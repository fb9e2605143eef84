"""The port's sharding decisions against the reference's, in one process on
the CPU (the multi-rank runs are ``tests/test_torch_sharded_train.py``):

* every parameter's placement on (2, 2), (1, 4), (4, 1) and (2, 2, 2)
  meshes, and its ZeRO-1 moments' data dim, equal to the reference's
  ``fit_spec(make_param_specs(...))`` and ``zero1_specs`` computed on
  ``jax.eval_shape`` shapes, for every SMOKE config (exactly);
* llama3.2-3b and starcoder2-7b at full width (q heads that do not
  divide 16) on the production (16, 16) and (2, 16, 16) meshes: their
  placements and moments' dims equal the reference's on ``jax.eval_shape``
  shapes from a child, the port's model on meta, and the tensor-parallel
  layers take them;
* every family's layers take a model axis of 2 and 4; one that would
  leave a rank no attention head (llama SMOKE's 4 heads on 8, zamba2
  SMOKE's shared attention on 16) refuses before anything changes,
  naming the layer;
* the expert-parallel MoE restated on one device equals the dropless
  dense MoE where its capacity drops nothing (rtol 1e-5, atol 1e-6: f32
  sums in another order);
* a data-parallel rank's batch is its rows of the global batch (exactly),
  and ``batch_specs`` is the reference's;
* ``--backend nccl`` with more ranks than cards, and a pod mesh on the
  wrong world, raise before any process group starts.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as ref_get_config
from repro.models import transformer as RT
from repro.models.common import fit_spec as ref_fit_spec
from repro.models.common import make_param_specs as ref_param_specs
from repro.optim.adamw import zero1_specs as ref_zero1_specs
from repro.train.train_step import batch_specs as ref_batch_specs
from repro_torch import parallel
from repro_torch.configs.base import get_config
from repro_torch.convert import reference_paths
from repro_torch.data.pipeline import SyntheticLM, batch_for
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import make_device_mesh, production_shape
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.common import axis_dim, placements
from repro_torch.train import train_step as TS

MESHES = ({"data": 2, "model": 2}, {"data": 1, "model": 4},
          {"data": 4, "model": 1}, {"pod": 2, "data": 2, "model": 2})


class _RefMesh:
    """What the reference's ``fit_spec`` reads of a mesh."""

    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


def reference_layouts(arch, sizes):
    """keystr path -> (fitted param spec, fitted moment spec), as tuples
    with one entry per dim."""
    cfg = ref_get_config(arch, smoke=True)
    shapes = jax.eval_shape(lambda: RT.init_params(cfg,
                                                   jax.random.PRNGKey(0)))
    ps = ref_param_specs(shapes)
    zs = ref_zero1_specs(shapes, ps)
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    mesh = _RefMesh(sizes)
    out = {}
    for (path, leaf), p, z in zip(flat, jax.tree.leaves(ps, is_leaf=is_p),
                                  jax.tree.leaves(zs, is_leaf=is_p)):
        fp = tuple(ref_fit_spec(p, leaf.shape, mesh))
        fz = tuple(ref_fit_spec(z, leaf.shape, mesh))
        out[jax.tree_util.keystr(path)] = (fp, fz, tuple(leaf.shape))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placements_and_zero1_dims_match_reference(arch):
    model = T.init_params(get_config(arch, smoke=True), device="cpu")
    paths = reference_paths(model)
    for sizes in MESHES:
        want = reference_layouts(arch, sizes)
        assert {p for p, _ in paths.values()} == set(want)
        got = TS.state_specs(model, sizes, zero1=True)
        for name, (path, full) in paths.items():
            fp, fz, shape = want[path]
            assert full == shape, name
            lead = len(full) - len(got[name].shape)
            assert fp[:lead] == (None,) * lead and \
                fz[:lead] == (None,) * lead, (name, fp, fz)
            assert got[name].spec == fp[lead:], (sizes, name)
            assert got[name].moment_spec == fz[lead:], (sizes, name)
            assert got[name].zero_dim == axis_dim(fz[lead:], "data")
        plain = TS.state_specs(model, sizes, zero1=False)
        assert all(plain[n].moment_spec == plain[n].spec for n in plain)


#: full-width configs whose q heads do not divide the production model axis
UNEVEN_ARCHS = ("llama3_2_3b", "starcoder2_7b")
PRODUCTION_MESHES = ({"data": 16, "model": 16},
                     {"pod": 2, "data": 16, "model": 16})
#: the reference's layouts of full configs, in a child (``jax.eval_shape``
#: of a full-width model): keystr -> [param spec, moment spec, shape] a mesh
REF_FULL_LAYOUTS = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import jax
from repro.configs.base import get_config
from repro.models import transformer as RT
from repro.models.common import fit_spec, make_param_specs
from repro.optim.adamw import zero1_specs

class Mesh:
    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)

archs, meshes = json.loads(sys.argv[2])
is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)
entry = lambda e: list(e) if isinstance(e, tuple) else e
out = {}
for arch in archs:
    shapes = jax.eval_shape(lambda: RT.init_params(get_config(arch),
                                                   jax.random.PRNGKey(0)))
    ps = make_param_specs(shapes)
    zs = zero1_specs(shapes, ps)
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    for sizes in meshes:
        key = arch + " " + json.dumps(sizes)
        out[key] = {jax.tree_util.keystr(path): [
            [entry(e) for e in fit_spec(p, leaf.shape, Mesh(sizes))],
            [entry(e) for e in fit_spec(z, leaf.shape, Mesh(sizes))],
            list(leaf.shape)]
            for (path, leaf), p, z in zip(
                flat, jax.tree.leaves(ps, is_leaf=is_p),
                jax.tree.leaves(zs, is_leaf=is_p))}
print("REF " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def full_layouts():
    src = str(Path(__file__).resolve().parents[1] / "src")
    r = subprocess.run(
        [sys.executable, "-c", REF_FULL_LAYOUTS, src,
         json.dumps([UNEVEN_ARCHS, PRODUCTION_MESHES])],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-4000:]
    line = next(x for x in r.stdout.splitlines() if x.startswith("REF "))
    return json.loads(line[4:])


def _spec(entries) -> tuple:
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


@pytest.mark.parametrize("sizes", PRODUCTION_MESHES,
                         ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", UNEVEN_ARCHS)
def test_full_width_uneven_placements_match_reference(full_layouts, arch,
                                                      sizes):
    cfg = get_config(arch)
    assert cfg.n_heads % sizes["model"]
    model = T.init_params(cfg, device="meta")
    paths = reference_paths(model)
    want = full_layouts[arch + " " + json.dumps(sizes)]
    assert {p for p, _ in paths.values()} == set(want)
    got = TS.state_specs(model, sizes, zero1=True)
    for name, (path, full) in paths.items():
        fp, fz, shape = (_spec(want[path][0]), _spec(want[path][1]),
                         tuple(want[path][2]))
        assert full == shape, name
        lead = len(full) - len(got[name].shape)
        assert fp[:lead] == (None,) * lead and fz[:lead] == (None,) * lead
        assert got[name].spec == fp[lead:], (sizes, name)
        assert got[name].moment_spec == fz[lead:], (sizes, name)
    # wq splits by columns, wo by rows, as the reference places them
    assert got["blocks.0.attn.wq"].spec == (None, "model")
    assert got["blocks.0.attn.wo"].spec == ("model", None)
    TS._check_tensor_parallel(model, cfg, got, sizes["model"])


def test_placements_as_dtensor_shards():
    from torch.distributed.tensor import Replicate, Shard
    model = T.init_params(get_config("llama3_2_1b", smoke=True),
                          device="cpu")
    lay = TS.state_specs(model, {"data": 2, "model": 2})
    names = ("data", "model")
    assert placements(lay["embed"].spec, names) == (Replicate(), Shard(0))
    assert placements(lay["blocks.0.attn.wq"].spec, names) == \
        (Replicate(), Shard(1))
    assert placements(lay["blocks.0.attn.wq"].moment_spec, names) == \
        (Shard(0), Shard(1))
    assert placements(lay["blocks.0.ln1.scale"].moment_spec, names) == \
        (Shard(0), Replicate())


@pytest.mark.parametrize("arch,model,refusal", [
    *((a, m, None) for a in ARCH_IDS for m in (2, 4)),
    ("llama3_2_1b", 8, "attention: 4 q heads do not split"),
    ("zamba2_7b", 16, "attention: 4 q heads do not split")])
def test_model_axis_refused_where_the_layers_do_not_split(arch, model,
                                                          refusal):
    """Every family's layers run their shards on model axes of 2 and 4;
    a model axis that would split a head refuses, naming the layer."""
    cfg = get_config(arch, smoke=True)
    model_ = T.init_params(cfg, device="cpu")
    lay = TS.state_specs(model_, {"data": 1, "model": model})
    if refusal is None:
        TS._check_tensor_parallel(model_, cfg, lay, model)
    else:
        with pytest.raises(NotImplementedError, match=refusal):
            TS._check_tensor_parallel(model_, cfg, lay, model)


def test_expert_parallel_restatement_without_drops_is_the_dense_moe():
    cfg = get_config("moonshot_v1_16b_a3b", smoke=True)
    for ep in (2, 4):
        # cap = ceil(t k / ep * cf) with cf = ep keeps every assignment
        c = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                capacity_factor=float(ep)))
        model = T.init_params(c, seed=2, device="cpu")
        moe = model.blocks[c.first_k_dense].ffn
        x = torch.as_tensor(np.random.default_rng(ep).standard_normal(
            (2, 8, c.d_model)).astype(np.float32))
        assert L.ep_capacity(c, 16, ep) == 16 * c.moe.top_k
        got, sizes = L.moe_ep_plain(moe, c, x, ep)
        with torch.no_grad():
            want = moe(x, c)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)
        assert sum(sizes, []) == moe.group_sizes


@pytest.mark.parametrize("arch", ["llama3_2_1b", "internvl2_2b",
                                  "seamless_m4t_large_v2"])
def test_data_parallel_batches_are_rows_of_the_global_batch(arch):
    cfg = get_config(arch, smoke=True)
    pipe = SyntheticLM(cfg.vocab_size, 40, 4, seed=3)
    whole = batch_for(cfg, pipe, 5, device="cpu")
    for n in (1, 2, 4):
        for i in range(n):
            part = batch_for(cfg, pipe, 5, device="cpu", shard=(i, n))
            assert sorted(part) == sorted(whole)
            for k, x in whole.items():
                assert torch.equal(part[k], x[i * 4 // n:(i + 1) * 4 // n])
    want = ref_batch_specs({k: jax.ShapeDtypeStruct(tuple(x.shape),
                                                    np.float32)
                            for k, x in whole.items()})
    assert TS.batch_specs(whole) == {k: tuple(v) for k, v in want.items()}


def test_nccl_refused_with_more_ranks_than_cards(monkeypatch):
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="pass --backend gloo"):
        parallel.check_backend("nccl", "cuda", cards + 1)
    with pytest.raises(ValueError, match="backend 'mpi'"):
        parallel.check_backend("mpi", "cpu", 1)
    parallel.check_backend("gloo", "cpu", 8)
    monkeypatch.setenv("WORLD_SIZE", str(cards + 2))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(cards + 2))
    with pytest.raises(ValueError, match="pass --backend gloo"):
        launcher.run("llama3_2_1b", smoke=True, steps=1, batch=2, seq=16,
                     device="cuda", backend="nccl")
    assert not torch.distributed.is_initialized()
    # a world of ranks needs a named backend
    with pytest.raises(ValueError, match="--backend gloo or --backend nccl"):
        launcher.run("llama3_2_1b", smoke=True, steps=1, batch=2, seq=16,
                     device="cpu")


def test_mesh_shapes_and_world_checks():
    assert production_shape() == {"data": 16, "model": 16}
    assert production_shape(multi_pod=True) == {"pod": 2, "data": 16,
                                                "model": 16}
    with pytest.raises(ValueError, match="needs 4 ranks, the world has 1"):
        make_device_mesh((2, 2), ("data", "model"))


def test_collectives_on_an_axis_of_one_are_the_identity():
    one = parallel.Axis("model", None, 1, 0, "gloo")
    x = torch.arange(6.0).reshape(2, 3).requires_grad_(True)
    for f in (parallel.copy_to, parallel.reduce_from):
        assert f(x, one) is x
    assert parallel.gather_partial(x, one, 1) is x
    assert parallel.all_gather_cat(x, one, 0) is x
    assert parallel.local_slice(x, one, 1) is x
    before = dict(parallel.LINK_BYTES)
    assert parallel.all_reduce(x.detach().clone(), one).equal(x.detach())
    assert parallel.LINK_BYTES == before
