"""Every family served and trained on a (data, model) mesh: processes
spawned by ``torch.multiprocessing`` on the CPU, a gloo group on a
``FileStore``, one intra-op thread a rank (``tests/torch_sharded_serve_ranks.py``),
held to the port's single-device runs on the reference's weights
(``load_reference_params``), which the family tests hold to the
reference.  Two spawns run side by side: two ranks on (1, 2) and four on
(2, 2) then (1, 4).

* **Every SMOKE config** (and internvl2 with a vocabulary of 515, which no
  model axis divides, so its embedding and head split by d_model) on
  (1, 2) and (2, 2), f32: a sharded prefill's logits; 8 decode steps from
  a seeded cache, the rows at other positions, crossing the middle of T
  (the logits of every step and the cache after them, at rtol 1e-5 /
  atol 1e-5 times the largest magnitude above 1: ``close``); a greedy ``generate`` whose tokens equal the one-device
  port's; 3 sharded train steps (ZeRO-1) whose losses are within 1e-5
  relative of the one-device step's.  The MoE configs run at a capacity
  that drops nothing, where expert parallelism is the dropless dispatch.
* **Odd vocabulary on four model ranks**: seamless with 514 rows on
  (1, 4), the same four checks.
* **Cache placements**: ``launch.specs.cache_layout`` equals the
  reference's ``cache_specs`` under ``fit_spec`` for every SMOKE config on
  (2, 2), (1, 4), (4, 1) and (2, 2, 2), exactly, the reference's side in a
  child process (importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512
  host devices).  The sLSTM ``m`` cache gets the data axes on its heads,
  as the reference's rule for the mLSTM's ``m`` gives it.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.configs.base import get_config as ref_get_config
from repro.models import transformer as RT
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.convert import load_reference_params
from repro_torch.launch.specs import cache_layout, cache_slice
from repro_torch.models import transformer as T

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_sharded_serve_ranks as R  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PLACEMENT_MESHES = ({"data": 2, "model": 2}, {"data": 1, "model": 4},
                    {"data": 4, "model": 1},
                    {"pod": 2, "data": 2, "model": 2})
#: the cache whose placements are compared: 4 rows, 32 positions
PLACEMENT_BATCH, PLACEMENT_LEN = 4, 32

REF_PLACEMENTS = r"""
import json, sys
import repro.launch.dryrun as D
import jax
from jax.sharding import PartitionSpec as P
from repro.configs.base import ARCH_IDS, get_config
from repro.models import transformer as RT
from repro.models.common import fit_spec

class Mesh:
    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)

meshes, b, t = json.loads(sys.argv[1])
entry = lambda e: list(e) if isinstance(e, tuple) else e
out = {}
for arch in ARCH_IDS:
    cfg = get_config(arch, smoke=True)
    cache = jax.eval_shape(lambda: RT.init_cache(cfg, b, t))
    specs = D.cache_specs(cache)
    leaves = jax.tree_util.tree_flatten_with_path(cache)[0]
    flat = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    out[arch] = [{jax.tree_util.keystr(path): [entry(e) for e in fit_spec(
        s, leaf.shape, Mesh(sizes))] for (path, leaf), s in zip(leaves, flat)}
        for sizes in meshes]
print("REF " + json.dumps(out))
"""


def ref_config(case: str):
    cfg = ref_get_config(case.split()[0], smoke=True)
    port = R.case_config(case)
    return cfg.replace(vocab_size=port.vocab_size)


def one_device(case: str, tmp: Path) -> dict:
    """The reference's weights in a port model: save them, the seeded
    cache and the inputs for the ranks (whole, by a rename), and run the
    single-device serve and train steps."""
    cfg = R.case_config(case)
    model = T.init_params(cfg, device="cpu")
    load_reference_params(model, RT.init_params(ref_config(case),
                                                jax.random.PRNGKey(0)))
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    cache, inp = R.seeded_cache(cfg), R.inputs(cfg)
    path = tmp / f"{case.replace(' ', '_')}.pt"
    torch.save({"params": params, "cache": cache, "inputs": inp},
               str(path) + ".part")
    os.replace(str(path) + ".part", path)
    out = R.serve(model, cfg, inp, cache)
    out["train"] = R.train_losses(cfg, params)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_serve")
    child = subprocess.Popen(
        [sys.executable, "-c", REF_PLACEMENTS, json.dumps(
            [PLACEMENT_MESHES, PLACEMENT_BATCH, PLACEMENT_LEN])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                 JAX_PLATFORMS="cpu"))
    spawns = [mp.start_processes(R.ranks, args=(world, str(tmp)),
                                 nprocs=world, join=False,
                                 start_method="spawn")
              for world in R.MESHES]
    want = {case: one_device(case, tmp)
            for case in R.CASES + (R.WIDE_CASE,)}
    for ctx in spawns:
        while not ctx.join():
            pass
    got = {}
    for world in R.MESHES:
        for r in range(world):
            for tg, res in torch.load(tmp / f"serve{world}.{r}.pt").items():
                got.setdefault(tg, []).append(res)
    stdout, stderr = child.communicate(timeout=300)
    assert child.returncode == 0, stdout + stderr
    line = next(x for x in stdout.splitlines() if x.startswith("REF "))
    return {"want": want, "got": got, "ref": json.loads(line[4:])}


CASES = [(c, s) for w in R.MESHES for s in R.MESHES[w]
         for c in R.mesh_cases(s)]
IDS = [R.tag(c, s) for c, s in CASES]


def rank_rows(res) -> slice:
    n, i = res["axes"]["dp"]
    return slice(i * R.BATCH // n, (i + 1) * R.BATCH // n)


#: the sharded-against-one-device tolerance: the family tests' f32 1e-5
#: (rtol and atol), the atol scaled by the tensor's largest magnitude above
#: 1 (``close``); ``test_tolerance_is_the_models_own_rounding`` shows one
#: ulp of the weights moving the one-device logits past atol 1e-6
TOL = 1e-5


def close(got, want, err_msg=""):
    """``got`` within ``TOL`` of ``want`` (rtol, and atol times ``want``'s
    largest magnitude where that exceeds 1): f32 sums taken in another
    order (a row block's partial products added over the axis) differ by
    a few ulps of the summands, not of a result near zero."""
    want = want.numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL,
                               atol=TOL * scale, err_msg=err_msg)


class _Axis:
    def __init__(self, size: int, index: int):
        self.size, self.index = size, index


@pytest.mark.parametrize("case,shape", CASES, ids=IDS)
def test_sharded_prefill_matches_one_device(runs, case, shape):
    want = runs["want"][case]["prefill"]
    for res in runs["got"][R.tag(case, shape)]:
        close(res["prefill"], want[rank_rows(res)])


@pytest.mark.parametrize("case,shape", CASES, ids=IDS)
def test_sharded_decode_matches_one_device(runs, case, shape):
    want = runs["want"][case]
    sizes = dict(zip(("data", "model"), shape))
    layout = cache_layout(want["cache"], sizes)
    for res in runs["got"][R.tag(case, shape)]:
        close(res["decode"], want["decode"][:, rank_rows(res)])
        axes = {k: _Axis(*res["axes"][k]) for k in ("dp", "model")}
        for group, leaves in want["cache"].items():
            if leaves is None:
                assert res["cache"][group] is None
                continue
            for name, whole in leaves.items():
                mine = cache_slice(whole, layout[group][name], axes)
                close(res["cache"][group][name], mine, f"{group}.{name}")


@pytest.mark.parametrize("case,shape", CASES, ids=IDS)
def test_sharded_generate_matches_one_device(runs, case, shape):
    want = runs["want"][case]["generate"]
    for res in runs["got"][R.tag(case, shape)]:
        assert torch.equal(res["generate"], want[rank_rows(res)])


@pytest.mark.parametrize("case,shape", CASES, ids=IDS)
def test_sharded_train_matches_one_device(runs, case, shape):
    want = runs["want"][case]["train"]
    for res in runs["got"][R.tag(case, shape)]:
        for g, w in zip(res["train"], want):
            assert abs(g - w) <= 1e-5 * abs(w), (res["train"], want)


def _keystr(tree, path=()):
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_keystr(v, path + (k,)))
        return out
    return {"".join(f"['{k}']" for k in path): tree}


def _entries(spec) -> list:
    """A spec as JSON lists, a one-axis tuple as its axis (as the
    reference's ``PartitionSpec`` writes it)."""
    return [(e[0] if len(e) == 1 else list(e)) if isinstance(e, (tuple, list))
            else e for e in spec]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_placements_match_reference(runs, arch):
    cache = T.init_cache(get_config(arch, smoke=True), PLACEMENT_BATCH,
                         PLACEMENT_LEN, device="meta")
    for sizes, want in zip(PLACEMENT_MESHES, runs["ref"][arch]):
        got = {k: _entries(v)
               for k, v in _keystr(cache_layout(cache, sizes)).items()}
        assert got == {k: _entries(v) for k, v in want.items()}, sizes
    if arch == "xlstm_1_3b":
        # the reference's "m" rule, written for the mLSTM's (B, nh), puts
        # the data axis on the sLSTM m's heads, not its rows
        lay = cache_layout(cache, PLACEMENT_MESHES[0])
        assert lay["slstm"]["m"] == (None, None, ("data",), None)
        assert lay["mlstm"]["m"] == (None, None, ("data",), None)
        assert lay["slstm"]["c"] == (None, ("data",), None, "model")


def test_tolerance_is_the_models_own_rounding():
    """A relative perturbation of 1e-7 (about one f32 ulp) of zamba2
    SMOKE's weights moves its one-device logits by more than 1e-6 at some
    element, and stays inside ``close``: the sharded runs are held as
    tightly as the model's own rounding allows."""
    cfg = R.case_config("zamba2_7b")
    model = T.init_params(cfg, seed=0, device="cpu")
    batch = R.prefill_batch(cfg, R.inputs(cfg))
    base = T.forward(model, cfg, batch)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen).sign())
    moved = T.forward(model, cfg, batch)
    assert float((moved - base).abs().max()) > 1e-6
    close(moved, base)
