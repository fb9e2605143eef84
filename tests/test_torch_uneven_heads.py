"""Tensor parallelism for q heads that do not divide the model axis, on the
CPU: llama3.2-3b and starcoder2-7b SMOKE made uneven with ``replace``
(``tests/torch_uneven_heads_ranks.py``: 6 q / 2 K/V heads and 9 q / 3
K/V heads of 16, on (data 1, model 4), and the latter on (1, 2), where
both ranks read parts of two K/V groups).

* **The head assignment** (``layers.head_blocks``): contiguous blocks of
  whole q heads that cover every head once, the first ``Hq mod tp`` ranks
  one head more, each rank's K/V heads the ones its q heads read; the
  divisible configs' blocks are ``Hq / tp`` heads at ``index * Hq / tp``
  as before; ``parallel.all_gather_uneven`` on an axis of one.
* **Four gloo ranks (and two) against one device** (spawned processes,
  one thread a rank, the reference's weights): the prefill's logits on
  ``block_masked``, ``dense_masked`` and ``flash_pallas``; four
  context-parallel decode steps of 2 rows on a seeded 32-position cache,
  their logits and the rank's cache slices; one sharded training step's
  loss and updated parameters (an element whose gradient is within 1e-5
  of its tensor's largest, where Adam's first step reads the gradient's
  rounding, held to the learning rate instead).
  Held at the sharded tolerance of
  ``tests/test_torch_sharded_serve.py`` (rtol 1e-5, atol 1e-5 times the
  largest magnitude above 1); the loss within 1e-5 relative.
* **One device against the reference's forward** on the same converted
  weights, at the families tests' f32 tolerance (1e-5, rtol and atol).

Every process group lives in a child; a fixture asserts that none is
left in this process.
"""
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs.base import get_config as ref_get_config
from repro.models import transformer as RT
from repro_torch import parallel
from repro_torch.configs.base import get_config
from repro_torch.convert import load_reference_params
from repro_torch.launch.specs import cache_layout, cache_slice
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_uneven_heads_ranks as R  # noqa: E402

#: the sharded tolerance (``test_torch_sharded_serve.close``)
TOL = 1e-5
#: seconds the ranks may take
RANKS_TIMEOUT = 240


@pytest.fixture(autouse=True)
def no_group_here():
    """No test leaves this process with a process group."""
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def close(got, want, err_msg=""):
    want = want.numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL,
                               atol=TOL * scale, err_msg=err_msg)


def ref_config(arch: str):
    return ref_get_config(arch, smoke=True).replace(**R.CASES[arch])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results and rank 0's one-device runs, and the
    reference's weights and forward on the prefill tokens."""
    tmp = tmp_path_factory.mktemp("uneven")
    spawns = [mp.start_processes(R.ranks, args=(world, str(tmp)),
                                 nprocs=world, join=False,
                                 start_method="spawn")
              for world in R.MESHES]
    try:
        ref = {}
        for arch in R.CASES:
            cfg = R.case_config(arch)
            params = RT.init_params(ref_config(arch), jax.random.PRNGKey(0))
            model = T.init_params(cfg, device="cpu")
            load_reference_params(model, params)
            inp = R.inputs(cfg)
            path = tmp / f"{arch}.pt"
            torch.save({"params": {n: p.detach().clone() for n, p
                                   in model.named_parameters()},
                        "cache": R.seeded_cache(cfg), "inputs": inp},
                       str(path) + ".part")
            os.replace(str(path) + ".part", path)
            ref[arch] = (model, np.asarray(RT.forward(params, ref_config(
                arch), {"tokens": jnp.asarray(inp["tokens"].numpy())})))
        for ctx in spawns:
            for _ in range(RANKS_TIMEOUT):
                if ctx.join(timeout=1):
                    break
            else:
                raise TimeoutError("the gloo ranks did not finish")
    finally:
        for ctx in spawns:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    got = {w: [torch.load(tmp / f"uneven{w}.{r}.pt") for r in range(w)]
           for w in R.MESHES}
    return {"got": got,
            "one": {a: got[w][0][a]["one"] for a, w in R.ONE_DEVICE.items()},
            "ref": ref}


#: (arch, world) of every sharded run
RUNS = [(a, w) for w, (_, cases) in R.MESHES.items() for a in cases]
RUN_IDS = [f"{a}@1x{w}" for a, w in RUNS]


# ---------------------------------------------------------------------------
# the head assignment
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hq,hkv,tp", [
    (6, 2, 4), (9, 3, 4), (24, 8, 16), (36, 4, 16), (36, 4, 8), (32, 8, 4),
    (32, 8, 16), (16, 16, 2), (7, 7, 3), (5, 1, 4)])
def test_head_blocks_cover_every_head_once(hq, hkv, tp):
    blocks = [L.head_blocks(hq, hkv, tp, i) for i in range(tp)]
    sizes = [e - f for f, e, _, _ in blocks]
    assert sum(sizes) == hq and sizes == L.balanced_sizes(hq, tp)
    assert [f for f, *_ in blocks] == [sum(sizes[:i]) for i in range(tp)]
    assert sizes == sorted(sizes, reverse=True)
    assert max(sizes) - min(sizes) <= 1
    g = hq // hkv
    for f, e, k0, k1 in blocks:
        assert list(range(k0, k1)) == sorted({h // g for h in range(f, e)})
    if hq % tp == 0:
        n = hq // tp
        assert all(f == i * n and e - f == n
                   for i, (f, e, _, _) in enumerate(blocks))


def test_head_blocks_of_the_production_axis():
    """The issue's three uneven axes, and which ranks read two groups."""
    sizes = lambda hq, tp: [e - f for f, e, _, _ in
                            (L.head_blocks(hq, 1, tp, i) for i in range(tp))]
    assert sizes(24, 16) == [2] * 8 + [1] * 8
    assert sizes(36, 16) == [3] * 4 + [2] * 12
    assert sizes(36, 8) == [5] * 4 + [4] * 4
    assert L.head_blocks(24, 8, 16, 0) == (0, 2, 0, 1)
    assert L.head_blocks(24, 8, 16, 1) == (2, 4, 0, 2)
    assert L.head_blocks(36, 4, 8, 0) == (0, 5, 0, 1)
    assert L.head_blocks(36, 4, 8, 1) == (5, 10, 0, 2)
    assert L.head_blocks(6, 2, 4, 1) == (2, 4, 0, 2)
    assert L.head_blocks(9, 3, 4, 2) == (5, 7, 1, 3)


class _Axis:
    def __init__(self, size, index):
        self.size, self.index = size, index


@pytest.mark.parametrize("hq,hkv,tp,indexed", [
    (6, 2, 4, ()), (9, 3, 4, ()), (9, 3, 2, (0, 1)),
    (36, 4, 8, (1, 3, 5)), (36, 4, 16, ()), (24, 8, 16, ()),
    (32, 8, 4, ()), (32, 8, 16, ())])
def test_kv_heads_as_gqa_reads_them(hq, hkv, tp, indexed):
    """Local q head j reads K/V head j // (Hq' / Hkv') of what
    ``_kv_per_q_head`` returns: that is q head h0 + j's K/V head on every
    rank; the K/V heads are indexed once per q head only on the ranks
    ``indexed``, whose q heads read unequal runs of two groups."""
    cfg = R.case_config("llama3_2_3b").replace(
        n_heads=hq, n_kv_heads=hkv, d_model=16 * hq)
    attn = L.Attention(cfg, torch.Generator().manual_seed(0))
    g = hq // hkv
    for i in range(tp):
        attn.tp = _Axis(tp, i)
        h0, h1, k0, k1 = attn.tp_heads(cfg)
        k = torch.arange(k0, k1, dtype=torch.float32).reshape(1, -1, 1, 1)
        (got,) = attn._kv_per_q_head(cfg, k)
        n_q, n_kv = h1 - h0, got.shape[1]
        assert n_q % n_kv == 0
        read = [float(got[0, j // (n_q // n_kv), 0, 0]) for j in range(n_q)]
        assert read == [h // g for h in range(h0, h1)], i
        assert (got is not k) == (i in indexed), i


def test_uneven_gather_on_an_axis_of_one_is_the_identity():
    one = parallel.Axis("model", None, 1, 0, "gloo")
    x = torch.arange(6.0).reshape(2, 3)
    assert parallel.all_gather_uneven(x, one, 1, [3]) is x


@pytest.mark.parametrize("world", list(R.MESHES))
def test_uneven_gather_and_its_gradient(runs, world):
    """Blocks of 2, 2, 1, 1 (2, 1) rows concatenated in rank order, the
    padding dropped; each rank's gradient is its own block of the
    consumer's."""
    for r, got in enumerate(runs["got"][world]):
        g = got["gather"]
        sizes = g["sizes"]
        want = torch.cat([torch.full((n, 3), float(i + 1))
                          for i, n in enumerate(sizes)])
        assert torch.equal(g["gathered"], want)
        lo = sum(sizes[:r])
        w = torch.arange(want.numel(), dtype=torch.float32).reshape(
            want.shape)
        assert torch.equal(g["grad"], w[lo:lo + sizes[r]])


def test_only_a_rank_without_heads_or_an_uneven_mla_is_refused():
    from repro_torch.train import train_step as TS
    for arch in ("llama3_2_3b", "starcoder2_7b"):
        cfg = R.case_config(arch)
        model = T.init_params(cfg, device="meta")
        for tp in (2, 4, 8):
            lay = TS.state_specs(model, {"data": 1, "model": tp})
            if tp < cfg.n_heads:
                TS._check_tensor_parallel(model, cfg, lay, tp)
                continue
            with pytest.raises(NotImplementedError,
                               match="a rank would run no head"):
                TS._check_tensor_parallel(model, cfg, lay, tp)
    cfg = get_config("deepseek_v2_lite_16b", smoke=True)
    model = T.init_params(cfg, device="meta")
    tp = next(t for t in range(2, cfg.n_heads) if cfg.n_heads % t)
    with pytest.raises(NotImplementedError, match="MLA"):
        TS._check_tensor_parallel(
            model, cfg, TS.state_specs(model, {"data": 1, "model": tp}), tp)


# ---------------------------------------------------------------------------
# the exchange of a rank's heads' columns (``parallel.regroup``)
# ---------------------------------------------------------------------------

def _meet(lo: int, hi: int, start: int, n: int) -> int:
    return max(0, min(hi, start + n) - max(lo, start))


def _wants(hq: int, hkv: int, tp: int, hd: int, kv: bool):
    blocks = [L.head_blocks(hq, hkv, tp, r) for r in range(tp)]
    return [(b[2 * kv] * hd, b[2 * kv + 1] * hd) for b in blocks]


def exchange_bytes(cfg, world: int, rank: int, kv: bool, nbytes: int = 4):
    """(forward, backward) bytes that rank ``rank`` sends for one weight of
    ``d_model`` rows and ``cfg``'s q (or, ``kv``, K/V) heads' columns,
    worked out from ``head_blocks`` and the equal shards alone: the parts
    of its shard in the other ranks' blocks, then the parts of its block in
    the other ranks' shards."""
    want = _wants(cfg.n_heads, cfg.n_kv_heads, world, cfg.hd, kv)
    n = (cfg.n_kv_heads if kv else cfg.n_heads) * cfg.hd // world
    fwd = sum(_meet(*want[j], rank * n, n) for j in range(world) if j != rank)
    bwd = sum(_meet(*want[rank], j * n, n) for j in range(world) if j != rank)
    return fwd * cfg.d_model * nbytes, bwd * cfg.d_model * nbytes


def layer_exchange_bytes(cfg, world: int, rank: int):
    """(forward, backward) bytes of one layer's ``wq``, ``wo``, ``wk`` and
    ``wv``."""
    parts = [exchange_bytes(cfg, world, rank, kv) for _, _, kv in R.WEIGHTS]
    return sum(f for f, _ in parts), sum(b for _, b in parts)


def test_regroup_on_an_axis_of_one_is_the_identity():
    one = parallel.Axis("model", None, 1, 0, "gloo")
    x = torch.arange(6.0).reshape(2, 3)
    assert parallel.regroup(x, one, 1, [(0, 3)]) is x


@pytest.mark.parametrize("hq,hkv,tp", [
    (24, 8, 16), (36, 4, 16), (36, 4, 8), (6, 2, 4), (9, 3, 4), (9, 3, 2)])
@pytest.mark.parametrize("kv", [False, True], ids=["q", "kv"])
def test_regroup_plan_moves_only_what_another_rank_reads(hq, hkv, tp, kv):
    """Each rank receives its block's width, part j what rank j sends it;
    what it sends is the parts of its shard in the other ranks' blocks
    (``exchange_bytes``), and some part crosses where the heads do not
    divide the axis."""
    hd = 8
    want = tuple(_wants(hq, hkv, tp, hd, kv))
    n = (hkv if kv else hq) * hd // tp
    plans = [parallel.regroup_plan(n, want, i) for i in range(tp)]
    cfg = R.case_config("llama3_2_3b").replace(
        n_heads=hq, n_kv_heads=hkv, d_model=1, head_dim=hd)
    for i, (send, recv, crosses) in enumerate(plans):
        assert crosses == bool(hq % tp)
        assert sum(recv) == want[i][1] - want[i][0]
        for j in range(tp):
            assert plans[j][0][i][1] == recv[j]
        sent = sum(k for j, (_, k) in enumerate(send) if j != i)
        assert (sent * 4, sum(recv) * 4 - recv[i] * 4) == \
            exchange_bytes(cfg, tp, i, kv)


@pytest.mark.parametrize("world", list(R.MESHES))
def test_regroup_gives_each_rank_its_heads_columns(runs, world):
    """Every rank's block of ``wq`` (columns), ``wo`` (rows) and ``wk`` /
    ``wv`` (columns; K/V heads read by two or three ranks) equals the
    slice of the whole weight bit for bit; each shard's gradient equals
    its slice of the whole weight's gradient, the readers' parts of a
    shared K/V head added in rank order; the forward and the backward each
    put ``exchange_bytes`` on the links, by one all-to-all each."""
    _, cases = R.MESHES[world]
    for arch in cases:
        cfg = R.case_config(arch)
        whole = R.whole_weights(cfg)
        for name, dim, kv in R.WEIGHTS:
            want = _wants(cfg.n_heads, cfg.n_kv_heads, world, cfg.hd, kv)
            grad = torch.zeros_like(whole[name])
            for r, (lo, hi) in enumerate(want):
                grad.narrow(dim, lo, hi - lo).add_(R.consumer(
                    whole[name].narrow(dim, lo, hi - lo).shape, r))
            n = whole[name].shape[dim] // world
            for r, got in enumerate(runs["got"][world]):
                res, what = got["regroup"][arch, name], f"{arch} {name} {r}"
                lo, hi = want[r]
                assert torch.equal(res["block"],
                                   whole[name].narrow(dim, lo, hi - lo)), what
                assert torch.equal(res["grad"],
                                   grad.narrow(dim, r * n, n)), what
                fwd, bwd = exchange_bytes(cfg, world, r, kv)
                assert res["forward"] == {("all_to_all", "gloo"): fwd}, what
                assert res["backward"] == {("all_to_all", "gloo"): bwd}, what


def _shard_shapes(cfg, world: int) -> set:
    d, q, kv = cfg.d_model, cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    return {(d, q // world), (q // world, d), (d, kv // world)}


@pytest.mark.parametrize("arch,world", RUNS, ids=RUN_IDS)
def test_model_moves_only_its_heads_columns(runs, arch, world):
    """No rank all-gathers a shard of ``wq``, ``wo``, ``wk`` or ``wv``;
    its all-to-all bytes are ``exchange_bytes``': the three served models
    fetch their blocks once each (``3 x layers x`` the forward's), the
    decode steps fetch nothing, the train step exchanges in its forward and
    back."""
    cfg = R.case_config(arch)
    shards = _shard_shapes(cfg, world)
    for r, got in enumerate(runs["got"][world]):
        res = got[arch]
        stages = dict(res["stages"], train=res["train"]["stage"])
        fwd, bwd = layer_exchange_bytes(cfg, world, r)
        want = {"prefill": len(R.IMPLS) * cfg.n_layers * fwd, "decode": 0,
                "train": cfg.n_layers * (fwd + bwd)}
        for name, n in want.items():
            st = stages[name]
            assert st["links"].get(("all_to_all", "gloo"), 0) == n, \
                (r, name)
            assert not shards & set(st["gathered"]), (r, name)


@pytest.mark.parametrize("arch,world", RUNS, ids=RUN_IDS)
def test_served_blocks_are_fetched_once_a_weight_version(runs, arch, world):
    """A served model's blocks are the whole weights' slices; two more
    forwards fetch nothing; after an in-place update of ``wq`` the next
    forward fetches that block alone, and it holds the updated columns."""
    model = runs["ref"][arch][0]
    cfg = R.case_config(arch)
    attn = model.blocks[0].attn
    for r, got in enumerate(runs["got"][world]):
        res = got[arch]
        for name, dim, kv in R.WEIGHTS:
            lo, hi = _wants(cfg.n_heads, cfg.n_kv_heads, world, cfg.hd,
                            kv)[r]
            w = getattr(attn, name).detach()
            assert torch.equal(res["fetched"][name],
                               w.narrow(dim, lo, hi - lo)), (r, name)
        a2a = lambda st: res["stages"][st]["links"].get(
            ("all_to_all", "gloo"), 0)
        assert a2a("again") == 0, r
        assert a2a("updated") == exchange_bytes(cfg, world, r, False)[0], r
        lo, hi = _wants(cfg.n_heads, cfg.n_kv_heads, world, cfg.hd,
                        False)[r]
        assert torch.equal(res["refetched"],
                           2.0 * attn.wq.detach()[:, lo:hi]), r


# ---------------------------------------------------------------------------
# four gloo ranks against one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,world", RUNS, ids=RUN_IDS)
def test_ranks_run_their_balanced_heads(runs, arch, world):
    cfg = R.case_config(arch)
    for r, got in enumerate(runs["got"][world]):
        assert tuple(got[arch]["heads"]) == L.head_blocks(
            cfg.n_heads, cfg.n_kv_heads, world, r)
        # the K/V heads do not divide the axis: the cache splits T
        assert got[arch]["place"]["dense"]["k"][3] == "model"
        # the exchange of its heads' columns is on the links
        assert got[arch]["links"][("all_to_all", "gloo")] > 0


@pytest.mark.parametrize("impl", R.IMPLS)
@pytest.mark.parametrize("arch,world", RUNS, ids=RUN_IDS)
def test_sharded_prefill_matches_one_device(runs, arch, world, impl):
    want = runs["one"][arch]["prefill"][impl]
    for r, got in enumerate(runs["got"][world]):
        close(got[arch]["prefill"][impl], want, f"rank {r}")


@pytest.mark.parametrize("arch,world", RUNS, ids=RUN_IDS)
def test_sharded_decode_matches_one_device(runs, arch, world):
    one = runs["one"][arch]
    layout = cache_layout(one["cache"], dict(zip(("data", "model"),
                                                 R.MESHES[world][0])))
    for r, got in enumerate(runs["got"][world]):
        res = got[arch]
        close(res["decode"], one["decode"], f"rank {r}")
        axes = {k: _Axis(*res["axes"][k]) for k in ("dp", "model")}
        for name, whole in one["cache"]["dense"].items():
            mine = cache_slice(whole, layout["dense"][name], axes)
            close(res["cache"]["dense"][name], mine, f"rank {r} {name}")


#: Adam's first update is lr g / (|g| + 1e-8): where the one-device
#: gradient is non-zero and within this fraction of its tensor's largest,
#: its size reads the f32 rounding of g (sums in another order move such
#: an element's update by up to lr), so there the parameter is held to
#: lr instead (the set is the one-device gradient's, not the ranks')
ILL_FRACTION = 1e-5


@pytest.mark.parametrize("arch,world", RUNS, ids=RUN_IDS)
def test_sharded_train_step_matches_one_device(runs, arch, world):
    want = runs["one"][arch]["train"]
    lr = R.STEP_OPT["lr"]
    for r, got in enumerate(runs["got"][world]):
        res = got[arch]["train"]
        assert abs(res["loss"] - want["loss"]) <= TOL * abs(want["loss"])
        assert set(res["params"]) == set(want["params"])
        for n, p in want["params"].items():
            g = want["grads"][n].abs()
            ill = (g > 0) & (g <= ILL_FRACTION * g.max())
            close(res["params"][n][~ill], p[~ill], f"rank {r} {n}")
            assert all(abs(float(d)) <= lr
                       for d in res["params"][n][ill] - p[ill]), n


# ---------------------------------------------------------------------------
# one device against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(R.CASES))
def test_one_device_forward_matches_reference(runs, arch):
    model, want = runs["ref"][arch]
    cfg = R.case_config(arch)
    assert cfg.attn_impl == "block_masked"
    tokens = R.inputs(cfg)["tokens"]
    with torch.no_grad():
        got = T.forward(model, cfg, {"tokens": tokens})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # and the one-device run the ranks were held to is this forward
    np.testing.assert_allclose(
        runs["one"][arch]["prefill"]["block_masked"].numpy(), got.numpy(),
        rtol=1e-6, atol=1e-6)
