"""The production dry run (``repro_torch.launch.dryrun``) on the CPU.

The reference's dry run lowers on 512 forced host devices and cannot run
here, so the port is held to the reference's pure pieces and to real
ranks:

* the shape grid, ``cell_is_runnable``, ``reduced_depth_cfgs``, the step
  inputs (``train_input_specs`` / ``decode_input_specs``, against
  ``jax.eval_shape``) and the parameter counts of every full config;
* SMOKE configs on a (2, 2) mesh: the dry run on meta as ranks 0 and 3 of
  a fake group of 4 against those ranks of 4 real gloo ranks
  (``tests/torch_sharded_ranks.py``): collectives, link bytes, state
  bytes and FLOPs (PyTorch's ``FlopCounterMode`` on the real rank; for
  the MoE outside its routed experts, whose rows the routing decides);
  and one row decoded on the mesh, the batch smaller than the data axes,
  against one device;
* ``account`` against a full-depth run, and the CLI with JAX blocked.

Every process group and every full-width model lives in a child process
(spawned ranks, or ``python -c``) with a time limit; a fixture asserts that
this process never holds a group.
"""
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import cell_is_runnable as ref_runnable
from repro.configs.base import get_config as ref_get_config
from repro.launch.specs import decode_input_specs as ref_decode_specs
from repro.launch.specs import train_input_specs as ref_train_specs
from repro_torch.configs.base import (ARCH_IDS, SHAPES, cell_is_runnable,
                                      get_config)
from repro_torch.launch import dryrun as D
from repro_torch.launch.specs import cache_map

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tests"))
import torch_sharded_ranks as R  # noqa: E402

#: the depth fields ``reduced_depth_cfgs`` sets
DEPTH_FIELDS = ("n_layers", "n_enc_layers", "n_dec_layers")
#: seconds a child may take
CHILD_TIMEOUT = 300
#: the head of every child: the port alone, JAX and the reference blocked
PRELUDE = f"""
import json, sys
sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO / 'tests')!r}]
sys.modules["jax"] = None
sys.modules["repro"] = None
import torch
from repro_torch.configs.base import ARCH_IDS, SHAPES, ShapeCfg, get_config
from repro_torch.launch import dryrun as D
"""
SPECS = PRELUDE + """
from repro_torch.launch.specs import decode_input_specs, train_input_specs
from repro_torch.launch.specs import cache_map
out = {"specs": {}, "params": {}}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    out["params"][arch] = D.param_counts(cfg)
    for name, shape in SHAPES.items():
        if shape.kind == "decode":
            s = decode_input_specs(cfg, shape)
            leaves = {}
            cache_map(lambda p, t: leaves.update({".".join(p): t}), s["cache"])
            s = dict({k: v for k, v in s.items() if k != "cache"},
                     **{"cache." + k: v for k, v in leaves.items()})
        else:
            s = train_input_specs(cfg, shape)
        assert all(t.device.type == "meta" for t in s.values())
        out["specs"][f"{arch}/{name}"] = {
            k: [list(t.shape), str(t.dtype).replace("torch.", "")]
            for k, t in s.items()}
print(json.dumps(out))
"""
FAKE = PRELUDE + """
import torch_sharded_ranks as R
R.dryrun_fake(sys.argv[1])
"""
#: llama3.2-1b SMOKE at 4 layers, extrapolated from 1 and 2 and run whole:
#: a train step and a prefill on the flash kernel (its meta branch)
ACCOUNT = PRELUDE + """
cfg = get_config("llama3_2_1b", smoke=True).replace(n_layers=4)
mesh = {"data": 2, "model": 2}
out = {}
with D.fake_group(4, 1):
    for name, c, shape in (
            ("train", cfg, ShapeCfg("t", 32, 4, "train")),
            ("prefill", cfg.replace(attn_impl="flash_pallas"),
             ShapeCfg("p", 64, 4, "prefill"))):
        out[name] = {"account": D.account(c, shape, mesh),
                     "full": D.run_cell(c, shape, mesh)}
print(json.dumps(out))
"""
#: the reference's ``reduced_depth_cfgs``, in a child: importing its
#: ``launch/dryrun.py`` forces 512 host devices on every later JAX backend
#: of the process (``XLA_FLAGS``)
REF_DEPTHS = f"""
import json, sys
sys.path[:0] = [{str(REPO / 'src')!r}]
from repro.configs.base import ARCH_IDS, get_config
from repro.launch.dryrun import reduced_depth_cfgs
out = {{}}
for arch in ARCH_IDS:
    c1, c2, *depths = reduced_depth_cfgs(get_config(arch))
    out[arch] = [[getattr(c, f) for f in {DEPTH_FIELDS!r}] for c in (c1, c2)]
    out[arch] += depths
print(json.dumps(out))
"""
#: the CLI on a divisible cell, the uneven ones (``UNEVEN_CELLS``) and a
#: refused one, every all-gather's axis and shape kept by cell
#: (``gathered.json``)
CLI = PRELUDE + """
from repro_torch import parallel
out = sys.argv[1]
gathered, saved = {}, parallel.all_gather_cat

def gather(t, axis, dim):
    gathered.setdefault(cell, []).append([axis.name, list(t.shape)])
    return saved(t, axis, dim)
parallel.all_gather_cat = gather
for cell in ("llama3_2_1b.train_4k", "llama3_2_3b.train_4k",
             "starcoder2_7b.train_4k", "llama3_2_3b.decode_32k"):
    arch, shape = cell.split(".")
    D.main(["--arch", arch, "--shape", shape, "--mesh", "pod", "--account",
            "--out", out])
cell = "zamba2_7b.train_4k"
D.main(["--arch", "zamba2_7b", "--shape", "train_4k", "--mesh", "pod",
        "--patch", "ssm.head_dim=128", "--out", out])
with open(out + "/gathered.json", "w") as f:
    json.dump(gathered, f)
"""
#: the cells whose q heads do not divide the model axis of 16 that the CLI
#: child runs, with the all-gather bytes of ``wq`` / ``wo`` (and ``wk`` /
#: ``wv``) gathered whole that the parent commit counted for a
#: ``train_4k`` step
UNEVEN_CELLS = {"llama3_2_3b": 4148962560.0, "starcoder2_7b": 7968311040.0}
#: llama3.2-1b's ``train_4k`` counts (rank 0 of the pod mesh, extrapolated)
#: as the parent commit gave them, before the exchange of uneven heads
DIVISIBLE_COUNTS = {
    "collective_bytes_per_device": {"all-reduce": 42104847381.0,
                                    "all-gather": 541539840.0},
    "collective_op_counts": {"all-gather": 210.0, "all-reduce": 121.0,
                             "reduce-scatter": 0.0, "all-to-all": 0.0,
                             "collective-permute": 0.0},
    "cost_analysis": {"flops": 42080650919936.0,
                      "bytes accessed": 3167937167052.0,
                      "kernel_flops": 0.0},
    "memory_analysis": {"argument_size_in_bytes": 348382212.0,
                        "output_size_in_bytes": 38650896.0,
                        "temp_size_in_bytes": 14086813080.0,
                        "alias_size_in_bytes": 38650880.0,
                        "peak_bytes": 14435195292.0,
                        "state_bytes": 347857924.0}}
#: the keys of the reference's ``lower_cell`` result
REF_KEYS = ("arch", "shape", "mesh", "n_devices", "kind", "attn_impl",
            "unrolled", "status", "seconds_lower", "seconds_compile",
            "memory_analysis", "cost_analysis",
            "collective_bytes_per_device", "collective_op_counts")
REF_MEMORY = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "alias_size_in_bytes")


@pytest.fixture(autouse=True)
def no_group_here():
    """No test leaves this process with a process group or JAX's forced
    host devices (the xdist worker runs other files after this one)."""
    flags = os.environ.get("XLA_FLAGS")
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()
    assert os.environ.get("XLA_FLAGS") == flags


def _child(code: str, *args: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", code, *args], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _output(proc: subprocess.Popen) -> str:
    try:
        out, err = proc.communicate(timeout=CHILD_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-4000:]
    return out


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Every child process of the file, started together: the four real
    ranks, the fake ranks, the specs and counts, the extrapolation check,
    the reference's depths and the CLI."""
    tmp = tmp_path_factory.mktemp("dryrun")
    ranks = mp.start_processes(R.dryrun_ranks, args=(4, str(tmp)), nprocs=4,
                               join=False, start_method="spawn")
    procs = {"fake": _child(FAKE, str(tmp)), "specs": _child(SPECS),
             "account": _child(ACCOUNT), "ref_depths": _child(REF_DEPTHS),
             "cli": _child(CLI, str(tmp / "cli"))}
    done = {}

    def wait(name: str):
        if name not in done:
            if name == "ranks":
                for _ in range(CHILD_TIMEOUT):
                    if ranks.join(timeout=1):
                        break
                else:
                    raise TimeoutError("the gloo ranks did not finish")
                done[name] = {r: torch.load(tmp / f"dryrun_real.{r}.pt")
                              for r in R.DRYRUN_RANKS}
            elif name == "fake":
                _output(procs["fake"])
                done[name] = {r: torch.load(tmp / f"dryrun_fake.{r}.pt")
                              for r in R.DRYRUN_RANKS}
            elif name == "cli":
                _output(procs["cli"])
                done[name] = tmp / "cli"
            else:
                done[name] = json.loads(
                    _output(procs[name]).strip().splitlines()[-1])
        return done[name]
    yield wait
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()
    for p in ranks.processes:
        if p.is_alive():
            p.kill()
            p.join(timeout=10)


# ---------------------------------------------------------------------------
# (a) the reference's pure pieces
# ---------------------------------------------------------------------------


def test_shape_grid_and_runnable_cells_match_reference():
    assert list(SHAPES) == list(REF_SHAPES)
    for name, s in SHAPES.items():
        r = REF_SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == \
            (r.name, r.seq_len, r.global_batch, r.kind)
    for arch in ARCH_IDS:
        for name in SHAPES:
            assert cell_is_runnable(get_config(arch), SHAPES[name]) == \
                ref_runnable(ref_get_config(arch), REF_SHAPES[name]), \
                (arch, name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_depth_cfgs_match_reference(children, arch):
    c1, c2, *depths = D.reduced_depth_cfgs(get_config(arch))
    got = [[getattr(c, f) for f in DEPTH_FIELDS] for c in (c1, c2)]
    assert got + depths == children("ref_depths")[arch]


# ---------------------------------------------------------------------------
# (b) step inputs and (c) parameter counts of every full config
# ---------------------------------------------------------------------------


def _ref_specs(arch: str, name: str) -> dict:
    cfg, shape = ref_get_config(arch), REF_SHAPES[name]
    if shape.kind != "decode":
        tree = ref_train_specs(cfg, shape)
    else:
        s = ref_decode_specs(cfg, shape)
        tree = {k: v for k, v in s.items() if k != "cache"}
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                s["cache"])[0]:
            tree["cache." + ".".join(p.key for p in path)] = leaf
    return {k: [list(v.shape), str(v.dtype)] for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference_eval_shape(children, arch):
    specs = children("specs")["specs"]
    for name in SHAPES:
        assert specs[f"{arch}/{name}"] == _ref_specs(arch, name), name


def _roofline():
    spec = importlib.util.spec_from_file_location(
        "roofline", REPO / "benchmarks" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_reference_eval_shape(children, arch):
    """Total parameters equal the reference's ``jax.eval_shape`` count and
    active ones its formula (``benchmarks/roofline.py``'s
    ``param_count``)."""
    got = children("specs")["params"][arch]
    want = _roofline().param_count(arch)
    assert got == {"total": want["total"], "active": want["active"]}


# ---------------------------------------------------------------------------
# (d) fake ranks on meta against real gloo ranks
# ---------------------------------------------------------------------------


def _cells(children):
    real, fake = children("ranks"), children("fake")
    for rank in R.DRYRUN_RANKS:
        for (arch, shape), r, f in zip(R.DRYRUN_CELLS, real[rank]["cells"],
                                       fake[rank]["cells"]):
            yield f"{arch} {shape[0]} rank {rank}", arch, r, f


def test_fake_ranks_count_the_collectives_of_real_ranks(children):
    for what, _, real, fake in _cells(children):
        assert real["status"] == fake["status"] == "ok", what
        assert fake["collective_op_counts"] == \
            real["collective_op_counts"], what
        assert sum(real["collective_op_counts"].values()) > 0, what
        assert fake["collective_bytes_per_device"] == \
            real["collective_bytes_per_device"], what


def test_fake_ranks_hold_the_state_of_real_ranks(children):
    for what, _, real, fake in _cells(children):
        for k in ("state_bytes", "argument_size_in_bytes",
                  "output_size_in_bytes", "alias_size_in_bytes"):
            assert fake["memory_analysis"][k] == \
                real["memory_analysis"][k], (what, k)
        assert fake["params"] == real["params"], what


def test_decode_cells_report_the_reference_placements_cache_bytes(
        children):
    """A decode cell's ``cache_bytes`` (the rank's cache) equal the
    reference placement's where the data axes split the rows; a batch of
    one row is held whole on each data rank, so the rank holds more than
    the reference's slices and moves none of it between steps."""
    seen = set()
    for what, _, real, fake in _cells(children):
        if real["kind"] != "decode":
            continue
        for res in (real, fake):
            mem = res["memory_analysis"]
            assert mem["cache_bytes"] == real["memory_analysis"][
                "cache_bytes"], what
            if "one_row" in what:
                assert mem["cache_bytes"] > mem["reference_cache_bytes"], \
                    what
            else:
                assert mem["cache_bytes"] == mem["reference_cache_bytes"], \
                    what
        seen.add("one_row" in what)
    assert seen == {True, False}


def _outside_routed_experts(flops: dict, cfg) -> float:
    """The step's operations less those of the MoE modules (router and
    routed experts), their shared experts kept."""
    moe = [f"Transformer.blocks.{i}.ffn"
           for i in range(cfg.first_k_dense, cfg.n_layers)]
    assert all(m in flops for m in moe), sorted(flops)
    return flops["Global"] - sum(flops[m] - flops.get(f"{m}.shared", 0)
                                 for m in moe)


def test_fake_ranks_count_the_flops_of_real_ranks(children):
    for what, arch, real, fake in _cells(children):
        # the dry run's count is FlopCounterMode's, run beside it
        for res in (real, fake):
            assert res["cost_analysis"]["flops"] == \
                res["flops_by_module"]["Global"], what
        want = real["flops_by_module"]
        got = fake["flops_by_module"]
        cfg = get_config(arch, smoke=True)
        if cfg.moe is None:
            assert fake["cost_analysis"]["flops"] == want["Global"], what
        else:
            assert fake["moe_routing"] == "balanced"
            outside = _outside_routed_experts(want, cfg)
            assert _outside_routed_experts(got, cfg) == outside, what
            assert 0 < outside < want["Global"], what


@pytest.mark.parametrize("arch", R.WHOLE_ROWS_ARCHS)
def test_one_row_decode_on_the_mesh_matches_one_device(children, arch):
    """A batch of one row, fewer than the data ranks: the cache is held
    in the layout its layer decodes, every row on each data rank and the
    data axes on no dim; the logits and every rank's cache slices equal
    one device's."""
    for rank, res in children("ranks").items():
        w = res["whole_rows"][arch]
        specs = []
        cache_map(lambda p, spec: specs.append(spec), w["specs"])
        assert specs and all("data" not in spec for spec in specs), specs
        for got, want in zip(w["logits"], w["one_logits"]):
            tol = 1e-5 * float(want.abs().max())
            torch.testing.assert_close(got, want, rtol=1e-5, atol=tol)
        got, want = {}, {}
        cache_map(lambda p, t: got.update({p: t}), w["cache"])
        cache_map(lambda p, t: want.update({p: t}), w["one_cache"])
        assert got and got.keys() == want.keys()
        for path, t in got.items():
            torch.testing.assert_close(t, want[path], rtol=1e-5, atol=1e-5,
                                       msg=f"rank {rank} {path}")


# ---------------------------------------------------------------------------
# (e) the two-depth extrapolation and (f) the CLI
# ---------------------------------------------------------------------------

EXACT = ("cost_analysis", "collective_bytes_per_device",
         "collective_op_counts", "params")


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_account_equals_the_full_depth_run(children, kind):
    res = children("account")[kind]
    acc, full = res["account"], res["full"]
    assert acc["accounting"] == "extrapolated"
    assert acc["depths"] == {"l1": 1, "l2": 2, "l_full": 4}
    for sec in EXACT:
        assert acc[sec] == pytest.approx(full[sec], rel=1e-12), sec
    for k in ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "state_bytes"):
        assert acc["memory_analysis"][k] == \
            pytest.approx(full["memory_analysis"][k], rel=1e-12), k
    if kind == "prefill":
        assert full["cost_analysis"]["kernel_flops"] > 0


def test_cli_writes_the_reference_keys_with_jax_blocked(children):
    out = children("cli")
    res = json.loads((out / "llama3_2_1b.train_4k.pod.json").read_text())
    assert set(REF_KEYS) <= set(res)
    assert res["status"] == "ok" and res["accounting"] == "extrapolated"
    assert (res["mesh"], res["n_devices"], res["kind"]) == \
        ("16x16", 256, "train")
    assert set(REF_MEMORY) <= set(res["memory_analysis"])
    assert {"flops", "bytes accessed"} <= set(res["cost_analysis"])
    assert set(res["collective_op_counts"]) == set(D.REF_COLLECTIVES)
    assert res["params"]["total"] == 1235814400
    # a rank's share of 6 N T, at least: 256 x 4,096 tokens over 256 ranks
    assert res["cost_analysis"]["flops"] > \
        6 * res["params"]["total"] * 256 * 4096 / 256
    uneven = json.loads((out / "llama3_2_3b.train_4k.pod.json").read_text())
    assert uneven["status"] == "ok" and uneven["tp_heads"] == [2, 1]


def test_divisible_cell_counts_equal_the_parent_commits(children):
    res = json.loads((children("cli") /
                      "llama3_2_1b.train_4k.pod.json").read_text())
    for sec, want in DIVISIBLE_COUNTS.items():
        assert res[sec] == want, sec
    assert "fetch_bytes_per_device" not in res


def _shard_shapes(arch: str, tp: int = 16) -> set:
    """The shapes of a rank's shards of ``wq``, ``wo`` and ``wk`` / ``wv``
    on a model axis of ``tp``."""
    cfg = get_config(arch)
    d, q, kv = cfg.d_model, cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    return {(d, q // tp), (q // tp, d), (d, kv // tp)}


def _fetch_bytes(arch: str, rank: int = 0, tp: int = 16) -> int:
    """The bytes that ``rank``'s served model sends to fetch its heads'
    columns of ``wq``, ``wo``, ``wk`` and ``wv`` once, in the activation
    dtype (bf16), worked out from ``head_blocks`` and the equal shards: the
    parts of its shards in the other ranks' blocks."""
    from repro_torch.models.layers import head_blocks
    cfg = get_config(arch)
    blocks = [head_blocks(cfg.n_heads, cfg.n_kv_heads, tp, r)
              for r in range(tp)]
    sent = 0
    for kv, copies in ((0, 2), (1, 2)):
        n = (cfg.n_kv_heads if kv else cfg.n_heads) * cfg.hd // tp
        for j, b in enumerate(blocks):
            lo, hi = b[2 * kv] * cfg.hd, b[2 * kv + 1] * cfg.hd
            if j != rank:
                sent += copies * max(0, min(hi, (rank + 1) * n)
                                     - max(lo, rank * n))
    return sent * cfg.d_model * 2 * cfg.n_layers


@pytest.mark.parametrize("arch", list(UNEVEN_CELLS))
def test_uneven_cells_exchange_their_heads_columns(children, arch):
    """Where the q heads do not divide the model axis, a ``train_4k`` step
    moves its heads' columns by all-to-all, at most a tenth of the parent
    commit's whole-weight gathers, and no rank all-gathers a shard of
    ``wq``, ``wo``, ``wk`` or ``wv`` over the model axis (what it
    all-gathers there is activations)."""
    out = children("cli")
    res = json.loads((out / f"{arch}.train_4k.pod.json").read_text())
    a2a = res["collective_bytes_per_device"]["all-to-all"]
    assert 0 < a2a <= UNEVEN_CELLS[arch] / 10
    assert res["collective_op_counts"]["all-to-all"] > 0
    gathered = json.loads((out / "gathered.json").read_text())
    model = [tuple(shape) for axis, shape in gathered[f"{arch}.train_4k"]
             if axis == "model"]
    assert not _shard_shapes(arch) & set(model), model


def test_uneven_decode_fetches_its_blocks_once_before_the_step(children):
    """llama3.2-3b's decode rank fetches its blocks before the step (the
    ``head_blocks`` figure, reported apart) and its step moves no weight:
    no all-to-all, no shard all-gathered."""
    out = children("cli")
    res = json.loads((out / "llama3_2_3b.decode_32k.pod.json").read_text())
    assert res["fetch_bytes_per_device"] == {
        "all-to-all": _fetch_bytes("llama3_2_3b")}
    assert res["collective_bytes_per_device"].get("all-to-all", 0) == 0
    assert res["collective_op_counts"]["all-to-all"] == 0
    gathered = json.loads((out / "gathered.json").read_text())
    assert not _shard_shapes("llama3_2_3b") & {
        tuple(shape) for _, shape in gathered["llama3_2_3b.decode_32k"]}


def test_cli_reports_a_cell_the_port_cannot_shard(children):
    """An SSM whose 56 heads (``ssm.head_dim=128``) do not split over the
    model axis of 16 is ``unsupported``, with the refusal's text."""
    out = children("cli")
    refused = json.loads((out / "zamba2_7b.train_4k.pod.json").read_text())
    assert refused["status"] == "unsupported"
    assert "SSM: 56 heads" in refused["reason"]


def test_balanced_split_sums_to_the_assignments():
    from repro_torch.models.layers import balanced_sizes
    for n, e in ((0, 4), (7, 4), (4096 * 6, 64), (5, 8)):
        sizes = balanced_sizes(n, e)
        assert len(sizes) == e and sum(sizes) == n
        assert max(sizes) - min(sizes) <= 1
        assert sizes == sorted(sizes, reverse=True)


def test_allowed_count_is_the_mask_sum():
    from repro_torch.kernels.flash_mask.ref import allowed_count, \
        mask_allowed
    for s_q, s_k, kw in ((64, 64, {}), (16, 80, dict(q_offset=64)),
                         (48, 48, dict(window=8, prefix=5)),
                         (32, 40, dict(causal=False, window=6)),
                         (1, 33, dict(q_offset=32, window=4, prefix=2))):
        kw = dict(dict(causal=True, window=0, prefix=0, q_offset=0), **kw)
        assert allowed_count(s_q, s_k, **kw) == \
            int(mask_allowed(s_q, s_k, **kw).sum())


def test_meta_construction_keeps_shapes_and_cpu_draws():
    """A model on meta has the CPU model's parameters, names and shapes;
    drawing on the CPU gives the weights it gave before (a generator on
    the device)."""
    from repro_torch.models import transformer as T
    cfg = get_config("moonshot_v1_16b_a3b", smoke=True)
    meta = T.init_params(cfg, seed=3, device="meta")
    cpu = T.init_params(cfg, seed=3, device="cpu")
    g = torch.Generator(device="cpu").manual_seed(3)
    again = T.init_params(cfg, g)
    assert [(n, p.shape, p.dtype) for n, p in meta.named_parameters()] == \
        [(n, p.shape, p.dtype) for n, p in cpu.named_parameters()]
    assert all(p.device.type == "meta" for p in meta.parameters())
    for (n, a), (_, b) in zip(cpu.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n
    assert D.param_counts(cfg, meta) == D.param_counts(cfg, cpu)
    assert math.prod(meta.embed.shape) == cfg.vocab_size * cfg.d_model
