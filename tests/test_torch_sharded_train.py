"""Sharded training on ranks: processes spawned by ``torch.multiprocessing``
on the CPU, a gloo group on a ``FileStore``, one intra-op thread a rank
(``tests/torch_sharded_ranks.py``), held to the reference and to the
port's single-device training.  Two spawns (four ranks on a (2, 2) mesh,
then two on (1, 2)) and one ``torchrun``.

* **Sharded step**: llama3.2-1b SMOKE from the reference's weights
  (``load_reference_state``), sliced onto the mesh exactly as the
  single-device tensors' slices; 3 steps with ZeRO-1, each loss within
  1e-5 relative of the port's single-device step and of the reference's
  single-device ``make_train_step`` (the reference's own sharded step
  fails under this JAX in its embedding gather, and GSPMD is defined to
  equal the single-device step); parameters after 3 steps within rtol
  2e-4 / atol 2e-5 of the single-device port's.
* **ZeRO-1** on and off give bitwise equal parameters (AdamW is
  elementwise and the norm is computed alike); **microbatches** 2 within
  1e-5 of 1; a **compressed** step runs and is finite.
* **Families**: stablelm, starcoder2 (biases, GELU), moonshot (the
  expert-parallel MoE at a capacity that drops nothing, and with ``ep``
  off: the dense dispatch on all-gathered experts) and internvl2 on
  (2, 2), xlstm, zamba2, seamless and deepseek (MLA) data-parallel on
  (4, 1) and again tensor-parallel on (2, 2) (MLA, cross-attention, the
  SSM and the xLSTM on the model axis), llama3.2-1b on (1, 4) (its two
  K/V heads split mid-head over four ranks): 3 steps from one seed, losses within 1e-5 relative and
  gradient norms within 1e-4 of the single-device step's.
* **Expert-parallel MoE** (moonshot SMOKE, capacity factors 1.5 and 0.5,
  so that the second drops assignments) against the reference's
  ``_apply_moe_ep`` under a (2, 2) mesh in a child with four host
  devices, and against the port's one-device restatement of the same
  capacity and drops (``layers.moe_ep_plain``) with equal rows per
  expert: rtol 1e-5 / atol 1e-6.
* **Compressed reduction** (``allreduce_compressed_group``) on 4 and 2
  ranks: means and error carries within rtol 1e-6 of the reference's
  ``shard_map`` outputs.
* **Elastic restart**, as the reference's ``tests/ft_check.py``: 4 ranks
  checkpoint every 2 steps and stop after 4; 2 ranks resume from LATEST
  to step 6; their losses within 1e-6 relative of an uninterrupted
  4-rank run.  The sharded checkpoint also restores on one device (the
  next two steps within 1e-5 of the sharded run's).
* **Launcher**: ``torchrun --nproc-per-node 2 -m repro_torch.launch.train
  --mesh auto --device cpu --backend gloo`` trains as the one-device
  launcher does (its printed losses within 2e-4).
"""
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.configs.base import get_config as ref_get_config
from repro.data import pipeline as RP
from repro.models import transformer as RT
from repro.optim.adamw import AdamW as RefAdamW
from repro.train import train_step as RTS
from repro_torch.configs.base import get_config
from repro_torch.convert import load_reference_params, load_reference_state
from repro_torch.data.pipeline import SyntheticLM, batch_for
from repro_torch.launch.train import run
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_step import init_state, make_train_step

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_sharded_ranks as R  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"

REF_CHILD = r"""
import dataclasses, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import set_mesh, shard_map
from repro.configs.base import get_config
from repro.models import layers as RL, transformer as RT
from repro.train.compression import allreduce_compressed
assert jax.device_count() == 4, jax.devices()
inp = np.load(sys.argv[1])
out = {}
base = get_config("moonshot_v1_16b_a3b", smoke=True)
params = RT.init_params(base, jax.random.PRNGKey(0))
layer = jax.tree.map(lambda a: a[0], params["layers_moe"]["ffn"])
mesh = jax.make_mesh((2, 2), ("data", "model"))
for cf in (1.5, 0.5):
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=cf))
    with set_mesh(mesh):
        y = jax.jit(lambda p, x: RL.apply_moe(p, cfg, x))(
            layer, jnp.asarray(inp["x"]))
    out[f"moe{cf}"] = np.asarray(y)
for p in (2, 4):
    m = jax.make_mesh((p,), ("data",), devices=jax.devices()[:p])
    def local(g, e, h):
        mean, err = allreduce_compressed({"w": g[0], "u": h[0]},
                                         {"w": e[0], "u": e[0][:6]},
                                         ("data",))
        return mean["w"][None], err["w"][None], mean["u"][None], \
            err["u"][None]
    f = shard_map(local, mesh=m, in_specs=(P("data"),) * 3,
                  out_specs=(P("data"),) * 4)
    r = f(jnp.asarray(inp[f"g{p}"]), jnp.asarray(inp[f"e{p}"]),
          jnp.asarray(inp[f"h{p}"]))
    for name, x in zip(("mean_w", "err_w", "mean_u", "err_u"), r):
        out[f"{name}{p}"] = np.asarray(x)
np.savez(sys.argv[2], **out)
print("REF_OK")
"""


def spawn(fn, world: int, tmp: Path) -> None:
    mp.spawn(fn, args=(world, str(tmp)), nprocs=world, join=True)


def port_state(cfg, rstate, opt):
    state = init_state(cfg, opt, device=CPU)
    load_reference_state(state, rstate)
    return state


def state_tensors(state) -> dict:
    out = {}
    for n, p in state.model.named_parameters():
        out[n] = p.detach().clone()
        out[f"m.{n}"] = state.opt.m[n].clone()
        out[f"v.{n}"] = state.opt.v[n].clone()
    out["step"] = state.opt.step.clone()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything the tests read: the single-device runs, the reference's
    outputs and the two spawns' results."""
    tmp = tmp_path_factory.mktemp("sharded")
    out = {"tmp": tmp}
    # llama: the reference's state, its single-device steps and the port's
    rcfg, cfg = (ref_get_config("llama3_2_1b", smoke=True),
                 get_config("llama3_2_1b", smoke=True))
    ref_opt, opt = RefAdamW(**R.STEP_OPT), AdamW(**R.STEP_OPT)
    rstate = RTS.init_state(rcfg, jax.random.PRNGKey(0), ref_opt)
    state = port_state(cfg, rstate, opt)
    torch.save(state_tensors(state), tmp / "llama_state.pt")
    rpipe = RP.SyntheticLM(cfg.vocab_size, **R.STEP_PIPE)
    pipe = SyntheticLM(cfg.vocab_size, **R.STEP_PIPE)
    rstep = jax.jit(RTS.make_train_step(rcfg, ref_opt))
    step = make_train_step(cfg, opt)
    out["ref_losses"], out["single_losses"] = [], []
    for i in range(R.STEPS):
        rstate, rm = rstep(rstate, RP.batch_for(rcfg, rpipe, i))
        state, m = step(state, batch_for(cfg, pipe, i, device=CPU))
        out["ref_losses"].append(float(rm["loss"]))
        out["single_losses"].append(float(m["loss"]))
    out["single_params"] = {n: p.detach().clone()
                            for n, p in state.model.named_parameters()}
    # moonshot's MoE block on the reference's weights, and x
    mcfg = get_config("moonshot_v1_16b_a3b", smoke=True)
    model = T.init_params(mcfg, device=CPU)
    load_reference_params(model, RT.init_params(
        ref_get_config("moonshot_v1_16b_a3b", smoke=True),
        jax.random.PRNGKey(0)))
    x = np.random.default_rng(5).standard_normal(
        (4, 8, mcfg.d_model)).astype(np.float32)
    torch.save({"params": {n: p.detach().clone() for n, p in
                           model.named_parameters()},
                "x": torch.as_tensor(x)}, tmp / "moe_in.pt")
    out["moe_model"], out["moe_x"] = model, torch.as_tensor(x)
    # the compressed reduction's inputs (the existing child's draws)
    rng = np.random.default_rng(7)
    comp = {}
    for p in (2, 4):
        comp[f"g{p}"] = (rng.standard_normal((p, 64)) * 0.1).astype(
            np.float32)
        comp[f"e{p}"] = (rng.standard_normal((p, 64)) * 1e-3).astype(
            np.float32)
        comp[f"h{p}"] = rng.standard_normal((p, 6)).astype(np.float32)
    torch.save({k: torch.as_tensor(v) for k, v in comp.items()},
               tmp / "compress_in.pt")
    out["comp"] = comp
    np.savez(tmp / "ref_in.npz", x=x, **comp)
    child = subprocess.Popen(
        [sys.executable, "-c", REF_CHILD, str(tmp / "ref_in.npz"),
         str(tmp / "ref_out.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                 JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    spawn(R.four_ranks, 4, tmp)
    spawn(R.two_ranks, 2, tmp)
    stdout, stderr = child.communicate(timeout=300)
    assert child.returncode == 0 and "REF_OK" in stdout, stdout + stderr
    out["ref"] = dict(np.load(tmp / "ref_out.npz"))
    out["four"] = torch.load(tmp / "four.pt")
    out["two"] = torch.load(tmp / "two.pt")
    return out


def rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def test_sharded_state_is_the_single_device_slices(runs):
    four = runs["four"]
    assert four["exact_slices"]
    shapes = four["local_shapes"]
    assert shapes["embed"] == (256, 64)          # vocab rows over model 2
    assert shapes["blocks.0.attn.wq"] == (64, 32)
    assert shapes["blocks.0.ffn.w_down"][1] == 64
    assert shapes["blocks.0.ln1.scale"] == (64,)


def test_sharded_steps_match_single_device_and_reference(runs):
    got = runs["four"]["losses"]
    for g, s, r in zip(got, runs["single_losses"], runs["ref_losses"]):
        assert rel(g, s) <= 1e-5 and rel(g, r) <= 1e-5, (g, s, r)
    for n, want in runs["single_params"].items():
        np.testing.assert_allclose(runs["four"]["params"][n].numpy(),
                                   want.numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=n)


def test_zero1_moments_leave_parameters_bitwise_equal(runs):
    four = runs["four"]
    assert four["losses_no_zero1"] == four["losses"]
    for n, p in four["params"].items():
        assert torch.equal(p, four["params_no_zero1"][n]), n


@pytest.mark.parametrize("arch", R.TP_FAMILIES + R.DP_FAMILIES
                         + (R.TP_WIDE,) + R.TP_MORE)
def test_families_match_single_device(runs, arch):
    cfg = R.family_config(arch)
    opt = AdamW(**R.STEP_OPT)
    state = init_state(cfg, opt, seed=3, device=CPU)
    pipe = SyntheticLM(cfg.vocab_size, **R.FAMILY_PIPE)
    step = make_train_step(cfg, opt)
    losses, norms = runs["four"]["families"][arch]
    for i in range(R.FAMILY_STEPS):
        state, m = step(state, batch_for(cfg, pipe, i, device=CPU))
        assert rel(losses[i], float(m["loss"])) <= 1e-5, (i, losses)
        assert rel(norms[i], float(m["grad_norm"])) <= 1e-4, (i, norms)


def test_microbatches_match_one_batch(runs):
    for a, b in zip(runs["four"]["losses_mb2"], runs["four"]["losses"]):
        assert rel(a, b) <= 1e-5


def test_compressed_step_runs_finite(runs):
    losses = runs["four"]["losses_compressed"]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert rel(losses[0], runs["four"]["losses"][0]) <= 1e-5


@pytest.mark.parametrize("cf", R.MOE_CAPACITIES)
def test_expert_parallel_moe_matches_reference(runs, cf):
    import dataclasses
    base = get_config("moonshot_v1_16b_a3b", smoke=True)
    cfg = base.replace(moe=dataclasses.replace(base.moe, capacity_factor=cf))
    moe = runs["moe_model"].blocks[cfg.first_k_dense].ffn
    want = runs["ref"][f"moe{cf}"]
    got = runs["four"]["moe"][cf]
    np.testing.assert_allclose(got["y"].numpy(), want, rtol=1e-5, atol=1e-6)
    # the one-device restatement, on each data shard's rows
    x = runs["moe_x"]
    plain, sizes = zip(*(L.moe_ep_plain(moe, cfg, x[i * 2:(i + 1) * 2], 2)
                         for i in range(2)))
    np.testing.assert_allclose(torch.cat(plain).numpy(), want, rtol=1e-5,
                               atol=1e-6)
    # rank 0 is (data 0, model 0): its rows per local expert
    assert got["sizes"] == sizes[0][0]
    t_local = 2 * 8
    dropped = t_local * cfg.moe.top_k - sum(sum(s) for s in sizes[0])
    assert (dropped > 0) == (cf < 1.0)


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_reduction_matches_reference(runs, world):
    ref = runs["ref"]
    got = runs["four" if world == 4 else "two"]["compressed"]
    for name in ("w", "u"):
        for i in range(world):
            np.testing.assert_allclose(got["mean"][name].numpy(),
                                       ref[f"mean_{name}{world}"][i],
                                       rtol=1e-6, atol=0)
            np.testing.assert_allclose(got["err"][name][i].numpy(),
                                       ref[f"err_{name}{world}"][i],
                                       rtol=1e-6, atol=1e-9)


def test_elastic_restart_on_fewer_ranks(runs):
    four, two = runs["four"], runs["two"]
    assert two["last"] == R.FT_CRASH_AFTER
    assert two["mesh"] == {"data": 1, "model": 2}
    oracle = four["ft_oracle"]
    assert four["ft_full"] == oracle[:R.FT_CRASH_AFTER]
    assert len(two["resumed"]) == R.FT_STEPS - R.FT_CRASH_AFTER
    for got, want in zip(two["resumed"], oracle[R.FT_CRASH_AFTER:]):
        assert rel(got, want) <= 1e-6, (got, want)


def test_sharded_checkpoint_restores_on_one_device(runs):
    cfg = get_config("llama3_2_1b", smoke=True)
    opt = AdamW(**R.FT_OPT)
    mgr = CheckpointManager(str(runs["tmp"] / "ckpt"))
    state = mgr.restore(R.FT_CRASH_AFTER, init_state(cfg, opt, seed=0,
                                                     device=CPU))
    assert int(state.opt.step) == R.FT_CRASH_AFTER
    pipe = SyntheticLM(cfg.vocab_size, **R.FT_PIPE)
    step = make_train_step(cfg, opt)
    oracle = runs["four"]["ft_oracle"]
    for i in range(R.FT_CRASH_AFTER, R.FT_STEPS):
        state, m = step(state, batch_for(cfg, pipe, i, device=CPU))
        assert rel(float(m["loss"]), oracle[i]) <= 1e-5


def test_launcher_trains_on_two_ranks(runs, tmp_path):
    args = ["--arch", "llama3_2_1b", "--smoke", "--steps", "4", "--batch",
            "2", "--seq", "16", "--log-every", "1", "--device", CPU]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *args,
         "--mesh", "auto", "--backend", "gloo",
         "--ckpt-dir", str(tmp_path / "ck")], capture_output=True,
        text=True, timeout=300, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    sharded = [float(x) for x in re.findall(r"loss (\S+)", proc.stdout)]
    assert len(sharded) == 4, proc.stdout
    single, _ = run("llama3_2_1b", smoke=True, steps=4, batch=2, seq=16,
                    device=CPU)
    np.testing.assert_allclose(sharded, single, rtol=0, atol=2e-4)
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 4
