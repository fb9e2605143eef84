"""The port's launcher layer on the CPU: the elastic mesh arithmetic and
``plan_restart`` against the reference (in a child with eight host
devices), ``Heartbeat``, the training CLI (a loss that drops, checkpoints,
resume) and a crash and resume in child processes against an
uninterrupted run and against the reference's one-device trajectory.

The reference's own crash test (``tests/ft_check.py``, 8 -> 4 devices)
fails under this JAX's explicit sharding, so the port is held to the
reference's single-device training, which works.  Tolerances: the
resumed losses equal the uninterrupted run's bitwise (stateless data and
full-state checkpoints on one device); all six lie within 1e-4 of the
reference's, the bound its test sets for steps before the crash.
"""
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs.base import get_config as ref_get_config
from repro.data import pipeline as RP
from repro.optim.adamw import AdamW as RefAdamW
from repro.train import train_step as RTS
from repro_torch.configs.base import get_config
from repro_torch.convert import load_reference_state
from repro_torch.launch.elastic import Heartbeat, plan_restart
from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.launch.train import run
from repro_torch.optim.adamw import AdamW
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_step import init_state

REPO = Path(__file__).resolve().parents[1]
TPS = (2, 4, 16)


def port_env(**extra):
    return dict(os.environ, PYTHONPATH=str(REPO / "src"), **extra)


# ---------------------------------------------------------------------------
# elastic
# ---------------------------------------------------------------------------


ELASTIC_CHILD = r"""
import json
import jax
from repro.launch.elastic import plan_restart
assert jax.device_count() == 8, jax.devices()
print(json.dumps({f"{n},{tp}": plan_restart(n, model_parallel=tp)
                  for tp in (2, 4, 16) for n in range(1, 9)}))
"""


def test_plan_restart_matches_reference_on_eight_devices():
    proc = subprocess.run(
        [sys.executable, "-c", ELASTIC_CHILD], capture_output=True,
        text=True, timeout=300,
        env=port_env(JAX_PLATFORMS="cpu",
                     XLA_FLAGS="--xla_force_host_platform_device_count=8"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    for tp in TPS:
        for n in range(1, 9):
            got = plan_restart(n, model_parallel=tp)
            assert got == want[f"{n},{tp}"], (n, tp, got)
            assert make_elastic_mesh(n, model_parallel=tp) == \
                got["mesh_shape"]
            assert got["dp"] * got["tp"] == n


def test_elastic_mesh_rejects_no_devices():
    with pytest.raises(ValueError):
        make_elastic_mesh(0)


def test_heartbeat_healthy_stale_and_missing(tmp_path):
    hb = Heartbeat(str(tmp_path / "worker0"), timeout_s=60.0)
    assert not hb.healthy()                  # missing
    hb.beat()
    assert hb.healthy()
    (tmp_path / "worker0").write_text(str(time.time() - 120.0))
    assert not hb.healthy()                  # stale
    (tmp_path / "worker0").write_text("not a time")
    assert not hb.healthy()                  # unreadable


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def launch(*args, timeout=600):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO,
        env=port_env())


def logged_losses(out: str) -> dict:
    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"\[train\] step (\d+) loss ([0-9.]+)",
                                 out)}


def test_launcher_cli_learns_checkpoints_and_resumes(tmp_path):
    """``examples/train_lm.py --tiny``'s run on the port's CLI: the smoke
    llama at lr 3e-3 drops its loss by more than 0.5 in 30 steps; a rerun
    with more steps resumes from the last checkpoint."""
    ckpt = str(tmp_path / "ckpt")
    common = ["--arch", "llama3_2_1b", "--smoke", "--batch", "4", "--seq",
              "64", "--lr", "3e-3", "--device", "cpu", "--ckpt-dir", ckpt,
              "--ckpt-every", "10"]
    proc = launch(*common, "--steps", "30")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    losses = logged_losses(proc.stdout)
    assert sorted(losses) == [0, 10, 20, 29]
    assert losses[29] < losses[0] - 0.5, losses
    mgr = CheckpointManager(ckpt)
    assert mgr.all_steps() == [10, 20, 30] and mgr.latest_step() == 30
    again = launch(*common, "--steps", "32")
    assert again.returncode == 0, again.stdout + again.stderr
    assert "[train] resumed from step 30" in again.stdout
    assert sorted(logged_losses(again.stdout)) == [30, 31]
    assert mgr.latest_step() == 32


def test_launcher_log_every(monkeypatch, capsys):
    """``--log-every k`` prints the loss at every k-th step and the last."""
    from repro_torch.launch import train as launcher
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "llama3_2_1b", "--smoke", "--steps", "5",
        "--batch", "2", "--seq", "16", "--device", "cpu",
        "--log-every", "2"])
    launcher.main()
    assert sorted(logged_losses(capsys.readouterr().out)) == [0, 2, 4]


def test_launcher_refuses_a_pod_mesh():
    """A pod mesh needs its 256 (512) ranks; a world of one is refused
    before anything starts."""
    for kind, need in (("pod", 256), ("multipod", 512)):
        with pytest.raises(ValueError, match=f"pod of {need} ranks; this "
                                             f"world has 1"):
            run("llama3_2_1b", smoke=True, steps=1, batch=2, seq=16,
                mesh_kind=kind, device="cpu")


# ---------------------------------------------------------------------------
# crash and resume
# ---------------------------------------------------------------------------

STEPS, CKPT_EVERY, CRASH_AFTER = 6, 2, 4

FT_CHILD = r"""
import os
import sys
sys.modules["jax"] = None            # the port trains without JAX
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import SyntheticLM, batch_for
from repro_torch.optim.adamw import AdamW
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_step import init_state, make_train_step

phase, init_dir, ckpt = sys.argv[1:4]
STEPS, CKPT_EVERY, CRASH_AFTER = 6, 2, 4
cfg = get_config("llama3_2_1b", smoke=True)
opt = AdamW(lr=1e-3, warmup=2, total_steps=STEPS, weight_decay=0.0)
pipe = SyntheticLM(cfg.vocab_size, 16, 8, seed=11)
state = CheckpointManager(init_dir).restore(
    0, init_state(cfg, opt, seed=1, device="cpu"))
start = 0
mgr = CheckpointManager(ckpt) if phase != "oracle" else None
if phase == "resume":
    last = mgr.latest_step()
    assert last == CRASH_AFTER, last
    state = mgr.restore(last, state)
    start = last
step_fn = make_train_step(cfg, opt)
for step in range(start, STEPS):
    state, m = step_fn(state, batch_for(cfg, pipe, step, device="cpu"))
    print(f"LOSS {step} {float(m['loss']).hex()}", flush=True)
    if phase == "full" and (step + 1) % CKPT_EVERY == 0:
        mgr.save(step + 1, state, asynchronous=True)
    if phase == "full" and step + 1 == CRASH_AFTER:
        mgr.wait()
        print("CRASH", flush=True)
        os._exit(42)               # a node failure: no clean-up
print("DONE", flush=True)
"""


def ft_phase(phase, init_dir, ckpt):
    return subprocess.run(
        [sys.executable, "-c", FT_CHILD, phase, init_dir, ckpt],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=port_env())


def ft_losses(out: str) -> dict:
    return {int(m.group(1)): float.fromhex(m.group(2))
            for m in re.finditer(r"LOSS (\d+) (\S+)", out)}


def test_crash_and_resume_match_uninterrupted_and_reference(tmp_path):
    """The reference's fault-tolerance story on one device: a run that
    dies after step 4's checkpoint, resumed, equals an uninterrupted one,
    and both follow the reference's trajectory from the same state."""
    rcfg = ref_get_config("llama3_2_1b", smoke=True)
    ropt = RefAdamW(lr=1e-3, warmup=2, total_steps=STEPS, weight_decay=0.0)
    rstate = RTS.init_state(rcfg, jax.random.PRNGKey(7), ropt)
    cfg = get_config("llama3_2_1b", smoke=True)
    state = init_state(cfg, AdamW(lr=1e-3, warmup=2, total_steps=STEPS,
                                  weight_decay=0.0), device="cpu")
    load_reference_state(state, jax.tree.map(np.asarray, rstate))
    init_dir, ckpt = str(tmp_path / "init"), str(tmp_path / "ckpt")
    CheckpointManager(init_dir).save(0, state)

    rpipe = RP.SyntheticLM(rcfg.vocab_size, 16, 8, seed=11)
    rstep = jax.jit(RTS.make_train_step(rcfg, ropt))
    ref = []
    for step in range(STEPS):
        rstate, m = rstep(rstate, RP.batch_for(rcfg, rpipe, step))
        ref.append(float(m["loss"]))

    full = ft_phase("full", init_dir, ckpt)
    assert full.returncode == 42, full.stdout + full.stderr
    assert "CRASH" in full.stdout
    assert CheckpointManager(ckpt).all_steps() == [2, 4]
    resume = ft_phase("resume", init_dir, ckpt)
    assert resume.returncode == 0, resume.stdout + resume.stderr
    oracle = ft_phase("oracle", init_dir, "")
    assert oracle.returncode == 0, oracle.stdout + oracle.stderr

    l_full, l_res, l_orc = (ft_losses(p.stdout)
                            for p in (full, resume, oracle))
    assert sorted(l_full) == [0, 1, 2, 3] and sorted(l_res) == [4, 5]
    assert sorted(l_orc) == list(range(STEPS))
    for s in range(CRASH_AFTER):
        assert l_full[s] == l_orc[s], (s, l_full[s], l_orc[s])
    for s in (4, 5):
        assert l_res[s] == l_orc[s], (s, l_res[s], l_orc[s])
    for s in range(STEPS):
        assert abs(l_orc[s] - ref[s]) < 1e-4, (s, l_orc[s], ref[s])
