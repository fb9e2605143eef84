"""The port's training path against the reference, SMOKE configs on the
CPU, every state started from the reference's (``load_reference_state``):
the data pipeline and ``concrete_batch`` bit for bit, AdamW's schedule and
update, ``loss_fn`` and its gradients for all ten configs (one backward
through every family's in-place buffers), three train steps, microbatches,
remat, ``moe_aux_loss``, ``_bmm_f32``'s backward, flash under gradients,
checkpoints and the compressed all-reduce (p = 1 in process; p = 2 and 4
against the reference in a child with four host devices).

Tolerances: batches exactly; the schedule rtol 1e-6 and the update rtol
1e-6 / atol 1e-7 (f32 elementwise arithmetic in another order); loss
relative 1e-5 and gradients 1e-4 normwise per parameter (f32 sums in other
orders); parameters after three AdamW steps 1e-4 normwise, because Adam's
first steps turn the sign of a near-zero gradient into a full-size
update; microbatches the reference's own rtol 2e-4 / atol 2e-5
(``tests/test_train_substrate.py``); remat bitwise (the same operations
recomputed); ``moe_aux_loss`` 1e-6; compression exactly on the int8
payloads and 1e-6 on the dequantized values.
"""
import copy
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as ref_get_config
from repro.data import pipeline as RP
from repro.launch.specs import concrete_batch as ref_concrete_batch
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.optim.adamw import AdamW as RefAdamW
from repro.train import train_step as RTS
from repro.train.compression import allreduce_compressed as ref_allreduce
from repro_torch.configs.base import get_config
from repro_torch.convert import load_reference_params, load_reference_state
from repro_torch.core.distributed import make_mesh
from repro_torch.data.pipeline import SyntheticLM, batch_for
from repro_torch.kernels.flash_mask import kernel as flash_kernel
from repro_torch.launch.specs import concrete_batch
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.compression import allreduce_compressed, init_error
from repro_torch.train.train_step import (TrainState, init_state,
                                          make_train_step)

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
SEQ = 32
BATCH = 2
#: one SMOKE config per family
FAMILY_ARCHS = ("llama3_2_1b", "deepseek_v2_lite_16b", "internvl2_2b",
                "xlstm_1_3b", "zamba2_7b", "seamless_m4t_large_v2")


def normwise(got, want) -> float:
    got = torch.as_tensor(np.asarray(got), dtype=torch.float64)
    want = torch.as_tensor(np.asarray(want), dtype=torch.float64)
    den = torch.linalg.norm(want).item()
    return torch.linalg.norm(got - want).item() / (den if den > 0 else 1.0)


def as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    return np.asarray(x, dtype=np.float32) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


def port_tree(model, ref_tree) -> dict:
    """A reference tree of the parameters' structure (gradients, moments)
    as the port's names: loaded into a copy of ``model``."""
    holder = copy.deepcopy(model)
    load_reference_params(holder, jax.tree.map(np.asarray, ref_tree))
    return {n: p.detach() for n, p in holder.named_parameters()}


def port_state(cfg, ref_state, opt) -> TrainState:
    state = init_state(cfg, opt, seed=0, device=CPU)
    load_reference_state(state, jax.tree.map(np.asarray, ref_state))
    return state


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,copy_frac", [(0, 0.5), (3, 1.0), (11, 0.0)])
def test_pipeline_global_batch_and_shards_bitwise(seed, copy_frac):
    kw = dict(vocab_size=97, seq_len=64, global_batch=8, seed=seed,
              copy_frac=copy_frac)
    ref, port = RP.SyntheticLM(**kw), SyntheticLM(**kw)
    for step in (0, 1, 5, 1000):
        np.testing.assert_array_equal(port.global_batch_at(step),
                                      ref.global_batch_at(step))
        for n in (1, 2, 4, 8):
            for i in range(n):
                np.testing.assert_array_equal(port.shard_at(step, i, n),
                                              ref.shard_at(step, i, n))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_for_and_concrete_batch_bitwise(arch, dtype):
    rcfg = ref_get_config(arch, smoke=True).replace(dtype=dtype)
    cfg = get_config(arch, smoke=True).replace(dtype=dtype)
    seq = 48 if cfg.family == "vlm" else 32
    kw = dict(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=4,
              seed=2)
    for got, want in (
            (batch_for(cfg, SyntheticLM(**kw), 3, rng_seed=5, device=CPU),
             RP.batch_for(rcfg, RP.SyntheticLM(**kw), 3, rng_seed=5)),
            (concrete_batch(cfg, 2, seq, seed=1, device=CPU),
             ref_concrete_batch(rcfg, 2, seq, seed=1))):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == {"float32": torch.float32,
                                    "bfloat16": torch.bfloat16,
                                    "int32": torch.int32}[str(want[k].dtype)]
            np.testing.assert_array_equal(as_numpy(got[k]),
                                          as_numpy(want[k]))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def test_adamw_schedule_matches_reference():
    kw = dict(lr=3e-4, warmup=20, total_steps=200, min_lr_frac=0.1)
    ref, port = RefAdamW(**kw), AdamW(**kw)
    steps = np.arange(0, 251, dtype=np.int32)
    got = port.schedule(torch.as_tensor(steps)).numpy()
    want = np.asarray(ref.schedule(jnp.asarray(steps)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("grad_clip", [1.0, 1e6], ids=["clipped",
                                                       "unclipped"])
def test_adamw_update_matches_reference(grad_clip):
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (13,), "c": (3, 4, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    kw = dict(lr=1e-2, warmup=2, total_steps=10, grad_clip=grad_clip)
    ref, port = RefAdamW(**kw), AdamW(**kw)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    rs = ref.init(rp)
    pp = {k: torch.as_tensor(v.copy()) for k, v in params.items()}
    ps = port.init(pp)
    for step in range(5):
        grads = {k: (rng.standard_normal(s) * 3).astype(np.float32)
                 for k, s in shapes.items()}
        rp, rs, rm = ref.update({k: jnp.asarray(g) for k, g in
                                 grads.items()}, rs, rp)
        pp, ps, pm = port.update({k: torch.as_tensor(g) for k, g in
                                  grads.items()}, ps, pp)
        gnorm = float(pm["grad_norm"])
        assert (gnorm > grad_clip) == (grad_clip == 1.0)
        np.testing.assert_allclose(gnorm, float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(pm["lr"]), float(rm["lr"]),
                                   rtol=1e-6)
        assert int(ps.step) == int(rs.step) == step + 1
        for k in shapes:
            for got, want in ((pp[k], rp[k]), (ps.m[k], rs.m[k]),
                              (ps.v[k], rs.v[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-7)


def test_adamw_converges_quadratic():
    """The reference's quadratic, on the port."""
    opt = AdamW(lr=0.1, warmup=1, total_steps=200, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    target = torch.tensor([1.0, 1.0])
    for _ in range(200):
        g = {"w": 2 * (params["w"] - target)}
        params, state, _ = opt.update(g, state, params)
    np.testing.assert_allclose(params["w"].numpy(), [1.0, 1.0], atol=1e-2)


def test_adamw_treats_a_missing_gradient_as_zero():
    opt = AdamW(lr=0.1, warmup=1, total_steps=10)
    a = {"w": torch.ones(3), "u": torch.ones(2)}
    b = copy.deepcopy(a)
    sa, sb = opt.init(a), opt.init(b)
    g = torch.tensor([0.5, -1.0, 2.0])
    opt.update({"w": g, "u": None}, sa, a)
    opt.update({"w": g, "u": torch.zeros(2)}, sb, b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def reference_grads(arch):
    """(reference cfg, params, batch, loss, gradient tree), numpy."""
    rcfg = ref_get_config(arch, smoke=True)
    params = RT.init_params(rcfg, jax.random.PRNGKey(0))
    batch = ref_concrete_batch(rcfg, BATCH, SEQ, seed=1)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: RT.loss_fn(p, rcfg, batch)))(params)
    to_np = functools.partial(jax.tree.map, np.asarray)
    return rcfg, to_np(params), to_np(batch), float(loss), to_np(grads)


def port_model(arch, params, **replace):
    cfg = get_config(arch, smoke=True).replace(**replace)
    model = T.init_params(cfg, device=CPU)
    load_reference_params(model, params)
    model.requires_grad_(True)
    return cfg, model


def port_grads(model, cfg, batch):
    for p in model.parameters():
        p.grad = None
    loss = T.loss_fn(model, cfg, batch)
    loss.backward()
    return loss.item(), {n: (p.grad if p.grad is not None
                             else torch.zeros_like(p)).clone()
                         for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_reference(arch):
    _, params, rb, want_loss, want_grads = reference_grads(arch)
    cfg, model = port_model(arch, params)
    batch = {k: torch.as_tensor(v.copy()) for k, v in rb.items()}
    loss, grads = port_grads(model, cfg, batch)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    want = port_tree(model, want_grads)
    assert sorted(grads) == sorted(want)
    errs = {n: normwise(grads[n], want[n]) for n in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, (worst, errs[worst])


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_remat_modes_give_bitwise_equal_gradients(arch):
    _, params, rb, _, _ = reference_grads(arch)
    batch = {k: torch.as_tensor(v.copy()) for k, v in rb.items()}
    out = {}
    for mode in ("none", "dots", "full"):
        cfg, model = port_model(arch, params, remat=mode)
        out[mode] = port_grads(model, cfg, batch)
    for mode in ("dots", "full"):
        assert out[mode][0] == out["none"][0]
        for n, g in out["none"][1].items():
            assert torch.equal(out[mode][1][n], g), (mode, n)


def test_remat_recomputes_the_block_bodies():
    """``remat="full"`` runs each block's forward again in the backward:
    the block_masked counter reads twice the layers."""
    _, params, rb, _, _ = reference_grads("llama3_2_1b")
    batch = {k: torch.as_tensor(v.copy()) for k, v in rb.items()}
    calls = {}
    for mode in ("none", "full"):
        cfg, model = port_model("llama3_2_1b", params, remat=mode)
        before = A.BLOCK_MASKED_CALLS
        port_grads(model, cfg, batch)
        calls[mode] = A.BLOCK_MASKED_CALLS - before
    assert calls == {"none": cfg.n_layers, "full": 2 * cfg.n_layers}


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_only_where_the_block_input_requires_grad(monkeypatch, remat):
    """Serving outside ``no_grad`` (frozen parameters) runs no checkpoint,
    so it computes what it computes under ``no_grad``; training wraps every
    block body."""
    cfg = get_config("llama3_2_1b", smoke=True).replace(remat=remat)
    wrapped = []
    real = T._ckpt.checkpoint
    monkeypatch.setattr(T._ckpt, "checkpoint", lambda fn, *a, **k: (
        wrapped.append(fn), real(fn, *a, **k))[1])
    tokens = concrete_batch(cfg, 1, SEQ, device=CPU)["tokens"]
    model = T.init_params(cfg, device=CPU)
    assert torch.is_grad_enabled()
    logits = model(tokens, cfg)
    assert wrapped == [] and logits.grad_fn is None
    with torch.no_grad():
        assert torch.equal(model(tokens, cfg), logits)
    model.requires_grad_(True)
    model(tokens, cfg).float().sum().backward()
    assert len(wrapped) == cfg.n_layers


def test_moe_aux_loss_matches_reference():
    rcfg, params, _, _, _ = reference_grads("deepseek_v2_lite_16b")
    cfg, model = port_model("deepseek_v2_lite_16b", params)
    kd = T.n_dense_layers(cfg)
    x = np.random.default_rng(4).standard_normal(
        (BATCH, SEQ, cfg.d_model)).astype(np.float32)
    want = float(RL.moe_aux_loss(
        jax.tree.map(lambda a: a[0], params["layers_moe"]["ffn"]), rcfg,
        jnp.asarray(x)))
    got = L.moe_aux_loss(model.blocks[kd].ffn, cfg, torch.as_tensor(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3_2_1b", "zamba2_7b"])
def test_train_steps_match_reference(arch):
    """Three steps against the reference's jitted step.  Adam's first
    update moves each element by about lr * sign(g): where g is near zero
    and the two packages' f32 sums give it opposite signs, that element
    differs by a full update.  Parameters of a small norm made mostly of
    such elements (deepseek's MoE router, seamless's LayerNorm biases,
    zero at init) exceed 1e-4 normwise after one step, so those configs
    are held on their loss and gradients
    (``test_loss_and_grads_match_reference``)."""
    rcfg = ref_get_config(arch, smoke=True)
    opt_kw = dict(lr=1e-3, warmup=1, total_steps=10)
    ref_opt, opt = RefAdamW(**opt_kw), AdamW(**opt_kw)
    rstate = RTS.init_state(rcfg, jax.random.PRNGKey(0), ref_opt)
    cfg = get_config(arch, smoke=True)
    state = port_state(cfg, rstate, opt)
    kw = dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=1)
    rpipe, pipe = RP.SyntheticLM(**kw), SyntheticLM(**kw)
    rstep = jax.jit(RTS.make_train_step(rcfg, ref_opt))
    step = make_train_step(cfg, opt)
    for i in range(3):
        rstate, rm = rstep(rstate, RP.batch_for(rcfg, rpipe, i))
        state, m = step(state, batch_for(cfg, pipe, i, device=CPU))
        assert abs(float(m["loss"]) - float(rm["loss"])) <= \
            1e-5 * abs(float(rm["loss"]))
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-4)
    assert int(state.opt.step) == 3
    want = port_tree(state.model, rstate.params)
    for n, p in state.model.named_parameters():
        assert normwise(p.detach(), want[n]) <= 1e-4, n


def test_microbatched_step_matches_one_batch():
    """The reference's microbatch test, on the port (its tolerances)."""
    rcfg = ref_get_config("llama3_2_1b", smoke=True)
    opt = AdamW(lr=1e-3, warmup=1, total_steps=10)
    rstate = RTS.init_state(rcfg, jax.random.PRNGKey(0),
                            RefAdamW(lr=1e-3, warmup=1, total_steps=10))
    cfg = get_config("llama3_2_1b", smoke=True)
    s1 = port_state(cfg, rstate, opt)
    s2 = copy.deepcopy(s1)
    b = batch_for(cfg, SyntheticLM(cfg.vocab_size, 16, 4, seed=1), 0,
                  device=CPU)
    s1, m1 = make_train_step(cfg, opt)(s1, b)
    s2, m2 = make_train_step(cfg, opt, microbatches=2)(s2, b)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for (n, x), (_, y) in zip(s1.model.named_parameters(),
                              s2.model.named_parameters()):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=n)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, opt, microbatches=3)(s1, b)


def test_make_train_step_refuses_an_aux_weight():
    """The reference adds no auxiliary loss whatever ``aux_weight`` says;
    the port accepts only 0 rather than ignore a weight silently."""
    cfg = get_config("deepseek_v2_lite_16b", smoke=True)
    make_train_step(cfg, AdamW(), aux_weight=0.0)
    with pytest.raises(ValueError, match="aux_weight"):
        make_train_step(cfg, AdamW(), aux_weight=0.01)


def test_init_state_turns_gradients_on_and_leaves_serving_frozen():
    cfg = get_config("llama3_2_1b", smoke=True)
    state = init_state(cfg, AdamW(), seed=0, device=CPU)
    assert all(p.requires_grad for p in state.model.parameters())
    assert all(m.dtype == torch.float32 and not m.any()
               for m in state.opt.m.values())
    assert state.opt.step.dtype == torch.int32 and int(state.opt.step) == 0
    assert not any(p.requires_grad for p in
                   T.init_params(cfg, device=CPU).parameters())


# ---------------------------------------------------------------------------
# _bmm_f32's backward and flash under gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bmm_f32_backward_is_the_widened_products(dtype):
    g = torch.Generator().manual_seed(0)
    a = torch.randn(3, 5, 8, generator=g).to(dtype).requires_grad_(True)
    b = torch.randn(3, 8, 4, generator=g).to(dtype).requires_grad_(True)
    cot = torch.randn(3, 5, 4, generator=g)
    out = A._bmm_f32(a, b)
    assert out.dtype == torch.float32
    ga, gb = torch.autograd.grad(out, (a, b), cot)
    assert ga.dtype == gb.dtype == dtype
    want_a = (cot @ b.detach().float().transpose(1, 2)).to(dtype)
    want_b = (a.detach().float().transpose(1, 2) @ cot).to(dtype)
    assert torch.equal(ga, want_a) and torch.equal(gb, want_b)


#: bf16 gradients against f32 on the same state and batch (SMOKE, 2 x 32
#: tokens): the worst parameter normwise, and all of them together.  Sound
#: runs read at most 0.285 (deepseek's router) and 0.092 (xlstm) on the
#: CPU, 0.336 and 0.157 (moonshot) on the H100 against the CPU's f32; a
#: transposed cotangent in ``_BmmF32``'s backward reads 1.31 or more for
#: a parameter and 0.89 or more together in every config that reaches it
#: (all but xlstm, which has no ``_bmm_f32``).
BF16_GRAD_PARAM_TOL = 0.6
BF16_GRAD_TOL = 0.3


def bf16_grad_errors(arch):
    """(the worst parameter's normwise distance and its name, the
    distance of all gradients together) between one bf16 backward and
    one f32 backward of ``arch``'s SMOKE config on the CPU."""
    cfg = get_config(arch, smoke=True)
    model = T.init_params(cfg, seed=0, device=CPU).requires_grad_(True)
    _, want = port_grads(model, cfg, concrete_batch(cfg, BATCH, SEQ, seed=1,
                                                    device=CPU))
    bcfg = cfg.replace(dtype="bfloat16")
    _, got = port_grads(model, bcfg, concrete_batch(bcfg, BATCH, SEQ,
                                                    seed=1, device=CPU))
    errs = {n: normwise(got[n], w) for n, w in want.items()}
    worst = max(errs, key=errs.get)
    num = sum(float((got[n] - w).double().norm()) ** 2
              for n, w in want.items())
    den = sum(float(w.double().norm()) ** 2 for w in want.values())
    return errs[worst], worst, (num / den) ** 0.5


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bf16_gradients_near_f32(arch):
    """Every family's backward in bf16 (``_bmm_f32``'s backward in
    block_masked, MLA and the SSD tile) against its f32 backward."""
    worst, name, total = bf16_grad_errors(arch)
    assert worst <= BF16_GRAD_PARAM_TOL, (name, worst)
    assert total <= BF16_GRAD_TOL, total


def transposed_cotangent(monkeypatch):
    """Plant a fault in ``_BmmF32``'s backward: each operand's gradient
    transposed where its tile is square (so its shape still fits)."""
    sound = A._BmmF32.backward

    def faulty(ctx, g):
        return tuple(x if x is None or x.shape[-1] != x.shape[-2]
                     else x.transpose(-1, -2).contiguous()
                     for x in sound(ctx, g))
    monkeypatch.setattr(A._BmmF32, "backward", staticmethod(faulty))


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if a != "xlstm_1_3b"])
def test_bf16_gradient_check_catches_a_transposed_cotangent(monkeypatch,
                                                            arch):
    transposed_cotangent(monkeypatch)
    worst, name, total = bf16_grad_errors(arch)
    assert worst > BF16_GRAD_PARAM_TOL and total > BF16_GRAD_TOL, \
        (name, worst, total)


def test_flash_pallas_raises_under_gradients_before_any_launch():
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 2, 32, 16, generator=g) for _ in range(3))
    before = (flash_kernel.LAUNCHES, flash_kernel.TC_LAUNCHES)
    with pytest.raises(NotImplementedError, match="no backward"):
        A.attention(q.requires_grad_(True), k, v, impl="flash_pallas",
                    block=16)
    assert (flash_kernel.LAUNCHES, flash_kernel.TC_LAUNCHES) == before
    with torch.no_grad():           # serving is untouched
        out = A.attention(q, k, v, impl="flash_pallas", block=16)
    assert out.shape == q.shape
    cfg = get_config("llama3_2_1b", smoke=True)
    model = init_state(cfg, AdamW(), device=CPU).model
    batch = concrete_batch(cfg, 1, 32, device=CPU)
    with pytest.raises(NotImplementedError):
        T.loss_fn(model, cfg.replace(attn_impl="flash_pallas"), batch)


# ---------------------------------------------------------------------------
# checkpoints (the reference's tests, on the port)
# ---------------------------------------------------------------------------


def small_tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.int32),
                  "h": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = small_tree()
    mgr.save(10, tree)
    mgr.save(20, tree)
    doubled = {"a": tree["a"] * 2, "b": {k: v * 2 for k, v in
                                          tree["b"].items()}}
    mgr.save(30, doubled, asynchronous=True)
    mgr.wait()
    assert mgr.latest_step() == 30
    assert mgr.all_steps() == [20, 30]       # keep=2 gc'd step 10
    out = mgr.restore(30, tree)
    assert sorted(out) == ["a", "b"] and sorted(out["b"]) == ["c", "h"]
    for got, want in ((out["a"], doubled["a"]), (out["b"]["c"],
                                                 doubled["b"]["c"]),
                      (out["b"]["h"], doubled["b"]["h"])):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_checkpoint_keep_collects_old_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path))           # keep=3
    for s in range(1, 7):
        mgr.save(s, small_tree(), asynchronous=s % 2 == 0)
    mgr.wait()
    assert mgr.all_steps() == [4, 5, 6] and mgr.latest_step() == 6
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_4", "step_5",
                                            "step_6"]


def test_checkpoint_saves_never_overlap(tmp_path):
    """Synchronous saves between asynchronous ones, with the interpreter
    switching threads as often as it can: every save waits for the write
    in flight, so no two writers race on LATEST.tmp or the collection."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for step in range(1, 41):
            mgr.save(step, small_tree(), asynchronous=step % 2 == 1)
        mgr.wait()
    finally:
        sys.setswitchinterval(old)
    assert mgr.all_steps() == [39, 40] and mgr.latest_step() == 40
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_39", "step_40"]


def test_checkpoint_atomic_on_partial_write(tmp_path):
    """A stale .tmp directory must not shadow a published checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    tree = {"a": torch.ones(3)}
    mgr.save(1, tree)
    os.makedirs(os.path.join(str(tmp_path), "step_2.tmp"))  # crash artifact
    assert mgr.latest_step() == 1
    out = mgr.restore(1, tree)
    assert torch.equal(out["a"], torch.ones(3))


def test_checkpoint_async_write_error_reaches_wait(tmp_path, monkeypatch):
    """A write that fails in the writer thread raises from ``wait()`` (and
    from the next save, which waits first); nothing is published."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, small_tree())

    def full_disk(*args, **kwargs):
        raise OSError("no space left on device")

    monkeypatch.setattr(np, "save", full_disk)
    mgr.save(2, small_tree(), asynchronous=True)
    with pytest.raises(OSError, match="no space"):
        mgr.wait()
    mgr.wait()                                  # raised once
    mgr.save(3, small_tree(), asynchronous=True)
    with pytest.raises(OSError, match="no space"):
        mgr.save(4, small_tree(), asynchronous=True)
    monkeypatch.undo()
    mgr.wait()
    assert mgr.all_steps() == [1] and mgr.latest_step() == 1


def test_checkpoint_async_train_state_and_resume(tmp_path):
    """An async save copies the state before its thread starts: training
    on does not reach the files, and a fresh state restored from them
    continues the run bit for bit."""
    cfg = get_config("llama3_2_1b", smoke=True)
    opt = AdamW(lr=1e-3, warmup=2, total_steps=6)
    pipe = SyntheticLM(cfg.vocab_size, 16, 4, seed=3)
    step = make_train_step(cfg, opt)
    state = init_state(cfg, opt, seed=5, device=CPU)
    mgr = CheckpointManager(str(tmp_path))
    losses = []
    for i in range(4):
        state, m = step(state, batch_for(cfg, pipe, i, device=CPU))
        losses.append(float(m["loss"]))
        if i == 1:
            mgr.save(2, state, asynchronous=True)
            saved = {n: p.detach().clone()
                     for n, p in state.model.named_parameters()}
    mgr.wait()
    fresh = mgr.restore(2, init_state(cfg, opt, seed=99, device=CPU))
    assert int(fresh.opt.step) == 2
    for n, p in fresh.model.named_parameters():
        assert torch.equal(p.detach(), saved[n]), n
    resumed = []
    for i in (2, 3):
        fresh, m = step(fresh, batch_for(cfg, pipe, i, device=CPU))
        resumed.append(float(m["loss"]))
    assert resumed == losses[2:]
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(2, init_state(cfg.replace(d_ff=64), opt, device=CPU))
    with pytest.raises(ValueError, match="no array"):
        mgr.restore(2, {"nope": torch.zeros(1)})


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


def test_compression_error_feedback_single_shard():
    """The reference's error-feedback test at p = 1, both packages."""
    from repro.compat import shard_map
    w = (np.random.default_rng(0).standard_normal((64,)) * 0.1).astype(
        np.float32)
    mesh = jax.make_mesh((1,), ("data",))

    def local(gw, ew):
        out, new_e = ref_allreduce({"w": gw}, {"w": ew}, ("data",))
        return out["w"], new_e["w"]

    P = jax.sharding.PartitionSpec
    want, want_err = shard_map(local, mesh=mesh, in_specs=(P(),) * 2,
                               out_specs=(P(),) * 2)(jnp.asarray(w),
                                                     jnp.zeros(64))
    g = {"w": torch.as_tensor(w)}
    got, errs = allreduce_compressed([g], [init_error(g)])
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(errs[0]["w"].numpy(), np.asarray(want_err),
                               rtol=1e-6, atol=1e-9)
    # single shard: dequantized value + error == original
    np.testing.assert_allclose(got["w"].numpy() + errs[0]["w"].numpy(), w,
                               rtol=1e-6, atol=1e-7)
    scale = float(np.abs(w).max()) / 127
    assert float(errs[0]["w"].abs().max()) <= scale / 2 + 1e-8


COMPRESSION_CHILD = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.train.compression import allreduce_compressed
assert jax.device_count() == 4, jax.devices()
z = np.load(sys.argv[1])
out = {}
for p in (2, 4):
    mesh = jax.make_mesh((p,), ("data",), devices=jax.devices()[:p])
    def local(g, e, h):
        mean, err = allreduce_compressed({"w": g[0], "u": h[0]},
                                         {"w": e[0], "u": e[0][:6]},
                                         ("data",))
        return mean["w"][None], err["w"][None], mean["u"][None], \
            err["u"][None]
    f = shard_map(local, mesh=mesh, in_specs=(P("data"),) * 3,
                  out_specs=(P("data"),) * 4)
    r = f(jnp.asarray(z[f"g{p}"]), jnp.asarray(z[f"e{p}"]),
          jnp.asarray(z[f"h{p}"]))
    for name, x in zip(("mean_w", "err_w", "mean_u", "err_u"), r):
        out[f"{name}{p}"] = np.asarray(x)
np.savez(sys.argv[2], **out)
print("REF_OK")
"""


def test_compression_matches_reference_on_two_and_four_shards(tmp_path):
    rng = np.random.default_rng(7)
    data = {}
    for p in (2, 4):
        data[f"g{p}"] = (rng.standard_normal((p, 64)) * 0.1).astype(
            np.float32)
        data[f"e{p}"] = (rng.standard_normal((p, 64)) * 1e-3).astype(
            np.float32)
        data[f"h{p}"] = rng.standard_normal((p, 6)).astype(np.float32)
    inp, outp = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, **data)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", COMPRESSION_CHILD,
                           str(inp), str(outp)], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0 and "REF_OK" in proc.stdout, \
        proc.stdout + proc.stderr
    want = np.load(outp)
    for p in (2, 4):
        mesh = make_mesh(p, device=CPU)
        grads = [{"w": torch.as_tensor(data[f"g{p}"][i], device=d),
                  "u": torch.as_tensor(data[f"h{p}"][i], device=d)}
                 for i, d in enumerate(mesh.devices)]
        errs = [{"w": torch.as_tensor(data[f"e{p}"][i], device=d),
                 "u": torch.as_tensor(data[f"e{p}"][i][:6], device=d)}
                for i, d in enumerate(mesh.devices)]
        mean, new_errs = allreduce_compressed(grads, errs)
        for name in ("w", "u"):
            for i in range(p):
                np.testing.assert_allclose(mean[name].numpy(),
                                           want[f"mean_{name}{p}"][i],
                                           rtol=1e-6, atol=0)
                np.testing.assert_allclose(new_errs[i][name].numpy(),
                                           want[f"err_{name}{p}"][i],
                                           rtol=1e-6, atol=1e-9)
            # the shared scale: sum(deq) + sum(err) = sum(g + e)
            total = sum(g[name].double() + e[name].double()
                        for g, e in zip(grads, errs))
            back = mean[name].double() * p + sum(
                e[name].double() for e in new_errs)
            np.testing.assert_allclose(back.numpy(), total.numpy(),
                                       rtol=1e-5, atol=1e-7)
