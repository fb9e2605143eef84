"""The xLSTM (``ssm``), Zamba2 (``hybrid``) and encoder-decoder (``audio``)
families of the port against the reference, SMOKE configs, on the
reference's weights (``load_reference_params``): forward under the
published ``block_masked`` and under ``flash_pallas`` (the flash kernel's
plain version against the reference's Pallas kernel in interpret mode),
the encoder computed once, teacher-forced ``decode_step`` (with
``encoder_out`` for the encoder-decoder), the reference's decode-vs-prefill
property, greedy ``generate``, the caches' layout and the parameter
tree's round trip and its rejections.

Tolerances: 1e-5 (rtol and atol) for f32, where both sides compute the
same f32 arithmetic in other summation orders; the reference's own 2e-2
for decode against prefill (``tests/test_models.py``); tokens exactly.
"""
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import get_config as ref_get_config
from repro.kernels.flash_mask import ops as ref_flash_ops
from repro.launch.specs import concrete_batch
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.models.common import rms_norm as ref_rms_norm
from repro.serve.decode import generate as ref_generate
from repro_torch.configs.base import get_config
from repro_torch.convert import load_reference_params
from repro_torch.kernels.flash_mask import kernel as flash_kernel
from repro_torch.kernels.flash_mask import ops as flash_ops
from repro_torch.models import transformer as T
from repro_torch.serve.decode import generate, make_serve_step

TOL = 1e-5
SEQ = 32
BATCH = 2
ARCHS = ("xlstm_1_3b", "zamba2_7b", "seamless_m4t_large_v2")
ATTN_ARCHS = ("zamba2_7b", "seamless_m4t_large_v2")


def ref_encode(params, cfg, frames):
    """The encoder half of the reference's ``_forward_encdec``."""
    enc = jnp.asarray(frames).astype(cfg.activation_dtype) @ \
        params["frame_proj"].astype(cfg.activation_dtype)
    b, s, _ = enc.shape
    pos = jnp.broadcast_to(jnp.arange(s)[None, :], (b, s))

    def step(x, p):
        h = RL._norm(cfg, p, x, "ln1")
        x = x + RL.apply_attn(p["attn"], cfg, h, pos, causal=False, window=0)
        h = RL._norm(cfg, p, x, "ln2")
        return x + RL.apply_mlp(p["ffn"], cfg, h), None

    enc, _ = jax.lax.scan(step, enc, params["enc_layers"])
    if cfg.norm == "rmsnorm":
        return ref_rms_norm(enc, params["encfinal_ln_scale"])
    return RL.layer_norm(enc, params["encfinal_ln_scale"],
                         params["encfinal_ln_bias"])


@functools.lru_cache(maxsize=None)
def reference(arch, impl=None):
    """(reference cfg, params, batch as numpy, f32 logits, encoder output
    or None)."""
    cfg = ref_get_config(arch, smoke=True)
    if impl is not None:
        cfg = cfg.replace(attn_impl=impl)
    params = RT.init_params(cfg, jax.random.PRNGKey(0))
    batch = {k: np.asarray(v)
             for k, v in concrete_batch(cfg, BATCH, SEQ, seed=1).items()
             if k != "labels"}
    ref_flash_ops._sched.cache_clear()
    logits = np.asarray(RT.forward(params, cfg, {
        k: jnp.asarray(v) for k, v in batch.items()}))
    enc = None
    if cfg.family == "audio":
        ref_flash_ops._sched.cache_clear()
        enc = ref_encode(params, cfg, batch["frames"])
    return cfg, params, batch, logits, enc


def port(arch, params, **replace):
    model = T.init_params(get_config(arch, smoke=True).replace(**replace),
                          device="cpu")
    load_reference_params(model, jax.tree.map(np.asarray, params))
    return model


def torch_batch(batch):
    return {k: torch.as_tensor(v.copy()) for k, v in batch.items()}


def encoder_out(model, batch):
    if model.cfg.family != "audio":
        return None
    return model.encode(torch.as_tensor(batch["frames"].copy()))


def teacher_forced(model, cfg, tokens, enc):
    tokens = torch.as_tensor(np.array(tokens))
    cache = T.init_cache(cfg, tokens.shape[0], tokens.shape[1], device="cpu")
    step = make_serve_step(cfg)
    out = []
    for t in range(tokens.shape[1]):
        logits, cache = step(model, tokens[:, t], cache,
                             torch.full((tokens.shape[0],), t,
                                        dtype=torch.int32), enc)
        out.append(logits)
    return torch.stack(out, dim=1).numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_matches_reference(arch):
    cfg, params, batch, want, _ = reference(arch)
    assert cfg.attn_impl == "block_masked"
    model = port(arch, params)
    got = T.forward(model, model.cfg, torch_batch(batch))
    assert got.shape == (BATCH, SEQ, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_flash_pallas_matches_reference_interpret_flash(arch, monkeypatch):
    """The flash kernel's path (its plain version on the CPU) against the
    reference's Pallas kernel in interpret mode: one wrapper call per
    shared-block application (hybrid) or per encoder and decoder layer
    (encoder non-causal, decoder causal), and block_masked within 1e-5 on
    the same weights."""
    cfg, params, batch, want, _ = reference(arch, "flash_pallas")
    model = port(arch, params, attn_impl="flash_pallas")
    calls = []
    real = flash_kernel.flash_mask_kernel

    def counting(*a, **kw):
        calls.append(kw["causal"])
        return real(*a, **kw)

    monkeypatch.setattr(flash_ops, "flash_mask_kernel", counting)
    got = T.forward(model, model.cfg, torch_batch(batch)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if cfg.family == "hybrid":
        assert calls == [True] * T.n_shared_attn(cfg)
    else:
        assert calls == ([False] * cfg.n_enc_layers
                         + [True] * cfg.n_dec_layers)
    blocked = T.forward(model, model.cfg.replace(attn_impl="block_masked"),
                        torch_batch(batch)).numpy()
    np.testing.assert_allclose(blocked, got, rtol=TOL, atol=TOL)


def test_encoder_output_matches_reference():
    """``Transformer.encode`` (computed once per request) against the
    encoder half of the reference's forward."""
    _, params, batch, _, enc = reference("seamless_m4t_large_v2")
    model = port("seamless_m4t_large_v2", params)
    got = encoder_out(model, batch)
    assert got.shape == (BATCH, SEQ, model.cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(enc), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_decode_matches_reference(arch):
    cfg, params, batch, _, enc = reference(arch)
    tokens = batch["tokens"]
    model = port(arch, params)
    got = teacher_forced(model, model.cfg, tokens, encoder_out(model, batch))
    cache = RT.init_cache(cfg, BATCH, tokens.shape[1])
    step = jax.jit(lambda p, t, c, pos, e: RT.decode_step(
        p, cfg, t, c, pos, encoder_out=e))
    for t in range(tokens.shape[1]):
        want, cache = step(params, jnp.asarray(tokens[:, t]), cache,
                           jnp.full((BATCH,), t, jnp.int32), enc)
        np.testing.assert_allclose(got[:, t], np.asarray(want), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_reproduces_prefill(arch):
    """The reference's property (``tests/test_models.py``), on the port."""
    _, params, batch, _, _ = reference(arch)
    model = port(arch, params)
    want = T.forward(model, model.cfg, torch_batch(batch)).numpy()
    got = teacher_forced(model, model.cfg, batch["tokens"],
                         encoder_out(model, batch))
    assert np.abs(got - want).max() < 2e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_tokens_equal_reference(arch):
    cfg, params, batch, _, enc = reference(arch)
    prompt = batch["tokens"][:, :8]
    want = np.asarray(ref_generate(params, cfg, jnp.asarray(prompt),
                                   max_new=8, encoder_out=enc))
    model = port(arch, params)
    got = generate(model, model.cfg, torch.as_tensor(prompt.copy()),
                   max_new=8, encoder_out=encoder_out(model, batch))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_caches_follow_the_reference_layout(arch):
    cfg = ref_get_config(arch, smoke=True)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        RT.init_cache(cfg, BATCH, 16))
    got = T.init_cache(get_config(arch, smoke=True), BATCH, 16, device="cpu")
    got = {seg: {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                 for k, v in c.items()} for seg, c in got.items()}
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_load_reference_params_round_trip(arch):
    """Every port parameter holds its reference leaf, the two-deep mLSTM
    stack and the unstacked shared block included, and every reference
    leaf lands somewhere: the counts agree."""
    _, params, _, _, _ = reference(arch)
    tree = jax.tree.map(np.asarray, params)
    model = port(arch, params)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    assert sum(v.size for v in state.values()) == sum(
        x.size for x in jax.tree.leaves(tree))
    blocks = model.blocks
    if arch == "xlstm_1_3b":
        r = model.cfg.xlstm.slstm_every
        np.testing.assert_array_equal(blocks[r + r - 2].mixer.wq.numpy(),
                                      tree["layers_mlstm"]["wq"][1, r - 2])
        np.testing.assert_array_equal(blocks[2 * r - 1].mixer.r_blocks
                                      .numpy(),
                                      tree["layers_slstm"]["r_blocks"][1])
    elif arch == "zamba2_7b":
        np.testing.assert_array_equal(blocks[3].mixer.in_proj.numpy(),
                                      tree["layers_ssm"]["ssm"]["in_proj"][3])
        np.testing.assert_array_equal(model.shared_attn.attn.wq.numpy(),
                                      tree["shared_attn"]["attn"]["wq"])
    else:
        np.testing.assert_array_equal(blocks[1].cross.wk.numpy(),
                                      tree["dec_layers"]["cross"]["wk"][1])
        np.testing.assert_array_equal(model.enc_blocks[1].ln2.bias.numpy(),
                                      tree["enc_layers"]["ln2_bias"][1])
        np.testing.assert_array_equal(model.frame_proj.numpy(),
                                      tree["frame_proj"])


def _stacked_shared(tree):
    tree["shared_attn"] = jax.tree.map(lambda a: a[None],
                                       tree["shared_attn"])


def _foreign_stack(tree):
    tree["layers_dense"] = tree["layers_ssm"]


def _missing_leaf(tree):
    del tree["shared_attn"]["ffn"]["w_up"]


@pytest.mark.parametrize("edit,match", [
    (_stacked_shared, r"shared_attn/attn/w.: reference shape \(1, "),
    (_foreign_stack, "layers_dense"),
    (_missing_leaf, "shared_attn.ffn.w_up"),
])
def test_load_reference_params_rejects_a_foreign_tree(edit, match):
    """A stacked ``shared_attn`` (the port holds one weight set), a stack
    the model has no blocks for, and a tree that leaves a parameter
    unwritten each raise."""
    _, params, _, _, _ = reference("zamba2_7b")
    tree = jax.tree.map(np.asarray, params)
    tree = {k: (dict(v) if isinstance(v, dict) else v)
            for k, v in tree.items()}
    tree["shared_attn"] = {k: (dict(v) if isinstance(v, dict) else v)
                           for k, v in tree["shared_attn"].items()}
    edit(tree)
    model = T.init_params(get_config("zamba2_7b", smoke=True), device="cpu")
    with pytest.raises(ValueError, match=match):
        load_reference_params(model, tree)
