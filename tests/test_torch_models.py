"""The LM path of the port (llama3.2-1b SMOKE, ``attn_impl="flash_pallas"``)
against the reference, on one set of weights: the reference's
``init_params`` carried across by ``load_reference_params``.

Tolerances: 1e-5 (rtol and atol) for f32 logits, where both sides compute
the same f32 arithmetic in other summation orders; 4e-2 for bf16 logits,
which are O(1) here, where a bf16 ulp is 8e-3 and the two frameworks round
to bf16 at different places (XLA keeps silu and RoPE's products in bf16
or f32 where torch rounds once), so a few ulps separate them.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import get_config as ref_get_config
from repro.kernels.flash_mask import ops as ref_flash_ops
from repro.models import transformer as RT
from repro.models.attention import attention as ref_attention
from repro.serve.decode import generate as ref_generate
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.convert import load_reference_params
from repro_torch.kernels.flash_mask import kernel as flash_kernel
from repro_torch.models import transformer as T
from repro_torch.models.attention import attention
from repro_torch.serve.decode import generate

SEQ = 32
BATCH = 2
F32_TOL = 1e-5
BF16_TOL = 4e-2


def ref_forward(params, cfg, tokens):
    # the reference's schedule cache keeps arrays made inside a trace;
    # a second trace that hits it leaks them, so start each call empty
    ref_flash_ops._sched.cache_clear()
    return np.asarray(RT.forward(params, cfg, {"tokens": jnp.asarray(tokens)})
                      .astype(jnp.float32))


@pytest.fixture(scope="module")
def ref():
    cfg = ref_get_config("llama3_2_1b", smoke=True).replace(
        attn_impl="flash_pallas")
    params = RT.init_params(cfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    return cfg, params, tokens, ref_forward(params, cfg, tokens)


def port_model(ref_params, **replace):
    cfg = get_config("llama3_2_1b", smoke=True).replace(
        **{"attn_impl": "flash_pallas", **replace})
    model = T.init_params(cfg, device="cpu")
    load_reference_params(model, jax.tree.map(np.asarray, ref_params))
    return model


@pytest.mark.parametrize("impl", ["flash_pallas", "dense_masked"])
def test_forward_matches_reference_flash(ref, impl):
    _, params, tokens, want = ref
    model = port_model(params, attn_impl=impl)
    got = T.forward(model, model.cfg, {"tokens": torch.as_tensor(tokens)})
    assert got.shape == (BATCH, SEQ, model.cfg.vocab_size)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_forward_runs_the_flash_kernel_wrapper_once_per_layer(ref,
                                                              monkeypatch):
    _, params, tokens, _ = ref
    model = port_model(params)
    calls = []
    real = flash_kernel.flash_mask_kernel

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(flash_kernel, "flash_mask_kernel", counting)
    from repro_torch.kernels.flash_mask import ops
    monkeypatch.setattr(ops, "flash_mask_kernel", counting)
    cfg = model.cfg
    T.forward(model, cfg, {"tokens": torch.as_tensor(tokens)})
    assert calls == [(BATCH, cfg.n_heads, SEQ, cfg.hd)] * cfg.n_layers


def test_forward_bf16_matches_reference(ref):
    cfg, params, tokens, _ = ref
    want = ref_forward(params, cfg.replace(dtype="bfloat16"), tokens)
    model = port_model(params, dtype="bfloat16")
    got = T.forward(model, model.cfg, {"tokens": torch.as_tensor(tokens)})
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_decode_step_matches_reference_teacher_forced(ref):
    cfg, params, tokens, want_fwd = ref
    model = port_model(params)
    cache = T.init_cache(model.cfg, BATCH, SEQ, device="cpu")
    ref_cache = RT.init_cache(cfg, BATCH, SEQ)
    step = jax.jit(lambda p, t, c, pos: RT.decode_step(p, cfg, t, c, pos))
    for t in range(SEQ):
        pos = np.full((BATCH,), t, np.int32)
        want, ref_cache = step(params, jnp.asarray(tokens[:, t]), ref_cache,
                               jnp.asarray(pos))
        got, cache = T.decode_step(model, model.cfg,
                                   torch.as_tensor(tokens[:, t]), cache,
                                   torch.as_tensor(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_TOL, atol=F32_TOL)
        # the reference's own property: decode reproduces the forward
        np.testing.assert_allclose(got.numpy(), want_fwd[:, t], rtol=2e-2,
                                   atol=2e-2)


def test_generate_greedy_tokens_equal_reference(ref):
    cfg, params, tokens, _ = ref
    prompt = tokens[:, :8]
    want = np.asarray(ref_generate(params, cfg, jnp.asarray(prompt),
                                   max_new=8))
    model = port_model(params)
    got = generate(model, model.cfg, torch.as_tensor(prompt), max_new=8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_with_temperature_is_reproducible(ref):
    _, params, tokens, _ = ref
    model = port_model(params)
    prompt = torch.as_tensor(tokens[:, :4])
    runs = [generate(model, model.cfg, prompt, max_new=6, temperature=0.8,
                     generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert runs[0].shape == (BATCH, 10)
    assert torch.equal(runs[0][:, :4], prompt.to(torch.int32))
    with pytest.raises(ValueError):
        generate(model, model.cfg, prompt, max_new=2, temperature=0.8)


VARIANTS = {
    # LayerNorm with bias, tanh-GELU MLP with biases, an untied head and
    # q/k/v biases: every optional parameter of the dense family
    "layernorm-gelu-untied-bias": dict(norm="layernorm", act="gelu",
                                       tie_embeddings=False, qkv_bias=True),
    # a sliding window (flash window pattern, ring-buffered decode cache)
    # with the reference's replicated K/V parameter names
    "window-kv-replicated": dict(window=16, kv_replicated=True),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_config_variants_match_reference(variant):
    """f32 forward and teacher-forced decode at 1e-5 on perturbed weights
    (the reference's init leaves biases at 0 and scales at 1)."""
    kw = VARIANTS[variant]
    cfg = ref_get_config("llama3_2_1b", smoke=True).replace(
        attn_impl="flash_pallas", **kw)
    rng = np.random.default_rng(2)
    tree = jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), RT.init_params(cfg, jax.random.PRNGKey(3)))
    params = jax.tree.map(jnp.asarray, tree)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    want = ref_forward(params, cfg, tokens)
    model = T.init_params(get_config("llama3_2_1b", smoke=True).replace(
        attn_impl="flash_pallas", **kw), device="cpu")
    load_reference_params(model, tree)
    got = T.forward(model, model.cfg, {"tokens": torch.as_tensor(tokens)})
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    cache = T.init_cache(model.cfg, BATCH, SEQ, device="cpu")
    ref_cache = RT.init_cache(cfg, BATCH, SEQ)
    step = jax.jit(lambda p, t, c, pos: RT.decode_step(p, cfg, t, c, pos))
    for t in range(SEQ):
        pos = np.full((BATCH,), t, np.int32)
        want_t, ref_cache = step(params, jnp.asarray(tokens[:, t]),
                                 ref_cache, jnp.asarray(pos))
        got_t, cache = T.decode_step(model, model.cfg,
                                     torch.as_tensor(tokens[:, t]), cache,
                                     torch.as_tensor(pos))
        np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t),
                                   rtol=F32_TOL, atol=F32_TOL)


def test_prefix_lm_mask_differs_between_impls_as_in_reference():
    """The dense and block-masked masks make a prefix bidirectional
    (prefix-LM) when window == 0; the flash kernel's mask does not.  Each
    port impl is held to its own reference impl, block_masked agrees with
    dense_masked, and the divergence from flash is pinned."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((1, 2, 16, 8)).astype(np.float32)
               for _ in range(3))
    kw = dict(causal=True, window=0, prefix=8, block=8)
    got, want = {}, {}
    for impl in ("flash_pallas", "dense_masked", "block_masked"):
        ref_flash_ops._sched.cache_clear()
        want[impl] = np.asarray(ref_attention(
            *(jnp.asarray(x) for x in (q, k, v)), impl=impl, **kw))
        got[impl] = attention(*(torch.as_tensor(x) for x in (q, k, v)),
                              impl=impl, **kw).numpy()
        np.testing.assert_allclose(got[impl], want[impl], rtol=F32_TOL,
                                   atol=F32_TOL)
    np.testing.assert_allclose(got["block_masked"], got["dense_masked"],
                               rtol=F32_TOL, atol=F32_TOL)
    # rows inside the prefix see later prefix keys only under dense_masked
    assert not np.allclose(got["flash_pallas"][:, :, :8],
                           got["dense_masked"][:, :, :8])
    np.testing.assert_allclose(got["flash_pallas"][:, :, 8:],
                               got["dense_masked"][:, :, 8:], rtol=F32_TOL,
                               atol=F32_TOL)


def test_unported_paths_raise():
    """Nothing is left unported: block_masked runs, all ten architectures
    build on the CPU (every family of the reference), and a family the
    reference does not know, or ``ssm`` without an xLSTM config, raises
    ``ValueError`` in both packages."""
    q = torch.zeros(1, 2, 8, 4)
    assert attention(q, q, q, impl="block_masked").shape == (1, 2, 8, 4)
    families = set()
    for arch in ARCH_IDS:
        model = T.init_params(get_config(arch, smoke=True), device="cpu")
        assert model.cfg.name == ref_get_config(arch, smoke=True).name
        families.add(model.cfg.family)
    assert families == set(T.PORTED_FAMILIES)
    for kw in (dict(family="rnn"), dict(family="ssm", xlstm=None)):
        cfg = get_config("llama3_2_1b", smoke=True).replace(**kw)
        with pytest.raises(ValueError, match="family"):
            T.init_params(cfg, device="cpu")
        ref_cfg = ref_get_config("llama3_2_1b", smoke=True).replace(**kw)
        with pytest.raises(ValueError, match="family"):
            RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    cfg = get_config("llama3.2-1b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.hd, cfg.vocab_size) == (16, 2048, 32, 8, 64, 128256)
    assert cfg.activation_dtype == torch.bfloat16


def test_load_reference_params_rejects_a_foreign_tree(ref):
    _, params, _, _ = ref
    tree = dict(jax.tree.map(np.asarray, params))
    tree["layers_moe"] = tree["layers_dense"]
    model = T.init_params(get_config("llama3_2_1b", smoke=True),
                          device="cpu")
    with pytest.raises(ValueError, match="layers_moe"):
        load_reference_params(model, tree)
