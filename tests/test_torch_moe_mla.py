"""The MoE, MLA and VLM decoder families and the three further dense
configs of the port against the reference, on the reference's weights
(``load_reference_params``): the ``MLA`` module (prefill and the
weight-absorbed decode over its latent cache), the ``MoE`` module (routing
and the dropless sorted dispatch, with and without ``router_scale`` and
shared experts), and each SMOKE config's forward (``block_masked``, the
published default; the VLM with its image patches) and teacher-forced
decode, the reference's decode-vs-prefill property, greedy ``generate``,
moonshot under ``flash_pallas`` and MLA's refusal of it.

Tolerances: 1e-5 (rtol and atol) for f32, where both sides compute the
same f32 arithmetic in other summation orders; the reference's own 2e-2
for decode against prefill (``tests/test_models.py``); routing assignments
and generated tokens exactly.
"""
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import MoECfg as RefMoECfg
from repro.configs.base import get_config as ref_get_config
from repro.kernels.flash_mask import ops as ref_flash_ops
from repro.launch.specs import concrete_batch
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.serve.decode import generate as ref_generate
from repro_torch.configs.base import MoECfg, get_config
from repro_torch.convert import load_reference_params
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve.decode import generate, make_serve_step

TOL = 1e-5
SEQ = 32
BATCH = 2
ARCHS = ("llama3_2_3b", "stablelm_3b", "starcoder2_7b",
         "deepseek_v2_lite_16b", "moonshot_v1_16b_a3b", "internvl2_2b")


def load_module(module, tree):
    """Copy an unstacked reference parameter dict into a port module."""
    for name, w in tree.items():
        if isinstance(w, dict):
            load_module(getattr(module, name), w)
        else:
            getattr(module, name).data.copy_(torch.as_tensor(np.array(w)))


def both_configs(arch, **replace):
    return (ref_get_config(arch, smoke=True).replace(**replace),
            get_config(arch, smoke=True).replace(**replace))


def activations(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mla():
    ref_cfg, cfg = both_configs("deepseek_v2_lite_16b")
    tree = jax.tree.map(np.asarray, RL.init_mla(jax.random.PRNGKey(1),
                                                ref_cfg))
    module = L.MLA(cfg, torch.Generator().manual_seed(0))
    load_module(module, tree)
    return ref_cfg, cfg, tree, module


def test_mla_prefill_matches_reference(mla):
    ref_cfg, cfg, tree, module = mla
    x = activations(2, (BATCH, SEQ, cfg.d_model))
    pos = np.broadcast_to(np.arange(SEQ), (BATCH, SEQ)).astype(np.int32)
    want = np.asarray(RL.apply_mla(tree, ref_cfg, jnp.asarray(x),
                                   jnp.asarray(pos)))
    got = module(torch.as_tensor(x), torch.as_tensor(pos), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_mla_absorbed_decode_matches_reference(mla):
    ref_cfg, cfg, tree, module = mla
    x = activations(3, (BATCH, SEQ, cfg.d_model))
    ref_cache = RL.mla_cache_init(ref_cfg, BATCH, SEQ, jnp.float32)
    cache = {k: v[0] for k, v in L.mla_cache_init(
        cfg, BATCH, SEQ, torch.float32, "cpu", 1).items()}
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        "kv_c": (BATCH, SEQ, cfg.mla.kv_lora_rank),
        "k_rope": (BATCH, SEQ, cfg.mla.qk_rope_dim)}
    step = jax.jit(lambda p, x, c, pos: RL.apply_mla_decode(p, ref_cfg, x, c,
                                                            pos))
    for t in range(SEQ):
        pos = np.full((BATCH,), t, np.int32)
        want, ref_cache = step(tree, jnp.asarray(x[:, t:t + 1]), ref_cache,
                               jnp.asarray(pos))
        got, cache = module.decode(torch.as_tensor(x[:, t:t + 1]), cache,
                                   torch.as_tensor(pos), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
    for name in ("kv_c", "k_rope"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(ref_cache[name]), rtol=TOL,
                                   atol=TOL)


def test_mla_under_flash_pallas_raises_in_both_packages(mla):
    """MLA's q.k head dim (dn + dr) is not its v head dim (dv); the flash op
    assumes they are equal, and both packages refuse the call."""
    ref_cfg, cfg, tree, module = mla
    x = activations(4, (1, SEQ, cfg.d_model))
    pos = np.arange(SEQ, dtype=np.int32)[None]
    ref_flash_ops._sched.cache_clear()
    with pytest.raises(TypeError):
        RL.apply_mla(tree, ref_cfg.replace(attn_impl="flash_pallas"),
                     jnp.asarray(x), jnp.asarray(pos))
    with pytest.raises(ValueError, match="k and v must be"):
        module(torch.as_tensor(x), torch.as_tensor(pos),
               cfg.replace(attn_impl="flash_pallas"))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


MOE_VARIANTS = {
    "router-scale-shared": dict(router_scale=True, n_shared=1),
    "router-scale": dict(router_scale=True, n_shared=0),
    "unscaled-two-shared": dict(router_scale=False, n_shared=2),
}


@pytest.mark.parametrize("variant", list(MOE_VARIANTS))
def test_moe_matches_reference(variant):
    kw = dict(n_experts=8, top_k=2, d_ff_expert=32, d_ff_shared=24,
              **MOE_VARIANTS[variant])
    ref_cfg, cfg = both_configs("moonshot_v1_16b_a3b")
    ref_cfg = ref_cfg.replace(moe=RefMoECfg(**kw))
    cfg = cfg.replace(moe=MoECfg(**kw))
    tree = jax.tree.map(np.asarray, RL.init_moe(jax.random.PRNGKey(2),
                                                ref_cfg))
    module = L.MoE(cfg, torch.Generator().manual_seed(0))
    assert (module.shared is None) == (kw["n_shared"] == 0)
    load_module(module, tree)
    x = activations(5, (BATCH, SEQ, cfg.d_model))
    want = np.asarray(RL.apply_moe(tree, ref_cfg, jnp.asarray(x)))
    before = L.EXPERT_MATMULS
    got = module(torch.as_tensor(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # the same assignments: top-k experts, weights and group sizes
    xt = x.reshape(-1, cfg.d_model)
    probs = jax.nn.softmax((jnp.asarray(xt) @ tree["router"])
                           .astype(jnp.float32), axis=-1)
    ref_w, ref_e = jax.lax.top_k(probs, kw["top_k"])
    if kw["router_scale"]:
        ref_w = ref_w / jnp.sum(ref_w, axis=-1, keepdims=True)
    top_w, top_e = module.route(torch.as_tensor(xt), cfg)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(ref_e))
    np.testing.assert_allclose(top_w.numpy(), np.asarray(ref_w), rtol=TOL,
                               atol=TOL)
    sizes = np.bincount(np.asarray(ref_e).reshape(-1),
                        minlength=kw["n_experts"])
    assert module.group_sizes == sizes.tolist()
    assert L.EXPERT_MATMULS - before == 3 * int((sizes > 0).sum())


# ---------------------------------------------------------------------------
# whole models, SMOKE configs
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def reference(arch, impl=None):
    """(reference cfg, params as numpy, batch as numpy, f32 logits)."""
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
    return cfg, params, batch, logits


def port(arch, params, **replace):
    model = T.init_params(get_config(arch, smoke=True).replace(**replace),
                          device="cpu")
    load_reference_params(model, jax.tree.map(np.asarray, params))
    return model


def torch_batch(batch):
    return {k: torch.as_tensor(v.copy()) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_matches_reference(arch):
    cfg, params, batch, want = reference(arch)
    assert cfg.attn_impl == "block_masked"
    model = port(arch, params)
    got = T.forward(model, model.cfg, torch_batch(batch))
    assert got.shape == (BATCH, SEQ, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def teacher_forced(model, cfg, tokens):
    tokens = torch.as_tensor(np.array(tokens))
    cache = T.init_cache(cfg, tokens.shape[0], tokens.shape[1], device="cpu")
    step = make_serve_step(cfg)
    out = []
    for t in range(tokens.shape[1]):
        logits, cache = step(model, tokens[:, t], cache,
                             torch.full((tokens.shape[0],), t,
                                        dtype=torch.int32))
        out.append(logits)
    return torch.stack(out, dim=1).numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_decode_matches_reference(arch):
    cfg, params, batch, _ = reference(arch)
    tokens = batch["tokens"]
    model = port(arch, params)
    got = teacher_forced(model, model.cfg, tokens)
    cache = RT.init_cache(cfg, BATCH, tokens.shape[1])
    step = jax.jit(lambda p, t, c, pos: RT.decode_step(p, cfg, t, c, pos))
    for t in range(tokens.shape[1]):
        want, cache = step(params, jnp.asarray(tokens[:, t]), cache,
                           jnp.full((BATCH,), t, jnp.int32))
        np.testing.assert_allclose(got[:, t], np.asarray(want), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("arch", ["llama3_2_3b", "moonshot_v1_16b_a3b",
                                  "deepseek_v2_lite_16b"])
def test_decode_reproduces_prefill(arch):
    """The reference's property (``tests/test_models.py``), on the port."""
    _, params, batch, _ = reference(arch)
    model = port(arch, params)
    want = T.forward(model, model.cfg, torch_batch(batch)).numpy()
    got = teacher_forced(model, model.cfg, batch["tokens"])
    assert np.abs(got - want).max() < 2e-2


def test_smoke_caches_follow_the_reference_layout():
    for arch in ("deepseek_v2_lite_16b", "moonshot_v1_16b_a3b",
                 "internvl2_2b"):
        cfg, _, _, _ = reference(arch)
        want = jax.tree.map(lambda a: a.shape, RT.init_cache(cfg, BATCH, 16))
        got = T.init_cache(get_config(arch, smoke=True), BATCH, 16,
                           device="cpu")
        got = {seg: None if c is None else {k: tuple(v.shape)
                                            for k, v in c.items()}
               for seg, c in got.items()}
        assert got == want


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b",
                                  "moonshot_v1_16b_a3b"])
def test_generate_greedy_tokens_equal_reference(arch):
    cfg, params, batch, _ = reference(arch)
    prompt = batch["tokens"][:, :8]
    want = np.asarray(ref_generate(params, cfg, jnp.asarray(prompt),
                                   max_new=8))
    model = port(arch, params)
    got = generate(model, model.cfg, torch.as_tensor(prompt.copy()),
                   max_new=8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_moonshot_flash_pallas_matches_reference_interpret_flash():
    """The flash kernel's path (its plain version on the CPU) against the
    reference's Pallas kernel in interpret mode, and block_masked against
    flash on the same weights."""
    cfg, params, batch, want = reference("moonshot_v1_16b_a3b",
                                         "flash_pallas")
    model = port("moonshot_v1_16b_a3b", params, attn_impl="flash_pallas")
    got = T.forward(model, model.cfg, torch_batch(batch)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    blocked = T.forward(model, model.cfg.replace(attn_impl="block_masked"),
                        torch_batch(batch)).numpy()
    np.testing.assert_allclose(blocked, got, rtol=TOL, atol=TOL)


def test_vlm_prefix_is_bidirectional_under_block_masked():
    """internvl2's image prefix: block_masked equals dense_masked (both
    honour the prefix-LM rule) and differs from a causal-only prefix
    (flash_pallas, whose mask has no prefix rule)."""
    _, params, batch, want = reference("internvl2_2b")
    model = port("internvl2_2b", params)
    cfg = model.cfg
    dense = T.forward(model, cfg.replace(attn_impl="dense_masked"),
                      torch_batch(batch)).numpy()
    np.testing.assert_allclose(want, dense, rtol=TOL, atol=TOL)
    flash = T.forward(model, cfg.replace(attn_impl="flash_pallas"),
                      torch_batch(batch)).numpy()
    assert not np.allclose(flash[:, :cfg.img_tokens],
                           dense[:, :cfg.img_tokens], rtol=TOL, atol=TOL)
