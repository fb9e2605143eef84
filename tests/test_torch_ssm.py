"""The port's Mamba2 mixer (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``) at zamba2-7b's SMOKE config, on seeded
numpy inputs and the reference's weights, perturbed so that no parameter
keeps its trivial init (``a_log``, ``dt_bias`` and ``conv_b`` start at 0,
``d_skip`` and ``norm_scale`` at 1): the depthwise causal conv, the SSD
chunked prefill at one chunk and at four, and the one-token recurrence
with its cache.  At the published chunk of 128 the reference's masked
decay tile overflows above its diagonal and its gradient is NaN; the
port's is finite with the same loss
(``test_ssd_gradient_is_finite_where_the_reference_overflows``).

Tolerances: 1e-5 (rtol and atol) in f32, where both sides compute the
same f32 arithmetic in other summation orders; 2e-2 normwise in bf16,
where the frameworks round the masked decay tile's products at other
places.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import get_config as ref_get_config
from repro.models import ssm as RS
from repro_torch.configs.base import get_config
from repro_torch.models import ssm as S

TOL = 1e-5
BATCH = 2


def configs(**replace):
    return (ref_get_config("zamba2_7b", smoke=True).replace(**replace),
            get_config("zamba2_7b", smoke=True).replace(**replace))


def perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v) + 0.1 * rng.standard_normal(v.shape))
            .astype(np.float32) for k, v in tree.items()}


@pytest.fixture(scope="module")
def mixer():
    ref_cfg, cfg = configs()
    tree = perturbed(RS.init_ssm(jax.random.PRNGKey(1), ref_cfg), 2)
    module = S.SSM(cfg, torch.Generator().manual_seed(0))
    for name, w in tree.items():
        getattr(module, name).data.copy_(torch.as_tensor(w))
    return ref_cfg, cfg, tree, module


def activations(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def test_causal_conv_matches_reference():
    x = activations(3, (BATCH, 24, 40))
    w = activations(4, (4, 40))
    b = activations(5, (40,))
    want = np.asarray(RS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b)))
    got = S._causal_conv(torch.as_tensor(x), torch.as_tensor(w),
                         torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("chunks", [1, 4])
def test_apply_ssm_matches_reference(mixer, chunks):
    ref_cfg, cfg, tree, module = mixer
    L = chunks * cfg.ssm.chunk
    x = activations(6, (BATCH, L, cfg.d_model))
    want = np.asarray(RS.apply_ssm(tree, ref_cfg, jnp.asarray(x)))
    got = S.apply_ssm(module, cfg, torch.as_tensor(x))
    assert got.shape == (BATCH, L, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_apply_ssm_bf16_matches_reference(mixer):
    ref_cfg, cfg, tree, module = mixer
    ref_cfg, cfg = (c.replace(dtype="bfloat16") for c in (ref_cfg, cfg))
    x = activations(7, (BATCH, 4 * cfg.ssm.chunk, cfg.d_model))
    want = np.asarray(RS.apply_ssm(tree, ref_cfg,
                                   jnp.asarray(x, jnp.bfloat16))
                      .astype(jnp.float32))
    got = S.apply_ssm(module, cfg, torch.as_tensor(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    rel = np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want)
    assert rel < 2e-2, rel


def test_apply_ssm_decode_matches_reference(mixer):
    """Token by token through the O(1) state: every output and, at the end,
    the state ``S`` and the conv history against the reference's."""
    ref_cfg, cfg, tree, module = mixer
    L = 2 * cfg.ssm.chunk
    x = activations(8, (BATCH, L, cfg.d_model))
    ref_cache = RS.ssm_cache_init(ref_cfg, BATCH, jnp.float32)
    cache = {k: v[0] for k, v in S.ssm_cache_init(cfg, BATCH, torch.float32,
                                                  "cpu", 1).items()}
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: v.shape for k, v in ref_cache.items()}
    step = jax.jit(lambda p, x, c: RS.apply_ssm_decode(p, ref_cfg, x, c))
    outs = []
    for t in range(L):
        want, ref_cache = step(tree, jnp.asarray(x[:, t:t + 1]), ref_cache)
        got, cache = S.apply_ssm_decode(module, cfg,
                                        torch.as_tensor(x[:, t:t + 1]),
                                        cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
        outs.append(got)
    for name in ("S", "conv"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(ref_cache[name]), rtol=TOL,
                                   atol=TOL)
    # the recurrence reproduces the chunked prefill (the reference's
    # decode-vs-prefill property, at the mixer)
    full = S.apply_ssm(module, cfg, torch.as_tensor(x))
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(),
                               rtol=2e-2, atol=2e-2)


def test_ssd_gradient_is_finite_where_the_reference_overflows():
    """zamba2 SMOKE at the published chunk of 128 on 256 tokens, the
    reference's weights: the same loss, but the reference's
    ``where(tri, exp(diff), 0)`` overflows above the diagonal (diff sums
    dt |A| over up to 127 positions) and its backward gives NaN, while
    the port masks the exponent and its every gradient is finite."""
    import dataclasses
    from repro.data import pipeline as RP
    from repro.models import transformer as RT
    from repro_torch.convert import load_reference_params
    from repro_torch.data.pipeline import SyntheticLM, batch_for
    from repro_torch.models import transformer as T
    ref_cfg, cfg = configs()
    ref_cfg = ref_cfg.replace(ssm=dataclasses.replace(ref_cfg.ssm,
                                                      chunk=128))
    cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk=128))
    params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    model = T.init_params(cfg, device="cpu")
    load_reference_params(model, params)
    model.requires_grad_(True)
    batch = batch_for(cfg, SyntheticLM(cfg.vocab_size, 256, 2, seed=0), 0,
                      device="cpu")
    ref_batch = RP.batch_for(ref_cfg, RP.SyntheticLM(cfg.vocab_size, 256, 2,
                                                     seed=0), 0)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: RT.loss_fn(p, ref_cfg, ref_batch))(params)
    loss = T.loss_fn(model, cfg, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=TOL)
    assert not all(bool(jnp.isfinite(g).all())
                   for g in jax.tree.leaves(ref_grads))
    assert all(bool(torch.isfinite(p.grad).all())
               for p in model.parameters())
