"""The port's xLSTM cells (``repro_torch.models.xlstm``) against the
reference's (``repro.models.xlstm``) at xlstm-1.3b's SMOKE config, on
seeded numpy inputs and the reference's weights, perturbed so that no
parameter keeps its trivial init: the chunkwise mLSTM at one chunk and at
four, its one-step recurrence with the cache, the per-token sLSTM and its
one-step decode; and the chunkwise mLSTM against the port's own
step-by-step recurrence.

Tolerances: 1e-5 (rtol and atol) in f32, where both sides compute the
same f32 arithmetic in other summation orders; 2e-2 for the chunkwise form
against the recurrence (the reference's decode-vs-prefill bound).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import get_config as ref_get_config
from repro.models import xlstm as RX
from repro_torch.configs.base import get_config
from repro_torch.models import xlstm as X

TOL = 1e-5
BATCH = 2


def perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v) + 0.1 * rng.standard_normal(v.shape))
            .astype(np.float32) for k, v in tree.items()}


def cell(kind, seed):
    ref_cfg = ref_get_config("xlstm_1_3b", smoke=True)
    cfg = get_config("xlstm_1_3b", smoke=True)
    init = RX.init_mlstm if kind == "m" else RX.init_slstm
    tree = perturbed(init(jax.random.PRNGKey(seed), ref_cfg), seed + 1)
    module = (X.mLSTM if kind == "m" else X.sLSTM)(
        cfg, torch.Generator().manual_seed(0))
    for name, w in tree.items():
        getattr(module, name).data.copy_(torch.as_tensor(w))
    return ref_cfg, cfg, tree, module


@pytest.fixture(scope="module")
def mlstm():
    return cell("m", 1)


@pytest.fixture(scope="module")
def slstm():
    return cell("s", 3)


def activations(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def stepped(module, cfg, x, cache, apply):
    """(the outputs of ``apply`` one token at a time, stacked; the cache)."""
    outs = []
    for t in range(x.shape[1]):
        out, cache = apply(module, cfg, torch.as_tensor(x[:, t:t + 1]),
                           cache)
        outs.append(out)
    return torch.cat(outs, dim=1).numpy(), cache


def ref_stepped(tree, cfg, x, cache, apply):
    step = jax.jit(lambda p, x, c: apply(p, cfg, x, c))
    outs = []
    for t in range(x.shape[1]):
        out, cache = step(tree, jnp.asarray(x[:, t:t + 1]), cache)
        outs.append(np.asarray(out))
    return np.concatenate(outs, axis=1), cache


@pytest.mark.parametrize("chunks", [1, 4])
def test_apply_mlstm_matches_reference(mlstm, chunks):
    ref_cfg, cfg, tree, module = mlstm
    L = chunks * cfg.xlstm.chunk
    x = activations(5, (BATCH, L, cfg.d_model))
    want = np.asarray(RX.apply_mlstm(tree, ref_cfg, jnp.asarray(x)))
    got = X.apply_mlstm(module, cfg, torch.as_tensor(x))
    assert got.shape == (BATCH, L, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_apply_mlstm_decode_matches_reference(mlstm):
    ref_cfg, cfg, tree, module = mlstm
    x = activations(6, (BATCH, 2 * cfg.xlstm.chunk, cfg.d_model))
    want, ref_cache = ref_stepped(tree, ref_cfg, x,
                                  RX.mlstm_cache_init(ref_cfg, BATCH),
                                  RX.apply_mlstm_decode)
    got, cache = stepped(module, cfg, x, X.mlstm_cache_init(cfg, BATCH,
                                                            "cpu"),
                         X.apply_mlstm_decode)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for name in ("C", "n", "m"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(ref_cache[name]), rtol=TOL,
                                   atol=TOL)


def test_chunkwise_mlstm_matches_its_recurrence(mlstm):
    """The chunkwise form with its log-space stabiliser against the exact
    one-step recurrence, both the port's, across four chunks."""
    _, cfg, _, module = mlstm
    x = activations(7, (BATCH, 4 * cfg.xlstm.chunk, cfg.d_model))
    full = X.apply_mlstm(module, cfg, torch.as_tensor(x)).numpy()
    got, _ = stepped(module, cfg, x, X.mlstm_cache_init(cfg, BATCH, "cpu"),
                     X.apply_mlstm_decode)
    np.testing.assert_allclose(got, full, rtol=2e-2, atol=2e-2)


def test_apply_slstm_matches_reference(slstm):
    ref_cfg, cfg, tree, module = slstm
    x = activations(8, (BATCH, 24, cfg.d_model))
    want = np.asarray(RX.apply_slstm(tree, ref_cfg, jnp.asarray(x)))
    got = X.apply_slstm(module, cfg, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_apply_slstm_decode_matches_reference(slstm):
    ref_cfg, cfg, tree, module = slstm
    x = activations(9, (BATCH, 12, cfg.d_model))
    want, ref_cache = ref_stepped(tree, ref_cfg, x,
                                  RX.slstm_cache_init(ref_cfg, BATCH),
                                  RX.apply_slstm_decode)
    got, cache = stepped(module, cfg, x, X.slstm_cache_init(cfg, BATCH,
                                                            "cpu"),
                         X.apply_slstm_decode)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for name in ("c", "n", "m", "h"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(ref_cache[name]), rtol=TOL,
                                   atol=TOL)
    # the per-token prefill is the same recurrence
    full = X.apply_slstm(module, cfg, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, full, rtol=TOL, atol=TOL)
