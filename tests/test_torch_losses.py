"""The port's pretraining losses against the JAX package's (losses/masked.py,
losses/contrastive.py) on the same numpy inputs, value and gradient, f32 on
the CPU; and against the executed reference's frozen loss values in
tests/golden/reference_golden.npz (rtol 1e-5)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu.losses import contrastive as jcontra
from incomplete_multimodal_fusion_tpu.losses import masked as jmasked
from incomplete_multimodal_fusion_tpu_torch.losses import contrastive as tcontra
from incomplete_multimodal_fusion_tpu_torch.losses import masked as tmasked
from tests.test_torch_common import to_np

TOL = dict(atol=1e-6, rtol=1e-5)
B, HW, P = 3, 32, 8
NP_ = (HW // P) ** 2


def _mask(kind):
    """[B, N] patch masks (1 = masked, where the loss is taken): sample 1
    has no masked patch, so it drops out of the mean; or all zero."""
    if kind == "zero":
        return np.zeros((B, NP_), np.int64)
    m = (np.random.default_rng(1).random((B, NP_)) < 0.5).astype(np.int64)
    m[1] = 0
    return m


def _inputs(loss, channels=3, k=5, seed=0):
    rng = np.random.default_rng(seed)
    if loss == "cross_entropy":
        return (rng.standard_normal((B, HW, HW, k)).astype(np.float32),
                rng.integers(0, k, (B, HW, HW)).astype(np.int64))
    return (rng.standard_normal((B, HW, HW, channels)).astype(np.float32),
            rng.standard_normal((B, HW, HW, channels)).astype(np.float32))


def _patch_pred(pred, p):
    """NHWC -> the decoder's [B, N, p*p*C] layout, pixel order (ph, pw, c)."""
    b, h, w, c = pred.shape
    return pred.reshape(b, h // p, p, w // p, p, c).transpose(0, 1, 3, 2, 4, 5).reshape(
        b, (h // p) * (w // p), p * p * c).copy()


def _both(loss, patch, pred, target, mask, **kw):
    """(value, d value / d pred) of the JAX loss and of the port's."""
    jfn = (jmasked.PATCH_LOSS_FNS if patch else jmasked.LOSS_FNS)[loss]
    tfn = (tmasked.PATCH_LOSS_FNS if patch else tmasked.LOSS_FNS)[loss]
    jmask = None if mask is None else jnp.asarray(mask)
    jval, jgrad = jax.value_and_grad(
        lambda p: jfn(p, jnp.asarray(target), jmask, patch_size=P, **kw))(jnp.asarray(pred))
    tpred = torch.from_numpy(pred).requires_grad_()
    tval = tfn(tpred, torch.from_numpy(target), None if mask is None else torch.from_numpy(mask),
               patch_size=P, **kw)
    tval.backward()
    return (float(jval), np.asarray(jgrad)), (float(tval.detach()), to_np(tpred.grad))


CASES = [(loss, patch, mask, extra)
         for loss in ("mse", "l1", "cross_entropy")
         for patch in (False, True)
         for mask in ("some", "zero", None)
         for extra in ((False, True) if loss != "cross_entropy" else (False,))]


@pytest.mark.parametrize("loss,patch,mask,extra", CASES)
def test_masked_loss_matches_jax(loss, patch, mask, extra):
    """Value and gradient of every masked loss, pixel and patch layout, with
    a zero-mask sample, an all-zero mask and no mask; ``extra`` is
    ``norm_pix`` (unbiased variance) for mse/l1."""
    pred, target = _inputs(loss)
    if patch:
        pred = _patch_pred(pred, P)
    kw = {"norm_pix": extra} if loss != "cross_entropy" else {}
    m = None if mask is None else _mask(mask)
    (jv, jg), (tv, tg) = _both(loss, patch, pred, target, m, **kw)
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)
    assert np.isfinite(tg).all()
    if mask == "zero":
        assert tv == 0.0


def test_label_smoothing_matches_jax():
    pred, target = _inputs("cross_entropy")
    (jv, jg), (tv, tg) = _both("cross_entropy", False, pred, target, _mask("some"),
                               label_smoothing=0.1)
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)


def test_patch_and_pixel_losses_agree():
    """The patch-layout fast path gives the pixel-space value (the JAX
    package's equivalence, tests/test_losses.py)."""
    pred, target = _inputs("mse")
    mask = torch.from_numpy(_mask("some"))
    for loss in ("mse", "l1"):
        for norm_pix in (False, True):
            pix = tmasked.LOSS_FNS[loss](torch.from_numpy(pred), torch.from_numpy(target), mask,
                                         patch_size=P, norm_pix=norm_pix)
            pat = tmasked.PATCH_LOSS_FNS[loss](torch.from_numpy(_patch_pred(pred, P)),
                                               torch.from_numpy(target), mask, patch_size=P,
                                               norm_pix=norm_pix)
            torch.testing.assert_close(pat, pix, rtol=1e-5, atol=1e-6)


def test_dino_loss_matches_jax_and_stops_the_teacher():
    rng = np.random.default_rng(2)
    s, t = (rng.standard_normal((4, 16)).astype(np.float32) for _ in range(2))
    jval, (jgs, jgt) = jax.value_and_grad(jcontra.dino_loss, argnums=(0, 1))(jnp.asarray(s),
                                                                            jnp.asarray(t))
    ts, tt = torch.from_numpy(s).requires_grad_(), torch.from_numpy(t).requires_grad_()
    tval = tcontra.dino_loss(ts, tt)
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), **TOL)
    np.testing.assert_allclose(to_np(ts.grad), np.asarray(jgs), **TOL)
    assert not np.asarray(jgt).any()
    assert tt.grad is None or not tt.grad.any()


# ---------------------------------------------------------------------------
# the executed reference's frozen values (tests/test_reference_parity.py)
# ---------------------------------------------------------------------------

G = np.load(os.path.join(os.path.dirname(__file__), "golden", "reference_golden.npz"))


def _nhwc(key):  # the golden arrays are NCHW
    return torch.from_numpy(G[key].transpose(0, 2, 3, 1).copy())


GOLDEN = {
    "mse_masked": lambda m: tmasked.masked_mse_loss(_nhwc("mse_pred"), _nhwc("mse_tgt"), m,
                                                    patch_size=8),
    "mse_unmasked": lambda m: tmasked.masked_mse_loss(_nhwc("mse_pred"), _nhwc("mse_tgt"),
                                                      patch_size=8),
    "mse_normpix": lambda m: tmasked.masked_mse_loss(_nhwc("mse_pred"), _nhwc("mse_tgt"), m,
                                                     patch_size=8, norm_pix=True),
    "mse_zero_mask": lambda m: tmasked.masked_mse_loss(_nhwc("mse_pred"), _nhwc("mse_tgt"),
                                                       torch.zeros_like(m), patch_size=8),
    "l1_masked": lambda m: tmasked.masked_l1_loss(_nhwc("l1_pred"), _nhwc("l1_tgt"), m,
                                                  patch_size=8),
    "ce_masked": lambda m: tmasked.masked_cross_entropy_loss(
        _nhwc("ce_logits"), torch.from_numpy(G["ce_target"]), m, patch_size=8),
    "ce_smoothed": lambda m: tmasked.masked_cross_entropy_loss(
        _nhwc("ce_logits"), torch.from_numpy(G["ce_target"]), m, patch_size=8,
        label_smoothing=0.1),
    "dino_fn": lambda m: tcontra.dino_loss(torch.from_numpy(G["contra_a"]),
                                           torch.from_numpy(G["contra_b"])),
}


@pytest.mark.parametrize("key", sorted(GOLDEN))
def test_losses_match_reference_golden(key):
    got = float(GOLDEN[key](torch.from_numpy(G["loss_mask"])))
    np.testing.assert_allclose(got, G[key], rtol=1e-5, atol=0)
