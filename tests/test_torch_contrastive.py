"""The port's contrastive losses (losses/contrastive.py) against the JAX
package's on the same numpy inputs, f32 on the CPU: each loss and the
gradient of each input (``jax.grad`` against ``torch.autograd``) at rtol
1e-5, the stop-gradients included (byol's ``z``, DINO's teacher), and the
centred DINO's next centre."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu.losses import contrastive as jc
from incomplete_multimodal_fusion_tpu_torch import losses as tlosses
from incomplete_multimodal_fusion_tpu_torch.losses import contrastive as tc

RTOL = 1e-5
ATOL = 1e-7  # gradients that vanish in exact arithmetic come out as rounding noise on both sides


def _inputs(seed, n, b=8, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, d)).astype(np.float32) for _ in range(n)]


def _check(jfn, tfn, arrays, **kw):
    """Loss and every input's gradient, JAX against the port."""
    jloss, jgrads = jax.value_and_grad(lambda *xs: jfn(*xs, **kw), argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    xs = [torch.tensor(a, requires_grad=True) for a in arrays]
    tloss = tfn(*xs, **kw)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=RTOL)
    for i, (x, g) in enumerate(zip(xs, jgrads)):
        got = np.zeros_like(np.asarray(g)) if x.grad is None else x.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(g), rtol=RTOL, atol=ATOL, err_msg=f"input {i}")
    return xs


def test_dino_loss_matches_jax():
    xs = _check(jc.dino_loss, tc.dino_loss, _inputs(0, 2))
    assert xs[1].grad is None  # the teacher's gradient is stopped


def test_byol_loss_matches_jax():
    xs = _check(jc.byol_loss, tc.byol_loss, _inputs(1, 2))
    assert xs[1].grad is None  # z's gradient is stopped
    assert xs[0].grad.abs().sum() > 0


@pytest.mark.parametrize("weights", [{}, dict(l=1.0, mu=2.0, nu=0.5)])
def test_vicreg_loss_matches_jax(weights):
    za, zb = _inputs(2, 2, b=6, d=5)
    za[:, 0] *= 0.01  # a near-collapsed dimension, so the std hinge is active
    _check(jc.vicreg_loss, tc.vicreg_loss, [za, zb], **weights)


def test_vicreg_variance_is_unbiased():
    za, zb = _inputs(3, 2, b=4, d=3)
    want = np.sqrt(za.var(axis=0, ddof=1) + 1e-4)
    got = torch.sqrt(torch.from_numpy(za).var(dim=0, correction=1) + 1e-4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("estimator", ["hard", "easy"])
@pytest.mark.parametrize("temperature", [0.5, 0.1])
def test_hard_negative_loss_matches_jax(estimator, temperature):
    _check(jc.hard_negative_loss, tc.hard_negative_loss, _inputs(4, 2), estimator=estimator,
           temperature=temperature)


def test_hard_negative_floor_is_reached():
    """Two identical views of far-apart points: the debiased negative term
    falls below n e^(-1/t) and the floor sets it, on both sides."""
    x = np.eye(4, 8, dtype=np.float32) * 3.0
    kw = dict(tau_plus=0.5, temperature=0.5)
    want = float(jc.hard_negative_loss(jnp.asarray(x), jnp.asarray(x), **kw))
    got = float(tc.hard_negative_loss(torch.from_numpy(x), torch.from_numpy(x), **kw))
    n = 2 * 4 - 2
    floor = -np.log(np.exp(2.0) / (np.exp(2.0) + n * np.exp(-2.0)))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(got, floor, rtol=1e-6)
    with pytest.raises(ValueError):
        tc.hard_negative_loss(torch.from_numpy(x), torch.from_numpy(x), estimator="other")


def test_dino_center_loss_matches_jax():
    rng = np.random.default_rng(5)
    students = _inputs(6, 3)
    teachers = _inputs(7, 3)
    center = rng.standard_normal((1, 16)).astype(np.float32) * 0.1

    def jfn(*xs):
        loss, state = jc.dino_center_loss(jc.DINOCenterState(jnp.asarray(center)), xs[:3], xs[3:])
        return loss

    def tfn(*xs):
        loss, _ = tc.dino_center_loss(tc.DINOCenterState(torch.from_numpy(center)), xs[:3], xs[3:])
        return loss

    xs = _check(jfn, tfn, students + teachers)
    assert all(x.grad is None for x in xs[3:])  # the teachers' gradients are stopped
    _, jstate = jc.dino_center_loss(jc.DINOCenterState(jnp.asarray(center)), students, teachers,
                                    center_momentum=0.8)
    _, tstate = tc.dino_center_loss(tc.DINOCenterState(torch.from_numpy(center)),
                                    [torch.from_numpy(s) for s in students],
                                    [torch.from_numpy(t) for t in teachers], center_momentum=0.8)
    np.testing.assert_allclose(tstate.center.numpy(), np.asarray(jstate.center), rtol=RTOL, atol=1e-8)


def test_init_dino_center_and_exports():
    state = tlosses.init_dino_center(32)
    assert state.center.shape == (1, 32) and state.center.dtype == torch.float32 and not state.center.any()
    for name in ("byol_loss", "vicreg_loss", "hard_negative_loss", "DINOCenterState", "init_dino_center",
                 "dino_center_loss", "dino_loss", "init_uncertainty_params", "uncertainty_weighting"):
        assert name in tlosses.__all__ and hasattr(tlosses, name), name
