"""PointRend point sampling of the port (``ops.points.point_sample``, the
plain version of kernels K5 / K5b, and ``ops.cuda_points``' wrappers and
autograd Function on CPU tensors) against the JAX package: its
``set_criterion.point_sample`` (the XLA gather branch on the CPU) and the
Pallas kernel ``point_sample_pallas`` in interpret mode, forward and
gradients, on the same numpy inputs, at the shapes of
tests/test_pallas_points.py:21 with points outside [0, 1]."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu.losses.set_criterion import point_sample as jax_point_sample
from incomplete_multimodal_fusion_tpu.ops.pallas_points import point_sample_pallas
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_points
from incomplete_multimodal_fusion_tpu_torch.ops.points import point_sample
from tests.test_torch_common import to_np

SHAPES = [(3, 16, 16, 40), (2, 8, 24, 100), (1, 64, 64, 300)]
JAX_FNS = {"xla": jax.jit(jax_point_sample), "pallas": jax.jit(point_sample_pallas)}


def _inputs(seed, n, h, w, p, lo=-0.1, hi=1.1):
    rng = np.random.default_rng(seed)
    masks = rng.standard_normal((n, h, w)).astype(np.float32)
    coords = rng.uniform(lo, hi, (n, p, 2)).astype(np.float32)
    return masks, coords


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("n,h,w,p", SHAPES)
def test_forward_matches_jax(reference, n, h, w, p):
    masks, coords = _inputs(0, n, h, w, p)
    ref = np.asarray(JAX_FNS[reference](jnp.asarray(masks), jnp.asarray(coords)))
    out = point_sample(torch.from_numpy(masks), torch.from_numpy(coords))
    assert out.shape == (n, p) and out.dtype == torch.float32
    np.testing.assert_allclose(to_np(out), ref, atol=1e-5)


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("n,h,w,p", SHAPES)
def test_gradients_match_jax(reference, n, h, w, p):
    """d/dmasks and d/dcoords of sum(sin(sample)) against jax.grad; coords
    inside (0.05, 0.95), off the pixel edges where the derivative is
    one-sided (tests/test_pallas_points.py:35). atol 2e-5 for dmasks; for
    dcoords 2e-4 at 16 pixels, scaled by the size: d/dcoords carries the
    factor W (or H), and f32 rounding with it (at 64^2 jitted and eager JAX
    differ by 3.5e-4 on gradients of 100)."""
    masks, coords = _inputs(1, n, h, w, p, 0.05, 0.95)
    fn = JAX_FNS[reference]
    g_ref = jax.jit(jax.grad(lambda m, c: jnp.sum(jnp.sin(fn(m, c))), argnums=(0, 1)))(
        jnp.asarray(masks), jnp.asarray(coords))
    tm = torch.from_numpy(masks).requires_grad_()
    tc = torch.from_numpy(coords).requires_grad_()
    torch.sin(cuda_points.PointSampleFunction.apply(tm, tc, 1)).sum().backward()
    np.testing.assert_allclose(to_np(tm.grad), np.asarray(g_ref[0]), atol=2e-5)
    np.testing.assert_allclose(to_np(tc.grad), np.asarray(g_ref[1]), atol=2e-4 * max(h, w, 16) / 16)


def test_shared_coords_grouping():
    """group = G: mask i samples coords row i // G, the matcher's shared
    points per image, without a broadcast copy; gradients of the shared
    rows sum over their group."""
    masks, coords = _inputs(2, 12, 9, 7, 25)
    shared = torch.from_numpy(coords[:3]).requires_grad_()
    tm = torch.from_numpy(masks).requires_grad_()
    out = cuda_points.PointSampleFunction.apply(tm, shared, 4)
    expanded = shared.detach().repeat_interleave(4, dim=0).requires_grad_()
    tm2 = torch.from_numpy(masks).requires_grad_()
    ref = point_sample(tm2, expanded)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(out.shape).astype(np.float32))
    out.backward(g)
    ref.backward(g)
    torch.testing.assert_close(tm.grad, tm2.grad, rtol=0, atol=0)
    torch.testing.assert_close(shared.grad, expanded.grad.reshape(3, 4, 25, 2).sum(1), rtol=1e-6,
                               atol=1e-6)
    jref = np.asarray(JAX_FNS["xla"](jnp.asarray(masks), jnp.asarray(np.repeat(coords[:3], 4, 0))))
    np.testing.assert_allclose(to_np(out), jref, atol=1e-5)


def test_function_gradcheck_float64():
    rng = np.random.default_rng(4)
    masks = torch.from_numpy(rng.standard_normal((4, 5, 6))).requires_grad_()
    coords = torch.from_numpy(rng.uniform(-0.2, 1.2, (2, 9, 2))).requires_grad_()
    assert torch.autograd.gradcheck(lambda m, c: cuda_points.PointSampleFunction.apply(m, c, 2),
                                    (masks, coords))


def test_cpu_wrappers_take_the_plain_version():
    masks, coords = (torch.from_numpy(a) for a in _inputs(5, 2, 8, 8, 30))
    cuda_points.LAUNCHES.update(forward=0, backward=0)
    torch.testing.assert_close(cuda_points.point_sample(masks, coords), point_sample(masks, coords),
                               rtol=0, atol=0)
    ds = torch.ones(2, 30)
    dm, dc = cuda_points.point_sample_backward(masks, coords, ds)
    assert dm.shape == masks.shape and dc is None
    assert cuda_points.LAUNCHES == {"forward": 0, "backward": 0}


def test_far_outside_gives_zero_and_bad_groups_raise():
    masks, coords = (torch.from_numpy(a) for a in _inputs(6, 2, 8, 8, 30))
    assert float(point_sample(masks, torch.full_like(coords, 3.0)).abs().max()) == 0.0
    with pytest.raises(ValueError, match="groups"):
        point_sample(masks, coords, group=3)
