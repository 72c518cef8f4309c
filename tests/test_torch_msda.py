"""Multi-scale deformable attention of the port against the JAX package:
the plain core (``ops.msda.ms_deform_attn_core``, kernel K4's plain
version) against the JAX XLA core and the Pallas kernel in interpret mode,
and the ``MSDeformAttn`` module against flax, on the same numpy inputs and
weights. Three non-square levels low -> high resolution catch an x/y or H/W
swap; locations in [-0.2, 1.2] put taps past every border."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu.models.msda_module import MSDeformAttn as JaxMSDeformAttn
from incomplete_multimodal_fusion_tpu.models.msda_module import _offset_bias_init
from incomplete_multimodal_fusion_tpu.ops.msda import ms_deform_attn_core as jax_core
from incomplete_multimodal_fusion_tpu.ops.pallas_msda import ms_deform_attn_pallas
from incomplete_multimodal_fusion_tpu_torch.models.msda_module import MSDeformAttn, offset_bias
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_msda
from incomplete_multimodal_fusion_tpu_torch.ops.msda import bilinear_sample, ms_deform_attn_core
from tests.test_torch_common import port_module, random_params, to_np

ATOL = 1e-5
SHAPES = ((3, 5), (6, 4), (7, 9))  # low -> high resolution, none square


def _inputs(seed, b=2, lq=13, m=2, d=8, p=3, shapes=SHAPES, lo=-0.2, hi=1.2):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in shapes)
    l = len(shapes)
    value = rng.standard_normal((b, s, m, d)).astype(np.float32)
    locs = rng.uniform(lo, hi, (b, lq, m, l, p, 2)).astype(np.float32)
    aw = rng.random((b, lq, m, l, p)).astype(np.float32)
    aw /= aw.sum(axis=(-2, -1), keepdims=True)
    return value, locs, aw


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("seed,lq,d,p", [(0, 13, 8, 3), (1, 7, 5, 4), (2, 1, 32, 2)])
def test_core_matches_jax(reference, seed, lq, d, p):
    """The plain core against the JAX XLA core and the Pallas kernel
    (interpret mode), odd Lq, a D that is no multiple of anything."""
    value, locs, aw = _inputs(seed, lq=lq, d=d, p=p)
    fn = jax.jit(jax_core if reference == "xla" else ms_deform_attn_pallas, static_argnums=1)
    ref = np.asarray(fn(jnp.asarray(value), SHAPES, jnp.asarray(locs), jnp.asarray(aw)))
    out = ms_deform_attn_core(torch.from_numpy(value), SHAPES, torch.from_numpy(locs),
                              torch.from_numpy(aw))
    assert out.shape == (2, lq, 2 * d)
    np.testing.assert_allclose(to_np(out), ref, atol=ATOL)


def test_wrapper_takes_the_plain_core_on_the_cpu():
    value, locs, aw = (torch.from_numpy(a) for a in _inputs(3))
    cuda_msda.LAUNCHES["forward"] = 0
    out = cuda_msda.MSDeformAttnFunction.apply(value, SHAPES, locs, aw)
    torch.testing.assert_close(out, ms_deform_attn_core(value, SHAPES, locs, aw), rtol=0, atol=0)
    assert cuda_msda.LAUNCHES["forward"] == 0


def test_function_backward_raises():
    """The Function's backward raised until the backward kernel landed (the
    name is older); on CPU tensors it is now the plain core's vjp: the same
    gradients as autograd of the plain core, and no kernel launch."""
    value, locs, aw = (torch.from_numpy(a).requires_grad_() for a in _inputs(4))
    cuda_msda.LAUNCHES.update(forward=0, backward=0)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 13, 16)).astype(np.float32))
    cuda_msda.MSDeformAttnFunction.apply(value, SHAPES, locs, aw).backward(g)
    refs = [t.detach().clone().requires_grad_() for t in (value, locs, aw)]
    ms_deform_attn_core(refs[0], SHAPES, refs[1], refs[2]).backward(g)
    for t, r in zip((value, locs, aw), refs):
        torch.testing.assert_close(t.grad, r.grad, rtol=0, atol=0)
    assert cuda_msda.LAUNCHES == {"forward": 0, "backward": 0}


def _off_integer(locs, shapes=SHAPES, margin=0.02):
    """Locations moved off the pixel centres, where the bilinear derivative
    is one-sided (tests/test_pallas_msda.py:62-64)."""
    locs = locs.copy()
    for lid, (h, w) in enumerate(shapes):
        for axis, size in ((0, w), (1, h)):
            px = locs[:, :, :, lid, :, axis] * size - 0.5
            frac = px - np.floor(px)
            near = (frac < margin) | (frac > 1 - margin)
            locs[:, :, :, lid, :, axis] += np.where(near, 2.5 * margin / size, 0.0).astype(np.float32)
    return locs


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("seed,lq,d,p", [(6, 13, 8, 3), (7, 5, 32, 2)])
def test_backward_matches_jax_vjp(reference, seed, lq, d, p):
    """Plain dvalue, dlocations and dweights against jax.vjp of the JAX core
    and of the Pallas kernel (interpret mode), at off-integer locations."""
    value, locs, aw = _inputs(seed, lq=lq, d=d, p=p)
    locs = _off_integer(locs)
    dout = np.random.default_rng(seed + 100).standard_normal((2, lq, 2 * d)).astype(np.float32)
    fn = jax_core if reference == "xla" else ms_deform_attn_pallas

    def vjp(v, lc, a, g):
        return jax.vjp(lambda v, lc, a: fn(v, SHAPES, lc, a), v, lc, a)[1](g)

    refs = jax.jit(vjp)(*(jnp.asarray(t) for t in (value, locs, aw, dout)))
    outs = cuda_msda.ms_deform_attn_backward(*(torch.from_numpy(t) for t in (value,)), SHAPES,
                                             torch.from_numpy(locs), torch.from_numpy(aw),
                                             torch.from_numpy(dout))
    for name, o, r in zip(("dvalue", "dlocations", "dweights"), outs, refs):
        np.testing.assert_allclose(to_np(o), np.asarray(r), atol=2e-4, rtol=1e-4, err_msg=name)


def test_function_gradcheck_float64():
    """The repair: MSDeformAttnFunction differentiates on the CPU."""
    rng = np.random.default_rng(8)
    shapes = ((2, 3), (3, 2))
    s = sum(h * w for h, w in shapes)
    value = torch.from_numpy(rng.standard_normal((1, s, 2, 3))).requires_grad_()
    locs = torch.from_numpy(_off_integer(rng.uniform(-0.2, 1.2, (1, 4, 2, 2, 2, 2)), shapes, 0.05))
    aw = torch.from_numpy(rng.random((1, 4, 2, 2, 2))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda v, lc, a: cuda_msda.MSDeformAttnFunction.apply(v, shapes, lc, a),
        (value, locs.requires_grad_(), aw))


def test_bilinear_zero_padding():
    """Far outside gives 0, half a pixel past the border half the value,
    the grid_sample(align_corners=False) convention of test_msda.py."""
    img = torch.ones(1, 4, 4, 1)
    x = torch.tensor([[-5.0, -0.5, 1.0, 3.5]])
    y = torch.tensor([[0.0, 0.0, 1.0, 1.0]])
    np.testing.assert_allclose(to_np(bilinear_sample(img, x, y))[0, :, 0], [0.0, 0.5, 1.0, 0.5])


def test_locations_outside_every_level_give_zero():
    value, locs, aw = (torch.from_numpy(a) for a in _inputs(5))
    out = ms_deform_attn_core(value, SHAPES, torch.full_like(locs, 3.0), aw)
    assert float(out.abs().max()) == 0.0


def test_offset_bias_matches_jax_init():
    for m, l, p in ((8, 3, 4), (3, 2, 5)):
        ref = np.asarray(_offset_bias_init(m, l, p)(None, (m * l * p * 2,)))
        np.testing.assert_array_equal(to_np(offset_bias(m, l, p)), ref)


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_module_matches_flax(impl):
    """MSDeformAttn with random (non-zero) sampling kernels, so the samples
    fall between pixel centres, against flax on the same weights."""
    d_model, heads, points, b, lq = 32, 4, 2, 2, 9
    rng = np.random.default_rng(6)
    s = sum(h * w for h, w in SHAPES)
    query = rng.standard_normal((b, lq, d_model)).astype(np.float32)
    ref_pts = rng.uniform(0.0, 1.0, (b, lq, len(SHAPES), 2)).astype(np.float32)
    feat = rng.standard_normal((b, s, d_model)).astype(np.float32)
    jm = JaxMSDeformAttn(d_model, len(SHAPES), heads, points, impl="xla")
    args = (jnp.asarray(query), jnp.asarray(ref_pts), jnp.asarray(feat), SHAPES)
    params = random_params(jm, 7, *args)
    ref = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, SHAPES))(params, *args[:3])
    tm = port_module(MSDeformAttn(d_model, len(SHAPES), heads, points, impl=impl), params)
    with torch.no_grad():
        out = tm(torch.from_numpy(query), torch.from_numpy(ref_pts), torch.from_numpy(feat), SHAPES)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=1e-4)
