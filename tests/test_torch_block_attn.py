"""Kernel K6's plain versions (ops/cuda_block_attn.py), the fused attention
half-block, against the JAX package on the CPU:

  * forward and backward against ``fused_block_attn`` (the Pallas kernel in
    interpret mode, its custom VJP through ``jax.vjp``) and
    ``fused_block_attn_xla``, at the JAX tests' own size
    (tests/test_pallas_block_attn.py:24: B 2, N 64, D 32, 2 heads of 16, the
    last 5 slots PAD), f32: atol 2e-5 forward, 5e-5 gradients; one bf16 case
    within rel-L2 1e-2 (the two sides round at the same places);
  * the port's ``EncoderBlock(fused_block=True)`` against the JAX fused
    block, weights carried by ``params_from_jax``, values and every
    parameter gradient, at a width the fused route admits (I % 64 == 0);
  * the port's fused block against its own composed block (as
    tests/test_pallas_block_attn.py:78 does in JAX);
  * ``block_attn_supported`` gives JAX's answers, and a float64
    ``gradcheck`` of ``FusedBlockAttn``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu.models import layers as jlayers
from incomplete_multimodal_fusion_tpu.ops import pallas_block_attn as jblock
from incomplete_multimodal_fusion_tpu_torch.models import layers as tlayers
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_block_attn
from incomplete_multimodal_fusion_tpu_torch.utils.jax_params import params_from_jax
from tests.test_torch_common import port_module, random_params, to_np

B, N, D, H, DH = 2, 64, 32, 2, 16
FUSION = 2
PAD = 255


def _data(dtype=np.float32):
    """x, types and the JAX-layout weights (g1, g2 [1, D], wq [D, I],
    wkv [D, 2I], wo [I, D]) of tests/test_pallas_block_attn.py, and a
    cotangent dy."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, N, D)).astype(dtype)
    types = rng.integers(0, 3, size=(B, N)).astype(np.int32)
    types[:, -5:] = PAD
    rng = np.random.default_rng(1)
    inner = H * DH
    weights = [(rng.normal(size=(1, D)) * 0.1 + 1.0), (rng.normal(size=(1, D)) * 0.1 + 1.0),
               rng.normal(size=(D, inner)) * 0.05, rng.normal(size=(D, 2 * inner)) * 0.05,
               rng.normal(size=(inner, D)) * 0.05]
    dy = np.random.default_rng(2).normal(size=(B, N, D))
    return x, types, [w.astype(dtype) for w in weights], dy.astype(dtype)


def _port_weights(weights, dtype=torch.float32):
    """JAX layout -> the port's: gains [D], Dense kernels transposed."""
    g1, g2, wq, wkv, wo = (torch.from_numpy(np.ascontiguousarray(w)).to(dtype) for w in weights)
    return g1[0], g2[0], wq.t().contiguous(), wkv.t().contiguous(), wo.t().contiguous()


def _jax_grads_in_port_layout(grads):
    """(dx, dg1, dg2, dwq, dwkv, dwo) of the JAX functions in the port's
    layout."""
    dx, dg1, dg2, dwq, dwkv, dwo = (np.asarray(g, np.float32) for g in grads)
    return [dx, dg1[0], dg2[0], dwq.T, dwkv.T, dwo.T]


def _jax_vjp(fn, x, types, weights, dy):
    jt = jnp.asarray(types)
    out, pullback = jax.vjp(lambda x_, *w: fn(x_, jt, *w, H, FUSION), jnp.asarray(x),
                            *map(jnp.asarray, weights))
    return np.asarray(out, np.float32), _jax_grads_in_port_layout(pullback(jnp.asarray(dy)))


@pytest.mark.parametrize("jax_fn", ["pallas", "xla"])
def test_plain_versions_match_jax_f32(jax_fn):
    x, types, weights, dy = _data()
    fn = jblock.fused_block_attn if jax_fn == "pallas" else jblock.fused_block_attn_xla
    ref, ref_grads = _jax_vjp(fn, x, types, weights, dy)
    tx, tt, tdy = torch.from_numpy(x), torch.from_numpy(types), torch.from_numpy(dy)
    w = _port_weights(weights)
    y = cuda_block_attn.fused_block_attn(tx, tt, *w, H, FUSION)
    grads = cuda_block_attn.fused_block_attn_backward(tx, tt, *w, tdy, H, FUSION)
    np.testing.assert_allclose(to_np(y), ref, atol=2e-5)
    for name, got, want in zip(("dx", "dg1", "dg2", "dwq", "dwkv", "dwo"), grads, ref_grads):
        np.testing.assert_allclose(to_np(got), want, atol=5e-5, err_msg=name)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_plain_versions_match_jax_bf16():
    """The same inputs rounded to bf16 on both sides; rel-L2 1e-2 (the cast
    points agree; the sums' order and libm do not)."""
    x, types, weights, dy = _data()
    bf = jnp.bfloat16
    jt = jnp.asarray(types)
    jw = [jnp.asarray(w, bf) for w in weights]
    out, pullback = jax.vjp(lambda x_, *w: jblock.fused_block_attn(x_, jt, *w, H, FUSION),
                            jnp.asarray(x, bf), *jw)
    ref_grads = _jax_grads_in_port_layout(pullback(jnp.asarray(dy, bf)))
    tb = torch.bfloat16
    tx, tdy = torch.from_numpy(x).to(tb), torch.from_numpy(dy).to(tb)
    w = _port_weights(weights, tb)
    y = cuda_block_attn.fused_block_attn(tx, torch.from_numpy(types), *w, H, FUSION)
    grads = cuda_block_attn.fused_block_attn_backward(tx, torch.from_numpy(types), *w, tdy, H, FUSION)
    assert y.dtype == tb and all(g.dtype == tb for g in grads)
    assert _rel(to_np(y.float()), np.asarray(out, np.float32)) <= 1e-2
    for name, got, want in zip(("dx", "dg1", "dg2", "dwq", "dwkv", "dwo"), grads, ref_grads):
        assert _rel(to_np(got.float()), want) <= 1e-2, name


# a width the fused route admits: I = 2 x 32 = 64
BLOCK_DIM, BLOCK_DH, BLOCK_HEADS, BLOCK_N = 64, 32, 2, 40


def _block_inputs():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, BLOCK_N, BLOCK_DIM)).astype(np.float32)
    types = np.asarray([[0] * 10 + [1] * 8 + [2] * 4 + [PAD] * 2 + [3] * 16,
                        [1] * 12 + [2] * 6 + [PAD] * 6 + [3] * 16], np.int32)
    weight = np.cos(0.01 * np.arange(x.size)).reshape(x.shape).astype(np.float32)
    return x, types, weight


def _port_block(params, fused):
    block = tlayers.EncoderBlock(BLOCK_DIM, BLOCK_DH, BLOCK_HEADS, 4, fused_block=fused)
    return port_module(block, params)


def _port_value_and_grads(block, x, types, weight):
    block.zero_grad(set_to_none=True)
    y = block(torch.from_numpy(x), torch.from_numpy(types), 3, use_kernel=True)
    (y * torch.from_numpy(weight)).sum().backward()
    return to_np(y), {n: to_np(p.grad) for n, p in block.named_parameters()}


def test_encoder_block_fused_matches_jax_fused_block(monkeypatch):
    x, types, weight = _block_inputs()
    assert cuda_block_attn.block_attn_supported(BLOCK_N, BLOCK_DIM, BLOCK_HEADS * BLOCK_DH)
    jm = jlayers.EncoderBlock(dim_head=BLOCK_DH, heads=BLOCK_HEADS, ff_mult=4, fused_block=True)
    jx, jt = jnp.asarray(x), jnp.asarray(types)
    params = random_params(jm, 8, jx, packed_types=jt, fusion_type=3)

    def loss(p):
        y = jm.apply({"params": p}, jx, packed_types=jt, fusion_type=3, use_pallas=True)
        return jnp.sum(y * jnp.asarray(weight)), y

    (_, ref), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    calls = []
    real = cuda_block_attn.fused_block_attn
    monkeypatch.setattr(cuda_block_attn, "fused_block_attn", lambda *a: calls.append(1) or real(*a))
    y, grads = _port_value_and_grads(_port_block(params, True), x, types, weight)
    assert calls == [1]  # the fused route ran
    np.testing.assert_allclose(y, np.asarray(ref), atol=2e-5)
    want = {n: to_np(g) for n, g in params_from_jax(jgrads).items()}
    assert sorted(grads) == sorted(want)
    for name in want:
        np.testing.assert_allclose(grads[name], want[name], atol=5e-5, err_msg=name)


def test_fused_block_matches_the_composed_block():
    """fused_block=True is the composed block, values and every gradient,
    on the same state dict."""
    x, types, weight = _block_inputs()
    jm = jlayers.EncoderBlock(dim_head=BLOCK_DH, heads=BLOCK_HEADS, ff_mult=4)
    params = random_params(jm, 9, jnp.asarray(x), packed_types=jnp.asarray(types), fusion_type=3)
    y_f, g_f = _port_value_and_grads(_port_block(params, True), x, types, weight)
    y_c, g_c = _port_value_and_grads(_port_block(params, False), x, types, weight)
    np.testing.assert_allclose(y_f, y_c, atol=3e-6)
    for name in g_c:
        np.testing.assert_allclose(g_f[name], g_c[name], atol=2e-5, err_msg=name)


@pytest.mark.parametrize("n,d,inner", [(640, 192, 192), (1024, 192, 192), (636, 192, 192), (64, 32, 32),
                                       (256, 768, 768), (768, 768, 768), (40, 64, 64)])
def test_block_attn_supported_matches_jax(n, d, inner):
    assert cuda_block_attn.block_attn_supported(n, d, inner) == jblock.block_attn_supported(n, d, inner)


def test_fused_block_function_gradcheck():
    g = torch.Generator().manual_seed(10)

    def rand(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=g, dtype=torch.float64) * scale + shift).requires_grad_()

    types = torch.tensor([[0, 0, 1, 255, 3, 3]])
    x = rand(1, 6, 8)
    g1, g2 = rand(8, scale=0.1, shift=1.0), rand(8, scale=0.1, shift=1.0)
    wq, wkv, wo = rand(8, 8, scale=0.3), rand(16, 8, scale=0.3), rand(8, 8, scale=0.3)
    assert torch.autograd.gradcheck(
        lambda *a: cuda_block_attn.FusedBlockAttn.apply(a[0], types, *a[1:], 2, 3), (x, g1, g2, wq, wkv, wo))


def _earlier_design_took(d: int, inner: int, dh: int) -> bool:
    """Whether the earlier wmma design of K6 / K6b fitted its shared memory
    (227 KB) at these widths: its projection pass (64 rows of h), attention
    pass and prep (a 64-query tile with every head's output), and row pass
    (16 rows of dqkv and of dhid)."""
    a128 = lambda b: (b + 127) // 128 * 128  # noqa: E731
    ldh = dh + 8
    tile = 64 * ldh * 2 * 3 + 64 * 68 * 4 + 64 * 72 * 2 + 64 * (dh + 4) * 4 + 3 * 64 * 4 + 128 * 4
    sizes = (a128(64 * (d + 8) * 2) + 4 * 16 * 68 * 4, a128(tile) + 64 * (inner + 8) * 2,
             max(a128(tile), a128(64 * (d + 8) * 2)) + a128(64 * (inner + 8) * 2) + 64 * 68 * 4,
             a128(16 * (3 * inner + 8) * 2) + 16 * (d + 4) * 4 + 2 * d * 4)
    return max(sizes) <= 232448


@pytest.mark.parametrize("dh", [32, 64, 128])
def test_kernel_widths_hold_every_width_the_earlier_design_took(dh):
    took = [(d, i) for d in range(16, 2049, 16) for i in range(dh, 2049, dh) if _earlier_design_took(d, i, dh)]
    assert max(d for d, _ in took) >= 1536 and max(i for _, i in took) >= 768
    assert all(d <= cuda_block_attn.MAX_D and i <= cuda_block_attn.MAX_D for d, i in took)


def test_kernel_widths_hold_every_equal_width_jax_admits():
    """Every D = I (multiple of 64) that JAX's gate admits at any N is
    within the kernels' MAX_D."""
    admitted = [d for d in range(64, 4097, 64) if any(jblock.block_attn_supported(n, d, d) for n in (8, 64, 256))]
    assert admitted and max(admitted) <= cuda_block_attn.MAX_D
