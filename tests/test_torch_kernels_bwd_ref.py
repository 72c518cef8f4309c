"""The plain backward beside each hand-written backward kernel, held against
``jax.vjp`` of both JAX forms of the Pallas kernel it replaces: the Pallas
kernel (its custom VJP, in interpret mode on the CPU) and its plain-XLA twin
(atol 2e-5, rtol 1e-5, f32). Also ``torch.autograd.gradcheck`` in float64 on
each autograd Function, which on CPU tensors runs the plain forward and the
plain backward -- the wiring the card runs with the kernels."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu.ops import pallas_ffn as jffn
from incomplete_multimodal_fusion_tpu.ops.pallas_attn import (
    _packed_qkv_xla, zorro_self_attention, zorro_self_attention_packed_qkv)
from incomplete_multimodal_fusion_tpu.ops.pallas_fusion_attn import (
    fusion_row_attention as jfusion_row, fusion_row_attention_xla)
from incomplete_multimodal_fusion_tpu.ops.pallas_small_attn import (
    small_attention_qkv, small_attention_qkv_xla)
from incomplete_multimodal_fusion_tpu_torch import ops as tops
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_attn, cuda_ffn, cuda_fusion_attn
from tests.test_torch_common import to_np
from tests.test_torch_kernels_ref import ZORRO_CASES

TOL = dict(atol=2e-5, rtol=1e-5)


def _vjp(fn, primals, cotangent):
    _, pullback = jax.vjp(fn, *map(jnp.asarray, primals))
    return [np.asarray(g) for g in pullback(jnp.asarray(cotangent))]


def _zorro_pallas(qkv, types, heads):
    """The Pallas attention on the fused slab: the packed-qkv body (#8) up to
    N = 768, the [B*H, N, dh] q-tiled body (#7) above."""
    b, n, three_i = qkv.shape
    if n <= 768:
        return zorro_self_attention_packed_qkv(qkv, types, heads, 3)
    dh = three_i // 3 // heads
    q, k, v = (t.reshape(b, n, heads, dh) for t in jnp.split(qkv, 3, axis=-1))
    return zorro_self_attention(q, k, v, types, 3).reshape(b, n, three_i // 3)


@pytest.mark.parametrize("case", sorted(ZORRO_CASES))
def test_zorro_backward_reference_matches_pallas_and_xla(case):
    """Masked, with packings where a `dem` (or `s2`) query's first key tiles
    hold only other types' keys."""
    b, heads, dh, rows = ZORRO_CASES[case]
    types = np.stack(rows)
    n = types.shape[1]
    rng = np.random.default_rng(10)
    qkv = rng.standard_normal((b, n, 3 * heads * dh)).astype(np.float32)
    do = rng.standard_normal((b, n, heads * dh)).astype(np.float32)
    tq, tt = torch.from_numpy(qkv), torch.from_numpy(types)
    out, lse = cuda_attn.zorro_attention_qkv_reference(tq, heads, tt, 3, return_lse=True)
    got = to_np(cuda_attn.zorro_attention_qkv_backward_reference(tq, tt, out, lse,
                                                                 torch.from_numpy(do), heads, 3))
    jt = jnp.asarray(types)
    pallas, = _vjp(lambda x: _zorro_pallas(x, jt, heads), [qkv], do)
    xla, = _vjp(lambda x: _packed_qkv_xla(x, jt, heads, 3, None), [qkv], do)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, xla, **TOL)


def test_unmasked_backward_reference_matches_pallas_and_xla():
    b, n, heads, dh = 2, 64, 2, 32
    rng = np.random.default_rng(11)
    qkv = rng.standard_normal((b, n, 3 * heads * dh)).astype(np.float32)
    do = rng.standard_normal((b, n, heads * dh)).astype(np.float32)
    tq = torch.from_numpy(qkv)
    out, lse = cuda_attn.zorro_attention_qkv_reference(tq, heads, return_lse=True)
    got = to_np(cuda_attn.zorro_attention_qkv_backward_reference(tq, None, out, lse,
                                                                 torch.from_numpy(do), heads))
    pallas, = _vjp(lambda x: small_attention_qkv(x, heads, dh), [qkv], do)
    xla, = _vjp(lambda x: small_attention_qkv_xla(x, heads, dh), [qkv], do)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, xla, **TOL)


@pytest.mark.parametrize("inner", [42, 170])
def test_geglu_padded_hidden_width_is_exact(inner):
    """The wrappers zero-pad a GEGLU inner width that is not a multiple of 16
    (the `large` config's 2730) before launching K2 / K2b: the plain forward
    and backward on the padded weights equal those on the unpadded ones and
    JAX's ``geglu_ffn_xla`` (and its vjp) at d = 64, once the padded
    gradient rows and columns are dropped."""
    m, d = 96, 64
    rng = np.random.default_rng(14)
    x = rng.standard_normal((m, d)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    w_in = (rng.standard_normal((d, 2 * inner)) * d ** -0.5).astype(np.float32)
    w_out = (rng.standard_normal((inner, d)) * inner ** -0.5).astype(np.float32)
    dy = rng.standard_normal((m, d)).astype(np.float32)
    tx, tgamma, tw_in, tw_out, tdy = map(torch.from_numpy, (x, gamma, w_in.T.copy(), w_out.T.copy(), dy))
    pw_in, pw_out = cuda_ffn.pad_geglu_hidden(tw_in, tw_out)
    assert pw_out.shape[1] % cuda_ffn.HIDDEN_MULTIPLE == 0 and pw_out.shape[1] > inner
    assert pw_in.shape == (2 * pw_out.shape[1], d)

    padded = to_np(cuda_ffn.geglu_ffn_reference(tx, tgamma, pw_in, pw_out))
    np.testing.assert_allclose(padded, to_np(cuda_ffn.geglu_ffn_reference(tx, tgamma, tw_in, tw_out)), **TOL)
    args = tuple(map(jnp.asarray, (x, gamma[None], w_in, w_out)))
    np.testing.assert_allclose(padded, np.asarray(jffn.geglu_ffn_xla(*args)), **TOL)

    dx, dgamma, dw_in_p, dw_out_p = cuda_ffn.geglu_ffn_backward_reference(tx, tgamma, pw_in, pw_out, tdy)
    dw_in, dw_out = cuda_ffn.unpad_geglu_grads(dw_in_p, dw_out_p, inner)
    pad = pw_out.shape[1] - inner
    assert float(dw_out_p[:, inner:].abs().max()) == 0.0 and pad > 0
    assert float(dw_in_p[inner:inner + pad].abs().max()) == float(dw_in_p[-pad:].abs().max()) == 0.0
    unpadded = cuda_ffn.geglu_ffn_backward_reference(tx, tgamma, tw_in, tw_out, tdy)
    for a, b in zip((dx, dgamma, dw_in, dw_out), unpadded):
        assert a.shape == b.shape
        np.testing.assert_allclose(to_np(a), to_np(b), **TOL)
    jdx, jdgamma, jdw_in, jdw_out = _vjp(jffn.geglu_ffn_xla, (x, gamma[None], w_in, w_out), dy)
    np.testing.assert_allclose(to_np(dx), jdx, **TOL)
    np.testing.assert_allclose(to_np(dgamma), jdgamma[0], **TOL)
    np.testing.assert_allclose(to_np(dw_in), jdw_in.T, **TOL)
    np.testing.assert_allclose(to_np(dw_out), jdw_out.T, **TOL)


def test_aligned_geglu_weights_are_not_copied():
    w_in, w_out = torch.zeros(64, 8), torch.zeros(8, 32)
    pw_in, pw_out = cuda_ffn.pad_geglu_hidden(w_in, w_out)
    assert pw_in is w_in and pw_out is w_out
    assert cuda_ffn.unpad_geglu_grads(w_in, w_out, 32) == (w_in, w_out)


@pytest.mark.parametrize("m,d,inner", [(256, 64, 170), (256, 32, 48)])
def test_geglu_backward_reference_matches_pallas_and_xla(m, d, inner):
    """M = 256 runs as two JAX row tiles, so the weight gradients there are
    the sum the sequential grid carries across tiles."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((m, d)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    w_in = (rng.standard_normal((d, 2 * inner)) * d ** -0.5).astype(np.float32)
    w_out = (rng.standard_normal((inner, d)) * inner ** -0.5).astype(np.float32)
    dy = rng.standard_normal((m, d)).astype(np.float32)
    dx, dgamma, dw_in, dw_out = map(to_np, cuda_ffn.geglu_ffn_backward_reference(
        *map(torch.from_numpy, (x, gamma, w_in.T.copy(), w_out.T.copy(), dy))))
    primals = (x, gamma[None], w_in, w_out)
    for fn in (jffn.geglu_ffn, jffn.geglu_ffn_xla):
        jdx, jdgamma, jdw_in, jdw_out = _vjp(fn, primals, dy)
        np.testing.assert_allclose(dx, jdx, **TOL)
        np.testing.assert_allclose(dgamma, jdgamma[0], **TOL)
        np.testing.assert_allclose(dw_in, jdw_in.T, **TOL)
        np.testing.assert_allclose(dw_out, jdw_out.T, **TOL)


def test_mlp_backward_reference_matches_pallas_and_xla():
    rng = np.random.default_rng(13)
    m, d, hidden, out = 256, 32, 128, 48
    x = rng.standard_normal((m, d)).astype(np.float32)
    w1 = (rng.standard_normal((d, hidden)) * d ** -0.5).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(hidden)).astype(np.float32)
    w2 = (rng.standard_normal((hidden, out)) * hidden ** -0.5).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(out)).astype(np.float32)
    dy = rng.standard_normal((m, out)).astype(np.float32)
    dx, dw1, db1, dw2, db2 = map(to_np, cuda_ffn.mlp_ffn_backward_reference(
        *map(torch.from_numpy, (x, w1.T.copy(), b1, w2.T.copy(), b2, dy))))
    primals = (x, w1, b1[None], w2, b2[None])
    for fn in (jffn.mlp_ffn, jffn.mlp_ffn_xla):
        jdx, jdw1, jdb1, jdw2, jdb2 = _vjp(fn, primals, dy)
        np.testing.assert_allclose(dx, jdx, **TOL)
        np.testing.assert_allclose(dw1, jdw1.T, **TOL)
        np.testing.assert_allclose(db1, jdb1[0], **TOL)
        np.testing.assert_allclose(dw2, jdw2.T, **TOL)
        np.testing.assert_allclose(db2, jdb2[0], **TOL)


@pytest.mark.parametrize("t_mod", [2, 3])
def test_fusion_row_backward_reference_matches_pallas_and_xla(t_mod):
    rng = np.random.default_rng(14)
    b, f, heads, dh = 2, 16, 2, 16
    inner = heads * dh
    q = rng.standard_normal((b, f, inner)).astype(np.float32)
    kv_grid = rng.standard_normal((b, t_mod * f, 2 * inner)).astype(np.float32)
    kv_f = rng.standard_normal((b, f, 2 * inner)).astype(np.float32)
    do = rng.standard_normal((b, f, inner)).astype(np.float32)
    got = [to_np(t) for t in cuda_fusion_attn.fusion_row_attention_backward_reference(
        *map(torch.from_numpy, (q, kv_grid, kv_f, do)), heads, dh)]
    for fn in (jfusion_row, fusion_row_attention_xla):
        ref = _vjp(lambda a, g, c: fn(a, g, c, heads, dh), (q, kv_grid, kv_f), do)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, **TOL)


# ---------------------------------------------------------------------------
# the autograd Functions, float64, on CPU tensors
# ---------------------------------------------------------------------------

def _rand64(*shape, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g, dtype=torch.float64) * scale).requires_grad_()


@pytest.mark.parametrize("masked", [True, False])
def test_zorro_function_gradcheck(masked):
    types = torch.tensor([[0, 0, 1, 2, 255, 3, 3], [1, 1, 1, 255, 255, 3, 3]]) if masked else None
    qkv = _rand64(2, 7, 3 * 2 * 4, seed=20)
    assert torch.autograd.gradcheck(
        lambda t: cuda_attn.ZorroAttentionQKV.apply(t, 2, types, 3 if masked else None), (qkv,))


def test_geglu_function_gradcheck():
    x, gamma = _rand64(5, 8, seed=21), _rand64(8, seed=22, scale=0.3)
    w_in, w_out = _rand64(12, 8, seed=23, scale=0.3), _rand64(8, 6, seed=24, scale=0.3)
    assert torch.autograd.gradcheck(cuda_ffn.GegluFFN.apply, (x, gamma, w_in, w_out))


def test_mlp_function_gradcheck():
    x, w1, b1 = _rand64(5, 6, seed=25), _rand64(10, 6, seed=26, scale=0.4), _rand64(10, seed=27)
    w2, b2 = _rand64(4, 10, seed=28, scale=0.3), _rand64(4, seed=29)
    assert torch.autograd.gradcheck(cuda_ffn.MlpFFN.apply, (x, w1, b1, w2, b2))


@pytest.mark.parametrize("t_mod", [1, 3])
def test_fusion_row_function_gradcheck(t_mod):
    b, f, heads, dh = 2, 3, 2, 4
    q, kvg = _rand64(b, f, heads * dh, seed=30), _rand64(b, t_mod * f, 2 * heads * dh, seed=31)
    kvf = _rand64(b, f, 2 * heads * dh, seed=32)
    assert torch.autograd.gradcheck(
        lambda a, g, c: cuda_fusion_attn.FusionRowAttention.apply(a, g, c, heads, dh),
        (q, kvg, kvf))


def test_functions_on_cpu_launch_nothing():
    """On CPU tensors the Functions run the plain forward and backward: the
    gradients flow and no kernel counter moves."""
    tops.reset_kernel_launches()
    qkv = _rand64(1, 5, 3 * 8, seed=33)
    cuda_attn.ZorroAttentionQKV.apply(qkv, 2).sum().backward()
    assert qkv.grad is not None and torch.isfinite(qkv.grad).all()
    assert all(n == 0 for n in tops.kernel_launches().values())
