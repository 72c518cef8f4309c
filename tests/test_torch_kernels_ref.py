"""The plain PyTorch version beside each hand-written kernel, held against
both JAX forms of the Pallas kernel it replaces: the Pallas kernel itself in
interpret mode and its plain-XLA twin (atol 2e-5, rtol 1e-5, f32). The CUDA
kernels themselves run only on the card, where chip_smoke.py holds them
against these plain versions."""
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

TOL = dict(atol=2e-5, rtol=1e-5)


def _packed_types(counts, pad, fusion, fusion_type=3):
    """One packed row: modality slots in type order, padding, fusion tail --
    a `dem` query's first 64-key tile then holds only other types' keys."""
    row = [t for t, c in enumerate(counts) for _ in range(c)] + [255] * pad + [fusion_type] * fusion
    return np.asarray(row, np.int32)


ZORRO_CASES = {
    # N = 128: the whole-slab packed-qkv kernel (pallas_attn.py:442)
    "n128": (2, 2, 32, [_packed_types((40, 30, 20), 6, 32), _packed_types((0, 70, 20), 6, 32)]),
    # N = 896 > 768: the q-tiled kernel (pallas_attn.py:123, _q_tile(896) = 128)
    "n896": (1, 3, 16, [_packed_types((300, 200, 150), 86, 160)]),
    "n896_dh64": (1, 2, 64, [_packed_types((0, 400, 250), 86, 160)]),
}


@pytest.mark.parametrize("case", sorted(ZORRO_CASES))
def test_zorro_attention_reference_matches_pallas_and_xla(case):
    b, heads, dh, rows = ZORRO_CASES[case]
    types = np.stack(rows)
    n = types.shape[1]
    inner = heads * dh
    qkv = np.random.default_rng(0).standard_normal((b, n, 3 * inner)).astype(np.float32)
    out = to_np(cuda_attn.zorro_attention_qkv_reference(
        torch.from_numpy(qkv), heads, torch.from_numpy(types), 3))
    xla = _packed_qkv_xla(jnp.asarray(qkv), jnp.asarray(types), heads, 3, None)
    if n <= 768:
        pallas = zorro_self_attention_packed_qkv(jnp.asarray(qkv), jnp.asarray(types), heads, 3)
    else:
        q, k, v = (jnp.asarray(t.reshape(b, n, heads, dh)) for t in np.split(qkv, 3, axis=-1))
        pallas = zorro_self_attention(q, k, v, jnp.asarray(types), 3).reshape(b, n, inner)
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out, np.asarray(xla), **TOL)


def test_unmasked_attention_reference_matches_pallas_and_xla():
    b, n, heads, dh = 2, 64, 2, 32
    qkv = np.random.default_rng(1).standard_normal((b, n, 3 * heads * dh)).astype(np.float32)
    out = to_np(cuda_attn.zorro_attention_qkv_reference(torch.from_numpy(qkv), heads))
    np.testing.assert_allclose(out, np.asarray(small_attention_qkv(jnp.asarray(qkv), heads, dh)),
                               **TOL)
    np.testing.assert_allclose(out, np.asarray(small_attention_qkv_xla(jnp.asarray(qkv), heads, dh)),
                               **TOL)


@pytest.mark.parametrize("m,d,inner", [(256, 64, 170), (256, 32, 48)])
def test_geglu_reference_matches_pallas_and_xla(m, d, inner):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((m, d)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    w_in = (rng.standard_normal((d, 2 * inner)) * d ** -0.5).astype(np.float32)
    w_out = (rng.standard_normal((inner, d)) * inner ** -0.5).astype(np.float32)
    out = to_np(cuda_ffn.geglu_ffn_reference(*map(torch.from_numpy, (x, gamma, w_in.T, w_out.T))))
    args = tuple(map(jnp.asarray, (x, gamma[None], w_in, w_out)))
    np.testing.assert_allclose(out, np.asarray(jffn.geglu_ffn(*args)), **TOL)
    np.testing.assert_allclose(out, np.asarray(jffn.geglu_ffn_xla(*args)), **TOL)


def test_mlp_reference_matches_pallas_and_xla():
    rng = np.random.default_rng(3)
    m, d, hidden = 256, 32, 128
    x = rng.standard_normal((m, d)).astype(np.float32)
    w1 = (rng.standard_normal((d, hidden)) * d ** -0.5).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(hidden)).astype(np.float32)
    w2 = (rng.standard_normal((hidden, d)) * hidden ** -0.5).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(d)).astype(np.float32)
    out = to_np(cuda_ffn.mlp_ffn_reference(*map(torch.from_numpy, (x, w1.T, b1, w2.T, b2))))
    args = tuple(map(jnp.asarray, (x, w1, b1[None], w2, b2[None])))
    np.testing.assert_allclose(out, np.asarray(jffn.mlp_ffn(*args)), **TOL)
    np.testing.assert_allclose(out, np.asarray(jffn.mlp_ffn_xla(*args)), **TOL)


@pytest.mark.parametrize("t_mod", [2, 3])
def test_fusion_row_reference_matches_pallas_and_xla(t_mod):
    rng = np.random.default_rng(4)
    b, f, heads, dh = 2, 16, 2, 16
    inner = heads * dh
    q = rng.standard_normal((b, f, inner)).astype(np.float32)
    kv_grid = rng.standard_normal((b, t_mod * f, 2 * inner)).astype(np.float32)
    kv_f = rng.standard_normal((b, f, 2 * inner)).astype(np.float32)
    out = to_np(cuda_fusion_attn.fusion_row_attention_reference(
        *map(torch.from_numpy, (q, kv_grid, kv_f)), heads, dh))
    args = tuple(map(jnp.asarray, (q, kv_grid, kv_f)))
    np.testing.assert_allclose(out, np.asarray(jfusion_row(*args, heads, dh)), **TOL)
    np.testing.assert_allclose(out, np.asarray(fusion_row_attention_xla(*args, heads, dh)), **TOL)


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    """On a CPU tensor each wrapper returns its plain version's result and
    launches nothing."""
    rng = np.random.default_rng(5)
    tops.reset_kernel_launches()
    qkv = torch.from_numpy(rng.standard_normal((1, 40, 3 * 64)).astype(np.float32))
    types = torch.from_numpy(_packed_types((10, 10, 4), 4, 12)[None])
    torch.testing.assert_close(cuda_attn.zorro_attention_qkv(qkv, 2, types, 3),
                               cuda_attn.zorro_attention_qkv_reference(qkv, 2, types, 3),
                               rtol=0, atol=0)
    torch.testing.assert_close(cuda_attn.zorro_attention_qkv(qkv, 2),
                               cuda_attn.zorro_attention_qkv_reference(qkv, 2), rtol=0, atol=0)
    x = torch.randn(8, 32)
    w = [torch.randn(64, 32), torch.randn(32), torch.randn(32, 32)]
    torch.testing.assert_close(cuda_ffn.geglu_ffn(x, w[1], w[0], w[2]),
                               cuda_ffn.geglu_ffn_reference(x, w[1], w[0], w[2]), rtol=0, atol=0)
    b1, b2 = torch.randn(64), torch.randn(32)
    torch.testing.assert_close(cuda_ffn.mlp_ffn(x, w[0], b1, w[0].t().contiguous(), b2),
                               cuda_ffn.mlp_ffn_reference(x, w[0], b1, w[0].t(), b2), rtol=0, atol=0)
    q, g, f = torch.randn(1, 4, 32), torch.randn(1, 12, 64), torch.randn(1, 4, 64)
    torch.testing.assert_close(cuda_fusion_attn.fusion_row_attention(q, g, f, 1, 32),
                               cuda_fusion_attn.fusion_row_attention_reference(q, g, f, 1, 32),
                               rtol=0, atol=0)
    assert all(n == 0 for n in tops.kernel_launches().values())


@pytest.mark.parametrize("call", ["zorro", "geglu", "mlp", "fusion_row"])
def test_wrappers_raise_for_a_device_without_kernel(call):
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        if call == "zorro":
            cuda_attn.zorro_attention_qkv(torch.empty(1, 8, 96, **meta), 1)
        elif call == "geglu":
            cuda_ffn.geglu_ffn(torch.empty(8, 32, **meta), torch.empty(32, **meta),
                               torch.empty(64, 32, **meta), torch.empty(32, 32, **meta))
        elif call == "mlp":
            cuda_ffn.mlp_ffn(torch.empty(8, 32, **meta), torch.empty(64, 32, **meta),
                             torch.empty(64, **meta), torch.empty(32, 64, **meta),
                             torch.empty(32, **meta))
        else:
            cuda_fusion_attn.fusion_row_attention(torch.empty(1, 4, 32, **meta),
                                                  torch.empty(1, 12, 64, **meta),
                                                  torch.empty(1, 4, 64, **meta), 1, 32)
