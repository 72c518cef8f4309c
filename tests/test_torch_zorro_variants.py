"""The two other modes of kernel K1 / K1b, through their plain versions on
the CPU, against the JAX package:

  * separate q, k, v (``cuda_attn.zorro_attention_packed``) against
    ``zorro_self_attention_packed`` (the Pallas kernel in interpret mode, its
    custom VJP through ``jax.vjp``): atol 2e-5 forward, 3e-5 gradients;
  * block-sparse (``cuda_zorro_sparse.zorro_sparse_attention_qkv``) against
    ``zorro_sparse_attention_qkv`` on the three packed layouts of
    tests/test_pallas_zorro_sparse.py (flagship 5 tiles, single-type tiles,
    a pure-PAD tail tile), on every row, PAD rows included: atol 3e-5
    forward, 5e-5 gradients; ``tile_active`` and ``zorro_sparse_supported``
    give JAX's answers;
  * float64 ``gradcheck`` of ``ZorroAttentionPacked`` and
    ``ZorroSparseAttentionQKV``, whose CPU path is the plain forward and
    backward the card runs as kernels.

All in f32 (float64 for gradcheck) with seeded numpy inputs; widths are cut
(one or two heads of 32) to keep the interpret-mode kernels quick.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu.ops import pallas_zorro_sparse as jsparse
from incomplete_multimodal_fusion_tpu.ops.pallas_attn import zorro_self_attention_packed
from incomplete_multimodal_fusion_tpu_torch import ops as tops
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_attn, cuda_zorro_sparse
from tests.test_torch_common import to_np

PAD = cuda_attn.PAD_TYPE


def _vjp(fn, primals, cotangent):
    """fn's value and its pullback of ``cotangent``, under one jit."""
    def value_and_pullback(primals, cotangent):
        out, pullback = jax.vjp(fn, *primals)
        return out, pullback(cotangent)

    out, grads = jax.jit(value_and_pullback)(tuple(map(jnp.asarray, primals)), jnp.asarray(cotangent))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _layout(n, blocks):
    """One packed row: per-type blocks in order, then PAD to n."""
    row = [t for t, c in blocks for _ in range(c)]
    return np.asarray(row + [PAD] * (n - len(row)), np.int32)


@pytest.mark.parametrize("heads,dh", [(2, 16), (1, 32)])
def test_packed_reference_matches_pallas(heads, dh):
    """Zorro attention on separate q, k, v with padding and a fusion block,
    forward and (dq, dk, dv)."""
    b, n = 2, 48
    inner = heads * dh
    rng = np.random.default_rng(3)
    types = np.stack([_layout(n, [(0, 12), (1, 10), (2, 8), (3, 12)]),
                      _layout(n, [(1, 20), (2, 4), (3, 16)])])
    q, k, v, do = (rng.standard_normal((b, n, inner)).astype(np.float32) for _ in range(4))
    tq, tk, tv, tt, tdo = map(torch.from_numpy, (q, k, v, types, do))
    out, lse = cuda_attn.zorro_attention_packed(tq, tk, tv, tt, heads, 3, return_lse=True)
    grads = cuda_attn.zorro_attention_packed_backward(tq, tk, tv, tt, out, lse, tdo, heads, 3)
    jt = jnp.asarray(types)
    ref, ref_grads = _vjp(lambda a, b_, c: zorro_self_attention_packed(a, b_, c, jt, heads, 3), [q, k, v], do)
    np.testing.assert_allclose(to_np(out), ref, atol=2e-5)
    for got, want in zip(grads, ref_grads):
        np.testing.assert_allclose(to_np(got), want, atol=3e-5)


# the layouts of tests/test_pallas_zorro_sparse.py:61, :67, :79, one batch
# row each: (tiles, type blocks, fusion type)
SPARSE_LAYOUTS = {
    "flagship": (5, [(0, 192), (1, 192), (3, 256)], 3),
    "single-type tiles": (4, [(0, 128), (1, 128), (2, 128), (3, 128)], 3),
    "pure-PAD tail tile": (6, [(0, 100), (1, 100), (2, 100), (3, 100), (4, 256)], 4),
}


@pytest.mark.parametrize("layout", sorted(SPARSE_LAYOUTS))
def test_sparse_reference_matches_pallas_on_every_row(layout):
    nt, blocks, fusion = SPARSE_LAYOUTS[layout]
    b, n, heads, dh = 1, nt * cuda_zorro_sparse.TILE, 1, 32
    rng = np.random.default_rng(4)
    types = np.tile(_layout(n, blocks), (b, 1))
    qkv = rng.standard_normal((b, n, 3 * heads * dh)).astype(np.float32)
    do = rng.standard_normal((b, n, heads * dh)).astype(np.float32)
    tq, tt = torch.from_numpy(qkv), torch.from_numpy(types)
    out, lse = cuda_zorro_sparse.zorro_sparse_attention_qkv(tq, tt, heads, fusion, return_lse=True)
    dqkv = cuda_zorro_sparse.zorro_sparse_attention_qkv_backward(tq, tt, out, lse, torch.from_numpy(do), heads,
                                                                 fusion)
    jt = jnp.asarray(types)
    ref, (ref_dqkv,) = _vjp(lambda x: jsparse.zorro_sparse_attention_qkv(x, jt, heads, fusion), [qkv], do)
    np.testing.assert_allclose(to_np(out), ref, atol=3e-5)
    np.testing.assert_allclose(to_np(dqkv), ref_dqkv, atol=5e-5)
    # the activity table is the JAX one; with single-type tiles it skips
    act = to_np(cuda_zorro_sparse.tile_active(tt, fusion, nt))
    np.testing.assert_array_equal(act, np.asarray(jsparse.tile_active(jt, fusion, nt)))
    if layout == "single-type tiles":
        assert act.sum() < nt * nt


def test_sparse_valid_rows_equal_the_dense_attention():
    """On valid query rows the skipped tiles hold only masked keys, so the
    sparse plain version equals the dense zorro attention there. PAD rows
    differ where PAD keys lie in tiles their own tile does not see: here
    PAD slots in tile 0 and a pure-PAD tile 2, each seeing only itself."""
    types = torch.tensor([[0] * 100 + [PAD] * 28 + [1] * 128 + [PAD] * 128])
    assert cuda_zorro_sparse.tile_active(types, 3, 3).reshape(3, 3).diagonal().all()
    qkv = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 384, 3 * 32)).astype(np.float32))
    sparse = cuda_zorro_sparse.zorro_sparse_attention_qkv(qkv, types, 1, 3)
    dense = cuda_attn.zorro_attention_qkv(qkv, 1, types, 3)
    valid = types != PAD
    torch.testing.assert_close(sparse[valid], dense[valid], atol=1e-6, rtol=0)
    assert not torch.allclose(sparse[~valid], dense[~valid])


@pytest.mark.parametrize("n", [128, 256, 640, 644, 768, 1024])
def test_sparse_supported_gate_matches_jax(n):
    assert cuda_zorro_sparse.zorro_sparse_supported(n) == jsparse.zorro_sparse_supported(n)


def _rand64(*shape, seed):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed),
                       dtype=torch.float64).requires_grad_()


def test_packed_function_gradcheck():
    types = torch.tensor([[0, 0, 1, 2, 255, 3, 3], [1, 1, 1, 255, 255, 3, 3]])
    q, k, v = (_rand64(2, 7, 2 * 4, seed=s) for s in (40, 41, 42))
    assert torch.autograd.gradcheck(
        lambda a, b, c: cuda_attn.ZorroAttentionPacked.apply(a, b, c, types, 2, 3), (q, k, v))


def test_sparse_function_gradcheck():
    """Two tiles, single-type: the off-diagonal modality tile is skipped,
    and a PAD tail in the second tile."""
    types = torch.tensor([[0] * 128 + [1] * 100 + [255] * 28])
    assert cuda_zorro_sparse.tile_active(types, 3, 2).sum() == 2
    qkv = _rand64(1, 256, 3 * 4, seed=43)
    assert torch.autograd.gradcheck(
        lambda t: cuda_zorro_sparse.ZorroSparseAttentionQKV.apply(t, types, 1, 3), (qkv,), fast_mode=True)


def test_functions_on_cpu_launch_nothing():
    tops.reset_kernel_launches()
    q, k, v = (_rand64(1, 5, 8, seed=s) for s in (44, 45, 46))
    types = torch.tensor([[0, 1, 255, 3, 3]])
    cuda_attn.ZorroAttentionPacked.apply(q, k, v, types, 2, 3).sum().backward()
    assert all(t.grad is not None for t in (q, k, v))
    assert all(count == 0 for count in tops.kernel_launches().values())
