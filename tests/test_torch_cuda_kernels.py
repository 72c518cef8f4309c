"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card, in bf16, over the edge cases the serving shapes do not reach: ragged
N and M (not multiples of the tiles), every supported head width, T from 1
to 8 slots, a query row whose first key tiles are all masked. Also the
wrappers' refusals. These tests need a CUDA card and skip without one; on a
card run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q

(``--noconftest``: the suite's conftest configures JAX, which the card's
machine need not have; this file imports nothing of JAX.)
"""
import pytest
import torch

from incomplete_multimodal_fusion_tpu_torch import ops
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_attn, cuda_ffn, cuda_fusion_attn

pytestmark = pytest.mark.cuda

REL_L2 = 2e-2  # bf16 kernel vs bf16 plain version on the same inputs


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def _randn(dev, *shape, scale=1.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(*shape, device=dev, generator=g) * scale).to(torch.bfloat16)


def _types(dev, counts, pad, fusion):
    row = [t for t, c in enumerate(counts) for _ in range(c)] + [255] * pad + [3] * fusion
    return torch.tensor([row], dtype=torch.int32, device=dev)


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("counts,pad,fusion", [((70, 0, 50), 9, 30), ((0, 3, 200), 60, 17),
                                               ((1, 1, 1), 0, 1)])
def test_zorro_kernel_matches_plain(dev, dh, counts, pad, fusion):
    types = _types(dev, counts, pad, fusion).expand(2, -1).contiguous()
    heads = 2
    qkv = _randn(dev, 2, types.shape[1], 3 * heads * dh)
    out = cuda_attn.zorro_attention_qkv(qkv, heads, types, 3)
    ref = cuda_attn.zorro_attention_qkv_reference(qkv, heads, types, 3)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert _rel(out, ref) <= REL_L2


@pytest.mark.parametrize("n,heads,dh", [(1, 1, 32), (63, 8, 32), (65, 2, 64), (300, 1, 128)])
def test_unmasked_kernel_matches_plain(dev, n, heads, dh):
    qkv = _randn(dev, 3, n, 3 * heads * dh, seed=1)
    out = cuda_attn.zorro_attention_qkv(qkv, heads)
    ref = cuda_attn.zorro_attention_qkv_reference(qkv, heads)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= REL_L2


@pytest.mark.parametrize("m", [1, 31, 33, 1000])
def test_geglu_kernel_matches_plain(dev, m):
    d, inner = 64, 96
    x = _randn(dev, m, d, seed=2)
    gamma = (1 + 0.1 * _randn(dev, d, seed=3).float()).to(torch.bfloat16)
    w_in, w_out = _randn(dev, 2 * inner, d, scale=d ** -0.5, seed=4), _randn(
        dev, d, inner, scale=inner ** -0.5, seed=5)
    out = cuda_ffn.geglu_ffn(x, gamma, w_in, w_out)
    ref = cuda_ffn.geglu_ffn_reference(x, gamma, w_in, w_out)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= REL_L2


@pytest.mark.parametrize("m,d,hidden,out_dim", [(1, 32, 128, 32), (45, 64, 256, 48), (300, 256, 1024, 256)])
def test_mlp_kernel_matches_plain(dev, m, d, hidden, out_dim):
    x = _randn(dev, m, d, seed=6)
    w1, b1 = _randn(dev, hidden, d, scale=d ** -0.5, seed=7), _randn(dev, hidden, scale=0.1, seed=8)
    w2, b2 = _randn(dev, out_dim, hidden, scale=hidden ** -0.5, seed=9), _randn(
        dev, out_dim, scale=0.1, seed=10)
    out = cuda_ffn.mlp_ffn(x, w1, b1, w2, b2)
    ref = cuda_ffn.mlp_ffn_reference(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= REL_L2


@pytest.mark.parametrize("t_mod", [1, 3, 8])
@pytest.mark.parametrize("heads,dh", [(3, 64), (1, 32), (2, 128)])
def test_fusion_row_kernel_matches_plain(dev, t_mod, heads, dh):
    b, f, inner = 2, 20, heads * dh
    q, kvg, kvf = _randn(dev, b, f, inner, seed=11), _randn(dev, b, t_mod * f, 2 * inner, seed=12), \
        _randn(dev, b, f, 2 * inner, seed=13)
    out = cuda_fusion_attn.fusion_row_attention(q, kvg, kvf, heads, dh)
    ref = cuda_fusion_attn.fusion_row_attention_reference(q, kvg, kvf, heads, dh)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= REL_L2


def test_each_launch_is_counted_once(dev):
    ops.reset_kernel_launches()
    qkv = _randn(dev, 1, 64, 3 * 64)
    cuda_attn.zorro_attention_qkv(qkv, 1)
    cuda_attn.zorro_attention_qkv_reference(qkv, 1)
    counts = ops.kernel_launches()
    assert counts["zorro_attention_qkv/none"] == 1
    assert sum(counts.values()) == 1


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    qkv = torch.randn(1, 16, 3 * 64, device=dev)
    with pytest.raises(TypeError, match="bfloat16"):
        cuda_attn.zorro_attention_qkv(qkv, 1)
    with pytest.raises(ValueError, match="head dim"):
        cuda_attn.zorro_attention_qkv(qkv.to(torch.bfloat16), 4)  # dh 16
    with pytest.raises(ValueError, match="contiguous"):
        cuda_attn.zorro_attention_qkv(qkv.to(torch.bfloat16)[:, ::2], 1)
    x = _randn(dev, 8, 30)  # d not a multiple of 16
    with pytest.raises(ValueError):
        cuda_ffn.mlp_ffn(x, _randn(dev, 32, 30), _randn(dev, 32), _randn(dev, 30, 32), _randn(dev, 30))
    with pytest.raises(ValueError, match="bad shapes"):
        cuda_fusion_attn.fusion_row_attention(_randn(dev, 1, 4, 64), _randn(dev, 1, 12, 64),
                                              _randn(dev, 1, 4, 128), 1, 64)
