"""The hand-written CUDA kernels, forward and backward, against their plain
PyTorch versions, on the card, in bf16 (the deformable-attention kernel K4
in f32), over the edge cases the model's shapes do not reach: ragged N and M
(not multiples of the tiles), every supported head width, T from 1 to 8
slots, a query row whose first key tiles are all masked, non-square levels,
channel counts that are not 32 and sampling locations past every border.
Also the autograd Functions' launches and the wrappers' refusals. These tests need a CUDA card and skip without one; on a
card run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q

(``--noconftest``: the suite's conftest configures JAX, which the card's
machine need not have; this file imports nothing of JAX.)
"""
import pytest
import torch

from incomplete_multimodal_fusion_tpu_torch import ops
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_attn, cuda_ffn, cuda_fusion_attn, cuda_msda

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


def _rel_all(outs, refs):
    """The largest rel-L2 over the gradients; one that is zero in exact
    arithmetic (dq and dk at N = 1) is measured against a norm of 1e-3."""
    return max(float((o.float() - r.float()).norm()) / max(float(r.float().norm()), 1e-3)
               for o, r in zip(outs, refs))


def _zorro_backward_case(dev, qkv, heads, types):
    out, lse = cuda_attn.zorro_attention_qkv(qkv, heads, types, 3, return_lse=True)
    ref, ref_lse = cuda_attn.zorro_attention_qkv_reference(qkv, heads, types, 3, return_lse=True)
    do = _randn(dev, *out.shape, seed=21)
    dqkv = cuda_attn.zorro_attention_qkv_backward(qkv, types, out, lse, do, heads, 3)
    ref_dqkv = cuda_attn.zorro_attention_qkv_backward_reference(qkv, types, ref, ref_lse, do, heads, 3)
    torch.cuda.synchronize()
    assert torch.isfinite(dqkv).all()
    assert _rel(lse, ref_lse) <= 1e-3
    assert _rel_all(dqkv.chunk(3, dim=-1), ref_dqkv.chunk(3, dim=-1)) <= REL_L2


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("counts,pad,fusion", [((70, 0, 50), 9, 30), ((0, 3, 200), 60, 17)])
def test_zorro_backward_kernel_matches_plain(dev, dh, counts, pad, fusion):
    types = _types(dev, counts, pad, fusion).expand(2, -1).contiguous()
    _zorro_backward_case(dev, _randn(dev, 2, types.shape[1], 3 * 2 * dh), 2, types)


@pytest.mark.parametrize("n,heads,dh", [(1, 1, 32), (65, 2, 64), (300, 1, 128), (256, 8, 32)])
def test_unmasked_backward_kernel_matches_plain(dev, n, heads, dh):
    _zorro_backward_case(dev, _randn(dev, 3, n, 3 * heads * dh, seed=1), heads, None)


@pytest.mark.parametrize("m", [1, 31, 33, 1000])
def test_geglu_backward_kernel_matches_plain(dev, m):
    d, inner = 64, 96
    x, dy = _randn(dev, m, d, seed=2), _randn(dev, m, d, seed=22)
    gamma = (1 + 0.1 * _randn(dev, d, seed=3).float()).to(torch.bfloat16)
    w_in, w_out = _randn(dev, 2 * inner, d, scale=d ** -0.5, seed=4), _randn(
        dev, d, inner, scale=inner ** -0.5, seed=5)
    out = cuda_ffn.geglu_ffn_backward(x, gamma, w_in, w_out, dy)
    ref = cuda_ffn.geglu_ffn_backward_reference(x, gamma, w_in, w_out, dy)
    torch.cuda.synchronize()
    assert [o.shape for o in out] == [r.shape for r in ref]
    assert _rel_all(out, ref) <= REL_L2


@pytest.mark.parametrize("m,d,hidden,out_dim", [(1, 32, 128, 32), (45, 64, 256, 48), (300, 256, 1024, 256)])
def test_mlp_backward_kernel_matches_plain(dev, m, d, hidden, out_dim):
    x, dy = _randn(dev, m, d, seed=6), _randn(dev, m, out_dim, seed=23)
    w1, b1 = _randn(dev, hidden, d, scale=d ** -0.5, seed=7), _randn(dev, hidden, scale=0.1, seed=8)
    w2, b2 = _randn(dev, out_dim, hidden, scale=hidden ** -0.5, seed=9), _randn(
        dev, out_dim, scale=0.1, seed=10)
    out = cuda_ffn.mlp_ffn_backward(x, w1, b1, w2, b2, dy)
    ref = cuda_ffn.mlp_ffn_backward_reference(x, w1, b1, w2, b2, dy)
    torch.cuda.synchronize()
    assert [o.shape for o in out] == [r.shape for r in ref]
    assert _rel_all(out, ref) <= REL_L2


@pytest.mark.parametrize("t_mod", [1, 3, 8])
@pytest.mark.parametrize("heads,dh", [(3, 64), (1, 32), (2, 128)])
def test_fusion_row_backward_kernel_matches_plain(dev, t_mod, heads, dh):
    b, f, inner = 2, 20, heads * dh
    q, kvg, kvf = _randn(dev, b, f, inner, seed=11), _randn(dev, b, t_mod * f, 2 * inner, seed=12), \
        _randn(dev, b, f, 2 * inner, seed=13)
    do = _randn(dev, b, f, inner, seed=24)
    out = cuda_fusion_attn.fusion_row_attention_backward(q, kvg, kvf, do, heads, dh)
    ref = cuda_fusion_attn.fusion_row_attention_backward_reference(q, kvg, kvf, do, heads, dh)
    torch.cuda.synchronize()
    assert _rel_all(out, ref) <= REL_L2


def test_functions_launch_forward_and_backward_kernels(dev):
    """Each autograd Function launches its forward kernel once and, in the
    backward, its backward kernel once."""
    ops.reset_kernel_launches()
    qkv = _randn(dev, 2, 70, 3 * 64).requires_grad_()
    cuda_attn.ZorroAttentionQKV.apply(qkv, 1).float().sum().backward()
    x = _randn(dev, 40, 64).requires_grad_()
    w = [_randn(dev, *s, seed=i).requires_grad_() for i, s in enumerate([(64,), (192, 64), (64, 96)])]
    cuda_ffn.GegluFFN.apply(x, *w).float().sum().backward()
    q, kvg, kvf = (_randn(dev, *s, seed=i).requires_grad_()
                   for i, s in enumerate([(1, 8, 64), (1, 24, 128), (1, 8, 128)]))
    cuda_fusion_attn.FusionRowAttention.apply(q, kvg, kvf, 1, 64).float().sum().backward()
    counts = ops.kernel_launches()
    for name in ("zorro_attention_qkv/none", "zorro_attention_qkv/none_backward", "fused_ffn/geglu",
                 "fused_ffn/geglu_backward", "fusion_row_attention/fusion_row",
                 "fusion_row_attention/fusion_row_backward"):
        assert counts[name] == 1, (name, counts)
    assert sum(counts.values()) == 6
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (qkv, x, *w, q, kvg, kvf))


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


MSDA_REL_L2 = 1e-4  # f32 on both sides: only the order of the sums differs
FULL_LEVELS = ((8, 8), (16, 16), (32, 32))  # the pixel decoder's levels at 256^2


def _msda_inputs(dev, b, lq, m, d, p, shapes, lo=-0.1, hi=1.1, seed=30):
    g = torch.Generator(device=dev).manual_seed(seed)
    s = sum(h * w for h, w in shapes)
    value = torch.randn(b, s, m, d, device=dev, generator=g)
    locs = lo + (hi - lo) * torch.rand(b, lq, m, len(shapes), p, 2, device=dev, generator=g)
    aw = torch.softmax(torch.randn(b, lq, m, len(shapes) * p, device=dev, generator=g), dim=-1)
    return value, locs, aw.reshape(b, lq, m, len(shapes), p)


@pytest.mark.parametrize("b,lq,m,d,p,shapes", [
    (2, 1344, 8, 32, 4, FULL_LEVELS),  # full width
    (1, 37, 2, 5, 3, ((3, 5), (6, 4), (7, 9))),  # narrow D, non-square levels, odd Lq
    (3, 101, 4, 40, 2, ((5, 3), (9, 11))),  # D over one warp's 32 lanes
    (1, 17, 1, 64, 1, ((1, 1), (2, 7), (12, 1), (4, 4))),
])
def test_msda_kernel_matches_plain(dev, b, lq, m, d, p, shapes):
    value, locs, aw = _msda_inputs(dev, b, lq, m, d, p, shapes)
    out = cuda_msda.ms_deform_attn(value, shapes, locs, aw)
    ref = cuda_msda.ms_deform_attn_core(value, shapes, locs, aw)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (b, lq, m * d)
    assert _rel(out, ref) <= MSDA_REL_L2


def test_msda_kernel_locations_past_the_borders(dev):
    """Far outside every level gives exactly 0; on and half a pixel past
    the borders the kernel matches the plain zero-padded sample."""
    value, locs, aw = _msda_inputs(dev, 2, 50, 4, 32, 4, FULL_LEVELS, seed=31)
    far = cuda_msda.ms_deform_attn(value, FULL_LEVELS, torch.full_like(locs, 2.0), aw)
    assert float(far.abs().max()) == 0.0
    g = torch.Generator(device=dev).manual_seed(32)
    edges = torch.tensor([-0.02, -1e-3, 0.0, 1.0, 1.0 + 1e-3, 1.02], device=dev)
    locs = edges[torch.randint(0, 6, locs.shape, device=dev, generator=g)]
    out = cuda_msda.ms_deform_attn(value, FULL_LEVELS, locs, aw)
    ref = cuda_msda.ms_deform_attn_core(value, FULL_LEVELS, locs, aw)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= MSDA_REL_L2


def test_msda_function_counts_its_launch_and_has_no_backward(dev):
    ops.reset_kernel_launches()
    value, locs, aw = _msda_inputs(dev, 1, 20, 2, 32, 2, ((4, 4), (2, 2)))
    cuda_msda.ms_deform_attn_core(value, ((4, 4), (2, 2)), locs, aw)
    value.requires_grad_()
    out = cuda_msda.MSDeformAttnFunction.apply(value, ((4, 4), (2, 2)), locs, aw)
    assert ops.kernel_launches()["ms_deform_attn/forward"] == 1
    assert sum(ops.kernel_launches().values()) == 1
    with pytest.raises(NotImplementedError, match="downstream training"):
        out.sum().backward()


def test_msda_wrapper_refuses_what_the_kernel_does_not_take(dev):
    shapes = ((4, 4), (2, 2))
    value, locs, aw = _msda_inputs(dev, 1, 20, 2, 32, 2, shapes)
    with pytest.raises(ValueError, match="float32"):
        cuda_msda.ms_deform_attn(value.to(torch.bfloat16), shapes, locs, aw)
    with pytest.raises(ValueError, match="float32"):
        cuda_msda.ms_deform_attn(value, shapes, locs.cpu(), aw)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_msda.ms_deform_attn(value, shapes, torch.cat([locs, locs], dim=-1)[..., ::2], aw)
    with pytest.raises(ValueError, match="spatial shapes"):
        cuda_msda.ms_deform_attn(value, ((4, 4), (3, 2)), locs, aw)
    with pytest.raises(ValueError, match="bad shapes"):
        cuda_msda.ms_deform_attn(value, shapes, locs, aw[..., :1].contiguous())
