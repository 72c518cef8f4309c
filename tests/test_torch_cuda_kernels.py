"""The hand-written CUDA kernels, forward and backward, against their plain
PyTorch versions, on the card, in bf16 (the deformable-attention kernel K4
in f32), over the edge cases the model's shapes do not reach: ragged N and M
(not multiples of the tiles), every supported head width, T from 1 to 8
slots, query rows whose first key tiles are all masked, K1 / K1b bitwise
the same from run to run, non-square levels,
channel counts that are not 32 and sampling locations past every border;
K1's separate-q/k/v and tile-skip modes (a pure-PAD tail tile; with every
tile active, bitwise the slab kernel) and the fused
attention half-block K6 / K6b at ragged N, every head width and B = 1 and 60
(the weight-gradient sums). Also the autograd Functions' launches and the
wrappers' refusals. These tests need a CUDA card and skip without one; on a
card run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q

(``--noconftest``: the suite's conftest configures JAX, which the card's
machine need not have; this file imports nothing of JAX.)
"""
import pytest
import torch

from incomplete_multimodal_fusion_tpu_torch import ops
from incomplete_multimodal_fusion_tpu_torch.ops import (cuda_attn, cuda_block_attn, cuda_ffn, cuda_fusion_attn,
                                                        cuda_msda, cuda_points, cuda_zorro_sparse)

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


@pytest.mark.parametrize("dh", [32, 64, 128])
def test_rows_whose_first_key_tiles_are_all_masked(dev, dh):
    """Rows 150-199 (type 1) see only masked keys in key tiles 0 and 1: the
    kernels score in log2 units, so the mask must be the finite NEG_INF
    applied after the scale (NEG_INF * log2(e) would overflow to -inf and
    -inf - (-inf) is NaN). N = 200 is ragged too."""
    types = _types(dev, (150, 50), 0, 0).expand(2, -1).contiguous()
    qkv = _randn(dev, 2, types.shape[1], 3 * 2 * dh, seed=2)
    out = cuda_attn.zorro_attention_qkv(qkv, 2, types, 3)
    ref = cuda_attn.zorro_attention_qkv_reference(qkv, 2, types, 3)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert _rel(out[:, 150:], ref[:, 150:]) <= REL_L2
    _zorro_backward_case(dev, qkv, 2, types)


@pytest.mark.parametrize("n,dh", [(65, 32), (190, 32), (100, 64), (255, 64)])
def test_ragged_n_forward_and_backward(dev, n, dh):
    """N not a multiple of the 64-row tiles: the last tile's rows past N are
    zero-filled, never written, and add nothing."""
    counts = (n // 3, n // 4, 0)
    fusion = n // 5
    types = _types(dev, counts, n - sum(counts) - fusion, fusion).expand(3, -1).contiguous()
    qkv = _randn(dev, 3, n, 3 * 3 * dh, seed=3)
    out = cuda_attn.zorro_attention_qkv(qkv, 3, types, 3)
    ref = cuda_attn.zorro_attention_qkv_reference(qkv, 3, types, 3)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= REL_L2
    _zorro_backward_case(dev, qkv, 3, types)


def test_backward_is_bitwise_the_same_from_run_to_run(dev):
    """No atomics: two runs of K1 and K1b on the same inputs agree bit for
    bit."""
    types = _types(dev, (300, 200, 184), 40, 256).expand(4, -1).contiguous()
    qkv = _randn(dev, 4, types.shape[1], 3 * 192, seed=4)
    do = _randn(dev, 4, types.shape[1], 192, seed=5)
    runs = []
    for _ in range(2):
        out, lse = cuda_attn.zorro_attention_qkv(qkv, 3, types, 3, return_lse=True)
        runs.append((out, lse, cuda_attn.zorro_attention_qkv_backward(qkv, types, out, lse, do, 3, 3)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


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


# K2b's widths: (d, I) for GEGLU, (d, H, out) for MLP. "model": the port's
# model paths (encoder and fusion blocks; decoder); "base": the `base`
# config's d = 768, past the row pass's d <= 256 (the wide path).
_FFN_WIDTHS = {"model": {"geglu": (192, 512), "mlp": (256, 1024, 256)},
               "base": {"geglu": (768, 2048), "mlp": (768, 3072, 768)}}


def _ffn_case(dev, mode, m, seed=80, widths="model"):
    if mode == "geglu":
        d, inner = _FFN_WIDTHS[widths][mode] if isinstance(widths, str) else widths
        w = ((1 + 0.1 * _randn(dev, d, seed=seed).float()).to(torch.bfloat16),
             _randn(dev, 2 * inner, d, scale=d ** -0.5, seed=seed + 1),
             _randn(dev, d, inner, scale=inner ** -0.5, seed=seed + 2))
        return _randn(dev, m, d, seed=seed + 3), w, _randn(dev, m, d, seed=seed + 4)
    d, hidden, out = _FFN_WIDTHS[widths][mode] if isinstance(widths, str) else widths
    w = (_randn(dev, hidden, d, scale=d ** -0.5, seed=seed), _randn(dev, hidden, scale=0.1, seed=seed + 1),
         _randn(dev, out, hidden, scale=hidden ** -0.5, seed=seed + 2), _randn(dev, out, scale=0.1, seed=seed + 3))
    return _randn(dev, m, d, seed=seed + 4), w, _randn(dev, m, out, seed=seed + 5)


_FFN_BACKWARD = {"geglu": (cuda_ffn.geglu_ffn_backward, cuda_ffn.geglu_ffn_backward_reference),
                 "mlp": (cuda_ffn.mlp_ffn_backward, cuda_ffn.mlp_ffn_backward_reference)}


def _check_ffn_backward(dev, mode, m, widths):
    x, w, dy = _ffn_case(dev, mode, m, widths=widths)
    kernel, plain = _FFN_BACKWARD[mode]
    out = kernel(x, *w, dy)
    ref = plain(x, *w, dy)
    torch.cuda.synchronize()
    assert [o.shape for o in out] == [r.shape for r in ref]
    assert all(torch.isfinite(o).all() for o in out)
    for o, r in zip(out, ref):
        assert _rel_all([o], [r]) <= REL_L2


@pytest.mark.parametrize("mode", ["geglu", "mlp"])
@pytest.mark.parametrize("m", [1, 63, 64, 65, 38400])
def test_ffn_backward_at_the_model_widths(dev, mode, m):
    """K2b at the model's widths, M below, at and past the 64-row warpgroup
    tile and the 128-row block (a partial last tile), and the pretraining
    shape (several weight-gradient row ranges)."""
    _check_ffn_backward(dev, mode, m, "model")


@pytest.mark.parametrize("mode,widths", [
    ("geglu", "base"), ("mlp", "base"),
    ("geglu", (320, 512)),  # just past the row pass
    ("mlp", (256, 1024, 320)),  # only the output width past it
    ("mlp", (320, 512, 256)),  # only the input width past it
    ("geglu", (1040, 256)),  # a partial last window and column tile
])
@pytest.mark.parametrize("m", [1, 65, 4100])
def test_ffn_backward_past_the_row_pass_widths(dev, mode, widths, m):
    """K2b's wide path, for d or the MLP's output width past 256 (the `base`
    and `large` configs): the same gradients as the plain version, at M
    below, past and well over a 128-row block."""
    _check_ffn_backward(dev, mode, m, widths)


@pytest.mark.parametrize("mode,widths", [("geglu", "model"), ("mlp", "model"), ("geglu", "base"), ("mlp", "base")])
def test_ffn_backward_is_bitwise_the_same_from_run_to_run(dev, mode, widths):
    """No atomics: every partial is summed in a fixed order."""
    x, w, dy = _ffn_case(dev, mode, 15360 if widths == "model" else 4100, seed=90, widths=widths)
    kernel, _ = _FFN_BACKWARD[mode]
    first = kernel(x, *w, dy)
    second = kernel(x, *w, dy)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


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
    """The Function launches K4 once forward and, since the backward kernel
    K4b landed, K4b once backward (the name predates K4b)."""
    ops.reset_kernel_launches()
    value, locs, aw = _msda_inputs(dev, 1, 20, 2, 32, 2, ((4, 4), (2, 2)))
    cuda_msda.ms_deform_attn_core(value, ((4, 4), (2, 2)), locs, aw)
    value.requires_grad_()
    out = cuda_msda.MSDeformAttnFunction.apply(value, ((4, 4), (2, 2)), locs, aw)
    assert ops.kernel_launches()["ms_deform_attn/forward"] == 1
    assert sum(ops.kernel_launches().values()) == 1
    out.sum().backward()
    assert ops.kernel_launches()["ms_deform_attn/backward"] == 1
    assert sum(ops.kernel_launches().values()) == 2
    assert torch.isfinite(value.grad).all()


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


def _off_integer(locs, shapes):
    """Locations moved off the pixel centres, where the bilinear derivative
    is one-sided (as tests/test_pallas_msda.py:62-64 keeps them)."""
    for lid, (h, w) in enumerate(shapes):
        for axis, size in ((0, w), (1, h)):
            px = locs[:, :, :, lid, :, axis] * size - 0.5
            frac = px - torch.floor(px)
            near = (frac < 0.02) | (frac > 0.98)
            locs[:, :, :, lid, :, axis] = torch.where(near, locs[:, :, :, lid, :, axis] + 0.05 / size,
                                                      locs[:, :, :, lid, :, axis])
    return locs


@pytest.mark.parametrize("b,lq,m,d,p,shapes", [
    (2, 1344, 8, 32, 4, FULL_LEVELS),  # full width
    (1, 37, 2, 5, 3, ((3, 5), (6, 4), (7, 9))),  # narrow D, non-square levels, odd Lq
    (3, 101, 4, 40, 2, ((5, 3), (9, 11))),  # D over one warp's 32 lanes
    (1, 17, 1, 64, 1, ((1, 1), (2, 7), (12, 1), (4, 4))),
])
def test_msda_backward_kernel_matches_plain(dev, b, lq, m, d, p, shapes):
    value, locs, aw = _msda_inputs(dev, b, lq, m, d, p, shapes, seed=33)
    locs = _off_integer(locs, shapes)
    g = torch.Generator(device=dev).manual_seed(34)
    dout = torch.randn(b, lq, m * d, device=dev, generator=g)
    out = cuda_msda.ms_deform_attn_backward(value, shapes, locs, aw, dout)
    ref = cuda_msda.ms_deform_attn_backward_reference(value, shapes, locs, aw, dout)
    torch.cuda.synchronize()
    for o, r, t in zip(out, ref, (value, locs, aw)):
        assert o.shape == r.shape == t.shape
        assert torch.isfinite(o).all()
    assert _rel_all(out, ref) <= MSDA_REL_L2


def test_msda_backward_far_outside_is_zero(dev):
    value, locs, aw = _msda_inputs(dev, 2, 50, 4, 32, 4, FULL_LEVELS, seed=35)
    dout = torch.randn(2, 50, 4 * 32, device=dev)
    dv, dl, da = cuda_msda.ms_deform_attn_backward(value, FULL_LEVELS, torch.full_like(locs, 2.0), aw,
                                                   dout)
    assert float(dv.abs().max()) == float(dl.abs().max()) == float(da.abs().max()) == 0.0


POINTS_REL_L2 = 1e-5  # f32 both sides: the same taps, sums in another order


def _points_inputs(dev, n, h, w, p, group=1, lo=-0.2, hi=1.2, seed=40):
    g = torch.Generator(device=dev).manual_seed(seed)
    masks = torch.randn(n, h, w, device=dev, generator=g)
    coords = lo + (hi - lo) * torch.rand(n // group, p, 2, device=dev, generator=g)
    return masks, coords


@pytest.mark.parametrize("n,h,w,p,group", [
    (240, 64, 64, 12544, 1),  # the loss's predictions
    (300, 64, 64, 1000, 100),  # the matcher's queries, points shared per image
    (24, 256, 256, 2000, 8),  # the matcher's targets
    (5, 7, 9, 33, 1),  # non-square, ragged P
])
def test_point_sample_kernel_matches_plain(dev, n, h, w, p, group):
    masks, coords = _points_inputs(dev, n, h, w, p, group)
    out = cuda_points.point_sample(masks, coords, group)
    ref = cuda_points.point_sample_reference(masks, coords, group)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (n, p)
    assert _rel(out, ref) <= POINTS_REL_L2


@pytest.mark.parametrize("n,h,w,p,group,coords_grad", [
    (240, 64, 64, 12544, 1, False),  # the loss path: shared-memory accumulation
    (12, 64, 64, 500, 4, True),  # shared coords, their gradient summed per group
    (6, 256, 256, 3000, 1, True),  # 256 KB masks: the global-atomics path
    (5, 7, 9, 33, 1, True),
])
def test_point_sample_backward_kernel_matches_plain(dev, n, h, w, p, group, coords_grad):
    masks, coords = _points_inputs(dev, n, h, w, p, group, seed=41)
    ds = torch.randn(n, p, device=dev)
    out = cuda_points.point_sample_backward(masks, coords, ds, group, coords_grad)
    ref = cuda_points.point_sample_backward_reference(masks, coords, ds, group, coords_grad)
    torch.cuda.synchronize()
    assert out[0].shape == masks.shape
    assert _rel(out[0], ref[0]) <= POINTS_REL_L2
    if coords_grad:
        assert out[1].shape == coords.shape
        assert _rel(out[1], ref[1]) <= 1e-4  # one-sided derivatives at pixel edges are rare
    else:
        assert out[1] is None and ref[1] is None


@pytest.mark.parametrize("n,h,w,p,group", [
    (800, 64, 64, 3001, 100),  # the matcher's queries: 8 coords rows, a ragged last chunk
    (3000, 64, 64, 12544, 100),  # the matcher's queries at full size
    (240, 256, 256, 12544, 8),  # the matcher's targets: 30 rows of 8 masks, read through L1 / L2
    (48, 256, 256, 4097, 8),
    (6, 128, 128, 2049, 3),  # 64 KB masks: staged two at a time
    (4, 240, 200, 5000, 2),  # 188 KB: staged one at a time
    (5, 96, 160, 777, 5),  # non-square, staged two at a time
    (3, 131, 101, 999, 3),  # 53 KB, a size that is no multiple of 4 floats (4-byte copies)
    (4, 244, 240, 3000, 2),  # 229 KB, past a block's shared memory: read through L1 / L2
])
def test_point_sample_kernel_groups_and_mask_sizes(dev, n, h, w, p, group):
    """The taps computed once per point serve every mask of the group, at
    every mask size and point count."""
    masks, coords = _points_inputs(dev, n, h, w, p, group, seed=43)
    out = cuda_points.point_sample(masks, coords, group)
    ref = cuda_points.point_sample_reference(masks, coords, group)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (n, p)
    assert _rel(out, ref) <= POINTS_REL_L2


def _edge_coords(dev, h, w, rows, extra_rand=500, seed=44):
    """Points on pixel centres and edges and between them around the rows
    127 / 128 and the middle column, on and past every border, then random
    ones."""
    ys = [(127.5 + f) / h for f in (-1.0, -0.5, -0.25, 0.0, 0.25, 0.5, 0.75, 1.0, 1.5)]
    ys += [0.0, 0.5 / h, 1.0 - 0.5 / h, 1.0, -0.25 / h, -1.0 / h, 1.0 + 0.25 / h, 1.0 + 1.0 / h, -0.5, 1.5]
    xs = [0.0, 0.5 / w, 0.5, (w / 2 + 0.5) / w, 1.0 - 0.5 / w, 1.0, -0.25 / w, -1.0 / w, 1.0 + 0.25 / w,
          1.0 + 1.0 / w, -0.5, 1.5]
    grid = torch.tensor([(x, y) for y in ys for x in xs], dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    rand = -0.1 + 1.2 * torch.rand(extra_rand, 2, device=dev, generator=g)
    return torch.cat([grid, rand])[None].expand(rows, -1, -1).contiguous()


@pytest.mark.parametrize("n,h,w,group", [(16, 256, 256, 8), (3, 256, 256, 1), (6, 64, 64, 3)])
def test_point_sample_kernel_on_the_middle_rows_and_past_the_borders(dev, n, h, w, group):
    """At 256^2 the points on and across rows 127 / 128 and the columns
    either side of the middle, on pixel centres and edges, and past every
    border: the same four taps as the plain version."""
    coords = _edge_coords(dev, h, w, n // group)
    masks = torch.randn(n, h, w, device=dev, generator=torch.Generator(device=dev).manual_seed(45))
    out = cuda_points.point_sample(masks, coords, group)
    ref = cuda_points.point_sample_reference(masks, coords, group)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= POINTS_REL_L2
    far = (coords[..., 0] <= -1.0 / w) | (coords[..., 0] >= 1.0 + 1.0 / w) | \
        (coords[..., 1] <= -1.0 / h) | (coords[..., 1] >= 1.0 + 1.0 / h)
    assert float(out[:, far[0]].abs().max()) == 0.0  # no tap inside: weight 0, nothing read


@pytest.mark.parametrize("h,w", [(64, 64), (256, 256)])
def test_point_sample_kernels_share_the_taps_at_pixel_edges(dev, h, w):
    """K5 and K5b take one taps_of: at pixel centres and edges, where the
    derivative in the coordinates is one-sided, K5b's dcoords is the plain
    version's, and K5's samples are the plain ones."""
    group = 2
    coords = _edge_coords(dev, h, w, 2, extra_rand=0)
    masks = torch.randn(2 * group, h, w, device=dev, generator=torch.Generator(device=dev).manual_seed(46))
    ds = torch.randn(2 * group, coords.shape[1], device=dev, generator=torch.Generator(device=dev).manual_seed(47))
    out = cuda_points.point_sample(masks, coords, group)
    dm, dc = cuda_points.point_sample_backward(masks, coords, ds, group, True)
    ref = cuda_points.point_sample_reference(masks, coords, group)
    ref_dm, ref_dc = cuda_points.point_sample_backward_reference(masks, coords, ds, group, True)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= POINTS_REL_L2
    assert _rel(dm, ref_dm) <= POINTS_REL_L2
    assert _rel(dc, ref_dc) <= POINTS_REL_L2


def test_point_sample_kernel_on_masks_that_start_off_16_bytes(dev):
    """A contiguous view 4 bytes into its storage: the staged path takes
    4-byte copies rather than fault on 16-byte ones."""
    n, h, w, p, group = 6, 64, 64, 3001, 3
    _, coords = _points_inputs(dev, n, h, w, p, group, seed=48)
    flat = torch.randn(n * h * w + 1, device=dev, generator=torch.Generator(device=dev).manual_seed(49))
    masks = flat[1:].view(n, h, w)
    assert masks.is_contiguous() and masks.data_ptr() % 16 == 4
    out = cuda_points.point_sample(masks, coords, group)
    ref = cuda_points.point_sample_reference(masks, coords, group)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= POINTS_REL_L2


def test_point_sample_function_launches_and_gradients(dev):
    ops.reset_kernel_launches()
    masks, coords = _points_inputs(dev, 8, 16, 16, 100, group=2, seed=42)
    masks.requires_grad_()
    cuda_points.PointSampleFunction.apply(masks, coords, 2).square().sum().backward()
    counts = ops.kernel_launches()
    assert counts["point_sample/forward"] == counts["point_sample/backward"] == 1
    assert sum(counts.values()) == 2
    m2 = masks.detach().clone().requires_grad_()
    cuda_points.point_sample_reference(m2, coords, 2).square().sum().backward()
    assert _rel(masks.grad, m2.grad) <= POINTS_REL_L2


def test_point_sample_wrapper_refuses_what_the_kernel_does_not_take(dev):
    masks, coords = _points_inputs(dev, 4, 8, 8, 10)
    with pytest.raises(ValueError, match="float32"):
        cuda_points.point_sample(masks.double(), coords)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_points.point_sample(masks.transpose(1, 2), coords)
    with pytest.raises(ValueError, match="bad shapes"):
        cuda_points.point_sample(masks, coords, group=3)


# ---------------------------------------------------------------------------
# K1's separate-q/k/v and tile-skip modes, K6 / K6b
# ---------------------------------------------------------------------------

def _attention_backward(out, lse, seed=50):
    return _randn(out.device, *out.shape, seed=seed)


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("counts,pad,fusion", [((70, 0, 50), 9, 30), ((1, 1, 1), 0, 1)])
def test_packed_mode_matches_plain_and_the_slab_kernel(dev, dh, counts, pad, fusion):
    """Separate q, k, v: within REL_L2 of the plain version, forward and
    backward, and bitwise the slab kernel's result on the same values."""
    types = _types(dev, counts, pad, fusion).expand(2, -1).contiguous()
    heads = 2
    qkv = _randn(dev, 2, types.shape[1], 3 * heads * dh, seed=51)
    q, k, v = (t.contiguous() for t in qkv.chunk(3, dim=-1))
    out, lse = cuda_attn.zorro_attention_packed(q, k, v, types, heads, 3, return_lse=True)
    ref, ref_lse = cuda_attn.zorro_attention_packed_reference(q, k, v, types, heads, 3, return_lse=True)
    do = _attention_backward(out, lse)
    grads = cuda_attn.zorro_attention_packed_backward(q, k, v, types, out, lse, do, heads, 3)
    ref_grads = cuda_attn.zorro_attention_packed_backward_reference(q, k, v, types, ref, ref_lse, do, heads, 3)
    slab_out, slab_lse = cuda_attn.zorro_attention_qkv(qkv, heads, types, 3, return_lse=True)
    slab_grads = cuda_attn.zorro_attention_qkv_backward(qkv, types, slab_out, slab_lse, do, heads, 3)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= REL_L2
    assert _rel_all(grads, ref_grads) <= REL_L2
    assert torch.equal(out, slab_out) and torch.equal(lse, slab_lse)
    assert all(torch.equal(g, s) for g, s in zip(grads, slab_grads.chunk(3, dim=-1)))


SPARSE_ROWS = {  # (type blocks, tiles): N = 128 x tiles, PAD to the end
    "flagship": ([(0, 192), (1, 192), (3, 256)], 5),
    "single-type tiles": ([(0, 128), (1, 128), (2, 128), (3, 128)], 4),
    "pure-PAD tail tile": ([(0, 100), (1, 100), (2, 100), (3, 100)], 6),
}


def _sparse_types(dev, layout, b):
    blocks, nt = SPARSE_ROWS[layout]
    row = [t for t, c in blocks for _ in range(c)]
    row += [255] * (nt * 128 - len(row))
    return torch.tensor([row] * b, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("layout", sorted(SPARSE_ROWS))
def test_sparse_mode_matches_plain_and_dense(dev, dh, layout):
    """Tile skipping: within REL_L2 of the plain version (allowed & active)
    on every row, forward and backward, and of dense K1 / K1b on the valid
    rows."""
    types = _sparse_types(dev, layout, 2)
    heads = 2
    qkv = _randn(dev, 2, types.shape[1], 3 * heads * dh, seed=52)
    out, lse = cuda_zorro_sparse.zorro_sparse_attention_qkv(qkv, types, heads, 3, return_lse=True)
    ref, ref_lse = cuda_zorro_sparse.zorro_sparse_attention_qkv_reference(qkv, types, heads, 3, return_lse=True)
    do = _attention_backward(out, lse)
    dqkv = cuda_zorro_sparse.zorro_sparse_attention_qkv_backward(qkv, types, out, lse, do, heads, 3)
    ref_dqkv = cuda_zorro_sparse.zorro_sparse_attention_qkv_backward_reference(qkv, types, ref, ref_lse, do,
                                                                               heads, 3)
    dense, dense_lse = cuda_attn.zorro_attention_qkv(qkv, heads, types, 3, return_lse=True)
    dense_dqkv = cuda_attn.zorro_attention_qkv_backward(qkv, types, dense, dense_lse, do, heads, 3)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(dqkv).all()
    assert _rel(out, ref) <= REL_L2
    assert _rel_all(dqkv.chunk(3, dim=-1), ref_dqkv.chunk(3, dim=-1)) <= REL_L2
    valid = types != 255
    assert _rel(out[valid], dense[valid]) <= REL_L2
    assert _rel_all(dqkv[valid].chunk(3, dim=-1), dense_dqkv[valid].chunk(3, dim=-1)) <= REL_L2


@pytest.mark.parametrize("dh", [32, 64])
def test_sparse_mode_with_every_tile_active_is_the_slab_kernel(dev, dh):
    """With an activity table that skips nothing, the tile-skip mode runs
    the slab kernel's loop over the same tiles: bitwise its results."""
    types = _sparse_types(dev, "flagship", 2)
    b, n = types.shape
    qkv = _randn(dev, b, n, 3 * 2 * dh, seed=53)
    do = _randn(dev, b, n, 2 * dh, seed=54)
    scale = cuda_attn.default_scale(2 * dh, 2, None)
    all_active = torch.ones((b, 1, (n // 128) ** 2), dtype=torch.int32, device=dev)
    out, lse = cuda_attn.launch_attention(cuda_attn.slab_view(qkv), b, n, 2 * dh, 2, dev, types, 3, scale, True,
                                          all_active)
    dqkv = torch.empty_like(qkv)
    cuda_attn.launch_attention_backward(cuda_attn.slab_view(qkv), cuda_attn.slab_view(dqkv), b, n, 2 * dh, 2, dev,
                                        types, 3, out, lse, do, scale, all_active)
    dense, dense_lse = cuda_attn.zorro_attention_qkv(qkv, 2, types, 3, return_lse=True)
    dense_dqkv = cuda_attn.zorro_attention_qkv_backward(qkv, types, dense, dense_lse, do, 2, 3)
    torch.cuda.synchronize()
    assert torch.equal(out, dense) and torch.equal(lse, dense_lse) and torch.equal(dqkv, dense_dqkv)


def _block_case(dev, b, n, d, heads, dh, seed=60):
    inner = heads * dh
    counts = (n // 4, n // 5, n // 6)
    fusion = n // 4
    pad = n - sum(counts) - fusion
    types = _types(dev, counts, pad, fusion).expand(b, -1).contiguous()
    x = _randn(dev, b, n, d, seed=seed)
    g1 = (1 + 0.1 * _randn(dev, d, seed=seed + 1).float()).to(torch.bfloat16)
    g2 = (1 + 0.1 * _randn(dev, d, seed=seed + 2).float()).to(torch.bfloat16)
    wq = _randn(dev, inner, d, scale=d ** -0.5, seed=seed + 3)
    wkv = _randn(dev, 2 * inner, d, scale=d ** -0.5, seed=seed + 4)
    wo = _randn(dev, d, inner, scale=inner ** -0.5, seed=seed + 5)
    dy = _randn(dev, b, n, d, seed=seed + 6)
    return x, types, (g1, g2, wq, wkv, wo), dy


@pytest.mark.parametrize("b,n,d,heads,dh", [(2, 70, 64, 1, 64), (1, 128, 192, 3, 64), (3, 100, 96, 3, 32),
                                            (2, 64, 128, 1, 128), (60, 128, 192, 3, 64), (1, 33, 48, 2, 32),
                                            (60, 640, 192, 3, 64)])
def test_fused_block_matches_plain(dev, b, n, d, heads, dh):
    """K6 and K6b within REL_L2 of the plain versions; the weight and gain
    gradients are sums over all B x N rows."""
    x, types, w, dy = _block_case(dev, b, n, d, heads, dh)
    y = cuda_block_attn.fused_block_attn(x, types, *w, heads, 3)
    ref = cuda_block_attn.fused_block_attn_reference(x, types, *w, heads, 3)
    grads = cuda_block_attn.fused_block_attn_backward(x, types, *w, dy, heads, 3)
    ref_grads = cuda_block_attn.fused_block_attn_backward_reference(x, types, *w, dy, heads, 3)
    torch.cuda.synchronize()
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert _rel(y, ref) <= REL_L2
    assert [g.shape for g in grads] == [r.shape for r in ref_grads]
    for name, g, r in zip(("dx", "dg1", "dg2", "dwq", "dwkv", "dwo"), grads, ref_grads):
        assert _rel_all([g], [r]) <= REL_L2, name


def test_new_functions_launch_their_kernels(dev):
    """FusedBlockAttn, ZorroAttentionPacked and ZorroSparseAttentionQKV each
    launch their forward kernel once and their backward kernel once."""
    ops.reset_kernel_launches()
    x, types, w, _ = _block_case(dev, 1, 64, 64, 1, 64)
    x.requires_grad_()
    w = [t.requires_grad_() for t in w]
    cuda_block_attn.FusedBlockAttn.apply(x, types, *w, 1, 3).float().sum().backward()
    q, k, v = (_randn(dev, 1, 64, 64, seed=s).requires_grad_() for s in (70, 71, 72))
    cuda_attn.ZorroAttentionPacked.apply(q, k, v, types, 1, 3).float().sum().backward()
    sparse_types = _sparse_types(dev, "single-type tiles", 1)
    qkv = _randn(dev, 1, 512, 3 * 64, seed=73).requires_grad_()
    cuda_zorro_sparse.ZorroSparseAttentionQKV.apply(qkv, sparse_types, 1, 3).float().sum().backward()
    counts = {k_: n for k_, n in ops.kernel_launches().items() if n}
    assert counts == {"fused_block_attn/forward": 1, "fused_block_attn/backward": 1,
                      "zorro_attention_packed/zorro": 1, "zorro_attention_packed/zorro_backward": 1,
                      "zorro_sparse/forward": 1, "zorro_sparse/backward": 1}, counts
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (x, *w, q, k, v, qkv))


def test_new_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x, types, w, _ = _block_case(dev, 1, 64, 64, 1, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        cuda_block_attn.fused_block_attn(x.float(), types, *w, 1, 3)
    with pytest.raises(ValueError):  # a weight left on the CPU
        cuda_block_attn.fused_block_attn(x, types, w[0].cpu(), *w[1:], 1, 3)
    with pytest.raises(ValueError, match="head dim"):
        cuda_block_attn.fused_block_attn(x, types, *w, 4, 3)  # dh 16
    q = _randn(dev, 1, 64, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        cuda_attn.zorro_attention_packed(q.float(), q.float(), q.float(), types, 1, 3)
    with pytest.raises(ValueError):  # k on the CPU
        cuda_attn.zorro_attention_packed(q, q.cpu(), q, types, 1, 3)
    qkv = _randn(dev, 1, 64 * 3, 3 * 64)
    sparse_types = torch.zeros(1, 192, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiple of 128"):
        cuda_zorro_sparse.zorro_sparse_attention_qkv(qkv, sparse_types, 1, 3)
    with pytest.raises(TypeError, match="bfloat16"):
        cuda_zorro_sparse.zorro_sparse_attention_qkv(qkv[:, :128].float(), sparse_types[:, :128], 1, 3)
    with pytest.raises(ValueError):  # types on the CPU
        cuda_zorro_sparse.zorro_sparse_attention_qkv(qkv[:, :128].contiguous(), sparse_types[:, :128].cpu(), 1, 3)
