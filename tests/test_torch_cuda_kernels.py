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
(the weight-gradient sums); K2's row path (with its hidden split at small
M), its wide path (`base` and `large` at a step's rows, bitwise run to run)
and `large`'s padded inner width; K4's staged value
slice at B = 1 and 30, past shared memory and off 16 bytes, bitwise the
same from run to run; K3's and K3b's 2-byte paths on operands off 16 bytes
and both at 40 heads; K5b's fixed-point adds on skewed points and at
ragged P, bitwise the same from run to run; K4b's
shared-memory dV at B = 1 and 30, near and off the reference points, and
with levels past shared memory; K1 / K1b over the pretraining variants' 2E
layout (PAD mid-sequence) and K3 / K3b with the quadruplet's four slots, in
bf16 and f32. Also the autograd Functions' launches and the wrappers'
refusals. These tests need a CUDA card and skip without one; on a
card run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q

(``--noconftest``: the suite's conftest configures JAX, which the card's
machine need not have; this file imports nothing of JAX.)
"""
import pytest
import torch

from incomplete_multimodal_fusion_tpu_torch import ops
from incomplete_multimodal_fusion_tpu_torch.models.pixel_decoder import reference_points_for
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
@pytest.mark.parametrize("m", [1, 63, 64, 65, 23040, 38400])
def test_ffn_backward_at_the_model_widths(dev, mode, m):
    """K2b at the model's widths, M below, at and past the 64-row warpgroup
    tile and the 128-row block (a partial last tile), and the 'sup'
    backbone's and pretraining shapes (several weight-gradient row
    ranges)."""
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


_FFN_FORWARD = {"geglu": (cuda_ffn.geglu_ffn, cuda_ffn.geglu_ffn_reference),
                "mlp": (cuda_ffn.mlp_ffn, cuda_ffn.mlp_ffn_reference)}


def _check_ffn_forward(dev, mode, m, widths):
    x, w, _ = _ffn_case(dev, mode, m, seed=100, widths=widths)
    kernel, plain = _FFN_FORWARD[mode]
    out = kernel(x, *w)
    ref = plain(x, *w)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert _rel(out, ref) <= REL_L2


@pytest.mark.parametrize("mode", ["geglu", "mlp"])
@pytest.mark.parametrize("m", [1, 127, 256, 1024, 15300, 15360, 23040, 38400])
def test_ffn_forward_at_the_model_widths(dev, mode, m):
    """K2's row path at the model's widths: the serving, training and 'sup'
    backbone's M, and M below and not a multiple of the 128-row tile."""
    _check_ffn_forward(dev, mode, m, "model")


@pytest.mark.parametrize("mode,widths", [
    ("geglu", "base"), ("mlp", "base"),
    ("geglu", (256, 512)),  # the row path's shared memory does not hold d = 256 in GEGLU mode
    ("mlp", (256, 1024, 320)),  # only the output width past the row path
    ("mlp", (320, 512, 256)),  # only the input width past it
    ("geglu", (1040, 208)),  # a partial last window, hidden chunk and column tile
])
@pytest.mark.parametrize("m", [1, 130, 4100])
def test_ffn_forward_past_the_row_path_widths(dev, mode, widths, m):
    """K2's wide path (the xn and activation workspaces and two wgmma
    products), for widths the row path does not take."""
    _check_ffn_forward(dev, mode, m, widths)


@pytest.mark.parametrize("mode,widths,m", [("geglu", "model", 15360), ("mlp", "model", 15360), ("geglu", "model", 1024),
                                          ("mlp", "model", 2048), ("geglu", "base", 4100), ("mlp", "base", 4100)])
def test_ffn_forward_is_bitwise_the_same_from_run_to_run(dev, mode, widths, m):
    """No atomics: at small M (1024, 2048) the hidden split's partial outputs
    are summed in a fixed order."""
    x, w, _ = _ffn_case(dev, mode, m, seed=110, widths=widths)
    kernel, _ = _FFN_FORWARD[mode]
    first, second = kernel(x, *w), kernel(x, *w)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("m", [1, 300, 4096])
def test_geglu_at_the_large_width_pads_its_inner_width(dev, m):
    """`large`: d = 1024 and the inner width int(1024 * 8 / 3) = 2730, not a
    multiple of 16; the wrappers zero-pad it, forward and backward, and
    return gradients of the unpadded weights."""
    x, w, dy = _ffn_case(dev, "geglu", m, seed=120, widths=(1024, 2730))
    out, ref = cuda_ffn.geglu_ffn(x, *w), cuda_ffn.geglu_ffn_reference(x, *w)
    grads, ref_grads = cuda_ffn.geglu_ffn_backward(x, *w, dy), cuda_ffn.geglu_ffn_backward_reference(x, *w, dy)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= REL_L2
    assert [g.shape for g in grads] == [r.shape for r in ref_grads] == [t.shape for t in (x, *w)]
    for g, r in zip(grads, ref_grads):
        assert torch.isfinite(g).all() and _rel_all([g], [r]) <= REL_L2


# the wide path's widths at the pretraining rows: `base` (d = 768, inner
# 2048; MLP hidden 3072) and `large` (d = 1024, inner 2730 padded to 2736;
# MLP hidden 4096)
_WIDE = {"base": {"geglu": (768, 2048), "mlp": (768, 3072, 768)},
         "large": {"geglu": (1024, 2730), "mlp": (1024, 4096, 1024)}}


@pytest.mark.parametrize("mode", ["geglu", "mlp"])
@pytest.mark.parametrize("size", ["base", "large"])
@pytest.mark.parametrize("m", [1, 65, 4100, 15360, 38400])
def test_ffn_wide_path_at_the_step_rows(dev, mode, size, m):
    """K2 / K2b's wide path (the pipelined product body of ffn_wide.cuh) at
    `base`'s and `large`'s widths, at M of one row, a ragged tile, and a
    `base` step's fusion (15,360) and encoder (38,400) rows: the output and
    every gradient within REL_L2 of the plain versions."""
    widths = _WIDE[size][mode]
    _check_ffn_forward(dev, mode, m, widths)
    _check_ffn_backward(dev, mode, m, widths)


@pytest.mark.parametrize("mode", ["geglu", "mlp"])
@pytest.mark.parametrize("m", [15360, 38400])
def test_ffn_wide_path_is_bitwise_the_same_at_the_step_rows(dev, mode, m):
    """No atomics on the wide path: the weight gradients' row ranges (several
    at these M) are summed in a fixed order, so two calls, forward and
    backward, are bitwise equal."""
    x, w, dy = _ffn_case(dev, mode, m, seed=130, widths="base")
    forward, _ = _FFN_FORWARD[mode]
    backward, _ = _FFN_BACKWARD[mode]
    first, second = forward(x, *w), forward(x, *w)
    grads, again = backward(x, *w, dy), backward(x, *w, dy)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("mode", ["geglu", "mlp"])
def test_ffn_wide_path_refuses_operands_off_16_bytes(dev, mode):
    """The wide path's cp.async copies take 16 bytes at a time: an operand
    whose data starts off a 16-byte boundary is refused by the wrapper
    (which asks for 32), forward and backward, never read misaligned."""
    x, w, dy = _ffn_case(dev, mode, 130, seed=140, widths="base")
    forward, _ = _FFN_FORWARD[mode]
    backward, _ = _FFN_BACKWARD[mode]
    for shift in (1, 8):  # 2 and 16 bytes into the storage
        bad = torch.empty(x.numel() + shift, dtype=x.dtype, device=dev)[shift:].view(x.shape)
        bad.copy_(x)
        assert bad.data_ptr() % 32
        with pytest.raises(ValueError, match="aligned"):
            forward(bad, *w)
        with pytest.raises(ValueError, match="aligned"):
            backward(bad, *w, dy)


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


@pytest.mark.parametrize("operand", ["q", "kv_grid", "kv_f", "do"])
def test_fusion_row_backward_on_an_operand_that_starts_off_16_bytes(dev, operand):
    """K3b moves 8 channels by 16-byte accesses only where every operand
    starts on 16 bytes; a contiguous view one bf16 into its storage takes
    the kernel's 2-byte path and gives the plain backward."""
    b, f, heads, dh, t_mod = 2, 20, 3, 64, 3
    operands = dict(q=_randn(dev, b, f, heads * dh, seed=11),
                    kv_grid=_randn(dev, b, t_mod * f, 2 * heads * dh, seed=12),
                    kv_f=_randn(dev, b, f, 2 * heads * dh, seed=13), do=_randn(dev, b, f, heads * dh, seed=24))
    ref = cuda_fusion_attn.fusion_row_attention_backward_reference(*operands.values(), heads, dh)
    operands[operand] = _offset_copy(operands[operand], 1)
    assert operands[operand].is_contiguous() and operands[operand].data_ptr() % 16
    out = cuda_fusion_attn.fusion_row_attention_backward(*operands.values(), heads, dh)
    torch.cuda.synchronize()
    assert _rel_all(out, ref) <= REL_L2


@pytest.mark.parametrize("operand", ["q", "kv_grid", "kv_f", "all"])
def test_fusion_row_kernel_on_an_operand_that_starts_off_16_bytes(dev, operand):
    """K3 moves 8 channels by 16-byte accesses only where every operand
    starts on 16 bytes; a contiguous view one bf16 into its storage (or all
    three such views) takes the kernel's 2-byte path and gives the plain
    forward."""
    b, f, heads, dh, t_mod = 2, 20, 3, 64, 3
    operands = dict(q=_randn(dev, b, f, heads * dh, seed=11),
                    kv_grid=_randn(dev, b, t_mod * f, 2 * heads * dh, seed=12),
                    kv_f=_randn(dev, b, f, 2 * heads * dh, seed=13))
    ref = cuda_fusion_attn.fusion_row_attention_reference(*operands.values(), heads, dh)
    for name in operands if operand == "all" else [operand]:
        operands[name] = _offset_copy(operands[name], 1)
        assert operands[name].is_contiguous() and operands[name].data_ptr() % 16
    out = cuda_fusion_attn.fusion_row_attention(*operands.values(), heads, dh)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= REL_L2


@pytest.mark.parametrize("t_mod", [1, 3])
def test_fusion_row_kernels_take_more_than_32_heads(dev, t_mod):
    """K3 and K3b cover (position, head) units in 256-thread blocks, so any
    head count runs; 40 heads of 32 against the plain versions."""
    b, f, heads, dh = 2, 9, 40, 32
    q, kvg, kvf = _randn(dev, b, f, heads * dh, seed=14), _randn(dev, b, t_mod * f, 2 * heads * dh, seed=15), \
        _randn(dev, b, f, 2 * heads * dh, seed=16)
    do = _randn(dev, b, f, heads * dh, seed=17)
    out = cuda_fusion_attn.fusion_row_attention(q, kvg, kvf, heads, dh)
    grads = cuda_fusion_attn.fusion_row_attention_backward(q, kvg, kvf, do, heads, dh)
    ref = cuda_fusion_attn.fusion_row_attention_reference(q, kvg, kvf, heads, dh)
    ref_grads = cuda_fusion_attn.fusion_row_attention_backward_reference(q, kvg, kvf, do, heads, dh)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= REL_L2
    assert _rel_all(grads, ref_grads) <= REL_L2


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
        cuda_attn.zorro_attention_qkv(qkv.to(torch.float16), 1)
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
    (1, 1344, 8, 32, 4, FULL_LEVELS),  # B = 1: a slice's queries over about 16 blocks
    (2, 300, 4, 32, 4, ((16, 16), (32, 32), (64, 64))),  # the 64^2 level past shared memory
    (1, 300, 4, 32, 4, ((16, 16), (32, 32), (64, 64))),
    (2, 300, 8, 64, 4, FULL_LEVELS),  # D = 64: part of the 32^2 level past shared memory
    (3, 101, 2, 40, 4, ((48, 48), (64, 64))),  # D over one warp's lanes, most levels past shared memory
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


def test_msda_kernel_is_bitwise_the_same_from_run_to_run(dev):
    """Each output element is summed by one group of lanes in a fixed order:
    no atomics, so two runs agree bit for bit (B = 30: blocks restage where
    their range of queries enters a new slice)."""
    value, locs, aw = _msda_inputs(dev, 30, 1344, 8, 32, 4, FULL_LEVELS, seed=45)
    first = cuda_msda.ms_deform_attn(value, FULL_LEVELS, locs, aw)
    second = cuda_msda.ms_deform_attn(value, FULL_LEVELS, locs, aw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("floats", [1, 2])
def test_msda_kernel_on_a_value_that_starts_off_16_bytes(dev, floats):
    """K4 stages and reads value 4 channels at a time only where value and
    the output start on 16 bytes; a contiguous view that does not takes the
    1-channel kernel and gives the plain version's output."""
    value, locs, aw = _msda_inputs(dev, 2, 1344, 8, 32, 4, FULL_LEVELS, seed=46)
    v = _offset_copy(value, floats)
    assert v.is_contiguous() and v.data_ptr() % 16
    out = cuda_msda.ms_deform_attn(v, FULL_LEVELS, locs, aw)
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


def _near_reference(dev, b, shapes, heads, points, seed=36):
    """Locations near each query's reference point on every level (N(0, 2
    pixels) offsets), as a trained pixel decoder samples; every position a
    query."""
    g = torch.Generator(device=dev).manual_seed(seed)
    s = sum(h * w for h, w in shapes)
    ref = reference_points_for(shapes, device=dev)[None, :, None, :, None, :]
    size = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=dev)
    noise = 2.0 * torch.randn(b, s, heads, len(shapes), points, 2, device=dev, generator=g)
    return ref + noise / size[None, None, None, :, None, :]


@pytest.mark.parametrize("b", [1, 30])
@pytest.mark.parametrize("near", [False, True])
def test_msda_backward_at_the_pixel_decoder_shapes(dev, b, near):
    """K4b with every (batch, head) slice's dV in shared memory: B = 30 (a
    block a slice) and B = 1 (a slice's queries split over blocks, the
    partial slices summed in a second launch), random locations and near the
    reference points, where the coarse rows take most adds."""
    value, locs, aw = _msda_inputs(dev, b, 1344, 8, 32, 4, FULL_LEVELS, seed=37)
    if near:
        locs = _near_reference(dev, b, FULL_LEVELS, 8, 4)
    locs = _off_integer(locs, FULL_LEVELS)
    dout = torch.randn(b, 1344, 8 * 32, device=dev, generator=torch.Generator(device=dev).manual_seed(38))
    out = cuda_msda.ms_deform_attn_backward(value, FULL_LEVELS, locs, aw, dout)
    ref = cuda_msda.ms_deform_attn_backward_reference(value, FULL_LEVELS, locs, aw, dout)
    torch.cuda.synchronize()
    assert all(torch.isfinite(o).all() for o in out)
    for o, r in zip(out, ref):
        assert _rel_all([o], [r]) <= MSDA_REL_L2


@pytest.mark.parametrize("b,shapes,d", [
    (2, ((8, 8), (16, 16), (32, 32), (64, 64)), 32),  # the 64^2 level past shared memory
    (1, ((8, 8), (16, 16), (32, 32), (64, 64)), 32),  # the same with split queries
    (2, ((48, 48), (64, 64)), 32),  # no level fits: every tap by atomics
    (3, ((5, 3), (9, 11), (48, 40)), 40),  # D over one warp's lanes, a slice of 325 KB
])
def test_msda_backward_with_levels_past_shared_memory(dev, b, shapes, d):
    """Where a (batch, head) slice of dV does not fit in shared memory, the
    coarse levels stay there and the rest take f32 atomics into dV, whose
    rows the kernel's launcher zeroes (the wrapper allocates dV empty)."""
    lq, m, p = 300, 4, 4
    value, locs, aw = _msda_inputs(dev, b, lq, m, d, p, shapes, seed=39)
    locs = _off_integer(locs, shapes)
    dout = torch.randn(b, lq, m * d, device=dev, generator=torch.Generator(device=dev).manual_seed(40))
    out = cuda_msda.ms_deform_attn_backward(value, shapes, locs, aw, dout)
    ref = cuda_msda.ms_deform_attn_backward_reference(value, shapes, locs, aw, dout)
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        assert torch.isfinite(o).all() and _rel_all([o], [r]) <= MSDA_REL_L2


def test_msda_backward_writes_every_element_of_dvalue(dev):
    """dV comes from torch.empty: positions no sample touches must read 0,
    however the allocator's memory was filled before."""
    shapes = ((8, 8), (16, 16), (32, 32))
    for fill in (float("nan"), 7.0):
        torch.cuda.empty_cache()
        junk = torch.full((8, 1344, 8, 32), fill, device=dev)
        del junk
        value, locs, aw = _msda_inputs(dev, 8, 10, 8, 32, 4, shapes, lo=0.2, hi=0.3, seed=41)
        dv, _, _ = cuda_msda.ms_deform_attn_backward(value, shapes, locs, aw, torch.ones(8, 10, 256, device=dev))
        torch.cuda.synchronize()
        assert torch.isfinite(dv).all()
        assert float(dv[:, 64 + 256 + 700:].abs().max()) == 0.0  # past every sample of [0.2, 0.3]


def _offset_copy(t, floats):
    """A contiguous copy of ``t`` whose storage starts ``floats`` elements
    into a larger buffer (a data pointer off 16 bytes for 1, 2 or 3)."""
    buf = torch.empty(t.numel() + floats, dtype=t.dtype, device=t.device)
    view = buf[floats:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("floats", [1, 2])
def test_msda_backward_on_views_that_start_off_16_bytes(dev, floats):
    """K4b reads value and dOut 4 channels at a time only where both start
    on 16 bytes; contiguous views that do not take the 1-channel kernel and
    give the plain version's gradients."""
    value, locs, aw = _msda_inputs(dev, 1, 1344, 8, 32, 4, FULL_LEVELS, seed=42)
    locs = _off_integer(locs, FULL_LEVELS)
    dout = torch.randn(1, 1344, 8 * 32, device=dev, generator=torch.Generator(device=dev).manual_seed(43))
    ref = cuda_msda.ms_deform_attn_backward_reference(value, FULL_LEVELS, locs, aw, dout)
    for v, do in ((_offset_copy(value, floats), dout), (value, _offset_copy(dout, floats))):
        assert v.is_contiguous() and do.is_contiguous() and (v.data_ptr() % 16 or do.data_ptr() % 16)
        out = cuda_msda.ms_deform_attn_backward(v, FULL_LEVELS, locs, aw, do)
        torch.cuda.synchronize()
        assert _rel_all(out, ref) <= MSDA_REL_L2


def _device_kernels(fn, name, tries: int = 3):
    """The device kernels one call of ``fn`` launches whose name holds
    ``name``, from torch.profiler: the most that one call showed in
    ``tries`` profiles (after another test's profile the profiler has
    dropped a call's first kernels; it never adds one)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name))
    return max(counts)


@pytest.mark.parametrize("mode,widths,m,planned", [("geglu", "model", 38400, 1), ("geglu", "model", 1024, 2),
                                                   ("mlp", "model", 2048, 2), ("geglu", "base", 130, 3),
                                                   ("mlp", "base", 130, 2), ("geglu", (1024, 2730), 300, 3)])
def test_k2_forward_launches_the_kernels_its_library_plans(dev, mode, widths, m, planned):
    """``cuda_ffn.forward_kernels``, which phase 3 of chip_smoke.py counts
    K2's kernels by, is what a forward launches: the row path, its hidden
    split at small M, the wide path."""
    x, w, _ = _ffn_case(dev, mode, m, seed=120, widths=widths)
    kernel, _ = _FFN_FORWARD[mode]
    hid, d_out = (w[2].shape[1], x.shape[1]) if mode == "geglu" else (w[0].shape[0], w[2].shape[0])
    assert cuda_ffn.forward_kernels(mode == "geglu", m, x.shape[1], hid, d_out) == planned
    assert _device_kernels(lambda: kernel(x, *w), "ffn_fwd") == planned


@pytest.mark.parametrize("mode,widths,m,planned", [("geglu", "model", 38400, 3), ("mlp", "model", 15360, 3),
                                                   ("geglu", "base", 8192, 5), ("mlp", "base", 130, 3),
                                                   ("geglu", (1024, 2730), 300, 5), ("mlp", (320, 512, 256), 65, 3)])
def test_k2b_launches_the_kernels_its_library_plans(dev, mode, widths, m, planned):
    """``cuda_ffn.backward_kernels``, which phase 3 of chip_smoke.py counts
    K2b's kernels by, is what a backward launches: the row pass, the weight
    gradients and the reduction, or the wide path's kernels."""
    x, w, dy = _ffn_case(dev, mode, m, seed=150, widths=widths)
    kernel, _ = _FFN_BACKWARD[mode]
    hid, d_out = (w[2].shape[1], x.shape[1]) if mode == "geglu" else (w[0].shape[0], w[2].shape[0])
    assert cuda_ffn.backward_kernels(mode == "geglu", m, x.shape[1], hid, d_out) == planned
    run = lambda: kernel(x, *w, dy)  # noqa: E731
    assert _device_kernels(run, "ffn_bwd") + _device_kernels(run, "wgrad") == planned


@pytest.mark.parametrize("b,planned", [(1, 2), (30, 1)])
def test_k4b_launches_the_kernels_its_library_plans(dev, b, planned):
    """``cuda_msda.backward_kernels``: at B = 1 a slice's queries split over
    blocks and a second kernel sums the partial slices."""
    value, locs, aw = _msda_inputs(dev, b, 1344, 8, 32, 4, FULL_LEVELS, seed=44)
    dout = torch.randn(b, 1344, 8 * 32, device=dev)
    assert cuda_msda.backward_kernels(b, 1344, 8, 32, FULL_LEVELS, 4) == planned
    run = lambda: cuda_msda.ms_deform_attn_backward(value, FULL_LEVELS, locs, aw, dout)  # noqa: E731
    assert _device_kernels(run, "ms_deform_attn_bwd") == planned


# the ViT-Adapter's interactions at 256^2 (6 heads x 32, 4 points): the
# injector's 256 fusion tokens over the priors' levels 32^2 / 16^2 / 8^2
# (high -> low resolution, S = 1344), the extractor's 1344 priors over the
# 16^2 token map (one level)
INJECTOR_LEVELS = ((32, 32), (16, 16), (8, 8))
EXTRACTOR_LEVELS = ((16, 16),)


@pytest.mark.parametrize("b,lq,shapes", [(30, 256, INJECTOR_LEVELS), (1, 256, INJECTOR_LEVELS),
                                         (30, 1344, EXTRACTOR_LEVELS), (1, 1344, EXTRACTOR_LEVELS)])
def test_msda_forward_and_backward_at_the_adapter_shapes(dev, b, lq, shapes):
    value, locs, aw = _msda_inputs(dev, b, lq, 6, 32, 4, shapes, seed=47)
    locs = _off_integer(locs, shapes)
    out = cuda_msda.ms_deform_attn(value, shapes, locs, aw)
    ref = cuda_msda.ms_deform_attn_core(value, shapes, locs, aw)
    assert _rel(out, ref) <= MSDA_REL_L2
    dout = torch.randn(b, lq, 6 * 32, device=dev, generator=torch.Generator(device=dev).manual_seed(48))
    grads = cuda_msda.ms_deform_attn_backward(value, shapes, locs, aw, dout)
    want = cuda_msda.ms_deform_attn_backward_reference(value, shapes, locs, aw, dout)
    torch.cuda.synchronize()
    assert all(torch.isfinite(t).all() for t in grads)
    assert _rel_all(grads, want) <= MSDA_REL_L2
    planned = cuda_msda.backward_kernels(b, lq, 6, 32, shapes, 4)
    run = lambda: cuda_msda.ms_deform_attn_backward(value, shapes, locs, aw, dout)  # noqa: E731
    assert _device_kernels(run, "ms_deform_attn_bwd") == planned


@pytest.mark.parametrize("levels", [INJECTOR_LEVELS, EXTRACTOR_LEVELS])
def test_msda_module_bf16_operands_launch_k4(dev, levels):
    """The adapter's MSDeformAttn in the bf16 backbone: its bf16 value,
    offsets and weights go to K4 / K4b cast up to f32 (one launch each way),
    and the result matches the plain route (impl 'xla', the plain core on
    the bf16 operands) and its gradients."""
    from incomplete_multimodal_fusion_tpu_torch.models.msda_module import MSDeformAttn

    torch.manual_seed(0)
    mod = MSDeformAttn(192, len(levels), 6, 4)
    with torch.no_grad():
        for lin in (mod.sampling_offsets, mod.attention_weights):
            lin.weight.normal_(0.0, 0.02)
    mod = mod.to(dev, torch.bfloat16)
    lq, s = (256, 1344) if len(levels) == 3 else (1344, 256)
    q = torch.randn(4, lq, 192, device=dev).to(torch.bfloat16)
    v = torch.randn(4, s, 192, device=dev).to(torch.bfloat16)
    ref_pts = torch.rand(4, lq, 1, 2, device=dev).expand(-1, -1, len(levels), -1)
    outs, grads = {}, {}
    for impl in ("auto", "xla"):
        mod.impl = impl
        mod.zero_grad()
        before = dict(cuda_msda.LAUNCHES)
        out = mod(q, ref_pts, v, levels)
        out.float().square().sum().backward()
        torch.cuda.synchronize()
        launched = {k: cuda_msda.LAUNCHES[k] - before[k] for k in before}
        assert launched == ({"forward": 1, "backward": 1} if impl == "auto" else {"forward": 0, "backward": 0})
        outs[impl] = out
        grads[impl] = {n: p.grad.float() for n, p in mod.named_parameters()}
    assert outs["auto"].dtype == torch.bfloat16
    assert _rel(outs["auto"], outs["xla"]) <= 1e-2
    for name in grads["xla"]:
        assert _rel(grads["auto"][name], grads["xla"][name]) <= REL_L2, name


def test_unmasked_at_the_sup_backbones_shape(dev):
    """The 'sup' backbone's attention at B = 30: K1 / K1b unmasked over all
    3 x 256 tokens at 3 heads x 64, against the plain versions at the bf16
    bound (its K2 / K2b rows, M = 30 * 768, are the FFN tests' 23040)."""
    qkv = _randn(dev, 30, 768, 3 * 192, seed=8)
    out = cuda_attn.zorro_attention_qkv(qkv, 3)
    ref = cuda_attn.zorro_attention_qkv_reference(qkv, 3)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and _rel(out, ref) <= REL_L2
    _zorro_backward_case(dev, qkv, 3, None)


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


def _skewed_coords(dev, kind, h, w, p, seed=50):
    """[1, p, 2] coords of one skewed kind: every point in one cell (their
    taps on the same four pixels); on the -1 border row and column (the
    pixel coordinate in [-1, 0): one tap row or column inside); far outside
    (no tap inside); or uniform past the borders."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand(1, p, 2, device=dev, generator=g)
    size = torch.tensor([w, h], dtype=torch.float32, device=dev)
    if kind == "one cell":  # pixel (x, y) in [20, 21) x [7, 8)
        return (torch.tensor([20.0, 7.0], device=dev) + u + 0.5) / size
    if kind == "border":  # x or y (or both) in [-1, 0), the other anywhere
        px = -1.0 + (w + 1.0) * u[..., 0]
        py = -1.0 + (h + 1.0) * u[..., 1]
        edge = torch.arange(p, device=dev) % 3
        px = torch.where(edge != 1, -u[..., 0], px)
        py = torch.where(edge != 0, -u[..., 1], py)
        return (torch.stack([px, py], dim=-1) + 0.5) / size
    if kind == "far outside":
        return torch.where(u < 0.5, -3.0 - u, 4.0 + u)
    return -0.2 + 1.4 * u


@pytest.mark.parametrize("kind,p", [("one cell", 12544), ("border", 12544), ("far outside", 12544),
                                    ("uniform", 12543), ("uniform", 1), ("uniform", 777)])
def test_point_sample_backward_on_skewed_points(dev, kind, p):
    """K5b's fixed-point adds at points that pile up: all 12544 in one cell,
    on the -1 border row and column, far outside (dmasks all zero), and at
    ragged P; dcoords from the same taps."""
    n, h, w = 4, 64, 64
    coords = _skewed_coords(dev, kind, h, w, p).expand(n, -1, -1).contiguous()
    g = torch.Generator(device=dev).manual_seed(51)
    masks = torch.randn(n, h, w, device=dev, generator=g)
    ds = torch.randn(n, p, device=dev, generator=g)
    dm, dc = cuda_points.point_sample_backward(masks, coords, ds, 1, True)
    ref_dm, ref_dc = cuda_points.point_sample_backward_reference(masks, coords, ds, 1, True)
    torch.cuda.synchronize()
    if kind == "far outside":
        assert float(dm.abs().max()) == 0.0 and float(ref_dm.abs().max()) == 0.0
        assert float(dc.abs().max()) == 0.0
    else:
        assert _rel(dm, ref_dm) <= POINTS_REL_L2
        assert _rel(dc, ref_dc) <= 1e-4  # one-sided derivatives at pixel edges are rare


def test_point_sample_backward_on_masks_that_start_off_16_bytes(dev):
    """Masks (read for dcoords) in a contiguous view 4 bytes into its
    storage: the same gradients as the plain backward."""
    n, h, w, p = 6, 64, 64, 3001
    _, coords = _points_inputs(dev, n, h, w, p, seed=52)
    flat = torch.randn(n * h * w + 1, device=dev, generator=torch.Generator(device=dev).manual_seed(53))
    masks = flat[1:].view(n, h, w)
    assert masks.is_contiguous() and masks.data_ptr() % 16 == 4
    ds = torch.randn(n, p, device=dev, generator=torch.Generator(device=dev).manual_seed(54))
    dm, dc = cuda_points.point_sample_backward(masks, coords, ds, 1, True)
    ref_dm, ref_dc = cuda_points.point_sample_backward_reference(masks, coords, ds, 1, True)
    torch.cuda.synchronize()
    assert _rel(dm, ref_dm) <= POINTS_REL_L2
    assert _rel(dc, ref_dc) <= 1e-4


def test_point_sample_backward_with_gradients_over_a_wide_range(dev):
    """dS spread over six decades: the fixed-point step follows the mask's
    largest |dS|, and dmasks stays within POINTS_REL_L2."""
    n, h, w, p = 8, 64, 64, 12544
    masks, coords = _points_inputs(dev, n, h, w, p, seed=55)
    g = torch.Generator(device=dev).manual_seed(56)
    ds = torch.randn(n, p, device=dev, generator=g) * 10.0 ** (6.0 * torch.rand(n, p, device=dev, generator=g) - 3)
    dm = cuda_points.point_sample_backward(masks, coords, ds)[0]
    ref = cuda_points.point_sample_backward_reference(masks, coords, ds)[0]
    torch.cuda.synchronize()
    assert _rel(dm, ref) <= POINTS_REL_L2


def test_point_sample_backward_is_bitwise_the_same_from_run_to_run(dev):
    """K5b adds its taps as integers, so the order of the adds leaves no
    trace: two runs give the same bits (the loss path's shape)."""
    masks, coords = _points_inputs(dev, 240, 64, 64, 12544, seed=57)
    ds = torch.randn(240, 12544, device=dev, generator=torch.Generator(device=dev).manual_seed(58))
    first = cuda_points.point_sample_backward(masks, coords, ds)[0]
    for _ in range(3):
        assert torch.equal(cuda_points.point_sample_backward(masks, coords, ds)[0], first)


def test_point_sample_wrapper_refuses_coords_off_8_bytes(dev):
    """The kernels load a point's (x, y) as one 8 bytes; a coords view 4
    bytes into its storage is no longer refused (the JAX kernel takes any
    coords): the wrapper copies it to an aligned buffer, and K5 and K5b
    give bitwise the results of the aligned coords, dcoords too."""
    masks, coords = _points_inputs(dev, 4, 8, 8, 10, group=2)
    off = _offset_copy(coords, 1)
    assert off.is_contiguous() and off.data_ptr() % 8 == 4 and torch.equal(off, coords)
    ds = torch.randn(4, 10, device=dev)
    assert torch.equal(cuda_points.point_sample(masks, off, 2), cuda_points.point_sample(masks, coords, 2))
    got = cuda_points.point_sample_backward(masks, off, ds, 2, coords_grad=True)
    want = cuda_points.point_sample_backward(masks, coords, ds, 2, coords_grad=True)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(off, coords)  # the caller's view is left as it was


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
        cuda_block_attn.fused_block_attn(x.to(torch.float16), types, *(t.to(torch.float16) for t in w), 1, 3)
    with pytest.raises(ValueError):  # a weight left on the CPU
        cuda_block_attn.fused_block_attn(x, types, w[0].cpu(), *w[1:], 1, 3)
    with pytest.raises(ValueError, match="head dim"):
        cuda_block_attn.fused_block_attn(x, types, *w, 4, 3)  # dh 16
    q = _randn(dev, 1, 64, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        cuda_attn.zorro_attention_packed(q.double(), q.double(), q.double(), types, 1, 3)
    with pytest.raises(ValueError):  # k on the CPU
        cuda_attn.zorro_attention_packed(q, q.cpu(), q, types, 1, 3)
    qkv = _randn(dev, 1, 64 * 3, 3 * 64)
    sparse_types = torch.zeros(1, 192, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiple of 128"):
        cuda_zorro_sparse.zorro_sparse_attention_qkv(qkv, sparse_types, 1, 3)
    with pytest.raises(TypeError, match="bfloat16"):
        cuda_zorro_sparse.zorro_sparse_attention_qkv(qkv[:, :128].to(torch.float16), sparse_types[:, :128], 1, 3)
    with pytest.raises(ValueError):  # types on the CPU
        cuda_zorro_sparse.zorro_sparse_attention_qkv(qkv[:, :128].contiguous(), sparse_types[:, :128].cpu(), 1, 3)


def _head_outputs_f32(qkv, types, heads, dh):
    """The kernel's own f32 head outputs o [B, N, H, dh] before their
    rounding, read through the D epilogue: with dO one-hot at column c of
    every head, D = o[..., c] exactly (one product by 1, the rest by 0)."""
    b, n, _ = qkv.shape
    o = torch.empty(b, n, heads, dh, device=qkv.device)
    for c in range(dh):
        onehot = torch.zeros(b, n, heads, dh, dtype=torch.bfloat16, device=qkv.device)
        onehot[..., c] = 1
        _, _, delta = cuda_block_attn.attention_with_delta(qkv, types, onehot.reshape(b, n, heads * dh), heads, 3)
        o[..., c] = delta.transpose(1, 2)
    return o


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("b,n", [(2, 70), (3, 640)])
def test_attention_with_delta_is_k1_with_d(dev, dh, b, n):
    """K6b's attention pass (K1's forward with the D epilogue): out and lse
    bitwise K1's; D = rowsum(dO * o) on the f32 head outputs o before their
    rounding (rel-L2 1e-5, o read back through one-hot dO, and rounding to
    the kernel's bf16 out within one bf16 step); and within REL_L2 of the
    plain version, which rounds the normalised p (not exp(s - m) before the
    division by the row sum, as K1 does)."""
    heads = 2
    counts = (n // 4, n // 5, n // 6)
    types = _types(dev, counts, n - sum(counts) - n // 4, n // 4).expand(b, -1).contiguous()
    qkv = _randn(dev, b, n, 3 * heads * dh, seed=80)
    dout = _randn(dev, b, n, heads * dh, seed=81)
    out, lse, delta = cuda_block_attn.attention_with_delta(qkv, types, dout, heads, 3)
    k1_out, k1_lse = cuda_attn.zorro_attention_qkv(qkv, heads, types, 3, return_lse=True)
    ref_out, ref_lse, ref_delta = cuda_block_attn.attention_with_delta_reference(qkv, types, dout, heads, 3)
    o = _head_outputs_f32(qkv, types, heads, dh)
    torch.cuda.synchronize()
    assert torch.equal(out, k1_out) and torch.equal(lse, k1_lse)
    rounded = out.reshape(b, n, heads, dh).float()
    assert ((o - rounded).abs() <= rounded.abs() * 2.0 ** -8 + 1e-30).all()
    want = (dout.reshape(b, n, heads, dh).double() * o.double()).sum(dim=-1).transpose(1, 2)
    assert _rel(delta.double(), want) <= 1e-5
    assert _rel_all([out, lse, delta], [ref_out, ref_lse, ref_delta]) <= REL_L2


@pytest.mark.parametrize("b,n,d,heads,dh", [(60, 640, 192, 3, 64), (2, 100, 832, 13, 64)])
def test_fused_block_backward_is_bitwise_the_same_run_to_run(dev, b, n, d, heads, dh):
    """K6b has no atomics (the row pass adds its warps' dg1 / dg2 sums in a
    fixed order, the weight gradients sum their row ranges in order): two
    runs give bitwise the same six gradients, at the pretraining shape and
    at a width the row pass takes in several slabs."""
    x, types, w, dy = _block_case(dev, b, n, d, heads, dh)
    first = cuda_block_attn.fused_block_attn_backward(x, types, *w, dy, heads, 3)
    second = cuda_block_attn.fused_block_attn_backward(x, types, *w, dy, heads, 3)
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dx", "dg1", "dg2", "dwq", "dwkv", "dwo"), first, second):
        assert torch.equal(a, b_), name


def _check_block_widths(dev, d, inner):
    heads, dh = (inner // 32, 32) if inner % 64 else ((inner // 128, 128) if inner % 128 == 0 else (inner // 64, 64))
    x, types, w, dy = _block_case(dev, 2, 100, d, heads, dh, seed=90)
    y = cuda_block_attn.fused_block_attn(x, types, *w, heads, 3)
    grads = cuda_block_attn.fused_block_attn_backward(x, types, *w, dy, heads, 3)
    ref = cuda_block_attn.fused_block_attn_reference(x, types, *w, heads, 3)
    ref_grads = cuda_block_attn.fused_block_attn_backward_reference(x, types, *w, dy, heads, 3)
    torch.cuda.synchronize()
    assert _rel(y, ref) <= REL_L2
    for name, g, r in zip(("dx", "dg1", "dg2", "dwq", "dwkv", "dwo"), grads, ref_grads):
        assert _rel(g, r) <= REL_L2, name


@pytest.mark.parametrize("d", [48, 64, 96, 128, 192, 256, 320, 768, 832, 1024, 1664])
def test_fused_block_row_products_at_every_width(dev, d):
    """The projection pass, the out projection and dout stream their
    weights in windows: D and I not multiples of 64 leave a tail window,
    D = 768 fills the 128-row tile's shared memory, D = 832 .. 1664 take
    64-row tiles (1664 = MAX_D, the staging tile in a window slot); the
    row pass takes D past 256 in slabs of 256 columns."""
    _check_block_widths(dev, d, d)


@pytest.mark.parametrize("d,inner", [(64, 1280), (1632, 64), (192, 1664), (1664, 256)])
def test_fused_block_at_unequal_widths(dev, d, inner):
    """D and I on either side of the 128-row tiles' 768: the projection
    pass and dout tile by D, the out projection by I."""
    _check_block_widths(dev, d, inner)


F32_SMALL = dict(in_domains=("s1", "s2", "dem"), out_domains=("s1", "s2", "dem"), image_size=64, patch_size=16,
                 dim_tokens=64, depth=2, dim_head=32, heads=2, ff_mult=4, num_fusion_tokens=16, decoder_dim=64,
                 decoder_depth=2, decoder_num_heads=2)


def test_f32_on_the_card_launches_the_f32_kernels(dev):
    """An f32 model on the card under attn_impl='auto' runs the kernels' f32
    instances (only ``*_f32`` launch keys; no bf16 kernel, no plain
    fallback) and matches attn_impl='xla' within 1e-5 (f32 on both paths;
    TF32 off, as the fixture sets). Widths the kernels take: dh 32, D 64,
    every encoder block on the fused route."""
    import numpy as np

    from incomplete_multimodal_fusion_tpu_torch.data.synthetic import synthetic_batch
    from incomplete_multimodal_fusion_tpu_torch.models.multimae import MultiMAE
    from incomplete_multimodal_fusion_tpu_torch.ops import masking

    torch.manual_seed(0)
    model = MultiMAE(**F32_SMALL).to(dev).eval()
    for blk in model.blocks:
        blk.fused_block = True
    doms = F32_SMALL["in_domains"]
    x = {d: torch.from_numpy(v).to(dev) for d, v in synthetic_batch(np.random.default_rng(0), doms, 2, 64).items()}
    mi = masking.generate_random_masks(torch.Generator().manual_seed(0), doms, (16,) * 3, 24, 2, device=dev)
    ops.reset_kernel_launches()
    with torch.no_grad():
        out = model(x, mi, 24)
    f32 = {k: n for k, n in ops.kernel_launches().items() if n}
    assert f32 == {"fused_block_attn/f32_forward": 2, "fusion_row_attention/fusion_row_f32": 2,
                   "fused_ffn/geglu_f32": 4, "zorro_attention_qkv/none_f32": 6, "fused_ffn/mlp_f32": 6}, f32
    model.attn_impl = "xla"
    ops.reset_kernel_launches()
    with torch.no_grad():
        ref = model(x, mi, 24)
    assert not any(ops.kernel_launches().values())
    for d in doms:
        assert out["preds"][d].dtype == torch.float32 and torch.isfinite(out["preds"][d]).all()
        assert _rel(out["preds"][d], ref["preds"][d]) <= 1e-5, d


F32_REL_L2 = 1e-5  # f32 instance vs f32 plain version: f32 operands, products and sums; only the order differs


def _randf(dev, *shape, scale=1.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, device=dev, generator=g) * scale


def _zorro_f32_case(dev, qkv, heads, types):
    out, lse = cuda_attn.zorro_attention_qkv(qkv, heads, types, 3, return_lse=True)
    ref, ref_lse = cuda_attn.zorro_attention_qkv_reference(qkv, heads, types, 3, return_lse=True)
    do = _randf(dev, *out.shape, seed=21)
    dqkv = cuda_attn.zorro_attention_qkv_backward(qkv, types, out, lse, do, heads, 3)
    ref_dqkv = cuda_attn.zorro_attention_qkv_backward_reference(qkv, types, ref, ref_lse, do, heads, 3)
    torch.cuda.synchronize()
    assert out.dtype == dqkv.dtype == torch.float32
    assert torch.isfinite(out).all() and torch.isfinite(dqkv).all()
    assert _rel(out, ref) <= F32_REL_L2
    assert _rel(lse, ref_lse) <= F32_REL_L2
    # each of dq, dk, dv against its own norm; at N = 1 (one key: dP = D, so
    # dq and dk are zero in exact arithmetic, and the kernel's are exactly
    # zero) the plain version's f32 rounding noise there is measured against
    # the whole gradient's norm
    whole = float(ref_dqkv.norm())
    for o, r in zip(dqkv.chunk(3, dim=-1), ref_dqkv.chunk(3, dim=-1)):
        assert float((o - r).norm()) <= F32_REL_L2 * (whole if qkv.shape[1] == 1 else float(r.norm()))


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("counts,pad,fusion", [((70, 0, 50), 9, 30), ((0, 3, 200), 60, 17), ((1, 1, 1), 0, 1),
                                               ((150, 50), 0, 0)])
def test_zorro_f32_kernel_matches_plain(dev, dh, counts, pad, fusion):
    """K1 / K1b's f32 instance on the zorro mask: PAD rows, fusion rows, a
    row of each type, and rows 150-199 whose first key tiles are all
    masked (the finite NEG_INF after the scale)."""
    types = _types(dev, counts, pad, fusion).expand(2, -1).contiguous()
    _zorro_f32_case(dev, _randf(dev, 2, types.shape[1], 3 * 2 * dh, seed=dh), 2, types)


@pytest.mark.parametrize("n,heads,dh", [(1, 1, 32), (63, 8, 32), (65, 2, 64), (300, 1, 128), (256, 8, 32),
                                        (640, 3, 64)])
def test_unmasked_f32_kernel_matches_plain(dev, n, heads, dh):
    _zorro_f32_case(dev, _randf(dev, 3, n, 3 * heads * dh, seed=1), heads, None)


@pytest.mark.parametrize("n,dh", [(65, 32), (190, 32), (100, 64), (255, 64), (640, 64), (1024, 64)])
def test_f32_ragged_n_and_the_model_lengths(dev, n, dh):
    counts = (n // 3, n // 4, 0)
    fusion = n // 5
    types = _types(dev, counts, n - sum(counts) - fusion, fusion).expand(3, -1).contiguous()
    _zorro_f32_case(dev, _randf(dev, 3, n, 3 * 3 * dh, seed=3), 3, types)


def test_f32_attention_is_bitwise_the_same_from_run_to_run(dev):
    types = _types(dev, (300, 200, 184), 40, 256).expand(4, -1).contiguous()
    qkv = _randf(dev, 4, types.shape[1], 3 * 192, seed=4)
    do = _randf(dev, 4, types.shape[1], 192, seed=5)
    runs = []
    for _ in range(2):
        out, lse = cuda_attn.zorro_attention_qkv(qkv, 3, types, 3, return_lse=True)
        runs.append((out, lse, cuda_attn.zorro_attention_qkv_backward(qkv, types, out, lse, do, 3, 3)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("mode", ["zorro", "none", "sparse"])
def test_f32_backward_is_bitwise_the_same_run_to_run(dev, mode):
    """K1b's f32 instance adds without atomics (dq in one kernel, dk and dv
    in the other), so two runs give the same bits in every mode: the zorro
    mask, none (the decoder's 8 x 32 heads) and the tile-skip table."""
    if mode == "none":
        types, heads, qkv = None, 8, _randf(dev, 3, 256, 3 * 256, seed=60)
    else:
        types = (_sparse_types(dev, "flagship", 3) if mode == "sparse" else
                 _types(dev, (300, 200, 184), 40, 256).expand(3, -1).contiguous())
        heads, qkv = 3, _randf(dev, 3, types.shape[1], 3 * 192, seed=60)
    if mode == "sparse":
        out, lse = cuda_zorro_sparse.zorro_sparse_attention_qkv(qkv, types, heads, 3, return_lse=True)
        backward = lambda do: cuda_zorro_sparse.zorro_sparse_attention_qkv_backward(qkv, types, out, lse, do, heads, 3)
    else:
        out, lse = cuda_attn.zorro_attention_qkv(qkv, heads, types, 3, return_lse=True)
        backward = lambda do: cuda_attn.zorro_attention_qkv_backward(qkv, types, out, lse, do, heads, 3)
    do = _randf(dev, *out.shape, seed=61)
    first, second = backward(do), backward(do)
    torch.cuda.synchronize()
    assert torch.isfinite(first).all() and torch.equal(first, second)


@pytest.mark.parametrize("b,counts,pad", [(1, (256, 256, 256), 0), (2, (300, 260, 280), 184)],
                         ids=["serving N=1024 B=1", "quadruplet N=1280"])
def test_f32_at_the_serving_shape_and_the_quadruplet_length(dev, b, counts, pad):
    """K1 / K1b's f32 instance at dh 64 where the f32 serving program runs it
    (N = 1024, B = 1: 48 blocks for 132 SMs) and at N = 1280 (four
    modalities' length), with 256 fusion rows."""
    types = _types(dev, counts, pad, 256).expand(b, -1).contiguous()
    _zorro_f32_case(dev, _randf(dev, b, types.shape[1], 3 * 3 * 64, seed=62), 3, types)


@pytest.mark.parametrize("dh", [32, 64, 128])
def test_f32_packed_mode_matches_plain_and_the_slab_kernel(dev, dh):
    types = _types(dev, (70, 0, 50), 9, 30).expand(2, -1).contiguous()
    qkv = _randf(dev, 2, types.shape[1], 3 * 2 * dh, seed=51)
    q, k, v = (t.contiguous() for t in qkv.chunk(3, dim=-1))
    out, lse = cuda_attn.zorro_attention_packed(q, k, v, types, 2, 3, return_lse=True)
    ref, ref_lse = cuda_attn.zorro_attention_packed_reference(q, k, v, types, 2, 3, return_lse=True)
    do = _randf(dev, *out.shape, seed=52)
    grads = cuda_attn.zorro_attention_packed_backward(q, k, v, types, out, lse, do, 2, 3)
    ref_grads = cuda_attn.zorro_attention_packed_backward_reference(q, k, v, types, ref, ref_lse, do, 2, 3)
    slab_out, slab_lse = cuda_attn.zorro_attention_qkv(qkv, 2, types, 3, return_lse=True)
    slab_grads = cuda_attn.zorro_attention_qkv_backward(qkv, types, slab_out, slab_lse, do, 2, 3)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= F32_REL_L2 and _rel_all(grads, ref_grads) <= F32_REL_L2
    assert torch.equal(out, slab_out) and torch.equal(lse, slab_lse)
    assert all(torch.equal(g, s_) for g, s_ in zip(grads, slab_grads.chunk(3, dim=-1)))


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("layout", sorted(SPARSE_ROWS))
def test_f32_sparse_mode_matches_plain_on_every_row(dev, dh, layout):
    """The tile-skip mode's f32 instance against its plain version (allowed
    & active) on every row, PAD rows included, forward and backward."""
    types = _sparse_types(dev, layout, 2)
    qkv = _randf(dev, 2, types.shape[1], 3 * 2 * dh, seed=53)
    out, lse = cuda_zorro_sparse.zorro_sparse_attention_qkv(qkv, types, 2, 3, return_lse=True)
    ref, ref_lse = cuda_zorro_sparse.zorro_sparse_attention_qkv_reference(qkv, types, 2, 3, return_lse=True)
    do = _randf(dev, *out.shape, seed=54)
    dqkv = cuda_zorro_sparse.zorro_sparse_attention_qkv_backward(qkv, types, out, lse, do, 2, 3)
    ref_dqkv = cuda_zorro_sparse.zorro_sparse_attention_qkv_backward_reference(qkv, types, ref, ref_lse, do, 2, 3)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= F32_REL_L2 and _rel(lse, ref_lse) <= F32_REL_L2
    assert _rel_all(dqkv.chunk(3, dim=-1), ref_dqkv.chunk(3, dim=-1)) <= F32_REL_L2


def _f32_weights(dev, mode, widths, seed=30):
    if mode == "geglu":
        d, inner = widths
        gamma = 1 + 0.1 * _randf(dev, d, seed=seed)
        return (gamma, _randf(dev, 2 * inner, d, scale=d ** -0.5, seed=seed + 1),
                _randf(dev, d, inner, scale=inner ** -0.5, seed=seed + 2)), d, d
    d, hidden, out = widths
    return (_randf(dev, hidden, d, scale=d ** -0.5, seed=seed), _randf(dev, hidden, scale=0.1, seed=seed + 1),
            _randf(dev, out, hidden, scale=hidden ** -0.5, seed=seed + 2),
            _randf(dev, out, scale=0.1, seed=seed + 3)), d, out


@pytest.mark.parametrize("mode,widths", [("geglu", (192, 512)), ("mlp", (256, 1024, 256)), ("geglu", (64, 96)),
                                         ("mlp", (32, 128, 48)), ("geglu", (768, 2048)), ("mlp", (768, 3072, 768)),
                                         ("geglu", (1024, 2730))])
@pytest.mark.parametrize("m", [1, 65, 4100])
def test_ffn_f32_matches_plain(dev, mode, widths, m):
    """K2 / K2b's f32 instance at the model's widths, small ones, `base`'s
    and `large`'s (inner width 2730, launched unpadded), forward and every
    gradient; M = 4100 spreads the weight gradients over several ranges."""
    w, d, d_out = _f32_weights(dev, mode, widths)
    x, dy = _randf(dev, m, d, seed=40), _randf(dev, m, d_out, seed=41)
    fwd, bwd = _FFN_FORWARD[mode], _FFN_BACKWARD[mode]
    out, ref = fwd[0](x, *w), fwd[1](x, *w)
    grads, ref_grads = bwd[0](x, *w, dy), bwd[1](x, *w, dy)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and _rel(out, ref) <= F32_REL_L2
    assert [g.shape for g in grads] == [r.shape for r in ref_grads]
    assert _rel_all(grads, ref_grads) <= F32_REL_L2


@pytest.mark.parametrize("mode", ["geglu", "mlp"])
def test_ffn_f32_at_the_training_rows_and_bitwise_run_to_run(dev, mode):
    """The pretraining step's M = 38,400 (GEGLU) and 15,360 (MLP): within
    F32_REL_L2, and two backward runs bitwise equal (partials summed in a
    fixed order, no atomics)."""
    widths = (192, 512) if mode == "geglu" else (256, 1024, 256)
    m = 38400 if mode == "geglu" else 15360
    w, d, d_out = _f32_weights(dev, mode, widths)
    x, dy = _randf(dev, m, d, seed=42), _randf(dev, m, d_out, seed=43)
    fwd, bwd = _FFN_FORWARD[mode], _FFN_BACKWARD[mode]
    first, second, ref_grads = bwd[0](x, *w, dy), bwd[0](x, *w, dy), bwd[1](x, *w, dy)
    out, ref = fwd[0](x, *w), fwd[1](x, *w)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= F32_REL_L2 and _rel_all(first, ref_grads) <= F32_REL_L2
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("mode,m", [("geglu", 1024), ("geglu", 256), ("geglu", 15300), ("geglu", 15360),
                                    ("mlp", 256), ("mlp", 2048)])
def test_ffn_f32_tensor_core_rows_match_plain_and_are_bitwise(dev, mode, m):
    """The 3xTF32 instance at the f32 paths' other rows (serving M = 1024
    and 256 with the hidden split, a ragged M, the fusion rows; the step's
    M = 38,400 and 15,360 are the test above's), forward and every gradient
    within F32_REL_L2 of the f32 plain version, and each bitwise the same run
    to run (fixed-order sums, no atomics)."""
    widths = (192, 512) if mode == "geglu" else (256, 1024, 256)
    w, d, d_out = _f32_weights(dev, mode, widths, seed=50)
    x, dy = _randf(dev, m, d, seed=51), _randf(dev, m, d_out, seed=52)
    fwd, bwd = _FFN_FORWARD[mode], _FFN_BACKWARD[mode]
    out, again, ref = fwd[0](x, *w), fwd[0](x, *w), fwd[1](x, *w)
    grads, grads_again, ref_grads = bwd[0](x, *w, dy), bwd[0](x, *w, dy), bwd[1](x, *w, dy)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= F32_REL_L2 and _rel_all(grads, ref_grads) <= F32_REL_L2
    assert torch.equal(out, again) and all(torch.equal(a, b) for a, b in zip(grads, grads_again))


@pytest.mark.parametrize("mode,widths,m", [("geglu", (768, 2048), 1024), ("geglu", (768, 2048), 256),
                                           ("geglu", (768, 2048), 8192), ("mlp", (768, 3072, 768), 2048),
                                           ("geglu", (1024, 2730), 4096), ("mlp", (320, 208, 288), 130)])
def test_ffn_f32_wide_rows_match_plain_and_are_bitwise(dev, mode, widths, m):
    """The wide path (d or d_out past 256) at the serving rows of `base`
    (M = 1024 and 256: the output product splits its hidden width), its
    training rows, `large`'s unpadded inner width 2730 (W_out's rows off 16
    bytes) and an MLP whose hidden width is no multiple of its blocks' 128
    and whose widths differ: forward and every gradient within F32_REL_L2 of the f32
    plain version, each bitwise the same run to run."""
    w, d, d_out = _f32_weights(dev, mode, widths, seed=64)
    x, dy = _randf(dev, m, d, seed=65), _randf(dev, m, d_out, seed=66)
    fwd, bwd = _FFN_FORWARD[mode], _FFN_BACKWARD[mode]
    out, again, ref = fwd[0](x, *w), fwd[0](x, *w), fwd[1](x, *w)
    grads, grads_again, ref_grads = bwd[0](x, *w, dy), bwd[0](x, *w, dy), bwd[1](x, *w, dy)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= F32_REL_L2 and _rel_all(grads, ref_grads) <= F32_REL_L2
    assert torch.equal(out, again) and all(torch.equal(a, b) for a, b in zip(grads, grads_again))


def test_mlp_tasks_f32_past_d_256_runs_the_wide_path_task_by_task(dev):
    """The task axis at `base`'s width (d = 768): within F32_REL_L2 of the
    plain MLPs, the wide path's launches once a task."""
    t, m, d, hidden = 2, 300, 768, 1024
    x = _randf(dev, t, m, d, seed=67)
    w = (_randf(dev, t, hidden, d, scale=d ** -0.5, seed=68), _randf(dev, t, hidden, scale=0.1, seed=69),
         _randf(dev, t, d, hidden, scale=hidden ** -0.5, seed=70), _randf(dev, t, d, scale=0.1, seed=71))
    out, ref = cuda_ffn.mlp_ffn_tasks(x, *w), cuda_ffn.mlp_ffn_tasks_reference(x, *w)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= F32_REL_L2
    assert cuda_ffn.forward_kernels_f32(False, m, d, hidden, d, tasks=t) == t * cuda_ffn.forward_kernels_f32(
        False, m, d, hidden, d)


@pytest.mark.parametrize("b", [1, 8])
def test_mlp_tasks_f32_at_the_batched_decoder_rows_is_bitwise(dev, b):
    """The task axis in f32 at T = 3, M = 256 B: within F32_REL_L2 of three
    plain MLPs, bitwise the same run to run."""
    t, m, d, hidden = 3, 256 * b, 256, 1024
    x = _randf(dev, t, m, d, seed=53)
    w = (_randf(dev, t, hidden, d, scale=d ** -0.5, seed=54), _randf(dev, t, hidden, scale=0.1, seed=55),
         _randf(dev, t, d, hidden, scale=hidden ** -0.5, seed=56), _randf(dev, t, d, scale=0.1, seed=57))
    out, again = cuda_ffn.mlp_ffn_tasks(x, *w), cuda_ffn.mlp_ffn_tasks(x, *w)
    ref = cuda_ffn.mlp_ffn_tasks_reference(x, *w)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= F32_REL_L2 and torch.equal(out, again)


@pytest.mark.parametrize("mode,widths", [("geglu", (192, 512)), ("mlp", (256, 1024, 256)), ("geglu", (768, 2048)),
                                         ("mlp", (768, 3072, 768)), ("geglu", (1024, 2730))])
def test_ffn_f32_runs_tensor_core_kernels_at_every_width(dev, mode, widths):
    """The f32 forward and backward launch tensor-core kernels and no FFMA
    product at every width: up to d = 256 ffn_tf32.cuh's row kernels, past
    it (`base`, `large`) ffn_tf32_wide.cuh's. Measured as chip_smoke.py's
    profiles are: after a warm-up, five calls a profile, up to three
    profiles (after another test's profile the profiler has dropped a
    call's first kernels)."""
    from torch.profiler import ProfilerActivity, profile

    w, d, d_out = _f32_weights(dev, mode, widths, seed=58)
    x, dy = _randf(dev, 300, d, seed=59), _randf(dev, 300, d_out, seed=60)
    fwd, bwd = _FFN_FORWARD[mode], _FFN_BACKWARD[mode]
    fwd[0](x, *w), bwd[0](x, *w, dy)
    torch.cuda.synchronize()
    if d <= 256:
        kinds = ("ffn_tf32_split", "ffn_tf32_fwd_rows", "ffn_tf32_bwd_rows", "ffn_tf32_wgrad")
    else:
        kinds = ("ffn_tf32_wide_act_kernel", "ffn_tf32_wide_gemm", "ffn_tf32_wide_act_bwd", "ffn_tf32_wide_weights")
    names = set()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fwd[0](x, *w), bwd[0](x, *w, dy)
            torch.cuda.synchronize()
        names |= {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
        if all(any(k in n for n in names) for k in kinds):
            break
    tensor_core = {k for k in kinds if any(k in n for n in names)}
    assert len(tensor_core) == 4, names
    assert not any("simt_f32_product" in n for n in names), names


def test_ffn_f32_in_a_cuda_graph_replays_bitwise(dev):
    """A CUDA graph captured around one f32 GEGLU forward and backward
    replays bitwise equal to the eager calls: the wrappers neither sync the
    host nor allocate at launch outside the graph's pool."""
    w, d, _ = _f32_weights(dev, "geglu", (192, 512), seed=61)
    x, dy = _randf(dev, 1024, d, seed=62), _randf(dev, 1024, d, seed=63)
    eager = [cuda_ffn.geglu_ffn(x, *w), *cuda_ffn.geglu_ffn_backward(x, *w, dy)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up on a side stream, as capture asks
        cuda_ffn.geglu_ffn(x, *w), cuda_ffn.geglu_ffn_backward(x, *w, dy)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = [cuda_ffn.geglu_ffn(x, *w), *cuda_ffn.geglu_ffn_backward(x, *w, dy)]
    for c in captured:
        c.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(captured, eager))


@pytest.mark.parametrize("t_mod", [1, 3, 8])
@pytest.mark.parametrize("heads,dh", [(3, 64), (1, 32), (2, 128), (40, 32)])
def test_fusion_row_f32_matches_plain(dev, t_mod, heads, dh):
    b, f, inner = 2, 20, heads * dh
    q, kvg, kvf = _randf(dev, b, f, inner, seed=11), _randf(dev, b, t_mod * f, 2 * inner, seed=12), \
        _randf(dev, b, f, 2 * inner, seed=13)
    do = _randf(dev, b, f, inner, seed=14)
    out = cuda_fusion_attn.fusion_row_attention(q, kvg, kvf, heads, dh)
    ref = cuda_fusion_attn.fusion_row_attention_reference(q, kvg, kvf, heads, dh)
    grads = cuda_fusion_attn.fusion_row_attention_backward(q, kvg, kvf, do, heads, dh)
    ref_grads = cuda_fusion_attn.fusion_row_attention_backward_reference(q, kvg, kvf, do, heads, dh)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and _rel(out, ref) <= F32_REL_L2
    assert _rel_all(grads, ref_grads) <= F32_REL_L2


@pytest.mark.parametrize("operand", ["q", "kv_grid", "kv_f", "do"])
def test_fusion_row_f32_on_an_operand_that_starts_off_16_bytes(dev, operand):
    """An operand 4 bytes past a 16-byte boundary takes the kernels' 4-byte
    path: the same values as the 16-byte one within F32_REL_L2."""
    b, f, heads, dh, t_mod = 2, 20, 3, 64, 3
    inner = heads * dh
    shapes = {"q": (b, f, inner), "kv_grid": (b, t_mod * f, 2 * inner), "kv_f": (b, f, 2 * inner),
              "do": (b, f, inner)}
    ops_ = {k: _randf(dev, *s, seed=60 + i) for i, (k, s) in enumerate(shapes.items())}
    t = ops_[operand]
    off = torch.empty(t.numel() + 1, device=dev)[1:].view(t.shape)
    off.copy_(t)
    shifted = dict(ops_, **{operand: off})
    args = [shifted[k] for k in ("q", "kv_grid", "kv_f")]
    out = cuda_fusion_attn.fusion_row_attention(*args, heads, dh)
    grads = cuda_fusion_attn.fusion_row_attention_backward(*args, shifted["do"], heads, dh)
    ref = cuda_fusion_attn.fusion_row_attention_reference(*args, heads, dh)
    ref_grads = cuda_fusion_attn.fusion_row_attention_backward_reference(*args, shifted["do"], heads, dh)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= F32_REL_L2 and _rel_all(grads, ref_grads) <= F32_REL_L2


def _block_case_f32(dev, b, n, d, heads, dh):
    x, types, w, dy = _block_case(dev, b, n, d, heads, dh)
    return x.float(), types, tuple(t.float() for t in w), dy.float()


_BLOCK_F32_SHAPES = [(2, 70, 64, 1, 64), (3, 100, 96, 3, 32), (2, 64, 128, 1, 128), (1, 33, 48, 2, 32),
                     (60, 640, 192, 3, 64), (2, 100, 1664, 13, 128), (2, 100, 64, 20, 64)]


@pytest.mark.parametrize("b,n,d,heads,dh", _BLOCK_F32_SHAPES)
def test_fused_block_f32_matches_plain(dev, b, n, d, heads, dh):
    """K6 / K6b's f32 instance within F32_REL_L2 of the f32 plain versions,
    at the pretraining shape and out to D = I = 1664."""
    x, types, w, dy = _block_case_f32(dev, b, n, d, heads, dh)
    y = cuda_block_attn.fused_block_attn(x, types, *w, heads, 3)
    ref = cuda_block_attn.fused_block_attn_reference(x, types, *w, heads, 3)
    grads = cuda_block_attn.fused_block_attn_backward(x, types, *w, dy, heads, 3)
    ref_grads = cuda_block_attn.fused_block_attn_backward_reference(x, types, *w, dy, heads, 3)
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and _rel(y, ref) <= F32_REL_L2
    assert [g.shape for g in grads] == [r.shape for r in ref_grads]
    for name, g, r in zip(("dx", "dg1", "dg2", "dwq", "dwkv", "dwo"), grads, ref_grads):
        assert _rel_all([g], [r]) <= F32_REL_L2, name


@pytest.mark.parametrize("b,n,d,heads,dh", _BLOCK_F32_SHAPES)
def test_fused_block_f32_runs_tensor_core_kernels_at_every_width(dev, b, n, d, heads, dh):
    """K6 / K6b's f32 instance runs its products on ffn_tf32_wide.cuh's
    3xTF32 wgmma kernels (the weights' and rows' split, the product
    launches) and no FFMA product, at every shape the plain comparison takes.
    Measured as chip_smoke.py's profiles are: after a warm-up, three calls a
    profile, up to three profiles."""
    from torch.profiler import ProfilerActivity, profile

    x, types, w, dy = _block_case_f32(dev, b, n, d, heads, dh)

    def run():
        cuda_block_attn.fused_block_attn(x, types, *w, heads, 3)
        cuda_block_attn.fused_block_attn_backward(x, types, *w, dy, heads, 3)

    run()
    torch.cuda.synchronize()
    kinds = ("ffn_tf32_wide_gemm", "ffn_tf32_wide_weights", "zorro_attention_f32", "simt_f32_ln_bwd")
    names = set()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                run()
            torch.cuda.synchronize()
        names |= {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
        if all(any(k in n_ for n_ in names) for k in kinds):
            break
    assert all(any(k in n_ for n_ in names) for k in kinds), names
    assert not any("simt_f32_product" in n_ for n_ in names), names


def test_fused_block_f32_backward_is_bitwise_the_same_run_to_run(dev):
    x, types, w, dy = _block_case_f32(dev, 60, 640, 192, 3, 64)
    first = cuda_block_attn.fused_block_attn_backward(x, types, *w, dy, 3, 3)
    second = cuda_block_attn.fused_block_attn_backward(x, types, *w, dy, 3, 3)
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dx", "dg1", "dg2", "dwq", "dwkv", "dwo"), first, second):
        assert torch.equal(a, b_), name


def test_f32_functions_launch_their_f32_instances(dev):
    """Every autograd Function on f32 tensors launches its f32 instance once
    forward and once backward, and nothing else."""
    ops.reset_kernel_launches()
    qkv = _randf(dev, 2, 70, 3 * 64).requires_grad_()
    cuda_attn.ZorroAttentionQKV.apply(qkv, 1).sum().backward()
    x = _randf(dev, 40, 64).requires_grad_()
    w = [_randf(dev, *s_, seed=i).requires_grad_() for i, s_ in enumerate([(64,), (192, 64), (64, 96)])]
    cuda_ffn.GegluFFN.apply(x, *w).sum().backward()
    wm = [_randf(dev, *s_, seed=i).requires_grad_() for i, s_ in enumerate([(128, 64), (128,), (32, 128), (32,)])]
    cuda_ffn.MlpFFN.apply(x, *wm).sum().backward()
    q, kvg, kvf = (_randf(dev, *s_, seed=i).requires_grad_() for i, s_ in enumerate([(1, 8, 64), (1, 24, 128),
                                                                                      (1, 8, 128)]))
    cuda_fusion_attn.FusionRowAttention.apply(q, kvg, kvf, 1, 64).sum().backward()
    xb, types, wb, _ = _block_case_f32(dev, 1, 64, 64, 1, 64)
    xb.requires_grad_()
    wb = [t.requires_grad_() for t in wb]
    cuda_block_attn.FusedBlockAttn.apply(xb, types, *wb, 1, 3).sum().backward()
    qp, kp, vp = (_randf(dev, 1, 64, 64, seed=s_).requires_grad_() for s_ in (70, 71, 72))
    cuda_attn.ZorroAttentionPacked.apply(qp, kp, vp, types, 1, 3).sum().backward()
    sparse_types = _sparse_types(dev, "single-type tiles", 1)
    qs = _randf(dev, 1, 512, 3 * 64, seed=73).requires_grad_()
    cuda_zorro_sparse.ZorroSparseAttentionQKV.apply(qs, sparse_types, 1, 3).sum().backward()
    counts = {k: n for k, n in ops.kernel_launches().items() if n}
    assert counts == {"zorro_attention_qkv/none_f32": 1, "zorro_attention_qkv/none_f32_backward": 1,
                      "fused_ffn/geglu_f32": 1, "fused_ffn/geglu_f32_backward": 1, "fused_ffn/mlp_f32": 1,
                      "fused_ffn/mlp_f32_backward": 1, "fusion_row_attention/fusion_row_f32": 1,
                      "fusion_row_attention/fusion_row_f32_backward": 1, "fused_block_attn/f32_forward": 1,
                      "fused_block_attn/f32_backward": 1, "zorro_attention_packed/zorro_f32": 1,
                      "zorro_attention_packed/zorro_f32_backward": 1, "zorro_sparse/f32_forward": 1,
                      "zorro_sparse/f32_backward": 1}, counts
    for t in (qkv, x, *w, *wm, q, kvg, kvf, xb, *wb, qp, kp, vp, qs):
        assert t.grad is not None and t.grad.dtype == torch.float32 and torch.isfinite(t.grad).all()


def test_f32_wrappers_refuse_mixed_dtypes_and_operands_off_16_bytes(dev):
    """The f32 instances take f32 operands only: a bf16 weight beside f32 x,
    or a K1 slab that starts off 16 bytes, raises."""
    x, types, w, _ = _block_case_f32(dev, 1, 64, 64, 1, 64)
    with pytest.raises(TypeError, match="float32"):
        cuda_block_attn.fused_block_attn(x, types, w[0].to(torch.bfloat16), *w[1:], 1, 3)
    with pytest.raises(TypeError, match="float32"):
        cuda_ffn.geglu_ffn(x[0], w[0], _randf(dev, 128, 64).to(torch.bfloat16), _randf(dev, 64, 64))
    qkv = _randf(dev, 1, 16, 3 * 64)
    off = torch.empty(qkv.numel() + 1, device=dev)[1:].view(qkv.shape)
    with pytest.raises(ValueError, match="16-byte"):
        cuda_attn.zorro_attention_qkv(off, 1)
    with pytest.raises(ValueError):
        cuda_fusion_attn.fusion_row_attention(_randf(dev, 1, 4, 64), _randf(dev, 1, 12, 128).to(torch.bfloat16),
                                              _randf(dev, 1, 4, 128), 1, 64)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,m,d,hidden,out_dim", [(3, 256, 256, 1024, 256), (3, 2048, 256, 1024, 256),
                                                  (2, 45, 64, 256, 48), (1, 300, 32, 128, 32),
                                                  (2, 130, 512, 256, 320)])
def test_mlp_tasks_kernel_matches_plain(dev, dtype, t, m, d, hidden, out_dim):
    """K2's MLP with a task axis, one launch for all T (two a task on the
    wide path, d = 512 here), against T calls of the plain MLP; each task
    with its own weights, so a wrong task offset shows."""
    rand = _randn if dtype == torch.bfloat16 else _randf
    x = rand(dev, t, m, d, seed=60)
    w1, b1 = rand(dev, t, hidden, d, scale=d ** -0.5, seed=61), rand(dev, t, hidden, scale=0.1, seed=62)
    w2, b2 = rand(dev, t, out_dim, hidden, scale=hidden ** -0.5, seed=63), rand(dev, t, out_dim, scale=0.1, seed=64)
    ops.reset_kernel_launches()
    out = cuda_ffn.mlp_ffn_tasks(x, w1, b1, w2, b2)
    ref = cuda_ffn.mlp_ffn_tasks_reference(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    key = "fused_ffn/mlp_tasks" + ("_f32" if dtype == torch.float32 else "")
    assert {k: n for k, n in ops.kernel_launches().items() if n} == {key: 1}
    bound = REL_L2 if dtype == torch.bfloat16 else 1e-5
    for i in range(t):
        assert _rel(out[i], ref[i]) <= bound, i


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mlp_tasks_backward_is_k2b_once_per_task(dev, dtype):
    rand = _randn if dtype == torch.bfloat16 else _randf
    t, m, d, hidden = 3, 256, 256, 1024
    x = rand(dev, t, m, d, seed=65).requires_grad_()
    w = [rand(dev, t, hidden, d, scale=d ** -0.5, seed=66), rand(dev, t, hidden, scale=0.1, seed=67),
         rand(dev, t, d, hidden, scale=hidden ** -0.5, seed=68), rand(dev, t, d, scale=0.1, seed=69)]
    w = [v.requires_grad_() for v in w]
    dy = rand(dev, t, m, d, seed=70)
    ops.reset_kernel_launches()
    cuda_ffn.mlp_ffn_tasks(x, *w).backward(dy)
    suffix = "_f32" if dtype == torch.float32 else ""
    assert {k: n for k, n in ops.kernel_launches().items() if n} == {
        f"fused_ffn/mlp_tasks{suffix}": 1, f"fused_ffn/mlp{suffix}_backward": t}
    for i in range(t):
        ref = cuda_ffn.mlp_ffn_backward_reference(x[i].detach(), *(v[i].detach() for v in w), dy[i])
        bound = REL_L2 if dtype == torch.bfloat16 else 1e-5
        for got, want in zip((x.grad[i], *(v.grad[i] for v in w)), ref):
            assert _rel(got, want) <= bound


def _op_cases(dev, dtype):
    """(operator name, arguments) at shapes the kernels take, forwards with
    inputs that require a gradient (their backward is exercised too)."""
    from incomplete_multimodal_fusion_tpu_torch.ops import library  # noqa: F401

    rand = _randn if dtype == torch.bfloat16 else _randf

    def r(*shape, seed, scale=1.0, grad=False):
        return rand(dev, *shape, scale=scale, seed=seed).requires_grad_(grad)

    b, n, heads, dh = 2, 70, 2, 32
    inner = heads * dh
    types = _types(dev, (20, 10, 20), 5, 15).expand(b, -1).contiguous()
    qkv = r(b, n, 3 * inner, seed=80, grad=True)
    o, lse = cuda_attn.zorro_attention_qkv(qkv.detach(), heads, types, 3, return_lse=True)
    do = r(b, n, inner, seed=81)
    q, k, v = (r(b, n, inner, seed=82 + i, grad=True) for i in range(3))
    op_, lsep = cuda_attn.zorro_attention_packed(q.detach(), k.detach(), v.detach(), types, heads, 3,
                                                 return_lse=True)
    stypes = _sparse_types(dev, "single-type tiles", 1)
    sq = r(1, stypes.shape[1], 3 * 64, seed=85, grad=True)
    so, slse = cuda_zorro_sparse.zorro_sparse_attention_qkv(sq.detach(), stypes, 1, 3, return_lse=True)
    x = r(70, 64, seed=86, grad=True)
    gw = [r(64, seed=87, scale=0.1), r(256, 64, seed=88, scale=0.125), r(64, 128, seed=89, scale=0.09)]
    gw[0] = (gw[0] + 1.0).detach().requires_grad_()
    gw = [w.detach().requires_grad_() for w in gw]
    mw = [r(128, 64, seed=90, scale=0.125, grad=True), r(128, seed=91, scale=0.1, grad=True),
          r(48, 128, seed=92, scale=0.09, grad=True), r(48, seed=93, scale=0.1, grad=True)]
    xt = r(3, 70, 64, seed=94, grad=True)
    tw = [r(3, 128, 64, seed=95, scale=0.125, grad=True), r(3, 128, seed=96, scale=0.1, grad=True),
          r(3, 48, 128, seed=97, scale=0.09, grad=True), r(3, 48, seed=98, scale=0.1, grad=True)]
    fq, fg, ff = r(b, 20, inner, seed=99, grad=True), r(b, 60, 2 * inner, seed=100, grad=True), \
        r(b, 20, 2 * inner, seed=101, grad=True)
    bx = r(b, n, 64, seed=102, grad=True)
    bw = [(r(64, seed=103, scale=0.1) + 1.0).detach().requires_grad_(),
          (r(64, seed=104, scale=0.1) + 1.0).detach().requires_grad_(), r(inner, 64, seed=105, scale=0.125, grad=True),
          r(2 * inner, 64, seed=106, scale=0.125, grad=True), r(64, inner, seed=107, scale=0.125, grad=True)]
    d = [t.detach() for t in (x, *gw)]
    scale = dh ** -0.5
    return [
        ("zorro_attention_qkv", (qkv, types, heads, 3, scale, True)),
        ("zorro_attention_qkv", (qkv, None, heads, None, scale, True)),
        ("zorro_attention_qkv_backward", (qkv.detach(), types, o, lse, do, heads, 3, scale)),
        ("zorro_attention_packed", (q, k, v, types, heads, 3, scale, True)),
        ("zorro_attention_packed_backward", (q.detach(), k.detach(), v.detach(), types, op_, lsep, do, heads, 3,
                                             scale)),
        ("zorro_sparse_attention_qkv", (sq, stypes, 1, 3, 64 ** -0.5, True)),
        ("zorro_sparse_attention_qkv_backward", (sq.detach(), stypes, so, slse, r(*so.shape, seed=108), 1, 3,
                                                 64 ** -0.5)),
        ("geglu_ffn", (x, *gw)),
        ("geglu_ffn_backward", (*d, r(70, 64, seed=109))),
        ("mlp_ffn", (x, *mw)),
        ("mlp_ffn_backward", (x.detach(), *(w.detach() for w in mw), r(70, 48, seed=110))),
        ("mlp_ffn_tasks", (xt, *tw)),
        ("fusion_row_attention", (fq, fg, ff, heads, dh)),
        ("fusion_row_attention_backward", (fq.detach(), fg.detach(), ff.detach(), r(b, 20, inner, seed=111),
                                           heads, dh)),
        ("fused_block_attn", (bx, types, *bw, heads, 3)),
        ("fused_block_attn_backward", (bx.detach(), types, *(w.detach() for w in bw), r(b, n, 64, seed=112),
                                       heads, 3)),
    ]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_opcheck_on_the_card(dev, dtype):
    """torch.library.opcheck of every operator on CUDA tensors: the schema,
    the fake implementation against the kernel's outputs, the autograd
    registration and AOT dispatch (the kernels' outputs bitwise the same
    eager and traced)."""
    from incomplete_multimodal_fusion_tpu_torch.ops import library

    for name, args in _op_cases(dev, dtype):
        torch.library.opcheck(library.operators()[name], args)


def test_export_round_trip_on_the_card(dev):
    """A small MultiMAE at widths the kernels take (bf16), exported on the
    card and reloaded: the reloaded program launches the kernels a forward
    as the live model does, and answers bitwise as the live closure."""
    import numpy as np

    from incomplete_multimodal_fusion_tpu_torch import serving
    from incomplete_multimodal_fusion_tpu_torch.models.multimae import MultiMAE

    doms = ("s1", "s2", "dem")
    model = MultiMAE(in_domains=doms, out_domains=doms, image_size=64, patch_size=16, dim_tokens=64, depth=2,
                     dim_head=32, heads=2, num_fusion_tokens=16, decoder_dim=64, decoder_depth=1,
                     decoder_num_heads=2)
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(dev).to(torch.bfloat16).eval()
    serve = serving.load_exported(serving.export_infer(model, None, batch=2, image_size=64))
    rng = np.random.default_rng(0)
    args = [rng.standard_normal((2, 64, 64, c)).astype(np.float32) for c in (1, 3, 1)]
    args += [np.full((2, 16), int(d == "s2"), np.int32) for d in doms]
    ops.reset_kernel_launches()
    out = serve(*args)
    torch.cuda.synchronize()
    counts = {k: n for k, n in ops.kernel_launches().items() if n}
    ops.reset_kernel_launches()
    live = serving.infer_closure(model, None, doms)(*args)
    torch.cuda.synchronize()
    assert counts == {k: n for k, n in ops.kernel_launches().items() if n} == {
        "zorro_attention_qkv/zorro": 2, "zorro_attention_qkv/none": 3, "fused_ffn/geglu": 4, "fused_ffn/mlp": 3,
        "fusion_row_attention/fusion_row": 2}
    for d in doms:
        assert torch.equal(out["preds"][d], live["preds"][d]), d
    assert torch.equal(out["pooled"], live["pooled"])


def _gathered_types(dev, b=4, e=384, f=256):
    """K1's PAD-coded types over the 2E layout of the lstm and crossattn_v1
    modes (models/multimae.gathered_layout): rows keeping 384, 300, 256 and
    128 of 768 tokens, a modality dropped whole in each row that keeps
    fewer than E, so the padding sits at [num_visible, E) and again at
    [E + num_visible, 2E), mid-sequence."""
    from incomplete_multimodal_fusion_tpu_torch.models.multimae import gathered_layout
    from incomplete_multimodal_fusion_tpu_torch.ops import masking

    g = torch.Generator().manual_seed(5)
    flat = torch.ones(b, 3 * f, dtype=torch.long)
    for row in range(b):
        keep = (384, 300, 256, 128)[row % 4]
        allowed = torch.arange(3 * f)
        if keep < e:
            allowed = allowed[(allowed // f) != row % 3]
        flat[row, allowed[torch.randperm(allowed.numel(), generator=g)[:keep]]] = 0
    mi = masking.mask_info_from_flat_mask(flat.to(dev), ("s1", "s2", "dem"), (f,) * 3, e)
    return gathered_layout(mi, e, f, 3).kernel_types


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_zorro_on_the_gathered_2e_layout(dev, dtype):
    """K1 / K1b at N = 768 where the PAD slots sit mid-sequence: query
    tiles of the fusion half meet key tiles that are PAD in the middle of
    the sequence (the finite NEG_INF, no NaN), against the plain versions
    at the bf16 and f32 bounds."""
    types = _gathered_types(dev)
    assert (types[1, 300:384] == cuda_attn.PAD_TYPE).all() and (types[1, 384:684] == 3).all()
    if dtype == torch.float32:
        _zorro_f32_case(dev, _randf(dev, 4, 768, 3 * 192, seed=6), 3, types)
        return
    qkv = _randn(dev, 4, 768, 3 * 192, seed=6)
    out = cuda_attn.zorro_attention_qkv(qkv, 3, types, 3)
    ref = cuda_attn.zorro_attention_qkv_reference(qkv, 3, types, 3)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and _rel(out, ref) <= REL_L2
    _zorro_backward_case(dev, qkv, 3, types)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 60])
def test_fusion_row_with_the_quadruplets_four_slots(dev, dtype, b):
    """K3 / K3b at T = 4 (the quadruplet's SLOTS(4) instance) at F = 256, 3
    heads of 64, against the plain versions at the bf16 and f32 bounds."""
    rand, bound = (_randn, REL_L2) if dtype == torch.bfloat16 else (_randf, F32_REL_L2)
    f, inner = 256, 192
    q, kvg, kvf = rand(dev, b, f, inner, seed=31), rand(dev, b, 4 * f, 2 * inner, seed=32), \
        rand(dev, b, f, 2 * inner, seed=33)
    do = rand(dev, b, f, inner, seed=34)
    out = cuda_fusion_attn.fusion_row_attention(q, kvg, kvf, 3, 64)
    ref = cuda_fusion_attn.fusion_row_attention_reference(q, kvg, kvf, 3, 64)
    grads = cuda_fusion_attn.fusion_row_attention_backward(q, kvg, kvf, do, 3, 64)
    ref_grads = cuda_fusion_attn.fusion_row_attention_backward_reference(q, kvg, kvf, do, 3, 64)
    torch.cuda.synchronize()
    assert out.dtype == dtype and _rel(out, ref) <= bound
    assert _rel_all(grads, ref_grads) <= bound
