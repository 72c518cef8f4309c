"""The arithmetic of K2 / K2b's f32 wide path (csrc/ffn_tf32_wide.cuh: d or
the output width past 256, the `base` and `large` widths), emulated in
plain PyTorch on the CPU in the kernels' order and held against the JAX
package. Each product is the 3xTF32 product of tests/test_torch_ffn_tf32_split.py
(cvt.rna splits, hi lo + lo hi + hi hi, each wgmma's sum rounded toward
zero, a fresh accumulator a window of 32 contraction columns added in f32),
taken where the wide path takes it:

  * the hidden pass: u = xn W_in^T over windows of d, a = val gelu(gate)
    (MLP gelu(h + b1)) into a workspace zero-padded to the hidden width hp;
  * the output product over the windows of hp, split at small M into
    ranges whose f32 partials are summed in order (+ b2), as the plan of
    ffn_tf32_wide.cuh splits them on a card of 132 SMs;
  * the backward: u and da = dy W_out recomputed, du = [da gelu(gate), da val
    gelu'(gate)] zero-padded to [2 hp]; dxn = du W_in over the windows of
    2 hp (all val windows, then all gate windows); the weight gradients
    over ranges of rows, each range's partial summed in order.

Forward and every gradient at d > 256 with small and ragged M, inner widths
that are not multiples of 8, `base`'s own widths, against JAX in f32
(``geglu_ffn_xla`` / ``mlp_ffn_xla``, the Pallas kernels in interpret mode
where their row tile divides M, and ``jax.vjp`` of both) at rel-L2 1e-5
(chip_smoke.py's F32_REL_L2). The control: one TF32 product a
multiplication in the same order misses that bound. The kernels run only
on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu.ops import pallas_ffn as pf
from tests.test_torch_ffn_tf32_split import F32_REL_L2, gelu_parts, jax_geglu_args, jax_mlp_args, ln, mm1, mm3, rel

KU = 32  # contraction columns a window
WB = 128  # rows and columns of a tile
SMS = 132  # an H100's SMs: the plans below are the card's


def hid_pad(hid: int, geglu: bool) -> int:
    """ffn_tf32_wide.cuh wide_hp: whole blocks of 64 (GEGLU) or 128 (MLP) hidden units."""
    hw = 64 if geglu else 128
    return -(-hid // hw) * hw


def fwd_splits(m: int, d_out: int, hp: int) -> int:
    """ffn_tf32_wide.cuh wide_fwd_plan: the output product's ranges."""
    tiles, windows = -(-m // WB) * -(-d_out // WB), hp // KU
    if 2 * tiles >= SMS:
        return 1
    want = min(SMS // tiles, windows)
    wps = -(-windows // want)
    return -(-windows // wps)


def bwd_splits(m: int, d: int, hp: int, d_out: int, geglu: bool) -> int:
    """ffn_tf32_wide.cuh wide_bwd_splits: the weight gradients' row ranges."""
    nh = (2 if geglu else 1) * hp
    tiles = -(-d // WB) * -(-nh // WB) + -(-d_out // WB) * -(-hp // WB)
    windows = -(-m // KU)
    s = max(-(-windows // 128), -(-SMS // tiles))
    s = min(s, 64, windows)
    wps = -(-windows // s)
    return -(-windows // wps)


def ranges(k: int, splits: int):
    """The contraction's ranges of whole windows, as wide_gemm cuts them."""
    windows = -(-k // KU)
    wps = -(-windows // max(1, min(splits, windows)))
    return [(w0 * KU, min(k, (w0 + wps) * KU)) for w0 in range(0, windows, wps)]


def split_mm(a, b, splits: int, mm):
    """a [M, K] @ b [K, N] over the ranges' partials, summed in order."""
    total = None
    for k0, k1 in ranges(a.shape[1], splits):
        part = mm(a[:, k0:k1], b[k0:k1])
        total = part if total is None else total + part
    return total


def pad_cols(t, width: int):
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def geglu_forward(x, gamma, w_in, w_out, mm):
    """Port layouts: w_in [2I, d], w_out [d, I]."""
    m, d = x.shape
    inner = w_out.shape[1]
    hp = hid_pad(inner, True)
    u = mm(ln(x, gamma)[2], w_in.t())
    a = pad_cols(u[:, :inner] * gelu_parts(u[:, inner:])[0], hp)
    return split_mm(a, pad_cols(w_out, hp).t(), fwd_splits(m, d, hp), mm)


def geglu_backward(x, gamma, w_in, w_out, dy, mm):
    m, d = x.shape
    inner = w_out.shape[1]
    hp = hid_pad(inner, True)
    z, rstd, xn = ln(x, gamma)
    u = mm(xn, w_in.t())
    val, gate = u[:, :inner], u[:, inner:]
    gv, gd = gelu_parts(gate)
    da = mm(dy, w_out)
    du = torch.cat([pad_cols(da * gv, hp), pad_cols(da * val * gd, hp)], dim=1)  # [M, 2 hp]
    w_in_t = torch.cat([pad_cols(w_in[:inner].t(), hp), pad_cols(w_in[inner:].t(), hp)], dim=1)  # [d, 2 hp]
    dxn = mm(du, w_in_t.t())
    s = bwd_splits(m, d, hp, d, True)
    dw_in_t = split_mm(xn.t(), du, s, mm)  # [d, 2 hp], stored as [2I, d]
    dw_in = torch.cat([dw_in_t[:, :inner].t(), dw_in_t[:, hp:hp + inner].t()])
    dw_out = split_mm(dy.t(), pad_cols(val * gv, hp), s, mm)[:, :inner]  # [d, I]
    dz = dxn * gamma
    dx = (dz - dz.mean(-1, keepdim=True) - z * (dz * z).mean(-1, keepdim=True)) * rstd
    return dx, (dxn * z).sum(0), dw_in, dw_out


def mlp_forward(x, w1, b1, w2, b2, mm):
    """Port layouts: w1 [H, d], w2 [O, H]."""
    m, hid, d_out = x.shape[0], w1.shape[0], w2.shape[0]
    hp = hid_pad(hid, False)
    a = pad_cols(gelu_parts(mm(x, w1.t()) + b1)[0], hp)
    return split_mm(a, pad_cols(w2, hp).t(), fwd_splits(m, d_out, hp), mm) + b2


def mlp_backward(x, w1, b1, w2, b2, dy, mm):
    m, d = x.shape
    hid, d_out = w1.shape[0], w2.shape[0]
    hp = hid_pad(hid, False)
    h = mm(x, w1.t()) + b1
    gv, gd = gelu_parts(h)
    dh = pad_cols(mm(dy, w2) * gd, hp)
    dx = mm(dh, pad_cols(w1.t(), hp).t())
    s = bwd_splits(m, d, hp, d_out, False)
    dw1 = split_mm(x.t(), dh, s, mm)[:, :hid].t()
    dw2 = split_mm(dy.t(), pad_cols(gv, hp), s, mm)[:, :hid]
    return dx, dw1, dh[:, :hid].sum(0), dw2, dy.sum(0)


GEGLU = {"m256_d288_i90": (256, 288, 90), "m65_ragged_d320_i100": (65, 320, 100),
         "m65_ragged_base_d768_i2048": (65, 768, 2048)}
MLP = {"m256_d272_h200_o288": (256, 272, 200, 288), "m130_ragged_d320_h144_o272": (130, 320, 144, 272)}


def geglu_inputs(case, seed):
    m, d, inner = GEGLU[case]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    w_in = (rng.standard_normal((2 * inner, d)) * d ** -0.5).astype(np.float32)
    w_out = (rng.standard_normal((d, inner)) * inner ** -0.5).astype(np.float32)
    return (x, gamma, w_in, w_out), rng.standard_normal((m, d)).astype(np.float32)


def mlp_inputs(case, seed):
    m, d, hid, out = MLP[case]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    w1 = (rng.standard_normal((hid, d)) * d ** -0.5).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(hid)).astype(np.float32)
    w2 = (rng.standard_normal((out, hid)) * hid ** -0.5).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(out)).astype(np.float32)
    return (x, w1, b1, w2, b2), rng.standard_normal((m, out)).astype(np.float32)


def geglu_references(args, dy):
    """(name, forward, (dx, dgamma, dW_in, dW_out) in port layouts) of JAX's
    XLA version and, where its row tile divides M, the Pallas kernel in
    interpret mode."""
    fns = [("xla", pf.geglu_ffn_xla)] + ([("pallas", pf.geglu_ffn)] if pf._row_tile(args[0].shape[0]) else [])
    out = []
    for name, fn in fns:
        y, pullback = jax.vjp(fn, *jax_geglu_args(*args))
        dx, dgamma, dw_in, dw_out = (np.asarray(g) for g in pullback(jnp.asarray(dy)))
        out.append((name, np.asarray(y), (dx, dgamma[0], dw_in.T, dw_out.T)))
    return out


def mlp_references(args, dy):
    fns = [("xla", pf.mlp_ffn_xla)] + ([("pallas", pf.mlp_ffn)]
                                       if pf._row_tile(args[0].shape[0], args[1].shape[0] // 2) else [])
    out = []
    for name, fn in fns:
        y, pullback = jax.vjp(fn, *jax_mlp_args(*args))
        dx, dw1, db1, dw2, db2 = (np.asarray(g) for g in pullback(jnp.asarray(dy)))
        out.append((name, np.asarray(y), (dx, dw1.T, db1[0], dw2.T, db2[0])))
    return out


def test_the_plans_split_where_the_card_would():
    """The emulated plans are the kernels': `base`'s serving rows split the
    output product (M = 1024: 8 x 6 tiles, 2 ranges; M = 65: 22), its
    training rows do not; the weight gradients at M = 8192 take 2 ranges."""
    hp = hid_pad(2048, True)
    assert (fwd_splits(1024, 768, hp), fwd_splits(65, 768, hp), fwd_splits(8192, 768, hp)) == (2, 22, 1)
    assert bwd_splits(8192, 768, hp, 768, True) == 2 and bwd_splits(65, 768, hp, 768, True) == 1
    assert hid_pad(2730, True) == 2752 and hid_pad(200, False) == 256
    assert ranges(2048, 2) == [(0, 1024), (1024, 2048)] and ranges(96, 22) == [(0, 32), (32, 64), (64, 96)]


@pytest.mark.parametrize("case", sorted(GEGLU))
def test_wide_geglu_forward_matches_jax(case):
    args, _ = geglu_inputs(case, 0)
    y = geglu_forward(*(torch.from_numpy(a) for a in args), mm3)
    refs = geglu_references(args, np.zeros_like(args[0]))
    assert len(refs) == (1 if "ragged" in case else 2)
    for name, want, _ in refs:
        assert rel(y, want) <= F32_REL_L2, name


@pytest.mark.parametrize("case", sorted(GEGLU))
def test_wide_geglu_backward_matches_jax_vjp(case):
    args, dy = geglu_inputs(case, 1)
    got = geglu_backward(*(torch.from_numpy(a) for a in args), torch.from_numpy(dy), mm3)
    for name, _, want in geglu_references(args, dy):
        for g, w, what in zip(got, want, ("dx", "dgamma", "dW_in", "dW_out")):
            assert g.shape == w.shape and rel(g, w) <= F32_REL_L2, (name, what)


@pytest.mark.parametrize("case", sorted(MLP))
def test_wide_mlp_forward_matches_jax(case):
    args, _ = mlp_inputs(case, 2)
    y = mlp_forward(*(torch.from_numpy(a) for a in args), mm3)
    refs = mlp_references(args, np.zeros((args[0].shape[0], args[3].shape[0]), np.float32))
    assert len(refs) == (1 if "ragged" in case else 2)
    for name, want, _ in refs:
        assert rel(y, want) <= F32_REL_L2, name


@pytest.mark.parametrize("case", sorted(MLP))
def test_wide_mlp_backward_matches_jax_vjp(case):
    args, dy = mlp_inputs(case, 3)
    got = mlp_backward(*(torch.from_numpy(a) for a in args), torch.from_numpy(dy), mm3)
    for name, _, want in mlp_references(args, dy):
        for g, w, what in zip(got, want, ("dx", "dW1", "db1", "dW2", "db2")):
            assert g.shape == w.shape and rel(g, w) <= F32_REL_L2, (name, what)


@pytest.mark.parametrize("mode", ["geglu", "mlp"])
def test_one_tf32_product_in_the_wide_order_misses_the_bound(mode):
    """The control: the same order with one TF32 product a multiplication,
    against JAX's XLA version: the forward and every gradient a product
    reaches above 1e-5 (the MLP's db2, dy's column sums, has none)."""
    if mode == "geglu":
        args, dy = geglu_inputs("m65_ragged_d320_i100", 1)
        t = [torch.from_numpy(a) for a in args]
        y, got = geglu_forward(*t, mm1), geglu_backward(*t, torch.from_numpy(dy), mm1)
        (_, want_y, want), = geglu_references(args, dy)
    else:
        args, dy = mlp_inputs("m130_ragged_d320_h144_o272", 3)
        t = [torch.from_numpy(a) for a in args]
        y, got = mlp_forward(*t, mm1), mlp_backward(*t, torch.from_numpy(dy), mm1)[:4]
        (_, want_y, want), = mlp_references(args, dy)
    assert rel(y, want_y) > F32_REL_L2
    for g, w in zip(got, want):
        assert rel(g, w) > F32_REL_L2
