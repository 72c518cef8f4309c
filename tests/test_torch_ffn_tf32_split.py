"""The arithmetic of K2 / K2b's f32 instance (csrc/ffn_tf32.cuh), emulated
in plain PyTorch on the CPU and held against the JAX package: each f32
operand of a product split into two TF32 parts as the kernel splits it
(``cvt.rna``: hi = rna(x), lo = rna(x - hi)), each k-step of 8 the three
TF32 products hi lo, lo hi, hi hi, each added by the tensor core with its
f32 sum rounded toward zero, and each unit of 32 contraction columns (4
k-steps) summed in a fresh accumulator that is then added in f32, rounded
to nearest -- along the hidden units chunk by chunk (the GEGLU backward's
dxn a chunk's val units, then its gate units), along the rows for the
weight gradients in ranges whose partials are summed in order. The GEGLU
and MLP forwards and every gradient built from it stay within the card's
bound (rel-L2 1e-5, chip_smoke.py's F32_REL_L2) of JAX in f32:
``geglu_ffn_xla`` / ``mlp_ffn_xla``, the Pallas kernels in interpret mode,
and ``jax.vjp`` of both, at small widths and a ragged M. Two controls: one
TF32 product a multiplication misses that bound, and a weight gradient
summed in one accumulator rounded toward zero over many rows strays
further from f64 than the fresh accumulators. The kernel itself runs only
on the card, where tests/test_torch_cuda_kernels.py and chip_smoke.py hold
it against the f32 plain version at the same bound; this file models its
arithmetic and is no second plain version."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu.ops import pallas_ffn as pf

F32_REL_L2 = 1e-5  # chip_smoke.py's bound for the f32 instances against their f32 plain versions
HC = 32  # hidden units a chunk; contraction columns a unit
RANGE = 1024  # rows a weight gradient's range (one partial each)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the f32 bit pattern: ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def rz(x: torch.Tensor) -> torch.Tensor:
    """f64 values rounded toward zero to f32, as the tensor core rounds its sum."""
    f = x.to(torch.float32)
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def pad_k(a: torch.Tensor, b: torch.Tensor):
    """a [M, K], b [K, N] with K zero-padded to a multiple of the unit."""
    k = a.shape[1]
    pad = -k % HC
    return torch.nn.functional.pad(a, (0, pad)), torch.nn.functional.pad(b, (0, 0, 0, pad))


def mm3(a: torch.Tensor, b: torch.Tensor, fresh: bool = True) -> torch.Tensor:
    """a @ b as the kernel computes it (module docstring). fresh=False: one
    accumulator over the whole contraction, the control's."""
    a, b = pad_k(a, b)
    (ah, al), (bh, bl) = (tuple(t.double() for t in split(v)) for v in (a, b))
    total = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for s0 in range(0, a.shape[1], HC):
        acc = torch.zeros_like(total) if fresh else total
        for k0 in range(s0, s0 + HC, 8):
            ks = slice(k0, k0 + 8)
            for x, y in ((ah, bl), (al, bh), (ah, bh)):
                acc = rz(acc.double() + x[:, ks] @ y[ks])
        total = total + acc if fresh else acc
    return total


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with one TF32 product: the control."""
    return tf32(a) @ tf32(b)


def rows_mm(xt: torch.Tensor, y: torch.Tensor, mm) -> torch.Tensor:
    """xt [P, M] @ y [M, Q] over the rows in ranges of RANGE rows, the
    ranges' partials summed in order (the weight gradients)."""
    total = torch.zeros(xt.shape[0], y.shape[1], dtype=torch.float32)
    for r0 in range(0, xt.shape[1], RANGE):
        total = total + mm(xt[:, r0:r0 + RANGE], y[r0:r0 + RANGE])
    return total


def ln(x, gamma):
    mean = x.mean(-1, keepdim=True)
    rstd = 1.0 / torch.sqrt(((x - mean) ** 2).mean(-1, keepdim=True) + 1e-5)
    z = (x - mean) * rstd
    return z, rstd, z * gamma


def gelu_parts(g):
    cdf = 0.5 * (1.0 + torch.erf(g * (1.0 / math.sqrt(2.0))))
    return g * cdf, cdf + g * torch.exp(-0.5 * g * g) * (1.0 / math.sqrt(2.0 * math.pi))


def by_chunks(*mats):
    """Matrices along the hidden units (columns), zero-padded to whole
    chunks and interleaved a chunk of each at a time."""
    padded = [torch.nn.functional.pad(m, (0, -m.shape[1] % HC)) for m in mats]
    return torch.cat([p[:, c:c + HC] for c in range(0, padded[0].shape[1], HC) for p in padded], dim=1)


def geglu_forward(x, gamma, w_in, w_out, mm):
    """Port layouts: w_in [2I, d], w_out [d, I]."""
    inner = w_out.shape[1]
    u = mm(ln(x, gamma)[2], w_in.t())
    a = u[:, :inner] * gelu_parts(u[:, inner:])[0]
    return mm(a, w_out.t())


def geglu_backward(x, gamma, w_in, w_out, dy, mm):
    inner = w_out.shape[1]
    z, rstd, xn = ln(x, gamma)
    u = mm(xn, w_in.t())
    val, gate = u[:, :inner], u[:, inner:]
    gv, gd = gelu_parts(gate)
    da = mm(dy, w_out)
    du_v, du_g = da * gv, da * val * gd
    dxn = mm(by_chunks(du_v, du_g), by_chunks(w_in[:inner].t(), w_in[inner:].t()).t())
    dw_in = rows_mm(torch.cat([du_v, du_g], dim=1).t(), xn, mm)
    dw_out = rows_mm((val * gv).t(), dy, mm).t()
    dz = dxn * gamma
    dx = (dz - dz.mean(-1, keepdim=True) - z * (dz * z).mean(-1, keepdim=True)) * rstd
    return dx, (dxn * z).sum(0), dw_in, dw_out


def mlp_forward(x, w1, b1, w2, b2, mm):
    """Port layouts: w1 [H, d], w2 [O, H]."""
    return mm(gelu_parts(mm(x, w1.t()) + b1)[0], w2.t()) + b2


def mlp_backward(x, w1, b1, w2, b2, dy, mm):
    h = mm(x, w1.t()) + b1
    gv, gd = gelu_parts(h)
    dh = mm(dy, w2) * gd
    return mm(dh, w1), rows_mm(dh.t(), x, mm), dh.sum(0), rows_mm(gv.t(), dy, mm).t(), dy.sum(0)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


GEGLU = {"m256_d32_i48": (256, 32, 48), "m384_d64_i80": (384, 64, 80), "m200_ragged_d48_i40": (200, 48, 40)}
MLP = {"m256_d32_h128_o48": (256, 32, 128, 48), "m384_d64_h96_o32": (384, 64, 96, 32),
       "m130_ragged_d32_h64_o32": (130, 32, 64, 32)}


def geglu_inputs(case, seed):
    """Port-layout operands (numpy, f32) and dy."""
    m, d, inner = GEGLU[case]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    w_in = (rng.standard_normal((2 * inner, d)) * d ** -0.5).astype(np.float32)
    w_out = (rng.standard_normal((d, inner)) * inner ** -0.5).astype(np.float32)
    dy = rng.standard_normal((m, d)).astype(np.float32)
    return (x, gamma, w_in, w_out), dy


def mlp_inputs(case, seed):
    m, d, hid, out = MLP[case]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    w1 = (rng.standard_normal((hid, d)) * d ** -0.5).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(hid)).astype(np.float32)
    w2 = (rng.standard_normal((out, hid)) * hid ** -0.5).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(out)).astype(np.float32)
    dy = rng.standard_normal((m, out)).astype(np.float32)
    return (x, w1, b1, w2, b2), dy


def jax_geglu_args(x, gamma, w_in, w_out):
    """JAX's layouts: gamma [1, d], w_in [d, 2I], w_out [I, d]."""
    return jnp.asarray(x), jnp.asarray(gamma[None]), jnp.asarray(w_in.T), jnp.asarray(w_out.T)


def jax_mlp_args(x, w1, b1, w2, b2):
    return jnp.asarray(x), jnp.asarray(w1.T), jnp.asarray(b1[None]), jnp.asarray(w2.T), jnp.asarray(b2[None])


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


@pytest.mark.parametrize("case", sorted(GEGLU))
def test_3xtf32_geglu_forward_matches_jax(case):
    args, _ = geglu_inputs(case, 0)
    y = geglu_forward(*(torch.from_numpy(a) for a in args), mm3)
    refs = geglu_references(args, np.zeros_like(args[0]))
    assert len(refs) == (1 if "ragged" in case else 2)
    for name, want, _ in refs:
        assert rel(y, want) <= F32_REL_L2, name


@pytest.mark.parametrize("case", sorted(GEGLU))
def test_3xtf32_geglu_backward_matches_jax_vjp(case):
    args, dy = geglu_inputs(case, 1)
    got = geglu_backward(*(torch.from_numpy(a) for a in args), torch.from_numpy(dy), mm3)
    for name, _, want in geglu_references(args, dy):
        for g, w, what in zip(got, want, ("dx", "dgamma", "dW_in", "dW_out")):
            assert g.shape == w.shape and rel(g, w) <= F32_REL_L2, (name, what)


@pytest.mark.parametrize("case", sorted(MLP))
def test_3xtf32_mlp_forward_matches_jax(case):
    args, _ = mlp_inputs(case, 2)
    y = mlp_forward(*(torch.from_numpy(a) for a in args), mm3)
    refs = mlp_references(args, np.zeros((args[0].shape[0], args[3].shape[0]), np.float32))
    assert len(refs) == (1 if "ragged" in case else 2)
    for name, want, _ in refs:
        assert rel(y, want) <= F32_REL_L2, name


@pytest.mark.parametrize("case", sorted(MLP))
def test_3xtf32_mlp_backward_matches_jax_vjp(case):
    args, dy = mlp_inputs(case, 3)
    got = mlp_backward(*(torch.from_numpy(a) for a in args), torch.from_numpy(dy), mm3)
    for name, _, want in mlp_references(args, dy):
        for g, w, what in zip(got, want, ("dx", "dW1", "db1", "dW2", "db2")):
            assert g.shape == w.shape and rel(g, w) <= F32_REL_L2, (name, what)


@pytest.mark.parametrize("mode", ["geglu", "mlp"])
def test_one_tf32_product_misses_the_bound(mode):
    """The control: the forward and every gradient that a product reaches
    with one TF32 product a multiplication, against JAX's XLA version, all
    above 1e-5 (the MLP's db2, the column sums of dy, has no product)."""
    if mode == "geglu":
        args, dy = geglu_inputs("m256_d32_i48", 1)
        t = [torch.from_numpy(a) for a in args]
        y, got = geglu_forward(*t, mm1), geglu_backward(*t, torch.from_numpy(dy), mm1)
        (_, want_y, want), = geglu_references(args, dy)[:1]
    else:
        args, dy = mlp_inputs("m256_d32_h128_o48", 3)
        t = [torch.from_numpy(a) for a in args]
        y, got = mlp_forward(*t, mm1), mlp_backward(*t, torch.from_numpy(dy), mm1)[:4]
        (_, want_y, want), = mlp_references(args, dy)[:1]
    assert rel(y, want_y) > F32_REL_L2
    for g, w in zip(got, want):
        assert rel(g, w) > F32_REL_L2


def test_one_round_toward_zero_accumulator_over_many_rows_strays_further():
    """The other control: a weight gradient a^T dy over 4096 rows (a =
    gelu(h), as the MLP's dW2 sums it) in one accumulator that the tensor
    core rounds toward zero at every wgmma strays further from f64 than the
    fresh accumulator a unit, and past the bound."""
    rng = np.random.default_rng(4)
    a = gelu_parts(torch.from_numpy(rng.standard_normal((4096, 32)).astype(np.float32)))[0]
    dy = torch.from_numpy(rng.standard_normal((4096, 48)).astype(np.float32))
    exact = a.double().t() @ dy.double()
    fresh = rel(mm3(a.t(), dy), exact)
    single = rel(mm3(a.t(), dy, fresh=False), exact)
    assert single > 2 * fresh and single > F32_REL_L2
    assert fresh <= F32_REL_L2 / 10


def test_the_sum_rounds_toward_zero_and_the_split_is_cvt_rna():
    one = 2.0 ** -23  # an f32 ulp in [1, 2)
    x = torch.tensor([1 + 0.75 * one, -(1 + 0.75 * one), 1 + 0.25 * one, 3.0], dtype=torch.float64)
    assert rz(x).tolist() == [1.0, -1.0, 1.0, 3.0]
    ulp = 2.0 ** -10  # a TF32 ulp in [1, 2)
    y = torch.tensor([1 + 0.5 * ulp, -(1 + 0.5 * ulp), 1 + 0.49 * ulp], dtype=torch.float32)
    assert tf32(y).tolist() == [1 + ulp, -(1 + ulp), 1.0]
