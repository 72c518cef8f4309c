"""The arithmetic of K1 / K1b's f32 instance (csrc/zorro_attention_f32.cuh),
emulated in plain PyTorch on the CPU and held against the JAX package: each
f32 operand of a product split into two TF32 parts as the kernel splits it
(``cvt.rna``: round to nearest, ties away from zero, to 10 mantissa bits;
hi = rna(x), lo = rna(x - hi)), and every product the three TF32 products
hi hi + hi lo + lo hi, summed in f32. The forward (O, lse) and the backward
(dq, dk, dv) built from it stay within the card's bound (rel-L2 1e-5,
chip_smoke.py's F32_REL_L2) of JAX's f32 attention -- `_packed_qkv_xla`, the
Pallas kernel in interpret mode, `jax.vjp` of the former, and
`small_attention_qkv_xla` for the decoder's unmasked mode -- on zorro masks
with padding, fusion rows, rows whose first key tiles are all masked, a
ragged N and dh 32, 64 and 128. The control: the same emulation with one
TF32 product a multiplication misses that bound, so the bound tells the two
designs apart. The kernel itself runs only on the card, where
tests/test_torch_cuda_kernels.py and chip_smoke.py hold it against the f32
plain version at the same bound; this file models its arithmetic and is no
second plain version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu.ops.attention import zorro_mask_from_padded_types
from incomplete_multimodal_fusion_tpu.ops.pallas_attn import _packed_qkv_xla, zorro_self_attention_packed_qkv
from incomplete_multimodal_fusion_tpu.ops.pallas_small_attn import small_attention_qkv_xla

F32_REL_L2 = 1e-5  # chip_smoke.py's bound for the f32 instances against their f32 plain versions
NEG_INF = -0.7 * float(np.finfo(np.float32).max)  # masked scores, in log2 units (zorro_attention.cuh)
LOG2E, LN2 = np.float32(1.4426950408889634), np.float32(0.6931471805599453)
PAD, FUSION = 255, 3


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the f32 bit pattern: the magnitude rounded to 10
    mantissa bits, to nearest with ties away from zero (add half of the
    13 dropped bits' unit, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)  # x - hi is exact in f32


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3xTF32 (hopper.cuh's mma3_*): the two small products first."""
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    return a_hi @ b_lo + a_lo @ b_hi + a_hi @ b_hi


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with one TF32 product: the control."""
    return tf32(a) @ tf32(b)


def heads_of(qkv: torch.Tensor, heads: int):
    b, n, three_i = qkv.shape
    return [t.reshape(b, n, heads, -1).transpose(1, 2) for t in qkv.chunk(3, dim=-1)]


def allowed_of(types, n: int):
    """[B, 1, N, N] boolean: the zorro mask of PAD-coded types, or all keys."""
    if types is None:
        return torch.ones(1, 1, n, n, dtype=torch.bool)
    tq, tk = types[:, None, :, None], types[:, None, None, :]
    return (tq == tk) | ((tq == FUSION) & (tk != PAD))


def emulated_forward(qkv, heads, types, mm):
    """O [B, N, I] and lse [B, H, N] as the kernel computes them: scores in
    log2 units, masked keys at the finite NEG_INF, P = exp2(s - m) split
    into the A fragments of P V, O divided by the row sum at the end."""
    q, k, v = heads_of(qkv, heads)
    b, _, n, dh = q.shape
    sl2 = np.float32(dh ** -0.5) * LOG2E
    s = torch.where(allowed_of(types, n), mm(q, k.transpose(-1, -2)) * sl2, torch.tensor(NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    o = mm(p, v) / l
    lse = (m * LN2 + torch.log(l))[..., 0]
    return o.transpose(1, 2).reshape(b, n, -1), lse


def emulated_backward(qkv, heads, types, o, lse, do, mm):
    """dqkv [B, N, 3I] as the kernel's two passes compute it: P from the
    forward's lse, dP = dO V^T, D = rowsum(dO * O) on the stored O, dS =
    P (dP - D), dQ = dS K, dK = dS^T Q, dV = P^T dO."""
    q, k, v = heads_of(qkv, heads)
    b, _, n, dh = q.shape
    scale = np.float32(dh ** -0.5)
    o_h, do_h = (t.reshape(b, n, heads, dh).transpose(1, 2) for t in (o, do))
    s = torch.where(allowed_of(types, n), mm(q, k.transpose(-1, -2)) * (scale * LOG2E), torch.tensor(NEG_INF))
    p = torch.exp2(s - lse[..., None] * LOG2E)
    dp = mm(do_h, v.transpose(-1, -2))
    ds = p * (dp - (do_h * o_h).sum(-1, keepdim=True))
    grads = (mm(ds, k) * scale, mm(ds.transpose(-1, -2), q) * scale, mm(p.transpose(-1, -2), do_h))
    return torch.cat([g.transpose(1, 2).reshape(b, n, -1) for g in grads], dim=-1)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def packed_types(counts, pad, fusion):
    return [t for t, c in enumerate(counts) for _ in range(c)] + [PAD] * pad + [FUSION] * fusion


# (dh, heads, rows of packed types); a row's types: modality slots in type
# order, padding, the fusion tail
ZORRO = {
    # N = 159, ragged: PAD rows, fusion rows, a type-2 query whose first key tile holds only type 0
    "dh32": (32, 2, [packed_types((70, 0, 50), 9, 30), packed_types((40, 40, 40), 9, 30)]),
    "dh64": (64, 2, [packed_types((70, 0, 50), 9, 30), packed_types((0, 60, 60), 0, 39)]),
    "dh128": (128, 1, [packed_types((70, 0, 50), 9, 30)]),
    # rows 150-199 see only keys 150-199: their first two key tiles are all masked
    "first_tiles_masked": (64, 2, [packed_types((150, 50), 0, 0)]),
    # a long PAD run and a fusion tail past 128 tokens
    "pad_and_fusion": (32, 2, [packed_types((0, 3, 200), 60, 17)]),
}
UNMASKED = {"n65_dh32": (65, 2, 32), "n63_dh64": (63, 1, 64), "n130_dh128": (130, 1, 128)}


def zorro_inputs(case, seed):
    dh, heads, rows = ZORRO[case]
    types = np.asarray(rows, np.int32)
    b, n = types.shape
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, n, 3 * heads * dh)).astype(np.float32)
    do = rng.standard_normal((b, n, heads * dh)).astype(np.float32)
    return qkv, do, types, heads


def jax_lse(qkv, types, heads):
    """The row log-sum-exp of JAX's masked scores (its mask and NEG_INF)."""
    q, k, _ = (t.reshape(*t.shape[:2], heads, -1) for t in jnp.split(jnp.asarray(qkv), 3, axis=-1))
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if types is not None:
        s = jnp.where(zorro_mask_from_padded_types(jnp.asarray(types), FUSION, PAD)[:, None], s, NEG_INF / LOG2E)
    return np.asarray(jax.nn.logsumexp(s, axis=-1))


def jax_grads(fn, qkv, do):
    _, pullback = jax.vjp(fn, jnp.asarray(qkv))
    return np.asarray(pullback(jnp.asarray(do))[0])


@pytest.mark.parametrize("case", sorted(ZORRO))
def test_3xtf32_forward_matches_jax(case):
    qkv, _, types, heads = zorro_inputs(case, 0)
    o, lse = emulated_forward(torch.from_numpy(qkv), heads, torch.from_numpy(types), mm3)
    xla = np.asarray(_packed_qkv_xla(jnp.asarray(qkv), jnp.asarray(types), heads, FUSION, None))
    pallas = np.asarray(zorro_self_attention_packed_qkv(jnp.asarray(qkv), jnp.asarray(types), heads, FUSION))
    assert rel(o, xla) <= F32_REL_L2
    assert rel(o, pallas) <= F32_REL_L2
    assert rel(lse, jax_lse(qkv, types, heads)) <= F32_REL_L2


@pytest.mark.parametrize("case", sorted(ZORRO))
def test_3xtf32_backward_matches_jax_vjp(case):
    qkv, do, types, heads = zorro_inputs(case, 1)
    tq, tt = torch.from_numpy(qkv), torch.from_numpy(types)
    o, lse = emulated_forward(tq, heads, tt, mm3)
    got = emulated_backward(tq, heads, tt, o, lse, torch.from_numpy(do), mm3).numpy()
    want = jax_grads(lambda x: _packed_qkv_xla(x, jnp.asarray(types), heads, FUSION, None), qkv, do)
    for g, w in zip(np.split(got, 3, axis=-1), np.split(want, 3, axis=-1)):  # dq, dk, dv
        assert rel(g, w) <= F32_REL_L2


@pytest.mark.parametrize("case", sorted(UNMASKED))
def test_3xtf32_unmasked_matches_jax(case):
    n, heads, dh = UNMASKED[case]
    rng = np.random.default_rng(2)
    qkv = rng.standard_normal((2, n, 3 * heads * dh)).astype(np.float32)
    do = rng.standard_normal((2, n, heads * dh)).astype(np.float32)
    tq = torch.from_numpy(qkv)
    o, lse = emulated_forward(tq, heads, None, mm3)
    assert rel(o, small_attention_qkv_xla(jnp.asarray(qkv), heads, dh)) <= F32_REL_L2
    assert rel(lse, jax_lse(qkv, None, heads)) <= F32_REL_L2
    got = emulated_backward(tq, heads, None, o, lse, torch.from_numpy(do), mm3).numpy()
    want = jax_grads(lambda x: small_attention_qkv_xla(x, heads, dh), qkv, do)
    for g, w in zip(np.split(got, 3, axis=-1), np.split(want, 3, axis=-1)):
        assert rel(g, w) <= F32_REL_L2


@pytest.mark.parametrize("case", sorted(ZORRO))
def test_one_tf32_product_misses_the_bound(case):
    """The control: the forward and each gradient with one TF32 product a
    multiplication, against the same JAX references, all above 1e-5."""
    qkv, do, types, heads = zorro_inputs(case, 1)
    tq, tt = torch.from_numpy(qkv), torch.from_numpy(types)
    o, lse = emulated_forward(tq, heads, tt, mm1)
    assert rel(o, _packed_qkv_xla(jnp.asarray(qkv), jnp.asarray(types), heads, FUSION, None)) > F32_REL_L2
    got = emulated_backward(tq, heads, tt, o, lse, torch.from_numpy(do), mm1).numpy()
    want = jax_grads(lambda x: _packed_qkv_xla(x, jnp.asarray(types), heads, FUSION, None), qkv, do)
    for g, w in zip(np.split(got, 3, axis=-1), np.split(want, 3, axis=-1)):
        assert rel(g, w) > F32_REL_L2


def test_the_split_is_cvt_rna():
    """hi keeps 10 mantissa bits, rounded to nearest with ties away from
    zero; lo is the rounded rest; hi + lo is within 2^-22 of x."""
    one_ulp = 2.0 ** -10  # of a TF32 value in [1, 2)
    x = torch.tensor([1 + 0.5 * one_ulp, -(1 + 0.5 * one_ulp), 1 + 0.49 * one_ulp, 1 + 1.5 * one_ulp, 3.0],
                     dtype=torch.float32)
    assert tf32(x).tolist() == [1 + one_ulp, -(1 + one_ulp), 1.0, 1 + 2 * one_ulp, 3.0]
    y = torch.from_numpy(np.random.default_rng(3).standard_normal(4096).astype(np.float32))
    hi, lo = split(y)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0) and torch.all((lo.view(torch.int32) & 0x1FFF) == 0)
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2.0 ** -22
