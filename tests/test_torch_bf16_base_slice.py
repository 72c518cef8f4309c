"""K2 / K2b in bf16 at the widths that take their wide path on the card, and
one bf16 pretraining step at `base`'s widths, on the CPU.

The port's plain K2 / K2b (what a CPU tensor runs, and what the card's wide
path is held against in chip_smoke.py phase 3) on bf16 inputs against the
JAX package's Pallas kernels (ops/pallas_ffn.py, in interpret mode on the
CPU: their custom VJP through ``jax.vjp``) on the same bf16 inputs: `base`
(d = 768, GEGLU inner 2048; the MLP at hidden 3072) and `large` (d = 1024,
inner int(1024 * 8 / 3) = 2730). The Pallas kernels take M only where their
row tile divides it: M = 256, two tiles of 128, so the weight gradients are
the sum their sequential grid carries (`large`'s backward has no row tile
within its VMEM budget at 2730 and is held against the XLA twin alone); the
XLA twins (``geglu_ffn_xla``, ``mlp_ffn_xla``) also at a ragged M = 130.
Bound rel-L2 1e-2, as test_torch_block_attn.py's bf16 case: both sides cast
at the Pallas points (xn, a and du / dh to bf16, the weight, gamma and bias
gradients summed in f32), but the order of the sums and the transcendentals
differ, and each bf16 rounding that flips moves a value by 2^-8 of itself.

Then one bf16 step (bf16 compute over f32 masters) at `base`'s widths,
depth 2, on a 64 x 64 raster, from ``params_from_jax`` weights: the loss and
the gradient norm finite, the masters still f32, the weights moved, as
test_torch_train.py's bf16 step does at `tiny`; the f32 `base` slice is held
against JAX in test_torch_f32_base_slice.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu import config as jconfig
from incomplete_multimodal_fusion_tpu.models.multimae import build_multimae as jbuild
from incomplete_multimodal_fusion_tpu.ops import masking as jmask
from incomplete_multimodal_fusion_tpu.ops import pallas_ffn as jffn
from incomplete_multimodal_fusion_tpu_torch import config as tconfig
from incomplete_multimodal_fusion_tpu_torch.data.synthetic import synthetic_batch
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_ffn
from incomplete_multimodal_fusion_tpu_torch.train import pretrain as tpretrain
from incomplete_multimodal_fusion_tpu_torch.utils.jax_params import params_from_jax
from tests.test_torch_common import DOMAINS, NP_, as_jax, random_params, to_np

BF16_REL = 1e-2
BF = jnp.bfloat16
TB = torch.bfloat16


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _f32(t) -> np.ndarray:
    return to_np(t.float()) if isinstance(t, torch.Tensor) else np.asarray(jnp.asarray(t, jnp.float32))


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16, kept as f32 numbers (the same values on both
    sides)."""
    return to_np(torch.from_numpy(a).to(TB).float())


def _geglu_inputs(m, d, inner, seed):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((m, d)).astype(np.float32))
    gamma = _bf16((1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32))
    w_in = _bf16((rng.standard_normal((d, 2 * inner)) * d ** -0.5).astype(np.float32))
    w_out = _bf16((rng.standard_normal((inner, d)) * inner ** -0.5).astype(np.float32))
    dy = _bf16(rng.standard_normal((m, d)).astype(np.float32))
    return x, gamma, w_in, w_out, dy


def _mlp_inputs(m, d, hidden, out, seed):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((m, d)).astype(np.float32))
    w1 = _bf16((rng.standard_normal((d, hidden)) * d ** -0.5).astype(np.float32))
    b1 = _bf16((0.1 * rng.standard_normal(hidden)).astype(np.float32))
    w2 = _bf16((rng.standard_normal((hidden, out)) * hidden ** -0.5).astype(np.float32))
    b2 = _bf16((0.1 * rng.standard_normal(out)).astype(np.float32))
    dy = _bf16(rng.standard_normal((m, out)).astype(np.float32))
    return x, w1, b1, w2, b2, dy


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(TB) for a in arrays]


# (d, inner, JAX function, M, whether its backward runs there): the Pallas kernel in
# interpret mode where its row tile divides M, the XLA twin at a ragged M
GEGLU_CASES = {
    "base pallas": (768, 2048, jffn.geglu_ffn, 256, True),
    "base xla ragged": (768, 2048, jffn.geglu_ffn_xla, 130, True),
    "large pallas": (1024, 2730, jffn.geglu_ffn, 256, False),
    "large xla ragged": (1024, 2730, jffn.geglu_ffn_xla, 130, True),
}


@pytest.mark.parametrize("case", sorted(GEGLU_CASES))
def test_geglu_plain_matches_jax_in_bf16_at_the_wide_widths(case):
    """K2 / K2b GEGLU: y, and dx, dgamma, dW_in, dW_out (the port's layout:
    W_in [2I, d], W_out [d, I]) within BF16_REL of the JAX kernel's."""
    d, inner, fn, m, backward = GEGLU_CASES[case]
    x, gamma, w_in, w_out, dy = _geglu_inputs(m, d, inner, seed=sum(map(ord, case)))
    primals = [jnp.asarray(v, BF) for v in (x, gamma[None], w_in, w_out)]
    y, pullback = jax.vjp(fn, *primals)
    tx, tg, twi, two, tdy = _torch(x, gamma, w_in.T, w_out.T, dy)
    got = cuda_ffn.geglu_ffn_reference(tx, tg, twi, two)
    assert got.dtype == TB and _rel(_f32(got), _f32(y)) <= BF16_REL
    if not backward:
        return
    jdx, jdg, jdwi, jdwo = pullback(jnp.asarray(dy, BF))
    dx, dg, dwi, dwo = cuda_ffn.geglu_ffn_backward_reference(tx, tg, twi, two, tdy)
    assert all(g.dtype == TB for g in (dx, dg, dwi, dwo))
    for name, a, b in (("dx", dx, jdx), ("dgamma", dg, jdg[0]), ("dw_in", dwi, jnp.transpose(jdwi)),
                       ("dw_out", dwo, jnp.transpose(jdwo))):
        assert _rel(_f32(a), _f32(b)) <= BF16_REL, name


MLP_CASES = {
    "base pallas": (768, 3072, 768, jffn.mlp_ffn, 256),
    "base xla ragged": (768, 3072, 768, jffn.mlp_ffn_xla, 130),
    "large xla ragged": (1024, 4096, 1024, jffn.mlp_ffn_xla, 130),
}


@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_mlp_plain_matches_jax_in_bf16_at_the_wide_widths(case):
    """K2 / K2b MLP past the row path's widths: y, and dx, dW1, db1, dW2,
    db2 within BF16_REL of the JAX kernel's."""
    d, hidden, out, fn, m = MLP_CASES[case]
    x, w1, b1, w2, b2, dy = _mlp_inputs(m, d, hidden, out, seed=sum(map(ord, case)))
    primals = [jnp.asarray(v, BF) for v in (x, w1, b1[None], w2, b2[None])]
    y, pullback = jax.vjp(fn, *primals)
    tx, tw1, tb1, tw2, tb2, tdy = _torch(x, w1.T, b1, w2.T, b2, dy)
    got = cuda_ffn.mlp_ffn_reference(tx, tw1, tb1, tw2, tb2)
    assert got.dtype == TB and _rel(_f32(got), _f32(y)) <= BF16_REL
    jdx, jdw1, jdb1, jdw2, jdb2 = pullback(jnp.asarray(dy, BF))
    grads = cuda_ffn.mlp_ffn_backward_reference(tx, tw1, tb1, tw2, tb2, tdy)
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), grads,
                          (jdx, jnp.transpose(jdw1), jdb1[0], jnp.transpose(jdw2), jdb2[0])):
        assert a.dtype == TB and _rel(_f32(a), _f32(b)) <= BF16_REL, name


def _base_cfg(mod, compute_dtype):
    """`base`'s encoder widths (MODEL_SIZES['base'] at depth 2) on a 64 x 64
    raster, as a PretrainConfig of either package."""
    return mod.PretrainConfig(
        model=mod.ModelConfig(dim_tokens=768, depth=2, dim_head=64, heads=8, ff_mult=4, num_fusion_tokens=16),
        data=mod.DataConfig(input_size=64, patch_size=16, batch_size=2),
        mask=mod.MaskConfig(num_encoded_tokens=24),
        decoder=mod.DecoderConfig(dim=32, depth=2, num_heads=2),
        train=mod.TrainConfig(epochs=1, compute_dtype=compute_dtype))


def test_one_bf16_step_at_base_widths_on_cpu():
    """The default compute dtype at `base`'s widths (the card runs the same
    step through K2 / K2b's bf16 wide path, chip_smoke.py phase 18): one
    step from JAX-initialised weights, finite loss and gradient norm, f32
    masters that moved."""
    batch = synthetic_batch(np.random.default_rng(0), DOMAINS, 2, 64)
    jm = jbuild(_base_cfg(jconfig, "bfloat16"))
    params = random_params(jm, 2, as_jax(batch), jmask.full_visible_mask_info(DOMAINS, (NP_,) * 3, 2), NP_ * 3)
    cfg = _base_cfg(tconfig, "bfloat16")
    model, state, optimizer = tpretrain.create_train_state(cfg, 0, total_steps=4, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    widths = {tuple(p.shape) for n, p in model.named_parameters() if n.endswith("proj_in.weight")}
    assert widths == {(2 * 2048, 768)}  # every block's GEGLU: inner 2048 over d = 768, the wide path's
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, metrics = tpretrain.make_train_step(model, cfg, optimizer)(state, batch)
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    assert all(p.dtype == torch.float32 for p in model.parameters())  # the masters stay f32
    assert any(not torch.equal(before[n], p) for n, p in model.named_parameters())
