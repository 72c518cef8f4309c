"""The f32 slice at `base`'s widths (d = 768, 8 x 64 heads, GEGLU inner
2048: the widths whose FFNs take K2 / K2b's wide path on the card) against
the JAX package on the same weights (``params_from_jax``) and injected
MaskInfo, f32 on the CPU: the MultiMAE forward and one pretraining step's
loss and every gradient at depth 2 on a 64 x 64 raster; and one encoder
block at `large`'s width (d = 1024) with its unpadded GEGLU inner width
int(1024 * 8 / 3) = 2730, forward and backward. Bound rel-L2 1e-5
(chip_smoke.py's F32_REL_L2). On the CPU the port's operators run their
plain versions; the card runs the same entry points through the kernels
(chip_smoke.py phase 9 (d))."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu import config as jconfig
from incomplete_multimodal_fusion_tpu.models import layers as jlayers
from incomplete_multimodal_fusion_tpu.models.multimae import build_multimae as jbuild
from incomplete_multimodal_fusion_tpu.ops import masking as jmask
from incomplete_multimodal_fusion_tpu.train import pretrain as jpretrain
from incomplete_multimodal_fusion_tpu_torch import config as tconfig
from incomplete_multimodal_fusion_tpu_torch.data.synthetic import synthetic_batch
from incomplete_multimodal_fusion_tpu_torch.models import layers as tlayers
from incomplete_multimodal_fusion_tpu_torch.ops import masking as tmask
from incomplete_multimodal_fusion_tpu_torch.train import pretrain as tpretrain
from incomplete_multimodal_fusion_tpu_torch.utils.jax_params import params_from_jax
from tests.test_torch_common import DOMAINS, NP_, as_jax, as_torch, port_module, random_params, to_np

REL = 1e-5
B, E = 2, 24
CAPACITY = NP_ * len(DOMAINS)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cfg(mod):
    """`base`'s encoder widths (MODEL_SIZES['base'] at depth 2) on a 64 x 64
    raster, f32 compute, as a PretrainConfig of either package."""
    return mod.PretrainConfig(
        model=mod.ModelConfig(dim_tokens=768, depth=2, dim_head=64, heads=8, ff_mult=4, num_fusion_tokens=16),
        data=mod.DataConfig(input_size=64, patch_size=16, batch_size=B),
        mask=mod.MaskConfig(num_encoded_tokens=E),
        decoder=mod.DecoderConfig(dim=32, depth=2, num_heads=2),
        train=mod.TrainConfig(epochs=1, compute_dtype="float32"))


def _mask_infos():
    """Exactly E visible tokens a row; row 1 sees no s2 token."""
    rng = np.random.default_rng(5)
    flat = np.ones((B, CAPACITY), np.int64)
    flat[0, rng.permutation(CAPACITY)[:E]] = 0
    others = np.r_[0:NP_, 2 * NP_:3 * NP_]
    flat[1, rng.permutation(others)[:E]] = 0
    return (jmask.mask_info_from_flat_mask(jnp.asarray(flat), DOMAINS, (NP_,) * 3, E),
            tmask.mask_info_from_flat_mask(torch.from_numpy(flat), DOMAINS, (NP_,) * 3, E))


@pytest.fixture(scope="module")
def base():
    batch = synthetic_batch(np.random.default_rng(0), DOMAINS, B, 64)
    jcfg = _cfg(jconfig)
    jm = jbuild(jcfg)
    params = random_params(jm, 2, as_jax(batch), jmask.full_visible_mask_info(DOMAINS, (NP_,) * 3, B), CAPACITY)
    cfg = _cfg(tconfig)
    model, _, _ = tpretrain.create_train_state(cfg, 0, total_steps=4, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return batch, jcfg, jm, params, cfg, model


def test_base_widths_forward_matches_jax(base):
    batch, _, jm, params, _, model = base
    jmi, tmi = _mask_infos()
    ref = jax.jit(lambda p, x, mi: jm.apply({"params": p}, x, mi, E))(params, as_jax(batch), jmi)
    with torch.no_grad():
        out = model(as_torch(batch), tmi, E)
    for d in DOMAINS:
        assert _rel(to_np(out["preds"][d]), ref["preds"][d]) <= REL, d
    assert _rel(to_np(out["pooled"]), ref["pooled"]) <= REL
    assert _rel(to_np(out["fusion_tokens"]), ref["fusion_tokens"]) <= REL


def test_base_widths_step_loss_and_every_gradient_match_jax(base):
    """One f32 pretraining step's loss (rel 1e-5) and gradients: the flat
    gradient within rel-L2 1e-5 of ``jax.value_and_grad``'s, and each
    parameter's within 1e-5 of the flat gradient's norm."""
    batch, jcfg, _, params, cfg, model = base
    jmi, tmi = _mask_infos()
    loss_fn = jpretrain.make_loss_fn(jbuild(jcfg), jcfg)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b, mi: loss_fn(p, {}, b, mi, jax.random.PRNGKey(0)), has_aux=True))(params, as_jax(batch), jmi)
    model.zero_grad(set_to_none=True)
    loss, _ = tpretrain.make_loss_fn(model, cfg)(dict(model.named_parameters()), as_torch(batch), tmi)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= REL * abs(float(jloss))
    want = {n: g.numpy() for n, g in params_from_jax(jgrads).items()}
    got = {n: (to_np(p.grad) if p.grad is not None else np.zeros(p.shape, np.float32))
           for n, p in model.named_parameters()}
    assert set(want) == set(got)
    names = sorted(want)
    flat_want = np.concatenate([want[n].ravel() for n in names]).astype(np.float64)
    flat_got = np.concatenate([got[n].ravel() for n in names]).astype(np.float64)
    assert np.linalg.norm(flat_got - flat_want) <= REL * np.linalg.norm(flat_want)
    scale = np.linalg.norm(flat_want)
    for n in names:
        assert np.linalg.norm(got[n].astype(np.float64) - want[n]) <= REL * scale, n


def test_large_width_block_with_unpadded_inner_width_matches_jax():
    """An encoder block at d = 1024, 8 x 64 heads, GEGLU inner 2730 (not a
    multiple of 8 or 16): forward, the input's gradient and every weight's
    against ``jax.vjp`` of the flax block."""
    rng = np.random.default_rng(7)
    b, n, d = 2, 40, 1024
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    dy = rng.standard_normal((b, n, d)).astype(np.float32)
    types = np.asarray([[0] * 10 + [1] * 8 + [2] * 4 + [255] * 2 + [3] * 16,
                        [1] * 12 + [2] * 6 + [255] * 6 + [3] * 16], np.int32)
    jm = jlayers.EncoderBlock(dim_head=64, heads=8, ff_mult=4)
    params = random_params(jm, 8, jnp.asarray(x), packed_types=jnp.asarray(types), fusion_type=3)
    y, pullback = jax.vjp(lambda p, xx: jm.apply({"params": p}, xx, packed_types=jnp.asarray(types), fusion_type=3,
                                                 use_pallas="auto"), params, jnp.asarray(x))
    jgrads, jdx = pullback(jnp.asarray(dy))
    tm = port_module(tlayers.EncoderBlock(d, 64, 8, 4), params)
    inner = [p.shape for name, p in tm.named_parameters() if p.dim() == 2]
    assert any(2730 in s for s in inner), inner
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm(xt, torch.from_numpy(types), 3, use_kernel=True)
    out.backward(torch.from_numpy(dy))
    assert _rel(to_np(out), y) <= REL
    assert _rel(to_np(xt.grad), jdx) <= REL
    want = params_from_jax(jgrads)
    for name, p in tm.named_parameters():
        assert _rel(to_np(p.grad), want[name].numpy()) <= REL, name
