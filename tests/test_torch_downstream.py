"""The ported downstream segmentation forward -- ViTBaseline backbone,
MSDeformAttn pixel decoder, Mask2Former decoder, MaskFormerModel and the
``forward_segmentation`` / ``forward_instance_segmentation`` entry points
-- against the JAX package on the same numpy inputs and flax weights (f32
on the CPU), against the executed reference's frozen outputs in
tests/golden/{pixel_decoder,mask2former_decoder,vit_baseline}_golden.npz,
and the pieces the carry-over of weights and the resizes depend on."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from incomplete_multimodal_fusion_tpu import infer_segmentation as jseg
from incomplete_multimodal_fusion_tpu.eval import metrics as jmetrics
from incomplete_multimodal_fusion_tpu.models import mask2former_decoder as jm2f
from incomplete_multimodal_fusion_tpu.models import maskformer as jmf
from incomplete_multimodal_fusion_tpu.models import pixel_decoder as jpd
from incomplete_multimodal_fusion_tpu.models import vit_baseline as jvit
from incomplete_multimodal_fusion_tpu.models.position_encoding import position_embedding_sine as jpos
from incomplete_multimodal_fusion_tpu.ops import masking as jmask
from incomplete_multimodal_fusion_tpu.utils import torch_convert as tc
from incomplete_multimodal_fusion_tpu_torch import infer_segmentation as tseg
from incomplete_multimodal_fusion_tpu_torch.eval import metrics as tmetrics
from incomplete_multimodal_fusion_tpu_torch.models import mask2former_decoder as tm2f
from incomplete_multimodal_fusion_tpu_torch.models import maskformer as tmf
from incomplete_multimodal_fusion_tpu_torch.models import pixel_decoder as tpd
from incomplete_multimodal_fusion_tpu_torch.models import vit_baseline as tvit
from incomplete_multimodal_fusion_tpu_torch.models.layers import GroupNorm, LayerNorm
from incomplete_multimodal_fusion_tpu_torch.models.msda_module import MSDeformAttn, offset_bias
from incomplete_multimodal_fusion_tpu_torch.models.position_encoding import position_embedding_sine
from incomplete_multimodal_fusion_tpu_torch.ops import masking as tmask
from incomplete_multimodal_fusion_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_nhwc
from incomplete_multimodal_fusion_tpu_torch.utils.jax_params import params_from_jax
from tests.test_torch_common import CHANNELS, DOMAINS, as_jax, port_module, random_params, to_np

ATOL = 1e-4
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def jit_apply(module, params, *args, **kwargs):
    """``module.apply`` under ``jax.jit`` (one compile instead of one per
    eager op); the non-array arguments are closed over."""
    arrays = [a for a in args if isinstance(a, (jnp.ndarray, list, dict, tuple)) and not _static(a)]
    fn = jax.jit(lambda p, *arr: module.apply({"params": p}, *_merge(args, arr), **kwargs))
    return fn(params, *arrays)


def _static(a):
    return isinstance(a, tuple) and all(isinstance(t, tuple) for t in a)  # spatial shapes


def _merge(args, arrays):
    it = iter(arrays)
    return [a if _static(a) else next(it) for a in args]


def _nhwc(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _sharpen_masks(params):
    """mask_embed.layer2 x 6, as test_full_maskformer_parity.py:139-146:
    mask logits off the 0.5 threshold, so the hard attention mask does not
    flip on rounding noise."""
    layer2 = params["mask_embed"]["layer2"] if "mask_embed" in params else \
        params["predictor"]["mask_embed"]["layer2"]
    layer2["kernel"] = layer2["kernel"] * 6.0
    layer2["bias"] = layer2["bias"] * 6.0
    return params


# ---------------------------------------------------------------------------
# carrying flax weights over: conv kernels, transposed convs, norm scales
# ---------------------------------------------------------------------------

def test_conv_kernel_carries_over():
    x = _nhwc(np.random.default_rng(0), 2, 5, 7, 3)
    conv = fnn.Conv(4, (3, 3), padding="SAME", name="fpn_output")
    params = random_params(conv, 1, jnp.asarray(x))
    ref = conv.apply({"params": params}, jnp.asarray(x))
    tconv = torch.nn.Conv2d(3, 4, 3, padding=1)
    tconv.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        out = tconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("name", ["up1_conv1", "up2_conv"])
def test_conv_transpose_kernel_carries_over_flipped(name):
    """flax ConvTranspose (2, 2)/2 against the port's ConvTranspose2x2: the
    kernel lands in conv_transpose2d's layout with the spatial flip."""
    x = _nhwc(np.random.default_rng(2), 2, 3, 4, 6)
    ct = fnn.ConvTranspose(5, (2, 2), strides=(2, 2))
    params = random_params(ct, 3, jnp.asarray(x))
    ref = ct.apply({"params": params}, jnp.asarray(x))
    mod = tvit.ConvTranspose2x2(6, 5)
    state = params_from_jax({name: params})
    mod.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()}, strict=True)
    with torch.no_grad():
        out = mod(torch.from_numpy(x))
        # the layout is conv_transpose2d's
        via_torch = torch.nn.functional.conv_transpose2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), mod.weight, mod.bias, stride=2)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(to_np(via_torch.permute(0, 2, 3, 1)), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("flax_norm,port_norm", [
    (lambda: fnn.GroupNorm(num_groups=4), lambda: GroupNorm(8, 4, eps=1e-6)),
    (lambda: fnn.GroupNorm(num_groups=2, epsilon=1e-5), lambda: GroupNorm(8, 2, eps=1e-5)),
    (lambda: fnn.LayerNorm(epsilon=1e-5), lambda: LayerNorm(8, eps=1e-5)),
])
def test_norm_scale_carries_over(flax_norm, port_norm):
    """flax LayerNorm / GroupNorm ``scale`` lands on ``weight``; the
    GroupNorm default epsilon (1e-6) is the pyramid's ``up1_gn``."""
    x = 3.0 + _nhwc(np.random.default_rng(4), 2, 3, 5, 8)
    norm = flax_norm()
    params = random_params(norm, 5, jnp.asarray(x))
    assert set(params) == {"scale", "bias"}
    ref = norm.apply({"params": params}, jnp.asarray(x))
    out = port_module(port_norm(), params)(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=1e-5)


# ---------------------------------------------------------------------------
# the pieces: position embedding, resizes, post-processing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,feats", [(4, 4, 16), (5, 7, 32), (64, 64, 128)])
def test_position_embedding_sine(h, w, feats):
    np.testing.assert_allclose(to_np(position_embedding_sine(h, w, feats)),
                               np.asarray(jpos(h, w, feats)), atol=2e-6)


@pytest.mark.parametrize("where,shape,size,antialias", [
    ("fpn upsample (pixel_decoder.py:138)", (2, 6, 8, 5), (12, 16), True),
    ("mask downsample (mask2former_decoder.py:157)", (2, 5, 32, 32), (4, 4), False),
    ("mask downsample, non-square", (2, 5, 16, 24), (8, 6), False),
    ("masks to the input size (infer_segmentation.py:67)", (2, 5, 16, 16), (64, 64), True),
])
def test_resizes_match_jax_image_resize(where, shape, size, antialias):
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    if where.startswith("fpn"):  # NHWC map
        ref = jax.image.resize(jnp.asarray(x), (shape[0],) + size + (shape[3],), method="bilinear")
        out = resize_bilinear_nhwc(torch.from_numpy(x), size)
    else:
        ref = jax.image.resize(jnp.asarray(x), shape[:2] + size, method="bilinear",
                               antialias=antialias)
        out = resize_bilinear(torch.from_numpy(x), size, antialias=antialias)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=1e-6, err_msg=where)


def test_pad_and_sem_seg_postprocess_match_jax():
    rng = np.random.default_rng(7)
    img = rng.standard_normal((2, 50, 70, 3)).astype(np.float32)
    padded, hw = tseg.pad_to_divisible(torch.from_numpy(img))
    ref_padded, ref_hw = jseg.pad_to_divisible(jnp.asarray(img))
    assert hw == ref_hw
    np.testing.assert_array_equal(to_np(padded), np.asarray(ref_padded))
    result = rng.standard_normal((2, 4, 64, 96)).astype(np.float32)
    for out_size in ((100, 140), (25, 35)):  # up, and down (antialiased as JAX's default)
        ref = jseg.sem_seg_postprocess(jnp.asarray(result), (50, 70), out_size)
        out = tseg.sem_seg_postprocess(torch.from_numpy(result), (50, 70), out_size)
        np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=1e-5)


def test_semantic_and_instance_inference_match_jax():
    rng = np.random.default_rng(8)
    cls = rng.standard_normal((2, 6, 5)).astype(np.float32)
    masks = (3.0 * rng.standard_normal((2, 6, 9, 11))).astype(np.float32)
    np.testing.assert_allclose(
        to_np(tmetrics.semantic_inference(torch.from_numpy(cls), torch.from_numpy(masks))),
        np.asarray(jmetrics.semantic_inference(jnp.asarray(cls), jnp.asarray(masks))), atol=1e-6)
    for topk in (7, 100):
        ref = jmetrics.instance_inference(jnp.asarray(cls[0]), jnp.asarray(masks[0]), 4, topk=topk)
        out = tmetrics.instance_inference(torch.from_numpy(cls[0]), torch.from_numpy(masks[0]), 4,
                                          topk=topk)
        np.testing.assert_allclose(to_np(out["scores"]), np.asarray(ref["scores"]), atol=1e-6)
        np.testing.assert_array_equal(to_np(out["pred_classes"]), np.asarray(ref["pred_classes"]))
        np.testing.assert_array_equal(to_np(out["pred_masks"]), np.asarray(ref["pred_masks"]))


# ---------------------------------------------------------------------------
# the modules against flax at small widths
# ---------------------------------------------------------------------------

SHAPES = ((2, 3), (4, 6), (8, 12))  # low -> high resolution, non-square


def test_encoder_layer_matches_flax():
    rng = np.random.default_rng(9)
    c, b = 64, 2
    s = sum(h * w for h, w in SHAPES)
    src, pos = _nhwc(rng, b, s, c), _nhwc(rng, 1, s, c)
    ref_pts = np.broadcast_to(to_np(tpd.reference_points_for(SHAPES))[None], (b, s, 3, 2)).copy()
    np.testing.assert_array_equal(ref_pts[0], np.asarray(jpd.reference_points_for(SHAPES)))
    jl = jpd.MSDeformAttnEncoderLayer(d_model=c, d_ffn=96, n_levels=3, n_heads=8, n_points=4)
    args = (jnp.asarray(src), jnp.asarray(pos), jnp.asarray(ref_pts), SHAPES)
    params = random_params(jl, 10, *args)
    ref = jit_apply(jl, params, *args)
    tl = port_module(tpd.MSDeformAttnEncoderLayer(c, 96, 3, 8, 4), params)
    with torch.no_grad():
        out = tl(torch.from_numpy(src), torch.from_numpy(pos), torch.from_numpy(ref_pts), SHAPES)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("num_fpn_levels", [1, 2])
def test_pixel_decoder_matches_flax(num_fpn_levels):
    """Non-square levels, 64 channels (GroupNorm groups of 2), both FPN
    layouts (the double step names fpn_lateral2 / fpn_output2)."""
    rng = np.random.default_rng(11)
    chans = (24, 32, 40, 48)
    hw = ((16, 24), (8, 12), (4, 6), (2, 3))  # res2..res5
    feats = [_nhwc(rng, 2, h, w, ch) for (h, w), ch in zip(hw, chans)]
    jm = jpd.MSDeformAttnPixelDecoder(conv_dim=64, mask_dim=48, transformer_enc_layers=2,
                                      dim_feedforward=96, num_fpn_levels=num_fpn_levels)
    params = random_params(jm, 12, [jnp.asarray(f) for f in feats])
    ref_mf, ref_ms = jit_apply(jm, params, [jnp.asarray(f) for f in feats])
    tm = port_module(tpd.MSDeformAttnPixelDecoder(chans, conv_dim=64, mask_dim=48,
                                                  transformer_enc_layers=2, dim_feedforward=96,
                                                  num_fpn_levels=num_fpn_levels), params)
    with torch.no_grad():
        mf, ms = tm([torch.from_numpy(f) for f in feats])
    np.testing.assert_allclose(to_np(mf), np.asarray(ref_mf), atol=ATOL)
    for o, r in zip(ms, ref_ms):
        np.testing.assert_allclose(to_np(o), np.asarray(r), atol=ATOL)


def test_mask2former_decoder_matches_flax():
    rng = np.random.default_rng(13)
    d, md = 32, 24
    x = [_nhwc(rng, 2, h, w, d) for h, w in SHAPES]
    mf = _nhwc(rng, 2, 16, 24, md)
    jm = jm2f.MultiScaleMaskedTransformerDecoder(num_classes=4, hidden_dim=d, num_queries=7,
                                                 n_heads=4, dim_feedforward=48, dec_layers=4,
                                                 mask_dim=md)
    jargs = ([jnp.asarray(t) for t in x], jnp.asarray(mf))
    params = _sharpen_masks(random_params(jm, 14, *jargs))
    ref = jit_apply(jm, params, *jargs)
    tm = port_module(tm2f.MultiScaleMaskedTransformerDecoder(4, d, 7, 4, 48, 4, md), params)
    with torch.no_grad():
        out = tm([torch.from_numpy(t) for t in x], torch.from_numpy(mf))
    _assert_outputs_close(out, ref, ATOL, ATOL)


def _assert_outputs_close(out, ref, rtol, atol):
    for key in ("pred_logits", "pred_masks"):
        np.testing.assert_allclose(to_np(out[key]), np.asarray(ref[key]), rtol=rtol, atol=atol,
                                   err_msg=key)
    assert len(out["aux_outputs"]) == len(ref["aux_outputs"])
    for i, (o, r) in enumerate(zip(out["aux_outputs"], ref["aux_outputs"])):
        for key in ("pred_logits", "pred_masks"):
            np.testing.assert_allclose(to_np(o[key]), np.asarray(r[key]), rtol=rtol, atol=atol,
                                       err_msg=f"aux {i} {key}")


VIT = dict(in_domains=DOMAINS, image_size=64, patch_size=16, dim_tokens=64, depth=3, dim_head=16,
           heads=2, num_fusion_tokens=16)
NP_ = 16


def _vit_inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    return {d: _nhwc(rng, b, 64, 64, CHANNELS[d]) for d in DOMAINS}


@pytest.fixture(scope="module")
def vit_pair():
    x = _vit_inputs(15)
    jm = jvit.ViTBaseline(**VIT)
    mi = jmask.full_visible_mask_info(DOMAINS, (NP_,) * 3, 2)
    params = random_params(jm, 16, as_jax(x), mi, 3 * NP_)
    return jm, params, port_module(tvit.ViTBaseline(**VIT), params), x


@pytest.mark.parametrize("case", ["all", "dem_absent", "random_e40"])
def test_vit_baseline_matches_flax(vit_pair, case):
    """The 4 pyramid maps: every token visible; dem's tokens masked and its
    plane out of the fusion stack; random masks packed into 40 slots."""
    jm, params, tm, x = vit_pair
    present = np.array([True, True, case != "dem_absent"])
    if case == "random_e40":
        flat = (np.random.default_rng(17).random((2, 3 * NP_)) < 0.6).astype(np.int64)
        e = 40
        jmi = jmask.mask_info_from_flat_mask(jnp.asarray(flat), DOMAINS, (NP_,) * 3, e)
        tmi = tmask.mask_info_from_flat_mask(torch.from_numpy(flat), DOMAINS, (NP_,) * 3, e)
    else:
        masks = {d: np.full((2, NP_), int(not p), np.int64) for d, p in zip(DOMAINS, present)}
        e = 3 * NP_
        jmi = jmask.mask_info_from_task_masks(as_jax(masks), DOMAINS, e)
        tmi = tmask.mask_info_from_task_masks({d: torch.from_numpy(m) for d, m in masks.items()},
                                              DOMAINS, e)
    ref = jax.jit(lambda p, x, mi, pr: jm.apply({"params": p}, x, mi, e, present=pr))(
        params, as_jax(x), jmi, jnp.asarray(present))
    with torch.no_grad():
        out = tm({d: torch.from_numpy(v) for d, v in x.items()}, tmi, e,
                 present=torch.from_numpy(present))
    assert [tuple(o.shape) for o in out] == [(2, 16, 16, 64), (2, 8, 8, 64), (2, 4, 4, 64),
                                             (2, 2, 2, 64)]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(to_np(o), np.asarray(r), atol=ATOL)


# ---------------------------------------------------------------------------
# the executed reference's frozen outputs, weights through convert_*_state
# ---------------------------------------------------------------------------

def _golden(name):
    g = np.load(os.path.join(GOLDEN, f"{name}_golden.npz"))
    return g, {k[len("w_"):]: g[k] for k in g.files if k.startswith("w_")}


def _chw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 3, 1)))


def test_pixel_decoder_golden():
    """tests/test_pixel_decoder_parity.py on the port (rtol/atol 2e-4)."""
    g, w = _golden("pixel_decoder")
    model = tpd.MSDeformAttnPixelDecoder((8, 16, 24, 40), conv_dim=32, mask_dim=32,
                                         transformer_enc_layers=1, n_heads=8, dim_feedforward=64,
                                         n_points=4, dropout=0.0, num_fpn_levels=1)
    model = port_module(model, tc.convert_pixel_decoder_state(w, enc_layers=1))
    with torch.no_grad():
        mask_features, ms = model([_chw(g[f"x_res{i}"]) for i in (2, 3, 4, 5)])
    for i in range(3):
        np.testing.assert_allclose(to_np(ms[i]), g[f"ms_{i}"].transpose(0, 2, 3, 1), rtol=2e-4,
                                   atol=2e-4)
    np.testing.assert_allclose(to_np(mask_features), g["mask_features"].transpose(0, 2, 3, 1),
                               rtol=2e-4, atol=2e-4)


def test_mask2former_decoder_golden():
    """tests/test_mask2former_decoder_parity.py on the port (rtol/atol 2e-4)."""
    g, w = _golden("mask2former_decoder")
    model = tm2f.MultiScaleMaskedTransformerDecoder(num_classes=3, hidden_dim=32, num_queries=5,
                                                    n_heads=4, dim_feedforward=64, dec_layers=3,
                                                    mask_dim=16)
    model = port_module(model, tc.convert_mask2former_decoder_state(w, hidden_dim=32, dec_layers=3))
    with torch.no_grad():
        out = model([_chw(g[f"x_{i}"]) for i in range(3)], _chw(g["mask_features"]))
    ref = {"pred_logits": g["pred_logits"], "pred_masks": g["pred_masks"],
           "aux_outputs": [{"pred_logits": g[f"aux_{i}_logits"], "pred_masks": g[f"aux_{i}_masks"]}
                           for i in range(3)]}
    _assert_outputs_close(out, ref, 2e-4, 2e-4)


def test_vit_baseline_golden():
    """tests/test_vit_baseline_parity.py on the port (rtol/atol 3e-4)."""
    g, w = _golden("vit_baseline")
    model = tvit.ViTBaseline(in_domains=DOMAINS, image_size=64, patch_size=16, dim_tokens=64,
                             depth=4, dim_head=16, heads=2, num_fusion_tokens=16)
    model = port_module(model, tc.convert_vit_baseline_state(w, DOMAINS, depth=4))
    mi = tmask.full_visible_mask_info(DOMAINS, (16,) * 3, 2)
    with torch.no_grad():
        feats = model({d: _chw(g[f"x_{d}"]) for d in DOMAINS}, mi, 48)
    for i, f in enumerate(feats):
        np.testing.assert_allclose(to_np(f), g[f"f_{i}"].transpose(0, 2, 3, 1), rtol=3e-4, atol=3e-4)


# ---------------------------------------------------------------------------
# the whole model and the entry points
# ---------------------------------------------------------------------------

CFG = dict(in_domains=DOMAINS, image_size=64, patch_size=16, num_classes=3, dim_tokens=32, depth=2,
           dim_head=8, heads=2, num_fusion_tokens=16, conv_dim=32, mask_dim=32,
           transformer_enc_layers=1, num_queries=10, dec_layers=3, dim_feedforward=64)


@pytest.fixture(scope="module")
def model_pair():
    x = _vit_inputs(18)
    jm = jmf.MaskFormerModel(jmf.MaskFormerConfig(**CFG))
    params = _sharpen_masks(random_params(jm, 19, as_jax(x)))
    tm = port_module(tmf.MaskFormerModel(tmf.MaskFormerConfig(**CFG)), params)
    return jm, params, tm, x


def test_config_matches_jax():
    j, t = jmf.MaskFormerConfig(), tmf.MaskFormerConfig()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (t.num_patches, t.max_encoded_tokens) == (j.num_patches, j.max_encoded_tokens) == (256, 768)


def test_jax_tree_names_map_one_to_one(model_pair):
    _, params, tm, _ = model_pair
    sd = params_from_jax(params)
    assert len(sd) == len(jax.tree_util.tree_leaves(params))
    assert set(sd) == set(tm.state_dict())


@pytest.mark.parametrize("attn_impl", ["auto", "xla"])
def test_maskformer_matches_flax(model_pair, attn_impl):
    """pred_logits, pred_masks and every aux output at rtol/atol 1e-3."""
    jm, params, tm, x = model_pair
    ref = jit_apply(jm, params, as_jax(x))
    tm.attn_impl = attn_impl
    assert {m.impl for m in tm.modules() if isinstance(m, MSDeformAttn)} == {attn_impl}
    with torch.no_grad():
        out = tm({d: torch.from_numpy(v) for d, v in x.items()})
    tm.attn_impl = "auto"
    _assert_outputs_close(out, ref, 1e-3, 1e-3)


@pytest.mark.parametrize("dropped", [(), ("dem",), ("s1", "dem")])
def test_forward_segmentation_matches_jax(model_pair, dropped):
    """Label maps equal except where JAX's two best class scores are within
    1e-4 of each other; with modalities dropped, the map does not move with
    their pixels."""
    jm, params, tm, x = model_pair

    def jax_ref(p, x):  # JAX's entry point, and its class probabilities
        labels = jseg.forward_segmentation(jm, p, x, 3, drop_modalities=dropped)
        kw = {}
        if dropped:
            masks = {d: jnp.full((2, NP_), int(d in dropped), jnp.int32) for d in DOMAINS}
            kw = dict(mask_info=jmask.mask_info_from_task_masks(masks, DOMAINS, 3 * NP_),
                      num_encoded_tokens=3 * NP_,
                      present=jnp.asarray([d not in dropped for d in DOMAINS]))
        jout = jm.apply({"params": p}, x, **kw)
        masks = jax.image.resize(jout["pred_masks"], jout["pred_masks"].shape[:2] + (64, 64),
                                 "bilinear")
        return labels, jmetrics.semantic_inference(jout["pred_logits"], masks)

    ref, sem = (np.asarray(a) for a in jax.jit(jax_ref)(params, as_jax(x)))
    out = to_np(tseg.forward_segmentation(tm, None, x, 3, drop_modalities=dropped))
    sem = np.sort(sem, axis=1)
    decided = sem[:, -1] - sem[:, -2] >= 1e-4
    assert out.shape == ref.shape == (2, 64, 64)
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(out[decided], ref[decided])
    if dropped:
        x2 = {d: (v * 0.0 + 123.0 if d in dropped else v) for d, v in x.items()}
        with torch.no_grad():
            a = tseg.segmentation_outputs(tm, None, x, dropped)
            b = tseg.segmentation_outputs(tm, None, x2, dropped)
        for key in ("pred_logits", "pred_masks"):
            torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
        np.testing.assert_array_equal(to_np(tseg.forward_segmentation(tm, None, x2, 3, dropped)), out)


def test_forward_instance_segmentation_matches_jax(model_pair):
    """Scores at 1e-4; classes equal; binary masks equal except at pixels
    whose JAX logit is within 1e-4 of 0."""
    jm, params, tm, x = model_pair
    ref = jax.jit(lambda p, x: jseg.forward_instance_segmentation(jm, p, x, topk=12))(
        params, as_jax(x))
    with torch.no_grad():
        out = tseg.forward_instance_segmentation(tm, None, x, topk=12)
    assert len(out) == len(ref) == 2
    for o, r in zip(out, ref):
        np.testing.assert_allclose(to_np(o["scores"]), np.asarray(r["scores"]), atol=1e-4)
        np.testing.assert_array_equal(to_np(o["pred_classes"]), np.asarray(r["pred_classes"]))
        decided = np.abs(np.asarray(r["mask_logits"])) >= 1e-4
        np.testing.assert_array_equal(to_np(o["pred_masks"])[decided],
                                      np.asarray(r["pred_masks"])[decided])


def test_build_maskformer_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmf.build_maskformer(tmf.MaskFormerConfig(**CFG))
    a = tmf.build_maskformer(tmf.MaskFormerConfig(**CFG), device="cpu",
                             generator=torch.Generator().manual_seed(3))
    b = tmf.build_maskformer(tmf.MaskFormerConfig(**CFG), device="cpu",
                             generator=torch.Generator().manual_seed(3))
    assert next(a.parameters()).device.type == "cpu"
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=name)
    # the JAX initializers where they are not random
    attn = a.pixel_decoder.enc_layer0.self_attn
    with torch.no_grad():
        assert float(attn.sampling_offsets.weight.abs().max()) == 0.0
        torch.testing.assert_close(attn.sampling_offsets.bias, offset_bias(8, 3, 4), rtol=0, atol=0)
        assert float(attn.attention_weights.weight.abs().max()) == 0.0
        assert float(a.backbone.mask_embedding.abs().max()) == 0.0
        assert float(a.backbone.fusion_tokens.abs().max()) <= 2 * 0.02 / 0.87962566103423978 + 1e-6
    x = {d: torch.from_numpy(v) for d, v in _vit_inputs(20, b=1).items()}
    with torch.no_grad():
        out = a(x)
    assert out["pred_logits"].shape == (1, 10, 4) and out["pred_masks"].shape == (1, 10, 16, 16)
    assert all(torch.isfinite(out[k]).all() for k in ("pred_logits", "pred_masks"))


@pytest.mark.parametrize("change", [dict(backbone_type="resnet50"), dict(backbone_type="swin"),
                                    dict(decoder_type="standard"), dict(fusion_mode="sup")])
def test_unported_variants_raise(change):
    """These variants are ported now (tests/test_torch_backbones_model.py
    holds them against flax): each builds and answers; a value the JAX
    config does not know raises."""
    model = tmf.MaskFormerModel(tmf.MaskFormerConfig(**{**CFG, **change})).eval()
    x = {d: torch.from_numpy(v) for d, v in _vit_inputs(21, b=1).items()}
    with torch.no_grad():
        out = model(x)
    assert out["pred_masks"].shape == (1, 10, 16, 16) and torch.isfinite(out["pred_masks"]).all()
    key = next(iter(change))
    with pytest.raises(ValueError):
        tmf.MaskFormerModel(tmf.MaskFormerConfig(**{**CFG, key: "unknown"}))
