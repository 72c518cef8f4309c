"""The ported MaskFormer on every backbone and decoder of the JAX package
(image 64, dim 32, depth 4, 16 fusion tokens; f32 on the CPU; weights from
``random_params`` through ``params_from_jax``, the injectors' ``gamma`` and
the sampling kernels non-zero):

  * ``MaskFormerModel`` for every ``backbone_type`` ('vit' in 'crossattn'
    and 'sup', 'vit_adapter', 'resnet18' / '50', 'swin') and both
    ``decoder_type`` s against flax (atol 1e-4, as
    tests/test_torch_downstream.py), the tree's names one to one and
    ``flax_path`` back to them, the pixel decoder's widths;
  * ``forward_segmentation`` / ``forward_instance_segmentation`` on them
    against JAX's, the adapter's answer bitwise unmoved by a dropped dem's
    pixels;
  * ``freeze_mask`` and ``load_pretrained_backbone`` against JAX's on every
    backbone; the seeded initializers of the new modules.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu import config as jconfig
from incomplete_multimodal_fusion_tpu import infer_segmentation as jseg
from incomplete_multimodal_fusion_tpu.eval import metrics as jmetrics
from incomplete_multimodal_fusion_tpu.models import maskformer as jmf
from incomplete_multimodal_fusion_tpu.models.multimae import build_multimae as jbuild_multimae
from incomplete_multimodal_fusion_tpu.ops import masking as jmask
from incomplete_multimodal_fusion_tpu.train import downstream as jds
from incomplete_multimodal_fusion_tpu_torch import infer_segmentation as tseg
from incomplete_multimodal_fusion_tpu_torch.models import maskformer as tmf
from incomplete_multimodal_fusion_tpu_torch.models.msda_module import MSDeformAttn, offset_bias
from incomplete_multimodal_fusion_tpu_torch.models.resnet import FrozenBatchNorm
from incomplete_multimodal_fusion_tpu_torch.train import downstream as tds
from incomplete_multimodal_fusion_tpu_torch.utils.jax_params import flax_path, params_from_jax
from tests.test_torch_common import CHANNELS, DOMAINS, as_jax, port_module, random_params, to_np
from tests.test_torch_downstream import CFG as VIT_CFG
from tests.test_torch_downstream import _sharpen_masks

NP_ = 16
CFG = dict(VIT_CFG, depth=4)
# (backbone_type, fusion_mode, decoder_type)
VARIANTS = {
    "vit_adapter": ("vit_adapter", "crossattn", "mask2former"),
    "sup": ("vit", "sup", "mask2former"),
    "resnet18": ("resnet18", "crossattn", "mask2former"),
    "resnet50 standard": ("resnet50", "crossattn", "standard"),
    "swin": ("swin", "crossattn", "mask2former"),
    "vit standard": ("vit", "crossattn", "standard"),
}
WIDTHS = {"vit_adapter": (32,) * 4, "sup": (32,) * 4, "resnet18": (64, 128, 256, 512),
          "resnet50 standard": (256, 512, 1024, 2048), "swin": (96, 192, 384, 768), "vit standard": (32,) * 4}


def cfg_of(name, **kw):
    bt, fm, dec = VARIANTS[name]
    return dict(CFG, backbone_type=bt, fusion_mode=fm, decoder_type=dec, **kw)


def _inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    return {d: rng.standard_normal((b, 64, 64, CHANNELS[d])).astype(np.float32) for d in DOMAINS}


_PAIRS = {}


def model_pair(name):
    """(JAX model, flax params, port model, inputs) of a variant, built once."""
    if name not in _PAIRS:
        x = _inputs(40)
        jm = jmf.MaskFormerModel(jmf.MaskFormerConfig(**cfg_of(name)))
        params = _sharpen_masks(random_params(jm, 41, as_jax(x)))
        tm = port_module(tmf.MaskFormerModel(tmf.MaskFormerConfig(**cfg_of(name))), params)
        _PAIRS[name] = (jm, params, tm, x)
    return _PAIRS[name]


def assert_outputs_close(out, ref):
    """Class logits (order 1) at atol 1e-4; mask logits, whose entries
    reach 80 here (the random weights' scale and ``_sharpen_masks``' x6), at
    atol 1e-4 of the tensor's largest entry, which is f32 rounding's scale
    (their rel-L2 lands near 1e-5)."""
    outs = [out] + out.get("aux_outputs", [])
    refs = [ref] + ref.get("aux_outputs", [])
    assert len(outs) == len(refs)
    for i, (o, r) in enumerate(zip(outs, refs)):
        for key in ("pred_logits", "pred_masks"):
            r_ = np.asarray(r[key])
            atol = 1e-4 * (1.0 if key == "pred_logits" else max(1.0, float(np.abs(r_).max())))
            np.testing.assert_allclose(to_np(o[key]), r_, atol=atol, rtol=0, err_msg=f"output {i} {key}")


@pytest.mark.parametrize("name", VARIANTS)
def test_maskformer_variant_matches_flax(name):
    jm, params, tm, x = model_pair(name)
    assert tm.pixel_decoder.input_proj0.in_features == WIDTHS[name][3]
    assert tm.pixel_decoder.fpn_lateral.in_features == WIDTHS[name][0]
    ref = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, as_jax(x))
    with torch.no_grad():
        out = tm({d: torch.from_numpy(v) for d, v in x.items()})
    assert_outputs_close(out, ref)


@pytest.mark.parametrize("name", VARIANTS)
def test_jax_tree_names_map_one_to_one(name):
    """Every flax leaf lands on one port parameter, and ``flax_path`` gives
    back each parameter's flax module path (the injector's ``gamma``, the
    frozen batch norms' ``scale`` and the bias tables keep their names)."""
    _, params, tm, _ = model_pair(name)
    sd = params_from_jax(params)
    assert len(sd) == len(jax.tree_util.tree_leaves(params))
    assert set(sd) == set(tm.state_dict())
    flax_modules = {"/".join(str(getattr(k, "key", k)) for k in path[:-1])
                    for path, _ in jax.tree_util.tree_leaves_with_path(params)}
    # the input adapters' ``proj_kernel`` / ``proj_bias`` leaves are the
    # port's ``proj`` module
    assert {re.sub(r"(input_adapter_\w+)/proj$", r"\1", flax_path(n).rsplit("/", 1)[0]) for n in sd} == \
        flax_modules
    kept = {"vit_adapter": "backbone.injector0.gamma", "resnet18": "backbone.layer1_0.bn1.scale",
            "swin": "backbone.stage0_block0.attn.relative_position_bias_table",
            "sup": "backbone.return_tokens", "resnet50 standard": "predictor.query_embed"}
    if name in kept:
        assert kept[name] in sd


@pytest.mark.parametrize("name,dropped", [("vit_adapter", ("dem",)), ("vit_adapter", ()), ("resnet18", ()),
                                          ("swin", ()), ("sup", ("s1",))])
def test_forward_segmentation_matches_jax(name, dropped):
    """Label maps equal except where JAX's two best class scores are within
    1e-4; the adapter with dem dropped does not move with dem's pixels (the
    prior module reads s2's, whatever ``present`` says)."""
    jm, params, tm, x = model_pair(name)

    def jax_ref(p, x):
        labels = jseg.forward_segmentation(jm, p, x, 3, drop_modalities=dropped)
        kw = {}
        if dropped and name != "resnet18":
            masks = {d: jnp.full((2, NP_), int(d in dropped), jnp.int32) for d in DOMAINS}
            kw = dict(mask_info=jmask.mask_info_from_task_masks(masks, DOMAINS, 3 * NP_),
                      num_encoded_tokens=3 * NP_, present=jnp.asarray([d not in dropped for d in DOMAINS]))
        jout = jm.apply({"params": p}, x, **kw)
        masks = jax.image.resize(jout["pred_masks"], jout["pred_masks"].shape[:2] + (64, 64), "bilinear")
        return labels, jmetrics.semantic_inference(jout["pred_logits"], masks)

    ref, sem = (np.asarray(a) for a in jax.jit(jax_ref)(params, as_jax(x)))
    out = to_np(tseg.forward_segmentation(tm, None, x, 3, drop_modalities=dropped))
    probs = tseg.semantic_probabilities(tseg.segmentation_outputs(tm, None, x, dropped), (64, 64))
    np.testing.assert_allclose(to_np(probs), sem, atol=1e-4, rtol=0)
    # where no query's mask covers a pixel (sigmoid of logits near -80) every
    # class scores about 0: the label there is a tie
    sem = np.sort(sem, axis=1)
    decided = sem[:, -1] - sem[:, -2] >= 1e-4
    assert out.shape == ref.shape == (2, 64, 64) and decided.mean() > 0.25
    np.testing.assert_array_equal(out[decided], ref[decided])
    if name == "vit_adapter" and dropped:
        x2 = {d: (v * 0.0 + 123.0 if d in dropped else v) for d, v in x.items()}
        a, b = (tseg.segmentation_outputs(tm, None, v, dropped) for v in (x, x2))
        for key in ("pred_logits", "pred_masks"):
            torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)


@pytest.mark.parametrize("name", ["vit_adapter", "resnet50 standard", "swin"])
def test_forward_instance_segmentation_matches_jax(name):
    jm, params, tm, x = model_pair(name)
    ref = jax.jit(lambda p, x: jseg.forward_instance_segmentation(jm, p, x, topk=12))(params, as_jax(x))
    out = tseg.forward_instance_segmentation(tm, None, x, topk=12)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(to_np(o["scores"]), np.asarray(r["scores"]), atol=1e-4)
        np.testing.assert_array_equal(to_np(o["pred_classes"]), np.asarray(r["pred_classes"]))
        decided = np.abs(np.asarray(r["mask_logits"])) >= 1e-4
        np.testing.assert_array_equal(to_np(o["pred_masks"])[decided], np.asarray(r["pred_masks"])[decided])


@pytest.mark.parametrize("name", VARIANTS)
def test_freeze_mask_matches_jax(name):
    _, params, tm, _ = model_pair(name)
    for frozen in (0, 1, 3):
        want = {k: bool(v) for k, v in params_from_jax(jds.freeze_mask(params, frozen)).items()}
        assert tds.freeze_mask(tm, frozen) == want
    mask = tds.freeze_mask(tm, 3)
    if name == "vit_adapter":
        assert all(mask[n] for n in mask if n.startswith(("backbone.spm.", "backbone.injector",
                                                          "backbone.extractor", "backbone.adapter_")))
        assert not mask["backbone.blocks.3.norm1.weight"] and mask["backbone.blocks.0.norm1.weight"]
    if name == "sup":
        assert not mask["backbone.blocks.1.attn.to_q.weight"] and mask["backbone.attn_pool.to_q.weight"]
        assert not mask["backbone.input_adapters.s1.proj.weight"]
    if name in ("resnet18", "swin"):
        assert all(mask.values())


def test_frozen_stages_zero_freezes_nothing():
    """JAX masks the updates only with frozen_stages > 0 (downstream.py:86)."""
    _, _, tm, _ = model_pair("sup")
    opt = tds.create_downstream_optimizer(tm, frozen_stages=0)
    assert len(opt.trainable) == len(opt.params)
    assert len(tds.create_downstream_optimizer(tm, frozen_stages=1).trainable) < len(opt.params)


@pytest.mark.parametrize("name", ["vit_adapter", "sup", "resnet18", "swin"])
def test_load_pretrained_backbone_matches_jax(name):
    _, params, _, _ = model_pair(name)
    pcfg = jconfig.PretrainConfig(
        model=jconfig.ModelConfig(dim_tokens=32, depth=4, dim_head=8, heads=2, ff_mult=4, num_fusion_tokens=16),
        data=jconfig.DataConfig(input_size=64, patch_size=16))
    jmm = jbuild_multimae(pcfg)
    batch = {d: jnp.zeros((1, 64, 64, CHANNELS[d])) for d in DOMAINS}
    pre = random_params(jmm, 42, batch, jmask.full_visible_mask_info(DOMAINS, (NP_,) * 3, 1), 3 * NP_)
    new, report = jds.load_pretrained_backbone(params, pre)
    model = tmf.build_maskformer(tmf.MaskFormerConfig(**cfg_of(name)), device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    got = tds.load_pretrained_backbone(model, params_from_jax(pre))
    assert len(got["copied"]) == len(report["copied"])
    assert len(got["missing_in_ckpt"]) == len(report["missing_in_ckpt"])
    assert len(got["unused_from_ckpt"]) == len(report["unused_from_ckpt"])
    assert (len(got["copied"]) > 0) == name.startswith(("vit", "sup"))
    want = params_from_jax(new)
    for key, p in model.state_dict().items():
        torch.testing.assert_close(p, want[key], rtol=0, atol=0, msg=key)


@pytest.mark.parametrize("name", ["vit_adapter", "sup", "resnet18", "swin", "resnet50 standard"])
def test_initializers_are_jax_s(name):
    """The new modules' JAX initializers where they are not random: zero
    injector gamma and sampling kernels with the offset grid, unit frozen-BN
    scales, zero biases; two generators of one seed give one model."""
    a, b = (tmf.build_maskformer(tmf.MaskFormerConfig(**cfg_of(name)), device="cpu",
                                 generator=torch.Generator().manual_seed(5)) for _ in range(2))
    for (key, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=key)
    for m in a.modules():
        if isinstance(m, MSDeformAttn):
            assert float(m.sampling_offsets.weight.abs().max()) == 0.0
            torch.testing.assert_close(m.sampling_offsets.bias, offset_bias(m.n_heads, m.n_levels, m.n_points))
        if isinstance(m, FrozenBatchNorm):
            assert bool((m.scale == 1).all()) and bool((m.bias == 0).all())
    bb = a.backbone
    if name == "vit_adapter":
        assert all(float(getattr(bb, f"injector{i}").gamma.abs().max()) == 0.0 for i in range(4))
        assert 0 < float(bb.adapter_level_embed.abs().max()) <= 2 * 0.02 / 0.87962566103423978 + 1e-6
    if name == "sup":
        assert 0 < float(bb.return_tokens.abs().max()) <= 2 * 0.02 / 0.87962566103423978 + 1e-6
    if name.startswith("resnet"):  # lecun-normal: std sqrt(1 / fan_in), cut at 2 std
        w = bb.conv1.weight
        assert float(w.abs().max()) <= 2 * (1 / w[0].numel()) ** 0.5 / 0.87962566103423978 + 1e-6
        assert abs(float(w.std()) - (1 / w[0].numel()) ** 0.5) < 0.1 * (1 / w[0].numel()) ** 0.5
    x = {d: torch.from_numpy(v) for d, v in _inputs(43, b=1).items()}
    with torch.no_grad():
        out = a(x)
    assert out["pred_logits"].shape == (1, 10, 4) and out["pred_masks"].shape == (1, 10, 16, 16)
    assert all(torch.isfinite(out[k]).all() for k in ("pred_logits", "pred_masks"))
