"""The ported downstream backbones' parts against the JAX package, f32 on
the CPU, weights from ``random_params`` carried by ``params_from_jax`` (the
injector's ``gamma``, the sampling-offset and attention-weight kernels drawn
non-zero, so the interleaving and the deformable samples show):

  * K4's plain core at the ViT-Adapter's injector and extractor shapes
    against the JAX core (atol 1e-5), and the MSDeformAttn module's bf16
    route (operands cast up around K4's Function) against the plain core;
  * ``SpatialPriorModule``, ``Injector`` and ``Extractor``;
  * ``ViTBaseline(adapter=True)`` and ``ViTBaseline(fusion_mode='sup')``;
  * ResNet-18 and -50, and Swin at a small ``embed_dim``; Swin's block
    against tests/golden/swin_golden.npz (atol 2e-5, as
    tests/test_swin_parity.py);
  * the standard decoder against JAX in both norm orders and the DETR stack
    against tests/golden/detr_golden.npz (rtol / atol 1e-4, as
    tests/test_detr_parity.py);
  * the DPT utilities (atol 1e-5).
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu.models import dpt_utils as jdpt
from incomplete_multimodal_fusion_tpu.models import maskformer_decoder as jmfd
from incomplete_multimodal_fusion_tpu.models import resnet as jresnet
from incomplete_multimodal_fusion_tpu.models import swin as jswin
from incomplete_multimodal_fusion_tpu.models import vit_adapter as jva
from incomplete_multimodal_fusion_tpu.models import vit_baseline as jvit
from incomplete_multimodal_fusion_tpu.ops import masking as jmask
from incomplete_multimodal_fusion_tpu.ops.msda import ms_deform_attn_core as jcore
from incomplete_multimodal_fusion_tpu_torch.models import dpt_utils as tdpt
from incomplete_multimodal_fusion_tpu_torch.models import maskformer_decoder as tmfd
from incomplete_multimodal_fusion_tpu_torch.models import resnet as tresnet
from incomplete_multimodal_fusion_tpu_torch.models import swin as tswin
from incomplete_multimodal_fusion_tpu_torch.models import vit_adapter as tva
from incomplete_multimodal_fusion_tpu_torch.models import vit_baseline as tvit
from incomplete_multimodal_fusion_tpu_torch.models.layers import LayerNorm
from incomplete_multimodal_fusion_tpu_torch.models.msda_module import MSDeformAttn
from incomplete_multimodal_fusion_tpu_torch.models.pixel_decoder import reference_points_for
from incomplete_multimodal_fusion_tpu_torch.ops import masking as tmask
from incomplete_multimodal_fusion_tpu_torch.ops.msda import ms_deform_attn_core
from tests.test_detr_parity import _lin, _mha_params, _norm
from tests.test_torch_common import CHANNELS, DOMAINS, as_jax, port_module, random_params, to_np
from tests.test_torch_downstream import _nhwc, jit_apply

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
NP_ = 16


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(out, ref, atol, rtol=0.0):
    if isinstance(ref, (list, tuple)):
        assert len(out) == len(ref)
        for o, r in zip(out, ref):
            _close(o, r, atol, rtol)
        return
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# K4's plain core at the adapter's shapes, and the module's bf16 route
# ---------------------------------------------------------------------------

# (label, batch, queries, value levels (H, W), heads, dim, points): the
# injector's 256 fusion tokens over the priors at strides 8 / 16 / 32 of a
# 256^2 image, the extractor's 1344 priors over the 16^2 token map
ADAPTER_MSDA = (("injector", 1, 256, ((32, 32), (16, 16), (8, 8)), 6, 32, 4),
                ("extractor", 1, 1344, ((16, 16),), 6, 32, 4),
                ("injector small", 2, 16, ((8, 8), (4, 4), (2, 2)), 8, 4, 4))


def _msda_inputs(seed, b, lq, shapes, m, d, p):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in shapes)
    value = rng.standard_normal((b, s, m, d)).astype(np.float32)
    locs = rng.uniform(-0.1, 1.1, (b, lq, m, len(shapes), p, 2)).astype(np.float32)
    aw = rng.random((b, lq, m, len(shapes), p)).astype(np.float32)
    return value, locs, aw / aw.sum(axis=(3, 4), keepdims=True)


@pytest.mark.parametrize("case", ADAPTER_MSDA, ids=[c[0] for c in ADAPTER_MSDA])
def test_msda_core_at_the_adapter_shapes(case):
    _, b, lq, shapes, m, d, p = case
    value, locs, aw = _msda_inputs(1, b, lq, shapes, m, d, p)
    ref = jax.jit(jcore, static_argnums=1)(jnp.asarray(value), shapes, jnp.asarray(locs), jnp.asarray(aw))
    out = ms_deform_attn_core(_t(value), shapes, _t(locs), _t(aw))
    _close(out, ref, 1e-5)


@pytest.mark.parametrize("levels", [((8, 8), (4, 4), (2, 2)), ((4, 4),)])
def test_msda_module_bf16_route_is_the_plain_core(levels):
    """A bf16 call through K4's Function (the CPU runs its plain version)
    computes what the plain core computes on the bf16 operands: the f32
    up-cast is exact and the one rounding is the output's; the gradients
    reach the bf16 parameters through the casts."""
    torch.manual_seed(0)
    mod = MSDeformAttn(32, len(levels), 8, 4)
    with torch.no_grad():
        for lin in (mod.sampling_offsets, mod.attention_weights):
            lin.weight.normal_(0.0, 0.2)
    mod = mod.to(torch.bfloat16)
    s = sum(h * w for h, w in levels)
    q = torch.randn(2, 12, 32).to(torch.bfloat16)
    v = torch.randn(2, s, 32).to(torch.bfloat16)
    ref_pts = torch.rand(2, 12, len(levels), 2)
    outs, grads = [], []
    for impl in ("auto", "xla"):
        mod.impl = impl
        mod.zero_grad()
        out = mod(q, ref_pts, v, levels)
        out.float().square().sum().backward()
        outs.append(out)
        grads.append({n: p.grad.clone() for n, p in mod.named_parameters()})
    assert outs[0].dtype == torch.bfloat16
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    for name in grads[1]:
        torch.testing.assert_close(grads[0][name].float(), grads[1][name].float(), rtol=2e-2, atol=2e-2,
                                   msg=name)
    assert float(grads[0]["sampling_offsets.weight"].float().abs().sum()) > 0


# ---------------------------------------------------------------------------
# the adapter's modules
# ---------------------------------------------------------------------------

def test_spatial_prior_module_matches_flax():
    x = _nhwc(np.random.default_rng(2), 2, 64, 64, 3)
    jm = jva.SpatialPriorModule(32)
    params = random_params(jm, 3, jnp.asarray(x))
    ref = jit_apply(jm, params, jnp.asarray(x))
    out = port_module(tva.SpatialPriorModule(3, 32), params)(_t(x))
    assert [tuple(o.shape) for o in out] == [(2, 16, 16, 32), (2, 8, 8, 32), (2, 4, 4, 32), (2, 2, 2, 32)]
    _close(out, ref, 1e-4)


PRIOR_SHAPES = ((8, 8), (4, 4), (2, 2))


def test_injector_matches_flax():
    rng = np.random.default_rng(4)
    s = sum(h * w for h, w in PRIOR_SHAPES)
    tokens, priors = _nhwc(rng, 2, 16, 32), _nhwc(rng, 2, s, 32)
    ref_pts = np.broadcast_to(to_np(reference_points_for([(4, 4)]))[None, :, :1], (2, 16, 3, 2)).copy()
    jm = jva.Injector(32)
    args = (jnp.asarray(tokens), jnp.asarray(ref_pts), jnp.asarray(priors), PRIOR_SHAPES)
    params = random_params(jm, 5, *args)
    assert float(np.abs(params["gamma"]).min()) > 0
    ref = jit_apply(jm, params, *args)
    tm = port_module(tva.Injector(32, 3), params)
    assert tm.attn.n_heads == jva._deform_heads(32) == 8
    with torch.no_grad():
        out = tm(_t(tokens), _t(ref_pts), _t(priors), PRIOR_SHAPES)
    _close(out, ref, 1e-5)
    assert not np.allclose(to_np(out), tokens, atol=1e-3)  # gamma moves the tokens


def test_extractor_matches_flax():
    rng = np.random.default_rng(6)
    s = sum(h * w for h, w in PRIOR_SHAPES)
    priors, tokens = _nhwc(rng, 2, s, 32), _nhwc(rng, 2, 16, 32)
    ref_pts = np.broadcast_to(to_np(reference_points_for(PRIOR_SHAPES))[None, :, :1], (2, s, 1, 2)).copy()
    jm = jva.Extractor(32)
    args = (jnp.asarray(priors), jnp.asarray(ref_pts), jnp.asarray(tokens))
    params = random_params(jm, 7, *args, (4, 4))
    ref = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, (4, 4)))(params, *args)
    with torch.no_grad():
        out = port_module(tva.Extractor(32), params)(_t(priors), _t(ref_pts), _t(tokens), (4, 4))
    _close(out, ref, 1e-5)


@pytest.mark.parametrize("dim,heads", [(192, 6), (32, 8), (12, 6), (10, 2), (7, 1)])
def test_deform_heads_match_jax(dim, heads):
    assert tva.deform_heads(dim) == jva._deform_heads(dim) == heads


# ---------------------------------------------------------------------------
# ViTBaseline with the adapter, and in 'sup' mode
# ---------------------------------------------------------------------------

VIT = dict(in_domains=DOMAINS, image_size=64, patch_size=16, dim_tokens=32, depth=4, dim_head=8, heads=2,
           num_fusion_tokens=16)


def _vit_inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    return {d: _nhwc(rng, b, 64, 64, CHANNELS[d]) for d in DOMAINS}


@pytest.fixture(scope="module")
def vit_modes():
    x = _vit_inputs(8)
    mi = jmask.full_visible_mask_info(DOMAINS, (NP_,) * 3, 2)
    out = {}
    for name, kw in (("adapter", dict(adapter=True)), ("sup", dict(fusion_mode="sup"))):
        jm = jvit.ViTBaseline(**VIT, **kw)
        params = random_params(jm, 9, as_jax(x), mi, 3 * NP_)
        out[name] = (jm, params, port_module(tvit.ViTBaseline(**VIT, **kw), params))
    return out, x


def test_interaction_groups_match_jax():
    for depth in (2, 4, 12):
        cfg = dict(VIT, depth=depth)
        j, t = jvit.ViTBaseline(**cfg, adapter=True), tvit.ViTBaseline(**cfg, adapter=True)
        assert t.interaction_groups == j.interaction_groups
        assert t.tap_layers == j.tap_layers
    assert tvit.ViTBaseline(**dict(VIT, depth=12)).interaction_groups == [(0, 2), (3, 5), (6, 8), (9, 11)]


@pytest.mark.parametrize("mode,case", [("adapter", "all"), ("adapter", "dem_absent"), ("adapter", "random_e40"),
                                       ("sup", "all"), ("sup", "random_e40")])
def test_vit_baseline_mode_matches_flax(vit_modes, mode, case):
    """The 4 pyramid maps: every token visible; dem's tokens masked and its
    plane out of the fusion stack; random masks packed into 40 slots ('sup'
    reads neither masks nor ``present``, as JAX)."""
    models, x = vit_modes
    jm, params, tm = models[mode]
    present = np.array([True, True, case != "dem_absent"])
    if case == "random_e40":
        flat = (np.random.default_rng(10).random((2, 3 * NP_)) < 0.6).astype(np.int64)
        e = 40
        jmi = jmask.mask_info_from_flat_mask(jnp.asarray(flat), DOMAINS, (NP_,) * 3, e)
        tmi = tmask.mask_info_from_flat_mask(torch.from_numpy(flat), DOMAINS, (NP_,) * 3, e)
    else:
        masks = {d: np.full((2, NP_), int(not p), np.int64) for d, p in zip(DOMAINS, present)}
        e = 3 * NP_
        jmi = jmask.mask_info_from_task_masks(as_jax(masks), DOMAINS, e)
        tmi = tmask.mask_info_from_task_masks({d: torch.from_numpy(m) for d, m in masks.items()}, DOMAINS, e)
    ref = jax.jit(lambda p, x, mi, pr: jm.apply({"params": p}, x, mi, e, present=pr))(
        params, as_jax(x), jmi, jnp.asarray(present))
    with torch.no_grad():
        out = tm({d: _t(v) for d, v in x.items()}, tmi, e, present=torch.from_numpy(present))
    assert [tuple(o.shape) for o in out] == [(2, 16, 16, 32), (2, 8, 8, 32), (2, 4, 4, 32), (2, 2, 2, 32)]
    _close(out, ref, 1e-4)


def test_adapter_priors_reach_the_encoder(vit_modes):
    """The interleaving (JAX tests/test_backbones.py:76-141 on the port):
    with gamma != 0 a change to the prior module alone moves the fusion
    tokens the last block sees; with gamma = 0 it moves only the priors'
    own maps."""
    models, x = vit_modes
    tm = models["adapter"][2]
    mi = tmask.full_visible_mask_info(DOMAINS, (NP_,) * 3, 2)
    xt = {d: _t(v) for d, v in x.items()}

    def block3(spm_shift, gamma):
        m, seen = copy.deepcopy(tm), {}
        m.blocks[3].register_forward_hook(lambda mod, a, o: seen.__setitem__("out", o))
        with torch.no_grad():
            for i in range(len(m.interaction_groups)):
                getattr(m, f"injector{i}").gamma.fill_(gamma)
            for c in m.spm.modules():
                if isinstance(c, torch.nn.Conv2d):
                    c.weight.add_(spm_shift)
            m(xt, mi, 3 * NP_)
        return seen["out"]

    assert not torch.allclose(block3(0.0, 1.0), block3(0.5, 1.0), atol=1e-6)
    torch.testing.assert_close(block3(0.0, 0.0), block3(0.5, 0.0), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# ResNet and Swin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [18, 50])
def test_resnet_matches_flax(depth):
    x = _nhwc(np.random.default_rng(11), 2, 64, 64, 3)
    jm = jresnet.ResNet(depth=depth)
    params = random_params(jm, 12, jnp.asarray(x))
    ref = jit_apply(jm, params, jnp.asarray(x))
    tm = port_module(tresnet.ResNet(depth, 3), params)
    with torch.no_grad():
        out = tm(_t(x))
    widths = (64, 128, 256, 512) if depth == 18 else (256, 512, 1024, 2048)
    assert tm.out_channels == widths
    assert [tuple(o.shape) for o in out] == [(2, 64 // s, 64 // s, c) for s, c in zip((4, 8, 16, 32), widths)]
    _close(out, ref, 1e-4, 1e-4)


@pytest.mark.parametrize("depth,blocks", [(34, (3, 4, 6, 3)), (101, (3, 4, 23, 3)), (152, (3, 8, 36, 3))])
def test_resnet_depths_build(depth, blocks):
    """The deeper specs (RESNET_SPEC, resnet.py:78-84) lay out the same
    stages as JAX's: block counts, widths and parameter count."""
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jresnet.ResNet(depth=depth).init(jax.random.PRNGKey(0), x))["params"]
    tm = tresnet.ResNet(depth, 3)
    assert tresnet.RESNET_SPEC[depth][1] == blocks
    assert sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes)) == \
        sum(p.numel() for p in tm.parameters())
    with torch.no_grad():
        out = tm(torch.zeros(1, 32, 32, 3))
    assert [o.shape[-1] for o in out] == list(tm.out_channels)


SWIN_SMALL = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16))


def test_swin_matches_flax():
    """64^2: stage 0 (16^2) and 1 (8^2) shift and pad to the window, stage 2
    (4^2) takes a smaller window without the shift."""
    x = _nhwc(np.random.default_rng(13), 2, 64, 64, 3)
    jm = jswin.SwinTransformer(**SWIN_SMALL)
    params = random_params(jm, 14, jnp.asarray(x))
    ref = jit_apply(jm, params, jnp.asarray(x))
    tm = port_module(tswin.SwinTransformer(**SWIN_SMALL), params)
    with torch.no_grad():
        out = tm(_t(x))
    assert tm.out_channels == (32, 64, 128, 256)
    _close(out, ref, 1e-4, 1e-4)


def test_swin_t_parameter_count_matches_jax():
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jswin.SwinTransformer().init(jax.random.PRNGKey(0), x))["params"]
    assert sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes)) == \
        sum(p.numel() for p in tswin.SwinTransformer().parameters())


SWIN_G = dict(np.load(os.path.join(GOLDEN, "swin_golden.npz")))


def test_swin_relative_position_index_golden():
    np.testing.assert_array_equal(tswin.relative_position_index(7, 7), SWIN_G["rel_index"])
    for w in (3, 5, 7):
        np.testing.assert_array_equal(tswin.relative_position_index(w, 7), jswin.relative_position_index(w, 7))


@pytest.mark.parametrize("tag,h,w,shift", [("plain", 14, 14, 0), ("shift", 14, 14, 3), ("shift_pad", 10, 10, 3)])
def test_swin_block_golden(tag, h, w, shift):
    """The reference block's frozen outputs, its weights loaded by their
    torch names (the port's)."""
    blk = tswin.SwinBlock(32, 2, 7, shift=shift)
    state = {k[len("w::"):]: torch.from_numpy(v) for k, v in SWIN_G.items()
             if k.startswith("w::") and not k.endswith("relative_position_index")}
    blk.load_state_dict(state, strict=True)
    with torch.no_grad():
        y = blk(torch.from_numpy(SWIN_G[f"{tag}::x"].reshape(2, h, w, 32)))
    np.testing.assert_allclose(to_np(y).reshape(2, h * w, 32), SWIN_G[f"{tag}::y"], atol=2e-5, err_msg=tag)


# ---------------------------------------------------------------------------
# the standard (DETR-style) decoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pre_norm", [False, True])
@pytest.mark.parametrize("enc_layers,in_ch", [(0, 32), (1, 24)])
def test_standard_decoder_matches_flax(pre_norm, enc_layers, in_ch):
    rng = np.random.default_rng(15)
    x, mf = _nhwc(rng, 2, 4, 5, in_ch), _nhwc(rng, 2, 8, 10, 16)
    jm = jmfd.StandardTransformerDecoder(num_classes=3, hidden_dim=32, num_queries=7, n_heads=4,
                                         dim_feedforward=48, enc_layers=enc_layers, dec_layers=3, mask_dim=16,
                                         pre_norm=pre_norm)
    params = random_params(jm, 16, jnp.asarray(x), jnp.asarray(mf))
    ref = jit_apply(jm, params, jnp.asarray(x), jnp.asarray(mf))
    tm = port_module(tmfd.StandardTransformerDecoder(3, in_ch, 32, 7, 4, 48, enc_layers, 3, 16, pre_norm), params)
    with torch.no_grad():
        out = tm(_t(x), _t(mf))
    assert len(out["aux_outputs"]) == len(ref["aux_outputs"]) == 2
    for key in ("pred_logits", "pred_masks"):
        _close(out[key], ref[key], 1e-4, 1e-4)
        _close([a[key] for a in out["aux_outputs"]], [a[key] for a in ref["aux_outputs"]], 1e-4, 1e-4)


@pytest.mark.parametrize("tag,pre", [("post", False), ("pre", True)])
def test_detr_transformer_golden(tag, pre):
    """The DETR stack the standard decoder builds (one encoder layer, two
    decoder layers with decoder_norm'd intermediates) on the executed
    reference's frozen tensors (tests/test_detr_parity.py's weights)."""
    g = np.load(os.path.join(GOLDEN, "detr_golden.npz"))
    w = {k[len(f"{tag}_w_"):]: g[k] for k in g.files if k.startswith(f"{tag}_w_")}
    d = 32

    def layer(p, names):
        out = {n: _mha_params(w, f"{p}.{n}", d) for n in names}
        out.update(linear1=_lin(w, f"{p}.linear1"), linear2=_lin(w, f"{p}.linear2"))
        out.update({f"norm{i}": _norm(w, f"{p}.norm{i}") for i in (1, 2, 3) if f"{p}.norm{i}.weight" in w})
        return out

    enc = port_module(tmfd._EncoderLayer(d, 4, 64, pre), layer("encoder.layers.0", ["self_attn"]))
    decs = [port_module(tmfd._DecoderLayer(d, 4, 64, pre),
                        layer(f"decoder.layers.{i}", ["self_attn", "multihead_attn"])) for i in range(2)]
    dec_norm = port_module(LayerNorm(d, eps=tmfd.EPS), _norm(w, "decoder.norm"))
    b, c, h, ww = g["src"].shape
    src = torch.from_numpy(g["src"]).reshape(b, c, h * ww).transpose(1, 2)
    pos = torch.from_numpy(g["pos"]).reshape(b, c, h * ww).transpose(1, 2)
    qpos = torch.from_numpy(g["query"])[None].expand(b, -1, -1)
    with torch.no_grad():
        memory = enc(src, pos)
        if pre:
            memory = port_module(LayerNorm(d, eps=tmfd.EPS), _norm(w, "encoder.norm"))(memory)
        tgt, hs = torch.zeros(b, qpos.shape[1], c), []
        for dec in decs:
            tgt = dec(tgt, memory, pos, qpos)
            hs.append(dec_norm(tgt))
    np.testing.assert_allclose(to_np(torch.stack(hs)), g[f"{tag}_hs"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_np(memory), g[f"{tag}_memory"].reshape(b, c, h * ww).transpose(0, 2, 1),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the DPT utilities
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_out,n_in,align", [(8, 4, True), (8, 4, False), (3, 7, False), (1, 5, True),
                                              (6, 1, False)])
def test_interp_matrix_matches_jax(n_out, n_in, align):
    np.testing.assert_allclose(to_np(tdpt.interp_matrix(n_out, n_in, align)),
                               np.asarray(jdpt._interp_matrix(n_out, n_in, align)), atol=1e-7)


@pytest.mark.parametrize("name", ["interpolate", "interpolate_align", "convnext", "convnext_scale",
                                  "residual_unit", "fusion", "fusion_lateral", "scratch", "dpt_head"])
def test_dpt_utils_match_flax(name):
    rng = np.random.default_rng(17)
    x = _nhwc(rng, 2, 6, 8, 16)
    pyr = [_nhwc(rng, 2, 16 // s, 16 // s, c) for s, c in ((1, 8), (2, 16), (4, 24), (8, 32))]
    cases = {
        "interpolate": (jdpt.Interpolate(2.0), tdpt.Interpolate(2.0), (x,)),
        "interpolate_align": (jdpt.Interpolate(0.5, True), tdpt.Interpolate(0.5, True), (x,)),
        "convnext": (jdpt.ConvNeXtBlock(16), tdpt.ConvNeXtBlock(16), (x,)),
        "convnext_scale": (jdpt.ConvNeXtBlock(16, 0.5), tdpt.ConvNeXtBlock(16, 0.5), (x,)),
        "residual_unit": (jdpt.ResidualConvUnit(16), tdpt.ResidualConvUnit(16), (x,)),
        "fusion": (jdpt.FeatureFusionBlock(16), None, (x,)),
        "fusion_lateral": (jdpt.FeatureFusionBlock(16), tdpt.FeatureFusionBlock(16), (x, x + 1.0)),
        "scratch": (jdpt.Scratch(12), tdpt.Scratch((8, 16, 24, 32), 12), (pyr,)),
        "dpt_head": (jdpt.DPTHead(features=16, out_channels=2), tdpt.DPTHead((8, 16, 24, 32), 16, 2), (pyr,)),
    }
    jm, tm, args = cases[name]
    jargs = [[jnp.asarray(a) for a in v] if isinstance(v, list) else jnp.asarray(v) for v in args]
    targs = [[_t(a) for a in v] if isinstance(v, list) else _t(v) for v in args]
    if name == "fusion":  # the lateral's unit exists, unused without a lateral
        params = random_params(jm, 18, jargs[0], jargs[0])
        tm = tdpt.FeatureFusionBlock(16)
    else:
        params = random_params(jm, 18, *jargs) if jax.tree_util.tree_leaves(
            jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *jargs))) else {}
    ref = jm.apply({"params": params}, *jargs)
    if params:
        port_module(tm, params)
    with torch.no_grad():
        out = tm(*targs)
    _close(out, ref, 1e-5, 1e-5)
