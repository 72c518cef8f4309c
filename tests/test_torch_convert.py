"""The port's converter of reference PyTorch checkpoints
(``incomplete_multimodal_fusion_tpu_torch/utils/torch_convert.py``, no JAX)
against the two-step path it replaces (the JAX package's
``utils/torch_convert.py`` then ``params_from_jax``) and against the
executed reference's frozen outputs:

  * the ``w::*`` weights of tests/golden/fullmodel_golden.npz: the same
    tensors bit for bit as the two-step path, and a strict load whose
    ``full::*`` / ``drop::*`` outputs match at 5e-5;
  * the three downstream goldens (pixel decoder, Mask2Former decoder, ViT
    backbone): bit for bit the two-step path's, outputs at the tolerances
    of tests/test_torch_downstream.py (2e-4, 2e-4, 3e-4);
  * a whole MaskFormer checkpoint (the three parts under their reference
    prefixes) and the input forms: torch tensors, DDP's ``module.``.
"""
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu.utils import torch_convert as jconvert
from incomplete_multimodal_fusion_tpu_torch.models import mask2former_decoder as tm2f
from incomplete_multimodal_fusion_tpu_torch.models import pixel_decoder as tpd
from incomplete_multimodal_fusion_tpu_torch.models import vit_baseline as tvit
from incomplete_multimodal_fusion_tpu_torch.models.multimae import MultiMAE as TorchMultiMAE
from incomplete_multimodal_fusion_tpu_torch.ops import masking as tmask
from incomplete_multimodal_fusion_tpu_torch.utils import torch_convert as tconvert
from incomplete_multimodal_fusion_tpu_torch.utils.jax_params import params_from_jax
from tests.test_torch_common import CHANNELS, DOMAINS, SMALL, to_np
from tests.test_torch_downstream import _assert_outputs_close, _chw, _golden
from tests.test_torch_slice import ATOL, G, _golden_forward

FULL_W = {k[len("w::"):]: v for k, v in G.items() if k.startswith("w::")}


def _assert_bitwise(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for name, t in want.items():
        assert got[name].dtype == torch.float32 and got[name].is_contiguous(), name
        assert torch.equal(got[name].view(torch.int32), t.view(torch.int32)), name


def test_multimae_converter_is_the_two_step_path_bit_for_bit():
    got = tconvert.convert_multimae_state(FULL_W, DOMAINS, DOMAINS, CHANNELS, patch_size=16, depth=2,
                                          decoder_depth=2)
    want = params_from_jax(jconvert.convert_multimae_state(FULL_W, DOMAINS, DOMAINS, CHANNELS, patch_size=16,
                                                           depth=2, decoder_depth=2))
    _assert_bitwise(got, want)


@pytest.fixture(scope="module")
def converted_model():
    model = TorchMultiMAE(attn_impl="auto", **SMALL)
    model.load_state_dict(tconvert.convert_multimae_state(FULL_W, DOMAINS, DOMAINS, CHANNELS, patch_size=16,
                                                          depth=2, decoder_depth=2), strict=True)
    return model.eval()


@pytest.mark.parametrize("tag", ["full", "drop"])
def test_multimae_converter_reproduces_the_reference_outputs(converted_model, tag):
    out = _golden_forward(converted_model, tag)
    for d in DOMAINS:
        np.testing.assert_allclose(to_np(out["preds"][d]), G[f"{tag}::pred_{d}"].transpose(0, 2, 3, 1),
                                   atol=ATOL, err_msg=d)
        np.testing.assert_allclose(to_np(out["pooled_mod"][d]), G[f"{tag}::pool_{d}"][:, 0], atol=ATOL)
    np.testing.assert_allclose(to_np(out["fusion_tokens"]), G[f"{tag}::fusion_tokens"], atol=ATOL)


def test_converter_takes_tensors_and_ddp_prefixes():
    wrapped = {f"module.{k}": torch.from_numpy(v.copy()) for k, v in FULL_W.items()}
    got = tconvert.convert_multimae_state(wrapped, DOMAINS, DOMAINS, CHANNELS, patch_size=16, depth=2,
                                          decoder_depth=2)
    _assert_bitwise(got, tconvert.convert_multimae_state(FULL_W, DOMAINS, DOMAINS, CHANNELS, patch_size=16,
                                                         depth=2, decoder_depth=2))


def test_pixel_decoder_golden_through_the_converter():
    g, w = _golden("pixel_decoder")
    sd = tconvert.convert_pixel_decoder_state(w, enc_layers=1)
    _assert_bitwise(sd, params_from_jax(jconvert.convert_pixel_decoder_state(w, enc_layers=1)))
    model = tpd.MSDeformAttnPixelDecoder((8, 16, 24, 40), conv_dim=32, mask_dim=32, transformer_enc_layers=1,
                                         n_heads=8, dim_feedforward=64, n_points=4, dropout=0.0,
                                         num_fpn_levels=1)
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        mask_features, ms = model.eval()([_chw(g[f"x_res{i}"]) for i in (2, 3, 4, 5)])
    for i in range(3):
        np.testing.assert_allclose(to_np(ms[i]), g[f"ms_{i}"].transpose(0, 2, 3, 1), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(to_np(mask_features), g["mask_features"].transpose(0, 2, 3, 1), rtol=2e-4,
                               atol=2e-4)


def test_mask2former_decoder_golden_through_the_converter():
    g, w = _golden("mask2former_decoder")
    sd = tconvert.convert_mask2former_decoder_state(w, hidden_dim=32, dec_layers=3)
    _assert_bitwise(sd, params_from_jax(jconvert.convert_mask2former_decoder_state(w, hidden_dim=32,
                                                                                   dec_layers=3)))
    model = tm2f.MultiScaleMaskedTransformerDecoder(num_classes=3, hidden_dim=32, num_queries=5, n_heads=4,
                                                    dim_feedforward=64, dec_layers=3, mask_dim=16)
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = model.eval()([_chw(g[f"x_{i}"]) for i in range(3)], _chw(g["mask_features"]))
    ref = {"pred_logits": g["pred_logits"], "pred_masks": g["pred_masks"],
           "aux_outputs": [{"pred_logits": g[f"aux_{i}_logits"], "pred_masks": g[f"aux_{i}_masks"]}
                           for i in range(3)]}
    _assert_outputs_close(out, ref, 2e-4, 2e-4)


def test_vit_baseline_golden_through_the_converter():
    g, w = _golden("vit_baseline")
    sd = tconvert.convert_vit_baseline_state(w, DOMAINS, depth=4)
    _assert_bitwise(sd, params_from_jax(jconvert.convert_vit_baseline_state(w, DOMAINS, depth=4)))
    model = tvit.ViTBaseline(in_domains=DOMAINS, image_size=64, patch_size=16, dim_tokens=64, depth=4,
                             dim_head=16, heads=2, num_fusion_tokens=16)
    model.load_state_dict(sd, strict=True)
    mi = tmask.full_visible_mask_info(DOMAINS, (16,) * 3, 2)
    with torch.no_grad():
        feats = model.eval()({d: _chw(g[f"x_{d}"]) for d in DOMAINS}, mi, 48)
    for i, f in enumerate(feats):
        np.testing.assert_allclose(to_np(f), g[f"f_{i}"].transpose(0, 2, 3, 1), rtol=3e-4, atol=3e-4)


def test_maskformer_checkpoint_is_the_two_step_path_bit_for_bit():
    """The three downstream goldens' weights as one checkpoint under the
    reference's prefixes (MaskFormerModel_vit.py)."""
    state = {}
    for name, prefix in (("vit_baseline", "backbone."), ("pixel_decoder", "sem_seg_head.pixel_decoder."),
                         ("mask2former_decoder", "sem_seg_head.predictor.")):
        state.update({prefix + k: v for k, v in _golden(name)[1].items()})
    kw = dict(depth=4, enc_layers=1, dec_layers=3, hidden_dim=32)
    got = tconvert.convert_maskformer_state(state, DOMAINS, **kw)
    want = params_from_jax(jconvert.convert_maskformer_state(state, DOMAINS, **kw))
    _assert_bitwise(got, want)
    assert {k.split(".")[0] for k in got} == {"backbone", "pixel_decoder", "predictor"}
