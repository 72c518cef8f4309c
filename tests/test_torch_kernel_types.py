"""Kernel K1's token types: ``multimae.pack_tokens``, which the MultiMAE
encoder and the segmentation backbone share, hands K1 int32 types (so its
wrapper casts nothing), equal in value to the JAX package's padded types
``where(valid, types, PAD_TYPE)`` (models/multimae.py:336,
models/vit_baseline.py:226) on the same injected ``MaskInfo``; and both
backbones pass them to K1's wrapper unchanged."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu.ops import attention as jattn
from incomplete_multimodal_fusion_tpu.ops import masking as jmask
from incomplete_multimodal_fusion_tpu.ops.pallas_attn import PAD_TYPE
from incomplete_multimodal_fusion_tpu_torch.models.multimae import MultiMAE, pack_tokens
from incomplete_multimodal_fusion_tpu_torch.models.vit_baseline import ViTBaseline
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_attn
from incomplete_multimodal_fusion_tpu_torch.ops import masking as tmask
from tests.test_torch_common import CHANNELS, DOMAINS, NP_, SMALL, to_np

VIT = dict(in_domains=DOMAINS, image_size=64, patch_size=16, dim_tokens=64, depth=3, dim_head=16,
           heads=2, num_fusion_tokens=16)


def _flat(seed, b=3):
    """[B, 3 * NP_] masks: random, one row all visible, one row with a
    whole modality dropped."""
    rng = np.random.default_rng(seed)
    flat = (rng.random((b, 3 * NP_)) < 0.5).astype(np.int64)
    flat[1] = 0
    flat[2, NP_:2 * NP_] = 1
    return flat


@pytest.mark.parametrize("e", [48, 24])
def test_pack_tokens_hands_k1_int32_types_equal_to_jax(e):
    flat = _flat(6)
    mj = jmask.mask_info_from_flat_mask(jnp.asarray(flat), DOMAINS, (NP_,) * 3, e)
    mt = tmask.mask_info_from_flat_mask(torch.from_numpy(flat), DOMAINS, (NP_,) * 3, e)
    types = jattn.packed_token_types(mj.order, (NP_,) * 3, e, 16, 3)
    want = np.asarray(jnp.where(jattn.packed_valid(mj.num_visible, e, 16), types, PAD_TYPE))
    tokens_in = [torch.zeros(3, NP_, 8) for _ in DOMAINS]
    layout = pack_tokens(tokens_in, torch.zeros(3, 16, 8), mt, e, NP_)
    assert layout.kernel_types.dtype == torch.int32
    np.testing.assert_array_equal(to_np(layout.kernel_types), want)
    assert cuda_attn.PAD_TYPE == PAD_TYPE


@pytest.mark.parametrize("backbone", ["multimae", "vit_baseline"])
def test_backbones_pass_int32_types_to_k1(monkeypatch, backbone):
    seen = []
    real = cuda_attn.zorro_attention_qkv

    def spy(qkv, heads, types=None, *args, **kwargs):
        seen.append(types)
        return real(qkv, heads, types, *args, **kwargs)

    monkeypatch.setattr(cuda_attn, "zorro_attention_qkv", spy)
    rng = np.random.default_rng(7)
    x = {d: torch.from_numpy(rng.standard_normal((3, 64, 64, CHANNELS[d])).astype(np.float32)) for d in DOMAINS}
    e = 40
    mi = tmask.mask_info_from_flat_mask(torch.from_numpy(_flat(8)), DOMAINS, (NP_,) * 3, e)
    torch.manual_seed(0)
    model = MultiMAE(attn_impl="auto", **SMALL) if backbone == "multimae" else ViTBaseline(**VIT)
    with torch.no_grad():
        model(x, mi, e)
    depth = SMALL["depth"] if backbone == "multimae" else VIT["depth"]
    encoder = [t for t in seen if t is not None]  # the MultiMAE decoder's unmasked calls pass None
    assert len(encoder) == depth
    assert all(t.dtype == torch.int32 and t.shape == (3, e + 16) for t in encoder)
