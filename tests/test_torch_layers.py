"""Each ported layer against its flax module at narrow widths, with the same
weights carried across by utils.jax_params.params_from_jax (atol 2e-5, f32).
The port runs with and without ``use_kernel``: on CPU tensors both take the
plain versions, so both must match."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu.models import adapters as jadapters
from incomplete_multimodal_fusion_tpu.models import layers as jlayers
from incomplete_multimodal_fusion_tpu_torch.models import adapters as tadapters
from incomplete_multimodal_fusion_tpu_torch.models import layers as tlayers
from tests.test_torch_common import port_module, random_params, to_np

ATOL = 2e-5
DIM, DH, HEADS = 64, 16, 2


def _types(b=2):
    rows = [[0] * 10 + [1] * 8 + [2] * 4 + [255] * 2 + [3] * 16,
            [1] * 12 + [2] * 6 + [255] * 6 + [3] * 16][:b]
    return np.asarray(rows, np.int32)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_zorro_attention_self(use_kernel):
    x, types = _x((2, 40, DIM)), _types()
    jm = jlayers.ZorroAttention(dim_head=DH, heads=HEADS)
    params = random_params(jm, 1, jnp.asarray(x), packed_types=jnp.asarray(types), fusion_type=3)
    ref = jm.apply({"params": params}, jnp.asarray(x), packed_types=jnp.asarray(types),
                   fusion_type=3, use_pallas="auto")
    tm = port_module(tlayers.ZorroAttention(DIM, DH, HEADS), params)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), packed_types=torch.from_numpy(types), fusion_type=3,
                 use_kernel=use_kernel)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=ATOL)


def test_zorro_attention_cross_with_empty_rows():
    """The pool form: masked cross-attention, a query row with no key
    attends uniformly over the valid keys."""
    rng = np.random.default_rng(2)
    q, ctx = _x((2, 4, DIM), 3), _x((2, 40, DIM), 4)
    mask = rng.random((2, 1, 4, 40)) < 0.4
    mask[0, :, 2] = False
    valid = rng.random((2, 1, 1, 40)) < 0.8
    jm = jlayers.ZorroAttention(dim_head=DH, heads=HEADS)
    params = random_params(jm, 5, jnp.asarray(q), context=jnp.asarray(ctx))
    ref = jm.apply({"params": params}, jnp.asarray(q), context=jnp.asarray(ctx),
                   attn_mask=jnp.asarray(mask), empty_rows_uniform_over=jnp.asarray(valid))
    tm = port_module(tlayers.ZorroAttention(DIM, DH, HEADS), params)
    with torch.no_grad():
        out = tm(torch.from_numpy(q), context=torch.from_numpy(ctx), attn_mask=torch.from_numpy(mask),
                 empty_rows_uniform_over=torch.from_numpy(valid))
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_encoder_block(use_kernel):
    x, types = _x((2, 40, DIM), 6), _types()
    jm = jlayers.EncoderBlock(dim_head=DH, heads=HEADS, ff_mult=4)
    params = random_params(jm, 7, jnp.asarray(x), packed_types=jnp.asarray(types), fusion_type=3)
    ref = jm.apply({"params": params}, jnp.asarray(x), packed_types=jnp.asarray(types),
                   fusion_type=3, use_pallas="auto")
    tm = port_module(tlayers.EncoderBlock(DIM, DH, HEADS, 4), params)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(types), 3, use_kernel=use_kernel)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_fusion_block_fast(use_kernel):
    """The gather-built KV grid against the JAX one-hot product, with padding
    slots and a fully dropped modality in the grid."""
    b, e, f, t = 2, 24, 16, 3
    rng = np.random.default_rng(8)
    packed, fusion, mask_emb = _x((b, e, DIM), 9), _x((b, f, DIM), 10), _x((1, f, DIM), 11)
    flat = (rng.random((b, t * f)) < 0.5).astype(np.int64)
    flat[1, 2 * f:] = 1
    sort_key = flat * (t * f) + np.arange(t * f)
    ids_restore = np.argsort(np.argsort(sort_key, axis=1), axis=1)
    num_visible = np.minimum((flat == 0).sum(1), e)
    use = (ids_restore < e) & (ids_restore < num_visible[:, None])
    onehot = ((ids_restore[..., None] == np.arange(e)) & use[..., None]).astype(np.float32)
    jm = jlayers.FusionBlockFast(dim_head=DH, heads=HEADS, ff_mult=4)
    jargs = tuple(map(jnp.asarray, (packed, fusion, mask_emb, onehot, use)))
    params = random_params(jm, 12, *jargs)
    ref = jm.apply({"params": params}, *jargs, use_pallas="auto")
    tm = port_module(tlayers.FusionBlockFast(DIM, DH, HEADS, 4), params)
    with torch.no_grad():
        out = tm(*map(torch.from_numpy, (packed, fusion, mask_emb, ids_restore, use)),
                 use_kernel=use_kernel)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_vit_block(use_kernel):
    x = _x((2, 16, 32), 13)
    jm = jlayers.ViTBlock(num_heads=2, qkv_bias=True, norm_eps=1e-6)
    params = random_params(jm, 14, jnp.asarray(x))
    ref = jm.apply({"params": params}, jnp.asarray(x), use_pallas="auto")
    tm = port_module(tlayers.ViTBlock(32, 2, 4.0, qkv_bias=True, norm_eps=1e-6), params)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), use_kernel=use_kernel)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("channels", [1, 3])
def test_patched_input_adapter(channels):
    x = _x((2, 64, 64, channels), 15)
    jm = jadapters.PatchedInputAdapter(num_channels=channels, patch_size=16, image_size=64)
    params = random_params(jm, 16, jnp.asarray(x), dim_tokens=DIM)
    ref = jm.apply({"params": params}, jnp.asarray(x), dim_tokens=DIM)
    tm = port_module(tadapters.PatchedInputAdapter(channels, DIM, 16, 64), params)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_spatial_output_adapter(use_kernel):
    tokens = _x((2, 16, DIM), 17)
    jm = jadapters.SpatialOutputAdapter(num_channels=3, patch_size=16, image_size=64, dim_tokens=32,
                                        depth=2, num_heads=2)
    params = random_params(jm, 18, jnp.asarray(tokens))
    ref = jm.apply({"params": params}, jnp.asarray(tokens), use_pallas="auto")
    tm = port_module(tadapters.SpatialOutputAdapter(3, DIM, 16, 64, 1, 32, 2, 2), params)
    with torch.no_grad():
        out = tm(torch.from_numpy(tokens), use_kernel=use_kernel)
    assert out.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=ATOL)
