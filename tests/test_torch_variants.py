"""The pretraining variants of the port against the JAX package, f32 on the
CPU, the weights carried by utils.jax_params.params_from_jax, inputs from
numpy seeds, at the widths of tests/test_variants.py (dim 32, depth 2, image
64, F = 16):

  * each new layer against its flax module (atol 2e-5, tests/test_torch_layers.py's);
  * each fusion mode's whole forward (``crossattn``, ``zorro``, ``lstm``,
    ``crossattn_v1``; the simple and the full decoder; the quadruplet with
    the ``dnw`` class map) against JAX ``MultiMAE`` on the same injected
    ``MaskInfo`` with dropped modalities (atol 5e-5, tests/test_torch_slice.py's;
    ``ori_tokens`` on the visible slots only);
  * the 20231203 snapshot's frozen outputs (tests/golden/crossattn_v1_golden.npz)
    through the JAX package's converter and params_from_jax, and through the
    port's own converter (atol 3e-5, tests/test_crossattn_v1_parity.py's);
  * the dropped modality's pixels leave a 2E mode's answer bitwise unmoved.
"""
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu.models import adapters as jadapters
from incomplete_multimodal_fusion_tpu.models import layers as jlayers
from incomplete_multimodal_fusion_tpu.models.multimae import MultiMAE as JaxMultiMAE
from incomplete_multimodal_fusion_tpu.ops import masking as jmask
from incomplete_multimodal_fusion_tpu.utils.torch_convert import convert_multimae_state as jconvert
from incomplete_multimodal_fusion_tpu_torch.models import adapters as tadapters
from incomplete_multimodal_fusion_tpu_torch.models import layers as tlayers
from incomplete_multimodal_fusion_tpu_torch.models.multimae import MultiMAE as TorchMultiMAE
from incomplete_multimodal_fusion_tpu_torch.ops import masking as tmask
from incomplete_multimodal_fusion_tpu_torch.utils.jax_params import params_from_jax
from incomplete_multimodal_fusion_tpu_torch.utils.torch_convert import convert_multimae_state as tconvert
from tests.test_torch_common import as_jax, port_module, random_params, to_np

LAYER_ATOL = 2e-5
ATOL = 5e-5
B, NP_, E = 2, 16, 24
TRIPLE = ("s1", "s2", "dem")
QUAD = ("s1_2ch", "s2_4ch", "dem", "dnw")
CHANNELS = {"s1": 1, "s2": 3, "dem": 1, "s1_2ch": 2, "s2_4ch": 4}
# tests/test_variants.py's widths
VARIANT = dict(image_size=64, patch_size=16, dim_tokens=32, depth=2, dim_head=8, heads=2, ff_mult=2,
               num_fusion_tokens=NP_, decoder_dim=32, decoder_depth=1, decoder_num_heads=2)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def batch(domains, seed, b=B):
    rng = np.random.default_rng(seed)
    return {d: (rng.integers(0, 9, (b, 64, 64)).astype(np.int32) if d == "dnw"
                else rng.standard_normal((b, 64, 64, CHANNELS[d])).astype(np.float32)) for d in domains}


def flat_mask(domains, seed, dropped=1):
    """A random flat mask (about half the tokens visible) with modality
    ``dropped`` fully masked in row 1."""
    flat = (np.random.default_rng(seed).random((B, NP_ * len(domains))) < 0.5).astype(np.int64)
    flat[1, dropped * NP_:(dropped + 1) * NP_] = 1
    return flat


def mask_infos(domains, flat, e=E):
    nums = (NP_,) * len(domains)
    return (jmask.mask_info_from_flat_mask(jnp.asarray(flat), domains, nums, e),
            tmask.mask_info_from_flat_mask(torch.from_numpy(flat), domains, nums, e))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_fusion_block_reference_form():
    """FusionBlock (the reference form of FusionBlockFast): a [B, N, M, D]
    stack, with and without a key mask."""
    stack = _x((2, 6, 4, 32))
    key_valid = np.random.default_rng(1).random((2, 6, 4)) < 0.7
    key_valid[..., -1] = True
    jm = jlayers.FusionBlock(dim_head=8, heads=2, ff_mult=2)
    params = random_params(jm, 1, jnp.asarray(stack))
    tm = port_module(tlayers.FusionBlock(32, 8, 2, 2), params)
    for kv in (None, key_valid):
        ref = jm.apply({"params": params}, jnp.asarray(stack), None if kv is None else jnp.asarray(kv))
        with torch.no_grad():
            out = tm(torch.from_numpy(stack), None if kv is None else torch.from_numpy(kv))
        np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=LAYER_ATOL)


def test_vit_cross_attention_with_a_key_mask():
    q, ctx = _x((2, 5, 32), 1), _x((2, 9, 32), 2)
    mask = np.random.default_rng(3).random((2, 1, 1, 9)) < 0.6
    mask[..., 0] = True
    jm = jlayers.ViTCrossAttention(num_heads=4, qkv_bias=True)
    params = random_params(jm, 4, jnp.asarray(q), jnp.asarray(ctx))
    ref = jm.apply({"params": params}, jnp.asarray(q), jnp.asarray(ctx), attn_mask=jnp.asarray(mask))
    tm = port_module(tlayers.ViTCrossAttention(32, 4, qkv_bias=True), params)
    with torch.no_grad():
        out = tm(torch.from_numpy(q), torch.from_numpy(ctx), attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=LAYER_ATOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_vit_decoder_block(use_kernel):
    x, ctx = _x((2, 16, 32), 5), _x((2, 7, 32), 6)
    jm = jlayers.ViTDecoderBlock(num_heads=4, qkv_bias=True)
    params = random_params(jm, 7, jnp.asarray(x), jnp.asarray(ctx))
    ref = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(ctx))
    tm = port_module(tlayers.ViTDecoderBlock(32, 4, qkv_bias=True), params)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(ctx), use_kernel=use_kernel)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=LAYER_ATOL)


def test_snapshot_cross_attention():
    q, ctx = _x((2, 11, 32), 8), _x((2, 11, 3, 32), 9)
    jm = jlayers.SnapshotCrossAttention(num_heads=2)
    params = random_params(jm, 10, jnp.asarray(q), jnp.asarray(ctx))
    assert "bias" not in params["q"] and "bias" not in params["kv"] and "bias" in params["proj"]
    ref = jm.apply({"params": params}, jnp.asarray(q), jnp.asarray(ctx))
    tm = port_module(tlayers.SnapshotCrossAttention(32, 2), params)
    with torch.no_grad():
        out = tm(torch.from_numpy(q), torch.from_numpy(ctx))
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=LAYER_ATOL)


@pytest.mark.parametrize("m", [2, 4])
def test_attention_bilstm(m):
    """flax's LSTMCell tree (ii/if/ig/io without bias, hi/hf/hg/ho with
    bias) lands on the port's cell; the gate order and the direction sum
    agree with JAX's over short axes."""
    x = _x((7, m, 32), 11)
    jm = jlayers.AttentionBiLSTM()
    params = random_params(jm, 12, jnp.asarray(x))
    assert set(params["lstm_fwd"]) == {"ii", "if", "ig", "io", "hi", "hf", "hg", "ho"}
    assert all(("bias" in v) == k.startswith("h") for k, v in params["lstm_fwd"].items())
    ref = jm.apply({"params": params}, jnp.asarray(x))
    tm = port_module(tlayers.AttentionBiLSTM(32), params)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=LAYER_ATOL)


def test_semseg_input_adapter():
    x = np.random.default_rng(13).integers(0, 9, (2, 64, 64)).astype(np.int32)
    jm = jadapters.SemSegInputAdapter(num_classes=9, patch_size=16, image_size=64)
    params = random_params(jm, 14, jnp.asarray(x), dim_tokens=32)
    ref = jm.apply({"params": params}, jnp.asarray(x), dim_tokens=32)
    tm = port_module(tadapters.SemSegInputAdapter(9, 32, 16, 64), params)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=LAYER_ATOL)


@pytest.mark.parametrize("task_queries,xattn,task", [(True, True, "s2"), (False, True, "s2"), (True, False, "s1"),
                                                     (True, True, "other")])
def test_spatial_output_adapter_full(task_queries, xattn, task):
    """The full decoder: unshuffle with mask_token, the task embeddings,
    the queries (task section or mask_token + pos), the key-masked
    cross-attention; a row with dropped slots and padding."""
    enc = _x((B, E, 32), 15)
    jmi, tmi = mask_infos(TRIPLE, flat_mask(TRIPLE, 16))
    kw = dict(num_channels=3, task=task, context_tasks=TRIPLE, patch_size=16, image_size=64, dim_tokens=32, depth=1,
              num_heads=2, use_task_queries=task_queries, use_xattn=xattn)
    jm = jadapters.SpatialOutputAdapterFull(**kw)
    params = random_params(jm, 17, jnp.asarray(enc), jmi, E)
    ref = jm.apply({"params": params}, jnp.asarray(enc), jmi, E)
    tm = port_module(tadapters.SpatialOutputAdapterFull(3, task, TRIPLE, 32, 16, 64, 1, 32, 1, 2, task_queries,
                                                        xattn), params)
    for use_kernel in (False, True):
        with torch.no_grad():
            out = tm(torch.from_numpy(enc), tmi, E, use_kernel=use_kernel)
        np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=LAYER_ATOL)


# ---------------------------------------------------------------------------
# whole forwards
# ---------------------------------------------------------------------------

MODES = {
    "crossattn-full": ("crossattn", "full", TRIPLE),
    "zorro": ("zorro", "simple", TRIPLE),
    "zorro-full": ("zorro", "full", TRIPLE),
    "lstm": ("lstm", "simple", TRIPLE),
    "crossattn_v1": ("crossattn_v1", "simple", TRIPLE),
    "crossattn_v1-full": ("crossattn_v1", "full", TRIPLE),
    "quadruplet-crossattn": ("crossattn", "simple", QUAD),
    "quadruplet-lstm": ("lstm", "simple", QUAD),
}


def model_kwargs(mode, style, domains):
    return dict(VARIANT, in_domains=domains, out_domains=domains, fusion_mode=mode, decoder_style=style)


_PAIRS = {}


def pair(name):
    """The JAX model, its random parameters and the port's model with them
    (cached a mode)."""
    if name not in _PAIRS:
        mode, style, domains = MODES[name]
        kw = model_kwargs(mode, style, domains)
        jm = JaxMultiMAE(attn_impl="xla", **kw)
        full = jmask.full_visible_mask_info(domains, (NP_,) * len(domains), B)
        params = random_params(jm, 1, as_jax(batch(domains, 0)), full, NP_ * len(domains))
        _PAIRS[name] = jm, params, port_module(TorchMultiMAE(attn_impl="auto", **kw), params)
    return _PAIRS[name]


def assert_outputs_match(out, ref, domains, num_visible, atol=ATOL):
    for d in domains:
        np.testing.assert_allclose(to_np(out["preds"][d]), np.asarray(ref["preds"][d]), atol=atol, err_msg=d)
        np.testing.assert_allclose(to_np(out["pooled_mod"][d]), np.asarray(ref["pooled_mod"][d]), atol=atol,
                                   err_msg=f"pooled_mod {d}")
    np.testing.assert_allclose(to_np(out["pooled"]), np.asarray(ref["pooled"]), atol=atol)
    np.testing.assert_allclose(to_np(out["fusion_tokens"]), np.asarray(ref["fusion_tokens"]), atol=atol)
    for row, n_vis in enumerate(num_visible):
        np.testing.assert_allclose(to_np(out["ori_tokens"][row, :n_vis]), np.asarray(ref["ori_tokens"][row, :n_vis]),
                                   atol=atol)


@pytest.mark.parametrize("name", sorted(MODES))
def test_forward_matches_jax(name):
    """Random masks with one modality dropped in row 1 (the 2E layout's
    padding mid-sequence), at e = 24 below the visible count."""
    jm, params, tm = pair(name)
    domains = MODES[name][2]
    x = batch(domains, 2)
    jmi, tmi = mask_infos(domains, flat_mask(domains, 3, dropped=len(domains) - 1))
    ref = jax.jit(lambda p, x, mi: jm.apply({"params": p}, x, mi, E))(params, as_jax(x), jmi)
    with torch.no_grad():
        out = tm({d: torch.from_numpy(v) for d, v in x.items()}, tmi, E)
    assert out["pooled"].shape == (B, len(domains) + 1, 32)
    assert_outputs_match(out, ref, domains, [int(v) for v in tmi.num_visible])
    if "dnw" in domains:
        assert out["preds"]["dnw"].shape == (B, 64, 64, 9)  # class logits


@pytest.mark.parametrize("name", ["lstm", "crossattn_v1", "quadruplet-crossattn"])
def test_dropped_modality_pixels_leave_the_answer_bitwise_unmoved(name):
    _, _, tm = pair(name)
    domains = MODES[name][2]
    x = {d: torch.from_numpy(v) for d, v in batch(domains, 4).items()}
    masks = {d: torch.full((B, NP_), int(d == "dem"), dtype=torch.long) for d in domains}
    mi = tmask.mask_info_from_task_masks(masks, domains, NP_ * len(domains))
    with torch.no_grad():
        a = tm(x, mi, NP_ * len(domains))
        b = tm(dict(x, dem=x["dem"] * 0.0 + 123.0), mi, NP_ * len(domains))
    for d in domains:
        assert torch.equal(a["preds"][d], b["preds"][d]), d
    assert torch.equal(a["pooled"], b["pooled"])


def test_semseg_domain_raises_the_fusion_type_and_keeps_its_tree():
    jm, params, tm = pair("quadruplet-crossattn")
    assert tm.fusion_type == jm.fusion_type == 4
    sd = params_from_jax(params)
    assert set(sd) == set(tm.state_dict())
    assert tuple(sd["input_adapters.dnw.class_emb"].shape) == (9, 64)


@pytest.mark.parametrize("name", ["lstm", "crossattn_v1", "crossattn-full"])
def test_mode_trees_map_one_to_one(name):
    """Every flax leaf of the mode lands on exactly one port parameter of
    the same shape, and the port has no other."""
    _, params, tm = pair(name)
    sd = params_from_jax(params)
    own = dict(tm.state_dict())
    assert set(sd) == set(own)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(own[k].shape), k


def test_refusals():
    with pytest.raises(ValueError, match="lstm"):
        TorchMultiMAE(**model_kwargs("lstm", "full", TRIPLE))
    with pytest.raises(NotImplementedError, match="sup"):
        TorchMultiMAE(**model_kwargs("sup", "simple", TRIPLE))
    with pytest.raises(ValueError, match="fusion_mode"):
        TorchMultiMAE(**model_kwargs("bogus", "simple", TRIPLE))


# ---------------------------------------------------------------------------
# the 20231203 snapshot's golden
# ---------------------------------------------------------------------------

G = dict(np.load(os.path.join(os.path.dirname(__file__), "golden", "crossattn_v1_golden.npz")))
GOLDEN_CHANNELS = {"s1": 1, "s2": 3, "dem": 1}


def synth_weight(key: str, shape) -> np.ndarray:
    """tests/test_crossattn_v1_parity.py's weight synthesis."""
    rng = np.random.default_rng(20260817 + zlib.crc32(key.encode()))
    if key.endswith((".gamma",)) or key.endswith("norm1.weight") or key.endswith("norm2.weight") or \
            key.endswith("norm.weight"):
        return (1.0 + 0.05 * rng.standard_normal(shape)).astype(np.float32)
    if key.endswith(".beta"):
        return np.zeros(shape, np.float32)
    if key.endswith(".bias"):
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)
    return (0.05 * rng.standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def golden_state():
    keys = [str(k) for k in G["wsum::keys"]]
    shapes = [tuple(int(v) for v in s.split(",")) for s in G["wsum::shapes"]]
    state = {}
    for k, shape, ref_sum in zip(keys, shapes, np.asarray(G["wsum::vals"])):
        state[k] = synth_weight(k, shape)
        np.testing.assert_allclose(np.float64(state[k]).sum(), ref_sum, rtol=1e-10, err_msg=k)
    return state


def test_crossattn_v1_golden(golden_state):
    """dim 768, depth 1, e = 16: the JAX converter and params_from_jax, and
    the port's converter (bit for bit the same state dict), against the
    executed snapshot's outputs."""
    kw = dict(patch_size=16, depth=1, decoder_depth=1, fusion_mode="crossattn_v1")
    via_jax = params_from_jax(jconvert(golden_state, TRIPLE, TRIPLE, GOLDEN_CHANNELS, **kw))
    native = tconvert(golden_state, TRIPLE, TRIPLE, GOLDEN_CHANNELS, **kw)
    assert set(via_jax) == set(native) and all(torch.equal(via_jax[k], native[k]) for k in native)
    model = TorchMultiMAE(in_domains=TRIPLE, out_domains=TRIPLE, image_size=64, patch_size=16, dim_tokens=768,
                          depth=1, dim_head=64, heads=8, ff_mult=4, num_fusion_tokens=16, fusion_mode="crossattn_v1",
                          attn_impl="auto", decoder_dim=32, decoder_depth=1, decoder_num_heads=2)
    model.load_state_dict(native, strict=True)
    x = {d: torch.from_numpy(G[f"x_{d}"].transpose(0, 2, 3, 1).copy()) for d in TRIPLE}
    mi = tmask.mask_info_from_task_masks({d: torch.from_numpy(G[f"mask_{d}"]) for d in TRIPLE}, TRIPLE, 16)
    with torch.no_grad():
        out = model.eval()(x, mi, 16)
    for d in TRIPLE:
        np.testing.assert_allclose(to_np(out["preds"][d]), G[f"pred_{d}"].transpose(0, 2, 3, 1), atol=3e-5)
        np.testing.assert_allclose(to_np(out["pooled_mod"][d]), G[f"pool_{d}"][:, 0, :], atol=3e-5)
    np.testing.assert_allclose(to_np(out["pooled"]), G["return_tokens"], atol=3e-5)
    np.testing.assert_allclose(to_np(out["ori_tokens"]), G["ori_tokens"], atol=3e-5)
