"""Reference PyTorch checkpoints straight into the port's ``state_dict``
(the job of the JAX package's utils/torch_convert.py followed by
utils/jax_params.py ``params_from_jax``, in one step and without JAX).

The input is a reference state dict of numpy arrays or torch tensors (a
``module.`` prefix of DDP is dropped); the output is {port name: f32 CPU
tensor} for ``load_state_dict(strict=True)``. The port keeps most of the
reference's layouts, so most tensors only change name:

  * ``nn.Linear`` and ``nn.Conv2d`` weights keep their layout, a
    ``ConvTranspose2d`` weight too (the port runs it as torch does);
  * the patchify ``Conv2d`` [D, C, P, P] becomes the input adapter's
    matmul weight [D, (ph pw c)] (reference input_adapters.py:88-91);
  * the decoder's ``out_proj`` rows go from (c ph pw) to (ph pw c)
    (output_adapters_simple.py:184-188 against the port's NHWC unpatchify);
  * a 1x1 ``Conv2d`` the port runs as a Linear drops its 1x1 window;
  * ``nn.MultiheadAttention``'s packed ``in_proj`` splits into q, k, v;
  * zorro LayerNorms' ``gamma`` becomes ``weight``;
  * fixed sin-cos position buffers are not carried: the port recomputes them.

Covered: the flagship MultiMAE (``crossattn``, multimae_crossattn.py), the
20231203 snapshot (``crossattn_v1``) and the
downstream MaskFormer (MaskFormerModel_vit.py: the ViT backbone, the
MSDeformAttn pixel decoder and the Mask2Former decoder), each part also on
its own.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

__all__ = [
    "convert_multimae_state", "convert_vit_baseline_state", "convert_pixel_decoder_state",
    "convert_mask2former_decoder_state", "convert_maskformer_state", "strip_prefixes",
]

Arrays = Dict[str, np.ndarray]


def strip_prefixes(state: Mapping) -> Arrays:
    """{name: f32 numpy array}, DDP's ``module.`` dropped (reference
    misc.py:147-171)."""
    out = {}
    for k, v in state.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v, dtype=np.float32)
    return out


def _sub(state: Mapping, prefix: str) -> Arrays:
    return {k[len(prefix):]: v for k, v in strip_prefixes(state).items() if k.startswith(prefix)}


def _tensors(out: Arrays) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def _copy(s: Arrays, out: Arrays, src: str, dst: str) -> None:
    out[dst] = s[src]


def _linear(s: Arrays, out: Arrays, src: str, dst: str, bias: bool = True) -> None:
    out[f"{dst}.weight"] = s[f"{src}.weight"]
    if bias:
        out[f"{dst}.bias"] = s[f"{src}.bias"]


def _norm(s: Arrays, out: Arrays, src: str, dst: str) -> None:
    """torch LayerNorm / GroupNorm (weight and bias)."""
    _linear(s, out, src, dst)


def _gamma(s: Arrays, out: Arrays, src: str, dst: str) -> None:
    """A zorro LayerNorm (gamma, no bias)."""
    out[f"{dst}.weight"] = s[f"{src}.gamma"]


def _conv1x1(s: Arrays, out: Arrays, src: str, dst: str) -> None:
    out[f"{dst}.weight"] = s[f"{src}.weight"][:, :, 0, 0]
    out[f"{dst}.bias"] = s[f"{src}.bias"]


def _zorro_attention(s: Arrays, out: Arrays, src: str, dst: str) -> None:
    """zorro_utils.Attention (norm, bias-free to_q / to_kv / to_out)."""
    _gamma(s, out, f"{src}.norm", f"{dst}.norm")
    for name in ("to_q", "to_kv", "to_out"):
        _linear(s, out, f"{src}.{name}", f"{dst}.{name}", bias=False)


def _geglu_ff(s: Arrays, out: Arrays, src: str, dst: str) -> None:
    """zorro_utils.FeedForward: Sequential(LayerNorm, Linear, GEGLU, Linear)."""
    _gamma(s, out, f"{src}.0", f"{dst}.norm")
    _linear(s, out, f"{src}.1", f"{dst}.proj_in", bias=False)
    _linear(s, out, f"{src}.3", f"{dst}.proj_out", bias=False)


def _encoder_block(s: Arrays, out: Arrays, src: str, dst: str) -> None:
    """zorro_utils.Block -> layers.EncoderBlock."""
    _gamma(s, out, f"{src}.norm1", f"{dst}.norm1")
    _zorro_attention(s, out, f"{src}.attn", f"{dst}.attn")
    _gamma(s, out, f"{src}.norm2", f"{dst}.norm2")
    _geglu_ff(s, out, f"{src}.mlp", f"{dst}.mlp")


def _fusion_block(s: Arrays, out: Arrays, src: str, dst: str) -> None:
    """zorro_utils.Block_Fusion -> layers.FusionBlockFast (the attention
    inlined: attn_norm / to_q / to_kv / to_out at the block's top)."""
    _gamma(s, out, f"{src}.norm1", f"{dst}.norm1")
    _gamma(s, out, f"{src}.attn.norm", f"{dst}.attn_norm")
    for name in ("to_q", "to_kv", "to_out"):
        _linear(s, out, f"{src}.attn.{name}", f"{dst}.{name}", bias=False)
    _gamma(s, out, f"{src}.norm2", f"{dst}.norm2")
    _geglu_ff(s, out, f"{src}.mlp", f"{dst}.mlp")


def _mlp(s: Arrays, out: Arrays, src: str, dst: str) -> None:
    """Mlp (fc1 / fc2 with biases)."""
    _linear(s, out, f"{src}.fc1", f"{dst}.fc1")
    _linear(s, out, f"{src}.fc2", f"{dst}.fc2")


def _vit_block(s: Arrays, out: Arrays, src: str, dst: str) -> None:
    """multimae_utils.Block (LayerNorm with bias, fused qkv, biased proj)."""
    _norm(s, out, f"{src}.norm1", f"{dst}.norm1")
    _linear(s, out, f"{src}.attn.qkv", f"{dst}.attn.qkv", bias=f"{src}.attn.qkv.bias" in s)
    _linear(s, out, f"{src}.attn.proj", f"{dst}.attn.proj")
    _norm(s, out, f"{src}.norm2", f"{dst}.norm2")
    _mlp(s, out, f"{src}.mlp", f"{dst}.mlp")


def _input_adapter(s: Arrays, out: Arrays, src: str, dst: str) -> None:
    """PatchedInputAdapter / SemSegInputAdapter: the patchify conv as the
    [D, (ph pw c)] matmul weight, and the class embedding where there is one."""
    w = s[f"{src}.proj.weight"]
    out[f"{dst}.proj.weight"] = w.transpose(0, 2, 3, 1).reshape(w.shape[0], -1)
    out[f"{dst}.proj.bias"] = s[f"{src}.proj.bias"]
    if f"{src}.class_emb.weight" in s:
        out[f"{dst}.class_emb"] = s[f"{src}.class_emb.weight"]


def _output_adapter(s: Arrays, out: Arrays, src: str, dst: str, task: str, num_channels: int,
                    patch: int, depth: int) -> None:
    """SpatialOutputAdapter (output_adapters_simple.py:33-188). Only this
    task's embedding is read in the forward (:178-181); the other tasks'
    are dropped."""
    _linear(s, out, f"{src}.proj_context", f"{dst}.proj_context")
    out[f"{dst}.task_emb"] = s[f"{src}.task_embeddings.{task}"]
    for i in range(depth):
        _vit_block(s, out, f"{src}.decoder_transformer.{i}", f"{dst}.blocks.{i}")
    w, b = s[f"{src}.out_proj.weight"], s[f"{src}.out_proj.bias"]
    dim = w.shape[1]
    out[f"{dst}.out_proj.weight"] = (w.reshape(num_channels, patch, patch, dim).transpose(1, 2, 0, 3)
                                     .reshape(-1, dim))
    out[f"{dst}.out_proj.bias"] = b.reshape(num_channels, patch, patch).transpose(1, 2, 0).reshape(-1)


def _snapshot_cross_attention(s: Arrays, out: Arrays, src: str, dst: str) -> None:
    """zorro_utils.CrossAttention (q / kv bias-free, proj biased) ->
    layers.SnapshotCrossAttention."""
    _linear(s, out, f"{src}.q", f"{dst}.q", bias=False)
    _linear(s, out, f"{src}.kv", f"{dst}.kv", bias=False)
    _linear(s, out, f"{src}.proj", f"{dst}.proj")


def convert_multimae_state(state: Mapping, in_domains: Sequence[str], out_domains: Sequence[str],
                           out_channels: Mapping[str, int], patch_size: int = 16, depth: int = 12,
                           decoder_depth: int = 2, fusion_mode: str = "crossattn") -> Dict[str, torch.Tensor]:
    """Reference MultiMAE -> the state dict of ``models.multimae.MultiMAE``
    (JAX utils/torch_convert.py:176-275). ``fusion_mode='crossattn'``: the
    flagship (multimae_crossattn.py) with a Block_Fusion a layer;
    ``'crossattn_v1'``: the 20231203 snapshot (multimae_crossattn_20231203.py),
    the shared per-layer cross-attention and its MLP and a pool attention
    and MLP a modality instead of the fusion blocks. ``out_channels``: the
    reconstruction channels of each out-domain (its class count for a
    semseg domain)."""
    if fusion_mode not in ("crossattn", "crossattn_v1"):
        raise ValueError(f"fusion_mode must be 'crossattn' or 'crossattn_v1', got {fusion_mode!r}")
    s = strip_prefixes(state)
    out: Arrays = {}
    for name in ("fusion_tokens", "return_tokens", "mask_embedding"):
        _copy(s, out, name, name)
    _gamma(s, out, "norm", "norm")
    _zorro_attention(s, out, "attn_pool", "attn_pool")
    _mlp(s, out, "mlp", "mlp")
    for d in in_domains:
        _copy(s, out, f"return_token_{d}", f"return_token_{d}")
        _input_adapter(s, out, f"input_adapters.{d}", f"input_adapters.{d}")
    for i in range(depth):
        _encoder_block(s, out, f"blocks.{i}", f"blocks.{i}")
        if fusion_mode == "crossattn":
            _fusion_block(s, out, f"fus_blocks.{i}", f"fus_blocks.{i}")
    if fusion_mode == "crossattn_v1":
        _snapshot_cross_attention(s, out, "attn_pool_modalities", "attn_pool_modalities")
        _mlp(s, out, "mlp_modalities", "mlp_modalities")
        for d in in_domains:
            _zorro_attention(s, out, f"attn_{d}", f"attn_{d}")
            _mlp(s, out, f"mlp_{d}", f"mlp_{d}")
    for d in out_domains:
        _output_adapter(s, out, f"output_adapters.{d}", f"output_adapters.{d}", d, out_channels[d],
                        patch_size, decoder_depth)
    return _tensors(out)


def _vit_baseline(s: Arrays, in_domains: Sequence[str], depth: int) -> Arrays:
    out: Arrays = {}
    for name in ("fusion_tokens", "mask_embedding"):
        _copy(s, out, name, name)
    _gamma(s, out, "norm", "norm")
    _linear(s, out, "up1.0", "pyramid.up1_conv1")  # ConvTranspose2d, the port runs torch's layout
    _norm(s, out, "up1.1", "pyramid.up1_gn")
    _linear(s, out, "up1.3", "pyramid.up1_conv2")
    _linear(s, out, "up2", "pyramid.up2_conv")
    for d in in_domains:
        _input_adapter(s, out, f"input_adapters.{d}", f"input_adapters.{d}")
    for i in range(depth):
        _encoder_block(s, out, f"blocks.{i}", f"blocks.{i}")
        _fusion_block(s, out, f"fus_blocks.{i}", f"fus_blocks.{i}")
    return out


def _pixel_decoder(s: Arrays, enc_layers: int, num_levels: int) -> Arrays:
    out: Arrays = {}
    _copy(s, out, "transformer.level_embed", "level_embed")
    _conv1x1(s, out, "adapter_1.0", "fpn_lateral")
    _norm(s, out, "adapter_1.1", "fpn_lateral_gn")
    _linear(s, out, "layer_1.0", "fpn_output")
    _norm(s, out, "layer_1.1", "fpn_output_gn")
    _conv1x1(s, out, "mask_features", "mask_features")
    n = 2
    while f"adapter_{n}.0.weight" in s:  # extra FPN levels (the full model's quirk)
        _conv1x1(s, out, f"adapter_{n}.0", f"fpn_lateral{n}")
        _norm(s, out, f"adapter_{n}.1", f"fpn_lateral{n}_gn")
        _linear(s, out, f"layer_{n}.0", f"fpn_output{n}")
        _norm(s, out, f"layer_{n}.1", f"fpn_output{n}_gn")
        n += 1
    for i in range(num_levels):
        _conv1x1(s, out, f"input_proj.{i}.0", f"input_proj{i}")
        _norm(s, out, f"input_proj.{i}.1", f"input_gn{i}")
    for i in range(enc_layers):
        src, dst = f"transformer.encoder.layers.{i}", f"enc_layer{i}"
        for name in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
            _linear(s, out, f"{src}.self_attn.{name}", f"{dst}.self_attn.{name}")
        for name in ("norm1", "norm2", "linear1", "linear2"):
            _linear(s, out, f"{src}.{name}", f"{dst}.{name}")
    return out


def _torch_mha(s: Arrays, out: Arrays, src: str, dst: str, d: int) -> None:
    """nn.MultiheadAttention's packed in_proj -> q_proj / k_proj / v_proj."""
    w, b = s[f"{src}.in_proj_weight"], s[f"{src}.in_proj_bias"]
    for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
        out[f"{dst}.{name}.weight"] = w[j * d:(j + 1) * d]
        out[f"{dst}.{name}.bias"] = b[j * d:(j + 1) * d]
    _linear(s, out, f"{src}.out_proj", f"{dst}.out_proj")


def _mask2former_decoder(s: Arrays, hidden_dim: int, dec_layers: int) -> Arrays:
    out: Arrays = {}
    for name in ("query_feat", "query_embed", "level_embed"):
        _copy(s, out, f"{name}.weight", name)
    _norm(s, out, "decoder_norm", "decoder_norm")
    _linear(s, out, "class_embed", "class_embed")
    for i in range(3):
        _linear(s, out, f"mask_embed.layers.{i}", f"mask_embed.layer{i}")
    for i in range(dec_layers):
        cross, self_ = f"transformer_cross_attention_layers.{i}", f"transformer_self_attention_layers.{i}"
        _torch_mha(s, out, f"{cross}.multihead_attn", f"cross{i}.mha", hidden_dim)
        _norm(s, out, f"{cross}.norm", f"cross{i}.norm")
        _torch_mha(s, out, f"{self_}.self_attn", f"self{i}.mha", hidden_dim)
        _norm(s, out, f"{self_}.norm", f"self{i}.norm")
        for name in ("linear1", "linear2", "norm"):
            _linear(s, out, f"transformer_ffn_layers.{i}.{name}", f"ffn{i}.{name}")
    return out


def convert_vit_baseline_state(state: Mapping, in_domains: Sequence[str], depth: int = 12,
                               prefix: str = "") -> Dict[str, torch.Tensor]:
    """Reference downstream ViTBaseline (multimae_big_imcomplete.py:418-683)
    -> ``models.vit_baseline.ViTBaseline``."""
    return _tensors(_vit_baseline(_sub(state, prefix), in_domains, depth))


def convert_pixel_decoder_state(state: Mapping, enc_layers: int = 2, num_levels: int = 3,
                                prefix: str = "") -> Dict[str, torch.Tensor]:
    """Reference MSDeformAttnPixelDecoder (msdeformattn{_vit}.py) ->
    ``models.pixel_decoder.MSDeformAttnPixelDecoder``."""
    return _tensors(_pixel_decoder(_sub(state, prefix), enc_layers, num_levels))


def convert_mask2former_decoder_state(state: Mapping, hidden_dim: int = 256, dec_layers: int = 3,
                                      prefix: str = "") -> Dict[str, torch.Tensor]:
    """Reference MultiScaleMaskedTransformerDecoder ->
    ``models.mask2former_decoder.MultiScaleMaskedTransformerDecoder``."""
    return _tensors(_mask2former_decoder(_sub(state, prefix), hidden_dim, dec_layers))


def convert_maskformer_state(state: Mapping, in_domains: Sequence[str], depth: int = 12,
                             enc_layers: int = 2, dec_layers: int = 3, hidden_dim: int = 256,
                             backbone_prefix: str = "backbone.",
                             pixel_decoder_prefix: str = "sem_seg_head.pixel_decoder.",
                             predictor_prefix: str = "sem_seg_head.predictor.") -> Dict[str, torch.Tensor]:
    """A whole reference downstream checkpoint (MaskFormerModel_vit.py:
    backbone + sem_seg_head.{pixel_decoder, predictor}) ->
    ``models.maskformer.MaskFormerModel``."""
    out = {}
    for module, part in (("backbone", convert_vit_baseline_state(state, in_domains, depth, backbone_prefix)),
                         ("pixel_decoder", convert_pixel_decoder_state(state, enc_layers,
                                                                       prefix=pixel_decoder_prefix)),
                         ("predictor", convert_mask2former_decoder_state(state, hidden_dim, dec_layers,
                                                                         predictor_prefix))):
        out.update({f"{module}.{k}": v for k, v in part.items()})
    return out
