"""Carry a flax parameter tree of the JAX package into this package's
``state_dict``.

The port's modules are named after the flax tree, so the mapping is a
renaming plus the Dense transpose:

  * ``input_adapter_{d}`` -> ``input_adapters.{d}``,
    ``output_adapter_{d}`` -> ``output_adapters.{d}``,
    ``block{i}`` -> ``blocks.{i}``, ``fus_block{i}`` -> ``fus_blocks.{i}``,
    a module named by a Python keyword (flax LSTMCell's ``if``) -> the name
    with ``_`` appended;
  * a Dense ``kernel`` [in, out] -> ``weight`` [out, in]; the input
    adapter's ``proj_kernel`` / ``proj_bias`` -> ``proj.weight`` (transposed)
    / ``proj.bias``;
  * a 4-D ``Conv`` kernel [kh, kw, in, out] -> ``nn.Conv2d``'s ``weight``
    [out, in, kh, kw]; the ``ConvTranspose`` kernels of the feature pyramid
    (modules ``up*_conv*``) -> ``F.conv_transpose2d``'s [in, out, kh, kw],
    spatially flipped: lax.conv_transpose runs the unflipped kernel as a
    fractionally strided convolution, where torch scatters ``weight[i, j]``
    to output ``(s*p + i, s*q + j)`` (the inverse of the JAX package's
    torch_convert.py:234-241);
  * ``gamma`` -> ``weight`` and ``beta`` -> ``bias`` of a LayerNorm (the
    ``_Param`` holders ``mlp/norm/gamma``, ``mlp/proj_in/kernel`` keep their
    module names); flax ``LayerNorm`` / ``GroupNorm`` ``scale`` -> ``weight``.
    A norm is a module of leaves alone: a ``gamma`` beside submodules (the
    ViT-Adapter injector's, a ConvNeXt block's layer scale) keeps its name,
    and so does the ``scale`` of a ResNet's frozen batch norm (modules
    ``bn{i}`` and ``downsample_bn``);
  * the ViT-Adapter's ``adapter_up`` is a transposed convolution like the
    pyramid's;
  * every other leaf (``fusion_tokens``, ``task_emb``, ``bias``,
    ``level_embed``, ``relative_position_bias_table``, ``query_embed``,
    ``return_tokens``, ...) keeps its name.

The downstream head's modules carry their flax names in the port
(``enc_layer{i}``, ``input_proj{i}``, ``fpn_lateral2_gn``, ``cross{i}``,
``self{i}``, ``ffn{i}``, ``mask_embed.layer{j}``, the standard decoder's
``enc{i}`` / ``dec{i}``, ...), and so do the other backbones' (``spm``,
``injector{i}``, ``extractor{i}``, ``attn_pool``, ``layer{s}_{b}``,
``stage{s}_block{i}``, ``merge{s}``, ...), so they need no rule.

The LSTM cells (``attn_lstm/lstm_fwd/ii``, ``if`` -> ``if_``, ...), the class-map adapter
(``input_adapter_dnw``: ``class_emb``, ``proj_kernel``, ``proj_bias``), the
full decoder (``task_emb_*``, ``mask_token``, ``decoder``, ``query_norm``,
``block{i}``, ...) and the snapshot's modules (``attn_pool_modalities``,
``mlp_modalities``, ``attn_{d}``, ``mlp_{d}``) carry their flax names in the
port too, so the same rules carry them. ``flax_path`` runs the module
renaming backwards (the layer-wise LR decay reads the flax path).

The input is the tree as nested dicts of numpy or JAX arrays
(``{"params": ...}`` or the inner tree). Any tree of the parameters' shape
carries over the same way: a gradient tree from ``jax.grad`` or the bool
tree of ``wd_mask`` lands on the port's parameter names.
"""
from __future__ import annotations

import keyword
import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_MODULE_RULES = (
    (re.compile(r"^input_adapter_(.+)$"), r"input_adapters.\1"),
    (re.compile(r"^output_adapter_(.+)$"), r"output_adapters.\1"),
    (re.compile(r"^fus_block(\d+)$"), r"fus_blocks.\1"),
    (re.compile(r"^block(\d+)$"), r"blocks.\1"),
)


def _module_name(key: str) -> str:
    for pattern, repl in _MODULE_RULES:
        if pattern.match(key):
            return pattern.sub(repl, key)
    # a Python keyword (flax LSTMCell's input kernel ``if``) cannot be a
    # module attribute that torch.export's generated code reads: ``if_``
    return key + "_" if keyword.iskeyword(key) else key


_PORT_MODULES = (
    (re.compile(r"^input_adapters\.([^.]+)"), r"input_adapter_\1"),
    (re.compile(r"^output_adapters\.([^.]+)"), r"output_adapter_\1"),
    (re.compile(r"^fus_blocks\.(\d+)"), r"fus_block\1"),
    (re.compile(r"^blocks\.(\d+)"), r"block\1"),
)


def flax_path(name: str) -> str:
    """A port parameter name as the flax tree's path of its module
    (``blocks.3.attn.to_q.weight`` -> ``block3/attn/to_q/weight``): the
    module renaming of ``params_from_jax`` run backwards, each dotted part
    that one of its rules maps joined back to one flax key. Leaf names stay
    the port's."""
    out = []
    rest = name
    while rest:
        for pattern, repl in _PORT_MODULES:
            m = pattern.match(rest)
            if m:
                out.append(m.expand(repl))
                rest = rest[m.end():].lstrip(".")
                break
        else:
            head, _, rest = rest.partition(".")
            out.append(head[:-1] if head.endswith("_") and keyword.iskeyword(head[:-1]) else head)
    return "/".join(out)


_CONV_TRANSPOSE = re.compile(r"^(up\d+_conv\d*|adapter_up)$")
_FROZEN_BN = re.compile(r"^(bn\d+|downsample_bn)$")


def _leaf(module: str, key: str, arr: np.ndarray, norm: bool) -> Tuple[str, np.ndarray]:
    if key == "kernel" and arr.ndim == 4:
        if _CONV_TRANSPOSE.match(module):
            return "weight", arr[::-1, ::-1].transpose(2, 3, 0, 1)
        return "weight", arr.transpose(3, 2, 0, 1)
    if key == "kernel":
        return "weight", arr.T
    if key == "proj_kernel":
        return "proj.weight", arr.T
    if key == "proj_bias":
        return "proj.bias", arr
    if key in ("gamma", "scale") and norm and not (key == "scale" and _FROZEN_BN.match(module)):
        return "weight", arr
    if key == "beta":
        return "bias", arr
    return key, arr


def params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax param tree (nested dicts of arrays) -> the port's state dict."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: str, module: str):
        norm = not any(isinstance(v, Mapping) for v in tree.values())
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, prefix + _module_name(key) + ".", key)
            else:
                name, arr = _leaf(module, key, np.array(value, dtype=np.float32), norm)  # a writable copy
                out[prefix + name] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(params, "", "")
    return out
