"""Carry a flax parameter tree of the JAX package into this package's
``state_dict``.

The port's modules are named after the flax tree, so the mapping is a
renaming plus the Dense transpose:

  * ``input_adapter_{d}`` -> ``input_adapters.{d}``,
    ``output_adapter_{d}`` -> ``output_adapters.{d}``,
    ``block{i}`` -> ``blocks.{i}``, ``fus_block{i}`` -> ``fus_blocks.{i}``;
  * a Dense ``kernel`` [in, out] -> ``weight`` [out, in]; the input
    adapter's ``proj_kernel`` / ``proj_bias`` -> ``proj.weight`` (transposed)
    / ``proj.bias``;
  * ``gamma`` -> ``weight`` and ``beta`` -> ``bias`` of a LayerNorm (the
    ``_Param`` holders ``mlp/norm/gamma``, ``mlp/proj_in/kernel`` keep their
    module names);
  * every other leaf (``fusion_tokens``, ``task_emb``, ``bias``, ...) keeps
    its name.

The input is the tree as nested dicts of numpy arrays (``{"params": ...}``
or the inner tree).
"""
from __future__ import annotations

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
    return key


def _leaf(key: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    if key == "kernel":
        return "weight", arr.T
    if key == "proj_kernel":
        return "proj.weight", arr.T
    if key == "proj_bias":
        return "proj.bias", arr
    if key == "gamma":
        return "weight", arr
    if key == "beta":
        return "bias", arr
    return key, arr


def params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax param tree (nested dicts of arrays) -> the port's state dict."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: str):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, prefix + _module_name(key) + ".")
            else:
                name, arr = _leaf(key, np.asarray(value, dtype=np.float32))
                out[prefix + name] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(params, "")
    return out
