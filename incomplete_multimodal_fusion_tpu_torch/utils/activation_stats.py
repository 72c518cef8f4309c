"""Activation statistics of one forward (JAX package utils/activation_stats.py;
reference pretraining/utils/model.py:30-106 ``ActivationStatsHook``).

A forward hook on every module records the statistics of its output under
the module's flax path (``utils.jax_params.flax_path``) followed by
``/__call__``, as flax's ``capture_intermediates`` names them; the model's
own output is walked under ``__call__/<key>``. A module called more than
once keeps its last call's statistics, as the JAX walk does. Only modules
the forward calls appear: where the port computes a step with the weights
directly (the encoder attention's fused q/kv product, the FFN kernels' norm
and projections), the flax submodule's key has no counterpart.
"""
from __future__ import annotations

import re
from typing import Callable, Dict

import torch

from .jax_params import flax_path


def default_stats(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Mean, standard deviation (population) and largest magnitude, in f32."""
    xf = x.float()
    return {"mean": xf.mean(), "std": xf.std(unbiased=False), "absmax": xf.abs().max()}


def _visit(tree, prefix: str, pattern, stat_fn, flat: Dict[str, Dict[str, float]]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _visit(v, f"{prefix}/{k}" if prefix else str(k), pattern, stat_fn, flat)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _visit(v, prefix, pattern, stat_fn, flat)
    elif isinstance(tree, torch.Tensor) and pattern.search(prefix):
        flat[prefix] = {k: float(v) for k, v in stat_fn(tree).items()}


def collect_activation_stats(model: torch.nn.Module, *args, filter_regex: str = ".*",
                             stat_fn: Callable = default_stats, **kwargs) -> Dict[str, Dict[str, float]]:
    """Run ``model(*args, **kwargs)`` once (no gradient) and return
    {module path: {stat: value}} for every module output whose path matches
    ``filter_regex``."""
    pattern = re.compile(filter_regex)
    flat: Dict[str, Dict[str, float]] = {}
    handles = []
    for name, module in model.named_modules():
        if not name:
            continue
        key = flax_path(name) + "/__call__"
        handles.append(module.register_forward_hook(
            lambda _m, _inp, out, key=key: _visit(out, key, pattern, stat_fn, flat)))
    try:
        with torch.no_grad():
            out = model(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    _visit(out, "__call__", pattern, stat_fn, flat)
    return flat
