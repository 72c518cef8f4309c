"""Serving entry point (JAX package serving.py).

``infer_closure`` returns the flat-signature forward a server calls:
``fn(x_d0, ..., x_dk, mask_d0, ..., mask_dk) -> {"preds", "pooled"}``, with
raw NHWC rasters and per-modality patch masks (1 = dropped), the
incomplete-multimodal contract of the reference's user-supplied mask branch
(multimae_crossattn.py:395-399). It packs at full capacity (e = N * T), so
any visible subset runs the same shapes.

The JAX package's ``export_infer`` / ``load_exported`` (a serialized
artifact) are not ported yet; their counterpart is a ``torch.export`` one.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .infer import as_input, resolve_module
from .ops import masking


def infer_closure(model, params, domains: Tuple[str, ...]):
    """``params``: None (the model's own weights), a module, or a state dict
    (loaded once, here)."""
    module = resolve_module(model, params)
    n_dom = len(domains)

    def fn(*args):
        device = next(module.parameters()).device
        x = {d: as_input(a, device) for d, a in zip(domains, args[:n_dom])}
        task_masks = {d: as_input(a, device) for d, a in zip(domains, args[n_dom:])}
        e = module.num_patches * n_dom
        mi = masking.mask_info_from_task_masks(task_masks, domains, e)
        with torch.no_grad():
            out = module(x, mi, e)
        return {"preds": out["preds"], "pooled": out["pooled"]}

    return fn
