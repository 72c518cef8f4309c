"""Serving entry points (JAX package serving.py).

``infer_closure`` returns the flat-signature forward a server calls:
``fn(x_d0, ..., x_dk, mask_d0, ..., mask_dk) -> {"preds", "pooled"}``, with
raw NHWC rasters and per-modality patch masks (1 = dropped), the
incomplete-multimodal contract of the reference's user-supplied mask branch
(multimae_crossattn.py:395-399). It packs at full capacity (e = N * T), so
any visible subset runs the same shapes.

``export_infer`` serializes that forward as one artifact with the weights
baked in (``torch.export`` at a static batch and image size, saved with
``torch.export.save``), the counterpart of the JAX package's StableHLO
export; ``load_exported`` reloads it into a callable with the same flat
arguments, in a process that imports no model code: the program's graph
calls the hand-written kernels as the operators of ops/library.py, which
this module registers on import, and runs on the device it was exported on.
Both run under ``torch.inference_mode``: no autograd layer is entered, the
operators' own (``register_autograd``) included.

    blob = export_infer(model, None, batch=1, image_size=256)   # bytes
    serve = load_exported(blob)
    out = serve(*xs, *masks)   # {"preds": {d: [B, H, W, C]}, "pooled": [B, T+1, D]}

CLI: ``python -m incomplete_multimodal_fusion_tpu_torch.cli.export_serving``.
"""
from __future__ import annotations

import io
from typing import Tuple

import torch

from .ops import library  # noqa: F401  (registers the kernels' operators an exported program calls)
from .ops import masking


def _flat_forward(module, domains: Tuple[str, ...], args):
    """The flat contract on ``module``: (x_d0..x_dk, mask_d0..mask_dk) ->
    {"preds", "pooled"}, packed at full capacity."""
    n_dom = len(domains)
    x = dict(zip(domains, args[:n_dom]))
    task_masks = dict(zip(domains, args[n_dom:]))
    e = module.num_patches * n_dom
    mi = masking.mask_info_from_task_masks(task_masks, domains, e)
    out = module(x, mi, e)
    return {"preds": out["preds"], "pooled": out["pooled"]}


def infer_closure(model, params, domains: Tuple[str, ...]):
    """``params``: None (the model's own weights), a module, or a state dict
    (loaded once, here). Arguments may be numpy arrays or tensors."""
    from .infer import as_input, resolve_module

    module = resolve_module(model, params)
    n_dom = len(domains)

    def fn(*args):
        device = next(module.parameters()).device
        args = [as_input(a, device) for a in args[:2 * n_dom]]
        with torch.inference_mode():
            return _flat_forward(module, domains, args)

    return fn


class _Closure(torch.nn.Module):
    """The flat forward as a module for ``torch.export``: the model is its
    submodule, so the model's weights are the exported program's state."""

    def __init__(self, module, domains: Tuple[str, ...]):
        super().__init__()
        self.model = module
        self.domains = domains

    def forward(self, *args):
        return _flat_forward(self.model, self.domains, args)


def export_infer(model, params, batch: int = 1, image_size: int = 256) -> bytes:
    """The serving forward at a static ``batch`` and ``image_size``,
    exported with its weights (``params``: None, a module or a state dict)
    on the device the model lives on, serialized to bytes. The arguments
    are f32 rasters [B, S, S, C] (int32 class maps [B, S, S] for a semseg
    domain) and int32 masks [B, num_patches]."""
    from . import modalities
    from .infer import resolve_module

    module = resolve_module(model, params)
    domains = tuple(module.in_domains)
    device = next(module.parameters()).device
    args = [torch.zeros((batch, image_size, image_size), dtype=torch.int32, device=device)
            if modalities.get(d).adapter == "semseg" else
            torch.zeros((batch, image_size, image_size, modalities.get(d).num_channels), device=device)
            for d in domains]
    args += [torch.zeros((batch, module.num_patches), dtype=torch.int32, device=device) for _ in domains]
    was_training = module.training
    module.eval()
    try:
        with torch.no_grad():
            program = torch.export.export(_Closure(module, domains), tuple(args), strict=False)
    finally:
        module.train(was_training)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def exported_device(program) -> torch.device:
    """The device an exported program's weights live on."""
    for t in program.state_dict.values():
        return t.device
    return torch.device("cpu")


def input_dtypes(program):
    """The dtypes of an exported program's user inputs, in order."""
    names = set(program.graph_signature.user_inputs)
    return [n.meta["val"].dtype for n in program.graph.nodes if n.op == "placeholder" and n.name in names]


def load_exported(blob: bytes):
    """Deserializes an ``export_infer`` artifact into a callable taking the
    same flat (x_d0..x_dk, mask_d0..mask_dk) arguments (numpy arrays or
    tensors, each taken to the program's device in the dtype it was
    exported with: f32 rasters, int32 class maps and masks)."""
    program = torch.export.load(io.BytesIO(blob))
    fn = program.module()
    device = exported_device(program)
    dtypes = input_dtypes(program)

    def serve(*args):
        args = [torch.as_tensor(a).to(device=device, dtype=dt) for a, dt in zip(args, dtypes)]
        with torch.inference_mode():
            return fn(*args)

    serve.program = program
    return serve
