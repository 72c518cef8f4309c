"""Downstream segmentation inference (JAX package infer_segmentation.py;
reference mask2former_infer.py:58-330 and mask2former_infer_seg.py):
MaskFormer forward -> masks upsampled to the input size -> semantic label
map or per-image instances.

``forward_segmentation`` and ``forward_instance_segmentation`` are the
entry points. Inputs are {domain: [B, H, W, C]} NHWC rasters (numpy or
tensors), moved to the model's device. ``params``: None (the model's own
weights), a module, or a state dict. Test-time augmentation, panoptic
inference and the PNG export are not ported yet.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F

from .eval.metrics import instance_inference, semantic_inference
from .infer import as_input, resolve_module
from .ops import masking
from .ops.resize import resize_bilinear


def pad_to_divisible(img: torch.Tensor, div: int = 32) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Zero-pad NHWC to a multiple of ``div`` (mask2former_infer.py:136-150);
    returns the padded image and the original (H, W)."""
    h, w = img.shape[1], img.shape[2]
    ph, pw = (div - h % div) % div, (div - w % div) % div
    pad = [0, 0] * (img.dim() - 3) + [0, pw, 0, ph]  # F.pad lists the last axis first
    return F.pad(img, pad), (h, w)


def sem_seg_postprocess(result: torch.Tensor, img_size: Tuple[int, int],
                        out_size: Tuple[int, int]) -> torch.Tensor:
    """Crop the padding, then resize to the original size (detectron2's
    sem_seg_postprocess, mask2former_infer.py:172-177)."""
    return resize_bilinear(result[..., :img_size[0], :img_size[1]], out_size)


def segmentation_outputs(model, params, inputs: Mapping, drop_modalities: Sequence[str] = ()):
    """The model's output dict for one request, computed without autograd.
    With ``drop_modalities`` the dropped modalities' tokens are all masked
    and their planes left out of the fusion stack, so their pixels reach
    nothing (:48-65)."""
    module = resolve_module(model, params)
    cfg = module.cfg
    device = next(module.parameters()).device
    x = {d: as_input(inputs[d], device) for d in cfg.in_domains}
    kwargs = {}
    if drop_modalities:
        b, n = x[cfg.in_domains[0]].shape[0], cfg.num_patches
        masks = {d: torch.full((b, n), int(d in drop_modalities), dtype=torch.long, device=device)
                 for d in cfg.in_domains}
        e = n * len(cfg.in_domains)
        kwargs = dict(mask_info=masking.mask_info_from_task_masks(masks, cfg.in_domains, e),
                      num_encoded_tokens=e,
                      present=torch.tensor([d not in drop_modalities for d in cfg.in_domains],
                                           device=device))
    with torch.no_grad():
        return module(x, **kwargs)


def semantic_probabilities(out: Mapping, size: Tuple[int, int]) -> torch.Tensor:
    """[B, num_classes, H, W] class probabilities at ``size`` from the
    model's outputs."""
    return semantic_inference(out["pred_logits"], resize_bilinear(out["pred_masks"], size))


def forward_segmentation(model, params, inputs: Mapping, num_classes: int,
                         drop_modalities: Sequence[str] = ()) -> torch.Tensor:
    """Semantic label map per image, [B, H, W]: argmax over the class
    probabilities + 1, as the semantic reference writes it to skip the
    ignore class (mask2former_infer_seg.py:239). ``num_classes`` is kept
    from the JAX signature; the classes are the model's."""
    module = resolve_module(model, params)
    out = segmentation_outputs(module, None, inputs, drop_modalities)
    return semantic_probabilities(out, input_size(module, inputs)).argmax(dim=1) + 1


def forward_instance_segmentation(model, params, inputs: Mapping,
                                  topk: int = 100) -> List[Dict[str, torch.Tensor]]:
    """Per-image instances (mask2former_infer.py instance path): a dict of
    scores, classes, binary masks and mask logits at the input size."""
    module = resolve_module(model, params)
    out = segmentation_outputs(module, None, inputs)
    masks = resize_bilinear(out["pred_masks"], input_size(module, inputs))
    return [instance_inference(out["pred_logits"][b], masks[b], module.cfg.num_classes, topk=topk)
            for b in range(masks.shape[0])]


def input_size(module, inputs: Mapping) -> Tuple[int, int]:
    """(H, W) of the request's rasters."""
    first = inputs[module.cfg.in_domains[0]]
    return int(first.shape[1]), int(first.shape[2])
