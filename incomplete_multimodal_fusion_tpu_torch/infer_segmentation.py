"""Downstream segmentation inference (JAX package infer_segmentation.py;
reference mask2former_infer.py:58-330 and mask2former_infer_seg.py):
MaskFormer forward -> masks upsampled to the input size -> semantic label
map or per-image instances.

``forward_segmentation`` and ``forward_instance_segmentation`` are the
entry points. Inputs are {domain: [B, H, W, C]} NHWC rasters (numpy or
tensors), moved to the model's device. ``params``: None (the model's own
weights), a module, or a state dict. ``semantic_inference_with_tta``
averages the class probabilities over flipped (and, for a convolutional
backbone, rescaled) views; ``panoptic_inference`` is Mask2Former's
panoptic postprocess (the scores on the device, the segment loop on the
host in numpy); ``colorize_labels``, ``overlay_instances`` and
``save_segmentation_png`` draw on the host (the PNG with the port's own
writer, ``infer.write_png``).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .eval.metrics import instance_inference, semantic_inference, to_numpy
from .infer import as_input, resolve_module, write_png
from .ops import masking
from .ops.resize import resize_bilinear, resize_bilinear_nhwc


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
    """The model's output dict for one request, computed in inference mode
    (no autograd) and with dropout off (the module's mode is restored after), as the JAX
    package's ``apply`` without a dropout key. With ``drop_modalities`` the
    dropped modalities' tokens are all masked and their planes left out of
    the fusion stack, so their pixels reach nothing (:48-65)."""
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
    was_training = module.training
    module.eval()
    try:
        with torch.inference_mode():
            return module(x, **kwargs)
    finally:
        module.train(was_training)


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


def panoptic_inference(
    mask_cls: torch.Tensor,  # [Q, K+1]
    mask_pred: torch.Tensor,  # [Q, H, W] logits
    object_mask_threshold: float = 0.8,
    overlap_threshold: float = 0.8,
    thing_ids: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, list]:
    """Mask2Former panoptic postprocess (mask2former_infer.py:288-345, JAX
    infer_segmentation.py:92-144): keep confident non-void queries, argmax
    over score-weighted masks, paint each segment as (argmax region) &
    (sigmoid >= 0.5), drop poor-overlap segments, and merge same-class
    stuff regions into one segment (stuff_memory_list, :313-331).
    ``thing_ids``: contiguous class ids that are instances (e.g.
    ``data.ade_metadata.thing_ids()``); None = all classes are things (no
    merging). The scores and the argmax run where the tensors are; the
    segment loop on the host. Returns the int32 segment map [H, W] (on the
    host) and the segments."""
    scores = torch.softmax(mask_cls, dim=-1)
    labels = scores.argmax(dim=-1)
    conf = scores[:, :-1].max(dim=-1).values
    keep = (labels != mask_cls.shape[-1] - 1) & (conf > object_mask_threshold)
    probs = torch.sigmoid(mask_pred)
    weighted = torch.where(keep[:, None, None], conf[:, None, None] * probs, torch.full_like(probs, -1e4))
    assign = weighted.argmax(dim=0)  # [H, W] query id

    things = None if thing_ids is None else set(int(t) for t in thing_ids)
    pan = np.zeros(tuple(mask_pred.shape[1:]), np.int32)
    segments = []
    sid = 0
    stuff_memory = {}  # class id -> segment id (merge stuff regions)
    assign_np, probs_np, keep_np, labels_np = (to_numpy(t) for t in (assign, probs, keep, labels))
    for q in range(mask_pred.shape[0]):
        if not keep_np[q]:
            continue
        cls = int(labels_np[q])
        isthing = things is None or cls in things
        region = assign_np == q
        orig = probs_np[q] >= 0.5
        mask = region & orig
        if region.sum() == 0 or orig.sum() == 0 or mask.sum() == 0:
            continue
        if region.sum() / orig.sum() < overlap_threshold:
            continue
        if not isthing and cls in stuff_memory:
            pan[mask] = stuff_memory[cls]
            continue
        sid += 1
        if not isthing:
            stuff_memory[cls] = sid
        pan[mask] = sid
        segments.append({"id": sid, "category_id": cls, "isthing": isthing})
    return torch.from_numpy(pan), segments


def semantic_inference_with_tta(model, params, inputs: Mapping, scales: Sequence[float] = (0.75, 1.0, 1.25),
                                flip: bool = True) -> torch.Tensor:
    """Multi-scale + horizontal-flip test-time augmentation (reference
    utils/test_time_augmentation.py:21-100 SemanticSegmentorWithTTA, JAX
    infer_segmentation.py:147-194): the class probabilities at the input
    size averaged over the views. The fusion-token ViT is fixed-size, so for
    it the scales reduce to (1.0,), as in JAX: one forward and one flipped
    forward (the flip along W of the NHWC inputs, undone along the
    probabilities' W). Returns [B, K, H, W]."""
    module = resolve_module(model, params)
    device = next(module.parameters()).device
    inputs = {k: as_input(v, device) for k, v in inputs.items()}
    base_hw = tuple(inputs[module.cfg.in_domains[0]].shape[1:3])
    if module.cfg.backbone_type.startswith("vit"):
        scales = (1.0,)
    views = []
    for s in scales:
        hw = (max(32, int(base_hw[0] * s) // 32 * 32), max(32, int(base_hw[1] * s) // 32 * 32))
        x_s = {k: (resize_bilinear_nhwc(v, hw) if v.dim() == 4 and tuple(v.shape[1:3]) != hw else v)
               for k, v in inputs.items()}
        views.append((x_s, False))
        if flip:
            views.append(({k: (torch.flip(v, dims=[2]) if v.dim() == 4 else v) for k, v in x_s.items()}, True))
    acc = None
    for x_v, flipped in views:
        sem = semantic_probabilities(segmentation_outputs(module, None, x_v), base_hw)
        if flipped:
            sem = torch.flip(sem, dims=[-1])
        acc = sem if acc is None else acc + sem
    return acc / len(views)


# Land-cover style colormap (role of the reference's Color2Index table,
# multimodal_quadruplet.py:19-48)
DEFAULT_COLORS = np.asarray(
    [
        [0, 0, 0], [65, 155, 223], [57, 125, 73], [136, 176, 83],
        [122, 135, 198], [228, 150, 53], [223, 195, 90], [196, 40, 27],
        [165, 155, 143], [179, 159, 225], [97, 34, 155], [255, 255, 255],
    ],
    np.uint8,
)


def colorize_labels(label_map, colors: Optional[np.ndarray] = None) -> np.ndarray:
    """[..., H, W] class ids (array or tensor) -> [..., H, W, 3] uint8."""
    colors = DEFAULT_COLORS if colors is None else colors
    return colors[np.clip(to_numpy(label_map), 0, len(colors) - 1)]


def _mask_boundary(sel: np.ndarray) -> np.ndarray:
    """Boundary pixels of a binary mask (mask minus its 4-neighbor erosion).
    Zero-padded shifts, not np.roll: wraparound would treat image-border
    pixels of an edge-to-edge mask as interior and drop their outline."""
    p = np.pad(sel, 1, constant_values=False)
    er = (sel & p[:-2, 1:-1] & p[2:, 1:-1] & p[1:-1, :-2] & p[1:-1, 2:])
    return sel & ~er


def overlay_instances(
    image,  # [H, W, 3] in any range
    instances: Mapping,
    score_threshold: float = 0.5,
    alpha: float = 0.5,
    colors: Optional[np.ndarray] = None,
    class_names: Optional[Sequence[str]] = None,
    draw_labels: bool = True,
) -> np.ndarray:
    """Blend instance masks over an image with boundary outlines and
    "name score%" labels at each mask centroid (the detectron2 Visualizer's
    draw_instance_predictions role, utils/visualizer.py:1-1243), on the
    host. The labels are drawn with PIL where it is installed; without it
    the overlay comes back without them, as in JAX."""
    colors = DEFAULT_COLORS if colors is None else colors
    img = to_numpy(image).astype(np.float32)
    img = (img - img.min()) / max(img.max() - img.min(), 1e-6) * 255.0
    out = img.copy()
    scores = to_numpy(instances["scores"])
    keep = scores >= score_threshold
    masks = to_numpy(instances["pred_masks"])[keep]
    scores = scores[keep]
    classes = (to_numpy(instances["pred_classes"])[keep]
               if "pred_classes" in instances else np.zeros(len(masks), np.int64))
    labels = []
    for i, m in enumerate(masks):
        color = colors[(i + 1) % len(colors)].astype(np.float32)
        sel = np.asarray(m) > 0.5
        if not sel.any():
            continue
        out[sel] = (1 - alpha) * out[sel] + alpha * color
        out[_mask_boundary(sel)] = color  # solid outline
        ys, xs = np.nonzero(sel)
        name = (class_names[int(classes[i])]
                if class_names is not None and int(classes[i]) < len(class_names)
                else str(int(classes[i])))
        labels.append((float(xs.mean()), float(ys.mean()), f"{name} {scores[i] * 100:.0f}%"))
    out = out.astype(np.uint8)
    if draw_labels and labels:
        try:
            from PIL import Image, ImageDraw  # type: ignore

            pil = Image.fromarray(out)
            draw = ImageDraw.Draw(pil)
            for cx, cy, text in labels:
                # 1px shadow for contrast on any background
                draw.text((cx + 1, cy + 1), text, fill=(0, 0, 0))
                draw.text((cx, cy), text, fill=(255, 255, 255))
            out = np.asarray(pil)
        except ImportError:
            pass  # labels need PIL; the blended overlay still returns
    return out


def save_segmentation_png(label_map, path: str, colors: Optional[np.ndarray] = None) -> str:
    """Write a colorized *_seg.png (mask2former_infer.py:211-226 role) with
    the port's PNG writer; ``label_map`` [H, W]."""
    write_png(path, colorize_labels(label_map, colors))
    return path
