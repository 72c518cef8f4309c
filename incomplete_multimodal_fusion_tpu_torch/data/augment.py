"""Train-time augmentation as pure-numpy/scipy host ops (JAX package
data/augment.py, draw for draw).

Replaces two reference subsystems with one composable module:

* ``random_crop_multimodal`` — the pretraining RandomCrop
  (pretraining/utils/multimodal_dfc2023.py:54-94): one crop window applied
  consistently to every modality raster and the label map. Extra channels
  like the SEN12MS superpixel ``segments``/``index`` planes
  (multimodal_dataset.py:42-72) ride along as ordinary dict entries.
* ``sample_affine`` / ``apply_affine`` / ``augment_sample`` — the downstream
  imgaug pipeline (downstream/instance_segmentation/dataset/aug_strategy.py:
  1-202, used by dataset.py:115,166). The reference samples independent
  rotate / translate / scale / shear / flip stages; here they compose into
  ONE affine map applied once per array (bilinear for images, nearest for
  masks), which is both faster and exactly as expressive. Photometric ops
  (gaussian blur, gamma contrast ~ aug_strategy.py meta_gblur /
  meta_contrast_g) apply to optical channels only.

Distribution parity with aug_strategy.py:
  rotate  ~ Normal(choice([0, 90, 180, 270]), 22.5 deg)     (:29)
  translate percent ~ Normal(0, 0.3)                        (:30)
  scale   ~ Normal(1, 0.3)                                  (:31)
  shear   ~ Normal(0, 4 deg)                                (:33)
  fliplr / flipud each p=0.5                                (:45-46)
  blur    sigma ~ U(0, 2), applied ~half the time           (:48)
  gamma   ~ U(0.4, 1.6)                                     (:76)

Everything runs on the host inside the batch sources, every draw from the
caller's ``np.random.Generator`` in the JAX package's order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from scipy import ndimage as _ndi


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    rotate: bool = True
    translate: bool = True
    scale: bool = True
    shear: bool = True
    flip: bool = True
    blur: bool = False  # photometric, off by default on z-scored inputs
    gamma: bool = False
    translate_std: float = 0.3
    scale_std: float = 0.3
    shear_std_deg: float = 4.0
    rotate_jitter_deg: float = 22.5


def random_crop_multimodal(
    sample: Dict[str, np.ndarray],
    out_size: Tuple[int, int],
    rng: np.random.Generator,
) -> Dict[str, np.ndarray]:
    """One random window applied to every array (CHW rasters and HW maps),
    including SEN12MS-style 'segments'/'index' superpixel planes.

    Mirrors multimodal_dfc2023.py:54-94: top/left ~ U(0, size - out); string
    entries (e.g. 'id') pass through untouched.
    """
    nh, nw = out_size
    h = w = None
    for v in sample.values():
        if isinstance(v, np.ndarray) and v.ndim >= 2:
            h, w = v.shape[-2], v.shape[-1]
            break
    assert h is not None, "no raster entries in sample"
    top = int(rng.integers(0, max(h - nh, 0) + 1))
    left = int(rng.integers(0, max(w - nw, 0) + 1))
    out = {}
    for k, v in sample.items():
        if isinstance(v, np.ndarray) and v.ndim >= 2:
            out[k] = v[..., top : top + nh, left : left + nw]
        else:
            out[k] = v
    return out


@dataclasses.dataclass(frozen=True)
class AffineParams:
    matrix: np.ndarray  # 2x2 output->input linear map (scipy convention)
    offset: np.ndarray  # length-2 offset
    blur_sigma: float = 0.0
    gamma: float = 1.0


def sample_affine(
    rng: np.random.Generator, h: int, w: int, cfg: AugmentConfig = AugmentConfig()
) -> AffineParams:
    """Sample one composed geometric transform about the image center."""
    angle = 0.0
    if cfg.rotate:
        base = float(rng.choice([0.0, 90.0, 180.0, 270.0]))
        angle = math.radians(base + rng.normal(0.0, cfg.rotate_jitter_deg))
    sc = float(np.clip(rng.normal(1.0, cfg.scale_std), 0.4, 1.8)) if cfg.scale else 1.0
    shear = math.radians(float(np.clip(rng.normal(0.0, cfg.shear_std_deg), -15, 15))) \
        if cfg.shear else 0.0
    tx = float(np.clip(rng.normal(0.0, cfg.translate_std), -0.45, 0.45)) * w \
        if cfg.translate else 0.0
    ty = float(np.clip(rng.normal(0.0, cfg.translate_std), -0.45, 0.45)) * h \
        if cfg.translate else 0.0
    fx = -1.0 if (cfg.flip and rng.random() < 0.5) else 1.0
    fy = -1.0 if (cfg.flip and rng.random() < 0.5) else 1.0

    ca, sa = math.cos(angle), math.sin(angle)
    rot = np.array([[ca, -sa], [sa, ca]])
    shr = np.array([[1.0, math.tan(shear)], [0.0, 1.0]])
    fwd = rot @ shr * sc * np.array([[fy], [fx]])  # rows: (y, x) forward map

    # scipy affine_transform maps OUTPUT coords to INPUT coords:
    #   in = matrix @ out + offset; invert the forward map about the center
    inv = np.linalg.inv(fwd)
    center = np.array([(h - 1) / 2.0, (w - 1) / 2.0])
    offset = center - inv @ (center + np.array([ty, tx]))

    sigma = float(rng.uniform(0.0, 2.0)) if (cfg.blur and rng.random() < 0.5) else 0.0
    gamma = float(rng.uniform(0.4, 1.6)) if cfg.gamma else 1.0
    return AffineParams(matrix=inv, offset=offset, blur_sigma=sigma, gamma=gamma)


def apply_affine(
    arr: np.ndarray, params: AffineParams, *, is_mask: bool = False,
    cval: float = 0.0,
) -> np.ndarray:
    """Apply the transform to [H, W], [C, H, W] or [N, H, W] arrays.

    Bilinear for images, nearest for masks/labels (imgaug_mask semantics:
    aug_strategy.py:107-125 uses SegmentationMapsOnImage = order 0). A
    plane whose bytes are all zero maps to zeros when ``cval`` is 0, so it
    is not warped (most of a sample's padded instance masks): the same
    output, without the warp.
    """
    order = 0 if is_mask else 1
    if arr.ndim == 2:
        return _ndi.affine_transform(
            arr, params.matrix, offset=params.offset, order=order,
            mode="constant", cval=cval, output=arr.dtype,
        )
    return np.stack([
        np.zeros_like(c) if cval == 0 and not np.ascontiguousarray(c).view(np.uint8).any() else
        _ndi.affine_transform(
            c, params.matrix, offset=params.offset, order=order,
            mode="constant", cval=cval, output=arr.dtype,
        )
        for c in arr
    ])


def apply_photometric(img: np.ndarray, params: AffineParams) -> np.ndarray:
    """Blur + gamma for optical channels (expects roughly [0, 1] range for
    gamma; callers on z-scored data should leave cfg.gamma off)."""
    out = img
    if params.blur_sigma > 0:
        axes = (-2, -1)
        out = _ndi.gaussian_filter(
            out, sigma=params.blur_sigma,
            axes=axes if out.ndim > 2 else None,
        ) if out.ndim == 2 else np.stack(
            [_ndi.gaussian_filter(c, params.blur_sigma) for c in out]
        )
    if params.gamma != 1.0:
        out = np.sign(out) * np.abs(out) ** params.gamma
    return out


def augment_sample(
    images: Dict[str, np.ndarray],
    rng: np.random.Generator,
    cfg: AugmentConfig = AugmentConfig(),
    masks: Optional[np.ndarray] = None,  # [N, H, W] instance masks
    label: Optional[np.ndarray] = None,  # [H, W] semantic labels
    photometric_keys: Sequence[str] = ("s2", "rgb"),
    label_cval: float = 0.0,
):
    """Augment a multimodal sample consistently: one geometric transform for
    every modality + targets; photometric only on optical channels.

    Returns (images, masks, label) with the untouched entries passed through.
    """
    ref = next(iter(images.values()))
    h, w = ref.shape[-2], ref.shape[-1]
    params = sample_affine(rng, h, w, cfg)
    out_images = {}
    for k, v in images.items():
        a = apply_affine(v, params)
        if k in photometric_keys:
            a = apply_photometric(a, params)
        out_images[k] = a
    out_masks = apply_affine(masks, params, is_mask=True) if masks is not None else None
    out_label = (
        apply_affine(label, params, is_mask=True, cval=label_cval)
        if label is not None else None
    )
    return out_images, out_masks, out_label
