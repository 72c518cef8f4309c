"""MAE inference (JAX package infer.py; reference pretraining/infer_mmae.py).

  * one forward with seeded random masks and ``num_encoded_tokens``
    (infer_mmae.py:330-338), the masks drawn from a ``torch.Generator``;
  * caller-supplied ``task_masks`` to force modalities absent
    (infer_mmae.py:344-361: "fill 1 = drop a modality"), with
    ``drop_modalities`` as the shorthand;
  * PSNR, the reconstruction-parity metric.

Plotting is not ported yet.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from .ops import masking


class InferenceResult(NamedTuple):
    preds: Dict[str, torch.Tensor]  # {task: [B, H, W, C]}
    task_masks: Dict[str, torch.Tensor]  # {task: [B, N]} 1 = masked
    pooled: torch.Tensor  # [B, T+1, D]


def resolve_module(model: nn.Module, params: Union[None, nn.Module, Mapping]) -> nn.Module:
    """The module to run: ``params`` itself when it is a module, else
    ``model`` with the state dict ``params`` loaded (when given)."""
    if isinstance(params, nn.Module):
        return params
    if params is not None:
        model.load_state_dict(params)
    return model


def as_input(v, device) -> torch.Tensor:
    """A request array (numpy or tensor) as a tensor on ``device``."""
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(v)
    return v.to(device)


def infer(
    model: nn.Module,
    params,
    x: Mapping[str, Union[np.ndarray, torch.Tensor]],
    num_encoded_tokens: int,
    generator: Optional[torch.Generator] = None,
    task_masks: Optional[Mapping[str, torch.Tensor]] = None,
    drop_modalities: Sequence[str] = (),
    alphas: float = 1.0,
    sample_tasks_uniformly: bool = False,
) -> InferenceResult:
    """Forward with random masking (default) or explicit/ablation masks.
    ``params``: None (the model's own weights), a module, or a state dict."""
    module = resolve_module(model, params)
    device = next(module.parameters()).device
    domains = tuple(module.in_domains)
    x = {d: as_input(x[d], device) for d in domains}
    b = x[domains[0]].shape[0]
    n = module.num_patches
    unknown = set(drop_modalities) - set(domains)
    if unknown:
        raise ValueError(f"drop_modalities {sorted(unknown)} not in model domains {domains}")
    if task_masks is None and drop_modalities:
        task_masks = {
            d: torch.full((b, n), 1 if d in drop_modalities else 0, dtype=torch.long, device=device)
            for d in domains
        }
    if task_masks is not None:
        # pack at full capacity: with caller-supplied masks the visible count
        # can exceed num_encoded_tokens; the reference encodes all of them
        # (multimae_crossattn.py:399), padding slots take the rest
        num_encoded_tokens = n * len(domains)
        task_masks = {d: as_input(task_masks[d], device) for d in domains}
        mi = masking.mask_info_from_task_masks(task_masks, domains, num_encoded_tokens)
    else:
        if generator is None:
            generator = torch.Generator().manual_seed(1)  # infer_mmae.py:330 seed(1)
        mi = masking.generate_random_masks(
            generator, domains, (n,) * len(domains), num_encoded_tokens, b,
            alphas=alphas, sample_tasks_uniformly=sample_tasks_uniformly, device=device,
        )
    with torch.no_grad():
        out = module(x, mi, num_encoded_tokens)
    return InferenceResult(out["preds"], out["task_masks"], out["pooled"])


def masked_input(x: torch.Tensor, mask: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Zero out masked patches for visualization (infer_mmae plot grids)."""
    b, h, w, c = x.shape
    m = mask.reshape(b, h // patch_size, w // patch_size).to(x.dtype)
    m = m.repeat_interleave(patch_size, dim=1).repeat_interleave(patch_size, dim=2)
    return x * (1 - m)[..., None]


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: Optional[float] = None) -> torch.Tensor:
    """Peak signal-to-noise ratio."""
    pred = pred.float()
    target = target.float()
    if data_range is None:
        data_range = float(target.max() - target.min())
    mse = ((pred - target) ** 2).mean()
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp(min=1e-12))


def masked_psnr(pred, target, mask, patch_size: int, data_range: Optional[float] = None):
    """PSNR over masked (reconstructed) patches only."""
    b, h, w, c = pred.shape
    m = mask.reshape(b, h // patch_size, w // patch_size).float()
    m = m.repeat_interleave(patch_size, dim=1).repeat_interleave(patch_size, dim=2)[..., None]
    pred = pred.float()
    target = target.float()
    if data_range is None:
        data_range = float(target.max() - target.min())
    mse = (((pred - target) ** 2) * m).sum() / (m.sum() * c).clamp(min=1.0)
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp(min=1e-12))
