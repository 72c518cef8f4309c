"""Task-loss balancing (JAX package losses/balancing.py; reference
pretraining/utils/task_balancing.py).

``uncertainty_weighting`` is Kendall-style homoscedastic uncertainty,
``exp(-log_var) * L + log_var`` with zero-loss masking
(task_balancing.py:21-44). The per-task log-variances are 0-d f32 tensors
the train state holds and its own AdamW group updates (train/pretrain.py).
"""
from __future__ import annotations

from typing import Dict, Iterable

import torch


def no_weighting(task_losses: Dict[str, torch.Tensor], params=None) -> Dict[str, torch.Tensor]:
    return dict(task_losses)


def init_uncertainty_params(tasks: Iterable[str], device=None) -> Dict[str, torch.Tensor]:
    """{task: 0-d f32 zero log-variance}, each a leaf that takes a gradient."""
    return {t: torch.zeros((), dtype=torch.float32, device=device, requires_grad=True) for t in tasks}


def uncertainty_weighting(task_losses: Dict[str, torch.Tensor],
                          params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = {}
    for t, loss in task_losses.items():
        log_var = params[t]
        weighted = torch.exp(-log_var) * loss + log_var
        # zero-loss masking (task_balancing.py:38-42)
        out[t] = torch.where(loss == 0.0, torch.zeros_like(weighted), weighted)
    return out
