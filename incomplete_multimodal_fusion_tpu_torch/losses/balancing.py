"""Task-loss balancing (JAX package losses/balancing.py; reference
pretraining/utils/task_balancing.py). Only ``no_weighting``, the pretraining
default, is ported; the uncertainty balancer and its AdamW group are not yet.
"""
from __future__ import annotations

from typing import Dict

import torch


def no_weighting(task_losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return dict(task_losses)
