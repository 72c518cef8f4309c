"""The downstream tasks' instance targets (JAX package
losses/set_criterion.py ``SegTargets``), kept in the data layer: the data
sources make them and the set criterion reads them."""
from __future__ import annotations

from typing import NamedTuple

import torch


class SegTargets(NamedTuple):
    labels: torch.Tensor  # [B, G] int, -1 padding
    masks: torch.Tensor  # [B, G, H, W] float 0/1
    valid: torch.Tensor  # [B, G] bool
