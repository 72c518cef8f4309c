"""Model EMA (JAX package train/ema.py; reference
pretraining/utils/model_ema.py:18-131, a decay-0.9999 shadow copy). An
opt-in part of the pretraining state, updated after the parameters and
carried by the checkpoints."""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch


def init_ema(named_params: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """{name: an f32 copy of the parameter} (real copies, not aliases)."""
    return {name: p.detach().float().clone() for name, p in named_params}


@torch.no_grad()
def update_ema(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float = 0.9999) -> Dict[str, torch.Tensor]:
    """ema = ema * decay + (1 - decay) * param, in f32 and in place."""
    shadows = list(ema.values())
    torch._foreach_mul_(shadows, decay)
    torch._foreach_add_(shadows, [params[name].detach().float() for name in ema], alpha=1.0 - decay)
    return ema
