"""Per-step LR / weight-decay schedules (JAX package train/schedules.py), on
Python floats.

The reference ``cosine_scheduler`` (pretraining/utils/native_scaler.py:65-82):
linear warmup from ``start_warmup_value`` to ``base_value`` over the warmup
steps, then a half cosine down to ``final_value``, as a callable of the step.
"""
from __future__ import annotations

import math
from typing import Callable


def cosine_scheduler(base_value: float, final_value: float, total_steps: int,
                     warmup_steps: int = 0,
                     start_warmup_value: float = 0.0) -> Callable[[int], float]:
    warmup_steps = max(int(warmup_steps), 0)
    decay_steps = max(total_steps - warmup_steps, 1)

    def schedule(step: int) -> float:
        step = float(step)
        if step < warmup_steps:
            return start_warmup_value + step * (base_value - start_warmup_value) / max(warmup_steps, 1)
        prog = min(max((step - warmup_steps) / decay_steps, 0.0), 1.0)
        return final_value + 0.5 * (base_value - final_value) * (1.0 + math.cos(math.pi * prog))

    return schedule


def scaled_lr(blr: float, total_batch_size: int) -> float:
    """absolute_lr = base_lr * total_batch_size / 256 (pretrain_mmae.py:335)."""
    return blr * total_batch_size / 256.0
