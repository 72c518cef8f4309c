"""Per-step LR / weight-decay schedules (JAX package train/schedules.py).

The reference ``cosine_scheduler`` (pretraining/utils/native_scaler.py:65-82):
linear warmup from ``start_warmup_value`` to ``base_value`` over the warmup
steps, then a half cosine down to ``final_value``, as a callable of the step
on Python floats. ``table(device)`` tabulates it as an f32 vector the
optimizer indexes by its device-side count, so a step reads its lr and wd
without the host, and a replayed CUDA graph reads the step's own values.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class CosineSchedule:
    base_value: float
    final_value: float
    total_steps: int
    warmup_steps: int = 0
    start_warmup_value: float = 0.0

    def __call__(self, step) -> float:
        step = float(step)
        warmup = max(int(self.warmup_steps), 0)
        if step < warmup:
            return self.start_warmup_value + step * (self.base_value - self.start_warmup_value) / max(warmup, 1)
        prog = min(max((step - warmup) / max(self.total_steps - warmup, 1), 0.0), 1.0)
        return self.final_value + 0.5 * (self.base_value - self.final_value) * (1.0 + math.cos(math.pi * prog))

    @property
    def last_step(self) -> int:
        """The step from which the value stays constant: the table's last
        entry serves every later step."""
        return max(int(self.total_steps), max(int(self.warmup_steps), 0) + 1)

    def table(self, device=None) -> torch.Tensor:
        """f32 [last_step + 1]: the value at steps 0 .. last_step."""
        return torch.tensor([self(s) for s in range(self.last_step + 1)], dtype=torch.float32,
                            device=device)


def cosine_scheduler(base_value: float, final_value: float, total_steps: int,
                     warmup_steps: int = 0, start_warmup_value: float = 0.0) -> CosineSchedule:
    return CosineSchedule(base_value, final_value, total_steps, warmup_steps, start_warmup_value)


def scaled_lr(blr: float, total_batch_size: int) -> float:
    """absolute_lr = base_lr * total_batch_size / 256 (pretrain_mmae.py:335)."""
    return blr * total_batch_size / 256.0
