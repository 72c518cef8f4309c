"""Training-summary writer (JAX package utils/summary.py; reference
downstream/*/utils/summary.py:26-41 ``create_summary`` and the JSON lines of
pretrain_mmae.py:412-414).

Writes JSON lines always, one a scalar; mirrors them to TensorBoard when
``torch.utils.tensorboard`` imports.
"""
from __future__ import annotations

import json
import os
import time


class SummaryWriter:
    def __init__(self, log_dir: str, filename: str = "events.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._fh = open(self.path, "a", encoding="utf-8")
        self._tb = None
        try:  # optional TensorBoard mirror
            from torch.utils.tensorboard import SummaryWriter as TB

            self._tb = TB(log_dir=log_dir)
        except Exception:
            pass

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._fh.write(json.dumps({"tag": tag, "value": float(value), "step": int(step), "ts": time.time()}) + "\n")
        self._fh.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def add_scalars(self, scalars: dict, step: int) -> None:
        for k, v in scalars.items():
            self.add_scalar(k, v, step)

    def close(self) -> None:
        self._fh.close()
        if self._tb is not None:
            self._tb.close()


def create_summary(log_dir: str) -> SummaryWriter:
    return SummaryWriter(log_dir)
