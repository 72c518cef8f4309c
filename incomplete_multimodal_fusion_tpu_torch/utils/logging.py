"""Metric logging (JAX package utils/logging.py; reference
pretraining/utils/logger.py:24-198): ``SmoothedValue``, ``MetricLogger`` and
the experiment tracker's ``WandbLogger``. One process trains on one card, so
there is nothing to reduce across processes; the host reads a metric only
when it logs it."""
from __future__ import annotations

import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Optional


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg,
                               value=self.value, count=self.count)


class MetricLogger:
    def __init__(self, delimiter: str = "  ", print_fn=print):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print_fn = print_fn

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = "", total: Optional[int] = None):
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        for i, obj in enumerate(iterable):
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            end = time.time()
            if i % print_freq == 0:
                n = total if total is not None else "?"
                self.print_fn(f"{header} [{i}/{n}] {self} iter: {iter_time} data: {data_time}")
        self.print_fn(f"{header} done in {time.time() - start:.1f}s")

    def jsonl(self, **extra) -> str:
        stats = {k: m.global_avg for k, m in self.meters.items()}
        stats.update(extra)
        return json.dumps(stats)


class WandbLogger:
    """Experiment-tracker logger (reference utils/logger.py:170-198, JAX
    utils/logging.py:88-127). ``wandb`` is optional: where it does not
    import, or its ``init`` fails (no network), the metrics go to
    ``out_dir/wandb_fallback.jsonl``, one JSON line a ``update``."""

    def __init__(self, config=None, project: str = "imf-tpu", entity: str = "", group: str = "",
                 run_name: str = "", out_dir: str = "."):
        self.step = 0
        self._wandb = None
        self.fallback_path = os.path.join(out_dir, "wandb_fallback.jsonl")
        try:
            import wandb

            wandb.init(config=config, project=project, entity=entity or None, group=group or None,
                       name=run_name or None)
            self._wandb = wandb
        except Exception:
            os.makedirs(out_dir, exist_ok=True)

    def set_step(self, step=None):
        self.step = step if step is not None else self.step + 1

    def update(self, metrics: dict):
        log = {k: float(v) for k, v in metrics.items() if v is not None}
        if self._wandb is not None:
            self._wandb.log(log, step=self.step)
        else:
            with open(self.fallback_path, "a") as f:
                f.write(json.dumps({"step": self.step, **log}) + "\n")

    def flush(self):
        pass
