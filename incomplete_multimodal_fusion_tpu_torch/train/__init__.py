from . import downstream, ema, optim, pretrain, schedules

__all__ = ["downstream", "ema", "optim", "pretrain", "schedules"]
