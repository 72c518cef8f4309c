from . import downstream, optim, pretrain, schedules

__all__ = ["downstream", "optim", "pretrain", "schedules"]
