from . import optim, pretrain, schedules

__all__ = ["optim", "pretrain", "schedules"]
