"""The contrastive term of pretraining (JAX package losses/contrastive.py;
reference pretraining/multimae/criterion.py:328-335).

Only ``dino_loss`` is ported: the pretraining step uses it. byol, vicreg,
the hard-negative InfoNCE and the centered DINO are not ported yet.
"""
from __future__ import annotations

import torch


def _l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / x.norm(dim=dim, keepdim=True).clamp(min=eps)


def dino_loss(student: torch.Tensor, teacher: torch.Tensor, teacher_temp: float = 0.04,
              student_temp: float = 0.1) -> torch.Tensor:
    """dino_loss_func (criterion.py:328-335): the fusion pool is the student,
    the modality pool the teacher, whose gradient is stopped."""
    student = _l2norm(student.float(), dim=1)
    teacher = _l2norm(teacher.float(), dim=1)
    s = torch.log_softmax(student / student_temp, dim=-1)
    t = torch.softmax(teacher / teacher_temp, dim=-1).detach()
    return (-t * s).sum(dim=-1).mean()
