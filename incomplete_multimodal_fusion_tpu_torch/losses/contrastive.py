"""Contrastive / self-distillation losses (JAX package losses/contrastive.py;
reference pretraining/multimae/criterion.py:175-335).

The pretraining step uses ``dino_loss``. The others are exported as the JAX
package exports them: byol, vicreg, the debiased hard-negative InfoNCE and
the DINO loss with an EMA centre, which carries its centre as explicit state
(the reference's torch buffer, criterion.py:280, 308-317).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

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


def byol_loss(p: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """byol_loss_func (criterion.py:319-326), the gradient of ``z`` stopped."""
    p = p.float()
    z = z.detach().float()
    cos = (_l2norm(p) * _l2norm(z)).sum(dim=-1)
    return 2.0 - 2.0 * cos.mean()


def _off_diagonal(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[0]
    return x.flatten()[:-1].reshape(n - 1, n + 1)[:, 1:].flatten()


def vicreg_loss(za: torch.Tensor, zb: torch.Tensor, l: float = 25.0, mu: float = 25.0,
                nu: float = 1.0) -> torch.Tensor:
    """vicreg (criterion.py:179-212): invariance MSE + std hinge + covariance,
    the variance unbiased (ddof 1) as torch's ``.var()`` is."""
    za, zb = za.float(), zb.float()
    sim = ((za - zb) ** 2).mean()
    std_a = torch.sqrt(za.var(dim=0, correction=1) + 1e-4)
    std_b = torch.sqrt(zb.var(dim=0, correction=1) + 1e-4)
    std = torch.relu(1 - std_a).mean() + torch.relu(1 - std_b).mean()
    n, d = za.shape
    ca = (za - za.mean(0)).T @ (za - za.mean(0)) / (n - 1)
    cb = (zb - zb.mean(0)).T @ (zb - zb.mean(0)) / (n - 1)
    cov = (_off_diagonal(ca) ** 2).sum() / d + (_off_diagonal(cb) ** 2).sum() / d
    return l * sim + mu * std + nu * cov


def hard_negative_loss(out_1: torch.Tensor, out_2: torch.Tensor, tau_plus: float = 0.1,
                       beta: float = 1.0, temperature: float = 0.5,
                       estimator: str = "hard") -> torch.Tensor:
    """HardNegtive_loss (criterion.py:214-268): debiased hard-negative
    InfoNCE; the ``hard`` estimator's negative term is floored at
    n * e^(-1/temperature)."""
    b = out_1.shape[0]
    o1 = _l2norm(out_1.float(), dim=1)
    o2 = _l2norm(out_2.float(), dim=1)
    out = torch.cat([o1, o2], dim=0)  # [2B, D]
    sim = torch.exp(out @ out.T / temperature)  # [2B, 2B]
    idx = torch.arange(2 * b, device=out.device)
    self_mask = idx[:, None] == idx[None, :]
    pair_mask = idx[:, None] == ((idx[None, :] + b) % (2 * b))
    neg_mask = ~(self_mask | pair_mask)
    neg = torch.where(neg_mask, sim, torch.zeros_like(sim))
    pos = torch.exp((o1 * o2).sum(dim=-1) / temperature)
    pos = torch.cat([pos, pos], dim=0)
    if estimator == "hard":
        n = b * 2 - 2
        log_neg = torch.where(neg_mask, torch.log(sim.clamp(min=1e-38)), torch.full_like(sim, -math.inf))
        imp = torch.where(neg_mask, torch.exp(beta * log_neg), torch.zeros_like(sim))
        reweight = (imp * neg).sum(dim=-1) / (imp.sum(dim=-1) / n)
        ng = (-tau_plus * n * pos + reweight) / (1 - tau_plus)
        ng = ng.clamp(min=n * math.e ** (-1 / temperature))
    elif estimator == "easy":
        ng = neg.sum(dim=-1)
    else:
        raise ValueError(estimator)
    return (-torch.log(pos / (pos + ng))).mean()


class DINOCenterState(NamedTuple):
    center: torch.Tensor  # [1, D]


def init_dino_center(out_dim: int, device=None) -> DINOCenterState:
    return DINOCenterState(torch.zeros((1, out_dim), dtype=torch.float32, device=device))


def dino_center_loss(state: DINOCenterState, student_outputs: Sequence[torch.Tensor],
                     teacher_outputs: Sequence[torch.Tensor], teacher_temp: float = 0.04,
                     student_temp: float = 0.1,
                     center_momentum: float = 0.9) -> Tuple[torch.Tensor, DINOCenterState]:
    """DINOLoss with an EMA centre (criterion.py:270-317), functional:
    returns the loss and the next centre state."""
    students = [_l2norm(s.float(), dim=1) for s in student_outputs]
    teachers = [_l2norm(t.float(), dim=1) for t in teacher_outputs]
    s_out = [torch.log_softmax(s / student_temp, dim=-1) for s in students]
    t_out = [torch.softmax((t - state.center) / teacher_temp, dim=-1).detach() for t in teachers]
    total, n_terms = 0.0, 0
    for ti, t in enumerate(t_out):
        for si, s in enumerate(s_out):
            if ti == si:
                continue
            total = total + (-t * s).sum(dim=-1).mean()
            n_terms += 1
    loss = total / max(n_terms, 1)
    batch_center = torch.cat(teachers, dim=0).mean(dim=0, keepdim=True)
    new_center = state.center * center_momentum + (1 - center_momentum) * batch_center.detach()
    return loss, DINOCenterState(new_center)
