"""AdamW over one flat f32 moment vector (JAX package train/optim.py
``flat_adamw``, optim.py:116-204; reference pretraining/utils/optim_factory.py
and the NativeScaler semantics of utils/native_scaler.py:14-62).

bf16 training needs no loss scaler; what survives of NativeScaler is the
clip by the raw global gradient norm and the skip of the whole update
(parameters, moments and count) when that norm reaches ``skip_grad``.
Weight decay is decoupled and masked by the reference's no-decay rules
(optim_factory.py:49-72). Layer-wise LR decay is not ported: pretraining
does not use it.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

NO_DECAY_NAMES = (
    "pos_emb",
    "class_emb",
    "fusion_tokens",
    "return_tokens",
    "return_token_",
    "mask_embedding",
    "task_emb",
    "gamma",
    "beta",
)


def wd_mask(named_params: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, bool]:
    """{name: True where weight decay applies}: not for tensors of ndim <= 1
    and not for the token / embedding parameters named in NO_DECAY_NAMES."""
    return {name: p.dim() > 1 and not any(nd in name for nd in NO_DECAY_NAMES)
            for name, p in named_params}


class FlatAdamW(torch.optim.Optimizer):
    """AdamW whose moments are one flat f32 vector each, with the semantics
    of ``flat_adamw``: the raw gradient norm feeds the clip and the skip
    guard; bias correction; decoupled weight decay under ``wd_mask``; the lr
    and wd schedules evaluated at the count before the increment.

    ``step()`` updates the parameters in place and returns the raw gradient
    norm (a 0-d tensor on the parameters' device)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 lr_schedule: Callable[[int], float], wd_schedule: Callable[[int], float], *,
                 betas=(0.9, 0.95), eps: float = 1e-8, clip_grad: Optional[float] = None,
                 skip_grad: Optional[float] = None):
        named = list(named_params)
        params = [p for _, p in named]
        super().__init__(params, dict(betas=tuple(betas), eps=eps))
        self.lr_schedule, self.wd_schedule = lr_schedule, wd_schedule
        self.clip_grad, self.skip_grad = clip_grad, skip_grad
        mask = wd_mask(named)
        device = params[0].device
        self.decay = torch.cat([torch.full((p.numel(),), mask[name]) for name, p in named]).to(device)
        self.count = 0
        self.mu = torch.zeros(self.decay.numel(), dtype=torch.float32, device=device)
        self.nu = torch.zeros_like(self.mu)

    @torch.no_grad()
    def step(self, closure=None) -> torch.Tensor:
        params = self.param_groups[0]["params"]
        b1, b2 = self.defaults["betas"]
        g = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float()
                       for p in params])
        flat = torch.cat([p.reshape(-1).float() for p in params])
        gnorm = g.square().sum().sqrt()
        if self.clip_grad is not None:
            g = g * torch.where(gnorm > self.clip_grad, self.clip_grad / gnorm, torch.ones_like(gnorm))
        if self.skip_grad is not None and bool(gnorm >= self.skip_grad):
            return gnorm
        count = self.count + 1
        mu = b1 * self.mu + (1.0 - b1) * g
        nu = b2 * self.nu + (1.0 - b2) * (g * g)
        mu_hat = mu / (1.0 - b1 ** count)
        nu_hat = nu / (1.0 - b2 ** count)
        wd = self.wd_schedule(self.count) * self.decay
        upd = -self.lr_schedule(self.count) * (mu_hat / (nu_hat.sqrt() + self.defaults["eps"]) + wd * flat)
        self.mu, self.nu, self.count = mu, nu, count
        torch._foreach_add_(params, [u.view_as(p) for u, p in zip(upd.split([p.numel() for p in params]),
                                                                     params)])
        return gnorm


def create_optimizer(named_params, lr_schedule, wd_schedule, *, betas=(0.9, 0.95), eps: float = 1e-8,
                     clip_grad: Optional[float] = None,
                     skip_grad: Optional[float] = None) -> FlatAdamW:
    """The pretraining optimizer. The JAX package's two forms
    (``fused_adamw`` True or False) give the same update
    (tests/test_optim_fused.py), so the port has only the flat one."""
    return FlatAdamW(named_params, lr_schedule, wd_schedule, betas=betas, eps=eps,
                     clip_grad=clip_grad, skip_grad=skip_grad)
