"""AdamW over one flat f32 moment vector (JAX package train/optim.py
``flat_adamw``, optim.py:116-204; reference pretraining/utils/optim_factory.py
and the NativeScaler semantics of utils/native_scaler.py:14-62).

bf16 training needs no loss scaler; what survives of NativeScaler is the
clip by the raw global gradient norm and the skip of the whole update
(parameters, moments and count) when that norm reaches ``skip_grad``.
Weight decay is decoupled and masked by the reference's no-decay rules
(optim_factory.py:49-72). Layer-wise LR decay is not ported: pretraining
does not use it.

``step()`` never waits for the host: the count lives on the device, the lr
and wd are read from f32 tables indexed by it, the skip is a select, and the
parameters, moments and count are updated in place. So a step captured in a
CUDA graph replays as a step (train/pretrain.py ``make_multi_step``).
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Tuple

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


def _table(schedule, device) -> torch.Tensor:
    """A schedule as its f32 device table: a tensor as it is, else the
    schedule's own ``table`` (train/schedules.py)."""
    if isinstance(schedule, torch.Tensor):
        return schedule.to(device=device, dtype=torch.float32)
    return schedule.table(device)


class FlatAdamW(torch.optim.Optimizer):
    """AdamW whose moments are one flat f32 vector each, with the semantics
    of ``flat_adamw``: the raw gradient norm feeds the clip and the skip
    guard; bias correction from the count in f32; decoupled weight decay
    under ``decay_mask`` (default ``wd_mask``); the lr and wd schedules read
    at the count before the increment.

    ``lr_schedule`` / ``wd_schedule``: a schedule of train/schedules.py or
    an f32 table (entry i serves step i, the last entry every later step).
    ``step()`` updates the parameters in place and returns the raw gradient
    norm (a 0-d tensor on the parameters' device)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]], lr_schedule, wd_schedule, *,
                 betas=(0.9, 0.95), eps: float = 1e-8, clip_grad: Optional[float] = None,
                 skip_grad: Optional[float] = None, decay_mask: Optional[Mapping[str, bool]] = None):
        named = list(named_params)
        params = [p for _, p in named]
        super().__init__(params, dict(betas=tuple(betas), eps=eps))
        self.clip_grad, self.skip_grad = clip_grad, skip_grad
        mask = wd_mask(named) if decay_mask is None else decay_mask
        device = params[0].device
        self.decay = torch.cat([torch.full((p.numel(),), bool(mask[name])) for name, p in named]).to(device)
        self.lr_table, self.wd_table = _table(lr_schedule, device), _table(wd_schedule, device)
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.mu = torch.zeros(self.decay.numel(), dtype=torch.float32, device=device)
        self.nu = torch.zeros_like(self.mu)

    def _at_count(self, table: torch.Tensor) -> torch.Tensor:
        """table[count] as a [1] tensor, by a device gather (no host read)."""
        return table.index_select(0, self.count.clamp(max=table.numel() - 1).view(1))

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
        count = self.count + 1
        mu = b1 * self.mu + (1.0 - b1) * g
        nu = b2 * self.nu + (1.0 - b2) * (g * g)
        cf = count.float()
        mu_hat = mu / (1.0 - b1 ** cf)
        nu_hat = nu / (1.0 - b2 ** cf)
        wd = self._at_count(self.wd_table) * self.decay
        upd = -self._at_count(self.lr_table) * (mu_hat / (nu_hat.sqrt() + self.defaults["eps"]) + wd * flat)
        new = flat + upd
        if self.skip_grad is not None:
            skip = gnorm >= self.skip_grad
            new = torch.where(skip, flat, new)
            mu = torch.where(skip, self.mu, mu)
            nu = torch.where(skip, self.nu, nu)
            count = torch.where(skip, self.count, count)
        self.mu.copy_(mu)
        self.nu.copy_(nu)
        self.count.copy_(count)
        torch._foreach_copy_(params, [v.view_as(p) for v, p in zip(new.split([p.numel() for p in params]),
                                                                   params)])
        return gnorm

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: Mapping[str, torch.Tensor]) -> None:
        """Copies count, mu and nu in place (a captured graph keeps reading
        the same tensors)."""
        for key in ("count", "mu", "nu"):
            getattr(self, key).copy_(state[key])


def create_optimizer(named_params, lr_schedule, wd_schedule, *, betas=(0.9, 0.95), eps: float = 1e-8,
                     clip_grad: Optional[float] = None, skip_grad: Optional[float] = None,
                     decay_mask: Optional[Mapping[str, bool]] = None) -> FlatAdamW:
    """The pretraining optimizer. The JAX package's two forms
    (``fused_adamw`` True or False) give the same update
    (tests/test_optim_fused.py), so the port has only the flat one."""
    return FlatAdamW(named_params, lr_schedule, wd_schedule, betas=betas, eps=eps,
                     clip_grad=clip_grad, skip_grad=skip_grad, decay_mask=decay_mask)
