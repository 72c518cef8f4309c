"""AdamW over one flat f32 moment vector (JAX package train/optim.py
``flat_adamw``, optim.py:116-204; reference pretraining/utils/optim_factory.py
and the NativeScaler semantics of utils/native_scaler.py:14-62).

bf16 training needs no loss scaler; what survives of NativeScaler is the
clip by the raw global gradient norm and the skip of the whole update
(parameters, moments and count) when that norm reaches ``skip_grad``.
Weight decay is decoupled and masked by the reference's no-decay rules
(optim_factory.py:49-72). Layer-wise LR decay (optim_factory.py:49-101,
JAX optim.py:67-104) scales each parameter's update by
``decay ** (num_layers + 1 - layer_id)``, the layer id read from the
parameter's flax path (``utils.jax_params.flax_path``).

``step()`` never waits for the host: the count lives on the device, the lr
and wd are read from f32 tables indexed by it, the skip is a select, and the
parameters, moments and count are updated in place. So a step captured in a
CUDA graph replays as a step (train/pretrain.py ``make_multi_step``).
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel import comm
from ..utils.jax_params import flax_path

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


def get_num_layer_for_vit(path: str, num_layers: int) -> int:
    """Layer id for layer-wise LR decay (optim_factory.py:49-64, JAX
    optim.py:67-80) from a flax path: the embeddings and input adapters 0,
    ``block{i}`` / ``fus_block{i}`` i + 1, everything else (decoders,
    norms, pools) num_layers + 1."""
    head = path.split("/")[0]
    if head.startswith(("input_adapter", "pos_emb", "fusion_tokens", "mask_embedding")):
        return 0
    if head.startswith(("block", "fus_block")):
        digits = "".join(c for c in head.split("block")[-1] if c.isdigit())
        return int(digits) + 1 if digits else num_layers + 1
    return num_layers + 1


def layer_decay_scales(named_params: Iterable[Tuple[str, torch.Tensor]], num_layers: int,
                       decay: float) -> Dict[str, float]:
    """{name: lr scale} (LayerDecayValueAssigner, optim_factory.py:66-101;
    JAX optim.py:83-92): ``decay ** (num_layers + 1 - layer_id)``, the layer
    id of the parameter's flax path."""
    return {name: decay ** (num_layers + 1 - get_num_layer_for_vit(flax_path(name), num_layers))
            for name, _ in named_params}


def scale_by_layer_decay(updates: Mapping[str, torch.Tensor], scales: Mapping[str, float]) -> Dict[str, torch.Tensor]:
    """Each update times its parameter's lr scale (JAX optim.py:95-104, the
    optax chain's last transform; ``FlatAdamW`` applies the same scales to
    its flat update)."""
    return {name: u * scales[name] for name, u in updates.items()}


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
    ``lr_scales``: {name: lr scale} (``layer_decay_scales``), one f32 entry
    a parameter element multiplying the update after the weight decay, as
    ``flat_adamw``'s ``ld_vec`` (JAX optim.py:160-163, :192-193).
    ``step()`` updates the parameters in place and returns the raw gradient
    norm (a 0-d tensor on the parameters' device).

    Parallel training (``layout``, parallel/mesh.py): the flat gradient is
    summed over the data ranks once a step (each rank's is its rows' part of
    the global loss's); with ``layout.fsdp`` (ZeRO) it is reduce-scattered
    instead, and the moments and the update cover this rank's 1/dp slice of
    the flat vector (padded to a multiple of dp, as the JAX moment vectors
    are for FSDP), the updated slices all-gathered back into the
    parameters. ``norm_weights`` {name: w}: the share of a parameter's
    squared gradient this rank counts in the norm, 1 where it holds its own
    shard (tensor-parallel shards, its pipeline stage's layers), 1 / size
    where the model or stage group holds it replicated; the weighted sums
    are all-reduced over that group, so the norm is the global gradient's.
    """

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]], lr_schedule, wd_schedule, *,
                 betas=(0.9, 0.95), eps: float = 1e-8, clip_grad: Optional[float] = None,
                 skip_grad: Optional[float] = None, decay_mask: Optional[Mapping[str, bool]] = None,
                 lr_scales: Optional[Mapping[str, float]] = None, layout=None,
                 norm_weights: Optional[Mapping[str, float]] = None):
        named = list(named_params)
        params = [p for _, p in named]
        super().__init__(params, dict(betas=tuple(betas), eps=eps))
        self.names = [name for name, _ in named]
        self.clip_grad, self.skip_grad = clip_grad, skip_grad
        self.data_group = None if layout is None else layout.data_group
        self.zero = layout is not None and layout.fsdp and self.data_group is not None
        mask = wd_mask(named) if decay_mask is None else decay_mask
        device = params[0].device
        self.numel = sum(p.numel() for p in params)
        dp = layout.dp if self.zero else 1
        self.pad = -self.numel % dp
        self.lo = (layout.dp_rank if self.zero else 0) * ((self.numel + self.pad) // dp)
        self.hi = self.lo + (self.numel + self.pad) // dp

        def flat(value_of, dtype):
            """One entry a parameter element (this rank's slice), padding 0."""
            v = torch.cat([torch.full((p.numel(),), value_of(name), dtype=dtype) for name, p in named])
            return self._local(v).to(device)

        self.decay = flat(lambda n: bool(mask[n]), torch.bool)
        self.lr_scale = None if lr_scales is None else flat(lambda n: float(lr_scales[n]), torch.float32)
        self.norm_weight = None
        self.norm_group = None
        if norm_weights is not None and any(w != 1.0 for w in norm_weights.values()):
            self.norm_weight = flat(lambda n: float(norm_weights[n]), torch.float32)
            self.norm_group = layout.model_group if layout.model_group is not None else layout.stage_group
        self.lr_table, self.wd_table = _table(lr_schedule, device), _table(wd_schedule, device)
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.mu = torch.zeros(self.hi - self.lo, dtype=torch.float32, device=device)
        self.nu = torch.zeros_like(self.mu)

    def _at_count(self, table: torch.Tensor) -> torch.Tensor:
        """table[count] as a [1] tensor, by a device gather (no host read)."""
        return table.index_select(0, self.count.clamp(max=table.numel() - 1).view(1))

    def _local(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a flat vector (all of it without ZeRO)."""
        return F.pad(v, (0, self.pad))[self.lo:self.hi] if self.zero else v

    @torch.no_grad()
    def step(self, closure=None) -> torch.Tensor:
        params = self.param_groups[0]["params"]
        b1, b2 = self.defaults["betas"]
        g = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float()
                       for p in params])
        flat = self._local(torch.cat([p.reshape(-1).float() for p in params]))
        if self.zero:
            g = comm.reduce_scatter_flat(F.pad(g, (0, self.pad)), self.data_group)
        elif self.data_group is not None:
            comm.all_reduce_(g, self.data_group)
        sq = g.square()
        sq = (sq if self.norm_weight is None else sq * self.norm_weight).sum()
        if self.zero:
            comm.all_reduce_(sq, self.data_group)
        if self.norm_group is not None:
            comm.all_reduce_(sq, self.norm_group)
        gnorm = sq.sqrt()
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
        if self.lr_scale is not None:
            upd = upd * self.lr_scale
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
        if self.zero:
            new = comm.all_gather_flat(new, self.data_group)[:self.numel]
        torch._foreach_copy_(params, [v.view_as(p) for v, p in zip(new.split([p.numel() for p in params]),
                                                                   params)])
        return gnorm

    def buffers(self):
        """The tensors ``step()`` updates in place besides the parameters."""
        return [self.count, self.mu, self.nu]

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """count, mu and nu over the whole flat vector of this rank's
        parameters (under ZeRO the slices all-gathered: a collective, every
        data rank calls it)."""
        if not self.zero:
            return {"count": self.count, "mu": self.mu, "nu": self.nu}
        return {"count": self.count, "mu": comm.all_gather_flat(self.mu, self.data_group)[:self.numel],
                "nu": comm.all_gather_flat(self.nu, self.data_group)[:self.numel]}

    def load_state_dict(self, state: Mapping[str, torch.Tensor]) -> None:
        """Copies count, mu and nu in place (a captured graph keeps reading
        the same tensors); under ZeRO this rank's slice of them."""
        self.count.copy_(state["count"])
        for key in ("mu", "nu"):
            getattr(self, key).copy_(self._local(state[key].to(self.mu.device)))


def create_optimizer(named_params, lr_schedule, wd_schedule, *, betas=(0.9, 0.95), eps: float = 1e-8,
                     clip_grad: Optional[float] = None, skip_grad: Optional[float] = None,
                     decay_mask: Optional[Mapping[str, bool]] = None, layer_decay: Optional[float] = None,
                     num_layers: int = 12, layout=None,
                     norm_weights: Optional[Mapping[str, float]] = None) -> FlatAdamW:
    """The pretraining optimizer. The JAX package's two forms
    (``fused_adamw`` True or False) give the same update
    (tests/test_optim_fused.py), so the port has only the flat one; both
    forms' layer-wise LR decay (JAX optim.py:157-163 fused, :216-248 chain)
    are its ``lr_scales``, taken for ``layer_decay`` < 1."""
    named = list(named_params)
    scales = (layer_decay_scales(named, num_layers, layer_decay)
              if layer_decay is not None and layer_decay < 1.0 else None)
    return FlatAdamW(named, lr_schedule, wd_schedule, betas=betas, eps=eps, clip_grad=clip_grad,
                     skip_grad=skip_grad, decay_mask=decay_mask, lr_scales=scales, layout=layout,
                     norm_weights=norm_weights)
