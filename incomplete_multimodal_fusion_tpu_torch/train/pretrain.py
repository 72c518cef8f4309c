"""The pretraining step (JAX package train/pretrain.py; reference
pretraining/pretrain_mmae.py:251-556).

One step: Dirichlet masks, the MultiMAE forward in the compute dtype over
f32 master weights, masked reconstruction losses weighted by the task
balancer plus the DINO-style contrastive term (``loss = sum(weighted task
losses) + contra_weight * contra``, pretrain_mmae.py:493-500), the backward
through the kernels' autograd Functions, a FlatAdamW update with per-step
cosine lr and wd, the balancer's own AdamW group, and the EMA shadow.

Mixed precision follows the JAX package's cast-the-whole-tree rule
(pretrain.py:99-104): every floating parameter is cast to the compute dtype
and the module runs on the cast copies through ``torch.func.functional_call``;
the gradients reach the f32 masters through the casts' backward. Targets stay
f32.

The step's device work never waits for the host: the masks are drawn on the
host before it, and the optimizers, balancer and EMA update their tensors in
place. ``make_multi_step`` captures that work once in a CUDA graph and
replays it K times, the counterpart of the JAX package's ``lax.scan``.
Not ported yet: parallelism and layer-wise LR decay.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.func import functional_call

from .. import modalities as modreg
from ..infer import as_input
from ..losses import LOSS_FNS, PATCH_LOSS_FNS, dino_loss, init_uncertainty_params, no_weighting
from ..losses import uncertainty_weighting
from ..models.multimae import MultiMAE, build_multimae
from ..ops import masking
from . import optim as optim_lib
from . import schedules
from .ema import init_ema, update_ema

BALANCERS = {"none": no_weighting, "uncertainty": uncertainty_weighting}


@dataclass
class TrainState:
    model: MultiMAE  # the f32 master weights; each step updates them in place
    optimizer: optim_lib.FlatAdamW
    step: int
    generator: torch.Generator  # host generator of the random masks
    # the uncertainty balancer's log-variances {task: 0-d f32} and their
    # AdamW group; empty and None without a balancer
    balancer_params: Dict[str, torch.Tensor] = field(default_factory=dict)
    balancer_optimizer: Optional[optim_lib.FlatAdamW] = None
    ema: Optional[Dict[str, torch.Tensor]] = None  # f32 shadow of the masters, with use_ema

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor a step updates in place."""
        out = [p for p in self.model.parameters()]
        for opt in (self.optimizer, self.balancer_optimizer):
            if opt is not None:
                out += list(opt.state_dict().values())
        out += list(self.balancer_params.values())
        out += list((self.ema or {}).values())
        return out

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)
        if self.balancer_optimizer is not None:
            self.balancer_optimizer.zero_grad(set_to_none=True)


def _balancer(cfg):
    if cfg.optim.task_balancer not in BALANCERS:
        raise ValueError(f"task_balancer must be one of {sorted(BALANCERS)}, got {cfg.optim.task_balancer!r}")
    return BALANCERS[cfg.optim.task_balancer]


def make_loss_fn(model: MultiMAE, cfg):
    """loss_fn(params, batch, mask_info, balancer_params=None) -> (loss,
    metrics), params a {name: tensor} dict of ``model``'s parameters and
    balancer_params the balancer's {task: log-variance} (pretrain.py:87-155)."""
    balancer = _balancer(cfg)
    in_domains = tuple(cfg.data.in_domains)
    out_domains = tuple(cfg.data.out_domains)
    e = cfg.mask.num_encoded_tokens
    compute_dtype = getattr(torch, cfg.train.compute_dtype)

    def loss_fn(params: Dict[str, torch.Tensor], batch, mask_info: masking.MaskInfo,
                balancer_params: Optional[Dict[str, torch.Tensor]] = None):
        cast_params = {k: v.to(compute_dtype) if v.is_floating_point() else v
                       for k, v in params.items()}
        cast_batch = {d: batch[d].to(compute_dtype) if batch[d].is_floating_point() else batch[d]
                      for d in in_domains}
        out = functional_call(model, cast_params, (cast_batch, mask_info, e))
        task_losses = {}
        for d in out_domains:
            spec = modreg.get(d)
            mask = None if cfg.train.loss_on_unmasked else mask_info.task_masks[d]
            if cfg.train.patch_space_losses and spec.loss in PATCH_LOSS_FNS:
                pred, fns = out["preds_patch"][d], PATCH_LOSS_FNS
            else:
                pred, fns = out["preds"][d], LOSS_FNS
            task_losses[d] = fns[spec.loss](pred, batch[d], mask, patch_size=cfg.data.patch_size,
                                            stride=spec.stride_level)
        # contrastive: fusion-stream pool at the modality's positions against
        # the modality-token pool (pretrain_mmae.py:488-493)
        pooled = out["pooled"].float()
        contra = sum(dino_loss(out["pooled_mod"][d], pooled[:, i]) for i, d in enumerate(in_domains))
        weighted = balancer(task_losses, balancer_params)
        loss = sum(weighted.values()) + cfg.train.contra_weight * contra
        metrics = {f"{d}_loss": task_losses[d] for d in out_domains}
        metrics.update(loss=loss, contra_loss=contra, recon_loss=sum(task_losses.values()))
        return loss, metrics

    return loss_fn


def make_train_step(model: MultiMAE, cfg, optimizer: optim_lib.FlatAdamW):
    """train_step(state, batch, mask_info=None) -> (state, metrics). The
    masks come from the state's generator unless ``mask_info`` is given. The
    step updates ``model``'s master weights, the optimizers, the balancer,
    the EMA and ``state.step`` in place; the metrics are 0-d tensors on the
    model's device, the loss terms and ``grad_norm`` (the raw global norm of
    the model's gradient).

    ``train_step.draw_masks(state, batch_size, device)`` draws one step's
    masks; ``train_step.device_step(state, batch, mask_info)`` is the step's
    device work, the gradients None on entry (what ``make_multi_step``
    captures)."""
    loss_fn = make_loss_fn(model, cfg)
    in_domains = tuple(cfg.data.in_domains)
    nums = tuple(cfg.data.num_patches for _ in in_domains)
    e = cfg.mask.num_encoded_tokens

    def draw_masks(state: TrainState, batch_size: int, device) -> masking.MaskInfo:
        return masking.generate_random_masks(
            state.generator, in_domains, nums, e, batch_size, alphas=cfg.mask.alphas,
            sample_tasks_uniformly=cfg.mask.sample_tasks_uniformly, device=device)

    def device_step(state: TrainState, batch, mask_info: masking.MaskInfo) -> Dict[str, torch.Tensor]:
        model.train()
        loss, metrics = loss_fn(dict(model.named_parameters()), batch, mask_info, state.balancer_params)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = optimizer.step()
        # the balancer's own AdamW group after the parameters, then the EMA
        # (pretrain.py:277-298)
        if state.balancer_optimizer is not None:
            state.balancer_optimizer.step()
        if state.ema is not None:
            update_ema(state.ema, dict(model.named_parameters()), cfg.train.ema_decay)
        return metrics

    def train_step(state: TrainState, batch, mask_info: Optional[masking.MaskInfo] = None):
        device = next(model.parameters()).device
        batch = {d: as_input(batch[d], device) for d in in_domains}
        if mask_info is None:
            mask_info = draw_masks(state, batch[in_domains[0]].shape[0], device)
        state.zero_grad()
        metrics = device_step(state, batch, mask_info)
        state.step += 1
        return state, metrics

    train_step.draw_masks = draw_masks
    train_step.device_step = device_step
    train_step.in_domains = in_domains
    return train_step


def _mask_leaves(mi: masking.MaskInfo) -> List[torch.Tensor]:
    return [*mi.task_masks.values(), mi.order, mi.ids_restore, mi.num_visible]


class _GraphedStep:
    """One step's device work captured in a CUDA graph, over static batch
    and mask buffers. Capturing leaves the state as it found it: a warm-up
    step on a side stream builds the kernels and sets their shared-memory
    limits, then the state's tensors are copied back in place."""

    def __init__(self, train_step, state: TrainState, batch, mask_info: masking.MaskInfo):
        self.state = state  # the graph reads and writes its tensors: keep them alive
        self.batch = {d: t.clone() for d, t in batch.items()}
        self.mask_info = masking.MaskInfo({d: t.clone() for d, t in mask_info.task_masks.items()},
                                          mask_info.order.clone(), mask_info.ids_restore.clone(),
                                          mask_info.num_visible.clone())
        tensors = state.tensors()
        saved = [t.detach().clone() for t in tensors]
        state.zero_grad()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            train_step.device_step(state, self.batch, self.mask_info)
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
        del saved
        # the gradients the capture allocates are the graph's static buffers:
        # each replay overwrites them, nothing zeroes them inside the graph
        state.zero_grad()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.metrics = train_step.device_step(state, self.batch, self.mask_info)

    def replay(self, batch, mask_info: masking.MaskInfo) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            for d, t in self.batch.items():
                t.copy_(batch[d], non_blocking=True)
            for dst, src in zip(_mask_leaves(self.mask_info), _mask_leaves(mask_info)):
                dst.copy_(src, non_blocking=True)
        self.graph.replay()
        return {k: v.clone() for k, v in self.metrics.items()}


def make_multi_step(train_step, k: int):
    """multi_step(state, batches, mask_infos=None) -> (state, metrics): K
    train steps, ``batches`` the K-stacked batch ({d: [K, B, ...]}), the
    metrics stacked [K]. The semantics are exactly K sequential
    ``train_step`` calls, the generator included (JAX pretrain.py:224-237).

    On the card the step's device work is captured once in a CUDA graph
    (the first call captures; a capture error raises) and replayed K times:
    before each group the K masks are drawn from the state's generator in
    order, then each step's batch and masks are copied into the graph's
    static buffers. On the CPU it is a loop of K ``train_step`` calls, the
    plain version. ``mask_infos`` (K of them) replaces the draws."""
    if k < 1:
        raise ValueError(f"make_multi_step: k must be >= 1, got {k}")
    graphs: Dict[Tuple, _GraphedStep] = {}

    def multi_step(state: TrainState, batches, mask_infos: Optional[List[masking.MaskInfo]] = None):
        device = next(state.model.parameters()).device
        domains = train_step.in_domains
        steps = [{d: as_input(batches[d][i], device) for d in domains} for i in range(k)]
        if mask_infos is not None and len(mask_infos) != k:
            raise ValueError(f"make_multi_step: {len(mask_infos)} mask infos for {k} steps")
        if device.type != "cuda":
            metrics = []
            for i in range(k):
                state, m = train_step(state, steps[i], None if mask_infos is None else mask_infos[i])
                metrics.append(m)
        else:
            b = steps[0][domains[0]].shape[0]
            if mask_infos is None:
                mask_infos = [train_step.draw_masks(state, b, device) for _ in range(k)]
            key = (id(state), tuple((d, tuple(steps[0][d].shape), steps[0][d].dtype) for d in domains))
            if key not in graphs:
                graphs[key] = _GraphedStep(train_step, state, steps[0], mask_infos[0])
            graph = graphs[key]
            metrics = [graph.replay(steps[i], mask_infos[i]) for i in range(k)]
            state.step += k
        return state, {name: torch.stack([m[name] for m in metrics]) for name in metrics[0]}

    return multi_step


def create_train_state(cfg, seed: int, total_steps: int, total_batch_size: Optional[int] = None,
                       device="cuda") -> Tuple[MultiMAE, TrainState, optim_lib.FlatAdamW]:
    """Model (initialized from ``seed`` on the CPU, then moved to
    ``device``), optimizer with the schedules of pretrain.py:240-270, the
    balancer and its AdamW group (lr = lr schedule * balancer_lr_scale, the
    wd schedule, no decay mask: the 0-d log-variances decay, as in
    ``optax.adamw``; pretrain.py:277-293), the EMA with ``use_ema``, and the
    train state. Returns (model, state, optimizer)."""
    _balancer(cfg)
    generator = torch.Generator().manual_seed(seed)
    model = build_multimae(cfg, device=device, generator=generator)
    device = next(model.parameters()).device
    total_batch = total_batch_size or cfg.data.batch_size
    steps_per_epoch = max(total_steps // max(cfg.train.epochs, 1), 1)
    lr_sched = schedules.cosine_scheduler(
        schedules.scaled_lr(cfg.optim.blr, total_batch), cfg.optim.min_lr, total_steps,
        warmup_steps=cfg.optim.warmup_epochs * steps_per_epoch,
        start_warmup_value=cfg.optim.warmup_lr)
    wd_end = (cfg.optim.weight_decay_end if cfg.optim.weight_decay_end is not None
              else cfg.optim.weight_decay)
    wd_sched = schedules.cosine_scheduler(cfg.optim.weight_decay, wd_end, total_steps)
    optimizer = optim_lib.create_optimizer(
        model.named_parameters(), lr_sched, wd_sched, betas=cfg.optim.opt_betas,
        eps=cfg.optim.opt_eps, clip_grad=cfg.optim.clip_grad, skip_grad=cfg.optim.skip_grad)
    state = TrainState(model, optimizer, 0, generator)
    if cfg.optim.task_balancer == "uncertainty":
        state.balancer_params = init_uncertainty_params(cfg.data.out_domains, device)
        state.balancer_optimizer = optim_lib.create_optimizer(
            state.balancer_params.items(), lr_sched.table(device) * cfg.optim.balancer_lr_scale, wd_sched,
            betas=cfg.optim.opt_betas, eps=cfg.optim.opt_eps,
            decay_mask={t: True for t in state.balancer_params})
    if cfg.train.use_ema:
        state.ema = init_ema(model.named_parameters())
    return model, state, optimizer
