"""The pretraining step (JAX package train/pretrain.py; reference
pretraining/pretrain_mmae.py:251-556).

One step: Dirichlet masks, the MultiMAE forward in the compute dtype over
f32 master weights, masked reconstruction losses plus the DINO-style
contrastive term (``loss = sum(task losses) + contra_weight * contra``,
pretrain_mmae.py:493-500), the backward through the kernels' autograd
Functions, and a FlatAdamW update with per-step cosine lr and wd.

Mixed precision follows the JAX package's cast-the-whole-tree rule
(pretrain.py:99-104): every floating parameter is cast to the compute dtype
and the module runs on the cast copies through ``torch.func.functional_call``;
the gradients reach the f32 masters through the casts' backward. Targets stay
f32. Not ported yet: EMA, the K-step scan (its counterpart is a CUDA graph),
the uncertainty balancer, checkpoints, the script and parallelism.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch.func import functional_call

from .. import modalities as modreg
from ..infer import as_input
from ..losses import LOSS_FNS, PATCH_LOSS_FNS, dino_loss, no_weighting
from ..models.multimae import MultiMAE, build_multimae
from ..ops import masking
from . import optim as optim_lib
from . import schedules


@dataclass
class TrainState:
    model: MultiMAE  # the f32 master weights; each step updates them in place
    optimizer: optim_lib.FlatAdamW
    step: int
    generator: torch.Generator  # host generator of the random masks


def _check_balancer(cfg) -> None:
    if cfg.optim.task_balancer != "none":
        raise NotImplementedError(f"task_balancer={cfg.optim.task_balancer!r} is not ported yet")


def make_loss_fn(model: MultiMAE, cfg):
    """loss_fn(params, batch, mask_info) -> (loss, metrics), params a
    {name: tensor} dict of ``model``'s parameters (pretrain.py:87-155)."""
    _check_balancer(cfg)
    in_domains = tuple(cfg.data.in_domains)
    out_domains = tuple(cfg.data.out_domains)
    e = cfg.mask.num_encoded_tokens
    compute_dtype = getattr(torch, cfg.train.compute_dtype)

    def loss_fn(params: Dict[str, torch.Tensor], batch, mask_info: masking.MaskInfo):
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
        loss = sum(no_weighting(task_losses).values()) + cfg.train.contra_weight * contra
        metrics = {f"{d}_loss": task_losses[d] for d in out_domains}
        metrics.update(loss=loss, contra_loss=contra, recon_loss=sum(task_losses.values()))
        return loss, metrics

    return loss_fn


def make_train_step(model: MultiMAE, cfg, optimizer: optim_lib.FlatAdamW):
    """train_step(state, batch, mask_info=None) -> (state, metrics). The
    masks come from the state's generator unless ``mask_info`` is given. The
    step updates ``model``'s master weights, the optimizer and
    ``state.step`` in place; the metrics are 0-d tensors on the card, the
    loss terms and ``grad_norm`` (the raw global gradient norm)."""
    loss_fn = make_loss_fn(model, cfg)
    in_domains = tuple(cfg.data.in_domains)
    nums = tuple(cfg.data.num_patches for _ in in_domains)
    e = cfg.mask.num_encoded_tokens

    def train_step(state: TrainState, batch, mask_info: Optional[masking.MaskInfo] = None):
        device = next(model.parameters()).device
        batch = {d: as_input(batch[d], device) for d in in_domains}
        if mask_info is None:
            mask_info = masking.generate_random_masks(
                state.generator, in_domains, nums, e, batch[in_domains[0]].shape[0],
                alphas=cfg.mask.alphas, sample_tasks_uniformly=cfg.mask.sample_tasks_uniformly,
                device=device)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(dict(model.named_parameters()), batch, mask_info)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = optimizer.step()
        state.step += 1
        return state, metrics

    return train_step


def create_train_state(cfg, seed: int, total_steps: int, total_batch_size: Optional[int] = None,
                       device="cuda") -> Tuple[MultiMAE, TrainState, optim_lib.FlatAdamW]:
    """Model (initialized from ``seed`` on the CPU, then moved to
    ``device``), optimizer with the schedules of pretrain.py:240-270, and the
    train state. Returns (model, state, optimizer)."""
    _check_balancer(cfg)
    generator = torch.Generator().manual_seed(seed)
    model = build_multimae(cfg, device=device, generator=generator)
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
    return model, TrainState(model, optimizer, 0, generator), optimizer
