"""The downstream segmentation training step (JAX package train/downstream.py;
reference downstream/instance_segmentation/maskformer_train_ins_vit.py).

One step: a random modality subset and keep-ratio masks -> the MaskFormer
forward in the compute dtype over f32 master weights (dropout on) -> the set
criterion with deep supervision (point-sampled mask losses, or with
``dense_masks`` the semantic flows' whole-mask ones), Hungarian matching
(exact on the host by default; 'greedy' or 'auction' on the device) ->
``0.3 * ce + 0.3 * dice + 0.4 * mask`` of the weighted terms (:228) ->
the backward through the kernels' autograd Functions -> the global-norm clip
over every gradient, frozen ones included, then AdamW on the trainable
parameters only (optax's chain clip -> adamw -> zero the frozen updates,
downstream.py:66-89).

Mixed precision follows the JAX package's cast-the-whole-tree rule
(downstream.py:193-201): every floating parameter is cast to the compute
dtype and the model runs on the cast copies through
``torch.func.functional_call``; the head's layers then compute in the dtype
flax's promotion gives (``models.layers.Dense``). Randomness: the state's
host generator draws each step's modality subset, masks, dropout seed and
criterion key (``losses.set_criterion``), in that order; ``cost_step`` draws
the same without advancing the state, as the JAX prologue does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..eval.metrics import binary_mask_from_labels, dice_score, semantic_inference
from ..infer import as_input
from ..infer_segmentation import segmentation_outputs
from ..losses.set_criterion import MATCH_MODES, SegTargets, set_criterion, set_criterion_costs
from ..models.layers import set_dropout_share
from ..models.maskformer import MaskFormerConfig, MaskFormerModel
from ..ops import masking
from ..ops.resize import resize_bilinear
from ..parallel import comm
from ..parallel.mesh import Layout, shard_rows
from ..utils import checkpoint as ckpt_lib

# _freeze_stages (multimae_big_imcomplete.py:682-730): the input adapters,
# the fusion tokens and the fusion blocks; encoder blocks 1..frozen_stages
FROZEN_PREFIXES_BACKBONE = (
    "backbone.input_adapters.",
    "backbone.fusion_tokens",
    "backbone.fus_blocks.",
)
ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default, no mask


def freeze_mask(model, frozen_stages: int) -> Dict[str, bool]:
    """{parameter name: True if trainable} (downstream.py:45-63) on the
    port's names, which follow the flax tree. ``model``: a module or
    (name, tensor) pairs. The rule holds for every backbone: the 'sup'
    backbone freezes its input adapters and blocks 1..frozen_stages; the
    ViT-Adapter's prior module, injectors, extractors and ``adapter_*``
    stay trainable, and so do the ResNet and Swin backbones whole."""
    named = model.named_parameters() if isinstance(model, torch.nn.Module) else model

    def trainable(name: str) -> bool:
        if any(name.startswith(f) for f in FROZEN_PREFIXES_BACKBONE):
            return False
        if name.startswith("backbone.blocks."):
            return not 1 <= int(name.split(".")[2]) <= frozen_stages
        return True

    return {name: trainable(name) for name, _ in named}


class DownstreamOptimizer:
    """optax.chain(clip_by_global_norm(clip_grad), adamw(lr) or sgd(lr, 0.9),
    masked(set_to_zero, frozen)): the clip's norm runs over every gradient,
    frozen parameters' included; only the trainable parameters are updated,
    by ``torch.optim.AdamW`` (optax.adamw's defaults: b1 0.9, b2 0.999,
    eps 1e-8, weight decay 1e-4 on every parameter) or SGD with momentum 0.9.
    ``step()`` returns the raw global gradient norm, a 0-d tensor. With a
    ``data_group`` (data parallelism) the gradients, each rank's part of the
    global loss's, are summed over the ranks in one flat all-reduce first."""

    def __init__(self, named_params, lr: float, clip_grad: Optional[float],
                 trainable: Mapping[str, bool], optimizer: str = "adamw", data_group=None):
        named = list(named_params)
        self.params = [p for _, p in named]
        self.trainable = [p for n, p in named if trainable[n]]
        self.clip_grad = clip_grad
        self.data_group = data_group
        if optimizer == "adamw":
            self.inner = torch.optim.AdamW(self.trainable, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=ADAMW_WEIGHT_DECAY)
        elif optimizer == "sgd":
            self.inner = torch.optim.SGD(self.trainable, lr=lr, momentum=0.9)
        else:
            raise ValueError(f"optimizer must be 'adamw' or 'sgd', got {optimizer!r}")

    @property
    def lr(self) -> float:
        return self.inner.param_groups[0]["lr"]

    def state_dict(self) -> Dict:
        """AdamW's moments and step counts (or SGD's momenta) and the current
        lr, which ReduceLROnPlateau may have cut."""
        return self.inner.state_dict()

    def load_state_dict(self, state: Dict) -> None:
        self.inner.load_state_dict(state)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.data_group is not None:
            flat = comm.all_reduce_(torch.cat([g.reshape(-1) for g in grads]), self.data_group)
            torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(flat.split([g.numel() for g in grads]),
                                                                       grads)])
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.clip_grad:
            # optax: g where the norm is below the limit, else g / norm * limit
            scale = torch.where(gnorm < self.clip_grad, torch.ones_like(gnorm), self.clip_grad / gnorm)
            live = [p.grad for p in self.trainable if p.grad is not None]
            if live:
                torch._foreach_mul_(live, scale)
        self.inner.step()
        return gnorm


def create_downstream_optimizer(model: torch.nn.Module, lr: float = 1e-4, clip_grad: float = 0.01,
                                frozen_stages: int = 0, optimizer: str = "adamw",
                                layout: Optional[Layout] = None) -> DownstreamOptimizer:
    """The downstream optimizer of ``model``'s parameters
    (downstream.py:66-89); with ``frozen_stages`` 0 nothing is frozen, as
    JAX masks the updates only above 0 (:86). A ``layout``'s data ranks sum
    their gradients."""
    trainable = freeze_mask(model, frozen_stages) if frozen_stages > 0 else \
        {name: True for name, _ in model.named_parameters()}
    return DownstreamOptimizer(model.named_parameters(), lr, clip_grad, trainable, optimizer,
                               None if layout is None else layout.data_group)


def set_learning_rate(optimizer: DownstreamOptimizer, lr: float) -> DownstreamOptimizer:
    """Host-side LR override; ReduceLROnPlateau applies through it."""
    for group in optimizer.inner.param_groups:
        group["lr"] = float(lr)
    return optimizer


class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau's 'min' semantics on a
    plain learning rate (maskformer_train_ins_vit.py:155)."""

    def __init__(self, lr: float, factor: float = 0.1, patience: int = 10, mode: str = "min",
                 min_lr: float = 0.0):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.sign = 1.0 if mode == "min" else -1.0
        self.best = float("inf")
        self.bad_epochs = 0
        self.min_lr = min_lr

    def step(self, metric: float) -> float:
        v = self.sign * metric
        if v < self.best - 1e-12:
            self.best = v
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr


def load_pretrained_backbone(model: MaskFormerModel, pretrain_params) -> Dict[str, list]:
    """Copy the pretraining MultiMAE's parameters that the backbone shares
    (same name, same shape) into ``model.backbone``, non-strict
    (checkpoint.py:26-72), whatever the backbone (the ResNet and Swin ones
    share none). ``pretrain_params``: a module or a state dict.
    Returns {'copied', 'missing_in_ckpt', 'unused_from_ckpt'} lists of
    names."""
    if isinstance(pretrain_params, torch.nn.Module):
        pretrain_params = pretrain_params.state_dict()
    own = model.backbone.state_dict()
    copied, missing = [], []
    with torch.no_grad():
        for name, t in own.items():
            src = pretrain_params.get(name)
            if src is not None and tuple(src.shape) == tuple(t.shape):
                t.copy_(torch.as_tensor(src))
                copied.append(name)
            else:
                missing.append(name)
    unused = [n for n in pretrain_params if n not in own]
    return {"copied": copied, "missing_in_ckpt": missing, "unused_from_ckpt": unused}


@dataclass
class DownstreamState:
    model: MaskFormerModel  # the f32 master weights; each step updates them in place
    optimizer: DownstreamOptimizer
    generator: torch.Generator  # host generator of the per-step draws
    step: int = 0

    def checkpoint_payload(self) -> Dict:
        """This state's checkpoint content (utils/checkpoint.py): the core
        alone."""
        return ckpt_lib.core_payload(self, "downstream")

    def restore_payload(self, saved: Dict) -> None:
        """Puts ``checkpoint_payload``'s content back in place."""
        ckpt_lib.restore_core(self, saved, "downstream")


def as_targets(targets: SegTargets, device) -> SegTargets:
    """Targets (numpy arrays or tensors) on ``device``."""
    return SegTargets(*(as_input(np.asarray(t) if not isinstance(t, torch.Tensor) else t, device)
                        for t in targets))


def _f32(tree):
    if isinstance(tree, torch.Tensor):
        return tree.float()
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return [_f32(v) for v in tree]


def make_downstream_train_step(
    model: MaskFormerModel,
    cfg: MaskFormerConfig,
    optimizer: DownstreamOptimizer,
    loss_weights: Tuple[float, float, float] = (0.3, 0.3, 0.4),  # ce, dice, mask
    num_points: int = 12544,
    eos_coef: float = 0.1,
    dense_masks: bool = False,
    compute_dtype: str = "bfloat16",
    match_mode: Optional[str] = None,
    # per-loss weights, also the matching costs unless given
    # (maskformer_ake150.yaml: CLASS 2.0, MASK 5.0, DICE 5.0)
    class_weight: float = 2.0,
    dice_weight: float = 5.0,
    mask_weight: float = 5.0,
    per_sample_masks: bool = False,
    cost_class: Optional[float] = None,
    cost_mask: Optional[float] = None,
    cost_dice: Optional[float] = None,
    layout: Optional[Layout] = None,
):
    """``train_step(state, batch, targets, matched_override=None)`` ->
    (state, metrics). The step updates the model's master weights, the
    optimizer and ``state`` in place; the metrics are 0-d tensors: ``loss``,
    the weighted ``loss_ce`` / ``loss_dice`` / ``loss_mask`` and
    ``grad_norm``. Keyword-only arguments of the step inject what a test
    holds fixed: ``mask_info`` and ``present``, ``point_coords_override``
    [L, B*G, P, 2], and ``deterministic`` (dropout off).

    ``train_step.cost_step(state, batch, targets)`` gives the per-level
    matching costs [L, B, Q, G] of the step the state would take next;
    ``train_step.loss_fn`` is the loss of given parameters, masks and key.

    ``dense_masks`` (the semantic flows) takes the mask losses over the
    whole masks; ``match_mode`` 'exact' (the default: scipy on the host),
    'greedy' or 'auction' (on the device), as downstream.py:164-209.

    Data parallelism (``layout``, scripts/train_downstream.py:249-274): the
    batch and targets are this rank's rows of the global batch; the masks
    and the random points are the global draws' rows of it, each rank
    matches its own rows, the criterion's normalisers (``num_masks``, the
    class weights) are summed over the ranks, every rank seeds dropout
    alike and keeps its rows of the global batch's mask
    (``models.layers.Dropout``), and the optimizer
    (``create_downstream_optimizer(..., layout=)``) sums the gradients once
    a step. An injected ``mask_info`` or ``point_coords_override`` is this
    rank's rows."""
    if (match_mode or "exact") not in MATCH_MODES:
        raise ValueError(f"match_mode must be one of {MATCH_MODES}, got {match_mode!r}")
    w_ce, w_dice, w_mask = loss_weights
    dtype = getattr(torch, compute_dtype)
    in_domains = tuple(cfg.in_domains)
    nums = (cfg.num_patches,) * len(in_domains)
    e = cfg.max_encoded_tokens
    dp, dp_rank = (1, 0) if layout is None else (layout.dp, layout.dp_rank)
    batch_sum = comm.batch_sum(None if layout is None else layout.data_group)
    share = None if layout is None else (dp_rank, dp)
    set_dropout_share(model, share)
    costs = dict(cost_class=class_weight if cost_class is None else cost_class,
                 cost_mask=mask_weight if cost_mask is None else cost_mask,
                 cost_dice=dice_weight if cost_dice is None else cost_dice)

    def forward(params, batch, mask_info, present, dropout_seed):
        """The model's outputs in f32, computed on ``dtype`` copies of
        ``params``; dropout on with ``dropout_seed`` (from it), else off."""
        cast_params = {k: v.to(dtype) if v.is_floating_point() else v for k, v in params.items()}
        cast_batch = {d: batch[d].to(dtype) if batch[d].is_floating_point() else batch[d] for d in in_domains}
        model.train(dropout_seed is not None)
        kwargs = dict(mask_info=mask_info, num_encoded_tokens=e, present=present)
        if dropout_seed is None:
            out = functional_call(model, cast_params, (cast_batch,), kwargs)
        else:
            device = cast_batch[in_domains[0]].device
            with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
                torch.manual_seed(dropout_seed)
                out = functional_call(model, cast_params, (cast_batch,), kwargs)
        return _f32(out)

    def impl():
        return "xla" if model.attn_impl == "xla" else "auto"

    def loss_fn(params: Dict[str, torch.Tensor], batch, targets: SegTargets,
                mask_info: masking.MaskInfo, present: torch.Tensor, key: int,
                dropout_seed: Optional[int] = None, matched_override=None,
                point_coords_override=None, return_aux: bool = False):
        """(loss, metrics), with ``return_aux`` also the criterion's
        {'matched', 'point_coords'} (downstream.py:198-223)."""
        out = forward(params, batch, mask_info, present, dropout_seed)
        losses = set_criterion(
            out, targets, key, num_classes=cfg.num_classes, eos_coef=eos_coef,
            num_points=num_points, **costs, dense_masks=dense_masks, match_mode=match_mode,
            matched_override=matched_override, point_coords_override=point_coords_override, impl=impl(),
            return_aux=return_aux, batch_sum=batch_sum, share=share)
        if return_aux:
            losses, aux = losses
        # partition by exact key prefix; substring tests would double-count
        l_ce = class_weight * sum(v for k, v in losses.items() if k.startswith("loss_ce"))
        l_dice = dice_weight * sum(v for k, v in losses.items() if k.startswith("loss_dice"))
        l_mask = mask_weight * sum(v for k, v in losses.items() if k.startswith("loss_mask"))
        total = w_ce * l_ce + w_dice * l_dice + w_mask * l_mask  # (:228)
        metrics = {"loss": total, "loss_ce": l_ce, "loss_dice": l_dice, "loss_mask": l_mask}
        return (total, metrics, aux) if return_aux else (total, metrics)

    def prologue(state: DownstreamState, batch):
        """This step's draws from a copy of the state's generator: the
        modality subset, the masks, the dropout seed and the criterion key;
        returns them with the advanced copy."""
        g = torch.Generator()
        g.set_state(state.generator.get_state())
        device = batch[in_domains[0]].device
        present = masking.sample_modality_subset(g, len(in_domains))
        b = batch[in_domains[0]].shape[0]
        mask_info = masking.incomplete_random_masks(
            g, in_domains, nums, present, e, b * dp,
            keep_ratio=cfg.keep_ratio, batch_shared=not per_sample_masks, device=device)
        if layout is not None:  # the global batch's masks, this rank's rows
            mask_info = shard_rows(mask_info, layout.rows(b * dp))
        dropout_seed = int(torch.randint(2 ** 62, (), generator=g))
        key = int(torch.randint(2 ** 62, (), generator=g))
        return g, present.to(device), mask_info, dropout_seed, key

    def inputs(batch, targets):
        device = next(model.parameters()).device
        return {d: as_input(batch[d], device) for d in in_domains}, as_targets(targets, device)

    def train_step(state: DownstreamState, batch, targets: SegTargets, matched_override=None, *,
                   mask_info: Optional[masking.MaskInfo] = None, present: Optional[torch.Tensor] = None,
                   point_coords_override=None, deterministic: bool = False):
        batch, targets = inputs(batch, targets)
        g, drawn_present, drawn_masks, dropout_seed, key = prologue(state, batch)
        optimizer.zero_grad()
        loss, metrics = loss_fn(
            dict(model.named_parameters()), batch, targets,
            drawn_masks if mask_info is None else mask_info,
            drawn_present if present is None else present.to(drawn_present.device), key,
            None if deterministic else dropout_seed, matched_override, point_coords_override)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = optimizer.step()
        state.generator = g
        state.step += 1
        return state, metrics

    def cost_step(state: DownstreamState, batch, targets: SegTargets) -> torch.Tensor:
        """The per-level matching costs [L, B, Q, G] of the next step's
        forward (same masks, dropout and key), without advancing the state
        (downstream.py:250-265)."""
        batch, targets = inputs(batch, targets)
        _, present, mask_info, dropout_seed, key = prologue(state, batch)
        with torch.no_grad():
            out = forward(dict(model.named_parameters()), batch, mask_info, present, dropout_seed)
            return set_criterion_costs(out, targets, key, num_points=num_points, **costs, impl=impl(), share=share)

    train_step.cost_step = cost_step
    train_step.loss_fn = loss_fn
    return train_step


def make_downstream_hostmatch_step(model, cfg, optimizer, **kw):
    """Exact scipy matching without an in-graph host callback. The JAX
    package splits its jitted step for that (a cost phase, scipy on the
    host, a gradient phase with ``matched_override``); in eager PyTorch the
    exact step already computes the costs of all levels, copies them to the
    host once and runs scipy there, so this is ``make_downstream_train_step``
    with ``match_mode='exact'``."""
    kw.pop("match_mode", None)
    return make_downstream_train_step(model, cfg, optimizer, match_mode="exact", **kw)


def label_map_from_targets(targets: SegTargets) -> torch.Tensor:
    """[B, H, W] int32 label map from padded instance targets: a pixel takes
    the label + 1 of the mask covering it (0 = background), the largest
    where they overlap (maskformer_train_ins_vit.py:279)."""
    labels = torch.where(targets.valid, targets.labels + 1, torch.zeros_like(targets.labels))
    per_inst = targets.masks * labels[:, :, None, None]
    return per_inst.amax(dim=1).to(torch.int32)


def make_semantic_pred_step(model: MaskFormerModel, cfg: MaskFormerConfig, out_size: int = 0):
    """``pred_step(params, batch)`` -> [B, S, S] per-pixel labels for the
    ConfMatrix evaluation: argmax + 1 of the class probabilities
    (maskformer_train_seg.py:242-285). ``params``: None (the model's own
    weights), a module or a state dict."""

    def pred_step(params, batch):
        out = segmentation_outputs(model, params, batch)
        s = out_size or cfg.image_size
        sem = semantic_inference(out["pred_logits"], resize_bilinear(out["pred_masks"], (s, s)))
        return sem.argmax(dim=1) + 1

    return pred_step


def make_eval_step(model: MaskFormerModel, cfg: MaskFormerConfig):
    """``eval_step(params, batch, gt_label_map)`` -> the mean dice of the
    full-modality forward over the batch (maskformer_train_ins_vit.py:269-306)."""

    def eval_step(params, batch, gt_label_map):
        out = segmentation_outputs(model, params, batch)
        gt = as_input(gt_label_map, out["pred_masks"].device)
        sem = semantic_inference(out["pred_logits"],
                                 resize_bilinear(out["pred_masks"], tuple(gt.shape[-2:])))
        return torch.stack([dice_score(s, binary_mask_from_labels(t, cfg.num_classes))
                            for s, t in zip(sem, gt)]).mean()

    return eval_step
