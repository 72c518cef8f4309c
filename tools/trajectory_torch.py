"""Many-step training trajectories of the PyTorch port, each held to a
control run: from the same weights, the same batches and the same injected
inputs each step,

  * A, the kernel path (``attn_impl='auto'``), on a card only: on the CPU
    the kernels run their plain versions, so A would be B again;
  * B, the plain path (``attn_impl='xla'``, also K4 / K5 through their
    plain versions);
  * C, the control: the plain path on the same batches with their rows
    permuted by one fixed permutation, every per-sample input with them
    (masks, downstream targets, matches and PointRend points). Every loss
    is a mean or a sum normalised by counts, so C equals B in exact
    arithmetic: its drift from B is what the order of the reductions alone
    gives;
  * D (by default on the CPU only): B with the model in f64. The port keeps
    three parts of the step in f32 whatever the model's dtype, so D is not
    f64 throughout: the optimizers' flat moments and update (FlatAdamW and
    the balancer's, ``train/optim.py``), the pooled stream of the
    contrastive term (``train/pretrain.py`` ``make_loss_fn``) and the
    downstream head's outputs and criterion (``train/downstream.py``
    ``forward``);
  * E (bf16 trajectories only): B computing in f32, the bf16 rounding's own
    control. A bf16 output rounds away most of what a permutation changes
    in an f32 accumulation, so C can stay bitwise B in bf16 while A and B,
    rounded at different places, differ by a bf16 rounding.

With A, each step also evaluates at B's weights (``at_B_weights``), before
B's update and without a gradient, on that step's inputs and B's
decisions: the kernel path (``A``: one step's kernel error, apart from the
trajectories' divergence) and, in bf16, the plain path in f32 (``E``: how
far B's own bf16 rounding takes it; ``A_vs_E`` and ``B_vs_E``: which of the
two bf16 paths lies nearer the f32 value); downstream each once with B's
head masks pinned and once with its own (``A_free``, ``E_free``, with the
head-mask bits that differ from B's).

Paths:
  * ``pretrain``: ``train.pretrain.create_train_state`` /
    ``make_train_step``; each step's masks (one a row) are drawn on the host
    from the seed by ``ops.masking.generate_random_masks`` and injected; the
    batches come from ``data.synthetic.synthetic_batch`` (a pool of 8,
    cycled, as tools/parity_trajectory.py);
  * ``downstream``: ``train.downstream.make_downstream_train_step``, dropout
    off; each step's modality subset and masks (one a row) are drawn from
    the seed, and every discrete decision of the step is B's own: the
    matches (the exact scipy assignment of B's costs), the PointRend points
    (B's importance-sampled ones) and the Mask2Former head's hard attention
    masks (sigmoid >= 0.5 of B's mask logits, which a rounding near the
    threshold flips), taken from a forward of B and injected into every
    other run (permuted into C). The step also records how many valid
    targets A's own costs would have matched to another query (the flips;
    nothing is changed by them).

Widths: ``small`` is the SMALL model of tests/test_torch_pretrain_state.py
(balancer and EMA on) and the small MaskFormer of
tests/test_torch_downstream_train.py (B = 2, 24 points); ``small_dh32`` the
same with every attention head 32 wide (pretraining 2 x 32, its decoder 1 x
32, the MaskFormer's backbone 1 x 32), the narrowest head the kernels take,
so the kernel path runs at a small width on the card; ``full`` is
``PretrainConfig()`` at B = 60 and ``MaskFormerConfig(num_classes=1)`` at B =
30 with 12,544 points. The downstream weights take the two changes
chip_smoke.py's ``segment_model`` makes to the initializers (noise on the
deformable attention's zero kernels, ``mask_embed.layer2`` x 6).

The optimizer: pretraining at lr 1e-4 constant (no warmup, ``min_lr`` = lr,
``blr`` scaled by the batch), betas (0.9, 0.95), no weight decay, as
tools/parity_trajectory.py; downstream the downstream optimizer's own AdamW
(betas (0.9, 0.999), weight decay 1e-4) at lr 1e-4, clip 0.01, its frozen
stages. On the card TF32 is off for every run.

The result: per run and step the loss and its terms, per run against B the
relative drift |x - B| / |B| of each (per step, and its max, mean and
final), per step the weights' flat rel-L2 against B's and each
tensor's, the final masters' flat rel-L2 against B's (the
key third of every fused qkv bias left out: its gradient is zero in exact
arithmetic, see tests/test_torch_pretrain_state.py; downstream over the
trainable parameters) and the wall seconds. A non-finite loss raises.
``--sync NAME`` copies B's tensor NAME into every other run after each
step: with it, what the other tensors alone make of the drift.

Usage (the port only: this file imports torch, numpy, the port and
chip_smoke.py's head-mask helpers, no JAX):
    python tools/trajectory_torch.py --path pretrain --width small --steps 20
    python tools/trajectory_torch.py --device cuda --width small_dh32 --steps 20
    python tools/trajectory_torch.py --device cuda --width full --path all \\
        --dtype bfloat16 float32 --out trajectory_card.json
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from chip_smoke import head_masks, mask_bits_differ  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch import config as tconfig  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch.data.synthetic import synthetic_batch, synthetic_instances  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch.losses.set_criterion import SegTargets  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch.models.maskformer import MaskFormerConfig, build_maskformer  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch.models.msda_module import MSDeformAttn  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_build, masking  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch.train import downstream, pretrain  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch.train.ema import init_ema  # noqa: E402

LR = 1e-4
BETAS = (0.9, 0.95)
CLIP = 0.01  # the downstream optimizer's (scripts/train_downstream.py)
POOL = 8  # batches, cycled
STEPS = {"pretrain": 200, "downstream": 50}  # PARITY_TRAJ.json's lengths
TERMS = {"pretrain": ("recon_loss", "contra_loss", "s1_loss", "s2_loss", "dem_loss", "grad_norm"),
         "downstream": ("loss_ce", "loss_dice", "loss_mask", "grad_norm")}
# the small MaskFormer of tests/test_torch_downstream_train.py
SMALL_SEGMENT = dict(in_domains=("s1", "s2", "dem"), image_size=64, patch_size=16, num_classes=3, dim_tokens=32,
                     depth=2, dim_head=8, heads=2, num_fusion_tokens=16, conv_dim=32, mask_dim=32,
                     transformer_enc_layers=1, num_queries=10, dec_layers=3, dim_feedforward=64, frozen_stages=1)
POINTS = {"small": 24, "small_dh32": 24, "full": 12544}
BATCH = {"small": {"pretrain": 2, "downstream": 2}, "small_dh32": {"pretrain": 2, "downstream": 2},
         "full": {"pretrain": 60, "downstream": 30}}
WIDTHS = tuple(BATCH)
RUNS = {"A": "kernel path (attn_impl='auto')", "B": "plain path (attn_impl='xla')",
        "C": "plain path, rows permuted (control)", "D": "plain path, model in f64 (control)",
        "E": "plain path computing in f32 (the bf16 rounding's control)"}


def pretrain_config(mod, width: str, dtype: str):
    """The pretraining config of ``width`` as ``mod``'s PretrainConfig (the
    port's config module or the JAX package's: the fields are the same),
    with the trajectory's optimizer."""
    if width not in WIDTHS:
        raise ValueError(f"width must be one of {WIDTHS}, got {width!r}")
    b = BATCH[width]["pretrain"]
    optim = dict(blr=LR * 256 / b, warmup_epochs=0, min_lr=LR, weight_decay=0.0, opt_betas=BETAS)
    if width == "full":
        return mod.PretrainConfig(data=mod.DataConfig(batch_size=b), optim=mod.OptimConfig(**optim),
                                  train=mod.TrainConfig(compute_dtype=dtype))
    dh32 = width == "small_dh32"  # every head 32 wide: the kernels' narrowest
    return mod.PretrainConfig(
        model=mod.ModelConfig(dim_tokens=64, depth=2, dim_head=32 if dh32 else 16, heads=2, ff_mult=4,
                              num_fusion_tokens=16),
        data=mod.DataConfig(input_size=64, patch_size=16, batch_size=b),
        mask=mod.MaskConfig(num_encoded_tokens=24),
        decoder=mod.DecoderConfig(dim=32, depth=2, num_heads=1 if dh32 else 2),
        optim=mod.OptimConfig(task_balancer="uncertainty", balancer_lr_scale=2.0, fused_adamw=True, **optim),
        train=mod.TrainConfig(epochs=1, compute_dtype=dtype, use_ema=True, ema_decay=0.5))


def segment_config(width: str) -> dict:
    """MaskFormerConfig's fields at ``width``."""
    if width == "full":
        return dict(num_classes=1)
    if width not in WIDTHS:
        raise ValueError(f"width must be one of {WIDTHS}, got {width!r}")
    return dict(SMALL_SEGMENT, **({"dim_head": 32, "heads": 1} if width == "small_dh32" else {}))


def fixed_permutation(b: int, seed: int) -> np.ndarray:
    """The control's row permutation: drawn from the seed, never the
    identity."""
    perm = np.random.default_rng(seed + 1).permutation(b)
    return np.roll(np.arange(b), 1) if b > 1 and (perm == np.arange(b)).all() else perm


def pretrain_masks(g: torch.Generator, cfg, b: int, device=None) -> masking.MaskInfo:
    """One step's masks, one a row, drawn on the host from ``g``."""
    doms = tuple(cfg.data.in_domains)
    return masking.generate_random_masks(g, doms, (cfg.data.num_patches,) * len(doms), cfg.mask.num_encoded_tokens,
                                         b, alphas=cfg.mask.alphas,
                                         sample_tasks_uniformly=cfg.mask.sample_tasks_uniformly,
                                         batch_shared=False, device=device)


def segment_draws(g: torch.Generator, cfg: MaskFormerConfig, b: int, device=None):
    """One downstream step's modality subset [T] bool, masks (one a row) and
    criterion key, drawn on the host from ``g``."""
    doms = tuple(cfg.in_domains)
    present = masking.sample_modality_subset(g, len(doms))
    mi = masking.incomplete_random_masks(g, doms, (cfg.num_patches,) * len(doms), present, cfg.max_encoded_tokens,
                                         b, keep_ratio=cfg.keep_ratio, batch_shared=False, device=device)
    return present, mi, int(torch.randint(2 ** 62, (), generator=g))


def permute_mask_info(mi: masking.MaskInfo, perm: torch.Tensor) -> masking.MaskInfo:
    return masking.MaskInfo({d: m[perm] for d, m in mi.task_masks.items()}, mi.order[perm], mi.ids_restore[perm],
                            mi.num_visible[perm])


def permute_targets(t: SegTargets, perm: torch.Tensor) -> SegTargets:
    return SegTargets(*(a[perm] for a in t))


def permute_coords(coords: torch.Tensor, perm: torch.Tensor, b: int) -> torch.Tensor:
    """[L, B*G, P, 2] point coordinates (rows batch-major) with the batch rows
    permuted."""
    lv, bg = coords.shape[:2]
    return coords.view(lv, b, bg // b, *coords.shape[2:])[:, perm].reshape(coords.shape)


def rel_drift(xs: List[float], refs: List[float]) -> Dict:
    """|x - ref| / |ref| a step, with its max (and step), mean and final."""
    r = [abs(x - y) / abs(y) if y != 0 else abs(x - y) for x, y in zip(xs, refs)]
    i = int(np.argmax(r))
    return {"per_step": r, "max": r[i], "max_at_step": i, "mean": float(np.mean(r)), "final": r[-1]}


def weights_drift(named, ref_named, only=None):
    """The flat rel-L2 of the parameters ``named`` against ``ref_named``
    (over the names in ``only`` when given), the key third of every fused
    qkv bias left out, computed where the tensors lie; and each tensor's
    own rel-L2, {name: rel-L2}."""
    names, diff, ref = [], [], []
    for (name, p), (_, q) in zip(named, ref_named):
        if only is not None and not only[name]:
            continue
        a, b = p.detach().reshape(-1).double(), q.detach().reshape(-1).double().to(p.device)
        if name.endswith("qkv.bias"):
            third = a.numel() // 3
            a, b = torch.cat([a[:third], a[2 * third:]]), torch.cat([b[:third], b[2 * third:]])
        names.append(name)
        diff.append((a - b).norm())
        ref.append(b.norm())
    diff, ref = torch.stack(diff).tolist(), torch.stack(ref).tolist()
    total = math.sqrt(sum(d * d for d in diff)) / math.sqrt(sum(r * r for r in ref))
    return total, {n: d / r if r else d for n, d, r in zip(names, diff, ref)}


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("trajectory_torch: --device cuda given and no CUDA device is available")
    return device


def _runs(runs: Optional[Sequence[str]], device: torch.device, dtype: str) -> Sequence[str]:
    """The runs asked for, by default every one that reads something here:
    A on a card, D on the CPU (on a card only when asked for), E in bf16."""
    cuda = device.type == "cuda"
    if runs is None:
        runs = ("A",) * cuda + ("B", "C") + ("D",) * (not cuda) + ("E",) * (dtype == "bfloat16")
    if "B" not in runs:
        raise ValueError("every run is held to B: runs must hold 'B'")
    if "A" in runs and not cuda:
        raise ValueError("run A, the kernel path, needs a CUDA device: on the CPU it is the plain path B again")
    if "E" in runs and dtype != "bfloat16":
        raise ValueError("run E, B in f32, is the control of a bf16 trajectory only")
    return runs


def _precision(device: torch.device) -> None:
    """No TF32 on the card, as chip_smoke.py's f32 phases: every f32 product
    (f32 runs, E, the f32 parts of a bf16 step) in f32."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


class _Run:
    """One trajectory: its step, state and recorded losses, and per step its
    weights' drift from B's."""

    def __init__(self, name: str, path: str, step, state, model, permuted: bool):
        self.name, self.step, self.state, self.model, self.permuted = name, step, state, model, permuted
        self.loss: List[float] = []
        self.terms: Dict[str, List[float]] = {k: [] for k in TERMS[path]}
        self.weights: List[float] = []  # a step: the flat rel-L2 against B's
        self.tensors: List[List[float]] = []  # a step: each tensor's rel-L2 against B's, in ``names``' order
        self.names: List[str] = []

    def record(self, i: int, metrics) -> None:
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            raise RuntimeError(f"run {self.name}: the loss of step {i} is {loss}")
        self.loss.append(loss)
        for k in self.terms:
            self.terms[k].append(float(metrics[k]))

    def record_weights(self, ref: "_Run", only=None) -> None:
        rel, each = weights_drift(self.model.named_parameters(), ref.model.named_parameters(), only)
        self.weights.append(rel)
        self.tensors.append([float(f"{v:.4g}") for v in each.values()])
        self.names = list(each)


def _sync(made: Dict[str, _Run], names: Sequence[str]) -> None:
    """B's tensors ``names`` copied into every other run."""
    ref = dict(made["B"].model.named_parameters())
    with torch.no_grad():
        for run in made.values():
            if run.name != "B":
                mine = dict(run.model.named_parameters())
                for n in names:
                    mine[n].copy_(ref[n])


class _AtB:
    """Loss evaluations at B's weights before each of B's steps, without a
    gradient, on that step's inputs and B's decisions: ``evals`` maps a name
    to (model, loss_fn), the model holding B's parameters when it is
    evaluated. Downstream each is evaluated with B's head masks pinned and,
    as ``<name>_free``, with its own, counting the bits that differ from
    B's."""

    def __init__(self, path: str, ref: _Run, evals: Dict[str, tuple]):
        self.ref, self.evals = ref, evals
        names = [n + s for n in evals for s in (("", "_free") if path == "downstream" else ("",))]
        self.loss: Dict[str, List[float]] = {n: [] for n in names}
        self.terms = {n: {k: [] for k in TERMS[path] if k != "grad_norm"} for n in names}
        self.bits: Dict[str, List[int]] = {n: [] for n in names if n.endswith("_free")}

    def _add(self, name: str, loss, metrics) -> None:
        self.loss[name].append(float(loss))
        for k in self.terms[name]:
            self.terms[name][k].append(float(metrics[k]))

    @torch.no_grad()
    def record(self, *args, ref_bits=None, **kwargs) -> None:
        for name, (model, loss_fn) in self.evals.items():
            if model is not self.ref.model:
                torch._foreach_copy_(list(model.parameters()), list(self.ref.model.parameters()))
            if ref_bits is None:
                self._add(name, *loss_fn(dict(model.named_parameters()), *args, **kwargs))
                continue
            with head_masks(model, ref_bits):
                self._add(name, *loss_fn(dict(model.named_parameters()), *args, **kwargs))
            with head_masks(model) as own:
                self._add(name + "_free", *loss_fn(dict(model.named_parameters()), *args, **kwargs))
            self.bits[name + "_free"].append(mask_bits_differ(own, ref_bits)[0])

    def summary(self, upto: int) -> Dict:
        ref = self.ref
        out = {n: {"loss": rel_drift(v, ref.loss[:upto]),
                   "terms": {k: rel_drift(t, ref.terms[k][:upto]) for k, t in self.terms[n].items()}}
               for n, v in self.loss.items()}
        for n, bits in self.bits.items():
            out[n]["head_mask_bits_differ"] = bits
        if "A" in self.loss and "E" in self.loss:  # which of the kernel and plain paths lies nearer the f32 value
            out["A_vs_E"] = rel_drift(self.loss["A"], self.loss["E"])
            out["B_vs_E"] = rel_drift(ref.loss[:upto], self.loss["E"])
        return out


def _summary(path: str, runs: Dict[str, _Run], masters: Dict[str, float], **extra) -> Dict:
    ref = runs["B"]
    out = dict(extra, path=path, runs={n: {"what": RUNS[n], "loss": r.loss, "terms": r.terms}
                                       for n, r in runs.items()})
    out["drift"] = {n: {"loss": rel_drift(r.loss, ref.loss),
                        "terms": {k: rel_drift(v, ref.terms[k]) for k, v in r.terms.items()},
                        "weights_per_step": r.weights, "tensor_names": r.names, "tensors_per_step": r.tensors,
                        "worst_tensors_final": sorted(zip(r.tensors[-1], r.names), reverse=True)[:3]}
                    for n, r in runs.items() if n != "B"}
    out["masters_rel_l2"] = masters
    return out


def pretrain_trajectories(width: str = "small", dtype: str = "float32", steps: int = STEPS["pretrain"],
                          device="cpu", seed: int = 0, runs: Optional[Sequence[str]] = None,
                          sync: Sequence[str] = ()) -> Dict:
    """A, B, C, D, E (those that read something on ``device`` in ``dtype``,
    or ``runs``) over ``steps`` pretraining steps; see the module
    docstring."""
    t0 = time.perf_counter()
    device = _device(device)
    runs = _runs(runs, device, dtype)
    _precision(device)
    cfg = pretrain_config(tconfig, width, dtype)
    b, doms = cfg.data.batch_size, tuple(cfg.data.in_domains)
    perm = torch.as_tensor(fixed_permutation(b, seed), device=device)
    rng = np.random.default_rng(seed)
    pool = [{d: torch.from_numpy(v).to(device) for d, v in synthetic_batch(rng, doms, b, cfg.data.input_size).items()}
            for _ in range(POOL)]
    wide = {"D": "float64", "E": "float32"}
    made: Dict[str, _Run] = {}
    for name in runs:
        rcfg = cfg if name not in wide else dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, compute_dtype=wide[name]))
        model, state, optimizer = pretrain.create_train_state(rcfg, seed, total_steps=steps, device=device)
        if name == "D":
            model.double()
            if state.ema is not None:
                state.ema = init_ema(model.named_parameters())
        model.attn_impl = "auto" if name == "A" else "xla"
        made[name] = _Run(name, "pretrain", pretrain.make_train_step(model, rcfg, optimizer), state, model,
                          permuted=name == "C")
    at_b = None
    if "A" in made:
        ref = made["B"].model
        kernel = copy.deepcopy(ref)
        kernel.attn_impl = "auto"
        evals = {"A": (kernel, pretrain.make_loss_fn(kernel, cfg))}
        if dtype == "bfloat16":
            f32 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype="float32"))
            evals["E"] = (ref, pretrain.make_loss_fn(ref, f32))
        at_b = _AtB("pretrain", made["B"], evals)
    g = torch.Generator().manual_seed(seed)
    for i in range(steps):
        mi = pretrain_masks(g, cfg, b, device)
        batch = pool[i % POOL]
        if at_b is not None:
            at_b.record(batch, mi, made["B"].state.balancer_params)
        for run in made.values():
            if run.permuted:
                run.state, metrics = run.step(run.state, {d: v[perm] for d, v in batch.items()},
                                              mask_info=permute_mask_info(mi, perm))
            else:
                run.state, metrics = run.step(run.state, batch, mask_info=mi)
            run.record(i, metrics)
        _sync(made, sync)
        for run in made.values():
            if run.name != "B":
                run.record_weights(made["B"])
    ref = made["B"].model.named_parameters
    masters = {n: weights_drift(r.model.named_parameters(), ref())[0] for n, r in made.items() if n != "B"}
    extra = {} if at_b is None else {"at_B_weights": at_b.summary(steps)}
    return _summary("pretrain", made, masters, width=width, dtype=dtype, device=str(device), steps=steps, batch=b,
                    seed=seed, permutation=perm.tolist(), sync=list(sync), seconds=time.perf_counter() - t0,
                    **extra)


def segment_model(cfg: MaskFormerConfig, seed: int):
    """The MaskFormer of ``cfg`` on the CPU with seeded weights and
    chip_smoke.py's two changes to the initializers: N(0, 0.02) noise on the
    deformable attention's zero sampling-offset and attention-weight
    kernels, and mask_embed.layer2 x 6 (mask logits off the hard 0.5
    threshold of the masked attention)."""
    model = build_maskformer(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    noise = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MSDeformAttn):
                for lin in (m.sampling_offsets, m.attention_weights):
                    lin.weight.add_(0.02 * torch.randn(lin.weight.shape, generator=noise))
        layer2 = model.predictor.mask_embed.layer2
        layer2.weight.mul_(6.0)
        layer2.bias.mul_(6.0)
    return model


def assignment_flips(matched: torch.Tensor, ref: torch.Tensor, valid: torch.Tensor) -> int:
    """How many valid targets [L, B, G] ``matched`` gives another query than
    ``ref``."""
    return int(((matched.to(ref.device) != ref) & valid[None]).sum())


def downstream_trajectories(width: str = "small", dtype: str = "float32", steps: int = STEPS["downstream"],
                            device="cpu", seed: int = 0, runs: Optional[Sequence[str]] = None,
                            sync: Sequence[str] = ()) -> Dict:
    """A, B, C, D, E (those that read something on ``device`` in ``dtype``,
    or ``runs``) over ``steps`` downstream steps; see the module
    docstring."""
    t0 = time.perf_counter()
    device = _device(device)
    runs = _runs(runs, device, dtype)
    _precision(device)
    cfg = MaskFormerConfig(**segment_config(width))
    b, points = BATCH[width]["downstream"], POINTS[width]
    perm = torch.as_tensor(fixed_permutation(b, seed), device=device)
    rng = np.random.default_rng(seed)
    pool = []
    for _ in range(POOL):
        x, t = synthetic_instances(rng, b, cfg.image_size, cfg.num_classes)
        pool.append(({d: torch.from_numpy(v).to(device) for d, v in x.items()}, downstream.as_targets(t, device)))
    base = segment_model(cfg, seed)
    trainable = downstream.freeze_mask(base, cfg.frozen_stages)
    wide = {"D": "float64", "E": "float32"}
    made: Dict[str, _Run] = {}
    for name in runs:
        model = copy.deepcopy(base).to(device)
        if name == "D":
            model.double()
        model.attn_impl = "auto" if name == "A" else "xla"
        optimizer = downstream.create_downstream_optimizer(model, lr=LR, clip_grad=CLIP,
                                                           frozen_stages=cfg.frozen_stages)
        step = downstream.make_downstream_train_step(model, cfg, optimizer, num_points=points,
                                                     compute_dtype=wide.get(name, dtype))
        made[name] = _Run(name, "downstream", step, downstream.DownstreamState(
            model, optimizer, torch.Generator().manual_seed(seed)), model, permuted=name == "C")
    del base
    ref = made["B"]
    at_b = None
    if "A" in made:
        kernel = copy.deepcopy(ref.model)
        kernel.attn_impl = "auto"

        def loss_fn(model, compute_dtype):
            return downstream.make_downstream_train_step(model, cfg, None, num_points=points,
                                                         compute_dtype=compute_dtype).loss_fn

        evals = {"A": (kernel, loss_fn(kernel, dtype))}
        if dtype == "bfloat16":
            evals["E"] = (ref.model, loss_fn(ref.model, "float32"))
        at_b = _AtB("downstream", ref, evals)
    g = torch.Generator().manual_seed(seed)
    flips: List[int] = []
    n_valid = 0
    for i in range(steps):
        present, mi, key = segment_draws(g, cfg, b, device)
        present = present.to(device)
        x, t = pool[i % POOL]
        with torch.no_grad(), head_masks(ref.model) as bits:  # B's decisions: what every run gets
            _, _, aux = ref.step.loss_fn(dict(ref.model.named_parameters()), x, t, mi, present, key,
                                         return_aux=True)
        matched, coords = aux["matched"], aux["point_coords"]
        if "A" in made:  # the assignment A's own costs give
            a = made["A"]
            with torch.no_grad():
                _, _, aux_a = a.step.loss_fn(dict(a.model.named_parameters()), x, t, mi, present, key,
                                             return_aux=True)
            flips.append(assignment_flips(aux_a["matched"], matched, t.valid))
        if at_b is not None:
            at_b.record(x, t, mi, present, key, ref_bits=bits, matched_override=matched,
                        point_coords_override=coords)
        n_valid = int(t.valid.sum()) * matched.shape[0]
        for run in made.values():
            if run.permuted:
                with head_masks(run.model, [m[perm] for m in bits]):
                    run.state, metrics = run.step(
                        run.state, {d: v[perm] for d, v in x.items()}, permute_targets(t, perm), matched[:, perm],
                        mask_info=permute_mask_info(mi, perm), present=present,
                        point_coords_override=permute_coords(coords, perm, b), deterministic=True)
            else:
                with head_masks(run.model, bits):
                    run.state, metrics = run.step(run.state, x, t, matched, mask_info=mi, present=present,
                                                  point_coords_override=coords, deterministic=True)
            run.record(i, metrics)
        _sync(made, sync)
        for run in made.values():
            if run.name != "B":
                run.record_weights(ref, trainable)
    masters = {n: weights_drift(r.model.named_parameters(), ref.model.named_parameters(), trainable)[0]
               for n, r in made.items() if n != "B"}
    extra = {} if at_b is None else {"at_B_weights": at_b.summary(steps)}
    if flips:
        extra["flips_A"] = {"per_step": flips, "total": int(sum(flips)), "steps_with_flips": sum(f > 0 for f in flips),
                            "valid_targets_x_levels_last_step": n_valid}
    return _summary("downstream", made, masters, width=width, dtype=dtype, device=str(device), steps=steps, batch=b,
                    points=points, seed=seed, permutation=perm.tolist(), sync=list(sync),
                    seconds=time.perf_counter() - t0, **extra)


TRAJECTORIES = {"pretrain": pretrain_trajectories, "downstream": downstream_trajectories}


def card_name_and_power() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit``'s line, None without it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def _brief(res: Dict) -> str:
    parts = [f"{res['path']} {res['width']} {res['dtype']} {res['device']}: {res['steps']} steps, "
             f"{res['seconds']:.1f} s"]
    for n, d in res["drift"].items():
        parts.append(f"{n} max {d['loss']['max']:.3g} mean {d['loss']['mean']:.3g} final {d['loss']['final']:.3g} "
                     f"masters {res['masters_rel_l2'][n]:.3g}")
    for n, d in res.get("at_B_weights", {}).items():
        one = d["loss"] if "loss" in d else d
        parts.append(f"{n} at B's weights max {one['max']:.3g} mean {one['mean']:.3g} final {one['final']:.3g}")
        bits = d.get("head_mask_bits_differ")
        if bits:
            parts.append(f"its head mask bits differing from B's: max {max(bits)}, in {sum(k > 0 for k in bits)} "
                         f"steps")
    if "flips_A" in res:
        parts.append(f"A flips {res['flips_A']['total']} in {res['flips_A']['steps_with_flips']} steps")
    return "; ".join(parts)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=("pretrain", "downstream", "all"), default="all")
    ap.add_argument("--width", choices=WIDTHS, default="small")
    ap.add_argument("--dtype", nargs="+", choices=("float32", "bfloat16"), default=["float32"])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--steps", type=int, default=None, help="default: 200 pretraining, 50 downstream")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", nargs="+", choices=tuple(RUNS), default=None,
                    help="default: every run that reads something on the device in the dtype")
    ap.add_argument("--sync", nargs="+", default=(), metavar="NAME",
                    help="parameters copied from B into every other run after each step")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    device = _device(args.device)
    result = {"device": str(device), "card": card_name_and_power() if device.type == "cuda" else None,
              "torch": torch.__version__, "results": []}
    if result["card"]:
        print(result["card"], flush=True)
    if device.type == "cuda":  # every kernel library at once (one nvcc a source), not one a first call
        t1 = time.perf_counter()
        cuda_build.build_all()
        result["build_seconds"] = time.perf_counter() - t1
    for path in (("pretrain", "downstream") if args.path == "all" else (args.path,)):
        for dtype in args.dtype:
            runs = None if args.runs is None else [n for n in args.runs if n != "E" or dtype == "bfloat16"]
            res = TRAJECTORIES[path](args.width, dtype, args.steps or STEPS[path], device, args.seed, runs=runs,
                                     sync=args.sync)
            result["results"].append(res)
            print(_brief(res), flush=True)
            if args.out:  # written after each trajectory, so a cut run keeps what it finished
                result["seconds"] = time.perf_counter() - t0
                os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
                with open(args.out, "w") as f:
                    json.dump(result, f, indent=1)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
