"""Mask2Former set criterion and Hungarian matching (JAX package
losses/set_criterion.py; reference criterion_ins.py:120-278 and
matcher_ins.py:70-175).

  * Targets are padded tensors (``SegTargets``: labels [B, G] with -1 pad,
    masks [B, G, H, W], valid [B, G]); padded target columns get the
    constant ``PAD_COST``, so their assignment is interchangeable and the
    real columns' assignment stays optimal.
  * Matching (``match_mode``): 'exact' is scipy's ``linear_sum_assignment``
    on the host, as the reference does (matcher_ins.py:147): the costs of
    every prediction level are computed first and copied to the host once
    (``set_criterion_costs``), one scipy pass assigns them all. 'greedy'
    and 'auction' (the JAX package's on-device assignments) run on the
    cost's device over every level and image at once.
  * ``dense_masks`` (the semantic criterion, criterion_seg.py:169-204): the
    mask losses over the whole masks, the targets resized to the
    predictions' size by nearest neighbour at half-pixel centres, no
    PointRend points.
  * PointRend uncertainty point sampling (12544 points, oversample 3.0,
    importance 0.75) with exact ``torch.topk``; point sampling runs kernels
    K5 / K5b through ``ops.cuda_points.PointSampleFunction`` (``impl``
    'auto'), or the plain version everywhere (``impl`` 'xla').

Randomness: the functions that draw take an explicit ``torch.Generator``
(``uncertain_point_coords``, ``match_costs``), or accept the drawn values
(``coords``, ``draws``, ``point_coords_override``) so a test can inject
JAX's draws. ``set_criterion`` and ``set_criterion_costs`` take a ``key``, an
int that plays a JAX key's part: both derive the same per-level generators
from it (level li: its matcher points from ``(key, li, 0)``, its PointRend
points from ``(key, li, 1)``), so host assignments made from
``set_criterion_costs(key)`` are what ``set_criterion(key)`` would make.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.targets import SegTargets
from ..ops import cuda_points
from ..ops.points import point_sample as point_sample_plain

PAD_COST = 1e8


def point_sample(masks: torch.Tensor, coords: torch.Tensor, group: int = 1,
                 impl: str = "auto") -> torch.Tensor:
    """masks [N, H, W], coords [N / group, P, 2] in [0, 1] (x, y) -> [N, P]
    f32: kernel K5 (its backward K5b) for CUDA tensors with ``impl`` 'auto',
    else the plain version, which autograd differentiates."""
    masks = masks.float().contiguous()
    coords = coords.float().contiguous()
    if impl == "xla":
        return point_sample_plain(masks, coords, group)
    return cuda_points.PointSampleFunction.apply(masks, coords, group)


def uniform_rows(generator: Optional[torch.Generator], n: int, tail: Tuple[int, ...], device,
                 share: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """U[0, 1) draws [n, *tail] from ``generator``. With ``share`` = (i, k)
    (data parallelism: this rank holds the i-th of k equal shares of the
    global batch) the draw is the global batch's, k * n rows, and share i's
    rows are kept: a rank draws the points the one-device step would give
    its rows."""
    if share is None:
        return torch.rand((n,) + tail, generator=generator, device=device)
    i, k = share
    return torch.rand((k * n,) + tail, generator=generator, device=device)[i * n:(i + 1) * n]


def calculate_uncertainty(logits: torch.Tensor) -> torch.Tensor:
    """-|logit| (criterion_ins.py calculate_uncertainty)."""
    return -logits.abs()


def uncertain_point_coords(generator: Optional[torch.Generator], logits: torch.Tensor,
                           num_points: int, oversample_ratio: float = 3.0,
                           importance_sample_ratio: float = 0.75,
                           draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                           impl: str = "auto", share: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """get_uncertain_point_coords_with_randomness: num_points * oversample
    uniform points, the most uncertain importance fraction of them kept
    (exact top-k), the rest fresh uniform points. logits [N, H, W] ->
    coords [N, num_points, 2]. ``draws`` = (oversampled [N, n_sampled, 2],
    fresh [N, n_rand, 2]) replaces the two uniform draws; ``share``
    (``uniform_rows``) draws them for the global batch's rows."""
    n = logits.shape[0]
    n_sampled = int(num_points * oversample_ratio)
    n_unc = int(importance_sample_ratio * num_points)
    n_rand = num_points - n_unc
    dev = logits.device
    if draws is None:
        coords = uniform_rows(generator, n, (n_sampled, 2), dev, share)
        rand_coords = uniform_rows(generator, n, (n_rand, 2), dev, share)
    else:
        coords, rand_coords = (d.to(dev, torch.float32) for d in draws)
    unc = calculate_uncertainty(point_sample(logits, coords, impl=impl))
    idx = torch.topk(unc, n_unc, dim=1).indices
    top = torch.gather(coords, 1, idx[..., None].expand(-1, -1, 2))
    return torch.cat([top, rand_coords], dim=1)


# ---------------------------------------------------------------------------
# matching
# ---------------------------------------------------------------------------
def batch_dice_cost(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """[..., Q, P] logits x [..., G, P] binary -> [..., Q, G]
    (matcher_ins.py:15-30)."""
    p = torch.sigmoid(inputs)
    num = 2 * torch.einsum("...qp,...gp->...qg", p, targets)
    den = p.sum(-1)[..., :, None] + targets.sum(-1)[..., None, :]
    return 1 - (num + 1) / (den + 1)


def batch_sigmoid_ce_cost(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """[..., Q, P] x [..., G, P] -> [..., Q, G] (matcher_ins.py:38-61)."""
    hw = inputs.shape[-1]
    pos = F.softplus(-inputs)  # BCE(x, 1)
    neg = F.softplus(inputs)  # BCE(x, 0)
    return (torch.einsum("...qp,...gp->...qg", pos, targets)
            + torch.einsum("...qp,...gp->...qg", neg, 1 - targets)) / hw


def _scipy_assign(cost: np.ndarray) -> np.ndarray:
    """[B, Q, G] -> the query matched to each target column, [B, G]."""
    from scipy.optimize import linear_sum_assignment

    b, q, g = cost.shape
    out = np.zeros((b, g), np.int64)
    for i in range(b):
        row, col = linear_sum_assignment(cost[i])
        out[i, col] = row
    return out


def scipy_assign_host(cost: np.ndarray) -> np.ndarray:
    """Exact assignment of a host cost array [..., B, Q, G] -> [..., B, G]
    (any leading level dims), one scipy pass."""
    lead = cost.shape[:-3]
    flat = cost.reshape((-1,) + cost.shape[-3:])
    out = np.stack([_scipy_assign(c) for c in flat])
    return out.reshape(lead + out.shape[1:])


def greedy_assign(cost: torch.Tensor) -> torch.Tensor:
    """On-device greedy assignment (JAX ``_greedy_assign``,
    set_criterion.py:141): G times, the globally cheapest (q, g) pair of
    each [Q, G] matrix is taken (the first in row-major order among equal
    costs, as ``jnp.argmin``; padded columns too) and its row and column
    are closed. cost [..., Q, G] -> [..., G] int64; no host sync."""
    lead, (q, g) = cost.shape[:-2], cost.shape[-2:]
    c = cost.detach().reshape(-1, q, g).clone()
    n = c.shape[0]
    rows = torch.arange(n, device=c.device)
    out = torch.zeros((n, g), dtype=torch.int64, device=c.device)
    for _ in range(g):
        flat = c.reshape(n, q * g).argmin(dim=1)
        qi, gi = flat // g, flat % g
        out[rows, gi] = qi
        c[rows, qi, :] = float("inf")
        c[rows, :, gi] = float("inf")
    return out.reshape(*lead, g)


AUCTION_CHECK_EVERY = 25  # auction rounds between two looks at the host's "all assigned?"


def auction_assign(cost: torch.Tensor, eps_scale: float = 1e-3, max_iters: int = 500) -> torch.Tensor:
    """On-device Bertsekas auction with Jacobi bidding (JAX
    ``_auction_assign``, set_criterion.py:165): the targets bid for
    queries with eps = eps_scale * the value spread, at most ``max_iters``
    rounds, then a greedy fill of any target left unassigned; within G eps
    of the optimum. cost [..., Q, G] -> [..., G] int64.

    How the loop ends: a round in which no target is unassigned changes
    nothing (no bidder, so no bid, price or owner moves), so a finished
    image may run on and still give JAX's result exactly, as JAX's vmapped
    while loop freezes it. Every ``AUCTION_CHECK_EVERY`` rounds the host
    reads whether any target of any image is still unassigned (one sync
    each time) and stops if none is; else the rounds stop at ``max_iters``.
    Ties go to the lowest index, as ``jnp.argmax`` and ``lax.top_k`` give
    them: the top two bids are argmax, mask, max (``torch.topk`` promises
    no order among ties)."""
    lead, (q, g) = cost.shape[:-2], cost.shape[-2:]
    c = cost.detach().float().reshape(-1, q, g)
    n, dev = c.shape[0], c.device
    value = -c.transpose(1, 2)  # [N, G, Q], maximized
    spread = torch.clamp(value.amax(dim=(1, 2)) - value.amin(dim=(1, 2)), min=1e-6)
    eps = (eps_scale * spread)[:, None]
    ar_q, ar_g = torch.arange(q, device=dev), torch.arange(g, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    prices = torch.zeros((n, q), device=dev)
    owner = torch.full((n, q), -1, dtype=torch.int64, device=dev)
    assigned = torch.full((n, g), -1, dtype=torch.int64, device=dev)
    for it in range(max_iters):
        if it % AUCTION_CHECK_EVERY == 0 and not bool((assigned < 0).any()):
            break
        net = value - prices[:, None, :]  # [N, G, Q]
        best_q = net.argmax(dim=2)  # [N, G]
        best_v = net.gather(2, best_q[..., None])[..., 0]
        second_v = net.scatter(2, best_q[..., None], float("-inf")).amax(dim=2)
        bid = prices.gather(1, best_q) + best_v - second_v + eps  # [N, G]
        bidding = assigned < 0
        bid_mat = torch.where(bidding[..., None] & (best_q[..., None] == ar_q), bid[..., None], neg_inf)
        got_bid = torch.isfinite(bid_mat).any(dim=1)  # [N, Q]
        winner_g = bid_mat.argmax(dim=1)
        winner_bid = bid_mat.amax(dim=1)
        # the previous owners of the queries that got a bid lose them
        lost = torch.where(got_bid, owner, torch.full_like(owner, -2))
        assigned = torch.where((ar_g[None, :, None] == lost[:, None, :]).any(dim=2), -1, assigned)
        owner = torch.where(got_bid, winner_g, owner)
        prices = torch.where(got_bid, winner_bid, prices)
        upd_g = torch.where(got_bid, winner_g, torch.full_like(winner_g, g))  # column g: dropped
        assigned = torch.cat([assigned, assigned.new_full((n, 1), -1)], dim=1).scatter(
            1, upd_g, ar_q.expand(n, q))[:, :g]
    # the fill: any target left unassigned takes the cheapest free query
    for _ in range(g):
        unas = assigned < 0
        gi = unas.to(torch.int32).argmax(dim=1)  # the first unassigned, else 0
        free = ~(ar_q[None, :, None] == assigned[:, None, :]).any(dim=2)  # [N, Q]
        column = c.gather(2, gi[:, None, None].expand(n, q, 1))[..., 0]
        pick = torch.where(free, column, torch.full_like(column, float("inf"))).argmin(dim=1)
        take = unas.gather(1, gi[:, None]) & (ar_g[None, :] == gi[:, None])
        assigned = torch.where(take, pick[:, None], assigned)
    return assigned.reshape(*lead, g)


MATCH_MODES = ("exact", "greedy", "auction")


def hungarian_match(cost: torch.Tensor, exact: bool = True, mode: Optional[str] = None) -> torch.Tensor:
    """cost [..., B, Q, G] -> matched query per target column [..., B, G]
    on the cost's device (JAX set_criterion.py:227): 'exact' (scipy on the
    host, one copy), 'greedy' or 'auction' (on the device)."""
    mode = mode or ("exact" if exact else "greedy")
    if mode == "greedy":
        return greedy_assign(cost)
    if mode == "auction":
        return auction_assign(cost)
    if mode != "exact":
        raise ValueError(f"match_mode must be one of {MATCH_MODES}, got {mode!r}")
    host = cost.detach().float().cpu().numpy()
    return torch.from_numpy(scipy_assign_host(host)).to(cost.device)


def match_costs(pred_logits: torch.Tensor, pred_masks: torch.Tensor, targets: SegTargets,
                generator: Optional[torch.Generator], num_points: int, cost_class: float = 1.0,
                cost_mask: float = 1.0, cost_dice: float = 1.0,
                coords: Optional[torch.Tensor] = None, impl: str = "auto",
                share: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Matching cost [B, Q, G] (matcher_ins.py:95-146), padded target
    columns at PAD_COST, without gradient. One row of uniform points per
    image [B, num_points, 2] (``coords``, or drawn from ``generator``),
    shared by its queries and its targets (matcher_ins.py:116-129): the
    samplers read it per group, with no broadcast copy."""
    with torch.no_grad():
        b, q = pred_logits.shape[:2]
        g = targets.labels.shape[1]
        prob = torch.softmax(pred_logits.float(), dim=-1)
        safe = targets.labels.long().clamp(0, prob.shape[-1] - 1)
        c_class = -torch.gather(prob, 2, safe[:, None, :].expand(b, q, g))
        if coords is None:
            coords = uniform_rows(generator, b, (num_points, 2), pred_masks.device, share)
        coords = coords.reshape(b, num_points, 2)
        out_pts = point_sample(pred_masks.reshape(b * q, *pred_masks.shape[2:]), coords, q, impl)
        tgt_pts = point_sample(targets.masks.reshape(b * g, *targets.masks.shape[2:]), coords, g, impl)
        out_pts = out_pts.reshape(b, q, num_points)
        tgt_pts = tgt_pts.reshape(b, g, num_points)
        cost = (cost_class * c_class + cost_mask * batch_sigmoid_ce_cost(out_pts, tgt_pts)
                + cost_dice * batch_dice_cost(out_pts, tgt_pts))
        return torch.where(targets.valid[:, None, :], cost, torch.full_like(cost, PAD_COST))


def match_outputs_to_targets(pred_logits, pred_masks, targets: SegTargets,
                             generator: Optional[torch.Generator], num_points: int,
                             cost_class: float = 1.0, cost_mask: float = 1.0, cost_dice: float = 1.0,
                             exact: bool = True, match_mode: Optional[str] = None,
                             impl: str = "auto") -> torch.Tensor:
    """HungarianMatcher.memory_efficient_forward (matcher_ins.py:95-153)."""
    cost = match_costs(pred_logits, pred_masks, targets, generator, num_points, cost_class,
                       cost_mask, cost_dice, impl=impl)
    return hungarian_match(cost, exact=exact, mode=match_mode)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def _summed(x: torch.Tensor, batch_sum) -> torch.Tensor:
    return x if batch_sum is None else batch_sum(x)


def sigmoid_ce_loss(point_logits, point_labels, weights, num_masks, batch_sum=None):
    """Per-mask mean over points, summed over masks / num_masks; padded rows
    weighted 0 (criterion_ins.py sigmoid_ce_loss). ``batch_sum`` (data
    parallelism, parallel/comm.py) sums over the global batch's masks."""
    loss = torch.where(point_labels > 0.5, F.softplus(-point_logits), F.softplus(point_logits))
    return _summed((loss.mean(dim=-1) * weights).sum(), batch_sum) / num_masks


def dice_loss(point_logits, point_labels, weights, num_masks, batch_sum=None):
    p = torch.sigmoid(point_logits)
    num = 2 * (p * point_labels).sum(dim=-1)
    den = p.sum(dim=-1) + point_labels.sum(dim=-1)
    return _summed(((1 - (num + 1) / (den + 1)) * weights).sum(), batch_sum) / num_masks


def criterion_losses(pred_logits: torch.Tensor, pred_masks: torch.Tensor, targets: SegTargets,
                     matched_q: torch.Tensor, generator: Optional[torch.Generator], num_classes: int,
                     num_masks: torch.Tensor, eos_coef: float = 0.1, num_points: int = 12544,
                     oversample_ratio: float = 3.0, importance_sample_ratio: float = 0.75,
                     dense_masks: bool = False, point_coords_override: Optional[torch.Tensor] = None,
                     impl: str = "auto", batch_sum=None, share: Optional[Tuple[int, int]] = None
                     ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """loss_labels + loss_masks of one prediction level
    (criterion_ins.py:153-221). Returns the losses and the PointRend coords
    [B*G, P, 2] they were taken at (``point_coords_override`` when given,
    else drawn from ``generator``). With ``dense_masks`` (criterion_seg.py:
    169-204) the mask losses are taken over the whole masks, the targets
    resized to the predictions' size by ``jax.image.resize(method=
    'nearest')``'s rule (half-pixel centres: 'nearest-exact'), and the
    coords returned are None. ``batch_sum`` and ``share`` (data
    parallelism): the class loss's weight sum and the mask losses' sums are
    the global batch's, the random points those the global draw gives this
    rank's rows."""
    b, q, _ = pred_logits.shape
    g = targets.labels.shape[1]
    dev = pred_logits.device
    matched_q = matched_q.long()

    # classes: matched queries take their valid target's label, every other
    # query no-object (weighted eos_coef); padded columns scatter into an
    # extra column q that is dropped (criterion_ins.py:161-165)
    slot = torch.where(targets.valid, matched_q, torch.full_like(matched_q, q))
    label = torch.where(targets.valid, targets.labels.long(), torch.full_like(matched_q, num_classes))
    target_classes = torch.full((b, q + 1), num_classes, dtype=torch.long, device=dev)
    target_classes = target_classes.scatter(1, slot, label)[:, :q]
    logp = torch.log_softmax(pred_logits.float(), dim=-1)
    class_w = torch.ones(num_classes + 1, device=dev)
    class_w[num_classes] = eos_coef
    w = class_w[target_classes]
    nll = -torch.gather(logp, 2, target_classes[..., None])[..., 0]
    if batch_sum is None:
        loss_ce = (nll * w).sum() / w.sum().clamp(min=1e-6)
    else:
        total, weight = batch_sum(torch.stack([(nll * w).sum(), w.sum()]))
        loss_ce = total / weight.clamp(min=1e-6)

    # masks: the matched prediction of each target column
    h, wd = pred_masks.shape[2:]
    src = torch.gather(pred_masks.float(), 1, matched_q[:, :, None, None].expand(b, g, h, wd))
    weights = targets.valid.float().reshape(-1)
    if dense_masks:
        with torch.no_grad():
            tgt = F.interpolate(targets.masks.float(), size=(h, wd), mode="nearest-exact")
        pl_, tl_ = src.reshape(b * g, h * wd), tgt.reshape(b * g, h * wd)
        return {"loss_ce": loss_ce, "loss_mask": sigmoid_ce_loss(pl_, tl_, weights, num_masks, batch_sum),
                "loss_dice": dice_loss(pl_, tl_, weights, num_masks, batch_sum)}, None
    src_f = src.reshape(b * g, h, wd)
    tgt_f = targets.masks.float().reshape(b * g, *targets.masks.shape[2:])
    if point_coords_override is not None:
        coords = point_coords_override.to(dev, torch.float32)
    else:
        with torch.no_grad():
            coords = uncertain_point_coords(generator, src_f.detach(), num_points, oversample_ratio,
                                            importance_sample_ratio, impl=impl, share=share)
    point_logits = point_sample(src_f, coords, impl=impl)
    with torch.no_grad():
        point_labels = point_sample(tgt_f, coords, impl=impl)
    losses = {
        "loss_ce": loss_ce,
        "loss_mask": sigmoid_ce_loss(point_logits, point_labels, weights, num_masks, batch_sum),
        "loss_dice": dice_loss(point_logits, point_labels, weights, num_masks, batch_sum),
    }
    return losses, coords


def _levels(outputs: Dict) -> list:
    return [outputs] + list(outputs.get("aux_outputs", []))


def level_generator(key: int, level: int, stream: int, device) -> torch.Generator:
    """The generator of prediction level ``level``'s matcher points (stream
    0) or PointRend points (stream 1) under ``key``."""
    seed = (int(key) * 1_000_003 + 2 * level + stream) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(seed)


def set_criterion_costs(outputs: Dict, targets: SegTargets, key: int, num_points: int = 12544,
                        cost_class: float = 1.0, cost_mask: float = 1.0, cost_dice: float = 1.0,
                        impl: str = "auto", share: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Per-level matching costs [L, B, Q, G] (level order: final, aux 0,
    aux 1, ...), each level's points from ``level_generator(key, li, 0)``,
    so host assignments from them equal ``set_criterion(key)``'s."""
    return torch.stack([
        match_costs(out["pred_logits"], out["pred_masks"], targets,
                    level_generator(key, li, 0, out["pred_masks"].device), num_points,
                    cost_class, cost_mask, cost_dice, impl=impl, share=share)
        for li, out in enumerate(_levels(outputs))])


def set_criterion(outputs: Dict, targets: SegTargets, key: int, num_classes: int,
                  eos_coef: float = 0.1, num_points: int = 12544, oversample_ratio: float = 3.0,
                  importance_sample_ratio: float = 0.75, cost_class: float = 1.0,
                  cost_mask: float = 1.0, cost_dice: float = 1.0, dense_masks: bool = False,
                  exact_match: bool = True, match_mode: Optional[str] = None,
                  matched_override: Optional[torch.Tensor] = None,
                  point_coords_override: Optional[Sequence[torch.Tensor]] = None,
                  impl: str = "auto", return_aux: bool = False, batch_sum=None,
                  share: Optional[Tuple[int, int]] = None):
    """The full criterion with the aux levels (criterion_ins.py:224-278).

    Without ``matched_override`` [L, B, G] the costs of all levels are
    computed first and assigned at once by ``match_mode`` (``exact_match``
    False: 'greedy'): 'exact' in one host pass, 'greedy' and 'auction' on
    the device. ``dense_masks`` takes the mask losses over the whole masks
    (``criterion_losses``). ``point_coords_override`` [L, B*G, P, 2]
    evaluates the mask losses at given PointRend coords. With
    ``return_aux`` also returns {'matched': [L, B, G], 'point_coords':
    [L, B*G, P, 2], or None with ``dense_masks``}, what this call used.

    Data parallelism: ``outputs`` and ``targets`` are this rank's rows,
    ``share`` = (i, k) its share of the global batch (the random points are
    the global draw's rows of it) and ``batch_sum`` sums over the ranks, so
    ``num_masks`` and every normaliser are the global batch's (JAX keeps the
    targets replicated, set_criterion.py:437); each rank matches its own
    rows."""
    levels = _levels(outputs)
    if matched_override is None:
        mode = match_mode or ("exact" if exact_match else "greedy")
        costs = set_criterion_costs(outputs, targets, key, num_points, cost_class, cost_mask,
                                    cost_dice, impl=impl, share=share)
        matched_override = hungarian_match(costs, mode=mode)
    num_masks = _summed(targets.valid.float().sum(), batch_sum).clamp(min=1.0)
    losses, used = {}, []
    for li, out in enumerate(levels):
        dev = out["pred_masks"].device
        override = None if point_coords_override is None else point_coords_override[li]
        level_losses, coords = criterion_losses(
            out["pred_logits"], out["pred_masks"], targets, matched_override[li].to(dev),
            level_generator(key, li, 1, dev), num_classes, num_masks, eos_coef, num_points,
            oversample_ratio, importance_sample_ratio, dense_masks, point_coords_override=override, impl=impl,
            batch_sum=batch_sum, share=share)
        suffix = "" if li == 0 else f"_{li - 1}"
        losses.update({k + suffix: v for k, v in level_losses.items()})
        used.append(coords)
    if return_aux:
        return losses, {"matched": matched_override, "point_coords": None if dense_masks else torch.stack(used)}
    return losses


def targets_from_semantic_labels(label_map: torch.Tensor, num_classes: int,
                                 ignore_index: int = 255) -> SegTargets:
    """Per-class binary masks of a label map (criterion_seg.py
    SetCriterion._get_targets:271-279); classes absent from an image are
    padding."""
    b, h, w = label_map.shape
    classes = torch.arange(num_classes, device=label_map.device)
    masks = (label_map[:, None, :, :] == classes[None, :, None, None]).float()
    valid = masks.sum(dim=(2, 3)) > 0
    labels = classes[None].expand(b, num_classes).to(torch.int32)
    return SegTargets(labels=labels, masks=masks, valid=valid)
