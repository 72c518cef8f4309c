"""Dirichlet token-budget masking with a fixed packed layout (JAX package
ops/masking.py; reference multimae_crossattn.py:205-278).

Every forward uses ``num_encoded_tokens`` packed slots:

  * ``order``       [B, N]  permutation putting visible tokens first, in
                            ascending global index (grouped by modality, the
                            reference's cat order);
  * ``ids_restore`` [B, N]  inverse of ``order``;
  * ``num_visible`` [B]     how many packed slots are real; later slots are
                            padding, excluded everywhere by masks;
  * ``task_masks``  {task: [B, N_t]} 1 = masked, 0 = visible.

The sort key ``mask * N + index`` is unique, so ``order`` and
``ids_restore`` equal the JAX package's exactly. Random masks come from a
``torch.Generator``; they follow the JAX sampler's steps but not its bits.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, NamedTuple, Sequence, Tuple

import torch


class MaskInfo(NamedTuple):
    task_masks: Dict[str, torch.Tensor]  # {task: [B, N_t]} int64, 1=masked
    order: torch.Tensor  # [B, N] int64; order[:, :E] indexes visible tokens
    ids_restore: torch.Tensor  # [B, N] int64, inverse of order
    num_visible: torch.Tensor  # [B] int64, <= num_encoded_tokens


def _log_gamma_sample(alpha: float, generator: torch.Generator) -> float:
    """log of one Gamma(alpha, 1) draw (Marsaglia-Tsang; alpha < 1 through
    Gamma(alpha + 1) * U**(1/alpha), kept in log space so tiny alphas do not
    underflow)."""
    boost = 0.0
    if alpha < 1.0:
        u = torch.rand((), generator=generator, dtype=torch.float64).item()
        boost = math.log(max(u, 1e-300)) / alpha
        alpha += 1.0
    d = alpha - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        x = torch.randn((), generator=generator, dtype=torch.float64).item()
        v = (1.0 + c * x) ** 3
        if v <= 0.0:
            continue
        u = torch.rand((), generator=generator, dtype=torch.float64).item()
        if math.log(max(u, 1e-300)) < 0.5 * x * x + d - d * v + d * math.log(v):
            return math.log(d * v) + boost


def _dirichlet(alphas: Sequence[float], generator: torch.Generator) -> torch.Tensor:
    logs = torch.tensor([_log_gamma_sample(float(a), generator) for a in alphas],
                        dtype=torch.float64)
    return torch.softmax(logs, dim=0).float()


def _single_random_mask(
    generator: torch.Generator,
    num_tokens_per_task: Sequence[int],
    num_encoded_tokens: int,
    alphas,
    sample_tasks_uniformly: bool,
) -> torch.Tensor:
    """One [N] 0/1 mask with exactly num_encoded_tokens zeros."""
    n_tasks = len(num_tokens_per_task)
    total = int(sum(num_tokens_per_task))
    if isinstance(alphas, (int, float)):
        alphas_vec = [float(alphas)] * n_tasks
    else:
        alphas_vec = [float(a) for a in alphas]
    if sample_tasks_uniformly:
        # reference sample_alphas (multimae_crossattn.py:188-203): pick a
        # non-empty task subset uniformly, Dirichlet over the chosen subset
        combos = [list(c) for c in itertools.product([0, 1], repeat=n_tasks)][1:]
        idx = int(torch.randint(len(combos), (), generator=generator))
        alphas_vec = [c * a + 1e-5 for c, a in zip(combos[idx], alphas_vec)]
    dist = _dirichlet(alphas_vec, generator)  # [T]
    samples_per_task = torch.round(dist * num_encoded_tokens).long()

    # per-task random keep of samples_per_task[t] tokens
    # (multimae_crossattn.py:236-247): shuffle, keep where rank < budget
    parts = []
    for t, n_t in enumerate(num_tokens_per_task):
        noise = torch.rand(n_t, generator=generator)
        rank = torch.argsort(torch.argsort(noise))
        parts.append((rank >= samples_per_task[t]).long())
    mask_all = torch.cat(parts)  # [N]

    # exactly E visible (multimae_crossattn.py:264-272): random within the
    # {visible, masked} groups, the first E become visible
    tie = torch.rand(total, generator=generator)
    ids_shuffle = torch.argsort(mask_all.float() + tie)
    ids_restore = torch.argsort(ids_shuffle)
    flags = (torch.arange(total) >= num_encoded_tokens).long()
    return flags[ids_restore]


def generate_random_masks(
    generator: torch.Generator,
    task_names: Tuple[str, ...],
    num_tokens_per_task: Tuple[int, ...],
    num_encoded_tokens: int,
    batch_size: int,
    alphas=1.0,
    sample_tasks_uniformly: bool = False,
    batch_shared: bool = True,
    device=None,
) -> MaskInfo:
    """Dirichlet task-budget masks, exactly ``num_encoded_tokens`` visible.

    The sampling runs on the host from ``generator`` (a CPU generator);
    the result lands on ``device``."""
    def one():
        return _single_random_mask(generator, num_tokens_per_task, num_encoded_tokens,
                                   alphas, sample_tasks_uniformly)

    if batch_shared:
        mask = one()[None].expand(batch_size, -1)
    else:
        mask = torch.stack([one() for _ in range(batch_size)])
    return mask_info_from_flat_mask(mask.to(device), task_names, num_tokens_per_task,
                                    num_encoded_tokens)


def mask_info_from_flat_mask(
    mask_all: torch.Tensor,
    task_names: Tuple[str, ...],
    num_tokens_per_task: Tuple[int, ...],
    num_encoded_tokens: int,
) -> MaskInfo:
    """Packed-layout bookkeeping from a [B, N] 0/1 mask."""
    b, n = mask_all.shape
    mask_all = mask_all.long()
    # visible first, ascending global index; the key is unique, so the sort
    # is exact whatever algorithm sorts it
    sort_key = mask_all * n + torch.arange(n, device=mask_all.device)[None, :]
    order = torch.argsort(sort_key, dim=1)
    ids_restore = torch.argsort(order, dim=1)
    num_visible = (mask_all == 0).sum(dim=1).clamp(max=num_encoded_tokens)
    task_masks = dict(zip(task_names, torch.split(mask_all, list(num_tokens_per_task), dim=1)))
    return MaskInfo(task_masks, order, ids_restore, num_visible)


def mask_info_from_task_masks(
    task_masks: Dict[str, torch.Tensor],
    task_names: Tuple[str, ...],
    num_encoded_tokens: int,
) -> MaskInfo:
    """User-supplied masks (reference multimae_crossattn.py:395-399; a task
    mask of all ones drops the modality, infer_mmae.py:344-361). Any number
    of visible tokens <= num_encoded_tokens packs; extra slots are padding."""
    mask_all = torch.cat([task_masks[t] for t in task_names], dim=1)
    nums = tuple(task_masks[t].shape[1] for t in task_names)
    return mask_info_from_flat_mask(mask_all, task_names, nums, num_encoded_tokens)


def _single_incomplete_mask(
    generator: torch.Generator,
    num_tokens_per_task: Sequence[int],
    present: torch.Tensor,  # [T] float
    keep_ratio: float,
    alphas: float,
) -> torch.Tensor:
    """One [N] 0/1 keep-mask over the present modalities: floor(keep_ratio *
    present tokens) visible, Dirichlet-split over the present tasks."""
    n_tasks = len(num_tokens_per_task)
    total = int(sum(num_tokens_per_task))
    pres = [float(p) for p in present.tolist()]
    dist = _dirichlet([alphas * p + 1e-6 for p in pres], generator) * present
    dist = dist / dist.sum().clamp(min=1e-6)
    e_dyn = int(math.floor(keep_ratio * sum(n * p for n, p in zip(num_tokens_per_task, pres))))
    samples = torch.round(dist * e_dyn).long()

    parts, absent_parts = [], []
    for t, n_t in enumerate(num_tokens_per_task):
        noise = torch.rand(n_t, generator=generator)
        rank = torch.argsort(torch.argsort(noise))
        keep = (rank < samples[t]) & (pres[t] > 0)
        parts.append((~keep).long())
        absent_parts.append(torch.full((n_t,), 1.0 - pres[t]))
    mask_all = torch.cat(parts)
    absent = torch.cat(absent_parts)

    # exact count: absent tokens sort last, so they are never made visible
    tie = torch.rand(total, generator=generator)
    ids_shuffle = torch.argsort(mask_all.float() + 10.0 * absent + tie)
    ids_restore = torch.argsort(ids_shuffle)
    flags = (torch.arange(total) >= e_dyn).long()
    return flags[ids_restore]


def incomplete_random_masks(
    generator: torch.Generator,
    task_names: Tuple[str, ...],
    num_tokens_per_task: Tuple[int, ...],
    present: torch.Tensor,  # [T] bool, the modalities this step has
    num_encoded_tokens: int,  # static packed size, >= the most that can be visible
    batch_size: int,
    keep_ratio: float = 0.9,
    alphas: float = 1.0,
    batch_shared: bool = True,
    device=None,
) -> MaskInfo:
    """Downstream train-time masking (multimae_big_imcomplete.py:542-594): of
    the ``present`` modalities, floor(keep_ratio * their tokens) stay visible
    by Dirichlet budgeting; absent modalities are fully masked; the packed
    layout pads to ``num_encoded_tokens``. ``batch_shared`` (the reference's
    quirk) draws one mask for the whole batch, else one per sample. Drawn on
    the host from ``generator``; the result lands on ``device``."""
    present = present.detach().to("cpu", torch.float32)

    def one():
        return _single_incomplete_mask(generator, num_tokens_per_task, present, keep_ratio, alphas)

    if batch_shared:
        mask = one()[None].expand(batch_size, -1)
    else:
        mask = torch.stack([one() for _ in range(batch_size)])
    return mask_info_from_flat_mask(mask.to(device), task_names, num_tokens_per_task,
                                    num_encoded_tokens)


def sample_modality_subset(generator: torch.Generator, n_tasks: int) -> torch.Tensor:
    """``random.randint(1, T); random.sample(domains, k)``
    (multimae_big_imcomplete.py:542-548) as a [T] bool vector, on the host."""
    k = int(torch.randint(1, n_tasks + 1, (), generator=generator))
    rank = torch.argsort(torch.argsort(torch.rand(n_tasks, generator=generator)))
    return rank < k


def full_visible_mask_info(
    task_names: Tuple[str, ...],
    num_tokens_per_task: Tuple[int, ...],
    batch_size: int,
    device=None,
) -> MaskInfo:
    """No masking: every token visible; num_encoded_tokens == N_total."""
    total = int(sum(num_tokens_per_task))
    masks = {
        t: torch.zeros((batch_size, n), dtype=torch.long, device=device)
        for t, n in zip(task_names, num_tokens_per_task)
    }
    return mask_info_from_task_masks(masks, task_names, total)



def make_mask(
    n_h: int,
    n_w: int,
    xy_idxs: Dict[str, Sequence[Tuple[int, int]]],
    full_tasks: Sequence[str] = (),
    indicate_visible: bool = True,
) -> Dict[str, torch.Tensor]:
    """Per-task [1, n_h * n_w] int64 masks (on the CPU) from (x, y) lists of visible
    patches (reference make_mask, multimae_crossattn.py:280-308): 1 = masked,
    0 = visible; every patch of a task in ``full_tasks`` visible; with
    ``indicate_visible=False`` the bits are flipped (1 = visible)."""
    task_masks = {}
    for k, coords in xy_idxs.items():
        m = torch.ones((n_h, n_w), dtype=torch.long)
        for (x, y) in coords:
            m[y, x] = 0
        task_masks[k] = m
    for task in full_tasks:
        task_masks[task][:] = 0
    if not indicate_visible:
        task_masks = {k: 1 - v for k, v in task_masks.items()}
    return {k: v.reshape(1, -1) for k, v in task_masks.items()}
