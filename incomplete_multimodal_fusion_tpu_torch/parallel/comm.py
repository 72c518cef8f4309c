"""Collectives as autograd functions, each the transpose of its pair, for
tensor, sequence and data parallelism on local shards (Megatron's f / g and
their sequence-parallel forms).

    op              forward            backward
    copy            identity           all-reduce      column-parallel input (f)
    reduce          all-reduce         identity        row-parallel output (g); batch sums
    gather          all-gather         reduce-scatter  sharded stream into a column-parallel product
    scatter         reduce-scatter     all-gather      row-parallel output back onto the stream
    split           my slice           all-gather      replicated stream onto its shard
    unsplit         all-gather         my slice        shard back to a replicated stream

``torch.distributed.nn.functional.all_reduce`` all-reduces in its backward
too, which would multiply a replicated gradient by the group's size; these
do not. Gathers and scatters run along ``dim`` (the token axis, 1). Every
op is the identity where ``group`` is None.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(x, group=group)
    return x


def all_gather_flat(x: torch.Tensor, group) -> torch.Tensor:
    """[n] on each rank -> [size * n], in rank order."""
    out = x.new_empty((dist.get_world_size(group) * x.numel(),))
    dist.all_gather_into_tensor(out, x.contiguous().reshape(-1), group=group)
    return out


def reduce_scatter_flat(x: torch.Tensor, group) -> torch.Tensor:
    """[size * n] on each rank -> the sum's n-slice of this rank."""
    out = x.new_empty((x.numel() // dist.get_world_size(group),))
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    size = dist.get_world_size(group)
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((size * moved.shape[0],) + moved.shape[1:])
    dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, dim)


def _scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    size = dist.get_world_size(group)
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((moved.shape[0] // size,) + moved.shape[1:])
    dist.reduce_scatter_tensor(out, moved, group=group)
    return out.movedim(0, dim)


def _split(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    return x.chunk(size, dim=dim)[rank].contiguous()


def _reduce(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


def _identity(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x


_PAIRS = {
    "copy": (_identity, _reduce),
    "reduce": (_reduce, _identity),
    "gather": (_gather, _scatter),
    "scatter": (_scatter, _gather),
    "split": (_split, _gather),
    "unsplit": (_gather, _split),
}


class _Collective(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op: str, group, dim: int):
        ctx.op, ctx.group, ctx.dim = op, group, dim
        return _PAIRS[op][0](x, group, dim)

    @staticmethod
    def backward(ctx, dy):
        return _PAIRS[ctx.op][1](dy, ctx.group, ctx.dim), None, None, None


def collective(x: torch.Tensor, op: str, group: Optional[dist.ProcessGroup], dim: int = 1) -> torch.Tensor:
    """``op`` of the table above over ``group``; ``x`` itself where there is
    no group."""
    if group is None:
        return x
    if op not in _PAIRS:
        raise ValueError(f"collective: op must be one of {sorted(_PAIRS)}, got {op!r}")
    return _Collective.apply(x, op, group, dim)


def batch_sum(group: Optional[dist.ProcessGroup]):
    """The batch-wide sum over ``group``'s ranks as a function of a local
    sum: all-reduce forward, identity backward, so every rank computes the
    global loss and its gradient reaches only its own rows. None without a
    group (the one-device losses)."""
    if group is None:
        return None
    return lambda x: collective(x, "reduce", group)
