"""Pipeline parallelism: GPipe microbatch pipelining of a block stack over
the ``stage`` ranks (JAX package parallel/pipeline.py).

Stage s holds layers s·L/S … (s+1)·L/S − 1 (``stage_layers``). The batch is
cut into M microbatches (default S) and the schedule runs M + S − 1 ticks:
at tick t stage s runs microbatch t − s on its layers, receiving its input
from stage s − 1 and sending its output to stage s + 1 (``send`` /
``recv``). The last stage's outputs are broadcast to every stage, as JAX's
``psum`` of them replicates them, so every stage runs what follows the
trunk on the same values. The backward runs the ticks in reverse: stage s
backpropagates microbatch t − (S − 1 − s) through its own graph of that
microbatch and sends the input's gradient to stage s − 1; stage 0's input
gradient is broadcast back to every stage, and the gradients of the
replicated context (``pipeline_apply``'s differentiable ``aux``) are summed
over the stages. The numbers equal the sequential block loop's.

The layer-constant per-example context (``aux``) is replicated to every
stage, never sent: an entry whose leading axis is the batch's is cut per
microbatch, any other is passed whole.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.distributed as dist


def stage_layers(depth: int, stages: int, stage: int) -> range:
    """The layers stage ``stage`` of ``stages`` holds (GPipe's contiguous
    groups, JAX ``stack_stage_params``)."""
    if depth % stages:
        raise ValueError(f"{depth} blocks do not divide {stages} stages")
    per = depth // stages
    return range(stage * per, (stage + 1) * per)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, group, microbatches: int, fixed: Dict, names: Tuple[str, ...], x, *diff):
        s, size = dist.get_rank(group), dist.get_world_size(group)
        prev = dist.get_global_rank(group, s - 1) if s > 0 else None
        nxt = dist.get_global_rank(group, s + 1) if s < size - 1 else None
        m = microbatches or size
        b = x.shape[0]
        if b % m:
            raise ValueError(f"batch {b} does not divide {m} microbatches")
        xs = x.chunk(m)
        leaves = [d.detach().requires_grad_(d.requires_grad) for d in diff]
        records: List = [None] * m
        outs: List = [None] * m
        with torch.enable_grad():
            for t in range(m + size - 1):
                j = t - s
                if not 0 <= j < m:
                    continue
                if s == 0:
                    inp = xs[j].detach()
                else:
                    inp = torch.empty_like(xs[j])
                    dist.recv(inp, prev, group=group)
                inp.requires_grad_(x.requires_grad or s > 0)
                aux = {k: _cut(v, b, m, j) for k, v in fixed.items()}
                aux.update({k: _cut(v, b, m, j) for k, v in zip(names, leaves)})
                out = stage_fn(inp, aux)
                records[j] = (inp, out)
                if nxt is not None:
                    dist.send(out.detach().contiguous(), nxt, group=group)
                else:
                    outs[j] = out.detach()
        ys = torch.cat(outs) if nxt is None else torch.empty_like(x)
        dist.broadcast(ys, dist.get_global_rank(group, size - 1), group=group)
        ctx.state = (group, m, records, leaves, prev, nxt)
        return ys

    @staticmethod
    def backward(ctx, dys):
        group, m, records, leaves, prev, nxt = ctx.state
        s, size = dist.get_rank(group), dist.get_world_size(group)
        dys = dys.contiguous()
        dy_mb = dys.chunk(m)
        dxs: List = [None] * m
        for t in range(m + size - 1):
            j = t - (size - 1 - s)
            if not 0 <= j < m:
                continue
            inp, out = records[j]
            if nxt is None:
                g = dy_mb[j]
            else:
                g = torch.empty_like(out)
                dist.recv(g, nxt, group=group)
            torch.autograd.backward(out, g)
            records[j] = None
            dx = inp.grad if inp.grad is not None else torch.zeros_like(inp)
            if prev is not None:
                dist.send(dx.contiguous(), prev, group=group)
            else:
                dxs[j] = dx
        dx = torch.cat(dxs) if prev is None else torch.empty_like(dys)
        dist.broadcast(dx, dist.get_global_rank(group, 0), group=group)
        daux = []
        for leaf in leaves:
            g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
            dist.all_reduce(g, group=group)
            daux.append(g)
        ctx.state = None
        return (None, None, None, None, None, dx, *daux)


def _cut(v: torch.Tensor, b: int, m: int, j: int) -> torch.Tensor:
    """Microbatch j's rows of a per-example tensor; a shared one whole."""
    return v.chunk(m)[j] if v.dim() > 0 and v.shape[0] == b else v


def pipeline_apply(stage_fn: Callable, x: torch.Tensor, aux: Dict[str, torch.Tensor], group,
                   microbatches: int = 0) -> torch.Tensor:
    """Runs ``x`` [B, ...] through every stage's layers, pipelined over the
    ranks of ``group``: ``stage_fn(x_mb, aux_mb) -> y_mb`` runs this rank's
    layers (shape-preserving). ``aux`` entries that require a gradient get
    it back through the pipeline (summed over the stages). Returns [B, ...]
    on every stage; differentiable."""
    names = tuple(k for k, v in aux.items() if v.requires_grad)
    fixed = {k: v for k, v in aux.items() if not v.requires_grad}
    return _Pipeline.apply(stage_fn, group, microbatches, fixed, names, x, *(aux[k] for k in names))
