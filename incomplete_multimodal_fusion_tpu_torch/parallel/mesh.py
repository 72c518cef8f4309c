"""Device meshes over the ranks, and the layout a training step runs on
(JAX package parallel/mesh.py and scripts/pretrain.py:167-188).

``make_mesh(shape, axes)`` is ``init_device_mesh`` over the world, one
``-1`` taking the remaining ranks. ``hybrid_mesh`` puts the data axis across
nodes and the other axes within a node; torchrun numbers a node's ranks
contiguously, so that is the flat mesh of the same shape once the inner
axes fit in a node (the JAX package's single-slice case is the same flat
mesh).

``Layout`` is what a step needs of the mesh: the process group and this
rank's place on each axis (``data``, ``model``, ``stage``), and the modes
on top of it (sequence parallel, ZeRO, the pipeline's microbatches). A rank
holds batch rows ``dp_rank * b ... (dp_rank + 1) * b - 1`` of the global
batch.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type() -> str:
    """The mesh's device type: 'cuda' under NCCL, else 'cpu' (gloo groups,
    which also take CUDA tensors)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Tuple[int, ...] = (-1,), axes: Tuple[str, ...] = ("data",)) -> DeviceMesh:
    """A mesh of ``shape`` over every rank; a single -1 takes the rest."""
    n = dist.get_world_size()
    shape = list(shape)
    if shape.count(-1) > 1:
        raise ValueError(f"make_mesh: at most one -1 in {tuple(shape)}")
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        shape[shape.index(-1)] = n // known
    if math.prod(shape) != n:
        raise ValueError(f"make_mesh: mesh {tuple(shape)} != {n} ranks")
    return init_device_mesh(_device_type(), tuple(shape), mesh_dim_names=tuple(axes))


def data_parallel_mesh() -> DeviceMesh:
    return make_mesh((-1,), ("data",))


def hybrid_mesh(ici_shape: Tuple[int, ...], axes: Tuple[str, ...] = ("data", "model"),
                local_world_size: Optional[int] = None) -> DeviceMesh:
    """The data axis across nodes, the other axes within one (JAX
    mesh.py:42-72). ``ici_shape`` gives the extent of the axes within a
    node (its leading entry multiplies the data axis there);
    ``local_world_size`` defaults to torchrun's ``LOCAL_WORLD_SIZE``."""
    inner = math.prod(ici_shape[1:])
    local = local_world_size or int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    if local % inner:
        raise ValueError(f"hybrid_mesh: the inner axes {tuple(ici_shape[1:])} do not fit a node of {local} ranks")
    return make_mesh((-1,) + tuple(ici_shape[1:]), axes)


@dataclass(frozen=True)
class Layout:
    """A step's place in the mesh: each axis's group (None where the mesh
    has no such axis) and extent and this rank's index on it, and the modes:
    ``sp`` (the residual stream token-sharded over ``model``), ``fsdp``
    (FlatAdamW's flat vectors sharded over ``data``), ``microbatches`` (the
    pipelined trunk's, 0 = one a stage; the trunk is pipelined when ``pp`` >
    1 or ``microbatches`` > 0)."""

    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None
    stage_group: Optional[dist.ProcessGroup] = None
    dp: int = 1
    tp: int = 1
    pp: int = 1
    dp_rank: int = 0
    tp_rank: int = 0
    pp_rank: int = 0
    sp: bool = False
    fsdp: bool = False
    microbatches: int = 0
    backend: str = "none"

    @property
    def pipelined(self) -> bool:
        return self.stage_group is not None and (self.pp > 1 or self.microbatches > 0)

    @property
    def tensor_parallel(self) -> bool:
        return self.model_group is not None and self.tp > 1

    @property
    def sequence_parallel(self) -> bool:
        return self.sp and self.tensor_parallel

    def rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch."""
        if global_batch % self.dp:
            raise ValueError(f"a global batch of {global_batch} does not divide {self.dp} data ranks")
        b = global_batch // self.dp
        return slice(self.dp_rank * b, (self.dp_rank + 1) * b)


def check_parallel_flags(n: int, tp: int = 1, pp: int = 1, sp: bool = False) -> None:
    """The JAX script's refusals of its parallel flags over ``n`` devices
    (scripts/pretrain.py:169-178), with its words; ValueError."""
    if n % tp:
        raise ValueError(f"--tp {tp} does not divide {n} devices")
    if sp and tp == 1:
        raise ValueError("--sp needs --tp > 1 (nothing to shard tokens over)")
    if pp > 1 and (tp > 1 or sp):
        raise ValueError("--pp excludes --tp/--sp (PP composes with DP only)")
    if pp > 1 and n % pp:
        raise ValueError(f"--pp {pp} does not divide {n} devices")


def make_layout(tp: int = 1, pp: int = 1, sp: bool = False, fsdp: bool = False, microbatches: int = 0) -> Layout:
    """The layout over the running process group: a (data, stage) mesh for
    the pipeline (``pp`` > 1 or ``microbatches`` > 0), a (data, model) mesh
    for tensor or sequence parallelism, else a data mesh, the data axis
    taking the ranks the other axes leave. The JAX script's refusals
    (scripts/pretrain.py:169-178) raise ValueError."""
    check_parallel_flags(dist.get_world_size(), tp, pp, sp)
    if pp > 1 or microbatches > 0:
        mesh = make_mesh((-1, pp), ("data", "stage"))
    elif tp > 1:
        mesh = make_mesh((-1, tp), ("data", "model"))
    else:
        mesh = make_mesh((-1,), ("data",))
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    groups = {a: mesh.get_group(a) for a in names}
    size = dict(zip(names, mesh.mesh.shape))
    at = dict(zip(names, coord))
    return Layout(
        data_group=groups.get("data"), model_group=groups.get("model"), stage_group=groups.get("stage"),
        dp=size.get("data", 1), tp=size.get("model", 1), pp=size.get("stage", 1),
        dp_rank=at.get("data", 0), tp_rank=at.get("model", 0), pp_rank=at.get("stage", 0),
        sp=sp, fsdp=fsdp, microbatches=microbatches, backend=dist.get_backend())


def downstream_layout(batch_size: int) -> Layout:
    """The downstream step's data mesh over ``gcd(batch_size, world)`` ranks
    (scripts/train_downstream.py:249-252); the ranks past it sit out the
    step (a Layout with no group, dp_rank -1) so no rank ever holds a
    fraction of a row."""
    n = dist.get_world_size()
    use = math.gcd(batch_size, n)
    group = dist.new_group(list(range(use)))
    rank = dist.get_rank()
    if rank >= use:
        return Layout(dp=use, dp_rank=-1, backend=dist.get_backend())
    return Layout(data_group=group, dp=use, dp_rank=rank, backend=dist.get_backend())


def shard_rows(tree, rows: slice):
    """Each array or tensor of a (nested) batch cut to ``rows`` on its first
    axis; other leaves as they are."""
    if isinstance(tree, dict):
        return {k: shard_rows(v, rows) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "shape"):
        out = [shard_rows(v, rows) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    if hasattr(tree, "shape") and len(tree.shape) > 0:
        return tree[rows]
    return tree


def check_capturable(layout: Optional[Layout]) -> None:
    """A CUDA graph captures NCCL's collectives and no other backend's:
    raises for a layout whose collectives cannot be captured."""
    if layout is not None and layout.backend not in ("nccl", "none"):
        raise RuntimeError(f"make_multi_step: the {layout.backend} backend's collectives cannot be captured "
                           "in a CUDA graph; run with --steps_per_call 1 or on NCCL")
