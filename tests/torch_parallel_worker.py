"""One rank of a parallel run of the port on the CPU, over gloo, for
tests/test_torch_parallel*.py. It imports torch and the port, never jax.

    python -m tests.torch_parallel_worker JOB RANK WORLD PORT

JOB is a ``torch.save``d dict written by the test (``kind`` 'pretrain',
'downstream' or 'restore', the config's keyword arguments, the full
weights, the global batch and each step's injected masks, matches and
points; ``dropout`` True trains the downstream step with dropout on); rank 0 writes the result to ``JOB + '.out'``: each step's metrics
and the weights after the steps, gathered into the one-device layout.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from incomplete_multimodal_fusion_tpu_torch import config as tconfig
from incomplete_multimodal_fusion_tpu_torch.losses.set_criterion import SegTargets
from incomplete_multimodal_fusion_tpu_torch.models import maskformer as tmf
from incomplete_multimodal_fusion_tpu_torch.ops import masking as tmask
from incomplete_multimodal_fusion_tpu_torch.parallel import dist as pdist
from incomplete_multimodal_fusion_tpu_torch.parallel.mesh import downstream_layout, make_layout, shard_rows
from incomplete_multimodal_fusion_tpu_torch.train import downstream as tds
from incomplete_multimodal_fusion_tpu_torch.train import pretrain as tpretrain
from incomplete_multimodal_fusion_tpu_torch.utils import checkpoint as ckpt_lib


def pretrain_config(c):
    """The PretrainConfig of the job's keyword dict."""
    return tconfig.PretrainConfig(
        model=tconfig.ModelConfig(**c["model"]), data=tconfig.DataConfig(**c["data"]),
        mask=tconfig.MaskConfig(**c["mask"]), decoder=tconfig.DecoderConfig(**c["decoder"]),
        optim=tconfig.OptimConfig(**c["optim"]), train=tconfig.TrainConfig(**c["train"]))


def run_pretrain(job, layout):
    cfg = pretrain_config(job["cfg"])
    model, state, _ = tpretrain.create_train_state(cfg, 0, job["total_steps"], device="cpu", layout=layout)
    full = {k: torch.as_tensor(v) for k, v in job["params"].items()}
    with torch.no_grad():
        for name, t in state.parallel.shard(full).items() if state.parallel else full.items():
            model.get_parameter(name).copy_(t)
    step = tpretrain.make_train_step(model, cfg, state.optimizer, layout=layout)
    domains = tuple(cfg.data.in_domains)
    n = cfg.data.num_patches
    global_b = job["batch"][domains[0]].shape[0]
    rows = slice(None) if layout is None else layout.rows(global_b)
    batch = {d: torch.from_numpy(np.asarray(v)[rows]) for d, v in job["batch"].items()}
    metrics = []
    for flat in job["flats"]:
        mi = tmask.mask_info_from_flat_mask(torch.from_numpy(flat[rows]), domains, (n,) * len(domains),
                                            cfg.mask.num_encoded_tokens)
        state, m = step(state, batch, mask_info=mi)
        metrics.append({k: float(v) for k, v in m.items()})
    if job.get("ckpt_dir"):
        ckpt_lib.save_checkpoint(job["ckpt_dir"], state.step, state)
    params = state.parallel.gather(dict(model.named_parameters())) if state.parallel else \
        dict(model.named_parameters())
    return {"metrics": metrics, "params": {k: v.detach().clone() for k, v in params.items()}}


def run_restore(job, layout):
    """Restores ``ckpt_dir``'s checkpoint into a fresh state of this layout
    and saves it again into ``out_dir``."""
    cfg = pretrain_config(job["cfg"])
    _, state, _ = tpretrain.create_train_state(cfg, 1, job["total_steps"], device="cpu", layout=layout)
    ckpt_lib.restore_checkpoint(job["ckpt_dir"], state)
    ckpt_lib.save_checkpoint(job["out_dir"], state.step, state)
    return {"step": state.step}


def run_downstream(job, layout):
    cfg = tmf.MaskFormerConfig(**job["cfg"])
    model = tmf.build_maskformer(cfg, device="cpu")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in job["params"].items()}, strict=True)
    opt = tds.create_downstream_optimizer(model, lr=job["lr"], clip_grad=0.01, frozen_stages=cfg.frozen_stages,
                                          layout=layout)
    step = tds.make_downstream_train_step(model, cfg, opt, num_points=job["num_points"], compute_dtype="float32",
                                          layout=layout)
    state = tds.DownstreamState(model, opt, torch.Generator().manual_seed(0))
    domains = tuple(cfg.in_domains)
    n = cfg.num_patches
    b = job["batch"][domains[0]].shape[0]
    rows = layout.rows(b)
    batch = {d: torch.from_numpy(np.asarray(v)[rows]) for d, v in job["batch"].items()}
    targets = SegTargets(*(torch.from_numpy(np.asarray(a)[rows]) for a in job["targets"]))
    metrics = []
    for present, flat, matched, coords in job["steps"]:
        mi = tmask.mask_info_from_flat_mask(torch.from_numpy(flat), domains, (n,) * len(domains), len(domains) * n)
        g = matched.shape[-1]
        local_coords = coords.reshape(coords.shape[0], b, g, *coords.shape[2:])[:, rows]
        state, m = step(state, batch, targets, torch.from_numpy(matched[:, rows]), mask_info=shard_rows(mi, rows),
                        present=torch.from_numpy(present),
                        point_coords_override=torch.from_numpy(local_coords.reshape(coords.shape[0], -1,
                                                                                    *coords.shape[2:])),
                        deterministic=not job.get("dropout", False))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": {k: v.detach().clone() for k, v in model.named_parameters()}}


def run_mesh_and_comm(job, _layout):
    """The meshes, ``collect_results`` and each collective of
    parallel/comm.py, forward and backward, against the same sums computed
    from every rank's inputs (f64). Rank r's loss is <y_r, dy_r>, so the
    gradient each op's backward gives x_r is that of the sum over ranks.
    Returns {check: flag} and {op: (forward error, gradient error)}."""
    import torch.distributed as dist

    from incomplete_multimodal_fusion_tpu_torch.parallel import comm, mesh

    world, rank = dist.get_world_size(), dist.get_rank()
    flags = {"collect_results": pdist.collect_results(rank) == list(range(world)),
             "data_parallel_mesh": tuple(mesh.data_parallel_mesh().mesh.shape) == (world,),
             "make_mesh -1": tuple(mesh.make_mesh((-1, 2), ("data", "model")).mesh.shape) == (world // 2, 2),
             "hybrid_mesh": tuple(mesh.hybrid_mesh((1, 2), local_world_size=world).mesh.shape) == (world // 2, 2)}

    def drawn(r):
        g = torch.Generator().manual_seed(100 + r)
        return [torch.randn(2, 2 * world, 3, generator=g, dtype=torch.float64) for _ in range(2)]

    xs, dys = zip(*(drawn(r) for r in range(world)))

    def shard(t, r):
        return t.chunk(world, dim=1)[r]

    gathered_x = torch.cat([shard(xs[s], s) for s in range(world)], dim=1)
    gathered_dy = torch.cat([shard(dys[s], s) for s in range(world)], dim=1)
    cases = {  # op: (x_r, dy_r, the forward, the gradient)
        "copy": (xs[rank], dys[rank], xs[rank], sum(dys)),
        "reduce": (xs[rank], dys[rank], sum(xs), dys[rank]),
        "gather": (shard(xs[rank], rank), dys[rank], gathered_x, shard(sum(dys), rank)),
        "unsplit": (shard(xs[rank], rank), dys[rank], gathered_x, shard(dys[rank], rank)),
        "scatter": (xs[rank], shard(dys[rank], rank), shard(sum(xs), rank), gathered_dy),
        "split": (xs[rank], shard(dys[rank], rank), shard(xs[rank], rank), gathered_dy),
    }
    errors = {}
    for op, (x, dy, fwd, grad) in cases.items():
        x = x.clone().requires_grad_(True)
        y = comm.collective(x, op, dist.group.WORLD)
        y.backward(dy)
        errors[op] = (float((y.detach() - fwd).abs().max()), float((x.grad - grad).abs().max()))
    return {"flags": flags, "errors": errors}


def main(argv) -> int:
    path, rank, world, port = argv[0], int(argv[1]), int(argv[2]), int(argv[3])
    job = torch.load(path, weights_only=False)
    pdist.init_distributed_mode("cpu", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    try:
        if job["kind"] == "comm":
            out = run_mesh_and_comm(job, None)
        elif job["kind"] == "downstream":
            layout = downstream_layout(job["batch"][job["cfg"]["in_domains"][0]].shape[0])
            out = run_downstream(job, layout)
        else:
            layout = make_layout(**job["layout"]) if world > 1 or job.get("layout") else None
            out = (run_restore if job["kind"] == "restore" else run_pretrain)(job, layout)
        if rank == 0:
            torch.save(out, path + ".out")
    finally:
        pdist.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
