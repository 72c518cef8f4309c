"""Time the default eager pretraining step (PretrainConfig(): B = 60, bf16
compute over f32 masters) in several source trees, one after another on one
card, to compare a change with its parent within one call.

    python3 tools/compare_train_step.py PARENT_DIR CHANGE_DIR CHANGE_DIR PARENT_DIR

Each argument is the root of an unpacked tree (``git archive``). Each run is
its own process that imports that tree's package and its ``chip_smoke.py``
(for ``phase_device``, ``device_breakdown`` and ``step_times``), builds the
tree's kernels, takes 3 warm-up steps and prints one JSON line: the profiled
device ms and kernels/copies a step (5 steps) and the wall p50 of 10 steps,
each ending in a synchronize. Fails without a card.
"""
from __future__ import annotations

import subprocess
import sys

RUN = r"""
import json, statistics, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import chip_smoke as s
from incomplete_multimodal_fusion_tpu_torch.config import PretrainConfig
from incomplete_multimodal_fusion_tpu_torch.data.synthetic import synthetic_batch
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_build
from incomplete_multimodal_fusion_tpu_torch.train import pretrain

smi = s.phase_device()
cuda_build.build_all()
dev = torch.device("cuda", 0)
cfg = PretrainConfig()
model, state, optimizer = pretrain.create_train_state(cfg, 0, total_steps=1000, device=dev)
step = pretrain.make_train_step(model, cfg, optimizer)
batch = {d: torch.from_numpy(v).to(dev) for d, v in
         synthetic_batch(np.random.default_rng(0), tuple(cfg.data.in_domains), cfg.data.batch_size,
                         cfg.data.input_size).items()}
for _ in range(3):
    step(state, batch)
device_ms, events, by_kind, _ = s.device_breakdown(lambda: step(state, batch), reps=5)
times, _ = s.step_times(lambda: step(state, batch)[1], steps=10, warmup=2)
print(json.dumps({"tree": sys.argv[1], "card": smi, "device_ms": device_ms, "events": events,
                  "by_kind": by_kind, "wall_p50_ms": statistics.median(times)}))
"""


def main(trees) -> int:
    if not trees:
        print(__doc__)
        return 2
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", RUN, tree], capture_output=True, text=True, cwd=tree)
        if out.returncode != 0:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        print([line for line in out.stdout.splitlines() if line.startswith("{")][-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
