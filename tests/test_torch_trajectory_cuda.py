"""The port's trajectories on the card (tools/trajectory_torch.py), the
kernel path (A) against the plain path (B) from the same weights, batches,
masks and discrete decisions (matches, points, the head's attention masks),
beside two controls: the plain path on the same batches with their rows
permuted (C) and, in bf16, the plain path computing in f32 (E). Every loss
is finite, and

  * step by step at the small width with 32-wide heads (``small_dh32``, the
    narrowest the kernels take), in bf16 and in f32, A's drift from B stays
    within max(10 x the larger control's, the one-step bound of
    chip_smoke.py for the dtype: TRAIN_LOSS_REL in bf16, F32_LOSS_REL in
    f32): over all 20 pretraining steps, and over the first 5 downstream
    steps, after which the downstream runs no longer track each other, the
    controls neither (PERF.md);
  * at every one of 20 steps, at ``small_dh32`` and at the full widths
    (B = 60 pretraining, B = 30 downstream), the kernel path evaluated at
    B's weights, with B's decisions: in f32 within F32_LOSS_REL of B's
    loss; in bf16 within TRAIN_LOSS_REL of the f32 value E, or no farther
    from it than twice the plain bf16 path is. So the kernels' error does
    not grow as the weights train.

These tests need a CUDA card and skip without one; on a card run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trajectory_cuda.py -q

(``--noconftest``: the suite's conftest configures JAX, which the card's
machine need not have; this file imports nothing of JAX.)
"""
import math

import pytest
import torch

from chip_smoke import F32_LOSS_REL, TRAIN_LOSS_REL
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_build
from tools import trajectory_torch as tt

pytestmark = pytest.mark.cuda

STEPS = 20
BOUND = {"bfloat16": TRAIN_LOSS_REL, "float32": F32_LOSS_REL}
HELD = {"pretrain": STEPS, "downstream": 5}  # the steps held one by one
KERNEL_OVER_PLAIN = 2.0  # bf16: the kernel path's distance from the f32 value over the plain path's
_RESULTS = {}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    cuda_build.build_all()
    return torch.device("cuda", 0)


def _run(dev, path, width, dtype):
    """The trajectories of (path, width, dtype), run once a module."""
    key = (path, width, dtype)
    if key not in _RESULTS:
        res = tt.TRAJECTORIES[path](width, dtype, STEPS, dev, seed=0)
        assert set(res["runs"]) == {"A", "B", "C"} | ({"E"} if dtype == "bfloat16" else set())
        for run in res["runs"].values():
            assert len(run["loss"]) == STEPS and all(math.isfinite(x) for x in run["loss"])
        _RESULTS[key] = res
    return _RESULTS[key]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("path", ["pretrain", "downstream"])
def test_kernel_path_tracks_plain_path_within_its_control(dev, path, dtype):
    res = _run(dev, path, "small_dh32", dtype)
    a = res["drift"]["A"]["loss"]["per_step"]
    controls = [res["drift"][n]["loss"]["per_step"] for n in ("C", "E") if n in res["drift"]]
    for i in range(HELD[path]):
        bound = max(10 * max(c[i] for c in controls), BOUND[dtype])
        assert a[i] <= bound, (path, dtype, i, a[:HELD[path]], [c[:HELD[path]] for c in controls])


@pytest.mark.parametrize("width", ["small_dh32", "full"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("path", ["pretrain", "downstream"])
def test_kernel_error_at_the_plain_path_weights_stays_within_its_bound(dev, path, dtype, width):
    at_b = _run(dev, path, width, dtype)["at_B_weights"]
    if dtype == "float32":
        one_step = at_b["A"]["loss"]["per_step"]
        assert max(one_step) <= F32_LOSS_REL, (path, width, one_step)
        return
    kernel, plain = at_b["A_vs_E"]["per_step"], at_b["B_vs_E"]["per_step"]
    for i, (k, p) in enumerate(zip(kernel, plain)):
        assert k <= max(TRAIN_LOSS_REL, KERNEL_OVER_PLAIN * p), (path, width, i, kernel, plain)
