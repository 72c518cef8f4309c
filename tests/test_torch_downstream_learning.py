"""The port's learning tool (tools/train_downstream_synthetic_torch.py)
against the JAX package's (tools/train_downstream_synthetic.py): the same
samples bit for bit from the same generator, the same flags and defaults,
and, after one step on the CPU, a JSON of the same keys as
DOWNSTREAM_E2E.json."""
import json
import os

import numpy as np
import pytest

from tools import train_downstream_synthetic as jtool
from tools import train_downstream_synthetic_torch as ttool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", [20260817, 3])
def test_samples_are_the_jax_tools(seed):
    jrng, trng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(2):  # the stream continues alike
        (jx, *jrest), (tx, *trest) = jtool.make_batch(jrng, 3), ttool.make_batch(trng, 3)
        assert set(tx) == set(jx) == set(ttool.DOMAINS)
        for a, b in [(jx[d], tx[d]) for d in jx] + list(zip(jrest, trest)):  # rasters, masks, labels, valid
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_one_step_on_the_cpu_writes_the_jax_runs_keys(tmp_path):
    out = tmp_path / "e2e.json"
    ttool.main(["--steps", "1", "--batch", "1", "--eval_images", "1", "--frozen_stages", "11", "--cpu",
                "--out", str(out)])
    got = json.loads(out.read_text())
    with open(os.path.join(ROOT, "DOWNSTREAM_E2E.json")) as f:
        want = json.load(f)
    assert set(got) == set(want)
    assert got["backend"] == "cpu" and got["steps"] == 1 and got["frozen_stages"] == 11
    assert got["loss_curve"] == [[0, got["loss_first"]]] and np.isfinite(got["loss_first"])
    assert 0.0 <= got["binary_foreground_iou"] <= 1.0


def test_the_evaluation_after_training_runs_without_dropout():
    """The learning tool scores the model right after its steps, which leave
    it in training mode: the segmentation forwards run with dropout off, as
    the JAX package's apply without a dropout key, and keep the mode."""
    import torch
    from incomplete_multimodal_fusion_tpu_torch.infer_segmentation import forward_instance_segmentation
    from incomplete_multimodal_fusion_tpu_torch.models.maskformer import MaskFormerConfig, build_maskformer
    from tests.test_torch_downstream_train import CFG

    model = build_maskformer(MaskFormerConfig(**CFG), device="cpu")
    x = {d: np.random.default_rng(1).standard_normal((1, 64, 64, c)).astype(np.float32)
         for d, c in ttool.CHANNELS.items()}
    torch.manual_seed(0)
    model.train()
    trained_mode = forward_instance_segmentation(model, None, x, topk=5)
    assert model.training
    model.eval()
    eval_mode = forward_instance_segmentation(model, None, x, topk=5)
    for a, b in zip(trained_mode, eval_mode):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_a_failing_forward_keeps_the_training_mode():
    """segmentation_outputs puts the module back in its mode even when the
    forward raises, so the next training step keeps dropout on."""
    import torch
    from incomplete_multimodal_fusion_tpu_torch.infer_segmentation import segmentation_outputs
    from incomplete_multimodal_fusion_tpu_torch.models.maskformer import MaskFormerConfig, build_maskformer
    from tests.test_torch_downstream_train import CFG

    model = build_maskformer(MaskFormerConfig(**CFG), device="cpu")
    model.train()

    def refuse(*args, **kwargs):
        assert not model.training
        raise RuntimeError("refused")

    model.forward = refuse
    x = {d: torch.zeros((1, 64, 64, c)) for d, c in ttool.CHANNELS.items()}
    with pytest.raises(RuntimeError, match="refused"):
        segmentation_outputs(model, None, x)
    assert model.training
