"""The port's downstream training CLI (``python -m
incomplete_multimodal_fusion_tpu_torch.cli.train_downstream``) on the CPU,
in subprocesses, at a small size (the ``tiny`` widths on 64² rasters, B = 2,
64 points, f32, 2 epochs of 2 steps, eval and a checkpoint each epoch):

  * checkpoints at epochs 1 and 2, the second restored bit for bit into a
    fresh model, optimizer and generator;
  * a finite loss and dice each epoch (the reference's dice, >= 0: it is
    not bounded by 1, as the JAX package's is not), the semantic task's
    AA / mIoU line in [0, 1];
  * ``--pretrained`` on a ``cli.pretrain`` run copies every backbone tensor
    the pretraining model shares at equal shape, the fusion tokens and the
    input adapters among them (the frozen ones still equal after training);
  * a non-finite loss (a huge lr) exits with code 1;
  * each flag of the JAX script the port does not run yet raises
    ``NotImplementedError`` naming it; the device defaults to ``cuda``;
  * ``data.synthetic.synthetic_instances`` is bitwise
    scripts/train_downstream.py's for three seeds; ``ReduceLROnPlateau``
    (mode 'max') gives the JAX class's lr sequence.
"""
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu.train import downstream as jds
from incomplete_multimodal_fusion_tpu_torch.cli import train_downstream as cli
from incomplete_multimodal_fusion_tpu_torch.data.synthetic import synthetic_instances
from incomplete_multimodal_fusion_tpu_torch.models.maskformer import build_maskformer
from incomplete_multimodal_fusion_tpu_torch.train import downstream as tds
from incomplete_multimodal_fusion_tpu_torch.utils import checkpoint as ckpt_lib
from tests.test_torch_checkpoint import assert_bitwise

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_RUN = ["--device", "cpu", "--input_size", "64", "--batch_size", "2", "--num_points", "64",
             "--compute_dtype", "float32", "--epochs", "2", "--steps_per_epoch", "2", "--eval_freq", "1",
             "--save_freq", "1", "--seed", "3"]


def _run(module, *args, expect=0):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", f"incomplete_multimodal_fusion_tpu_torch.cli.{module}", *args],
                       capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert r.returncode == expect, r.stdout[-2000:] + r.stderr[-2000:]
    return r.stdout


def _floats(pattern, text):
    return [float(v) for v in re.findall(pattern, text)]


@pytest.fixture(scope="module")
def instance_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("instance")
    return out, _run("train_downstream", *SMALL_RUN, "--output_dir", str(out))


def test_checkpoints_each_epoch_restore_bitwise(instance_run):
    out, _ = instance_run
    assert sorted(os.listdir(out)) == ["checkpoint-1", "checkpoint-2"]
    args = cli.get_args(SMALL_RUN)
    cfg = cli.build_config(args)
    model = build_maskformer(cfg, device="cpu")
    opt = tds.create_downstream_optimizer(model, lr=args.lr, clip_grad=args.clip_grad,
                                          frozen_stages=args.frozen_stages)
    state = ckpt_lib.restore_checkpoint(str(out), tds.DownstreamState(model, opt, torch.Generator()))
    saved = torch.load(str(out / "checkpoint-2"), weights_only=True)
    assert state.step == saved["step"] == 4
    assert_bitwise(ckpt_lib.state_payload(state), saved)
    assert opt.lr == args.lr
    # the weights of epoch 1 differ from epoch 2's: the steps trained
    first = torch.load(str(out / "checkpoint-1"), weights_only=True)
    assert first["step"] == 2 and not torch.equal(first["model"]["predictor.query_feat"],
                                                  saved["model"]["predictor.query_feat"])


def test_epoch_lines_and_eval(instance_run):
    _, log = instance_run
    losses = _floats(r"epoch \d+: loss=(\S+)", log)
    dice = _floats(r"eval dice=(\S+)", log)
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert len(dice) == 2 and all(math.isfinite(v) and v >= 0.0 for v in dice)
    assert "lr=1.00e-04" in log and re.search(r"done: 4 steps, step wall p50 \S+ ms", log)


def test_semantic_task_prints_aa_and_miou(tmp_path):
    log = _run("train_downstream", *SMALL_RUN, "--epochs", "1", "--task", "semantic", "--num_classes", "4",
               "--match_mode", "greedy", "--output_dir", str(tmp_path))
    aa, miou = _floats(r"eval AA=(\S+) mIoU", log), _floats(r"mIoU=(\S+)", log)
    assert len(aa) == len(miou) == 1 and 0.0 <= aa[0] <= 1.0 and 0.0 <= miou[0] <= 1.0
    assert os.listdir(tmp_path) == ["checkpoint-1"]


def test_pretrained_copies_the_shared_backbone_tensors(tmp_path):
    pre, out = tmp_path / "pre", tmp_path / "ft"
    _run("pretrain", "--device", "cpu", "--input_size", "64", "--batch_size", "2", "--num_encoded_tokens", "24",
         "--steps_per_epoch", "1", "--epochs", "1", "--save_ckpt_freq", "1", "--compute_dtype", "float32",
         "--output_dir", str(pre))
    log = _run("train_downstream", *SMALL_RUN, "--epochs", "1", "--pretrained", str(pre), "--output_dir", str(out))
    pre_state = ckpt_lib.load_model_state(str(pre))
    cfg = cli.build_config(cli.get_args(SMALL_RUN))
    backbone = build_maskformer(cfg, device="cpu").backbone.state_dict()
    shared = [k for k, v in backbone.items() if k in pre_state and pre_state[k].shape == v.shape]
    assert {"fusion_tokens", "mask_embedding", "input_adapters.s2.proj.weight", "blocks.11.attn.to_q.weight"} <= set(
        shared)
    assert f"restored {len(shared)} backbone tensors from {pre} step 1" in log
    tuned = ckpt_lib.load_model_state(str(out))
    frozen = tds.freeze_mask(build_maskformer(cfg, device="cpu"), cfg.frozen_stages)
    kept = [k for k in shared if not frozen.get(f"backbone.{k}", True)]
    assert kept and all(torch.equal(tuned[f"backbone.{k}"], pre_state[k]) for k in kept)


def test_a_non_finite_loss_exits_with_code_1(tmp_path):
    # greedy matching on the device: scipy (exact) refuses a NaN cost first
    log = _run("train_downstream", *SMALL_RUN, "--epochs", "1", "--steps_per_epoch", "4", "--lr", "1e30",
               "--clip_grad", "0", "--match_mode", "greedy", "--output_dir", str(tmp_path), expect=1)
    assert re.search(r"Loss is \S+, stopping training", log) and not os.listdir(tmp_path)


@pytest.mark.parametrize("flag", [["--coco_root", "/data"], ["--coco_json", "a.json"], ["--quad_root", "/q"],
                                  ["--ade_root", "/a"], ["--odgt", "x.odgt"], ["--aug"],
                                  ["--segm_downsampling_rate", "4"], ["--backbone", "swin"],
                                  ["--fusion_mode", "sup"]])
def test_unported_flags_raise(flag, tmp_path):
    with pytest.raises(NotImplementedError, match=flag[0]):
        cli.main(["--device", "cpu", "--output_dir", str(tmp_path), *flag])
    assert not os.listdir(tmp_path)  # refused before anything ran


def test_the_device_defaults_to_cuda(tmp_path):
    args = cli.get_args([])
    assert args.device == "cuda"
    assert (args.epochs, args.steps_per_epoch, args.batch_size, args.lr, args.clip_grad, args.num_points,
            args.input_size, args.frozen_stages, args.match_mode, args.eval_freq, args.save_freq,
            args.compute_dtype) == (51, 100, 30, 1e-4, 0.01, 12544, 256, 11, "exact", 50, 10, "bfloat16")
    cfg = cli.build_config(args)
    assert cfg.num_fusion_tokens == 256 and (cfg.dim_tokens, cfg.depth, cfg.heads) == (192, 12, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--output_dir", str(tmp_path)])


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_synthetic_instances_are_the_jax_scripts(seed):
    sys.path.insert(0, ROOT)
    from scripts import train_downstream as jscript
    jx, jt = jscript.synthetic_instances(np.random.default_rng(seed), 3, 32, 4)
    tx, tt = synthetic_instances(np.random.default_rng(seed), 3, 32, 4)
    assert set(tx) == set(jx)
    for k in jx:
        assert tx[k].dtype == jx[k].dtype
        np.testing.assert_array_equal(tx[k], jx[k])
    for a, b in zip(tt, jt):
        b = np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_reduce_lr_on_plateau_max_gives_jaxs_lrs():
    metrics = [0.1, 0.2, 0.2, 0.15, 0.19, 0.2, 0.18, 0.3, 0.29, 0.28, 0.3, 0.27, 0.3, 0.3, 0.31]
    a, b = jds.ReduceLROnPlateau(lr=1e-4, mode="max", patience=2), tds.ReduceLROnPlateau(lr=1e-4, mode="max",
                                                                                       patience=2)
    want, got = [a.step(m) for m in metrics], [b.step(m) for m in metrics]
    assert got == want and len(set(got)) > 2


def test_the_dice_passes_1_as_the_references_does():
    """The eval's dice is not bounded by 1: its prediction sums 100 queries'
    class probabilities x mask probabilities, which can pass 1 at a pixel
    (maskformer_train_ins_vit.py:308-316); the port's equals JAX's there."""
    import jax.numpy as jnp
    from incomplete_multimodal_fusion_tpu.eval import metrics as jmetrics
    from incomplete_multimodal_fusion_tpu_torch.eval import metrics as tmetrics

    rng = np.random.default_rng(5)
    pred = (3.0 + rng.random((1, 16, 16))).astype(np.float32)  # summed mass above 1
    tgt = (rng.random((1, 16, 16)) < 0.7).astype(np.float32)
    want = float(jmetrics.dice_score(jnp.asarray(pred), jnp.asarray(tgt)))
    got = float(tmetrics.dice_score(torch.from_numpy(pred), torch.from_numpy(tgt)))
    assert got > 1.0 and abs(got - want) <= 1e-6 * want
