"""The port's command lines on real trees, on the CPU, in this process at a
small size (the ``tiny`` widths on 32² rasters, B = 2, f32): each data flag
feeds its step the batches of the JAX package's reader and iterator for the
same seed (the port's native normalizations within tests/test_native.py's
tolerance of the JAX package's numpy ones, everything else bitwise) and the
losses are finite.

  * ``cli.pretrain --data_path`` (with and without ``--random_crop``, with
    ``--steps_per_call 2``); a run resumed from the first epoch's
    checkpoint takes the batches an unbroken run takes next and ends
    bitwise where it ends;
  * ``cli.train_downstream``: ``--coco_root/--coco_json`` with and without
    ``--aug``, ``--quad_root`` with and without ``--aug``, ``--odgt
    --ade_root --segm_downsampling_rate 2`` (one domain, s2), each after the
    first batch (taken for the initialisation, as the JAX script does);
  * ``cli.infer --data_path --tile_index 1``.
"""
import math
import re

import numpy as np
import pytest
import torch

import incomplete_multimodal_fusion_tpu.data.dfc2023 as jdfc
import incomplete_multimodal_fusion_tpu.data.native as jnative
from incomplete_multimodal_fusion_tpu.data import ade_odgt as jade
from incomplete_multimodal_fusion_tpu.data import coco_instance as jcoco
from incomplete_multimodal_fusion_tpu.data import quadruplet as jquad
from incomplete_multimodal_fusion_tpu.data.augment import AugmentConfig as JaxAugmentConfig
from incomplete_multimodal_fusion_tpu_torch.cli import infer as cli_infer
from incomplete_multimodal_fusion_tpu_torch.cli import pretrain as cli_pretrain
from incomplete_multimodal_fusion_tpu_torch.cli import train_downstream as cli_down
from incomplete_multimodal_fusion_tpu_torch.data import sample_trees
from incomplete_multimodal_fusion_tpu_torch.losses.set_criterion import targets_from_semantic_labels
from tests.test_torch_checkpoint import assert_bitwise
from tests.test_torch_data_iterators import jax_quadruplet_batches

NATIVE_ATOL = 1e-4  # tests/test_native.py's loader tolerance
PRETRAIN = ["--device", "cpu", "--input_size", "32", "--batch_size", "2", "--num_encoded_tokens", "6",
            "--steps_per_epoch", "2", "--epochs", "2", "--save_ckpt_freq", "1", "--warmup_epochs", "0",
            "--compute_dtype", "float32", "--seed", "3"]
DOWNSTREAM = ["--device", "cpu", "--input_size", "32", "--batch_size", "2", "--num_points", "16",
              "--num_queries", "8", "--compute_dtype", "float32", "--epochs", "1", "--steps_per_epoch", "1",
              "--eval_freq", "1", "--save_freq", "1", "--seed", "3"]


@pytest.fixture(autouse=True)
def jax_plain(monkeypatch):
    monkeypatch.setattr(jdfc, "_native", lambda: None)
    monkeypatch.setattr(jnative, "available", lambda: False)


def recording(monkeypatch, module, name, targets=False):
    """Wraps ``module.name`` (a step factory) so each step's batch (and with
    ``targets`` its targets) is kept as numpy; returns the list they go
    to."""
    seen = []
    make = getattr(module, name)

    def factory(*args, **kwargs):
        step = make(*args, **kwargs)

        def recorded(state, batch, *rest, **kw):
            kept = [{k: np.array(v) for k, v in batch.items()}]
            seen.append(kept + [tuple(np.array(t) for t in rest[0])] if targets else kept)
            return step(state, batch, *rest, **kw)

        recorded.__dict__.update(step.__dict__)
        return recorded

    monkeypatch.setattr(module, name, factory)
    return seen


def close(got, want, atol=0.0):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)


def run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def dfc_root(tmp_path_factory):
    return sample_trees.write_dfc2023(str(tmp_path_factory.mktemp("dfc")), 5, 32, seed=21)


@pytest.mark.parametrize("extra", [[], ["--random_crop"], ["--steps_per_call", "2"]])
def test_pretrain_reads_the_tree_the_jax_script_reads(dfc_root, tmp_path, monkeypatch, capsys, extra):
    seen = recording(monkeypatch, cli_pretrain.pretrain, "make_train_step")
    run(cli_pretrain.main, [*PRETRAIN, "--data_path", dfc_root, "--output_dir", str(tmp_path), *extra], capsys)
    it = jdfc.dfc2023_iterator(dfc_root, ("s1", "s2", "dem"), 2, 32, seed=3, random_crop="--random_crop" in extra)
    want = [next(it) for _ in range(4)]
    it.close()
    assert len(seen) == 4
    for (got,), ref in zip(seen, want):
        close(got, ref, NATIVE_ATOL)
    logged = [float(v) for v in re.findall(r'"recon_loss": ([-0-9.e+]+)', (tmp_path / "log.txt").read_text())]
    assert len(logged) == 2 and all(math.isfinite(v) for v in logged)


def test_pretrain_resume_takes_the_unbroken_runs_next_batches(dfc_root, tmp_path, monkeypatch, capsys):
    straight, split = tmp_path / "straight", tmp_path / "split"
    seen = recording(monkeypatch, cli_pretrain.pretrain, "make_train_step")
    run(cli_pretrain.main, [*PRETRAIN, "--data_path", dfc_root, "--output_dir", str(straight)], capsys)
    unbroken = list(seen)
    split.mkdir()
    (split / "checkpoint-2").write_bytes((straight / "checkpoint-2").read_bytes())
    seen.clear()
    out = run(cli_pretrain.main, [*PRETRAIN, "--data_path", dfc_root, "--output_dir", str(split)], capsys)
    assert "Resumed from step 2" in out and len(seen) == 2
    for (got,), (ref,) in zip(seen, unbroken[2:]):
        close(got, ref)
    assert_bitwise(torch.load(str(split / "checkpoint-4"), weights_only=True),
                   torch.load(str(straight / "checkpoint-4"), weights_only=True))


def _finite_losses(out):
    losses = [float(v) for v in re.findall(r"epoch \d+: loss=(\S+)", out)]
    assert losses and all(math.isfinite(v) for v in losses), out[-2000:]


@pytest.mark.parametrize("aug", [False, True])
def test_downstream_coco(tmp_path, monkeypatch, capsys, aug):
    root, ann = sample_trees.write_coco(str(tmp_path / "coco"), 6, 32, seed=22)
    seen = recording(monkeypatch, cli_down.ds, "make_downstream_train_step", targets=True)
    out = run(cli_down.main, [*DOWNSTREAM, "--coco_root", root, "--coco_json", ann, "--output_dir",
                              str(tmp_path / "out"), *(["--aug"] if aug else [])], capsys)
    want = jcoco.coco_batch_iterator(jcoco.CocoInstanceDataset(root, ann, 32), 2, seed=3,
                                     augment=JaxAugmentConfig() if aug else None)
    next(want)  # the JAX script's initialisation batch
    (batch, targets), = seen
    x, t = next(want)
    close(batch, x, NATIVE_ATOL)
    for got, ref in zip(targets, t):
        np.testing.assert_array_equal(got, ref)
    _finite_losses(out)
    assert re.search(r"eval dice=\d", out)


@pytest.mark.parametrize("aug", [False, True])
def test_downstream_quadruplet(tmp_path, monkeypatch, capsys, aug):
    root = sample_trees.write_quadruplet(str(tmp_path / "quad"), 5, 40, seed=23)
    seen = recording(monkeypatch, cli_down.ds, "make_downstream_train_step", targets=True)
    out = run(cli_down.main, [*DOWNSTREAM, "--task", "semantic", "--num_classes", "6", "--quad_root", root,
                              "--output_dir", str(tmp_path / "out"), *(["--aug"] if aug else [])], capsys)
    want = jax_quadruplet_batches(jquad.QuadrupletDataset(root, unlabeled=False, crop_size=32), 2, 3, aug)
    next(want)
    (batch, targets), = seen
    ref = next(want)
    close(batch, {k: ref[k] for k in ("s1", "s2", "dem")})
    for got, r in zip(targets, targets_from_semantic_labels(torch.from_numpy(ref["label"]), 6)):
        np.testing.assert_array_equal(got, r.numpy())
    _finite_losses(out)
    assert re.search(r"eval AA=\S+ mIoU=\S+", out)


def test_downstream_ade(tmp_path, monkeypatch, capsys):
    root, odgt = sample_trees.write_ade(str(tmp_path / "ade"), 5, (40, 48), seed=24, num_classes=4)
    seen = recording(monkeypatch, cli_down.ds, "make_downstream_train_step", targets=True)
    out = run(cli_down.main, [*DOWNSTREAM, "--task", "semantic", "--num_classes", "4", "--odgt", odgt, "--ade_root",
                              root, "--segm_downsampling_rate", "2", "--aug", "--output_dir", str(tmp_path / "out")],
              capsys)
    ds = jade.ADEOdgtDataset(odgt, root=root, img_size=32, segm_downsampling_rate=2, flip=True, seed=3)
    want = jade.ade_batch_iterator(ds, 2, seed=3)
    next(want)
    (batch, targets), = seen
    ref = next(want)
    close(batch, {"s2": ref["image"]})
    assert targets[1].shape == (2, 4, 16, 16)
    for got, r in zip(targets, targets_from_semantic_labels(torch.from_numpy(ref["label"]), 4)):
        np.testing.assert_array_equal(got, r.numpy())
    _finite_losses(out)


def test_infer_on_a_dfc2023_tile(dfc_root, tmp_path, monkeypatch, capsys):
    seen = []
    infer = cli_infer.infer_lib.infer
    monkeypatch.setattr(cli_infer.infer_lib, "infer", lambda model, params, x, *a, **kw: (
        seen.append({k: np.array(v) for k, v in x.items()}) or infer(model, params, x, *a, **kw)))
    png = tmp_path / "grid.png"
    out = run(cli_infer.main, ["--device", "cpu", "--input_size", "32", "--num_encoded_tokens", "6", "--ckpt_dir",
                               str(tmp_path / "none"), "--data_path", dfc_root, "--tile_index", "1", "--output",
                               str(png)], capsys)
    tile = jdfc.DFC2023Dataset(dfc_root, size=32)[1]
    close(seen[0], {k: v.transpose(1, 2, 0)[None] for k, v in tile.items()}, NATIVE_ATOL)
    psnr = [float(v) for v in re.findall(r"PSNR (\S+) dB", out)]
    assert psnr and all(math.isfinite(v) for v in psnr) and png.read_bytes()[:4] == b"\x89PNG"
