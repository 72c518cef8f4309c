"""The port's batch iterators against the JAX package's on the same small
trees and seeds, on the plain path: the first three batches of every
iterator (DFC2023 with and without the random crop; COCO with and without
augmentation; the quadruplet loop of scripts/train_downstream.py with and
without ``--aug``; ADE with flips) are bitwise equal, through the port's
numpy iterators and through ``data.loader.DeviceLoader`` on the CPU (one
batch a slot, and K batches a slot for ``make_multi_step``). Skipping n
DFC2023 batches lands where n batches read would."""
import numpy as np
import pytest

import incomplete_multimodal_fusion_tpu.data.dfc2023 as jdfc
import incomplete_multimodal_fusion_tpu.data.native as jnative
from incomplete_multimodal_fusion_tpu.data import ade_odgt as jade
from incomplete_multimodal_fusion_tpu.data import augment as jaug
from incomplete_multimodal_fusion_tpu.data import coco_instance as jcoco
from incomplete_multimodal_fusion_tpu.data import quadruplet as jquad
from incomplete_multimodal_fusion_tpu_torch.data import ade_odgt, augment, coco_instance, dfc2023, quadruplet
from incomplete_multimodal_fusion_tpu_torch.data import sample_trees
from incomplete_multimodal_fusion_tpu_torch.data.loader import DeviceLoader
from tests.test_torch_data_readers import assert_same

N = 3  # batches compared


@pytest.fixture(autouse=True)
def jax_plain(monkeypatch):
    monkeypatch.setattr(jdfc, "_native", lambda: None)
    monkeypatch.setattr(jnative, "available", lambda: False)


def take(it, n=N):
    return [next(it) for _ in range(n)]


def as_numpy(batch):
    return {k: v.numpy() for k, v in batch.items()}


def unstack(groups):
    return [{k: v[j] for k, v in g.items()} for g in groups for j in range(next(iter(g.values())).shape[0])]


@pytest.fixture(scope="module")
def dfc_root(tmp_path_factory):
    return sample_trees.write_dfc2023(str(tmp_path_factory.mktemp("dfc")), 7, 32, seed=11)


@pytest.mark.parametrize("crop", [False, True])
def test_dfc2023_batches(dfc_root, crop):
    kw = dict(in_domains=("s1", "s2", "dem"), batch_size=2, input_size=32 if not crop else 16, seed=4,
              random_crop=crop)
    theirs = jdfc.dfc2023_iterator(dfc_root, num_threads=2, **kw)
    want = take(theirs, 2 * N)
    theirs.close()
    ours = dfc2023.dfc2023_iterator(dfc_root, num_threads=2, native=False, **kw)
    for got, ref in zip(take(ours), want):
        assert_same(got, ref)
    ours.close()
    for stack in (1, 2):
        source = dfc2023.DFC2023Batches(dfc_root, num_threads=2, native=False, **kw)
        with DeviceLoader(source, "cpu", stack=stack) as loader:
            got = [as_numpy(b) for b in take(loader)]
        got = unstack(got) if stack > 1 else got
        for g, ref in zip(got, want[:len(got)]):
            assert_same(g, ref)


def test_dfc2023_skip_is_reading_past(dfc_root, monkeypatch):
    """Resume: skip(n) then a batch is the (n+1)-th batch, across epochs (7
    tiles: 3 batches of 2 an epoch), without reading the skipped ones."""
    kw = dict(in_domains=("s1", "s2", "dem"), batch_size=2, input_size=32, seed=9, native=False, num_threads=1)
    read = dfc2023.DFC2023Batches(dfc_root, **kw)
    outs = []
    for _ in range(8):
        out = {k: np.empty(shape, dtype) for k, (shape, dtype) in read.specs.items()}
        read.fill(out)
        outs.append(out)
    skipped = dfc2023.DFC2023Batches(dfc_root, **kw)
    calls, read_one = [], dfc2023.DFC2023Dataset.__getitem__
    monkeypatch.setattr(dfc2023.DFC2023Dataset, "__getitem__", lambda self, i: calls.append(i) or read_one(self, i))
    skipped.skip(7)
    assert not calls
    out = {k: np.empty(shape, dtype) for k, (shape, dtype) in skipped.specs.items()}
    skipped.fill(out)
    assert_same(out, outs[7])


def test_dfc2023_refuses_a_tree_smaller_than_a_batch(dfc_root):
    with pytest.raises(ValueError, match="fewer than a batch"):
        dfc2023.DFC2023Batches(dfc_root, ("s1",), batch_size=8, input_size=32)


@pytest.mark.parametrize("aug", [False, True])
def test_coco_batches(tmp_path, aug):
    root, ann = sample_trees.write_coco(str(tmp_path), 5, 32, seed=12, num_classes=2)
    jds = jcoco.CocoInstanceDataset(root, ann, img_size=32, max_instances=6)
    want = take(jcoco.coco_batch_iterator(jds, 2, seed=3, augment=jaug.AugmentConfig() if aug else None))
    ds = coco_instance.CocoInstanceDataset(root, ann, img_size=32, max_instances=6, native=False)
    cfg = augment.AugmentConfig() if aug else None
    for got, (x, t) in zip(take(coco_instance.coco_batch_iterator(ds, 2, seed=3, augment=cfg)), want):
        assert_same(got[0], x)
        assert_same(tuple(got[1]), tuple(t))
    with DeviceLoader(coco_instance.CocoBatches(ds, 2, seed=3, augment=cfg), "cpu") as loader:
        got = [coco_instance.split_targets(as_numpy(b)) for b in take(loader)]
    for (gx, gt), (x, t) in zip(got, want):
        assert_same(gx, x)
        assert_same(tuple(gt), tuple(t))


def jax_quadruplet_batches(ds, batch_size, seed, aug):
    """The loop of scripts/train_downstream.py:163-205 on the JAX package's
    modules, the labels left as the integer map the targets are made from."""
    rng = np.random.default_rng(seed)
    idx = np.arange(len(ds))
    while True:
        rng.shuffle(idx)
        for start in range(0, len(ds) - batch_size + 1, batch_size):
            samples = [ds[int(i)] for i in idx[start:start + batch_size]]
            if aug:
                auged = []
                for s in samples:
                    imgs = {k: s[k] for k in ("s1", "s2", "dem")}
                    imgs, _, lab = jaug.augment_sample(imgs, rng, jaug.AugmentConfig(), label=s["label"],
                                                       label_cval=255)
                    auged.append({**imgs, "label": lab})
                samples = auged
            yield {"s1": np.stack([s["s1"].transpose(1, 2, 0)[..., :1] for s in samples]),
                   "s2": np.stack([s["s2"].transpose(1, 2, 0)[..., :3] for s in samples]),
                   "dem": np.stack([s["dem"].transpose(1, 2, 0) for s in samples]),
                   "label": np.stack([s["label"] for s in samples])}


@pytest.mark.parametrize("aug", [False, True])
def test_quadruplet_batches(tmp_path, aug):
    root = sample_trees.write_quadruplet(str(tmp_path), 5, 40, seed=13)
    want = take(jax_quadruplet_batches(jquad.QuadrupletDataset(root, unlabeled=False, crop_size=32), 2, 6, aug))
    ds = quadruplet.QuadrupletDataset(root, unlabeled=False, crop_size=32)
    source = quadruplet.QuadrupletBatches(ds, 2, seed=6, augment=augment.AugmentConfig() if aug else None)
    with DeviceLoader(source, "cpu") as loader:
        for got, ref in zip(take(loader), want):
            assert_same(as_numpy(got), ref)


def test_ade_batches(tmp_path):
    root, odgt = sample_trees.write_ade(str(tmp_path), 5, (40, 48), seed=14)
    kw = dict(root=root, img_size=32, segm_downsampling_rate=2, flip=True, seed=8)
    want = take(jade.ade_batch_iterator(jade.ADEOdgtDataset(odgt, **kw), 2, seed=8))
    assert_same(take(ade_odgt.ade_batch_iterator(ade_odgt.ADEOdgtDataset(odgt, **kw), 2, seed=8)), want)
    with DeviceLoader(ade_odgt.ADEBatches(ade_odgt.ADEOdgtDataset(odgt, **kw), 2, seed=8), "cpu") as loader:
        got = [as_numpy(b) for b in take(loader)]
    assert_same(got, want)
