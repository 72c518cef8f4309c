"""Each reader of the port against the JAX package's on the same small trees
(32²-64² tiles, a few samples), on the plain path (``native=False`` in the
port; the JAX package's native library switched off the way
tests/test_native.py does): every sample bitwise equal, the generators'
draws (crops, flips, augmentation) in the same order."""
import os

import numpy as np
import pytest

import incomplete_multimodal_fusion_tpu.data.dfc2023 as jdfc
import incomplete_multimodal_fusion_tpu.data.native as jnative
from incomplete_multimodal_fusion_tpu.data import ade_odgt as jade
from incomplete_multimodal_fusion_tpu.data import augment as jaug
from incomplete_multimodal_fusion_tpu.data import coco_instance as jcoco
from incomplete_multimodal_fusion_tpu.data import quadruplet as jquad
from incomplete_multimodal_fusion_tpu.data import sen12ms as jsen
from incomplete_multimodal_fusion_tpu_torch.data import ade_odgt, augment, coco_instance, dfc2023, quadruplet
from incomplete_multimodal_fusion_tpu_torch.data import sample_trees, sen12ms


@pytest.fixture(autouse=True)
def jax_plain(monkeypatch):
    """The JAX package's readers on their numpy path."""
    monkeypatch.setattr(jdfc, "_native", lambda: None)
    monkeypatch.setattr(jnative, "available", lambda: False)


def assert_same(a, b, path="sample"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b, equal_nan=True), path
    else:
        assert a == b, path


@pytest.mark.parametrize("kind", ["none", "deflate", "packbits", "npy"])
def test_dfc2023_samples(tmp_path, kind):
    npy = kind == "npy"
    root = sample_trees.write_dfc2023(str(tmp_path), 3, 64, seed=1, compression="none" if npy else kind,
                                      labeled=True, npy=npy)
    for kw in ({"size": 64}, {"size": 32}, {"size": 64, "transform": True, "crop_size": 24, "seed": 5},
               {"size": 64, "unlabeled": False}):
        ours, theirs = dfc2023.DFC2023Dataset(root, native=False, **kw), jdfc.DFC2023Dataset(root, **kw)
        assert ours.samples == theirs.samples
        for i in range(3):
            assert_same(ours[i], theirs[i])


def test_dfc2023_loaders_keep_the_resize_rules(tmp_path):
    """512-like resize path at a small size: integer factors box-average,
    others take the nearest sample; the missing-raster error names the
    side-car."""
    root = sample_trees.write_dfc2023(str(tmp_path), 1, 48, seed=2)
    for size in (16, 24, 32):
        for name in ("load_sar", "load_rgb", "load_dsm"):
            path = os.path.join(root, {"load_sar": "sar", "load_rgb": "rgb", "load_dsm": "dsm"}[name], "t0000.tiff")
            assert_same(getattr(dfc2023, name)(path, size, native=False), getattr(jdfc, name)(path, size))
    with pytest.raises(FileNotFoundError, match="side-car"):
        dfc2023._read_raster(os.path.join(root, "sar", "missing.tiff"))


@pytest.mark.parametrize("size", [32, 48])
def test_coco_samples(tmp_path, size):
    root, ann = sample_trees.write_coco(str(tmp_path), 4, 32, seed=3, num_classes=2)
    ours = coco_instance.CocoInstanceDataset(root, ann, img_size=size, max_instances=6, native=False)
    theirs = jcoco.CocoInstanceDataset(root, ann, img_size=size, max_instances=6)
    assert ours.ids == theirs.ids and ours.num_classes == theirs.num_classes == 2
    for i in range(len(ours)):
        (x, t), (jx, jt) = ours[i], theirs[i]
        assert_same(x, jx)
        assert_same(tuple(t), tuple(jt))
        assert t.valid.any()


def test_coco_augmentation_draws(tmp_path):
    root, ann = sample_trees.write_coco(str(tmp_path), 2, 32, seed=4)
    ours = coco_instance.CocoInstanceDataset(root, ann, img_size=32, max_instances=5, native=False)
    theirs = jcoco.CocoInstanceDataset(root, ann, img_size=32, max_instances=5)
    rng, jrng = np.random.default_rng(7), np.random.default_rng(7)
    for i in range(2):
        x, t = coco_instance._augment_one(*ours[i], rng, augment.AugmentConfig())
        jx, jt = jcoco._augment_one(*theirs[i], jrng, jaug.AugmentConfig())
        assert_same(x, jx)
        assert_same(tuple(t), tuple(jt))


@pytest.mark.parametrize("cfg", [{}, {"blur": True, "gamma": True}, {"rotate": False, "scale": False}])
def test_augment_sample_draws(cfg):
    rng = np.random.default_rng(0)
    images = {"s2": rng.uniform(0, 1, (3, 24, 24)).astype(np.float32),
              "s1": rng.standard_normal((1, 24, 24)).astype(np.float32)}
    masks = (rng.uniform(size=(4, 24, 24)) > 0.5).astype(np.float32)
    label = rng.integers(0, 5, (24, 24)).astype(np.uint8)
    ours = augment.augment_sample(images, np.random.default_rng(3), augment.AugmentConfig(**cfg), masks=masks,
                                  label=label, label_cval=255)
    theirs = jaug.augment_sample(images, np.random.default_rng(3), jaug.AugmentConfig(**cfg), masks=masks,
                                 label=label, label_cval=255)
    assert_same(ours, theirs)
    crop = augment.random_crop_multimodal({**images, "id": "x"}, (10, 12), np.random.default_rng(1))
    assert_same(crop, jaug.random_crop_multimodal({**images, "id": "x"}, (10, 12), np.random.default_rng(1)))


@pytest.mark.parametrize("kw", [{}, {"unlabeled": False}, {"unlabeled": False, "crop_size": 24,
                                                          "segm_downsampling_rate": 4, "seed": 2}])
def test_quadruplet_samples(tmp_path, kw):
    root = sample_trees.write_quadruplet(str(tmp_path), 3, 32, seed=5)
    ours, theirs = quadruplet.QuadrupletDataset(root, **kw), jquad.QuadrupletDataset(root, **kw)
    assert ours.samples == theirs.samples
    for _ in range(2):  # the crop generator advances alike
        for i in range(3):
            assert_same(ours[i], theirs[i])


def test_ade_samples(tmp_path):
    root, odgt = sample_trees.write_ade(str(tmp_path), 3, (40, 56), seed=6)
    for kw in ({"img_size": 32}, {"img_size": 32, "segm_downsampling_rate": 4, "flip": True, "seed": 1}):
        ours, theirs = ade_odgt.ADEOdgtDataset(odgt, root=root, **kw), jade.ADEOdgtDataset(odgt, root=root, **kw)
        for _ in range(2):
            for i in range(3):
                assert_same(ours[i], theirs[i])


@pytest.fixture
def sen_root(tmp_path):
    """A DFC2020 folder-of-places tree of .npy side-cars (the JAX package
    reads SEN12MS through rasterio / tifffile otherwise, absent here)."""
    rng = np.random.default_rng(8)
    for d in ("s1_0", "s2_0", "se_0", "dfc_0"):
        os.makedirs(tmp_path / d)
    for i in range(3):
        np.save(tmp_path / "s1_0" / f"p_s1_{i}.npy", rng.uniform(-30, 5, (2, 32, 32)).astype(np.float32))
        np.save(tmp_path / "s2_0" / f"p_s2_{i}.npy", rng.uniform(0, 12000, (13, 32, 32)).astype(np.float32))
        np.save(tmp_path / "se_0" / f"p_se_{i}.npy", rng.integers(0, 6, (32, 32)).astype(np.int64))
        np.save(tmp_path / "dfc_0" / f"p_dfc_{i}.npy", rng.integers(0, 8, (1, 32, 32)).astype(np.float32))
    return str(tmp_path)


@pytest.mark.parametrize("kw", [{}, {"use_s2mr": True, "use_s2lr": True, "unlabeled": False},
                                {"use_superpixel": True, "crop_size": 16, "unlabeled": False, "seed": 3}])
def test_sen12ms_samples(sen_root, kw):
    ours, theirs = sen12ms.SEN12MSDataset(sen_root, **kw), jsen.SEN12MSDataset(sen_root, **kw)
    assert ours.samples == theirs.samples and len(ours) == 3
    for _ in range(2):
        for i in range(3):
            assert_same(ours[i], theirs[i])


def test_sen12ms_reads_tiffs_with_the_ports_codec(tmp_path):
    """Without a side-car the port reads the TIFF itself (the JAX package
    needs rasterio or tifffile), channel-first, bands picked."""
    from incomplete_multimodal_fusion_tpu_torch.data.tiff import write_tiff

    arr = np.random.default_rng(9).integers(0, 9000, (16, 16, 13)).astype(np.uint16)
    write_tiff(str(tmp_path / "x.tif"), arr)
    got = sen12ms._read_tif(str(tmp_path / "x.tif"), bands=[2, 3, 4, 8])
    assert_same(got, arr.transpose(2, 0, 1)[[1, 2, 3, 7]])
