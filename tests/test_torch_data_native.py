"""The port's native raster ops (``data/native.py``) on the CPU: built from
native/raster_ops.cc with native/Makefile's flags into build/native/ (never
the prebuilt native/libraster_ops.so); each op against the port's numpy
version at tests/test_native.py's tolerances; a failed build raises; the
readers' ``native`` argument picks the path and ``load_into`` routes on
what the files are, a broken file raising instead of falling back."""
import os
import re
import struct

import numpy as np
import pytest

from incomplete_multimodal_fusion_tpu_torch.data import dfc2023, native, sample_trees
from incomplete_multimodal_fusion_tpu_torch.data.tiff import write_tiff


def _plain_sar(x):
    r = np.clip(10 * np.log10(x + 1e-7), -25, 0)
    return ((np.nan_to_num(r) - dfc2023.SAR_MEAN) / dfc2023.SAR_STD).astype(np.float32)


def test_library_is_built_from_the_source_with_the_makefiles_flags():
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.parent.parts[-2:] == ("build", "native")
    assert path.name.startswith("libraster_ops-") and path.exists()
    lib = native.load_library()
    assert os.path.realpath(lib._name) == os.path.realpath(path)
    assert os.path.realpath(lib._name) != os.path.realpath(native.ROOT / "native" / "libraster_ops.so")
    make = (native.ROOT / "native" / "Makefile").read_text()
    flags = {k: tuple(re.search(rf"^{k} \?= (.*)$", make, re.M).group(1).split()) for k in ("CXXFLAGS", "LDFLAGS")}
    assert flags == {"CXXFLAGS": native.CXXFLAGS, "LDFLAGS": native.LDFLAGS}


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "raster_ops.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_sar_rgb_dsm_resize_against_numpy():
    rng = np.random.default_rng(0)
    x = rng.uniform(0.0001, 2.0, (1, 64, 64)).astype(np.float32)
    x[0, 3, 3] = np.nan
    np.testing.assert_allclose(native.sar_normalize(x), _plain_sar(x), atol=1e-5)
    rgb = rng.uniform(0, 255, (3, 32, 32)).astype(np.float32)
    ref = (rgb - dfc2023.RGB_MEAN[:, None, None]) / dfc2023.RGB_STD[:, None, None]
    np.testing.assert_allclose(native.rgb_normalize(rgb), ref, atol=1e-5)
    d = rng.uniform(0, 100, (1, 64, 64)).astype(np.float32)
    np.testing.assert_allclose(native.dsm_standardize(d), (d - d.mean()) / np.sqrt(d.var() + 1e-6), atol=1e-4)
    y = rng.standard_normal((2, 64, 64)).astype(np.float32)
    np.testing.assert_allclose(native.box_resize(y, 16), dfc2023._resize_area(y, 16), atol=1e-5)
    b = rng.uniform(0.001, 1.0, (8, 1, 32, 32)).astype(np.float32)
    np.testing.assert_allclose(native.sar_normalize_batch(b), np.stack([native.sar_normalize(t) for t in b]),
                               atol=1e-6)
    np.testing.assert_allclose(native.dsm_standardize_batch(b), np.stack([native.dsm_standardize(t) for t in b]),
                               atol=1e-5)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_fused_rgb_into_a_slot(dtype):
    x = np.random.default_rng(1).integers(0, 255, (16, 24, 3)).astype(dtype)
    out = np.empty((16, 24, 3), np.float32)
    native.rgb_hwc_normalize_into(x, out)
    ref = (x.astype(np.float32) - dfc2023.RGB_MEAN) / dfc2023.RGB_STD
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_into_functions_refuse_what_they_cannot_write():
    out = np.empty((4, 4, 3), np.float32)
    with pytest.raises(TypeError, match="uint8"):
        native.rgb_hwc_normalize_into(np.zeros((4, 4, 3), np.float32), out)
    with pytest.raises(ValueError, match="contiguous"):
        native.rgb_hwc_normalize_into(np.zeros((4, 4, 3), np.uint8), np.empty((4, 4, 3), np.float64))
    with pytest.raises(ValueError, match="32 elements"):
        native.sar_normalize_into(np.ones((4, 4, 2), np.float32), np.empty((4, 4, 1), np.float32))
    with pytest.raises(ValueError, match="contiguous"):
        native.standardize_into(np.ones((4, 4), np.float32), np.empty((4, 8), np.float32)[:, ::2])


@pytest.mark.parametrize("compression", ["none", "deflate"])
def test_readers_native_against_plain(tmp_path, compression):
    """The datasets' native path (the fused load_into and __getitem__)
    within tests/test_native.py's tolerance of the numpy path, and the
    resize path (64^2 rasters read at 32)."""
    root = sample_trees.write_dfc2023(str(tmp_path), 3, 64, seed=2, compression=compression)
    for size in (64, 32):
        plain = dfc2023.DFC2023Dataset(root, size=size, native=False)
        fast = dfc2023.DFC2023Dataset(root, size=size)
        for i in range(3):
            a, b = plain[i], fast[i]
            dst = {k: np.empty((size, size, a[k].shape[0]), np.float32) for k in ("s1", "s2", "dem")}
            assert fast.load_into(i, dst) == (size == 64)
            assert not plain.load_into(i, dst)
            for k in a:
                np.testing.assert_allclose(b[k], a[k], atol=1e-4)
                if size == 64:
                    np.testing.assert_allclose(dst[k], a[k].transpose(1, 2, 0), atol=1e-4)


def test_load_into_routes_on_the_files_and_raises_on_a_broken_one(tmp_path):
    npy = sample_trees.write_dfc2023(str(tmp_path / "npy"), 1, 32, npy=True)
    dst = {k: np.empty((32, 32, c), np.float32) for k, c in (("s1", 1), ("s2", 3), ("dem", 1))}
    assert not dfc2023.DFC2023Dataset(npy, size=32).load_into(0, dst)  # side-cars: __getitem__
    root = sample_trees.write_dfc2023(str(tmp_path / "tiff"), 1, 32, labeled=True)
    assert not dfc2023.DFC2023Dataset(root, size=32, unlabeled=False).load_into(0, dst)
    assert not dfc2023.DFC2023Dataset(root, size=32, transform=True, crop_size=16).load_into(0, dst)
    write_tiff(os.path.join(root, "rgb", "t0000.tiff"), np.zeros((32, 32, 3), np.float32))
    assert not dfc2023.DFC2023Dataset(root, size=32).load_into(0, dst)  # float RGB: no fused kernel
    with pytest.raises(KeyError, match="dnw"):
        dfc2023.DFC2023Dataset(root, size=32).load_into(0, {"dnw": dst["s1"]})
    with open(os.path.join(root, "sar", "t0000.tiff"), "wb") as f:
        f.write(b"II*\0garbage")
    with pytest.raises(struct.error):  # a broken raster raises; nothing falls back
        dfc2023.DFC2023Dataset(root, size=32).load_into(0, dst)
    os.remove(os.path.join(root, "dsm", "t0000.tiff"))
    with pytest.raises(FileNotFoundError):
        dfc2023.load_dsm(os.path.join(root, "dsm", "t0000.tiff"), 32)
