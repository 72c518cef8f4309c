"""The port's TIFF codec (``data/tiff.py``) against the JAX package's, on
the CPU: every dtype, compression and predictor round-trips through the
port alone; the port's files are byte for byte the JAX writer's and each
reader decodes the other's files; a big-endian planar file and
libtiff-encoded strips (PIL) decode as the JAX reader decodes them; a
tiled or JPEG file raises."""
import struct

import numpy as np
import pytest

from incomplete_multimodal_fusion_tpu.data import tiff as jtiff
from incomplete_multimodal_fusion_tpu_torch.data import tiff as ttiff

DTYPES = [(np.uint8, (37, 41, 3)), (np.uint16, (16, 23)), (np.int16, (9, 5)), (np.int32, (33, 17)),
          (np.float32, (20, 20)), (np.float32, (12, 7, 4)), (np.float64, (4, 4))]
COMPRESSIONS = ["none", "deflate", "packbits", "lzw"]


def _array(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return rng.integers(info.min // 2, info.max // 2, shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _cases():
    for dtype, shape in DTYPES:
        for comp in COMPRESSIONS:
            for pred in (1, 2):
                if pred == 2 and np.issubdtype(dtype, np.floating):
                    continue  # predictor 2 is integer differencing
                yield pytest.param(dtype, shape, comp, pred, id=f"{np.dtype(dtype).name}-{comp}-p{pred}")


@pytest.mark.parametrize("dtype,shape,comp,pred", list(_cases()))
def test_roundtrip_and_cross_read(tmp_path, dtype, shape, comp, pred):
    arr = _array(dtype, shape)
    ours, theirs = str(tmp_path / "ours.tiff"), str(tmp_path / "theirs.tiff")
    ttiff.write_tiff(ours, arr, compression=comp, predictor=pred)
    jtiff.write_tiff(theirs, arr, compression=comp, predictor=pred)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    for reader, path in ((ttiff.read_tiff, ours), (ttiff.read_tiff, theirs), (jtiff.read_tiff, ours)):
        back = reader(path)
        assert back.dtype == arr.dtype
        np.testing.assert_array_equal(back.reshape(arr.shape), arr)


def test_lzw_width_bumps_and_table_clear(tmp_path):
    """Large enough to cross every LZW code width (9 to 12 bits) and clear
    the table mid-stream, in both readers."""
    arr = np.random.default_rng(4).integers(0, 256, (64, 70, 3)).astype(np.uint8)
    p = str(tmp_path / "big.tiff")
    ttiff.write_tiff(p, arr, compression="lzw")
    np.testing.assert_array_equal(ttiff.read_tiff(p), arr)
    np.testing.assert_array_equal(jtiff.read_tiff(p), arr)


def test_big_endian_planar(tmp_path):
    """A hand-built MM (big-endian), planar-config-2 file, two strips."""
    arr = np.arange(2 * 3 * 4, dtype=np.uint8).reshape(3, 4, 2)
    h, w, spp = arr.shape
    planes = arr.transpose(2, 0, 1).tobytes()
    tags = [(256, 4, 1, (w,)), (257, 4, 1, (h,)), (258, 3, 2, (8, 8)), (259, 3, 1, (1,)), (273, 4, 2, None),
            (277, 3, 1, (spp,)), (279, 4, 2, (h * w, h * w)), (284, 3, 1, (2,)), (339, 3, 2, (1, 1))]
    extra_off = 8 + 2 + 12 * len(tags) + 4
    pix_off = extra_off + 8 + 8  # the two offsets, the two counts
    entries, extra = b"", b""
    for tag, ftype, n, vals in tags:
        size = {3: 2, 4: 4}[ftype] * n
        if vals is None:  # strip offsets, past the counts
            vals = (pix_off, pix_off + h * w)
        code = {3: "H", 4: "I"}[ftype]
        if size <= 4:
            vb = struct.pack(">" + code * n, *vals).ljust(4, b"\0")
        else:
            vb = struct.pack(">I", extra_off + len(extra))
            extra += struct.pack(">" + code * n, *vals)
        entries += struct.pack(">HHI", tag, ftype, n) + vb
    blob = struct.pack(">2sHI", b"MM", 42, 8) + struct.pack(">H", len(tags)) + entries + b"\0\0\0\0" + extra
    assert len(blob) == pix_off, (len(blob), pix_off)
    p = str(tmp_path / "mm.tiff")
    with open(p, "wb") as f:
        f.write(blob + planes)
    np.testing.assert_array_equal(ttiff.read_tiff(p), arr)
    np.testing.assert_array_equal(ttiff.read_tiff(p), jtiff.read_tiff(p))


@pytest.mark.parametrize("pilcomp", ["raw", "tiff_adobe_deflate", "packbits", "tiff_lzw"])
def test_reads_libtiff_strips(tmp_path, pilcomp):
    """libtiff-encoded strips (through PIL, about 8 KB a strip, each its own
    stream) decode as the JAX reader decodes them."""
    image = pytest.importorskip("PIL.Image")
    img = np.random.default_rng(5).integers(0, 256, (150, 120, 3)).astype(np.uint8)
    img[:50] = 7  # long runs: RLE and LZW clears
    p = str(tmp_path / "libtiff.tiff")
    image.fromarray(img).save(p, compression=pilcomp)
    np.testing.assert_array_equal(ttiff.read_tiff(p), img)
    np.testing.assert_array_equal(ttiff.read_tiff(p), jtiff.read_tiff(p))


def test_unsupported_layouts_raise(tmp_path):
    image = pytest.importorskip("PIL.Image")
    p = str(tmp_path / "jpg.tiff")
    image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(p, compression="jpeg")
    with pytest.raises(ValueError, match="compression"):
        ttiff.read_tiff(p)
    # a TIFF without strip offsets (tiled): a clear error, not a KeyError
    arr = np.zeros((4, 4), np.uint8)
    q = tmp_path / "tiled.tiff"
    ttiff.write_tiff(str(q), arr)
    blob = bytearray(q.read_bytes())
    (count,) = struct.unpack_from("<H", blob, 8)
    for i in range(count):
        if struct.unpack_from("<H", blob, 10 + 12 * i)[0] == 273:
            struct.pack_into("<H", blob, 10 + 12 * i, 324)  # StripOffsets -> TileOffsets
    q.write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="strip"):
        ttiff.read_tiff(str(q))
    np.save(str(tmp_path / "x.npy"), arr)
    with pytest.raises(ValueError, match="not a TIFF"):
        ttiff.read_tiff(str(tmp_path / "x.npy"))
