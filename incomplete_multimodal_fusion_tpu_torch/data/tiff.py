"""Minimal zero-dependency TIFF codec for the raster pipeline (JAX package
data/tiff.py, the same codec byte for byte).

The DFC2023 tree the reference trains on (multimodal_dfc2023.py:99-141) is
GeoTIFF rasters: uint8 RGB, float32 SAR/DSM. GeoTIFF is plain TIFF plus
georeferencing tags the training path never reads, so pixel ingestion only
needs TIFF 6.0. This module decodes (and encodes, for tests and dataset
preparation) strip-based TIFF with uint8/uint16/int16/int32/float32/float64
samples, chunky or planar layout, either byte order, and the compressions
real GeoTIFF trees use: deflate (zip), packbits and LZW, each with the
horizontal-differencing predictor (tag 317, predictor=2) that gdal/rasterio
apply by default alongside them. It is the port's only TIFF reader: the
port reads no raster through rasterio, tifffile or PIL.

Deliberately not a general TIFF library: tiled layout, JPEG compression and
the floating-point predictor (3) raise a clear error.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

# TIFF tag ids (TIFF 6.0 spec)
_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTOMETRIC = 256, 257, 258, 259, 262
_STRIP_OFFSETS, _SAMPLES_PER_PIXEL, _ROWS_PER_STRIP = 273, 277, 278
_STRIP_COUNTS, _PLANAR, _SAMPLE_FORMAT = 279, 284, 339
_PREDICTOR = 317

# compression tag values (TIFF 6.0 + the Adobe deflate extension)
_C_NONE, _C_LZW, _C_DEFLATE_ADOBE, _C_DEFLATE_OLD, _C_PACKBITS = 1, 5, 8, 32946, 32773
_COMP_NAMES = {"none": _C_NONE, "lzw": _C_LZW, "deflate": _C_DEFLATE_ADOBE,
               "packbits": _C_PACKBITS}

# field type -> (struct code, byte size)
_FIELD = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4), 8: ("h", 2), 9: ("i", 4),
          16: ("Q", 8), 17: ("q", 8)}

# (sample_format, bits) -> numpy dtype char
_DTYPES = {(1, 8): "u1", (1, 16): "u2", (1, 32): "u4",
           (2, 8): "i1", (2, 16): "i2", (2, 32): "i4",
           (3, 32): "f4", (3, 64): "f8"}


def _packbits_decode(data: bytes) -> bytes:
    """Apple PackBits RLE (TIFF 6.0 §9)."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        h = data[i]
        i += 1
        if h < 128:  # literal run of h+1 bytes
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:  # replicate next byte 257-h times
            out += data[i:i + 1] * (257 - h)
            i += 1
        # h == 128: no-op
    return bytes(out)


def _packbits_encode(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        # find a replicate run (>= 3 repeats pays for itself)
        j = i
        while j + 1 < n and data[j + 1] == data[j] and j - i < 127:
            j += 1
        run = j - i + 1
        if run >= 3:
            out += bytes([257 - run, data[i]])
            i = j + 1
            continue
        # literal run up to the next >=3 replicate or 128 bytes
        j = i
        while j < n and j - i < 127:
            if j + 2 < n and data[j] == data[j + 1] == data[j + 2]:
                break
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _lzw_decode(data: bytes) -> bytes:
    """TIFF-variant LZW (TIFF 6.0 §13): MSB-first bit packing, 9→12 bit
    codes with the 'early change' width bump, ClearCode=256, EOI=257."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    nbits = len(data) * 8
    bitpos = 0
    width = 9
    table = None
    prev = None
    while bitpos + width <= nbits:
        byte_off = bitpos >> 3
        chunk = int.from_bytes(data[byte_off:byte_off + 4].ljust(4, b"\0"),
                               "big")
        code = (chunk >> (32 - (bitpos & 7) - width)) & ((1 << width) - 1)
        bitpos += width
        if code == EOI:
            break
        if code == CLEAR:
            table = [bytes([i]) for i in range(256)] + [b"", b""]
            width = 9
            prev = None
            continue
        if table is None:
            raise ValueError("LZW stream does not start with a clear code")
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:  # the K-omega-K special case
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        # "early change" width bump, decoder side, libtiff-calibrated: bump
        # when the table reaches 2^width - 1 entries (the decoder's table
        # lags the encoder's by one, so the encoder-side condition is
        # next_code == 2^width). Validated against libtiff streams via PIL
        # in tests/test_data_tiff.py.
        if len(table) >= (1 << width) - 1 and width < 12:
            width += 1
    return bytes(out)


def _lzw_encode(data: bytes) -> bytes:
    CLEAR, EOI = 256, 257
    bits = bytearray()
    acc, nacc = 0, 0

    def emit(code: int, width: int):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            bits.append((acc >> nacc) & 0xFF)

    def fresh():
        return {bytes([i]): i for i in range(256)}

    width = 9
    emit(CLEAR, width)
    table = fresh()
    next_code = 258
    w = b""
    for b in data:
        ch = bytes([b])
        wc = w + ch
        if wc in table:
            w = wc
            continue
        emit(table[w], width)
        table[wc] = next_code
        next_code += 1
        if next_code == (1 << width) and width < 12:  # early change (libtiff)
            width += 1
        if next_code > 4093:  # table nearly full: restart
            emit(CLEAR, width)
            table = fresh()
            next_code = 258
            width = 9
        w = ch
    if w:
        emit(table[w], width)
    emit(EOI, width)
    if nacc:
        bits.append((acc << (8 - nacc)) & 0xFF)
    return bytes(bits)


_DECODERS = {
    _C_NONE: lambda b: b,
    _C_LZW: _lzw_decode,
    _C_DEFLATE_ADOBE: zlib.decompress,
    _C_DEFLATE_OLD: zlib.decompress,
    _C_PACKBITS: _packbits_decode,
}
_ENCODERS = {
    _C_NONE: lambda b: b,
    _C_LZW: _lzw_encode,
    _C_DEFLATE_ADOBE: zlib.compress,
    _C_PACKBITS: _packbits_encode,
}


def _undo_predictor2(raw: bytes, rows: int, w: int, spp: int,
                     dt: np.dtype) -> bytes:
    """Horizontal differencing (predictor=2): each sample stores the delta
    to the previous pixel's same sample in the row; undo = cumsum along the
    row with the storage dtype's modular arithmetic."""
    native = dt.newbyteorder("=")
    arr = np.frombuffer(raw, dtype=dt).reshape(rows, w, spp).astype(native)
    with np.errstate(over="ignore"):
        np.add.accumulate(arr, axis=1, dtype=native, out=arr)
    return arr.astype(dt).tobytes()


def _apply_predictor2(pix: np.ndarray) -> bytes:
    """Forward horizontal differencing on a [rows, W, SPP] array."""
    d = pix.copy()
    with np.errstate(over="ignore"):
        d[:, 1:, :] -= pix[:, :-1, :]
    return d.tobytes()


def _read_entries(buf: bytes, off: int, en: str) -> Dict[int, Tuple]:
    (count,) = struct.unpack_from(en + "H", buf, off)
    entries = {}
    for i in range(count):
        tag, ftype, n = struct.unpack_from(en + "HHI", buf, off + 2 + 12 * i)
        if ftype not in _FIELD:
            continue  # rationals/ascii: geo tags, irrelevant to pixels
        code, size = _FIELD[ftype]
        total = size * n
        voff = off + 2 + 12 * i + 8
        if total > 4:
            (voff,) = struct.unpack_from(en + "I", buf, voff)
        entries[tag] = struct.unpack_from(en + code * n, buf, voff)
    return entries


def read_tiff(path: str) -> np.ndarray:
    """Decode the first IFD as [H, W] (1 sample) or [H, W, S] array."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:2] == b"II":
        en = "<"
    elif buf[:2] == b"MM":
        en = ">"
    else:
        raise ValueError(f"{path}: not a TIFF (bad byte-order mark)")
    magic, ifd_off = struct.unpack_from(en + "HI", buf, 2)
    if magic != 42:
        raise ValueError(f"{path}: not a classic TIFF (magic {magic})")
    e = _read_entries(buf, ifd_off, en)

    comp = e.get(_COMPRESSION, (1,))[0]
    if comp not in _DECODERS:
        raise ValueError(
            f"{path}: compression {comp} unsupported by the builtin codec "
            "(have: none/lzw/deflate/packbits) — re-encode the raster")
    pred = e.get(_PREDICTOR, (1,))[0]
    if pred not in (1, 2):
        raise ValueError(
            f"{path}: predictor {pred} unsupported by the builtin codec "
            "(have: none, horizontal differencing)")
    w = e[_WIDTH][0]
    h = e[_LENGTH][0]
    spp = e.get(_SAMPLES_PER_PIXEL, (1,))[0]
    bits = e.get(_BITS, (8,) * spp)
    fmt = e.get(_SAMPLE_FORMAT, (1,) * spp)
    if len(set(bits)) != 1 or len(set(fmt)) != 1:
        raise ValueError(f"{path}: heterogeneous samples unsupported")
    key = (fmt[0], bits[0])
    if key not in _DTYPES:
        raise ValueError(f"{path}: sample format/bits {key} unsupported")
    dt = np.dtype(en + _DTYPES[key])

    if _STRIP_OFFSETS not in e:
        raise ValueError(f"{path}: no strip offsets (a tiled TIFF?); the builtin codec reads strips only")
    offsets = e[_STRIP_OFFSETS]
    counts = e.get(_STRIP_COUNTS)
    if counts is None:  # single-strip files may omit it
        counts = (h * w * spp * dt.itemsize,)
    planar = e.get(_PLANAR, (1,))[0]
    rps = e.get(_ROWS_PER_STRIP, (h,))[0] or h
    spp_strip = 1 if (planar == 2 and spp > 1) else spp  # samples per strip row
    strips_per_image = -(-h // rps)  # strips cycle per plane when planar
    decode = _DECODERS[comp]
    chunks = []
    for i, (o, c) in enumerate(zip(offsets, counts)):
        raw = decode(buf[o:o + c])
        if pred == 2:
            row0 = (i % strips_per_image) * rps
            rows = min(rps, h - row0)
            raw = _undo_predictor2(raw, rows, w, spp_strip, dt)
        chunks.append(raw)
    arr = np.frombuffer(b"".join(chunks), dtype=dt)
    if planar == 2 and spp > 1:  # planar: strips ordered plane-major
        arr = arr.reshape(spp, h, w).transpose(1, 2, 0)
    else:
        arr = arr.reshape(h, w, spp) if spp > 1 else arr.reshape(h, w)
    return np.ascontiguousarray(arr)


def write_tiff(path: str, arr: np.ndarray, compression: str = "none",
               predictor: int = 1) -> None:
    """Encode [H, W] or [H, W, S] as single-strip little-endian TIFF.

    compression: "none" | "deflate" | "packbits" | "lzw".
    predictor=2 applies horizontal differencing before compression (the
    gdal/rasterio default companion for lzw/deflate on integer rasters).
    """
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, spp = arr.shape
    dt = arr.dtype
    fmt = {"u": 1, "i": 2, "f": 3}[dt.kind]
    bits = dt.itemsize * 8
    if (fmt, bits) not in _DTYPES:
        raise ValueError(f"cannot encode dtype {dt}")
    comp = _COMP_NAMES.get(compression)
    if comp is None:
        raise ValueError(f"unknown compression {compression!r} "
                         f"(have {sorted(_COMP_NAMES)})")
    if predictor not in (1, 2):
        raise ValueError("predictor must be 1 or 2")
    if predictor == 2 and dt.kind == "f":
        raise ValueError("predictor=2 is integer horizontal differencing; "
                         "float rasters use predictor=3 (unsupported) or 1")
    pix_arr = np.ascontiguousarray(arr, dtype=dt.newbyteorder("<"))
    if predictor == 2:
        pix = _apply_predictor2(pix_arr.reshape(h, w, spp))
    else:
        pix = pix_arr.tobytes()
    pix = _ENCODERS[comp](pix)

    tags = []  # (tag, ftype, count, values)
    def tag(t, ftype, vals):
        tags.append((t, ftype, len(vals), tuple(vals)))

    tag(_WIDTH, 4, [w])
    tag(_LENGTH, 4, [h])
    tag(_BITS, 3, [bits] * spp)
    tag(_COMPRESSION, 3, [comp])
    tag(_PHOTOMETRIC, 3, [2 if spp == 3 else 1])
    tag(_STRIP_OFFSETS, 4, [0])  # patched below
    tag(_SAMPLES_PER_PIXEL, 3, [spp])
    tag(_ROWS_PER_STRIP, 4, [h])
    tag(_STRIP_COUNTS, 4, [len(pix)])
    tag(_PLANAR, 3, [1])
    tag(_SAMPLE_FORMAT, 3, [fmt] * spp)
    if predictor == 2:
        tag(_PREDICTOR, 3, [2])
    tags.sort()

    ifd_off = 8
    ifd_size = 2 + 12 * len(tags) + 4
    extra_off = ifd_off + ifd_size
    extra = b""
    entries = b""
    data_off = None  # where the strip-offset value lives, patched at the end
    for t, ftype, n, vals in tags:
        code, size = _FIELD[ftype]
        total = size * n
        if total <= 4:
            vbytes = struct.pack("<" + code * n, *vals).ljust(4, b"\0")
        else:
            vbytes = struct.pack("<I", extra_off + len(extra))
            extra += struct.pack("<" + code * n, *vals)
        if t == _STRIP_OFFSETS:
            data_off = ifd_off + 2 + len(entries) + 8
        entries += struct.pack("<HHI", t, ftype, n) + vbytes
    pix_off = extra_off + len(extra)
    head = struct.pack("<2sHI", b"II", 42, ifd_off)
    ifd = struct.pack("<H", len(tags)) + entries + struct.pack("<I", 0)
    blob = bytearray(head + ifd + extra + pix)
    struct.pack_into("<I", blob, data_off, pix_off)
    with open(path, "wb") as f:
        f.write(bytes(blob))
