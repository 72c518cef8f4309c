"""Small dataset trees in each reader's layout, written from a seed with the
port's TIFF codec: for the tests, the card smoke and trying the command
lines without a download. The pixel values are random; the layouts, dtypes
and band counts are those the readers take:

  * ``write_dfc2023``: ``rgb/`` uint8 [H, W, 3], ``sar/`` and ``dsm/`` float32
    [H, W] TIFFs (``lc/`` uint8 labels with ``labeled``), or ``.npy``
    side-cars [C, H, W] float32 with ``npy``;
  * ``write_coco``: a DFC2023-style ``rgb/sar/dsm`` tree under ``images/``
    and a COCO json of polygon (and uncompressed RLE) annotations;
  * ``write_quadruplet``: ``f1/{s2,s1,dem,dnw,lc}_area/tile{i}.tif``: s2
    uint16 4 bands, s1 float32 2 bands, dem float32, dnw uint8, lc uint8 RGB
    from the land-cover color table;
  * ``write_ade``: ``img/`` uint8 [H, W, 3] and ``ann/`` uint8 [H, W]
    ``.npy`` images and a ``training.odgt`` list.
"""
from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np

from .tiff import write_tiff


def _write_all(jobs, threads: int) -> None:
    """write_tiff for each (path, array, compression, predictor), on
    ``threads`` threads (zlib releases the interpreter lock)."""
    def one(job):
        path, arr, compression, predictor = job
        if path.endswith(".npy"):
            np.save(path, arr)
        else:
            write_tiff(path, arr, compression=compression, predictor=predictor)

    if threads > 1:
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(one, jobs))
    else:
        for job in jobs:
            one(job)


def write_dfc2023(root: str, n: int, size: int, seed: int = 0, compression: str = "none",
                  labeled: bool = False, npy: bool = False, threads: int = 1) -> str:
    rng = np.random.default_rng(seed)
    subs = ("rgb", "sar", "dsm") + (("lc",) if labeled else ())
    for sub in subs:
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    jobs = []
    for i in range(n):
        rgb = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        sar = rng.uniform(0.0, 2.0, (size, size)).astype(np.float32)
        dsm = rng.uniform(-3.0, 40.0, (size, size)).astype(np.float32)
        arrays = {"rgb": rgb, "sar": sar, "dsm": dsm}
        if labeled:
            arrays["lc"] = rng.integers(0, 10, (size, size), dtype=np.uint8)
        for sub, arr in arrays.items():
            if npy:
                arr = arr.transpose(2, 0, 1) if arr.ndim == 3 else arr[None]
                jobs.append((os.path.join(root, sub, f"t{i:04d}.npy"), arr.astype(np.float32), None, 1))
            else:
                jobs.append((os.path.join(root, sub, f"t{i:04d}.tiff"), arr, compression, 1))
    _write_all(jobs, threads)
    return root


def _polygon(rng, size: int) -> list:
    """A random convex quadrilateral inside the image, flat [x0, y0, ...]."""
    cx, cy = rng.uniform(0.2 * size, 0.8 * size, 2)
    r = rng.uniform(0.05 * size, 0.2 * size)
    angles = np.sort(rng.uniform(0, 2 * np.pi, 4))
    return [float(v) for a in angles for v in (cx + r * np.cos(a), cy + r * np.sin(a))]


def write_coco(root: str, n: int, size: int, seed: int = 0, num_classes: int = 1,
               threads: int = 1) -> Tuple[str, str]:
    """Returns (the images' root, the annotation json). Each image has 1-4
    annotated polygons; the odd images also a crowd annotation (dropped by
    the reader) and the images divisible by 3 an uncompressed RLE mask."""
    rng = np.random.default_rng(seed)
    write_dfc2023(os.path.join(root, "images"), n, size, seed=seed + 1, threads=threads)
    images, annotations = [], []
    for i in range(n):
        images.append({"id": i, "file_name": f"images/rgb/t{i:04d}.tiff", "height": size, "width": size})
        for _ in range(int(rng.integers(1, 5))):
            annotations.append({"id": len(annotations), "image_id": i, "iscrowd": 0, "area": float(size),
                                "category_id": int(rng.integers(1, num_classes + 1)),
                                "segmentation": [_polygon(rng, size)]})
        if i % 2:
            annotations.append({"id": len(annotations), "image_id": i, "iscrowd": 1, "area": float(size),
                                "category_id": 1, "segmentation": [_polygon(rng, size)]})
        if i % 3 == 0:
            start = int(rng.integers(0, size * size // 2))
            counts = [start, size * 4, size * size - start - size * 4]
            annotations.append({"id": len(annotations), "image_id": i, "iscrowd": 0, "area": float(size * 4),
                                "category_id": 1, "segmentation": {"counts": counts, "size": [size, size]}})
    coco = {"images": images, "annotations": annotations,
            "categories": [{"id": c, "name": f"class{c}"} for c in range(1, num_classes + 1)]}
    path = os.path.join(root, "train.json")
    with open(path, "w") as f:
        json.dump(coco, f)
    return root, path


def write_quadruplet(root: str, n: int, size: int, seed: int = 0, place: str = "f1", threads: int = 1) -> str:
    from .quadruplet import LC_COLORMAP

    rng = np.random.default_rng(seed)
    dirs = {k: os.path.join(root, place, f"{k}_area") for k in ("s2", "s1", "dem", "dnw", "lc")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    colors = np.asarray(LC_COLORMAP, np.uint8)
    jobs = []
    for i in range(n):
        arrays = {
            "s2": rng.integers(0, 12000, (size, size, 4)).astype(np.uint16),
            "s1": rng.uniform(-30.0, 30.0, (size, size, 2)).astype(np.float32),
            "dem": rng.uniform(-200.0, 6000.0, (size, size)).astype(np.float32),
            "dnw": rng.integers(0, 9, (size, size), dtype=np.uint8),
            "lc": colors[rng.integers(0, 12, (size, size))],
        }
        for k, arr in arrays.items():
            jobs.append((os.path.join(dirs[k], f"tile{i:04d}.tif"), arr, "none", 1))
    _write_all(jobs, threads)
    return root


def write_ade(root: str, n: int, shape: Tuple[int, int], seed: int = 0, num_classes: int = 10) -> Tuple[str, str]:
    """Returns (the root, the odgt list)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "img"), exist_ok=True)
    os.makedirs(os.path.join(root, "ann"), exist_ok=True)
    records = []
    for i in range(n):
        np.save(os.path.join(root, "img", f"i{i:04d}.npy"), rng.integers(0, 256, shape + (3,), dtype=np.uint8))
        np.save(os.path.join(root, "ann", f"i{i:04d}.npy"),
                rng.integers(0, num_classes, shape, dtype=np.uint8))
        records.append({"fpath_img": f"img/i{i:04d}.npy", "fpath_segm": f"ann/i{i:04d}.npy",
                        "height": shape[0], "width": shape[1]})
    path = os.path.join(root, "training.odgt")
    with open(path, "w") as f:
        f.write("\n".join(json.dumps(r) for r in records))
    return root, path
