"""Result-container structures (JAX package eval/structures.py:19-243): the
detectron2 `Instances` / `Boxes` / `BitMasks` / `BoxMode` / `ImageList`
surface the reference trainers touch (maskformer_train_ins_vit.py:21,357-362;
utils/instances.py, utils/boxes.py, utils/masks.py vendored from detectron2).

Numpy on the host, as in the JAX package: these carry post-processed
predictions between inference and evaluation or serialization.
``BitMasks`` and ``Instances.from_dict`` also take torch tensors on any
device (the port's instance dicts), each brought to the host once;
``from_dict`` / ``to_dict`` bridge to those dicts.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple, Union

import numpy as np

from .coco_eval import box_iou, boxes_from_masks
from .metrics import to_numpy


class Boxes:
    """[N, 4] xyxy boxes (utils/boxes.py Boxes role)."""

    def __init__(self, tensor: np.ndarray):
        t = np.asarray(tensor, np.float32).reshape(-1, 4)
        self.tensor = t

    def __len__(self) -> int:
        return self.tensor.shape[0]

    def __getitem__(self, item) -> "Boxes":
        return Boxes(self.tensor[item])

    def area(self) -> np.ndarray:
        t = self.tensor
        return (t[:, 2] - t[:, 0]) * (t[:, 3] - t[:, 1])

    def clip(self, box_size: Tuple[int, int]) -> None:
        h, w = box_size
        self.tensor[:, 0::2] = np.clip(self.tensor[:, 0::2], 0, w)
        self.tensor[:, 1::2] = np.clip(self.tensor[:, 1::2], 0, h)

    def nonempty(self, threshold: float = 0.0) -> np.ndarray:
        t = self.tensor
        return ((t[:, 2] - t[:, 0]) > threshold) & ((t[:, 3] - t[:, 1]) > threshold)

    def scale(self, scale_x: float, scale_y: float) -> None:
        self.tensor[:, 0::2] *= scale_x
        self.tensor[:, 1::2] *= scale_y

    def iou(self, other: "Boxes") -> np.ndarray:
        return box_iou(self.tensor, other.tensor)

    @staticmethod
    def cat(boxes_list: Sequence["Boxes"]) -> "Boxes":
        return Boxes(np.concatenate([b.tensor for b in boxes_list], axis=0)
                     if boxes_list else np.zeros((0, 4), np.float32))


class BoxMode:
    """XYXY_ABS <-> XYWH_ABS conversions (utils/boxes.py BoxMode; the only
    modes the reference's COCO json paths exercise)."""

    XYXY_ABS = 0
    XYWH_ABS = 1

    @staticmethod
    def convert(box: np.ndarray, from_mode: int, to_mode: int) -> np.ndarray:
        box = np.asarray(box, np.float32)
        if from_mode == to_mode:
            return box.copy()
        out = box.copy()
        if from_mode == BoxMode.XYWH_ABS and to_mode == BoxMode.XYXY_ABS:
            out[..., 2] = box[..., 0] + box[..., 2]
            out[..., 3] = box[..., 1] + box[..., 3]
        elif from_mode == BoxMode.XYXY_ABS and to_mode == BoxMode.XYWH_ABS:
            out[..., 2] = box[..., 2] - box[..., 0]
            out[..., 3] = box[..., 3] - box[..., 1]
        else:
            raise ValueError(f"unsupported conversion {from_mode}->{to_mode}")
        return out


class BitMasks:
    """[N, H, W] binary masks (utils/masks.py BitMasks role); an array or a
    tensor on any device."""

    def __init__(self, tensor):
        self.tensor = to_numpy(tensor).astype(bool)

    def __len__(self) -> int:
        return self.tensor.shape[0]

    def __getitem__(self, item) -> "BitMasks":
        return BitMasks(self.tensor[item])

    def get_bounding_boxes(self) -> Boxes:
        return Boxes(boxes_from_masks(self.tensor))

    def nonempty(self) -> np.ndarray:
        return self.tensor.any(axis=(1, 2))

    def area(self) -> np.ndarray:
        return self.tensor.sum(axis=(1, 2)).astype(np.float32)


class ImageList:
    """Batch of variable-size images padded into one array, with original
    sizes retained (utils/image_list.py:22-109 role). NHWC; pad stride
    mirrors the ÷`size_divisibility` padding `infer_segmentation.py` applies
    before the jitted forward (static shapes for XLA)."""

    def __init__(self, tensor: np.ndarray, image_sizes: List[Tuple[int, int]]):
        self.tensor = tensor
        self.image_sizes = list(image_sizes)

    def __len__(self) -> int:
        return len(self.image_sizes)

    def __getitem__(self, idx: int) -> np.ndarray:
        h, w = self.image_sizes[idx]
        return self.tensor[idx, :h, :w]

    @staticmethod
    def from_tensors(tensors: Sequence[np.ndarray], size_divisibility: int = 0,
                     pad_value: float = 0.0) -> "ImageList":
        """tensors: list of [H, W, C] (or [H, W]) images."""
        sizes = [(t.shape[0], t.shape[1]) for t in tensors]
        max_h = max(s[0] for s in sizes)
        max_w = max(s[1] for s in sizes)
        if size_divisibility > 0:
            d = size_divisibility
            max_h = -(-max_h // d) * d
            max_w = -(-max_w // d) * d
        rest = tensors[0].shape[2:]
        out = np.full((len(tensors), max_h, max_w) + rest, pad_value,
                      np.asarray(tensors[0]).dtype)
        for i, t in enumerate(tensors):
            out[i, :t.shape[0], :t.shape[1]] = t
        return ImageList(out, sizes)


class Instances:
    """Per-image field container (utils/instances.py): named parallel arrays
    with shared length, len/index/cat, plus dict bridging to the instance
    dicts `infer_segmentation.forward_instance_segmentation` emits."""

    def __init__(self, image_size: Tuple[int, int], **fields):
        self._image_size = tuple(image_size)
        self._fields: Dict[str, object] = {}
        for k, v in fields.items():
            self.set(k, v)

    @property
    def image_size(self) -> Tuple[int, int]:
        return self._image_size

    def set(self, name: str, value) -> None:
        n = len(value)
        if self._fields:
            assert n == len(self), (
                f"field {name} has length {n}, Instances has {len(self)}")
        self._fields[name] = value

    def get(self, name: str):
        return self._fields[name]

    def has(self, name: str) -> bool:
        return name in self._fields

    def remove(self, name: str) -> None:
        del self._fields[name]

    def get_fields(self) -> Dict[str, object]:
        return self._fields

    def __setattr__(self, name: str, value) -> None:
        if name.startswith("_"):
            super().__setattr__(name, value)
        else:
            self.set(name, value)

    def __getattr__(self, name: str):
        if name.startswith("_") or name not in self._fields:
            raise AttributeError(f"Instances has no field '{name}'")
        return self._fields[name]

    def __len__(self) -> int:
        for v in self._fields.values():
            return len(v)
        return 0

    def __getitem__(self, item) -> "Instances":
        if isinstance(item, (int, np.integer)):  # keep fields 1-D, as d2 does
            item = slice(item, item + 1 if item != -1 else None)
        out = Instances(self._image_size)
        for k, v in self._fields.items():
            out.set(k, v[item])
        return out

    def __iter__(self) -> Iterator["Instances"]:
        for i in range(len(self)):
            yield self[i]

    @staticmethod
    def cat(instance_list: Sequence["Instances"]) -> "Instances":
        assert instance_list
        out = Instances(instance_list[0].image_size)
        for k in instance_list[0].get_fields():
            vals = [inst.get(k) for inst in instance_list]
            if isinstance(vals[0], Boxes):
                out.set(k, Boxes.cat(vals))
            elif isinstance(vals[0], BitMasks):
                out.set(k, BitMasks(np.concatenate([v.tensor for v in vals])))
            else:
                out.set(k, np.concatenate([np.asarray(v) for v in vals]))
        return out

    # -- bridges to the framework's plain instance dicts -----------------
    @staticmethod
    def from_dict(d: Dict[str, object],
                  image_size: Tuple[int, int]) -> "Instances":
        """An instance dict of arrays or tensors (on any device) as
        Instances."""
        inst = Instances(image_size)
        for k, v in d.items():
            v = to_numpy(v)
            if k == "pred_boxes":
                inst.set(k, Boxes(v))
            elif k == "pred_masks":
                inst.set(k, BitMasks(v > 0.5))
            else:
                inst.set(k, v)
        return inst

    def to_dict(self) -> Dict[str, np.ndarray]:
        out = {}
        for k, v in self._fields.items():
            if isinstance(v, Boxes):
                out[k] = v.tensor
            elif isinstance(v, BitMasks):
                out[k] = v.tensor
            else:
                out[k] = np.asarray(v)
        return out
