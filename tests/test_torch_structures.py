"""The port's result containers (``eval/structures.py``) against the JAX
package's on the same seeded arrays: every case of tests/test_structures.py
run through both, results equal exactly (both sides are numpy), plus the
port's conversions from torch tensors (``BitMasks``, ``Instances.from_dict``)."""
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu.eval import structures as jst
from incomplete_multimodal_fusion_tpu_torch.eval import structures as tst

MODULES = [jst, tst]


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _both(fn):
    """``fn(module)`` for the JAX module and the port's."""
    return [fn(m) for m in MODULES]


@pytest.mark.parametrize("size_divisibility", [0, 8, 5])
def test_imagelist_padding(size_divisibility):
    rng = np.random.default_rng(size_divisibility)
    imgs = [rng.standard_normal((5, 7, 3)).astype(np.float32), rng.standard_normal((9, 4, 3)).astype(np.float32)]
    jil, til = _both(lambda m: m.ImageList.from_tensors(imgs, size_divisibility=size_divisibility, pad_value=0.5))
    _eq(til.tensor, jil.tensor)
    assert til.image_sizes == jil.image_sizes and len(til) == len(jil) == 2
    for i in range(2):
        _eq(til[i], jil[i])
        _eq(til[i], imgs[i])


def test_boxes_ops():
    rng = np.random.default_rng(1)
    raw = np.concatenate([np.array([[1, 2, 5, 6], [0, 0, 0, 0], [-2, -2, 300, 10]], np.float32),
                          rng.uniform(-5, 20, (5, 4)).astype(np.float32)])
    jb, tb = _both(lambda m: m.Boxes(raw.copy()))
    _eq(tb.area(), jb.area())
    _eq(tb.nonempty(), jb.nonempty())
    _eq(tb.nonempty(1.5), jb.nonempty(1.5))
    for b in (jb, tb):
        b.clip((8, 10))
        b.scale(2.0, 0.5)
    _eq(tb.tensor, jb.tensor)
    _eq(tb[1:3].tensor, jb[1:3].tensor)
    _eq(tst.Boxes.cat([tb, tb]).tensor, jst.Boxes.cat([jb, jb]).tensor)
    _eq(tst.Boxes.cat([]).tensor, jst.Boxes.cat([]).tensor)
    other = rng.uniform(0, 10, (3, 4)).astype(np.float32)
    _eq(tb.iou(tst.Boxes(other)), jb.iou(jst.Boxes(other)))
    np.testing.assert_allclose(tst.Boxes(np.array([[0, 0, 4, 4]])).iou(tst.Boxes(np.array([[2, 2, 6, 6]]))),
                               [[4.0 / 28.0]], rtol=1e-6)


@pytest.mark.parametrize("src,dst", [("XYWH_ABS", "XYXY_ABS"), ("XYXY_ABS", "XYWH_ABS"), ("XYXY_ABS", "XYXY_ABS")])
def test_boxmode_convert(src, dst):
    boxes = np.random.default_rng(2).uniform(0, 30, (4, 4)).astype(np.float32)
    jout, tout = _both(lambda m: m.BoxMode.convert(boxes, getattr(m.BoxMode, src), getattr(m.BoxMode, dst)))
    _eq(tout, jout)
    back = tst.BoxMode.convert(tout, getattr(tst.BoxMode, dst), getattr(tst.BoxMode, src))
    np.testing.assert_allclose(back, boxes, rtol=1e-6, atol=1e-5)


def test_boxmode_refuses_unknown_modes():
    for m in MODULES:
        with pytest.raises(ValueError):
            m.BoxMode.convert(np.zeros((1, 4)), 0, 7)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_bitmasks(as_tensor):
    rng = np.random.default_rng(3)
    m = rng.random((4, 12, 10)) > 0.7
    m[1] = False
    m[2, 2:5, 3:7] = True
    jm = jst.BitMasks(m)
    tm = tst.BitMasks(torch.from_numpy(m).float() if as_tensor else m)
    _eq(tm.tensor, jm.tensor)
    _eq(tm.nonempty(), jm.nonempty())
    _eq(tm.area(), jm.area())
    _eq(tm.get_bounding_boxes().tensor, jm.get_bounding_boxes().tensor)
    _eq(tm[1:3].tensor, jm[1:3].tensor)
    assert len(tm) == len(jm) == 4


def test_instances_container():
    for m in MODULES:
        inst = m.Instances((16, 16))
        inst.scores = np.array([0.9, 0.2, 0.7])
        inst.pred_classes = np.array([1, 0, 1])
        inst.pred_boxes = m.Boxes(np.zeros((3, 4)))
        assert len(inst) == 3 and inst.has("scores") and inst.image_size == (16, 16)
        with pytest.raises(AssertionError):
            inst.bad = np.zeros(5)  # length mismatch rejected
        with pytest.raises(AttributeError):
            inst.missing
        top = inst[inst.scores >= 0.5]
        assert len(top) == 2 and top.pred_classes.tolist() == [1, 1]
        assert len(inst[0]) == 1 and len(inst[-1]) == 1
        cat = m.Instances.cat([top, top])
        assert len(cat) == 4 and len(cat.pred_boxes) == 4
        assert [len(i) for i in inst] == [1, 1, 1]
        inst.remove("scores")
        assert not inst.has("scores") and set(inst.get_fields()) == {"pred_classes", "pred_boxes"}


@pytest.mark.parametrize("as_tensor", [False, True])
def test_instances_dict_bridge(as_tensor):
    rng = np.random.default_rng(4)
    d = {"scores": rng.random(3).astype(np.float32), "pred_classes": np.array([0, 2, 1]),
         "pred_masks": rng.random((3, 6, 5)).astype(np.float32),
         "pred_boxes": rng.uniform(0, 5, (3, 4)).astype(np.float32)}
    jinst = jst.Instances.from_dict(d, (6, 5))
    tinst = tst.Instances.from_dict({k: torch.from_numpy(v) for k, v in d.items()} if as_tensor else d, (6, 5))
    assert isinstance(tinst.pred_masks, tst.BitMasks) and isinstance(tinst.pred_boxes, tst.Boxes)
    jd, td = jinst.to_dict(), tinst.to_dict()
    assert set(td) == set(jd)
    for k in jd:
        _eq(td[k], jd[k])
    cat_j, cat_t = jst.Instances.cat([jinst, jinst[1:]]), tst.Instances.cat([tinst, tinst[1:]])
    for k, v in cat_j.to_dict().items():
        _eq(cat_t.to_dict()[k], v)
