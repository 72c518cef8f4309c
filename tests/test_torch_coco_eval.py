"""The port's COCO mask evaluation (``eval/coco_eval.py``) against the JAX
package's on seeded random predictions and ground truths: empty images,
one class and several, objects in every area range, segm and bbox IoU,
supplied boxes; ``mask_iou``, ``box_iou``, ``boxes_from_masks``, every key
of ``summarize()`` and ``predictions_to_coco_json``'s JSON equal exactly
(both sides are numpy), with numpy arrays or torch tensors given to the
port. The hand-made cases of tests/test_eval_extras.py run through both too."""
import json

import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu.eval import coco_eval as jce
from incomplete_multimodal_fusion_tpu_torch.eval import coco_eval as tce

SIZE = 128  # small (< 32^2), medium and large (> 96^2) objects all fit


def _rect(rng, size):
    """A random rectangle mask, its side drawn so every area range occurs."""
    side_h, side_w = (int(rng.choice([rng.integers(3, 30), rng.integers(33, 95), rng.integers(98, size)]))
                      for _ in range(2))
    r, c = int(rng.integers(0, size - side_h + 1)), int(rng.integers(0, size - side_w + 1))
    m = np.zeros((size, size), np.float32)
    m[r:r + side_h, c:c + side_w] = 1.0
    return m


def _image(rng, num_classes, empty):
    """(pred masks, classes, scores, gt masks, classes) of one image: each
    gt object predicted as a shifted copy (some dropped), plus junk; an
    empty image has no predictions, no ground truth, or neither."""
    g = 0 if empty in ("gt", "both") else int(rng.integers(1, 6))
    gt = np.stack([_rect(rng, SIZE) for _ in range(g)]) if g else np.zeros((0, SIZE, SIZE), np.float32)
    gt_cls = rng.integers(0, num_classes, g)
    preds, cls = [], []
    if empty not in ("pred", "both"):
        for m, c in zip(gt, gt_cls):
            if rng.random() < 0.8:
                preds.append(np.roll(m, tuple(rng.integers(-6, 7, 2)), axis=(0, 1)))
                cls.append(c if rng.random() < 0.85 else rng.integers(0, num_classes))
        for _ in range(int(rng.integers(0, 4))):
            preds.append(_rect(rng, SIZE))
            cls.append(rng.integers(0, num_classes))
    p = len(preds)
    pm = np.stack(preds) if p else np.zeros((0, SIZE, SIZE), np.float32)
    return pm, np.asarray(cls, np.int64).reshape(p), rng.random(p), gt, gt_cls


def _scenario(seed, num_classes, n_images=6):
    rng = np.random.default_rng(seed)
    empties = [None, "pred", None, "gt", None, "both"]
    return [_image(rng, num_classes, empties[i % len(empties)]) for i in range(n_images)]


def _as_port_input(x, tensors):
    return torch.from_numpy(np.ascontiguousarray(x)) if tensors else x


def _summaries(images, num_classes, iou_type, tensors, max_dets=100, supply_boxes=False):
    jev = jce.CocoMaskEvaluator(num_classes, max_dets=max_dets, iou_type=iou_type)
    tev = tce.CocoMaskEvaluator(num_classes, max_dets=max_dets, iou_type=iou_type)
    for pm, pc, ps, gm, gc in images:
        boxes = {}
        if supply_boxes:
            boxes = dict(pred_boxes=jce.boxes_from_masks(pm) + 0.5, gt_boxes=jce.boxes_from_masks(gm))
        jev.add_image(pm, pc, ps, gm, gc, **boxes)
        tev.add_image(*(_as_port_input(v, tensors) for v in (pm, pc, ps, gm, gc)),
                      **{k: _as_port_input(v, tensors) for k, v in boxes.items()})
    return jev.summarize(), tev.summarize()


@pytest.mark.parametrize("seed,num_classes,iou_type,tensors,max_dets,supply_boxes", [
    (0, 1, "segm", False, 100, False),
    (1, 1, "segm", True, 100, False),
    (2, 3, "segm", False, 100, False),
    (3, 3, "segm", True, 5, False),
    (4, 1, "bbox", False, 100, False),
    (5, 3, "bbox", True, 100, False),
    (6, 3, "bbox", False, 100, True),
    (7, 5, "segm", True, 2, False),
])
def test_summarize_equals_jax(seed, num_classes, iou_type, tensors, max_dets, supply_boxes):
    want, got = _summaries(_scenario(seed, num_classes), num_classes, iou_type, tensors, max_dets, supply_boxes)
    assert got == want
    assert {"AP", "AP50", "AP75", "AP_small", "AP_medium", "AP_large", "per_class_AP"} <= set(got)


def test_summarize_with_no_ground_truth_equals_jax():
    images = [_image(np.random.default_rng(8), 2, "gt") for _ in range(3)]
    want, got = _summaries(images, 2, "segm", True)
    assert got == want == {"AP": 0.0, "AP50": 0.0, "AP75": 0.0}


@pytest.mark.parametrize("seed", [0, 1])
def test_ious_and_boxes_equal_jax(seed):
    rng = np.random.default_rng(seed)
    a = (rng.random((5, 20, 17)) > 0.6).astype(np.float32)
    b = (rng.random((4, 20, 17)) > 0.5).astype(np.float32)
    a[1] = 0.0
    np.testing.assert_array_equal(tce.mask_iou(a, b), jce.mask_iou(a, b))
    bx_a, bx_b = tce.boxes_from_masks(a), tce.boxes_from_masks(b)
    np.testing.assert_array_equal(bx_a, jce.boxes_from_masks(a))
    np.testing.assert_array_equal(tce.box_iou(bx_a, bx_b), jce.box_iou(bx_a, bx_b))


@pytest.mark.parametrize("tensors", [False, True])
def test_predictions_to_coco_json_equals_jax(tensors):
    rng = np.random.default_rng(9)
    results, ids = [], []
    for i in range(4):
        pm, pc, ps, _, _ = _image(rng, 3, None if i != 2 else "pred")
        ids.append(100 + i)
        results.append({"pred_masks": pm > 0.5, "pred_classes": pc, "scores": ps})
    port_results = [{k: _as_port_input(v, tensors) for k, v in r.items()} for r in results]
    got = tce.predictions_to_coco_json(ids, port_results, category_offset=2)
    want = jce.predictions_to_coco_json(ids, results, category_offset=2)
    assert json.dumps(got) == json.dumps(want) and len(got) > 0


def _hand_cases():
    """The cases of tests/test_eval_extras.py: (num_classes, iou_type,
    [(pred masks, classes, scores, gt masks, classes)])."""
    gt2 = np.zeros((2, 8, 8)); gt2[0, :4] = 1; gt2[1, 4:] = 1
    gt1 = np.zeros((1, 8, 8)); gt1[0, :4] = 1
    half = np.zeros((1, 8, 8)); half[0, :2] = 1
    junk = np.stack([gt1[0], np.eye(8)])
    big = np.zeros((2, 128, 128)); big[0, :8, :8] = 1; big[1, 10:110, 10:110] = 1
    three = np.zeros((3, 32, 32)); three[0, :8, :8] = 1; three[1, 12:20, 12:20] = 1; three[2, 24:32, 24:32] = 1
    junk1 = np.zeros((1, 32, 32)); junk1[0, :2, 30:] = 1
    ell = np.zeros((1, 16, 16)); ell[0, :, :4] = 1; ell[0, 12:, :] = 1
    box = np.ones((1, 16, 16))
    return [
        (2, "segm", [(gt2.copy(), np.array([0, 1]), np.array([0.9, 0.8]), gt2, np.array([0, 1]))]),
        (1, "segm", [(half, np.array([0]), np.array([0.9]), gt1, np.array([0]))]),
        (1, "segm", [(junk, np.array([0, 0]), np.array([0.5, 0.9]), gt1, np.array([0]))]),
        (1, "segm", [(np.zeros((0, 8, 8)), np.zeros(0, np.int32), np.zeros(0), gt1, np.array([0]))]),
        (3, "segm", [(gt1.copy(), np.array([0]), np.array([0.9]), gt1, np.array([0]))]),
        (1, "bbox", [(gt2.copy(), np.array([0, 0]), np.array([0.9, 0.8]), gt2, np.array([0, 0]))]),
        (1, "bbox", [(box, np.array([0]), np.array([0.9]), ell, np.array([0]))]),
        (1, "segm", [(box, np.array([0]), np.array([0.9]), ell, np.array([0]))]),
        (1, "segm", [(big[:1], np.array([0]), np.array([0.9]), big, np.array([0, 0]))]),
        (1, "segm", [(np.concatenate([junk1, three]), np.zeros(4, np.int64), np.array([0.99, 0.9, 0.8, 0.7]),
                      three, np.zeros(3, np.int64))]),
        (1, "segm", [(big.copy(), np.array([0, 0]), np.array([0.5, 0.9]), big, np.array([0, 0]))]),
    ]


@pytest.mark.parametrize("case", range(11))
def test_hand_cases_equal_jax(case):
    num_classes, iou_type, images = _hand_cases()[case]
    want, got = _summaries(images, num_classes, iou_type, tensors=case % 2 == 1)
    assert got == want
