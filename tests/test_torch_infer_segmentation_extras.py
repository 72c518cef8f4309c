"""Segmentation inference extras of the port against the JAX package's
infer_segmentation.py: ``panoptic_inference`` (the segment map bitwise and
the segments equal, with and without ``thing_ids``, in the settings of
tests/test_downstream_train.py:195-226), ``semantic_inference_with_tta``
(within 1e-5, relative and absolute, on one MaskFormer weight set, tests/test_extras2.py:84-95's
setting), ``colorize_labels`` and ``overlay_instances`` with and without
labels (bitwise), ``save_segmentation_png`` (its file decodes to the
colorized map), and ``data.ade_metadata`` (JAX's tables)."""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu import infer_segmentation as jseg
from incomplete_multimodal_fusion_tpu.data import ade_metadata as jade
from incomplete_multimodal_fusion_tpu.models.maskformer import MaskFormerModel as JaxMaskFormer
from incomplete_multimodal_fusion_tpu_torch import infer_segmentation as tseg
from incomplete_multimodal_fusion_tpu_torch.data import ade_metadata as tade
from incomplete_multimodal_fusion_tpu_torch.models import maskformer as tmf
from tests.test_torch_common import port_module, to_np


def _panoptic_cases():
    rng = np.random.default_rng(1)
    yield "random", rng.standard_normal((6, 4)) * 5, rng.standard_normal((6, 16, 16)) * 5, \
        dict(object_mask_threshold=0.1, overlap_threshold=0.1)
    cls = np.asarray([[9.0, 0.0, -9.0]] * 2 + [[0.0, 9.0, -9.0]])  # q0, q1 class 0; q2 class 1
    masks = np.full((3, 4, 8), -9.0)
    masks[0, :, :3] = 9.0
    masks[1, :, 3:6] = 9.0
    masks[2, :, 6:] = 9.0
    yield "stuff_merging", cls, masks, dict(object_mask_threshold=0.5, overlap_threshold=0.5)
    rng = np.random.default_rng(2)
    yield "many", rng.standard_normal((20, 11)) * 4, rng.standard_normal((20, 32, 24)) * 4, {}


@pytest.mark.parametrize("thing_ids", [None, [1], [0, 2, 5]])
@pytest.mark.parametrize("case", [c[0] for c in _panoptic_cases()])
def test_panoptic_matches_jax(case, thing_ids):
    _, cls, masks, kw = next(c for c in _panoptic_cases() if c[0] == case)
    cls, masks = cls.astype(np.float32), masks.astype(np.float32)
    pan_j, segs_j = jseg.panoptic_inference(jnp.asarray(cls), jnp.asarray(masks), thing_ids=thing_ids, **kw)
    pan_t, segs_t = tseg.panoptic_inference(torch.from_numpy(cls), torch.from_numpy(masks), thing_ids=thing_ids,
                                            **kw)
    assert pan_t.dtype == torch.int32
    np.testing.assert_array_equal(to_np(pan_t), np.asarray(pan_j))
    assert segs_t == segs_j
    if case == "stuff_merging":
        assert len(segs_t) == (3 if thing_ids is None or 0 in thing_ids else 2)


def test_panoptic_keeps_nothing_below_the_threshold():
    cls = torch.tensor([[0.0, 0.0, 9.0]])  # void wins
    pan, segs = tseg.panoptic_inference(cls, torch.full((1, 4, 4), 9.0))
    assert segs == [] and int(pan.abs().sum()) == 0


class _Jitted:
    """The flax model with its ``apply`` under ``jax.jit`` (one compile
    rather than one per eager op), as JAX's TTA calls it."""

    def __init__(self, model):
        self.cfg = model.cfg
        self._apply = jax.jit(model.apply)

    def apply(self, variables, x):
        return self._apply(variables, x)


def test_tta_matches_jax():
    from tests.test_downstream_model import CFG, batch

    x = batch(0)
    jm = JaxMaskFormer(CFG)
    params = jm.init(jax.random.PRNGKey(0), x)["params"]
    ref = jseg.semantic_inference_with_tta(_Jitted(jm), params, x)
    tm = port_module(tmf.MaskFormerModel(tmf.MaskFormerConfig(**dataclasses.asdict(CFG))), params)
    got = tseg.semantic_inference_with_tta(tm, None, {d: np.asarray(v) for d, v in x.items()})
    assert got.shape == (2, CFG.num_classes, 64, 64)
    # 1e-5 relative as well: the maps are sums over the queries and reach 2.4
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # the mean of the plain and the flipped views, computed by hand
    xt = {d: torch.from_numpy(np.asarray(v)) for d, v in x.items()}
    plain = tseg.semantic_probabilities(tseg.segmentation_outputs(tm, None, xt), (64, 64))
    flipped = tseg.semantic_probabilities(
        tseg.segmentation_outputs(tm, None, {d: torch.flip(v, dims=[2]) for d, v in xt.items()}), (64, 64))
    np.testing.assert_allclose(to_np(got), to_np((plain + torch.flip(flipped, dims=[-1])) / 2), atol=1e-6)


def _instances(seed, n=4, h=24, w=32):
    rng = np.random.default_rng(seed)
    masks = np.zeros((n, h, w), np.float32)
    for i in range(n):
        y0, x0 = rng.integers(0, h - 6), rng.integers(0, w - 6)
        masks[i, y0:y0 + rng.integers(3, 10), x0:x0 + rng.integers(3, 12)] = 1.0
    masks[-1] = 0.0  # an empty mask draws nothing
    masks[0, :, :2] = 1.0  # an edge-to-edge strip keeps its border outline
    return {"scores": np.asarray([0.9, 0.7, 0.3, 0.95], np.float32)[:n], "pred_masks": masks,
            "pred_classes": np.asarray([3, 12, 1, 0])[:n]}


@pytest.mark.parametrize("draw_labels", [True, False])
@pytest.mark.parametrize("names", [None, "ade"])
def test_overlay_matches_jax_bitwise(draw_labels, names):
    image = np.random.default_rng(9).standard_normal((24, 32, 3)).astype(np.float32) * 3.0 + 1.0
    inst = _instances(10)
    kw = dict(draw_labels=draw_labels, class_names=None if names is None else jade.class_names())
    ref = jseg.overlay_instances(image, inst, **kw)
    got = tseg.overlay_instances(torch.from_numpy(image), {k: torch.from_numpy(v) for k, v in inst.items()}, **kw)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def test_overlay_labels_change_pixels_where_pil_draws():
    pytest.importorskip("PIL")
    image = np.zeros((64, 96, 3), np.float32)
    image[0, 0] = 1.0
    inst = _instances(11, h=64, w=96)
    with_labels = tseg.overlay_instances(image, inst, draw_labels=True)
    without = tseg.overlay_instances(image, inst, draw_labels=False)
    assert (with_labels != without).any()


@pytest.mark.parametrize("palette", [None, "ade"])
def test_colorize_matches_jax(palette):
    colors = None if palette is None else tade.palette()
    lm = np.random.default_rng(12).integers(-2, 160, (9, 13))
    np.testing.assert_array_equal(tseg.colorize_labels(torch.from_numpy(lm), colors),
                                  jseg.colorize_labels(lm, None if palette is None else jade.palette()))


def _read_png(path):
    """An 8-bit RGB PNG of one IDAT, unfiltered rows (the port's writer)."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")
    i = data.index(b"IDAT")
    n = int.from_bytes(data[i - 4:i], "big")
    raw = zlib.decompress(data[i + 4:i + 4 + n])
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_save_segmentation_png_decodes_to_the_colorized_map(tmp_path):
    lm = torch.from_numpy(np.random.default_rng(13).integers(0, 12, (20, 28)))
    path = tseg.save_segmentation_png(lm, str(tmp_path / "t_seg.png"))
    np.testing.assert_array_equal(_read_png(path), tseg.colorize_labels(lm))


def test_ade_metadata_equals_jax():
    assert tade.class_names() == jade.class_names()
    np.testing.assert_array_equal(tade.palette(), jade.palette())
    assert tade.thing_ids() == jade.thing_ids() and tade.stuff_ids() == jade.stuff_ids()
    assert tade.metadata() == jade.metadata()
    assert len(tade.thing_ids()) == 100 and tade.metadata()["num_classes"] == 150
