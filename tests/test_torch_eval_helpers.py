"""The port's small host-side helpers against the JAX package's, and what
``patchify_batch`` feeds:

  * ``eval.metrics.psnr_metrics`` (rel 1e-6, f32 sums in another order),
    ``ops.masking.make_mask`` (all three options, exact) and
    ``data.patchify_batch`` (exact, integer maps and patch-major entries
    passed through);
  * ``PatchedInputAdapter``'s patch-major path against JAX's 3-D path (the
    weights by ``params_from_jax``; atol 2e-5) and against the port's own
    4-D path (bitwise, f32), its patch-width check as JAX's; a patch-space
    loss on a patchified target against JAX's (rel 1e-6) and against the
    port's 4-D target (bitwise); the pretraining step on a patchified batch
    gives the image batch's loss (rel 1e-6);
  * ``infer.reconstruction_grid``'s panels against what JAX's
    ``plot_reconstructions`` hands to ``Axes.imshow`` on the same
    ``InferenceResult`` (recorded, with and without ``denorm``; exact bytes
    through matplotlib's own ``to_rgba``: x 255 truncated for RGB, channel 0
    min-max scaled onto viridis), and the PNG it writes decoded back with
    ``zlib``.
"""
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu import data as jdata
from incomplete_multimodal_fusion_tpu import infer as jinfer
from incomplete_multimodal_fusion_tpu.eval import metrics as jmetrics
from incomplete_multimodal_fusion_tpu.losses import masked as jmasked
from incomplete_multimodal_fusion_tpu.models import adapters as jadapters
from incomplete_multimodal_fusion_tpu.ops import masking as jmasking
from incomplete_multimodal_fusion_tpu_torch import data as tdata
from incomplete_multimodal_fusion_tpu_torch import infer as tinfer
from incomplete_multimodal_fusion_tpu_torch.eval import metrics as tmetrics
from incomplete_multimodal_fusion_tpu_torch.losses import masked as tmasked
from incomplete_multimodal_fusion_tpu_torch.models import adapters as tadapters
from incomplete_multimodal_fusion_tpu_torch.ops import masking as tmasking
from tests.test_torch_common import port_module, random_params, to_np

DIM = 64


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("data_range", [None, 4.0])
def test_psnr_metrics_equals_jax(data_range):
    pred, target = _x((2, 32, 32, 3), 0), _x((2, 32, 32, 3), 1)
    want = jmetrics.psnr_metrics(jnp.asarray(pred), jnp.asarray(target), data_range)
    got = tmetrics.psnr_metrics(torch.from_numpy(pred), target, data_range)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("full_tasks,indicate_visible", [((), True), (("s1",), True), ((), False),
                                                         (("s2",), False)])
def test_make_mask_equals_jax(full_tasks, indicate_visible):
    coords = {"s1": [(0, 0), (1, 1), (2, 3)], "s2": [(2, 0)], "dem": []}
    want = jmasking.make_mask(4, 3, coords, full_tasks=full_tasks, indicate_visible=indicate_visible)
    got = tmasking.make_mask(4, 3, coords, full_tasks=full_tasks, indicate_visible=indicate_visible)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == (1, 12) and got[k].dtype == torch.long
        np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k]))


def test_make_mask_drives_a_mask_info():
    masks = tmasking.make_mask(2, 2, {"s1": [(0, 0)], "s2": [(1, 1), (0, 1)]})
    mi = tmasking.mask_info_from_task_masks(masks, ("s1", "s2"), 8)
    assert int(mi.num_visible[0]) == 3


def test_patchify_batch_equals_jax():
    batch = {"s1": _x((2, 64, 48, 1), 2), "s2": _x((2, 64, 48, 3), 3),
             "dnw": np.random.default_rng(4).integers(0, 9, (2, 64, 48)).astype(np.int32),
             "done": _x((2, 12, 768), 5)}
    want, got = jdata.patchify_batch(batch, 16), tdata.patchify_batch(batch, 16)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    assert got["s2"].shape == (2, 12, 16 * 16 * 3) and got["dnw"] is batch["dnw"] and got["done"] is batch["done"]


@pytest.mark.parametrize("channels", [1, 3])
def test_patch_major_adapter_equals_jax_and_the_4d_path(channels):
    img = _x((2, 64, 64, channels), 6)
    patches = tdata.patchify_batch({"x": img}, 16)["x"]
    jm = jadapters.PatchedInputAdapter(num_channels=channels, patch_size=16, image_size=64)
    params = random_params(jm, 7, jnp.asarray(img), dim_tokens=DIM)
    ref = jm.apply({"params": params}, jnp.asarray(patches), dim_tokens=DIM)
    tm = port_module(tadapters.PatchedInputAdapter(channels, DIM, 16, 64), params)
    with torch.no_grad():
        out3 = tm(torch.from_numpy(patches))
        out4 = tm(torch.from_numpy(img))
    np.testing.assert_allclose(to_np(out3), np.asarray(ref), atol=2e-5)
    assert torch.equal(out3, out4)


def test_patch_major_adapter_checks_the_patch_width():
    bad = np.zeros((1, 16, 16 * 16 * 2), np.float32)  # 2 channels' patches into a 3-channel adapter
    jm = jadapters.PatchedInputAdapter(num_channels=3, patch_size=16, image_size=64)
    params = random_params(jm, 8, jnp.zeros((1, 64, 64, 3)), dim_tokens=DIM)
    with pytest.raises(AssertionError, match="adapter expects patch dim 768, got 512"):
        jm.apply({"params": params}, jnp.asarray(bad), dim_tokens=DIM)
    tm = port_module(tadapters.PatchedInputAdapter(3, DIM, 16, 64), params)
    with pytest.raises(ValueError, match="adapter expects patch dim 768, got 512"):
        tm(torch.from_numpy(bad))
    with pytest.raises(ValueError, match="square grid"):
        tm(torch.zeros(1, 15, 768))


@pytest.mark.parametrize("loss,norm_pix", [("mse", False), ("mse", True), ("l1", False), ("l1", True)])
def test_patch_loss_on_a_patchified_target(loss, norm_pix):
    img = _x((3, 64, 64, 3), 9)
    target = tdata.patchify_batch({"x": img}, 16)["x"]
    pred = _x((3, 16, 16 * 16 * 3), 10)
    mask = (np.random.default_rng(11).random((3, 16)) > 0.5).astype(np.int32)
    mask[1] = 0
    jfn, tfn = jmasked.PATCH_LOSS_FNS[loss], tmasked.PATCH_LOSS_FNS[loss]
    want = jfn(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask), patch_size=16, norm_pix=norm_pix)
    got3 = tfn(torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(mask), patch_size=16,
               norm_pix=norm_pix)
    got4 = tfn(torch.from_numpy(pred), torch.from_numpy(img), torch.from_numpy(mask), patch_size=16,
               norm_pix=norm_pix)
    np.testing.assert_allclose(float(got3), float(want), rtol=1e-6)
    assert torch.equal(got3, got4)


def test_pretrain_step_takes_a_patchified_batch():
    from incomplete_multimodal_fusion_tpu_torch.config import DataConfig, MaskConfig, ModelConfig, PretrainConfig
    from incomplete_multimodal_fusion_tpu_torch.data.synthetic import synthetic_batch
    from incomplete_multimodal_fusion_tpu_torch.train import pretrain

    cfg = PretrainConfig(model=ModelConfig(dim_tokens=32, depth=2, dim_head=8, heads=2, ff_mult=2,
                                           num_fusion_tokens=16),
                         data=DataConfig(input_size=64, batch_size=2), mask=MaskConfig(num_encoded_tokens=24))
    cfg = cfg.__class__(**{**cfg.__dict__, "train": cfg.train.__class__(**{**cfg.train.__dict__,
                                                                           "compute_dtype": "float32"})})
    batch = synthetic_batch(np.random.default_rng(12), cfg.data.in_domains, 2, 64)
    losses = []
    for b in (batch, tdata.patchify_batch(batch, 16)):
        model, state, optimizer = pretrain.create_train_state(cfg, 0, total_steps=10, device="cpu")
        step = pretrain.make_train_step(model, cfg, optimizer)
        losses.append(float(step(state, b)[1]["loss"]))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)


def _result(seed, channels=(("s1", 1), ("s2", 3), ("dem", 1), ("s2_4ch", 4), ("six", 6))):
    """Rasters and an InferenceResult (both frameworks' forms) at 64², patch 16."""
    rng = np.random.default_rng(seed)
    x = {d: rng.standard_normal((2, 64, 64, c)).astype(np.float32) for d, c in channels}
    preds = {d: rng.standard_normal((2, 64, 64, c)).astype(np.float32) for d, c in channels}
    masks = {d: (rng.random((2, 16)) > 0.5).astype(np.int32) for d, _ in channels}
    pooled = np.zeros((2, len(channels) + 1, 8), np.float32)
    jres = jinfer.InferenceResult({d: jnp.asarray(v) for d, v in preds.items()},
                                  {d: jnp.asarray(v) for d, v in masks.items()}, jnp.asarray(pooled))
    tres = tinfer.InferenceResult({d: torch.from_numpy(v) for d, v in preds.items()},
                                  {d: torch.from_numpy(v).long() for d, v in masks.items()}, torch.from_numpy(pooled))
    return x, jres, tres


def _jax_panels(x, jres, tmp_path, denorm=None):
    """The panels JAX's plot_reconstructions draws on the same result, a row
    a modality: each array and cmap it hands to ``Axes.imshow``, recorded,
    turned into bytes by matplotlib's own ``to_rgba`` (imshow's colour
    scale: min-max of the array through the cmap, or x 255 truncated for
    RGB in [0, 1])."""
    import matplotlib
    from matplotlib.axes import Axes
    from matplotlib.cm import ScalarMappable

    matplotlib.use("Agg")
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Axes, "imshow", lambda self, img, cmap=None, **kw: calls.append((np.asarray(img), cmap)))
        jinfer.plot_reconstructions(x, jres, 16, str(tmp_path / "jax_grid.png"), denorm=denorm)
    panels = [ScalarMappable(cmap=cmap).to_rgba(img, bytes=True)[..., :3] for img, cmap in calls]
    assert len(panels) == 3 * len(jres.preds)
    return [panels[i:i + 3] for i in range(0, len(panels), 3)]


@pytest.mark.parametrize("seed", [0, 1])
def test_reconstruction_grid_panels_equal_jax(seed, tmp_path):
    x, jres, tres = _result(seed)
    grid = tinfer.reconstruction_grid({d: torch.from_numpy(v) for d, v in x.items()}, tres, 16)
    assert grid.dtype == np.uint8 and grid.shape == (5 * 64, 3 * 64, 3)
    for i, (d, row) in enumerate(zip(jres.preds, _jax_panels(x, jres, tmp_path))):
        for j, panel in enumerate(row):
            np.testing.assert_array_equal(grid[i * 64:(i + 1) * 64, j * 64:(j + 1) * 64], panel,
                                          err_msg=f"{d} panel {j}")


def test_viridis_table_is_matplotlibs():
    import matplotlib
    np.testing.assert_array_equal(tinfer.VIRIDIS, matplotlib.colormaps["viridis"](np.arange(256), bytes=True)[:, :3])


def _decode_png(path):
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(kind + body)
        chunks.append((kind, body))
        pos += 12 + n
    assert [k for k, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    w, h, depth, colour, _, _, _ = struct.unpack(">IIBBBBB", chunks[0][1])
    assert (depth, colour) == (8, 2)
    raw = np.frombuffer(zlib.decompress(chunks[1][1]), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()  # filter type 0 on every row
    return raw[:, 1:].reshape(h, w, 3)


def test_plot_reconstructions_writes_the_grid_as_png(tmp_path):
    x, _, tres = _result(2)
    path = str(tmp_path / "grid.png")
    assert tinfer.plot_reconstructions(x, tres, 16, path) == path
    np.testing.assert_array_equal(_decode_png(path), tinfer.reconstruction_grid(x, tres, 16))
    with pytest.raises(ValueError, match="PNG only"):
        tinfer.plot_reconstructions(x, tres, 16, str(tmp_path / "grid.jpg"))


def test_reconstruction_grid_denormalises_as_jax(tmp_path):
    x, jres, tres = _result(3, channels=(("s2", 3), ("dem", 1), ("s1", 1)))
    denorm = {"s2": (0.5, 2.0), "dem": (-3.0, 7.5)}
    grid = tinfer.reconstruction_grid(x, tres, 16, denorm=denorm)
    want = np.concatenate([np.concatenate(row, axis=1) for row in _jax_panels(x, jres, tmp_path, denorm)], axis=0)
    np.testing.assert_array_equal(grid, want)
