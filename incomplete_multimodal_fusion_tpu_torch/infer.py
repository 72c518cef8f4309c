"""MAE inference (JAX package infer.py; reference pretraining/infer_mmae.py).

  * one forward with seeded random masks and ``num_encoded_tokens``
    (infer_mmae.py:330-338), the masks drawn from a ``torch.Generator``;
  * caller-supplied ``task_masks`` to force modalities absent
    (infer_mmae.py:344-361: "fill 1 = drop a modality"), with
    ``drop_modalities`` as the shorthand;
  * PSNR, the reconstruction-parity metric;
  * the masked-input / prediction / ground-truth grid per modality
    (infer_mmae.py:233-287), built as a uint8 array and written as PNG with
    the standard library (``zlib``, ``struct``): JAX draws it with
    matplotlib, which the card's machine lacks, and PNG is the only format.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from .eval.metrics import to_numpy
from .ops import masking


class InferenceResult(NamedTuple):
    preds: Dict[str, torch.Tensor]  # {task: [B, H, W, C]}
    task_masks: Dict[str, torch.Tensor]  # {task: [B, N]} 1 = masked
    pooled: torch.Tensor  # [B, T+1, D]


def resolve_module(model: nn.Module, params: Union[None, nn.Module, Mapping]) -> nn.Module:
    """The module to run: ``params`` itself when it is a module, else
    ``model`` with the state dict ``params`` loaded (when given)."""
    if isinstance(params, nn.Module):
        return params
    if params is not None:
        model.load_state_dict(params)
    return model


def as_input(v, device) -> torch.Tensor:
    """A request array (numpy or tensor) as a tensor on ``device``."""
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(v)
    return v.to(device)


def infer(
    model: nn.Module,
    params,
    x: Mapping[str, Union[np.ndarray, torch.Tensor]],
    num_encoded_tokens: int,
    generator: Optional[torch.Generator] = None,
    task_masks: Optional[Mapping[str, torch.Tensor]] = None,
    drop_modalities: Sequence[str] = (),
    alphas: float = 1.0,
    sample_tasks_uniformly: bool = False,
) -> InferenceResult:
    """Forward with random masking (default) or explicit/ablation masks.
    ``params``: None (the model's own weights), a module, or a state dict."""
    module = resolve_module(model, params)
    device = next(module.parameters()).device
    domains = tuple(module.in_domains)
    x = {d: as_input(x[d], device) for d in domains}
    b = x[domains[0]].shape[0]
    n = module.num_patches
    unknown = set(drop_modalities) - set(domains)
    if unknown:
        raise ValueError(f"drop_modalities {sorted(unknown)} not in model domains {domains}")
    if task_masks is None and drop_modalities:
        task_masks = {
            d: torch.full((b, n), 1 if d in drop_modalities else 0, dtype=torch.long, device=device)
            for d in domains
        }
    if task_masks is not None:
        # pack at full capacity: with caller-supplied masks the visible count
        # can exceed num_encoded_tokens; the reference encodes all of them
        # (multimae_crossattn.py:399), padding slots take the rest
        num_encoded_tokens = n * len(domains)
        task_masks = {d: as_input(task_masks[d], device) for d in domains}
        mi = masking.mask_info_from_task_masks(task_masks, domains, num_encoded_tokens)
    else:
        if generator is None:
            generator = torch.Generator().manual_seed(1)  # infer_mmae.py:330 seed(1)
        mi = masking.generate_random_masks(
            generator, domains, (n,) * len(domains), num_encoded_tokens, b,
            alphas=alphas, sample_tasks_uniformly=sample_tasks_uniformly, device=device,
        )
    with torch.inference_mode():
        out = module(x, mi, num_encoded_tokens)
    return InferenceResult(out["preds"], out["task_masks"], out["pooled"])


def masked_input(x: torch.Tensor, mask: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Zero out masked patches for visualization (infer_mmae plot grids)."""
    b, h, w, c = x.shape
    m = mask.reshape(b, h // patch_size, w // patch_size).to(x.dtype)
    m = m.repeat_interleave(patch_size, dim=1).repeat_interleave(patch_size, dim=2)
    return x * (1 - m)[..., None]


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: Optional[float] = None) -> torch.Tensor:
    """Peak signal-to-noise ratio."""
    pred = pred.float()
    target = target.float()
    if data_range is None:
        data_range = float(target.max() - target.min())
    mse = ((pred - target) ** 2).mean()
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp(min=1e-12))


def masked_psnr(pred, target, mask, patch_size: int, data_range: Optional[float] = None):
    """PSNR over masked (reconstructed) patches only."""
    b, h, w, c = pred.shape
    m = mask.reshape(b, h // patch_size, w // patch_size).float()
    m = m.repeat_interleave(patch_size, dim=1).repeat_interleave(patch_size, dim=2)[..., None]
    pred = pred.float()
    target = target.float()
    if data_range is None:
        data_range = float(target.max() - target.min())
    mse = (((pred - target) ** 2) * m).sum() / (m.sum() * c).clamp(min=1.0)
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp(min=1e-12))


# matplotlib's 'viridis' colour table as imshow renders it, 256 RGB entries
# (generated once: matplotlib.colormaps['viridis'](range(256), bytes=True))
VIRIDIS = np.frombuffer(bytes.fromhex(
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163471265471466471567471669"
    "47186a48196b481a6c481c6e481d6f481e70482071482172482273482374472575472676472777472878472a79472b7a"
    "472c7b462d7c462f7c46307d46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
    "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c893c4d8a3c4e8a3b508a3b518a"
    "3a528b3a538b39548b39558b38568b38578c37588c37598c365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d"
    "32628d32638d31648d31658d31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e277d8e277e8e267f8e26808e"
    "26818e25828e25838d24848d24858d24868d23878d23888d23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c"
    "20908c20918c1f928c1f938b1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
    "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a98224aa8225ab8126ac8127ad80"
    "28ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a32b57a33b67935b77836b87738b97639b9763bba753dbb74"
    "3ebc7340bd7242be7144be7045bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d05279d1517cd24f7ed24e81d34c"
    "83d34b86d44988d5478bd5468dd64490d64392d74195d73f97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32"
    "addc30afdc2eb2dd2cb5dd2bb7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
    "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51ef6e61ff8e621fae622fde724"
), np.uint8).reshape(256, 3)


def panel_rgb(img: np.ndarray) -> np.ndarray:
    """One [H, W, C] panel as uint8 RGB, as plot_reconstructions draws it
    (JAX infer.py:148-157) and imshow turns it into bytes (x 255,
    truncated): 3 channels min-max normalised over the panel, 4 channels the
    first three so, any other count channel 0 through ``VIRIDIS`` on
    imshow's min-max colour scale."""
    img = np.asarray(img, np.float32)
    if img.shape[-1] in (3, 4):
        rgb = img[..., :3]
        lo, hi = rgb.min(), rgb.max()
        return (np.clip((rgb - lo) / max(hi - lo, 1e-6), 0.0, 1.0) * 255).astype(np.uint8)
    # matplotlib's Normalize: the f32 difference over the range taken in f64
    v = img[..., 0]
    lo, hi = float(v.min()), float(v.max())
    t = ((v - np.float32(lo)) / np.float64(hi - lo)).astype(np.float32) if hi > lo else np.zeros_like(v)
    return VIRIDIS[np.clip((t * 256).astype(np.int64), 0, 255)]


def reconstruction_grid(x: Mapping[str, Union[np.ndarray, torch.Tensor]], result: InferenceResult,
                        patch_size: int,
                        denorm: Optional[Dict[str, Tuple[float, float]]] = None) -> np.ndarray:
    """The grid of plot_reconstructions as a [rows * H, 3 * W, 3] uint8
    array: a row a modality of ``result.preds``, its masked input (the first
    image, masked patches zeroed), prediction and ground truth."""
    rows = []
    for d in result.preds:
        gt = to_numpy(x[d][:1]).astype(np.float32)
        mask = torch.as_tensor(to_numpy(result.task_masks[d][:1]))
        masked = masked_input(torch.from_numpy(gt), mask, patch_size).numpy()[0]
        panels = [masked, to_numpy(result.preds[d][0]), gt[0]]
        if denorm and d in denorm:
            mu, sigma = denorm[d]
            panels = [p * sigma + mu for p in panels]
        rows.append(np.concatenate([panel_rgb(p) for p in panels], axis=1))
    return np.concatenate(rows, axis=0)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def write_png(path: str, rgb: np.ndarray) -> None:
    """An [H, W, 3] uint8 array as an 8-bit RGB PNG (no filter, one IDAT)."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + np.ascontiguousarray(row).tobytes() for row in rgb)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + _png_chunk(b"IDAT", zlib.compress(raw, 6)) + _png_chunk(b"IEND", b""))


def plot_reconstructions(x: Mapping[str, Union[np.ndarray, torch.Tensor]], result: InferenceResult,
                         patch_size: int, out_path: str = "output.png",
                         denorm: Optional[Dict[str, Tuple[float, float]]] = None) -> str:
    """Masked-input / prediction / ground-truth grid per modality written to
    ``out_path`` as PNG (JAX infer.py:104-163); returns the path. Raises
    ValueError for any other extension."""
    if not out_path.lower().endswith(".png"):
        raise ValueError(f"plot_reconstructions writes PNG only, got {out_path!r}")
    write_png(out_path, reconstruction_grid(x, result, patch_size, denorm))
    return out_path
