"""Block-sparse zorro attention over the fused [B, N, 3I] qkv projection:
kernel K1 / K1b (csrc/zorro_attention.cu) in its tile-skip mode, the
counterpart of the JAX package's ops/pallas_zorro_sparse.py.

The packed layout groups tokens by type, so whole 128 x 128 tiles of the
[N, N] scores can never be unmasked. ``tile_active`` marks the pairs of
128-token tiles that can be (the predicate of pallas_zorro_sparse.py:42-65:
the type ranges overlap, or the query tile holds a fusion token and the key
tile any valid key; the diagonal always), and the kernel skips the others: a
skipped tile adds nothing to the row max, the row sum or any product.

For a valid query the skipped keys are all masked anyway, so its row equals
the dense zorro attention's. A PAD query row (type PAD_TYPE) attends only the
PAD keys of its active tiles, as in the TPU kernel; the plain version is
therefore the masked softmax under ``allowed & active``, which matches the
TPU kernel on every row, PAD rows included.

Both directions are operators of ops/library.py: on a CPU tensor the plain
version, on a CUDA tensor the kernel (its bf16 or f32 instance, N a
multiple of 128), or an error.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import cuda_attn, library

PAD_TYPE = cuda_attn.PAD_TYPE
TILE = 128

# launches of the kernel in its tile-skip mode; only the wrappers' launches add
LAUNCHES = {"forward": 0, "backward": 0, "f32_forward": 0, "f32_backward": 0}


def tile_active(types: torch.Tensor, fusion_type: int, nt: int) -> torch.Tensor:
    """[B, N] padded types -> [B, 1, nt * nt] int32 activity of the pairs of
    128-token tiles (query tile i, key tile j) at entry i * nt + j."""
    b = types.shape[0]
    tt = types.to(torch.int32).reshape(b, nt, TILE)
    pad = tt == PAD_TYPE
    tmin = torch.where(pad, torch.full_like(tt, 1 << 20), tt).amin(dim=-1)  # [B, nt]
    tmax = torch.where(pad, torch.full_like(tt, -1), tt).amax(dim=-1)
    qfus = (tt == fusion_type).any(dim=-1)
    kvalid = (~pad).any(dim=-1)
    overlap = (tmin[:, :, None] <= tmax[:, None, :]) & (tmin[:, None, :] <= tmax[:, :, None])
    active = overlap | (qfus[:, :, None] & kvalid[:, None, :])
    active = active | torch.eye(nt, dtype=torch.bool, device=types.device)[None]
    return active.to(torch.int32).reshape(b, 1, nt * nt)


def zorro_sparse_supported(n: int) -> bool:
    """The JAX package's gate (pallas_zorro_sparse.py:272): 128-tiled rows,
    2 to 6 tiles."""
    return n % TILE == 0 and 2 <= n // TILE <= 6


def sparse_allowed(types: torch.Tensor, fusion_type: int) -> torch.Tensor:
    """[B, N, N]: the zorro mask and the tile activity, token by token."""
    b, n = types.shape
    nt = n // TILE
    act = tile_active(types, fusion_type, nt).reshape(b, nt, nt).bool()
    act = act.repeat_interleave(TILE, dim=1).repeat_interleave(TILE, dim=2)
    return cuda_attn.zorro_allowed(types, fusion_type) & act


def _split(qkv):
    return qkv.split(qkv.shape[-1] // 3, dim=-1)


def _scale(qkv, heads, scale):
    return cuda_attn.default_scale(qkv.shape[-1] // 3, heads, scale)


def zorro_sparse_attention_qkv_reference(qkv, types, heads: int, fusion_type: int,
                                         scale: Optional[float] = None, return_lse: bool = False):
    """Plain version: the masked softmax under ``allowed & active``.
    qkv [B, N, 3I] -> [B, N, I] (and lse [B, H, N])."""
    q, k, v = _split(qkv)
    return cuda_attn.masked_attention_reference(q, k, v, heads, sparse_allowed(types, fusion_type),
                                                _scale(qkv, heads, scale), return_lse)


def zorro_sparse_attention_qkv_backward_reference(qkv, types, o, lse, do, heads: int, fusion_type: int,
                                                  scale: Optional[float] = None) -> torch.Tensor:
    """Plain backward under the same mask, with the cast points of the TPU
    body (pallas_zorro_sparse.py:154-180, those of the dense kernel): dqkv
    [B, N, 3I]."""
    q, k, v = _split(qkv)
    grads = cuda_attn.masked_attention_backward_reference(q, k, v, sparse_allowed(types, fusion_type), o, lse,
                                                          do, heads, _scale(qkv, heads, scale))
    return torch.cat(grads, dim=-1)


def _key(direction: str, dtype: torch.dtype) -> str:
    """The launch counter of the instance for ``dtype``."""
    return ("f32_" if dtype == torch.float32 else "") + direction


def _check(name, qkv, heads, types, fusion_type):
    if types is None:
        raise ValueError(f"{name}: the block-sparse form is zorro-masked and needs types")
    types = cuda_attn.check_qkv(name, qkv, heads, types, fusion_type)
    n = qkv.shape[1]
    if n % TILE:
        raise ValueError(f"{name}: N = {n} is not a multiple of {TILE}")
    active = tile_active(types, int(fusion_type), n // TILE).contiguous()
    return types, active


def _cpu(qkv, types, heads, fusion_type, scale, return_lse):
    out, lse = zorro_sparse_attention_qkv_reference(qkv, types, heads, fusion_type, scale, return_lse=True)
    return out, (lse if return_lse else cuda_attn._no_lse(qkv))


def _cuda(qkv, types, heads, fusion_type, scale, return_lse):
    types, active = _check("zorro_sparse_attention_qkv", qkv, heads, types, fusion_type)
    b, n, three_i = qkv.shape
    out, lse = cuda_attn.launch_attention(cuda_attn.slab_view(qkv), b, n, three_i // 3, heads, qkv.device,
                                          types, fusion_type, scale, return_lse, active, dtype=qkv.dtype)
    LAUNCHES[_key("forward", qkv.dtype)] += 1
    return out, (lse if return_lse else cuda_attn._no_lse(qkv))


def _backward_cpu(qkv, types, o, lse, do, heads, fusion_type, scale):
    return zorro_sparse_attention_qkv_backward_reference(qkv, types, o, lse, do, heads, fusion_type, scale)


def _backward_cuda(qkv, types, o, lse, do, heads, fusion_type, scale):
    cuda_attn._need_lse("zorro_sparse_attention_qkv_backward", lse)
    types, active = _check("zorro_sparse_attention_qkv_backward", qkv, heads, types, fusion_type)
    b, n, three_i = qkv.shape
    dqkv = torch.empty_like(qkv)
    cuda_attn.launch_attention_backward(cuda_attn.slab_view(qkv), cuda_attn.slab_view(dqkv), b, n,
                                        three_i // 3, heads, qkv.device, types, fusion_type, o, lse, do, scale,
                                        active, dtype=qkv.dtype)
    LAUNCHES[_key("backward", qkv.dtype)] += 1
    return dqkv


def _setup(ctx, inputs, output):
    qkv, types, heads, fusion_type, scale, _ = inputs
    ctx.save_for_backward(qkv, types, *output)
    ctx.args = (heads, fusion_type, scale)
    ctx.set_materialize_grads(False)


def _grad(ctx, dout, _dlse):
    if dout is None:
        return (None,) * 6
    qkv, types, out, lse = ctx.saved_tensors
    cuda_attn._need_lse("zorro_sparse_attention_qkv", lse)
    return (zorro_sparse_attention_qkv_backward(qkv, types, out, lse, dout.contiguous(), *ctx.args),) + (None,) * 5


_BACKWARD = library.define(
    "zorro_sparse_attention_qkv_backward",
    "(Tensor qkv, Tensor types, Tensor o, Tensor lse, Tensor do, int heads, int fusion_type, float scale)"
    " -> Tensor", _backward_cpu, _backward_cuda, cuda_attn._qkv_backward_fake)
_FORWARD = library.define(
    "zorro_sparse_attention_qkv",
    "(Tensor qkv, Tensor types, int heads, int fusion_type, float scale, bool return_lse) -> (Tensor, Tensor)",
    _cpu, _cuda, cuda_attn._qkv_fake, _grad, _setup)


def zorro_sparse_attention_qkv(qkv: torch.Tensor, types: torch.Tensor, heads: int, fusion_type: int,
                               scale: Optional[float] = None, return_lse: bool = False):
    """Block-sparse zorro attention. qkv [B, N, 3I] with N % 128 == 0;
    types [B, N] int (PAD_TYPE = padding). Returns [B, N, I], and with
    ``return_lse`` the f32 lse [B, H, N]. Differentiable."""
    out, lse = _FORWARD(qkv, types, heads, fusion_type, _scale(qkv, heads, scale),
                        cuda_attn.keeps_lse(qkv, return_lse))
    return (out, lse) if return_lse else out


def zorro_sparse_attention_qkv_backward(qkv, types, o, lse, do, heads: int, fusion_type: int,
                                        scale: Optional[float] = None) -> torch.Tensor:
    """dqkv [B, N, 3I] of ``zorro_sparse_attention_qkv``."""
    return _BACKWARD(qkv, types, o, lse, do, heads, fusion_type, _scale(qkv, heads, scale))


class ZorroSparseAttentionQKV:
    """``zorro_sparse_attention_qkv`` with its gradient:
    ``ZorroSparseAttentionQKV.apply(qkv, types, heads, fusion_type, scale)``."""

    @staticmethod
    def apply(qkv, types, heads, fusion_type, scale=None):
        return zorro_sparse_attention_qkv(qkv, types, heads, fusion_type, scale)
