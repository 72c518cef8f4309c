from typing import Dict

from . import (attention, cuda_attn, cuda_block_attn, cuda_ffn, cuda_fusion_attn, cuda_msda, cuda_points,
               cuda_zorro_sparse, masking, msda, patches, points, posemb, resize)

__all__ = ["attention", "cuda_attn", "cuda_block_attn", "cuda_ffn", "cuda_fusion_attn", "cuda_msda",
           "cuda_points", "cuda_zorro_sparse", "masking", "msda", "patches", "points", "posemb", "resize",
           "kernel_launches", "reset_kernel_launches"]

_COUNTERS = {"zorro_attention_qkv": cuda_attn.LAUNCHES, "fused_ffn": cuda_ffn.LAUNCHES,
             "fusion_row_attention": cuda_fusion_attn.LAUNCHES,
             "ms_deform_attn": cuda_msda.LAUNCHES, "point_sample": cuda_points.LAUNCHES,
             "zorro_attention_packed": cuda_attn.PACKED_LAUNCHES, "zorro_sparse": cuda_zorro_sparse.LAUNCHES,
             "fused_block_attn": cuda_block_attn.LAUNCHES}


def kernel_launches() -> Dict[str, int]:
    """Launches of every hand-written kernel so far, as {"kernel/mode": n}."""
    return {f"{k}/{mode}": n for k, counts in _COUNTERS.items() for mode, n in counts.items()}


def reset_kernel_launches() -> None:
    for counts in _COUNTERS.values():
        for mode in counts:
            counts[mode] = 0
