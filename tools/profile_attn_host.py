"""Host time of kernel K1's and K1b's wrappers, split by item, on one GPU.

At the pretraining shape (B = 60, N = 640, 3 heads x 64, the training
masks of chip_smoke.py), times on the host clock (mean of REPS calls after
warm-up, no synchronisation inside the timed loop) of:
  * the whole wrapper call, forward (``zorro_attention_qkv`` with the lse)
    and backward (``zorro_attention_qkv_backward``), with int64 and with
    int32 token types;
  * its items: the checks with the int32 cast of int64 types
    (``check_qkv``), the same on int32 types, the output and lse
    allocations, binding the C entry point (``cuda_build.bind``), entering
    the device context and reading the current stream, checking the current
    device and reading the current stream, and the ctypes call
    of the C entry point alone (the launch, and whatever the launcher does
    on the host before it).

    python3 tools/profile_attn_host.py

Needs a CUDA card; imports nothing of the JAX package.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import SEED, packed_types
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_attn, cuda_build, masking

REPS = 200


def host_us(fn, reps: int = REPS, warmup: int = 20) -> float:
    """Mean host microseconds of one call of ``fn``; the device drains
    between the warm-up and the timed calls, not during them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this profile runs only on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)
    doms, f = ("s1", "s2", "dem"), 256
    mi = masking.generate_random_masks(torch.Generator().manual_seed(SEED), doms, (f,) * 3, 384, 60, device=dev)
    types64 = packed_types(mi, 384, f, 3).to(torch.int64)
    types32 = types64.to(torch.int32)
    b, n, heads, inner = 60, 640, 3, 192
    qkv = torch.randn(b, n, 3 * inner, device=dev, generator=g).to(torch.bfloat16)
    o, lse = cuda_attn.zorro_attention_qkv(qkv, heads, types32, 3, return_lse=True)
    do = torch.randn(b, n, inner, device=dev, generator=g).to(torch.bfloat16)
    scale = cuda_attn.default_scale(inner, heads, None)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    argtypes = [p, p, p, ll, ll, p, p, i, p, p, i, i, i, i, ll, ll, ll, ctypes.c_float, i, i, p]
    fn = cuda_build.bind("zorro_attention.cu", "zorro_attention_bf16", argtypes)
    out = torch.empty((b, n, inner), dtype=torch.bfloat16, device=dev)
    lse_buf = torch.empty((b, heads, n), dtype=torch.float32, device=dev)
    q_ptr, k_ptr, v_ptr, rstride = cuda_attn.slab_view(qkv)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def c_call():
        err = fn(q_ptr, k_ptr, v_ptr, n * rstride, rstride, types32.data_ptr(), 0, 0, out.data_ptr(),
                 lse_buf.data_ptr(), b, n, heads, inner // heads, n * inner, inner, n, scale, 3, 1, stream)
        cuda_build.check_launch(err, "zorro_attention")

    def device_context():
        with torch.cuda.device(dev):
            torch.cuda.current_stream(dev).cuda_stream

    items = [
        ("wrapper forward, int64 types", lambda: cuda_attn.zorro_attention_qkv(qkv, heads, types64, 3,
                                                                                return_lse=True)),
        ("wrapper forward, int32 types", lambda: cuda_attn.zorro_attention_qkv(qkv, heads, types32, 3,
                                                                                return_lse=True)),
        ("wrapper backward, int64 types", lambda: cuda_attn.zorro_attention_qkv_backward(qkv, types64, o, lse, do,
                                                                                          heads, 3)),
        ("wrapper backward, int32 types", lambda: cuda_attn.zorro_attention_qkv_backward(qkv, types32, o, lse, do,
                                                                                          heads, 3)),
        ("checks + int32 cast of int64 types", lambda: cuda_attn.check_qkv("t", qkv, heads, types64, 3)),
        ("checks on int32 types", lambda: cuda_attn.check_qkv("t", qkv, heads, types32, 3)),
        ("out + lse allocation", lambda: (torch.empty((b, n, inner), dtype=torch.bfloat16, device=dev),
                                          torch.empty((b, heads, n), dtype=torch.float32, device=dev))),
        ("cuda_build.bind", lambda: cuda_build.bind("zorro_attention.cu", "zorro_attention_bf16", argtypes)),
        ("device context + current stream", device_context),
        ("current-device check + current stream", lambda: (torch.cuda.current_device(),
                                                            torch.cuda.current_stream(dev).cuda_stream)),
        ("ctypes call of the C entry point (forward)", c_call),
    ]
    print(f"[attn-host] {smi}; B={b} N={n} {heads}x{inner // heads}, mean host us of one call over {REPS}",
          flush=True)
    for label, call in items:
        print(f"[attn-host] {label:45s} {host_us(call):10.2f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
