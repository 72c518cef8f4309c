"""Registers, shared memory, spills and stack frame of every kernel of a
CUDA source of the port, as ptxas reports them (``nvcc -Xptxas -v`` with the
port's build flags), one line per kernel instantiation, after the
compiler's warnings (a wgmma serialized: C7520 and its kin); for
zorro_attention.cu also each kernel's dynamic shared memory per block
(``zorro_attention_smem_bytes``; the f32 instances' too).

    python3 tools/ptxas_report.py [source.cu ...]   # default: every source of csrc/

Needs nvcc (the machine with the card); imports nothing of the JAX package.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_build

FLAGS = [f for f in cuda_build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]


def demangle(names):
    tool = shutil.which("cu++filt") or os.path.join(os.path.dirname(cuda_build.nvcc()), "cu++filt")
    if not os.path.exists(tool):
        tool = shutil.which("c++filt")
    if tool is None:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def report(source: str):
    """[(kernel, registers, static smem bytes, spill stores, spill loads)],
    and the compiler's warnings (ptxas's C7520 and its kin: wgmma serialized)."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([cuda_build.nvcc(), *FLAGS, "-Xptxas", "-v", "-c", str(cuda_build.CSRC / source),
                               "-o", os.path.join(tmp, "k.o")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr}")
    rows, name, spills = [], None, (0, 0, 0)
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(2)), int(m.group(3)), int(m.group(1)))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and name:
            rows.append((name, int(m.group(1)), int(m.group(2)), *spills))
            name, spills = None, (0, 0, 0)
        elif "Used" in line and name:  # no static shared memory
            m = re.search(r"Used (\d+) registers", line)
            rows.append((name, int(m.group(1)), 0, *spills))
            name, spills = None, (0, 0, 0)
    names = demangle([r[0] for r in rows])
    warnings = [line for line in proc.stderr.splitlines() if "warning" in line.lower()]
    return [(n.replace("(int)", "").replace("(bool)", "").split("(")[0], *r[1:]) for n, r in zip(names, rows)], warnings


def main(argv) -> int:
    sources = argv[1:] or list(cuda_build.SOURCES)
    for source in sources:
        smem = None
        if source == "zorro_attention.cu":
            fn = cuda_build.bind(source, "zorro_attention_smem_bytes", [ctypes.c_int, ctypes.c_int])
            fn.restype = ctypes.c_longlong
            smem = fn
        rows, warnings = report(source)
        for line in warnings:
            print(f"[ptxas] {source}: {line}", flush=True)
        for kernel, regs, static, st, ld, stack in rows:
            extra = ""
            m = re.search(r"(zorro_attention(?:_f32_fwd|_f32_dq|_f32_dkdv|_dq|_dkdv)?_kernel)<(\d+), (\d+)(, \d+)?>",
                          kernel)
            if smem is not None and m:
                which = {"zorro_attention_kernel": 0, "zorro_attention_dq_kernel": 1,
                         "zorro_attention_dkdv_kernel": 2, "zorro_attention_f32_fwd_kernel": 3,
                         "zorro_attention_f32_dq_kernel": 4, "zorro_attention_f32_dkdv_kernel": 5}[m.group(1)]
                extra = f", dynamic smem {smem(which, int(m.group(2)))} bytes"
            print(f"[ptxas] {source}: {kernel}: {regs} registers, static smem {static} bytes{extra}, "
                  f"spill stores {st} bytes, spill loads {ld} bytes, stack frame {stack} bytes", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
