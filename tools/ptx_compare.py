"""Whether the kernels of a CUDA source compile to the same PTX in two
source trees: each tree's source is compiled with the port's nvcc flags
(``-ptx``), the PTX is cut into its ``.entry`` functions, and each entry
present in both is compared byte for byte. Prints one line per source: the
entries the same, those that differ (by name), and those only in one tree;
where some differ, the start of the first one's diff.

    python3 tools/ptx_compare.py BEFORE_TREE AFTER_TREE [source.cu ...]
    # default sources: every source of csrc/

Needs nvcc (the machine with the card); imports nothing of the JAX package.
"""
from __future__ import annotations

import difflib
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_build

FLAGS = [f for f in cuda_build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]


def entries(tree: str, source: str, tmp: str):
    """{entry name: its PTX text} of a tree's source."""
    out = os.path.join(tmp, f"{abs(hash(tree))}-{source}.ptx")
    src = os.path.join(tree, "incomplete_multimodal_fusion_tpu_torch", "csrc", source)
    proc = subprocess.run([cuda_build.nvcc(), *FLAGS, "-ptx", src, "-o", out], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -ptx failed for {src}:\n{proc.stderr}")
    # an anonymous namespace's mangled name carries a hash of its file: the
    # same kernel in an edited file would otherwise compare as a new one
    text = re.sub(r"(_Z+N)\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}(\d+)", r"\1_ANON_\2", open(out).read())
    found = {}
    for m in re.finditer(r"\.entry (\w+)\(", text):
        end = text.find("\n}\n", m.end())
        found[m.group(1)] = text[m.start():end]
    return found


def main(argv) -> int:
    before, after = argv[1], argv[2]
    sources = argv[3:] or list(cuda_build.SOURCES)
    with tempfile.TemporaryDirectory() as tmp:
        for source in sources:
            a, b = entries(before, source, tmp), entries(after, source, tmp)
            both = sorted(set(a) & set(b))
            differ = [n for n in both if a[n] != b[n]]
            print(f"[ptx_compare] {source}: {len(both) - len(differ)} of {len(both)} common entries the same; "
                  f"differ {differ}; only before {len(set(a) - set(b))}; only after {len(set(b) - set(a))} "
                  f"{sorted(set(b) - set(a))}", flush=True)
            if differ:  # where the first one differs
                diff = difflib.unified_diff(a[differ[0]].splitlines(), b[differ[0]].splitlines(), lineterm="", n=1)
                print("\n".join(list(diff)[:40]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
