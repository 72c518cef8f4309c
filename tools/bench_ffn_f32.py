"""K2 / K2b's f32 instance (csrc/fused_ffn.cu, csrc/fused_ffn_bwd.cu) of one
or more source trees timed against each other and against the f32 plain
chain in one process, at the shapes the f32 paths run: the pretraining
step's GEGLU rows (M = 38,400 encoder, 15,360 fusion) and decoder MLP rows
(M = 15,360), the serving forward's (GEGLU M = 1024 and 256, MLP 2048 and
256) and the batched decoder's task axis (T = 3, M = 256 x 1 and 256 x 8).

Each tree's two sources are built with the port's nvcc flags into a
temporary directory and called through their C entries, whose interface
every version shares (the workspace each asks for itself). For each shape
and version the script prints the device time of one call (torch.profiler:
the sum of its kernels, 10 calls after 3 warm-ups), the kernels a call, and
the rel-L2 of the output (every gradient, the worst) against the f32 plain
version (ops/cuda_ffn.py, TF32 off); the plain chain's own device time is
printed beside them.

    python3 tools/bench_ffn_f32.py [label=tree ...]   # default: this tree

Needs a CUDA card and nvcc; imports nothing of the JAX package.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as smoke  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_build, cuda_ffn  # noqa: E402

P, I = ctypes.c_void_p, ctypes.c_int


def build(tree: str, out_dir: str):
    """The two f32 FFN libraries of a tree, built and loaded."""
    csrc = os.path.join(tree, "incomplete_multimodal_fusion_tpu_torch", "csrc")
    procs = {}
    for source in ("fused_ffn.cu", "fused_ffn_bwd.cu"):
        out = os.path.join(out_dir, f"{abs(hash(tree))}-{source}.so")
        procs[source] = (out, subprocess.Popen([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", out,
                                                os.path.join(csrc, source)]))
    libs = {}
    for source, (out, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {tree}/{source}")
        libs[source] = ctypes.CDLL(out)
    return libs


class Version:
    """The f32 C entries of one tree."""

    def __init__(self, libs):
        fwd, bwd = libs["fused_ffn.cu"], libs["fused_ffn_bwd.cu"]
        self.fwd, self.bwd = fwd, bwd
        for lib, name, args in ((fwd, "geglu_ffn_f32", [P] * 6 + [I] * 3 + [P]),
                                (fwd, "mlp_ffn_f32", [P] * 7 + [I] * 4 + [P]),
                                (fwd, "mlp_ffn_tasks_f32", [P] * 7 + [I] * 5 + [P]),
                                (bwd, "geglu_ffn_bwd_f32", [P] * 10 + [I] * 3 + [P]),
                                (bwd, "mlp_ffn_bwd_f32", [P] * 11 + [I] * 4 + [P])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        for lib, name in ((fwd, "ffn_fwd_f32_workspace_floats"), (bwd, "ffn_bwd_f32_scratch_floats")):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = [I] * 5, ctypes.c_longlong
        self.tasks_floats = getattr(fwd, "ffn_fwd_tasks_f32_workspace_floats", None)
        if self.tasks_floats is not None:
            self.tasks_floats.argtypes, self.tasks_floats.restype = [I] * 5, ctypes.c_longlong

    @staticmethod
    def _ws(floats, dev):
        return torch.empty((max(int(floats), 1),), dtype=torch.float32, device=dev)

    @staticmethod
    def _call(fn, *args):
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args],
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{fn.__name__}: cudaError_t {err}")

    def geglu(self, x, gamma, w_in, w_out):
        m, d = x.shape
        inner = w_out.shape[1]
        y = torch.empty_like(x)
        ws = self._ws(self.fwd.ffn_fwd_f32_workspace_floats(0, m, d, inner, d), x.device)
        self._call(self.fwd.geglu_ffn_f32, x, gamma, w_in, w_out, y, ws, m, d, inner)
        return y

    def mlp(self, x, w1, b1, w2, b2):
        m, d = x.shape
        hid, out = w1.shape[0], w2.shape[0]
        y = x.new_empty((m, out))
        ws = self._ws(self.fwd.ffn_fwd_f32_workspace_floats(1, m, d, hid, out), x.device)
        self._call(self.fwd.mlp_ffn_f32, x, w1, b1, w2, b2, y, ws, m, d, hid, out)
        return y

    def mlp_tasks(self, x, w1, b1, w2, b2):
        t, m, d = x.shape
        hid, out = w1.shape[1], w2.shape[1]
        y = x.new_empty((t, m, out))
        floats = (self.tasks_floats(t, m, d, hid, out) if self.tasks_floats is not None
                  else self.fwd.ffn_fwd_f32_workspace_floats(1, t * m, d, hid, out))
        self._call(self.fwd.mlp_ffn_tasks_f32, x, w1, b1, w2, b2, y, self._ws(floats, x.device), t, m, d, hid, out)
        return y

    def geglu_bwd(self, x, gamma, w_in, w_out, dy):
        m, d = x.shape
        inner = w_out.shape[1]
        outs = [torch.empty_like(v) for v in (x, gamma, w_in, w_out)]
        sc = self._ws(self.bwd.ffn_bwd_f32_scratch_floats(0, m, d, inner, d), x.device)
        self._call(self.bwd.geglu_ffn_bwd_f32, x, gamma, w_in, w_out, dy, *outs, sc, m, d, inner)
        return outs

    def mlp_bwd(self, x, w1, b1, w2, b2, dy):
        m, d = x.shape
        hid, out = w1.shape[0], w2.shape[0]
        outs = [torch.empty_like(v) for v in (x, w1, b1, w2, b2)]
        sc = self._ws(self.bwd.ffn_bwd_f32_scratch_floats(1, m, d, hid, out), x.device)
        self._call(self.bwd.mlp_ffn_bwd_f32, x, w1, b1, w2, dy, *outs, sc, m, d, hid, out)
        return outs


def cases(dev):
    """(label, version method, plain function, operands) at the f32 paths'
    shapes, seeded."""
    g = torch.Generator(device=dev).manual_seed(0)

    def randf(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=g) * scale

    d, inner, dd, hid = 192, 512, 256, 1024
    gw = (1 + 0.1 * randf(d), randf(2 * inner, d, scale=d ** -0.5), randf(d, inner, scale=inner ** -0.5))
    mw = (randf(hid, dd, scale=dd ** -0.5), randf(hid, scale=0.1), randf(dd, hid, scale=hid ** -0.5),
          randf(dd, scale=0.1))
    tw = (randf(3, hid, dd, scale=dd ** -0.5), randf(3, hid, scale=0.1), randf(3, dd, hid, scale=hid ** -0.5),
          randf(3, dd, scale=0.1))
    out = []
    for m in (38400, 15360, 1024, 256):
        out.append((f"GEGLU fwd M={m}", "geglu", cuda_ffn.geglu_ffn_reference, (randf(m, d), *gw)))
    for m in (38400, 15360):
        out.append((f"GEGLU bwd M={m}", "geglu_bwd", cuda_ffn.geglu_ffn_backward_reference,
                    (randf(m, d), *gw, randf(m, d))))
    for m in (15360, 2048, 256):
        out.append((f"MLP fwd M={m}", "mlp", cuda_ffn.mlp_ffn_reference, (randf(m, dd), *mw)))
    out.append(("MLP bwd M=15360", "mlp_bwd", cuda_ffn.mlp_ffn_backward_reference,
                (randf(15360, dd), *mw, randf(15360, dd))))
    for b in (1, 8):
        out.append((f"MLP tasks T=3 M=256x{b}", "mlp_tasks", cuda_ffn.mlp_ffn_tasks_reference,
                    (randf(3, 256 * b, dd), *tw)))
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[bench_ffn_f32] {smi}; torch {torch.__version__}", flush=True)
    trees = [a.split("=", 1) for a in argv[1:]] or [["this", ROOT]]
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        versions = {label: Version(build(os.path.abspath(tree), tmp)) for label, tree in trees}
        for label, method, plain, args in cases(dev):
            ref = smoke.outputs(plain(*args))
            plain_ms = smoke.profiled_ms(lambda: plain(*args))[0]
            line = f"[bench_ffn_f32] {label:24s} f32 chain {plain_ms:.6g} ms"
            for name, version in versions.items():
                fn = getattr(version, method)
                got = smoke.outputs(fn(*args))
                torch.cuda.synchronize()
                rel = max(smoke.rel_l2(o, r) for o, r in zip(got, ref))
                ms, count, _ = smoke.profiled_ms(lambda: fn(*args))
                line += f" | {name} {ms:.6g} ms, {count:g} kernels, rel_l2 {rel:.3g}"
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
