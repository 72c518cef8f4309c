"""K2 / K2b's bf16 wide path (csrc/fused_ffn.cu, csrc/fused_ffn_bwd.cu past
d = 256) of one or more source trees timed against each other and against
the unfused bf16 chain in one process, at the shapes a `base` pretraining
step and serving forward run: GEGLU (d = 768, inner 2048) forward at M =
8192, 38,400 (the encoder rows of B = 60), 15,360 (the fusion rows), 1024
and 256 (B = 1 serving), backward at 8192, 38,400 and 15,360; the MLP at
`base`'s widths (d = 768, hidden 3072) at M = 8192; `large` (d = 1024,
inner 2730 padded to 2736) at M = 4096.

Each tree's two sources are built with the port's nvcc flags into a
temporary directory and called through their bf16 C entries, whose
interface every version shares (each asks for its own workspace). For each
shape and version the script prints the device time of one call
(torch.profiler: the sum of its kernels, 10 calls after 3 warm-ups), its
kernels by name, the rel-L2 of the output (every gradient, the worst)
against the bf16 plain version (ops/cuda_ffn.py) and whether two calls are
bitwise equal; beside them the unfused chain's device time (forward: the
cuBLAS chain; backward: its autograd backward) and the bound (the larger of
the operations at 989 TFLOP/s and the bytes at 3.35 TB/s).

    python3 tools/bench_ffn_wide.py [--shapes a,b] [label=tree ...]   # default: this tree

(``--shapes``: substrings of the case labels to run, e.g. ``bwd M=8192``.)
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
    """The two FFN libraries of a tree, built and loaded."""
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
    """The bf16 C entries of one tree."""

    def __init__(self, libs):
        fwd, bwd = libs["fused_ffn.cu"], libs["fused_ffn_bwd.cu"]
        self.fwd, self.bwd = fwd, bwd
        for lib, name, args in ((fwd, "geglu_ffn_bf16", [P] * 6 + [I] * 3 + [P]),
                                (fwd, "mlp_ffn_bf16", [P] * 7 + [I] * 4 + [P]),
                                (bwd, "geglu_ffn_bwd_bf16", [P] * 13 + [I] * 3 + [P]),
                                (bwd, "mlp_ffn_bwd_bf16", [P] * 13 + [I] * 4 + [P])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        for lib, name in ((fwd, "ffn_fwd_workspace_bytes"), (bwd, "ffn_bwd_scratch_floats")):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = [I] * 5, ctypes.c_longlong

    @staticmethod
    def _call(fn, *args):
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args],
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{fn.__name__}: cudaError_t {err}")

    def _ws(self, mode, m, d, hid, d_out, dev):
        size = self.fwd.ffn_fwd_workspace_bytes(mode, m, d, hid, d_out)
        return torch.empty((max(int(size), 1),), dtype=torch.uint8, device=dev)

    def geglu(self, x, gamma, w_in, w_out):
        w_in, w_out = cuda_ffn.pad_geglu_hidden(w_in, w_out)
        m, d = x.shape
        inner = w_out.shape[1]
        y = torch.empty_like(x)
        self._call(self.fwd.geglu_ffn_bf16, x, gamma, w_in, w_out, y, self._ws(0, m, d, inner, d, x.device), m, d,
                   inner)
        return y

    def mlp(self, x, w1, b1, w2, b2):
        m, d = x.shape
        hid, out = w1.shape[0], w2.shape[0]
        y = x.new_empty((m, out))
        self._call(self.fwd.mlp_ffn_bf16, x, w1, b1, w2, b2, y, self._ws(1, m, d, hid, out, x.device), m, d, hid,
                   out)
        return y

    def geglu_bwd(self, x, gamma, w_in, w_out, dy):
        real = w_out.shape[1]
        w_in, w_out = cuda_ffn.pad_geglu_hidden(w_in, w_out)
        m, d = x.shape
        inner = w_out.shape[1]
        outs = [torch.empty_like(v) for v in (x, gamma, w_in, w_out)]
        du, a, xn = (x.new_empty((m, w)) for w in (2 * inner, inner, d))
        sc = torch.empty((self.bwd.ffn_bwd_scratch_floats(0, m, d, inner, d),), dtype=torch.float32, device=x.device)
        self._call(self.bwd.geglu_ffn_bwd_bf16, x, gamma, w_in, w_out, dy, *outs, du, a, xn, sc, m, d, inner)
        return (outs[0], outs[1], *cuda_ffn.unpad_geglu_grads(outs[2], outs[3], real))

    def mlp_bwd(self, x, w1, b1, w2, b2, dy):
        m, d = x.shape
        hid, out = w1.shape[0], w2.shape[0]
        outs = [torch.empty_like(v) for v in (x, w1, b1, w2, b2)]
        dh, a = x.new_empty((m, hid)), x.new_empty((m, hid))
        sc = torch.empty((self.bwd.ffn_bwd_scratch_floats(1, m, d, hid, out),), dtype=torch.float32,
                         device=x.device)
        self._call(self.bwd.mlp_ffn_bwd_bf16, x, w1, b1, w2, dy, *outs, dh, a, sc, m, d, hid, out)
        return outs


def profiled(fn, tries: int = 3):
    """smoke.profiled_ms of ``fn``, profiled again where the profiler
    dropped every event of a profile (it reads 0 ms)."""
    for _ in range(tries):
        out = smoke.profiled_ms(fn)
        if out[0] > 0:
            return out
    raise RuntimeError("the profiler saw no device event in three profiles")


def ffn_work(m, backward, geglu, d, hid):
    """(flops, bytes) of one call: the products, and each operand read and
    output written once (as phase 3's rows)."""
    if geglu:
        weights = 3 * hid * d + d
        flops = (16 if backward else 6) * m * d * hid
    else:
        weights = 2 * hid * d + hid + d
        flops = (10 if backward else 4) * m * d * hid
    return flops, 2 * ((3 if backward else 2) * m * d + (2 if backward else 1) * weights)


def cases(dev):
    """(label, version method, plain function, chain, operands, work) at the
    wide path's shapes, seeded."""
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=g) * scale).to(torch.bfloat16)

    out = []
    for d, inner, fwd_ms, bwd_ms, tag in ((768, 2048, (8192, 38400, 15360, 1024, 256), (8192, 38400, 15360), "base"),
                                          (1024, 2730, (4096,), (4096,), "large")):
        gw = ((1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(torch.bfloat16),
              randn(2 * inner, d, scale=d ** -0.5), randn(d, inner, scale=inner ** -0.5))
        for m in fwd_ms:
            x = randn(m, d)
            out.append((f"{tag} GEGLU fwd M={m}", "geglu", cuda_ffn.geglu_ffn_reference, smoke.unfused_geglu(x, *gw),
                        (x, *gw), ffn_work(m, False, True, d, inner)))
        for m in bwd_ms:
            x, dy = randn(m, d), randn(m, d)
            out.append((f"{tag} GEGLU bwd M={m}", "geglu_bwd", cuda_ffn.geglu_ffn_backward_reference,
                        smoke.unfused_backward(smoke.unfused_geglu, (x, *gw), dy), (x, *gw, dy),
                        ffn_work(m, True, True, d, inner)))
    d, hid = 768, 3072
    mw = (randn(hid, d, scale=d ** -0.5), randn(hid, scale=0.1), randn(d, hid, scale=hid ** -0.5), randn(d, scale=0.1))
    x, dy = randn(8192, d), randn(8192, d)
    out.append(("base MLP fwd M=8192", "mlp", cuda_ffn.mlp_ffn_reference, smoke.unfused_mlp(x, *mw), (x, *mw),
                ffn_work(8192, False, False, d, hid)))
    out.append(("base MLP bwd M=8192", "mlp_bwd", cuda_ffn.mlp_ffn_backward_reference,
                smoke.unfused_backward(smoke.unfused_mlp, (x, *mw), dy), (x, *mw, dy),
                ffn_work(8192, True, False, d, hid)))
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[bench_ffn_wide] {smi}; torch {torch.__version__}", flush=True)
    args = list(argv[1:])
    shapes = None
    if "--shapes" in args:
        i = args.index("--shapes")
        shapes = args[i + 1].split(",")
        del args[i:i + 2]
    trees = [a.split("=", 1) for a in args] or [["this", ROOT]]
    dev = torch.device("cuda", 0)
    failed = False
    with tempfile.TemporaryDirectory() as tmp:
        versions = {label: Version(build(os.path.abspath(tree), tmp)) for label, tree in trees}
        for label, method, plain, chain, operands, (flops, n_bytes) in cases(dev):
            if shapes and not any(s in label for s in shapes):
                continue
            ref = smoke.outputs(plain(*operands))
            chain_ms = profiled(chain)[0]
            bound_ms, bound_by = smoke.bound(flops, n_bytes, smoke.PEAK_BF16)
            print(f"[bench_ffn_wide] {label}: chain {chain_ms:.6g} ms, bound {bound_ms:.6g} ms ({bound_by})",
                  flush=True)
            for name, version in versions.items():
                fn = getattr(version, method)
                outs = smoke.outputs(fn(*operands))
                again = smoke.outputs(fn(*operands))
                torch.cuda.synchronize()
                rel = max(smoke.rel_l2(o, r) for o, r in zip(outs, ref))
                bitwise = all(torch.equal(a, b) for a, b in zip(outs, again))
                ms, per_call, per_name = profiled(lambda: fn(*operands))
                kernels = ", ".join(f"{smoke.kernel_name(k)} {v:.4g}" for k, v in sorted(per_name.items()))
                ok = rel <= smoke.KERNEL_REL_L2 and bitwise and all(torch.isfinite(o).all() for o in outs)
                failed |= not ok
                print(f"[bench_ffn_wide]   {name}: {ms:.6g} ms ({ms / chain_ms:.3g}x the chain, {bound_ms / ms:.3g} "
                      f"of the bound), {per_call:g} kernels a call ({kernels}); rel_l2 {rel:.4g}; bitwise run to "
                      f"run {bitwise}{'' if ok else '  FAILED'}", flush=True)
                del outs, again
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
