"""Host time of one call of an operator defined the two ways torch.library
offers, against a plain Python call: ``Library.define`` / ``impl`` with
``register_fake`` and ``register_autograd`` (what ops/library.py does), and
``torch.library.custom_op`` with the same fake and backward. The operator's
implementation only allocates its output, as a kernel wrapper does before
its launch, so the times are the dispatch's own. Each way is timed without
a gradient (serving) and with an input that requires one (the forward of a
training step, its autograd node recorded), and in inference mode.

    python3 tools/bench_op_dispatch.py [--device cuda|cpu] [--calls N]

Prints one line per way: microseconds a call under ``no_grad``, under
``inference_mode`` (no autograd layer at all) and with a gradient, each the
median of five runs of N calls. Imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch


def _impl(x):
    return torch.empty_like(x)


def _fake(x):
    return torch.empty_like(x)


def _setup(ctx, inputs, output):
    pass


def _backward(ctx, grad):
    return grad


def define_library():
    lib = torch.library.Library("dispatch_bench_lib", "DEF")
    lib.define("op(Tensor x) -> Tensor")
    lib.impl("op", _impl, "CPU")
    lib.impl("op", _impl, "CUDA")
    torch.library.register_fake("dispatch_bench_lib::op", _fake, lib=lib)
    torch.library.register_autograd("dispatch_bench_lib::op", _backward, setup_context=_setup, lib=lib)
    return lib, torch.ops.dispatch_bench_lib.op.default


def define_custom_op():
    @torch.library.custom_op("dispatch_bench_custom::op", mutates_args=())
    def op(x: torch.Tensor) -> torch.Tensor:
        return torch.empty_like(x)

    op.register_fake(_fake)
    op.register_autograd(_backward, setup_context=_setup)
    return op


def per_call_us(fn, x, calls: int) -> float:
    runs = []
    for _ in range(6):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(x)
        runs.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(runs[1:])  # the first run warms up


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda")
    p.add_argument("--calls", type=int, default=20000)
    args = p.parse_args(argv)
    _lib, lib_op = define_library()
    custom = define_custom_op()
    x = torch.randn(256, 256, device=args.device)
    xg = x.clone().requires_grad_()
    for name, fn in (("python call", _impl), ("Library.define/impl", lib_op), ("custom_op", custom)):
        with torch.no_grad():
            no_grad = per_call_us(fn, x, args.calls)
        with torch.inference_mode():
            inference = per_call_us(fn, x, args.calls)
        grad = per_call_us(fn, xg, args.calls)
        print(f"{name:22s} {no_grad:8.3f} us a call without a gradient, {inference:8.3f} us in inference "
              f"mode, {grad:8.3f} us with a gradient ({args.device})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
