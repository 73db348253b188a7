#!/usr/bin/env python3
"""Where a kernel wrapper's host time goes: each statement of the
``rmsnorm`` wrapper, the pieces every wrapper shares, and whole wrapper
calls, each timed alone with ``time.perf_counter_ns`` over many calls on
the card (default 10,000), the timer's own cost subtracted.

    PYTHONPATH=src python3 tools/host_time.py [--calls N] [--json PATH]

Prints one line per statement (mean ns a call) and writes them to
``--json``.  Launching statements synchronize every 200 calls, outside the
timed region, so the device queue never fills and the host never waits on
it.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import struct
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=10_000)
    ap.add_argument("--json", default="build/host_time.json")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    from repro_torch.core import quantization as Q
    from repro_torch.kernels import loader
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import w4a8_matmul as WM
    from repro_torch.runtime import plan as RP

    if not torch.cuda.is_available():
        raise SystemExit("tools/host_time.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    lib = loader.build()
    rows, D, eps = 4, 3584, 1e-6
    x = torch.randn((rows, D), device=dev).to(torch.bfloat16)
    w = 1.0 + 0.1 * torch.randn((D,), device=dev)
    wb = w.to(torch.bfloat16)
    y = torch.empty_like(x)
    ptrs = (x.data_ptr(), w.data_ptr(), y.data_ptr())
    stream = loader.stream_ptr(dev)
    # what ctypes' argument conversion costs alone: libc's labs, which reads
    # its first argument and ignores the rest (the caller cleans the stack)
    libc = ctypes.CDLL(None)
    noop8, noop1 = libc.labs, libc.llabs
    noop8.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float,
                                                                    ctypes.c_int, ctypes.c_void_p]
    noop1.argtypes = [ctypes.c_char_p]
    noop8.restype = noop1.restype = ctypes.c_long
    pack8 = struct.Struct("<3Q2qdqQ").pack
    pl = RP.pack_linear(Q.quantize(torch.randn((3584, 18944), device=dev) * 0.02, 4))
    xq, sx = Q.quantize_activations(torch.randn((4, 3584), device=dev).to(torch.bfloat16))
    mm = (xq, sx, pl.data, pl.scale[0], pl.zero[0])
    ym = torch.empty((4, 18944), dtype=torch.float32, device=dev)
    mm_ptrs = (*(t.data_ptr() for t in mm), ym.data_ptr(),
               loader.scratch(dev, 148, 2 * (16 * 18944 + 148 * 16)).data_ptr())

    stmts = [
        ("empty statement (timer floor)", lambda: None, False),
        ("weight.shape != (D,)", lambda: w.shape != (D,), False),
        ("x.dtype checks (2 compares)",
         lambda: x.dtype != torch.bfloat16 and x.dtype != torch.float32, False),
        ("x.is_cuda", lambda: x.is_cuda, False),
        ("x.device", lambda: x.device, False),
        ("x.device != w.device", lambda: x.device != w.device, False),
        ("w.get_device() != x.get_device()", lambda: w.get_device() != x.get_device(), False),
        ("is_contiguous() x2", lambda: x.is_contiguous() and w.is_contiguous(), False),
        ("torch.empty_like(x)", lambda: torch.empty_like(x), False),
        ("x.new_empty(x.shape)", lambda: x.new_empty(x.shape), False),
        ("torch.empty(shape, dtype=, device=)",
         lambda: torch.empty((rows, D), dtype=torch.bfloat16, device=dev), False),
        ("x.numel() // D", lambda: x.numel() // D, False),
        ("loader.build()", loader.build, False),
        ("data_ptr() x3", lambda: (x.data_ptr(), w.data_ptr(), y.data_ptr()), False),
        ("torch.cuda.current_stream(dev).cuda_stream",
         lambda: torch.cuda.current_stream(dev).cuda_stream, False),
        ("loader.stream_ptr(dev) (raw pointer)", lambda: loader.stream_ptr(dev), False),
        ("ctypes lookup lib.lib.rmsnorm_launch", lambda: lib.lib.rmsnorm_launch, False),
        ("ctypes launch rmsnorm_launch(...)",
         lambda: lib.rmsnorm_launch(*ptrs, rows, D, eps, True, stream), True),
        ("loader.check(0)", lambda: loader.check(0, "rmsnorm"), False),
        ("ctypes call of a C no-op, 8 arguments", lambda: noop8(*ptrs, rows, D, eps, 1, stream),
         False),
        ("ctypes call of a C no-op, 8 arguments packed in one",
         lambda: noop1(pack8(*ptrs, rows, D, eps, 1, stream)), False),
        ("RN.rmsnorm (whole wrapper)", lambda: RN.rmsnorm(x, w, eps), True),
        ("F.rms_norm", lambda: F.rms_norm(x, (D,), wb, eps), True),
        ("torch.empty((M, N), dtype=float32, device=dev)",
         lambda: torch.empty((4, 18944), dtype=torch.float32, device=dev), False),
        ("sx.new_empty((M, N))", lambda: sx.new_empty((4, 18944)), False),
        ("dtype tuple compare (3 tensors)",
         lambda: (xq.dtype, sx.dtype, pl.data.dtype) != (torch.int8, torch.float32, torch.int8),
         False),
        ("sx.shape != (M, 1)", lambda: sx.shape != (4, 1), False),
        ("get_device() x5", lambda: (xq.get_device(), sx.get_device(), pl.data.get_device(),
                                     pl.scale.get_device(), pl.zero.get_device()), False),
        ("ctypes launch w4a8_matmul_launch(...) (2 splits)",
         lambda: lib.w4a8_matmul_launch(*mm_ptrs, 4, 18944, 3584, 4, 16, 2, stream), True),
        ("WM.matmul_splits", lambda: WM.matmul_splits(4, 18944, 3584), False),
        ("loader.scratch (cached)", lambda: loader.scratch(dev, 148, 1000), False),
        ("WM.w4a8_matmul gate/up M=4 (whole wrapper)",
         lambda: WM.w4a8_matmul(*mm, bits=4), True),
    ]
    out = {"card": torch.cuda.get_device_name(0), "calls": args.calls, "ns": {}}
    floor = 0.0
    for label, fn, launches in stmts:
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        total = 0
        for i in range(args.calls):
            if launches and i % 200 == 0:
                torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            fn()
            total += time.perf_counter_ns() - t0
        torch.cuda.synchronize()
        ns = total / args.calls
        if label.startswith("empty"):
            floor = ns
        out["ns"][label] = ns - floor if not label.startswith("empty") else ns
        print(f"[host] {label:48s} {out['ns'][label]:9.1f} ns", flush=True)
    Path(args.json).parent.mkdir(parents=True, exist_ok=True)
    Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
