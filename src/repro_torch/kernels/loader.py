"""Build and load the port's CUDA kernels (``repro_torch/csrc``).

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded through ``ctypes`` — no PyTorch headers,
so a build takes seconds.  The library is built at first use into
``build/kernels/<hash>/`` at the repository root, keyed by a hash of the
sources and flags, one ``nvcc -c`` per source started together, then
linked.  Every C entry point returns ``cudaGetLastError()``; ``check``
turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
SIGNATURES = {
    # xq, sx, w, scale, zero, y, M, N, K, bits, stream
    "w4a8_matmul_launch": [P, P, P, P, P, P, I, I, I, I, P],
    # q, kq, kscale, kzero, v, table, base, length, out, scratch,
    # B, Hkv, G, D, ps, n_pages, window, splits, stream
    "paged_decode_attention_launch": [P] * 10 + [I] * 8 + [P],
    # q, kq, kscale, kzero, v, table, pos0, out, B, C, Hkv, G, D, ps,
    # n_pages, stream
    "paged_prefill_attention_launch": [P] * 8 + [I] * 7 + [P],
    # x, w, y, rows, D, eps, is_bf16, stream
    "rmsnorm_launch": [P, P, P, I, I, ctypes.c_float, I, P],
    # xq, sx, w, scale, zero, y, ids, rows, E, M, N, K, G, bits, stream
    "grouped_matmul_launch": [P] * 8 + [I] * 6 + [P],
    # q, kq, kscale, kzero, v, length, out, scratch, B, S, Hkv, G, D, splits,
    # stream
    "decode_attention_launch": [P] * 8 + [I] * 6 + [P],
    # q, k, v, out, B, T, S, Hkv, G, D, causal, window, stream
    "flash_prefill_attention_launch": [P] * 4 + [I] * 8 + [P],
}


class KernelLibrary:
    """The built shared library plus its build report."""

    def __init__(self, path: Path, build_s: float, ptxas_log: str):
        self.path = path
        self.build_s = build_s
        self.ptxas_log = ptxas_log
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self.lib, name)


_LIB: Optional[KernelLibrary] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def build(force: bool = False) -> KernelLibrary:
    """Compile (if needed) and load the kernel library."""
    global _LIB
    if _LIB is not None and not force:
        return _LIB
    cus, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cus + headers:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / "libreprokernels.so"
    t0 = time.perf_counter()
    log = ""
    if force or not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for cu in cus:
            obj = out_dir / (cu.stem + ".o")
            procs.append((cu, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(cu), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for cu, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"--- {cu.name}\n{text}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {cu.name}:\n{text}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = out_dir / "libreprokernels.so.tmp"
        link = subprocess.run(
            [nvcc, "-shared", *[str(out_dir / (cu.stem + ".o")) for cu in cus],
             "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        tmp.replace(lib_path)
        log = "\n".join(logs)
    _LIB = KernelLibrary(lib_path, time.perf_counter() - t0, log)
    return _LIB


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
