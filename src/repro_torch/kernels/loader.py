"""Build and load the port's CUDA kernels (``repro_torch/csrc``).

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded through ``ctypes`` — no PyTorch headers,
so a build takes seconds.  The library is built at first use into
``build/kernels/<hash>/`` at the repository root, keyed by a hash of the
sources and flags, one ``nvcc -c`` per source started together, then
linked.  Every C entry point returns ``cudaGetLastError()``; ``check``
turns a non-zero code into an exception.  ``stream_ptr`` and ``scratch``
serve every wrapper: the current stream as a raw pointer, and the cached
scratch buffers of the kernels that combine partial results across blocks
(``capture`` scopes them to one CUDA graph).  ``refuse_grad`` guards every
wrapper's launch against autograd, which cannot see through it;
``plain_vjp`` is the backward of the kernels that train under an
``autograd.Function``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
# --split-compile: a source's optimization passes run on 4 threads, so the
# two decode sources (28 kernel instantiations each) no longer hold the
# build back while the card's host has cores to spare
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--split-compile=4", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Every entry point takes one pointer to its arguments, packed by ``struct``
# as 8-byte little-endian words (Q a pointer, q an int, d a float; csrc/
# common.cuh PackedArgs): ctypes converts each argument of a call
# separately, and on an H100's host that cost ~2.1-2.5 us for 8 arguments
# against ~0.8-1.2 us for one packed (tools/host_time.py).
SIGNATURES = {
    # xq, sx, w, scale, zero, y, scratch, M, N, K, bits, tile_rows, splits,
    # stream
    "w4a8_matmul_launch": "7Q6qQ",
    # q, kq, kscale, kzero, v, table, base, length, out, scratch,
    # B, Hkv, G, D, ps, n_pages, window, splits, key_bits, v_bf16, stream
    "paged_decode_attention_launch": "10Q10qQ",
    # q, kq, kscale, kzero, v, table, pos0, out, B, C, Hkv, G, D, ps,
    # n_pages, key_bits, v_bf16, stream
    "paged_prefill_attention_launch": "8Q9qQ",
    # x, w, y, rows, D, eps, is_bf16, stream
    "rmsnorm_launch": "3Q2qdqQ",
    # xq, sx, w, scale, zero, y, ids, rows, E, M, N, K, G, bits, stream
    "grouped_matmul_launch": "8Q6qQ",
    # q, kq, kscale, kzero, v, length, out, scratch, B, S, Hkv, G, D, splits,
    # key_bits, v_bf16, stream
    "decode_attention_launch": "8Q8qQ",
    # q, k, v, out, B, T, S, Hkv, G, D, causal, window, stream
    "flash_prefill_attention_launch": "4Q8qQ",
}


class KernelLibrary:
    """The built shared library plus its build report; each C entry point of
    ``SIGNATURES`` is an attribute that takes the arguments one by one and
    packs them."""

    def __init__(self, path: Path, build_s: float, ptxas_log: str):
        self.path = path
        self.build_s = build_s
        self.ptxas_log = ptxas_log
        self.lib = ctypes.CDLL(str(path))
        for name, fmt in SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = [ctypes.c_char_p]
            fn.restype = ctypes.c_int
            setattr(self, name, _packing(fn, struct.Struct("<" + fmt).pack))


def _packing(fn, pack):
    def call(*args):
        return fn(pack(*args))
    return call


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


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise where a launch would cut the autograd chain: a kernel writes
    its output through ``ctypes``, so the output has no ``grad_fn`` and
    every input's gradient would be lost without an error.  Grad mode is
    off inside an ``autograd.Function``'s forward, so the Functions of
    ``rmsnorm`` and ``flash_prefill_attention`` (the training forward's
    kernels) pass; any other call on tensors that require grad must come
    under ``torch.no_grad()``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad and the kernel's output would carry "
            "no gradient; call it through its autograd Function or under "
            "torch.no_grad()")


def plain_vjp(fn, inputs, needs, grad_out: torch.Tensor) -> tuple:
    """The backward of a kernel's ``autograd.Function``: ``fn`` (the
    kernel's plain version) recomputed on detached ``inputs`` under grad
    mode, and ``torch.autograd.grad`` of it against ``grad_out`` for each
    input whose ``needs`` flag is set (None for the others) -- the JAX
    package has no backward kernel, and XLA differentiates the plain op."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(bool(n)) for t, n in zip(inputs, needs)]
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(fn(*leaves), wanted, grad_out) if wanted else ())
    return tuple(next(grads) if n else None for n in needs)


def stream_ptr(device: torch.device) -> int:
    """The current stream of ``device`` (a CUDA-graph capture's side stream
    too) as a raw pointer, without building a ``torch.cuda.Stream`` object,
    which costs the host several microseconds a call."""
    return torch._C._cuda_getCurrentRawStream(
        device.index if device.index is not None else torch.cuda.current_device())


_SCRATCH: dict = {}
# layout -> scratch buffer, for the length of a capture made by ``capture``
_CAPTURE_SCRATCH: Optional[dict] = None


@contextlib.contextmanager
def capture(graph: "torch.cuda.CUDAGraph", pool=None):
    """``torch.cuda.graph(graph, pool=pool)``, in which every launch of one
    scratch layout shares one buffer, made (and its zeroing captured) at the
    layout's first launch: the graph's kernels run in order on one stream
    and leave their counters at 0, as eager launches do."""
    global _CAPTURE_SCRATCH
    _CAPTURE_SCRATCH = {}
    try:
        with torch.cuda.graph(graph, pool=pool):
            yield
    finally:
        _CAPTURE_SCRATCH = None


def scratch(device: torch.device, counters: int, words: int) -> torch.Tensor:
    """A kernel's scratch: ``counters`` int32 combine counters (padded to a
    multiple of 4) then ``words`` 32-bit words of partial results.  Zeroed
    once; every launch leaves its counters at 0 and the partials need no
    clearing, so one buffer per device, stream and layout is reused.  Inside
    a CUDA-graph capture the buffer belongs to the graph, its zeroing
    captured with it: one per layout within ``capture``, one per launch in a
    capture made otherwise."""
    n = (counters + 3) // 4 * 4 + words
    if torch.cuda.is_current_stream_capturing():
        if _CAPTURE_SCRATCH is None:
            return torch.zeros((n,), dtype=torch.int32, device=device)
        cache, key = _CAPTURE_SCRATCH, (device, counters, n)
    else:
        cache, key = _SCRATCH, (device, stream_ptr(device), counters, n)
    buf = cache.get(key)
    if buf is None:
        buf = cache[key] = torch.zeros((n,), dtype=torch.int32, device=device)
    return buf
