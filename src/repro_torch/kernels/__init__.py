"""The serving paths' hand-written Hopper kernels.

Each module holds its kernels' wrappers and their plain PyTorch versions.
A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel (built from ``repro_torch/csrc`` by
``loader``) or raises -- also where an input requires grad, since the
launch would carry no gradient (the training forward runs kernels 4 and 7
through their ``autograd.Function``s).  Every wrapper counts its launches in
``<wrapper>.launches``; a caller that replays a CUDA graph adds the
launches its capture recorded (``add_launch_counts``).  ``counts`` adds the
dispatcher's float path for the quantized linears (``"float_matmul"``:
A16 or group-wise scales, no kernel), counted, reset and replayed the same
way, so that a run can show which path its linears took.
"""
from __future__ import annotations

from typing import Dict


def wrappers() -> Dict[str, object]:
    """name -> kernel wrapper, for every kernel of the serving paths."""
    from repro_torch.kernels import (flash_prefill, grouped_matmul, quant_attention,
                                     rmsnorm, w4a8_matmul)
    return {"w4a8_matmul": w4a8_matmul.w4a8_matmul,
            "paged_quant_decode_attention":
                quant_attention.paged_quant_decode_attention,
            "paged_flash_prefill_attention":
                flash_prefill.paged_flash_prefill_attention,
            "rmsnorm": rmsnorm.rmsnorm,
            "grouped_matmul": grouped_matmul.grouped_matmul,
            "quant_decode_attention": quant_attention.quant_decode_attention,
            "flash_prefill_attention": flash_prefill.flash_prefill_attention}


def counted() -> Dict[str, object]:
    """``wrappers()`` and the dispatcher's float path."""
    from repro_torch.runtime import dispatch
    return {**wrappers(), "float_matmul": dispatch.float_matmul}


def launch_counts() -> Dict[str, int]:
    """name -> launches of every kernel wrapper."""
    return {name: fn.launches for name, fn in wrappers().items()}


def counts() -> Dict[str, int]:
    """``launch_counts()`` and the float path's calls."""
    return {name: fn.launches for name, fn in counted().items()}


def reset_launch_counts() -> None:
    """Zero every count of ``counts()``."""
    for fn in counted().values():
        fn.launches = 0


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add ``counts`` (name -> launches, over the names of ``counts()``) to
    the counts: what one replay of a CUDA graph launched, or, negated, what
    its capture counted without launching."""
    fns = counted()
    for name, n in counts.items():
        fns[name].launches += n
