"""Public wrappers for the kernels under the reference's names and tensor
arguments -- port of ``repro.kernels.ops``.

Each op keeps the port's dispatch contract: a CUDA tensor goes through the
kernel's wrapper (the launch counted in ``kernels.counts()``), which
launches the Hopper kernel or raises; a CPU tensor takes the plain version;
nothing falls back.  On the CPU the attention ops run their plain versions
in float32 (the oracles of ``kernels.ref``), the math of the reference's
kernels, which compute scores, probabilities and values in float32 whatever
the inputs' dtype; on the card the kernels read bf16 queries (and bf16 keys
and values for ``flash_prefill``) and keep their own precision, as the
serving path runs them.

The reference's Pallas tile arguments (``blocks``, ``block_s``,
``block_rows``, ``bq``, ``bk``) and its ``INTERPRET`` flag have no meaning
here: each kernel chooses its launch from the shapes (``core.tiling.
kernel_tiles`` reads the matmul's), and there is no interpret mode.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantization as q
from repro_torch.kernels import flash_prefill as FP
from repro_torch.kernels import quant_attention as QA
from repro_torch.kernels import ref as R
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import w4a8_matmul as WM


def _plain_here(t: torch.Tensor) -> bool:
    """The plain version for CPU tensors; the wrapper (kernel or raise) for
    every other device."""
    return t.device.type == "cpu"


def quant_matmul_kernel(x: torch.Tensor, wq_packed: torch.Tensor,
                        w_scale: torch.Tensor, w_zero: torch.Tensor,
                        bits: int = 4) -> torch.Tensor:
    """Float activations in; dynamic int8 activation quant + the W4A8 kernel.
    ``wq_packed`` int8 [K, N/2] (int4 nibbles) or [K, N]; scale/zero f32
    [N] -> f32 [M, N]."""
    xq, sx = q.quantize_activations(x)
    return WM.w4a8_matmul(xq, sx, wq_packed, w_scale, w_zero, bits=bits)


def quant_decode_attention(qh: torch.Tensor, k_q: torch.Tensor,
                           k_scale: torch.Tensor, k_zero: torch.Tensor,
                           v: torch.Tensor, length) -> torch.Tensor:
    """One pre-scaled query a row [B, H, D] over a dense int8-key cache
    (``length``: the live prefix, a scalar or [B]) -> f32 [B, H, D]."""
    if _plain_here(qh):
        return R.quant_decode_attention_ref(qh, k_q, k_scale, k_zero, v, length)
    return QA.quant_decode_attention(qh, k_q, k_scale, k_zero, v, length)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x [..., D] -> x's shape and dtype (float32 math)."""
    return RN.rmsnorm(x, weight, eps)


def flash_prefill(q_: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """Pre-scaled queries [B, T, H, D] over keys and values [B, S, Hkv, D],
    query i at position i -> f32 [B, T, H, D]."""
    if _plain_here(q_):
        return R.flash_prefill_ref(q_, k, v, causal=causal, window=window)
    return FP.flash_prefill_attention(q_, k, v, causal=causal, window=window)
