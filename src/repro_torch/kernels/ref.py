"""Oracles for the kernels under the reference's contracts -- port of
``repro.kernels.ref`` (its pure-jnp allclose targets).

Each oracle adapts the reference's layout and calls the plain version that
already computes the function beside its wrapper; no arithmetic is written
twice.  The float oracles run in float32, as the reference's do.
``flash_prefill_ref`` is the port's own: the reference holds its flash
kernel to ``models.attention.flash_attention`` at float32 in its tests,
and this is that oracle.
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import PrecisionPolicy
from repro_torch.kernels import flash_prefill as FP
from repro_torch.kernels import quant_attention as QA
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import w4a8_matmul as WM


def w4a8_matmul_ref(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
                    w_scale: torch.Tensor, w_zero: torch.Tensor) -> torch.Tensor:
    """W4A8 integer matmul oracle.

    xq: int8 [M, K] (symmetric per-row quantized activations, scale sx [M, 1])
    wq: int8 [K, N] UNPACKED int4 values in [0, 15]
    w_scale/w_zero: f32 [N] per-output-channel asymmetric params
    y = sx * w_scale * (xq @ wq - w_zero * rowsum(xq)), f32 [M, N]: the
    plain version on unpacked (8-bit carrier) weights."""
    return WM.w4a8_matmul_plain(xq, sx, wq, w_scale, w_zero, bits=8)


def w8a8_matmul_ref(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
                    w_scale: torch.Tensor, w_zero: torch.Tensor) -> torch.Tensor:
    """Same contract with int8 weights in [-128, 127]."""
    return w4a8_matmul_ref(xq, sx, wq, w_scale, w_zero)


def quant_decode_attention_ref(q: torch.Tensor, k_q: torch.Tensor,
                               k_scale: torch.Tensor, k_zero: torch.Tensor,
                               v_fp8: torch.Tensor, length) -> torch.Tensor:
    """Decode attention oracle with fused dequant.

    q: [B, H, D] (already pre-scaled by 1/sqrt(D) -- paper C5)
    k_q: int8 [B, S, Hkv, D]; k_scale/k_zero: f32 [B, S, Hkv]
    v_fp8: fp8/bf16 [B, S, Hkv, D]
    length: the valid prefix of the cache (a scalar, or [B]).
    Returns f32 [B, H, D]: the dense plain version with float32 keys,
    scores and probabilities."""
    return QA.quant_decode_attention_plain(q, k_q, k_scale, k_zero, v_fp8, length,
                                           compute_dtype=torch.float32)


def rmsnorm_ref(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return RN.rmsnorm_plain(x, weight, eps)


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0) -> torch.Tensor:
    """Blockwise attention oracle: pre-scaled q [B, T, H, D] over k/v
    [B, S, Hkv, D], query i at position i, in float32 -> f32 [B, T, H, D]."""
    return FP.flash_prefill_attention_plain(q, k, v, causal=causal, window=window,
                                            policy=PrecisionPolicy(compute_dtype=torch.float32))
