"""Combined quantization (paper §4.2, C1) — port of ``repro.core.quantization``.

Asymmetric weight quantization (paper Eq. 1) to int4 (clip [0, 15], two
unsigned nibbles per byte along the output axis) or int8 (clip [-128, 127])
with per-output-channel (optionally per-group) scale/zero; symmetric
per-row int8 activations; fp8 e4m3 KV values; the prequantized import
(``load_prequantized``, paper §3's adapter for GPTQ-style exports).  Every
integer carrier is bit-identical to the reference's (both round half to
even in float32).  The reference's ``abstract_quantized`` (a tree of
``ShapeDtypeStruct``s) has no counterpart: the dry run builds ``meta``
tensors (``runtime.plan.packed_layout``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

INT4_CLIP_MIN, INT4_CLIP_MAX = 0, 15
INT8_CLIP_MIN, INT8_CLIP_MAX = -128, 127

FP8_DTYPE = torch.float8_e4m3fn
FP8_MAX = 448.0


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Quantization policy for one model (paper's 'combined quantization')."""
    weight_bits: int = 4            # 4 or 8 (or 16 = no quant) for layer weights
    act_bits: int = 8               # 8 => WxA8 integer path, 16 => WxA16 float path
    lm_head_bits: int = 8           # paper: lm_head prioritized for int8
    kv_key_bits: int = 8            # int4/int8 keys
    kv_value_fp8: bool = True       # fp8 e4m3 values
    group_size: int = 0             # 0 => per-channel only
    embed_dtype: str = "bfloat16"   # embedding kept float (on Flash)

    def tag(self) -> str:
        return f"W{self.weight_bits}A{self.act_bits}"


@dataclasses.dataclass
class QuantizedTensor:
    """data: int8 carrier (bits=4: two nibbles per byte along the last
    axis); scale/zero: float32 [..., g, h] with w ~= scale * (q - zero);
    shape: the logical float shape."""
    data: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    bits: int
    shape: tuple

    @property
    def nbytes_logical(self) -> int:
        """Bytes of the logical weight at ``bits`` a value (the reference's
        count: scales and zeros not included)."""
        return int(np.prod(self.shape)) * self.bits // 8


def _clip_range(bits: int):
    if bits == 4:
        return INT4_CLIP_MIN, INT4_CLIP_MAX
    if bits == 8:
        return INT8_CLIP_MIN, INT8_CLIP_MAX
    raise ValueError(f"unsupported bits={bits}")


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack values 0..15 pairwise along the last axis: column 2j in the low
    nibble, column 2j+1 in the high nibble."""
    if q.shape[-1] % 2:
        raise ValueError(f"pack_int4 needs an even last axis, got {q.shape}")
    lo = q[..., 0::2].to(torch.uint8)
    hi = q[..., 1::2].to(torch.uint8)
    return (lo | (hi << 4)).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4 -> values 0..15 as int8."""
    p = packed.view(torch.uint8)
    lo = (p & 0x0F).to(torch.int8)
    hi = ((p >> 4) & 0x0F).to(torch.int8)
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1],
                                                 packed.shape[-1] * 2)


def quantize(w: torch.Tensor, bits: int, *, group_size: int = 0) -> QuantizedTensor:
    """Asymmetric quantization per Eq. 1 of a float weight [..., l, h]
    (reduction dim l, output channels last)."""
    *lead, l, h = w.shape
    cmin, cmax = _clip_range(bits)
    w = w.float()
    if group_size and group_size < l:
        if l % group_size:
            raise ValueError(f"group_size {group_size} does not divide {l}")
        wg = w.reshape(*lead, l // group_size, group_size, h)
    else:
        wg = w.reshape(*lead, 1, l, h)
    wmin = wg.amin(dim=-2, keepdim=True)
    wmax = wg.amax(dim=-2, keepdim=True)
    scale = (wmax - wmin) / (cmax - cmin)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.round((wg - wmin) / scale) + cmin
    q = torch.clamp(q, cmin, cmax)
    zero = cmin - wmin / scale
    q = q.reshape(*lead, l, h)
    data = pack_int4(q.to(torch.int32)) if bits == 4 else q.to(torch.int8)
    return QuantizedTensor(data=data, scale=scale.squeeze(-2).float(),
                           zero=zero.squeeze(-2).float(), bits=bits,
                           shape=(*lead, l, h))


def dequantize(qt: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """w = scale * (q - zero)."""
    q = unpack_int4(qt.data) if qt.bits == 4 else qt.data
    *lead, l, h = q.shape
    g = qt.scale.shape[-2]
    qf = q.reshape(*lead, g, l // g, h).float()
    w = qt.scale[..., :, None, :] * (qf - qt.zero[..., :, None, :])
    return w.reshape(*lead, l, h).to(dtype)


# The reference runs inside ``jax.jit``, where XLA rewrites a division by a
# constant as a multiplication by the constant's float32 reciprocal; the
# port multiplies by the same reciprocal so its carriers match bit for bit.
RECIP_127 = float(np.float32(1.0 / 127.0))


def quantize_activations(x: torch.Tensor):
    """Symmetric per-row int8 quantization over the last axis.  The scale
    ``amax / 127`` is taken in float32 and rounded to x's dtype, then cast
    to float32 (the reference's casts)."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scaled = (amax.float() * RECIP_127).to(amax.dtype)
    sx = torch.where(amax == 0, torch.ones_like(amax), scaled).float()
    xq = torch.clamp(torch.round(x.float() / sx), -127, 127).to(torch.int8)
    return xq, sx


def int_dot(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 dot of xq [..., K] with w [K, N].  Taken
    in float64, which is exact on every device here: |acc| <= 127 * 128 * K
    < 2**53 for any K this engine meets (CUDA has no integer matmul)."""
    return torch.matmul(xq.double(), w.double()).to(torch.int32)


def zero_correction(acc: torch.Tensor, zero: torch.Tensor,
                    rowsum: torch.Tensor) -> torch.Tensor:
    """acc - zero * rowsum in float32 with one rounding, as the compiled
    reference computes it (XLA contracts the pair into a fused
    multiply-add): the int32 operands go to float32 first, the product and
    difference are exact in float64."""
    return (acc.float().double() - zero.double() * rowsum.float().double()).float()


def quant_matmul(x: torch.Tensor, qt: QuantizedTensor, cfg: QuantConfig,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """y = x @ dequant(qt) on the configured path (reference op order):
    A8: y = scale * (xq @ qw - zero * rowsum(xq)) * sx;  A16 or group-wise
    scales: dequantize to bf16 and multiply with f32 accumulation."""
    if x.shape[-1] != qt.data.shape[-2]:
        raise ValueError(f"x {tuple(x.shape)} vs weight {tuple(qt.data.shape)}")
    if cfg.act_bits == 16 or qt.scale.shape[-2] > 1:
        w = dequantize(qt)
        return torch.matmul(x.to(torch.bfloat16).float(), w.float()).to(out_dtype)
    xq, sx = quantize_activations(x)
    qw = unpack_int4(qt.data) if qt.bits == 4 else qt.data
    acc = int_dot(xq, qw)
    rowsum = xq.to(torch.int32).sum(dim=-1, keepdim=True)
    scale = qt.scale[..., 0, :]
    zero = qt.zero[..., 0, :]
    y = scale * zero_correction(acc, zero, rowsum)
    y = y * sx
    return y.to(out_dtype)


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """Scale-free saturating fp8 e4m3 cast."""
    return torch.clamp(x.float(), -FP8_MAX, FP8_MAX).to(FP8_DTYPE)


def from_fp8(x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return x.to(dtype)


# ---------------------------------------------------------------------------
# Prequantized import (GPTQ-style adapter, paper §3)
# ---------------------------------------------------------------------------

def load_prequantized(qweight: np.ndarray, scales: np.ndarray,
                      zeros: np.ndarray, bits: int,
                      logical_shape: tuple) -> QuantizedTensor:
    """Adapter for externally quantized weights (e.g. GPTQ exports), the
    reference's: ``qweight`` already in this module's layout (int8 carrier,
    nibble pairs for 4 bits), scales and zeros per (group, channel) -- a 1-d
    pair is one group.  Returns CPU tensors (int8 data, float32 scale and
    zero); ``runtime.plan.pack_linear`` then gives the kernel's layout."""
    scale = torch.from_numpy(np.array(scales, dtype=np.float32))
    zero = torch.from_numpy(np.array(zeros, dtype=np.float32))
    if scale.dim() == 1:
        scale = scale[None, :]
        zero = zero[None, :]
    return QuantizedTensor(data=torch.from_numpy(np.array(qweight, dtype=np.int8)),
                           scale=scale, zero=zero, bits=bits,
                           shape=tuple(logical_shape))


def maybe_quantize(w: torch.Tensor, bits: int, group_size: int = 0):
    """Quantize unless bits >= 16 (then keep bf16)."""
    if bits >= 16:
        return w.to(torch.bfloat16)
    return quantize(w, bits, group_size=group_size)
