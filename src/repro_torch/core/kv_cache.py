"""Quantized KV values (paper §4.2, Fig. 3) — the parts of
``repro.core.kv_cache`` the paged pool uses.

Keys are asymmetric int8 per (token, head) over head_dim (the fixed
reduction dim, so appends never disturb old scales); values are a
saturating fp8 e4m3 cast."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import quantization as q


def quantize_keys(k: torch.Tensor, bits: int = 8):
    """-> (kq int8 [..., D] (bits=4: nibble pairs), scale f32 [...],
    zero f32 [...]).  Op for op the reference's float32 math."""
    kmin = k.amin(dim=-1).float()
    kmax = k.amax(dim=-1).float()
    # (kmax - kmin) / levels, as XLA computes it under jit: times the
    # float32 reciprocal of the constant
    recip = float(np.float32(1.0 / (15.0 if bits == 4 else 255.0)))
    lo = 0.0 if bits == 4 else -128.0
    hi = 15.0 if bits == 4 else 127.0
    scale = (kmax - kmin) * recip
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    zero = lo - kmin / scale
    kq = torch.round(k.float() / scale[..., None] + zero[..., None])
    kq = torch.clamp(kq, lo, hi).to(torch.int8)
    if bits == 4:
        kq = q.pack_int4(kq)
    return kq, scale, zero


def dequantize_keys(kq: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                    dtype=torch.bfloat16, bits: int = 8) -> torch.Tensor:
    if bits == 4:
        kq = q.unpack_int4(kq)
    return ((kq.float() - zero[..., None]) * scale[..., None]).to(dtype)


def cast_values(v_new: torch.Tensor, dtype) -> torch.Tensor:
    """Saturating fp8 conversion for e4m3 pools, plain cast otherwise."""
    if dtype == q.FP8_DTYPE:
        return q.to_fp8(v_new)
    return v_new.to(dtype)
