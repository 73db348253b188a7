"""Mixed float precision policy (paper §5.3, C5) — port of
``repro.core.precision``: low-precision compute with float32 accumulation,
float32 softmax, and the 1/sqrt(d_k) attention scale applied to the query
before Q.K^T."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    compute_dtype: torch.dtype = torch.bfloat16
    accum_dtype: torch.dtype = torch.float32
    softmax_dtype: torch.dtype = torch.float32
    prescale_query: bool = True


DEFAULT_POLICY = PrecisionPolicy()
