"""Mixed float precision policy (paper §5.3, C5) — port of
``repro.core.precision``: low-precision compute with float32 accumulation,
float32 softmax, and the 1/sqrt(d_k) attention scale applied to the query
before Q.K^T, which keeps a half-precision Q.K^T under fp16's 65504
ceiling (``UNSAFE_FP16_POLICY`` shows the overflow it avoids).

PyTorch has no ``preferred_element_type``: ``matmul`` and
``attention_scores`` accumulate in ``accum_dtype`` by casting the operands
to it after rounding them to ``compute_dtype``.  Float32 products on the
card run with TF32 off (PyTorch's default,
``torch.backends.cuda.matmul.allow_tf32 = False``, which the port never
changes), so a float32 accumulation is a float32 product, as the
reference's."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    compute_dtype: torch.dtype = torch.bfloat16
    accum_dtype: torch.dtype = torch.float32
    softmax_dtype: torch.dtype = torch.float32
    prescale_query: bool = True

    def cast_in(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)


DEFAULT_POLICY = PrecisionPolicy()
# fp16 with the scale applied after Q.K^T: the overflow the paper's
# prescaling avoids
UNSAFE_FP16_POLICY = PrecisionPolicy(compute_dtype=torch.float16,
                                     accum_dtype=torch.float16,
                                     softmax_dtype=torch.float16,
                                     prescale_query=False)


def _accum(x: torch.Tensor, policy: PrecisionPolicy) -> torch.Tensor:
    """x rounded to the compute dtype, then carried in the accumulation's."""
    return x.to(policy.compute_dtype).to(policy.accum_dtype)


def matmul(a: torch.Tensor, b: torch.Tensor,
           policy: PrecisionPolicy = DEFAULT_POLICY) -> torch.Tensor:
    return torch.matmul(_accum(a, policy), _accum(b, policy))


def softmax(x: torch.Tensor, axis: int = -1,
            policy: PrecisionPolicy = DEFAULT_POLICY) -> torch.Tensor:
    return torch.softmax(x.to(policy.softmax_dtype), dim=axis)


def attention_scores(q: torch.Tensor, k: torch.Tensor, d_k: int,
                     policy: PrecisionPolicy = DEFAULT_POLICY) -> torch.Tensor:
    """Q.K^T with the paper's pre-scaling. q: [..., T, D], k: [..., S, D].
    The scale is a float32 scalar, so the pre-scaled product is taken in
    float32 before its cast to the compute dtype (the reference's type
    promotion)."""
    scale = 1.0 / torch.sqrt(torch.tensor(d_k, dtype=torch.float32, device=q.device))
    if policy.prescale_query:
        q = (q.to(policy.accum_dtype).float() * scale).to(policy.compute_dtype)
        return torch.einsum("...td,...sd->...ts", q.to(policy.accum_dtype),
                            _accum(k, policy))
    s = torch.einsum("...td,...sd->...ts", _accum(q, policy), _accum(k, policy))
    return s * scale.to(s.dtype)
