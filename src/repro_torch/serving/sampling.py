"""Token sampling: greedy / temperature / top-k / top-p — port of
``repro.serving.sampling``.  Pad-vocab slots are masked to -inf first.

Greedy decoding (the parity path) is an argmax and picks the first maximal
index, as ``jnp.argmax`` does.  Stochastic sampling draws from an explicit
``torch.Generator``; it cannot reproduce ``jax.random``'s bits, so it
matches the reference in distribution only.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0         # 0 => greedy
    top_k: int = 0                   # 0 => off
    top_p: float = 1.0               # 1 => off
    max_new_tokens: int = 32
    eos_token: int = -1              # -1 => never stops early


def mask_pad_vocab(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    V = logits.shape[-1]
    if V == vocab_size:
        return logits
    idx = torch.arange(V, device=logits.device)
    return torch.where(idx[None, :] < vocab_size, logits,
                       torch.full_like(logits, float("-inf")))


def sample(logits: torch.Tensor, params: SamplingParams, vocab_size: int,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits [B, V] float32 -> token ids [B] (int64)."""
    logits = mask_pad_vocab(logits, vocab_size)
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / params.temperature
    neg_inf = torch.full_like(logits, float("-inf"))
    if params.top_k:
        kth = torch.topk(logits, params.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if params.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < params.top_p).sum(dim=-1, keepdim=True)
        cutoff_idx = cutoff_idx.clamp(max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, neg_inf, logits)
    if generator is None:
        raise ValueError("stochastic sampling needs a torch.Generator")
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
