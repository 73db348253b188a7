"""Model/config dataclasses — the port's copy of ``repro.configs.base``.

Field names, defaults and derived properties match the reference, so a
config compares equal field by field; ``QuantConfig`` comes from the
port's own ``core.quantization``."""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.quantization import QuantConfig


@dataclasses.dataclass(frozen=True)
class LayerPattern:
    """One element of the layer period.  kind: "attn" | "mamba" | "rwkv";
    window: sliding-window size for attn (0 = full/causal); moe: the FFN is
    a mixture of experts."""
    kind: str = "attn"
    window: int = 0
    moe: bool = False


ATTN = LayerPattern("attn")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 => d_model // num_heads
    period: Tuple[LayerPattern, ...] = (ATTN,)
    num_experts: int = 0
    experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    encoder_layers: int = 0
    rope_kind: str = "rope"
    rope_theta: float = 1_000_000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    qkv_bias: bool = False
    rwkv_head_dim: int = 64
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    rms_eps: float = 1e-5
    act: str = "swiglu"
    tie_embeddings: bool = False
    frontend: str = "none"
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    sub_quadratic: bool = False
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab_size(self) -> int:
        """Vocab padded to a multiple of 256 (sampling masks the pad)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def layer_plan(self) -> Tuple[Tuple[Tuple[LayerPattern, ...], int], ...]:
        """(period_patterns, repeat_count) stacks in layer order: full
        periods first, then the tail."""
        p = len(self.period)
        full, tail = divmod(self.num_layers, p)
        plan = []
        if full:
            plan.append((self.period, full))
        if tail:
            plan.append((self.period[:tail], 1))
        return tuple(plan)
