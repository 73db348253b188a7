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

    def param_count(self) -> dict:
        """Analytic parameter counts (the reference's Table-1 breakdown,
        term for term: ``training.train_loop.default_opt_for`` picks the
        optimizer from its total)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        qo = self.num_heads * hd
        kv = self.num_kv_heads * hd
        per_attn = d * qo + 2 * d * kv + qo * d   # q, k, v, o
        if self.qkv_bias:
            per_attn += qo + 2 * kv
        n_ff_mats = 3 if self.act == "swiglu" else 2
        per_dense_ffn = n_ff_mats * d * f
        per_moe_ffn = self.num_experts * n_ff_mats * d * f + d * self.num_experts
        d_inner = self.mamba_expand * d
        per_mamba = (2 * d * d_inner + d_inner * self.mamba_d_conv
                     + d_inner * (2 * self.mamba_d_state + 1) + d_inner * d)
        per_rwkv = 6 * d * d + 2 * d * 64
        layers = 0
        for patterns, count in self.layer_plan():
            for pat in patterns:
                if pat.kind == "attn":
                    layers += count * (per_attn + 2 * d)
                elif pat.kind == "mamba":
                    layers += count * (per_mamba + d)
                elif pat.kind == "rwkv":
                    layers += count * (per_rwkv + per_dense_ffn + 2 * d)
                if pat.kind != "rwkv":
                    layers += count * (per_moe_ffn if pat.moe else per_dense_ffn)
        embedding = v * d
        lm_head = 0 if self.tie_embeddings else v * d
        enc = 0
        if self.encoder_layers:
            enc = self.encoder_layers * (per_attn + per_dense_ffn + 2 * d)
            layers += self.num_layers * (d * qo + 2 * d * kv + qo * d)   # cross attention
        return {"embedding": embedding, "layers": layers + enc,
                "lm_head": lm_head, "total": embedding + lm_head + layers + enc}

    def active_param_count(self) -> int:
        """Parameters a token passes through (the embedding excluded; an MoE
        layer counted with ``experts_per_tok`` experts): the reference's N in
        MODEL_FLOPS = 6 * N_active * D."""
        if not self.num_experts:
            return self.param_count()["total"] - self.param_count()["embedding"]
        pc = dataclasses.replace(self, num_experts=self.experts_per_tok).param_count()
        return pc["total"] - pc["embedding"]


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One step the dry run sizes: ``kind`` train | prefill | decode, over
    ``global_batch`` sequences of ``seq_len`` tokens (decode: a cache of
    ``seq_len`` slots and one new token a sequence)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
