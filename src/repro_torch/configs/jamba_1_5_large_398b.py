"""jamba-1.5-large-398b [hybrid] — Mamba + attention 1:7, MoE 16e top-2.

72L, d_model=8192, 64H (GQA kv=8), d_ff=24576, vocab=65536.
[arXiv:2403.19887]

Period of 8 layers: 1 attention + 7 mamba; MoE on every other layer
(odd indices).  72 = 9 full periods.  A mamba layer carries a conv tail
and an SSM state of fixed size; the attention layers' KV is paged as in
the dense decoders.
"""
from repro_torch.configs.base import LayerPattern, ModelConfig

_PERIOD = tuple(
    LayerPattern("attn" if i == 0 else "mamba", moe=(i % 2 == 1))
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    num_experts=16,
    experts_per_tok=2,
    period=_PERIOD,
    mamba_d_state=16,
    mamba_expand=2,
    sub_quadratic=True,
    source="arXiv:2403.19887",
)
