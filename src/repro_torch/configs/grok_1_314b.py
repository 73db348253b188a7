"""grok-1-314b [moe] — 8 experts top-2.

64L, d_model=6144, 48H (GQA kv=8), d_ff=32768, vocab=131072.
[hf:xai-org/grok-1]

``act`` says gelu, but every layer is an MoE layer, and the MoE FFN runs
swiglu whatever ``act`` says (as in the reference).
"""
from repro_torch.configs.base import LayerPattern, ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    arch_type="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    num_experts=8,
    experts_per_tok=2,
    period=(LayerPattern("attn", moe=True),),
    act="gelu",
    sub_quadratic=False,
    source="hf:xai-org/grok-1",
)
