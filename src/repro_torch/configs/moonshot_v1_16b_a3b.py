"""moonshot-v1-16b-a3b [MoE] — Moonlight-16B-A3B-style.

48L, d_model=2048, 16H (kv=16), per-expert d_ff=1408, vocab=163840,
MoE 64 experts top-6.  [hf:moonshotai/Moonlight-16B-A3B]
"""
from repro_torch.configs.base import LayerPattern, ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    arch_type="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,                    # per-expert
    vocab_size=163840,
    num_experts=64,
    experts_per_tok=6,
    period=(LayerPattern("attn", moe=True),),
    sub_quadratic=False,
    source="hf:moonshotai/Moonlight-16B-A3B",
)
