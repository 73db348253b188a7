"""dbrx-132b [moe] — 16 experts top-4, fine-grained.

40L, d_model=6144, 48H (GQA kv=8), per-expert d_ff=10752, vocab=100352.
[hf:databricks/dbrx-base]
"""
from repro_torch.configs.base import LayerPattern, ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    arch_type="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    experts_per_tok=4,
    period=(LayerPattern("attn", moe=True),),
    sub_quadratic=False,
    source="hf:databricks/dbrx-base",
)
