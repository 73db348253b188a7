"""Qwen2-7B — the paper's own primary evaluation model (Table 1).

28L, d_model=3584, 28H (GQA kv=4), d_ff=18944, vocab=151646.
[arXiv:2407.10671]
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    arch_type="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=151646,
    period=(ATTN,),
    qkv_bias=True,
    sub_quadratic=False,
    source="arXiv:2407.10671 (paper Table 1)",
)
