"""Qwen2-1.5B — paper evaluation model.  [arXiv:2407.10671]"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    arch_type="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151646,
    period=(ATTN,),
    qkv_bias=True,
    tie_embeddings=True,
    sub_quadratic=False,
    source="arXiv:2407.10671",
)
