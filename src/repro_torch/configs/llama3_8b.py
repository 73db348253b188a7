"""Llama3-8B — paper evaluation model.  [hf:meta-llama/Meta-Llama-3-8B]"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    period=(ATTN,),
    rope_theta=500_000.0,
    sub_quadratic=False,
    source="hf:meta-llama/Meta-Llama-3-8B",
)
