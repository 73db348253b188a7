"""qwen1.5-110b [dense] — QKV bias, the largest dense config.

80L, d_model=8192, 64H (GQA kv=8), d_ff=49152, vocab=152064.
[hf:Qwen/Qwen1.5-0.5B family card]
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    arch_type="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    period=(ATTN,),
    qkv_bias=True,
    sub_quadratic=False,
    source="hf:Qwen/Qwen1.5-110B",
)
