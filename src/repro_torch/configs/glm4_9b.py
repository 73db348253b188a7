"""glm4-9b [dense] — RoPE, extreme GQA (kv=2): 16 query heads per KV head.

40L, d_model=4096, 32H (GQA kv=2), d_ff=13696, vocab=151552.
[hf:THUDM/glm-4-9b]
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    arch_type="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    period=(ATTN,),
    sub_quadratic=False,
    source="hf:THUDM/glm-4-9b",
)
