"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution.

28L, d_model=1536, 12H (GQA kv=2), d_ff=8960, vocab=151936.
[arXiv:2409.12191]

Backbone only: the ViT vision encoder + projector frontend is a stub —
callers merge pre-projected patch embeddings into the token stream;
M-RoPE consumes (t, h, w) position ids.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    arch_type="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    period=(ATTN,),
    rope_kind="mrope",
    mrope_sections=(16, 24, 24),
    qkv_bias=True,
    frontend="vision",
    sub_quadratic=False,
    source="arXiv:2409.12191",
)
