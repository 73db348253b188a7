"""seamless-m4t-large-v2 [audio] — enc-dec multimodal backbone.

24 encoder + 24 decoder layers, d_model=1024, 16H (GQA kv=16), d_ff=8192,
vocab=256206.  [arXiv:2308.11596]

Backbone only: the mel-spectrogram + conformer feature frontend is a stub —
callers hand the encoder precomputed frame embeddings (B, S, d).
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    arch_type="audio",
    num_layers=24,
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    period=(ATTN,),
    act="gelu",
    rope_kind="rope",
    frontend="audio",
    sub_quadratic=False,
    source="arXiv:2308.11596",
)
