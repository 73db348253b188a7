"""rwkv6-7b [ssm] — Finch: attention-free, data-dependent decay.

32L, d_model=4096, d_ff=14336, vocab=65536.  [arXiv:2404.05892]

No KV cache: each layer carries a recurrent state (token shifts and a
64 x 64 wkv matrix a head), so the paper's KV-cache quantization does not
apply; weight quantization and the Flash embedding do.
"""
from repro_torch.configs.base import LayerPattern, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    arch_type="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,              # wkv heads = d_model / rwkv_head_dim
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    period=(LayerPattern("rwkv"),),
    rope_kind="none",
    rwkv_head_dim=64,
    sub_quadratic=True,
    source="arXiv:2404.05892",
)
