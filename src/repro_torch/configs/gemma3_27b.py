"""gemma3-27b [dense] — 5:1 local:global attention, gelu FFN.

62L, d_model=5376, 32H (GQA kv=16), d_ff=21504, vocab=262144,
head_dim=128 (model card).  [hf:google/gemma-3-27b-pt family]

Period of 6: 5 sliding-window (1024) local layers + 1 global layer.
62 = 10 periods + 2 tail local layers.  The local layers keep their KV in
rings of the window's size, which bounds their KV memory.
"""
from repro_torch.configs.base import LayerPattern, ModelConfig

_LOCAL = LayerPattern("attn", window=1024)
_GLOBAL = LayerPattern("attn")

CONFIG = ModelConfig(
    name="gemma3-27b",
    arch_type="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    period=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    rope_theta=1_000_000.0,
    act="gelu",
    sub_quadratic=True,
    source="hf:google/gemma-3-1b-pt",
)
