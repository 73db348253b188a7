"""Architecture registry: ``<arch>`` / ``<arch>@<variant>`` lookup.

The port serves the paper's three dense decoders, glm4-9b (a dense decoder
with 16 query heads per KV head), qwen1.5-110b (the largest dense config,
with the qkv bias), gemma3-27b (five sliding-window layers to each global
one, gelu FFN), three MoE decoders (moonshot-v1-16b-a3b, grok-1-314b and
dbrx-132b, whose ``@tiny-moe`` variant -- GQA with two key/value heads, 8
experts at top-2 -- is the expert-streaming test model) and two recurrent
stacks: rwkv6-7b (attention-free) and jamba-1.5-large-398b (one attention
layer to seven mamba layers, MoE on every other layer), the
encoder-decoder seamless-m4t-large-v2 (24 bidirectional encoder layers over
precomputed frame embeddings, 24 decoder layers with cross attention) and
qwen2-vl-2b (M-RoPE: three-axis position ids over per-axis rotary
sections).
``reduced``, ``tiny`` and ``tiny_moe`` are copies of the reference
transforms (only the branches these configs reach)."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import (dbrx_132b, gemma3_27b, glm4_9b, grok_1_314b,
                                 jamba_1_5_large_398b, llama3_8b,
                                 moonshot_v1_16b_a3b, qwen1_5_110b, qwen2_1_5b,
                                 qwen2_7b, qwen2_vl_2b, rwkv6_7b,
                                 seamless_m4t_large_v2)
from repro_torch.configs.base import ATTN, LayerPattern, ModelConfig

# the architectures the dry run sizes (the reference's ASSIGNED)
ASSIGNED: Dict[str, ModelConfig] = {
    "seamless-m4t-large-v2": seamless_m4t_large_v2.CONFIG,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b.CONFIG,
    "glm4-9b": glm4_9b.CONFIG,
    "rwkv6-7b": rwkv6_7b.CONFIG,
    "dbrx-132b": dbrx_132b.CONFIG,
    "grok-1-314b": grok_1_314b.CONFIG,
    "qwen1.5-110b": qwen1_5_110b.CONFIG,
    "jamba-1.5-large-398b": jamba_1_5_large_398b.CONFIG,
    "gemma3-27b": gemma3_27b.CONFIG,
    "qwen2-vl-2b": qwen2_vl_2b.CONFIG,
}

PAPER_MODELS = {
    "qwen2-7b": qwen2_7b.CONFIG,
    "qwen2-1.5b": qwen2_1_5b.CONFIG,
    "llama3-8b": llama3_8b.CONFIG,
}

ARCHS: Dict[str, ModelConfig] = {**ASSIGNED, **PAPER_MODELS}

VARIANTS = ("reduced", "tiny", "tiny-moe")


def get(arch: str) -> ModelConfig:
    """Look up ``<arch>`` or ``<arch>@<variant>``."""
    base, _, variant = arch.partition("@")
    if base not in ARCHS:
        raise KeyError(f"unknown arch {base!r}; known: {sorted(ARCHS)}")
    cfg = ARCHS[base]
    if not variant:
        return cfg
    if variant == "reduced":
        return reduced(cfg)
    if variant == "tiny":
        return tiny(cfg)
    if variant == "tiny-moe":
        return tiny_moe(cfg)
    raise KeyError(f"unknown variant {variant!r} for {base!r}; "
                   f"known: {VARIANTS}")


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Same-family smoke variant: 2 layers, d_model 256 (rwkv: 128), head_dim
    64, d_ff 512, vocab 512; gemma3 keeps one local layer (window 16) and
    one global layer, jamba one attention layer and one mamba+MoE layer; an
    encoder-decoder keeps 2 encoder layers, M-RoPE the sections (8, 12, 12)
    of head_dim 64."""
    d_model = 128 if cfg.period[0].kind == "rwkv" else 256
    head_dim = 64
    num_heads = max(2, d_model // head_dim)
    num_kv = min(cfg.num_kv_heads, num_heads)
    if num_heads % num_kv:
        num_kv = 1
    period = cfg.period
    if cfg.name.startswith("gemma3"):
        period = (LayerPattern("attn", window=16), ATTN)   # one local + one global
    if cfg.name.startswith("jamba"):
        period = (LayerPattern("attn"), LayerPattern("mamba", moe=True))
    num_layers = min(len(period), 2) if len(period) > 1 else 2
    sections = (8, 12, 12) if cfg.rope_kind == "mrope" else cfg.mrope_sections
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        num_layers=num_layers,
        encoder_layers=2 if cfg.encoder_layers else 0,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=head_dim,
        d_ff=512,
        vocab_size=512,
        num_experts=min(cfg.num_experts, 4),
        experts_per_tok=min(cfg.experts_per_tok, 2),
        period=period,
        mrope_sections=sections,
        rwkv_head_dim=64,
    )


def tiny(cfg: ModelConfig) -> ModelConfig:
    """Scaled-down variant that keeps >= 6 layer groups and GQA.  jamba: 3
    periods and a 2-layer tail (attention, mamba+MoE); rwkv6: the period
    doubled over 7 layers -- two stacks, both recurrent, either way.  M-RoPE
    keeps the sections (8, 12, 12) of head_dim 64."""
    sections = (8, 12, 12) if cfg.rope_kind == "mrope" else cfg.mrope_sections
    num_layers = max(6, 3 * len(cfg.period))
    period = cfg.period
    if cfg.name.startswith("jamba"):
        num_layers = 3 * len(cfg.period) + 2
    if cfg.name.startswith("rwkv6"):
        period = cfg.period * 2
        num_layers = 7
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-tiny",
        period=period,
        num_layers=num_layers,
        encoder_layers=2 if cfg.encoder_layers else 0,
        d_model=256,
        num_heads=4,
        num_kv_heads=2 if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        num_experts=min(cfg.num_experts, 4),
        experts_per_tok=min(cfg.experts_per_tok, 2),
        mrope_sections=sections,
        rwkv_head_dim=64,
    )


def tiny_moe(cfg: ModelConfig) -> ModelConfig:
    """``tiny`` with 8 experts at top-2 routing (MoE architectures only)."""
    if not cfg.num_experts:
        raise KeyError(f"{cfg.name!r} has no MoE layers; "
                       "@tiny-moe needs an MoE architecture")
    return dataclasses.replace(tiny(cfg), name=cfg.name + "-tiny-moe",
                               num_experts=8, experts_per_tok=2)
