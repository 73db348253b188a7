"""Model assembly for serving — port of the paged serving path of
``repro.models.transformer``: parameters, the paged decode state, one
prompt chunk into the pool (``prefill_chunk_paged``) and one bucketed
decode step (``decode_step_bucketed``).

Parameters keep the reference's tree: ``{"stacks": (stack, ...),
"final_norm", "lm_head"}`` where each stack is a tuple with one dict per
period pattern whose leaves are stacked on a leading [count] axis.  Layers
run as a Python loop over that axis (the reference scans it).  The decode
state's page pools are updated in place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import LayerPattern, ModelConfig
from repro_torch.core import kv_pool as KP
from repro_torch.core.precision import DEFAULT_POLICY, PrecisionPolicy
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.runtime import dispatch as D
from repro_torch.runtime import plan as RP


def _check_supported(cfg: ModelConfig) -> None:
    for patterns, _count in cfg.layer_plan():
        for pat in patterns:
            if pat.kind != "attn" or pat.window or pat.moe:
                raise NotImplementedError(
                    f"{cfg.name}: layer {pat} is not ported (the port serves "
                    "dense full-attention decoders; ROADMAP queue 1 items 12-14)")
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are not "
                                  "ported (ROADMAP queue 1 item 15)")


def _pattern_params(b: L.ParamBuilder, cfg: ModelConfig, count: int) -> dict:
    lead = (count,)
    return {"ln1": b.norm(cfg.d_model, lead),
            "attn": A.attn_params(b, cfg, lead),
            "ln2": b.norm(cfg.d_model, lead),
            "ffn": L.ffn_params(b, cfg, lead)}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device) -> dict:
    """Quantized serving parameters built directly on ``device`` in the
    packed kernel-native layout (the reference's ``init_params(...,
    quantized=True, pack=True)``).  The embedding is not part of the tree:
    it lives on Flash (``serving.engine.build_engine``)."""
    _check_supported(cfg)
    b = L.ParamBuilder(generator, device, cfg.quant)
    stacks = tuple(tuple(_pattern_params(b, cfg, count) for _ in patterns)
                   for patterns, count in cfg.layer_plan())
    return {"stacks": stacks,
            "final_norm": b.norm(cfg.d_model),
            "lm_head": b.linear(cfg.d_model, cfg.padded_vocab_size,
                                bits=cfg.quant.lm_head_bits)}


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, RP.PackedLinear):
        return tree.layer(i)
    return tree[i]


# ===========================================================================
# Decode state
# ===========================================================================

def init_paged_cache(cfg: ModelConfig, batch: int, geom: KP.PoolGeometry,
                     device: torch.device) -> dict:
    """Paged decode state: one stacked page pool per attention pattern, the
    per-row positions ``pos`` [batch] and the shared page table
    [batch, pages_per_row], all-trash until the host allocator hands out
    pages."""
    _check_supported(cfg)
    stacks = tuple(
        tuple(KP.init_paged_layer(geom, cfg.num_kv_heads, cfg.resolved_head_dim,
                                  layers=count, key_bits=cfg.quant.kv_key_bits,
                                  value_fp8=cfg.quant.kv_value_fp8, device=device)
              for _ in patterns)
        for patterns, count in cfg.layer_plan())
    return {"stacks": stacks,
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "table": torch.full((batch, geom.pages_per_row), geom.trash_page,
                                dtype=torch.int32, device=device)}


def free_slots(cache: dict, rows) -> dict:
    """Reset finished rows' positions to zero (in place).  The KV
    bytes stay; per-row masks make them unreachable."""
    cache["pos"][torch.as_tensor(rows, dtype=torch.long)] = 0
    return cache


# ===========================================================================
# Forward passes
# ===========================================================================

def _apply_layer(x: torch.Tensor, pp: dict, cfg: ModelConfig, pat: LayerPattern,
                 mode: str, positions: torch.Tensor, pool: KP.PagedLayerKV,
                 pos, table: torch.Tensor, dispatch: D.Dispatcher,
                 policy: PrecisionPolicy) -> torch.Tensor:
    h = L.rms_norm(x, pp["ln1"], cfg.rms_eps, dispatch)
    if mode == "prefill_paged":
        att = A.attention_prefill_paged(h, pp["attn"], cfg, pat, pool, table,
                                        positions, pos, dispatch, policy)
    else:
        att = A.attention_decode_paged(h, pp["attn"], cfg, pat, pool, table, pos,
                                       positions, dispatch, policy)
    x = x + att
    h2 = L.rms_norm(x, pp["ln2"], cfg.rms_eps, dispatch)
    return x + L.apply_ffn(h2, pp["ffn"], cfg, dispatch)


def _run_stacks(x: torch.Tensor, params: dict, cfg: ModelConfig, mode: str,
                positions: torch.Tensor, cache: dict, pos, table: torch.Tensor,
                dispatch: D.Dispatcher, policy: PrecisionPolicy = DEFAULT_POLICY,
                collect: Optional[list] = None) -> torch.Tensor:
    """Every layer in order.  ``mode`` "prefill_paged": ``pos`` is the
    chunk's first position and ``table`` the row's [pages_per_row] table;
    "decode": ``pos`` [B] per-row positions and ``table`` [B,
    pages_per_row].  ``collect``: if a list, each layer's output hidden
    state is appended (parity tests)."""
    for si, (patterns, count) in enumerate(cfg.layer_plan()):
        sp = params["stacks"][si]
        for li in range(count):
            for pi, pat in enumerate(patterns):
                x = _apply_layer(x, layer_slice(sp[pi], li), cfg, pat, mode,
                                 positions, cache["stacks"][si][pi].layer(li),
                                 pos, table, dispatch, policy)
                if collect is not None:
                    collect.append(x)
    return x


def _logits(x: torch.Tensor, params: dict, cfg: ModelConfig,
            dispatch: D.Dispatcher) -> torch.Tensor:
    h = L.rms_norm(x, params["final_norm"], cfg.rms_eps, dispatch)
    return L.apply_linear(h, params["lm_head"], cfg.quant, dispatch,
                          out_dtype=torch.float32)


def prefill_chunk_paged(params: dict, cfg: ModelConfig, embeds: torch.Tensor,
                        cache: dict, slot: int, pos0: int, last_idx: int,
                        dispatch: D.Dispatcher,
                        policy: PrecisionPolicy = DEFAULT_POLICY,
                        collect: Optional[list] = None) -> torch.Tensor:
    """One prompt chunk for decode row ``slot`` written straight into the
    pool.  embeds [1, C, d] at absolute positions [pos0, pos0 + C); a
    padded final chunk's keys land in causally dead positions or the trash
    page.  Returns the logits [1, V] of chunk-local index ``last_idx``.
    The caller advances ``cache["pos"]`` once the whole prompt is in."""
    x = embeds.to(torch.bfloat16)
    B, C = x.shape[:2]
    if B != 1:
        raise ValueError("prompt chunks are per-row")
    positions = (int(pos0) + torch.arange(C, device=x.device,
                                          dtype=torch.int32))[None]
    x = _run_stacks(x, params, cfg, "prefill_paged", positions, cache, int(pos0),
                    cache["table"][slot], dispatch, policy, collect)
    last = x[:, int(last_idx):int(last_idx) + 1]
    return _logits(last, params, cfg, dispatch)[:, 0]


def decode_step_bucketed(params: dict, cfg: ModelConfig, embeds: torch.Tensor,
                         cache: dict, slot_idx: torch.Tensor, dispatch: D.Dispatcher,
                         active: Optional[torch.Tensor] = None,
                         policy: PrecisionPolicy = DEFAULT_POLICY,
                         collect: Optional[list] = None
                         ) -> Tuple[torch.Tensor, dict]:
    """One decode step over a bucket of rows gathered from the slot set:
    embeds [b, 1, d]; ``slot_idx`` [b] names each bucket row's slot (pad
    rows are distinct idle slots, masked by ``active`` [b] and routed to the
    trash page by their all-trash table rows).  Only ``pos`` and the table
    are gathered — the pool is physical-page addressed and never moves.
    Returns (logits [b, V] in bucket order, cache with ``pos`` advanced for
    the active rows)."""
    x = embeds.to(torch.bfloat16)
    b, T = x.shape[:2]
    idx = slot_idx.long()
    pos = cache["pos"][idx]
    positions = pos[:, None] + torch.arange(T, device=x.device, dtype=pos.dtype)[None]
    x = _run_stacks(x, params, cfg, "decode", positions, cache, pos,
                    cache["table"][idx], dispatch, policy, collect)
    stepped = pos + T if active is None else torch.where(active, pos + T, pos)
    cache["pos"][idx] = stepped
    return _logits(x, params, cfg, dispatch)[:, -1], cache
