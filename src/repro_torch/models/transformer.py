"""Model assembly for serving — port of the serving paths of
``repro.models.transformer``: parameters (dense or MoE FFN), the two decode
states — dense per-sequence caches (``init_cache``, ``prefill``,
``decode_step``: the slot-synchronous ``Engine.generate``) and the paged
pool (``init_paged_cache``, ``prefill_chunk_paged``, ``decode_step`` /
``decode_step_bucketed``: the ``EngineLoop``).

Parameters keep the reference's tree: ``{"stacks": (stack, ...),
"final_norm", "lm_head"}`` where each stack is a tuple with one dict per
period pattern whose leaves are stacked on a leading [count] axis.  Layers
run as a Python loop over that axis (the reference scans it).  Caches and
page pools are updated in place.

A stack streamed from Flash runs one layer group at a time out of a ring
slot's parameter tree (``run_stack_group``); the paged steps take the
caller's stack runner for that (``run_stacks``).

Every step takes ``lora`` (multi-LoRA, C7): the adapter tables and one
adapter id per batch row, carried to every layer's q/v projections as the
reference's ``StepCtx.lora`` is.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs.base import LayerPattern, ModelConfig
from repro_torch.core import kv_cache as kvc
from repro_torch.core import kv_pool as KP
from repro_torch.core.precision import DEFAULT_POLICY, PrecisionPolicy
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.runtime import dispatch as D
from repro_torch.runtime import plan as RP


def _check_supported(cfg: ModelConfig) -> None:
    for patterns, _count in cfg.layer_plan():
        for pat in patterns:
            if pat.kind != "attn" or pat.window:
                raise NotImplementedError(
                    f"{cfg.name}: layer {pat} is not ported (the port serves "
                    "full-attention decoders; ROADMAP queue 1 items 13-14)")
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are not "
                                  "ported (ROADMAP queue 1 item 15)")


def _pattern_params(b: L.ParamBuilder, cfg: ModelConfig, pat: LayerPattern,
                    count: int) -> dict:
    lead = (count,)
    p = {"ln1": b.norm(cfg.d_model, lead),
         "attn": A.attn_params(b, cfg, lead),
         "ln2": b.norm(cfg.d_model, lead)}
    if pat.moe:
        p["moe"] = M.moe_params(b, cfg, lead)
    else:
        p["ffn"] = L.ffn_params(b, cfg, lead)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device) -> dict:
    """Quantized serving parameters built directly on ``device`` in the
    packed kernel-native layout (the reference's ``init_params(...,
    quantized=True, pack=True)``).  The embedding is not part of the tree:
    it lives on Flash (``serving.engine.build_engine``)."""
    _check_supported(cfg)
    b = L.ParamBuilder(generator, device, cfg.quant)
    stacks = tuple(tuple(_pattern_params(b, cfg, pat, count) for pat in patterns)
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

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device: torch.device = torch.device("cpu")) -> dict:
    """Dense decode state: one stacked ``LayerKVCache`` per attention
    pattern and ``pos``, one scalar position for every row (the
    slot-synchronous path)."""
    _check_supported(cfg)
    stacks = tuple(
        tuple(kvc.init_layer_cache(batch, max_seq, cfg.num_kv_heads,
                                   cfg.resolved_head_dim,
                                   key_bits=cfg.quant.kv_key_bits,
                                   value_fp8=cfg.quant.kv_value_fp8,
                                   layers=count, device=device)
              for _ in patterns)
        for patterns, count in cfg.layer_plan())
    return {"stacks": stacks,
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


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
    """Reset finished rows' positions to zero (in place), one fill a row:
    an index tensor from the host would be a copy the host waits for.  The
    KV bytes stay; per-row masks make them unreachable."""
    for r in rows:
        cache["pos"][int(r)].fill_(0)
    return cache


# ===========================================================================
# Forward passes
# ===========================================================================

def _apply_layer(x: torch.Tensor, pp: dict, cfg: ModelConfig, pat: LayerPattern,
                 mode: str, positions: torch.Tensor, cache, pos, table,
                 dispatch: D.Dispatcher, policy: PrecisionPolicy,
                 collect: Optional[dict] = None, lora: Optional[dict] = None):
    """One layer.  ``cache`` is this layer's ``PagedLayerKV`` (modes
    "prefill_paged" and "decode") or ``LayerKVCache`` ("prefill" and
    "decode").  ``collect``: an MoE layer's router ids (``apply_moe``).
    Returns (x, the layer's cache after the step)."""
    h = L.rms_norm(x, pp["ln1"], cfg.rms_eps, dispatch)
    if mode == "prefill_paged":
        att = A.attention_prefill_paged(h, pp["attn"], cfg, pat, cache, table,
                                        positions, pos, dispatch, policy, lora)
    elif mode == "prefill":
        att, cache = A.attention_prefill(h, pp["attn"], cfg, pat, positions, cache,
                                         dispatch, policy, lora)
    elif isinstance(cache, KP.PagedLayerKV):
        att = A.attention_decode_paged(h, pp["attn"], cfg, pat, cache, table, pos,
                                       positions, dispatch, policy, lora)
    else:
        att, cache = A.attention_decode(h, pp["attn"], cfg, pat, cache, pos,
                                        positions, dispatch, policy, lora)
    x = x + att
    h2 = L.rms_norm(x, pp["ln2"], cfg.rms_eps, dispatch)
    if pat.moe:
        # serving sizes expert capacity to the worst case: no token drops
        y, _aux = M.apply_moe(h2, pp["moe"], cfg, dispatch=dispatch,
                              full_capacity=True, collect=collect)
    else:
        y = L.apply_ffn(h2, pp["ffn"], cfg, dispatch)
    return x + y, cache


def _run_stacks(x: torch.Tensor, params: dict, cfg: ModelConfig, mode: str,
                positions: torch.Tensor, cache: dict, pos, table,
                dispatch: D.Dispatcher, policy: PrecisionPolicy = DEFAULT_POLICY,
                collect: Optional[list] = None,
                lora: Optional[dict] = None) -> torch.Tensor:
    """Every layer in order.  ``mode`` "prefill_paged": ``pos`` is the
    chunk's first position and ``table`` the row's [pages_per_row] table;
    "prefill": the dense caches are empty and fill from position 0;
    "decode": ``pos`` the per-row positions [B] (or, on dense caches, one
    scalar) and ``table`` [B, pages_per_row] (None for dense caches).
    Caches are written in place; dense caches get their per-layer lengths
    stacked back.  ``collect``: if a list, each layer's output hidden
    state is appended (parity tests)."""
    stacks = []
    for si, (patterns, count) in enumerate(cfg.layer_plan()):
        sp = params["stacks"][si]
        lengths = [[] for _ in patterns]
        for li in range(count):
            for pi, pat in enumerate(patterns):
                x, new = _apply_layer(x, layer_slice(sp[pi], li), cfg, pat, mode,
                                      positions, cache["stacks"][si][pi].layer(li),
                                      pos, table, dispatch, policy, lora=lora)
                if isinstance(new, kvc.LayerKVCache):
                    lengths[pi].append(new.length)
                if collect is not None:
                    collect.append(x)
        stacks.append(tuple(
            dataclasses.replace(c, length=torch.stack(lens)) if lens else c
            for c, lens in zip(cache["stacks"][si], lengths)))
    cache["stacks"] = tuple(stacks)
    return x


def run_stack_group(gp: tuple, cfg: ModelConfig, stack_idx: int, mode: str,
                    x: torch.Tensor, positions: torch.Tensor, cache: dict,
                    group: int, pos, table, dispatch: D.Dispatcher,
                    policy: PrecisionPolicy = DEFAULT_POLICY,
                    collect: Optional[dict] = None,
                    lora: Optional[dict] = None) -> torch.Tensor:
    """ONE layer group of one stack on the paged pool (modes "decode" and
    "prefill_paged", arguments as ``_run_stacks``'s): ``gp`` is the group's
    parameter tree (one dict per period pattern, no leading [count] axis;
    a ring slot's), run against layer ``group`` of the stack's page pools.
    The layers are the ones ``_run_stacks`` applies, in its order, so a pass
    over every group is the resident step.  With ``collect`` a dict, the
    group's MoE router ids land in ``collect["moe_ids"]`` [n_moe, B, T, K]."""
    patterns, _count = cfg.layer_plan()[stack_idx]
    ids = []
    for pi, pat in enumerate(patterns):
        sub = None if collect is None else {}
        x, _ = _apply_layer(x, gp[pi], cfg, pat, mode, positions,
                            cache["stacks"][stack_idx][pi].layer(group), pos, table,
                            dispatch, policy, sub, lora)
        if sub:
            ids.append(sub["moe_ids"])
    if collect is not None and ids:
        collect["moe_ids"] = torch.stack(ids)
    return x


def _logits(x: torch.Tensor, params: dict, cfg: ModelConfig,
            dispatch: D.Dispatcher) -> torch.Tensor:
    h = L.rms_norm(x, params["final_norm"], cfg.rms_eps, dispatch)
    return L.apply_linear(h, params["lm_head"], cfg.quant, dispatch,
                          out_dtype=torch.float32)


def prefill_chunk_paged(params: dict, cfg: ModelConfig, embeds: torch.Tensor,
                        cache: dict, slot, pos0, last_idx,
                        dispatch: D.Dispatcher,
                        policy: PrecisionPolicy = DEFAULT_POLICY,
                        collect: Optional[list] = None,
                        run_stacks: Optional[Callable] = None,
                        lora: Optional[dict] = None) -> torch.Tensor:
    """One prompt chunk for decode row ``slot`` written straight into the
    pool.  embeds [1, C, d] at absolute positions [pos0, pos0 + C); a
    padded final chunk's keys land in causally dead positions or the trash
    page.  Returns the logits [1, V] of chunk-local index ``last_idx``.
    ``slot``, ``pos0`` and ``last_idx`` are ints or one-element int32 device
    tensors: read from the device, they never make the host wait and a CUDA
    graph replays the step for any values.  The caller advances
    ``cache["pos"]`` once the whole prompt is in.  ``run_stacks(x, mode,
    positions, pos, table, lora)`` replaces the resident stacks' run
    (streamed weights).  ``lora["ids"]`` holds the row's one adapter id."""
    x = embeds.to(torch.bfloat16)
    B, C = x.shape[:2]
    if B != 1:
        raise ValueError("prompt chunks are per-row")
    slot, pos0, last_idx = (KP.device_scalar(v, x.device) for v in (slot, pos0, last_idx))
    positions = (pos0 + torch.arange(C, device=x.device, dtype=torch.int32))[None]
    table_row = cache["table"].index_select(0, slot.long())[0]
    if run_stacks is not None:
        x = run_stacks(x, "prefill_paged", positions, pos0, table_row, lora)
    else:
        x = _run_stacks(x, params, cfg, "prefill_paged", positions, cache, pos0,
                        table_row, dispatch, policy, collect, lora)
    last = x.index_select(1, last_idx.long())
    return _logits(last, params, cfg, dispatch)[:, 0]


def decode_step_bucketed(params: dict, cfg: ModelConfig, embeds: torch.Tensor,
                         cache: dict, slot_idx: torch.Tensor, dispatch: D.Dispatcher,
                         active: Optional[torch.Tensor] = None,
                         policy: PrecisionPolicy = DEFAULT_POLICY,
                         collect: Optional[list] = None,
                         run_stacks: Optional[Callable] = None,
                         lora: Optional[dict] = None
                         ) -> Tuple[torch.Tensor, dict]:
    """One decode step over a bucket of rows gathered from the slot set:
    embeds [b, 1, d]; ``slot_idx`` [b] names each bucket row's slot (pad
    rows are distinct idle slots, masked by ``active`` [b] and routed to the
    trash page by their all-trash table rows).  Only ``pos`` and the table
    are gathered — the pool is physical-page addressed and never moves.
    ``run_stacks`` as in ``prefill_chunk_paged``; ``lora["ids"]`` [b] in
    bucket order.  Returns (logits [b, V] in
    bucket order, cache with ``pos`` advanced for the active rows)."""
    x = embeds.to(torch.bfloat16)
    b, T = x.shape[:2]
    idx = slot_idx.long()
    pos = cache["pos"][idx]
    positions = pos[:, None] + torch.arange(T, device=x.device, dtype=pos.dtype)[None]
    if run_stacks is not None:
        x = run_stacks(x, "decode", positions, pos, cache["table"][idx], lora)
    else:
        x = _run_stacks(x, params, cfg, "decode", positions, cache, pos,
                        cache["table"][idx], dispatch, policy, collect, lora)
    stepped = pos + T if active is None else torch.where(active, pos + T, pos)
    cache["pos"][idx] = stepped
    return _logits(x, params, cfg, dispatch)[:, -1], cache


def prefill(params: dict, cfg: ModelConfig, embeds: torch.Tensor, max_seq: int,
            dispatch: D.Dispatcher, positions: Optional[torch.Tensor] = None,
            policy: PrecisionPolicy = DEFAULT_POLICY,
            collect: Optional[list] = None,
            lora: Optional[dict] = None) -> Tuple[torch.Tensor, dict]:
    """Whole-prompt prefill of embeds [B, T, d] into fresh dense caches of
    ``max_seq`` slots.  Returns (logits [B, V] of the last token, cache
    with ``pos`` = T)."""
    x = embeds.to(torch.bfloat16)
    B, T = x.shape[:2]
    if positions is None:
        positions = torch.arange(T, device=x.device)[None].expand(B, T)
    cache = init_cache(cfg, B, max_seq, device=x.device)
    x = _run_stacks(x, params, cfg, "prefill", positions, cache, None, None,
                    dispatch, policy, collect, lora)
    cache["pos"] = torch.tensor(T, dtype=torch.int32, device=x.device)
    return _logits(x[:, -1:], params, cfg, dispatch)[:, 0], cache


def decode_step(params: dict, cfg: ModelConfig, embeds: torch.Tensor, cache: dict,
                dispatch: D.Dispatcher, positions: Optional[torch.Tensor] = None,
                active: Optional[torch.Tensor] = None,
                policy: PrecisionPolicy = DEFAULT_POLICY,
                collect: Optional[list] = None,
                lora: Optional[dict] = None) -> Tuple[torch.Tensor, dict]:
    """One decode step of every row: embeds [B, 1, d] against dense caches
    (``pos`` a scalar or [B]) or the paged pool (``pos`` [B], ``table``).
    ``active`` [B] keeps inactive rows' positions; their KV bytes need no
    rollback (the reference's ``freeze_inactive_rows`` passes full-attention
    pools and dense caches through): a paged row outside the step has an
    all-trash table row, and a dense row rewrites the same slot next step.
    Returns (logits [B, V], cache with ``pos`` advanced)."""
    x = embeds.to(torch.bfloat16)
    B, T = x.shape[:2]
    pos = cache["pos"]
    if positions is None:
        if pos.dim() == 1:
            positions = pos[:, None] + torch.arange(T, device=x.device, dtype=pos.dtype)[None]
        else:
            positions = pos.expand(B, T)
    x = _run_stacks(x, params, cfg, "decode", positions, cache, pos,
                    cache.get("table"), dispatch, policy, collect, lora)
    cache["pos"] = pos + T if active is None else torch.where(active, pos + T, pos)
    return _logits(x, params, cfg, dispatch)[:, -1], cache
