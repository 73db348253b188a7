"""Model assembly — port of ``repro.models.transformer``: parameters
(attention, mamba or rwkv6 layers; dense or MoE FFN; the quantized serving
tree or the float training tree), the training forward (``forward_hidden``,
``forward_train``: every layer kind the reference trains -- full or windowed
attention, mamba and rwkv6 layers from a zero state, dense or MoE FFNs, an
encoder-decoder's encoder and cross attention, ``embeds`` batches -- each
layer under ``torch.utils.checkpoint`` when ``StepCtx.remat``), the two
decode states — dense per-sequence caches
(``init_cache``, ``prefill``, ``decode_step``: the slot-synchronous
``Engine.generate``) and the paged pool (``init_paged_cache``,
``prefill_chunk_paged``, ``decode_step`` / ``decode_step_bucketed``: the
``EngineLoop``).  An encoder-decoder (seamless-m4t) also has its
bidirectional encoder (``encode``) and one cross-attention cache per
decoder layer over the encoder's output (``build_cross_caches``), which the
dense path's ``prefill`` builds and every later decode step reads; the
paged ``EngineLoop`` serves decoder-only models, as the reference's does.

A recurrent layer's entry in either cache is its state, a dict of leaves
[count, B, ...] (``models.ssm``); the paged cache holds one spare row past
the slots, which warm-up chunks write.  Every step updates the rows it runs
in place: a prompt chunk its row (``index_copy_`` at the chunk's device
``slot``), a decode step its active rows, leaving the others' state as the
reference's ``freeze_inactive_rows`` does.

Parameters keep the reference's tree: ``{"stacks": (stack, ...),
"final_norm", "lm_head"}`` (an encoder-decoder adds ``"encoder"``, one
attention layer's dict stacked [encoder_layers], and ``"enc_norm"``; its
decoder layers add ``"ln_cross"`` and ``"cross"``) where each stack is a
tuple with one dict per period pattern whose leaves are stacked on a
leading [count] axis.  Layers
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
from repro_torch.models import ssm as S
from repro_torch.runtime import dispatch as D
from repro_torch.runtime import plan as RP


def _check_supported(cfg: ModelConfig) -> None:
    for patterns, _count in cfg.layer_plan():
        for pat in patterns:
            if pat.kind not in ("attn", "mamba", "rwkv"):
                raise ValueError(f"{cfg.name}: unknown layer kind {pat.kind!r}")


def _pattern_params(b: L.ParamBuilder, cfg: ModelConfig, pat: LayerPattern,
                    count: int, cross: bool = False) -> dict:
    """One period pattern's layers stacked [count]; ``cross`` (an
    encoder-decoder's decoder) adds ``ln_cross`` and the bias-free ``cross``
    projections, after the FFN as in the reference's tree."""
    lead = (count,)
    p = {"ln1": b.norm(cfg.d_model, lead)}
    if pat.kind == "rwkv":
        # rwkv_params holds its own channel mix, which ln2 norms
        p["tm"] = S.rwkv_params(b, cfg, lead)
        p["ln2"] = b.norm(cfg.d_model, lead)
        return p
    if pat.kind == "mamba":
        p["mamba"] = S.mamba_params(b, cfg, lead)
    else:
        p["attn"] = A.attn_params(b, cfg, lead)
    p["ln2"] = b.norm(cfg.d_model, lead)
    if pat.moe:
        p["moe"] = M.moe_params(b, cfg, lead)
    else:
        p["ffn"] = L.ffn_params(b, cfg, lead)
    if cross:
        p["ln_cross"] = b.norm(cfg.d_model, lead)
        p["cross"] = A.attn_params(b, cfg, lead, cross=True)
    return p


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device: torch.device, *, quantized: bool = False,
                include_embedding: Optional[bool] = None) -> dict:
    """The model's parameters built directly on ``device``, with the
    reference's keys and nesting.  ``quantized`` (serving): linears in the
    packed kernel-native layout (the reference's ``init_params(...,
    quantized=True, pack=True)``); otherwise (training) every linear a bf16
    tensor, ``lm_head`` a separate bf16 linear even where the config ties
    embeddings, as in the reference.  ``include_embedding`` (default: not
    ``quantized``) adds the bf16 ``embedding`` [padded_vocab, d]; a serving
    engine keeps it on Flash instead (``serving.engine.build_engine``).
    With no ``generator`` (the ``meta`` device only) nothing is drawn:
    ``abstract_params``."""
    _check_supported(cfg)
    if include_embedding is None:
        include_embedding = not quantized
    b = L.ParamBuilder(generator, device, cfg.quant, quantized=quantized)
    params = {}
    if include_embedding:
        params["embedding"] = b.param((cfg.padded_vocab_size, cfg.d_model))
    if cfg.is_encdec:
        params["encoder"] = _pattern_params(b, cfg, LayerPattern("attn"), cfg.encoder_layers)
        params["enc_norm"] = b.norm(cfg.d_model)
    params["stacks"] = tuple(
        tuple(_pattern_params(b, cfg, pat, count, cross=cfg.is_encdec) for pat in patterns)
        for patterns, count in cfg.layer_plan())
    params["final_norm"] = b.norm(cfg.d_model)
    params["lm_head"] = b.linear(cfg.d_model, cfg.padded_vocab_size,
                                 bits=cfg.quant.lm_head_bits)
    return params


def abstract_params(cfg: ModelConfig, *, quantized: bool = False,
                    include_embedding: Optional[bool] = None) -> dict:
    """``init_params``' tree on the ``meta`` device: every leaf with the
    shape and dtype the drawn tree has, no storage and no draw (the
    reference's ``abstract_params``; the dry run sizes a case from it).
    The reference's ``param_specs`` (partition specs over a pod mesh) has
    no counterpart on one card."""
    return init_params(cfg, None, torch.device("meta"), quantized=quantized,
                       include_embedding=include_embedding)


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

def _recurrent_state(cfg: ModelConfig, pat: LayerPattern, batch: int, count: int,
                     device: torch.device) -> dict:
    init = S.init_mamba_state if pat.kind == "mamba" else S.init_rwkv_state
    return init(batch, cfg, lead=(count,), device=device)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *, cross_len: int = 0,
               device: torch.device = torch.device("cpu")) -> dict:
    """Dense decode state: one stacked ``LayerKVCache`` per attention
    pattern (a windowed pattern's a ring of min(window, max_seq) slots), a
    zero state per recurrent pattern and ``pos``, one scalar position for
    every row (the slot-synchronous path).  An encoder-decoder with
    ``cross_len`` adds ``cross``: per stack and pattern, an empty stacked
    cache of ``cross_len`` slots a decoder layer (``build_cross_caches``
    fills them)."""
    _check_supported(cfg)
    stacks = tuple(
        tuple(kvc.init_layer_cache(batch, max_seq, cfg.num_kv_heads,
                                   cfg.resolved_head_dim, window=pat.window,
                                   key_bits=cfg.quant.kv_key_bits,
                                   value_fp8=cfg.quant.kv_value_fp8,
                                   layers=count, device=device)
              if pat.kind == "attn" else
              _recurrent_state(cfg, pat, batch, count, device)
              for pat in patterns)
        for patterns, count in cfg.layer_plan())
    cache = {"stacks": stacks, "pos": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.is_encdec and cross_len:
        cache["cross"] = tuple(
            tuple(kvc.init_layer_cache(batch, cross_len, cfg.num_kv_heads,
                                       cfg.resolved_head_dim,
                                       key_bits=cfg.quant.kv_key_bits,
                                       value_fp8=cfg.quant.kv_value_fp8,
                                       layers=count, device=device)
                  for _pat in patterns)
            for patterns, count in cfg.layer_plan())
    return cache


def init_paged_cache(cfg: ModelConfig, batch: int, geom: KP.PoolGeometry,
                     device: torch.device) -> dict:
    """Paged decode state: one stacked page pool per attention pattern (a
    windowed pattern's holds a ring per row), a zero state of batch + 1 rows
    per recurrent pattern (the last one spare), the per-row positions
    ``pos`` [batch] and the page table [batch, pages_per_row] that the
    full-attention pools share, all-trash until the host allocator hands
    out pages."""
    _check_supported(cfg)
    stacks = tuple(
        tuple(KP.init_paged_layer(geom, cfg.num_kv_heads, cfg.resolved_head_dim,
                                  layers=count, batch=batch, window=pat.window,
                                  key_bits=cfg.quant.kv_key_bits,
                                  value_fp8=cfg.quant.kv_value_fp8, device=device)
              if pat.kind == "attn" else
              _recurrent_state(cfg, pat, batch + 1, count, device)
              for pat in patterns)
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


def reset_row_recurrent(cache: dict, cfg: ModelConfig, slot: int) -> dict:
    """Zero row ``slot`` of every recurrent state, in place (one fill a
    leaf, no host wait): a fresh prompt's first chunk enters from the
    initial state, not the previous occupant's exit state."""
    for si, (patterns, _count) in enumerate(cfg.layer_plan()):
        for pi, pat in enumerate(patterns):
            if pat.kind != "attn":
                for leaf in cache["stacks"][si][pi].values():
                    leaf[:, int(slot)].zero_()
    return cache


def layer_entry(entry, li: int):
    """Layer ``li`` of a stacked cache entry: a pool's or cache's ``layer``,
    a recurrent state's leaves at ``li`` (views)."""
    if isinstance(entry, dict):
        return {k: v[li] for k, v in entry.items()}
    return entry.layer(li)


def _state_rows(state: dict, mode: str, slot, rows, batch: int) -> dict:
    """The rows of a layer's recurrent state ([B, ...] leaves) that a step
    runs: a prompt chunk's one row at ``slot``, a decode step's gathered
    ``rows`` (None: the first ``batch``)."""
    if mode == "prefill_paged":
        idx = slot.reshape(1).long()
        return {k: v.index_select(0, idx) for k, v in state.items()}
    if rows is not None:
        return {k: v.index_select(0, rows) for k, v in state.items()}
    return {k: v[:batch] for k, v in state.items()}


def _put_state_rows(state: dict, new: dict, mode: str, slot, rows, batch: int,
                    active) -> None:
    """Write a step's exit state back in place; rows outside ``active`` keep
    theirs (``torch.where``, the reference's ``freeze_inactive_rows``)."""
    for k, v in state.items():
        val = new[k].to(v.dtype)
        if mode == "prefill_paged":
            v.index_copy_(0, slot.reshape(1).long(), val)
            continue
        if active is not None:
            old = v.index_select(0, rows) if rows is not None else v[:batch]
            val = torch.where(active.reshape((-1,) + (1,) * (val.dim() - 1)), val, old)
        if rows is not None:
            v.index_copy_(0, rows, val)
        else:
            v[:batch].copy_(val)


# ===========================================================================
# Forward passes
# ===========================================================================

def _apply_layer(x: torch.Tensor, pp: dict, cfg: ModelConfig, pat: LayerPattern,
                 mode: str, positions: torch.Tensor, cache, pos, table,
                 dispatch: D.Dispatcher, policy: PrecisionPolicy,
                 collect: Optional[dict] = None, lora: Optional[dict] = None,
                 slot=None, valid_len=None, active=None, rows=None, cross=None):
    """One layer.  ``cache`` is this layer's ``PagedLayerKV`` (modes
    "prefill_paged" and "decode") or ``LayerKVCache`` ("prefill" and
    "decode"), or a recurrent layer's state ([B, ...] leaves, written in
    place).  ``collect``: an MoE layer's router ids (``apply_moe``).
    ``slot`` and ``valid_len``: a prompt chunk's row and real tokens (a
    padded dense prefill's real tokens); ``active`` [B]: a decode step's
    live rows (windowed layers' rings, recurrent states); ``rows`` [B]: a
    decode step's slots in a recurrent state (None: the first B).
    ``cross``: an encoder-decoder layer's cross-attention cache, attended
    after self attention.  Returns (x, the layer's cache after the step)."""
    h = L.rms_norm(x, pp["ln1"], cfg.rms_eps, dispatch)
    if pat.kind != "attn":
        # a prompt's real tokens reach the state; a decode step's are all real
        batch = x.shape[0]
        st = _state_rows(cache, mode, slot, rows, batch)
        if pat.kind == "rwkv":
            y, st = S.rwkv_time_mix(h, pp["tm"], cfg, st, dispatch, valid_len=valid_len)
            x = x + y
            h2 = L.rms_norm(x, pp["ln2"], cfg.rms_eps, dispatch)
            y2, st = S.rwkv_channel_mix(h2, pp["tm"], cfg, st, dispatch, valid_len=valid_len)
            _put_state_rows(cache, st, mode, slot, rows, batch, active)
            return x + y2, cache
        att, st = S.mamba_forward(h, pp["mamba"], cfg, st, dispatch, valid_len=valid_len)
        _put_state_rows(cache, st, mode, slot, rows, batch, active)
    elif mode == "prefill_paged":
        att = A.attention_prefill_paged(h, pp["attn"], cfg, pat, cache, table,
                                        positions, pos, dispatch, policy, lora,
                                        slot=slot, valid_len=valid_len)
    elif mode == "prefill":
        att, cache = A.attention_prefill(h, pp["attn"], cfg, pat, positions, cache,
                                         dispatch, policy, lora)
    elif isinstance(cache, KP.PagedLayerKV):
        att = A.attention_decode_paged(h, pp["attn"], cfg, pat, cache, table, pos,
                                       positions, dispatch, policy, lora, active)
    else:
        att, cache = A.attention_decode(h, pp["attn"], cfg, pat, cache, pos,
                                        positions, dispatch, policy, lora)
    x = x + att
    if cross is not None:
        hc = L.rms_norm(x, pp["ln_cross"], cfg.rms_eps, dispatch)
        x = x + A.cross_attention(hc, pp["cross"], cfg, cross, dispatch, policy)
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
                lora: Optional[dict] = None, slot=None, valid_len=None,
                active=None, rows=None) -> torch.Tensor:
    """Every layer in order.  ``mode`` "prefill_paged": ``pos`` is the
    chunk's first position, ``table`` the row's [pages_per_row] table,
    ``slot`` the row and ``valid_len`` the chunk's real tokens;
    "prefill": the dense caches are empty and fill from position 0
    (``valid_len``: a padded prompt's real tokens, for recurrent states);
    "decode": ``pos`` the per-row positions [B] (or, on dense caches, one
    scalar), ``table`` [B, pages_per_row] (None for dense caches),
    ``active`` [B] the live rows (None: all) and ``rows`` [B] their slots
    in the recurrent states (None: the first B).  ``cache["cross"]``, where
    present, gives each layer its cross-attention cache.
    Caches are written in place; dense caches get their per-layer lengths
    stacked back.  ``collect``: if a list, each layer's output hidden
    state is appended (parity tests)."""
    stacks = []
    cross = cache.get("cross")
    for si, (patterns, count) in enumerate(cfg.layer_plan()):
        sp = params["stacks"][si]
        lengths = [[] for _ in patterns]
        for li in range(count):
            for pi, pat in enumerate(patterns):
                x, new = _apply_layer(x, layer_slice(sp[pi], li), cfg, pat, mode,
                                      positions, layer_entry(cache["stacks"][si][pi], li),
                                      pos, table, dispatch, policy, lora=lora,
                                      slot=slot, valid_len=valid_len, active=active,
                                      rows=rows,
                                      cross=None if cross is None else
                                      layer_entry(cross[si][pi], li))
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
                    lora: Optional[dict] = None, slot=None, valid_len=None,
                    active=None, rows=None) -> torch.Tensor:
    """ONE layer group of one stack on the paged pool (modes "decode" and
    "prefill_paged", arguments as ``_run_stacks``'s): ``gp`` is the group's
    parameter tree (one dict per period pattern, no leading [count] axis;
    a ring slot's), run against layer ``group`` of the stack's page pools,
    windowed rings and recurrent states.  The layers are the ones
    ``_run_stacks`` applies, in its order and with its ``slot``,
    ``valid_len``, ``active`` and ``rows``, so a pass over every group is
    the resident step.  With ``collect`` a dict, the group's MoE router ids
    land in ``collect["moe_ids"]`` [n_moe, B, T, K]."""
    patterns, _count = cfg.layer_plan()[stack_idx]
    ids = []
    for pi, pat in enumerate(patterns):
        sub = None if collect is None else {}
        x, _ = _apply_layer(x, gp[pi], cfg, pat, mode, positions,
                            layer_entry(cache["stacks"][stack_idx][pi], group), pos,
                            table, dispatch, policy, sub, lora, slot=slot,
                            valid_len=valid_len, active=active, rows=rows)
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


# ===========================================================================
# Training forward
# ===========================================================================

@dataclasses.dataclass
class StepCtx:
    """A training step's context (the reference's ``StepCtx``, less its
    mesh fields): ``remat`` runs each layer under
    ``torch.utils.checkpoint`` (the reference's per-scan-body
    ``jax.checkpoint`` with ``nothing_saveable``: only the layer's input
    is kept, its forward is recomputed in the backward); ``dispatch`` None
    is a kernel ``Dispatcher`` (the plain versions on the CPU, the kernels
    on the card)."""
    cfg: ModelConfig
    policy: PrecisionPolicy = DEFAULT_POLICY
    remat: bool = False
    dispatch: Optional[D.Dispatcher] = None

    def __post_init__(self):
        if self.dispatch is None:
            self.dispatch = D.Dispatcher()


def embed_tokens(params: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The bf16 embedding rows of ``tokens`` [B, T] -> [B, T, d]."""
    return torch.nn.functional.embedding(tokens.long(), params["embedding"].to(torch.bfloat16))


def _train_layer(x: torch.Tensor, pp: dict, cfg: ModelConfig, pat: LayerPattern,
                 positions: torch.Tensor, ctx: StepCtx,
                 cross: Optional[kvc.LayerKVCache] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer in train mode (the reference ``_apply_pattern``'s "train"
    branches): an attention layer (windowed where the pattern says) and, on
    an encoder-decoder, its cross attention over ``cross``; a mamba layer
    from a zero state; each with its dense FFN, or its MoE FFN at the
    training capacity (``cfg.moe_capacity_factor``: tokens past it drop);
    or an rwkv6 layer from a zero state, its time mix then its channel mix
    with the state carried between them.  Returns (x, the layer's MoE aux
    [2]: load-balance loss, router z-loss; zeros for a dense FFN)."""
    dsp = ctx.dispatch
    B = x.shape[0]
    aux = torch.zeros((2,), dtype=torch.float32, device=x.device)
    h = L.rms_norm(x, pp["ln1"], cfg.rms_eps, dsp)
    if pat.kind == "rwkv":
        st = S.init_rwkv_state(B, cfg, device=x.device)
        y, st = S.rwkv_time_mix(h, pp["tm"], cfg, st, dsp)
        x = x + y
        h2 = L.rms_norm(x, pp["ln2"], cfg.rms_eps, dsp)
        y2, _ = S.rwkv_channel_mix(h2, pp["tm"], cfg, st, dsp)
        return x + y2, aux
    if pat.kind == "mamba":
        y, _ = S.mamba_forward(h, pp["mamba"], cfg, S.init_mamba_state(B, cfg, device=x.device),
                               dsp)
        x = x + y
    else:
        x = x + A.attention_train(h, pp["attn"], cfg, pat, positions, dsp, ctx.policy)
        if cross is not None:
            hc = L.rms_norm(x, pp["ln_cross"], cfg.rms_eps, dsp)
            x = x + A.cross_attention(hc, pp["cross"], cfg, cross, dsp, ctx.policy)
    h2 = L.rms_norm(x, pp["ln2"], cfg.rms_eps, dsp)
    if pat.moe:
        y, aux = M.apply_moe(h2, pp["moe"], cfg, dispatch=dsp, full_capacity=False)
    else:
        y = L.apply_ffn(h2, pp["ffn"], cfg, dsp)
    return x + y, aux


def _remat(fn, remat: bool, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``remat``."""
    if remat:
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def forward_hidden(params: dict, cfg: ModelConfig, batch: dict,
                   ctx: Optional[StepCtx] = None,
                   collect: Optional[list] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward up to the final norm: batch {"tokens" [B, T]
    (or "embeds" [B, T, d]: the vision frontend's), "positions"? [B, T],
    "src_embeds" [B, S, d] (an encoder-decoder's source)} -> (hidden [B, T,
    d] bf16, MoE aux [2] summed over the layers in layer order).  An
    encoder-decoder first encodes the source (each encoder layer under
    remat too) and builds every decoder layer's cross cache from it
    (``attention.cross_cache_train``), as the reference's train-mode cache
    holds cross K/V only; each decoder layer takes its cache as an input
    of its checkpoint.  The loss takes the hidden state with a chunked
    lm_head and cross entropy (``training.train_loop.chunked_cross_entropy``),
    so [B, T, V] logits never exist whole.  ``collect``: if a list, each
    decoder layer's output is appended (parity tests)."""
    ctx = ctx or StepCtx(cfg)
    if "tokens" in batch:
        x = embed_tokens(params, cfg, batch["tokens"])
    else:
        x = batch["embeds"].to(torch.bfloat16)
    B, T = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(T, device=x.device)[None].expand(B, T)
    cross = None
    if cfg.is_encdec:
        enc_out = encode(params, cfg, batch["src_embeds"], ctx.dispatch, ctx.policy,
                         remat=ctx.remat)
        cross = tuple(
            tuple([A.cross_cache_train(enc_out, layer_slice(sp[pi]["cross"], li), cfg,
                                       ctx.dispatch) for li in range(count)]
                  for pi in range(len(patterns)))
            for sp, (patterns, count) in zip(params["stacks"], cfg.layer_plan()))
    aux = torch.zeros((2,), dtype=torch.float32, device=x.device)
    for si, (patterns, count) in enumerate(cfg.layer_plan()):
        sp = params["stacks"][si]
        for li in range(count):
            for pi, pat in enumerate(patterns):
                x, a = _remat(_train_layer, ctx.remat, x, layer_slice(sp[pi], li), cfg, pat,
                              positions, ctx, None if cross is None else cross[si][pi][li])
                aux = aux + a
                if collect is not None:
                    collect.append(x)
    return L.rms_norm(x, params["final_norm"], cfg.rms_eps, ctx.dispatch), aux


def forward_train(params: dict, cfg: ModelConfig, batch: dict,
                  ctx: Optional[StepCtx] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward to the logits: (float32 [B, T, V], MoE aux
    [2])."""
    ctx = ctx or StepCtx(cfg)
    hidden, aux = forward_hidden(params, cfg, batch, ctx)
    return L.apply_linear(hidden, params["lm_head"], cfg.quant, ctx.dispatch,
                          out_dtype=torch.float32), aux


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
    graph replays the step for any values.  The chunk's real tokens are
    ``last_idx + 1`` (the padded tail of a final chunk never reaches a
    windowed layer's ring).  The caller advances
    ``cache["pos"]`` once the whole prompt is in.  ``run_stacks(x, mode,
    positions, pos, table, lora, slot=, valid_len=)`` replaces the resident
    stacks' run (streamed weights).  ``lora["ids"]`` holds the row's one
    adapter id."""
    x = embeds.to(torch.bfloat16)
    B, C = x.shape[:2]
    if B != 1:
        raise ValueError("prompt chunks are per-row")
    slot, pos0, last_idx = (KP.device_scalar(v, x.device) for v in (slot, pos0, last_idx))
    positions = (pos0 + torch.arange(C, device=x.device, dtype=torch.int32))[None]
    # a warm-up chunk aims at the spare ring past the last row (slot ==
    # batch), reading the last table row, which warm-up sets all-trash
    table = cache["table"]
    table_row = table.index_select(0, slot.long().clamp(max=table.shape[0] - 1))[0]
    if run_stacks is not None:
        x = run_stacks(x, "prefill_paged", positions, pos0, table_row, lora,
                       slot=slot, valid_len=last_idx + 1)
    else:
        x = _run_stacks(x, params, cfg, "prefill_paged", positions, cache, pos0,
                        table_row, dispatch, policy, collect, lora, slot=slot,
                        valid_len=last_idx + 1)
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
    Windowed layers' rings and recurrent states are addressed by bucket
    row, so a model with them decodes every slot in order (the loop turns
    bucketing off); the inactive rows' ring writes go to the ring pool's
    trash page, and their recurrent state is left as it was.
    ``run_stacks`` as in ``prefill_chunk_paged``, given ``active=`` and
    ``rows=`` (the bucket's slots) instead; ``lora["ids"]`` [b] in
    bucket order.  Returns (logits [b, V] in
    bucket order, cache with ``pos`` advanced for the active rows)."""
    x = embeds.to(torch.bfloat16)
    b, T = x.shape[:2]
    idx = slot_idx.long()
    pos = cache["pos"][idx]
    positions = pos[:, None] + torch.arange(T, device=x.device, dtype=pos.dtype)[None]
    if run_stacks is not None:
        x = run_stacks(x, "decode", positions, pos, cache["table"][idx], lora,
                       active=active, rows=idx)
    else:
        x = _run_stacks(x, params, cfg, "decode", positions, cache, pos,
                        cache["table"][idx], dispatch, policy, collect, lora,
                        active=active, rows=idx)
    stepped = pos + T if active is None else torch.where(active, pos + T, pos)
    cache["pos"][idx] = stepped
    return _logits(x, params, cfg, dispatch)[:, -1], cache


def _encoder_layer(x: torch.Tensor, pp: dict, cfg: ModelConfig, positions: torch.Tensor,
                   dispatch: D.Dispatcher, policy: PrecisionPolicy) -> torch.Tensor:
    """One bidirectional encoder layer: self attention over the unquantized
    K/V of the whole source (rope at the source positions, no causal mask:
    the dense prefill kernel, non-causal), then the FFN."""
    h = L.rms_norm(x, pp["ln1"], cfg.rms_eps, dispatch)
    qh, kh, vh = A._project_qkv(h, pp["attn"], cfg, dispatch)
    qh = L.positional(qh, cfg, positions)
    kh = L.positional(kh, cfg, positions)
    qh = A._prescale(qh, cfg.resolved_head_dim, policy)
    att = dispatch.prefill_attention(qh, kh, vh, causal=False, window=0, policy=policy)
    x = x + L.apply_linear(att.reshape(*x.shape[:2], -1), pp["attn"]["wo"], cfg.quant,
                           dispatch)
    h2 = L.rms_norm(x, pp["ln2"], cfg.rms_eps, dispatch)
    return x + L.apply_ffn(h2, pp["ffn"], cfg, dispatch)


def encode(params: dict, cfg: ModelConfig, src_embeds: torch.Tensor,
           dispatch: D.Dispatcher, policy: PrecisionPolicy = DEFAULT_POLICY,
           collect: Optional[list] = None, remat: bool = False) -> torch.Tensor:
    """The encoder-decoder's bidirectional encoder over src_embeds [B, S, d]
    (source positions 0..S-1), then ``enc_norm``.  ``collect``: if a list,
    each encoder layer's output is appended; ``remat``: each layer under
    ``torch.utils.checkpoint`` (training, as the reference's encoder scan
    is checkpointed)."""
    x = src_embeds.to(torch.bfloat16)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    for li in range(cfg.encoder_layers):
        x = _remat(_encoder_layer, remat, x, layer_slice(params["encoder"], li), cfg,
                   positions, dispatch, policy)
        if collect is not None:
            collect.append(x)
    return L.rms_norm(x, params["enc_norm"], cfg.rms_eps, dispatch)


def build_cross_caches(params: dict, cfg: ModelConfig, enc_out: torch.Tensor,
                       cross: tuple, dispatch: D.Dispatcher) -> tuple:
    """Every decoder layer's cross-attention K/V, projected from enc_out
    [B, S, d] and quantized into ``cross`` (``init_cache(cross_len=S)``'s,
    written in place); returns it with the per-layer lengths (S)."""
    stacks = []
    for si, (patterns, count) in enumerate(cfg.layer_plan()):
        per = []
        for pi in range(len(patterns)):
            c = cross[si][pi]
            lens = [A.build_cross_cache(enc_out,
                                        layer_slice(params["stacks"][si][pi]["cross"], li),
                                        cfg, c.layer(li), dispatch).length
                    for li in range(count)]
            per.append(dataclasses.replace(c, length=torch.stack(lens)))
        stacks.append(tuple(per))
    return tuple(stacks)


def prefill(params: dict, cfg: ModelConfig, embeds: torch.Tensor, max_seq: int,
            dispatch: D.Dispatcher, positions: Optional[torch.Tensor] = None,
            policy: PrecisionPolicy = DEFAULT_POLICY,
            collect: Optional[list] = None,
            lora: Optional[dict] = None,
            src_embeds: Optional[torch.Tensor] = None,
            valid_len=None) -> Tuple[torch.Tensor, dict]:
    """Whole-prompt prefill of embeds [B, T, d] into fresh dense caches of
    ``max_seq`` slots (``positions`` [B, T], or [B, T, 3] on an M-RoPE
    model; default 0..T-1).  An encoder-decoder encodes ``src_embeds`` [B,
    S, d] first and builds its cross caches.  Returns (logits [B, V] of the
    last token, cache with ``pos`` = T).

    ``valid_len`` (an int or a one-element device tensor): the real tokens
    of a prompt padded to a bucket -- logits are taken at valid_len - 1,
    ``pos`` is valid_len (the padded tail's keys stay masked and are
    overwritten), and recurrent states stop at valid_len.  A windowed
    layer's dense ring still needs an exact-length prompt: its padded tail
    would wrap over real keys, as in the reference."""
    x = embeds.to(torch.bfloat16)
    B, T = x.shape[:2]
    if positions is None:
        positions = torch.arange(T, device=x.device)[None].expand(B, T)
    if cfg.is_encdec and src_embeds is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: prefill needs src_embeds")
    cross_len = src_embeds.shape[1] if cfg.is_encdec else 0
    cache = init_cache(cfg, B, max_seq, cross_len=cross_len, device=x.device)
    if cross_len:
        enc_out = encode(params, cfg, src_embeds, dispatch, policy)
        cache["cross"] = build_cross_caches(params, cfg, enc_out, cache["cross"], dispatch)
    x = _run_stacks(x, params, cfg, "prefill", positions, cache, None, None,
                    dispatch, policy, collect, lora, valid_len=valid_len)
    if valid_len is None:
        cache["pos"] = torch.tensor(T, dtype=torch.int32, device=x.device)
        last = x[:, -1:]
    else:
        vl = KP.device_scalar(valid_len, x.device)
        cache["pos"] = vl.reshape(())
        last = x.index_select(1, (vl - 1).long())
    return _logits(last, params, cfg, dispatch)[:, 0], cache


def decode_step(params: dict, cfg: ModelConfig, embeds: torch.Tensor, cache: dict,
                dispatch: D.Dispatcher, positions: Optional[torch.Tensor] = None,
                active: Optional[torch.Tensor] = None,
                policy: PrecisionPolicy = DEFAULT_POLICY,
                collect: Optional[list] = None,
                lora: Optional[dict] = None) -> Tuple[torch.Tensor, dict]:
    """One decode step of every row: embeds [B, 1, d] against dense caches
    (``pos`` a scalar or [B]) or the paged pool (``pos`` [B], ``table``).
    ``active`` [B] keeps inactive rows' positions, and their KV bytes and
    recurrent state stay as the reference's ``freeze_inactive_rows`` leaves
    them: a paged row outside the step has an all-trash table row, its
    windowed layers write the ring pool's trash page, a dense row rewrites
    the same slot next step, and a recurrent state keeps the row's value.
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
                    cache.get("table"), dispatch, policy, collect, lora,
                    active=active)
    cache["pos"] = pos + T if active is None else torch.where(active, pos + T, pos)
    return _logits(x, params, cfg, dispatch)[:, -1], cache
