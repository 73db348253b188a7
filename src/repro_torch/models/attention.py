"""Attention for serving — port of the serving parts of
``repro.models.attention``: GQA projections with the qwen2 bias, the query
pre-scale of the paper's mixed-precision policy, the training forward
(``attention_train``), and the two cache layouts' entry points — whole-prompt prefill into a dense ``LayerKVCache`` and
one-token decode against it (``Engine.generate``), chunked prefill and
one-token decode against the paged pool (``EngineLoop``) — and an
encoder-decoder's cross attention over the encoder's quantized K/V
(``build_cross_cache``, in place for serving; ``cross_cache_train``, out of
place and differentiable for training; ``cross_attention``).  Every
self-attention entry
point takes ``lora``, the per-row multi-LoRA bypass on the q and v
projections (C7; ``core.lora``).

The blockwise reference ``flash_attention`` lives beside the prefill
kernels' plain versions (``kernels.flash_prefill``) and is re-exported
here; the reference's dense ``decode_attention_ref`` is
``kernels.quant_attention.quant_decode_attention_plain``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import LayerPattern, ModelConfig
from repro_torch.core import kv_cache as kvc
from repro_torch.core import kv_pool as KP
from repro_torch.core import lora as LR
from repro_torch.core.precision import DEFAULT_POLICY, PrecisionPolicy
from repro_torch.kernels.flash_prefill import FLASH_BK, flash_attention  # noqa: F401
from repro_torch.models import layers as L
from repro_torch.runtime import dispatch as D


def attn_params(b: L.ParamBuilder, cfg: ModelConfig, lead: tuple = (),
                cross: bool = False) -> dict:
    """wq, wk, wv, wo and, with ``cfg.qkv_bias``, the q/k/v biases; cross
    attention's projections (``cross``) carry no bias, as in the reference."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    qo, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    p = {"wq": b.linear(d, qo, lead=lead), "wk": b.linear(d, kv, lead=lead),
         "wv": b.linear(d, kv, lead=lead), "wo": b.linear(qo, d, lead=lead)}
    if cfg.qkv_bias and not cross:
        p["bq"] = b.bias(qo, lead)
        p["bk"] = b.bias(kv, lead)
        p["bv"] = b.bias(kv, lead)
    return p


def _project_qkv(x: torch.Tensor, p: dict, cfg: ModelConfig,
                 dispatch: D.Dispatcher, lora: Optional[dict] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q/k/v projections of x, k and v reading x too (cross attention
    projects its k and v from the encoder output in ``_cross_kv``).
    ``lora``: the adapter tables ("wq_a", "wq_b", "wv_a",
    "wv_b") and each row's adapter id ("ids" [B]); the bypass is computed
    in float32 from the bf16 input, cast to the projection's dtype and
    added before the bias, as in the reference."""
    hd = cfg.resolved_head_dim
    qp = L.apply_linear(x, p["wq"], cfg.quant, dispatch)
    kp = L.apply_linear(x, p["wk"], cfg.quant, dispatch)
    vp = L.apply_linear(x, p["wv"], cfg.quant, dispatch)
    if lora is not None:
        qp = qp + LR.lora_apply_batched(x, lora["wq_a"], lora["wq_b"],
                                        lora["ids"]).to(qp.dtype)
        vp = vp + LR.lora_apply_batched(x, lora["wv_a"], lora["wv_b"],
                                        lora["ids"]).to(vp.dtype)
    if "bq" in p:
        qp = qp + p["bq"].to(qp.dtype)
        kp = kp + p["bk"].to(kp.dtype)
        vp = vp + p["bv"].to(vp.dtype)
    B, T = x.shape[:2]
    return (qp.reshape(B, T, cfg.num_heads, hd),
            kp.reshape(B, T, cfg.num_kv_heads, hd),
            vp.reshape(B, T, cfg.num_kv_heads, hd))


def _prescale(qh: torch.Tensor, hd: int, policy: PrecisionPolicy) -> torch.Tensor:
    """The paper's fix for half precision's range: 1/sqrt(d) applied to the
    query (in float32) before Q.K^T."""
    if policy.prescale_query:
        return (qh.float() * (1.0 / float(hd) ** 0.5)).to(policy.compute_dtype)
    return qh


def attention_train(x: torch.Tensor, p: dict, cfg: ModelConfig, pat: LayerPattern,
                    positions: torch.Tensor, dispatch: D.Dispatcher,
                    policy: PrecisionPolicy = DEFAULT_POLICY) -> torch.Tensor:
    """The training forward of x [B, T, d] (no cache): the projections,
    RoPE at ``positions``, the pre-scale, then causal attention over the
    unquantized K/V through the dispatcher's ``prefill_attention`` (kernel
    7 under its ``autograd.Function`` on the card), then the o projection."""
    B, T = x.shape[:2]
    qh, kh, vh = _project_qkv(x, p, cfg, dispatch)
    qh = L.positional(qh, cfg, positions)
    kh = L.positional(kh, cfg, positions)
    qh = _prescale(qh, cfg.resolved_head_dim, policy)
    out = dispatch.prefill_attention(qh, kh, vh, causal=True, window=pat.window,
                                     policy=policy)
    return L.apply_linear(out.reshape(B, T, -1), p["wo"], cfg.quant, dispatch)


def attention_prefill(x: torch.Tensor, p: dict, cfg: ModelConfig,
                      pat: LayerPattern, positions: torch.Tensor,
                      cache: kvc.LayerKVCache, dispatch: D.Dispatcher,
                      policy: PrecisionPolicy = DEFAULT_POLICY,
                      lora: Optional[dict] = None
                      ) -> Tuple[torch.Tensor, kvc.LayerKVCache]:
    """Whole-prompt prefill of x [B, T, d] into the empty layer ``cache``
    (written in place): quantize and store K/V at [0, T), then attend over
    the quantization round trip of exactly the stored bytes, as every later
    decode reads them.  A full-attention layer reads the cache view cut to
    whole 1024-key flash blocks past the prompt: a wholly causal-masked
    block is an exact no-op of the online softmax, so the cut changes no
    bit.  A windowed layer's ring cannot give back the prompt's overwritten
    keys, so it attends over the round trip of the prompt's own K/V, within
    the window."""
    B, T = x.shape[:2]
    qh, kh, vh = _project_qkv(x, p, cfg, dispatch, lora)
    qh = L.positional(qh, cfg, positions)
    kh = L.positional(kh, cfg, positions)
    cache = kvc.append(cache, kh, vh, 0)
    qh = _prescale(qh, cfg.resolved_head_dim, policy)
    if pat.window:
        k_rt, v_rt = kvc.roundtrip_kv(kh, vh, key_bits=cache.key_bits,
                                      v_dtype=cache.v.dtype,
                                      dtype=policy.compute_dtype)
    else:
        s_eff = min(cache.max_seq, -(-T // FLASH_BK) * FLASH_BK)
        k_rt = kvc.dequantize_keys(cache.k_q[:, :s_eff], cache.k_scale[:, :s_eff],
                                   cache.k_zero[:, :s_eff], policy.compute_dtype,
                                   bits=cache.key_bits)
        v_rt = cache.v[:, :s_eff].to(policy.compute_dtype)
    out = dispatch.prefill_attention(qh, k_rt, v_rt, causal=True, window=pat.window,
                                     policy=policy)
    return L.apply_linear(out.reshape(B, T, -1), p["wo"], cfg.quant, dispatch), cache


def attention_decode(x: torch.Tensor, p: dict, cfg: ModelConfig,
                     pat: LayerPattern, cache: kvc.LayerKVCache, pos,
                     positions: torch.Tensor, dispatch: D.Dispatcher,
                     policy: PrecisionPolicy = DEFAULT_POLICY,
                     lora: Optional[dict] = None
                     ) -> Tuple[torch.Tensor, kvc.LayerKVCache]:
    """One decode step against a dense cache: append the new token's
    quantized K/V at ``pos`` (a scalar, or [B] per row; in place), then
    attend over the first ``pos + 1`` slots (a windowed ring: its live
    slots)."""
    B, T = x.shape[:2]
    qh, kh, vh = _project_qkv(x, p, cfg, dispatch, lora)
    qh = L.positional(qh, cfg, positions)
    kh = L.positional(kh, cfg, positions)
    cache = kvc.append(cache, kh, vh, pos)
    qh = _prescale(qh, cfg.resolved_head_dim, policy)
    out = dispatch.decode_attention(qh, cache, pos + T, policy)
    return L.apply_linear(out.reshape(B, T, -1), p["wo"], cfg.quant, dispatch), cache


def attention_prefill_paged(x: torch.Tensor, p: dict, cfg: ModelConfig,
                            pat: LayerPattern, pool: KP.PagedLayerKV,
                            table_row: torch.Tensor, positions: torch.Tensor,
                            pos0, dispatch: D.Dispatcher,
                            policy: PrecisionPolicy = DEFAULT_POLICY,
                            lora: Optional[dict] = None, slot=None,
                            valid_len=None) -> torch.Tensor:
    """One prompt chunk of one row straight into the paged pool: quantize and
    append the chunk's K/V (in place), then attend the chunk's queries
    (absolute positions ``pos0 + arange(C)``; ``pos0``, ``slot`` and
    ``valid_len`` ints or one-element device tensors).  A full-attention
    layer appends into the row's pages through ``table_row``
    [pages_per_row] and attends over them through the dispatcher's paged
    prefill kernel.  A windowed layer appends into row ``slot``'s ring,
    clamped to the ``valid_len`` real tokens of a padded chunk, and attends
    over the ring through ``kv_pool.paged_prefill_window_ref``, called
    directly as the reference does: the reference has no TPU kernel for
    this path, and it runs as plain PyTorch on every device."""
    B, C = x.shape[:2]
    qh, kh, vh = _project_qkv(x, p, cfg, dispatch, lora)
    qh = L.positional(qh, cfg, positions)
    kh = L.positional(kh, cfg, positions)
    qh = _prescale(qh, cfg.resolved_head_dim, policy)
    if pool.window:
        vl = C if valid_len is None else valid_len
        KP.append_paged_prompt(pool, kh, vh, pos0, slot=slot, valid_len=vl)
        out = KP.paged_prefill_window_ref(qh, pool, slot, pos0, vl, pat.window,
                                          table_row.shape[0], policy)
    else:
        KP.append_paged_prompt(pool, kh, vh, pos0, table_row)
        out = dispatch.paged_prefill_attention(qh, pool, table_row[None], pos0, policy)
    return L.apply_linear(out.reshape(B, C, -1), p["wo"], cfg.quant, dispatch)


def attention_decode_paged(x: torch.Tensor, p: dict, cfg: ModelConfig,
                           pat: LayerPattern, pool: KP.PagedLayerKV,
                           table: torch.Tensor, pos: torch.Tensor,
                           positions: torch.Tensor, dispatch: D.Dispatcher,
                           policy: PrecisionPolicy = DEFAULT_POLICY,
                           lora: Optional[dict] = None,
                           active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step per row against the pool: append the new token's
    quantized K/V (in place), then attend over the row's keys up to
    ``pos + 1``.  Full-attention layers go through ``table`` [B,
    pages_per_row]; a windowed layer appends into each row's ring (rows
    outside ``active`` [B] into the ring pool's trash page) and attends
    over its ring view, table and base, within the window."""
    B, T = x.shape[:2]
    qh, kh, vh = _project_qkv(x, p, cfg, dispatch, lora)
    qh = L.positional(qh, cfg, positions)
    kh = L.positional(kh, cfg, positions)
    KP.append_paged(pool, kh, vh, pos, table, active=active)
    qh = _prescale(qh, cfg.resolved_head_dim, policy)
    if pool.window:
        tbl, base = KP.ring_view(pool, pos + T, B)
    else:
        tbl, base = table, None
    out = dispatch.paged_decode_attention(qh, pool, tbl, pos + T, policy, base=base)
    return L.apply_linear(out.reshape(B, T, -1), p["wo"], cfg.quant, dispatch)


def _cross_kv(enc_out: torch.Tensor, p: dict, cfg: ModelConfig,
              dispatch: D.Dispatcher) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross attention's k and v [B, S, H_kv, D], projected from the
    encoder output enc_out [B, S, d] (no bias)."""
    B, S = enc_out.shape[:2]
    shape = (B, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    return (L.apply_linear(enc_out, p["wk"], cfg.quant, dispatch).reshape(shape),
            L.apply_linear(enc_out, p["wv"], cfg.quant, dispatch).reshape(shape))


def build_cross_cache(enc_out: torch.Tensor, p: dict, cfg: ModelConfig,
                      cache: kvc.LayerKVCache, dispatch: D.Dispatcher) -> kvc.LayerKVCache:
    """One decoder layer's cross-attention cache: k/v projected from the
    encoder output enc_out [B, S, d] and quantized into ``cache``, a dense
    cache of S slots written in place from slot 0 (the reference's
    ``init_layer_cache`` + ``append``).  Returns it with ``length`` S."""
    return kvc.append(cache, *_cross_kv(enc_out, p, cfg, dispatch), 0)


def cross_cache_train(enc_out: torch.Tensor, p: dict, cfg: ModelConfig,
                      dispatch: D.Dispatcher) -> kvc.LayerKVCache:
    """``build_cross_cache`` for training: the same projections and
    quantization, the cache built out of place (``kv_cache.quantized_cache``)
    so that the gradient reaches ``wk`` through the keys' scale and zero
    and ``wv`` through the fp8 values, as in the reference's train step."""
    return kvc.quantized_cache(*_cross_kv(enc_out, p, cfg, dispatch),
                               key_bits=cfg.quant.kv_key_bits,
                               value_fp8=cfg.quant.kv_value_fp8)


def cross_attention(x: torch.Tensor, p: dict, cfg: ModelConfig,
                    cross_cache: kvc.LayerKVCache, dispatch: D.Dispatcher,
                    policy: PrecisionPolicy = DEFAULT_POLICY) -> torch.Tensor:
    """Decoder cross attention of x [B, T, d] over the encoder's quantized
    K/V: the q projection, the pre-scale, then every query token over the
    cache's ``length`` slots with no causal mask (the dispatcher's
    ``decode_attention``: one launch of the dense decode kernel, T tokens
    folded into the query-head axis where T > 1), then the o projection."""
    B, T = x.shape[:2]
    hd = cfg.resolved_head_dim
    qh = L.apply_linear(x, p["wq"], cfg.quant, dispatch).reshape(B, T, cfg.num_heads, hd)
    qh = _prescale(qh, hd, policy)
    out = dispatch.decode_attention(qh, cross_cache, cross_cache.length, policy,
                                    causal=False)
    return L.apply_linear(out.reshape(B, T, -1), p["wo"], cfg.quant, dispatch)
