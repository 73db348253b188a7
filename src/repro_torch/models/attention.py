"""Attention for serving — port of the serving parts of
``repro.models.attention``: GQA projections with the qwen2 bias, the query
pre-scale of the paper's mixed-precision policy, and the two cache layouts'
entry points — whole-prompt prefill into a dense ``LayerKVCache`` and
one-token decode against it (``Engine.generate``), chunked prefill and
one-token decode against the paged pool (``EngineLoop``).  Every entry
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


def attn_params(b: L.ParamBuilder, cfg: ModelConfig, lead: tuple = ()) -> dict:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    qo, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    p = {"wq": b.linear(d, qo, lead=lead), "wk": b.linear(d, kv, lead=lead),
         "wv": b.linear(d, kv, lead=lead), "wo": b.linear(qo, d, lead=lead)}
    if cfg.qkv_bias:
        p["bq"] = b.bias(qo, lead)
        p["bk"] = b.bias(kv, lead)
        p["bv"] = b.bias(kv, lead)
    return p


def _project_qkv(x: torch.Tensor, p: dict, cfg: ModelConfig,
                 dispatch: D.Dispatcher, lora: Optional[dict] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q/k/v projections of x (the port has no cross attention: k and v
    read x too).  ``lora``: the adapter tables ("wq_a", "wq_b", "wv_a",
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


def attention_prefill(x: torch.Tensor, p: dict, cfg: ModelConfig,
                      pat: LayerPattern, positions: torch.Tensor,
                      cache: kvc.LayerKVCache, dispatch: D.Dispatcher,
                      policy: PrecisionPolicy = DEFAULT_POLICY,
                      lora: Optional[dict] = None
                      ) -> Tuple[torch.Tensor, kvc.LayerKVCache]:
    """Whole-prompt prefill of x [B, T, d] into the empty layer ``cache``
    (written in place): quantize and store K/V at [0, T), then attend over
    the quantization round trip of exactly the stored bytes, as every later
    decode reads them.  The cache view is cut to whole 1024-key flash
    blocks past the prompt: a wholly causal-masked block is an exact no-op
    of the online softmax, so the cut changes no bit."""
    if pat.window:
        raise NotImplementedError("windowed layers prefill through their ring "
                                  "(ROADMAP queue 1 item 13)")
    B, T = x.shape[:2]
    qh, kh, vh = _project_qkv(x, p, cfg, dispatch, lora)
    qh = L.positional(qh, cfg, positions)
    kh = L.positional(kh, cfg, positions)
    cache = kvc.append(cache, kh, vh, 0)
    qh = _prescale(qh, cfg.resolved_head_dim, policy)
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
    attend over the first ``pos + 1`` slots."""
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
                            lora: Optional[dict] = None) -> torch.Tensor:
    """One prompt chunk of one row straight into the paged pool: quantize and
    append the chunk's K/V into the row's pages (in place), then attend the
    chunk's queries (absolute positions ``pos0 + arange(C)``; ``pos0`` an
    int or a one-element device tensor) over the row's stored pages through
    ``table_row`` [pages_per_row]."""
    if pat.window:
        raise NotImplementedError("windowed layers prefill through their ring "
                                  "(ROADMAP queue 1 item 13)")
    B, C = x.shape[:2]
    qh, kh, vh = _project_qkv(x, p, cfg, dispatch, lora)
    qh = L.positional(qh, cfg, positions)
    kh = L.positional(kh, cfg, positions)
    KP.append_paged_prompt(pool, kh, vh, pos0, table_row)
    qh = _prescale(qh, cfg.resolved_head_dim, policy)
    out = dispatch.paged_prefill_attention(qh, pool, table_row[None], pos0, policy)
    return L.apply_linear(out.reshape(B, C, -1), p["wo"], cfg.quant, dispatch)


def attention_decode_paged(x: torch.Tensor, p: dict, cfg: ModelConfig,
                           pat: LayerPattern, pool: KP.PagedLayerKV,
                           table: torch.Tensor, pos: torch.Tensor,
                           positions: torch.Tensor, dispatch: D.Dispatcher,
                           policy: PrecisionPolicy = DEFAULT_POLICY,
                           lora: Optional[dict] = None) -> torch.Tensor:
    """One decode step per row against the pool: append the new token's
    quantized K/V into its page through ``table`` [B, pages_per_row] (in
    place), then attend over the row's pages up to ``pos + 1``."""
    if pat.window:
        raise NotImplementedError("windowed decode reads a ring view "
                                  "(ROADMAP queue 1 item 13)")
    B, T = x.shape[:2]
    qh, kh, vh = _project_qkv(x, p, cfg, dispatch, lora)
    qh = L.positional(qh, cfg, positions)
    kh = L.positional(kh, cfg, positions)
    KP.append_paged(pool, kh, vh, pos, table)
    qh = _prescale(qh, cfg.resolved_head_dim, policy)
    out = dispatch.paged_decode_attention(qh, pool, table, pos + T, policy)
    return L.apply_linear(out.reshape(B, T, -1), p["wo"], cfg.quant, dispatch)
