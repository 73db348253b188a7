"""Attention over the paged quantized KV pool — port of the serving parts of
``repro.models.attention`` (GQA projections with the qwen2 bias, the
query pre-scale of the paper's mixed-precision policy, chunked prefill and
one-token decode against the pool).

The blockwise reference ``flash_attention`` lives beside the prefill
kernel's plain version (``kernels.flash_prefill``) and is re-exported here.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import LayerPattern, ModelConfig
from repro_torch.core import kv_pool as KP
from repro_torch.core.precision import DEFAULT_POLICY, PrecisionPolicy
from repro_torch.kernels.flash_prefill import flash_attention  # noqa: F401
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
                 dispatch: D.Dispatcher
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    hd = cfg.resolved_head_dim
    qp = L.apply_linear(x, p["wq"], cfg.quant, dispatch)
    kp = L.apply_linear(x, p["wk"], cfg.quant, dispatch)
    vp = L.apply_linear(x, p["wv"], cfg.quant, dispatch)
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


def attention_prefill_paged(x: torch.Tensor, p: dict, cfg: ModelConfig,
                            pat: LayerPattern, pool: KP.PagedLayerKV,
                            table_row: torch.Tensor, positions: torch.Tensor,
                            pos0: int, dispatch: D.Dispatcher,
                            policy: PrecisionPolicy = DEFAULT_POLICY
                            ) -> torch.Tensor:
    """One prompt chunk of one row straight into the paged pool: quantize and
    append the chunk's K/V into the row's pages (in place), then attend the
    chunk's queries (absolute positions ``pos0 + arange(C)``) over the
    row's stored pages through ``table_row`` [pages_per_row]."""
    if pat.window:
        raise NotImplementedError("windowed layers prefill through their ring "
                                  "(ROADMAP queue 1 item 13)")
    B, C = x.shape[:2]
    qh, kh, vh = _project_qkv(x, p, cfg, dispatch)
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
                           policy: PrecisionPolicy = DEFAULT_POLICY
                           ) -> torch.Tensor:
    """One decode step per row against the pool: append the new token's
    quantized K/V into its page through ``table`` [B, pages_per_row] (in
    place), then attend over the row's pages up to ``pos + 1``."""
    if pat.window:
        raise NotImplementedError("windowed decode reads a ring view "
                                  "(ROADMAP queue 1 item 13)")
    B, T = x.shape[:2]
    qh, kh, vh = _project_qkv(x, p, cfg, dispatch)
    qh = L.positional(qh, cfg, positions)
    kh = L.positional(kh, cfg, positions)
    KP.append_paged(pool, kh, vh, pos, table)
    qh = _prescale(qh, cfg.resolved_head_dim, policy)
    out = dispatch.paged_decode_attention(qh, pool, table, pos + T, policy)
    return L.apply_linear(out.reshape(B, T, -1), p["wo"], cfg.quant, dispatch)
