"""Mixture-of-Experts FFN — port of ``repro.models.moe`` (sort-based capacity
dispatch and the selected-expert decode path; the port has no device mesh,
so tokens form gcd(B, 16) groups exactly as the reference's do with no
mesh set).

Dispatch: router top-k -> flatten (token, expert) pairs -> stable sort by
expert -> rank within expert -> gather into [G, E, C, d] (pairs past the
capacity C go to an extra pad row and drop) -> grouped matmul -> gather the
K expert outputs back per token and weight them.  Serving sizes C to the
worst case (``full_capacity``), so no token drops; the grouped matmul is
told each segment's live row count, so its kernel skips the zero rows.
With at most E routed pairs (B*T*K <= E) the selected-expert path runs the
K chosen experts of each token instead, as an n*K-slab grouped matmul of
one row each that names its experts by id.  Every expert matmul goes
through the dispatcher's ``grouped_matmul`` op.

Routing order follows the reference: ``jnp.argsort`` is stable, so the
port sorts with ``stable=True``; ``lax.top_k`` breaks ties toward the lower
index, which a stable descending sort reproduces.

The reference's ``expert_parallel`` (the experts sharded over the 16-way
"model" axis of a pod mesh, with its all-to-all) has no counterpart: one
card holds every expert.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quantization as q
from repro_torch.models import layers as L
from repro_torch.runtime import dispatch as D

MOE_CHUNK_TOKENS = 16384   # tokens per dispatch for giant prefill batches


def moe_params(b: L.ParamBuilder, cfg: ModelConfig, lead: tuple = ()) -> dict:
    """Router (bf16, as the reference builds it) and the three expert
    tables [*lead, E, ...] of one MoE FFN (``lead`` = the stack's layers)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {"router": b.param((*lead, d, e), scale=0.02),
            "w_gate": b.linear(d, f, lead=(*lead, e), experts=True),
            "w_up": b.linear(d, f, lead=(*lead, e), experts=True),
            "w_down": b.linear(f, d, lead=(*lead, e), experts=True)}


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest along the last axis, descending, ties
    to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x: torch.Tensor, router: torch.Tensor, K: int):
    """float32 router logits, softmax probabilities, and the top-K
    probabilities renormalized to sum to 1."""
    logits = torch.matmul(x.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    topk_p, topk_i = _top_k(probs, K)
    topk_p = topk_p / torch.clamp(topk_p.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, topk_p, topk_i


def _expert_matmul(xe: torch.Tensor, wp: dict, qcfg: q.QuantConfig,
                   dispatch: D.Dispatcher, **tables) -> torch.Tensor:
    """xe [G, E, C, in] @ w [E, in, out] -> [G, E, C, out] (bf16) through
    the ``grouped_matmul`` op (``tables``: its ``rows`` / ``ids``).  A float
    table (a bf16 tensor: the training tree) is the reference's float32
    ``einsum`` cast to bf16, which it computes outside any kernel (with
    ``ids``, over the slabs they select)."""
    w = wp["w"]
    if torch.is_tensor(w):
        if tables.get("ids") is not None:
            w = w.index_select(0, tables["ids"].long())
        return torch.einsum("geci,eio->geco", xe.float(), w.float()).to(torch.bfloat16)
    return dispatch.grouped_matmul(xe, w, qcfg, **tables)


def _dispatch_moe(xg: torch.Tensor, p: dict, cfg: ModelConfig,
                  dispatch: D.Dispatcher, full_capacity: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grouped capacity dispatch over xg [G, Tg, d].  Returns (y [G, Tg, d],
    aux [2] = (load-balance loss, router z-loss), router top-k ids
    [G, Tg, K])."""
    G, Tg, d = xg.shape
    E, K = cfg.num_experts, cfg.experts_per_tok
    dev = xg.device
    logits, probs, topk_p, topk_i = _route(xg, p["router"], K)
    if full_capacity:
        C = Tg        # an expert receives at most Tg tokens: nothing drops
    else:
        C = min(int(max(1, round(Tg * K / E * cfg.moe_capacity_factor))), Tg)
    TK = Tg * K
    flat_e = topk_i.reshape(G, TK)
    flat_t = torch.arange(Tg, device=dev).repeat_interleave(K)[None].expand(G, TK)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(-1, order)
    st = flat_t.gather(-1, order)
    counts = torch.zeros((G, E), dtype=torch.int64, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=-1) - counts                # [G, E]
    pos_in_e = torch.arange(TK, device=dev)[None] - starts.gather(-1, se)
    slot = torch.where(pos_in_e < C, se * C + pos_in_e,
                       torch.full_like(se, E * C))                # [G, TK]
    # dropped pairs land in the extra column E*C, sliced off below
    idx = torch.full((G, E * C + 1), Tg, dtype=torch.int64, device=dev)
    idx = idx.scatter(1, slot, st)[:, :E * C]
    xg_pad = torch.cat([xg, torch.zeros((G, 1, d), dtype=xg.dtype, device=dev)], 1)
    xe = xg_pad.gather(1, idx[..., None].expand(G, E * C, d)).reshape(G, E, C, d)
    # the live rows at the head of each (expert, group) segment, on the
    # device (no host wait); the rest are zeros, and stay zeros through
    # swiglu, so the down projection skips the same rows
    rows = counts.clamp(max=C).to(torch.int32).t().contiguous()   # [E, G]
    g = _expert_matmul(xe, p["w_gate"], cfg.quant, dispatch, rows=rows)
    u = _expert_matmul(xe, p["w_up"], cfg.quant, dispatch, rows=rows)
    ye = _expert_matmul(L.swiglu(u, g), p["w_down"], cfg.quant, dispatch, rows=rows)
    # gather-based combine: inverse-permute to token-major, sum the K experts
    slot_tok = slot.gather(-1, torch.argsort(order, dim=-1))       # [G, TK]
    contrib = torch.cat([ye.to(torch.bfloat16).reshape(G, E * C, d),
                         torch.zeros((G, 1, d), dtype=torch.bfloat16, device=dev)], 1)
    per_tok = contrib.gather(1, slot_tok[..., None].expand(G, TK, d))
    per_tok = per_tok.reshape(G, Tg, K, d).float()
    y = torch.einsum("gtkd,gtk->gtd", per_tok, topk_p.float())
    frac_tokens = counts.float() / max(TK, 1)
    lb = E * (frac_tokens * probs.mean(dim=1)).sum(-1).mean()
    z = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    return y.to(xg.dtype), torch.stack([lb, z]), topk_i


def _dispatch_moe_tiny(xg: torch.Tensor, p: dict, cfg: ModelConfig,
                       dispatch: D.Dispatcher
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Selected-expert path for tiny token counts (tokens * K <= E): only
    the K chosen experts' slabs of each token are read, as an n*K-slab
    grouped matmul of one row each that names its experts by id (the
    plain version gathers the slabs, the kernel reads them in place)."""
    G, Tg, d = xg.shape
    E, K = cfg.num_experts, cfg.experts_per_tok
    n = G * Tg
    x_flat = xg.reshape(n, d)
    logits, probs, topk_p, topk_i = _route(x_flat, p["router"], K)
    ids = topk_i.reshape(n * K).to(torch.int32)
    xr = x_flat.repeat_interleave(K, dim=0).reshape(1, n * K, 1, d)
    g = _expert_matmul(xr, p["w_gate"], cfg.quant, dispatch, ids=ids)
    u = _expert_matmul(xr, p["w_up"], cfg.quant, dispatch, ids=ids)
    ye = _expert_matmul(L.swiglu(u, g), p["w_down"], cfg.quant, dispatch,
                        ids=ids)                                   # [1, nK, 1, d]
    per_tok = ye.reshape(n, K, d).float()
    y = torch.einsum("tkd,tk->td", per_tok, topk_p.float())
    frac = torch.zeros((E,), dtype=torch.float32, device=xg.device).index_add_(
        0, ids, torch.ones((n * K,), dtype=torch.float32, device=xg.device))
    lb = E * (frac / max(n * K, 1) * probs.mean(0)).sum()
    z = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    return (y.reshape(G, Tg, d).to(xg.dtype), torch.stack([lb, z]),
            topk_i.reshape(G, Tg, K))


def _num_groups(batch: int, mesh_data: int = 16) -> int:
    return math.gcd(batch, mesh_data)


def apply_moe(x: torch.Tensor, p: dict, cfg: ModelConfig, *,
              dispatch: D.Dispatcher, full_capacity: bool = False,
              collect: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, d] -> (y [B, T, d], aux [2]).  Tokens form G = gcd(B, 16)
    groups; sequences longer than ``MOE_CHUNK_TOKENS // B`` that it divides
    are dispatched chunk by chunk along T.  ``full_capacity`` (serving)
    sizes expert capacity to the worst case, so routing never depends on
    the prefill chunk length.  With ``collect`` a dict, the router's top-k
    expert ids land in ``collect["moe_ids"]`` [B, T, K] (on the device):
    what the serving loop reads to stream only the experts a step needs."""
    B, T, d = x.shape
    G = _num_groups(B)
    bg = B // G                                      # sequences per group
    ct = max(1, MOE_CHUNK_TOKENS // B)
    if T > ct and T % ct == 0:
        nc = T // ct
        xc = x.reshape(G, bg, nc, ct, d).permute(2, 0, 1, 3, 4).reshape(nc, G, bg * ct, d)
        outs = [_dispatch_moe(xc[i], p, cfg, dispatch, full_capacity) for i in range(nc)]
        y = torch.stack([o[0] for o in outs]).reshape(nc, G, bg, ct, d)
        y = y.permute(1, 2, 0, 3, 4).reshape(B, T, d)
        if collect is not None:
            ids = torch.stack([o[2] for o in outs])
            ids = ids.reshape(nc, G, bg, ct, ids.shape[-1]).permute(1, 2, 0, 3, 4)
            collect["moe_ids"] = ids.reshape(B, T, ids.shape[-1])
        return y, torch.stack([o[1] for o in outs]).mean(0)
    if B * T * cfg.experts_per_tok <= cfg.num_experts:
        y, aux, ids = _dispatch_moe_tiny(x.reshape(G, bg * T, d), p, cfg, dispatch)
    else:
        y, aux, ids = _dispatch_moe(x.reshape(G, bg * T, d), p, cfg, dispatch,
                                    full_capacity)
    if collect is not None:
        collect["moe_ids"] = ids.reshape(B, T, ids.shape[-1])
    return y.reshape(B, T, d), aux
