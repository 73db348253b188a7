"""Recurrent layers — port of ``repro.models.ssm``: Mamba (jamba's recurrent
layer) and RWKV6 "Finch", with entry and exit state.

Neither layer keeps a KV cache: its state is the cache.  Mamba carries the
causal conv's last ``d_conv - 1`` inputs (bf16) and the selective SSM's
state h [d_inner, d_state] (float32); RWKV6 the two token-shift rows (bf16)
and the wkv matrix [H, dh, dh] a row (float32).

Mamba: h_t = exp(A dt_t) h_{t-1} + dt_t B_t x_t, y_t = C_t h_t + D x_t.  The
scan runs in fixed ``SCAN_BLOCK``-token blocks: inside a block the
combine tree of ``jax.lax.associative_scan`` at length 8 (``_assoc_scan``
follows its recursion), across blocks a sequential fold from the entry
state.  The reduction order therefore depends on the block, never on T, and
any partition of a prompt into chunks whose boundaries fall on multiples
of 8 reduces in the same order as one pass.

RWKV6: data-dependent per-channel decay w_t = exp(-exp(w0 + lora(x_t))):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
scanned token by token in float32 (decode is one step).  The outer
products k v^T are formed ``RWKV_CHUNK`` tokens at a time (the reference's
piece, there for its backward pass): at rwkv6's width they take 1 MiB a
token and row.  The fold's order is the same whatever the pieces.

``valid_len`` (a padded prompt chunk's real tokens) masks the padded tail
to exact scan identities through ``where`` -- a = 1, b = 0 for mamba, the
state kept as it was for rwkv -- and the exit state is taken at the last
real token, so a padded chunk leaves the state an unpadded one would.  It
is an int or a one-element int32 device tensor: every pick by it is an
``index_select`` on the device, so a CUDA graph replays the step for any
value.  There is no TPU kernel for either scan (the reference computes both
in XLA); both run as plain PyTorch on every device, and autograd
differentiates both for training (the per-block and per-token pieces are
``unbind`` views, whose backward is one stack).  The reference's
``abstract_mamba_state`` / ``abstract_rwkv_state`` have no counterpart:
``meta`` tensors give the states' shapes.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert as CV
from repro_torch.configs.base import ModelConfig
from repro_torch.core import kv_pool as KP
from repro_torch.models import layers as L
from repro_torch.runtime import dispatch as D
from repro_torch.runtime import plan as RP

MAMBA_CHUNK = 512
RWKV_CHUNK = 256

# Fixed block of the mamba scan: the combine tree inside a block depends on
# this constant alone, so chunk boundaries on its multiples keep the
# reduction order of a whole-prompt pass.  The engine's chunk schedule
# aligns every chunk to it (runtime/plan.py, which imports no model code).
SCAN_BLOCK = 8
assert SCAN_BLOCK == RP.CHUNK_ALIGN


def _valid(valid, device: torch.device) -> Optional[torch.Tensor]:
    """None, or ``valid`` as a one-element int32 tensor on ``device``."""
    return None if valid is None else KP.device_scalar(valid, device)


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


# ===========================================================================
# Mamba
# ===========================================================================

def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_inner = cfg.mamba_expand * cfg.d_model
    dt_rank = max(1, math.ceil(cfg.d_model / 16))
    return d_inner, dt_rank, cfg.mamba_d_state


def mamba_params(b: L.ParamBuilder, cfg: ModelConfig, lead: tuple = ()) -> dict:
    d = cfg.d_model
    d_inner, dt_rank, d_state = mamba_dims(cfg)
    return {
        "in_proj": b.linear(d, 2 * d_inner, lead=lead),
        "conv_w": b.param((cfg.mamba_d_conv, d_inner), lead=lead),
        "conv_b": b.param((d_inner,), lead=lead, scale=0.0),
        "x_proj": b.linear(d_inner, dt_rank + 2 * d_state, lead=lead),
        "dt_proj": b.linear(dt_rank, d_inner, lead=lead, scale=0.1),
        "dt_bias": b.param((d_inner,), lead=lead, scale=0.0),
        "A_log": b.param((d_inner, d_state), lead=lead, scale=1.0, dtype=torch.float32),
        "D": b.param((d_inner,), lead=lead, scale=1.0, dtype=torch.float32),
        "out_proj": b.linear(d_inner, d, lead=lead),
    }


def init_mamba_state(batch: int, cfg: ModelConfig, lead: tuple = (),
                     device: torch.device = torch.device("cpu")) -> dict:
    d_inner, _, d_state = mamba_dims(cfg)
    return {"conv": torch.zeros((*lead, batch, cfg.mamba_d_conv - 1, d_inner),
                                dtype=torch.bfloat16, device=device),
            "ssm": torch.zeros((*lead, batch, d_inner, d_state), dtype=torch.float32,
                               device=device)}


def _take(x: torch.Tensor, dim: int, start: int, stop: Optional[int] = None,
          step: int = 1) -> torch.Tensor:
    return x[(slice(None),) * dim + (slice(start, stop, step),)]


def _combine(e1, e2):
    """h = a2 (a1 h + b1) + b2: the earlier element first."""
    (a1, b1), (a2, b2) = e1, e2
    return a2 * a1, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along ``dim`` (even one longer or as
    long as odd)."""
    n = odd.shape[dim]
    pairs = torch.stack([_take(even, dim, 0, n), odd], dim=dim + 1).flatten(dim, dim + 1)
    if even.shape[dim] > n:
        pairs = torch.cat([pairs, _take(even, dim, n)], dim=dim)
    return pairs


def _assoc_scan(a: torch.Tensor, b: torch.Tensor, dim: int):
    """Inclusive scan of ``_combine`` along ``dim`` with the combine tree of
    ``jax.lax.associative_scan``: pairs reduced, the half-length scan
    recursed, the even elements filled in from it."""
    n = a.shape[dim]
    if n < 2:
        return a, b
    ra, rb = _combine((_take(a, dim, 0, n - 1, 2), _take(b, dim, 0, n - 1, 2)),
                      (_take(a, dim, 1, None, 2), _take(b, dim, 1, None, 2)))
    oa, ob = _assoc_scan(ra, rb, dim)
    rest = (_take(a, dim, 2, None, 2), _take(b, dim, 2, None, 2))
    if n % 2 == 0:
        m = oa.shape[dim] - 1
        ea, eb = _combine((_take(oa, dim, 0, m), _take(ob, dim, 0, m)), rest)
    else:
        ea, eb = _combine((oa, ob), rest)
    ea = torch.cat([_take(a, dim, 0, 1), ea], dim=dim)
    eb = torch.cat([_take(b, dim, 0, 1), eb], dim=dim)
    return _interleave(ea, oa, dim), _interleave(eb, ob, dim)


def selective_scan(a: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + bx_t over a [B, T, d, S] float32 block from the
    entry state h0 [B, d, S], T a multiple of ``SCAN_BLOCK``: the associative
    scan inside each block, a sequential fold across blocks.  Returns every
    h_t [B, T, d, S].  The blocks are stacked, not written into a buffer,
    so autograd differentiates the scan (training) with the same bits."""
    B, T = a.shape[:2]
    nb = T // SCAN_BLOCK
    aa, hh = _assoc_scan(a.reshape(B, nb, SCAN_BLOCK, *a.shape[2:]),
                         bx.reshape(B, nb, SCAN_BLOCK, *bx.shape[2:]), dim=2)
    blocks = []
    s = h0
    # unbind: one backward for every block, where a select's backward would
    # write a zero tensor of the whole scan's size a block
    for a_k, h_k in zip(aa.unbind(1), hh.unbind(1)):
        blocks.append(a_k * s[:, None] + h_k)
        s = blocks[-1][:, -1]
    if nb == 1:         # a serving chunk or decode step: no copy of h
        return blocks[0]
    return torch.stack(blocks, dim=1).reshape(B, T, *a.shape[2:])


def _mamba_inner(xz: torch.Tensor, p: dict, cfg: ModelConfig, conv_in: torch.Tensor,
                 ssm_in: torch.Tensor, dispatch: D.Dispatcher, valid=None):
    """Shared prefill/decode math over xz [B, T, 2 d_inner].  conv_in [B,
    d_conv - 1, d_inner] is the causal conv's left context, ssm_in [B,
    d_inner, d_state] the entry state; ``valid`` (None: T) the real tokens.
    Returns (y [B, T, d_inner] bf16, conv_out, ssm_out)."""
    d_inner, dt_rank, d_state = mamba_dims(cfg)
    x, z = xz.chunk(2, dim=-1)
    B_, T = x.shape[:2]
    dev = x.device
    valid = _valid(valid, dev)
    dc = cfg.mamba_d_conv
    xc = torch.cat([conv_in.to(x.dtype), x], dim=1)
    if dc > 1:
        if valid is None:
            conv_out = xc[:, -(dc - 1):]
        else:
            # tokens [valid - (dc-1), valid) sit at xc[valid : valid + dc - 1];
            # valid == 0 gives conv_in back
            idx = (valid + torch.arange(dc - 1, device=dev, dtype=torch.int32)).long()
            conv_out = xc.index_select(1, idx)
    else:
        conv_out = conv_in
    w = p["conv_w"]
    xconv = 0
    for i in range(dc):                       # bf16 products and sums, in order
        xconv = xconv + xc[:, i:i + T] * w[i][None, None]
    xconv = _silu((xconv + p["conv_b"][None, None]).float())
    dbc = L.apply_linear(xconv.to(torch.bfloat16), p["x_proj"], cfg.quant, dispatch,
                         out_dtype=torch.float32)
    dt, Bm, Cm = torch.split(dbc, [dt_rank, d_state, d_state], dim=-1)
    dt = L.apply_linear(dt.to(torch.bfloat16), p["dt_proj"], cfg.quant, dispatch,
                        out_dtype=torch.float32)
    # jax.nn.softplus is logaddexp(x, 0) (F.softplus turns linear above 20)
    dt = dt + p["dt_bias"][None, None].float()
    dt = torch.logaddexp(dt, torch.zeros_like(dt))
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt[..., None] * A[None, None])             # [B, T, d, S]
    bx = dt[..., None] * Bm[:, :, None, :] * xconv[..., None]
    if valid is not None:
        live = (torch.arange(T, device=dev) < valid)[None, :, None, None]
        a = torch.where(live, a, torch.ones((), dtype=a.dtype, device=dev))
        bx = torch.where(live, bx, torch.zeros((), dtype=bx.dtype, device=dev))
    Tp = -(-T // SCAN_BLOCK) * SCAN_BLOCK
    if Tp != T:                               # pad with scan identities
        a = torch.cat([a, a.new_ones((B_, Tp - T, d_inner, d_state))], dim=1)
        bx = torch.cat([bx, bx.new_zeros((B_, Tp - T, d_inner, d_state))], dim=1)
    h = selective_scan(a, bx, ssm_in)[:, :T]
    if valid is None:
        ssm_out = h[:, T - 1]
    else:
        # the state after the last real token, never a padded position
        last = h.index_select(1, (valid - 1).clamp(min=0).long())[:, 0]
        ssm_out = torch.where(valid > 0, last, ssm_in)
    y = torch.einsum("btds,bts->btd", h, Cm)
    y = y + p["D"][None, None] * xconv
    y = y * _silu(z.float())
    return y.to(torch.bfloat16), conv_out, ssm_out


def mamba_forward(x: torch.Tensor, p: dict, cfg: ModelConfig, state: dict,
                  dispatch: D.Dispatcher, valid_len=None) -> Tuple[torch.Tensor, dict]:
    """A prompt (or chunk) x [B, T, d] from the entry ``state``; returns
    (out [B, T, d], exit state).  Past ``MAMBA_CHUNK`` tokens (T a multiple of
    it) the scan runs a piece at a time, carrying the state: [B, T, d_inner,
    d_state] float32 is 1 MiB a token and row at jamba's width.  Outputs at
    padded positions (>= ``valid_len``) are never read."""
    B, T, _ = x.shape
    xz = L.apply_linear(x, p["in_proj"], cfg.quant, dispatch)
    if T > MAMBA_CHUNK and T % MAMBA_CHUNK == 0:
        vl = _valid(T if valid_len is None else valid_len, x.device)
        conv_c, ssm_c, ys = state["conv"], state["ssm"], []
        for off in range(0, T, MAMBA_CHUNK):
            y, conv_c, ssm_c = _mamba_inner(xz[:, off:off + MAMBA_CHUNK], p, cfg, conv_c,
                                            ssm_c, dispatch,
                                            valid=(vl - off).clamp(0, MAMBA_CHUNK))
            ys.append(y)
        y = torch.cat(ys, dim=1)
    else:
        y, conv_c, ssm_c = _mamba_inner(xz, p, cfg, state["conv"], state["ssm"], dispatch,
                                        valid=valid_len)
    out = L.apply_linear(y, p["out_proj"], cfg.quant, dispatch)
    return out, {"conv": conv_c, "ssm": ssm_c}


def mamba_decode(x: torch.Tensor, p: dict, cfg: ModelConfig, state: dict,
                 dispatch: D.Dispatcher) -> Tuple[torch.Tensor, dict]:
    """One token a row (the same math at T == 1)."""
    return mamba_forward(x, p, cfg, state, dispatch)


# ===========================================================================
# RWKV6 (Finch)
# ===========================================================================

def rwkv_dims(cfg: ModelConfig) -> Tuple[int, int]:
    dh = cfg.rwkv_head_dim
    if cfg.d_model % dh:
        raise ValueError(f"d_model {cfg.d_model} is not a multiple of the head {dh}")
    return cfg.d_model // dh, dh


def rwkv_params(b: L.ParamBuilder, cfg: ModelConfig, lead: tuple = ()) -> dict:
    d = cfg.d_model
    H, dh = rwkv_dims(cfg)
    lora = 64
    return {
        "mu": b.param((5, d), lead=lead, scale=0.5),   # token-shift mix: r, k, v, w, g
        "w0": b.param((d,), lead=lead, scale=0.1, dtype=torch.float32),
        "wA": b.linear(d, lora, lead=lead, bits=16),    # the decay's low-rank path
        "wB": b.linear(lora, d, lead=lead, bits=16),
        "u": b.param((H, dh), lead=lead, scale=0.1, dtype=torch.float32),
        "wr": b.linear(d, d, lead=lead),
        "wk": b.linear(d, d, lead=lead),
        "wv": b.linear(d, d, lead=lead),
        "wg": b.linear(d, d, lead=lead),
        "wo": b.linear(d, d, lead=lead),
        "ln_x": b.norm(d, lead),
        "cm_mu": b.param((2, d), lead=lead, scale=0.5),  # channel mix (the FFN)
        "cm_k": b.linear(d, cfg.d_ff, lead=lead),
        "cm_v": b.linear(cfg.d_ff, d, lead=lead),
        "cm_r": b.linear(d, d, lead=lead),
    }


def init_rwkv_state(batch: int, cfg: ModelConfig, lead: tuple = (),
                    device: torch.device = torch.device("cpu")) -> dict:
    H, dh = rwkv_dims(cfg)
    return {"x_tm": torch.zeros((*lead, batch, cfg.d_model), dtype=torch.bfloat16,
                                device=device),
            "x_cm": torch.zeros((*lead, batch, cfg.d_model), dtype=torch.bfloat16,
                                device=device),
            "wkv": torch.zeros((*lead, batch, H, dh, dh), dtype=torch.float32,
                               device=device)}


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """[B, T, d] -> the previous token's rows (the carried row first)."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _shift_exit(x: torch.Tensor, valid_len) -> torch.Tensor:
    """The last real token's row, x[:, valid_len - 1] (x[:, -1] unpadded)."""
    valid = _valid(valid_len, x.device)
    if valid is None:
        return x[:, -1]
    return x.index_select(1, (valid - 1).clamp(min=0).long())[:, 0]


def wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, S: torch.Tensor, live: Optional[torch.Tensor] = None):
    """The wkv recurrence over float32 r, k, v, w [B, T, H, dh] from the entry
    state S [B, H, dh, dh], u [H, dh]; ``live`` [T] bool marks the real
    tokens (None: all), a padded step leaving S as it was.  Returns (y [B, T,
    H, dh], exit state)."""
    ys = []
    # per-token views by unbind, whose backward stacks the tokens' gradients
    # once: a select's backward would write a zero tensor of the whole
    # [B, t, H, dh, dh] piece (1 GiB at rwkv6's width and 4 x 256 tokens) a token
    rs, ws = r.unbind(1), w.unbind(1)
    for c0 in range(0, r.shape[1], RWKV_CHUNK):
        piece = slice(c0, c0 + RWKV_CHUNK)
        kv = k[:, piece, ..., :, None] * v[:, piece, ..., None, :]   # [B, t, H, dh, dh]
        ukv = u[None, None, :, :, None] * kv
        for i, (kv_t, ukv_t) in enumerate(zip(kv.unbind(1), ukv.unbind(1))):
            t = c0 + i
            ys.append(torch.einsum("bhi,bhij->bhj", rs[t], S + ukv_t))
            nxt = ws[t][..., None] * S + kv_t
            S = nxt if live is None else torch.where(live[t], nxt, S)
    return torch.stack(ys, dim=1), S


def rwkv_time_mix(x: torch.Tensor, p: dict, cfg: ModelConfig, state: dict,
                  dispatch: D.Dispatcher, valid_len=None) -> Tuple[torch.Tensor, dict]:
    """Entry state in, exit state out (the scan is sequential, so chunked
    calls fold in a whole pass's order; padded steps keep the state)."""
    B, T, d = x.shape
    H, dh = rwkv_dims(cfg)
    q = cfg.quant
    dx = _token_shift(x, state["x_tm"]) - x
    mu = p["mu"]
    xr, xk, xv, xw, xg = (x + dx * mu[i][None, None] for i in range(5))
    r = L.apply_linear(xr, p["wr"], q, dispatch).reshape(B, T, H, dh)
    k = L.apply_linear(xk, p["wk"], q, dispatch).reshape(B, T, H, dh)
    v = L.apply_linear(xv, p["wv"], q, dispatch).reshape(B, T, H, dh)
    g = L.apply_linear(xg, p["wg"], q, dispatch)
    lo = L.tanh_xla(L.apply_linear(xw, p["wA"], q, dispatch, out_dtype=torch.float32))
    wlo = L.apply_linear(lo.to(torch.bfloat16), p["wB"], q, dispatch, out_dtype=torch.float32)
    w = torch.exp(-torch.exp(p["w0"][None, None] + wlo)).reshape(B, T, H, dh)
    valid = _valid(valid_len, x.device)
    live = None if valid is None else torch.arange(T, device=x.device) < valid
    y, S = wkv_scan(r.float(), k.float(), v.float(), w, p["u"], state["wkv"], live)
    # per-head group norm, then the gate
    mean = y.mean(-1, keepdim=True)
    cen = y - mean
    var = (cen * cen).mean(-1, keepdim=True)
    yn = cen * torch.rsqrt(var + 1e-5)
    y = (yn.reshape(B, T, d) * p["ln_x"][None, None]).to(torch.bfloat16)
    y = y * _silu(g.float()).to(y.dtype)
    out = L.apply_linear(y, p["wo"], q, dispatch)
    return out, dict(state, x_tm=_shift_exit(x, valid_len), wkv=S)


def rwkv_channel_mix(x: torch.Tensor, p: dict, cfg: ModelConfig, state: dict,
                     dispatch: D.Dispatcher, valid_len=None) -> Tuple[torch.Tensor, dict]:
    """Entry/exit-state channel mix (the rwkv FFN)."""
    q = cfg.quant
    dx = _token_shift(x, state["x_cm"]) - x
    mu = p["cm_mu"]
    xk = x + dx * mu[0][None, None]
    xr = x + dx * mu[1][None, None]
    k = L.apply_linear(xk, p["cm_k"], q, dispatch, out_dtype=torch.float32)
    k = torch.square(torch.relu(k)).to(torch.bfloat16)
    kv = L.apply_linear(k, p["cm_v"], q, dispatch)
    r = L.apply_linear(xr, p["cm_r"], q, dispatch, out_dtype=torch.float32)
    out = torch.sigmoid(r).to(kv.dtype) * kv
    return out, dict(state, x_cm=_shift_exit(x, valid_len))


# ===========================================================================
# A row of the state, to and from the host (the KV Flash tier)
# ===========================================================================

def read_state_row(state: Dict[str, torch.Tensor], slot: int) -> Dict[str, np.ndarray]:
    """Row ``slot`` of every leaf of a stacked state ([count, B, ...]) as host
    arrays [count, 1, ...] by leaf name (bf16 as its int16 bits).  On the
    card the rows go to pinned memory without blocking, then the host waits
    once for the stream."""
    on_card = next(iter(state.values())).device.type == "cuda"
    host = {}
    for name in sorted(state):
        row = state[name][:, slot:slot + 1]
        buf = torch.empty(row.shape, dtype=row.dtype, pin_memory=on_card)
        buf.copy_(row, non_blocking=True)
        host[name] = buf
    if on_card:
        torch.cuda.current_stream(next(iter(state.values())).device).synchronize()
    return {name: CV.to_numpy(t) for name, t in host.items()}


def write_state_row(state: Dict[str, torch.Tensor], slot: int,
                    arrays: Dict[str, np.ndarray]) -> None:
    """Write ``read_state_row``'s arrays back into row ``slot``, in place,
    through pinned memory with a non-blocking copy a leaf."""
    for name, dst in state.items():
        row = dst[:, slot:slot + 1]
        src = arrays[name]
        if tuple(src.shape) != tuple(row.shape):
            raise ValueError(f"{name}: {src.shape} for a row of {tuple(row.shape)}")
        buf = torch.empty(row.shape, dtype=row.dtype, pin_memory=dst.device.type == "cuda")
        view = buf.view(torch.int16) if buf.dtype == torch.bfloat16 else buf
        view.numpy()[...] = src
        row.copy_(buf.to(dst.device, non_blocking=True))
