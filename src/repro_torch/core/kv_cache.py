"""Quantized KV cache (paper §4.2, Fig. 3) — port of ``repro.core.kv_cache``.

Keys are asymmetric int8 per (token, head) over head_dim (the fixed
reduction dim, so appends never disturb old scales); values are a
saturating fp8 e4m3 cast.  ``LayerKVCache`` is the dense per-sequence
cache of the slot-synchronous ``Engine.generate`` path, laid out
[B, max_seq, H_kv, D] as the reference's; a sliding-window layer's cache
is a ring of ``min(window, max_seq)`` slots, position p in slot p mod size.
The paged pool (``core.kv_pool``) shares the quantization below.  The reference's ``abstract_layer_cache``
(``ShapeDtypeStruct``s for its dry run) has no counterpart: the port's dry
run builds the cache from ``meta`` tensors."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import quantization as q


def quantize_keys(k: torch.Tensor, bits: int = 8):
    """-> (kq int8 [..., D] (bits=4: nibble pairs), scale f32 [...],
    zero f32 [...]).  Op for op the reference's float32 math."""
    kmin = k.amin(dim=-1).float()
    kmax = k.amax(dim=-1).float()
    # (kmax - kmin) / levels, as XLA computes it under jit: times the
    # float32 reciprocal of the constant
    recip = float(np.float32(1.0 / (15.0 if bits == 4 else 255.0)))
    lo = 0.0 if bits == 4 else -128.0
    hi = 15.0 if bits == 4 else 127.0
    scale = (kmax - kmin) * recip
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    zero = lo - kmin / scale
    kq = torch.round(k.float() / scale[..., None] + zero[..., None])
    kq = torch.clamp(kq, lo, hi).to(torch.int8)
    if bits == 4:
        kq = q.pack_int4(kq)
    return kq, scale, zero


def dequantize_keys(kq: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                    dtype=torch.bfloat16, bits: int = 8) -> torch.Tensor:
    if bits == 4:
        kq = q.unpack_int4(kq)
    return ((kq.float() - zero[..., None]) * scale[..., None]).to(dtype)


def cast_values(v_new: torch.Tensor, dtype) -> torch.Tensor:
    """Saturating fp8 conversion for e4m3 pools, plain cast otherwise."""
    if dtype == q.FP8_DTYPE:
        return q.to_fp8(v_new)
    return v_new.to(dtype)


@dataclasses.dataclass
class LayerKVCache:
    """One layer's quantized KV cache, or a stack of them (leading [L]
    axis on every field; ``layer(i)`` is a view of layer i).

    k_q int8 [B, S, H_kv, D] (key_bits=4: [.., D//2] nibble pairs);
    k_scale/k_zero float32 [B, S, H_kv]; v fp8 e4m3 [B, S, H_kv, D];
    length int32 [] or [B]: tokens written so far; ``window`` > 0: the
    cache is a ring of S = min(window, max_seq) slots."""
    k_q: torch.Tensor
    k_scale: torch.Tensor
    k_zero: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor
    window: int = 0
    key_bits: int = 8

    @property
    def max_seq(self) -> int:
        return self.k_q.shape[-3]

    def layer(self, i: int) -> "LayerKVCache":
        return LayerKVCache(self.k_q[i], self.k_scale[i], self.k_zero[i],
                            self.v[i], self.length[i], window=self.window,
                            key_bits=self.key_bits)


def init_layer_cache(batch: int, max_seq: int, kv_heads: int, head_dim: int,
                     *, window: int = 0, key_bits: int = 8,
                     value_fp8: bool = True, per_row: bool = False,
                     layers: int = 0,
                     device: torch.device = torch.device("cpu")) -> LayerKVCache:
    """Zero-initialized cache (scales start at 1, as in the reference);
    ``window``: a ring of min(window, max_seq) slots; ``per_row``: one
    length per row; ``layers``: a leading [layers] axis."""
    max_seq = min(window, max_seq) if window else max_seq
    kd = head_dim // 2 if key_bits == 4 else head_dim
    lead = (layers,) if layers else ()
    vdt = q.FP8_DTYPE if value_fp8 else torch.bfloat16
    return LayerKVCache(
        k_q=torch.zeros((*lead, batch, max_seq, kv_heads, kd), dtype=torch.int8,
                        device=device),
        k_scale=torch.ones((*lead, batch, max_seq, kv_heads), dtype=torch.float32,
                           device=device),
        k_zero=torch.zeros((*lead, batch, max_seq, kv_heads), dtype=torch.float32,
                           device=device),
        v=torch.zeros((*lead, batch, max_seq, kv_heads, head_dim), dtype=vdt,
                      device=device),
        length=torch.zeros((*lead, *((batch,) if per_row else ())),
                           dtype=torch.int32, device=device),
        window=window, key_bits=key_bits)


def quantized_cache(k: torch.Tensor, v: torch.Tensor, *, key_bits: int = 8,
                    value_fp8: bool = True) -> LayerKVCache:
    """A cache of exactly the S tokens k/v [B, S, H_kv, D], built out of
    place from ``quantize_keys`` and ``cast_values`` (what ``append`` at
    position 0 writes into an ``init_layer_cache`` of S slots): training's
    cross caches, whose scale, zero and values carry a gradient as the
    reference's do.  The key codes pass none (the rounding's gradient is
    zero, the int8 cast cuts it); the fp8 cast stays in the graph, so the
    values' cotangent is rounded to e4m3 on its way back, as XLA's is."""
    kq, ks, kz = quantize_keys(k, bits=key_bits)
    vdt = q.FP8_DTYPE if value_fp8 else torch.bfloat16
    length = torch.tensor(k.shape[1], dtype=torch.int32, device=k.device)
    return LayerKVCache(kq, ks, kz, cast_values(v, vdt), length, key_bits=key_bits)


def roundtrip_kv(k: torch.Tensor, v: torch.Tensor, *, key_bits: int = 8,
                 v_dtype, dtype=torch.bfloat16):
    """Quantize-then-dequantize a K/V chunk: exactly the values the cache
    stores and decode reads back."""
    kq, ks, kz = quantize_keys(k, bits=key_bits)
    return (dequantize_keys(kq, ks, kz, dtype, bits=key_bits),
            cast_values(v, v_dtype).to(dtype))


def append(cache: LayerKVCache, k_new: torch.Tensor, v_new: torch.Tensor,
           pos) -> LayerKVCache:
    """Write ``t`` new tokens' K/V (k_new/v_new [B, t, H_kv, D]) at
    positions [pos, pos + t), quantizing on the way in.  ``pos`` is a
    scalar (all rows aligned) or a [B] vector of per-row positions.
    Unlike the reference, the cache arrays are written in place; the
    returned cache shares them and carries ``length = pos + t``.

    A ring (``window``) takes position p in slot p mod S.  Where t > S the
    reference's scatter meets duplicate slots, applied in order on the CPU
    so that the last write wins, and undefined on CUDA; only the last S
    positions are written here, so each slot holds the largest position
    that maps to it, as in the reference on the CPU."""
    b, t = k_new.shape[:2]
    kq, ks, kz = quantize_keys(k_new, bits=cache.key_bits)
    v_cast = cast_values(v_new, cache.v.dtype)
    dev = k_new.device
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    size = cache.max_seq
    if cache.window and t > size:
        kq, ks, kz, v_cast = (x[:, t - size:] for x in (kq, ks, kz, v_cast))
        start, t_w = pos + (t - size), size
    else:
        start, t_w = pos, t
    steps = torch.arange(t_w, device=dev)
    if pos.dim() == 1:
        rows = torch.arange(b, device=dev)[:, None]
        slots = (start[:, None] + steps[None]).long()            # [B, t]
        if cache.window:
            slots = slots % size
        index = (rows, slots)
    elif cache.window:
        index = (slice(None), (start.long() + steps) % size)
    else:
        # the reference's dynamic_update_slice clamps the start so that the
        # whole update fits; the start stays on the device (no sync)
        slots = pos.clamp(0, cache.max_seq - t).long() + steps
        index = (slice(None), slots)
    cache.k_q[index] = kq
    cache.k_scale[index] = ks
    cache.k_zero[index] = kz
    cache.v[index] = v_cast
    return dataclasses.replace(cache, length=pos + t)


def live_slots(cache: LayerKVCache, pos) -> torch.Tensor:
    """How many leading slots hold live tokens after ``pos`` tokens (a
    scalar or [B]): pos, or for a ring min(pos, S) -- a full ring holds the
    last S positions, the keys the reference's ``slot_positions >= 0``
    mask admits."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=cache.k_q.device)
    return torch.clamp(pos, max=cache.max_seq) if cache.window else pos


def valid_mask(cache: LayerKVCache, pos) -> torch.Tensor:
    """Slots holding live tokens: pos scalar -> [S]; pos [B] -> [B, S]."""
    n = live_slots(cache, pos)
    idx = torch.arange(cache.max_seq, device=n.device)
    if n.dim() == 1:
        n = n[:, None]
    return idx < n


def slot_positions(cache: LayerKVCache, pos) -> torch.Tensor:
    """The absolute position stored in each slot, -1 where none: pos scalar
    -> [S]; pos [B] -> [B, S].  A ring's slot s holds the largest p < pos
    with p = s mod S."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=cache.k_q.device)
    size = cache.max_seq
    idx = torch.arange(size, device=pos.device)
    if pos.dim() == 1:
        pos = pos[:, None]
    if cache.window:
        p = idx + torch.div(pos - 1 - idx, size, rounding_mode="floor") * size
        return torch.where((p >= 0) & (p < pos), p, torch.full_like(p, -1))
    return torch.where(idx < pos, idx, torch.full_like(idx, -1))
