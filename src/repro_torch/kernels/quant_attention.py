"""Decode attention over the quantized KV cache: wrappers + plain versions.

Ports of ``repro/kernels/quant_attention.py``: ``quant_decode_attention``
(dense cache; CUDA kernel ``csrc/decode_attention.cu``) and
``paged_quant_decode_attention`` (the paged pool; ``csrc/
paged_decode_attention.cu``).  Both kernels share their body
(``csrc/decode_attention.cuh``), split over the keys: ``decode_splits``
chooses the split count from shapes, and each wrapper hands the kernel a
cached scratch buffer for the partials and combine counters.  A block takes
up to ``HEAD_TILE`` query heads of one KV head (the rows of one tensor-core
tile); a group of more takes ``head_tiles(G)`` blocks a split.  The
kernels read int8 or int4 keys (nibble pairs, D / 2 bytes a row) and fp8
e4m3 or bf16 values, as the TPU kernels read values of any dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import kv_cache as kvc
from repro_torch.core import quantization as q
from repro_torch.kernels import loader

NEG_INF = -1e30
HEAD_TILE = 16       # query heads a block: the rows of one 16-row MMA tile
DENSE_BLOCK = 128    # slots of a dense cache the decode kernel reads as a page
TARGET_BLOCKS = 2 * 132   # about two blocks per SM of an H100
MAX_SPLITS = 256     # the kernels' bound (csrc/decode_attention.cuh)


def head_tiles(G: int) -> int:
    """Blocks a (row, KV head, split) takes for its G query heads."""
    return -(-G // HEAD_TILE)


def decode_splits(B: int, Hkv: int, n_blocks: int) -> int:
    """How many blocks share one (row, KV head) -- or, with ``Hkv`` counting
    KV heads times ``head_tiles(G)``, one head tile -- in the decode kernels:
    each takes a contiguous run of key blocks (pages, or ``DENSE_BLOCK``
    slots of a dense cache), so that B * Hkv * splits reaches at least
    ``TARGET_BLOCKS`` where there are enough key blocks.  Shapes only:
    reading ``length`` would make the host wait for the device."""
    if n_blocks <= 1:
        return 1
    want = min(n_blocks, max(1, -(-TARGET_BLOCKS // max(1, B * Hkv))))
    per = max(1, n_blocks // want, -(-n_blocks // MAX_SPLITS))   # key blocks a split
    return -(-n_blocks // per)               # no split left empty by rounding


def _scratch(dev: torch.device, pairs: int, splits: int, G: int,
             D: int) -> Optional[torch.Tensor]:
    """The decode kernels' scratch (``loader.scratch``): a combine counter
    for each of the ``pairs`` (row, KV head) pairs' head tiles, then their
    splits' partials (float32 max, denominator and acc [heads, D] each, for
    the tile's up to ``HEAD_TILE`` heads).  None for one split, which writes
    the output itself."""
    if splits == 1:
        return None
    tiles = pairs * head_tiles(G)
    return loader.scratch(dev, tiles, tiles * splits * min(G, HEAD_TILE) * (D + 2))


def gather_rows(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Pool array [P, page, ...] -> per-row dense view [B, n_pages*page, ...]
    in logical page order."""
    y = x[table.long()]
    return y.reshape(table.shape[0], y.shape[1] * y.shape[2], *y.shape[3:])


VARIANT_HEAD_DIMS = (64, 128)   # the head dims of every variant but int8 keys + fp8 values


def kernel_variant(q_: torch.Tensor, k_q: torch.Tensor, k_scale: torch.Tensor,
                   k_zero: torch.Tensor, v: torch.Tensor, key_bits: int,
                   head_dims=None) -> tuple:
    """What the CUDA attention kernels over the quantized cache take (the
    decode kernels; the paged prefill kernel with ``head_dims``): int8 keys
    of last dim D or int4 keys of last dim D / 2 (nibble pairs), fp8 e4m3
    or bf16 values.  Returns (key_bits, 1 for bf16 values else 0), the
    kernels' variant arguments; anything else raises on the card."""
    D = q_.shape[-1]
    if key_bits not in (4, 8) or k_q.shape[-1] != D * key_bits // 8:
        raise NotImplementedError(f"keys of {key_bits} bits, last dim {k_q.shape[-1]} "
                                  f"for D={D}: the kernels read int8 or int4 keys")
    if v.dtype not in (q.FP8_DTYPE, torch.bfloat16):
        raise NotImplementedError(f"values {v.dtype}: the kernels read fp8 e4m3 or bf16")
    v_bf16 = int(v.dtype == torch.bfloat16)
    if head_dims is None:
        if (key_bits, v_bf16) == (8, 0):
            if D % 16 or D > 128:
                raise NotImplementedError(
                    f"D={D}: the kernel takes a multiple of 16 up to 128")
        elif D not in VARIANT_HEAD_DIMS:
            raise NotImplementedError(f"D={D} with int{key_bits} keys and {v.dtype} values: "
                                      f"the kernel takes D in {VARIANT_HEAD_DIMS}")
    elif D not in head_dims:
        raise NotImplementedError(f"D={D}: the kernel takes D in {head_dims}")
    if (k_q.dtype, k_scale.dtype, k_zero.dtype) != (torch.int8, torch.float32,
                                                    torch.float32):
        raise TypeError("cache dtypes must be int8 key codes, float32 scale/zero")
    if q_.dtype != torch.bfloat16:
        raise TypeError(f"q dtype {q_.dtype}: the kernel reads bf16 queries")
    return key_bits, v_bf16


def quant_decode_attention_plain(
        q_: torch.Tensor, k_q: torch.Tensor, k_scale: torch.Tensor,
        k_zero: torch.Tensor, v: torch.Tensor, length, *,
        key_bits: int = 8, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The reference dense decode (``models.attention.decode_attention_ref``)
    op for op: keys dequantized to the compute dtype, bf16 scores with f32
    accumulation, f32 softmax over the slots below ``length`` (a scalar or
    [B]), probabilities cast to the compute dtype before P.V.  Returns f32
    [B, H, D] (the reference casts it to the compute dtype)."""
    B, H, D = q_.shape
    S, Hkv = k_q.shape[1], k_q.shape[2]
    G = H // Hkv
    k = kvc.dequantize_keys(k_q, k_scale, k_zero, compute_dtype, bits=key_bits)
    vv = v.to(compute_dtype)
    qg = q_.reshape(B, Hkv, G, D).to(compute_dtype)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float())
    length = torch.as_tensor(length, device=q_.device).long().reshape(-1)
    mask = torch.arange(S, device=q_.device)[None] < length[:, None]
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(compute_dtype).float(), vv.float())
    return out.reshape(B, H, D)


def quant_decode_attention(
        q_: torch.Tensor, k_q: torch.Tensor, k_scale: torch.Tensor,
        k_zero: torch.Tensor, v: torch.Tensor, length, *,
        key_bits: int = 8) -> torch.Tensor:
    """One pre-scaled query per row [B, H, D] (bf16 on the card) against a
    dense cache (k_q [B, S, Hkv, D(k)], k_scale/k_zero [B, S, Hkv], v
    [B, S, Hkv, D]); ``length`` the live prefix, a scalar for every row or
    [B] per row.  Returns f32 [B, H, D]."""
    B, H, D = q_.shape
    S, Hkv = k_q.shape[1], k_q.shape[2]
    if H % Hkv:
        raise ValueError(f"H={H} not a multiple of Hkv={Hkv}")
    if k_q.shape[0] != B or k_scale.shape != (B, S, Hkv) or v.shape != (B, S, Hkv, D):
        raise ValueError(f"cache k_q {tuple(k_q.shape)}, k_scale "
                         f"{tuple(k_scale.shape)}, v {tuple(v.shape)} for q "
                         f"{tuple(q_.shape)}")
    length = torch.as_tensor(length, device=q_.device).to(torch.int32).reshape(-1)
    if length.numel() not in (1, B):
        raise ValueError(f"length of {length.numel()} entries for B={B}")
    length = length.expand(B).contiguous()
    devs = {t.device for t in (q_, k_q, k_scale, k_zero, v)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    dev = q_.device
    if dev.type == "cpu":
        return quant_decode_attention_plain(q_, k_q, k_scale, k_zero, v, length,
                                            key_bits=key_bits)
    if dev.type != "cuda":
        raise NotImplementedError(f"no decode-attention kernel for {dev}")
    loader.refuse_grad("quant_decode_attention", q_, k_scale, k_zero, v)
    variant = kernel_variant(q_, k_q, k_scale, k_zero, v, key_bits)
    operands = (q_, k_q, k_scale, k_zero, v)
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("decode-attention operands must be contiguous")
    out = torch.empty((B, H, D), dtype=torch.float32, device=dev)
    if B * S == 0:
        return out.zero_()
    lib = loader.build()
    G = H // Hkv
    splits = decode_splits(B, Hkv * head_tiles(G), -(-S // DENSE_BLOCK))
    scratch = _scratch(dev, B * Hkv, splits, G, D)
    code = lib.decode_attention_launch(
        q_.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(), k_zero.data_ptr(),
        v.data_ptr(), length.data_ptr(), out.data_ptr(),
        0 if scratch is None else scratch.data_ptr(), B, S, Hkv, G, D, splits,
        *variant, loader.stream_ptr(dev))
    loader.check(code, "quant_decode_attention")
    quant_decode_attention.launches += 1
    return out


quant_decode_attention.launches = 0


class QuantDecodeAttentionFunction(torch.autograd.Function):
    """``quant_decode_attention`` under autograd (training's cross attention
    of an encoder-decoder: every query token over the encoder's quantized
    K/V, folded into the head axis by the dispatcher): the forward launches
    the kernel through the wrapper and saves its operands; the backward is
    autograd of ``quant_decode_attention_plain`` recomputed from them
    (``loader.plain_vjp``), the reference's ``decode_attention_ref``, which
    XLA differentiates.  Gradients reach q, ``k_scale``, ``k_zero`` and the
    values (fp8 values get an fp8 gradient, as XLA's cast transposes);
    the int8 key codes and ``length`` take none.  ``apply(q, k_q, k_scale,
    k_zero, v, length, key_bits)`` -> f32 [B, H, D]."""

    @staticmethod
    def forward(ctx, q_, k_q, k_scale, k_zero, v, length, key_bits):
        ctx.save_for_backward(q_, k_q, k_scale, k_zero, v, length)
        ctx.key_bits = key_bits
        return quant_decode_attention(q_, k_q, k_scale, k_zero, v, length, key_bits=key_bits)

    @staticmethod
    def backward(ctx, grad):
        q_, k_q, k_scale, k_zero, v, length = ctx.saved_tensors
        needs = ctx.needs_input_grad
        grads = loader.plain_vjp(
            lambda a, b, c, d: quant_decode_attention_plain(a, k_q, b, c, d, length,
                                                            key_bits=ctx.key_bits),
            (q_, k_scale, k_zero, v), (needs[0], needs[2], needs[3], needs[4]), grad)
        return grads[0], None, grads[1], grads[2], grads[3], None, None


def paged_quant_decode_attention_plain(
        q_: torch.Tensor, k_q: torch.Tensor, k_scale: torch.Tensor,
        k_zero: torch.Tensor, v: torch.Tensor, table: torch.Tensor,
        base: torch.Tensor, length: torch.Tensor, *, window: int = 0,
        key_bits: int = 8, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The reference paged decode (``kv_pool.paged_decode_attention_ref``)
    op for op: keys dequantized to the compute dtype, bf16 scores with f32
    accumulation, f32 softmax, probabilities cast to the compute dtype
    before P.V.  Returns f32 [B, H, D] (the reference casts it to the
    compute dtype)."""
    B, H, D = q_.shape
    Hkv = k_q.shape[-2]
    G = H // Hkv
    ps = k_q.shape[1]
    k = kvc.dequantize_keys(gather_rows(k_q, table), gather_rows(k_scale, table),
                            gather_rows(k_zero, table), compute_dtype,
                            bits=key_bits)                       # [B,S,Hkv,D]
    vv = gather_rows(v, table).to(compute_dtype)
    S = k.shape[1]
    qg = q_.reshape(B, Hkv, G, D).to(compute_dtype)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float())
    kpos = (base.long()[:, None] * ps
            + torch.arange(S, device=q_.device)[None])
    length = length.long()[:, None]
    mask = (kpos >= 0) & (kpos < length)
    if window:
        mask = mask & (kpos >= length - window)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(compute_dtype).float(), vv.float())
    return out.reshape(B, H, D)


def paged_quant_decode_attention(
        q_: torch.Tensor, k_q: torch.Tensor, k_scale: torch.Tensor,
        k_zero: torch.Tensor, v: torch.Tensor, table: torch.Tensor,
        base: torch.Tensor, length: torch.Tensor, *, window: int = 0,
        key_bits: int = 8) -> torch.Tensor:
    """One pre-scaled query per row [B, H, D] (bf16 on the card) against its pool pages
    (pool arrays [P, page, Hkv, D(k)]) through ``table`` [B, n_pages];
    ``base`` [B] is the logical page of table column 0, ``length`` [B] the
    live prefix.  Returns f32 [B, H, D]."""
    B, H, D = q_.shape
    P, ps, Hkv = k_q.shape[0], k_q.shape[1], k_q.shape[2]
    if H % Hkv:
        raise ValueError(f"H={H} not a multiple of Hkv={Hkv}")
    if table.shape[0] != B or base.shape != (B,) or length.shape != (B,):
        raise ValueError(f"table {tuple(table.shape)}, base {tuple(base.shape)}, "
                         f"length {tuple(length.shape)} for B={B}")
    devs = {t.device for t in (q_, k_q, k_scale, k_zero, v, table, base, length)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    dev = q_.device
    if dev.type == "cpu":
        return paged_quant_decode_attention_plain(
            q_, k_q, k_scale, k_zero, v, table, base, length, window=window,
            key_bits=key_bits)
    if dev.type != "cuda":
        raise NotImplementedError(f"no decode-attention kernel for {dev}")
    loader.refuse_grad("paged_quant_decode_attention", q_, k_scale, k_zero, v)
    variant = kernel_variant(q_, k_q, k_scale, k_zero, v, key_bits)
    if {table.dtype, base.dtype, length.dtype} != {torch.int32}:
        raise TypeError("table/base/length must be int32")
    operands = (q_, k_q, k_scale, k_zero, v, table, base, length)
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("decode-attention operands must be contiguous")
    out = torch.empty((B, H, D), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lib = loader.build()
    G, n_pages = H // Hkv, table.shape[1]
    splits = decode_splits(B, Hkv * head_tiles(G), n_pages)
    scratch = _scratch(dev, B * Hkv, splits, G, D)
    code = lib.paged_decode_attention_launch(
        q_.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(), k_zero.data_ptr(),
        v.data_ptr(), table.data_ptr(), base.data_ptr(), length.data_ptr(),
        out.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
        B, Hkv, G, D, ps, n_pages, int(window), splits, *variant, loader.stream_ptr(dev))
    loader.check(code, "paged_quant_decode_attention")
    paged_quant_decode_attention.launches += 1
    return out


paged_quant_decode_attention.launches = 0
