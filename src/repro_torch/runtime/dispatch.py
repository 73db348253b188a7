"""Kernel dispatch for the serving paths — port of ``repro.runtime.dispatch``
(ops ``linear``, ``grouped_matmul``, ``rmsnorm``, ``decode_attention``,
``paged_decode_attention``, ``prefill_attention``,
``paged_prefill_attention``).

Each op calls its kernel's wrapper (``repro_torch.kernels``), which picks
by the tensors' device: the plain PyTorch version for CPU tensors, the
Hopper kernel for CUDA tensors — or it raises.  Unlike the reference, the
dispatcher never falls back: a configuration the kernels do not take on
the card raises ``NotImplementedError`` there, so a run that finishes went
through the kernels.  ``fallbacks`` stays empty by construction; callers
assert it.

The quantized linears have two paths, chosen by name from facts known
before the call, on every device.  The integer path (W4A8 / W8A8 with
per-channel scales) runs kernel 1 or 5.  The float path, taken whenever
``act_bits == 16`` or the weight has more than one scale group, is the
reference's own (``repro.core.quantization.quant_matmul``, whose kernels
refuse both): ``float_matmul`` dequantizes the weight to bf16 and
multiplies with float32 sums, TF32 off.  No TPU kernel computes it, so
``torch.matmul`` does; its calls are counted in ``float_matmul.launches``
(``repro_torch.kernels.counts``), beside the kernels' launches.
Where the reference's dense decode kernel refuses a windowed ring and
falls back, the port runs its kernel over the ring's live slots (see
``decode_attention``).  Where it refuses T > 1 query tokens a row and
falls back (an encoder-decoder's cross attention at prefill: every prompt
token over the encoder's K/V, no causal mask), the port folds the T tokens
into the query-head axis and runs the same kernel once, G' = T * G query
heads a KV head.

``backend="reference"`` runs the plain versions on any device — the only
use is holding the kernel path against the plain path on the card.

Training: a kernel's output carries no gradient (every wrapper refuses a
launch on tensors that require grad, ``kernels.loader.refuse_grad``), so
under grad mode on the card ``rmsnorm``, ``prefill_attention`` and
``decode_attention`` -- the kernels of the training forward, the last one
an encoder-decoder's cross attention -- run through their
``autograd.Function`` (the kernel forward, autograd of the plain version
backward; the JAX package has no backward kernel).  On the CPU their plain
versions are differentiable as they stand.

One linear has no kernel by design: the reference's unquantized (bf16)
weight, rwkv6's low-rank decay path, which the reference multiplies in XLA
(``_matmul_reference``), never in a Pallas kernel.  ``linear`` computes it
in float32 from the bf16 operands with ``torch.matmul`` on every device; it
is no fallback and is not recorded in ``fallbacks``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.core import kv_cache as kvc
from repro_torch.core import kv_pool as KP
from repro_torch.core import quantization as q
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.kernels import flash_prefill as FP
from repro_torch.kernels import grouped_matmul as GM
from repro_torch.kernels import quant_attention as QA
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import w4a8_matmul as WM
from repro_torch.runtime import plan as planlib

BACKENDS = ("kernel", "reference")


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _check_no_tf32(x: torch.Tensor) -> None:
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on: the float linears sum in float32")


def float_path(qcfg: q.QuantConfig, w) -> bool:
    """Whether a packed weight takes the reference's float path: A16, or
    group-wise scales (the integer correction term would be
    group-dependent)."""
    return qcfg.act_bits == 16 or w.scale.shape[-2] > 1


def float_matmul(x: torch.Tensor, w, qcfg: q.QuantConfig, out_dtype=torch.bfloat16, *,
                 ids: Optional[torch.Tensor] = None,
                 rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's float path (``quant_matmul``), op for op: the packed
    weight, padding sliced off, dequantized to bf16, then bf16 operands
    with float32 products and sums, cast to ``out_dtype``.  A
    ``PackedLinear`` takes x [..., K]; a layer-sliced ``PackedExpertLinear``
    takes x [G, E, C, K] -> [G, E, C, N] (the reference's per-expert
    ``quant_matmul``), with ``ids`` [E] naming each slab's expert in the
    whole table and ``rows`` [E, G] the live rows of each capacity segment:
    the rows past them are zeros, and their outputs are written +0.0, as
    the grouped kernel writes them.  Inside a CUDA graph the dequantized
    weight is a transient of the graph's pool."""
    _check_no_tf32(x)
    float_matmul.launches += 1
    if ids is not None:
        w = planlib.take_experts(w, ids)
    y = q.quant_matmul(x, planlib.unpack_linear(w), qcfg, out_dtype=out_dtype)
    if rows is not None:
        C = x.shape[2]
        live = torch.arange(C, device=x.device)[None, None] < rows.t()[..., None]
        y = torch.where(live[..., None], y, torch.zeros((), dtype=y.dtype, device=y.device))
    return y


float_matmul.launches = 0     # calls: counted as the kernel wrappers count launches


class Dispatcher:
    """Resolves every hot op of the serving path to a kernel wrapper (or,
    with ``backend="reference"``, to its plain version)."""

    def __init__(self, backend: str = "kernel"):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}; expected one of {BACKENDS}")
        self.backend = backend
        self.fallbacks: List[Tuple[str, str, str]] = []

    @property
    def _plain(self) -> bool:
        return self.backend == "reference"

    def linear(self, x: torch.Tensor, w, qcfg: q.QuantConfig,
               out_dtype=torch.bfloat16) -> torch.Tensor:
        """y = x @ w for a ``PackedLinear`` weight, or for a bf16 weight
        [K, N]: bf16 operands, float32 products and sums (TF32 stays off),
        cast to ``out_dtype`` -- the reference's ``preferred_element_type``
        float32 dot."""
        if torch.is_tensor(w):
            if w.dim() != 2:
                raise ValueError("stacked weights: slice one layer first")
            _check_no_tf32(x)
            y = torch.matmul(x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float())
            return y.to(out_dtype)
        if w.data.dim() != 2:
            raise ValueError("stacked weights: slice one layer first")
        if float_path(qcfg, w):
            return float_matmul(x, w, qcfg, out_dtype)
        lead, K = x.shape[:-1], x.shape[-1]
        if K != w.k:
            raise ValueError(f"reduction dim {K} != weight {w.k}")
        xq, sx = q.quantize_activations(x.reshape(-1, K))
        fn = WM.w4a8_matmul_plain if self._plain else WM.w4a8_matmul
        y = fn(xq, sx, w.data, w.scale[0], w.zero[0], bits=w.bits)
        return y[:, :w.n].reshape(*lead, w.n).to(out_dtype)

    def grouped_matmul(self, x: torch.Tensor, w, qcfg: q.QuantConfig,
                       out_dtype=torch.bfloat16, *, rows: Optional[torch.Tensor] = None,
                       ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Per-expert matmul x [G, E, C, K] @ w[e] [K, N] -> [G, E, C, N]
        for a layer-sliced ``PackedExpertLinear`` [E, Kp, Np(/2)]: the G*C
        rows of each expert are quantized per row and run as one slab.
        ``ids`` int32 [E'] (x then [G, E', C, K]): slab e of x meets expert
        ids[e] of the whole table, read in place on the card.  ``rows``
        int32 [E, G]: the live rows at the head of each (expert, group)
        capacity segment, the rest being zero rows the kernel skips.  Only
        shapes and dtypes are checked (an id out of range raises on the CPU;
        on the card a check would make the host wait)."""
        if w.data.dim() != 3:
            raise ValueError("stacked expert tables: slice one layer first")
        if x.dim() != 4:
            raise ValueError(f"grouped matmul wants [G, E, C, K], got {tuple(x.shape)}")
        G, E, C, K = x.shape
        if ids is None and E != w.data.shape[0]:
            raise ValueError(f"expert axis {E} != weight {w.data.shape[0]}")
        if ids is not None and (ids.dtype != torch.int32 or ids.shape != (E,)):
            raise ValueError(f"ids {ids.dtype} {tuple(ids.shape)}: int32 [{E}] wanted")
        if rows is not None and (rows.dtype != torch.int32 or rows.shape != (E, G)):
            raise ValueError(f"rows {rows.dtype} {tuple(rows.shape)}: int32 [{E}, {G}] wanted")
        if K != w.k:
            raise ValueError(f"reduction dim {K} != weight {w.k}")
        if G * C == 0:                       # empty capacity: no rows at all
            return torch.zeros((G, E, C, w.n), dtype=out_dtype, device=x.device)
        if float_path(qcfg, w):
            return float_matmul(x, w, qcfg, out_dtype, ids=ids, rows=rows)
        # a view when C == 1 and G > 1 (decode through the capacity dispatch):
        # quantizing it would keep its strides, and the kernel reads rows
        xq, sx = q.quantize_activations(
            x.movedim(1, 0).reshape(E, G * C, K).contiguous())
        fn = GM.grouped_matmul_plain if self._plain else GM.grouped_matmul
        y = fn(xq, sx, w.data, w.scale[:, 0], w.zero[:, 0], bits=w.bits, rows=rows, ids=ids)
        return y[..., :w.n].reshape(E, G, C, w.n).movedim(0, 1).to(out_dtype)

    def rmsnorm(self, x: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
        if self._plain:
            return RN.rmsnorm_plain(x, weight, eps)
        if x.is_cuda and _wants_grad(x, weight):
            return RN.RMSNormFunction.apply(x, weight, eps)
        return RN.rmsnorm(x, weight, eps)

    def decode_attention(self, qh: torch.Tensor, cache, pos,
                         policy: PrecisionPolicy, causal: bool = True) -> torch.Tensor:
        """Decode over a dense ``LayerKVCache``: qh [B, T, H, D] pre-scaled,
        ``pos`` the tokens written so far, a scalar or [B].  A windowed ring
        attends over its first min(pos, S) slots: a full ring holds exactly
        the last S positions, the keys the reference's mask admits, and the
        softmax does not depend on the order of its keys.

        T > 1 needs ``causal=False`` (cross attention at prefill, on a
        dense cache only; a self-attention step of T > 1 tokens would need
        a causal mask among them and raises): all T
        query tokens attend over the same first ``pos`` slots, as the
        reference's ``decode_attention_ref`` computes them (it masks dead
        slots only), so qh [B, T, Hkv, G, D] is folded to [B, Hkv * T * G,
        D] -- query head (t, g) of KV head k becomes head t * G + g of a
        group of T * G -- and runs as one call; the output unfolds to [B,
        T, H, D] (at T = 1 both are views).  The fold is chosen from shapes
        and the window alone: reading ``pos`` would make the host wait."""
        B, T, H, D = qh.shape
        if T != 1 and causal:
            raise ValueError("decode attends one query token per row; T > 1 tokens need "
                             "causal=False (cross attention: no mask among them)")
        if T != 1 and cache.window:
            raise ValueError("a windowed ring attends one query token per row")
        Hkv = cache.k_q.shape[-2]
        G = H // Hkv
        pos = kvc.live_slots(cache, pos)
        q = qh.reshape(B, T, Hkv, G, D).transpose(1, 2).reshape(B, Hkv * T * G, D)
        args = (q, cache.k_q, cache.k_scale, cache.k_zero, cache.v)
        if self._plain:
            out = QA.quant_decode_attention_plain(
                *args, pos, key_bits=cache.key_bits,
                compute_dtype=policy.compute_dtype)
        elif q.is_cuda and _wants_grad(q, cache.k_scale, cache.k_zero, cache.v):
            out = QA.QuantDecodeAttentionFunction.apply(*args, pos, cache.key_bits)
        else:
            out = QA.quant_decode_attention(*args, pos, key_bits=cache.key_bits)
        out = out.reshape(B, Hkv, T, G, D).transpose(1, 2).reshape(B, T, H, D)
        return out.to(policy.compute_dtype)

    def paged_decode_attention(self, qh: torch.Tensor, pool, table: torch.Tensor,
                               pos: torch.Tensor, policy: PrecisionPolicy,
                               base: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Decode over the paged pool: qh [B, 1, H, D] pre-scaled, ``pos``
        [B] live lengths, ``table`` [B, n_pages] and ``base`` [B] the
        logical page of its column 0 (None: 0; a ring view's may be
        negative); a windowed pool masks to its window."""
        B, T = qh.shape[:2]
        if T != 1:
            raise ValueError("decode attends one query token per row")
        if base is None:
            base = torch.zeros((B,), dtype=torch.int32, device=qh.device)
        args = (qh[:, 0], pool.k_q, pool.k_scale, pool.k_zero, pool.v, table,
                base, pos.to(torch.int32))
        if self._plain:
            out = QA.paged_quant_decode_attention_plain(
                *args, window=pool.window, key_bits=pool.key_bits,
                compute_dtype=policy.compute_dtype)
        else:
            out = QA.paged_quant_decode_attention(
                *args, window=pool.window, key_bits=pool.key_bits)
        return out[:, None].to(policy.compute_dtype)

    def prefill_attention(self, qh: torch.Tensor, kh: torch.Tensor,
                          vh: torch.Tensor, *, causal: bool, window: int,
                          policy: PrecisionPolicy) -> torch.Tensor:
        """Attention of pre-scaled queries qh [B, T, H, D] (query i at
        position i) over unquantized kh/vh [B, S, Hkv, D]."""
        if self._plain:
            out = FP.flash_prefill_attention_plain(qh, kh, vh, causal=causal,
                                                   window=window, policy=policy)
        elif qh.is_cuda and _wants_grad(qh, kh, vh):
            out = FP.FlashPrefillFunction.apply(qh, kh, vh, causal, window)
        else:
            out = FP.flash_prefill_attention(qh, kh, vh, causal=causal,
                                             window=window)
        return out.to(policy.compute_dtype)

    def paged_prefill_attention(self, qh: torch.Tensor, pool, table: torch.Tensor,
                                pos0, policy: PrecisionPolicy) -> torch.Tensor:
        """Prompt-chunk attention: qh [B, C, H, D] pre-scaled at absolute
        positions pos0 + arange(C) over ``table`` [B, pages_per_row];
        ``pos0`` an int or a one-element device tensor (the kernel reads
        it from device memory)."""
        if pool.window:
            raise NotImplementedError(
                "windowed pools prefill through kv_pool.paged_prefill_window_ref, "
                "as in the reference, whose paged kernel refuses them; a kernel "
                "for that path is ROADMAP queue 2 item D")
        pos0_arr = KP.device_scalar(pos0, qh.device).expand(qh.shape[0]).contiguous()
        args = (qh, pool.k_q, pool.k_scale, pool.k_zero, pool.v, table, pos0_arr)
        if self._plain:
            out = FP.paged_flash_prefill_attention_plain(
                *args, key_bits=pool.key_bits, policy=policy)
        else:
            out = FP.paged_flash_prefill_attention(*args, key_bits=pool.key_bits)
        return out.to(policy.compute_dtype)
