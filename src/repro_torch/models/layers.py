"""Shared layers and the parameter builder — port of ``repro.models.layers``
(the serving parts: linear, RMSNorm, RoPE and M-RoPE, the SwiGLU and gelu
FFNs; the MoE FFN is ``models.moe``).

Hot ops (every linear matmul and every RMSNorm) route through the
``runtime.dispatch.Dispatcher``: Hopper kernels for CUDA tensors, their
plain PyTorch versions for CPU tensors.  Every cast sits where the
reference casts, so the CPU path reproduces the reference's bf16 rounding.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quantization as q
from repro_torch.runtime import dispatch as D
from repro_torch.runtime import plan as RP


class ParamBuilder:
    """Builds a model's parameters on ``device`` from a ``torch.Generator``:
    serving (``quantized``) linears in the packed kernel-native layout
    (``runtime.plan.PackedLinear``), training (``quantized=False``, the
    reference's float mode) every linear a bf16 tensor [*lead, in, out],
    expert tables included; bf16 biases (zero-initialized, as in the
    reference) and float32 norms (ones) either way.  Random weights are
    N(0, 0.02) in float32 before quantization or the bf16 cast, the
    reference's recipe; torch cannot reproduce JAX's random bits, so parity
    tests convert the reference's own parameters instead
    (``repro_torch.convert``).  With no ``generator`` (on the ``meta``
    device only) the builder draws nothing: every leaf gets the shape and
    dtype a drawn one would have, and no storage."""

    def __init__(self, generator: Optional[torch.Generator], device: torch.device,
                 qcfg: Optional[q.QuantConfig] = None, quantized: bool = True):
        self.gen = generator
        self.device = torch.device(device)
        if generator is None and self.device.type != "meta":
            raise ValueError("a builder without a generator builds on the meta device only")
        self.qcfg = qcfg or q.QuantConfig()
        self.quantized = quantized

    def norm(self, dim: int, lead: tuple = ()) -> torch.Tensor:
        return torch.ones((*lead, dim), dtype=torch.float32, device=self.device)

    def bias(self, dim: int, lead: tuple = ()) -> torch.Tensor:
        return torch.zeros((*lead, dim), dtype=torch.bfloat16, device=self.device)

    def param(self, shape: tuple, *, lead: tuple = (), scale: float = 0.02,
              dtype=torch.bfloat16) -> torch.Tensor:
        """A plain (never-quantized) parameter [*lead, *shape], N(0, scale)
        drawn in float32 and cast to ``dtype`` (the reference's builder
        default, bf16); as in the reference, ``scale`` 0 gives zeros and
        ``scale`` 1 ones for a vector."""
        full = (*lead, *shape)
        if scale == 0.0:
            return torch.zeros(full, dtype=dtype, device=self.device)
        if scale == 1.0 and len(shape) <= 1:
            return torch.ones(full, dtype=dtype, device=self.device)
        if self.gen is None:
            return torch.empty(full, dtype=dtype, device=self.device)
        return (torch.randn(full, generator=self.gen, device=self.device,
                            dtype=torch.float32) * scale).to(dtype)

    def linear(self, in_dim: int, out_dim: int, *, bits: Optional[int] = None,
               lead: tuple = (), scale: float = 0.02,
               experts: bool = False) -> dict:
        """{"w": PackedLinear} with data [*lead, Kp, Np/2 | Np] — a
        ``PackedExpertLinear`` for expert tables (``experts``, lead
        ``(count, E)``).  Each index of the first leading axis (one layer) is
        drawn separately, then quantized and packed one [in_dim, out_dim]
        slab (an expert) at a time into carriers allocated once (the scales
        are per column, so slab by slab is the whole table's quantization):
        the float32 transient is one layer's draw and nothing is stacked.
        ``bits`` 16 (the reference's unquantized linear) or a float builder:
        {"w": a bf16 tensor [*lead, in_dim, out_dim]}."""
        bits = self.qcfg.weight_bits if bits is None else bits
        if bits >= 16 or not self.quantized:
            return {"w": self.param((in_dim, out_dim), lead=lead, scale=scale)}
        cls = RP.PackedExpertLinear if experts else RP.PackedLinear
        gs = self.qcfg.group_size
        if self.gen is None:        # abstract: the packed carriers' shapes, stacked
            return {"w": cls(*(torch.empty((*lead, *shape), dtype=dtype, device=self.device)
                               for shape, dtype in RP.packed_layout(in_dim, out_dim, bits, gs)),
                             bits, in_dim, out_dim)}
        carriers = None
        for i in range(lead[0] if lead else 1):
            wf = torch.randn((*lead[1:], in_dim, out_dim), generator=self.gen,
                             device=self.device, dtype=torch.float32).mul_(scale)
            for j, slab in enumerate(wf.reshape(-1, in_dim, out_dim)):
                p = RP.pack_linear(q.quantize(slab, bits, group_size=gs))
                if not lead:
                    return {"w": cls(p.data, p.scale, p.zero, bits, p.k, p.n)}
                if carriers is None:
                    carriers = [torch.empty((*lead, *t.shape), dtype=t.dtype,
                                            device=self.device)
                                for t in (p.data, p.scale, p.zero)]
                for dst, src in zip(carriers, (p.data, p.scale, p.zero)):
                    dst[i].reshape(-1, *src.shape)[j] = src
            del wf
        return {"w": cls(*carriers, bits, p.k, p.n)}


def apply_linear(x: torch.Tensor, p: dict, qcfg: q.QuantConfig,
                 dispatch: D.Dispatcher, out_dtype=torch.bfloat16) -> torch.Tensor:
    """y = x @ w (+b) through the dispatcher (``w`` packed, or a bf16
    tensor for the unquantized linear)."""
    y = dispatch.linear(x, p["w"], qcfg, out_dtype=out_dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             dispatch: D.Dispatcher) -> torch.Tensor:
    return dispatch.rmsnorm(x, weight, eps)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


_ROPE_TABLES: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}


def rope_table(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_freqs`` as a float32 tensor on ``device``, built once per
    (head_dim, theta, device): building it copies from the host, which makes
    the host wait for the device and cannot be captured in a CUDA graph, so
    the first call must come outside any capture (the serving loop runs every
    step once before capturing it)."""
    key = (int(head_dim), float(theta), torch.device(device))
    table = _ROPE_TABLES.get(key)
    if table is None:
        table = torch.tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                             device=device)
        _ROPE_TABLES[key] = table
    return table


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, T, H, D]; positions [B, T] int -> x's dtype.  float32 math with
    the reference's op order (angles in float32, rotate-half layout)."""
    d = x.shape[-1]
    freqs = rope_table(d, theta, x.device)
    ang = positions[..., None].float() * freqs                      # [B,T,D/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


_MROPE_AXES: Dict[Tuple[Tuple[int, ...], torch.device], torch.Tensor] = {}


def mrope_axes(sections, device: torch.device) -> torch.Tensor:
    """Which position axis (0 = t, 1 = h, 2 = w) drives each of the D/2
    rotary frequencies: ``sections[a]`` consecutive frequencies per axis, an
    int64 index [sum(sections)] on ``device``, built once per (sections,
    device) from numpy, as ``rope_table`` is (a host copy: the first call
    must come outside any CUDA graph capture)."""
    key = (tuple(int(s) for s in sections), torch.device(device))
    axes = _MROPE_AXES.get(key)
    if axes is None:
        axes = torch.tensor(np.repeat(np.arange(3), np.asarray(key[0])),
                            dtype=torch.int64, device=device)
        _MROPE_AXES[key] = axes
    return axes


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE: x [B, T, H, D]; positions3 [B, T, 3] int
    (t, h, w) ids; the D/2 rotary frequencies split into per-axis
    ``sections`` (sum(sections) == D/2), frequency i turning by its axis's
    id.  float32 math in the reference's op order, as ``apply_rope``: with
    the same id on all three axes it is ``apply_rope`` bit for bit."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not cover D/2 = {d // 2}")
    freqs = rope_table(d, theta, x.device)
    pos = positions3.float().index_select(-1, mrope_axes(sections, x.device))  # [B,T,D/2]
    ang = pos * freqs
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def positional(qk: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """The config's rotary embedding of qk [B, T, H, D] at ``positions``
    [B, T] or, three-axis, [B, T, 3]: an M-RoPE model given [B, T] ids
    (text only) uses them on all three axes; a RoPE model given three-axis
    ids takes the t axis, as the reference does."""
    if cfg.rope_kind == "none":
        return qk
    if cfg.rope_kind == "mrope":
        if positions.dim() == 2:
            positions = positions[..., None].expand(*positions.shape, 3)
        return apply_mrope(qk, positions, cfg.rope_theta, cfg.mrope_sections)
    if positions.dim() == 3:
        positions = positions[..., 0]
    return apply_rope(qk, positions, cfg.rope_theta)


def swiglu(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """silu(gate) in float32, cast to x's dtype, times x (the reference's
    casts: ``jax.nn.silu`` is g * sigmoid(g))."""
    g = gate.float()
    return (g * torch.sigmoid(g)).to(x.dtype) * x


# Eigen's rational tanh, which XLA emits on the CPU: odd numerator and even
# denominator polynomials in x^2, Horner steps fused into FMAs, the input
# clamped to where the ratio reaches +-1, tanh(x) = x below 4e-4
_TANH_CLAMP = 7.99881172180175781
_TANH_NUM = (-2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
             5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
             4.89352455891786e-03)
_TANH_DEN = (1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
             4.89352518554385e-03)
_SQRT_2_OVER_PI = float(np.float32(np.sqrt(2 / np.pi)))


def _horner(x2: torch.Tensor, coeffs) -> torch.Tensor:
    acc = torch.full_like(x2, coeffs[0])
    for c in coeffs[1:]:
        acc = torch.addcmul(torch.full_like(x2, c), x2, acc)   # c + x2*acc, one FMA
    return acc


def tanh_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 tanh, bit for bit the one XLA computes on the CPU: torch's
    own tanh rounds differently in a third of the inputs, which the int8
    re-quantization of the next linear turns into whole code steps."""
    xc = x.clamp(-_TANH_CLAMP, _TANH_CLAMP)
    x2 = xc * xc
    ratio = (xc * _horner(x2, _TANH_NUM)) / _horner(x2, _TANH_DEN)
    return torch.where(x.abs() < 0.0004, x, ratio)


def gelu(u: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its tanh approximation) in float32, cast to u's
    dtype: 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))) with XLA's op
    order -- x^3 as x*x*x, the inner sum one FMA, XLA's tanh."""
    x = u.float()
    inner = _SQRT_2_OVER_PI * torch.addcmul(x, x * x * x, torch.full_like(x, 0.044715))
    return (x * (0.5 * (1.0 + tanh_xla(inner)))).to(u.dtype)


def _check_act(cfg: ModelConfig) -> None:
    if cfg.act not in ("swiglu", "gelu"):
        raise NotImplementedError(f"act={cfg.act!r}: the port runs swiglu and gelu FFNs, "
                                  "the reference configs' two")


def ffn_params(b: ParamBuilder, cfg: ModelConfig, lead: tuple = ()) -> dict:
    """swiglu: w_gate, w_up, w_down; gelu: w_up, w_down."""
    _check_act(cfg)
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_gate": b.linear(d, f, lead=lead)} if cfg.act == "swiglu" else {}
    p["w_up"] = b.linear(d, f, lead=lead)
    p["w_down"] = b.linear(f, d, lead=lead)
    return p


def apply_ffn(x: torch.Tensor, p: dict, cfg: ModelConfig,
              dispatch: D.Dispatcher) -> torch.Tensor:
    _check_act(cfg)
    if cfg.act == "swiglu":
        g = apply_linear(x, p["w_gate"], cfg.quant, dispatch)
        u = apply_linear(x, p["w_up"], cfg.quant, dispatch)
        h = swiglu(u, g)
    else:
        h = gelu(apply_linear(x, p["w_up"], cfg.quant, dispatch))
    return apply_linear(h, p["w_down"], cfg.quant, dispatch)
