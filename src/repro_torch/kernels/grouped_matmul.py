"""Grouped (per-expert) W4A8 / W8A8 matmul: wrapper + plain version.

Port of ``repro/kernels/grouped_matmul.py::grouped_matmul``; the CUDA kernel
is ``csrc/grouped_matmul.cu``.  ``quantize_activations`` stays outside, as in
the reference dispatcher.

Two optional int32 tables serve the MoE paths.  ``ids`` [E'] names the
weight slab of each activation slab (the selected-expert decode path hands
over the layer's whole table): the plain version gathers the slabs first,
as ``runtime.plan.take_experts`` does, and the kernel reads them in place.
``rows`` [E', G] gives the live rows of each of the G capacity segments of
an activation slab (the rows past them are zeros): the plain version
computes every row, as the Pallas kernel does, and the kernel skips the
16-row tiles that hold none.  Neither changes the function.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import quantization as q
from repro_torch.kernels import loader

MAX_GRID = 65535      # the kernel puts slabs on grid z and column tiles on y


def grouped_matmul_plain(xq: torch.Tensor, sx: torch.Tensor, w: torch.Tensor,
                         w_scale: torch.Tensor, w_zero: torch.Tensor, *,
                         bits: int, rows: Optional[torch.Tensor] = None,
                         ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's per-expert ``quant_matmul``, op for op, for every
    expert at once: y[e] = w_scale[e] * (xq[e] @ w[e] - w_zero[e] *
    rowsum(xq[e])) * sx[e], with an exact int32 dot and a fused correction.
    xq int8 [E, M, K]; sx f32 [E, M, 1]; w int8 [E, K, N/2] (int4 nibbles)
    or [E, K, N]; scale/zero f32 [E, N] -> f32 [E, M, N].  With ``ids``
    the slabs ids[e] of w/scale/zero are gathered first (``take_experts``'
    gather); ``rows`` is accepted and every row computed."""
    del rows
    if ids is not None:
        ids = ids.long()
        w, w_scale, w_zero = (torch.index_select(t, 0, ids) for t in (w, w_scale, w_zero))
    wq = q.unpack_int4(w) if bits == 4 else w
    if xq.shape[-1] < wq.shape[-2]:
        xq = F.pad(xq, (0, wq.shape[-2] - xq.shape[-1]))
    # one expert's float64 table at a time (the dot is exact either way):
    # jamba's whole [16, 24576, 8192] table would take 24 GiB
    acc = torch.stack([q.int_dot(xq[e], wq[e]) for e in range(wq.shape[0])])
    rowsum = xq.to(torch.int32).sum(dim=-1, keepdim=True)
    y = w_scale[:, None, :] * q.zero_correction(acc, w_zero[:, None, :], rowsum)
    return y * sx


def _check_tables(rows, ids, E: int, M: int, n_slabs: int) -> None:
    """Shapes and dtypes of the optional ``rows`` [E, G] and ``ids`` [E]
    tables (their values are not read: that would make the host wait)."""
    if ids is not None:
        if ids.dtype != torch.int32 or ids.shape != (E,):
            raise ValueError(f"ids {ids.dtype} {tuple(ids.shape)}: int32 [{E}] wanted")
    elif n_slabs != E:
        raise ValueError(f"expert axis: xq {E}, w {n_slabs}")
    if rows is not None:
        if rows.dtype != torch.int32 or rows.dim() != 2 or rows.shape[0] != E:
            raise ValueError(f"rows {rows.dtype} {tuple(rows.shape)}: int32 [{E}, G] wanted")
        if rows.shape[1] == 0 or M % rows.shape[1]:
            raise ValueError(f"rows {tuple(rows.shape)}: G must divide M={M}")


def grouped_matmul(xq: torch.Tensor, sx: torch.Tensor, w: torch.Tensor,
                   w_scale: torch.Tensor, w_zero: torch.Tensor, *,
                   bits: int, rows: Optional[torch.Tensor] = None,
                   ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y [E, M, N] f32 from per-expert int8 activations xq [E, M, K] (K <=
    the weight's padded K; the wrapper zero-pads the rest) with per-row
    scales sx [E, M, 1] and int4/int8 expert slabs w [E, Kp, N/2 | N] with
    per-channel scale/zero [E, N].  ``ids`` int32 [E]: slab e of xq meets
    weight slab ids[e] of a table with any number of slabs.  ``rows`` int32
    [E, G]: in each of the G segments of M / G rows of slab e only the
    first rows[e, g] rows hold data (the rest are zeros)."""
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}")
    if xq.dim() != 3 or w.dim() != 3:
        raise ValueError(f"xq {tuple(xq.shape)} / w {tuple(w.shape)}: 3-D only")
    E, M, K = xq.shape
    Kp = w.shape[1]
    N = w.shape[2] * (2 if bits == 4 else 1)
    n_slabs = w.shape[0]
    _check_tables(rows, ids, E, M, n_slabs)
    if (xq.dtype, sx.dtype, w.dtype) != (torch.int8, torch.float32, torch.int8):
        raise TypeError(f"dtypes {xq.dtype}, {sx.dtype}, {w.dtype}")
    if w_scale.dtype != torch.float32 or w_zero.dtype != torch.float32:
        raise TypeError("weight scale/zero must be float32")
    if sx.shape != (E, M, 1) or w_scale.shape != (n_slabs, N) or w_zero.shape != (n_slabs, N):
        raise ValueError(f"sx {tuple(sx.shape)}, scale {tuple(w_scale.shape)}, "
                         f"zero {tuple(w_zero.shape)} for E={E}, M={M}, N={N}")
    if K > Kp:
        raise ValueError(f"activation K={K} exceeds the weight's K={Kp}")
    tables = [t for t in (rows, ids) if t is not None]
    devs = {t.device for t in (xq, sx, w, w_scale, w_zero, *tables)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    dev = xq.device
    if dev.type == "cpu":
        return grouped_matmul_plain(xq, sx, w, w_scale, w_zero, bits=bits,
                                    rows=rows, ids=ids)
    if dev.type != "cuda":
        raise NotImplementedError(f"no grouped_matmul kernel for {dev}")
    loader.refuse_grad("grouped_matmul", sx, w_scale, w_zero)
    if Kp % 64 or N % 128:
        raise NotImplementedError(f"K={Kp} must be a multiple of 64 and N={N} "
                                  "of 128 (the PackedExpertLinear layout)")
    if E > MAX_GRID or N // 128 > MAX_GRID:
        raise NotImplementedError(f"E={E}, N={N}: past the kernel's grid limits")
    if K < Kp:
        xq = F.pad(xq, (0, Kp - K))
    tensors = (xq, sx, w, w_scale, w_zero, *tables)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("grouped_matmul operands must be contiguous")
    if xq.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("grouped_matmul reads xq and w in 16-byte copies: "
                         "both must be 16-byte aligned")
    y = torch.empty((E, M, N), dtype=torch.float32, device=dev)
    if E * M == 0:
        return y
    lib = loader.build()
    code = lib.grouped_matmul_launch(
        xq.data_ptr(), sx.data_ptr(), w.data_ptr(), w_scale.data_ptr(),
        w_zero.data_ptr(), y.data_ptr(), 0 if ids is None else ids.data_ptr(),
        0 if rows is None else rows.data_ptr(), E, M, N, Kp,
        1 if rows is None else rows.shape[1], bits, loader.stream_ptr(dev))
    loader.check(code, "grouped_matmul")
    grouped_matmul.launches += 1
    return y


grouped_matmul.launches = 0
