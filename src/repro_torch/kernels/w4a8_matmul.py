"""W4A8 / W8A8 quantized matmul: wrapper + plain version.

Port of ``repro/kernels/w4a8_matmul.py::w4a8_matmul``; the CUDA kernel is
``csrc/w4a8_matmul.cu``.  ``quantize_activations`` stays outside, as in the
reference dispatcher.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import quantization as q
from repro_torch.kernels import loader


def w4a8_matmul_plain(xq: torch.Tensor, sx: torch.Tensor, w: torch.Tensor,
                      w_scale: torch.Tensor, w_zero: torch.Tensor, *,
                      bits: int) -> torch.Tensor:
    """The reference dispatcher's integer path, op for op
    (``quant_matmul``): y = w_scale * (xq @ w - w_zero * rowsum(xq)) * sx,
    with an exact int32 dot and a fused correction term.  xq int8 [M, K]; sx f32 [M, 1]; w int8
    [K, N/2] (int4 nibbles) or [K, N]; scale/zero f32 [N] -> f32 [M, N]."""
    wq = q.unpack_int4(w) if bits == 4 else w
    if xq.shape[-1] < wq.shape[0]:
        xq = F.pad(xq, (0, wq.shape[0] - xq.shape[-1]))
    acc = q.int_dot(xq, wq)
    rowsum = xq.to(torch.int32).sum(dim=-1, keepdim=True)
    y = w_scale * q.zero_correction(acc, w_zero, rowsum)
    return y * sx


def w4a8_matmul(xq: torch.Tensor, sx: torch.Tensor, w: torch.Tensor,
                w_scale: torch.Tensor, w_zero: torch.Tensor, *,
                bits: int) -> torch.Tensor:
    """y [M, N] f32 from int8 activations xq [M, K] (K <= the weight's
    padded K; the wrapper zero-pads the rest) with per-row scales sx
    [M, 1] and int4/int8 weights w [Kp, N/2 | N] with per-channel
    scale/zero [N]."""
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}")
    if xq.dim() != 2 or w.dim() != 2:
        raise ValueError(f"xq {tuple(xq.shape)} / w {tuple(w.shape)}: 2-D only")
    M, K = xq.shape
    Kp = w.shape[0]
    N = w.shape[1] * (2 if bits == 4 else 1)
    if (xq.dtype, sx.dtype, w.dtype) != (torch.int8, torch.float32, torch.int8):
        raise TypeError(f"dtypes {xq.dtype}, {sx.dtype}, {w.dtype}")
    if w_scale.dtype != torch.float32 or w_zero.dtype != torch.float32:
        raise TypeError("weight scale/zero must be float32")
    if sx.shape != (M, 1) or w_scale.shape != (N,) or w_zero.shape != (N,):
        raise ValueError(f"sx {tuple(sx.shape)}, scale {tuple(w_scale.shape)}, "
                         f"zero {tuple(w_zero.shape)} for M={M}, N={N}")
    if K > Kp:
        raise ValueError(f"activation K={K} exceeds the weight's K={Kp}")
    devs = {t.device for t in (xq, sx, w, w_scale, w_zero)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    dev = xq.device
    if dev.type == "cpu":
        return w4a8_matmul_plain(xq, sx, w, w_scale, w_zero, bits=bits)
    if dev.type != "cuda":
        raise NotImplementedError(f"no w4a8_matmul kernel for {dev}")
    if Kp % 64 or N % 128:
        raise NotImplementedError(f"K={Kp} must be a multiple of 64 and N={N} "
                                  "of 128 (the PackedLinear layout)")
    if K < Kp:
        xq = F.pad(xq, (0, Kp - K))
    tensors = (xq, sx, w, w_scale, w_zero)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("w4a8_matmul operands must be contiguous")
    y = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0:
        return y
    lib = loader.build()
    code = lib.w4a8_matmul_launch(
        xq.data_ptr(), sx.data_ptr(), w.data_ptr(), w_scale.data_ptr(),
        w_zero.data_ptr(), y.data_ptr(), M, N, Kp, bits, loader.stream_ptr(dev))
    loader.check(code, "w4a8_matmul")
    w4a8_matmul.launches += 1
    return y


w4a8_matmul.launches = 0
