"""Fused RMSNorm: wrapper + plain version.

Port of ``repro/kernels/rmsnorm.py::rmsnorm``; the CUDA kernel is
``csrc/rmsnorm.cu``.  ``RMSNormFunction`` runs the kernel in a training
forward, with autograd of the plain version as its backward.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import loader


def rmsnorm_plain(x: torch.Tensor, weight: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """The reference dispatcher's entry op for op: float32 math, output in
    x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x [..., D] bf16/float32; weight [D] -> x's shape and dtype.  On the
    card the checks come first and each reads one cheap attribute: the
    wrapper's host time is most of what a call costs."""
    D = x.shape[-1]
    if weight.shape != (D,):
        raise ValueError(f"weight {tuple(weight.shape)} for D={D}")
    dtype = x.dtype
    if dtype != torch.bfloat16 and dtype != torch.float32:
        raise TypeError(f"x dtype {dtype}")
    if not x.is_cuda:
        if x.device != weight.device:
            raise ValueError(f"x on {x.device}, weight on {weight.device}")
        if x.device.type == "cpu":
            return rmsnorm_plain(x, weight, eps)
        raise NotImplementedError(f"no rmsnorm kernel for {x.device}")
    loader.refuse_grad("rmsnorm", x, weight)
    if not weight.is_cuda or weight.get_device() != x.get_device():
        raise ValueError(f"x on {x.device}, weight on {weight.device}")
    if weight.dtype != torch.float32:
        raise TypeError(f"weight dtype {weight.dtype}: the kernel takes float32")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rmsnorm operands must be contiguous")
    y = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return y
    code = loader.build().rmsnorm_launch(
        x.data_ptr(), weight.data_ptr(), y.data_ptr(), rows, D, float(eps),
        dtype == torch.bfloat16, loader.stream_ptr(x.device))
    loader.check(code, "rmsnorm")
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0


class RMSNormFunction(torch.autograd.Function):
    """``rmsnorm`` under autograd: the forward launches the kernel (through
    the wrapper, so a CPU tensor takes the plain version) and saves its
    inputs; the backward is autograd of ``rmsnorm_plain`` recomputed from
    them (``loader.plain_vjp``).  ``apply(x, weight, eps)``."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return rmsnorm(x, weight, eps)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        gx, gw = loader.plain_vjp(lambda a, w: rmsnorm_plain(a, w, ctx.eps), (x, weight),
                                  ctx.needs_input_grad[:2], grad)
        return gx, gw, None
