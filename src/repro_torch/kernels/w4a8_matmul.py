"""W4A8 / W8A8 quantized matmul: wrapper + plain version.

Port of ``repro/kernels/w4a8_matmul.py::w4a8_matmul``; the CUDA kernel is
``csrc/w4a8_matmul.cu``.  ``quantize_activations`` stays outside, as in the
reference dispatcher.

The kernel's launch is chosen on the host from shapes alone, never from a
tensor's values (that would make the host wait): ``tile_rows`` picks the
16-row tile for decode widths and the 64-row tile for prompt chunks, and
``matmul_splits`` how many contiguous K ranges (``k_ranges``) share each
output tile so that the grid fills the card.  The splits' int32 partials
are summed exactly, so the output does not depend on the split count.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import quantization as q
from repro_torch.kernels import loader

BK, BN = 64, 128          # the tile's K step and columns (csrc/w4a8_mma_tile.cuh)
SMS = 132                 # an H100's SMs
TARGET_BLOCKS = 2 * SMS   # two blocks an SM: the 64-row tile's residency limit
MIN_STEPS = 4             # K steps a split at least: the 4-stage cp.async ring fills
LONG_K = 128              # K steps from which the 64-row tile splits past half the SMs
MAX_GRID = 65535          # row tiles on grid y, column tiles on z


def tile_rows(M: int) -> int:
    """Rows of the kernel's output tile: 16 at decode widths, 64 above."""
    return 16 if M <= 16 else 64


@functools.lru_cache(maxsize=4096)
def matmul_splits(M: int, N: int, K: int) -> int:
    """How many contiguous K ranges share one output tile, from shapes only.
    The last block of a tile sums every split's partial tile alone, so the
    splits are capped where, on an H100, that cost overtook the parallelism
    (``tools/matmul_splits_sweep.py``): the 16-row tile, while its tiles
    leave SMs without a block, takes enough splits for about
    ``TARGET_BLOCKS`` blocks, at most 8; the 64-row tile (bigger partials)
    takes 4 while its tiles leave half the SMs idle or K is long
    (``LONG_K``: the down projection), else 1.  Each range has at least
    ``MIN_STEPS`` whole 64-deep steps."""
    rows = tile_rows(M)
    tiles = -(-M // rows) * (N // BN)
    steps = K // BK
    if rows == 16:
        want = 1 if tiles >= SMS else min(-(-TARGET_BLOCKS // tiles), 8)
    elif tiles < TARGET_BLOCKS and (tiles <= SMS // 2 or steps >= LONG_K):
        want = 4
    else:
        want = 1
    return max(1, min(want, steps // MIN_STEPS))


def k_ranges(K: int, splits: int) -> List[Tuple[int, int]]:
    """The K range [begin, end) of each split, as the kernel takes them:
    split s has the 64-deep steps [s * nk // S, (s + 1) * nk // S)."""
    nk = K // BK
    return [(s * nk // splits * BK, (s + 1) * nk // splits * BK) for s in range(splits)]


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
                bits: int, splits: Optional[int] = None) -> torch.Tensor:
    """y [M, N] f32 from int8 activations xq [M, K] (K <= the weight's
    padded K; the wrapper zero-pads the rest) with per-row scales sx
    [M, 1] and int4/int8 weights w [Kp, N/2 | N] with per-channel
    scale/zero [N].  ``splits`` overrides ``matmul_splits`` (for tests:
    every count gives the same output)."""
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
    if not xq.is_cuda:
        devs = {t.device for t in (xq, sx, w, w_scale, w_zero)}
        if len(devs) != 1:
            raise ValueError(f"operands on several devices: {devs}")
        if xq.device.type == "cpu":
            return w4a8_matmul_plain(xq, sx, w, w_scale, w_zero, bits=bits)
        raise NotImplementedError(f"no w4a8_matmul kernel for {xq.device}")
    loader.refuse_grad("w4a8_matmul", sx, w_scale, w_zero)
    idx = xq.get_device()
    if sx.get_device() != idx or w.get_device() != idx or w_scale.get_device() != idx \
            or w_zero.get_device() != idx:
        raise ValueError("operands on several devices: "
                         f"{ {t.device for t in (xq, sx, w, w_scale, w_zero)} }")
    if Kp % BK or N % BN:
        raise NotImplementedError(f"K={Kp} must be a multiple of 64 and N={N} "
                                  "of 128 (the PackedLinear layout)")
    rows = tile_rows(M)
    if N // BN > MAX_GRID or -(-M // rows) > MAX_GRID:
        raise NotImplementedError(f"M={M}, N={N}: past the kernel's grid limits")
    if splits is None:
        splits = matmul_splits(M, N, Kp)
    elif not 1 <= splits <= Kp // BK:
        raise ValueError(f"splits={splits} for {Kp // BK} K steps")
    if K < Kp:
        xq = F.pad(xq, (0, Kp - K))
    if not (xq.is_contiguous() and sx.is_contiguous() and w.is_contiguous()
            and w_scale.is_contiguous() and w_zero.is_contiguous()):
        raise ValueError("w4a8_matmul operands must be contiguous")
    ptrs = (xq.data_ptr(), sx.data_ptr(), w.data_ptr(), w_scale.data_ptr(),
            w_zero.data_ptr())
    if ptrs[0] % 16 or ptrs[2] % 16 or ptrs[3] % 16 or ptrs[4] % 16:
        raise ValueError("w4a8_matmul reads xq, w, scale and zero in 16-byte "
                         "pieces: all must be 16-byte aligned")
    dev = xq.device
    y = sx.new_empty((M, N))                 # float32 on the card (cheaper than torch.empty)
    if M == 0:
        return y
    scratch = None
    if splits > 1:
        row_tiles, col_tiles = -(-M // rows), N // BN
        mp = row_tiles * rows
        scratch = loader.scratch(dev, row_tiles * col_tiles,
                                 splits * (mp * N + col_tiles * mp))
    code = loader.build().w4a8_matmul_launch(
        *ptrs, y.data_ptr(), 0 if scratch is None else scratch.data_ptr(), M, N, Kp, bits,
        rows, splits, loader.stream_ptr(dev))
    loader.check(code, "w4a8_matmul")
    w4a8_matmul.launches += 1
    return y


w4a8_matmul.launches = 0
