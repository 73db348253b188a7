"""Geometry compute (paper §5.4, C6) -- port of ``repro.core.geometry``.

Long-tail data-rearrangement operators (Transpose / Gather / Concat /
Slice) are abstracted as affine address maps

    f(x) = offset + stride . x            (Eq. 5)

over a 3-D iteration space -- a **Region**.  A Region says: for every index
vector x in [0, size), element  dst[dst_offset + dst_stride.x] =
src[src_offset + src_stride.x].  Any rearrangement op is one or more
Regions; chains of rearrangement ops compose *affinely*, so consecutive
Regions can be **fused** into one (the paper's automatic Region Fusion via
loop unrolling / interchange / tiling / fusion), halving the reads+writes
per eliminated intermediate.

Regions, their builders and the fusion are host-side integer logic, kept
in numpy as in the reference, so every Region and fused ``Plan`` equals the
reference's field for field.  ``execute_regions`` / ``execute_plan`` take
a tensor on any device and run each Region as one flat gather and scatter
(``out[di] = flat[si]``, the index tensors built on the tensor's device
from the Region's offsets and strides): a fused
Region is one pass over memory instead of one per materialized
intermediate.  The reference runs this in XLA, not in a Pallas kernel, so
the plain PyTorch version is the port.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

VDIM = 3   # Regions use rank-3 iteration spaces (paper: length-3 offset/stride)


@dataclasses.dataclass(frozen=True)
class Region:
    """One affine mapping between a flat src buffer and a flat dst buffer."""
    size: tuple            # (s0, s1, s2) iteration space
    src_offset: int
    src_stride: tuple      # (3,)
    dst_offset: int
    dst_stride: tuple      # (3,)

    @property
    def numel(self) -> int:
        return int(np.prod(self.size))

    def src_indices(self) -> np.ndarray:
        """Flat src index for every point of the iteration space (row-major
        over ``size``)."""
        g = np.indices(self.size).reshape(VDIM, -1)
        return self.src_offset + np.asarray(self.src_stride) @ g

    def dst_indices(self) -> np.ndarray:
        g = np.indices(self.size).reshape(VDIM, -1)
        return self.dst_offset + np.asarray(self.dst_stride) @ g


def _pad3(t: Sequence[int], fill: int) -> tuple:
    t = tuple(t)
    assert len(t) <= VDIM
    return (fill,) * (VDIM - len(t)) + t


def _contig_strides(shape: Sequence[int]) -> tuple:
    s, acc = [], 1
    for d in reversed(shape):
        s.append(acc)
        acc *= d
    return tuple(reversed(s))


# ---------------------------------------------------------------------------
# Region builders for the long-tail ops
# ---------------------------------------------------------------------------

def region_identity(shape) -> List[Region]:
    shape3 = _pad3(shape, 1) if len(shape) <= VDIM else (int(np.prod(shape)), 1, 1)
    st = _contig_strides(shape3)
    return [Region(size=shape3, src_offset=0, src_stride=st,
                   dst_offset=0, dst_stride=st)]


def region_transpose(shape, perm) -> List[Region]:
    """dst = src.transpose(perm); shapes of rank <= 3."""
    assert len(shape) == len(perm) <= VDIM
    shape3 = _pad3(shape, 1)
    perm3 = tuple(range(VDIM - len(perm))) + tuple(p + VDIM - len(perm) for p in perm)
    src_st = _contig_strides(shape3)
    out_shape = tuple(shape3[p] for p in perm3)
    out_st = _contig_strides(out_shape)
    # iterate over OUTPUT space; src stride d follows perm
    dst_stride = out_st
    src_stride = tuple(src_st[perm3[d]] for d in range(VDIM))
    return [Region(size=out_shape, src_offset=0, src_stride=src_stride,
                   dst_offset=0, dst_stride=dst_stride)]


def region_slice(shape, starts, sizes) -> List[Region]:
    shape3 = _pad3(shape, 1)
    starts3 = _pad3(starts, 0)
    sizes3 = _pad3(sizes, 1)
    src_st = _contig_strides(shape3)
    dst_st = _contig_strides(sizes3)
    off = int(np.dot(starts3, src_st))
    return [Region(size=sizes3, src_offset=off, src_stride=src_st,
                   dst_offset=0, dst_stride=dst_st)]


def region_concat(shapes, axis: int) -> List[List[Region]]:
    """Concat of n inputs along ``axis``; returns one Region list per input
    (each mapping that input into the shared output buffer)."""
    shapes3 = [_pad3(s, 1) for s in shapes]
    axis3 = axis + (VDIM - len(shapes[0]))
    out_shape = list(shapes3[0])
    out_shape[axis3] = sum(s[axis3] for s in shapes3)
    out_st = _contig_strides(out_shape)
    regions, run = [], 0
    for s in shapes3:
        src_st = _contig_strides(s)
        dst_off = run * out_st[axis3]
        regions.append([Region(size=s, src_offset=0, src_stride=src_st,
                               dst_offset=dst_off, dst_stride=out_st)])
        run += s[axis3]
    return regions


def region_gather_rows(shape, rows: Sequence[int]) -> List[Region]:
    """dst[i] = src[rows[i]] for 2-D src [n, m]: one Region per contiguous
    run of rows (runs fuse into strided Regions when evenly spaced)."""
    n, m = shape
    regions = []
    rows = list(rows)
    i = 0
    while i < len(rows):
        j = i + 1
        while j < len(rows) and rows[j] == rows[j - 1] + 1:
            j += 1
        cnt = j - i
        regions.append(Region(size=(1, cnt, m),
                              src_offset=rows[i] * m, src_stride=(0, m, 1),
                              dst_offset=i * m, dst_stride=(0, m, 1)))
        i = j
    return regions


# ---------------------------------------------------------------------------
# Fusion (the paper's automatic Region Fusion)
# ---------------------------------------------------------------------------

def try_fuse(first: Region, second: Region) -> Region | None:
    """Fuse ``second ∘ first`` when first's dst space feeds second's src
    space: produce a Region mapping first.src -> second.dst directly.

    Rule 1 (loop fusion): identical traversal of the intermediate —
    compose trivially.
    Rule 2 (loop interchange / tiling): numerically invert first's dst map
    over the addresses second actually reads (second may read a *subset*,
    e.g. a slice after a transpose), then re-fit a strided Region.
    Guarded to small iteration spaces; larger chains simply stay staged.
    """
    # Rule 1: same iteration space order
    if (first.size == second.size
            and first.dst_stride == second.src_stride
            and first.dst_offset == second.src_offset):
        return Region(size=first.size,
                      src_offset=first.src_offset, src_stride=first.src_stride,
                      dst_offset=second.dst_offset, dst_stride=second.dst_stride)
    # Rule 2: numeric composition (subset reads allowed)
    if first.numel <= 1 << 18 and second.numel <= 1 << 18:
        mid_addr = first.dst_indices()
        src_addr = first.src_indices()
        inv = {int(m): int(s) for m, s in zip(mid_addr, src_addr)}
        want = second.src_indices()
        try:
            src = np.asarray([inv[int(m)] for m in want])
        except KeyError:
            return None   # second reads addresses first never wrote
        dst = second.dst_indices()
        return _rediscover_region(src, dst)
    return None


def _rediscover_region(src: np.ndarray, dst: np.ndarray) -> Region | None:
    """Fit flat (src[i], dst[i]) pairs back into a single affine Region.

    Sort by dst, then look for a 1-to-3-level nested-loop structure in src.
    """
    o = np.argsort(dst, kind="stable")
    src, dst = src[o], dst[o]
    n = len(dst)
    # dst must be affine in the (sorted) iteration: constant stride
    if n > 1 and len(set(np.diff(dst).tolist())) > 1:
        return None
    dst_stride = int(dst[1] - dst[0]) if n > 1 else 1
    # find nested structure in src: try splits n = s0*s1*s2
    def fits(sizes):
        g = np.indices(sizes).reshape(VDIM, -1)
        # solve src = off + st.g  using first occurrences
        st = []
        for d in range(VDIM):
            idx = np.zeros(VDIM, dtype=int)
            if sizes[d] > 1:
                idx[d] = 1
                flat = int(np.ravel_multi_index(idx, sizes))
                st.append(int(src[flat] - src[0]))
            else:
                st.append(0)
        pred = src[0] + np.asarray(st) @ g
        return (st if np.array_equal(pred, src) else None)
    for s1 in _divisors(n):
        for s2 in _divisors(n // s1):
            s0 = n // (s1 * s2)
            st = fits((s0, s1, s2))
            if st is not None:
                return Region(size=(s0, s1, s2),
                              src_offset=int(src[0]), src_stride=tuple(st),
                              dst_offset=int(dst[0]),
                              dst_stride=tuple(np.asarray(
                                  _contig_strides((s0, s1, s2))) * dst_stride))
    return None


def _divisors(n: int):
    return [d for d in range(1, n + 1) if n % d == 0]


@dataclasses.dataclass
class Plan:
    """Fused execution plan: a list of stages, each materializing one
    intermediate buffer (the last stage is the output)."""
    stages: List[tuple]    # (regions: List[Region], out_numel: int)

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    @property
    def memory_ops(self) -> int:
        """Reads + writes performed (the quantity the paper's fusion cuts:
        each eliminated stage removes one full read+write pass)."""
        return sum(2 * r.numel for regs, _ in self.stages for r in regs)


def fuse_chain(chain: List[List[Region]], out_numels: List[int]) -> Plan:
    """Fuse a chain of rearrangement steps (step i = Region list writing a
    buffer of out_numels[i]) into as few stages as possible."""
    assert chain and len(chain) == len(out_numels)
    stages: List[tuple] = [(list(chain[0]), out_numels[0])]
    for step, numel in zip(chain[1:], out_numels[1:]):
        prev_regs, _ = stages[-1]
        if len(prev_regs) == 1 and len(step) == 1:
            f = try_fuse(prev_regs[0], step[0])
            if f is not None:
                stages[-1] = ([f], numel)
                continue
        elif len(step) == 1:
            # many-writers (e.g. concat) then one reader: fuse each writer
            # through the reader when the reader covers them (fan-in fusion)
            fused_all = _fuse_fan_in(prev_regs, step[0])
            if fused_all is not None:
                stages[-1] = (fused_all, numel)
                continue
        stages.append((list(step), numel))
    return Plan(stages=stages)


def _fuse_fan_in(writers: List[Region], reader: Region) -> List[Region] | None:
    """Compose one reader through several writers (concat -> transpose etc.)."""
    if sum(w.numel for w in writers) > 1 << 18 or reader.numel > 1 << 18:
        return None
    inv = {}
    which = {}
    for wi, w in enumerate(writers):
        for m, s in zip(w.dst_indices(), w.src_indices()):
            inv[int(m)] = int(s)
            which[int(m)] = wi
    want = reader.src_indices()
    dst = reader.dst_indices()
    out: List[Region] = []
    for wi in range(len(writers)):
        sel = np.asarray([which.get(int(m), -1) == wi for m in want])
        if not sel.any():
            continue
        try:
            src = np.asarray([inv[int(m)] for m in want[sel]])
        except KeyError:
            return None
        reg = _rediscover_region(src, dst[sel])
        if reg is None:
            return None
        out.append(reg)
    if any(which.get(int(m)) is None for m in want):
        return None
    return out


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------

def _flat_indices(size: tuple, offset: int, stride: tuple,
                  device: torch.device) -> torch.Tensor:
    """``offset + stride . x`` for every x of the iteration space in
    row-major order (``Region.src_indices`` / ``dst_indices``), built on
    ``device`` from three ``arange``s: nothing crosses from the host."""
    i0, i1, i2 = (torch.arange(int(n), device=device) for n in size)
    idx = (int(offset) + int(stride[0]) * i0[:, None, None]
           + int(stride[1]) * i1[None, :, None] + int(stride[2]) * i2[None, None, :])
    return idx.reshape(-1)


def execute_regions(regions: List[Region], src: torch.Tensor,
                    out_numel: int) -> torch.Tensor:
    """Run one stage's Regions: one flat gather + scatter per Region, on
    ``src``'s device."""
    flat = src.reshape(-1)
    out = torch.zeros((out_numel,), dtype=src.dtype, device=src.device)
    for r in regions:
        si = _flat_indices(r.size, r.src_offset, r.src_stride, src.device)
        di = _flat_indices(r.size, r.dst_offset, r.dst_stride, src.device)
        out[di] = flat[si]
    return out


def execute_plan(plan: Plan, src: torch.Tensor) -> torch.Tensor:
    buf = src
    for regions, numel in plan.stages:
        buf = execute_regions(regions, buf, numel)
    return buf
