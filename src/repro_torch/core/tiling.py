"""Hardware-driven data reorder and tile selection (paper §5.1, C3) -- port
of ``repro.core.tiling``.

The paper's part, as the reference has it:

* ``solve_cpu_tiles`` -- the register-constrained optimizer (Eqs. 2-4):
  minimize the memory-access count

      e/e_p * h/h_p * (l*e_p + l*h_p + h_p*e_p)

  s.t. e_p + h_p + e_p*h_p <= R and l_p = the instruction width.  It
  reproduces the paper's Table 2 for its four CPU ISAs (``PAPER_ISAS``,
  ``PAPER_TABLE2``).
* ``reorder_shape_cpu`` / ``reorder_shape_gpu`` -- the paper's activation
  and weight layouts.
* ``hbm_traffic`` -- the bytes a tiled [M, K] x [K, N] matmul moves.

The reference's TPU analogue (``TPUSpec``, ``vmem_working_set``,
``solve_tpu_blocks``) sizes Pallas VMEM tiles on the (8, 128) lane grid and
has no counterpart here: tiles are the port's own.  The Hopper counterpart
of its choice is the W4A8 kernel's: ``kernel_tiles(M, N, K)`` returns the
tile the kernel's wrapper launches (``kernels.w4a8_matmul``: the 16- or
64-row tile, ``BN`` columns, ``BK`` deep, and its split-K count), read from
the wrapper so that the constants live in one place, and
``kernel_hbm_traffic`` evaluates ``hbm_traffic`` at that tile.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple


@dataclasses.dataclass(frozen=True)
class CPUISA:
    """R counts register *elements* available to the kernel (Eq. 3 budget);
    ``output_width`` pins h_p to the ISA's natural output-vector width
    (sdot: paired 4-lane int32 accumulators -> 8; smmla 2x2 tiles x4 -> 8;
    SSE 4-lane int32 pairs -> 8; AVX512-VNNI zmm = 64 int8 lanes -> 64)."""
    name: str
    register_budget: int        # R in Eq. 3
    instruction_width: int      # l_p in Eq. 4 (elements reduced per instr)
    output_width: int           # h_p pinned by the ISA's output vector


# The four ISAs of the paper's Table 2 (NEON sdot / NEON i8mm / SSE / AVX512)
PAPER_ISAS = (
    CPUISA("armv8-sdot", register_budget=116, instruction_width=4, output_width=8),
    CPUISA("armv8-i8mm", register_budget=106, instruction_width=8, output_width=8),
    CPUISA("x86-sse", register_budget=44, instruction_width=4, output_width=8),
    CPUISA("x86-avx512", register_budget=328, instruction_width=4, output_width=64),
)

PAPER_TABLE2 = {
    "armv8-sdot": (12, 8, 4),
    "armv8-i8mm": (10, 8, 8),
    "x86-sse": (4, 8, 4),
    "x86-avx512": (4, 64, 4),
}


def memory_access_count(e: int, h: int, l: int, ep: int, hp: int) -> float:
    """Eq. 2 objective (for the [e,l]x[h,l] -> [e,h] tiled matmul)."""
    return (e / ep) * (h / hp) * (l * ep + l * hp + hp * ep)


def solve_cpu_tiles(isa: CPUISA, *, e: int = 1024, h: int = 1024,
                    l: int = 1024,
                    ep_range: Iterable[int] = range(1, 129)) -> Tuple[int, int, int]:
    """Minimize Eq. 2 s.t. the Eq. 3 register constraint
    ``e_p + h_p + e_p*h_p <= R`` with h_p pinned to the ISA output width and
    l_p = instruction width (Eq. 4).  Reproduces the paper's Table 2."""
    hp = isa.output_width
    best, best_cost = None, float("inf")
    for ep in ep_range:
        # Eq. 3: activation tile elems + weight tile elems + accumulators
        if ep + hp + ep * hp > isa.register_budget:
            continue
        c = memory_access_count(e, h, l, ep, hp)
        if c < best_cost - 1e-9:
            best_cost, best = c, (ep, hp, isa.instruction_width)
    if best is None:
        raise ValueError(f"{isa.name}: no e_p in range meets the register budget")
    return best


def reorder_shape_cpu(e: int, l: int, ep: int, lp: int) -> tuple:
    """Paper's CPU activation layout [e/e_p, l/l_p, e_p, l_p]."""
    return (_ceil_div(e, ep), _ceil_div(l, lp), ep, lp)


def reorder_shape_gpu(l: int, h: int, lp: int = 32) -> tuple:
    """Paper's GPU weight layout [l/l_p, h, l_p] with l_p=32 (128-bit
    vectorized 4-bit loads)."""
    return (_ceil_div(l, lp), h, lp)


def hbm_traffic(M: int, N: int, K: int, bm: int, bn: int, bk: int,
                in_bytes: float, out_bytes: float = 4.0) -> float:
    """Bytes a tiled matmul moves from device memory: every (bm, bn) output
    tile reads its x and w tiles along K once (the accumulator stays on
    chip) and writes its output once."""
    gm, gn, gk = _ceil_div(M, bm), _ceil_div(N, bn), _ceil_div(K, bk)
    x_reads = gm * gn * gk * bm * bk * in_bytes
    w_reads = gm * gn * gk * bk * bn * in_bytes
    out_writes = gm * gn * bm * bn * out_bytes
    return x_reads + w_reads + out_writes


def kernel_tiles(M: int, N: int, K: int) -> Tuple[int, int, int, int]:
    """(rows, columns, depth, split-K count) of the tile the W4A8 kernel
    launches for an [M, K] x [K, N] product: what its wrapper chooses from
    the shapes alone."""
    from repro_torch.kernels import w4a8_matmul as WM
    return WM.tile_rows(M), WM.BN, WM.BK, WM.matmul_splits(M, N, K)


def kernel_hbm_traffic(M: int, N: int, K: int, in_bytes: float = 1.0,
                       out_bytes: float = 4.0) -> float:
    """``hbm_traffic`` at the tile ``kernel_tiles`` gives (int8 operands and
    a float32 output by default; the split-K partials' own traffic is not
    in Eq. 2's count)."""
    bm, bn, bk, _splits = kernel_tiles(M, N, K)
    return hbm_traffic(M, N, K, bm, bn, bk, in_bytes, out_bytes)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)
