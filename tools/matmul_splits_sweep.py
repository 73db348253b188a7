#!/usr/bin/env python3
"""The dense matmul kernel's device time against its split of K, at the
serving paths' linears, so the split rule (``kernels/w4a8_matmul.py::
matmul_splits``) can be checked against what the card does.

    PYTHONPATH=src python3 tools/matmul_splits_sweep.py

For qwen2-7b's q/o, k/v, gate/up and down and moonshot-v1-16b-a3b's
2048 x 2048 projections (int4), at M = 1, 4, 128 and 320, times the kernel
at each split count of 1-16 (20 calls captured in a CUDA graph and
replayed, rotating over enough weight copies to leave the 50 MB L2 cold,
as ``chip_smoke.py`` times it) and prints one line a shape: ``splits:us``
pairs and the count the rule chooses.  Needs one CUDA card.
"""
from __future__ import annotations

import math
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[1] / "src")]


def main() -> int:
    import torch
    import chip_smoke as CS
    from repro_torch.core import quantization as Q
    from repro_torch.kernels import w4a8_matmul as WM
    from repro_torch.runtime import plan as RP

    if not torch.cuda.is_available():
        raise SystemExit("tools/matmul_splits_sweep.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"[sweep] {CS.card_line()}", flush=True)
    for what, K, N in (("qwen2-7b q/o", 3584, 3584), ("qwen2-7b k/v", 3584, 512),
                       ("qwen2-7b gate/up", 3584, 18944), ("qwen2-7b down", 18944, 3584),
                       ("moonshot q/k/v/o", 2048, 2048)):
        pl = RP.pack_linear(Q.quantize(
            torch.randn((K, N), generator=gen, device=dev) * 0.02, 4))
        n_copies = min(8, max(1, math.ceil(100e6 / pl.data.numel())))
        copies = [pl.data] + [pl.data.clone() for _ in range(n_copies - 1)]
        for M in (1, 4, 128, 320):
            xq, sx = Q.quantize_activations(
                torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16))
            sets = [(xq, sx, c, pl.scale[0], pl.zero[0]) for c in copies]
            chosen = WM.matmul_splits(M, N, K)
            counts = sorted({1, 2, 3, 4, 5, 6, 8, 10, 12, 16, chosen} & set(range(1, K // 64 + 1)))
            times = [f"{s}:{CS.graph_ms(lambda *a: WM.w4a8_matmul(*a, bits=4, splits=s), sets) * 1e3:.1f}"
                     for s in counts]
            tiles = -(-M // WM.tile_rows(M)) * (N // 128)
            print(f"[sweep] {what} M={M} ({WM.tile_rows(M)}-row tile, {tiles} tiles, "
                  f"{K // 64} K steps) chosen {chosen}: {' '.join(times)} (us on the device)",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
