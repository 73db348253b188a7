#!/usr/bin/env python3
"""Run parts of ``chip_smoke.py`` from several checkouts on one card, so
two commits are compared on the same machine (host speed varies between
machines far more than device speed).

    python3 tools/ab_trees.py phases DIR [DIR ...]   # each tree's [kernels] and [moe] phases
    python3 tools/ab_trees.py moe DIR [DIR ...]      # each tree's MoE trace and decode step

DIR is the root of a checkout (e.g. the parent unpacked with ``git
archive`` into ``build/parent``).  Each tree runs in a process of its own,
importing its own ``chip_smoke.py`` and building its own kernels under
DIR/build, in the order given: name trees repeatedly to alternate them
(parent, change, change, parent).  ``moe`` serves the moonshot-v1-16b-a3b
trace of ``chip_smoke.py`` through ``EngineLoop`` (after a short warm-up
trace) and profiles 8 four-row decode steps; each run prints one line
``AB {json}``.  Needs one CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def run_phases(root: Path) -> dict:
    import torch
    import chip_smoke as CS
    from repro_torch.kernels import loader
    loader.build(force=True)
    dev = torch.device("cuda", 0)
    results: dict = {}
    CS.phase_kernels(dev, results)
    CS.phase_new_kernels(dev, results)
    return {"kernels": results, "moe": CS.phase_moe(dev)}


def run_moe(root: Path) -> dict:
    import torch
    import chip_smoke as CS
    from repro_torch.configs import registry
    from repro_torch.kernels import loader
    from repro_torch.serving import engine as E
    loader.build(force=True)
    dev = torch.device("cuda", 0)
    cfg = registry.get("moonshot-v1-16b-a3b")
    eng = E.build_engine(cfg, seed=0, max_seq=1024, device=dev,
                         flash_dir=str(root / "build" / "flash-moe"))
    specs, arrivals = CS.moe_trace(cfg.vocab_size)
    CS.serve_trace(eng, specs[:2], arrivals[:2], max_new=4)        # warm-up
    eng.stats = E.EngineStats()
    _loop, _reqs, wall = CS.serve_trace(eng, specs, arrivals, max_new=16)
    s = eng.stats
    prof = CS.profile_loop_decode(eng, specs, steps=8)
    return {"wall_s": wall, "ttft_p50_ms": s.ttft(50) * 1e3, "tpot_p50_ms": s.tpot(50) * 1e3,
            "prefill_tok_s": s.prefill_tps, "decode_tok_s": s.decode_tps,
            "step_ms": prof["decode_step_ms"], "host_ms": prof["host_enqueue_ms"],
            "device_ms": prof.get("device_ms_per_step"),
            "launches": prof.get("device_launches_per_step")}


def main(argv) -> int:
    if len(argv) >= 3 and argv[0] == "--one":
        mode, root = argv[1], Path(argv[2]).resolve()
        sys.path[:0] = [str(root / "src"), str(root)]
        out = (run_phases if mode == "phases" else run_moe)(root)
        print("AB " + json.dumps({"tree": argv[2], **out}, default=str), flush=True)
        return 0
    if len(argv) < 2 or argv[0] not in ("phases", "moe"):
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for tree in argv[1:]:
        proc = subprocess.run([sys.executable, __file__, "--one", argv[0], tree],
                              capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if line.startswith("AB ") or line.startswith("[kernels]   ") or \
                    line.startswith("[moe] 6") or line.startswith("[profile] moon"):
                print(line, flush=True)
        if proc.returncode:
            print(f"{tree}: exit {proc.returncode}\n{proc.stderr[-2000:]}", file=sys.stderr)
            rc = proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
