#!/usr/bin/env python3
"""Run parts of ``chip_smoke.py`` from several checkouts on one card, so
two commits are compared on the same machine (host speed varies between
machines far more than device speed).

    python3 tools/ab_trees.py phases DIR [DIR ...]   # each tree's [kernels] and [moe] phases
    python3 tools/ab_trees.py kernels DIR [DIR ...]  # each tree's [kernels] phase alone
    python3 tools/ab_trees.py moe DIR [DIR ...]      # each tree's MoE trace and decode step
    python3 tools/ab_trees.py qwen DIR [DIR ...]     # each tree's qwen2-7b serving paths
    python3 tools/ab_trees.py profiles DIR [DIR ...] # each tree's qwen2-7b and MoE phases, timed

DIR is the root of a checkout (e.g. the parent unpacked with ``git
archive`` into ``build/parent``).  Each tree runs in a process of its own,
importing its own ``chip_smoke.py`` and building its own kernels under
DIR/build, in the order given: name trees repeatedly to alternate them
(parent, change, change, parent).  ``moe`` serves the moonshot-v1-16b-a3b
trace of ``chip_smoke.py`` through ``EngineLoop`` (after a short warm-up
trace) and profiles 8 four-row decode steps; ``qwen`` serves full-width
qwen2-7b (random weights, seed 0) through ``EngineLoop`` on the trace of
``chip_smoke.py`` (after a short warm-up trace) and through
``Engine.generate`` (4 prompts of 320 tokens, 32 new tokens each), and
profiles 8 four-row ``EngineLoop`` decode steps.  In a tree whose loop
captures CUDA graphs, ``moe`` and ``qwen`` then serve the loop's trace and
profile its decode step again on the graphs (``graph_*`` keys), so eager
and graph runs alternate with the trees.  ``profiles`` runs a tree's
qwen2-7b part of ``chip_smoke.py``'s main path as its ``main()`` does (the
eager trace, the graphs, the eager and graph decode-step profiles) and its
``phase_moe``, and gives each part's wall seconds.  Each run prints one
line ``AB {json}``.  Needs one CUDA card.
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


def run_kernels(root: Path) -> dict:
    import torch
    import chip_smoke as CS
    from repro_torch.kernels import loader
    loader.build(force=True)
    dev = torch.device("cuda", 0)
    results: dict = {}
    CS.phase_kernels(dev, results)
    CS.phase_new_kernels(dev, results)
    return {"kernels": results}


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
    out = {"wall_s": wall, "ttft_p50_ms": s.ttft(50) * 1e3, "tpot_p50_ms": s.tpot(50) * 1e3,
           "prefill_tok_s": s.prefill_tps, "decode_tok_s": s.decode_tps,
           "step_ms": prof["decode_step_ms"], "host_ms": prof["host_enqueue_ms"],
           "device_ms": prof.get("device_ms_per_step"),
           "launches": prof.get("device_launches_per_step")}
    return {**out, **run_graphs(CS, eng, specs, arrivals, 16)}


def run_graphs(CS, eng, specs, arrivals, max_new: int) -> dict:
    """A tree whose loop has CUDA graphs serves the trace again on them
    (after ``warmup()``) and profiles the graph decode step: ``graph_*``."""
    from repro_torch.serving import engine as E
    if not hasattr(CS, "make_loop"):
        return {}
    loop = CS.make_loop(eng, cuda_graphs=True)
    loop.warmup()
    eng.stats = E.EngineStats()
    _loop, _reqs, wall = CS.serve_trace(eng, specs, arrivals, max_new=max_new, loop=loop)
    s = eng.stats
    loop.close()
    prof = CS.profile_loop_decode(eng, specs, steps=8, cuda_graphs=True)
    return {"graph_wall_s": wall, "graph_ttft_p50_ms": s.ttft(50) * 1e3,
            "graph_tpot_p50_ms": s.tpot(50) * 1e3, "graph_prefill_tok_s": s.prefill_tps,
            "graph_decode_tok_s": s.decode_tps, "graph_step_ms": prof["decode_step_ms"],
            "graph_host_ms": prof["host_enqueue_ms"],
            "graph_device_ms": prof.get("device_ms_per_step"),
            "graph_busy": prof.get("device_busy_share")}


def run_qwen(root: Path) -> dict:
    import numpy as np
    import torch
    import chip_smoke as CS
    from repro_torch.configs import registry
    from repro_torch.kernels import loader
    from repro_torch.serving import engine as E
    from repro_torch.serving import sampling as SM
    loader.build(force=True)
    dev = torch.device("cuda", 0)
    cfg = registry.get("qwen2-7b")
    eng = E.build_engine(cfg, seed=0, max_seq=2048, device=dev)
    specs, arrivals = CS.make_trace(cfg.vocab_size)
    CS.serve_trace(eng, specs[:2], arrivals[:2], max_new=4)        # warm-up
    eng.stats = E.EngineStats()
    _loop, _reqs, wall = CS.serve_trace(eng, specs, arrivals)
    s = eng.stats
    out = {"loop_wall_s": wall, "loop_ttft_p50_ms": s.ttft(50) * 1e3,
           "loop_tpot_p50_ms": s.tpot(50) * 1e3, "loop_prefill_tok_s": s.prefill_tps,
           "loop_decode_tok_s": s.decode_tps}
    rng = np.random.default_rng(1)
    reqs = [E.Request(uid=i, prompt_tokens=[int(t) for t in rng.integers(1, cfg.vocab_size, 320)],
                      max_new_tokens=32) for i in range(4)]
    eng.stats = E.EngineStats()
    torch.cuda.synchronize()
    eng.generate(reqs, SM.SamplingParams(temperature=0.0, max_new_tokens=32))
    g = eng.stats
    out.update({"generate_prefill_tok_s": g.prefill_tps, "generate_decode_tok_s": g.decode_tps,
                "generate_prefill_s": g.prefill_s})
    prof = CS.profile_loop_decode(eng, specs, steps=8)
    out.update({"step_ms": prof["decode_step_ms"], "host_ms": prof["host_enqueue_ms"],
                "device_ms": prof.get("device_ms_per_step"),
                "port_kernels": prof.get("port_kernels"),
                "syncs_per_step": prof.get("syncs_per_step")})
    return {**out, **run_graphs(CS, eng, specs, arrivals, 32)}


def run_profiles(root: Path) -> dict:
    import time
    import torch
    import chip_smoke as CS
    from repro_torch.kernels import loader
    loader.build(force=True)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    eng, specs, arrivals, reqs, _ = CS.phase_main_path(dev)
    t1 = time.perf_counter()
    graphs = CS.phase_graphs("qwen2-7b", eng, specs, arrivals, reqs, 32, CS.LOOP_KERNELS)
    if not isinstance(graphs, tuple):     # a tree that profiles on a loop of its own
        graphs = (graphs, CS.profile_loop_decode(eng, specs, cuda_graphs=True))
    eager = CS.profile_loop_decode(eng, specs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del eng
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    CS.phase_moe(dev)
    torch.cuda.synchronize()
    return {"qwen_trace_s": t1 - t0, "qwen_graphs_and_profiles_s": t2 - t1,
            "moe_phase_s": time.perf_counter() - t3,
            "graph_step_ms": graphs[1]["decode_step_ms"], "eager_step_ms": eager["decode_step_ms"]}


def main(argv) -> int:
    if len(argv) >= 3 and argv[0] == "--one":
        mode, root = argv[1], Path(argv[2]).resolve()
        sys.path[:0] = [str(root / "src"), str(root)]
        out = {"phases": run_phases, "kernels": run_kernels, "moe": run_moe,
               "qwen": run_qwen, "profiles": run_profiles}[mode](root)
        print("AB " + json.dumps({"tree": argv[2], **out}, default=str), flush=True)
        return 0
    if len(argv) < 2 or argv[0] not in ("phases", "kernels", "moe", "qwen", "profiles"):
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for tree in argv[1:]:
        proc = subprocess.run([sys.executable, __file__, "--one", argv[0], tree],
                              capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            shown = "[kernels]" if argv[0] == "kernels" else "[kernels]   "
            if line.startswith("AB ") or line.startswith(shown) or \
                    line.startswith("[moe] 6") or line.startswith("[profile] "):
                print(line, flush=True)
        if proc.returncode:
            print(f"{tree}: exit {proc.returncode}\n{proc.stderr[-2000:]}", file=sys.stderr)
            rc = proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
