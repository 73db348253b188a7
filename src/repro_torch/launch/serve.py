"""Serving driver: a trace of requests through the continuous-batching
``EngineLoop`` on the card, with ``--no-continuous`` through the
slot-synchronous ``Engine.generate``, or with ``--http PORT`` the streaming
HTTP gateway over an ``EngineLoop`` — the counterpart of ``python -m
repro.launch.serve``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
      --requests 8 --max-new 32 --slots 4 --max-seq 2048
  PYTHONPATH=src python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b \\
      --max-seq 1024 --max-prompt 400
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b@reduced \\
      --device cpu --http 8090
  curl -N http://127.0.0.1:8090/v1/completions -d \\
      '{"prompt": "hello", "max_tokens": 16, "stream": true}'

``--arch`` takes ``<arch>`` or ``<arch>@reduced`` / ``@tiny`` / ``@tiny-moe``
(MoE architectures); weights are random, drawn from ``--seed``.  With
``--weight-dram-budget BYTES`` the stacks that overflow the budget stream
from Flash through a ring of device slots (``EngineLoop`` only).  It runs on
``cuda``; ``--device cpu`` runs the plain PyTorch path instead.  With
``--warmup`` (the default) the loop captures every step graph before
serving and prints the reference's warmup line (with ``--http``, the
gateway's ``/healthz`` answers 503 until it is done).  Prints every
request's tokens and the serving stats.  ``Engine.generate`` decodes
the whole batch at request 0's position, so ``--no-continuous`` draws every
prompt at one length (``--max-prompt``).
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.serving import engine as E
from repro_torch.serving import sampling as SM


def main(argv: Optional[List[str]] = None) -> List[E.Request]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--min-prompt", type=int, default=4)
    ap.add_argument("--max-prompt", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--prefill-token-budget", type=int, default=None)
    ap.add_argument("--preempt-patience", type=int, default=0,
                    help="evict a long-running request (its KV spilled to Flash "
                         "and restored on resume) once the queue's head has "
                         "waited this many steps; 0 never preempts")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continuous", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="continuous batching (EngineLoop) vs the slot-synchronous "
                         "two-phase Engine.generate")
    ap.add_argument("--warmup", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="capture every decode-bucket / prompt-chunk step graph "
                         "before serving (on the card; on the CPU the steps run "
                         "once, eagerly); --no-warmup captures each where first met")
    ap.add_argument("--weight-dram-budget", type=int, default=None, metavar="BYTES",
                    help="device byte budget for the WEIGHTS: stacks that overflow "
                         "it stream per layer group from Flash through a ring of "
                         "device slots (default: everything resident)")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve the streaming HTTP gateway on PORT "
                         "instead of replaying a trace")
    ap.add_argument("--host", default="127.0.0.1",
                    help="gateway bind address (with --http)")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="gateway backpressure: waiting requests beyond "
                         "this bound are rejected with HTTP 429")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain path)")
    ap.add_argument("--flash-dir", default=None,
                    help="directory of the Flash embedding (default: build/flash)")
    args = ap.parse_args(argv)

    cfg = registry.get(args.arch)
    t0 = time.perf_counter()
    eng = E.build_engine(cfg, seed=args.seed, max_seq=args.max_seq,
                         flash_dir=args.flash_dir, device=args.device,
                         weight_dram_budget_bytes=args.weight_dram_budget)
    print(f"[serve] arch={cfg.name} quant={cfg.quant.tag()} on {eng.device} "
          f"(embedding on Flash, int8-K/fp8-V paged KV); built in "
          f"{time.perf_counter() - t0:.1f}s")
    pol = eng.weight_policy
    if pol.active:
        print(f"[serve] weight streaming: {len(pol.streamed)} stack(s) on Flash, "
              f"ring {pol.ring_bytes / 1024:.0f} KiB, resident "
              f"{pol.resident_bytes / 1024:.0f} KiB of budget "
              f"{pol.dram_budget_bytes / 1024:.0f} KiB")
    if args.http is not None:
        from repro_torch.data.tokenizer import ByteTokenizer
        from repro_torch.serving import gateway as G
        loop = E.EngineLoop(eng, max_slots=args.slots,
                            prefill_chunk=args.prefill_chunk,
                            prefill_token_budget=args.prefill_token_budget,
                            preempt_patience=args.preempt_patience,
                            max_queue=args.max_queue, seed=args.seed)
        tok = ByteTokenizer(cfg.vocab_size) if cfg.vocab_size >= 258 else None
        print(f"[serve] gateway on http://{args.host}:{args.http} "
              f"({args.slots} slots, queue bound {args.max_queue}, "
              f"{'byte tokenizer' if tok else 'token-id prompts only'})",
              flush=True)
        try:
            G.serve(G.EngineService(loop, warmup=args.warmup),
                    host=args.host, port=args.http,
                    tokenizer=tok, model_name=cfg.name)
        finally:
            eng.close()
        return []
    rng = np.random.default_rng(args.seed)
    sp = SM.SamplingParams(temperature=args.temperature, top_k=args.top_k,
                           max_new_tokens=args.max_new)

    def prompt_len() -> int:
        if not args.continuous:
            return args.max_prompt
        return int(rng.integers(args.min_prompt, args.max_prompt + 1))

    reqs = [E.Request(uid=i, max_new_tokens=args.max_new, sampling=sp,
                      prompt_tokens=[int(t) for t in rng.integers(
                          1, cfg.vocab_size, prompt_len())])
            for i in range(args.requests)]
    t0 = time.perf_counter()
    if args.continuous:
        loop = E.EngineLoop(eng, max_slots=args.slots,
                            prefill_chunk=args.prefill_chunk,
                            prefill_token_budget=args.prefill_token_budget,
                            preempt_patience=args.preempt_patience,
                            seed=args.seed)
        if args.warmup:
            rep = loop.warmup()
            print(f"[serve] warmup: {rep['graphs']} graphs "
                  f"(buckets {rep['decode_buckets']}, "
                  f"chunks {rep['chunk_sizes']}) in {rep['warmup_s']:.2f}s")
            t0 = time.perf_counter()
        out = loop.run(reqs)
        how = f"on {args.slots} slots"
    else:
        out = eng.generate(reqs, sp, torch.Generator(device=eng.device)
                           .manual_seed(args.seed))
        how = "slot-synchronous"
    wall = time.perf_counter() - t0
    s = eng.stats
    done = sum(len(r.generated) for r in out)
    for r in out:
        print(f"[serve] req {r.uid}: prompt {len(r.prompt_tokens)} toks -> {r.generated}")
    print(f"[serve] {len(out)} requests, {done} new tokens in {wall:.2f}s "
          f"({done / wall:.1f} tok/s) {how}")
    if args.continuous:
        print(f"[serve] TTFT p50={s.ttft(50) * 1e3:.1f}ms p95={s.ttft(95) * 1e3:.1f}ms; "
              f"TPOT p50={s.tpot(50) * 1e3:.2f}ms; latency p50={s.latency(50):.2f}s; "
              f"prefix pages adopted {loop.pool.prefix_hits}; graphs captured "
              f"{s.compile_events} ({s.recompiles_after_warmup} after warmup); "
              f"preemptions {s.preemptions}, pages spilled {s.spilled_pages} / "
              f"restored {s.restored_pages}, cold pages spilled "
              f"{s.cold_spilled_pages}")
        if pol.active:
            print(f"[serve] weight groups: hit rate {s.weight_stream_hit_rate:.3f} "
                  f"({s.weight_group_hits} hits, {s.weight_group_misses} misses), "
                  f"stall {s.weight_stall_s * 1e3:.1f} ms; experts: hit rate "
                  f"{s.expert_prefetch_hit_rate:.3f}, bytes saved "
                  f"{s.expert_bytes_saved_frac:.3f}")
        loop.close()
    print(f"[serve] prefill {s.prefill_tokens} toks @ {s.prefill_tps:.1f} t/s; "
          f"decode {s.decode_tokens} toks @ {s.decode_tps:.1f} t/s; "
          f"flash reads {s.flash_bytes / 1024:.1f} KiB")
    eng.close()
    return out


if __name__ == "__main__":
    main()
