#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero; nothing is caught and carried on):

1. The card (``nvidia-smi`` name and power limit), torch and CUDA versions;
   build of the Hopper kernels from ``src/repro_torch/csrc``.
2. Each of the seven kernels against its plain PyTorch version on the card,
   at the serving paths' shapes (qwen2-7b, G=7; moonshot-v1-16b-a3b, G=1;
   the decode kernels and the dense matmul with the split count their
   wrappers choose, the matmul at every dense linear of both models at
   M = 1, 4, 128 and 320)
   and at small ``@reduced`` shapes, with the tolerance of the matching CPU
   test; the dense prefill kernel also non-causal and windowed; the grouped
   kernel with expert ids (decode) and live-row counts (full-capacity
   prefill, routed and uneven).  Kernel, plain and library-yardstick times.
3. The continuous path: full-width qwen2-7b (random weights from a seed, 28
   layers) serves 8 greedy requests through ``EngineLoop.submit``/``step``
   (prompts of 40-700 tokens, a third sharing a 256-token prefix, staggered
   arrivals, 32 new tokens each), eagerly; then ``[graphs]``: a loop's
   ``warmup()`` captures one CUDA graph per decode bucket and chunk size
   (seconds and the graph pool's device memory logged), and the same trace
   through the graphs must commit the eager run's greedy tokens token for
   token, capture nothing after warmup and launch the path's four kernels;
   a profiled decode step, eager and on its graph; the kernel path
   against the plain path for one prompt chunk and one decode step, layer by
   layer, within a stated tolerance (free-running drift and greedy agreement
   are printed, not asserted: flat random-weight logits can flip an argmax
   inside the tolerance).
4. The slot-synchronous path: the same qwen2-7b engine serves 4 greedy
   requests with 320-token prompts through ``Engine.generate`` (32 new
   tokens, dense caches of 2048 slots); a profiled decode step; kernel path
   against plain path for the whole-prompt prefill and one decode step.
   Then ``[lora]``, multi-LoRA on the same engine: five requests (prompts of
   150-300 tokens, 16 new tokens) with no adapter, adapter A (rank 8) and
   adapter B (rank 4) decoding in one bucket, one prompt under no adapter
   and then under A (no adoption across adapters) and again under A after
   a slot frees (it adopts).  The trace runs with no adapter loaded (every
   row the base model's), then with A and B loaded eagerly and on a loop
   warmed with them: graph tokens equal eager, base rows equal the
   no-adapter run, adapter rows differ, no capture after warmup; adapter C
   loaded after warmup captures nothing and its replay equals eager.  The
   bypass's norm against the projection's is printed; one LoRA chunk and
   decode step are held, kernel path against plain, layer by layer; and
   ``Engine.generate`` runs two 256-token prompts, one under A.  Then
   ``[gateway]``: an ``EngineService`` over a graph loop warms up on its
   engine thread (not ready until it is done) while six threads submit
   requests mixed across adapters; each stream must carry the tokens
   ``EngineLoop.run`` commits on graphs, its first token while the engine
   still has work; a second round after warmup gives TTFT p50/p95 and TPOT
   p50 through the service; where aiohttp is installed, an SSE completion,
   ``/healthz`` and ``/v1/stats`` through ``GatewayServer`` with urllib
   (the line says whether it ran).  The adapters are unloaded after it.
   Then ``[spill]``, the Flash tier on the same engine: an ``EngineLoop``
   whose DRAM pool holds 16 pages of 128 tokens (half the trace's 32-page
   peak; staging reserve 14 pages) serves 830-900-token prompts sharing a
   256-token prefix, 64 new tokens each, eagerly: with prefix sharing (cold
   pages of running rows spill), without (decodes in 2+ staging waves),
   and without it plus a fifth request and queue patience (preemption to
   Flash and restore).  Every request's greedy tokens must equal an
   all-DRAM loop's; the staging reserve must come back whole and nothing
   stay on Flash; the no-sharing run again on a warmed loop's graphs must
   equal the eager run with no capture after warmup, and each of its steps
   is timed, its syncs counted and its host time in ``_stage_wave`` summed
   (a decode step that stages nothing must make exactly one sync).
5. The MoE path: full-width moonshot-v1-16b-a3b (48 layers, 64 experts
   top-6, random weights) serves 6 greedy requests with prompts of 64-400
   tokens (two sharing a 256-token prefix) on 4 slots through
   ``EngineLoop``; the grouped kernel must run on both dispatch branches --
   prompt chunks with live-row counts, decode steps with expert ids and no
   ``take_experts`` copy -- and the paged attention kernels at G=1; the same
   trace through the graphs (one 4-row decode step, its chunk sizes; each
   graph holds grouped launches of its branch), as for qwen2-7b; a profiled
   decode step, eager and on its graph; kernel path against plain path for
   one prompt chunk and one decode step.

6. ``[wstream]``, weights streamed from Flash through a ring of device slots:
   full-width qwen2-7b (28 groups, a budget of the head plus 7 groups: a
   7-slot ring) serves 4 greedy requests of 64-400 prompt tokens (two
   sharing a 256-token prefix, 16 new tokens, all at step 0) first on the
   resident engine, then on an engine built from the same parameters under
   that budget, the resident one released: the same greedy tokens, the
   stack's device memory freed (within 5% of the policy's bytes), the four
   kernels launched, nothing fallen back, the CUDA-graph gate recorded,
   one sync a decode step.  Then full-width moonshot-v1-16b-a3b with its
   experts streamed (48 groups, a 16-slot ring: the head plus a third of
   the stack), 4 requests of 48-128 tokens, 8 new: the resident loop's
   tokens, the grouped kernel on both branches, expert prefetch hits and
   fewer bytes than whole groups.  Each part prints its export, Flash
   bytes, installs and wall time a step, one install's host-to-device rate,
   the time waited for Flash and the syncs of a decode step, and deletes
   its blobs.  The blobs are read back from the host's page cache.

Launch counts are zeroed just before each serving path and read just after
it (a graph replay adds the launches its capture recorded): every kernel of
the path must have launched, and nothing fell back.
The last three lines of standard output are the card (``nvidia-smi`` name,
power limit), one JSON object with every kernel's numbers, and
``{"ok": true, "device": {...}}``.  Details go to ``chiprun_out/``.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12          # CUDA cores (RMSNorm's elementwise math)

# tolerances of the matching CPU tests (tests/test_torch_kernels.py), which
# are the JAX package's own kernel-vs-reference tolerances
TOL = {"w4a8_matmul": (1e-4, 1e-4),
       "paged_quant_decode_attention": (2e-2, 2e-2),
       "paged_flash_prefill_attention": (2e-2, 2e-2),
       "rmsnorm": (2e-2, 2e-2),
       "grouped_matmul": (1e-4, 1e-4),
       "quant_decode_attention": (2e-2, 2e-2),
       "flash_prefill_attention": (2e-2, 2e-2)}
# full width, kernel path vs plain path on the same input, relative L2 error.
# A layer: the attention kernels round keys and probabilities to bf16 where
# the plain path does, but sum in another order (tensor-core products; the
# decode kernels round P before normalising, per split), and every linear then
# re-quantizes its input to int8, where one code step is 1/127 of the row's
# max (~3% of its rms): a share of elements lands on the neighbouring code,
# so a layer's output differs by a few percent of its norm.  The head (final
# RMSNorm + int8 lm_head) re-quantizes the same hidden state in both paths
# and differs only in the order of the epilogue's two scale products.
LAYER_REL_L2 = 5e-2
HEAD_REL_L2 = 1e-4
# MoE: share of (token, layer) router decisions allowed to differ between
# the two paths on the same layer input.  Last-bit differences of the
# attention sums move the router logits by a fraction of a percent of their
# spread; with 64 experts the 6th and 7th largest sit about a tenth of a
# spread apart, so a few percent of tokens can change their expert set.
MAX_ROUTE_FLIPS = 0.1

REPLACES = {
    "w4a8_matmul": "src/repro/kernels/w4a8_matmul.py:65",
    "paged_quant_decode_attention": "src/repro/kernels/quant_attention.py:167",
    "paged_flash_prefill_attention": "src/repro/kernels/flash_prefill.py:191",
    "rmsnorm": "src/repro/kernels/rmsnorm.py:23",
    "grouped_matmul": "src/repro/kernels/grouped_matmul.py:66",
    "quant_decode_attention": "src/repro/kernels/quant_attention.py:82",
    "flash_prefill_attention": "src/repro/kernels/flash_prefill.py:91",
}
SOURCES = {
    "w4a8_matmul": "src/repro_torch/csrc/w4a8_matmul.cu",
    "paged_quant_decode_attention": "src/repro_torch/csrc/paged_decode_attention.cu",
    "paged_flash_prefill_attention": "src/repro_torch/csrc/paged_prefill_attention.cu",
    "rmsnorm": "src/repro_torch/csrc/rmsnorm.cu",
    "grouped_matmul": "src/repro_torch/csrc/grouped_matmul.cu",
    "quant_decode_attention": "src/repro_torch/csrc/decode_attention.cu",
    "flash_prefill_attention": "src/repro_torch/csrc/flash_prefill_attention.cu",
}
KERNELS = tuple(SOURCES)
# the kernels each EngineLoop path must launch (eager and inside its graphs)
LOOP_KERNELS = ("w4a8_matmul", "paged_quant_decode_attention",
                "paged_flash_prefill_attention", "rmsnorm")
MOE_KERNELS = ("grouped_matmul",) + LOOP_KERNELS
# device-kernel names of the port's kernels in a profiler trace
PORT_KERNEL_SYMBOLS = ("w4a8_kernel", "paged_decode_kernel", "paged_prefill_kernel",
                       "rmsnorm_kernel", "grouped_kernel", "dense_decode_kernel",
                       "flash_prefill_kernel")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def time_ms(fn, arg_sets, iters: int = 20, warmup: int = 3) -> float:
    """Mean time over ``iters`` launches between two CUDA events,
    rotating over ``arg_sets`` (enough copies that the weights do not stay
    in the 50 MB L2 where the real caller finds them cold)."""
    import torch
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alternating_ms(cases, iters: int = 200, batches: int = 7):
    """The median time a call of each ``(fn, arg_sets)`` case over
    ``batches`` batches of ``iters`` calls, the cases' batches taken in
    turns: where a call is mostly host time, the host's speed drifts
    within a run, and alternating lays the drift on every case alike."""
    import statistics
    means = [[] for _ in cases]
    for _ in range(batches):
        for m, (fn, arg_sets) in zip(means, cases):
            m.append(time_ms(fn, arg_sets, iters))
    return [statistics.median(m) for m in means]


def graph_ms(fn, arg_sets, iters: int = 20, replays: int = 5):
    """Device time per launch: ``iters`` calls captured in one CUDA graph and
    replayed, so the host's time per call (Python checks, allocation, the
    launch itself: tens of microseconds a wrapper call) drops out.  Same
    rotation over ``arg_sets`` as ``time_ms``; None where a call cannot be
    captured."""
    import torch
    try:
        for i in range(3):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(iters):
                fn(*arg_sets[i % len(arg_sets)])
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / (replays * iters)
        del graph
        return ms
    except (RuntimeError, TypeError, AttributeError) as e:
        log(f"[kernels]   not capturable in a CUDA graph: {type(e).__name__}: {e}")
        torch.cuda.synchronize()
        return None


def f4(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def library_time(fn, arg_sets):
    """The yardstick's time per call and its device time per launch, or None
    where this PyTorch build lacks the call or refuses these operands (the
    yardstick is never part of the port)."""
    try:
        return time_ms(fn, arg_sets), graph_ms(fn, arg_sets)
    except (RuntimeError, TypeError, AttributeError) as e:
        log(f"[kernels]   library yardstick unavailable: {type(e).__name__}: {e}")
        return None, None


def check_close(name: str, got, want, what: str) -> float:
    import torch
    rtol, atol = TOL[name]
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name} {what}: non-finite output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(f"{name} {what}: {int(bad.sum())} elements outside "
                             f"rtol={rtol} atol={atol} (max abs err "
                             f"{float(err.max()):.3e})")
    return float(err.max())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def make_pool(n_pages: int, ps: int, hkv: int, d: int, gen, dev):
    """A pool whose bytes come from quantizing random keys/values, as the
    serving path writes them."""
    import torch
    from repro_torch.core import kv_cache as KV
    from repro_torch.core import quantization as Q
    k = torch.randn((n_pages, ps, hkv, d), generator=gen, device=dev)
    v = torch.randn((n_pages, ps, hkv, d), generator=gen, device=dev)
    kq, ks, kz = KV.quantize_keys(k.to(torch.bfloat16))
    return kq.contiguous(), ks.contiguous(), kz.contiguous(), KV.cast_values(v, Q.FP8_DTYPE)


def make_table(lengths, ps: int, n_cols: int, n_pages: int, trash: int, gen, dev):
    import torch
    perm = torch.randperm(n_pages, generator=gen, device=dev).tolist()
    table = torch.full((len(lengths), n_cols), trash, dtype=torch.int32)
    for b, L in enumerate(lengths):
        for c in range(-(-L // ps)):
            table[b, c] = perm.pop()
    return table.to(dev)


def gather_dense(pool, table, dtype):
    """Library-yardstick input: each row's pages gathered and dequantized."""
    from repro_torch.core import kv_cache as KV
    from repro_torch.kernels.quant_attention import gather_rows
    kq, ks, kz, v = pool
    k = KV.dequantize_keys(gather_rows(kq, table), gather_rows(ks, table),
                           gather_rows(kz, table), dtype)
    return k, gather_rows(v, table).to(dtype)


def phase_kernels(dev, results: dict) -> None:
    import torch
    import torch.nn.functional as F
    from repro_torch.core import quantization as Q
    from repro_torch.kernels import flash_prefill as FP
    from repro_torch.kernels import quant_attention as QA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import w4a8_matmul as WM
    from repro_torch.runtime import plan as RP

    gen = torch.Generator(device=dev).manual_seed(1234)

    # --- w4a8_matmul -------------------------------------------------------
    # every dense linear of qwen2-7b and of moonshot-v1-16b-a3b (K, N, bits;
    # moonshot's q/k/v/o are all 2048 x 2048) at decode (M = 1, 4), a prompt
    # chunk (128) and an Engine.generate prompt (320), and @reduced.  Each
    # shape: the split count and tile the wrapper chooses, the bound, and
    # torch._int_mm as yardstick (the weight unpacked to int8 beforehand, M
    # padded to 32 where it is 16 or less: _int_mm takes no fewer rows).
    shapes = [("qwen2-7b q/o", 3584, 3584, 4), ("qwen2-7b k/v", 3584, 512, 4),
              ("qwen2-7b gate/up", 3584, 18944, 4), ("qwen2-7b down", 18944, 3584, 4),
              ("qwen2-7b lm_head", 3584, 151808, 8), ("moonshot q/k/v/o", 2048, 2048, 4),
              ("moonshot lm_head", 2048, 163840, 8), ("@reduced", 256, 512, 4)]
    wm_rows = []
    for what, K, N, bits in shapes:
        pl = RP.pack_linear(Q.quantize(
            torch.randn((K, N), generator=gen, device=dev) * 0.02, bits))
        n_copies = max(1, math.ceil(100e6 / pl.data.numel()))
        copies = [pl.data] + [pl.data.clone() for _ in range(min(n_copies, 8) - 1)]
        w8 = Q.unpack_int4(pl.data).contiguous() if bits == 4 else pl.data
        w8s = [w8, w8.clone()]
        for M in ((1, 4, 128, 320) if K > 256 else (3,)):
            x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            xq, sx = Q.quantize_activations(x)
            args = (xq, sx, pl.data, pl.scale[0], pl.zero[0])
            got = WM.w4a8_matmul(*args, bits=bits)
            want = WM.w4a8_matmul_plain(*args, bits=bits)
            err = check_close("w4a8_matmul", got, want, f"M={M} K={K} N={N} bits={bits}")
            del got, want
            sets = [(xq, sx, c, pl.scale[0], pl.zero[0]) for c in copies]
            ms = time_ms(lambda *a: WM.w4a8_matmul(*a, bits=bits), sets)
            gms = graph_ms(lambda *a: WM.w4a8_matmul(*a, bits=bits), sets)
            xi = F.pad(xq, (0, 0, 0, 32 - M)) if M <= 16 else xq
            lib_ms, lib_gms = library_time(torch._int_mm, [(xi, w) for w in w8s])
            bytes_ = (xq.numel() + sx.numel() * 4 + pl.data.numel()
                      + 2 * N * 4 + M * N * 4)
            b = bound(bytes_, 2 * M * K * N, INT8_OPS_PER_S)
            splits, rows = WM.matmul_splits(M, N, K), WM.tile_rows(M)
            row = {"what": what, "M": M, "K": K, "N": N, "bits": bits, "splits": splits,
                   "tile_rows": rows, "ms": ms, "graph_ms": gms, "max_abs_err": err,
                   "bound_ms": b[0], "bound_by": b[1], "library_ms": lib_ms,
                   "library_graph_ms": lib_gms}
            wm_rows.append(row)
            log(f"[kernels] w4a8_matmul {what} M={M:4d} K={K:5d} N={N:6d} int{bits} "
                f"({rows}-row tile, {splits} splits, "
                f"{-(-M // rows) * (N // 128) * splits} blocks): {ms:.4f} ms a call, "
                f"{f4(gms)} ms on the device, bound {b[0]:.4f} ms ({b[1]}); _int_mm "
                f"{f4(lib_ms)} ms a call, {f4(lib_gms)} ms on the device; max abs err "
                f"{err:.3e}")
            if (M, K, N) == (4, 3584, 18944):
                plain_ms = time_ms(lambda *a: WM.w4a8_matmul_plain(*a, bits=bits), [args],
                                   iters=5, warmup=1)
                results["w4a8_matmul"] = dict(
                    err=err, ms=ms, graph_ms=gms, plain_ms=plain_ms, library_ms=lib_ms,
                    library_graph_ms=lib_gms, bound=b,
                    shape=f"M={M} K={K} N={N} int4 (gate/up projection, decode bucket 4)")
        del pl, copies, w8, w8s
    results["w4a8_matmul"]["err"] = max(r["max_abs_err"] for r in wm_rows)
    results["w4a8_matmul"]["all_shapes"] = wm_rows

    # --- paged_quant_decode_attention --------------------------------------
    # (B, H, Hkv, D, page, pages per row, lengths): qwen2-7b at max_seq 2048
    # (G=7) with the trace's ragged lengths (row 2), moonshot-v1-16b-a3b at
    # max_seq 1024 (G=1, row 2b), and @reduced (G=1, D=64).  The timed shapes
    # print the split count the wrapper chooses from their shapes.
    cases = [(4, 28, 4, 128, 128, 16, [732, 296, 512, 41]),
             (4, 16, 16, 128, 128, 8, [416, 80, 272, 64]),
             (3, 4, 4, 64, 16, 4, [37, 5, 64])]
    pd_rows, pd_errs = [], []
    for B, H, Hkv, D, ps, ppr, lengths in cases:
        n_pages = B * ppr + 1 + max(2, ppr - 2)
        trash = B * ppr
        pools = [make_pool(n_pages, ps, Hkv, D, gen, dev)
                 for _ in range(8 if D == 128 else 1)]
        table = make_table(lengths, ps, ppr, trash, trash, gen, dev)
        q = (torch.randn((B, H, D), generator=gen, device=dev) / math.sqrt(D)).to(torch.bfloat16)
        base = torch.zeros((B,), dtype=torch.int32, device=dev)
        length = torch.tensor(lengths, dtype=torch.int32, device=dev)
        args = (q, *pools[0], table, base, length)
        got = QA.paged_quant_decode_attention(*args)
        want = QA.paged_quant_decode_attention_plain(*args)
        err = check_close("paged_quant_decode_attention", got, want,
                          f"B={B} G={H // Hkv} D={D} lengths={lengths}")
        pd_errs.append(err)
        splits = QA.decode_splits(B, Hkv, ppr)
        log(f"[kernels] paged_quant_decode_attention G={H // Hkv} D={D} "
            f"lengths={lengths}: {splits} splits of {-(-ppr // splits)} pages "
            f"({B * Hkv * splits} blocks), max abs err {err:.3e}")
        if D == 128:
            sets = [(q, *p, table, base, length) for p in pools]
            ms = time_ms(QA.paged_quant_decode_attention, sets)
            gms = graph_ms(QA.paged_quant_decode_attention, sets)
            plain_ms = time_ms(QA.paged_quant_decode_attention_plain, [args], iters=5)
            k, v = gather_dense(pools[0], table, torch.bfloat16)
            S = k.shape[1]
            mask = (torch.arange(S, device=dev)[None] < length[:, None])[:, None, None, :]
            G = H // Hkv
            qs = q[:, :, None]
            ks = k.transpose(1, 2).repeat_interleave(G, dim=1)
            vs = v.transpose(1, 2).repeat_interleave(G, dim=1)
            lib_ms, lib_gms = library_time(lambda a, b, c, m: F.scaled_dot_product_attention(
                a, b, c, attn_mask=m, scale=1.0), [(qs, ks, vs, mask)])
            live = sum(lengths)
            bytes_ = (q.numel() * 2 + live * Hkv * (2 * D + 8) + B * H * D * 4)
            ops = 4 * live * H * D
            b = bound(bytes_, ops, BF16_FLOPS_PER_S)
            row = dict(err=err, ms=ms, graph_ms=gms, plain_ms=plain_ms, library_ms=lib_ms,
                       library_graph_ms=lib_gms, bound=b, splits=splits,
                       shape=f"B={B} H={H} Hkv={Hkv} D={D} page={ps} pages={ppr} "
                             f"lengths={lengths}")
            pd_rows.append(row)
            log(f"[kernels]   {ms:.4f} ms a call, {f4(gms)} ms on the device, bound "
                f"{b[0]:.5f} ms ({b[1]}); plain {plain_ms:.4f} ms; SDPA {f4(lib_ms)} ms "
                f"a call, {f4(lib_gms)} ms on the device")
    results["paged_quant_decode_attention"] = dict(pd_rows[0], err=max(pd_errs),
                                                   all_shapes=pd_rows)

    # --- paged_flash_prefill_attention -------------------------------------
    # (C, pos0, H, Hkv, D, page, pages per row): a 128-token qwen2-7b chunk
    # two pages into its prompt, and @reduced chunks of 16 and 8 (padded)
    cases = [(128, 256, 28, 4, 128, 128, 16), (16, 16, 4, 4, 64, 16, 4),
             (8, 37, 4, 4, 64, 16, 4)]
    for C, pos0, H, Hkv, D, ps, ppr in cases:
        n_pages = 4 * ppr + 1 + max(2, ppr - 2)
        trash = 4 * ppr
        pools = [make_pool(n_pages, ps, Hkv, D, gen, dev)
                 for _ in range(8 if D == 128 else 1)]
        table = make_table([pos0 + C], ps, ppr, trash, trash, gen, dev)
        q = (torch.randn((1, C, H, D), generator=gen, device=dev) / math.sqrt(D)).to(torch.bfloat16)
        p0 = torch.tensor([pos0], dtype=torch.int32, device=dev)
        args = (q, *pools[0], table, p0)
        got = FP.paged_flash_prefill_attention(*args)
        want = FP.paged_flash_prefill_attention_plain(*args)
        err = check_close("paged_flash_prefill_attention", got, want,
                          f"C={C} pos0={pos0} G={H // Hkv} D={D}")
        log(f"[kernels] paged_flash_prefill_attention C={C} pos0={pos0} "
            f"G={H // Hkv} D={D}: max abs err {err:.3e}")
        if D == 128:
            sets = [(q, *p, table, p0) for p in pools]
            ms = time_ms(FP.paged_flash_prefill_attention, sets)
            gms = graph_ms(FP.paged_flash_prefill_attention, sets)
            plain_ms = time_ms(FP.paged_flash_prefill_attention_plain, [args], iters=5)
            k, v = gather_dense(pools[0], table, torch.bfloat16)
            S = k.shape[1]
            qpos = pos0 + torch.arange(C, device=dev)
            mask = (torch.arange(S, device=dev)[None] <= qpos[:, None])[None, None]
            G = H // Hkv
            lib_ms, lib_gms = library_time(lambda a, b, c, m: F.scaled_dot_product_attention(
                a, b, c, attn_mask=m, scale=1.0),
                [(q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(G, dim=1),
                  v.transpose(1, 2).repeat_interleave(G, dim=1), mask)])
            keys = pos0 + C
            bytes_ = (q.numel() * 2 + keys * Hkv * (2 * D + 8) + C * H * D * 4)
            ops = 4 * H * D * sum(pos0 + i + 1 for i in range(C))
            results["paged_flash_prefill_attention"] = dict(
                err=err, ms=ms, graph_ms=gms, plain_ms=plain_ms, library_ms=lib_ms,
                library_graph_ms=lib_gms,
                bound=bound(bytes_, ops, BF16_FLOPS_PER_S),
                shape=f"B=1 C={C} pos0={pos0} H={H} Hkv={Hkv} D={D} page={ps}")
            log(f"[kernels]   {ms:.4f} ms a call, {f4(gms)} ms on the device; plain "
                f"{plain_ms:.4f} ms; SDPA {f4(lib_ms)} ms a call, {f4(lib_gms)} ms on the device")

    # --- rmsnorm -------------------------------------------------------------
    # qwen2-7b's rows at decode (1, 4), a prompt chunk (128) and a prompt
    # (320), each against F.rms_norm (bf16 weight), and @reduced
    rn_rows = []
    for rows, D in ((1, 3584), (4, 3584), (128, 3584), (320, 3584), (5, 256)):
        x = torch.randn((rows, D), generator=gen, device=dev).to(torch.bfloat16)
        w = 1.0 + 0.1 * torch.randn((D,), generator=gen, device=dev)
        got = RN.rmsnorm(x, w, 1e-6)
        want = RN.rmsnorm_plain(x, w, 1e-6)
        err = check_close("rmsnorm", got, want, f"rows={rows} D={D}")
        wb = w.to(torch.bfloat16)
        lib = (lambda a, b: F.rms_norm(a, (D,), b, 1e-6), [(x, wb)])
        # a call is mostly host time here: kernel and yardstick in turns
        ms, lib_ms = alternating_ms([(RN.rmsnorm, [(x, w, 1e-6)]), lib])
        gms, lib_gms = graph_ms(RN.rmsnorm, [(x, w, 1e-6)]), graph_ms(*lib)
        b = bound(rows * D * 2 * 2 + D * 4, 4 * rows * D, F32_FLOPS_PER_S)
        rn_rows.append({"rows": rows, "D": D, "ms": ms, "graph_ms": gms, "max_abs_err": err,
                        "bound_ms": b[0], "bound_by": b[1], "library_ms": lib_ms,
                        "library_graph_ms": lib_gms})
        log(f"[kernels] rmsnorm rows={rows} D={D}: {ms:.4f} ms a call, {f4(gms)} ms on "
            f"the device; F.rms_norm {f4(lib_ms)} ms a call, {f4(lib_gms)} ms on the "
            f"device; max abs err {err:.3e}")
        if rows == 4:
            plain_ms = time_ms(RN.rmsnorm_plain, [(x, w, 1e-6)])
            results["rmsnorm"] = dict(
                err=err, ms=ms, graph_ms=gms, plain_ms=plain_ms, library_ms=lib_ms,
                library_graph_ms=lib_gms, bound=b,
                shape=f"rows={rows} D={D} bf16 (decode bucket 4)")
    results["rmsnorm"]["err"] = max(r["max_abs_err"] for r in rn_rows)
    results["rmsnorm"]["all_shapes"] = rn_rows
    torch.cuda.synchronize()


def phase_new_kernels(dev, results: dict) -> None:
    """The grouped matmul, dense decode and dense prefill kernels at the
    shapes their serving paths give them."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import kv_cache as KV
    from repro_torch.core import quantization as Q
    from repro_torch.kernels import flash_prefill as FP
    from repro_torch.kernels import grouped_matmul as GM
    from repro_torch.kernels import quant_attention as QA
    from repro_torch.runtime import plan as RP

    gen = torch.Generator(device=dev).manual_seed(4321)

    # --- grouped_matmul ----------------------------------------------------
    # moonshot-v1-16b-a3b (d_model 2048, per-expert d_ff 1408 -> 1536 padded,
    # 64 experts top-6).  Decode: 4 rows x top-6 = 24 slabs of one row that
    # name their experts by id in the layer's whole table, with the repeats
    # a top-6 of 4 rows gives.  Prefill: a 128-token chunk at full capacity
    # (64 experts x 128 rows) whose live rows per expert are those a top-6
    # routing of 128 tokens gives (about 12), passed as ``rows``; checked
    # also at uneven counts (0 and 128 among them, most off the 16-row
    # tiles).  Two copies of each table alternate, so no launch finds the
    # previous one's weights in the 50 MB L2.  Bounds count what these
    # inputs need: the distinct slabs named (decode), the live rows and the
    # weights of experts with any (prefill), and every output element.
    E_ALL, TOPK = 64, 6
    gm_rows, gm_errs = [], []

    def expert_tables(K, N):
        return [RP.pack_expert_linear(Q.quantize(
            torch.randn((E_ALL, K, N), generator=gen, device=dev) * 0.02, 4)) for _ in range(2)]

    def live_input(counts, M, K):
        x = torch.randn((len(counts), M, K), generator=gen, device=dev)
        keep = torch.arange(M, device=dev)[None] < counts[:, None]
        return (x * keep[..., None]).to(torch.bfloat16)

    def operands(xq, sx, pel):
        return (xq, sx, pel.data, pel.scale[:, 0], pel.zero[:, 0])

    for what, K, N in (("decode gate/up", 2048, 1408), ("decode down", 1408, 2048),
                       ("prefill gate/up", 2048, 1408), ("prefill down", 1408, 2048)):
        tables = expert_tables(K, N)
        pel = tables[0]
        Np, Kp = pel.np_pad, pel.kp
        slab_bytes = pel.data[0].numel() + 2 * Np * 4
        if what.startswith("decode"):
            ids = torch.cat([torch.randperm(E_ALL, generator=gen, device=dev)[:TOPK]
                             for _ in range(4)]).to(torch.int32)
            E, M, kw = ids.numel(), 1, {"ids": ids}
            x = torch.randn((E, M, K), generator=gen, device=dev).to(torch.bfloat16)
            live_rows, slabs = E, int(torch.unique(ids).numel())
        else:
            top = torch.randn((128, E_ALL), generator=gen, device=dev).topk(TOPK, dim=-1).indices
            counts = torch.bincount(top.reshape(-1), minlength=E_ALL)
            E, M = E_ALL, 128
            kw = {"rows": counts.to(torch.int32)[:, None].contiguous()}
            x = live_input(counts, M, K)
            live_rows, slabs = int(counts.sum()), int((counts > 0).sum())
            uneven = torch.tensor([0, 128, 17, 1, 33, 12, 100, 64] * 8, device=dev)
            xu, su = Q.quantize_activations(live_input(uneven, M, K))
            rows_u = uneven.to(torch.int32)[:, None].contiguous()
            got = GM.grouped_matmul(*operands(xu, su, pel), bits=4, rows=rows_u)
            gm_errs.append(check_close("grouped_matmul", got,
                                       GM.grouped_matmul_plain(*operands(xu, su, pel), bits=4),
                                       f"{what} uneven live rows"))
            dead = got[torch.arange(M, device=dev)[None] >= uneven[:, None]]
            assert torch.equal(dead, torch.zeros_like(dead)), "dead rows not +0.0"
            del xu, su, got, dead
        xq, sx = Q.quantize_activations(x)
        args = operands(xq, sx, pel)
        err = check_close("grouped_matmul", GM.grouped_matmul(*args, bits=4, **kw),
                          GM.grouped_matmul_plain(*args, bits=4, **kw),
                          f"{what} E={E} M={M} {sorted(kw)}")
        gm_errs.append(err)
        sets = [operands(xq, sx, t) for t in tables]
        ms = time_ms(lambda *a: GM.grouped_matmul(*a, bits=4, **kw), sets)
        gms = graph_ms(lambda *a: GM.grouped_matmul(*a, bits=4, **kw), sets)
        bytes_ = (live_rows * (Kp + 4) + slabs * slab_bytes + E * M * Np * 4
                  + 4 * sum(t.numel() for t in kw.values()))
        ops = 2 * live_rows * Kp * Np
        b = bound(bytes_, ops, INT8_OPS_PER_S)
        row = {"what": what, "E": E, "M": M, "K": K, "N": N, "live_rows": live_rows,
               "slabs_read": slabs, "ms": ms, "graph_ms": gms, "max_abs_err": err,
               "bound_ms": b[0], "bound_by": b[1]}
        log(f"[kernels] grouped_matmul {what} E={E} M={M} K={K} N={N} ({live_rows} live "
            f"rows, {slabs} slabs, {sorted(kw)[0]}): {ms:.4f} ms a call, {f4(gms)} ms on "
            f"the device, bound {b[0]:.4f} ms ({b[1]}), max abs err {err:.3e}")
        if "gate/up" in what:
            row["plain_ms"] = time_ms(lambda *a: GM.grouped_matmul_plain(*a, bits=4, **kw),
                                      [args], iters=3, warmup=1)
            used = RP.take_experts(pel, kw["ids"]) if "ids" in kw else pel
            wd = Q.dequantize(RP.unpack_expert_linear(used))      # bf16 [E, K, N]
            row["library_ms"], row["library_graph_ms"] = library_time(torch.bmm, [(x, wd)])
            log(f"[kernels]   plain {row['plain_ms']:.4f} ms, bf16 bmm {f4(row['library_ms'])} "
                f"ms a call, {f4(row['library_graph_ms'])} ms on the device")
            del wd, used
        gm_rows.append(row)
        del tables, pel, x, xq, sx, args
    for E, M, K, N in ((3, 5, 256, 512),):                 # @reduced
        pel = RP.pack_expert_linear(Q.quantize(
            torch.randn((E, K, N), generator=gen, device=dev) * 0.02, 4))
        xq, sx = Q.quantize_activations(
            torch.randn((E, M, K), generator=gen, device=dev).to(torch.bfloat16))
        gm_errs.append(check_close("grouped_matmul", GM.grouped_matmul(*operands(xq, sx, pel), bits=4),
                                   GM.grouped_matmul_plain(*operands(xq, sx, pel), bits=4),
                                   f"@reduced E={E} M={M}"))
    dec = gm_rows[0]
    results["grouped_matmul"] = dict(
        err=max(gm_errs), ms=dec["ms"], graph_ms=dec["graph_ms"], plain_ms=dec["plain_ms"],
        library_ms=dec["library_ms"], library_graph_ms=dec["library_graph_ms"],
        bound=(dec["bound_ms"], dec["bound_by"]),
        shape=f"E={dec['E']} M=1 K=2048 N=1408 (padded 1536) int4: moonshot "
              "selected-expert decode, 4 rows x top-6 by id (gate/up)",
        all_shapes=gm_rows)
    torch.cuda.synchronize()

    # --- quant_decode_attention (dense cache) -------------------------------
    # (B, H, Hkv, D, S, lengths): Engine.generate's decode at qwen2-7b (4 rows
    # of a 320-token prompt + 32 steps in 2048-slot caches, G=7), moonshot's
    # G=1 with ragged per-row lengths, and @reduced
    for B, H, Hkv, D, S, lengths in ((4, 28, 4, 128, 2048, [352] * 4),
                                     (4, 16, 16, 128, 2048, [700, 5, 1333, 2048]),
                                     (3, 4, 2, 64, 64, [37, 5, 64])):
        def cache():
            k = torch.randn((B, S, Hkv, D), generator=gen, device=dev)
            v = torch.randn((B, S, Hkv, D), generator=gen, device=dev)
            kq, ks, kz = KV.quantize_keys(k.to(torch.bfloat16))
            return kq, ks, kz, KV.cast_values(v, Q.FP8_DTYPE)
        caches = [cache() for _ in range(8 if H == 28 else 1)]
        q = (torch.randn((B, H, D), generator=gen, device=dev) / math.sqrt(D)).to(torch.bfloat16)
        uniform = len(set(lengths)) == 1
        length = torch.tensor(lengths[0] if uniform else lengths, dtype=torch.int32,
                              device=dev)
        args = (q, *caches[0], length)
        got = QA.quant_decode_attention(*args)
        want = QA.quant_decode_attention_plain(
            q, *caches[0], torch.tensor(lengths, dtype=torch.int32, device=dev))
        err = check_close("quant_decode_attention", got, want,
                          f"B={B} G={H // Hkv} D={D} S={S} lengths={lengths}")
        splits = QA.decode_splits(B, Hkv, -(-S // QA.DENSE_BLOCK))
        log(f"[kernels] quant_decode_attention G={H // Hkv} D={D} S={S} "
            f"lengths={lengths}: {splits} splits ({B * Hkv * splits} blocks), max abs "
            f"err {err:.3e}")
        if H == 28:
            sets = [(q, *c, length) for c in caches]
            ms = time_ms(QA.quant_decode_attention, sets)
            gms = graph_ms(QA.quant_decode_attention, sets)
            plens = torch.tensor(lengths, dtype=torch.int32, device=dev)
            plain_ms = time_ms(QA.quant_decode_attention_plain, [(q, *caches[0], plens)],
                               iters=5)
            kq, ks, kz, v = caches[0]
            G = H // Hkv
            kd = KV.dequantize_keys(kq, ks, kz).transpose(1, 2).repeat_interleave(G, dim=1)
            vd = v.to(torch.bfloat16).transpose(1, 2).repeat_interleave(G, dim=1)
            mask = (torch.arange(S, device=dev)[None] < plens[:, None])[:, None, None, :]
            lib_ms, lib_gms = library_time(lambda a, b, c, m: F.scaled_dot_product_attention(
                a, b, c, attn_mask=m, scale=1.0), [(q[:, :, None], kd, vd, mask)])
            live = sum(lengths)
            bytes_ = q.numel() * 2 + live * Hkv * (2 * D + 8) + B * H * D * 4
            results["quant_decode_attention"] = dict(
                err=err, ms=ms, graph_ms=gms, plain_ms=plain_ms, library_ms=lib_ms,
                library_graph_ms=lib_gms,
                bound=bound(bytes_, 4 * live * H * D, BF16_FLOPS_PER_S), splits=splits,
                shape=f"B={B} H={H} Hkv={Hkv} D={D} S={S} length={lengths[0]} "
                      "(Engine.generate decode, qwen2-7b)")
            b = results["quant_decode_attention"]["bound"]
            log(f"[kernels]   {ms:.4f} ms a call, {f4(gms)} ms on the device, bound "
                f"{b[0]:.5f} ms ({b[1]}); plain {plain_ms:.4f} ms; SDPA {f4(lib_ms)} ms a "
                f"call, {f4(lib_gms)} ms on the device")
            del kd, vd
        del caches

    # --- flash_prefill_attention (unquantized K/V) --------------------------
    # (B, T, S, H, Hkv, D, causal, window): Engine.generate's prefill at
    # qwen2-7b (a 320-token prompt over its cache cut to one 1024-key flash
    # block), the same non-causal and windowed, moonshot's G=1, and @reduced
    for B, T, S, H, Hkv, D, causal, window in (
            (1, 320, 1024, 28, 4, 128, True, 0), (1, 320, 1024, 28, 4, 128, False, 0),
            (1, 320, 1024, 28, 4, 128, True, 128), (1, 256, 1024, 16, 16, 128, True, 0),
            (2, 40, 64, 4, 2, 64, True, 8)):
        q = (torch.randn((B, T, H, D), generator=gen, device=dev) / math.sqrt(D)).to(torch.bfloat16)
        k = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
        args = (q, k, v)
        kw = dict(causal=causal, window=window)
        err = check_close("flash_prefill_attention", FP.flash_prefill_attention(*args, **kw),
                          FP.flash_prefill_attention_plain(*args, **kw),
                          f"T={T} S={S} G={H // Hkv} causal={causal} window={window}")
        log(f"[kernels] flash_prefill_attention T={T} S={S} G={H // Hkv} D={D} "
            f"causal={causal} window={window}: max abs err {err:.3e}")
        if (H, causal, window) == (28, True, 0):
            ms = time_ms(lambda *a: FP.flash_prefill_attention(*a, **kw), [args])
            gms = graph_ms(lambda *a: FP.flash_prefill_attention(*a, **kw), [args])
            plain_ms = time_ms(lambda *a: FP.flash_prefill_attention_plain(*a, **kw),
                               [args], iters=5)
            G = H // Hkv
            qpos = torch.arange(T, device=dev)
            mask = (torch.arange(S, device=dev)[None] <= qpos[:, None])[None, None]
            lib_ms, lib_gms = library_time(lambda a, b, c, m: F.scaled_dot_product_attention(
                a, b, c, attn_mask=m, scale=1.0),
                [(q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(G, dim=1),
                  v.transpose(1, 2).repeat_interleave(G, dim=1), mask)])
            pairs = sum(min(i + 1, S) for i in range(T))
            live_keys = min(S, T) if causal else S     # keys some query attends to
            bytes_ = (q.numel() * 2 + 2 * B * live_keys * Hkv * D * 2
                      + B * T * H * D * 4)
            results["flash_prefill_attention"] = dict(
                err=err, ms=ms, graph_ms=gms, plain_ms=plain_ms, library_ms=lib_ms,
                library_graph_ms=lib_gms,
                bound=bound(bytes_, 4 * B * H * D * pairs, BF16_FLOPS_PER_S),
                shape=f"B={B} T={T} S={S} H={H} Hkv={Hkv} D={D} causal "
                      "(Engine.generate prefill, qwen2-7b)")
            log(f"[kernels]   {ms:.4f} ms a call, {f4(gms)} ms on the device; plain "
                f"{plain_ms:.4f} ms; SDPA {f4(lib_ms)} ms a call, {f4(lib_gms)} ms on the device")
    torch.cuda.synchronize()


def bound(bytes_: float, ops: float, peak_ops: float):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

def make_trace(vocab: int, seed: int = 0):
    import numpy as np
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(1, vocab, 256)]
    specs = []
    for i in range(8):
        n = int(rng.integers(40, 701))
        if i % 3 == 0:
            n = max(n, 300)
            prompt = shared + [int(t) for t in rng.integers(1, vocab, n - 256)]
        else:
            prompt = [int(t) for t in rng.integers(1, vocab, n)]
        specs.append(prompt)
    arrivals = [0, 0, 1, 2, 4, 7, 11, 16]
    return specs, arrivals


def step_name(key) -> str:
    """A step shape's name: ("decode", 4, True) -> "decode4+lora"."""
    kind, n, lora = key
    return f"{kind}{n}" + ("+lora" if lora else "")


def make_loop(engine, cuda_graphs: bool = False, prefill_token_budget: int = 256):
    """The serving paths' ``EngineLoop``: 4 slots, 128-token chunks; eager on
    the card unless ``cuda_graphs``."""
    from repro_torch.serving import engine as E
    return E.EngineLoop(engine, max_slots=4, prefill_chunk=128,
                        prefill_token_budget=prefill_token_budget,
                        cuda_graphs=cuda_graphs)


def serve_trace(engine, specs, arrivals, max_new: int = 32, loop=None, adapters=None):
    """Drive ``EngineLoop`` (``loop``, by default a new eager one) through
    submit/step, request i under adapter ``adapters[i]`` if given; returns
    (loop, requests, wall seconds)."""
    import torch
    from repro_torch.serving import engine as E
    from repro_torch.serving import sampling as SM
    loop = make_loop(engine) if loop is None else loop
    sp = SM.SamplingParams(temperature=0.0, max_new_tokens=max_new)
    reqs = [E.Request(uid=i, prompt_tokens=p, max_new_tokens=max_new, sampling=sp,
                      adapter=adapters[i] if adapters else None)
            for i, p in enumerate(specs)]
    pending = sorted(range(len(reqs)), key=lambda i: (arrivals[i], i))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = 0
    while pending or loop.has_work():
        while pending and arrivals[pending[0]] <= step:
            loop.submit(reqs[pending.pop(0)])
        loop.step()
        step += 1
    torch.cuda.synchronize()
    return loop, reqs, time.perf_counter() - t0


def phase_main_path(dev):
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import registry
    from repro_torch.serving import engine as E

    cfg = registry.get("qwen2-7b")
    t0 = time.perf_counter()
    eng = E.build_engine(cfg, seed=0, max_seq=2048, device=dev)
    torch.cuda.synchronize()
    log(f"[main] qwen2-7b: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.padded_vocab_size}; weights + Flash embedding built in "
        f"{time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    specs, arrivals = make_trace(cfg.vocab_size)
    log(f"[main] trace: prompts {[len(p) for p in specs]}, arrivals {arrivals}; "
        "eager (cuda_graphs=False)")
    K.reset_launch_counts()
    loop, reqs, wall = serve_trace(eng, specs, arrivals)
    counts = K.launch_counts()
    s = eng.stats
    log(f"[main] launches during the trace: {counts}")
    assert all(r.done and len(r.generated) == 32 for r in reqs), "unfinished requests"
    assert loop.pool.prefix_hits > 0, "the shared prefix was never adopted"
    for name in LOOP_KERNELS:
        assert counts[name] > 0, f"{name} never launched on the EngineLoop path: {counts}"
    assert eng.dispatch.fallbacks == [], eng.dispatch.fallbacks
    new_tokens = sum(len(r.generated) for r in reqs)
    summary = {
        "wall_s": wall, "new_tokens": new_tokens,
        "prefill_tokens": s.prefill_tokens, "prefix_hits_pages": loop.pool.prefix_hits,
        "shared_prompt_tokens": s.shared_prompt_tokens,
        "ttft_p50_ms": s.ttft(50) * 1e3, "ttft_p95_ms": s.ttft(95) * 1e3,
        "tpot_p50_ms": s.tpot(50) * 1e3, "tpot_p95_ms": s.tpot(95) * 1e3,
        "decode_tok_per_s": s.decode_tps, "prefill_tok_per_s": s.prefill_tps,
        "launches": counts,
    }
    log(f"[main] {len(reqs)} requests, {new_tokens} new tokens in {wall:.2f} s; "
        f"TTFT p50 {summary['ttft_p50_ms']:.1f} ms p95 {summary['ttft_p95_ms']:.1f} ms; "
        f"TPOT p50 {summary['tpot_p50_ms']:.2f} ms; decode {s.decode_tps:.1f} tok/s; "
        f"prefill {s.prefill_tps:.1f} tok/s; prefix pages adopted "
        f"{loop.pool.prefix_hits}")
    return eng, specs, arrivals, reqs, summary


def phase_graphs(label: str, eng, specs, arrivals, eager_reqs, max_new: int,
                 kernels, spies=None) -> dict:
    """The trace of an eager ``EngineLoop`` run again through a warmed loop's
    CUDA graphs (one per decode bucket, or the one 4-row step, and one per
    chunk size): warmup time and the device memory the graph pool reserves,
    then every request finishes with the eager run's greedy tokens, token
    for token, no graph is captured after warmup, each kernel of ``kernels``
    launched (a replay adds what its capture recorded) and nothing fell
    back.  ``spies`` (a context manager) wraps the warmup, whose eager runs
    and captures are the only Python calls the graphs' steps make."""
    import contextlib
    import statistics
    import torch
    from repro_torch import kernels as K
    from repro_torch.serving import engine as E
    dev = eng.device
    eng.stats = E.EngineStats()
    loop = make_loop(eng, cuda_graphs=True)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()          # as a capture does: what stays is the graphs'
    reserved0 = torch.cuda.memory_reserved(dev)
    with spies if spies is not None else contextlib.nullcontext():
        rep = loop.warmup()
    reserved1 = torch.cuda.memory_reserved(dev)
    log(f"[graphs] {label}: warmup captured {rep['graphs']} CUDA graphs (decode buckets "
        f"{rep['decode_buckets']}, chunk sizes {rep['chunk_sizes']}) in "
        f"{rep['warmup_s']:.2f} s; device memory reserved {reserved0 / 2**30:.2f} -> "
        f"{reserved1 / 2**30:.2f} GiB (+{(reserved1 - reserved0) / 2**20:.1f} MiB)")
    assert rep["graphs"] == len(rep["decode_buckets"]) + len(rep["chunk_sizes"]), rep
    assert loop.warmup()["graphs"] == rep["graphs"], "a second warmup captured again"
    # the host's time in one replay call (the launch of every node), unprofiled:
    # after warmup each graph's inputs are the warm run's (all-trash table,
    # every row inactive), so these replays change no state
    replay_ms = {}
    for key, graph in loop._graphs.items():
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graph.replay()
            times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        replay_ms[step_name(key)] = statistics.median(times) * 1e3
    log(f"[graphs] {label}: host time of one replay call, median of 5: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in replay_ms.items()))
    K.reset_launch_counts()
    _, reqs, wall = serve_trace(eng, specs, arrivals, max_new=max_new, loop=loop)
    counts = K.launch_counts()
    s = eng.stats
    log(f"[graphs] {label}: launches during the trace: {counts}")
    assert all(r.done and len(r.generated) == max_new for r in reqs), "unfinished requests"
    differ = [r.uid for r, e in zip(reqs, eager_reqs) if r.generated != e.generated]
    assert not differ, f"{label}: greedy tokens differ from the eager run for {differ}"
    assert s.recompiles_after_warmup == 0, f"{s.recompiles_after_warmup} captures after warmup"
    for name in kernels:
        assert counts[name] > 0, f"{name} never launched inside the graphs: {counts}"
    assert eng.dispatch.fallbacks == [], eng.dispatch.fallbacks
    new_tokens = sum(len(r.generated) for r in reqs)
    summary = {
        "warmup": rep, "graph_pool_reserved_mib": (reserved1 - reserved0) / 2**20,
        "replay_host_ms": replay_ms,
        "memory_reserved_gib": [reserved0 / 2**30, reserved1 / 2**30],
        "wall_s": wall, "new_tokens": new_tokens, "prefill_tokens": s.prefill_tokens,
        "ttft_p50_ms": s.ttft(50) * 1e3, "ttft_p95_ms": s.ttft(95) * 1e3,
        "tpot_p50_ms": s.tpot(50) * 1e3, "tpot_p95_ms": s.tpot(95) * 1e3,
        "decode_tok_per_s": s.decode_tps, "prefill_tok_per_s": s.prefill_tps,
        "compile_events": s.compile_events,
        "recompiles_after_warmup": s.recompiles_after_warmup,
        "graph_launches": {step_name(k): v for k, v in loop._graph_launches.items()},
        "launches": counts, "tokens_equal_eager": True,
    }
    log(f"[graphs] {label}: {len(reqs)} requests, {new_tokens} new tokens in {wall:.2f} s, "
        f"greedy tokens equal to the eager run's; TTFT p50 {summary['ttft_p50_ms']:.1f} ms "
        f"p95 {summary['ttft_p95_ms']:.1f} ms; TPOT p50 {summary['tpot_p50_ms']:.2f} ms; "
        f"decode {s.decode_tps:.1f} tok/s; prefill {s.prefill_tps:.1f} tok/s; "
        f"{s.recompiles_after_warmup} captures after warmup")
    loop.close()
    return summary


def count_syncs(step) -> dict:
    """The host-device synchronizations of one ``step()``: torch's sync debug
    mode warns at each one (a blocking copy, ``.item()``, ``.cpu()``), and
    the warning names the Python line that asked for it."""
    import collections
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    where = collections.Counter()
    for w in caught:      # (not the mode's own "prototype feature" notice)
        msg = str(w.message)
        if "synchroniz" in msg and "prototype" not in msg:
            f = Path(w.filename)
            where[f"{f.relative_to(ROOT) if f.is_relative_to(ROOT) else f.name}:{w.lineno}"] += 1
    return {"syncs_per_step": sum(where.values()), "sync_sites": dict(where.most_common())}


def profile_steps(label: str, step, steps: int = 4) -> dict:
    """Where a decode step's time goes: wall time per ``step()``, the
    host-device synchronizations of one step, and the device's busy share
    and top kernels under ``torch.profiler`` (reported, not asserted; "not
    measured" where the profiler sees no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step()
    syncs = count_syncs(step)
    gc.collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enqueue = 0.0
    for _ in range(steps):
        t1 = time.perf_counter()
        step()
        enqueue += time.perf_counter() - t1      # host time until the call returns
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    out = {"decode_step_ms": step_ms, "host_enqueue_ms": enqueue / steps * 1e3, **syncs}
    log(f"[profile] {label}: {syncs['syncs_per_step']} host-device synchronizations "
        f"per step at {syncs['sync_sites']}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = []          # device kernels only (host ops would count them twice)
    api = []           # the host's time in CUDA runtime calls (launches, copies, waits)
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            if e.key.startswith("cuda") and e.cpu_time_total > 0:
                api.append((e.cpu_time_total, e.count, e.key))
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            kern.append((dev_us, e.count, e.key))
    kern.sort(reverse=True)
    busy = sum(k[0] for k in kern)
    if busy > 0:
        ours = sum(us for us, _c, n in kern if any(k in n for k in PORT_KERNEL_SYMBOLS))
        out["device_busy_share"] = busy / wall_us
        out["profiled_step_ms"] = wall_us / steps / 1e3
        out["device_ms_per_step"] = busy / steps / 1e3
        out["port_kernel_ms_per_step"] = ours / steps / 1e3
        out["device_launches_per_step"] = sum(c for _u, c, _n in kern) / steps
        out["top_kernels"] = [{"name": n[:80], "ms_per_step": us / steps / 1e3,
                               "launches_per_step": c / steps} for us, c, n in kern[:10]]
        out["port_kernels"] = {
            sym: {"ms_per_step": sum(us for us, _c, n in kern if sym in n) / steps / 1e3,
                  "launches_per_step": sum(c for _u, c, n in kern if sym in n) / steps}
            for sym in PORT_KERNEL_SYMBOLS if any(sym in n for _u, _c, n in kern)}
        log(f"[profile] {label}: {step_ms:.1f} ms wall ({out['host_enqueue_ms']:.1f} ms "
            f"until the host's calls return); under the profiler "
            f"{out['profiled_step_ms']:.1f} ms, device busy "
            f"{100 * out['device_busy_share']:.1f}% ({out['device_ms_per_step']:.1f} ms "
            f"of kernels, {out['port_kernel_ms_per_step']:.1f} ms in the port's, "
            f"{out['device_launches_per_step']:.0f} launches)")
        for k in out["top_kernels"][:6]:
            log(f"[profile]   {k['ms_per_step']:8.3f} ms/step  "
                f"{k['launches_per_step']:6.0f} launches  {k['name']}")
        log(f"[profile] {label}: the port's kernels per step: " + ", ".join(
            f"{sym} {k['ms_per_step']:.3f} ms ({k['launches_per_step']:.0f})"
            for sym, k in out["port_kernels"].items()))
        api.sort(reverse=True)
        out["runtime_calls"] = {n: {"host_ms_per_step": us / steps / 1e3,
                                    "calls_per_step": c / steps} for us, c, n in api[:6]}
        log(f"[profile] {label}: host time in CUDA runtime calls per step: " + ", ".join(
            f"{n} {k['host_ms_per_step']:.2f} ms ({k['calls_per_step']:.0f})"
            for n, k in out["runtime_calls"].items()))
    else:
        out["device_busy_share"] = "not measured"
        log(f"[profile] {label}: {step_ms:.1f} ms wall; the profiler saw no device "
            "time (device busy share not measured)")
    return out


def profile_loop_decode(eng, specs, steps: int = 4, cuda_graphs: bool = False,
                        adapters=(None,) * 4) -> dict:
    """A full-batch ``EngineLoop`` step with four rows decoding (row i under
    adapter ``adapters[i]``), eager or (``cuda_graphs``, after ``warmup()``)
    replaying its CUDA graph."""
    from repro_torch.serving import engine as E
    from repro_torch.serving import sampling as SM
    loop = make_loop(eng, cuda_graphs=cuda_graphs, prefill_token_budget=512)
    if cuda_graphs:
        loop.warmup()
    sp = SM.SamplingParams(temperature=0.0, max_new_tokens=64)
    for i, p in enumerate(specs[:4]):
        loop.submit(E.Request(uid=100 + i, prompt_tokens=p[:128], max_new_tokens=64,
                              sampling=sp, adapter=adapters[i]))
    while loop._prefilling or sum(r is not None for r in loop.scheduler.running) < 4:
        loop.step()
    how = ("CUDA graphs" if cuda_graphs else "eager") + (
        f", adapters {list(adapters)}" if any(adapters) else "")
    out = profile_steps(f"{eng.cfg.name} EngineLoop decode step, 4 rows, {how}",
                        loop.step, steps)
    out["rows"] = 4
    while loop.has_work():
        loop.step()
    loop.close()
    return out


# ---------------------------------------------------------------------------
# kernel path against plain path at full width, layer by layer
# ---------------------------------------------------------------------------

def run_layers(engine, x, mode, positions, pos, table, caches, fed, lora=None):
    """Every layer of the (single-stack) model on ``x``; with ``fed``
    (another run's per-layer outputs) layer i takes that run's output of
    layer i-1 instead of its own input, and the logits are taken on that
    run's last hidden state.  ``lora``: the step's adapter tables and ids."""
    from repro_torch.core.precision import DEFAULT_POLICY
    from repro_torch.models import transformer as T
    cfg = engine.cfg
    stack = engine.params["stacks"][0][0]
    outs = []
    for li in range(cfg.num_layers):
        inp = x if fed is None or li == 0 else fed[li - 1]
        x, _ = T._apply_layer(inp, T.layer_slice(stack, li), cfg, cfg.period[0], mode,
                              positions, caches.layer(li), pos, table, engine.dispatch,
                              DEFAULT_POLICY, lora=lora)
        outs.append(x)
    last = outs[-1] if fed is None else fed[-1]
    return outs, T._logits(last[:, -1:], engine.params, cfg, engine.dispatch)[:, 0]


def chunk_then_decode(engine, prompt, nxt, feed=None, lora=None):
    """One 128-token prompt chunk into a fresh paged pool and the decode step
    of token ``nxt`` after it (``lora``: the adapter tables and the row's id,
    carried by both).  Returns the per-layer hidden states and the logits of
    both."""
    import numpy as np
    import torch
    from repro_torch.serving import engine as E
    dev = engine.device
    loop = E.EngineLoop(engine, max_slots=4, prefill_chunk=128)
    loop.pool.alloc_row(0, 129)
    cache = loop.cache
    cache["table"] = torch.as_tensor(loop.pool.table, device=dev)
    pool = cache["stacks"][0][0]
    ids = np.asarray(prompt[:128], np.int64)[None]
    chunk = run_layers(engine, engine.embed(ids), "prefill_paged",
                       torch.arange(128, device=dev)[None], 0, cache["table"][0], pool,
                       None if feed is None else feed["chunk"][0], lora)
    pos = torch.tensor([128], dtype=torch.int32, device=dev)
    dec = run_layers(engine, engine.embed(np.asarray([[nxt]], np.int64)), "decode",
                     pos[:, None], pos, cache["table"][:1], pool,
                     None if feed is None else feed["decode"][0], lora)
    return {"chunk": chunk, "decode": dec}


def prefill_then_decode(engine, prompt, nxt, feed=None):
    """``Engine.generate``'s steps: the whole prompt into a fresh dense cache
    of ``max_seq`` slots, then the decode step of token ``nxt``."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    dev = engine.device
    T_ = len(prompt)
    caches = T.init_cache(engine.cfg, 1, engine.max_seq, device=dev)["stacks"][0][0]
    pre = run_layers(engine, engine.embed(np.asarray(prompt, np.int64)[None]), "prefill",
                     torch.arange(T_, device=dev)[None], None, None, caches,
                     None if feed is None else feed["prefill"][0])
    pos = torch.tensor(T_, dtype=torch.int32, device=dev)
    dec = run_layers(engine, engine.embed(np.asarray([[nxt]], np.int64)), "decode",
                     pos.expand(1, 1), pos, None, caches,
                     None if feed is None else feed["decode"][0])
    return {"prefill": pre, "decode": dec}


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def routed(steps_fn, engine, prompt, nxt, feed=None):
    """``steps_fn`` with the router's top-k ids of every MoE layer recorded,
    in call order (one call per layer and step)."""
    from repro_torch.models import moe as M
    ids, route = [], M._route

    def recording(*a, **kw):
        out = route(*a, **kw)
        ids.append(out[3].reshape(-1, out[3].shape[-1]).sort(dim=-1).values)
        return out
    M._route = recording
    try:
        return steps_fn(engine, prompt, nxt, feed), ids
    finally:
        M._route = route


def compare_paths(label: str, eng, steps_fn, prompt, nxt) -> dict:
    """Kernel path against plain path at full width and depth.  Free running,
    the int8 re-quantization of every linear's input turns last-bit
    differences into whole quantization steps, so the runs drift apart with
    depth; that drift is printed.  The assertion holds every layer, and the
    head, to the tolerance on the same input.  On an MoE model a token whose
    router picks another expert set in the two runs (a near tie decided by
    float noise) is a discrete change, not a kernel error: such tokens are
    counted, bounded by MAX_ROUTE_FLIPS, and left out of that layer's error."""
    import torch
    from repro_torch.serving import engine as E
    plain = E.Engine(eng.cfg, eng.params, eng.embedding, max_seq=eng.max_seq,
                     device=eng.device, backend="reference")
    V = eng.cfg.vocab_size
    ref, ref_ids = routed(steps_fn, plain, prompt, nxt)
    free = steps_fn(eng, prompt, nxt)
    forced, forced_ids = routed(steps_fn, eng, prompt, nxt, feed=ref)
    per_step = len(ref_ids) // max(1, len(ref))        # MoE layers per step
    out = {}
    for si, what in enumerate(ref):
        (ref_h, ref_l), (free_h, free_l), (forced_h, forced_l) = (
            ref[what], free[what], forced[what])
        for t in (ref_l, free_l, forced_l):
            assert torch.isfinite(t).all(), what
        drift = [rel_l2(a, b) for a, b in zip(free_h, ref_h)]
        per_layer, flipped, tokens = [], 0, 0
        for li, (a, b) in enumerate(zip(forced_h, ref_h)):
            keep = torch.ones(a.shape[1], dtype=torch.bool, device=a.device)
            if per_step:
                ra, rb = forced_ids[si * per_step + li], ref_ids[si * per_step + li]
                keep = (ra == rb).all(dim=-1)
                flipped += int((~keep).sum())
                tokens += keep.numel()
            per_layer.append(rel_l2(a[:, keep], b[:, keep]) if keep.any() else 0.0)
        head = rel_l2(forced_l[:, :V], ref_l[:, :V])
        free_logits = rel_l2(free_l[:, :V], ref_l[:, :V])
        out[what] = {"per_layer_rel_l2": per_layer, "head_rel_l2": head,
                     "free_running_rel_l2_by_layer": drift,
                     "free_running_logits_rel_l2": free_logits,
                     "logit_std": float(ref_l[:, :V].std())}
        flips = ""
        if per_step:
            out[what]["route_flips"] = {"tokens_x_layers": tokens, "flipped": flipped}
            flips = f"; router top-k differs for {flipped} of {tokens} token-layers"
        log(f"[check] {label} {what}: kernel vs plain on the same input: max over "
            f"layers rel L2 {max(per_layer):.3e} (tolerance {LAYER_REL_L2}), head rel L2 "
            f"{head:.3e} (tolerance {HEAD_REL_L2}){flips}; free running: layer 1 "
            f"{drift[0]:.3e}, layer {len(drift) // 2} {drift[len(drift) // 2 - 1]:.3e}, "
            f"layer {len(drift)} {drift[-1]:.3e}, logits {free_logits:.3e} (printed, "
            "not asserted)")
        assert max(per_layer) <= LAYER_REL_L2, f"{label} {what}: a layer disagrees {per_layer}"
        assert head <= HEAD_REL_L2, f"{label} {what}: logits disagree, rel L2 {head:.3e}"
        assert flipped <= MAX_ROUTE_FLIPS * max(tokens, 1), f"{label} {what}: {flips}"
    return out


def phase_kernel_vs_plain(eng, specs, arrivals, reqs):
    """The continuous path's layer check, plus the greedy agreement of the
    whole trace on the plain path (printed, not asserted)."""
    from repro_torch.serving import engine as E
    prompt = next(p for p in specs if len(p) > 128)
    out = compare_paths("EngineLoop", eng, chunk_then_decode, prompt, prompt[128])
    plain = E.Engine(eng.cfg, eng.params, eng.embedding, max_seq=eng.max_seq,
                     device=eng.device, backend="reference")
    t0 = time.perf_counter()
    _, preqs, _ = serve_trace(plain, specs, arrivals)
    same_req = sum(a.generated == b.generated for a, b in zip(reqs, preqs))
    agree = sum(sum(x == y for x, y in zip(a.generated, b.generated))
                for a, b in zip(reqs, preqs))
    total = sum(len(a.generated) for a in reqs)
    out["greedy"] = {"requests_identical": same_req, "requests": len(reqs),
                     "tokens_equal": agree, "tokens": total,
                     "plain_trace_s": time.perf_counter() - t0}
    log(f"[check] greedy agreement over the trace (plain path on the card): "
        f"{same_req}/{len(reqs)} requests identical, {agree}/{total} tokens equal "
        f"position by position (printed, not asserted)")
    return out


# ---------------------------------------------------------------------------
# phase 4: Engine.generate at full width
# ---------------------------------------------------------------------------

def phase_generate(eng) -> dict:
    """Four greedy requests with equal-length prompts through the
    slot-synchronous ``Engine.generate`` (it decodes the batch at request
    0's position, so unequal prompts would decode at the wrong offsets)."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as E
    from repro_torch.serving import sampling as SM
    cfg = eng.cfg
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, 320)] for _ in range(4)]
    reqs = [E.Request(uid=i, prompt_tokens=p, max_new_tokens=32)
            for i, p in enumerate(prompts)]
    eng.stats = E.EngineStats()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(reqs, SM.SamplingParams(temperature=0.0, max_new_tokens=32))
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    s = eng.stats
    log(f"[generate] launches: {counts}")
    assert all(r.done and len(r.generated) == 32 for r in reqs), "unfinished requests"
    for name in ("quant_decode_attention", "flash_prefill_attention", "w4a8_matmul",
                 "rmsnorm"):
        assert counts[name] > 0, f"{name} never launched on Engine.generate: {counts}"
    assert eng.dispatch.fallbacks == [], eng.dispatch.fallbacks
    summary = {"wall_s": wall, "requests": 4, "prompt_tokens": 320, "new_tokens": 128,
               "prefill_s": s.prefill_s, "decode_s": s.decode_s,
               "prefill_tok_per_s": s.prefill_tps, "decode_tok_per_s": s.decode_tps,
               "decode_step_ms": s.decode_s / 31 * 1e3, "launches": counts}
    log(f"[generate] 4 requests x 320-token prompts, 128 new tokens in {wall:.2f} s; "
        f"prefill {s.prefill_tps:.1f} tok/s ({s.prefill_s:.2f} s), decode "
        f"{s.decode_tps:.1f} tok/s ({summary['decode_step_ms']:.1f} ms a 4-row step)")
    caches = [T.prefill(eng.params, cfg, eng.embed(np.asarray(p)[None]), eng.max_seq,
                        eng.dispatch)[1] for p in prompts]
    state = {"cache": E._concat_caches(caches)}
    embeds = eng.embed(np.asarray([[p[-1]] for p in prompts]))

    def step():
        _, state["cache"] = T.decode_step(eng.params, cfg, embeds, state["cache"],
                                          eng.dispatch)
    summary["profile"] = profile_steps("qwen2-7b Engine.generate decode step, 4 rows",
                                       step)
    summary["kernel_vs_plain"] = compare_paths("Engine.generate", eng, prefill_then_decode,
                                               prompts[0], prompts[1][0])
    return summary


# ---------------------------------------------------------------------------
# phase 4a: multi-LoRA and the streaming gateway at full width
# ---------------------------------------------------------------------------

LORA_NEW = 16
# adapter factors: A ~ N(0, 1/d) keeps x.A at the input's rms (RMSNorm'd, ~1);
# B ~ N(0, LORA_B_STD^2) then puts the bypass at about sqrt(rank) * LORA_B_STD,
# against ~sqrt(d) * 0.02 = 1.2 for a random projection (weights N(0, 0.02^2)):
# a third to a half of it at rank 4-8, so an adapter row's greedy tokens leave
# the base model's
LORA_B_STD = 0.2
GATEWAY_NEW = 16


def lora_factors(cfg, rank: int, rng):
    """One adapter: ((A_q [d, r], B_q [r, H*hd]), (A_v [d, r], B_v [r, Hkv*hd]))."""
    import numpy as np
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return tuple((rng.normal(size=(d, rank)).astype(np.float32) / math.sqrt(d),
                  rng.normal(size=(rank, heads * hd)).astype(np.float32) * LORA_B_STD)
                 for heads in (cfg.num_heads, cfg.num_kv_heads))


def lora_trace(vocab: int, seed: int = 4):
    """Five requests on 4 slots: base and adapter rows decoding in one
    bucket, prompt 0 under no adapter and then under A (different salt: no
    adoption), and again under A after a slot frees (adopts A's pages)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    p0, p1, p2 = ([int(t) for t in rng.integers(1, vocab, n)] for n in (300, 200, 150))
    trace = [(p0, None, 0), (p1, "B", 0), (p2, None, 1), (p0, "A", 5), (p0, "A", 10)]
    return [t[0] for t in trace], [t[1] for t in trace], [t[2] for t in trace]


def snoop_adoption(loop) -> dict:
    """uid -> prompt tokens the request adopted from the prefix index."""
    shared, admit = {}, loop._admit_into_slot

    def admit_into_slot(req, slot):
        admit(req, slot)
        shared[req.uid] = int(loop.pool.row_shared[slot])
    loop._admit_into_slot = admit_into_slot
    return shared


def bypass_ratio(eng, prompt) -> dict:
    """||bypass|| / ||projection|| of each loaded adapter at layer 0's q and v
    on a prompt's first 128 tokens."""
    import numpy as np
    import torch
    from repro_torch.core import lora as LR
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cfg = eng.cfg
    lp = T.layer_slice(eng.params["stacks"][0][0], 0)
    h = L.rms_norm(eng.embed(np.asarray(prompt[:128], np.int64)[None]), lp["ln1"],
                   cfg.rms_eps, eng.dispatch)
    out = {}
    for name, slot in sorted(eng.lora_q._names.items()):
        ids = torch.tensor([slot], device=eng.device)
        for proj, reg in (("q", eng.lora_q), ("v", eng.lora_v)):
            y = L.apply_linear(h, lp["attn"]["w" + proj], cfg.quant, eng.dispatch)
            byp = LR.lora_apply_batched(h, *reg.device_tables(), ids)
            out[f"{name}.{proj}"] = float(byp.norm() / y.float().norm())
    return out


def phase_lora(eng, card: str) -> dict:
    """Multi-LoRA (C7) on the qwen2-7b engine: a mixed trace with no adapter
    loaded (every row the base model's), then with adapters A (rank 8) and B
    (rank 4) eagerly and on a loop warmed with them loaded; a third adapter
    loaded after warmup; one LoRA chunk and decode step on the kernels
    against the plain path; ``Engine.generate`` with an adapter row.  Leaves
    A, B and C loaded."""
    import functools
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.serving import engine as E
    from repro_torch.serving import sampling as SM
    cfg = eng.cfg
    assert not eng.lora_q._names, "the engine already has adapters"
    rng = np.random.default_rng(0)
    factors = {"A": lora_factors(cfg, 8, rng), "B": lora_factors(cfg, 4, rng),
               "C": lora_factors(cfg, 8, rng)}
    specs, adapters, arrivals = lora_trace(cfg.vocab_size)
    t0 = time.perf_counter()
    # no adapter loaded: the reference ignores the names (only the prefix
    # salt reads them), so every row is the base model's
    loop, base, _ = serve_trace(eng, specs, arrivals, LORA_NEW, adapters=adapters)
    loop.close()
    for name in ("A", "B"):
        eng.load_adapter(name, *factors[name])
    ratio = bypass_ratio(eng, specs[0])
    log(f"[lora] adapters A (rank 8), B (rank 4): bypass / projection norm at layer 0: "
        + ", ".join(f"{k} {v:.3f}" for k, v in ratio.items()))

    def run(cuda_graphs: bool):
        eng.stats = E.EngineStats()
        loop = make_loop(eng, cuda_graphs=cuda_graphs)
        shared = snoop_adoption(loop)
        rep = loop.warmup() if cuda_graphs else None
        K.reset_launch_counts()
        _, reqs, wall = serve_trace(eng, specs, arrivals, LORA_NEW, loop=loop,
                                    adapters=adapters)
        counts = K.launch_counts()
        how = "CUDA graphs" if cuda_graphs else "eager"
        assert all(r.done and len(r.generated) == LORA_NEW for r in reqs), how
        for name in LOOP_KERNELS:
            assert counts[name] > 0, f"[lora] {how}: {name} never launched: {counts}"
        assert eng.dispatch.fallbacks == [], eng.dispatch.fallbacks
        assert shared[3] == 0, f"[lora] {how}: adopted across adapters {shared}"
        assert shared[4] > 0, f"[lora] {how}: no adoption under one adapter {shared}"
        s = eng.stats
        log(f"[lora] {how}: {len(reqs)} requests (adapters {adapters}, prompts "
            f"{[len(p) for p in specs]}) in {wall:.2f} s; TTFT p50 {s.ttft(50) * 1e3:.1f} ms "
            f"p95 {s.ttft(95) * 1e3:.1f} ms; TPOT p50 {s.tpot(50) * 1e3:.2f} ms; prompt "
            f"tokens adopted by uid {shared}; launches {counts} ({card})")
        return loop, reqs, {"wall_s": wall, "ttft_p50_ms": s.ttft(50) * 1e3,
                            "ttft_p95_ms": s.ttft(95) * 1e3, "tpot_p50_ms": s.tpot(50) * 1e3,
                            "adopted_tokens": shared, "launches": counts, "warmup": rep}
    loop, eager, out_e = run(False)
    loop.close()
    gloop, graphs, out_g = run(True)
    s = eng.stats
    assert all(key[2] for key in gloop._graphs), "a graph was captured without LoRA"
    assert s.recompiles_after_warmup == 0, f"{s.recompiles_after_warmup} captures after warmup"
    differ = [r.uid for r, e in zip(graphs, eager) if r.generated != e.generated]
    assert not differ, f"[lora] graph tokens differ from eager for {differ}"
    for r, b, a in zip(eager, base, adapters):
        if a is None:
            assert r.generated == b.generated, f"[lora] base row {r.uid} moved"
        else:
            assert r.generated != b.generated, f"[lora] adapter row {r.uid} equals base"
    # a third adapter loaded after warmup: written into the tables in place,
    # no capture, and the next replay reads it
    ev0 = gloop.compile_events()
    eng.load_adapter("C", *factors["C"])
    sp = SM.SamplingParams(temperature=0.0, max_new_tokens=LORA_NEW)

    def one_c(loop):
        req = E.Request(uid=100, prompt_tokens=specs[1], max_new_tokens=LORA_NEW,
                        sampling=sp, adapter="C")
        loop.submit(req)
        while loop.has_work():
            loop.step()
        return req.generated
    c_graph = one_c(gloop)
    assert gloop.compile_events() == ev0 and s.recompiles_after_warmup == 0, \
        "loading an adapter after warmup captured a graph"
    gloop.close()
    # a 4-row decode step on its graph with adapter rows, beside the base
    # step [profile] measured on the same engine earlier in this run
    profile = profile_loop_decode(eng, specs, cuda_graphs=True,
                                  adapters=(None, "A", "B", "C"))
    eloop = make_loop(eng)
    c_eager = one_c(eloop)
    eloop.close()
    assert c_graph == c_eager, "[lora] adapter C on the graphs differs from eager"
    assert c_graph != base[1].generated, "[lora] adapter C equals the base model"
    log(f"[lora] graphs: warmup {out_g['warmup']['graphs']} graphs in "
        f"{out_g['warmup']['warmup_s']:.2f} s, all with LoRA on; tokens equal eager; base "
        f"rows equal the no-adapter loop, adapter rows differ; 0 captures after warmup; "
        f"adapter C loaded after warmup: no capture, its replay equals eager ({card})")
    # one LoRA chunk and decode step (adapter A), kernel path against plain
    ids = torch.tensor([eng.lora_q.slot("A")], device=eng.device)
    check = compare_paths("EngineLoop + LoRA", eng,
                          functools.partial(chunk_then_decode, lora=eng._lora_tables(ids)),
                          specs[0], specs[0][128])
    # Engine.generate: two 256-token prompts, one under adapter A
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, 256)] for _ in range(2)]
    greqs = [E.Request(uid=i, prompt_tokens=p, max_new_tokens=LORA_NEW, adapter=a)
             for i, (p, a) in enumerate(zip(prompts, ("A", None)))]
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng.generate(greqs, sp)
    gen_wall = time.perf_counter() - t1
    gen_counts = K.launch_counts()
    assert all(r.done and len(r.generated) == LORA_NEW for r in greqs)
    for name in ("quant_decode_attention", "flash_prefill_attention", "w4a8_matmul",
                 "rmsnorm"):
        assert gen_counts[name] > 0, f"{name} never launched on Engine.generate: {gen_counts}"
    assert eng.dispatch.fallbacks == [], eng.dispatch.fallbacks
    log(f"[lora] Engine.generate, 2 x 256-token prompts (adapter A, none), {LORA_NEW} new "
        f"tokens in {gen_wall:.2f} s; launches {gen_counts}")
    return {"bypass_ratio": ratio, "eager": out_e, "graphs": out_g,
            "recompiles_after_warmup": s.recompiles_after_warmup,
            "tokens_equal_eager": True, "base_rows_equal_no_adapter": True,
            "late_load_captures": 0, "kernel_vs_plain": check,
            "generate": {"wall_s": gen_wall, "launches": gen_counts},
            "profile_graphs": profile,
            "launches": out_e["launches"], "graph_launches": out_g["launches"],
            "generate_launches": gen_counts, "phase_s": time.perf_counter() - t0}


def http_round_trip(url: str, prompt, adapter) -> dict:
    """SSE ``/v1/completions``, ``/healthz`` and ``/v1/stats`` with urllib."""
    import urllib.request
    body = json.dumps({"prompt": prompt, "max_tokens": GATEWAY_NEW, "adapter": adapter,
                       "stream": True}).encode()
    req = urllib.request.Request(url + "/v1/completions", data=body,
                                 headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=300) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        for line in r:
            line = line.decode().strip()
            if line:
                data = line[len("data: "):]
                events.append(data if data == "[DONE]" else json.loads(data))
    assert events[-1] == "[DONE]" and len(events) == GATEWAY_NEW + 1, events[-2:]
    reasons = [e["choices"][0]["finish_reason"] for e in events[:-1]]
    assert reasons == [None] * (GATEWAY_NEW - 1) + ["length"], reasons
    with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
        health = json.loads(r.read())
        assert r.status == 200 and health["ready"] is True, health
    with urllib.request.urlopen(url + "/v1/stats", timeout=60) as r:
        stats = json.loads(r.read())
    assert stats["recompiles_after_warmup"] == 0, stats
    return {"tokens": [e["choices"][0]["token"] for e in events[:-1]], "healthz": health,
            "stats_recompiles_after_warmup": stats["recompiles_after_warmup"]}


def phase_gateway(eng, card: str) -> dict:
    """The streaming gateway over a graph loop on the qwen2-7b engine (with
    adapters A, B and C loaded): ``EngineService(warmup=True)`` is not ready
    while its engine thread captures the graphs; six threads submit at once
    meanwhile (host work only), mixed across adapters, and each stream
    carries the tokens ``EngineLoop.run`` commits on graphs; a second round
    after warmup gives TTFT and TPOT through the service.  Where aiohttp is
    installed, the HTTP round trip through ``GatewayServer``.  Unloads the
    adapters at the end."""
    import concurrent.futures
    import importlib.util
    import threading
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.serving import engine as E
    from repro_torch.serving import gateway as G
    from repro_torch.serving import sampling as SM
    cfg = eng.cfg
    t0 = time.perf_counter()
    have_http = importlib.util.find_spec("aiohttp") is not None
    rng = np.random.default_rng(7)
    # distinct lengths: the queue orders equal arrivals by cost, not by uid,
    # so the service admits them in the order EngineLoop.run does
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in (260, 96, 180, 64, 140, 220)]
    adapters = [None, "A", "B", "C", None, "A"]
    sp = SM.SamplingParams(temperature=0.0, max_new_tokens=GATEWAY_NEW)
    ref_loop = make_loop(eng, cuda_graphs=True)
    ref_loop.warmup()
    ref = ref_loop.run([E.Request(uid=i, prompt_tokens=p, max_new_tokens=GATEWAY_NEW,
                                  sampling=sp, adapter=a)
                        for i, (p, a) in enumerate(zip(prompts, adapters))])
    ref_loop.close()
    want = {tuple(r.prompt_tokens): r.generated for r in ref}

    eng.stats = E.EngineStats()
    loop = make_loop(eng, cuda_graphs=True)
    svc = G.EngineService(loop, warmup=True)
    gw = G.GatewayServer(svc, model_name=cfg.name) if have_http else None
    first = {}
    inner = loop.on_token

    def on_token(req, tok, done):           # engine thread, at each emission
        first.setdefault(req.uid, (done, loop.has_work()))
        inner(req, tok, done)
    loop.on_token = on_token
    gc.collect()
    K.reset_launch_counts()
    t_start = time.perf_counter()
    (gw if gw is not None else svc).start()
    ready_at_start = svc.ready
    barrier = threading.Barrier(len(prompts))

    def client(i):
        barrier.wait()
        return svc.submit(prompts[i], sp, adapter=adapters[i])
    with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
        streams = list(pool.map(client, range(len(prompts))))
    submitted_while_warming = not svc.ready
    while not svc.ready:                     # host state only: no CUDA call
        assert svc._thread.is_alive(), "the engine thread died during warmup"
        time.sleep(0.01)
    warmup_s = time.perf_counter() - t_start
    heads = [s.get(timeout=600) for s in streams]
    outs = [[tok] + s.collect(timeout=600) for (tok, _d), s in zip(heads, streams)]
    assert not ready_at_start and submitted_while_warming, \
        (ready_at_start, submitted_while_warming)
    assert all(not done for _t, done in heads), "a first token came marked done"
    assert all(first[s.uid] == (False, True) for s in streams), first
    differ = [i for i, (p, o) in enumerate(zip(prompts, outs)) if o != want[tuple(p)]]
    assert not differ, f"[gateway] streams differ from EngineLoop.run for {differ}"
    # round 2, after warmup: TTFT and TPOT through the service
    with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
        streams2 = list(pool.map(client, range(len(prompts))))
    outs2 = [s.collect(timeout=600) for s in streams2]
    uids2 = {s.uid for s in streams2}
    with svc._mu:        # the step that emitted a last token has recorded it
        recs = [r for r in eng.stats.requests if r.uid in uids2]
    assert len(recs) == len(prompts), recs
    ttft = [r.ttft_s for r in recs]
    tpot = [r.tpot_s for r in recs]
    stats = svc.stats_snapshot()
    assert stats["recompiles_after_warmup"] == 0, stats
    assert stats["warmed"] and stats["compile_events"] > 0, stats
    http = {"ran": False}
    if gw is not None:
        http = {"ran": True, **http_round_trip(gw.url, prompts[1], "A")}
        gw.close()
    else:
        svc.close()
    counts = K.launch_counts()
    for name in LOOP_KERNELS:
        assert counts[name] > 0, f"[gateway] {name} never launched: {counts}"
    assert eng.dispatch.fallbacks == [], eng.dispatch.fallbacks
    for name in list(eng.lora_q._names):
        eng.lora_q.unload(name)
        eng.lora_v.unload(name)
    out = {"warmup_s": warmup_s, "ready_before_warmup_end": ready_at_start,
           "submits_during_warmup": submitted_while_warming,
           "tokens_equal_engine_loop_run": True,
           "round2_tokens_equal_round1": sum(a == b for a, b in zip(outs, outs2)),
           "ttft_p50_ms": E.percentile(ttft, 50) * 1e3,
           "ttft_p95_ms": E.percentile(ttft, 95) * 1e3,
           "tpot_p50_ms": E.percentile(tpot, 50) * 1e3,
           "recompiles_after_warmup": stats["recompiles_after_warmup"],
           "compile_events": stats["compile_events"], "http": http, "launches": counts,
           "phase_s": time.perf_counter() - t0}
    log(f"[gateway] EngineService over a graph loop: not ready at start, ready after "
        f"{warmup_s:.2f} s of warmup on the engine thread ({stats['compile_events']} "
        f"graphs); 6 concurrent submits (adapters {adapters}) landed during warmup and "
        f"stream EngineLoop.run's tokens; each first token came while the engine had work "
        f"({card})")
    log(f"[gateway] through the service after warmup, 6 concurrent requests of "
        f"{GATEWAY_NEW} tokens: TTFT p50 {out['ttft_p50_ms']:.1f} ms p95 "
        f"{out['ttft_p95_ms']:.1f} ms, TPOT p50 {out['tpot_p50_ms']:.2f} ms; "
        f"{stats['recompiles_after_warmup']} captures after warmup ({card})")
    log(f"[gateway] HTTP round trip (SSE /v1/completions, /healthz, /v1/stats): "
        + ("ran" if http["ran"] else "not run: aiohttp is not installed here"))
    return out


# ---------------------------------------------------------------------------
# phase 4b: the Flash tier at full width
# ---------------------------------------------------------------------------

# the DRAM pool of the [spill] runs: the plan's floor of one full row
# (max_seq 2048 / page 128), half of the four rows' peak KV
SPILL_POOL_PAGES = 16
SPILL_NEW = 64
SPILL_PATIENCE = 16


def spill_trace(vocab: int, seed: int = 3):
    """Five prompts of 830-900 tokens, all opening with one 256-token
    prefix: four rows end at 8 pages of 128 each, 32 in all."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(1, vocab, 256)]
    return [shared + [int(t) for t in rng.integers(1, vocab, int(n) - 256)]
            for n in rng.integers(830, 901, 5)]


def spill_step_kind(before: dict, after: dict) -> str:
    """What one ``step()`` did, from the counters around it."""
    if after["chunks"] > before["chunks"]:
        return "prefill"
    if any(after[k] > before[k] for k in ("cold", "spilled", "restored")):
        return "spill"
    if after["read"] > before["read"]:
        return "stage"
    if after["rates"] > before["rates"]:
        return "staged_hit"
    return "plain"


def drive_spill(loop, specs, per_step: bool = False):
    """All requests submitted at step 0 (greedy, ``SPILL_NEW`` tokens), then
    ``step()`` until idle.  With ``per_step`` each step is timed to the
    device's end, its host-device synchronizations counted under sync debug
    mode, its host time in ``_stage_wave`` summed, and its kind recorded.
    Returns (tokens, steps, waves a step)."""
    import collections
    import warnings
    import torch
    from repro_torch.serving import engine as E
    from repro_torch.serving import sampling as SM
    eng = loop.eng
    sp = SM.SamplingParams(temperature=0.0, max_new_tokens=SPILL_NEW)
    reqs = [E.Request(uid=i, prompt_tokens=p, max_new_tokens=SPILL_NEW, sampling=sp)
            for i, p in enumerate(specs)]
    waves, stage_s = [], [0.0]
    plan, stage = loop._plan_waves, loop._stage_wave

    def plan_waves(slots):
        out = plan(slots)
        waves.append(len(out))
        return out

    def stage_wave(needed):
        t0 = time.perf_counter()
        stage(needed)
        stage_s[0] += time.perf_counter() - t0
    loop._plan_waves, loop._stage_wave = plan_waves, stage_wave

    def counters():
        s = eng.stats
        return {"chunks": s.prefill_chunks, "cold": s.cold_spilled_pages,
                "spilled": s.spilled_pages, "restored": s.restored_pages,
                "read": loop.spill.flash.bytes_read, "rates": len(s.flash_hit_rates)}
    for r in reqs:
        loop.submit(r)
    steps = []
    torch.cuda.synchronize()
    while loop.has_work():
        if not per_step:
            loop.step()
            continue
        before, stage_s[0] = counters(), 0.0
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                loop.step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        where = collections.Counter()
        for w in caught:
            msg = str(w.message)
            if "synchroniz" in msg and "prototype" not in msg:
                f = Path(w.filename)
                where[f"{f.relative_to(ROOT) if f.is_relative_to(ROOT) else f.name}"
                      f":{w.lineno}"] += 1
        steps.append({"kind": spill_step_kind(before, counters()), "wall_ms": wall * 1e3,
                      "stage_host_ms": stage_s[0] * 1e3, "syncs": sum(where.values()),
                      "sync_sites": dict(where)})
    torch.cuda.synchronize()
    assert all(r.done and len(r.generated) == SPILL_NEW for r in reqs), "unfinished requests"
    return [r.generated for r in reqs], steps, waves


def step_table(steps) -> dict:
    """Median wall, staging host time and syncs of each kind of step."""
    import statistics
    out = {}
    for kind in ("plain", "staged_hit", "stage", "spill", "prefill"):
        sel = [s for s in steps if s["kind"] == kind]
        if sel:
            out[kind] = {"steps": len(sel),
                         "wall_ms": statistics.median(s["wall_ms"] for s in sel),
                         "stage_host_ms": statistics.median(s["stage_host_ms"] for s in sel),
                         "syncs": sorted({s["syncs"] for s in sel}),
                         "sync_sites": dict(sorted({k: v for s in sel
                                                    for k, v in s["sync_sites"].items()
                                                    }.items()))}
    return out


def phase_spill(eng) -> dict:
    """The Flash tier on full-width qwen2-7b: an ``EngineLoop`` whose DRAM
    pool holds ``SPILL_POOL_PAGES`` pages (4 slots, max_seq 2048, page 128,
    the default staging reserve of 14 pages) serves the spill trace three
    times, eagerly: (1) prefix sharing on, (2) off, so every row's old pages
    may spill and decodes need several staging waves, (3) off with a fifth
    request queued and ``preempt_patience``, so rows are preempted to Flash
    and restored.  Every request's greedy tokens must equal those of an
    all-DRAM loop on its graphs; run 2 again on a warmed loop's graphs must
    equal the eager run and capture nothing after warmup."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.runtime import plan as RP
    from repro_torch.serving import engine as E
    specs = spill_trace(eng.cfg.vocab_size)
    pb = RP.kv_page_bytes(eng.cfg, RP.kv_page_size(eng.max_seq))

    def spill_loop(cuda_graphs=False, **kw):
        return E.EngineLoop(eng, max_slots=4, prefill_chunk=128, prefill_token_budget=256,
                            dram_budget_bytes=SPILL_POOL_PAGES * pb,
                            cuda_graphs=cuda_graphs, **kw)

    ref = E.EngineLoop(eng, max_slots=4, prefill_chunk=128, prefill_token_budget=256)
    ref.warmup()
    eng.stats = E.EngineStats()
    want, ref_steps, _ = drive_spill(ref, specs, per_step=True)
    ref_pool = ref.geom.num_pages
    ref.close()
    geom = eng.plan.kv_pool_geometry(eng.cfg, eng.max_seq, 4,
                                     dram_budget_bytes=SPILL_POOL_PAGES * pb)
    log(f"[spill] qwen2-7b: prompts {[len(p) for p in specs]}, {SPILL_NEW} new tokens; "
        f"all-DRAM reference on graphs ({ref_pool} pages); the spill loops hold "
        f"{geom.num_pages} pages of {pb / 2**20:.2f} MiB ({geom.num_pages * pb / 2**20:.1f} "
        f"MiB) and a staging reserve of {geom.staging_pages}")
    runs = {}
    K.reset_launch_counts()
    for name, kw, n in (("sharing", {}, 4),
                        ("no_sharing", {"prefix_sharing": False}, 4),
                        ("patience", {"prefix_sharing": False,
                                      "preempt_patience": SPILL_PATIENCE}, 5)):
        loop = spill_loop(**kw)
        eng.stats = E.EngineStats()
        t0 = time.perf_counter()
        got, _, waves = drive_spill(loop, specs[:n])
        wall = time.perf_counter() - t0
        s = eng.stats
        differ = [i for i in range(n) if got[i] != want[i]]
        assert not differ, f"[spill] {name}: greedy tokens differ from all-DRAM for {differ}"
        r = {"requests": n, "wall_s": wall, "num_pages": loop.geom.num_pages,
             "staging_pages": loop.geom.staging_pages, "peak_kv_pages": loop.peak_kv_pages,
             "cold_spilled_pages": s.cold_spilled_pages, "spilled_pages": s.spilled_pages,
             "restored_pages": s.restored_pages, "preemptions": s.preemptions,
             "max_waves": max(waves), "steps_with_2plus_waves": sum(w >= 2 for w in waves),
             "decode_steps": len(waves), "flash_bytes_written": loop.spill.flash.bytes_written,
             "flash_bytes_read": loop.spill.flash.bytes_read,
             "staging_hit_rate": s.flash_hit_rate, "staging_steps": len(s.flash_hit_rates),
             "tokens_equal_all_dram": True}
        assert loop.pool.staged_count == 0, loop.pool.staged_count
        assert loop.pool.staging_free == loop.geom.staging_pages, loop.pool.staging_free
        assert loop.spill.pages_on_flash == 0, loop.spill.pages_on_flash
        assert 0.0 <= r["staging_hit_rate"] <= 1.0
        log(f"[spill] {name}: {n} requests in {wall:.2f} s, tokens equal to all-DRAM; "
            f"peak KV {r['peak_kv_pages']} pages on a {r['num_pages']}-page pool; cold pages "
            f"spilled {r['cold_spilled_pages']}; preemptions {r['preemptions']} (pages "
            f"spilled {r['spilled_pages']}, restored {r['restored_pages']}); waves max "
            f"{r['max_waves']} ({r['steps_with_2plus_waves']} of {r['decode_steps']} decode "
            f"steps 2+); Flash written {r['flash_bytes_written'] / 2**20:.1f} MiB, read "
            f"{r['flash_bytes_read'] / 2**20:.1f} MiB; staging hit rate "
            f"{r['staging_hit_rate']:.3f} over {r['staging_steps']} steps; reserve returned, "
            "nothing left on Flash")
        runs[name] = r
        if name == "no_sharing":
            eager_tokens = got
        loop.close()
    eager_counts = K.launch_counts()
    assert runs["sharing"]["cold_spilled_pages"] > 0, runs["sharing"]
    assert runs["no_sharing"]["max_waves"] >= 2, runs["no_sharing"]
    assert runs["no_sharing"]["peak_kv_pages"] > runs["no_sharing"]["num_pages"]
    assert runs["patience"]["preemptions"] >= 1 and runs["patience"]["restored_pages"] > 0
    for name in LOOP_KERNELS:
        assert eager_counts[name] > 0, f"{name} never launched on the spill path: {eager_counts}"
    assert eng.dispatch.fallbacks == [], eng.dispatch.fallbacks

    loop = spill_loop(cuda_graphs=True, prefix_sharing=False)
    rep = loop.warmup()
    eng.stats = E.EngineStats()
    K.reset_launch_counts()
    got, steps, waves = drive_spill(loop, specs[:4], per_step=True)
    graph_counts = K.launch_counts()
    s = eng.stats
    assert got == eager_tokens, "[spill] graphs: greedy tokens differ from the eager run"
    assert s.recompiles_after_warmup == 0, f"{s.recompiles_after_warmup} captures after warmup"
    assert max(waves) >= 2, waves
    for name in LOOP_KERNELS:
        assert graph_counts[name] > 0, f"{name} never launched inside the graphs: {graph_counts}"
    assert eng.dispatch.fallbacks == [], eng.dispatch.fallbacks
    table, ref_table = step_table(steps), step_table(ref_steps)
    plain = [st["syncs"] for st in ref_steps + steps if st["kind"] == "plain"]
    assert plain and set(plain) == {1}, f"no-spill decode steps made {sorted(set(plain))} syncs"
    loop.close()
    for label, t in (("all-DRAM loop", ref_table), ("spill loop, no sharing", table)):
        for kind, k in t.items():
            log(f"[spill] graphs, {label}: {kind} steps {k['steps']}: wall {k['wall_ms']:.2f} ms"
                f" (median), host in _stage_wave {k['stage_host_ms']:.2f} ms, syncs "
                f"{k['syncs']} at {k['sync_sites']}")
    log(f"[spill] graphs: {rep['graphs']} graphs at warmup, tokens equal to the eager run, "
        f"0 captures after warmup; waves max {max(waves)}; launches {graph_counts}")
    return {"runs": runs, "launches": eager_counts, "graph_launches": graph_counts,
            "graph_steps": table, "all_dram_graph_steps": ref_table,
            "graph_warmup": rep, "pool_page_bytes": pb}


# ---------------------------------------------------------------------------
# phase 5: MoE serving at full width
# ---------------------------------------------------------------------------

def moe_trace(vocab: int, seed: int = 2):
    import numpy as np
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(1, vocab, 256)]
    lens = [300, 64, 400, 131, 97, 340]
    specs = []
    for i, n in enumerate(lens):
        if i in (0, 5):                # the second arrives after the first is in
            specs.append(shared + [int(t) for t in rng.integers(1, vocab, n - 256)])
        else:
            specs.append([int(t) for t in rng.integers(1, vocab, n)])
    return specs, [0, 0, 1, 2, 4, 6]


class MoeSpies:
    """While entered: the grouped kernel's launches by MoE branch and by the
    table each call was given, and the calls of ``take_experts`` (the slab
    copy the kernel's id table replaces).  ``check`` asserts that both
    branches launched it, chunks with live-row counts and decode steps by
    expert id, and that no slab was copied."""

    def __init__(self):
        self.by_branch = {"full_dispatch": 0, "selected_expert": 0}
        self.tables = {b: {"rows": 0, "ids": 0, "neither": 0} for b in self.by_branch}
        self.take_calls = 0
        self._branch = None

    def __enter__(self):
        from repro_torch.kernels import grouped_matmul as GM
        from repro_torch.models import moe as M
        from repro_torch.runtime import dispatch as D
        from repro_torch.runtime import plan as RP
        self._originals = originals = (M._dispatch_moe, M._dispatch_moe_tiny,
                                       D.Dispatcher.grouped_matmul, RP.take_experts)

        def counted(fn, name):
            def inner(*a, **kw):
                before = GM.grouped_matmul.launches
                self._branch = name
                try:
                    return fn(*a, **kw)
                finally:
                    self.by_branch[name] += GM.grouped_matmul.launches - before
                    self._branch = None
            return inner

        def grouped_spy(disp, *a, rows=None, ids=None, **kw):
            before = GM.grouped_matmul.launches
            out = originals[2](disp, *a, rows=rows, ids=ids, **kw)
            key = "rows" if rows is not None else "ids" if ids is not None else "neither"
            self.tables[self._branch][key] += GM.grouped_matmul.launches - before
            return out

        def take_spy(*a, **kw):
            self.take_calls += 1
            return originals[3](*a, **kw)

        M._dispatch_moe = counted(originals[0], "full_dispatch")
        M._dispatch_moe_tiny = counted(originals[1], "selected_expert")
        D.Dispatcher.grouped_matmul = grouped_spy
        RP.take_experts = take_spy
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.models import moe as M
        from repro_torch.runtime import dispatch as D
        from repro_torch.runtime import plan as RP
        (M._dispatch_moe, M._dispatch_moe_tiny, D.Dispatcher.grouped_matmul,
         RP.take_experts) = self._originals

    def __str__(self) -> str:
        return (f"grouped_matmul by branch {self.by_branch}, by table {self.tables}; "
                f"take_experts calls {self.take_calls}")

    def check(self) -> None:
        assert all(n > 0 for n in self.by_branch.values()), self.by_branch
        # chunks skip dead capacity rows, decode reads slabs by id: no slab copy
        assert self.tables["full_dispatch"]["rows"] == self.by_branch["full_dispatch"], \
            self.tables
        assert self.tables["selected_expert"]["ids"] == self.by_branch["selected_expert"], \
            self.tables
        assert self.take_calls == 0, f"take_experts ran {self.take_calls} times on the card"


def phase_moe(dev) -> dict:
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import registry
    from repro_torch.serving import engine as E

    cfg = registry.get("moonshot-v1-16b-a3b")
    assert cfg.num_heads == cfg.num_kv_heads          # G = 1 in the paged kernels
    t0 = time.perf_counter()
    eng = E.build_engine(cfg, seed=0, max_seq=1024, device=dev,
                         flash_dir=str(ROOT / "build" / "flash-moe"))
    torch.cuda.synchronize()
    log(f"[moe] moonshot-v1-16b-a3b: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, {cfg.num_experts} experts top-"
        f"{cfg.experts_per_tok} of d_ff {cfg.d_ff}, vocab {cfg.padded_vocab_size}; built "
        f"in {time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    specs, arrivals = moe_trace(cfg.vocab_size)
    log(f"[moe] trace: prompts {[len(p) for p in specs]}, arrivals {arrivals}; eager")
    spy = MoeSpies()
    with spy:
        K.reset_launch_counts()
        loop, reqs, wall = serve_trace(eng, specs, arrivals, max_new=16)
        counts = K.launch_counts()
    s = eng.stats
    log(f"[moe] launches during the trace: {counts}; {spy}")
    assert all(r.done and len(r.generated) == 16 for r in reqs), "unfinished requests"
    assert loop.pool.prefix_hits > 0, "the shared prefix was never adopted"
    assert loop.disabled_features.get("decode_bucketing"), loop.disabled_features
    for name in MOE_KERNELS:
        assert counts[name] > 0, f"{name} never launched on the MoE path: {counts}"
    spy.check()
    assert eng.dispatch.fallbacks == [], eng.dispatch.fallbacks
    new_tokens = sum(len(r.generated) for r in reqs)
    summary = {
        "wall_s": wall, "new_tokens": new_tokens, "prefill_tokens": s.prefill_tokens,
        "prefill_chunks": s.prefill_chunks, "prefix_hits_pages": loop.pool.prefix_hits,
        "shared_prompt_tokens": s.shared_prompt_tokens,
        "ttft_p50_ms": s.ttft(50) * 1e3, "ttft_p95_ms": s.ttft(95) * 1e3,
        "tpot_p50_ms": s.tpot(50) * 1e3, "tpot_p95_ms": s.tpot(95) * 1e3,
        "decode_tok_per_s": s.decode_tps, "prefill_tok_per_s": s.prefill_tps,
        "launches": counts, "grouped_matmul_by_branch": spy.by_branch,
        "grouped_matmul_by_table": spy.tables, "take_experts_calls": spy.take_calls,
        "disabled_features": loop.disabled_features,
        "device_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
    }
    log(f"[moe] {len(reqs)} requests, {new_tokens} new tokens in {wall:.2f} s; TTFT p50 "
        f"{summary['ttft_p50_ms']:.1f} ms p95 {summary['ttft_p95_ms']:.1f} ms; TPOT p50 "
        f"{summary['tpot_p50_ms']:.2f} ms; decode {s.decode_tps:.1f} tok/s; prefill "
        f"{s.prefill_tps:.1f} tok/s in {s.prefill_chunks} chunks; prefix pages adopted "
        f"{loop.pool.prefix_hits}")
    # the same trace on the graphs: the warmup's eager runs and captures are
    # the only Python calls of the graphs' steps, so the spies see each
    # graph's grouped launches there: chunks with live-row counts, decode
    # by expert id; every graph of each kind then holds grouped launches
    graph_spy = MoeSpies()
    summary["graphs"] = phase_graphs("moonshot-v1-16b-a3b", eng, specs, arrivals, reqs, 16,
                                     MOE_KERNELS, spies=graph_spy)
    log(f"[graphs] moonshot-v1-16b-a3b: at warmup {graph_spy}")
    graph_spy.check()
    per_graph = summary["graphs"]["graph_launches"]
    assert all(v.get("grouped_matmul", 0) > 0 for v in per_graph.values()), per_graph
    summary["graphs"]["grouped_matmul_by_branch_at_warmup"] = graph_spy.by_branch
    summary["graphs"]["grouped_matmul_by_table_at_warmup"] = graph_spy.tables
    summary["profile"] = profile_loop_decode(eng, specs)
    summary["profile_graphs"] = profile_loop_decode(eng, specs, cuda_graphs=True)
    prompt = specs[3]
    summary["kernel_vs_plain"] = compare_paths("MoE EngineLoop", eng, chunk_then_decode,
                                               prompt, prompt[128])
    return eng, summary


# ---------------------------------------------------------------------------
# phase 6: weight and expert streaming from Flash through a ring of slots
# ---------------------------------------------------------------------------

WSTREAM_DENSE_RING = 7        # qwen2-7b: 7 slots for 28 groups
WSTREAM_MOE_RING = 16         # moonshot: 16 slots for 48 groups (head + stack / 3)
WSTREAM_MEMORY_SLACK = 0.05   # device weight bytes after the export vs the policy's


def wstream_trace(vocab: int, lens, seed: int):
    """Prompts of ``lens`` tokens; the first and third open with one
    256-token prefix where they are that long."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(1, vocab, 256)]
    return [shared + [int(t) for t in rng.integers(1, vocab, n - 256)]
            if i in (0, 2) and n > 256 else [int(t) for t in rng.integers(1, vocab, n)]
            for i, n in enumerate(lens)]


def drive_wstream(loop, specs, max_new: int) -> dict:
    """Every request at step 0 (greedy), then ``step()`` until idle, each
    step timed to the device's end and classed (a step that ran a prompt
    chunk, or a decode step), with the ring installs and Flash bytes it
    took; the host-device synchronizations of one decode step with all rows
    decoding are counted (that step is not timed)."""
    import torch
    from repro_torch.serving import engine as E
    from repro_torch.serving import sampling as SM
    eng = loop.eng
    rings = [*loop._wstreams.values(), *loop._expert_rings.values()]
    store = eng.weight_store
    sp = SM.SamplingParams(temperature=0.0, max_new_tokens=max_new)
    reqs = [E.Request(uid=i, prompt_tokens=p, max_new_tokens=max_new, sampling=sp)
            for i, p in enumerate(specs)]

    def counters():
        return (eng.stats.prefill_chunks, sum(r.installs for r in rings),
                sum(getattr(r, "expert_installs", 0) for r in rings),
                store.flash.bytes_read if store is not None else 0)
    for r in reqs:
        loop.submit(r)
    steps, syncs = [], None
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    while loop.has_work():
        decoding = sum(r is not None for r in loop.scheduler.running)
        if syncs is None and not loop._prefilling and decoding == len(reqs) \
                and min(len(r.generated) for r in reqs) >= 1:
            syncs = count_syncs(loop.step)
            continue
        before = counters()
        t0 = time.perf_counter()
        loop.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = counters()
        steps.append({"kind": "chunk" if after[0] > before[0] else "decode",
                      "wall_ms": wall * 1e3, "group_installs": after[1] - before[1],
                      "expert_installs": after[2] - before[2],
                      "flash_read_mb": (after[3] - before[3]) / 1e6})
    wall = time.perf_counter() - t_run
    assert all(r.done and len(r.generated) == max_new for r in reqs), "unfinished requests"
    return {"tokens": [r.generated for r in reqs], "steps": steps, "wall_s": wall,
            "syncs": syncs}


def wstream_steps(steps) -> dict:
    """Median wall time, installs and Flash megabytes of each kind of step."""
    import statistics
    out = {}
    for kind in ("decode", "chunk"):
        sel = [s for s in steps if s["kind"] == kind]
        if sel:
            out[kind] = {"steps": len(sel), **{
                k: statistics.median(s[k] for s in sel)
                for k in ("wall_ms", "group_installs", "expert_installs", "flash_read_mb")}}
    return out


def install_rate(ring, store, stack: int) -> dict:
    """Host-to-device rate of one install: a fetched (pinned) group blob
    copied into a ring slot 20 times, timed with CUDA events."""
    import torch
    blob = store.fetch_group(stack, 1)
    dst = ring.shared_buf[1] if hasattr(ring, "shared_buf") else ring.buffers[1]
    n = 20
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    dst.copy_(blob.buffer, non_blocking=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        dst.copy_(blob.buffer, non_blocking=True)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / n
    ring.slot_group[1] = -1            # the slot no longer holds its group
    if hasattr(ring, "exp_group"):
        ring.exp_group[1] = [-1] * ring.experts
    return {"bytes": int(blob.buffer.numel()), "ms": ms,
            "gb_per_s": blob.buffer.numel() / ms / 1e6, "pinned": blob.buffer.is_pinned()}


def phase_wstream(holder: list, label: str, ring_slots: int, lens, max_new: int,
                  seed: int, spies=None) -> dict:
    """One part of ``[wstream]``: ``holder`` hands over the resident engine
    (its caller keeps no other reference).  An all-resident eager loop
    serves the trace; then a streamed engine is built from the same
    parameters under a budget of the head plus ``ring_slots`` groups, the
    resident engine is released, and the streamed loop (asked for CUDA
    graphs, which the streaming gate turns off) serves the trace again: its
    greedy tokens must equal the resident run's, the stack's device memory
    must be freed, every kernel of the path must launch and nothing fall
    back.  The Flash blobs are deleted at the end.  Every rate here reads
    blobs the host has just written: page-cache reads."""
    import shutil
    import torch
    from repro_torch import kernels as K
    from repro_torch.runtime import plan as RP
    from repro_torch.serving import engine as E
    eng = holder.pop()
    cfg = eng.cfg
    moe = bool(cfg.num_experts)
    kernels = MOE_KERNELS if moe else LOOP_KERNELS
    specs = wstream_trace(cfg.vocab_size, lens, seed)
    eng.stats = E.EngineStats()
    loop, reqs, res_wall = serve_trace(eng, specs, [0] * len(specs), max_new=max_new)
    want = [r.generated for r in reqs]
    res = {"wall_s": res_wall, "decode_tok_per_s": eng.stats.decode_tps,
           "prefill_tok_per_s": eng.stats.prefill_tps}
    loop.close()
    del loop, reqs
    gc.collect()

    full = RP.weight_stream_policy(cfg, eng.params)
    count = cfg.layer_plan()[0][1]
    group_bytes = -(-(full.resident_bytes - full.head_bytes) // count)
    budget = full.head_bytes + ring_slots * group_bytes
    root = eng.embedding.flash.root
    free = shutil.disk_usage(root).free
    log(f"[wstream] {label}: {count} groups of {group_bytes / 1e6:.2f} MB (stack "
        f"{(full.resident_bytes - full.head_bytes) / 1e9:.2f} GB, head "
        f"{full.head_bytes / 1e6:.1f} MB); budget head + {ring_slots} groups; Flash "
        f"directory has {free / 1e9:.1f} GB free; all-resident eager run "
        f"{res_wall:.2f} s")
    assert free > 1.1 * (full.resident_bytes - full.head_bytes), "no room on Flash"
    params, emb = eng.params, eng.embedding
    torch.cuda.synchronize()
    mem_resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    streamed = E.Engine(cfg, params, emb, max_seq=eng.max_seq, device=eng.device,
                        weight_dram_budget_bytes=budget)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    del eng, params
    gc.collect()
    pol = streamed.weight_policy
    (spl,) = pol.streamed
    assert spl.ring_groups == ring_slots and bool(spl.experts) == moe, pol
    freed = mem_resident - torch.cuda.memory_allocated()
    weights_after = full.resident_bytes - freed
    loop = make_loop(streamed, cuda_graphs=True)
    ring = (loop._expert_rings or loop._wstreams)[spl.stack]
    if moe:
        ring_alloc = sum(b.numel() for b in ring.shared_buf) + sum(
            t.numel() * t.element_size() for ts in ring.tables for t in ts)
    else:
        ring_alloc = sum(b.numel() for b in ring.buffers)
    on_card = weights_after + ring_alloc
    log(f"[wstream] {label}: exported in {export_s:.1f} s, Flash written "
        f"{streamed.weight_store.flash.bytes_written / 1e9:.2f} GB; device weight bytes "
        f"{on_card / 1e9:.3f} GB (resident {weights_after / 1e9:.3f} + ring "
        f"{ring_alloc / 1e9:.3f}) against the policy's {pol.resident_bytes / 1e9:.3f} GB; "
        f"disabled {loop.disabled_features}")
    assert on_card <= (1 + WSTREAM_MEMORY_SLACK) * pol.resident_bytes, \
        f"the streamed stack's memory was not freed: {on_card} > {pol.resident_bytes}"
    assert not loop.cuda_graphs and "cuda_graphs" in loop.disabled_features
    assert loop.disabled_features.get("decode_bucketing", "").startswith("weight streaming")
    rep = None
    if not moe:
        rep = loop.warmup()
        assert rep["graphs"] == 0, rep
        log(f"[wstream] {label}: warmup {rep['warmup_s']:.1f} s, {rep['graphs']} graphs "
            f"(chunks {rep['chunk_sizes']})")
    streamed.stats = E.EngineStats()
    h0, m0 = streamed.weight_store.prefetch_hits, streamed.weight_store.prefetch_misses
    read0 = streamed.weight_store.flash.bytes_read
    stall0 = sum(r.stall_s for r in (*loop._wstreams.values(), *loop._expert_rings.values()))
    K.reset_launch_counts()
    if spies is not None:
        with spies:
            run = drive_wstream(loop, specs, max_new)
    else:
        run = drive_wstream(loop, specs, max_new)
    counts = K.launch_counts()
    s = streamed.stats
    differ = [i for i in range(len(specs)) if run["tokens"][i] != want[i]]
    assert not differ, f"[wstream] {label}: greedy tokens differ from all-resident for {differ}"
    for name in kernels:
        assert counts[name] > 0, f"{name} never launched on the streamed path: {counts}"
    if spies is not None:
        spies.check()
    assert streamed.dispatch.fallbacks == [], streamed.dispatch.fallbacks
    hits = streamed.weight_store.prefetch_hits - h0
    misses = streamed.weight_store.prefetch_misses - m0
    table = wstream_steps(run["steps"])
    rate = install_rate(ring, streamed.weight_store, spl.stack)
    out = {"resident": res, "groups": count, "group_bytes": group_bytes,
           "ring_groups": spl.ring_groups, "budget": budget,
           "policy_resident_bytes": pol.resident_bytes, "device_weight_bytes": on_card,
           "export_s": export_s, "flash_bytes_written": streamed.weight_store.flash.bytes_written,
           "flash_bytes_read": streamed.weight_store.flash.bytes_read - read0,
           "wall_s": run["wall_s"], "steps": table, "syncs": run["syncs"],
           "weight_group_hits": hits, "weight_group_misses": misses,
           "weight_stall_s": s.weight_stall_s - stall0, "install": rate,
           "warmup": rep, "launches": counts, "disabled_features": loop.disabled_features,
           "decode_tok_per_s": s.decode_tps, "prefill_tok_per_s": s.prefill_tps,
           "tokens_equal_resident": True, "flash": "page-cache reads"}
    log(f"[wstream] {label}: {len(specs)} requests (prompts {[len(p) for p in specs]}, "
        f"{max_new} new) in {run['wall_s']:.2f} s, greedy tokens equal to all-resident; "
        f"Flash read {out['flash_bytes_read'] / 1e9:.2f} GB (page-cache reads); prefetch "
        f"hits {hits}, misses {misses} (hit rate {hits / max(1, hits + misses):.3f}); "
        f"waited for Flash {out['weight_stall_s']:.2f} s; "
        f"launches {counts}")
    for kind, k in table.items():
        log(f"[wstream] {label}: {kind} steps {k['steps']}: wall {k['wall_ms']:.1f} ms "
            f"(median), group installs {k['group_installs']:.0f}, expert installs "
            f"{k['expert_installs']:.0f}, Flash read {k['flash_read_mb']:.0f} MB a step")
    log(f"[wstream] {label}: one install of {rate['bytes'] / 1e6:.2f} MB from pinned "
        f"host memory ({rate['pinned']}): {rate['ms']:.3f} ms, {rate['gb_per_s']:.1f} GB/s; "
        f"a decode step with every row decoding made {run['syncs']['syncs_per_step']} "
        f"host-device synchronizations at {run['syncs']['sync_sites']}")
    if moe:
        out.update({k: getattr(s, k) for k in (
            "expert_prefetch_hits", "expert_prefetch_misses", "expert_bytes_fetched",
            "expert_bytes_baseline")})
        out["expert_bytes_saved_frac"] = s.expert_bytes_saved_frac
        out["expert_reruns"] = loop.expert_reruns
        out["grouped_matmul_by_branch"] = spies.by_branch
        assert s.expert_prefetch_hits > 0, out
        assert s.expert_bytes_fetched < s.expert_bytes_baseline, out
        log(f"[wstream] {label}: experts: hits {s.expert_prefetch_hits}, misses "
            f"{s.expert_prefetch_misses} (hit rate {s.expert_prefetch_hit_rate:.3f}), "
            f"groups run again {loop.expert_reruns}; fetched "
            f"{s.expert_bytes_fetched / 1e9:.2f} GB against whole groups' "
            f"{s.expert_bytes_baseline / 1e9:.2f} GB (saved {s.expert_bytes_saved_frac:.3f}); "
            f"{spies}")
    else:
        assert run["syncs"]["syncs_per_step"] == 1, run["syncs"]
    loop.close()
    streamed.close()
    assert not [f for f in Path(root).iterdir() if f.name.startswith("wgrp")], \
        "weight blobs left on Flash"
    return out


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py runs from the root of a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import loader

    t_start = time.perf_counter()
    OUT.mkdir(exist_ok=True)
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    lib = loader.build(force=True)
    (OUT / "ptxas.log").write_text(lib.ptxas_log)
    log(f"[build] kernels built in {lib.build_s:.1f} s -> {lib.path.relative_to(ROOT)}")
    for line in lib.ptxas_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")

    results: dict = {}
    phase_kernels(dev, results)
    phase_new_kernels(dev, results)
    eng, specs, arrivals, reqs, summary = phase_main_path(dev)
    summary["graphs"] = phase_graphs("qwen2-7b", eng, specs, arrivals, reqs, 32,
                                     LOOP_KERNELS)
    summary["profile"] = profile_loop_decode(eng, specs)
    summary["profile_graphs"] = profile_loop_decode(eng, specs, cuda_graphs=True)
    checks = phase_kernel_vs_plain(eng, specs, arrivals, reqs)
    generate = phase_generate(eng)
    lora = phase_lora(eng, card)
    log(f"[lora] phase took {lora['phase_s']:.1f} s")
    gateway = phase_gateway(eng, card)
    log(f"[gateway] phase took {gateway['phase_s']:.1f} s")
    t_spill = time.perf_counter()
    spill = phase_spill(eng)
    spill["phase_s"] = time.perf_counter() - t_spill
    log(f"[spill] phase took {spill['phase_s']:.1f} s")
    t_ws = time.perf_counter()
    holder = [eng]
    del eng
    wstream = {"qwen2-7b": phase_wstream(holder, "qwen2-7b", WSTREAM_DENSE_RING,
                                         [400, 64, 300, 170], 16, seed=5)}
    log(f"[wstream] qwen2-7b part took {time.perf_counter() - t_ws:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()            # the MoE engine needs the room
    torch.cuda.reset_peak_memory_stats(dev)
    eng_moe, moe = phase_moe(dev)
    t_ws = time.perf_counter()
    holder = [eng_moe]
    del eng_moe
    wstream["moonshot-v1-16b-a3b"] = phase_wstream(
        holder, "moonshot-v1-16b-a3b", WSTREAM_MOE_RING, [128, 48, 96, 77], 8, seed=6,
        spies=MoeSpies())
    log(f"[wstream] moonshot-v1-16b-a3b part took {time.perf_counter() - t_ws:.1f} s")

    # launches: the sum over the three serving paths, each counted from zero
    paths = {"EngineLoop qwen2-7b": summary["launches"],
             "EngineLoop qwen2-7b, CUDA graphs": summary["graphs"]["launches"],
             "Engine.generate qwen2-7b": generate["launches"],
             "EngineLoop qwen2-7b, LoRA": lora["launches"],
             "EngineLoop qwen2-7b, LoRA, CUDA graphs": lora["graph_launches"],
             "Engine.generate qwen2-7b, LoRA": lora["generate_launches"],
             "EngineService qwen2-7b, LoRA, CUDA graphs": gateway["launches"],
             "EngineLoop qwen2-7b, Flash tier": spill["launches"],
             "EngineLoop qwen2-7b, Flash tier, CUDA graphs": spill["graph_launches"],
             "EngineLoop qwen2-7b, weights streamed": wstream["qwen2-7b"]["launches"],
             "EngineLoop moonshot-v1-16b-a3b": moe["launches"],
             "EngineLoop moonshot-v1-16b-a3b, CUDA graphs": moe["graphs"]["launches"],
             "EngineLoop moonshot-v1-16b-a3b, experts streamed":
                 wstream["moonshot-v1-16b-a3b"]["launches"]}
    kernels = []
    for name in KERNELS:
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name],
                        "launches": sum(c[name] for c in paths.values()),
                        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                        "library_ms": r["library_ms"], "graph_ms": r["graph_ms"],
                        "library_graph_ms": r["library_graph_ms"], "shape": r["shape"]})
    detail = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "build_s": lib.build_s, "kernels": kernels, "launches_by_path": paths,
              "w4a8_all_shapes": results["w4a8_matmul"]["all_shapes"],
              "rmsnorm_all_shapes": results["rmsnorm"]["all_shapes"],
              "grouped_all_shapes": results["grouped_matmul"]["all_shapes"],
              "paged_decode_all_shapes": results["paged_quant_decode_attention"]["all_shapes"],
              "main_path": summary, "kernel_vs_plain": checks,
              "generate_path": generate, "lora_path": lora, "gateway_path": gateway,
              "spill_path": spill, "moe_path": moe,
              "wstream": wstream,
              "total_s": time.perf_counter() - t_start}
    (OUT / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    log(f"[done] {detail['total_s']:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
