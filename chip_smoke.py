#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero; nothing is caught and carried on):

1. The card (``nvidia-smi`` name and power limit), torch and CUDA versions;
   build of the Hopper kernels from ``src/repro_torch/csrc``.
2. Each of the seven kernels against its plain PyTorch version on the card,
   at the serving paths' shapes (qwen2-7b, G=7; moonshot-v1-16b-a3b, G=1;
   the decode kernels also at glm4-9b's G=16 and at G=24, two head tiles a
   KV head, each timed with its bound and SDPA; the decode kernels and the
   dense matmul with the split count their wrappers choose, the matmul at
   every dense linear of both models at M = 1, 4, 128 and 320)
   and at small ``@reduced`` shapes, with the tolerance of the matching CPU
   test; the dense prefill kernel also non-causal and windowed; the grouped
   kernel with expert ids (decode) and live-row counts (full-capacity
   prefill, routed and uneven).  Kernel, plain and library-yardstick times.
2b. The slice of the modules with no TPU kernel.  ``[ops]``: the public ops
   of ``kernels/ops.py`` at qwen2-7b's widths (a gate/up linear at M = 4
   and 128, RMSNorm over 4 rows, decode attention over 352 live of 2048
   slots, a 320-token prefill) against ``kernels/ref.py``, kernels 1, 4, 6
   and 7 launched.  ``[geometry]``: a transpose -> slice -> transpose chain
   over one layer's keys at 512 tokens fuses to one Region (C6) and moves
   the composed ops' bytes exactly on the card.  ``[dryrun]``: the meta
   dry run of the 40 ``ASSIGNED x INPUT_SHAPES`` cases against the card's
   capacity, as a table; later, beside the builds of qwen2-7b and moonshot,
   its prediction of each engine's device memory (packed parameters and
   the KV pool) against the growth of ``memory_allocated`` across the build
   and the loop's construction, within 5%.  ``[roofline]``: after the
   profiled graph decode steps of qwen2-7b, moonshot, llama3-8b and
   qwen2-1.5b, the step's bound from shapes (``analysis/roofline.py``: the
   packed weights read, moonshot's routed experts only, the live KV, the
   activations) against the profile's device time and the step's wall
   time, beside the card's name and power limit.
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
   Then ``[kvflash]``, §4.1's per-layer KV spill on the same engine
   (``KVSpillManager``, the reference's Figure-2 Flash: 1 GB/s, 15 us a
   read): one row's whole prompt (1,536 and then 8,704 tokens) is
   prefilled through kernel 7 into a dense cache; the tokens past the
   last 512 of every layer go to Flash in blocks of 128 (int8 key codes,
   fp8 values: 1 KiB a token; the key scales and zeros stay on the card);
   then decode steps drive the 28 layers one by one, each joining its
   layer's history from Flash to its device part before kernel 6 runs,
   with and without the layer-ahead prefetch.  Hard checks: every spilled
   step's logits bit-equal to the unspilled step's, a prefetch hit rate of
   1.0 with the prefetch and every fetch a miss without it, 28 kernel-6
   launches a step, no fallback, the Flash files deleted; and two cheap
   ones: ``core/precision.py``'s ``attention_scores`` overflows fp16 under
   ``UNSAFE_FP16_POLICY`` and not under the pre-scaled policy, and a
   qwen2-7b gate weight through numpy -> ``load_prequantized`` ->
   ``pack_linear`` gives kernel 1's output bit for bit at M = 4.  Each
   step's wall, the Flash read time and bytes and the hidden share are
   printed, not asserted.
4c. ``[glm4]``, 16 query heads per KV head: full-width glm4-9b (40 layers,
   d_model 4096, 32/2 heads, d_ff 13696, vocab 151552; random weights from
   seed 0) serves 6 greedy requests of the qwen2-7b trace's kind (16 new
   tokens) through ``EngineLoop`` eagerly and on its CUDA graphs (tokens
   equal, no capture after warmup), a graph decode step profiled, one
   chunk and one decode step kernel vs plain layer by layer, and
   ``Engine.generate`` (4 x 320-token prompts, both dense kernels) as in
   phase 4.  The engine is released before the MoE engine is built.
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
7. ``[gemma3]``, ``[qwen110b]``, ``[grok1]``, each engine released (and its
   Flash embedding deleted) before the next is built.  ``[gemma3]`` first
   holds kernels 2, 6 and 7 at gemma3-27b's windowed shapes against their
   plain versions (ring views of 9 pages with negative and positive bases,
   a full 1024-slot dense ring, a 1152-token prompt under window 1024),
   each timed with its bound and SDPA, and times the windowed chunk
   attention, which has no TPU kernel and runs as plain PyTorch on the
   card.  Then full-width gemma3-27b (62 layers: 52 with a 1024-token
   window in rings of 9 pages, 10 global; gelu FFN; ~10 GiB) serves 6
   greedy requests, two of them past the window (1130 and 1480 tokens),
   16 new tokens, eagerly (kernel 2 over ring views and over the global
   pool, ring bases below and above 0, kernel 3 on the global layers
   only, prefix sharing and decode bucketing off) and on its graphs; a
   graph decode step profiled; a chunk and a decode step past the window
   kernel vs plain; ``Engine.generate`` at 4 x 1152 tokens (kernel 6 over
   wrapped rings).  ``[qwen110b]``: full-width qwen1.5-110b (80 layers,
   ~52 GiB) with ``w4a8_matmul`` timed at its layer 0's gate/up (N =
   49152) and down (K = 49152) weights, 4 requests eagerly and on graphs,
   a profiled graph decode step, a chunk and a decode step kernel vs
   plain.  ``[grok1]``: grok-1-314b at full width and 16 of its 64 layers
   (the whole int4 model, ~157 GB, does not fit one card), printed as
   ``reduced``, with ``grouped_matmul`` timed on its layer 0's expert
   tables, then as ``[qwen110b]`` with both MoE branches checked.
8. ``[rwkv6]`` and ``[jamba]``, recurrent stacks, each engine released
   before the next.  rwkv6-7b at full width and depth (32 attention-free
   layers, d_model 4096, 64 wkv heads, d_ff 14336) and jamba-1.5-large-398b
   at full width and 16 of its 72 layers (two periods of one attention
   layer and seven mamba layers, d_inner 16384, 16 experts top-2 on every
   other layer; ``reduced`` printed: the int4 model, ~199 GB, does not fit
   one card).  Each times its scan, which has no TPU kernel and runs as
   plain PyTorch on the card (mamba's ``selective_scan``, rwkv6's
   ``wkv_scan``), at a 128-token chunk and a 4-row decode step, beside its
   bound; serves 6 (jamba: 4) requests through ``EngineLoop`` eagerly and
   on its graphs (tokens equal, no capture after warmup, prefix sharing
   and bucketing off, 1 sync a graph decode step; rows 1 and 4 launched,
   jamba also rows 2, 3 and 5 on both MoE branches); holds a chunk and a
   decode step kernel vs plain; runs ``Engine.generate`` at 4 x 320
   (jamba: rows 6 and 7).  ``[jamba]`` then evicts a row mid-prefill and
   preempts a decoding one under a 4-page pool (their state to Flash and
   back): every request's tokens equal the unpressured run's.  The
   windowed chunk of ``[gemma3]`` is also timed against SDPA over the
   dequantized ring with a window mask.
9. ``[seamless]`` and ``[qwen2vl]``, each engine released before the next.
   seamless-m4t-large-v2 at full width and depth (24 encoder and 24
   decoder layers, d_model 1024, 16 heads of 64, gelu FFN of 8192, vocab
   256206): kernels 7 and 6 at its shapes first (the encoder non-causal
   over 256 frames; a 64-token prompt's cross attention folded into the
   head axis, G' = 64; cross attention at decode), each timed with its
   bound and SDPA; then 4 greedy requests of 64-token prompts over 256
   source frames each (N(0, 0.02) from the seed), 32 new tokens through
   ``Engine.generate``: kernel 7 non-causal 24 times a request, kernel 6
   folded 24 times a request, a profiled decode step, the encoder, the
   decoder prefill and a decode step kernel vs plain layer by layer.
   qwen2-vl-2b at full width and depth (28 layers, 12/2 heads of 128,
   M-RoPE sections (16, 24, 24)) serves 6 requests through ``EngineLoop``
   eagerly and on its graphs (text positions; tokens equal, no capture
   after warmup, 1 sync a graph decode step), runs ``Engine.generate`` at
   4 x 320, and holds a prefill and a decode step with three-axis
   positions (text, a 16 x 16-patch image block, text) kernel vs plain.

10. ``[train]``: qwen2-1.5b's float tree at full width and depth (28
   layers, d_model 1536, 12/2 heads of 128, d_ff 8960; ~1.78 B parameters,
   bf16, from seed 0) on batches of 4 x 512 tokens from the port's
   pipeline: kernels 4 and 7 at the training shapes against their plain
   versions; one step's loss and every gradient leaf on the kernel route
   against the plain route; 20 AdamW steps under remat with kernels 4 and
   7 launched in every step through their ``autograd.Function``s (forward
   and recompute), a held-out batch's loss falling and the gradient norm
   finite; a step's wall time, tokens/s, peak device memory and the two
   kernels' device time; one Adafactor step moving every parameter.

11. The paper's models and its quantization variants.  ``[kernels]`` first
   holds kernels 2, 3 and 6 at the shapes of rows 2, 3 and 6 once with
   int4 keys and fp8 values and once with int8 keys and bf16 values, each
   timed with its bound (the variant's bytes) and SDPA.  ``[paper]``:
   llama3-8b (32 layers, 32/8 heads, d_ff 14336, vocab 128256) and
   qwen2-1.5b (28 layers, 12/2 heads: G = 6, d_model 1536) at full width
   and depth under the default quantization, each serving a 6-request
   trace (16 new tokens) through ``EngineLoop`` eagerly and on its graphs
   (tokens equal, no capture after warmup, a graph decode step profiled,
   kernels 1-4 launched), a chunk and a decode step kernel vs plain, and
   ``Engine.generate`` at 4 x 320 (kernels 6 and 7), with no eager
   profile.  ``[quantvar]``: qwen2-1.5b at full width and depth under
   ``QuantConfig(kv_key_bits=4, kv_value_fp8=False, act_bits=16,
   group_size=128)``, the same checks with kernels 2, 3 and 4 launched,
   kernel 1 never, every linear on the dispatcher's float path (its count
   positive here and zero in every other path: each reset of the counts
   checks it) and every attention launch over int4 keys and bf16 values.
   ``[dbrx]``: dbrx-132b at full width and 16 of its 40 layers (~24 GiB
   of int4 experts; ``reduced`` printed), ``grouped_matmul`` timed at its
   layer 0's tables (16 experts, top-4), 4 requests eagerly and on graphs
   with both MoE branches through the grouped kernel, a chunk and a
   decode step kernel vs plain.

Every profile records CUDA activity only: the device's kernels and the
host's CUDA runtime calls, which Kineto's CUDA activity carries, without
the PyTorch operator events an eager step makes by the thousand.

Launch counts are zeroed just before each serving path (and the training
steps) and read just after it (a graph replay adds the launches its
capture recorded): every kernel of the path must have launched, and
nothing fell back.  Each phase ends with a ``[timing]`` line: its seconds
split by what they were spent on (``spent_on`` sections).
The last three lines of standard output are the card (``nvidia-smi`` name,
power limit), one JSON object with every kernel's numbers, and
``{"ok": true, "device": {...}}``.  Details go to ``chiprun_out/``.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import gc
import json
import math
import os
import statistics
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


def log(msg: str) -> None:
    print(msg, flush=True)


# --- where each phase's seconds go ------------------------------------------
# Every second of the host's wall clock is charged to the innermost open
# section ("build" of weights and engines, "flash" writes, "warmup" with its
# graph captures, "traces" the kernel route serves, "kernel_vs_plain", the
# "timing" loops, "profile"s, "train_steps"), its path through the open
# sections joined by "/"; time outside any section is "other".  A phase's
# split is logged on its [timing] line and cleared.
_SECTIONS: list = []
_SPENT: dict = collections.defaultdict(float)
_SINCE = [time.perf_counter()]


def _charge() -> None:
    now = time.perf_counter()
    path = [c for i, c in enumerate(_SECTIONS) if i == 0 or _SECTIONS[i - 1] != c]
    _SPENT["/".join(path) or "other"] += now - _SINCE[0]
    _SINCE[0] = now


@contextlib.contextmanager
def spent_on(category: str):
    _charge()
    _SECTIONS.append(category)
    try:
        yield
    finally:
        _charge()
        _SECTIONS.pop()


def timed(category: str):
    """Decorator: the function's seconds are ``category``'s."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with spent_on(category):
                return fn(*args, **kwargs)
        return run
    return wrap


def timing_split(phase: str) -> dict:
    """Log and return the seconds spent since the last split, by section."""
    _charge()
    split = dict(sorted(_SPENT.items(), key=lambda kv: -kv[1]))
    _SPENT.clear()
    total = sum(split.values())
    log(f"[timing] {phase}: {total:.1f} s = " + ", ".join(
        f"{k} {v:.1f}" for k, v in split.items()))
    return {"total_s": total, "split_s": split}


def instrument() -> None:
    """Charge the port's engine construction, Flash writes, warmups and
    ``Engine.generate`` to their sections (the script's own helpers carry
    ``timed``)."""
    from repro_torch.core import hybrid_storage as HS
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as E
    E.build_engine = timed("build")(E.build_engine)
    E.Engine.__init__ = timed("build")(E.Engine.__init__)
    T.init_params = timed("build")(T.init_params)
    E.EngineLoop.warmup = timed("warmup")(E.EngineLoop.warmup)
    E.Engine.generate = timed("traces")(E.Engine.generate)
    HS.EmbeddingStore.create = classmethod(timed("flash")(HS.EmbeddingStore.create.__func__))
    HS.WeightGroupStore._put = timed("flash")(HS.WeightGroupStore._put)
    HS.WeightGroupStore.flush = timed("flash")(HS.WeightGroupStore.flush)


# whether the dispatcher's float path (A16, group-wise scales) may run: only
# in [quantvar]; every reset of the counts checks the calls since the last
FLOAT_PATH = {"allowed": False}


def guard_float_path() -> None:
    """Make every ``K.reset_launch_counts()`` (one before each path) assert
    that no linear took the float path since the previous reset, unless
    ``FLOAT_PATH["allowed"]``: the float path's count is positive only in
    [quantvar]."""
    from repro_torch import kernels as K
    reset = K.reset_launch_counts

    def checked_reset() -> None:
        n = K.counts()["float_matmul"]
        assert n == 0 or FLOAT_PATH["allowed"], f"{n} linears took the float path"
        reset()
    K.reset_launch_counts = checked_reset


@functools.lru_cache(maxsize=1)
def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


@timed("timing")
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


@timed("timing")
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

def make_pool(n_pages: int, ps: int, hkv: int, d: int, gen, dev, key_bits: int = 8,
              bf16_values: bool = False):
    """A pool (or, with ``n_pages`` and ``ps`` read as B and S, a dense
    cache) whose bytes come from quantizing random keys/values, as the
    serving path writes them: int8 or int4 keys, fp8 or bf16 values."""
    import torch
    from repro_torch.core import kv_cache as KV
    from repro_torch.core import quantization as Q
    k = torch.randn((n_pages, ps, hkv, d), generator=gen, device=dev)
    v = torch.randn((n_pages, ps, hkv, d), generator=gen, device=dev)
    kq, ks, kz = KV.quantize_keys(k.to(torch.bfloat16), bits=key_bits)
    vv = KV.cast_values(v, torch.bfloat16 if bf16_values else Q.FP8_DTYPE)
    return kq.contiguous(), ks.contiguous(), kz.contiguous(), vv


def make_table(lengths, ps: int, n_cols: int, n_pages: int, trash: int, gen, dev):
    import torch
    perm = torch.randperm(n_pages, generator=gen, device=dev).tolist()
    table = torch.full((len(lengths), n_cols), trash, dtype=torch.int32)
    for b, L in enumerate(lengths):
        for c in range(-(-L // ps)):
            table[b, c] = perm.pop()
    return table.to(dev)


def gather_dense(pool, table, dtype, key_bits: int = 8):
    """Library-yardstick input: each row's pages gathered and dequantized."""
    from repro_torch.core import kv_cache as KV
    from repro_torch.kernels.quant_attention import gather_rows
    kq, ks, kz, v = pool
    k = KV.dequantize_keys(gather_rows(kq, table), gather_rows(ks, table),
                           gather_rows(kz, table), dtype, bits=key_bits)
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
    # max_seq 1024 (G=1, row 2b), glm4-9b (G=16: both halves of a block's
    # 16-row tile, row 2c), G=24 (two head tiles a KV head), and @reduced
    # (G=1, D=64).  The timed shapes print the split count the wrapper
    # chooses from their shapes.
    cases = [(4, 28, 4, 128, 128, 16, [732, 296, 512, 41]),
             (4, 16, 16, 128, 128, 8, [416, 80, 272, 64]),
             (4, 32, 2, 128, 128, 16, [732, 296, 512, 41]),
             (4, 48, 2, 128, 128, 16, [732, 296, 512, 41]),
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
        tiles = QA.head_tiles(H // Hkv)
        splits = QA.decode_splits(B, Hkv * tiles, ppr)
        log(f"[kernels] paged_quant_decode_attention G={H // Hkv} D={D} "
            f"lengths={lengths}: {splits} splits of {-(-ppr // splits)} pages, {tiles} "
            f"head tile(s) ({B * Hkv * tiles * splits} blocks), max abs err {err:.3e}")
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
                       library_graph_ms=lib_gms, bound=b, splits=splits, head_tiles=tiles,
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
    # G=1 with ragged per-row lengths, glm4-9b's G=16 (row 6b) and G=24 (two
    # head tiles) at qwen2-7b's lengths, and @reduced.  Timed: D = 128, G > 1.
    dd_rows, dd_errs = [], []
    for B, H, Hkv, D, S, lengths in ((4, 28, 4, 128, 2048, [352] * 4),
                                     (4, 16, 16, 128, 2048, [700, 5, 1333, 2048]),
                                     (4, 32, 2, 128, 2048, [352] * 4),
                                     (4, 48, 2, 128, 2048, [352] * 4),
                                     (3, 4, 2, 64, 64, [37, 5, 64])):
        G = H // Hkv
        timed = G > 1 and D == 128
        def cache():
            k = torch.randn((B, S, Hkv, D), generator=gen, device=dev)
            v = torch.randn((B, S, Hkv, D), generator=gen, device=dev)
            kq, ks, kz = KV.quantize_keys(k.to(torch.bfloat16))
            return kq, ks, kz, KV.cast_values(v, Q.FP8_DTYPE)
        caches = [cache() for _ in range(8 if timed else 1)]
        q = (torch.randn((B, H, D), generator=gen, device=dev) / math.sqrt(D)).to(torch.bfloat16)
        uniform = len(set(lengths)) == 1
        length = torch.tensor(lengths[0] if uniform else lengths, dtype=torch.int32,
                              device=dev)
        args = (q, *caches[0], length)
        got = QA.quant_decode_attention(*args)
        want = QA.quant_decode_attention_plain(
            q, *caches[0], torch.tensor(lengths, dtype=torch.int32, device=dev))
        err = check_close("quant_decode_attention", got, want,
                          f"B={B} G={G} D={D} S={S} lengths={lengths}")
        dd_errs.append(err)
        tiles = QA.head_tiles(G)
        splits = QA.decode_splits(B, Hkv * tiles, -(-S // QA.DENSE_BLOCK))
        log(f"[kernels] quant_decode_attention G={G} D={D} S={S} "
            f"lengths={lengths}: {splits} splits, {tiles} head tile(s) "
            f"({B * Hkv * tiles * splits} blocks), max abs err {err:.3e}")
        if timed:
            sets = [(q, *c, length) for c in caches]
            ms = time_ms(QA.quant_decode_attention, sets)
            gms = graph_ms(QA.quant_decode_attention, sets)
            plens = torch.tensor(lengths, dtype=torch.int32, device=dev)
            plain_ms = time_ms(QA.quant_decode_attention_plain, [(q, *caches[0], plens)],
                               iters=5)
            kq, ks, kz, v = caches[0]
            kd = KV.dequantize_keys(kq, ks, kz).transpose(1, 2).repeat_interleave(G, dim=1)
            vd = v.to(torch.bfloat16).transpose(1, 2).repeat_interleave(G, dim=1)
            mask = (torch.arange(S, device=dev)[None] < plens[:, None])[:, None, None, :]
            lib_ms, lib_gms = library_time(lambda a, b, c, m: F.scaled_dot_product_attention(
                a, b, c, attn_mask=m, scale=1.0), [(q[:, :, None], kd, vd, mask)])
            live = sum(lengths)
            bytes_ = q.numel() * 2 + live * Hkv * (2 * D + 8) + B * H * D * 4
            b = bound(bytes_, 4 * live * H * D, BF16_FLOPS_PER_S)
            dd_rows.append(dict(
                err=err, ms=ms, graph_ms=gms, plain_ms=plain_ms, library_ms=lib_ms,
                library_graph_ms=lib_gms, bound=b, splits=splits, head_tiles=tiles,
                shape=f"B={B} H={H} Hkv={Hkv} D={D} S={S} length={lengths[0]} "
                      f"(Engine.generate decode, G={G})"))
            log(f"[kernels]   {ms:.4f} ms a call, {f4(gms)} ms on the device, bound "
                f"{b[0]:.5f} ms ({b[1]}); plain {plain_ms:.4f} ms; SDPA {f4(lib_ms)} ms a "
                f"call, {f4(lib_gms)} ms on the device")
            del kd, vd
        del caches
    results["quant_decode_attention"] = dict(dd_rows[0], err=max(dd_errs),
                                             all_shapes=dd_rows)

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


def phase_ops(dev) -> dict:
    """``[ops]``: the public ops of ``kernels/ops.py`` on the card at
    qwen2-7b's widths (the shapes of ``PERF.md``'s kernel rows 1, 4, 6 and
    7): a gate/up linear (K 3584, N 18944, int4) at M = 4 and 128, RMSNorm
    over 4 rows of 3584, dense decode attention of 4 rows over 352 live of
    2048 slots (G = 7), a 320-token causal prefill over a 1024-key cache,
    each against its oracle in ``kernels/ref.py`` (integer matmul on the
    unpacked weights; float32 attention and norm) at its kernel's
    tolerance.  Kernels 1, 4, 6 and 7 must launch, counted from zero."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import quantization as Q
    from repro_torch.kernels import ops as OPS
    from repro_torch.kernels import ref as REF
    from repro_torch.runtime import plan as RP
    gen = torch.Generator(device=dev).manual_seed(2929)
    errs = {}
    K.reset_launch_counts()
    pl = RP.pack_linear(Q.quantize(
        torch.randn((3584, 18944), generator=gen, device=dev) * 0.02, 4))
    wq = Q.unpack_int4(pl.data)
    for M in (4, 128):
        x = torch.randn((M, 3584), generator=gen, device=dev).to(torch.bfloat16)
        got = OPS.quant_matmul_kernel(x, pl.data, pl.scale[0], pl.zero[0], bits=4)
        xq, sx = Q.quantize_activations(x)
        errs[f"quant_matmul_kernel M={M}"] = check_close(
            "w4a8_matmul", got, REF.w4a8_matmul_ref(xq, sx, wq, pl.scale[0], pl.zero[0]),
            f"[ops] gate/up M={M}")
    del pl, wq
    x = torch.randn((4, 3584), generator=gen, device=dev).to(torch.bfloat16)
    w = 1.0 + 0.1 * torch.randn((3584,), generator=gen, device=dev)
    errs["rmsnorm rows=4"] = check_close("rmsnorm", OPS.rmsnorm(x, w, 1e-6),
                                         REF.rmsnorm_ref(x, w, 1e-6), "[ops] rows=4")
    B, H, Hkv, D, S = 4, 28, 4, 128, 2048
    q = (torch.randn((B, H, D), generator=gen, device=dev) / math.sqrt(D)).to(torch.bfloat16)
    cache = make_pool(B, S, Hkv, D, gen, dev)
    length = torch.full((B,), 352, dtype=torch.int32, device=dev)
    errs["quant_decode_attention 352 of 2048"] = check_close(
        "quant_decode_attention", OPS.quant_decode_attention(q, *cache, length),
        REF.quant_decode_attention_ref(q, *cache, length), "[ops] 352 of 2048 slots")
    del cache
    q = (torch.randn((1, 320, H, D), generator=gen, device=dev) / math.sqrt(D)).to(torch.bfloat16)
    k = torch.randn((1, 1024, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((1, 1024, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
    errs["flash_prefill T=320"] = check_close(
        "flash_prefill_attention", OPS.flash_prefill(q, k, v),
        REF.flash_prefill_ref(q, k, v), "[ops] T=320 S=1024 causal")
    counts = K.counts()
    for name in ("w4a8_matmul", "rmsnorm", "quant_decode_attention",
                 "flash_prefill_attention"):
        assert counts[name] > 0, f"[ops] {name} never launched: {counts}"
    torch.cuda.synchronize()
    log("[ops] kernels/ops.py against kernels/ref.py: " + ", ".join(
        f"{k} max abs err {v:.3e}" for k, v in errs.items()) + f"; launches {counts}")
    return {"max_abs_err": errs, "launches": counts}


def phase_geometry(dev) -> dict:
    """``[geometry]`` (C6): transpose -> slice -> transpose over one
    qwen2-7b layer's keys at 512 tokens ([512, 4, 128] bf16: 2^18 elements,
    the largest space the reference's Rule 2 fuses) -- heads 1-2 of tokens
    128-383.  The fused plan has one stage and at most half the memory
    operations of the staged chain; on the card its output is bit-equal to
    the composed ``permute``/slice ops and to the staged plan.  Each is
    timed a call (a plan builds its index tensors on the card each call)."""
    import torch
    from repro_torch.core import geometry as GEO
    x = torch.randn((512, 4, 128), generator=torch.Generator(device=dev).manual_seed(6),
                    device=dev).to(torch.bfloat16)
    chain = [GEO.region_transpose((512, 4, 128), (1, 0, 2)),
             GEO.region_slice((4, 512, 128), (1, 128, 0), (2, 256, 128)),
             GEO.region_transpose((2, 256, 128), (1, 0, 2))]
    numels = [2 ** 18, 2 ** 16, 2 ** 16]
    t0 = time.perf_counter()
    plan = GEO.fuse_chain(chain, numels)
    fuse_s = time.perf_counter() - t0
    staged = GEO.Plan(stages=[(list(step), n) for step, n in zip(chain, numels)])
    assert plan.num_stages == 1, plan
    assert 2 * plan.memory_ops <= staged.memory_ops, (plan.memory_ops, staged.memory_ops)

    def composed(a):
        return a.permute(1, 0, 2)[1:3, 128:384].permute(1, 0, 2).contiguous()
    want = composed(x)
    got = GEO.execute_plan(plan, x).reshape(want.shape)
    assert got.device == x.device and torch.equal(got, want), "the fused plan moved other bytes"
    assert torch.equal(GEO.execute_plan(staged, x).reshape(want.shape), want)
    ms = {"fused": time_ms(lambda a: GEO.execute_plan(plan, a), [(x,)]),
          "staged": time_ms(lambda a: GEO.execute_plan(staged, a), [(x,)]),
          "composed": time_ms(composed, [(x,)])}
    log(f"[geometry] K [512, 4, 128] bf16 -> transpose -> slice -> transpose: fused to "
        f"{plan.num_stages} stage {plan.stages[0][0]} in {fuse_s:.2f} s on the host; "
        f"memory ops {plan.memory_ops} against {staged.memory_ops} staged "
        f"({plan.memory_ops / staged.memory_ops:.3f}); bit-equal to the composed ops "
        f"on {x.device}; a call: fused {ms['fused']:.4f} ms, staged "
        f"{ms['staged']:.4f} ms, permute/slice {ms['composed']:.4f} ms")
    return {"stages": plan.num_stages, "memory_ops": plan.memory_ops,
            "staged_memory_ops": staged.memory_ops, "fuse_s": fuse_s, "ms": ms}


def phase_dryrun(dev) -> dict:
    """``[dryrun]``: the meta dry run (``launch/dryrun.py``) of the 40
    ``ASSIGNED x INPUT_SHAPES`` cases against this card's capacity, as a
    table (OK/SKIP/FAIL, argument GiB, fits); records to ``OUT /
    "dryrun"``.  No case may fail; the 7 full-attention archs
    skip ``long_500k``."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as MESH
    mesh = MESH.make_host_mesh(dev)
    recs = [DR.run_case(a, s, mesh, out_dir=str(OUT / "dryrun"))
            for a in registry.ASSIGNED for s in INPUT_SHAPES]
    log(f"[dryrun] {mesh.name}, {mesh.memory_bytes / 2**30:.2f} GiB, {mesh.size} chip "
        f"{mesh.axis_names} = {mesh.shape}:")
    for line in DR.summary_table(recs).splitlines():
        log(f"[dryrun] {line}")
    status = collections.Counter(r["status"] for r in recs)
    assert len(recs) == 40 and status["FAIL"] == 0 and status["SKIP"] == 7, status
    return {"status": dict(status), "fits": sum(r.get("fits", False) for r in recs),
            "device_memory_bytes": mesh.memory_bytes}


# the paper's quantization variants of kernels 2, 3 and 6 beyond int8 keys
# with fp8 values: (key bits, bf16 values)
VARIANT_ROWS = ((4, False), (8, True))


def variant_name(key_bits: int, bf16_values: bool) -> str:
    return f"int{key_bits} keys, {'bf16' if bf16_values else 'fp8'} values"


def kv_bytes_per_key(hkv: int, d: int, key_bits: int, bf16_values: bool) -> int:
    """Bytes a live key costs the attention kernels: its key codes, its
    values and its scale and zero, over the KV heads."""
    return hkv * (d * key_bits // 8 + d * (2 if bf16_values else 1) + 8)


def phase_variant_kernels(dev, results: dict) -> None:
    """Kernels 2, 3 and 6 at the shapes of rows 2, 3 and 6 (qwen2-7b, G = 7:
    4 rows over 16 pages of 128 with the trace's ragged lengths; a
    128-token chunk at 256; 4 rows of 352 live slots of 2048) once with
    int4 keys and fp8 values and once with int8 keys and bf16 values:
    each held to its plain version, timed a call and on the device, with
    its bound (the variant's bytes) and SDPA over the dequantized K/V."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import kv_cache as KV
    from repro_torch.kernels import flash_prefill as FP
    from repro_torch.kernels import quant_attention as QA

    gen = torch.Generator(device=dev).manual_seed(2727)
    B, H, Hkv, D, ps, ppr, lengths = 4, 28, 4, 128, 128, 16, [732, 296, 512, 41]
    G = H // Hkv

    def sdpa(q4, k, v, mask):
        return library_time(lambda a, b, c, m: F.scaled_dot_product_attention(
            a, b, c, attn_mask=m, scale=1.0),
            [(q4, k.transpose(1, 2).repeat_interleave(G, dim=1),
              v.transpose(1, 2).repeat_interleave(G, dim=1), mask)])

    def row(name, what, fn, plain, sets, args, bytes_, ops, lib):
        err = check_close(name, fn(*args), plain(*args), what)
        ms, gms = time_ms(fn, sets), graph_ms(fn, sets)
        plain_ms = time_ms(plain, [args], iters=5)
        b = bound(bytes_, ops, BF16_FLOPS_PER_S)
        out = {"what": what, "ms": ms, "graph_ms": gms, "plain_ms": plain_ms,
               "max_abs_err": err, "bound_ms": b[0], "bound_by": b[1],
               "library_ms": lib[0], "library_graph_ms": lib[1]}
        results[name]["all_shapes"].append(out)
        results[name]["err"] = max(results[name]["err"], err)
        log(f"[kernels] {name} {what}: {ms:.4f} ms a call, {f4(gms)} ms on the device, "
            f"bound {b[0]:.5f} ms ({b[1]}); plain {plain_ms:.4f} ms; SDPA {f4(lib[0])} ms "
            f"a call, {f4(lib[1])} ms on the device; max abs err {err:.3e}")

    results["paged_flash_prefill_attention"].setdefault("all_shapes", [])
    for bits, bf16 in VARIANT_ROWS:
        var = variant_name(bits, bf16)
        per_key = kv_bytes_per_key(Hkv, D, bits, bf16)
        # row 2: paged decode
        n_pages = B * ppr + 1 + max(2, ppr - 2)
        trash = B * ppr
        pools = [make_pool(n_pages, ps, Hkv, D, gen, dev, bits, bf16) for _ in range(8)]
        table = make_table(lengths, ps, ppr, trash, trash, gen, dev)
        q = (torch.randn((B, H, D), generator=gen, device=dev) / math.sqrt(D)).to(torch.bfloat16)
        base = torch.zeros((B,), dtype=torch.int32, device=dev)
        length = torch.tensor(lengths, dtype=torch.int32, device=dev)
        k, v = gather_dense(pools[0], table, torch.bfloat16, bits)
        mask = (torch.arange(k.shape[1], device=dev)[None] < length[:, None])[:, None, None, :]
        live = sum(lengths)
        row("paged_quant_decode_attention",
            f"{var}: B={B} H={H} Hkv={Hkv} D={D} page={ps} pages={ppr} lengths={lengths}",
            lambda *a: QA.paged_quant_decode_attention(*a, key_bits=bits),
            lambda *a: QA.paged_quant_decode_attention_plain(*a, key_bits=bits),
            [(q, *p, table, base, length) for p in pools], (q, *pools[0], table, base, length),
            q.numel() * 2 + live * per_key + B * H * D * 4, 4 * live * H * D,
            sdpa(q[:, :, None], k, v, mask))
        del pools, k, v
        # row 3: a 128-token chunk at 256 through the page table
        C, pos0 = 128, 256
        n_pages = 4 * ppr + 1 + max(2, ppr - 2)
        trash = 4 * ppr
        pools = [make_pool(n_pages, ps, Hkv, D, gen, dev, bits, bf16) for _ in range(8)]
        table = make_table([pos0 + C], ps, ppr, trash, trash, gen, dev)
        qc = (torch.randn((1, C, H, D), generator=gen, device=dev) / math.sqrt(D)).to(torch.bfloat16)
        p0 = torch.tensor([pos0], dtype=torch.int32, device=dev)
        k, v = gather_dense(pools[0], table, torch.bfloat16, bits)
        qpos = pos0 + torch.arange(C, device=dev)
        mask = (torch.arange(k.shape[1], device=dev)[None] <= qpos[:, None])[None, None]
        row("paged_flash_prefill_attention",
            f"{var}: B=1 C={C} pos0={pos0} H={H} Hkv={Hkv} D={D} page={ps}",
            lambda *a: FP.paged_flash_prefill_attention(*a, key_bits=bits),
            lambda *a: FP.paged_flash_prefill_attention_plain(*a, key_bits=bits),
            [(qc, *p, table, p0) for p in pools], (qc, *pools[0], table, p0),
            qc.numel() * 2 + (pos0 + C) * per_key + C * H * D * 4,
            4 * H * D * sum(pos0 + i + 1 for i in range(C)),
            sdpa(qc.transpose(1, 2), k, v, mask))
        del pools, k, v
        # row 6: the dense cache of Engine.generate's decode
        S, dl = 2048, [352] * 4
        caches = [make_pool(B, S, Hkv, D, gen, dev, bits, bf16) for _ in range(8)]
        dlen = torch.tensor(dl, dtype=torch.int32, device=dev)
        kq, ks, kz, vv = caches[0]
        k = KV.dequantize_keys(kq, ks, kz, bits=bits)
        mask = (torch.arange(S, device=dev)[None] < dlen[:, None])[:, None, None, :]
        row("quant_decode_attention",
            f"{var}: B={B} H={H} Hkv={Hkv} D={D} S={S} length={dl[0]}",
            lambda *a: QA.quant_decode_attention(*a, key_bits=bits),
            lambda *a: QA.quant_decode_attention_plain(*a, key_bits=bits),
            [(q, *c, dlen) for c in caches], (q, *caches[0], dlen),
            q.numel() * 2 + sum(dl) * per_key + B * H * D * 4, 4 * sum(dl) * H * D,
            sdpa(q[:, :, None], k, vv.to(torch.bfloat16), mask))
        del caches, k
    torch.cuda.synchronize()


def bound(bytes_: float, ops: float, peak_ops: float):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

def make_trace(vocab: int, seed: int = 0, requests: int = 8):
    """``requests`` (at most 8) prompts of 40-700 tokens, every third
    sharing a 256-token prefix, and their arrival steps."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(1, vocab, 256)]
    specs = []
    for i in range(requests):
        n = int(rng.integers(40, 701))
        if i % 3 == 0:
            n = max(n, 300)
            prompt = shared + [int(t) for t in rng.integers(1, vocab, n - 256)]
        else:
            prompt = [int(t) for t in rng.integers(1, vocab, n)]
        specs.append(prompt)
    arrivals = [0, 0, 1, 2, 4, 7, 11, 16][:requests]
    return specs, arrivals


def step_name(key) -> str:
    """A step shape's name: ("decode", 4, True) -> "decode4+lora"."""
    kind, n, lora = key
    return f"{kind}{n}" + ("+lora" if lora else "")


def make_loop(engine, cuda_graphs: bool = False, prefill_token_budget: int = 256,
              bucketing: bool = True):
    """The serving paths' ``EngineLoop``: 4 slots, 128-token chunks; eager on
    the card unless ``cuda_graphs``."""
    from repro_torch.serving import engine as E
    return E.EngineLoop(engine, max_slots=4, prefill_chunk=128,
                        prefill_token_budget=prefill_token_budget,
                        cuda_graphs=cuda_graphs, bucketing=bucketing)


@timed("traces")
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


def allocated_before_build(dev) -> int:
    """The device memory live tensors hold before an engine's build (after
    collecting what earlier phases left unreferenced)."""
    import torch
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated(dev)


def predicted_vs_allocated(label: str, cfg, max_seq: int, m0: int, dev) -> dict:
    """``[dryrun]``: the dry run's prediction of an engine (the packed
    parameters and its ``EngineLoop``'s KV pool, from shapes on the meta
    device) against the growth of ``memory_allocated`` across the build
    and the loop's construction, before any warmup; within 5%."""
    import torch
    from repro_torch.launch import dryrun as DR
    with spent_on("dryrun"):
        got = torch.cuda.memory_allocated(dev) - m0
        pred = DR.engine_bytes(cfg, max_seq, max_slots=4)
        total = pred["params"] + pred["kv_pool"]
        rel = got / total - 1
        log(f"[dryrun] {label}: predicted {total / 2**30:.3f} GiB (packed params "
            f"{pred['params'] / 2**30:.3f} + KV pool {pred['kv_pool'] / 2**30:.3f}), "
            f"measured {got / 2**30:.3f} GiB allocated by the build and the loop "
            f"({100 * rel:+.2f}%)")
        assert abs(rel) <= 0.05, f"{label}: the dry run is {100 * rel:+.2f}% off"
    return {"predicted_bytes": total, **pred, "allocated_bytes": got, "rel_err": rel}


def phase_main_path(dev):
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import registry
    from repro_torch.serving import engine as E

    cfg = registry.get("qwen2-7b")
    m0 = allocated_before_build(dev)
    t0 = time.perf_counter()
    eng = E.build_engine(cfg, seed=0, max_seq=2048, device=dev)
    loop = make_loop(eng)
    torch.cuda.synchronize()
    memory = predicted_vs_allocated("qwen2-7b", cfg, 2048, m0, dev)
    log(f"[main] qwen2-7b: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.padded_vocab_size}; weights + Flash embedding built in "
        f"{time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    specs, arrivals = make_trace(cfg.vocab_size)
    log(f"[main] trace: prompts {[len(p) for p in specs]}, arrivals {arrivals}; "
        "eager (cuda_graphs=False)")
    K.reset_launch_counts()
    loop, reqs, wall = serve_trace(eng, specs, arrivals, loop=loop)
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
        "launches": counts, "dryrun_memory": memory,
    }
    log(f"[main] {len(reqs)} requests, {new_tokens} new tokens in {wall:.2f} s; "
        f"TTFT p50 {summary['ttft_p50_ms']:.1f} ms p95 {summary['ttft_p95_ms']:.1f} ms; "
        f"TPOT p50 {summary['tpot_p50_ms']:.2f} ms; decode {s.decode_tps:.1f} tok/s; "
        f"prefill {s.prefill_tps:.1f} tok/s; prefix pages adopted "
        f"{loop.pool.prefix_hits}")
    return eng, specs, arrivals, reqs, summary


def phase_graphs(label: str, eng, specs, arrivals, eager_reqs, max_new: int,
                 kernels, spies=None, roofline: bool = False) -> dict:
    """The trace of an eager ``EngineLoop`` run again through a warmed loop's
    CUDA graphs (one per decode bucket, or the one 4-row step, and one per
    chunk size): warmup time and the device memory the graph pool reserves,
    then every request finishes with the eager run's greedy tokens, token
    for token, no graph is captured after warmup, each kernel of ``kernels``
    launched (a replay adds what its capture recorded) and nothing fell
    back.  ``spies`` (a context manager) wraps the warmup, whose eager runs
    and captures are the only Python calls the graphs' steps make.  Then a
    4-row decode step on the same graphs is profiled
    (``profile_loop_decode``), with its ``[roofline]`` line if
    ``roofline``.  Returns (summary, profile)."""
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
    counts = K.counts()
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
    # a graph decode step profiled on this loop: its graphs are already
    # captured, so the profile needs no second warmup
    profile = profile_loop_decode(eng, specs, loop=loop, roofline=roofline)
    assert eng.stats.recompiles_after_warmup == 0, "the profile captured a graph"
    loop.close()
    return summary, profile


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


# steps under the profiler: collecting its events costs the host far more
# than the steps (an eager step launches 3,500-13,000 kernels), so the wall
# is timed over ``steps`` unprofiled steps and the profile reads one
PROFILED_STEPS = 1


@timed("profile")
def profile_steps(label: str, step, steps: int = 4) -> dict:
    """Where a decode step's time goes: wall time per ``step()`` over
    ``steps`` steps, the host-device synchronizations of one step, and the
    device's busy share and top kernels of ``PROFILED_STEPS`` more under
    ``torch.profiler`` (reported, not asserted; "not
    measured" where the profiler sees no device time).  The profiler
    records CUDA activity only: the device's kernels and the host's CUDA
    runtime calls (which Kineto's CUDA activity includes), not the
    thousands of PyTorch operator events an eager step makes on the host,
    whose collection and aggregation cost the script minutes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.analysis import trace
    with spent_on("unprofiled"):
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
    with spent_on("profiler"), profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with spent_on("profiler"):
        out.update(trace.summarize(prof, PROFILED_STEPS, wall_us))
    if out["device_busy_share"] != "not measured":
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
        log(f"[profile] {label}: host time in CUDA runtime calls per step: " + (", ".join(
            f"{n} {k['host_ms_per_step']:.2f} ms ({k['calls_per_step']:.0f})"
            for n, k in out["runtime_calls"].items()) or "not measured (none recorded)"))
    else:
        log(f"[profile] {label}: {step_ms:.1f} ms wall; the profiler saw no device "
            "time (device busy share not measured)")
    return out


class MoeIds:
    """While entered: the expert ids each MoE layer's router chose, in the
    order the layers run (the third output of both MoE branches, the
    reference's ``collect["moe_ids"]``)."""

    def __enter__(self):
        from repro_torch.models import moe as M
        self.ids = []
        self._originals = originals = (M._dispatch_moe, M._dispatch_moe_tiny)

        def recorded(fn):
            def inner(*a, **kw):
                out = fn(*a, **kw)
                self.ids.append(out[2])
                return out
            return inner
        M._dispatch_moe, M._dispatch_moe_tiny = (recorded(f) for f in originals)
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.models import moe as M
        M._dispatch_moe, M._dispatch_moe_tiny = self._originals


def roofline_line(eng, loop, profile: dict) -> dict:
    """``[roofline]``: the bound of the decode step just profiled
    (``analysis.roofline.decode_step_bound`` from the engine's tree, each
    row's keys read in that step, and for an MoE model the experts routed
    in one more step, run eagerly under ``MoeIds``: a graph replay runs no
    Python), set against the profile's
    device time and the unprofiled steps' wall time."""
    import torch
    from repro_torch.analysis import roofline as RL
    cfg = eng.cfg
    active = [i for i, r in enumerate(loop.scheduler.running) if r is not None]
    pos = loop.cache["pos"].tolist()
    lens = [pos[i] for i in active]
    expert_ids = None
    if cfg.num_experts:
        loop._launch = loop._step_body      # one step eagerly, even on a graph loop
        try:
            with MoeIds() as spy:
                loop.step()
            torch.cuda.synchronize()
        finally:
            del loop._launch
        expert_ids = spy.ids
    b = RL.decode_step_bound(cfg, eng.params, loop.max_slots, lens, expert_ids)
    dev_ms = profile.get("device_ms_per_step")
    sh = RL.shares(b.bound_s, dev_ms and dev_ms / 1e3, profile["decode_step_ms"] / 1e3)
    pct = lambda x: x if isinstance(x, str) else f"{100 * x:.1f}%"   # noqa: E731
    gb = {k: v / 1e9 for k, v in b.bytes.items()}
    log(f"[roofline] {cfg.name} decode step, {loop.max_slots} rows, keys {lens}: bound "
        f"{b.bound_s * 1e3:.3f} ms by {b.bound_by} ({b.total_bytes / 1e9:.3f} GB: " + ", ".join(
            f"{k} {v:.3f}" for k, v in gb.items() if v) + "; " + ", ".join(
            f"{t} {n / 1e9:.2f} G" for t, n in b.ops.items()) + f" operations); device "
        f"{f4(dev_ms)} ms of kernels -> {pct(sh['device_share'])}; wall "
        f"{profile['decode_step_ms']:.2f} ms -> {pct(sh['wall_share'])}; on {card_line()}")
    return {"bound_ms": b.bound_s * 1e3, "bound_by": b.bound_by, "bytes": b.bytes,
            "ops": b.ops, "context_lens": lens, "device_ms": dev_ms,
            "wall_ms": profile["decode_step_ms"], **sh, "card": card_line()}


@timed("profile")
def profile_loop_decode(eng, specs, steps: int = 4, cuda_graphs: bool = False,
                        adapters=(None,) * 4, loop=None, roofline: bool = False) -> dict:
    """A full-batch ``EngineLoop`` step with four rows decoding (row i under
    adapter ``adapters[i]``), eager or (``cuda_graphs``, after ``warmup()``)
    replaying its CUDA graph; ``loop``: an idle loop already warmed (its
    graphs are replayed, and it is left open).  Each request asks for the
    tokens the profile's steps need and a margin (``profile_steps`` runs 2
    + 2 * ``steps``), so draining the loop afterwards costs a few steps."""
    from repro_torch.serving import engine as E
    from repro_torch.serving import sampling as SM
    own = loop is None
    if own:
        loop = make_loop(eng, cuda_graphs=cuda_graphs, prefill_token_budget=512)
        if cuda_graphs:
            loop.warmup()
    cuda_graphs = loop.cuda_graphs
    new = 2 * steps + 8
    sp = SM.SamplingParams(temperature=0.0, max_new_tokens=new)
    for i, p in enumerate(specs[:4]):
        loop.submit(E.Request(uid=100 + i, prompt_tokens=p[:128], max_new_tokens=new,
                              sampling=sp, adapter=adapters[i]))
    while loop._prefilling or sum(r is not None for r in loop.scheduler.running) < 4:
        loop.step()
    how = ("CUDA graphs" if cuda_graphs else "eager") + (
        f", adapters {list(adapters)}" if any(adapters) else "")
    out = profile_steps(f"{eng.cfg.name} EngineLoop decode step, 4 rows, {how}",
                        loop.step, steps)
    assert sum(r is not None for r in loop.scheduler.running) == 4, "a row finished early"
    if roofline:
        with spent_on("roofline"):
            out["roofline"] = roofline_line(eng, loop, out)
    out["rows"] = 4
    while loop.has_work():
        loop.step()
    if own:
        loop.close()
    return out


# ---------------------------------------------------------------------------
# kernel path against plain path at full width, layer by layer
# ---------------------------------------------------------------------------

def run_layers(engine, x, mode, positions, pos, table, cache, fed, lora=None, entry=None,
               **kw):
    """Every layer of the model on ``x``, stack by stack and pattern by
    pattern, against the caches of ``cache["stacks"]``; with ``fed``
    (another run's per-layer outputs) layer i takes that run's output of
    layer i-1 instead of its own input, and the logits are taken on that
    run's last hidden state.  ``lora``: the step's adapter tables and ids;
    ``entry(i, layer_cache)``: the cache layer i reads in place of its own
    (``[kvflash]``'s history joined from Flash); ``kw``: a chunk's ``slot``
    and ``valid_len`` (windowed layers).  An encoder-decoder's layers read
    their cross caches, ``cache["cross"]``."""
    from repro_torch.core.precision import DEFAULT_POLICY
    from repro_torch.models import transformer as T
    cfg = engine.cfg
    cross = cache.get("cross")
    outs = []
    for si, (patterns, count) in enumerate(cfg.layer_plan()):
        for li in range(count):
            for pi, pat in enumerate(patterns):
                inp = x if fed is None or not outs else fed[len(outs) - 1]
                layer_cache = T.layer_entry(cache["stacks"][si][pi], li)
                if entry is not None:
                    layer_cache = entry(len(outs), layer_cache)
                x, _ = T._apply_layer(inp, T.layer_slice(engine.params["stacks"][si][pi], li),
                                      cfg, pat, mode, positions, layer_cache, pos, table,
                                      engine.dispatch, DEFAULT_POLICY, lora=lora,
                                      cross=None if cross is None else
                                      T.layer_entry(cross[si][pi], li), **kw)
                outs.append(x)
    last = outs[-1] if fed is None else fed[-1]
    return outs, T._logits(last[:, -1:], engine.params, cfg, engine.dispatch)[:, 0]


def chunk_then_decode(engine, prompt, nxt, feed=None, lora=None):
    """One 128-token prompt chunk into a fresh paged pool (row 0, whose
    recurrent state starts at zero) and the decode step of token ``nxt``
    after it (``lora``: the adapter tables and the row's id, carried by
    both).  Returns the per-layer hidden states and the logits of both."""
    import numpy as np
    import torch
    from repro_torch.serving import engine as E
    dev = engine.device
    loop = E.EngineLoop(engine, max_slots=4, prefill_chunk=128)
    loop.pool.alloc_row(0, 129)
    cache = loop.cache
    cache["table"] = torch.as_tensor(loop.pool.table, device=dev)
    ids = np.asarray(prompt[:128], np.int64)[None]
    chunk = run_layers(engine, engine.embed(ids), "prefill_paged",
                       torch.arange(128, device=dev)[None], 0, cache["table"][0], cache,
                       None if feed is None else feed["chunk"][0], lora,
                       slot=torch.zeros((1,), dtype=torch.int32, device=dev),
                       valid_len=torch.full((1,), 128, dtype=torch.int32, device=dev))
    pos = torch.tensor([128], dtype=torch.int32, device=dev)
    dec = run_layers(engine, engine.embed(np.asarray([[nxt]], np.int64)), "decode",
                     pos[:, None], pos, cache["table"][:1], cache,
                     None if feed is None else feed["decode"][0], lora)
    loop.close()
    return {"chunk": chunk, "decode": dec}


def prefill_then_decode(engine, prompt, nxt, feed=None, caches=None, positions=None,
                        dec_positions=None):
    """``Engine.generate``'s steps: the whole prompt into a fresh dense cache
    of ``max_seq`` slots (``caches``: one the caller made, an
    encoder-decoder's with its cross caches), then the decode step of token
    ``nxt``; ``positions`` [1, T] or [1, T, 3] and ``dec_positions`` default
    to the token positions."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    dev = engine.device
    T_ = len(prompt)
    if caches is None:
        caches = T.init_cache(engine.cfg, 1, engine.max_seq, device=dev)
    pos = torch.tensor(T_, dtype=torch.int32, device=dev)
    pre = run_layers(engine, engine.embed(np.asarray(prompt, np.int64)[None]), "prefill",
                     torch.arange(T_, device=dev)[None] if positions is None else positions,
                     None, None, caches, None if feed is None else feed["prefill"][0])
    dec = run_layers(engine, engine.embed(np.asarray([[nxt]], np.int64)), "decode",
                     pos.expand(1, 1) if dec_positions is None else dec_positions, pos, None,
                     caches, None if feed is None else feed["decode"][0])
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


@timed("kernel_vs_plain")
def compare_paths(label: str, eng, steps_fn, prompt, nxt) -> dict:
    """Kernel path against plain path at full width and depth.  Free running,
    the int8 re-quantization of every linear's input turns last-bit
    differences into whole quantization steps, so the runs drift apart with
    depth; that drift is printed.  The assertion holds every layer, and the
    head, to the tolerance on the same input.  On an MoE model a token whose
    router picks another expert set in the two runs (a near tie decided by
    float noise) is a discrete change, not a kernel error: such tokens are
    counted, bounded by MAX_ROUTE_FLIPS, and left out of that layer's error.
    A step with no logits (an encoder's, whose last entry is its final
    norm) is held layer by layer only."""
    import torch
    from repro_torch.serving import engine as E
    gc.collect()
    torch.cuda.empty_cache()     # the plain path's transients want whole free blocks
    plain = E.Engine(eng.cfg, eng.params, eng.embedding, max_seq=eng.max_seq,
                     device=eng.device, backend="reference")
    V = eng.cfg.vocab_size
    ref, ref_ids = routed(steps_fn, plain, prompt, nxt)
    free = steps_fn(eng, prompt, nxt)
    forced, forced_ids = routed(steps_fn, eng, prompt, nxt, feed=ref)
    # which layers route (jamba: every other one); the router ids come one
    # list entry per MoE layer and step, in layer order
    moe_of = [pat.moe for patterns, count in eng.cfg.layer_plan() for _ in range(count)
              for pat in patterns]
    per_step = sum(moe_of)                             # MoE layers per step
    assert len(ref_ids) == per_step * len(ref), (len(ref_ids), per_step)
    out = {}
    for si, what in enumerate(ref):
        (ref_h, ref_l), (free_h, free_l), (forced_h, forced_l) = (
            ref[what], free[what], forced[what])
        for t in (*ref_h, *forced_h, *(() if ref_l is None else (ref_l, free_l, forced_l))):
            assert torch.isfinite(t).all(), what
        drift = [rel_l2(a, b) for a, b in zip(free_h, ref_h)]
        per_layer, flipped, tokens = [], 0, 0
        for li, (a, b) in enumerate(zip(forced_h, ref_h)):
            keep = torch.ones(a.shape[1], dtype=torch.bool, device=a.device)
            if per_step and moe_of[li]:
                mi = si * per_step + sum(moe_of[:li])
                ra, rb = forced_ids[mi], ref_ids[mi]
                keep = (ra == rb).all(dim=-1)
                flipped += int((~keep).sum())
                tokens += keep.numel()
            per_layer.append(rel_l2(a[:, keep], b[:, keep]) if keep.any() else 0.0)
        if ref_l is None:
            out[what] = {"per_layer_rel_l2": per_layer, "free_running_rel_l2_by_layer": drift}
            log(f"[check] {label} {what}: kernel vs plain on the same input: max over "
                f"{len(per_layer)} layers rel L2 {max(per_layer):.3e} (tolerance "
                f"{LAYER_REL_L2}); free running: last {drift[-1]:.3e} (printed, not asserted)")
            assert max(per_layer) <= LAYER_REL_L2, f"{label} {what}: a layer disagrees {per_layer}"
            continue
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


# requests of the trace the plain path serves again for the greedy agreement
PLAIN_TRACE_REQUESTS = 4


@timed("kernel_vs_plain")
def phase_kernel_vs_plain(eng, specs, arrivals, reqs):
    """The continuous path's layer check, plus the greedy agreement of the
    trace's first ``PLAIN_TRACE_REQUESTS`` requests on the plain path
    (printed, not asserted)."""
    from repro_torch.serving import engine as E
    prompt = next(p for p in specs if len(p) > 128)
    out = compare_paths("EngineLoop", eng, chunk_then_decode, prompt, prompt[128])
    plain = E.Engine(eng.cfg, eng.params, eng.embedding, max_seq=eng.max_seq,
                     device=eng.device, backend="reference")
    t0 = time.perf_counter()
    n = PLAIN_TRACE_REQUESTS
    _, preqs, _ = serve_trace(plain, specs[:n], arrivals[:n])
    reqs = reqs[:n]
    same_req = sum(a.generated == b.generated for a, b in zip(reqs, preqs))
    agree = sum(sum(x == y for x, y in zip(a.generated, b.generated))
                for a, b in zip(reqs, preqs))
    total = sum(len(a.generated) for a in reqs)
    out["greedy"] = {"requests_identical": same_req, "requests": len(reqs),
                     "tokens_equal": agree, "tokens": total,
                     "plain_trace_s": time.perf_counter() - t0}
    log(f"[check] greedy agreement over the trace's first {n} requests (plain path on "
        f"the card): "
        f"{same_req}/{len(reqs)} requests identical, {agree}/{total} tokens equal "
        f"position by position (printed, not asserted)")
    return out


# ---------------------------------------------------------------------------
# phase 4: Engine.generate at full width
# ---------------------------------------------------------------------------

GENERATE_KERNELS = ("quant_decode_attention", "flash_prefill_attention", "w4a8_matmul",
                    "rmsnorm")


def phase_generate(eng, tag: str = "generate", prompt_len: int = 320,
                   kernels=GENERATE_KERNELS, steps=None, profile: bool = True) -> dict:
    """Four greedy requests with equal-length prompts of ``prompt_len``
    tokens through the slot-synchronous ``Engine.generate`` (it decodes the
    batch at request 0's position, so unequal prompts would decode at the
    wrong offsets); ``tag`` heads its log lines, and every kernel of
    ``kernels`` must launch.  A decode step is profiled unless not
    ``profile``.  Then request 0's prefill and a decode step
    kernel vs plain through ``steps`` (``compare_paths``' steps function;
    by default ``prefill_then_decode`` on token positions)."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as E
    from repro_torch.serving import sampling as SM
    cfg = eng.cfg
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, prompt_len)]
               for _ in range(4)]
    reqs = [E.Request(uid=i, prompt_tokens=p, max_new_tokens=32)
            for i, p in enumerate(prompts)]
    eng.stats = E.EngineStats()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(reqs, SM.SamplingParams(temperature=0.0, max_new_tokens=32))
    wall = time.perf_counter() - t0
    counts = K.counts()
    s = eng.stats
    log(f"[{tag}] Engine.generate launches: {counts}")
    assert all(r.done and len(r.generated) == 32 for r in reqs), "unfinished requests"
    for name in kernels:
        assert counts[name] > 0, f"{name} never launched on Engine.generate: {counts}"
    assert eng.dispatch.fallbacks == [], eng.dispatch.fallbacks
    summary = {"wall_s": wall, "requests": 4, "prompt_tokens": prompt_len, "new_tokens": 128,
               "prefill_s": s.prefill_s, "decode_s": s.decode_s,
               "prefill_tok_per_s": s.prefill_tps, "decode_tok_per_s": s.decode_tps,
               "decode_step_ms": s.decode_s / 31 * 1e3, "launches": counts}
    log(f"[{tag}] Engine.generate: 4 requests x {prompt_len}-token prompts, 128 new tokens in "
        f"{wall:.2f} s; "
        f"prefill {s.prefill_tps:.1f} tok/s ({s.prefill_s:.2f} s), decode "
        f"{s.decode_tps:.1f} tok/s ({summary['decode_step_ms']:.1f} ms a 4-row step)")
    if profile:
        caches = [T.prefill(eng.params, cfg, eng.embed(np.asarray(p)[None]), eng.max_seq,
                            eng.dispatch)[1] for p in prompts]
        state = {"cache": E._concat_caches(caches)}
        embeds = eng.embed(np.asarray([[p[-1]] for p in prompts]))

        def step():
            _, state["cache"] = T.decode_step(eng.params, cfg, embeds, state["cache"],
                                              eng.dispatch)
        summary["profile"] = profile_steps(f"{cfg.name} Engine.generate decode step, 4 rows",
                                           step)
    summary["kernel_vs_plain"] = compare_paths(f"{cfg.name} Engine.generate", eng,
                                               steps or prefill_then_decode, prompts[0],
                                               prompts[1][0])
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
# new tokens of the sharing run and its all-DRAM reference (past the shared
# prefix a row's pages turn cold only this late), and of the runs with
# sharing off, whose rows outgrow the pool at once
SPILL_NEW = 64
SPILL_WAVES_NEW = 32
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


@timed("traces")
def drive_spill(loop, specs, per_step: bool = False, max_new: int = SPILL_NEW):
    """All requests submitted at step 0 (greedy, ``max_new`` tokens), then
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
    sp = SM.SamplingParams(temperature=0.0, max_new_tokens=max_new)
    reqs = [E.Request(uid=i, prompt_tokens=p, max_new_tokens=max_new, sampling=sp)
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
    assert all(r.done and len(r.generated) == max_new for r in reqs), "unfinished requests"
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


def spill_runs(eng, label: str, make_loop_of, specs, want, plan, spies=None):
    """The oversubscribed runs of ``[spill]``: for each (name, loop keyword
    arguments, requests, new tokens) of ``plan`` (sharing on, sharing off,
    sharing off with queue patience), a fresh eager loop ``make_loop_of(**kw)``
    serves the first requests of ``specs``; every request's greedy tokens
    must equal the head of ``want`` (an all-DRAM loop's), the staging reserve
    come back whole and nothing stay on Flash.  Then the sharing run spilled
    cold pages, the no-sharing run decoded in 2+ waves and the patience run
    preempted a row and restored it.  Returns (records, tokens) by name."""
    import contextlib
    from repro_torch.serving import engine as E
    runs, tokens = {}, {}
    for name, kw, n, new in plan:
        loop = make_loop_of(**kw)
        eng.stats = E.EngineStats()
        t0 = time.perf_counter()
        with spies if spies is not None else contextlib.nullcontext():
            got, _, waves = drive_spill(loop, specs[:n], max_new=new)
        wall = time.perf_counter() - t0
        s = eng.stats
        differ = [i for i in range(n) if got[i] != want[i][:new]]
        assert not differ, f"{label} {name}: greedy tokens differ from all-DRAM for {differ}"
        r = {"requests": n, "new_tokens": new, "wall_s": wall,
             "num_pages": loop.geom.num_pages, "staging_pages": loop.geom.staging_pages,
             "peak_kv_pages": loop.peak_kv_pages, "cold_spilled_pages": s.cold_spilled_pages,
             "spilled_pages": s.spilled_pages, "restored_pages": s.restored_pages,
             "preemptions": s.preemptions, "max_waves": max(waves),
             "steps_with_2plus_waves": sum(w >= 2 for w in waves), "decode_steps": len(waves),
             "flash_bytes_written": loop.spill.flash.bytes_written,
             "flash_bytes_read": loop.spill.flash.bytes_read,
             "staging_hit_rate": s.flash_hit_rate, "staging_steps": len(s.flash_hit_rates),
             "tokens_equal_all_dram": True}
        assert loop.pool.staged_count == 0, loop.pool.staged_count
        assert loop.pool.staging_free == loop.geom.staging_pages, loop.pool.staging_free
        assert loop.spill.pages_on_flash == 0, loop.spill.pages_on_flash
        assert 0.0 <= r["staging_hit_rate"] <= 1.0
        log(f"{label} {name}: {n} requests ({new} new) in {wall:.2f} s, tokens equal to "
            f"all-DRAM; peak KV {r['peak_kv_pages']} pages on a {r['num_pages']}-page pool; "
            f"cold pages spilled {r['cold_spilled_pages']}; preemptions {r['preemptions']} "
            f"(pages spilled {r['spilled_pages']}, restored {r['restored_pages']}); waves max "
            f"{r['max_waves']} ({r['steps_with_2plus_waves']} of {r['decode_steps']} decode "
            f"steps 2+); Flash written {r['flash_bytes_written'] / 2**20:.1f} MiB, read "
            f"{r['flash_bytes_read'] / 2**20:.1f} MiB; staging hit rate "
            f"{r['staging_hit_rate']:.3f} over {r['staging_steps']} steps; reserve returned, "
            "nothing left on Flash")
        runs[name], tokens[name] = r, got
        loop.close()
    if "sharing" in runs:
        assert runs["sharing"]["cold_spilled_pages"] > 0, runs["sharing"]
    assert runs["no_sharing"]["max_waves"] >= 2, runs["no_sharing"]
    assert runs["patience"]["preemptions"] >= 1 and runs["patience"]["restored_pages"] > 0
    return runs, tokens


def phase_spill(eng) -> dict:
    """The Flash tier on full-width qwen2-7b: an ``EngineLoop`` whose DRAM
    pool holds ``SPILL_POOL_PAGES`` pages (4 slots, max_seq 2048, page 128,
    the default staging reserve of 14 pages) serves the spill trace three
    times, eagerly: (1) prefix sharing on (``SPILL_NEW`` new tokens), (2)
    off, so every row's old pages may spill and decodes need several
    staging waves, (3) off with a fifth request queued and
    ``preempt_patience``, so rows are preempted to Flash and restored (2
    and 3 ``SPILL_WAVES_NEW`` tokens).  Every request's greedy tokens must equal those of an
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
    log(f"[spill] qwen2-7b: prompts {[len(p) for p in specs]}, {SPILL_NEW} new tokens "
        f"({SPILL_WAVES_NEW} with sharing off); "
        f"all-DRAM reference on graphs ({ref_pool} pages); the spill loops hold "
        f"{geom.num_pages} pages of {pb / 2**20:.2f} MiB ({geom.num_pages * pb / 2**20:.1f} "
        f"MiB) and a staging reserve of {geom.staging_pages}")
    K.reset_launch_counts()
    runs, tokens = spill_runs(eng, "[spill]", spill_loop, specs, want, (
        ("sharing", {}, 4, SPILL_NEW),
        ("no_sharing", {"prefix_sharing": False}, 4, SPILL_WAVES_NEW),
        ("patience", {"prefix_sharing": False, "preempt_patience": SPILL_PATIENCE}, 5,
         SPILL_WAVES_NEW)))
    eager_tokens = tokens["no_sharing"]
    eager_counts = K.launch_counts()
    assert runs["no_sharing"]["peak_kv_pages"] > runs["no_sharing"]["num_pages"]
    for name in LOOP_KERNELS:
        assert eager_counts[name] > 0, f"{name} never launched on the spill path: {eager_counts}"
    assert eng.dispatch.fallbacks == [], eng.dispatch.fallbacks

    loop = spill_loop(cuda_graphs=True, prefix_sharing=False)
    rep = loop.warmup()
    eng.stats = E.EngineStats()
    K.reset_launch_counts()
    got, steps, waves = drive_spill(loop, specs[:4], per_step=True, max_new=SPILL_WAVES_NEW)
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
# phase 4b: §4.1's per-layer KV spill to Flash, with layer-ahead prefetch
# ---------------------------------------------------------------------------

KVFLASH_DRAM_TOKENS = 512        # a layer's newest tokens, kept on the card
KVFLASH_BLOCK = 128              # tokens a spilled block
# 1 and 8 MiB of spilled KV a layer: either side of the paper's crossover
# (~3 MB a layer-step at qwen2-7b's compute time, bench_kv_flash.py)
KVFLASH_CONTEXTS = (1536, 8704)
KVFLASH_STEPS = 3
# the paper's Figure-2 Flash, as benchmarks/bench_kv_flash.py sets it
KVFLASH_SPEC = {"bandwidth_bytes_per_s": 1e9, "latency_s": 15e-6}


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def kv_spill_layers(cache, ctx: int, mgr, dram_tokens: int, block: int) -> dict:
    """Spill every layer's tokens [0, ctx - dram_tokens) of the one-row
    dense ``cache`` to ``mgr`` in blocks of ``block`` (int8 key codes, fp8
    values as their uint8 bits) and return the cache the card keeps: the
    key and value slots from ctx - dram_tokens on (the last ``dram_tokens``
    prompt tokens and the room to decode), and every slot's key scale and
    zero (32 B a token at 4 KV heads), which stay on the card."""
    import dataclasses
    import torch
    (stacked,), = cache["stacks"]
    cut = ctx - dram_tokens
    assert cut % block == 0 and stacked.k_q.shape[1] == 1, (cut, tuple(stacked.k_q.shape))
    for i in range(stacked.k_q.shape[0]):
        k = stacked.k_q[i, :, :cut].cpu().numpy()
        v = stacked.v[i, :, :cut].view(torch.uint8).cpu().numpy()
        for start in range(0, cut, block):
            mgr.spill(i, k[:, start:start + block], v[:, start:start + block], start)
    part = dataclasses.replace(stacked, k_q=stacked.k_q[:, :, cut:].clone(),
                               v=stacked.v[:, :, cut:].clone())
    return {"stacks": ((part,),), "pos": cache["pos"]}


def joined_history(mgr, dev, prefetch: bool):
    """``run_layers``'s ``entry`` for a spilled cache: before layer i, ask
    for layer i + 1's blocks (``prefetch``; past the last layer, the next
    step's layer 0), take layer i's (``gather``: blocking on its prefetch,
    or a synchronous read) and join them on the card ahead of the layer's
    device part, so kernel 6 reads the unspilled cache's bytes at the same
    slots."""
    import dataclasses
    import torch
    from repro_torch.core import quantization as q

    def entry(i, part):
        if prefetch:
            mgr.prefetch_async(i + 1)
        hk, hv = mgr.gather(i)
        k = torch.from_numpy(hk).to(dev)
        v = torch.from_numpy(hv).to(dev).view(q.FP8_DTYPE)
        return dataclasses.replace(part, k_q=torch.cat([k, part.k_q], 1),
                                   v=torch.cat([v, part.v], 1))
    return entry


def kvflash_context(eng, ctx: int, root: str, spec: dict, *, steps: int, dram_tokens: int,
                    block: int, seed: int = 9) -> dict:
    """One context of ``[kvflash]``: a ``ctx``-token prompt prefilled into a
    dense cache of ctx + ``block`` slots, then ``steps`` decode steps at
    position ctx (each re-writes the same slot, so every step reads the
    same bytes) unspilled, spilled without prefetch and spilled with it,
    the spilled ones under ``FlashSpec(simulate=True, **spec)`` in
    ``root``.  Asserts the spilled logits bit-equal to the unspilled, the
    hit and miss counts, the dense decode kernel's launches (on the card:
    one a layer a step) and no fallback; deletes the blocks.  Returns the
    steps' walls, Flash reads and launches, the decoded token and its
    logits."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import hybrid_storage as HS
    from repro_torch.models import transformer as T
    cfg, dev = eng.cfg, eng.device
    layers = cfg.num_layers
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, ctx)
    with spent_on("prefill"):
        first, cache = T.prefill(eng.params, cfg, eng.embed(prompt[None]), ctx + block,
                                 eng.dispatch)
        nxt = int(first[0, :cfg.vocab_size].argmax())
        emb = eng.embed(np.asarray([[nxt]], np.int64))
        pos = torch.tensor(ctx, dtype=torch.int32, device=dev)
        sync(dev)

    def steps_of(c, entry=None, before=None):
        walls, logits, launches = [], None, []
        for _ in range(steps):
            if before is not None:
                before()
            K.reset_launch_counts()
            sync(dev)
            t0 = time.perf_counter()
            _, got = run_layers(eng, emb, "decode", pos.expand(1, 1), pos, None, c, None,
                                entry=entry)
            sync(dev)
            walls.append(time.perf_counter() - t0)
            launches.append(K.launch_counts())
            assert logits is None or torch.equal(got, logits), "a step's logits moved"
            logits = got
        return walls, logits, launches

    with spent_on("traces"):
        base_walls, want, base_launches = steps_of(cache)
    flash = HS.FlashStore(root, HS.FlashSpec(simulate=True, **spec))
    mgr = HS.KVSpillManager(flash, layers, cfg.num_kv_heads, cfg.resolved_head_dim,
                            dram_budget_tokens=dram_tokens, block_tokens=block)
    try:
        with spent_on("flash"):
            part = kv_spill_layers(cache, ctx, mgr, dram_tokens, block)
            del cache
            sync(dev)
        runs, spilled_launches = {}, collections.Counter()
        with spent_on("traces"):
            for name, prefetch in (("no_prefetch", False), ("prefetch", True)):
                hits, misses = mgr.prefetch_hits, mgr.prefetch_misses
                t_read, n_read = flash.read_time_s, flash.bytes_read
                walls, got, launches = steps_of(
                    part, joined_history(mgr, dev, prefetch),
                    (lambda: mgr.prefetch_async(0)) if prefetch else None)
                runs[name] = {"walls_s": walls,
                              "kernel6_launches": [c["quant_decode_attention"]
                                                   for c in launches],
                              "hits": mgr.prefetch_hits - hits,
                              "misses": mgr.prefetch_misses - misses,
                              "read_time_s": (flash.read_time_s - t_read) / steps,
                              "bytes_read": (flash.bytes_read - n_read) / steps}
                assert torch.equal(got, want), \
                    f"[kvflash] {ctx} tokens, {name}: spilled logits differ from unspilled"
                for c in launches:
                    spilled_launches.update(c)
        spilled = mgr.spilled_tokens(0)
    finally:
        mgr.drop_all()
    left = os.listdir(root)
    assert not left, f"[kvflash] Flash files left: {left[:4]}"
    n = layers * steps
    assert (runs["prefetch"]["hits"], runs["prefetch"]["misses"]) == (n, 0), runs["prefetch"]
    assert (runs["no_prefetch"]["hits"], runs["no_prefetch"]["misses"]) == (0, n), \
        runs["no_prefetch"]
    if dev.type == "cuda":
        for launches in ([c["quant_decode_attention"] for c in base_launches],
                         runs["no_prefetch"]["kernel6_launches"],
                         runs["prefetch"]["kernel6_launches"]):
            assert launches == [layers] * steps, f"kernel 6 launches a step: {launches}"
    assert eng.dispatch.fallbacks == [], eng.dispatch.fallbacks
    med = {"unspilled": statistics.median(base_walls),
           **{k: statistics.median(r["walls_s"]) for k, r in runs.items()}}
    read = runs["prefetch"]["read_time_s"]
    hidden = 1.0 - (med["prefetch"] - med["unspilled"]) / read if read else None
    return {"context": ctx, "spilled_tokens_a_layer": spilled,
            "spilled_bytes_a_layer": spilled * cfg.num_kv_heads * cfg.resolved_head_dim * 2,
            "unspilled_walls_s": base_walls, "runs": runs, "median_wall_s": med,
            "hidden_share": hidden, "launches": dict(spilled_launches),
            "next_token": nxt, "logits": want}


@timed("kvflash")
def phase_kvflash(eng, card: str) -> dict:
    """``[kvflash]``: §4.1's decode loop over a KV cache spilled to the
    reference's Figure-2 Flash, on the full-width qwen2-7b engine, at
    ``KVFLASH_CONTEXTS`` (one row; the last ``KVFLASH_DRAM_TOKENS`` of a
    layer on the card, the rest on Flash in blocks of ``KVFLASH_BLOCK``:
    int8 key codes and fp8 values, 1 KiB a token at 4 KV heads of 128; the
    key scales and zeros, 32 B a token, stay on the card).  Then the two
    cheap checks: C5's fp16 overflow and the prequantized import through
    kernel 1."""
    import shutil
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import precision as PR
    from repro_torch.core import quantization as q
    from repro_torch.models import transformer as T
    from repro_torch.runtime import plan as RP
    dev = eng.device
    root = str(ROOT / "build" / "flash-kvflash")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out = {"card": card, "contexts": {}}
    for ctx in KVFLASH_CONTEXTS:
        r = kvflash_context(eng, ctx, root, KVFLASH_SPEC, steps=KVFLASH_STEPS,
                            dram_tokens=KVFLASH_DRAM_TOKENS, block=KVFLASH_BLOCK)
        del r["logits"]
        out["contexts"][ctx] = r
        med, runs = r["median_wall_s"], r["runs"]
        hidden = "not measured" if r["hidden_share"] is None else f"{r['hidden_share']:.3f}"
        log(f"[kvflash] {ctx} tokens ({r['spilled_tokens_a_layer']} a layer on Flash, "
            f"{r['spilled_bytes_a_layer'] / 2**20:.2f} MiB): decode step wall (median of "
            f"{KVFLASH_STEPS}) unspilled {1e3 * med['unspilled']:.2f} ms, spilled without "
            f"prefetch {1e3 * med['no_prefetch']:.2f} ms, with prefetch "
            f"{1e3 * med['prefetch']:.2f} ms; Flash read time a step "
            f"{1e3 * runs['prefetch']['read_time_s']:.2f} ms for "
            f"{runs['prefetch']['bytes_read'] / 2**20:.2f} MiB; hidden share {hidden}"
            f"; logits bit-equal, prefetch hit rate 1.0, kernel 6 {eng.cfg.num_layers} "
            f"launches a step ({card})")
        for name in ("no_prefetch", "prefetch"):
            log(f"[kvflash]   {ctx} tokens, {name}: step walls "
                f"{[round(1e3 * w, 2) for w in runs[name]['walls_s']]} ms "
                f"(unspilled {[round(1e3 * w, 2) for w in r['unspilled_walls_s']]})")
    shutil.rmtree(root)
    out["launches"] = {k: sum(r["launches"][k] for r in out["contexts"].values())
                       for k in out["contexts"][KVFLASH_CONTEXTS[0]]["launches"]}
    # C5: the paper's fp16 overflow, on the card (tests/test_precision.py's inputs)
    x = torch.full((1, 2, 256), 40.0, device=dev)
    unsafe = PR.attention_scores(x, x, 256, PR.UNSAFE_FP16_POLICY)
    safe = PR.attention_scores(x, x, 256, PR.PrecisionPolicy(
        compute_dtype=torch.float16, accum_dtype=torch.float16,
        softmax_dtype=torch.float32, prescale_query=True))
    assert unsafe.dtype == torch.float16 and bool(torch.isinf(unsafe).any())
    assert not bool(torch.isinf(safe).any()), safe
    out["fp16"] = {"unsafe_inf": int(torch.isinf(unsafe).sum()), "safe_max": float(safe.max())}
    # the prequantized import: numpy carriers -> load_prequantized -> kernel 1
    w = T.layer_slice(eng.params["stacks"][0][0], 0)["ffn"]["w_gate"]["w"]
    qt = RP.unpack_linear(w)
    back = RP.pack_linear(q.load_prequantized(
        qt.data.cpu().numpy(), qt.scale.cpu().numpy()[0], qt.zero.cpu().numpy()[0],
        qt.bits, qt.shape))
    back = RP.PackedLinear(back.data.to(dev), back.scale.to(dev), back.zero.to(dev),
                           back.bits, back.k, back.n)
    xs = torch.randn((4, w.k), generator=torch.Generator(device=dev).manual_seed(9),
                     device=dev).to(torch.bfloat16)
    K.reset_launch_counts()
    y0 = eng.dispatch.linear(xs, w, eng.cfg.quant)
    y1 = eng.dispatch.linear(xs, back, eng.cfg.quant)
    mm = K.launch_counts()["w4a8_matmul"]
    assert torch.equal(y0, y1), "[kvflash] the prequantized gate weight's output differs"
    assert dev.type != "cuda" or mm == 2, mm
    out["prequantized"] = {"shape": list(qt.shape), "bits": qt.bits,
                           "nbytes_logical": qt.nbytes_logical}
    log(f"[kvflash] fp16 Q.K^T at 40 x 40 x 256: {out['fp16']['unsafe_inf']} inf under "
        f"UNSAFE_FP16_POLICY, none pre-scaled (max {out['fp16']['safe_max']:.0f}); "
        f"the gate weight {list(qt.shape)} int{qt.bits} through load_prequantized -> "
        f"pack_linear -> kernel 1 at M = 4: bit-equal")
    return out


# ---------------------------------------------------------------------------
# phase 4c: glm4-9b at full width (16 query heads per KV head)
# ---------------------------------------------------------------------------

GLM4_REQUESTS = 6
GLM4_NEW = 16


def phase_glm4(dev):
    """glm4-9b (40 layers, d_model 4096, 32 heads over 2 KV heads, d_ff
    13696) from seed 0: both decode kernels at G = 16, every linear through
    ``w4a8_matmul`` (d_ff 13696: 107 column tiles of 128).  A 6-request
    trace through ``EngineLoop`` eagerly and on its CUDA graphs, a graph
    decode step profiled, one chunk and one decode step kernel vs plain,
    and ``Engine.generate`` (which also holds its prefill and decode step
    kernel vs plain).  Returns (engine, summary)."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import registry
    from repro_torch.serving import engine as E

    cfg = registry.get("glm4-9b")
    assert cfg.num_heads // cfg.num_kv_heads == 16
    t0 = time.perf_counter()
    eng = E.build_engine(cfg, seed=0, max_seq=2048, device=dev,
                         flash_dir=str(ROOT / "build" / "flash-glm4"))
    torch.cuda.synchronize()
    log(f"[glm4] glm4-9b: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads (G = 16), d_ff {cfg.d_ff}, vocab "
        f"{cfg.padded_vocab_size}; built in {time.perf_counter() - t0:.1f} s; device "
        f"memory {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    specs, arrivals = make_trace(cfg.vocab_size, requests=GLM4_REQUESTS)
    log(f"[glm4] trace: prompts {[len(p) for p in specs]}, arrivals {arrivals}; eager")
    K.reset_launch_counts()
    loop, reqs, wall = serve_trace(eng, specs, arrivals, max_new=GLM4_NEW)
    counts = K.launch_counts()
    loop.close()
    s = eng.stats
    log(f"[glm4] launches during the trace: {counts}")
    assert all(r.done and len(r.generated) == GLM4_NEW for r in reqs), "unfinished requests"
    for name in LOOP_KERNELS:
        assert counts[name] > 0, f"{name} never launched on glm4-9b's EngineLoop: {counts}"
    assert eng.dispatch.fallbacks == [], eng.dispatch.fallbacks
    new_tokens = sum(len(r.generated) for r in reqs)
    summary = {
        "wall_s": wall, "new_tokens": new_tokens, "prefill_tokens": s.prefill_tokens,
        "prefix_hits_pages": loop.pool.prefix_hits,
        "ttft_p50_ms": s.ttft(50) * 1e3, "ttft_p95_ms": s.ttft(95) * 1e3,
        "tpot_p50_ms": s.tpot(50) * 1e3, "decode_tok_per_s": s.decode_tps,
        "prefill_tok_per_s": s.prefill_tps, "launches": counts,
    }
    log(f"[glm4] {len(reqs)} requests, {new_tokens} new tokens in {wall:.2f} s; TTFT p50 "
        f"{summary['ttft_p50_ms']:.1f} ms p95 {summary['ttft_p95_ms']:.1f} ms; TPOT p50 "
        f"{summary['tpot_p50_ms']:.2f} ms; prefix pages adopted {loop.pool.prefix_hits}")
    summary["graphs"], summary["profile_graphs"] = phase_graphs(
        "glm4-9b", eng, specs, arrivals, reqs, GLM4_NEW, LOOP_KERNELS)
    prompt = next(p for p in specs if len(p) > 128)
    summary["kernel_vs_plain"] = compare_paths("glm4-9b EngineLoop", eng, chunk_then_decode,
                                               prompt, prompt[128])
    summary["generate"] = phase_generate(eng, tag="glm4")
    return eng, summary


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
    m0 = allocated_before_build(dev)
    t0 = time.perf_counter()
    eng = E.build_engine(cfg, seed=0, max_seq=1024, device=dev,
                         flash_dir=str(ROOT / "build" / "flash-moe"))
    loop = make_loop(eng)
    torch.cuda.synchronize()
    memory = predicted_vs_allocated("moonshot-v1-16b-a3b", cfg, 1024, m0, dev)
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
        loop, reqs, wall = serve_trace(eng, specs, arrivals, max_new=16, loop=loop)
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
        "dryrun_memory": memory,
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
    summary["graphs"], summary["profile_graphs"] = phase_graphs(
        "moonshot-v1-16b-a3b", eng, specs, arrivals, reqs, 16, MOE_KERNELS, spies=graph_spy,
        roofline=True)
    log(f"[graphs] moonshot-v1-16b-a3b: at warmup {graph_spy}")
    graph_spy.check()
    per_graph = summary["graphs"]["graph_launches"]
    assert all(v.get("grouped_matmul", 0) > 0 for v in per_graph.values()), per_graph
    summary["graphs"]["grouped_matmul_by_branch_at_warmup"] = graph_spy.by_branch
    summary["graphs"]["grouped_matmul_by_table_at_warmup"] = graph_spy.tables
    summary["profile"] = profile_loop_decode(eng, specs)
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
# the later parts, each on its phase's engine: (ring slots, prompt lengths,
# new tokens, seed).  With R of C groups a decode step installs 2 * (C - R)
# groups (R < C / 2: all C), so gemma3-27b (10 groups of ~0.9 GB) reads ~1.8
# GB a step through 9 slots and rwkv6-7b (32 groups of ~0.14 GB) ~2.2 GB
# through 24; qwen2-1.5b's 28 groups of ~30 MB all install, ~0.8 GB
WSTREAM_GEMMA = (9, [1100, 64, 300, 170], 8, 7)     # the 1100-token prompt wraps a ring
WSTREAM_RWKV = (24, [300, 64, 200, 100], 8, 8)
WSTREAM_QUANTVAR = (7, [400, 64, 300, 170], 8, 9)


def wstream_trace(vocab: int, lens, seed: int):
    """Prompts of ``lens`` tokens; the first and third open with one
    256-token prefix where they are that long."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(1, vocab, 256)]
    return [shared + [int(t) for t in rng.integers(1, vocab, n - 256)]
            if i in (0, 2) and n > 256 else [int(t) for t in rng.integers(1, vocab, n)]
            for i, n in enumerate(lens)]


@timed("traces")
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
                  seed: int, spies=None, kernels=None, idle_kernels=(),
                  float_path: bool = False, warmup: bool = True) -> dict:
    """One part of ``[wstream]``: ``holder`` hands over the resident engine
    (its caller keeps no other reference).  An all-resident eager loop
    serves the trace; then a streamed engine is built from the same
    parameters under a budget of the head, ``ring_slots`` groups of stack 0
    and every later stack (resident), the resident engine is released, and
    the streamed loop (asked for CUDA graphs, which the streaming gate turns
    off; with ``warmup``, a dense model's loop warms up and must capture
    none) serves the trace again: its greedy tokens must equal the resident
    run's, the stack's device memory must be freed, every kernel of the
    path (``kernels``; by default the dense or MoE loop's) must launch,
    ``idle_kernels`` never, the float path exactly when ``float_path``, and
    nothing fall back.  Both loops decode the max_slots batch (the streamed
    step always does; the resident loop is not bucketed), so a float path's
    sums see the same row count.  A windowed or recurrent model keeps
    prefix sharing and bucketing off.  The Flash blobs are deleted at the
    end.  Every rate here reads blobs the host has just written: page-cache
    reads."""
    import shutil
    import torch
    from repro_torch import kernels as K
    from repro_torch.runtime import plan as RP
    from repro_torch.serving import engine as E
    eng = holder.pop()
    cfg = eng.cfg
    moe = bool(cfg.num_experts)
    kernels = kernels or (MOE_KERNELS if moe else LOOP_KERNELS)
    full_attn = all(pat.kind == "attn" and not pat.window
                    for pats, _ in cfg.layer_plan() for pat in pats)
    specs = wstream_trace(cfg.vocab_size, lens, seed)
    eng.stats = E.EngineStats()
    loop, reqs, res_wall = serve_trace(eng, specs, [0] * len(specs), max_new=max_new,
                                       loop=make_loop(eng, bucketing=False))
    want = [r.generated for r in reqs]
    res = {"wall_s": res_wall, "decode_tok_per_s": eng.stats.decode_tps,
           "prefill_tok_per_s": eng.stats.prefill_tps}
    loop.close()
    del loop, reqs
    gc.collect()

    full = RP.weight_stream_policy(cfg, eng.params)
    count = cfg.layer_plan()[0][1]
    stack_bytes = RP._tree_nbytes(eng.params["stacks"][0])
    group_bytes = -(-stack_bytes // count)
    rest = full.resident_bytes - full.head_bytes - stack_bytes
    budget = full.head_bytes + ring_slots * group_bytes + rest
    root = eng.embedding.flash.root
    free = shutil.disk_usage(root).free
    log(f"[wstream] {label}: stack 0 is {count} groups of {group_bytes / 1e6:.2f} MB "
        f"({stack_bytes / 1e9:.2f} GB; later stacks {rest / 1e6:.1f} MB, head "
        f"{full.head_bytes / 1e6:.1f} MB); budget head + {ring_slots} groups + later "
        f"stacks; Flash directory has {free / 1e9:.1f} GB free; all-resident eager run "
        f"{res_wall:.2f} s")
    assert free > 1.1 * stack_bytes, "no room on Flash"
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
    assert spl.stack == 0 and spl.ring_groups == ring_slots, pol
    assert bool(spl.experts) == moe, pol
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
    assert full_attn or "prefix_sharing" in loop.disabled_features, loop.disabled_features
    rep = None
    if warmup and not moe:
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
    counts = K.counts()
    s = streamed.stats
    differ = [i for i in range(len(specs)) if run["tokens"][i] != want[i]]
    assert not differ, f"[wstream] {label}: greedy tokens differ from all-resident for {differ}"
    for name in kernels:
        assert counts[name] > 0, f"{name} never launched on the streamed path: {counts}"
    for name in idle_kernels:
        assert counts[name] == 0, f"{name} launched on the streamed path: {counts}"
    assert (counts["float_matmul"] > 0) == float_path, counts
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


# ---------------------------------------------------------------------------
# phase 7: sliding-window attention and the gelu FFN (gemma3-27b), and the
# largest dense and MoE configs (qwen1.5-110b, grok-1-314b)
# ---------------------------------------------------------------------------

GEMMA_NEW = 16
GEMMA_GENERATE_PROMPT = 1152     # past the 1024-token window: the dense rings wrap
BIG_NEW = 8
GROK_LAYERS = 16                 # of 64: see phase_grok


def free_engine(label: str, holder: list) -> None:
    """Drop the last reference to an engine and give its memory back."""
    import torch
    holder.clear()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[{label}] engine released: device memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, reserved "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")


def engine_line(label: str, cfg, t0: float, dev, extra: str = "") -> None:
    import torch
    torch.cuda.synchronize()
    log(f"[{label}] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff} ({cfg.act}), vocab "
        f"{cfg.padded_vocab_size}{extra}; weights + Flash embedding built in "
        f"{time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")


def loop_summary(label: str, loop, reqs, wall: float, eng, counts) -> dict:
    s = eng.stats
    new_tokens = sum(len(r.generated) for r in reqs)
    out = {"wall_s": wall, "new_tokens": new_tokens, "prefill_tokens": s.prefill_tokens,
           "prefill_chunks": s.prefill_chunks,
           "ttft_p50_ms": s.ttft(50) * 1e3, "ttft_p95_ms": s.ttft(95) * 1e3,
           "tpot_p50_ms": s.tpot(50) * 1e3, "decode_tok_per_s": s.decode_tps,
           "prefill_tok_per_s": s.prefill_tps, "launches": counts,
           "disabled_features": dict(loop.disabled_features)}
    log(f"[{label}] {len(reqs)} requests, {new_tokens} new tokens in {wall:.2f} s; TTFT "
        f"p50 {out['ttft_p50_ms']:.1f} ms p95 {out['ttft_p95_ms']:.1f} ms; TPOT p50 "
        f"{out['tpot_p50_ms']:.2f} ms; decode {s.decode_tps:.1f} tok/s; prefill "
        f"{s.prefill_tps:.1f} tok/s in {s.prefill_chunks} chunks")
    return out


class WindowSpies:
    """While entered: the decode kernels' launches by what they read --
    kernel 2 over windowed ring views and over the global pool's table,
    kernel 6 over windowed rings (and how many of those calls found the ring
    wrapped: more tokens than slots) and over full caches -- and the least
    and greatest ring base met, kept on the device (no host wait) and read
    by ``check``."""

    def __init__(self):
        self.paged = {"ring": 0, "global": 0}
        self.dense = {"ring": 0, "full": 0}
        self._wrapped = None
        self._bases = None

    def __enter__(self):
        import torch
        from repro_torch.kernels import quant_attention as QA
        from repro_torch.runtime import dispatch as D
        self._orig = orig = (D.Dispatcher.paged_decode_attention,
                             D.Dispatcher.decode_attention)

        def paged(disp, qh, pool, table, pos, policy, base=None):
            before = QA.paged_quant_decode_attention.launches
            out = orig[0](disp, qh, pool, table, pos, policy, base=base)
            n = QA.paged_quant_decode_attention.launches - before
            self.paged["ring" if pool.window else "global"] += n
            if pool.window and n and not torch.cuda.is_current_stream_capturing():
                mm = torch.stack([base.min(), base.max()]).to(torch.int64)
                self._bases = mm if self._bases is None else torch.stack(
                    [torch.minimum(self._bases[0], mm[0]), torch.maximum(self._bases[1], mm[1])])
            return out

        def dense(disp, qh, cache, pos, policy):
            before = QA.quant_decode_attention.launches
            out = orig[1](disp, qh, cache, pos, policy)
            n = QA.quant_decode_attention.launches - before
            self.dense["ring" if cache.window else "full"] += n
            if cache.window and n and not torch.cuda.is_current_stream_capturing():
                w = (torch.as_tensor(pos, device=qh.device).max() > cache.max_seq).to(torch.int64)
                self._wrapped = w if self._wrapped is None else self._wrapped + w
            return out

        D.Dispatcher.paged_decode_attention = paged
        D.Dispatcher.decode_attention = dense
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.runtime import dispatch as D
        D.Dispatcher.paged_decode_attention, D.Dispatcher.decode_attention = self._orig

    @property
    def bases(self):
        return None if self._bases is None else [int(b) for b in self._bases.tolist()]

    @property
    def wrapped(self) -> int:
        return 0 if self._wrapped is None else int(self._wrapped)

    def __str__(self) -> str:
        return (f"paged decode kernel by pool {self.paged}, ring bases {self.bases}; dense "
                f"decode kernel by cache {self.dense}, over a wrapped ring {self.wrapped}")


def gemma_trace(vocab: int, seed: int = 8):
    """Six prompts, two of them longer than the 1024-token window (so rings
    recycle during chunked prefill and during decode), arriving over seven
    steps: long prompts are still mid-prefill while earlier rows decode."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = [1480, 96, 1130, 300, 64, 700]
    return ([[int(t) for t in rng.integers(1, vocab, n)] for n in lens],
            [0, 0, 1, 2, 4, 7])


def window_steps(eng, fill_to: int = 1152):
    """``compare_paths``' steps for a windowed model past its window: row 0
    of a 4-slot pool is filled to ``fill_to`` tokens once, through the
    served chunk step on the kernel path, and its pools snapshotted; each
    call restores them, then runs one 128-token chunk at [fill_to, fill_to
    + 128) and the decode step after it layer by layer (every ring has
    recycled pages by then)."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as E
    dev = eng.device
    loop = E.EngineLoop(eng, max_slots=4, prefill_chunk=128)
    loop.pool.alloc_row(0, fill_to + 129)
    cache = loop.cache
    cache["table"] = torch.as_tensor(loop.pool.table, device=dev)
    rng = np.random.default_rng(12)
    ids = rng.integers(1, eng.cfg.vocab_size, fill_to + 129)
    for p0 in range(0, fill_to, 128):
        T.prefill_chunk_paged(eng.params, eng.cfg, eng.embed(ids[None, p0:p0 + 128]), cache,
                              0, p0, 127, eng.dispatch)
    tensors = [getattr(p, f) for st in cache["stacks"] for p in st
               for f in ("k_q", "k_scale", "k_zero", "v")]
    snap = [t.clone() for t in tensors]
    loop.close()

    def steps(engine, prompt, nxt, feed=None):
        for t, s_ in zip(tensors, snap):
            t.copy_(s_)
        chunk = run_layers(engine, engine.embed(ids[None, fill_to:fill_to + 128]),
                           "prefill_paged",
                           torch.arange(fill_to, fill_to + 128, device=dev)[None], fill_to,
                           cache["table"][0], cache,
                           None if feed is None else feed["chunk"][0], slot=0,
                           valid_len=128)
        pos = torch.tensor([fill_to + 128], dtype=torch.int32, device=dev)
        dec = run_layers(engine, engine.embed(ids[None, fill_to + 128:fill_to + 129].T),
                         "decode", pos[:, None], pos, cache["table"][:1], cache,
                         None if feed is None else feed["decode"][0])
        return {"chunk": chunk, "decode": dec}
    return steps


def phase_window_kernels(dev, cfg, results: dict) -> dict:
    """The decode and prefill attention kernels at gemma3-27b's windowed
    shapes (H = 32 over 16 KV heads, D = 128, window 1024, pages of 128):
    kernel 2 over 9-page ring views with negative and positive bases,
    kernel 6 over a full 1024-slot dense ring, kernel 7 over a 1152-token
    prompt with the window; each against its plain version, timed with its
    bound and SDPA.  Then the windowed chunk attention, which has no TPU
    kernel and runs as plain PyTorch on the card: its time a call, eager
    and replayed in a CUDA graph, beside its bound and SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import kv_cache as KV
    from repro_torch.core import kv_pool as KP
    from repro_torch.core import quantization as Q
    from repro_torch.kernels import flash_prefill as FP
    from repro_torch.kernels import quant_attention as QA
    gen = torch.Generator(device=dev).manual_seed(77)
    W, H, Hkv, D, ps, B = 1024, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, 128, 4
    G = H // Hkv
    ppw = KP.pages_per_window(W, ps)
    out = {}

    def sdpa(q4, k, v, mask):
        return library_time(lambda a, b, c, m: F.scaled_dot_product_attention(
            a, b, c, attn_mask=m, scale=1.0),
            [(q4, k.transpose(1, 2).repeat_interleave(G, dim=1),
              v.transpose(1, 2).repeat_interleave(G, dim=1), mask)])

    # kernel 2 over ring views: (B+1) rings of 9 pages, as the served pool
    rows = []
    for lengths in ([700, 300, 1000, 64], [1500, 1300, 1153, 2000]):
        pools = [KP.PagedLayerKV(*make_pool((B + 1) * ppw, ps, Hkv, D, gen, dev), window=W,
                                 ppw=ppw) for _ in range(4)]
        length = torch.tensor(lengths, dtype=torch.int32, device=dev)
        table, base = KP.ring_view(pools[0], length, B)
        q = (torch.randn((B, H, D), generator=gen, device=dev) / math.sqrt(D)).to(torch.bfloat16)
        fields = lambda p: (p.k_q, p.k_scale, p.k_zero, p.v)
        args = (q, *fields(pools[0]), table, base, length)
        err = check_close("paged_quant_decode_attention",
                          QA.paged_quant_decode_attention(*args, window=W),
                          QA.paged_quant_decode_attention_plain(*args, window=W),
                          f"ring view lengths={lengths} bases={base.tolist()}")
        sets = [(q, *fields(p), table, base, length) for p in pools]
        ms = time_ms(lambda *a: QA.paged_quant_decode_attention(*a, window=W), sets)
        gms = graph_ms(lambda *a: QA.paged_quant_decode_attention(*a, window=W), sets)
        plain_ms = time_ms(lambda *a: QA.paged_quant_decode_attention_plain(*a, window=W),
                           [args], iters=5)
        k, v = gather_dense(fields(pools[0]), table, torch.bfloat16)
        kpos = base[:, None].long() * ps + torch.arange(ppw * ps, device=dev)[None]
        live_mask = (kpos >= 0) & (kpos < length[:, None]) & (kpos >= length[:, None] - W)
        lib_ms, lib_gms = sdpa(q[:, :, None], k, v, live_mask[:, None, None, :])
        live = sum(min(n, W) for n in lengths)
        b = bound(q.numel() * 2 + live * Hkv * (2 * D + 8) + B * H * D * 4 + 8 * B * (ppw + 1),
                  4 * live * H * D, BF16_FLOPS_PER_S)
        splits = QA.decode_splits(B, Hkv * QA.head_tiles(G), ppw)
        row = dict(err=err, ms=ms, graph_ms=gms, plain_ms=plain_ms, library_ms=lib_ms,
                   library_graph_ms=lib_gms, bound=b, splits=splits,
                   head_tiles=QA.head_tiles(G), bases=base.tolist(),
                   shape=f"B={B} H={H} Hkv={Hkv} D={D} page={ps} ring of {ppw} pages, "
                         f"window {W}, lengths={lengths} (gemma3-27b local decode)")
        rows.append(row)
        results["paged_quant_decode_attention"]["all_shapes"].append(row)
        results["paged_quant_decode_attention"]["err"] = max(
            results["paged_quant_decode_attention"]["err"], err)
        log(f"[kernels] paged_quant_decode_attention ring view G={G} lengths={lengths} "
            f"bases {base.tolist()}: {splits} splits; {ms:.4f} ms a call, {f4(gms)} ms on "
            f"the device, bound {b[0]:.5f} ms ({b[1]}); plain {plain_ms:.4f} ms; SDPA "
            f"{f4(lib_ms)} ms a call, {f4(lib_gms)} ms on the device; max abs err {err:.3e}")
        del pools, k, v
    out["ring_decode"] = rows

    # kernel 6 over a full dense ring (Engine.generate's local layers after a
    # 1152-token prompt): min(pos, 1024) = 1024 live slots
    caches = []
    for _ in range(4):
        k = torch.randn((B, W, Hkv, D), generator=gen, device=dev)
        v = torch.randn((B, W, Hkv, D), generator=gen, device=dev)
        kq, ks, kz = KV.quantize_keys(k.to(torch.bfloat16))
        caches.append((kq, ks, kz, KV.cast_values(v, Q.FP8_DTYPE)))
    q = (torch.randn((B, H, D), generator=gen, device=dev) / math.sqrt(D)).to(torch.bfloat16)
    length = torch.tensor(min(GEMMA_GENERATE_PROMPT + 1, W), dtype=torch.int32, device=dev)
    args = (q, *caches[0], length)
    err = check_close("quant_decode_attention", QA.quant_decode_attention(*args),
                      QA.quant_decode_attention_plain(*args), f"full ring of {W} slots")
    sets = [(q, *c, length) for c in caches]
    ms, gms = time_ms(QA.quant_decode_attention, sets), graph_ms(QA.quant_decode_attention, sets)
    plain_ms = time_ms(QA.quant_decode_attention_plain, [args], iters=5)
    kd = KV.dequantize_keys(*caches[0][:3])
    lib_ms, lib_gms = sdpa(q[:, :, None], kd, caches[0][3].to(torch.bfloat16), None)
    b = bound(q.numel() * 2 + B * W * Hkv * (2 * D + 8) + B * H * D * 4,
              4 * B * W * H * D, BF16_FLOPS_PER_S)
    row = dict(err=err, ms=ms, graph_ms=gms, plain_ms=plain_ms, library_ms=lib_ms,
               library_graph_ms=lib_gms, bound=b,
               splits=QA.decode_splits(B, Hkv * QA.head_tiles(G), W // QA.DENSE_BLOCK),
               shape=f"B={B} H={H} Hkv={Hkv} D={D} ring S={W} full (length {W}; "
                     "gemma3-27b Engine.generate local decode)")
    results["quant_decode_attention"]["all_shapes"].append(row)
    results["quant_decode_attention"]["err"] = max(results["quant_decode_attention"]["err"], err)
    out["ring_dense_decode"] = row
    log(f"[kernels] quant_decode_attention full ring S={W} G={G}: {ms:.4f} ms a call, "
        f"{f4(gms)} ms on the device, bound {b[0]:.5f} ms ({b[1]}); plain {plain_ms:.4f} ms; "
        f"SDPA {f4(lib_ms)} ms a call, {f4(lib_gms)} ms on the device; max abs err {err:.3e}")
    del caches, kd

    # kernel 7: a 1152-token prompt over its own round-tripped K/V, window 1024
    T_ = GEMMA_GENERATE_PROMPT
    q = (torch.randn((1, T_, H, D), generator=gen, device=dev) / math.sqrt(D)).to(torch.bfloat16)
    k = torch.randn((1, T_, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((1, T_, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
    kw = dict(causal=True, window=W)
    err = check_close("flash_prefill_attention", FP.flash_prefill_attention(q, k, v, **kw),
                      FP.flash_prefill_attention_plain(q, k, v, **kw), f"T={T_} window={W}")
    ms = time_ms(lambda *a: FP.flash_prefill_attention(*a, **kw), [(q, k, v)])
    gms = graph_ms(lambda *a: FP.flash_prefill_attention(*a, **kw), [(q, k, v)])
    plain_ms = time_ms(lambda *a: FP.flash_prefill_attention_plain(*a, **kw), [(q, k, v)],
                       iters=3)
    qpos = torch.arange(T_, device=dev)
    mask = ((qpos[None] <= qpos[:, None]) & (qpos[:, None] - qpos[None] < W))[None, None]
    lib_ms, lib_gms = sdpa(q.transpose(1, 2), k, v, mask)
    pairs = sum(min(i + 1, W) for i in range(T_))
    b = bound(q.numel() * 2 + 2 * T_ * Hkv * D * 2 + T_ * H * D * 4, 4 * H * D * pairs,
              BF16_FLOPS_PER_S)
    row = dict(err=err, ms=ms, graph_ms=gms, plain_ms=plain_ms, library_ms=lib_ms,
               library_graph_ms=lib_gms, bound=b,
               shape=f"B=1 T={T_} S={T_} H={H} Hkv={Hkv} D={D} causal, window {W} "
                     "(gemma3-27b Engine.generate local prefill)")
    results["flash_prefill_attention"].setdefault("all_shapes", []).append(row)
    results["flash_prefill_attention"]["err"] = max(results["flash_prefill_attention"]["err"],
                                                    err)
    out["window_prefill"] = row
    log(f"[kernels] flash_prefill_attention T={T_} window={W} G={G}: {ms:.4f} ms a call, "
        f"{f4(gms)} ms on the device, bound {b[0]:.4f} ms ({b[1]}); plain {plain_ms:.4f} ms; "
        f"SDPA {f4(lib_ms)} ms a call, {f4(lib_gms)} ms on the device; max abs err {err:.3e}")
    del q, k, v, mask

    # the windowed chunk (no TPU kernel; plain PyTorch on the card): a
    # 128-token chunk at [1152, 1280) over row 0's ring, 16 logical pages
    pool = KP.PagedLayerKV(*make_pool((B + 1) * ppw, ps, Hkv, D, gen, dev), window=W, ppw=ppw)
    q = (torch.randn((1, 128, H, D), generator=gen, device=dev) / math.sqrt(D)).to(torch.bfloat16)
    scal = [torch.tensor([x], dtype=torch.int32, device=dev) for x in (0, 1152, 128)]
    fn = lambda *a: KP.paged_prefill_window_ref(*a, W, 16)
    ms = time_ms(fn, [(q, pool, *scal)], iters=10)
    gms = graph_ms(fn, [(q, pool, *scal)], iters=5)
    pairs = sum(min(1152 + i + 1, W) for i in range(128))
    b = bound(q.numel() * 2 + ppw * ps * Hkv * (2 * D + 8) + 128 * H * D * 2,
              4 * H * D * pairs, BF16_FLOPS_PER_S)
    # the yardstick: SDPA over the row's ring dequantized in logical order
    # (positions 128-1279), the window and causal mask on each query
    table, base = KP.ring_view(pool, torch.tensor([1280], dtype=torch.int32, device=dev), 1)
    k, v = gather_dense((pool.k_q, pool.k_scale, pool.k_zero, pool.v), table, torch.bfloat16)
    kpos = base.long() * ps + torch.arange(ppw * ps, device=dev)
    qpos = 1152 + torch.arange(128, device=dev)
    mask = (kpos[None] <= qpos[:, None]) & (qpos[:, None] - kpos[None] < W)
    lib_ms, lib_gms = sdpa(q.transpose(1, 2), k, v, mask[None, None])
    del k, v, mask
    out["window_chunk_plain"] = {"ms": ms, "graph_ms": gms, "bound_ms": b[0], "bound_by": b[1],
                                 "library_ms": lib_ms, "library_graph_ms": lib_gms,
                                 "calls_per_chunk": sum(
                                     n for pats, n in cfg.layer_plan() for p in pats
                                     if p.window),
                                 "shape": f"C=128 pos0=1152 H={H} Hkv={Hkv} D={D} ring of "
                                          f"{ppw} pages, window {W}, view of 16 pages"}
    log(f"[kernels] windowed chunk attention (kv_pool.paged_prefill_window_ref, plain "
        f"PyTorch: no TPU kernel) C=128 pos0=1152: {ms:.4f} ms a call, {f4(gms)} ms on the "
        f"device (a CUDA graph), bound {b[0]:.4f} ms ({b[1]}); SDPA over the dequantized "
        f"ring with a window mask {f4(lib_ms)} ms a call, {f4(lib_gms)} ms on the device")
    del pool, q
    torch.cuda.synchronize()
    return out


def phase_gemma3(dev, results: dict):
    """gemma3-27b at full width and depth (62 layers: ten periods of five
    window-1024 layers and a global one, then two window layers; d_model
    5376, 32/16 heads, gelu FFN of 21504, vocab 262144) from seed 0.  Its
    windowed kernel shapes first; then a 6-request trace, two prompts past
    the window, through ``EngineLoop`` eagerly and on its CUDA graphs
    (prefix sharing and decode bucketing off, as in the reference), a graph
    decode step profiled, one chunk and one decode step past the window
    kernel vs plain, and ``Engine.generate`` at 4 x 1152 tokens (the dense
    rings wrap).  Returns (engine holder, summary)."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_prefill as FP
    from repro_torch.serving import engine as E

    cfg = registry.get("gemma3-27b")
    n_global = sum(n for pats, n in cfg.layer_plan() for p in pats if not p.window)
    n_local = cfg.num_layers - n_global
    summary = {"window_kernels": phase_window_kernels(dev, cfg, results)}
    t0 = time.perf_counter()
    eng = E.build_engine(cfg, seed=0, max_seq=2048, device=dev,
                         flash_dir=str(ROOT / "build" / "flash-gemma3"))
    engine_line("gemma3", cfg, t0, dev, f"; {n_local} window-{cfg.period[0].window} layers, "
                f"{n_global} global")
    specs, arrivals = gemma_trace(cfg.vocab_size)
    log(f"[gemma3] trace: prompts {[len(p) for p in specs]}, arrivals {arrivals}; eager")
    spy = WindowSpies()
    with spy:
        K.reset_launch_counts()
        loop, reqs, wall = serve_trace(eng, specs, arrivals, max_new=GEMMA_NEW)
        counts = K.launch_counts()
    loop.close()
    log(f"[gemma3] launches during the trace: {counts}; {spy}")
    assert all(r.done and len(r.generated) == GEMMA_NEW for r in reqs), "unfinished requests"
    for name in LOOP_KERNELS:
        assert counts[name] > 0, f"{name} never launched on gemma3's EngineLoop: {counts}"
    assert {"prefix_sharing", "decode_bucketing"} <= set(loop.disabled_features), \
        loop.disabled_features
    assert loop.prefill_chunk == 128 and loop.buckets == (4,), (loop.prefill_chunk, loop.buckets)
    # kernel 3 on the global layers only; kernel 2 on both pool kinds, ring
    # views with negative and positive bases
    assert counts["paged_flash_prefill_attention"] == eng.stats.prefill_chunks * n_global, \
        (counts, eng.stats.prefill_chunks)
    assert spy.paged["ring"] == spy.paged["global"] * n_local // n_global > 0, spy.paged
    assert spy.bases[0] < 0 < spy.bases[1], spy.bases
    assert eng.dispatch.fallbacks == [], eng.dispatch.fallbacks
    summary.update(loop_summary("gemma3", loop, reqs, wall, eng, counts))
    summary["decode_kernel_by_pool"] = dict(spy.paged)
    summary["ring_bases"] = spy.bases
    summary["graphs"], summary["profile_graphs"] = phase_graphs(
        "gemma3-27b", eng, specs, arrivals, reqs, GEMMA_NEW, LOOP_KERNELS)
    summary["kernel_vs_plain"] = compare_paths("gemma3-27b EngineLoop past the window", eng,
                                               window_steps(eng), None, None)
    gspy = WindowSpies()
    with gspy:
        summary["generate"] = phase_generate(eng, tag="gemma3",
                                             prompt_len=GEMMA_GENERATE_PROMPT)
    log(f"[gemma3] Engine.generate: {gspy}")
    assert gspy.dense["ring"] > 0 and gspy.wrapped == gspy.dense["ring"], str(gspy)
    assert summary["generate"]["launches"]["flash_prefill_attention"] == 4 * cfg.num_layers, \
        summary["generate"]["launches"]
    summary["generate"]["dense_decode_by_cache"] = dict(gspy.dense)
    return [eng], summary


def matmul_rows(label: str, pl, Ms, what: str, results: dict) -> list:
    """``w4a8_matmul`` on a served layer's own packed weight ``pl`` at the
    row counts ``Ms``: against the plain version, timed with its bound and
    ``torch._int_mm`` (the weight unpacked to int8, M padded to 32)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import quantization as Q
    from repro_torch.kernels import w4a8_matmul as WM
    dev = pl.data.device
    gen = torch.Generator(device=dev).manual_seed(99)
    K, N, bits = pl.k, pl.n, pl.bits
    w8 = Q.unpack_int4(pl.data).contiguous() if bits == 4 else pl.data
    rows = []
    for M in Ms:
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        xq, sx = Q.quantize_activations(x)
        args = (xq, sx, pl.data, pl.scale[0], pl.zero[0])
        err = check_close("w4a8_matmul", WM.w4a8_matmul(*args, bits=bits),
                          WM.w4a8_matmul_plain(*args, bits=bits), f"{label} {what} M={M}")
        ms = time_ms(lambda *a: WM.w4a8_matmul(*a, bits=bits), [args])
        gms = graph_ms(lambda *a: WM.w4a8_matmul(*a, bits=bits), [args])
        plain_ms = time_ms(lambda *a: WM.w4a8_matmul_plain(*a, bits=bits), [args], iters=3,
                           warmup=1)
        xi = F.pad(xq, (0, 0, 0, 32 - M)) if M <= 16 else xq
        xi = F.pad(xi, (0, w8.shape[0] - K)) if w8.shape[0] > K else xi
        lib_ms, lib_gms = library_time(torch._int_mm, [(xi, w8)])
        b = bound(xq.numel() + sx.numel() * 4 + pl.data.numel() + 2 * N * 4 + M * N * 4,
                  2 * M * K * N, INT8_OPS_PER_S)
        splits, trows = WM.matmul_splits(M, N, K), WM.tile_rows(M)
        row = {"what": f"{label} {what}", "M": M, "K": K, "N": N, "bits": bits,
               "splits": splits, "tile_rows": trows, "ms": ms, "graph_ms": gms,
               "plain_ms": plain_ms, "max_abs_err": err, "bound_ms": b[0], "bound_by": b[1],
               "library_ms": lib_ms, "library_graph_ms": lib_gms}
        rows.append(row)
        results["w4a8_matmul"]["all_shapes"].append(row)
        results["w4a8_matmul"]["err"] = max(results["w4a8_matmul"]["err"], err)
        log(f"[kernels] w4a8_matmul {label} {what} M={M:4d} K={K:5d} N={N:6d} int{bits} "
            f"({trows}-row tile, {splits} splits, {-(-M // trows) * (-(-N // 128)) * splits} "
            f"blocks): {ms:.4f} ms a call, {f4(gms)} ms on the device, bound {b[0]:.4f} ms "
            f"({b[1]}); plain {plain_ms:.4f} ms; _int_mm {f4(lib_ms)} ms a call, "
            f"{f4(lib_gms)} ms on the device; max abs err {err:.3e}")
    del w8
    return rows


def phase_big_dense(dev, results: dict):
    """qwen1.5-110b at full width and depth (80 layers, d_model 8192, 64/8
    heads, d_ff 49152, qkv bias; about 54 GB of int4 weights) from seed 0:
    ``w4a8_matmul`` at its layer 0's gate/up (N = 49152: 384 column tiles)
    and down (K = 49152) projections, then a 4-request trace through
    ``EngineLoop`` eagerly and on its graphs, a graph decode step profiled,
    one chunk and one decode step kernel vs plain.  Returns (engine holder,
    summary)."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as E

    cfg = registry.get("qwen1.5-110b")
    t0 = time.perf_counter()
    eng = E.build_engine(cfg, seed=0, max_seq=2048, device=dev,
                         flash_dir=str(ROOT / "build" / "flash-qwen110b"))
    engine_line("qwen110b", cfg, t0, dev)
    ffn = T.layer_slice(eng.params["stacks"][0][0]["ffn"], 0)
    summary = {"matmul": matmul_rows("qwen1.5-110b", ffn["w_gate"]["w"], (1, 4, 128),
                                     "gate/up", results)
               + matmul_rows("qwen1.5-110b", ffn["w_down"]["w"], (1, 4, 128), "down",
                             results)}
    specs, arrivals = make_trace(cfg.vocab_size, seed=9, requests=4)
    log(f"[qwen110b] trace: prompts {[len(p) for p in specs]}, arrivals {arrivals}; eager")
    K.reset_launch_counts()
    loop, reqs, wall = serve_trace(eng, specs, arrivals, max_new=BIG_NEW)
    counts = K.launch_counts()
    loop.close()
    log(f"[qwen110b] launches during the trace: {counts}")
    assert all(r.done and len(r.generated) == BIG_NEW for r in reqs), "unfinished requests"
    for name in LOOP_KERNELS:
        assert counts[name] > 0, f"{name} never launched on qwen1.5-110b's EngineLoop: {counts}"
    assert eng.dispatch.fallbacks == [], eng.dispatch.fallbacks
    summary.update(loop_summary("qwen110b", loop, reqs, wall, eng, counts))
    summary["graphs"], summary["profile_graphs"] = phase_graphs(
        "qwen1.5-110b", eng, specs, arrivals, reqs, BIG_NEW, LOOP_KERNELS)
    prompt = next(p for p in specs if len(p) > 128)
    summary["kernel_vs_plain"] = compare_paths("qwen1.5-110b EngineLoop", eng,
                                               chunk_then_decode, prompt, prompt[128])
    return [eng], summary


def grouped_rows(label: str, pel, results: dict, top: int = 2) -> list:
    """``grouped_matmul`` on a served layer's own expert table ``pel``:
    decode as 4 rows x top-``top`` one-row slabs named by id, and a
    128-token chunk at full capacity with the live rows a top-``top``
    routing gives; against the plain version, timed with its bound and
    bf16 bmm."""
    import torch
    from repro_torch.core import quantization as Q
    from repro_torch.kernels import grouped_matmul as GM
    from repro_torch.runtime import plan as RP
    dev = pel.data.device
    gen = torch.Generator(device=dev).manual_seed(98)
    E_ALL, K, N = pel.data.shape[0], pel.k, pel.n
    Kp, Np = pel.kp, pel.np_pad
    slab_bytes = pel.data[0].numel() + 2 * Np * 4
    rows = []
    for kind in ("decode", "prefill"):
        if kind == "decode":
            ids = torch.cat([torch.randperm(E_ALL, generator=gen, device=dev)[:top]
                             for _ in range(4)]).to(torch.int32)
            E, M, kw = ids.numel(), 1, {"ids": ids}
            x = torch.randn((E, M, K), generator=gen, device=dev).to(torch.bfloat16)
            live_rows, slabs = E, int(torch.unique(ids).numel())
        else:
            picks = torch.randn((128, E_ALL), generator=gen, device=dev).topk(top, dim=-1).indices
            counts = torch.bincount(picks.reshape(-1), minlength=E_ALL)
            E, M = E_ALL, 128
            kw = {"rows": counts.to(torch.int32)[:, None].contiguous()}
            x = torch.randn((E, M, K), generator=gen, device=dev)
            x = (x * (torch.arange(M, device=dev)[None] < counts[:, None])[..., None]).to(
                torch.bfloat16)
            live_rows, slabs = int(counts.sum()), int((counts > 0).sum())
        xq, sx = Q.quantize_activations(x)
        args = (xq, sx, pel.data, pel.scale[:, 0], pel.zero[:, 0])
        err = check_close("grouped_matmul", GM.grouped_matmul(*args, bits=pel.bits, **kw),
                          GM.grouped_matmul_plain(*args, bits=pel.bits, **kw),
                          f"{label} {kind} E={E} M={M} K={K} N={N}")
        fn = lambda *a: GM.grouped_matmul(*a, bits=pel.bits, **kw)
        ms, gms = time_ms(fn, [args]), graph_ms(fn, [args])
        plain_ms = time_ms(lambda *a: GM.grouped_matmul_plain(*a, bits=pel.bits, **kw), [args],
                           iters=3, warmup=1)
        used = RP.take_experts(pel, kw["ids"]) if "ids" in kw else pel
        wd = Q.dequantize(RP.unpack_expert_linear(used))
        lib_ms, lib_gms = library_time(torch.bmm, [(x, wd)])
        del wd, used
        b = bound(live_rows * (Kp + 4) + slabs * slab_bytes + E * M * Np * 4
                  + 4 * sum(t.numel() for t in kw.values()), 2 * live_rows * Kp * Np,
                  INT8_OPS_PER_S)
        row = {"what": f"{label} {kind}", "E": E, "M": M, "K": K, "N": N,
               "live_rows": live_rows, "slabs_read": slabs, "ms": ms, "graph_ms": gms,
               "plain_ms": plain_ms, "max_abs_err": err, "bound_ms": b[0], "bound_by": b[1],
               "library_ms": lib_ms, "library_graph_ms": lib_gms}
        rows.append(row)
        results["grouped_matmul"]["all_shapes"].append(row)
        results["grouped_matmul"]["err"] = max(results["grouped_matmul"]["err"], err)
        log(f"[kernels] grouped_matmul {label} {kind} E={E} M={M} K={K} N={N} ({live_rows} "
            f"live rows, {slabs} slabs, {sorted(kw)[0]}): {ms:.4f} ms a call, {f4(gms)} ms "
            f"on the device, bound {b[0]:.4f} ms ({b[1]}); plain {plain_ms:.4f} ms; bf16 bmm "
            f"{f4(lib_ms)} ms a call, {f4(lib_gms)} ms on the device; max abs err {err:.3e}")
        del x, xq, sx
    return rows


def phase_grok(dev, results: dict):
    """grok-1-314b at full width (d_model 6144, 48/8 heads, 8 experts top-2
    of d_ff 32768 in every layer) and 16 of its 64 layers, from seed 0.
    The depth is cut because the 64-layer int4 model (about 157 GB) does
    not fit one card, and its weight-streamed step would wait minutes a
    token on Flash.  ``grouped_matmul`` at its layer 0's expert tables
    (gate/up N = 32768, down K = 32768), then a 4-request trace through
    ``EngineLoop`` eagerly and on its graphs, both MoE dispatch branches
    launching the grouped kernel (chunks by live-row counts, decode by
    expert id), one chunk and one decode step kernel vs plain."""
    import dataclasses
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as E

    full = registry.get("grok-1-314b")
    cfg = dataclasses.replace(full, num_layers=GROK_LAYERS)
    log(f"[grok1] reduced: depth {GROK_LAYERS} of {full.num_layers} layers (every width "
        "kept): the 64-layer int4 model, about 157 GB, does not fit one 80 GB card")
    t0 = time.perf_counter()
    eng = E.build_engine(cfg, seed=0, max_seq=2048, device=dev,
                         flash_dir=str(ROOT / "build" / "flash-grok1"))
    engine_line("grok1", cfg, t0, dev, f"; {cfg.num_experts} experts top-"
                f"{cfg.experts_per_tok}")
    moe0 = T.layer_slice(eng.params["stacks"][0][0]["moe"], 0)
    summary = {"reduced": {"num_layers": [full.num_layers, GROK_LAYERS]},
               "grouped": grouped_rows("grok-1-314b gate/up", moe0["w_gate"]["w"], results)
               + grouped_rows("grok-1-314b down", moe0["w_down"]["w"], results)}
    del moe0
    specs, arrivals = make_trace(cfg.vocab_size, seed=10, requests=4)
    log(f"[grok1] trace: prompts {[len(p) for p in specs]}, arrivals {arrivals}; eager")
    spy = MoeSpies()
    with spy:
        K.reset_launch_counts()
        loop, reqs, wall = serve_trace(eng, specs, arrivals, max_new=BIG_NEW)
        counts = K.launch_counts()
    loop.close()
    log(f"[grok1] launches during the trace: {counts}; {spy}")
    assert all(r.done and len(r.generated) == BIG_NEW for r in reqs), "unfinished requests"
    for name in MOE_KERNELS:
        assert counts[name] > 0, f"{name} never launched on grok-1's EngineLoop: {counts}"
    spy.check()
    assert eng.dispatch.fallbacks == [], eng.dispatch.fallbacks
    summary.update(loop_summary("grok1", loop, reqs, wall, eng, counts))
    summary["grouped_matmul_by_branch"] = spy.by_branch
    graph_spy = MoeSpies()
    summary["graphs"], summary["profile_graphs"] = phase_graphs(
        "grok-1-314b", eng, specs, arrivals, reqs, BIG_NEW, MOE_KERNELS, spies=graph_spy)
    graph_spy.check()
    prompt = next(p for p in specs if len(p) > 128)
    summary["kernel_vs_plain"] = compare_paths("grok-1-314b EngineLoop", eng,
                                               chunk_then_decode, prompt, prompt[128])
    return [eng], summary


# ---------------------------------------------------------------------------
# phase 8: recurrent stacks (rwkv6-7b, jamba-1.5-large-398b)
# ---------------------------------------------------------------------------

RWKV_NEW = 16
JAMBA_NEW = 8
JAMBA_LAYERS = 16                # of 72: see phase_jamba
RWKV_KERNELS = ("w4a8_matmul", "rmsnorm")
PRESSURE_MAX_SEQ = 512           # pages of 128 tokens, 4 a row: a 4-page pool is one row


def recurrent_trace(vocab: int, lens, arrivals, seed: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, n)] for n in lens], list(arrivals)


def scan_rows(label: str, cfg, dev) -> dict:
    """The recurrent scan of ``cfg``'s layers, which has no TPU kernel (the
    reference computes it in XLA) and runs as plain PyTorch on the card by
    design: mamba's ``ssm.selective_scan`` (a [B, T, d_inner, d_state]
    block, T padded to the 8-token scan block) or rwkv6's ``ssm.wkv_scan``,
    at a 128-token chunk and a 4-row decode step at full width; its time a
    call and on the device (the calls replayed in a CUDA graph), beside its
    bound (f32 operations at the CUDA cores' rate).  No single PyTorch call
    computes either scan: no library time."""
    import torch
    from repro_torch.models import ssm as S
    gen = torch.Generator(device=dev).manual_seed(55)
    rows = {}
    mamba = any(p.kind == "mamba" for pats, _ in cfg.layer_plan() for p in pats)
    for what, B, T in (("chunk", 1, 128), ("decode", 4, 1)):
        if mamba:
            d, _, st = S.mamba_dims(cfg)
            Tp = -(-T // S.SCAN_BLOCK) * S.SCAN_BLOCK
            a = torch.rand((B, Tp, d, st), generator=gen, device=dev) * 0.5 + 0.5
            bx = torch.randn((B, Tp, d, st), generator=gen, device=dev)
            h0 = torch.randn((B, d, st), generator=gen, device=dev)
            fn, args, name = S.selective_scan, (a, bx, h0), "mamba selective_scan"
            # a and bx read, every h written, the entry state read
            nbytes, ops = 4 * (3 * a.numel() + h0.numel()), 3 * a.numel()
            shape = f"B={B} T={T} (scan block {Tp}) d_inner={d} d_state={st}"
        else:
            H, dh = S.rwkv_dims(cfg)
            r, k, v = (torch.randn((B, T, H, dh), generator=gen, device=dev) for _ in range(3))
            w = torch.rand((B, T, H, dh), generator=gen, device=dev) * 0.5 + 0.5
            u = torch.randn((H, dh), generator=gen, device=dev)
            s0 = torch.randn((B, H, dh, dh), generator=gen, device=dev) * 0.1
            fn, args, name = S.wkv_scan, (r, k, v, w, u, s0), "rwkv6 wkv_scan"
            # r, k, v, w read, y written, the state read and written; per token
            # and head: k v^T, u k v^T, S + u k v^T, r (.) (2 dh^2), w S + k v^T
            nbytes = 4 * (5 * r.numel() + u.numel() + 2 * s0.numel())
            ops = 7 * B * T * H * dh * dh
            shape = f"B={B} T={T} H={H} dh={dh}"
        ms = time_ms(fn, [args], iters=10)
        gms = graph_ms(fn, [args], iters=5)
        b = bound(nbytes, ops, F32_FLOPS_PER_S)
        rows[what] = {"function": name, "shape": shape, "ms": ms, "graph_ms": gms,
                      "bound_ms": b[0], "bound_by": b[1], "library_ms": None}
        log(f"[{label}] {name} (no TPU kernel: plain PyTorch on the card) {what} {shape}: "
            f"{ms:.4f} ms a call, {f4(gms)} ms on the device (a CUDA graph), bound "
            f"{b[0]:.5f} ms ({b[1]}); no library call computes it")
        del args
    torch.cuda.synchronize()
    return rows


def recurrent_pressure(eng) -> dict:
    """The KV Flash tier with recurrent state, at full width: an engine on
    the same weights at ``max_seq`` 512 (pages of 128 tokens), 2 slots, a
    4-page pool, proactive spill off, queue patience 3, and three requests
    of 100, 230 and 160 tokens.  The 230-token one is evicted once its first
    chunk is in (its pages and its rows of every recurrent state to Flash)
    and resumes from that chunk boundary; the waiting third request makes
    the loop preempt a decoding row (pages and state to Flash) and restore
    it.  Every request's greedy tokens must equal the same requests served
    without the budget, eagerly both."""
    import numpy as np
    import torch
    from repro_torch.runtime import plan as RP
    from repro_torch.serving import engine as E
    from repro_torch.serving import sampling as SM
    cfg = eng.cfg
    small = E.Engine(cfg, eng.params, eng.embedding, max_seq=PRESSURE_MAX_SEQ,
                     device=eng.device)
    pb = RP.kv_page_bytes(cfg, RP.kv_page_size(PRESSURE_MAX_SEQ))
    rng = np.random.default_rng(14)
    spec = [([int(t) for t in rng.integers(1, cfg.vocab_size, n)], m)
            for n, m in ((100, 8), (230, 4), (160, 5))]
    sp = SM.SamplingParams(temperature=0.0)

    def run(pressure: bool):
        small.stats = E.EngineStats()
        kw = dict(max_slots=2, prefill_chunk=128, prefill_token_budget=128, cuda_graphs=False)
        if pressure:
            kw.update(dram_budget_bytes=4 * pb, proactive_spill=False, preempt_patience=3)
        loop = E.EngineLoop(small, **kw)
        reqs = [E.Request(uid=i, prompt_tokens=p, max_new_tokens=m, sampling=sp)
                for i, (p, m) in enumerate(spec)]
        for r in reqs:
            loop.submit(r)
        if pressure:
            assert loop.geom.num_pages == 4, loop.geom
            victim = reqs[1]
            for _ in range(50):
                loop.step()
                st = next((s for s in loop._prefilling.values() if s["req"] is victim), None)
                if st is not None and st["next"] > 0:
                    break
            else:
                raise AssertionError("the victim never reached a chunk boundary")
            loop._spill_prefilling_row(victim)
        while loop.has_work():
            loop.step()
        torch.cuda.synchronize()
        on_flash = loop.spill.pages_on_flash
        loop.close()
        return reqs, small.stats, on_flash

    t0 = time.perf_counter()
    free, _, _ = run(False)
    pressed, stats, on_flash = run(True)
    wall = time.perf_counter() - t0
    pre = [r.preemptions for r in pressed]
    differ = [r.uid for r, f in zip(pressed, free) if r.generated != f.generated]
    out = {"preemptions": pre, "spilled_pages": stats.spilled_pages,
           "restored_pages": stats.restored_pages, "prefill_chunks": stats.prefill_chunks,
           "tokens_equal_unpressured": not differ, "wall_s": wall}
    log(f"[jamba] Flash tier with recurrent state (max_seq {PRESSURE_MAX_SEQ}, a 4-page "
        f"pool, patience 3): preemptions by request {pre}, pages spilled "
        f"{stats.spilled_pages}, restored {stats.restored_pages}, {stats.prefill_chunks} "
        f"chunks; greedy tokens equal to the unpressured run: {not differ}; {wall:.1f} s")
    assert all(r.done for r in pressed) and not differ, f"tokens differ for {differ}"
    assert pre[1] >= 1 and sum(pre) >= 2 and stats.restored_pages > 0, out
    assert on_flash == 0 and small.dispatch.fallbacks == []
    return out


def phase_recurrent(dev, label: str, cfg, specs, arrivals, max_new: int, loop_kernels,
                    generate_kernels, extra: str = "", moe: bool = False):
    """A recurrent model from seed 0 at full width: its scan's "—" rows,
    then the trace through ``EngineLoop`` eagerly (prefix sharing and decode
    bucketing off, every kernel of ``loop_kernels`` launched, on an MoE model
    both grouped branches) and on its CUDA graphs (tokens equal eager, no
    capture after warmup), a graph decode step profiled (1 sync), one chunk
    and one decode step kernel vs plain layer by layer, and
    ``Engine.generate`` at 4 x 320 (``generate_kernels`` launched).
    Returns (engine holder, summary)."""
    import contextlib
    import torch
    from repro_torch import kernels as K
    from repro_torch.serving import engine as E

    t0 = time.perf_counter()
    eng = E.build_engine(cfg, seed=0, max_seq=2048, device=dev,
                         flash_dir=str(ROOT / "build" / f"flash-{label}"))
    engine_line(label, cfg, t0, dev, extra)
    summary = {"scan": scan_rows(label, cfg, dev)}
    log(f"[{label}] trace: prompts {[len(p) for p in specs]}, arrivals {arrivals}; eager")
    spy = MoeSpies() if moe else None
    with spy if moe else contextlib.nullcontext():
        K.reset_launch_counts()
        loop, reqs, wall = serve_trace(eng, specs, arrivals, max_new=max_new)
        counts = K.launch_counts()
    loop.close()
    log(f"[{label}] launches during the trace: {counts}" + (f"; {spy}" if moe else ""))
    assert all(r.done and len(r.generated) == max_new for r in reqs), "unfinished requests"
    for name in loop_kernels:
        assert counts[name] > 0, f"{name} never launched on {cfg.name}'s EngineLoop: {counts}"
    if moe:
        spy.check()
        summary["grouped_matmul_by_branch"] = spy.by_branch
    assert set(loop.disabled_features) == {"prefix_sharing", "decode_bucketing"}, \
        loop.disabled_features
    assert eng.dispatch.fallbacks == [], eng.dispatch.fallbacks
    summary.update(loop_summary(label, loop, reqs, wall, eng, counts))
    graph_spy = MoeSpies() if moe else None
    summary["graphs"], summary["profile_graphs"] = phase_graphs(
        cfg.name, eng, specs, arrivals, reqs, max_new, loop_kernels, spies=graph_spy)
    if moe:
        graph_spy.check()
    assert summary["profile_graphs"]["syncs_per_step"] == 1, summary["profile_graphs"]
    prompt = next(p for p in specs if len(p) > 128)
    summary["kernel_vs_plain"] = compare_paths(f"{cfg.name} EngineLoop", eng, chunk_then_decode,
                                               prompt, prompt[128])
    summary["generate"] = phase_generate(eng, tag=label, kernels=generate_kernels)
    torch.cuda.synchronize()
    return [eng], summary


def phase_rwkv6(dev, results: dict):
    """rwkv6-7b at full width and depth (32 layers, d_model 4096, 64 wkv
    heads of 64, d_ff 14336, vocab 65536; ~3.5 GB of int4 weights and an
    int8 ``lm_head``), attention-free: 6 requests of 64-700 tokens (two not
    multiples of 8), 16 new, as ``phase_recurrent`` sets out; the kernels
    on its path are ``w4a8_matmul`` and ``rmsnorm``."""
    from repro_torch.configs import registry
    cfg = registry.get("rwkv6-7b")
    specs, arrivals = recurrent_trace(cfg.vocab_size, [700, 64, 301, 128, 451, 200],
                                      [0, 0, 1, 2, 4, 7], seed=11)
    return phase_recurrent(dev, "rwkv6", cfg, specs, arrivals, RWKV_NEW, RWKV_KERNELS,
                           RWKV_KERNELS, extra=f"; {cfg.num_layers} rwkv6 layers")


def phase_jamba(dev, results: dict):
    """jamba-1.5-large-398b at full width (d_model 8192, 64/8 heads, mamba
    d_inner 16384 with d_state 16 and dt_rank 512, 16 experts top-2 of d_ff
    24576 on every other layer) and 16 of its 72 layers, from seed 0: two
    periods of one attention layer and seven mamba layers.  The depth is
    cut because the 72-layer int4 model (about 199 GB) does not fit one
    card.  4 requests of 200-680 tokens, 8 new, as ``phase_recurrent`` sets
    out, with rows 1-5 on the path (kernel 2 and 3 on the two attention
    layers, both grouped branches) and rows 6 and 7 in ``Engine.generate``;
    then ``recurrent_pressure``."""
    import dataclasses
    from repro_torch.configs import registry
    full = registry.get("jamba-1.5-large-398b")
    cfg = dataclasses.replace(full, num_layers=JAMBA_LAYERS)
    log(f"[jamba] reduced: depth {JAMBA_LAYERS} of {full.num_layers} layers (every width "
        "kept): the 72-layer int4 model, about 199 GB, does not fit one 80 GB card")
    specs, arrivals = recurrent_trace(cfg.vocab_size, [680, 200, 413, 333], [0, 0, 1, 3],
                                      seed=12)
    holder, summary = phase_recurrent(
        dev, "jamba", cfg, specs, arrivals, JAMBA_NEW, MOE_KERNELS,
        GENERATE_KERNELS + ("grouped_matmul",),
        extra=f"; {cfg.num_experts} experts top-{cfg.experts_per_tok} on odd layers", moe=True)
    summary["reduced"] = {"num_layers": [full.num_layers, JAMBA_LAYERS]}
    summary["pressure"] = recurrent_pressure(holder[0])
    return holder, summary


# ---------------------------------------------------------------------------
# phase 9: the encoder-decoder and M-RoPE at full width
# ---------------------------------------------------------------------------

SEAMLESS_PROMPT = 64
SEAMLESS_SRC = 256               # source frames a request
SEAMLESS_NEW = 32
QWEN2VL_NEW = 16


class EncDecSpies:
    """While entered: the dense attention kernels' launches by what they
    ran -- kernel 7 causal and non-causal (the encoder), kernel 6 with one
    query token a row and with T > 1 tokens folded into the head axis
    (cross attention at prefill)."""

    def __init__(self):
        self.prefill = {"causal": 0, "non_causal": 0}
        self.decode = {"one_token": 0, "folded": 0}

    def __enter__(self):
        from repro_torch.kernels import flash_prefill as FP
        from repro_torch.kernels import quant_attention as QA
        from repro_torch.runtime import dispatch as D
        self._orig = orig = (D.Dispatcher.prefill_attention, D.Dispatcher.decode_attention)

        def prefill(disp, qh, kh, vh, *, causal, window, policy):
            before = FP.flash_prefill_attention.launches
            out = orig[0](disp, qh, kh, vh, causal=causal, window=window, policy=policy)
            self.prefill["causal" if causal else "non_causal"] += (
                FP.flash_prefill_attention.launches - before)
            return out

        def decode(disp, qh, cache, pos, policy, causal=True):
            before = QA.quant_decode_attention.launches
            out = orig[1](disp, qh, cache, pos, policy, causal=causal)
            self.decode["folded" if qh.shape[1] > 1 else "one_token"] += (
                QA.quant_decode_attention.launches - before)
            return out

        D.Dispatcher.prefill_attention = prefill
        D.Dispatcher.decode_attention = decode
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.runtime import dispatch as D
        D.Dispatcher.prefill_attention, D.Dispatcher.decode_attention = self._orig

    def __str__(self) -> str:
        return f"dense prefill kernel {self.prefill}; dense decode kernel {self.decode}"


def dense_caches(B: int, S: int, hkv: int, d: int, gen, dev, copies: int = 4):
    """``copies`` dense caches [B, S, hkv, d] quantized from random keys and
    values, as a cross cache is written."""
    import torch
    from repro_torch.core import kv_cache as KV
    from repro_torch.core import quantization as Q
    out = []
    for _ in range(copies):
        k = torch.randn((B, S, hkv, d), generator=gen, device=dev)
        v = torch.randn((B, S, hkv, d), generator=gen, device=dev)
        kq, ks, kz = KV.quantize_keys(k.to(torch.bfloat16))
        out.append((kq, ks, kz, KV.cast_values(v, Q.FP8_DTYPE)))
    return out


def phase_encdec_kernels(dev, cfg, results: dict) -> dict:
    """Kernels 6 and 7 at seamless-m4t-large-v2's shapes (16 heads of 64 over
    16 KV heads), each against its plain version, timed a call and on the
    device beside its bound and SDPA: kernel 7 non-causal over a 256-frame
    source (the encoder, row 7c); kernel 6 with a 64-token prompt's queries
    folded into the head axis over a 256-slot cross cache (cross attention
    at prefill, G' = 64, row 6d); kernel 6 at a 4-row decode step over the
    same caches (cross attention at decode, row 6e)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import kv_cache as KV
    from repro_torch.kernels import flash_prefill as FP
    from repro_torch.kernels import quant_attention as QA
    gen = torch.Generator(device=dev).manual_seed(78)
    H, Hkv, D, S = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, SEAMLESS_SRC
    out = {}

    def record(name: str, key: str, row: dict, label: str) -> None:
        results[name]["all_shapes"].append(row)
        results[name]["err"] = max(results[name]["err"], row["err"])
        out[key] = row
        b = row["bound"]
        log(f"[kernels] {name} {label}: {row['ms']:.4f} ms a call, {f4(row['graph_ms'])} ms "
            f"on the device, bound {b[0]:.5f} ms ({b[1]}); plain {row['plain_ms']:.4f} ms; "
            f"SDPA {f4(row['library_ms'])} ms a call, {f4(row['library_graph_ms'])} ms on "
            f"the device; max abs err {row['err']:.3e}")

    # row 7c: the encoder, every frame over every frame
    q = (torch.randn((1, S, H, D), generator=gen, device=dev) / math.sqrt(D)).to(torch.bfloat16)
    k = torch.randn((1, S, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((1, S, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
    fn = lambda *a: FP.flash_prefill_attention(*a, causal=False)  # noqa: E731
    plain = lambda *a: FP.flash_prefill_attention_plain(*a, causal=False)  # noqa: E731
    err = check_close("flash_prefill_attention", fn(q, k, v), plain(q, k, v),
                      f"non-causal T=S={S} D={D}")
    lib_ms, lib_gms = library_time(lambda a, b, c: F.scaled_dot_product_attention(
        a, b, c, scale=1.0), [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))])
    record("flash_prefill_attention", "encoder_prefill", dict(
        err=err, ms=time_ms(fn, [(q, k, v)]), graph_ms=graph_ms(fn, [(q, k, v)]),
        plain_ms=time_ms(plain, [(q, k, v)], iters=3), library_ms=lib_ms,
        library_graph_ms=lib_gms,
        bound=bound(q.numel() * 2 + 2 * S * Hkv * D * 2 + S * H * D * 4, 4 * H * D * S * S,
                    BF16_FLOPS_PER_S),
        shape=f"B=1 T={S} S={S} H={H} Hkv={Hkv} D={D} non-causal (seamless-m4t encoder)"),
        f"non-causal T=S={S} H={H} D={D}")
    del q, k, v

    caches = dense_caches(4, S, Hkv, D, gen, dev)
    length = torch.tensor(S, dtype=torch.int32, device=dev)
    for key, B, Gq, label in (("cross_prefill", 1, SEAMLESS_PROMPT, "folded"),
                              ("cross_decode", 4, 1, "cross decode")):
        q = (torch.randn((B, Hkv * Gq, D), generator=gen, device=dev)
             / math.sqrt(D)).to(torch.bfloat16)
        sets = [(q, *(t[:B] for t in c), length) for c in caches]
        err = check_close("quant_decode_attention", QA.quant_decode_attention(*sets[0]),
                          QA.quant_decode_attention_plain(*sets[0]),
                          f"{label} B={B} G'={Gq} S={S}")
        kd = KV.dequantize_keys(*(t[:B] for t in caches[0][:3]))
        vd = caches[0][3][:B].to(torch.bfloat16)
        lib_ms, lib_gms = library_time(lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, scale=1.0), [(q.reshape(B, Hkv, Gq, D), kd.transpose(1, 2),
                                   vd.transpose(1, 2))])
        splits = QA.decode_splits(B, Hkv * QA.head_tiles(Gq), -(-S // QA.DENSE_BLOCK))
        record("quant_decode_attention", key, dict(
            err=err, ms=time_ms(QA.quant_decode_attention, sets),
            graph_ms=graph_ms(QA.quant_decode_attention, sets),
            plain_ms=time_ms(QA.quant_decode_attention_plain, sets[:1], iters=5),
            library_ms=lib_ms, library_graph_ms=lib_gms, splits=splits,
            head_tiles=QA.head_tiles(Gq),
            bound=bound(q.numel() * 2 + B * S * Hkv * (2 * D + 8) + q.numel() * 4,
                        4 * B * S * Hkv * Gq * D, BF16_FLOPS_PER_S),
            shape=f"B={B} Hkv={Hkv} G'={Gq} D={D} S={S} full (seamless-m4t cross "
                  + ("attention at prefill: a 64-token prompt folded into the head axis)"
                     if Gq > 1 else "attention at decode)")),
            f"{label} B={B} Hkv={Hkv} G'={Gq} S={S} ({splits} splits, "
            f"{QA.head_tiles(Gq)} head tiles)")
        del kd, vd
    del caches
    torch.cuda.synchronize()
    return out


def encdec_steps(src):
    """``compare_paths``' steps for an encoder-decoder on source frames
    ``src`` (numpy [1, S, d]): every encoder layer and the final norm, then
    ``prefill_then_decode`` over cross caches built from the encoder's
    output.  Fed, the encoder layers take the other run's outputs and the
    cross caches are built from its encoder output, so each decoder layer
    meets the same keys and values in both runs."""
    def steps(engine, prompt, nxt, feed=None):
        import torch
        from repro_torch.core.precision import DEFAULT_POLICY
        from repro_torch.models import layers as L
        from repro_torch.models import transformer as T
        cfg, dev = engine.cfg, engine.device
        x = torch.from_numpy(src).to(dev).to(torch.bfloat16)
        positions = torch.arange(x.shape[1], device=dev)[None]
        fed = None if feed is None else feed["encoder"][0]
        outs = []
        for li in range(cfg.encoder_layers):
            inp = x if fed is None or not outs else fed[li - 1]
            x = T._encoder_layer(inp, T.layer_slice(engine.params["encoder"], li), cfg,
                                 positions, engine.dispatch, DEFAULT_POLICY)
            outs.append(x)
        last = outs[-1] if fed is None else fed[cfg.encoder_layers - 1]
        outs.append(L.rms_norm(last, engine.params["enc_norm"], cfg.rms_eps, engine.dispatch))
        enc_out = outs[-1] if fed is None else fed[-1]
        caches = T.init_cache(cfg, 1, engine.max_seq, cross_len=src.shape[1], device=dev)
        caches["cross"] = T.build_cross_caches(engine.params, cfg, enc_out, caches["cross"],
                                               engine.dispatch)
        return {"encoder": (outs, None),
                **prefill_then_decode(engine, prompt, nxt, feed, caches=caches)}
    return steps


def phase_seamless(dev, results: dict):
    """seamless-m4t-large-v2 at full width and depth (24 encoder and 24
    decoder layers, d_model 1024, 16 heads of 64 over 16 KV heads, gelu FFN
    of 8192, vocab 256206 padded to 256256) from seed 0: kernels 6 and 7 at
    its shapes first; then 4 greedy requests of 64-token prompts, each with
    256 source frames drawn N(0, 0.02) from the seed, 32 new tokens through
    ``Engine.generate`` (rows 1, 4, 6 and 7 launched; kernel 7 non-causal 24
    times a request, the encoder; kernel 6 folded 24 times a request, cross
    attention at prefill); a profiled decode step; the encoder, the decoder
    prefill and one decode step kernel vs plain, layer by layer.  The
    continuous loop refuses the model, as the reference's does.  Returns
    (engine holder, summary)."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as E
    from repro_torch.serving import sampling as SM

    cfg = registry.get("seamless-m4t-large-v2")
    summary = {"kernels": phase_encdec_kernels(dev, cfg, results)}
    t0 = time.perf_counter()
    eng = E.build_engine(cfg, seed=0, max_seq=1024, device=dev,
                         flash_dir=str(ROOT / "build" / "flash-seamless"))
    engine_line("seamless", cfg, t0, dev, f"; {cfg.encoder_layers} encoder layers")
    try:
        E.EngineLoop(eng)
        raise AssertionError("EngineLoop took an encoder-decoder")
    except ValueError as e:
        log(f"[seamless] EngineLoop refuses it: {e}")
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, SEAMLESS_PROMPT)]
               for _ in range(4)]
    src = np.asarray(rng.normal(size=(4, SEAMLESS_SRC, cfg.d_model)) * 0.02, np.float32)
    reqs = [E.Request(uid=i, prompt_tokens=p, max_new_tokens=SEAMLESS_NEW)
            for i, p in enumerate(prompts)]
    spy = EncDecSpies()
    eng.stats = E.EngineStats()
    with spy:
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng.generate(reqs, SM.SamplingParams(temperature=0.0, max_new_tokens=SEAMLESS_NEW),
                     src_embeds=src)
        wall = time.perf_counter() - t1
        counts = K.launch_counts()
    s = eng.stats
    log(f"[seamless] Engine.generate launches: {counts}; {spy}")
    assert all(r.done and len(r.generated) == SEAMLESS_NEW for r in reqs), "unfinished requests"
    for name in GENERATE_KERNELS:
        assert counts[name] > 0, f"{name} never launched on seamless's Engine.generate: {counts}"
    L_ = cfg.num_layers
    assert spy.prefill == {"causal": 4 * L_, "non_causal": 4 * cfg.encoder_layers}, spy.prefill
    assert spy.decode == {"folded": 4 * L_, "one_token": 2 * L_ * (SEAMLESS_NEW - 1)}, \
        spy.decode
    assert eng.dispatch.fallbacks == [], eng.dispatch.fallbacks
    summary.update({
        "wall_s": wall, "requests": 4, "prompt_tokens": SEAMLESS_PROMPT,
        "source_frames": SEAMLESS_SRC, "new_tokens": 4 * SEAMLESS_NEW,
        "prefill_s": s.prefill_s, "decode_s": s.decode_s,
        "prefill_tok_per_s": s.prefill_tps, "decode_tok_per_s": s.decode_tps,
        "decode_step_ms": s.decode_s / (SEAMLESS_NEW - 1) * 1e3, "launches": counts,
        "dense_prefill_kernel": dict(spy.prefill), "dense_decode_kernel": dict(spy.decode),
        "tokens": [r.generated for r in reqs]})
    log(f"[seamless] Engine.generate: 4 requests x {SEAMLESS_PROMPT}-token prompts over "
        f"{SEAMLESS_SRC} source frames, {4 * SEAMLESS_NEW} new tokens in {wall:.2f} s; "
        f"prefill (encoder included) {s.prefill_s:.2f} s, decode {s.decode_tps:.1f} tok/s "
        f"({summary['decode_step_ms']:.1f} ms a 4-row step)")
    caches = [T.prefill(eng.params, cfg, eng.embed(np.asarray(p)[None]), eng.max_seq,
                        eng.dispatch,
                        src_embeds=torch.from_numpy(src[i:i + 1]).to(dev).to(torch.bfloat16))[1]
              for i, p in enumerate(prompts)]
    state = {"cache": E._concat_caches(caches)}
    del caches
    embeds = eng.embed(np.asarray([[p[-1]] for p in prompts]))

    def step():
        _, state["cache"] = T.decode_step(eng.params, cfg, embeds, state["cache"], eng.dispatch)
    summary["profile"] = profile_steps(f"{cfg.name} Engine.generate decode step, 4 rows "
                                       "(self and cross attention)", step)
    del state
    summary["kernel_vs_plain"] = compare_paths(f"{cfg.name} Engine.generate", eng,
                                               encdec_steps(src[:1]), prompts[0],
                                               prompts[1][0])
    return [eng], summary


def vision_positions(n_text: int, side: int, n_tail: int):
    """Qwen2-VL's (t, h, w) ids for text, a side x side image block and more
    text: text ids count up on all three axes; the block keeps t at the
    next id while h and w step over its rows and columns; the tail resumes
    one past the block's largest id.  -> int64 [n_text + side**2 + n_tail, 3]."""
    import numpy as np
    text = np.repeat(np.arange(n_text)[:, None], 3, axis=1)
    hh, ww = np.divmod(np.arange(side * side), side)
    block = np.stack([np.full(side * side, n_text), n_text + hh, n_text + ww], axis=1)
    tail = np.repeat((n_text + side + np.arange(n_tail))[:, None], 3, axis=1)
    return np.concatenate([text, block, tail]).astype(np.int64)


def phase_qwen2vl(dev, results: dict):
    """qwen2-vl-2b at full width and depth (28 layers, d_model 1536, 12
    heads over 2 KV heads of 128, qkv bias, d_ff 8960, M-RoPE sections (16,
    24, 24), vocab 151936) from seed 0: 6 requests of the qwen2-7b trace's
    kind (16 new tokens) through ``EngineLoop`` eagerly and on its CUDA
    graphs (text positions: the same id on all three axes; tokens equal
    eager, no capture after warmup, 1 sync a graph decode step, rows 1-4
    launched), a decode step profiled eager and on its graph, and
    ``Engine.generate`` at 4 x 320 (rows 6 and 7), whose prefill and decode
    step are held kernel vs plain, layer by layer, with three-axis
    positions (32 text tokens, a 16 x 16-patch image block, 32 more text
    tokens).  Returns (engine holder, summary)."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import registry
    from repro_torch.serving import engine as E

    cfg = registry.get("qwen2-vl-2b")
    t0 = time.perf_counter()
    eng = E.build_engine(cfg, seed=0, max_seq=2048, device=dev,
                         flash_dir=str(ROOT / "build" / "flash-qwen2vl"))
    engine_line("qwen2vl", cfg, t0, dev, f"; M-RoPE sections {cfg.mrope_sections}")
    specs, arrivals = make_trace(cfg.vocab_size, requests=6)
    log(f"[qwen2vl] trace: prompts {[len(p) for p in specs]}, arrivals {arrivals}; eager")
    K.reset_launch_counts()
    loop, reqs, wall = serve_trace(eng, specs, arrivals, max_new=QWEN2VL_NEW)
    counts = K.launch_counts()
    loop.close()
    log(f"[qwen2vl] launches during the trace: {counts}")
    assert all(r.done and len(r.generated) == QWEN2VL_NEW for r in reqs), "unfinished requests"
    for name in LOOP_KERNELS:
        assert counts[name] > 0, f"{name} never launched on qwen2-vl's EngineLoop: {counts}"
    assert eng.dispatch.fallbacks == [], eng.dispatch.fallbacks
    summary = loop_summary("qwen2vl", loop, reqs, wall, eng, counts)
    summary["prefix_hits_pages"] = loop.pool.prefix_hits
    summary["graphs"], summary["profile_graphs"] = phase_graphs(
        "qwen2-vl-2b", eng, specs, arrivals, reqs, QWEN2VL_NEW, LOOP_KERNELS)
    summary["profile"] = profile_loop_decode(eng, specs)
    assert summary["profile_graphs"]["syncs_per_step"] == 1, summary["profile_graphs"]
    pos3 = vision_positions(32, 16, 32)
    nxt = int(pos3[-1, 0]) + 1
    log(f"[qwen2vl] three-axis positions for the kernel-vs-plain steps: {len(pos3)} tokens, "
        f"t/h/w ids up to {pos3.max(axis=0).tolist()}, the decode step at id {nxt} on every "
        "axis")

    def mrope_steps(engine, prompt, tok, feed=None):
        return prefill_then_decode(
            engine, prompt, tok, feed,
            positions=torch.from_numpy(pos3).to(engine.device)[None],
            dec_positions=torch.full((1, 1, 3), nxt, dtype=torch.int64, device=engine.device))
    summary["generate"] = phase_generate(eng, tag="qwen2vl", prompt_len=len(pos3),
                                         steps=mrope_steps)
    return [eng], summary


# ---------------------------------------------------------------------------
# phase 10: training at full width
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen2-1.5b"
TRAIN_BATCH, TRAIN_SEQ = 4, 512
TRAIN_STEPS = 20
TRAIN_WARMUP = 5                         # steps of warmup; the cosine ends at step 20
TRAIN_KERNELS = ("rmsnorm", "flash_prefill_attention")
# kernel route vs plain route, one step on the same parameters and batch:
# the loss, and each gradient leaf's relative L2 error.  Both routes sum in
# float32 and round to bf16 at the same places; the kernels sum in another
# order (kernel 7's tensor-core products and bf16 probabilities against the
# plain blockwise softmax), and each layer's backward carries the later
# layers' differences, so early leaves read the most.
TRAIN_LOSS_REL = 1e-3
TRAIN_GRAD_REL_L2 = 2e-2
# the loss of a held-out batch (the pipeline's next) after the AdamW steps
# below its loss before them by this much: a batch's training loss moves
# with its mix of documents, the held-out one measures what was learnt
# (synthetic data: skewed unigrams a random model learns first)
TRAIN_LOSS_DROP = 1.0


def _tree_rel_l2(a_tree, b_tree):
    """(worst relative L2 error over the leaves, its leaf index, the
    errors) of b against a, in float32 on the device."""
    from torch.linalg import vector_norm
    from repro_torch.training import optimizer as O
    errs = [float(vector_norm(a.float() - b.float()) / vector_norm(a.float()).clamp(min=1e-30))
            for a, b in zip(O.leaves(a_tree), O.leaves(b_tree))]
    worst = max(range(len(errs)), key=errs.__getitem__)
    return errs[worst], worst, errs


@timed("timing")
def train_kernel_rows(dev, cfg, results: dict) -> None:
    """Kernels 4 and 7 at the training forward's shapes (one RMSNorm over
    the B*T rows; causal GQA over T = S = 512), each against its plain
    version, timed with its bound and library call; the rows join the
    kernels' ``all_shapes``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_prefill as FP
    from repro_torch.kernels import rmsnorm as RN
    gen = torch.Generator(device=dev).manual_seed(11)
    rows, D = TRAIN_BATCH * TRAIN_SEQ, cfg.d_model
    x = torch.randn((rows, D), generator=gen, device=dev).to(torch.bfloat16)
    w = 1.0 + 0.1 * torch.randn((D,), generator=gen, device=dev)
    err = check_close("rmsnorm", RN.rmsnorm(x, w, cfg.rms_eps), RN.rmsnorm_plain(x, w, cfg.rms_eps),
                      f"rows={rows} D={D} (training)")
    lib = (lambda a, b: F.rms_norm(a, (D,), b, cfg.rms_eps), [(x, w.to(torch.bfloat16))])
    b = bound(rows * D * 2 * 2 + D * 4, 4 * rows * D, F32_FLOPS_PER_S)
    row = {"rows": rows, "D": D, "what": "training forward", "max_abs_err": err,
           "ms": time_ms(RN.rmsnorm, [(x, w, cfg.rms_eps)]),
           "graph_ms": graph_ms(RN.rmsnorm, [(x, w, cfg.rms_eps)]),
           "plain_ms": time_ms(RN.rmsnorm_plain, [(x, w, cfg.rms_eps)]),
           "library_ms": time_ms(*lib), "library_graph_ms": graph_ms(*lib),
           "bound_ms": b[0], "bound_by": b[1]}
    results["rmsnorm"]["all_shapes"].append(row)
    log(f"[train] rmsnorm rows={rows} D={D}: {row['ms']:.4f} ms a call, "
        f"{f4(row['graph_ms'])} ms on the device; plain {row['plain_ms']:.4f}; F.rms_norm "
        f"{row['library_ms']:.4f} / {f4(row['library_graph_ms'])}; bound {b[0]:.5f} ms "
        f"({b[1]}); max abs err {err:.3e}")
    B, T, H, Hkv, hd = TRAIN_BATCH, TRAIN_SEQ, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (torch.randn((B, T, H, hd), generator=gen, device=dev) / math.sqrt(hd)).to(torch.bfloat16)
    k = torch.randn((B, T, Hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, T, Hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    err = check_close("flash_prefill_attention", FP.flash_prefill_attention(q, k, v),
                      FP.flash_prefill_attention_plain(q, k, v),
                      f"B={B} T=S={T} H={H} Hkv={Hkv} (training)")
    G = H // Hkv
    sdpa = (lambda a, b_, c: F.scaled_dot_product_attention(a, b_, c, is_causal=True, scale=1.0),
            [(q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(G, dim=1),
              v.transpose(1, 2).repeat_interleave(G, dim=1))])
    pairs = T * (T + 1) // 2
    b = bound(q.numel() * 2 + 2 * k.numel() * 2 + B * T * H * hd * 4,
              4 * B * H * hd * pairs, BF16_FLOPS_PER_S)
    row = {"B": B, "T": T, "S": T, "H": H, "Hkv": Hkv, "D": hd, "what": "training forward",
           "max_abs_err": err, "ms": time_ms(FP.flash_prefill_attention, [(q, k, v)]),
           "graph_ms": graph_ms(FP.flash_prefill_attention, [(q, k, v)]),
           "plain_ms": time_ms(FP.flash_prefill_attention_plain, [(q, k, v)], iters=5),
           "library_ms": time_ms(*sdpa), "library_graph_ms": graph_ms(*sdpa),
           "bound_ms": b[0], "bound_by": b[1]}
    results["flash_prefill_attention"]["all_shapes"].append(row)
    log(f"[train] flash_prefill_attention B={B} T=S={T} {H}/{Hkv} heads of {hd}, causal: "
        f"{row['ms']:.4f} ms a call, {f4(row['graph_ms'])} ms on the device; plain "
        f"{row['plain_ms']:.4f}; SDPA {row['library_ms']:.4f} / {f4(row['library_graph_ms'])}; "
        f"bound {b[0]:.5f} ms ({b[1]}); max abs err {err:.3e}")


def phase_train(dev, results: dict, card: str):
    """qwen2-1.5b's float tree at full width and depth (28 layers, d_model
    1536, 12/2 heads of 128, d_ff 8960, vocab 151936; ~1.78 B parameters,
    bf16, from ``torch.Generator`` seed 0) takes AdamW steps
    (``default_opt_for``: lr 3e-4, here after 5 warmup steps and a cosine
    over 20) under remat on batches of 4 x 512 tokens from the port's
    pipeline: (a) one step's loss and every gradient leaf on the kernel
    route against ``Dispatcher(backend="reference")`` on the same
    parameters and batch; (b) kernels 4 and 7 launched in every step (the
    forward and remat's recompute, through their ``autograd.Function``s),
    nothing fallen back; (c) over 20 steps the loss of a held-out batch
    falls and the gradient norm stays finite; (d) one Adafactor step moves every parameter
    and stays finite.  Prints a step's wall time, tokens/s, peak device
    memory and the two kernels' device time in a step.  Returns (holder,
    summary)."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels as K
    from repro_torch.analysis import trace
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.models import transformer as T
    from repro_torch.runtime import dispatch as D
    from repro_torch.runtime import plan as RP
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_loop as TL

    cfg = registry.get(TRAIN_ARCH)
    train_kernel_rows(dev, cfg, results)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in O.leaves(params))
    log(f"[train] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.padded_vocab_size}; float tree of {n_params:,} "
        f"parameters ({sum(t.numel() * t.element_size() for t in O.leaves(params)) / 2**30:.2f} "
        f"GiB) built in {time.perf_counter() - t0:.1f} s")
    data = Pipeline(DataConfig(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                               vocab_size=cfg.vocab_size, seed=0))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for b in data.batches(TRAIN_STEPS + 1)]
    held_out = batches.pop()

    def held_out_loss(p) -> float:
        with torch.no_grad():
            return float(TL.loss_fn(p, cfg, held_out, T.StepCtx(cfg))[1]["loss"])
    summary = {"arch": cfg.name, "parameters": n_params, "batch": TRAIN_BATCH,
               "seq": TRAIN_SEQ, "card": card}

    # (a) one step's loss and gradients, kernel route vs plain route
    kern = T.StepCtx(cfg, remat=True)
    with spent_on("kernel_vs_plain"):
        K.reset_launch_counts()
        (ktot, km), kgrads = TL.value_and_grad(params, cfg, batches[0], kern)
        once = {n: K.launch_counts()[n] for n in TRAIN_KERNELS}
        (ptot, pm), pgrads = TL.value_and_grad(
            params, cfg, batches[0], T.StepCtx(cfg, remat=True, dispatch=D.Dispatcher("reference")))
        loss_rel = abs(float(km["loss"]) - float(pm["loss"])) / abs(float(pm["loss"]))
        worst, at, errs = _tree_rel_l2(pgrads, kgrads)
        del kgrads, pgrads
    names = ["/".join(map(str, k)) for k, _ in RP.tree_leaves_with_path(params)]
    log(f"[train] kernel vs plain, one step: loss {float(km['loss']):.6f} vs "
        f"{float(pm['loss']):.6f} (rel {loss_rel:.2e}, tolerance {TRAIN_LOSS_REL}); "
        f"{len(errs)} gradient leaves, worst rel L2 {worst:.2e} at {names[at]} (tolerance "
        f"{TRAIN_GRAD_REL_L2}), median {sorted(errs)[len(errs) // 2]:.2e}; launches {once}")
    assert loss_rel < TRAIN_LOSS_REL, (float(km["loss"]), float(pm["loss"]))
    assert worst < TRAIN_GRAD_REL_L2, (names[at], worst)
    summary["kernel_vs_plain"] = {"loss": float(km["loss"]), "plain_loss": float(pm["loss"]),
                                  "loss_rel": loss_rel, "grad_rel_l2_worst": worst,
                                  "grad_rel_l2_worst_leaf": names[at],
                                  "grad_rel_l2": dict(zip(names, errs)),
                                  "launches_one_step": once}

    # (b), (c): AdamW steps on the kernel route
    opt = dataclasses.replace(TL.default_opt_for(cfg), warmup_steps=TRAIN_WARMUP,
                              decay_steps=TRAIN_STEPS)
    eval_before = held_out_loss(params)
    assert opt.kind == "adamw", opt
    disp = D.Dispatcher()
    step = TL.make_train_step(cfg, opt, remat=True, dispatch=disp)
    state = O.init_state(opt, params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    losses, norms, walls, per_step = [], [], [], []
    with spent_on("train_steps"):
        for b in batches:
            before = K.launch_counts()
            t1 = time.perf_counter()
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))      # waits for the step
            walls.append(time.perf_counter() - t1)
            norms.append(float(m["grad_norm"]))
            after = K.launch_counts()
            per_step.append({n: after[n] - before[n] for n in K.wrappers()})
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    # the peak split: gradients take the parameters' dtypes and shapes
    p_bytes = sum(t.numel() * t.element_size() for t in O.leaves(params))
    s_bytes = sum(t.numel() * t.element_size() for t in O.leaves(state))
    split = {"parameters": p_bytes / 2**30, "gradients": p_bytes / 2**30,
             "optimizer_state": s_bytes / 2**30,
             "rest": (peak - 2 * p_bytes - s_bytes) / 2**30}
    assert disp.fallbacks == [], disp.fallbacks
    for i, c in enumerate(per_step):
        for name in TRAIN_KERNELS:
            assert c[name] > 0, f"step {i}: {name} never launched: {c}"
        assert c == per_step[0], (i, c, per_step[0])
    assert all(math.isfinite(x) for x in losses + norms), (losses, norms)
    eval_after = held_out_loss(params)
    log(f"[train] {TRAIN_STEPS} AdamW steps (lr {opt.lr}, warmup {opt.warmup_steps}, remat): "
        f"loss {' '.join(f'{x:.3f}' for x in losses)}; grad norm {norms[0]:.3f} -> "
        f"{norms[-1]:.3f}; held-out batch {eval_before:.4f} -> {eval_after:.4f} (must fall "
        f"by {TRAIN_LOSS_DROP})")
    assert eval_after < eval_before - TRAIN_LOSS_DROP, (eval_before, eval_after)
    wall = sorted(walls[1:])[len(walls[1:]) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"[train] launches a step: {per_step[0]} (rmsnorm: 2 a layer + the final norm, "
        f"and 2 a layer again in remat's recompute; attention 1 a layer and again); "
        f"fallbacks {disp.fallbacks}")
    log(f"[train] {card}: a step {wall * 1e3:.1f} ms wall (median of steps 2-{TRAIN_STEPS}; "
        f"step 1 {walls[0] * 1e3:.1f} ms), {tokens / wall:.0f} tokens/s; peak device memory "
        f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")
    summary.update(losses=losses, grad_norms=norms, held_out_loss=[eval_before, eval_after], step_wall_ms=[w * 1e3 for w in walls],
                   step_ms=wall * 1e3, tokens_per_s=tokens / wall, peak_memory_gib=peak / 2**30,
                   memory_split_gib=split,
                   launches=counts, launches_per_step=per_step[0], optimizer=opt.kind)

    # the kernels' device time in one step
    with spent_on("profile"):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            params, state, m = step(params, state, batches[-1])
            torch.cuda.synchronize()
    total_ms, dev_ms = trace.device_ms(prof, ("rmsnorm_kernel", "flash_prefill_kernel"))
    summary["device_ms_per_step"] = total_ms
    summary["kernel_device_ms_per_step"] = dev_ms
    log(f"[train] {card}: device time in a step {total_ms:.1f} ms"
        + ("" if total_ms else " (the profiler saw none: not measured)") + "; "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in dev_ms.items()))

    # (d) one Adafactor step on the same tree
    del state, step
    gc.collect()
    ada = dataclasses.replace(opt, kind="adafactor")
    astep = TL.make_train_step(cfg, ada, remat=True)
    new, _astate, am = astep(params, O.init_state(ada, params), batches[0])
    moved = [not torch.equal(a, b) for a, b in zip(O.leaves(new), O.leaves(params))]
    finite = all(bool(torch.isfinite(t).all()) for t in O.leaves(new))
    log(f"[train] one Adafactor step: loss {float(am['loss']):.4f}, grad norm "
        f"{float(am['grad_norm']):.3f}; {sum(moved)}/{len(moved)} parameter leaves moved, "
        f"all finite: {finite}")
    assert all(moved) and finite and math.isfinite(float(am["loss"]))
    summary["adafactor"] = {"loss": float(am["loss"]), "grad_norm": float(am["grad_norm"]),
                            "leaves_moved": sum(moved), "leaves": len(moved)}
    return [params, new], summary


# ---------------------------------------------------------------------------
# phase 10b: training of the other layer kinds at full width
# ---------------------------------------------------------------------------

# (arch, layers kept or None for all, batch, sequence, optimizer kind or None
# for default_opt_for's, the path's kernels, the variants of kernel 7)
TRAIN18A = (
    ("qwen2-vl-2b", None, 4, 512, None, ("rmsnorm", "flash_prefill_attention"),
     ("causal",)),
    ("seamless-m4t-large-v2", None, 4, 512, None,
     ("rmsnorm", "flash_prefill_attention", "quant_decode_attention"),
     ("causal", "non-causal")),
    # one period of gemma3's 62 layers: five window-1024 layers and a global
    # one; AdamW state for its 4.60 B parameters (2.82 B of them the
    # embedding and lm_head at vocab 262,144) does not fit beside the rest
    ("gemma3-27b", 6, 1, 2048, "adafactor", ("rmsnorm", "flash_prefill_attention"),
     ("causal", "windowed")),
    # 4 of 32 layers: 1.65 B parameters; 8 would be 2.76 B, ~80 GiB at
    # [train]'s bytes a parameter under AdamW
    ("rwkv6-7b", 4, 4, 512, None, ("rmsnorm",), ()),
    ("jamba-1.5-large-398b@reduced", None, 4, 512, None,
     ("rmsnorm", "flash_prefill_attention"), ("causal",)),
)
TRAIN18A_STEPS = 3
PLAIN_SPREAD_BK = 64             # key block of the plain route's second summation order
# where a leaf's gradient is past TRAIN_GRAD_REL_L2, the kernel route may
# differ from the plain route by this many times the plain route's own
# spread.  A weight's gradient sums its input rows: the pipeline's skewed
# tokens (147 distinct in 4 x 512) repeat rows and the sum is coherent,
# while distinct rows (qwen2-vl-2b's embeds; the encoder's N(0, 1) frames,
# whose gradient reaches it only through the int8 keys' scale and zero)
# cancel, and the same rounding reads larger.  tools/train_conditioning.py
# on the card: qwen2-1.5b on uniform tokens or embeds spreads to 4.4-4.8e-2
# and qwen2-vl-2b on the pipeline's tokens to 1.5e-2; the kernel route sits
# at 0.93-1.08 times the spread in every case, and a route with one wrong
# layer (layer 0's attention windowed at 256) at 19-28 (qwen2-vl) and up to
# 32 (seamless) with its loss within TRAIN_LOSS_REL
TRAIN_SPREAD_FACTOR = 1.5


@contextlib.contextmanager
def plain_key_blocks(bk: int):
    """The plain prefill attention (``flash_attention``) over key blocks of
    ``bk`` instead of its 1024: the same math, another summation order."""
    from repro_torch.kernels import flash_prefill as FP
    saved = FP.flash_attention
    FP.flash_attention = functools.partial(saved, bk=bk)
    try:
        yield
    finally:
        FP.flash_attention = saved
SEAMLESS_TRAIN_SRC = 128         # source frames a row: seq // 4


class TrainSpies:
    """Counts the training forward's ``autograd.Function`` applications:
    kernel 7's by variant (causal, windowed, non-causal) and kernel 6's
    (cross attention), by wrapping the classes the dispatcher looks up."""

    def __init__(self):
        self.prefill = collections.Counter()
        self.decode = 0

    def __enter__(self):
        from repro_torch.kernels import flash_prefill as FP
        from repro_torch.kernels import quant_attention as QA
        self._saved = (FP.FlashPrefillFunction, QA.QuantDecodeAttentionFunction)
        spies = self
        fp_cls, qa_cls = self._saved

        class Prefill:
            @staticmethod
            def apply(q, k, v, causal, window):
                spies.prefill["windowed" if window else
                              "causal" if causal else "non-causal"] += 1
                return fp_cls.apply(q, k, v, causal, window)

        class Decode:
            @staticmethod
            def apply(*args):
                spies.decode += 1
                return qa_cls.apply(*args)
        FP.FlashPrefillFunction, QA.QuantDecodeAttentionFunction = Prefill, Decode
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import flash_prefill as FP
        from repro_torch.kernels import quant_attention as QA
        FP.FlashPrefillFunction, QA.QuantDecodeAttentionFunction = self._saved

    def take(self) -> dict:
        out = {"prefill": dict(self.prefill), "decode": self.decode}
        self.prefill.clear()
        self.decode = 0
        return out


@timed("timing")
def train18a_kernel_rows(dev, results: dict) -> dict:
    """Kernel 7 windowed at gemma3-27b's training shape (row 7e: B = 1,
    T = S = 2048, 32/16 heads of 128, window 1024) and non-causal at
    seamless-m4t-large-v2's encoder (row 7f: B = 4, S = 128, 16/16 heads
    of 64), kernel 6 folded at seamless's cross attention (row 6h: B = 4,
    512 query tokens x 16 heads over 128 frames), each against its plain
    version, timed a call and on the device beside its bound and SDPA, and
    its ``autograd.Function``'s backward (``loader.plain_vjp``, autograd of
    the plain version) timed a call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import kv_cache as KV
    from repro_torch.kernels import flash_prefill as FP
    from repro_torch.kernels import loader
    from repro_torch.kernels import quant_attention as QA
    gen = torch.Generator(device=dev).manual_seed(31)
    out = {}

    def record(name, key, row, label):
        results[name]["all_shapes"].append(row)
        results[name]["err"] = max(results[name]["err"], row["err"])
        out[key] = row
        b = row["bound"]
        log(f"[train18a] {key} {name} {label}: {row['ms']:.4f} ms a call, "
            f"{f4(row['graph_ms'])} ms on the device, bound {b[0]:.5f} ms ({b[1]}); plain "
            f"{row['plain_ms']:.4f} ms; SDPA {f4(row['library_ms'])} ms a call, "
            f"{f4(row['library_graph_ms'])} ms on the device; backward (plain_vjp) "
            f"{row['backward_ms']:.4f} ms a call; max abs err {row['err']:.3e}")

    for key, B, T, H, Hkv, D, causal, window, what in (
            ("7e", 1, 2048, 32, 16, 128, True, 1024, "windowed (gemma3-27b training)"),
            ("7f", 4, 128, 16, 16, 64, False, 0, "non-causal (seamless-m4t encoder training)")):
        q = (torch.randn((B, T, H, D), generator=gen, device=dev) / math.sqrt(D)).to(torch.bfloat16)
        k = torch.randn((B, T, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((B, T, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
        fn = lambda *a, c=causal, w=window: FP.flash_prefill_attention(*a, causal=c, window=w)  # noqa: E731
        plain = lambda *a, c=causal, w=window: FP.flash_prefill_attention_plain(  # noqa: E731
            *a, causal=c, window=w)
        err = check_close("flash_prefill_attention", fn(q, k, v), plain(q, k, v),
                          f"{what} B={B} T=S={T}")
        G = H // Hkv
        i = torch.arange(T, device=dev)
        mask = None
        if causal:
            mask = i[None, :] <= i[:, None]
            if window:
                mask = mask & (i[:, None] - i[None, :] < window)
        lib_ms, lib_gms = library_time(
            lambda a, b_, c, m=mask: F.scaled_dot_product_attention(a, b_, c, attn_mask=m,
                                                                   scale=1.0),
            [(q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(G, dim=1),
              v.transpose(1, 2).repeat_interleave(G, dim=1))])
        pairs = (int(mask.sum()) if mask is not None else T * T)
        grad = torch.randn((B, T, H, D), generator=gen, device=dev)
        bwd = lambda a, b_, c, g: loader.plain_vjp(plain, (a, b_, c), (True,) * 3, g)  # noqa: E731
        record("flash_prefill_attention", key, dict(
            err=err, ms=time_ms(fn, [(q, k, v)]), graph_ms=graph_ms(fn, [(q, k, v)]),
            plain_ms=time_ms(plain, [(q, k, v)], iters=3), library_ms=lib_ms,
            library_graph_ms=lib_gms, backward_ms=time_ms(bwd, [(q, k, v, grad)], iters=3),
            bound=bound(q.numel() * 2 + 2 * k.numel() * 2 + B * T * H * D * 4,
                        4 * B * H * D * pairs, BF16_FLOPS_PER_S),
            shape=f"B={B} T=S={T} H={H} Hkv={Hkv} D={D} {what}"),
            f"B={B} T=S={T} {H}/{Hkv} heads of {D}, {what}")
        del q, k, v, grad, mask

    B, Hkv, D, S, Tq = 4, 16, 64, SEAMLESS_TRAIN_SRC, 512
    c = KV.quantized_cache(torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(torch.bfloat16),
                           torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(torch.bfloat16))
    q = (torch.randn((B, Hkv * Tq, D), generator=gen, device=dev) / math.sqrt(D)).to(torch.bfloat16)
    args = (q, c.k_q, c.k_scale, c.k_zero, c.v, c.length)
    err = check_close("quant_decode_attention", QA.quant_decode_attention(*args),
                      QA.quant_decode_attention_plain(*args),
                      f"folded cross attention B={B} G'={Tq} S={S} (training)")
    kd = KV.dequantize_keys(c.k_q, c.k_scale, c.k_zero)
    vd = c.v.to(torch.bfloat16)
    lib_ms, lib_gms = library_time(lambda a, b_, cc: F.scaled_dot_product_attention(
        a, b_, cc, scale=1.0), [(q.reshape(B, Hkv, Tq, D), kd.transpose(1, 2), vd.transpose(1, 2))])
    grad = torch.randn((B, Hkv * Tq, D), generator=gen, device=dev)
    bwd = lambda a, ks, kz, vv, g: loader.plain_vjp(  # noqa: E731
        lambda a_, ks_, kz_, vv_: QA.quant_decode_attention_plain(a_, c.k_q, ks_, kz_, vv_, c.length),
        (a, ks, kz, vv), (True,) * 4, g)
    splits = QA.decode_splits(B, Hkv * QA.head_tiles(Tq), -(-S // QA.DENSE_BLOCK))
    record("quant_decode_attention", "6h", dict(
        err=err, ms=time_ms(QA.quant_decode_attention, [args]),
        graph_ms=graph_ms(QA.quant_decode_attention, [args]),
        plain_ms=time_ms(QA.quant_decode_attention_plain, [args], iters=5),
        library_ms=lib_ms, library_graph_ms=lib_gms, splits=splits,
        head_tiles=QA.head_tiles(Tq),
        backward_ms=time_ms(bwd, [(q, c.k_scale, c.k_zero, c.v, grad)], iters=5),
        bound=bound(q.numel() * 2 + B * S * Hkv * (2 * D + 8) + q.numel() * 4,
                    4 * B * S * Hkv * Tq * D, BF16_FLOPS_PER_S),
        shape=f"B={B} Hkv={Hkv} G'={Tq} D={D} S={S} full (seamless-m4t cross attention at "
              "training: 512 query tokens folded into the head axis)"),
        f"folded B={B} Hkv={Hkv} G'={Tq} S={S} ({splits} splits, {QA.head_tiles(Tq)} head tiles)")
    del c, q, kd, vd, grad
    torch.cuda.synchronize()
    return out


def train18a_model(dev, arch: str, layers, B: int, T: int, kind, kernels, variants,
                   card: str) -> dict:
    """One model of ``TRAIN18A`` at full width from seed 0: (a) one step's
    loss (``TRAIN_LOSS_REL``) and every gradient leaf on the kernel route
    against ``Dispatcher("reference")`` on the same parameters and batch,
    with the same all-zero leaves on both; a leaf holds within
    ``TRAIN_GRAD_REL_L2`` or, where the plain route differs from itself by
    more under another summation order of the same math
    (``plain_key_blocks``), within ``TRAIN_SPREAD_FACTOR`` times that
    spread; (b) the path's kernels
    launched in every step through their ``autograd.Function``s, nothing
    fallen back; (c) ``TRAIN18A_STEPS`` optimizer steps with finite losses
    and gradient norms, every leaf with a gradient above the optimizer's
    eps moved by the first; (d) each step's wall time, tokens/s, peak
    device memory and the kernels' device time in one profiled step.  The
    parameters are freed before it returns."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels as K
    from repro_torch.analysis import trace
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.launch.train import frontend_batch
    from repro_torch.models import transformer as T_
    from repro_torch.runtime import dispatch as D
    from repro_torch.runtime import plan as RP
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_loop as TL

    full = registry.get(arch)
    cfg = full if layers is None else dataclasses.replace(full, num_layers=layers)
    out = {"arch": arch, "batch": B, "seq": T, "card": card}
    if layers is not None:
        out["reduced"] = {"num_layers": [full.num_layers, layers]}
    t0 = time.perf_counter()
    params = T_.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(t.numel() for t in O.leaves(params))
    gib = sum(t.numel() * t.element_size() for t in O.leaves(params)) / 2**30
    log(f"[train18a] {arch}: "
        + (f"reduced: depth {layers} of {full.num_layers} layers (every width kept); "
           if layers is not None else f"{cfg.num_layers} layers"
           + (f" + {cfg.encoder_layers} encoder layers" if cfg.encoder_layers else "") + "; ")
        + f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.resolved_head_dim}, vocab {cfg.padded_vocab_size}; {n_params:,} parameters "
        f"({gib:.2f} GiB) built in {time.perf_counter() - t0:.1f} s")
    data = Pipeline(DataConfig(batch_size=B, seq_len=T, vocab_size=cfg.vocab_size, seed=0))
    gen = torch.Generator(device=dev).manual_seed(7)
    batches = []
    for step, b in enumerate(data.batches(TRAIN18A_STEPS + 1), start=1):
        tb = frontend_batch(cfg, {k: torch.from_numpy(v).to(dev) for k, v in b.items()}, 0, step)
        if cfg.is_encdec:
            # N(0, 1) frames: the launcher's zeros would make every encoder row alike
            tb["src_embeds"] = torch.randn((B, T // 4, cfg.d_model), generator=gen,
                                           device=dev).to(torch.bfloat16)
        batches.append(tb)
    names = ["/".join(map(str, k)) for k, _ in RP.tree_leaves_with_path(params)]
    spies = TrainSpies()

    # (a) one step's loss and gradients, kernel route vs plain route
    with spent_on("kernel_vs_plain"):
        K.reset_launch_counts()
        with spies:
            (_kt, km), kgrads = TL.value_and_grad(params, cfg, batches[0],
                                                  T_.StepCtx(cfg, remat=True))
        once = {n: K.launch_counts()[n] for n in kernels}
        fn_once = spies.take()
        (_pt, pm), pgrads = TL.value_and_grad(
            params, cfg, batches[0],
            T_.StepCtx(cfg, remat=True, dispatch=D.Dispatcher("reference")))
        loss_rel = abs(float(km["loss"]) - float(pm["loss"])) / abs(float(pm["loss"]))
        kzero = [not bool(g.any()) for g in O.leaves(kgrads)]
        gmax = [float(g.abs().max()) for g in O.leaves(kgrads)]
        pzero = [not bool(g.any()) for g in O.leaves(pgrads)]
        live = [(a, b) for a, b, z in zip(O.leaves(pgrads), O.leaves(kgrads), pzero) if not z]
        worst, at, errs = _tree_rel_l2([a for a, _ in live], [b for _, b in live])
        live_names = [n for n, z in zip(names, pzero) if not z]
        del kgrads, live
        spread = [0.0] * len(errs)
        if worst >= TRAIN_GRAD_REL_L2:
            # the plain route's own spread: the same exact math in another
            # summation order (attention's online softmax over key blocks of
            # PLAIN_SPREAD_BK), as the kernels sum in theirs
            with plain_key_blocks(PLAIN_SPREAD_BK):
                _, sgrads = TL.value_and_grad(
                    params, cfg, batches[0],
                    T_.StepCtx(cfg, remat=True, dispatch=D.Dispatcher("reference")))
            _, _, spread = _tree_rel_l2(
                [a for a, z in zip(O.leaves(pgrads), pzero) if not z],
                [b for b, z in zip(O.leaves(sgrads), pzero) if not z])
            del sgrads
        del pgrads
        over = [i for i, e in enumerate(errs) if e >= TRAIN_GRAD_REL_L2]
    log(f"[train18a] {arch} kernel vs plain, one step: loss {float(km['loss']):.6f} vs "
        f"{float(pm['loss']):.6f} (rel {loss_rel:.2e}, tolerance {TRAIN_LOSS_REL}); "
        f"{len(names)} gradient leaves, {sum(pzero)} all zero on the plain route and "
        f"{sum(kzero)} on the kernel route; worst rel L2 {worst:.2e} at {live_names[at]} "
        f"(tolerance {TRAIN_GRAD_REL_L2}), median {sorted(errs)[len(errs) // 2]:.2e}; "
        f"launches {once}; Functions {fn_once}")
    if over:
        log(f"[train18a] {arch}: {len(over)} of {len(errs)} leaves past {TRAIN_GRAD_REL_L2}; "
            f"the plain route against itself with key blocks of {PLAIN_SPREAD_BK} (same "
            "math, another order) differs there by: " + ", ".join(
                f"{live_names[i]} {errs[i]:.2e} vs {spread[i]:.2e}" for i in over[:12])
            + (" ..." if len(over) > 12 else "") + "; ratios " + "-".join(
                f"{f(errs[i] / max(spread[i], 1e-30) for i in over):.2f}" for f in (min, max)))
    if cfg.num_experts:
        log(f"[train18a] {arch} MoE aux: load balance {float(km['moe_lb']):.4f} vs "
            f"{float(pm['moe_lb']):.4f}, z {float(km['moe_z']):.4f} vs {float(pm['moe_z']):.4f}")
    out["kernel_vs_plain"] = {
        "loss": float(km["loss"]), "plain_loss": float(pm["loss"]), "loss_rel": loss_rel,
        "grad_rel_l2_worst": worst, "grad_rel_l2_worst_leaf": live_names[at],
        "grad_rel_l2": dict(zip(live_names, errs)),
        "plain_spread_rel_l2": {live_names[i]: spread[i] for i in over},
        "zero_leaves_plain": sum(pzero),
        "zero_leaves_kernel": sum(kzero),
        "zero_leaf_names": [n for n, z in zip(names, pzero) if z],
        "launches_one_step": once, "functions_one_step": fn_once}

    # (b), (c): optimizer steps on the kernel route
    base = TL.default_opt_for(cfg)
    # warmup of one step: at the default's first warmup step (lr / 100) a
    # bf16 leaf's update rounds away
    opt = dataclasses.replace(base, kind=kind or base.kind, warmup_steps=1)
    disp = D.Dispatcher()
    step_fn = TL.make_train_step(cfg, opt, remat=True, dispatch=disp)
    state = O.init_state(opt, params)
    moved = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    losses, norms, walls, per_step, fns = [], [], [], [], []
    with spent_on("train_steps"):
        for b in batches[:TRAIN18A_STEPS]:
            before = K.launch_counts()
            t1 = time.perf_counter()
            with spies:
                new, state, m = step_fn(params, state, b)
                losses.append(float(m["loss"]))      # waits for the step
            walls.append(time.perf_counter() - t1)
            if moved is None:    # the first update, while its input still lives
                moved = [not torch.equal(a, b) for a, b in zip(O.leaves(new), O.leaves(params))]
            params = new
            norms.append(float(m["grad_norm"]))
            after = K.launch_counts()
            per_step.append({n: after[n] - before[n] for n in K.wrappers()})
            fns.append(spies.take())
    peak = torch.cuda.max_memory_allocated(dev)
    counts = K.launch_counts()
    # a leaf whose gradient lies far below the optimizer's eps (jamba's
    # dt_proj: ~1e-11 against AdamW's 1e-8) takes an update of lr * g / eps,
    # below its bf16 rounding; every other leaf with a gradient must move
    tiny = [n for n, g, z in zip(names, gmax, pzero) if not z and g <= opt.eps]
    stuck = [n for n, mv, g, z in zip(names, moved, gmax, pzero)
             if not mv and not z and g > opt.eps]
    finite = all(bool(torch.isfinite(t).all()) for t in O.leaves(params))
    del new
    tokens = B * T
    log(f"[train18a] {arch}: {TRAIN18A_STEPS} {opt.kind} steps (lr {opt.lr}, warmup 1, "
        f"remat): loss {' '.join(f'{x:.4f}' for x in losses)}; grad norm "
        f"{' '.join(f'{x:.3f}' for x in norms)}; {sum(moved)}/{len(moved)} leaves moved in the "
        f"first step "
        f"({len(stuck)} with a gradient above the optimizer's eps {opt.eps:g} did not; "
        f"below it: {tiny or 'none'}), all finite: {finite}")
    log(f"[train18a] {arch} launches a step: {per_step[0]}; Functions a step: {fns[0]}; "
        f"fallbacks {disp.fallbacks}")
    log(f"[train18a] {card}: {arch} step wall "
        + ", ".join(f"{w * 1e3:.1f}" for w in walls) + " ms, "
        + ", ".join(f"{tokens / w:.0f}" for w in walls) + " tokens/s; peak device memory "
        f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")

    # (d) the kernels' device time in one profiled step
    syms = {"rmsnorm": "rmsnorm_kernel", "flash_prefill_attention": "flash_prefill_kernel",
            "quant_decode_attention": "dense_decode_kernel"}
    with spent_on("profile"):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            params, state, m = step_fn(params, state, batches[-1])
            torch.cuda.synchronize()
        total_ms, dev_ms = trace.device_ms(prof, [syms[n] for n in kernels])
    log(f"[train18a] {card}: {arch} device time in a step {total_ms:.1f} ms"
        + ("" if total_ms else " (the profiler saw none: not measured)") + "; "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in dev_ms.items()))
    out.update(parameters=n_params, parameter_gib=gib, optimizer=opt.kind, losses=losses,
               grad_norms=norms, step_wall_ms=[w * 1e3 for w in walls],
               tokens_per_s=[tokens / w for w in walls], peak_memory_gib=peak / 2**30,
               launches=counts, launches_per_step=per_step[0], functions_per_step=fns[0],
               leaves_moved=sum(moved), leaves=len(moved), stuck=stuck, below_eps=tiny,
               device_ms_per_step=total_ms, kernel_device_ms_per_step=dev_ms,
               last_loss=float(m["loss"]))

    assert loss_rel < TRAIN_LOSS_REL, (arch, float(km["loss"]), float(pm["loss"]))
    for i in over:
        assert errs[i] <= TRAIN_SPREAD_FACTOR * spread[i], (arch, live_names[i], errs[i],
                                                            spread[i])
    assert kzero == pzero, (arch, [n for n, a, b in zip(names, kzero, pzero) if a != b])
    assert disp.fallbacks == [], disp.fallbacks
    for i, c in enumerate(per_step):
        for name in kernels:
            assert c[name] > 0, f"{arch} step {i}: {name} never launched: {c}"
        assert c == per_step[0], (arch, i, c, per_step[0])
    for i, f in enumerate(fns):
        assert f == fns[0], (arch, i, f, fns[0])
        assert set(f["prefill"]) == set(variants), (arch, i, f)
        assert (f["decode"] > 0) == ("quant_decode_attention" in kernels), (arch, i, f)
        # each launch of kernel 7 or 6 came through its Function
        assert sum(f["prefill"].values()) == per_step[i]["flash_prefill_attention"], (arch, f)
        assert f["decode"] == per_step[i]["quant_decode_attention"], (arch, f)
    assert all(math.isfinite(x) for x in losses + norms), (arch, losses, norms)
    assert finite and not stuck, (arch, stuck[:8])
    del params, state, m, batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train18a(dev, results: dict, card: str, train: dict):
    """Training of every other layer kind at full width (``TRAIN18A``):
    first the memory of ``[train]``'s qwen2-1.5b AdamW step split into
    parameters, gradients, optimizer state and the rest, then kernels 7
    and 6 at the new training shapes (rows 7e, 7f, 6h), then each model in
    turn through ``train18a_model``.  Returns (an empty holder, summary)."""
    split = train["memory_split_gib"]
    log(f"[train18a] {card}: [train]'s {train['arch']} AdamW step peaked at "
        f"{train['peak_memory_gib']:.2f} GiB: parameters {split['parameters']:.2f}, "
        f"gradients {split['gradients']:.2f}, optimizer state {split['optimizer_state']:.2f}, "
        f"the rest (activations saved for remat, each layer's recompute, the float32 "
        f"products and the logits of a 512-token chunk) {split['rest']:.2f} GiB")
    summary = {"memory_split_gib_train": split,
               "kernel_rows": train18a_kernel_rows(dev, results), "models": {}}
    for arch, layers, B, T, kind, kernels, variants in TRAIN18A:
        t0 = time.perf_counter()
        summary["models"][arch] = train18a_model(dev, arch, layers, B, T, kind, kernels,
                                                 variants, card)
        summary["models"][arch]["phase_s"] = time.perf_counter() - t0
        log(f"[train18a] {arch} took {summary['models'][arch]['phase_s']:.1f} s")
    return [], summary


# ---------------------------------------------------------------------------
# phase 11: the paper's models and its quantization variants
# ---------------------------------------------------------------------------

PAPER_REQUESTS = 6
PAPER_NEW = 16
DBRX_LAYERS = 16                 # of 40: see phase_dbrx
# one engine for every variant at once: int4 keys, bf16 values, A16 and
# weight groups of 128 (the JAX package's QuantConfig fields)
QUANTVAR = dict(kv_key_bits=4, kv_value_fp8=False, act_bits=16, group_size=128)
VARIANT_KERNELS = ("paged_quant_decode_attention", "paged_flash_prefill_attention",
                   "quant_decode_attention")


class VariantSpies:
    """While entered: the launches of kernels 2, 3 and 6 by the (key bits,
    value dtype) of the pool or cache they read, counted around the
    dispatcher's ops (the warmup's eager runs and captures are the only
    Python calls of a graph step)."""

    def __init__(self):
        self.by_variant = {n: collections.Counter() for n in VARIANT_KERNELS}

    def __enter__(self):
        from repro_torch import kernels as K
        from repro_torch.runtime import dispatch as D
        ops = {"paged_quant_decode_attention": "paged_decode_attention",
               "paged_flash_prefill_attention": "paged_prefill_attention",
               "quant_decode_attention": "decode_attention"}
        self._orig = {op: getattr(D.Dispatcher, op) for op in ops.values()}

        def spy(kernel, op):
            orig = self._orig[op]

            def inner(disp, qh, store, *a, **kw):
                before = K.launch_counts()[kernel]
                out = orig(disp, qh, store, *a, **kw)
                n = K.launch_counts()[kernel] - before
                if n:
                    self.by_variant[kernel][f"int{store.key_bits}/{store.v.dtype}"] += n
                return out
            return inner
        for kernel, op in ops.items():
            setattr(D.Dispatcher, op, spy(kernel, op))
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.runtime import dispatch as D
        for op, fn in self._orig.items():
            setattr(D.Dispatcher, op, fn)

    def __str__(self) -> str:
        return "launches by (key bits, values): " + ", ".join(
            f"{k} {dict(v)}" for k, v in self.by_variant.items())

    def check(self, kernels, variant: str) -> None:
        for k in kernels:
            assert set(self.by_variant[k]) == {variant}, (k, dict(self.by_variant[k]))


def serve_dense(dev, tag: str, cfg, flash: str, loop_kernels, idle_kernels=(),
                generate_kernels=GENERATE_KERNELS, float_path: bool = False,
                spies=None, variant: str = ""):
    """A dense model at full width through ``EngineLoop`` (a 6-request
    ``make_trace``, 16 new tokens, the shared prefix adopted, eagerly and
    on its CUDA graphs: tokens equal, no capture after warmup, one graph
    decode step profiled), one
    chunk and one decode step kernel vs plain, then ``Engine.generate`` at
    4 x 320 with no eager profile.  ``loop_kernels`` must launch on both
    loop paths and ``idle_kernels`` never; the float path's count must be
    positive exactly when ``float_path``; with ``spies`` (a
    ``VariantSpies``) every launch of kernels 2, 3 and 6 read ``variant``.
    Returns (engine holder, summary)."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.serving import engine as E

    def check_counts(where: str, counts: dict, kernels) -> None:
        for name in kernels:
            assert counts[name] > 0, f"[{tag}] {name} never launched {where}: {counts}"
        for name in idle_kernels:
            assert counts[name] == 0, f"[{tag}] {name} launched {where}: {counts}"
        assert (counts["float_matmul"] > 0) == float_path, (where, counts)

    t0 = time.perf_counter()
    eng = E.build_engine(cfg, seed=0, max_seq=2048, device=dev,
                         flash_dir=str(ROOT / "build" / flash))
    engine_line(tag, cfg, t0, dev, f"; quantization {cfg.quant}")
    specs, arrivals = make_trace(cfg.vocab_size, seed=11, requests=PAPER_REQUESTS)
    # the second prompt that shares the trace's 256-token prefix arrives
    # last, when the first has been prefilled past it: the pool adopts it
    specs = [specs[i] for i in (0, 1, 2, 4, 5, 3)]
    log(f"[{tag}] trace: prompts {[len(p) for p in specs]}, arrivals {arrivals}; eager")
    with spies if spies is not None else contextlib.nullcontext():
        K.reset_launch_counts()
        loop, reqs, wall = serve_trace(eng, specs, arrivals, max_new=PAPER_NEW)
        counts = K.counts()
    loop.close()
    log(f"[{tag}] launches during the trace: {counts}" + (f"; {spies}" if spies else ""))
    assert all(r.done and len(r.generated) == PAPER_NEW for r in reqs), "unfinished requests"
    assert loop.pool.prefix_hits > 0, "the shared prefix was never adopted"
    check_counts("on the eager EngineLoop", counts, loop_kernels)
    assert eng.dispatch.fallbacks == [], eng.dispatch.fallbacks
    summary = loop_summary(tag, loop, reqs, wall, eng, counts)
    summary["prefix_hits_pages"] = loop.pool.prefix_hits
    summary["graphs"], summary["profile_graphs"] = phase_graphs(
        cfg.name, eng, specs, arrivals, reqs, PAPER_NEW, loop_kernels, spies=spies,
        roofline=tag == "paper")
    check_counts("inside the graphs", summary["graphs"]["launches"], loop_kernels)
    prompt = next(p for p in specs if len(p) > 128)
    summary["kernel_vs_plain"] = compare_paths(f"{cfg.name} EngineLoop", eng,
                                               chunk_then_decode, prompt, prompt[128])
    with spies if spies is not None else contextlib.nullcontext():
        summary["generate"] = phase_generate(eng, tag=tag, kernels=generate_kernels,
                                             profile=False)
    check_counts("on Engine.generate", summary["generate"]["launches"], generate_kernels)
    if spies is not None:
        log(f"[{tag}] {spies}")
        spies.check(VARIANT_KERNELS, variant)
        summary["variant_launches"] = {k: dict(v) for k, v in spies.by_variant.items()}
    summary["device_memory_gib"] = torch.cuda.memory_allocated(dev) / 2**30
    return [eng], summary


def phase_paper(dev, results: dict):
    """The paper's two dense evaluation models at full width and depth
    under the default quantization (W4A8, int8 lm_head and keys, fp8
    values): llama3-8b (32 layers, 32/8 heads, d_ff 14336, vocab 128256)
    and qwen2-1.5b (28 layers, 12/2 heads: G = 6, d_model 1536, tied
    embeddings), each through ``serve_dense`` and released before the
    next.  Returns (an empty holder, summary)."""
    from repro_torch.configs import registry
    out = {}
    for arch in ("llama3-8b", "qwen2-1.5b"):
        t_p = time.perf_counter()
        holder, out[arch] = serve_dense(dev, "paper", registry.get(arch),
                                        f"flash-{arch}", LOOP_KERNELS,
                                        idle_kernels=("grouped_matmul",))
        free_engine("paper", holder)
        drop_flash(f"flash-{arch}")
        out[arch]["phase_s"] = time.perf_counter() - t_p
        log(f"[paper] {arch} took {out[arch]['phase_s']:.1f} s")
    return [], out


def phase_quantvar(dev, results: dict):
    """qwen2-1.5b at full width and depth under ``QuantConfig(kv_key_bits=4,
    kv_value_fp8=False, act_bits=16, group_size=128)``, built as the JAX
    package's tests build variants (``dataclasses.replace(cfg, quant=...)``):
    the paged pool and the dense caches hold int4 keys and bf16 values, and
    every linear takes the reference's float path (A16, groups of 128).
    ``serve_dense`` with kernels 2, 3 and 4 on the loop (kernel 1 never),
    kernels 6, 7 and 4 on ``Engine.generate``, the float path's count
    positive, and every attention launch over int4 keys and bf16 values."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.core import quantization as Q
    cfg = dataclasses.replace(registry.get("qwen2-1.5b"), quant=Q.QuantConfig(**QUANTVAR))
    FLOAT_PATH["allowed"] = True
    try:
        holder, summary = serve_dense(
            dev, "quantvar", cfg, "flash-quantvar",
            ("paged_quant_decode_attention", "paged_flash_prefill_attention", "rmsnorm"),
            idle_kernels=("w4a8_matmul", "grouped_matmul"),
            generate_kernels=("quant_decode_attention", "flash_prefill_attention", "rmsnorm"),
            float_path=True, spies=VariantSpies(), variant="int4/torch.bfloat16")
        from repro_torch import kernels as K
        K.reset_launch_counts()
    finally:
        FLOAT_PATH["allowed"] = False
    summary["quant"] = dict(QUANTVAR)
    return holder, summary


# new tokens of the variant's spill runs: with prefix sharing off the four
# rows' KV outgrows the pool within them (cold pages, two waves), and the
# fifth request's wait ends in a preemption
SPILL_VARIANT_NEW = 8
SPILL_VARIANT_PATIENCE = 4


def phase_spill_variant(eng) -> dict:
    """``[spill]``'s oversubscribed pool on ``[quantvar]``'s engine: int4
    keys and bf16 values move between the pool, the staging reserve and
    Flash (``read_pages``/``write_pages``, the page spill store).  The
    spill trace's four (five) prompts of 830-900 tokens on a
    ``SPILL_POOL_PAGES``-page pool, eagerly, ``SPILL_VARIANT_NEW`` new
    tokens each, prefix sharing off: cold pages spilled and 2+ staging
    waves, then with the fifth request queued and queue patience a
    preemption to Flash and its restore; each run token-equal to an
    all-DRAM loop's tokens, the reserve returned and nothing left on Flash;
    every kernel 2 and 3 launch read int4 keys and bf16 values.  (``[spill]``
    itself also runs sharing on: the variants change no page's sharing.)
    Every loop decodes the max_slots batch: a wave's smaller bucket would
    change the float path's row count, and with it the order of its float32
    sums."""
    from repro_torch import kernels as K
    from repro_torch.runtime import plan as RP
    from repro_torch.serving import engine as E
    specs = spill_trace(eng.cfg.vocab_size)
    pb = RP.kv_page_bytes(eng.cfg, RP.kv_page_size(eng.max_seq))
    kernels = ("paged_quant_decode_attention", "paged_flash_prefill_attention")

    def loop_of(**kw):
        return E.EngineLoop(eng, max_slots=4, prefill_chunk=128, prefill_token_budget=256,
                            bucketing=False, cuda_graphs=False, **kw)
    new = SPILL_VARIANT_NEW
    ref = loop_of()
    eng.stats = E.EngineStats()
    want, _, _ = drive_spill(ref, specs, max_new=new)
    ref.close()
    spies = VariantSpies()
    K.reset_launch_counts()
    runs, _ = spill_runs(eng, "[spill] quantvar", functools.partial(
        loop_of, dram_budget_bytes=SPILL_POOL_PAGES * pb), specs, want, (
        ("no_sharing", {"prefix_sharing": False}, 4, new),
        ("patience", {"prefix_sharing": False, "preempt_patience": SPILL_VARIANT_PATIENCE}, 5,
         new)), spies=spies)
    assert runs["no_sharing"]["cold_spilled_pages"] > 0, runs["no_sharing"]
    counts = K.counts()
    for name in kernels + ("rmsnorm", "float_matmul"):
        assert counts[name] > 0, f"{name} never ran on the variant spill path: {counts}"
    assert counts["w4a8_matmul"] == 0, counts
    spies.check(kernels, "int4/torch.bfloat16")
    assert eng.dispatch.fallbacks == [], eng.dispatch.fallbacks
    log(f"[spill] quantvar: launches {counts}; {spies}")
    return {"runs": runs, "launches": counts, "pool_page_bytes": pb,
            "variant_launches": {k: dict(v) for k, v in spies.by_variant.items()}}


def phase_dbrx(dev, results: dict):
    """dbrx-132b at full width (d_model 6144, 48/8 heads, 16 experts top-4
    of d_ff 10752 in every layer, vocab 100352) and 16 of its 40 layers,
    from seed 0, cut as grok-1 is: the 40 layers' ~66 GB of int4 weights
    and their random init do not fit the script's time.  ``grouped_matmul``
    at its layer 0's expert tables (decode 4 rows x top-4 by id, a chunk's
    live rows), then a 4-request trace through ``EngineLoop`` eagerly and on
    its graphs, both MoE branches through the grouped kernel (chunks by
    live-row counts, decode by expert id, no ``take_experts``), one chunk
    and one decode step kernel vs plain."""
    import dataclasses
    from repro_torch import kernels as K
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as E

    full = registry.get("dbrx-132b")
    cfg = dataclasses.replace(full, num_layers=DBRX_LAYERS)
    log(f"[dbrx] reduced: depth {DBRX_LAYERS} of {full.num_layers} layers (every width "
        "kept): the 40 layers' int4 weights, about 66 GB, and their random init do not "
        "fit the script's time")
    t0 = time.perf_counter()
    eng = E.build_engine(cfg, seed=0, max_seq=2048, device=dev,
                         flash_dir=str(ROOT / "build" / "flash-dbrx"))
    engine_line("dbrx", cfg, t0, dev, f"; {cfg.num_experts} experts top-"
                f"{cfg.experts_per_tok}")
    moe0 = T.layer_slice(eng.params["stacks"][0][0]["moe"], 0)
    top = cfg.experts_per_tok
    summary = {"reduced": {"num_layers": [full.num_layers, DBRX_LAYERS]},
               "grouped": grouped_rows("dbrx-132b gate/up", moe0["w_gate"]["w"], results, top)
               + grouped_rows("dbrx-132b down", moe0["w_down"]["w"], results, top)}
    del moe0
    specs, arrivals = make_trace(cfg.vocab_size, seed=12, requests=4)
    log(f"[dbrx] trace: prompts {[len(p) for p in specs]}, arrivals {arrivals}; eager")
    spy = MoeSpies()
    with spy:
        K.reset_launch_counts()
        loop, reqs, wall = serve_trace(eng, specs, arrivals, max_new=BIG_NEW)
        counts = K.counts()
    loop.close()
    log(f"[dbrx] launches during the trace: {counts}; {spy}")
    assert all(r.done and len(r.generated) == BIG_NEW for r in reqs), "unfinished requests"
    for name in MOE_KERNELS:
        assert counts[name] > 0, f"{name} never launched on dbrx's EngineLoop: {counts}"
    spy.check()
    assert eng.dispatch.fallbacks == [], eng.dispatch.fallbacks
    summary.update(loop_summary("dbrx", loop, reqs, wall, eng, counts))
    summary["grouped_matmul_by_branch"] = spy.by_branch
    graph_spy = MoeSpies()
    summary["graphs"], summary["profile_graphs"] = phase_graphs(
        "dbrx-132b", eng, specs, arrivals, reqs, BIG_NEW, MOE_KERNELS, spies=graph_spy)
    log(f"[graphs] dbrx-132b: at warmup {graph_spy}")
    graph_spy.check()
    prompt = next(p for p in specs if len(p) > 128)
    summary["kernel_vs_plain"] = compare_paths("dbrx-132b EngineLoop", eng,
                                               chunk_then_decode, prompt, prompt[128])
    return [eng], summary


def drop_flash(name: str) -> None:
    """Delete a phase's Flash embedding (the card machine's disk is finite)."""
    import shutil
    shutil.rmtree(ROOT / "build" / name, ignore_errors=True)



def later_wstream(label: str, holder: list, wstream: dict, big: dict,
                  timings: dict) -> None:
    """The ``[wstream]`` parts that take over a later phase's engine before
    it is released: gemma3-27b's windowed stack and rwkv6-7b's rwkv stack at
    full depth, and ``[quantvar]``'s qwen2-1.5b through ``[spill]``'s
    oversubscribed pool and then streamed (its group-wise A16 blobs).
    jamba-1.5-large-398b at ``JAMBA_LAYERS`` layers is one stack of two
    groups, which the policy keeps resident (a ring of two slots would hold
    the whole stack), as the reference's does: the check says so."""
    import torch
    if label == "jamba":
        eng = holder[0]
        pol = eng.plan.weight_placement(eng.cfg, 1, expert_granular=False)
        count = eng.cfg.layer_plan()[0][1]
        assert count < 3 and not pol.active, pol
        log(f"[wstream] jamba-1.5-large-398b ({JAMBA_LAYERS} of 72 layers): not streamed: "
            f"its one stack has {count} groups of ~{pol.resident_bytes / count / 1e9:.1f} GB "
            "and a 2-group stack stays resident under any budget (a ring cannot hold a strict "
            "subset of it)")
        wstream["jamba-1.5-large-398b"] = {"streamed": False, "groups": count,
                                           "policy_resident_bytes": pol.resident_bytes}
        return
    parts = {"gemma3": ("gemma3-27b", WSTREAM_GEMMA, {"warmup": False}),
             "rwkv6": ("rwkv6-7b", WSTREAM_RWKV, {"kernels": RWKV_KERNELS, "warmup": False}),
             "quantvar": ("qwen2-1.5b quantvar", WSTREAM_QUANTVAR, {"warmup": False,
                 "kernels": ("paged_quant_decode_attention", "paged_flash_prefill_attention",
                             "rmsnorm"),
                 "idle_kernels": ("w4a8_matmul", "grouped_matmul"), "float_path": True})}
    if label not in parts:
        return
    name, (ring, lens, new, seed), kw = parts[label]
    FLOAT_PATH["allowed"] = label == "quantvar"
    try:
        if label == "quantvar":
            t0 = time.perf_counter()
            big[label]["spill"] = phase_spill_variant(holder[0])
            big[label]["spill"]["phase_s"] = time.perf_counter() - t0
            log(f"[spill] quantvar part took {big[label]['spill']['phase_s']:.1f} s")
            timings["spill quantvar"] = timing_split("spill quantvar")
        t0 = time.perf_counter()
        wstream[name] = phase_wstream(holder, name, ring, lens, new, seed=seed, **kw)
        from repro_torch import kernels as K
        K.reset_launch_counts()
    finally:
        FLOAT_PATH["allowed"] = False
    wstream[name]["phase_s"] = time.perf_counter() - t0
    log(f"[wstream] {name} part took {wstream[name]['phase_s']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    timings[f"wstream {name}"] = timing_split(f"wstream {name}")


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
    from repro_torch import kernels as K
    from repro_torch.kernels import loader

    instrument()
    guard_float_path()
    timings = {}
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

    timings["build"] = timing_split("build")
    results: dict = {}
    phase_kernels(dev, results)
    phase_new_kernels(dev, results)
    phase_variant_kernels(dev, results)
    timings["kernels"] = timing_split("kernels")
    ops = phase_ops(dev)
    timings["ops"] = timing_split("ops")
    geometry = phase_geometry(dev)
    timings["geometry"] = timing_split("geometry")
    dryrun = phase_dryrun(dev)
    timings["dryrun"] = timing_split("dryrun")
    eng, specs, arrivals, reqs, summary = phase_main_path(dev)
    summary["graphs"], summary["profile_graphs"] = phase_graphs(
        "qwen2-7b", eng, specs, arrivals, reqs, 32, LOOP_KERNELS, roofline=True)
    summary["profile"] = profile_loop_decode(eng, specs)
    checks = phase_kernel_vs_plain(eng, specs, arrivals, reqs)
    timings["main"] = timing_split("main")
    generate = phase_generate(eng)
    timings["generate"] = timing_split("generate")
    lora = phase_lora(eng, card)
    log(f"[lora] phase took {lora['phase_s']:.1f} s")
    timings["lora"] = timing_split("lora")
    gateway = phase_gateway(eng, card)
    log(f"[gateway] phase took {gateway['phase_s']:.1f} s")
    timings["gateway"] = timing_split("gateway")
    t_spill = time.perf_counter()
    spill = phase_spill(eng)
    spill["phase_s"] = time.perf_counter() - t_spill
    log(f"[spill] phase took {spill['phase_s']:.1f} s")
    timings["spill"] = timing_split("spill")
    t_kv = time.perf_counter()
    kvflash = phase_kvflash(eng, card)
    kvflash["phase_s"] = time.perf_counter() - t_kv
    log(f"[kvflash] phase took {kvflash['phase_s']:.1f} s")
    timings["kvflash"] = timing_split("kvflash")
    t_ws = time.perf_counter()
    holder = [eng]
    del eng
    wstream = {"qwen2-7b": phase_wstream(holder, "qwen2-7b", WSTREAM_DENSE_RING,
                                         [400, 64, 300, 170], 16, seed=5)}
    log(f"[wstream] qwen2-7b part took {time.perf_counter() - t_ws:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    timings["wstream qwen2-7b"] = timing_split("wstream qwen2-7b")
    t_glm = time.perf_counter()
    eng_glm, glm4 = phase_glm4(dev)
    del eng_glm
    glm4["phase_s"] = time.perf_counter() - t_glm
    log(f"[glm4] phase took {glm4['phase_s']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()            # the MoE engine needs the room
    timings["glm4"] = timing_split("glm4")
    torch.cuda.reset_peak_memory_stats(dev)
    eng_moe, moe = phase_moe(dev)
    timings["moe"] = timing_split("moe")
    t_ws = time.perf_counter()
    holder = [eng_moe]
    del eng_moe
    wstream["moonshot-v1-16b-a3b"] = phase_wstream(
        holder, "moonshot-v1-16b-a3b", WSTREAM_MOE_RING, [128, 48, 96, 77], 8, seed=6,
        spies=MoeSpies())
    log(f"[wstream] moonshot-v1-16b-a3b part took {time.perf_counter() - t_ws:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    timings["wstream moonshot"] = timing_split("wstream moonshot")
    big = {}
    for label, phase, flash in (("gemma3", phase_gemma3, "flash-gemma3"),
                                ("qwen110b", phase_big_dense, "flash-qwen110b"),
                                ("grok1", phase_grok, "flash-grok1"),
                                ("rwkv6", phase_rwkv6, "flash-rwkv6"),
                                ("jamba", phase_jamba, "flash-jamba"),
                                ("seamless", phase_seamless, "flash-seamless"),
                                ("qwen2vl", phase_qwen2vl, "flash-qwen2vl"),
                                ("paper", phase_paper, "flash-llama3-8b"),
                                ("quantvar", phase_quantvar, "flash-quantvar"),
                                ("dbrx", phase_dbrx, "flash-dbrx")):
        t_p = time.perf_counter()
        holder, big[label] = phase(dev, results)
        big[label]["phase_s"] = time.perf_counter() - t_p
        log(f"[{label}] phase took {big[label]['phase_s']:.1f} s")
        timings[label] = timing_split(label)
        later_wstream(label, holder, wstream, big, timings)
        free_engine(label, holder)
        drop_flash(flash)
    t_p = time.perf_counter()
    holder, train = phase_train(dev, results, card)
    free_engine("train", holder)
    train["phase_s"] = time.perf_counter() - t_p
    log(f"[train] phase took {train['phase_s']:.1f} s")
    timings["train"] = timing_split("train")
    t_p = time.perf_counter()
    _, train18a = phase_train18a(dev, results, card, train)
    train18a["phase_s"] = time.perf_counter() - t_p
    log(f"[train18a] phase took {train18a['phase_s']:.1f} s")
    timings["train18a"] = timing_split("train18a")
    K.reset_launch_counts()          # the float path ran in no path since [quantvar]

    # launches: the sum over the public ops, the serving paths and training,
    # each counted from zero
    paths = {"kernels/ops.py at qwen2-7b's widths": ops["launches"],
             "EngineLoop qwen2-7b": summary["launches"],
             "EngineLoop qwen2-7b, CUDA graphs": summary["graphs"]["launches"],
             "Engine.generate qwen2-7b": generate["launches"],
             "EngineLoop qwen2-7b, LoRA": lora["launches"],
             "EngineLoop qwen2-7b, LoRA, CUDA graphs": lora["graph_launches"],
             "Engine.generate qwen2-7b, LoRA": lora["generate_launches"],
             "EngineService qwen2-7b, LoRA, CUDA graphs": gateway["launches"],
             "EngineLoop qwen2-7b, Flash tier": spill["launches"],
             "EngineLoop qwen2-7b, Flash tier, CUDA graphs": spill["graph_launches"],
             "decode qwen2-7b, KV spilled to Flash": kvflash["launches"],
             "EngineLoop qwen2-7b, weights streamed": wstream["qwen2-7b"]["launches"],
             "EngineLoop gemma3-27b, weights streamed": wstream["gemma3-27b"]["launches"],
             "EngineLoop rwkv6-7b, weights streamed": wstream["rwkv6-7b"]["launches"],
             "EngineLoop qwen2-1.5b, int4 keys, bf16 values, W4A16 g128, weights streamed":
                 wstream["qwen2-1.5b quantvar"]["launches"],
             "EngineLoop qwen2-1.5b, int4 keys, bf16 values, W4A16 g128, Flash tier":
                 big["quantvar"]["spill"]["launches"],
             "EngineLoop glm4-9b": glm4["launches"],
             "EngineLoop glm4-9b, CUDA graphs": glm4["graphs"]["launches"],
             "Engine.generate glm4-9b": glm4["generate"]["launches"],
             "EngineLoop moonshot-v1-16b-a3b": moe["launches"],
             "EngineLoop moonshot-v1-16b-a3b, CUDA graphs": moe["graphs"]["launches"],
             "EngineLoop moonshot-v1-16b-a3b, experts streamed":
                 wstream["moonshot-v1-16b-a3b"]["launches"],
             "EngineLoop gemma3-27b": big["gemma3"]["launches"],
             "EngineLoop gemma3-27b, CUDA graphs": big["gemma3"]["graphs"]["launches"],
             "Engine.generate gemma3-27b": big["gemma3"]["generate"]["launches"],
             "EngineLoop qwen1.5-110b": big["qwen110b"]["launches"],
             "EngineLoop qwen1.5-110b, CUDA graphs": big["qwen110b"]["graphs"]["launches"],
             f"EngineLoop grok-1-314b ({GROK_LAYERS} of 64 layers)": big["grok1"]["launches"],
             f"EngineLoop grok-1-314b ({GROK_LAYERS} of 64 layers), CUDA graphs":
                 big["grok1"]["graphs"]["launches"],
             "EngineLoop rwkv6-7b": big["rwkv6"]["launches"],
             "EngineLoop rwkv6-7b, CUDA graphs": big["rwkv6"]["graphs"]["launches"],
             "Engine.generate rwkv6-7b": big["rwkv6"]["generate"]["launches"],
             f"EngineLoop jamba-1.5-large-398b ({JAMBA_LAYERS} of 72 layers)":
                 big["jamba"]["launches"],
             f"EngineLoop jamba-1.5-large-398b ({JAMBA_LAYERS} of 72 layers), CUDA graphs":
                 big["jamba"]["graphs"]["launches"],
             f"Engine.generate jamba-1.5-large-398b ({JAMBA_LAYERS} of 72 layers)":
                 big["jamba"]["generate"]["launches"],
             "Engine.generate seamless-m4t-large-v2": big["seamless"]["launches"],
             "EngineLoop qwen2-vl-2b": big["qwen2vl"]["launches"],
             "EngineLoop qwen2-vl-2b, CUDA graphs": big["qwen2vl"]["graphs"]["launches"],
             "Engine.generate qwen2-vl-2b": big["qwen2vl"]["generate"]["launches"],
             **{f"{path} {arch}{how}": launches
                for arch in ("llama3-8b", "qwen2-1.5b")
                for path, how, launches in (
                    ("EngineLoop", "", big["paper"][arch]["launches"]),
                    ("EngineLoop", ", CUDA graphs", big["paper"][arch]["graphs"]["launches"]),
                    ("Engine.generate", "", big["paper"][arch]["generate"]["launches"]))},
             **{f"{path} qwen2-1.5b, int4 keys, bf16 values, W4A16 g128{how}": launches
                for path, how, launches in (
                    ("EngineLoop", "", big["quantvar"]["launches"]),
                    ("EngineLoop", ", CUDA graphs", big["quantvar"]["graphs"]["launches"]),
                    ("Engine.generate", "", big["quantvar"]["generate"]["launches"]))},
             f"EngineLoop dbrx-132b ({DBRX_LAYERS} of 40 layers)": big["dbrx"]["launches"],
             f"EngineLoop dbrx-132b ({DBRX_LAYERS} of 40 layers), CUDA graphs":
                 big["dbrx"]["graphs"]["launches"],
             f"training {TRAIN_ARCH}, {TRAIN_STEPS} AdamW steps": train["launches"],
             **{f"training {arch}"
                + (f" ({r['reduced']['num_layers'][1]} of {r['reduced']['num_layers'][0]} "
                   "layers)" if "reduced" in r else "")
                + f", {TRAIN18A_STEPS} {r['optimizer']} steps": r["launches"]
                for arch, r in train18a["models"].items()}}
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
              "dense_decode_all_shapes": results["quant_decode_attention"]["all_shapes"],
              "dense_prefill_all_shapes": results["flash_prefill_attention"]["all_shapes"],
              "paged_prefill_all_shapes":
                  results["paged_flash_prefill_attention"]["all_shapes"],
              "main_path": summary, "kernel_vs_plain": checks,
              "generate_path": generate, "lora_path": lora, "gateway_path": gateway,
              "spill_path": spill, "kvflash_path": kvflash, "glm4_path": glm4, "moe_path": moe,
              "gemma3_path": big["gemma3"], "qwen1.5-110b_path": big["qwen110b"],
              "grok1_path": big["grok1"], "rwkv6_path": big["rwkv6"],
              "jamba_path": big["jamba"], "seamless_path": big["seamless"],
              "qwen2vl_path": big["qwen2vl"], "paper_paths": big["paper"],
              "quantvar_path": big["quantvar"], "dbrx_path": big["dbrx"],
              "train_path": train, "train18a_paths": train18a, "ops": ops, "geometry": geometry, "dryrun": dryrun,
              "wstream": wstream, "timing_split": timings,
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
