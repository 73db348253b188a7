"""Serving engine — port of ``repro.serving.engine``: the continuous-batching
``EngineLoop`` over the paged quantized KV pool, and the slot-synchronous
``Engine.generate`` over dense per-sequence caches, on the card.

  * The embedding table lives on Flash (C2): every step gathers only its
    tokens' rows from a disk memmap (``core.hybrid_storage``).
  * Weights are W4A8 with an int8 ``lm_head`` (C1), in the packed
    kernel-native layout; every linear, RMSNorm and attention call goes
    through the ``runtime.dispatch.Dispatcher`` to a Hopper kernel.
  * KV is int8 keys / fp8 values in a block-paged pool (C1); one unified
    step runs prompt chunks under a token budget, samples one token per
    decodable row, and decodes the active rows gathered into the smallest
    covering batch bucket.  Prompt prefixes are adopted copy-free from the
    pool's token-hash index.

MoE models decode every slot each step, unbucketed, as the reference loop
does (``disabled_features["decode_bucketing"]`` says why).

The KV pool has the reference's Flash tier (C2): cold prompt pages of
running rows spill to Flash under page pressure and are gathered back into
a staging reserve of device pages before each decode, in as many waves as
the reserve needs; a request preempted under queue patience or page
pressure spills its row to Flash and is restored bit for bit.

So do the weights: an ``Engine`` built with ``weight_dram_budget_bytes``
keeps the stacks that overflow the budget on Flash (``runtime.plan``'s
policy), one blob per layer group (per expert, for an expert-granular MoE
stack), and frees their device memory.  ``EngineLoop`` then runs those
stacks group by group out of a ring of device slots allocated once and
written in place, the next group's Flash read queued while one computes;
an MoE group installs the experts its router history predicts and runs
again when the router picked a cold one.  That split step runs eagerly
(``disabled_features["cuda_graphs"]``).

Multi-LoRA (C7): ``Engine.load_adapter`` loads an adapter's q and v
factors online into registries whose device tables keep their storage;
every step of either path adds the per-row bypass of each row's adapter
(slot 0, the zero adapter, for rows without one).  Until the first adapter
is loaded the steps carry no bypass at all, as the reference's do.

``EngineLoop.warmup`` is the reference's: where the reference pre-compiles
one step graph per decode bucket and per prompt-chunk size, the port
captures one CUDA graph each, replayed by ``step()``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(the tests do); without a card they raise instead of falling back.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import kernels as K
from repro_torch.configs.base import ModelConfig
from repro_torch.core import hybrid_storage as HS
from repro_torch.core import kv_pool as KP
from repro_torch.core import lora as LR
from repro_torch.kernels import loader
from repro_torch.models import transformer as T
from repro_torch.runtime import dispatch as D
from repro_torch.runtime import plan as RP
from repro_torch.serving import sampling as SM
from repro_torch.serving.scheduler import (AdmissionError, ContinuousScheduler,
                                           QueueFullError, Request)

__all__ = ["AdmissionError", "QueueFullError", "Engine", "EngineLoop",
           "EngineStats", "RequestStats", "Request", "TokenEvent",
           "bucket_cover", "build_engine", "percentile", "resolve_device"]

DEFAULT_FLASH_DIR = loader.BUILD_ROOT.parent / "flash"


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; a CUDA device without a
    card raises — the port never quietly runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch path on the CPU")
    return dev


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bucket_cover(buckets: Sequence[int], wave: Sequence[int], max_slots: int):
    """Gather plan for one decode wave: the smallest ladder bucket covering
    the wave's slots, padded with DISTINCT idle slots (masked inactive;
    their table rows upload as all-trash, so they write nothing).  Returns
    (slot_idx int32 [bucket], active bool [bucket]), wave slots first."""
    n = len(wave)
    bucket = next(b for b in buckets if b >= n)
    idx = sorted(int(s) for s in wave)
    taken = set(idx)
    for s in range(max_slots):
        if len(idx) >= bucket:
            break
        if s not in taken:
            idx.append(s)
    if len(idx) != bucket:
        raise ValueError(f"cannot cover {tuple(wave)} with {tuple(buckets)} "
                         f"over {max_slots} slots")
    active = np.zeros((bucket,), bool)
    active[:n] = True
    return np.asarray(idx, np.int32), active


@dataclasses.dataclass
class RequestStats:
    """Per-request serving latency record."""
    uid: int
    ttft_s: float          # arrival -> first token
    tpot_s: float          # mean inter-token time after the first
    latency_s: float       # arrival -> completion
    new_tokens: int
    preemptions: int = 0


def percentile(xs: Sequence[float], p: float) -> float:
    if not xs:
        return 0.0
    return float(np.percentile(np.asarray(xs, np.float64), p))


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One committed token, emitted by ``EngineLoop.step()`` when the
    sampling phase appends it.  ``done`` marks the request's final token."""
    uid: int
    token: int
    index: int
    done: bool
    request: Request = dataclasses.field(repr=False, compare=False)


@dataclasses.dataclass
class EngineStats:
    prefill_tokens: int = 0
    decode_tokens: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    flash_bytes: int = 0
    # the spill tier: pool pages moved to / back from Flash by preemption,
    # cold pages of running rows moved to Flash, evictions, and the staging
    # accounting (a hit is a needed cold page already staged or served
    # through the prefetch pipeline; a miss a synchronous Flash read)
    spilled_pages: int = 0
    restored_pages: int = 0
    cold_spilled_pages: int = 0
    preemptions: int = 0
    flash_page_hits: int = 0
    flash_page_misses: int = 0
    flash_hit_rates: List[float] = dataclasses.field(default_factory=list)
    # prefix sharing: prompt tokens adopted from the page index, and prompt
    # chunks run by the unified step
    shared_prompt_tokens: int = 0
    prefill_chunks: int = 0
    # step graphs: CUDA graphs the loop has captured (one per decode bucket
    # and prompt-chunk size), and those captured after warmup() -- 0 means
    # the hot loop never captured once warmed
    compile_events: int = 0
    recompiles_after_warmup: int = 0
    # weight streaming: layer groups (and expert slices) served through the
    # prefetch pipeline vs synchronous Flash reads, the seconds the loop
    # waited for Flash, and the device bytes of resident weights and rings
    weight_group_hits: int = 0
    weight_group_misses: int = 0
    weight_stall_s: float = 0.0
    dram_weight_bytes: int = 0
    # router-aware expert streaming, per decode visit of an MoE group: routed
    # experts the prediction had installed (hits) or not (misses), and the
    # Flash bytes fetched vs the install-every-expert baseline
    expert_prefetch_hits: int = 0
    expert_prefetch_misses: int = 0
    expert_bytes_fetched: int = 0
    expert_bytes_baseline: int = 0
    # features the loop resolved off at construction: name -> reason
    disabled_features: Dict[str, str] = dataclasses.field(default_factory=dict)
    requests: List[RequestStats] = dataclasses.field(default_factory=list)

    @property
    def prefill_tps(self) -> float:
        return self.prefill_tokens / self.prefill_s if self.prefill_s else 0.0

    @property
    def decode_tps(self) -> float:
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0

    @property
    def flash_hit_rate(self) -> float:
        """Aggregate staging hit rate (1.0 when no page was ever cold)."""
        total = self.flash_page_hits + self.flash_page_misses
        return self.flash_page_hits / total if total else 1.0

    @property
    def weight_stream_hit_rate(self) -> float:
        """Share of streamed weight fetches served through the prefetch
        pipeline (1.0 when nothing streams)."""
        total = self.weight_group_hits + self.weight_group_misses
        return self.weight_group_hits / total if total else 1.0

    @property
    def expert_prefetch_hit_rate(self) -> float:
        """Share of routed experts the router-history prediction had
        installed when their group ran (1.0 when no expert stack streams)."""
        total = self.expert_prefetch_hits + self.expert_prefetch_misses
        return self.expert_prefetch_hits / total if total else 1.0

    @property
    def expert_bytes_saved_frac(self) -> float:
        """Share of whole-group streaming's Flash traffic that per-expert
        fetches avoided on the decode path (0.0 when none streams)."""
        if not self.expert_bytes_baseline:
            return 0.0
        return 1.0 - self.expert_bytes_fetched / self.expert_bytes_baseline

    def ttft(self, p: float = 50.0) -> float:
        return percentile([r.ttft_s for r in self.requests], p)

    def tpot(self, p: float = 50.0) -> float:
        return percentile([r.tpot_s for r in self.requests], p)

    def latency(self, p: float = 50.0) -> float:
        return percentile([r.latency_s for r in self.requests], p)


def _alloc_slot(specs, device: torch.device):
    """One device byte buffer laid out as ``HS.leaf_offsets(specs)`` and a
    typed view of each leaf in it."""
    offsets, total = HS.leaf_offsets(specs)
    buf = torch.empty((total,), dtype=torch.uint8, device=device)
    return buf, HS.leaf_views(buf, specs, offsets)


def _slot_tree(skeleton, leaves):
    """The group parameter tree of ``skeleton`` (meta tensors) with its
    leaves, in ``RP.tree_leaves_with_path`` order, taken from ``leaves``."""
    it = iter(leaves)
    return RP.map_tree(lambda _meta: next(it), skeleton)


class WeightRing:
    """A ring of device slots for ONE streamed stack.  Group ``g`` runs out
    of slot ``g % ring_groups``, so with at least 2 slots the group computing
    and the group installing never share one.  Each slot is one byte buffer
    allocated once, with the group's leaves as views into it; an install is
    one non-blocking copy of a fetched blob (pinned, laid out as the slot)
    into it.  The copies and the launches share one stream, so an install
    into a slot runs after every launch that reads the group before it."""

    def __init__(self, store: HS.WeightGroupStore, stack: int, count: int,
                 ring_groups: int, skeleton, device: torch.device):
        if ring_groups < 2:
            raise ValueError("the ring must double-buffer")
        self.store = store
        self.stack = stack
        self.count = count
        self.ring_groups = ring_groups
        specs = [(tuple(t.shape), t.dtype) for _p, t in RP.tree_leaves_with_path(skeleton)]
        self.buffers, self.slots = [], []
        for _ in range(ring_groups):
            buf, leaves = _alloc_slot(specs, device)
            self.buffers.append(buf)
            self.slots.append(_slot_tree(skeleton, leaves))
        self.slot_group = [-1] * ring_groups
        self.stall_s = 0.0                # waiting for Flash
        self.installs = 0

    def slot_of(self, group: int) -> int:
        return group % self.ring_groups

    def prefetch(self, group: int) -> None:
        # a group already in its slot needs no read (a fetch nobody takes
        # would only hold host memory)
        if 0 <= group < self.count and self.slot_group[self.slot_of(group)] != group:
            self.store.prefetch_group(self.stack, group)

    def obtain(self, group: int):
        """The group's parameter tree, installing it into its slot if the
        slot holds another group (waiting for an in-flight prefetch, counted
        in ``stall_s``, or reading Flash on a miss)."""
        r = self.slot_of(group)
        if self.slot_group[r] != group:
            t0 = time.perf_counter()
            blob = self.store.fetch_group(self.stack, group)
            self.stall_s += time.perf_counter() - t0
            self.buffers[r].copy_(blob.buffer, non_blocking=True)
            self.slot_group[r] = group
            self.installs += 1
        return self.slots[r]


class ExpertWeightRing:
    """A ring of device slots for ONE expert-granular streamed MoE stack.
    Slot ``g % ring_groups`` holds the group's shared leaves (router, norms,
    attention: one byte buffer, one copy an install) and the full ``[E,
    ...]`` expert tables, zeroed at allocation, into which each expert's
    slice installs on its own (one copy a leaf into ``table[e]``) -- only
    for the experts the router history predicts or the step picked.  An
    expert never installed reads as zeros, one last installed for another
    group as stale; the selected-expert path reads experts by id, so one it
    does not route to is never read, and the loop runs the group again
    after installing any routed expert that was cold."""

    def __init__(self, store: HS.WeightGroupStore, stack: int, count: int,
                 ring_groups: int, experts: int, skeleton, flags: Sequence[bool],
                 device: torch.device):
        if ring_groups < 2:
            raise ValueError("the ring must double-buffer")
        self.store = store
        self.stack = stack
        self.count = count
        self.ring_groups = ring_groups
        self.experts = experts
        metas = [t for _p, t in RP.tree_leaves_with_path(skeleton)]
        shared = [(tuple(t.shape), t.dtype) for t, f in zip(metas, flags) if not f]
        self.shared_buf, self.tables, self.slots = [], [], []
        for _ in range(ring_groups):
            buf, shared_leaves = _alloc_slot(shared, device)
            tables = [torch.zeros(t.shape, dtype=t.dtype, device=device)
                      for t, f in zip(metas, flags) if f]
            s_it, t_it = iter(shared_leaves), iter(tables)
            self.shared_buf.append(buf)
            self.tables.append(tables)
            self.slots.append(_slot_tree(skeleton, [next(t_it) if f else next(s_it)
                                                    for f in flags]))
        self.slot_group = [-1] * ring_groups          # the shared leaves' group
        self.exp_group = [[-1] * experts for _ in range(ring_groups)]
        self.stall_s = 0.0
        self.installs = 0                 # shared-leaf installs
        self.expert_installs = 0          # per-expert slice installs

    def slot_of(self, group: int) -> int:
        return group % self.ring_groups

    def installed(self, group: int) -> set:
        """Experts whose slices of ``group`` are in its slot now."""
        r = self.slot_of(group)
        return {e for e in range(self.experts) if self.exp_group[r][e] == group}

    def prefetch(self, group: int, experts) -> None:
        """Queue the group's shared leaves and the given experts' slices for
        background reads, skipping what is installed."""
        if not (0 <= group < self.count):
            return
        r = self.slot_of(group)
        if self.slot_group[r] != group:
            self.store.prefetch_group(self.stack, group)
        for e in experts:
            e = int(e)
            if 0 <= e < self.experts and self.exp_group[r][e] != group:
                self.store.prefetch_expert(self.stack, group, e)

    def ensure(self, group: int, experts) -> Tuple[int, bool]:
        """Install the group's shared leaves and the given experts' slices
        into its slot.  Returns (expert slices installed, whether the shared
        leaves were)."""
        r = self.slot_of(group)
        shared_new = False
        if self.slot_group[r] != group:
            t0 = time.perf_counter()
            blob = self.store.fetch_group(self.stack, group)
            self.stall_s += time.perf_counter() - t0
            self.shared_buf[r].copy_(blob.buffer, non_blocking=True)
            self.slot_group[r] = group
            self.installs += 1
            shared_new = True
        n_new = 0
        for e in sorted({int(e) for e in experts}):
            if self.exp_group[r][e] == group:
                continue
            t0 = time.perf_counter()
            blob = self.store.fetch_expert(self.stack, group, e)
            self.stall_s += time.perf_counter() - t0
            for table, piece in zip(self.tables[r], blob.leaves):
                table[e].copy_(piece, non_blocking=True)
            self.exp_group[r][e] = group
            self.expert_installs += 1
            n_new += 1
        return n_new, shared_new

    def obtain(self, group: int):
        """The group's parameter tree (``ensure`` it first)."""
        r = self.slot_of(group)
        if self.slot_group[r] != group:
            raise RuntimeError(f"group {group} is not installed: ensure() it first")
        return self.slots[r]


class Engine:
    """Model parameters (resident on ``device``), the Flash embedding, the
    dispatcher and the serving stats.  With ``weight_dram_budget_bytes`` the
    stacks that overflow it are exported to Flash at construction and
    dropped from ``params`` (``weight_policy``, ``weight_store``); their
    device memory is freed once the caller holds no reference to the tree
    it passed in."""

    def __init__(self, cfg: ModelConfig, params: dict,
                 embedding: HS.EmbeddingStore, max_seq: int = 256,
                 device=None, backend: str = "kernel",
                 weight_dram_budget_bytes: Optional[int] = None,
                 weight_ring_groups: int = 2, expert_streaming: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.plan = RP.ExecutionPlan(quant_tag=cfg.quant.tag(), params=params)
        self.params = params
        self.dispatch = D.Dispatcher(backend=backend)
        self.max_seq = max_seq
        self.embedding = embedding
        self.stats = EngineStats()
        # multi-LoRA (C7): online-loaded adapter registries for q/v
        hd = cfg.resolved_head_dim
        self.lora_q = LR.LoraRegistry(cfg.d_model, cfg.num_heads * hd,
                                      max_rank=8, device=self.device)
        self.lora_v = LR.LoraRegistry(cfg.d_model, cfg.num_kv_heads * hd,
                                      max_rank=8, device=self.device)
        self.weight_policy = self.plan.weight_placement(
            cfg, weight_dram_budget_bytes, ring_groups=weight_ring_groups,
            expert_granular=expert_streaming)
        self.weight_store: Optional[HS.WeightGroupStore] = None
        # stack -> (group skeleton: meta tensors, per-leaf expert flags)
        self._stream_skel: Dict[int, tuple] = {}
        if self.weight_policy.active:
            self._export_streamed_stacks()
        self.stats.dram_weight_bytes = self.weight_policy.resident_bytes

    def _export_streamed_stacks(self) -> None:
        """Write each streamed stack to Flash one layer group at a time (an
        expert-granular stack's expert tables one expert at a time, its
        shared leaves in the group's blob) and drop it from ``params``."""
        self.weight_store = HS.WeightGroupStore(
            HS.FlashStore(self.embedding.flash.root),
            pin_memory=self.device.type == "cuda")
        stacks = list(self.params["stacks"])
        for sp in self.weight_policy.streamed:
            si = sp.stack
            paths, leaves = zip(*RP.tree_leaves_with_path(stacks[si]))
            flags = [bool(sp.experts) and RP.is_expert_path(p) for p in paths]
            for g in range(sp.count):
                self.weight_store.put_group(
                    si, g, [t[g] for t, f in zip(leaves, flags) if not f])
                if sp.experts:
                    tables = [t[g].cpu() for t, f in zip(leaves, flags) if f]
                    for e in range(sp.experts):
                        self.weight_store.put_expert_group(
                            si, g, e, [tab[e] for tab in tables])
            self._stream_skel[si] = (
                RP.map_tree(lambda t: torch.empty(t.shape[1:], dtype=t.dtype,
                                                  device="meta"), stacks[si]),
                flags)
            stacks[si] = None
        self.params = dict(self.params, stacks=tuple(stacks))
        self.plan.params = self.params

    def close(self) -> None:
        """Stop the weight store's prefetch worker and delete the streamed
        stacks' blobs from Flash (the engine serves no streamed step after)."""
        if self.weight_store is not None:
            self.weight_store.drop_all()

    # --- multi-LoRA (C7) ------------------------------------------------------
    def load_adapter(self, name: str, q_ab, v_ab) -> None:
        """Online-load one adapter: q_ab/v_ab = (A [d, r], B [r, out]).  The
        device tables are written in place on the current stream."""
        self.lora_q.load(name, *q_ab)
        self.lora_v.load(name, *v_ab)

    def _lora_ids(self, requests: Sequence[Optional[Request]],
                  rows: Optional[Sequence[int]] = None) -> Optional[List[int]]:
        """Per-row adapter slots (``None`` entries, empty continuous-batching
        slots, select the zero adapter), or None while no adapter is loaded;
        an adapter name nobody loaded raises ``KeyError`` then."""
        if not self.lora_q._names:
            return None
        ids = [self.lora_q.slot(r.adapter) if r is not None else 0
               for r in requests]
        if rows is not None:
            ids = [ids[int(i)] for i in rows]
        return ids

    def _lora_tables(self, ids: torch.Tensor) -> dict:
        """The step-side LoRA argument: the device tables and ``ids`` [B]."""
        qa, qb = self.lora_q.device_tables()
        va, vb = self.lora_v.device_tables()
        return {"wq_a": qa, "wq_b": qb, "wv_a": va, "wv_b": vb, "ids": ids}

    def _lora_for(self, requests: Sequence[Optional[Request]],
                  rows: Optional[Sequence[int]] = None) -> Optional[dict]:
        """Per-row adapter tables (the reference's), None while no adapter
        is loaded."""
        ids = self._lora_ids(requests, rows)
        if ids is None:
            return None
        return self._lora_tables(torch.tensor(ids, dtype=torch.int64,
                                              device=self.device))

    def embed(self, token_ids: np.ndarray,
              out: Optional[HS.StagedBuffer] = None) -> torch.Tensor:
        """bf16 rows gathered from Flash (C2), on the engine's device; with
        ``out``, copied without a host wait into its target (returned)."""
        rows = self.embedding.lookup(token_ids, self.device, out=out)
        self.stats.flash_bytes = self.embedding.flash.bytes_read
        return rows

    def generate(self, requests: Sequence[Request], sampling: SM.SamplingParams,
                 generator: Optional[torch.Generator] = None) -> List[Request]:
        """The slot-synchronous two-phase path: prefill each request into its
        own dense cache, concatenate the caches on the batch axis, then
        decode the batch until every request is done.  As in the reference,
        the batch decodes at request 0's position (one scalar ``pos``), so
        requests must have prompts of equal length to decode correctly.
        Each request's adapter rides along (its prompt alone, then its row
        of the batch)."""
        if self.weight_policy.active:
            raise RuntimeError("weight streaming requires the EngineLoop step path")
        cfg = self.cfg
        gen = generator or torch.Generator(device=self.device).manual_seed(0)
        caches, last_logits = [], []
        t0 = time.perf_counter()
        for ri, req in enumerate(requests):
            toks = np.asarray(req.prompt_tokens)[None, :]
            logits, cache = T.prefill(self.params, cfg, self.embed(toks),
                                      self.max_seq, self.dispatch,
                                      lora=self._lora_for(requests, rows=[ri]))
            caches.append(cache)
            last_logits.append(logits)
            self.stats.prefill_tokens += toks.size
        _sync(self.device)
        self.stats.prefill_s += time.perf_counter() - t0

        cache = _concat_caches(caches)
        logits = torch.cat(last_logits, dim=0)
        lora = self._lora_for(requests)
        t0 = time.perf_counter()
        for _ in range(sampling.max_new_tokens):
            tok_np = SM.sample(logits, sampling, cfg.vocab_size, gen).cpu().numpy()
            for ri, req in enumerate(requests):
                if not req.done:
                    req.generated.append(int(tok_np[ri]))
                    if sampling.eos_token >= 0 and tok_np[ri] == sampling.eos_token:
                        req.done = True
                    elif len(req.generated) >= req.max_new_tokens:
                        req.done = True
            if all(r.done for r in requests):
                break
            # C2: the next token's embedding row comes from Flash
            logits, cache = T.decode_step(self.params, cfg, self.embed(tok_np[:, None]),
                                          cache, self.dispatch, lora=lora)
            self.stats.decode_tokens += len(requests)
        _sync(self.device)
        self.stats.decode_s += time.perf_counter() - t0
        return list(requests)


def _concat_caches(caches: List[dict]) -> dict:
    """Per-request dense caches -> one batch: fields with a batch axis
    ([L, B, ...]) are concatenated on it; per-layer lengths and ``pos``
    are taken from request 0, as the reference does."""
    if len(caches) == 1:
        return caches[0]

    def cat(parts):
        if parts[0].dim() <= 1:
            return parts[0]
        return torch.cat(parts, dim=1)

    stacks = tuple(
        tuple(dataclasses.replace(
            entries[0], **{f: cat([getattr(e, f) for e in entries])
                           for f in ("k_q", "k_scale", "k_zero", "v", "length")})
              for entries in zip(*per_stack))
        for per_stack in zip(*[c["stacks"] for c in caches]))
    return {"stacks": stacks, "pos": caches[0]["pos"]}


class EngineLoop:
    """Step-driven continuous-batching loop on the paged KV pool: one unified
    step runs pending prompt chunks and the decode batch together.
    ``submit(req)`` enqueues (``AdmissionError`` for a request that can
    never fit, ``QueueFullError`` past ``max_queue``), ``step()`` advances
    one unified step and returns the ``TokenEvent``s it committed,
    ``poll(uid)`` drains a request's tokens, ``drain()`` steps until idle
    and ``run()`` replays a whole trace.  Per-request TTFT/TPOT/latency land
    in ``engine.stats.requests``.

    Each step shape -- a decode bucket, or the one ``max_slots`` batch when
    bucketing is off, and a prompt-chunk size -- runs on static inputs the
    host fills through pinned twins, so no step makes the host wait for the
    device; the decode step's only wait is sampling's.  On the card each
    shape is captured once as a CUDA graph and replayed: ``warmup()``
    captures them all up front, and a shape met later is captured where it
    is met (counted in ``stats.recompiles_after_warmup``).  A shape's key
    also says whether LoRA is on, as the reference's steps retrace once when
    the first adapter is loaded: adapters loaded before ``warmup()`` are in
    every graph it captures, the first load after it captures each shape
    once more where met, and later loads and unloads capture nothing (the
    adapter tables keep their storage; each row's adapter id is a static
    input).  A capture that fails raises.  ``cuda_graphs=False`` runs the
    same steps eagerly on the card, for comparison only; on the CPU nothing
    is captured.

    Under page pressure (``dram_budget_bytes`` below the trace's KV) the
    Flash tier keeps every request running: cold pages of running rows
    spill (``proactive_spill``, up to ``flash_budget_bytes`` on Flash) and
    each decode stages them back into the reserve past the trash page, wave
    by wave, each wave replaying its bucket's graph; when that is not
    enough the row holding the most DRAM pages is preempted (and, with
    ``preempt_patience``, a long runner when the queue's head has waited
    that many steps), its pages saved to Flash and restored page-exact on
    re-admission; a row caught mid-prefill resumes from its last chunk.
    Every page write lands in the existing pool tensors, so the graphs keep
    reading them.  ``close()`` releases the graphs and stops the Flash
    prefetch worker.

    On an engine whose weights stream (``Engine.weight_policy.active``) each
    step runs the split step at ``max_slots`` shape, eagerly: streamed
    stacks group by group out of rings of device slots this loop allocates,
    each group's Flash read queued one group ahead (wrapping to the next
    step's first); ``disabled_features`` records both gates."""

    def __init__(self, engine: Engine, max_slots: int = 4,
                 token_budget: Optional[int] = None,
                 preempt_patience: int = 0,
                 dram_budget_bytes: Optional[int] = None,
                 prefill_chunk: int = 64,
                 prefill_token_budget: Optional[int] = None,
                 prefix_sharing: bool = True,
                 proactive_spill: bool = True,
                 flash_budget_bytes: Optional[int] = None,
                 default_sampling: Optional[SM.SamplingParams] = None,
                 max_queue: Optional[int] = None,
                 on_token: Optional[Callable[[Request, int, bool], None]] = None,
                 seed: int = 0, cuda_graphs: bool = True):
        cfg = engine.cfg
        self.eng = engine
        self.cfg = cfg
        self.device = engine.device
        self.max_slots = max_slots
        # the reference's geometry, staging reserve included, so that page
        # ids, pool shapes and allocation match it step for step
        self.proactive = proactive_spill
        self.geom = engine.plan.kv_pool_geometry(
            cfg, engine.max_seq, max_slots, dram_budget_bytes=dram_budget_bytes,
            staging_pages=None if self.proactive else 0)
        self.spill_policy = engine.plan.kv_spill_policy(
            cfg, self.geom, max_slots, flash_budget_bytes=flash_budget_bytes)
        self.prefill_chunk = RP.prefill_chunk_schedule(cfg, prefill_chunk,
                                                       self.geom.page_size)
        self.prefill_token_budget = (prefill_token_budget
                                     if prefill_token_budget is not None
                                     else max(prefill_chunk, 64))
        self.pool = KP.KVPoolManager(self.geom, max_slots,
                                     prefix_sharing=prefix_sharing)
        # KV pages spill beside the Flash embedding, with their own byte counts
        self.spill = HS.PageSpillStore(HS.FlashStore(engine.embedding.flash.root))
        self.scheduler = ContinuousScheduler(
            max_slots, engine.max_seq, self.pool, token_budget=token_budget,
            preempt_patience=preempt_patience,
            spill_headroom=self._spill_headroom if self.proactive else None)
        self.cache = T.init_paged_cache(cfg, max_slots, self.geom, self.device)
        self.logits = torch.zeros((max_slots, cfg.padded_vocab_size),
                                  dtype=torch.float32, device=self.device)
        # step graphs: the table and every step's inputs keep their storage
        # (a graph reads them at replay), every output lands in a tensor made
        # before any capture: the pool, cache["pos"], self.logits (decode)
        # and _chunk_logits (prompt chunks)
        self._table = HS.StagedBuffer(self.cache["table"])
        self._chunk_logits = torch.zeros((1, cfg.padded_vocab_size),
                                         dtype=torch.float32, device=self.device)
        self._inputs: Dict[Tuple[str, int, bool], Dict[str, HS.StagedBuffer]] = {}
        self.cuda_graphs = cuda_graphs and self.device.type == "cuda"
        self._graphs: Dict[Tuple[str, int, bool], "torch.cuda.CUDAGraph"] = {}
        self._graph_launches: Dict[Tuple[str, int, bool], Dict[str, int]] = {}
        self._graph_pool = None
        self.warmed = False
        self._warmup_graphs = 0
        self._prefilling: Dict[int, dict] = {}
        self._prefill_rr = 0
        # uid -> spill record of a preempted request (its pages on Flash)
        self._spilled: Dict[int, dict] = {}
        # restored slots that owe one decode of their last sampled token
        # (evicted between sampling and its KV append) before sampling again
        self._hold: set = set()
        self._step_hits = self._step_misses = 0
        self.peak_active = 0
        self.peak_kv_pages = 0
        self.expert_reruns = 0          # MoE groups run again for a cold expert
        self.default_sampling = default_sampling
        self.max_queue = max_queue
        self.on_token = on_token
        self._step_no = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._streams: Dict[int, dict] = {}
        self.rejected = 0
        # batch-size bucketing gathers the active slots into the smallest
        # covering bucket; MoE stacks decode every slot (expert capacity
        # couples the batch's tokens in the reference, which gates them off)
        no_moe = not any(pat.moe for pats, _ in cfg.layer_plan() for pat in pats)
        self._bucketed = no_moe and max_slots > 1
        # weight streaming: the split step runs every streamed stack group by
        # group out of its ring at max_slots shape, as the reference's does.
        # An expert ring installs the experts its router history predicts:
        # per (stack, group), the union of the last two decode visits' picks,
        # starting from every expert, so prediction only ever narrows
        self.wpolicy = engine.weight_policy
        self._wstreams: Dict[int, WeightRing] = {}
        self._expert_rings: Dict[int, ExpertWeightRing] = {}
        self._expert_pred: Dict[tuple, set] = {}
        self._expert_last: Dict[tuple, set] = {}
        # the decode step's active rows on the host (router accounting)
        self._host_active = np.zeros((max_slots,), bool)
        if self.wpolicy.active:
            self._bucketed = False
            for spl in self.wpolicy.streamed:
                skel, flags = engine._stream_skel[spl.stack]
                if spl.experts:
                    self._expert_rings[spl.stack] = ExpertWeightRing(
                        engine.weight_store, spl.stack, spl.count, spl.ring_groups,
                        spl.experts, skel, flags, self.device)
                    for g in range(spl.count):
                        self._expert_pred[(spl.stack, g)] = set(range(spl.experts))
                        self._expert_last[(spl.stack, g)] = set(range(spl.experts))
                else:
                    self._wstreams[spl.stack] = WeightRing(
                        engine.weight_store, spl.stack, spl.count, spl.ring_groups,
                        skel, self.device)
            # the prefetch chain walks the streamed groups in execution order
            # and wraps from the last to the first, so the next step's first
            # read is in flight when the step starts
            seq = [(spl.stack, g) for spl in self.wpolicy.streamed
                   for g in range(spl.count)]
            self._stream_next = {seq[i]: seq[(i + 1) % len(seq)] for i in range(len(seq))}
            self._prefetch_sg(*seq[0])
        self.buckets = engine.plan.decode_buckets(max_slots, uniform=self._bucketed)
        self.disabled_features: Dict[str, str] = {}
        if not self._bucketed:
            self.disabled_features["decode_bucketing"] = (
                "weight streaming: the split step runs at max_slots shape only"
                if self.wpolicy.active
                else "MoE: expert capacity couples tokens across the batch"
                if not no_moe else "max_slots == 1: nothing to bucket")
        if self.wpolicy.active and self.cuda_graphs:
            self.disabled_features["cuda_graphs"] = (
                "weight streaming: the split step installs ring slots on the "
                "host between groups; it runs eagerly")
            self.cuda_graphs = False
        engine.stats.disabled_features = dict(self.disabled_features)

    # --- row snapshot / restore (preemption to Flash) ----------------------
    def _pooled_groups(self):
        """(group name, stacked pool) of every full-attention page pool: the
        layer groups that carry per-page bytes."""
        for si, (patterns, _count) in enumerate(self.cfg.layer_plan()):
            for pi, _pat in enumerate(patterns):
                yield f"s{si}p{pi}", self.cache["stacks"][si][pi]

    def _row_groups(self, phys: Sequence[int]):
        """(group name, host arrays) of a row's decode state: the bytes of
        its DRAM pages ``phys`` in every pooled group (the port's stacks are
        all full-attention pools)."""
        for group, pool in self._pooled_groups():
            yield group, KP.read_pages(pool, phys)

    def _spill_row(self, slot: int, req: Request, pending: bool) -> None:
        """Move a preempted row's DRAM pages to Flash and free them; pages
        the proactive tier already spilled stay there, keyed by uid.
        ``pending``: the row was evicted after sampling and before its
        token's KV append, so the token replays through decode on resume
        instead of sampling again from saved logits."""
        n_kv = int(self.pool.row_pos[slot])
        n_pages = self.pool.pages_for(n_kv)
        held = self.pool.row_pages[slot]
        dram_idxs = [i for i in range(n_pages) if held[i] >= 0]
        flash_idxs = [i for i in range(n_pages) if held[i] < 0]
        groups = []
        for gi, (group, arrays) in enumerate(
                self._row_groups([held[i] for i in dram_idxs])):
            self.spill.put(req.uid, group, arrays,
                           pages=len(dram_idxs) if gi == 0 else 0)
            groups.append(group)
        self._spilled[req.uid] = {
            "n_kv": n_kv, "pending": pending, "groups": groups,
            "dram_idxs": dram_idxs, "flash_idxs": flash_idxs,
            "logits": None if pending else self.logits[slot].clone()}
        req.spilled_flash_pages = len(flash_idxs)
        self.pool.free_row(slot)
        self.eng.stats.spilled_pages += len(dram_idxs)
        self.eng.stats.preemptions += 1
        self.pool.spilled_pages += n_pages
        T.free_slots(self.cache, [slot])
        self._hold.discard(slot)

    def _restore_into_slot(self, req: Request, slot: int, rec: dict) -> None:
        """Bring a spilled row back page-exact: fresh pool pages for its
        snapshot (cold pages stay on Flash and rejoin through staging), each
        layer group read from Flash with the next group prefetched, written
        in place; then sampling resumes from the saved logits, or the slot
        holds one step to replay a pending token.  A mid-prefill victim
        takes pages for its whole prompt and resumes chunking."""
        n_kv = rec["n_kv"]
        pf = rec.get("prefill")
        alloc_tokens = pf["t"] if pf is not None else n_kv
        ok = self.pool.alloc_row(slot, alloc_tokens, flash_idxs=rec["flash_idxs"])
        while not ok and self._spill_one_cold(exclude={slot}):
            ok = self.pool.alloc_row(slot, alloc_tokens,
                                     flash_idxs=rec["flash_idxs"])
        if not ok:
            raise RuntimeError("admission checked that the pages were free "
                               "or spillable")
        req.spilled_flash_pages = 0
        self.pool.spilled_pages -= self.pool.pages_for(n_kv)
        phys = [self.pool.row_pages[slot][i] for i in rec["dram_idxs"]]
        groups = rec["groups"]
        self.spill.prefetch_async(req.uid, groups[0])
        for gi, (group, pool) in enumerate(self._pooled_groups()):
            if gi + 1 < len(groups):
                self.spill.prefetch_async(req.uid, groups[gi + 1])
            KP.write_pages(pool, phys, self.spill.fetch(req.uid, group))
        self.spill.drop_groups(req.uid, groups)
        self.eng.stats.restored_pages += len(rec["dram_idxs"])
        if pf is not None:
            # like a fresh admission, pos stays 0 until the prompt is in
            req.resume_prefill = False
            self._prefilling[slot] = {"req": req, "tokens": pf["tokens"],
                                      "t": pf["t"], "next": n_kv}
            return
        self.cache["pos"][slot].fill_(n_kv)
        self.pool.row_pos[slot] = n_kv
        if rec["pending"]:
            self._hold.add(slot)
        else:
            self.logits[slot].copy_(rec["logits"])

    # --- proactive spill: cold pages of running rows -----------------------
    def _cold_candidates(self) -> List:
        """(logical page, slot) spill candidates over running decode rows,
        oldest page first: full single-owner DRAM pages outside each row's
        hot tail, from rows with staging room left (a row's Flash pages must
        fit the reserve for one wave), capped by the Flash budget left."""
        if not self.proactive:
            return []
        pol = self.spill_policy
        budget_left = pol.flash_budget_pages - self.spill.pages_on_flash
        if budget_left <= 0:
            return []
        out = []
        for slot, req in enumerate(self.scheduler.running):
            if req is None or slot in self._prefilling:
                continue
            room = pol.staging_pages - self.pool.flash_pages_of(slot)
            if room <= 0:
                continue
            out.extend((i, slot) for i in
                       self.pool.cold_pages(slot, pol.hot_pages)[:room])
        out.sort()
        return out[:budget_left]

    def _spill_headroom(self) -> int:
        """Pages admission may oversubscribe the pool by now (the scheduler
        calls this through ``_fits``)."""
        return len(self._cold_candidates())

    def _spill_cold_page(self, slot: int, idx: int) -> None:
        """One cold page of a running row: every pooled group's bytes of it
        to Flash, then its pool page is free; the row keeps decoding, the
        page rejoining each step through the staging reserve."""
        uid = self.scheduler.running[slot].uid
        phys = self.pool.row_pages[slot][idx]
        for gi, (group, pool) in enumerate(self._pooled_groups()):
            self.spill.put_page(uid, idx, group, KP.read_pages(pool, [phys]),
                                count_page=gi == 0)
        self.pool.spill_page(slot, idx)
        self.eng.stats.cold_spilled_pages += 1

    def _spill_one_cold(self, exclude: set = frozenset()) -> bool:
        """Spill the oldest cold candidate; False when none is eligible."""
        for idx, slot in self._cold_candidates():
            if slot not in exclude:
                self._spill_cold_page(slot, idx)
                return True
        return False

    def _proactive_spill(self) -> None:
        """Below the low watermark of free pages, spill cold pages until the
        high watermark (or the candidates run out)."""
        if not self.proactive \
                or self.pool.free_pages >= self.spill_policy.low_watermark:
            return
        while self.pool.free_pages < self.spill_policy.high_watermark \
                and self._spill_one_cold():
            pass

    # --- decode-time staging: gather Flash pages for a wave ----------------
    def _stage_wave(self, needed: List) -> None:
        """Make every (slot, idx) in ``needed`` visible to the kernels:
        staged pages are LRU touches (hits); Flash pages claim a staging
        page (evicting LRU pages the wave does not need) and their group
        blobs stream in from Flash, the next group read ahead while one
        installs.  All the wave's pages of a group reach the pool in one
        copy a field, queued on the stream behind every earlier wave's
        replay; table entries flip to the staging page only at commit."""
        stats = self.eng.stats
        to_fetch = []
        for slot, idx in needed:
            if self.pool.row_res[slot][idx] == KP.RES_STAGED:
                self.pool.begin_stage(slot, idx)
                self._step_hits += 1
                stats.flash_page_hits += 1
            else:
                to_fetch.append((slot, idx))
        if not to_fetch:
            return
        groups = [g for g, _ in self._pooled_groups()]
        uid_of = {slot: self.scheduler.running[slot].uid for slot, _ in to_fetch}
        for slot, idx in to_fetch:
            self.spill.prefetch_page(uid_of[slot], idx, groups[0])
        protect = set(needed)
        updates: Dict[str, list] = {}
        for slot, idx in to_fetch:
            sid = self.pool.begin_stage(slot, idx)
            while sid is None:
                victim = self.pool.stage_victim(protect)
                if victim is None:
                    raise RuntimeError("the staging reserve cannot hold the wave")
                self.pool.unstage(*victim)
                sid = self.pool.begin_stage(slot, idx)
            uid = uid_of[slot]
            m0 = self.spill.prefetch_misses
            for gi, group in enumerate(groups):
                if gi + 1 < len(groups):
                    self.spill.prefetch_page(uid, idx, groups[gi + 1])
                updates.setdefault(group, []).append(
                    (sid, self.spill.fetch_page(uid, idx, group)))
            if self.spill.prefetch_misses > m0:
                self._step_misses += 1
                stats.flash_page_misses += 1
            else:
                self._step_hits += 1
                stats.flash_page_hits += 1
        for group, pool in self._pooled_groups():
            pages = updates[group]
            KP.write_pages(pool, [sid for sid, _ in pages], {
                f: np.concatenate([arrays[f] for _, arrays in pages], axis=1)
                for f in KP.KV_FIELDS})
        for slot, idx in to_fetch:
            self.pool.commit_stage(slot, idx)

    def _plan_waves(self, slots: List[int]) -> List[List[int]]:
        """Partition the decodable slots into staging waves whose Flash
        pages fit the reserve at once; rows with none ride in the first
        wave, so the no-spill steady state is one wave."""
        flashy = {s: self.pool.flash_pages_of(s) for s in slots}
        plain = [s for s in slots if not flashy[s]]
        cap = max(1, self.spill_policy.staging_pages)
        waves: List[List[int]] = []
        cur: List[int] = []
        load = 0
        for s in sorted(s for s in slots if flashy[s]):
            n = flashy[s]
            if n > cap:
                raise RuntimeError(f"row {s} holds {n} Flash pages, more than "
                                   f"the staging reserve of {cap}")
            if cur and load + n > cap:
                waves.append(cur)
                cur, load = [], 0
            cur.append(s)
            load += n
        if cur:
            waves.append(cur)
        if not waves:
            return [plain]
        waves[0] = plain + waves[0]
        return waves

    # --- admission + the unified prefill step ------------------------------
    def _upload_table(self, visible) -> None:
        """Upload the page table with every slot outside ``visible`` masked
        to the trash page (rows mid-prefill, rows of a later staging wave
        and empty rows never see dispatch; their ride-along appends land in
        the trash)."""
        table = self.pool.table
        hidden = [s for s in range(self.max_slots) if s not in visible]
        if hidden:
            table = table.copy()
            table[hidden] = self.geom.trash_page
        self._table.put(table)

    def _admit_into_slot(self, req: Request, slot: int) -> None:
        rec = self._spilled.pop(req.uid, None)
        if rec is not None:
            self._restore_into_slot(req, slot, rec)
            return
        if req.generated:
            raise RuntimeError(f"request {req.uid} was preempted without a "
                               "spill record")
        toks = list(req.prompt_tokens)
        t = len(toks)
        ids = toks if self.pool.prefix_sharing else None
        ok = self.pool.alloc_row(slot, t, token_ids=ids, salt=req.adapter or "")
        while not ok and self._spill_one_cold(exclude={slot}):
            # admission counted the spillable cold pages: deliver them
            ok = self.pool.alloc_row(slot, t, token_ids=ids,
                                     salt=req.adapter or "")
        if not ok:
            raise RuntimeError("admission checked that the pages were free "
                               "or spillable")
        shared = int(self.pool.row_shared[slot])
        self.eng.stats.shared_prompt_tokens += shared
        self._prefilling[slot] = {"req": req, "tokens": toks, "t": t,
                                  "next": shared}

    def _spill_prefilling_row(self, victim: Request) -> None:
        """Evict a mid-prefill row under page pressure: with a chunk done,
        its written pages go to Flash and it resumes from its last chunk
        boundary; with none, it is freed and requeued and its adoption
        statistics are taken back (the re-admission counts them again)."""
        vslot = victim.slot
        st = self._prefilling[vslot]
        done = st["next"]
        self.eng.stats.preemptions += 1
        if done <= 0:
            self.eng.stats.shared_prompt_tokens -= int(self.pool.row_shared[vslot])
            self.pool.retract_prompt_stats(vslot, st["t"])
            self.scheduler.evict(victim)
            del self._prefilling[vslot]
            self.pool.free_row(vslot)
            T.free_slots(self.cache, [vslot])
            return
        n_pages = self.pool.pages_for(done)
        held = self.pool.row_pages[vslot]
        dram_idxs = list(range(n_pages))
        groups = []
        for gi, (group, arrays) in enumerate(
                self._row_groups([held[i] for i in dram_idxs])):
            self.spill.put(victim.uid, group, arrays,
                           pages=n_pages if gi == 0 else 0)
            groups.append(group)
        self._spilled[victim.uid] = {
            "n_kv": done, "pending": False, "groups": groups,
            "dram_idxs": dram_idxs, "flash_idxs": [], "logits": None,
            "prefill": {"t": st["t"], "tokens": st["tokens"]}}
        # the restore adopts nothing: admission charges the whole prompt
        victim.resume_prefill = True
        self.scheduler.evict(victim)
        del self._prefilling[vslot]
        self.pool.free_row(vslot)
        self.eng.stats.spilled_pages += n_pages
        self.pool.spilled_pages += n_pages
        T.free_slots(self.cache, [vslot])

    def _pick_page_victim(self, exclude: set) -> Optional[Request]:
        """Page pressure: the decoding row holding the most DRAM pages
        (excluding ``exclude``); rows restored this step (``_hold``) only as
        a last resort."""
        cands = [r for r in self.scheduler.running
                 if r is not None and r.slot not in exclude
                 and r.slot not in self._prefilling]
        fresh = [r for r in cands if r.slot not in self._hold]
        cands = fresh or cands
        if not cands:
            return None
        return max(cands, key=lambda r: (self.pool.dram_pages_held(r.slot),
                                         len(r.generated)))

    def _next_chunk(self, remaining: int) -> int:
        """Full ``prefill_chunk`` slabs, then one power-of-two final chunk
        (padded; at least 8)."""
        if remaining >= self.prefill_chunk:
            return self.prefill_chunk
        c = 8
        while c < remaining:
            c *= 2
        return c

    def _run_prefill_chunks(self) -> None:
        """Advance prefilling rows by whole chunks until the per-step token
        budget runs out, round-robin across rows and across steps; only the
        step's first chunk may overshoot the budget.  A row whose final
        chunk lands here decodes in this same step."""
        if not self._prefilling:
            return
        eng = self.eng
        budget = self.prefill_token_budget
        t0 = time.perf_counter()
        ran = False
        self._table.put(self.pool.table)
        while budget > 0 and self._prefilling:
            advanced = False
            order = sorted(self._prefilling)
            pivot = sum(1 for s in order if s < self._prefill_rr)
            for slot in order[pivot:] + order[:pivot]:
                if budget <= 0:
                    break
                st = self._prefilling[slot]
                req, toks, t = st["req"], st["tokens"], st["t"]
                c = self._next_chunk(t - st["next"])
                valid = min(c, t - st["next"])
                if ran and valid > budget:
                    continue
                self._prefill_rr = slot + 1
                ids = np.zeros((1, c), np.int64)
                ids[0, :valid] = np.asarray(toks[st["next"]:st["next"] + valid])
                last_idx = t - 1 - st["next"] if st["next"] + c >= t else c - 1
                adapters = self._row_lora(req)
                key = ("chunk", c, adapters is not None)
                self._prepare(key)
                ins = self._inputs[key]
                eng.embed(ids, out=ins["emb"])
                ins["scal"].put((slot, st["next"], last_idx))
                if adapters is not None:
                    ins["lora"].put(adapters)
                self._launch(key)
                st["next"] += valid
                budget -= valid
                ran = advanced = True
                eng.stats.prefill_tokens += valid
                eng.stats.prefill_chunks += 1
                if st["next"] >= t:
                    self.logits[slot] = self._chunk_logits[0]
                    self.cache["pos"][slot].fill_(t)
                    self.pool.row_pos[slot] = t
                    self.pool.register_prefix(slot, toks, salt=req.adapter or "")
                    del self._prefilling[slot]
            if not advanced:
                break
        if ran:
            _sync(self.device)
            eng.stats.prefill_s += time.perf_counter() - t0

    # --- step graphs --------------------------------------------------------
    def _chunk_sizes(self) -> tuple:
        """Every chunk size ``_next_chunk`` can emit: full slabs and the
        power-of-two final chunks, one prompt-chunk graph each."""
        return tuple(sorted({self._next_chunk(r)
                             for r in range(1, self.prefill_chunk + 1)}))

    def _slot_lora(self, rows: Optional[Sequence[int]] = None) -> Optional[List[int]]:
        """The adapter slots of the running rows at ``rows`` (every slot by
        default), or None while no adapter is loaded."""
        return self.eng._lora_ids(self.scheduler.running, rows)

    def _row_lora(self, req: Request) -> Optional[List[int]]:
        return self.eng._lora_ids([req])

    def compile_events(self) -> int:
        """CUDA graphs captured so far (monotonic until ``close``): the
        counterpart of the reference's jit-cache entries.  ``step()``
        mirrors it into ``EngineStats``."""
        return len(self._graphs)

    def _step_body(self, key: Tuple[str, int, bool]) -> None:
        """One step of shape ``key`` on its static inputs: ("decode", b, _)
        reads embeddings [b, 1, d] and rows [2, b] (slot ids, active flags);
        ("chunk", c, _) reads embeddings [1, c, d] and (slot, pos0,
        last_idx); with LoRA on (``key[2]``) also each row's adapter id."""
        eng, ins = self.eng, self._inputs[key]
        run = self._stream_stacks if self.wpolicy.active else None
        lora = eng._lora_tables(ins["lora"].target) if key[2] else None
        if key[0] == "decode":
            rows = ins["rows"].target
            idx, act = rows[0], rows[1] != 0
            logits_b, _ = T.decode_step_bucketed(
                eng.params, self.cfg, ins["emb"].target, self.cache, idx,
                eng.dispatch, active=act, run_stacks=run, lora=lora)
            # pad rows keep their slot's logits: a fixed-shape write (a
            # boolean index would make the host wait for its count)
            self.logits.index_copy_(0, idx, torch.where(
                act[:, None], logits_b, self.logits.index_select(0, idx)))
        else:
            scal = ins["scal"].target
            self._chunk_logits.copy_(T.prefill_chunk_paged(
                eng.params, self.cfg, ins["emb"].target, self.cache, scal[0:1],
                scal[1:2], scal[2:3], eng.dispatch, run_stacks=run, lora=lora))

    # --- the weight-streamed split step -----------------------------------
    def _prefetch_sg(self, si: int, g: int) -> None:
        """Queue group ``g`` of stack ``si``'s Flash reads on its ring (an
        expert ring: the shared leaves and the predicted experts)."""
        ring = self._wstreams.get(si)
        if ring is not None:
            ring.prefetch(g)
        else:
            self._expert_rings[si].prefetch(g, self._expert_pred[(si, g)])

    def _run_expert_group(self, ering: ExpertWeightRing, spl, si: int, g: int,
                          mode: str, x, positions, pos, table, lora) -> torch.Tensor:
        """One expert-granular group: install the shared leaves and the
        predicted experts, run the group, then read the router's picks for
        the active rows; a routed expert that was cold is installed and the
        group runs again (the group is a pure function of its slot and
        inputs, so the last run is the resident step's, KV writes
        included).  Prompt chunks install every expert and are left out of
        the accounting, as are steps with no active row (warmup)."""
        def run(collect=None):
            return T.run_stack_group(ering.obtain(g), self.cfg, si, mode, x,
                                     positions, self.cache, g, pos, table,
                                     self.eng.dispatch, collect=collect, lora=lora)
        if mode != "decode":
            ering.ensure(g, range(spl.experts))
            return run()
        stats = self.eng.stats
        n_new, shared_new = ering.ensure(g, self._expert_pred[(si, g)])
        installed = ering.installed(g)
        collect: dict = {}
        out = run(collect)
        act = self._host_active
        if not act.any():
            return out

        def picked(ids) -> set:      # the readback: one sync a group run
            return {int(e) for e in np.unique(ids.cpu().numpy()[:, act])}
        actual = picked(collect["moe_ids"])
        stats.expert_prefetch_hits += len(actual & installed)
        stats.expert_prefetch_misses += len(actual - installed)
        # more than one re-run only where a group holds several MoE layers
        # (a later router reads what an earlier layer's stale experts made)
        for _ in range(spl.experts):
            missing = actual - ering.installed(g)
            if not missing:
                break
            n_new += ering.ensure(g, missing)[0]
            self.expert_reruns += 1
            collect = {}
            out = run(collect)
            actual = picked(collect["moe_ids"])
        fetched = (spl.shared_bytes if shared_new else 0) + n_new * spl.expert_bytes
        stats.expert_bytes_fetched += fetched
        # whole-group streaming refetches the group when the slot was stale;
        # when it was not, neither moves bytes beyond what was fetched
        stats.expert_bytes_baseline += (spl.shared_bytes + spl.experts * spl.expert_bytes
                                        if shared_new else fetched)
        self._expert_pred[(si, g)] = actual | self._expert_last[(si, g)]
        self._expert_last[(si, g)] = actual
        return out

    def _stream_stacks(self, x, mode: str, positions, pos, table,
                       lora: Optional[dict] = None) -> torch.Tensor:
        """Every stack for one step in the split mode: resident stacks layer
        by layer, streamed ones group by group out of their ring, the chain
        successor's Flash reads queued before each install so they overlap
        the group that computes."""
        eng, cfg = self.eng, self.cfg
        for si, (_patterns, count) in enumerate(cfg.layer_plan()):
            ring = self._wstreams.get(si)
            ering = self._expert_rings.get(si)
            for g in range(count):
                if ring is None and ering is None:
                    gp = tuple(T.layer_slice(p, g) for p in eng.params["stacks"][si])
                    x = T.run_stack_group(gp, cfg, si, mode, x, positions, self.cache, g,
                                          pos, table, eng.dispatch, lora=lora)
                    continue
                self._prefetch_sg(*self._stream_next[(si, g)])
                if ering is not None:
                    x = self._run_expert_group(ering, self.wpolicy.streamed_stack(si), si,
                                               g, mode, x, positions, pos, table, lora)
                else:
                    x = T.run_stack_group(ring.obtain(g), cfg, si, mode, x, positions,
                                          self.cache, g, pos, table, eng.dispatch,
                                          lora=lora)
        return x

    def _prepare(self, key: Tuple[str, int, bool], warm: bool = False) -> None:
        """Make step shape ``key`` ready at its first use: its static inputs
        and, with graphs on (or ``warm``), one eager run -- which sets up what
        a capture cannot: the kernel library, cuBLAS's workspace, RoPE's
        table, scratch -- against the all-trash table with every row
        inactive, so only the trash page and ``_chunk_logits`` change; then,
        with graphs on, its capture."""
        if key in self._inputs:
            return
        kind, n, lora = key
        d, dev = self.cfg.d_model, self.device
        if kind == "decode":
            rows = torch.zeros((2, n), dtype=torch.int64, device=dev)
            rows[0] = torch.arange(n, device=dev)
            ins = {"emb": torch.zeros((n, 1, d), dtype=torch.bfloat16, device=dev),
                   "rows": rows}
        else:
            scal = torch.zeros((3,), dtype=torch.int32, device=dev)
            scal[2] = n - 1
            ins = {"emb": torch.zeros((1, n, d), dtype=torch.bfloat16, device=dev),
                   "scal": scal}
        if lora:
            ins["lora"] = torch.zeros((ins["emb"].shape[0],), dtype=torch.int64, device=dev)
        self._inputs[key] = {k: HS.StagedBuffer(v) for k, v in ins.items()}
        if warm or self.cuda_graphs:
            table = self.cache["table"]
            saved = table.clone()
            table.fill_(self.geom.trash_page)
            self._host_active[:] = False
            try:
                self._step_body(key)
            finally:
                table.copy_(saved)
        if self.cuda_graphs:
            self._capture(key)

    def _capture(self, key: Tuple[str, int, bool]) -> None:
        """Capture step ``key`` as a CUDA graph.  The loop's graphs share one
        memory pool: no graph reads what another's replay writes there, as
        every output lands in a tensor made before capture.  The launches the
        wrappers count during capture are what each replay launches."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = K.launch_counts()
        with loader.capture(graph, pool=self._graph_pool):
            self._step_body(key)
        launched = {n: c - before[n] for n, c in K.launch_counts().items()
                    if c != before[n]}
        K.add_launch_counts({n: -c for n, c in launched.items()})
        self._graphs[key] = graph
        self._graph_launches[key] = launched

    def _launch(self, key: Tuple[str, int, bool]) -> None:
        graph = self._graphs.get(key)
        if graph is None:
            self._step_body(key)
        else:
            graph.replay()
            K.add_launch_counts(self._graph_launches[key])

    def warmup(self) -> dict:
        """Make every step shape the hot loop can need ready: one decode step
        per bucket (the one ``max_slots`` step when bucketing is off) and one
        prompt-chunk step per chunk size, each run against the all-trash
        table with every row inactive, so the pool's pages and the loop's
        state are untouched, and on the card captured, with LoRA on if an
        adapter is loaded.  After this a trace captures nothing
        (``stats.recompiles_after_warmup`` stays 0) unless the first adapter
        is loaded later.
        Idempotent.  Returns {"warmup_s", "graphs", "decode_buckets",
        "chunk_sizes"}; ``graphs`` is 0 where nothing is captured."""
        t0 = time.perf_counter()
        chunks = self._chunk_sizes()
        lora = bool(self.eng.lora_q._names)
        for key in ([("decode", b, lora) for b in self.buckets]
                    + [("chunk", c, lora) for c in chunks]):
            self._prepare(key, warm=True)
        _sync(self.device)
        self.warmed = True
        self._warmup_graphs = self.compile_events()
        self.eng.stats.compile_events = self._warmup_graphs
        return {"warmup_s": time.perf_counter() - t0,
                "graphs": self._warmup_graphs,
                "decode_buckets": [int(b) for b in self.buckets],
                "chunk_sizes": [int(c) for c in chunks]}

    def close(self) -> None:
        """Release the step graphs and their memory pool and stop the Flash
        prefetch worker; a later step prepares (and captures) its shape
        again, ``warmup()`` may be called again, and Flash reads become
        synchronous."""
        self.spill.close()
        for graph in self._graphs.values():
            graph.reset()
        self._graphs.clear()
        self._graph_launches.clear()
        self._inputs.clear()
        self._graph_pool = None
        self.warmed = False
        self._warmup_graphs = 0
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the incremental serving API ---------------------------------------
    def _validate(self, req: Request) -> None:
        need = req.length + req.max_new_tokens
        if need > self.eng.max_seq:
            raise AdmissionError(
                f"request {req.uid}: prompt+decode budget {need} exceeds "
                f"max_seq={self.eng.max_seq}", uid=req.uid)
        if need > self.scheduler.token_budget:
            raise AdmissionError(
                f"request {req.uid}: {need} tokens exceed the scheduler "
                f"token budget {self.scheduler.token_budget}", uid=req.uid)
        if self.pool.pages_for(need) > self.geom.num_pages:
            raise AdmissionError(
                f"request {req.uid}: needs {self.pool.pages_for(need)} KV "
                f"pages, pool holds {self.geom.num_pages}", uid=req.uid)

    def submit(self, req: Request, arrival_step: Optional[int] = None) -> int:
        """Enqueue one request at any time; returns its uid."""
        if req.sampling is None:
            if self.default_sampling is None:
                raise ValueError(f"request {req.uid} has no SamplingParams and "
                                 "the loop has no default_sampling")
            req.sampling = self.default_sampling
        self._validate(req)
        if (self.max_queue is not None
                and len(self.scheduler.waiting) >= self.max_queue):
            self.rejected += 1
            raise QueueFullError(
                f"request {req.uid}: submit queue full "
                f"({len(self.scheduler.waiting)} waiting, bound "
                f"{self.max_queue})", uid=req.uid)
        if req.arrival_t == 0.0:
            req.arrival_t = time.perf_counter()
        self.scheduler.submit(req, arrival_step=self._step_no
                              if arrival_step is None else arrival_step)
        self._streams[req.uid] = {"toks": [], "cursor": 0, "done": False}
        return req.uid

    def poll(self, uid: int):
        """Tokens committed for ``uid`` since the last poll, and the done
        flag; the record drops once done and fully consumed."""
        st = self._streams[uid]
        new = st["toks"][st["cursor"]:]
        st["cursor"] = len(st["toks"])
        if st["done"] and st["cursor"] == len(st["toks"]):
            del self._streams[uid]
        return new, st["done"]

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def _emit(self, req: Request, token: int, done: bool,
              events: List[TokenEvent]) -> None:
        events.append(TokenEvent(uid=req.uid, token=token,
                                 index=len(req.generated) - 1, done=done,
                                 request=req))
        st = self._streams.get(req.uid)
        if st is not None:
            st["toks"].append(token)
            st["done"] = done
        if self.on_token is not None:
            self.on_token(req, token, done)

    def _sample(self) -> np.ndarray:
        """One token per decodable slot; rows are grouped by their request's
        ``SamplingParams`` and each group samples the full logits."""
        groups: Dict[SM.SamplingParams, List[int]] = {}
        for slot, req in enumerate(self.scheduler.running):
            if req is None or slot in self._prefilling or slot in self._hold:
                continue
            groups.setdefault(req.sampling, []).append(slot)
        tok = np.zeros((self.max_slots,), np.int64)
        for sp, slots in sorted(groups.items(), key=lambda kv: kv[1][0]):
            t = SM.sample(self.logits, sp, self.cfg.vocab_size, self._gen)
            tok[slots] = t.cpu().numpy()[slots]
        return tok

    def step(self) -> List[TokenEvent]:
        """Advance the loop by ONE unified step: preempt or spill under
        pressure, admit from the queue, run prompt chunks under the token
        budget, sample one token for every decodable row (emitted here),
        then decode in staging waves, each gathered into its smallest
        covering batch bucket."""
        try:
            return self._step()
        finally:
            # mirror the graph count into the stats at every exit path, so a
            # capture in any phase of this step shows at once
            ev = self.compile_events()
            stats = self.eng.stats
            stats.compile_events = ev
            if self.warmed:
                stats.recompiles_after_warmup = ev - self._warmup_graphs
            if self.wpolicy.active:
                store = self.eng.weight_store
                stats.weight_group_hits = store.prefetch_hits
                stats.weight_group_misses = store.prefetch_misses
                stats.weight_stall_s = sum(r.stall_s for r in (
                    *self._wstreams.values(), *self._expert_rings.values()))
                # resident_bytes counts the rings' slots
                stats.dram_weight_bytes = self.wpolicy.resident_bytes

    def _step(self) -> List[TokenEvent]:
        eng, sched = self.eng, self.scheduler
        events: List[TokenEvent] = []
        sched.step = self._step_no
        t_step = time.perf_counter()
        pf0 = eng.stats.prefill_s
        # rows that owe a pending decode, or are mid-prefill, are not victims
        preempted = sched.maybe_preempt(
            exclude_slots=set(self._hold) | set(self._prefilling))
        if preempted is not None:
            self._spill_row(*preempted, pending=False)
        self._proactive_spill()
        for slot, req in sched.admit():
            self._admit_into_slot(req, slot)
        self.peak_kv_pages = max(self.peak_kv_pages, sum(
            self.pool.pages_held(s) for s in range(self.max_slots)))
        self._run_prefill_chunks()
        running = list(sched.running)
        n_active = sum(r is not None for r in running)
        self.peak_active = max(self.peak_active, n_active)
        if n_active == 0:
            self._step_no += 1
            return events

        tok_np = self._sample()
        now = time.perf_counter()
        for slot, req in enumerate(running):
            if req is None or slot in self._hold or slot in self._prefilling:
                continue
            t_id = int(tok_np[slot])
            req.generated.append(t_id)
            if req.first_token_t == 0.0:
                req.first_token_t = now
            sp = req.sampling
            finished = ((sp.eos_token >= 0 and t_id == sp.eos_token)
                        or len(req.generated) >= req.decode_cap)
            self._emit(req, t_id, finished, events)
            if finished:
                req.finish_t = now
                sched.finish(req)
                self.pool.free_row(slot)
                self.spill.drop(req.uid)
                T.free_slots(self.cache, [slot])
                eng.stats.requests.append(RequestStats(
                    uid=req.uid, ttft_s=req.ttft, tpot_s=req.tpot,
                    latency_s=req.finish_t - req.arrival_t,
                    new_tokens=len(req.generated), preemptions=req.preemptions))

        # allocate-on-append: rows crossing a page boundary take a page; when
        # the pool runs dry, a cold page spills first, then the row holding
        # the most DRAM pages is preempted, then a mid-prefill row
        for slot, req in enumerate(sched.running):
            if req is None or slot in self._prefilling:
                continue
            while not self.pool.ensure(slot, int(self.pool.row_pos[slot])):
                if self._spill_one_cold():
                    continue
                victim = self._pick_page_victim(exclude={slot})
                if victim is None:
                    pref = [r for r in sched.running
                            if r is not None and r.slot != slot
                            and r.slot in self._prefilling]
                    if not pref:
                        raise RuntimeError("the pool cannot hold a single request")
                    self._spill_prefilling_row(max(
                        pref, key=lambda r: self.pool.pages_held(r.slot)))
                    continue
                vslot = victim.slot
                sched.evict(victim)
                self._spill_row(vslot, victim, pending=True)

        act_slots = [slot for slot, req in enumerate(sched.running)
                     if req is not None and slot not in self._prefilling]
        self._hold.clear()
        if not act_slots:
            self._step_no += 1
            eng.stats.decode_s += ((time.perf_counter() - t_step)
                                   - (eng.stats.prefill_s - pf0))
            return events

        ids = np.zeros((self.max_slots, 1), np.int64)
        for slot in act_slots:
            ids[slot, 0] = sched.running[slot].generated[-1]
        flash_needs = sum(self.pool.flash_pages_of(s) for s in act_slots)
        self._step_hits = self._step_misses = 0
        for wave in self._plan_waves(act_slots):
            needed = [(s, i) for s in wave for i in self.pool.flash_idxs(s)]
            if needed:
                self._stage_wave(needed)
            if self._bucketed:
                slot_idx, act_b = bucket_cover(self.buckets, wave, self.max_slots)
            else:
                # every slot rides along; rows outside the wave write only to
                # the trash page and keep their positions and logits
                slot_idx = np.arange(self.max_slots, dtype=np.int32)
                act_b = np.zeros((self.max_slots,), bool)
                act_b[wave] = True
            adapters = self._slot_lora(slot_idx)
            key = ("decode", len(slot_idx), adapters is not None)
            self._prepare(key)
            self._upload_table(visible=set(wave))
            ins = self._inputs[key]
            eng.embed(ids[slot_idx], out=ins["emb"])
            ins["rows"].put(np.stack([slot_idx, act_b]))
            if adapters is not None:
                ins["lora"].put(adapters)
            self._host_active = act_b
            self._launch(key)
        if flash_needs:
            total = self._step_hits + self._step_misses
            eng.stats.flash_hit_rates.append(
                self._step_hits / total if total else 1.0)
        for slot in act_slots:
            self.pool.row_pos[slot] += 1
        eng.stats.decode_tokens += len(act_slots)
        self._step_no += 1
        eng.stats.decode_s += ((time.perf_counter() - t_step)
                               - (eng.stats.prefill_s - pf0))
        return events

    def drain(self) -> None:
        """Step until the loop is idle."""
        while self.scheduler.has_work():
            self.step()
        _sync(self.device)

    def run(self, requests: Sequence[Request],
            sampling: Optional[SM.SamplingParams] = None,
            arrivals: Optional[Sequence[int]] = None) -> List[Request]:
        """Serve a whole trace to completion through ``submit()``/``step()``;
        ``arrivals``: per-request arrival step relative to the call.
        ``sampling`` applies to requests without their own."""
        arrivals = list(arrivals) if arrivals is not None else [0] * len(requests)
        if len(arrivals) != len(requests):
            raise ValueError("one arrival step per request")
        for req in requests:
            if req.sampling is None:
                req.sampling = sampling
            if req.sampling is None:
                raise ValueError(f"request {req.uid} has no SamplingParams")
            self._validate(req)
        base = self._step_no
        pending = sorted(zip(arrivals, requests), key=lambda p: (p[0], p[1].uid))
        self.peak_active = 0
        while pending or self.scheduler.has_work():
            now = time.perf_counter()
            while pending and pending[0][0] + base <= self._step_no:
                _, req = pending.pop(0)
                req.arrival_t = now
                self.submit(req)
            self.step()
        _sync(self.device)
        for req in requests:
            self._streams.pop(req.uid, None)
        return list(requests)


def build_engine(cfg: ModelConfig, seed: int = 0, max_seq: int = 256,
                 flash_dir: Optional[str] = None, device=None,
                 params: Optional[dict] = None,
                 embedding: Optional[HS.EmbeddingStore] = None,
                 weight_dram_budget_bytes: Optional[int] = None,
                 weight_ring_groups: int = 2,
                 expert_streaming: bool = True) -> Engine:
    """A serving engine with random weights drawn on ``device`` from
    ``seed`` (quantized, packed) and a random N(0, 0.02) embedding table
    written to Flash in chunks — or with converted ``params`` /
    ``embedding`` (``repro_torch.convert``).  ``flash_dir`` defaults to
    ``build/flash`` in the checkout.  The weight-streaming arguments are
    ``Engine``'s."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if params is None:
        params = T.init_params(cfg, gen, dev)
    if embedding is None:
        flash = HS.FlashStore(str(flash_dir or DEFAULT_FLASH_DIR))
        d = cfg.d_model
        embedding = HS.EmbeddingStore.create(
            flash, cfg.padded_vocab_size, d,
            lambda a, b: torch.randn((b - a, d), generator=gen, device=dev) * 0.02)
    return Engine(cfg, params, embedding, max_seq=max_seq, device=dev,
                  weight_dram_budget_bytes=weight_dram_budget_bytes,
                  weight_ring_groups=weight_ring_groups,
                  expert_streaming=expert_streaming)
