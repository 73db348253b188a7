"""Continuous-batching admission — port of ``repro.serving.scheduler``
(pure Python, with the reference's queue order and page accounting, so
that admission follows the reference step for step).

``ContinuousScheduler``: requests join the decode batch the moment a slot
frees; admission is priority, then deadline, then FIFO with the cost model
as tie-break, bounded by slots, the token budget and the KV pages the
request's context actually needs.  Under queue patience a running request
is evicted (``maybe_preempt``); the engine spills its pages to Flash and
restores them bit for bit on resume.

The paper's multicore load balancing (C4) is ported too: ``balance_requests``
assigns requests to workers by longest cost first onto the worker that
finishes earliest at its rate, ``uniform_requests`` is the round-robin
baseline and ``makespan`` the finish time of the slowest worker, with the
reference's order and tie-breaks, so the assignments equal it bucket for
bucket.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

if TYPE_CHECKING:
    from repro_torch.serving.sampling import SamplingParams  # pragma: no cover


class AdmissionError(ValueError):
    """The request can never be served by this loop configuration (prompt +
    decode budget exceed max_seq, the token budget, or the KV pool)."""

    def __init__(self, message: str, uid: Optional[int] = None):
        super().__init__(message)
        self.uid = uid


class QueueFullError(AdmissionError):
    """The bounded submit queue is full — transient backpressure."""


@dataclasses.dataclass
class Request:
    uid: int
    prompt_tokens: List[int]
    max_new_tokens: int = 32
    adapter: Optional[str] = None      # multi-LoRA (C7): Engine.load_adapter name
    # per-request sampling (None until EngineLoop.submit resolves it
    # against the loop default)
    sampling: Optional["SamplingParams"] = None
    # QoS: higher priority admits first; deadline_s is an absolute
    # wall-clock deadline used for earliest-deadline-first ordering
    # within a priority class (None = no deadline)
    priority: int = 0
    deadline_s: Optional[float] = None
    # runtime state
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    slot: int = -1                     # decode-batch row currently held
    arrival_step: int = -1             # step the request entered the queue
    admit_step: int = -1               # step of admission
    finish_step: int = -1              # step the request completed
    preemptions: int = 0               # times evicted and requeued
    # pages a preempted request left on Flash: its restore allocates DRAM
    # only for the rest, so admission does not charge them
    spilled_flash_pages: int = 0
    # a mid-prefill victim awaiting resume: its restore adopts nothing from
    # the prefix index, so admission charges the full prompt
    resume_prefill: bool = False
    # per-request latency stats (wall-clock, filled by EngineLoop)
    arrival_t: float = 0.0
    first_token_t: float = 0.0
    finish_t: float = 0.0

    @property
    def length(self) -> int:
        return len(self.prompt_tokens)

    @property
    def cost(self) -> float:
        """Approximate work: prefill tokens + expected decode steps."""
        return self.length + 4.0 * self.max_new_tokens

    @property
    def context_tokens(self) -> List[int]:
        """Prompt + anything already generated (non-empty after a
        preemption)."""
        return list(self.prompt_tokens) + list(self.generated)

    @property
    def decode_cap(self) -> int:
        """Effective decode budget: the request's own cap tightened by its
        sampling params (once resolved by submit)."""
        if self.sampling is not None:
            return min(self.max_new_tokens, self.sampling.max_new_tokens)
        return self.max_new_tokens

    @property
    def ttft(self) -> float:
        """Time to first token (s)."""
        return self.first_token_t - self.arrival_t

    @property
    def tpot(self) -> float:
        """Time per output token after the first (s)."""
        n = len(self.generated)
        if n <= 1:
            return 0.0
        return (self.finish_t - self.first_token_t) / (n - 1)


def balance_requests(requests: Sequence[Request], n_workers: int,
                     rates: Optional[Sequence[float]] = None
                     ) -> List[List[Request]]:
    """Longest-cost-first assignment (the paper's "balanced", Fig. 4):
    each request, by descending ``cost``, goes to the worker whose
    normalized finish time (a min-heap of (time, worker)) is least;
    ``rates`` are per-worker throughput weights (uniform when None)."""
    rates = list(rates) if rates else [1.0] * n_workers
    if len(rates) != n_workers:
        raise ValueError(f"{len(rates)} rates for {n_workers} workers")
    buckets: List[List[Request]] = [[] for _ in range(n_workers)]
    heap = [(0.0, i) for i in range(n_workers)]
    heapq.heapify(heap)
    for req in sorted(requests, key=lambda r: -r.cost):
        t, i = heapq.heappop(heap)
        buckets[i].append(req)
        heapq.heappush(heap, (t + req.cost / rates[i], i))
    return buckets


def uniform_requests(requests: Sequence[Request], n_workers: int
                     ) -> List[List[Request]]:
    """Round-robin (the paper's "uniform" baseline)."""
    buckets: List[List[Request]] = [[] for _ in range(n_workers)]
    for j, req in enumerate(requests):
        buckets[j % n_workers].append(req)
    return buckets


def makespan(buckets: Sequence[Sequence[Request]],
             rates: Optional[Sequence[float]] = None) -> float:
    """The slowest worker's total cost over its rate."""
    rates = list(rates) if rates else [1.0] * len(buckets)
    return max((sum(r.cost for r in b) / rate) if b else 0.0
               for b, rate in zip(buckets, rates))


class ContinuousScheduler:
    """Slot admission for the step-driven EngineLoop.

    * Queue order: priority class, earliest deadline, arrival step, then the
      C4 cost model (cheapest first).  A head that does not fit yet blocks
      later arrivals, so a large head is never starved.
    * Budgets: at most ``max_slots`` concurrent requests; the committed
      token load (context + remaining decode budget over running requests)
      never exceeds ``token_budget``.
    * Preemption: when the queue's head has waited ``preempt_patience``
      steps with no slot free, the lowest-priority, longest-running request
      that has held its slot that long is evicted (``maybe_preempt``).
    * Paged admission: a request is admitted when the pages its context and
      first decode append need are available in ``pool``
      (kv_pool.KVPoolManager) — prefix pages another running row holds are
      free, a resumed request's pages on Flash are not charged — plus
      ``spill_headroom()``, the cold pages the engine could spill to Flash
      (None when proactive spill is off).
    """

    def __init__(self, max_slots: int, max_seq: int, pool,
                 token_budget: Optional[int] = None,
                 preempt_patience: int = 0, spill_headroom=None):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.token_budget = token_budget or max_slots * max_seq
        self.preempt_patience = preempt_patience
        self.pool = pool
        self.spill_headroom = spill_headroom
        self.waiting: List[Request] = []
        self.running: List[Optional[Request]] = [None] * max_slots
        self.step = 0

    @staticmethod
    def queue_key(r: Request):
        return (-r.priority,
                r.deadline_s if r.deadline_s is not None else math.inf,
                r.arrival_step, r.cost, r.uid)

    @property
    def active(self) -> List[Request]:
        """The running requests, in slot order."""
        return [r for r in self.running if r is not None]

    def has_work(self) -> bool:
        return bool(self.waiting) or any(r is not None for r in self.running)

    def _committed_tokens(self) -> int:
        return sum(len(r.context_tokens) + r.max_new_tokens - len(r.generated)
                   for r in self.active)

    def need_pages(self, req: Request) -> int:
        """Pages of availability the request consumes on admission: its
        context plus the first decode append, less the prefix pages another
        running row still holds (a fresh prompt) or the pages it left on
        Flash (a resumed request)."""
        need = self.pool.pages_for(len(req.context_tokens) + 1)
        if not req.generated:
            if not req.resume_prefill:
                need -= self.pool.probe_admission_discount(
                    req.prompt_tokens, salt=req.adapter or "")
        else:
            need -= req.spilled_flash_pages
        return max(need, 0)

    def _fits(self, req: Request, pending_pages: int) -> bool:
        need = len(req.context_tokens) + req.max_new_tokens - len(req.generated)
        if self._committed_tokens() + need > self.token_budget:
            return False
        avail = self.pool.available_pages - pending_pages
        if self.spill_headroom is not None:
            avail += self.spill_headroom()
        return self.need_pages(req) <= avail

    def submit(self, req: Request, arrival_step: Optional[int] = None) -> None:
        req.arrival_step = self.step if arrival_step is None else arrival_step
        self.waiting.append(req)

    def admit(self) -> List[Tuple[int, Request]]:
        """Fill free slots from the queue in ``queue_key`` order.  Returns
        the (slot, request) pairs admitted this step."""
        self.waiting.sort(key=self.queue_key)
        admitted: List[Tuple[int, Request]] = []
        pending_pages = 0
        for slot in range(self.max_slots):
            if self.running[slot] is not None or not self.waiting:
                continue
            cand = None
            for req in self.waiting:
                need = (len(req.context_tokens) + req.max_new_tokens
                        - len(req.generated))
                if need > self.max_seq:
                    continue        # can never run; don't block the queue
                if self._fits(req, pending_pages):
                    cand = req
                break               # strict queue order under the budget
            if cand is None:
                break
            self.waiting.remove(cand)
            cand.slot = slot
            cand.admit_step = self.step
            self.running[slot] = cand
            admitted.append((slot, cand))
            pending_pages += self.need_pages(cand)
        return admitted

    def evict(self, victim: Request) -> int:
        """Evict one running request and requeue it at the back (its arrival
        step becomes this step, or it would win the next admission and
        ping-pong).  Returns the freed slot."""
        freed = victim.slot
        self.running[freed] = None
        victim.slot = -1
        victim.preemptions += 1
        victim.arrival_step = self.step
        self.waiting.append(victim)
        return freed

    def maybe_preempt(self, exclude_slots: Optional[set] = None,
                      sampling_cap: Optional[int] = None
                      ) -> Optional[Tuple[int, Request]]:
        """Under queue pressure evict one request a step: the lowest
        priority class, then the most generated tokens, then the highest
        slot.  Never a request that has held its slot fewer than
        ``preempt_patience`` steps, has no token yet, is about to finish, or
        sits in ``exclude_slots``.  Returns (freed_slot, victim)."""
        if not self.preempt_patience or not self.waiting:
            return None
        head = min(self.waiting, key=self.queue_key)
        if self.step - head.arrival_step < self.preempt_patience:
            return None
        if any(r is None for r in self.running):
            return None

        def cap(r: Request) -> int:
            c = r.decode_cap
            return min(c, sampling_cap) if sampling_cap is not None else c

        victims = [r for r in self.running
                   if r is not None
                   and (exclude_slots is None or r.slot not in exclude_slots)
                   and r.admit_step + self.preempt_patience <= self.step
                   and len(r.generated) >= 1
                   and len(r.generated) < cap(r) - 1]
        if not victims:
            return None
        victim = max(victims,
                     key=lambda r: (-r.priority, len(r.generated), r.slot))
        return self.evict(victim), victim

    def finish(self, req: Request) -> None:
        req.done = True
        req.finish_step = self.step
        if req.slot >= 0:
            self.running[req.slot] = None
        req.slot = -1
