"""Continuous-batching admission — port of ``repro.serving.scheduler``
(pure Python, with the reference's queue order and page accounting, so
that admission follows the reference step for step).

``ContinuousScheduler``: requests join the decode batch the moment a slot
frees; admission is priority, then deadline, then FIFO with the cost model
as tie-break, bounded by slots, the token budget and the KV pages the
request's prompt actually needs.  Preemption (queue patience, page
pressure) spills to Flash in the reference and is not ported (ROADMAP
queue 1 item 10); nor are the replica-balancing helpers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, List, Optional, Tuple

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
    adapter: Optional[str] = None      # multi-LoRA (C7); not ported
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


class ContinuousScheduler:
    """Slot admission for the step-driven EngineLoop.

    * Queue order: priority class, earliest deadline, arrival step, then the
      C4 cost model (cheapest first).  A head that does not fit yet blocks
      later arrivals, so a large head is never starved.
    * Budgets: at most ``max_slots`` concurrent requests; the committed
      token load (prompt + remaining decode budget over running requests)
      never exceeds ``token_budget``.
    * Paged admission: a request is admitted when the pages its prompt and
      first decode append need are available in ``pool``
      (kv_pool.KVPoolManager) — prefix pages another running row holds are
      free — plus what ``spill_headroom()`` says the reference could free by
      spilling cold pages (the engine raises before it would spill).
    """

    def __init__(self, max_slots: int, max_seq: int, pool, spill_headroom):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.token_budget = max_slots * max_seq
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

    def has_work(self) -> bool:
        return bool(self.waiting) or any(r is not None for r in self.running)

    def _committed_tokens(self) -> int:
        return sum(r.length + r.max_new_tokens for r in self.running
                   if r is not None)

    def need_pages(self, req: Request) -> int:
        """Pages of availability the request consumes on admission: its
        prompt plus the first decode append, less the prefix pages another
        running row still holds (adopted copy-free)."""
        need = self.pool.pages_for(req.length + 1)
        need -= self.pool.probe_admission_discount(req.prompt_tokens,
                                                   salt=req.adapter or "")
        return max(need, 0)

    def _fits(self, req: Request, pending_pages: int) -> bool:
        if self._committed_tokens() + req.length + req.max_new_tokens \
                > self.token_budget:
            return False
        avail = (self.pool.available_pages - pending_pages
                 + self.spill_headroom())
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
                if req.length + req.max_new_tokens > self.max_seq:
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

    def finish(self, req: Request) -> None:
        req.done = True
        req.finish_step = self.step
        if req.slot >= 0:
            self.running[req.slot] = None
        req.slot = -1
