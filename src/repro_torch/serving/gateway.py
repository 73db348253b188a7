"""Streaming serving gateway — port of ``repro.serving.gateway``: an async
HTTP front-end over the incremental ``EngineLoop`` API.

Two layers:

  * ``EngineService`` — owns the EngineLoop plus the single *engine
    thread* that drives ``step()``.  ``submit()`` is thread-safe and may
    be called from any thread (the HTTP handlers); it enqueues the
    request under the engine lock and returns a ``TokenStream`` that the
    loop's ``on_token`` callback feeds the moment a step commits a token
    — a consumer sees the first token while the rest of the completion
    is still decoding.  Admission failures surface synchronously:
    ``AdmissionError`` (the request can never fit) and ``QueueFullError``
    (bounded-queue backpressure) propagate to the caller.

  * ``build_app`` — an aiohttp application exposing

      POST /v1/completions   OpenAI-style; ``"stream": true`` answers
                             with SSE (``data: {chunk}\\n\\n`` per token,
                             then ``data: [DONE]``), else one JSON body.
                             AdmissionError -> 400, QueueFullError -> 429.
      GET  /healthz          readiness probe (503 until warmup() has
                             captured the step graphs, 200 after)
      GET  /v1/stats         EngineStats + queue/pool snapshot

Only the engine thread touches the device: it runs ``warmup()`` (the
kernel build and every CUDA-graph capture) and every step, on the loop's
device and on that thread's current stream.  A capture is made in global
error mode, where a CUDA call from another thread would break it, so
``submit``, ``ready`` and ``stats_snapshot`` read and write host state
only.

aiohttp is optional: ``EngineService`` (and everything tests drive
in-process) works without it; only ``build_app``/``serve`` require it.
"""
from __future__ import annotations

import asyncio
import itertools
import json
import queue
import threading
import time
from typing import List, Optional

import torch

from repro_torch.serving import engine as E
from repro_torch.serving import sampling as SM
from repro_torch.serving.scheduler import AdmissionError, QueueFullError, Request

try:                                   # gated: server mode only
    from aiohttp import web
except ImportError:                    # pragma: no cover - present in CI
    web = None


class TokenStream:
    """Thread-safe per-request token stream (engine thread -> consumer).

    Iterating yields ``(token, done)`` pairs; ``collect()`` blocks until
    the completion finishes and returns the whole token list."""

    _ERROR = object()

    def __init__(self, request: Request):
        self.request = request
        self.uid = request.uid
        self._q: "queue.Queue" = queue.Queue()

    # --- engine side -------------------------------------------------------
    def _put(self, token: int, done: bool) -> None:
        self._q.put((token, done))

    def _fail(self, exc: BaseException) -> None:
        self._q.put((self._ERROR, exc))

    # --- consumer side -----------------------------------------------------
    def get(self, timeout: Optional[float] = None):
        """Next ``(token, done)`` pair; raises ``queue.Empty`` on timeout
        and re-raises an engine-side failure."""
        tok, done = self._q.get(timeout=timeout)
        if tok is self._ERROR:
            raise done
        return tok, done

    def __iter__(self):
        while True:
            tok, done = self.get()
            yield tok, done
            if done:
                return

    def collect(self, timeout: Optional[float] = None) -> List[int]:
        toks: List[int] = []
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            wait = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            tok, done = self.get(timeout=wait)
            toks.append(tok)
            if done:
                return toks


class EngineService:
    """The engine thread + thread-safe submission over one EngineLoop.

    The loop is NOT thread-safe, so every touch — submit, step — happens
    under one lock.  The engine thread steps whenever the scheduler has
    work and parks on a condition variable when idle; ``submit()`` wakes
    it.  Per-token delivery rides the loop's ``on_token`` callback into
    each request's ``TokenStream`` queue.  If the engine thread raises,
    warmup included, every open stream fails with the error and the thread
    stops."""

    def __init__(self, loop: E.EngineLoop, idle_wait_s: float = 0.05,
                 warmup: bool = True):
        assert loop.on_token is None, \
            "EngineService owns the loop's on_token callback"
        self.loop = loop
        loop.on_token = self._on_token
        self._streams: dict = {}
        self._mu = threading.Lock()
        self._wake = threading.Condition(self._mu)
        self._idle_wait_s = idle_wait_s
        self._stop = False
        self._uids = itertools.count()
        self.started_t = time.time()
        # warmup runs on the ENGINE thread (first thing _serve does), so
        # start() returns immediately and /healthz answers 503 while the
        # bucket/chunk graphs are captured — load balancers never route
        # traffic into a warming engine.  warmup=False is the escape hatch
        # for latency-insensitive tooling that would rather capture lazily.
        self._warmup_requested = warmup
        self._thread = threading.Thread(
            target=self._serve, name="engine-loop", daemon=True)

    @property
    def ready(self) -> bool:
        """True once the loop's step graphs are captured (or warmup was
        disabled) — the /healthz readiness signal."""
        return self.loop.warmed or not self._warmup_requested

    # --- lifecycle ---------------------------------------------------------
    def start(self) -> "EngineService":
        self._thread.start()
        return self

    def close(self) -> None:
        with self._wake:
            self._stop = True
            self._wake.notify_all()
        if self._thread.is_alive():
            self._thread.join(timeout=30.0)
        self.loop.close()

    def __enter__(self) -> "EngineService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # --- submission (any thread) -------------------------------------------
    def submit(self, prompt_tokens: List[int],
               sampling: Optional[SM.SamplingParams] = None,
               max_new_tokens: Optional[int] = None,
               priority: int = 0,
               deadline_s: Optional[float] = None,
               adapter: Optional[str] = None) -> TokenStream:
        """Admission-checked enqueue; raises AdmissionError/QueueFullError
        exactly like ``EngineLoop.submit``.  ``deadline_s`` is an offset
        from now (converted to the absolute wall-clock deadline the
        scheduler orders by)."""
        req = Request(
            uid=next(self._uids),
            prompt_tokens=list(int(t) for t in prompt_tokens),
            max_new_tokens=(max_new_tokens if max_new_tokens is not None
                            else (sampling.max_new_tokens if sampling
                                  else 32)),
            adapter=adapter,
            sampling=sampling,
            priority=priority,
            deadline_s=(time.perf_counter() + deadline_s
                        if deadline_s is not None else None))
        stream = TokenStream(req)
        with self._wake:
            self.loop.submit(req)          # may raise: nothing registered
            self._streams[req.uid] = stream
            self._wake.notify_all()
        return stream

    # --- engine thread ------------------------------------------------------
    def _on_token(self, req: Request, token: int, done: bool) -> None:
        stream = self._streams.get(req.uid)
        if stream is not None:
            stream._put(token, done)
            if done:
                del self._streams[req.uid]

    def _fail_all(self, exc: BaseException) -> None:
        for stream in self._streams.values():
            stream._fail(exc)
        self._streams.clear()

    def _serve(self) -> None:
        if self.loop.device.type == "cuda":
            torch.cuda.set_device(self.loop.device)
        if self._warmup_requested and not self.loop.warmed:
            try:
                self.loop.warmup()
            except Exception as exc:       # never ready: fail all streams
                with self._wake:
                    self._fail_all(exc)
                raise
        while True:
            with self._wake:
                while not self._stop and not self.loop.has_work():
                    self._wake.wait(self._idle_wait_s)
                if self._stop:
                    # unblock any stream still waiting on tokens
                    self._fail_all(RuntimeError("engine service closed"))
                    return
                try:
                    self.loop.step()
                except Exception as exc:   # engine died: fail all streams
                    self._fail_all(exc)
                    raise
            # let a thread waiting on the lock (submit, close, stats) take
            # it between steps: the lock is not fair, and a loop that
            # re-acquires at once can hold it for a whole trace
            time.sleep(0)

    # --- observability -----------------------------------------------------
    def stats_snapshot(self) -> dict:
        s = self.loop.eng.stats
        with self._mu:
            sched = self.loop.scheduler
            return {
                "uptime_s": round(time.time() - self.started_t, 3),
                "step": self.loop._step_no,
                "running": sum(r is not None for r in sched.running),
                "waiting": len(sched.waiting),
                "rejected": self.loop.rejected,
                "max_slots": self.loop.max_slots,
                "free_kv_pages": self.loop.pool.free_pages,
                "total_kv_pages": self.loop.geom.num_pages,
                "prefill_tokens": s.prefill_tokens,
                "decode_tokens": s.decode_tokens,
                "prefill_tps": round(s.prefill_tps, 3),
                "decode_tps": round(s.decode_tps, 3),
                "completed_requests": len(s.requests),
                "ttft_p50_s": round(s.ttft(50), 6),
                "ttft_p95_s": round(s.ttft(95), 6),
                "tpot_p50_s": round(s.tpot(50), 6),
                "flash_hit_rate": round(s.flash_hit_rate, 6),
                "preempted_spilled_pages": s.spilled_pages,
                "cold_spilled_pages": s.cold_spilled_pages,
                "shared_prompt_tokens": s.shared_prompt_tokens,
                # step graphs: the capture counter the CI gate watches
                # (recompiles_after_warmup must stay 0)
                "warmed": self.loop.warmed,
                "decode_buckets": [int(b) for b in self.loop.buckets],
                "compile_events": s.compile_events,
                "recompiles_after_warmup": s.recompiles_after_warmup,
                # weight residency: which stacks stream from Flash through
                # the device ring, and how well prefetch hides it
                "weight_streaming": self._weight_stats(),
                # feature gates the loop resolved OFF at construction —
                # name -> why (empty when everything requested is live)
                "disabled_features": dict(s.disabled_features),
            }

    def _weight_stats(self) -> dict:
        pol = self.loop.wpolicy
        s = self.loop.eng.stats
        out = {
            "active": pol.active,
            "resident_stacks": sum(
                1 for k, v in pol.placement.items()
                if k.startswith("stacks/") and v == "dram"),
            "streamed_stacks": len(pol.streamed),
            "dram_weight_bytes": s.dram_weight_bytes,
        }
        if pol.active:
            out.update({
                "ring_groups": {str(p.stack): p.ring_groups
                                for p in pol.streamed},
                "ring_bytes": pol.ring_bytes,
                "hit_rate": round(s.weight_stream_hit_rate, 6),
                "stall_s": round(s.weight_stall_s, 6),
            })
        if any(p.experts for p in pol.streamed):
            # router-aware per-expert streaming
            out.update({
                "expert_stacks": sum(1 for p in pol.streamed if p.experts),
                "expert_prefetch_hit_rate":
                    round(s.expert_prefetch_hit_rate, 6),
                "expert_bytes_saved_frac":
                    round(s.expert_bytes_saved_frac, 6),
            })
        return out


# ===========================================================================
# HTTP layer (aiohttp)
# ===========================================================================

def _sampling_from_body(body: dict) -> SM.SamplingParams:
    return SM.SamplingParams(
        temperature=float(body.get("temperature", 0.0)),
        top_k=int(body.get("top_k", 0)),
        top_p=float(body.get("top_p", 1.0)),
        max_new_tokens=int(body.get("max_tokens", 16)),
        eos_token=int(body.get("eos_token", -1)))


def _chunk(uid: int, model: str, text: str, token: Optional[int],
           finish_reason: Optional[str]) -> dict:
    return {"id": f"cmpl-{uid}", "object": "text_completion",
            "created": int(time.time()), "model": model,
            "choices": [{"index": 0, "text": text, "token": token,
                         "logprobs": None, "finish_reason": finish_reason}]}


def build_app(svc: EngineService, tokenizer=None,
              model_name: str = "repro",
              stream_get_timeout_s: float = 60.0):
    """The aiohttp application over one EngineService.

    ``tokenizer`` (data.tokenizer.ByteTokenizer or compatible) enables
    string prompts and text detokenization; without it, prompts must be
    token-id arrays and chunks carry ids only."""
    if web is None:
        raise RuntimeError("the HTTP gateway requires aiohttp "
                           "(EngineService works without it)")
    app = web.Application()

    def detok(tok: int) -> str:
        return tokenizer.decode([tok]) if tokenizer is not None else ""

    async def completions(request: "web.Request") -> "web.StreamResponse":
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return web.json_response(
                {"error": {"type": "invalid_request_error",
                           "message": "body must be JSON"}}, status=400)
        prompt = body.get("prompt")
        if isinstance(prompt, str):
            if tokenizer is None:
                return web.json_response(
                    {"error": {"type": "invalid_request_error",
                               "message": "string prompts need a tokenizer; "
                                          "pass a token-id array"}},
                    status=400)
            prompt_tokens = [int(t) for t in tokenizer.encode(prompt)]
        elif isinstance(prompt, list) and all(
                isinstance(t, int) for t in prompt):
            prompt_tokens = prompt
        else:
            return web.json_response(
                {"error": {"type": "invalid_request_error",
                           "message": "prompt must be a string or a "
                                      "token-id array"}}, status=400)
        sampling = _sampling_from_body(body)
        deadline_ms = body.get("deadline_ms")
        try:
            stream = await asyncio.to_thread(
                svc.submit, prompt_tokens, sampling,
                priority=int(body.get("priority", 0)),
                deadline_s=(float(deadline_ms) / 1e3
                            if deadline_ms is not None else None),
                adapter=body.get("adapter"))
        except QueueFullError as exc:
            return web.json_response(
                {"error": {"type": "overloaded_error", "message": str(exc)}},
                status=429, headers={"Retry-After": "1"})
        except AdmissionError as exc:
            return web.json_response(
                {"error": {"type": "invalid_request_error",
                           "message": str(exc)}}, status=400)

        def finish_reason(req: Request, last_token: int) -> str:
            sp = req.sampling
            return ("stop" if sp.eos_token >= 0 and last_token == sp.eos_token
                    else "length")

        if bool(body.get("stream", False)):
            resp = web.StreamResponse(headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                "Connection": "keep-alive",
                "X-Accel-Buffering": "no"})
            await resp.prepare(request)
            # SSE: one chunk per token, flushed the moment the engine
            # commits it — the client reads token 0 while the completion
            # is still decoding
            while True:
                tok, done = await asyncio.to_thread(
                    stream.get, stream_get_timeout_s)
                payload = _chunk(
                    stream.uid, model_name, detok(tok), tok,
                    finish_reason(stream.request, tok) if done else None)
                await resp.write(
                    f"data: {json.dumps(payload)}\n\n".encode())
                if done:
                    break
            await resp.write(b"data: [DONE]\n\n")
            await resp.write_eof()
            return resp

        toks = await asyncio.to_thread(stream.collect, stream_get_timeout_s)
        text = (tokenizer.decode(toks) if tokenizer is not None else "")
        return web.json_response({
            "id": f"cmpl-{stream.uid}", "object": "text_completion",
            "created": int(time.time()), "model": model_name,
            "choices": [{"index": 0, "text": text, "tokens": toks,
                         "logprobs": None,
                         "finish_reason": finish_reason(stream.request,
                                                        toks[-1])}],
            "usage": {"prompt_tokens": len(prompt_tokens),
                      "completion_tokens": len(toks),
                      "total_tokens": len(prompt_tokens) + len(toks)}})

    async def healthz(request: "web.Request") -> "web.Response":
        # readiness, not just liveness: 503 until warmup() has captured
        # every bucket/chunk graph, so a load balancer never routes
        # traffic into a warming engine
        ready = svc.ready
        return web.json_response(
            {"status": "ok" if ready else "warming",
             "ready": ready,
             "engine_alive": svc._thread.is_alive() or not svc._stop},
            status=200 if ready else 503)

    async def stats(request: "web.Request") -> "web.Response":
        return web.json_response(
            await asyncio.to_thread(svc.stats_snapshot))

    app.router.add_post("/v1/completions", completions)
    app.router.add_get("/healthz", healthz)
    app.router.add_get("/v1/stats", stats)
    return app


def serve(svc: EngineService, host: str = "127.0.0.1", port: int = 8080,
          tokenizer=None, model_name: str = "repro") -> None:
    """Blocking entry point: run the gateway until interrupted."""
    app = build_app(svc, tokenizer=tokenizer, model_name=model_name)
    svc.start()
    try:
        web.run_app(app, host=host, port=port, print=None)
    finally:
        svc.close()


class GatewayServer:
    """A gateway on a background thread with its own asyncio loop — for
    tests and the smoke job (``web.run_app`` wants the main thread)."""

    def __init__(self, svc: EngineService, host: str = "127.0.0.1",
                 port: int = 0, tokenizer=None, model_name: str = "repro"):
        self.svc = svc
        self.host, self.port = host, port
        self.app = build_app(svc, tokenizer=tokenizer, model_name=model_name)
        self._aio: Optional[asyncio.AbstractEventLoop] = None
        self._started = threading.Event()
        self._thread = threading.Thread(
            target=self._serve_thread, name="gateway-http", daemon=True)

    def _serve_thread(self) -> None:
        self._aio = asyncio.new_event_loop()
        asyncio.set_event_loop(self._aio)

        async def boot():
            runner = web.AppRunner(self.app)
            await runner.setup()
            site = web.TCPSite(runner, self.host, self.port)
            await site.start()
            # ephemeral port resolution
            self.port = runner.addresses[0][1]
            self._runner = runner
            self._started.set()

        self._aio.run_until_complete(boot())
        try:
            self._aio.run_forever()
        finally:
            self._aio.run_until_complete(self._runner.cleanup())
            self._aio.close()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self, timeout: float = 30.0) -> "GatewayServer":
        self.svc.start()
        self._thread.start()
        if not self._started.wait(timeout):
            raise RuntimeError("gateway failed to start")
        return self

    def close(self) -> None:
        if self._aio is not None:
            self._aio.call_soon_threadsafe(self._aio.stop)
        self._thread.join(timeout=30.0)
        self.svc.close()

    def __enter__(self) -> "GatewayServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
