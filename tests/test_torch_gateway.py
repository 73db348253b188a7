"""The port's streaming gateway against the reference, on the CPU, on
qwen2-7b@tiny with ``max_seq`` 64 and the reference's own weights
(``repro_torch.convert``), adapters "a" and "b" loaded on both engines:

  * ``ByteTokenizer`` equals the reference's;
  * ``EngineService``: a stream's first token is delivered while the
    engine still has work, concurrent submits from several threads mixed
    across adapters stream ``EngineLoop.run``'s greedy tokens, ``close``
    fails the pending streams, and an engine thread that raises (an
    adapter nobody loaded) fails every open stream;
  * the HTTP layer: the same SSE requests through the port's app and the
    reference's app stream the same greedy tokens; a non-stream request
    with a string prompt through ``ByteTokenizer``; 400/429 mapping;
    ``/healthz`` 503 until warmup is done, then 200; ``/v1/stats``.

Timing is asserted by order (first token before the completion), never in
milliseconds: the tests share the machine with others.  The client is
plain ``urllib``."""
import concurrent.futures
import functools
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.data.tokenizer import ByteTokenizer as JByteTokenizer  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import gateway as JG  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.configs import registry as PR  # noqa: E402
from repro_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from repro_torch.serving import engine as PE  # noqa: E402
from repro_torch.serving import gateway as G  # noqa: E402
from repro_torch.serving import sampling as PS  # noqa: E402

ARCH = "qwen2-7b@tiny"
STRICT = {"xla_allow_excess_precision": False}
TIMEOUT = 300.0


def _strict(build):
    orig = jax.jit
    jax.jit = functools.partial(orig, compiler_options=STRICT)
    try:
        return build()
    finally:
        jax.jit = orig


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(reference engine with strict jits, the port's engine on its weights),
    both with adapters "a" (rank 8) and "b" (rank 4) loaded."""
    je = _strict(lambda: JE.build_engine(
        JR.get(ARCH), max_seq=64, flash_dir=str(tmp_path_factory.mktemp("ref"))))
    emb = CV.embedding_from_reference(je.embedding.flash._maps[je.embedding.name],
                                      str(tmp_path_factory.mktemp("port")))
    pe = PE.build_engine(PR.get(ARCH), max_seq=64, device="cpu",
                         params=CV.params_from_reference(je.params), embedding=emb)
    rng = np.random.default_rng(0)
    cfg, hd = je.cfg, je.cfg.resolved_head_dim
    for name, r in (("a", 8), ("b", 4)):
        q, v = ((rng.normal(size=(cfg.d_model, r)).astype(np.float32) * 0.3,
                 rng.normal(size=(r, h * hd)).astype(np.float32) * 0.3)
                for h in (cfg.num_heads, cfg.num_kv_heads))
        je.load_adapter(name, q, v)
        pe.load_adapter(name, q, v)
    return je, pe


def _prompts(n, length, seed):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 400, length)] for _ in range(n)]


def _loop_tokens(pe, prompts, adapters, n):
    """The same requests through ``EngineLoop.run`` on a fresh loop."""
    loop = PE.EngineLoop(pe, max_slots=4)
    sp = PS.SamplingParams(temperature=0.0, max_new_tokens=n)
    out = loop.run([PE.Request(uid=i, prompt_tokens=list(p), max_new_tokens=n,
                               adapter=a, sampling=sp)
                    for i, (p, a) in enumerate(zip(prompts, adapters))])
    loop.close()
    return [r.generated for r in out]


def test_byte_tokenizer_matches_reference():
    ours, ref = ByteTokenizer(512), JByteTokenizer(512)
    for text in ("hello", "", "grüße, 世界", "a\nb\x00c"):
        ids = ours.encode(text)
        assert ids.dtype == np.int32 and np.array_equal(ids, ref.encode(text))
        assert ours.decode(ids) == ref.decode(ids) == text
    assert ours.decode([0, 300, 105, 106]) == ref.decode([0, 300, 105, 106]) == "hi"


# ---------------------------------------------------------------------------
# EngineService (no HTTP)
# ---------------------------------------------------------------------------

def test_engine_service_streams_while_decoding(engines):
    """The first token is delivered (not done) while the engine still has
    work: checked on the engine thread as the token is emitted."""
    _je, pe = engines
    prompt = _prompts(1, 8, 5)[0]
    sp = PS.SamplingParams(temperature=0.0, max_new_tokens=6)
    with G.EngineService(PE.EngineLoop(pe, max_slots=2), warmup=False) as svc:
        emitted = []
        inner = svc.loop.on_token

        def on_token(req, tok, done):
            emitted.append((tok, done, svc.loop.has_work()))
            inner(req, tok, done)
        svc.loop.on_token = on_token
        stream = svc.submit(prompt, sp, adapter="a")
        first, done = stream.get(timeout=TIMEOUT)
        assert not done
        rest = stream.collect(timeout=TIMEOUT)
    assert emitted[0] == (first, False, True)
    assert [first] + rest == _loop_tokens(pe, [prompt], ["a"], 6)[0]


def test_engine_service_concurrent_streams_mixed_adapters(engines):
    """Four submits from four threads at once, mixed across adapters: each
    stream carries the greedy tokens ``EngineLoop.run`` commits for it."""
    _je, pe = engines
    prompts = _prompts(4, 7, 6)
    adapters = [None, "a", "b", "a"]
    sp = PS.SamplingParams(temperature=0.0, max_new_tokens=5)
    done0 = len(pe.stats.requests)
    with G.EngineService(PE.EngineLoop(pe, max_slots=4), warmup=False) as svc:
        start = threading.Barrier(4)

        def client(i):
            start.wait()
            return svc.submit(prompts[i], sp, adapter=adapters[i]).collect(timeout=TIMEOUT)
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            outs = list(pool.map(client, range(4)))
        assert svc.stats_snapshot()["completed_requests"] == done0 + 4
    assert outs == _loop_tokens(pe, prompts, adapters, 5)


def test_engine_service_close_fails_pending_streams(engines):
    _je, pe = engines
    sp = PS.SamplingParams(temperature=0.0, max_new_tokens=50)
    svc = G.EngineService(PE.EngineLoop(pe, max_slots=1), warmup=False).start()
    stream = svc.submit(_prompts(1, 6, 7)[0], sp)
    stream.get(timeout=TIMEOUT)          # it is really running
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        stream.collect(timeout=10.0)


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_engine_thread_failure_fails_every_stream(engines):
    """An adapter nobody loaded raises KeyError at the step that first runs
    it (the reference's behaviour with an adapter loaded): the engine thread
    stops and every open stream fails with that error."""
    _je, pe = engines
    sp = PS.SamplingParams(temperature=0.0, max_new_tokens=4)
    svc = G.EngineService(PE.EngineLoop(pe, max_slots=2), warmup=False)
    try:
        ok = svc.submit(_prompts(1, 6, 8)[0], sp, adapter="a")
        bad = svc.submit([1, 2, 3], sp, adapter="nobody")
        svc.start()
        for stream in (ok, bad):
            with pytest.raises(KeyError, match="nobody"):
                stream.collect(timeout=TIMEOUT)
        svc._thread.join(timeout=TIMEOUT)
        assert not svc._thread.is_alive()
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# HTTP layer
# ---------------------------------------------------------------------------

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, body, raw=None):
    data = raw if raw is not None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        r = urllib.request.urlopen(req, timeout=TIMEOUT)
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())
    with r:
        return r.status, dict(r.headers), json.loads(r.read())


def _sse(url, body):
    """POST with ``"stream": true``; returns the events in order (payload
    dicts, then "[DONE]") and the response's content type."""
    req = urllib.request.Request(url + "/v1/completions",
                                 data=json.dumps(dict(body, stream=True)).encode(),
                                 headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        ctype = r.headers["Content-Type"]
        while True:
            line = r.readline().decode()
            if not line:
                break
            line = line.strip()
            if not line:
                continue
            assert line.startswith("data: ")
            data = line[len("data: "):]
            events.append("[DONE]" if data == "[DONE]" else json.loads(data))
    return events, ctype


def _wait_ready(url):
    deadline = time.monotonic() + TIMEOUT
    codes = []
    while time.monotonic() < deadline:
        code, body = _get(url + "/healthz")
        codes.append(code)
        if code == 200:
            assert body == {"status": "ok", "ready": True, "engine_alive": True}
            return codes
        assert code == 503 and body["status"] == "warming"
        time.sleep(0.05)
    raise AssertionError("the gateway never became ready")


def test_http_sse_streams_the_reference_apps_tokens(engines):
    """Three SSE completions (base, "a", "b") through the port's app, after
    its warmup, and through the reference's app: the same greedy tokens,
    one chunk a token, finish reasons None then "length", then [DONE];
    ``/v1/stats`` reports the completions and no capture after warmup."""
    pytest.importorskip("aiohttp")
    je, pe = engines
    prompts = _prompts(3, 8, 9)
    adapters = [None, "a", "b"]
    streamed = {}
    done0 = len(pe.stats.requests)
    servers = {
        "port": lambda: G.GatewayServer(G.EngineService(
            PE.EngineLoop(pe, max_slots=2, max_queue=8))),
        "ref": lambda: JG.GatewayServer(JG.EngineService(
            _strict(lambda: JE.EngineLoop(je, max_slots=2, max_queue=8)), warmup=False)),
    }
    for name, make in servers.items():
        with make() as gw:
            if name == "port":
                _wait_ready(gw.url)
            toks = []
            for p, a in zip(prompts, adapters):
                events, ctype = _sse(gw.url, {"prompt": p, "max_tokens": 5, "adapter": a})
                assert ctype.startswith("text/event-stream")
                assert events[-1] == "[DONE]"
                chunks = events[:-1]
                assert [c["choices"][0]["finish_reason"] for c in chunks] == \
                    [None] * 4 + ["length"]
                toks.append([c["choices"][0]["token"] for c in chunks])
            streamed[name] = toks
            if name == "port":
                code, stats = _get(gw.url + "/v1/stats")
                assert code == 200 and stats["completed_requests"] == done0 + 3
                assert stats["warmed"] is True and stats["recompiles_after_warmup"] == 0
                assert stats["decode_buckets"] == [1, 2]
                assert stats["decode_tokens"] >= 12
                assert stats["weight_streaming"]["active"] is False
    assert streamed["port"] == streamed["ref"]
    assert streamed["port"] == _loop_tokens(pe, prompts, adapters, 5)


def test_healthz_503_until_warmup_completes(engines):
    """While warmup runs, /healthz answers 503 "warming"; once it returns,
    200 "ok".  The warmup is gated by an event, so the test decides when
    readiness flips."""
    pytest.importorskip("aiohttp")
    _je, pe = engines
    gate = threading.Event()
    loop = PE.EngineLoop(pe, max_slots=2)
    warm = loop.warmup

    def gated_warmup():
        assert gate.wait(timeout=TIMEOUT)
        return warm()
    loop.warmup = gated_warmup
    with G.GatewayServer(G.EngineService(loop, warmup=True)) as gw:
        code, body = _get(gw.url + "/healthz")
        assert code == 503
        assert body == {"status": "warming", "ready": False, "engine_alive": True}
        gate.set()
        assert _wait_ready(gw.url)[-1] == 200
        assert loop.warmed


def test_http_non_stream_string_prompt(engines):
    """A string prompt through ``ByteTokenizer``, one JSON body: the tokens,
    the detokenized text and the usage counts, as the reference's app
    answers the same request."""
    pytest.importorskip("aiohttp")
    je, pe = engines
    tok = ByteTokenizer(pe.cfg.vocab_size)
    body = {"prompt": "hello", "max_tokens": 4, "adapter": "b"}
    with G.GatewayServer(G.EngineService(PE.EngineLoop(pe, max_slots=2), warmup=False),
                         tokenizer=tok) as gw:
        code, _h, out = _post(gw.url + "/v1/completions", body)
    assert code == 200
    choice = out["choices"][0]
    assert len(choice["tokens"]) == 4 and choice["finish_reason"] == "length"
    assert choice["text"] == tok.decode(choice["tokens"])
    assert out["usage"] == {"prompt_tokens": 5, "completion_tokens": 4, "total_tokens": 9}
    want = _loop_tokens(pe, [[int(t) for t in tok.encode("hello")]], ["b"], 4)[0]
    assert choice["tokens"] == want


def test_http_error_mapping_400_and_429(engines):
    pytest.importorskip("aiohttp")
    _je, pe = engines
    # max_queue=0: every admission is backpressured -> 429
    loop = PE.EngineLoop(pe, max_slots=1, max_queue=0)
    with G.GatewayServer(G.EngineService(loop, warmup=False)) as gw:
        url = gw.url + "/v1/completions"
        code, headers, body = _post(url, {"prompt": [1, 2, 3], "max_tokens": 4})
        assert code == 429 and headers["Retry-After"] == "1"
        assert body["error"]["type"] == "overloaded_error"
        # a request that can never fit -> 400, checked before the queue
        code, _h, body = _post(url, {"prompt": [1] * 200, "max_tokens": 4})
        assert code == 400 and body["error"]["type"] == "invalid_request_error"
        # string prompt without a tokenizer, a prompt of the wrong type,
        # malformed body -> 400
        for req in ({"prompt": "hi", "max_tokens": 4}, {"prompt": [1.5], "max_tokens": 4}):
            assert _post(url, req)[0] == 400
        assert _post(url, None, raw=b"not json")[0] == 400
        code, stats = _get(gw.url + "/v1/stats")
        assert code == 200 and stats["rejected"] >= 1
