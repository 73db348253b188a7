"""The port's serving path against the reference, on qwen2-7b@reduced with
max_seq=64 and the reference's own weights (``repro.serving.engine.
build_engine``, converted by ``repro_torch.convert``): per-layer outputs and
logits of one prompt chunk and one bucketed decode step, and a mixed trace
through ``EngineLoop`` whose greedy tokens must equal the JAX loop's.

The reference's steps are compiled with XLA's excess precision switched
off (``xla_allow_excess_precision=False``).  With it on, XLA keeps some
bf16 intermediates in float32 depending on how it fuses the step (a
residual sum feeding RMSNorm skips its bf16 rounding), so the compiled
reference rounds at fewer places than its source casts; the port rounds
where the source casts.  What remains are one-ulp float32 differences
between XLA's and PyTorch's transcendentals and reduction orders: the
tolerances below are one bf16 rounding."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import sampling as JS  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.configs import registry as PR  # noqa: E402
from repro_torch.launch import serve as PSV  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.serving import engine as PE  # noqa: E402
from repro_torch.serving import sampling as PS  # noqa: E402

ARCH = "qwen2-7b@reduced"
STRICT = {"xla_allow_excess_precision": False}


@pytest.fixture(scope="module")
def engine_pairs(tmp_path_factory):
    """arch -> (reference engine, port engine on the reference's weights)."""
    built = {}

    def get(arch):
        if arch not in built:
            je = JE.build_engine(JR.get(arch), max_seq=64,
                                 flash_dir=str(tmp_path_factory.mktemp("flash_ref")))
            emb = CV.embedding_from_reference(
                je.embedding.flash._maps[je.embedding.name],
                str(tmp_path_factory.mktemp("flash_port")))
            pe = PE.build_engine(PR.get(arch), max_seq=64, device="cpu",
                                 params=CV.params_from_reference(je.params),
                                 embedding=emb)
            built[arch] = (je, pe)
        return built[arch]
    return get


@pytest.fixture(scope="module")
def engines(engine_pairs):
    return engine_pairs(ARCH)


def _close(a, b, tol=1e-2):
    a = np.asarray(jnp.asarray(a, jnp.float32))
    b = b.float().numpy()
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
    return float(np.mean(a == b))


def _reference_layers(je, mode):
    """The reference's layers one at a time (its own ``_apply_pattern``),
    returning every layer's output — compiled like the engine's steps."""
    cfg = je.cfg
    ctx = JT.StepCtx(cfg, dispatch=je.dispatch)
    pat = cfg.period[0]

    def run(params, cache, x, positions, pos, table, slot, valid_len):
        pool = cache["stacks"][0][0]
        outs = []
        for li in range(cfg.num_layers):
            pl = jax.tree.map(lambda a: a[li], params["stacks"][0][0])
            cl = jax.tree.map(lambda a: a[li], pool)
            x, nc, _ = JT._apply_pattern(x, pl, cfg, pat, mode, positions, cl, None,
                                         pos, table, ctx, slot=slot,
                                         valid_len=valid_len)
            pool = jax.tree.map(lambda big, small: big.at[li].set(small), pool, nc)
            outs.append(x)
        return outs, JT._logits(x[:, -1:], params, cfg, ctx.dispatch)[:, 0], pool

    return jax.jit(run, static_argnames=("valid_len",), compiler_options=STRICT)


@pytest.mark.parametrize("arch", [ARCH, "qwen2-1.5b@reduced", "llama3-8b@reduced"])
def test_chunk_and_decode_per_layer_match_reference(engine_pairs, arch):
    """qwen2-7b (G=1 at @reduced, qkv bias), qwen2-1.5b (G=2) and llama3-8b
    (no bias, rope theta 5e5)."""
    je, pe = engine_pairs(arch)
    loop_j = JE.EngineLoop(je, max_slots=4)
    loop_p = PE.EngineLoop(pe, max_slots=4)
    for loop in (loop_j, loop_p):
        assert loop.pool.alloc_row(1, 40)
    cj = dict(loop_j.cache, table=jnp.asarray(loop_j.pool.table))
    cp = loop_p.cache
    cp["table"] = torch.from_numpy(loop_p.pool.table.copy())
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 500, size=(1, 32))
    # chunk: 32 prompt tokens at positions [0, 32) into row 1
    x_j = je.embed(ids)
    outs_j, logits_j, pool_j = _reference_layers(je, "prefill_paged")(
        je.params, cj, x_j, jnp.arange(32)[None], None, cj["table"][1],
        jnp.asarray(1), valid_len=32)
    collect = []
    logits_p = PT.prefill_chunk_paged(pe.params, pe.cfg, pe.embed(ids), cp, 1, 0, 31,
                                      pe.dispatch, collect=collect)
    same = [_close(a, b) for a, b in zip(outs_j, collect)]
    assert len(collect) == pe.cfg.num_layers
    assert min(same) > 0.99                    # bitwise bar stray last-bit flips
    _close(logits_j, logits_p)
    # one decode step for rows 1 (active) and 0 (idle pad row, all-trash table)
    cj = dict(cj, stacks=((pool_j,),), pos=cj["pos"].at[1].set(32))
    cp["pos"][1] = 32
    for loop in (loop_j, loop_p):
        assert loop.pool.ensure(1, 32)
    table = loop_p.pool.table.copy()
    table[0] = loop_p.geom.trash_page
    tok = np.asarray([[int(np.argmax(np.asarray(logits_j)[0, :500]))], [0]])
    slot_idx = np.asarray([1, 0], np.int32)
    outs_j, logits_j, _ = _reference_layers(je, "decode")(
        je.params, cj, je.embed(tok), cj["pos"][slot_idx][:, None],
        cj["pos"][slot_idx], jnp.asarray(table)[slot_idx], None, valid_len=None)
    cp["table"] = torch.from_numpy(table)
    collect = []
    logits_p, cp = PT.decode_step_bucketed(
        pe.params, pe.cfg, pe.embed(tok), cp, torch.from_numpy(slot_idx).long(),
        pe.dispatch, active=torch.tensor([True, False]), collect=collect)
    same = [_close(a[:1], b[:1]) for a, b in zip(outs_j, collect)]
    assert min(same) > 0.99
    _close(logits_j[:1], logits_p[:1])
    assert cp["pos"].tolist() == [0, 33, 0, 0]


def _trace(seed=0, n=12):
    rng = np.random.default_rng(seed)
    sysp = [int(t) for t in rng.integers(1, 400, 19)]
    specs = []
    for i in range(n):
        tail = [int(t) for t in rng.integers(1, 400, int(rng.integers(2, 20)))]
        prompt = (sysp + tail)[:40] if i % 3 == 0 else \
            [int(t) for t in rng.integers(1, 400, int(rng.integers(4, 40)))]
        specs.append((prompt, int(rng.integers(2, 8))))
    arrivals = [int(a) for a in sorted(rng.integers(0, 30, n))]
    return specs, arrivals


def test_mixed_trace_greedy_tokens_equal_reference(engines, monkeypatch):
    """12 requests, a shared system prompt on every third, staggered
    arrivals, slot reuse: the port's EngineLoop commits the reference
    loop's greedy tokens, adopts the same prefix pages and leaves the
    allocator in the same state."""
    je, pe = engines
    specs, arrivals = _trace()
    monkeypatch.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=STRICT))
    loop_j = JE.EngineLoop(je, max_slots=4, prefill_chunk=16, prefill_token_budget=32)
    monkeypatch.undo()
    loop_p = PE.EngineLoop(pe, max_slots=4, prefill_chunk=16, prefill_token_budget=32)
    sj = JS.SamplingParams(temperature=0.0, max_new_tokens=8)
    sp = PS.SamplingParams(temperature=0.0, max_new_tokens=8)
    out_j = loop_j.run([JRequest(uid=i, prompt_tokens=p, max_new_tokens=m, sampling=sj)
                        for i, (p, m) in enumerate(specs)], arrivals=arrivals)
    out_p = loop_p.run([PE.Request(uid=i, prompt_tokens=p, max_new_tokens=m, sampling=sp)
                        for i, (p, m) in enumerate(specs)], arrivals=arrivals)
    # the trace fits the pool: nothing spills or is preempted
    assert je.stats.spilled_pages == je.stats.cold_spilled_pages == 0
    assert loop_p.pool.prefix_hits == loop_j.pool.prefix_hits > 0
    assert pe.stats.shared_prompt_tokens == je.stats.shared_prompt_tokens
    assert pe.stats.prefill_chunks == je.stats.prefill_chunks
    assert loop_p.pool.table.tolist() == loop_j.pool.table.tolist()
    assert loop_p.pool.refcount.tolist() == loop_j.pool.refcount.tolist()
    for a, b in zip(out_j, out_p):
        assert a.generated == b.generated, a.uid
        assert len(b.generated) == min(a.max_new_tokens, 8)
    assert len(pe.stats.requests) == len(specs)
    assert pe.dispatch.fallbacks == []


def test_incremental_api(engines):
    _, pe = engines
    sp = PS.SamplingParams(temperature=0.0, max_new_tokens=3)
    loop = PE.EngineLoop(pe, max_slots=2, default_sampling=sp, max_queue=2)
    with pytest.raises(PE.AdmissionError):
        loop.submit(PE.Request(uid=9, prompt_tokens=[1] * 60, max_new_tokens=8))
    events = []
    loop.on_token = lambda req, tok, done: events.append((req.uid, tok, done))
    for uid in (1, 2):
        loop.submit(PE.Request(uid=uid, prompt_tokens=[5, 6, 7, uid], max_new_tokens=3))
    with pytest.raises(PE.QueueFullError):
        loop.submit(PE.Request(uid=3, prompt_tokens=[5], max_new_tokens=3))
    loop.drain()
    toks, done = loop.poll(1)
    assert done and len(toks) == 3
    assert [e for e in events if e[0] == 1] == [(1, t, i == 2) for i, t in enumerate(toks)]
    assert pe.dispatch.fallbacks == []
    _unknown_adapter_as_in_reference(*engines)


def _unknown_adapter_as_in_reference(je, pe):
    """An adapter name nobody loaded, held to the reference's behaviour
    (a known fault of the reference, ROADMAP queue 3): while no adapter is
    loaded ``_lora_for`` returns None and the name is ignored (the request
    is served on the base weights); once one is loaded, the unknown name
    raises KeyError at the step that first runs the request."""
    assert pe._lora_for([PE.Request(uid=8, prompt_tokens=[1, 2], adapter="a")]) is None
    assert je._lora_for([JRequest(uid=8, prompt_tokens=[1, 2], adapter="a")]) is None
    sp = PS.SamplingParams(temperature=0.0, max_new_tokens=3)
    loop = PE.EngineLoop(pe, max_slots=2)
    reqs = [PE.Request(uid=u, prompt_tokens=[5, 6, 7, 8], max_new_tokens=3, adapter=a)
            for u, a in ((8, "a"), (9, None))]
    loop.run(reqs, sp)
    loop.close()
    assert reqs[0].generated == reqs[1].generated and len(reqs[0].generated) == 3
    rng = np.random.default_rng(0)
    cfg, hd = pe.cfg, pe.cfg.resolved_head_dim
    q = (rng.normal(size=(cfg.d_model, 2)).astype(np.float32),
         rng.normal(size=(2, cfg.num_heads * hd)).astype(np.float32))
    v = (rng.normal(size=(cfg.d_model, 2)).astype(np.float32),
         rng.normal(size=(2, cfg.num_kv_heads * hd)).astype(np.float32))
    for eng, loop_cls, req_cls, sp_cls in ((je, JE.EngineLoop, JRequest, JS.SamplingParams),
                                           (pe, PE.EngineLoop, PE.Request, PS.SamplingParams)):
        eng.load_adapter("known", q, v)
        try:
            loop = loop_cls(eng, max_slots=2,
                            default_sampling=sp_cls(temperature=0.0, max_new_tokens=3))
            loop.submit(req_cls(uid=10, prompt_tokens=[5, 6, 7], max_new_tokens=3,
                                adapter="a"))
            with pytest.raises(KeyError):
                loop.step()
            loop.close()
        finally:
            eng.lora_q.unload("known")
            eng.lora_v.unload("known")
    assert pe._lora_for([None]) is None


def test_stochastic_sampling_matches_distribution():
    """Sampling draws from a torch.Generator: it cannot reproduce jax.random's
    bits, so it is held to the distribution (temperature, top-k, pad mask)."""
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, 3.0, 9.0, 9.0]]).repeat(20000, 1)
    gen = torch.Generator().manual_seed(0)
    sp = PS.SamplingParams(temperature=1.5, top_k=4)
    toks = PS.sample(logits, sp, vocab_size=6, generator=gen)
    keep = [0, 1, 2, 5]                             # top 4 of the 6 real tokens
    p = torch.softmax(logits[0, keep] / 1.5, dim=0)
    freq = torch.bincount(toks, minlength=8).float() / len(toks)
    assert freq[[3, 4, 6, 7]].sum() == 0            # top-k and pad vocab masked
    assert torch.allclose(freq[keep], p, atol=0.015)
    greedy = PS.sample(logits[:2], PS.SamplingParams(), vocab_size=8)
    assert greedy.tolist() == [6, 6]                # first maximal index
    assert JS.sample(jnp.asarray(logits[:2].numpy()), JS.SamplingParams(), 8).tolist() == [6, 6]


def test_serve_entry_point_on_cpu(tmp_path, capsys):
    out = PSV.main(["--arch", ARCH, "--requests", "3", "--max-new", "4",
                    "--max-seq", "64", "--device", "cpu", "--flash-dir", str(tmp_path)])
    assert [len(r.generated) for r in out] == [4, 4, 4]
    assert "TTFT" in capsys.readouterr().out
