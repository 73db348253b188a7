"""Recurrent stacks through the port's serving paths against the reference
on the CPU: rwkv6-7b@tiny (7 rwkv layers in two stacks, attention-free) and
jamba-1.5-large-398b@tiny (26 layers: three periods of one attention layer
and seven mamba layers, MoE on the odd ones, then an attention + mamba-MoE
tail: two stacks, both recurrent), each served on the reference's own
weights (converted by ``repro_torch.convert``) with ``max_seq`` 64.

- ``EngineLoop``'s gates: prefix sharing and decode bucketing off with the
  reference's reasons (``disabled_features`` equal), whatever the stack's
  window; an engine whose weights stream serving the resident tokens;
- the greedy tokens of a trace with ragged prompts (final chunks padded;
  decode steps beside rows mid-prefill, whose state must stay frozen),
  eagerly and after ``warmup()`` on stand-in graphs (one capture a step
  shape, none after warmup), equal to the JAX loop's, with the counters
  (chunks, preemptions, pages spilled and restored): on rwkv6 a staggered
  trace with slot reuse; on jamba the page-pressure trace, under a 4-page
  pool with queue patience: a mid-prefill victim spilled at its chunk
  boundary (pages and state) and resumed, and a decoding row preempted to
  Flash and restored, the JAX loop driven the same way;
- ``Engine.generate``'s greedy tokens equal to the JAX engine's;
- inactive rows of a decode step keep their state.

The reference's steps are compiled with XLA's excess precision off, as in
``test_torch_engine``."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.runtime import plan as JP  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import sampling as JS  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.configs import registry as PR  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.serving import engine as PE  # noqa: E402
from repro_torch.serving import sampling as PS  # noqa: E402
from test_torch_engine import STRICT  # noqa: E402

MAX_SEQ = 64
ARCHS = ("rwkv6-7b@tiny", "jamba-1.5-large-398b@tiny")
LOOP_KW = dict(max_slots=3, prefill_chunk=16, prefill_token_budget=16)


@pytest.fixture(scope="module")
def engine_pairs(tmp_path_factory):
    built = {}

    def get(arch):
        if arch not in built:
            orig = jax.jit
            jax.jit = functools.partial(orig, compiler_options=STRICT)
            try:
                je = JE.build_engine(JR.get(arch), max_seq=MAX_SEQ,
                                     flash_dir=str(tmp_path_factory.mktemp("ref")))
            finally:
                jax.jit = orig
            emb = CV.embedding_from_reference(je.embedding.flash._maps[je.embedding.name],
                                              str(tmp_path_factory.mktemp("port")))
            pe = PE.build_engine(PR.get(arch), max_seq=MAX_SEQ, device="cpu",
                                 params=CV.params_from_reference(je.params), embedding=emb)
            built[arch] = (je, pe)
        return built[arch]
    return get


def _jax_loop(je, **kw):
    orig = jax.jit
    jax.jit = functools.partial(orig, compiler_options=STRICT)
    try:
        return JE.EngineLoop(je, **kw)
    finally:
        jax.jit = orig


def _trace(seed=5):
    """Five requests of 9-41 tokens (none a multiple of 8: every final chunk
    is padded), 4-8 new tokens, arriving over six steps into 3 slots with a
    16-token chunk budget: long prompts sit mid-prefill while rows decode,
    and slots are reused."""
    rng = np.random.default_rng(seed)
    lens = [41, 9, 27, 19, 35]
    specs = [([int(t) for t in rng.integers(1, 500, n)], int(rng.integers(4, 9)))
             for n in lens]
    return specs, [0, 0, 1, 3, 6]


def _pressure(loop, make):
    """Three requests (13, 30 and 21 tokens) on 2 slots: ``b`` is spilled
    once its first chunk is in, then the loop runs dry; queue patience
    preempts a decoding row."""
    rng = np.random.default_rng(13)
    reqs = [make(uid, [int(t) for t in rng.integers(1, 400, n)], m)
            for uid, (n, m) in enumerate([(13, 8), (30, 4), (21, 5)])]
    a, b, c = reqs
    for r in reqs:
        loop.submit(r)
    for _ in range(50):
        loop.step()
        st = next((s for s in loop._prefilling.values() if s["req"] is b), None)
        if st is not None and st["next"] > 0:
            break
    else:
        pytest.fail("b never reached a chunk boundary mid-prefill")
    loop._spill_prefilling_row(b)
    assert b.resume_prefill and b.preemptions == 1
    for _ in range(300):
        if not loop.scheduler.has_work():
            break
        loop.step()
    assert all(r.done for r in reqs) and not b.resume_prefill
    return reqs


def _loop_kw(arch: str) -> dict:
    """rwkv6: the staggered trace's loop; jamba: a 4-page pool, proactive
    spill off, queue patience 3 (the pressure trace)."""
    if arch.startswith("rwkv"):
        return LOOP_KW
    cfg = JR.get(arch)
    pb = JP.kv_page_bytes(cfg, JP.kv_page_size(MAX_SEQ))
    return dict(max_slots=2, prefill_chunk=8, prefill_token_budget=8,
                dram_budget_bytes=4 * pb, proactive_spill=False, preempt_patience=3)


def _serve(arch: str, loop, make):
    """The arch's trace through ``loop``; ``make(uid, prompt, max_new)``
    builds a request.  Returns the requests."""
    if not arch.startswith("rwkv"):
        return _pressure(loop, make)
    specs, arrivals = _trace()
    reqs = [make(i, p, m) for i, (p, m) in enumerate(specs)]
    loop.run(reqs, arrivals=arrivals)
    return reqs


COUNTERS = ("prefill_chunks", "spilled_pages", "restored_pages", "decode_tokens")


@pytest.fixture(scope="module")
def reference_runs(engine_pairs):
    """arch -> the JAX loop's run of the arch's trace: greedy tokens,
    preemptions by request, ``COUNTERS`` and ``disabled_features``."""
    runs = {}

    def get(arch):
        if arch not in runs:
            je, _ = engine_pairs(arch)
            je.stats = JE.EngineStats()
            loop = _jax_loop(je, **_loop_kw(arch))
            sj = JS.SamplingParams(temperature=0.0, max_new_tokens=8)
            out = _serve(arch, loop, lambda u, p, m: JRequest(
                uid=u, prompt_tokens=p, max_new_tokens=m, sampling=sj))
            runs[arch] = {"tokens": [r.generated for r in out],
                          "preemptions": [r.preemptions for r in out],
                          "counters": {f: getattr(je.stats, f) for f in COUNTERS},
                          "features": dict(loop.disabled_features),
                          "on_flash": loop.spill.pages_on_flash}
            loop.close()
        return runs[arch]
    return get


def test_configs_and_caches():
    """Both configs as the reference has them; the recurrent entries of both
    caches: leaves [count, B, ...], the paged cache with a spare row."""
    for arch in ("rwkv6-7b", "jamba-1.5-large-398b") + ARCHS:
        p, j = PR.get(arch), JR.get(arch)
        assert [[(q.kind, q.window, q.moe) for q in pats] + [n] for pats, n in p.layer_plan()] \
            == [[(q.kind, q.window, q.moe) for q in pats] + [n] for pats, n in j.layer_plan()]
        assert (p.d_model, p.d_ff, p.num_experts, p.vocab_size, p.rope_kind) == \
            (j.d_model, j.d_ff, j.num_experts, j.vocab_size, j.rope_kind)
    cfg = PR.get("jamba-1.5-large-398b@tiny")
    geom = PE.RP.ExecutionPlan("", None).kv_pool_geometry(cfg, MAX_SEQ, 3)
    paged = PT.init_paged_cache(cfg, 3, geom, torch.device("cpu"))
    dense = PT.init_cache(cfg, 2, MAX_SEQ)
    (pats, count), (tail, one) = cfg.layer_plan()
    assert (count, one) == (3, 1)
    st = paged["stacks"][0][1]
    assert set(st) == {"conv", "ssm"} and st["ssm"].shape == (3, 4, 512, 16)
    assert st["conv"].shape == (3, 4, 3, 512) and st["conv"].dtype == torch.bfloat16
    assert dense["stacks"][1][1]["ssm"].shape == (1, 2, 512, 16)
    rw = PT.init_cache(PR.get("rwkv6-7b@tiny"), 2, MAX_SEQ)["stacks"][0][0]
    assert {k: tuple(v.shape) for k, v in rw.items()} == {
        "x_tm": (3, 2, 256), "x_cm": (3, 2, 256), "wkv": (3, 2, 4, 64, 64)}
    st["ssm"].fill_(1.0)
    PT.reset_row_recurrent(paged, cfg, 1)
    assert not st["ssm"][:, 1].any() and st["ssm"][:, [0, 2, 3]].eq(1.0).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_gates_follow_the_reference(engine_pairs, reference_runs, arch):
    """Recurrent stacks have no window, yet prefix sharing and decode
    bucketing stay off, with the reference's reasons: rwkv6 has neither MoE
    nor a window, so only the layer kind turns bucketing off."""
    je, pe = engine_pairs(arch)
    feats_j = reference_runs(arch)["features"]
    kw = _loop_kw(arch)
    loop = PE.EngineLoop(pe, **kw)
    try:
        assert not loop._full_attn and not loop._bucketed and not loop.pool.prefix_sharing
        assert loop.disabled_features == feats_j
        assert set(feats_j) == {"prefix_sharing", "decode_bucketing"}
        assert "recurrent" in feats_j["decode_bucketing"]
        assert loop.buckets == (kw["max_slots"],)
    finally:
        loop.close()


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_loop_tokens_equal_reference_eager_and_warmed(engine_pairs, reference_runs,
                                                            arch, monkeypatch):
    je, pe = engine_pairs(arch)
    want = reference_runs(arch)
    sp = PS.SamplingParams(temperature=0.0, max_new_tokens=8)
    mixed = []
    body = PE.EngineLoop._step_body

    def spy(self, key):          # a decode step beside a row mid-prefill
        if key[0] == "decode" and self._prefilling:
            mixed.append(key)
        return body(self, key)
    monkeypatch.setattr(PE.EngineLoop, "_step_body", spy)
    captured = []
    monkeypatch.setattr(PE.EngineLoop, "_capture", lambda self, key: (
        captured.append(key), self._graphs.__setitem__(key, _Replay(self, key)),
        self._graph_launches.__setitem__(key, {})))
    tables = len(PL._ROPE_TABLES)
    for warm in (False, True):
        pe.stats = PE.EngineStats()
        loop = PE.EngineLoop(pe, **_loop_kw(arch))
        if warm:
            loop.cuda_graphs = True
            rep = loop.warmup()
            assert rep["graphs"] == len(captured) == 1 + len(rep["chunk_sizes"])
        out = _serve(arch, loop, lambda u, p, m: PE.Request(
            uid=u, prompt_tokens=p, max_new_tokens=m, sampling=sp))
        on_flash = loop.spill.pages_on_flash
        loop.close()
        assert [r.generated for r in out] == want["tokens"], warm
        assert [r.preemptions for r in out] == want["preemptions"]
        assert {f: getattr(pe.stats, f) for f in COUNTERS} == want["counters"]
        assert pe.stats.preemptions == sum(want["preemptions"])
        assert on_flash == want["on_flash"] == 0
        assert pe.stats.recompiles_after_warmup == 0
        assert mixed and pe.dispatch.fallbacks == []
    if arch.startswith("rwkv"):
        assert len(PL._ROPE_TABLES) == tables          # rope_kind "none"
    else:                    # a mid-prefill victim and a preempted decoding row
        assert want["preemptions"] == [1, 1, 0] and want["counters"]["restored_pages"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_leaves_inactive_rows_state(engine_pairs, arch):
    """A decode step over every slot (a staging wave, a row mid-prefill):
    the rows outside ``active`` keep their recurrent state byte for byte,
    the spare row is untouched, and the active rows' state is the one an
    all-active step gives them."""
    _je, pe = engine_pairs(arch)
    loop = PE.EngineLoop(pe, **LOOP_KW)
    loop.close()
    # rows 0 and 2 hold pages (jamba's attention layers append and attend
    # there); row 1's table row is all-trash, as the loop uploads it
    for slot in (0, 2):
        assert loop.pool.alloc_row(slot, 4)
    table = loop.pool.table.copy()
    table[1] = loop.geom.trash_page
    loop.cache["table"] = torch.from_numpy(table)
    gen = torch.Generator().manual_seed(3)
    states = [e for stack in loop.cache["stacks"] for e in stack if isinstance(e, dict)]
    for st in states:
        for v in st.values():
            v.copy_(torch.randn(v.shape, generator=gen).to(v.dtype))
    before = [{k: v.clone() for k, v in st.items()} for st in states]
    emb = pe.embed(np.asarray([[5], [6], [7]]))
    idx, active = torch.arange(3), torch.tensor([True, False, True])
    PT.decode_step_bucketed(pe.params, pe.cfg, emb, loop.cache, idx, pe.dispatch, active=active)
    after = [{k: v.clone() for k, v in st.items()} for st in states]
    for st, b in zip(states, before):
        for k, v in st.items():
            v.copy_(b[k])
    PT.decode_step_bucketed(pe.params, pe.cfg, emb, loop.cache, idx, pe.dispatch)
    for st, b, a in zip(states, before, after):
        for k in st:
            assert torch.equal(a[k][:, [1, 3]], b[k][:, [1, 3]]), k
            assert torch.equal(a[k][:, [0, 2]], st[k][:, [0, 2]]), k
            assert not torch.equal(a[k][:, 0], b[k][:, 0]), k


class _Replay:
    """A captured step's stand-in on the CPU: a replay runs the step on its
    static inputs, as the graph would."""

    def __init__(self, loop, key):
        self.loop, self.key = loop, key

    def replay(self):
        self.loop._step_body(self.key)

    def reset(self):
        pass


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_equal_reference(engine_pairs, arch):
    """Three 21-token prompts (a padded last block), 6 greedy tokens each."""
    je, pe = engine_pairs(arch)
    rng = np.random.default_rng(9)
    prompts = [[int(t) for t in rng.integers(1, 500, 21)] for _ in range(3)]
    out_j = je.generate([JRequest(uid=i, prompt_tokens=p, max_new_tokens=6)
                         for i, p in enumerate(prompts)],
                        JS.SamplingParams(temperature=0.0, max_new_tokens=6))
    out_p = pe.generate([PE.Request(uid=i, prompt_tokens=p, max_new_tokens=6)
                         for i, p in enumerate(prompts)],
                        PS.SamplingParams(temperature=0.0, max_new_tokens=6))
    for a, b in zip(out_j, out_p):
        assert a.generated == b.generated, a.uid
        assert len(b.generated) == 6 and b.done
    assert pe.dispatch.fallbacks == []


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_streaming_on_recurrent_stacks(engine_pairs, reference_runs, arch):
    """A one-byte weight budget streams every stack of 3+ groups through a
    2-slot ring (jamba's by whole groups: its mixed dense/MoE stack cannot
    stream per expert, ROADMAP queue 3 item 5).  The streamed loop serves
    the arch's trace (jamba's mid-prefill victim and preempted row
    included) with the resident loop's greedy tokens and preemptions, and
    the blobs go at close."""
    _je, pe = engine_pairs(arch)
    want = reference_runs(arch)
    eng = PE.Engine(pe.cfg, pe.params, pe.embedding, max_seq=MAX_SEQ, device="cpu",
                    weight_dram_budget_bytes=1, expert_streaming=False)
    sp = PS.SamplingParams(temperature=0.0, max_new_tokens=8)
    try:
        assert eng.weight_policy.active and eng.params["stacks"][0] is None
        loop = PE.EngineLoop(eng, **_loop_kw(arch))
        out = _serve(arch, loop, lambda u, p, m: PE.Request(
            uid=u, prompt_tokens=p, max_new_tokens=m, sampling=sp))
        loop.close()
        assert [r.generated for r in out] == want["tokens"]
        assert [r.preemptions for r in out] == want["preemptions"]
        assert eng.stats.weight_group_hits > 0 and eng.dispatch.fallbacks == []
    finally:
        eng.close()
    assert eng.weight_store.groups() == []
