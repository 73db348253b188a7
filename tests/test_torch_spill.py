"""The port's DRAM-Flash KV tier against the reference, on the CPU: the
Flash prefetcher and page spill store, the pool manager's residency machine
(spill / stage / commit / unstage / restore) on random walks, the
scheduler's preemption decisions, and ``EngineLoop`` traces whose KV
outgrows the DRAM pool (cold pages of running rows on Flash and staged back
each decode, decode in staging waves, adoption while the donor's cold pages
sit on Flash, preemption to Flash under page pressure and under queue
patience, and MoE waves on the unbucketed step), all at ``@reduced`` scale
with ``max_seq`` 64 on the reference's own weights.

Greedy tokens must equal the JAX loop's, and so must every deterministic
counter (pages spilled, restored and spilled cold, preemptions, wave
counts, peak KV pages) and the allocator's final state.  Prefetch hit rates
depend on thread timing and are only held to [0, 1].  The JAX steps are
compiled with excess precision off, as in ``test_torch_engine``."""
import dataclasses
import functools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.core import hybrid_storage as JHS  # noqa: E402
from repro.core import kv_pool as JKP  # noqa: E402
from repro.runtime import plan as JP  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import sampling as JS  # noqa: E402
from repro.serving import scheduler as JSC  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.configs import registry as PR  # noqa: E402
from repro_torch.core import hybrid_storage as HS  # noqa: E402
from repro_torch.core import kv_pool as KP  # noqa: E402
from repro_torch.core import quantization as Q  # noqa: E402
from repro_torch.serving import engine as PE  # noqa: E402
from repro_torch.serving import sampling as PS  # noqa: E402
from repro_torch.serving import scheduler as PSC  # noqa: E402

STRICT = {"xla_allow_excess_precision": False}


# ---------------------------------------------------------------------------
# the Flash prefetcher and the page spill store
# ---------------------------------------------------------------------------

def _recording(base):
    class Recording(base):
        """Keyed blobs with a load delay, recording every backing load."""

        def __init__(self, data, delay=0.0):
            self.data, self.delay, self.loads = dict(data), delay, []
            super().__init__()

        def _load(self, key):
            if self.delay:
                time.sleep(self.delay)
            self.loads.append(key)
            if isinstance(self.data[key], Exception):
                raise self.data[key]
            return self.data[key]

        def _has(self, key):
            return key in self.data
    return Recording


def test_prefetcher_accounting_matches_reference():
    """Miss (synchronous load), hit through an in-flight request, a
    duplicate request deduped, an unknown key never queued: the same
    answers, loads and counters as the reference's prefetcher."""
    data = {"a": b"alpha", "b": b"bravo", "c": b"charlie"}
    out = []
    for base in (JHS._FlashPrefetcher, HS._FlashPrefetcher):
        pf = _recording(base)(data, delay=0.02)
        try:
            got = [pf._obtain("a")]
            pf._request("b")
            got.append(pf._obtain("b"))
            pf._request("c")
            pf._request("c")
            pf._request("nope")
            got.append(pf._obtain("c"))
            out.append((got, sorted(pf.loads), pf.prefetch_hits,
                        pf.prefetch_misses, pf.hit_rate))
        finally:
            pf.close()
    assert out[0] == out[1] == ([b"alpha", b"bravo", b"charlie"],
                                ["a", "b", "c"], 2, 1, 2 / 3)


def test_prefetcher_thread_lifetime_and_load_errors():
    """The worker starts at the first request, a load that raises reaches
    the consumer (the worker lives on), and after close() the thread is gone
    and every fetch reads synchronously."""
    pf = _recording(HS._FlashPrefetcher)({"x": 1, "bad": OSError("gone")})
    assert pf._thread is None
    assert pf._obtain("x") == 1 and pf._thread is None
    pf._request("bad")
    thread = pf._thread
    assert thread is not None and thread.daemon
    with pytest.raises(OSError, match="gone"):
        pf._obtain("bad")
    pf._request("x")
    assert pf._obtain("x") == 1
    assert pf.prefetch_hits == 2
    pf.close()
    assert not thread.is_alive() and pf._thread is None
    pf._request("x")                          # ignored once closed
    assert pf._thread is None
    assert pf._obtain("x") == 1 and pf.prefetch_misses == 2


def test_page_spill_store_roundtrip_matches_reference(tmp_path):
    """Row snapshots and page blobs (int8 keys, float32 scales, fp8 values
    as uint8) round-trip byte for byte; pages_on_flash counts as the
    reference's; Flash bytes written and read are counted."""
    rng = np.random.default_rng(0)
    kq = rng.integers(-128, 128, (2, 1, 16, 4, 8)).astype(np.int8)
    ks = rng.normal(size=(2, 1, 16, 4)).astype(np.float32)
    v8 = (torch.from_numpy(rng.normal(size=(2, 1, 16, 4, 8)).astype(np.float32)) * 300
          ).to(Q.FP8_DTYPE)
    vb = v8.view(torch.uint8).numpy()
    refs = []
    for hs, root in ((JHS, tmp_path / "ref"), (HS, tmp_path / "port")):
        flash = (hs.FlashStore(str(root), hs.FlashSpec(simulate=False)) if hs is JHS
                 else hs.FlashStore(str(root)))
        store = hs.PageSpillStore(flash)
        try:
            store.put_page(5, 2, "s0p0", {"k_q": kq, "k_scale": ks, "v": vb},
                           count_page=True)
            store.put_page(5, 2, "s1p0", {"k_q": kq + 1})
            seen = [store.pages_on_flash, store.has_page(5, 2, "s0p0"),
                    store.has_page(5, 3, "s0p0")]
            store.prefetch_page(5, 2, "s0p0")
            a = store.fetch_page(5, 2, "s0p0")
            b = store.fetch_page(5, 2, "s1p0")
            store.put_page(5, 2, "s0p0", {"k_q": kq}, count_page=True)
            store.put(5, "s0p0", {"k_q": kq[:, 0]}, pages=2)
            seen.append(store.pages_on_flash)
            store.drop_groups(5, ["s0p0"])
            seen += [store.pages_on_flash, store.has_page(5, 2, "s0p0")]
            store.drop(5)
            seen += [store.pages_on_flash, store.has_page(5, 2, "s0p0"),
                     store.prefetch_hits, store.prefetch_misses]
            refs.append(seen)
            assert a["k_q"].tobytes() == kq.tobytes() and a["k_q"].dtype == np.int8
            assert a["k_scale"].tobytes() == ks.tobytes()
            assert b["k_q"].tobytes() == (kq + 1).tobytes()
            back = torch.from_numpy(np.ascontiguousarray(a["v"])).view(Q.FP8_DTYPE)
            assert torch.equal(back.view(torch.uint8), v8.view(torch.uint8))
        finally:
            store.close()
    assert refs[0] == refs[1] == [1, True, False, 3, 1, True, 0, False, 1, 1]
    assert flash.bytes_written == 3 * kq.nbytes + ks.nbytes + vb.nbytes + kq[:, 0].nbytes
    assert flash.bytes_read == 2 * kq.nbytes + ks.nbytes + vb.nbytes
    flash.put("kept", ks)                   # another process maps it read-only
    again = HS.FlashStore(str(tmp_path / "port"))
    again.open("kept", ks.shape, ks.dtype)
    assert again.read_view("kept").tobytes() == ks.tobytes()
    assert again.bytes_read == ks.nbytes and again.nbytes("kept") == ks.nbytes
    again.delete("kept")
    assert not (tmp_path / "port" / "kept.bin").exists()


def test_read_write_pages_roundtrip():
    """Every layer's bytes of some pages to the host and into the staging
    pages past the trash page, in place: the pool tensors keep their
    storage and the bytes match, fp8 included."""
    geom = KP.PoolGeometry(page_size=4, num_pages=6, pages_per_row=3,
                           staging_pages=3)
    pool = KP.init_paged_layer(geom, 2, 8, layers=3)
    gen = torch.Generator().manual_seed(0)
    pool.k_q.copy_(torch.randint(-128, 128, pool.k_q.shape, generator=gen))
    pool.k_scale.copy_(torch.rand(pool.k_scale.shape, generator=gen))
    pool.v.copy_((torch.randn(pool.v.shape, generator=gen) * 100).to(Q.FP8_DTYPE))
    ptrs = [getattr(pool, f).data_ptr() for f in KP.KV_FIELDS]
    src = [4, 1]
    got = KP.read_pages(pool, src)
    assert got["v"].dtype == np.uint8 and got["k_q"].shape == (3, 2, 4, 2, 8)
    sids = list(range(geom.staging_base, geom.staging_base + 2))
    KP.write_pages(pool, sids, got)
    for f in KP.KV_FIELDS:
        x = KP._bytes_view(getattr(pool, f))
        assert torch.equal(x[:, sids], x[:, src]), f
    assert [getattr(pool, f).data_ptr() for f in KP.KV_FIELDS] == ptrs
    assert KP.read_pages(pool, [])["k_q"].shape == (3, 0, 4, 2, 8)
    with pytest.raises(ValueError):
        KP.write_pages(pool, sids[:1], got)


# ---------------------------------------------------------------------------
# the pool manager's residency machine and the scheduler
# ---------------------------------------------------------------------------

def _state(m):
    return {"free": list(m._free), "table": m.table.tolist(),
            "row_pages": [list(r) for r in m.row_pages],
            "row_res": [list(r) for r in m.row_res],
            "refcount": m.refcount.tolist(), "row_shared": m.row_shared.tolist(),
            "index": sorted(m._chain_of_page.items()), "order": list(m._index_order),
            "staging_free": list(m._staging_free), "staged": sorted(m._staged.items()),
            "lru": list(m._stage_lru),
            "stats": (m.prefix_hits, m.prefix_misses, m.prefix_evictions,
                      m.alloc_failures, m.cold_spills, m.spilled_pages),
            "counts": (m.free_pages, m.available_pages, m.pages_in_use,
                       m.flash_page_count, m.staged_count, m.staging_free),
            "residency": m.residency()}


@pytest.mark.parametrize("seed", range(4))
def test_residency_random_walk_matches_reference(seed):
    """The same random alloc / adopt / register / ensure / free / cold
    spill / stage / commit / evict / restore sequence leaves both managers
    in the same state after every step (table, row_res, staging free list,
    LRU, counters), and every call returns the same answer."""
    rng = np.random.default_rng(seed)
    geom = dict(page_size=4, num_pages=12, pages_per_row=6, staging_pages=3)
    jm = JKP.KVPoolManager(JKP.PoolGeometry(**geom), num_slots=4)
    pm = KP.KVPoolManager(KP.PoolGeometry(**geom), num_slots=4)
    vocab = [[int(t) for t in rng.integers(1, 50, int(rng.integers(1, 20)))]
             for _ in range(3)]
    prompts = {}
    for _ in range(200):
        op, row = int(rng.integers(0, 9)), int(rng.integers(0, 4))
        both = (jm, pm)
        if op == 0 and not jm.row_pages[row]:
            toks = vocab[int(rng.integers(0, len(vocab)))]
            ok = [m.alloc_row(row, len(toks), token_ids=toks) for m in both]
            assert ok[0] == ok[1]
            if ok[0]:
                prompts[row] = toks
                jm.row_pos[row] = pm.row_pos[row] = len(toks)
        elif op == 1 and jm.row_pages[row]:
            assert len({m.register_prefix(row, prompts[row]) for m in both}) == 1
        elif op == 2 and 0 < len(jm.row_pages[row]) < geom["pages_per_row"]:
            at = len(jm.row_pages[row]) * geom["page_size"]
            assert len({m.ensure(row, at) for m in both}) == 1
            jm.row_pos[row] = pm.row_pos[row] = at
        elif op == 3 and jm.row_pages[row]:
            assert len({m.free_row(row) for m in both}) == 1
            prompts.pop(row, None)
        elif op == 4 and jm.row_pages[row]:
            cold = jm.cold_pages(row)
            assert pm.cold_pages(row) == cold
            if cold:
                assert len({m.spill_page(row, cold[0]) for m in both}) == 1
        elif op == 5:
            flash = [i for i, s in enumerate(jm.row_res[row]) if s == JKP.RES_FLASH]
            if flash:
                sids = [m.begin_stage(row, flash[0]) for m in both]
                assert sids[0] == sids[1]
                if sids[0] is None:
                    victim = {m.stage_victim(protect=set()) for m in both}
                    assert len(victim) == 1
                    victim = victim.pop()
                    if victim is None:
                        continue
                    for m in both:
                        m.unstage(*victim)
                    assert len({m.begin_stage(row, flash[0]) for m in both}) == 1
                assert _state(jm) == _state(pm)          # the in-flight window
                for m in both:
                    m.commit_stage(row, flash[0])
        elif op == 6 and jm._staged:
            victim = {m.stage_victim(protect=set()) for m in both}
            assert len(victim) == 1
            victim = victim.pop()
            if victim is not None:
                for m in both:
                    m.unstage(*victim)
        elif op == 7:
            off = [i for i, s in enumerate(jm.row_res[row])
                   if s in (JKP.RES_FLASH, JKP.RES_STAGED)]
            if off:
                assert len({m.restore_page(row, off[0]) for m in both}) == 1
        elif op == 8 and jm.row_pages[row]:
            staged = [i for i, s in enumerate(jm.row_res[row]) if s == JKP.RES_STAGED]
            if staged:                                   # an LRU touch
                assert len({m.begin_stage(row, staged[-1]) for m in both}) == 1
            assert jm.flash_idxs(row) == pm.flash_idxs(row)
            assert jm.dram_pages_held(row) == pm.dram_pages_held(row)
        assert _state(jm) == _state(pm)
    for row in range(4):
        if jm.row_pages[row]:
            assert jm.free_row(row) == pm.free_row(row)
    assert _state(jm) == _state(pm)
    assert pm.staging_free == geom["staging_pages"]


def _sched_state(s):
    return ([r.uid if r is not None else None for r in s.running],
            [(r.uid, r.arrival_step, r.preemptions) for r in s.waiting])


@pytest.mark.parametrize("seed", range(2))
def test_preemption_decisions_match_reference(seed):
    """A random schedule of submits, admissions, patience preemptions,
    page-pressure evictions and finishes over two schedulers with their own
    pools: the same admissions, the same victims, the same queues."""
    rng = np.random.default_rng(seed)
    geom = dict(page_size=4, num_pages=10, pages_per_row=6, staging_pages=2)
    pools = [JKP.KVPoolManager(JKP.PoolGeometry(**geom), 3),
             KP.KVPoolManager(KP.PoolGeometry(**geom), 3)]
    headroom = [0]
    scheds = [JSC.ContinuousScheduler(3, 24, preempt_patience=2, pool=pools[0],
                                      spill_headroom=lambda: headroom[0]),
              PSC.ContinuousScheduler(3, 24, pools[1], preempt_patience=2,
                                      spill_headroom=lambda: headroom[0])]
    reqs = [{}, {}]
    uid = 0
    for step in range(120):
        for s in scheds:
            s.step = step
        headroom[0] = int(rng.integers(0, 3))
        if rng.random() < 0.4:
            toks = [int(t) for t in rng.integers(1, 30, int(rng.integers(2, 12)))]
            prio, mnt = int(rng.integers(0, 2)), int(rng.integers(2, 10))
            for side, (mod, s) in enumerate(((JSC, scheds[0]), (PSC, scheds[1]))):
                r = mod.Request(uid=uid, prompt_tokens=list(toks), max_new_tokens=mnt,
                                priority=prio)
                reqs[side][uid] = r
                s.submit(r)
            uid += 1
        got = []
        exclude = {int(rng.integers(0, 3))} if seed else None
        for side, s in enumerate(scheds):
            pre = s.maybe_preempt(exclude_slots=exclude)
            if pre is not None:
                pools[side].free_row(pre[0])
            adm = s.admit()
            for slot, r in adm:
                assert pools[side].alloc_row(slot, len(r.context_tokens))
            got.append((None if pre is None else (pre[0], pre[1].uid),
                        [(slot, r.uid) for slot, r in adm]))
        assert got[0] == got[1]
        # the same random progress, evictions and finishes on both sides
        for slot in range(3):
            if scheds[0].running[slot] is None:
                continue
            roll = rng.random()
            for side, s in enumerate(scheds):
                r = s.running[slot]
                if roll < 0.1:
                    s.evict(r)
                    pools[side].free_row(slot)
                elif roll < 0.25 or len(r.generated) + 1 >= r.decode_cap:
                    s.finish(r)
                    pools[side].free_row(slot)
                else:
                    r.generated.append(7)
        assert _sched_state(scheds[0]) == _sched_state(scheds[1])
        assert [scheds[0].need_pages(r) for r in scheds[0].waiting] == \
            [scheds[1].need_pages(r) for r in scheds[1].waiting]
    assert sum(r.preemptions for r in reqs[1].values()) == \
        sum(r.preemptions for r in reqs[0].values()) > 0


# ---------------------------------------------------------------------------
# EngineLoop on oversubscribed pools
# ---------------------------------------------------------------------------

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


def _snoop(loop):
    """Record the wave count of every decode step and the Flash-resident
    cold pages at every admission."""
    loop.waves, loop.flash_at_admit = [], {}
    plan, admit = loop._plan_waves, loop._admit_into_slot

    def plan_waves(slots):
        waves = plan(slots)
        loop.waves.append(len(waves))
        return waves

    def admit_into_slot(req, slot):
        loop.flash_at_admit[req.uid] = loop.pool.flash_page_count
        admit(req, slot)
    loop._plan_waves, loop._admit_into_slot = plan_waves, admit_into_slot


@pytest.fixture
def loops():
    """Builds a JAX and a port loop with the same arguments (the JAX steps
    compiled strictly), each recording its wave counts; closes both at
    teardown, so no prefetch worker outlives the test."""
    made = []

    def build(je, pe, pages, **kw):
        pb = JP.kv_page_bytes(je.cfg, JP.kv_page_size(je.max_seq))
        orig = jax.jit
        jax.jit = functools.partial(orig, compiler_options=STRICT)
        try:
            lj = JE.EngineLoop(je, dram_budget_bytes=pages * pb, **kw)
        finally:
            jax.jit = orig
        lp = PE.EngineLoop(pe, dram_budget_bytes=pages * pb, **kw)
        for loop in (lj, lp):
            made.append(loop)
            _snoop(loop)
        return lj, lp
    yield build
    for loop in made:
        loop.close()


def _serve(je, pe, lj, lp, prompts, max_new, arrivals=None):
    """The same trace through both loops on fresh stats; returns both stats
    after checking tokens, counters and the allocator's end state."""
    je.stats, pe.stats = JE.EngineStats(), PE.EngineStats()
    sj = JS.SamplingParams(temperature=0.0, max_new_tokens=max(max_new))
    sp = PS.SamplingParams(temperature=0.0, max_new_tokens=max(max_new))
    out_j = lj.run([JSC.Request(uid=i, prompt_tokens=p, max_new_tokens=m, sampling=sj)
                    for i, (p, m) in enumerate(zip(prompts, max_new))], arrivals=arrivals)
    out_p = lp.run([PE.Request(uid=i, prompt_tokens=p, max_new_tokens=m, sampling=sp)
                    for i, (p, m) in enumerate(zip(prompts, max_new))], arrivals=arrivals)
    for a, b in zip(out_j, out_p):
        assert b.done and b.generated == a.generated, a.uid
        assert b.preemptions == a.preemptions, a.uid
    js, ps = je.stats, pe.stats
    for f in ("spilled_pages", "restored_pages", "cold_spilled_pages",
              "prefill_chunks", "shared_prompt_tokens", "decode_tokens"):
        assert getattr(ps, f) == getattr(js, f), f
    assert ps.preemptions == sum(r.preemptions for r in out_j)
    assert [r.preemptions for r in ps.requests] == [r.preemptions for r in js.requests]
    assert lp.waves == lj.waves
    assert lp.peak_kv_pages == lj.peak_kv_pages
    assert lp.flash_at_admit == lj.flash_at_admit
    assert _state(lp.pool) == _state(lj.pool)
    # the staging reserve came back whole and no blob is left on Flash
    assert lp.pool.staged_count == 0
    assert lp.pool.staging_free == lp.geom.staging_pages
    assert lp.spill.pages_on_flash == lj.spill.pages_on_flash == 0
    assert all(0.0 <= r <= 1.0 for r in ps.flash_hit_rates)
    assert len(ps.flash_hit_rates) == len(js.flash_hit_rates)
    assert 0.0 <= ps.flash_hit_rate <= 1.0
    assert pe.dispatch.fallbacks == []
    return js, ps


def _prompts(seed, n, length):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 400, length)] for _ in range(n)]


@pytest.mark.parametrize("budgets", [False, True])
def test_oversubscribed_decode_matches_reference(engine_pairs, loops, budgets):
    """4 rows whose KV peaks past a 6-page pool: cold pages live on Flash and
    are staged back each decode; with a 3-page Flash budget and a token
    budget too, fewer pages may spill and admission waits longer."""
    je, pe = engine_pairs("qwen2-7b@reduced")
    pb = JP.kv_page_bytes(je.cfg, JP.kv_page_size(je.max_seq))
    kw = dict(flash_budget_bytes=3 * pb, token_budget=150) if budgets else {}
    lj, lp = loops(je, pe, 6, max_slots=4, **kw)
    assert dataclasses.astuple(lp.geom) == dataclasses.astuple(lj.geom) and lp.proactive
    assert lp.spill_policy.flash_budget_pages == lj.spill_policy.flash_budget_pages
    _, ps = _serve(je, pe, lj, lp, _prompts(7, 4, 30), [20] * 4)
    assert ps.cold_spilled_pages > 0
    assert lp.peak_kv_pages > lp.geom.num_pages


def test_multi_wave_decode_matches_reference(engine_pairs, loops):
    """Prefix sharing off: every row's old pages may spill, and the decode
    needs more staging waves than one."""
    je, pe = engine_pairs("qwen2-7b@reduced")
    lj, lp = loops(je, pe, 6, max_slots=4, prefix_sharing=False)
    _serve(je, pe, lj, lp, _prompts(23, 4, 30), [20] * 4)
    assert max(lp.waves) >= 2


def test_adoption_while_donor_cold_pages_on_flash(engine_pairs, loops):
    """A prompt adopts the donor's indexed head page while the donor's cold
    pages sit on Flash."""
    je, pe = engine_pairs("qwen2-7b@reduced")
    rng = np.random.default_rng(31)
    head = [int(t) for t in rng.integers(1, 400, 19)]
    prompts = [head, [int(t) for t in rng.integers(1, 400, 17)],
               head + [int(t) for t in rng.integers(1, 400, 4)]]
    lj, lp = loops(je, pe, 6, max_slots=3)
    h0 = lp.pool.prefix_hits
    _, ps = _serve(je, pe, lj, lp, [prompts[0], prompts[2], prompts[1]],
                   [45, 6, 30], arrivals=[0, 30, 0])
    assert lp.pool.prefix_hits > h0 and ps.cold_spilled_pages > 0
    assert lp.flash_at_admit[1] > 0


@pytest.mark.parametrize("how", ["page_pressure", "patience"])
def test_preemption_to_flash_matches_reference(engine_pairs, loops, how):
    """On a 4-page pool: full-row preemption under page pressure mid-decode
    (proactive spill off), and under queue patience with a third request
    waiting; rows come back from Flash bit for bit."""
    je, pe = engine_pairs("qwen2-7b@reduced")
    if how == "page_pressure":
        lj, lp = loops(je, pe, 4, max_slots=2, proactive_spill=False)
        prompts = _prompts(12, 2, 8)
    else:
        lj, lp = loops(je, pe, 4, max_slots=2, preempt_patience=2)
        prompts = _prompts(3, 3, 8)
    _, ps = _serve(je, pe, lj, lp, prompts, [30] * len(prompts))
    assert ps.preemptions >= 1 and ps.restored_pages > 0


def test_moe_oversubscribed_waves_match_reference(engine_pairs, loops):
    """moonshot-v1-16b-a3b@reduced decodes every slot unbucketed: rows
    outside a staging wave ride along inactive and keep their logits."""
    je, pe = engine_pairs("moonshot-v1-16b-a3b@reduced")
    lj, lp = loops(je, pe, 6, max_slots=4, prefix_sharing=False)
    assert not lp._bucketed
    _, ps = _serve(je, pe, lj, lp, _prompts(23, 4, 30), [20] * 4)
    assert max(lp.waves) >= 2 and ps.cold_spilled_pages > 0
