"""The port's weight and expert streaming against the reference, on the CPU:
the placement policy (every field, over the port's packed leaves), the
weight-group store beside the page spill store in one Flash root, and
``EngineLoop`` on engines whose stacks stream from Flash through a ring of
slots -- qwen2-7b@tiny (6 groups) for whole-group streaming, dbrx-132b@tiny-moe
(6 groups, 8 experts at top-2, GQA with two key/value heads) for
router-aware per-expert streaming -- on the reference's own weights
(``repro_torch.convert``).

Greedy tokens must equal the JAX streamed loop's and the port's resident
loop's, and so must every deterministic counter: prefetch hits and misses
(the chain's requests and fetches do not depend on thread timing: a fetch
waits for an in-flight read), ring installs, the device weight bytes, and
the expert hits, misses and bytes.  Float outputs of one group are held to
one bf16 rounding (1e-2), as in ``test_torch_engine``; router ids exactly.
The JAX steps are compiled with excess precision off, as there."""
import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.core import hybrid_storage as JHS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime import plan as JP  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import sampling as JS  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.configs import registry as PR  # noqa: E402
from repro_torch.core import hybrid_storage as HS  # noqa: E402
from repro_torch.launch import serve as PSV  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.runtime import dispatch as PD  # noqa: E402
from repro_torch.runtime import plan as RP  # noqa: E402
from repro_torch.serving import engine as PE  # noqa: E402
from repro_torch.serving import sampling as PS  # noqa: E402

DENSE = "qwen2-7b@tiny"
MOE = "dbrx-132b@tiny-moe"
STRICT = {"xla_allow_excess_precision": False}


def _strict(build):
    """Run ``build`` with every ``jax.jit`` it makes compiled strictly."""
    orig = jax.jit
    jax.jit = functools.partial(orig, compiler_options=STRICT)
    try:
        return build()
    finally:
        jax.jit = orig


def _head_and_stacks(params):
    head = RP._tree_nbytes(params["final_norm"]) + RP._tree_nbytes(params["lm_head"])
    return head, sum(RP._tree_nbytes(s) for s in params["stacks"])


def _budget(arch, params):
    """The reference tests' budgets: head + 0.6 stacks (dense), head + a third
    of the stack (MoE)."""
    head, stacks = _head_and_stacks(params)
    return head + (int(0.6 * stacks) if arch == DENSE else stacks // 3)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """arch -> (reference engine, port params, port embedding store)."""
    built = {}

    def get(arch):
        if arch not in built:
            je = JE.build_engine(JR.get(arch), max_seq=64,
                                 flash_dir=str(tmp_path_factory.mktemp("ref")))
            emb = CV.embedding_from_reference(
                je.embedding.flash._maps[je.embedding.name],
                str(tmp_path_factory.mktemp("port")))
            built[arch] = (je, CV.params_from_reference(je.params), emb)
        return built[arch]
    return get


def _port_engine(models, arch, budget=None, expert_streaming=True, params=None):
    je, _pp, emb = models(arch)
    params = CV.params_from_reference(je.params) if params is None else params
    return PE.Engine(PR.get(arch), params, emb, max_seq=64, device="cpu",
                     weight_dram_budget_bytes=budget, expert_streaming=expert_streaming)


# ---------------------------------------------------------------------------
# the placement policy
# ---------------------------------------------------------------------------

BUDGETS = ["none", "0.6", "third", "head", "third-whole-group"]


@pytest.mark.parametrize("arch", [DENSE, MOE])
@pytest.mark.parametrize("budget", BUDGETS)
def test_weight_stream_policy_matches_reference(models, arch, budget):
    """Every field of the policy, at no budget, head + 0.6 stacks, head + a
    third of the stacks, the head alone (the ring floors at 2) and, for the
    third, with expert granularity off."""
    je, pp, _emb = models(arch)
    head, stacks = _head_and_stacks(pp)
    b = {"none": None, "0.6": head + int(0.6 * stacks), "third": head + stacks // 3,
         "head": head, "third-whole-group": head + stacks // 3}[budget]
    granular = budget != "third-whole-group"
    want = JP.weight_stream_policy(JR.get(arch), je.params, b, expert_granular=granular)
    got = RP.weight_stream_policy(PR.get(arch), pp, b, expert_granular=granular)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if b is not None and budget != "none":
        assert got.active


@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_packed_leaves_match_reference_byte_for_byte(models, arch):
    """The leaves the policy counts, one by one in flattening order: the same
    bytes (padding, biases, norms and routers included) and the same expert
    flags as the reference's packed tree."""
    je, pp, _emb = models(arch)
    ref = jax.tree_util.tree_flatten_with_path(je.params)[0]
    got = list(RP.tree_leaves_with_path(pp))
    assert len(got) == len(ref)
    for (jpath, jleaf), (path, t) in zip(ref, got):
        assert t.numel() * t.element_size() == jleaf.nbytes, (jpath, path)
        assert tuple(t.shape) == tuple(jleaf.shape), path
        assert RP.is_expert_path(path) == JP.is_expert_path(jpath), path


def test_two_group_stack_stays_resident():
    """A 2-group stack cannot double-buffer a strict subset: resident even
    under a hopeless budget, as in the reference."""
    cfg = PR.get("qwen2-7b@reduced")
    assert cfg.layer_plan()[0][1] == 2
    params = {"final_norm": torch.zeros(10, dtype=torch.int8),
              "lm_head": torch.zeros(10, dtype=torch.int8),
              "stacks": (torch.zeros(1000, dtype=torch.int8),)}
    pol = RP.weight_stream_policy(cfg, params, dram_budget_bytes=50)
    jparams = {k: (tuple(jnp.zeros(v[0].numel(), jnp.int8) for v in [v])
                   if k == "stacks" else jnp.zeros(v.numel(), jnp.int8))
               for k, v in params.items()}
    want = JP.weight_stream_policy(JR.get("qwen2-7b@reduced"), jparams, dram_budget_bytes=50)
    assert dataclasses.asdict(pol) == dataclasses.asdict(want)
    assert not pol.active and pol.placement["stacks/0"] == "dram"


# ---------------------------------------------------------------------------
# the weight-group store
# ---------------------------------------------------------------------------

def test_weight_store_roundtrip_beside_page_spill(tmp_path):
    """int8, float32 and bf16 leaves of odd sizes round-trip bit for bit
    (a miss, then a prefetched hit), expert slices beside group blobs; the
    byte accounting equals the reference store's on the same arrays; a page
    spill store shares the root, and dropping the weights leaves its blobs."""
    rng = np.random.default_rng(0)
    i8 = torch.from_numpy(rng.integers(-128, 128, (1, 3, 7)).astype(np.int8))
    f32 = torch.from_numpy(rng.normal(size=(1, 5)).astype(np.float32))
    b16 = torch.from_numpy(rng.normal(size=(1, 9)).astype(np.float32)).bfloat16()
    experts = [[torch.full((1, 4), e, dtype=torch.int8),
                torch.full((1, 3), e / 3, dtype=torch.float32)] for e in range(3)]
    root = str(tmp_path / "flash")
    store = HS.WeightGroupStore(HS.FlashStore(root))
    spill = HS.PageSpillStore(HS.FlashStore(root))
    jstore = JHS.WeightGroupStore(JHS.FlashStore(str(tmp_path / "ref"),
                                                 JHS.FlashSpec(simulate=False)))
    try:
        store.put_group(0, 0, [i8, f32, b16])
        jstore.put_group(0, 0, [i8.numpy(), f32.numpy(),
                                np.asarray(b16.float().numpy(), jnp.bfloat16)])
        for e, leaves in enumerate(experts):
            store.put_expert_group(0, 0, e, leaves)
            jstore.put_expert_group(0, 0, e, [t.numpy() for t in leaves])
        spill.put_page(3, 1, "s0p0", {"k_q": i8.numpy()}, count_page=True)
        for a, b in zip(store.fetch_group(0, 0).leaves, [i8, f32, b16]):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
        store.prefetch_expert(0, 0, 2)
        got = store.fetch_expert(0, 0, 2)
        assert all(torch.equal(a, b) for a, b in zip(got.leaves, experts[2]))
        assert all(o % HS.WEIGHT_ALIGN == 0 for o in HS.leaf_offsets(store._specs[(0, 0)])[0])
        assert (store.prefetch_hits, store.prefetch_misses) == (1, 1)
        for e in range(3):
            assert store.expert_nbytes(0, 0, e) == jstore.expert_nbytes(0, 0, e)
        assert store.group_nbytes(0, 0) == jstore.group_nbytes(0, 0)
        assert store.stack_nbytes(0) == jstore.stack_nbytes(0)
        assert store.total_nbytes == jstore.total_nbytes
        assert store.flash.bytes_written == sum(
            jstore.flash.nbytes(n) for names in jstore._groups.values() for n in names)
        assert store.groups() == jstore.groups()
        np.testing.assert_array_equal(spill.fetch_page(3, 1, "s0p0")["k_q"], i8.numpy())
        store.drop_all()
        assert store.groups() == [] and spill.has_page(3, 1, "s0p0")
        assert all(f.startswith("pspill") for f in os.listdir(root))
    finally:
        store.close()
        spill.close()
        jstore.close()


# ---------------------------------------------------------------------------
# whole-group streaming: qwen2-7b@tiny
# ---------------------------------------------------------------------------

def _dense_trace(cfg, n, seed=7, max_new=8, request=JRequest, sampling=JS.SamplingParams):
    """``tests/test_weight_stream.py::_trace``: 3-23-token prompts."""
    rng = np.random.default_rng(seed)
    return [request(uid=i,
                    prompt_tokens=[int(t) for t in rng.integers(
                        1, cfg.vocab_size, size=int(rng.integers(3, 24)))],
                    max_new_tokens=int(rng.integers(2, max_new + 1)),
                    sampling=sampling(temperature=0.0))
            for i in range(n)]


def _ring_installs(loop):
    rings = [*loop._wstreams.values(), *loop._expert_rings.values()]
    return sum(r.installs for r in rings)


@pytest.fixture(scope="module")
def dense(models, tmp_path_factory):
    """The same 6-request trace through the JAX streamed loop, the port's
    streamed loop and the port's resident loop (each warmed up first)."""
    je, pp, _emb = models(DENSE)
    budget = _budget(DENSE, pp)
    js = JE.build_engine(JR.get(DENSE), max_seq=64, weight_dram_budget_bytes=budget,
                         flash_dir=str(tmp_path_factory.mktemp("ref_stream")))
    lj = _strict(lambda: JE.EngineLoop(js, max_slots=4, prefill_chunk=16))
    lj.warmup()
    out_j = lj.run(_dense_trace(js.cfg, 6))
    ps = _port_engine(models, DENSE, budget)
    lp = PE.EngineLoop(ps, max_slots=4, prefill_chunk=16)
    lp.warmup()
    out_p = lp.run(_dense_trace(ps.cfg, 6, request=PE.Request, sampling=PS.SamplingParams))
    lr = PE.EngineLoop(_port_engine(models, DENSE), max_slots=4, prefill_chunk=16)
    out_r = lr.run(_dense_trace(ps.cfg, 6, request=PE.Request, sampling=PS.SamplingParams))
    yield {"js": js, "lj": lj, "ps": ps, "lp": lp,
           "tokens": [[r.generated for r in out] for out in (out_j, out_p, out_r)]}
    for loop in (lj, lp, lr):
        loop.close()
    ps.close()
    js.weight_store.close()


def test_dense_stream_matches_reference_and_resident(dense):
    """Greedy tokens equal the JAX streamed loop's and the port's resident
    loop's; prefetch hits and misses, ring installs, device weight bytes
    and the disabled features equal the JAX loop's; nothing fell back."""
    want, got, resident = dense["tokens"]
    assert got == want == resident
    js, ps, lj, lp = dense["js"], dense["ps"], dense["lj"], dense["lp"]
    for f in ("weight_group_hits", "weight_group_misses", "dram_weight_bytes",
              "decode_tokens", "prefill_chunks"):
        assert getattr(ps.stats, f) == getattr(js.stats, f), f
    assert ps.stats.weight_group_misses == 0 and ps.stats.weight_stream_hit_rate == 1.0
    assert _ring_installs(lp) == _ring_installs(lj) > lp.wpolicy.streamed[0].ring_groups
    assert lp.disabled_features == lj.disabled_features
    assert ps.stats.weight_stall_s >= 0.0 and ps.dispatch.fallbacks == []


def test_streamed_stack_dropped_and_on_flash(dense):
    """The streamed stack is gone from the parameter tree and the store holds
    every group, with the reference store's byte counts."""
    js, ps = dense["js"], dense["ps"]
    (sp,) = ps.weight_policy.streamed
    assert ps.params["stacks"][sp.stack] is None and ps.plan.params is ps.params
    assert [k for k in ps.weight_store.groups()] == [(sp.stack, g) for g in range(sp.count)]
    assert ps.weight_store.stack_nbytes(sp.stack) == js.weight_store.stack_nbytes(sp.stack)
    assert ps.weight_store.total_nbytes == js.weight_store.total_nbytes
    assert ps.stats.dram_weight_bytes == ps.weight_policy.resident_bytes


def test_generate_refuses_a_streamed_engine(dense):
    with pytest.raises(RuntimeError, match="EngineLoop"):
        dense["ps"].generate([PE.Request(uid=0, prompt_tokens=[1, 2, 3], max_new_tokens=2)],
                             PS.SamplingParams(temperature=0.0, max_new_tokens=2))


class _RingSpy(PE.WeightRing):
    """Checks the ring's residency on every obtain."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.obtained = []
        self.ptrs = [b.data_ptr() for b in self.buffers]

    def obtain(self, group):
        out = super().obtain(group)
        assert (self.stack, group) not in self.store._inflight
        assert self.slot_group[self.slot_of(group)] == group
        live = [g for g in self.slot_group if g >= 0]
        assert len(live) == len(set(live))
        assert all(g < 0 or g % self.ring_groups == r for r, g in enumerate(self.slot_group))
        assert [b.data_ptr() for b in self.buffers] == self.ptrs
        self.obtained.append(group)
        return out


def test_ring_slots_never_alias(models, dense):
    """Group g runs out of slot g % R, no two slots hold one group, every
    pass obtains the groups in order, slots keep their storage, and slots
    are recycled; warmup() a second time changes nothing."""
    ps = dense["ps"]
    (sp,) = ps.weight_policy.streamed
    loop = PE.EngineLoop(ps, max_slots=2, prefill_chunk=16)
    spy = loop._wstreams[sp.stack] = _RingSpy(ps.weight_store, sp.stack, sp.count,
                                              sp.ring_groups, ps._stream_skel[sp.stack][0],
                                              loop.device)
    rep = loop.warmup()
    installs = spy.installs
    again = loop.warmup()
    assert again["graphs"] == rep["graphs"] == 0 and spy.installs == installs
    assert again["chunk_sizes"] == rep["chunk_sizes"]
    loop.run(_dense_trace(ps.cfg, 3, seed=3, max_new=4, request=PE.Request,
                          sampling=PS.SamplingParams))
    n = sp.count
    assert len(spy.obtained) % n == 0 and len(spy.obtained) >= 2 * n
    assert all(spy.obtained[i:i + n] == list(range(n))
               for i in range(0, len(spy.obtained), n))
    assert spy.installs > sp.ring_groups
    loop.close()


def test_kv_spill_and_weight_stream_share_flash_root(models):
    """Both Flash tiers at once under one root: KV pages of running rows
    spill while the weights stream, and the tokens equal the resident
    engine's on an unconstrained pool."""
    _je, pp, emb = models(DENSE)
    head, stacks = _head_and_stacks(pp)
    eng = _port_engine(models, DENSE, head + int(0.5 * stacks))
    pb = RP.kv_page_bytes(eng.cfg, RP.kv_page_size(eng.max_seq))
    loop = PE.EngineLoop(eng, max_slots=4, prefill_chunk=16, dram_budget_bytes=6 * pb)
    assert loop.proactive and loop.spill.flash.root == eng.weight_store.flash.root == \
        emb.flash.root
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(1, 400, 30)] for _ in range(4)]
    sp = PS.SamplingParams(temperature=0.0, max_new_tokens=10)

    def serve(loop):
        return [r.generated for r in loop.run(
            [PE.Request(uid=i, prompt_tokens=p, max_new_tokens=10, sampling=sp)
             for i, p in enumerate(prompts)])]
    got = serve(loop)
    assert eng.stats.cold_spilled_pages > 0 or eng.stats.spilled_pages > 0
    assert eng.stats.weight_group_hits > 0 and eng.stats.weight_stream_hit_rate >= 0.9
    resident = PE.EngineLoop(_port_engine(models, DENSE), max_slots=4, prefill_chunk=16)
    assert got == serve(resident)
    for lp in (loop, resident):
        lp.close()
    eng.close()


def test_serve_cli_streams_weights_on_cpu(capsys, tmp_path):
    """``launch/serve.py --weight-dram-budget`` on the plain path prints the
    reference's streaming line and serves every request."""
    cfg = PR.get(DENSE)
    params = PT.init_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    head, stacks = _head_and_stacks(params)
    out = PSV.main(["--arch", DENSE, "--device", "cpu", "--max-seq", "64",
                    "--requests", "3", "--max-new", "4", "--no-warmup",
                    "--flash-dir", str(tmp_path),
                    "--weight-dram-budget", str(head + stacks // 3)])
    text = capsys.readouterr().out
    assert "[serve] weight streaming: 1 stack(s) on Flash" in text
    assert "weight groups: hit rate" in text
    assert len(out) == 3 and all(len(r.generated) == 4 for r in out)


# ---------------------------------------------------------------------------
# router-aware expert streaming: dbrx-132b@tiny-moe
# ---------------------------------------------------------------------------

def _moe_trace(n=6, request=JRequest, sampling=JS.SamplingParams):
    """``tests/test_expert_stream.py::_trace``: 8-token prompts."""
    sp = sampling(temperature=0.0, max_new_tokens=8)
    return [request(uid=i, prompt_tokens=list(range(1 + i, 9 + i)), max_new_tokens=8,
                    sampling=sp) for i in range(n)]


def _port_run(eng, n=6, poison_at=None):
    loop = PE.EngineLoop(eng, max_slots=4, prefill_chunk=16)
    reqs = _moe_trace(n, request=PE.Request, sampling=PS.SamplingParams)
    for r in reqs:
        loop.submit(r)
    for i in range(200):
        if i == poison_at:
            for k in loop._expert_pred:
                loop._expert_pred[k] = set()
        loop.step()
        if not loop.scheduler.has_work():
            break
    assert not loop.scheduler.has_work(), "the loop did not drain"
    loop.close()
    return loop, [r.generated for r in reqs]


@pytest.fixture(scope="module")
def moe(models, tmp_path_factory):
    """The MoE trace through the JAX expert-streamed loop and the port's
    expert-streamed, whole-group-streamed and resident loops (none warmed
    up: the counters follow the trace alone)."""
    je, pp, _emb = models(MOE)
    budget = _budget(MOE, pp)
    js = JE.build_engine(JR.get(MOE), max_seq=64, weight_dram_budget_bytes=budget,
                         flash_dir=str(tmp_path_factory.mktemp("ref_moe")))
    lj = _strict(lambda: JE.EngineLoop(js, max_slots=4, prefill_chunk=16))
    tok_j = [r.generated for r in lj.run(_moe_trace())]
    ps = _port_engine(models, MOE, budget)
    lp, tok_p = _port_run(ps)
    pg = _port_engine(models, MOE, budget, expert_streaming=False)
    lg, tok_g = _port_run(pg)
    _lr, tok_r = _port_run(_port_engine(models, MOE))
    yield {"js": js, "lj": lj, "ps": ps, "lp": lp, "lg": lg,
           "tokens": (tok_j, tok_p, tok_g, tok_r)}
    lj.close()
    for e in (ps, pg):
        e.close()
    js.weight_store.close()


def test_expert_stream_matches_reference(moe):
    """Tokens equal among the JAX expert-streamed loop and the port's
    expert-streamed, whole-group-streamed and resident loops; the expert
    hits, misses, bytes fetched and baseline, the group hits and misses and
    the ring installs equal the JAX loop's; per-expert fetches move fewer
    bytes than whole groups."""
    tok_j, tok_p, tok_g, tok_r = moe["tokens"]
    assert tok_p == tok_j == tok_g == tok_r
    js, ps, lj, lp, lg = (moe[k] for k in ("js", "ps", "lj", "lp", "lg"))
    assert lp._expert_rings and not lp._wstreams
    assert lg._wstreams and not lg._expert_rings
    for f in ("expert_prefetch_hits", "expert_prefetch_misses", "expert_bytes_fetched",
              "expert_bytes_baseline", "weight_group_hits", "weight_group_misses",
              "dram_weight_bytes"):
        assert getattr(ps.stats, f) == getattr(js.stats, f), f
    (ring,) = lp._expert_rings.values()
    (jring,) = lj._expert_rings.values()
    assert (ring.installs, ring.expert_installs) == (jring.installs, jring.expert_installs)
    assert ps.stats.expert_prefetch_hits > 0
    assert ps.stats.expert_bytes_fetched < ps.stats.expert_bytes_baseline
    assert ps.dispatch.fallbacks == []


def test_sticky_routing_hit_rate(models):
    """A zeroed router ties every logit, so top-k always picks the lowest
    ids: the last-two-visit prediction converges, the hit rate clears 0.8
    and the bytes saved approach the 6/8 of unrouted experts."""
    je, _pp, _emb = models(MOE)
    params = CV.params_from_reference(je.params)
    for stack in params["stacks"]:
        for pat in stack:
            pat["moe"]["router"] = torch.zeros_like(pat["moe"]["router"])
    eng = _port_engine(models, MOE, _budget(MOE, params), params=params)
    _loop, toks = _port_run(eng, n=8)
    s = eng.stats
    assert toks and s.expert_prefetch_hit_rate >= 0.8, s.expert_prefetch_hit_rate
    assert s.expert_bytes_saved_frac > 0.3, s.expert_bytes_saved_frac
    eng.close()


def test_cold_expert_miss_reruns_the_group(models, moe):
    """The prediction emptied at step 3: every later visit takes the
    cold-miss path (install what the router picked, run the group again);
    the loop drains and commits the resident tokens."""
    _je, pp, _emb = models(MOE)
    eng = _port_engine(models, MOE, _budget(MOE, pp))
    loop, toks = _port_run(eng, poison_at=3)
    assert toks == moe["tokens"][3]
    assert eng.stats.expert_prefetch_misses > 0 and loop.expert_reruns > 0
    assert eng.dispatch.fallbacks == []
    eng.close()


@pytest.mark.parametrize("batch", [4, 8])
def test_group_moe_ids_match_reference(models, batch):
    """One decode group on both packages (4 rows: the selected-expert path;
    8 rows: capacity dispatch): the router ids collected equal the
    reference's exactly, the output to one bf16 rounding."""
    je, pp, _emb = models(MOE)
    cfg = je.cfg
    g = 2
    rng = np.random.default_rng(batch)
    x = rng.normal(size=(batch, 1, cfg.d_model)).astype(np.float32)
    geom = je.plan.kv_pool_geometry(cfg, 64, batch)
    jcache = JT.init_paged_cache(cfg, batch, 64, geom)
    pos = jnp.asarray(rng.integers(0, 8, batch), jnp.int32)
    ctx = JT.StepCtx(cfg, dispatch=je.dispatch)

    def group(gp, x, scache, pos, table):
        collect = {}
        x, _nsc, _aux = JT.run_stack_group(gp, cfg, 0, "decode", x, pos[:, None], scache,
                                           jnp.asarray(g, jnp.int32), pos, table, ctx,
                                           collect=collect)
        return x, collect["moe_ids"]
    jx, jids = jax.jit(group, compiler_options=STRICT)(
        jax.tree.map(lambda a: a[g:g + 1], je.params["stacks"][0]),
        jnp.asarray(x, jnp.bfloat16), jcache["stacks"][0], pos, jcache["table"])
    pcfg = PR.get(MOE)
    pgeom = RP.ExecutionPlan(quant_tag="", params=pp).kv_pool_geometry(pcfg, 64, batch)
    pcache = PT.init_paged_cache(pcfg, batch, pgeom, torch.device("cpu"))
    ppos = torch.from_numpy(np.array(pos))
    got = {}
    px = PT.run_stack_group(tuple(PT.layer_slice(p, g) for p in pp["stacks"][0]), pcfg, 0,
                            "decode", torch.from_numpy(x).bfloat16(), ppos[:, None], pcache,
                            g, ppos, pcache["table"], PD.Dispatcher(), collect=got)
    np.testing.assert_array_equal(got["moe_ids"].numpy(), np.asarray(jids))
    np.testing.assert_allclose(px.float().numpy(), np.asarray(jx, np.float32),
                               rtol=1e-2, atol=1e-2)
