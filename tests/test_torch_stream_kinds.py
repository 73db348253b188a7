"""Weight streaming on every stack kind, and the paper's quantization
variants on every path that moves KV or weights, against the reference on
the CPU.

The split step (``EngineLoop._stream_stacks``) hands each group a chunk's
row and real length or a decode step's active rows, so windowed rings and
recurrent states stream as the resident step runs them.  Each streamed case
holds the port's streamed loop to the JAX streamed loop on one trace --
greedy tokens, weight-group hits and misses, ring installs, device weight
bytes, chunks and decode tokens, ``disabled_features`` -- and to the port's
resident loop's tokens:

- gemma3-27b@tiny (three periods of five windowed and one global layer) at
  ``max_seq`` 512, whose 128-token pages keep the reference's 1024-token
  ring at 9 pages (at 64 its unrolled ring scatter takes minutes to
  compile), and a copy with ``window=16`` at ``max_seq`` 64, where rings
  wrap;
- rwkv6-7b@tiny (a streamed 3-group stack, a resident tail);
- jamba-1.5-large-398b@tiny by whole groups, on the pressure trace (a
  mid-prefill victim and a preempted decoding row on a 4-page pool).  Its
  stack mixes dense and MoE FFNs; the reference flags the dense FFN's
  leaves as expert tables and cannot export it per expert (ROADMAP queue 3
  item 5), and the port refuses that combination;
- qwen2-7b@tiny under int4 keys, bf16 values, A16 and groups of 128: the
  group-wise stack's blobs and ring slots, then the same variants through
  an oversubscribed KV pool (``tests/test_torch_spill.py``'s checks: cold
  spill, staging waves, preemption and restore).

The variants on the other paths: ``read_pages``/``write_pages`` and the
page spill store over int4-key and bf16-value pages, bit for bit against
the reference's snapshot; ring appends, ring decode and the windowed chunk
over int4 keys and bf16 values (one bf16 rounding, as in
``test_torch_gemma3``); moonshot-v1-16b-a3b@tiny-moe under A16 through
``EngineLoop``, the float path taking both MoE branches.  An expert group
run again after a cold miss starts from the recurrent state it had before
its first run: on an all-MoE jamba@tiny its state and output equal one
run's bit for bit.

The JAX steps are compiled with excess precision off, as in
``test_torch_engine``."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.core import hybrid_storage as JHS  # noqa: E402
from repro.core import kv_pool as JKP  # noqa: E402
from repro.core import quantization as JQ  # noqa: E402
from repro.core.precision import DEFAULT_POLICY as JPOL  # noqa: E402
from repro.runtime import plan as JP  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import sampling as JS  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.configs import registry as PR  # noqa: E402
from repro_torch.core import hybrid_storage as HS  # noqa: E402
from repro_torch.core import kv_pool as PKP  # noqa: E402
from repro_torch.core import quantization as PQ  # noqa: E402
from repro_torch.core.precision import DEFAULT_POLICY as PPOL  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.runtime import dispatch as PD  # noqa: E402
from repro_torch.runtime import plan as RP  # noqa: E402
from repro_torch.serving import engine as PE  # noqa: E402
from repro_torch.serving import sampling as PS  # noqa: E402
from test_torch_cuda import expert_rerun_case  # noqa: E402
from test_torch_engine import STRICT  # noqa: E402
from test_torch_recurrent import _pressure  # noqa: E402
from test_torch_spill import _prompts, _serve as _spill_serve, loops  # noqa: E402,F401
from test_torch_wstream import _dense_trace, _ring_installs, _strict  # noqa: E402

QUANTVAR = dict(kv_key_bits=4, kv_value_fp8=False, act_bits=16, group_size=128)
KVVAR = dict(kv_key_bits=4, kv_value_fp8=False)
JAMBA = "jamba-1.5-large-398b@tiny"
# name -> (arch, window, quant, max_seq)
MODELS = {
    "gemma3": ("gemma3-27b@tiny", 0, None, 512),
    "gemma3-w16": ("gemma3-27b@tiny", 16, None, 64),
    "rwkv6": ("rwkv6-7b@tiny", 0, None, 64),
    "jamba": (JAMBA, 0, None, 64),
    "qwen2-quantvar": ("qwen2-7b@tiny", 0, QUANTVAR, 64),
    "qwen2-kvvar": ("qwen2-7b@tiny", 0, KVVAR, 64),
    "moonshot-a16": ("moonshot-v1-16b-a3b@tiny-moe", 0, {"act_bits": 16}, 64),
}


def _variant(cfg, quant_mod, window=0, quant=None, all_moe=False):
    """``cfg`` with its windowed layers at ``window``, ``quant`` fields
    (a ``quant_mod.QuantConfig``), or every layer's FFN an MoE one; the
    same replacement on either package's config."""
    period = tuple(dataclasses.replace(p, window=window if (window and p.window) else p.window,
                                       moe=p.moe or all_moe) for p in cfg.period)
    cfg = dataclasses.replace(cfg, period=period)
    if quant:
        cfg = dataclasses.replace(cfg, quant=quant_mod.QuantConfig(**quant))
    return cfg


@dataclasses.dataclass
class Model:
    jcfg: object
    pcfg: object
    je: object            # the reference's resident engine (weights, embedding)
    params: dict          # the port's tree, converted from the reference's
    emb: object           # the port's embedding store
    max_seq: int

    @property
    def budget(self) -> int:
        """The head and a third of the stacks: the first stack of 3+ groups
        streams through a 2-slot ring."""
        head = RP._tree_nbytes(self.params["final_norm"]) + \
            RP._tree_nbytes(self.params["lm_head"])
        return head + sum(RP._tree_nbytes(s) for s in self.params["stacks"]) // 3


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    built = {}

    def get(name):
        if name not in built:
            arch, window, quant, max_seq = MODELS[name]
            jcfg = _variant(JR.get(arch), JQ, window, quant)
            pcfg = _variant(PR.get(arch), PQ, window, quant)
            je = _strict(lambda: JE.build_engine(
                jcfg, max_seq=max_seq, flash_dir=str(tmp_path_factory.mktemp("ref"))))
            emb = CV.embedding_from_reference(je.embedding.flash._maps[je.embedding.name],
                                              str(tmp_path_factory.mktemp("port")))
            built[name] = Model(jcfg, pcfg, je, CV.params_from_reference(je.params), emb,
                                max_seq)
        return built[name]
    return get


def _loop_kw(name, m):
    if name != "jamba":
        return dict(max_slots=4, prefill_chunk=16)
    pb = JP.kv_page_bytes(m.jcfg, JP.kv_page_size(m.max_seq))
    return dict(max_slots=2, prefill_chunk=8, prefill_token_budget=8,
                dram_budget_bytes=4 * pb, proactive_spill=False, preempt_patience=3)


def _run(name, loop, request, sampling):
    """jamba: the pressure trace; the others ``test_torch_wstream``'s six
    requests of 3-23 tokens."""
    if name == "jamba":
        sp = sampling(temperature=0.0, max_new_tokens=8)
        return _pressure(loop, lambda u, p, n: request(uid=u, prompt_tokens=p,
                                                       max_new_tokens=n, sampling=sp))
    return loop.run(_dense_trace(loop.cfg, 6, request=request, sampling=sampling))


STREAM_COUNTERS = ("weight_group_hits", "weight_group_misses", "dram_weight_bytes",
                   "decode_tokens", "prefill_chunks", "spilled_pages", "restored_pages")


@pytest.fixture(scope="module")
def streamed(models, tmp_path_factory):
    """name -> one trace through the JAX streamed loop, the port's streamed
    loop and the port's resident loop (whole-group streaming)."""
    runs = {}

    def get(name):
        if name in runs:
            return runs[name]
        m = models(name)
        kw = _loop_kw(name, m)
        js = _strict(lambda: JE.Engine(
            m.jcfg, m.je.params, m.je.embedding, max_seq=m.max_seq,
            flash_dir=str(tmp_path_factory.mktemp("ref_stream")),
            weight_dram_budget_bytes=m.budget, expert_streaming=False))
        lj = _strict(lambda: JE.EngineLoop(js, **kw))
        out_j = _run(name, lj, JRequest, JS.SamplingParams)
        ps = PE.Engine(m.pcfg, m.params, m.emb, max_seq=m.max_seq, device="cpu",
                       weight_dram_budget_bytes=m.budget, expert_streaming=False)
        lp = PE.EngineLoop(ps, **kw)
        out_p = _run(name, lp, PE.Request, PS.SamplingParams)
        # the streamed step runs the max_slots batch; the resident loop does
        # too (A16's float32 matmuls pick their kernel, and so their sum
        # order, by the number of rows)
        lr = PE.EngineLoop(PE.Engine(m.pcfg, m.params, m.emb, max_seq=m.max_seq,
                                     device="cpu"), bucketing=False, **kw)
        out_r = _run(name, lr, PE.Request, PS.SamplingParams)
        for loop in (lj, lp, lr):
            loop.close()
        runs[name] = {"m": m, "js": js, "lj": lj, "ps": ps, "lp": lp,
                      "out": (out_j, out_p, out_r)}
        return runs[name]
    yield get
    for run in runs.values():
        run["ps"].close()
        run["js"].weight_store.close()


@pytest.mark.parametrize("name", ["gemma3", "gemma3-w16", "rwkv6", "jamba", "qwen2-quantvar"])
def test_streamed_loop_matches_reference_and_resident(streamed, name):
    r = streamed(name)
    out_j, out_p, out_r = r["out"]
    js, ps, lj, lp = r["js"], r["ps"], r["lj"], r["lp"]
    want = [q.generated for q in out_j]
    assert [q.generated for q in out_p] == want == [q.generated for q in out_r]
    assert all(want) and all(q.done for q in out_p)
    assert [q.preemptions for q in out_p] == [q.preemptions for q in out_j]
    for f in STREAM_COUNTERS:
        assert getattr(ps.stats, f) == getattr(js.stats, f), f
    (sp,) = ps.weight_policy.streamed
    assert dataclasses.asdict(ps.weight_policy) == dataclasses.asdict(js.weight_policy)
    assert sp.stack == 0 and sp.ring_groups == 2 and not sp.experts
    assert _ring_installs(lp) == _ring_installs(lj) > sp.ring_groups
    assert ps.stats.weight_group_hits > 0
    assert lp.disabled_features == lj.disabled_features
    assert ps.params["stacks"][0] is None
    assert ps.weight_store.stack_nbytes(0) == js.weight_store.stack_nbytes(0)
    assert ps.dispatch.fallbacks == []
    if name == "jamba":      # a mid-prefill victim and a preempted decoding row
        assert [q.preemptions for q in out_p] == [1, 1, 0] and ps.stats.restored_pages > 0
    if name == "gemma3-w16":     # prompts past the window: the rings wrapped
        assert max(len(q.prompt_tokens) + len(q.generated) for q in out_p) > 16


def test_group_wise_blobs_and_ring_slots_bit_for_bit(streamed):
    """The group-wise A16 stack's ring slots hold the resident tree's layer
    slices byte for byte (int4 data, the [K / 128, N] scales and zeros),
    read from blobs of the reference store's sizes."""
    r = streamed("qwen2-quantvar")
    ps, lp, m = r["ps"], r["lp"], r["m"]
    ring = lp._wstreams[0]
    wq = m.params["stacks"][0][0]["attn"]["wq"]["w"]
    assert wq.scale.shape[-2] == m.pcfg.d_model // 128
    for s in range(ring.count):
        assert ps.weight_store.group_nbytes(0, s) == r["js"].weight_store.group_nbytes(0, s)
    for slot, g in enumerate(ring.slot_group):
        assert g >= 0
        got = [t for _p, t in RP.tree_leaves_with_path(ring.slots[slot])]
        want = [t[g] for _p, t in RP.tree_leaves_with_path(m.params["stacks"][0])]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(PKP._bytes_view(a), PKP._bytes_view(b))


def test_expert_granular_mixed_stack_refused_as_the_reference_fails(models, tmp_path):
    """jamba@tiny's stack 0 mixes dense and MoE FFNs.  The reference's
    policy streams it per expert (4 experts) and its export slices the dense
    FFN's leaves along their second axis per expert, which fails on the
    [count, 1, N] scales; the port computes the same policy and refuses
    before writing anything."""
    m = models("jamba")
    want = JP.weight_stream_policy(m.jcfg, m.je.params, m.budget)
    got = RP.weight_stream_policy(m.pcfg, m.params, m.budget)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.streamed[0].experts == m.pcfg.num_experts
    with pytest.raises(ValueError, match="empty"):
        JE.Engine(m.jcfg, m.je.params, m.je.embedding, max_seq=m.max_seq,
                  flash_dir=str(tmp_path / "ref"), weight_dram_budget_bytes=m.budget)
    files = sorted(os.listdir(m.emb.flash.root))
    with pytest.raises(NotImplementedError, match="queue 3 item 5"):
        PE.Engine(m.pcfg, m.params, m.emb, max_seq=m.max_seq, device="cpu",
                  weight_dram_budget_bytes=m.budget)
    assert sorted(os.listdir(m.emb.flash.root)) == files


@pytest.mark.parametrize("name", ["gemma3-w16", "jamba"])
def test_streamed_decode_step_leaves_inactive_rows(models, name):
    """One decode step over every slot with a row outside ``active``,
    through the split step (whole groups) and the resident step from the
    same state: every ring page and recurrent state equal bit for bit, the
    inactive row's ring and state and the spare state row untouched, the
    active rows' logits equal."""
    m = models(name)
    eng = PE.Engine(m.pcfg, m.params, m.emb, max_seq=m.max_seq, device="cpu",
                    weight_dram_budget_bytes=m.budget, expert_streaming=False)
    res = PE.Engine(m.pcfg, m.params, m.emb, max_seq=m.max_seq, device="cpu")
    try:
        loops = [PE.EngineLoop(e, max_slots=3) for e in (eng, res)]
        gen = torch.Generator().manual_seed(5)
        for loop in loops:
            for slot in (0, 2):
                assert loop.pool.alloc_row(slot, 20)
            table = loop.pool.table.copy()
            table[1] = loop.geom.trash_page
            loop.cache["table"].copy_(torch.from_numpy(table))
            loop.cache["pos"].copy_(torch.tensor([19, 0, 7, 0], dtype=torch.int32)[
                :loop.cache["pos"].shape[0]])
        entries = [[e for stack in lp.cache["stacks"] for e in stack] for lp in loops]
        for a, b in zip(*entries):
            for f in ([*a] if isinstance(a, dict) else PKP.KV_FIELDS):
                x = a[f] if isinstance(a, dict) else getattr(a, f)
                y = b[f] if isinstance(b, dict) else getattr(b, f)
                x.copy_((torch.randn(x.shape, generator=gen) * 0.5).to(x.dtype))
                y.copy_(x)
        before = [{f: (e[f] if isinstance(e, dict) else getattr(e, f)).clone()
                   for f in ([*e] if isinstance(e, dict) else PKP.KV_FIELDS)}
                  for e in entries[0]]
        emb = eng.embed(np.asarray([[5], [6], [7]]))
        idx, active = torch.arange(3), torch.tensor([True, False, True])
        loops[0]._host_active[:] = active.numpy()
        out = [PT.decode_step_bucketed(e.params, e.cfg, emb, lp.cache, idx, e.dispatch,
                                       active=active,
                                       run_stacks=lp._stream_stacks if e is eng else None)[0]
               for e, lp in zip((eng, res), loops)]
        assert torch.equal(out[0][[0, 2]], out[1][[0, 2]])
        changed = 0
        for a, b, was in zip(*entries, before):
            for f, old in was.items():
                x = a[f] if isinstance(a, dict) else getattr(a, f)
                y = b[f] if isinstance(b, dict) else getattr(b, f)
                assert torch.equal(PKP._bytes_view(x), PKP._bytes_view(y)), f
                changed += not torch.equal(PKP._bytes_view(x), PKP._bytes_view(old))
                if isinstance(a, dict):           # rows 1 and 3 (the spare) frozen
                    assert torch.equal(x[:, [1, 3]], old[:, [1, 3]]), f
                elif a.window:    # row 1's ring (its write went to the trash page)
                    keep = a.ring_pages(1)
                    assert torch.equal(PKP._bytes_view(x)[:, keep],
                                       PKP._bytes_view(old)[:, keep]), f
        assert changed
        for lp in loops:
            lp.close()
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# an expert group run again after a cold miss
# ---------------------------------------------------------------------------

def test_expert_rerun_restores_recurrent_state(tmp_path):
    (x, st), (x1, st1), reruns, fallbacks = expert_rerun_case("cpu", str(tmp_path))
    assert reruns >= 1 and fallbacks == []
    assert torch.equal(x, x1)
    assert all(torch.equal(a, b) for a, b in zip(st, st1))


# ---------------------------------------------------------------------------
# the variants through the KV Flash tier
# ---------------------------------------------------------------------------

FIELDS = ("k_q", "k_scale", "k_zero", "v")


def _variant_pools(window=0, batch=0, seed=0):
    """A reference pool and the port's with int4 keys and bf16 values, both
    holding the same random bytes (the port's spare ring aside)."""
    geom = dict(page_size=8, num_pages=6, pages_per_row=3, staging_pages=3)
    kw = dict(layers=2, window=window, batch=batch, key_bits=4, value_fp8=False)
    jp = JKP.init_paged_layer(JKP.PoolGeometry(**geom), 2, 16, **kw)
    pp = PKP.init_paged_layer(PKP.PoolGeometry(**geom), 2, 16, **kw)
    assert pp.k_q.shape[-1] == 8 and pp.v.dtype == torch.bfloat16
    rng = np.random.default_rng(seed)
    n = jp.num_pages
    vals = {}
    for f in FIELDS:
        t = getattr(pp, f)
        if f == "k_q":
            a = rng.integers(-128, 128, t.shape).astype(np.int8)
        elif f == "v":
            a = np.asarray(rng.normal(size=t.shape), jnp.bfloat16)
        else:
            a = rng.random(t.shape).astype(np.float32)
        t.copy_(CV.to_tensor(a))
        vals[f] = jnp.asarray(a[:, :n])
    return dataclasses.replace(jp, **vals), pp


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def test_variant_pages_read_write_and_spill_bit_for_bit(tmp_path):
    """``read_pages`` of int4-key and bf16-value pages equals the
    reference's page snapshot (``EngineLoop._row_groups``: the pool indexed
    at the pages) bit for bit, a windowed row's whole ring too; the arrays
    survive the page spill store as the reference's do (the same bytes)
    and ``write_pages`` puts them back into staging pages in place."""
    jp, pp = _variant_pools()
    phys = [4, 1, 2]
    got = PKP.read_pages(pp, phys)
    assert got["v"].dtype == np.int16 and got["k_q"].shape == (2, 3, 8, 2, 8)
    for f in FIELDS:
        want = np.asarray(getattr(jp, f)[:, np.asarray(phys)])
        assert np.array_equal(_bits(got[f]), _bits(want)), f
    spill = HS.PageSpillStore(HS.FlashStore(str(tmp_path / "port"),
                                              HS.FlashSpec(simulate=False)))
    jspill = JHS.PageSpillStore(JHS.FlashStore(str(tmp_path / "ref"),
                                               JHS.FlashSpec(simulate=False)))
    try:
        spill.put(7, "s0p0", got, pages=3)
        jspill.put(7, "s0p0", {f: np.asarray(getattr(jp, f)[:, np.asarray(phys)])
                               for f in FIELDS}, pages=3)
        back, jback = spill.fetch(7, "s0p0"), jspill.fetch(7, "s0p0")
        assert spill.pages_on_flash == jspill.pages_on_flash == 3
        for f in FIELDS:
            assert back[f].nbytes == jback[f].nbytes
            assert np.array_equal(_bits(back[f]), _bits(jback[f])), f
        staged = list(range(pp.k_q.shape[1] - 3, pp.k_q.shape[1]))
        ptrs = [getattr(pp, f).data_ptr() for f in FIELDS]
        PKP.write_pages(pp, staged, back)
        for f in FIELDS:
            x = PKP._bytes_view(getattr(pp, f))
            assert torch.equal(x[:, staged], x[:, phys]), f
        assert [getattr(pp, f).data_ptr() for f in FIELDS] == ptrs
    finally:
        spill.close()
        jspill.close()
    jr, pr = _variant_pools(window=12, batch=2, seed=1)
    ring = PKP.read_pages(pr, pr.ring_pages(1))
    for f in FIELDS:
        want = np.asarray(getattr(jr, f)[:, jr.ppw:2 * jr.ppw])
        assert np.array_equal(_bits(ring[f]), _bits(want)), f


def test_variant_rings_append_decode_and_window_chunk_match_reference():
    """A windowed ring pool of int4 keys and bf16 values: prompt chunks (one
    padded, one wrapping the ring) and decode appends with an inactive row
    byte for byte; kernel 2's plain version over the ring views and the
    windowed chunk (``paged_prefill_window_ref``) within one bf16 rounding."""
    W, B_, HKV, D = 12, 3, 2, 64
    geom = dict(page_size=8, num_pages=12, pages_per_row=8, staging_pages=2)
    kw = dict(batch=B_, window=W, key_bits=4, value_fp8=False)
    jp = JKP.init_paged_layer(JKP.PoolGeometry(**geom), HKV, D, **kw)
    pp = PKP.init_paged_layer(PKP.PoolGeometry(**geom), HKV, D, **kw)
    rng = np.random.default_rng(0)

    def kv(shape):
        k = jnp.asarray(rng.normal(size=shape).astype(np.float32), jnp.bfloat16)
        return k, jnp.asarray((rng.normal(size=shape) * 3).astype(np.float32), jnp.bfloat16)

    def equal():
        for f in FIELDS:
            assert np.array_equal(_bits(getattr(jp, f)),
                                  _bits(CV.to_numpy(getattr(pp, f)[:jp.num_pages]))), f
    for slot, pos0, C, vl in [(0, 0, 8, 8), (1, 0, 8, 8), (1, 8, 40, 40), (2, 0, 8, 5),
                              (0, 8, 8, 8), (0, 16, 8, 3)]:
        k, v = kv((1, C, HKV, D))
        jp = jax.jit(JKP.append_paged_prompt)(jp, k, v, jnp.asarray(pos0, jnp.int32),
                                              slot=jnp.asarray(slot), valid_len=vl)
        PKP.append_paged_prompt(pp, CV.to_tensor(k), CV.to_tensor(v), pos0, slot=slot,
                                valid_len=vl)
        equal()
    pos = np.asarray([19, 48, 5], np.int32)
    for active in ([True, True, True], [True, False, True]):
        k, v = kv((B_, 1, HKV, D))
        new = jax.jit(JKP.append_paged)(jp, k, v, jnp.asarray(pos), None)
        act = jnp.asarray(active)
        jp = jax.tree.map(lambda o, n: jnp.where(
            jnp.repeat(act, jp.ppw).reshape((-1,) + (1,) * (n.ndim - 1)), n, o), jp, new)
        PKP.append_paged(pp, CV.to_tensor(k), CV.to_tensor(v), torch.from_numpy(pos),
                         None, active=torch.tensor(active))
        equal()
        pos = pos + np.asarray(active, np.int32)
    q = jnp.asarray(rng.normal(size=(B_, 1, 2 * HKV, D)).astype(np.float32) / 8, jnp.bfloat16)
    tj, bj = JKP.ring_view(jp, jnp.asarray(pos), B_)
    ref = jax.jit(lambda a: JKP.paged_decode_attention_ref(
        a, jp, tj, bj, jnp.asarray(pos), JPOL), compiler_options=STRICT)(q)
    tp, bp = PKP.ring_view(pp, torch.from_numpy(pos), B_)
    got = PD.Dispatcher().paged_decode_attention(CV.to_tensor(q), pp, tp,
                                                 torch.from_numpy(pos), PPOL, base=bp)
    np.testing.assert_allclose(np.asarray(ref, np.float32), got.float().numpy(),
                               rtol=1e-2, atol=1e-2)
    qc = jnp.asarray(rng.normal(size=(1, 8, 2 * HKV, D)).astype(np.float32) / 8, jnp.bfloat16)
    ref = jax.jit(lambda a: JKP.paged_prefill_window_ref(
        a, jp, jnp.asarray(0), jnp.asarray(19), jnp.asarray(6), W, 8, JPOL),
        compiler_options=STRICT)(qc)
    got = PKP.paged_prefill_window_ref(CV.to_tensor(qc), pp, torch.tensor([0]),
                                       torch.tensor([19]), torch.tensor([6]), W, 8, PPOL)
    np.testing.assert_allclose(np.asarray(ref[:, :6], np.float32), got[:, :6].float().numpy(),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("how", ["waves", "patience"])
def test_variant_kv_flash_tier_matches_reference(models, loops, how):
    """int4 keys and bf16 values through the oversubscribed pool (the
    linears on the integer path): with sharing off on a 6-page pool, cold
    pages spill and are staged back in 2+ waves; on a 4-page pool with
    queue patience a decoding row is preempted to Flash and restored.
    Tokens, counters and the allocator's end state equal the JAX loop's,
    nothing is left on Flash."""
    m = models("qwen2-kvvar")
    je = m.je
    pe = PE.Engine(m.pcfg, m.params, m.emb, max_seq=m.max_seq, device="cpu")
    if how == "waves":
        lj, lp = loops(je, pe, 6, max_slots=4, prefix_sharing=False)
        prompts, new = _prompts(23, 4, 30), [20] * 4
    else:
        lj, lp = loops(je, pe, 4, max_slots=2, preempt_patience=2)
        prompts, new = _prompts(3, 3, 8), [30] * 3
    pool = lp.cache["stacks"][0][0]
    assert pool.key_bits == 4 and pool.k_q.shape[-1] == m.pcfg.resolved_head_dim // 2
    assert pool.v.dtype == torch.bfloat16
    _, ps = _spill_serve(je, pe, lj, lp, prompts, new)
    if how == "waves":
        assert max(lp.waves) >= 2 and ps.cold_spilled_pages > 0
    else:
        assert ps.preemptions >= 1 and ps.restored_pages > 0


def test_quantvar_kv_flash_tier_equals_all_dram(models):
    """Every variant at once (int4 keys, bf16 values, A16, groups of 128)
    through the oversubscribed pool: cold spill (sharing on), 2+ staging
    waves (sharing off) and a preemption with its restore (patience), each
    token-equal to an all-DRAM loop.  Every loop decodes the max_slots
    batch (``bucketing=False``): a wave's smaller bucket would change the
    float32 matmuls' row count, and with it their sum order."""
    m = models("qwen2-quantvar")
    pe = PE.Engine(m.pcfg, m.params, m.emb, max_seq=m.max_seq, device="cpu")
    pb = RP.kv_page_bytes(m.pcfg, RP.kv_page_size(m.max_seq))
    sp = PS.SamplingParams(temperature=0.0, max_new_tokens=20)
    prompts = _prompts(23, 5, 30)

    def serve(n, **kw):
        pe.stats = PE.EngineStats()
        loop = PE.EngineLoop(pe, max_slots=4, bucketing=False, **kw)
        waves = []
        plan = loop._plan_waves
        loop._plan_waves = lambda slots: waves.append(len(plan(slots))) or plan(slots)
        out = loop.run([PE.Request(uid=i, prompt_tokens=p, max_new_tokens=20, sampling=sp)
                        for i, p in enumerate(prompts[:n])])
        assert loop.pool.staged_count == 0 and loop.spill.pages_on_flash == 0
        assert loop.pool.staging_free == loop.geom.staging_pages
        loop.close()
        return [r.generated for r in out], pe.stats, waves
    want, _, _ = serve(5)
    got, s, _ = serve(4, dram_budget_bytes=6 * pb)
    assert got == want[:4] and s.cold_spilled_pages > 0
    got, s, waves = serve(4, dram_budget_bytes=6 * pb, prefix_sharing=False)
    assert got == want[:4] and max(waves) >= 2
    got, s, _ = serve(5, dram_budget_bytes=6 * pb, prefix_sharing=False, preempt_patience=2)
    assert got == want and s.preemptions >= 1 and s.restored_pages > 0
    assert K.counts()["float_matmul"] > 0 and pe.dispatch.fallbacks == []


# ---------------------------------------------------------------------------
# MoE under A16
# ---------------------------------------------------------------------------

def test_moe_a16_loop_tokens_equal_reference(models, monkeypatch):
    """moonshot-v1-16b-a3b@tiny-moe with A16 activations: every expert
    matmul takes the float path, by ``rows`` at prompt chunks (capacity
    dispatch) and by ``ids`` at 2-row decode steps (the selected experts);
    the greedy tokens equal the JAX loop's."""
    m = models("moonshot-a16")
    sj = JS.SamplingParams(temperature=0.0, max_new_tokens=6)
    sp = PS.SamplingParams(temperature=0.0, max_new_tokens=6)
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(1, 400, n)] for n in (21, 9, 14, 30)]
    lj = _strict(lambda: JE.EngineLoop(m.je, max_slots=2, prefill_chunk=16))
    out_j = lj.run([JRequest(uid=i, prompt_tokens=p, max_new_tokens=6, sampling=sj)
                    for i, p in enumerate(prompts)])
    pe = PE.Engine(m.pcfg, m.params, m.emb, max_seq=m.max_seq, device="cpu")
    seen = []
    grouped = PD.Dispatcher.grouped_matmul

    def spy(self, x, w, qcfg, out_dtype=torch.bfloat16, *, rows=None, ids=None):
        assert PD.float_path(qcfg, w)
        seen.append(("rows" if rows is not None else "") + ("ids" if ids is not None else ""))
        return grouped(self, x, w, qcfg, out_dtype, rows=rows, ids=ids)
    monkeypatch.setattr(PD.Dispatcher, "grouped_matmul", spy)
    K.reset_launch_counts()
    lp = PE.EngineLoop(pe, max_slots=2, prefill_chunk=16)
    out_p = lp.run([PE.Request(uid=i, prompt_tokens=p, max_new_tokens=6, sampling=sp)
                    for i, p in enumerate(prompts)])
    for loop in (lj, lp):
        loop.close()
    assert [r.generated for r in out_p] == [r.generated for r in out_j]
    assert all(len(r.generated) == 6 for r in out_p)
    assert {"rows", "ids"} <= set(seen)
    assert K.counts()["float_matmul"] > 0 and K.counts()["grouped_matmul"] == 0
    assert pe.dispatch.fallbacks == []
