"""gemma3-27b through the port against the reference on the CPU: sliding-
window attention (rings in the paged pool and in the dense cache) and the
gelu FFN.

The models are ``gemma3-27b@reduced`` (one local layer with window 16, one
global layer) and a 3-layer variant of it whose plan has a tail stack
(((local, global), 1), ((local,), 1)), each served on the reference's own
weights (converted by ``repro_torch.convert``) with ``max_seq`` 64: pages
of 16 tokens, so a ring holds ppw = 2 pages.

- the ring functions: ``pages_per_window``, ``ring_view`` (negative
  bases), ring ``append_paged`` (a row outside the step leaves its ring as
  the reference's rollback does) and ``append_paged_prompt`` (padded and
  ring-wrapping chunks), byte for byte, and ``paged_prefill_window_ref``
  within one bf16 rounding, more than 99% bit for bit;
- the dense ring's ``append`` at T < W, T = W and T > W, byte for byte,
  with its ``slot_positions`` and ``valid_mask``;
- ``apply_ffn`` with gelu, bit for bit;
- every layer's output and the logits of two paged prompt chunks and one
  decode step past the window (the tail variant), and of a whole-prompt
  prefill longer than the window and one decode step on dense caches
  (@reduced), within one bf16 rounding (the tolerances of
  ``test_torch_engine`` and ``test_torch_generate``);
- the greedy tokens of an ``EngineLoop`` trace whose prompts are longer
  than the window, staggered so that decode steps run beside rows still
  mid-prefill and slots are reused, and of ``Engine.generate`` at T > W,
  token for token, with ``disabled_features`` equal to the reference's.

The reference's steps are compiled with XLA's excess precision off, as in
``test_torch_engine``."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.core import kv_cache as JKV  # noqa: E402
from repro.core import kv_pool as JKP  # noqa: E402
from repro.core.precision import DEFAULT_POLICY as JPOL  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import sampling as JS  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.configs import registry as PR  # noqa: E402
from repro_torch.core import kv_cache as PKV  # noqa: E402
from repro_torch.core import kv_pool as PKP  # noqa: E402
from repro_torch.core.precision import DEFAULT_POLICY as PPOL  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.runtime import dispatch as PD  # noqa: E402
from repro_torch.serving import engine as PE  # noqa: E402
from repro_torch.serving import sampling as PS  # noqa: E402
from test_torch_engine import STRICT  # noqa: E402

MAX_SEQ = 64
ARCHS = {"reduced": {}, "tail": {"num_layers": 3}}
FIELDS = ("k_q", "k_scale", "k_zero", "v")


def _close(a, b, tol=1e-2):
    a = np.asarray(jnp.asarray(a, jnp.float32))
    b = b.float().numpy()
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
    return float(np.mean(a == b))


def _bytes(x) -> bytes:
    a = CV.to_numpy(x) if torch.is_tensor(x) else np.asarray(x)
    return a.reshape(-1).view(np.uint8).tobytes()


def test_registry_and_plans():
    full = PR.get("gemma3-27b")
    assert full.act == "gelu" and full.num_layers == 62
    assert [(len(p), n) for p, n in full.layer_plan()] == [(6, 10), (2, 1)]
    assert [p.window for p in full.period] == [1024] * 5 + [0]
    red = PR.get("gemma3-27b@reduced")
    assert [p.window for p in red.period] == [16, 0] and red.num_layers == 2
    tail = dataclasses.replace(red, **ARCHS["tail"])
    assert [([p.window for p in pats], n) for pats, n in tail.layer_plan()] == [
        ([16, 0], 1), ([16], 1)]


# ---------------------------------------------------------------------------
# ring functions
# ---------------------------------------------------------------------------

def test_pages_per_window_matches_reference():
    for window in (1, 15, 16, 17, 1024, 1000):
        for ps in (8, 16, 128):
            assert PKP.pages_per_window(window, ps) == JKP.pages_per_window(window, ps)


GEOM = dict(page_size=8, num_pages=12, pages_per_row=8, staging_pages=2)
HKV, D, W, B = 2, 64, 12, 3


def _ring_pools():
    jg, pg = JKP.PoolGeometry(**GEOM), PKP.PoolGeometry(**GEOM)
    jp = JKP.init_paged_layer(jg, HKV, D, batch=B, window=W)
    pp = PKP.init_paged_layer(pg, HKV, D, batch=B, window=W)
    assert jp.ppw == pp.ppw == 3
    # the port's ring pool has one spare ring past the rows' rings
    assert pp.num_pages == jp.num_pages + pp.ppw and pp.ring_trash == B * pp.ppw
    return jp, pp


def _ring_equal(jp, pp):
    n = jp.num_pages
    for f in FIELDS:
        assert _bytes(getattr(jp, f)) == _bytes(getattr(pp, f)[:n]), f


def _kv(rng, shape):
    k = jnp.asarray(rng.normal(size=shape).astype(np.float32), jnp.bfloat16)
    v = jnp.asarray((rng.normal(size=shape) * 300).astype(np.float32), jnp.bfloat16)
    return k, v


def _filled_rings(seed=0):
    """Both ring pools after prompt chunks (one padded, one wrapping the
    ring) and decode appends with an inactive row."""
    rng = np.random.default_rng(seed)
    jp, pp = _ring_pools()
    # (slot, pos0, C, valid_len): row 1's 3rd chunk wraps a 3-page ring
    # (40 > 24 positions); row 2's is padded past its 5 real tokens
    for slot, pos0, C, vl in [(0, 0, 8, 8), (0, 8, 8, 8), (1, 0, 8, 8), (1, 8, 40, 40),
                              (2, 0, 8, 5), (0, 16, 8, 3)]:
        k, v = _kv(rng, (1, C, HKV, D))
        jp = jax.jit(JKP.append_paged_prompt)(jp, k, v, jnp.asarray(pos0, jnp.int32),
                                              slot=jnp.asarray(slot), valid_len=vl)
        PKP.append_paged_prompt(pp, CV.to_tensor(k), CV.to_tensor(v), pos0, slot=slot,
                                valid_len=vl)
        _ring_equal(jp, pp)
    pos = np.asarray([19, 48, 5], np.int32)
    for step, active in enumerate([[True, True, True], [True, False, True],
                                   [False, True, True]]):
        k, v = _kv(rng, (B, 1, HKV, D))
        new = jax.jit(JKP.append_paged)(jp, k, v, jnp.asarray(pos), None)
        # the reference's engine rolls inactive rows' ring pages back
        act = jnp.asarray(active)
        jp = jax.tree.map(lambda o, n: jnp.where(
            jnp.repeat(act, jp.ppw).reshape((-1,) + (1,) * (n.ndim - 1)), n, o), jp, new)
        PKP.append_paged(pp, CV.to_tensor(k), CV.to_tensor(v), torch.from_numpy(pos),
                         None, active=torch.tensor(active))
        _ring_equal(jp, pp)
        pos = pos + np.asarray(active, np.int32)
    return jp, pp, pos


def test_ring_appends_match_reference_bytes():
    _filled_rings()


def test_ring_view_matches_reference():
    jp, pp = _ring_pools()
    for pos in ([0, 1, 8, 9], [17, 24, 25, 100], [23, 7, 16, 40]):
        p = np.asarray(pos, np.int32)
        tj, bj = JKP.ring_view(jp, jnp.asarray(p), len(pos))
        tp, bp = PKP.ring_view(pp, torch.from_numpy(p), len(pos))
        assert tp.dtype == bp.dtype == torch.int32
        assert np.array_equal(np.asarray(tj), tp.numpy())
        assert np.array_equal(np.asarray(bj), bp.numpy())
        assert (bp < 0).any() or min(pos) > 16
    tj, bj = JKP.ring_view(jp, jnp.asarray(9, jnp.int32), 2)
    tp, bp = PKP.ring_view(pp, torch.tensor(9), 2)
    assert np.array_equal(np.asarray(tj), tp.numpy()) and bp.tolist() == [-1, -1]


def test_ring_decode_and_window_chunk_attention_match_reference():
    """Decode over ring views (through the dispatcher, against the
    reference's paged decode) and the windowed chunk attention, on the
    filled rings."""
    jp, pp, pos = _filled_rings(1)
    rng = np.random.default_rng(2)
    H = HKV * 2
    q = jnp.asarray(rng.normal(size=(B, 1, H, D)).astype(np.float32) / 8, jnp.bfloat16)
    tj, bj = JKP.ring_view(jp, jnp.asarray(pos), B)
    ref = jax.jit(lambda a: JKP.paged_decode_attention_ref(
        a, jp, tj, bj, jnp.asarray(pos), JPOL), compiler_options=STRICT)(q)
    tp, bp = PKP.ring_view(pp, torch.from_numpy(pos), B)
    got = PD.Dispatcher().paged_decode_attention(CV.to_tensor(q), pp, tp,
                                                 torch.from_numpy(pos), PPOL, base=bp)
    assert _close(ref, got) > 0.99
    # a chunk of row 0 at positions [19, 27), 6 real tokens, after its append
    k, v = _kv(rng, (1, 8, HKV, D))
    jp2 = jax.jit(JKP.append_paged_prompt)(jp, k, v, jnp.asarray(19),
                                           slot=jnp.asarray(0), valid_len=6)
    PKP.append_paged_prompt(pp, CV.to_tensor(k), CV.to_tensor(v), 19, slot=0,
                            valid_len=6)
    _ring_equal(jp2, pp)
    qc = jnp.asarray(rng.normal(size=(1, 8, H, D)).astype(np.float32) / 8, jnp.bfloat16)
    ref = jax.jit(lambda a: JKP.paged_prefill_window_ref(
        a, jp2, jnp.asarray(0), jnp.asarray(19), jnp.asarray(6), W, 8, JPOL),
        compiler_options=STRICT)(qc)
    got = PKP.paged_prefill_window_ref(CV.to_tensor(qc), pp, torch.tensor([0]),
                                       torch.tensor([19]), torch.tensor([6]), W, 8, PPOL)
    assert _close(ref[:, :6], got[:, :6]) > 0.99


# ---------------------------------------------------------------------------
# the dense ring and the gelu FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos,t", [(0, 5), (0, 12), (0, 29), (7, 3), (9, 1),
                                   ([3, 11, 30], 1), ([0, 2, 5], 14)])
def test_dense_ring_append_matches_reference(pos, t):
    """A ring of W = 12 slots: T < W, T = W, T > W (the reference's scatter
    applies its duplicate slots in order on the CPU), a wrapping window and
    per-row positions."""
    per_row = isinstance(pos, list)
    rng = np.random.default_rng(t)
    jc = JKV.init_layer_cache(3, 32, HKV, D, window=W, per_row=per_row)
    pc = PKV.init_layer_cache(3, 32, HKV, D, window=W, per_row=per_row)
    assert pc.max_seq == jc.max_seq == W and pc.window == W
    k, v = _kv(rng, (3, t, HKV, D))
    pj = jnp.asarray(pos, jnp.int32)
    jc = jax.jit(JKV.append)(jc, k, v, pj)
    pc = PKV.append(pc, CV.to_tensor(k), CV.to_tensor(v), torch.tensor(pos, dtype=torch.int32))
    for f in (*FIELDS, "length"):
        assert _bytes(getattr(jc, f)) == _bytes(getattr(pc, f)), f
    for later in (pj + t, pj + t + 13):
        pt = torch.from_numpy(np.asarray(later))
        assert np.array_equal(np.asarray(JKV.slot_positions(jc, later)),
                              PKV.slot_positions(pc, pt).numpy())
        assert np.array_equal(np.asarray(JKV.valid_mask(jc, later)),
                              PKV.valid_mask(pc, pt).numpy())


def test_gelu_ffn_matches_reference_bitwise():
    cfg_j, cfg_p = JR.get("gemma3-27b@reduced"), PR.get("gemma3-27b@reduced")
    b = JL.ParamBuilder("init", key=jax.random.PRNGKey(4), quantized=True,
                        qcfg=cfg_j.quant, pack=True)
    pj = JL.ffn_params(b, cfg_j)
    assert set(pj) == {"w_up", "w_down"}
    pp = CV.params_from_reference(pj)
    x = jnp.asarray(np.random.default_rng(5).normal(size=(2, 9, cfg_j.d_model)),
                    jnp.bfloat16)
    ref = jax.jit(lambda a: JL.apply_ffn(a, pj, cfg_j), compiler_options=STRICT)(x)
    got = PL.apply_ffn(CV.to_tensor(x), pp, cfg_p, PD.Dispatcher())
    assert _bytes(ref) == _bytes(got)
    u = np.random.default_rng(6).normal(size=(4096,)).astype(np.float32) * 4
    for dt_j, dt_p in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        a = jax.jit(lambda z: jax.nn.gelu(z.astype(jnp.float32)).astype(z.dtype))(
            jnp.asarray(u, dt_j))
        assert _bytes(a) == _bytes(PL.gelu(torch.from_numpy(u).to(dt_p)))


def test_other_activations_still_raise():
    cfg = dataclasses.replace(PR.get("gemma3-27b@reduced"), act="relu")
    with pytest.raises(NotImplementedError, match="relu"):
        PL.apply_ffn(torch.zeros(1, 1, cfg.d_model), {}, cfg, PD.Dispatcher())


# ---------------------------------------------------------------------------
# the model: per-layer outputs, EngineLoop and Engine.generate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_pairs(tmp_path_factory):
    built = {}

    def get(name):
        if name not in built:
            over = ARCHS[name]
            orig = jax.jit
            jax.jit = functools.partial(orig, compiler_options=STRICT)
            try:
                je = JE.build_engine(dataclasses.replace(JR.get("gemma3-27b@reduced"), **over),
                                     max_seq=MAX_SEQ,
                                     flash_dir=str(tmp_path_factory.mktemp("ref")))
            finally:
                jax.jit = orig
            emb = CV.embedding_from_reference(je.embedding.flash._maps[je.embedding.name],
                                              str(tmp_path_factory.mktemp("port")))
            pe = PE.build_engine(dataclasses.replace(PR.get("gemma3-27b@reduced"), **over),
                                 max_seq=MAX_SEQ, device="cpu",
                                 params=CV.params_from_reference(je.params), embedding=emb)
            built[name] = (je, pe)
        return built[name]
    return get


def _reference_layers(je, mode):
    """The reference's layers one at a time, over every stack and pattern
    (its own ``_apply_pattern``), returning every layer's output and the
    caches after the step, compiled like the engine's steps."""
    cfg = je.cfg
    ctx = JT.StepCtx(cfg, dispatch=je.dispatch)

    def run(params, stacks, x, positions, pos, table, slot, valid_len):
        outs, new = [], []
        for si, (patterns, count) in enumerate(cfg.layer_plan()):
            stack = list(stacks[si])
            for li in range(count):
                for pi, pat in enumerate(patterns):
                    pl = jax.tree.map(lambda a: a[li], params["stacks"][si][pi])
                    cl = jax.tree.map(lambda a: a[li], stack[pi])
                    x, nc, _ = JT._apply_pattern(x, pl, cfg, pat, mode, positions, cl,
                                                 None, pos, table, ctx, slot=slot,
                                                 valid_len=valid_len)
                    stack[pi] = jax.tree.map(lambda big, small: big.at[li].set(small),
                                             stack[pi], nc)
                    outs.append(x)
            new.append(tuple(stack))
        return outs, JT._logits(x[:, -1:], params, cfg, ctx.dispatch)[:, 0], tuple(new)

    return jax.jit(run, static_argnames=("valid_len",), compiler_options=STRICT)


def _pools_equal(stacks_j, cache_p, trash=None):
    """Every page the reference holds, bar a full-attention pool's trash
    page ``trash`` (where several rows outside a decode step write at once,
    in an order neither side fixes); the port's spare ring is its own."""
    for sj, sp in zip(stacks_j, cache_p["stacks"]):
        for pj, pp in zip(sj, sp):
            n = pj.k_q.shape[1]
            keep = [i for i in range(n) if pj.window or i != trash]
            for f in FIELDS:
                a, b = np.asarray(getattr(pj, f))[:, keep], getattr(pp, f)[:, keep]
                assert _bytes(a) == _bytes(b), f


@pytest.mark.parametrize("arch", ["tail"])
def test_chunks_and_decode_past_window_per_layer_match_reference(engine_pairs, arch):
    """On the tail variant (its first stack holds @reduced's two layers, a
    local and a global one, and its tail stack one more local layer): row 1
    of a 4-slot pool: chunks at [0, 16) and [16, 32) (the second
    padded past its 13 real tokens), then one decode step at position 29,
    past the 16-token window, with rows 0, 2 and 3 outside the step (their
    ring writes go to the trash page where the reference rolls them
    back).  The pools, rings included, stay byte-equal."""
    je, pe = engine_pairs(arch)
    loop_j, loop_p = JE.EngineLoop(je, max_slots=4), PE.EngineLoop(pe, max_slots=4)
    for loop in (loop_j, loop_p):
        assert loop.pool.alloc_row(1, 40)
    loop_p.close()
    table = loop_j.pool.table.copy()
    cp = loop_p.cache
    cp["table"] = torch.from_numpy(table.copy())
    stacks = loop_j.cache["stacks"]
    rng = np.random.default_rng(0)
    for pos0, valid in ((0, 16), (16, 13)):
        ids = rng.integers(1, 500, size=(1, 16))
        outs_j, logits_j, stacks = _reference_layers(je, "prefill_paged")(
            je.params, stacks, je.embed(ids), jnp.arange(pos0, pos0 + 16)[None],
            None, jnp.asarray(table)[1], jnp.asarray(1), valid_len=valid)
        collect = []
        logits_p = PT.prefill_chunk_paged(pe.params, pe.cfg, pe.embed(ids), cp, 1, pos0,
                                          valid - 1, pe.dispatch, collect=collect)
        assert len(collect) == pe.cfg.num_layers
        assert min(_close(a, b) for a, b in zip(outs_j, collect)) > 0.99
        if valid == 16:          # the reference returns the padded chunk's last row
            _close(logits_j, logits_p)
        _pools_equal(stacks, cp)
    pos = np.asarray([0, 29, 0, 0], np.int32)
    cp["pos"][:] = torch.from_numpy(pos)
    dec = table.copy()
    dec[[0, 2, 3]] = loop_p.geom.trash_page
    tok = rng.integers(1, 500, size=(4, 1))
    outs_j, logits_j, new = _reference_layers(je, "decode")(
        je.params, stacks, je.embed(tok), jnp.asarray(pos)[:, None], jnp.asarray(pos),
        jnp.asarray(dec), None, valid_len=None)
    active = np.asarray([False, True, False, False])
    stacks = JT.freeze_inactive_rows(je.cfg, stacks, new, jnp.asarray(active))
    cp["table"] = torch.from_numpy(dec)
    collect = []
    logits_p, cp = PT.decode_step_bucketed(pe.params, pe.cfg, pe.embed(tok), cp,
                                           torch.arange(4), pe.dispatch,
                                           active=torch.from_numpy(active), collect=collect)
    assert min(_close(a[1:2], b[1:2]) for a, b in zip(outs_j, collect)) > 0.99
    _close(logits_j[1:2], logits_p[1:2])
    _pools_equal(stacks, cp, trash=loop_p.geom.trash_page)
    assert cp["pos"].tolist() == [0, 30, 0, 0]


@pytest.mark.parametrize("arch", ["reduced"])
def test_prefill_past_window_and_decode_per_layer_match_reference(engine_pairs, arch):
    """A 24-token whole-prompt prefill of two rows (the 16-slot ring wraps)
    and one decode step, on dense caches: every layer within one bf16
    rounding and more than 99% bit for bit, the caches byte-equal."""
    je, pe = engine_pairs(arch)
    cfg = je.cfg
    Bn, T = 2, 24
    ids = np.random.default_rng(1).integers(1, 500, size=(Bn, T))
    cache_j = JT.init_cache(cfg, Bn, MAX_SEQ)
    positions = jnp.broadcast_to(jnp.arange(T)[None], (Bn, T))
    outs_j, logits_j, stacks = _reference_layers(je, "prefill")(
        je.params, cache_j["stacks"], je.embed(ids), positions, None, None, None,
        valid_len=None)
    collect = []
    logits_p, cache_p = PT.prefill(pe.params, pe.cfg, pe.embed(ids), MAX_SEQ,
                                   pe.dispatch, collect=collect)
    assert min(_close(a, b) for a, b in zip(outs_j, collect)) > 0.99
    _close(logits_j, logits_p)
    _pools_equal(stacks, cache_p)
    tok = np.argmax(np.asarray(logits_j)[:, :cfg.vocab_size], axis=-1)[:, None]
    pos = jnp.asarray(T, jnp.int32)
    outs_j, logits_j, stacks = _reference_layers(je, "decode")(
        je.params, stacks, je.embed(tok), jnp.broadcast_to(pos, (Bn, 1)), pos, None,
        None, valid_len=None)
    collect = []
    logits_p, cache_p = PT.decode_step(pe.params, pe.cfg, pe.embed(tok), cache_p,
                                       pe.dispatch, collect=collect)
    assert min(_close(a, b) for a, b in zip(outs_j, collect)) > 0.99
    _close(logits_j, logits_p)
    _pools_equal(stacks, cache_p)


def _trace(seed):
    """Six requests with 20-44-token prompts (past the 16-token window),
    arriving over 8 steps into 3 slots: a 16-token chunk budget keeps
    long prompts mid-prefill over several steps while other rows decode."""
    rng = np.random.default_rng(seed)
    specs = [([int(t) for t in rng.integers(1, 500, int(rng.integers(20, 45)))],
              int(rng.integers(4, 12))) for _ in range(6)]
    return specs, [0, 0, 1, 2, 5, 8]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_engine_loop_greedy_tokens_equal_reference(engine_pairs, arch, monkeypatch):
    je, pe = engine_pairs(arch)
    specs, arrivals = _trace(7)
    kw = dict(max_slots=3, prefill_chunk=16, prefill_token_budget=16)
    monkeypatch.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=STRICT))
    loop_j = JE.EngineLoop(je, **kw)
    monkeypatch.undo()
    loop_p = PE.EngineLoop(pe, **kw)
    assert loop_p.disabled_features == loop_j.disabled_features
    assert set(loop_p.disabled_features) == {"prefix_sharing", "decode_bucketing"}
    assert loop_p.prefill_chunk == loop_j.prefill_chunk == 16
    sj = JS.SamplingParams(temperature=0.0, max_new_tokens=12)
    sp = PS.SamplingParams(temperature=0.0, max_new_tokens=12)
    out_j = loop_j.run([JRequest(uid=i, prompt_tokens=p, max_new_tokens=m, sampling=sj)
                        for i, (p, m) in enumerate(specs)], arrivals=arrivals)
    mixed = []
    step = PE.EngineLoop._step_body

    def spy(self, key):          # a decode step beside a row mid-prefill
        if key[0] == "decode" and self._prefilling:
            mixed.append(key)
        return step(self, key)
    monkeypatch.setattr(PE.EngineLoop, "_step_body", spy)
    out_p = loop_p.run([PE.Request(uid=i, prompt_tokens=p, max_new_tokens=m, sampling=sp)
                        for i, (p, m) in enumerate(specs)], arrivals=arrivals)
    loop_p.close()
    assert mixed and pe.stats.prefill_chunks == je.stats.prefill_chunks
    for a, b in zip(out_j, out_p):
        assert a.generated == b.generated, a.uid
        assert len(b.generated) == a.max_new_tokens
    assert pe.dispatch.fallbacks == []


@pytest.mark.parametrize("arch", ["reduced"])
def test_generate_greedy_tokens_equal_reference(engine_pairs, arch):
    """Three 24-token prompts (the dense rings wrap during prefill), 8
    greedy tokens each."""
    je, pe = engine_pairs(arch)
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(1, 500, 24)] for _ in range(3)]
    out_j = je.generate([JRequest(uid=i, prompt_tokens=p, max_new_tokens=8)
                         for i, p in enumerate(prompts)],
                        JS.SamplingParams(temperature=0.0, max_new_tokens=8))
    out_p = pe.generate([PE.Request(uid=i, prompt_tokens=p, max_new_tokens=8)
                         for i, p in enumerate(prompts)],
                        PS.SamplingParams(temperature=0.0, max_new_tokens=8))
    for a, b in zip(out_j, out_p):
        assert a.generated == b.generated, a.uid
        assert len(b.generated) == 8 and b.done
    assert pe.dispatch.fallbacks == []


def test_weight_streaming_on_windowed_stacks(tmp_path):
    """gemma3-27b@tiny (three periods of six layers) under a one-byte weight
    budget streams its stack through a 2-slot ring: the loop builds, serves
    the staggered trace (decode steps beside rows mid-prefill, slots reused)
    with the resident engine's greedy tokens, and the blobs go at close."""
    cfg = PR.get("gemma3-27b@tiny")
    params = PT.init_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"),
                            quantized=True)
    res = PE.build_engine(cfg, max_seq=MAX_SEQ, device="cpu", params=params,
                          flash_dir=str(tmp_path))
    eng = PE.Engine(cfg, params, res.embedding, max_seq=MAX_SEQ, device="cpu",
                    weight_dram_budget_bytes=1)
    specs, arrivals = _trace(7)
    sp = PS.SamplingParams(temperature=0.0, max_new_tokens=12)
    kw = dict(max_slots=3, prefill_chunk=16, prefill_token_budget=16)
    try:
        assert eng.weight_policy.active and eng.params["stacks"][0] is None
        out = []
        for e in (eng, res):
            loop = PE.EngineLoop(e, **kw)
            out.append([r.generated for r in loop.run(
                [PE.Request(uid=i, prompt_tokens=p, max_new_tokens=m, sampling=sp)
                 for i, (p, m) in enumerate(specs)], arrivals=arrivals)])
            loop.close()
        assert out[0] == out[1] and all(out[0])
        assert eng.stats.weight_group_hits > 0 and eng.dispatch.fallbacks == []
    finally:
        eng.close()
    assert eng.weight_store.groups() == []
