"""The port's multi-LoRA runtime (C7) against the reference, on the CPU:
``lora_apply`` in both orders, ``lora_apply_batched`` and ``table3_costs``
against ``repro.core.lora``; ``LoraRegistry``'s host state bit for bit
through loads, unloads, rank padding and slot reuse, with its device tables
keeping their storage; and on qwen2-7b@tiny with ``max_seq`` 64 and the
reference's own weights (``repro_torch.convert``), with two adapters of
rank 8 and 4 loaded on both engines:

  * an ``EngineLoop`` trace with base, adapter A and adapter B rows in one
    decode bucket, where the same prompt under two adapters adopts nothing
    and a later request under the same adapter adopts its prefix;
  * ``Engine.generate`` with an adapter row beside a base row;
  * a weight-streamed loop with an adapter row.

Greedy tokens and prefix hits must equal the JAX loop's.  The JAX steps
are compiled with excess precision off, as in ``test_torch_engine``."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.core import lora as JL  # noqa: E402
from repro.runtime import plan as JP  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import sampling as JS  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.configs import registry as PR  # noqa: E402
from repro_torch.core import lora as PL  # noqa: E402
from repro_torch.serving import engine as PE  # noqa: E402
from repro_torch.serving import sampling as PS  # noqa: E402

ARCH = "qwen2-7b@tiny"
STRICT = {"xla_allow_excess_precision": False}


def _strict(build):
    """Run ``build`` with every ``jax.jit`` it makes compiled strictly."""
    orig = jax.jit
    jax.jit = functools.partial(orig, compiler_options=STRICT)
    try:
        return build()
    finally:
        jax.jit = orig


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


def _assert_rel(got, want, rel=1e-6):
    """f32 relative tolerance against the output's scale (reduction order
    differs between XLA and PyTorch by an ulp or so a sum)."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * np.abs(want).max())


# ---------------------------------------------------------------------------
# the ops and the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("optimized", [True, False])
def test_lora_apply_matches_reference(optimized):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(32, 4)).astype(np.float32)
    b = rng.normal(size=(4, 16)).astype(np.float32)
    x = rng.normal(size=(5, 32)).astype(np.float32)
    want = JL.lora_apply(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                         optimized=optimized, scale=0.5)
    got = PL.lora_apply(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b),
                        optimized=optimized, scale=0.5)
    _assert_rel(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_apply_batched_matches_reference(dtype):
    """Per-row adapters gathered by id, slot 0 the zero adapter; a bf16
    activation (the serving case) promotes to float32 as in JAX."""
    rng = np.random.default_rng(1)
    K, din, r, dout = 4, 48, 8, 24
    a = rng.normal(size=(K, din, r)).astype(np.float32)
    b = rng.normal(size=(K, r, dout)).astype(np.float32)
    a[0], b[0] = 0.0, 0.0
    x = rng.normal(size=(3, 5, din)).astype(np.float32)
    ids = np.asarray([2, 0, 3], np.int32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    want = JL.lora_apply_batched(xj, jnp.asarray(a), jnp.asarray(b), jnp.asarray(ids))
    xp = torch.from_numpy(np.array(jnp.asarray(xj, jnp.float32))).to(getattr(torch, dtype))
    got = PL.lora_apply_batched(xp, torch.from_numpy(a), torch.from_numpy(b),
                                torch.from_numpy(ids))
    assert got.dtype == torch.float32
    _assert_rel(got, want)
    assert not got[1].any()


@pytest.mark.parametrize("h,r", [(3584, 8), (4096, 16), (256, 4)])
def test_table3_costs_equal_reference(h, r):
    assert PL.table3_costs(h, r) == JL.table3_costs(h, r)


def _registry_state(reg):
    return (reg._a.tobytes(), reg._b.tobytes(), dict(reg._names), list(reg._free))


def test_registry_host_state_bit_equal_and_device_tables_in_place():
    """Load (new name, reused name, rank padded), unload (slot zeroed and
    returned to the front of the free list), reload into the freed slot,
    exhaustion: the host tables, names and free list equal the reference's
    after every operation; the device tables are the same tensors
    throughout and hold the host tables."""
    rng = np.random.default_rng(2)
    ref = JL.LoraRegistry(in_dim=12, out_dim=10, max_rank=4, max_adapters=4)
    port = PL.LoraRegistry(in_dim=12, out_dim=10, max_rank=4, max_adapters=4,
                           device="cpu")
    tables = port.device_tables()

    def ab(r):
        return (rng.normal(size=(12, r)).astype(np.float32),
                rng.normal(size=(r, 10)).astype(np.float32))
    ops = [("load", "x", ab(2)), ("load", "y", ab(4)), ("load", "x", ab(3)),
           ("load", "z", ab(1)), ("unload", "y", None), ("load", "w", ab(4)),
           ("unload", "x", None), ("unload", "z", None), ("load", "v", ab(2))]
    for op, name, weights in ops:
        if op == "load":
            assert port.load(name, *weights) == ref.load(name, *weights)
        else:
            port.unload(name)
            ref.unload(name)
        assert _registry_state(port) == _registry_state(ref), (op, name)
        assert port.device_tables() is tables
        assert np.array_equal(tables[0].numpy(), port._a)
        assert np.array_equal(tables[1].numpy(), port._b)
    assert port.slot(None) == ref.slot(None) == 0
    assert port.slot("w") == ref.slot("w")
    assert port.resident_bytes == ref.resident_bytes
    last = ab(2)
    for reg in (ref, port):
        reg.load("u", *last)
        with pytest.raises(RuntimeError, match="exhausted"):
            reg.load("t", *last)
        with pytest.raises(KeyError):
            reg.slot("x")
    assert _registry_state(port) == _registry_state(ref)


# ---------------------------------------------------------------------------
# the serving paths with adapters
# ---------------------------------------------------------------------------

def _adapters(cfg, seed=0, scale=0.3):
    """Adapters "a" (rank 8) and "b" (rank 4): (q (A, B), v (A, B)) each."""
    rng = np.random.default_rng(seed)
    hd = cfg.resolved_head_dim

    def one(r):
        return tuple((rng.normal(size=(cfg.d_model, r)).astype(np.float32) * scale,
                      rng.normal(size=(r, heads * hd)).astype(np.float32) * scale)
                     for heads in (cfg.num_heads, cfg.num_kv_heads))
    return {"a": one(8), "b": one(4)}


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(reference engine with strict jits, the port's engine on its weights),
    both with adapters "a" and "b" loaded."""
    je = _strict(lambda: JE.build_engine(
        JR.get(ARCH), max_seq=64, flash_dir=str(tmp_path_factory.mktemp("ref"))))
    emb = CV.embedding_from_reference(je.embedding.flash._maps[je.embedding.name],
                                      str(tmp_path_factory.mktemp("port")))
    pe = PE.build_engine(PR.get(ARCH), max_seq=64, device="cpu",
                         params=CV.params_from_reference(je.params), embedding=emb)
    for name, (q, v) in _adapters(je.cfg).items():
        je.load_adapter(name, q, v)
        pe.load_adapter(name, q, v)
    return je, pe


def _prompts():
    rng = np.random.default_rng(1)
    return ([int(t) for t in rng.integers(1, 400, 20)],
            [int(t) for t in rng.integers(1, 400, 9)])


# (prompt, adapter, arrival): base and B decode together from the start, A
# joins on the base row's prompt (different salt: no adoption) and a later
# A request on the same prompt adopts A's prefix page
def _trace():
    p, q = _prompts()
    return [(p, None, 0), (q, "b", 0), (p, "a", 3), (p, "a", 9)]


def _run(loop, request, sampling, spec):
    sp = sampling(temperature=0.0, max_new_tokens=6)
    out = loop.run([request(uid=i, prompt_tokens=list(p), max_new_tokens=6, sampling=sp,
                            adapter=a) for i, (p, a, _t) in enumerate(spec)],
                   arrivals=[t for _p, _a, t in spec])
    return [r.generated for r in out]


def test_engine_loop_adapters_match_reference(engines):
    """Base, A and B rows in one decode bucket; the same prompt under two
    adapters adopts nothing, a later same-adapter request adopts: the
    port's loop commits the JAX loop's greedy tokens and prefix hits."""
    je, pe = engines
    lj = _strict(lambda: JE.EngineLoop(je, max_slots=4, prefill_chunk=16))
    lp = PE.EngineLoop(pe, max_slots=4, prefill_chunk=16)
    seen = []
    body = lp._step_body

    def spy(key):
        seen.append(key)
        body(key)
    lp._step_body = spy
    spec = _trace()
    want = _run(lj, JRequest, JS.SamplingParams, spec)
    got = _run(lp, PE.Request, PS.SamplingParams, spec)
    assert got == want
    assert lp.pool.prefix_hits == lj.pool.prefix_hits == 1
    assert pe.stats.shared_prompt_tokens == je.stats.shared_prompt_tokens > 0
    base, _b, styled, styled2 = got
    assert styled != base and styled2 == styled
    # every step carried the adapter ids (LoRA on), a 4-row bucket included
    assert seen and all(key[2] for key in seen)
    assert ("decode", 4, True) in seen
    assert pe.dispatch.fallbacks == []
    lj.close()
    lp.close()


def test_generate_with_adapter_matches_reference(engines):
    """``tests/test_serving.py::test_multi_lora_in_engine`` on the port: a
    base row and an adapter row of equal prompt length, greedy tokens equal
    to the JAX engine's; the base row equals a generate with no adapter."""
    je, pe = engines
    p, _q = _prompts()
    p = p[:12]
    spec = [(p, None), (p[::-1], "a")]
    out_j = je.generate([JRequest(uid=i, prompt_tokens=list(t), max_new_tokens=5,
                                  adapter=a) for i, (t, a) in enumerate(spec)],
                        JS.SamplingParams(temperature=0.0, max_new_tokens=5))
    out_p = pe.generate([PE.Request(uid=i, prompt_tokens=list(t), max_new_tokens=5,
                                    adapter=a) for i, (t, a) in enumerate(spec)],
                        PS.SamplingParams(temperature=0.0, max_new_tokens=5))
    assert [r.generated for r in out_p] == [r.generated for r in out_j]
    base = pe.generate([PE.Request(uid=9, prompt_tokens=list(p), max_new_tokens=5)],
                       PS.SamplingParams(temperature=0.0, max_new_tokens=5))
    assert base[0].generated == out_p[0].generated
    assert pe.dispatch.fallbacks == []


def test_weight_streamed_loop_with_adapter_matches_reference(engines, tmp_path):
    """Half the stack on Flash (the reference tests' head + 0.6 stacks
    budget), an adapter row beside a base row: the split step carries the
    ids to every streamed group; tokens equal the JAX streamed loop's."""
    je, _pe = engines
    params = CV.params_from_reference(je.params)
    head = sum(JP._tree_nbytes(je.params[k]) for k in ("final_norm", "lm_head"))
    budget = head + int(0.6 * sum(JP._tree_nbytes(s) for s in je.params["stacks"]))
    js = _strict(lambda: JE.build_engine(JR.get(ARCH), max_seq=64,
                                         weight_dram_budget_bytes=budget,
                                         flash_dir=str(tmp_path / "ref")))
    ps = PE.Engine(PR.get(ARCH), params, _pe.embedding, max_seq=64, device="cpu",
                   weight_dram_budget_bytes=budget)
    assert ps.weight_policy.active
    q, v = _adapters(je.cfg)["a"]
    js.load_adapter("a", q, v)
    ps.load_adapter("a", q, v)
    lj = _strict(lambda: JE.EngineLoop(js, max_slots=2, prefill_chunk=16))
    lp = PE.EngineLoop(ps, max_slots=2, prefill_chunk=16)
    p, q_ = _prompts()
    spec = [(q_, "a", 0), (p, None, 0)]
    assert _run(lp, PE.Request, PS.SamplingParams, spec) == \
        _run(lj, JRequest, JS.SamplingParams, spec)
    assert ps.stats.weight_group_misses == js.stats.weight_group_misses
    for loop in (lj, lp):
        loop.close()
    ps.close()
    js.weight_store.close()


class _Replay:
    """Stands in for a captured CUDA graph on the CPU: a replay runs the
    step on its static inputs, as the graph would."""

    def __init__(self, loop, key):
        self.loop, self.key = loop, key

    def replay(self):
        self.loop._step_body(self.key)

    def reset(self):
        pass


def test_graph_count_follows_the_reference_retraces(engines, monkeypatch):
    """The reference's steps retrace once per shape when the first adapter
    is loaded (``lora`` goes from None to tables) and never after.  With the
    capture replaced by a stand-in (the card test captures for real): a loop
    warmed with no adapter captures each shape with LoRA once more where the
    first adapter's trace meets it; a second load, and unloading every
    adapter, capture nothing; a loop warmed with adapters loaded captures
    nothing after warmup.  Base rows keep their tokens throughout."""
    _je, pe = engines
    monkeypatch.setattr(PE.EngineLoop, "_capture", lambda self, key: (
        self._graphs.__setitem__(key, _Replay(self, key)),
        self._graph_launches.__setitem__(key, {})))
    eng = PE.Engine(pe.cfg, pe.params, pe.embedding, max_seq=64, device="cpu")
    p, q = _prompts()

    def warmed():
        loop = PE.EngineLoop(eng, max_slots=4, prefill_chunk=16)
        loop.cuda_graphs = True
        rep = loop.warmup()
        assert rep["graphs"] == len(rep["decode_buckets"]) + len(rep["chunk_sizes"])
        return loop, rep["graphs"]

    def serve(loop, spec):
        return _run(loop, PE.Request, PS.SamplingParams, [(t, a, 0) for t, a in spec])
    loop, n0 = warmed()
    base = serve(loop, [(p, None), (q, None)])
    assert eng.stats.recompiles_after_warmup == 0
    adapters = _adapters(pe.cfg)
    eng.load_adapter("a", *adapters["a"])
    got = serve(loop, [(p, None), (q, "a")])
    lora_keys = [k for k in loop._graphs if k[2]]
    assert lora_keys and eng.stats.recompiles_after_warmup == len(lora_keys)
    assert got[0] == base[0] and got[1] != base[1]
    eng.load_adapter("b", *adapters["b"])
    assert serve(loop, [(q, "b"), (p, None)])[1] == base[0]
    assert eng.stats.recompiles_after_warmup == len(lora_keys)
    for name in ("a", "b"):
        eng.lora_q.unload(name)
        eng.lora_v.unload(name)
    assert serve(loop, [(p, None), (q, "a")]) == base        # names ignored again
    assert eng.stats.recompiles_after_warmup == len(lora_keys)
    assert loop.compile_events() == n0 + len(lora_keys)
    loop.close()
    eng.load_adapter("b", *adapters["b"])
    loop, n1 = warmed()
    assert n1 == n0 and all(k[2] for k in loop._graphs)
    serve(loop, [(p, "b"), (q, None)])
    assert eng.stats.recompiles_after_warmup == 0
    loop.close()
