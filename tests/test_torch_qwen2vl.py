"""M-RoPE (qwen2-vl-2b@reduced: 2 layers, d_model 256, 4 heads of 64 over
2 KV heads, qkv bias, rotary sections (8, 12, 12)) through the port against
the reference on the CPU, on the reference's own weights converted by
``repro_torch.convert``:

- ``apply_mrope`` on random three-axis ids against the reference's
  (within one bf16 rounding: ``cos``/``sin`` may differ by one float32 ulp
  between XLA and PyTorch, ROADMAP queue 3 item 1), and text ids (the
  same id on all three axes) giving the port's own ``apply_rope`` bit for
  bit, the axis index built once;
- every layer's output and the logits of a whole-prompt ``prefill`` and of
  one ``decode_step`` with three-axis positions (text, a 3 x 3 image block
  at a fixed t, text resuming past the block's largest id), within one
  bf16 rounding and more than 99% bit for bit;
- the greedy tokens of an ``EngineLoop`` trace (2 slots, 6 requests) and
  of ``Engine.generate``, which run on text positions.

The reference's steps are compiled with XLA's excess precision off, as in
``test_torch_engine``."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import sampling as JS  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.configs import registry as PR  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.serving import engine as PE  # noqa: E402
from repro_torch.serving import sampling as PS  # noqa: E402

ARCH = "qwen2-vl-2b@reduced"
STRICT = {"xla_allow_excess_precision": False}
MAX_SEQ = 64
FIELDS = ("k_q", "k_scale", "k_zero", "v")


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(reference engine with strict jits, the port's engine on its weights)."""
    orig = jax.jit
    jax.jit = functools.partial(orig, compiler_options=STRICT)
    try:
        je = JE.build_engine(JR.get(ARCH), max_seq=MAX_SEQ,
                             flash_dir=str(tmp_path_factory.mktemp("ref")))
    finally:
        jax.jit = orig
    emb = CV.embedding_from_reference(je.embedding.flash._maps[je.embedding.name],
                                      str(tmp_path_factory.mktemp("port")))
    pe = PE.build_engine(PR.get(ARCH), max_seq=MAX_SEQ, device="cpu",
                         params=CV.params_from_reference(je.params), embedding=emb)
    return je, pe


def _close(a, b, tol=1e-2):
    a = np.asarray(jnp.asarray(a, jnp.float32))
    b = b.float().numpy()
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
    return float(np.mean(a == b))


def test_config_sections():
    full, red = PR.get("qwen2-vl-2b"), PR.get(ARCH)
    assert (full.rope_kind, full.mrope_sections, full.head_dim) == ("mrope", (16, 24, 24), 128)
    assert red.mrope_sections == PR.get("qwen2-vl-2b@tiny").mrope_sections == (8, 12, 12)
    assert sum(red.mrope_sections) == red.resolved_head_dim // 2


def test_apply_mrope_matches_reference():
    """Random three-axis ids up to 4096 on [2, 10, 4, 64] bf16 rows."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(2, 10, 4, 64)), jnp.bfloat16)
    ids = rng.integers(0, 4096, size=(2, 10, 3)).astype(np.int32)
    sections, theta = (8, 12, 12), 1e6
    want = jax.jit(lambda x, p: JL.apply_mrope(x, p, theta, sections))(x, jnp.asarray(ids))
    got = PL.apply_mrope(CV.to_tensor(x), torch.from_numpy(ids), theta, sections)
    assert got.dtype == torch.bfloat16
    assert _close(want, got) > 0.99
    with pytest.raises(ValueError, match="sections"):
        PL.apply_mrope(CV.to_tensor(x), torch.from_numpy(ids), theta, (8, 12, 8))


def test_text_ids_give_apply_rope_bit_for_bit():
    """Two-axis ids on an M-RoPE model repeat on all three axes; the
    rotation then equals ``apply_rope`` bit for bit, and the axis index is
    built once per (sections, device)."""
    cfg = PR.get(ARCH)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 7, 4, 64)).astype(np.float32)).bfloat16()
    ids = torch.from_numpy(rng.integers(0, 30000, size=(2, 7)))
    want = PL.apply_rope(x, ids, cfg.rope_theta)
    assert torch.equal(PL.positional(x, cfg, ids), want)
    axes = PL.mrope_axes(cfg.mrope_sections, torch.device("cpu"))
    n = len(PL._MROPE_AXES)
    three = ids[..., None].expand(2, 7, 3)
    assert torch.equal(PL.apply_mrope(x, three, cfg.rope_theta, cfg.mrope_sections), want)
    assert len(PL._MROPE_AXES) == n
    assert PL.mrope_axes(cfg.mrope_sections, torch.device("cpu")) is axes
    assert axes.tolist() == [0] * 8 + [1] * 12 + [2] * 12


def _vision_positions(n_text: int, side: int, n_tail: int) -> np.ndarray:
    """Qwen2-VL's ids for text, a side x side image block and more text:
    text ids count up on all three axes; the block keeps t at the next id
    while h and w step over its rows and columns; the tail text resumes one
    past the block's largest id.  -> int32 [n_text + side**2 + n_tail, 3]."""
    text = np.repeat(np.arange(n_text)[:, None], 3, axis=1)
    hh, ww = np.divmod(np.arange(side * side), side)
    block = np.stack([np.full(side * side, n_text), n_text + hh, n_text + ww], axis=1)
    tail = np.repeat((n_text + side + np.arange(n_tail))[:, None], 3, axis=1)
    return np.concatenate([text, block, tail]).astype(np.int32)


def _reference_layers(je, mode):
    cfg = je.cfg
    ctx = JT.StepCtx(cfg, dispatch=je.dispatch)
    pat = cfg.period[0]

    def run(params, stack, x, positions, pos):
        outs, news = [], []
        for li in range(cfg.num_layers):
            at = lambda tree: jax.tree.map(lambda a: a[li], tree)  # noqa: E731
            x, nc, _ = JT._apply_pattern(x, at(params["stacks"][0][0]), cfg, pat, mode,
                                         positions, at(stack), None, pos, None, ctx)
            outs.append(x)
            news.append(nc)
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *news)
        return outs, JT._logits(x[:, -1:], params, cfg, ctx.dispatch)[:, 0], stacked

    return jax.jit(run, compiler_options=STRICT)


def test_prefill_and_decode_step_three_axis_positions_match_reference(engines):
    """Two rows of 4 text tokens, a 3 x 3 image block and 3 text tokens (16
    tokens, ids up to 9), then one decode step at id 10 on every axis,
    cache position 16."""
    je, pe = engines
    cfg = je.cfg
    B = 2
    pos3 = _vision_positions(4, 3, 3)
    T = len(pos3)
    assert pos3[-1].tolist() == [9, 9, 9] and pos3[4].tolist() == [4, 4, 4]
    positions = np.broadcast_to(pos3[None], (B, T, 3))
    ids = np.random.default_rng(2).integers(1, 500, size=(B, T))
    stack_j = JT.init_cache(cfg, B, MAX_SEQ)["stacks"][0][0]
    outs_j, logits_j, stack_j = _reference_layers(je, "prefill")(
        je.params, stack_j, je.embed(ids), jnp.asarray(positions), None)
    collect = []
    logits_p, cache_p = PT.prefill(pe.params, pe.cfg, pe.embed(ids), MAX_SEQ, pe.dispatch,
                                   positions=torch.from_numpy(positions.copy()),
                                   collect=collect)
    assert len(collect) == cfg.num_layers
    assert min(_close(a, b) for a, b in zip(outs_j, collect)) > 0.99
    _close(logits_j, logits_p)
    for f in FIELDS:
        a, b = np.asarray(getattr(stack_j, f)), CV.to_numpy(getattr(cache_p["stacks"][0][0], f))
        assert np.mean(a.view(np.uint8) == b.view(np.uint8)) > 0.99, f
    tok = np.argmax(np.asarray(logits_j)[:, :cfg.vocab_size], axis=-1)[:, None]
    dec = np.full((B, 1, 3), 10, np.int32)
    pos = jnp.asarray(T, jnp.int32)
    outs_j, logits_j, _ = _reference_layers(je, "decode")(
        je.params, stack_j, je.embed(tok), jnp.asarray(dec), pos)
    collect = []
    logits_p, cache_p = PT.decode_step(pe.params, pe.cfg, pe.embed(tok), cache_p, pe.dispatch,
                                       positions=torch.from_numpy(dec), collect=collect)
    assert min(_close(a, b) for a, b in zip(outs_j, collect)) > 0.99
    _close(logits_j, logits_p)
    assert int(cache_p["pos"]) == T + 1


def test_engine_loop_greedy_tokens_equal_reference(engines, monkeypatch):
    """Six requests of 5-40 tokens (two sharing a 19-token prefix) arriving
    over 6 steps into 2 slots, 16-token chunks under a 32-token budget."""
    je, pe = engines
    rng = np.random.default_rng(6)
    shared = [int(t) for t in rng.integers(1, 500, 19)]
    specs = []
    for i in range(6):
        n = int(rng.integers(5, 41))
        prompt = (shared + [int(t) for t in rng.integers(1, 500, 8)])[:n + 19] if i in (0, 3) \
            else [int(t) for t in rng.integers(1, 500, n)]
        specs.append((prompt, int(rng.integers(3, 8))))
    arrivals = [0, 0, 1, 2, 4, 6]
    kw = dict(max_slots=2, prefill_chunk=16, prefill_token_budget=32)
    monkeypatch.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=STRICT))
    loop_j = JE.EngineLoop(je, **kw)
    monkeypatch.undo()
    loop_p = PE.EngineLoop(pe, **kw)
    sj = JS.SamplingParams(temperature=0.0, max_new_tokens=8)
    sp = PS.SamplingParams(temperature=0.0, max_new_tokens=8)
    out_j = loop_j.run([JRequest(uid=i, prompt_tokens=p, max_new_tokens=m, sampling=sj)
                        for i, (p, m) in enumerate(specs)], arrivals=arrivals)
    out_p = loop_p.run([PE.Request(uid=i, prompt_tokens=p, max_new_tokens=m, sampling=sp)
                        for i, (p, m) in enumerate(specs)], arrivals=arrivals)
    loop_p.close()
    assert loop_p.pool.prefix_hits == loop_j.pool.prefix_hits > 0
    for a, b in zip(out_j, out_p):
        assert a.generated == b.generated, a.uid
        assert len(b.generated) == a.max_new_tokens
    assert pe.dispatch.fallbacks == []


def test_generate_greedy_tokens_equal_reference(engines):
    je, pe = engines
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(1, 500, 12)] for _ in range(3)]
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
