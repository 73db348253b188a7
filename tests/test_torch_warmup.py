"""The port's step graphs on the CPU: RoPE's cached frequency table, the
reference's ``EngineLoop.warmup`` report, and the loop on its static-input
steps (the path a CUDA graph replays on the card; on the CPU nothing is
captured and the steps run directly).

On qwen2-7b@reduced with ``max_seq=64`` and the reference's own weights
(``repro_torch.convert``): a warmed loop commits the JAX ``EngineLoop``'s
greedy tokens on ``test_torch_engine``'s 12-request trace, and a small
churny trace commits the same tokens with and without ``warmup()``, on
qwen2-7b and on moonshot-v1-16b-a3b@tiny-moe (unbucketed decode).  The
capture itself, its launch counts and its absence of host waits are held
on the card (``tests/test_torch_cuda.py``)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import sampling as JS  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.configs import registry as PR  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.serving import engine as PE  # noqa: E402
from repro_torch.serving import sampling as PS  # noqa: E402
from test_torch_engine import STRICT, _trace  # noqa: E402

ARCH = "qwen2-7b@reduced"
MOE_ARCH = "moonshot-v1-16b-a3b@tiny-moe"
REPORT_KEYS = {"warmup_s", "graphs", "decode_buckets", "chunk_sizes"}


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(reference engine, port engine on the reference's weights)."""
    je = JE.build_engine(JR.get(ARCH), max_seq=64,
                         flash_dir=str(tmp_path_factory.mktemp("flash_ref")))
    emb = CV.embedding_from_reference(je.embedding.flash._maps[je.embedding.name],
                                      str(tmp_path_factory.mktemp("flash_port")))
    pe = PE.build_engine(PR.get(ARCH), max_seq=64, device="cpu",
                         params=CV.params_from_reference(je.params), embedding=emb)
    return je, pe


@pytest.fixture(scope="module")
def moe_engine(tmp_path_factory):
    return PE.build_engine(PR.get(MOE_ARCH), max_seq=64, device="cpu",
                           flash_dir=str(tmp_path_factory.mktemp("flash_moe")))


def test_cached_rope_table_is_bit_equal_and_built_once():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 6, 3, 16)).astype(np.float32)).bfloat16()
    positions = torch.tensor([[0, 1, 7, 63, 1000, 32767], [5, 4, 3, 2, 1, 0]])
    theta = 1e6
    got = PL.apply_rope(x, positions, theta)
    # the formula with the table built anew from numpy
    freqs = torch.tensor(PL.rope_freqs(16, theta), dtype=torch.float32)
    ang = positions[..., None].float() * freqs
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    want = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)
    assert torch.equal(got, want)
    table = PL.rope_table(16, theta, torch.device("cpu"))
    n = len(PL._ROPE_TABLES)
    assert torch.equal(PL.apply_rope(x, positions, theta), want)
    assert len(PL._ROPE_TABLES) == n
    assert PL.rope_table(16, theta, torch.device("cpu")) is table


@pytest.mark.parametrize("slots,chunk", [(4, 16), (3, 64), (1, 32)])
def test_warmup_report_matches_reference_loop(engines, slots, chunk):
    """The reference's four keys; buckets and chunk sizes as the JAX loop
    has them (read without its warmup); nothing captured on the CPU; a
    second call changes nothing."""
    je, pe = engines
    loop_j = JE.EngineLoop(je, max_slots=slots, prefill_chunk=chunk)
    loop_p = PE.EngineLoop(pe, max_slots=slots, prefill_chunk=chunk)
    rep = loop_p.warmup()
    assert set(rep) == REPORT_KEYS
    assert rep["decode_buckets"] == [int(b) for b in loop_j.buckets]
    assert rep["chunk_sizes"] == [int(c) for c in loop_j._chunk_sizes()]
    assert rep["graphs"] == 0 and loop_p.warmed
    again = loop_p.warmup()
    assert {k: v for k, v in again.items() if k != "warmup_s"} == \
        {k: v for k, v in rep.items() if k != "warmup_s"}
    assert pe.stats.compile_events == 0
    # the warm runs touched no state: every row idle at position 0
    assert loop_p.cache["pos"].tolist() == [0] * slots
    assert (loop_p.cache["table"] == loop_p.geom.trash_page).all()
    loop_p.close()
    assert not loop_p.warmed


def test_moe_warmup_report_is_one_unbucketed_step(moe_engine):
    loop = PE.EngineLoop(moe_engine, max_slots=4, prefill_chunk=16)
    rep = loop.warmup()
    assert rep["decode_buckets"] == [4] and rep["chunk_sizes"] == [8, 16]
    assert loop.disabled_features.get("decode_bucketing")


def test_warmed_loop_greedy_tokens_equal_reference(engines, monkeypatch):
    """test_torch_engine's 12-request trace: shared prefixes, staggered
    arrivals, slot reuse, every bucket and both chunk sizes."""
    je, pe = engines
    specs, arrivals = _trace()
    monkeypatch.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=STRICT))
    loop_j = JE.EngineLoop(je, max_slots=4, prefill_chunk=16, prefill_token_budget=32)
    monkeypatch.undo()
    loop_p = PE.EngineLoop(pe, max_slots=4, prefill_chunk=16, prefill_token_budget=32)
    loop_p.warmup()
    sj = JS.SamplingParams(temperature=0.0, max_new_tokens=8)
    sp = PS.SamplingParams(temperature=0.0, max_new_tokens=8)
    out_j = loop_j.run([JRequest(uid=i, prompt_tokens=p, max_new_tokens=m, sampling=sj)
                        for i, (p, m) in enumerate(specs)], arrivals=arrivals)
    out_p = loop_p.run([PE.Request(uid=i, prompt_tokens=p, max_new_tokens=m, sampling=sp)
                        for i, (p, m) in enumerate(specs)], arrivals=arrivals)
    for a, b in zip(out_j, out_p):
        assert a.generated == b.generated, a.uid
    assert loop_p.pool.prefix_hits == loop_j.pool.prefix_hits > 0
    assert pe.stats.recompiles_after_warmup == 0
    assert pe.dispatch.fallbacks == []


def _churn(loop, vocab, seed=3):
    """Short prompts and budgets arriving every step or two, so rows finish
    and slots refill while others decode: every bucket is met."""
    rng = np.random.default_rng(seed)
    sp = PS.SamplingParams(temperature=0.0, max_new_tokens=6)
    reqs = [PE.Request(uid=i, sampling=sp, max_new_tokens=int(rng.integers(1, 7)),
                       prompt_tokens=[int(t) for t in rng.integers(1, vocab,
                                                                   int(rng.integers(3, 30)))])
            for i in range(8)]
    loop.run(reqs, arrivals=[0, 0, 1, 2, 2, 4, 5, 7])
    return [r.generated for r in reqs]


@pytest.mark.parametrize("which", ["dense", "moe"])
def test_churny_trace_same_tokens_with_and_without_warmup(engines, moe_engine, which):
    eng = engines[1] if which == "dense" else moe_engine
    cold = PE.EngineLoop(eng, max_slots=4, prefill_chunk=16, prefill_token_budget=24)
    want = _churn(cold, 400)
    warm = PE.EngineLoop(eng, max_slots=4, prefill_chunk=16, prefill_token_budget=24)
    warm.warmup()
    assert _churn(warm, 400) == want
    assert all(len(t) > 0 for t in want)
    assert warm._inputs.keys() == cold._inputs.keys()   # the trace met every shape
