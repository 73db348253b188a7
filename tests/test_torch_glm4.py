"""glm4-9b through the port against the reference on the CPU: a decoder
whose KV heads each serve 16 query heads (glm4-9b has 32 over 2), so that
both decode-attention paths run at G = 16.

The registry's ``@reduced`` and ``@tiny`` variants of glm4-9b keep 4 heads
over 2 KV heads (G = 2), so the test config is ``glm4-9b@reduced`` with 16
heads of 32 over one KV head, built the same way on both sides and served
on the reference's own weights (converted by ``repro_torch.convert``):

- every layer's output and the logits of one paged prompt chunk and one
  bucketed decode step, and of a whole-prompt prefill and one decode step
  on dense caches, within one bf16 rounding (the tolerances of
  ``test_torch_engine`` and ``test_torch_generate``, whose checks these
  are), and more than 99% of each layer's elements bit for bit, except in
  the paged decode step (below);
- the greedy tokens of a short ``EngineLoop`` trace and of
  ``Engine.generate`` (prompts of equal length: it decodes the batch at
  request 0's position), token for token.

The reference's steps are compiled with XLA's excess precision off, as in
``test_torch_engine``.  The CUDA kernels at G = 16, 24 and 32 are held
against the plain versions on the card (``tests/test_torch_cuda.py``)."""
import dataclasses
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
from repro_torch.serving import engine as PE  # noqa: E402
from repro_torch.serving import sampling as PS  # noqa: E402
from test_torch_engine import STRICT, _trace, chunk_and_decode_match_reference  # noqa: E402
from test_torch_generate import prefill_and_decode_step_match_reference  # noqa: E402

MAX_SEQ = 64
GROUP = dict(num_heads=16, num_kv_heads=1, head_dim=32)


def test_registry_serves_glm4_at_its_group_size():
    full = PR.get("glm4-9b")
    assert full.num_heads // full.num_kv_heads == 16
    assert (full.num_layers, full.d_model, full.d_ff, full.vocab_size) == (
        40, 4096, 13696, 151552)
    assert not full.qkv_bias
    # @reduced differs from qwen2-7b@reduced in its name, KV heads (2 of 4
    # heads, G = 2), bias and source only
    glm, qwen = (dataclasses.asdict(PR.get(a + "@reduced")) for a in ("glm4-9b", "qwen2-7b"))
    assert {k for k in glm if glm[k] != qwen[k]} == {"name", "num_kv_heads", "qkv_bias",
                                                     "source"}


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(reference engine with strict jits, the port's engine on its weights)
    at G = 16."""
    orig = jax.jit
    jax.jit = functools.partial(orig, compiler_options=STRICT)
    try:
        je = JE.build_engine(dataclasses.replace(JR.get("glm4-9b@reduced"), **GROUP),
                             max_seq=MAX_SEQ, flash_dir=str(tmp_path_factory.mktemp("ref")))
    finally:
        jax.jit = orig
    emb = CV.embedding_from_reference(je.embedding.flash._maps[je.embedding.name],
                                      str(tmp_path_factory.mktemp("port")))
    pe = PE.build_engine(dataclasses.replace(PR.get("glm4-9b@reduced"), **GROUP),
                         max_seq=MAX_SEQ, device="cpu",
                         params=CV.params_from_reference(je.params), embedding=emb)
    assert pe.cfg.num_heads // pe.cfg.num_kv_heads == 16
    return je, pe


def test_chunk_and_decode_per_layer_match_reference(engines):
    """The chunk is bit-equal at every layer, and the decode step at layer
    1.  At layer 2 the first operation to differ is the decode attention:
    0.3% of its outputs by one bf16 ulp, as the plain version and XLA sum
    the softmax and P.V in another order (ROADMAP queue 3 item 1).  The o
    projection re-quantizes its input to int8, which spreads those flips
    over the row, so the layer's output is 40% bit-equal; it is held to the
    tolerance, and its bitwise share is not asserted."""
    chunk_and_decode_match_reference(*engines, decode_bitwise=False)


def test_prefill_and_decode_step_per_layer_match_reference(engines):
    prefill_and_decode_step_match_reference(*engines)


def test_engine_loop_greedy_tokens_equal_reference(engines, monkeypatch):
    """Six requests (a shared system prompt on every third, staggered
    arrivals, slot reuse) through both ``EngineLoop``s."""
    je, pe = engines
    specs, arrivals = _trace(n=6)
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
    loop_p.close()
    assert loop_p.pool.prefix_hits == loop_j.pool.prefix_hits > 0
    for a, b in zip(out_j, out_p):
        assert a.generated == b.generated, a.uid
        assert len(b.generated) == min(a.max_new_tokens, 8)
    assert pe.dispatch.fallbacks == []


def test_generate_greedy_tokens_equal_reference(engines):
    """Three requests with 12-token prompts, 8 greedy tokens each, through
    the dense caches of ``Engine.generate``."""
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
