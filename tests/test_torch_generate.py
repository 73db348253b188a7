"""The port's slot-synchronous path (dense caches, ``Engine.generate``)
against the reference on the CPU, with the reference's own weights
converted by ``repro_torch.convert``: every layer's output and the logits
of a whole-prompt ``prefill`` and of one ``decode_step``, on qwen2-7b@reduced
(dense FFN) and moonshot-v1-16b-a3b@reduced (MoE FFN), the dense cache
bytes the prefill wrote, and the greedy tokens of ``Engine.generate``.

``Engine.generate`` decodes the batch at request 0's position (the
reference takes one scalar ``pos`` from the first request's cache), so the
requests here have prompts of equal length.  The reference runs jitted
with excess precision off (see ``test_torch_engine``): layer outputs are
held to one bf16 rounding (1e-2) with > 99% of elements bitwise equal."""
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

STRICT = {"xla_allow_excess_precision": False}
MAX_SEQ = 64


@pytest.fixture(scope="module")
def engine_pairs(tmp_path_factory):
    """arch -> (reference engine with strict jits, the port's engine on its
    weights), built once for the module."""
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


def _reference_layers(je, mode):
    """The reference's layers one at a time on dense caches (its own
    ``_apply_pattern``), returning every layer's output, the logits and the
    stacked caches."""
    cfg = je.cfg
    ctx = JT.StepCtx(cfg, dispatch=je.dispatch)
    pat = cfg.period[0]

    def run(params, cache, x, positions, pos):
        outs, news = [], []
        for li in range(cfg.num_layers):
            pl = jax.tree.map(lambda a: a[li], params["stacks"][0][0])
            cl = jax.tree.map(lambda a: a[li], cache["stacks"][0][0])
            x, nc, _ = JT._apply_pattern(x, pl, cfg, pat, mode, positions, cl, None,
                                         pos, None, ctx)
            outs.append(x)
            news.append(nc)
        stack = jax.tree.map(lambda *xs: jnp.stack(xs), *news)
        return outs, JT._logits(x[:, -1:], params, cfg, ctx.dispatch)[:, 0], stack

    return jax.jit(run, compiler_options=STRICT)


def _close(a, b):
    a = np.asarray(jnp.asarray(a, jnp.float32))
    b = b.float().numpy()
    np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-2)
    return float(np.mean(a == b))


@pytest.mark.parametrize("arch", ["qwen2-7b@reduced", "moonshot-v1-16b-a3b@reduced"])
def test_prefill_and_decode_step_per_layer_match_reference(arch, engine_pairs):
    prefill_and_decode_step_match_reference(*engine_pairs(arch))


def prefill_and_decode_step_match_reference(je, pe):
    """Every layer's output, the logits and the dense cache bytes of a
    whole-prompt prefill of two 12-token rows, then every layer's output and
    the logits of one decode step, the port's engine ``pe`` against the
    reference's ``je``."""
    cfg = je.cfg
    B, T = 2, 12
    ids = np.random.default_rng(1).integers(1, 500, size=(B, T))
    cache_j = JT.init_cache(cfg, B, MAX_SEQ)
    positions = jnp.broadcast_to(jnp.arange(T)[None], (B, T))
    outs_j, logits_j, stack_j = _reference_layers(je, "prefill")(
        je.params, cache_j, je.embed(ids), positions, None)
    collect = []
    logits_p, cache_p = PT.prefill(pe.params, pe.cfg, pe.embed(ids), MAX_SEQ,
                                   pe.dispatch, collect=collect)
    assert len(collect) == cfg.num_layers
    assert min(_close(a, b) for a, b in zip(outs_j, collect)) > 0.99
    _close(logits_j, logits_p)
    stack_p = cache_p["stacks"][0][0]
    assert int(cache_p["pos"]) == T and stack_p.length.tolist() == [T] * cfg.num_layers
    for f in ("k_q", "k_scale", "k_zero", "v"):
        a, b = np.asarray(getattr(stack_j, f)), CV.to_numpy(getattr(stack_p, f))
        assert a.shape == b.shape
        assert np.mean(a.view(np.uint8) == b.view(np.uint8)) > 0.99, f
    # one decode step of both rows at the shared scalar position T
    tok = np.argmax(np.asarray(logits_j)[:, :cfg.vocab_size], axis=-1)[:, None]
    pos = jnp.asarray(T, jnp.int32)
    outs_j, logits_j, _ = _reference_layers(je, "decode")(
        je.params, {"stacks": ((stack_j,),), "pos": pos}, je.embed(tok),
        jnp.broadcast_to(pos, (B, 1)), pos)
    collect = []
    logits_p, cache_p = PT.decode_step(pe.params, pe.cfg, pe.embed(tok), cache_p,
                                       pe.dispatch, collect=collect)
    assert min(_close(a, b) for a, b in zip(outs_j, collect)) > 0.99
    _close(logits_j, logits_p)
    assert int(cache_p["pos"]) == T + 1


@pytest.mark.parametrize("arch", ["qwen2-7b@reduced", "moonshot-v1-16b-a3b@reduced"])
def test_generate_greedy_tokens_equal_reference(arch, engine_pairs):
    """Three requests with 12-token prompts, 8 greedy tokens each.  On the
    MoE model the 3-row decode routes 6 pairs over 4 experts: one group of
    three tokens through the capacity dispatch."""
    je, pe = engine_pairs(arch)
    je.stats, pe.stats = JE.EngineStats(), PE.EngineStats()
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(1, 500, 12)] for _ in range(3)]
    sj = JS.SamplingParams(temperature=0.0, max_new_tokens=8)
    sp = PS.SamplingParams(temperature=0.0, max_new_tokens=8)
    out_j = je.generate([JRequest(uid=i, prompt_tokens=p, max_new_tokens=8)
                         for i, p in enumerate(prompts)], sj)
    out_p = pe.generate([PE.Request(uid=i, prompt_tokens=p, max_new_tokens=8)
                         for i, p in enumerate(prompts)], sp)
    for a, b in zip(out_j, out_p):
        assert a.generated == b.generated, a.uid
        assert len(b.generated) == 8 and b.done
    s = pe.stats
    assert (s.prefill_tokens, s.decode_tokens) == (je.stats.prefill_tokens,
                                                   je.stats.decode_tokens) == (36, 21)
    assert s.prefill_s > 0 and s.decode_s > 0 and s.flash_bytes > 0
    assert pe.dispatch.fallbacks == []


def test_serve_no_continuous_on_cpu(tmp_path, capsys):
    out = PSV.main(["--arch", "moonshot-v1-16b-a3b@tiny-moe", "--no-continuous",
                    "--requests", "2", "--max-new", "3", "--max-prompt", "10",
                    "--max-seq", "64", "--device", "cpu", "--flash-dir", str(tmp_path)])
    assert [len(r.prompt_tokens) for r in out] == [10, 10]
    assert [len(r.generated) for r in out] == [3, 3]
    assert "slot-synchronous" in capsys.readouterr().out
