"""qwen1.5-110b and grok-1-314b through the port's ``EngineLoop`` against the
reference's on the CPU, at ``@tiny`` (6 layers, d_model 256, GQA 4/2):
qwen1.5-110b with its qkv bias, grok-1-314b with 4 experts at top-2 in
every layer.  grok-1's config says ``act="gelu"``, but every one of its
layers is an MoE layer, whose FFN runs swiglu in both packages, so its
parameter tree has ``w_gate``.

Each model is served on the reference's own weights (converted by
``repro_torch.convert``): six requests with staggered arrivals on 4 slots,
two sharing a prompt prefix, greedy tokens token for token.  The
reference's steps are compiled with XLA's excess precision off, as in
``test_torch_engine``."""
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
from test_torch_engine import STRICT  # noqa: E402


def test_full_configs():
    qwen, grok = PR.get("qwen1.5-110b"), PR.get("grok-1-314b")
    assert (qwen.num_layers, qwen.d_model, qwen.num_heads, qwen.num_kv_heads,
            qwen.d_ff, qwen.qkv_bias) == (80, 8192, 64, 8, 49152, True)
    assert (grok.num_layers, grok.d_model, grok.num_heads, grok.num_kv_heads,
            grok.d_ff, grok.num_experts, grok.experts_per_tok) == (
                64, 6144, 48, 8, 32768, 8, 2)
    assert grok.act == "gelu" and all(p.moe for p in grok.period)


@pytest.mark.parametrize("arch", ["qwen1.5-110b@tiny", "grok-1-314b@tiny"])
def test_engine_loop_greedy_tokens_equal_reference(arch, tmp_path, monkeypatch):
    monkeypatch.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=STRICT))
    je = JE.build_engine(JR.get(arch), max_seq=64, flash_dir=str(tmp_path / "ref"))
    loop_j = JE.EngineLoop(je, max_slots=4, prefill_chunk=16, prefill_token_budget=32)
    monkeypatch.undo()
    emb = CV.embedding_from_reference(je.embedding.flash._maps[je.embedding.name],
                                      str(tmp_path / "port"))
    pe = PE.build_engine(PR.get(arch), max_seq=64, device="cpu",
                         params=CV.params_from_reference(je.params), embedding=emb)
    assert pe.cfg.num_layers == 6
    if pe.cfg.num_experts:
        assert "w_gate" in pe.params["stacks"][0][0]["moe"]
    loop_p = PE.EngineLoop(pe, max_slots=4, prefill_chunk=16, prefill_token_budget=32)
    assert loop_p.buckets == loop_j.buckets
    assert loop_p.disabled_features == loop_j.disabled_features
    rng = np.random.default_rng(11)
    shared = [int(t) for t in rng.integers(1, 500, 20)]
    prompts = [shared + [5, 6, 7], [int(t) for t in rng.integers(1, 500, 9)],
               shared + [9, 1], [int(t) for t in rng.integers(1, 500, 30)],
               [int(t) for t in rng.integers(1, 500, 4)],
               [int(t) for t in rng.integers(1, 500, 17)]]
    arrivals = [0, 0, 1, 3, 4, 6]
    sj = JS.SamplingParams(temperature=0.0, max_new_tokens=6)
    sp = PS.SamplingParams(temperature=0.0, max_new_tokens=6)
    out_j = loop_j.run([JRequest(uid=i, prompt_tokens=p, max_new_tokens=6, sampling=sj)
                        for i, p in enumerate(prompts)], arrivals=arrivals)
    out_p = loop_p.run([PE.Request(uid=i, prompt_tokens=p, max_new_tokens=6, sampling=sp)
                        for i, p in enumerate(prompts)], arrivals=arrivals)
    loop_p.close()
    assert loop_p.pool.prefix_hits == loop_j.pool.prefix_hits > 0
    for a, b in zip(out_j, out_p):
        assert a.generated == b.generated, a.uid
        assert len(b.generated) == 6
    assert pe.dispatch.fallbacks == []
