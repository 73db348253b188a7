"""The port's MoE FFN and MoE serving against the reference, on the CPU.

``apply_moe`` on the reference's own expert tables (converted by
``repro_torch.convert``) through both dispatch branches — the
selected-expert path (B*T*K <= E) and the grouped capacity dispatch, with
and without drops, whole and chunked along T — and a short trace through
``EngineLoop`` on moonshot-v1-16b-a3b@tiny-moe whose greedy tokens must
equal the reference loop's.  Routers are random normal, so no two router
probabilities tie (``lax.top_k`` and the port's stable sort agree on ties
anyway: both pick the lower expert index).

The reference runs jitted with excess precision off, as in
``test_torch_engine``; the integer paths then agree bit for bit and the
float ones (router logits, combine) within float32 reduction order, so the
outputs are held to one bf16 rounding (1e-2) and to > 99% bitwise-equal
elements."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.runtime import dispatch as JD  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import sampling as JS  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.configs import registry as PR  # noqa: E402
from repro_torch.models import moe as PM  # noqa: E402
from repro_torch.runtime import dispatch as PD  # noqa: E402
from repro_torch.runtime import plan as PP  # noqa: E402
from repro_torch.serving import engine as PE  # noqa: E402
from repro_torch.serving import sampling as PS  # noqa: E402

STRICT = {"xla_allow_excess_precision": False}
REF = JD.Dispatcher(backend="reference")


def _moe(arch, seed=0):
    """(config, reference MoE params, the port's converted copy)."""
    cfg = JR.get(arch)
    b = JL.ParamBuilder("init", key=jax.random.PRNGKey(seed), quantized=True,
                        qcfg=cfg.quant, pack=True)
    jp = JM.moe_params(b, cfg)
    return cfg, jp, CV.params_from_reference(jp)


def _run_both(arch, B, T, full_capacity=True, seed=0):
    cfg, jp, pp = _moe(arch, seed)
    x = np.random.default_rng(seed).normal(size=(B, T, cfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    yj, auxj = jax.jit(lambda a, p: JM.apply_moe(a, p, cfg, dispatch=REF,
                                                  full_capacity=full_capacity),
                       compiler_options=STRICT)(xj, jp)
    yp, auxp = PM.apply_moe(torch.from_numpy(x).bfloat16(), pp, PR.get(arch),
                            dispatch=PD.Dispatcher(), full_capacity=full_capacity)
    a = np.asarray(jnp.asarray(yj, jnp.float32))
    b = yp.float().numpy()
    assert yp.dtype == torch.bfloat16 and b.shape == a.shape
    np.testing.assert_allclose(b, a, rtol=1e-2, atol=1e-2)
    assert np.mean(a == b) > 0.99
    np.testing.assert_allclose(auxp.numpy(), np.asarray(auxj), rtol=1e-5)
    return cfg


def _spy(monkeypatch, fn_name):
    calls = []
    fn = getattr(PM, fn_name)

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return fn(*a, **kw)
    monkeypatch.setattr(PM, fn_name, spy)
    return calls


@pytest.mark.parametrize("arch,B,T,branch", [
    # 4 decode rows at top-2 of 8 experts: 8 routed pairs <= 8 experts
    ("moonshot-v1-16b-a3b@tiny-moe", 4, 1, "_dispatch_moe_tiny"),
    # 4 decode rows at top-2 of 4 experts: 8 pairs > 4, G = 4 groups of one
    ("moonshot-v1-16b-a3b@reduced", 4, 1, "_dispatch_moe"),
    # one 24-token prompt chunk at full capacity (G = 1, C = Tg = 24)
    ("moonshot-v1-16b-a3b@reduced", 1, 24, "_dispatch_moe"),
])
def test_apply_moe_matches_reference(monkeypatch, arch, B, T, branch):
    calls = _spy(monkeypatch, branch)
    _run_both(arch, B, T)
    assert len(calls) == 1


def test_apply_moe_capacity_drops_match_reference(monkeypatch):
    """Training-style capacity (factor 1.25): pairs past an expert's
    capacity go to the extra pad row and contribute nothing."""
    cfg = JR.get("moonshot-v1-16b-a3b@reduced")
    C = min(int(max(1, round(24 * 2 / 4 * cfg.moe_capacity_factor))), 24)
    assert C < 24                      # some expert overflows for sure: 48 pairs, 4 * 15 slots
    _run_both("moonshot-v1-16b-a3b@reduced", 1, 24, full_capacity=False, seed=3)


def test_apply_moe_chunked_matches_reference(monkeypatch):
    """A prompt longer than MOE_CHUNK_TOKENS // B dispatches chunk by chunk
    (here 4 chunks of 8 with the chunk size cut on both sides)."""
    monkeypatch.setattr(JM, "MOE_CHUNK_TOKENS", 8)
    monkeypatch.setattr(PM, "MOE_CHUNK_TOKENS", 8)
    calls = _spy(monkeypatch, "_dispatch_moe")
    _run_both("moonshot-v1-16b-a3b@reduced", 1, 32)
    assert calls == [(1, 8, 256)] * 4


def test_selected_expert_path_gathers_slabs():
    """The decode path reads only the chosen experts' slabs: take_experts
    on the port's table equals the reference's, bit for bit."""
    _, jp, pp = _moe("moonshot-v1-16b-a3b@tiny-moe")
    ids = np.asarray([3, 0, 7, 3, 5, 1], np.int32)
    from repro.runtime import plan as JP
    a = JP.take_experts(jp["w_up"]["w"], jnp.asarray(ids))
    b = PP.take_experts(pp["w_up"]["w"], torch.from_numpy(ids))
    assert isinstance(b, PP.PackedExpertLinear) and b.experts == 6
    for f in ("data", "scale", "zero"):
        assert np.asarray(getattr(a, f)).tobytes() == CV.to_numpy(getattr(b, f)).tobytes()


def test_moe_engine_loop_greedy_tokens_equal_reference(tmp_path, monkeypatch):
    """moonshot-v1-16b-a3b@tiny-moe (6 MoE layers, 8 experts, top-2) through
    EngineLoop: 6 requests on 4 slots, two sharing a prompt prefix,
    staggered arrivals.  Decode runs every slot unbucketed (4 rows x top-2
    = 8 pairs: the selected-expert path), prompt chunks the full dispatch;
    the greedy tokens, prefix adoption and allocator state equal the
    reference loop's."""
    arch = "moonshot-v1-16b-a3b@tiny-moe"
    monkeypatch.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=STRICT))
    je = JE.build_engine(JR.get(arch), max_seq=64, flash_dir=str(tmp_path / "ref"))
    loop_j = JE.EngineLoop(je, max_slots=4, prefill_chunk=16, prefill_token_budget=32)
    monkeypatch.undo()
    emb = CV.embedding_from_reference(je.embedding.flash._maps[je.embedding.name],
                                      str(tmp_path / "port"))
    pe = PE.build_engine(PR.get(arch), max_seq=64, device="cpu",
                         params=CV.params_from_reference(je.params), embedding=emb)
    loop_p = PE.EngineLoop(pe, max_slots=4, prefill_chunk=16, prefill_token_budget=32)
    assert loop_p.buckets == loop_j.buckets == (4,)
    assert loop_p.disabled_features == loop_j.disabled_features
    assert "decode_bucketing" in pe.stats.disabled_features
    rng = np.random.default_rng(7)
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
    K.reset_launch_counts()
    out_p = loop_p.run([PE.Request(uid=i, prompt_tokens=p, max_new_tokens=6, sampling=sp)
                        for i, p in enumerate(prompts)], arrivals=arrivals)
    assert loop_p.pool.prefix_hits == loop_j.pool.prefix_hits > 0
    assert loop_p.pool.table.tolist() == loop_j.pool.table.tolist()
    for a, b in zip(out_j, out_p):
        assert a.generated == b.generated, a.uid
        assert len(b.generated) == 6
    assert pe.dispatch.fallbacks == []
    assert set(K.launch_counts().values()) == {0}     # CPU tensors: plain versions
