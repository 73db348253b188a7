"""The encoder-decoder (seamless-m4t-large-v2@reduced: 2 encoder and 2
decoder layers, d_model 256, 4 heads of 64, gelu FFN) through the port
against the reference on the CPU, on the reference's own weights converted
by ``repro_torch.convert``:

- the parameter tree (``encoder``, ``enc_norm``, each decoder layer's
  ``ln_cross`` and bias-free ``cross``) key for key and shape for shape;
- ``encode`` and every decoder layer's cross cache (integer carriers held
  as the dense-cache tests hold them);
- ``cross_attention`` at T = 1 and T = 12, and the dispatcher's folded
  ``decode_attention`` (T query tokens in the query-head axis) against T
  one-token calls, and a two-token self-attention decode step refused;
- every layer's output of a whole-prompt ``prefill`` with source
  embeddings and of one ``decode_step``, and the greedy tokens of
  ``Engine.generate``; ``EngineLoop`` and the continuous launcher refuse
  the model, as the reference does;
- ``prefill(valid_len=)`` on a padded prompt (qwen2-7b@reduced and
  rwkv6-7b@reduced): logits at the last real token, ``pos`` and the state.

Layer outputs are held to one bf16 rounding (1e-2) with more than 99% of
elements bitwise equal, the reference compiled with excess precision off,
as in ``test_torch_generate``."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import sampling as JS  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.configs import registry as PR  # noqa: E402
from repro_torch.core import kv_cache as PKV  # noqa: E402
from repro_torch.launch import serve as PSV  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.runtime import dispatch as PD  # noqa: E402
from repro_torch.serving import engine as PE  # noqa: E402
from repro_torch.serving import sampling as PS  # noqa: E402

ARCH = "seamless-m4t-large-v2@reduced"
STRICT = {"xla_allow_excess_precision": False}
MAX_SEQ = 64
S = 16                    # source frames a request
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


def _src(batch, seed=5):
    """Source frame embeddings, N(0, 0.02) from numpy, as the launchers draw them."""
    return np.asarray(np.random.default_rng(seed).normal(size=(batch, S, 256)) * 0.02,
                      np.float32)


def _close(a, b, tol=1e-2):
    a = np.asarray(jnp.asarray(a, jnp.float32))
    b = b.float().numpy()
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
    return float(np.mean(a == b))


def _bytes_share(a, b) -> float:
    a, b = np.asarray(a), CV.to_numpy(b)
    assert a.shape == b.shape
    return float(np.mean(a.view(np.uint8) == b.view(np.uint8)))


def _ctx(je):
    return JT.StepCtx(je.cfg, dispatch=je.dispatch)


def _reference_encode(je, src):
    cfg = je.cfg
    spos = jnp.broadcast_to(jnp.arange(S)[None], (src.shape[0], S))
    fn = jax.jit(lambda p, x: JT.encode(p, cfg, x, spos, _ctx(je)), compiler_options=STRICT)
    return fn(je.params, jnp.asarray(src, jnp.bfloat16))


def _reference_cross(je, enc_out):
    fn = jax.jit(lambda p, e: JT.build_cross_caches(p, je.cfg, e, dispatch=je.dispatch),
                 compiler_options=STRICT)
    return fn(je.params, enc_out)


def _port_cross(pe, enc_out):
    cache = PT.init_cache(pe.cfg, enc_out.shape[0], MAX_SEQ, cross_len=S)
    return PT.build_cross_caches(pe.params, pe.cfg, enc_out, cache["cross"], pe.dispatch)


def _tree_shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _tree_shapes(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (tuple, list)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _tree_shapes(v, f"{prefix}/{i}").items()}
    if torch.is_tensor(tree):
        return {prefix: (tuple(tree.shape), tree.dtype)}
    return {prefix: (tuple(tree.data.shape), tuple(tree.scale.shape), tree.bits)}


def test_parameter_tree_matches_reference(engines):
    """The port's own init_params builds the reference's tree: the same key
    paths, shapes and bit widths as the converted reference parameters."""
    je, pe = engines
    own = PT.init_params(pe.cfg, torch.Generator().manual_seed(0), torch.device("cpu"),
                         quantized=True)
    assert _tree_shapes(own) == _tree_shapes(pe.params)
    assert set(own) == {"encoder", "enc_norm", "stacks", "final_norm", "lm_head"}
    layer = own["stacks"][0][0]
    assert {"ln_cross", "cross"} <= set(layer) and "bq" not in layer["cross"]
    assert own["encoder"]["ln1"].shape == (pe.cfg.encoder_layers, pe.cfg.d_model)


def test_encode_and_cross_caches_match_reference(engines):
    """The encoder's output (after enc_norm) within one bf16 rounding, more
    than 99% bit for bit; every decoder layer's cross cache built from the
    same encoder output, its bytes more than 99% equal, length S."""
    je, pe = engines
    src = _src(2)
    enc_j = _reference_encode(je, src)
    collect = []
    enc_p = PT.encode(pe.params, pe.cfg, torch.from_numpy(src), pe.dispatch, collect=collect)
    assert len(collect) == pe.cfg.encoder_layers
    assert _close(enc_j, enc_p) > 0.99
    cross_j = _reference_cross(je, enc_j)[0][0]
    cross_p = _port_cross(pe, CV.to_tensor(enc_j))[0][0]
    for f in FIELDS:
        assert _bytes_share(getattr(cross_j, f), getattr(cross_p, f)) > 0.99, f
    assert cross_p.length.tolist() == [S] * pe.cfg.num_layers


@pytest.mark.parametrize("T", [1, 12])
def test_cross_attention_matches_reference(engines, T):
    """Layer 0's cross attention of T query tokens over the same cross
    cache: at T = 12 the reference falls back to ``decode_attention_ref``,
    the port folds the tokens into one call."""
    je, pe = engines
    enc_j = _reference_encode(je, _src(2))
    cross_j = jax.tree.map(lambda a: a[0], _reference_cross(je, enc_j)[0][0])
    cross_p = _port_cross(pe, CV.to_tensor(enc_j))[0][0].layer(0)
    x = jnp.asarray(np.random.default_rng(T).normal(size=(2, T, 256)), jnp.bfloat16)
    pj = jax.tree.map(lambda a: a[0], je.params["stacks"][0][0]["cross"])
    out_j = jax.jit(lambda x, p, c: JA.cross_attention(x, p, je.cfg, c, dispatch=je.dispatch),
                    compiler_options=STRICT)(x, pj, cross_j)
    pp = PT.layer_slice(pe.params["stacks"][0][0]["cross"], 0)
    out_p = PA.cross_attention(CV.to_tensor(x), pp, pe.cfg, cross_p, pe.dispatch)
    assert out_p.shape == (2, T, 256)
    assert _close(out_j, out_p) > 0.99


@pytest.mark.parametrize("backend", ["kernel", "reference"])
@pytest.mark.parametrize("hkv", [4, 2])
def test_folded_decode_attention_equals_one_token_calls(backend, hkv):
    """T = 12 query tokens a row (G = 1 and 2) over a dense cache with 13 of
    16 slots live: one folded call equals T one-token calls within 1e-6;
    windowed rings, the paged pool and a causal (self-attention) call still
    take one token a row."""
    rng = np.random.default_rng(hkv)
    B, T, H, D = 2, 12, 4, 64
    cache = PKV.init_layer_cache(B, 16, hkv, D)
    k = torch.from_numpy(rng.normal(size=(B, 16, hkv, D)).astype(np.float32)).bfloat16()
    v = torch.from_numpy(rng.normal(size=(B, 16, hkv, D)).astype(np.float32)).bfloat16()
    cache = PKV.append(cache, k, v, 0)
    qh = torch.from_numpy(rng.normal(size=(B, T, H, D)).astype(np.float32) / 8).bfloat16()
    disp = PD.Dispatcher(backend)
    pol = PA.DEFAULT_POLICY
    length = torch.tensor(13, dtype=torch.int32)
    folded = disp.decode_attention(qh, cache, length, pol, causal=False)
    single = torch.cat([disp.decode_attention(qh[:, t:t + 1], cache, length, pol)
                        for t in range(T)], dim=1)
    assert folded.shape == (B, T, H, D)
    torch.testing.assert_close(folded.float(), single.float(), rtol=1e-6, atol=1e-6)
    ring = PKV.init_layer_cache(B, 16, hkv, D, window=8)
    with pytest.raises(ValueError, match="causal=False"):
        disp.decode_attention(qh, cache, length, pol)
    with pytest.raises(ValueError, match="windowed"):
        disp.decode_attention(qh, ring, length, pol, causal=False)
    with pytest.raises(ValueError, match="one query token"):
        disp.paged_decode_attention(qh, None, None, length.reshape(1), pol)


def test_two_token_self_attention_decode_raises(engines):
    """A decode step of two tokens a row reaches the dense decode without
    the cross-attention flag and raises: self-attention would need a causal
    mask between the two tokens, which the folded call does not apply."""
    _, pe = engines
    ids = np.random.default_rng(2).integers(1, 500, size=(1, 6))
    _, cache = PT.prefill(pe.params, pe.cfg, pe.embed(ids), MAX_SEQ, pe.dispatch,
                          src_embeds=torch.from_numpy(_src(1)))
    with pytest.raises(ValueError, match="causal=False"):
        PT.decode_step(pe.params, pe.cfg, pe.embed(ids[:, :2]), cache, pe.dispatch)


def _reference_layers(je, mode):
    """The reference's decoder layers one at a time (its own
    ``_apply_pattern``, each with its cross cache), returning every layer's
    output, the logits and the stacked self-attention caches."""
    cfg = je.cfg
    pat = cfg.period[0]

    def run(params, stack, cross, x, positions, pos):
        outs, news = [], []
        for li in range(cfg.num_layers):
            at = lambda tree: jax.tree.map(lambda a: a[li], tree)  # noqa: E731
            x, nc, _ = JT._apply_pattern(x, at(params["stacks"][0][0]), cfg, pat, mode,
                                         positions, at(stack), at(cross), pos, None,
                                         _ctx(je))
            outs.append(x)
            news.append(nc)
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *news)
        return outs, JT._logits(x[:, -1:], params, cfg, je.dispatch)[:, 0], stacked

    return jax.jit(run, compiler_options=STRICT)


def test_prefill_and_decode_step_per_layer_match_reference(engines):
    """Two 12-token prompts with 16 source frames each: every decoder
    layer's output, the logits and the self-attention cache bytes of the
    prefill, then every layer's output and the logits of one decode step;
    the port's prefill encodes and builds its cross caches itself."""
    je, pe = engines
    cfg = je.cfg
    B, T = 2, 12
    src = _src(B, seed=9)
    ids = np.random.default_rng(1).integers(1, 500, size=(B, T))
    cross_j = _reference_cross(je, _reference_encode(je, src))[0][0]
    stack_j = JT.init_cache(cfg, B, MAX_SEQ)["stacks"][0][0]
    positions = jnp.broadcast_to(jnp.arange(T)[None], (B, T))
    outs_j, logits_j, stack_j = _reference_layers(je, "prefill")(
        je.params, stack_j, cross_j, je.embed(ids), positions, None)
    collect = []
    logits_p, cache_p = PT.prefill(pe.params, pe.cfg, pe.embed(ids), MAX_SEQ, pe.dispatch,
                                   collect=collect, src_embeds=torch.from_numpy(src))
    assert len(collect) == cfg.num_layers and set(cache_p) == {"stacks", "pos", "cross"}
    assert min(_close(a, b) for a, b in zip(outs_j, collect)) > 0.99
    _close(logits_j, logits_p)
    for f in FIELDS:
        assert _bytes_share(getattr(stack_j, f), getattr(cache_p["stacks"][0][0], f)) > 0.99
    tok = np.argmax(np.asarray(logits_j)[:, :cfg.vocab_size], axis=-1)[:, None]
    pos = jnp.asarray(T, jnp.int32)
    outs_j, logits_j, _ = _reference_layers(je, "decode")(
        je.params, stack_j, cross_j, je.embed(tok), jnp.broadcast_to(pos, (B, 1)), pos)
    collect = []
    logits_p, cache_p = PT.decode_step(pe.params, pe.cfg, pe.embed(tok), cache_p,
                                       pe.dispatch, collect=collect)
    assert min(_close(a, b) for a, b in zip(outs_j, collect)) > 0.99
    _close(logits_j, logits_p)
    assert int(cache_p["pos"]) == T + 1


def test_generate_greedy_tokens_equal_reference(engines):
    """Three 12-token prompts, each with its own 16 source frames, 8 greedy
    tokens each; the decode batch concatenates the cross caches too."""
    je, pe = engines
    je.stats, pe.stats = JE.EngineStats(), PE.EngineStats()
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(1, 500, 12)] for _ in range(3)]
    src = _src(3, seed=4)
    out_j = je.generate([JRequest(uid=i, prompt_tokens=p, max_new_tokens=8)
                         for i, p in enumerate(prompts)],
                        JS.SamplingParams(temperature=0.0, max_new_tokens=8), src_embeds=src)
    out_p = pe.generate([PE.Request(uid=i, prompt_tokens=p, max_new_tokens=8)
                         for i, p in enumerate(prompts)],
                        PS.SamplingParams(temperature=0.0, max_new_tokens=8), src_embeds=src)
    for a, b in zip(out_j, out_p):
        assert a.generated == b.generated, a.uid
        assert len(b.generated) == 8 and b.done
    assert (pe.stats.prefill_tokens, pe.stats.decode_tokens) == (36, 21)
    assert pe.dispatch.fallbacks == []
    with pytest.raises(ValueError, match="src_embeds"):
        pe.generate([PE.Request(uid=9, prompt_tokens=prompts[0], max_new_tokens=2)],
                    PS.SamplingParams(temperature=0.0, max_new_tokens=2))


def test_engine_loop_and_continuous_launcher_refuse_encoder_decoder(engines, tmp_path, capsys):
    je, pe = engines
    with pytest.raises(AssertionError):
        JE.EngineLoop(je, max_slots=2)
    with pytest.raises(ValueError, match="encoder-decoder"):
        PE.EngineLoop(pe, max_slots=2)
    flags = ["--arch", ARCH, "--device", "cpu", "--max-seq", "64",
             "--flash-dir", str(tmp_path)]
    for extra in ([], ["--http", "8099"]):
        with pytest.raises(SystemExit):
            PSV.main(flags + extra)
    assert "encoder-decoder" in capsys.readouterr().err
    out = PSV.main(flags + ["--no-continuous", "--requests", "2", "--max-new", "3",
                            "--max-prompt", "6"])
    assert [len(r.generated) for r in out] == [3, 3]


# ---------------------------------------------------------------------------
# prefill(valid_len=): a prompt padded to a bucket
# ---------------------------------------------------------------------------

def _state_leaves(cache):
    """(name, array) of every per-layer state: a dense cache's fields up to
    the prompt's real tokens, or a recurrent state's leaves."""
    out = []
    for si, stack in enumerate(cache["stacks"]):
        for pi, entry in enumerate(stack):
            if isinstance(entry, dict):
                out += [(f"{si}/{pi}/{k}", entry[k]) for k in sorted(entry)]
            else:
                out += [(f"{si}/{pi}/{f}", getattr(entry, f)[:, :, :VALID]) for f in FIELDS]
    return out


VALID, PADDED = 9, 16


@pytest.mark.parametrize("arch", ["qwen2-7b@reduced", "rwkv6-7b@reduced"])
def test_prefill_valid_len_matches_reference(arch):
    """A 9-token prompt padded to 16: the logits of token 9, ``pos`` 9, the
    KV bytes of the 9 real tokens (qwen2-7b; more than 99% equal) or the
    recurrent state (rwkv6-7b; within 1e-2), against the reference's
    ``prefill(valid_len=)`` on the same weights and embeddings."""
    jcfg = JR.get(arch)
    params = JT.init_params(jcfg, key=jax.random.PRNGKey(3), quantized=True, pack=True)
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.normal(size=(2, PADDED, jcfg.d_model)) * 0.5, jnp.bfloat16)
    ctx = JT.StepCtx(jcfg)
    logits_j, cache_j = jax.jit(
        lambda p, e, vl: JT.prefill(p, jcfg, e, MAX_SEQ, ctx=ctx, valid_len=vl),
        compiler_options=STRICT)(params, x, jnp.asarray(VALID, jnp.int32))
    pcfg = PR.get(arch)
    logits_p, cache_p = PT.prefill(CV.params_from_reference(params), pcfg, CV.to_tensor(x),
                                   MAX_SEQ, PD.Dispatcher(), valid_len=VALID)
    assert int(cache_j["pos"]) == int(cache_p["pos"]) == VALID and cache_p["pos"].dim() == 0
    _close(logits_j, logits_p)
    whole, _ = PT.prefill(CV.params_from_reference(params), pcfg, CV.to_tensor(x[:, :VALID]),
                          MAX_SEQ, PD.Dispatcher())
    assert torch.equal(whole, logits_p)          # the padded tail changes nothing
    for (name, a), (_, b) in zip(_state_leaves(cache_j), _state_leaves(cache_p)):
        if isinstance(cache_p["stacks"][0][0], dict):
            np.testing.assert_allclose(np.asarray(jnp.asarray(a, jnp.float32)),
                                       b.float().numpy(), rtol=1e-2, atol=1e-2, err_msg=name)
        else:
            assert _bytes_share(a, b) > 0.99, name
