"""The paper's quantization variants in the port, held to the JAX package:
int4 keys (nibble pairs) and bf16 values in the attention kernels' plain
versions (kernels 2, 3 and 6), the reference's float path for group-wise
and A16 linears and experts, and qwen2-1.5b@reduced served end to end under
``QuantConfig(kv_key_bits=4, kv_value_fp8=False, act_bits=16,
group_size=128)``.

Tolerances: against the Pallas kernels run with ``interpret=True`` (bf16
values; the Pallas kernels refuse int4 keys), the JAX package's own
kernel-vs-reference tolerance, 2e-2, as in ``tests/test_torch_kernels.py``;
against the reference's own path (``decode_attention_ref``, the reference
dispatcher), which the plain versions repeat op for op, one bf16 rounding,
1e-2.  The float linears sum the same bf16 products in float32 in another
order than XLA: 1e-5 relative on float32 outputs."""
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
from repro.core import quantization as JQ  # noqa: E402
from repro.core.precision import DEFAULT_POLICY as JPOL  # noqa: E402
from repro.kernels import flash_prefill as JFP  # noqa: E402
from repro.kernels import quant_attention as JQA  # noqa: E402
from repro.runtime import dispatch as JD  # noqa: E402
from repro.runtime import plan as JP  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import sampling as JS  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.configs import registry as PR  # noqa: E402
from repro_torch.core import kv_cache as PKV  # noqa: E402
from repro_torch.core import quantization as PQ  # noqa: E402
from repro_torch.core.precision import DEFAULT_POLICY as PPOL  # noqa: E402
from repro_torch.kernels import flash_prefill as FP  # noqa: E402
from repro_torch.kernels import quant_attention as QA  # noqa: E402
from repro_torch.runtime import dispatch as PD  # noqa: E402
from repro_torch.serving import engine as PE  # noqa: E402
from repro_torch.serving import sampling as PS  # noqa: E402

REF = JD.Dispatcher(backend="reference")
STRICT = {"xla_allow_excess_precision": False}
PS_, PPR, HKV, D = 16, 4, 2, 64
# (key bits, bf16 values): every variant the kernels take besides the
# default int8 keys + fp8 values
VARIANTS = [(8, True), (4, False), (4, True)]
QUANTVAR = dict(kv_key_bits=4, kv_value_fp8=False, act_bits=16, group_size=128)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(_f32(a), _f32(b), rtol=rtol, atol=atol)


def _kv(shape, bits, bf16, seed):
    """Keys and values quantized by the reference's own functions: (JAX
    arrays, the port's tensors) of (k_q, k_scale, k_zero, v)."""
    rng = np.random.default_rng(seed)
    k = jnp.asarray(rng.normal(size=shape).astype(np.float32), jnp.bfloat16)
    v = jnp.asarray(rng.normal(size=shape).astype(np.float32), jnp.bfloat16)
    kq, ks, kz = JKV.quantize_keys(k, bits=bits)
    vv = JKV.cast_values(v, jnp.bfloat16 if bf16 else JQ.FP8_DTYPE)
    arrays = (kq, ks, kz, vv)
    return arrays, tuple(CV.to_tensor(a) for a in arrays)


def _table(lengths, trash, seed):
    rng = np.random.default_rng(seed)
    free = list(rng.permutation(trash))
    table = np.full((len(lengths), PPR), trash, np.int32)
    for b, L in enumerate(lengths):
        for c in range(-(-L // PS_)):
            table[b, c] = free.pop()
    return table


def _query(shape, seed):
    q = (np.random.default_rng(seed).normal(size=shape) / 8).astype(np.float32)
    return jnp.asarray(q, jnp.bfloat16), torch.from_numpy(q).bfloat16()


# ---------------------------------------------------------------------------
# kernels 2, 3 and 6: plain versions over int4 keys and bf16 values
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,bf16", VARIANTS)
@pytest.mark.parametrize("G", [1, 6])
def test_paged_decode_variants_vs_reference_and_pallas(bits, bf16, G):
    lengths = [37, 5, 64]
    B, H, trash = len(lengths), HKV * G, len(lengths) * PPR
    (kq, ks, kz, vv), ppool = _kv((trash + 3, PS_, HKV, D), bits, bf16, seed=G + bits)
    jpool = JKP.PagedLayerKV(k_q=kq, k_scale=ks, k_zero=kz, v=vv, key_bits=bits)
    assert ppool[0].shape[-1] == D * bits // 8
    assert ppool[3].dtype == (torch.bfloat16 if bf16 else PQ.FP8_DTYPE)
    table = _table(lengths, trash, seed=G)
    qj, qp = _query((B, 1, H, D), seed=G + 1)
    length = np.asarray(lengths, np.int32)
    ref = jax.jit(lambda a: REF.paged_decode_attention(
        a, jpool, jnp.asarray(table), None, jnp.asarray(length), JPOL))(qj)
    got = QA.paged_quant_decode_attention(qp[:, 0], *ppool, torch.from_numpy(table),
                                          torch.zeros((B,), dtype=torch.int32),
                                          torch.from_numpy(length), key_bits=bits)
    assert got.dtype == torch.float32 and got.shape == (B, H, D)
    _close(got.bfloat16(), ref[:, 0], rtol=1e-2, atol=1e-2)
    if bits == 8:          # the Pallas kernel reads int8 keys and values of any dtype
        pallas = JQA.paged_quant_decode_attention(
            jnp.asarray(qj[:, 0], jnp.float32), kq, ks, kz, vv, jnp.asarray(table),
            jnp.zeros((B,), jnp.int32), jnp.asarray(length), interpret=True)
        _close(got, pallas, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("bits,bf16", VARIANTS)
@pytest.mark.parametrize("C,pos0", [(16, 21), (8, 37)])
def test_paged_prefill_variants_vs_reference_and_pallas(bits, bf16, C, pos0):
    G = 3
    H, trash = HKV * G, 4 * PPR
    (kq, ks, kz, vv), ppool = _kv((trash + 3, PS_, HKV, D), bits, bf16, seed=C + bits)
    jpool = JKP.PagedLayerKV(k_q=kq, k_scale=ks, k_zero=kz, v=vv, key_bits=bits)
    table = _table([pos0 + C], trash, seed=C + G)
    qj, qp = _query((1, C, H, D), seed=pos0)
    ref = jax.jit(lambda a: REF.paged_prefill_attention(
        a, jpool, jnp.asarray(table), jnp.asarray(pos0, jnp.int32), JPOL))(qj)
    got = FP.paged_flash_prefill_attention(qp, *ppool, torch.from_numpy(table),
                                           torch.tensor([pos0], dtype=torch.int32),
                                           key_bits=bits)
    assert got.dtype == torch.float32 and got.shape == (1, C, H, D)
    _close(got.bfloat16(), ref, rtol=1e-2, atol=1e-2)
    if bits == 8:
        pallas = JFP.paged_flash_prefill_attention(
            qj, kq, ks, kz, vv, jnp.asarray(table), jnp.asarray([pos0], jnp.int32),
            interpret=True)
        _close(got, pallas, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("bits,bf16", VARIANTS)
@pytest.mark.parametrize("G,pos", [(1, [37, 5, 64]), (6, 23)])
def test_dense_decode_variants_vs_reference_and_pallas(bits, bf16, G, pos):
    B, S, H = 3, 64, HKV * G
    (kq, ks, kz, vv), parts = _kv((B, S, HKV, D), bits, bf16, seed=G + 7 * bits)
    jc = JKV.LayerKVCache(k_q=kq, k_scale=ks, k_zero=kz, v=vv,
                          length=jnp.zeros((), jnp.int32), key_bits=bits)
    pc = PKV.LayerKVCache(*parts, length=torch.zeros((), dtype=torch.int32), key_bits=bits)
    qj, qp = _query((B, 1, H, D), seed=G + 1)
    ref = jax.jit(lambda a, p: REF.decode_attention(a, jc, p, JPOL))(
        qj, jnp.asarray(pos, jnp.int32))
    out = PD.Dispatcher().decode_attention(qp, pc, torch.tensor(pos, dtype=torch.int32),
                                           PPOL)
    assert out.shape == (B, 1, H, D) and out.dtype == torch.bfloat16
    _close(out, ref, rtol=1e-2, atol=1e-2)
    got = QA.quant_decode_attention(qp[:, 0], *parts, torch.tensor(pos, dtype=torch.int32),
                                    key_bits=bits)
    assert torch.equal(got.bfloat16(), out[:, 0])
    if bits == 8:
        pallas = JQA.quant_decode_attention(
            jnp.asarray(qj[:, 0], jnp.float32), kq, ks, kz, vv, jnp.asarray(pos, jnp.int32),
            block_s=JD._decode_block(S), interpret=True)
        _close(got, pallas, rtol=2e-2, atol=2e-2)


def test_kernel_variant_checks():
    """What the kernels take is decided before the device: int8 keys of
    last dim D or int4 keys of D / 2, fp8 or bf16 values, and for every
    variant but int8 + fp8 a head dim of 64 or 128."""
    q = torch.zeros((2, 4, 64), dtype=torch.bfloat16)
    sz = torch.zeros((2, 8, 2))
    k8, k4 = torch.zeros((2, 8, 2, 64), dtype=torch.int8), torch.zeros((2, 8, 2, 32),
                                                                       dtype=torch.int8)
    fp8, bf = torch.zeros((2, 8, 2, 64)).to(PQ.FP8_DTYPE), torch.zeros((2, 8, 2, 64),
                                                                       dtype=torch.bfloat16)
    assert QA.kernel_variant(q, k8, sz, sz, fp8, 8) == (8, 0)
    assert QA.kernel_variant(q, k8, sz, sz, bf, 8) == (8, 1)
    assert QA.kernel_variant(q, k4, sz, sz, fp8, 4) == (4, 0)
    assert QA.kernel_variant(q, k4, sz, sz, bf, 4, head_dims=FP.HEAD_DIMS) == (4, 1)
    with pytest.raises(NotImplementedError):
        QA.kernel_variant(q, k8, sz, sz, fp8, 4)                    # int4 keys of D bytes
    with pytest.raises(NotImplementedError):
        QA.kernel_variant(q, k8, sz, sz, fp8.float(), 8)            # float32 values
    q80 = torch.zeros((2, 4, 80), dtype=torch.bfloat16)
    k80 = torch.zeros((2, 8, 2, 80), dtype=torch.int8)
    assert QA.kernel_variant(q80, k80, sz, sz, torch.zeros((2, 8, 2, 80)).to(PQ.FP8_DTYPE),
                             8) == (8, 0)
    with pytest.raises(NotImplementedError):                        # bf16 values at D = 80
        QA.kernel_variant(q80, k80, sz, sz, torch.zeros((2, 8, 2, 80), dtype=torch.bfloat16), 8)


# ---------------------------------------------------------------------------
# the float path: group-wise and A16 linears and experts
# ---------------------------------------------------------------------------

# (weight bits, activation bits, group size): W4A16 and W8A16 per channel
# and with groups, W4A8 with groups (the A8 integer path's kernel refuses
# groups; the reference takes its float path)
LINEAR_CASES = [(4, 16, 0), (8, 16, 0), (4, 16, 32), (8, 16, 32), (4, 8, 32)]


@pytest.mark.parametrize("bits,act,gs", LINEAR_CASES)
def test_float_linear_vs_quant_matmul(bits, act, gs):
    K_, N = 96 if gs == 0 else 128, 200
    rng = np.random.default_rng(bits + act + gs)
    w = (rng.normal(size=(K_, N)) * 0.02).astype(np.float32)
    x = rng.normal(size=(3, 5, K_)).astype(np.float32)
    jqt = JQ.quantize(jnp.asarray(w), bits, group_size=gs)
    pw = CV.params_from_reference(JP.pack_linear(jqt))
    jcfg = JQ.QuantConfig(weight_bits=bits, act_bits=act, group_size=gs)
    pcfg = PQ.QuantConfig(weight_bits=bits, act_bits=act, group_size=gs)
    assert PD.float_path(pcfg, pw)
    ref = JQ.quant_matmul(jnp.asarray(x, jnp.bfloat16), jqt, jcfg, out_dtype=jnp.float32)
    K.reset_launch_counts()
    got = PD.Dispatcher().linear(torch.from_numpy(x).bfloat16(), pw, pcfg,
                                 out_dtype=torch.float32)
    assert K.counts()["float_matmul"] == 1
    assert set(K.launch_counts().values()) == {0}
    assert got.shape == (3, 5, N) and got.dtype == torch.float32
    _close(got, ref, rtol=1e-5, atol=1e-5)
    # the plain backend takes the same path; bf16 output is one rounding of it
    plain = PD.Dispatcher(backend="reference").linear(torch.from_numpy(x).bfloat16(), pw,
                                                      pcfg)
    assert torch.equal(plain, got.bfloat16())


def _expert_table(E, K_, N, bits, gs, seed):
    w = (np.random.default_rng(seed).normal(size=(E, K_, N)) * 0.02).astype(np.float32)
    jw = JP.pack_expert_linear(JQ.quantize(jnp.asarray(w), bits, group_size=gs))
    return jw, CV.params_from_reference(jw)


@pytest.mark.parametrize("bits,act,gs", LINEAR_CASES)
def test_float_grouped_matmul_with_rows_and_ids_vs_reference(bits, act, gs):
    """The full-capacity branch (``rows``: dead capacity rows are zeros and
    come out +0.0) and the selected-expert branch (``ids`` name slabs of the
    whole table, with repeats), against the reference's per-expert
    ``quant_matmul`` (``_grouped_matmul_reference``) on the same slabs."""
    E, K_, N = 4, 128, 136
    jw, pw = _expert_table(E, K_, N, bits, gs, seed=bits + gs)
    jcfg = JQ.QuantConfig(weight_bits=bits, act_bits=act, group_size=gs)
    pcfg = PQ.QuantConfig(weight_bits=bits, act_bits=act, group_size=gs)
    rng = np.random.default_rng(act + gs)
    # rows: G = 2 capacity segments of C = 6 rows per expert
    counts = np.asarray([[6, 0], [2, 5], [0, 1], [3, 3]], np.int32)
    x = rng.normal(size=(2, E, 6, K_)).astype(np.float32)
    x *= (np.arange(6)[None, None] < counts.T[..., None])[..., None]
    ref = JD._grouped_matmul_reference(None, jnp.asarray(x, jnp.bfloat16), jw, jcfg,
                                       jnp.float32)
    K.reset_launch_counts()
    got = PD.Dispatcher().grouped_matmul(torch.from_numpy(x).bfloat16(), pw, pcfg,
                                         out_dtype=torch.float32,
                                         rows=torch.from_numpy(counts))
    assert K.counts()["float_matmul"] == 1 and set(K.launch_counts().values()) == {0}
    assert got.shape == (2, E, 6, N)
    _close(got, ref, rtol=1e-5, atol=1e-5)
    dead = got[torch.from_numpy(~(np.arange(6)[None, None] < counts.T[..., None]))]
    assert dead.numel() and torch.equal(dead, torch.zeros_like(dead))
    assert not torch.signbit(dead).any()
    # ids: 5 one-row slabs naming experts of the whole table
    ids = np.asarray([3, 0, 3, 1, 2], np.int32)
    xi = rng.normal(size=(1, 5, 1, K_)).astype(np.float32)
    ref = JD._grouped_matmul_reference(None, jnp.asarray(xi, jnp.bfloat16),
                                       JP.take_experts(jw, jnp.asarray(ids)), jcfg,
                                       jnp.float32)
    got = PD.Dispatcher().grouped_matmul(torch.from_numpy(xi).bfloat16(), pw, pcfg,
                                         out_dtype=torch.float32,
                                         ids=torch.from_numpy(ids))
    _close(got, ref, rtol=1e-5, atol=1e-5)


def test_integer_path_unchanged_for_per_channel_a8():
    """Per-channel W4A8 stays on the integer path (the kernel's plain
    version on the CPU): the float path's count does not move."""
    jw, pw = _expert_table(2, 128, 256, 4, 0, seed=0)
    del jw
    cfg = PQ.QuantConfig()
    assert not PD.float_path(cfg, pw)
    K.reset_launch_counts()
    PD.Dispatcher().grouped_matmul(torch.zeros((1, 2, 3, 128), dtype=torch.bfloat16), pw, cfg)
    assert K.counts()["float_matmul"] == 0


# ---------------------------------------------------------------------------
# qwen2-1.5b@reduced end to end under the variant config
# ---------------------------------------------------------------------------

ARCH = "qwen2-1.5b@reduced"


@pytest.fixture(scope="module")
def quantvar_engines(tmp_path_factory):
    """(reference engine with strict jits, the port's engine on its weights)
    for qwen2-1.5b@reduced under int4 keys, bf16 values, A16 and groups of
    128."""
    jcfg = dataclasses.replace(JR.get(ARCH), quant=JQ.QuantConfig(**QUANTVAR))
    pcfg = dataclasses.replace(PR.get(ARCH), quant=PQ.QuantConfig(**QUANTVAR))
    orig = jax.jit
    jax.jit = functools.partial(orig, compiler_options=STRICT)
    try:
        je = JE.build_engine(jcfg, max_seq=64, flash_dir=str(tmp_path_factory.mktemp("ref")))
    finally:
        jax.jit = orig
    emb = CV.embedding_from_reference(je.embedding.flash._maps[je.embedding.name],
                                      str(tmp_path_factory.mktemp("port")))
    pe = PE.build_engine(pcfg, max_seq=64, device="cpu",
                         params=CV.params_from_reference(je.params), embedding=emb)
    return je, pe


def test_quantvar_engine_layout(quantvar_engines):
    """The pools and caches follow the plan: int4 keys (D / 2 bytes), bf16
    values; every linear carries groups of 128."""
    _, pe = quantvar_engines
    loop = PE.EngineLoop(pe, max_slots=2)
    pool = loop.cache["stacks"][0][0]
    D_ = pe.cfg.resolved_head_dim
    assert pool.key_bits == 4 and pool.k_q.shape[-1] == D_ // 2
    assert pool.v.dtype == torch.bfloat16
    loop.close()
    wq = pe.params["stacks"][0][0]["attn"]["wq"]["w"]
    assert wq.scale.shape[-2] == pe.cfg.d_model // 128


def test_quantvar_loop_and_generate_greedy_tokens_equal_reference(quantvar_engines,
                                                                 monkeypatch):
    """A 6-request trace through ``EngineLoop`` (a shared prefix, staggered
    arrivals) and 3 requests through ``Engine.generate``: the JAX package's
    greedy tokens, every linear on the float path."""
    je, pe = quantvar_engines
    rng = np.random.default_rng(5)
    shared = [int(t) for t in rng.integers(1, 400, 19)]
    specs = [(shared + [int(t) for t in rng.integers(1, 400, 9)]) if i % 3 == 0 else
             [int(t) for t in rng.integers(1, 400, int(rng.integers(4, 36)))]
             for i in range(6)]
    arrivals = [0, 0, 1, 3, 6, 9]
    monkeypatch.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=STRICT))
    loop_j = JE.EngineLoop(je, max_slots=4, prefill_chunk=16, prefill_token_budget=32)
    monkeypatch.undo()
    loop_p = PE.EngineLoop(pe, max_slots=4, prefill_chunk=16, prefill_token_budget=32)
    sj = JS.SamplingParams(temperature=0.0, max_new_tokens=6)
    sp = PS.SamplingParams(temperature=0.0, max_new_tokens=6)
    out_j = loop_j.run([JRequest(uid=i, prompt_tokens=p, max_new_tokens=6, sampling=sj)
                        for i, p in enumerate(specs)], arrivals=arrivals)
    K.reset_launch_counts()
    out_p = loop_p.run([PE.Request(uid=i, prompt_tokens=p, max_new_tokens=6, sampling=sp)
                        for i, p in enumerate(specs)], arrivals=arrivals)
    assert K.counts()["float_matmul"] > 0
    loop_p.close()
    assert loop_p.pool.prefix_hits == loop_j.pool.prefix_hits > 0
    for a, b in zip(out_j, out_p):
        assert a.generated == b.generated, a.uid
        assert len(b.generated) == 6
    prompts = [[int(t) for t in rng.integers(1, 400, 12)] for _ in range(3)]
    gj = je.generate([JRequest(uid=i, prompt_tokens=p, max_new_tokens=6)
                      for i, p in enumerate(prompts)], sj)
    gp = pe.generate([PE.Request(uid=i, prompt_tokens=p, max_new_tokens=6)
                      for i, p in enumerate(prompts)], sp)
    for a, b in zip(gj, gp):
        assert a.generated == b.generated, a.uid
        assert len(b.generated) == 6 and b.done
    assert pe.dispatch.fallbacks == []
