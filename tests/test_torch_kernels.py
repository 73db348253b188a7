"""The seven kernels of the serving paths: each plain PyTorch version against
the reference's dispatch entry (``repro.runtime.dispatch``, backend
"reference") and against the Pallas kernel run with ``interpret=True``;
and the wrappers' checks.  The CUDA kernels themselves are held against
the plain versions on the card (``tests/test_torch_cuda.py``).

Tolerances: the plain versions repeat the reference entries op for op, so
the integer matmul matches them bit for bit and the float paths within a
bf16 rounding (1e-2); against the Pallas kernels, which keep keys and
probabilities in float32 and apply the matmul epilogue in another order,
the JAX package's own kernel-vs-reference tolerances hold (matmul 1e-4,
attention and RMSNorm 2e-2)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import kv_cache as JKV  # noqa: E402
from repro.core import kv_pool as JKP  # noqa: E402
from repro.core import quantization as JQ  # noqa: E402
from repro.core.precision import DEFAULT_POLICY as JPOL  # noqa: E402
from repro.kernels import flash_prefill as JFP  # noqa: E402
from repro.kernels import quant_attention as JQA  # noqa: E402
from repro.kernels import rmsnorm as JRN  # noqa: E402
from repro.runtime import dispatch as JD  # noqa: E402
from repro.runtime import plan as JP  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.core import quantization as PQ  # noqa: E402
from repro_torch.core.precision import DEFAULT_POLICY as PPOL  # noqa: E402
from repro_torch.core import kv_cache as PKV  # noqa: E402
from repro_torch.kernels import flash_prefill as FP  # noqa: E402
from repro_torch.kernels import grouped_matmul as GM  # noqa: E402
from repro_torch.kernels import quant_attention as QA  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from repro_torch.kernels import w4a8_matmul as WM  # noqa: E402
from repro_torch.runtime import dispatch as PD  # noqa: E402
from repro_torch.runtime import plan as PP  # noqa: E402

REF = JD.Dispatcher(backend="reference")


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(_f32(a), _f32(b), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# w4a8_matmul
# ---------------------------------------------------------------------------

def _linear(K, N, bits, seed):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(K, N)) * 0.02).astype(np.float32)
    jw = JP.pack_linear(JQ.quantize(jnp.asarray(w), bits))
    return jw, CV.params_from_reference(jw)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M", [1, 5, 16])
def test_w4a8_plain_vs_reference_and_pallas(bits, M):
    K, N = 200, 300                     # padded to Kp=256, Np=512 by the plan
    jw, pw = _linear(K, N, bits, seed=M)
    x = np.random.default_rng(10 + M).normal(size=(M, K)).astype(np.float32)
    xj, xp = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    qcfg_j, qcfg_p = JQ.QuantConfig(), PQ.QuantConfig()
    ref = jax.jit(lambda a: REF.linear(a, jw, qcfg_j, out_dtype=jnp.float32))(xj)
    got = PD.Dispatcher().linear(xp, pw, qcfg_p, out_dtype=torch.float32)
    assert _f32(ref).tobytes() == _f32(got).tobytes()          # bit for bit
    pallas = JD.Dispatcher(backend="interpret").linear(xj, jw, qcfg_j,
                                                       out_dtype=jnp.float32)
    _close(got, pallas, rtol=1e-4, atol=1e-4)
    # the wrapper on CPU tensors is the plain version (and counts nothing)
    xq, sx = PQ.quantize_activations(xp)
    before = WM.w4a8_matmul.launches
    y = WM.w4a8_matmul(xq, sx, pw.data, pw.scale[0], pw.zero[0], bits=bits)
    assert torch.equal(y, WM.w4a8_matmul_plain(xq, sx, pw.data, pw.scale[0],
                                               pw.zero[0], bits=bits))
    assert WM.w4a8_matmul.launches == before
    assert torch.equal(y[:, :N], got)


def test_w4a8_wrapper_checks():
    _, pw = _linear(128, 256, 4, seed=0)
    xq = torch.zeros((2, 128), dtype=torch.int8)
    sx = torch.ones((2, 1))
    args = (pw.data, pw.scale[0], pw.zero[0])
    with pytest.raises(ValueError):
        WM.w4a8_matmul(xq, torch.ones((3, 1)), *args, bits=4)
    with pytest.raises(TypeError):
        WM.w4a8_matmul(xq.float(), sx, *args, bits=4)
    with pytest.raises(ValueError):
        WM.w4a8_matmul(torch.zeros((2, 300), dtype=torch.int8), sx, *args, bits=4)
    with pytest.raises(ValueError):
        WM.w4a8_matmul(xq, sx, *args, bits=3)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,rows,D", [("bfloat16", 5, 256), ("float32", 3, 200),
                                          ("bfloat16", 1, 3584)])
def test_rmsnorm_plain_vs_reference_and_pallas(dtype, rows, D):
    rng = np.random.default_rng(rows)
    x = (rng.normal(size=(rows, D)) * 2).astype(np.float32)
    w = (1 + 0.1 * rng.normal(size=(D,))).astype(np.float32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xp = torch.from_numpy(x).to(getattr(torch, dtype))
    got = RN.rmsnorm(xp, torch.from_numpy(w), 1e-6)
    assert got.dtype == xp.dtype and got.shape == xp.shape
    ref = jax.jit(lambda a: REF.rmsnorm(a, jnp.asarray(w), 1e-6))(xj)
    tol = 1e-2 if dtype == "bfloat16" else 1e-5
    _close(got, ref, rtol=tol, atol=tol)
    _close(got, JRN.rmsnorm(xj, jnp.asarray(w), eps=1e-6, interpret=True),
           rtol=2e-2, atol=2e-2)


def test_rmsnorm_wrapper_checks():
    with pytest.raises(ValueError):
        RN.rmsnorm(torch.ones((2, 8)), torch.ones((7,)))
    with pytest.raises(TypeError):
        RN.rmsnorm(torch.ones((2, 8), dtype=torch.float16), torch.ones((8,)))


# ---------------------------------------------------------------------------
# paged attention: a pool built by the reference's own quantization
# ---------------------------------------------------------------------------

PS, PPR, HKV, D = 16, 4, 2, 64


def _pool(seed, n_pages):
    """Pool arrays (numpy) + the matching reference and port pools."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(n_pages, PS, HKV, D)).astype(np.float32)
    v = rng.normal(size=(n_pages, PS, HKV, D)).astype(np.float32)
    kq, ks, kz = JKV.quantize_keys(jnp.asarray(k, jnp.bfloat16))
    vv = JKV.cast_values(jnp.asarray(v, jnp.bfloat16), JQ.FP8_DTYPE)
    jpool = JKP.PagedLayerKV(k_q=kq, k_scale=ks, k_zero=kz, v=vv)
    ppool = tuple(CV.to_tensor(a) for a in (kq, ks, kz, vv))
    return jpool, ppool


def _table(lengths, trash, seed):
    rng = np.random.default_rng(seed)
    free = list(rng.permutation(trash))
    table = np.full((len(lengths), PPR), trash, np.int32)
    for b, L in enumerate(lengths):
        for c in range(-(-L // PS)):
            table[b, c] = free.pop()
    return table


@pytest.mark.parametrize("G", [1, 3, 16, 24])
@pytest.mark.parametrize("lengths", [[37, 5, 64], [16, 17, 1]])
def test_decode_attention_plain_vs_reference_and_pallas(G, lengths):
    B, H = len(lengths), HKV * G
    trash = B * PPR
    jpool, ppool = _pool(G, trash + 3)          # + trash page + staging pages
    table = _table(lengths, trash, seed=G)       # unallocated entries: trash
    q = (np.random.default_rng(G + 1).normal(size=(B, 1, H, D)) / 8).astype(np.float32)
    qj, qp = jnp.asarray(q, jnp.bfloat16), torch.from_numpy(q).bfloat16()
    length = np.asarray(lengths, np.int32)
    ref = jax.jit(lambda a: REF.paged_decode_attention(
        a, jpool, jnp.asarray(table), None, jnp.asarray(length), JPOL))(qj)
    base = torch.zeros((B,), dtype=torch.int32)
    got = QA.paged_quant_decode_attention(qp[:, 0], *ppool, torch.from_numpy(table),
                                          base, torch.from_numpy(length))
    assert got.dtype == torch.float32 and got.shape == (B, H, D)
    _close(got.bfloat16(), ref[:, 0], rtol=1e-2, atol=1e-2)
    pallas = JQA.paged_quant_decode_attention(
        jnp.asarray(qj[:, 0], jnp.float32), jpool.k_q, jpool.k_scale, jpool.k_zero,
        jpool.v, jnp.asarray(table), jnp.zeros((B,), jnp.int32),
        jnp.asarray(length), interpret=True)
    _close(got, pallas, rtol=2e-2, atol=2e-2)
    # the dispatcher's op returns the reference's layout and dtype
    class Pool:
        k_q, k_scale, k_zero, v = ppool
        window, key_bits = 0, 8
    out = PD.Dispatcher().paged_decode_attention(qp, Pool, torch.from_numpy(table),
                                                 torch.from_numpy(length), PPOL)
    assert out.shape == (B, 1, H, D) and out.dtype == torch.bfloat16
    assert torch.equal(out[:, 0], got.bfloat16())


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("C,pos0", [(16, 0), (16, 21), (8, 37)])
def test_prefill_attention_plain_vs_reference_and_pallas(G, C, pos0):
    H = HKV * G
    trash = 4 * PPR
    jpool, ppool = _pool(10 + G, trash + 3)
    table = _table([pos0 + C], trash, seed=C + G)
    q = (np.random.default_rng(pos0).normal(size=(1, C, H, D)) / 8).astype(np.float32)
    qj, qp = jnp.asarray(q, jnp.bfloat16), torch.from_numpy(q).bfloat16()
    ref = jax.jit(lambda a: REF.paged_prefill_attention(
        a, jpool, jnp.asarray(table), jnp.asarray(pos0, jnp.int32), JPOL))(qj)
    p0 = torch.tensor([pos0], dtype=torch.int32)
    got = FP.paged_flash_prefill_attention(qp, *ppool, torch.from_numpy(table), p0)
    assert got.dtype == torch.float32 and got.shape == (1, C, H, D)
    _close(got.bfloat16(), ref, rtol=1e-2, atol=1e-2)
    pallas = JFP.paged_flash_prefill_attention(
        qj, jpool.k_q, jpool.k_scale, jpool.k_zero, jpool.v, jnp.asarray(table),
        jnp.asarray([pos0], jnp.int32), interpret=True)
    _close(got, pallas, rtol=2e-2, atol=2e-2)


def test_attention_wrapper_checks():
    _, ppool = _pool(0, 8)
    q = torch.zeros((2, 3, D), dtype=torch.bfloat16)   # H=3 vs Hkv=2
    table = torch.zeros((2, PPR), dtype=torch.int32)
    z = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError):
        QA.paged_quant_decode_attention(q, *ppool, table, z, z)
    with pytest.raises(ValueError):
        FP.paged_flash_prefill_attention(torch.zeros((1, 4, 2, D)), *ppool,
                                         table, torch.zeros((1,), dtype=torch.int32))


def test_dispatcher_contract():
    with pytest.raises(ValueError):
        PD.Dispatcher(backend="tpu")
    d = PD.Dispatcher()
    assert d.fallbacks == []
    assert set(K.launch_counts()) == {"w4a8_matmul", "paged_quant_decode_attention",
                                      "paged_flash_prefill_attention", "rmsnorm",
                                      "grouped_matmul", "quant_decode_attention",
                                      "flash_prefill_attention"}


# ---------------------------------------------------------------------------
# grouped_matmul
# ---------------------------------------------------------------------------

def _experts(E, K, N, bits, seed):
    w = (np.random.default_rng(seed).normal(size=(E, K, N)) * 0.02).astype(np.float32)
    jw = JP.pack_expert_linear(JQ.quantize(jnp.asarray(w), bits))
    return jw, CV.params_from_reference(jw)


# (G, E, C, K, N): ragged shapes padded by the plan (K to 128s, N to 256s),
# one C=1 slab per expert (the selected-expert decode path), and empty
# capacity
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("G,E,C,K,N", [(1, 3, 5, 100, 72), (3, 2, 1, 300, 130),
                                       (1, 6, 1, 256, 512), (2, 3, 0, 96, 72)])
def test_grouped_matmul_plain_vs_reference_and_pallas(bits, G, E, C, K, N):
    jw, pw = _experts(E, K, N, bits, seed=E * C + bits)
    assert isinstance(pw, PP.PackedExpertLinear)
    x = np.random.default_rng(C).normal(size=(G, E, C, K)).astype(np.float32)
    xj, xp = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    qcfg_j, qcfg_p = JQ.QuantConfig(), PQ.QuantConfig()
    got = PD.Dispatcher().grouped_matmul(xp, pw, qcfg_p, out_dtype=torch.float32)
    assert got.shape == (G, E, C, N) and got.dtype == torch.float32
    ref = jax.jit(lambda a: REF.grouped_matmul(a, jw, qcfg_j, out_dtype=jnp.float32))(xj)
    assert _f32(ref).tobytes() == _f32(got).tobytes()          # bit for bit
    interp = JD.Dispatcher(backend="interpret")
    pallas = interp.grouped_matmul(xj, jw, qcfg_j, out_dtype=jnp.float32)
    assert interp.fallbacks == []
    _close(got, pallas, rtol=1e-4, atol=1e-4)
    # the dispatcher ran the plain version: the wrapper on CPU tensors is it
    xq, sx = PQ.quantize_activations(xp.movedim(1, 0).reshape(E, G * C, K))
    args = (xq, sx, pw.data, pw.scale[:, 0], pw.zero[:, 0])
    before = GM.grouped_matmul.launches
    y = GM.grouped_matmul(*args, bits=bits)
    assert torch.equal(y, GM.grouped_matmul_plain(*args, bits=bits))
    assert GM.grouped_matmul.launches == before
    assert torch.equal(y[..., :N].reshape(E, G, C, N).movedim(0, 1), got)


def test_grouped_matmul_wrapper_checks():
    _, pw = _experts(2, 128, 256, 4, seed=0)
    xq = torch.zeros((2, 3, 128), dtype=torch.int8)
    sx = torch.ones((2, 3, 1))
    args = (pw.data, pw.scale[:, 0], pw.zero[:, 0])
    with pytest.raises(ValueError):
        GM.grouped_matmul(xq[:1], sx[:1], *args, bits=4)            # expert axis
    with pytest.raises(ValueError):
        GM.grouped_matmul(xq, torch.ones((2, 3)), *args, bits=4)
    with pytest.raises(TypeError):
        GM.grouped_matmul(xq.float(), sx, *args, bits=4)
    with pytest.raises(ValueError):
        PD.Dispatcher().grouped_matmul(torch.zeros((1, 2, 3, 100)), pw, PQ.QuantConfig())
    # A16 experts take the reference's float path (counted), no kernel
    K.reset_launch_counts()
    y = PD.Dispatcher().grouped_matmul(torch.zeros((1, 2, 3, 128)), pw,
                                       PQ.QuantConfig(act_bits=16))
    assert y.shape == (1, 2, 3, 256) and K.counts()["float_matmul"] == 1


@pytest.mark.parametrize("bits", [4, 8])
def test_grouped_matmul_ids_match_take_experts_and_pallas(bits):
    """Slabs named by id in the whole table (the selected-expert decode
    path, with repeats): the port equals its own plain matmul over
    ``take_experts`` and the reference over its ``take_experts`` bit for
    bit, and the Pallas kernel over the reference's gather within 1e-4."""
    jw, pw = _experts(6, 200, 130, bits, seed=11)
    ids = np.asarray([3, 0, 5, 3, 1, 3, 2, 0], np.int32)
    x = np.random.default_rng(5).normal(size=(1, len(ids), 1, 200)).astype(np.float32)
    xj, xp = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    qcfg_j, qcfg_p = JQ.QuantConfig(), PQ.QuantConfig()
    got = PD.Dispatcher().grouped_matmul(xp, pw, qcfg_p, out_dtype=torch.float32,
                                         ids=torch.from_numpy(ids))
    assert got.shape == (1, len(ids), 1, 130)
    gathered = PD.Dispatcher().grouped_matmul(xp, PP.take_experts(pw, torch.from_numpy(ids)),
                                              qcfg_p, out_dtype=torch.float32)
    assert torch.equal(got, gathered)
    jsel = JP.take_experts(jw, jnp.asarray(ids))
    ref = jax.jit(lambda a: REF.grouped_matmul(a, jsel, qcfg_j, out_dtype=jnp.float32))(xj)
    assert _f32(ref).tobytes() == _f32(got).tobytes()
    interp = JD.Dispatcher(backend="interpret")
    _close(got, interp.grouped_matmul(xj, jsel, qcfg_j, out_dtype=jnp.float32),
           rtol=1e-4, atol=1e-4)
    assert interp.fallbacks == []


@pytest.mark.parametrize("bits", [4, 8])
def test_grouped_matmul_rows_plain_matches_pallas(bits):
    """Live-row counts per (expert, group) capacity segment, the rows past
    them zero: the plain version takes ``rows`` and computes every row, so
    it equals itself without them, the reference bit for bit and the Pallas
    kernel within 1e-4; the dead rows come out +0.0."""
    G, E, C, K, N = 2, 3, 20, 100, 72
    jw, pw = _experts(E, K, N, bits, seed=17)
    rows = np.asarray([[0, 20], [7, 3], [20, 0]], np.int32)          # [E, G]
    x = np.random.default_rng(9).normal(size=(G, E, C, K)).astype(np.float32)
    live = np.arange(C)[None, None] < rows.T[..., None]              # [G, E, C]
    x = x * live[..., None]
    xj, xp = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    qcfg_j, qcfg_p = JQ.QuantConfig(), PQ.QuantConfig()
    d = PD.Dispatcher()
    got = d.grouped_matmul(xp, pw, qcfg_p, out_dtype=torch.float32,
                           rows=torch.from_numpy(rows))
    assert torch.equal(got, d.grouped_matmul(xp, pw, qcfg_p, out_dtype=torch.float32))
    dead = got[torch.from_numpy(~live)]
    assert torch.equal(dead, torch.zeros_like(dead)) and not torch.signbit(dead).any()
    ref = jax.jit(lambda a: REF.grouped_matmul(a, jw, qcfg_j, out_dtype=jnp.float32))(xj)
    assert _f32(ref).tobytes() == _f32(got).tobytes()
    pallas = JD.Dispatcher(backend="interpret").grouped_matmul(xj, jw, qcfg_j,
                                                               out_dtype=jnp.float32)
    _close(got, pallas, rtol=1e-4, atol=1e-4)


def test_grouped_matmul_tables_checked():
    """``rows`` and ``ids`` must be int32 of their shapes; an id past the
    table raises on the CPU (the gather checks it)."""
    _, pw = _experts(4, 128, 256, 4, seed=0)
    d, qcfg = PD.Dispatcher(), PQ.QuantConfig()
    x = torch.zeros((1, 3, 2, 128))
    ids = torch.tensor([0, 3, 3], dtype=torch.int32)
    assert d.grouped_matmul(x, pw, qcfg, ids=ids).shape == (1, 3, 2, 256)
    for bad in (ids.long(), ids[:2], ids[None]):
        with pytest.raises(ValueError):
            d.grouped_matmul(x, pw, qcfg, ids=bad)
    with pytest.raises(IndexError):
        d.grouped_matmul(x, pw, qcfg, ids=torch.tensor([0, 4, 1], dtype=torch.int32))
    x = torch.zeros((2, 4, 3, 128))
    rows = torch.tensor([[3, 0], [1, 2], [0, 0], [3, 3]], dtype=torch.int32)
    assert d.grouped_matmul(x, pw, qcfg, rows=rows).shape == (2, 4, 3, 256)
    for bad in (rows.long(), rows.t().contiguous(), rows[:, :1]):
        with pytest.raises(ValueError):
            d.grouped_matmul(x, pw, qcfg, rows=bad)
    xq, sx = torch.zeros((4, 6, 128), dtype=torch.int8), torch.ones((4, 6, 1))
    args = (pw.data, pw.scale[:, 0], pw.zero[:, 0])
    with pytest.raises(ValueError):                                  # G must divide M
        GM.grouped_matmul(xq, sx, *args, bits=4, rows=torch.zeros((4, 4), dtype=torch.int32))
    with pytest.raises(ValueError):                                  # one id per slab
        GM.grouped_matmul(xq, sx, *args, bits=4, ids=torch.zeros((3,), dtype=torch.int32))


# ---------------------------------------------------------------------------
# quant_decode_attention (dense cache)
# ---------------------------------------------------------------------------

def _dense_cache(B, S, seed):
    """A dense cache written by the reference's own quantization, and the
    port's copy."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(B, S, HKV, D)).astype(np.float32)
    v = rng.normal(size=(B, S, HKV, D)).astype(np.float32)
    kq, ks, kz = JKV.quantize_keys(jnp.asarray(k, jnp.bfloat16))
    vv = JKV.cast_values(jnp.asarray(v, jnp.bfloat16), JQ.FP8_DTYPE)
    jc = JKV.LayerKVCache(k_q=kq, k_scale=ks, k_zero=kz, v=vv,
                          length=jnp.zeros((), jnp.int32))
    pc = PKV.LayerKVCache(*(CV.to_tensor(a) for a in (kq, ks, kz, vv)),
                          length=torch.zeros((), dtype=torch.int32))
    return jc, pc


@pytest.mark.parametrize("G", [1, 3, 16, 24])
@pytest.mark.parametrize("pos", [[37, 5, 64], 23])
def test_dense_decode_attention_plain_vs_reference_and_pallas(G, pos):
    B, S, H = 3, 64, HKV * G
    jc, pc = _dense_cache(B, S, seed=G)
    q = (np.random.default_rng(G + 1).normal(size=(B, 1, H, D)) / 8).astype(np.float32)
    qj, qp = jnp.asarray(q, jnp.bfloat16), torch.from_numpy(q).bfloat16()
    ref = jax.jit(lambda a, p: REF.decode_attention(a, jc, p, JPOL))(
        qj, jnp.asarray(pos, jnp.int32))
    out = PD.Dispatcher().decode_attention(qp, pc, torch.tensor(pos, dtype=torch.int32),
                                           PPOL)
    assert out.shape == (B, 1, H, D) and out.dtype == torch.bfloat16
    _close(out, ref, rtol=1e-2, atol=1e-2)
    got = QA.quant_decode_attention(qp[:, 0], pc.k_q, pc.k_scale, pc.k_zero, pc.v,
                                    torch.tensor(pos, dtype=torch.int32))
    assert got.dtype == torch.float32 and torch.equal(got.bfloat16(), out[:, 0])
    pallas = JQA.quant_decode_attention(
        jnp.asarray(qj[:, 0], jnp.float32), jc.k_q, jc.k_scale, jc.k_zero, jc.v,
        jnp.asarray(pos, jnp.int32), block_s=JD._decode_block(S), interpret=True)
    _close(got, pallas, rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# flash_prefill_attention (unquantized K/V)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("T,S,causal,window", [(40, 40, True, 0), (24, 64, True, 0),
                                               (24, 40, False, 0), (40, 40, True, 8)])
def test_flash_prefill_plain_vs_reference_and_pallas(G, T, S, causal, window):
    H = HKV * G
    rng = np.random.default_rng(T + S + G)
    q = (rng.normal(size=(2, T, H, D)) / 8).astype(np.float32)
    k = rng.normal(size=(2, S, HKV, D)).astype(np.float32)
    v = rng.normal(size=(2, S, HKV, D)).astype(np.float32)
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    qp, kp, vp = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    ref = jax.jit(lambda a, b, c: REF.prefill_attention(
        a, b, c, causal=causal, window=window, policy=JPOL))(qj, kj, vj)
    out = PD.Dispatcher().prefill_attention(qp, kp, vp, causal=causal, window=window,
                                            policy=PPOL)
    assert out.shape == (2, T, H, D) and out.dtype == torch.bfloat16
    _close(out, ref, rtol=1e-2, atol=1e-2)
    got = FP.flash_prefill_attention(qp, kp, vp, causal=causal, window=window)
    assert got.dtype == torch.float32 and torch.equal(got.bfloat16(), out)
    pallas = JFP.flash_prefill_attention(qj, kj, vj, causal=causal, window=window,
                                         bq=16, bk=16, interpret=True)
    _close(got, pallas, rtol=2e-2, atol=2e-2)


def test_dense_attention_wrapper_checks():
    _, pc = _dense_cache(2, 16, seed=0)
    q = torch.zeros((2, 3, D), dtype=torch.bfloat16)           # H=3 vs Hkv=2
    with pytest.raises(ValueError):
        QA.quant_decode_attention(q, pc.k_q, pc.k_scale, pc.k_zero, pc.v, 4)
    with pytest.raises(ValueError):
        QA.quant_decode_attention(q[:, :2], pc.k_q, pc.k_scale, pc.k_zero, pc.v,
                                  torch.tensor([1, 2, 3]))
    kv = torch.zeros((1, 8, HKV, D), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        FP.flash_prefill_attention(torch.zeros((1, 8, 3, D), dtype=torch.bfloat16), kv, kv)
    with pytest.raises(ValueError):
        FP.flash_prefill_attention(torch.zeros((1, 8, 2, D), dtype=torch.bfloat16),
                                   kv, kv[:, :4])
