"""The port's public kernel ops, their oracles and the scheduler's load
balancing (C4), held to the JAX package on the same numpy inputs.

``repro_torch.kernels.ops`` against ``repro.kernels.ops`` (the Pallas
kernels in interpret mode) and ``repro_torch.kernels.ref`` against
``repro.kernels.ref``, at ``tests/test_kernels.py``'s shapes and
tolerances.  The integer matmul oracle is bit-equal to the compiled
reference oracle: XLA contracts its ``acc - zero * rowsum`` into one fused
multiply-add, which the port's plain version reproduces (run op by op, the
reference rounds twice).  ``balance_requests`` / ``uniform_requests`` /
``makespan`` equal the reference's bucket for bucket, and the launcher's
``--no-continuous`` path prints the reference's C4 makespan line."""
import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import kv_cache as JKV  # noqa: E402
from repro.core import quantization as JQ  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.kernels import ref as JREF  # noqa: E402
from repro.serving import scheduler as JS  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import ops as PO  # noqa: E402
from repro_torch.kernels import ref as PREF  # noqa: E402
from repro_torch.launch import serve as PLS  # noqa: E402
from repro_torch.serving import scheduler as PS  # noqa: E402


def _t(a) -> torch.Tensor:
    """A JAX or numpy array as a torch tensor with the same bytes (fp8 by
    its bit pattern)."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# kernels/ref.py
# ---------------------------------------------------------------------------

def _matmul_operands(m, k, n, bits, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    qt = JQ.quantize(jnp.asarray(w), bits)
    return x, qt


@pytest.mark.parametrize("m,k,n", [(8, 128, 128), (16, 256, 256),
                                   (32, 128, 512), (8, 512, 128)])
@pytest.mark.parametrize("bits", [4, 8])
def test_integer_matmul_oracle_bit_equal(m, k, n, bits):
    x, qt = _matmul_operands(m, k, n, bits)
    xq, sx = JQ.quantize_activations(jnp.asarray(x))
    wq = JQ.unpack_int4(qt.data) if bits == 4 else qt.data
    args = (xq, sx, wq, qt.scale[0], qt.zero[0])
    jref = JREF.w4a8_matmul_ref if bits == 4 else JREF.w8a8_matmul_ref
    pref = PREF.w4a8_matmul_ref if bits == 4 else PREF.w8a8_matmul_ref
    want = np.asarray(jax.jit(jref)(*args))
    got = pref(*[_t(a) for a in args])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _decode_operands(s, hkv, g, d, seed=1, value_dtype=None):
    rng = np.random.default_rng(seed)
    B, H = 2, hkv * g
    qv = (rng.standard_normal((B, H, d)) / d ** 0.5).astype(np.float32)
    k = rng.standard_normal((B, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((B, s, hkv, d)).astype(np.float32)
    kq, ks, kz = JKV.quantize_keys(jnp.asarray(k))
    vv = JQ.to_fp8(jnp.asarray(v)) if value_dtype is None else jnp.asarray(v).astype(value_dtype)
    return jnp.asarray(qv), kq, ks, kz, vv


DECODE_SHAPES = [(256, 2, 4, 64, 128), (512, 4, 1, 128, 256), (1024, 1, 8, 64, 512)]


@pytest.mark.parametrize("s,hkv,g,d,blk", DECODE_SHAPES)
def test_decode_attention_oracle(s, hkv, g, d, blk):
    args = _decode_operands(s, hkv, g, d)
    L = s * 3 // 4
    want = JREF.quant_decode_attention_ref(*args, jnp.int32(L))
    got = PREF.quant_decode_attention_ref(*[_t(a) for a in args], L)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("rows,d", [(8, 128), (100, 256), (257, 512)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_rmsnorm_oracle(rows, d, dtype):
    rng = np.random.default_rng(rows)
    x = jnp.asarray(rng.standard_normal((rows, d)), jnp.float32).astype(dtype)
    w = jnp.asarray(np.abs(rng.standard_normal(d)) + 0.5, jnp.float32)
    want = JREF.rmsnorm_ref(x, w)
    got = PREF.rmsnorm_ref(_t(x), _t(w))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# kernels/ops.py against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,bits", [(8, 128, 128, 4), (16, 256, 256, 8),
                                        (32, 128, 512, 4), (8, 512, 128, 8)])
def test_quant_matmul_kernel_matches_reference_op(m, k, n, bits):
    x, qt = _matmul_operands(m, k, n, bits, seed=m + k)
    want = JO.quant_matmul_kernel(jnp.asarray(x), qt.data, qt.scale[0], qt.zero[0],
                                  bits=bits)
    got = PO.quant_matmul_kernel(_t(x), _t(qt.data), _t(qt.scale[0]), _t(qt.zero[0]),
                                 bits=bits)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("s,hkv,g,d,blk", DECODE_SHAPES)
def test_quant_decode_attention_matches_reference_op(s, hkv, g, d, blk):
    args = _decode_operands(s, hkv, g, d, seed=2)
    length = jnp.asarray([s * 3 // 4], jnp.int32)
    want = JO.quant_decode_attention(*args, length, block_s=blk)
    got = PO.quant_decode_attention(*[_t(a) for a in args], _t(length))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quant_decode_attention_value_dtypes(dtype):
    args = _decode_operands(256, 2, 2, 64, seed=3, value_dtype=dtype)
    want = JO.quant_decode_attention(*args, jnp.asarray([256], jnp.int32), block_s=128)
    got = PO.quant_decode_attention(*[_t(a) for a in args], 256)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("shape", [(8, 128), (2, 5, 128)])
def test_rmsnorm_matches_reference_op(shape):
    rng = np.random.default_rng(len(shape))
    x = jnp.asarray(rng.standard_normal(shape), jnp.float32).astype(jnp.bfloat16)
    w = jnp.asarray(np.abs(rng.standard_normal(shape[-1])) + 0.5, jnp.float32)
    want = JO.rmsnorm(x, w)
    got = PO.rmsnorm(_t(x), _t(w))
    assert got.shape == tuple(shape) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("t,hkv,g,d,w,causal", [
    (128, 2, 3, 64, 0, True),
    (96, 1, 4, 32, 16, True),     # sliding window
    (64, 2, 1, 64, 0, False),     # bidirectional (encoder)
    (100, 2, 2, 64, 0, True),     # ragged T (padding path)
])
def test_flash_prefill_matches_reference_op(t, hkv, g, d, w, causal):
    rng = np.random.default_rng(t)
    B = 2
    qv = (rng.standard_normal((B, t, hkv * g, d)) / d ** 0.5).astype(np.float32)
    k = rng.standard_normal((B, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((B, t, hkv, d)).astype(np.float32)
    want = JO.flash_prefill(jnp.asarray(qv), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, window=w, bq=32, bk=32)
    got = PO.flash_prefill(_t(qv), _t(k), _t(v), causal=causal, window=w)
    assert got.shape == (B, t, hkv * g, d)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_ops_keep_the_dispatch_contract():
    """CPU tensors run the plain versions and launch nothing; a tensor on
    any other device without a kernel raises instead of falling back."""
    K.reset_launch_counts()
    x, qt = _matmul_operands(8, 128, 128, 4)
    PO.quant_matmul_kernel(_t(x), _t(qt.data), _t(qt.scale[0]), _t(qt.zero[0]))
    PO.rmsnorm(torch.ones(3, 128), torch.ones(128))
    assert all(n == 0 for n in K.counts().values()), K.counts()
    meta = torch.device("meta")
    with pytest.raises(NotImplementedError):
        PO.rmsnorm(torch.ones(3, 128, device=meta), torch.ones(128, device=meta))
    with pytest.raises(NotImplementedError):
        PO.quant_decode_attention(
            torch.ones(1, 2, 64, dtype=torch.bfloat16, device=meta),
            torch.ones(1, 8, 1, 64, dtype=torch.int8, device=meta),
            torch.ones(1, 8, 1, device=meta), torch.ones(1, 8, 1, device=meta),
            torch.ones(1, 8, 1, 64, dtype=torch.bfloat16, device=meta), 8)
    with pytest.raises(NotImplementedError):
        q = torch.ones(1, 4, 2, 64, dtype=torch.bfloat16, device=meta)
        PO.flash_prefill(q, q[:, :, :1], q[:, :, :1])


# ---------------------------------------------------------------------------
# the scheduler's load balancing (C4) and the launcher's line
# ---------------------------------------------------------------------------

def _trace(seed: int, n: int):
    rng = np.random.default_rng(seed)
    specs = [([int(t) for t in rng.integers(1, 100, int(rng.integers(1, 300)))],
              int(rng.integers(1, 64))) for _ in range(n)]
    return ([JS.Request(uid=i, prompt_tokens=p, max_new_tokens=m)
             for i, (p, m) in enumerate(specs)],
            [PS.Request(uid=i, prompt_tokens=p, max_new_tokens=m)
             for i, (p, m) in enumerate(specs)])


def _uids(buckets):
    return [[r.uid for r in b] for b in buckets]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("rates", [None, (1.0, 2.0, 0.5), (3.0, 1.0, 1.0, 1.0, 2.5)])
def test_balance_and_uniform_match_reference(seed, rates):
    n_workers = len(rates) if rates else 4
    jreqs, preqs = _trace(seed, 7 + 5 * seed)
    jb = JS.balance_requests(jreqs, n_workers, rates)
    pb = PS.balance_requests(preqs, n_workers, rates)
    assert _uids(pb) == _uids(jb)
    ju, pu = JS.uniform_requests(jreqs, n_workers), PS.uniform_requests(preqs, n_workers)
    assert _uids(pu) == _uids(ju)
    assert PS.makespan(pb, rates) == JS.makespan(jb, rates)
    assert PS.makespan(pu, rates) == JS.makespan(ju, rates)


def test_balance_rejects_rates_of_another_length():
    with pytest.raises(ValueError, match="rates"):
        PS.balance_requests([], 3, [1.0, 2.0])


def test_launcher_prints_the_c4_line(tmp_path):
    """``--no-continuous`` prints the reference launcher's C4 line, its
    makespans those of the reference helpers over the launcher's requests."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = PLS.main(["--arch", "qwen2-7b@tiny", "--device", "cpu", "--max-seq", "64",
                        "--no-continuous", "--requests", "6", "--max-new", "2",
                        "--max-prompt", "12", "--flash-dir", str(tmp_path)])
    jreqs = [JS.Request(uid=r.uid, prompt_tokens=r.prompt_tokens,
                        max_new_tokens=r.max_new_tokens) for r in out]
    want = (f"[serve] C4 makespan: "
            f"balanced={JS.makespan(JS.balance_requests(jreqs, 4)):.0f} "
            f"uniform={JS.makespan(JS.uniform_requests(jreqs, 4)):.0f}")
    assert want in buf.getvalue().splitlines()
