"""Port vs reference: C5's mixed float precision (``core/precision.py``) --
the policies, ``cast_in``, ``matmul``, ``softmax`` and ``attention_scores``
on the same numpy inputs, at the reference tests' tolerances
(``tests/test_precision.py``: 1e-5 where the products are float32 sums;
fp16 results to fp16's own resolution), and the paper's fp16 overflow that
pre-scaling the query avoids."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from repro.core import precision as JPR  # noqa: E402
from repro_torch.core import precision as PPR  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _policies(compute, accum, softmax, prescale):
    j, p = zip(*(DTYPES[d] for d in (compute, accum, softmax)))
    return (JPR.PrecisionPolicy(*j, prescale_query=prescale),
            PPR.PrecisionPolicy(*p, prescale_query=prescale))


POLICIES = {
    "default": (JPR.DEFAULT_POLICY, PPR.DEFAULT_POLICY),
    "unsafe_fp16": (JPR.UNSAFE_FP16_POLICY, PPR.UNSAFE_FP16_POLICY),
    "fp32_pre": _policies("float32", "float32", "float32", True),
    "fp32_post": _policies("float32", "float32", "float32", False),
    "fp16_pre": _policies("float16", "float16", "float32", True),
}


def _tol(pol):
    return 1e-3 if pol.accum_dtype == torch.float16 else 1e-5


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def test_policies_field_by_field():
    for name, (j, p) in POLICIES.items():
        for f in ("compute_dtype", "accum_dtype", "softmax_dtype"):
            assert str(getattr(p, f)).replace("torch.", "") == \
                jnp.dtype(getattr(j, f)).name, (name, f)
        assert j.prescale_query == p.prescale_query


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_helpers_match_reference(name):
    jpol, ppol = POLICIES[name]
    rng = np.random.default_rng(len(name))
    q = rng.normal(size=(2, 4, 64)).astype(np.float32)
    k = rng.normal(size=(2, 6, 64)).astype(np.float32)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    tol = _tol(ppol)
    c = ppol.cast_in(tq)
    assert c.dtype == ppol.compute_dtype
    np.testing.assert_array_equal(_np(c), _np(jpol.cast_in(jnp.asarray(q))))
    s_j = JPR.attention_scores(jnp.asarray(q), jnp.asarray(k), 64, jpol)
    s_p = PPR.attention_scores(tq, tk, 64, ppol)
    assert s_p.dtype == ppol.accum_dtype and s_p.shape == s_j.shape
    np.testing.assert_allclose(_np(s_p), _np(s_j), rtol=tol, atol=tol)
    m_j = JPR.matmul(jnp.asarray(q), jnp.asarray(k).swapaxes(-1, -2), jpol)
    m_p = PPR.matmul(tq, tk.transpose(-1, -2), ppol)
    assert m_p.dtype == ppol.accum_dtype
    np.testing.assert_allclose(_np(m_p), _np(m_j), rtol=tol, atol=tol)
    y_j = JPR.softmax(s_j, policy=jpol)
    y_p = PPR.softmax(s_p, policy=ppol)
    assert y_p.dtype == ppol.softmax_dtype
    np.testing.assert_allclose(_np(y_p), _np(y_j), rtol=tol, atol=tol)


def test_prescale_equivalent_to_postscale_in_fp32():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, 4, 64)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 6, 64)).astype(np.float32))
    s1 = PPR.attention_scores(q, k, 64, POLICIES["fp32_pre"][1])
    s2 = PPR.attention_scores(q, k, 64, POLICIES["fp32_post"][1])
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), rtol=1e-5, atol=1e-5)


def test_prescaling_prevents_fp16_overflow():
    """40 * 40 * 256 = 409600 > 65504 overflows fp16 when Q.K^T accumulates
    before the scale; pre-scaled, 2.5 * 40 * 256 = 25600 fits -- in both
    packages, at the same entries."""
    x = np.full((1, 2, 256), 40.0, np.float32)
    for jpol, ppol, overflows in ((JPR.UNSAFE_FP16_POLICY, PPR.UNSAFE_FP16_POLICY, True),
                                  (*POLICIES["fp16_pre"], False)):
        s_j = JPR.attention_scores(jnp.asarray(x), jnp.asarray(x), 256, jpol)
        s_p = PPR.attention_scores(torch.from_numpy(x), torch.from_numpy(x), 256, ppol)
        assert bool(torch.isinf(s_p).any()) == overflows
        np.testing.assert_array_equal(np.isinf(_np(s_p)), np.isinf(_np(s_j)))
        if not overflows:
            np.testing.assert_array_equal(_np(s_p), _np(s_j))


def test_softmax_fp32_under_bf16_policy():
    x = torch.tensor([[1e3, -1e3, 0.0]], dtype=torch.bfloat16)
    y = PPR.softmax(x, policy=PPR.DEFAULT_POLICY)
    assert y.dtype == torch.float32
    assert abs(float(y.sum()) - 1.0) < 1e-6
    want = JPR.softmax(jnp.asarray([[1e3, -1e3, 0.0]], jnp.bfloat16), policy=JPR.DEFAULT_POLICY)
    np.testing.assert_array_equal(y.numpy(), np.asarray(want))
