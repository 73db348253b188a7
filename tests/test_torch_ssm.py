"""The port's recurrent layers (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``) on the CPU, at ``@reduced`` width.

jamba-1.5-large-398b@reduced (d_model 256: d_inner 512, d_state 16, dt_rank
16) for mamba, rwkv6-7b@reduced (d_model 128: two wkv heads of 64) for
rwkv6, each on the reference's own quantized packed parameters (converted
by ``repro_torch.convert``), the reference compiled with XLA's excess
precision off as in ``test_torch_engine``.  Inputs and entry states are
drawn with numpy from a seed.  What is held against the reference:

- the in-block scan's combine tree, ``jax.lax.associative_scan``'s at
  length 8, within float32 rounding;
- ``mamba_forward`` whole, padded (``valid_len``), past ``MAMBA_CHUNK``
  (T = 1024) and ``mamba_decode``; ``rwkv_time_mix`` and
  ``rwkv_channel_mix`` whole and over a partition of padded chunks that
  carry the state, and ``rwkv_time_mix`` past ``RWKV_CHUNK`` (T = 300):
  outputs within a relative L2 of 1e-2, float32 states within 1e-3
  (relative L2), the bf16 states, which copy activations of the integer
  path, bit for bit; the bf16 linear of rwkv6's decay within 1e-6.

The port's own partition invariance (chunked against whole, on the port
alone) is held bit for bit: the CPU path gives it.  The reference's
chunked mamba is never held to its whole pass (a known fault of the
reference, ROADMAP queue 3)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.configs import registry as PR  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import ssm as PS  # noqa: E402
from repro_torch.runtime import dispatch as PD  # noqa: E402
from repro_torch.runtime import plan as PP  # noqa: E402
from test_torch_engine import STRICT  # noqa: E402

OUT_TOL = 1e-2        # relative L2 of a layer's bf16 output
STATE_TOL = 1e-3      # relative L2 of a float32 state
DISP = PD.Dispatcher()


def _rel(a, b) -> float:
    a = np.asarray(jnp.asarray(a, jnp.float32), np.float64)
    b = (b.float() if torch.is_tensor(b) else torch.as_tensor(b)).double().numpy()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _bytes(x) -> bytes:
    a = CV.to_numpy(x) if torch.is_tensor(x) else np.asarray(x)
    return a.reshape(-1).view(np.uint8).tobytes()


def _states_match(sj: dict, sp: dict) -> None:
    assert set(sj) == set(sp)
    for k in sj:
        if sp[k].dtype == torch.float32:
            assert _rel(sj[k], sp[k]) <= STATE_TOL, k
        else:
            assert _bytes(sj[k]) == _bytes(sp[k]), k


def _layer(arch: str, fn, seed: int):
    cfg_j, cfg_p = JR.get(arch), PR.get(arch)
    b = JL.ParamBuilder("init", key=jax.random.PRNGKey(seed), quantized=True,
                        qcfg=cfg_j.quant, pack=True)
    pj = fn(b, cfg_j)
    return cfg_j, cfg_p, pj, CV.params_from_reference(pj)


@pytest.fixture(scope="module")
def mamba():
    return _layer("jamba-1.5-large-398b@reduced", JS.mamba_params, 3)


@pytest.fixture(scope="module")
def rwkv():
    return _layer("rwkv6-7b@reduced", JS.rwkv_params, 4)


def _x(rng, B, T, d):
    return jnp.asarray(rng.normal(size=(B, T, d)), jnp.bfloat16)


def _entry_state(rng, init, B, cfg_j, scales: dict):
    """A nonzero entry state of the reference's shapes and dtypes."""
    st = init(B, cfg_j)
    return {k: jnp.asarray(rng.normal(size=v.shape) * scales[k], v.dtype)
            for k, v in st.items()}


def _to_port(tree):
    return {k: CV.to_tensor(v) for k, v in tree.items()}


MAMBA_SCALES = {"conv": 1.0, "ssm": 0.5}
RWKV_SCALES = {"x_tm": 1.0, "x_cm": 1.0, "wkv": 0.3}


def test_scan_block_is_the_chunk_alignment():
    assert PS.SCAN_BLOCK == JS.SCAN_BLOCK == PP.CHUNK_ALIGN == 8
    assert (PS.MAMBA_CHUNK, PS.RWKV_CHUNK) == (JS.MAMBA_CHUNK, JS.RWKV_CHUNK)
    cfg = PR.get("jamba-1.5-large-398b@tiny")
    for req in (8, 13, 64, 100):
        cap = PP.prefill_chunk_schedule(cfg, req, page_size=16)
        assert cap % PS.SCAN_BLOCK == 0 and cap >= PS.SCAN_BLOCK


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_assoc_scan_follows_jax_combine_tree(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, size=(2, 3, n, 5, 4)).astype(np.float32)
    b = rng.normal(size=(2, 3, n, 5, 4)).astype(np.float32)

    def combine(e1, e2):
        return e2[0] * e1[0], e2[0] * e1[1] + e2[1]
    ja, jb = jax.jit(lambda x, y: jax.lax.associative_scan(combine, (x, y), axis=2),
                     compiler_options=STRICT)(a, b)
    pa, pb = PS._assoc_scan(torch.from_numpy(a), torch.from_numpy(b), dim=2)
    np.testing.assert_allclose(np.asarray(ja), pa.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jb), pb.numpy(), rtol=1e-6, atol=1e-6)
    # the tree, not a sequential fold: the first element passes through
    assert np.array_equal(np.asarray(jb)[:, :, 0], pb.numpy()[:, :, 0])


def test_bf16_linear_is_float32_products_of_bf16_operands(rwkv):
    cfg_j, cfg_p, pj, pp = rwkv
    assert pp["wA"]["w"].dtype == torch.bfloat16 and pp["wA"]["w"].shape == (128, 64)
    x = _x(np.random.default_rng(0), 2, 5, cfg_j.d_model)
    ref = jax.jit(lambda a: JL.apply_linear(a, pj["wA"], cfg_j.quant, out_dtype=jnp.float32),
                  compiler_options=STRICT)(x)
    got = PL.apply_linear(CV.to_tensor(x), pp["wA"], cfg_p.quant, DISP, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and _rel(ref, got) <= 1e-6
    assert DISP.fallbacks == []
    # the builder's bits=16 linear is the reference's: a bf16 weight, N(0, 0.02)
    b = PL.ParamBuilder(torch.Generator().manual_seed(0), "cpu", cfg_p.quant)
    w = b.linear(128, 64, bits=16, lead=(3,))["w"]
    assert w.dtype == torch.bfloat16 and w.shape == (3, 128, 64)
    assert 0.015 < float(w.float().std()) < 0.025


def _mamba_ref(cfg_j, pj, x, st, valid_len=None):
    return jax.jit(lambda a, s: JS.mamba_forward(a, pj, cfg_j, s, valid_len=valid_len),
                   compiler_options=STRICT)(x, st)


@pytest.mark.parametrize("T,valid", [(21, None), (24, 19), (24, 0), (1024, None), (1024, 700)])
def test_mamba_forward_matches_reference(mamba, T, valid):
    """Whole prompts (T = 21 pads its last block with identities), a padded
    chunk, an all-padding chunk (the state passes through) and T = 1024,
    which both packages run as two MAMBA_CHUNK pieces."""
    cfg_j, cfg_p, pj, pp = mamba
    rng = np.random.default_rng(T + (valid or 0))
    B = 1 if T > PS.MAMBA_CHUNK else 2
    x = _x(rng, B, T, cfg_j.d_model)
    st = _entry_state(rng, JS.init_mamba_state, B, cfg_j, MAMBA_SCALES)
    yj, sj = _mamba_ref(cfg_j, pj, x, st, valid)
    yp, sp = PS.mamba_forward(CV.to_tensor(x), pp, cfg_p, _to_port(st), DISP,
                              valid_len=None if valid is None else torch.tensor([valid]))
    n = T if valid is None else valid
    if n:
        assert _rel(yj[:, :n], yp[:, :n]) <= OUT_TOL
    _states_match(sj, sp)
    if valid == 0:
        assert _bytes(sp["ssm"]) == _bytes(st["ssm"]) and _bytes(sp["conv"]) == _bytes(st["conv"])


def test_mamba_decode_matches_reference(mamba):
    cfg_j, cfg_p, pj, pp = mamba
    rng = np.random.default_rng(7)
    st = _entry_state(rng, JS.init_mamba_state, 3, cfg_j, MAMBA_SCALES)
    sp = _to_port(st)
    for _ in range(3):
        x = _x(rng, 3, 1, cfg_j.d_model)
        yj, st = jax.jit(lambda a, s: JS.mamba_decode(a, pj, cfg_j, s),
                         compiler_options=STRICT)(x, st)
        yp, sp = PS.mamba_decode(CV.to_tensor(x), pp, cfg_p, sp, DISP)
        assert _rel(yj, yp) <= OUT_TOL
        _states_match(st, sp)


def _chunks(x, parts, block=8):
    """(padded chunk, real tokens) for each part of the partition."""
    t = 0
    for c in parts:
        xc = x[:, t:t + c]
        pad = -c % block
        if pad:
            xc = jnp.concatenate([xc, jnp.zeros((x.shape[0], pad, x.shape[2]), x.dtype)], 1)
        yield xc, c
        t += c


RWKV_FNS = {"time_mix": (JS.rwkv_time_mix, PS.rwkv_time_mix),
            "channel_mix": (JS.rwkv_channel_mix, PS.rwkv_channel_mix)}


@pytest.mark.parametrize("which", list(RWKV_FNS))
def test_rwkv_matches_reference_whole_and_chunked(rwkv, which):
    """A 37-token prompt from a nonzero state: whole, then as chunks of 16,
    8 and 13 (padded to 16) carrying the state, each on both packages."""
    cfg_j, cfg_p, pj, pp = rwkv
    fj, fp = RWKV_FNS[which]
    rng = np.random.default_rng(11)
    x = _x(rng, 2, 37, cfg_j.d_model)
    st = _entry_state(rng, JS.init_rwkv_state, 2, cfg_j, RWKV_SCALES)
    step_j = jax.jit(lambda a, s, vl: fj(a, pj, cfg_j, s, valid_len=vl),
                     compiler_options=STRICT)
    yj, sj = jax.jit(lambda a, s: fj(a, pj, cfg_j, s), compiler_options=STRICT)(x, st)
    yp, sp = fp(CV.to_tensor(x), pp, cfg_p, _to_port(st), DISP)
    assert _rel(yj, yp) <= OUT_TOL
    _states_match(sj, sp)
    cj, cp = st, _to_port(st)
    for xc, c in _chunks(x, [16, 8, 13]):
        yj, cj = step_j(xc, cj, jnp.asarray(c, jnp.int32))
        yp, cp = fp(CV.to_tensor(xc), pp, cfg_p, cp, DISP, valid_len=torch.tensor([c]))
        assert _rel(yj[:, :c], yp[:, :c]) <= OUT_TOL
        _states_match(cj, cp)


def test_rwkv_time_mix_past_rwkv_chunk_matches_reference(rwkv):
    """T = 300: the port forms k v^T in a 256-token piece and a 44-token one
    (the reference scans the 300 tokens in one piece); same fold."""
    cfg_j, cfg_p, pj, pp = rwkv
    rng = np.random.default_rng(12)
    x = _x(rng, 1, 300, cfg_j.d_model)
    st = _entry_state(rng, JS.init_rwkv_state, 1, cfg_j, RWKV_SCALES)
    yj, sj = jax.jit(lambda a, s: JS.rwkv_time_mix(a, pj, cfg_j, s),
                     compiler_options=STRICT)(x, st)
    yp, sp = PS.rwkv_time_mix(CV.to_tensor(x), pp, cfg_p, _to_port(st), DISP)
    assert _rel(yj, yp) <= OUT_TOL
    _states_match(sj, sp)


def _port_chunked(fn, x, st, parts):
    ys = []
    for xc, c in _chunks(x, parts):
        y, st = fn(CV.to_tensor(xc), st, torch.tensor([c]))
        ys.append(y[:, :c])
    return torch.cat(ys, 1), st


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_partition_invariance_is_bitwise(mamba, rwkv, seed):
    """The port's own property: any 8-aligned partition of a ragged prompt,
    padded chunks carrying the state, gives the whole pass's outputs and exit
    state bit for bit (mamba, both rwkv mixes)."""
    rng = np.random.default_rng(seed)
    T = 8 * int(rng.integers(2, 7)) + int(rng.integers(1, 8))
    parts, t = [], 0
    while t < T:
        c = 8 * int(rng.integers(1, 4))
        parts.append(min(c, T - t))
        t += c
    cases = [(mamba, PS.mamba_forward, JS.init_mamba_state, MAMBA_SCALES)] + [
        (rwkv, fp, JS.init_rwkv_state, RWKV_SCALES) for _fj, fp in RWKV_FNS.values()]
    for (cfg_j, cfg_p, _pj, pp), fn, init, scales in cases:
        x = _x(rng, 2, T, cfg_j.d_model)
        st = _to_port(_entry_state(rng, init, 2, cfg_j, scales))
        call = lambda xc, s, vl: fn(xc, pp, cfg_p, s, DISP, valid_len=vl)  # noqa: E731
        y_whole, s_whole = _port_chunked(call, x, st, [T])
        y_plain, _ = fn(CV.to_tensor(x), pp, cfg_p, st, DISP)
        assert _bytes(y_plain) == _bytes(y_whole)
        y, s = _port_chunked(call, x, st, parts)
        assert _bytes(y) == _bytes(y_whole), (fn.__name__, parts)
        for k in s_whole:
            assert _bytes(s[k]) == _bytes(s_whole[k]), (fn.__name__, k, parts)


def test_state_rows_round_trip(mamba):
    """``read_state_row`` / ``write_state_row`` (the Flash tier's snapshot)
    move one row's bytes, bf16 leaves as their bits."""
    _cfg_j, cfg_p, _pj, _pp = mamba
    st = PS.init_mamba_state(3, cfg_p, lead=(2,))
    gen = torch.Generator().manual_seed(0)
    for v in st.values():
        v.copy_(torch.randn(v.shape, generator=gen).to(v.dtype))
    arrays = PS.read_state_row(st, 1)
    assert {k: a.shape for k, a in arrays.items()} == {
        k: (2, 1, *v.shape[2:]) for k, v in st.items()}
    other = {k: torch.zeros_like(v) for k, v in st.items()}
    PS.write_state_row(other, 2, arrays)
    for k in st:
        assert torch.equal(other[k][:, 2], st[k][:, 1])
        assert not other[k][:, :2].any()
    with pytest.raises(ValueError):
        PS.write_state_row(other, 0, {k: a[:1, :, :1] for k, a in arrays.items()})
