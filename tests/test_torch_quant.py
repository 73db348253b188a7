"""Port vs reference: configurations, the integer quantization paths (bit for
bit), the load-time plan's layout and geometry, and parameter conversion.

Inputs are drawn with numpy and handed to both packages.  The reference's
serving steps run under ``jax.jit``, where XLA turns a division by a
constant into a multiplication by its float32 reciprocal; the comparisons
below therefore run the reference jitted, as the engine does."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.core import kv_cache as JKV  # noqa: E402
from repro.core import quantization as JQ  # noqa: E402
from repro.runtime import plan as JP  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.configs import registry as PR  # noqa: E402
from repro_torch.core import kv_cache as PKV  # noqa: E402
from repro_torch.core import quantization as PQ  # noqa: E402
from repro_torch.runtime import plan as PP  # noqa: E402


def _same(a, b):
    """Bitwise equality of a reference array and a port tensor."""
    a = np.asarray(a)
    b = CV.to_numpy(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.view(np.uint8).tobytes() == b.view(np.uint8).tobytes()


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen2-1.5b", "llama3-8b"])
@pytest.mark.parametrize("variant", ["", "@reduced", "@tiny"])
def test_config_equal_field_by_field(arch, variant):
    a = dataclasses.asdict(JR.get(arch + variant))
    b = dataclasses.asdict(PR.get(arch + variant))
    assert a == b
    assert JR.get(arch + variant).padded_vocab_size == PR.get(arch + variant).padded_vocab_size
    plan = lambda c: [([dataclasses.asdict(p) for p in pats], n)
                      for pats, n in c.layer_plan()]
    assert plan(JR.get(arch + variant)) == plan(PR.get(arch + variant))


def test_config_errors_match():
    for bad in ("qwen2-7b@tiny-moe", "qwen2-7b@huge", "nope"):
        with pytest.raises(KeyError):
            JR.get(bad)
        with pytest.raises(KeyError):
            PR.get(bad)


# ---------------------------------------------------------------------------
# weight quantization and packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("group_size", [0, 16])
def test_quantize_bitwise(bits, group_size):
    rng = np.random.default_rng(bits + group_size)
    w = (rng.normal(size=(2, 64, 48)) * 0.02).astype(np.float32)
    w[0, :, 3] = 0.125                               # a constant column: scale 1
    a = JQ.quantize(jnp.asarray(w), bits, group_size=group_size)
    b = PQ.quantize(torch.from_numpy(w), bits, group_size=group_size)
    _same(a.data, b.data)
    _same(a.scale, b.scale)
    _same(a.zero, b.zero)
    assert tuple(a.shape) == tuple(b.shape)
    _same(JQ.dequantize(a), PQ.dequantize(b))


def test_pack_unpack_int4_bitwise():
    rng = np.random.default_rng(0)
    q = rng.integers(0, 16, size=(5, 32)).astype(np.int32)
    a = JQ.pack_int4(jnp.asarray(q))
    b = PQ.pack_int4(torch.from_numpy(q))
    _same(a, b)
    # low nibble is column 2j, high nibble column 2j+1
    assert int(b[0, 0].view(torch.uint8)) == q[0, 0] | (q[0, 1] << 4)
    _same(JQ.unpack_int4(a), PQ.unpack_int4(b))
    assert np.array_equal(PQ.unpack_int4(b).numpy(), q)


def _tie_rows(dtype):
    """Rows whose quantization hits exact .5 ties: amax = 127 * 2^-4, and
    entries at (k + 0.5) * 2^-4."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(16, 64)) * 3).astype(np.float32)
    x[:4] = (rng.integers(-120, 120, size=(4, 64)) + 0.5) / 16.0
    x[:4, 0] = 127 / 16.0
    x[4] = 0.0                                         # all-zero row: scale 1
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activations_bitwise_with_ties(dtype):
    x = _tie_rows(np.float32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xp = torch.from_numpy(x).to(getattr(torch, dtype))
    qa, sa = jax.jit(JQ.quantize_activations)(xj)
    qb, sb = PQ.quantize_activations(xp)
    _same(qa, qb)
    _same(sa, sb)
    # round half to even on both sides: the tie rows land on even codes
    xq = qb[:4].float()
    frac = (xp[:4].float() / sb[:4]) % 1
    assert ((xq[frac == 0.5] % 2) == 0).all()


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_keys_bitwise(bits, dtype):
    rng = np.random.default_rng(bits)
    k = (rng.normal(size=(3, 7, 4, 64))).astype(np.float32)
    k[0, 0, 0] = 0.75                                  # constant head: scale 1
    k[1, :, 1, :8] = (rng.integers(-60, 60, size=(7, 8)) + 0.5) / 32.0
    kj = jnp.asarray(k, getattr(jnp, dtype))
    kp = torch.from_numpy(k).to(getattr(torch, dtype))
    a = jax.jit(lambda x: JKV.quantize_keys(x, bits=bits))(kj)
    b = PKV.quantize_keys(kp, bits=bits)
    for x, y in zip(a, b):
        _same(x, y)
    da = jax.jit(lambda *t: JKV.dequantize_keys(*t, bits=bits))(*a)
    _same(da, PKV.dequantize_keys(*b, bits=bits))


def test_fp8_casts_bitwise():
    rng = np.random.default_rng(5)
    v = np.concatenate([rng.normal(size=500) * 50, [448.0, 449.0, 1e4, -1e4, 0.0,
                                                    -0.0, 1e-9]]).astype(np.float32)
    a = JKV.cast_values(jnp.asarray(v, jnp.bfloat16), JQ.FP8_DTYPE)
    b = PKV.cast_values(torch.from_numpy(v).bfloat16(), PQ.FP8_DTYPE)
    _same(a, b)
    assert torch.isfinite(b.float()).all()            # saturates, never NaN
    _same(JQ.from_fp8(a), PQ.from_fp8(b))


@pytest.mark.parametrize("bits", [4, 8])
def test_quant_matmul_integer_path(bits):
    """The int32 dot is exact on both sides; the float epilogue runs the same
    operations in the same order."""
    rng = np.random.default_rng(bits)
    w = (rng.normal(size=(96, 64)) * 0.02).astype(np.float32)
    x = rng.normal(size=(2, 3, 96)).astype(np.float32)
    cfg = JQ.QuantConfig()
    qa = JQ.quantize(jnp.asarray(w), bits)
    qb = PQ.quantize(torch.from_numpy(w), bits)
    xj = jnp.asarray(x, jnp.bfloat16)
    xp = torch.from_numpy(x).bfloat16()
    xq, _ = PQ.quantize_activations(xp)
    wq = PQ.unpack_int4(qb.data) if bits == 4 else qb.data
    acc_a = JQ._int_matmul(jax.jit(JQ.quantize_activations)(xj)[0], JQ.unpack_int4(qa.data)
                           if bits == 4 else qa.data)
    _same(acc_a, PQ.int_dot(xq, wq))
    ya = jax.jit(lambda a: JQ.quant_matmul(a, qa, cfg))(xj)
    yb = PQ.quant_matmul(xp, qb, PQ.QuantConfig())
    _same(ya, yb)


# ---------------------------------------------------------------------------
# the load-time plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,bits", [((200, 300), 4), ((128, 256), 4),
                                        ((3, 130, 40), 8)])
def test_pack_linear_layout(shape, bits):
    rng = np.random.default_rng(len(shape))
    w = (rng.normal(size=shape) * 0.02).astype(np.float32)
    a = JP.pack_linear(JQ.quantize(jnp.asarray(w), bits))
    b = PP.pack_linear(PQ.quantize(torch.from_numpy(w), bits))
    for f in ("data", "scale", "zero"):
        _same(getattr(a, f), getattr(b, f))
    assert (a.k, a.n, a.kp, a.np_pad) == (b.k, b.n, b.kp, b.np_pad)
    ua, ub = JP.unpack_linear(a), PP.unpack_linear(b)
    _same(ua.data, ub.data)
    assert tuple(ua.shape) == tuple(ub.shape)


@pytest.mark.parametrize("max_seq", [16, 64, 100, 256, 2048, 4096])
def test_geometry_matches(max_seq):
    assert JP.kv_page_size(max_seq) == PP.kv_page_size(max_seq)
    for slots in (1, 3, 4, 8):
        assert JP.decode_buckets(slots) == PP.decode_buckets(slots)
    for arch in ("qwen2-7b", "qwen2-7b@reduced", "llama3-8b@tiny"):
        cj, cp = JR.get(arch), PR.get(arch)
        ps = JP.kv_page_size(max_seq)
        assert JP.kv_page_bytes(cj, ps) == PP.kv_page_bytes(cp, ps)
        for chunk in (7, 16, 64, 130):
            assert (JP.prefill_chunk_schedule(cj, chunk, ps)
                    == PP.prefill_chunk_schedule(cp, chunk, ps))
        plan_j = JP.ExecutionPlan(quant_tag="", matmuls={}, placement={}, params=None)
        plan_p = PP.ExecutionPlan(quant_tag="", params=None)
        for budget in (None, 10 ** 5, 10 ** 7):
            gj = plan_j.kv_pool_geometry(cj, max_seq, 4, dram_budget_bytes=budget)
            gp = plan_p.kv_pool_geometry(cp, max_seq, 4, dram_budget_bytes=budget)
            assert dataclasses.asdict(gj) == dataclasses.asdict(gp)
            assert gj.trash_page == gp.trash_page
            sj = plan_j.kv_spill_policy(cj, gj, 4)
            sp = plan_p.kv_spill_policy(cp, gp, 4)
            assert dataclasses.asdict(sj) == dataclasses.asdict(sp)


# ---------------------------------------------------------------------------
# conversion of the reference's parameters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_engine(tmp_path_factory):
    cfg = JR.get("qwen2-7b@reduced")
    return JE.build_engine(cfg, max_seq=64,
                           flash_dir=str(tmp_path_factory.mktemp("flash_ref")))


def _pairs(ref, port, path=""):
    if isinstance(ref, dict):
        assert set(ref) == set(port), path
        for k in ref:
            yield from _pairs(ref[k], port[k], f"{path}/{k}")
    elif isinstance(ref, (tuple, list)):
        assert len(ref) == len(port), path
        for i, (r, p) in enumerate(zip(ref, port)):
            yield from _pairs(r, p, f"{path}/{i}")
    elif hasattr(ref, "bits"):
        assert (ref.bits, ref.k, ref.n) == (port.bits, port.k, port.n), path
        for f in ("data", "scale", "zero"):
            yield f"{path}.{f}", getattr(ref, f), getattr(port, f)
    else:
        yield path, ref, port


def test_convert_params_exact_and_round_trips(ref_engine):
    port = CV.params_from_reference(ref_engine.params)
    n = 0
    for path, r, p in _pairs(ref_engine.params, port):
        r = np.asarray(r)
        assert CV.to_numpy(p).tobytes() == r.tobytes(), path
        assert str(p.dtype).split(".")[-1] == r.dtype.name, path
        n += 1
    assert n >= 20
    back = CV.params_to_numpy(port)
    assert back["final_norm"].tobytes() == np.asarray(ref_engine.params["final_norm"]).tobytes()
    lm = ref_engine.params["lm_head"]["w"]
    assert back["lm_head"]["w"]["data"].tobytes() == np.asarray(lm.data).tobytes()
    # a second conversion of the numpy round trip gives the same tensors
    again = CV.to_tensor(back["stacks"][0][0]["attn"]["bq"]).view(torch.bfloat16)
    assert torch.equal(again, port["stacks"][0][0]["attn"]["bq"])


def test_convert_embedding_rows_match(ref_engine, tmp_path):
    table = ref_engine.embedding.flash._maps[ref_engine.embedding.name]
    store = CV.embedding_from_reference(table, str(tmp_path))
    ids = np.array([[0, 5, 511], [17, 17, 300]])
    _same(ref_engine.embed(ids), store.lookup(ids))
    assert store.dram_bytes_saved == table.shape[0] * table.shape[1] * 2
