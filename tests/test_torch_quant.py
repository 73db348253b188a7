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
from _torch_threads import one_intra_op_thread  # noqa: E402,F401
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
    assert a.dtype.itemsize == b.dtype.itemsize and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen2-1.5b", "llama3-8b",
                                  "moonshot-v1-16b-a3b", "dbrx-132b"])
@pytest.mark.parametrize("variant", ["", "@reduced", "@tiny", "@tiny-moe"])
def test_config_equal_field_by_field(arch, variant):
    if variant == "@tiny-moe" and not JR.get(arch).num_experts:
        for get in (JR.get, PR.get):        # dense models have no MoE variant
            with pytest.raises(KeyError):
                get(arch + variant)
        return
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


@pytest.mark.parametrize("bits", [4, 8])
def test_pack_expert_linear_and_take_experts_bitwise(bits):
    """moonshot's per-expert N = 1408 pads to 1536 (its down projection's
    K = 1408 to 1536 as well); pack, unpack and the selected-expert gather
    are bit for bit the reference's."""
    rng = np.random.default_rng(bits)
    w = (rng.normal(size=(5, 72, 1408 // 8)) * 0.02).astype(np.float32)
    a = JP.pack_expert_linear(JQ.quantize(jnp.asarray(w), bits))
    b = PP.pack_expert_linear(PQ.quantize(torch.from_numpy(w), bits))
    assert isinstance(b, PP.PackedExpertLinear) and b.experts == a.experts == 5
    for f in ("data", "scale", "zero"):
        _same(getattr(a, f), getattr(b, f))
    ua, ub = JP.unpack_expert_linear(a), PP.unpack_expert_linear(b)
    _same(ua.data, ub.data)
    _same(ua.scale, ub.scale)
    ids = np.asarray([4, 0, 4, 2], np.int32)
    ta, tb = JP.take_experts(a, jnp.asarray(ids)), PP.take_experts(b, torch.from_numpy(ids))
    for f in ("data", "scale", "zero"):
        _same(getattr(ta, f), getattr(tb, f))
    assert PP.pack_linear(PQ.quantize(torch.zeros((1408, 64)), 4)).kp == 1408
    assert PP.pack_linear(PQ.quantize(torch.zeros((64, 1408)), 4)).np_pad == 1536
    path = ["stacks", 0, "moe", "w_gate", "w"]
    assert PP.is_expert_path(path) and not PP.is_expert_path(["stacks", 0, "moe", "router"])
    leaves = jax.tree_util.tree_flatten_with_path({"moe": {"w_up": 1, "router": 2}})[0]
    assert [JP.is_expert_path(k) for k, _ in leaves] == [PP.is_expert_path(k)
                                                         for k, _ in leaves]


# ---------------------------------------------------------------------------
# the dense KV cache
# ---------------------------------------------------------------------------

def _append_both(pos, t, seed, per_row=False):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(3, t, 4, 64)).astype(np.float32)
    v = rng.normal(size=(3, t, 4, 64)).astype(np.float32)
    jc = JKV.init_layer_cache(3, 32, 4, 64, per_row=per_row)
    pc = PKV.init_layer_cache(3, 32, 4, 64, per_row=per_row)
    pj = jnp.asarray(pos, jnp.int32)
    jc = jax.jit(JKV.append)(jc, jnp.asarray(k, jnp.bfloat16),
                             jnp.asarray(v, jnp.bfloat16), pj)
    pc = PKV.append(pc, torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16(),
                    torch.tensor(pos, dtype=torch.int32))
    return jc, pc, pj


@pytest.mark.parametrize("pos,t", [(0, 7), (30, 5), ([0, 9, 31], 1), ([2, 3, 20], 4)])
def test_dense_cache_bytes_after_append(pos, t):
    """Scalar positions (slot-synchronous; a start past max_seq - t clamps,
    as dynamic_update_slice does) and per-row positions."""
    per_row = isinstance(pos, list)
    jc, pc, pj = _append_both(pos, t, seed=t, per_row=per_row)
    for f in ("k_q", "k_scale", "k_zero", "v", "length"):
        _same(getattr(jc, f), getattr(pc, f))
    assert pc.max_seq == jc.max_seq == 32
    _same(JKV.valid_mask(jc, pj), PKV.valid_mask(pc, torch.tensor(pos)))
    assert np.array_equal(np.asarray(JKV.slot_positions(jc, pj)),
                          PKV.slot_positions(pc, torch.tensor(pos)).numpy())
    # a stacked cache appends through its per-layer views
    st = PKV.init_layer_cache(3, 32, 4, 64, per_row=per_row, layers=2)
    k = torch.from_numpy(np.random.default_rng(t).normal(size=(3, t, 4, 64))
                         .astype(np.float32)).bfloat16()
    PKV.append(st.layer(1), k, k, torch.tensor(pos, dtype=torch.int32))
    assert st.k_q[0].abs().sum() == 0 and torch.equal(st.k_q[1], pc.k_q)


def test_roundtrip_kv_bitwise():
    rng = np.random.default_rng(0)
    k = rng.normal(size=(2, 9, 4, 64)).astype(np.float32)
    v = (rng.normal(size=(2, 9, 4, 64)) * 100).astype(np.float32)
    a = jax.jit(lambda x, y: JKV.roundtrip_kv(x, y, v_dtype=JQ.FP8_DTYPE))(
        jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16))
    b = PKV.roundtrip_kv(torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16(),
                         v_dtype=PQ.FP8_DTYPE)
    for x, y in zip(a, b):
        assert y.dtype == torch.bfloat16
        _same(x, y)


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


def test_convert_moe_params_exact():
    """Expert tables stay ``PackedExpertLinear`` and the bf16 router is
    carried bit for bit (moonshot-v1-16b-a3b@reduced, full parameter tree)."""
    from repro.models import transformer as JT
    cfg = JR.get("moonshot-v1-16b-a3b@reduced")
    ref = JT.init_params(cfg, key=jax.random.PRNGKey(0), quantized=True, pack=True)
    port = CV.params_from_reference(ref)
    moe = port["stacks"][0][0]["moe"]
    assert set(moe) == {"router", "w_gate", "w_up", "w_down"}
    for k in ("w_gate", "w_up", "w_down"):
        assert isinstance(moe[k]["w"], PP.PackedExpertLinear)
        assert moe[k]["w"].layer(1).experts == cfg.num_experts
    assert moe["router"].dtype == torch.bfloat16
    n = 0
    for path, r, p in _pairs(ref, port):
        assert CV.to_numpy(p).tobytes() == np.asarray(r).tobytes(), path
        n += 1
    assert n >= 25
