"""Port vs reference: the simulated Flash and §4.1's per-layer KV spill
(``core/hybrid_storage.py``), the paper's placement (``placement_for``,
``plan_embedding_placement``, and the plan an engine builds), on the CPU.

* ``FlashStore``'s throttle: every read sleeps latency + bytes / bandwidth
  and charges it to ``read_time_s`` (a zero-byte read its latency, a
  zero-latency one nothing), each read kind counted as the reference's
  (sleeps of a few milliseconds); ``read_slice`` clamps as numpy slices do.
* ``KVSpillManager``: the same int8 / fp8-bit blocks spilled into the
  reference's manager and the port's give the same bytes back, the same
  hits and misses and the same empty arrays for a layer with nothing
  spilled; a load that fails reaches the consumer instead of hanging it
  (the reference's would wait forever, ROADMAP queue 3).
* ``chip_smoke.py``'s ``[kvflash]`` at qwen2-7b@reduced on the reference's
  weights: a decode step whose history comes back from a throttled Flash
  gives the unspilled step's logits bit for bit through kernel 6's plain
  version, and the reference's decode logits within one bf16 rounding."""
import functools
import importlib.util
import pathlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.core import hybrid_storage as JHS  # noqa: E402
from repro.runtime import plan as JP  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.configs import registry as PR  # noqa: E402
from repro_torch.core import hybrid_storage as HS  # noqa: E402
from repro_torch.core import kv_pool as KP  # noqa: E402
from repro_torch.runtime import plan as PP  # noqa: E402
from repro_torch.serving import engine as PE  # noqa: E402
from repro_torch.serving import scheduler as PSC  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
STRICT = {"xla_allow_excess_precision": False}


def _stores(tmp_path, **spec):
    return (JHS.FlashStore(str(tmp_path / "ref"), JHS.FlashSpec(**spec)),
            HS.FlashStore(str(tmp_path / "port"), HS.FlashSpec(**spec)))


# ---------------------------------------------------------------------------
# the throttle
# ---------------------------------------------------------------------------

def test_flash_spec_defaults_match():
    j, p = JHS.FlashSpec(), HS.FlashSpec()
    assert (j.bandwidth_bytes_per_s, j.latency_s, j.simulate) == \
        (p.bandwidth_bytes_per_s, p.latency_s, p.simulate) == (1e9, 15e-6, True)
    assert HS.FlashStore.__init__.__defaults__ == (None,)


@pytest.mark.parametrize("spec", [
    dict(bandwidth_bytes_per_s=1e9, latency_s=0.0),      # bandwidth only
    dict(bandwidth_bytes_per_s=1e9, latency_s=0.002),    # a zero-byte read pays 2 ms
    dict(bandwidth_bytes_per_s=1e10, latency_s=15e-6),   # the paper's latency
    dict(simulate=False)])
def test_throttle_accounting_matches_reference(tmp_path, spec):
    """read_rows, read_slice (empty too), read_all and read_view charge
    the reference's seconds and count its bytes, read for read."""
    table = np.arange(256 * 1024, dtype=np.float32).reshape(1024, 256)    # 1 MiB
    res = []
    for fs in _stores(tmp_path, **spec):
        fs.put("t", table)
        got = [fs.read_rows("t", np.asarray([3, 7, 3])), fs.read_slice("t", 5, 5),
               fs.read_slice("t", 0, 1024), fs.read_all("t"), np.asarray(fs.read_view("t"))]
        res.append((got, fs.bytes_read, fs.read_time_s))
    (gj, bj, tj), (gp, bp, tp) = res
    for a, b in zip(gj, gp):
        np.testing.assert_array_equal(a, b)
    assert bj == bp == (3 * 256 + 0 + 3 * 1024 * 256) * 4
    assert tp == tj
    if spec.get("simulate", True):
        bw, lat = spec["bandwidth_bytes_per_s"], spec["latency_s"]
        assert tp == pytest.approx(5 * lat + bp / bw, rel=1e-12)
    else:
        assert tp == 0.0


def test_zero_byte_read_charges_latency_only(tmp_path):
    for fs in _stores(tmp_path, bandwidth_bytes_per_s=1e9, latency_s=0.01):
        fs.put("x", np.arange(16, dtype=np.float32).reshape(4, 4))
        out = fs.read_slice("x", 2, 2)
        assert out.shape == (0, 4) and out.nbytes == 0 and fs.bytes_read == 0
        assert 0.01 <= fs.read_time_s < 0.02
    for fs in _stores(tmp_path / "free", bandwidth_bytes_per_s=1e9, latency_s=0.0):
        fs.put("x", np.zeros((8, 2), np.float32))
        fs.read_slice("x", 5, 5)
        assert fs.read_time_s == 0.0 and fs.bytes_read == 0


def test_read_slice_bounds_match_reference(tmp_path):
    table = np.arange(40, dtype=np.int32).reshape(10, 4)
    for fs in _stores(tmp_path, simulate=False):
        fs.put("t", table)
        for start, stop in ((3, 7), (8, 100), (0, 10), (-3, 10), (7, 3)):
            np.testing.assert_array_equal(fs.read_slice("t", start, stop), table[start:stop])
        assert fs.bytes_read == (4 + 2 + 10 + 3 + 0) * 4 * 4


def test_blob_reads_are_throttled(tmp_path):
    """The port's own blob read (weight groups) pays one read's latency and
    its bytes, as every other read does."""
    fs = HS.FlashStore(str(tmp_path), HS.FlashSpec(bandwidth_bytes_per_s=1e9,
                                                   latency_s=0.001))
    arrays = [np.arange(1000, dtype=np.uint8), np.arange(3000, dtype=np.uint8)]
    fs.write_blob("b", arrays).result()
    outs = [np.empty_like(a) for a in arrays]
    fs.read_blob_into("b", outs)
    for a, b in zip(arrays, outs):
        np.testing.assert_array_equal(a, b)
    assert fs.bytes_read == 4000 and fs.read_time_s == 0.001 + 4000 / 1e9


# ---------------------------------------------------------------------------
# KVSpillManager
# ---------------------------------------------------------------------------

def _blocks(rng, n, B=2, block=4, H=2, D=8):
    k = [rng.integers(-128, 128, (B, block, H, D)).astype(np.int8) for _ in range(n)]
    v8 = torch.from_numpy(rng.normal(size=(n, B, block, H, D)).astype(np.float32) * 300)
    v = list(v8.to(torch.float8_e4m3fn).view(torch.uint8).numpy())
    return k, v


@pytest.mark.parametrize("simulate", [False, True])
def test_kv_spill_manager_matches_reference(tmp_path, simulate):
    rng = np.random.default_rng(int(simulate))
    ks, vs = _blocks(rng, 3)
    spec = dict(bandwidth_bytes_per_s=1e9, latency_s=1e-4, simulate=simulate)
    seen = []
    for hs, fs in zip((JHS, HS), _stores(tmp_path, **spec)):
        mgr = hs.KVSpillManager(fs, num_layers=3, kv_heads=2, head_dim=8,
                                dram_budget_tokens=8, block_tokens=4)
        try:
            for i, (k, v) in enumerate(zip(ks, vs)):
                mgr.spill(0, k, v, start=4 * i)
            mgr.spill(1, ks[0], vs[0].view(np.int8), start=0)      # values cast to uint8
            log = [mgr.spilled_tokens(layer) for layer in range(3)]
            mgr.prefetch_async(0)
            a = mgr.gather(0)                                       # a hit
            b = mgr.gather(0)                                       # a miss, same bytes
            mgr.prefetch_async(4)                                   # layer 4 % 3 = 1
            c = mgr.gather(1)
            empty = mgr.gather(2)                                   # nothing spilled: a miss
            mgr.prefetch_async(2)                                   # never enqueued
            mgr.spill(0, ks[1], vs[1], start=12)                    # stales layer 0
            d = mgr.gather(0)
            log += [mgr.prefetch_hits, mgr.prefetch_misses, mgr.hit_rate, fs.bytes_read]
            seen.append(([a, b, c, empty, d], log, fs.read_time_s))
        finally:
            mgr.close()
    (j, jlog, jt), (p, plog, pt) = seen
    assert jlog == plog and plog[3:5] == [2, 3]
    for x, y in zip(j, p):
        for xa, ya in zip(x, y):
            assert xa.dtype == ya.dtype and xa.shape == ya.shape
            assert xa.tobytes() == ya.tobytes()
    assert p[0][0].shape == (2, 12, 2, 8) and p[0][1].dtype == np.uint8
    assert p[3][0].shape == (0,) and p[3][0].dtype == np.int8
    assert pt == pytest.approx(jt, rel=1e-12) and (pt > 0) == simulate


def test_kv_spill_load_failure_reaches_the_consumer(tmp_path):
    """A block whose file went missing: the prefetched gather raises in the
    consumer's thread (bounded here by a join timeout) and the manager
    still deletes what is left."""
    fs = HS.FlashStore(str(tmp_path), HS.FlashSpec(simulate=False))
    mgr = HS.KVSpillManager(fs, 2, 2, 8, dram_budget_tokens=4, block_tokens=4)
    ks, vs = _blocks(np.random.default_rng(3), 2)
    mgr.spill(0, ks[0], vs[0], 0)
    mgr.spill(0, ks[1], vs[1], 4)
    fs.delete(mgr._name(0, 4) + "_v")
    mgr.prefetch_async(0)
    caught = []

    def consume():
        try:
            mgr.gather(0)
        except KeyError as e:
            caught.append(e)
    t = threading.Thread(target=consume)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and len(caught) == 1
    mgr.drop_all()
    assert sorted(p.name for p in tmp_path.iterdir()) == []


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

ARCH_VARIANTS = [a + v for a in sorted(JR.ARCHS) for v in ("", "@reduced", "@tiny")]


@pytest.mark.parametrize("arch", ARCH_VARIANTS)
def test_placement_for_matches_reference(arch):
    jc, pc = JR.get(arch), PR.get(arch)
    sizes = pc.param_count()
    for budget in (None, 0, sizes["embedding"] * 2, 10 ** 15):
        assert PP.placement_for(pc, budget) == JP.placement_for(jc, budget)
    assert PP.placement_for(pc)["embedding"] == "flash"


def test_plan_embedding_placement_matches_reference():
    sizes = {"embedding": 100, "layers": 400, "lm_head": 100, "x_embedding": 50}
    for budget in (0, 99, 100, 500, 520, 550, 650, 1000):
        assert HS.plan_embedding_placement(sizes, budget) == \
            JHS.plan_embedding_placement(sizes, budget)
    assert list(HS.plan_embedding_placement(sizes, 520)) == \
        list(JHS.plan_embedding_placement(sizes, 520))


@pytest.mark.parametrize("budget", [None, 900_000])
def test_engine_plan_placement_matches_reference(tmp_path, budget):
    """The plan of an engine starts from ``placement_for`` (the embedding on
    Flash, layers and lm_head in DRAM) and merges the weight-stream entries
    in, key for key as the reference's ``build_engine``."""
    arch = "qwen2-7b@tiny"
    je = JE.build_engine(JR.get(arch), max_seq=32, flash_dir=str(tmp_path / "ref"),
                         weight_dram_budget_bytes=budget)
    pe = PE.build_engine(PR.get(arch), max_seq=32, device="cpu",
                         flash_dir=str(tmp_path / "port"), weight_dram_budget_bytes=budget)
    try:
        assert pe.plan.placement == je.plan.placement
        assert pe.plan.placement["embedding"] == "flash"
        assert ("stream" in pe.plan.placement.values()) == (budget is not None)
    finally:
        pe.close()
        if je.weight_store is not None:
            je.weight_store.close()


# ---------------------------------------------------------------------------
# the scheduler's running set and the pool's device table
# ---------------------------------------------------------------------------

def test_scheduler_active_and_device_table():
    geom = KP.PoolGeometry(page_size=4, num_pages=8, pages_per_row=4)
    pool = KP.KVPoolManager(geom, num_slots=3)
    s = PSC.ContinuousScheduler(3, 16, pool)
    reqs = [PSC.Request(uid=u, prompt_tokens=[1, 2, 3], max_new_tokens=2) for u in range(3)]
    for r in reqs:
        s.submit(r)
    admitted = s.admit()
    assert [r.uid for r in s.active] == [r.uid for _slot, r in admitted] == [0, 1, 2]
    for slot, r in admitted:
        assert pool.alloc_row(slot, len(r.context_tokens))
    s.finish(reqs[1])
    assert [r.uid for r in s.active] == [0, 2]
    t = pool.device_table()
    assert t.dtype == torch.int32 and t.device.type == "cpu"
    assert t.tolist() == pool.table.tolist()
    pool.free_row(0)
    assert t.tolist() != pool.table.tolist()                  # a copy, not a view


# ---------------------------------------------------------------------------
# [kvflash] at qwen2-7b@reduced
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_spilled_decode_equals_unspilled_and_reference(tmp_path):
    """96 prompt tokens, the last 32 of each layer kept, 64 spilled in 4
    blocks of 16 to a throttled Flash; 2 steps each way."""
    C = _chip_smoke()
    arch, ctx, block = "qwen2-7b@reduced", 96, 16
    orig = jax.jit
    jax.jit = functools.partial(orig, compiler_options=STRICT)
    try:
        je = JE.build_engine(JR.get(arch), max_seq=ctx + block,
                             flash_dir=str(tmp_path / "ref"))
    finally:
        jax.jit = orig
    emb = CV.embedding_from_reference(je.embedding.flash._maps[je.embedding.name],
                                      str(tmp_path / "port"))
    pe = PE.build_engine(PR.get(arch), max_seq=ctx + block, device="cpu",
                         params=CV.params_from_reference(je.params), embedding=emb)
    root = tmp_path / "kvflash"
    root.mkdir()
    r = C.kvflash_context(pe, ctx, str(root), C.KVFLASH_SPEC, steps=2, dram_tokens=32,
                          block=block)
    cfg = pe.cfg
    per_layer = 64 * cfg.num_kv_heads * cfg.resolved_head_dim * 2
    assert r["spilled_tokens_a_layer"] == 64 and r["spilled_bytes_a_layer"] == per_layer
    assert r["runs"]["no_prefetch"]["bytes_read"] == cfg.num_layers * per_layer
    assert r["runs"]["no_prefetch"]["read_time_s"] == pytest.approx(
        cfg.num_layers * (8 * 15e-6 + per_layer / 1e9), rel=1e-9)
    assert r["runs"]["prefetch"]["hits"] == 2 * cfg.num_layers
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size, ctx)
    _, cache = je._prefill(je.params, je.embed(prompt[None]), max_seq=ctx + block)
    want, _ = je._decode(je.params, je.embed(np.asarray([[r["next_token"]]])), cache)
    np.testing.assert_allclose(np.asarray(want, np.float32)[:, :cfg.vocab_size],
                               r["logits"].float().numpy()[:, :cfg.vocab_size],
                               rtol=1e-2, atol=1e-2)


class _CoarseClock:
    """A host whose every sleep lasts at least one 1-ms tick."""

    def __init__(self):
        self.now, self.sleeps = 0.0, 0

    def perf_counter(self):
        return self.now

    def sleep(self, s):
        self.sleeps += 1
        self.now += max(s, 1e-3)


def test_throttle_waits_what_it_charges_on_a_coarse_clock(tmp_path, monkeypatch):
    """1,000 reads of 1 KiB at the paper's Flash charge 16 ms; on a host
    whose sleeps last a 1-ms tick a sleep a read (the reference's) would
    wait 1 s, the port's debt-and-credit throttle waits the 16 ms charged,
    to within one tick."""
    clock = _CoarseClock()
    monkeypatch.setattr(HS, "time", clock)
    fs = HS.FlashStore(str(tmp_path), HS.FlashSpec())
    fs.put("t", np.zeros((1000, 256), np.float32))
    for i in range(1000):
        fs.read_slice("t", i, i + 1)
    charged = 1000 * (15e-6 + 1024 / 1e9)
    assert fs.read_time_s == pytest.approx(charged, rel=1e-12)
    assert charged <= clock.now <= charged + 1e-3
    assert clock.sleeps <= charged / 1e-3 + 1
