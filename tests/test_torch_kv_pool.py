"""The paged KV pool, port vs reference: the bytes a sequence of prompt-chunk
and decode appends leaves in the pool (bit for bit, trash page included),
attention read back through the page table, and the host allocator's state
over random walks of alloc / adopt / register / ensure / free."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import kv_pool as JKP  # noqa: E402
from repro.core.precision import DEFAULT_POLICY as JPOL  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.core import kv_pool as PKP  # noqa: E402
from repro_torch.core.precision import DEFAULT_POLICY as PPOL  # noqa: E402

GEOM = dict(page_size=8, num_pages=12, pages_per_row=4, staging_pages=2)
HKV, D = 2, 64


def _pools():
    jg, pg = JKP.PoolGeometry(**GEOM), PKP.PoolGeometry(**GEOM)
    jp = JKP.init_paged_layer(jg, HKV, D)
    pp = PKP.init_paged_layer(pg, HKV, D)
    return jg, jp, pp


def _assert_pool_bytes_equal(jp, pp):
    for f in ("k_q", "k_scale", "k_zero", "v"):
        a = np.asarray(getattr(jp, f))
        b = CV.to_numpy(getattr(pp, f))
        assert a.view(np.uint8).tobytes() == b.view(np.uint8).tobytes(), f


def _filled(seed=0):
    """Both pools after the same prompt chunks (one padded past the table,
    one past its row's pages) and decode appends (a masked row writes the
    trash page)."""
    rng = np.random.default_rng(seed)
    jg, jp, pp = _pools()
    table = np.full((3, GEOM["pages_per_row"]), jg.trash_page, np.int32)
    table[0, :3] = [4, 0, 7]
    table[1, :4] = [1, 2, 3, 5]
    chunks = [(0, 0, 8), (0, 8, 16), (1, 0, 16), (1, 16, 16), (0, 24, 8)]
    for row, pos0, C in chunks:
        k = rng.normal(size=(1, C, HKV, D)).astype(np.float32)
        v = (rng.normal(size=(1, C, HKV, D)) * 300).astype(np.float32)   # saturates
        kj, vj = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
        jp = jax.jit(JKP.append_paged_prompt)(jp, kj, vj, jnp.asarray(pos0, jnp.int32),
                                              table_row=jnp.asarray(table[row]))
        PKP.append_paged_prompt(pp, CV.to_tensor(kj), CV.to_tensor(vj), pos0,
                                torch.from_numpy(table[row].copy()))
    pos = np.asarray([24, 31, 5], np.int32)        # row 2 holds no pages: trash
    for step in range(3):
        k = rng.normal(size=(3, 1, HKV, D)).astype(np.float32)
        v = rng.normal(size=(3, 1, HKV, D)).astype(np.float32)
        kj, vj = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
        p = pos + np.asarray([step, 0, step], np.int32)
        jp = jax.jit(JKP.append_paged)(jp, kj, vj, jnp.asarray(p), jnp.asarray(table))
        PKP.append_paged(pp, CV.to_tensor(kj), CV.to_tensor(vj), torch.from_numpy(p),
                         torch.from_numpy(table))
    return jp, pp, table


def test_pool_shapes_and_trash_page_match():
    jg, jp, pp = _pools()
    assert jp.k_q.shape == tuple(pp.k_q.shape)
    assert jp.v.dtype.name == "float8_e4m3fn" and pp.v.dtype == torch.float8_e4m3fn
    _assert_pool_bytes_equal(jp, pp)
    assert PKP.PoolGeometry(**GEOM).trash_page == jg.trash_page == GEOM["num_pages"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_append_bytes_match_reference(seed):
    jp, pp, _ = _filled(seed)
    _assert_pool_bytes_equal(jp, pp)


def test_gathered_pages_match_reference():
    jp, pp, table = _filled(3)
    for a, b in zip(JKP.gather_pages(jp, jnp.asarray(table)),
                    PKP.gather_pages(pp, torch.from_numpy(table))):
        assert np.asarray(a).view(np.uint8).tobytes() == \
            CV.to_numpy(b).view(np.uint8).tobytes()


def test_paged_attention_refs_match_reference():
    jp, pp, table = _filled(4)
    rng = np.random.default_rng(9)
    q = (rng.normal(size=(3, 1, 4, D)) / 8).astype(np.float32)
    pos = np.asarray([27, 31, 3], np.int32)
    a = jax.jit(lambda x: JKP.paged_decode_attention_ref(
        x, jp, jnp.asarray(table), None, jnp.asarray(pos), JPOL))(jnp.asarray(q, jnp.bfloat16))
    b = PKP.paged_decode_attention_ref(torch.from_numpy(q).bfloat16(), pp,
                                       torch.from_numpy(table), None,
                                       torch.from_numpy(pos), PPOL)
    np.testing.assert_allclose(np.asarray(a, np.float32), b.float().numpy(),
                               rtol=1e-2, atol=1e-2)
    qc = (rng.normal(size=(1, 8, 4, D)) / 8).astype(np.float32)
    a = jax.jit(lambda x: JKP.paged_prefill_attention_ref(
        x, jp, jnp.asarray(table[1:2]), jnp.asarray(16, jnp.int32), JPOL))(
        jnp.asarray(qc, jnp.bfloat16))
    b = PKP.paged_prefill_attention_ref(torch.from_numpy(qc).bfloat16(), pp,
                                        torch.from_numpy(table[1:2].copy()), 16, PPOL)
    np.testing.assert_allclose(np.asarray(a, np.float32), b.float().numpy(),
                               rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# the host allocator
# ---------------------------------------------------------------------------

def _device_table(m):
    t = np.asarray(m.device_table())
    return str(t.dtype), t.tolist()


def _state(m):
    return {"free": list(m._free), "table": m.table.tolist(),
            "device_table": _device_table(m),
            "row_pages": [list(r) for r in m.row_pages],
            "refcount": m.refcount.tolist(), "row_shared": m.row_shared.tolist(),
            "index": sorted((p, k) for p, k in m._chain_of_page.items()),
            "order": list(m._index_order),
            "stats": (m.prefix_hits, m.prefix_misses, m.prefix_evictions,
                      m.alloc_failures),
            "avail": (m.free_pages, m.reclaimable_pages, m.available_pages,
                      m.pages_in_use)}


@pytest.mark.parametrize("seed", range(8))
def test_allocator_random_walk_matches_reference(seed):
    """The same random sequence of allocator operations (with real prefix
    collisions) leaves both managers in the same state after every step,
    and every call returns the same answer."""
    rng = np.random.default_rng(seed)
    geom = dict(page_size=4, num_pages=12, pages_per_row=6)
    jm = JKP.KVPoolManager(JKP.PoolGeometry(**geom), num_slots=4)
    pm = PKP.KVPoolManager(PKP.PoolGeometry(**geom), num_slots=4)
    vocab = [[int(t) for t in rng.integers(1, 50, int(rng.integers(1, 20)))]
             for _ in range(3)]
    prompts = {}
    for _ in range(150):
        op, row = int(rng.integers(0, 5)), int(rng.integers(0, 4))
        if op == 0 and not jm.row_pages[row]:
            toks = vocab[int(rng.integers(0, len(vocab)))]
            assert jm.probe_admission_discount(toks) == pm.probe_admission_discount(toks)
            ok = jm.alloc_row(row, len(toks), token_ids=toks)
            assert pm.alloc_row(row, len(toks), token_ids=toks) == ok
            if ok:
                prompts[row] = toks
                jm.row_pos[row] = pm.row_pos[row] = len(toks)
        elif op == 1 and jm.row_pages[row]:
            assert jm.register_prefix(row, prompts[row]) == \
                pm.register_prefix(row, prompts[row])
        elif op == 2 and 0 < len(jm.row_pages[row]) < geom["pages_per_row"]:
            at = len(jm.row_pages[row]) * geom["page_size"]
            assert jm.ensure(row, at) == pm.ensure(row, at)
            jm.row_pos[row] = pm.row_pos[row] = at
        elif op == 3 and jm.row_pages[row]:
            assert jm.free_row(row) == pm.free_row(row)
            prompts.pop(row, None)
        elif op == 4 and jm.row_pages[row]:
            assert jm.cold_pages(row) == pm.cold_pages(row)
        assert _state(jm) == _state(pm)


def test_geometry_dataclass_matches():
    for kw in (GEOM, dict(page_size=128, num_pages=64, pages_per_row=16,
                          staging_pages=14)):
        jg, pg = JKP.PoolGeometry(**kw), PKP.PoolGeometry(**kw)
        assert dataclasses.asdict(jg) == dataclasses.asdict(pg)
        assert (jg.trash_page, jg.total_device_pages, jg.max_seq, jg.pages_for(33)) == \
            (pg.trash_page, pg.total_device_pages, pg.max_seq, pg.pages_for(33))
