"""Geometry compute (C6) and tile selection (C3) in the port, held to the
JAX package.

Geometry mirrors ``tests/test_geometry.py``: every builder's Regions and
every fused ``Plan`` equal the reference's field for field (sizes, offsets,
strides, stage count, ``memory_ops``), and ``execute_plan`` on a torch
tensor equals the reference's on the same numpy input bit for bit.  Tiling:
the paper's Table 2, the Eq. 3 register constraint, the reorder shapes and
the Eq. 2 formula against the reference, and ``kernel_tiles`` equal to the
W4A8 wrapper's own choice of tile and split count."""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
from _torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from repro.core import geometry as JG  # noqa: E402
from repro.core import tiling as JT  # noqa: E402
from repro_torch.core import geometry as g  # noqa: E402
from repro_torch.core import tiling as T  # noqa: E402
from repro_torch.kernels import w4a8_matmul as WM  # noqa: E402


def _fields(regions):
    """Regions (or a list of Region lists) as plain tuples of ints."""
    if isinstance(regions, (list, tuple)):
        return [_fields(r) for r in regions]
    return tuple(tuple(int(v) for v in f) if isinstance(f, tuple) else int(f)
                 for f in dataclasses.astuple(regions))


def _same_plan(plan, jplan):
    assert plan.num_stages == jplan.num_stages
    assert plan.memory_ops == jplan.memory_ops
    assert [(_fields(r), n) for r, n in plan.stages] == \
        [(_fields(r), n) for r, n in jplan.stages]


def _run_both(plan, jplan, x: np.ndarray) -> np.ndarray:
    """The port's plan on a torch tensor, checked bit for bit against the
    reference's on the same input."""
    got = g.execute_plan(plan, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JG.execute_plan(jplan, jnp.asarray(x))))
    return got


@pytest.mark.parametrize("build,args", [
    ("region_identity", ((4, 6),)),
    ("region_identity", ((2, 3, 4, 5),)),
    ("region_transpose", ((4, 6), (1, 0))),
    ("region_transpose", ((3, 4, 5), (2, 0, 1))),
    ("region_slice", ((8, 5), (2, 1), (3, 4))),
    ("region_slice", ((6, 7, 8), (1, 2, 3), (2, 3, 4))),
    ("region_concat", ([(2, 3), (3, 3)], 0)),
    ("region_concat", ([(2, 3, 4), (2, 1, 4), (2, 2, 4)], 1)),
    ("region_gather_rows", ((10, 4), [2, 3, 4, 8])),
    ("region_gather_rows", ((12, 3), [0, 5, 6, 7, 1, 11])),
])
def test_builders_equal_reference(build, args):
    assert _fields(getattr(g, build)(*args)) == _fields(getattr(JG, build)(*args))


def test_transpose_region():
    x = np.arange(24).reshape(4, 6)
    regs = g.region_transpose((4, 6), (1, 0))
    out = g.execute_regions(regs, torch.from_numpy(x), 24).reshape(6, 4)
    np.testing.assert_array_equal(out.numpy(), x.T)


def test_slice_region():
    x = np.arange(40).reshape(8, 5)
    regs = g.region_slice((8, 5), (2, 1), (3, 4))
    out = g.execute_regions(regs, torch.from_numpy(x), 12).reshape(3, 4)
    np.testing.assert_array_equal(out.numpy(), x[2:5, 1:5])


def test_concat_regions():
    a = np.arange(6).reshape(2, 3)
    b = np.arange(9).reshape(3, 3) + 100
    reg_lists = g.region_concat([(2, 3), (3, 3)], axis=0)
    out = torch.zeros(15, dtype=torch.int64)
    for regs, src in zip(reg_lists, (a, b)):
        for r in regs:
            out[torch.from_numpy(r.dst_indices())] = \
                torch.from_numpy(src).reshape(-1)[torch.from_numpy(r.src_indices())]
    np.testing.assert_array_equal(out.reshape(5, 3).numpy(), np.concatenate([a, b], 0))


def test_fusion_transpose_then_slice():
    x = np.arange(24).reshape(4, 6)
    chain = ([g.region_transpose((4, 6), (1, 0)), g.region_slice((6, 4), (1, 0), (2, 4))],
             [JG.region_transpose((4, 6), (1, 0)), JG.region_slice((6, 4), (1, 0), (2, 4))])
    plan, jplan = g.fuse_chain(chain[0], [24, 8]), JG.fuse_chain(chain[1], [24, 8])
    assert plan.num_stages == 1                 # fused into one pass
    _same_plan(plan, jplan)
    np.testing.assert_array_equal(_run_both(plan, jplan, x).reshape(2, 4), x.T[1:3])


def test_fusion_reduces_memory_ops():
    chain = [g.region_transpose((8, 8), (1, 0)), g.region_transpose((8, 8), (1, 0))]
    fused = g.fuse_chain(chain, [64, 64])
    unfused_ops = sum(2 * r.numel for step in chain for r in step)
    assert fused.memory_ops == unfused_ops // 2  # one pass instead of two
    _same_plan(fused, JG.fuse_chain([JG.region_transpose((8, 8), (1, 0))] * 2, [64, 64]))


def test_fan_in_concat_then_transpose():
    """Two writers (a concat along the minor axis) fused through one reader
    (a transpose): each writer lands on whole output rows, so both fuse."""
    a = np.arange(6).reshape(3, 2)
    b = np.arange(6).reshape(3, 2) + 100
    x = np.concatenate([a.reshape(-1), b.reshape(-1)])

    def chain(mod):
        # each writer's Regions read its own part of the flat source buffer
        ws = [dataclasses.replace(r, src_offset=r.src_offset + off)
              for regs, off in zip(mod.region_concat([(3, 2), (3, 2)], 1), (0, 6))
              for r in regs]
        return [ws, mod.region_transpose((3, 4), (1, 0))]
    plan, jplan = g.fuse_chain(chain(g), [12, 12]), JG.fuse_chain(chain(JG), [12, 12])
    assert plan.num_stages == 1 and len(plan.stages[0][0]) == 2
    _same_plan(plan, jplan)
    np.testing.assert_array_equal(_run_both(plan, jplan, x).reshape(4, 3),
                                  np.concatenate([a, b], 1).T)


def test_unfusable_chain_stays_staged():
    """A slice that reads past what the first step wrote keeps two stages,
    as in the reference."""
    chain = [g.region_slice((6, 6), (0, 0), (3, 6)), g.region_transpose((6, 3), (1, 0))]
    jchain = [JG.region_slice((6, 6), (0, 0), (3, 6)), JG.region_transpose((6, 3), (1, 0))]
    plan, jplan = g.fuse_chain(chain, [18, 18]), JG.fuse_chain(jchain, [18, 18])
    _same_plan(plan, jplan)
    _run_both(plan, jplan, np.arange(36).reshape(6, 6))


@settings(max_examples=8, deadline=None)
@given(st.integers(2, 6), st.integers(2, 6), st.integers(2, 6),
       st.permutations([0, 1, 2]), st.permutations([0, 1, 2]))
def test_fused_double_transpose_matches_composed(a, b, c, p1, p2):
    x = np.arange(a * b * c).reshape(a, b, c)
    mid_shape = tuple(np.array((a, b, c))[list(p1)])
    steps = lambda mod: [mod.region_transpose((a, b, c), tuple(p1)),  # noqa: E731
                         mod.region_transpose(mid_shape, tuple(p2))]
    plan = g.fuse_chain(steps(g), [a * b * c] * 2)
    jplan = JG.fuse_chain(steps(JG), [a * b * c] * 2)
    assert plan.num_stages == 1
    _same_plan(plan, jplan)
    want = x.transpose(p1).transpose(p2)
    np.testing.assert_array_equal(_run_both(plan, jplan, x).reshape(want.shape), want)


@settings(max_examples=8, deadline=None)
@given(st.data())
def test_fused_slice_chain_matches_composed(data):
    n0, m0 = 8, 8
    x = np.arange(n0 * m0, dtype=np.float32).reshape(n0, m0)
    s0 = data.draw(st.integers(0, 3)), data.draw(st.integers(0, 3))
    sz = data.draw(st.integers(2, n0 - 3)), data.draw(st.integers(2, m0 - 3))
    perm = data.draw(st.permutations([0, 1]))
    steps = lambda mod: [mod.region_slice((n0, m0), s0, sz),  # noqa: E731
                         mod.region_transpose(sz, tuple(perm))]
    plan = g.fuse_chain(steps(g), [sz[0] * sz[1]] * 2)
    jplan = JG.fuse_chain(steps(JG), [sz[0] * sz[1]] * 2)
    _same_plan(plan, jplan)
    want = x[s0[0]:s0[0] + sz[0], s0[1]:s0[1] + sz[1]].transpose(perm)
    np.testing.assert_array_equal(_run_both(plan, jplan, x).reshape(want.shape), want)


def test_gather_rows_runs_compress():
    regs = g.region_gather_rows((10, 4), [2, 3, 4, 8])
    assert len(regs) == 2                       # [2,3,4] contiguous + [8]
    x = np.arange(40, dtype=np.float32).reshape(10, 4)
    out = g.execute_regions(regs, torch.from_numpy(x), 16).reshape(4, 4)
    np.testing.assert_array_equal(out.numpy(), x[[2, 3, 4, 8]])


def test_bf16_tensor_moves_bit_for_bit():
    """A bf16 tensor (the KV cache's dtype) through a fused plan: the bytes
    of the composed ops, the device's dtype kept."""
    x = torch.randn(6, 4, 8, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    plan = g.fuse_chain([g.region_transpose((6, 4, 8), (1, 0, 2)),
                         g.region_slice((4, 6, 8), (1, 2, 0), (2, 3, 8)),
                         g.region_transpose((2, 3, 8), (1, 0, 2))], [192, 48, 48])
    assert plan.num_stages == 1
    out = g.execute_plan(plan, x)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.reshape(3, 2, 8), x.permute(1, 0, 2)[1:3, 2:5].permute(1, 0, 2))


# ---------------------------------------------------------------------------
# tiling (C3)
# ---------------------------------------------------------------------------

def test_paper_table2_reproduced():
    for isa, jisa in zip(T.PAPER_ISAS, JT.PAPER_ISAS):
        assert dataclasses.astuple(isa) == dataclasses.astuple(jisa)
        assert T.solve_cpu_tiles(isa) == T.PAPER_TABLE2[isa.name] == JT.solve_cpu_tiles(jisa)
    assert T.PAPER_TABLE2 == JT.PAPER_TABLE2


def test_register_constraint_eq3_holds():
    for isa in T.PAPER_ISAS:
        ep, hp, lp = T.solve_cpu_tiles(isa)
        assert ep + hp + ep * hp <= isa.register_budget
        assert lp == isa.instruction_width


@pytest.mark.parametrize("e,h,l", [(1024, 1024, 1024), (64, 4096, 512), (7, 100, 33)])
def test_solver_equals_reference_off_the_table(e, h, l):
    for isa, jisa in zip(T.PAPER_ISAS, JT.PAPER_ISAS):
        assert T.solve_cpu_tiles(isa, e=e, h=h, l=l) == JT.solve_cpu_tiles(jisa, e=e, h=h, l=l)


def test_reorder_shapes():
    assert T.reorder_shape_cpu(1024, 512, 12, 4) == (86, 128, 12, 4) == \
        JT.reorder_shape_cpu(1024, 512, 12, 4)
    assert T.reorder_shape_gpu(512, 1024) == (16, 1024, 32) == JT.reorder_shape_gpu(512, 1024)


def test_memory_access_count_matches_paper_formula():
    # e/e_p * h/h_p * (l e_p + l h_p + h_p e_p), Eq. 2
    assert T.memory_access_count(12, 8, 4, 12, 8) == 1 * 1 * (4 * 12 + 4 * 8 + 96)
    for args in ((1024, 1024, 1024, 12, 8), (100, 30, 7, 3, 64)):
        assert T.memory_access_count(*args) == JT.memory_access_count(*args)
        assert T.hbm_traffic(*args, 1, 1.0) == JT.hbm_traffic(*args, 1, 1.0)


@pytest.mark.parametrize("M,N,K", [(1, 18944, 3584), (4, 18944, 3584), (4, 3584, 18944),
                                   (128, 512, 3584), (320, 151808, 3584), (3, 512, 256)])
def test_kernel_tiles_are_the_wrappers_choice(M, N, K):
    rows, bn, bk, splits = T.kernel_tiles(M, N, K)
    assert (rows, bn, bk) == (WM.tile_rows(M), WM.BN, WM.BK)
    assert splits == WM.matmul_splits(M, N, K)
    assert T.kernel_hbm_traffic(M, N, K) == T.hbm_traffic(M, N, K, rows, bn, bk, 1.0)
    # the split ranges the kernel takes cover K exactly
    ranges = WM.k_ranges(K, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == K // WM.BK * WM.BK
