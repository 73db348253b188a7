"""The dense matmul kernel's launch rule and its split of K, held on the CPU.

``matmul_splits`` picks from shapes alone how many contiguous K ranges share
one output tile of ``csrc/w4a8_matmul.cu``, and ``tile_rows`` which of its
two tiles runs; the kernel then sums the splits' int32 partials exactly.
Here: the rule at every dense linear of the serving paths (qwen2-7b and
moonshot-v1-16b-a3b at M = 1, 4, 128, 320), the split arithmetic modelled
in plain PyTorch (test code only) against the plain version bit for bit,
and the plain version against the Pallas kernel run with ``interpret=True``
at the JAX package's kernel-vs-reference tolerance (1e-4: the Pallas
epilogue orders its scale products differently).  The kernel itself is held
against the plain version on the card (``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import w4a8_matmul as JW  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import quantization as Q  # noqa: E402
from repro_torch.kernels import w4a8_matmul as WM  # noqa: E402
from repro_torch.runtime import plan  # noqa: E402

SMS = 132
BLOCKS = 2 * SMS


def _dense_linears(arch):
    """(name, Kp, Np, bits) of every dense linear of a serving step, padded as
    ``plan.pack_linear`` pads them."""
    cfg = registry.get(arch)
    q_out, kv_out = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    shapes = [("q/o", cfg.d_model, q_out, 4), ("k/v", cfg.d_model, kv_out, 4),
              ("o", q_out, cfg.d_model, 4)]
    if cfg.num_experts == 0:
        shapes += [("gate/up", cfg.d_model, cfg.d_ff, 4), ("down", cfg.d_ff, cfg.d_model, 4)]
    shapes.append(("lm_head", cfg.d_model, cfg.padded_vocab_size, cfg.quant.lm_head_bits))
    return [(name, plan._ceil_to(k, plan.LANE), plan._ceil_to(n, plan.N_ALIGN), bits)
            for name, k, n, bits in shapes]


@pytest.mark.parametrize("arch", ["qwen2-7b", "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("M", [1, 4, 128, 320])
def test_split_rule_at_main_path_shapes(arch, M):
    for name, K, N, bits in _dense_linears(arch):
        splits = WM.matmul_splits(M, N, K)
        ranges = WM.k_ranges(K, splits)
        assert len(ranges) == splits and ranges[0][0] == 0 and ranges[-1][1] == K
        for (a, b), (c, _) in zip(ranges, ranges[1:]):
            assert b == c                                    # contiguous
        steps = [(b - a) // WM.BK for a, b in ranges]
        assert all((b - a) % WM.BK == 0 for a, b in ranges)
        assert max(steps) - min(steps) <= 1                  # remainder spread
        if splits > 1:
            assert min(steps) >= WM.MIN_STEPS
        rows = WM.tile_rows(M)
        tiles = -(-M // rows) * (N // WM.BN)
        blocks = tiles * splits
        k_cap = (K // WM.BK) // WM.MIN_STEPS                 # K allows no more
        if tiles >= BLOCKS or (rows == 16 and tiles >= SMS):
            assert splits == 1
        elif rows == 16:                                     # about 2 x 132 blocks, <= 8
            assert splits == min(-(-BLOCKS // tiles), 8, k_cap), (name, M, splits)
            assert blocks >= BLOCKS or splits in (8, k_cap), (name, M, blocks)
        else:                                                # the 64-row tile: 4 or 1
            assert splits in (1, min(4, k_cap)), (name, M, splits)
        if name == "lm_head":
            assert splits == 1
    assert WM.tile_rows(M) == (16 if M <= 16 else 64)


def test_split_rule_named_cases():
    """qwen2-7b at decode bucket 4: q/o, k/v and down 8 splits (down: 37
    steps each over 28 column tiles, 224 blocks); gate/up (148 tiles, every
    SM busy) and lm_head none.
    The 64-row tile: 4 splits while its tiles leave half the SMs idle (a
    128-token chunk's q/o and k/v) or K is long (down at 128 and 320 rows),
    else none (320-row q/o; gate/up)."""
    assert WM.matmul_splits(4, 3584, 3584) == 8
    assert WM.matmul_splits(4, 512, 3584) == 8
    assert WM.matmul_splits(4, 3584, 18944) == 8
    assert WM.matmul_splits(4, 18944, 3584) == 1
    assert WM.matmul_splits(4, 151808, 3584) == 1
    assert WM.matmul_splits(1, 2048, 2048) == 8             # moonshot, 32 K steps
    assert WM.matmul_splits(128, 3584, 3584) == 4
    assert WM.matmul_splits(128, 3584, 18944) == 4
    assert WM.matmul_splits(320, 3584, 18944) == 4
    assert WM.matmul_splits(320, 3584, 3584) == 1
    assert WM.matmul_splits(320, 512, 3584) == 4
    assert WM.matmul_splits(320, 2048, 2048) == 1
    assert WM.matmul_splits(128, 18944, 3584) == 1          # 2 x 148 tiles already
    assert WM.k_ranges(18944, 8)[:2] == [(0, 2368), (2368, 4736)]
    assert WM.k_ranges(3584, 3) == [(0, 1152), (1152, 2368), (2368, 3584)]


def _operands(M, K, N, bits, seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.normal(size=(K, N)) * 0.02).astype(np.float32))
    pl = plan.pack_linear(Q.quantize(w, bits))
    x = torch.from_numpy(rng.normal(size=(M, pl.data.shape[0])).astype(np.float32))
    xq, sx = Q.quantize_activations(x.bfloat16())
    return xq, sx, pl.data, pl.scale[0], pl.zero[0]


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M,splits", [(1, 3), (4, 7), (17, 2), (128, 5)])
def test_split_partials_combine_to_the_plain_version(bits, M, splits):
    """The kernel's combine, modelled: int32 partial dot products and row
    sums over each K range, summed, then the epilogue in the plain order --
    bit for bit the plain version, whatever the split count."""
    K, N = 1280, 512                                  # 20 K steps, 4 column tiles
    xq, sx, w, scale, zero = _operands(M, K, N, bits, seed=M)
    wq = Q.unpack_int4(w) if bits == 4 else w
    acc = torch.zeros((M, N), dtype=torch.int32)
    rowsum = torch.zeros((M, 1), dtype=torch.int32)
    for a, b in WM.k_ranges(K, splits):
        acc += Q.int_dot(xq[:, a:b], wq[a:b])
        rowsum += xq[:, a:b].to(torch.int32).sum(dim=-1, keepdim=True)
    y = scale * Q.zero_correction(acc, zero, rowsum) * sx
    assert torch.equal(y, WM.w4a8_matmul_plain(xq, sx, w, scale, zero, bits=bits))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M", [1, 4, 17, 128])
def test_w4a8_plain_vs_pallas_interpret(bits, M):
    """K over four 64-deep steps and N over four 128-column tiles."""
    K, N = 256, 512
    xq, sx, w, scale, zero = _operands(M, K, N, bits, seed=100 + M)
    got = WM.w4a8_matmul_plain(xq, sx, w, scale, zero, bits=bits)
    want = JW.w4a8_matmul(jnp.asarray(xq.numpy()), jnp.asarray(sx.numpy()),
                          jnp.asarray(w.numpy()), jnp.asarray(scale.numpy()),
                          jnp.asarray(zero.numpy()), bits=bits, blocks=(M, 128, 64),
                          interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
