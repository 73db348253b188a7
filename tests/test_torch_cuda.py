"""On the card only: each CUDA kernel of the port against its plain PyTorch
version, at small shapes (G in {1, 3}, ragged lengths, several pages and
trash-page table entries) and, for the dense-cache, dense-prefill and
grouped kernels, at the serving paths' shapes (G = 1 as moonshot, G = 7 as
qwen2-7b); the grouped kernel also with live-row counts (uneven, 0 and
full, not multiples of its 16-row tiles) and with expert ids (repeated),
and both prefill kernels across the edges of their 64-key tiles and 64-row
blocks.  Imports torch alone, so it runs where JAX is
absent: ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py``.
Without a card each test skips.

Tolerances are the JAX package's own kernel-vs-reference ones: matmul
1e-4 (the epilogue's scale products are ordered differently), attention
and RMSNorm 2e-2 (the decode kernels keep keys and probabilities in
float32; the prefill kernels round them to bf16 where the plain versions
do but sum in another order, against an output the plain versions round to
bf16)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as K  # noqa: E402
from repro_torch.core import kv_cache as KV  # noqa: E402
from repro_torch.core import quantization as Q  # noqa: E402
from repro_torch.kernels import flash_prefill as FP  # noqa: E402
from repro_torch.kernels import grouped_matmul as GM  # noqa: E402
from repro_torch.kernels import quant_attention as QA  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from repro_torch.kernels import w4a8_matmul as WM  # noqa: E402
from repro_torch.runtime import plan as RP  # noqa: E402

PS, PPR, HKV, D = 16, 4, 2, 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _close(a, b, tol):
    np.testing.assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                               rtol=tol, atol=tol)


def _pool(seed, n_pages, dev):
    rng = np.random.default_rng(seed)
    k = torch.from_numpy(rng.normal(size=(n_pages, PS, HKV, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(n_pages, PS, HKV, D)).astype(np.float32))
    kq, ks, kz = KV.quantize_keys(k.bfloat16())
    return tuple(t.contiguous().to(dev) for t in
                 (kq, ks, kz, KV.cast_values(v, Q.FP8_DTYPE)))


def _table(lengths, trash, seed, dev):
    free = list(np.random.default_rng(seed).permutation(trash))
    table = np.full((len(lengths), PPR), trash, np.int32)
    for b, L in enumerate(lengths):
        for c in range(-(-L // PS)):
            table[b, c] = free.pop()
    return torch.from_numpy(table).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M", [1, 5, 40])
def test_w4a8_kernel_matches_plain(dev, bits, M):
    g = torch.Generator().manual_seed(M)
    w = torch.randn((200, 300), generator=g) * 0.02
    pl = RP.pack_linear(Q.quantize(w, bits))
    x = torch.randn((M, 200), generator=g).bfloat16().to(dev)
    xq, sx = Q.quantize_activations(x)
    args = (xq, sx, pl.data.to(dev), pl.scale[0].to(dev), pl.zero[0].to(dev))
    before = WM.w4a8_matmul.launches
    got = WM.w4a8_matmul(*args, bits=bits)
    assert WM.w4a8_matmul.launches == before + 1
    _close(got, WM.w4a8_matmul_plain(*args, bits=bits), 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_kernel_matches_plain(dev, dtype):
    x = torch.randn((5, 256), device=dev).to(dtype)
    w = torch.rand((256,), device=dev) + 0.5
    got = RN.rmsnorm(x, w)
    assert got.dtype == dtype
    _close(got, RN.rmsnorm_plain(x, w), 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 3])
def test_decode_attention_kernel_matches_plain(dev, G):
    lengths = [37, 5, 64]
    trash = len(lengths) * PPR
    pool = _pool(G, trash + 3, dev)
    table = _table(lengths, trash, G, dev)
    q = (torch.randn((3, HKV * G, D), device=dev) / math.sqrt(D)).bfloat16()
    base = torch.zeros((3,), dtype=torch.int32, device=dev)
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    _close(QA.paged_quant_decode_attention(q, *pool, table, base, length),
           QA.paged_quant_decode_attention_plain(q, *pool, table, base, length), 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("C,pos0", [(16, 0), (16, 21), (8, 37)])
def test_prefill_attention_kernel_matches_plain(dev, G, C, pos0):
    trash = 4 * PPR
    pool = _pool(10 + G, trash + 3, dev)
    table = _table([pos0 + C], trash, C + G, dev)
    q = (torch.randn((1, C, HKV * G, D), device=dev) / math.sqrt(D)).bfloat16()
    p0 = torch.tensor([pos0], dtype=torch.int32, device=dev)
    _close(FP.paged_flash_prefill_attention(q, *pool, table, p0),
           FP.paged_flash_prefill_attention_plain(q, *pool, table, p0), 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("E,M,K,N", [(24, 1, 2048, 1408), (8, 128, 1408, 2048),
                                     (4, 40, 200, 300)])
def test_grouped_matmul_kernel_matches_plain(dev, bits, E, M, K, N):
    """moonshot's selected-expert decode (24 slabs of one row) and a
    full-capacity prefill slab, and a ragged shape padded by the plan."""
    g = torch.Generator().manual_seed(E + M)
    w = torch.randn((E, K, N), generator=g) * 0.02
    pel = RP.pack_expert_linear(Q.quantize(w, bits))
    x = torch.randn((E, M, K), generator=g).bfloat16().to(dev)
    xq, sx = Q.quantize_activations(x)
    args = (xq, sx, pel.data.to(dev), pel.scale[:, 0].to(dev), pel.zero[:, 0].to(dev))
    before = GM.grouped_matmul.launches
    got = GM.grouped_matmul(*args, bits=bits)
    assert GM.grouped_matmul.launches == before + 1
    _close(got, GM.grouped_matmul_plain(*args, bits=bits), 1e-4)


def _live_rows(x, rows, C):
    """Zero the capacity rows of x [E, G*C, K] past each segment's count."""
    E, M, _ = x.shape
    m = torch.arange(M)
    live = (m % C)[None] < torch.as_tensor(rows)[:, m // C]
    return x * live[..., None].to(x.dtype), live


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("K,N,C,rows", [
    # moonshot's full-capacity gate/up: one 128-row segment per expert, an
    # expert with no live row, one full, counts off the 16-row tiles
    (2048, 1536, 128, [[0], [128], [12], [17], [31], [1], [64], [100]]),
    # two segments of 40 rows (tiles straddle them), ragged K and N
    (200, 300, 40, [[0, 40], [40, 0], [17, 3], [16, 33], [1, 0], [0, 0]]),
])
def test_grouped_matmul_kernel_skips_dead_rows(dev, bits, K, N, C, rows):
    E, G = len(rows), len(rows[0])
    g = torch.Generator().manual_seed(K + bits)
    pel = RP.pack_expert_linear(Q.quantize(torch.randn((E, K, N), generator=g) * 0.02, bits))
    x, live = _live_rows(torch.randn((E, G * C, K), generator=g), rows, C)
    xq, sx = Q.quantize_activations(x.bfloat16().to(dev))
    args = (xq, sx, pel.data.to(dev), pel.scale[:, 0].to(dev), pel.zero[:, 0].to(dev))
    rows_t = torch.tensor(rows, dtype=torch.int32, device=dev)
    got = GM.grouped_matmul(*args, bits=bits, rows=rows_t)
    want = GM.grouped_matmul_plain(*args, bits=bits)
    _close(got, want, 1e-4)
    dead = got[~live.to(dev)]
    assert torch.equal(dead, torch.zeros_like(dead))       # +0.0, as the plain version
    assert not torch.signbit(dead).any()


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("E,K,N", [(64, 2048, 1408), (64, 1408, 2048), (5, 200, 300)])
def test_grouped_matmul_kernel_reads_experts_by_id(dev, bits, E, K, N):
    """The selected-expert decode: 4 tokens x top-6 slabs of one row each,
    named by id in the whole table, with repeats across tokens."""
    g = torch.Generator().manual_seed(E + K + bits)
    pel = RP.pack_expert_linear(Q.quantize(torch.randn((E, K, N), generator=g) * 0.02, bits))
    ids = torch.cat([torch.randperm(E, generator=g)[:min(6, E)] for _ in range(4)])
    ids[-1] = ids[0]
    x = torch.randn((ids.numel(), 1, K), generator=g).bfloat16().to(dev)
    xq, sx = Q.quantize_activations(x)
    table = (pel.data.to(dev), pel.scale[:, 0].to(dev), pel.zero[:, 0].to(dev))
    ids = ids.to(torch.int32).to(dev)
    before = GM.grouped_matmul.launches
    got = GM.grouped_matmul(xq, sx, *table, bits=bits, ids=ids)
    assert GM.grouped_matmul.launches == before + 1
    _close(got, GM.grouped_matmul_plain(xq, sx, *table, bits=bits, ids=ids), 1e-4)
    sel = RP.take_experts(RP.PackedExpertLinear(pel.data.to(dev), pel.scale.to(dev),
                                                pel.zero.to(dev), bits, K, N), ids)
    _close(got, GM.grouped_matmul_plain(xq, sx, sel.data, sel.scale[:, 0], sel.zero[:, 0],
                                        bits=bits), 1e-4)


def _dense_cache(B, S, hkv, d, dev, seed):
    g = torch.Generator().manual_seed(seed)
    k = torch.randn((B, S, hkv, d), generator=g)
    v = torch.randn((B, S, hkv, d), generator=g)
    kq, ks, kz = KV.quantize_keys(k.bfloat16())
    return tuple(t.contiguous().to(dev) for t in
                 (kq, ks, kz, KV.cast_values(v, Q.FP8_DTYPE)))


@pytest.mark.gpu
@pytest.mark.parametrize("G,hkv,S,lengths", [(1, 16, 2048, [700, 5, 1333, 2048]),
                                            (7, 4, 2048, [412]),
                                            (3, 2, 200, [37, 200, 1])])
def test_dense_decode_attention_kernel_matches_plain(dev, G, hkv, S, lengths):
    d = 128 if S == 2048 else 64
    B = len(lengths)
    cache = _dense_cache(B, S, hkv, d, dev, G)
    q = (torch.randn((B, hkv * G, d), device=dev) / math.sqrt(d)).bfloat16()
    for length in (torch.tensor(lengths, dtype=torch.int32, device=dev),
                   torch.tensor(lengths[0], dtype=torch.int32, device=dev)):
        want = QA.quant_decode_attention_plain(
            q, *cache, length.reshape(-1).expand(B))
        _close(QA.quant_decode_attention(q, *cache, length), want, 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("G,hkv,T,S,causal,window",
                         [(7, 4, 300, 1024, True, 0), (1, 16, 128, 128, True, 0),
                          (1, 16, 128, 200, False, 0), (7, 4, 96, 96, True, 40),
                          (3, 2, 50, 50, False, 16)])
def test_dense_prefill_attention_kernel_matches_plain(dev, G, hkv, T, S, causal, window):
    d = 128 if hkv > 2 else 64
    g = torch.Generator().manual_seed(T + S)
    q = (torch.randn((2, T, hkv * G, d), generator=g) / math.sqrt(d)).bfloat16().to(dev)
    k = torch.randn((2, S, hkv, d), generator=g).bfloat16().to(dev)
    v = torch.randn((2, S, hkv, d), generator=g).bfloat16().to(dev)
    got = FP.flash_prefill_attention(q, k, v, causal=causal, window=window)
    _close(got, FP.flash_prefill_attention_plain(q, k, v, causal=causal,
                                                 window=window), 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("G,hkv,D,T,S,causal,window", [
    (3, 2, 64, 37, 100, True, 0),        # T*G = 111: a half-empty 64-row block
    (7, 2, 64, 70, 70, True, 24),        # window inside one 64-key tile
    (1, 4, 128, 65, 130, False, 0),      # one key past two whole tiles
    (7, 4, 128, 129, 129, True, 65),     # window across a tile edge
    (1, 3, 64, 200, 64, True, 0),        # more queries than keys
])
def test_dense_prefill_kernel_across_tile_edges(dev, G, hkv, D, T, S, causal, window):
    g = torch.Generator().manual_seed(T * G + S)
    q = (torch.randn((2, T, hkv * G, D), generator=g) / math.sqrt(D)).bfloat16().to(dev)
    k = torch.randn((2, S, hkv, D), generator=g).bfloat16().to(dev)
    v = torch.randn((2, S, hkv, D), generator=g).bfloat16().to(dev)
    got = FP.flash_prefill_attention(q, k, v, causal=causal, window=window)
    _close(got, FP.flash_prefill_attention_plain(q, k, v, causal=causal,
                                                 window=window), 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("G,hkv,D", [(7, 4, 128), (1, 16, 128), (3, 2, 64)])
@pytest.mark.parametrize("C,pos0", [(128, 256), (100, 37), (50, 200)])
def test_paged_prefill_kernel_on_128_key_pages(dev, G, hkv, D, C, pos0):
    """The serving page size: two 64-key tiles a page, chunks that start and
    end off the tile edges, a 64-row block the chunk does not fill."""
    ps, ppr = 128, 4
    rng = np.random.default_rng(C + G)
    n_pages = 2 * ppr + 1
    k = torch.from_numpy(rng.normal(size=(n_pages, ps, hkv, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(n_pages, ps, hkv, D)).astype(np.float32))
    kq, ks, kz = KV.quantize_keys(k.bfloat16())
    pool = tuple(t.contiguous().to(dev) for t in (kq, ks, kz, KV.cast_values(v, Q.FP8_DTYPE)))
    pages = rng.permutation(n_pages - 1)[:ppr].astype(np.int32)
    table = torch.from_numpy(pages[None]).to(dev)
    q = (torch.randn((1, C, hkv * G, D), device=dev) / math.sqrt(D)).bfloat16()
    p0 = torch.tensor([pos0], dtype=torch.int32, device=dev)
    _close(FP.paged_flash_prefill_attention(q, *pool, table, p0),
           FP.paged_flash_prefill_attention_plain(q, *pool, table, p0), 2e-2)


@pytest.mark.gpu
def test_unsupported_configurations_raise_on_the_card(dev):
    """No silent fallback: what the kernels do not take raises."""
    pool = _pool(0, 8, dev)
    q = torch.zeros((1, HKV, D), device=dev)                    # float32 queries
    z = torch.zeros((1,), dtype=torch.int32, device=dev)
    table = torch.zeros((1, PPR), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        QA.paged_quant_decode_attention(q, *pool, table, z, z + 1)
    with pytest.raises(NotImplementedError):
        QA.paged_quant_decode_attention(q.bfloat16(), *pool, table, z, z + 1, key_bits=4)
    dense = _dense_cache(1, 16, HKV, D, dev, 0)
    with pytest.raises(TypeError):
        QA.quant_decode_attention(q, *dense, 3)
    with pytest.raises(TypeError):
        FP.flash_prefill_attention(q[:, None], dense[3].float(), dense[3].float())
    K.reset_launch_counts()
    assert set(K.launch_counts().values()) == {0}
