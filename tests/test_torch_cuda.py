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

The decode kernels are split over keys: their cases cover 128-key pages at
G = 7 and G = 1 with lengths at a page edge, a full 16-page table, a row
whose only live keys lie in the last split, and a CUDA-graph replay that
shows the combine counters reset.  A block takes up to 16 query heads (both
halves of its tensor-core tile) and larger groups take several head tiles:
the same cases run at G = 16 (glm4-9b), 24 and 32, at D = 64 and 128, with
empty rows, window and base masks, and outputs allocated over NaN so that a
row the kernel leaves unwritten fails.

The serving loop's step graphs (qwen2-7b@reduced, bucketed; moonshot@tiny-moe,
one unbucketed decode step): ``warmup()`` captures one graph per decode
bucket and chunk size and a second call none; a churny 8-slot trace on the
graphs captures nothing more and commits the eager loop's tokens with the
same launch counts; the step functions run under sync debug mode "error";
a replay gives an eager step's launches and bit-equal outputs.

The Flash tier: both paged kernels over tables that mix pool pages and
staging pages (ids past the trash page); page bytes (fp8 included) to Flash
through pinned memory and back into staging and fresh pool pages, bit for
bit, in place and with no host wait on the way in; a warmed loop whose
decode runs in several staging waves commits the eager loop's tokens with
no capture after warmup; a no-spill decode step still waits once.

Weight streaming: a group blob read into pinned memory lands in a ring slot
bit for bit, in place, with no host wait; on qwen2-7b@tiny (6 groups, a
2-slot ring) a prompt and its decode steps give the resident engine's
logits bit for bit; on moonshot@tiny-moe with an emptied expert prediction
every decode visit runs its group again and the logits still equal the
resident engine's, with nothing falling back; gemma3-27b@tiny's windowed
stack and rwkv6-7b@tiny's rwkv stack streamed give the resident chunk and
decode logits bit for bit beside a row mid-prefill, and an all-MoE
jamba@tiny expert group run again after a cold miss leaves its output and
mamba state as one run does.

The dense matmul kernel is split over K at decode widths and has two tile
sizes (16 rows up to M = 16, 64 above): its cases give bit-identical
outputs for every split count (uneven ranges of K = 18944 among them), M
at the tiles' edges, and a CUDA-graph replay; RMSNorm runs at the serving
paths' row counts and on its scalar path (rows not whole 16-byte chunks,
or too wide for registers).

Tolerances are the JAX package's own kernel-vs-reference ones: matmul
1e-4 (the epilogue's scale products are ordered differently), attention
and RMSNorm 2e-2 (the attention kernels round keys and probabilities to
bf16 where the plain versions do but sum in another order, and the decode
kernels round probabilities before normalising, against an output the
plain versions round to bf16).

The encoder-decoder's shapes: the dense prefill kernel non-causal at
D = 64 over a whole source (the encoder), and the dense decode kernel with
T query tokens folded into the query-head axis (cross attention at
prefill, G' = T * G = 64 and 320: 4 and 20 head tiles a KV head).  M-RoPE's
axis index is built outside a CUDA graph capture and read inside it.

The paper's quantization variants: kernels 2, 3 and 6 over int4 keys
(nibble pairs) with fp8 and bf16 values and over int8 keys with bf16
values, at D = 64 and 128 and G = 1, 6 and 16 (128-key pages, ragged
lengths, a chunk off the tile edges); the dispatcher's float path (A16,
group-wise scales) on the card against the same call on the CPU, linears
and experts with live-row counts and ids.

Training: the two kernels of the training forward under their
``autograd.Function``s at qwen2-1.5b's shapes (forward within the kernel
tolerance, every input gradient equal to autograd of the plain version),
kernel 7 windowed and non-causal and kernel 6 over a differentiable cross
cache under theirs;
a wrapper called on an input that requires grad raises; one qwen2-7b@tiny
step's loss and gradients on the kernel route against the plain route.

The public ops (``kernels/ops.py``) on the card against their oracles
(``kernels/ref.py``), kernels 1, 4, 6 and 7 counted; a fused Region plan
(geometry compute) bit-equal to the composed ``permute``/slice ops.

§4.1's KV spill: kernel 6 over a history that went through a
``KVSpillManager`` and was joined on the card ahead of the device part
gives the unspilled cache's output bit for bit at qwen2-7b's shape (1,536
and 8,704 tokens); ``analysis.trace.summarize``, which reads raw kineto
events, equals the ``key_averages()`` aggregation it replaced."""
import dataclasses
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
from repro_torch.configs import registry as PR  # noqa: E402
from repro_torch.core import hybrid_storage as HS  # noqa: E402
from repro_torch.core import kv_pool as KP  # noqa: E402
from repro_torch.core.precision import DEFAULT_POLICY  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.runtime import dispatch as PD  # noqa: E402
from repro_torch.runtime import plan as RP  # noqa: E402
from repro_torch.serving import engine as PE  # noqa: E402
from repro_torch.serving import sampling as PSM  # noqa: E402

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


def _linear_on(dev, K, N, bits, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    pl = RP.pack_linear(Q.quantize(torch.randn((K, N), generator=g, device=dev) * 0.02, bits))
    return pl.data, pl.scale[0], pl.zero[0], g


def _activations(M, K, g, dev):
    return Q.quantize_activations(torch.randn((M, K), generator=g, device=dev).bfloat16())


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M,K,N,counts", [
    (4, 3584, 512, [2, 3, 13]),          # qwen2-7b k/v at decode: 8 chosen
    (4, 18944, 3584, [2, 7, 13, 74]),    # down: 8 chosen; 296 steps split unevenly
    (1, 2048, 2048, [2, 5]),             # moonshot q at decode: 8 chosen
    (128, 3584, 3584, [2, 3]),           # a prompt chunk on the 64-row tile
])
def test_w4a8_kernel_split_k_is_exact(dev, bits, M, K, N, counts):
    """Every split count gives the same bits (int32 partials summed exactly)."""
    w, scale, zero, g = _linear_on(dev, K, N, bits, M + K)
    xq, sx = _activations(M, K, g, dev)
    args = (xq, sx, w, scale, zero)
    chosen = WM.matmul_splits(M, N, K)
    one = WM.w4a8_matmul(*args, bits=bits, splits=1)
    for s_ in [chosen] + counts:
        assert torch.equal(WM.w4a8_matmul(*args, bits=bits, splits=s_), one), s_
    assert torch.equal(WM.w4a8_matmul(*args, bits=bits), one)
    _close(one, WM.w4a8_matmul_plain(*args, bits=bits), 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M", [1, 15, 16, 17, 64, 65, 128, 320])
def test_w4a8_kernel_at_tile_edges(dev, bits, M):
    K, N = 1024, 384
    w, scale, zero, g = _linear_on(dev, K, N, bits, M)
    xq, sx = _activations(M, K, g, dev)
    args = (xq, sx, w, scale, zero)
    got = WM.w4a8_matmul(*args, bits=bits)
    _close(got, WM.w4a8_matmul_plain(*args, bits=bits), 1e-4)
    assert torch.equal(got, WM.w4a8_matmul(*args, bits=bits, splits=1))


@pytest.mark.gpu
def test_w4a8_kernel_replays_in_a_cuda_graph(dev):
    """20 calls captured in one CUDA graph and replayed twice give the eager
    calls' outputs bit for bit: split launches leave their counters at 0."""
    shapes = [(4, 3584, 512, 4), (1, 18944, 3584, 4), (128, 3584, 3584, 4),
              (4, 2048, 1024, 8), (40, 1024, 384, 8)]
    layers = [_linear_on(dev, K, N, bits, i) for i, (_, K, N, bits) in enumerate(shapes)]
    calls = []
    for i in range(20):
        M, K, N, bits = shapes[i % len(shapes)]
        w, scale, zero, g = layers[i % len(shapes)]
        calls.append((*_activations(M, K, g, dev), w, scale, zero, bits))

    def run():
        return [WM.w4a8_matmul(*c[:5], bits=c[5]) for c in calls]

    eager = run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(eager, captured))
    assert all(torch.equal(a, b) for a, b in zip(eager, run()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,D", [(1, 3584), (4, 3584), (128, 3584), (320, 3584),
                                    (600, 2048), (3, 1001), (2, 16384)])
def test_rmsnorm_kernel_at_serving_rows(dev, dtype, rows, D):
    """Rows held in registers by blocks of 4 warps (D = 3584 bf16), 8 (3584
    float32, 16384 bf16) and 2 (2048 bf16), and the scalar path (D = 1001;
    16384 float32 is too wide for registers)."""
    g = torch.Generator(device=dev).manual_seed(rows + D)
    x = torch.randn((rows, D), generator=g, device=dev).to(dtype)
    w = 1.0 + 0.1 * torch.randn((D,), generator=g, device=dev)
    before = RN.rmsnorm.launches
    got = RN.rmsnorm(x, w, 1e-6)
    assert RN.rmsnorm.launches == before + 1 and got.dtype == dtype
    _close(got, RN.rmsnorm_plain(x, w, 1e-6), 2e-2)


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


def _paged_128(B, hkv, D, n_pages, seed, dev):
    """A pool of 128-key pages (+ one trash page, the last) and a table of
    distinct pages for B rows of ``n_pages`` columns."""
    rng = np.random.default_rng(seed)
    P = B * n_pages + 1
    k = torch.from_numpy(rng.normal(size=(P, 128, hkv, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(P, 128, hkv, D)).astype(np.float32))
    kq, ks, kz = KV.quantize_keys(k.bfloat16())
    pool = tuple(t.contiguous().to(dev) for t in (kq, ks, kz, KV.cast_values(v, Q.FP8_DTYPE)))
    table = rng.permutation(P - 1)[:B * n_pages].reshape(B, n_pages).astype(np.int32)
    return pool, table


# lengths of 4 rows: a page edge (page - 1, page, page + 1), one live key,
# a full table, and rows whose later splits hold no live key
_PAGED_LENGTHS = [[127, 128, 129, 1], [732, 296, 512, 41], [2048, 1, 255, 257]]


@pytest.mark.gpu
@pytest.mark.parametrize("G,hkv", [(7, 4), (1, 16), (16, 2), (24, 2), (32, 1)])
@pytest.mark.parametrize("lengths", _PAGED_LENGTHS)
def test_paged_decode_kernel_on_128_key_pages(dev, G, hkv, lengths):
    D, n_pages = 128, 16
    B = len(lengths)
    pool, table = _paged_128(B, hkv, D, n_pages, G + lengths[0], dev)
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    # columns past a row's length name the trash page, as the pool manager's do
    for b, L in enumerate(lengths):
        table[b, -(-L // 128):] = pool[0].shape[0] - 1
    table = torch.from_numpy(table).to(dev)
    base = torch.zeros((B,), dtype=torch.int32, device=dev)
    q = (torch.randn((B, hkv * G, D), device=dev) / math.sqrt(D)).bfloat16()
    before = QA.paged_quant_decode_attention.launches
    got = QA.paged_quant_decode_attention(q, *pool, table, base, length)
    assert QA.paged_quant_decode_attention.launches == before + 1
    _close(got, QA.paged_quant_decode_attention_plain(q, *pool, table, base, length), 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("G,hkv", [(7, 4), (1, 16), (16, 2)])
@pytest.mark.parametrize("window", [100, 128, 129])
def test_paged_decode_kernel_live_keys_in_last_split_only(dev, G, hkv, window):
    """A full 16-page table with a window: every live key lies in the last
    split (or straddles the last two), the earlier splits exit."""
    D, n_pages = 128, 16
    B = 2
    pool, table = _paged_128(B, hkv, D, n_pages, window + G, dev)
    table = torch.from_numpy(table).to(dev)
    length = torch.tensor([2048, 2047], dtype=torch.int32, device=dev)
    base = torch.zeros((B,), dtype=torch.int32, device=dev)
    q = (torch.randn((B, hkv * G, D), device=dev) / math.sqrt(D)).bfloat16()
    got = QA.paged_quant_decode_attention(q, *pool, table, base, length, window=window)
    _close(got, QA.paged_quant_decode_attention_plain(q, *pool, table, base, length,
                                                      window=window), 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("G,hkv", [(7, 4), (1, 16), (16, 2), (24, 2), (32, 1)])
@pytest.mark.parametrize("lengths", [[127, 128, 129, 1], [2048, 352, 1000, 2047], [352]])
def test_dense_decode_kernel_split_over_keys(dev, G, hkv, lengths):
    """S = 2048 (16 key blocks of 128 slots): ragged per-row lengths at a
    block edge, and one scalar length for every row."""
    S, D, B = 2048, 128, 4
    cache = _dense_cache(B, S, hkv, D, dev, G + len(lengths))
    q = (torch.randn((B, hkv * G, D), device=dev) / math.sqrt(D)).bfloat16()
    length = torch.tensor(lengths if len(lengths) > 1 else lengths[0], dtype=torch.int32,
                          device=dev)
    before = QA.quant_decode_attention.launches
    got = QA.quant_decode_attention(q, *cache, length)
    assert QA.quant_decode_attention.launches == before + 1
    _close(got, QA.quant_decode_attention_plain(q, *cache, length.reshape(-1).expand(B)),
           2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("G,hkv", [(7, 4), (1, 16), (16, 2)])
def test_decode_kernels_read_subnormal_values(dev, G, hkv):
    """Values of a few thousandths are e4m3 subnormals (below 2^-6); the
    kernels convert them to bf16 exactly, so the output, itself of that
    size, holds the plain version at a relative tolerance."""
    D, n_pages, B = 128, 4, 2
    pool, table = _paged_128(B, hkv, D, n_pages, 11, dev)
    g = torch.Generator().manual_seed(12)
    small = KV.cast_values(torch.randn(pool[3].shape, generator=g) * 4e-3, Q.FP8_DTYPE)
    pool = (*pool[:3], small.to(dev))
    table = torch.from_numpy(table).to(dev)
    length = torch.tensor([300, 77], dtype=torch.int32, device=dev)
    base = torch.zeros((B,), dtype=torch.int32, device=dev)
    q = (torch.randn((B, hkv * G, D), device=dev) / math.sqrt(D)).bfloat16()
    got = QA.paged_quant_decode_attention(q, *pool, table, base, length)
    want = QA.paged_quant_decode_attention_plain(q, *pool, table, base, length)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=2e-2, atol=2e-5)


def _over_nan(dev, *shapes):
    """Free float32 blocks of these shapes that hold NaN, so that the
    caching allocator hands them to the next outputs of those sizes: an
    output element the kernel does not write stays NaN."""
    bufs = [torch.full(s, float("nan"), device=dev) for s in shapes]
    torch.cuda.synchronize()
    del bufs


@pytest.mark.gpu
@pytest.mark.parametrize("G,hkv", [(16, 2), (24, 2), (32, 1)])
@pytest.mark.parametrize("D", [64, 128])
def test_decode_kernels_write_every_row_at_large_groups(dev, G, hkv, D):
    """Groups of more than 8 query heads: both halves of a block's 16-row
    tile, and (G > 16) several head tiles of one (row, KV head), each with
    its own partials and combine counter.  Paged: an empty row, lengths at
    a page edge and a full 16-page table, then windows and bases (the
    logical page of column 0) that leave only a row's later pages live;
    dense: the same lengths over 2048 slots.  Every output is allocated
    over NaN and must match the plain version, except that a row with no
    live key is zeros (the plain version's softmax over all-masked scores
    averages the values there; no serving step reads such a row)."""
    n_pages, B = 16, 4
    pool, table = _paged_128(B, hkv, D, n_pages, G + D, dev)
    trash = pool[0].shape[0] - 1
    q = (torch.randn((B, hkv * G, D), device=dev) / math.sqrt(D)).bfloat16()
    dense = _dense_cache(B, n_pages * 128, hkv, D, dev, G + D)
    for lengths, bases, window in (([0, 127, 128, 2048], [0, 0, 0, 0], 0),
                                   ([129, 1, 0, 2047], [0, 0, 0, 0], 0),
                                   ([1000, 700, 2048, 300], [0, 0, 0, 0], 129),
                                   ([1000, 700, 2300, 600], [2, 1, 3, 4], 300)):
        t = table.copy()
        for b, (L, bs) in enumerate(zip(lengths, bases)):
            t[b, max(0, -(-L // 128) - bs):] = trash
        t = torch.from_numpy(t).to(dev)
        length = torch.tensor(lengths, dtype=torch.int32, device=dev)
        base = torch.tensor(bases, dtype=torch.int32, device=dev)
        live = length > 0
        _over_nan(dev, (B, hkv * G, D))
        got = QA.paged_quant_decode_attention(q, *pool, t, base, length, window=window)
        assert torch.isfinite(got).all() and not got[~live].any(), (lengths, bases, window)
        _close(got[live], QA.paged_quant_decode_attention_plain(
            q, *pool, t, base, length, window=window)[live], 2e-2)
        if window or any(bases):
            continue
        _over_nan(dev, (B, hkv * G, D))
        got = QA.quant_decode_attention(q, *dense, length)
        assert torch.isfinite(got).all() and not got[~live].any(), lengths
        _close(got[live], QA.quant_decode_attention_plain(q, *dense, length)[live], 2e-2)


@pytest.mark.gpu
def test_decode_kernels_replay_in_a_cuda_graph(dev):
    """20 calls of each decode kernel captured in one CUDA graph and
    replayed twice give the eager calls' outputs bit for bit: every launch
    leaves its combine counters at 0."""
    G, hkv, D, n_pages, B = 7, 4, 128, 16, 4
    pool, table = _paged_128(B, hkv, D, n_pages, 5, dev)
    table = torch.from_numpy(table).to(dev)
    base = torch.zeros((B,), dtype=torch.int32, device=dev)
    dense = _dense_cache(B, 2048, hkv, D, dev, 6)
    qs = [(torch.randn((B, hkv * G, D), device=dev) / math.sqrt(D)).bfloat16()
          for _ in range(20)]
    lengths = [torch.tensor([732 - i, 296 + i, 512, 41 + 3 * i], dtype=torch.int32,
                            device=dev) for i in range(20)]

    def calls():
        return [(QA.paged_quant_decode_attention(q, *pool, table, base, L),
                 QA.quant_decode_attention(q, *dense, L)) for q, L in zip(qs, lengths)]

    eager = calls()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = calls()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for (pe, de), (pc, dc) in zip(eager, captured):
            assert torch.equal(pe, pc) and torch.equal(de, dc)
    again = calls()                    # eager once more, after the replays
    for (pe, de), (pa, da) in zip(eager, again):
        assert torch.equal(pe, pa) and torch.equal(de, da)


@pytest.mark.gpu
@pytest.mark.parametrize("T,S", [(256, 256), (16, 16), (100, 100)])
def test_encoder_prefill_kernel_non_causal_at_d64(dev, T, S):
    """seamless-m4t's encoder: 16 heads of 64 over 16 KV heads, every query
    over every key of the source."""
    g = torch.Generator().manual_seed(T)
    q = (torch.randn((2, T, 16, 64), generator=g) / 8).bfloat16().to(dev)
    k = torch.randn((2, S, 16, 64), generator=g).bfloat16().to(dev)
    v = torch.randn((2, S, 16, 64), generator=g).bfloat16().to(dev)
    got = FP.flash_prefill_attention(q, k, v, causal=False)
    _close(got, FP.flash_prefill_attention_plain(q, k, v, causal=False), 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("T,hkv,G", [(64, 16, 1), (320, 16, 1), (24, 2, 4)])
def test_folded_decode_attention_matches_plain(dev, T, hkv, G):
    """Cross attention at prefill: T query tokens a row over a 256-slot
    dense cache (200 live in row 1), folded to G' = T * G heads a KV head
    in one kernel launch, against the plain fold and T one-token launches."""
    B, S, d = 2, 256, 64
    cache = KV.LayerKVCache(*_dense_cache(B, S, hkv, d, dev, T),
                            length=torch.tensor(S, dtype=torch.int32, device=dev))
    g = torch.Generator().manual_seed(T * G)
    qh = (torch.randn((B, T, hkv * G, d), generator=g) / 8).bfloat16().to(dev)
    length = torch.tensor([S, 200], dtype=torch.int32, device=dev)
    before = QA.quant_decode_attention.launches
    got = PD.Dispatcher("kernel").decode_attention(qh, cache, length, DEFAULT_POLICY,
                                                   causal=False)
    assert QA.quant_decode_attention.launches == before + 1
    want = PD.Dispatcher("reference").decode_attention(qh, cache, length, DEFAULT_POLICY,
                                                       causal=False)
    assert got.shape == (B, T, hkv * G, d)
    _close(got, want, 2e-2)
    single = torch.cat([PD.Dispatcher("kernel").decode_attention(
        qh[:, t:t + 1].contiguous(), cache, length, DEFAULT_POLICY)
        for t in range(0, T, 7)], dim=1)
    _close(got[:, ::7], single, 2e-2)


@pytest.mark.gpu
def test_mrope_axis_index_cached_before_a_capture(dev):
    """qwen2-vl's rotation on text positions: the eager call builds the
    axis index (a host copy); a CUDA graph captured after it reads the
    cached index and its replay equals the eager result."""
    cfg = PR.get("qwen2-vl-2b")
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 1, 12, 128), generator=g).bfloat16().to(dev)
    pos = torch.tensor([[3], [70], [500], [1999]], device=dev)
    want = PL.positional(x, cfg, pos)
    axes = PL.mrope_axes(cfg.mrope_sections, dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = PL.positional(x, cfg, pos)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert PL.mrope_axes(cfg.mrope_sections, dev) is axes


@pytest.mark.gpu
def test_unsupported_configurations_raise_on_the_card(dev):
    """No silent fallback: what the kernels do not take raises."""
    pool = _pool(0, 8, dev)
    q = torch.zeros((1, HKV, D), device=dev)                    # float32 queries
    z = torch.zeros((1,), dtype=torch.int32, device=dev)
    table = torch.zeros((1, PPR), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        QA.paged_quant_decode_attention(q, *pool, table, z, z + 1)
    d48 = 48                                # bf16 values: the variants take D = 64, 128
    pool48 = (torch.zeros((8, PS, HKV, d48), dtype=torch.int8, device=dev),
              pool[1], pool[2], torch.zeros((8, PS, HKV, d48), dtype=torch.bfloat16,
                                            device=dev))
    with pytest.raises(NotImplementedError):
        QA.paged_quant_decode_attention(torch.zeros((1, HKV, d48), dtype=torch.bfloat16,
                                                    device=dev), *pool48, table, z, z + 1)
    dense = _dense_cache(1, 16, HKV, D, dev, 0)
    with pytest.raises(TypeError):
        QA.quant_decode_attention(q, *dense, 3)
    with pytest.raises(TypeError):
        FP.flash_prefill_attention(q[:, None], dense[3].float(), dense[3].float())
    w, scale, zero, g = _linear_on(dev, 256, 128, 4, 0)
    xq, sx = _activations(2, 256, g, dev)
    for bad in (0, 5):                                          # 4 K steps
        with pytest.raises(ValueError):
            WM.w4a8_matmul(xq, sx, w, scale, zero, bits=4, splits=bad)
    K.reset_launch_counts()
    assert set(K.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# the paper's quantization variants: int4 keys, bf16 values, the float path
# ---------------------------------------------------------------------------

def _variant_kv(shape, bits, bf16, seed, dev):
    """Keys and values of ``shape`` quantized as the serving path writes
    them: int8 or int4 keys (nibble pairs), fp8 or bf16 values."""
    g = torch.Generator().manual_seed(seed)
    k = torch.randn(shape, generator=g)
    v = torch.randn(shape, generator=g)
    kq, ks, kz = KV.quantize_keys(k.bfloat16(), bits=bits)
    vv = KV.cast_values(v, torch.bfloat16 if bf16 else Q.FP8_DTYPE)
    return tuple(t.contiguous().to(dev) for t in (kq, ks, kz, vv))


_VARIANTS = [(4, False), (4, True), (8, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("bits,bf16", _VARIANTS)
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G,hkv", [(1, 8), (6, 2), (16, 2)])
def test_attention_kernel_variants_match_plain(dev, bits, bf16, D, G, hkv):
    """Kernels 2, 3 and 6 over each variant: the paged decode kernel on a
    16-page table of 128-key pages (a page edge, one live key, a full
    table, a row past its split), the paged prefill kernel on a 100-token
    chunk at 37 (off the 64-key tiles), the dense decode kernel over 2048
    slots; each launches once and agrees with its plain version."""
    B, n_pages, H = 4, 16, hkv * G
    P = B * n_pages + 1
    pool = _variant_kv((P, 128, hkv, D), bits, bf16, seed=D + G + bits, dev=dev)
    assert pool[0].shape[-1] == D * bits // 8
    rng = np.random.default_rng(G + D)
    table = rng.permutation(P - 1)[:B * n_pages].reshape(B, n_pages).astype(np.int32)
    lengths = [129, 1, 2048, 700]
    for b, L in enumerate(lengths):
        table[b, -(-L // 128):] = P - 1
    table = torch.from_numpy(table).to(dev)
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    base = torch.zeros((B,), dtype=torch.int32, device=dev)
    q = (torch.randn((B, H, D), device=dev) / math.sqrt(D)).bfloat16()
    counts = K.launch_counts()
    got = QA.paged_quant_decode_attention(q, *pool, table, base, length, key_bits=bits)
    _close(got, QA.paged_quant_decode_attention_plain(q, *pool, table, base, length,
                                                      key_bits=bits), 2e-2)
    C, pos0 = 100, 37
    qc = (torch.randn((1, C, H, D), device=dev) / math.sqrt(D)).bfloat16()
    p0 = torch.tensor([pos0], dtype=torch.int32, device=dev)
    got = FP.paged_flash_prefill_attention(qc, *pool, table[3:], p0, key_bits=bits)
    _close(got, FP.paged_flash_prefill_attention_plain(qc, *pool, table[3:], p0,
                                                       key_bits=bits), 2e-2)
    dense = _variant_kv((B, 2048, hkv, D), bits, bf16, seed=D * G + bits, dev=dev)
    got = QA.quant_decode_attention(q, *dense, length, key_bits=bits)
    _close(got, QA.quant_decode_attention_plain(q, *dense, length, key_bits=bits), 2e-2)
    after = K.launch_counts()
    for name in ("paged_quant_decode_attention", "paged_flash_prefill_attention",
                 "quant_decode_attention"):
        assert after[name] == counts[name] + 1, name


@pytest.mark.gpu
@pytest.mark.parametrize("bits,act,gs", [(4, 16, 128), (8, 16, 0), (4, 8, 32)])
def test_float_path_on_the_card_equals_the_cpu(dev, bits, act, gs):
    """The float path (A16, group-wise scales) on the card against the same
    call on the CPU: bf16 products summed in float32 in another order, TF32
    off (1e-5 relative on float32 outputs), for a linear and for experts
    with live-row counts and with ids; counted, no kernel launched."""
    cfg = Q.QuantConfig(weight_bits=bits, act_bits=act, group_size=gs)
    g = torch.Generator().manual_seed(bits + gs)
    pl = RP.pack_linear(Q.quantize(torch.randn((1536, 1000), generator=g) * 0.02, bits,
                                   group_size=gs))
    x = torch.randn((4, 1536), generator=g).bfloat16()
    pel = RP.pack_expert_linear(Q.quantize(torch.randn((4, 512, 300), generator=g) * 0.02,
                                           bits, group_size=gs))
    counts = torch.tensor([[5, 0], [1, 8], [8, 3], [0, 0]], dtype=torch.int32)
    xe = torch.randn((2, 4, 8, 512), generator=g)
    xe = (xe * (torch.arange(8)[None, None] < counts.t()[..., None])[..., None]).bfloat16()
    ids = torch.tensor([2, 2, 0, 3], dtype=torch.int32)
    xi = torch.randn((1, 4, 1, 512), generator=g).bfloat16()
    on = lambda t: RP.map_tree(lambda a: a.to(dev), t)
    d = PD.Dispatcher()
    K.reset_launch_counts()
    got = [d.linear(x.to(dev), on(pl), cfg, out_dtype=torch.float32),
           d.grouped_matmul(xe.to(dev), on(pel), cfg, out_dtype=torch.float32,
                            rows=counts.to(dev)),
           d.grouped_matmul(xi.to(dev), on(pel), cfg, out_dtype=torch.float32,
                            ids=ids.to(dev))]
    assert K.counts()["float_matmul"] == 3 and set(K.launch_counts().values()) == {0}
    want = [d.linear(x, pl, cfg, out_dtype=torch.float32),
            d.grouped_matmul(xe, pel, cfg, out_dtype=torch.float32, rows=counts),
            d.grouped_matmul(xi, pel, cfg, out_dtype=torch.float32, ids=ids)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# EngineLoop's step graphs (one CUDA graph per decode bucket and chunk size)
# ---------------------------------------------------------------------------

GRAPH_ARCHS = ("qwen2-7b@reduced", "moonshot-v1-16b-a3b@tiny-moe")


@pytest.fixture(scope="module")
def card_engines(tmp_path_factory):
    """arch -> a serving engine on the card (random weights, seed 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    built = {}

    def get(arch):
        if arch not in built:
            built[arch] = PE.build_engine(PR.get(arch), max_seq=64, device="cuda",
                                          flash_dir=str(tmp_path_factory.mktemp("flash")))
        return built[arch]
    return get


def _churn_trace(loop, vocab, n=16, seed=5):
    """Short prompts and budgets arriving over the first steps: rows finish
    and slots refill while others decode, so every bucket is met."""
    rng = np.random.default_rng(seed)
    sp = PSM.SamplingParams(temperature=0.0, max_new_tokens=8)
    reqs = [PE.Request(uid=i, sampling=sp, max_new_tokens=int(rng.integers(1, 9)),
                       prompt_tokens=[int(t) for t in rng.integers(
                           1, vocab, int(rng.integers(3, 40)))]) for i in range(n)]
    loop.run(reqs, arrivals=sorted(int(a) for a in rng.integers(0, 12, n)))
    return [r.generated for r in reqs]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_warmup_captures_one_graph_per_step_shape(card_engines, arch):
    loop = PE.EngineLoop(card_engines(arch), max_slots=4, prefill_chunk=16)
    rep = loop.warmup()
    assert rep["graphs"] == len(rep["decode_buckets"]) + len(rep["chunk_sizes"])
    assert rep["graphs"] == loop.compile_events() > 0
    assert loop.warmup()["graphs"] == rep["graphs"] == loop.compile_events()
    loop.close()
    assert loop.compile_events() == 0 and not loop.warmed


@pytest.mark.gpu
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_churny_trace_on_graphs_equals_eager(card_engines, arch):
    """8 slots: the graph loop captures nothing after warmup and commits the
    eager loop's greedy tokens; its kernels launch as often as the eager
    loop's (each replay adds what its capture recorded)."""
    eng = card_engines(arch)
    eager = PE.EngineLoop(eng, max_slots=8, prefill_chunk=16, cuda_graphs=False)
    eager.warmup()
    K.reset_launch_counts()
    want = _churn_trace(eager, eng.cfg.vocab_size)
    eager_counts = K.launch_counts()
    graphs = PE.EngineLoop(eng, max_slots=8, prefill_chunk=16)
    graphs.warmup()
    K.reset_launch_counts()
    assert _churn_trace(graphs, eng.cfg.vocab_size) == want
    assert K.launch_counts() == eager_counts
    assert eng.stats.recompiles_after_warmup == 0
    assert eng.dispatch.fallbacks == []
    graphs.close()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_step_functions_make_no_host_wait(card_engines, arch):
    """decode_step_bucketed and prefill_chunk_paged on device inputs under
    sync debug mode "error" (after a first call, which builds RoPE's table)."""
    eng = card_engines(arch)
    dev = eng.device
    loop = PE.EngineLoop(eng, max_slots=4, prefill_chunk=16)
    assert loop.pool.alloc_row(1, 24)
    loop.cache["table"].copy_(torch.from_numpy(loop.pool.table))
    emb_c = eng.embed(np.arange(1, 17)[None])
    emb_d = eng.embed(np.asarray([[3], [5], [7], [9]]))
    scal = torch.tensor([1, 0, 15], dtype=torch.int32, device=dev)
    idx = torch.tensor([1, 0, 2, 3], device=dev)
    act = torch.tensor([True, False, False, False], device=dev)

    def run():
        PT.prefill_chunk_paged(eng.params, eng.cfg, emb_c, loop.cache, scal[0:1],
                               scal[1:2], scal[2:3], eng.dispatch)
        PT.decode_step_bucketed(eng.params, eng.cfg, emb_d, loop.cache, idx,
                                eng.dispatch, active=act)
    run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_replay_launches_and_outputs_equal_an_eager_step(card_engines, arch):
    """One decode step (rows 0 and 2 active on pages of their own; the idle
    rows' all-trash table rows make them race for the trash page, which no
    active row reads) and one prompt chunk of row 2, through a replayed graph
    and eagerly, from the same state: the same launch counts and bit-equal
    logits and positions."""
    eng = card_engines(arch)
    loops = [PE.EngineLoop(eng, max_slots=4, prefill_chunk=16, cuda_graphs=g)
             for g in (False, True)]
    tok_d = np.asarray([[3], [5], [7], [9]])
    tok_c = np.arange(1, 17)[None]
    counts, outs = [], []
    for loop in loops:
        loop.warmup()
        assert loop.pool.alloc_row(0, 16) and loop.pool.alloc_row(2, 16)
        loop._upload_table(visible={0, 2})
        dec, chunk = loop._inputs[("decode", 4, False)], loop._inputs[("chunk", 16, False)]
        eng.embed(tok_d, out=dec["emb"])
        dec["rows"].put(np.asarray([[0, 1, 2, 3], [1, 0, 1, 0]]))
        eng.embed(tok_c, out=chunk["emb"])
        chunk["scal"].put((2, 0, 11))
        K.reset_launch_counts()
        loop._launch(("decode", 4, False))
        loop._launch(("chunk", 16, False))
        torch.cuda.synchronize()
        counts.append(K.launch_counts())
        outs.append((loop.logits.clone(), loop.cache["pos"].clone(),
                     loop._chunk_logits.clone()))
    assert counts[0] == counts[1]
    for name in ("w4a8_matmul", "paged_quant_decode_attention",
                 "paged_flash_prefill_attention", "rmsnorm"):
        assert counts[1][name] > 0, counts
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert outs[1][1].tolist() == [1, 0, 1, 0]
    loops[1].close()


@pytest.mark.gpu
def test_lora_graphs_follow_the_reference_retraces(card_engines):
    """Multi-LoRA on the graphs (qwen2-7b@reduced): a loop warmed with no
    adapter captures each shape once more, with LoRA, where the first
    adapter's trace meets it; a second adapter loaded after that captures
    nothing, and its replay reads the tables written in place (tokens equal
    an eager loop's); base rows keep their tokens; unloading every adapter
    captures nothing."""
    eng = card_engines("qwen2-7b@reduced")
    cfg, hd = eng.cfg, eng.cfg.resolved_head_dim
    rng = np.random.default_rng(0)

    def factors(r):
        return tuple((rng.normal(size=(cfg.d_model, r)).astype(np.float32) * 0.3,
                      rng.normal(size=(r, h * hd)).astype(np.float32) * 0.3)
                     for h in (cfg.num_heads, cfg.num_kv_heads))
    prompts = [[int(t) for t in rng.integers(1, 400, n)] for n in (20, 9)]
    sp = PSM.SamplingParams(temperature=0.0, max_new_tokens=6)

    def serve(loop, adapters):
        reqs = [PE.Request(uid=i, prompt_tokens=p, max_new_tokens=6, sampling=sp, adapter=a)
                for i, (p, a) in enumerate(zip(prompts, adapters))]
        loop.run(reqs)
        return [r.generated for r in reqs]
    graphs = PE.EngineLoop(eng, max_slots=4, prefill_chunk=16)
    n0 = graphs.warmup()["graphs"]
    try:
        base = serve(graphs, [None, None])
        eng.load_adapter("x", *factors(8))
        got = serve(graphs, [None, "x"])
        lora_keys = [k for k in graphs._graphs if k[2]]
        assert lora_keys and eng.stats.recompiles_after_warmup == len(lora_keys)
        assert got[0] == base[0] and got[1] != base[1]
        eng.load_adapter("y", *factors(4))
        got = serve(graphs, [None, "y"])
        assert eng.stats.recompiles_after_warmup == len(lora_keys)
        eager = PE.EngineLoop(eng, max_slots=4, prefill_chunk=16, cuda_graphs=False)
        assert serve(eager, [None, "y"]) == got and got[0] == base[0]
        for name in ("x", "y"):
            eng.lora_q.unload(name)
            eng.lora_v.unload(name)
        assert serve(graphs, [None, "x"]) == base
        assert graphs.compile_events() == n0 + len(lora_keys)
        assert eng.dispatch.fallbacks == []
    finally:
        for name in list(eng.lora_q._names):
            eng.lora_q.unload(name)
            eng.lora_v.unload(name)
        graphs.close()


# ---------------------------------------------------------------------------
# the Flash tier: staging pages past the trash page, pinned page copies, waves
# ---------------------------------------------------------------------------

def _staging_pool(dev, n_pages=6, staging=6, hkv=4, D=128, seed=0):
    """A pool of 128-key pages laid out as the serving loop's: ``n_pages``
    pool pages, the trash page, then the staging reserve, all filled."""
    geom = KP.PoolGeometry(page_size=128, num_pages=n_pages, pages_per_row=8,
                           staging_pages=staging)
    rng = np.random.default_rng(seed)
    P = geom.total_device_pages
    k = torch.from_numpy(rng.normal(size=(P, 128, hkv, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(P, 128, hkv, D)).astype(np.float32))
    kq, ks, kz = KV.quantize_keys(k.bfloat16())
    pool = tuple(t.contiguous().to(dev) for t in (kq, ks, kz, KV.cast_values(v, Q.FP8_DTYPE)))
    return geom, pool


@pytest.mark.gpu
@pytest.mark.parametrize("G,hkv", [(7, 4), (1, 16)])
def test_paged_kernels_read_staging_pages(dev, G, hkv):
    """Tables that mix pool pages and staging pages (ids past the trash
    page), as a decode wave uploads them: both paged kernels equal their
    plain versions."""
    D = 128
    geom, pool = _staging_pool(dev, hkv=hkv, seed=G)
    s0, trash = geom.staging_base, geom.trash_page
    table = np.full((3, geom.pages_per_row), trash, np.int32)
    table[0, :5] = [s0 + 3, 0, s0, 4, s0 + 5]
    table[1, :3] = [2, s0 + 1, 5]
    table[2, :6] = [s0 + 2, s0 + 4, 1, 3, s0 + 3, s0]
    table = torch.from_numpy(table).to(dev)
    length = torch.tensor([600, 300, 700], dtype=torch.int32, device=dev)
    base = torch.zeros((3,), dtype=torch.int32, device=dev)
    q = (torch.randn((3, hkv * G, D), device=dev) / math.sqrt(D)).bfloat16()
    _close(QA.paged_quant_decode_attention(q, *pool, table, base, length),
           QA.paged_quant_decode_attention_plain(q, *pool, table, base, length), 2e-2)
    qc = (torch.randn((1, 64, hkv * G, D), device=dev) / math.sqrt(D)).bfloat16()
    p0 = torch.tensor([640], dtype=torch.int32, device=dev)
    _close(FP.paged_flash_prefill_attention(qc, *pool, table[2:3], p0),
           FP.paged_flash_prefill_attention_plain(qc, *pool, table[2:3], p0), 2e-2)


@pytest.mark.gpu
def test_page_spill_stage_restore_bit_exact(dev, tmp_path):
    """Pages of a stacked pool (fp8 values included) to Flash through pinned
    memory, back into staging pages and into fresh pool pages: bit for bit,
    the pool tensors keep their storage, and the writes make no host wait."""
    geom = KP.PoolGeometry(page_size=128, num_pages=8, pages_per_row=8,
                           staging_pages=4)
    pool = KP.init_paged_layer(geom, 4, 128, layers=3, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    pool.k_q.copy_(torch.randint(-128, 128, pool.k_q.shape, generator=gen, device=dev))
    pool.k_scale.copy_(torch.rand(pool.k_scale.shape, generator=gen, device=dev))
    pool.k_zero.copy_(torch.randn(pool.k_zero.shape, generator=gen, device=dev))
    pool.v.copy_((torch.randn(pool.v.shape, generator=gen, device=dev) * 100
                  ).to(Q.FP8_DTYPE))
    ptrs = [getattr(pool, f).data_ptr() for f in KP.KV_FIELDS]
    want = {f: KP._bytes_view(getattr(pool, f)).clone() for f in KP.KV_FIELDS}
    store = HS.PageSpillStore(HS.FlashStore(str(tmp_path), HS.FlashSpec(simulate=False)))
    try:
        src = [5, 0, 3]
        store.put(1, "s0p0", KP.read_pages(pool, src), pages=3)
        sids = [geom.staging_base + i for i in (2, 0, 3)]
        got = store.fetch(1, "s0p0")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            KP.write_pages(pool, sids, got)          # staging
            KP.write_pages(pool, [7, 6, 1], got)     # a restore into fresh pages
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        for f in KP.KV_FIELDS:
            x = KP._bytes_view(getattr(pool, f))
            assert torch.equal(x[:, sids], want[f][:, src]), f
            assert torch.equal(x[:, [7, 6, 1]], want[f][:, src]), f
        assert [getattr(pool, f).data_ptr() for f in KP.KV_FIELDS] == ptrs
    finally:
        store.close()


def _spill_trace(loop, vocab):
    """4 rows whose KV outgrows a 6-page pool with prefix sharing off: cold
    pages spill and the decode needs several staging waves."""
    rng = np.random.default_rng(23)
    sp = PSM.SamplingParams(temperature=0.0, max_new_tokens=20)
    reqs = [PE.Request(uid=i, sampling=sp, max_new_tokens=20,
                       prompt_tokens=[int(t) for t in rng.integers(1, vocab, 30)])
            for i in range(4)]
    waves = []
    plan = loop._plan_waves

    def plan_waves(slots):
        out = plan(slots)
        waves.append(len(out))
        return out
    loop._plan_waves = plan_waves
    loop.run(reqs)
    return [r.generated for r in reqs], waves


@pytest.mark.gpu
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_spill_waves_on_graphs_equal_eager(card_engines, arch):
    """Waves replay the bucket graphs captured at warmup: the warmed loop
    commits the eager loop's tokens, with cold spills, 2+ waves, the same
    launch counts and no capture after warmup; the reserve comes back whole."""
    eng = card_engines(arch)
    pb = RP.kv_page_bytes(eng.cfg, RP.kv_page_size(eng.max_seq))
    kw = dict(max_slots=4, dram_budget_bytes=6 * pb, prefix_sharing=False)
    eager = PE.EngineLoop(eng, cuda_graphs=False, **kw)
    K.reset_launch_counts()
    eng.stats = PE.EngineStats()
    want, eager_waves = _spill_trace(eager, eng.cfg.vocab_size)
    eager_counts = K.launch_counts()
    assert eng.stats.cold_spilled_pages > 0 and max(eager_waves) >= 2
    eager.close()
    graphs = PE.EngineLoop(eng, **kw)
    graphs.warmup()
    K.reset_launch_counts()
    eng.stats = PE.EngineStats()
    got, waves = _spill_trace(graphs, eng.cfg.vocab_size)
    assert got == want and waves == eager_waves
    assert K.launch_counts() == eager_counts
    assert eng.stats.recompiles_after_warmup == 0
    assert graphs.pool.staged_count == 0 and graphs.spill.pages_on_flash == 0
    assert eng.dispatch.fallbacks == []
    graphs.close()


@pytest.mark.gpu
def test_no_spill_decode_step_makes_one_sync(card_engines):
    """With the Flash tier in place, a warmed loop's decode step that needs
    no staging still makes one host wait: sampling's."""
    import warnings
    eng = card_engines("qwen2-7b@reduced")
    loop = PE.EngineLoop(eng, max_slots=4, prefill_chunk=16)
    loop.warmup()
    sp = PSM.SamplingParams(temperature=0.0, max_new_tokens=16)
    for i in range(4):
        loop.submit(PE.Request(uid=i, prompt_tokens=[3 + i, 5, 7, 9], max_new_tokens=16,
                               sampling=sp))
    while loop._prefilling or sum(r is not None for r in loop.scheduler.running) < 4:
        loop.step()
    loop.step()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            loop.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught
             if "synchroniz" in str(w.message) and "prototype" not in str(w.message)]
    assert len(syncs) == 1, [f"{w.filename}:{w.lineno}" for w in syncs]
    assert loop.pool.flash_page_count == 0
    loop.drain()
    loop.close()


# ---------------------------------------------------------------------------
# weight and expert streaming: ring slots written in place
# ---------------------------------------------------------------------------

def _meta_skeleton(stack):
    return RP.map_tree(lambda t: torch.empty(t.shape[1:], dtype=t.dtype, device="meta"),
                       stack)


@pytest.mark.gpu
def test_ring_install_lands_in_place(dev, tmp_path):
    """Groups of int8, float32 and bf16 leaves (odd sizes) read into pinned
    memory by the prefetch worker and installed into ring slots: bit for bit,
    each slot keeps its storage, and an install makes no host wait."""
    gen = torch.Generator(device=dev).manual_seed(0)
    stack = ({"a": torch.randint(-128, 128, (3, 64, 48), dtype=torch.int8, device=dev,
                                 generator=gen),
              "b": torch.randn((3, 17), device=dev, generator=gen),
              "c": torch.randn((3, 5, 9), device=dev, generator=gen).bfloat16()},)
    leaves = [t for _p, t in RP.tree_leaves_with_path(stack)]
    store = HS.WeightGroupStore(HS.FlashStore(str(tmp_path), HS.FlashSpec(simulate=False)),
                               pin_memory=True)
    try:
        for g in range(3):
            store.put_group(0, g, [t[g] for t in leaves])
        ring = PE.WeightRing(store, 0, 3, 2, _meta_skeleton(stack), dev)
        ptrs = [b.data_ptr() for b in ring.buffers]
        for g in (0, 1, 2, 0):
            ring.prefetch(g)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                tree = ring.obtain(g)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            for (_p, got), want in zip(RP.tree_leaves_with_path(tree), leaves):
                assert got.dtype == want.dtype and torch.equal(got, want[g])
        assert [b.data_ptr() for b in ring.buffers] == ptrs
        assert ring.installs == 4 and store.prefetch_hits == 4
        assert store.fetch_group(0, 1).buffer.is_pinned()
    finally:
        store.drop_all()


def _same_weights(arch, tmp_path, dev, budget_of):
    """A resident engine and a streamed one on the same weights (seed 0)."""
    cfg = PR.get(arch)
    res = PE.build_engine(cfg, seed=0, max_seq=64, device=dev, flash_dir=str(tmp_path))
    params = PT.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                            quantized=True)
    pol = RP.weight_stream_policy(cfg, params)
    st = PE.Engine(cfg, params, res.embedding, max_seq=64, device=dev,
                   weight_dram_budget_bytes=budget_of(pol.head_bytes,
                                                      pol.resident_bytes - pol.head_bytes))
    return res, st


@pytest.mark.gpu
def test_streamed_step_logits_equal_resident(dev, tmp_path):
    """qwen2-7b@tiny, 6 groups through a 2-slot ring: one prompt (two
    chunks) and the decode steps after it give bit-equal logits to the
    resident engine's, with no fallback."""
    res, st = _same_weights("qwen2-7b@tiny", tmp_path, dev, lambda head, _s: head)
    assert st.weight_policy.streamed[0].ring_groups == 2
    loops = [PE.EngineLoop(e, max_slots=1, prefill_chunk=16, cuda_graphs=False)
             for e in (res, st)]
    sp = PSM.SamplingParams(temperature=0.0, max_new_tokens=3)
    for loop in loops:
        loop.submit(PE.Request(uid=0, prompt_tokens=list(range(3, 23)), max_new_tokens=3,
                               sampling=sp))
    while loops[0].has_work():
        for loop in loops:
            loop.step()
        torch.cuda.synchronize()
        assert torch.equal(loops[0]._chunk_logits, loops[1]._chunk_logits)
        assert torch.equal(loops[0].logits, loops[1].logits)
    assert not loops[1].has_work()
    assert res.dispatch.fallbacks == [] and st.dispatch.fallbacks == []
    for loop in loops:
        loop.close()
    st.close()


@pytest.mark.gpu
def test_expert_ring_rerun_equals_resident(dev, tmp_path):
    """moonshot@tiny-moe with its experts streamed and the prediction
    emptied before every step: each decode visit runs its group again after
    installing the routed experts, and the logits equal the resident
    engine's bit for bit."""
    res, st = _same_weights("moonshot-v1-16b-a3b@tiny-moe", tmp_path, dev,
                            lambda head, stack: head + stack // 3)
    assert st.weight_policy.streamed[0].experts == 8
    loops = [PE.EngineLoop(e, max_slots=4, prefill_chunk=16, cuda_graphs=False)
             for e in (res, st)]
    sp = PSM.SamplingParams(temperature=0.0, max_new_tokens=6)
    for loop in loops:
        for i in range(3):
            loop.submit(PE.Request(uid=i, prompt_tokens=list(range(2 + i, 12 + 2 * i)),
                                   max_new_tokens=6, sampling=sp))
    while loops[0].has_work():
        for k in loops[1]._expert_pred:
            loops[1]._expert_pred[k] = set()
        for loop in loops:
            loop.step()
        torch.cuda.synchronize()
        assert torch.equal(loops[0].logits, loops[1].logits)
    assert loops[1].expert_reruns > 0 and st.stats.expert_prefetch_misses > 0
    assert res.dispatch.fallbacks == [] and st.dispatch.fallbacks == []
    for loop in loops:
        loop.close()
    st.close()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma3-27b@tiny", "rwkv6-7b@tiny"])
def test_streamed_windowed_and_recurrent_steps_equal_resident(dev, tmp_path, arch):
    """A stack of windowed layers (gemma3-27b@tiny) or of rwkv layers
    (rwkv6-7b@tiny) through a 2-slot ring: two rows, the second admitted
    while the first decodes (decode steps beside a row mid-prefill), give
    the resident engine's chunk and decode logits bit for bit, with no
    fallback."""
    res, st = _same_weights(arch, tmp_path, dev, lambda head, _s: head)
    assert st.weight_policy.streamed[0].ring_groups == 2
    loops = [PE.EngineLoop(e, max_slots=2, prefill_chunk=16, prefill_token_budget=16,
                           cuda_graphs=False) for e in (res, st)]
    sp = PSM.SamplingParams(temperature=0.0, max_new_tokens=6)
    for loop in loops:
        loop.submit(PE.Request(uid=0, prompt_tokens=list(range(3, 23)), max_new_tokens=6,
                               sampling=sp))
    steps = 0
    while loops[0].has_work():
        if steps == 2:
            for loop in loops:
                loop.submit(PE.Request(uid=1, prompt_tokens=list(range(40, 77)),
                                       max_new_tokens=4, sampling=sp))
        for loop in loops:
            loop.step()
        torch.cuda.synchronize()
        assert torch.equal(loops[0]._chunk_logits, loops[1]._chunk_logits)
        assert torch.equal(loops[0].logits, loops[1].logits)
        steps += 1
    assert not loops[1].has_work() and st.stats.weight_group_hits > 0
    assert res.dispatch.fallbacks == [] and st.dispatch.fallbacks == []
    for loop in loops:
        loop.close()
    st.close()


def expert_rerun_case(device, flash_dir):
    """An all-MoE jamba-1.5-large-398b@tiny (every period layer's FFN an MoE
    one, so its stack streams per expert) on ``device``: decode group 1 of
    its expert-granular streamed loop runs with an empty expert prediction,
    so its first run meets cold experts and it runs again.  Returns ((x,
    recurrent state leaves) after that, the same after one run of the
    resident layer slice from the same state, the re-runs, the fallbacks)."""
    cfg = PR.get("jamba-1.5-large-398b@tiny")
    cfg = dataclasses.replace(cfg, period=tuple(dataclasses.replace(p, moe=True)
                                                for p in cfg.period))
    dev = torch.device(device)
    res = PE.build_engine(cfg, max_seq=64, device=dev, flash_dir=flash_dir)
    eng = PE.Engine(cfg, res.params, res.embedding, max_seq=64, device=dev,
                    weight_dram_budget_bytes=1)
    try:
        (spl,) = eng.weight_policy.streamed
        assert spl.experts == cfg.num_experts and spl.stack == 0
        loop = PE.EngineLoop(eng, max_slots=4, cuda_graphs=False)
        g, B = 1, 4
        gen = torch.Generator().manual_seed(3)
        states = [leaf for e in loop.cache["stacks"][0] if isinstance(e, dict)
                  for leaf in e.values()]
        for leaf in states:
            leaf.copy_(torch.randn(leaf.shape, generator=gen).to(leaf.dtype))
        start = [t.clone() for t in states]
        x = (torch.randn((B, 1, cfg.d_model), generator=gen) * 0.5).bfloat16().to(dev)
        pos = torch.tensor([5, 9, 2, 7], dtype=torch.int32, device=dev)
        table = loop.cache["table"][:B]
        kw = dict(active=torch.ones(B, dtype=torch.bool, device=dev),
                  rows=torch.arange(B, device=dev))
        loop._host_active[:] = True
        loop._expert_pred[(0, g)] = set()
        runs0 = loop.expert_reruns
        out = loop._run_expert_group(loop._expert_rings[0], spl, 0, g, "decode", x,
                                     pos[:, None], pos, table, None, kw)
        got = (out.clone(), [t.clone() for t in states])
        for t, s in zip(states, start):
            t.copy_(s)
        gp = tuple(PT.layer_slice(p, g) for p in res.params["stacks"][0])
        one = PT.run_stack_group(gp, cfg, 0, "decode", x, pos[:, None], loop.cache, g, pos,
                                 table, eng.dispatch, **kw)
        loop.close()
        return (got, (one, [t.clone() for t in states]), loop.expert_reruns - runs0,
                eng.dispatch.fallbacks)
    finally:
        eng.close()


@pytest.mark.gpu
def test_expert_group_rerun_leaves_mamba_state_as_one_run(dev, tmp_path):
    (x, st), (x1, st1), reruns, fallbacks = expert_rerun_case(dev, str(tmp_path))
    torch.cuda.synchronize()
    assert reruns >= 1 and fallbacks == []
    assert torch.equal(x, x1)
    assert all(torch.equal(a, b) for a, b in zip(st, st1))


# ---------------------------------------------------------------------------
# sliding-window attention (gemma3-27b's local layers)
# ---------------------------------------------------------------------------

def _ring_pool(B, hkv, D, window, ps, seed, dev):
    """A windowed pool of ``B`` rows' rings and the spare ring, its pages
    filled with quantized random keys and values."""
    ppw = KP.pages_per_window(window, ps)
    rng = np.random.default_rng(seed)
    P = (B + 1) * ppw
    k = torch.from_numpy(rng.normal(size=(P, ps, hkv, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(P, ps, hkv, D)).astype(np.float32))
    kq, ks, kz = KV.quantize_keys(k.bfloat16())
    return KP.PagedLayerKV(*(t.contiguous().to(dev) for t in
                             (kq, ks, kz, KV.cast_values(v, Q.FP8_DTYPE))),
                           window=window, ppw=ppw)


@pytest.mark.gpu
@pytest.mark.parametrize("G,hkv", [(2, 16), (7, 4), (16, 2)])
@pytest.mark.parametrize("window,ps,lengths", [
    (1024, 128, [700, 1, 1025, 64]),          # negative bases: the ring not yet full
    (1024, 128, [1500, 1152, 1153, 2047]),    # positive bases: the ring wrapped
    (100, 16, [5, 99, 100, 101]),             # a window that is not a whole page
    (16, 16, [16, 17, 33, 300])])
def test_paged_decode_kernel_over_ring_views(dev, G, hkv, window, ps, lengths):
    """Kernel 2 over ``kv_pool.ring_view``'s table and base, window-masked,
    against its plain version; the output is allocated over NaN through the
    launch, so a row the kernel leaves unwritten fails."""
    B, D = len(lengths), 128
    pool = _ring_pool(B, hkv, D, window, ps, G + window + lengths[0], dev)
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    table, base = KP.ring_view(pool, length, B)
    q = (torch.randn((B, hkv * G, D), device=dev) / math.sqrt(D)).bfloat16()
    args = (q, pool.k_q, pool.k_scale, pool.k_zero, pool.v, table, base, length)
    got = QA.paged_quant_decode_attention(*args, window=window)
    assert torch.isfinite(got).all()
    _close(got, QA.paged_quant_decode_attention_plain(*args, window=window), 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("G,hkv", [(2, 16), (7, 4)])
@pytest.mark.parametrize("window,pos", [(1024, [1153, 2000, 1024, 300]), (16, [40, 17, 16, 3])])
def test_dense_decode_kernel_over_a_wrapped_ring(dev, G, hkv, window, pos):
    """Kernel 6 through the dispatcher over a dense ring that has wrapped
    (``pos`` past the ring's slots for most rows): it attends over the
    ring's min(pos, S) live slots, and equals the plain ring path -- the
    reference's ``slot_positions >= 0`` mask over the same slots."""
    from repro_torch.core.precision import DEFAULT_POLICY
    from repro_torch.runtime import dispatch as RD
    B, D = len(pos), 128
    cache = KV.init_layer_cache(B, 2048, hkv, D, window=window, per_row=True, device=dev)
    src = _dense_cache(B, window, hkv, D, dev, window + G)
    for f, t in zip(("k_q", "k_scale", "k_zero", "v"), src):
        getattr(cache, f).copy_(t)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    q = (torch.randn((B, 1, hkv * G, D), device=dev) / math.sqrt(D)).bfloat16()
    before = QA.quant_decode_attention.launches
    got = RD.Dispatcher().decode_attention(q, cache, p, DEFAULT_POLICY)
    assert QA.quant_decode_attention.launches == before + 1
    live = KV.slot_positions(cache, p) >= 0
    assert torch.equal(live.sum(-1), torch.clamp(p, max=window))
    want = RD.Dispatcher("reference").decode_attention(q, cache, p, DEFAULT_POLICY)
    _close(got, want, 2e-2)


@pytest.mark.gpu
def test_windowed_chunk_is_captured_in_a_cuda_graph(dev):
    """``kv_pool.paged_prefill_window_ref`` (plain PyTorch by design: the
    reference has no TPU kernel for it) with its row, offset and length as
    device scalars: captured in a CUDA graph and replayed for new values
    filled in place, it equals the same chunk run eagerly, bit for bit."""
    hkv, G, D, window, ps = 16, 2, 128, 1024, 128
    pool = _ring_pool(4, hkv, D, window, ps, 3, dev)
    q = (torch.randn((1, 128, hkv * G, D), device=dev) / math.sqrt(D)).bfloat16()
    slot, pos0, vl = (torch.zeros((1,), dtype=torch.int32, device=dev) for _ in range(3))
    fn = lambda: KP.paged_prefill_window_ref(q, pool, slot, pos0, vl, window, 16)
    for t, v in zip((slot, pos0, vl), (1, 256, 128)):
        t.fill_(v)
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for s_, p_, v_ in ((1, 256, 128), (2, 1152, 128), (0, 1900, 37), (3, 0, 8)):
        for t, v in zip((slot, pos0, vl), (s_, p_, v_)):
            t.fill_(v)
        graph.replay()
        torch.cuda.synchronize()
        eager = KP.paged_prefill_window_ref(q, pool, s_, p_, v_, window, 16)
        assert torch.equal(out[:, :v_], eager[:, :v_]), (s_, p_, v_)
    del graph


@pytest.mark.gpu
def test_training_functions_at_qwen2_1_5b_shapes(dev):
    """The two kernels of the training forward under their
    ``autograd.Function``s at qwen2-1.5b's training shapes (4 x 512 tokens,
    d_model 1536; 12 query heads over 2 KV heads of 128, causal): the
    forward launches the kernel and equals the plain version within the
    kernel tolerance; every input gradient equals autograd of the plain
    version on the same inputs (the backward recomputes exactly that)."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((4, 512, 1536), generator=g, device=dev).bfloat16()
    w = 1 + 0.1 * torch.randn((1536,), generator=g, device=dev)
    q = (torch.randn((4, 512, 12, 128), generator=g, device=dev) / math.sqrt(128)).bfloat16()
    k = torch.randn((4, 512, 2, 128), generator=g, device=dev).bfloat16()
    v = torch.randn((4, 512, 2, 128), generator=g, device=dev).bfloat16()
    cases = [("rmsnorm", RN.RMSNormFunction.apply, (1e-6,),
              lambda a, b: RN.rmsnorm_plain(a, b, 1e-6), (x, w)),
             ("flash_prefill_attention", FP.FlashPrefillFunction.apply, (True, 0),
              lambda a, b, c: FP.flash_prefill_attention_plain(a, b, c, causal=True), (q, k, v))]
    for name, fn, extra, plain, inputs in cases:
        a = [t.clone().requires_grad_(True) for t in inputs]
        b = [t.clone().requires_grad_(True) for t in inputs]
        before = K.launch_counts()[name]
        ya = fn(*a, *extra)
        assert K.launch_counts()[name] == before + 1 and ya.grad_fn is not None
        yb = plain(*b)
        _close(ya.detach(), yb.detach(), 2e-2)
        grad = torch.randn(ya.shape, generator=g, device=dev).to(ya.dtype)
        ya.backward(grad)
        yb.backward(grad)
        for ta, tb in zip(a, b):
            _close(ta.grad, tb.grad, 1e-5)


@pytest.mark.gpu
def test_training_functions_of_the_other_layer_kinds(dev):
    """Kernel 7 windowed and non-causal under ``FlashPrefillFunction`` and
    kernel 6 under ``QuantDecodeAttentionFunction`` over a cache built out
    of place (``quantized_cache``: fp8 values and the keys' scale and zero
    carry a gradient; 64 query tokens folded into the head axis, as cross
    attention calls it): the forward launches the kernel and equals the
    plain version within the kernel tolerance; every input gradient equals
    autograd of the plain version on the same inputs; the dispatcher takes
    the Function for a cross cache that requires grad."""
    g = torch.Generator(device=dev).manual_seed(3)
    q = (torch.randn((1, 96, 4, 128), generator=g, device=dev) / math.sqrt(128)).bfloat16()
    k = torch.randn((1, 96, 2, 128), generator=g, device=dev).bfloat16()
    qn = (torch.randn((2, 32, 4, 64), generator=g, device=dev) / 8).bfloat16()
    kn = torch.randn((2, 32, 4, 64), generator=g, device=dev).bfloat16()
    for (qq, kk, causal, window) in ((q, k, True, 32), (qn, kn, False, 0)):
        a = [t.clone().requires_grad_(True) for t in (qq, kk, kk)]
        b = [t.clone().requires_grad_(True) for t in (qq, kk, kk)]
        before = K.launch_counts()["flash_prefill_attention"]
        ya = FP.FlashPrefillFunction.apply(*a, causal, window)
        assert K.launch_counts()["flash_prefill_attention"] == before + 1
        yb = FP.flash_prefill_attention_plain(*b, causal=causal, window=window)
        _close(ya.detach(), yb.detach(), 2e-2)
        grad = torch.randn(ya.shape, generator=g, device=dev)
        ya.backward(grad)
        yb.backward(grad)
        for ta, tb in zip(a, b):
            _close(ta.grad, tb.grad, 1e-5)
    kx = torch.randn((2, 32, 4, 64), generator=g, device=dev).bfloat16()
    vx = (0.1 * torch.randn((2, 32, 4, 64), generator=g, device=dev)).bfloat16()
    qd = (torch.randn((2, 4 * 64, 64), generator=g, device=dev) / 8).bfloat16()
    grads = []
    for use_fn in (True, False):
        kk, vv, qq = (t.clone().requires_grad_(True) for t in (kx, vx, qd))
        c = KV.quantized_cache(kk, vv)
        args = (qq, c.k_q, c.k_scale, c.k_zero, c.v, c.length)
        before = K.launch_counts()["quant_decode_attention"]
        y = (QA.QuantDecodeAttentionFunction.apply(*args, 8) if use_fn
             else QA.quant_decode_attention_plain(*args))
        assert K.launch_counts()["quant_decode_attention"] == before + int(use_fn)
        y.backward(torch.ones_like(y) * 1e-2)
        grads.append((y.detach(), qq.grad, kk.grad, vv.grad))
    (ya, *ga), (yb, *gb) = grads
    _close(ya, yb, 2e-2)
    for ta, tb in zip(ga, gb):
        _close(ta, tb, 1e-5)
    kk, vv = kx.clone().requires_grad_(True), vx.clone().requires_grad_(True)
    c = KV.quantized_cache(kk, vv)
    with pytest.raises(RuntimeError, match="autograd Function"):
        QA.quant_decode_attention(qd, c.k_q, c.k_scale, c.k_zero, c.v, c.length)
    out = PD.Dispatcher().decode_attention(qd.reshape(2, 64, 4, 64), c, c.length,
                                           DEFAULT_POLICY, causal=False)
    assert out.grad_fn is not None and out.shape == (2, 64, 4, 64)


@pytest.mark.gpu
def test_kernel_wrappers_refuse_inputs_that_require_grad(dev):
    """A wrapper's output carries no gradient, so on the card a call with
    an input that requires grad under grad mode raises; under no_grad it
    launches, and the dispatcher routes training calls through the
    Functions (an output with a ``grad_fn``)."""
    x = torch.randn((8, 256), device=dev).bfloat16().requires_grad_(True)
    w = torch.ones((256,), device=dev)
    with pytest.raises(RuntimeError, match="autograd Function"):
        RN.rmsnorm(x, w, 1e-6)
    q = torch.randn((1, 16, 4, 64), device=dev).bfloat16().requires_grad_(True)
    kv = torch.randn((1, 16, 2, 64), device=dev).bfloat16()
    with pytest.raises(RuntimeError, match="autograd Function"):
        FP.flash_prefill_attention(q, kv, kv)
    with torch.no_grad():
        RN.rmsnorm(x, w, 1e-6)
        FP.flash_prefill_attention(q, kv, kv)
    disp = PD.Dispatcher()
    assert disp.rmsnorm(x, w, 1e-6).grad_fn is not None
    assert disp.prefill_attention(q, kv, kv, causal=True, window=0,
                                  policy=DEFAULT_POLICY).grad_fn is not None


@pytest.mark.gpu
def test_train_step_kernel_route_matches_plain_route(dev):
    """One training step of qwen2-7b@tiny on the card: the kernel route's
    loss and gradients against ``Dispatcher(backend="reference")`` on the
    same parameters and batch (the chip script's tolerances), kernels 4 and
    7 launched in the forward and in remat's recompute."""
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_loop as TL
    cfg = PR.get("qwen2-7b@tiny")
    params = PT.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 64), generator=g, device=dev),
             "labels": torch.randint(0, cfg.vocab_size, (2, 64), generator=g, device=dev)}
    K.reset_launch_counts()
    (kt, _), kg = TL.value_and_grad(params, cfg, batch, PT.StepCtx(cfg, remat=True))
    counts = K.launch_counts()
    assert counts["rmsnorm"] == 4 * cfg.num_layers + 1, counts
    assert counts["flash_prefill_attention"] == 2 * cfg.num_layers, counts
    (pt, _), pg = TL.value_and_grad(params, cfg, batch, PT.StepCtx(
        cfg, remat=True, dispatch=PD.Dispatcher("reference")))
    assert abs(float(kt) - float(pt)) < 1e-3 * abs(float(pt))
    for a, b in zip(O.leaves(pg), O.leaves(kg)):
        rel = float(torch.linalg.vector_norm(a.float() - b.float())
                    / torch.linalg.vector_norm(a.float()))
        assert rel < 2e-2, rel


@pytest.mark.gpu
def test_ops_on_the_card_match_the_oracles(dev):
    """``kernels.ops`` on CUDA tensors launches kernels 1, 4, 6 and 7
    (counted) and matches ``kernels.ref`` on the same inputs, at the
    kernel-vs-plain tolerances; a float32 query, which the kernels do not
    read, raises instead of falling back."""
    from repro_torch.kernels import ops as OPS
    from repro_torch.kernels import ref as REF
    g = torch.Generator(device=dev).manual_seed(5)
    K.reset_launch_counts()
    for M, bits in ((4, 4), (40, 8)):
        x = torch.randn((M, 512), generator=g, device=dev).bfloat16()
        pl = RP.pack_linear(Q.quantize(torch.randn((512, 768), generator=g, device=dev)
                                       * 0.02, bits))
        y = OPS.quant_matmul_kernel(x, pl.data, pl.scale[0], pl.zero[0], bits=bits)
        xq, sx = Q.quantize_activations(x)
        wq = Q.unpack_int4(pl.data) if bits == 4 else pl.data
        _close(y, REF.w4a8_matmul_ref(xq, sx, wq, pl.scale[0], pl.zero[0]), 1e-4)
    x = torch.randn((4, 3584), generator=g, device=dev).bfloat16()
    w = 1.0 + 0.1 * torch.randn((3584,), generator=g, device=dev)
    _close(OPS.rmsnorm(x, w, 1e-6), REF.rmsnorm_ref(x, w, 1e-6), 2e-2)
    B, S, Hkv, G, Dh = 2, 256, 2, 4, 64
    q = (torch.randn((B, Hkv * G, Dh), generator=g, device=dev) / 8).bfloat16()
    kq, ks, kz = KV.quantize_keys(torch.randn((B, S, Hkv, Dh), generator=g,
                                              device=dev).bfloat16())
    v = KV.cast_values(torch.randn((B, S, Hkv, Dh), generator=g, device=dev), Q.FP8_DTYPE)
    length = torch.tensor([200, 77], dtype=torch.int32, device=dev)
    cache = (kq.contiguous(), ks.contiguous(), kz.contiguous(), v)
    _close(OPS.quant_decode_attention(q, *cache, length),
           REF.quant_decode_attention_ref(q, *cache, length), 2e-2)
    with pytest.raises(TypeError):
        OPS.quant_decode_attention(q.float(), *cache, length)
    qp = (torch.randn((1, 100, 8, 64), generator=g, device=dev) / 8).bfloat16()
    kp = torch.randn((1, 100, 2, 64), generator=g, device=dev).bfloat16()
    vp = torch.randn((1, 100, 2, 64), generator=g, device=dev).bfloat16()
    for causal, window in ((True, 0), (False, 0), (True, 16)):
        _close(OPS.flash_prefill(qp, kp, vp, causal=causal, window=window),
               REF.flash_prefill_ref(qp, kp, vp, causal=causal, window=window), 2e-2)
    counts = K.counts()
    assert counts["w4a8_matmul"] == 2 and counts["rmsnorm"] == 1, counts
    assert counts["quant_decode_attention"] == 1, counts
    assert counts["flash_prefill_attention"] == 3, counts


@pytest.mark.gpu
def test_fused_geometry_plan_on_the_card_equals_composed_ops(dev):
    """A transpose -> slice -> transpose chain over one layer's keys (512
    tokens, 4 heads of 128: the largest space the reference's Rule 2
    fuses) fuses to one Region and moves the composed ops' bytes exactly."""
    from repro_torch.core import geometry as GEO
    x = torch.randn((512, 4, 128), generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev).bfloat16()
    chain = [GEO.region_transpose((512, 4, 128), (1, 0, 2)),
             GEO.region_slice((4, 512, 128), (1, 128, 0), (2, 256, 128)),
             GEO.region_transpose((2, 256, 128), (1, 0, 2))]
    plan = GEO.fuse_chain(chain, [2 ** 18, 2 ** 16, 2 ** 16])
    assert plan.num_stages == 1
    assert 2 * plan.memory_ops <= sum(2 * r.numel for step in chain for r in step)
    want = x.permute(1, 0, 2)[1:3, 128:384].permute(1, 0, 2)
    got = GEO.execute_plan(plan, x)
    assert got.device == x.device and torch.equal(got.reshape(want.shape), want)


@pytest.mark.gpu
@pytest.mark.parametrize("ctx", [1536, 8704])
def test_dense_decode_over_history_joined_from_flash(dev, tmp_path, ctx):
    """§4.1's spill at qwen2-7b's shape (G = 7, 4 KV heads of 128, one row
    of ctx + 128 slots): the tokens before the last 512 go to a
    ``KVSpillManager`` in blocks of 128 and come back, joined on the card
    ahead of the device part; kernel 6 over the joined cache gives the
    unspilled cache's output bit for bit (same bytes, same split)."""
    S, cut = ctx + 128, ctx - 512
    kq, ks, kz, v = _dense_cache(1, S, 4, 128, dev, ctx)
    q = (torch.randn((1, 28, 128), device=dev) / math.sqrt(128)).bfloat16()
    length = torch.tensor(ctx + 1, dtype=torch.int32, device=dev)
    want = QA.quant_decode_attention(q, kq, ks, kz, v, length)
    mgr = HS.KVSpillManager(HS.FlashStore(str(tmp_path), HS.FlashSpec(simulate=False)),
                            1, 4, 128, dram_budget_tokens=512, block_tokens=128)
    try:
        hk, hv = kq[:, :cut].cpu().numpy(), v[:, :cut].view(torch.uint8).cpu().numpy()
        for start in range(0, cut, 128):
            mgr.spill(0, hk[:, start:start + 128], hv[:, start:start + 128], start)
        mgr.prefetch_async(0)
        gk, gv = mgr.gather(0)
    finally:
        mgr.drop_all()
    jk = torch.cat([torch.from_numpy(gk).to(dev), kq[:, cut:]], 1)
    jv = torch.cat([torch.from_numpy(gv).to(dev).view(Q.FP8_DTYPE), v[:, cut:]], 1)
    before = QA.quant_decode_attention.launches
    got = QA.quant_decode_attention(q, jk, ks, kz, jv, length)
    assert QA.quant_decode_attention.launches == before + 1
    assert torch.equal(jk, kq) and torch.equal(jv.view(torch.uint8), v.view(torch.uint8))
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_trace_summary_equals_key_averages(dev):
    """``analysis.trace.summarize`` reads the raw kineto events; on a
    profiled run of the port's kernels its fields equal an aggregation of
    the same run's ``key_averages()``, which it replaced."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.analysis import trace as TR
    x = torch.randn((4, 3584), device=dev).bfloat16()
    w = torch.randn((3584,), device=dev)
    kq, ks, kz, v = _dense_cache(1, 2048, 4, 128, dev, 0)
    q = (torch.randn((1, 28, 128), device=dev) / math.sqrt(128)).bfloat16()
    length = torch.tensor(700, dtype=torch.int32, device=dev)
    RN.rmsnorm(x, w, 1e-6)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            RN.rmsnorm(x, w, 1e-6)
            QA.quant_decode_attention(q, kq, ks, kz, v, length)
            y = (x.float() @ x.float().T).sum()
        y.item()
    got = TR.summarize(prof, 3, 5000.0)
    kern, api = [], []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            if e.key.startswith("cuda") and e.cpu_time_total > 0:
                api.append((e.cpu_time_total, e.count, e.key))
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        if us > 0:
            kern.append((us, e.count, e.key))
    kern.sort(reverse=True)
    api.sort(reverse=True)
    busy = sum(k[0] for k in kern)
    assert got["device_ms_per_step"] == pytest.approx(busy / 3 / 1e3, rel=1e-6)
    assert got["device_launches_per_step"] == sum(c for _u, c, _n in kern) / 3
    assert [k["name"] for k in got["top_kernels"]] == [n[:80] for _u, _c, n in kern[:10]]
    assert set(got["port_kernels"]) == {"rmsnorm_kernel", "dense_decode_kernel"}
    assert [(n, k["calls_per_step"]) for n, k in got["runtime_calls"].items()] == \
        [(n, c / 3) for _u, c, n in api[:6]]
    for (us, _c, n), k in zip(api[:6], got["runtime_calls"].values()):
        assert k["host_ms_per_step"] == pytest.approx(us / 3 / 1e3, rel=1e-6)
