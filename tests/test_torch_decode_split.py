"""The decode kernels' split over keys, held on the CPU.

``decode_splits`` picks how many blocks share one (row, KV head) from shapes
alone; the CUDA body (``csrc/decode_attention.cuh``) then runs, per split,
4 warps over 64-key tiles with their own online softmax, merges the warps,
and combines the splits.  Its arithmetic is modelled here in plain PyTorch
(test code only) -- keys dequantized and rounded to bf16, P rounded to bf16
relative to its warp's running max, float32 statistics, an exact combine --
and held against ``paged_quant_decode_attention_plain`` at the JAX
package's kernel-vs-reference attention tolerance (2e-2).  The kernel
itself is held against the plain version on the card
(``tests/test_torch_cuda.py``)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import kv_cache as KV  # noqa: E402
from repro_torch.core import quantization as Q  # noqa: E402
from repro_torch.kernels import quant_attention as QA  # noqa: E402
from repro_torch.runtime import plan  # noqa: E402

SMS = 132                 # an H100's SMs
TS, WARPS = 64, 4         # the body's keys a tile and warps a block


@pytest.mark.parametrize("arch,B,max_seq", [("qwen2-7b", 4, 2048),
                                            ("moonshot-v1-16b-a3b", 4, 1024),
                                            ("qwen2-7b@reduced", 4, 64),
                                            ("qwen2-7b", 1, 2048)])
def test_split_rule_reaches_the_card_from_shapes(arch, B, max_seq):
    cfg = registry.get(arch)
    Hkv = cfg.num_kv_heads
    n_blocks = max_seq // plan.kv_page_size(max_seq)     # pages a row
    splits = QA.decode_splits(B, Hkv, n_blocks)
    assert 1 <= splits <= n_blocks
    per = -(-n_blocks // splits)
    assert (splits - 1) * per < n_blocks                 # no split is empty by shape
    assert B * Hkv * splits >= min(2 * SMS, B * Hkv * n_blocks)
    # the dense cache's 128-slot blocks follow the same rule
    dense = QA.decode_splits(B, Hkv, -(-max_seq // QA.DENSE_BLOCK))
    assert 1 <= dense <= -(-max_seq // QA.DENSE_BLOCK)


def _pool(n_pages, ps, hkv, D, seed):
    rng = np.random.default_rng(seed)
    k = torch.from_numpy(rng.normal(size=(n_pages, ps, hkv, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(n_pages, ps, hkv, D)).astype(np.float32))
    kq, ks, kz = KV.quantize_keys(k.bfloat16())
    return kq, ks, kz, KV.cast_values(v, Q.FP8_DTYPE)


def _split_model(q, kq, ks, kz, v, table, base, length, window, splits):
    """The CUDA body's arithmetic, split by split and warp by warp."""
    B, H, D = q.shape
    ps, Hkv = kq.shape[1], kq.shape[2]
    G, n_pages = H // Hkv, table.shape[1]
    k = KV.dequantize_keys(QA.gather_rows(kq, table), QA.gather_rows(ks, table),
                           QA.gather_rows(kz, table)).float()         # bf16-rounded keys
    vv = QA.gather_rows(v, table).float()                            # e4m3: exact
    tpp, per = -(-ps // TS), -(-n_pages // splits)
    out = torch.zeros((B, H, D))
    for b in range(B):
        L = int(length[b])
        lo = max(L - window if window else 0, int(base[b]) * ps, 0)
        hi = min(L, (int(base[b]) + n_pages) * ps)
        for h in range(Hkv):
            qg = q[b, h * G:(h + 1) * G].float()
            parts = []
            for s in range(splits):
                m = torch.full((WARPS, G), QA.NEG_INF)
                lsum = torch.zeros((WARPS, G))
                acc = torch.zeros((WARPS, G, D))
                live_split = False
                for p in range(s * per, min((s + 1) * per, n_pages)):
                    for tp in range(tpp):
                        nt = min(TS, ps - tp * TS)
                        for w in range(WARPS):
                            if 16 * w >= nt:
                                continue
                            idx = torch.arange(16 * w, min(16 * w + 16, nt))
                            col = p * ps + tp * TS + idx                # in the gathered row
                            pos = (int(base[b]) + p) * ps + tp * TS + idx
                            live = (pos >= lo) & (pos < hi)
                            live_split |= bool(live.any())
                            sc = qg @ k[b, col, h].T                    # [G, keys]
                            mx = torch.where(live, sc, torch.full_like(sc, QA.NEG_INF))
                            mn = torch.maximum(m[w], mx.max(dim=1).values)
                            corr = torch.exp(m[w] - mn)
                            pr = torch.where(live, torch.exp(sc - mn[:, None]),
                                             torch.zeros_like(sc))
                            lsum[w] = lsum[w] * corr + pr.sum(dim=1)
                            acc[w] = (acc[w] * corr[:, None]
                                      + pr.bfloat16().float() @ vv[b, col, h])
                            m[w] = mn
                if live_split:                      # splits with no live key exit
                    M = m.max(dim=0).values
                    f = torch.exp(m - M)
                    parts.append((M, (f * lsum).sum(0), (f[..., None] * acc).sum(0)))
            if not parts:
                continue                            # no live key: zeros
            M = torch.stack([pm for pm, _, _ in parts]).max(dim=0).values
            num = sum(torch.exp(pm - M)[:, None] * pa for pm, _, pa in parts)
            den = sum(torch.exp(pm - M) * pl for pm, pl, _ in parts)
            out[b, h * G:(h + 1) * G] = num / torch.clamp(den, min=1e-30)[:, None]
    return out


@pytest.mark.parametrize("ps,n_pages,G,lengths,window", [
    # 16-key pages (@reduced): a split with every key masked, one live key,
    # page - 1 / page / page + 1
    (16, 4, 3, [5, 1, 15, 16, 17], 0),
    (16, 4, 1, [64, 33, 48, 2, 31], 0),
    # 128-key pages (the serving size): two tiles a page, four warps a tile
    (128, 3, 7, [127, 128, 129, 1, 384], 0),
    # windowed: only the last split's keys live
    (16, 4, 3, [64, 60, 40, 17, 5], 10),
])
def test_split_and_combine_match_the_plain_version(ps, n_pages, G, lengths, window):
    B, hkv, D = len(lengths), 2, 64
    rng = np.random.default_rng(ps + G + window)
    P = B * n_pages + 1
    pool = _pool(P, ps, hkv, D, seed=G)
    table = torch.from_numpy(
        rng.permutation(P - 1)[:B * n_pages].reshape(B, n_pages).astype(np.int32))
    for b, L in enumerate(lengths):                          # past the length: trash page
        table[b, -(-L // ps):] = P - 1
    q = torch.from_numpy((rng.normal(size=(B, hkv * G, D)) / math.sqrt(D))
                         .astype(np.float32)).bfloat16()
    base = torch.zeros((B,), dtype=torch.int32)
    length = torch.tensor(lengths, dtype=torch.int32)
    want = QA.paged_quant_decode_attention_plain(q, *pool, table, base, length,
                                                 window=window)
    splits = QA.decode_splits(B, hkv, n_pages)
    assert splits == n_pages                                 # one page a split here
    for n in sorted({1, 2, splits}):
        got = _split_model(q, *pool, table, base, length, window, n)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-2, atol=2e-2)
