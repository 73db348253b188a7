// Blockwise (flash) attention of many query tokens, shared by the paged
// prefill kernel (csrc/paged_prefill_attention.cu) and the dense prefill
// kernel (csrc/flash_prefill_attention.cu): the two differ only in where a
// tile of keys lives, how its bytes turn into float32 and which keys the mask
// leaves live, which the ``Tiles`` policy answers.
//
// One thread block serves one (row, KV head, 16 query-head rows), where a
// query-head row is one (query, head-in-group) pair, so G = H / Hkv need not
// be a power of two (qwen2-7b has 7, moonshot 1) and every block holds the
// same number of rows.  The block walks only the key tiles that can hold a
// live key for one of its queries.  Per tile it converts keys and values to
// float32 in shared memory, scores its 16 rows against the tile, updates the
// online softmax (float32) one warp per row, and accumulates P.V with thread
// d owning column d of all 16 rows.  Padded query rows (past Tq) are computed
// and never written, as the Pallas kernels slice them off.
#pragma once

#include "common.cuh"

namespace prefill {

constexpr int THREADS = 128;
constexpr int R = 16;          // query-head rows per block
constexpr int TS = 32;         // keys per tile (one per lane in the softmax)
constexpr int MAXD = 128;

// Tiles: for the block's queries at positions [qlo, qhi], key tiles
// begin(qlo) .. end(qhi) - 1 are the ones that may hold a live key.  For tile
// it, start(it) is the position of its first key, size(it) its number of keys
// (<= TS), first(it) the flat token index (row of the [..., Hkv, D] arrays)
// of its first key; key(tok, d) / value(tok, d) read element d of flat
// (token, head) row tok as float32; qpos(i) is the position of query i and
// live(qp, kp) the mask.
// q: bf16 [B, Tq, H, D] pre-scaled; out: f32 [B, Tq, H, D].
template <class Tiles>
__device__ __forceinline__ void attend(const Tiles& tiles,
                                       const __nv_bfloat16* __restrict__ q,
                                       float* __restrict__ out, int b, int h, int Tq,
                                       int Hkv, int G, int D) {
  __shared__ float qs[R][MAXD];
  __shared__ float kt[TS][MAXD + 1];
  __shared__ float vt[TS][MAXD];
  __shared__ float sc[R][TS];
  __shared__ float mrow[R], lrow[R], crow[R];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int r0 = blockIdx.y * R;
  const int H = Hkv * G;

  for (int idx = tid; idx < R * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int row = r0 + r, i = row / G, g = row % G;
    qs[r][d] = i < Tq ? __bfloat162float(q[(((size_t)b * Tq + i) * H + h * G + g) * D + d])
                      : 0.f;
  }
  if (tid < R) { mrow[tid] = REPRO_NEG_INF; lrow[tid] = 0.f; }
  const int qlo = tiles.qpos(r0 / G);                          // the block's first query
  const int qhi = tiles.qpos((min(r0 + R, Tq * G) - 1) / G);   // and its last

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;

  const int it_end = tiles.end(qhi);
  for (int it = tiles.begin(qlo); it < it_end; ++it) {
    const int kstart = tiles.start(it);
    const int nt = tiles.size(it);
    const size_t first = tiles.first(it);
    __syncthreads();
    for (int idx = tid; idx < nt * D; idx += THREADS) {
      const int t = idx / D, d = idx % D;
      const size_t tok = (first + t) * Hkv + h;
      kt[t][d] = tiles.key(tok, d);
      vt[t][d] = tiles.value(tok, d);
    }
    __syncthreads();
    for (int idx = tid; idx < R * nt; idx += THREADS) {
      const int r = idx / nt, t = idx % nt;
      float s = REPRO_NEG_INF;
      if (tiles.live(tiles.qpos((r0 + r) / G), kstart + t)) {
        s = 0.f;
        for (int d = 0; d < D; ++d) s += qs[r][d] * kt[t][d];
      }
      sc[r][t] = s;
    }
    __syncthreads();
    for (int r = warp; r < R; r += THREADS / 32) {
      const float x = lane < nt ? sc[r][lane] : REPRO_NEG_INF;
      const float m_old = mrow[r];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float e = lane < nt ? expf(x - m_new) : 0.f;
      if (lane < nt) sc[r][lane] = e;
      const float sum = warp_sum(e);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        crow[r] = corr;
        lrow[r] = lrow[r] * corr + sum;
        mrow[r] = m_new;
      }
    }
    __syncthreads();
    if (tid < D) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float a = acc[r] * crow[r];
        for (int t = 0; t < nt; ++t) a += sc[r][t] * vt[t][tid];
        acc[r] = a;
      }
    }
  }
  __syncthreads();
  if (tid < D) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = r0 + r, i = row / G, g = row % G;
      if (i < Tq)
        out[(((size_t)b * Tq + i) * H + h * G + g) * D + tid] =
            acc[r] / fmaxf(lrow[r], 1e-30f);
    }
  }
}

// Grid of a launch: one block per (row, KV head) on x, R query-head rows on y.
inline dim3 grid(int B, int Hkv, int Tq, int G) {
  return dim3(B * Hkv, (Tq * G + R - 1) / R);
}

}  // namespace prefill
