// Paged prefill (prompt-chunk) attention over the quantized KV pool, for
// Hopper.
//
// Replaces the TPU kernel
// repro/kernels/flash_prefill.py::paged_flash_prefill_attention: a chunk of C
// pre-scaled queries at absolute positions pos0 + [0, C) attends causally
// over the row's pages through the page table, with int8 key dequantization
// fused in, fp8 e4m3 values read as they are, and online softmax in float32.
// Pages (and key tiles) that start past the block's last query are skipped.
//
// What bounds it on the H100: operations at long contexts (each key tile is
// reused by every query row of the block), bytes for short ones; at the
// serving chunk sizes here both are small next to the chunk's matmuls.
//
// Design: one block per (row, KV head, 16 query-head rows), where a query-head
// row is one (query, head-in-group) pair, so G need not be a power of two and
// every block holds the same number of rows.  The block walks the row's pages
// in 32-token tiles: it dequantizes the key tile (via the same dequant_key as
// the decode kernel) and converts the value tile into shared memory, scores
// all 16 rows against the tile with the causal mask pos0 + i >= key position,
// updates the online softmax one warp per row, and accumulates P.V with thread
// d owning column d of all 16 rows.  Padded query rows (past C) are computed
// and never written, as the Pallas kernel slices them off.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int R = 16;          // query-head rows per block
constexpr int TS = 32;         // keys per tile (one per lane in the softmax)
constexpr int MAXD = 128;

__global__ void __launch_bounds__(THREADS)
paged_prefill_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kq,
                     const float* __restrict__ kscale, const float* __restrict__ kzero,
                     const uint8_t* __restrict__ v, const int* __restrict__ table,
                     const int* __restrict__ pos0, float* __restrict__ out,
                     int C, int Hkv, int G, int D, int ps, int n_pages) {
  __shared__ float qs[R][MAXD];
  __shared__ float kt[TS][MAXD + 1];
  __shared__ float vt[TS][MAXD];
  __shared__ float sc[R][TS];
  __shared__ float mrow[R], lrow[R], crow[R];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int r0 = blockIdx.y * R;
  const int H = Hkv * G;
  const int p0 = pos0[b];

  for (int idx = tid; idx < R * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int row = r0 + r, i = row / G, g = row % G;
    qs[r][d] = i < C ? __bfloat162float(q[(((size_t)b * C + i) * H + h * G + g) * D + d]) : 0.f;
  }
  if (tid < R) { mrow[tid] = REPRO_NEG_INF; lrow[tid] = 0.f; }
  const int last_row = min(r0 + R, C * G) - 1;
  const int qmax = p0 + last_row / G;      // the block's last query position

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;

  for (int p = 0; p < n_pages && p * ps <= qmax; ++p) {
    const size_t page = static_cast<size_t>(table[(size_t)b * n_pages + p]);
    for (int t0 = 0; t0 < ps && p * ps + t0 <= qmax; t0 += TS) {
      const int nt = min(TS, ps - t0);
      const int kstart = p * ps + t0;
      __syncthreads();
      for (int idx = tid; idx < nt * D; idx += THREADS) {
        const int t = idx / D, d = idx % D;
        const size_t tok = (page * ps + t0 + t) * Hkv + h;
        kt[t][d] = dequant_key(kq[tok * D + d], kscale[tok], kzero[tok]);
        vt[t][d] = fp8_to_float(v[tok * D + d]);
      }
      __syncthreads();
      for (int idx = tid; idx < R * nt; idx += THREADS) {
        const int r = idx / nt, t = idx % nt;
        const int qpos = p0 + (r0 + r) / G;
        float s = REPRO_NEG_INF;
        if (kstart + t <= qpos) {
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
  }
  __syncthreads();
  if (tid < D) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = r0 + r, i = row / G, g = row % G;
      if (i < C)
        out[(((size_t)b * C + i) * H + h * G + g) * D + tid] =
            acc[r] / fmaxf(lrow[r], 1e-30f);
    }
  }
}

}  // namespace

// q bf16 [B, C, H, D] pre-scaled; pool arrays as for the decode kernel; table
// int32 [B, n_pages]; pos0 int32 [B]; out f32 [B, C, H, D].  D <= 128.
extern "C" int paged_prefill_attention_launch(
    const void* q, const void* kq, const void* kscale, const void* kzero,
    const void* v, const void* table, const void* pos0, void* out, int B, int C,
    int Hkv, int G, int D, int ps, int n_pages, void* stream) {
  const dim3 grid(B * Hkv, (C * G + R - 1) / R);
  paged_prefill_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(kscale), static_cast<const float*>(kzero),
      static_cast<const uint8_t*>(v), static_cast<const int*>(table),
      static_cast<const int*>(pos0), static_cast<float*>(out), C, Hkv, G, D, ps,
      n_pages);
  return static_cast<int>(cudaGetLastError());
}
