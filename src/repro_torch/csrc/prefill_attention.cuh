// Blockwise (flash) attention of many query tokens on the bf16 tensor
// cores, shared by the dense prefill kernel (csrc/flash_prefill_attention.cu)
// and the paged prefill kernel (csrc/paged_prefill_attention.cu): the two
// differ only in where a tile of keys lives, how its bytes become a bf16
// tile in shared memory and which keys the mask leaves live, which the
// ``Tiles`` policy answers.
//
// What bounds it on the H100: at the serving shapes the work is small (a
// 320-token prompt at G = 7 is 0.74 GFLOP and 7.5 MB), so what matters is
// keeping the tensor cores fed and the key bytes in flight.  The earlier
// body ran on CUDA cores in float32 (one thread per (row, key) dot product,
// keys and values converted to float32 tiles, four block barriers a tile).
//
// Design.  A block of 4 warps serves one (batch row, KV head) and 64
// query-head rows, a query-head row being one (query, head-in-group) pair,
// so G = H / Hkv need not be a power of two (qwen2-7b has 7, moonshot 1);
// each warp owns one 16-row MMA block.  (Blocks of 32 rows, which would
// double a 128-token chunk's 56 blocks on the 132 SMs, measured slower.)  The block's queries are gathered once into
// shared memory and from there into bf16 A fragments (ldmatrix).  The block
// walks, in tiles of 64 keys, only the tiles that can hold a live key for
// one of its queries; the policy stages each tile in shared memory as bf16
// through cp.async, double-buffered so the next tile's bytes are in flight
// while this one is multiplied.  Per tile a warp computes S = Q.K^T with
// mma.sync m16n8k16 (float32 accumulation; K's B fragments by ldmatrix),
// masks it (causal / window / key past the tile with the REPRO_NEG_INF
// sentinel, so a wholly masked tile keeps the Pallas kernels' semantics),
// runs the online softmax in float32 registers with the row max and sum
// taken across each quad by shuffles, rounds P to bf16 and accumulates
// O += P.V on the tensor cores (V's fragments by ldmatrix.trans).  The
// output is float32, divided by max(l, 1e-30) once at the end; padded
// query rows (past Tq * G) are computed and never written, as the Pallas
// kernels slice them off.
//
// Rounding against the Pallas kernels (repro/kernels/flash_prefill.py): the
// Pallas kernels keep P in float32 for P.V; here P is rounded to bf16, as the
// plain version's bf16 ``flash_attention`` rounds it.  Scores and the
// softmax statistics (row max, row sum of the unrounded P) are float32, as
// there.  Exponentials are exp2 of a scaled difference (1-2 ulp from expf).
#pragma once

#include "mma.cuh"

namespace prefill {

constexpr int TS = 64;                 // keys per tile
constexpr int WARPS = 4;               // 16-row MMA blocks (and warps) a block
constexpr int THREADS = 32 * WARPS;
constexpr int R = 16 * WARPS;          // query-head rows a block
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Geo {
  static_assert(D == 64 || D == 128, "head dims 64 and 128");
  static constexpr int PITCH = D + 8;              // bf16 per shared row: conflict-free ldmatrix
  static constexpr int TILE = TS * PITCH;          // bf16 elements of one key or value tile
};

// Shared memory of the block's queries (the policy's tiles follow it).
template <int D>
__host__ __device__ constexpr int q_bytes() { return R * Geo<D>::PITCH * 2; }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Tiles: for the block's queries at positions [qlo, qhi], key tiles
// begin(qlo) .. end(qhi) - 1 are the ones that may hold a live key.  For tile
// it, start(it) is the position of its first key and size(it) its number of
// keys (<= TS); stage(it, slot, tid, n) issues the cp.async copies of its
// bytes into buffer slot (0 or 1) with n threads; where CONVERTS, convert(it,
// slot, tid, n) then turns the landed bytes into the bf16 tile;
// ktile(slot) / vtile(slot) are the bf16 tiles [TS][PITCH], zero past
// size(it).  qpos(i) is the position of query i and live(qp, kp) the mask.
// q: bf16 [B, Tq, H, D] pre-scaled; out: f32 [B, Tq, H, D]; qs: the
// block's query buffer in shared memory.
template <int D, class Tiles>
__device__ __forceinline__ void attend(const Tiles& tiles,
                                       const __nv_bfloat16* __restrict__ q,
                                       float* __restrict__ out, int b, int h, int Tq,
                                       int Hkv, int G, __nv_bfloat16* qs) {
  constexpr int P = Geo<D>::PITCH;
  constexpr int KD = D / 16;           // k16 steps of Q.K^T
  constexpr int ND = D / 8;            // n8 column blocks of O
  constexpr int NS = TS / 8;           // n8 key blocks of S
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.y * R;
  const int H = Hkv * G;
  const int nrows = Tq * G;

  for (int c = tid; c < R * (D / 8); c += THREADS) {
    const int r = c / (D / 8), ch = c % (D / 8), row = r0 + r;
    const bool ok = row < nrows;
    const __nv_bfloat16* src =
        ok ? q + (((size_t)b * Tq + row / G) * H + h * G + row % G) * D + ch * 8 : q;
    mma::cp_async16(qs + r * P + ch * 8, src, ok);
  }
  mma::cp_async_commit();
  const int qlo = tiles.qpos(r0 / G);                           // the block's first query
  const int qhi = tiles.qpos((min(r0 + R, nrows) - 1) / G);     // and its last
  const int it_begin = tiles.begin(qlo);
  const int it_end = tiles.end(qhi);
  if (it_begin < it_end) tiles.stage(it_begin, 0, tid, THREADS);
  mma::cp_async_commit();
  mma::cp_async_wait<1>();                                      // the queries have landed
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    mma::ldmatrix_x4(qf[kk], qs + (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * P
                                 + 16 * kk + 8 * (lane >> 4));

  // this thread's two rows: g and g + 8 of the warp's 16; the warp's first
  // and last query
  const int row_a = r0 + 16 * warp + g;
  const int row_b = row_a + 8;
  const int qp_a = tiles.qpos(row_a / G);
  const int qp_b = tiles.qpos(row_b / G);
  const int qlo_w = tiles.qpos(min(r0 + 16 * warp, nrows - 1) / G);
  const int qhi_w = tiles.qpos(min(r0 + 16 * warp + 15, nrows - 1) / G);
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_a = REPRO_NEG_INF, m_b = REPRO_NEG_INF, l_a = 0.f, l_b = 0.f;

  for (int it = it_begin, n = 0; it < it_end; ++it, ++n) {
    const int slot = n & 1;
    mma::cp_async_wait<0>();
    __syncthreads();                   // tile it landed; every warp is done with tile it - 1
    if constexpr (Tiles::CONVERTS) {
      tiles.convert(it, slot, tid, THREADS);
      __syncthreads();
    }
    if (it + 1 < it_end) tiles.stage(it + 1, slot ^ 1, tid, THREADS);
    mma::cp_async_commit();
    const __nv_bfloat16* kt = tiles.ktile(slot);
    const __nv_bfloat16* vt = tiles.vtile(slot);
    const int kstart = tiles.start(it);
    const int nt = tiles.size(it);

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; kk += 2)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t kb[4];
        mma::ldmatrix_x4(kb, kt + (8 * j + (lane & 7)) * P + 16 * kk + 8 * (lane >> 3));
        mma::mma_bf16(s[j], qf[kk], kb[0], kb[1]);
        mma::mma_bf16(s[j], qf[kk + 1], kb[2], kb[3]);
      }

    // S[j][e]: key 8j + 2t + (e & 1) of row a (e < 2) or row b (e >= 2).
    // The masks are bands, so the tile is live for every (row, key) pair of
    // the warp when its last key is live for the warp's first query and its
    // first key for the last; only other tiles are masked.
    const bool full = nt == TS && tiles.live(qlo_w, kstart + TS - 1) &&
                      tiles.live(qhi_w, kstart);
    if (!full) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * j + 2 * t + e;
          const int kp = kstart + key;
          if (!(key < nt && tiles.live(qp_a, kp))) s[j][e] = REPRO_NEG_INF;
          if (!(key < nt && tiles.live(qp_b, kp))) s[j][2 + e] = REPRO_NEG_INF;
        }
    }
    float mx_a = REPRO_NEG_INF, mx_b = REPRO_NEG_INF;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float corr_a = exp2f((m_a - mn_a) * LOG2E);
    const float corr_b = exp2f((m_b - mn_b) * LOG2E);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = 8 * j + 2 * t + e < nt;      // keys past the tile add nothing
        s[j][e] = in ? exp2f((s[j][e] - mn_a) * LOG2E) : 0.f;
        s[j][2 + e] = in ? exp2f((s[j][2 + e] - mn_b) * LOG2E) : 0.f;
        sum_a += s[j][e];
        sum_b += s[j][2 + e];
      }
    l_a = l_a * corr_a + quad_sum(sum_a);
    l_b = l_b * corr_b + quad_sum(sum_b);
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[j][0] *= corr_a;
      o[j][1] *= corr_a;
      o[j][2] *= corr_b;
      o[j][3] *= corr_b;
    }

    // O += P.V: P's accumulator layout is the A fragment of the next product
#pragma unroll
    for (int kk = 0; kk < TS / 16; ++kk) {
      const uint32_t pa[4] = {mma::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              mma::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              mma::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              mma::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        uint32_t vb[4];
        mma::ldmatrix_x4_trans(vb, vt + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * P
                                       + 8 * j + 8 * (lane >> 4));
        mma::mma_bf16(o[j], pa, vb[0], vb[1]);
        mma::mma_bf16(o[j + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row_b : row_a;
    if (row >= nrows) continue;
    const float l = fmaxf(half ? l_b : l_a, 1e-30f);
    float* dst = out + (((size_t)b * Tq + row / G) * H + h * G + row % G) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(o[j][2 * half] / l, o[j][2 * half + 1] / l);
  }
}

// Grid of a launch: one block per (row, KV head) on x, R query-head rows
// on y.
inline dim3 grid(int B, int Hkv, int Tq, int G) {
  return dim3(B * Hkv, (Tq * G + R - 1) / R);
}

// Opt a kernel in to the dynamic shared memory it needs (above 48 KB).
template <class Kernel>
inline void allow_smem(Kernel kernel, int bytes) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace prefill
