// The W4A8 / W8A8 output tile on the int8 tensor cores (mma.sync m16n8k32),
// shared by both matmul kernels of the port (csrc/w4a8_matmul.cu,
// csrc/grouped_matmul.cu):
//   y[m0:m0+BM, n0:n0+128] = sx * w_scale * (xq @ w - w_zero * rowsum(xq))
// with int8 activations xq [M, K], int4 weights packed two unsigned nibbles
// per byte along N (column 2j low, 2j+1 high) or int8 weights [K, N], and a
// per-channel asymmetric scale/zero.
//
// What bounds it on the H100: the weight bytes at decode (a weight byte
// meets at most 16 rows: 32 int8 operations a byte against the card's ~590
// ops/byte ridge); at a 128-row prompt chunk the int4 weight stream and the
// tensor cores (~512 operations a weight byte) come close, and with only
// mma.sync (not wgmma) the tensor cores are the nearer limit.
//
// Design.  A block of 4 * RH warps computes BM = 16 * MT * RH rows x 128
// columns over a range of K steps of 64 (the whole K, or one split's range
// [kt0, kt1)).  Weight and activation tiles come in through 16-byte
// cp.async into a ring of 4 stages in dynamic shared memory, so three K
// steps of bytes are in flight while one is multiplied.  Warp w takes the
// columns 64 * (w % 2) .. +63, the 32-deep half (w / 2) % 2 of each K step
// (split K inside the block; the two halves are summed in shared memory at
// the end, exactly, in int32) and the MT row tiles of its row group w / 4.
// Hopper has no int4 MMA: a thread reads one 32-bit word of packed weights
// from each of four consecutive K rows (8 columns of 4 K values), transposes
// the 4 x 4 bytes in registers with __byte_perm, and masks the nibbles
// apart, which gives the K-major B fragments of 8 MMAs directly (int8
// weights: two words a row, no masks); those fragments are unpacked once a
// K step and used for each of the warp's MT row tiles.  MMA j of a warp
// multiplies the columns {8c + j}, so each thread ends up owning 16
// consecutive output columns of two rows a row tile.  The row sums of xq
// come from one more MMA a row tile against a B of ones, exact in int32.
//
// Two ways out.  The epilogue, once per output, in the order of the plain
// version (kernels/w4a8_matmul.py, quant_matmul): (w_scale * fmaf(-w_zero,
// rowsum, acc)) * sx.  Or, for a split of K, the int32 partial tile and row
// sums, written for the caller to combine (csrc/w4a8_matmul.cu); int32 sums
// are exact, so the result does not depend on how K was split.
//
// Live rows (grouped kernel).  The caller may say which rows hold data: a
// tile none of whose rows is live reads nothing and writes +0.0 -- what the
// full computation gives for an all-zero row (sx = 1, acc = rowsum = 0) --
// and the dead rows of a live tile are read as zeros.  Requires K % 64 == 0,
// N % 128 == 0, 16-byte aligned xq, w, w_scale and w_zero, and BM * 4 <= the
// block's threads (one 16-byte activation chunk a thread a K step).
#pragma once

#include "mma.cuh"

namespace w4a8mma {

constexpr int BN = 128;
constexpr int BK = 64;
constexpr int STAGES = 4;
constexpr int A_PITCH = BK + 16;     // activation row stride (bytes): conflict-free fragment reads

// MT row tiles of 16 a warp, RH row groups of 4 warps a block.
template <int BITS, int MT, int RH>
struct Geo {
  static constexpr int BM = 16 * MT * RH;
  static constexpr int THREADS = 128 * RH;
  static constexpr int ROW_BYTES = BITS == 4 ? BN / 2 : BN;   // weight bytes per K row
  static constexpr int W_PITCH = ROW_BYTES + 16;
  static constexpr int W_STAGE = BK * W_PITCH;
  static constexpr int STAGE = W_STAGE + BM * A_PITCH;
  static constexpr int SMEM = STAGES * STAGE;                  // dynamic shared memory (bytes)
  static constexpr int RED = 34 * MT + 1;   // words per lane in the K-half reduction (odd: no conflicts)
  static_assert(BM * BK / 16 <= THREADS, "one activation chunk a thread");
  static_assert((BK * ROW_BYTES / 16) % THREADS == 0, "whole weight chunks a thread");
  static_assert(2 * RH * 32 * RED * 4 <= SMEM, "reduction area inside the ring");
};

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Row m of a slab with M = G * C rows is live iff m % C < rows[m / C]
// (every row is live when rows is null).
__device__ __forceinline__ bool row_live(int m, int M, const int* rows, int C) {
  return m < M && (rows == nullptr || m % C < rows[m / C]);
}

// The epilogue of one output, in the plain version's order.
__device__ __forceinline__ float epilogue(int acc, int rowsum, float scale, float zero,
                                          float sxm) {
  return (scale * fmaf(-zero, static_cast<float>(rowsum), static_cast<float>(acc))) * sxm;
}

// With part_acc null: the output tile through the epilogue.  Otherwise the
// int32 partial sums over K steps [kt0, kt1): part_acc[m * N + n] and
// part_rs[m] for the live rows m.  Threads leave the function, never the
// kernel, so the caller may synchronize the block after it.
template <int BITS, int MT, int RH>
__device__ __forceinline__ void tile(const int8_t* __restrict__ xq,
                                     const float* __restrict__ sx,
                                     const int8_t* __restrict__ w,
                                     const float* __restrict__ wscale,
                                     const float* __restrict__ wzero,
                                     float* __restrict__ y, int M, int N, int K,
                                     int m0, int n0, const int* __restrict__ rows,
                                     int C, int kt0, int kt1,
                                     int* __restrict__ part_acc = nullptr,
                                     int* __restrict__ part_rs = nullptr) {
  using GE = Geo<BITS, MT, RH>;
  extern __shared__ __align__(128) int8_t smem[];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int hw = warp % 2;             // column half
  const int ks = (warp / 2) % 2;       // 32-deep half of each K step
  const int rg = warp / 4;             // row group: row tiles rg * MT ..

  // activation chunk of this thread (16 B of one row), and whether its row
  // is live; the block skips everything when no row is
  const int a_row = tid / (BK / 16), a_ch = tid % (BK / 16);
  const bool a_loader = tid < GE::BM * BK / 16;
  const bool a_live = a_loader && row_live(m0 + a_row, M, rows, C);
  if (!__syncthreads_or(a_live)) {
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = tid; c < GE::BM * BN / 4; c += GE::THREADS) {
      const int m = m0 + c / (BN / 4);
      if (m < M) *reinterpret_cast<float4*>(y + (size_t)m * N + n0 + c % (BN / 4) * 4) = zero4;
    }
    return;
  }

  const size_t wpitch = BITS == 4 ? N / 2 : N;
  const int8_t* wtile = w + (BITS == 4 ? n0 / 2 : n0);
  const int8_t* arow = a_live ? xq + (size_t)(m0 + a_row) * K + a_ch * 16 : xq;
  auto load_stage = [&](int kt, int slot) {
    int8_t* ws = smem + slot * GE::STAGE;
    const int k0 = kt * BK;
    constexpr int WCH = GE::ROW_BYTES / 16;
#pragma unroll
    for (int i = 0; i < BK * WCH / GE::THREADS; ++i) {
      const int c = tid + i * GE::THREADS;
      mma::cp_async16(ws + (c / WCH) * GE::W_PITCH + (c % WCH) * 16,
                      wtile + (size_t)(k0 + c / WCH) * wpitch + (c % WCH) * 16, true);
    }
    if (a_loader)
      mma::cp_async16(ws + GE::W_STAGE + a_row * A_PITCH + a_ch * 16,
                      a_live ? arow + k0 : xq, a_live);
  };

  const int nk = kt1 - kt0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(kt0 + s, s);
    mma::cp_async_commit();
  }

  int acc[MT][8][4];
  int rs[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    rs[mt][0] = rs[mt][1] = rs[mt][2] = rs[mt][3] = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0;
  }

  for (int i = 0; i < nk; ++i) {
    mma::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (i + STAGES - 1 < nk) load_stage(kt0 + i + STAGES - 1, (i + STAGES - 1) % STAGES);
    mma::cp_async_commit();

    const int8_t* ws = smem + (i % STAGES) * GE::STAGE;
    uint32_t b[2][8];                  // [K rows 4t.. / 16+4t..][column 8c + j]
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int8_t* base = ws + (ks * 32 + 16 * half + 4 * t) * GE::W_PITCH;
      if constexpr (BITS == 4) {
        uint32_t wv[4], tr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) wv[r] = lds32(base + r * GE::W_PITCH + 32 * hw + 4 * g);
        mma::transpose4x4(wv, tr);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[half][2 * j] = tr[j] & 0x0F0F0F0Fu;
          b[half][2 * j + 1] = (tr[j] >> 4) & 0x0F0F0F0Fu;
        }
      } else {
        uint32_t lo[4], hi[4], tl[4], th[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint2 v = *reinterpret_cast<const uint2*>(base + r * GE::W_PITCH + 64 * hw + 8 * g);
          lo[r] = v.x;
          hi[r] = v.y;
        }
        mma::transpose4x4(lo, tl);
        mma::transpose4x4(hi, th);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[half][j] = tl[j];
          b[half][4 + j] = th[j];
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int8_t* as = ws + GE::W_STAGE + (rg * MT + mt) * 16 * A_PITCH + ks * 32 + 4 * t;
      uint32_t a[4];
      a[0] = lds32(as + g * A_PITCH);
      a[1] = lds32(as + (g + 8) * A_PITCH);
      a[2] = lds32(as + g * A_PITCH + 16);
      a[3] = lds32(as + (g + 8) * A_PITCH + 16);
#pragma unroll
      for (int j = 0; j < 8; ++j) mma::mma_s8(acc[mt][j], a, b[0][j], b[1][j]);
      mma::mma_s8(rs[mt], a, 0x01010101u, 0x01010101u);
    }
  }

  // sum the two K halves (int32, exact)
  mma::cp_async_wait<0>();
  __syncthreads();
  int* red = reinterpret_cast<int*>(smem) + ((rg * 2 + hw) * 32 + lane) * GE::RED;
  if (ks == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[(mt * 8 + j) * 4 + e] = acc[mt][j][e];
      red[32 * MT + 2 * mt] = rs[mt][0];
      red[32 * MT + 2 * mt + 1] = rs[mt][2];
    }
  }
  __syncthreads();
  if (ks == 1) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] += red[(mt * 8 + j) * 4 + e];
    rs[mt][0] += red[32 * MT + 2 * mt];
    rs[mt][2] += red[32 * MT + 2 * mt + 1];
  }

  // thread (g, t) owns columns nb .. nb + 15 of rows g and g + 8 of each of
  // its row tiles: MMA j's accumulator holds columns nb + j and nb + 8 + j
  const int nb = n0 + 64 * hw + 16 * t;
  if (part_acc != nullptr) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + (rg * MT + mt) * 16 + g + 8 * half;
        if (m >= M) continue;
        int o[16];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[j] = acc[mt][j][2 * half];
          o[8 + j] = acc[mt][j][2 * half + 1];
        }
        int* dst = part_acc + (size_t)m * N + nb;
#pragma unroll
        for (int c = 0; c < 16; c += 4)
          *reinterpret_cast<int4*>(dst + c) = *reinterpret_cast<const int4*>(o + c);
        if (hw == 0 && t == 0) part_rs[m] = rs[mt][2 * half];
      }
    return;
  }

  float s[16], z[16];
#pragma unroll
  for (int c = 0; c < 16; c += 4) {
    *reinterpret_cast<float4*>(s + c) = *reinterpret_cast<const float4*>(wscale + nb + c);
    *reinterpret_cast<float4*>(z + c) = *reinterpret_cast<const float4*>(wzero + nb + c);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + (rg * MT + mt) * 16 + g + 8 * half;
      if (m >= M) continue;
      const float sxm = sx[m];
      const int rsm = rs[mt][2 * half];
      float o[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[j] = epilogue(acc[mt][j][2 * half], rsm, s[j], z[j], sxm);
        o[8 + j] = epilogue(acc[mt][j][2 * half + 1], rsm, s[8 + j], z[8 + j], sxm);
      }
      float* dst = y + (size_t)m * N + nb;
#pragma unroll
      for (int c = 0; c < 16; c += 4)
        *reinterpret_cast<float4*>(dst + c) = *reinterpret_cast<const float4*>(o + c);
    }
}

}  // namespace w4a8mma
