// A W4A8 / W8A8 output tile on the int8 tensor cores (mma.sync m16n8k32),
// for the grouped matmul kernel (csrc/grouped_matmul.cu):
//   y[m0:m0+16, n0:n0+128] = sx * w_scale * (xq @ w - w_zero * rowsum(xq))
// with int8 activations xq [M, K], int4 weights packed two unsigned nibbles
// per byte along N (column 2j low, 2j+1 high) or int8 weights [K, N], and a
// per-channel asymmetric scale/zero.
//
// What bounds it on the H100: the bytes.  At the MoE paths' shapes a tile
// has one to a few live rows, so each weight byte meets at most 16 rows
// (32 int8 operations per byte against the card's ~590 ops/byte ridge).
// The tile has to stream weights at the memory's rate, which the earlier
// __dp4a tile (csrc/w4a8_tile.cuh) did not: it ran on CUDA cores, unpacked
// nibbles one byte at a time with transposing stores, and waited on every
// K step with nothing in flight.
//
// Design.  One block of 4 warps computes the 16 x 128 tile over K in steps
// of 64.  Weight and activation tiles come in through 16-byte cp.async into
// a ring of 4 stages, so three K steps of bytes are in flight while one is
// multiplied.  Warp w takes the columns 64 * (w % 2) .. +63 and the 32-deep
// half w / 2 of each K step (split K inside the block; the two halves are
// summed in shared memory at the end, exactly, in int32).  Hopper has no
// int4 MMA: a thread reads one 32-bit word of packed weights from each of
// four consecutive K rows (8 columns of 4 K values), transposes the 4 x 4
// bytes in registers with __byte_perm, and masks the nibbles apart, which
// gives the K-major B fragments of 8 MMAs directly (int8 weights: two words
// a row, no masks).  MMA j of a warp therefore multiplies the columns
// {8c + j}, and each thread ends up owning 16 consecutive output columns of
// its two rows.  The row sums of xq come from one more MMA against a B of
// ones, exact in int32.  The asymmetric-zero epilogue is applied once per
// output, in the order of the earlier tile: sx * ws * fmaf(-wz, rs, acc).
//
// Live rows.  The caller may say which rows hold data: a tile none of whose
// rows is live reads nothing and writes +0.0 -- what the full computation
// gives for an all-zero row (sx = 1, acc = rowsum = 0) -- and the dead rows
// of a live tile are read as zeros.  Requires K % 64 == 0, N % 128 == 0 and
// 16-byte aligned xq and w (the padded PackedExpertLinear layout).
#pragma once

#include "mma.cuh"

namespace w4a8mma {

constexpr int BM = 16;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int THREADS = 128;
constexpr int STAGES = 4;
constexpr int A_PITCH = BK + 16;     // activation row stride (bytes): conflict-free fragment reads
constexpr int RED = 37;              // words per lane in the split-K reduction (odd: no conflicts)

template <int BITS>
struct Geo {
  static constexpr int ROW_BYTES = BITS == 4 ? BN / 2 : BN;   // weight bytes per K row
  static constexpr int W_PITCH = ROW_BYTES + 16;
  static constexpr int W_STAGE = BK * W_PITCH;
  static constexpr int STAGE = W_STAGE + BM * A_PITCH;
};

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Row m of a slab with M = G * C rows is live iff m % C < rows[m / C]
// (every row is live when rows is null).
__device__ __forceinline__ bool row_live(int m, int M, const int* rows, int C) {
  return m < M && (rows == nullptr || m % C < rows[m / C]);
}

template <int BITS>
__device__ __forceinline__ void tile(const int8_t* __restrict__ xq,
                                     const float* __restrict__ sx,
                                     const int8_t* __restrict__ w,
                                     const float* __restrict__ wscale,
                                     const float* __restrict__ wzero,
                                     float* __restrict__ y, int M, int N, int K,
                                     int m0, int n0, const int* __restrict__ rows,
                                     int C) {
  using GE = Geo<BITS>;
  __shared__ __align__(128) int8_t smem[STAGES * GE::STAGE];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int hw = warp % 2;             // column half
  const int ks = warp / 2;             // 32-deep half of each K step

  // activation chunk of this thread (16 B of one row), and whether its row
  // is live; the block skips everything when no row is
  const int a_row = tid / (BK / 16), a_ch = tid % (BK / 16);
  const bool a_loader = tid < BM * BK / 16;
  const bool a_live = a_loader && row_live(m0 + a_row, M, rows, C);
  if (!__syncthreads_or(a_live)) {
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = tid; c < BM * BN / 4; c += THREADS) {
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
    for (int i = 0; i < BK * WCH / THREADS; ++i) {
      const int c = tid + i * THREADS;
      mma::cp_async16(ws + (c / WCH) * GE::W_PITCH + (c % WCH) * 16,
                      wtile + (size_t)(k0 + c / WCH) * wpitch + (c % WCH) * 16, true);
    }
    if (a_loader)
      mma::cp_async16(ws + GE::W_STAGE + a_row * A_PITCH + a_ch * 16,
                      a_live ? arow + k0 : xq, a_live);
  };

  const int nk = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    mma::cp_async_commit();
  }

  int acc[8][4];
  int rs[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;

  for (int kt = 0; kt < nk; ++kt) {
    mma::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nk) load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    mma::cp_async_commit();

    const int8_t* ws = smem + (kt % STAGES) * GE::STAGE;
    const int8_t* as = ws + GE::W_STAGE + ks * 32 + 4 * t;
    uint32_t a[4];
    a[0] = lds32(as + g * A_PITCH);
    a[1] = lds32(as + (g + 8) * A_PITCH);
    a[2] = lds32(as + g * A_PITCH + 16);
    a[3] = lds32(as + (g + 8) * A_PITCH + 16);

    uint32_t b[2][8];                  // [K rows 4t.. / 16+4t..][column 8c + j]
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int8_t* base = ws + (ks * 32 + 16 * half + 4 * t) * GE::W_PITCH;
      if constexpr (BITS == 4) {
        uint32_t wv[4], tr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) wv[i] = lds32(base + i * GE::W_PITCH + 32 * hw + 4 * g);
        mma::transpose4x4(wv, tr);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[half][2 * j] = tr[j] & 0x0F0F0F0Fu;
          b[half][2 * j + 1] = (tr[j] >> 4) & 0x0F0F0F0Fu;
        }
      } else {
        uint32_t lo[4], hi[4], tl[4], th[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint2 v = *reinterpret_cast<const uint2*>(base + i * GE::W_PITCH + 64 * hw + 8 * g);
          lo[i] = v.x;
          hi[i] = v.y;
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
    for (int j = 0; j < 8; ++j) mma::mma_s8(acc[j], a, b[0][j], b[1][j]);
    mma::mma_s8(rs, a, 0x01010101u, 0x01010101u);
  }

  // sum the two K halves (int32, exact), then the epilogue
  mma::cp_async_wait<0>();
  __syncthreads();
  int* red = reinterpret_cast<int*>(smem) + (hw * 32 + lane) * RED;
  if (ks == 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[j * 4 + e] = acc[j][e];
    red[32] = rs[0];
    red[33] = rs[2];
  }
  __syncthreads();
  if (ks == 1) return;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += red[j * 4 + e];
  rs[0] += red[32];
  rs[2] += red[33];

  // thread (g, t) owns columns nb .. nb + 15 of rows m0 + g and m0 + g + 8:
  // MMA j's accumulator holds columns nb + j (first pair) and nb + 8 + j
  const int nb = n0 + 64 * hw + 16 * t;
  float s[16], z[16];
#pragma unroll
  for (int c = 0; c < 16; c += 4) {
    *reinterpret_cast<float4*>(s + c) = *reinterpret_cast<const float4*>(wscale + nb + c);
    *reinterpret_cast<float4*>(z + c) = *reinterpret_cast<const float4*>(wzero + nb + c);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + g + 8 * half;
    if (m >= M) continue;
    const float sxm = sx[m];
    const float rsf = static_cast<float>(rs[2 * half]);
    float o[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // the correction acc - wz * rs as one fused multiply-add, rounded
      // once as in the plain version; only the scale products differ in order
      o[j] = sxm * s[j] * fmaf(-z[j], rsf, static_cast<float>(acc[j][2 * half]));
      o[8 + j] = sxm * s[8 + j] * fmaf(-z[8 + j], rsf, static_cast<float>(acc[j][2 * half + 1]));
    }
    float* dst = y + (size_t)m * N + nb;
#pragma unroll
    for (int c = 0; c < 16; c += 4)
      *reinterpret_cast<float4*>(dst + c) = *reinterpret_cast<const float4*>(o + c);
  }
}

}  // namespace w4a8mma
