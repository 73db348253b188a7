// The W4A8 / W8A8 output tile shared by the matmul kernels of the port
// (csrc/w4a8_matmul.cu, csrc/grouped_matmul.cu):
//   y[m0:m0+16, n0:n0+128] = sx * w_scale * (xq @ w - w_zero * rowsum(xq))
// with int8 activations xq [M, K], int4 weights packed two unsigned nibbles
// per byte along N (column 2j low, 2j+1 high) or int8 weights [K, N], and a
// per-channel asymmetric scale/zero.
//
// One block of 256 threads computes one 16 x 128 tile, looping over K in
// steps of 64.  Each step stages the xq tile and the weight tile in shared
// memory, unpacking the nibbles to int8 on the way in (Hopper has no int4
// MMA) and transposing so that the four K values of one output column sit in
// one 32-bit word.  Each thread accumulates its column for its rows with
// __dp4a in int32; the int32 row sums of xq are taken once per tile by the
// threads that load it.  The asymmetric-zero epilogue is applied once, in the
// Pallas order sx * ws * (acc - wz * rs).  Weights are read with 16-byte
// coalesced loads.  Requires K % 64 == 0 and N % 128 == 0 (the padded
// PackedLinear layout guarantees both).
#pragma once

#include "common.cuh"

namespace w4a8 {

constexpr int BM = 16;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int ROW_GROUPS = THREADS / BN;   // threads sharing one column
constexpr int RPT = BM / ROW_GROUPS;       // rows per thread
constexpr int WS_STRIDE = BK / 4 + 1;      // padded words per unpacked column

template <int BITS>
__device__ __forceinline__ void tile(const int8_t* __restrict__ xq,
                                     const float* __restrict__ sx,
                                     const int8_t* __restrict__ w,
                                     const float* __restrict__ wscale,
                                     const float* __restrict__ wzero,
                                     float* __restrict__ y, int M, int N, int K,
                                     int m0, int n0) {
  __shared__ __align__(16) int xs[BM][BK / 4];
  __shared__ __align__(16) int ws[BN][WS_STRIDE];
  __shared__ int rsum[BM];
  int8_t* wsb = reinterpret_cast<int8_t*>(&ws[0][0]);

  const int tid = threadIdx.x;
  const int col = tid % BN;
  const int rgroup = tid / BN;               // uniform within a warp
  const size_t wpitch = BITS == 4 ? N / 2 : N;

  if (tid < BM) rsum[tid] = 0;
  int acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0;
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += BK) {
    if (tid < BM * BK / 16) {                // activation tile, 16 B a thread
      const int m = tid / (BK / 16);
      const int c = (tid % (BK / 16)) * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (m0 + m < M)
        v = *reinterpret_cast<const int4*>(xq + (size_t)(m0 + m) * K + k0 + c);
      *reinterpret_cast<int4*>(&xs[m][c / 4]) = v;
      const int part = __dp4a(v.x, 0x01010101,
                       __dp4a(v.y, 0x01010101,
                       __dp4a(v.z, 0x01010101, __dp4a(v.w, 0x01010101, 0))));
      atomicAdd(&rsum[m], part);
    }
    if (BITS == 4) {                         // BK x BN/2 packed bytes
      const int k = tid / (BN / 32);
      const int c = (tid % (BN / 32)) * 16;
      const int4 v = *reinterpret_cast<const int4*>(
          w + (size_t)(k0 + k) * wpitch + n0 / 2 + c);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = 2 * (c + j);
        wsb[n * WS_STRIDE * 4 + k] = static_cast<int8_t>(b[j] & 0x0F);
        wsb[(n + 1) * WS_STRIDE * 4 + k] = static_cast<int8_t>(b[j] >> 4);
      }
    } else {                                 // BK x BN int8 bytes
#pragma unroll
      for (int it = 0; it < (BK * BN / 16) / THREADS; ++it) {
        const int idx = tid + it * THREADS;
        const int k = idx / (BN / 16);
        const int c = (idx % (BN / 16)) * 16;
        const int4 v = *reinterpret_cast<const int4*>(
            w + (size_t)(k0 + k) * wpitch + n0 + c);
        const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int j = 0; j < 16; ++j) wsb[(c + j) * WS_STRIDE * 4 + k] = b[j];
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int m = rgroup + i * ROW_GROUPS;
      if (m0 + m < M) {
        int a = acc[i];
#pragma unroll
        for (int kk = 0; kk < BK / 4; ++kk) a = __dp4a(xs[m][kk], ws[col][kk], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  const float s = wscale[n0 + col];
  const float z = wzero[n0 + col];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int mm = rgroup + i * ROW_GROUPS;
    const int m = m0 + mm;
    if (m < M)
      // the correction acc - wz * rs as one fused multiply-add, rounded
      // once as in the plain version; only the scale products differ in order
      y[(size_t)m * N + n0 + col] =
          sx[m] * s * fmaf(-z, static_cast<float>(rsum[mm]), static_cast<float>(acc[i]));
  }
}

}  // namespace w4a8
