// Grouped (per-expert) W4A8 / W8A8 matmul for Hopper.
//
// Replaces the TPU kernel repro/kernels/grouped_matmul.py::grouped_matmul:
//   y[e, M, N] f32 = sx[e] * w_scale[e] * (xq[e] @ w[e] - w_zero[e] * rowsum(xq[e]))
// for every expert e, in one launch: one int8 activation slab [M, K] and one
// int4 (two nibbles per byte along N) or int8 weight slab [K, N] per expert.
//
// What bounds it on the H100: the MoE decode path runs it on the K gathered
// experts of each token at M = 1, where the weight bytes bound it.  The
// prefill path runs every expert at full capacity (M = chunk rows, most of
// them zero padding), about 512 int8 operations per int4 weight byte -- the
// bytes still bound it on paper, but this kernel's __dp4a tile has a far
// lower peak than the tensor cores, so in practice it is compute-limited.
//
// Design: the matmul kernel's 16 x 128 output tile (csrc/w4a8_tile.cuh) with
// the expert as the grid's z dimension; each block offsets its pointers to
// its expert's slabs.  The kernel computes every row it is given, as the
// Pallas kernel does: rows past an expert's live tokens are zeros, and
// skipping them is later work.
#include "w4a8_tile.cuh"

namespace {

template <int BITS>
__global__ void __launch_bounds__(w4a8::THREADS)
grouped_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
               const int8_t* __restrict__ w, const float* __restrict__ wscale,
               const float* __restrict__ wzero, float* __restrict__ y,
               int M, int N, int K) {
  const size_t e = blockIdx.z;
  const size_t wslab = static_cast<size_t>(K) * (BITS == 4 ? N / 2 : N);
  w4a8::tile<BITS>(xq + e * M * K, sx + e * M, w + e * wslab, wscale + e * N,
                   wzero + e * N, y + e * M * N, M, N, K,
                   blockIdx.y * w4a8::BM, blockIdx.x * w4a8::BN);
}

}  // namespace

// xq int8 [E, M, K]; sx f32 [E, M]; w int8 [E, K, N/2] (bits 4) or
// [E, K, N] (bits 8); scale/zero f32 [E, N]; y f32 [E, M, N].  Requires
// K % 64 == 0, N % 128 == 0 (the padded PackedExpertLinear layout), and
// E and ceil(M / 16) at most 65535 (grid limits).
extern "C" int grouped_matmul_launch(const void* xq, const void* sx, const void* w,
                                     const void* scale, const void* zero, void* y,
                                     int E, int M, int N, int K, int bits,
                                     void* stream) {
  const dim3 grid(N / w4a8::BN, (M + w4a8::BM - 1) / w4a8::BM, E);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(xq);
  const auto* wp = static_cast<const int8_t*>(w);
  if (bits == 4)
    grouped_kernel<4><<<grid, w4a8::THREADS, 0, s>>>(
        xp, static_cast<const float*>(sx), wp, static_cast<const float*>(scale),
        static_cast<const float*>(zero), static_cast<float*>(y), M, N, K);
  else
    grouped_kernel<8><<<grid, w4a8::THREADS, 0, s>>>(
        xp, static_cast<const float*>(sx), wp, static_cast<const float*>(scale),
        static_cast<const float*>(zero), static_cast<float*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
