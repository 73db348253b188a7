// W4A8 / W8A8 quantized matmul for Hopper.
//
// Replaces the TPU kernel repro/kernels/w4a8_matmul.py::w4a8_matmul:
//   y[M, N] f32 = sx * w_scale * (xq @ w - w_zero * rowsum(xq))
// with int8 activations xq [M, K] (per-row scale sx [M, 1]) and int4 weights
// packed two unsigned nibbles per byte along N (column 2j low, 2j+1 high) or
// int8 weights, each with a per-channel asymmetric scale/zero.
//
// What bounds it on the H100: at decode (M = 1..8) every weight byte is read
// once for a handful of rows, so the weight stream (bytes) bounds it; a
// 128-token prefill chunk does about 512 int8 operations per int4 weight
// byte, under the card's ~590 operations/byte ridge for int8 tensor cores,
// so its bound is still the bytes.  This kernel's __dp4a path has a far lower
// peak than the tensor cores, so in practice prefill is compute-limited here.
//
// Design: one block per 16 x 128 output tile (csrc/w4a8_tile.cuh).  No
// split-K, no tensor cores yet: narrow-N decode GEMMs launch few blocks (a
// later PR's work, together with mma.sync / wgmma).
#include "w4a8_tile.cuh"

namespace {

template <int BITS>
__global__ void __launch_bounds__(w4a8::THREADS)
w4a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
            const int8_t* __restrict__ w, const float* __restrict__ wscale,
            const float* __restrict__ wzero, float* __restrict__ y,
            int M, int N, int K) {
  w4a8::tile<BITS>(xq, sx, w, wscale, wzero, y, M, N, K,
                   blockIdx.y * w4a8::BM, blockIdx.x * w4a8::BN);
}

}  // namespace

// xq int8 [M, K]; sx f32 [M]; w int8 [K, N/2] (bits 4) or [K, N] (bits 8);
// scale/zero f32 [N]; y f32 [M, N].  Requires K % 64 == 0 and N % 128 == 0
// (the padded PackedLinear layout guarantees both).
extern "C" int w4a8_matmul_launch(const void* xq, const void* sx, const void* w,
                                  const void* scale, const void* zero, void* y,
                                  int M, int N, int K, int bits, void* stream) {
  const dim3 grid(N / w4a8::BN, (M + w4a8::BM - 1) / w4a8::BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(xq);
  const auto* wp = static_cast<const int8_t*>(w);
  if (bits == 4)
    w4a8_kernel<4><<<grid, w4a8::THREADS, 0, s>>>(
        xp, static_cast<const float*>(sx), wp, static_cast<const float*>(scale),
        static_cast<const float*>(zero), static_cast<float*>(y), M, N, K);
  else
    w4a8_kernel<8><<<grid, w4a8::THREADS, 0, s>>>(
        xp, static_cast<const float*>(sx), wp, static_cast<const float*>(scale),
        static_cast<const float*>(zero), static_cast<float*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
