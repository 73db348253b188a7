// Fused RMSNorm for Hopper.
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py::rmsnorm:
//   y = x * rsqrt(mean(x^2) + eps) * w
// with float32 math, x and y in bf16 or float32, w float32.
//
// What bounds it on the H100: bytes (one read and one write per element,
// three float ops per element).
//
// Design: one block per row (D = 3584 at qwen2-7b).  Threads stride over the
// row accumulating the sum of squares in float32, reduce across the block
// with warp shuffles, then stride again to scale and write.  The second read
// of the row hits L1/L2, so device memory sees one read and one write.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ y, int D, float eps) {
  __shared__ float partial[THREADS / 32];
  __shared__ float inv_rms;
  const T* xr = x + (size_t)blockIdx.x * D;
  T* yr = y + (size_t)blockIdx.x * D;
  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += THREADS) {
    const float v = to_f32(xr[d]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < THREADS / 32 ? partial[threadIdx.x] : 0.f;
    t = warp_sum(t);
    if (threadIdx.x == 0) inv_rms = rsqrtf(t / static_cast<float>(D) + eps);
  }
  __syncthreads();
  const float r = inv_rms;
  for (int d = threadIdx.x; d < D; d += THREADS) store(yr + d, to_f32(xr[d]) * r * w[d]);
}

}  // namespace

// x, y: [rows, D] bf16 (is_bf16 = 1) or float32; w float32 [D].
extern "C" int rmsnorm_launch(const void* x, const void* w, void* y, int rows, int D,
                              float eps, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    rmsnorm_kernel<__nv_bfloat16><<<rows, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<__nv_bfloat16*>(y), D, eps);
  else
    rmsnorm_kernel<float><<<rows, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), D, eps);
  return static_cast<int>(cudaGetLastError());
}
