// Shared device helpers for the port's Hopper kernels (built for sm_90a by
// repro_torch/kernels/loader.py; every entry point has a plain C interface
// and returns cudaGetLastError()).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>

// The masked-score sentinel of the reference kernels (not -inf: a fully
// masked tile then stays finite, and the next live tile's correction factor
// exp(NEG_INF - m) wipes it exactly as in the Pallas kernels).
#define REPRO_NEG_INF (-1e30f)

// Fused in-kernel key dequantization, shared by the paged decode and the
// paged prefill kernels so both read the quantized bytes identically:
// k = (kq - zero) * scale in float32, per (token, head) scale/zero.
__device__ __forceinline__ float dequant_key(int8_t kq, float scale, float zero) {
  return (static_cast<float>(kq) - zero) * scale;
}

// fp8 e4m3 value byte -> float32 (values are stored scale-free).
__device__ __forceinline__ float fp8_to_float(uint8_t byte) {
  __nv_fp8_e4m3 f;
  f.__x = byte;
  return static_cast<float>(f);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
