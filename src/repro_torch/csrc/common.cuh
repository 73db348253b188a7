// Shared device helpers for the port's Hopper kernels (built for sm_90a by
// repro_torch/kernels/loader.py; every entry point has a plain C interface,
// takes its arguments packed (PackedArgs) and returns cudaGetLastError()).
#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>

// The arguments of an entry point, packed by the host into 8-byte words
// (kernels/loader.py: one ctypes argument instead of a conversion per
// argument): word i holds a pointer, an int64 or a double.
struct PackedArgs {
  const unsigned char* p;
  template <typename T>
  T word(int i) const {
    T v;
    memcpy(&v, p + 8 * i, sizeof(T));
    return v;
  }
  void* ptr(int i) const { return reinterpret_cast<void*>(word<uint64_t>(i)); }
  int integer(int i) const { return static_cast<int>(word<int64_t>(i)); }
  float real(int i) const { return static_cast<float>(word<double>(i)); }
};

// The masked-score sentinel of the reference kernels (not -inf: a fully
// masked tile then stays finite, and the next live tile's correction factor
// exp(NEG_INF - m) wipes it exactly as in the Pallas kernels).
#define REPRO_NEG_INF (-1e30f)

// Fused in-kernel key dequantization, shared by the decode and the paged
// prefill kernels so all read the quantized bytes identically:
// k = (kq - zero) * scale in float32, per (token, head) scale/zero.  The
// float overload takes the int8 code already converted (exactly) to float.
__device__ __forceinline__ float dequant_key(float kq, float scale, float zero) {
  return (kq - zero) * scale;
}

__device__ __forceinline__ float dequant_key(int8_t kq, float scale, float zero) {
  return dequant_key(static_cast<float>(kq), scale, zero);
}

// Byte i of w, an int8 code, as float -- exactly, without the I2F
// conversion unit: w ^ 0x80808080 holds the codes biased to [0, 255], which
// become the low mantissa bits of 2^23 and are subtracted back out.
__device__ __forceinline__ float int8_byte_to_float(uint32_t w_biased, int i) {
  return __int_as_float(__byte_perm(w_biased, 0x4B000000u, 0x7440 | i)) - 8388736.f;
}

// The int4 key code in bits shift .. shift + 3 of w (0..15) as float --
// exactly, as int8_byte_to_float does: the code becomes the low mantissa
// bits of 2^23, which is subtracted back out.
__device__ __forceinline__ float int4_nibble_to_float(uint32_t w, int shift) {
  return __int_as_float(0x4B000000u | ((w >> shift) & 0xFu)) - 8388608.f;
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
