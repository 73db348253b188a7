// Decode attention over a dense quantized KV cache, for Hopper.
//
// Replaces the TPU kernel repro/kernels/quant_attention.py::
// quant_decode_attention: one pre-scaled query token per row attends over
// the row's cache [S, Hkv, D]; int8 keys are dequantized in the kernel as
// (kq - zero) * scale, fp8 e4m3 values are read as they are, and softmax runs
// online in float32.  Keys at positions [0, length[b]) are live.
//
// What bounds it on the H100: bytes, as for the paged kernel (each live KV
// byte is read once and meets G queries).
//
// Design: one block per (row, KV head), running decode::attend
// (csrc/decode_attention.cuh) over the row's cache cut into blocks of up to
// 128 keys; blocks past the row's length are skipped, so only the live
// prefix is read.  The dense cache is the slot-synchronous Engine.generate
// path's (and the cross-attention cache's) layout.
#include "decode_attention.cuh"

namespace {

constexpr int BS = 128;

struct DenseBlocks {
  size_t row0;        // flat token index of the row's position 0
  int S, bs;
  __device__ int count() const { return (S + bs - 1) / bs; }
  __device__ int start(int p) const { return p * bs; }
  __device__ int size(int p) const { return min(bs, S - p * bs); }
  __device__ size_t first(int p) const { return row0 + static_cast<size_t>(p) * bs; }
};

__global__ void __launch_bounds__(decode::THREADS)
dense_decode_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kq,
                    const float* __restrict__ kscale, const float* __restrict__ kzero,
                    const uint8_t* __restrict__ v, const int* __restrict__ length,
                    float* __restrict__ out, int S, int Hkv, int G, int D, int bs) {
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const size_t row = static_cast<size_t>(b) * Hkv * G * D;
  const DenseBlocks blk{static_cast<size_t>(b) * S, S, bs};
  decode::attend(blk, q + row, kq, kscale, kzero, v, out + row, h, Hkv, G, D, bs,
                 min(length[b], S), 0);
}

}  // namespace

// q bf16 [B, H, D] pre-scaled; kq int8 [B, S, Hkv, D]; kscale/kzero f32
// [B, S, Hkv]; v fp8 e4m3 bytes [B, S, Hkv, D]; length int32 [B]; out f32
// [B, H, D].  G = H / Hkv <= 8, D % 16 == 0, D <= 128.
extern "C" int decode_attention_launch(
    const void* q, const void* kq, const void* kscale, const void* kzero,
    const void* v, const void* length, void* out, int B, int S, int Hkv, int G,
    int D, void* stream) {
  const int bs = S < BS ? S : BS;
  dense_decode_kernel<<<B * Hkv, decode::THREADS, decode::smem_bytes(G, D, bs),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(kscale), static_cast<const float*>(kzero),
      static_cast<const uint8_t*>(v), static_cast<const int*>(length),
      static_cast<float*>(out), S, Hkv, G, D, bs);
  return static_cast<int>(cudaGetLastError());
}
