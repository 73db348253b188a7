// Decode attention over a dense quantized KV cache, for Hopper.
//
// Replaces the TPU kernel repro/kernels/quant_attention.py::
// quant_decode_attention: one pre-scaled query token per row attends over
// the row's cache [S, Hkv, D]; int8 keys are dequantized in the kernel as
// (kq - zero) * scale, fp8 e4m3 values are read as they are, and softmax runs
// online in float32.  Keys at positions [0, length[b]) are live.
//
// What bounds it on the H100: bytes, as for the paged kernel (each live KV
// byte is read once and meets G queries); at decode's 1-2 MB a launch is
// mostly load latency.
//
// Design: decode::attend (csrc/decode_attention.cuh) over the row's cache
// read as pages of 128 slots, split over them: ``splits`` blocks a (row, KV
// head, tile of up to 16 query heads), each a contiguous run of 128-slot
// blocks; blocks past the row's length are never read and a split holding
// none of the live prefix exits at once.  The dense cache is the
// slot-synchronous Engine.generate path's (and the cross-attention cache's)
// layout.
#include "decode_attention.cuh"

namespace {

constexpr int BS = 128;              // slots a key block (a "page" of the cache)

struct DensePages {
  size_t row0;        // flat token index of the row's position 0
  int S;
  int n_pages, ps, base, lo, hi;
  __device__ size_t first(int p) const { return row0 + static_cast<size_t>(p) * ps; }
  __device__ int size(int p) const { return min(ps, S - p * ps); }
};

template <int D, int ROWS>
__global__ void __launch_bounds__(decode::THREADS)
dense_decode_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kq,
                    const float* __restrict__ kscale, const float* __restrict__ kzero,
                    const uint8_t* __restrict__ v, const int* __restrict__ length,
                    float* __restrict__ out, int* __restrict__ scratch, int S, int Hkv,
                    int G, int splits) {
  const int b = blockIdx.y / Hkv, h = blockIdx.y % Hkv;
  const DensePages pg{static_cast<size_t>(b) * S, S, (S + BS - 1) / BS, BS, 0, 0,
                      min(length[b], S)};
  decode::attend_tile<D, ROWS>(pg, q, kq, kscale, kzero, v, out, scratch, b, h, Hkv, G,
                               splits);
}

template <int D>
void launch(const void* q, const void* kq, const void* kscale, const void* kzero,
            const void* v, const void* length, void* out, void* scratch, int B, int S,
            int Hkv, int G, int splits, cudaStream_t stream) {
  // a tile of at most 8 heads is compiled with its other 8 rows zero
  const auto kernel = G > 8 ? dense_decode_kernel<D, decode::RT> : dense_decode_kernel<D, 8>;
  kernel<<<decode::grid(B, Hkv, G, splits), decode::THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(kscale), static_cast<const float*>(kzero),
      static_cast<const uint8_t*>(v), static_cast<const int*>(length),
      static_cast<float*>(out), static_cast<int*>(scratch), S, Hkv, G, splits);
}

}  // namespace

// q bf16 [B, H, D] pre-scaled; kq int8 [B, S, Hkv, D]; kscale/kzero f32
// [B, S, Hkv]; v fp8 e4m3 bytes [B, S, Hkv, D]; length int32 [B]; out f32
// [B, H, D]; scratch as for the paged kernel, over ceil(S / 128) key blocks.
// Any G = H / Hkv (ceil(G / 16) head tiles); D % 16 == 0, D <= 128.
static int decode_attention(
    const void* q, const void* kq, const void* kscale, const void* kzero,
    const void* v, const void* length, void* out, void* scratch, int B, int S, int Hkv,
    int G, int D, int splits, void* stream) {
  if (splits < 1 || splits > decode::MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DENSE_DECODE(DIM)                                                        \
  case DIM:                                                                            \
    launch<DIM>(q, kq, kscale, kzero, v, length, out, scratch, B, S, Hkv, G, splits, s); \
    break;
  switch (D) {
    REPRO_DENSE_DECODE(16) REPRO_DENSE_DECODE(32) REPRO_DENSE_DECODE(48)
    REPRO_DENSE_DECODE(64) REPRO_DENSE_DECODE(80) REPRO_DENSE_DECODE(96)
    REPRO_DENSE_DECODE(112) REPRO_DENSE_DECODE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_DENSE_DECODE
  return static_cast<int>(cudaGetLastError());
}

// The entry point: the arguments above, packed (common.cuh, PackedArgs).
extern "C" int decode_attention_launch(const unsigned char* packed) {
  const PackedArgs a{packed};
  return decode_attention(a.ptr(0), a.ptr(1), a.ptr(2), a.ptr(3), a.ptr(4), a.ptr(5), a.ptr(6),
                          a.ptr(7), a.integer(8), a.integer(9), a.integer(10), a.integer(11),
                          a.integer(12), a.integer(13), a.ptr(14));
}
