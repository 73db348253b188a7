// Decode attention over a dense quantized KV cache, for Hopper.
//
// Replaces the TPU kernel repro/kernels/quant_attention.py::
// quant_decode_attention: one pre-scaled query token per row attends over
// the row's cache [S, Hkv, D]; int8 or int4 keys are dequantized in the
// kernel as (kq - zero) * scale, fp8 e4m3 or bf16 values are read as they
// are, and softmax runs online in float32.  Keys at positions [0, length[b]) are live.
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

template <int D, int ROWS, int KBITS, bool VBF16>
__global__ void __launch_bounds__(decode::THREADS)
dense_decode_kernel(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ kq,
                    const float* __restrict__ kscale, const float* __restrict__ kzero,
                    const uint8_t* __restrict__ v, const int* __restrict__ length,
                    float* __restrict__ out, int* __restrict__ scratch, int S, int Hkv,
                    int G, int splits) {
  const int b = blockIdx.y / Hkv, h = blockIdx.y % Hkv;
  const DensePages pg{static_cast<size_t>(b) * S, S, (S + BS - 1) / BS, BS, 0, 0,
                      min(length[b], S)};
  decode::attend_tile<D, ROWS, KBITS, VBF16>(pg, q, kq, kscale, kzero, v, out, scratch, b, h,
                                             Hkv, G, splits);
}

struct Launch {
  const void *q, *kq, *kscale, *kzero, *v, *length;
  void *out, *scratch;
  int B, S, Hkv, G, splits;
  cudaStream_t stream;

  template <int D, int KBITS, bool VBF16>
  void operator()() const {
    constexpr int smem = decode::Geo<D, KBITS, VBF16>::SMEM;
    static const bool ready = (decode::allow_smem(dense_decode_kernel<D, 8, KBITS, VBF16>, smem),
                               decode::allow_smem(dense_decode_kernel<D, decode::RT, KBITS, VBF16>,
                                                  smem),
                               true);
    (void)ready;
    // a tile of at most 8 heads is compiled with its other 8 rows zero
    const auto kernel = G > 8 ? dense_decode_kernel<D, decode::RT, KBITS, VBF16>
                              : dense_decode_kernel<D, 8, KBITS, VBF16>;
    kernel<<<decode::grid(B, Hkv, G, splits), decode::THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(kq),
        static_cast<const float*>(kscale), static_cast<const float*>(kzero),
        static_cast<const uint8_t*>(v), static_cast<const int*>(length),
        static_cast<float*>(out), static_cast<int*>(scratch), S, Hkv, G, splits);
  }
};

}  // namespace

// q bf16 [B, H, D] pre-scaled; kq int8 [B, S, Hkv, D] (key_bits 8) or
// [B, S, Hkv, D / 2] (key_bits 4); kscale/kzero f32 [B, S, Hkv]; v fp8 e4m3
// bytes (v_bf16 0) or bf16 (v_bf16 1) [B, S, Hkv, D]; length int32 [B]; out
// f32 [B, H, D]; scratch as for the paged kernel, over ceil(S / 128) key
// blocks.  Any G = H / Hkv (ceil(G / 16) head tiles); the head dims of
// decode::dispatch_variant.
static int decode_attention(
    const void* q, const void* kq, const void* kscale, const void* kzero,
    const void* v, const void* length, void* out, void* scratch, int B, int S, int Hkv,
    int G, int D, int splits, int key_bits, int v_bf16, void* stream) {
  if (splits < 1 || splits > decode::MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch run{q, kq, kscale, kzero, v, length, out, scratch, B, S, Hkv, G, splits,
                   static_cast<cudaStream_t>(stream)};
  if (!decode::dispatch_variant(D, key_bits, v_bf16, run))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The entry point: the arguments above, packed (common.cuh, PackedArgs).
extern "C" int decode_attention_launch(const unsigned char* packed) {
  const PackedArgs a{packed};
  return decode_attention(a.ptr(0), a.ptr(1), a.ptr(2), a.ptr(3), a.ptr(4), a.ptr(5), a.ptr(6),
                          a.ptr(7), a.integer(8), a.integer(9), a.integer(10), a.integer(11),
                          a.integer(12), a.integer(13), a.integer(14), a.integer(15),
                          a.ptr(16));
}
