// Paged decode attention over the quantized KV pool, for Hopper.
//
// Replaces the TPU kernel
// repro/kernels/quant_attention.py::paged_quant_decode_attention: one
// pre-scaled query token per row attends over the row's pages, reached
// through a per-row page table; int8 or int4 keys are dequantized in the
// kernel as (kq - zero) * scale, fp8 e4m3 or bf16 values are read as they
// are, and softmax runs online in float32.  Keys at logical position pos are live iff
// 0 <= pos < length (and pos >= length - window for windowed pools), with
// pos = (base + table column) * page + offset.
//
// What bounds it on the H100: bytes.  Each live KV byte is read once and
// meets G = H / Hkv queries, about 2G operations a byte -- far below the
// ridge; at decode's 1-2 MB a launch is mostly load latency.
//
// Design: decode::attend (csrc/decode_attention.cuh) split over the row's
// pages: ``splits`` blocks a (row, KV head, tile of up to 16 query heads),
// each a contiguous run of table columns, so a 4-row qwen2-7b step's 16
// (row, KV head) pairs fill the card with one page a block instead of
// walking up to 16 pages in one block.  A block reads the physical page id
// from the table in global memory (there is no scalar prefetch on this
// card) only for the pages it stages, and a split with no live position
// exits at once, so only ceil(length / page) pages are touched and the
// trash page never is.
#include "decode_attention.cuh"

namespace {

struct PagedPages {
  const int* table;   // this row's table columns
  int n_pages, ps, base, lo, hi;
  __device__ size_t first(int p) const { return static_cast<size_t>(table[p]) * ps; }
  __device__ int size(int) const { return ps; }
};

template <int D, int ROWS, int KBITS, bool VBF16>
__global__ void __launch_bounds__(decode::THREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ kq,
                    const float* __restrict__ kscale, const float* __restrict__ kzero,
                    const uint8_t* __restrict__ v, const int* __restrict__ table,
                    const int* __restrict__ base, const int* __restrict__ length,
                    float* __restrict__ out, int* __restrict__ scratch, int Hkv, int G,
                    int ps, int n_pages, int window, int splits) {
  const int b = blockIdx.y / Hkv, h = blockIdx.y % Hkv;
  const int len = length[b];
  const int bs = base[b];
  const int lo = max(window ? max(0, len - window) : 0, bs * ps);
  const int hi = min(len, (bs + n_pages) * ps);
  const PagedPages pg{table + static_cast<size_t>(b) * n_pages, n_pages, ps, bs, lo, hi};
  decode::attend_tile<D, ROWS, KBITS, VBF16>(pg, q, kq, kscale, kzero, v, out, scratch, b, h,
                                             Hkv, G, splits);
}

struct Launch {
  const void *q, *kq, *kscale, *kzero, *v, *table, *base, *length;
  void *out, *scratch;
  int B, Hkv, G, ps, n_pages, window, splits;
  cudaStream_t stream;

  template <int D, int KBITS, bool VBF16>
  void operator()() const {
    constexpr int smem = decode::Geo<D, KBITS, VBF16>::SMEM;
    static const bool ready = (decode::allow_smem(paged_decode_kernel<D, 8, KBITS, VBF16>, smem),
                               decode::allow_smem(paged_decode_kernel<D, decode::RT, KBITS, VBF16>,
                                                  smem),
                               true);
    (void)ready;
    // a tile of at most 8 heads is compiled with its other 8 rows zero
    const auto kernel = G > 8 ? paged_decode_kernel<D, decode::RT, KBITS, VBF16>
                              : paged_decode_kernel<D, 8, KBITS, VBF16>;
    kernel<<<decode::grid(B, Hkv, G, splits), decode::THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(kq),
        static_cast<const float*>(kscale), static_cast<const float*>(kzero),
        static_cast<const uint8_t*>(v), static_cast<const int*>(table),
        static_cast<const int*>(base), static_cast<const int*>(length),
        static_cast<float*>(out), static_cast<int*>(scratch), Hkv, G, ps, n_pages, window,
        splits);
  }
};

}  // namespace

// q bf16 [B, H, D] pre-scaled; kq int8 [P, ps, Hkv, D] (key_bits 8) or
// [P, ps, Hkv, D / 2] (key_bits 4: nibble pairs); kscale/kzero f32
// [P, ps, Hkv]; v fp8 e4m3 bytes (v_bf16 0) or bf16 (v_bf16 1)
// [P, ps, Hkv, D]; table int32 [B, n_pages]; base/length int32 [B]; out f32
// [B, H, D]; scratch int32, zeroed once and left zeroed by every launch
// (decode_attention.cuh; may be null when splits is 1).  Any G = H / Hkv
// (ceil(G / 16) head tiles); int8 keys with fp8 values at D % 16 == 0, D <=
// 128, the other variants at D = 64 and 128 (decode::dispatch_variant).
static int paged_decode_attention(
    const void* q, const void* kq, const void* kscale, const void* kzero,
    const void* v, const void* table, const void* base, const void* length,
    void* out, void* scratch, int B, int Hkv, int G, int D, int ps, int n_pages,
    int window, int splits, int key_bits, int v_bf16, void* stream) {
  if (splits < 1 || splits > decode::MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch run{q, kq, kscale, kzero, v, table, base, length, out, scratch, B, Hkv, G, ps,
                   n_pages, window, splits, static_cast<cudaStream_t>(stream)};
  if (!decode::dispatch_variant(D, key_bits, v_bf16, run))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The entry point: the arguments above, packed (common.cuh, PackedArgs).
extern "C" int paged_decode_attention_launch(const unsigned char* packed) {
  const PackedArgs a{packed};
  return paged_decode_attention(a.ptr(0), a.ptr(1), a.ptr(2), a.ptr(3), a.ptr(4), a.ptr(5),
                                a.ptr(6), a.ptr(7), a.ptr(8), a.ptr(9), a.integer(10),
                                a.integer(11), a.integer(12), a.integer(13), a.integer(14),
                                a.integer(15), a.integer(16), a.integer(17), a.integer(18),
                                a.integer(19), a.ptr(20));
}
