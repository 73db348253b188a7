// Paged decode attention over the quantized KV pool, for Hopper.
//
// Replaces the TPU kernel
// repro/kernels/quant_attention.py::paged_quant_decode_attention: one
// pre-scaled query token per row attends over the row's pages, reached
// through a per-row page table; int8 keys are dequantized in the kernel as
// (kq - zero) * scale, fp8 e4m3 values are read as they are, and softmax runs
// online in float32.  Keys at logical position pos are live iff
// 0 <= pos < length (and pos >= length - window for windowed pools), with
// pos = (base + table column) * page + offset.
//
// What bounds it on the H100: bytes.  Each live KV byte is read once and
// meets G = H / Hkv queries, about 2G float ops per byte -- far below the
// ridge.
//
// Design: one block per (row, KV head), running decode::attend
// (csrc/decode_attention.cuh) with one key block per page.  The block reads
// each physical page id from the table in global memory (there is no scalar
// prefetch on this card) only for pages with a live position, so only
// ceil(length / page) pages are touched and the trash page never is.
#include "decode_attention.cuh"

namespace {

struct PagedBlocks {
  const int* table;   // this row's table columns
  int n_pages, ps, base;
  __device__ int count() const { return n_pages; }
  __device__ int start(int p) const { return (base + p) * ps; }
  __device__ int size(int) const { return ps; }
  __device__ size_t first(int p) const { return static_cast<size_t>(table[p]) * ps; }
};

__global__ void __launch_bounds__(decode::THREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kq,
                    const float* __restrict__ kscale, const float* __restrict__ kzero,
                    const uint8_t* __restrict__ v, const int* __restrict__ table,
                    const int* __restrict__ base, const int* __restrict__ length,
                    float* __restrict__ out, int Hkv, int G, int D, int ps,
                    int n_pages, int window) {
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const size_t row = static_cast<size_t>(b) * Hkv * G * D;
  const int len = length[b];
  const int lo_live = window ? max(0, len - window) : 0;
  const PagedBlocks blk{table + static_cast<size_t>(b) * n_pages, n_pages, ps, base[b]};
  decode::attend(blk, q + row, kq, kscale, kzero, v, out + row, h, Hkv, G, D, ps,
                 len, lo_live);
}

}  // namespace

// q bf16 [B, H, D] pre-scaled; kq int8 [P, ps, Hkv, D]; kscale/kzero f32
// [P, ps, Hkv]; v fp8 e4m3 bytes [P, ps, Hkv, D]; table int32 [B, n_pages];
// base/length int32 [B]; out f32 [B, H, D].  G = H / Hkv <= 8, D % 16 == 0,
// D <= 128.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* kq, const void* kscale, const void* kzero,
    const void* v, const void* table, const void* base, const void* length,
    void* out, int B, int Hkv, int G, int D, int ps, int n_pages, int window,
    void* stream) {
  paged_decode_kernel<<<B * Hkv, decode::THREADS, decode::smem_bytes(G, D, ps),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(kscale), static_cast<const float*>(kzero),
      static_cast<const uint8_t*>(v), static_cast<const int*>(table),
      static_cast<const int*>(base), static_cast<const int*>(length),
      static_cast<float*>(out), Hkv, G, D, ps, n_pages, window);
  return static_cast<int>(cudaGetLastError());
}
