// Paged prefill (prompt-chunk) attention over the quantized KV pool, for
// Hopper.
//
// Replaces the TPU kernel
// repro/kernels/flash_prefill.py::paged_flash_prefill_attention: a chunk of C
// pre-scaled queries at absolute positions pos0 + [0, C) attends causally
// over the row's pages through the page table, with int8 key dequantization
// fused in, fp8 e4m3 values read as they are, and online softmax in float32.
//
// What bounds it on the H100: operations at long contexts (each key tile is
// reused by every query row of the block), bytes for short ones; at the
// serving chunk sizes here both are small next to the chunk's matmuls.
//
// Design: prefill::attend (csrc/prefill_attention.cuh) over the row's pages
// in tiles of up to 32 keys (a tile never crosses a page), with the causal
// mask pos0 + i >= key position.  Keys are dequantized through the same
// dequant_key as the decode kernels.  Pages (and tiles) that start past the
// block's last query are skipped; the page id is read once per tile.
#include "prefill_attention.cuh"

namespace {

using prefill::TS;

struct PagedTiles {
  const int8_t* __restrict__ kq;
  const float* __restrict__ kscale;
  const float* __restrict__ kzero;
  const uint8_t* __restrict__ v;
  const int* __restrict__ row_table;   // the row's page ids [n_pages]
  int p0, ps, n_pages, D;
  __device__ int tiles_per_page() const { return (ps + TS - 1) / TS; }
  __device__ int qpos(int i) const { return p0 + i; }
  __device__ int begin(int) const { return 0; }
  __device__ int end(int qhi) const {
    const int tpp = tiles_per_page();
    return min(n_pages * tpp, qhi / ps * tpp + qhi % ps / TS + 1);
  }
  __device__ int start(int it) const {
    const int tpp = tiles_per_page();
    return it / tpp * ps + it % tpp * TS;
  }
  __device__ int size(int it) const { return min(TS, ps - it % tiles_per_page() * TS); }
  __device__ size_t first(int it) const {
    const int tpp = tiles_per_page();
    return static_cast<size_t>(row_table[it / tpp]) * ps + it % tpp * TS;
  }
  __device__ float key(size_t tok, int d) const {
    return dequant_key(kq[tok * D + d], kscale[tok], kzero[tok]);
  }
  __device__ float value(size_t tok, int d) const { return fp8_to_float(v[tok * D + d]); }
  __device__ bool live(int qp, int kp) const { return kp <= qp; }
};

__global__ void __launch_bounds__(prefill::THREADS)
paged_prefill_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kq,
                     const float* __restrict__ kscale, const float* __restrict__ kzero,
                     const uint8_t* __restrict__ v, const int* __restrict__ table,
                     const int* __restrict__ pos0, float* __restrict__ out,
                     int C, int Hkv, int G, int D, int ps, int n_pages) {
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const PagedTiles tiles{kq, kscale, kzero, v, table + static_cast<size_t>(b) * n_pages,
                         pos0[b], ps, n_pages, D};
  prefill::attend(tiles, q, out, b, h, C, Hkv, G, D);
}

}  // namespace

// q bf16 [B, C, H, D] pre-scaled; pool arrays as for the decode kernel; table
// int32 [B, n_pages]; pos0 int32 [B]; out f32 [B, C, H, D].  D <= 128.
extern "C" int paged_prefill_attention_launch(
    const void* q, const void* kq, const void* kscale, const void* kzero,
    const void* v, const void* table, const void* pos0, void* out, int B, int C,
    int Hkv, int G, int D, int ps, int n_pages, void* stream) {
  paged_prefill_kernel<<<prefill::grid(B, Hkv, C, G), prefill::THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(kscale), static_cast<const float*>(kzero),
      static_cast<const uint8_t*>(v), static_cast<const int*>(table),
      static_cast<const int*>(pos0), static_cast<float*>(out), C, Hkv, G, D, ps,
      n_pages);
  return static_cast<int>(cudaGetLastError());
}
