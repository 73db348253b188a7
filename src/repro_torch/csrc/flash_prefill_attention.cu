// Blockwise (flash) prefill attention over unquantized K/V, for Hopper.
//
// Replaces the TPU kernel repro/kernels/flash_prefill.py::
// flash_prefill_attention: pre-scaled bf16 queries [B, T, H, D] attend over
// bf16 keys/values [B, S, Hkv, D] (GQA, G = H / Hkv query heads per KV head)
// with online softmax in float32.  Query i sits at position i; key j is
// live iff j < S, and j <= i when causal, and i - j < window when window > 0.
//
// What bounds it on the H100: operations at long prompts (each key tile is
// reused by every query row of the block), bytes for short ones.  This
// kernel computes on CUDA cores in float32 (no tensor cores yet).
//
// Design: prefill::attend (csrc/prefill_attention.cuh) over the row's keys
// in tiles of 32 read straight from the bf16 arrays: only tiles that can
// hold a live key for one of the block's queries are walked -- tiles past
// its last query are skipped when causal, tiles wholly outside the window of
// its first query when windowed.
#include "prefill_attention.cuh"

namespace {

using prefill::TS;

struct DenseTiles {
  const __nv_bfloat16* __restrict__ k;
  const __nv_bfloat16* __restrict__ v;
  size_t row0;        // flat token index of the row's position 0
  int S, D, causal, window;
  __device__ int qpos(int i) const { return i; }
  __device__ int begin(int qlo) const {
    return window ? max(0, qlo - window + 1) / TS : 0;
  }
  __device__ int end(int qhi) const { return ((causal ? min(S, qhi + 1) : S) + TS - 1) / TS; }
  __device__ int start(int it) const { return it * TS; }
  __device__ int size(int it) const { return min(TS, S - it * TS); }
  __device__ size_t first(int it) const { return row0 + static_cast<size_t>(it) * TS; }
  __device__ float key(size_t tok, int d) const { return __bfloat162float(k[tok * D + d]); }
  __device__ float value(size_t tok, int d) const { return __bfloat162float(v[tok * D + d]); }
  __device__ bool live(int qp, int kp) const {
    return (!causal || kp <= qp) && (!window || qp - kp < window);
  }
};

__global__ void __launch_bounds__(prefill::THREADS)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, float* __restrict__ out,
                     int T, int S, int Hkv, int G, int D, int causal, int window) {
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const DenseTiles tiles{k, v, static_cast<size_t>(b) * S, S, D, causal, window};
  prefill::attend(tiles, q, out, b, h, T, Hkv, G, D);
}

}  // namespace

// q bf16 [B, T, H, D] pre-scaled; k/v bf16 [B, S, Hkv, D]; out f32
// [B, T, H, D].  D <= 128; ceil(T * G / 16) at most 65535.
extern "C" int flash_prefill_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int T, int S,
    int Hkv, int G, int D, int causal, int window, void* stream) {
  flash_prefill_kernel<<<prefill::grid(B, Hkv, T, G), prefill::THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out), T, S, Hkv, G,
      D, causal, window);
  return static_cast<int>(cudaGetLastError());
}
