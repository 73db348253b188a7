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
// Design: one block per (row, KV head).  The block walks the row's table
// columns, reading each physical page id from global memory (there is no
// scalar prefetch on this card), and skips columns with no live position,
// so only ceil(length / page) pages are touched.  Per page, each thread
// dequantizes one key row (16-byte loads) in registers and scores it against
// all G queries of the group held in shared memory; one warp per query head
// runs the online-softmax update; then thread d accumulates column d of P.V
// for all G heads.  G need not be a power of two (qwen2-7b has 7).
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MAXG = 8;

__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kq,
                    const float* __restrict__ kscale, const float* __restrict__ kzero,
                    const uint8_t* __restrict__ v, const int* __restrict__ table,
                    const int* __restrict__ base, const int* __restrict__ length,
                    float* __restrict__ out, int Hkv, int G, int D, int ps,
                    int n_pages, int window) {
  extern __shared__ float smem[];
  float* qs = smem;                 // [G, D]
  float* sc = qs + G * D;           // [G, ps] scores, then probabilities
  float* mrow = sc + G * ps;        // [G] running max
  float* lrow = mrow + G;           // [G] running denominator
  float* crow = lrow + G;           // [G] this page's correction

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int H = Hkv * G;

  for (int i = tid; i < G * D; i += THREADS)
    qs[i] = __bfloat162float(q[((size_t)b * H + h * G) * D + i]);
  if (tid < G) { mrow[tid] = REPRO_NEG_INF; lrow[tid] = 0.f; }

  float acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;

  const int len = length[b];
  const int lo_live = window ? max(0, len - window) : 0;
  const int row_base = base[b];

  for (int p = 0; p < n_pages; ++p) {
    const int lo = (row_base + p) * ps;
    if (lo + ps <= lo_live || lo >= len) continue;   // no live key on this page
    const size_t page = static_cast<size_t>(table[(size_t)b * n_pages + p]);
    __syncthreads();
    for (int t = tid; t < ps; t += THREADS) {
      const int pos = lo + t;
      float dot[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) dot[g] = 0.f;
      if (pos >= lo_live && pos < len) {
        const size_t tok = (page * ps + t) * Hkv + h;
        const float s = kscale[tok], z = kzero[tok];
        const int8_t* krow = kq + tok * D;
        for (int d0 = 0; d0 < D; d0 += 16) {
          const int4 raw = *reinterpret_cast<const int4*>(krow + d0);
          const int8_t* kb = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float kd = dequant_key(kb[j], s, z);
#pragma unroll
            for (int g = 0; g < MAXG; ++g)
              if (g < G) dot[g] += qs[g * D + d0 + j] * kd;
          }
        }
      } else {
#pragma unroll
        for (int g = 0; g < MAXG; ++g) dot[g] = REPRO_NEG_INF;
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) sc[g * ps + t] = dot[g];
    }
    __syncthreads();
    for (int g = warp; g < G; g += THREADS / 32) {
      float mx = REPRO_NEG_INF;
      for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, sc[g * ps + t]);
      mx = warp_max(mx);
      const float m_old = mrow[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < ps; t += 32) {
        const float e = expf(sc[g * ps + t] - m_new);
        sc[g * ps + t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        crow[g] = corr;
        lrow[g] = lrow[g] * corr + sum;
        mrow[g] = m_new;
      }
    }
    __syncthreads();
    if (tid < D) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) acc[g] *= crow[g];
      for (int t = 0; t < ps; ++t) {
        const float vt = fp8_to_float(v[((page * ps + t) * Hkv + h) * D + tid]);
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) acc[g] += sc[g * ps + t] * vt;
      }
    }
  }
  __syncthreads();
  if (tid < D) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G)
        out[((size_t)b * H + h * G + g) * D + tid] = acc[g] / fmaxf(lrow[g], 1e-30f);
  }
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
  const size_t smem = sizeof(float) * (static_cast<size_t>(G) * D + G * ps + 3 * G);
  paged_decode_kernel<<<B * Hkv, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(kscale), static_cast<const float*>(kzero),
      static_cast<const uint8_t*>(v), static_cast<const int*>(table),
      static_cast<const int*>(base), static_cast<const int*>(length),
      static_cast<float*>(out), Hkv, G, D, ps, n_pages, window);
  return static_cast<int>(cudaGetLastError());
}
