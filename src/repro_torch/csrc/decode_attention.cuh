// One-token (decode) attention over a quantized KV sequence, shared by the
// paged kernel (csrc/paged_decode_attention.cu) and the dense kernel
// (csrc/decode_attention.cu): the two differ only in where a block of keys
// lives, which the ``Blocks`` policy answers.
//
// One thread block serves one (row, KV head) and holds all G = H / Hkv
// queries of the group (G need not be a power of two; qwen2-7b has 7,
// moonshot 1).  It walks the row's key blocks and skips those with no live
// position.  Per block, each thread dequantizes one key row (16-byte loads,
// via dequant_key, so every decode kernel reads the quantized bytes
// identically) in registers and scores it against all G queries held in
// shared memory; one warp per query head runs the online-softmax update in
// float32; then thread d accumulates column d of P.V for all G heads from
// the fp8 e4m3 values.  Keys at logical position pos are live iff
// lo_live <= pos < len.
#pragma once

#include "common.cuh"

namespace decode {

constexpr int THREADS = 128;
constexpr int MAXG = 8;

// Shared floats one block needs for key blocks of up to bs keys.
inline size_t smem_bytes(int G, int D, int bs) {
  return sizeof(float) * (static_cast<size_t>(G) * D + static_cast<size_t>(G) * bs + 3 * G);
}

// Blocks: count() key blocks; for block p, start(p) is the logical position
// of its first key, size(p) its number of keys (<= bs), first(p) the flat
// token index (row of the [..., Hkv, D] arrays) of its first key.
// q: the row's bf16 queries [H, D]; out: the row's f32 output [H, D].
template <class Blocks>
__device__ __forceinline__ void attend(const Blocks& blk,
                                       const __nv_bfloat16* __restrict__ q,
                                       const int8_t* __restrict__ kq,
                                       const float* __restrict__ kscale,
                                       const float* __restrict__ kzero,
                                       const uint8_t* __restrict__ v,
                                       float* __restrict__ out, int h, int Hkv,
                                       int G, int D, int bs, int len, int lo_live) {
  extern __shared__ float smem[];
  float* qs = smem;                 // [G, D]
  float* sc = qs + G * D;           // [G, bs] scores, then probabilities
  float* mrow = sc + G * bs;        // [G] running max
  float* lrow = mrow + G;           // [G] running denominator
  float* crow = lrow + G;           // [G] this block's correction

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  for (int i = tid; i < G * D; i += THREADS)
    qs[i] = __bfloat162float(q[static_cast<size_t>(h) * G * D + i]);
  if (tid < G) { mrow[tid] = REPRO_NEG_INF; lrow[tid] = 0.f; }

  float acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;

  for (int p = 0; p < blk.count(); ++p) {
    const int lo = blk.start(p);
    const int nt = blk.size(p);
    if (lo + nt <= lo_live || lo >= len) continue;   // no live key here
    const size_t first = blk.first(p);
    __syncthreads();
    for (int t = tid; t < nt; t += THREADS) {
      const int pos = lo + t;
      float dot[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) dot[g] = 0.f;
      if (pos >= lo_live && pos < len) {
        const size_t tok = (first + t) * Hkv + h;
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
        if (g < G) sc[g * bs + t] = dot[g];
    }
    __syncthreads();
    for (int g = warp; g < G; g += THREADS / 32) {
      float mx = REPRO_NEG_INF;
      for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, sc[g * bs + t]);
      mx = warp_max(mx);
      const float m_old = mrow[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const float e = expf(sc[g * bs + t] - m_new);
        sc[g * bs + t] = e;
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
      for (int t = 0; t < nt; ++t) {
        const float vt = fp8_to_float(v[((first + t) * Hkv + h) * D + tid]);
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) acc[g] += sc[g * bs + t] * vt;
      }
    }
  }
  __syncthreads();
  if (tid < D) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G)
        out[(static_cast<size_t>(h) * G + g) * D + tid] = acc[g] / fmaxf(lrow[g], 1e-30f);
  }
}

}  // namespace decode
