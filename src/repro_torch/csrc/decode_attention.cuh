// One-token (decode) attention over a quantized KV sequence on the bf16
// tensor cores, split over keys (flash-decoding); shared by the paged kernel
// (csrc/paged_decode_attention.cu) and the dense kernel
// (csrc/decode_attention.cu), which differ only in where a page of keys
// lives (the ``Pages`` policy).  The dense cache is read as pages of 128
// slots.  Keys are int8 (D bytes a row) or int4 (D / 2 bytes: column 2j in
// the low nibble, 2j + 1 in the high one); values are fp8 e4m3 (D bytes) or
// bf16 (2D bytes), each variant one instantiation of the same body
// (``KBITS``, ``VBF16``).
//
// What bounds it on the H100: bytes.  Each live key costs its key bytes (D
// at int8, D / 2 at int4), its value bytes (D at fp8, 2D at bf16) and 8
// bytes of scale and zero, and meets only G = H / Hkv queries (about 2G
// operations a byte).  At decode the live bytes are few
// (~1,600 live keys of a 4-row qwen2-7b step: 1.7 MB a layer), so what a
// launch costs is mostly the latency of its loads, and the design's job is
// to have many of them in flight on many SMs at once.
//
// Design.  The grid is (split, row x KV head, head tile): each (row, KV
// head) has ``splits`` blocks for each tile of up to 16 of its G query
// heads, each taking a contiguous run of pages (chosen on the host from
// shapes alone, kernels/quant_attention.py::decode_splits); a block whose
// pages hold no live key exits at once, so page ids past the row's length
// (and the trash page) are never read.  The head tiles of one (row, KV
// head) read the same keys and values and keep their own partials and
// combine counter; G <= 16 is one tile.  A block of 4 warps walks its live
// tiles of up to 64 keys (a tile never crosses a page).  Each tile's key
// codes, values and per-key scale and zero come in through cp.async (16
// bytes a thread, neighbouring threads on neighbouring bytes of a key row),
// double-buffered, so the next tile lands while this one is scored.  Warp w
// takes keys 16w..16w+15 of every tile, with its own online softmax: S =
// Q.K^T on mma.sync m16n8k16, the head tile's query heads in the A tile's
// rows (head g in row g, rows past the tile's heads zero), each row with
// its own running max and denominator (a lane holds rows g and g + 8; a
// kernel for groups of at most 8 heads is compiled with rows 8..15
// constant zero, so they cost it no registers), keys dequantized in
// registers through dequant_key and rounded to bf16 (an int4 key byte holds
// the two consecutive dims a B-fragment register takes); then O += P.V on
// the same MMA, P rounded to bf16 and the e4m3 values converted to bf16
// (exact) in registers, bf16 values taken as they are.  The key order
// inside a warp's 16 is permuted so
// that the S accumulators are P's A fragment and each value fragment comes
// from whole 4-byte (fp8) or 8-byte (bf16) words.  At the end of the split the warps merge in
// shared memory.  With one live split the block writes the output;
// otherwise it writes its partial (running max m, denominator l,
// unnormalised acc[heads, D], float32) to the scratch buffer, and the last
// block of the (row, KV head, head tile) to finish -- found by an
// atomicAdd on the tile's counter after a __threadfence -- combines the
// partials exactly (rescaled by exp(m_s - m), summed, divided by max(l,
// 1e-30)) and resets the counter to 0 for the next launch or CUDA-graph
// replay.  One launch, no allocation in the kernel.  The stage buffers are
// dynamic shared memory: two stages of int8 keys and bf16 values at D = 128
// take 55 KB.
//
// Rounding against the plain version (kernels/quant_attention.py): keys are
// rounded to bf16 after dequantization and P to bf16 before P.V, as there;
// scores, softmax statistics and sums are float32.  P is rounded relative
// to its warp's running max within its split, not the global max, and the
// denominator sums the unrounded P (the plain version rounds normalised P).
// Keys at logical position pos are live iff lo <= pos < hi; a (row, KV head)
// with no live key gets zeros.
#pragma once

#include "mma.cuh"

namespace decode {

constexpr int TS = 64;                 // keys per staged tile
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_SPLITS = 256;        // splits a (row, KV head) at most
constexpr int RT = 16;                 // query heads a block: the rows of one A tile

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// D: head dim; KBITS: 8 or 4 (key bytes a row KB = D or D / 2); VBF16:
// values bf16 (VB = 2D bytes a row) or fp8 e4m3 (VB = D).
template <int D, int KBITS, bool VBF16>
struct Geo {
  static_assert(D % 16 == 0 && D <= 128, "head dims: multiples of 16 up to 128");
  static_assert(KBITS == 8 || (D % 64 == 0), "int4 keys: head dims 64 and 128");
  static_assert(!VBF16 || (D % 64 == 0), "bf16 values: head dims 64 and 128");
  static constexpr int KB = D * KBITS / 8;             // key bytes a row
  static constexpr int VB = VBF16 ? 2 * D : D;         // value bytes a row
  static constexpr int KP = KB + 16;                   // bytes per key row in shared memory
  // bytes per value row in shared memory: 8 words past a multiple of 32, so
  // a warp's fragment loads (4 bytes a lane for fp8, 8 for bf16) are
  // conflict-free
  static constexpr int VP = (VB + 127) / 128 * 128 + 32;
  static constexpr int KS = D / 4 * KBITS / 8;         // key bytes of one lane's D / 4 dims
  static constexpr int DP = (D + 31) / 32 * 32;        // value columns the P.V MMAs cover
  static constexpr int NB = DP / 8;                    // n8 column blocks of O
  static constexpr int KD = D / 16;                    // k16 steps of Q.K^T
  static constexpr int STAGE = TS * KP + TS * VP + TS * 8;   // keys, values, (scale, zero)
  static constexpr int MERGE = (3 * WARPS * RT + WARPS * RT * D + 2 * RT) * 4;
  static constexpr int COMBINE = (2 * MAX_SPLITS * RT + RT) * 4;
  // the stage buffers, reused by the warps' merge and the splits' combine
  // (the combine area is the larger below D = 80); dynamic shared memory
  static constexpr int SMEM = cmax(2 * STAGE, cmax(MERGE, COMBINE));
  static_assert(SMEM <= 227 * 1024, "shared memory");
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One query row's online softmax step over a lane's four keys x (live
// where ``live``), reduced over the lane's quad: updates the row's running
// max m and denominator l, writes the unnormalised probabilities p and
// returns the factor that rescales the row's accumulators.
__device__ __forceinline__ float online_softmax(const float (&x)[4], const bool (&live)[4],
                                                float& m, float& l, float (&p)[4]) {
  float mx = REPRO_NEG_INF;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (live[i]) mx = fmaxf(mx, x[i]);
  const float mn = fmaxf(m, quad_max(mx));
  const float corr = exp2f((m - mn) * LOG2E);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    p[i] = live[i] ? exp2f((x[i] - mn) * LOG2E) : 0.f;
    sum += p[i];
  }
  l = l * corr + quad_sum(sum);
  m = mn;
  return corr;
}

// Byte e of x (lo) and of y (hi), two fp8 e4m3 values -> one register of two
// bf16 (lo in the low half), exactly and without the conversion unit: the
// sign goes to bit 15, exponent and mantissa to bits 10..4 (an exponent
// 120 too small, e4m3's subnormals landing on bf16's), and one bf16 multiply
// by 2^120 restores the scale.
__device__ __forceinline__ uint32_t e4m3_pair_to_bf16x2(uint32_t x, uint32_t y, int e) {
  const uint32_t z = __byte_perm(x, y, (e * 0x11) | ((4 + e) * 0x1100));   // bytes [e, e, 4+e, 4+e]
  const uint32_t bits = ((z >> 4) & 0x07F007F0u) | (z & 0x80008000u);
  uint32_t out;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(out) : "r"(bits), "r"(0x7B807B80u));
  return out;
}

// NW = BYTES / 4 words of one lane's slice of a key row from shared memory
// (16- or 8-byte loads where the slice allows).
template <int BYTES>
__device__ __forceinline__ void load_key_words(uint32_t (&w)[BYTES / 4], const uint8_t* src) {
  static_assert(BYTES % 4 == 0, "whole words");
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 x = *reinterpret_cast<const uint4*>(src + 16 * i);
      w[4 * i] = x.x; w[4 * i + 1] = x.y; w[4 * i + 2] = x.z; w[4 * i + 3] = x.w;
    }
  } else if constexpr (BYTES % 8 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 8; ++i) {
      const uint2 x = *reinterpret_cast<const uint2*>(src + 8 * i);
      w[2 * i] = x.x; w[2 * i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < BYTES / 4; ++i) w[i] = *reinterpret_cast<const uint32_t*>(src + 4 * i);
  }
}

// The four key codes of k16 step c of a lane (dims D/4 * t + 4c .. + 3), as
// exact floats: int8, byte i of word c (biased by 0x80 in int8_byte_to_float);
// int4, nibble i of halfword c (int4_nibble_to_float).
template <int KBITS>
__device__ __forceinline__ void key_codes(const uint32_t* w, int c, float (&k)[4]) {
  if constexpr (KBITS == 8) {
    const uint32_t x = w[c] ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i) k[i] = int8_byte_to_float(x, i);
  } else {
    const uint32_t x = w[c / 2] >> (16 * (c % 2));
#pragma unroll
    for (int i = 0; i < 4; ++i) k[i] = int4_nibble_to_float(x, 4 * i);
  }
}

// Value dims 32u + 4g + e (e = 0..3) of keys t and 4 + t (x0, x1: their
// 4 bytes (fp8) or 8 bytes (bf16) there) -> the B-fragment register of
// column e: two bf16, key t's in the low half.
template <bool VBF16>
__device__ __forceinline__ uint32_t value_pair(uint2 x0, uint2 x1, int e) {
  if constexpr (VBF16) {
    const uint32_t a = e < 2 ? x0.x : x0.y, b = e < 2 ? x1.x : x1.y;
    return __byte_perm(a, b, e % 2 ? 0x7632 : 0x5410);
  } else {
    return e4m3_pair_to_bf16x2(x0.x, x1.x, e);
  }
}

// Pages: page p of the row (0 <= p < n_pages) holds size(p) keys at logical
// positions (base + p) * ps + [0, size(p)); first(p) is the flat token index
// (row of the [..., Hkv, D] arrays) of its first key.  [lo, hi) are the live
// positions.  q: the tile's bf16 queries [G, D] (G <= ROWS heads of KV
// head h; ROWS is 8 or RT); kq: key codes, KB bytes a (token, head); v:
// values, VB bytes a (token, head) (Geo); out: their f32 output [G, D];
// part: the tile's partials [splits][G * (D + 2)] and counter its combine
// counter (unused when one split is live).  The caller launches with
// Geo::SMEM bytes of dynamic shared memory.
template <int D, int ROWS, int KBITS, bool VBF16, class Pages>
__device__ __forceinline__ void attend(const Pages& pg, const __nv_bfloat16* __restrict__ q,
                                       const uint8_t* __restrict__ kq,
                                       const float* __restrict__ kscale,
                                       const float* __restrict__ kzero,
                                       const uint8_t* __restrict__ v,
                                       float* __restrict__ out, float* __restrict__ part,
                                       int* __restrict__ counter, int h, int Hkv, int G,
                                       int split, int splits) {
  static_assert(ROWS == 8 || ROWS == RT, "a tile holds 8 or 16 heads");
  constexpr bool TWO = ROWS > 8;              // rows 8..15 hold heads
  using Gm = Geo<D, KBITS, VBF16>;
  constexpr int KP = Gm::KP, VP = Gm::VP, KB = Gm::KB, VB = Gm::VB;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;

  if (pg.lo >= pg.hi) {                       // no live key: zeros, once
    if (split == 0)
      for (int i = tid; i < G * D; i += THREADS) out[i] = 0.f;
    return;
  }
  // live pages, splits and tiles (tile it: page it / tpp, keys (it % tpp) * TS ..)
  const int tpp = (pg.ps + TS - 1) / TS;
  const int per = (pg.n_pages + splits - 1) / splits;          // pages a split
  const int origin = pg.base * pg.ps;
  const int L_lo = pg.lo - origin, L_hi = pg.hi - 1 - origin;  // logical, from column 0
  const int s_lo = L_lo / pg.ps / per, s_hi = L_hi / pg.ps / per;
  if (split < s_lo || split > s_hi) return;
  const int n_live = s_hi - s_lo + 1;
  const int it0 = max(L_lo / pg.ps * tpp + L_lo % pg.ps / TS, split * per * tpp);
  const int it1 = min(L_hi / pg.ps * tpp + L_hi % pg.ps / TS + 1,
                      min((split + 1) * per, pg.n_pages) * tpp);

  auto stage = [&](int it, int slot) {
    uint8_t* ks = smem + slot * Gm::STAGE;
    uint8_t* vs = ks + TS * KP;
    float* sz = reinterpret_cast<float*>(vs + TS * VP);
    const int p = it / tpp, off = it % tpp * TS;
    const int nt = min(TS, pg.size(p) - off);
    const size_t first = pg.first(p) + off;
    for (int c = tid; c < TS * (KB / 16); c += THREADS) {
      const int r = c / (KB / 16), ch = c % (KB / 16);
      const bool ok = r < nt;                 // past the tile: zero filled
      const size_t at = ((first + r) * Hkv + h) * KB + ch * 16;
      mma::cp_async16(ks + r * KP + ch * 16, ok ? kq + at : kq, ok);
    }
    for (int c = tid; c < TS * (VB / 16); c += THREADS) {
      const int r = c / (VB / 16), ch = c % (VB / 16);
      const bool ok = r < nt;
      const size_t at = ((first + r) * Hkv + h) * VB + ch * 16;
      mma::cp_async16(vs + r * VP + ch * 16, ok ? v + at : v, ok);
    }
    for (int r = tid; r < TS; r += THREADS) {
      const bool ok = r < nt;
      const size_t tok = (first + r) * Hkv + h;
      mma::cp_async4(sz + 2 * r, ok ? kscale + tok : kscale, ok);
      mma::cp_async4(sz + 2 * r + 1, ok ? kzero + tok : kzero, ok);
    }
  };
  stage(it0, 0);
  mma::cp_async_commit();
  if (it0 + 1 < it1) stage(it0 + 1, 1);
  mma::cp_async_commit();

  // Q's A fragments: step c covers dims D/4 * t + 4c .. + 3 for this lane's
  // k slots (2t, 2t + 1, 2t + 8, 2t + 9), of head g in row g and head g + 8
  // in row g + 8 (registers 0, 2 and 1, 3); rows of no head are zero
  uint32_t qa[Gm::KD][4];
#pragma unroll
  for (int c = 0; c < Gm::KD; ++c)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      qa[c][hf] = qa[c][2 + hf] = 0u;
      if ((hf == 0 || TWO) && g + 8 * hf < G) {
        const __nv_bfloat16* qr = q + static_cast<size_t>(g + 8 * hf) * D + D / 4 * t + 4 * c;
        qa[c][hf] = *reinterpret_cast<const uint32_t*>(qr);
        qa[c][2 + hf] = *reinterpret_cast<const uint32_t*>(qr + 2);
      }
    }

  float o[Gm::NB][4];                         // [.][0..1] row g, [.][2..3] row g + 8
#pragma unroll
  for (int j = 0; j < Gm::NB; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF};   // rows g, g + 8: running max
  float l[2] = {0.f, 0.f};                       // and denominator

  for (int it = it0, n = 0; it < it1; ++it, ++n) {
    const int slot = n & 1;
    mma::cp_async_wait<1>();                  // tile it has landed
    __syncthreads();
    const int p = it / tpp, off = it % tpp * TS;
    const int nt = min(TS, pg.size(p) - off);
    const int pos0 = (pg.base + p) * pg.ps + off;
    if (16 * warp < nt) {
      const uint8_t* ks = smem + slot * Gm::STAGE;
      const uint8_t* vs = ks + TS * KP;
      const float* sz = reinterpret_cast<const float*>(vs + TS * VP);
      // S = Q.K^T over the warp's 16 keys.  Key order: S block jb, column n
      // is key 8jb + 4(n & 1) + n / 2, so this lane's accumulators hold keys
      // t, 4 + t, 8 + t, 12 + t -- P's k slots 2t, 2t + 1, 2t + 8, 2t + 9.
      float s[2][4];
      uint32_t kw[2][Gm::KS / 4];
      float scale[2], zero[2];
#pragma unroll
      for (int jb = 0; jb < 2; ++jb) {
        const int r = 16 * warp + 8 * jb + 4 * (g & 1) + (g >> 1);
        load_key_words<Gm::KS>(kw[jb], ks + r * KP + Gm::KS * t);
        scale[jb] = sz[2 * r];
        zero[jb] = sz[2 * r + 1];
        s[jb][0] = s[jb][1] = s[jb][2] = s[jb][3] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < Gm::KD; ++c) {
#pragma unroll
        for (int jb = 0; jb < 2; ++jb) {
          float k[4];
          key_codes<KBITS>(kw[jb], c, k);
#pragma unroll
          for (int i = 0; i < 4; ++i) k[i] = dequant_key(k[i], scale[jb], zero[jb]);
          mma::mma_bf16(s[jb], qa[c], mma::pack_bf16(k[0], k[1]), mma::pack_bf16(k[2], k[3]));
        }
      }
      // online softmax of rows g and g + 8 over the warp's keys, float32
      bool live[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = 16 * warp + 4 * i + t;
        const int pos = pos0 + key;
        live[i] = key < nt && pos >= pg.lo && pos < pg.hi;
      }
      float pr[2][4] = {};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (hf == 1 && !TWO) break;
        const float x[4] = {s[0][2 * hf], s[0][2 * hf + 1], s[1][2 * hf], s[1][2 * hf + 1]};
        const float corr = online_softmax(x, live, m[hf], l[hf], pr[hf]);
#pragma unroll
        for (int j = 0; j < Gm::NB; ++j) {
          o[j][2 * hf] *= corr;
          o[j][2 * hf + 1] *= corr;
        }
      }
      // O += P.V.  Column g of n8 block 4u + e is dim 32u + 4g + e: for keys
      // t, 4 + t, 8 + t, 12 + t, value word g + 8u (fp8: byte e is dim
      // 32u + 4g + e) or the two words at dim 32u + 4g (bf16: half e).
      const uint32_t pa[4] = {mma::pack_bf16(pr[0][0], pr[0][1]),
                              mma::pack_bf16(pr[1][0], pr[1][1]),
                              mma::pack_bf16(pr[0][2], pr[0][3]),
                              mma::pack_bf16(pr[1][2], pr[1][3])};
#pragma unroll
      for (int u = 0; u < Gm::DP / 32; ++u) {
        uint2 xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint8_t* row = vs + (16 * warp + 4 * i + t) * VP;
          if constexpr (VBF16)
            xv[i] = *reinterpret_cast<const uint2*>(row + 2 * (32 * u + 4 * g));
          else
            xv[i] = make_uint2(*reinterpret_cast<const uint32_t*>(row + 4 * (g + 8 * u)), 0u);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mma::mma_bf16(o[4 * u + e], pa, value_pair<VBF16>(xv[0], xv[1], e),
                        value_pair<VBF16>(xv[2], xv[3], e));
      }
    }
    __syncthreads();                          // every warp is done with this slot
    if (it + 2 < it1) stage(it + 2, slot);
    mma::cp_async_commit();
  }

  // merge the warps (the stage buffers become the merge area; only empty
  // copy groups can still be pending)
  mma::cp_async_wait<0>();
  float* mw = reinterpret_cast<float*>(smem);  // [WARPS][RT]
  float* lw = mw + WARPS * RT;                 // [WARPS][RT]
  float* aw = lw + WARPS * RT;                 // [WARPS][RT][D]
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = g + 8 * hf;
    if ((hf == 0 || TWO) && r < G) {
      if (t == 0) {
        mw[warp * RT + r] = m[hf];
        lw[warp * RT + r] = l[hf];
      }
      // accumulator o[4u + e][2hf + c] is row r, dim 32u + 8t + 4c + e
#pragma unroll
      for (int u = 0; u < Gm::DP / 32; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int d = 32 * u + 8 * t + 4 * c + e;
            if (d < D) aw[(warp * RT + r) * D + d] = o[4 * u + e][2 * hf + c];
          }
    }
  }
  __syncthreads();
  float* fw = aw + WARPS * RT * D;             // [WARPS][RT] exp(m_w - M)
  float* ml = fw + WARPS * RT;                 // [RT] M, then [RT] l, of the split
  if (tid < G) {
    float M = REPRO_NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, mw[w * RT + tid]);
    float Lsum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = exp2f((mw[w * RT + tid] - M) * LOG2E);
      fw[w * RT + tid] = f;
      Lsum += f * lw[w * RT + tid];
    }
    ml[tid] = M;
    ml[RT + tid] = Lsum;
  }
  __syncthreads();
  const int stride = G * (D + 2);              // floats of one split's partial
  float* mine = part + static_cast<size_t>(split) * stride;
  for (int i = tid; i < G * D; i += THREADS) {
    const int gg = i / D, d = i % D;
    float A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) A += fw[w * RT + gg] * aw[(w * RT + gg) * D + d];
    if (n_live == 1)
      out[i] = A / fmaxf(ml[RT + gg], 1e-30f);
    else
      mine[2 * G + i] = A;
  }
  if (n_live == 1) return;
  if (tid < G) {
    mine[tid] = ml[tid];
    mine[G + tid] = ml[RT + tid];
  }

  // the last live split of this (row, KV head, head tile) to finish
  // combines them all
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counter, 1) == n_live - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  float* fs = reinterpret_cast<float*>(smem);  // [n_live][RT] m_s, then exp(m_s - M)
  float* ls = fs + MAX_SPLITS * RT;            // [n_live][RT] l_s
  float* lt = ls + MAX_SPLITS * RT;            // [RT] the total l
  for (int j = tid; j < n_live * G; j += THREADS) {
    const int s = j / G, gg = j % G;
    const float* ps = part + (s_lo + s) * stride;
    fs[s * RT + gg] = __ldcg(ps + gg);
    ls[s * RT + gg] = __ldcg(ps + G + gg);
  }
  __syncthreads();
  if (tid < G) {
    float M = REPRO_NEG_INF;
    for (int s = 0; s < n_live; ++s) M = fmaxf(M, fs[s * RT + tid]);
    float Lsum = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float f = exp2f((fs[s * RT + tid] - M) * LOG2E);
      fs[s * RT + tid] = f;
      Lsum += f * ls[s * RT + tid];
    }
    lt[tid] = Lsum;
  }
  __syncthreads();
  constexpr int PER_THREAD = (ROWS * D + THREADS - 1) / THREADS;  // of G * D, at most
  float a[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) a[k] = 0.f;
  for (int s = 0; s < n_live; ++s) {           // each split's loads all in flight
    const float* ps = part + (s_lo + s) * stride + 2 * G;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int i = tid + k * THREADS;
      if (i < G * D) a[k] += fs[s * RT + i / D] * __ldcg(ps + i);
    }
  }
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = tid + k * THREADS;
    if (i < G * D) out[i] = a[k] / fmaxf(lt[i / D], 1e-30f);
  }
  if (tid == 0) *counter = 0;                  // clean for the next launch or replay
}

// Head tiles of a group of G query heads: ceil(G / RT).
__host__ __device__ inline int head_tiles(int G) { return (G + RT - 1) / RT; }

// This block's share of a launch over the grid below: row b, KV head h
// (blockIdx.y = b * Hkv + h), head tile blockIdx.z (heads RT * z .. of the
// group), split blockIdx.x.  q and out: [B, Hkv * G, D].  Scratch layout:
// one combine counter a (row, KV head, head tile) (int32, padded to a
// multiple of 4), then each one's ``splits`` partials of min(G, RT) *
// (D + 2) floats.
template <int D, int ROWS, int KBITS, bool VBF16, class Pages>
__device__ __forceinline__ void attend_tile(const Pages& pg, const __nv_bfloat16* __restrict__ q,
                                            const uint8_t* __restrict__ kq,
                                            const float* __restrict__ kscale,
                                            const float* __restrict__ kzero,
                                            const uint8_t* __restrict__ v,
                                            float* __restrict__ out, int* __restrict__ scratch,
                                            int b, int h, int Hkv, int G, int splits) {
  const int g0 = RT * blockIdx.z;
  const int tile = blockIdx.y * gridDim.z + blockIdx.z;
  const size_t at = (static_cast<size_t>(b * Hkv + h) * G + g0) * D;
  float* part = reinterpret_cast<float*>(scratch + ((gridDim.y * gridDim.z + 3) & ~3))
                + static_cast<size_t>(tile) * splits * min(G, RT) * (D + 2);
  attend<D, ROWS, KBITS, VBF16>(pg, q + at, kq, kscale, kzero, v, out + at, part,
                                scratch + tile, h, Hkv, min(RT, G - g0), blockIdx.x, splits);
}

// Grid of a launch: splits on x, one (row, KV head) pair per y, head tiles
// on z.
inline dim3 grid(int B, int Hkv, int G, int splits) {
  return dim3(splits, B * Hkv, head_tiles(G));
}

// Opt a kernel in to the dynamic shared memory it needs (above 48 KB).
template <class Kernel>
inline void allow_smem(Kernel kernel, int bytes) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// A launch's (key bits, value type) variant: int8 keys with fp8 values at
// any head dim the kernels take, the other three at D = 64 and 128 only.
// Calls ``run.template operator()<D, KBITS, VBF16>()``; false where the
// variant has no instantiation.
template <class Run>
inline bool dispatch_variant(int D, int key_bits, int v_bf16, Run&& run) {
  if (key_bits == 8 && !v_bf16) {
    switch (D) {
      case 16: run.template operator()<16, 8, false>(); return true;
      case 32: run.template operator()<32, 8, false>(); return true;
      case 48: run.template operator()<48, 8, false>(); return true;
      case 64: run.template operator()<64, 8, false>(); return true;
      case 80: run.template operator()<80, 8, false>(); return true;
      case 96: run.template operator()<96, 8, false>(); return true;
      case 112: run.template operator()<112, 8, false>(); return true;
      case 128: run.template operator()<128, 8, false>(); return true;
      default: return false;
    }
  }
  if ((key_bits != 8 && key_bits != 4) || (D != 64 && D != 128)) return false;
#define REPRO_DECODE_VARIANT(DIM, BITS, BF16)                       \
  if (D == DIM && key_bits == BITS && (v_bf16 != 0) == BF16) {     \
    run.template operator()<DIM, BITS, BF16>();                     \
    return true;                                                    \
  }
  REPRO_DECODE_VARIANT(64, 8, true) REPRO_DECODE_VARIANT(128, 8, true)
  REPRO_DECODE_VARIANT(64, 4, false) REPRO_DECODE_VARIANT(128, 4, false)
  REPRO_DECODE_VARIANT(64, 4, true) REPRO_DECODE_VARIANT(128, 4, true)
#undef REPRO_DECODE_VARIANT
  return false;
}

}  // namespace decode
