// Paged prefill (prompt-chunk) attention over the quantized KV pool, for
// Hopper.
//
// Replaces the TPU kernel
// repro/kernels/flash_prefill.py::paged_flash_prefill_attention: a chunk of C
// pre-scaled queries at absolute positions pos0 + [0, C) attends causally
// over the row's pages through the page table, with int8 or int4 key
// dequantization fused in, fp8 e4m3 or bf16 values read as they are, and
// online softmax in float32.
//
// What bounds it on the H100: bytes at the serving chunk sizes (a 128-token
// chunk at position 256 reads 3.2 MB of pool and queries for 0.6 GFLOP),
// operations only at long contexts, where each key tile is reused by every
// query row of a block.
//
// Design: prefill::attend (csrc/prefill_attention.cuh) on the bf16 tensor
// cores, with this policy staging tiles of up to 64 keys (a tile never
// crosses a page): the page id is read once per tile, the tile's key codes
// (int8, or int4 nibble pairs: half the bytes), values (fp8 e4m3, or bf16:
// twice the bytes) and per-(token, head) key scale and zero come in through
// cp.async into a double-buffered raw area, and once landed they become the
// bf16 tile -- keys dequantized as (kq - zero) * scale in float32 through
// the decode kernels' dequant_key and rounded to bf16, values converted
// from e4m3, which bf16 holds exactly, or copied as they are.  Each (key
// bits, value type) variant is one instantiation of the policy.  Pages (and tiles) that start past
// the block's last query are skipped.  Rounding against the Pallas kernel:
// keys are rounded to bf16 after dequantization and P to bf16 for P.V, as
// the plain version does (the Pallas kernel keeps both in float32).
#include "prefill_attention.cuh"

namespace {

using prefill::TS;

template <int D, int KBITS, bool VBF16>
struct PagedTiles {
  static constexpr bool CONVERTS = true;
  static constexpr int P = prefill::Geo<D>::PITCH;
  static constexpr int TILE = prefill::Geo<D>::TILE;
  static constexpr int KB = D * KBITS / 8;            // key bytes a row
  static constexpr int VB = VBF16 ? 2 * D : D;        // value bytes a row
  static constexpr int RAW = TS * (KB + VB);          // one slot: keys, then values
  // one bf16 K and V tile, two raw slots, two slots of (scale, zero) per key
  static constexpr int SMEM = 2 * TILE * 2 + 2 * RAW + 2 * TS * 2 * 4;
  const uint8_t* __restrict__ kq;
  const float* __restrict__ kscale;
  const float* __restrict__ kzero;
  const uint8_t* __restrict__ v;
  const int* __restrict__ row_table;   // the row's page ids [n_pages]
  int p0, ps, n_pages, Hkv, h;
  __nv_bfloat16* tile;                 // [K tile, V tile]
  uint8_t* raw;                        // [slot][keys TS x KB, values TS x VB]
  float* sz;                           // [slot][key][scale, zero]
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
  __device__ bool live(int qp, int kp) const { return kp <= qp; }
  __device__ void stage(int it, int slot, int tid, int n) const {
    const int tpp = tiles_per_page();
    const size_t first = static_cast<size_t>(row_table[it / tpp]) * ps + it % tpp * TS;
    const int nt = size(it);
    uint8_t* rk = raw + slot * RAW;
    uint8_t* rv = rk + TS * KB;
    for (int c = tid; c < TS * (KB / 16); c += n) {
      const int r = c / (KB / 16), ch = c % (KB / 16);
      const bool ok = r < nt;
      const size_t off = ((first + r) * Hkv + h) * KB + ch * 16;
      mma::cp_async16(rk + r * KB + ch * 16, ok ? kq + off : kq, ok);
    }
    for (int c = tid; c < TS * (VB / 16); c += n) {
      const int r = c / (VB / 16), ch = c % (VB / 16);
      const bool ok = r < nt;
      const size_t off = ((first + r) * Hkv + h) * VB + ch * 16;
      mma::cp_async16(rv + r * VB + ch * 16, ok ? v + off : v, ok);
    }
    for (int r = tid; r < TS; r += n) {
      const bool ok = r < nt;
      const size_t tok = (first + r) * Hkv + h;
      float* dst = sz + (slot * TS + r) * 2;
      mma::cp_async4(dst, ok ? kscale + tok : kscale, ok);
      mma::cp_async4(dst + 1, ok ? kzero + tok : kzero, ok);
    }
  }
  // dims 8ch .. 8ch + 7 of key / value row r -> bf16 (zero past the tile)
  __device__ void convert(int it, int slot, int tid, int n) const {
    const int nt = size(it);
    const uint8_t* rk = raw + slot * RAW;
    const uint8_t* rv = rk + TS * KB;
    for (int c = tid; c < TS * (D / 8); c += n) {
      const int r = c / (D / 8), ch = c % (D / 8);
      uint4 kout = make_uint4(0, 0, 0, 0), vout = make_uint4(0, 0, 0, 0);
      if (r < nt) {
        const float scale = sz[(slot * TS + r) * 2];
        const float zero = sz[(slot * TS + r) * 2 + 1];
        uint32_t* ko = reinterpret_cast<uint32_t*>(&kout);
        if constexpr (KBITS == 8) {
          const int8_t* kb = reinterpret_cast<const int8_t*>(rk + r * KB + ch * 8);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            ko[i] = mma::pack_bf16(dequant_key(kb[2 * i], scale, zero),
                                   dequant_key(kb[2 * i + 1], scale, zero));
        } else {
          // byte i holds dims 2i (low nibble) and 2i + 1 (high nibble)
          const uint32_t w = *reinterpret_cast<const uint32_t*>(rk + r * KB + ch * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            ko[i] = mma::pack_bf16(dequant_key(int4_nibble_to_float(w, 8 * i), scale, zero),
                                   dequant_key(int4_nibble_to_float(w, 8 * i + 4), scale,
                                               zero));
        }
        if constexpr (VBF16) {
          vout = *reinterpret_cast<const uint4*>(rv + r * VB + ch * 16);
        } else {
          const uint8_t* vb = rv + r * VB + ch * 8;
          uint32_t* vo = reinterpret_cast<uint32_t*>(&vout);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            vo[i] = mma::pack_bf16(fp8_to_float(vb[2 * i]), fp8_to_float(vb[2 * i + 1]));
        }
      }
      *reinterpret_cast<uint4*>(tile + r * P + ch * 8) = kout;
      *reinterpret_cast<uint4*>(tile + TILE + r * P + ch * 8) = vout;
    }
  }
  __device__ const __nv_bfloat16* ktile(int) const { return tile; }
  __device__ const __nv_bfloat16* vtile(int) const { return tile + TILE; }
};

template <int D, int KBITS, bool VBF16>
constexpr int smem_bytes() { return prefill::q_bytes<D>() + PagedTiles<D, KBITS, VBF16>::SMEM; }

template <int D, int KBITS, bool VBF16>
__global__ void __launch_bounds__(prefill::THREADS)
paged_prefill_kernel(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ kq,
                     const float* __restrict__ kscale, const float* __restrict__ kzero,
                     const uint8_t* __restrict__ v, const int* __restrict__ table,
                     const int* __restrict__ pos0, float* __restrict__ out,
                     int C, int Hkv, int G, int ps, int n_pages) {
  using Tiles = PagedTiles<D, KBITS, VBF16>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  auto* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* rest = smem + prefill::q_bytes<D>();
  auto* tile = reinterpret_cast<__nv_bfloat16*>(rest);
  uint8_t* raw = rest + 2 * Tiles::TILE * 2;
  auto* sz = reinterpret_cast<float*>(raw + 2 * Tiles::RAW);
  const Tiles tiles{kq, kscale, kzero, v, table + static_cast<size_t>(b) * n_pages,
                    pos0[b], ps, n_pages, Hkv, h, tile, raw, sz};
  prefill::attend<D>(tiles, q, out, b, h, C, Hkv, G, qs);
}

template <int D, int KBITS, bool VBF16>
void launch(const void* q, const void* kq, const void* kscale, const void* kzero,
            const void* v, const void* table, const void* pos0, void* out, int B, int C,
            int Hkv, int G, int ps, int n_pages, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D, KBITS, VBF16>();
  static bool opted_in = false;
  if (!opted_in) {
    prefill::allow_smem(paged_prefill_kernel<D, KBITS, VBF16>, smem);
    opted_in = true;
  }
  paged_prefill_kernel<D, KBITS, VBF16><<<prefill::grid(B, Hkv, C, G), prefill::THREADS, smem,
                                          stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(kq),
      static_cast<const float*>(kscale), static_cast<const float*>(kzero),
      static_cast<const uint8_t*>(v), static_cast<const int*>(table),
      static_cast<const int*>(pos0), static_cast<float*>(out), C, Hkv, G, ps, n_pages);
}

}  // namespace

// q bf16 [B, C, H, D] pre-scaled; pool arrays as for the decode kernel (keys
// of key_bits 8 or 4, values fp8 or, v_bf16, bf16); table int32
// [B, n_pages]; pos0 int32 [B]; out f32 [B, C, H, D].  D is 64 or 128.
static int paged_prefill_attention(
    const void* q, const void* kq, const void* kscale, const void* kzero,
    const void* v, const void* table, const void* pos0, void* out, int B, int C,
    int Hkv, int G, int D, int ps, int n_pages, int key_bits, int v_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((D != 64 && D != 128) || (key_bits != 8 && key_bits != 4))
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_PAGED_PREFILL(DIM, BITS, BF16)                                               \
  if (D == DIM && key_bits == BITS && (v_bf16 != 0) == BF16)                               \
    launch<DIM, BITS, BF16>(q, kq, kscale, kzero, v, table, pos0, out, B, C, Hkv, G, ps,   \
                            n_pages, s);
  REPRO_PAGED_PREFILL(64, 8, false) REPRO_PAGED_PREFILL(128, 8, false)
  REPRO_PAGED_PREFILL(64, 8, true) REPRO_PAGED_PREFILL(128, 8, true)
  REPRO_PAGED_PREFILL(64, 4, false) REPRO_PAGED_PREFILL(128, 4, false)
  REPRO_PAGED_PREFILL(64, 4, true) REPRO_PAGED_PREFILL(128, 4, true)
#undef REPRO_PAGED_PREFILL
  return static_cast<int>(cudaGetLastError());
}

// The entry point: the arguments above, packed (common.cuh, PackedArgs).
extern "C" int paged_prefill_attention_launch(const unsigned char* packed) {
  const PackedArgs a{packed};
  return paged_prefill_attention(a.ptr(0), a.ptr(1), a.ptr(2), a.ptr(3), a.ptr(4), a.ptr(5),
                                 a.ptr(6), a.ptr(7), a.integer(8), a.integer(9), a.integer(10),
                                 a.integer(11), a.integer(12), a.integer(13), a.integer(14),
                                 a.integer(15), a.integer(16), a.ptr(17));
}
