// Blockwise (flash) prefill attention over unquantized K/V, for Hopper.
//
// Replaces the TPU kernel repro/kernels/flash_prefill.py::
// flash_prefill_attention: pre-scaled bf16 queries [B, T, H, D] attend over
// bf16 keys/values [B, S, Hkv, D] (GQA, G = H / Hkv query heads per KV head)
// with online softmax in float32.  Query i sits at position i; key j is
// live iff j < S, and j <= i when causal, and i - j < window when window > 0.
//
// What bounds it on the H100: bytes at the serving shapes (a 320-token
// prompt reads 7.5 MB for 0.74 GFLOP of bf16 products), operations only at
// long prompts, where each key tile is reused by every query row of a block.
//
// Design: prefill::attend (csrc/prefill_attention.cuh) on the bf16 tensor
// cores, with this policy staging 64-key tiles of the bf16 arrays as they
// are -- 16-byte cp.async straight into the double-buffered shared tiles,
// keys past S zero-filled -- so a tile costs one block barrier.  Only tiles
// that can hold a live key for one of the block's queries are walked: tiles
// past its last query are skipped when causal, tiles wholly outside the
// window of its first query when windowed.  Rounding differs from the
// Pallas kernel in one place: P is rounded to bf16 for P.V, as the plain
// version rounds it (the Pallas kernel keeps it in float32).
#include "prefill_attention.cuh"

namespace {

using prefill::TS;

template <int D>
struct DenseTiles {
  static constexpr bool CONVERTS = false;
  static constexpr int P = prefill::Geo<D>::PITCH;
  static constexpr int TILE = prefill::Geo<D>::TILE;
  static constexpr int SMEM = 2 * 2 * TILE * 2;      // two slots of a K and a V tile
  const __nv_bfloat16* __restrict__ k;
  const __nv_bfloat16* __restrict__ v;
  size_t row0;        // flat token index of the row's position 0
  int S, causal, window, Hkv, h;
  __nv_bfloat16* buf;  // [slot][K tile, V tile]
  __device__ int qpos(int i) const { return i; }
  __device__ int begin(int qlo) const {
    return window ? max(0, qlo - window + 1) / TS : 0;
  }
  __device__ int end(int qhi) const { return ((causal ? min(S, qhi + 1) : S) + TS - 1) / TS; }
  __device__ int start(int it) const { return it * TS; }
  __device__ int size(int it) const { return min(TS, S - it * TS); }
  __device__ bool live(int qp, int kp) const {
    return (!causal || kp <= qp) && (!window || qp - kp < window);
  }
  __device__ void stage(int it, int slot, int tid, int n) const {
    __nv_bfloat16* kt = buf + slot * 2 * TILE;
    __nv_bfloat16* vt = kt + TILE;
    const int nt = size(it);
    const size_t first = row0 + static_cast<size_t>(it) * TS;
    for (int c = tid; c < TS * (D / 8); c += n) {
      const int r = c / (D / 8), ch = c % (D / 8);
      const bool ok = r < nt;
      const size_t off = ((first + r) * Hkv + h) * D + ch * 8;
      mma::cp_async16(kt + r * P + ch * 8, ok ? k + off : k, ok);
      mma::cp_async16(vt + r * P + ch * 8, ok ? v + off : v, ok);
    }
  }
  __device__ void convert(int, int, int, int) const {}
  __device__ const __nv_bfloat16* ktile(int slot) const { return buf + slot * 2 * TILE; }
  __device__ const __nv_bfloat16* vtile(int slot) const { return buf + slot * 2 * TILE + TILE; }
};

template <int D>
constexpr int smem_bytes() { return prefill::q_bytes<D>() + DenseTiles<D>::SMEM; }

template <int D>
__global__ void __launch_bounds__(prefill::THREADS)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, float* __restrict__ out,
                     int T, int S, int Hkv, int G, int causal, int window) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  auto* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  const DenseTiles<D> tiles{k, v, static_cast<size_t>(b) * S, S, causal, window, Hkv, h,
                            reinterpret_cast<__nv_bfloat16*>(smem + prefill::q_bytes<D>())};
  prefill::attend<D>(tiles, q, out, b, h, T, Hkv, G, qs);
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* out, int B, int T, int S,
            int Hkv, int G, int causal, int window, cudaStream_t stream) {
  static bool opted_in = false;
  if (!opted_in) {
    prefill::allow_smem(flash_prefill_kernel<D>, smem_bytes<D>());
    opted_in = true;
  }
  flash_prefill_kernel<D><<<prefill::grid(B, Hkv, T, G), prefill::THREADS, smem_bytes<D>(),
                            stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out), T, S, Hkv, G,
      causal, window);
}

}  // namespace

// q bf16 [B, T, H, D] pre-scaled; k/v bf16 [B, S, Hkv, D]; out f32
// [B, T, H, D].  D is 64 or 128; ceil(T * G / 64) at most 65535.
static int flash_prefill_attention(
    const void* q, const void* k, const void* v, void* out, int B, int T, int S,
    int Hkv, int G, int D, int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    launch<128>(q, k, v, out, B, T, S, Hkv, G, causal, window, s);
  else if (D == 64)
    launch<64>(q, k, v, out, B, T, S, Hkv, G, causal, window, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The entry point: the arguments above, packed (common.cuh, PackedArgs).
extern "C" int flash_prefill_attention_launch(const unsigned char* packed) {
  const PackedArgs a{packed};
  return flash_prefill_attention(a.ptr(0), a.ptr(1), a.ptr(2), a.ptr(3), a.integer(4),
                                 a.integer(5), a.integer(6), a.integer(7), a.integer(8),
                                 a.integer(9), a.integer(10), a.integer(11), a.ptr(12));
}
