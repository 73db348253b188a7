// W4A8 / W8A8 quantized matmul for Hopper.
//
// Replaces the TPU kernel repro/kernels/w4a8_matmul.py::w4a8_matmul:
//   y[M, N] f32 = sx * w_scale * (xq @ w - w_zero * rowsum(xq))
// with int8 activations xq [M, K] (per-row scale sx [M, 1]) and int4 weights
// packed two unsigned nibbles per byte along N (column 2j low, 2j+1 high) or
// int8 weights, each with a per-channel asymmetric scale/zero.
//
// What bounds it on the H100: at decode (M = 1..4, every linear of a
// qwen2-7b step) each weight byte is read once for a handful of rows, so
// the weight stream bounds it -- 0.002 ms for a 3584 x 3584 int4 weight,
// 0.16 ms for the int8 lm_head -- and a launch that puts too few blocks on
// the 132 SMs cannot reach it: one block per 16 x 128 output tile gives the
// q/o projections 28 blocks and k/v 4.  A 128-token prompt chunk does ~512
// int8 operations a weight byte, near the tensor cores' ridge.
//
// Design: the int8 tensor-core tile of csrc/w4a8_mma_tile.cuh, shared with
// the grouped kernel, in two sizes chosen on the host from M alone
// (kernels/w4a8_matmul.py::tile_rows): 16 rows x 128 columns and 4 warps
// for M <= 16, 64 x 128 and 8 warps (each weight fragment unpacked once
// and used for two row tiles a warp) above.  Grid: on x the splits of K,
// whose count the host chooses from shapes alone (matmul_splits) so that
// the grid fills the card; row tiles on y; column tiles on z.  Split s
// takes the K steps [s * nk / S, (s + 1) * nk / S).  Each split writes its
// int32 partial tile and row sums to its own slot of a scratch buffer; the
// last block of an output tile to finish -- an atomicAdd ticket on the
// tile's counter after a __threadfence, as in csrc/decode_attention.cuh --
// sums the slots (int32, exact: the output is the same for every split
// count), applies the epilogue once, and resets the counter to 0 for the
// next launch or CUDA-graph replay.  One launch, no allocation.  That last
// block reads every split's partial tile alone, which is what caps the
// splits (8 for the 16-row tile, 4 for the 64-row tile).
#include "w4a8_mma_tile.cuh"

namespace {

using w4a8mma::BN;

// The last split of the output tile (row tile rt, column tile nt) to finish
// sums every split's partials and writes y.  part_acc [S][Mp][N] and
// part_rs [S][n_tiles][Mp] int32, Mp = the row tiles' rows.
template <int BM, int THREADS>
__device__ __forceinline__ void combine(const float* __restrict__ sx,
                                        const float* __restrict__ wscale,
                                        const float* __restrict__ wzero,
                                        float* __restrict__ y, int* counter,
                                        const int* part_acc, const int* part_rs,
                                        int splits, int Mp, int M, int N, int m0, int nt) {
  __shared__ int is_last;
  __shared__ int rsum[BM];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int n_tiles = N / BN, n0 = nt * BN;
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    int v = 0;
    if (m0 + r < M)
      for (int s = 0; s < splits; ++s)
        v += __ldcg(part_rs + ((size_t)s * n_tiles + nt) * Mp + m0 + r);
    rsum[r] = v;
  }
  __syncthreads();
  const int rows = min(BM, M - m0);
  for (int i = threadIdx.x; i < rows * (BN / 4); i += THREADS) {
    const int r = i / (BN / 4), c = n0 + i % (BN / 4) * 4;
    const int m = m0 + r;
    int4 a = make_int4(0, 0, 0, 0);
    for (int s = 0; s < splits; ++s) {
      const int4 v = __ldcg(reinterpret_cast<const int4*>(part_acc + ((size_t)s * Mp + m) * N + c));
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
    const float4 sc = *reinterpret_cast<const float4*>(wscale + c);
    const float4 zr = *reinterpret_cast<const float4*>(wzero + c);
    const float sxm = sx[m];
    const int rs = rsum[r];
    float4 o;
    o.x = w4a8mma::epilogue(a.x, rs, sc.x, zr.x, sxm);
    o.y = w4a8mma::epilogue(a.y, rs, sc.y, zr.y, sxm);
    o.z = w4a8mma::epilogue(a.z, rs, sc.z, zr.z, sxm);
    o.w = w4a8mma::epilogue(a.w, rs, sc.w, zr.w, sxm);
    *reinterpret_cast<float4*>(y + (size_t)m * N + c) = o;
  }
  if (threadIdx.x == 0) *counter = 0;            // clean for the next launch or replay
}

template <int BITS, int MT, int RH>
__global__ void __launch_bounds__(128 * RH)
w4a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
            const int8_t* __restrict__ w, const float* __restrict__ wscale,
            const float* __restrict__ wzero, float* __restrict__ y,
            int* __restrict__ scratch, int M, int N, int K) {
  using GE = w4a8mma::Geo<BITS, MT, RH>;
  const int splits = gridDim.x, split = blockIdx.x;
  const int nk = K / w4a8mma::BK;
  const int kt0 = static_cast<int>(static_cast<long long>(split) * nk / splits);
  const int kt1 = static_cast<int>(static_cast<long long>(split + 1) * nk / splits);
  const int rt = blockIdx.y, nt = blockIdx.z, m0 = rt * GE::BM;
  if (splits == 1) {
    w4a8mma::tile<BITS, MT, RH>(xq, sx, w, wscale, wzero, y, M, N, K, m0, nt * BN,
                                nullptr, M, kt0, kt1);
    return;
  }
  // scratch: one counter per output tile (padded to 4), then the partials
  const int n_tiles = gridDim.z, Mp = gridDim.y * GE::BM;
  int* counter = scratch + rt * n_tiles + nt;
  int* part_acc = scratch + ((gridDim.y * n_tiles + 3) & ~3);
  int* part_rs = part_acc + (size_t)splits * Mp * N;
  w4a8mma::tile<BITS, MT, RH>(xq, sx, w, wscale, wzero, y, M, N, K, m0, nt * BN,
                              nullptr, M, kt0, kt1, part_acc + (size_t)split * Mp * N,
                              part_rs + ((size_t)split * n_tiles + nt) * Mp);
  combine<GE::BM, GE::THREADS>(sx, wscale, wzero, y, counter, part_acc, part_rs, splits,
                               Mp, M, N, m0, nt);
}

template <int BITS, int MT, int RH>
int launch(const void* xq, const void* sx, const void* w, const void* scale,
           const void* zero, void* y, void* scratch, int M, int N, int K, int splits,
           cudaStream_t s) {
  using GE = w4a8mma::Geo<BITS, MT, RH>;
  auto kernel = w4a8_kernel<BITS, MT, RH>;
  if constexpr (GE::SMEM > 48 * 1024) {        // once per kernel
    static const cudaError_t raised = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GE::SMEM);
    if (raised != cudaSuccess) return static_cast<int>(raised);
  }
  const dim3 grid(splits, (M + GE::BM - 1) / GE::BM, N / BN);
  kernel<<<grid, GE::THREADS, GE::SMEM, s>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const int8_t*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(zero), static_cast<float*>(y), static_cast<int*>(scratch),
      M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xq int8 [M, K]; sx f32 [M]; w int8 [K, N/2] (bits 4) or [K, N] (bits 8);
// scale/zero f32 [N]; y f32 [M, N].  tile_rows 16 or 64 (the host's
// tile_rows(M)); splits >= 1 K ranges, each of at least one 64-deep step;
// with splits > 1, scratch holds row_tiles * N/128 zeroed counters (padded
// to a multiple of 4) then splits * (Mp * N + N/128 * Mp) int32 words, Mp =
// row_tiles * tile_rows.  Requires K % 64 == 0, N % 128 == 0, N/128 and
// row_tiles at most 65535, and 16-byte aligned xq, w, scale and zero.
static int w4a8_matmul(const void* xq, const void* sx, const void* w,
                       const void* scale, const void* zero, void* y,
                       void* scratch, int M, int N, int K, int bits,
                       int tile_rows, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_rows == 16)
    return bits == 4 ? launch<4, 1, 1>(xq, sx, w, scale, zero, y, scratch, M, N, K, splits, s)
                     : launch<8, 1, 1>(xq, sx, w, scale, zero, y, scratch, M, N, K, splits, s);
  return bits == 4 ? launch<4, 2, 2>(xq, sx, w, scale, zero, y, scratch, M, N, K, splits, s)
                   : launch<8, 2, 2>(xq, sx, w, scale, zero, y, scratch, M, N, K, splits, s);
}

// The entry point: the arguments above, packed (common.cuh, PackedArgs).
extern "C" int w4a8_matmul_launch(const unsigned char* packed) {
  const PackedArgs a{packed};
  return w4a8_matmul(a.ptr(0), a.ptr(1), a.ptr(2), a.ptr(3), a.ptr(4), a.ptr(5), a.ptr(6),
                     a.integer(7), a.integer(8), a.integer(9), a.integer(10), a.integer(11),
                     a.integer(12), a.ptr(13));
}
