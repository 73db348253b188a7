// Grouped (per-expert) W4A8 / W8A8 matmul for Hopper.
//
// Replaces the TPU kernel repro/kernels/grouped_matmul.py::grouped_matmul:
//   y[e, M, N] f32 = sx[e] * w_scale[e] * (xq[e] @ w[e] - w_zero[e] * rowsum(xq[e]))
// for every expert e, in one launch: one int8 activation slab [M, K] and one
// int4 (two nibbles per byte along N) or int8 weight slab [K, N] per expert.
//
// What bounds it on the H100: the weight bytes.  The MoE decode path runs it
// on the K experts each token chose, at M = 1; the prefill path runs every
// expert at full capacity, M = the chunk's rows, of which only the routed
// tokens (about 12 of 128 at moonshot's 64 experts, top-6) hold data.  With
// those rows skipped both are weight streams: at most 16 live rows meet a
// weight byte, far under the int8 tensor cores' ridge.
//
// Design: the tensor-core tile of csrc/w4a8_mma_tile.cuh, shared with the
// dense kernel (mma.sync m16n8k32 with exact int32 sums, nibbles unpacked
// in registers, a 4-stage cp.async ring), one 16 x 128 output tile per
// block, the expert on grid z and the row tiles on grid x, so the blocks
// that share an expert's weight tile run side by side and meet its bytes in
// L2.  Two optional tables:
//   rows int32 [E, G]: the live rows of each of the G capacity segments of
//     C = M / G rows of expert e (row m is live iff m % C < rows[e, m / C]).
//     A tile with no live row reads nothing and writes +0.0, which is what
//     the Pallas kernel computes for those all-zero rows.
//   ids int32 [E']: block z multiplies activation slab z by weight slab
//     ids[z] of the whole table (the selected-expert decode path), instead
//     of a copy of the chosen slabs.  The ids are not range-checked here.
// The rounding is the plain version's (kernels/grouped_matmul.py): exact
// int32 products, the correction fused, then the two scale products in its
// order.
#include "w4a8_mma_tile.cuh"

namespace {

template <int BITS>
__global__ void __launch_bounds__(w4a8mma::Geo<BITS, 1, 1>::THREADS)
grouped_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
               const int8_t* __restrict__ w, const float* __restrict__ wscale,
               const float* __restrict__ wzero, float* __restrict__ y,
               const int* __restrict__ ids, const int* __restrict__ rows,
               int M, int N, int K, int G) {
  const size_t z = blockIdx.z;
  const size_t e = ids ? static_cast<size_t>(ids[z]) : z;
  const size_t wslab = static_cast<size_t>(K) * (BITS == 4 ? N / 2 : N);
  w4a8mma::tile<BITS, 1, 1>(xq + z * M * K, sx + z * M, w + e * wslab, wscale + e * N,
                            wzero + e * N, y + z * M * N, M, N, K,
                            blockIdx.x * w4a8mma::Geo<BITS, 1, 1>::BM, blockIdx.y * w4a8mma::BN,
                            rows ? rows + z * G : nullptr, M / G, 0, K / w4a8mma::BK);
}

}  // namespace

// xq int8 [E', M, K]; sx f32 [E', M]; w int8 [E, K, N/2] (bits 4) or
// [E, K, N] (bits 8); scale/zero f32 [E, N]; y f32 [E', M, N]; ids int32
// [E'] or null (then E' = E and slab z is expert z); rows int32 [E', G] or
// null (every row live; G is then ignored).  Requires K % 64 == 0,
// N % 128 == 0, M % G == 0, N / 128 and E' at most 65535 (grid limits).
static int grouped_matmul(const void* xq, const void* sx, const void* w,
                          const void* scale, const void* zero, void* y,
                          const void* ids, const void* rows, int E, int M,
                          int N, int K, int G, int bits, void* stream) {
  using GE4 = w4a8mma::Geo<4, 1, 1>;
  using GE8 = w4a8mma::Geo<8, 1, 1>;
  static_assert(GE4::BM == GE8::BM && GE8::SMEM <= 48 * 1024, "one grid, default smem limit");
  const dim3 grid((M + GE4::BM - 1) / GE4::BM, N / w4a8mma::BN, E);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(xq);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* ip = static_cast<const int*>(ids);
  const auto* rp = static_cast<const int*>(rows);
  if (bits == 4)
    grouped_kernel<4><<<grid, GE4::THREADS, GE4::SMEM, s>>>(
        xp, static_cast<const float*>(sx), wp, static_cast<const float*>(scale),
        static_cast<const float*>(zero), static_cast<float*>(y), ip, rp, M, N, K, G);
  else
    grouped_kernel<8><<<grid, GE8::THREADS, GE8::SMEM, s>>>(
        xp, static_cast<const float*>(sx), wp, static_cast<const float*>(scale),
        static_cast<const float*>(zero), static_cast<float*>(y), ip, rp, M, N, K, G);
  return static_cast<int>(cudaGetLastError());
}

// The entry point: the arguments above, packed (common.cuh, PackedArgs).
extern "C" int grouped_matmul_launch(const unsigned char* packed) {
  const PackedArgs a{packed};
  return grouped_matmul(a.ptr(0), a.ptr(1), a.ptr(2), a.ptr(3), a.ptr(4), a.ptr(5), a.ptr(6),
                        a.ptr(7), a.integer(8), a.integer(9), a.integer(10), a.integer(11),
                        a.integer(12), a.integer(13), a.ptr(14));
}
