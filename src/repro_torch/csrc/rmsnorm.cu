// Fused RMSNorm for Hopper.
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py::rmsnorm:
//   y = x * rsqrt(mean(x^2) + eps) * w
// with float32 math, x and y in bf16 or float32, w float32.
//
// What bounds it on the H100: bytes in principle (one read and one write
// per element, three float operations each: 0.00002 ms for 4 rows of 3584
// bf16), but at the serving paths' 1-320 rows that is far below a launch's
// latency.  What a launch costs is the latency of a row's loads; what a
// call costs is mostly the host's time in the wrapper.
//
// Design: one block per row, of the fewest warps (1-8) that leave each
// thread at most 4 chunks of 16 bytes (4 warps for a 3584-wide bf16 row).
// Each thread issues all its 16-byte loads of the row and of w at once and
// keeps them in registers, so the row is read once and the only wait on
// memory is the first; then the float32 sum of squares, reduced by warp
// shuffles and, across the block's warps, one barrier, and the scaling
// from registers.  Rows not a whole number of 16-byte chunks, too wide for
// 8 chunks a thread, or at unaligned addresses take 8 warps with scalar
// loads, reading the row twice (CH = 0).  The math and rounding are the
// earlier kernel's: a float32 sum of squares, rsqrtf(ss / D + eps),
// (x * r) * w rounded once to the output type.
#include "common.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// 16 bytes <-> E floats
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int E = 4;
  __device__ static void unpack(uint4 v, float (&f)[4]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void unpack(uint4 v, float (&f)[8]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
  __device__ static uint32_t pack2(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  __device__ static uint4 pack(const float (&f)[8]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
};

// A block of W warps per row.  CH > 0: each thread holds CH 16-byte chunks
// of the row (chunk c = thread + 32 * W * i) and the matching pieces of w in
// registers, all loaded at once.  CH = 0: threads stride over the row with
// scalar loads and read it twice.
template <typename T, int W, int CH>
__global__ void __launch_bounds__(32 * W)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ y, int D, float eps) {
  const int tid = threadIdx.x;
  const T* xr = x + (size_t)blockIdx.x * D;
  T* yr = y + (size_t)blockIdx.x * D;
  __shared__ float part[W];
  // the sum of squares over the block: shuffles, then W partials in order
  auto block_sum = [&](float ss) {
    ss = warp_sum(ss);
    if constexpr (W == 1) {
      return ss;
    } else {
      if (tid % 32 == 0) part[tid / 32] = ss;
      __syncthreads();
      float t = 0.f;
#pragma unroll
      for (int i = 0; i < W; ++i) t += part[i];
      return t;
    }
  };
  if constexpr (CH == 0) {
    float ss = 0.f;
    for (int d = tid; d < D; d += 32 * W) {
      const float v = to_f32(xr[d]);
      ss += v * v;
    }
    const float r = rsqrtf(block_sum(ss) / static_cast<float>(D) + eps);
    for (int d = tid; d < D; d += 32 * W) store(yr + d, to_f32(xr[d]) * r * w[d]);
  } else {
    using V = Vec<T>;
    constexpr int Q = V::E / 4;                  // float4s of w a chunk
    const int n = D / V::E;                      // chunks a row
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    const float4* wv = reinterpret_cast<const float4*>(w);
    uint4 v[CH];
    float4 wr[CH][Q];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = tid + 32 * W * i;
      v[i] = c < n ? xv[c] : make_uint4(0, 0, 0, 0);   // zeros add nothing
#pragma unroll
      for (int q = 0; q < Q; ++q) wr[i][q] = c < n ? wv[c * Q + q] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      float f[V::E];
      V::unpack(v[i], f);
#pragma unroll
      for (int e = 0; e < V::E; ++e) ss += f[e] * f[e];
    }
    const float r = rsqrtf(block_sum(ss) / static_cast<float>(D) + eps);
    uint4* yv = reinterpret_cast<uint4*>(yr);
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = tid + 32 * W * i;
      if (c >= n) break;
      float f[V::E], o[V::E];
      V::unpack(v[i], f);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        o[4 * q] = f[4 * q] * r * wr[i][q].x;
        o[4 * q + 1] = f[4 * q + 1] * r * wr[i][q].y;
        o[4 * q + 2] = f[4 * q + 2] * r * wr[i][q].z;
        o[4 * q + 3] = f[4 * q + 3] * r * wr[i][q].w;
      }
      yv[c] = V::pack(o);
    }
  }
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int W>
void launch_w(const T* x, const float* w, T* y, int rows, int D, float eps, int ch,
              cudaStream_t s) {
  if (ch == 0)
    rmsnorm_kernel<T, W, 0><<<rows, 32 * W, 0, s>>>(x, w, y, D, eps);
  else if (ch == 1)
    rmsnorm_kernel<T, W, 1><<<rows, 32 * W, 0, s>>>(x, w, y, D, eps);
  else if (ch == 2)
    rmsnorm_kernel<T, W, 2><<<rows, 32 * W, 0, s>>>(x, w, y, D, eps);
  else if (ch <= 4)
    rmsnorm_kernel<T, W, 4><<<rows, 32 * W, 0, s>>>(x, w, y, D, eps);
  else
    rmsnorm_kernel<T, W, 8><<<rows, 32 * W, 0, s>>>(x, w, y, D, eps);
}

// One block per row, of the fewest warps (1, 2, 4, 8) that leave each
// thread at most 4 chunks of 16 bytes (at most 8 with 8 warps); rows not
// whole chunks, wider than that, or unaligned: 8 warps on the scalar path.
template <typename T>
int launch(const void* x, const void* w, void* y, int rows, int D, float eps, cudaStream_t s) {
  constexpr int E = Vec<T>::E;
  const int n = D / E;                           // 16-byte chunks a row
  int W = 1;
  while (W < 8 && n > 32 * W * 4) W *= 2;
  int ch = (n + 32 * W - 1) / (32 * W);
  if (D % E || ch > 8 || !aligned16(x) || !aligned16(w) || !aligned16(y)) {
    W = 8;
    ch = 0;
  }
  const auto* xp = static_cast<const T*>(x);
  const auto* wp = static_cast<const float*>(w);
  auto* yp = static_cast<T*>(y);
  if (W == 1)
    launch_w<T, 1>(xp, wp, yp, rows, D, eps, ch, s);
  else if (W == 2)
    launch_w<T, 2>(xp, wp, yp, rows, D, eps, ch, s);
  else if (W == 4)
    launch_w<T, 4>(xp, wp, yp, rows, D, eps, ch, s);
  else
    launch_w<T, 8>(xp, wp, yp, rows, D, eps, ch, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: [rows, D] bf16 (is_bf16 = 1) or float32; w float32 [D].
static int rmsnorm(const void* x, const void* w, void* y, int rows, int D,
                   float eps, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, w, y, rows, D, eps, s)
                 : launch<float>(x, w, y, rows, D, eps, s);
}

// The entry point: the arguments above, packed (common.cuh, PackedArgs).
extern "C" int rmsnorm_launch(const unsigned char* packed) {
  const PackedArgs a{packed};
  return rmsnorm(a.ptr(0), a.ptr(1), a.ptr(2), a.integer(3), a.integer(4), a.real(5),
                 a.integer(6), a.ptr(7));
}
