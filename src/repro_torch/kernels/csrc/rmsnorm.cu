// Row RMSNorm: y = x * rsqrt(mean(x^2) + eps) * scale, fp32 math.
//
// Replaces repro/kernels/rmsnorm.py::rmsnorm (pl.pallas_call at :35), which
// normalises 256-row blocks in VMEM.
//
// Bound on Hopper: bytes at a prefill (each element read once and written
// once, 4 flops per element, far below the ~20 flop/byte the H100 needs in
// fp32 before compute matters), latency at a decode tick (4 rows: a few
// kilobytes, a few SMs).  The design answers both:
//
// * One read of x, held in registers.  At a served width (the table in
//   rmsnorm_launch) every thread of a row loads its NV 16-byte vectors of x
//   (4 fp32 or 8 bf16 each) and the matching vectors of scale, reduces the
//   sum of squares, and normalises and stores from the registers: no second
//   pass over x, 16-byte loads and stores only, neighbouring threads on
//   neighbouring vectors.
// * A block shape per width: TPR threads a row, NV = D / (16 bytes * TPR)
//   vectors a thread (at most 7, 28 registers of x).  A row narrower than a
//   warp's 32 threads x 2 vectors shares its warp with other rows; blocks
//   hold at least 128 threads, so narrow rows go several to a block.  The
//   row's sum is a butterfly of shuffles and, for rows of more than one
//   warp, one __syncthreads over a shared array of per-warp sums.
//
// An ordinary launch: programmatic dependent launch (griddepcontrol.wait
// before the first read) shortened 4-row calls back to back by ~1.1 us,
// but neither the add + norm + projection chain of a decode step nor the
// norm's device time in a served tick on an H100 (PERF.md, Findings).
//
// Any other width, or a pointer that is not 16-byte aligned, takes the
// general path: one 256-thread block a row, two passes over the row (the
// second from L1/L2), element loads.
#include <stdint.h>

#include "common.cuh"

namespace {

// 16 bytes of a storage type as fp32 values, and back.
template <typename T> struct Pack;

template <> struct Pack<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <> struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
  // element 2i is the low half of word i; a bf16 is the top half of an fp32
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint32_t pair(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // nearest even
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(pair(f[0], f[1]), pair(f[2], f[3]), pair(f[4], f[5]),
                      pair(f[6], f[7]));
  }
};

__host__ __device__ constexpr int rows_per_block(int tpr) {
  return tpr >= 128 ? 1 : 128 / tpr;
}

template <typename T, int TPR, int NV>
__global__ void __launch_bounds__(TPR * rows_per_block(TPR))
rmsnorm_vec(const T* __restrict__ x, const float* __restrict__ scale,
            T* __restrict__ y, int n, float eps) {
  using P = Pack<T>;
  constexpr int V = P::kN, RPB = rows_per_block(TPR), W = TPR / 32;
  constexpr int VR = TPR * NV;             // 16-byte vectors a row
  static_assert(TPR % 32 == 0 || 32 % TPR == 0, "TPR splits warps");
  __shared__ float part[RPB * (W > 1 ? W : 1)];
  const int t = threadIdx.x % TPR, r = threadIdx.x / TPR;
  const long long row = static_cast<long long>(blockIdx.x) * RPB + r;
  const bool live = row < n;
  const uint4* xr = reinterpret_cast<const uint4*>(x) + row * VR;
  const float4* sr = reinterpret_cast<const float4*>(scale);

  uint4 xv[NV];
  float4 sv[NV][V / 4];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = j * TPR + t;
    xv[j] = live ? xr[c] : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int k = 0; k < V / 4; ++k) sv[j][k] = sr[c * (V / 4) + k];
  }

  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float f[V];
    P::unpack(xv[j], f);
#pragma unroll
    for (int k = 0; k < V; ++k) ss = fmaf(f[k], f[k], ss);
  }
#pragma unroll
  for (int o = (TPR < 32 ? TPR : 32) / 2; o > 0; o >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (W > 1) {
    if ((t & 31) == 0) part[r * W + (t >> 5)] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) ss += part[r * W + w];
  }
  const float inv = rsqrtf(ss / static_cast<float>(VR * V) + eps);
  if (!live) return;

  uint4* yr = reinterpret_cast<uint4*>(y) + row * VR;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float f[V];
    P::unpack(xv[j], f);
    const float* s = reinterpret_cast<const float*>(sv[j]);
#pragma unroll
    for (int k = 0; k < V; ++k) f[k] = f[k] * inv * s[k];
    yr[j * TPR + t] = P::pack(f);
  }
}

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_any(const T* __restrict__ x, const float* __restrict__ scale,
            T* __restrict__ y, int d, float eps) {
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  __shared__ float part[kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  ss = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) ss += part[w];
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
  for (int i = threadIdx.x; i < d; i += kThreads)
    yr[i] = from_f32<T>(to_f32(xr[i]) * inv * scale[i]);
}

// TPR32 threads a row in fp32, half as many in bf16 (8 elements a vector,
// not 4), NV vectors a thread either way.
template <typename T, int TPR32, int NV>
int launch_vec(const T* x, const float* scale, T* y, int n, float eps,
               cudaStream_t stream) {
  constexpr int TPR = sizeof(T) == 4 ? TPR32 : TPR32 / 2;
  constexpr int RPB = rows_per_block(TPR);
  rmsnorm_vec<T, TPR, NV><<<(n + RPB - 1) / RPB, TPR * RPB, 0, stream>>>(
      x, scale, y, n, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int rmsnorm_launch(const void* xp, const void* sp, void* yp, int n, int d,
                   float eps, void* stream_p) {
  if (n <= 0) return 0;
  const T* x = static_cast<const T*>(xp);
  const float* s = static_cast<const float*>(sp);
  T* y = static_cast<T*>(yp);
  cudaStream_t st = static_cast<cudaStream_t>(stream_p);
  const bool aligned = ((reinterpret_cast<uintptr_t>(xp) |
                         reinterpret_cast<uintptr_t>(sp) |
                         reinterpret_cast<uintptr_t>(yp)) & 15u) == 0;
  if (aligned) {
    // the served widths: MLA's kv_norm (256) and q_norm (768), xlstm_125m
    // (768), whisper_medium (1024), deepseek_moe_16b (2048), minicpm3_4b
    // (2560), zamba2_7b (3584), glm4_9b and llava (4096), zamba2's gated
    // norm (7168), and 12288
    switch (d) {
      case 256: return launch_vec<T, 32, 2>(x, s, y, n, eps, st);
      case 768: return launch_vec<T, 64, 3>(x, s, y, n, eps, st);
      case 1024: return launch_vec<T, 64, 4>(x, s, y, n, eps, st);
      case 2048: return launch_vec<T, 128, 4>(x, s, y, n, eps, st);
      case 2560: return launch_vec<T, 128, 5>(x, s, y, n, eps, st);
      case 3584: return launch_vec<T, 128, 7>(x, s, y, n, eps, st);
      case 4096: return launch_vec<T, 256, 4>(x, s, y, n, eps, st);
      case 7168: return launch_vec<T, 256, 7>(x, s, y, n, eps, st);
      case 12288: return launch_vec<T, 512, 6>(x, s, y, n, eps, st);
      default: break;
    }
  }
  rmsnorm_any<T><<<n, kThreads, 0, st>>>(x, s, y, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rmsnorm_f32(const void* x, const void* scale, void* y, int n,
                           int d, float eps, void* stream) {
  return rmsnorm_launch<float>(x, scale, y, n, d, eps, stream);
}

extern "C" int rmsnorm_bf16(const void* x, const void* scale, void* y, int n,
                            int d, float eps, void* stream) {
  return rmsnorm_launch<__nv_bfloat16>(x, scale, y, n, d, eps, stream);
}
