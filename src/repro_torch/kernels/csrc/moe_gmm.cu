// Grouped (per-expert) matmul: y[e] = x[e] @ w[e], (E,C,D) @ (E,D,F) ->
// (E,C,F), both operands upcast to fp32, an fp32 accumulator, the output in
// x's storage type.
//
// Replaces repro/kernels/moe_gmm.py::gmm (pl.pallas_call at :49), whose
// grid (E, nC, nF, nD) carries a (BC, BF) fp32 accumulator in VMEM across
// an ordered contraction axis and whose wrapper pads C to the block with
// jnp.pad.  Blocks on a GPU run in no order, so here the contraction is a
// loop inside one thread block: one block per (C tile of 64 rows, F tile of
// 64 columns, expert) walks D in steps of 64, staging an x tile and a w
// tile in shared memory as fp32, and keeps its 64 x 64 outputs in
// registers (4 x 4 a thread, fp32 FMAs on CUDA cores).  While it computes
// one step it has the next step's loads in flight in registers.  A ragged C
// (the MoE capacity is any integer) is masked inside the kernel: rows past
// C read as 0 and are not written, and no padded copy is made.  x is read
// through its expert and row strides (the model hands over a view of its
// dispatch buffer without the sink row); its last dimension is contiguous.
//
// Bound on Hopper.  Decode (E = 64, C = 1, D = 2048, F = 1408, fp32): the
// function must read 64 x 2048 x 1408 weights = 738.2 MB, so 0.2204 ms at
// 3.35 TB/s; it does 0.37 GFLOP.  It is a per-expert GEMV and reading the
// weights is all of its cost, so the w tile is read along F, 16 bytes a
// thread, neighbouring threads on neighbouring columns (a warp reads two
// 256-byte rows), and a warp whose rows all lie past C skips the FMAs.
// Prefill at S = 512 (C = 60 at capacity factor 1.25): 2 x 64 x 60 x 2048 x
// 1408 = 22.1 GFLOP, so 0.330 ms at 67 TFLOP/s fp32 against 0.22 ms of
// weight bytes: it is bound by operations.  One 64-row C tile covers C <= 64,
// so every weight is read from device memory once.  Known weaknesses, left
// to later work: experts that received no rows still read their weights
// (in decode at most 24 of 64 experts get a row); gate and up are two
// launches over the same x, with the SiLU product a third pass; the FMAs
// run on CUDA cores (wgmma and TMA would serve bf16 prefill).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int BC = 64;         // rows of a C tile: thread row ty + 16 i
constexpr int BF = 64;         // columns of an F tile: 4 a thread
constexpr int BD = 64;         // depth of one D step
constexpr int XS = BD + 1;     // padded row of the x tile (no bank conflicts)
constexpr int kXLoads = BC * BD / kThreads;      // 16 x elements a thread
constexpr int kWLoads = BD * BF / 4 / kThreads;  // 4 groups of 4 w columns

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Elements row[col .. col+3] as fp32, 0 past ncols.  ``vec``: F is a
// multiple of 4 and w aligned, so a group of 4 is either whole and aligned
// or past F.
template <typename T>
__device__ __forceinline__ float4 load_w4(const T* row, int col, int ncols,
                                          bool vec) {
  if (vec && col + 4 <= ncols) return load4(row + col);
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = col + j < ncols ? to_f32(row[col + j]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// acc[i][j] += sum_k x[ty + 16 i][k] * w[k][4 tx + j] over one D step, for
// the first NI of the thread's rows.
template <int NI>
__device__ __forceinline__ void mac(const float* sX, const float* sW,
                                    float (&acc)[4][4], int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < BD; ++k) {
    const float4 b = *reinterpret_cast<const float4*>(sW + k * BF + 4 * tx);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const float a = sX[(ty + 16 * i) * XS + k];
      acc[i][0] = fmaf(a, b.x, acc[i][0]);
      acc[i][1] = fmaf(a, b.y, acc[i][1]);
      acc[i][2] = fmaf(a, b.z, acc[i][2]);
      acc[i][3] = fmaf(a, b.w, acc[i][3]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, int C, int D, int F, long long sxe,
               long long sxc) {
  __shared__ float sX[BC * XS];
  __shared__ __align__(16) float sW[BD * BF];
  const int c0 = blockIdx.x * BC, f0 = blockIdx.y * BF, e = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int rows = min(BC, C - c0);  // valid rows of this C tile
  const int ncols = F - f0;          // valid columns from f0 on
  // groups of 4 w columns load as one vector when F and w's base allow
  const bool vec = (F & 3) == 0 &&
                   reinterpret_cast<unsigned long long>(w) % (4 * sizeof(T))
                       == 0;
  const T* xe = x + e * sxe + c0 * sxc;
  const T* we = w + static_cast<long long>(e) * D * F + f0;

  // Rows of this warp: 2w and 2w + 1, plus 16 i.  It computes the first
  // ``ni`` of them; a warp whose rows all lie past C computes nothing.
  const int warp_row = (tid >> 5) * 2;
  const int ni = rows > warp_row ? min(4, (rows - warp_row + 15) / 16) : 0;

  float xr[kXLoads];
  float4 wr[kWLoads];
  auto fetch = [&](int d0) {
#pragma unroll
    for (int j = 0; j < kXLoads; ++j) {
      const int idx = tid + j * kThreads, r = idx / BD, k = idx % BD;
      xr[j] = (r < rows && d0 + k < D) ? to_f32(xe[r * sxc + d0 + k]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kWLoads; ++j) {
      const int idx = tid + j * kThreads;
      const int k = idx / (BF / 4), q = idx % (BF / 4);
      wr[j] = d0 + k < D
                  ? load_w4(we + static_cast<long long>(d0 + k) * F, 4 * q,
                            ncols, vec)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  float acc[4][4] = {};
  fetch(0);
  for (int d0 = 0; d0 < D; d0 += BD) {
    __syncthreads();  // the previous step's tiles are consumed
#pragma unroll
    for (int j = 0; j < kXLoads; ++j) {
      const int idx = tid + j * kThreads;
      sX[(idx / BD) * XS + idx % BD] = xr[j];
    }
#pragma unroll
    for (int j = 0; j < kWLoads; ++j) {
      const int idx = tid + j * kThreads;
      *reinterpret_cast<float4*>(sW + (idx / (BF / 4)) * BF +
                                 4 * (idx % (BF / 4))) = wr[j];
    }
    __syncthreads();
    if (d0 + BD < D) fetch(d0 + BD);  // in flight while this step computes
    switch (ni) {
      case 4: mac<4>(sX, sW, acc, ty, tx); break;
      case 3: mac<3>(sX, sW, acc, ty, tx); break;
      case 2: mac<2>(sX, sW, acc, ty, tx); break;
      case 1: mac<1>(sX, sW, acc, ty, tx); break;
      default: break;
    }
  }

  T* ye = y + (static_cast<long long>(e) * C + c0) * F + f0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 4 * tx + j;
      if (col < ncols)
        ye[static_cast<long long>(r) * F + col] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int E, int C, int D, int F,
           long long sxe, long long sxc, void* stream) {
  if (E > 0 && C > 0 && F > 0) {
    const dim3 grid((C + BC - 1) / BC, (F + BF - 1) / BF, E);
    moe_gmm_kernel<T><<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(y), C, D, F, sxe, sxc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int moe_gmm_f32(const void* x, const void* w, void* y, int E,
                           int C, int D, int F, long long sxe, long long sxc,
                           void* stream) {
  return launch<float>(x, w, y, E, C, D, F, sxe, sxc, stream);
}

extern "C" int moe_gmm_bf16(const void* x, const void* w, void* y, int E,
                            int C, int D, int F, long long sxe, long long sxc,
                            void* stream) {
  return launch<__nv_bfloat16>(x, w, y, E, C, D, F, sxe, sxc, stream);
}
