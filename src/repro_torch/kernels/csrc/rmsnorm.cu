// Row RMSNorm: y = x * rsqrt(mean(x^2) + eps) * scale, fp32 math.
//
// Replaces repro/kernels/rmsnorm.py::rmsnorm (pl.pallas_call at :35), which
// normalises 256-row blocks in VMEM.  Here one thread block takes one row.
//
// Bound on Hopper: bytes.  The function reads each element once and writes
// it once (4 flops per element), far below the ~20 flop/byte the H100 needs
// in fp32 before compute matters.  The design keeps every access coalesced
// (neighbouring threads on neighbouring elements) and reduces the sum of
// squares in registers and shared memory; the second pass re-reads the row,
// which a row of d_model <= 12288 keeps in L1/L2, so device memory sees one
// read and one write.  At the decode shape (4 rows) the kernel is bound by
// launch latency, not by either roofline.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
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
  if (warp == 0) {
    float v = lane < kThreads / 32 ? part[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) part[0] = v;
  }
  __syncthreads();
  const float inv = rsqrtf(part[0] / static_cast<float>(d) + eps);
  for (int i = threadIdx.x; i < d; i += kThreads)
    yr[i] = from_f32<T>(to_f32(xr[i]) * inv * scale[i]);
}

template <typename T>
int launch(const void* x, const void* scale, void* y, int n, int d,
           float eps, void* stream) {
  if (n > 0)
    rmsnorm_kernel<T><<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<T*>(y), d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rmsnorm_f32(const void* x, const void* scale, void* y, int n,
                           int d, float eps, void* stream) {
  return launch<float>(x, scale, y, n, d, eps, stream);
}

extern "C" int rmsnorm_bf16(const void* x, const void* scale, void* y, int n,
                            int d, float eps, void* stream) {
  return launch<__nv_bfloat16>(x, scale, y, n, d, eps, stream);
}
