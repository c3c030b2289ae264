// Hopper (sm_90a) building blocks of the port's kernels: mbarriers, the
// proxy fence, thread block clusters (rank, distributed shared memory, the
// cluster barrier), the TMA tile load, wgmma shared-memory descriptors, the
// wgmma and mma.sync instructions the kernels issue, and the host-side
// encoding of a TMA tensor map.
//
// The tensor map is encoded with cuTensorMapEncodeTiled, which lives in
// libcuda.  The library links no libcuda (the build is one plain nvcc call,
// and an install may lack the unversioned libcuda.so that -lcuda needs), so
// the CUDA runtime hands out the function's address: the entry-point query
// taken by version from CUDA 12.5 on, where the older query's signature
// changed.  <cuda.h> gives only the types and enums.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(bar)
      : "memory");
}

// One arrival that also expects ``bytes`` of transactions (TMA writes).
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n\t}" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}

// Waits until the barrier's phase of parity ``parity`` has completed.  A
// wait still open after 2^34 clocks (about 10 s) traps, so a pipeline fault
// ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// Orders this thread's earlier shared-memory reads and writes (the generic
// proxy) before later accesses of the async proxy: TMA.  A consumer that
// read a ring stage with plain loads issues it before it releases the
// stage; without it the TMA write that refills the stage can land first.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Barrier ``id`` (1-15; 0 is __syncthreads) over ``count`` threads.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// ---- thread block clusters --------------------------------------------------

// This block's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// The address in the shared memory of the cluster's block ``rank`` that
// corresponds to ``addr`` (a shared-memory address of this block).
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// A 16-byte store into another block's shared memory, at a 16-byte aligned
// address from map_rank.
__device__ __forceinline__ void st_cluster(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(
                   addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// The cluster barrier, split: every thread of every block of the cluster
// arrives (releasing its earlier writes, shared memory of other blocks
// included) and later waits (acquiring everyone's).  Every thread of a warp
// must take both together.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// ---- TMA --------------------------------------------------------------------

// One box of a 4-d tensor map into shared memory at ``dst``, completing
// ``bytes`` (the whole box, zero-filled out of bounds) on barrier ``bar``.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor for a tile that TMA wrote with the 128-byte
// swizzle: start address, leading and stride byte offsets (all >> 4) and the
// swizzle mode (1 = 128 B) in bits 62-63.  The tile's 8-row atoms must be
// 1024-byte aligned, so the base offset (bits 49-51) stays 0.
//   K-major (K contiguous): SBO = 1024 (next 8 rows), LBO unused; a k-step
//     inside the 128-byte row advances the start address by its bytes.
//   MN-major (M or N contiguous): LBO = the stride between 64-element
//     (128-byte) column chunks, SBO = 1024 (next 8 K-rows).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) : : "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i]) : : "memory");
}

#define HOPPER_ACC8(d, i)                                             \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_ACC32(d, i)                                            \
  HOPPER_ACC8(d, i), HOPPER_ACC8(d, i + 8), HOPPER_ACC8(d, i + 16),   \
      HOPPER_ACC8(d, i + 24)

// D(64x64, f32) = A(64x16, bf16, K-major in smem) * B(16x64, bf16, K-major
// in smem, i.e. N rows of K contiguous), + D unless ``accumulate`` is 0.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n\t}"
      : HOPPER_ACC32(d, 0)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D(64x128, f32) += A(64x16, bf16, K-major in smem) * B(16x128, bf16,
// MN-major in smem: the transposed B operand, N contiguous), + D unless
// ``accumulate`` is 0.  B's descriptor: LBO = the stride between its
// 64-column (128-byte) chunks, SBO = 1024; a k-step of 16 rows advances the
// start address by 16 x 128 bytes.
__device__ __forceinline__ void wgmma_m64n128k16_ss_tb(float (&d)[64],
                                                       uint64_t desc_a,
                                                       uint64_t desc_b,
                                                       int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n\t}"
      : HOPPER_ACC32(d, 0), HOPPER_ACC32(d, 32)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D(64xN, f32) += A(64x16, bf16, from registers) * B(16xN, bf16, MN-major
// in smem: the transposed B operand, N contiguous).  A's four registers hold
// (row g, k 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..) of the warp's
// 16 rows, g = lane/4 and t = lane%4: the layout of a 16-column slice of an
// f32 accumulator, so scores become the next product's A without smem.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : HOPPER_ACC32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1;\n\t}"
      : HOPPER_ACC32(d, 0), HOPPER_ACC32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef HOPPER_ACC32
#undef HOPPER_ACC8

// ---- mma.sync, TF32 ---------------------------------------------------------

// Round a finite float to TF32 (10 mantissa bits), to nearest with ties
// away from zero: what cvt.rna.tf32.f32 gives, which ptxas expands to an
// inf/NaN test and a select besides this add and mask.  Half an ulp is
// added to the magnitude bits, then the 13 low bits are cleared.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo to about 2^-22 of |x|: hi = tf32(x), lo = tf32(x - hi).
// Finite inputs only.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// x = hi + lo with hi = tf32(x) and lo = x - hi passed unrounded: whatever
// the tensor core does with lo's low 13 bits moves lo·y by at most 2^-21 of
// |x·y|.  One integer add, one mask and one subtraction, against five
// instructions for split_tf32.  Finite inputs only.
__device__ __forceinline__ void split_tf32_fast(float x, uint32_t& hi,
                                                uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// C(16x8, f32) += A(16x8, tf32) * B(8x8, tf32).  g = lane/4, t = lane%4:
// a = (g, t), (g+8, t), (g, t+4), (g+8, t+4); b = (k t, n g), (k t+4, n g);
// c = (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D(16x8, f32) = A(16x8, tf32) * B(8x8, tf32), with C = 0: a fresh partial
// sum.  The tensor core truncates as it accumulates, so a long chain of
// mma.sync into one accumulator drifts (about 5e-5 over 768 products of
// O(1) sums); a kernel adds such partials into its fp32 sum instead.
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// ---- host: tensor maps ------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Errors of map_4d, returned by the kernels' C entry points: the runtime
// found no cuTensorMapEncodeTiled, or it refused (its CUresult added to
// kEncodeFailed).
constexpr int kNoEncoder = 90000;
constexpr int kEncodeFailed = 90001;

// A 4-d tiled tensor map over (dim0 contiguous, dim1, dim2, dim3) with
// element strides s1..s3 for the outer three dims, boxes of (box0, box1, 1,
// 1), the 128-byte swizzle and zero fill out of bounds.  0 on success.
inline int map_4d(CUtensorMap* map, CUtensorMapDataType type, int elsize,
                  const void* base, const uint64_t (&dims)[4],
                  const long long (&strides)[3], uint32_t box0,
                  uint32_t box1) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t gdim[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t gstride[3] = {
      static_cast<cuuint64_t>(strides[0]) * elsize,
      static_cast<cuuint64_t>(strides[1]) * elsize,
      static_cast<cuuint64_t>(strides[2]) * elsize};
  const cuuint32_t box[4] = {box0, box1, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, type, 4, const_cast<void*>(base), gdim, gstride, box, estride,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

}  // namespace hopper
