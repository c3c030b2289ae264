// Grouped (per-expert) matmul on Hopper: y[e] = x[e] @ w[e], (E,C,D) @
// (E,D,F) -> (E,C,F), both operands upcast to fp32, an fp32 accumulator, the
// output in x's storage type.  With a row count per expert (``rows``, (E,)
// int32 on the device, or null for all C), row r of expert e is
// x[e, r] @ w[e] for r < min(rows[e], C) and exactly 0 past it.
//
// Replaces repro/kernels/moe_gmm.py::gmm (pl.pallas_call at :49), whose grid
// (E, nC, nF, nD) carries a (BC, BF) fp32 accumulator in VMEM across an
// ordered contraction axis, pads C to its block with jnp.pad and computes
// every row of every expert.  Here the contraction is a loop inside a
// block, a ragged C is masked in the kernel (no padded copy), x is read
// through its expert and row strides (the model hands over its dispatch
// buffer without the sink row), and a block looks at its expert's row count
// first: a block whose rows all lie past the count writes its zero tile and
// returns without reading a weight.  In a 4-slot decode tick of
// deepseek_moe_16b about 21 of 64 experts get a row, so about two thirds of
// the weight bytes are never read.
//
// Two paths, picked on the host by C (kStreamMaxC):
//
// * Streaming GEMV, C <= 8 (decode: C = 1 at four slots).  Bound by bytes:
//   E = 64, D = 2048, F = 1408 in fp32 is 738.2 MB of weights, 0.2204 ms at
//   3.35 TB/s, for 0.37 GFLOP.  One block of 8 warps per (128-column F tile,
//   chunk of up to 8 rows, expert).  Each thread loads 16 bytes of a w row
//   at a time (4 fp32 or 8 bf16 columns: a warp reads 512 contiguous bytes,
//   one row in fp32, two in bf16), U rows ahead with no barrier between
//   them.  The warps split D and meet in shared memory; x's rows sit in
//   shared memory as fp32 and are read as broadcasts.
// * Tiled tensor-core GEMM, C > 8 (prefill: C = 15 and 60 at S = 128 and
//   512).  One block per (128-column F tile, 64-row C tile, expert): a
//   producer warp loads the x tile (K-major: D contiguous) and the w tile
//   (MN-major: F contiguous) with TMA into a ring of 4 stages of 24 KB, and
//   one consumer warpgroup multiplies them.  bf16: wgmma m64n128k16 with w
//   as the transposed B operand; at S = 512 it is bound by bytes (369 MB of
//   weights, 0.110 ms, against 22 GFLOP, 0.022 ms).  fp32: 3xTF32 on
//   mma.sync.  One TF32 product misses the 2e-5 fp32 gate; fp32 FMAs on
//   CUDA cores can hardly beat cuBLAS, which reaches 39 of their 67 TFLOP/s
//   at S = 512; TF32 wgmma takes B only K-major, which w is not.  So x =
//   hi + lo in registers, hi TF32-rounded by an integer add and mask, lo =
//   x - hi, and each k8 step's lo·hi + hi·lo + hi·hi is a fresh partial
//   that an fp32 add takes into the sum (the tensor core truncates as it
//   accumulates).
//   Each warp owns 32 columns (one 128-byte TMA box) and all 64 rows, and
//   skips the 16-row slices that lie past the count.  It reads a stage
//   with plain shared-memory loads, so it fences the async proxy before it
//   releases the stage: without the fence the TMA write that refills the
//   stage could land before the reads, and now and then did: at 64
//   experts and C = 60, one call in five to eight had tiles of 17-32 rows
//   off by up to 0.6.
//
// The tiled path needs TMA's layout: 16-byte aligned bases and strides.
// Without it (a D or F that is no multiple of 8 in bf16 or 4 in fp32) C > 8
// takes the streaming path in chunks of 8 rows, which is right for any C
// but reads each weight once per chunk.
//
// Known weaknesses, left to later work: gate and up are two launches over
// the same x, with the SiLU product a third pass; blocks are not
// persistent; the tensor maps are encoded on the host at each call.
#include "common.cuh"
#include "hopper.cuh"

namespace {

// C at or under this takes the streaming GEMV, larger C the tiled path.
constexpr int kStreamMaxC = 8;
constexpr int kMaxSmem = 227 * 1024;  // a block's shared memory on Hopper
// Columns of w (and y) one block owns on either path.  A wider tile in bf16
// (256 columns, 512 bytes of a row) measured slower on both: fewer blocks
// share an expert's rows.
constexpr int kCols = 128;

// Row count of expert e: min(rows[e], C), or C without ``rows``.
__device__ __forceinline__ int expert_rows(const int* rows, int e, int C) {
  return rows == nullptr ? C : max(0, min(rows[e], C));
}

// Zeros into rows [0, nrows) and columns [n0, n0 + ncols) (within F) of y,
// whose rows are F apart, by the block's ``nthreads`` threads.
template <typename T>
__device__ void zero_tile(T* y, int nrows, int n0, int ncols, int F,
                          int nthreads) {
  const int cols = min(ncols, F - n0);
  for (int i = threadIdx.x; i < nrows * ncols; i += nthreads) {
    const int r = i / ncols, c = i - r * ncols;
    if (c < cols)
      y[static_cast<long long>(r) * F + n0 + c] = from_f32<T>(0.f);
  }
}

// ---- streaming GEMV ---------------------------------------------------------

constexpr int kGemvWarps = 8, kGemvThreads = 32 * kGemvWarps;

// 16 bytes of weights, read once: not kept in L1.  Volatile, so that the
// compiler never hoists it out of the bounds check around it.
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// The 16 bytes of a row from ``col`` element by element, 0 past F.
__device__ __forceinline__ uint4 load_tail(const float* row, int col,
                                           int F) {
  uint32_t e[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    e[j] = col + j < F ? __float_as_uint(row[col + j]) : 0u;
  return make_uint4(e[0], e[1], e[2], e[3]);
}
__device__ __forceinline__ uint4 load_tail(const __nv_bfloat16* row, int col,
                                           int F) {
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
  uint32_t e[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = col + j < F ? r[col + j] : 0u;
  return make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16, e[4] | e[5] << 16,
                    e[6] | e[7] << 16);
}

// Columns [col, col + 16 / sizeof(T)) of a w row: one vector load when they
// lie within F and ``vec`` (F a multiple of the vector, w 16-byte aligned).
template <typename T>
__device__ __forceinline__ uint4 load_w16(const T* row, int col, int F,
                                          int vec) {
  if (vec && col + static_cast<int>(16 / sizeof(T)) <= F)
    return ld_stream(row + col);
  return load_tail(row, col, F);
}

// 16 bytes as fp32: 4 floats, or 8 bf16 (element 2i in the low half).
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t p[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(p[i] << 16);
    f[2 * i + 1] = __uint_as_float(p[i] & 0xFFFF0000u);
  }
}

// Loads in flight a thread, and D rows a warp covers per iteration.
__host__ __device__ constexpr int stream_unroll(int cs) {
  return cs >= 4 ? 4 : 8;
}
__host__ __device__ constexpr int stream_step(int cs, int elsize) {
  return stream_unroll(cs) * 32 / (kCols * elsize / 16);
}

// Rows [c0, c0 + CS) of expert e against its F tile [n0, n0 + kCols).  Warp w
// takes the D rows of iterations w, w + 8, ...; each iteration issues U
// independent 16-byte loads a thread before it uses any.  Shared memory
// holds x's rows as fp32 (CS x Dp, zero past D and past the count), then
// the warps' partial sums.
template <typename T, int CS, int U>
__global__ void __launch_bounds__(kGemvThreads)
gmm_stream(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ y, const int* __restrict__ rows, int C, int D,
           int F, long long sxe, long long sxc, int Dp, int vec) {
  constexpr int V = 16 / sizeof(T);  // columns a load: 4 or 8
  constexpr int LPR = kCols / V;     // lanes on one w row: 32 or 16
  constexpr int RPL = 32 / LPR;      // w rows of one warp load: 1 or 2
  constexpr int R = U * RPL;         // D rows a warp iteration
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);
  const int e = blockIdx.z, c0 = blockIdx.y * CS, n0 = blockIdx.x * kCols;
  const int nr = min(CS, expert_rows(rows, e, C) - c0);  // rows to compute
  const int nw = min(CS, C - c0);                        // rows to write
  T* ye = y + (static_cast<long long>(e) * C + c0) * F;
  if (nr <= 0) {  // no row of this chunk: no weight is read
    zero_tile(ye, nw, n0, kCols, F, kGemvThreads);
    return;
  }
  const T* xe = x + e * sxe + c0 * sxc;
  for (int r = 0; r < CS; ++r)
    for (int d = threadIdx.x; d < Dp; d += kGemvThreads)
      xs[r * Dp + d] = r < nr && d < D ? to_f32(xe[r * sxc + d]) : 0.f;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane % LPR, h = lane / LPR;
  const int col = n0 + q * V;
  const T* we = w + static_cast<long long>(e) * D * F;
  float acc[CS][V];
#pragma unroll
  for (int r = 0; r < CS; ++r)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[r][j] = 0.f;
  for (int d0 = warp * R; d0 < D; d0 += kGemvWarps * R) {
    uint4 wv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int d = d0 + u * RPL + h;
      wv[u] = d < D ? load_w16(we + static_cast<long long>(d) * F, col, F,
                               vec)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int d = d0 + u * RPL + h;  // < Dp; x is 0 from D to Dp
      float wf[V];
      unpack(wv[u], wf);
#pragma unroll
      for (int r = 0; r < CS; ++r) {
        const float xv = xs[r * Dp + d];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[r][j] = fmaf(xv, wf[j], acc[r][j]);
      }
    }
  }
#pragma unroll
  for (int o = 16; o >= LPR; o >>= 1)  // lanes that took other rows
#pragma unroll
    for (int r = 0; r < CS; ++r)
#pragma unroll
      for (int j = 0; j < V; ++j)
        acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], o);
  __syncthreads();  // x is read: its space takes the partial sums
  float* part = xs;  // [warp][CS][kCols]
  if (h == 0) {
#pragma unroll
    for (int r = 0; r < CS; ++r)
#pragma unroll
      for (int j = 0; j < V; j += 4)
        *reinterpret_cast<float4*>(part + (warp * CS + r) * kCols + q * V +
                                   j) =
            make_float4(acc[r][j], acc[r][j + 1], acc[r][j + 2],
                        acc[r][j + 3]);
  }
  __syncthreads();
  const int ncols = min(kCols, F - n0);
  for (int i = threadIdx.x; i < nw * kCols; i += kGemvThreads) {
    const int r = i / kCols, c = i % kCols;
    if (c >= ncols) continue;
    float s = 0.f;
    if (r < nr) {
#pragma unroll
      for (int k = 0; k < kGemvWarps; ++k)
        s += part[(k * CS + r) * kCols + c];
    }
    ye[static_cast<long long>(r) * F + n0 + c] = from_f32<T>(s);
  }
}

size_t stream_smem(int cs, int D, int elsize) {
  const int step = stream_step(cs, elsize);
  const int dp = (D + step - 1) / step * step;
  const int part = kGemvWarps * kCols;  // the partial sums
  return sizeof(float) * cs * (dp > part ? dp : part);
}

template <typename T, int CS>
int run_stream(const void* x, const void* w, void* y, const int* rows, int E,
               int C, int D, int F, long long sxe, long long sxc,
               cudaStream_t stream) {
  constexpr int U = stream_unroll(CS);
  constexpr int step = stream_step(CS, sizeof(T));
  const size_t smem = stream_smem(CS, D, sizeof(T));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      gmm_stream<T, CS, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = F % (16 / sizeof(T)) == 0 &&
                  reinterpret_cast<unsigned long long>(w) % 16 == 0;
  const dim3 grid((F + kCols - 1) / kCols, (C + CS - 1) / CS, E);
  gmm_stream<T, CS, U><<<grid, kGemvThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      rows, C, D, F, sxe, sxc, (D + step - 1) / step * step, vec);
  return static_cast<int>(cudaGetLastError());
}

// Rows a block: C rounded up to a power of two, at most 8, and fewer while
// x's rows would not fit in shared memory.
template <typename T>
int launch_stream(const void* x, const void* w, void* y, const int* rows,
                  int E, int C, int D, int F, long long sxe, long long sxc,
                  cudaStream_t stream) {
  int cs = C <= 1 ? 1 : C <= 2 ? 2 : C <= 4 ? 4 : 8;
  while (cs > 1 && stream_smem(cs, D, sizeof(T)) > kMaxSmem) cs /= 2;
  switch (cs) {
    case 1:
      return run_stream<T, 1>(x, w, y, rows, E, C, D, F, sxe, sxc, stream);
    case 2:
      return run_stream<T, 2>(x, w, y, rows, E, C, D, F, sxe, sxc, stream);
    case 4:
      return run_stream<T, 4>(x, w, y, rows, E, C, D, F, sxe, sxc, stream);
    default:
      return run_stream<T, 8>(x, w, y, rows, E, C, D, F, sxe, sxc, stream);
  }
}

// ---- tiled tensor-core GEMM -------------------------------------------------

constexpr int kTileM = 64, kStages = 4;
constexpr int kTiledThreads = 128 + 32;  // a consumer warpgroup, a producer
constexpr int kXBoxBytes = kTileM * 128;  // the x tile: 64 rows of 128 bytes
constexpr int kWTileBytes = 16384;        // the w tile: BK rows of kCols
constexpr int kStageBytes = kXBoxBytes + kWTileBytes;

// BK, the depth of a stage, is one 128-byte box row of x; a w box is BK
// rows of BK columns, kCols / BK of them a stage.  A stage is 24 KB and a
// block 97 KB, so two blocks share an SM.
template <typename T> struct Tile;
template <> struct Tile<float> {
  static constexpr int BK = 32;
  static constexpr CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <> struct Tile<__nv_bfloat16> {
  static constexpr int BK = 64;
  static constexpr CUtensorMapDataType type =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

constexpr size_t tiled_smem() {
  return 1024 + static_cast<size_t>(kStages) * kStageBytes + 16 * kStages;
}

// Byte offset of fp32 element (row, col < 32) in a box of 128-byte rows that
// TMA wrote with the 128-byte swizzle.
__device__ __forceinline__ int sw128(int row, int col) {
  return row * 128 + ((((col >> 2) ^ (row & 7)) << 4) | ((col & 3) << 2));
}

// acc[i][j] += x rows [16i, 16i + 16) times w columns [8j, 8j + 8) of the
// warp's 32-column box, over one stage (BK = 32: four k8 steps), in 3xTF32,
// for the first MT 16-row slices.  In each k8 step, fragment slot t is
// k = 2t and slot t + 4 is k = 2t + 1: x's two values are one 8-byte load,
// and w's rows 2t and 2t + 1 fall in distinct banks under the swizzle.  The
// three products of a k8 step go into a fresh partial, which an fp32 add
// takes into acc: one chain of D / 8 x 3 mma.sync into acc would drift by
// the tensor core's truncation (5e-5 at D = 2048).
template <int MT>
__device__ __forceinline__ void stage_3xtf32(float (&acc)[4][4][4],
                                             const uint8_t* sx,
                                             const uint8_t* sw, int g,
                                             int t) {
#pragma unroll
  for (int kq = 0; kq < 4; ++kq) {
    const int k = 8 * kq + 2 * t;
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float2 v0 =
          *reinterpret_cast<const float2*>(sx + sw128(16 * i + g, k));
      const float2 v1 =
          *reinterpret_cast<const float2*>(sx + sw128(16 * i + g + 8, k));
      hopper::split_tf32_fast(v0.x, ah[i][0], al[i][0]);
      hopper::split_tf32_fast(v1.x, ah[i][1], al[i][1]);
      hopper::split_tf32_fast(v0.y, ah[i][2], al[i][2]);
      hopper::split_tf32_fast(v1.y, ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t bh0, bl0, bh1, bl1;
      hopper::split_tf32_fast(
          *reinterpret_cast<const float*>(sw + sw128(k, 8 * j + g)), bh0,
          bl0);
      hopper::split_tf32_fast(
          *reinterpret_cast<const float*>(sw + sw128(k + 1, 8 * j + g)), bh1,
          bl1);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float p[4];
        hopper::mma_tf32_zero(p, al[i], bh0, bh1);
        hopper::mma_tf32(p, ah[i], bl0, bl1);
        hopper::mma_tf32(p, ah[i], bh0, bh1);
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] += p[v];
      }
    }
  }
}

// The fp32 consumer's main loop over the stages, for MT 16-row slices.
template <int MT>
__device__ __forceinline__ void consume_3xtf32(float (&acc)[4][4][4],
                                               const uint8_t* smem,
                                               uint32_t full0,
                                               uint32_t empty0, int n_k,
                                               int warp, int g, int t) {
  for (int it = 0; it < n_k; ++it) {
    const int st = it % kStages;
    hopper::mbar_wait(full0 + 8 * st, (it / kStages) & 1);
    const uint8_t* sx = smem + st * kStageBytes;
    stage_3xtf32<MT>(acc, sx, sx + kXBoxBytes + warp * Tile<float>::BK * 128,
                     g, t);
    hopper::fence_proxy_async();  // the stage's reads before its refill
    hopper::mbar_arrive(empty0 + 8 * st);
  }
}

template <typename T>
__global__ void __launch_bounds__(kTiledThreads, 2)
gmm_tiled(const __grid_constant__ CUtensorMap tm_x,
          const __grid_constant__ CUtensorMap tm_w, T* __restrict__ y,
          const int* __restrict__ rows, int C, int D, int F) {
  constexpr int BK = Tile<T>::BK, BN = kCols;
  constexpr int kStage = kStageBytes;
  constexpr int kWBox = BK * 128;  // bytes of a w box
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kTileM;
  const int e = blockIdx.z;
  const int nr = min(kTileM, expert_rows(rows, e, C) - m0);  // to compute
  const int nw = min(kTileM, C - m0);                        // to write
  T* ye = y + (static_cast<long long>(e) * C + m0) * F;
  if (nr <= 0) {  // no row of this tile: no weight is read
    zero_tile(ye, nw, n0, BN, F, kTiledThreads);
    return;
  }
  // swizzled boxes need 1024-byte alignment; the launch adds the slack
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023))
                              & 1023);
  const uint32_t full0 = hopper::smem_u32(smem + kStages * kStage);
  const uint32_t empty0 = full0 + 8 * kStages;
  const int n_k = (D + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(full0 + 8 * st, 1);
      hopper::mbar_init(empty0 + 8 * st, 128);  // the consumer warpgroup
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // producer warp: one thread issues TMA
    if (threadIdx.x == 128) {
      for (int it = 0; it < n_k; ++it) {
        const int st = it % kStages;
        if (it >= kStages)  // the consumers released this stage's last use
          hopper::mbar_wait(empty0 + 8 * st, ((it / kStages) - 1) & 1);
        const uint32_t full = full0 + 8 * st;
        const uint32_t sx = hopper::smem_u32(smem + st * kStage);
        hopper::mbar_arrive_expect_tx(full, kStage);
        hopper::tma_load_4d(sx, &tm_x, it * BK, m0, e, 0, full);
        for (int b = 0; b < BN / BK; ++b)
          hopper::tma_load_4d(sx + kXBoxBytes + b * kWBox, &tm_w,
                              n0 + b * BK, it * BK, e, 0, full);
      }
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (sizeof(T) == 2) {
    // acc[4j + v]: row 16 warp + g + 8 (v >= 2), column 8j + 2t + (v & 1)
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int it = 0; it < n_k; ++it) {
      const int st = it % kStages;
      hopper::mbar_wait(full0 + 8 * st, (it / kStages) & 1);
      const uint32_t sx = hopper::smem_u32(smem + st * kStage);
      const uint32_t sw = sx + kXBoxBytes;
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hopper::wgmma_m64n128k16_ss_tb(
            acc, hopper::desc_sw128(sx + 32 * kk, 16, 1024),
            hopper::desc_sw128(sw + kk * 16 * 128, kWBox, 1024), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::mbar_arrive(empty0 + 8 * st);
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;  // F is a multiple of 8
      if (col >= F) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 16 * warp + g + 8 * half;
        if (row >= nw) continue;
        const bool live = row < nr;
        *reinterpret_cast<__nv_bfloat162*>(ye + row * F + col) =
            __floats2bfloat162_rn(live ? acc[4 * j + 2 * half] : 0.f,
                                  live ? acc[4 * j + 2 * half + 1] : 0.f);
      }
    }
  } else {
    // acc[i][j]: rows 16i + g (+ 8), columns 32 warp + 8j + 2t (+ 1)
    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
    switch ((nr + 15) / 16) {  // the 16-row slices that hold rows
      case 1:
        consume_3xtf32<1>(acc, smem, full0, empty0, n_k, warp, g, t);
        break;
      case 2:
        consume_3xtf32<2>(acc, smem, full0, empty0, n_k, warp, g, t);
        break;
      case 3:
        consume_3xtf32<3>(acc, smem, full0, empty0, n_k, warp, g, t);
        break;
      default:
        consume_3xtf32<4>(acc, smem, full0, empty0, n_k, warp, g, t);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + 32 * warp + 8 * j + 2 * t;  // F: a multiple of 4
      if (col >= F) break;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = 16 * i + g + 8 * half;
          if (row >= nw) continue;
          const bool live = row < nr;
          *reinterpret_cast<float2*>(ye + row * F + col) =
              make_float2(live ? acc[i][j][2 * half] : 0.f,
                          live ? acc[i][j][2 * half + 1] : 0.f);
        }
    }
  }
}

template <typename T>
int launch_tiled(const void* x, const void* w, void* y, const int* rows,
                 int E, int C, int D, int F, long long sxe, long long sxc,
                 cudaStream_t stream) {
  constexpr int BK = Tile<T>::BK;
  CUtensorMap tm_x, tm_w;
  const uint64_t dx[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(C),
                          static_cast<uint64_t>(E), 1};
  const long long sx[3] = {sxc, sxe, sxe * E};
  const uint64_t dw[4] = {static_cast<uint64_t>(F), static_cast<uint64_t>(D),
                          static_cast<uint64_t>(E), 1};
  const long long sw[3] = {F, static_cast<long long>(D) * F,
                           static_cast<long long>(E) * D * F};
  int err = hopper::map_4d(&tm_x, Tile<T>::type, sizeof(T), x, dx, sx, BK,
                           kTileM);
  if (!err)
    err = hopper::map_4d(&tm_w, Tile<T>::type, sizeof(T), w, dw, sw, BK, BK);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      gmm_tiled<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(tiled_smem()));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((F + kCols - 1) / kCols, (C + kTileM - 1) / kTileM, E);
  gmm_tiled<T><<<grid, kTiledThreads, tiled_smem(), stream>>>(
      tm_x, tm_w, static_cast<T*>(y), rows, C, D, F);
  return static_cast<int>(cudaGetLastError());
}

// 1 for the tiled path, 0 for the streaming GEMV: C over kStreamMaxC, and
// TMA's layout (16-byte aligned bases and strides).
int pick_path(int C, int D, int F, long long sxe, long long sxc,
              const void* x, const void* w, int elsize) {
  if (C <= kStreamMaxC || D <= 0) return 0;
  const bool aligned =
      (static_cast<long long>(F) * elsize) % 16 == 0 && sxc > 0 &&
      (sxc * elsize) % 16 == 0 && sxe > 0 && (sxe * elsize) % 16 == 0 &&
      reinterpret_cast<unsigned long long>(x) % 16 == 0 &&
      reinterpret_cast<unsigned long long>(w) % 16 == 0;
  return aligned ? 1 : 0;
}

template <typename T>
int launch(const void* x, const void* w, void* y, const int* rows, int E,
           int C, int D, int F, long long sxe, long long sxc, void* stream) {
  if (E <= 0 || C <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pick_path(C, D, F, sxe, sxc, x, w, sizeof(T)))
    return launch_tiled<T>(x, w, y, rows, E, C, D, F, sxe, sxc, s);
  return launch_stream<T>(x, w, y, rows, E, C, D, F, sxe, sxc, s);
}

}  // namespace

// x (E, C, D) with strides (sxe, sxc, 1) in elements, w (E, D, F) and y
// (E, C, F) contiguous; ``rows`` (E,) int32 on the device, or null for all C
// rows.  Returns a cudaError_t, or hopper::kNoEncoder / kEncodeFailed +
// CUresult when a tensor map could not be encoded.
extern "C" int moe_gmm_f32(const void* x, const void* w, void* y,
                           const int* rows, int E, int C, int D, int F,
                           long long sxe, long long sxc, void* stream) {
  return launch<float>(x, w, y, rows, E, C, D, F, sxe, sxc, stream);
}

extern "C" int moe_gmm_bf16(const void* x, const void* w, void* y,
                            const int* rows, int E, int C, int D, int F,
                            long long sxe, long long sxc, void* stream) {
  return launch<__nv_bfloat16>(x, w, y, rows, E, C, D, F, sxe, sxc, stream);
}

// The path the entry points take for these operands: 1 tiled, 0 streaming.
extern "C" int moe_gmm_path(int C, int D, int F, long long sxe,
                            long long sxc, const void* x, const void* w,
                            int elsize) {
  return pick_path(C, D, F, sxe, sxc, x, w, elsize);
}
