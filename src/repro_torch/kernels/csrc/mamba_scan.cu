// Chunked Mamba2 SSD forward: y and the final state of
//   h_t = exp(dt_t * a) h_{t-1} + dt_t * B_t x_t,   y_t = C_t h_t
// per (batch row, head), with B and C shared by all heads (G = 1).
//
// Replaces repro/kernels/mamba_scan.py::mamba_scan (pl.pallas_call at :78),
// whose grid (B, H, nChunks) carries the (N, P) state in VMEM across an
// ordered chunk axis.  Hopper has no ordered grid, so this follows the
// dataflow of repro/models/ssm.py::ssd_chunked instead: every (batch row,
// chunk, head, slice of P) is a block of its own, and the state passes
// between chunks through a scratch in L2.  One call is ONE device kernel.
//
// The kernel's chunk is 64 rows, whatever chunk the caller names: the SSD's
// result does not depend on the chunk length, only the order of its sums
// does.  The last chunk may be ragged (S = 17 is one chunk of 17 rows).
// Per chunk of rows i, j < L, with cum the chunk's cumsum of dt * a:
//
//   Z     = (B ⊙ dt exp(cum_L - cum))ᵀ X                 (N x P, the summary)
//   G     = (C Bᵀ) ⊙ exp(cum_i - cum_j) ⊙ dt_j, j <= i    (L x L, masked)
//   state = exp(cum_L) state_prev + Z
//   y     = G X + exp(cum) ⊙ (C state_prev)
//
// state_prev, the state after the chunks before, comes by a decoupled
// look-back: a block takes its unit in launch order from a counter (chunk
// major), writes Z to the scratch and flags it (1); it then walks back over
// the earlier chunks of its (b, head, slice), adding each one's Z scaled by
// the decays in between, until it meets one whose own state is out (flag
// 2), adds that and stops; it writes its own state and flags it 2.  A block
// waits only on blocks that took their unit before it, and those are
// running, so the grid progresses whatever order the card schedules it in.
// The last block to finish puts the counters and flags back to 0, so the
// next launch (or a CUDA graph's replay) finds them clean.  A wait still
// open after 2^34 clocks (about 10 s) traps instead of hanging the card.
//
// Products run on tensor cores with mma.sync, a warp a 16-row tile, its
// fragments by ldmatrix where the layout allows; tiles of C Bᵀ and steps of
// G X past the diagonal are skipped.  fp32: 3xTF32, hi·hi and the two
// corrections in accumulators of their own (gemm_3xtf32).  bf16: C Bᵀ,
// G X and the summary on bf16 m16n8k16 with fp32 accumulation; G and
// B ⊙ dt exp(cum_L - cum), fp32 values, are each split into a bf16 pair
// hi + lo (hi = bf16(v), lo = bf16(v - hi), 2^-17 of v) and take two
// products: one bf16 rounding of them put y 3e-2 off the sequential
// recurrence at S = 512.  The state is fp32 in both types, and so is
// C state_prev: TF32 with the state split in two (bf16 C is exact in TF32).
// ref.ssd_plan is this plan on the CPU.
//
// Bound on Hopper: at zamba2's prefill (S = 512, H = 112, N = P = 64) the
// function needs ~1.2 GFLOP against ~31 MB of inputs and outputs: bytes in
// bf16; in fp32, 3xTF32 triples the flops at the TF32 peak, and the bytes
// still bound it.  The scratch round trip (Z and the states, 2 x 14.7 MB at
// S = 512) stays in the 50 MB L2 as far as it can.  What sets the time is
// neither: a block is a chain of dependent phases (loads, four products,
// the look-back), two blocks fit an SM, and at S = 512 the grid runs in
// about four waves; repro_torch/launch/scan_phases.py times the phases.
//
// Shapes: N <= 128 (64 or 128 in the tiles); P a multiple of 4, split
// into blocks of 64 columns, or of 32 where the grid would otherwise not
// fill the card (mamba_scan.tiling).  Rows of x, B and C that start on 16
// bytes (the model's) go by cp.async, others element by element.
//
// One chunk (S <= 64, six of zamba2's eight served prompts) needs no order
// between blocks: the block index is the unit, Z is the final state, and
// neither the scratch nor the counters are touched.
#include "common.cuh"
#include "hopper.cuh"

// Phase stamps, for repro_torch/launch/scan_phases.py only: built with
// -DMAMBA_SCAN_STAMPS, thread 0 of each block writes %globaltimer (ns) at
// the end of each phase into mamba_scan_stamps[unit]; the default build has
// none of it.
#ifdef MAMBA_SCAN_STAMPS
constexpr int kStampUnits = 8192, kStamps = 12;
__device__ unsigned long long mamba_scan_stamps[kStampUnits][kStamps];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(k, value)                                     \
  do {                                                      \
    if (threadIdx.x == 0 && u < kStampUnits)                \
      mamba_scan_stamps[u][k] = (value);                    \
  } while (0)
// Copies the stamps to ``host`` and sets them to 0 for the next launch.
extern "C" int mamba_scan_read_stamps(void* host) {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, mamba_scan_stamps);
  if (e == cudaSuccess)
    e = cudaMemcpy(host, p, sizeof(mamba_scan_stamps),
                   cudaMemcpyDeviceToHost);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(mamba_scan_stamps));
  return static_cast<int>(e);
}
#else
#define STAMP(k, value) \
  do {                  \
  } while (0)
#endif

namespace {

constexpr int kThreads = 256;  // 8 warps: rows 16 (w % 4), column half w / 4
constexpr int kRows = 64;      // the kernel's chunk
// The thread that publishes Z: lane 0 of warp 4, whose tile of C Bᵀ lies
// above the diagonal, so its fence holds up no product.
constexpr int kPublisher = 128;

struct Strides {
  long long xb, xs, xh, bb, bs, cb, cs;
};

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Shared memory of one block.  Row pads keep the fragment loads free of
// bank conflicts: ldmatrix (A operands, [n][k] B operands, bf16 [k][n] B
// operands) wants 8 rows in distinct 16-byte bank groups, a row stride of
// 4 words mod 32; fp32 [k][n] B operands, loaded a word at a time, 8 words.
template <typename T, int NT, int PW>
struct Smem {
  static constexpr int el = sizeof(T);
  static constexpr bool f32 = sizeof(T) == 4;
  static constexpr int ldx = PW + 8;                     // X [j][p], T
  static constexpr int ldbc = NT + (f32 ? 4 : 8);        // B [j][n], C [i][n]
  static constexpr int ldg = kRows + (f32 ? 4 : 8);      // Bw [n][j], G [i][j]
  static constexpr int lds = PW + 8;                     // Sprev [n][p], fp32
  static constexpr int x = 0;
  static constexpr int c = x + kRows * ldx * el;
  static constexpr int b = c + kRows * ldbc * el;        // B, then Sprev
  static constexpr int g = b + cmax(kRows * ldbc * el, NT * lds * 4);
  static constexpr int g_elems = cmax(NT, kRows) * ldg;  // Bw, then G
  static constexpr int v = g + (f32 ? 1 : 2) * g_elems * el;  // bf16: hi, lo
  static constexpr int bytes = v + 4 * kRows * 4 + 16;   // cum, dt, w, e
};

// 16 bytes into shared memory, of which the first ``bytes`` (0 to 16) come
// from ``src`` and the rest are zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Four 8x8 matrices of 16-bit elements, rows at the addresses of lanes
// 8m..8m+7 for matrix m: the A fragment of a 16-row tile, or the B
// fragments of two 8-column tiles of an [n][k] operand (fp32 taken as pairs
// of halves: an 8 x 4 block of fp32 a matrix).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_u32(p)));
}

// The same, transposed: the B fragments of two 8-column tiles of a bf16
// [k][n] operand.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_u32(p)));
}

// d (16x8, fp32) += a (16x16, bf16, row) b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[mi][nj] += A[r0 + 16 mi + ., k] B[k, n0 + 8 nj + .] over k < kEnd
// (a multiple of 16, at most K) for the first njLive (even) of NJ column
// tiles, in 3xTF32: A row-major in fp32, or in bf16, which is exact in
// TF32 (no low part, two products); B fp32, [k][n] (KN) or [n][k]; g =
// lane / 4, t = lane % 4.  fp32 A and [n][k] B come by ldmatrix.  hi·hi
// chains in acc, the corrections lo·hi + hi·lo in an accumulator of their
// own, added at the end: with K <= 128 a chain is at most 16 k8 steps,
// short enough that the tensor core's truncating accumulation stays under
// 1e-6 (a chain of 256 drifts by 5e-5).
template <int MI, int NJ, bool KN, int K, typename TA>
__device__ __forceinline__ void gemm_3xtf32(float (&acc)[MI][NJ][4],
                                            const TA* A, int lda, int r0,
                                            const float* Bm, int ldb, int n0,
                                            int kEnd, int njLive, int lane) {
  constexpr bool f32a = sizeof(TA) == 4;
  const int g = lane >> 2, t = lane & 3, m = lane >> 3, l8 = lane & 7;
  float cor[MI][NJ][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 8) {
    if (k0 >= kEnd) break;
    uint32_t ah[MI][4], al[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      if constexpr (f32a) {
        uint32_t r[4];
        ldsm_x4(r, A + (r0 + 16 * mi + l8 + 8 * (m & 1)) * lda + k0 +
                       4 * (m >> 1));
#pragma unroll
        for (int v = 0; v < 4; ++v)
          hopper::split_tf32_fast(__uint_as_float(r[v]), ah[mi][v],
                                  al[mi][v]);
      } else {
        const TA* a = A + (r0 + 16 * mi + g) * lda + k0 + t;
        hopper::split_tf32_fast(to_f32(a[0]), ah[mi][0], al[mi][0]);
        hopper::split_tf32_fast(to_f32(a[8 * lda]), ah[mi][1], al[mi][1]);
        hopper::split_tf32_fast(to_f32(a[4]), ah[mi][2], al[mi][2]);
        hopper::split_tf32_fast(to_f32(a[8 * lda + 4]), ah[mi][3],
                                al[mi][3]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < NJ / 2; ++jj) {
      if (2 * jj >= njLive) break;
      float bv[4];  // b0, b1 of tile 2 jj, then of tile 2 jj + 1
      if (KN) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = n0 + 8 * (2 * jj + q) + g;
          bv[2 * q] = Bm[(k0 + t) * ldb + n];
          bv[2 * q + 1] = Bm[(k0 + t + 4) * ldb + n];
        }
      } else {
        uint32_t r[4];
        ldsm_x4(r, Bm + (n0 + 8 * (2 * jj + (m >> 1)) + l8) * ldb + k0 +
                       4 * (m & 1));
#pragma unroll
        for (int v = 0; v < 4; ++v) bv[v] = __uint_as_float(r[v]);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int nj = 2 * jj + q;
        uint32_t bh0, bl0, bh1, bl1;
        hopper::split_tf32_fast(bv[2 * q], bh0, bl0);
        hopper::split_tf32_fast(bv[2 * q + 1], bh1, bl1);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          hopper::mma_tf32(cor[mi][nj], ah[mi], bl0, bl1);
          if (f32a) hopper::mma_tf32(cor[mi][nj], al[mi], bh0, bh1);
          hopper::mma_tf32(acc[mi][nj], ah[mi], bh0, bh1);
        }
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mi][nj][v] += cor[mi][nj][v];
}

// The same in bf16 on m16n8k16, every fragment by ldmatrix: A row-major; B
// [k][n] (KN, transposed) or [n][k].  SPLIT: A is the hi part of a bf16
// pair whose lo part lies ``lo`` elements on, and both are multiplied.
template <int MI, int NJ, bool KN, bool SPLIT, int K>
__device__ __forceinline__ void gemm_bf16(float (&acc)[MI][NJ][4],
                                          const __nv_bfloat16* A, int lda,
                                          int lo, int r0,
                                          const __nv_bfloat16* Bm, int ldb,
                                          int n0, int kEnd, int njLive,
                                          int lane) {
  const int m = lane >> 3, l8 = lane & 7;
  constexpr int NA = SPLIT ? 2 : 1;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    if (k0 >= kEnd) break;
    uint32_t a[NA][MI][4];
#pragma unroll
    for (int part = 0; part < NA; ++part)
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldsm_x4(a[part][mi], A + part * lo +
                                 (r0 + 16 * mi + l8 + 8 * (m & 1)) * lda +
                                 k0 + 8 * (m >> 1));
#pragma unroll
    for (int jj = 0; jj < NJ / 2; ++jj) {
      if (2 * jj >= njLive) break;
      uint32_t b[4];  // b0, b1 of tile 2 jj, then of tile 2 jj + 1
      if (KN)
        ldsm_x4_trans(b, Bm + (k0 + 8 * (m & 1) + l8) * ldb + n0 +
                             8 * (2 * jj + (m >> 1)));
      else
        ldsm_x4(b, Bm + (n0 + 8 * (2 * jj + (m >> 1)) + l8) * ldb + k0 +
                       8 * (m & 1));
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int part = 0; part < NA; ++part)
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
            mma_bf16(acc[mi][2 * jj + q], a[part][mi], b[2 * q],
                     b[2 * q + 1]);
    }
  }
}

// acc += A B over k < kEnd <= K, the first njLive column tiles, in the
// storage type's plan; SPLIT (bf16 only): A is a pair.
template <int MI, int NJ, bool KN, bool SPLIT, int K, typename T>
__device__ __forceinline__ void gemm(float (&acc)[MI][NJ][4], const T* A,
                                     int lda, int lo, int r0, const T* Bm,
                                     int ldb, int n0, int kEnd, int njLive,
                                     int lane) {
  if constexpr (sizeof(T) == 4)
    gemm_3xtf32<MI, NJ, KN, K>(acc, A, lda, r0, Bm, ldb, n0, kEnd, njLive,
                               lane);
  else
    gemm_bf16<MI, NJ, KN, SPLIT, K>(acc, A, lda, lo, r0, Bm, ldb, n0, kEnd,
                                    njLive, lane);
}

// An fp32 operand into shared memory: as it is, or as a bf16 pair, hi at
// ``p`` and lo ``lo`` elements on.
__device__ __forceinline__ void put(float* p, int, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, int lo, float v) {
  const __nv_bfloat16 hi = __float2bfloat16(v);
  p[0] = hi;
  p[lo] = __float2bfloat16(v - __bfloat162float(hi));
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Makes the block's global writes before the barrier that precedes this
// call visible at GPU scope, then sets the flag: the barrier and one
// thread's fence order every thread's writes, as a grid barrier does.
__device__ __forceinline__ void publish(int* flag, int v) {
  __threadfence();
  store_release(flag, v);
}

__device__ __forceinline__ int wait_flag(const int* p) {
  const long long start = clock64();
  int v;
  while ((v = load_acquire(p)) == 0) {
    if (clock64() - start > (1ll << 34)) __trap();
    __nanosleep(32);
  }
  return v;
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ws: Z of every unit (NT x PW floats each), then the state after every
// unit's chunk, then every unit's exp(cum_L).  ctr: the unit counter, the
// done counter, then one flag a unit.
template <typename T, int NT, int PW>
__global__ void __launch_bounds__(kThreads, 2)
mamba_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a_log, const T* __restrict__ bm,
                  const T* __restrict__ cm, T* __restrict__ y,
                  float* __restrict__ state_out, float* ws, int* ctr, int B,
                  int S, int H, int P, int N, Strides st, int vec) {
  using L = Smem<T, NT, PW>;
  constexpr int MZ = NT / 64;         // 16-row slices of Z a warp takes
  constexpr int NJ = PW / 16;         // 8-column tiles a warp takes
  constexpr int kBlk = NT * PW;       // floats of one state
  extern __shared__ __align__(16) uint8_t smem[];
#ifdef MAMBA_SCAN_STAMPS
  const unsigned long long t_start = global_ns();
#endif
  T* sX = reinterpret_cast<T*>(smem + L::x);
  T* sC = reinterpret_cast<T*>(smem + L::c);
  T* sB = reinterpret_cast<T*>(smem + L::b);
  float* sS = reinterpret_cast<float*>(smem + L::b);
  T* sG = reinterpret_cast<T*>(smem + L::g);   // Bw first, then G
  float* sCum = reinterpret_cast<float*>(smem + L::v);
  float* sDt = sCum + kRows;
  float* sW = sDt + kRows;
  float* sE = sW + kRows;
  int* sInt = reinterpret_cast<int*>(sE + kRows);
  float* sF = reinterpret_cast<float*>(sInt + 2);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp & 3, wc = warp >> 2, g = lane >> 2, t = lane & 3;
  const int nC = (S + kRows - 1) / kRows, PS = (P + PW - 1) / PW;
  const int per_chunk = B * H * PS, total = nC * per_chunk;
  // one chunk needs no order: the block index is the unit
  if (nC > 1 && tid == 0) sInt[0] = atomicAdd(ctr, 1);
  __syncthreads();
  const int u = nC > 1 ? sInt[0] : blockIdx.x;
  STAMP(0, t_start);
  STAMP(1, global_ns());  // the unit
  const int c = u / per_chunk, rest = u - c * per_chunk;
  const int b = rest / (H * PS), h = (rest / PS) % H, ps = rest % PS;
  const int c0 = c * kRows, rows = min(kRows, S - c0), p0 = ps * PW;
  int* flags = ctr + 2;
  float* zs = ws;                               // Z of unit u
  float* incl = ws + (long long)total * kBlk;   // the state after unit u
  float* decay = incl + (long long)total * kBlk;

  // X, B and C of the chunk into shared memory; rows past the chunk and
  // columns past P or N are zero.  Rows off 16 bytes go element by element.
  if (vec) {
    constexpr int kv = 16 / sizeof(T);
    const T* xp = x + b * st.xb + c0 * st.xs + h * st.xh + p0;
    for (int i = tid; i < kRows * PW / kv; i += kThreads) {
      const int r = i / (PW / kv), q = (i - r * (PW / kv)) * kv;
      const int n_el = r < rows ? min(kv, P - p0 - q) : 0;
      cp_async16(sX + r * L::ldx + q, n_el > 0 ? xp + r * st.xs + q : x,
                 max(n_el, 0) * (int)sizeof(T));
    }
    const T* bp = bm + b * st.bb + c0 * st.bs;
    const T* cp = cm + b * st.cb + c0 * st.cs;
    for (int i = tid; i < kRows * NT / kv; i += kThreads) {
      const int r = i / (NT / kv), q = (i - r * (NT / kv)) * kv;
      const int n_el = r < rows ? min(kv, N - q) : 0;
      const int nb = max(n_el, 0) * (int)sizeof(T);
      cp_async16(sB + r * L::ldbc + q, n_el > 0 ? bp + r * st.bs + q : bm,
                 nb);
      cp_async16(sC + r * L::ldbc + q, n_el > 0 ? cp + r * st.cs + q : cm,
                 nb);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  } else {
    const T zero = from_f32<T>(0.f);
    const T* xp = x + b * st.xb + c0 * st.xs + h * st.xh + p0;
    for (int i = tid; i < kRows * PW; i += kThreads) {
      const int r = i / PW, q = i - r * PW;
      sX[r * L::ldx + q] = r < rows && p0 + q < P ? xp[r * st.xs + q] : zero;
    }
    const T* bp = bm + b * st.bb + c0 * st.bs;
    const T* cp = cm + b * st.cb + c0 * st.cs;
    for (int i = tid; i < kRows * NT; i += kThreads) {
      const int r = i / NT, q = i - r * NT;
      const bool ok = r < rows && q < N;
      sB[r * L::ldbc + q] = ok ? bp[r * st.bs + q] : zero;
      sC[r * L::ldbc + q] = ok ? cp[r * st.cs + q] : zero;
    }
  }
  // the chunk's cumsum of dt * a, a scan over one warp's shuffles, while
  // the copies fly
  if (warp == 0) {
    const float av = -expf(a_log[h]);
    const float* dtp = dt + ((long long)b * S + c0) * H + h;
    const int r0 = 2 * lane;
    const float d0 = r0 < rows ? dtp[(long long)r0 * H] : 0.f;
    const float d1 = r0 + 1 < rows ? dtp[(long long)(r0 + 1) * H] : 0.f;
    const float v0 = d0 * av, v1 = d1 * av;
    float s = v0 + v1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += up;
    }
    float ex = __shfl_up_sync(0xffffffffu, s, 1);
    if (lane == 0) ex = 0.f;
    const float cum0 = ex + v0, cum1 = cum0 + v1;
    const float last = __shfl_sync(0xffffffffu, cum1, 31);
    sCum[r0] = cum0;
    sCum[r0 + 1] = cum1;
    sDt[r0] = d0;
    sDt[r0 + 1] = d1;
    sW[r0] = d0 * expf(last - cum0);
    sW[r0 + 1] = d1 * expf(last - cum1);
    sE[r0] = expf(cum0);
    sE[r0 + 1] = expf(cum1);
    if (lane == 0) sF[0] = expf(last);
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  STAMP(2, global_ns());  // x, B, C, cumsum

  // Bw [n][j] = B[j][n] w_j (in bf16 a pair)
  constexpr int lo = L::g_elems;
  for (int i = tid; i < NT * kRows; i += kThreads) {
    const int n = i / kRows, j = i - n * kRows;
    put(sG + n * L::ldg + j, lo, to_f32(sB[j * L::ldbc + n]) * sW[j]);
  }
  __syncthreads();
  STAMP(3, global_ns());  // B ⊙ w

  // the summary Z = Bwᵀ X, kept in registers: warp w holds rows
  // 16 MZ (w % 4) onwards of its half of the columns.  Into the scratch,
  // flagged at once, or, where the chunk is the only one, the final state
  float z[MZ][NJ][4] = {};
  gemm<MZ, NJ, true, true, kRows>(z, sG, L::ldg, lo, 16 * MZ * wr, sX,
                                  L::ldx, wc * PW / 2, kRows, NJ, lane);
  float* zp = zs + (long long)u * kBlk;
  float* fp = state_out + (((long long)b * H + h) * N) * P + p0;
#pragma unroll
  for (int mi = 0; mi < MZ; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj) {
      const int n = 16 * (MZ * wr + mi) + g;
      const int p = wc * PW / 2 + 8 * nj + 2 * t;
      if (nC > 1) {
        *reinterpret_cast<float2*>(zp + n * PW + p) =
            make_float2(z[mi][nj][0], z[mi][nj][1]);
        *reinterpret_cast<float2*>(zp + (n + 8) * PW + p) =
            make_float2(z[mi][nj][2], z[mi][nj][3]);
      } else if (p0 + p < P) {
        if (n < N)
          *reinterpret_cast<float2*>(fp + n * P + p) =
              make_float2(z[mi][nj][0], z[mi][nj][1]);
        if (n + 8 < N)
          *reinterpret_cast<float2*>(fp + (n + 8) * P + p) =
              make_float2(z[mi][nj][2], z[mi][nj][3]);
      }
    }
  if (nC > 1 && tid == kPublisher) decay[u] = sF[0];
  __syncthreads();  // Z is out, and Bw is read: its space takes G
  if (nC > 1 && tid == kPublisher)  // chunk 0's Z is its state
    publish(flags + u, c == 0 ? 2 : 1);
  STAMP(4, global_ns());  // Z out and flagged

  // G = (C Bᵀ) ⊙ exp(cum_i - cum_j) ⊙ dt_j on and below the diagonal: a
  // warp takes the 8-column tiles of its 16 x 32 tile that reach it (none
  // for warps 4 and 5), and none where its rows are past the chunk.  No
  // product reads G past the diagonal's 16 x 16 block.
  const bool live = 16 * wr < rows;
  const int gLive = live ? max(0, min(4, (16 * wr + 16 - 32 * wc) / 8)) : 0;
  if (gLive > 0) {
    float acc[1][4][4] = {};
    gemm<1, 4, false, false, NT>(acc, sC, L::ldbc, 0, 16 * wr, sB, L::ldbc,
                                 32 * wc, NT, gLive, lane);
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      if (nj >= gLive) break;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int i = 16 * wr + g + (v >> 1) * 8;
        const int j = 32 * wc + 8 * nj + 2 * t + (v & 1);
        const float gv =
            j <= i ? acc[0][nj][v] * expf(sCum[i] - sCum[j]) * sDt[j] : 0.f;
        put(sG + i * L::ldg + j, lo, gv);
      }
    }
  }
  __syncthreads();  // G is whole; B is read, its space takes the state
  STAMP(5, global_ns());  // C Bᵀ and G

  // y = G X, the causal part: rows 16 wr need k < 16 wr + 16
  float yacc[1][NJ][4] = {};
  if (live)
    gemm<1, NJ, true, true, kRows>(yacc, sG, L::ldg, lo, 16 * wr, sX,
                                   L::ldx, wc * PW / 2, 16 * wr + 16, NJ,
                                   lane);
  STAMP(6, global_ns());  // G X

  if (c > 0) {
    // look back over the earlier chunks of this (b, h, ps), each thread
    // over the entries of Z it holds
    float sp[MZ][NJ][4] = {};
    float scale = 1.f;
    for (int k = c - 1; k >= 0; --k) {
      const int uk = u - (c - k) * per_chunk;
      if (tid == 0) {
        const int f = wait_flag(flags + uk);
        sInt[1] = f;
        sF[1] = f == 1 ? __ldcg(decay + uk) : 0.f;
      }
      __syncthreads();
      const int f = sInt[1];
      const float dk = sF[1];
      const float* src = (f == 2 && k > 0 ? incl : zs) + (long long)uk * kBlk;
#pragma unroll
      for (int mi = 0; mi < MZ; ++mi)
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj) {
          const int n = 16 * (MZ * wr + mi) + g;
          const int p = wc * PW / 2 + 8 * nj + 2 * t;
          const float2 v0 =
              __ldcg(reinterpret_cast<const float2*>(src + n * PW + p));
          const float2 v1 =
              __ldcg(reinterpret_cast<const float2*>(src + (n + 8) * PW + p));
          sp[mi][nj][0] += scale * v0.x;
          sp[mi][nj][1] += scale * v0.y;
          sp[mi][nj][2] += scale * v1.x;
          sp[mi][nj][3] += scale * v1.y;
        }
      __syncthreads();  // sInt[1] and sF[1] are read
      if (f == 2) break;
      scale *= dk;
    }
    STAMP(7, global_ns());  // look-back
    // this chunk's state = exp(cum_L) state_prev + Z (published at the
    // end), the last chunk's the final state; state_prev goes to shared
    // memory for C state_prev
    const float total_decay = sF[0];
    float* out = incl + (long long)u * kBlk;
#pragma unroll
    for (int mi = 0; mi < MZ; ++mi)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int n = 16 * (MZ * wr + mi) + g + 8 * half;
          const int p = wc * PW / 2 + 8 * nj + 2 * t;
          const float s0 = sp[mi][nj][2 * half], s1 = sp[mi][nj][2 * half + 1];
          const float2 st2 =
              make_float2(total_decay * s0 + z[mi][nj][2 * half],
                          total_decay * s1 + z[mi][nj][2 * half + 1]);
          if (c < nC - 1)
            *reinterpret_cast<float2*>(out + n * PW + p) = st2;
          else if (n < N && p0 + p < P)
            *reinterpret_cast<float2*>(fp + n * P + p) = st2;
          *reinterpret_cast<float2*>(sS + n * L::lds + p) =
              make_float2(s0, s1);
        }
    __syncthreads();  // the state before the chunk is in shared memory
    STAMP(8, global_ns());  // the chunk's state out
    // y += exp(cum) ⊙ (C state_prev), in TF32 pairs whatever T is
    if (live) {
      float cs[1][NJ][4] = {};
      gemm_3xtf32<1, NJ, true, NT>(cs, sC, L::ldbc, 16 * wr, sS, L::lds,
                                   wc * PW / 2, NT, NJ, lane);
      const float e0 = sE[16 * wr + g], e1 = sE[16 * wr + g + 8];
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          yacc[0][nj][v] += (v < 2 ? e0 : e1) * cs[0][nj][v];
    }
  }
  STAMP(9, global_ns());  // C state_prev

  // y rows of the chunk, columns of P
  T* yp = y + (((long long)b * S + c0) * H + h) * P + p0;
#pragma unroll
  for (int nj = 0; nj < NJ; ++nj) {
    const int p = wc * PW / 2 + 8 * nj + 2 * t;
    if (p0 + p >= P) continue;
    const int i = 16 * wr + g;
    if (i < rows)
      store2<T>(yp + (long long)i * H * P + p, yacc[0][nj][0],
                yacc[0][nj][1]);
    if (i + 8 < rows)
      store2<T>(yp + (long long)(i + 8) * H * P + p, yacc[0][nj][2],
                yacc[0][nj][3]);
  }
  STAMP(10, global_ns());  // y out

  // one fence publishes the chunk's state (written before the last
  // barrier) and counts the block out; the last block to count out leaves
  // the counters and flags at 0, every block's reads of flags being done
  if (nC == 1 || warp != 0) return;
  int last = 0;
  if (lane == 0) {
    __threadfence();
    if (c > 0 && c < nC - 1) store_release(flags + u, 2);
    last = atomicAdd(ctr + 1, 1) == total - 1;
    if (last) __threadfence();
  }
  STAMP(11, global_ns());  // published and counted out
  if (__shfl_sync(0xffffffffu, last, 0)) {
    for (int i = lane; i < total; i += 32) flags[i] = 0;
    if (lane == 0) {
      ctr[0] = 0;
      ctr[1] = 0;
    }
  }
}

template <typename T, int NT, int PW>
int launch_cfg(const void* x, const void* dt, const void* a_log,
               const void* bm, const void* cm, void* y, void* state,
               void* ws, void* ctr, int B, int S, int H, int P, int N,
               const Strides& st, int vec, int units, cudaStream_t stream) {
  constexpr int smem = Smem<T, NT, PW>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_kernel<T, NT, PW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mamba_scan_kernel<T, NT, PW><<<units, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<T*>(y),
      static_cast<float*>(state), static_cast<float*>(ws),
      static_cast<int*>(ctr), B, S, H, P, N, st, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* dt, const void* a_log, const void* bm,
           const void* cm, void* y, void* state, void* ws, void* ctr, int B,
           int S, int H, int P, int N, int pw, int vec, const long long* s,
           void* stream) {
  if (B * H == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  if (N <= 0 || N > 128 || P <= 0 || P % 4 || (pw != 32 && pw != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6]};
  const int units = ((S + kRows - 1) / kRows) * B * H * ((P + pw - 1) / pw);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
#define MAMBA_SCAN_LAUNCH(NT, PW)                                            \
  launch_cfg<T, NT, PW>(x, dt, a_log, bm, cm, y, state, ws, ctr, B, S, H, P, \
                        N, st, vec, units, cs)
  if (N <= 64)
    return pw == 64 ? MAMBA_SCAN_LAUNCH(64, 64) : MAMBA_SCAN_LAUNCH(64, 32);
  return pw == 64 ? MAMBA_SCAN_LAUNCH(128, 64) : MAMBA_SCAN_LAUNCH(128, 32);
#undef MAMBA_SCAN_LAUNCH
}

}  // namespace

// Shared memory of one block, for the wrapper's checks.
extern "C" int mamba_scan_smem(int bf16, int N, int pw) {
  if (bf16)
    return N <= 64 ? (pw == 64 ? Smem<__nv_bfloat16, 64, 64>::bytes
                               : Smem<__nv_bfloat16, 64, 32>::bytes)
                   : (pw == 64 ? Smem<__nv_bfloat16, 128, 64>::bytes
                               : Smem<__nv_bfloat16, 128, 32>::bytes);
  return N <= 64 ? (pw == 64 ? Smem<float, 64, 64>::bytes
                             : Smem<float, 64, 32>::bytes)
                 : (pw == 64 ? Smem<float, 128, 64>::bytes
                             : Smem<float, 128, 32>::bytes);
}

// x (B,S,H,P), bm/cm (B,S,N) in T with the last dimension contiguous and
// P a multiple of 4; vec: rows of x, B and C start on 16 bytes, so they are
// copied 16 bytes at a time; strides: x (b, s, h), bm (b, s), cm (b, s), in
// elements.  dt (B,S,H) and a_log (H,) are contiguous fp32; y (B,S,H,P) in
// T and the final state (B,H,N,P) in fp32 are contiguous.  pw: the columns
// of P a block takes (32 or 64).  ws: fp32 scratch of 2 * units * NT * pw +
// units floats, and ctr units + 2 ints, 0 before the first launch (every
// launch leaves them at 0); one chunk (S <= 64) reads neither.
extern "C" int mamba_scan_f32(const void* x, const void* dt,
                              const void* a_log, const void* bm,
                              const void* cm, void* y, void* state, void* ws,
                              void* ctr, int B, int S, int H, int P, int N,
                              int pw, int vec, const long long* strides,
                              void* stream) {
  return launch<float>(x, dt, a_log, bm, cm, y, state, ws, ctr, B, S, H, P,
                       N, pw, vec, strides, stream);
}

extern "C" int mamba_scan_bf16(const void* x, const void* dt,
                               const void* a_log, const void* bm,
                               const void* cm, void* y, void* state, void* ws,
                               void* ctr, int B, int S, int H, int P, int N,
                               int pw, int vec, const long long* strides,
                               void* stream) {
  return launch<__nv_bfloat16>(x, dt, a_log, bm, cm, y, state, ws, ctr, B, S,
                               H, P, N, pw, vec, strides, stream);
}
