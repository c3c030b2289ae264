// sLSTM recurrence over a whole sequence: per (batch row, head) and step t
//
//   g   = xg_t + h_{t-1} R + bias      (gates z, i, f, o; R is Dh x Dh a
//                                       gate, block-diagonal by head)
//   f~  = logsigmoid(g_f)
//   m_t = max(f~ + m_{t-1}, g_i)
//   c_t = exp(f~ + m_{t-1} - m_t) c_{t-1} + exp(g_i - m_t) tanh(g_z)
//   n_t = exp(f~ + m_{t-1} - m_t) n_{t-1} + exp(g_i - m_t)
//   h_t = sigmoid(g_o) c_t / max(n_t, 1)
//
// Replaces repro/kernels/slstm_cell.py::slstm_seq (pl.pallas_call at :74),
// whose grid (B, nSeqChunks) keeps (c, n, h, m) in VMEM across an ordered
// sequence axis and holds the whole recurrent matrix R (4, H, Dh, Dh) in
// VMEM.  At xlstm_125m's widths (H = 4, Dh = 192) R is 576 KB a head in
// fp32: more than one SM holds, in shared memory or in registers.
//
// Bound on Hopper: at the xlstm_125m prefill (B = 1, S = 512) the function
// does 0.6 GFLOP and moves ~10 MB, a bound of ~9 us; but its S steps are
// dependent, so a launch is S times the latency of one step.  A step is a
// Dh-long product per gate and column, an update and an exchange of h_t:
// what bounds it is the chain product -> update -> exchange -> barrier.
//
// So a thread block cluster of K blocks serves one head and a group of up
// to kMaxRows batch rows (the grid is (K, H, groups)).  Dh's 4-column
// groups are dealt to the K blocks; block k owns its columns of all four
// gates, and:
//
//   * loads its slice of R once a launch into registers, every load in
//     flight at once: warp w owns the block's columns 4w to 4w + 3, and its
//     lane (cc, s) holds R[g, head, d, col] of all four gates g of column
//     4w + cc for d = 4 (s + 8 j) + q, 96 values at Dh = 192;
//   * keeps c, n, m and h of its columns in registers for the whole
//     sequence: lane (cc, r) owns row r of column 4w + cc (with one row the
//     column's other lanes compute the same);
//   * each step reads h_{t-1}, all Dh of it for every row, from its own
//     shared buffer t & 1 (a float4 a load), sums its products in IEEE fp32
//     FMAs, reduces a column's 8 partial sums of each gate by warp shuffles
//     into every lane of the column, adds xg (loaded kAhead steps ahead)
//     and the bias, applies the gates' activations and the exp-gated,
//     max-stabilised update, writes h_t to the output, gathers a row of the
//     warp's 4 columns into one float4 and stores it into buffer (t + 1) & 1
//     of every block of the cluster through distributed shared memory
//     (lanes k < K store to block k); then one cluster barrier.  One is
//     enough: a block stores into buffer (t + 1) & 1 at step t only after
//     the barrier of step t - 1, which every peer arrives at only after it
//     has read that buffer (as h_{t-2}) at step t - 1.  The last step
//     exchanges nothing.
//
// Four columns a warp, not one: a step's scalar tail (the reductions, the
// activations, the update) is issued once a warp, and with a warp a column
// (24 warps an SM) its issue bounded the step.
//
// A cluster serves its rows with one copy of R: a decode tick of 4 slots
// reads each head's R once.  At one prompt (B = 1, H = 4) 64 SMs work, in
// clusters of 16 wherever Dh has 16 4-column groups (8, the portable size,
// measured slower: the step's product and update shrink with a block's
// columns more than its exchange grows).
// The grid depends on (B, H, Dh) only, nothing is allocated and nothing
// waits for the host, so a CUDA graph replays the launch.  The plan (K and
// the rows a cluster serves) comes from the wrapper
// (slstm_cell.cluster_plan); the launcher checks it and sizes the blocks
// and their shared memory from it.
#include "common.cuh"
#include "hopper.cuh"

// Phase stamps, for repro_torch/launch/slstm_phases.py only: built with
// -DSLSTM_SEQ_STAMPS, thread 0 of each block writes %globaltimer (ns) at
// each step's marks into slstm_seq_stamps[block][step]; the default build
// has none of it.
#ifdef SLSTM_SEQ_STAMPS
constexpr int kStampBlocks = 64, kStampSteps = 512, kStamps = 5;
// [block][step]: the step's start, h_{t-1} in, gates summed, the update
// done, h_t sent; [block][kStampSteps][0]: the block's start
__device__ unsigned long long
    slstm_seq_stamps[kStampBlocks][kStampSteps + 1][kStamps];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(t, k)                                                    \
  do {                                                                 \
    if (threadIdx.x == 0 && blk < kStampBlocks && (t) < kStampSteps) \
      slstm_seq_stamps[blk][t][k] = global_ns();                       \
  } while (0)
// Copies the stamps to ``host`` and sets them to 0 for the next launch.
extern "C" int slstm_seq_read_stamps(void* host) {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, slstm_seq_stamps);
  if (e == cudaSuccess)
    e = cudaMemcpy(host, p, sizeof(slstm_seq_stamps),
                   cudaMemcpyDeviceToHost);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(slstm_seq_stamps));
  return static_cast<int>(e);
}
__global__ void empty_kernel() {}
// One launch of a kernel that does nothing: the floor of any launch.
extern "C" int slstm_seq_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
#else
#define STAMP(t, k) \
  do {              \
  } while (0)
#endif

namespace {

constexpr int kMaxDh = 256;
constexpr int kMaxCluster = 16;   // non-portable above 8
constexpr int kMaxRows = 4;       // batch rows a cluster serves
constexpr int kMaxThreads = 256;  // 8 a column: at most 32 columns a block
constexpr int kAhead = 4;         // steps of xg in flight

// Columns of the widest block when Dh's 4-column groups are dealt to K.
inline int max_cols(int Dh, int K) {
  return 4 * ((Dh / 4 + K - 1) / K);
}
// The h row in shared memory, zero past Dh: the 8 splits' float4 loads
// reach 32 J4 values, J4 = 2, 6 or 8 (the kernel's template argument).
inline int span_of(int Dh) {
  return Dh <= 64 ? 64 : Dh <= 192 ? 192 : 256;
}
// Row slots of the h buffers (the kernel's NB): 1, or kMaxRows.
inline int row_slots(int nb) {
  return nb <= 1 ? 1 : kMaxRows;
}

// Warp w owns the block's columns 4w to 4w + 3; its lane (cc, ks) = (lane
// / 8, lane % 8) sums the four gates of column 4w + cc over d = 4 (ks + 8
// j) + q for j < J4, q < 4 (16 J4 values of R; h read as float4): J4 = 2, 6
// or 8 (Dh up to 64, 192, 256).  NB: row slots, 1 or kMaxRows.
template <typename T, int J4, int NB>
__global__ void __launch_bounds__(kMaxThreads)
slstm_seq_kernel(const T* __restrict__ xg, const float* __restrict__ r,
                 const float* __restrict__ bias,
                 const float* __restrict__ c0, const float* __restrict__ n0,
                 const float* __restrict__ h0, const float* __restrict__ m0,
                 T* __restrict__ out, float* __restrict__ c_out,
                 float* __restrict__ n_out, float* __restrict__ h_out,
                 float* __restrict__ m_out, int B, int S, int H, int Dh,
                 int nb) {
  constexpr int kSpan = 32 * J4;
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ __align__(16) float hb[];  // [2][NB][kSpan]

  const int K = gridDim.x, rank = hopper::cluster_rank(), head = blockIdx.y;
  const int b0 = blockIdx.z * nb;
#ifdef SLSTM_SEQ_STAMPS
  const int blk = rank + K * (head + H * blockIdx.z);
  if (threadIdx.x == 0 && blk < kStampBlocks)
    slstm_seq_stamps[blk][kStampSteps][0] = global_ns();
#endif
  const int n4 = Dh / 4, base = n4 / K, extra = n4 % K;
  const int col0 = 4 * (rank * base + min(rank, extra));
  const int cw = 4 * (base + (rank < extra ? 1 : 0));  // this block's columns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cc = lane >> 3, ks = lane & 7;
  const bool live = 4 * warp < cw;  // warp-uniform: it owns 4 columns
  const int col = col0 + 4 * warp + cc;  // the lane's column
  const size_t gstride = static_cast<size_t>(H) * Dh;  // a gate of xg
  // row r of this cluster is batch row b0 + r, if there is one
  auto row_ok = [&](int rr) { return rr < nb && b0 + rr < B; };

  // both h buffers: h_{-1} in buffer 0, zeros elsewhere and past Dh
  for (int i = threadIdx.x; i < 2 * NB * kSpan; i += blockDim.x) {
    const int rr = (i / kSpan) % NB, d = i % kSpan;
    float v = 0.f;
    if (i < NB * kSpan && h0 != nullptr && d < Dh && row_ok(rr))
      v = h0[(static_cast<size_t>(b0 + rr) * H + head) * Dh + d];
    hb[i] = v;
  }
  // w[gate][j][q] = R[gate, head, 4 (ks + 8 j) + q, col], 0 past Dh: all
  // of them in flight at once (a warp reads 16 bytes of 8 rows a load)
  float w[4][J4][4];
#pragma unroll
  for (int gg = 0; gg < 4; ++gg)
#pragma unroll
    for (int j = 0; j < J4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int d = 4 * (ks + 8 * j) + q;
        w[gg][j][q] =
            live && d < Dh
                ? __ldg(r + ((static_cast<size_t>(gg) * H + head) * Dh + d) *
                                Dh +
                        col)
                : 0.f;
      }
  __syncthreads();  // h_{-1} is in
  float bg[4];
#pragma unroll
  for (int gg = 0; gg < 4; ++gg)
    bg[gg] = live ? bias[(static_cast<size_t>(gg) * H + head) * Dh + col]
                  : 0.f;
  // lane (cc, r) owns the state of row r in its column; with one slot the
  // other lanes of the column compute the same, with four lanes r and
  // r + 4 do
  const int row = ks & (NB - 1);
  const bool owner = live && ks < NB;
  const size_t so = (static_cast<size_t>(b0 + row) * H + head) * Dh + col;
  float c = 0.f, n = 0.f, m = 0.f, hv = 0.f;
  if (live && c0 != nullptr && row_ok(row)) {
    c = c0[so];
    n = n0[so];
    hv = h0[so];
    m = m0[so];
  }
  // every lane loads xg of its row and column, kAhead steps ahead
  const bool loader = live && row_ok(row);
  const size_t tstride = 4 * gstride;
  const T* xp = xg + static_cast<size_t>(b0 + row) * S * tstride +
                static_cast<size_t>(head) * Dh + col;
  float xs[kAhead][4];
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
#pragma unroll
    for (int gg = 0; gg < 4; ++gg)
      xs[u][gg] = loader && u < S
                      ? to_f32(xp[u * tstride + gg * gstride])
                      : 0.f;
  // lanes k < K store h_t into block k's buffers
  const uint32_t hb_peer =
      hopper::map_rank(hopper::smem_u32(hb), lane < K ? lane : 0);
  if (S > 1) hopper::cluster_arrive();  // pairs with the wait at step 0

  for (int t0 = 0; t0 < S; t0 += kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int t = t0 + u;
      if (t >= S) break;
      STAMP(t, 0);
      if (t > 0) hopper::cluster_wait();  // every block's h_{t-1} is in
      STAMP(t, 1);
      float x[4];
#pragma unroll
      for (int gg = 0; gg < 4; ++gg) {
        x[gg] = xs[u][gg];
        if (loader && t + kAhead < S)
          xs[u][gg] = to_f32(xp[(t + kAhead) * tstride + gg * gstride]);
      }
      if (live) {
        const float* hp = hb + (t & 1) * NB * kSpan;
        float acc[4][NB];
#pragma unroll
        for (int gg = 0; gg < 4; ++gg)
#pragma unroll
          for (int rr = 0; rr < NB; ++rr) acc[gg][rr] = 0.f;
#pragma unroll
        for (int j = 0; j < J4; ++j)
#pragma unroll
          for (int rr = 0; rr < NB; ++rr) {
            const float4 h4 = *reinterpret_cast<const float4*>(
                hp + rr * kSpan + 4 * (ks + 8 * j));
#pragma unroll
            for (int gg = 0; gg < 4; ++gg) {
              acc[gg][rr] = fmaf(h4.x, w[gg][j][0], acc[gg][rr]);
              acc[gg][rr] = fmaf(h4.y, w[gg][j][1], acc[gg][rr]);
              acc[gg][rr] = fmaf(h4.z, w[gg][j][2], acc[gg][rr]);
              acc[gg][rr] = fmaf(h4.w, w[gg][j][3], acc[gg][rr]);
            }
          }
        // the column's 8 partial sums of every gate and row, in every lane
#pragma unroll
        for (int gg = 0; gg < 4; ++gg)
#pragma unroll
          for (int rr = 0; rr < NB; ++rr)
#pragma unroll
            for (int o = 1; o < 8; o <<= 1)
              acc[gg][rr] += __shfl_xor_sync(kAll, acc[gg][rr], o);
        float pre[4];
#pragma unroll
        for (int gg = 0; gg < 4; ++gg) {
          pre[gg] = acc[gg][0];
#pragma unroll
          for (int rr = 1; rr < NB; ++rr)
            if (row == rr) pre[gg] = acc[gg][rr];
          pre[gg] += x[gg] + bg[gg];
        }
        STAMP(t, 2);
        const float zt = tanhf(pre[0]);
        const float ft = fminf(pre[2], 0.f) - log1pf(expf(-fabsf(pre[2])));
        const float ot = 1.f / (1.f + expf(-pre[3]));
        const float m_new = fmaxf(ft + m, pre[1]);
        const float i_ = expf(pre[1] - m_new);
        const float f_ = expf(ft + m - m_new);
        c = f_ * c + i_ * zt;
        n = f_ * n + i_;
        hv = ot * c / fmaxf(n, 1.f);
        m = m_new;
        if (owner && row_ok(row))
          out[(static_cast<size_t>(b0 + row) * S + t) * gstride +
              static_cast<size_t>(head) * Dh + col] = from_f32<T>(hv);
      }
      STAMP(t, 3);
      if (t + 1 < S) {
        if (t == 0) hopper::cluster_wait();  // every block has started
        if (live) {
          const uint32_t dst =
              hb_peer + 4 * (((t + 1) & 1) * NB * kSpan + col0 + 4 * warp);
#pragma unroll
          for (int rr = 0; rr < NB; ++rr) {
            // row rr of the warp's 4 columns, from their owner lanes
            const float4 v = make_float4(__shfl_sync(kAll, hv, rr),
                                         __shfl_sync(kAll, hv, 8 + rr),
                                         __shfl_sync(kAll, hv, 16 + rr),
                                         __shfl_sync(kAll, hv, 24 + rr));
            if (lane < K) hopper::st_cluster(dst + 4 * rr * kSpan, v);
          }
        }
        hopper::cluster_arrive();
      }
      STAMP(t, 4);
    }
  }
  if (owner && row_ok(row)) {
    c_out[so] = c;
    n_out[so] = n;
    h_out[so] = hv;
    m_out[so] = m;
  }
}

struct Args {
  const void *xg, *r, *bias, *c0, *n0, *h0, *m0;
  void *out, *c, *n, *h, *m;
  int B, S, H, Dh;
};

template <typename T, int J4, int NB>
int run(const Args& a, int K, int nb, cudaStream_t stream) {
  auto kern = slstm_seq_kernel<T, J4, NB>;
  constexpr size_t smem = sizeof(float) * 2 * NB * 32 * J4;  // h_{t-1}, h_t
  if (K > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K, a.H, (a.B + nb - 1) / nb);
  cfg.blockDim = dim3(8 * max_cols(a.Dh, K));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(a.xg),
      static_cast<const float*>(a.r), static_cast<const float*>(a.bias),
      static_cast<const float*>(a.c0), static_cast<const float*>(a.n0),
      static_cast<const float*>(a.h0), static_cast<const float*>(a.m0),
      static_cast<T*>(a.out), static_cast<float*>(a.c),
      static_cast<float*>(a.n), static_cast<float*>(a.h),
      static_cast<float*>(a.m), a.B, a.S, a.H, a.Dh, nb);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int J4>
int run_rows(const Args& a, int K, int nb, cudaStream_t s) {
  return row_slots(nb) == 1 ? run<T, J4, 1>(a, K, nb, s)
                            : run<T, J4, kMaxRows>(a, K, nb, s);
}

template <typename T>
int launch(const Args& a, int K, int nb, void* stream) {
  if (a.Dh < 4 || a.Dh > kMaxDh || a.Dh % 4 != 0 || a.S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.B * a.H == 0) return static_cast<int>(cudaGetLastError());
  // the plan: K blocks of at most 32 columns, 1-4 rows
  if (K < 1 || K > kMaxCluster || K > a.Dh / 4 || nb < 1 || nb > kMaxRows ||
      8 * max_cols(a.Dh, K) > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (span_of(a.Dh)) {
    case 64:
      return run_rows<T, 2>(a, K, nb, s);
    case 192:
      return run_rows<T, 6>(a, K, nb, s);
    default:
      return run_rows<T, 8>(a, K, nb, s);
  }
}

}  // namespace

// xg (B,S,4,H,Dh) in T and out (B,S,H,Dh) in T, contiguous; r (4,H,Dh,Dh)
// and bias (4,H,Dh) contiguous fp32, r 16-byte aligned; the initial state
// c0, n0, h0, m0 (B,H,Dh) contiguous fp32, all four null for zeros; the
// final state c, n, h, m (B,H,Dh) contiguous fp32.  Dh a multiple of 4 up
// to 256, S >= 1.  The plan: a cluster of K blocks, nb batch rows a
// cluster.
extern "C" int slstm_seq_f32(const void* xg, const void* r, const void* bias,
                             const void* c0, const void* n0, const void* h0,
                             const void* m0, void* out, void* c, void* n,
                             void* h, void* m, int B, int S, int H, int Dh,
                             int K, int nb, void* stream) {
  return launch<float>({xg, r, bias, c0, n0, h0, m0, out, c, n, h, m, B, S,
                        H, Dh},
                       K, nb, stream);
}

extern "C" int slstm_seq_bf16(const void* xg, const void* r, const void* bias,
                              const void* c0, const void* n0, const void* h0,
                              const void* m0, void* out, void* c, void* n,
                              void* h, void* m, int B, int S, int H, int Dh,
                              int K, int nb, void* stream) {
  return launch<__nv_bfloat16>({xg, r, bias, c0, n0, h0, m0, out, c, n, h, m,
                                B, S, H, Dh},
                               K, nb, stream);
}
