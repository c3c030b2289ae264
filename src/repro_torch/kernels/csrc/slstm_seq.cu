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
// VMEM.  At xlstm_125m's widths (H = 4, Dh = 192) R is 2.36 MB in fp32,
// 576 KB a head: over the 227 KB of shared memory a Hopper block can have,
// and over an SM's registers too.  So here one block per (b, head) walks
// the steps in order with the state in registers and h_{t-1} in shared
// memory, and streams its head's R from the L2 cache (where all of R stays
// resident) at every step:
//
//   * 4 Dh threads: thread (gate g, column group cg, split ks) reads R[g,
//     head, d, 4cg:4cg+4] as one 16-byte load for d in its quarter of the
//     rows (neighbouring threads on neighbouring columns) and sums
//     h_{t-1}[d] times it with IEEE fp32 FMAs into four partial sums;
//   * a barrier; then thread e < Dh adds its four quarters for each gate,
//     applies the exp-gated, max-stabilised update in fp32 registers (its
//     c, n, m and h never leave them) and writes h_t to shared memory and
//     to the output; a barrier, and the next step.
//
// Unlike the TPU kernel it starts from an optional state (c, n, h, m) and
// writes the final one, so the prefill's decode cache comes from the same
// launch and a decode tick is a launch at S = 1; and it takes any S >= 1.
//
// Bound on Hopper: at the xlstm_125m prefill (B = 1, S = 512) the function
// does 0.6 GFLOP and moves ~10 MB, a bound of ~9 us, but its S steps are
// dependent: each streams 576 KB of R through one SM from L2, so a step
// takes microseconds and the launch milliseconds, with only B * H blocks
// (4 at one prompt) busy.  The redesign (ROADMAP) splits R across a thread
// block cluster per head, held in shared memory, and exchanges h through
// distributed shared memory.
#include "common.cuh"

namespace {

constexpr int kMaxDh = 256;    // 4 Dh threads a block, at most 1024
constexpr int kSplit = 4;      // each Dh-long dot product in kSplit parts

template <typename T>
__global__ void __launch_bounds__(4 * kMaxDh)
slstm_seq_kernel(const T* __restrict__ xg, const float* __restrict__ r,
                 const float* __restrict__ bias,
                 const float* __restrict__ c0, const float* __restrict__ n0,
                 const float* __restrict__ h0, const float* __restrict__ m0,
                 T* __restrict__ out, float* __restrict__ c_out,
                 float* __restrict__ n_out, float* __restrict__ h_out,
                 float* __restrict__ m_out, int S, int H, int Dh) {
  __shared__ float sH[kMaxDh];                      // h_{t-1}
  __shared__ float4 sPart[kSplit * 4 * kMaxDh / 4];  // [ks][gate][Dh]

  const int b = blockIdx.x / H, head = blockIdx.x - b * H;
  const int tid = threadIdx.x;
  const int ncg = Dh / 4, dlen = Dh / kSplit;
  // the recurrent product's share of this thread
  const int cg = tid % ncg, gk = tid / ncg;
  const int g = gk / kSplit, ks = gk - g * kSplit;
  const float* sHk = sH + ks * dlen;
  const float4* rp = reinterpret_cast<const float4*>(
                         r + ((size_t)(g * H + head) * Dh + ks * dlen) * Dh) +
                     cg;
  float4* part = sPart + (ks * 4 + g) * ncg + cg;

  // the update's column: thread e < Dh owns c, n, m and h of column e
  const int e = tid;
  const bool owner = e < Dh;
  const size_t so = (size_t)blockIdx.x * Dh + e;   // (B, H, Dh) state
  const size_t gstride = (size_t)H * Dh;           // gate stride of xg
  const T* xp = xg + (size_t)b * S * 4 * gstride + (size_t)head * Dh + e;
  T* op = out + (size_t)b * S * gstride + (size_t)head * Dh + e;
  const float* sP = reinterpret_cast<const float*>(sPart) + e;
  float c = 0.f, n = 0.f, m = 0.f, hv = 0.f;
  float bz = 0.f, bi = 0.f, bf = 0.f, bo = 0.f;
  if (owner) {
    if (c0 != nullptr) {
      c = c0[so];
      n = n0[so];
      hv = h0[so];
      m = m0[so];
    }
    const float* bp = bias + (size_t)head * Dh + e;
    bz = bp[0];
    bi = bp[gstride];
    bf = bp[2 * gstride];
    bo = bp[3 * gstride];
    sH[e] = hv;
  }
  __syncthreads();

  for (int t = 0; t < S; ++t) {
    // the step's input gates, in flight during the recurrent product
    float xz = 0.f, xi = 0.f, xf = 0.f, xo = 0.f;
    if (owner) {
      const T* xt = xp + (size_t)t * 4 * gstride;
      xz = to_f32(xt[0]);
      xi = to_f32(xt[gstride]);
      xf = to_f32(xt[2 * gstride]);
      xo = to_f32(xt[3 * gstride]);
    }
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int d = 0; d < dlen; ++d) {
      const float hd = sHk[d];
      const float4 w = __ldg(rp + (size_t)d * ncg);
      acc.x = fmaf(hd, w.x, acc.x);
      acc.y = fmaf(hd, w.y, acc.y);
      acc.z = fmaf(hd, w.z, acc.z);
      acc.w = fmaf(hd, w.w, acc.w);
    }
    *part = acc;
    __syncthreads();   // every partial sum is in; h_{t-1} is read
    if (owner) {
      float rec[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        rec[q] = sP[q * Dh];
#pragma unroll
        for (int k = 1; k < kSplit; ++k) rec[q] += sP[(k * 4 + q) * Dh];
      }
      const float gz = xz + rec[0] + bz, gi = xi + rec[1] + bi;
      const float gf = xf + rec[2] + bf, go = xo + rec[3] + bo;
      const float zt = tanhf(gz);
      const float ft = fminf(gf, 0.f) - log1pf(expf(-fabsf(gf)));
      const float ot = 1.f / (1.f + expf(-go));
      const float m_new = fmaxf(ft + m, gi);
      const float i_ = expf(gi - m_new);
      const float f_ = expf(ft + m - m_new);
      c = f_ * c + i_ * zt;
      n = f_ * n + i_;
      hv = ot * c / fmaxf(n, 1.f);
      m = m_new;
      sH[e] = hv;
      op[(size_t)t * gstride] = from_f32<T>(hv);
    }
    __syncthreads();   // h_t is in; the partial sums are consumed
  }
  if (owner) {
    c_out[so] = c;
    n_out[so] = n;
    h_out[so] = hv;
    m_out[so] = m;
  }
}

template <typename T>
int launch(const void* xg, const void* r, const void* bias, const void* c0,
           const void* n0, const void* h0, const void* m0, void* out,
           void* c, void* n, void* h, void* m, int B, int S, int H, int Dh,
           void* stream) {
  if (Dh < 4 || Dh > kMaxDh || Dh % 4 != 0 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B * H == 0) return static_cast<int>(cudaGetLastError());
  slstm_seq_kernel<T><<<B * H, 4 * Dh, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xg), static_cast<const float*>(r),
      static_cast<const float*>(bias), static_cast<const float*>(c0),
      static_cast<const float*>(n0), static_cast<const float*>(h0),
      static_cast<const float*>(m0), static_cast<T*>(out),
      static_cast<float*>(c), static_cast<float*>(n), static_cast<float*>(h),
      static_cast<float*>(m), S, H, Dh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xg (B,S,4,H,Dh) in T and out (B,S,H,Dh) in T, contiguous; r (4,H,Dh,Dh)
// and bias (4,H,Dh) contiguous fp32, r 16-byte aligned; the initial state
// c0, n0, h0, m0 (B,H,Dh) contiguous fp32, all four null for zeros; the
// final state c, n, h, m (B,H,Dh) contiguous fp32.  Dh a multiple of 4 up
// to 256, S >= 1.
extern "C" int slstm_seq_f32(const void* xg, const void* r, const void* bias,
                             const void* c0, const void* n0, const void* h0,
                             const void* m0, void* out, void* c, void* n,
                             void* h, void* m, int B, int S, int H, int Dh,
                             void* stream) {
  return launch<float>(xg, r, bias, c0, n0, h0, m0, out, c, n, h, m, B, S, H,
                       Dh, stream);
}

extern "C" int slstm_seq_bf16(const void* xg, const void* r, const void* bias,
                              const void* c0, const void* n0, const void* h0,
                              const void* m0, void* out, void* c, void* n,
                              void* h, void* m, int B, int S, int H, int Dh,
                              void* stream) {
  return launch<__nv_bfloat16>(xg, r, bias, c0, n0, h0, m0, out, c, n, h, m,
                               B, S, H, Dh, stream);
}
