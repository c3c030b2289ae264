// Flash attention forward: q (B,H,S,D) against k/v (B,Hkv,T,D), GQA by
// head divide, optional causal mask (top-left aligned, qpos >= kpos).
//
// Replaces repro/kernels/flash_attention.py::flash_attention_fwd
// (pl.pallas_call at :91), whose grid (B, H, nQ, nK) carries the online
// softmax state (m, l, acc) in VMEM across KV blocks in order.  Blocks on a
// GPU run in no order, so here the KV axis is a loop inside one thread block:
// one block per (q tile of 64 rows, head, batch row) walks the 64-key tiles
// of its KV head (h / group, no KV repeat) through shared memory, with m, l
// and acc in fp32 registers.  Whole tiles above the diagonal are skipped;
// ragged tiles (S or T not a multiple of 64) are masked inside the kernel.
//
// Bound on Hopper: operations.  At the prefill shapes (S = T = 512, D = 128)
// the function does ~2*S*T*D flops per head (half that when causal) against
// O((S+T)*D) bytes, over 100 flop per byte.  The math is IEEE fp32 on CUDA
// cores (67 TFLOP/s peak), which matches the reference's fp32 upcast to
// 2e-5; each thread computes a 4x4 tile of scores and a 4x8 tile of the
// output from shared memory (Q and K rows padded by one word against bank
// conflicts).  Tensor cores (wgmma, TMA) would be the next step, at a cost
// in precision for fp32 inputs.
#include "common.cuh"

namespace {

constexpr int BQ = 64, BK = 64, kThreads = 256, kMaxD = 128;

struct Strides {
  long long qb, qh, qs, kb, kh, kt, vb, vh, vt, ob, oh, os;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int H,
                  int group, int S, int T_, int D, int Dv, Strides st,
                  float scale, int causal) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* sQ = smem;              // BQ x DP
  float* sK = sQ + BQ * DP;      // BK x DP
  float* sV = sK + BK * DP;      // BK x Dv
  float* sP = sV + BK * Dv;      // BQ x BK

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + hk * st.kh;
  const T* vp = v + b * st.vb + hk * st.vh;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    sQ[r * DP + c] = q0 + r < S ? to_f32(qp[(q0 + r) * st.qs + c]) : 0.f;
  }

  float m[4], l[4], acc[4][kMaxD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxD / 16; ++j) acc[i][j] = 0.f;
  }

  // Top-left causal alignment: keys past the tile's last row never count.
  const int kend = causal ? min(T_, q0 + BQ) : T_;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's sK, sV and sP are consumed
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      sK[r * DP + c] = k0 + r < T_ ? to_f32(kp[(k0 + r) * st.kt + c]) : 0.f;
    }
    for (int i = tid; i < BK * Dv; i += kThreads) {
      const int r = i / Dv, c = i - r * Dv;
      sV[r * Dv + c] = k0 + r < T_ ? to_f32(vp[(k0 + r) * st.vt + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool ok[4];
      float mt = NEG_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        ok[j] = kj < T_ && (!causal || qi >= kj);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF_F;
        mt = fmaxf(mt, s[i][j]);
      }
      // the 16 threads of a row are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty + 16 * i) * BK + tx + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kMaxD / 16; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * BK + kk];
#pragma unroll
      for (int j = 0; j < kMaxD / 16; ++j) {
        const int c = tx + 16 * j;
        if (c < Dv) {
          const float vv = sV[kk * Dv + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * vv;
        }
      }
    }
  }

  T* op = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kMaxD / 16; ++j) {
      const int c = tx + 16 * j;
      if (c < Dv) op[qi * st.os + c] = from_f32<T>(acc[i][j] / den);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int S, int T_, int D, int Dv, const long long* s,
           float scale, int causal, void* stream) {
  if (D > kMaxD || Dv > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  if (B * H * S == 0) return static_cast<int>(cudaGetLastError());
  const Strides st{s[0], s[1], s[2], s[3], s[4],  s[5],
                   s[6], s[7], s[8], s[9], s[10], s[11]};
  const size_t smem =
      sizeof(float) * (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * Dv + BQ * BK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attn_kernel<T><<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / Hkv, S, T_, D, Dv,
      st, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: q (b, h, s), k (b, h, t), v (b, h, t), o (b, h, s), in elements;
// the head dimension is contiguous in every tensor.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int Hkv, int S, int T_, int D, int Dv,
                                   const long long* strides, float scale,
                                   int causal, void* stream) {
  return launch<float>(q, k, v, o, B, H, Hkv, S, T_, D, Dv, strides, scale,
                       causal, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int H,
                                    int Hkv, int S, int T_, int D, int Dv,
                                    const long long* strides, float scale,
                                    int causal, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, H, Hkv, S, T_, D, Dv, strides,
                               scale, causal, stream);
}
