// Chunked Mamba2 SSD forward: y and the final state of
//   h_t = exp(dt_t * a) h_{t-1} + dt_t * B_t x_t,   y_t = C_t h_t
// per (batch row, head), with B and C shared by all heads (G = 1).
//
// Replaces repro/kernels/mamba_scan.py::mamba_scan (pl.pallas_call at :78),
// whose grid (B, H, nChunks) carries the (N, P) state in VMEM across an
// ordered chunk axis.  Blocks on a GPU run in no order, so here the chunk
// walk is a loop inside one thread block: one block per (b, h) holds the
// state in shared memory from the first chunk to the last, and per chunk of
// L rows computes, all in fp32 (the TPU kernel upcasts every operand too):
//
//   G     = (C Bᵀ) ⊙ exp(cum_i - cum_j) ⊙ dt_j, j <= i    (L x L, masked)
//   y     = G X + exp(cum) ⊙ (C state)
//   state = exp(cum_L) state + (B ⊙ dt exp(cum_L - cum))ᵀ X
//
// Unlike the TPU kernel it also writes the carried state after the last
// chunk, (B, H, N, P) in fp32: that is the prefill's decode-cache entry.
//
// Bound on Hopper: operations.  At the zamba2 prefill shape (S = 512,
// H = 112, N = P = 64, L = 64) the function does ~1.2 GFLOP (the causal
// triangle) against ~32 MB of inputs and outputs.  The math is IEEE fp32
// on CUDA cores, as in the reference; each thread computes 4 x 4 tiles of
// G, y and the state out of shared memory (rows of B, C and G padded by
// one word against bank conflicts).  L may be any length (the last chunk of a short prompt is the
// whole prompt); rows and columns past L, N or P are masked inside the
// kernel.  The shared memory holds X, B, C, the state and G in fp32, sized
// from L, N and P at launch (81.5 KB at L = N = P = 64); the wrapper refuses
// shapes over the 227 KB a block can have.  Known weakness: the grid is
// only B*H blocks (112 at one zamba2 prompt against 132 SMs), and C Bᵀ is
// recomputed by every head; splitting heads or chunks across blocks and
// tensor cores are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kTile = 64;      // 4 x 4 outputs per thread

struct Strides {
  long long xb, xs, xh, bb, bs, cb, cs;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a, const T* __restrict__ bm,
                  const T* __restrict__ cm, T* __restrict__ y,
                  float* __restrict__ state_out, int S, int H, int P, int N,
                  int L, Strides st) {
  extern __shared__ float smem[];
  const int NP = N + 1, LP = L + 1;
  float* sX = smem;           // L x P
  float* sB = sX + L * P;     // L x NP
  float* sC = sB + L * NP;    // L x NP
  float* sS = sC + L * NP;    // N x P, the carried state
  float* sG = sS + N * P;     // L x LP
  float* sCum = sG + L * LP;  // L: inclusive cumsum of dt * a
  float* sDt = sCum + L;      // L
  float* sW = sDt + L;        // L: dt * exp(cum_L - cum)

  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float av = a[h];
  const T* xp = x + b * st.xb + h * st.xh;
  const T* bp = bm + b * st.bb;
  const T* cp = cm + b * st.cb;
  const float* dtp = dt + (long long)b * S * H + h;       // (B,S,H)
  T* yp = y + ((long long)b * S * H + h) * P;              // (B,S,H,P)

  for (int i = tid; i < N * P; i += kThreads) sS[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += L) {
    __syncthreads();  // the previous chunk's tiles and state are consumed
    for (int i = tid; i < L * P; i += kThreads) {
      const int r = i / P, c = i - r * P;
      sX[i] = to_f32(xp[(c0 + r) * st.xs + c]);
    }
    for (int i = tid; i < L * N; i += kThreads) {
      const int r = i / N, c = i - r * N;
      sB[r * NP + c] = to_f32(bp[(c0 + r) * st.bs + c]);
      sC[r * NP + c] = to_f32(cp[(c0 + r) * st.cs + c]);
    }
    for (int i = tid; i < L; i += kThreads)
      sDt[i] = dtp[(long long)(c0 + i) * H];
    __syncthreads();
    // the sum in the order of a sequential cumsum
    for (int i = tid; i < L; i += kThreads) {
      float cum = 0.f;
      for (int r = 0; r <= i; ++r) cum += sDt[r] * av;
      sCum[i] = cum;
    }
    __syncthreads();
    const float cum_last = sCum[L - 1];
    for (int i = tid; i < L; i += kThreads)
      sW[i] = sDt[i] * expf(cum_last - sCum[i]);

    // G: the tiles on and below the diagonal
    for (int r0 = 0; r0 < L; r0 += kTile) {
      for (int k0 = 0; k0 <= r0; k0 += kTile) {
        float acc[4][4] = {};
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = r0 + ty + 16 * i;
            cv[i] = r < L ? sC[r * NP + n] : 0.f;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = k0 + tx + 16 * j;
            bv[j] = k < L ? sB[k * NP + n] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += cv[i] * bv[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = k0 + tx + 16 * j;
            if (r < L && k < L)
              sG[r * LP + k] =
                  k <= r ? acc[i][j] * expf(sCum[r] - sCum[k]) * sDt[k] : 0.f;
          }
        }
      }
    }
    __syncthreads();

    // y = G X + exp(cum) (C state), with the state of the chunks before
    for (int r0 = 0; r0 < L; r0 += kTile) {
      const int jend = min(L, r0 + kTile);
      for (int p0 = 0; p0 < P; p0 += kTile) {
        float intra[4][4] = {}, inter[4][4] = {};
        for (int j = 0; j < jend; ++j) {
          float gv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = r0 + ty + 16 * i;
            gv[i] = r < L ? sG[r * LP + j] : 0.f;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int p = p0 + tx + 16 * q;
            xv[q] = p < P ? sX[j * P + p] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) intra[i][q] += gv[i] * xv[q];
        }
        for (int n = 0; n < N; ++n) {
          float cv[4], sv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = r0 + ty + 16 * i;
            cv[i] = r < L ? sC[r * NP + n] : 0.f;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int p = p0 + tx + 16 * q;
            sv[q] = p < P ? sS[n * P + p] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) inter[i][q] += cv[i] * sv[q];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + ty + 16 * i;
          if (r >= L) continue;
          const float e = expf(sCum[r]);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int p = p0 + tx + 16 * q;
            if (p < P)
              yp[(long long)(c0 + r) * H * P + p] =
                  from_f32<T>(intra[i][q] + e * inter[i][q]);
          }
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // state <- exp(cum_L) state + (B ⊙ w)ᵀ X; each thread owns its entries
    const float total = expf(cum_last);
    for (int n0 = 0; n0 < N; n0 += kTile) {
      for (int p0 = 0; p0 < P; p0 += kTile) {
        float acc[4][4] = {};
        for (int j = 0; j < L; ++j) {
          const float w = sW[j];
          float bv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int n = n0 + ty + 16 * i;
            bv[i] = n < N ? sB[j * NP + n] * w : 0.f;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int p = p0 + tx + 16 * q;
            xv[q] = p < P ? sX[j * P + p] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][q] += bv[i] * xv[q];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = n0 + ty + 16 * i;
          if (n >= N) continue;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int p = p0 + tx + 16 * q;
            if (p < P) sS[n * P + p] = total * sS[n * P + p] + acc[i][q];
          }
        }
      }
    }
  }
  __syncthreads();
  float* so = state_out + (long long)blockIdx.x * N * P;   // (B,H,N,P)
  for (int i = tid; i < N * P; i += kThreads) so[i] = sS[i];
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, void* y, void* state, int B, int S, int H, int P,
           int N, int L, const long long* s, void* stream) {
  if (B * H == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  if (L <= 0 || S % L) return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6]};
  const size_t smem = sizeof(float) * ((size_t)L * P + 2 * (size_t)L * (N + 1) +
                                       (size_t)N * P + (size_t)L * (L + 1) +
                                       3 * (size_t)L);
  cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mamba_scan_kernel<T><<<B * H, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<T*>(y),
      static_cast<float*>(state), S, H, P, N, L, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B,S,H,P), bm/cm (B,S,N) in T with the last dimension contiguous;
// strides: x (b, s, h), bm (b, s), cm (b, s), in elements.  dt (B,S,H) and
// a = -exp(a_log) (H,) are contiguous fp32; y (B,S,H,P) in T and the final
// state (B,H,N,P) in fp32 are contiguous.  S must be a multiple of L.
extern "C" int mamba_scan_f32(const void* x, const void* dt, const void* a,
                              const void* bm, const void* cm, void* y,
                              void* state, int B, int S, int H, int P, int N,
                              int L, const long long* strides, void* stream) {
  return launch<float>(x, dt, a, bm, cm, y, state, B, S, H, P, N, L, strides,
                       stream);
}

extern "C" int mamba_scan_bf16(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm, void* y,
                               void* state, int B, int S, int H, int P, int N,
                               int L, const long long* strides,
                               void* stream) {
  return launch<__nv_bfloat16>(x, dt, a, bm, cm, y, state, B, S, H, P, N, L,
                               strides, stream);
}
