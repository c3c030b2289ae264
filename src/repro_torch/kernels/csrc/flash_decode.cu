// Flash decode: one query token per (batch row, head) against a KV cache,
// with GQA and a per-row fill level kv_len.
//
// Replaces repro/kernels/flash_decode.py::flash_decode (pl.pallas_call at
// :76), whose grid walks 256-key cache blocks in order and skips blocks past
// kv_len.  Here one thread block takes one (b, h): its 8 warps stride over
// the keys below kv_len[b] (read from device memory, so one compiled kernel
// serves any fill level), each warp keeping its own online-softmax state
// (m, l, acc) in fp32 registers; the warps' states merge in shared memory
// at the end.  kv_len = 0 gives 0, as the TPU kernel does.
//
// Bound on Hopper: bytes.  Each key costs 2*D flops per head against 2*D
// elements of K and V, and a GQA group of heads shares one KV head, so the
// function needs at most ~16 flop per byte of cache.  The design reads each
// K and V row once per warp with coalesced 16-lane..32-lane accesses, keeps
// 4 keys of loads in flight per warp to hide latency, reads K/V through the
// strides of the model's (B, T, Hkv, D) cache (no transposed copy), and
// leaves the G heads of a group to meet the same rows in L2.  With B*H
// blocks (128 at glm4_9b's 4 slots) the grid does not fill 132 SMs deeply;
// splitting the KV axis across blocks is later work.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;

struct Strides {
  long long qb, qh, kb, kh, kt, vb, vh, vt, ob, oh;
};

template <typename T, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    T* __restrict__ o, int H, int group, int T_, int D,
                    int Dv, Strides st, float scale) {
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int len = kv_len[b];
  len = len < 0 ? 0 : (len > T_ ? T_ : len);
  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + hk * st.kh;
  const T* vp = v + b * st.vb + hk * st.vh;

  float qf[DPL], acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int d = lane + 32 * j;
    qf[j] = d < D ? to_f32(qp[d]) : 0.f;
    acc[j] = 0.f;
  }
  float m = NEG_INF_F, l = 0.f;

  for (int t0 = warp * kUnroll; t0 < len; t0 += kWarps * kUnroll) {
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float part = 0.f;
      if (t0 + u < len) {
        const T* kr = kp + (long long)(t0 + u) * st.kt;
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int d = lane + 32 * j;
          if (d < D) part += qf[j] * to_f32(kr[d]);
        }
      }
      s[u] = part;
    }
    float mt = NEG_INF_F;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      s[u] = t0 + u < len ? warp_sum(s[u]) * scale : NEG_INF_F;
      mt = fmaxf(mt, s[u]);
    }
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    float p[kUnroll], psum = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      p[u] = t0 + u < len ? expf(s[u] - m_new) : 0.f;
      psum += p[u];
    }
    l = l * corr + psum;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[j] *= corr;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < len) {
        const T* vr = vp + (long long)(t0 + u) * st.vt;
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int d = lane + 32 * j;
          if (d < Dv) acc[j] += p[u] * to_f32(vr[d]);
        }
      }
    }
    m = m_new;
  }

  __shared__ float sm[kWarps], sl[kWarps];
  __shared__ float sacc[kWarps][32 * DPL];
  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
#pragma unroll
  for (int j = 0; j < DPL; ++j) sacc[warp][lane + 32 * j] = acc[j];
  __syncthreads();
  float mx = sm[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sm[w]);
  float lsum = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) lsum += sl[w] * expf(sm[w] - mx);
  T* op = o + b * st.ob + h * st.oh;
  for (int d = threadIdx.x; d < Dv; d += kWarps * 32) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += sacc[w][d] * expf(sm[w] - mx);
    op[d] = from_f32<T>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int DPL>
void launch_dpl(const void* q, const void* k, const void* v,
                const int* kv_len, void* o, int B, int H, int group, int T_,
                int D, int Dv, const Strides& st, float scale,
                cudaStream_t stream) {
  flash_decode_kernel<T, DPL><<<B * H, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(o), H, group, T_, D,
      Dv, st, scale);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* o, int B, int H, int Hkv, int T_, int D, int Dv,
           const long long* s, float scale, void* stream) {
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9]};
  const int dmax = D > Dv ? D : Dv;
  const int group = H / Hkv;
  const int* len = static_cast<const int*>(kv_len);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (B * H == 0) return static_cast<int>(cudaGetLastError());
  if (dmax <= 32)
    launch_dpl<T, 1>(q, k, v, len, o, B, H, group, T_, D, Dv, st, scale, cs);
  else if (dmax <= 64)
    launch_dpl<T, 2>(q, k, v, len, o, B, H, group, T_, D, Dv, st, scale, cs);
  else if (dmax <= 128)
    launch_dpl<T, 4>(q, k, v, len, o, B, H, group, T_, D, Dv, st, scale, cs);
  else if (dmax <= 256)
    launch_dpl<T, 8>(q, k, v, len, o, B, H, group, T_, D, Dv, st, scale, cs);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: q (b, h), k (b, h, t), v (b, h, t), o (b, h), in elements; the
// head dimension is contiguous in every tensor.
extern "C" int flash_decode_f32(const void* q, const void* k, const void* v,
                                const void* kv_len, void* o, int B, int H,
                                int Hkv, int T_, int D, int Dv,
                                const long long* strides, float scale,
                                void* stream) {
  return launch<float>(q, k, v, kv_len, o, B, H, Hkv, T_, D, Dv, strides,
                       scale, stream);
}

extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* kv_len, void* o, int B, int H,
                                 int Hkv, int T_, int D, int Dv,
                                 const long long* strides, float scale,
                                 void* stream) {
  return launch<__nv_bfloat16>(q, k, v, kv_len, o, B, H, Hkv, T_, D, Dv,
                               strides, scale, stream);
}
