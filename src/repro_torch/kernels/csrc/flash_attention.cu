// Flash attention forward on Hopper's tensor cores: q (B,H,S,D) against k/v
// (B,Hkv,T,D), GQA by head divide, optional causal mask (top-left aligned,
// qpos >= kpos), scale D^-0.5 by default, output acc / max(l, 1e-30).
//
// Replaces repro/kernels/flash_attention.py::flash_attention_fwd
// (pl.pallas_call at :91; body _kernel at :31-72), whose grid (B, H, nQ, nK)
// carries the online softmax state (m, l, acc) in VMEM across KV blocks in
// order.  Blocks on a GPU run in no order, so the KV axis is a loop inside
// one CTA: one CTA per (64-row q block, head, batch row), the heaviest
// (last, under the causal mask) q blocks launched first.  Two consumer
// warpgroups share the block's KV tiles, even and odd, and merge their
// softmax states at the end, so the longest chain of tiles a CTA walks is
// halved and each SM has 8 math warps to hide latency with.
//
// Bound on Hopper: operations.  At the prefill shapes (S = T = 512, D = 128)
// the function does 2*S*T*D flops a head (half that when causal) against
// O((S+T)*D) bytes.  So the products run on tensor cores and the loads are
// asynchronous:
// * warp 8 is the producer: one thread loads the Q block once and the K and
//   V tiles (64 keys) into a ring of stages with TMA, each stage behind a
//   full and an empty mbarrier;
// * warps 0-3 and 4-7 are the two consumer warpgroups, each over all 64
//   query rows and every other tile; each keeps m, l and its output
//   accumulator in registers and does the online softmax on the score
//   fragments, the row max and sum across the 4 threads of a quad; at the
//   end the second hands its state to the first through shared memory.
// TMA loads boxes of 64 rows by 128 bytes with the 128-byte swizzle (a row
// of D = 128 is two boxes in bf16, four in fp32) and fills rows and columns
// out of bounds with zeros: ragged S and T (served prompts of 9, 67 and 110)
// and D = 112 (zamba2_7b) need no copy; key positions >= T and the causal
// diagonal are masked by position.  Tiles wholly above the diagonal are
// skipped.
//
// bf16: both products are wgmma.  S = Q·Kᵀ takes Q and K from shared memory,
// both K-major (D contiguous).  O += P·V takes P from registers (the score
// accumulator rounded to bf16 in place) and V as the transposed (MN-major)
// operand, which 16-bit wgmma allows.  Rounding P to bf16 before P·V differs
// from the Pallas body, which multiplies fp32 p by v upcast to fp32
// (flash_attention.py:51-66); the difference sits within the 3e-2 bf16 gate
// (ref.attention_bf16p holds the rounding plan against Pallas on the CPU).
//
// fp32: one TF32 product misses the 2e-5 fp32 gate (about 1e-3 at D = 128,
// S = 512), so each product is 3xTF32: x = hi + lo with hi = tf32(x) and
// lo = tf32(x - hi), both rounded to nearest with ties away (as
// cvt.rna.tf32.f32 does, by integer ops: the inputs are finite), and
// acc += lo·hi + hi·lo + hi·hi in fp32
// (ref.attention_3xtf32 is the plan).  The products are mma.sync m16n8k8
// tf32 with fragments read from shared memory by address, not wgmma:
// TF32 wgmma takes only K-major operands and its B only from shared
// memory, so V would have to be transposed while it is staged and every
// operand's hi and lo parts written back to shared memory (twice the
// footprint, one more pass and barrier a tile); with mma.sync the transpose
// is addressing and the split stays in registers.  P·V reads P's accumulator
// fragment as the A operand with the key axis permuted inside each 8-key
// slice (slot t is key 2t, slot t+4 key 2t+1), and V's rows in the same
// order.  The swizzle keeps those reads free of bank conflicts.
//
// The tensor maps are encoded on the host at each call (hopper.cuh says
// how).  Contract (the Python wrapper checks it and raises first): D and Dv
// multiples of 16 in bf16 and of 8 in fp32, D at most 192 (deepseek_v2's
// MLA prefill: qk_nope 128 + qk_rope 64) and Dv at most 128 (the output
// accumulator's DVP / 2 = 64 registers a thread); the head dimension
// contiguous; base pointers 16-byte aligned and the outer strides
// multiples of 16 bytes (TMA's rules).
//
// Shared memory: 1 KB of alignment slack, the Q block and `stages` stages
// of a K and a V tile, in 8 KB boxes of 64 rows by 128 bytes, and
// 2 * stages + 1 mbarriers; a block may have 232,448 bytes on sm_90.
// bf16 takes 4 stages: D 192 / Dv 128 is 3 Q boxes + 4 x (3 + 2) boxes,
// 189,512 bytes.  fp32 (32 columns a box) takes 3 stages up to D 128
// (4 + 3 x 8 boxes, 230,456 bytes at D = Dv = 128) and 2 above: at D 192 /
// Dv 128, three would be 6 + 3 x (6 + 4) boxes, 295,992 bytes; two are
// 6 + 2 x 10 boxes, 214,056 bytes.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64, BK = 64, kGroups = 2, kConsumers = 128 * kGroups;
constexpr int kThreads = kConsumers + 32, kMaxD = 192, kMaxDv = 128;
constexpr int kBoxRows = 64, kBoxBytes = kBoxRows * 128;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr int box = 32;  // elements in a 128-byte box row
  static constexpr CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr int box = 64;
  static constexpr CUtensorMapDataType type =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

// Ring stages of an instantiation (the header says why): 4 in bf16, 3 in
// fp32 up to D 128 and 2 above.
template <typename T, int DP>
__host__ __device__ constexpr int stages_of() {
  return sizeof(T) == 2 ? 4 : (DP <= 128 ? 3 : 2);
}

// V boxes of a stage: wgmma's N covers DVP columns (whole boxes); fp32 reads
// only the boxes that hold Dv columns.
template <typename T, int DVP>
__host__ __device__ int v_boxes(int Dv) {
  return sizeof(T) == 2 ? DVP / 64 : (Dv + 31) / 32;
}

// Element (row, col) of an fp32 tile of 128-byte-swizzled boxes (64 rows
// each), and the 4 elements from a col that is a multiple of 4.
__device__ __forceinline__ float lds_sw128(const uint8_t* tile, int row,
                                           int col) {
  const int c = col & 31;
  const int off = (col >> 5) * kBoxBytes + row * 128 +
                  ((((c >> 2) ^ (row & 7)) << 4) | ((c & 3) << 2));
  return *reinterpret_cast<const float*>(tile + off);
}
__device__ __forceinline__ float4 lds4_sw128(const uint8_t* tile, int row,
                                             int col) {
  const int off = (col >> 5) * kBoxBytes + row * 128 +
                  ((((col & 31) >> 2) ^ (row & 7)) << 4);
  return *reinterpret_cast<const float4*>(tile + off);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q·Kᵀ of the warpgroup's 64 rows against a 64-key tile, in the
// accumulator layout s[4j + e]: row g + 8 (e >= 2), key 8j + 2t + (e & 1).
// The operand fences, and a k loop unrolled over DP (D rounded up to its
// 64-column boxes, zero-filled past D), keep every other instruction that
// touches the accumulators or P's registers out of the wgmma stage, which
// ptxas would otherwise serialise.
template <int DP>
__device__ __forceinline__ void scores_bf16(float (&s)[32], uint32_t sQ,
                                            uint32_t sK) {
  hopper::fence_regs(s);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
    hopper::wgmma_m64n64k16_ss(s, hopper::desc_sw128(sQ + off, 16, 1024),
                               hopper::desc_sw128(sK + off, 16, 1024),
                               kk > 0);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(s);
}

// S = Q·Kᵀ in fp32, 3xTF32.  The sum over d does not care about its order,
// so each 16-column slice of D is permuted: thread t holds columns 4t..4t+3
// of its rows of Q and K (one 16-byte load each), the first k8 step takes
// columns 4t and 4t+1 as its slots t and t+4, the second 4t+2 and 4t+3.
// Columns past D are zero (TMA's fill), so D a multiple of 8 is enough.
__device__ __forceinline__ void tf32x4(const float4& x, uint32_t (&h)[4],
                                       uint32_t (&l)[4]) {
  hopper::split_tf32(x.x, h[0], l[0]);
  hopper::split_tf32(x.y, h[1], l[1]);
  hopper::split_tf32(x.z, h[2], l[2]);
  hopper::split_tf32(x.w, h[3], l[3]);
}

__device__ __forceinline__ void scores_f32(float (&s)[32], const uint8_t* sQ,
                                           const uint8_t* sK, int D, int w,
                                           int g, int t) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < (D + 15) / 16; ++kk) {
    const int c = 16 * kk + 4 * t;
    uint32_t h0[4], l0[4], h1[4], l1[4];   // rows g and g + 8 of the warp
    tf32x4(lds4_sw128(sQ, 16 * w + g, c), h0, l0);
    tf32x4(lds4_sw128(sQ, 16 * w + g + 8, c), h1, l1);
    const uint32_t ah0[4] = {h0[0], h1[0], h0[1], h1[1]};
    const uint32_t al0[4] = {l0[0], l1[0], l0[1], l1[1]};
    const uint32_t ah1[4] = {h0[2], h1[2], h0[3], h1[3]};
    const uint32_t al1[4] = {l0[2], l1[2], l0[3], l1[3]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t bh[4], bl[4];
      tf32x4(lds4_sw128(sK, 8 * j + g, c), bh, bl);
      hopper::mma_tf32(s + 4 * j, al0, bh[0], bh[1]);
      hopper::mma_tf32(s + 4 * j, ah0, bl[0], bl[1]);
      hopper::mma_tf32(s + 4 * j, ah0, bh[0], bh[1]);
      hopper::mma_tf32(s + 4 * j, al1, bh[2], bh[3]);
      hopper::mma_tf32(s + 4 * j, ah1, bl[2], bl[3]);
      hopper::mma_tf32(s + 4 * j, ah1, bh[2], bh[3]);
    }
  }
}

// O += P·V, bf16: P's 16-key slices are the A registers, V the MN-major B.
template <int DVP>
__device__ __forceinline__ void pv_bf16(float (&o)[DVP / 2],
                                        const float (&p)[32], uint32_t sV) {
  uint32_t a[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(p[8 * kk + 2 * r], p[8 * kk + 2 * r + 1]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(a[kk]);
  hopper::fence_regs(o);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc = hopper::desc_sw128(sV + kk * 16 * 128, kBoxBytes,
                                             1024);
    if constexpr (DVP == 128)
      hopper::wgmma_m64n128k16_rs(o, a[kk], desc);
    else
      hopper::wgmma_m64n64k16_rs(o, a[kk], desc);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(o);
}

// O += P·V, fp32 in 3xTF32 by mma.sync.  Slot t of an 8-key slice holds key
// 2t and slot t+4 key 2t+1, so P's accumulator fragment is the A fragment.
template <int DVP>
__device__ __forceinline__ void pv_f32(float (&o)[DVP / 2],
                                       const float (&p)[32],
                                       const uint8_t* sV, int Dv, int g,
                                       int t) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t ah[4], al[4];
    hopper::split_tf32(p[4 * kk], ah[0], al[0]);
    hopper::split_tf32(p[4 * kk + 2], ah[1], al[1]);
    hopper::split_tf32(p[4 * kk + 1], ah[2], al[2]);
    hopper::split_tf32(p[4 * kk + 3], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < DVP / 8; ++n) {
      if (8 * n >= Dv) break;
      uint32_t bh0, bl0, bh1, bl1;
      hopper::split_tf32(lds_sw128(sV, 8 * kk + 2 * t, 8 * n + g), bh0, bl0);
      hopper::split_tf32(lds_sw128(sV, 8 * kk + 2 * t + 1, 8 * n + g), bh1,
                         bl1);
      hopper::mma_tf32(o + 4 * n, al, bh0, bh1);
      hopper::mma_tf32(o + 4 * n, ah, bl0, bl1);
      hopper::mma_tf32(o + 4 * n, ah, bh0, bh1);
    }
  }
}

struct Params {
  int S, T, D, Dv, group, n_q, causal;
  float scale_log2;             // scale * log2(e): the softmax runs in exp2
  long long ob, oh, os;         // output strides in elements
};

template <typename T, int DP, int DVP>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, T* __restrict__ o,
                  const Params prm) {
  extern __shared__ uint8_t smem_raw[];
  // swizzled boxes need 1024-byte alignment; the launch adds the slack
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023))
                              & 1023);
  constexpr int kStages = stages_of<T, DP>();
  const int nbd = (prm.D + Elem<T>::box - 1) / Elem<T>::box;
  const int nbv = v_boxes<T, DVP>(prm.Dv);
  const int stage_bytes = (nbd + nbv) * kBoxBytes;
  uint8_t* sQ = smem;
  uint8_t* sKV = sQ + nbd * kBoxBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sKV + kStages * stage_bytes);
  const uint32_t full0 = hopper::smem_u32(bars);        // + 8 * stage
  const uint32_t empty0 = full0 + 8 * kStages;          // + 8 * stage
  const uint32_t qbar = empty0 + 8 * kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (prm.n_q - 1 - static_cast<int>(blockIdx.z)) * BQ;
  const int kend = prm.causal ? min(prm.T, q0 + BQ) : prm.T;
  const int n_tiles = (kend + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(full0 + 8 * st, 1);
      hopper::mbar_init(empty0 + 8 * st, 128);  // the warpgroup that read it
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // producer warp: one thread issues TMA
    if (threadIdx.x == kConsumers) {
      const int hk = h / prm.group;
      const uint32_t sq = hopper::smem_u32(sQ);
      hopper::mbar_arrive_expect_tx(qbar, nbd * kBoxBytes);
      for (int i = 0; i < nbd; ++i)
        hopper::tma_load_4d(sq + i * kBoxBytes, &tm_q, i * Elem<T>::box, q0,
                            h, b, qbar);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        if (it >= kStages)  // a consumer released this stage's last use
          hopper::mbar_wait(empty0 + 8 * st, ((it / kStages) - 1) & 1);
        const uint32_t full = full0 + 8 * st;
        const uint32_t sk = hopper::smem_u32(sKV + st * stage_bytes);
        const uint32_t sv = sk + nbd * kBoxBytes;
        hopper::mbar_arrive_expect_tx(full, stage_bytes);
        for (int i = 0; i < nbd; ++i)
          hopper::tma_load_4d(sk + i * kBoxBytes, &tm_k, i * Elem<T>::box,
                              it * BK, hk, b, full);
        for (int i = 0; i < nbv; ++i)
          hopper::tma_load_4d(sv + i * kBoxBytes, &tm_v, i * Elem<T>::box,
                              it * BK, hk, b, full);
      }
    }
    return;
  }

  // consumer warpgroup wg takes tiles wg, wg + 2, ...; its warp w owns
  // rows 16w .. 16w + 15 of the block
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 16 * w + g, row1 = row0 + 8;
  float acc[DVP / 2];
#pragma unroll
  for (int i = 0; i < DVP / 2; ++i) acc[i] = 0.f;
  float m0 = NEG_INF_F, m1 = NEG_INF_F, l0 = 0.f, l1 = 0.f;

  hopper::mbar_wait(qbar, 0);
  for (int it = wg; it < n_tiles; it += kGroups) {
    const int st = it % kStages;
    const int k0 = it * BK;
    const uint8_t* sK = sKV + st * stage_bytes;
    const uint8_t* sV = sK + nbd * kBoxBytes;
    hopper::mbar_wait(full0 + 8 * st, (it / kStages) & 1);

    float s[32];
    if constexpr (sizeof(T) == 2)
      scores_bf16<DP>(s, hopper::smem_u32(sQ), hopper::smem_u32(sK));
    else
      scores_f32(s, sQ, sK, prm.D, w, g, t);

    // Online softmax in the exp2 domain.  Only the tile holding key T - 1
    // or the diagonal needs masks.  A visited tile starts at a key k0 < T
    // and (causal) k0 <= q0, so every row of the block sees key k0: each
    // tile's row max is finite and a masked score's exp2 is 0.
    const bool edge = k0 + BK > prm.T || (prm.causal && k0 + BK - 1 > q0);
    float mx0 = NEG_INF_F, mx1 = NEG_INF_F;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * prm.scale_log2;
      if (edge) {
        const int kpos = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const int qpos = (i & 2) ? row1 : row0;
        if (kpos >= prm.T || (prm.causal && qpos < kpos)) x = NEG_INF_F;
      }
      s[i] = x;
      if (i & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f(s[i] - ((i & 2) ? mn1 : mn0));
      s[i] = p;
      if (i & 2) ps1 += p; else ps0 += p;
    }
    l0 = l0 * c0 + ps0;   // this thread's part of the row sums
    l1 = l1 * c1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int i = 0; i < DVP / 2; ++i) acc[i] *= (i & 2) ? c1 : c0;

    if constexpr (sizeof(T) == 2)
      pv_bf16<DVP>(acc, s, hopper::smem_u32(sV));
    else
      pv_f32<DVP>(acc, s, sV, prm.Dv, g, t);
    if constexpr (sizeof(T) == 4)
      hopper::fence_proxy_async();  // K and V read with plain loads
    hopper::mbar_arrive(empty0 + 8 * st);
  }

  // Merge: every tile has been read, so the stages are free.  Thread i of
  // the second warpgroup holds the same (row, column) slots as thread i of
  // the first; it stores (m, l, acc) there column-major, conflict-free.
  float* xchg = reinterpret_cast<float*>(sKV);
  const int me = threadIdx.x & 127;
  hopper::named_barrier(1, kConsumers);
  if (wg == 1) {
    xchg[0 * 128 + me] = m0;
    xchg[1 * 128 + me] = m1;
    xchg[2 * 128 + me] = l0;
    xchg[3 * 128 + me] = l1;
#pragma unroll
    for (int i = 0; i < DVP / 2; ++i) xchg[(4 + i) * 128 + me] = acc[i];
  }
  hopper::named_barrier(1, kConsumers);
  if (wg == 1) return;
  {
    const float mb0 = xchg[me], mb1 = xchg[128 + me];
    const float mn0 = fmaxf(m0, mb0), mn1 = fmaxf(m1, mb1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    const float b0 = exp2f(mb0 - mn0), b1 = exp2f(mb1 - mn1);
    l0 = l0 * a0 + xchg[2 * 128 + me] * b0;
    l1 = l1 * a1 + xchg[3 * 128 + me] * b1;
#pragma unroll
    for (int i = 0; i < DVP / 2; ++i)
      acc[i] = acc[i] * ((i & 2) ? a1 : a0)
               + xchg[(4 + i) * 128 + me] * ((i & 2) ? b1 : b0);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  T* ob = o + b * prm.ob + h * prm.oh;
#pragma unroll
  for (int j = 0; j < DVP / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= prm.Dv) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row1 : row0;
      if (row >= prm.S) continue;
      const float den = half ? den1 : den0;
      const float v0 = acc[4 * j + 2 * half] / den;
      const float v1 = acc[4 * j + 2 * half + 1] / den;
      T* dst = ob + row * prm.os + col;
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
      else
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
    }
  }
}

template <typename T, int DP, int DVP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int S, int T_, int D, int Dv, const long long* st,
           float scale, int causal, void* stream) {
  const int mult = sizeof(T) == 2 ? 16 : 8;
  if (D <= 0 || Dv <= 0 || D > kMaxD || Dv > kMaxDv || D % mult || Dv % mult
      || Hkv <= 0 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B * H * S == 0) return static_cast<int>(cudaGetLastError());
  CUtensorMap tm_q, tm_k, tm_v;
  const int el = sizeof(T), box = Elem<T>::box;
  const uint64_t dq[4] = {(uint64_t)D, (uint64_t)S, (uint64_t)H, (uint64_t)B};
  const uint64_t dk[4] = {(uint64_t)D, (uint64_t)T_, (uint64_t)Hkv,
                          (uint64_t)B};
  const uint64_t dv[4] = {(uint64_t)Dv, (uint64_t)T_, (uint64_t)Hkv,
                          (uint64_t)B};
  // strides arrive as (b, h, s) per tensor; the maps take (s, h, b)
  const long long sq[3] = {st[2], st[1], st[0]};
  const long long sk[3] = {st[5], st[4], st[3]};
  const long long sv[3] = {st[8], st[7], st[6]};
  int err = hopper::map_4d(&tm_q, Elem<T>::type, el, q, dq, sq, box, kBoxRows);
  if (!err)
    err = hopper::map_4d(&tm_k, Elem<T>::type, el, k, dk, sk, box, kBoxRows);
  if (!err)
    err = hopper::map_4d(&tm_v, Elem<T>::type, el, v, dv, sv, box, kBoxRows);
  if (err) return err;

  const int nbd = (D + box - 1) / box;
  const int nbv = v_boxes<T, DVP>(Dv);
  constexpr int kStages = stages_of<T, DP>();
  const size_t smem = 1024 + (size_t)(nbd + kStages * (nbd + nbv)) * kBoxBytes
                      + 8 * (2 * kStages + 1);
  cudaError_t e = cudaFuncSetAttribute(
      flash_attn_kernel<T, DP, DVP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_q = (S + BQ - 1) / BQ;
  const Params prm{S, T_, D, Dv, H / Hkv, n_q, causal, scale * kLog2e,
                   st[9], st[10], st[11]};
  flash_attn_kernel<T, DP, DVP><<<dim3(H, B, n_q), kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, static_cast<T*>(o), prm);
  return static_cast<int>(cudaGetLastError());
}

// Instantiations: Dv padded to 64 or 128 (the accumulator's width), and in
// bf16 D padded to 64, 128 or 192 (the unrolled Q·Kᵀ k loop); fp32 loops
// over D, and its D over 128 is an instantiation of its own for the stages.
template <typename T, int DP>
int dispatch_dv(const void* q, const void* k, const void* v, void* o, int B,
                int H, int Hkv, int S, int T_, int D, int Dv,
                const long long* strides, float scale, int causal,
                void* stream) {
  return Dv <= 64
      ? launch<T, DP, 64>(q, k, v, o, B, H, Hkv, S, T_, D, Dv, strides,
                          scale, causal, stream)
      : launch<T, DP, 128>(q, k, v, o, B, H, Hkv, S, T_, D, Dv, strides,
                           scale, causal, stream);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Hkv, int S, int T_, int D, int Dv,
             const long long* strides, float scale, int causal,
             void* stream) {
  if constexpr (sizeof(T) == 2) {
    if (D <= 64)
      return dispatch_dv<T, 64>(q, k, v, o, B, H, Hkv, S, T_, D, Dv, strides,
                                scale, causal, stream);
  }
  if (D <= 128)
    return dispatch_dv<T, 128>(q, k, v, o, B, H, Hkv, S, T_, D, Dv, strides,
                               scale, causal, stream);
  return dispatch_dv<T, 192>(q, k, v, o, B, H, Hkv, S, T_, D, Dv, strides,
                             scale, causal, stream);
}

}  // namespace

// strides: q (b, h, s), k (b, h, t), v (b, h, t), o (b, h, s), in elements;
// the head dimension is contiguous in every tensor.  Returns a cudaError_t,
// or hopper::kNoEncoder / kEncodeFailed + CUresult when a tensor map could
// not be encoded.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int Hkv, int S, int T_, int D, int Dv,
                                   const long long* strides, float scale,
                                   int causal, void* stream) {
  return dispatch<float>(q, k, v, o, B, H, Hkv, S, T_, D, Dv, strides, scale,
                         causal, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int H,
                                    int Hkv, int S, int T_, int D, int Dv,
                                    const long long* strides, float scale,
                                    int causal, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, H, Hkv, S, T_, D, Dv, strides,
                                 scale, causal, stream);
}
