// Flash decode: one query token per (batch row, head) against a KV cache,
// with GQA and a per-row fill level kv_len.
//
// Replaces repro/kernels/flash_decode.py::flash_decode (pl.pallas_call at
// :76), whose grid walks 256-key cache blocks in order, carries (m, l, acc)
// from block to block and skips blocks past kv_len.
//
// Bound on Hopper: bytes.  A key costs 4*D flops per query head against
// 2*D elements of K and V, so a GQA group of G heads does at most ~16 flop
// per byte of cache in bf16 (8 in fp32), far under the card's ratio.  The
// design is about bytes in flight and enough blocks, not FMAs:
// * One block per (key split, b, KV head) serves all G query heads of the
//   group (up to 32 a block, 16 at the widest rows; a larger group takes
//   several blocks), so a K/V row leaves HBM once per group of a block,
//   not once a head.
// * The key axis is split over `nsplit` <= 32 blocks.  The host picks
//   nsplit from T, the number of groups and the SM count, never from
//   kv_len: the launch reads no device value, needs no host sync and suits
//   a CUDA graph.  A split wholly at or past kv_len[b] reads no K/V and
//   leaves at once; the live splits know from kv_len how many they are.
// * A block streams its keys in 32-row tiles through a ring of shared-
//   memory stages, filled with 16-byte cp.async loads, several tiles in
//   flight.  Scores: bf16 groups of 8-16 heads run Q·Kᵀ and P·V on tensor
//   cores (mma.sync m16n8k16, the heads as the 16 rows, q held as A
//   fragments; P is rounded to bf16 before P·V, l keeps the fp32 sum).
//   Otherwise fp32 FMAs on CUDA cores: up to 4 heads, 8 lanes a key each
//   take every 8th 16-byte unit of the row and meet in 3 shuffles; more
//   heads, a lane takes whole dot products of its key.  No per-key warp
//   reduction: the online softmax gives each head 8-32 threads and takes
//   one max and one sum of shuffles a tile for all heads at once.
// * Rows at or past kv_len are neither loaded nor read into a product (a
//   tensor-core B fragment of stale rows is zeroed), so whatever the
//   cache's unwritten tail holds, NaN included, never counts.
// * The merge runs in the same launch: with one live split its block
//   writes the output; with more, each writes its (m, l, acc) to a small
//   fp32 scratch, and the last of them to bump the group's counter merges
//   them with max-shifted weights and resets the counter.  An empty split
//   takes no part (no exp(-inf - -inf)).
//   A thread-block cluster merging in distributed shared memory measured
//   slower: every block of a cluster waits for its slowest, and most
//   splits of a ragged batch are empty.
// K/V are read through the strides of the model's (B, T, Hkv, D) cache.
// kv_len = 0 gives 0, as the TPU kernel does.
// The single read: where V is the first Dv columns of K's rows (one
// storage, one base, the same strides: MLA's latent cache, whose key is
// [c_kv | k_rope] and whose value c_kv), each row is staged once and V is
// read from the staged K rows; otherwise K and V each have their rows in
// a stage.
// Widths and plans (`plan_of`, mirrored by flash_decode.plan in Python),
// shared memory of a block at most 232,448 bytes on sm_90:
// * rows of at most 128: a lane's NC = 1 chunk of 4 output dims, 32 heads
//   a block, 4 stages in bf16 and 3 in fp32; two blocks an SM;
// * a key of at most 288 and a value of at most 256 (minicpm3_4b's latent
//   decode: 256 + 32 and 256, 40 heads on one KV head, blocks of 32 and 8
//   heads): NC = 2, 32 heads, 4 / 2 stages.  Its fp32 block of 32 heads
//   took 220,672 bytes with K and V staged apart; the single read stages
//   74,752 bytes of the 149,504 and the block takes 154,112;
// * a key of at most 576 and a value of at most 512 (deepseek_v2_236b's
//   latent decode: 512 + 64 and 512, 128 heads on one KV head): NC = 4,
//   16 heads a block, 3 stages in bf16 and 2 in fp32.  In fp32 a staged
//   row is 2,320 bytes (145 odd 16-byte units), a stage 74,240, the q rows
//   of 16 heads 36,864 and the partial-acc rows 32,768: 223,232 bytes in
//   all.  With V staged apart (a stage 140,288) or 32 heads (q 73,728 and
//   the acc rows 65,536) it would pass the limit; so would bf16's four
//   stages (242,688 with its A fragments of q); three take 205,312.  A
//   value over 256 that is not a view of the key's rows does not fit and
//   is refused.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;         // keys a tile: one a lane
constexpr int kMaxHeads = 32;     // query heads a block, in any plan
constexpr int kMaxSplit = 32;     // key splits of a group
constexpr int kMaxD = 576;        // key row
constexpr int kMaxDv = 512;       // value row: NC = 4 chunks of 4 a lane
constexpr int kMaxSmem = 232448;  // 227 KB, a block's most on sm_90
constexpr int kPStride = kTile + 8;  // floats a row of P: conflict-free
                                     // 8-byte reads of 8 rows

struct Strides {
  long long qb, qh, kb, kh, kt, vb, vh, vt, ob, oh;
};

// The plan of a width (the header's table): 4-dim output chunks a lane,
// query heads a block, ring stages.
__host__ __device__ constexpr int nc_of(int D, int Dv) {
  return D <= 128 && Dv <= 128 ? 1 : (D <= 288 && Dv <= 256 ? 2 : 4);
}
__host__ __device__ constexpr int heads_of(int nc) {
  return nc == 4 ? 16 : 32;
}
__host__ __device__ constexpr int stages_of(int elsize, int nc) {
  return elsize == 2 ? (nc == 4 ? 3 : 4) : (nc == 1 ? 3 : 2);
}

// Keys of one split: T over the splits, rounded up to whole tiles.
__host__ __device__ inline int chunk_keys(int T_, int nsplit) {
  const int per = (T_ + nsplit - 1) / nsplit;
  return (per + kTile - 1) / kTile * kTile;
}

// The merge's scratch: a slot a split of (m, l) for the heads of a block,
// each row rounded up to 4 floats, then the heads' acc rows of Dv rounded
// to 4, so that every acc row starts on 16 bytes.
__host__ __device__ inline int slot_heads(int group, int heads) {
  const int g = group < heads ? group : heads;
  return (g + 3) / 4 * 4;
}
__host__ __device__ inline long long scratch_slot(int group, int Dv,
                                                  int heads) {
  const int g = group < heads ? group : heads;
  return 2 * slot_heads(group, heads) + (long long)g * ((Dv + 3) / 4 * 4);
}

// Byte offsets into the dynamic shared memory, the same on host and device.
struct Layout {
  int E;             // elements of a 16-byte unit
  int uk, uv;        // 16-byte units of a K row (D), of a V row (Dv)
  int rk, rv;        // bytes of a K row, a V row in the ring (odd units:
                     // 16-byte reads of 8 rows hit 8 bank groups)
  bool shared;       // V read from the first Dv columns of the K rows
  int stage;         // bytes of one ring stage: a tile of K and of V
  int gb;            // query heads of the block
  bool tc;           // bf16 products on tensor cores (mma.sync m16n8k16)
  bool few;          // up to 4 heads (and at most those a warp holds) on
                     // CUDA cores: each warp a quarter of the tile's keys,
                     // its own softmax state
  int slices;        // partial-acc rows a head: one a warp when few
  int rows;          // partial-acc rows: gb * slices <= 32
  int dv4;           // floats of a partial-acc row (Dv rounded up to 4)
  int qs, qf, sbuf, pbuf, stat, part, total;
  __host__ __device__ Layout(int elsize, int D, int Dv, int gb_, int heads,
                             int stages, bool shared_) {
    E = 16 / elsize;
    uk = (D + E - 1) / E;
    uv = (Dv + E - 1) / E;
    shared = shared_;
    rk = 16 * (uk | 1);
    rv = shared ? rk : 16 * (uv | 1);
    stage = kTile * (rk + (shared ? 0 : rv));
    gb = gb_;
    tc = elsize == 2 && gb >= 8 && gb <= 16 && D % 16 == 0 && Dv % 8 == 0;
    const int hpw = heads / kWarps;
    few = !tc && gb <= (hpw < 4 ? hpw : 4);
    slices = few ? kWarps : 1;
    rows = gb * slices;
    dv4 = (Dv + 3) / 4 * 4;
    qs = stages * stage;
    qf = qs + gb * uk * E * 4;              // q as mma A fragments
    sbuf = qf + (tc ? D / 16 * 512 : 0);
    pbuf = sbuf + gb * kTile * 4;     // sbuf holds the merge's weights too
    stat = pbuf + gb * kPStride * 4;
    part = stat + 4 * kMaxHeads * 4;
    total = part + rows * dv4 * 4;
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest
  return *reinterpret_cast<uint32_t*>(&h);
}

// D (16x8, fp32) += A (16x16, bf16, row) B (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float4& d, const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d.x), "+f"(d.y), "+f"(d.z), "+f"(d.w)
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// Two 8x8 bf16 matrices at the row addresses of lanes 0-15, transposed:
// the B fragment of a 16 (keys) x 8 (dims) slice of a row-major V tile.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];"
      : "=r"(r0), "=r"(r1)
      : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One 16-byte unit of a shared-memory row as fp32.
__device__ __forceinline__ void unit_f32(const float* p, float (&x)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x, x[1] = u.y, x[2] = u.z, x[3] = u.w;
}
__device__ __forceinline__ void unit_f32(const __nv_bfloat16* p,
                                         float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x, x[2 * i + 1] = f.y;
  }
}

// Four elements of a shared-memory V row as fp32 (8- or 16-byte aligned).
__device__ __forceinline__ float4 four_f32(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 four_f32(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// s += q[0:E] * k[0:E] for one 16-byte unit of K, in four partial sums.
template <int E>
__device__ __forceinline__ void dot_unit(float4& s, const float* q,
                                         const float (&kf)[E]) {
#pragma unroll
  for (int e = 0; e < E; e += 4) {
    const float4 qv = *reinterpret_cast<const float4*>(q + e);
    s.x = fmaf(qv.x, kf[e], s.x);
    s.y = fmaf(qv.y, kf[e + 1], s.y);
    s.z = fmaf(qv.z, kf[e + 2], s.z);
    s.w = fmaf(qv.w, kf[e + 3], s.w);
  }
}

// Rows [t0, t0 + n) of K and V into one ring stage (of K alone under the
// single read): 16-byte cp.async where every row and the head dims are
// 16-byte aligned (vec), else element by element with the tail of the last
// unit zeroed.
template <typename T>
__device__ __forceinline__ void load_tile(char* stage, const T* kp,
                                          const T* vp, const Strides& st,
                                          int t0, int n, const Layout& L,
                                          int D, int Dv, int vec) {
  char* ks = stage;
  char* vs = stage + kTile * L.rk;
  if (vec) {  // thread c copies units c, c + 256, ... in (row, unit) steps
    int r = threadIdx.x / L.uk, u = threadIdx.x - r * L.uk;
    int dr = kThreads / L.uk, du = kThreads - dr * L.uk;
    for (; r < n; r += dr, u += du) {
      if (u >= L.uk) u -= L.uk, ++r;
      if (r >= n) break;
      cp_async16(ks + r * L.rk + 16 * u, kp + (t0 + r) * st.kt + u * L.E);
    }
    if (L.shared) return;
    r = threadIdx.x / L.uv, u = threadIdx.x - r * L.uv;
    dr = kThreads / L.uv, du = kThreads - dr * L.uv;
    for (; r < n; r += dr, u += du) {
      if (u >= L.uv) u -= L.uv, ++r;
      if (r >= n) break;
      cp_async16(vs + r * L.rv + 16 * u, vp + (t0 + r) * st.vt + u * L.E);
    }
  } else {
    const int wk = L.uk * L.E, wv = L.uv * L.E;
    for (int c = threadIdx.x; c < n * wk; c += kThreads) {
      const int r = c / wk, d = c - r * wk;
      reinterpret_cast<T*>(ks + r * L.rk)[d] =
          d < D ? kp[(t0 + r) * st.kt + d] : from_f32<T>(0.f);
    }
    if (L.shared) return;
    for (int c = threadIdx.x; c < n * wv; c += kThreads) {
      const int r = c / wv, d = c - r * wv;
      reinterpret_cast<T*>(vs + r * L.rv)[d] =
          d < Dv ? vp[(t0 + r) * st.vt + d] : from_f32<T>(0.f);
    }
  }
}

// NC: 4-dim output chunks a lane (1 for Dv <= 128, 2 for Dv <= 256, 4 for
// Dv <= 512); HB: query heads a block; the narrow plan fits two blocks an
// SM (at most 128 registers a thread), the wider ones one.
template <typename T, int NC, int HB, int STAGES>
__global__ void __launch_bounds__(kThreads, NC == 1 ? 2 : 1)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    T* __restrict__ o, float* __restrict__ ws,
                    int* __restrict__ counters, int Hkv, int group,
                    int hchunks, int T_, int D, int Dv, int chunk,
                    Strides st, float scale, int vec, int shared) {
  constexpr int E = 16 / sizeof(T);
  constexpr int kHeadsPerWarp = HB / kWarps;
  // the tensor cores' acc holds 2 NC C fragments in the same registers
  static_assert(kHeadsPerWarp >= 2, "a warp holds two heads at least");
  extern __shared__ __align__(16) char smem[];
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int hc = blockIdx.y % hchunks, bh = blockIdx.y / hchunks;
  const int hk = bh % Hkv, b = bh / Hkv;
  const int g0 = hc * HB;
  const int gb = min(HB, group - g0);
  const Layout L(sizeof(T), D, Dv, gb, HB, min(STAGES, chunk / kTile),
                 shared);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // CUDA-core P·V sums: heads hs + j hstep, partial-acc row slice (one a
  // warp when few, all heads then)
  const int slice = warp % L.slices, hs = warp / L.slices;
  const int hstep = kWarps / L.slices;
  // tensor cores: lane = (fragment row fg, fragment column pair ft)
  const int fg = lane >> 2, ft = lane & 3;

  float* qs = reinterpret_cast<float*>(smem + L.qs);
  uint4* qf = reinterpret_cast<uint4*>(smem + L.qf);
  float* sbuf = reinterpret_cast<float*>(smem + L.sbuf);
  float* pbuf = reinterpret_cast<float*>(smem + L.pbuf);
  float* corr_s = reinterpret_cast<float*>(smem + L.stat);
  float* m_s = corr_s + kMaxHeads;
  float* l_s = m_s + kMaxHeads;
  int* last = reinterpret_cast<int*>(l_s + kMaxHeads);
  float* part = reinterpret_cast<float*>(smem + L.part);

  // the group's q rows in fp32, zero past D; the first eight loads a
  // thread go out with kv_len's, ahead of the prologue's cp.async traffic
  const int qrow = L.uk * E;
  const T* qp = q + b * st.qb + (long long)(hk * group + g0) * st.qh;
  const int nq = gb * qrow;
  float x[8];
  auto q_load = [&](int c0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 + i * kThreads + threadIdx.x;
      const int g = c / qrow, d = c - g * qrow;
      x[i] = c < nq && d < D ? to_f32(qp[g * st.qh + d]) : 0.f;
    }
  };
  auto q_store = [&](int c0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 + i * kThreads + threadIdx.x;
      if (c < nq) qs[c] = x[i];
    }
  };
  q_load(0);

  int len = kv_len[b];
  len = len < 0 ? 0 : (len > T_ ? T_ : len);
  // the splits that hold keys start below kv_len; the others leave at
  // once, but split 0 stays to write the zeros of kv_len = 0
  const int live = min(nsplit, (len + chunk - 1) / chunk);
  if (split >= max(live, 1)) return;
  const int start = split * chunk;
  const int end = min(start + chunk, len);
  const int ntiles = end > start ? (end - start + kTile - 1) / kTile : 0;
  const T* kp = k + b * st.kb + hk * st.kh;
  const T* vp = v + b * st.vb + hk * st.vh;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles)
      load_tile(smem + s * L.stage, kp, vp, st, start + s * kTile,
                min(kTile, end - start - s * kTile), L, D, Dv, vec);
    cp_async_commit();
  }
  if (ntiles > 0) {  // an empty split needs no q
    q_store(0);
    for (int c0 = 8 * kThreads; c0 < nq; c0 += 8 * kThreads) {
      q_load(c0);
      q_store(c0);
    }
  }
  if (L.tc && ntiles > 0) {
    __syncthreads();
    // q as the A fragments of Q·Kᵀ, one 16-byte load a lane a k step;
    // rows past the group are zero
    for (int c = threadIdx.x; c < D / 16 * 32; c += kThreads) {
      const int k0 = c / 32 * 16, r = (c & 31) >> 2, t = c & 3;
      const float* lo = qs + r * qrow + k0 + 2 * t;
      const float* hi = qs + (r + 8) * qrow + k0 + 2 * t;
      const bool hv = r + 8 < gb;
      qf[c] = make_uint4(pack_bf16(lo[0], lo[1]),
                         hv ? pack_bf16(hi[0], hi[1]) : 0u,
                         pack_bf16(lo[8], lo[9]),
                         hv ? pack_bf16(hi[8], hi[9]) : 0u);
    }
  }

  // softmax: head sg of tph threads (a power of two, 8..32), kpt keys each
  const int gpad = gb == 1 ? 1 : 1 << (32 - __clz(gb - 1));
  const int tph = min(32, kThreads / gpad), kpt = kTile / tph;
  const int sg = threadIdx.x / tph, ssub = threadIdx.x % tph;
  float m_run = NEG_INF_F, l_run = 0.f;
  float mw[kHeadsPerWarp], lw[kHeadsPerWarp];  // few: the warp's own state
#pragma unroll
  for (int j = 0; j < kHeadsPerWarp; ++j) mw[j] = NEG_INF_F, lw[j] = 0.f;
  // P·V sums: CUDA cores, acc[NC j + c] for head hs + hstep j and dims
  // 4 (lane + 32 c); tensor cores, acc[i] the C fragment of dims
  // 8 (warp + 8 i) of the 16 fragment rows, i < 2 NC
  float4 acc[kHeadsPerWarp * NC];
#pragma unroll
  for (int i = 0; i < kHeadsPerWarp * NC; ++i)
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile i landed; tile i - 1's stage is free
    const int nt = i + STAGES - 1;
    if (nt < ntiles)
      load_tile(smem + (nt % STAGES) * L.stage, kp, vp, st,
                start + nt * kTile, min(kTile, end - start - nt * kTile), L,
                D, Dv, vec);
    cp_async_commit();
    const char* ks = smem + (i % STAGES) * L.stage;
    const char* vs = L.shared ? ks : ks + kTile * L.rk;
    const int n = min(kTile, end - start - i * kTile);

    if (L.tc) {
      // scores on tensor cores: warp w < 4 takes keys 8w..8w+7 of the
      // tile; rows of K past n hold stale data, and the softmax masks them
      if constexpr (sizeof(T) == 2) {
        if (warp < kTile / 8) {
          float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
          float4 c2 = c;  // odd k steps: two chains of mma, not one
          const T* kr = reinterpret_cast<const T*>(ks + (8 * warp + fg) *
                                                   L.rk) + 2 * ft;
          int ks16 = 0;
#pragma unroll 2
          for (; ks16 + 1 < D / 16; ks16 += 2) {
            const uint32_t* kw =
                reinterpret_cast<const uint32_t*>(kr + 16 * ks16);
            mma_bf16(c, qf[ks16 * 32 + lane], kw[0], kw[4]);
            mma_bf16(c2, qf[(ks16 + 1) * 32 + lane], kw[8], kw[12]);
          }
          if (ks16 < D / 16) {
            const uint32_t* kw =
                reinterpret_cast<const uint32_t*>(kr + 16 * ks16);
            mma_bf16(c, qf[ks16 * 32 + lane], kw[0], kw[4]);
          }
          c.x += c2.x, c.y += c2.y, c.z += c2.z, c.w += c2.w;
          const int col = 8 * warp + 2 * ft;
          if (fg < gb) {
            sbuf[fg * kTile + col] = c.x;
            sbuf[fg * kTile + col + 1] = c.y;
          }
          if (fg + 8 < gb) {
            sbuf[(fg + 8) * kTile + col] = c.z;
            sbuf[(fg + 8) * kTile + col + 1] = c.w;
          }
        }
      }
    } else if (!L.few) {
      // scores on CUDA cores: lane = key, whole dot products, warp w heads
      // w, w + 8, ...; four partial sums a head keep the FMA chains short
      float4 s4[kHeadsPerWarp];
#pragma unroll
      for (int j = 0; j < kHeadsPerWarp; ++j)
        s4[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (lane < n) {
        const T* kr = reinterpret_cast<const T*>(ks + lane * L.rk);
#pragma unroll 4
        for (int u = 0; u < L.uk; ++u) {
          float kf[E];
          unit_f32(kr + u * E, kf);
#pragma unroll
          for (int j = 0; j < kHeadsPerWarp; ++j)
            if (warp + j * kWarps < gb)
              dot_unit(s4[j], qs + (warp + j * kWarps) * qrow + u * E, kf);
        }
      }
#pragma unroll
      for (int j = 0; j < kHeadsPerWarp; ++j)
        if (warp + j * kWarps < gb)
          sbuf[(warp + j * kWarps) * kTile + lane] =
              (s4[j].x + s4[j].y) + (s4[j].z + s4[j].w);
    } else {
      // up to 4 heads on CUDA cores, all in the warp: warp w takes keys
      // 4w..4w+3, 8 lanes a key each summing every 8th 16-byte unit of its
      // row (3 shuffles); the warp's own online softmax over its keys (2
      // shuffles for the max, 2 for the sum); then P·V of its 4 keys, a
      // lane 4 dims.  No block barrier but the tile's.
      const int key = 4 * warp + (lane >> 3);
      const bool valid = key < n;
      float4 s4[kHeadsPerWarp];
#pragma unroll
      for (int j = 0; j < kHeadsPerWarp; ++j)
        s4[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (valid) {
        const T* kr = reinterpret_cast<const T*>(ks + key * L.rk);
#pragma unroll 2
        for (int u = lane & 7; u < L.uk; u += 8) {
          float kf[E];
          unit_f32(kr + u * E, kf);
#pragma unroll
          for (int j = 0; j < kHeadsPerWarp; ++j)
            if (j < gb) dot_unit(s4[j], qs + j * qrow + u * E, kf);
        }
      }
      float p[kHeadsPerWarp];
#pragma unroll
      for (int j = 0; j < kHeadsPerWarp; ++j) {
        p[j] = 0.f;
        if (j < gb) {
          float x = (s4[j].x + s4[j].y) + (s4[j].z + s4[j].w);
          x += __shfl_xor_sync(0xffffffffu, x, 4);
          x += __shfl_xor_sync(0xffffffffu, x, 2);
          x += __shfl_xor_sync(0xffffffffu, x, 1);
          x = valid ? x * scale : NEG_INF_F;
          float mt = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 16));
          const float m_new = fmaxf(mw[j], mt);
          const float corr = expf(mw[j] - m_new);
          p[j] = valid ? expf(x - m_new) : 0.f;
          // a key's p sits in its 8 lanes: the xor-8 and -16 sum counts it
          // once
          float ps = p[j] + __shfl_xor_sync(0xffffffffu, p[j], 8);
          ps += __shfl_xor_sync(0xffffffffu, ps, 16);
          lw[j] = lw[j] * corr + ps;
          mw[j] = m_new;
#pragma unroll
          for (int cc = 0; cc < NC; ++cc) {
            float4& a = acc[j * NC + cc];
            a.x *= corr, a.y *= corr, a.z *= corr, a.w *= corr;
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (4 * warp + kk < n) {
          const T* vr = reinterpret_cast<const T*>(vs + (4 * warp + kk) *
                                                   L.rv);
          float4 vv[NC];
#pragma unroll
          for (int cc = 0; cc < NC; ++cc) {
            const int d = 4 * (lane + 32 * cc);
            vv[cc] = d < L.dv4 ? four_f32(vr + d)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int j = 0; j < kHeadsPerWarp; ++j) {
            if (j < gb) {
              const float pk = __shfl_sync(0xffffffffu, p[j], 8 * kk);
#pragma unroll
              for (int cc = 0; cc < NC; ++cc) {
                float4& a = acc[j * NC + cc];
                a.x += pk * vv[cc].x, a.y += pk * vv[cc].y;
                a.z += pk * vv[cc].z, a.w += pk * vv[cc].w;
              }
            }
          }
        }
      }
      continue;
    }
    __syncthreads();

    // online softmax: tph threads a head, kpt keys each; one max and one
    // sum over tph lanes a head a tile, every head at once
    {
      float xs[kTile / 8], mx = NEG_INF_F;
#pragma unroll
      for (int e = 0; e < kTile / 8; ++e) {
        const int key = ssub * kpt + e;
        xs[e] = NEG_INF_F;
        if (e < kpt && sg < gb && key < n) {
          xs[e] = sbuf[sg * kTile + key] * scale;
        }
        mx = fmaxf(mx, xs[e]);
      }
      for (int o = tph / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run, mx);
      const float corr = expf(m_run - m_new);
      float ps = 0.f;
#pragma unroll
      for (int e = 0; e < kTile / 8; ++e) {
        const int key = ssub * kpt + e;
        if (e < kpt && sg < gb) {
          const float p = key < n ? expf(xs[e] - m_new) : 0.f;
          pbuf[sg * kPStride + key] = p;
          ps += p;
        }
      }
      for (int o = tph / 2; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l_run = l_run * corr + ps;
      m_run = m_new;
      if (sg < gb && ssub == 0) corr_s[sg] = corr;
    }
    __syncthreads();

    if (L.tc) {
      // P·V on tensor cores: P rounded to bf16 (l keeps the fp32 sum),
      // warp w takes dims 8 (w + 8 i); V rows past n are zeroed in the
      // fragment, since 0 times stale data need not be 0
      if constexpr (sizeof(T) == 2) {
        const float clo = fg < gb ? corr_s[fg] : 1.f;
        const float chi = fg + 8 < gb ? corr_s[fg + 8] : 1.f;
#pragma unroll
        for (int j = 0; j < 2 * NC; ++j) {
          acc[j].x *= clo, acc[j].y *= clo;
          acc[j].z *= chi, acc[j].w *= chi;
        }
        for (int k0 = 0; k0 < n; k0 += 16) {
          const float* plo = pbuf + fg * kPStride + k0 + 2 * ft;
          const float* phi = plo + 8 * kPStride;
          const bool hv = fg + 8 < gb;
          const uint4 a = make_uint4(pack_bf16(plo[0], plo[1]),
                                     hv ? pack_bf16(phi[0], phi[1]) : 0u,
                                     pack_bf16(plo[8], plo[9]),
                                     hv ? pack_bf16(phi[8], phi[9]) : 0u);
          const int r = k0 + 2 * ft;
          const uint32_t m0 = (r < n ? 0xffffu : 0u) |
                              (r + 1 < n ? 0xffff0000u : 0u);
          const uint32_t m1 = (r + 8 < n ? 0xffffu : 0u) |
                              (r + 9 < n ? 0xffff0000u : 0u);
          const char* vr = vs + (k0 + (lane & 15)) * L.rv;
#pragma unroll
          for (int j = 0; j < 2 * NC; ++j) {
            const int d0 = 8 * (warp + kWarps * j);
            if (d0 < Dv) {
              uint32_t b0, b1;
              ldmatrix_x2_trans(b0, b1, vr + d0 * sizeof(T));
              mma_bf16(acc[j], a, b0 & m0, b1 & m1);
            }
          }
        }
      }
    } else {
      // P·V on CUDA cores: lane = 4 dims of the output, every key
#pragma unroll
      for (int j = 0; j < kHeadsPerWarp; ++j) {
        const int g = hs + j * hstep;
        if (g < gb) {
          const float c = corr_s[g];
#pragma unroll
          for (int cc = 0; cc < NC; ++cc) {
            float4& a = acc[j * NC + cc];
            a.x *= c, a.y *= c, a.z *= c, a.w *= c;
          }
        }
      }
#pragma unroll 4
      for (int key = 0; key < n; ++key) {
        const T* vr = reinterpret_cast<const T*>(vs + key * L.rv);
        float4 vv[NC];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const int d = 4 * (lane + 32 * cc);
          vv[cc] = d < L.dv4 ? four_f32(vr + d)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < kHeadsPerWarp; ++j) {
          const int g = hs + j * hstep;
          if (g < gb) {
            const float p = pbuf[g * kPStride + key];
#pragma unroll
            for (int cc = 0; cc < NC; ++cc) {
              float4& a = acc[j * NC + cc];
              a.x += p * vv[cc].x, a.y += p * vv[cc].y;
              a.z += p * vv[cc].z, a.w += p * vv[cc].w;
            }
          }
        }
      }
    }
  }

  cp_async_wait<0>();

  if (L.few) {
    // the warps' states meet: each scales its acc to the heads' common max
    float* mws = sbuf;                // (warp, head), 16 gb floats of sbuf
    float* lws = sbuf + kWarps * gb;
    if (lane == 0)
      for (int j = 0; j < gb; ++j) {
        mws[warp * gb + j] = mw[j];
        lws[warp * gb + j] = lw[j];
      }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kHeadsPerWarp; ++j) {
      if (j < gb) {
        float mx = NEG_INF_F;
        for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mws[w * gb + j]);
        const float e = expf(mw[j] - mx);
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          float4& a = acc[j * NC + cc];
          a.x *= e, a.y *= e, a.z *= e, a.w *= e;
        }
        if (threadIdx.x == 0) {
          float lsum = 0.f;
          for (int w = 0; w < kWarps; ++w)
            lsum += lws[w * gb + j] * expf(mws[w * gb + j] - mx);
          m_s[j] = mx;
          l_s[j] = lsum;
        }
      }
    }
  }

  // the block's partial: (m, l) a head, acc summed over the slices
  if (L.tc) {
#pragma unroll
    for (int j = 0; j < 2 * NC; ++j) {
      const int col = 8 * (warp + kWarps * j) + 2 * ft;
      if (col < Dv) {
        if (fg < gb) {
          part[fg * L.dv4 + col] = acc[j].x;
          part[fg * L.dv4 + col + 1] = acc[j].y;
        }
        if (fg + 8 < gb) {
          part[(fg + 8) * L.dv4 + col] = acc[j].z;
          part[(fg + 8) * L.dv4 + col + 1] = acc[j].w;
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kHeadsPerWarp; ++j) {
      const int g = hs + j * hstep;
      if (g < gb) {
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const int d = 4 * (lane + 32 * cc);
          if (d < L.dv4)
            *reinterpret_cast<float4*>(part + (slice * gb + g) * L.dv4 +
                                       d) = acc[j * NC + cc];
        }
      }
    }
  }
  if (!L.few && sg < gb && ssub == 0) {
    m_s[sg] = m_run;
    l_s[sg] = l_run;
  }
  __syncthreads();
  if (L.slices > 1) {
    for (int c = threadIdx.x; c < gb * L.dv4; c += kThreads) {
      float a = part[c];
      for (int sl = 1; sl < L.slices; ++sl) a += part[sl * gb * L.dv4 + c];
      part[c] = a;
    }
  }
  __syncthreads();

  T* op = o + b * st.ob + (long long)(hk * group + g0) * st.oh;
  if (live <= 1) {  // the block holds the whole row
    for (int c = threadIdx.x; c < gb * Dv; c += kThreads) {
      const int g = c / Dv, d = c - g * Dv;
      op[g * st.oh + d] =
          from_f32<T>(part[g * L.dv4 + d] / fmaxf(l_s[g], 1e-30f));
    }
    return;
  }
  // a live split leaves (m, l, acc) in the scratch; the last live block of
  // the group to arrive merges them and resets the counter
  const long long slot = scratch_slot(group, Dv, HB);
  const int mrow = slot_heads(group, HB);
  float* const wg = ws + (long long)blockIdx.y * nsplit * slot;
  {
    float* w = wg + split * slot;  // m at 0, l at mrow, acc at 2 mrow
    for (int c = threadIdx.x; c < gb; c += kThreads) {
      w[c] = m_s[c];
      w[mrow + c] = l_s[c];
    }
    for (int c = threadIdx.x; c < gb * L.dv4 / 4; c += kThreads)
      reinterpret_cast<float4*>(w + 2 * mrow)[c] =
          reinterpret_cast<const float4*>(part)[c];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *last = atomicAdd(counters + blockIdx.y, 1) == live - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  if (threadIdx.x == 0) counters[blockIdx.y] = 0;  // for the next launch
  // the weights exp(m_s - max) / sum of split s and head g, as in the
  // softmax: tph threads a head, a few splits each, one round of loads
  float* wt = sbuf;  // live * gb <= 32 * 32 floats
  {
    constexpr int kE = kMaxSplit / 8;  // tph >= 8
    float mr[kE], lr[kE], mx = NEG_INF_F;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int r = ssub + e * tph;
      const bool ok = sg < gb && r < live;
      mr[e] = ok ? __ldcg(wg + r * slot + sg) : NEG_INF_F;
      lr[e] = ok ? __ldcg(wg + r * slot + mrow + sg) : 0.f;
      mx = fmaxf(mx, mr[e]);
    }
    for (int o = tph / 2; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float lsum = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      mr[e] = ssub + e * tph < live ? expf(mr[e] - mx) : 0.f;
      lsum += mr[e] * lr[e];
    }
    for (int o = tph / 2; o > 0; o >>= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int r = ssub + e * tph;
      if (sg < gb && r < live) wt[r * gb + sg] = mr[e] / fmaxf(lsum, 1e-30f);
    }
  }
  __syncthreads();
  // 16-byte loads of the partial sums, many in flight a thread
  for (int c = threadIdx.x; c < gb * L.dv4 / 4; c += kThreads) {
    const int g = 4 * c / L.dv4, d = 4 * c - g * L.dv4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
    for (int r = 0; r < live; ++r) {
      const float w = wt[r * gb + g];
      const float4 p =
          __ldcg(reinterpret_cast<const float4*>(wg + r * slot + 2 * mrow) + c);
      a.x += w * p.x, a.y += w * p.y, a.z += w * p.z, a.w += w * p.w;
    }
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d + e < Dv) op[g * st.oh + d + e] = from_f32<T>(av[e]);
  }
}

template <typename T, int NC>
int launch_cfg(const void* q, const void* k, const void* v,
               const int* kv_len, void* o, void* ws, void* counters, int B,
               int Hkv, int group, int T_, int D, int Dv, const Strides& st,
               float scale, int nsplit, int vec, int shared,
               cudaStream_t stream) {
  constexpr int HB = heads_of(NC), STAGES = stages_of(sizeof(T), NC);
  auto kernel = flash_decode_kernel<T, NC, HB, STAGES>;
  const int gb = group < HB ? group : HB;
  const int hchunks = (group + HB - 1) / HB;
  const int chunk = chunk_keys(T_, nsplit);
  const int stages = STAGES < chunk / kTile ? STAGES : chunk / kTile;
  const Layout L(sizeof(T), D, Dv, gb, HB, stages, shared);
  if (L.total > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static bool raised = false;  // the limit, set once per instantiation
  if (!raised) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised = true;
  }
  kernel<<<dim3(nsplit, B * Hkv * hchunks), kThreads, L.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(o),
      static_cast<float*>(ws), static_cast<int*>(counters), Hkv, group,
      hchunks, T_, D, Dv, chunk, st, scale, vec, shared);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* o, void* ws, void* counters, int B, int H, int Hkv, int T_,
           int D, int Dv, const long long* s, float scale, int nsplit,
           int vec, int shared, void* stream) {
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9]};
  const int* len = static_cast<const int*>(kv_len);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (B * H == 0) return static_cast<int>(cudaGetLastError());
  if (Hkv <= 0 || H % Hkv || nsplit < 1 || nsplit > kMaxSplit ||
      D > kMaxD || Dv > kMaxDv || (shared && (Dv > D || k != v)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = H / Hkv;
  switch (nc_of(D, Dv)) {
    case 1:
      return launch_cfg<T, 1>(q, k, v, len, o, ws, counters, B, Hkv, group,
                              T_, D, Dv, st, scale, nsplit, vec, shared, cs);
    case 2:
      return launch_cfg<T, 2>(q, k, v, len, o, ws, counters, B, Hkv, group,
                              T_, D, Dv, st, scale, nsplit, vec, shared, cs);
    default:
      return launch_cfg<T, 4>(q, k, v, len, o, ws, counters, B, Hkv, group,
                              T_, D, Dv, st, scale, nsplit, vec, shared, cs);
  }
}

}  // namespace

// strides: q (b, h), k (b, h, t), v (b, h, t), o (b, h), in elements; the
// head dimension is contiguous in every tensor.  nsplit: key splits (1..32);
// ws: fp32 scratch of flash_decode_scratch() floats, counters: one int a
// (b, KV head, block of query heads), zero before the first launch and left
// zero by each; vec: K and V rows and head dims 16-byte aligned; shared: v
// is k (the same pointer and strides) and V its rows' first Dv columns.
extern "C" int flash_decode_f32(const void* q, const void* k, const void* v,
                                const void* kv_len, void* o, void* ws,
                                void* counters, int B, int H, int Hkv, int T_,
                                int D, int Dv, const long long* strides,
                                float scale, int nsplit, int vec, int shared,
                                void* stream) {
  return launch<float>(q, k, v, kv_len, o, ws, counters, B, H, Hkv, T_, D,
                       Dv, strides, scale, nsplit, vec, shared, stream);
}

extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* kv_len, void* o, void* ws,
                                 void* counters, int B, int H, int Hkv,
                                 int T_, int D, int Dv,
                                 const long long* strides, float scale,
                                 int nsplit, int vec, int shared,
                                 void* stream) {
  return launch<__nv_bfloat16>(q, k, v, kv_len, o, ws, counters, B, H, Hkv,
                               T_, D, Dv, strides, scale, nsplit, vec, shared,
                               stream);
}

// Floats of scratch the merge needs: a (m, l, acc) slot for every split of
// every (b, KV head, block of query heads).
extern "C" long long flash_decode_scratch(int B, int H, int Hkv, int D,
                                          int Dv, int nsplit) {
  const int group = H / Hkv, heads = heads_of(nc_of(D, Dv));
  const long long groups = (long long)B * Hkv * ((group + heads - 1) / heads);
  return groups * nsplit * scratch_slot(group, Dv, heads);
}

// Dynamic shared memory of a block for these widths, group size and read
// (shared: V from the K rows), bytes, at the plan's full ring of stages.
extern "C" int flash_decode_smem(int elsize, int D, int Dv, int group,
                                 int shared) {
  const int nc = nc_of(D, Dv), heads = heads_of(nc);
  const int gb = group < heads ? group : heads;
  return Layout(elsize, D, Dv, gb, heads, stages_of(elsize, nc), shared)
      .total;
}
