// Memory cross-attention with the key projection and RoPE fused in, for
// Hopper (sm_90a), hand-written CUDA C++, forward and backward.
//
// Replaces the TPU kernel sam2_video_tpu/ops/flash_attention.py
// flash_attention_kproj (Pallas _fwd_kproj_kernel / _bwd_kproj_kernel):
//   k = RoPE(kin Wk^T + bk) per key tile: the leading num_spatial keys
//   rotate by the axial table of one HW-token slot, tiled per slot; the
//   trailing object-pointer keys are not rotated;
//   s = (q * scale) k^T + key bias; online softmax; o = p v against the raw
//   64-wide memory (the v-commute); lse kept for the backward.
// Like the TPU kernel it runs in f32 inside: kin, Wk, q and v are bf16
// inputs (their products are exact in f32), and the f32 values that feed a
// product (the rotated k, the probabilities, the score gradients, the
// projection's gradient) go in as a bf16 high part and a bf16 remainder
// (common.cuh split2), so the tensor cores see them to ~16 bits. Outputs
// are rounded once.
//
// What bounds it on an H100 (8 objects, 576 queries, up to 4096 keys, d =
// 256): ~11 GFLOP of attention products per forward call against ~5 MB of
// q, memory and output, so the tensor cores bound it. Every product is a
// wgmma (sm90.cuh) on 128-byte-swizzled tiles fed by a two-stage cp.async
// ring, and the key projection is one of them:
//   - a block of two warpgroups owns 128 queries of one object (64 each)
//     and streams 64-key tiles of kin, v and
//     the key bias through the ring; Wk (32 KB), bk and the RoPE factors
//     stay in shared memory for the whole block;
//   - per tile, kin [64 x 64] Wk^T [64 x 256] is a wgmma; bias, RoPE and
//     the hi / lo split run on its accumulator in registers and write the
//     swizzled K tiles that q k^T reads. Two warpgroups share the tile
//     (each projects half of its columns). K never reaches device memory;
//   - RoPE factors: the axial table of a slot is cos / sin(x f_j) for the
//     first 64 pairs and (y f_j) for the last 64, so the kernel keeps one
//     row per x and one per y (gw + gh rows of 64 cos + 64 sin, bf16, the
//     values the plain version reads), not one per key;
//   - the keys are split across blocks (grid (query blocks, BH, S)) when
//     the query blocks alone do not fill the card twice (the wrapper's
//     kproj_plan); each split writes its unnormalised f32 output with its
//     row max and sum, and a combine merges the splits in split order.
//
// Backward, three passes and two small kernels, no float atomics (two runs
// give the same bits):
//   delta: rowsum(dout * out);
//   dq:    per (128 queries, object, key split), over the split's key
//          tiles (the same ring and projection as the forward): s = q k^T,
//          dp = dout v^T, ds = p (dp - delta), dq += ds k with all 256
//          columns of dq in one warpgroup, so a key tile is projected once
//          per block; splits summed in split order. Above slots of 34 x 34
//          two warpgroups' tiles and the RoPE rows overflow shared memory,
//          and a block holds one warpgroup (64 queries);
//   dkv:   per (64 keys, object), the tile projected once, over all query
//          tiles (a ring of q, dout, lse, delta): s^T = k q^T, dp^T = v
//          dout^T, dv += p^T dout, dk += ds^T q; then the RoPE adjoint ->
//          dpre, dkin = dpre Wk (a wgmma), and dpre (bf16 hi + lo) to
//          device memory. Two warpgroups share the tile, each with half of
//          dk's columns (RoPE pairs kept together), so dk fits in registers;
//   dWk:   dWk = dpre^T kin and dbk = column sums of dpre over all keys of
//          all objects: one wgmma GEMM over the stored dpre, ~one block per
//          SM, each over a run of 64-key tiles, then a sum of the blocks'
//          f32 partials in block order.

#include "common.cuh"
#include "sm90.cuh"

constexpr int KD = 256;              // q / k width
constexpr int KV = 64;               // kin / v / output width
constexpr int KT = 64;               // keys per tile
constexpr int QT = 64;               // queries per warpgroup
constexpr int WGT = 128;             // threads per warpgroup
constexpr int RING = 2;              // depth of the cp.async ring
constexpr int ROPE_ROW = 256;        // bytes per RoPE row: 64 cos, 64 sin
constexpr int MAX_ROPE_ROWS = 128;   // gw + gh held in shared memory (a
                                     // 64 x 64 slot, 1024 px); larger
                                     // grids read the table in place
constexpr int DW_PART = KD * KV + KD;   // one dWk / dbk partial
constexpr int K_BYTES = KD * 128;    // a 64-row tile 256 wide (32 KB)
constexpr int V_BYTES = KV * 128;    // a 64-row tile 64 wide (8 KB)

// ---------------------------------------------------------------------------
// Staging and the key projection
// ---------------------------------------------------------------------------

// the RoPE rows (cos 0..63, sin 0..63, bf16) to shared dst, 16-byte chunk n
// of row a at chunk n ^ (a % 8): the 8 rows a warp reads at once fall in
// 8 different bank groups
template <int NT>
__device__ __forceinline__ void stage_rope(uint32_t dst,
                                           const bf16* __restrict__ rope,
                                           int rows) {
  for (int e = threadIdx.x; e < rows * 16; e += NT) {
    const int a = e >> 4, n = e & 15;
    cp_async16(dst + a * ROPE_ROW + ((n ^ (a & 7)) << 4), rope + a * 128 + n * 8,
               true);
  }
}

// bk [256] bf16 (512 bytes) to shared dst
template <int NT>
__device__ __forceinline__ void stage_bk(uint32_t dst,
                                         const bf16* __restrict__ bk) {
  for (int e = threadIdx.x; e < KD / 8; e += NT)
    cp_async16(dst + 16 * e, bk + 8 * e, true);
}

// Wk [256, 64] as four 64-row tiles (rows 64 T ..: tile T)
template <int NT>
__device__ __forceinline__ void stage_wk(uint32_t dst,
                                         const bf16* __restrict__ wk) {
#pragma unroll
  for (int T = 0; T < KD / 64; ++T)
    stage_tile<KV, NT>(dst + T * TILE_COL_BYTES, wk + T * 64 * KV, 0, 64);
}

// the RoPE row of key `key` for column half c of a pair block (c = 0:
// pairs 0..63, the x row; c = 1: pairs 64..127, the y row), or -1 for a
// key that is not rotated (pointer keys, keys past Lk)
__device__ __forceinline__ int rope_row(int key, int c, int num_spatial,
                                        int HW, int gw) {
  if (key >= num_spatial) return -1;
  const int pos = key % HW;
  return c == 0 ? pos % gw : gw + pos / gw;
}

// the RoPE table a kernel reads: its copy in shared memory (stage_rope's
// swizzle, sw = 7) where gw + gh <= MAX_ROPE_ROWS, else the caller's
// [gw + gh, 128] table in device memory as it is (sw = 0: slot grids above
// 64 x 64, whose rows do not fit beside a pass's tiles)
struct RopeTab {
  const unsigned char* p;
  int sw;
};

__device__ __forceinline__ RopeTab rope_tab(unsigned char* smem_copy,
                                            const bf16* rope, int rows) {
  return rows <= MAX_ROPE_ROWS
             ? RopeTab{smem_copy, 7}
             : RopeTab{reinterpret_cast<const unsigned char*>(rope), 0};
}

// (cos, sin) of pairs 8 n + 2 t, + 1 of RoPE row a (1, 0 when a < 0)
__device__ __forceinline__ void rope_pair(RopeTab rope_s, int a, int n,
                                          float2& cs, float2& sn) {
  if (a < 0) {
    cs = make_float2(1.f, 1.f);
    sn = make_float2(0.f, 0.f);
    return;
  }
  const unsigned char* p = rope_s.p + a * ROPE_ROW +
                           ((n ^ (a & rope_s.sw)) << 4) + 4 * (threadIdx.x & 3);
  cs = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  sn = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + 128));
}

// k = RoPE(kin Wk^T + bk) for columns 64 c .. 64 c + 63 and their RoPE
// partners 128 + 64 c .. of the 64 keys k0 .. of the kin tile, by one
// warpgroup: two wgmma products (the columns and their partners in the same
// registers), then bias, rotation and the hi / lo split in registers, into
// the swizzled K tiles at ktg (hi, then lo K_BYTES after it)
__device__ __forceinline__ void project_cols(
    uint32_t kin_s, uint32_t wk_s, const bf16* bk_s,
    RopeTab rope_s, unsigned char* ktg, int c, int k0,
    int num_spatial, int HW, int gw) {
  float a1[32], a2[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KV / 16; ++kk)
    wgmma_ss_n64(a1, desc_k(kin_s, kk * 16),
                 desc_k(wk_s + c * TILE_COL_BYTES, kk * 16), kk > 0);
#pragma unroll
  for (int kk = 0; kk < KV / 16; ++kk)
    wgmma_ss_n64(a2, desc_k(kin_s, kk * 16),
                 desc_k(wk_s + (2 + c) * TILE_COL_BYTES, kk * 16), kk > 0);
  wgmma_commit();
  const int warp = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2;
  const int r0 = warp * 16 + g;
  int a[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    a[h] = rope_row(k0 + r0 + 8 * h, c, num_spatial, HW, gw);
  wgmma_wait<0>();
  fence_regs(a1);
  fence_regs(a2);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int j1 = 64 * c + acc_col(4 * n), j2 = j1 + KD / 2;
    const float2 b1 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(bk_s + j1));
    const float2 b2 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(bk_s + j2));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * n + 2 * h, r = r0 + 8 * h;
      float2 cs, sn;
      rope_pair(rope_s, a[h], n, cs, sn);
      const float k1x = a1[i] + b1.x, k1y = a1[i + 1] + b1.y;
      const float k2x = a2[i] + b2.x, k2y = a2[i + 1] + b2.y;
      uint32_t hi, lo;
      uint32_t* p1 = reinterpret_cast<uint32_t*>(ktg + sw128_off(r, j1));
      uint32_t* p2 = reinterpret_cast<uint32_t*>(ktg + sw128_off(r, j2));
      split2(k1x * cs.x - k2x * sn.x, k1y * cs.y - k2y * sn.y, hi, lo);
      p1[0] = hi;
      p1[K_BYTES / 4] = lo;
      split2(k2x * cs.x + k1x * sn.x, k2y * cs.y + k1y * sn.y, hi, lo);
      p2[0] = hi;
      p2[K_BYTES / 4] = lo;
    }
  }
}

// the key range [t0, t1) of tiles of split blockIdx.z
__device__ __forceinline__ void split_range(int Lk, int tiles_per_split,
                                            int& t0, int& t1) {
  const int ntiles = (Lk + KT - 1) / KT;
  t0 = blockIdx.z * tiles_per_split;
  t1 = min(ntiles, t0 + tiles_per_split);
}

// online softmax of one 64-key tile: s (64 x 64, f32 logits) scaled, key
// bias added, keys at and past kmax masked; s becomes p, o is rescaled
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&o)[32],
                                             float (&m)[2], float (&l)[2],
                                             const float* bs, int kmax,
                                             float scale) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = acc_col(i);
    s[i] = c < kmax ? s[i] * scale + (bs ? bs[c] : 0.f) : -INFINITY;
  }
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float cm = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      cm = fmaxf(cm, fmaxf(s[4 * n + 2 * h], s[4 * n + 2 * h + 1]));
    const float mn = fmaxf(m[h], quad_max(cm));
    alpha[h] = expf(m[h] - mn);
    float ls = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = expf(s[4 * n + 2 * h + e] - mn);
        s[4 * n + 2 * h + e] = p;
        ls += p;
      }
    l[h] = l[h] * alpha[h] + ls;
    m[h] = mn;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// ---------------------------------------------------------------------------
// Forward: grid (ceil(Lq / 128), BH, S), FWD_WG warpgroups per block
// ---------------------------------------------------------------------------

constexpr int FWD_WG = 2;            // warpgroups (64 queries each) per block

struct FwdSmem {
  static constexpr int Q = 0;                       // one tile per warpgroup
  static constexpr int WK = Q + FWD_WG * K_BYTES;
  static constexpr int KHI = WK + K_BYTES;
  static constexpr int KLO = KHI + K_BYTES;
  static constexpr int KIN = KLO + K_BYTES;
  static constexpr int V = KIN + RING * V_BYTES;
  static constexpr int BIAS = V + RING * V_BYTES;
  static constexpr int BK = BIAS + RING * KT * 4;
  static constexpr int ROPE = BK + KD * 2;          // + rows * ROPE_ROW
};

// out / lse when part is null; else the split's unnormalised f32 output
// part[split][BH][Lq][64] and its (row max, row sum) pairs after all S
// splits' outputs
__global__ void __launch_bounds__(FWD_WG * WGT, 1)
kproj_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kin,
                 const bf16* __restrict__ v, const bf16* __restrict__ wk,
                 const bf16* __restrict__ bk, const float* __restrict__ bias,
                 long bias_bz, const bf16* __restrict__ rope,
                 bf16* __restrict__ out, float* __restrict__ lse,
                 float* __restrict__ part, int Lq, int Lk, int num_spatial,
                 int HW, int gw, int rope_rows, int tiles_per_split,
                 float scale) {
  using SM = FwdSmem;
  constexpr int NT = FWD_WG * WGT;
  extern __shared__ unsigned char kp_smem[];
  unsigned char* gen;
  const uint32_t sm = aligned_smem(kp_smem, &gen);
  const float* bias_s = reinterpret_cast<const float*>(gen + SM::BIAS);
  const bf16* bk_s = reinterpret_cast<const bf16*>(gen + SM::BK);
  const RopeTab rope_s = rope_tab(gen + SM::ROPE, rope, rope_rows);

  const int tid = threadIdx.x, wg = tid / WGT;
  const int warp = (tid >> 5) & 3, g = (tid & 31) >> 2;
  const int b = blockIdx.y, qb0 = blockIdx.x * FWD_WG * QT, q0 = qb0 + wg * QT;
  int t0, t1;
  split_range(Lk, tiles_per_split, t0, t1);
  const bf16* kb = kin + (size_t)b * Lk * KV;
  const bf16* vb = v + (size_t)b * Lk * KV;
  const float* bb = bias ? bias + (size_t)b * bias_bz : nullptr;
  const uint32_t Qs = sm + SM::Q + wg * K_BYTES;

  auto load = [&](int t, int st) {
    stage_tile<KV, NT>(sm + SM::KIN + st * V_BYTES, kb, t * KT, Lk);
    stage_tile<KV, NT>(sm + SM::V + st * V_BYTES, vb, t * KT, Lk);
    if (bb) stage_row_f32(sm + SM::BIAS + st * KT * 4, bb, t * KT, Lk);
  };
#pragma unroll
  for (int w = 0; w < FWD_WG; ++w)
    stage_tile<KD, NT>(sm + SM::Q + w * K_BYTES, q + (size_t)b * Lq * KD,
                       qb0 + w * QT, Lq);
  stage_wk<NT>(sm + SM::WK, wk);
  stage_bk<NT>(sm + SM::BK, bk);
  if (rope_rows <= MAX_ROPE_ROWS)
    stage_rope<NT>(sm + SM::ROPE, rope, rope_rows);
  load(t0, 0);
  cp_async_commit();

  const bool active = q0 < Lq;       // a last block's second warpgroup may
                                     // have no queries: it only projects
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float o[32];
  zero(o);

  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) % RING;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();                 // tile t landed; tile t - 1 consumed
    if (t + 1 < t1) load(t + 1, (t + 1 - t0) % RING);
    cp_async_commit();

    project_cols(sm + SM::KIN + st * V_BYTES, sm + SM::WK, bk_s, rope_s,
                 gen + SM::KHI, wg, t * KT, num_spatial, HW, gw);
    fence_proxy_async();
    __syncthreads();                 // the K tile is whole
    if (!active) continue;

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD / 16; ++kk)
      wgmma_ss_n64(s, desc_k(Qs, kk * 16), desc_k(sm + SM::KHI, kk * 16),
                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < KD / 16; ++kk)
      wgmma_ss_n64(s, desc_k(Qs, kk * 16), desc_k(sm + SM::KLO, kk * 16), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile(s, o, m, l, bb ? bias_s + st * KT : nullptr, Lk - t * KT,
                 scale);

    // o += p v, p as hi + lo
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_split(s, kk, ph[kk], pl[kk]);
    const uint32_t Vs = sm + SM::V + st * V_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = desc_mn(Vs, kk * 16, 0);
      wgmma_rs_n64(o, ph[kk], dv, 1);
      wgmma_rs_n64(o, pl[kk], dv, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }

  const int rows_left = Lq - q0;
  const int BH = gridDim.y;
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  if (!part) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= 1.f / l[(i >> 1) & 1];
    store_bf16<KV>(o, out + ((size_t)b * Lq + q0) * KV, KV, rows_left, 1.f);
    if ((tid & 3) == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        if (r < rows_left) lse[(size_t)b * Lq + q0 + r] = m[h] + logf(l[h]);
      }
    return;
  }
  const size_t prow = ((size_t)blockIdx.z * BH + b) * Lq + q0;
  store_f32<KV>(o, part + prow * KV, KV, rows_left);
  float2* ml = reinterpret_cast<float2*>(part + (size_t)gridDim.z * BH * Lq * KV);
  if ((tid & 3) == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + 8 * h;
      if (r < rows_left) ml[prow + r] = make_float2(m[h], l[h]);
    }
}

// ---------------------------------------------------------------------------
// Backward pass 1, dq: grid (ceil(Lq / (64 NWG)), BH, S), NWG warpgroups
// per block sharing each projected key tile (as in the forward)
// ---------------------------------------------------------------------------

template <int NWG>
struct DqSmem {
  static constexpr int Q = 0;                       // one tile per warpgroup
  static constexpr int DO = Q + NWG * K_BYTES;
  static constexpr int WK = DO + NWG * V_BYTES;
  static constexpr int KHI = WK + K_BYTES;
  static constexpr int KLO = KHI + K_BYTES;
  static constexpr int KIN = KLO + K_BYTES;
  static constexpr int V = KIN + RING * V_BYTES;
  static constexpr int BIAS = V + RING * V_BYTES;
  static constexpr int BK = BIAS + RING * KT * 4;
  static constexpr int ROPE = BK + KD * 2;
};

// dq (bf16, scaled) when part is null; else the split's f32 dq partial
// part[split][BH][Lq][256] (unscaled)
template <int NWG>
__global__ void __launch_bounds__(NWG * WGT, 1)
kproj_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kin,
                const bf16* __restrict__ v, const bf16* __restrict__ wk,
                const bf16* __restrict__ bk, const float* __restrict__ bias,
                long bias_bz, const bf16* __restrict__ rope,
                const bf16* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq,
                float* __restrict__ part, int Lq, int Lk, int num_spatial,
                int HW, int gw, int rope_rows, int tiles_per_split,
                float scale) {
  using SM = DqSmem<NWG>;
  constexpr int NT = NWG * WGT;
  extern __shared__ unsigned char kp_smem[];
  unsigned char* gen;
  const uint32_t sm = aligned_smem(kp_smem, &gen);
  const float* bias_s = reinterpret_cast<const float*>(gen + SM::BIAS);
  const bf16* bk_s = reinterpret_cast<const bf16*>(gen + SM::BK);
  const RopeTab rope_s = rope_tab(gen + SM::ROPE, rope, rope_rows);

  const int wg = threadIdx.x / WGT;
  const int warp = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2;
  const int b = blockIdx.y, qb0 = blockIdx.x * NWG * QT, q0 = qb0 + wg * QT;
  int t0, t1;
  split_range(Lk, tiles_per_split, t0, t1);
  const bf16* kb = kin + (size_t)b * Lk * KV;
  const bf16* vb = v + (size_t)b * Lk * KV;
  const float* bb = bias ? bias + (size_t)b * bias_bz : nullptr;

  const uint32_t Qs = sm + SM::Q + wg * K_BYTES;
  const uint32_t dOs = sm + SM::DO + wg * V_BYTES;

  auto load = [&](int t, int st) {
    stage_tile<KV, NT>(sm + SM::KIN + st * V_BYTES, kb, t * KT, Lk);
    stage_tile<KV, NT>(sm + SM::V + st * V_BYTES, vb, t * KT, Lk);
    if (bb) stage_row_f32(sm + SM::BIAS + st * KT * 4, bb, t * KT, Lk);
  };
#pragma unroll
  for (int w = 0; w < NWG; ++w) {
    stage_tile<KD, NT>(sm + SM::Q + w * K_BYTES, q + (size_t)b * Lq * KD,
                       qb0 + w * QT, Lq);
    stage_tile<KV, NT>(sm + SM::DO + w * V_BYTES,
                       dout + (size_t)b * Lq * KV, qb0 + w * QT, Lq);
  }
  stage_wk<NT>(sm + SM::WK, wk);
  stage_bk<NT>(sm + SM::BK, bk);
  if (rope_rows <= MAX_ROPE_ROWS)
    stage_rope<NT>(sm + SM::ROPE, rope, rope_rows);
  load(t0, 0);
  cp_async_commit();

  float lse_r[2], del_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    lse_r[h] = row < Lq ? lse[(size_t)b * Lq + row] : INFINITY;
    del_r[h] = row < Lq ? delta[(size_t)b * Lq + row] : 0.f;
  }
  float acc0[64], acc1[64];            // dq columns 0..127, 128..255
  zero(acc0);
  zero(acc1);

  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) % RING;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (t + 1 < t1) load(t + 1, (t + 1 - t0) % RING);
    cp_async_commit();

    const uint32_t Vs = sm + SM::V + st * V_BYTES;
    for (int c = wg; c < 2; c += NWG)
      project_cols(sm + SM::KIN + st * V_BYTES, sm + SM::WK, bk_s, rope_s,
                   gen + SM::KHI, c, t * KT, num_spatial, HW, gw);
    fence_proxy_async();
    __syncthreads();                   // the K tile is whole
    if (q0 >= Lq) continue;            // a last block's second warpgroup

    // s = q k^T and dp = dout v^T in two groups: p is computed while dp's
    // products run
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD / 16; ++kk)
      wgmma_ss_n64(s, desc_k(Qs, kk * 16), desc_k(sm + SM::KHI, kk * 16),
                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < KD / 16; ++kk)
      wgmma_ss_n64(s, desc_k(Qs, kk * 16), desc_k(sm + SM::KLO, kk * 16), 1);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KV / 16; ++kk)
      wgmma_ss_n64(dp, desc_k(dOs, kk * 16), desc_k(Vs, kk * 16),
                   kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    const float* bs = bias_s + st * KT;
    const int kmax = Lk - t * KT;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = acc_col(i), h = (i >> 1) & 1;
      s[i] = c < kmax ? expf(s[i] * scale + (bb ? bs[c] : 0.f) - lse_r[h])
                      : 0.f;                          // p
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] *= dp[i] - del_r[(i >> 1) & 1];            // ds
    uint32_t dh[4][4], dl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_split(s, kk, dh[kk], dl[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {                  // dq += ds k
      const uint64_t h0 = desc_mn(sm + SM::KHI, kk * 16, 0);
      const uint64_t l0 = desc_mn(sm + SM::KLO, kk * 16, 0);
      const uint64_t h1 = desc_mn(sm + SM::KHI, kk * 16, 128);
      const uint64_t l1 = desc_mn(sm + SM::KLO, kk * 16, 128);
      wgmma_rs_n128(acc0, dh[kk], h0, 1);
      wgmma_rs_n128(acc0, dh[kk], l0, 1);
      wgmma_rs_n128(acc0, dl[kk], h0, 1);
      wgmma_rs_n128(acc1, dh[kk], h1, 1);
      wgmma_rs_n128(acc1, dh[kk], l1, 1);
      wgmma_rs_n128(acc1, dl[kk], h1, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
  }

  const int rows_left = Lq - q0;
  if (!part) {
    bf16* dst = dq + ((size_t)b * Lq + q0) * KD;
    store_bf16<128>(acc0, dst, KD, rows_left, scale);
    store_bf16<128>(acc1, dst + 128, KD, rows_left, scale);
    return;
  }
  float* dst = part + (((size_t)blockIdx.z * gridDim.y + b) * Lq + q0) * KD;
  store_f32<128>(acc0, dst, KD, rows_left);
  store_f32<128>(acc1, dst + 128, KD, rows_left);
}

// ---------------------------------------------------------------------------
// Backward pass 2, dkin / dv / dpre: grid (ceil(Lk / 64), BH), two
// warpgroups on one key tile. Warpgroup w owns the dk columns 64 w .. 64 w +
// 63 and their RoPE partners 128 + 64 w .., so the RoPE adjoint stays in its
// registers; both compute the tile's scores (s^T and dp^T), which keeps
// each one's live accumulators at ~160 registers (one warpgroup holding all
// 256 columns of dk spilled); warpgroup 0 also accumulates dv.
// ---------------------------------------------------------------------------

constexpr int DKV_NT = 2 * WGT;

struct DkvSmem {
  static constexpr int WK = 0;
  static constexpr int KHI = WK + K_BYTES;
  static constexpr int KLO = KHI + K_BYTES;
  static constexpr int V = KLO + K_BYTES;
  static constexpr int Q = V + V_BYTES;
  static constexpr int KIN = Q + K_BYTES;   // the kin tile, in q's second
                                            // ring stage until the loop
  static constexpr int DO = Q + RING * K_BYTES;
  static constexpr int LSE = DO + RING * V_BYTES;
  static constexpr int DEL = LSE + RING * QT * 4;
  static constexpr int BK = DEL + RING * QT * 4;
  static constexpr int ROPE = BK + KD * 2;
  static constexpr int XCH = KHI;           // after the loop: warpgroup 1's
                                            // dkin partial, f32 [32][128]
};

__global__ void __launch_bounds__(DKV_NT, 1)
kproj_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kin,
                 const bf16* __restrict__ v, const bf16* __restrict__ wk,
                 const bf16* __restrict__ bk, const float* __restrict__ bias,
                 long bias_bz, const bf16* __restrict__ rope,
                 const bf16* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dkin,
                 bf16* __restrict__ dv, bf16* __restrict__ dpre_hi,
                 bf16* __restrict__ dpre_lo, int Lq, int Lk, int num_spatial,
                 int HW, int gw, int rope_rows, float scale) {
  using SM = DkvSmem;
  extern __shared__ unsigned char kp_smem[];
  unsigned char* gen;
  const uint32_t sm = aligned_smem(kp_smem, &gen);
  const float* lse_s = reinterpret_cast<const float*>(gen + SM::LSE);
  const float* del_s = reinterpret_cast<const float*>(gen + SM::DEL);
  const bf16* bk_s = reinterpret_cast<const bf16*>(gen + SM::BK);
  const RopeTab rope_s = rope_tab(gen + SM::ROPE, rope, rope_rows);

  const int tid = threadIdx.x, wg = tid / WGT, wt = tid % WGT;
  const int warp = wt >> 5, g = (wt & 31) >> 2, t4 = wt & 3;
  const int b = blockIdx.y, k0 = blockIdx.x * KT;
  const int c0 = 64 * wg, c1 = KD / 2 + 64 * wg;   // my dk columns
  const bf16* qb = q + (size_t)b * Lq * KD;
  const bf16* dob = dout + (size_t)b * Lq * KV;
  const float* lb = lse + (size_t)b * Lq;
  const float* db = delta + (size_t)b * Lq;

  auto load = [&](int t, int st) {
    stage_tile<KD, DKV_NT>(sm + SM::Q + st * K_BYTES, qb, t * QT, Lq);
    stage_tile<KV, DKV_NT>(sm + SM::DO + st * V_BYTES, dob, t * QT, Lq);
    stage_row_f32(sm + SM::LSE + st * QT * 4, lb, t * QT, Lq);
    stage_row_f32(sm + SM::DEL + st * QT * 4, db, t * QT, Lq);
  };
  stage_wk<DKV_NT>(sm + SM::WK, wk);
  stage_bk<DKV_NT>(sm + SM::BK, bk);
  if (rope_rows <= MAX_ROPE_ROWS)
    stage_rope<DKV_NT>(sm + SM::ROPE, rope, rope_rows);
  stage_tile<KV, DKV_NT>(sm + SM::KIN, kin + (size_t)b * Lk * KV, k0, Lk);
  stage_tile<KV, DKV_NT>(sm + SM::V, v + (size_t)b * Lk * KV, k0, Lk);
  cp_async_commit();
  load(0, 0);
  cp_async_commit();

  float bias_r[2];
  int rrow[2];                          // RoPE rows of my keys (my axis)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + warp * 16 + g + 8 * h;
    bias_r[h] = key < Lk ? (bias ? bias[(size_t)b * bias_bz + key] : 0.f)
                         : -INFINITY;
    rrow[h] = rope_row(key, wg, num_spatial, HW, gw);
  }

  cp_async_wait<1>();                   // Wk, bk, RoPE, kin and v landed
  fence_proxy_async();
  __syncthreads();
  project_cols(sm + SM::KIN, sm + SM::WK, bk_s, rope_s, gen + SM::KHI, wg,
               k0, num_spatial, HW, gw);

  float dka[32], dkb[32], dva[32];      // dk columns c0 .., c1 ..; dv
  zero(dka);
  zero(dkb);
  zero(dva);

  const int nq = (Lq + QT - 1) / QT;
  for (int t = 0; t < nq; ++t) {
    const int st = t % RING;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();                    // tile t landed (and, at t = 0, the
                                        // K tile is whole and kin is free)
    if (t + 1 < nq) load(t + 1, (t + 1) % RING);
    cp_async_commit();

    const uint32_t Qs = sm + SM::Q + st * K_BYTES;
    const uint32_t dOs = sm + SM::DO + st * V_BYTES;
    // s^T = k q^T (k as hi + lo) and dp^T = v dout^T, [64 keys x 64
    // queries], in two groups
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD / 16; ++kk)
      wgmma_ss_n64(s, desc_k(sm + SM::KHI, kk * 16), desc_k(Qs, kk * 16),
                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < KD / 16; ++kk)
      wgmma_ss_n64(s, desc_k(sm + SM::KLO, kk * 16), desc_k(Qs, kk * 16), 1);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KV / 16; ++kk)
      wgmma_ss_n64(dp, desc_k(sm + SM::V, kk * 16), desc_k(dOs, kk * 16),
                   kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    const float* ls = lse_s + st * QT;
    const float* ds_ = del_s + st * QT;
    const int qmax = Lq - t * QT;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = acc_col(i), h = (i >> 1) & 1;
      s[i] = c < qmax ? expf(s[i] * scale + bias_r[h] - ls[c]) : 0.f;  // p^T
    }
    uint32_t ph[4][4], pl[4][4];
    if (wg == 0) {                      // dv += p^T dout
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) a_split(s, kk, ph[kk], pl[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t d = desc_mn(dOs, kk * 16, 0);
        wgmma_rs_n64(dva, ph[kk], d, 1);
        wgmma_rs_n64(dva, pl[kk], d, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();                  // dp^T landed
    } else {
      wgmma_wait<0>();
    }
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp[i] = s[i] * (dp[i] - ds_[acc_col(i)]);       // ds^T
    uint32_t dh[4][4], dl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_split(dp, kk, dh[kk], dl[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {                  // dk += ds^T q
      const uint64_t d0 = desc_mn(Qs, kk * 16, c0);
      const uint64_t d1 = desc_mn(Qs, kk * 16, c1);
      wgmma_rs_n64(dka, dh[kk], d0, 1);
      wgmma_rs_n64(dka, dl[kk], d0, 1);
      wgmma_rs_n64(dkb, dh[kk], d1, 1);
      wgmma_rs_n64(dkb, dl[kk], d1, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(dkb);
  }

  const int rows_left = Lk - k0;
  if (wg == 0)
    store_bf16<KV>(dva, dv + ((size_t)b * Lk + k0) * KV, KV, rows_left, 1.f);

  // the RoPE adjoint (and the scale of q): dk -> dpre, in place; pair j of
  // my columns and its partner j + 128 sit in the same register of dka and
  // dkb. Keys past Lk have p = 0, so dk = 0 there.
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 cs, sn;
      rope_pair(rope_s, rrow[h], n, cs, sn);
      const int i = 4 * n + 2 * h;
      const float g1x = dka[i] * scale, g1y = dka[i + 1] * scale;
      const float g2x = dkb[i] * scale, g2y = dkb[i + 1] * scale;
      dka[i] = g1x * cs.x + g2x * sn.x;
      dka[i + 1] = g1y * cs.y + g2y * sn.y;
      dkb[i] = g2x * cs.x - g1x * sn.x;
      dkb[i + 1] = g2y * cs.y - g1y * sn.y;
    }

  // my share of dkin = dpre Wk (dpre as hi + lo over my 128 columns, the
  // product's K) and dpre's hi and lo parts to device memory for the dWk
  // pass
  float dki[32];
  zero(dki);
  bf16* hb = dpre_hi + ((size_t)b * Lk + k0) * KD;
  bf16* lob = dpre_lo + ((size_t)b * Lk + k0) * KD;
  const int r0 = warp * 16 + g;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int col0 = kk < 4 ? c0 + 16 * kk : c1 + 16 * (kk - 4);
    uint32_t hi[4], lo[4];
    if (kk < 4)
      a_split(dka, kk, hi, lo);
    else
      a_split(dkb, kk - 4, hi, lo);
    const uint64_t d = desc_mn(sm + SM::WK + (col0 >> 6) * TILE_COL_BYTES,
                               col0 & 63, 0);
    wgmma_rs_n64(dki, hi, d, 1);
    wgmma_rs_n64(dki, lo, d, 1);
    // fragment e: row r0 (+ 8 for e odd), columns col0 + 2 t4 (+ 8 for
    // e >= 2), two values each
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e & 1), col = col0 + 2 * t4 + 8 * (e >> 1);
      if (r < rows_left) {
        *reinterpret_cast<uint32_t*>(hb + (size_t)r * KD + col) = hi[e];
        *reinterpret_cast<uint32_t*>(lob + (size_t)r * KD + col) = lo[e];
      }
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dki);
  // dkin = warpgroup 0's share + warpgroup 1's, in that order (the K
  // tiles' space holds the exchange once both warpgroups left the loop)
  float* xch = reinterpret_cast<float*>(gen + SM::XCH);
  __syncthreads();
  if (wg == 1)
#pragma unroll
    for (int i = 0; i < 32; ++i) xch[i * WGT + wt] = dki[i];
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < 32; ++i) dki[i] += xch[i * WGT + wt];
    store_bf16<KV>(dki, dkin + ((size_t)b * Lk + k0) * KV, KV, rows_left,
                   1.f);
  }
}

// ---------------------------------------------------------------------------
// Backward pass 3, dWk / dbk: grid (blocks), one warpgroup; block p sums
// the 64-row tiles p * tpb .. of the N = BH * Lk stored (dpre, kin) rows
// ---------------------------------------------------------------------------

struct DwSmem {
  static constexpr int HI = 0;
  static constexpr int LO = HI + RING * K_BYTES;
  static constexpr int KIN = LO + RING * K_BYTES;
  static constexpr int BYTES = KIN + RING * V_BYTES + 1024;
};

// part[p]: dWk[o][i] (row-major [256][64]) then dbk[o], f32, of block p
__global__ void __launch_bounds__(WGT, 1)
kproj_dwk_kernel(const bf16* __restrict__ kin, const bf16* __restrict__ hi,
                 const bf16* __restrict__ lo, float* __restrict__ part, int N,
                 int tiles_per_block) {
  using SM = DwSmem;
  extern __shared__ unsigned char kp_smem[];
  unsigned char* gen;
  const uint32_t sm = aligned_smem(kp_smem, &gen);
  const int tid = threadIdx.x;
  const int ntiles = (N + KT - 1) / KT;
  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = min(ntiles, t0 + tiles_per_block);

  auto load = [&](int t, int st) {
    stage_tile<KD>(sm + SM::HI + st * K_BYTES, hi, t * KT, N);
    stage_tile<KD>(sm + SM::LO + st * K_BYTES, lo, t * KT, N);
    stage_tile<KV>(sm + SM::KIN + st * V_BYTES, kin, t * KT, N);
  };
  load(t0, 0);
  cp_async_commit();

  float acc[4][32];                    // dWk rows 64 ob .., columns 0..63
#pragma unroll
  for (int ob = 0; ob < 4; ++ob) zero(acc[ob]);
  float sb[2] = {0.f, 0.f};            // dbk[tid], dbk[tid + 128]

  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) % RING;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (t + 1 < t1) load(t + 1, (t + 1 - t0) % RING);
    cp_async_commit();

    const uint32_t H = sm + SM::HI + st * K_BYTES;
    const uint32_t L = sm + SM::LO + st * K_BYTES;
    const uint32_t Ks = sm + SM::KIN + st * V_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
      for (int ob = 0; ob < 4; ++ob) {
        const uint64_t dk = desc_mn(Ks, kk * 16, 0);
        wgmma_ss_n64_mn(acc[ob], desc_mn(H, kk * 16, ob * 64), dk);
        wgmma_ss_n64_mn(acc[ob], desc_mn(L, kk * 16, ob * 64), dk);
      }
    wgmma_commit();
    // dbk: column sums of hi + lo while the products run (rows past N are
    // zero-filled)
    const unsigned char* Hg = gen + SM::HI + st * K_BYTES;
    const unsigned char* Lg = gen + SM::LO + st * K_BYTES;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int o = tid + 128 * u;
      float a = 0.f;
      for (int r = 0; r < KT; ++r) {
        const uint32_t off = sw128_off(r, o);
        a += to_f32(*reinterpret_cast<const bf16*>(Hg + off)) +
             to_f32(*reinterpret_cast<const bf16*>(Lg + off));
      }
      sb[u] += a;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int ob = 0; ob < 4; ++ob) fence_regs(acc[ob]);
  }

  float* pp = part + (size_t)blockIdx.x * DW_PART;
#pragma unroll
  for (int ob = 0; ob < 4; ++ob)
    store_f32<KV>(acc[ob], pp + ob * 64 * KV, KV, 64);
  pp[KD * KV + tid] = sb[0];
  pp[KD * KV + tid + 128] = sb[1];
}

// out[i] = sum over p = 0 .. P-1, in that order, of part[p * n + i]
__global__ void kproj_reduce_kernel(const float* __restrict__ part, int P,
                                    int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += part[(size_t)p * n + i];
  out[i] = s;
}

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------

template <class Kernel>
static int set_smem(Kernel* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

static int cdiv(int a, int b) { return (a + b - 1) / b; }

constexpr size_t smem_with_rope(int carve, int rope_rows) {
  return (size_t)carve +
         (size_t)(rope_rows <= MAX_ROPE_ROWS ? rope_rows : 0) * ROPE_ROW + 1024;
}

// the dynamic shared memory of one block on an H100 (227 KB) holds every
// pass's RoPE rows up to MAX_ROPE_ROWS (above, the passes read the table
// in device memory); a dq block of two warpgroups up to DQ2_MAX_ROPE_ROWS
// (slots of 34 x 34) only, the wrapper's KPROJ_DQ_MAX_ROPE_ROWS
constexpr size_t MAX_SMEM = 227 * 1024;
constexpr int DQ2_MAX_ROPE_ROWS = 68;
static_assert(smem_with_rope(FwdSmem::ROPE, MAX_ROPE_ROWS) <= MAX_SMEM);
static_assert(smem_with_rope(DqSmem<1>::ROPE, MAX_ROPE_ROWS) <= MAX_SMEM);
static_assert(smem_with_rope(DkvSmem::ROPE, MAX_ROPE_ROWS) <= MAX_SMEM);
static_assert(smem_with_rope(DqSmem<2>::ROPE, DQ2_MAX_ROPE_ROWS) <= MAX_SMEM &&
              smem_with_rope(DqSmem<2>::ROPE, DQ2_MAX_ROPE_ROWS + 1) >
                  MAX_SMEM);

template <int NWG>
static int dq_launch(const bf16* q, const bf16* kin, const bf16* v,
                     const bf16* wk, const bf16* bk, const float* bias,
                     long bias_bz, const bf16* rope, const bf16* dout,
                     const float* lse, const float* delta, bf16* dq,
                     float* part, int BH, int Lq, int Lk, int num_spatial,
                     int HW, int gw, int rope_rows, int tps, float scale,
                     cudaStream_t st) {
  const int S = cdiv(cdiv(Lk, KT), tps);
  const size_t smem = smem_with_rope(DqSmem<NWG>::ROPE, rope_rows);
  const int err = set_smem(kproj_dq_kernel<NWG>, smem);
  if (err) return err;
  dim3 grid(cdiv(Lq, NWG * QT), BH, S);
  kproj_dq_kernel<NWG><<<grid, NWG * WGT, smem, st>>>(
      q, kin, v, wk, bk, bias, bias_bz, rope, dout, lse, delta, dq, part, Lq,
      Lk, num_spatial, HW, gw, rope_rows, tps, scale);
  return 0;
}

// q [BH, Lq, 256], kin / v [BH, Lk, 64], wk [256, 64], bk [256] bf16;
// bias [BH or 1, Lk] f32 (batch stride bias_bz) or null; rope [gw + gh,
// 128] bf16: row x < gw holds cos, sin of pairs 0..63 at x, row gw + y
// those of pairs 64..127 at y. out [BH, Lq, 64] bf16, lse [BH, Lq] f32.
// tiles_per_split: 64-key tiles per split, S = ceil(ceil(Lk / 64) / it);
// with S > 1, part is the caller's f32 scratch of S * BH * Lq * (64 + 2).
extern "C" int kproj_fwd(const void* q, const void* kin, const void* v,
                         const void* wk, const void* bk, const void* bias,
                         long bias_bz, const void* rope, void* out, void* lse,
                         void* part, int BH, int Lq, int Lk, int num_spatial,
                         int HW, int gw, int gh, int tiles_per_split,
                         void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const int rope_rows = gw + gh;
  if (tiles_per_split < 1 || gw < 1 || HW != gw * gh)
    return (int)cudaErrorInvalidValue;
  const int S = cdiv(cdiv(Lk, KT), tiles_per_split);
  const size_t smem = smem_with_rope(FwdSmem::ROPE, rope_rows);
  const int err = set_smem(kproj_fwd_kernel, smem);
  if (err) return err;
  dim3 grid(cdiv(Lq, FWD_WG * QT), BH, S);
  auto* pf = static_cast<float*>(part);
  kproj_fwd_kernel<<<grid, FWD_WG * WGT, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kin),
      static_cast<const bf16*>(v), static_cast<const bf16*>(wk),
      static_cast<const bf16*>(bk), static_cast<const float*>(bias), bias_bz,
      static_cast<const bf16*>(rope), static_cast<bf16*>(out),
      static_cast<float*>(lse), S > 1 ? pf : nullptr, Lq, Lk, num_spatial,
      HW, gw, rope_rows, tiles_per_split, 1.0f / sqrtf((float)KD));
  if (S > 1)
    fa_combine_kernel<KV><<<cdiv(BH * Lq, 4), 128, 0, st>>>(
        pf, S, BH * Lq, static_cast<bf16*>(out), static_cast<float*>(lse));
  return (int)cudaGetLastError();
}

// gradients dq [BH, Lq, 256], dkin / dv [BH, Lk, 64] bf16; dw: dWk [256 *
// 64] then dbk [256] f32. dq_nwg: warpgroups (64 queries each) per dq
// block, 1 or 2 (2 only for gw + gh <= DQ2_MAX_ROPE_ROWS). Scratch from the
// caller: delta [BH * Lq] f32; with S > 1 (tiles_per_split as in
// kproj_fwd) dq_part, f32 S * BH * Lq * 256; dpre, bf16 2 * BH * Lk * 256
// (hi, then lo); dw_part, f32 of ceil(ceil(BH * Lk / 64) / dw_tiles) *
// (256 * 64 + 256), dw_tiles: 64-row tiles of the dWk pass per block.
extern "C" int kproj_bwd(const void* q, const void* kin, const void* v,
                         const void* wk, const void* bk, const void* bias,
                         long bias_bz, const void* rope, const void* out,
                         const void* lse, const void* dout, void* dq,
                         void* dkin, void* dv, void* dw, void* delta,
                         void* dq_part, void* dpre, void* dw_part, int BH,
                         int Lq, int Lk, int num_spatial, int HW, int gw,
                         int gh, int dq_nwg, int tiles_per_split,
                         int dw_tiles, void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const int rope_rows = gw + gh;
  if (tiles_per_split < 1 || dw_tiles < 1 || gw < 1 || HW != gw * gh ||
      (dq_nwg != 1 && dq_nwg != 2) ||
      (dq_nwg == 2 && rope_rows > DQ2_MAX_ROPE_ROWS))
    return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)KD);
  auto* qb = static_cast<const bf16*>(q);
  auto* kb = static_cast<const bf16*>(kin);
  auto* vb = static_cast<const bf16*>(v);
  auto* wb = static_cast<const bf16*>(wk);
  auto* bkf = static_cast<const bf16*>(bk);
  auto* bf = static_cast<const float*>(bias);
  auto* rb = static_cast<const bf16*>(rope);
  auto* dob = static_cast<const bf16*>(dout);
  auto* lsef = static_cast<const float*>(lse);
  auto* del = static_cast<float*>(delta);
  auto* dqp = static_cast<float*>(dq_part);
  auto* dp_hi = static_cast<bf16*>(dpre);
  auto* dp_lo = dp_hi + (size_t)BH * Lk * KD;
  auto* dwp = static_cast<float*>(dw_part);

  const int rows = BH * Lq, S = cdiv(cdiv(Lk, KT), tiles_per_split);
  fa_delta_kernel<<<cdiv(rows, 4), 128, 0, st>>>(
      dob, static_cast<const bf16*>(out), del, rows, KV);

  const int err = dq_nwg == 2
      ? dq_launch<2>(qb, kb, vb, wb, bkf, bf, bias_bz, rb, dob, lsef, del,
                     static_cast<bf16*>(dq), S > 1 ? dqp : nullptr, BH, Lq,
                     Lk, num_spatial, HW, gw, rope_rows, tiles_per_split,
                     scale, st)
      : dq_launch<1>(qb, kb, vb, wb, bkf, bf, bias_bz, rb, dob, lsef, del,
                     static_cast<bf16*>(dq), S > 1 ? dqp : nullptr, BH, Lq,
                     Lk, num_spatial, HW, gw, rope_rows, tiles_per_split,
                     scale, st);
  if (err) return err;
  if (S > 1) {
    const long n = (long)rows * KD;
    const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    fa_dq_combine_kernel<<<blocks, 256, 0, st>>>(dqp, S, n, scale,
                                                 static_cast<bf16*>(dq));
  }

  const size_t smem_kv = smem_with_rope(DkvSmem::ROPE, rope_rows);
  int e2 = set_smem(kproj_dkv_kernel, smem_kv);
  if (e2) return e2;
  dim3 gk(cdiv(Lk, KT), BH);
  kproj_dkv_kernel<<<gk, DKV_NT, smem_kv, st>>>(
      qb, kb, vb, wb, bkf, bf, bias_bz, rb, dob, lsef, del,
      static_cast<bf16*>(dkin), static_cast<bf16*>(dv), dp_hi, dp_lo, Lq, Lk,
      num_spatial, HW, gw, rope_rows, scale);

  const int N = BH * Lk, P = cdiv(cdiv(N, KT), dw_tiles);
  e2 = set_smem(kproj_dwk_kernel, DwSmem::BYTES);
  if (e2) return e2;
  kproj_dwk_kernel<<<P, WGT, DwSmem::BYTES, st>>>(kb, dp_hi, dp_lo, dwp, N,
                                                  dw_tiles);
  kproj_reduce_kernel<<<cdiv(DW_PART, 256), 256, 0, st>>>(
      dwp, P, DW_PART, static_cast<float*>(dw));
  return (int)cudaGetLastError();
}
