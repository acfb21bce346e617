// Generic flash attention with an additive key bias, for Hopper (sm_90a),
// hand-written CUDA C++, forward and backward.
//
// Replaces the TPU kernel sam2_video_tpu/ops/flash_attention.py
// flash_attention (Pallas _fwd_kernel / the merged dq-dk-dv _bwd_kernel):
//   o = softmax(q k^T / sqrt(D) + key_bias) v,
//   q [BH, Lq, D], k [BH, Lk, D], v [BH, Lk, DV] bf16, key_bias f32 [Lk]
//   (batch stride 0) or [BH, Lk] or none; out [BH, Lq, DV] bf16 and the
// row logsumexp [BH, Lq] f32 for the backward. D and DV in {64, 128, 256}
// (every head count 1 / 2 / 4 of d_model 256, and one head over raw memory
// of 64, 128 or 256 channels), any Lq and any Lk: the last query and key
// tiles are zero-filled and masked (no padding of the keys to 256 with a
// -1e9 bias, no padding of v to 128 lanes, as the TPU wrapper does).
// Like the TPU kernel it runs in f32 inside: q, k, v and dout are bf16 (their
// products are exact in f32), the statistics are f32 with an online softmax
// over key tiles, and the f32 values that feed a tensor-core product (the
// probabilities p and the score gradients ds) go in as a bf16 high part and
// a bf16 remainder (common.cuh split2), two products each, so the tensor
// cores see them to ~16 bits. Outputs are rounded once.
//
// What bounds it on an H100 (8 objects x 2 heads, 576 queries, up to 4096
// keys, D = DV = 128): ~29 GFLOP of tensor-core products per forward call
// (QK^T once, PV twice for hi and lo) against ~40 MB of q, k, v and output,
// so the tensor cores bound it, and the design is about keeping them fed:
//   - one warpgroup (128 threads) owns 64 query rows; every product is a
//     wgmma (sm90.cuh): S = Q K^T with both operands in shared memory, and
//     P V with p's hi and lo parts in registers into the same f32
//     accumulator; tiles are 128-byte swizzled, so nothing is transposed;
//   - K and V tiles (64 keys) stream through a two-stage cp.async ring: the
//     copy of tile j + 1 is in flight while tile j is multiplied, with one
//     __syncthreads() per tile;
//   - the keys are split across blocks (grid (q tiles, BH, S)): the path's
//     9 x 16 = 144 query tiles are too few for 132 SMs (two blocks each), so
//     each of S splits runs ~ceil(tiles / S) key tiles and writes its
//     unnormalised f32 accumulator with its row max and sum; a combine
//     kernel merges the splits in split order (the same bits from run to
//     run) into the bf16 output and the f32 lse. S = 1 writes them directly.
//     The wrapper (ops/flash_attention.py split_tiles) picks S.
//
// Backward: the TPU kernel's single ordered sweep carries dq across key
// blocks in VMEM. Blocks run in parallel here, so it is two passes:
//   dq:  per (64 queries, batch-head and 128 columns of dq, key split), over
//        the split's key tiles (the same cp.async ring): s = Q K^T and
//        dp = dout V^T (wgmma, shared memory), p from the saved lse,
//        ds = p (dp - delta), dq += ds K (ds hi + lo from registers); with
//        S > 1 the f32 partials are summed in split order by a combine;
//   dkv: per (64 keys, batch-head, 128 columns of dk / dv), over all query
//        tiles (a cp.async ring of q, dout, lse, delta): s^T = K Q^T,
//        dp^T = V dout^T, dv += p^T dout, dk += ds^T q, dk and dv held in
//        registers for the whole sweep;
// with delta = rowsum(dout * out) from a first small kernel. No float
// atomics: two runs give the same bits. The key bias gets no gradient.
// The two passes recompute q k^T and dout v^T, and p / ds enter three
// products as hi + lo: ~97 GFLOP per backward call at the path's shape,
// twice a one-pass bf16 backward's, so the tensor cores bound it too.
// Each pass issues its second product group while the first group's
// softmax arithmetic runs.

#include "common.cuh"
#include "sm90.cuh"

constexpr int FA_THREADS = 128;      // one warpgroup: 4 warps x 16 rows
constexpr int TQ = 64;               // queries per tile
constexpr int TK = 64;               // keys per tile
constexpr int STAGES = 2;            // depth of the cp.async ring
constexpr int COLS = 128;            // dq / dk / dv columns per block

// blocks per SM the launch bounds ask for: two at widths up to 128 (shared
// memory and 255 registers allow it), one at 256
template <int D, int DV>
constexpr int fa_min_blocks() { return (D <= 128 && DV <= 128) ? 2 : 1; }

// the key range [t0, t1) of tiles of split blockIdx.z
__device__ __forceinline__ void split_range(int Lk, int tiles_per_split,
                                            int& t0, int& t1) {
  const int ntiles = (Lk + TK - 1) / TK;
  t0 = blockIdx.z * tiles_per_split;
  t1 = min(ntiles, t0 + tiles_per_split);
}

// ---------------------------------------------------------------------------
// Forward: grid (ceil(Lq / 64), BH, S)
// ---------------------------------------------------------------------------

template <int D, int DV>
struct FwdSmem {
  static constexpr int Q = 0;
  static constexpr int K = Q + D * 128;
  static constexpr int V = K + STAGES * D * 128;
  static constexpr int BIAS = V + STAGES * DV * 128;
  static constexpr int BYTES = BIAS + STAGES * TK * 4 + 1024;
};

// out / lse when part is null; else the split's unnormalised f32 output
// part[split][BH][Lq][DV] and its (row max, row sum) pairs after all S
// splits' outputs
template <int D, int DV>
__global__ void __launch_bounds__(FA_THREADS, (fa_min_blocks<D, DV>()))
fa_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const float* __restrict__ bias,
              long bias_bz, bf16* __restrict__ out, float* __restrict__ lse,
              float* __restrict__ part, int Lq, int Lk, int tiles_per_split,
              float scale) {
  using SM = FwdSmem<D, DV>;
  constexpr int OC = DV < COLS ? DV : COLS;   // columns per P V product
  constexpr int NOC = DV / OC;
  extern __shared__ unsigned char fa_smem[];
  unsigned char* gen;
  const uint32_t sm = aligned_smem(fa_smem, &gen);
  const float* bias_s = reinterpret_cast<const float*>(gen + SM::BIAS);

  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2;
  const int b = blockIdx.y, q0 = blockIdx.x * TQ;
  int t0, t1;
  split_range(Lk, tiles_per_split, t0, t1);
  const bf16* kb = k + (size_t)b * Lk * D;
  const bf16* vb = v + (size_t)b * Lk * DV;
  const float* bb = bias ? bias + (size_t)b * bias_bz : nullptr;

  auto load = [&](int t, int st) {
    stage_tile<D>(sm + SM::K + st * D * 128, kb, t * TK, Lk);
    stage_tile<DV>(sm + SM::V + st * DV * 128, vb, t * TK, Lk);
    if (bb) stage_row_f32(sm + SM::BIAS + st * TK * 4, bb, t * TK, Lk);
  };
  stage_tile<D>(sm + SM::Q, q + (size_t)b * Lq * D, q0, Lq);
  load(t0, 0);
  cp_async_commit();

  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float o[NOC][OC / 2];
#pragma unroll
  for (int c = 0; c < NOC; ++c) zero(o[c]);

  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) % STAGES;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();                 // tile t landed; tile t - 1 consumed
    if (t + 1 < t1) load(t + 1, (t + 1 - t0) % STAGES);
    cp_async_commit();

    const uint32_t Ks = sm + SM::K + st * D * 128;
    const uint32_t Vs = sm + SM::V + st * DV * 128;
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_k(sm + SM::Q, kk * 16), desc_k(Ks, kk * 16),
                   kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    const float* bs = bias_s + st * TK;
    const int kmax = Lk - t * TK;    // valid keys of this tile
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = acc_col(i);
      s[i] = c < kmax ? s[i] * scale + (bb ? bs[c] : 0.f) : -INFINITY;
    }
    // online softmax, rows g (h = 0) and g + 8 (h = 1)
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
    for (int c = 0; c < NOC; ++c)
#pragma unroll
      for (int i = 0; i < OC / 2; ++i) o[c][i] *= alpha[(i >> 1) & 1];

    // o += p v, p as hi + lo
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_split(s, kk, ph[kk], pl[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < NOC; ++c) {
        const uint64_t dv = desc_mn(Vs, kk * 16, c * OC);
        wgmma_rs<OC>(o[c], ph[kk], dv);
        wgmma_rs<OC>(o[c], pl[kk], dv);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NOC; ++c) fence_regs(o[c]);
  }

  const int rows_left = Lq - q0;
  const int BH = gridDim.y;
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  if (!part) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float inv = 1.f / l[h];
#pragma unroll
      for (int c = 0; c < NOC; ++c)
#pragma unroll
        for (int i = 0; i < OC / 2; ++i)
          if (((i >> 1) & 1) == h) o[c][i] *= inv;
    }
    bf16* ob = out + ((size_t)b * Lq + q0) * DV;
#pragma unroll
    for (int c = 0; c < NOC; ++c)
      store_bf16<OC>(o[c], ob + c * OC, DV, rows_left, 1.f);
    if ((tid & 3) == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        if (r < rows_left)
          lse[(size_t)b * Lq + q0 + r] = m[h] + logf(l[h]);
      }
    return;
  }
  const size_t prow = ((size_t)blockIdx.z * BH + b) * Lq + q0;
#pragma unroll
  for (int c = 0; c < NOC; ++c)
    store_f32<OC>(o[c], part + prow * DV + c * OC, DV, rows_left);
  float2* ml = reinterpret_cast<float2*>(part + (size_t)gridDim.z * BH * Lq * DV);
  if ((tid & 3) == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + 8 * h;
      if (r < rows_left) ml[prow + r] = make_float2(m[h], l[h]);
    }
}

// ---------------------------------------------------------------------------
// Backward pass 1, dq: grid (ceil(Lq / 64), BH * D / DQC, S)
// ---------------------------------------------------------------------------

template <int D, int DV>
struct DqSmem {
  static constexpr int Q = 0;
  static constexpr int DO = Q + D * 128;
  static constexpr int K = DO + DV * 128;
  static constexpr int V = K + STAGES * D * 128;
  static constexpr int BIAS = V + STAGES * DV * 128;
  static constexpr int BYTES = BIAS + STAGES * TK * 4 + 1024;
};

// dq (bf16, scaled) when part is null; else the split's f32 dq partial
// part[split][BH][Lq][D] (unscaled)
template <int D, int DV>
__global__ void __launch_bounds__(FA_THREADS, (fa_min_blocks<D, DV>()))
fa_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const float* __restrict__ bias,
             long bias_bz, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, float* __restrict__ part, int Lq, int Lk,
             int tiles_per_split, float scale) {
  using SM = DqSmem<D, DV>;
  constexpr int DQC = D < COLS ? D : COLS;
  constexpr int NZ = D / DQC;
  extern __shared__ unsigned char fa_smem[];
  unsigned char* gen;
  const uint32_t sm = aligned_smem(fa_smem, &gen);
  const float* bias_s = reinterpret_cast<const float*>(gen + SM::BIAS);

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int b = blockIdx.y / NZ, c0 = (blockIdx.y % NZ) * DQC;
  const int BH = gridDim.y / NZ, q0 = blockIdx.x * TQ;
  int t0, t1;
  split_range(Lk, tiles_per_split, t0, t1);
  const bf16* kb = k + (size_t)b * Lk * D;
  const bf16* vb = v + (size_t)b * Lk * DV;
  const float* bb = bias ? bias + (size_t)b * bias_bz : nullptr;

  auto load = [&](int t, int st) {
    stage_tile<D>(sm + SM::K + st * D * 128, kb, t * TK, Lk);
    stage_tile<DV>(sm + SM::V + st * DV * 128, vb, t * TK, Lk);
    if (bb) stage_row_f32(sm + SM::BIAS + st * TK * 4, bb, t * TK, Lk);
  };
  stage_tile<D>(sm + SM::Q, q + (size_t)b * Lq * D, q0, Lq);
  stage_tile<DV>(sm + SM::DO, dout + (size_t)b * Lq * DV, q0, Lq);
  load(t0, 0);
  cp_async_commit();

  float lse_r[2], del_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    lse_r[h] = row < Lq ? lse[(size_t)b * Lq + row] : INFINITY;
    del_r[h] = row < Lq ? delta[(size_t)b * Lq + row] : 0.f;
  }
  float acc[DQC / 2];
  zero(acc);

  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) % STAGES;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (t + 1 < t1) load(t + 1, (t + 1 - t0) % STAGES);
    cp_async_commit();

    const uint32_t Ks = sm + SM::K + st * D * 128;
    const uint32_t Vs = sm + SM::V + st * DV * 128;
    // s = q k^T and dp = dout v^T in two groups: p is computed while dp's
    // products run
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_k(sm + SM::Q, kk * 16), desc_k(Ks, kk * 16),
                   kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk)
      wgmma_ss_n64(dp, desc_k(sm + SM::DO, kk * 16), desc_k(Vs, kk * 16),
                   kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    const float* bs = bias_s + st * TK;
    const int kmax = Lk - t * TK;
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
      const uint64_t dk = desc_mn(Ks, kk * 16, c0);
      wgmma_rs<DQC>(acc, dh[kk], dk);
      wgmma_rs<DQC>(acc, dl[kk], dk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  const int rows_left = Lq - q0;
  if (!part) {
    store_bf16<DQC>(acc, dq + ((size_t)b * Lq + q0) * D + c0, D, rows_left,
                    scale);
    return;
  }
  store_f32<DQC>(acc, part + (((size_t)blockIdx.z * BH + b) * Lq + q0) * D + c0,
                 D, rows_left);
}

// ---------------------------------------------------------------------------
// Backward pass 2, dk / dv: grid (ceil(Lk / 64), BH, NZ); block z owns
// columns z * 128 .. of dk (if z < D / 128) and of dv (if z < DV / 128)
// ---------------------------------------------------------------------------

template <int D, int DV>
struct DkvSmem {
  static constexpr int K = 0;
  static constexpr int V = K + D * 128;
  static constexpr int Q = V + DV * 128;
  static constexpr int DO = Q + STAGES * D * 128;
  static constexpr int LSE = DO + STAGES * DV * 128;
  static constexpr int DEL = LSE + STAGES * TQ * 4;
  static constexpr int BYTES = DEL + STAGES * TQ * 4 + 1024;
};

template <int D, int DV>
__global__ void __launch_bounds__(FA_THREADS, (fa_min_blocks<D, DV>()))
fa_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const float* __restrict__ bias,
              long bias_bz, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int Lq, int Lk,
              float scale) {
  using SM = DkvSmem<D, DV>;
  constexpr int DKC = D < COLS ? D : COLS;
  constexpr int DVC = DV < COLS ? DV : COLS;
  extern __shared__ unsigned char fa_smem[];
  unsigned char* gen;
  const uint32_t sm = aligned_smem(fa_smem, &gen);
  const float* lse_s = reinterpret_cast<const float*>(gen + SM::LSE);
  const float* del_s = reinterpret_cast<const float*>(gen + SM::DEL);

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int b = blockIdx.y, k0 = blockIdx.x * TK, z = blockIdx.z;
  const bool do_dk = z * DKC < D, do_dv = z * DVC < DV;
  const int ck = do_dk ? z * DKC : 0, cv = do_dv ? z * DVC : 0;
  const bf16* qb = q + (size_t)b * Lq * D;
  const bf16* dob = dout + (size_t)b * Lq * DV;
  const float* lb = lse + (size_t)b * Lq;
  const float* db = delta + (size_t)b * Lq;

  auto load = [&](int t, int st) {
    stage_tile<D>(sm + SM::Q + st * D * 128, qb, t * TQ, Lq);
    stage_tile<DV>(sm + SM::DO + st * DV * 128, dob, t * TQ, Lq);
    stage_row_f32(sm + SM::LSE + st * TQ * 4, lb, t * TQ, Lq);
    stage_row_f32(sm + SM::DEL + st * TQ * 4, db, t * TQ, Lq);
  };
  stage_tile<D>(sm + SM::K, k + (size_t)b * Lk * D, k0, Lk);
  stage_tile<DV>(sm + SM::V, v + (size_t)b * Lk * DV, k0, Lk);
  load(0, 0);
  cp_async_commit();

  float bias_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + warp * 16 + g + 8 * h;
    bias_r[h] = key < Lk ? (bias ? bias[(size_t)b * bias_bz + key] : 0.f)
                         : -INFINITY;
  }
  float dka[DKC / 2], dva[DVC / 2];
  zero(dka);
  zero(dva);

  const int nq = (Lq + TQ - 1) / TQ;
  for (int t = 0; t < nq; ++t) {
    const int st = t % STAGES;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (t + 1 < nq) load(t + 1, (t + 1) % STAGES);
    cp_async_commit();

    const uint32_t Qs = sm + SM::Q + st * D * 128;
    const uint32_t dOs = sm + SM::DO + st * DV * 128;
    // s^T = k q^T and dp^T = v dout^T, [64 keys x 64 queries], in two
    // groups; p^T is computed and dv += p^T dout issued while dp^T's
    // products run, then ds^T split while dv's run, then dk += ds^T q
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_k(sm + SM::K, kk * 16), desc_k(Qs, kk * 16),
                   kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk)
      wgmma_ss_n64(dp, desc_k(sm + SM::V, kk * 16), desc_k(dOs, kk * 16),
                   kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    const float* ls = lse_s + st * TQ;
    const float* ds_ = del_s + st * TQ;
    const int qmax = Lq - t * TQ;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = acc_col(i), h = (i >> 1) & 1;
      s[i] = c < qmax ? expf(s[i] * scale + bias_r[h] - ls[c]) : 0.f;  // p^T
    }
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_split(s, kk, ph[kk], pl[kk]);
    wgmma_fence();
    if (do_dv)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t d = desc_mn(dOs, kk * 16, cv);
        wgmma_rs<DVC>(dva, ph[kk], d);
        wgmma_rs<DVC>(dva, pl[kk], d);
      }
    wgmma_commit();
    wgmma_wait<1>();                                  // dp^T landed
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp[i] = s[i] * (dp[i] - ds_[acc_col(i)]);       // ds^T
    uint32_t dh[4][4], dl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_split(dp, kk, dh[kk], dl[kk]);
    wgmma_fence();
    if (do_dk)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t d = desc_mn(Qs, kk * 16, ck);
        wgmma_rs<DKC>(dka, dh[kk], d);
        wgmma_rs<DKC>(dka, dl[kk], d);
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
  }

  const int rows_left = Lk - k0;
  if (do_dv)
    store_bf16<DVC>(dva, dv + ((size_t)b * Lk + k0) * DV + cv, DV, rows_left,
                    1.f);
  if (do_dk)
    store_bf16<DKC>(dka, dk + ((size_t)b * Lk + k0) * D + ck, D, rows_left,
                    scale);
}

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------

#define FA_WIDTHS(X) \
  X(64, 64) X(64, 128) X(64, 256) X(128, 64) X(128, 128) X(128, 256) \
  X(256, 64) X(256, 128) X(256, 256)

template <class Kernel>
static int set_smem(Kernel* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

static int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int D, int DV>
static int fwd_launch(const bf16* q, const bf16* k, const bf16* v,
                      const float* bias, long bias_bz, bf16* out, float* lse,
                      float* part, int BH, int Lq, int Lk, int tps,
                      cudaStream_t st) {
  const int S = cdiv(cdiv(Lk, TK), tps);
  const size_t smem = FwdSmem<D, DV>::BYTES;
  const int err = set_smem(fa_fwd_kernel<D, DV>, smem);
  if (err) return err;
  dim3 grid(cdiv(Lq, TQ), BH, S);
  fa_fwd_kernel<D, DV><<<grid, FA_THREADS, smem, st>>>(
      q, k, v, bias, bias_bz, out, lse, S > 1 ? part : nullptr, Lq, Lk, tps,
      1.0f / sqrtf((float)D));
  if (S > 1)
    fa_combine_kernel<DV><<<cdiv(BH * Lq, 4), 128, 0, st>>>(part, S, BH * Lq,
                                                           out, lse);
  return (int)cudaGetLastError();
}

template <int D, int DV>
static int bwd_launch(const bf16* q, const bf16* k, const bf16* v,
                      const float* bias, long bias_bz, const bf16* out,
                      const float* lse, const bf16* dout, bf16* dq, bf16* dk,
                      bf16* dv, float* delta, float* part, int BH, int Lq,
                      int Lk, int tps, cudaStream_t st) {
  constexpr int NQ = D < COLS ? 1 : D / COLS;
  constexpr int NZ = (D > DV ? D : DV) < COLS ? 1 : (D > DV ? D : DV) / COLS;
  const float scale = 1.0f / sqrtf((float)D);
  const int rows = BH * Lq, S = cdiv(cdiv(Lk, TK), tps);
  fa_delta_kernel<<<cdiv(rows, 4), 128, 0, st>>>(dout, out, delta, rows, DV);

  const size_t smem_dq = DqSmem<D, DV>::BYTES;
  int err = set_smem(fa_dq_kernel<D, DV>, smem_dq);
  if (err) return err;
  dim3 gq(cdiv(Lq, TQ), BH * NQ, S);
  fa_dq_kernel<D, DV><<<gq, FA_THREADS, smem_dq, st>>>(
      q, k, v, bias, bias_bz, dout, lse, delta, dq, S > 1 ? part : nullptr,
      Lq, Lk, tps, scale);
  if (S > 1) {
    const long n = (long)rows * D;
    const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    fa_dq_combine_kernel<<<blocks, 256, 0, st>>>(part, S, n, scale, dq);
  }

  const size_t smem_kv = DkvSmem<D, DV>::BYTES;
  err = set_smem(fa_dkv_kernel<D, DV>, smem_kv);
  if (err) return err;
  dim3 gk(cdiv(Lk, TK), BH, NZ);
  fa_dkv_kernel<D, DV><<<gk, FA_THREADS, smem_kv, st>>>(
      q, k, v, bias, bias_bz, dout, lse, delta, dk, dv, Lq, Lk, scale);
  return (int)cudaGetLastError();
}

// q [BH, Lq, D], k [BH, Lk, D], v [BH, Lk, DV] bf16; bias [BH or 1, Lk] f32
// (batch stride bias_bz) or null. out [BH, Lq, DV] bf16, lse [BH, Lq] f32.
// tiles_per_split: 64-key tiles per split, S = ceil(ceil(Lk / 64) / it);
// with S > 1, part is the caller's f32 scratch of S * BH * Lq * (DV + 2).
// Returns a CUDA error code; cudaErrorInvalidValue for other widths.
extern "C" int fa_fwd(const void* q, const void* k, const void* v,
                      const void* bias, long bias_bz, void* out, void* lse,
                      void* part, int BH, int Lq, int Lk, int D, int DV,
                      int tiles_per_split, void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v);
  const float* bf = static_cast<const float*>(bias);
  if (tiles_per_split < 1) return (int)cudaErrorInvalidValue;
  switch (D * 1024 + DV) {
#define FA_CASE(D_, DV_)                                                    \
  case D_ * 1024 + DV_:                                                     \
    return fwd_launch<D_, DV_>(qb, kb, vb, bf, bias_bz, static_cast<bf16*>(out), \
                             static_cast<float*>(lse),                      \
                             static_cast<float*>(part), BH, Lq, Lk,         \
                             tiles_per_split, st);
    FA_WIDTHS(FA_CASE)
#undef FA_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// gradients dq [BH, Lq, D], dk [BH, Lk, D], dv [BH, Lk, DV] bf16; delta:
// the caller's [BH, Lq] f32 scratch for rowsum(dout * out); with S > 1
// (tiles_per_split as in fa_fwd) part: f32 scratch of S * BH * Lq * D
extern "C" int fa_bwd(const void* q, const void* k, const void* v,
                      const void* bias, long bias_bz, const void* out,
                      const void* lse, const void* dout, void* dq, void* dk,
                      void* dv, void* delta, void* part, int BH, int Lq,
                      int Lk, int D, int DV, int tiles_per_split,
                      void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v);
  const float* bf = static_cast<const float*>(bias);
  if (tiles_per_split < 1) return (int)cudaErrorInvalidValue;
  switch (D * 1024 + DV) {
#define FA_CASE(D_, DV_)                                                     \
  case D_ * 1024 + DV_:                                                      \
    return bwd_launch<D_, DV_>(                                                \
        qb, kb, vb, bf, bias_bz, static_cast<const bf16*>(out),              \
        static_cast<const float*>(lse), static_cast<const bf16*>(dout),      \
        static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), \
        static_cast<float*>(delta), static_cast<float*>(part), BH, Lq, Lk,   \
        tiles_per_split, st);
    FA_WIDTHS(FA_CASE)
#undef FA_CASE
  }
  return (int)cudaErrorInvalidValue;
}
