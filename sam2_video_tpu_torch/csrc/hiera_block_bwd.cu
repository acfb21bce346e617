// Hiera block backward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel sam2_video_tpu/ops/hiera_block_bwd.py
// fused_block_trainable (Pallas _mlp_bwd_kernel, B1, and _attn_bwd_kernel,
// B2): the block's backward from its input x and the residual after
// attention, x1, which the forward (hiera_block.cu) keeps.
//   B1: recompute LN2 -> W1 -> exact-erf GELU from x1, then dx1 = dy +
//     LN2^T(...) and the LN2, W1, b1, W2, b2 gradients;
//   B2: recompute LN1 -> qkv (-> shortcut) and the attention, then dx and
//     the LN1, qkv, proj and (dim-change blocks) shortcut gradients.
//
// What bounds it on an H100 (SAM2-tiny, 384 px, 10 frames per call): about
// three times the forward's products (the recompute, then two products per
// forward product), ~0.78 TFLOP over the 12 blocks against a few hundred
// MB of activations, so the tensor cores bound it; ~90% of the products are
// dense (the projections and the MLP), the rest the window attention. The
// design:
//   - every dense product is a wgmma GEMM of sm90_gemm.cuh (cp.async ring,
//     128 x 128 tiles, 64 x 128 for the weight gradients), grouped where
//     the products are independent, with the element-wise work in its
//     epilogue: b1, GELU and the stored pre-activation on the W1 product;
//     GELU' on dh = dy W2; the bias walk of kernel #1 on qkv and the
//     shortcut; dxn = dqkv Wqkv + ds Wsc as one sum. No f32 [rows x
//     hidden] buffer: a, h and dh are bf16 (the reference's own rounding
//     points), dy_ln and dxn f32 [rows x C];
//   - weight gradients are K-split GEMMs over all rows with the bias
//     gradients as column sums of the staged rows (sm90_gemm.cuh), the
//     LayerNorm gradients per-block partials of the LayerNorm backward,
//     and one ordered reduce adds every partial of both halves (no float
//     atomics: two runs give the same bits);
//   - the attention backward is flash style on wgmma in three kernels per
//     (group, head, 64-row tile): forward statistics with the output O and
//     D = rowsum(dO * O); dq over key tiles; dk and dv over query tiles,
//     held in registers. Where a group's keys fit one tile, one kernel
//     forms S and dP once for the statistics, O and dq (attn_onepass), then
//     the dk / dv kernel. Hiera's windows are small (16-196 keys), so
//     several windows share a 64-row tile (block-diagonal mask: 4 windows
//     of 16 tokens, 16 pooled windows of 4 queries over 16 keys); the
//     head dim (96) is zero-padded to 128 in shared memory.
//   - attention runs on the zero-padded token grid: LN1's output is
//     written with zero rows at the pad tokens, so qkv there is the bias
//     (the reference pads after norm1) and pad keys are ordinary rows whose
//     dk and dv land in dqkv; the qkv bias gradient, a column sum of dqkv
//     over every row of the padded grid, takes them, and dWqkv, whose
//     other operand is zero there, does not.
//
// Semantics kept from the TPU kernel: pad queries and cropped pooled
// queries get no gradient; the 2x2 max-pool backward (q-pool and the
// dim-change shortcut) routes each cell's gradient as JAX's
// _unpool2x2_rows_cols does: to the column whose row-pair max is larger,
// then to the larger row of that column, the first on a tie.
//
// The geometry, the forward's attention passes and the LayerNorm forward
// are kernel #1's (hiera_attn.cuh): the recompute forms xn, qkv and O as
// the forward does, bit for bit.
//
// The C entry point launches its kernels in order on the caller's stream,
// carves its scratch from one workspace the caller allocates (its size
// from hiera_bwd_workspace_bytes) and returns the first CUDA error.

#include "hiera_attn.cuh"
#include "sm90_gemm.cuh"

// ---------------------------------------------------------------------------
// dq over several key tiles: grid (qtiles, heads, ngroups). Per key tile:
// s = Q K^T and dp = dO V^T (two product groups), p from the statistics,
// ds = p (dp - D) scale rounded to bf16 (the reference's walk), dq += ds K.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(AT_THREADS, 2)
attn_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
               const float4* __restrict__ stats, bf16* __restrict__ dqkv,
               const HGeo g) {
  using SM = AfSmem;
  extern __shared__ unsigned char at_smem[];
  unsigned char* gen;
  const uint32_t sm = aligned_smem(at_smem, &gen);
  const int qt = blockIdx.x, h = blockIdx.y, grp = blockIdx.z;
  const long C3 = 3L * g.C;
  const bf16* qb = qkv + h * g.hd;
  const bf16* kb = qb + g.C;
  const bf16* vb = kb + g.C;
  const int q0 = qt * AT_ROWS;
  int* ktab = reinterpret_cast<int*>(gen + SM::TAB);
  int* qtab = ktab + g.ktiles * AT_ROWS;
  int* ttab = qtab + AT_ROWS;
  fill_keys(ktab, g, grp, 0, g.ktiles * AT_ROWS);
  fill_queries(qtab, ttab, g, grp, q0, AT_ROWS);
  __syncthreads();

  stage_queries(sm + SM::Q, gen + SM::Q, qb, g, qtab);
  stage_rows(sm + SM::DO, dout + h * g.hd, g.C, g.hd, ttab);
  auto load = [&](int kt) {
    const int st = kt & 1;
    stage_rows(sm + SM::K + st * AT_TILE, kb, C3, g.hd, ktab + kt * AT_ROWS);
    stage_rows(sm + SM::V + st * AT_TILE, vb, C3, g.hd, ktab + kt * AT_ROWS);
  };
  load(0);
  cp_async_commit();

  const int lr = acc_row();
  const int2 kr[2] = {key_range(g, grp, q0 + lr), key_range(g, grp, q0 + lr + 8)};
  const long sb = stat_base(g, grp, h, qt);
  const float4 sr[2] = {__ldg(stats + sb + lr), __ldg(stats + sb + lr + 8)};

  float dq[64];
  zero(dq);
  for (int kt = 0; kt < g.ktiles; ++kt) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (kt + 1 < g.ktiles) load(kt + 1);
    cp_async_commit();
    const int st = kt & 1;
    const uint32_t Ks = sm + SM::K + st * AT_TILE;
    float s[32], dp[32];
    wgmma_fence();
    issue_scores(s, sm + SM::Q, Ks);
    wgmma_commit();
    issue_scores(dp, sm + SM::DO, sm + SM::V + st * AT_TILE);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
    mask_rows(s, kt * AT_ROWS, kr, g.sl);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      s[i] = exp2f(s[i] - sr[hh].x) * sr[hh].y;     // p
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      s[i] = s[i] * (dp[i] - sr[hh].z) * g.scale;  // ds
    }
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_bf16(s, kk, da[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n128(dq, da[kk], desc_mn(Ks, kk * 16, 0), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
  }
  store_dq(dq, dqkv, qb, qtab, g, h);
}

// ---------------------------------------------------------------------------
// dk, dv: grid (ktiles, heads, ngroups). K and V of the tile stay in shared
// memory; per query tile (a two-stage ring of Q, dO and the statistics):
// s^T = K Q^T, dp^T = V dO^T, p^T from the statistics, dv += bf16(p^T) dO,
// ds^T = p^T (dp^T - D) scale, dk += bf16(ds^T) Q; dk and dv in registers.
// They go into columns C + h hd .. and 2C + h hd .. of dqkv at each key's
// token of the padded grid (pad keys included).
// ---------------------------------------------------------------------------

struct AkSmem {
  static constexpr int K = 0, V = AT_TILE, Q = 2 * AT_TILE;   // Q, dO:
  static constexpr int DO = 4 * AT_TILE;                        // two stages
  static constexpr int ST = 6 * AT_TILE;                        // stats ring
  static constexpr int TAB = ST + 2 * AT_ROWS * 16;   // keys, queries, tokens
  static int bytes(int qtiles) {
    return TAB + (1 + 2 * qtiles) * AT_ROWS * 4 + 1024;
  }
};

__global__ void __launch_bounds__(AT_THREADS, 2)
attn_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                const float4* __restrict__ stats, bf16* __restrict__ dqkv,
                const HGeo g) {
  using SM = AkSmem;
  extern __shared__ unsigned char at_smem[];
  unsigned char* gen;
  const uint32_t sm = aligned_smem(at_smem, &gen);
  const int kt = blockIdx.x, h = blockIdx.y, grp = blockIdx.z;
  const int tid = threadIdx.x, q4 = tid & 3;
  const long C3 = 3L * g.C;
  const bf16* qb = qkv + h * g.hd;
  const int c0 = kt * AT_ROWS;
  int* ktab = reinterpret_cast<int*>(gen + SM::TAB);
  int* qtab = ktab + AT_ROWS;
  int* ttab = qtab + g.qtiles * AT_ROWS;
  fill_keys(ktab, g, grp, c0, AT_ROWS);
  fill_queries(qtab, ttab, g, grp, 0, g.qtiles * AT_ROWS);
  __syncthreads();

  stage_rows(sm + SM::K, qb + g.C, C3, g.hd, ktab);
  stage_rows(sm + SM::V, qb + 2 * g.C, C3, g.hd, ktab);
  auto load = [&](int qt) {
    const int st = qt & 1;
    stage_queries(sm + SM::Q + st * AT_TILE, gen + SM::Q + st * AT_TILE, qb, g,
                  qtab + qt * AT_ROWS);
    stage_rows(sm + SM::DO + st * AT_TILE, dout + h * g.hd, g.C, g.hd,
               ttab + qt * AT_ROWS);
    if (tid < AT_ROWS)
      cp_async16(sm + SM::ST + st * AT_ROWS * 16 + 16 * tid,
                 stats + stat_base(g, grp, h, qt) + tid, true);
  };
  load(0);
  cp_async_commit();

  const int lr = acc_row();
  const int2 qr[2] = {query_range(g, grp, c0 + lr),
                      query_range(g, grp, c0 + lr + 8)};
  float dk[64], dv[64];
  zero(dk);
  zero(dv);
  for (int qt = 0; qt < g.qtiles; ++qt) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (qt + 1 < g.qtiles) load(qt + 1);
    cp_async_commit();
    const int st = qt & 1;
    const uint32_t Qs = sm + SM::Q + st * AT_TILE;
    const uint32_t dOs = sm + SM::DO + st * AT_TILE;
    const float4* ss =
        reinterpret_cast<const float4*>(gen + SM::ST + st * AT_ROWS * 16);
    float s[32], dp[32];
    wgmma_fence();
    issue_scores(s, sm + SM::K, Qs);
    wgmma_commit();
    issue_scores(dp, sm + SM::V, dOs);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = acc_col(i), r = qt * AT_ROWS + col, hh = (i >> 1) & 1;
      const float4 sv = ss[col];
      s[i] = r >= qr[hh].x && r < qr[hh].y
                 ? exp2f(s[i] * g.sl - sv.x) * sv.y : 0.f;   // p^T
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_bf16(s, kk, pa[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n128(dv, pa[kk], desc_mn(dOs, kk * 16, 0), 1);
    wgmma_commit();
    wgmma_wait<1>();                 // dp^T landed
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp[i] = s[i] * (dp[i] - ss[acc_col(i)].z) * g.scale;   // ds^T
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_bf16(dp, kk, da[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n128(dk, da[kk], desc_mn(Qs, kk * 16, 0), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const long row = ktab[lr + 8 * hh];
    if (row < 0) continue;
    bf16* dst = dqkv + row * C3 + g.C + h * g.hd;
#pragma unroll
    for (int n = 0; n < AT_COLS / 8; ++n) {
      const int col = 8 * n + 2 * q4;
      if (col >= g.hd) continue;
      *reinterpret_cast<uint32_t*>(dst + col) =
          bf2(dk[4 * n + 2 * hh], dk[4 * n + 2 * hh + 1]);
      *reinterpret_cast<uint32_t*>(dst + g.C + col) =
          bf2(dv[4 * n + 2 * hh], dv[4 * n + 2 * hh + 1]);
    }
  }
}

constexpr int LB_WARPS = 4;          // warps per block, a row each in turn
constexpr int LB_BLOCKS = 1056;      // at most (8 an SM), so the partials stay few

// rows per block of the LayerNorm backward: a multiple of LB_WARPS, at
// most LB_BLOCKS blocks
static long ln_rpb(long rows) {
  long r = (rows + LB_BLOCKS - 1) / LB_BLOCKS;
  return (r + LB_WARPS - 1) / LB_WARPS * LB_WARPS;
}

static long ln_blocks(long rows) {
  return (rows + ln_rpb(rows) - 1) / ln_rpb(rows);
}

// dx [rows, C] (grid rows) = LN'(dyl at the padded row) + res, bf16, dyl
// the sum of np f32 partials pstride apart (added in order); block
// b takes rows b rpb .. (b + 1) rpb - 1, warp w every LB_WARPS-th from w;
// part[b][2C]: the column sums over them of dyl xhat (the LN weight's
// gradient) and of dyl (its bias'), each in a fixed order. Every load of
// a row is issued before its first store (a load after a store waits for
// it: one memory round trip per row, not one per value).
template <int PER>
__global__ void __launch_bounds__(LB_WARPS * 32)
ln_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ dyl, int np, long pstride,
              RowMap map,
              const bf16* __restrict__ res, bf16* __restrict__ dx,
              float* __restrict__ part, long rows, long rpb, int C) {
  __shared__ float red[LB_WARPS][2 * PER * 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float pw[PER], pb[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) pw[i] = pb[i] = 0.f;
  const long r_end = (blockIdx.x + 1) * rpb < rows ? (blockIdx.x + 1) * rpb
                                                   : rows;
  for (long r = (long)blockIdx.x * rpb + warp; r < r_end; r += LB_WARPS) {
    const long pr = map.padded(r);
    float xv[PER], dv[PER], rv[PER], s = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = lane + 32 * i;
      xv[i] = c < C ? to_f32(x[r * C + c]) : 0.f;
      dv[i] = c < C ? dyl[pr * C + c] : 0.f;
      rv[i] = c < C && res ? to_f32(res[r * C + c]) : 0.f;
      s += xv[i];
    }
    for (int p = 1; p < np; ++p)       // the other partials, in order
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int c = lane + 32 * i;
        if (c < C) dv[i] += dyl[p * pstride + pr * C + c];
      }
    const float mu = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = lane + 32 * i;
      const float d = c < C ? xv[i] - mu : 0.f;
      q += d * d;
    }
    const float rinv = rsqrtf(warp_sum(q) / C + HB_EPS);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = lane + 32 * i;
      xv[i] = (xv[i] - mu) * rinv;                   // xhat
      pw[i] += dv[i] * xv[i];
      pb[i] += dv[i];
      dv[i] *= c < C ? __ldg(w + c) : 0.f;          // dxh
      s1 += dv[i];
      s2 += dv[i] * xv[i];
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = lane + 32 * i;
      if (c < C)
        dx[r * C + c] = to_bf16(rinv * (dv[i] - m1 - xv[i] * m2) + rv[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    red[warp][lane + 32 * i] = pw[i];
    red[warp][PER * 32 + lane + 32 * i] = pb[i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * C; e += LB_WARPS * 32) {
    const int src = e < C ? e : PER * 32 + e - C;
    float t = 0.f;
#pragma unroll
    for (int v = 0; v < LB_WARPS; ++v) t += red[v][src];
    part[(size_t)blockIdx.x * 2 * C + e] = t;
  }
}

static void ln_bwd(const bf16* x, const float* w, const float* dyl, int np,
                   long pstride, RowMap map, const bf16* res, bf16* dx,
                   float* part, long rows, int C, cudaStream_t st) {
  const unsigned blocks = (unsigned)ln_blocks(rows);
  const long rpb = ln_rpb(rows);
  if (C <= 128)
    ln_bwd_kernel<4><<<blocks, LB_WARPS * 32, 0, st>>>(
        x, w, dyl, np, pstride, map, res, dx, part, rows, rpb, C);
  else if (C <= 256)
    ln_bwd_kernel<8><<<blocks, LB_WARPS * 32, 0, st>>>(
        x, w, dyl, np, pstride, map, res, dx, part, rows, rpb, C);
  else if (C <= 512)
    ln_bwd_kernel<16><<<blocks, LB_WARPS * 32, 0, st>>>(
        x, w, dyl, np, pstride, map, res, dx, part, rows, rpb, C);
  else if (C <= 1024)
    ln_bwd_kernel<32><<<blocks, LB_WARPS * 32, 0, st>>>(
        x, w, dyl, np, pstride, map, res, dx, part, rows, rpb, C);
  else
    ln_bwd_kernel<40><<<blocks, LB_WARPS * 32, 0, st>>>(
        x, w, dyl, np, pstride, map, res, dx, part, rows, rpb, C);
}

// ---------------------------------------------------------------------------
// The shortcut's gradient on the padded grid: ds [Hp x Wp rows, C] from
// the output-grid gradient g [B, Ho, Wo, C]: with q_pool, each 2x2 cell's
// g goes to the element unpool_pick chooses among the pre-pool values sp
// [padded rows, C], zeros elsewhere; without, ds = g at grid tokens. Pad
// tokens and tokens outside every cell get zeros: every element is written.
// ---------------------------------------------------------------------------

__global__ void shortcut_bwd_kernel(const bf16* __restrict__ gz,
                                    const bf16* __restrict__ sp,
                                    bf16* __restrict__ ds, HGeo g) {
  const int C8 = g.C / 8;                         // 8 channels a thread
  const long total = (long)g.B * g.Hp * g.Wp * C8;
  for (long e = blockIdx.x * (long)blockDim.x + threadIdx.x; e < total;
       e += (long)gridDim.x * blockDim.x) {
    const int c = (int)(e % C8) * 8;
    const long p = e / C8;
    const int x = (int)(p % g.Wp), y = (int)(p / g.Wp % g.Hp);
    const long b = p / ((long)g.Wp * g.Hp);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (!g.q_pool) {
      if (y < g.H && x < g.W)
        v = __ldg(reinterpret_cast<const uint4*>(
            gz + ((b * g.H + y) * g.W + x) * g.C + c));
    } else if (y / 2 < g.Ho && x / 2 < g.Wo) {
      const long tl = p - (y & 1) * (long)g.Wp - (x & 1);   // cell's top left
      const int me = 2 * (y & 1) + (x & 1);
      uint4 cv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        cv[k] = __ldg(reinterpret_cast<const uint4*>(
            sp + (tl + (k >> 1) * (long)g.Wp + (k & 1)) * g.C + c));
      const uint4 gv = __ldg(reinterpret_cast<const uint4*>(
          gz + ((b * g.Ho + y / 2) * g.Wo + x / 2) * g.C + c));
      const bf16* c0 = reinterpret_cast<const bf16*>(&cv[0]);
      const bf16* c1 = reinterpret_cast<const bf16*>(&cv[1]);
      const bf16* c2 = reinterpret_cast<const bf16*>(&cv[2]);
      const bf16* c3 = reinterpret_cast<const bf16*>(&cv[3]);
      const bf16* gg = reinterpret_cast<const bf16*>(&gv);
      bf16* vv = reinterpret_cast<bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        vv[j] = unpool_pick(to_f32(c0[j]), to_f32(c1[j]), to_f32(c2[j]),
                            to_f32(c3[j])) == me ? gg[j] : to_bf16(0.f);
    }
    *reinterpret_cast<uint4*>(ds + p * g.C + c) = v;
  }
}

// ---------------------------------------------------------------------------
// Workspace and the C entry point. Weight table (the forward's, ops/
// hiera_block_kernel.py pack): ln1w ln1b Wqkv bqkv Wproj bproj ln2w ln2b W1
// b1 W2 b2 Wsc bsc (the last two null without a dim change). Gradients
// (f32) in the same order.
// ---------------------------------------------------------------------------

enum { W_LN1W, W_LN1B, W_QKV, W_BQKV, W_PROJ, W_BPROJ, W_LN2W, W_LN2B, W_1,
       W_B1, W_2, W_B2, W_SC, W_BSC };

// #6's K-split products (the two weight-gradient groups) run in blocks of
// one warpgroup, 64 rows, three to an SM, where the 128-row blocks of two
// were slower (not so for the epilogue-heavy products, which keep them),
// and aim at HB_SPLIT_BLOCKS blocks
constexpr int HB_SPLIT_BM = 64;
constexpr int HB_SPLIT_BLOCKS = 264;

// K chunks of a product [M, N] summed over K
static int ksplits(int M, int N, long K) {
  int tps;
  return gm_k_splits(gm_cdiv(M, HB_SPLIT_BM) * gm_cdiv(N, GM_BN), (int)K,
                     &tps, HB_SPLIT_BLOCKS);
}

extern "C" int hiera_bwd_k_splits(int M, int N, long K) {
  return ksplits(M, N, K);
}

struct Dims {
  int B, H, W, Cin, C, heads, hid, wsh, wsw, q_pool, sc;
  HGeo g;
  long Mo, Mp, Mi;
};

static Dims dims(int B, int H, int W, int Cin, int C, int heads, int hid,
                 int wsh, int wsw, int q_pool, int sc) {
  Dims d{B, H, W, Cin, C, heads, hid, wsh, wsw, q_pool, sc};
  d.g = hgeo(B, H, W, C, heads, wsh, wsw, q_pool);
  d.Mo = (long)B * d.g.Ho * d.g.Wo;
  d.Mp = (long)B * d.g.Hp * d.g.Wp;
  d.Mi = (long)B * H * W;
  return d;
}

struct Bufs {
  // B1
  bf16 *y, *a, *h, *dh, *dx1;
  float *dyl, *pw1, *c1, *pw2, *c2, *pl2;
  // B2
  bf16 *xn, *qkv, *sp, *dob, *o, *dqkv, *ds;
  float4* stats;
  float *dxn, *pwp, *cp, *pwq, *cq, *pws, *cs, *pl1;
  int s1, s2, sp_, sq, ss, sy, sx;
};

static Bufs carve(Arena& ar, const Dims& d) {
  const HGeo& g = d.g;
  const int C = d.C, C3 = 3 * C;
  Bufs b{};
  b.s1 = ksplits(d.hid, C, d.Mo);
  b.s2 = ksplits(C, d.hid, d.Mo);
  b.sp_ = ksplits(C, C, d.Mo);
  b.sq = ksplits(C3, d.Cin, d.Mp);
  b.ss = d.sc ? ksplits(C, d.Cin, d.Mp) : 0;
  b.sy = ksplits((int)d.Mo, C, d.hid);
  b.sx = ksplits((int)d.Mp, d.Cin, (gm_cdiv(C3, GM_BK) +
                                    (d.sc ? gm_cdiv(C, GM_BK) : 0)) * GM_BK);
  b.y = ar.take<bf16>(d.Mo * C);
  b.a = ar.take<bf16>(d.Mo * d.hid);
  b.h = ar.take<bf16>(d.Mo * d.hid);
  b.dh = ar.take<bf16>(d.Mo * d.hid);
  b.dx1 = ar.take<bf16>(d.Mo * C);
  b.dyl = ar.take<float>(b.sy * d.Mo * C);
  b.pw1 = ar.take<float>((size_t)b.s1 * d.hid * C);
  b.c1 = ar.take<float>((size_t)b.s1 * d.hid);
  b.pw2 = ar.take<float>((size_t)b.s2 * C * d.hid);
  b.c2 = ar.take<float>((size_t)b.s2 * C);
  b.pl2 = ar.take<float>((size_t)ln_blocks(d.Mo) * 2 * C);
  b.xn = ar.take<bf16>(d.Mp * d.Cin);
  b.qkv = ar.take<bf16>(d.Mp * C3);
  b.sp = d.sc && d.q_pool ? ar.take<bf16>(d.Mp * C) : nullptr;
  b.dob = ar.take<bf16>(d.Mo * C);
  b.o = ar.take<bf16>(d.Mo * C);
  b.stats = ar.take<float4>((size_t)g.ngroups * g.heads * g.qtiles * AT_ROWS);
  b.dqkv = ar.take<bf16>(d.Mp * C3);
  b.ds = d.sc ? ar.take<bf16>(d.Mp * C) : nullptr;
  b.dxn = ar.take<float>(b.sx * d.Mp * d.Cin);
  b.pwp = ar.take<float>((size_t)b.sp_ * C * C);
  b.cp = ar.take<float>((size_t)b.sp_ * C);
  b.pwq = ar.take<float>((size_t)b.sq * C3 * d.Cin);
  b.cq = ar.take<float>((size_t)b.sq * C3);
  if (d.sc) {
    b.pws = ar.take<float>((size_t)b.ss * C * d.Cin);
    b.cs = ar.take<float>((size_t)b.ss * C);
  }
  b.pl1 = ar.take<float>((size_t)ln_blocks(d.Mi) * 2 * d.Cin);
  return b;
}

extern "C" long hiera_bwd_workspace_bytes(int B, int H, int W, int Cin, int C,
                                          int heads, int hid, int wsh, int wsw,
                                          int q_pool, int sc) {
  Arena ar{nullptr, 0};
  carve(ar, dims(B, H, W, Cin, C, heads, hid, wsh, wsw, q_pool, sc));
  return (long)ar.off;
}

static GemmOp wgrad_op(const bf16* dy, long lda, const bf16* x, long ldb,
                       int M, int N, long K, float* part, float* colsum) {
  GemmOp o = gemm_op(dy, lda, 1, x, ldb, 1, M, N, (int)K);
  o.part = part;
  o.colsum = colsum;
  o.target = HB_SPLIT_BLOCKS;
  return o;
}

// x [B, H, W, Cin], x1 / dy [B, Ho, Wo, C] bf16 -> dx [B, H, W, Cin] bf16
// and every leaf's gradient (f32, the weight table's order)
extern "C" int hiera_block_bwd(const void* x_, const void* x1_,
                               const void* dy_, void* dx_,
                               const void* const* w, void* grads, void* ws,
                               int B, int H, int W, int Cin, int C, int heads,
                               int hid, int wsh, int wsw, int q_pool,
                               void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const int sc = w[W_SC] != nullptr;
  const Dims d = dims(B, H, W, Cin, C, heads, hid, wsh, wsw, q_pool, sc);
  const HGeo& g = d.g;
  if (g.hd > AT_COLS || g.hd % 8 || C % 8 || Cin % 8 || hid % 8 ||
      Cin > LN_MAX_C || C > LN_MAX_C || (q_pool && (wsh % 2 || wsw % 2)))
    return (int)cudaErrorInvalidValue;
  Arena ar{static_cast<char*>(ws), 0};
  const Bufs b = carve(ar, d);
  auto Wt = [&](int i) { return static_cast<const bf16*>(w[i]); };
  auto F = [&](int i) { return static_cast<const float*>(w[i]); };
  const bf16* x = static_cast<const bf16*>(x_);
  const bf16* x1 = static_cast<const bf16*>(x1_);
  const bf16* dy = static_cast<const bf16*>(dy_);
  const int C3 = 3 * C;
  const RowMap out_map{g.Ho, g.Wo, g.Ho, g.Wo};
  const RowMap in_map{H, W, g.Hp, g.Wp};
  int err;

  // ---- B1: y = LN2(x1); a = y W1^T + b1, h = GELU(a); dh = (dy W2)
  // GELU'(a); dy_ln = dh W1, dW1 = dh^T y (+ db1), dW2 = dy^T h (+ db2);
  // dx1 = dy + LN2'(dy_ln)
  ln_fwd(x1, b.y, F(W_LN2W), F(W_LN2B), out_map, d.Mo, C, st);
  GemmGroup G{};
  G.n = 1;
  G.op[0] = gemm_op(b.y, C, 0, Wt(W_1), C, 0, (int)d.Mo, hid, C);
  G.op[0].bias = F(W_B1);
  G.op[0].pre = b.a;
  G.op[0].gelu = 1;
  G.op[0].out = b.h;
  if ((err = gemm_group(G, st))) return err;
  G = GemmGroup{};
  G.n = 1;
  G.op[0] = gemm_op(dy, C, 0, Wt(W_2), hid, 1, (int)d.Mo, hid, C);
  G.op[0].dgelu = b.a;
  G.op[0].out = b.dh;
  if ((err = gemm_group(G, st))) return err;
  G = GemmGroup{};
  G.n = 3;
  G.op[0] = gemm_op(b.dh, hid, 0, Wt(W_1), C, 1, (int)d.Mo, C, hid);
  G.op[0].part = b.dyl;                 // dy_ln in K chunks
  G.op[0].target = HB_SPLIT_BLOCKS;
  G.op[1] = wgrad_op(b.dh, hid, b.y, C, hid, C, d.Mo, b.pw1, b.c1);
  G.op[2] = wgrad_op(dy, C, b.h, hid, C, hid, d.Mo, b.pw2, b.c2);
  if ((err = gemm_group<HB_SPLIT_BM>(G, st))) return err;
  ln_bwd(x1, F(W_LN2W), b.dyl, b.sy, d.Mo * C, out_map, dy, b.dx1, b.pl2,
         d.Mo, C, st);

  // ---- B2: xn = LN1(x) on the padded grid; qkv (and the shortcut's
  // pre-pool values) with kernel #1's bias walk; dO = dx1 Wproj
  ln_fwd(x, b.xn, F(W_LN1W), F(W_LN1B), in_map, d.Mp, Cin, st);
  G = GemmGroup{};
  G.op[G.n] = gemm_op(b.xn, Cin, 0, Wt(W_QKV), Cin, 0, (int)d.Mp, C3, Cin);
  G.op[G.n].bias = F(W_BQKV);
  G.op[G.n].bias_once = 1;
  G.op[G.n++].out = b.qkv;
  if (b.sp) {
    G.op[G.n] = gemm_op(b.xn, Cin, 0, Wt(W_SC), Cin, 0, (int)d.Mp, C, Cin);
    G.op[G.n].bias = F(W_BSC);
    G.op[G.n].bias_once = 1;
    G.op[G.n++].out = b.sp;
  }
  G.op[G.n] = gemm_op(b.dx1, C, 0, Wt(W_PROJ), C, 1, (int)d.Mo, C, C);
  G.op[G.n++].out = b.dob;
  if ((err = gemm_group(G, st))) return err;

  // ---- attention: statistics and O, dq (one pass where a group's keys
  // fit a tile), dk and dv
  const dim3 gq(g.qtiles, heads, g.ngroups), gk(g.ktiles, heads, g.ngroups);
  if (g.ktiles == 1) {
    if ((err = (int)set_smem(attn_onepass_kernel<true>, A1Smem::BYTES))) return err;
    attn_onepass_kernel<true><<<gq, AT_THREADS, A1Smem::BYTES, st>>>(
        b.qkv, b.dob, b.o, b.stats, b.dqkv, g);
  } else {
    const int bytes = AfSmem::bytes(g.ktiles);
    if ((err = (int)set_smem(attn_dq_kernel, bytes))) return err;
    if ((err = (int)set_smem(attn_fwd_kernel<true>, bytes))) return err;
    attn_fwd_kernel<true><<<gq, AT_THREADS, bytes, st>>>(b.qkv, b.dob, b.o,
                                                         b.stats, g);
    attn_dq_kernel<<<gq, AT_THREADS, bytes, st>>>(b.qkv, b.dob, b.stats,
                                                  b.dqkv, g);
  }
  const int kbytes = AkSmem::bytes(g.qtiles);
  if ((err = (int)set_smem(attn_dkv_kernel, kbytes))) return err;
  attn_dkv_kernel<<<gk, AT_THREADS, kbytes, st>>>(b.qkv, b.dob, b.stats,
                                                  b.dqkv, g);

  // ---- shortcut (dim-change blocks): ds on the padded grid
  if (sc) {
    const long n = d.Mp * C / 8;
    const unsigned blocks = (unsigned)((n + 255) / 256 < 8192 ? (n + 255) / 256
                                                              : 8192);
    shortcut_bwd_kernel<<<blocks, 256, 0, st>>>(b.dx1, b.sp, b.ds, g);
  }

  // ---- dWproj = dx1^T o (+ dbproj), dWqkv = dqkv^T xn (+ dbqkv, pad keys
  // included), dWsc = ds^T xn (+ dbsc), dxn = dqkv Wqkv (+ ds Wsc)
  G = GemmGroup{};
  G.op[G.n++] = wgrad_op(b.dx1, C, b.o, C, C, C, d.Mo, b.pwp, b.cp);
  G.op[G.n++] = wgrad_op(b.dqkv, C3, b.xn, Cin, C3, Cin, d.Mp, b.pwq, b.cq);
  if (sc)
    G.op[G.n++] = wgrad_op(b.ds, C, b.xn, Cin, C, Cin, d.Mp, b.pws, b.cs);
  G.op[G.n] = gemm_op(b.dqkv, C3, 0, Wt(W_QKV), Cin, 1, (int)d.Mp, Cin, C3);
  if (sc) {
    G.op[G.n].a2 = b.ds;
    G.op[G.n].lda2 = C;
    G.op[G.n].b2 = Wt(W_SC);
    G.op[G.n].ldb2 = Cin;
    G.op[G.n].K2 = C;
  }
  G.op[G.n].target = HB_SPLIT_BLOCKS;
  G.op[G.n++].part = b.dxn;             // dxn in K chunks
  if ((err = gemm_group<HB_SPLIT_BM>(G, st))) return err;

  // ---- LN1 backward (+ the identity shortcut's gradient)
  bf16* dx = static_cast<bf16*>(dx_);
  ln_bwd(x, F(W_LN1W), b.dxn, b.sx, d.Mp * Cin, in_map, sc ? nullptr : b.dx1,
         dx, b.pl1, d.Mi,
         Cin, st);

  // ---- every partial, added in order (the leaves' order)
  const int n1 = (int)ln_blocks(d.Mi), n2 = (int)ln_blocks(d.Mo);
  RedPlan R{};
  reduce_add(R, b.pl1, 2L * Cin, n1, Cin);                      // ln1w
  reduce_add(R, b.pl1 + Cin, 2L * Cin, n1, Cin);                // ln1b
  reduce_add(R, b.pwq, (long)C3 * Cin, b.sq, (long)C3 * Cin);   // Wqkv
  reduce_add(R, b.cq, C3, b.sq, C3);                            // bqkv
  reduce_add(R, b.pwp, (long)C * C, b.sp_, (long)C * C);        // Wproj
  reduce_add(R, b.cp, C, b.sp_, C);                             // bproj
  reduce_add(R, b.pl2, 2L * C, n2, C);                          // ln2w
  reduce_add(R, b.pl2 + C, 2L * C, n2, C);                      // ln2b
  reduce_add(R, b.pw1, (long)hid * C, b.s1, (long)hid * C);     // W1
  reduce_add(R, b.c1, hid, b.s1, hid);                          // b1
  reduce_add(R, b.pw2, (long)C * hid, b.s2, (long)C * hid);     // W2
  reduce_add(R, b.c2, C, b.s2, C);                              // b2
  if (sc) {
    reduce_add(R, b.pws, (long)C * Cin, b.ss, (long)C * Cin);   // Wsc
    reduce_add(R, b.cs, C, b.ss, C);                            // bsc
  }
  reduce_launch(R, static_cast<float*>(grads), st);
  return (int)cudaGetLastError();
}
