// The Hiera block's attention forward and its geometry, shared by the
// block's forward (hiera_block.cu, kernel #1) and its backward's recompute
// (hiera_block_bwd.cu, kernel #6), so the two form O with the same
// arithmetic and agree bit for bit:
//   - the geometry (HGeo): windows of the zero-padded token grid, packed
//     several to a 64-row tile under a block-diagonal mask, 2x2 q-pooling
//     inside each window and the crop of the pooled grid;
//   - the attention passes on wgmma (sm90.cuh tiles): attn_onepass where a
//     packed group's keys fit one 64-key tile, else attn_fwd over key tiles
//     (row max and sum, then p = exp(s - max) / sum rounded to bf16 and
//     O += p V); each is a template on BWD: the backward's instance also
//     forms dO V^T, the statistics and D (and, in one pass, dq), the
//     forward's forms O alone;
//   - the LayerNorm forward on the padded grid (zero rows at pad tokens, so
//     qkv there is the bias: the reference pads after norm1).
#pragma once

#include "common.cuh"
#include "sm90.cuh"

constexpr float HB_EPS = 1e-6f;

// ---------------------------------------------------------------------------
// 2x2 max-pool backward (JAX's rule, see the header). Cell values v00 v01
// (top row) v10 v11; returns 2 * row + column of the element that takes
// the gradient.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int unpool_pick(float v00, float v01, float v10,
                                           float v11) {
  const int col = fmaxf(v00, v10) >= fmaxf(v01, v11) ? 0 : 1;
  const float top = col ? v01 : v00, bot = col ? v11 : v10;
  return (top >= bot ? 0 : 2) + col;
}

// elementwise max of bf16 vectors (exact: bf16 widens to f32 exactly)
__device__ __forceinline__ uint32_t bmax2(uint32_t a, uint32_t b) {
  const float lo = fmaxf(__uint_as_float(a << 16), __uint_as_float(b << 16));
  const float hi = fmaxf(__uint_as_float(a & 0xffff0000u),
                         __uint_as_float(b & 0xffff0000u));
  return (__float_as_uint(hi) & 0xffff0000u) | (__float_as_uint(lo) >> 16);
}

__device__ __forceinline__ uint4 bmax8(uint4 a, uint4 b) {
  return make_uint4(bmax2(a.x, b.x), bmax2(a.y, b.y), bmax2(a.z, b.z),
                    bmax2(a.w, b.w));
}

__device__ __forceinline__ uint32_t bf2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// Geometry. The input grid H x W is padded to Hp x Wp, whole windows of
// wsh x wsw (global attention: one window of H x W); a row of xn, qkv and
// dqkv is a token of the padded grid, (b Hp + y) Wp + x. With q_pool a
// window's queries are the 2x2 maxima of its q ((wsh/2) x (wsw/2)), and the
// output grid is (H/2, W/2), pooled positions past it cropped. A query is
// kept where it lands on the output grid (a pad query does not); others
// get no gradient. Windows are packed G to a group: a group's queries are
// its windows' queries in order (GQ = G Tq rows), its keys their keys in
// order (GK = G T), and query r sees key c where both belong to the same
// window. Windows of at most 64 tokens pack to one 64-key tile (4 windows
// of 16; a q-pooled window of 64 alone, its 16 queries in a 64-row tile).
// ---------------------------------------------------------------------------

constexpr int AT_ROWS = 64;        // rows of every attention tile
constexpr int AT_COLS = 128;       // head dim padded to 128 (zero columns)
constexpr int AT_TILE = AT_ROWS * AT_COLS * 2;   // bytes of a tile
constexpr int AT_THREADS = 128;    // one warpgroup
constexpr int AT_MAX_GK = 256;     // keys of a packed group

struct HGeo {
  int B, H, W, Hp, Wp, C, heads, hd;
  int wsh, wsw, nWh, nWw, q_pool;
  int T, qh, qw, Tq, Ho, Wo;
  int G, nwin, ngroups, GQ, GK, qtiles, ktiles;
  float scale, sl;                 // 1 / sqrt(hd), and times log2(e)
};

static HGeo hgeo(int B, int H, int W, int C, int heads, int wsh, int wsw,
                 int q_pool) {
  HGeo g{};
  g.B = B, g.H = H, g.W = W, g.C = C, g.heads = heads, g.hd = C / heads;
  g.wsh = wsh, g.wsw = wsw, g.q_pool = q_pool;
  g.nWh = (H + wsh - 1) / wsh, g.nWw = (W + wsw - 1) / wsw;
  g.Hp = g.nWh * wsh, g.Wp = g.nWw * wsw;
  g.T = wsh * wsw;
  g.qh = q_pool ? wsh / 2 : wsh, g.qw = q_pool ? wsw / 2 : wsw;
  g.Tq = g.qh * g.qw;
  g.Ho = q_pool ? H / 2 : H, g.Wo = q_pool ? W / 2 : W;
  g.nwin = B * g.nWh * g.nWw;
  // windows whose keys fit one tile keep their group's keys in one tile
  // (one pass; pooled queries then fill a quarter of the rows), larger
  // ones fill the query rows up to AT_MAX_GK keys
  int G = g.T <= AT_ROWS ? AT_ROWS / g.T : g.Tq < AT_ROWS ? AT_ROWS / g.Tq : 1;
  if (G > 1 && G * g.T > AT_MAX_GK) G = AT_MAX_GK / g.T > 1 ? AT_MAX_GK / g.T : 1;
  g.G = G;
  g.ngroups = (g.nwin + G - 1) / G;
  g.GQ = G * g.Tq, g.GK = G * g.T;
  g.qtiles = (g.GQ + AT_ROWS - 1) / AT_ROWS;
  g.ktiles = (g.GK + AT_ROWS - 1) / AT_ROWS;
  g.scale = 1.f / sqrtf((float)g.hd);
  g.sl = g.scale * 1.4426950408889634f;
  return g;
}

// the group-local window of query r (-1: none) and of key c (-2: none)
__device__ __forceinline__ int qwin(const HGeo& g, int grp, int r) {
  if (r >= g.GQ) return -1;
  const int w = r / g.Tq;
  return grp * g.G + w < g.nwin ? w : -1;
}

__device__ __forceinline__ int kwin(const HGeo& g, int grp, int c) {
  if (c >= g.GK) return -2;
  const int w = c / g.T;
  return grp * g.G + w < g.nwin ? w : -2;
}

// padded-grid row of token (y, x) of window w of the grid
__device__ __forceinline__ long grid_row(const HGeo& g, int w, int y, int x) {
  const int wx = w % g.nWw, t = w / g.nWw, wy = t % g.nWh, b = t / g.nWh;
  return ((long)b * g.Hp + wy * g.wsh + y) * g.Wp + wx * g.wsw + x;
}

// padded-grid row of key c of group grp, or -1
__device__ __forceinline__ long key_row(const HGeo& g, int grp, int c) {
  const int w = kwin(g, grp, c);
  if (w < 0) return -1;
  const int i = c - w * g.T;
  return grid_row(g, grp * g.G + w, i / g.wsw, i % g.wsw);
}

// padded-grid row of query r of group grp (the top-left token of its 2x2
// cell with q_pool), or -1
__device__ __forceinline__ long query_row(const HGeo& g, int grp, int r) {
  const int w = qwin(g, grp, r);
  if (w < 0) return -1;
  const int i = r - w * g.Tq, f = g.q_pool ? 2 : 1;
  return grid_row(g, grp * g.G + w, f * (i / g.qw), f * (i % g.qw));
}

// output-grid token of query r of group grp, or -1 when not kept
__device__ __forceinline__ long kept_row(const HGeo& g, int grp, int r) {
  const int w = qwin(g, grp, r);
  if (w < 0) return -1;
  const int wi = grp * g.G + w, i = r - w * g.Tq;
  const int wx = wi % g.nWw, t = wi / g.nWw, wy = t % g.nWh, b = t / g.nWh;
  const int oy = wy * g.qh + i / g.qw, ox = wx * g.qw + i % g.qw;
  if (oy >= g.Ho || ox >= g.Wo) return -1;
  return ((long)b * g.Ho + oy) * g.Wo + ox;
}

// the keys [x, y) query r of group grp sees (its window's; empty when it
// has none), and the queries [x, y) that see key c
__device__ __forceinline__ int2 key_range(const HGeo& g, int grp, int r) {
  const int w = qwin(g, grp, r);
  return w < 0 ? make_int2(0, 0) : make_int2(w * g.T, (w + 1) * g.T);
}

__device__ __forceinline__ int2 query_range(const HGeo& g, int grp, int c) {
  const int w = kwin(g, grp, c);
  return w < 0 ? make_int2(0, 0) : make_int2(w * g.Tq, (w + 1) * g.Tq);
}

// ---------------------------------------------------------------------------
// Attention tiles: 64 rows x 128 columns in the 128-byte-swizzled layout
// (sm90.cuh), columns at and past hd zero. Each block first writes the
// rows of its keys and queries (and the queries' output tokens) into
// tables in shared memory, so no load or mask divides. Rows by cp.async
// from the rows tab[r] of a row-major matrix (stride ld, -1: zeros);
// pooled queries (the 2x2 max of q) by plain loads and shared stores.
// ---------------------------------------------------------------------------

// padded-grid rows of keys c0 .. c0 + n - 1 of group grp
__device__ __forceinline__ void fill_keys(int* tab, const HGeo& g, int grp,
                                          int c0, int n) {
  for (int i = threadIdx.x; i < n; i += AT_THREADS)
    tab[i] = (int)key_row(g, grp, c0 + i);
}

// rows (qtab) and output tokens (ttab) of queries r0 .. r0 + n - 1
__device__ __forceinline__ void fill_queries(int* qtab, int* ttab,
                                             const HGeo& g, int grp, int r0,
                                             int n) {
  for (int i = threadIdx.x; i < n; i += AT_THREADS) {
    qtab[i] = (int)query_row(g, grp, r0 + i);
    ttab[i] = (int)kept_row(g, grp, r0 + i);
  }
}

__device__ __forceinline__ void stage_rows(uint32_t dst, const bf16* base,
                                           long ld, int hd, const int* tab) {
#pragma unroll
  for (int i = 0; i < AT_ROWS * 16 / AT_THREADS; ++i) {
    const int r = i * (AT_THREADS / 16) + (threadIdx.x >> 4);
    const int j = threadIdx.x & 15;
    const long row = tab[r];
    const bool ok = row >= 0 && 8 * j < hd;
    cp_async16(dst + sw128_off(r, 8 * j), base + (ok ? row * ld + 8 * j : 0),
               ok);
  }
}

// the queries of the rows tab[0 .. 63], head base qb (qkv + h hd)
__device__ __forceinline__ void stage_queries(uint32_t dst, unsigned char* gdst,
                                              const bf16* qb, const HGeo& g,
                                              const int* tab) {
  const long C3 = 3L * g.C;
  if (!g.q_pool) {
    stage_rows(dst, qb, C3, g.hd, tab);
    return;
  }
#pragma unroll 2
  for (int i = 0; i < AT_ROWS * 16 / AT_THREADS; ++i) {
    const int r = i * (AT_THREADS / 16) + (threadIdx.x >> 4);
    const int j = threadIdx.x & 15;
    const long row = tab[r];
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row >= 0 && 8 * j < g.hd) {
      const bf16* p = qb + row * C3 + 8 * j;
      const long dn = (long)g.Wp * C3;
      v = bmax8(bmax8(__ldg(reinterpret_cast<const uint4*>(p)),
                      __ldg(reinterpret_cast<const uint4*>(p + C3))),
                bmax8(__ldg(reinterpret_cast<const uint4*>(p + dn)),
                      __ldg(reinterpret_cast<const uint4*>(p + dn + C3))));
    }
    *reinterpret_cast<uint4*>(gdst + sw128_off(r, 8 * j)) = v;
  }
}

// s[64 x 64] = A B^T over the 128 (padded) columns, both tiles K-major
__device__ __forceinline__ void issue_scores(float (&s)[32], uint32_t A,
                                             uint32_t B) {
#pragma unroll
  for (int kk = 0; kk < AT_COLS / 16; ++kk)
    wgmma_ss_n64(s, desc_k(A, kk * 16), desc_k(B, kk * 16), kk > 0);
}

// this thread's first accumulator row in the tile (the second is + 8)
__device__ __forceinline__ int acc_row() {
  return (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
}

// bf16 A operands of k16 slice kk of a 64 x 64 f32 accumulator
__device__ __forceinline__ void a_bf16(const float (&x)[32], int kk,
                                       uint32_t (&a)[4]) {
  const int j = 8 * kk;
  a[0] = bf2(x[j], x[j + 1]);
  a[1] = bf2(x[j + 2], x[j + 3]);
  a[2] = bf2(x[j + 4], x[j + 5]);
  a[3] = bf2(x[j + 6], x[j + 7]);
}

// per (group, head, query row): (row max of s sl, 1 / row sum, D, 0);
// rows without a key: (0, 0, 0, 0)
__device__ __forceinline__ long stat_base(const HGeo& g, int grp, int h,
                                          int qt) {
  return (((long)grp * g.heads + h) * g.qtiles + qt) * AT_ROWS;
}

// s <- s sl at the keys [kr.x, kr.y) of each row (columns c0 + ..), -inf
// elsewhere
__device__ __forceinline__ void mask_rows(float (&s)[32], int c0,
                                          const int2 (&kr)[2], float sl) {
  const int q4 = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = c0 + (i >> 2) * 8 + 2 * q4 + (i & 1), hh = (i >> 1) & 1;
    s[i] = c >= kr[hh].x && c < kr[hh].y ? s[i] * sl : -INFINITY;
  }
}

// O (bf16) into the kept rows' columns h hd .. of o
__device__ __forceinline__ void store_o(const float (&oacc)[64], bf16* o,
                                        const int* ttab, const HGeo& g,
                                        int h) {
  const int lr = acc_row(), q4 = threadIdx.x & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const long tok = ttab[lr + 8 * hh];
    if (tok < 0) continue;
    bf16* dst = o + tok * g.C + h * g.hd;
#pragma unroll
    for (int n = 0; n < AT_COLS / 8; ++n) {
      const int col = 8 * n + 2 * q4;
      if (col < g.hd)
        *reinterpret_cast<uint32_t*>(dst + col) =
            bf2(oacc[4 * n + 2 * hh], oacc[4 * n + 2 * hh + 1]);
    }
  }
}

// dq (bf16) into columns h hd .. of dqkv at the rows qtab (through the 2x2
// cell with q_pool: the element unpool_pick chooses, zeros elsewhere)
__device__ __forceinline__ void store_dq(const float (&dq)[64], bf16* dqkv,
                                         const bf16* qb, const int* qtab,
                                         const HGeo& g, int h) {
  const int lr = acc_row(), q4 = threadIdx.x & 3;
  const long C3 = 3L * g.C;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const long row = qtab[lr + 8 * hh];
    if (row < 0) continue;
    bf16* dst = dqkv + row * C3 + h * g.hd;
#pragma unroll
    for (int n = 0; n < AT_COLS / 8; ++n) {
      const int col = 8 * n + 2 * q4;
      if (col >= g.hd) continue;
      const float d0 = dq[4 * n + 2 * hh], d1 = dq[4 * n + 2 * hh + 1];
      if (!g.q_pool) {
        *reinterpret_cast<uint32_t*>(dst + col) = bf2(d0, d1);
        continue;
      }
      const long off[4] = {0, C3, (long)g.Wp * C3, (long)g.Wp * C3 + C3};
      float2 v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[c] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            qb + row * C3 + off[c] + col));
      const int p0 = unpool_pick(v[0].x, v[1].x, v[2].x, v[3].x);
      const int p1 = unpool_pick(v[0].y, v[1].y, v[2].y, v[3].y);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<uint32_t*>(dst + off[c] + col) =
            bf2(p0 == c ? d0 : 0.f, p1 == c ? d1 : 0.f);
    }
  }
}

template <class Kernel>
static cudaError_t set_smem(Kernel* fn, int bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  // the largest carve-out, so that two blocks share an SM
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return e;
}

// ---------------------------------------------------------------------------
// One pass where a group's keys fit one tile (GK <= 64: windows of 64, 49
// or 16 tokens): grid (qtiles, heads, ngroups). s = Q K^T once; the exact
// softmax over the whole row, p rounded to bf16 (the reference's walk), O
// += p V, written (bf16) at the kept queries. With BWD also dp = dO V^T; D
// = rowsum(p dp) (the reference's formula); ds = p (dp - D) scale rounded
// to bf16, dq = ds K; writes the statistics (for the dk / dv pass) and dq.
// ---------------------------------------------------------------------------

struct A1Smem {
  static constexpr int Q = 0, DO = AT_TILE, K = 2 * AT_TILE, V = 3 * AT_TILE;
  static constexpr int TAB = 4 * AT_TILE;         // keys, queries, tokens
  static constexpr int BYTES = TAB + 3 * AT_ROWS * 4 + 1024;
};

template <bool BWD>
__global__ void __launch_bounds__(AT_THREADS, 2)
attn_onepass_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                    bf16* __restrict__ o, float4* __restrict__ stats,
                    bf16* __restrict__ dqkv, const HGeo g) {
  using SM = A1Smem;
  extern __shared__ unsigned char at_smem[];
  unsigned char* gen;
  const uint32_t sm = aligned_smem(at_smem, &gen);
  const int qt = blockIdx.x, h = blockIdx.y, grp = blockIdx.z;
  const int q4 = threadIdx.x & 3;
  const long C3 = 3L * g.C;
  const bf16* qb = qkv + h * g.hd;
  const int q0 = qt * AT_ROWS;
  int* ktab = reinterpret_cast<int*>(gen + SM::TAB);
  int* qtab = ktab + AT_ROWS;
  int* ttab = qtab + AT_ROWS;
  fill_keys(ktab, g, grp, 0, AT_ROWS);
  fill_queries(qtab, ttab, g, grp, q0, AT_ROWS);
  __syncthreads();
  stage_queries(sm + SM::Q, gen + SM::Q, qb, g, qtab);
  if (BWD) stage_rows(sm + SM::DO, dout + h * g.hd, g.C, g.hd, ttab);
  stage_rows(sm + SM::K, qb + g.C, C3, g.hd, ktab);
  stage_rows(sm + SM::V, qb + 2 * g.C, C3, g.hd, ktab);
  cp_async_commit();
  const int lr = acc_row();
  const int2 kr[2] = {key_range(g, grp, q0 + lr), key_range(g, grp, q0 + lr + 8)};
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  float s[32], dp[32];
  wgmma_fence();
  issue_scores(s, sm + SM::Q, sm + SM::K);
  wgmma_commit();
  if (BWD) {
    issue_scores(dp, sm + SM::DO, sm + SM::V);
    wgmma_commit();
    wgmma_wait<1>();
  } else {
    wgmma_wait<0>();
  }
  fence_regs(s);
  mask_rows(s, 0, kr, g.sl);
  float mb[2], inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float m = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      m = fmaxf(m, fmaxf(s[4 * n + 2 * hh], s[4 * n + 2 * hh + 1]));
    m = quad_max(m);
    mb[hh] = m == -INFINITY ? 0.f : m;
    float l = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      l += exp2f(s[4 * n + 2 * hh] - mb[hh]) +
           exp2f(s[4 * n + 2 * hh + 1] - mb[hh]);
    l = quad_sum(l);
    inv[hh] = l > 0.f ? 1.f / l : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hh = (i >> 1) & 1;
    s[i] = exp2f(s[i] - mb[hh]) * inv[hh];          // p
  }
  float oacc[64];
  {
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_bf16(s, kk, pa[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n128(oacc, pa[kk], desc_mn(sm + SM::V, kk * 16, 0), kk > 0);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(oacc);
  store_o(oacc, o, ttab, g, h);
  if (!BWD) return;
  fence_regs(dp);
  float D[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) D[(i >> 1) & 1] += s[i] * dp[i];
  const long sb = stat_base(g, grp, h, qt);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    D[hh] = quad_sum(D[hh]);
    if (q4 == 0)
      stats[sb + lr + 8 * hh] = make_float4(mb[hh], inv[hh], D[hh], 0.f);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hh = (i >> 1) & 1;
    dp[i] = s[i] * (dp[i] - D[hh]) * g.scale;      // ds
  }
  float dq[64];
  {
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_bf16(dp, kk, da[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n128(dq, da[kk], desc_mn(sm + SM::K, kk * 16, 0), kk > 0);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(dq);
  store_dq(dq, dqkv, qb, qtab, g, h);
}

// ---------------------------------------------------------------------------
// Forward statistics over several key tiles: grid (qtiles, heads,
// ngroups). Pass 1 over the key tiles: the row max and sum of the exact
// softmax; pass 2: p = exp(s - m) / sum rounded to bf16, O += p V; O
// (bf16) at the kept queries (the forward's output, the backward's operand
// of dWproj). With BWD also D = rowsum(dO * O) over the f32 O and the
// statistics. (Keeping the scores of up to four key tiles in registers,
// one QK^T pass, left 14 x 14 windows as fast as they are: their time is
// the tile loads.)
// ---------------------------------------------------------------------------

struct AfSmem {                      // forward statistics and dq
  static constexpr int Q = 0, DO = AT_TILE, K = 2 * AT_TILE;
  static constexpr int V = 4 * AT_TILE;          // K, V: two stages each
  static constexpr int TAB = 6 * AT_TILE;        // keys, queries, tokens
  static int bytes(int ktiles) {
    return TAB + (ktiles + 2) * AT_ROWS * 4 + 1024;
  }
};

template <bool BWD>
__global__ void __launch_bounds__(AT_THREADS, 2)
attn_fwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                bf16* __restrict__ o, float4* __restrict__ stats,
                const HGeo g) {
  using SM = AfSmem;
  extern __shared__ unsigned char at_smem[];
  unsigned char* gen;
  const uint32_t sm = aligned_smem(at_smem, &gen);
  const int qt = blockIdx.x, h = blockIdx.y, grp = blockIdx.z;
  const int q4 = threadIdx.x & 3;
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
  if (BWD) stage_rows(sm + SM::DO, dout + h * g.hd, g.C, g.hd, ttab);
  auto load = [&](int kt, bool with_v) {
    const int st = kt & 1;
    stage_rows(sm + SM::K + st * AT_TILE, kb, C3, g.hd, ktab + kt * AT_ROWS);
    if (with_v)
      stage_rows(sm + SM::V + st * AT_TILE, vb, C3, g.hd, ktab + kt * AT_ROWS);
  };
  load(0, false);
  cp_async_commit();

  const int lr = acc_row();
  const int2 kr[2] = {key_range(g, grp, q0 + lr), key_range(g, grp, q0 + lr + 8)};
  float s[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < g.ktiles; ++kt) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (kt + 1 < g.ktiles) load(kt + 1, false);
    cp_async_commit();
    wgmma_fence();
    issue_scores(s, sm + SM::Q, sm + SM::K + (kt & 1) * AT_TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    mask_rows(s, kt * AT_ROWS, kr, g.sl);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float cm = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        cm = fmaxf(cm, fmaxf(s[4 * n + 2 * hh], s[4 * n + 2 * hh + 1]));
      const float mn = fmaxf(m[hh], quad_max(cm));
      const float base = mn == -INFINITY ? 0.f : mn;
      float acc = l[hh] * exp2f(m[hh] - base);
#pragma unroll
      for (int n = 0; n < 8; ++n)
        acc += exp2f(s[4 * n + 2 * hh] - base) +
               exp2f(s[4 * n + 2 * hh + 1] - base);
      l[hh] = acc;
      m[hh] = mn;
    }
  }
  float inv[2], mb[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float tot = quad_sum(l[hh]);
    inv[hh] = tot > 0.f ? 1.f / tot : 0.f;
    mb[hh] = m[hh] == -INFINITY ? 0.f : m[hh];
  }

  __syncthreads();                   // every warp is done with the K ring
  load(0, true);
  cp_async_commit();
  float oacc[64];
  zero(oacc);
  for (int kt = 0; kt < g.ktiles; ++kt) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (kt + 1 < g.ktiles) load(kt + 1, true);
    cp_async_commit();
    const int st = kt & 1;
    wgmma_fence();
    issue_scores(s, sm + SM::Q, sm + SM::K + st * AT_TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    mask_rows(s, kt * AT_ROWS, kr, g.sl);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      s[i] = exp2f(s[i] - mb[hh]) * inv[hh];
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_bf16(s, kk, pa[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n128(oacc, pa[kk], desc_mn(sm + SM::V + st * AT_TILE, kk * 16, 0),
                    1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oacc);
  }

  if (!BWD) {
    store_o(oacc, o, ttab, g, h);
    return;
  }
  float D[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < AT_COLS / 8; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          gen + SM::DO + sw128_off(lr + 8 * hh, 8 * n + 2 * q4)));
      D[hh] += d.x * oacc[4 * n + 2 * hh] + d.y * oacc[4 * n + 2 * hh + 1];
    }
  const long sb = stat_base(g, grp, h, qt);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    D[hh] = quad_sum(D[hh]);
    if (q4 == 0)
      stats[sb + lr + 8 * hh] = make_float4(mb[hh], inv[hh], D[hh], 0.f);
  }
  store_o(oacc, o, ttab, g, h);
}

// ---------------------------------------------------------------------------
// LayerNorm forward over rows of C <= 1024 channels (C % 8 == 0, eps 1e-6),
// a warp per row (two rows for C <= 128; 16-byte loads and stores), rows
// mapped between a grid (B,
// H, W) and its padding (Hp, Wp) >= (H, W); optional exact GELU after it
// (the memory encoder's downsampler).
// ---------------------------------------------------------------------------

struct RowMap {
  int H, W, Hp, Wp;
  // padded row of grid row r
  __device__ __forceinline__ long padded(long r) const {
    const long b = r / ((long)H * W), t = r % ((long)H * W);
    return (b * Hp + t / W) * Wp + t % W;
  }
};

// the sum over the L lanes of a lane group (L a power of two <= 32)
template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffff, v, o);
  return v;
}

// LN (GELU(LN) with gelu) of one row of C <= 8 L PER8 channels by the L
// lanes of a lane group, 8 consecutive channels a lane (16-byte loads: lane
// l of the group holds channels 8 (l + L i) ..); eps 1e-6. Every lane of
// the warp calls it; a group whose row is not live reads nothing and
// returns zeros.
template <int PER8, int L>
__device__ __forceinline__ void ln_row(const bf16* __restrict__ xr,
                                       const float* __restrict__ w,
                                       const float* __restrict__ b, int C,
                                       int gelu, bool live,
                                       uint4 (&out)[PER8]) {
  const int lane = threadIdx.x & (L - 1);
  float v[PER8][8], s = 0.f;
#pragma unroll
  for (int i = 0; i < PER8; ++i) {
    const int c = 8 * (lane + L * i);
    uint4 u = make_uint4(0, 0, 0, 0);
    if (live && c < C) u = __ldg(reinterpret_cast<const uint4*>(xr + c));
    const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[i][e] = to_f32(h[e]);
      s += v[i][e];
    }
  }
  const float mu = group_sum<L>(s) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < PER8; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = 8 * (lane + L * i) < C ? v[i][e] - mu : 0.f;
      q += d * d;
    }
  const float rs = rsqrtf(group_sum<L>(q) / C + HB_EPS);
#pragma unroll
  for (int i = 0; i < PER8; ++i) {
    const int c = 8 * (lane + L * i);
    out[i] = make_uint4(0, 0, 0, 0);
    if (!live || c >= C) continue;
    float wv[8], bv[8];
    *reinterpret_cast<float4*>(wv) = __ldg(reinterpret_cast<const float4*>(w + c));
    *reinterpret_cast<float4*>(wv + 4) =
        __ldg(reinterpret_cast<const float4*>(w + c + 4));
    *reinterpret_cast<float4*>(bv) = __ldg(reinterpret_cast<const float4*>(b + c));
    *reinterpret_cast<float4*>(bv + 4) =
        __ldg(reinterpret_cast<const float4*>(b + c + 4));
    bf16* o = reinterpret_cast<bf16*>(&out[i]);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float y = (v[i][e] - mu) * rs * wv[e] + bv[e];
      if (gelu) y = gelu_erf(y);
      o[e] = to_bf16(y);
    }
  }
}

// y [rows of the padded grid, C] = LN(x) (GELU(LN(x)) with gelu) at grid
// tokens, zeros at pad: a lane group of L lanes per row (32 / L rows a warp)
template <int PER8, int L>
__global__ void __launch_bounds__(128)
ln_fwd_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
              const float* __restrict__ w, const float* __restrict__ b,
              RowMap map, long rows, int C, int gelu) {
  const long p = ((long)blockIdx.x * 4 + (threadIdx.x >> 5)) * (32 / L) +
                 (threadIdx.x & 31) / L;
  const int lane = threadIdx.x & (L - 1);
  const long bi = p / ((long)map.Hp * map.Wp), t = p % ((long)map.Hp * map.Wp);
  const int yy = (int)(t / map.Wp), xx = (int)(t % map.Wp);
  const bool grid = p < rows && yy < map.H && xx < map.W;
  uint4 o[PER8];
  ln_row<PER8, L>(x + ((bi * map.H + yy) * map.W + xx) * C, w, b, C, gelu,
                  grid, o);
  if (p >= rows) return;
  bf16* yr = y + p * C;
#pragma unroll
  for (int i = 0; i < PER8; ++i) {
    const int c = 8 * (lane + L * i);
    if (c < C) *reinterpret_cast<uint4*>(yr + c) = o[i];
  }
}

static void ln_fwd(const bf16* x, bf16* y, const float* w, const float* b,
                   RowMap map, long rows, int C, cudaStream_t st,
                   int gelu = 0) {
  auto blocks = [&](int per_warp) {
    return (unsigned)((rows + 4 * per_warp - 1) / (4 * per_warp));
  };
  if (C <= 128)
    ln_fwd_kernel<1, 16><<<blocks(2), 128, 0, st>>>(x, y, w, b, map, rows, C,
                                                    gelu);
  else if (C <= 256)
    ln_fwd_kernel<1, 32><<<blocks(1), 128, 0, st>>>(x, y, w, b, map, rows, C,
                                                    gelu);
  else if (C <= 512)
    ln_fwd_kernel<2, 32><<<blocks(1), 128, 0, st>>>(x, y, w, b, map, rows, C,
                                                    gelu);
  else
    ln_fwd_kernel<4, 32><<<blocks(1), 128, 0, st>>>(x, y, w, b, map, rows, C,
                                                    gelu);
}
