// Hiera block backward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel sam2_video_tpu/ops/hiera_block_bwd.py
// fused_block_trainable (Pallas _mlp_bwd_kernel, B1, and _attn_bwd_kernel,
// B2): the block's backward from its input x and the residual after
// attention, x1, which the forward (hiera_block.cu) keeps.
//   B1 (hiera_block_bwd_mlp): recompute LN2 -> W1 -> exact-erf GELU from
//     x1, then dx1 = dy + LN2^T(...) and the LN2, W1, b1, W2, b2 gradients.
//   B2 (hiera_block_bwd_attn): recompute LN1 -> qkv (-> shortcut) and the
//     attention output with its row statistics, then dx and the LN1, qkv,
//     proj and (dim-change blocks) shortcut gradients.
//
// What bounds it on an H100 (SAM2-tiny, 384 px, 10 frames per call): about
// three times the forward's products (the recompute, then two products per
// forward product), ~0.78 TFLOP over the 12 blocks, against a few hundred
// MB of activations, so the tensor cores bound it. Every product runs on
// mma.sync (m16n8k16, f32 accumulate): the projections and MLP through the
// shared batched GEMM of common.cuh, which reads either operand row- or
// column-major, so no transpose is written; the attention in two kernels
// per (window, head), flash style: the forward kernel recomputes the
// output and keeps each query's row max, inverse row sum and
// D = dO . O; a query-tiled kernel then recomputes the scores over key
// chunks in shared memory and accumulates dq, and a key-tiled kernel
// accumulates dk and dv over query chunks. No [T, T] matrix is stored, so
// any window (global 24x24 or 32x32) fits.
//
// The TPU kernels sum every weight gradient over all tokens into one
// revisited VMEM block (its grid runs in order). Blocks here run in
// parallel: weight gradients are batched GEMMs over chunks of rows that
// write f32 partials, column sums write f32 partials per chunk of rows,
// and one last pass adds the partials in a fixed order. No float atomics:
// two runs give the same bits.
//
// Semantics of the reference (hieradet.py, which pads after norm1), as the
// TPU kernel keeps them: pad tokens of a padded window are keys with
// k = bk and v = bv, so their dk and dv flow into dbk and dbv and nowhere
// else; pad queries and cropped pooled queries get no gradient. The 2x2
// max-pool backward (q-pool and the dim-change shortcut) routes each
// cell's gradient as JAX's _unpool2x2_rows_cols does: to the column whose
// row-pair max is larger, then to the larger row of that column, the
// first on a tie.
//
// The C entry points launch their kernels in order on the caller's stream,
// carve their scratch from one workspace the caller allocates (its size
// from *_workspace_bytes) and return cudaGetLastError().

#include "hiera_window.cuh"

constexpr float HB_EPS = 1e-6f;
constexpr int CS_ROWS = 256;        // rows per column-sum partial
constexpr float NOT_KEPT = 1e30f;   // row max of a query with no gradient

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

// shortcut: ds [B, H, W, C] from the pooled gradient g [B, H/2, W/2, C] and
// the pre-pool values v [B, H, W, C]; ds is zeroed by the caller (rows and
// columns outside every cell of an odd grid keep their zeros)
__global__ void unpool2x2_kernel(const bf16* __restrict__ g,
                                 const bf16* __restrict__ v,
                                 bf16* __restrict__ ds, int B, int H, int W,
                                 int C) {
  const int Ho = H / 2, Wo = W / 2;
  const size_t total = (size_t)B * Ho * Wo * C;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int c = e % C;
    size_t t = e / C;
    const int ox = t % Wo;
    t /= Wo;
    const int oy = t % Ho;
    const int b = t / Ho;
    const size_t p = (((size_t)b * H + 2 * oy) * W + 2 * ox) * C + c;
    const size_t rs = (size_t)W * C;
    const int pick = unpool_pick(to_f32(v[p]), to_f32(v[p + C]),
                                 to_f32(v[p + rs]), to_f32(v[p + rs + C]));
    const size_t at = p + (pick >> 1) * rs + (pick & 1) * C;
    ds[at] = g[e];
  }
}

// ---------------------------------------------------------------------------
// Attention backward, flash style, per (window, head). Geometry as in
// window_attention_kernel: a window is wsh x wsw tokens of the zero-padded
// grid (pad tokens carry the rounded biases as q, k and v); with q_pool
// its queries are the 2x2 maxima of q inside the window, and the output
// grid is (H/2, W/2), pooled positions beyond it cropped. A query is
// "kept" where it lands on the output grid; others get no gradient.
// Both kernels: 4 warps, 16 rows (queries or keys) each; HDP is the head
// dim padded to 16 (zero columns add nothing).
// ---------------------------------------------------------------------------

constexpr int AB_TILE = 64;     // rows per block (4 warps x 16)
constexpr int AB_CHUNK = 64;    // rows per shared-memory chunk
constexpr int AB_THREADS = 128;

struct AttnGeom {
  int H, W, C, hd, heads, wsh, wsw, nWh, nWw, q_pool;
  int T, qh, qw, Tq, Ho, Wo;
};

static AttnGeom attn_geom(int H, int W, int C, int heads, int wsh, int wsw,
                          int q_pool) {
  AttnGeom g;
  g.H = H, g.W = W, g.C = C, g.heads = heads, g.hd = C / heads;
  g.wsh = wsh, g.wsw = wsw, g.q_pool = q_pool;
  g.nWh = (H + wsh - 1) / wsh, g.nWw = (W + wsw - 1) / wsw;
  g.T = wsh * wsw;
  g.qh = q_pool ? wsh / 2 : wsh, g.qw = q_pool ? wsw / 2 : wsw;
  g.Tq = g.qh * g.qw;
  g.Ho = q_pool ? H / 2 : H, g.Wo = q_pool ? W / 2 : W;
  return g;
}

// 8 consecutive bf16 of query qi of window (b, wy, wx), head h (2x2-pooled
// inside the window when q_pool)
__device__ __forceinline__ uint4 query8(const bf16* qkv, const bf16* Bq,
                                        const AttnGeom& G, int b, int wy,
                                        int wx, int h, int qi, int d0) {
  const int qy = qi / G.qw, qx = qi % G.qw, C3 = 3 * G.C, off = h * G.hd;
  if (G.q_pool) {
    const int y = wy * G.wsh + 2 * qy, x = wx * G.wsw + 2 * qx;
    return bmax8(
        bmax8(row8(qkv, Bq, b, y, x, G.H, G.W, C3, off, d0, G.hd),
              row8(qkv, Bq, b, y, x + 1, G.H, G.W, C3, off, d0, G.hd)),
        bmax8(row8(qkv, Bq, b, y + 1, x, G.H, G.W, C3, off, d0, G.hd),
              row8(qkv, Bq, b, y + 1, x + 1, G.H, G.W, C3, off, d0, G.hd)));
  }
  return row8(qkv, Bq, b, wy * G.wsh + qy, wx * G.wsw + qx, G.H, G.W, C3,
              off, d0, G.hd);
}

// output-grid token of query qi, or -1 when the query is not kept
__device__ __forceinline__ long kept_token(const AttnGeom& G, int b, int wy,
                                           int wx, int qi) {
  if (qi >= G.Tq) return -1;
  const int oy = wy * G.qh + qi / G.qw, ox = wx * G.qw + qi % G.qw;
  if (oy >= G.Ho || ox >= G.Wo) return -1;
  return ((long)b * G.Ho + oy) * G.Wo + ox;
}

// 8 consecutive bf16 of dO for query qi (zeros when not kept)
__device__ __forceinline__ uint4 dout8(const bf16* dout, const AttnGeom& G,
                                       long tok, int h, int d0) {
  if (tok < 0 || d0 >= G.hd) return make_uint4(0, 0, 0, 0);
  return *reinterpret_cast<const uint4*>(dout + tok * G.C + h * G.hd + d0);
}

// store the 8 bf16 of v into column r of a [HDP][ld] transposed tile
__device__ __forceinline__ void store_t8(bf16* t, int ld, int d0, int r,
                                         uint4 v) {
  unsigned short* t16 = reinterpret_cast<unsigned short*>(t);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    t16[(d0 + 2 * j) * ld + r] = (unsigned short)(w[j] & 0xffffu);
    t16[(d0 + 2 * j + 1) * ld + r] = (unsigned short)(w[j] >> 16);
  }
}

__device__ __forceinline__ void load_biases(const float* bqkv, bf16* Bq,
                                            bf16* Bk, bf16* Bv, int C, int h,
                                            int hd, int hdp) {
  for (int d = threadIdx.x; d < hdp; d += blockDim.x) {
    const bool in = d < hd;
    Bq[d] = to_bf16(in ? bqkv[h * hd + d] : 0.f);
    Bk[d] = to_bf16(in ? bqkv[C + h * hd + d] : 0.f);
    Bv[d] = to_bf16(in ? bqkv[2 * C + h * hd + d] : 0.f);
  }
}

template <int HDP>
static size_t dq_smem_bytes() {
  return sizeof(bf16) * ((size_t)(2 * AB_TILE + 2 * AB_CHUNK) *
                             (HDP + ATT_PAD) +
                         (size_t)HDP * (AB_CHUNK + ATT_PAD) + 3 * HDP);
}

// dq: one block per (64-query tile, head, window). For each key chunk:
// S = Q K^T, P = exp(S - m) * inv, dP = dO V^T, dS = P (dP - D) scale
// (rounded to bf16, the TPU kernel's walk), dq += dS K. Writes dq into
// columns [h*hd, (h+1)*hd) of dqkv at every real token the tile's queries
// cover (routed through the 2x2 cell when q_pool).
template <int HDP>
__global__ void __launch_bounds__(AB_THREADS)
attn_dq_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bqkv,
               const bf16* __restrict__ dout, AttnStats st,
               bf16* __restrict__ dqkv, AttnGeom G) {
  extern __shared__ __align__(16) unsigned char ab_smem[];
  constexpr int LD = HDP + ATT_PAD, LDT = AB_CHUNK + ATT_PAD, CPR = HDP / 8;
  bf16* Qs = reinterpret_cast<bf16*>(ab_smem);   // [AB_TILE][LD]
  bf16* dOs = Qs + AB_TILE * LD;                  // [AB_TILE][LD]
  bf16* Ks = dOs + AB_TILE * LD;                  // [AB_CHUNK][LD]
  bf16* Vs = Ks + AB_CHUNK * LD;                  // [AB_CHUNK][LD]
  bf16* Kt = Vs + AB_CHUNK * LD;                  // [HDP][LDT]
  bf16* Bq = Kt + HDP * LDT;
  bf16* Bk = Bq + HDP;
  bf16* Bv = Bk + HDP;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y;
  int win = blockIdx.z;
  const int wx = win % G.nWw;
  win /= G.nWw;
  const int wy = win % G.nWh;
  const int b = win / G.nWh;
  const int q0 = blockIdx.x * AB_TILE;
  const int C3 = 3 * G.C, hd = G.hd;
  const float scale = rsqrtf((float)hd);

  load_biases(bqkv, Bq, Bk, Bv, G.C, h, hd, HDP);
  __syncthreads();
  for (int e = tid; e < AB_TILE * CPR; e += AB_THREADS) {
    const int r = e / CPR, d0 = (e % CPR) * 8, qi = q0 + r;
    uint4 qv = make_uint4(0, 0, 0, 0), dv = qv;
    if (qi < G.Tq) {
      qv = query8(qkv, Bq, G, b, wy, wx, h, qi, d0);
      dv = dout8(dout, G, kept_token(G, b, wy, wx, qi), h, d0);
    }
    *reinterpret_cast<uint4*>(&Qs[r * LD + d0]) = qv;
    *reinterpret_cast<uint4*>(&dOs[r * LD + d0]) = dv;
  }
  __syncthreads();

  const int r0 = warp * 16;
  const bool active = q0 + r0 < G.Tq;
  uint32_t qf[HDP / 16][4], df[HDP / 16][4];
#pragma unroll
  for (int ks = 0; ks < HDP / 16; ++ks) {
    const int ra = (r0 + g) * LD + ks * 16 + 2 * t4, rb8 = ra + 8 * LD;
    qf[ks][0] = *reinterpret_cast<const uint32_t*>(&Qs[ra]);
    qf[ks][1] = *reinterpret_cast<const uint32_t*>(&Qs[rb8]);
    qf[ks][2] = *reinterpret_cast<const uint32_t*>(&Qs[ra + 8]);
    qf[ks][3] = *reinterpret_cast<const uint32_t*>(&Qs[rb8 + 8]);
    df[ks][0] = *reinterpret_cast<const uint32_t*>(&dOs[ra]);
    df[ks][1] = *reinterpret_cast<const uint32_t*>(&dOs[rb8]);
    df[ks][2] = *reinterpret_cast<const uint32_t*>(&dOs[ra + 8]);
    df[ks][3] = *reinterpret_cast<const uint32_t*>(&dOs[rb8 + 8]);
  }
  float mrow[2], irow[2], drow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long tok = kept_token(G, b, wy, wx, q0 + r0 + g + 8 * r);
    const size_t si = (size_t)tok * G.heads + h;
    mrow[r] = tok >= 0 ? st.m[si] : NOT_KEPT;
    irow[r] = tok >= 0 ? st.inv[si] : 0.f;
    drow[r] = tok >= 0 ? st.D[si] : 0.f;
  }

  float dq[HDP / 8][4];
#pragma unroll
  for (int dn = 0; dn < HDP / 8; ++dn)
    dq[dn][0] = dq[dn][1] = dq[dn][2] = dq[dn][3] = 0.f;

  for (int k0 = 0; k0 < G.T; k0 += AB_CHUNK) {
    __syncthreads();
    for (int e = tid; e < AB_CHUNK * CPR; e += AB_THREADS) {
      const int kk = e / CPR, d0 = (e % CPR) * 8, ki = k0 + kk;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
      if (ki < G.T) {
        const int y = wy * G.wsh + ki / G.wsw, x = wx * G.wsw + ki % G.wsw;
        kv = row8(qkv, Bk, b, y, x, G.H, G.W, C3, G.C + h * hd, d0, hd);
        vv = row8(qkv, Bv, b, y, x, G.H, G.W, C3, 2 * G.C + h * hd, d0, hd);
      }
      *reinterpret_cast<uint4*>(&Ks[kk * LD + d0]) = kv;
      *reinterpret_cast<uint4*>(&Vs[kk * LD + d0]) = vv;
      store_t8(Kt, LDT, d0, kk, kv);
    }
    __syncthreads();
    if (!active) continue;

    float s[AB_CHUNK / 8][4], dp[AB_CHUNK / 8][4];
#pragma unroll
    for (int nt = 0; nt < AB_CHUNK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = dp[nt][j] = 0.f;
#pragma unroll
      for (int ks = 0; ks < HDP / 16; ++ks) {
        const int c = (nt * 8 + g) * LD + ks * 16 + 2 * t4;
        const uint32_t bk[2] = {*reinterpret_cast<const uint32_t*>(&Ks[c]),
                                *reinterpret_cast<const uint32_t*>(&Ks[c + 8])};
        const uint32_t bv[2] = {*reinterpret_cast<const uint32_t*>(&Vs[c]),
                                *reinterpret_cast<const uint32_t*>(&Vs[c + 8])};
        mma_16816(s[nt], qf[ks], bk);
        mma_16816(dp[nt], df[ks], bv);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + nt * 8 + 2 * t4 + (j & 1), r = j >> 1;
        const float p =
            key < G.T ? expf(s[nt][j] * scale - mrow[r]) * irow[r] : 0.f;
        s[nt][j] = p * (dp[nt][j] - drow[r]) * scale;      // dS
      }
    }
#pragma unroll
    for (int kb = 0; kb < AB_CHUNK / 16; ++kb) {
      const float* s0 = s[2 * kb];
      const float* s1 = s[2 * kb + 1];
      const uint32_t af[4] = {pack_bf16x2(s0[0], s0[1]),
                              pack_bf16x2(s0[2], s0[3]),
                              pack_bf16x2(s1[0], s1[1]),
                              pack_bf16x2(s1[2], s1[3])};
#pragma unroll
      for (int dn = 0; dn < HDP / 8; ++dn) {
        const bf16* kr = &Kt[(dn * 8 + g) * LDT + kb * 16 + 2 * t4];
        const uint32_t bfr[2] = {*reinterpret_cast<const uint32_t*>(kr),
                                 *reinterpret_cast<const uint32_t*>(kr + 8)};
        mma_16816(dq[dn], af, bfr);
      }
    }
  }
  if (!active) return;

  const int ndn = hd / 8;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + g + 8 * r;
    if (qi >= G.Tq) continue;
    const int qy = qi / G.qw, qx = qi % G.qw;
    if (!G.q_pool) {
      const int y = wy * G.wsh + qy, x = wx * G.wsw + qx;
      if (y >= G.H || x >= G.W) continue;
      bf16* dst = dqkv + (((size_t)b * G.H + y) * G.W + x) * C3 + h * hd;
#pragma unroll
      for (int dn = 0; dn < HDP / 8; ++dn)
        if (dn < ndn)
          *reinterpret_cast<__nv_bfloat162*>(dst + dn * 8 + 2 * t4) =
              __floats2bfloat162_rn(dq[dn][2 * r], dq[dn][2 * r + 1]);
      continue;
    }
    const int y0 = wy * G.wsh + 2 * qy, x0 = wx * G.wsw + 2 * qx;
#pragma unroll
    for (int dn = 0; dn < HDP / 8; ++dn) {
      if (dn >= ndn) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = dn * 8 + 2 * t4 + j;
        float v[4];
        size_t at[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int y = y0 + (c >> 1), x = x0 + (c & 1);
          const bool real = y < G.H && x < G.W;
          at[c] = real ? (((size_t)b * G.H + y) * G.W + x) * C3 + h * hd + d
                       : (size_t)-1;
          v[c] = real ? to_f32(qkv[at[c]]) : to_f32(Bq[d]);
        }
        const int pick = unpool_pick(v[0], v[1], v[2], v[3]);
        const bf16 val = to_bf16(dq[dn][2 * r + j]);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (at[c] != (size_t)-1) dqkv[at[c]] = c == pick ? val : to_bf16(0.f);
      }
    }
  }
}

template <int HDP>
static size_t dkv_smem_bytes() {
  return sizeof(bf16) * ((size_t)(2 * AB_TILE + 2 * AB_CHUNK) *
                             (HDP + ATT_PAD) +
                         2 * (size_t)HDP * (AB_CHUNK + ATT_PAD) + 3 * HDP) +
         sizeof(float) * (3 * AB_CHUNK + 4 * 2 * HDP);
}

// dk, dv: one block per (64-key tile, head, window). For each query chunk:
// S^T = K Q^T, P^T = exp(S^T - m) * inv, dP^T = V dO^T,
// dS^T = P^T (dP^T - D) scale, dv += bf16(P^T) dO, dk += bf16(dS^T) Q.
// Real keys write columns C + h*hd and 2C + h*hd of dqkv; pad keys' dk, dv
// are summed over the tile into padpart[slot * 3C + C + h*hd + d] and
// [... + 2C + ...] (slot = window * tiles + tile), when padpart is given.
template <int HDP>
__global__ void __launch_bounds__(AB_THREADS)
attn_dkv_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bqkv,
                const bf16* __restrict__ dout, AttnStats st,
                bf16* __restrict__ dqkv, float* __restrict__ padpart,
                AttnGeom G) {
  extern __shared__ __align__(16) unsigned char ab_smem[];
  constexpr int LD = HDP + ATT_PAD, LDT = AB_CHUNK + ATT_PAD, CPR = HDP / 8;
  bf16* Ks = reinterpret_cast<bf16*>(ab_smem);   // [AB_TILE][LD]
  bf16* Vs = Ks + AB_TILE * LD;                   // [AB_TILE][LD]
  bf16* Qs = Vs + AB_TILE * LD;                   // [AB_CHUNK][LD]
  bf16* dOs = Qs + AB_CHUNK * LD;                 // [AB_CHUNK][LD]
  bf16* Qt = dOs + AB_CHUNK * LD;                 // [HDP][LDT]
  bf16* dOt = Qt + HDP * LDT;                     // [HDP][LDT]
  bf16* Bq = dOt + HDP * LDT;
  bf16* Bk = Bq + HDP;
  bf16* Bv = Bk + HDP;
  float* sm = reinterpret_cast<float*>(Bv + HDP);  // [AB_CHUNK] x 3
  float* si = sm + AB_CHUNK;
  float* sD = si + AB_CHUNK;
  float* red = sD + AB_CHUNK;                      // [4][2 * HDP]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y;
  int win = blockIdx.z;
  const int wx = win % G.nWw;
  win /= G.nWw;
  const int wy = win % G.nWh;
  const int b = win / G.nWh;
  const int k0 = blockIdx.x * AB_TILE;
  const int C3 = 3 * G.C, hd = G.hd;
  const float scale = rsqrtf((float)hd);

  load_biases(bqkv, Bq, Bk, Bv, G.C, h, hd, HDP);
  __syncthreads();
  for (int e = tid; e < AB_TILE * CPR; e += AB_THREADS) {
    const int kk = e / CPR, d0 = (e % CPR) * 8, ki = k0 + kk;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
    if (ki < G.T) {
      const int y = wy * G.wsh + ki / G.wsw, x = wx * G.wsw + ki % G.wsw;
      kv = row8(qkv, Bk, b, y, x, G.H, G.W, C3, G.C + h * hd, d0, hd);
      vv = row8(qkv, Bv, b, y, x, G.H, G.W, C3, 2 * G.C + h * hd, d0, hd);
    }
    *reinterpret_cast<uint4*>(&Ks[kk * LD + d0]) = kv;
    *reinterpret_cast<uint4*>(&Vs[kk * LD + d0]) = vv;
  }

  const int r0 = warp * 16;
  const bool active = k0 + r0 < G.T;
  float dk[HDP / 8][4], dv[HDP / 8][4];
#pragma unroll
  for (int dn = 0; dn < HDP / 8; ++dn)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[dn][j] = dv[dn][j] = 0.f;

  for (int q0 = 0; q0 < G.Tq; q0 += AB_CHUNK) {
    __syncthreads();
    for (int e = tid; e < AB_CHUNK * CPR; e += AB_THREADS) {
      const int r = e / CPR, d0 = (e % CPR) * 8, qi = q0 + r;
      uint4 qv = make_uint4(0, 0, 0, 0), ov = qv;
      if (qi < G.Tq) {
        qv = query8(qkv, Bq, G, b, wy, wx, h, qi, d0);
        ov = dout8(dout, G, kept_token(G, b, wy, wx, qi), h, d0);
      }
      *reinterpret_cast<uint4*>(&Qs[r * LD + d0]) = qv;
      *reinterpret_cast<uint4*>(&dOs[r * LD + d0]) = ov;
      store_t8(Qt, LDT, d0, r, qv);
      store_t8(dOt, LDT, d0, r, ov);
    }
    for (int r = tid; r < AB_CHUNK; r += AB_THREADS) {
      const long tok = kept_token(G, b, wy, wx, q0 + r);
      const size_t i = (size_t)tok * G.heads + h;
      sm[r] = tok >= 0 ? st.m[i] : NOT_KEPT;
      si[r] = tok >= 0 ? st.inv[i] : 0.f;
      sD[r] = tok >= 0 ? st.D[i] : 0.f;
    }
    __syncthreads();
    if (!active) continue;

    float s[AB_CHUNK / 8][4], dp[AB_CHUNK / 8][4];
#pragma unroll
    for (int nt = 0; nt < AB_CHUNK / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = dp[nt][j] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HDP / 16; ++ks) {
      const int c = ks * 16 + 2 * t4;
      uint32_t ka[4], va[4];
      const int ra = (r0 + g) * LD + c, rb8 = (r0 + g + 8) * LD + c;
      ka[0] = *reinterpret_cast<const uint32_t*>(&Ks[ra]);
      ka[1] = *reinterpret_cast<const uint32_t*>(&Ks[rb8]);
      ka[2] = *reinterpret_cast<const uint32_t*>(&Ks[ra + 8]);
      ka[3] = *reinterpret_cast<const uint32_t*>(&Ks[rb8 + 8]);
      va[0] = *reinterpret_cast<const uint32_t*>(&Vs[ra]);
      va[1] = *reinterpret_cast<const uint32_t*>(&Vs[rb8]);
      va[2] = *reinterpret_cast<const uint32_t*>(&Vs[ra + 8]);
      va[3] = *reinterpret_cast<const uint32_t*>(&Vs[rb8 + 8]);
#pragma unroll
      for (int nt = 0; nt < AB_CHUNK / 8; ++nt) {
        const int o = (nt * 8 + g) * LD + c;
        const uint32_t bq[2] = {*reinterpret_cast<const uint32_t*>(&Qs[o]),
                                *reinterpret_cast<const uint32_t*>(&Qs[o + 8])};
        const uint32_t bo[2] = {*reinterpret_cast<const uint32_t*>(&dOs[o]),
                                *reinterpret_cast<const uint32_t*>(&dOs[o + 8])};
        mma_16816(s[nt], ka, bq);
        mma_16816(dp[nt], va, bo);
      }
    }
    // s becomes P^T, dp becomes dS^T
#pragma unroll
    for (int nt = 0; nt < AB_CHUNK / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = nt * 8 + 2 * t4 + (j & 1);
        const float p = si[q] > 0.f ? expf(s[nt][j] * scale - sm[q]) * si[q]
                                    : 0.f;
        s[nt][j] = p;
        dp[nt][j] = p * (dp[nt][j] - sD[q]) * scale;
      }
#pragma unroll
    for (int kb = 0; kb < AB_CHUNK / 16; ++kb) {
      const uint32_t pf[4] = {
          pack_bf16x2(s[2 * kb][0], s[2 * kb][1]),
          pack_bf16x2(s[2 * kb][2], s[2 * kb][3]),
          pack_bf16x2(s[2 * kb + 1][0], s[2 * kb + 1][1]),
          pack_bf16x2(s[2 * kb + 1][2], s[2 * kb + 1][3])};
      const uint32_t sf[4] = {
          pack_bf16x2(dp[2 * kb][0], dp[2 * kb][1]),
          pack_bf16x2(dp[2 * kb][2], dp[2 * kb][3]),
          pack_bf16x2(dp[2 * kb + 1][0], dp[2 * kb + 1][1]),
          pack_bf16x2(dp[2 * kb + 1][2], dp[2 * kb + 1][3])};
#pragma unroll
      for (int dn = 0; dn < HDP / 8; ++dn) {
        const int o = (dn * 8 + g) * LDT + kb * 16 + 2 * t4;
        const uint32_t bo[2] = {*reinterpret_cast<const uint32_t*>(&dOt[o]),
                                *reinterpret_cast<const uint32_t*>(&dOt[o + 8])};
        const uint32_t bq[2] = {*reinterpret_cast<const uint32_t*>(&Qt[o]),
                                *reinterpret_cast<const uint32_t*>(&Qt[o + 8])};
        mma_16816(dv[dn], pf, bo);
        mma_16816(dk[dn], sf, bq);
      }
    }
  }

  // real keys: dk, dv into dqkv; pad keys: this warp's sums
  const int ndn = hd / 8;
  float pk[HDP / 8][2], pv[HDP / 8][2];
#pragma unroll
  for (int dn = 0; dn < HDP / 8; ++dn)
    pk[dn][0] = pk[dn][1] = pv[dn][0] = pv[dn][1] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int ki = k0 + r0 + g + 8 * r;
    if (ki >= G.T) continue;
    const int y = wy * G.wsh + ki / G.wsw, x = wx * G.wsw + ki % G.wsw;
    if (y < G.H && x < G.W) {
      bf16* dst = dqkv + (((size_t)b * G.H + y) * G.W + x) * C3 + h * hd;
#pragma unroll
      for (int dn = 0; dn < HDP / 8; ++dn)
        if (dn < ndn) {
          *reinterpret_cast<__nv_bfloat162*>(dst + G.C + dn * 8 + 2 * t4) =
              __floats2bfloat162_rn(dk[dn][2 * r], dk[dn][2 * r + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dst + 2 * G.C + dn * 8 +
                                             2 * t4) =
              __floats2bfloat162_rn(dv[dn][2 * r], dv[dn][2 * r + 1]);
        }
    } else {
#pragma unroll
      for (int dn = 0; dn < HDP / 8; ++dn) {
        pk[dn][0] += dk[dn][2 * r];
        pk[dn][1] += dk[dn][2 * r + 1];
        pv[dn][0] += dv[dn][2 * r];
        pv[dn][1] += dv[dn][2 * r + 1];
      }
    }
  }
  if (!padpart) return;
  // pad sums: over the 8 lanes of one column pair, then the 4 warps in order
#pragma unroll
  for (int dn = 0; dn < HDP / 8; ++dn)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        pk[dn][j] += __shfl_xor_sync(0xffffffff, pk[dn][j], o);
        pv[dn][j] += __shfl_xor_sync(0xffffffff, pv[dn][j], o);
      }
  if (g == 0) {
#pragma unroll
    for (int dn = 0; dn < HDP / 8; ++dn)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        red[warp * 2 * HDP + dn * 8 + 2 * t4 + j] = pk[dn][j];
        red[warp * 2 * HDP + HDP + dn * 8 + 2 * t4 + j] = pv[dn][j];
      }
  }
  __syncthreads();
  const size_t slot = (size_t)blockIdx.z * gridDim.x + blockIdx.x;
  for (int d = tid; d < hd; d += AB_THREADS) {
    float sk = 0.f, sv = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      sk += red[w * 2 * HDP + d];
      sv += red[w * 2 * HDP + HDP + d];
    }
    padpart[slot * C3 + G.C + h * hd + d] = sk;
    padpart[slot * C3 + 2 * G.C + h * hd + d] = sv;
  }
}

template <int HDP>
static void attn_bwd_at(const bf16* qkv, const float* bqkv, const bf16* dout,
                        const AttnStats& st, bf16* dqkv, float* padpart,
                        const AttnGeom& G, int B, cudaStream_t stream) {
  const size_t s_dq = dq_smem_bytes<HDP>(), s_dkv = dkv_smem_bytes<HDP>();
  static bool opted = false;
  if (!opted) {
    cudaFuncSetAttribute(attn_dq_kernel<HDP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)s_dq);
    cudaFuncSetAttribute(attn_dkv_kernel<HDP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)s_dkv);
    opted = true;
  }
  const int wins = B * G.nWh * G.nWw;
  dim3 gq((G.Tq + AB_TILE - 1) / AB_TILE, G.heads, wins);
  attn_dq_kernel<HDP><<<gq, AB_THREADS, s_dq, stream>>>(qkv, bqkv, dout, st,
                                                        dqkv, G);
  dim3 gk((G.T + AB_TILE - 1) / AB_TILE, G.heads, wins);
  attn_dkv_kernel<HDP><<<gk, AB_THREADS, s_dkv, stream>>>(
      qkv, bqkv, dout, st, dqkv, padpart, G);
}

static void attn_bwd(const bf16* qkv, const float* bqkv, const bf16* dout,
                     const AttnStats& st, bf16* dqkv, float* padpart,
                     const AttnGeom& G, int B, cudaStream_t stream) {
  const int hdp = (G.hd + 15) & ~15;
  if (hdp <= 64)
    attn_bwd_at<64>(qkv, bqkv, dout, st, dqkv, padpart, G, B, stream);
  else if (hdp <= 96)
    attn_bwd_at<96>(qkv, bqkv, dout, st, dqkv, padpart, G, B, stream);
  else
    attn_bwd_at<128>(qkv, bqkv, dout, st, dqkv, padpart, G, B, stream);
}

// ---------------------------------------------------------------------------
// Weight gradients over many rows: dW[Nout, Nin] = sum_r A(r, :)^T B(r, :)
// as batched-GEMM partials over chunks of rows (about 512 blocks in all,
// chunks of at least 256 rows, a multiple of 32, the last one ragged).
// ---------------------------------------------------------------------------

struct Chunks {
  int Z;
  long rows, last;
};

static Chunks row_chunks(long M, int Nout, int Nin) {
  const int tiles = ((Nout + GEMM_BM - 1) / GEMM_BM) *
                    ((Nin + GEMM_BN - 1) / GEMM_BN);
  long Z = (512 + tiles - 1) / tiles;
  const long maxZ = (M + 255) / 256;
  if (Z > maxZ) Z = maxZ;
  if (Z < 1) Z = 1;
  long rows = (M + Z - 1) / Z;
  rows = (rows + 31) / 32 * 32;
  Chunks c;
  c.Z = (int)((M + rows - 1) / rows);
  c.rows = rows;
  c.last = M - (long)(c.Z - 1) * rows;
  return c;
}

static void wgrad(const bf16* A, int lda, const bf16* B, int ldb, long M,
                  int Nout, int Nin, float* part, cudaStream_t st) {
  const Chunks c = row_chunks(M, Nout, Nin);
  BEpi e = bepi(Nin, (long)Nout * Nin);
  e.out32 = part;
  bgemm<true, true>(A, lda, c.rows * lda, B, ldb, c.rows * ldb, Nout, Nin,
                    (int)c.rows, c.Z, e, st, (int)c.last);
}

static int cs_chunks(long M) { return (int)((M + CS_ROWS - 1) / CS_ROWS); }

// ---------------------------------------------------------------------------
// B1: LN2 + MLP backward. Weight table (the forward's, ops/hiera_block_
// kernel.py pack): ln1w ln1b Wqkv bqkv Wproj bproj ln2w ln2b W1 b1 W2 b2
// Wsc bsc. Gradients (f32): dln2w[C] dln2b[C] dW1[Hd, C] db1[Hd]
// dW2[C, Hd] db2[C].
// ---------------------------------------------------------------------------

enum { W_LN1W, W_LN1B, W_QKV, W_BQKV, W_PROJ, W_BPROJ, W_LN2W, W_LN2B, W_1,
       W_B1, W_2, W_B2, W_SC, W_BSC };

struct MlpBufs {
  bf16 *y, *a, *h, *dac;
  float *da32, *dyln, *pw1, *pw2, *pb1, *pb2, *pl2w, *pl2b;
  float2* st;
};

static MlpBufs carve_mlp(Arena& ar, long M, int C, int Hd) {
  MlpBufs b{};
  b.y = ar.take<bf16>(M * C);
  b.a = ar.take<bf16>(M * Hd);
  b.h = ar.take<bf16>(M * Hd);
  b.dac = ar.take<bf16>(M * Hd);
  b.da32 = ar.take<float>(M * Hd);
  b.dyln = ar.take<float>(M * C);
  b.st = ar.take<float2>(M);
  b.pw1 = ar.take<float>((size_t)row_chunks(M, Hd, C).Z * Hd * C);
  b.pw2 = ar.take<float>((size_t)row_chunks(M, C, Hd).Z * C * Hd);
  const size_t zc = cs_chunks(M);
  b.pb1 = ar.take<float>(zc * Hd);
  b.pb2 = ar.take<float>(zc * C);
  b.pl2w = ar.take<float>(zc * C);
  b.pl2b = ar.take<float>(zc * C);
  return b;
}

extern "C" long hiera_bwd_mlp_workspace_bytes(long M, int C, int Hd) {
  Arena ar{nullptr, 0};
  carve_mlp(ar, M, C, Hd);
  return (long)ar.off;
}

extern "C" int hiera_block_bwd_mlp(const void* x1_, const void* dy_,
                                   void* dx1, const void* const* w,
                                   void* grads, void* ws, long M, int C,
                                   int Hd, void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  Arena ar{static_cast<char*>(ws), 0};
  MlpBufs b = carve_mlp(ar, M, C, Hd);
  auto Wt = [&](int i) { return static_cast<const bf16*>(w[i]); };
  auto F = [&](int i) { return static_cast<const float*>(w[i]); };
  const bf16* x1 = static_cast<const bf16*>(x1_);
  const bf16* dy = static_cast<const bf16*>(dy_);
  float* G = static_cast<float*>(grads);
  const long g_ln2b = C, g_w1 = 2 * C, g_b1 = g_w1 + (long)Hd * C,
             g_w2 = g_b1 + Hd, g_b2 = g_w2 + (long)C * Hd;
  const int zc = cs_chunks(M);

  // recompute: y = LN2(x1), a = y W1^T + b1 (bf16 walk), h = GELU(a)
  layer_norm<bf16>(x1, b.y, F(W_LN2W), F(W_LN2B), (int)M, C, 1, HB_EPS, 0,
                   st);
  BEpi e = bepi(Hd);
  e.bias = F(W_B1);
  e.pre = b.a;
  e.gelu = 1;
  e.out = b.h;
  bgemm<false, false>(b.y, C, 0, Wt(W_1), C, 0, (int)M, Hd, C, 1, e, st);

  // da = (dy W2) GELU'(a), f32 and rounded
  e = bepi(Hd);
  e.dgelu = b.a;
  e.out = b.dac;
  e.out32 = b.da32;
  bgemm<false, true>(dy, C, 0, Wt(W_2), Hd, 0, (int)M, Hd, C, 1, e, st);
  colsum(b.da32, nullptr, Hd, nullptr, nullptr, CS_ROWS, M, Hd, b.pb1, Hd,
         st);
  wgrad(b.dac, Hd, b.y, C, M, Hd, C, b.pw1, st);       // dW1 = da^T y
  wgrad(dy, C, b.h, Hd, M, C, Hd, b.pw2, st);          // dW2 = dy^T h
  colsum(nullptr, dy, C, nullptr, nullptr, CS_ROWS, M, C, b.pb2, C, st);
  e = bepi(C);
  e.out32 = b.dyln;                                    // dy_ln = da W1
  bgemm<false, true>(b.dac, Hd, 0, Wt(W_1), C, 0, (int)M, C, Hd, 1, e, st);

  // LN2 backward + residual: dx1 = dy + LN2'(dy_ln)
  ln_bwd(x1, F(W_LN2W), b.dyln, nullptr, dy, nullptr, static_cast<bf16*>(dx1),
         b.st, (int)M, C, HB_EPS, st);
  colsum(b.dyln, nullptr, C, x1, b.st, CS_ROWS, M, C, b.pl2w, C, st);
  colsum(b.dyln, nullptr, C, nullptr, nullptr, CS_ROWS, M, C, b.pl2b, C,
         st);

  reduce_cols(b.pl2w, zc, C, G, st);
  reduce_cols(b.pl2b, zc, C, G + g_ln2b, st);
  reduce_cols(b.pw1, row_chunks(M, Hd, C).Z, (long)Hd * C, G + g_w1, st);
  reduce_cols(b.pb1, zc, Hd, G + g_b1, st);
  reduce_cols(b.pw2, row_chunks(M, C, Hd).Z, (long)C * Hd, G + g_w2, st);
  reduce_cols(b.pb2, zc, C, G + g_b2, st);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B2: LN1 + attention + shortcut backward. Gradients (f32): dln1w[Cin]
// dln1b[Cin] dWqkv[3C, Cin] dbqkv[3C] dWproj[C, C] dbproj[C], then, on
// dim-change blocks, dWsc[C, Cin] dbsc[C].
// ---------------------------------------------------------------------------

struct AttnBufs {
  bf16 *xn, *qkv, *scf, *dob, *o, *dqkv, *dsp;
  float *sm, *sinv, *sD, *dxn, *pwp, *pbp, *pwqkv, *pbqkv, *pwsc, *pbsc,
      *pl1w, *pl1b;
  float2* st;
  int nslots;
};

static AttnBufs carve_attn(Arena& ar, int B, int H, int W, int Cin, int C,
                           int heads, int wsh, int wsw, int q_pool) {
  const AttnGeom G = attn_geom(H, W, C, heads, wsh, wsw, q_pool);
  const long Mi = (long)B * H * W, Mo = (long)B * G.Ho * G.Wo;
  const bool sc = Cin != C;
  AttnBufs b{};
  b.nslots = (H % wsh || W % wsw)
                 ? B * G.nWh * G.nWw * ((G.T + AB_TILE - 1) / AB_TILE)
                 : 0;
  b.xn = ar.take<bf16>(Mi * Cin);
  b.qkv = ar.take<bf16>(Mi * 3 * C);
  b.scf = sc && q_pool ? ar.take<bf16>(Mi * C) : nullptr;
  b.dob = ar.take<bf16>(Mo * C);
  b.o = ar.take<bf16>(Mo * C);
  b.sm = ar.take<float>(Mo * heads);
  b.sinv = ar.take<float>(Mo * heads);
  b.sD = ar.take<float>(Mo * heads);
  b.dqkv = ar.take<bf16>(Mi * 3 * C);
  b.dsp = sc && q_pool ? ar.take<bf16>(Mi * C) : nullptr;
  b.dxn = ar.take<float>(Mi * Cin);
  b.st = ar.take<float2>(Mi);
  const size_t zi = cs_chunks(Mi), zo = cs_chunks(Mo);
  b.pwp = ar.take<float>((size_t)row_chunks(Mo, C, C).Z * C * C);
  b.pbp = ar.take<float>(zo * C);
  b.pwqkv = ar.take<float>((size_t)row_chunks(Mi, 3 * C, Cin).Z * 3 * C *
                           Cin);
  b.pbqkv = ar.take<float>((zi + b.nslots) * 3 * C);
  if (sc) {
    b.pwsc = ar.take<float>((size_t)row_chunks(Mi, C, Cin).Z * C * Cin);
    b.pbsc = ar.take<float>(zi * C);
  }
  b.pl1w = ar.take<float>(zi * Cin);
  b.pl1b = ar.take<float>(zi * Cin);
  return b;
}

extern "C" long hiera_bwd_attn_workspace_bytes(int B, int H, int W, int Cin,
                                               int C, int heads, int wsh,
                                               int wsw, int q_pool) {
  Arena ar{nullptr, 0};
  carve_attn(ar, B, H, W, Cin, C, heads, wsh, wsw, q_pool);
  return (long)ar.off;
}

extern "C" int hiera_block_bwd_attn(const void* x_, const void* dx1_,
                                    void* dx, const void* const* w,
                                    void* grads, void* ws, int B, int H,
                                    int W, int Cin, int C, int heads,
                                    int wsh, int wsw, int q_pool,
                                    void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  Arena ar{static_cast<char*>(ws), 0};
  AttnBufs b = carve_attn(ar, B, H, W, Cin, C, heads, wsh, wsw, q_pool);
  const AttnGeom G = attn_geom(H, W, C, heads, wsh, wsw, q_pool);
  auto Wt = [&](int i) { return static_cast<const bf16*>(w[i]); };
  auto F = [&](int i) { return static_cast<const float*>(w[i]); };
  const bf16* x = static_cast<const bf16*>(x_);
  const bf16* gz = static_cast<const bf16*>(dx1_);
  float* Gr = static_cast<float*>(grads);
  const long Mi = (long)B * H * W, Mo = (long)B * G.Ho * G.Wo;
  const int C3 = 3 * C, zi = cs_chunks(Mi), zo = cs_chunks(Mo);
  const bool sc = w[W_SC] != nullptr;
  const long g_ln1b = Cin, g_wqkv = 2 * Cin, g_bqkv = g_wqkv + (long)C3 * Cin,
             g_wp = g_bqkv + C3, g_bp = g_wp + (long)C * C, g_wsc = g_bp + C,
             g_bsc = g_wsc + (long)C * Cin;

  // recompute: xn = LN1(x), qkv, the shortcut's pre-pool values
  layer_norm<bf16>(x, b.xn, F(W_LN1W), F(W_LN1B), (int)Mi, Cin, 1, HB_EPS, 0,
                   st);
  gemm(DenseA{b.xn, Cin}, Wt(W_QKV), b.qkv, (int)Mi, C3, Cin,
       epi(F(W_BQKV)), st);
  if (sc && q_pool)
    gemm(DenseA{b.xn, Cin}, Wt(W_SC), b.scf, (int)Mi, C, Cin, epi(F(W_BSC)),
         st);

  // dO = dx1 Wproj (bf16), then the attention output and its statistics
  BEpi e = bepi(C);
  e.out = b.dob;
  bgemm<false, true>(gz, C, 0, Wt(W_PROJ), C, 0, (int)Mo, C, C, 1, e, st);
  const AttnStats as{b.sm, b.sinv, b.sD, b.dob, heads};
  window_attention(b.qkv, F(W_BQKV), b.o, B, H, W, C, heads, wsh, wsw, q_pool,
                   as, st);
  wgrad(gz, C, b.o, C, Mo, C, C, b.pwp, st);            // dWproj = dx1^T o
  colsum(nullptr, gz, C, nullptr, nullptr, CS_ROWS, Mo, C, b.pbp, C, st);

  // attention: dq into dqkv[:, :C], dk and dv into dqkv[:, C:], pad keys'
  // dk and dv into the slots after the bias partials
  float* padpart = b.nslots ? b.pbqkv + (size_t)zi * C3 : nullptr;
  if (padpart)
    cudaMemsetAsync(padpart, 0, sizeof(float) * (size_t)b.nslots * C3, st);
  attn_bwd(b.qkv, F(W_BQKV), b.dob, as, b.dqkv, padpart, G, B, st);

  // qkv projection
  wgrad(b.dqkv, C3, b.xn, Cin, Mi, C3, Cin, b.pwqkv, st);
  colsum(nullptr, b.dqkv, C3, nullptr, nullptr, CS_ROWS, Mi, C3, b.pbqkv,
         C3, st);
  e = bepi(Cin);
  e.out32 = b.dxn;                                      // dxn = dqkv Wqkv
  bgemm<false, true>(b.dqkv, C3, 0, Wt(W_QKV), Cin, 0, (int)Mi, Cin, C3, 1, e,
                     st);

  // shortcut projection (dim-change blocks), through the 2x2 max-pool
  if (sc) {
    const bf16* dsp = gz;
    if (q_pool) {
      cudaMemsetAsync(b.dsp, 0, sizeof(bf16) * (size_t)Mi * C, st);
      const size_t total = (size_t)Mo * C;
      const int blocks =
          (int)((total + 255) / 256 < 65535 ? (total + 255) / 256 : 65535);
      unpool2x2_kernel<<<blocks, 256, 0, st>>>(gz, b.scf, b.dsp, B, H, W, C);
      dsp = b.dsp;
    }
    wgrad(dsp, C, b.xn, Cin, Mi, C, Cin, b.pwsc, st);   // dWsc = ds^T xn
    colsum(nullptr, dsp, C, nullptr, nullptr, CS_ROWS, Mi, C, b.pbsc, C, st);
    e = bepi(Cin);
    e.res32 = b.dxn;
    e.out32 = b.dxn;                                    // dxn += ds Wsc
    bgemm<false, true>(dsp, C, 0, Wt(W_SC), Cin, 0, (int)Mi, Cin, C, 1, e,
                       st);
  }

  // LN1 backward (+ the identity shortcut's gradient)
  ln_bwd(x, F(W_LN1W), b.dxn, nullptr, sc ? nullptr : gz, nullptr,
         static_cast<bf16*>(dx), b.st, (int)Mi, Cin, HB_EPS, st);
  colsum(b.dxn, nullptr, Cin, x, b.st, CS_ROWS, Mi, Cin, b.pl1w, Cin, st);
  colsum(b.dxn, nullptr, Cin, nullptr, nullptr, CS_ROWS, Mi, Cin, b.pl1b,
         Cin, st);

  reduce_cols(b.pl1w, zi, Cin, Gr, st);
  reduce_cols(b.pl1b, zi, Cin, Gr + g_ln1b, st);
  reduce_cols(b.pwqkv, row_chunks(Mi, C3, Cin).Z, (long)C3 * Cin,
              Gr + g_wqkv, st);
  reduce_cols(b.pbqkv, zi + b.nslots, C3, Gr + g_bqkv, st);
  reduce_cols(b.pwp, row_chunks(Mo, C, C).Z, (long)C * C, Gr + g_wp, st);
  reduce_cols(b.pbp, zo, C, Gr + g_bp, st);
  if (sc) {
    reduce_cols(b.pwsc, row_chunks(Mi, C, Cin).Z, (long)C * Cin, Gr + g_wsc,
                st);
    reduce_cols(b.pbsc, zi, C, Gr + g_bsc, st);
  }
  return (int)cudaGetLastError();
}
