// Hiera attention on the tensor cores, for the block's forward
// (hiera_block.cu, kernel #1): the 2x2 max-pool of the shortcut, and
// windowed / global attention with pad tokens as keys and 2x2 q-pooling
// inside each window.
#pragma once

#include "common.cuh"

// ---------------------------------------------------------------------------
// 2x2 / stride-2 max-pool of the shortcut, NHWC (VALID: floor(H/2)).
// ---------------------------------------------------------------------------

__global__ void maxpool2x2_kernel(const bf16* __restrict__ x,
                                  bf16* __restrict__ y, int B, int H, int W,
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
    const bf16* p = x + (((size_t)b * H + 2 * oy) * W + 2 * ox) * C + c;
    const size_t rs = (size_t)W * C;
    float m = fmaxf(fmaxf(to_f32(p[0]), to_f32(p[C])),
                    fmaxf(to_f32(p[rs]), to_f32(p[rs + C])));
    y[e] = to_bf16(m);
  }
}

// ---------------------------------------------------------------------------
// Windowed / global attention on the tensor cores, one block per
// (64-query tile, head, window); each of the 4 warps owns 16 queries.
//
// qkv [B, H, W, 3C] (q | k | v, head h at columns h*hd). A window is
// wsh x wsw tokens of the zero-padded grid (global attention: one window
// of H x W). Tokens outside H x W are the reference's pad tokens: their
// q/k/v are the bf16-rounded biases. With q_pool the queries are the 2x2
// max over each window's q (pooled window (wsh/2) x (wsw/2)); the output
// grid is (H/2, W/2) and pooled positions beyond it are cropped, as the
// reference's unpartition does.
//
// Exact softmax in two passes over 64-key chunks held in shared memory:
// pass 1 runs S = Q K^T (mma.sync m16n8k16, f32 accumulate) for the row
// max and sum; pass 2 recomputes S, forms p = exp(s - max) / sum in f32,
// rounds p to bf16 (the sdpa dtype walk: normalise, then cast) and feeds
// it from registers as the A operand of the P V product. No score matrix
// is stored, so any window size fits.
// ---------------------------------------------------------------------------

constexpr int ATT_Q = 64;        // queries per block (4 warps x 16)
constexpr int ATT_KC = 64;       // keys per shared-memory chunk
constexpr int ATT_THREADS = 128;
constexpr int ATT_MAX_HD = 128;
constexpr int ATT_PAD = 8;       // bf16 row padding: conflict-free fragments
constexpr float ATT_MASKED = -1e30f;

// 8 consecutive bf16 of one token's q, k or v row (16-byte load), or of
// the rounded bias for a pad token, or zeros for the head-dim padding.
__device__ __forceinline__ uint4 row8(const bf16* qkv, const bf16* bias_s,
                                      int b, int y, int x, int H, int W,
                                      int C3, int off, int d0, int hd) {
  if (d0 >= hd) return make_uint4(0, 0, 0, 0);
  if (y < H && x < W)
    return *reinterpret_cast<const uint4*>(
        qkv + (((size_t)b * H + y) * W + x) * C3 + off + d0);
  return *reinterpret_cast<const uint4*>(bias_s + d0);
}

// elementwise max of two bf16 pairs (exact: bf16 widens to f32 exactly)
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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

static size_t attention_smem_bytes(int hd) {
  const int hdp = (hd + 15) & ~15;
  return sizeof(bf16) * ((size_t)(ATT_Q + ATT_KC) * (hdp + ATT_PAD) +
                         (size_t)hdp * (ATT_KC + ATT_PAD) + 3 * (size_t)hdp);
}

__global__ void __launch_bounds__(ATT_THREADS)
window_attention_kernel(const bf16* __restrict__ qkv,
                        const float* __restrict__ bqkv, bf16* __restrict__ out,
                        int H, int W, int C, int hd, int wsh, int wsw,
                        int nWh, int nWw, int q_pool) {
  extern __shared__ __align__(16) unsigned char att_smem[];
  const int hdp = (hd + 15) & ~15;               // k-dim of Q K^T, padded
  const int LDQ = hdp + ATT_PAD, LDV = ATT_KC + ATT_PAD;
  bf16* Qs = reinterpret_cast<bf16*>(att_smem);  // [ATT_Q][LDQ]
  bf16* Ks = Qs + ATT_Q * LDQ;                   // [ATT_KC][LDQ]
  bf16* Vt = Ks + ATT_KC * LDQ;                  // [hdp][LDV], V transposed
  bf16* Bq = Vt + hdp * LDV;                     // [hdp] rounded biases
  bf16* Bk = Bq + hdp;                           //   (pad tokens)
  bf16* Bv = Bk + hdp;

  const int T = wsh * wsw;
  const int qh = q_pool ? wsh / 2 : wsh, qw = q_pool ? wsw / 2 : wsw;
  const int Tq = qh * qw;
  const int Ho = q_pool ? H / 2 : H, Wo = q_pool ? W / 2 : W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y;
  int win = blockIdx.z;
  const int wx = win % nWw;
  win /= nWw;
  const int wy = win % nWh;
  const int b = win / nWh;
  const int q0 = blockIdx.x * ATT_Q;
  const int C3 = 3 * C;
  const float scale = rsqrtf((float)hd);
  const int nks = hdp / 16, ndn = hd / 8;

  const int cpr = hdp / 8;                       // 16-byte chunks per row
  for (int d = tid; d < hdp; d += ATT_THREADS) {
    const bool in = d < hd;
    Bq[d] = to_bf16(in ? bqkv[h * hd + d] : 0.f);
    Bk[d] = to_bf16(in ? bqkv[C + h * hd + d] : 0.f);
    Bv[d] = to_bf16(in ? bqkv[2 * C + h * hd + d] : 0.f);
  }
  __syncthreads();

  // queries (2x2-pooled inside the window when q_pool), zero-padded; all
  // of a thread's loads are issued before its shared-memory stores
  constexpr int MAXIT = ATT_KC * ATT_MAX_HD / 8 / ATT_THREADS;
  static_assert(ATT_Q == ATT_KC, "one load schedule for q and k/v tiles");
  {
    uint4 qv[MAXIT];
#pragma unroll
    for (int it = 0; it < MAXIT; ++it) {
      const int e = tid + it * ATT_THREADS;
      const int r = e / cpr, d0 = (e % cpr) * 8, qi = q0 + r;
      qv[it] = make_uint4(0, 0, 0, 0);
      if (e < ATT_Q * cpr && qi < Tq) {
        const int qy = qi / qw, qx = qi % qw;
        if (q_pool) {
          const int y = wy * wsh + 2 * qy, x = wx * wsw + 2 * qx;
          qv[it] = bmax8(
              bmax8(row8(qkv, Bq, b, y, x, H, W, C3, h * hd, d0, hd),
                    row8(qkv, Bq, b, y, x + 1, H, W, C3, h * hd, d0, hd)),
              bmax8(row8(qkv, Bq, b, y + 1, x, H, W, C3, h * hd, d0, hd),
                    row8(qkv, Bq, b, y + 1, x + 1, H, W, C3, h * hd, d0, hd)));
        } else {
          qv[it] = row8(qkv, Bq, b, wy * wsh + qy, wx * wsw + qx, H, W, C3,
                        h * hd, d0, hd);
        }
      }
    }
#pragma unroll
    for (int it = 0; it < MAXIT; ++it) {
      const int e = tid + it * ATT_THREADS;
      if (e < ATT_Q * cpr)
        *reinterpret_cast<uint4*>(&Qs[(e / cpr) * LDQ + (e % cpr) * 8]) =
            qv[it];
    }
  }
  __syncthreads();

  const int r0 = warp * 16;
  const bool active = q0 + r0 < Tq;
  uint32_t qf[ATT_MAX_HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < ATT_MAX_HD / 16; ++ks) {
    if (ks < nks) {
      const int c = ks * 16 + 2 * t4;
      qf[ks][0] = *reinterpret_cast<const uint32_t*>(&Qs[(r0 + g) * LDQ + c]);
      qf[ks][1] = *reinterpret_cast<const uint32_t*>(&Qs[(r0 + g + 8) * LDQ + c]);
      qf[ks][2] = *reinterpret_cast<const uint32_t*>(&Qs[(r0 + g) * LDQ + c + 8]);
      qf[ks][3] = *reinterpret_cast<const uint32_t*>(&Qs[(r0 + g + 8) * LDQ + c + 8]);
    }
  }

  // S chunk for this warp's 16 rows x 64 keys: s[nt][0..1] row g, keys
  // k0 + nt*8 + 2*t4 + {0,1}; s[nt][2..3] row g + 8, same keys
  float s[ATT_KC / 8][4];
  auto scores = [&](int k0) {
#pragma unroll
    for (int nt = 0; nt < ATT_KC / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < ATT_MAX_HD / 16; ++ks) {
        if (ks < nks) {
          const bf16* kr = &Ks[(nt * 8 + g) * LDQ + ks * 16 + 2 * t4];
          const uint32_t bfr[2] = {*reinterpret_cast<const uint32_t*>(kr),
                                   *reinterpret_cast<const uint32_t*>(kr + 8)};
          mma_16816(s[nt], qf[ks], bfr);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + nt * 8 + 2 * t4 + (j & 1);
        s[nt][j] = key < T ? s[nt][j] * scale : ATT_MASKED;
      }
    }
  };

  unsigned short* Vt16 = reinterpret_cast<unsigned short*>(Vt);
  auto load_chunk = [&](int k0, bool with_v) {
    uint4 kv[MAXIT], vv[MAXIT];
#pragma unroll
    for (int it = 0; it < MAXIT; ++it) {
      const int e = tid + it * ATT_THREADS;
      const int kk = e / cpr, d0 = (e % cpr) * 8, ki = k0 + kk;
      kv[it] = vv[it] = make_uint4(0, 0, 0, 0);
      if (e < ATT_KC * cpr && ki < T) {
        const int y = wy * wsh + ki / wsw, x = wx * wsw + ki % wsw;
        kv[it] = row8(qkv, Bk, b, y, x, H, W, C3, C + h * hd, d0, hd);
        if (with_v)
          vv[it] = row8(qkv, Bv, b, y, x, H, W, C3, 2 * C + h * hd, d0, hd);
      }
    }
#pragma unroll
    for (int it = 0; it < MAXIT; ++it) {
      const int e = tid + it * ATT_THREADS;
      if (e >= ATT_KC * cpr) continue;
      const int kk = e / cpr, d0 = (e % cpr) * 8;
      *reinterpret_cast<uint4*>(&Ks[kk * LDQ + d0]) = kv[it];
      if (with_v) {
        const uint32_t w[4] = {vv[it].x, vv[it].y, vv[it].z, vv[it].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Vt16[(d0 + 2 * j) * LDV + kk] = (unsigned short)(w[j] & 0xffffu);
          Vt16[(d0 + 2 * j + 1) * LDV + kk] = (unsigned short)(w[j] >> 16);
        }
      }
    }
  };

  // pass 1: row max and sum (online rescaling of the running sum)
  float m[2] = {ATT_MASKED, ATT_MASKED}, l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < T; k0 += ATT_KC) {
    __syncthreads();
    load_chunk(k0, false);
    __syncthreads();
    if (!active) continue;
    scores(k0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float cm = ATT_MASKED;
#pragma unroll
      for (int nt = 0; nt < ATT_KC / 8; ++nt)
        cm = fmaxf(cm, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffff, cm, 1));
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffff, cm, 2));
      const float mn = fmaxf(m[r], cm);
      float acc = l[r] * expf(m[r] - mn);
#pragma unroll
      for (int nt = 0; nt < ATT_KC / 8; ++nt)
        acc += expf(s[nt][2 * r] - mn) + expf(s[nt][2 * r + 1] - mn);
      l[r] = acc;
      m[r] = mn;
    }
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float tot = l[r];
    tot += __shfl_xor_sync(0xffffffff, tot, 1);
    tot += __shfl_xor_sync(0xffffffff, tot, 2);
    inv[r] = 1.f / tot;
  }

  // pass 2: normalised probabilities (bf16) times V
  float o[ATT_MAX_HD / 8][4];
#pragma unroll
  for (int dn = 0; dn < ATT_MAX_HD / 8; ++dn)
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  for (int k0 = 0; k0 < T; k0 += ATT_KC) {
    __syncthreads();
    load_chunk(k0, true);
    __syncthreads();
    if (!active) continue;
    scores(k0);
#pragma unroll
    for (int kb = 0; kb < ATT_KC / 16; ++kb) {
      const float* s0 = s[2 * kb];
      const float* s1 = s[2 * kb + 1];
      const uint32_t pf[4] = {
          pack_bf16x2(expf(s0[0] - m[0]) * inv[0], expf(s0[1] - m[0]) * inv[0]),
          pack_bf16x2(expf(s0[2] - m[1]) * inv[1], expf(s0[3] - m[1]) * inv[1]),
          pack_bf16x2(expf(s1[0] - m[0]) * inv[0], expf(s1[1] - m[0]) * inv[0]),
          pack_bf16x2(expf(s1[2] - m[1]) * inv[1], expf(s1[3] - m[1]) * inv[1])};
#pragma unroll
      for (int dn = 0; dn < ATT_MAX_HD / 8; ++dn) {
        if (dn < ndn) {
          const bf16* vr = &Vt[(dn * 8 + g) * LDV + kb * 16 + 2 * t4];
          const uint32_t bfr[2] = {*reinterpret_cast<const uint32_t*>(vr),
                                   *reinterpret_cast<const uint32_t*>(vr + 8)};
          mma_16816(o[dn], pf, bfr);
        }
      }
    }
  }
  if (!active) return;

  // write the un-partitioned, cropped output
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + g + 8 * r;
    const int oy = wy * qh + qi / qw, ox = wx * qw + qi % qw;
    const bool kept = qi < Tq && oy < Ho && ox < Wo;
    const size_t tok = ((size_t)b * Ho + oy) * Wo + ox;
    if (!kept) continue;
    bf16* dst = out + tok * C + h * hd;
#pragma unroll
    for (int dn = 0; dn < ATT_MAX_HD / 8; ++dn)
      if (dn < ndn)
        *reinterpret_cast<__nv_bfloat162*>(dst + dn * 8 + 2 * t4) =
            __floats2bfloat162_rn(o[dn][2 * r], o[dn][2 * r + 1]);
  }
}

// launch window_attention_kernel for a block's geometry (shared memory
// above 48 KB is opted into once per size)
static void window_attention(const bf16* qkv, const float* bqkv, bf16* out,
                             int B, int H, int W, int C, int heads, int wsh,
                             int wsw, int q_pool, cudaStream_t stream) {
  const int hd = C / heads;
  const int nWh = (H + wsh - 1) / wsh, nWw = (W + wsw - 1) / wsw;
  const int Tq = q_pool ? (wsh / 2) * (wsw / 2) : wsh * wsw;
  const size_t smem = attention_smem_bytes(hd);
  static int smem_opt_in = 0;
  if (smem > 48 * 1024 && (size_t)smem_opt_in < smem) {
    cudaFuncSetAttribute(window_attention_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    smem_opt_in = (int)smem;
  }
  dim3 grid((Tq + ATT_Q - 1) / ATT_Q, heads, B * nWh * nWw);
  window_attention_kernel<<<grid, ATT_THREADS, smem, stream>>>(
      qkv, bqkv, out, H, W, C, hd, wsh, wsw, nWh, nWw, q_pool);
}


