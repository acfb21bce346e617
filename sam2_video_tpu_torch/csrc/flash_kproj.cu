// Memory cross-attention with the key projection and RoPE fused in, for
// Hopper (sm_90a), hand-written CUDA C++, forward and backward.
//
// Replaces the TPU kernel sam2_video_tpu/ops/flash_attention.py
// flash_attention_kproj (Pallas _fwd_kproj_kernel / _bwd_kproj_kernel):
//   k = RoPE(kin Wk^T + bk) per key tile, never stored: the leading
//   num_spatial keys rotate by the axial table of one HW-token slot, tiled
//   per slot; the trailing object-pointer keys are not rotated;
//   s = (q * scale) k^T + key bias; online softmax; o = p v against the raw
//   64-wide memory (the v-commute); lse kept for the backward.
// Like the TPU kernel it runs in f32 inside: kin, Wk, q and v are bf16
// inputs (their products are exact in f32), and the f32 values that feed a
// product (the rotated k, the probabilities, the score gradients) are
// split into a bf16 high part and a bf16 remainder, two mma.sync products
// each, so the tensor cores see them to ~16 bits instead of 8. The output
// is rounded once.
//
// What bounds it on an H100 (8 objects, 576 queries, up to 4068 keys, d =
// 256): ~11 GFLOP of attention products per call forward against ~5 MB of
// q, memory and output, so the tensor cores bound it; the hi/lo split
// doubles the products the card runs. One block owns 64 queries of one
// object and streams 64-key tiles: the tile's keys are projected and
// rotated into shared memory (bf16 hi/lo), so K never reaches device memory.
// Any Lk: the ragged last tile is masked.
//
// Backward: the TPU kernel merges dq, dkin, dv and dWk into one sweep
// because its grid runs in order and carries dq and dWk in VMEM across key
// blocks. Here blocks run in parallel, so the backward is two passes:
//   dq:   per (object, 64 queries, half of d), over all key tiles;
//   dkv:  per (object, 64 keys), over all query tiles: dv and dk (dk summed
//         in shared memory), then the RoPE adjoint, dkin = dpre Wk and this
//         tile's f32 partial of dWk, dbk;
// and a third pass adds the dWk / dbk partials in a fixed order (no float
// atomics, so the result is the same from run to run).

#include "common.cuh"

constexpr int KD = 256;              // q / k width
constexpr int KV = 64;               // kin / v width
constexpr int TQ = 64;               // queries per block (4 warps x 16)
constexpr int TK = 64;               // keys per tile
constexpr int LDK = KD + 8;          // bf16 row stride of 256-wide tiles
constexpr int LDW = KV + 8;          // bf16 row stride of 64-wide tiles
constexpr int LDD = KD + 4;          // f32 row stride of the dk tile
constexpr int KP_THREADS = 128;
constexpr int WK_PART = KD * KV + KD;   // one dWk / dbk partial

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) as bf16 pairs: hi = round(a, b), lo = round of the remainders
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// RoPE factors of key `key` at pair j: the axial table of the key's slot
// position for spatial keys, the identity for pointer (and pad) keys
__device__ __forceinline__ void rope_cs(const float* cosv, const float* sinv,
                                        int key, int j, int num_spatial,
                                        int HW, float& c, float& s) {
  if (key < num_spatial) {
    const int pos = key % HW;
    c = cosv[pos * (KD / 2) + j];
    s = sinv[pos * (KD / 2) + j];
  } else {
    c = 1.f;
    s = 0.f;
  }
}

// k = RoPE(Kin_s Wk_s^T + bk) for the tile's 64 keys (rows k0 ...) into
// Khi / Klo [64][LDK]; warp w projects keys 16w .. 16w + 15, each column
// pair (j, j + 128) of RoPE from one pair of 8-wide product tiles.
__device__ __forceinline__ void project_keys(
    const bf16* Kin_s, const bf16* Wk_s, const float* __restrict__ bk,
    const float* __restrict__ cosv, const float* __restrict__ sinv, int k0,
    int num_spatial, int HW, bf16* Khi, bf16* Klo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, r0 = warp * 16;
  uint32_t ka[KV / 16][4];
#pragma unroll
  for (int ks = 0; ks < KV / 16; ++ks) {
    const int c = ks * 16 + 2 * t4;
    ka[ks][0] = ld32(Kin_s + (r0 + g) * LDW + c);
    ka[ks][1] = ld32(Kin_s + (r0 + g + 8) * LDW + c);
    ka[ks][2] = ld32(Kin_s + (r0 + g) * LDW + c + 8);
    ka[ks][3] = ld32(Kin_s + (r0 + g + 8) * LDW + c + 8);
  }
#pragma unroll 1
  for (int j = 0; j < KD / 16; ++j) {
    float c1[4] = {0.f, 0.f, 0.f, 0.f}, c2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < KV / 16; ++ks) {
      const int kc = ks * 16 + 2 * t4;
      const bf16* w1 = Wk_s + (8 * j + g) * LDW + kc;
      const bf16* w2 = Wk_s + (KD / 2 + 8 * j + g) * LDW + kc;
      const uint32_t b1[2] = {ld32(w1), ld32(w1 + 8)};
      const uint32_t b2[2] = {ld32(w2), ld32(w2 + 8)};
      mma_16816(c1, ka[ks], b1);
      mma_16816(c2, ka[ks], b2);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + (e >> 1) * 8;
      const int d = 8 * j + 2 * t4 + (e & 1);
      float cs, sn;
      rope_cs(cosv, sinv, k0 + row, d, num_spatial, HW, cs, sn);
      const float k1 = c1[e] + bk[d], k2 = c2[e] + bk[d + KD / 2];
      const float r1 = k1 * cs - k2 * sn, r2 = k2 * cs + k1 * sn;
      const bf16 h1 = to_bf16(r1), h2 = to_bf16(r2);
      Khi[row * LDK + d] = h1;
      Klo[row * LDK + d] = to_bf16(r1 - to_f32(h1));
      Khi[row * LDK + d + KD / 2] = h2;
      Klo[row * LDK + d + KD / 2] = to_bf16(r2 - to_f32(h2));
    }
  }
}

// Wk [256, 64] into shared memory
__device__ __forceinline__ void stage_wk(const bf16* __restrict__ wk,
                                         bf16* Wk_s) {
  for (int e = threadIdx.x; e < KD * (KV / 8); e += KP_THREADS) {
    const int r = e >> 3, c8 = (e & 7) * 8;
    *reinterpret_cast<uint4*>(Wk_s + r * LDW + c8) =
        *reinterpret_cast<const uint4*>(wk + r * KV + c8);
  }
}

// the tile's kin rows, v rows (vt: transposed, dims x keys) and key bias
// (-inf beyond Lk)
__device__ __forceinline__ void stage_keys(
    const bf16* __restrict__ kin, const bf16* __restrict__ v,
    const float* __restrict__ bias, long bias_bz, int b, int k0, int Lk,
    bf16* Kin_s, bf16* V_s, bool vt, float* bias_s) {
  for (int e = threadIdx.x; e < TK * (KV / 8); e += KP_THREADS) {
    const int kk = e >> 3, c8 = (e & 7) * 8, key = k0 + kk;
    uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
    if (key < Lk) {
      const size_t off = ((size_t)b * Lk + key) * KV + c8;
      kv4 = *reinterpret_cast<const uint4*>(kin + off);
      vv4 = *reinterpret_cast<const uint4*>(v + off);
    }
    *reinterpret_cast<uint4*>(Kin_s + kk * LDW + c8) = kv4;
    if (vt) {
      const bf16* ve = reinterpret_cast<const bf16*>(&vv4);
#pragma unroll
      for (int j = 0; j < 8; ++j) V_s[(c8 + j) * LDW + kk] = ve[j];
    } else {
      *reinterpret_cast<uint4*>(V_s + kk * LDW + c8) = vv4;
    }
  }
  if (bias_s && threadIdx.x < TK) {
    const int key = k0 + threadIdx.x;
    bias_s[threadIdx.x] =
        key < Lk ? (bias ? bias[(size_t)b * bias_bz + key] : 0.f) : -INFINITY;
  }
}

// q fragments (A operand, 16 rows x 256) of rows qa = q0 + 16w + g, qa + 8
__device__ __forceinline__ void load_q_frags(const bf16* __restrict__ qb,
                                             int qa, int Lq,
                                             uint32_t (&qf)[KD / 16][4]) {
  const int t4 = (threadIdx.x & 31) & 3;
#pragma unroll
  for (int ks = 0; ks < KD / 16; ++ks) {
    const int c = ks * 16 + 2 * t4;
    qf[ks][0] = qa < Lq ? ld32(qb + (size_t)qa * KD + c) : 0u;
    qf[ks][1] = qa + 8 < Lq ? ld32(qb + (size_t)(qa + 8) * KD + c) : 0u;
    qf[ks][2] = qa < Lq ? ld32(qb + (size_t)qa * KD + c + 8) : 0u;
    qf[ks][3] = qa + 8 < Lq ? ld32(qb + (size_t)(qa + 8) * KD + c + 8) : 0u;
  }
}

// s[16 x 8] += q k^T for key tile rows nt*8 .. from hi and lo parts
__device__ __forceinline__ void qk_tile(const uint32_t (&qf)[KD / 16][4],
                                        const bf16* Khi, const bf16* Klo,
                                        int nt, float* s) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int ks = 0; ks < KD / 16; ++ks) {
    const int off = (nt * 8 + g) * LDK + ks * 16 + 2 * t4;
    const uint32_t bh[2] = {ld32(Khi + off), ld32(Khi + off + 8)};
    const uint32_t bl[2] = {ld32(Klo + off), ld32(Klo + off + 8)};
    mma_16816(s, qf[ks], bh);
    mma_16816(s, qf[ks], bl);
  }
}

static size_t fwd_smem_bytes() {
  return sizeof(bf16) * ((size_t)KD * LDW + 2 * (size_t)TK * LDW +
                         2 * (size_t)TK * LDK) +
         sizeof(float) * TK;
}

// ---------------------------------------------------------------------------
// Forward: grid (ceil(Lq / 64), BH)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(KP_THREADS)
kproj_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kin,
                 const bf16* __restrict__ v, const bf16* __restrict__ wk,
                 const float* __restrict__ bk, const float* __restrict__ bias,
                 long bias_bz, const float* __restrict__ cosv,
                 const float* __restrict__ sinv, bf16* __restrict__ out,
                 float* __restrict__ lse, int Lq, int Lk, int num_spatial,
                 int HW, float scale) {
  extern __shared__ __align__(16) unsigned char kp_smem[];
  bf16* Wk_s = reinterpret_cast<bf16*>(kp_smem);
  bf16* Kin_s = Wk_s + KD * LDW;
  bf16* Vt_s = Kin_s + TK * LDW;          // [64 dims][LDW]: keys along rows
  bf16* Khi = Vt_s + KV * LDW;
  bf16* Klo = Khi + TK * LDK;
  float* bias_s = reinterpret_cast<float*>(Klo + TK * LDK);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y, q0 = blockIdx.x * TQ, r0 = warp * 16;
  const int qa = q0 + r0 + g;

  stage_wk(wk, Wk_s);
  uint32_t qf[KD / 16][4];
  load_q_frags(q + (size_t)b * Lq * KD, qa, Lq, qf);

  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float o[KV / 8][4];
#pragma unroll
  for (int dn = 0; dn < KV / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += TK) {
    __syncthreads();
    stage_keys(kin, v, bias, bias_bz, b, k0, Lk, Kin_s, Vt_s, true, bias_s);
    __syncthreads();
    project_keys(Kin_s, Wk_s, bk, cosv, sinv, k0, num_spatial, HW, Khi, Klo);
    __syncthreads();

    float s[TK / 8][4];
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      qk_tile(qf, Khi, Klo, nt, s[nt]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = s[nt][e] * scale + bias_s[nt * 8 + 2 * t4 + (e & 1)];
    }
    // online softmax, rows g (r = 0) and g + 8 (r = 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float cm = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt)
        cm = fmaxf(cm, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffff, cm, 1));
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffff, cm, 2));
      const float mn = fmaxf(m[r], cm);
      const float alpha = expf(m[r] - mn);
      float ls = 0.f;
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[nt][2 * r + e] - mn);
          s[nt][2 * r + e] = p;
          ls += p;
        }
      l[r] = l[r] * alpha + ls;
      m[r] = mn;
#pragma unroll
      for (int dn = 0; dn < KV / 8; ++dn) {
        o[dn][2 * r] *= alpha;
        o[dn][2 * r + 1] *= alpha;
      }
    }
    // o += p v, p as hi + lo
#pragma unroll
    for (int kb = 0; kb < TK / 16; ++kb) {
      uint32_t ph[4], pl[4];
      split2(s[2 * kb][0], s[2 * kb][1], ph[0], pl[0]);
      split2(s[2 * kb][2], s[2 * kb][3], ph[1], pl[1]);
      split2(s[2 * kb + 1][0], s[2 * kb + 1][1], ph[2], pl[2]);
      split2(s[2 * kb + 1][2], s[2 * kb + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dn = 0; dn < KV / 8; ++dn) {
        const bf16* vr = Vt_s + (dn * 8 + g) * LDW + kb * 16 + 2 * t4;
        const uint32_t bv[2] = {ld32(vr), ld32(vr + 8)};
        mma_16816(o[dn], ph, bv);
        mma_16816(o[dn], pl, bv);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float tot = l[r];
    tot += __shfl_xor_sync(0xffffffff, tot, 1);
    tot += __shfl_xor_sync(0xffffffff, tot, 2);
    const int row = qa + 8 * r;
    if (row >= Lq) continue;
    const float inv = 1.f / tot;
    bf16* dst = out + ((size_t)b * Lq + row) * KV;
#pragma unroll
    for (int dn = 0; dn < KV / 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(dst + dn * 8 + 2 * t4) =
          __floats2bfloat162_rn(o[dn][2 * r] * inv, o[dn][2 * r + 1] * inv);
    if (t4 == 0) lse[(size_t)b * Lq + row] = m[r] + logf(tot);
  }
}

// delta[row] = sum_d dout[row][d] * out[row][d] in f32, a warp per row
__global__ void kproj_delta_kernel(const bf16* __restrict__ dout,
                                   const bf16* __restrict__ out,
                                   float* __restrict__ delta, int rows) {
  const size_t row = (size_t)blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (size_t)rows) return;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < KV / 32; ++i) {
    const int c = lane + 32 * i;
    s += to_f32(dout[row * KV + c]) * to_f32(out[row * KV + c]);
  }
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// ---------------------------------------------------------------------------
// Backward pass 1, dq: grid (ceil(Lq / 64), BH, 2 halves of d)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(KP_THREADS)
kproj_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kin,
                const bf16* __restrict__ v, const bf16* __restrict__ wk,
                const float* __restrict__ bk, const float* __restrict__ bias,
                long bias_bz, const float* __restrict__ cosv,
                const float* __restrict__ sinv, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq,
                int Lq, int Lk, int num_spatial, int HW, float scale) {
  extern __shared__ __align__(16) unsigned char kp_smem[];
  bf16* Wk_s = reinterpret_cast<bf16*>(kp_smem);
  bf16* Kin_s = Wk_s + KD * LDW;
  bf16* V_s = Kin_s + TK * LDW;           // [64 keys][LDW]
  bf16* Khi = V_s + TK * LDW;
  bf16* Klo = Khi + TK * LDK;
  float* bias_s = reinterpret_cast<float*>(Klo + TK * LDK);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y, q0 = blockIdx.x * TQ, r0 = warp * 16;
  const int half = blockIdx.z;
  const int qa = q0 + r0 + g;

  stage_wk(wk, Wk_s);
  uint32_t qf[KD / 16][4];
  load_q_frags(q + (size_t)b * Lq * KD, qa, Lq, qf);
  uint32_t dof[KV / 16][4];
  const bf16* dob = dout + (size_t)b * Lq * KV;
#pragma unroll
  for (int ks = 0; ks < KV / 16; ++ks) {
    const int c = ks * 16 + 2 * t4;
    dof[ks][0] = qa < Lq ? ld32(dob + (size_t)qa * KV + c) : 0u;
    dof[ks][1] = qa + 8 < Lq ? ld32(dob + (size_t)(qa + 8) * KV + c) : 0u;
    dof[ks][2] = qa < Lq ? ld32(dob + (size_t)qa * KV + c + 8) : 0u;
    dof[ks][3] = qa + 8 < Lq ? ld32(dob + (size_t)(qa + 8) * KV + c + 8) : 0u;
  }
  float lse_r[2], del_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qa + 8 * r;
    lse_r[r] = row < Lq ? lse[(size_t)b * Lq + row] : INFINITY;
    del_r[r] = row < Lq ? delta[(size_t)b * Lq + row] : 0.f;
  }
  float acc[KD / 2 / 8][4];
#pragma unroll
  for (int dn = 0; dn < KD / 2 / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += TK) {
    __syncthreads();
    stage_keys(kin, v, bias, bias_bz, b, k0, Lk, Kin_s, V_s, false, bias_s);
    __syncthreads();
    project_keys(Kin_s, Wk_s, bk, cosv, sinv, k0, num_spatial, HW, Khi, Klo);
    __syncthreads();

    float ds[TK / 8][4];
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt) {
      float s4[4] = {0.f, 0.f, 0.f, 0.f}, dp4[4] = {0.f, 0.f, 0.f, 0.f};
      qk_tile(qf, Khi, Klo, nt, s4);
#pragma unroll
      for (int ks = 0; ks < KV / 16; ++ks) {
        const bf16* vr = V_s + (nt * 8 + g) * LDW + ks * 16 + 2 * t4;
        const uint32_t bv[2] = {ld32(vr), ld32(vr + 8)};
        mma_16816(dp4, dof[ks], bv);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = expf(s4[e] * scale + bias_s[nt * 8 + 2 * t4 + (e & 1)]
                             - lse_r[r]);
        ds[nt][e] = p * (dp4[e] - del_r[r]);
      }
    }
    // dq[:, half] += ds k[:, half]; B(n = d, k = key) = k[key][d]
#pragma unroll
    for (int kb = 0; kb < TK / 16; ++kb) {
      uint32_t dh[4], dl[4];
      split2(ds[2 * kb][0], ds[2 * kb][1], dh[0], dl[0]);
      split2(ds[2 * kb][2], ds[2 * kb][3], dh[1], dl[1]);
      split2(ds[2 * kb + 1][0], ds[2 * kb + 1][1], dh[2], dl[2]);
      split2(ds[2 * kb + 1][2], ds[2 * kb + 1][3], dh[3], dl[3]);
      const int ka = kb * 16 + 2 * t4;
#pragma unroll
      for (int dn = 0; dn < KD / 2 / 8; ++dn) {
        const int d = half * (KD / 2) + dn * 8 + g;
        const uint32_t bh[2] = {
            pack2(Khi[ka * LDK + d], Khi[(ka + 1) * LDK + d]),
            pack2(Khi[(ka + 8) * LDK + d], Khi[(ka + 9) * LDK + d])};
        const uint32_t bl[2] = {
            pack2(Klo[ka * LDK + d], Klo[(ka + 1) * LDK + d]),
            pack2(Klo[(ka + 8) * LDK + d], Klo[(ka + 9) * LDK + d])};
        mma_16816(acc[dn], dh, bh);
        mma_16816(acc[dn], dh, bl);
        mma_16816(acc[dn], dl, bh);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qa + 8 * r;
    if (row >= Lq) continue;
    bf16* dst = dq + ((size_t)b * Lq + row) * KD + half * (KD / 2);
#pragma unroll
    for (int dn = 0; dn < KD / 2 / 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(dst + dn * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[dn][2 * r] * scale,
                                acc[dn][2 * r + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// Backward pass 2, dkin / dv / dWk partials: grid (ceil(Lk / 64), BH)
// ---------------------------------------------------------------------------

static size_t dkv_smem_bytes() {
  const size_t region = sizeof(bf16) * ((size_t)TQ * LDK + (size_t)TQ * LDW);
  const size_t wk = sizeof(bf16) * (size_t)KD * LDW;
  return sizeof(bf16) * (2 * (size_t)TK * LDW + 2 * (size_t)TK * LDK) +
         (region > wk ? region : wk) + sizeof(float) * 2 * TQ +
         sizeof(float) * (size_t)TK * LDD;
}

__global__ void __launch_bounds__(KP_THREADS)
kproj_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kin,
                 const bf16* __restrict__ v, const bf16* __restrict__ wk,
                 const float* __restrict__ bk, const float* __restrict__ bias,
                 long bias_bz, const float* __restrict__ cosv,
                 const float* __restrict__ sinv,
                 const bf16* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dkin,
                 bf16* __restrict__ dv, float* __restrict__ part, int Lq,
                 int Lk, int num_spatial, int HW, float scale) {
  extern __shared__ __align__(16) unsigned char kp_smem[];
  bf16* Kin_s = reinterpret_cast<bf16*>(kp_smem);
  bf16* V_s = Kin_s + TK * LDW;           // [64 keys][LDW]
  bf16* Khi = V_s + TK * LDW;
  bf16* Klo = Khi + TK * LDK;
  bf16* region = Klo + TK * LDK;          // Wk, or the q / dout tiles
  bf16* Wk_s = region;
  bf16* Qs = region;                      // [64 queries][LDK]
  bf16* dOs = Qs + TQ * LDK;              // [64 queries][LDW]
  const size_t region_bytes =
      sizeof(bf16) * ((size_t)TQ * LDK + (size_t)TQ * LDW) >
              sizeof(bf16) * (size_t)KD * LDW
          ? sizeof(bf16) * ((size_t)TQ * LDK + (size_t)TQ * LDW)
          : sizeof(bf16) * (size_t)KD * LDW;
  float* lse_s = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(region) + region_bytes);
  float* del_s = lse_s + TQ;
  float* dK_s = del_s + TQ;               // [64 keys][LDD] f32

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, r0 = warp * 16;
  const int b = blockIdx.y, k0 = blockIdx.x * TK;

  stage_wk(wk, Wk_s);
  stage_keys(kin, v, nullptr, 0, b, k0, Lk, Kin_s, V_s, false, nullptr);
  float bias_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + g + 8 * r;
    bias_r[r] = key < Lk ? (bias ? bias[(size_t)b * bias_bz + key] : 0.f)
                         : -INFINITY;
  }
  for (int e = tid; e < TK * LDD; e += KP_THREADS) dK_s[e] = 0.f;
  __syncthreads();
  project_keys(Kin_s, Wk_s, bk, cosv, sinv, k0, num_spatial, HW, Khi, Klo);
  uint32_t va[KV / 16][4];
#pragma unroll
  for (int ks = 0; ks < KV / 16; ++ks) {
    const int c = ks * 16 + 2 * t4;
    va[ks][0] = ld32(V_s + (r0 + g) * LDW + c);
    va[ks][1] = ld32(V_s + (r0 + g + 8) * LDW + c);
    va[ks][2] = ld32(V_s + (r0 + g) * LDW + c + 8);
    va[ks][3] = ld32(V_s + (r0 + g + 8) * LDW + c + 8);
  }
  float dva[KV / 8][4];
#pragma unroll
  for (int dn = 0; dn < KV / 8; ++dn)
    dva[dn][0] = dva[dn][1] = dva[dn][2] = dva[dn][3] = 0.f;

  const bf16* qb = q + (size_t)b * Lq * KD;
  const bf16* dob = dout + (size_t)b * Lq * KV;
  for (int q0 = 0; q0 < Lq; q0 += TQ) {
    __syncthreads();                      // Wk / previous tiles released
    for (int e = tid; e < TQ * (KD / 8); e += KP_THREADS) {
      const int qq = e >> 5, c8 = (e & 31) * 8;
      *reinterpret_cast<uint4*>(Qs + qq * LDK + c8) =
          q0 + qq < Lq ? *reinterpret_cast<const uint4*>(
                             qb + (size_t)(q0 + qq) * KD + c8)
                       : make_uint4(0, 0, 0, 0);
    }
    for (int e = tid; e < TQ * (KV / 8); e += KP_THREADS) {
      const int qq = e >> 3, c8 = (e & 7) * 8;
      *reinterpret_cast<uint4*>(dOs + qq * LDW + c8) =
          q0 + qq < Lq ? *reinterpret_cast<const uint4*>(
                             dob + (size_t)(q0 + qq) * KV + c8)
                       : make_uint4(0, 0, 0, 0);
    }
    if (tid < TQ) {
      const int row = q0 + tid;
      lse_s[tid] = row < Lq ? lse[(size_t)b * Lq + row] : INFINITY;
      del_s[tid] = row < Lq ? delta[(size_t)b * Lq + row] : 0.f;
    }
    __syncthreads();

    // s^T [16 keys x 64 queries] = k q^T (k as hi + lo)
    float st[TQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < TQ / 8; ++nt) st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
#pragma unroll 4
    for (int ks = 0; ks < KD / 16; ++ks) {
      const int c = ks * 16 + 2 * t4;
      const uint32_t kh[4] = {ld32(Khi + (r0 + g) * LDK + c),
                              ld32(Khi + (r0 + g + 8) * LDK + c),
                              ld32(Khi + (r0 + g) * LDK + c + 8),
                              ld32(Khi + (r0 + g + 8) * LDK + c + 8)};
      const uint32_t kl[4] = {ld32(Klo + (r0 + g) * LDK + c),
                              ld32(Klo + (r0 + g + 8) * LDK + c),
                              ld32(Klo + (r0 + g) * LDK + c + 8),
                              ld32(Klo + (r0 + g + 8) * LDK + c + 8)};
#pragma unroll
      for (int nt = 0; nt < TQ / 8; ++nt) {
        const bf16* qr = Qs + (nt * 8 + g) * LDK + c;
        const uint32_t bq[2] = {ld32(qr), ld32(qr + 8)};
        mma_16816(st[nt], kh, bq);
        mma_16816(st[nt], kl, bq);
      }
    }
    // p^T
#pragma unroll
    for (int nt = 0; nt < TQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qq = nt * 8 + 2 * t4 + (e & 1);
        st[nt][e] = expf(st[nt][e] * scale + bias_r[e >> 1] - lse_s[qq]);
      }
    // dv += p^T dout; B(n = dim, k = query) = dout[query][dim]
#pragma unroll
    for (int kb = 0; kb < TQ / 16; ++kb) {
      uint32_t ph[4], pl[4];
      split2(st[2 * kb][0], st[2 * kb][1], ph[0], pl[0]);
      split2(st[2 * kb][2], st[2 * kb][3], ph[1], pl[1]);
      split2(st[2 * kb + 1][0], st[2 * kb + 1][1], ph[2], pl[2]);
      split2(st[2 * kb + 1][2], st[2 * kb + 1][3], ph[3], pl[3]);
      const int qq = kb * 16 + 2 * t4;
#pragma unroll
      for (int dn = 0; dn < KV / 8; ++dn) {
        const int d = dn * 8 + g;
        const uint32_t bo[2] = {
            pack2(dOs[qq * LDW + d], dOs[(qq + 1) * LDW + d]),
            pack2(dOs[(qq + 8) * LDW + d], dOs[(qq + 9) * LDW + d])};
        mma_16816(dva[dn], ph, bo);
        mma_16816(dva[dn], pl, bo);
      }
    }
    // ds^T = p^T (dp^T - delta), dp^T = v dout^T
#pragma unroll
    for (int nt = 0; nt < TQ / 8; ++nt) {
      float dp4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < KV / 16; ++ks) {
        const bf16* dr = dOs + (nt * 8 + g) * LDW + ks * 16 + 2 * t4;
        const uint32_t bd[2] = {ld32(dr), ld32(dr + 8)};
        mma_16816(dp4, va[ks], bd);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[nt][e] *= dp4[e] - del_s[nt * 8 + 2 * t4 + (e & 1)];
    }
    // dk += ds^T q, summed in shared memory (each thread owns its cells)
    uint32_t dh[TQ / 16][4], dl[TQ / 16][4];
#pragma unroll
    for (int kb = 0; kb < TQ / 16; ++kb) {
      split2(st[2 * kb][0], st[2 * kb][1], dh[kb][0], dl[kb][0]);
      split2(st[2 * kb][2], st[2 * kb][3], dh[kb][1], dl[kb][1]);
      split2(st[2 * kb + 1][0], st[2 * kb + 1][1], dh[kb][2], dl[kb][2]);
      split2(st[2 * kb + 1][2], st[2 * kb + 1][3], dh[kb][3], dl[kb][3]);
    }
#pragma unroll 2
    for (int dn = 0; dn < KD / 8; ++dn) {
      const int d = dn * 8 + g;
      float c4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kb = 0; kb < TQ / 16; ++kb) {
        const int qq = kb * 16 + 2 * t4;
        const uint32_t bq[2] = {
            pack2(Qs[qq * LDK + d], Qs[(qq + 1) * LDK + d]),
            pack2(Qs[(qq + 8) * LDK + d], Qs[(qq + 9) * LDK + d])};
        mma_16816(c4, dh[kb], bq);
        mma_16816(c4, dl[kb], bq);
      }
      float* c0 = dK_s + (r0 + g) * LDD + dn * 8 + 2 * t4;
      c0[0] += c4[0];
      c0[1] += c4[1];
      c0[8 * LDD] += c4[2];
      c0[8 * LDD + 1] += c4[3];
    }
  }
  __syncthreads();

  // RoPE adjoint (and the scale of q) -> dpre; keys beyond Lk contribute 0
  stage_wk(wk, Wk_s);
  for (int e = tid; e < TK * (KD / 2); e += KP_THREADS) {
    const int row = e / (KD / 2), j = e % (KD / 2), key = k0 + row;
    float* dr = dK_s + row * LDD;
    const float g1 = dr[j] * scale, g2 = dr[j + KD / 2] * scale;
    float cs, sn;
    rope_cs(cosv, sinv, key, j, num_spatial, HW, cs, sn);
    const bool in = key < Lk;
    dr[j] = in ? g1 * cs + g2 * sn : 0.f;
    dr[j + KD / 2] = in ? g2 * cs - g1 * sn : 0.f;
  }
  __syncthreads();

  // dkin[key][i] = sum_o dpre[key][o] Wk[o][i] (f32)
  {
    const int i = tid & (KV - 1), kh = tid >> 6;
    float acc[TK / 2];
#pragma unroll
    for (int r = 0; r < TK / 2; ++r) acc[r] = 0.f;
    for (int o = 0; o < KD; ++o) {
      const float w = to_f32(Wk_s[o * LDW + i]);
#pragma unroll
      for (int r = 0; r < TK / 2; ++r) acc[r] += dK_s[(kh + 2 * r) * LDD + o] * w;
    }
#pragma unroll
    for (int r = 0; r < TK / 2; ++r) {
      const int key = k0 + kh + 2 * r;
      if (key < Lk) dkin[((size_t)b * Lk + key) * KV + i] = to_bf16(acc[r]);
    }
  }

  // this tile's partial of dWk[o][i] = sum_key dpre[key][o] kin[key][i] and
  // of dbk[o] = sum_key dpre[key][o]
  float* pp = part + ((size_t)b * gridDim.x + blockIdx.x) * WK_PART;
  for (int o = tid; o < KD; o += KP_THREADS) {
    float acc[KV];
#pragma unroll
    for (int i = 0; i < KV; ++i) acc[i] = 0.f;
    float sb = 0.f;
    for (int kk = 0; kk < TK; ++kk) {
      const float d = dK_s[kk * LDD + o];
      sb += d;
#pragma unroll
      for (int i = 0; i < KV; ++i) acc[i] += d * to_f32(Kin_s[kk * LDW + i]);
    }
#pragma unroll
    for (int i = 0; i < KV; ++i) pp[o * KV + i] = acc[i];
    pp[KD * KV + o] = sb;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + g + 8 * r;
    if (key >= Lk) continue;
    bf16* dst = dv + ((size_t)b * Lk + key) * KV;
#pragma unroll
    for (int dn = 0; dn < KV / 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(dst + dn * 8 + 2 * t4) =
          __floats2bfloat162_rn(dva[dn][2 * r], dva[dn][2 * r + 1]);
  }
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

extern "C" long kproj_bwd_workspace_bytes(int BH, int Lq, int Lk) {
  const size_t nkt = (Lk + TK - 1) / TK;
  const size_t delta = ((size_t)BH * Lq * sizeof(float) + 255) & ~(size_t)255;
  return (long)(delta + (size_t)BH * nkt * WK_PART * sizeof(float));
}

// q [BH, Lq, 256], kin / v [BH, Lk, 64], wk [256, 64] bf16; bk [256] f32;
// bias [BH or 1, Lk] f32 (batch stride bias_bz) or null; cos / sin [HW,
// 128] f32. out [BH, Lq, 64] bf16, lse [BH, Lq] f32.
extern "C" int kproj_fwd(const void* q, const void* kin, const void* v,
                         const void* wk, const void* bk, const void* bias,
                         long bias_bz, const void* cosv, const void* sinv,
                         void* out, void* lse, int BH, int Lq, int Lk,
                         int num_spatial, int HW, void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const size_t smem = fwd_smem_bytes();
  const int err = set_smem(kproj_fwd_kernel, smem);
  if (err) return err;
  dim3 grid((Lq + TQ - 1) / TQ, BH);
  kproj_fwd_kernel<<<grid, KP_THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kin),
      static_cast<const bf16*>(v), static_cast<const bf16*>(wk),
      static_cast<const float*>(bk), static_cast<const float*>(bias), bias_bz,
      static_cast<const float*>(cosv), static_cast<const float*>(sinv),
      static_cast<bf16*>(out), static_cast<float*>(lse), Lq, Lk, num_spatial,
      HW, 1.0f / sqrtf((float)KD));
  return (int)cudaGetLastError();
}

// gradients: dq [BH, Lq, 256], dkin / dv [BH, Lk, 64] bf16; dwk [256 * 64]
// then dbk [256] f32 (one buffer of WK_PART floats)
extern "C" int kproj_bwd(const void* q, const void* kin, const void* v,
                         const void* wk, const void* bk, const void* bias,
                         long bias_bz, const void* cosv, const void* sinv,
                         const void* out, const void* lse, const void* dout,
                         void* dq, void* dkin, void* dv, void* dwk, void* ws,
                         int BH, int Lq, int Lk, int num_spatial, int HW,
                         void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const float scale = 1.0f / sqrtf((float)KD);
  const int nkt = (Lk + TK - 1) / TK;
  float* delta = static_cast<float*>(ws);
  float* part = reinterpret_cast<float*>(
      static_cast<char*>(ws) +
      (((size_t)BH * Lq * sizeof(float) + 255) & ~(size_t)255));
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(kin);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* wb = static_cast<const bf16*>(wk);
  const float* bkf = static_cast<const float*>(bk);
  const float* bf = static_cast<const float*>(bias);
  const float* cs = static_cast<const float*>(cosv);
  const float* sn = static_cast<const float*>(sinv);
  const bf16* dob = static_cast<const bf16*>(dout);
  const float* lsef = static_cast<const float*>(lse);

  const int rows = BH * Lq;
  kproj_delta_kernel<<<(rows + 3) / 4, 128, 0, st>>>(
      dob, static_cast<const bf16*>(out), delta, rows);

  const size_t smem_dq = fwd_smem_bytes();
  int err = set_smem(kproj_dq_kernel, smem_dq);
  if (err) return err;
  dim3 gq((Lq + TQ - 1) / TQ, BH, 2);
  kproj_dq_kernel<<<gq, KP_THREADS, smem_dq, st>>>(
      qb, kb, vb, wb, bkf, bf, bias_bz, cs, sn, dob, lsef, delta,
      static_cast<bf16*>(dq), Lq, Lk, num_spatial, HW, scale);

  const size_t smem_kv = dkv_smem_bytes();
  err = set_smem(kproj_dkv_kernel, smem_kv);
  if (err) return err;
  dim3 gk(nkt, BH);
  kproj_dkv_kernel<<<gk, KP_THREADS, smem_kv, st>>>(
      qb, kb, vb, wb, bkf, bf, bias_bz, cs, sn, dob, lsef, delta,
      static_cast<bf16*>(dkin), static_cast<bf16*>(dv), part, Lq, Lk,
      num_spatial, HW, scale);

  kproj_reduce_kernel<<<(WK_PART + 255) / 256, 256, 0, st>>>(
      part, BH * nkt, WK_PART, static_cast<float*>(dwk));
  return (int)cudaGetLastError();
}
