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
// tiles are masked (no padding of the keys to 256 with a -1e9 bias, no
// padding of v to 128 lanes, as the TPU wrapper and its caller do).
// Like the TPU kernel it runs in f32 inside: q, k, v and dout are bf16 (their
// products are exact in f32), the statistics are f32 with an online softmax
// over key tiles, and the f32 values that feed a tensor-core product (the
// probabilities p and the score gradients ds) are split into a bf16 high
// part and a bf16 remainder (common.cuh split2), two mma.sync products each,
// so the tensor cores see them to ~16 bits. Outputs are rounded once.
//
// What bounds it on an H100 (8 objects x 2 heads, 576 queries, up to 4096
// keys, D = DV = 128): ~7 GFLOP of products per forward call (QK^T once, PV
// twice for hi and lo) against ~40 MB of q, k, v and output, so the tensor
// cores bound it. One block owns 64 queries of one (batch, head) and
// streams 64-key tiles of k and v through shared memory; s and p live in
// registers only, nothing of size Lq x Lk reaches device memory.
//
// Backward: the TPU kernel's single ordered sweep carries dq across key
// blocks in VMEM. Blocks run in parallel here, so it is two passes, like
// csrc/flash_kproj.cu's:
//   dq:  per (batch-head, 64 queries, 128 columns of dq), over all key
//        tiles: s, p from the saved lse, dp = dout v^T, ds = p (dp - delta),
//        dq += ds k;
//   dkv: per (batch-head, 64 keys), over all query tiles: p^T, dv += p^T
//        dout, dp^T, ds^T, dk += ds^T q (dk summed in shared memory by the
//        thread that owns each cell);
// with delta = rowsum(dout * out) from a first small kernel. No float
// atomics: two runs give the same bits. The key bias gets no gradient.

#include "common.cuh"

constexpr int FA_THREADS = 128;      // 4 warps, 16 rows each
constexpr int TQ = 64;               // queries per block / per tile
constexpr int TK = 64;               // keys per tile / per block
constexpr int PAD = 8;               // bf16 row padding: conflict-free loads
constexpr int DQ_COLS = 128;         // dq columns per block of the dq pass

// rows r0 .. r0 + 63 (zeros at and past n) of a row-major [n][W] bf16
// matrix into a [64][W + PAD] shared tile
template <int W>
__device__ __forceinline__ void stage_rows(const bf16* __restrict__ src,
                                           int r0, int n, bf16* dst) {
  constexpr int C8 = W / 8;
  for (int e = threadIdx.x; e < 64 * C8; e += FA_THREADS) {
    const int r = e / C8, c8 = (e % C8) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * W + c8);
    *reinterpret_cast<uint4*>(dst + r * (W + PAD) + c8) = val;
  }
}

// A fragment (16 rows from r, 16 columns from c) of a shared bf16 tile
__device__ __forceinline__ void a_frag(const bf16* s, int ld, int r, int c,
                                       uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const bf16* p = s + (r + g) * ld + c + 2 * t4;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// acc[16 x 64] = A[16 rows from r, W] B^T with B the shared tile's 64 rows
// (n = row, k = column): q k^T, dout v^T, k q^T, v dout^T
template <int W>
__device__ __forceinline__ void rows_x_rows(const bf16* As, int r,
                                            const bf16* Bs,
                                            float (&acc)[8][4]) {
  constexpr int LD = W + PAD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll 4
  for (int ks = 0; ks < W / 16; ++ks) {
    uint32_t a[4];
    a_frag(As, LD, r, ks * 16, a);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const bf16* br = Bs + (nt * 8 + g) * LD + ks * 16 + 2 * t4;
      const uint32_t b[2] = {ld32(br), ld32(br + 8)};
      mma_16816(acc[nt], a, b);
    }
  }
}

// acc[16 x NC] += X[16 x 64] M[64 rows, columns c0 .. c0 + NC) for f32 X
// held as the C fragments of rows_x_rows (split into bf16 hi + lo) and M a
// shared [64][LD] bf16 tile: p v, ds k, p^T dout, ds^T q
template <int NC>
__device__ __forceinline__ void frags_x_tile(const float (&x)[8][4],
                                             const bf16* Ms, int ld, int c0,
                                             float (&acc)[NC / 8][4]) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    uint32_t xh[4], xl[4];
    split2(x[2 * kb][0], x[2 * kb][1], xh[0], xl[0]);
    split2(x[2 * kb][2], x[2 * kb][3], xh[1], xl[1]);
    split2(x[2 * kb + 1][0], x[2 * kb + 1][1], xh[2], xl[2]);
    split2(x[2 * kb + 1][2], x[2 * kb + 1][3], xh[3], xl[3]);
#pragma unroll
    for (int dn = 0; dn < NC / 8; dn += 2) {
      uint32_t b0[2], b1[2];
      ldsm_b_kn(Ms, ld, kb * 16, c0 + dn * 8, b0, b1);
      mma_16816(acc[dn], xh, b0);
      mma_16816(acc[dn], xl, b0);
      mma_16816(acc[dn + 1], xh, b1);
      mma_16816(acc[dn + 1], xl, b1);
    }
  }
}

__device__ __forceinline__ float key_bias(const float* __restrict__ bias,
                                          long bias_bz, int b, int key,
                                          int Lk) {
  return key < Lk ? (bias ? bias[(size_t)b * bias_bz + key] : 0.f)
                  : -INFINITY;
}

// ---------------------------------------------------------------------------
// Forward: grid (ceil(Lq / 64), BH)
// ---------------------------------------------------------------------------

template <int D, int DV>
static size_t fwd_smem_bytes() {
  return sizeof(bf16) * (2 * (size_t)64 * (D + PAD) + 64 * (DV + PAD)) +
         sizeof(float) * TK;
}

template <int D, int DV>
__global__ void __launch_bounds__(FA_THREADS)
fa_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const float* __restrict__ bias,
              long bias_bz, bf16* __restrict__ out, float* __restrict__ lse,
              int Lq, int Lk, float scale) {
  constexpr int LDQ = D + PAD, LDV = DV + PAD;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(fa_smem);
  bf16* Ks = Qs + TQ * LDQ;
  bf16* Vs = Ks + TK * LDQ;
  float* bias_s = reinterpret_cast<float*>(Vs + TK * LDV);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, r0 = warp * 16;
  const int b = blockIdx.y, q0 = blockIdx.x * TQ;
  const bf16* kb = k + (size_t)b * Lk * D;
  const bf16* vb = v + (size_t)b * Lk * DV;

  stage_rows<D>(q + (size_t)b * Lq * D, q0, Lq, Qs);
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float o[DV / 8][4];
#pragma unroll
  for (int dn = 0; dn < DV / 8; ++dn)
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += TK) {
    __syncthreads();                      // the previous tile is consumed
    stage_rows<D>(kb, k0, Lk, Ks);
    stage_rows<DV>(vb, k0, Lk, Vs);
    if (threadIdx.x < TK)
      bias_s[threadIdx.x] = key_bias(bias, bias_bz, b, k0 + threadIdx.x, Lk);
    __syncthreads();

    float s[8][4];
    rows_x_rows<D>(Qs, r0, Ks, s);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = s[nt][e] * scale + bias_s[nt * 8 + 2 * t4 + (e & 1)];
    // online softmax, rows g (r = 0) and g + 8 (r = 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float cm = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        cm = fmaxf(cm, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffff, cm, 1));
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffff, cm, 2));
      const float mn = fmaxf(m[r], cm);
      const float alpha = expf(m[r] - mn);
      float ls = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[nt][2 * r + e] - mn);
          s[nt][2 * r + e] = p;
          ls += p;
        }
      l[r] = l[r] * alpha + ls;
      m[r] = mn;
#pragma unroll
      for (int dn = 0; dn < DV / 8; ++dn) {
        o[dn][2 * r] *= alpha;
        o[dn][2 * r + 1] *= alpha;
      }
    }
    frags_x_tile<DV>(s, Vs, LDV, 0, o);   // o += p v
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float tot = l[r];
    tot += __shfl_xor_sync(0xffffffff, tot, 1);
    tot += __shfl_xor_sync(0xffffffff, tot, 2);
    const int row = q0 + r0 + g + 8 * r;
    if (row >= Lq) continue;
    const float inv = 1.f / tot;
    bf16* dst = out + ((size_t)b * Lq + row) * DV;
#pragma unroll
    for (int dn = 0; dn < DV / 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(dst + dn * 8 + 2 * t4) =
          __floats2bfloat162_rn(o[dn][2 * r] * inv, o[dn][2 * r + 1] * inv);
    if (t4 == 0) lse[(size_t)b * Lq + row] = m[r] + logf(tot);
  }
}

// delta[row] = sum_d dout[row][d] * out[row][d] in f32, a warp per row
__global__ void fa_delta_kernel(const bf16* __restrict__ dout,
                                const bf16* __restrict__ out,
                                float* __restrict__ delta, int rows, int DV) {
  const size_t row = (size_t)blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (size_t)rows) return;
  float s = 0.f;
  for (int c = lane; c < DV; c += 32)
    s += to_f32(dout[row * DV + c]) * to_f32(out[row * DV + c]);
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// ---------------------------------------------------------------------------
// Backward pass 1, dq: grid (ceil(Lq / 64), BH, D / DH)
// ---------------------------------------------------------------------------

template <int D, int DV>
static size_t dq_smem_bytes() {
  return sizeof(bf16) * 2 * ((size_t)64 * (D + PAD) + 64 * (DV + PAD)) +
         sizeof(float) * TK;
}

template <int D, int DV, int DH>
__global__ void __launch_bounds__(FA_THREADS)
fa_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const float* __restrict__ bias,
             long bias_bz, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, int Lq, int Lk, float scale) {
  constexpr int LDQ = D + PAD, LDV = DV + PAD;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(fa_smem);
  bf16* dOs = Qs + TQ * LDQ;
  bf16* Ks = dOs + TQ * LDV;
  bf16* Vs = Ks + TK * LDQ;
  float* bias_s = reinterpret_cast<float*>(Vs + TK * LDV);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, r0 = warp * 16;
  const int b = blockIdx.y, q0 = blockIdx.x * TQ, c0 = blockIdx.z * DH;
  const bf16* kb = k + (size_t)b * Lk * D;
  const bf16* vb = v + (size_t)b * Lk * DV;

  stage_rows<D>(q + (size_t)b * Lq * D, q0, Lq, Qs);
  stage_rows<DV>(dout + (size_t)b * Lq * DV, q0, Lq, dOs);
  float lse_r[2], del_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    lse_r[r] = row < Lq ? lse[(size_t)b * Lq + row] : INFINITY;
    del_r[r] = row < Lq ? delta[(size_t)b * Lq + row] : 0.f;
  }
  float acc[DH / 8][4];
#pragma unroll
  for (int dn = 0; dn < DH / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += TK) {
    __syncthreads();
    stage_rows<D>(kb, k0, Lk, Ks);
    stage_rows<DV>(vb, k0, Lk, Vs);
    if (threadIdx.x < TK)
      bias_s[threadIdx.x] = key_bias(bias, bias_bz, b, k0 + threadIdx.x, Lk);
    __syncthreads();

    float s[8][4], dp[8][4];
    rows_x_rows<D>(Qs, r0, Ks, s);
    rows_x_rows<DV>(dOs, r0, Vs, dp);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = expf(s[nt][e] * scale +
                             bias_s[nt * 8 + 2 * t4 + (e & 1)] - lse_r[r]);
        s[nt][e] = p * (dp[nt][e] - del_r[r]);       // ds
      }
    frags_x_tile<DH>(s, Ks, LDQ, c0, acc);           // dq += ds k
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    if (row >= Lq) continue;
    bf16* dst = dq + ((size_t)b * Lq + row) * D + c0;
#pragma unroll
    for (int dn = 0; dn < DH / 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(dst + dn * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[dn][2 * r] * scale,
                                acc[dn][2 * r + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// Backward pass 2, dk / dv: grid (ceil(Lk / 64), BH)
// ---------------------------------------------------------------------------

template <int D, int DV>
static size_t dkv_smem_bytes() {
  return sizeof(bf16) * 2 * ((size_t)64 * (D + PAD) + 64 * (DV + PAD)) +
         sizeof(float) * ((size_t)TK * (D + 4) + 2 * TQ);
}

template <int D, int DV>
__global__ void __launch_bounds__(FA_THREADS)
fa_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const float* __restrict__ bias,
              long bias_bz, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int Lq, int Lk,
              float scale) {
  constexpr int LDQ = D + PAD, LDV = DV + PAD, LDD = D + 4;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(fa_smem);
  bf16* Vs = Ks + TK * LDQ;
  bf16* Qs = Vs + TK * LDV;
  bf16* dOs = Qs + TQ * LDQ;
  float* dK_s = reinterpret_cast<float*>(dOs + TQ * LDV);   // [64][LDD]
  float* lse_s = dK_s + TK * LDD;
  float* del_s = lse_s + TQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, r0 = warp * 16;
  const int b = blockIdx.y, k0 = blockIdx.x * TK;
  const bf16* qb = q + (size_t)b * Lq * D;
  const bf16* dob = dout + (size_t)b * Lq * DV;

  stage_rows<D>(k + (size_t)b * Lk * D, k0, Lk, Ks);
  stage_rows<DV>(v + (size_t)b * Lk * DV, k0, Lk, Vs);
  for (int e = tid; e < TK * LDD; e += FA_THREADS) dK_s[e] = 0.f;
  float bias_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    bias_r[r] = key_bias(bias, bias_bz, b, k0 + r0 + g + 8 * r, Lk);
  float dva[DV / 8][4];
#pragma unroll
  for (int dn = 0; dn < DV / 8; ++dn)
    dva[dn][0] = dva[dn][1] = dva[dn][2] = dva[dn][3] = 0.f;

  for (int q0 = 0; q0 < Lq; q0 += TQ) {
    __syncthreads();                      // the previous query tile is consumed
    stage_rows<D>(qb, q0, Lq, Qs);
    stage_rows<DV>(dob, q0, Lq, dOs);
    if (tid < TQ) {
      const int row = q0 + tid;
      lse_s[tid] = row < Lq ? lse[(size_t)b * Lq + row] : INFINITY;
      del_s[tid] = row < Lq ? delta[(size_t)b * Lq + row] : 0.f;
    }
    __syncthreads();

    // p^T [16 keys x 64 queries] from s^T = k q^T
    float st[8][4];
    rows_x_rows<D>(Ks, r0, Qs, st);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[nt][e] = expf(st[nt][e] * scale + bias_r[e >> 1] -
                         lse_s[nt * 8 + 2 * t4 + (e & 1)]);
    frags_x_tile<DV>(st, dOs, LDV, 0, dva);          // dv += p^T dout
    // ds^T = p^T (dp^T - delta), dp^T = v dout^T
    {
      float dpt[8][4];
      rows_x_rows<DV>(Vs, r0, dOs, dpt);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[nt][e] *= dpt[nt][e] - del_s[nt * 8 + 2 * t4 + (e & 1)];
    }
    // dk += ds^T q, 64 columns at a time, added into this thread's cells
#pragma unroll 1
    for (int c0 = 0; c0 < D; c0 += 64) {
      float c[8][4];
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) c[dn][0] = c[dn][1] = c[dn][2] = c[dn][3] = 0.f;
      frags_x_tile<64>(st, Qs, LDQ, c0, c);
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) {
        float* cell = dK_s + (r0 + g) * LDD + c0 + dn * 8 + 2 * t4;
        cell[0] += c[dn][0];
        cell[1] += c[dn][1];
        cell[8 * LDD] += c[dn][2];
        cell[8 * LDD + 1] += c[dn][3];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + g + 8 * r;
    if (key >= Lk) continue;
    bf16* dvr = dv + ((size_t)b * Lk + key) * DV;
#pragma unroll
    for (int dn = 0; dn < DV / 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(dvr + dn * 8 + 2 * t4) =
          __floats2bfloat162_rn(dva[dn][2 * r], dva[dn][2 * r + 1]);
    const float* cell = dK_s + (r0 + g + 8 * r) * LDD;
    bf16* dkr = dk + ((size_t)b * Lk + key) * D;
    for (int d = 2 * t4; d < D; d += 8)
      *reinterpret_cast<__nv_bfloat162*>(dkr + d) =
          __floats2bfloat162_rn(cell[d] * scale, cell[d + 1] * scale);
  }
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

template <int D, int DV>
static int fwd_launch(const bf16* q, const bf16* k, const bf16* v,
                      const float* bias, long bias_bz, bf16* out, float* lse,
                      int BH, int Lq, int Lk, cudaStream_t st) {
  const size_t smem = fwd_smem_bytes<D, DV>();
  const int err = set_smem(fa_fwd_kernel<D, DV>, smem);
  if (err) return err;
  dim3 grid((Lq + TQ - 1) / TQ, BH);
  fa_fwd_kernel<D, DV><<<grid, FA_THREADS, smem, st>>>(
      q, k, v, bias, bias_bz, out, lse, Lq, Lk, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D, int DV>
static int bwd_launch(const bf16* q, const bf16* k, const bf16* v,
                      const float* bias, long bias_bz, const bf16* out,
                      const float* lse, const bf16* dout, bf16* dq, bf16* dk,
                      bf16* dv, float* delta, int BH, int Lq, int Lk,
                      cudaStream_t st) {
  constexpr int DH = D < DQ_COLS ? D : DQ_COLS;
  const float scale = 1.0f / sqrtf((float)D);
  const int rows = BH * Lq;
  fa_delta_kernel<<<(rows + 3) / 4, 128, 0, st>>>(dout, out, delta, rows, DV);

  const size_t smem_dq = dq_smem_bytes<D, DV>();
  int err = set_smem(fa_dq_kernel<D, DV, DH>, smem_dq);
  if (err) return err;
  dim3 gq((Lq + TQ - 1) / TQ, BH, D / DH);
  fa_dq_kernel<D, DV, DH><<<gq, FA_THREADS, smem_dq, st>>>(
      q, k, v, bias, bias_bz, dout, lse, delta, dq, Lq, Lk, scale);

  const size_t smem_kv = dkv_smem_bytes<D, DV>();
  err = set_smem(fa_dkv_kernel<D, DV>, smem_kv);
  if (err) return err;
  dim3 gk((Lk + TK - 1) / TK, BH);
  fa_dkv_kernel<D, DV><<<gk, FA_THREADS, smem_kv, st>>>(
      q, k, v, bias, bias_bz, dout, lse, delta, dk, dv, Lq, Lk, scale);
  return (int)cudaGetLastError();
}

// q [BH, Lq, D], k [BH, Lk, D], v [BH, Lk, DV] bf16; bias [BH or 1, Lk] f32
// (batch stride bias_bz) or null. out [BH, Lq, DV] bf16, lse [BH, Lq] f32.
// Returns a CUDA error code; cudaErrorInvalidValue for other widths.
extern "C" int fa_fwd(const void* q, const void* k, const void* v,
                      const void* bias, long bias_bz, void* out, void* lse,
                      int BH, int Lq, int Lk, int D, int DV,
                      void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v);
  const float* bf = static_cast<const float*>(bias);
  switch (D * 1024 + DV) {
#define FA_CASE(D_, DV_)                                                    \
  case D_ * 1024 + DV_:                                                     \
    return fwd_launch<D_, DV_>(qb, kb, vb, bf, bias_bz, static_cast<bf16*>(out), \
                             static_cast<float*>(lse), BH, Lq, Lk, st);
    FA_WIDTHS(FA_CASE)
#undef FA_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// gradients dq [BH, Lq, D], dk [BH, Lk, D], dv [BH, Lk, DV] bf16; delta:
// the caller's [BH, Lq] f32 scratch for rowsum(dout * out)
extern "C" int fa_bwd(const void* q, const void* k, const void* v,
                      const void* bias, long bias_bz, const void* out,
                      const void* lse, const void* dout, void* dq, void* dk,
                      void* dv, void* delta, int BH, int Lq, int Lk, int D,
                      int DV, void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v);
  const float* bf = static_cast<const float*>(bias);
  switch (D * 1024 + DV) {
#define FA_CASE(D_, DV_)                                                     \
  case D_ * 1024 + DV_:                                                      \
    return bwd_launch<D_, DV_>(                                                \
        qb, kb, vb, bf, bias_bz, static_cast<const bf16*>(out),              \
        static_cast<const float*>(lse), static_cast<const bf16*>(dout),      \
        static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), \
        static_cast<float*>(delta), BH, Lq, Lk, st);
    FA_WIDTHS(FA_CASE)
#undef FA_CASE
  }
  return (int)cudaErrorInvalidValue;
}
