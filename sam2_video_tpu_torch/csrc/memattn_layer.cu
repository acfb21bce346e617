// Memory-attention layer blocks for Hopper (sm_90a), hand-written CUDA C++,
// forward and backward.
//
// Replaces the TPU kernels of sam2_video_tpu/ops/memattn_layer_kernel.py:
//   fused_self_block (Pallas _self_fwd_kernel / _self_bwd_kernel):
//     LN1 -> q, k, v -> RoPE(q, k) -> dense single-head L x L attention
//     (f32 softmax, p cast to bf16 before PV) -> out-proj -> +residual, and
//     the cross-attention query LN2 -> q-proj -> RoPE (q3);
//   fused_tail_block (Pallas _tail_fwd_kernel / _tail_bwd_kernel):
//     v-proj on the cross-attention output -> out-proj -> +residual -> LN3
//     -> linear1 -> ReLU -> linear2 -> +residual.
// Both backward passes recompute the forward from the block inputs, as the
// TPU kernels do.
//
// What bounds them on an H100 (N = 8 objects, L = 576 tokens, d = 256,
// hidden 2048; chip_smoke.py self_block_cost / tail_block_cost): the self
// block does 5.7 GFLOP of bf16 products forward and 16.6 backward, the
// tail 10.4 and 26.4, on a few MB of inputs, outputs and weights, so the
// tensor cores bound both (6-27 us at 989 TFLOP/s). In practice the
// limits are the rate at which one SM draws tiles from L2 into shared
// memory and the arithmetic between products, so the design keeps
// operands resident, streams each weight once per row block and fuses the
// epilogues. Every
// product is a wgmma on 128-byte-swizzled tiles staged by cp.async
// (sm90.cuh, sm90_gemm.cuh); a transposed operand is read by its
// descriptor:
//   - row chains (row_chain_kernel): a block of two warpgroups owns 64 rows
//     and all 256 output columns (warpgroup w columns 64 w.. and 128 +
//     64 w.., so RoPE pairs sit in one thread); the row tile stays in
//     shared memory and the weight streams in 64-column chunks through a
//     3-stage ring; each product's epilogue (bias, residual, RoPE in bf16
//     pairs, LayerNorm over the whole row) feeds the next product from
//     shared memory: LN1 -> q, k, v; o -> out-proj -> LN2 -> q-proj; a ->
//     v-proj -> out-proj -> LN3;
//   - the self-attention (L x L, one head, width 256) as flash kernels of
//     two warpgroups: the forward a two-pass exact softmax per 64 queries
//     (row max and sum, then p = exp(s - max) / sum rounded to bf16 and
//     o += p v), the warpgroups taking half of each key tile; the dq pass
//     per 64 queries (it also forms delta = rowsum(do * o)), halves of the
//     keys; the dk / dv pass per 64 keys, one warpgroup dk, the other dv.
//     The scores never reach device memory; RoPE's adjoint runs in the
//     epilogues;
//   - the MLP (mlp_fwd_kernel, mlp_bwd_kernel): per 128 rows and a third
//     of the hidden units, h (and the cotangent) stay in shared memory
//     while W1 / W2 chunks stream; r = ReLU(h W1^T + b1) lives in
//     registers as the A operand of the next product (forward: out +=
//     r W2^T; backward: dm1, then dh += dm1 W1), f32 partials added in
//     order;
//   - the remaining backward products and every weight gradient: the
//     grouped GEMM of sm90_gemm.cuh.
// The TPU grid runs in order, so its backward sums every weight gradient
// over the objects in VMEM. Here a weight gradient is one GEMM over the
// rows of all objects, cut into a fixed number of K chunks; bias gradients
// are column sums of the staged rows in the same GEMM, LayerNorm weight
// gradients per-block partials of the LayerNorm backward; one last kernel
// adds every partial in a fixed order. No float atomics: two runs give the
// same bits.
//
// Weights: the forward packs the leaves (f32 or bf16) into one buffer,
// bf16 matrices and f32 vectors, in one launch; the backward reads that
// buffer (the wrapper keeps it). Device operations per call: self
// forward 4, backward 11; tail forward 4, backward 7.
//
// Any token count L per object: tiles past an object's rows are
// zero-filled, and the self block masks the keys at and past Lv in its
// softmax (the wrapper pads L to a multiple of ROW_MULTIPLE with zero rows
// whose outputs it drops and whose cotangents are zero, so nothing of the
// pad reaches an output or a gradient).
//
// The C entry points launch their kernels in order on the caller's stream,
// carve their scratch from one workspace the caller allocates (its size
// from *_workspace_bytes) and return the first CUDA error.

#include "common.cuh"
#include "sm90.cuh"
#include "sm90_gemm.cuh"

constexpr int D_MODEL = 256;
constexpr float LN_EPS = 1e-5f;
constexpr int QKV_LD = 3 * D_MODEL;
// the tail's MLP kernels: rows per block, hidden units per chunk, hidden
// splits (their f32 partials), threads; a W1 chunk [64, 256] or a W2
// chunk [256, 64] in bytes
constexpr int MF_ROWS = 128, MF_HC = 64, MF_SPLITS = 3, MF_THREADS = 256;
constexpr int MF_W = 64 * D_MODEL * 2;

__host__ __device__ inline int cdiv(long a, long b) {
  return (int)((a + b - 1) / b);
}

template <class Kernel>
static int set_smem(Kernel* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---------------------------------------------------------------------------
// Weight packing: leaves (f32 or bf16) -> bf16 matrices, f32 vectors
// ---------------------------------------------------------------------------

constexpr int MAX_SEGS = 14;

struct PackSeg {
  const void* src;
  long n;         // elements
  long dst;       // byte offset in the packed buffer
  int src_bf16, dst_bf16;
};

struct PackPlan {
  PackSeg seg[MAX_SEGS];
  int n;
  long total;
};

// four elements per item (every segment is a multiple of 4 long)
__global__ void pack_kernel(const __grid_constant__ PackPlan P,
                            unsigned char* __restrict__ dst) {
  for (long i = 4 * (blockIdx.x * (long)blockDim.x + threadIdx.x); i < P.total;
       i += 4 * (long)gridDim.x * blockDim.x) {
    int s = 0;
    long j = i;
    while (j >= P.seg[s].n) j -= P.seg[s++].n;
    const void* src = P.seg[s].src;
    const int sb = P.seg[s].src_bf16, db = P.seg[s].dst_bf16;
    unsigned char* d = dst + P.seg[s].dst;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = sb ? to_f32(static_cast<const bf16*>(src)[j + e])
                : static_cast<const float*>(src)[j + e];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (db)
        reinterpret_cast<bf16*>(d)[j + e] = to_bf16(v[e]);
      else
        reinterpret_cast<float*>(d)[j + e] = v[e];
    }
  }
}

// byte layout of a packed buffer: bf16 matrices first, then f32 vectors,
// each 256-byte aligned
struct PackLayout {
  long off[MAX_SEGS];
  long bytes;
};

static PackLayout pack_layout(const long* n, const int* is_matrix, int k) {
  PackLayout L{};
  long o = 0;
  for (int pass = 1; pass >= 0; --pass)
    for (int i = 0; i < k; ++i)
      if (is_matrix[i] == pass) {
        L.off[i] = o;
        o = (o + n[i] * (pass ? 2 : 4) + 255) & ~255L;
      }
  L.bytes = o;
  return L;
}

static int pack_launch(const void* const* leaves, int bf16_mask,
                       const long* n, const int* is_matrix, int k,
                       unsigned char* dst, cudaStream_t st) {
  const PackLayout L = pack_layout(n, is_matrix, k);
  PackPlan P{};
  P.n = k;
  for (int i = 0; i < k; ++i) {
    P.seg[i] = PackSeg{leaves[i], n[i], L.off[i], (bf16_mask >> i) & 1,
                       is_matrix[i]};
    P.total += n[i];
  }
  const int blocks = cdiv(P.total, 1024) < 1024 ? cdiv(P.total, 1024) : 1024;
  pack_kernel<<<blocks, 256, 0, st>>>(P, dst);
  return 0;
}

// ---------------------------------------------------------------------------
// Row chains: a block (one warpgroup) owns 64 rows and all 256 columns
// ---------------------------------------------------------------------------

constexpr int RC_ROWS = 64;
constexpr int RC_THREADS = 256;                       // two warpgroups
constexpr int RC_MAX_STEPS = 3;
constexpr int RC_W_BYTES = D_MODEL * 64 * 2;          // a 64-column chunk of W
constexpr int RC_ROPE_LD = 136;                       // bf16, 128 + 8 pad
// shared memory: the row tile, the W ring, the residual tile (staged per
// step), the block's RoPE factors (bf16 cos then sin, [64][136] each), the
// step's f32 vectors (bias, LN weight, LN bias) and the two warpgroups'
// LayerNorm row sums
constexpr int RC_IN = 0;
constexpr int RC_W = RC_IN + RC_ROWS * D_MODEL * 2;
constexpr int RC_STAGES = 3;                          // depth of the W ring
constexpr int RC_RES = RC_W + RC_STAGES * RC_W_BYTES;
constexpr int RC_ROPE = RC_RES + RC_ROWS * D_MODEL * 2;
constexpr int RC_VEC = RC_ROPE + 2 * RC_ROWS * RC_ROPE_LD * 2;
constexpr int RC_RED = RC_VEC + 3 * D_MODEL * 4;
constexpr int RC_SMEM = RC_RED + 2 * 2 * RC_ROWS * 4 + 1024;

enum { FEED_KEEP = 0, FEED_OUT = 1, FEED_LN = 2 };

// one product of a chain: r = in[64 x k] W[256 x k]^T with the bf16 walk
// round(acc) + round(bias), round; + residual, round; RoPE (rope_half's
// walk); stored to out (row stride ld_out) when given; the next product's
// input is the current one (FEED_KEEP), r (FEED_OUT) or LN(r) (FEED_LN,
// also stored to ln_out when given)
struct RowStep {
  const bf16* w;
  int k;
  const float* bias;
  const bf16* res;
  int rope;
  bf16* out;
  long ld_out;
  int feed;
  const float* lnw;
  const float* lnb;
  bf16* ln_out;
};

// in [M, kin] (kin % 64 == 0, <= 256), LayerNorm'd first when lnw is given
// (kin 256; stored to ln_out when given); the RoPE tables [L, 256] f32 by
// row % L; aux: the RoPE adjoint of aux_src [M, 256] rows into aux_dst
struct RowChain {
  const bf16* in;
  int kin;
  const float* lnw;
  const float* lnb;
  bf16* ln_out;
  RowStep step[RC_MAX_STEPS];
  int nsteps;
  const float* cosv;
  const float* sinv;
  int L, M;
  const bf16* aux_src;
  bf16* aux_dst;
};

__device__ __forceinline__ uint4 pack8(const float (&y)[8]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  return u;
}

__device__ __forceinline__ void unpack8(uint4 u, float (&y)[8]) {
  const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) y[i] = to_f32(h[i]);
}

// rows r0 .. r0 + 63 (below M) of a 64 x 256 tile in shared memory (the
// 128-byte-swizzled layout of stage_block) to dst (row stride ld), 16
// bytes a thread, whole rows per warp
__device__ __forceinline__ void copy_rows_out(const unsigned char* tile,
                                              bf16* dst, long ld, int r0,
                                              int M) {
#pragma unroll
  for (int i = 0; i < RC_ROWS * 32 / RC_THREADS; ++i) {
    const int e = threadIdx.x + RC_THREADS * i, rl = e >> 5, j = e & 31;
    const uint4 v = *reinterpret_cast<const uint4*>(tile + sw128_off(rl, 8 * j));
    if (r0 + rl < M)
      *reinterpret_cast<uint4*>(dst + (size_t)(r0 + rl) * ld + 8 * j) = v;
  }
}

// a block of two warpgroups owns 64 rows; warpgroup w the output columns
// 64 w .. 64 w + 63 and 128 + 64 w .. (acc[0] and acc[1]: RoPE pairs in
// one thread), so the accumulators stay in registers
__global__ void __launch_bounds__(RC_THREADS, 1)
row_chain_kernel(const __grid_constant__ RowChain c) {
  extern __shared__ unsigned char rc_smem[];
  unsigned char* gen;
  const uint32_t sm = aligned_smem(rc_smem, &gen);
  const uint32_t In = sm + RC_IN, Wr = sm + RC_W;
  const bf16* res_s = reinterpret_cast<const bf16*>(gen + RC_RES);
  bf16* rope_c = reinterpret_cast<bf16*>(gen + RC_ROPE);
  bf16* rope_s = rope_c + RC_ROWS * RC_ROPE_LD;
  const float* vec = reinterpret_cast<const float*>(gen + RC_VEC);
  float* red = reinterpret_cast<float*>(gen + RC_RED);   // [2][2][64]
  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5;
  const int wi = warp & 3, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int r0 = blockIdx.x * RC_ROWS, c0 = 64 * wg;
  // the parameters this thread reads more than once, in registers (a read
  // through a reference into the parameter space is a generic load,
  // repeated after every store)
  const int M = c.M, L = c.L, nsteps = c.nsteps;
  const bf16* wk[RC_MAX_STEPS];
  int kc_n[RC_MAX_STEPS];
  int total = 0;
  bool any_rope = c.aux_src != nullptr;
#pragma unroll
  for (int s = 0; s < RC_MAX_STEPS; ++s) {
    wk[s] = c.step[s].w;
    kc_n[s] = s < nsteps ? c.step[s].k / 64 : 0;
    total += kc_n[s];
    any_rope = any_rope || (s < nsteps && c.step[s].rope);
  }
  auto load_w = [&](int u) {
    int s = 0, kc = u;
    while (kc >= kc_n[s]) kc -= kc_n[s++];
    stage_block<D_MODEL, 64, RC_THREADS>(Wr + (u % RC_STAGES) * RC_W_BYTES, wk[s],
                                         kc_n[s] * 64, 0, D_MODEL, kc * 64,
                                         kc_n[s] * 64);
  };
  load_w(0);
  if (!c.lnw)
    stage_block<RC_ROWS, D_MODEL, RC_THREADS>(In, c.in, c.kin, r0, M, 0,
                                              c.kin);
  cp_async_commit();
  if (total > 1) load_w(1);
  cp_async_commit();

  if (any_rope) {                      // RoPE factors of the block's rows
    const float* cosv = c.cosv;
    const float* sinv = c.sinv;
    constexpr int IT = RC_ROWS * 32 / RC_THREADS;
    float4 cv[IT], sv[IT];             // every load in flight at once
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      const int e = tid + RC_THREADS * i, rl = e >> 5, j = (e & 31) * 4;
      const size_t at = (size_t)((r0 + rl) % L) * D_MODEL + j;
      cv[i] = __ldg(reinterpret_cast<const float4*>(cosv + at));
      sv[i] = __ldg(reinterpret_cast<const float4*>(sinv + at));
    }
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      const int e = tid + RC_THREADS * i, rl = e >> 5, j = (e & 31) * 4;
      __nv_bfloat162* dc =
          reinterpret_cast<__nv_bfloat162*>(rope_c + rl * RC_ROPE_LD + j);
      __nv_bfloat162* ds =
          reinterpret_cast<__nv_bfloat162*>(rope_s + rl * RC_ROPE_LD + j);
      dc[0] = __floats2bfloat162_rn(cv[i].x, cv[i].y);
      dc[1] = __floats2bfloat162_rn(cv[i].z, cv[i].w);
      ds[0] = __floats2bfloat162_rn(sv[i].x, sv[i].y);
      ds[1] = __floats2bfloat162_rn(sv[i].z, sv[i].w);
    }
  }
  if (c.lnw) {                         // LN of the input rows, a warp per row
    const bf16* in = c.in;
    const float* lnw = c.lnw;
    const float* lnb = c.lnb;
    bf16* ln_out = c.ln_out;
    uint4 raw[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {      // every load in flight at once
      const int row = min(r0 + warp * 8 + i, M - 1);
      raw[i] = __ldg(reinterpret_cast<const uint4*>(
          in + (size_t)row * D_MODEL + 8 * lane));
    }
    float w8[8], b8[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      w8[e] = __ldg(lnw + 8 * lane + e);
      b8[e] = __ldg(lnb + 8 * lane + e);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int rl = warp * 8 + i, row = r0 + rl;
      float v[8];
      unpack8(raw[i], v);
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) s += v[e];
      const float mu = warp_sum(s) / D_MODEL;
      float qv = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) qv += (v[e] - mu) * (v[e] - mu);
      const float rinv = rsqrtf(warp_sum(qv) / D_MODEL + LN_EPS);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = (v[e] - mu) * rinv * w8[e] + b8[e];
      const uint4 u = pack8(v);
      *reinterpret_cast<uint4*>(gen + RC_IN + sw128_off(rl, 8 * lane)) = u;
      if (ln_out && row < M)
        *reinterpret_cast<uint4*>(ln_out + (size_t)row * D_MODEL + 8 * lane) =
            u;
    }
  }
  if (c.aux_src) {                     // RoPE adjoint, 8 pairs per item
    __syncthreads();                   // the RoPE factors are in place
    const bf16* src = c.aux_src;
    bf16* dst = c.aux_dst;
    uint4 x1r[4], x2r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + RC_THREADS * i;
      const int row = min(r0 + (e >> 4), M - 1), j0 = (e & 15) * 8;
      const size_t b = (size_t)row * D_MODEL + j0;
      x1r[i] = __ldg(reinterpret_cast<const uint4*>(src + b));
      x2r[i] = __ldg(reinterpret_cast<const uint4*>(src + b + 128));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + RC_THREADS * i, rl = e >> 4, row = r0 + rl;
      const int j0 = (e & 15) * 8;
      float x1[8], x2[8], y1[8], y2[8];
      unpack8(x1r[i], x1);
      unpack8(x2r[i], x2);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float c1 = to_f32(rope_c[rl * RC_ROPE_LD + j0 + k]);
        const float s1 = to_f32(rope_s[rl * RC_ROPE_LD + j0 + k]);
        y1[k] = rb(x1[k] * c1) + rb(x2[k] * s1);
        y2[k] = rb(x2[k] * c1) - rb(x1[k] * s1);
      }
      if (row < M) {
        const size_t b = (size_t)row * D_MODEL + j0;
        *reinterpret_cast<uint4*>(dst + b) = pack8(y1);
        *reinterpret_cast<uint4*>(dst + b + 128) = pack8(y2);
      }
    }
  }

  int u = 0;
  for (int s = 0; s < nsteps; ++s) {
    const RowStep st = c.step[s];
    __syncthreads();                   // the last step is done with RES, VEC
    // the step's vectors and residual tile, in the next chunk's wait
    if (tid < 3 * 64) {
      const float* v = tid < 64 ? st.bias : tid < 128 ? st.lnw : st.lnb;
      if (v) cp_async16(sm + RC_VEC + 16 * tid, v + 4 * (tid & 63), true);
    }
    if (st.res)
      stage_block<RC_ROWS, D_MODEL, RC_THREADS>(sm + RC_RES, st.res, D_MODEL,
                                                r0, M, 0, D_MODEL);
    cp_async_commit();
    float acc[2][32];
    zero(acc[0]);
    zero(acc[1]);
    for (int kc = 0; kc < kc_n[s]; ++kc, ++u) {
      if (kc == 0)                     // the step's operands too
        cp_async_wait<0>();
      else
        cp_async_wait<RC_STAGES - 2>();
      fence_proxy_async();
      __syncthreads();                 // chunk u landed, u - 1 consumed
      if (u + RC_STAGES - 1 < total) load_w(u + RC_STAGES - 1);
      cp_async_commit();
      const uint32_t Wt = Wr + (u % RC_STAGES) * RC_W_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = desc_k(In, kc * 64 + kk * 16);
        wgmma_ss_n64(acc[0], da, desc_k(Wt + c0 * 128, kk * 16), 1);
        wgmma_ss_n64(acc[1], da, desc_k(Wt + (128 + c0) * 128, kk * 16), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
    }

    // epilogue: thread rows 16 wi + g (+ 8), columns 128 h2 + c0 + 8 n +
    // 2 q (+ 1) in acc[h2][4 n + 2 h (+ 1)]; operands from shared memory.
    // The walk in bf16 pairs: a bf16 add or product rounds the exact
    // result once, as rounding its f32 result does (for bf16 operands)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wi * 16 + g + 8 * h;
      __nv_bfloat162 vb[2][8];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int col = 128 * h2 + c0 + 8 * n + 2 * q;
          __nv_bfloat162 v = __hadd2(
              __floats2bfloat162_rn(acc[h2][4 * n + 2 * h],
                                    acc[h2][4 * n + 2 * h + 1]),
              __floats2bfloat162_rn(vec[col], vec[col + 1]));
          if (st.res)
            v = __hadd2(v, *reinterpret_cast<const __nv_bfloat162*>(
                               res_s + sw128_off(rl, col) / 2));
          vb[h2][n] = v;
        }
      if (st.rope)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int j = c0 + 8 * n + 2 * q;
          const __nv_bfloat162 cs =
              *reinterpret_cast<const __nv_bfloat162*>(rope_c + rl * RC_ROPE_LD + j);
          const __nv_bfloat162 sn =
              *reinterpret_cast<const __nv_bfloat162*>(rope_s + rl * RC_ROPE_LD + j);
          const __nv_bfloat162 x1 = vb[0][n], x2 = vb[1][n];
          vb[0][n] = __hsub2(__hmul2(x1, cs), __hmul2(x2, sn));
          vb[1][n] = __hadd2(__hmul2(x2, cs), __hmul2(x1, sn));
        }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          // staged where this thread read its residual (RES is free after)
          if (st.out)
            *reinterpret_cast<__nv_bfloat162*>(
                gen + RC_RES + sw128_off(rl, 128 * h2 + c0 + 8 * n + 2 * q)) =
                vb[h2][n];
          const float2 f = __bfloat1622float2(vb[h2][n]);
          acc[h2][4 * n + 2 * h] = f.x;
          acc[h2][4 * n + 2 * h + 1] = f.y;
        }
    }
    if (st.out) {
      __syncthreads();
      copy_rows_out(gen + RC_RES, st.out, st.ld_out, r0, M);
    }
    if (st.feed == FEED_KEEP) continue;
    float mu[2] = {0.f, 0.f}, rinv[2] = {1.f, 1.f};
    if (st.feed == FEED_LN) {          // row statistics over both halves
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float t = 0.f;
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
            for (int i = 0; i < 16; ++i) {
              const float v = acc[h2][(i >> 1) * 4 + 2 * h + (i & 1)];
              t += pass ? (v - mu[h]) * (v - mu[h]) : v;
            }
          t = quad_sum(t);
          if (q == 0) red[(pass * 2 + wg) * RC_ROWS + wi * 16 + g + 8 * h] = t;
        }
        __syncthreads();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rl = wi * 16 + g + 8 * h;
          const float t = red[(pass * 2) * RC_ROWS + rl] +
                          red[(pass * 2 + 1) * RC_ROWS + rl];
          if (pass)
            rinv[h] = rsqrtf(t / D_MODEL + LN_EPS);
          else
            mu[h] = t / D_MODEL;
        }
      }
    } else {
      __syncthreads();                 // every warp is done reading the tile
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wi * 16 + g + 8 * h;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int col = 128 * h2 + c0 + 8 * n + 2 * q;
          float y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            y[e] = acc[h2][4 * n + 2 * h + e];
            if (st.feed == FEED_LN)
              y[e] = (y[e] - mu[h]) * rinv[h] * vec[D_MODEL + col + e] +
                     vec[2 * D_MODEL + col + e];
          }
          *reinterpret_cast<__nv_bfloat162*>(gen + RC_IN +
                                             sw128_off(rl, col)) =
              __floats2bfloat162_rn(y[0], y[1]);
        }
    }
    if (st.feed == FEED_LN && st.ln_out) {
      __syncthreads();
      copy_rows_out(gen + RC_IN, st.ln_out, D_MODEL, r0, M);
    }
  }
}

static int row_chain(const RowChain& c, cudaStream_t st) {
  for (int s = 0; s < c.nsteps; ++s)
    if (c.step[s].k % 64 || c.step[s].k > D_MODEL)
      return (int)cudaErrorInvalidValue;
  if (c.kin % 64 || c.kin > D_MODEL || (c.lnw && c.kin != D_MODEL))
    return (int)cudaErrorInvalidValue;
  const int err = set_smem(row_chain_kernel, RC_SMEM);
  if (err) return err;
  row_chain_kernel<<<cdiv(c.M, RC_ROWS), RC_THREADS, RC_SMEM, st>>>(c);
  return 0;
}

// ---------------------------------------------------------------------------
// Self-attention (one head, width 256) over the q | k | v columns of
// qkv [N * L, 768]: grid (ceil(L / 64), N); keys at and past Lv masked
// ---------------------------------------------------------------------------

constexpr int SA_TILE = 64 * D_MODEL * 2;   // a 64-row tile 256 wide (32 KB)
constexpr int SA_THREADS = 256;             // two warpgroups

// the A operands (bf16 pairs, rounded) of the 16-wide k slices of a 64 x N
// f32 accumulator (its columns become the product's K)
template <int N>
__device__ __forceinline__ void pack_a(const float (&x)[N / 2],
                                       uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h = __floats2bfloat162_rn(x[8 * kk + 2 * i],
                                               x[8 * kk + 2 * i + 1]);
      a[kk][i] = *reinterpret_cast<uint32_t*>(&h);
    }
}

// Every attention block holds two warpgroups that split the inner tile:
// warpgroup w takes keys (or, in the dk / dv pass, queries) 32 w .. 32 w +
// 31 of each 64-row tile with m64n32 score products, and the two partial
// accumulators are added at the end through shared memory, warpgroup 0's
// first (a fixed order). The second warpgroup's arithmetic overlaps the
// first's products and loads, which one warpgroup per SM leaves idle.

// warpgroup 1's accumulators (n floats per thread) into shared memory,
// added to warpgroup 0's; true in warpgroup 0, which then holds the sums
template <int N>
__device__ __forceinline__ bool sum_warpgroups(float (&x)[N], float* xch) {
  const int wg = threadIdx.x >> 7, wt = threadIdx.x & 127;
  __syncthreads();                     // every product read its tiles
  if (wg == 1)
#pragma unroll
    for (int i = 0; i < N; ++i) xch[i * 128 + wt] = x[i];
  __syncthreads();
  if (wg == 1) return false;
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] += xch[i * 128 + wt];
  return true;
}

constexpr int SA_FWD_STAGES = 3;    // the forward's K and V rings
struct SaFwdSmem {
  static constexpr int Q = 0;
  static constexpr int K = Q + SA_TILE;
  static constexpr int V = K + SA_FWD_STAGES * SA_TILE;
  static constexpr int ML = V + SA_FWD_STAGES * SA_TILE;   // [2][64] (m, l)
  static constexpr int BYTES = ML + 2 * 64 * 8 + 1024;
};

// o [N * L, 256] bf16 and lse [N * L] f32: pass 1 over the key tiles forms
// each row's max and sum (the two warpgroups' halves merged once), pass 2
// p = exp(s - max) (1 / sum) (f32), rounded to bf16, o += p v
__global__ void __launch_bounds__(SA_THREADS, 1)
sa_fwd_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ o,
              float* __restrict__ lse, int L, int Lv, float scale) {
  using SM = SaFwdSmem;
  extern __shared__ unsigned char sa_smem[];
  unsigned char* gen;
  const uint32_t sm = aligned_smem(sa_smem, &gen);
  float2* ml = reinterpret_cast<float2*>(gen + SM::ML);
  const int tid = threadIdx.x, wg = tid >> 7, wi = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2;
  const int b = blockIdx.y, q0 = blockIdx.x * 64;
  const bf16* base = qkv + (size_t)b * L * QKV_LD;
  const int nt = cdiv(Lv, 64), total = 2 * nt;

  // the tiles of both passes (pass 2 with V) through 3-stage rings
  auto load = [&](int u) {
    const int t = u % nt, slot = u % SA_FWD_STAGES;
    stage_block<64, D_MODEL, SA_THREADS>(sm + SM::K + slot * SA_TILE,
                                         base + D_MODEL, QKV_LD, t * 64, Lv,
                                         0, D_MODEL);
    if (u >= nt)
      stage_block<64, D_MODEL, SA_THREADS>(sm + SM::V + slot * SA_TILE,
                                           base + 2 * D_MODEL, QKV_LD, t * 64,
                                           Lv, 0, D_MODEL);
  };
  stage_block<64, D_MODEL, SA_THREADS>(sm + SM::Q, base, QKV_LD, q0, L, 0,
                                       D_MODEL);
  load(0);
  cp_async_commit();
  if (total > 1) load(1);
  cp_async_commit();

  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f};
  float acc[2][64];
  zero(acc[0]);
  zero(acc[1]);
  for (int u = 0; u < total; ++u) {
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();                   // tile u landed, u - 1 consumed
    if (u + 2 < total) load(u + 2);
    cp_async_commit();
    const int t = u % nt, slot = u % SA_FWD_STAGES;
    const uint32_t Ks = sm + SM::K + slot * SA_TILE;
    float s[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D_MODEL / 16; ++kk)
      wgmma_ss_n32(s, desc_k(sm + SM::Q, kk * 16),
                   desc_k(Ks + wg * 32 * 128, kk * 16), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    const int kmax = Lv - t * 64 - 32 * wg;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      s[i] = acc_col(i) < kmax ? s[i] * scale : -INFINITY;
    if (u < nt) {                      // pass 1: row max and sum
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float cm = -INFINITY;
#pragma unroll
        for (int n = 0; n < 4; ++n)
          cm = fmaxf(cm, fmaxf(s[4 * n + 2 * h], s[4 * n + 2 * h + 1]));
        const float mn = fmaxf(m[h], quad_max(cm));
        float ls = 0.f;
#pragma unroll
        for (int n = 0; n < 4; ++n)
          ls += expf(s[4 * n + 2 * h] - mn) + expf(s[4 * n + 2 * h + 1] - mn);
        l[h] = l[h] * expf(m[h] - mn) + ls;
        m[h] = mn;
      }
      if (u == nt - 1) {               // merge the halves: 0's, then 1's
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          l[h] = quad_sum(l[h]);
          if ((tid & 3) == 0)
            ml[wg * 64 + wi * 16 + g + 8 * h] = make_float2(m[h], l[h]);
        }
        __syncthreads();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wi * 16 + g + 8 * h;
          const float2 a0 = ml[r], a1 = ml[64 + r];
          const float mx = fmaxf(a0.x, a1.x);
          m[h] = mx;
          l[h] = a0.y * expf(a0.x - mx) + a1.y * expf(a1.x - mx);
          inv[h] = 1.f / l[h];
        }
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {     // pass 2: p, rounded, then o += p v
      const int h = (i >> 1) & 1;
      s[i] = expf(s[i] - m[h]) * inv[h];
    }
    uint32_t pa[2][4];
    pack_a<32>(s, pa);
    const uint32_t Vs = sm + SM::V + slot * SA_TILE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      wgmma_rs<128>(acc[0], pa[kk], desc_mn(Vs, 32 * wg + 16 * kk, 0));
      wgmma_rs<128>(acc[1], pa[kk], desc_mn(Vs, 32 * wg + 16 * kk, 128));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
  }

  float* xch = reinterpret_cast<float*>(gen + SM::K);
  const bool w0 = sum_warpgroups(acc[0], xch);
  if (!sum_warpgroups(acc[1], xch) || !w0) return;
  const int rows_left = L - q0;
  bf16* ob = o + ((size_t)b * L + q0) * D_MODEL;
  store_bf16<128>(acc[0], ob, D_MODEL, rows_left, 1.f);
  store_bf16<128>(acc[1], ob + 128, D_MODEL, rows_left, 1.f);
  if ((tid & 3) == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wi * 16 + g + 8 * h;
      if (r < rows_left) lse[(size_t)b * L + q0 + r] = m[h] + logf(l[h]);
    }
}

// the RoPE adjoint of the column pairs (c0 + j, 128 + c0 + j), j < NH, of
// two accumulators (lo: columns c0 .., hi: 128 + c0 ..), rounded as the
// plain walk (round the product's output, then each rotation term),
// stored to rows [0, rows_left) of dst (row stride ld); the RoPE position
// of local row r is pos0 + r
template <int NH>
__device__ __forceinline__ void store_rope_t(const float (&lo)[NH / 2],
                                             const float (&hi)[NH / 2],
                                             bf16* dst, long ld, int c0,
                                             int rows_left, int pos0,
                                             const float* cosv,
                                             const float* sinv) {
  const int warp = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2;
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    const size_t at = (size_t)(pos0 + (r < rows_left ? r : 0)) * D_MODEL + c0 +
                      2 * q;
    float2 cs[NH / 8], sn[NH / 8];     // every load before the first store
#pragma unroll
    for (int n = 0; n < NH / 8; ++n) {
      cs[n] = __ldg(reinterpret_cast<const float2*>(cosv + at + 8 * n));
      sn[n] = __ldg(reinterpret_cast<const float2*>(sinv + at + 8 * n));
    }
    if (r >= rows_left) continue;
#pragma unroll
    for (int n = 0; n < NH / 8; ++n) {
      const int j = c0 + 8 * n + 2 * q;
      const float c2[2] = {rb(cs[n].x), rb(cs[n].y)};
      const float s2[2] = {rb(sn[n].x), rb(sn[n].y)};
      float y1[2], y2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x1 = rb(lo[4 * n + 2 * h + e]), x2 = rb(hi[4 * n + 2 * h + e]);
        y1[e] = rb(x1 * c2[e]) + rb(x2 * s2[e]);
        y2[e] = rb(x2 * c2[e]) - rb(x1 * s2[e]);
      }
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r * ld + j) =
          __floats2bfloat162_rn(y1[0], y1[1]);
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r * ld + 128 + j) =
          __floats2bfloat162_rn(y2[0], y2[1]);
    }
  }
}

struct SaDqSmem {
  static constexpr int Q = 0;
  static constexpr int DO = Q + SA_TILE;
  static constexpr int K = DO + SA_TILE;
  static constexpr int V = K + 2 * SA_TILE;
  static constexpr int DEL = V + 2 * SA_TILE;
  static constexpr int BYTES = DEL + 64 * 4 + 1024;
};

// dq: grid (ceil(L / 64), N), all 256 columns per block. delta =
// rowsum(do * o) of its rows, also written for the dk / dv pass. ds =
// bf16(p (dp - delta) scale), dq = RoPE^T(bf16(ds k)) into the q columns
// of dqkv [N * L, 768].
__global__ void __launch_bounds__(SA_THREADS, 1)
sa_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ o,
             const bf16* __restrict__ dout, const float* __restrict__ lse,
             float* __restrict__ delta, bf16* __restrict__ dqkv,
             const float* __restrict__ cosv, const float* __restrict__ sinv,
             int L, int Lv, float scale) {
  using SM = SaDqSmem;
  extern __shared__ unsigned char sa_smem[];
  unsigned char* gen;
  const uint32_t sm = aligned_smem(sa_smem, &gen);
  float* del_s = reinterpret_cast<float*>(gen + SM::DEL);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = tid >> 7, wi = warp & 3, g = lane >> 2;
  const int b = blockIdx.y, q0 = blockIdx.x * 64;
  const bf16* base = qkv + (size_t)b * L * QKV_LD;
  const size_t rb0 = (size_t)b * L;
  const int nt = cdiv(Lv, 64);

  auto load = [&](int t) {
    const int slot = t & 1;
    stage_block<64, D_MODEL, SA_THREADS>(sm + SM::K + slot * SA_TILE,
                                         base + D_MODEL, QKV_LD, t * 64, Lv,
                                         0, D_MODEL);
    stage_block<64, D_MODEL, SA_THREADS>(sm + SM::V + slot * SA_TILE,
                                         base + 2 * D_MODEL, QKV_LD, t * 64,
                                         Lv, 0, D_MODEL);
  };
  stage_block<64, D_MODEL, SA_THREADS>(sm + SM::Q, base, QKV_LD, q0, L, 0,
                                       D_MODEL);
  stage_block<64, D_MODEL, SA_THREADS>(sm + SM::DO, dout + rb0 * D_MODEL,
                                       D_MODEL, q0, L, 0, D_MODEL);
  load(0);
  cp_async_commit();

  {                                    // delta, a warp per row, 8 rows each
    uint4 ra[8], rc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = min(q0 + warp * 8 + i, L - 1);
      const size_t e = (rb0 + row) * D_MODEL + 8 * lane;
      ra[i] = __ldg(reinterpret_cast<const uint4*>(dout + e));
      rc[i] = __ldg(reinterpret_cast<const uint4*>(o + e));
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int rl = warp * 8 + i, row = q0 + rl;
      float a[8], c[8], sd = 0.f;
      unpack8(ra[i], a);
      unpack8(rc[i], c);
#pragma unroll
      for (int e = 0; e < 8; ++e) sd += a[e] * c[e];
      sd = row < L ? warp_sum(sd) : 0.f;
      if (lane == 0) {
        del_s[rl] = sd;
        if (row < L) delta[rb0 + row] = sd;
      }
    }
  }
  float lse_r[2], del_r[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wi * 16 + g + 8 * h;
    lse_r[h] = row < L ? lse[rb0 + row] : INFINITY;
  }
  float dq[2][64];                     // columns 0..127, 128..255
  zero(dq[0]);
  zero(dq[1]);

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (t + 1 < nt) load(t + 1);
    cp_async_commit();
    if (t == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) del_r[h] = del_s[wi * 16 + g + 8 * h];
    const int slot = t & 1;
    const uint32_t Ks = sm + SM::K + slot * SA_TILE;
    const uint32_t Vs = sm + SM::V + slot * SA_TILE;
    float s[16], dp[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D_MODEL / 16; ++kk)
      wgmma_ss_n32(s, desc_k(sm + SM::Q, kk * 16),
                   desc_k(Ks + wg * 32 * 128, kk * 16), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D_MODEL / 16; ++kk)
      wgmma_ss_n32(dp, desc_k(sm + SM::DO, kk * 16),
                   desc_k(Vs + wg * 32 * 128, kk * 16), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
    const int kmax = Lv - t * 64 - 32 * wg;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      s[i] = acc_col(i) < kmax ? expf(s[i] * scale - lse_r[(i >> 1) & 1])
                               : 0.f;         // p
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      s[i] = s[i] * (dp[i] - del_r[(i >> 1) & 1]) * scale;   // ds
    uint32_t da[2][4];
    pack_a<32>(s, da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      wgmma_rs<128>(dq[0], da[kk], desc_mn(Ks, 32 * wg + 16 * kk, 0));
      wgmma_rs<128>(dq[1], da[kk], desc_mn(Ks, 32 * wg + 16 * kk, 128));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq[0]);
    fence_regs(dq[1]);
  }
  float* xch = reinterpret_cast<float*>(gen + SM::K);
  const bool w0 = sum_warpgroups(dq[0], xch);
  if (!sum_warpgroups(dq[1], xch) || !w0) return;
  store_rope_t<128>(dq[0], dq[1], dqkv + (rb0 + q0) * QKV_LD, QKV_LD, 0,
                    L - q0, q0, cosv, sinv);
}

struct SaDkvSmem {
  static constexpr int K = 0;
  static constexpr int V = K + SA_TILE;
  static constexpr int Q = V + SA_TILE;
  static constexpr int DO = Q + 2 * SA_TILE;
  static constexpr int LSE = DO + 2 * SA_TILE;
  static constexpr int DEL = LSE + 2 * 64 * 4;
  static constexpr int P = DEL + 2 * 64 * 4;   // p^T, f32, 32 per thread
  static constexpr int BYTES = P + 32 * 128 * 4 + 1024;
};

// dk / dv: grid (ceil(L / 64), N) over all L rows (keys at and past Lv
// get zeros), over all query tiles; the warpgroups split the work, not the
// tile, two products each: warpgroup 1 forms s^T = k q^T and p^T (f32,
// passed to warpgroup 0 through shared memory) and dv += bf16(p^T) do,
// warpgroup 0 dp^T = v do^T and dk += ds^T q (all 256 columns each; then
// dk = RoPE^T(bf16(dk))).
__global__ void __launch_bounds__(SA_THREADS, 1)
sa_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dqkv, const float* __restrict__ cosv,
              const float* __restrict__ sinv, int L, int Lv, float scale) {
  using SM = SaDkvSmem;
  extern __shared__ unsigned char sa_smem[];
  unsigned char* gen;
  const uint32_t sm = aligned_smem(sa_smem, &gen);
  const float* lse_s = reinterpret_cast<const float*>(gen + SM::LSE);
  const float* del_s = reinterpret_cast<const float*>(gen + SM::DEL);
  const int tid = threadIdx.x, wg = tid >> 7, wi = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2;
  const int b = blockIdx.y, k0 = blockIdx.x * 64;
  const bf16* base = qkv + (size_t)b * L * QKV_LD;
  const size_t rb0 = (size_t)b * L;
  const int nq = cdiv(L, 64);

  auto load = [&](int t) {
    const int slot = t & 1;
    stage_block<64, D_MODEL, SA_THREADS>(sm + SM::Q + slot * SA_TILE, base,
                                         QKV_LD, t * 64, L, 0, D_MODEL);
    stage_block<64, D_MODEL, SA_THREADS>(sm + SM::DO + slot * SA_TILE,
                                         dout + rb0 * D_MODEL, D_MODEL, t * 64,
                                         L, 0, D_MODEL);
    stage_row_f32(sm + SM::LSE + slot * 256, lse + rb0, t * 64, L);
    stage_row_f32(sm + SM::DEL + slot * 256, delta + rb0, t * 64, L);
  };
  stage_block<64, D_MODEL, SA_THREADS>(sm + SM::K, base + D_MODEL, QKV_LD, k0,
                                       L, 0, D_MODEL);
  stage_block<64, D_MODEL, SA_THREADS>(sm + SM::V, base + 2 * D_MODEL, QKV_LD,
                                       k0, L, 0, D_MODEL);
  load(0);
  cp_async_commit();

  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) key_ok[h] = k0 + wi * 16 + g + 8 * h < Lv;
  float acc[2][64];                    // dk (warpgroup 0) or dv (1)
  zero(acc[0]);
  zero(acc[1]);

  for (int t = 0; t < nq; ++t) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (t + 1 < nq) load(t + 1);
    cp_async_commit();
    const int slot = t & 1;
    const uint32_t Qs = sm + SM::Q + slot * SA_TILE;
    const uint32_t Ds = sm + SM::DO + slot * SA_TILE;
    float s[32];
    uint32_t fa[4][4];
    float* pt = reinterpret_cast<float*>(gen + SM::P);
    const int wt = tid & 127;
    // warpgroup 0: dp^T = v do^T; warpgroup 1: s^T = k q^T
    const uint32_t As = wg == 0 ? sm + SM::V : sm + SM::K;
    const uint32_t Bs = wg == 0 ? Ds : Qs;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D_MODEL / 16; ++kk)
      wgmma_ss_n64(s, desc_k(As, kk * 16), desc_k(Bs, kk * 16), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (wg == 1) {
      const float* ls = lse_s + slot * 64;
      const int qmax = L - t * 64;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = acc_col(i);
        s[i] = c < qmax && key_ok[(i >> 1) & 1] ? expf(s[i] * scale - ls[c])
                                                : 0.f;     // p^T
        pt[i * 128 + wt] = s[i];
      }
      asm volatile("bar.arrive 1, 256;" ::: "memory");   // p^T is in place
      pack_a<64>(s, fa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {                     // dv += p^T do
        wgmma_rs<128>(acc[0], fa[kk], desc_mn(Ds, kk * 16, 0));
        wgmma_rs<128>(acc[1], fa[kk], desc_mn(Ds, kk * 16, 128));
      }
    } else {
      const float* dl = del_s + slot * 64;
      asm volatile("bar.sync 1, 256;" ::: "memory");
#pragma unroll
      for (int i = 0; i < 32; ++i)                         // ds^T
        s[i] = pt[i * 128 + wt] * (s[i] - dl[acc_col(i)]) * scale;
      pack_a<64>(s, fa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {                     // dk += ds^T q
        wgmma_rs<128>(acc[0], fa[kk], desc_mn(Qs, kk * 16, 0));
        wgmma_rs<128>(acc[1], fa[kk], desc_mn(Qs, kk * 16, 128));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
  }
  bf16* dst = dqkv + (rb0 + k0) * QKV_LD;
  if (wg == 1) {
    store_bf16<128>(acc[0], dst + 2 * D_MODEL, QKV_LD, L - k0, 1.f);
    store_bf16<128>(acc[1], dst + 2 * D_MODEL + 128, QKV_LD, L - k0, 1.f);
  } else {
    store_rope_t<128>(acc[0], acc[1], dst + D_MODEL, QKV_LD, 0, L - k0, k0,
                      cosv, sinv);
  }
}

static int self_attention_fwd(const bf16* qkv, bf16* o, float* lse, int N,
                              int L, int Lv, cudaStream_t st) {
  const float scale = 1.0f / sqrtf((float)D_MODEL);
  const int err = set_smem(sa_fwd_kernel, SaFwdSmem::BYTES);
  if (err) return err;
  sa_fwd_kernel<<<dim3(cdiv(L, 64), N), SA_THREADS, SaFwdSmem::BYTES, st>>>(
      qkv, o, lse, L, Lv, scale);
  return 0;
}

// ---------------------------------------------------------------------------
// LayerNorm backward with column partials, and the last sum of partials
// ---------------------------------------------------------------------------

// rows per block, two per warp: 8-warp blocks, four to an SM, so every
// block of the path's 4608 rows runs at once
constexpr int LB_ROWS = 16;
constexpr int LB_WARPS = 8;
constexpr int LB_PART = 3 * D_MODEL;   // per block: sum dy xhat, dy, dx

// rows of 256: with xhat, rinv from x (bf16) in f32 and dxh = dy * w,
//   dx = rinv (dxh - mean(dxh) - xhat mean(dxh xhat)) + g (f32 g32 or bf16
//   gb, or none), stored f32 (dx32) and / or bf16 (dxb);
// part[block]: column sums over the block's rows of dy xhat (the LN
// weight's gradient), dy (its bias') and dx, each in a fixed order
__global__ void __launch_bounds__(LB_WARPS * 32)
ln_bwd_part_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ dy, int dy_parts,
                   const float* g32, const bf16* gb, float* dx32, bf16* dxb,
                   float* __restrict__ part, int rows) {
  __shared__ float red[LB_WARPS][LB_PART];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float pw[8], pb[8], po[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) pw[k] = pb[k] = po[k] = 0.f;
  float wv[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) wv[k] = __ldg(w + lane + 32 * k);
#pragma unroll
  for (int i = 0; i < LB_ROWS / LB_WARPS; ++i) {
    const size_t row = (size_t)blockIdx.x * LB_ROWS + warp + LB_WARPS * i;
    const bool ok = row < (size_t)rows;  // uniform per warp
    const size_t rl = ok ? row : rows - 1;
    float xv[8], dv[8], dyv[8], gv[8], s = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {      // loads not held behind the stores
      const size_t e = rl * D_MODEL + lane + 32 * k;
      xv[k] = to_f32(__ldg(x + e));
      dyv[k] = __ldg(dy + e);
#pragma unroll
      for (int p = 1; p < MF_SPLITS; ++p)  // dy's partials, in order
        if (p < dy_parts) dyv[k] += __ldg(dy + (size_t)p * rows * D_MODEL + e);
      gv[k] = g32 ? __ldg(g32 + e) : gb ? to_f32(__ldg(gb + e)) : 0.f;
      s += xv[k];
    }
    const float mu = warp_sum(s) / D_MODEL;
    float qv = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) qv += (xv[k] - mu) * (xv[k] - mu);
    const float rinv = rsqrtf(warp_sum(qv) / D_MODEL + LN_EPS);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float d = ok ? dyv[k] : 0.f;
      xv[k] = (xv[k] - mu) * rinv;
      dv[k] = d * wv[k];
      s1 += dv[k];
      s2 += dv[k] * xv[k];
      pw[k] += d * xv[k];
      pb[k] += d;
    }
    const float m1 = warp_sum(s1) / D_MODEL, m2 = warp_sum(s2) / D_MODEL;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const size_t e = row * D_MODEL + lane + 32 * k;
      const float v = rinv * (dv[k] - m1 - xv[k] * m2) + gv[k];
      if (!ok) continue;
      if (dx32) dx32[e] = v;
      if (dxb) dxb[e] = to_bf16(v);
      po[k] += v;
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    red[warp][lane + 32 * k] = pw[k];
    red[warp][D_MODEL + lane + 32 * k] = pb[k];
    red[warp][2 * D_MODEL + lane + 32 * k] = po[k];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < LB_PART; e += LB_WARPS * 32) {
    float t = 0.f;
#pragma unroll
    for (int v = 0; v < LB_WARPS; ++v) t += red[v][e];
    part[(size_t)blockIdx.x * LB_PART + e] = t;
  }
}

static int ln_blocks(int rows) { return cdiv(rows, LB_ROWS); }

// dy: dy_parts (<= MF_SPLITS) f32 partials [dy_parts][rows][256], added
// in order
static void ln_bwd_part(const bf16* x, const float* w, const float* dy,
                        int dy_parts, const float* g32, const bf16* gb,
                        float* dx32, bf16* dxb, float* part, int rows,
                        cudaStream_t st) {
  ln_bwd_part_kernel<<<ln_blocks(rows), LB_WARPS * 32, 0, st>>>(
      x, w, dy, dy_parts, g32, gb, dx32, dxb, part, rows);
}

// K chunks of a weight gradient [M, N] summed over K rows
static int wsplits(int M, int N, int K) {
  int tps;
  return gm_k_splits(gm_cdiv(M, GM_BM) * gm_cdiv(N, GM_BN), K, &tps);
}

// a weight-gradient op: part [splits][M][N] of dY^T X, dY [K rows, M], X [K
// rows, N] (row strides lda, ldb); with colsum, dY's column sums
static GemmOp wgrad_op(const bf16* dy, long lda, const bf16* x, long ldb,
                       int M, int N, int K, float* part, float* colsum) {
  GemmOp o = gemm_op(dy, lda, 1, x, ldb, 1, M, N, K);
  o.part = part;
  o.colsum = colsum;
  return o;
}

extern "C" int memattn_k_splits(int M, int N, int K) {
  return wsplits(M, N, K);
}

// ---------------------------------------------------------------------------
// Self block
// ---------------------------------------------------------------------------

// leaves: ln1w ln1b wq bq wk bk wv bv wo bo ln2w ln2b wqc bqc
constexpr int S_LEAVES = 14;
static const long S_N[S_LEAVES] = {256, 256, 65536, 256, 65536, 256, 65536,
                                   256, 65536, 256, 256, 256, 65536, 256};
static const int S_MAT[S_LEAVES] = {0, 0, 1, 0, 1, 0, 1, 0, 1, 0, 0, 0, 1, 0};

// the packed weights (wq, wk, wv adjacent: Wqkv [768, 256]; bq, bk, bv:
// bqkv [768])
struct SelfW {
  const bf16 *wqkv, *wo, *wqc;
  const float *ln1w, *ln1b, *bqkv, *bo, *ln2w, *ln2b, *bqc;
};

static SelfW self_w(const void* packed) {
  const PackLayout L = pack_layout(S_N, S_MAT, S_LEAVES);
  const unsigned char* p = static_cast<const unsigned char*>(packed);
  auto B = [&](int i) { return reinterpret_cast<const bf16*>(p + L.off[i]); };
  auto F = [&](int i) { return reinterpret_cast<const float*>(p + L.off[i]); };
  return SelfW{B(2), B(8), B(12), F(0), F(1), F(3), F(9), F(10), F(11), F(13)};
}

extern "C" long memattn_self_pack_bytes() {
  return pack_layout(S_N, S_MAT, S_LEAVES).bytes;
}

// f32 gradient layout (the leaves' order with q, k, v stacked)
constexpr long SG_LN1W = 0, SG_LN1B = 256, SG_WQKV = 512,
               SG_BQKV = SG_WQKV + 768 * 256, SG_WO = SG_BQKV + 768,
               SG_BO = SG_WO + 256 * 256, SG_LN2W = SG_BO + 256,
               SG_LN2B = SG_LN2W + 256, SG_WQC = SG_LN2B + 256,
               SG_BQC = SG_WQC + 256 * 256, SG_TOTAL = SG_BQC + 256;

struct SelfBufs {
  bf16 *xn, *qkv, *o, *out, *y2, *dqc, *doutc, *dob, *dqkv;
  float *lse, *delta, *dy2, *dout32, *dxn, *ln1p, *ln2p, *pqc, *cqc, *pwo,
      *pqkv, *cqkv;
  int s_qc, s_wo, s_qkv;
};

static SelfBufs carve_self(Arena& ar, int N, int L, bool bwd) {
  const size_t NL = (size_t)N * L, D = D_MODEL;
  SelfBufs b{};
  b.qkv = ar.take<bf16>(NL * QKV_LD);
  b.o = ar.take<bf16>(NL * D);
  b.lse = ar.take<float>(NL);
  if (!bwd) return b;
  const int K = (int)NL, P = ln_blocks(K);
  b.s_qc = wsplits(256, 256, K);
  b.s_wo = b.s_qc;
  b.s_qkv = wsplits(768, 256, K);
  b.xn = ar.take<bf16>(NL * D);
  b.out = ar.take<bf16>(NL * D);
  b.y2 = ar.take<bf16>(NL * D);
  b.dqc = ar.take<bf16>(NL * D);
  b.doutc = ar.take<bf16>(NL * D);
  b.dob = ar.take<bf16>(NL * D);
  b.dqkv = ar.take<bf16>(NL * QKV_LD);
  b.delta = ar.take<float>(NL);
  b.dy2 = ar.take<float>(NL * D);
  b.dout32 = ar.take<float>(NL * D);
  b.dxn = ar.take<float>(NL * D);
  b.ln1p = ar.take<float>((size_t)P * LB_PART);
  b.ln2p = ar.take<float>((size_t)P * LB_PART);
  b.pqc = ar.take<float>((size_t)b.s_qc * 256 * 256);
  b.cqc = ar.take<float>((size_t)b.s_qc * 256);
  b.pwo = ar.take<float>((size_t)b.s_wo * 256 * 256);
  b.pqkv = ar.take<float>((size_t)b.s_qkv * 768 * 256);
  b.cqkv = ar.take<float>((size_t)b.s_qkv * 768);
  return b;
}

extern "C" long memattn_self_workspace_bytes(int N, int L, int bwd) {
  Arena ar{nullptr, 0};
  carve_self(ar, N, L, bwd != 0);
  return (long)ar.off;
}

// LN1 -> q, k (RoPE), v into qkv; xn stored when given
static RowChain qkv_chain(const bf16* x, const SelfW& W, bf16* xn, bf16* qkv,
                          const float* cs, const float* sn, int L, int M) {
  RowChain c{};
  c.in = x;
  c.kin = D_MODEL;
  c.lnw = W.ln1w;
  c.lnb = W.ln1b;
  c.ln_out = xn;
  c.nsteps = 3;
  for (int i = 0; i < 3; ++i) {
    RowStep& s = c.step[i];
    s.w = W.wqkv + (size_t)i * D_MODEL * D_MODEL;
    s.k = D_MODEL;
    s.bias = W.bqkv + i * D_MODEL;
    s.rope = i < 2;
    s.out = qkv + i * D_MODEL;
    s.ld_out = QKV_LD;
    s.feed = FEED_KEEP;
  }
  c.cosv = cs;
  c.sinv = sn;
  c.L = L;
  c.M = M;
  return c;
}

// out = x + o Wo^T + bo -> LN2 (y2 stored when given) [-> q3 = RoPE(LN2
// Wqc^T + bqc) when q3 is given]
static RowChain out_chain(const bf16* o, const bf16* x, const SelfW& W,
                          bf16* out, bf16* y2, bf16* q3, const float* cs,
                          const float* sn, int L, int M) {
  RowChain c{};
  c.in = o;
  c.kin = D_MODEL;
  c.nsteps = q3 ? 2 : 1;
  RowStep& a = c.step[0];
  a.w = W.wo;
  a.k = D_MODEL;
  a.bias = W.bo;
  a.res = x;
  a.out = out;
  a.ld_out = D_MODEL;
  a.feed = FEED_LN;
  a.lnw = W.ln2w;
  a.lnb = W.ln2b;
  a.ln_out = y2;
  RowStep& b = c.step[1];
  b.w = W.wqc;
  b.k = D_MODEL;
  b.bias = W.bqc;
  b.rope = 1;
  b.out = q3;
  b.ld_out = D_MODEL;
  b.feed = FEED_KEEP;
  c.cosv = cs;
  c.sinv = sn;
  c.L = L;
  c.M = M;
  return c;
}

// x [N, L, 256] bf16, of which the first Lv tokens of each object are real
// (the rest are pad keys, masked in the softmax); leaves: the 14 leaves'
// pointers, bit i of bf16_mask set where leaf i is bf16 (else f32);
// packed: memattn_self_pack_bytes() bytes, filled here for the backward
extern "C" int memattn_self_fwd(const void* x_, const void* const* leaves,
                                int bf16_mask, void* packed, const void* cosv,
                                const void* sinv, void* out, void* q3,
                                void* ws, int N, int L, int Lv,
                                void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  Arena ar{static_cast<char*>(ws), 0};
  SelfBufs b = carve_self(ar, N, L, false);
  const bf16* x = static_cast<const bf16*>(x_);
  const float* cs = static_cast<const float*>(cosv);
  const float* sn = static_cast<const float*>(sinv);
  const int M = N * L;
  if (Lv < 1 || Lv > L) return (int)cudaErrorInvalidValue;
  pack_launch(leaves, bf16_mask, S_N, S_MAT, S_LEAVES,
              static_cast<unsigned char*>(packed), st);
  const SelfW W = self_w(packed);
  int err = row_chain(qkv_chain(x, W, nullptr, b.qkv, cs, sn, L, M), st);
  if (!err) err = self_attention_fwd(b.qkv, b.o, b.lse, N, L, Lv, st);
  if (!err)
    err = row_chain(out_chain(b.o, x, W, static_cast<bf16*>(out), nullptr,
                              static_cast<bf16*>(q3), cs, sn, L, M),
                    st);
  return err ? err : (int)cudaGetLastError();
}

// grads: f32 [SG_TOTAL] in the SG_* layout; dx bf16 [N, L, 256]
extern "C" int memattn_self_bwd(const void* x_, const void* packed,
                                const void* cosv, const void* sinv,
                                const void* dout_, const void* dq3_, void* dx,
                                void* grads, void* ws, int N, int L, int Lv,
                                void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  Arena ar{static_cast<char*>(ws), 0};
  SelfBufs b = carve_self(ar, N, L, true);
  const SelfW W = self_w(packed);
  const bf16* x = static_cast<const bf16*>(x_);
  const bf16* dout = static_cast<const bf16*>(dout_);
  const float* cs = static_cast<const float*>(cosv);
  const float* sn = static_cast<const float*>(sinv);
  const int M = N * L, D = D_MODEL;
  const float scale = 1.0f / sqrtf((float)D);
  if (Lv < 1 || Lv > L) return (int)cudaErrorInvalidValue;

  // ---- forward recompute: xn, q / k / v, o, lse, out, y2; dqc = RoPE^T(dq3)
  int err = row_chain(qkv_chain(x, W, b.xn, b.qkv, cs, sn, L, M), st);
  if (!err) err = self_attention_fwd(b.qkv, b.o, b.lse, N, L, Lv, st);
  if (!err) {
    RowChain c = out_chain(b.o, x, W, b.out, b.y2, nullptr, cs, sn, L, M);
    c.aux_src = static_cast<const bf16*>(dq3_);
    c.aux_dst = b.dqc;
    err = row_chain(c, st);
  }
  if (err) return err;

  // ---- q-proj backward: dWqc = dqc^T y2 (+ dbqc), dy2 = dqc Wqc
  GemmGroup G{};
  G.n = 2;
  G.op[0] = wgrad_op(b.dqc, D, b.y2, D, D, D, M, b.pqc, b.cqc);
  G.op[1] = gemm_op(b.dqc, D, 0, W.wqc, D, 1, M, D, D);
  G.op[1].out32 = b.dy2;
  if ((err = gemm_group(G, st))) return err;
  // LN2 backward: dout_tot = dout + LN2'(dy2); dln2w, dln2b, dbo partials
  ln_bwd_part(b.out, W.ln2w, b.dy2, 1, nullptr, dout, b.dout32, b.doutc,
              b.ln2p, M, st);
  // ---- out-proj backward: dWo = doutc^T o, do = doutc Wo
  G = GemmGroup{};
  G.n = 2;
  G.op[0] = wgrad_op(b.doutc, D, b.o, D, D, D, M, b.pwo, nullptr);
  G.op[1] = gemm_op(b.doutc, D, 0, W.wo, D, 1, M, D, D);
  G.op[1].out = b.dob;
  if ((err = gemm_group(G, st))) return err;

  // ---- attention backward into dqkv (q, k with the RoPE adjoint)
  if ((err = set_smem(sa_dq_kernel, SaDqSmem::BYTES))) return err;
  sa_dq_kernel<<<dim3(cdiv(L, 64), N), SA_THREADS, SaDqSmem::BYTES, st>>>(
      b.qkv, b.o, b.dob, b.lse, b.delta, b.dqkv, cs, sn, L, Lv, scale);
  if ((err = set_smem(sa_dkv_kernel, SaDkvSmem::BYTES))) return err;
  sa_dkv_kernel<<<dim3(cdiv(L, 64), N), SA_THREADS, SaDkvSmem::BYTES, st>>>(
      b.qkv, b.dob, b.lse, b.delta, b.dqkv, cs, sn, L, Lv, scale);

  // ---- q / k / v projections: dWqkv = dqkv^T xn (+ dbqkv), dxn = dqkv Wqkv
  G = GemmGroup{};
  G.n = 2;
  G.op[0] = wgrad_op(b.dqkv, QKV_LD, b.xn, D, QKV_LD, D, M, b.pqkv, b.cqkv);
  G.op[1] = gemm_op(b.dqkv, QKV_LD, 0, W.wqkv, D, 1, M, D, QKV_LD);
  G.op[1].out32 = b.dxn;
  if ((err = gemm_group(G, st))) return err;
  // LN1 backward + the residual: dx = dout_tot + LN1'(dxn)
  ln_bwd_part(x, W.ln1w, b.dxn, 1, b.dout32, nullptr, nullptr,
              static_cast<bf16*>(dx), b.ln1p, M, st);

  // ---- every partial, added in order
  const int P = ln_blocks(M);
  RedPlan R{};
  reduce_add(R, b.ln1p, LB_PART, P, D);                 // ln1w
  reduce_add(R, b.ln1p + D, LB_PART, P, D);             // ln1b
  reduce_add(R, b.pqkv, (long)QKV_LD * D, b.s_qkv, (long)QKV_LD * D);
  reduce_add(R, b.cqkv, QKV_LD, b.s_qkv, QKV_LD);       // bqkv
  reduce_add(R, b.pwo, (long)D * D, b.s_wo, (long)D * D);
  reduce_add(R, b.ln2p + 2 * D, LB_PART, P, D);         // bo
  reduce_add(R, b.ln2p, LB_PART, P, D);                 // ln2w
  reduce_add(R, b.ln2p + D, LB_PART, P, D);             // ln2b
  reduce_add(R, b.pqc, (long)D * D, b.s_qc, (long)D * D);
  reduce_add(R, b.cqc, D, b.s_qc, D);                   // bqc
  if (R.total != SG_TOTAL) return (int)cudaErrorInvalidValue;
  reduce_launch(R, static_cast<float*>(grads), st);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tail block
// ---------------------------------------------------------------------------

// leaves: wv[256, kv] bv wo bo ln3w ln3b w1[hid, 256] b1 w2[256, hid] b2
constexpr int T_LEAVES = 10;
static const int T_MAT[T_LEAVES] = {1, 0, 1, 0, 0, 0, 1, 0, 1, 0};

static void tail_sizes(int KV, int HID, long* n) {
  const long s[T_LEAVES] = {256L * KV, 256, 65536, 256, 256, 256,
                            (long)HID * 256, HID, 256L * HID, 256};
  for (int i = 0; i < T_LEAVES; ++i) n[i] = s[i];
}

struct TailW {
  const bf16 *wv, *wo, *w1, *w2;
  const float *bv, *bo, *ln3w, *ln3b, *b1, *b2;
};

static TailW tail_w(const void* packed, int KV, int HID) {
  long n[T_LEAVES];
  tail_sizes(KV, HID, n);
  const PackLayout L = pack_layout(n, T_MAT, T_LEAVES);
  const unsigned char* p = static_cast<const unsigned char*>(packed);
  auto B = [&](int i) { return reinterpret_cast<const bf16*>(p + L.off[i]); };
  auto F = [&](int i) { return reinterpret_cast<const float*>(p + L.off[i]); };
  return TailW{B(0), B(2), B(6), B(8), F(1), F(3), F(4), F(5), F(7), F(9)};
}

extern "C" long memattn_tail_pack_bytes(int KV, int HID) {
  long n[T_LEAVES];
  tail_sizes(KV, HID, n);
  return pack_layout(n, T_MAT, T_LEAVES).bytes;
}

extern "C" long memattn_tail_grad_floats(int KV, int HID) {
  long n[T_LEAVES], t = 0;
  tail_sizes(KV, HID, n);
  for (int i = 0; i < T_LEAVES; ++i) t += n[i];
  return t;
}

struct TailBufs {
  bf16 *t, *z, *h, *r, *dm1, *dt;
  float *part, *dh, *ln3p, *pw1, *c1, *pw2, *c2, *pwo, *pwv, *cv;
  int s1, s2, so, sv;
};

static TailBufs carve_tail(Arena& ar, int N, int L, int KV, int HID,
                           bool bwd) {
  const size_t NL = (size_t)N * L, D = D_MODEL;
  TailBufs b{};
  b.z = ar.take<bf16>(NL * D);
  b.h = ar.take<bf16>(NL * D);
  if (!bwd) {
    b.part = ar.take<float>((size_t)MF_SPLITS * NL * D);
    return b;
  }
  b.r = ar.take<bf16>(NL * HID);
  const int K = (int)NL;
  b.s1 = wsplits(HID, 256, K);
  b.s2 = wsplits(256, HID, K);
  b.so = wsplits(256, 256, K);
  b.sv = wsplits(256, KV, K);
  b.t = ar.take<bf16>(NL * D);
  b.dm1 = ar.take<bf16>(NL * HID);
  b.dt = ar.take<bf16>(NL * D);
  b.dh = ar.take<float>((size_t)MF_SPLITS * NL * D);
  b.ln3p = ar.take<float>((size_t)ln_blocks(K) * LB_PART);
  b.pw1 = ar.take<float>((size_t)b.s1 * HID * 256);
  b.c1 = ar.take<float>((size_t)b.s1 * HID);
  b.pw2 = ar.take<float>((size_t)b.s2 * 256 * HID);
  b.c2 = ar.take<float>((size_t)b.s2 * 256);
  b.pwo = ar.take<float>((size_t)b.so * 256 * 256);
  b.pwv = ar.take<float>((size_t)b.sv * 256 * KV);
  b.cv = ar.take<float>((size_t)b.sv * 256);
  return b;
}

extern "C" long memattn_tail_workspace_bytes(int N, int L, int KV, int HID,
                                             int bwd) {
  Arena ar{nullptr, 0};
  carve_tail(ar, N, L, KV, HID, bwd != 0);
  return (long)ar.off;
}

// a -> t = a Wv^T + bv (stored when given) -> z = y + t Wo^T + bo -> h =
// LN3(z)
static RowChain front_chain(const bf16* y, const bf16* a, const TailW& W,
                            bf16* t, bf16* z, bf16* h, int KV, int M) {
  RowChain c{};
  c.in = a;
  c.kin = KV;
  c.nsteps = 2;
  RowStep& v = c.step[0];
  v.w = W.wv;
  v.k = KV;
  v.bias = W.bv;
  v.out = t;
  v.ld_out = D_MODEL;
  v.feed = FEED_OUT;
  RowStep& o = c.step[1];
  o.w = W.wo;
  o.k = D_MODEL;
  o.bias = W.bo;
  o.res = y;
  o.out = z;
  o.ld_out = D_MODEL;
  o.feed = FEED_LN;
  o.lnw = W.ln3w;
  o.lnb = W.ln3b;
  o.ln_out = h;
  c.L = 1;
  c.M = M;
  return c;
}

// ---------------------------------------------------------------------------
// The tail's MLP forward, r never in device memory: a block of two
// warpgroups owns 128 rows (64 each) and a third of the hidden units; per
// chunk of 64 hidden units r = ReLU(h W1c^T + b1c) is formed in registers,
// rounded, and becomes the A operand of out += r W2c^T. The three f32
// partials are added (in order) by mlp_finish_kernel with linear2's walk.
// ---------------------------------------------------------------------------

struct MfSmem {
  static constexpr int H = 0;                // two 64-row tiles of h
  static constexpr int W = H + 2 * SA_TILE;  // ring of (W1 chunk, W2 chunk)
  static constexpr int BYTES = W + 2 * 2 * MF_W + 1024;
};

// part [MF_SPLITS][M][256] f32: split blockIdx.y's sum over its hidden
// chunks of ReLU(rb(rb(h W1^T) + rb(b1))) W2^T
__global__ void __launch_bounds__(MF_THREADS, 1)
mlp_fwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w1,
               const float* __restrict__ b1, const bf16* __restrict__ w2,
               float* __restrict__ part, int M, int HID) {
  using SM = MfSmem;
  extern __shared__ unsigned char mf_smem[];
  unsigned char* gen;
  const uint32_t sm = aligned_smem(mf_smem, &gen);
  const int tid = threadIdx.x, wg = tid >> 7, q = tid & 3;
  const int r0 = blockIdx.x * MF_ROWS;
  const int nc = HID / MF_HC, per = cdiv(nc, gridDim.y);
  const int cb = blockIdx.y * per, ce = min(nc, cb + per);

  auto load = [&](int cidx) {
    const uint32_t W = sm + SM::W + (cidx & 1) * 2 * MF_W;
    stage_block<64, D_MODEL, MF_THREADS>(W, w1, D_MODEL, cidx * MF_HC, HID,
                                         0, D_MODEL);
    stage_block<D_MODEL, 64, MF_THREADS>(W + MF_W, w2, HID, 0, D_MODEL,
                                         cidx * MF_HC, HID);
  };
#pragma unroll
  for (int t = 0; t < 2; ++t)
    stage_block<64, D_MODEL, MF_THREADS>(sm + SM::H + t * SA_TILE, h, D_MODEL,
                                         r0 + 64 * t, M, 0, D_MODEL);
  if (cb < ce) load(cb);
  cp_async_commit();

  float out[2][64];
  zero(out[0]);
  zero(out[1]);
  for (int cidx = cb; cidx < ce; ++cidx) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (cidx + 1 < ce) load(cidx + 1);
    cp_async_commit();
    const uint32_t W = sm + SM::W + (cidx & 1) * 2 * MF_W;
    float racc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D_MODEL / 16; ++kk)
      wgmma_ss_n64(racc, desc_k(sm + SM::H + wg * SA_TILE, kk * 16),
                   desc_k(W, kk * 16), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(racc);
    // r = ReLU(rb(rb(acc) + rb(b1))) in bf16 pairs, the next A operand
    uint32_t ra[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 8 * kk + 2 * i;   // racc index of the pair
        const int col = cidx * MF_HC + (j >> 2) * 8 + 2 * q;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(b1 + col));
        __nv_bfloat162 v = __hadd2(__floats2bfloat162_rn(racc[j], racc[j + 1]),
                                   __floats2bfloat162_rn(bb.x, bb.y));
        v = __hmax2(v, __float2bfloat162_rn(0.f));
        ra[kk][i] = *reinterpret_cast<uint32_t*>(&v);
      }
    const uint32_t W2t = W + MF_W;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_n128_k(out[0], ra[kk], desc_k(W2t, kk * 16));
      wgmma_rs_n128_k(out[1], ra[kk], desc_k(W2t + 128 * 128, kk * 16));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(out[0]);
    fence_regs(out[1]);
  }
  float* p = part + ((size_t)blockIdx.y * M + r0 + 64 * wg) * D_MODEL;
  const int rows_left = M - r0 - 64 * wg;
  store_f32<128>(out[0], p, D_MODEL, rows_left);
  store_f32<128>(out[1], p + 128, D_MODEL, rows_left);
}

// The tail's MLP backward in one pass over the hidden units: a block of
// two warpgroups owns 128 rows (h and the cotangent g stay in shared
// memory) and a third of the hidden units; per chunk of 64,
//   r = ReLU(rb(rb(h W1c^T) + rb(b1c))), dm1 = rb(g W2c) where r > 0,
// both stored (the weight gradients' operands), and dh += dm1 W1c with
// dm1 as the A operand in registers. The three f32 partials of dh are
// added (in order) by the LN3 backward. W2 chunks are double-buffered,
// the W1 chunk (read by two products) is single.
struct MbSmem {
  static constexpr int H = 0;
  static constexpr int G = H + 2 * SA_TILE;
  static constexpr int W1 = G + 2 * SA_TILE;
  static constexpr int W2 = W1 + MF_W;
  static constexpr int B1 = W2 + 2 * MF_W;   // the chunk's b1, f32
  static constexpr int BYTES = B1 + MF_HC * 4 + 1024;
};

__global__ void __launch_bounds__(MF_THREADS, 1)
mlp_bwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ g,
               const bf16* __restrict__ w1, const float* __restrict__ b1,
               const bf16* __restrict__ w2, bf16* __restrict__ r,
               bf16* __restrict__ dm1, float* __restrict__ dh_part, int M,
               int HID) {
  using SM = MbSmem;
  extern __shared__ unsigned char mb_smem[];
  unsigned char* gen;
  const uint32_t sm = aligned_smem(mb_smem, &gen);
  const int tid = threadIdx.x, wg = tid >> 7, wi = (tid >> 5) & 3;
  const int gq = (tid & 31) >> 2, q = tid & 3;
  const int r0 = blockIdx.x * MF_ROWS;
  const int nc = HID / MF_HC, per = cdiv(nc, gridDim.y);
  const int cb = blockIdx.y * per, ce = min(nc, cb + per);

  auto load_w1 = [&](int cidx) {           // with the chunk's b1
    stage_block<64, D_MODEL, MF_THREADS>(sm + SM::W1, w1, D_MODEL,
                                         cidx * MF_HC, HID, 0, D_MODEL);
    if (tid < MF_HC / 4)
      cp_async16(sm + SM::B1 + 16 * tid, b1 + cidx * MF_HC + 4 * tid, true);
  };
  const float* b1s = reinterpret_cast<const float*>(gen + SM::B1);
  auto load_w2 = [&](int cidx) {
    stage_block<D_MODEL, 64, MF_THREADS>(sm + SM::W2 + (cidx & 1) * MF_W, w2,
                                         HID, 0, D_MODEL, cidx * MF_HC, HID);
  };
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    stage_block<64, D_MODEL, MF_THREADS>(sm + SM::H + t * SA_TILE, h, D_MODEL,
                                         r0 + 64 * t, M, 0, D_MODEL);
    stage_block<64, D_MODEL, MF_THREADS>(sm + SM::G + t * SA_TILE, g, D_MODEL,
                                         r0 + 64 * t, M, 0, D_MODEL);
  }
  if (cb < ce) {
    load_w1(cb);
    load_w2(cb);
  }
  cp_async_commit();

  float dh[2][64];
  zero(dh[0]);
  zero(dh[1]);
  for (int cidx = cb; cidx < ce; ++cidx) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();                   // W1c, W2c (and h, g) landed
    if (cidx + 1 < ce) load_w2(cidx + 1);
    cp_async_commit();
    const uint32_t W2c = sm + SM::W2 + (cidx & 1) * MF_W;
    float racc[32], gacc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D_MODEL / 16; ++kk)
      wgmma_ss_n64(racc, desc_k(sm + SM::H + wg * SA_TILE, kk * 16),
                   desc_k(sm + SM::W1, kk * 16), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D_MODEL / 16; ++kk)   // g W2c: W2c read as [out][hid]
      wgmma_ss_n64_bmn(gacc, desc_k(sm + SM::G + wg * SA_TILE, kk * 16),
                       desc_mn(W2c, kk * 16, 0), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(racc);
    fence_regs(gacc);
    __syncthreads();                   // both warpgroups are done with W2c
    // r and dm1 in bf16 pairs; dm1 is the next A operand
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 8 * kk + 2 * i;   // accumulator index of the pair
        const int cc = (j >> 2) * 8 + 2 * q;
        const float2 bb = *reinterpret_cast<const float2*>(b1s + cc);
        __nv_bfloat162 rv = __hadd2(
            __floats2bfloat162_rn(racc[j], racc[j + 1]),
            __floats2bfloat162_rn(bb.x, bb.y));
        rv = __hmax2(rv, __float2bfloat162_rn(0.f));
        const float2 rf = __bfloat1622float2(rv);
        __nv_bfloat162 dv = __floats2bfloat162_rn(gacc[j], gacc[j + 1]);
        const float2 df = __bfloat1622float2(dv);
        dv = __floats2bfloat162_rn(rf.x > 0.f ? df.x : 0.f,
                                   rf.y > 0.f ? df.y : 0.f);
        da[kk][i] = *reinterpret_cast<uint32_t*>(&dv);
        // staged in W2c (free after g W2c): tile rows of 128 bytes, 16-byte
        // chunk j of row rl at chunk j ^ (rl % 8)
        const int rl = wg * 64 + wi * 16 + gq + 8 * ((j >> 1) & 1);
        const int off = rl * 128 + ((((cc >> 3) ^ rl) & 7) << 4) + (cc & 7) * 2;
        *reinterpret_cast<__nv_bfloat162*>(gen + (W2c - sm) + off) = rv;
        *reinterpret_cast<__nv_bfloat162*>(gen + (W2c - sm) + MF_W / 2 + off) =
            dv;
      }
    // dh += dm1 W1c: W1c read as [hid][in], MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<128>(dh[0], da[kk], desc_mn(sm + SM::W1, kk * 16, 0));
      wgmma_rs<128>(dh[1], da[kk], desc_mn(sm + SM::W1, kk * 16, 128));
    }
    wgmma_commit();
    __syncthreads();                   // the r and dm1 tiles are staged
    // r and dm1 out in whole 128-byte row segments (16 bytes a thread)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = tid + MF_THREADS * i, which = e >> 10, rl = (e >> 3) & 127;
      const int j = e & 7, row = r0 + rl;
      const uint4 v = *reinterpret_cast<const uint4*>(
          gen + (W2c - sm) + which * (MF_W / 2) + rl * 128 + (((j ^ rl) & 7) << 4));
      if (row < M)
        *reinterpret_cast<uint4*>((which ? dm1 : r) + (size_t)row * HID +
                                  cidx * MF_HC + 8 * j) = v;
    }
    wgmma_wait<0>();
    fence_regs(dh[0]);
    fence_regs(dh[1]);
    __syncthreads();                   // both warpgroups are done with W1c
                                       // and the staged tiles
    if (cidx + 1 < ce) load_w1(cidx + 1);
    cp_async_commit();
  }
  float* p = dh_part + ((size_t)blockIdx.y * M + r0 + 64 * wg) * D_MODEL;
  const int rows_left = M - r0 - 64 * wg;
  store_f32<128>(dh[0], p, D_MODEL, rows_left);
  store_f32<128>(dh[1], p + 128, D_MODEL, rows_left);
}

// out = rb(rb(rb(sum of the partials) + rb(b2)) + z), 4 columns a thread
__global__ void mlp_finish_kernel(const float* __restrict__ part, int S,
                                  const float* __restrict__ b2,
                                  const bf16* __restrict__ z,
                                  bf16* __restrict__ out, long n) {
  for (long i = 4 * (blockIdx.x * (long)blockDim.x + threadIdx.x); i < n;
       i += 4 * (long)gridDim.x * blockDim.x) {
    float4 a = __ldg(reinterpret_cast<const float4*>(part + i));
    for (int s = 1; s < S; ++s) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(part + s * n + i));
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
    const float4 bb = __ldg(reinterpret_cast<const float4*>(b2 + i % D_MODEL));
    const uint2 zz = __ldg(reinterpret_cast<const uint2*>(z + i));
    const __nv_bfloat162 y0 = __hadd2(
        __hadd2(__floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(bb.x, bb.y)),
        *reinterpret_cast<const __nv_bfloat162*>(&zz.x));
    const __nv_bfloat162 y1 = __hadd2(
        __hadd2(__floats2bfloat162_rn(a.z, a.w), __floats2bfloat162_rn(bb.z, bb.w)),
        *reinterpret_cast<const __nv_bfloat162*>(&zz.y));
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&y0);
    u.y = *reinterpret_cast<const uint32_t*>(&y1);
    *reinterpret_cast<uint2*>(out + i) = u;
  }
}


// y [N, L, 256], a [N, L, kv] bf16 (kv % 64 == 0, <= 256); leaves and
// bf16_mask as memattn_self_fwd's; packed: memattn_tail_pack_bytes()
extern "C" int memattn_tail_fwd(const void* y_, const void* a_,
                                const void* const* leaves, int bf16_mask,
                                void* packed, void* out, void* ws, int N,
                                int L, int KV, int HID, void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  Arena ar{static_cast<char*>(ws), 0};
  TailBufs b = carve_tail(ar, N, L, KV, HID, false);
  const int M = N * L;
  long n[T_LEAVES];
  tail_sizes(KV, HID, n);
  pack_launch(leaves, bf16_mask, n, T_MAT, T_LEAVES,
              static_cast<unsigned char*>(packed), st);
  const TailW W = tail_w(packed, KV, HID);
  int err = row_chain(front_chain(static_cast<const bf16*>(y_),
                                  static_cast<const bf16*>(a_), W, nullptr,
                                  b.z, b.h, KV, M),
                      st);
  if (err) return err;
  if ((err = set_smem(mlp_fwd_kernel, MfSmem::BYTES))) return err;
  mlp_fwd_kernel<<<dim3(cdiv(M, MF_ROWS), MF_SPLITS), MF_THREADS,
                   MfSmem::BYTES, st>>>(b.h, W.w1, W.b1, W.w2, b.part, M,
                                        HID);
  const long nout = (long)M * D_MODEL;
  const int blocks = cdiv(nout, 1024) < 2048 ? cdiv(nout, 1024) : 2048;
  mlp_finish_kernel<<<blocks, 256, 0, st>>>(b.part, MF_SPLITS, W.b2, b.z,
                                            static_cast<bf16*>(out), nout);
  return (int)cudaGetLastError();
}

// dy (bf16 [N, L, 256]), da (bf16 [N, L, kv]), grads f32 in the leaves'
// order (memattn_tail_grad_floats)
extern "C" int memattn_tail_bwd(const void* y_, const void* a_,
                                const void* packed, const void* g_, void* dy,
                                void* da, void* grads, void* ws, int N, int L,
                                int KV, int HID, void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  Arena ar{static_cast<char*>(ws), 0};
  TailBufs b = carve_tail(ar, N, L, KV, HID, true);
  const TailW W = tail_w(packed, KV, HID);
  const bf16* a = static_cast<const bf16*>(a_);
  const bf16* g = static_cast<const bf16*>(g_);
  const int M = N * L, D = D_MODEL;

  // ---- recompute t, z, h
  int err = row_chain(front_chain(static_cast<const bf16*>(y_), a, W, b.t,
                                  b.z, b.h, KV, M),
                      st);
  if (err) return err;

  // ---- MLP backward: r, dm1 (stored) and dh's partials in one pass
  if ((err = set_smem(mlp_bwd_kernel, MbSmem::BYTES))) return err;
  mlp_bwd_kernel<<<dim3(cdiv(M, MF_ROWS), MF_SPLITS), MF_THREADS,
                   MbSmem::BYTES, st>>>(b.h, g, W.w1, W.b1, W.w2, b.r, b.dm1,
                                        b.dh, M, HID);
  // dW1 = dm1^T h (+ db1), dW2 = g^T r (+ db2)
  GemmGroup G{};
  G.n = 2;
  G.op[0] = wgrad_op(b.dm1, HID, b.h, D, HID, D, M, b.pw1, b.c1);
  G.op[1] = wgrad_op(g, D, b.r, HID, D, HID, M, b.pw2, b.c2);
  if ((err = gemm_group(G, st))) return err;

  // ---- LN3 backward + residual: dy = bf16(g + LN3'(dh)); dln3w, dln3b,
  // dbo (sum of dz in f32) partials
  bf16* dyb = static_cast<bf16*>(dy);
  ln_bwd_part(b.z, W.ln3w, b.dh, MF_SPLITS, nullptr, g, nullptr, dyb, b.ln3p,
              M, st);

  // ---- out-proj: dWo = dy^T t, dt = dy Wo
  G = GemmGroup{};
  G.n = 2;
  G.op[0] = wgrad_op(dyb, D, b.t, D, D, D, M, b.pwo, nullptr);
  G.op[1] = gemm_op(dyb, D, 0, W.wo, D, 1, M, D, D);
  G.op[1].out = b.dt;
  if ((err = gemm_group(G, st))) return err;
  // ---- v-proj: dWv = dt^T a (+ dbv), da = dt Wv
  G = GemmGroup{};
  G.n = 2;
  G.op[0] = wgrad_op(b.dt, D, a, KV, D, KV, M, b.pwv, b.cv);
  G.op[1] = gemm_op(b.dt, D, 0, W.wv, KV, 1, M, KV, D);
  G.op[1].out = static_cast<bf16*>(da);
  if ((err = gemm_group(G, st))) return err;

  // ---- every partial, added in order (the leaves' order)
  const int P = ln_blocks(M);
  RedPlan R{};
  reduce_add(R, b.pwv, (long)D * KV, b.sv, (long)D * KV);     // wv
  reduce_add(R, b.cv, D, b.sv, D);                            // bv
  reduce_add(R, b.pwo, (long)D * D, b.so, (long)D * D);       // wo
  reduce_add(R, b.ln3p + 2 * D, LB_PART, P, D);               // bo
  reduce_add(R, b.ln3p, LB_PART, P, D);                       // ln3w
  reduce_add(R, b.ln3p + D, LB_PART, P, D);                   // ln3b
  reduce_add(R, b.pw1, (long)HID * D, b.s1, (long)HID * D);   // w1
  reduce_add(R, b.c1, HID, b.s1, HID);                        // b1
  reduce_add(R, b.pw2, (long)D * HID, b.s2, (long)D * HID);   // w2
  reduce_add(R, b.c2, D, b.s2, D);                            // b2
  reduce_launch(R, static_cast<float*>(grads), st);
  return (int)cudaGetLastError();
}
