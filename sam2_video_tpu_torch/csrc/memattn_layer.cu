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
// What bounds them on an H100 (N = 8 objects, L = 576 tokens, d = 256):
// the self block needs ~3.6 GFLOP of bf16 products forward (five 256-wide
// projections and the two L x L attention products) on ~2.4 MB of inputs,
// outputs and weights; the tail ~11 GFLOP (the 256 -> 2048 -> 256 MLP) on
// ~5 MB. Both are bounded by the tensor cores (a few microseconds at 989
// TFLOP/s). Every product here runs on the tensor cores through one
// batched mma.sync GEMM (m16n8k16, f32 accumulate) whose tile loaders take
// either operand in row or column order, so no transpose is ever written,
// and whose epilogue fuses scale, bias, ReLU, the ReLU mask of the
// backward, the residual, and a bf16 and/or f32 store.
//
// The TPU kernel holds the L x L f32 scores in VMEM. Here the scores, the
// probabilities and their gradients live in device memory ([N, L, L] f32,
// 10.6 MB at N = 8, L = 576), written and read by query-tiled GEMMs and an
// exact two-pass row softmax (max, then sum, then p = e / sum in f32 and
// one bf16 rounding), so no block ever holds a score row in shared memory.
//
// The TPU grid runs in order, so its backward sums every weight gradient
// over the objects into one VMEM-resident block. Blocks here run in
// parallel: each weight gradient is written per object as an f32 partial
// (a batched GEMM over that object's rows, or a column sum), and one more
// pass adds the partials in a fixed order. No float atomics: the result is
// the same from run to run.
//
// The GEMMs take rows in multiples of 32 per object. Any other token count L
// reaches them padded (ops/memattn_layer_kernel.py) to the next multiple of
// 32: the self block masks the pad keys in its softmax, the pad rows'
// outputs are dropped and their cotangents are zero, so nothing of the pad
// reaches an output or a gradient (the tail's rows are independent).
//
// The C entry points launch their kernels in order on the caller's stream,
// carve their scratch from one workspace the caller allocates (its size
// from *_workspace_bytes) and return cudaGetLastError().

#include "common.cuh"

// ---------------------------------------------------------------------------
// Row kernels
// ---------------------------------------------------------------------------

// RoPE in the de-interleaved layout over rows of x (row stride ldx; the
// row's position is row % L), D columns from column 0 of the row:
//   forward:   y1 = x1 c - x2 s,  y2 = x2 c + x1 s
//   transpose: y1 = x1 c + x2 s,  y2 = x2 c - x1 s
// in the compute dtype, as the JAX kernels' walk: (c, s) = the f32 tables
// [L, D] rounded to bf16, each product and the sum rounded. In place
// allowed.
__global__ void rope_kernel(const bf16* x, int ldx, bf16* y, int ldy,
                            const float* __restrict__ cosv,
                            const float* __restrict__ sinv, int rows, int L,
                            int D, int transpose) {
  const int half = D / 2;
  const size_t total = (size_t)rows * half;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int j = e % half;
    const size_t r = e / half;
    const int pos = r % L;
    const float c = to_f32(to_bf16(cosv[(size_t)pos * D + j]));
    const float s = to_f32(to_bf16(sinv[(size_t)pos * D + j]));
    const float x1 = to_f32(x[r * ldx + j]), x2 = to_f32(x[r * ldx + j + half]);
    const float y1 = transpose ? rb(x1 * c) + rb(x2 * s)
                               : rb(x1 * c) - rb(x2 * s);
    const float y2 = transpose ? rb(x2 * c) - rb(x1 * s)
                               : rb(x2 * c) + rb(x1 * s);
    y[r * ldy + j] = to_bf16(y1);
    y[r * ldy + j + half] = to_bf16(y2);
  }
}

static void rope(const bf16* x, int ldx, bf16* y, int ldy, const float* cosv,
                 const float* sinv, int rows, int L, int D, int transpose,
                 cudaStream_t stream) {
  const size_t total = (size_t)rows * (D / 2);
  const int blocks = (int)((total + 255) / 256 < 8192 ? (total + 255) / 256
                                                       : 8192);
  rope_kernel<<<blocks, 256, 0, stream>>>(x, ldx, y, ldy, cosv, sinv, rows, L,
                                          D, transpose);
}

constexpr int ROW_THREADS = 256;

__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffff, v, o);
    v = is_max ? fmaxf(v, u) : v + u;
  }
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < ROW_THREADS / 32; ++w)
    r = is_max ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// exact row softmax of f32 scores over the first nv of n columns: p =
// exp(s - max) / sum, 0 at and past nv (pad keys), stored as f32 (p32,
// optional) and bf16 (pb). One block per row.
__global__ void __launch_bounds__(ROW_THREADS)
softmax_rows_kernel(const float* __restrict__ s, float* p32, bf16* pb, int n,
                    int nv) {
  __shared__ float red[ROW_THREADS / 32];
  const size_t row = blockIdx.x;
  const float* sr = s + row * n;
  float m = -INFINITY;
  for (int i = threadIdx.x; i < nv; i += ROW_THREADS) m = fmaxf(m, sr[i]);
  m = block_reduce(m, red, true);
  float t = 0.f;
  for (int i = threadIdx.x; i < nv; i += ROW_THREADS) t += expf(sr[i] - m);
  t = block_reduce(t, red, false);
  for (int i = threadIdx.x; i < n; i += ROW_THREADS) {
    const float p = i < nv ? expf(sr[i] - m) / t : 0.f;
    if (p32) p32[row * n + i] = p;
    pb[row * n + i] = to_bf16(p);
  }
}

// softmax backward: ds = bf16(p * (dp - sum(dp * p)) * scale), per row
__global__ void __launch_bounds__(ROW_THREADS)
softmax_bwd_rows_kernel(const float* __restrict__ p, const float* __restrict__ dp,
                        bf16* ds, int n, float scale) {
  __shared__ float red[ROW_THREADS / 32];
  const size_t row = blockIdx.x;
  const float* pr = p + row * n;
  const float* dr = dp + row * n;
  float t = 0.f;
  for (int i = threadIdx.x; i < n; i += ROW_THREADS) t += dr[i] * pr[i];
  t = block_reduce(t, red, false);
  for (int i = threadIdx.x; i < n; i += ROW_THREADS)
    ds[row * n + i] = to_bf16(pr[i] * (dr[i] - t) * scale);
}

constexpr int D_MODEL = 256;
constexpr float LN_EPS = 1e-5f;

// weight table of the self block (bf16 products in [out, in] layout, f32
// vectors): ln1w ln1b wqkv[768, 256] bqkv[768] wo bo ln2w ln2b wqc bqc
enum { S_LN1W, S_LN1B, S_WQKV, S_BQKV, S_WO, S_BO, S_LN2W, S_LN2B, S_WQC,
       S_BQC, S_NUM };
// f32 gradient layout of the self block (the partials use it per object)
constexpr long SG_LN1W = 0, SG_LN1B = 256, SG_WQKV = 512,
               SG_BQKV = SG_WQKV + 768 * 256, SG_WO = SG_BQKV + 768,
               SG_BO = SG_WO + 256 * 256, SG_LN2W = SG_BO + 256,
               SG_LN2B = SG_LN2W + 256, SG_WQC = SG_LN2B + 256,
               SG_BQC = SG_WQC + 256 * 256, SG_TOTAL = SG_BQC + 256;

struct SelfBufs {
  bf16 *xn, *qkv, *o, *y2, *pb, *dqc, *doutc, *dob, *dqkv, *dsb;
  float *s, *p32, *dp, *dy32, *dout32, *dxn32, *part;
  float2 *st1, *st2;
};

static SelfBufs carve_self(Arena& ar, int N, int L, bool bwd) {
  const size_t NL = (size_t)N * L, LL = (size_t)N * L * L;
  SelfBufs b{};
  b.xn = ar.take<bf16>(NL * D_MODEL);
  b.qkv = ar.take<bf16>(NL * 3 * D_MODEL);
  b.o = ar.take<bf16>(NL * D_MODEL);
  b.s = ar.take<float>(LL);
  b.pb = ar.take<bf16>(LL);
  if (!bwd) return b;
  b.y2 = ar.take<bf16>(NL * D_MODEL);
  b.p32 = ar.take<float>(LL);
  b.dp = ar.take<float>(LL);
  b.dsb = ar.take<bf16>(LL);
  b.dqc = ar.take<bf16>(NL * D_MODEL);
  b.doutc = ar.take<bf16>(NL * D_MODEL);
  b.dob = ar.take<bf16>(NL * D_MODEL);
  b.dqkv = ar.take<bf16>(NL * 3 * D_MODEL);
  b.dy32 = ar.take<float>(NL * D_MODEL);
  b.dout32 = ar.take<float>(NL * D_MODEL);
  b.dxn32 = ar.take<float>(NL * D_MODEL);
  b.st1 = ar.take<float2>(NL);
  b.st2 = ar.take<float2>(NL);
  b.part = ar.take<float>((size_t)N * SG_TOTAL);
  return b;
}

extern "C" long memattn_self_workspace_bytes(int N, int L, int bwd) {
  Arena ar{nullptr, 0};
  carve_self(ar, N, L, bwd != 0);
  return (long)ar.off;
}

// forward recompute shared by both passes: xn, roped q/k and v in qkv,
// probabilities (pb bf16; p32 when given) over the first Lv keys of each
// object's L tokens, o, out = x + o Wo^T + bo
static void self_forward_core(const bf16* x, const void* const* w,
                              const float* cosv, const float* sinv,
                              bf16* out, SelfBufs& b, float* p32, int N,
                              int L, int Lv, cudaStream_t st) {
  auto W = [&](int i) { return static_cast<const bf16*>(w[i]); };
  auto F = [&](int i) { return static_cast<const float*>(w[i]); };
  const int NL = N * L, D = D_MODEL, D3 = 3 * D_MODEL;
  const long LL = (long)L * L;
  const float scale = 1.0f / sqrtf((float)D);

  layer_norm<bf16>(x, b.xn, F(S_LN1W), F(S_LN1B), NL, D, 1, LN_EPS, 0, st);
  BEpi e = bepi(D3);
  e.bias = F(S_BQKV);
  e.out = b.qkv;
  bgemm<false, false>(b.xn, D, 0, W(S_WQKV), D, 0, NL, D3, D, 1, e, st);
  rope(b.qkv, D3, b.qkv, D3, cosv, sinv, NL, L, D, 0, st);          // q
  rope(b.qkv + D, D3, b.qkv + D, D3, cosv, sinv, NL, L, D, 0, st);  // k
  // scores S = q k^T * scale, per object
  e = bepi(L, LL);
  e.alpha = scale;
  e.out32 = b.s;
  bgemm<false, false>(b.qkv, D3, (long)L * D3, b.qkv + D, D3, (long)L * D3,
                      L, L, D, N, e, st);
  softmax_rows_kernel<<<NL, ROW_THREADS, 0, st>>>(b.s, p32, b.pb, L, Lv);
  // o = P v (v read column-wise: B(n = d, k = key) = v[key][d])
  e = bepi(D, (long)L * D);
  e.out = b.o;
  bgemm<false, true>(b.pb, L, LL, b.qkv + 2 * D, D3, (long)L * D3, L, D, L,
                     N, e, st);
  e = bepi(D);
  e.bias = F(S_BO);
  e.res = x;
  e.out = out;
  bgemm<false, false>(b.o, D, 0, W(S_WO), D, 0, NL, D, D, 1, e, st);
}

// x [N, L, 256] bf16 with L % 32 == 0, of which the first Lv tokens of
// each object are real: the rest are pad keys, masked in the softmax (the
// caller pads, drops the pad rows' outputs and gives them zero cotangents,
// so they add nothing to any gradient)
extern "C" int memattn_self_fwd(const void* x, const void* const* w,
                                const void* cosv, const void* sinv, void* out,
                                void* q3, void* ws, int N, int L, int Lv,
                                void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  Arena ar{static_cast<char*>(ws), 0};
  SelfBufs b = carve_self(ar, N, L, false);
  const float* cs = static_cast<const float*>(cosv);
  const float* sn = static_cast<const float*>(sinv);
  const int NL = N * L, D = D_MODEL;
  bf16* o = static_cast<bf16*>(out);
  self_forward_core(static_cast<const bf16*>(x), w, cs, sn, o, b, nullptr, N,
                    L, Lv, st);
  // q3 = rope(LN2(out) Wqc^T + bqc); xn is free again and holds LN2(out)
  layer_norm<bf16>(o, b.xn, static_cast<const float*>(w[S_LN2W]),
                   static_cast<const float*>(w[S_LN2B]), NL, D, 1, LN_EPS, 0,
                   st);
  BEpi e = bepi(D);
  e.bias = static_cast<const float*>(w[S_BQC]);
  e.out = static_cast<bf16*>(q3);
  bgemm<false, false>(b.xn, D, 0, static_cast<const bf16*>(w[S_WQC]), D, 0,
                      NL, D, D, 1, e, st);
  rope(static_cast<bf16*>(q3), D, static_cast<bf16*>(q3), D, cs, sn, NL, L, D,
       0, st);
  return (int)cudaGetLastError();
}

// grads: f32 [SG_TOTAL] in the SG_* layout; dx bf16 [N, L, 256]
extern "C" int memattn_self_bwd(const void* x_, const void* const* w,
                                const void* cosv, const void* sinv,
                                const void* dout_, const void* dq3_, void* dx,
                                void* grads, void* ws, int N, int L, int Lv,
                                void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  Arena ar{static_cast<char*>(ws), 0};
  SelfBufs b = carve_self(ar, N, L, true);
  auto W = [&](int i) { return static_cast<const bf16*>(w[i]); };
  auto F = [&](int i) { return static_cast<const float*>(w[i]); };
  const bf16* x = static_cast<const bf16*>(x_);
  const bf16* dout = static_cast<const bf16*>(dout_);
  const bf16* dq3 = static_cast<const bf16*>(dq3_);
  const float* cs = static_cast<const float*>(cosv);
  const float* sn = static_cast<const float*>(sinv);
  const int NL = N * L, D = D_MODEL, D3 = 3 * D_MODEL;
  const long LL = (long)L * L, LD = (long)L * D, LD3 = (long)L * D3;
  const float scale = 1.0f / sqrtf((float)D);
  float* P = b.part;

  // ---- forward recompute (out lands in doutc's buffer until LN2 is done)
  bf16* out = b.dob;
  self_forward_core(x, w, cs, sn, out, b, b.p32, N, L, Lv, st);
  layer_norm<bf16>(out, b.y2, F(S_LN2W), F(S_LN2B), NL, D, 1, LN_EPS, 0, st);

  // ---- q3 = rope(qc_proj(LN2(out))) backward
  rope(dq3, D, b.dqc, D, cs, sn, NL, L, D, 1, st);
  BEpi e = bepi(D, SG_TOTAL);
  e.out32 = P + SG_WQC;            // dWqc[o][i] = sum_l dqc[l][o] y2[l][i]
  bgemm<true, true>(b.dqc, D, LD, b.y2, D, LD, D, D, L, N, e, st);
  colsum(nullptr, b.dqc, D, nullptr, nullptr, L, NL, D, P + SG_BQC, SG_TOTAL,
         st);
  e = bepi(D);
  e.out32 = b.dy32;                // dy2 = dqc Wqc
  bgemm<false, true>(b.dqc, D, 0, W(S_WQC), D, 0, NL, D, D, 1, e, st);
  ln_bwd(out, F(S_LN2W), b.dy32, nullptr, dout, b.dout32, b.doutc, b.st2, NL,
         D, LN_EPS, st);
  colsum(b.dy32, nullptr, D, out, b.st2, L, NL, D, P + SG_LN2W, SG_TOTAL, st);
  colsum(b.dy32, nullptr, D, nullptr, nullptr, L, NL, D, P + SG_LN2B,
         SG_TOTAL, st);

  // ---- out-proj backward
  colsum(b.dout32, nullptr, D, nullptr, nullptr, L, NL, D, P + SG_BO,
         SG_TOTAL, st);
  e = bepi(D, SG_TOTAL);
  e.out32 = P + SG_WO;             // dWo = doutc^T o
  bgemm<true, true>(b.doutc, D, LD, b.o, D, LD, D, D, L, N, e, st);
  e = bepi(D);
  e.out = b.dob;                   // do = doutc Wo (out is no longer needed)
  bgemm<false, true>(b.doutc, D, 0, W(S_WO), D, 0, NL, D, D, 1, e, st);

  // ---- attention backward, per object
  e = bepi(D3, LD3);
  e.out = b.dqkv + 2 * D;          // dv = P^T do
  bgemm<true, true>(b.pb, L, LL, b.dob, D, LD, L, D, L, N, e, st);
  e = bepi(L, LL);
  e.out32 = b.dp;                  // dp = do v^T
  bgemm<false, false>(b.dob, D, LD, b.qkv + 2 * D, D3, LD3, L, L, D, N, e,
                      st);
  softmax_bwd_rows_kernel<<<NL, ROW_THREADS, 0, st>>>(b.p32, b.dp, b.dsb, L,
                                                      scale);
  e = bepi(D3, LD3);
  e.out = b.dqkv;                  // dq = ds k
  bgemm<false, true>(b.dsb, L, LL, b.qkv + D, D3, LD3, L, D, L, N, e, st);
  e = bepi(D3, LD3);
  e.out = b.dqkv + D;              // dk = ds^T q
  bgemm<true, true>(b.dsb, L, LL, b.qkv, D3, LD3, L, D, L, N, e, st);
  rope(b.dqkv, D3, b.dqkv, D3, cs, sn, NL, L, D, 1, st);
  rope(b.dqkv + D, D3, b.dqkv + D, D3, cs, sn, NL, L, D, 1, st);

  // ---- q/k/v projections backward (stacked [768] rows)
  e = bepi(D, SG_TOTAL);
  e.out32 = P + SG_WQKV;           // dWqkv = dqkv^T xn
  bgemm<true, true>(b.dqkv, D3, LD3, b.xn, D, LD, D3, D, L, N, e, st);
  colsum(nullptr, b.dqkv, D3, nullptr, nullptr, L, NL, D3, P + SG_BQKV,
         SG_TOTAL, st);
  e = bepi(D);
  e.out32 = b.dxn32;               // dxn = dqkv Wqkv
  bgemm<false, true>(b.dqkv, D3, 0, W(S_WQKV), D, 0, NL, D, D3, 1, e, st);
  ln_bwd(x, F(S_LN1W), b.dxn32, b.dout32, nullptr, nullptr,
         static_cast<bf16*>(dx), b.st1, NL, D, LN_EPS, st);
  colsum(b.dxn32, nullptr, D, x, b.st1, L, NL, D, P + SG_LN1W, SG_TOTAL, st);
  colsum(b.dxn32, nullptr, D, nullptr, nullptr, L, NL, D, P + SG_LN1B,
         SG_TOTAL, st);

  // ---- the objects' partials, added in order
  reduce_cols(P, N, SG_TOTAL, static_cast<float*>(grads), st);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tail block
// ---------------------------------------------------------------------------

// weights: wv[256, kv] bv wo bo ln3w ln3b w1[hid, 256] b1 w2[256, hid] b2
enum { T_WV, T_BV, T_WO, T_BO, T_LN3W, T_LN3B, T_W1, T_B1, T_W2, T_B2,
       T_NUM };

struct TailLayout {
  long wv, bv, wo, bo, ln3w, ln3b, w1, b1, w2, b2, total;
};

static TailLayout tail_layout(int KV, int HID) {
  TailLayout t;
  t.wv = 0;
  t.bv = t.wv + (long)D_MODEL * KV;
  t.wo = t.bv + D_MODEL;
  t.bo = t.wo + (long)D_MODEL * D_MODEL;
  t.ln3w = t.bo + D_MODEL;
  t.ln3b = t.ln3w + D_MODEL;
  t.w1 = t.ln3b + D_MODEL;
  t.b1 = t.w1 + (long)HID * D_MODEL;
  t.w2 = t.b1 + HID;
  t.b2 = t.w2 + (long)D_MODEL * HID;
  t.total = t.b2 + D_MODEL;
  return t;
}

extern "C" long memattn_tail_grad_floats(int KV, int HID) {
  return tail_layout(KV, HID).total;
}

struct TailBufs {
  bf16 *t, *z, *h, *r, *dm1, *dzc, *dt;
  float *dm1_32, *dh32, *dz32, *part;
  float2* st3;
};

static TailBufs carve_tail(Arena& ar, int N, int L, int KV, int HID,
                           bool bwd) {
  const size_t NL = (size_t)N * L;
  TailBufs b{};
  b.t = ar.take<bf16>(NL * D_MODEL);
  b.z = ar.take<bf16>(NL * D_MODEL);
  b.h = ar.take<bf16>(NL * D_MODEL);
  b.r = ar.take<bf16>(NL * HID);
  if (!bwd) return b;
  b.dm1 = ar.take<bf16>(NL * HID);
  b.dm1_32 = ar.take<float>(NL * HID);
  b.dh32 = ar.take<float>(NL * D_MODEL);
  b.dz32 = ar.take<float>(NL * D_MODEL);
  b.dt = ar.take<bf16>(NL * D_MODEL);
  b.st3 = ar.take<float2>(NL);
  b.part = ar.take<float>((size_t)N * tail_layout(KV, HID).total);
  return b;
}

extern "C" long memattn_tail_workspace_bytes(int N, int L, int KV, int HID,
                                             int bwd) {
  Arena ar{nullptr, 0};
  carve_tail(ar, N, L, KV, HID, bwd != 0);
  return (long)ar.off;
}

// t, z, h, r of the tail's forward; out = z + r W2^T + b2 when out != null
static void tail_forward_core(const bf16* y, const bf16* a,
                              const void* const* w, bf16* out, TailBufs& b,
                              int NL, int KV, int HID, cudaStream_t st) {
  auto W = [&](int i) { return static_cast<const bf16*>(w[i]); };
  auto F = [&](int i) { return static_cast<const float*>(w[i]); };
  const int D = D_MODEL;
  BEpi e = bepi(D);
  e.bias = F(T_BV);
  e.out = b.t;
  bgemm<false, false>(a, KV, 0, W(T_WV), KV, 0, NL, D, KV, 1, e, st);
  e = bepi(D);
  e.bias = F(T_BO);
  e.res = y;
  e.out = b.z;
  bgemm<false, false>(b.t, D, 0, W(T_WO), D, 0, NL, D, D, 1, e, st);
  layer_norm<bf16>(b.z, b.h, F(T_LN3W), F(T_LN3B), NL, D, 1, LN_EPS, 0, st);
  e = bepi(HID);
  e.bias = F(T_B1);
  e.relu = 1;
  e.out = b.r;
  bgemm<false, false>(b.h, D, 0, W(T_W1), D, 0, NL, HID, D, 1, e, st);
  if (!out) return;
  e = bepi(D);
  e.bias = F(T_B2);
  e.res = b.z;
  e.out = out;
  bgemm<false, false>(b.r, HID, 0, W(T_W2), HID, 0, NL, D, HID, 1, e, st);
}

extern "C" int memattn_tail_fwd(const void* y, const void* a,
                                const void* const* w, void* out, void* ws,
                                int N, int L, int KV, int HID,
                                void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  Arena ar{static_cast<char*>(ws), 0};
  TailBufs b = carve_tail(ar, N, L, KV, HID, false);
  tail_forward_core(static_cast<const bf16*>(y), static_cast<const bf16*>(a),
                    w, static_cast<bf16*>(out), b, N * L, KV, HID, st);
  return (int)cudaGetLastError();
}

// dy (bf16 [N, L, 256]), da (bf16 [N, L, kv]), grads f32 in tail_layout
extern "C" int memattn_tail_bwd(const void* y_, const void* a_,
                                const void* const* w, const void* g_,
                                void* dy, void* da, void* grads, void* ws,
                                int N, int L, int KV, int HID,
                                void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  Arena ar{static_cast<char*>(ws), 0};
  TailBufs b = carve_tail(ar, N, L, KV, HID, true);
  const TailLayout G = tail_layout(KV, HID);
  auto W = [&](int i) { return static_cast<const bf16*>(w[i]); };
  auto F = [&](int i) { return static_cast<const float*>(w[i]); };
  const bf16* y = static_cast<const bf16*>(y_);
  const bf16* a = static_cast<const bf16*>(a_);
  const bf16* g = static_cast<const bf16*>(g_);
  const int NL = N * L, D = D_MODEL;
  const long LD = (long)L * D, LH = (long)L * HID, LK = (long)L * KV;
  float* P = b.part;

  tail_forward_core(y, a, w, nullptr, b, NL, KV, HID, st);

  // ---- MLP backward
  BEpi e = bepi(HID);
  e.mask = b.r;                    // dm1 = (g W2) where m1 > 0 (r > 0)
  e.out = b.dm1;
  e.out32 = b.dm1_32;
  bgemm<false, true>(g, D, 0, W(T_W2), HID, 0, NL, HID, D, 1, e, st);
  colsum(b.dm1_32, nullptr, HID, nullptr, nullptr, L, NL, HID, P + G.b1,
         G.total, st);
  e = bepi(D, G.total);
  e.out32 = P + G.w1;              // dW1 = dm1^T h
  bgemm<true, true>(b.dm1, HID, LH, b.h, D, LD, HID, D, L, N, e, st);
  e = bepi(HID, G.total);
  e.out32 = P + G.w2;              // dW2 = g^T r
  bgemm<true, true>(g, D, LD, b.r, HID, LH, D, HID, L, N, e, st);
  colsum(nullptr, g, D, nullptr, nullptr, L, NL, D, P + G.b2, G.total, st);
  e = bepi(D);
  e.out32 = b.dh32;                // dh = dm1 W1
  bgemm<false, true>(b.dm1, HID, 0, W(T_W1), D, 0, NL, D, HID, 1, e, st);

  // ---- LN3 backward + residual: dz = g + LN3'(dh)
  ln_bwd(b.z, F(T_LN3W), b.dh32, nullptr, g, b.dz32, static_cast<bf16*>(dy),
         b.st3, NL, D, LN_EPS, st);
  colsum(b.dh32, nullptr, D, b.z, b.st3, L, NL, D, P + G.ln3w, G.total, st);
  colsum(b.dh32, nullptr, D, nullptr, nullptr, L, NL, D, P + G.ln3b,
         G.total, st);
  const bf16* dzc = static_cast<const bf16*>(dy);   // dy = bf16(dz)

  // ---- out-proj and v-proj backward
  colsum(b.dz32, nullptr, D, nullptr, nullptr, L, NL, D, P + G.bo, G.total,
         st);
  e = bepi(D, G.total);
  e.out32 = P + G.wo;              // dWo = dz^T t
  bgemm<true, true>(dzc, D, LD, b.t, D, LD, D, D, L, N, e, st);
  e = bepi(D);
  e.out = b.dt;                    // dt = dz Wo
  bgemm<false, true>(dzc, D, 0, W(T_WO), D, 0, NL, D, D, 1, e, st);
  colsum(nullptr, b.dt, D, nullptr, nullptr, L, NL, D, P + G.bv, G.total, st);
  e = bepi(KV, G.total);
  e.out32 = P + G.wv;              // dWv = dt^T a
  bgemm<true, true>(b.dt, D, LD, a, KV, LK, D, KV, L, N, e, st);
  e = bepi(KV);
  e.out = static_cast<bf16*>(da);  // da = dt Wv
  bgemm<false, true>(b.dt, D, 0, W(T_WV), KV, 0, NL, KV, D, 1, e, st);

  reduce_cols(P, N, G.total, static_cast<float*>(grads), st);
  return (int)cudaGetLastError();
}
