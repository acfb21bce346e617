// The mask decoder's two-way transformer block for Hopper (sm_90a),
// hand-written CUDA C++, forward and backward.
//
// Replaces the TPU kernel sam2_video_tpu/ops/twoway_kernel.py
// fused_twoway_block (Pallas _twoway_fwd_kernel, _twoway_bwd1_kernel,
// _twoway_bwd2_kernel): for O objects, N tokens and HW image keys each,
//   A  self-attention over the tokens (the first block replaces them, no
//      residual), LN1;
//   B  token -> image attention (q = x1 + qpe, k = K0 + kpe, v = K0), LN2;
//   C  ReLU MLP 256 -> 2048 -> 256, LN3;
//   D  image -> token attention (q = K0 + kpe, k = x3 + qpe, v = x3), LN4,
// 8 heads (head dim 32 in A, 16 in B and D), LayerNorm eps 1e-5.
//
// What bounds it on an H100 (O = 8, N = 8, HW = 576): ~1.3 GFLOP of bf16
// products forward, most of them the four 256 x 128 projections over the
// 4608 image rows (B's k and v, D's q and out-projection), against ~6 MB
// of inputs, outputs and weights: a few microseconds either way. At these
// sizes launches, not products or bytes, set the time, so the block runs
// as a short fixed sequence of launches over all objects at once: every
// row-wise product is one batched mma.sync GEMM over the O*N token rows or
// the O*HW image rows (common.cuh bgemm, with the bf16-walk epilogue,
// ReLU and its mask, residuals and f32 stores), and each attention is one
// launch of a warp per (object, head, query row) over the object's own
// keys. Objects never see each other's keys, so the TPU's dense
// [O*N, O*HW] block-diagonal mask and its VMEM group sizing have no
// counterpart here.
//
// Attention: head dims 16 and 32 and 8-token sides are below one mma tile,
// so the scores are dot products on the CUDA cores in f32, an exact
// three-pass softmax (max, sum, then p = e / sum in f32, rounded to bf16
// before PV, as ops/attention.py sdpa does). The backward is a row pass (a
// warp per query: dp, D = sum p dp, ds = bf16(p (dp - D) scale), dq) that
// writes ds and bf16(p) to scratch, and a column pass (a warp per key: dk,
// dv). Any token count and any HW: no tile constraint on either side.
//
// The backward keeps the forward's activations (the forward's workspace,
// which the caller holds until the backward) instead of recomputing them
// as the TPU's B1 / B2 programs do: device memory is not scarce here, and
// one pass over the saved rows needs no recompute launches. Weight
// gradients are float32: over the token rows one GEMM (or column sum)
// each, whose sum runs in one fixed order; over the image rows f32
// partials per chunk of 256 rows, added in a fixed order by one last
// reduction. No float atomics anywhere: the same bits from run to run.
//
// Rounding points follow the TPU kernel: products rounded once to bf16,
// then the bias added in bf16 (_mm); the out-projection sums every head in
// one f32 accumulator before its single rounding; residual and pe adds in
// bf16; the backward rounds do, dq, dk, dv and ds to bf16 where _MHA.bwd
// does, and the ReLU mask reads the rounded pre-activation.
//
// The C entry points launch their kernels in order on the caller's stream,
// carve their scratch from one workspace the caller allocates (its size
// from twoway_workspace_bytes) and return cudaGetLastError().

#include "common.cuh"

constexpr int C_ = 256;          // transformer dim
constexpr int HEADS = 8;
constexpr int IS = 256;          // self-attention internal dim (head dim 32)
constexpr int IX = 128;          // cross-attention internal dim (head dim 16)
constexpr int HID = 2048;        // MLP hidden dim
constexpr float EPS = 1e-5f;
constexpr int CHUNK = 256;       // image rows per weight-gradient partial

// operand table (ops/twoway_kernel.py pack): bf16 products [out, in], f32
// vectors. TKQ stacks token->image k_proj over image->token q_proj: both
// read K0 + kpe.
enum {
  W_SQKV, B_SQKV, W_SO, B_SO, LN1W, LN1B,
  W_TQ, B_TQ, W_TKQ, B_TKQ, W_TV, B_TV, W_TO, B_TO, LN2W, LN2B,
  W_M1, B_M1, W_M2, B_M2, LN3W, LN3B,
  W_IK, B_IK, W_IV, B_IV, W_IO, B_IO, LN4W, LN4B, W_NUM
};

// f32 gradient layout: the token-row gradients, then the image-row ones
// (reduced from per-chunk partials laid out as this second part).
constexpr long G_SQKV = 0, G_SBQKV = G_SQKV + 3L * IS * C_,
               G_SO = G_SBQKV + 3 * IS, G_SBO = G_SO + (long)C_ * IS,
               G_LN1W = G_SBO + C_, G_LN1B = G_LN1W + C_,
               G_TQ = G_LN1B + C_, G_TBQ = G_TQ + (long)IX * C_,
               G_TO = G_TBQ + IX, G_TBO = G_TO + (long)C_ * IX,
               G_LN2W = G_TBO + C_, G_LN2B = G_LN2W + C_,
               G_M1 = G_LN2B + C_, G_MB1 = G_M1 + (long)HID * C_,
               G_M2 = G_MB1 + HID, G_MB2 = G_M2 + (long)C_ * HID,
               G_LN3W = G_MB2 + C_, G_LN3B = G_LN3W + C_,
               G_IK = G_LN3B + C_, G_IBK = G_IK + (long)IX * C_,
               G_IV = G_IBK + IX, G_IBV = G_IV + (long)IX * C_,
               G_TOKEN = G_IBV + IX;
// image part, offsets relative to G_TOKEN (and to a partial's start)
constexpr long I_TKQ = 0, I_TBKQ = I_TKQ + 2L * IX * C_,
               I_TV = I_TBKQ + 2 * IX, I_TBV = I_TV + (long)IX * C_,
               I_IO = I_TBV + IX, I_IBO = I_IO + (long)C_ * IX,
               I_LN4W = I_IBO + C_, I_LN4B = I_LN4W + C_,
               I_TOTAL = I_LN4B + C_;

extern "C" long twoway_grad_floats() { return G_TOKEN + I_TOTAL; }

// ---------------------------------------------------------------------------
// Row kernels
// ---------------------------------------------------------------------------

// kin = K0 + kpe (kpe [HW, C] shared by the objects) over the S image rows
// and, when q0 is given, q0 = x + qpe over the T token rows; bf16 adds.
__global__ void prep_kernel(const bf16* __restrict__ k0,
                            const bf16* __restrict__ kpe, bf16* kin, long S,
                            int HW, const bf16* __restrict__ x,
                            const bf16* __restrict__ qpe, bf16* q0, long T) {
  const long img = S * C_, total = img + (q0 ? T * C_ : 0);
  for (long e = blockIdx.x * (long)blockDim.x + threadIdx.x; e < total;
       e += (long)gridDim.x * blockDim.x) {
    if (e < img) {
      const long r = e / C_;
      const int c = e - r * C_;
      kin[e] = to_bf16(to_f32(k0[e]) + to_f32(kpe[(r % HW) * C_ + c]));
    } else {
      const long t = e - img;
      q0[t] = to_bf16(to_f32(x[t]) + to_f32(qpe[t]));
    }
  }
}

static int grid_for(long n) {
  const long b = (n + 255) / 256;
  return (int)(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

// LayerNorm of rows of C_ (a warp per row, f32 statistics), y = bf16 out;
// with pe, also ype = bf16(y + pe) (the next stage's query, pe added in
// bf16 to the rounded y).
__global__ void __launch_bounds__(128)
ln_fwd_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ b, bf16* y, const bf16* pe, bf16* ype,
              long rows) {
  const long row = blockIdx.x * 4L + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  constexpr int PER = C_ / 32;
  float v[PER];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    v[i] = to_f32(x[row * C_ + lane + 32 * i]);
    s += v[i];
  }
  const float mu = warp_sum(s) / C_;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const float d = v[i] - mu;
    q += d * d;
  }
  const float rs = rsqrtf(warp_sum(q) / C_ + EPS);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    const bf16 o = to_bf16((v[i] - mu) * rs * w[c] + b[c]);
    y[row * C_ + c] = o;
    if (ype) ype[row * C_ + c] = to_bf16(to_f32(o) + to_f32(pe[row * C_ + c]));
  }
}

static void ln_fwd(const bf16* x, const float* w, const float* b, bf16* y,
                   const bf16* pe, bf16* ype, long rows, cudaStream_t st) {
  ln_fwd_kernel<<<(unsigned)((rows + 3) / 4), 128, 0, st>>>(x, w, b, y, pe,
                                                            ype, rows);
}

// LayerNorm backward over rows of C_ (a warp per row) whose incoming
// gradient is a sum, dy = ((bf16 dyb) + d1) + d2 (any term may be null), in
// the order the TPU kernel adds them:
//   dx = rinv * (dxh - mean(dxh) - xhat * mean(dxh * xhat)), dxh = dy * w,
// stored as f32 (dx32) and bf16 (dxb); dy itself to dytot when given, and
// (mean, rinv) per row for the LayerNorm's weight-gradient column sums.
__global__ void __launch_bounds__(128)
ln_bwd_sum_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                  const bf16* dyb, const float* d1, const float* d2,
                  float* dytot, float* dx32, bf16* dxb, float2* stats,
                  long rows) {
  const long row = blockIdx.x * 4L + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  constexpr int PER = C_ / 32;
  float xv[PER], dv[PER];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    xv[i] = to_f32(x[row * C_ + lane + 32 * i]);
    s += xv[i];
  }
  const float mu = warp_sum(s) / C_;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const float d = xv[i] - mu;
    q += d * d;
  }
  const float rinv = rsqrtf(warp_sum(q) / C_ + EPS);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const long e = row * C_ + lane + 32 * i;
    float g = dyb ? to_f32(dyb[e]) : 0.f;
    if (d1) g += d1[e];
    if (d2) g += d2[e];
    if (dytot) dytot[e] = g;
    xv[i] = (xv[i] - mu) * rinv;
    dv[i] = g * w[lane + 32 * i];
    s1 += dv[i];
    s2 += dv[i] * xv[i];
  }
  const float m1 = warp_sum(s1) / C_, m2 = warp_sum(s2) / C_;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const long e = row * C_ + lane + 32 * i;
    const float o = rinv * (dv[i] - m1 - xv[i] * m2);
    dx32[e] = o;
    dxb[e] = to_bf16(o);
  }
  if (lane == 0) stats[row] = make_float2(mu, rinv);
}

static void ln_bwd_sum(const bf16* x, const float* w, const bf16* dyb,
                       const float* d1, const float* d2, float* dytot,
                       float* dx32, bf16* dxb, float2* stats, long rows,
                       cudaStream_t st) {
  ln_bwd_sum_kernel<<<(unsigned)((rows + 3) / 4), 128, 0, st>>>(
      x, w, dyb, d1, d2, dytot, dx32, dxb, stats, rows);
}

// ---------------------------------------------------------------------------
// Attention, per (object, head): a warp per query row (forward, backward
// row pass) or per key (backward column pass). Row r of object o of an
// operand X lies at X + o * sX + r * ldX, head h at column h * HD.
// ---------------------------------------------------------------------------

struct Attn {
  const bf16 *q, *k, *v, *dout;
  int ldq, ldk, ldv, lddo;
  long sq, sk, sv, sdo;
  bf16* o;                 // forward output [rows, H * HD]
  int ldo;
  long so;
  bf16 *dq, *dk, *dvb;     // backward outputs (bf16)
  int lddq, lddk, lddv;
  long sdq, sdk, sdv;
  float* dv32;             // dv in f32, dense [O * Lk, H * HD]
  bf16 *ds, *pb;           // scratch [O, H, Lq, Lk]: bf16 ds and p
  int O, H, Lq, Lk;
  float scale;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffff, v, o));
  return v;
}

template <int HD>
__device__ __forceinline__ void load_row(const bf16* p, float* r) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const uint4 u = *reinterpret_cast<const uint4*>(p + 8 * j);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int t = 0; t < 8; ++t) r[8 * j + t] = to_f32(e[t]);
  }
}

template <int HD>
__device__ __forceinline__ float dot_row(const float* a, const bf16* p) {
  float r[HD];
  load_row<HD>(p, r);
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) s += a[d] * r[d];
  return s;
}

// the row max and the softmax denominator of query row qv against the Lk
// keys at kb (row stride ldk), each lane taking every 32nd key
template <int HD>
__device__ __forceinline__ void softmax_stats(const float* qv, const bf16* kb,
                                              int ldk, int Lk, float scale,
                                              int lane, float& m, float& l) {
  m = -INFINITY;
  for (int j = lane; j < Lk; j += 32)
    m = fmaxf(m, dot_row<HD>(qv, kb + (long)j * ldk) * scale);
  m = warp_max(m);
  l = 0.f;
  for (int j = lane; j < Lk; j += 32)
    l += expf(dot_row<HD>(qv, kb + (long)j * ldk) * scale - m);
  l = warp_sum(l);
}

// lane d (< HD) stores the warp sum of acc[d]
template <int HD>
__device__ __forceinline__ void store_sums(float* acc, int lane, bf16* outb,
                                           float* out32) {
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    const float t = warp_sum(acc[d]);
    if (lane == d) {
      if (outb) outb[d] = to_bf16(t);
      if (out32) out32[d] = t;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(256) attn_fwd_kernel(Attn a) {
  const long gw = (blockIdx.x * (long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (gw >= (long)a.O * a.H * a.Lq) return;
  const int i = gw % a.Lq;
  const long t = gw / a.Lq;
  const int h = t % a.H, o = t / a.H;
  const bf16* kb = a.k + o * a.sk + h * HD;
  const bf16* vb = a.v + o * a.sv + h * HD;
  float qv[HD];
  load_row<HD>(a.q + o * a.sq + (long)i * a.ldq + h * HD, qv);
  float m, l;
  softmax_stats<HD>(qv, kb, a.ldk, a.Lk, a.scale, lane, m, l);
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  for (int j = lane; j < a.Lk; j += 32) {
    const float p = rb(expf(dot_row<HD>(qv, kb + (long)j * a.ldk) * a.scale -
                             m) / l);
    float vr[HD];
    load_row<HD>(vb + (long)j * a.ldv, vr);
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] += p * vr[d];
  }
  store_sums<HD>(acc, lane, a.o + o * a.so + (long)i * a.ldo + h * HD,
                 nullptr);
}

// backward row pass: a warp per query row (o, h, i)
template <int HD>
__global__ void __launch_bounds__(256) attn_bwd_rows_kernel(Attn a) {
  const long gw = (blockIdx.x * (long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (gw >= (long)a.O * a.H * a.Lq) return;
  const int i = gw % a.Lq;
  const long t = gw / a.Lq;
  const int h = t % a.H, o = t / a.H;
  const bf16* kb = a.k + o * a.sk + h * HD;
  const bf16* vb = a.v + o * a.sv + h * HD;
  float qv[HD], dov[HD];
  load_row<HD>(a.q + o * a.sq + (long)i * a.ldq + h * HD, qv);
  load_row<HD>(a.dout + o * a.sdo + (long)i * a.lddo + h * HD, dov);
  float m, l;
  softmax_stats<HD>(qv, kb, a.ldk, a.Lk, a.scale, lane, m, l);
  float D = 0.f;
  for (int j = lane; j < a.Lk; j += 32) {
    const float p =
        expf(dot_row<HD>(qv, kb + (long)j * a.ldk) * a.scale - m) / l;
    D += dot_row<HD>(dov, vb + (long)j * a.ldv) * p;
  }
  D = warp_sum(D);
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  const long srow = gw * a.Lk;   // ((o * H + h) * Lq + i) * Lk
  for (int j = lane; j < a.Lk; j += 32) {
    const bf16* kr = kb + (long)j * a.ldk;
    const float p = expf(dot_row<HD>(qv, kr) * a.scale - m) / l;
    const float dp = dot_row<HD>(dov, vb + (long)j * a.ldv);
    const float ds = rb(p * (dp - D) * a.scale);
    a.ds[srow + j] = to_bf16(ds);
    a.pb[srow + j] = to_bf16(p);
    float kv[HD];
    load_row<HD>(kr, kv);
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] += ds * kv[d];
  }
  store_sums<HD>(acc, lane, a.dq + o * a.sdq + (long)i * a.lddq + h * HD,
                 nullptr);
}

// backward column pass: a warp per key (o, h, j): dk = ds^T q, dv = p^T do
template <int HD>
__global__ void __launch_bounds__(256) attn_bwd_cols_kernel(Attn a) {
  const long gw = (blockIdx.x * (long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (gw >= (long)a.O * a.H * a.Lk) return;
  const int j = gw % a.Lk;
  const long t = gw / a.Lk;
  const int h = t % a.H, o = t / a.H;
  const long sbase = t * a.Lq * a.Lk + j;   // ((o * H + h) * Lq + i) * Lk + j
  float ak[HD], av[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) ak[d] = av[d] = 0.f;
  for (int i = lane; i < a.Lq; i += 32) {
    const float ds = to_f32(a.ds[sbase + (long)i * a.Lk]);
    const float p = to_f32(a.pb[sbase + (long)i * a.Lk]);
    float qv[HD], dov[HD];
    load_row<HD>(a.q + o * a.sq + (long)i * a.ldq + h * HD, qv);
    load_row<HD>(a.dout + o * a.sdo + (long)i * a.lddo + h * HD, dov);
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      ak[d] += ds * qv[d];
      av[d] += p * dov[d];
    }
  }
  const long row = (long)o * a.Lk + j;
  store_sums<HD>(ak, lane, a.dk + o * a.sdk + (long)j * a.lddk + h * HD,
                 nullptr);
  store_sums<HD>(av, lane, a.dvb + o * a.sdv + (long)j * a.lddv + h * HD,
                 a.dv32 + row * (a.H * HD) + h * HD);
}

static unsigned warps_grid(long warps) { return (unsigned)((warps + 7) / 8); }

template <int HD>
static void attn_fwd(const Attn& a, cudaStream_t st) {
  attn_fwd_kernel<HD><<<warps_grid((long)a.O * a.H * a.Lq), 256, 0, st>>>(a);
}

template <int HD>
static void attn_bwd(const Attn& a, cudaStream_t st) {
  const long rows = (long)a.O * a.H * a.Lq, cols = (long)a.O * a.H * a.Lk;
  attn_bwd_rows_kernel<HD><<<warps_grid(rows), 256, 0, st>>>(a);
  attn_bwd_cols_kernel<HD><<<warps_grid(cols), 256, 0, st>>>(a);
}

static Attn attn(const bf16* q, int ldq, long sq, const bf16* k, int ldk,
                 long sk, const bf16* v, int ldv, long sv, int O, int Lq,
                 int Lk, int hd) {
  Attn a{};
  a.q = q; a.ldq = ldq; a.sq = sq;
  a.k = k; a.ldk = ldk; a.sk = sk;
  a.v = v; a.ldv = ldv; a.sv = sv;
  a.O = O; a.H = HEADS; a.Lq = Lq; a.Lk = Lk;
  a.scale = 1.0f / sqrtf((float)hd);
  return a;
}

// ---------------------------------------------------------------------------
// Final sums of the backward
// ---------------------------------------------------------------------------

// image side, per (hw, c): dk0 = bf16(bf16(dpre4 + kin_d) + kin_b + dvb)
// for each object (B1's bf16 dk0, then B2's sum), dkpe = sum over the
// objects of kin_d, plus the same of kin_b (in object order); token side:
// dx = [dpre1 +] dqk + dv0, dqpe = (dqd + dqb) [+ dqk], both bf16.
__global__ void finalize_kernel(const float* __restrict__ dpre4,
                                const float* __restrict__ kin_d,
                                const float* __restrict__ kin_b,
                                const float* __restrict__ dvb, bf16* dk0,
                                bf16* dkpe, int O, int HW,
                                const float* __restrict__ dpre1,
                                const float* __restrict__ dqk,
                                const float* __restrict__ dv0,
                                const float* __restrict__ dqd,
                                const float* __restrict__ dqb, bf16* dx,
                                bf16* dqpe, long T, int first) {
  const long img = (long)HW * C_, total = img + T * C_;
  for (long e = blockIdx.x * (long)blockDim.x + threadIdx.x; e < total;
       e += (long)gridDim.x * blockDim.x) {
    if (e < img) {
      float sd = 0.f, sb = 0.f;
      for (int o = 0; o < O; ++o) {
        const long i = (long)o * img + e;
        const float a = kin_d[i], b = kin_b[i];
        sd += a;
        sb += b;
        dk0[i] = to_bf16(rb(dpre4[i] + a) + b + dvb[i]);
      }
      dkpe[e] = to_bf16(sd + sb);
    } else {
      const long i = e - img;
      const float q = dqk[i];
      dx[i] = to_bf16((first ? q : dpre1[i] + q) + dv0[i]);
      float g = dqd[i] + dqb[i];
      if (!first) g += q;
      dqpe[i] = to_bf16(g);
    }
  }
}

// ---------------------------------------------------------------------------
// Workspaces
// ---------------------------------------------------------------------------

// the forward's activations, kept for the backward
struct FwdBufs {
  bf16 *q0, *sqkv, *so, *pre1, *x1, *x1pe, *tq, *to, *pre2, *x2, *r, *pre3,
      *x3pe, *ikv;                                   // token rows
  bf16 *kin, *kq, *tv, *io, *pre4;                   // image rows
};

static FwdBufs carve_fwd(Arena& ar, long T, long S) {
  FwdBufs f{};
  f.q0 = ar.take<bf16>(T * C_);
  f.sqkv = ar.take<bf16>(T * 3 * IS);
  f.so = ar.take<bf16>(T * IS);
  f.pre1 = ar.take<bf16>(T * C_);
  f.x1 = ar.take<bf16>(T * C_);
  f.x1pe = ar.take<bf16>(T * C_);
  f.tq = ar.take<bf16>(T * IX);
  f.to = ar.take<bf16>(T * IX);
  f.pre2 = ar.take<bf16>(T * C_);
  f.x2 = ar.take<bf16>(T * C_);
  f.r = ar.take<bf16>(T * HID);
  f.pre3 = ar.take<bf16>(T * C_);
  f.x3pe = ar.take<bf16>(T * C_);
  f.ikv = ar.take<bf16>(T * 2 * IX);
  f.kin = ar.take<bf16>(S * C_);
  f.kq = ar.take<bf16>(S * 2 * IX);
  f.tv = ar.take<bf16>(S * IX);
  f.io = ar.take<bf16>(S * IX);
  f.pre4 = ar.take<bf16>(S * C_);
  return f;
}

struct BwdBufs {
  float *dpre4, *kin_d, *kin_b, *dvt32, *dvb, *part;             // image
  bf16 *dpre4b, *do4, *dkq, *dvtb;
  float2* st4;
  float *dvi32, *dqd, *dxa, *dy3, *dpre3, *dh1, *dx2, *dpre2, *dqb, *dy1,
      *dpre1, *dsv32, *dqk, *dv0;                                 // token
  bf16 *dki, *dvib, *dpre3b, *dh1b, *dpre2b, *do2, *dqt, *dpre1b, *dos,
      *dsqkv;
  float2 *st3, *st2, *st1;
  bf16 *ds, *pb;                                                  // attention
};

static BwdBufs carve_bwd(Arena& ar, long O, long N, long HW) {
  const long T = O * N, S = O * HW;
  const long Z = (S + CHUNK - 1) / CHUNK;
  const long LL = O * HEADS * (N * HW > N * N ? N * HW : N * N);
  BwdBufs b{};
  b.dpre4 = ar.take<float>(S * C_);
  b.kin_d = ar.take<float>(S * C_);
  b.kin_b = ar.take<float>(S * C_);
  b.dvt32 = ar.take<float>(S * IX);
  b.dvb = ar.take<float>(S * C_);
  b.part = ar.take<float>(Z * I_TOTAL);
  b.dpre4b = ar.take<bf16>(S * C_);
  b.do4 = ar.take<bf16>(S * IX);
  b.dkq = ar.take<bf16>(S * 2 * IX);
  b.dvtb = ar.take<bf16>(S * IX);
  b.st4 = ar.take<float2>(S);
  b.dvi32 = ar.take<float>(T * IX);
  b.dqd = ar.take<float>(T * C_);
  b.dxa = ar.take<float>(T * C_);
  b.dy3 = ar.take<float>(T * C_);
  b.dpre3 = ar.take<float>(T * C_);
  b.dh1 = ar.take<float>(T * HID);
  b.dx2 = ar.take<float>(T * C_);
  b.dpre2 = ar.take<float>(T * C_);
  b.dqb = ar.take<float>(T * C_);
  b.dy1 = ar.take<float>(T * C_);
  b.dpre1 = ar.take<float>(T * C_);
  b.dsv32 = ar.take<float>(T * IS);
  b.dqk = ar.take<float>(T * C_);
  b.dv0 = ar.take<float>(T * C_);
  b.dki = ar.take<bf16>(T * IX);
  b.dvib = ar.take<bf16>(T * IX);
  b.dpre3b = ar.take<bf16>(T * C_);
  b.dh1b = ar.take<bf16>(T * HID);
  b.dpre2b = ar.take<bf16>(T * C_);
  b.do2 = ar.take<bf16>(T * IX);
  b.dqt = ar.take<bf16>(T * IX);
  b.dpre1b = ar.take<bf16>(T * C_);
  b.dos = ar.take<bf16>(T * IS);
  b.dsqkv = ar.take<bf16>(T * 3 * IS);
  b.st3 = ar.take<float2>(T);
  b.st2 = ar.take<float2>(T);
  b.st1 = ar.take<float2>(T);
  b.ds = ar.take<bf16>(LL);
  b.pb = ar.take<bf16>(LL);
  return b;
}

// bytes of the forward's saved activations (bwd = 0) or of the backward's
// scratch (bwd = 1)
extern "C" long twoway_workspace_bytes(int O, int N, int HW, int bwd) {
  Arena ar{nullptr, 0};
  if (bwd)
    carve_bwd(ar, O, N, HW);
  else
    carve_fwd(ar, (long)O * N, (long)O * HW);
  return (long)ar.off;
}

// ---------------------------------------------------------------------------
// Entry points
// ---------------------------------------------------------------------------

// x, qpe [O, N, 256]; k0 [O, HW, 256]; kpe [HW, 256]; all bf16. Writes
// xout [O, N, 256], kout [O, HW, 256] and the activations into fws.
extern "C" int twoway_fwd(const void* x_, const void* k0_, const void* qpe_,
                          const void* kpe_, const void* const* w, void* xout_,
                          void* kout_, void* fws, int O, int N, int HW,
                          int first, void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  auto W = [&](int i) { return static_cast<const bf16*>(w[i]); };
  auto F = [&](int i) { return static_cast<const float*>(w[i]); };
  const bf16* x = static_cast<const bf16*>(x_);
  const bf16* k0 = static_cast<const bf16*>(k0_);
  const bf16* qpe = static_cast<const bf16*>(qpe_);
  bf16* xout = static_cast<bf16*>(xout_);
  const long T = (long)O * N, S = (long)O * HW;
  Arena ar{static_cast<char*>(fws), 0};
  FwdBufs f = carve_fwd(ar, T, S);

  prep_kernel<<<grid_for(S * C_ + T * C_), 256, 0, st>>>(
      k0, static_cast<const bf16*>(kpe_), f.kin, S, HW, x, qpe,
      first ? nullptr : f.q0, T);
  // image rows: [t2i k | i2t q] from kin, t2i v from K0
  BEpi e = bepi(2 * IX);
  e.bias = F(B_TKQ);
  e.out = f.kq;
  bgemm<false, false>(f.kin, C_, 0, W(W_TKQ), C_, 0, S, 2 * IX, C_, 1, e, st);
  e = bepi(IX);
  e.bias = F(B_TV);
  e.out = f.tv;
  bgemm<false, false>(k0, C_, 0, W(W_TV), C_, 0, S, IX, C_, 1, e, st);

  // ---- A: self-attention (q = k = x + qpe, v = x; the first block x only)
  e = bepi(3 * IS);
  e.bias = F(B_SQKV);
  e.out = f.sqkv;
  if (first) {
    bgemm<false, false>(x, C_, 0, W(W_SQKV), C_, 0, T, 3 * IS, C_, 1, e, st);
  } else {
    bgemm<false, false>(f.q0, C_, 0, W(W_SQKV), C_, 0, T, 2 * IS, C_, 1, e,
                        st);
    e.bias = F(B_SQKV) + 2 * IS;
    e.out = f.sqkv + 2 * IS;
    bgemm<false, false>(x, C_, 0, W(W_SQKV) + 2L * IS * C_, C_, 0, T, IS, C_,
                        1, e, st);
  }
  Attn a = attn(f.sqkv, 3 * IS, N * 3L * IS, f.sqkv + IS, 3 * IS,
                N * 3L * IS, f.sqkv + 2 * IS, 3 * IS, N * 3L * IS, O, N, N,
                IS / HEADS);
  a.o = f.so; a.ldo = IS; a.so = N * (long)IS;
  attn_fwd<IS / HEADS>(a, st);
  e = bepi(C_);
  e.bias = F(B_SO);
  e.res = first ? nullptr : x;
  e.out = f.pre1;
  bgemm<false, false>(f.so, IS, 0, W(W_SO), IS, 0, T, C_, IS, 1, e, st);
  ln_fwd(f.pre1, F(LN1W), F(LN1B), f.x1, qpe, f.x1pe, T, st);

  // ---- B: token -> image
  e = bepi(IX);
  e.bias = F(B_TQ);
  e.out = f.tq;
  bgemm<false, false>(f.x1pe, C_, 0, W(W_TQ), C_, 0, T, IX, C_, 1, e, st);
  a = attn(f.tq, IX, N * (long)IX, f.kq, 2 * IX, HW * 2L * IX, f.tv, IX,
           HW * (long)IX, O, N, HW, IX / HEADS);
  a.o = f.to; a.ldo = IX; a.so = N * (long)IX;
  attn_fwd<IX / HEADS>(a, st);
  e = bepi(C_);
  e.bias = F(B_TO);
  e.res = f.x1;
  e.out = f.pre2;
  bgemm<false, false>(f.to, IX, 0, W(W_TO), IX, 0, T, C_, IX, 1, e, st);
  ln_fwd(f.pre2, F(LN2W), F(LN2B), f.x2, nullptr, nullptr, T, st);

  // ---- C: MLP
  e = bepi(HID);
  e.bias = F(B_M1);
  e.relu = 1;
  e.out = f.r;
  bgemm<false, false>(f.x2, C_, 0, W(W_M1), C_, 0, T, HID, C_, 1, e, st);
  e = bepi(C_);
  e.bias = F(B_M2);
  e.res = f.x2;
  e.out = f.pre3;
  bgemm<false, false>(f.r, HID, 0, W(W_M2), HID, 0, T, C_, HID, 1, e, st);
  ln_fwd(f.pre3, F(LN3W), F(LN3B), xout, qpe, f.x3pe, T, st);

  // ---- D: image -> token (k = x3 + qpe, v = x3)
  e = bepi(2 * IX);
  e.bias = F(B_IK);
  e.out = f.ikv;
  bgemm<false, false>(f.x3pe, C_, 0, W(W_IK), C_, 0, T, IX, C_, 1, e, st);
  e.bias = F(B_IV);
  e.out = f.ikv + IX;
  bgemm<false, false>(xout, C_, 0, W(W_IV), C_, 0, T, IX, C_, 1, e, st);
  a = attn(f.kq + IX, 2 * IX, HW * 2L * IX, f.ikv, 2 * IX, N * 2L * IX,
           f.ikv + IX, 2 * IX, N * 2L * IX, O, HW, N, IX / HEADS);
  a.o = f.io; a.ldo = IX; a.so = HW * (long)IX;
  attn_fwd<IX / HEADS>(a, st);
  e = bepi(C_);
  e.bias = F(B_IO);
  e.res = k0;
  e.out = f.pre4;
  bgemm<false, false>(f.io, IX, 0, W(W_IO), IX, 0, S, C_, IX, 1, e, st);
  ln_fwd(f.pre4, F(LN4W), F(LN4B), static_cast<bf16*>(kout_), nullptr,
         nullptr, S, st);
  return (int)cudaGetLastError();
}

// dx3 [O, N, 256], dk1 [O, HW, 256] bf16 cotangents of xout and kout. Writes
// dx, dqpe [O, N, 256], dk0 [O, HW, 256], dkpe [HW, 256] (bf16) and, with
// wgrad, the f32 weight gradients (twoway_grad_floats(), layout G_* / I_*).
extern "C" int twoway_bwd(const void* x_, const void* k0_, const void* qpe_,
                          const void* kpe_, const void* const* w,
                          const void* x3_, const void* fws, const void* dx3_,
                          const void* dk1_, void* dx_, void* dk0_,
                          void* dqpe_, void* dkpe_, void* grads, void* ws,
                          int O, int N, int HW, int first, int wgrad,
                          void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  auto W = [&](int i) { return static_cast<const bf16*>(w[i]); };
  auto F = [&](int i) { return static_cast<const float*>(w[i]); };
  const bf16* x = static_cast<const bf16*>(x_);
  const bf16* k0 = static_cast<const bf16*>(k0_);
  const bf16* x3 = static_cast<const bf16*>(x3_);
  const bf16* dk1 = static_cast<const bf16*>(dk1_);
  const long T = (long)O * N, S = (long)O * HW;
  Arena af{const_cast<char*>(static_cast<const char*>(fws)), 0};
  const FwdBufs f = carve_fwd(af, T, S);
  Arena ab{static_cast<char*>(ws), 0};
  BwdBufs b = carve_bwd(ab, O, N, HW);
  float* G = static_cast<float*>(grads);
  float* P = b.part;
  const int Z = (int)((S + CHUNK - 1) / CHUNK);
  const int Klast = (int)(S - (long)(Z - 1) * CHUNK);

  // weight gradient dW[M, Nn] = dY^T X over the token rows (one sum) or the
  // image rows (per-chunk partials); column sums likewise
  auto wtok = [&](const bf16* dy, int ldy, const bf16* xx, int ldx, int M,
                  int Nn, long off) {
    if (!wgrad) return;
    BEpi e = bepi(Nn);
    e.out32 = G + off;
    bgemm<true, true>(dy, ldy, 0, xx, ldx, 0, M, Nn, (int)T, 1, e, st,
                      (int)T);
  };
  auto wimg = [&](const bf16* dy, int ldy, const bf16* xx, int ldx, int M,
                  int Nn, long off) {
    if (!wgrad) return;
    BEpi e = bepi(Nn, I_TOTAL);
    e.out32 = P + off;
    bgemm<true, true>(dy, ldy, (long)CHUNK * ldy, xx, ldx, (long)CHUNK * ldx,
                      M, Nn, CHUNK, Z, e, st, Klast);
  };
  auto ctok = [&](const float* a32, const bf16* a16, int lda, const bf16* xx,
                  const float2* stats, int n, long off) {
    if (wgrad) colsum(a32, a16, lda, xx, stats, T, T, n, G + off, 0, st);
  };
  auto cimg = [&](const float* a32, const bf16* a16, int lda, const bf16* xx,
                  const float2* stats, int n, long off) {
    if (wgrad) colsum(a32, a16, lda, xx, stats, CHUNK, S, n, P + off, I_TOTAL,
                      st);
  };
  auto prod32 = [&](const bf16* a, int lda, const bf16* wt, int ldw, long M,
                    int Nn, int K, float* out, const float* res32) {
    BEpi e = bepi(Nn);
    e.out32 = out;
    e.res32 = res32;
    bgemm<false, true>(a, lda, 0, wt, ldw, 0, (int)M, Nn, K, 1, e, st);
  };
  auto prod16 = [&](const bf16* a, int lda, const bf16* wt, int ldw, long M,
                    int Nn, int K, bf16* out) {
    BEpi e = bepi(Nn);
    e.out = out;
    bgemm<false, true>(a, lda, 0, wt, ldw, 0, (int)M, Nn, K, 1, e, st);
  };

  // ---- D backward: K1 = LN4(K0 + i2t(q = kin, k = x3 + qpe, v = x3))
  ln_bwd_sum(f.pre4, F(LN4W), dk1, nullptr, nullptr, nullptr, b.dpre4,
             b.dpre4b, b.st4, S, st);
  cimg(nullptr, dk1, C_, f.pre4, b.st4, C_, I_LN4W);
  cimg(nullptr, dk1, C_, nullptr, nullptr, C_, I_LN4B);
  cimg(b.dpre4, nullptr, C_, nullptr, nullptr, C_, I_IBO);
  wimg(b.dpre4b, C_, f.io, IX, C_, IX, I_IO);
  prod16(b.dpre4b, C_, W(W_IO), IX, S, IX, C_, b.do4);
  Attn a = attn(f.kq + IX, 2 * IX, HW * 2L * IX, f.ikv, 2 * IX, N * 2L * IX,
                f.ikv + IX, 2 * IX, N * 2L * IX, O, HW, N, IX / HEADS);
  a.dout = b.do4; a.lddo = IX; a.sdo = HW * (long)IX;
  a.dq = b.dkq + IX; a.lddq = 2 * IX; a.sdq = HW * 2L * IX;
  a.dk = b.dki; a.lddk = IX; a.sdk = N * (long)IX;
  a.dvb = b.dvib; a.lddv = IX; a.sdv = N * (long)IX;
  a.dv32 = b.dvi32;
  a.ds = b.ds; a.pb = b.pb;
  attn_bwd<IX / HEADS>(a, st);
  wtok(b.dki, IX, f.x3pe, C_, IX, C_, G_IK);
  ctok(nullptr, b.dki, IX, nullptr, nullptr, IX, G_IBK);
  wtok(b.dvib, IX, x3, C_, IX, C_, G_IV);
  ctok(b.dvi32, nullptr, IX, nullptr, nullptr, IX, G_IBV);
  prod32(b.dki, IX, W(W_IK), C_, T, C_, IX, b.dqd, nullptr);
  prod32(b.dvib, IX, W(W_IV), C_, T, C_, IX, b.dxa, nullptr);
  prod32(b.dkq + IX, 2 * IX, W(W_TKQ) + (long)IX * C_, C_, S, C_, IX,
         b.kin_d, nullptr);

  // ---- C backward: x3 = LN3(x2 + MLP(x2))
  ln_bwd_sum(f.pre3, F(LN3W), static_cast<const bf16*>(dx3_), b.dqd, b.dxa,
             b.dy3, b.dpre3, b.dpre3b, b.st3, T, st);
  ctok(b.dy3, nullptr, C_, f.pre3, b.st3, C_, G_LN3W);
  ctok(b.dy3, nullptr, C_, nullptr, nullptr, C_, G_LN3B);
  ctok(b.dpre3, nullptr, C_, nullptr, nullptr, C_, G_MB2);
  wtok(b.dpre3b, C_, f.r, HID, C_, HID, G_M2);
  {
    BEpi e = bepi(HID);                 // dh1 = (dpre3 W2) where h1 > 0
    e.mask = f.r;
    e.out = b.dh1b;
    e.out32 = b.dh1;
    bgemm<false, true>(b.dpre3b, C_, 0, W(W_M2), HID, 0, (int)T, HID, C_, 1,
                       e, st);
  }
  ctok(b.dh1, nullptr, HID, nullptr, nullptr, HID, G_MB1);
  wtok(b.dh1b, HID, f.x2, C_, HID, C_, G_M1);
  prod32(b.dh1b, HID, W(W_M1), C_, T, C_, HID, b.dx2, b.dpre3);

  // ---- B backward: x2 = LN2(x1 + t2i(q = x1 + qpe, k = kin, v = K0))
  ln_bwd_sum(f.pre2, F(LN2W), nullptr, b.dx2, nullptr, nullptr, b.dpre2,
             b.dpre2b, b.st2, T, st);
  ctok(b.dx2, nullptr, C_, f.pre2, b.st2, C_, G_LN2W);
  ctok(b.dx2, nullptr, C_, nullptr, nullptr, C_, G_LN2B);
  ctok(b.dpre2, nullptr, C_, nullptr, nullptr, C_, G_TBO);
  wtok(b.dpre2b, C_, f.to, IX, C_, IX, G_TO);
  prod16(b.dpre2b, C_, W(W_TO), IX, T, IX, C_, b.do2);
  a = attn(f.tq, IX, N * (long)IX, f.kq, 2 * IX, HW * 2L * IX, f.tv, IX,
           HW * (long)IX, O, N, HW, IX / HEADS);
  a.dout = b.do2; a.lddo = IX; a.sdo = N * (long)IX;
  a.dq = b.dqt; a.lddq = IX; a.sdq = N * (long)IX;
  a.dk = b.dkq; a.lddk = 2 * IX; a.sdk = HW * 2L * IX;
  a.dvb = b.dvtb; a.lddv = IX; a.sdv = HW * (long)IX;
  a.dv32 = b.dvt32;
  a.ds = b.ds; a.pb = b.pb;
  attn_bwd<IX / HEADS>(a, st);
  wtok(b.dqt, IX, f.x1pe, C_, IX, C_, G_TQ);
  ctok(nullptr, b.dqt, IX, nullptr, nullptr, IX, G_TBQ);
  wimg(b.dkq, 2 * IX, f.kin, C_, 2 * IX, C_, I_TKQ);
  cimg(nullptr, b.dkq, 2 * IX, nullptr, nullptr, 2 * IX, I_TBKQ);
  wimg(b.dvtb, IX, k0, C_, IX, C_, I_TV);
  cimg(b.dvt32, nullptr, IX, nullptr, nullptr, IX, I_TBV);
  prod32(b.dqt, IX, W(W_TQ), C_, T, C_, IX, b.dqb, nullptr);
  prod32(b.dkq, 2 * IX, W(W_TKQ), C_, S, C_, IX, b.kin_b, nullptr);
  prod32(b.dvtb, IX, W(W_TV), C_, S, C_, IX, b.dvb, nullptr);

  // ---- A backward: x1 = LN1([x +] self(q = k = x [+ qpe], v = x))
  ln_bwd_sum(f.pre1, F(LN1W), nullptr, b.dpre2, b.dqb, b.dy1, b.dpre1,
             b.dpre1b, b.st1, T, st);
  ctok(b.dy1, nullptr, C_, f.pre1, b.st1, C_, G_LN1W);
  ctok(b.dy1, nullptr, C_, nullptr, nullptr, C_, G_LN1B);
  ctok(b.dpre1, nullptr, C_, nullptr, nullptr, C_, G_SBO);
  wtok(b.dpre1b, C_, f.so, IS, C_, IS, G_SO);
  prod16(b.dpre1b, C_, W(W_SO), IS, T, IS, C_, b.dos);
  a = attn(f.sqkv, 3 * IS, N * 3L * IS, f.sqkv + IS, 3 * IS, N * 3L * IS,
           f.sqkv + 2 * IS, 3 * IS, N * 3L * IS, O, N, N, IS / HEADS);
  a.dout = b.dos; a.lddo = IS; a.sdo = N * (long)IS;
  a.dq = b.dsqkv; a.lddq = 3 * IS; a.sdq = N * 3L * IS;
  a.dk = b.dsqkv + IS; a.lddk = 3 * IS; a.sdk = N * 3L * IS;
  a.dvb = b.dsqkv + 2 * IS; a.lddv = 3 * IS; a.sdv = N * 3L * IS;
  a.dv32 = b.dsv32;
  a.ds = b.ds; a.pb = b.pb;
  attn_bwd<IS / HEADS>(a, st);
  const bf16* qin = first ? x : f.q0;
  wtok(b.dsqkv, 3 * IS, qin, C_, 2 * IS, C_, G_SQKV);
  wtok(b.dsqkv + 2 * IS, 3 * IS, x, C_, IS, C_, G_SQKV + 2L * IS * C_);
  ctok(nullptr, b.dsqkv, 3 * IS, nullptr, nullptr, 2 * IS, G_SBQKV);
  ctok(b.dsv32, nullptr, IS, nullptr, nullptr, IS, G_SBQKV + 2 * IS);
  prod32(b.dsqkv, 3 * IS, W(W_SQKV), C_, T, C_, 2 * IS, b.dqk, nullptr);
  prod32(b.dsqkv + 2 * IS, 3 * IS, W(W_SQKV) + 2L * IS * C_, C_, T, C_, IS,
         b.dv0, nullptr);

  // ---- input gradients, then the image rows' weight-gradient partials
  finalize_kernel<<<grid_for((long)HW * C_ + T * C_), 256, 0, st>>>(
      b.dpre4, b.kin_d, b.kin_b, b.dvb, static_cast<bf16*>(dk0_),
      static_cast<bf16*>(dkpe_), O, HW, b.dpre1, b.dqk, b.dv0, b.dqd, b.dqb,
      static_cast<bf16*>(dx_), static_cast<bf16*>(dqpe_), T, first);
  if (wgrad) reduce_cols(P, Z, I_TOTAL, G + G_TOKEN, st);
  return (int)cudaGetLastError();
}
