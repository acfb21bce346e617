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
// The C entry points launch their kernels in order on the caller's stream,
// carve their scratch from one workspace the caller allocates (its size
// from *_workspace_bytes) and return cudaGetLastError().

#include "common.cuh"

// ---------------------------------------------------------------------------
// Batched GEMM on mma.sync: for z in [0, Z):
//   C[z](M x N) = epilogue(alpha * sum_k A[z](m, k) * B[z](n, k))
// A(m, k) lies at a + z*sAz + m*lda + k (TA = false) or + k*lda + m (TA);
// B(n, k) at b + z*sBz + n*ldb + k (TB = false) or + k*ldb + n (TB).
// Needs M, N % 8 == 0, K % 32 == 0, lda, ldb % 8 == 0 (checked by the
// wrappers).
// ---------------------------------------------------------------------------

// With a bias and a bf16 store the epilogue walks the compute dtype as the
// JAX kernels do (ops/common.py linear): round(acc), + round(bias), round,
// ReLU, + residual, round. The ReLU backward reads its mask from the
// rounded pre-activation, so the walk must match the plain version's.
struct BEpi {
  float alpha;          // acc *= alpha
  const float* bias;    // [N] or null, added after alpha
  int relu;             // max(v, 0) after the bias
  const bf16* mask;     // v = mask(m, n) > 0 ? v : 0, or null
  const bf16* res;      // v += res(m, n), or null (last)
  bf16* out;            // bf16 store, or null
  float* out32;         // f32 store, or null
  long sz;              // batch stride of mask / res / out / out32
  int ld;               // row stride of mask / res / out / out32
};

static inline BEpi bepi(int ld, long sz = 0) {
  BEpi e;
  e.alpha = 1.f;
  e.bias = nullptr;
  e.relu = 0;
  e.mask = nullptr;
  e.res = nullptr;
  e.out = nullptr;
  e.out32 = nullptr;
  e.sz = sz;
  e.ld = ld;
  return e;
}

// stage one 64 x 32 tile (rows r of the operand, k in [k0, k0 + 32)) as two
// 16-byte chunks per thread; `trans` reads the operand stored k-major
template <bool TRANS>
struct TileLoad {
  uint4 v[2];
  __device__ __forceinline__ void load(const bf16* p, int ld, int r0, int R,
                                       int k0, int tid) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * GEMM_THREADS;
      if (!TRANS) {
        const int r = c >> 2, kc = (c & 3) * 8;
        v[i] = r0 + r < R ? *reinterpret_cast<const uint4*>(
                                p + (size_t)(r0 + r) * ld + k0 + kc)
                          : make_uint4(0, 0, 0, 0);
      } else {
        const int kr = c >> 3, rc = (c & 7) * 8;
        v[i] = r0 + rc < R ? *reinterpret_cast<const uint4*>(
                                 p + (size_t)(k0 + kr) * ld + r0 + rc)
                           : make_uint4(0, 0, 0, 0);
      }
    }
  }
  __device__ __forceinline__ void store(bf16 (*s)[GEMM_LDS], int tid) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * GEMM_THREADS;
      if (!TRANS) {
        const int r = c >> 2, kc = (c & 3) * 8;
        *reinterpret_cast<uint4*>(&s[r][kc]) = v[i];
      } else {
        const int kr = c >> 3, rc = (c & 7) * 8;
        const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) s[rc + j][kr] = e[j];
      }
    }
  }
};

// round to bf16 and back
__device__ __forceinline__ float rb(float v) { return to_f32(to_bf16(v)); }

template <bool TA, bool TB>
__global__ void __launch_bounds__(GEMM_THREADS)
bgemm_kernel(const bf16* __restrict__ A, int lda, long sAz,
             const bf16* __restrict__ B, int ldb, long sBz, int M, int N,
             int K, BEpi ep) {
  __shared__ __align__(16) bf16 As[2][GEMM_BM][GEMM_LDS];
  __shared__ __align__(16) bf16 Bs[2][GEMM_BN][GEMM_LDS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * GEMM_BM, n0 = blockIdx.x * GEMM_BN;
  const int z = blockIdx.z;
  const bf16* a = A + (size_t)z * sAz;
  const bf16* b = B + (size_t)z * sBz;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  TileLoad<TA> la;
  TileLoad<TB> lb;
  const int KT = K / GEMM_BK;
  la.load(a, lda, m0, M, 0, tid);
  lb.load(b, ldb, n0, N, 0, tid);
  la.store(As[0], tid);
  lb.store(Bs[0], tid);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < KT) {
      la.load(a, lda, m0, M, (kt + 1) * GEMM_BK, tid);
      lb.load(b, ldb, n0, N, (kt + 1) * GEMM_BK, tid);
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int c = ks * 16 + 2 * t4;
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(&As[buf][r][c]);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(&As[buf][r + 8][c]);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(&As[buf][r][c + 8]);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(&As[buf][r + 8][c + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn * 32 + ni * 8 + g;
        bfr[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[buf][n][c]);
        bfr[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[buf][n][c + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_16816(acc[mi][ni], af[mi], bfr[ni]);
    }
    if (kt + 1 < KT) {
      la.store(As[buf ^ 1], tid);
      lb.store(Bs[buf ^ 1], tid);
    }
    __syncthreads();
  }

  const size_t zo = (size_t)z * ep.sz;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 32 + mi * 16 + g + half * 8;
        const int col = n0 + wn * 32 + ni * 8 + 2 * t4;
        if (row >= M || col >= N) continue;
        const size_t o = zo + (size_t)row * ep.ld + col;
        float v[2] = {acc[mi][ni][half * 2], acc[mi][ni][half * 2 + 1]};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          v[j] *= ep.alpha;
          if (ep.bias && ep.out)
            v[j] = rb(rb(v[j]) + rb(ep.bias[col + j]));
          else if (ep.bias)
            v[j] += ep.bias[col + j];
          if (ep.relu) v[j] = fmaxf(v[j], 0.f);
          if (ep.mask && !(to_f32(ep.mask[o + j]) > 0.f)) v[j] = 0.f;
          if (ep.res) v[j] += to_f32(ep.res[o + j]);
        }
        if (ep.out)
          *reinterpret_cast<__nv_bfloat162*>(ep.out + o) =
              __floats2bfloat162_rn(v[0], v[1]);
        if (ep.out32)
          *reinterpret_cast<float2*>(ep.out32 + o) = make_float2(v[0], v[1]);
      }
}

template <bool TA, bool TB>
static void bgemm(const bf16* A, int lda, long sAz, const bf16* B, int ldb,
                  long sBz, int M, int N, int K, int Z, const BEpi& ep,
                  cudaStream_t stream) {
  dim3 grid((N + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM, Z);
  bgemm_kernel<TA, TB><<<grid, GEMM_THREADS, 0, stream>>>(A, lda, sAz, B, ldb,
                                                          sBz, M, N, K, ep);
}

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

// exact row softmax of f32 scores: p = exp(s - max) / sum, stored as f32
// (p32, optional) and bf16 (pb). One block per row.
__global__ void __launch_bounds__(ROW_THREADS)
softmax_rows_kernel(const float* __restrict__ s, float* p32, bf16* pb, int n) {
  __shared__ float red[ROW_THREADS / 32];
  const size_t row = blockIdx.x;
  const float* sr = s + row * n;
  float m = -INFINITY;
  for (int i = threadIdx.x; i < n; i += ROW_THREADS) m = fmaxf(m, sr[i]);
  m = block_reduce(m, red, true);
  float t = 0.f;
  for (int i = threadIdx.x; i < n; i += ROW_THREADS) t += expf(sr[i] - m);
  t = block_reduce(t, red, false);
  for (int i = threadIdx.x; i < n; i += ROW_THREADS) {
    const float p = expf(sr[i] - m) / t;
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

// LayerNorm backward over rows of C = 256 (a warp per row, 8 values per
// lane): with xhat, rinv recomputed from x in f32 and dxh = dy * w,
//   dx = rinv * (dxh - mean(dxh) - xhat * mean(dxh * xhat)) + g
// stored as f32 (dx32) and/or bf16 (dxb); g is an f32 (g32) or bf16 (gb)
// gradient added on top, or none. stats[row] = (mean, rinv) for the column
// sums of the LayerNorm's weight gradient.
constexpr int LNB_C = 256;

__global__ void __launch_bounds__(128)
ln_bwd_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ dy, const float* g32,
                   const bf16* gb, float* dx32, bf16* dxb, float2* stats,
                   int rows, float eps) {
  const size_t row = (size_t)blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (size_t)rows) return;
  constexpr int PER = LNB_C / 32;
  float xv[PER], dv[PER];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    xv[i] = to_f32(x[row * LNB_C + c]);
    s += xv[i];
  }
  const float mu = warp_sum(s) / LNB_C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const float d = xv[i] - mu;
    q += d * d;
  }
  const float rinv = rsqrtf(warp_sum(q) / LNB_C + eps);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    xv[i] = (xv[i] - mu) * rinv;                       // xhat
    dv[i] = dy[row * LNB_C + c] * w[c];                // dxh
    s1 += dv[i];
    s2 += dv[i] * xv[i];
  }
  const float m1 = warp_sum(s1) / LNB_C, m2 = warp_sum(s2) / LNB_C;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    float o = rinv * (dv[i] - m1 - xv[i] * m2);
    if (g32) o += g32[row * LNB_C + c];
    if (gb) o += to_f32(gb[row * LNB_C + c]);
    if (dx32) dx32[row * LNB_C + c] = o;
    if (dxb) dxb[row * LNB_C + c] = to_bf16(o);
  }
  if (lane == 0) stats[row] = make_float2(mu, rinv);
}

// per-object column sums (f32 partials): for z in [0, Z), column c,
//   part[z * pstride + c] = sum over the object's rows r of
//       a(r, c) [* (x(r, c) - mean_r) * rinv_r when x is given]
// a is f32 (a32) or bf16 (ab) with row stride lda; x has row stride C.
__global__ void colsum_kernel(const float* a32, const bf16* ab, int lda,
                              const bf16* x, const float2* stats, int rows,
                              int C, float* part, long pstride) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y;
  if (c >= C) return;
  float s = 0.f;
  for (int i = 0; i < rows; ++i) {
    const size_t r = (size_t)z * rows + i;
    float v = a32 ? a32[r * lda + c] : to_f32(ab[r * lda + c]);
    if (x) {
      const float2 st = stats[r];
      v *= (to_f32(x[r * C + c]) - st.x) * st.y;
    }
    s += v;
  }
  part[(size_t)z * pstride + c] = s;
}

static void colsum(const float* a32, const bf16* ab, int lda, const bf16* x,
                   const float2* stats, int rows, int C, int Z, float* part,
                   long pstride, cudaStream_t stream) {
  dim3 grid((C + 127) / 128, Z);
  colsum_kernel<<<grid, 128, 0, stream>>>(a32, ab, lda, x, stats, rows, C,
                                          part, pstride);
}

// out[i] = sum over z = 0 .. Z-1, in that order, of part[z * n + i]
__global__ void reduce_partials_kernel(const float* __restrict__ part, int Z,
                                       long n, float* __restrict__ out) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < Z; ++z) s += part[(size_t)z * n + i];
    out[i] = s;
  }
}

static void reduce_partials(const float* part, int Z, long n, float* out,
                            cudaStream_t stream) {
  const long blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
  reduce_partials_kernel<<<(int)blocks, 256, 0, stream>>>(part, Z, n, out);
}

// ---------------------------------------------------------------------------
// Workspace: one allocation from the caller, carved in a fixed order (the
// size query runs the same carving on a null base).
// ---------------------------------------------------------------------------

struct Arena {
  char* base;
  size_t off;
  template <class T>
  T* take(size_t n) {
    const size_t o = (off + 255) & ~(size_t)255;
    off = o + n * sizeof(T);
    return base ? reinterpret_cast<T*>(base + o) : nullptr;
  }
};

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
// probabilities (pb bf16; p32 when given), o, out = x + o Wo^T + bo
static void self_forward_core(const bf16* x, const void* const* w,
                              const float* cosv, const float* sinv,
                              bf16* out, SelfBufs& b, float* p32, int N,
                              int L, cudaStream_t st) {
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
  softmax_rows_kernel<<<NL, ROW_THREADS, 0, st>>>(b.s, p32, b.pb, L);
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

extern "C" int memattn_self_fwd(const void* x, const void* const* w,
                                const void* cosv, const void* sinv, void* out,
                                void* q3, void* ws, int N, int L,
                                void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  Arena ar{static_cast<char*>(ws), 0};
  SelfBufs b = carve_self(ar, N, L, false);
  const float* cs = static_cast<const float*>(cosv);
  const float* sn = static_cast<const float*>(sinv);
  const int NL = N * L, D = D_MODEL;
  bf16* o = static_cast<bf16*>(out);
  self_forward_core(static_cast<const bf16*>(x), w, cs, sn, o, b, nullptr, N,
                    L, st);
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
                                void* grads, void* ws, int N, int L,
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
  self_forward_core(x, w, cs, sn, out, b, b.p32, N, L, st);
  layer_norm<bf16>(out, b.y2, F(S_LN2W), F(S_LN2B), NL, D, 1, LN_EPS, 0, st);

  // ---- q3 = rope(qc_proj(LN2(out))) backward
  rope(dq3, D, b.dqc, D, cs, sn, NL, L, D, 1, st);
  BEpi e = bepi(D, SG_TOTAL);
  e.out32 = P + SG_WQC;            // dWqc[o][i] = sum_l dqc[l][o] y2[l][i]
  bgemm<true, true>(b.dqc, D, LD, b.y2, D, LD, D, D, L, N, e, st);
  colsum(nullptr, b.dqc, D, nullptr, nullptr, L, D, N, P + SG_BQC, SG_TOTAL,
         st);
  e = bepi(D);
  e.out32 = b.dy32;                // dy2 = dqc Wqc
  bgemm<false, true>(b.dqc, D, 0, W(S_WQC), D, 0, NL, D, D, 1, e, st);
  ln_bwd_rows_kernel<<<(NL + 3) / 4, 128, 0, st>>>(
      out, F(S_LN2W), b.dy32, nullptr, dout, b.dout32, b.doutc, b.st2, NL,
      LN_EPS);
  colsum(b.dy32, nullptr, D, out, b.st2, L, D, N, P + SG_LN2W, SG_TOTAL, st);
  colsum(b.dy32, nullptr, D, nullptr, nullptr, L, D, N, P + SG_LN2B, SG_TOTAL,
         st);

  // ---- out-proj backward
  colsum(b.dout32, nullptr, D, nullptr, nullptr, L, D, N, P + SG_BO, SG_TOTAL,
         st);
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
  colsum(nullptr, b.dqkv, D3, nullptr, nullptr, L, D3, N, P + SG_BQKV,
         SG_TOTAL, st);
  e = bepi(D);
  e.out32 = b.dxn32;               // dxn = dqkv Wqkv
  bgemm<false, true>(b.dqkv, D3, 0, W(S_WQKV), D, 0, NL, D, D3, 1, e, st);
  ln_bwd_rows_kernel<<<(NL + 3) / 4, 128, 0, st>>>(
      x, F(S_LN1W), b.dxn32, b.dout32, nullptr, nullptr,
      static_cast<bf16*>(dx), b.st1, NL, LN_EPS);
  colsum(b.dxn32, nullptr, D, x, b.st1, L, D, N, P + SG_LN1W, SG_TOTAL, st);
  colsum(b.dxn32, nullptr, D, nullptr, nullptr, L, D, N, P + SG_LN1B,
         SG_TOTAL, st);

  // ---- the objects' partials, added in order
  reduce_partials(P, N, SG_TOTAL, static_cast<float*>(grads), st);
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
  colsum(b.dm1_32, nullptr, HID, nullptr, nullptr, L, HID, N, P + G.b1,
         G.total, st);
  e = bepi(D, G.total);
  e.out32 = P + G.w1;              // dW1 = dm1^T h
  bgemm<true, true>(b.dm1, HID, LH, b.h, D, LD, HID, D, L, N, e, st);
  e = bepi(HID, G.total);
  e.out32 = P + G.w2;              // dW2 = g^T r
  bgemm<true, true>(g, D, LD, b.r, HID, LH, D, HID, L, N, e, st);
  colsum(nullptr, g, D, nullptr, nullptr, L, D, N, P + G.b2, G.total, st);
  e = bepi(D);
  e.out32 = b.dh32;                // dh = dm1 W1
  bgemm<false, true>(b.dm1, HID, 0, W(T_W1), D, 0, NL, D, HID, 1, e, st);

  // ---- LN3 backward + residual: dz = g + LN3'(dh)
  ln_bwd_rows_kernel<<<(NL + 3) / 4, 128, 0, st>>>(
      b.z, F(T_LN3W), b.dh32, nullptr, g, b.dz32, static_cast<bf16*>(dy),
      b.st3, NL, LN_EPS);
  colsum(b.dh32, nullptr, D, b.z, b.st3, L, D, N, P + G.ln3w, G.total, st);
  colsum(b.dh32, nullptr, D, nullptr, nullptr, L, D, N, P + G.ln3b, G.total,
         st);
  const bf16* dzc = static_cast<const bf16*>(dy);   // dy = bf16(dz)

  // ---- out-proj and v-proj backward
  colsum(b.dz32, nullptr, D, nullptr, nullptr, L, D, N, P + G.bo, G.total,
         st);
  e = bepi(D, G.total);
  e.out32 = P + G.wo;              // dWo = dz^T t
  bgemm<true, true>(dzc, D, LD, b.t, D, LD, D, D, L, N, e, st);
  e = bepi(D);
  e.out = b.dt;                    // dt = dz Wo
  bgemm<false, true>(dzc, D, 0, W(T_WO), D, 0, NL, D, D, 1, e, st);
  colsum(nullptr, b.dt, D, nullptr, nullptr, L, D, N, P + G.bv, G.total, st);
  e = bepi(KV, G.total);
  e.out32 = P + G.wv;              // dWv = dt^T a
  bgemm<true, true>(b.dt, D, LD, a, KV, LK, D, KV, L, N, e, st);
  e = bepi(KV);
  e.out = static_cast<bf16*>(da);  // da = dt Wv
  bgemm<false, true>(b.dt, D, 0, W(T_WV), KV, 0, NL, KV, D, 1, e, st);

  reduce_partials(P, N, G.total, static_cast<float*>(grads), st);
  return (int)cudaGetLastError();
}
