// Device code shared by the port's hand-written kernels (sm_90a):
//   - gemm():       tiled bf16 GEMM on mma.sync (m16n8k16, f32 accumulate)
//                   with bias / GELU / per-column scale / residual epilogues,
//                   fed by a pluggable A-tile loader (dense rows, or the
//                   implicit im2col of a 2x2 conv);
//   - layer_norm(): f32 LayerNorm over channel groups (a warp per row when
//                   phases == 1, the memory encoder's phase-packed LN
//                   otherwise), optional exact-erf GELU, bf16 out;
//   - bgemm():      the backward passes' batched GEMM: either operand read
//                   row- or column-major, so no transpose is ever written,
//                   a ragged last batch along K, and epilogues for the
//                   bf16 walk, GELU and its derivative, ReLU masks,
//                   residuals and f32 stores;
//   - ln_bwd():     the LayerNorm backward, a warp per row;
//   - colsum(), reduce_cols(): column sums as f32
//                   partials and their reduction in a fixed order, so
//                   weight gradients need no float atomics and two runs
//                   give the same bits;
//   - Arena:        carving of one caller-allocated workspace.
// Every routine launches on the caller's stream and allocates nothing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16(v); }

// exact (erf) GELU, torch nn.GELU's default
__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// ---------------------------------------------------------------------------
// GEMM: out[M, N] = epilogue(A[M, K] @ W[N, K]^T), bf16 in/out, f32 acc.
// Requirements (checked by the host wrappers): K % 32 == 0, N % 8 == 0,
// 16-byte aligned rows.
// ---------------------------------------------------------------------------

struct Epilogue {
  const float* bias;      // [N] or null
  const float* scale;     // [N] or null: v *= scale (after bias, GELU)
  const bf16* residual;   // [M, N] or null: v += residual (last)
  int gelu;               // apply exact GELU after the bias
};

// A rows read straight from a row-major [M, lda] matrix.
struct DenseA {
  const bf16* a;
  int lda;
  __device__ __forceinline__ uint4 load(int m, int k, int M) const {
    if (m >= M) return make_uint4(0, 0, 0, 0);
    return *reinterpret_cast<const uint4*>(a + (size_t)m * lda + k);
  }
};

// Implicit im2col of a 2x2 conv with zero padding ((1, 0), (1, 0)) over
// x [N, h, w, C]: row m = (n, i, j), column k = tap * C + c with
// tap = 2a + b reading x[n, i + a - 1, j + b - 1, c].
struct Conv2x2A {
  const bf16* x;
  int h, w, C;
  __device__ __forceinline__ uint4 load(int m, int k, int M) const {
    if (m >= M) return make_uint4(0, 0, 0, 0);
    const int tap = k / C, c = k - tap * C;
    const int j = m % w, t = m / w;
    const int i = t % h, n = t / h;
    const int ii = i + (tap >> 1) - 1, jj = j + (tap & 1) - 1;
    if (ii < 0 || jj < 0) return make_uint4(0, 0, 0, 0);
    return *reinterpret_cast<const uint4*>(
        x + (((size_t)n * h + ii) * w + jj) * C + c);
  }
};

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int GEMM_BM = 64, GEMM_BN = 64, GEMM_BK = 32;
constexpr int GEMM_LDS = GEMM_BK + 8;   // +8 bf16: conflict-free fragments
constexpr int GEMM_THREADS = 128;       // 4 warps, 2 x 2, 32 x 32 each

template <class ALoader>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_bf16_kernel(ALoader A, const bf16* __restrict__ W, bf16* __restrict__ out,
                 int M, int N, int K, Epilogue ep) {
  __shared__ __align__(16) bf16 As[2][GEMM_BM][GEMM_LDS];
  __shared__ __align__(16) bf16 Bs[2][GEMM_BN][GEMM_LDS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * GEMM_BM, n0 = blockIdx.x * GEMM_BN;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // each thread stages two 16-byte chunks of the A tile and of the W tile
  uint4 ra[2], rb[2];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * GEMM_THREADS;
      const int r = c >> 2, kc = (c & 3) * 8;
      ra[i] = A.load(m0 + r, k0 + kc, M);
      const int n = n0 + r;
      rb[i] = n < N ? *reinterpret_cast<const uint4*>(W + (size_t)n * K + k0 + kc)
                    : make_uint4(0, 0, 0, 0);
    }
  };
  auto store_tile = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * GEMM_THREADS;
      const int r = c >> 2, kc = (c & 3) * 8;
      *reinterpret_cast<uint4*>(&As[buf][r][kc]) = ra[i];
      *reinterpret_cast<uint4*>(&Bs[buf][r][kc]) = rb[i];
    }
  };

  const int KT = K / GEMM_BK;
  load_tile(0);
  store_tile(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < KT) load_tile((kt + 1) * GEMM_BK);   // in flight during mma
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
    if (kt + 1 < KT) store_tile(buf ^ 1);
    __syncthreads();
  }

  // epilogue: two adjacent columns per fragment half, stored as a bf16 pair
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 32 + mi * 16 + g + half * 8;
        const int col = n0 + wn * 32 + ni * 8 + 2 * t4;
        if (row >= M || col >= N) continue;
        float v[2] = {acc[mi][ni][half * 2], acc[mi][ni][half * 2 + 1]};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (ep.bias) v[j] += ep.bias[col + j];
          if (ep.gelu) v[j] = gelu_erf(v[j]);
          if (ep.scale) v[j] *= ep.scale[col + j];
          if (ep.residual) v[j] += to_f32(ep.residual[(size_t)row * N + col + j]);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
}

template <class ALoader>
static void gemm(ALoader A, const bf16* W, bf16* out, int M, int N, int K,
                 Epilogue ep, cudaStream_t stream) {
  dim3 grid((N + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM);
  gemm_bf16_kernel<ALoader><<<grid, GEMM_THREADS, 0, stream>>>(A, W, out, M, N,
                                                               K, ep);
}

static inline Epilogue epi(const float* bias, int gelu = 0,
                           const float* scale = nullptr,
                           const bf16* residual = nullptr) {
  Epilogue e;
  e.bias = bias;
  e.gelu = gelu;
  e.scale = scale;
  e.residual = residual;
  return e;
}

// ---------------------------------------------------------------------------
// LayerNorm over whole rows (phases == 1, C <= 1024): one warp per row, the
// row in registers, two-pass mean / variance in f32.
// ---------------------------------------------------------------------------

constexpr int LN_ROWS_PER_BLOCK = 4;
constexpr int LN_MAX_C = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffff, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(32 * LN_ROWS_PER_BLOCK)
layer_norm_rows_kernel(const T* __restrict__ x, bf16* __restrict__ y,
                       const float* __restrict__ w,
                       const float* __restrict__ b, int rows, int C,
                       float eps, int gelu) {
  const size_t row = (size_t)blockIdx.x * LN_ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (size_t)rows) return;
  const T* xr = x + row * C;
  float v[LN_MAX_C / 32];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAX_C / 32; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < C ? to_f32(xr[c]) : 0.f;
    s += v[i];
  }
  const float mu = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAX_C / 32; ++i) {
    const int c = lane + 32 * i;
    const float d = c < C ? v[i] - mu : 0.f;
    q += d * d;
  }
  const float rs = rsqrtf(warp_sum(q) / C + eps);
#pragma unroll
  for (int i = 0; i < LN_MAX_C / 32; ++i) {
    const int c = lane + 32 * i;
    if (c < C) {
      float o = (v[i] - mu) * rs * w[c] + b[c];
      if (gelu) o = gelu_erf(o);
      y[row * C + c] = to_bf16(o);
    }
  }
}

// ---------------------------------------------------------------------------
// LayerNorm over channel groups: row of `lanes` values, lane = c * phases + p;
// statistics over c for each phase p (two-pass mean / variance in f32),
// y = (x - mu) * rsqrt(var + eps) * w[c] + b[c], optional GELU, bf16 out.
// One block of LN_THREADS per row; phases must be a power of two <= 128.
// ---------------------------------------------------------------------------

constexpr int LN_THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
layer_norm_kernel(const T* __restrict__ x, bf16* __restrict__ y,
                  const float* __restrict__ w, const float* __restrict__ b,
                  int lanes, int phases, float eps, int gelu) {
  extern __shared__ float ln_smem[];
  float* xs = ln_smem;             // [lanes]
  float* red = ln_smem + lanes;    // [LN_THREADS]
  const size_t row = blockIdx.x;
  const T* xr = x + row * lanes;
  for (int i = threadIdx.x; i < lanes; i += LN_THREADS) xs[i] = to_f32(xr[i]);
  __syncthreads();

  const int tpg = LN_THREADS / phases;          // threads per group
  const int p = threadIdx.x / tpg, l = threadIdx.x % tpg;
  const int C = lanes / phases;

  float s = 0.f;
  for (int c = l; c < C; c += tpg) s += xs[c * phases + p];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int st = tpg >> 1; st > 0; st >>= 1) {
    if (l < st) red[threadIdx.x] += red[threadIdx.x + st];
    __syncthreads();
  }
  const float mu = red[p * tpg] / C;
  __syncthreads();

  float v = 0.f;
  for (int c = l; c < C; c += tpg) {
    const float d = xs[c * phases + p] - mu;
    v += d * d;
  }
  red[threadIdx.x] = v;
  __syncthreads();
  for (int st = tpg >> 1; st > 0; st >>= 1) {
    if (l < st) red[threadIdx.x] += red[threadIdx.x + st];
    __syncthreads();
  }
  const float rs = rsqrtf(red[p * tpg] / C + eps);

  for (int c = l; c < C; c += tpg) {
    const int i = c * phases + p;
    float o = (xs[i] - mu) * rs * w[c] + b[c];
    if (gelu) o = gelu_erf(o);
    y[row * lanes + i] = to_bf16(o);
  }
}

template <typename T>
static void layer_norm(const T* x, bf16* y, const float* w, const float* b,
                       int rows, int lanes, int phases, float eps, int gelu,
                       cudaStream_t stream) {
  if (phases == 1 && lanes <= LN_MAX_C) {
    const int blocks = (rows + LN_ROWS_PER_BLOCK - 1) / LN_ROWS_PER_BLOCK;
    layer_norm_rows_kernel<T><<<blocks, 32 * LN_ROWS_PER_BLOCK, 0, stream>>>(
        x, y, w, b, rows, lanes, eps, gelu);
    return;
  }
  const size_t smem = (size_t)(lanes + LN_THREADS) * sizeof(float);
  layer_norm_kernel<T><<<rows, LN_THREADS, smem, stream>>>(x, y, w, b, lanes,
                                                           phases, eps, gelu);
}

// ---------------------------------------------------------------------------
// LayerNorm backward over rows of C <= LN_MAX_C (a warp per row, PER values
// per lane): with xhat, rinv recomputed from x in f32 and dxh = dy * w,
//   dx = rinv * (dxh - mean(dxh) - xhat * mean(dxh * xhat)) [+ g]
// with g an f32 (g32) or bf16 (gb) gradient added on top, or none, stored
// as f32 (dx32) and/or bf16 (dxb); stats[row] = (mean, rinv) for the
// column sums of the LayerNorm's weight gradient.
// ---------------------------------------------------------------------------

template <int PER>
__global__ void __launch_bounds__(128)
ln_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ dy, const float* g32, const bf16* gb,
              float* dx32, bf16* dxb, float2* stats, int rows, int C,
              float eps) {
  const size_t row = (size_t)blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (size_t)rows) return;
  float xv[PER], dv[PER];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    xv[i] = c < C ? to_f32(x[row * C + c]) : 0.f;
    s += xv[i];
  }
  const float mu = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    const float d = c < C ? xv[i] - mu : 0.f;
    q += d * d;
  }
  const float rinv = rsqrtf(warp_sum(q) / C + eps);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    xv[i] = (xv[i] - mu) * rinv;                       // xhat
    dv[i] = c < C ? dy[row * C + c] * w[c] : 0.f;      // dxh
    s1 += dv[i];
    s2 += dv[i] * xv[i];
  }
  const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    if (c >= C) continue;
    float o = rinv * (dv[i] - m1 - xv[i] * m2);
    if (g32) o += g32[row * C + c];
    if (gb) o += to_f32(gb[row * C + c]);
    if (dx32) dx32[row * C + c] = o;
    if (dxb) dxb[row * C + c] = to_bf16(o);
  }
  if (lane == 0) stats[row] = make_float2(mu, rinv);
}

static void ln_bwd(const bf16* x, const float* w, const float* dy,
                   const float* g32, const bf16* gb, float* dx32, bf16* dxb,
                   float2* stats, int rows, int C, float eps,
                   cudaStream_t stream) {
  const int blocks = (rows + 3) / 4;
  if (C <= 256)
    ln_bwd_kernel<8><<<blocks, 128, 0, stream>>>(x, w, dy, g32, gb, dx32, dxb,
                                                 stats, rows, C, eps);
  else if (C <= 512)
    ln_bwd_kernel<16><<<blocks, 128, 0, stream>>>(x, w, dy, g32, gb, dx32,
                                                  dxb, stats, rows, C, eps);
  else
    ln_bwd_kernel<LN_MAX_C / 32><<<blocks, 128, 0, stream>>>(
        x, w, dy, g32, gb, dx32, dxb, stats, rows, C, eps);
}

// ---------------------------------------------------------------------------
// Batched GEMM on mma.sync: for z in [0, Z):
//   C[z](M x N) = epilogue(alpha * sum_k A[z](m, k) * B[z](n, k))
// A(m, k) lies at a + z*sAz + m*lda + k (TA = false) or + k*lda + m (TA);
// B(n, k) at b + z*sBz + n*ldb + k (TB = false) or + k*ldb + n (TB).
// Needs M, N % 8 == 0, K % 32 == 0, lda, ldb % 8 == 0 (checked by the
// wrappers). With Klast > 0 the last batch sums only its first Klast
// values of k (Klast % 8 == 0 where an operand is read row-major): a
// reduction over M rows cut into batches of K rows, the last one ragged.
// That and the epilogue's pre / gelu / dgelu / res32 (kernel #6's) are
// compiled in only where a call uses them (EXT), so the other callers run
// the plain kernel.
// ---------------------------------------------------------------------------

// With a bias and a bf16 store the epilogue walks the compute dtype as the
// JAX kernels do (ops/common.py linear): round(acc), + round(bias), round,
// ReLU, + residual, round. The ReLU backward reads its mask from the
// rounded pre-activation, so the walk must match the plain version's.
struct BEpi {
  float alpha;          // acc *= alpha
  const float* bias;    // [N] or null, added after alpha
  bf16* pre;            // bf16 store of the value after the bias, or null
  int gelu;             // exact GELU after the bias (and the pre store)
  int relu;             // max(v, 0) after the bias
  const bf16* mask;     // v = mask(m, n) > 0 ? v : 0, or null
  const bf16* dgelu;    // v *= GELU'(dgelu(m, n)), or null
  const bf16* res;      // v += res(m, n), or null
  const float* res32;   // v += res32(m, n), or null (last)
  bf16* out;            // bf16 store, or null
  float* out32;         // f32 store, or null
  long sz;              // batch stride of pre/mask/dgelu/res/res32/out/out32
  int ld;               // their row stride
};

static inline BEpi bepi(int ld, long sz = 0) {
  BEpi e;
  e.alpha = 1.f;
  e.bias = nullptr;
  e.pre = nullptr;
  e.gelu = 0;
  e.relu = 0;
  e.mask = nullptr;
  e.dgelu = nullptr;
  e.res = nullptr;
  e.res32 = nullptr;
  e.out = nullptr;
  e.out32 = nullptr;
  e.sz = sz;
  e.ld = ld;
  return e;
}

// stage one 64 x 32 tile (rows r of the operand, k in [k0, k0 + 32)) as two
// 16-byte chunks per thread; `trans` reads the operand stored k-major.
// With RAGGED, values of k at or past K read as zeros.
template <bool TRANS, bool RAGGED>
struct TileLoad {
  uint4 v[2];
  __device__ __forceinline__ void load(const bf16* p, int ld, int r0, int R,
                                       int k0, int K, int tid) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * GEMM_THREADS;
      if (!TRANS) {
        const int r = c >> 2, kc = (c & 3) * 8;
        v[i] = r0 + r < R && (!RAGGED || k0 + kc < K)
                   ? *reinterpret_cast<const uint4*>(
                         p + (size_t)(r0 + r) * ld + k0 + kc)
                   : make_uint4(0, 0, 0, 0);
      } else {
        const int kr = c >> 3, rc = (c & 7) * 8;
        v[i] = r0 + rc < R && (!RAGGED || k0 + kr < K)
                   ? *reinterpret_cast<const uint4*>(
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

// d/dx of exact-erf GELU: Phi(x) + x phi(x)
__device__ __forceinline__ float gelu_erf_grad(float v) {
  return 0.5f * (1.0f + erff(v * 0.70710678118654752f)) +
         v * expf(-0.5f * v * v) * 0.39894228040143268f;
}

template <bool TA, bool TB, bool EXT>
__global__ void __launch_bounds__(GEMM_THREADS)
bgemm_kernel(const bf16* __restrict__ A, int lda, long sAz,
             const bf16* __restrict__ B, int ldb, long sBz, int M, int N,
             int K, int Klast, BEpi ep) {
  __shared__ __align__(16) bf16 As[2][GEMM_BM][GEMM_LDS];
  __shared__ __align__(16) bf16 Bs[2][GEMM_BN][GEMM_LDS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * GEMM_BM, n0 = blockIdx.x * GEMM_BN;
  const int z = blockIdx.z;
  const bf16* a = A + (size_t)z * sAz;
  const bf16* b = B + (size_t)z * sBz;
  const int Kz = (EXT && Klast > 0 && z == (int)gridDim.z - 1) ? Klast : K;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  TileLoad<TA, EXT> la;
  TileLoad<TB, EXT> lb;
  const int KT = (Kz + GEMM_BK - 1) / GEMM_BK;
  la.load(a, lda, m0, M, 0, Kz, tid);
  lb.load(b, ldb, n0, N, 0, Kz, tid);
  la.store(As[0], tid);
  lb.store(Bs[0], tid);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < KT) {
      la.load(a, lda, m0, M, (kt + 1) * GEMM_BK, Kz, tid);
      lb.load(b, ldb, n0, N, (kt + 1) * GEMM_BK, Kz, tid);
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
          if (EXT && ep.pre) ep.pre[o + j] = to_bf16(v[j]);
          if (EXT && ep.gelu) v[j] = gelu_erf(v[j]);
          if (ep.relu) v[j] = fmaxf(v[j], 0.f);
          if (ep.mask && !(to_f32(ep.mask[o + j]) > 0.f)) v[j] = 0.f;
          if (EXT && ep.dgelu) v[j] *= gelu_erf_grad(to_f32(ep.dgelu[o + j]));
          if (ep.res) v[j] += to_f32(ep.res[o + j]);
          if (EXT && ep.res32) v[j] += ep.res32[o + j];
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
                  cudaStream_t stream, int Klast = 0) {
  dim3 grid((N + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM, Z);
  if (Klast > 0 || ep.pre || ep.gelu || ep.dgelu || ep.res32)
    bgemm_kernel<TA, TB, true><<<grid, GEMM_THREADS, 0, stream>>>(
        A, lda, sAz, B, ldb, sBz, M, N, K, Klast, ep);
  else
    bgemm_kernel<TA, TB, false><<<grid, GEMM_THREADS, 0, stream>>>(
        A, lda, sAz, B, ldb, sBz, M, N, K, 0, ep);
}

// ---------------------------------------------------------------------------
// Column sums and their ordered reduction
// ---------------------------------------------------------------------------

// column sums as f32 partials over chunks of `rows` rows: for chunk z and
// column c,
//   part[z * pstride + c] = sum over the rows r < total of the chunk of
//       a(r, c) [* (x(r, c) - mean_r) * rinv_r when x is given]
// a is f32 (a32) or bf16 (ab) with row stride lda; x has row stride C.
// 8 lanes per column each add every 8th row of the chunk in order, then
// lane 0 adds the 8 lane sums in order: the order is fixed by the thread
// layout, and a chunk's sum does not wait on `rows` dependent loads.
constexpr int CS_COLS = 32, CS_LANES = 8;

__global__ void __launch_bounds__(CS_COLS * CS_LANES)
colsum_kernel(const float* a32, const bf16* ab, int lda, const bf16* x,
              const float2* stats, long rows, long total, int C, float* part,
              long pstride) {
  __shared__ float red[CS_LANES][CS_COLS];
  const int c = blockIdx.x * CS_COLS + threadIdx.x, ly = threadIdx.y;
  const long r0 = (long)blockIdx.y * rows;
  float s = 0.f;
  if (c < C) {
#pragma unroll 4
    for (long i = ly; i < rows; i += CS_LANES) {
      const long r = r0 + i;
      if (r >= total) break;
      float v = a32 ? a32[r * lda + c] : to_f32(ab[r * lda + c]);
      if (x) {
        const float2 st = stats[r];
        v *= (to_f32(x[r * C + c]) - st.x) * st.y;
      }
      s += v;
    }
  }
  red[ly][threadIdx.x] = s;
  __syncthreads();
  if (ly == 0 && c < C) {
    float t = 0.f;
#pragma unroll
    for (int l = 0; l < CS_LANES; ++l) t += red[l][threadIdx.x];
    part[(size_t)blockIdx.y * pstride + c] = t;
  }
}

static void colsum(const float* a32, const bf16* ab, int lda, const bf16* x,
                   const float2* stats, long rows, long total, int C,
                   float* part, long pstride, cudaStream_t stream) {
  const dim3 grid((C + CS_COLS - 1) / CS_COLS,
                  (unsigned)((total + rows - 1) / rows));
  colsum_kernel<<<grid, dim3(CS_COLS, CS_LANES), 0, stream>>>(
      a32, ab, lda, x, stats, rows, total, C, part, pstride);
}

// out[i] = the sum over z = 0 .. Z-1 of part[z * n + i] in a fixed order:
// 8 lanes per column each add every 8th partial in order, then lane 0 adds
// the 8 lane sums in order (for Z <= 8 that is z = 0, 1, ... in turn). The
// order is fixed by the thread layout alone.
constexpr int RC_COLS = 32, RC_LANES = 8;

__global__ void __launch_bounds__(RC_COLS * RC_LANES)
reduce_cols_kernel(const float* __restrict__ part, int Z, long n,
                   float* __restrict__ out) {
  __shared__ float red[RC_LANES][RC_COLS];
  const long i = (long)blockIdx.x * RC_COLS + threadIdx.x;
  const int ly = threadIdx.y;
  float s = 0.f;
  if (i < n)
    for (int z = ly; z < Z; z += RC_LANES) s += part[(size_t)z * n + i];
  red[ly][threadIdx.x] = s;
  __syncthreads();
  if (ly == 0 && i < n) {
    float t = 0.f;
#pragma unroll
    for (int l = 0; l < RC_LANES; ++l) t += red[l][threadIdx.x];
    out[i] = t;
  }
}

static void reduce_cols(const float* part, int Z, long n, float* out,
                        cudaStream_t stream) {
  const long blocks = (n + RC_COLS - 1) / RC_COLS;
  reduce_cols_kernel<<<(unsigned)blocks, dim3(RC_COLS, RC_LANES), 0, stream>>>(
      part, Z, n, out);
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
