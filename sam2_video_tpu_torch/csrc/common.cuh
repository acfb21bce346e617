// Device code shared by the port's hand-written kernels (sm_90a):
//   - gemm():       tiled bf16 GEMM on mma.sync (m16n8k16, f32 accumulate)
//                   with bias / GELU / per-column scale / residual epilogues,
//                   fed by a pluggable A-tile loader (dense rows, or the
//                   implicit im2col of a 2x2 conv);
//   - layer_norm(): f32 LayerNorm over channel groups (a warp per row when
//                   phases == 1, the memory encoder's phase-packed LN
//                   otherwise), optional exact-erf GELU, bf16 out.
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
