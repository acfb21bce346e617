// Device code shared by the port's hand-written kernels (sm_90a):
//   - bgemm():      the two-way block's batched GEMM (#8) on mma.sync
//                   (m16n8k16, f32 accumulate): either operand read row-
//                   or column-major, so no transpose is ever written, a
//                   ragged last batch along K, and epilogues for the bf16
//                   walk, GELU and its derivative, ReLU masks, residuals
//                   and f32 stores;
//   - colsum(), reduce_cols(): column sums as f32 partials and their
//                   reduction in a fixed order, so weight gradients need
//                   no float atomics and two runs give the same bits;
//   - split2():     f32 values as bf16 hi / lo pairs (#3, #7);
//   - warp_sum(), rb(), gelu_erf() and its derivative: row reductions and
//                   the bf16 walk's pieces;
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

// (a, b) as bf16 pairs: hi = round(a, b), lo = round of the remainders, so
// an f32 value that feeds a tensor-core product does so to ~16 bits as two
// products (hi and lo) instead of to 8
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

constexpr int LN_MAX_C = 1024;         // the widest row a LayerNorm takes

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffff, v, o);
  return v;
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
// That and the epilogue's res32 are compiled in only where a call uses
// them (EXT), so the other callers run the plain kernel.
// ---------------------------------------------------------------------------

constexpr int GEMM_BM = 64, GEMM_BN = 64, GEMM_BK = 32;
constexpr int GEMM_LDS = GEMM_BK + 8;   // +8 bf16: conflict-free fragments
constexpr int GEMM_THREADS = 128;       // 4 warps, 2 x 2, 32 x 32 each

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// With a bias and a bf16 store the epilogue walks the compute dtype as the
// JAX kernels do (ops/common.py linear): round(acc), + round(bias), round,
// ReLU, + residual, round. The ReLU backward reads its mask from the
// rounded pre-activation, so the walk must match the plain version's.
struct BEpi {
  float alpha;          // acc *= alpha
  const float* bias;    // [N] or null, added after alpha
  int relu;             // max(v, 0) after the bias
  const bf16* mask;     // v = mask(m, n) > 0 ? v : 0, or null
  const bf16* res;      // v += res(m, n), or null
  const float* res32;   // v += res32(m, n), or null (last)
  bf16* out;            // bf16 store, or null
  float* out32;         // f32 store, or null
  long sz;              // batch stride of mask/res/res32/out/out32
  int ld;               // their row stride
};

static inline BEpi bepi(int ld, long sz = 0) {
  BEpi e;
  e.alpha = 1.f;
  e.bias = nullptr;
  e.relu = 0;
  e.mask = nullptr;
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
          if (ep.relu) v[j] = fmaxf(v[j], 0.f);
          if (ep.mask && !(to_f32(ep.mask[o + j]) > 0.f)) v[j] = 0.f;
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
  if (Klast > 0 || ep.res32)
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
