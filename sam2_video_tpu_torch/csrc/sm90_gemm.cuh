// A pipelined batched GEMM for Hopper (sm_90a) on wgmma, for the port's
// row-wise products (the Hiera block forward and backward, #1 and #6, the
// memory encoder, #2, and the memory-attention layer blocks, #4 and #5):
//   C(m, n) = epilogue(sum_k A(m, k) B(n, k)),
// with A(m, k) read from a row-major matrix as a[m lda + k] (K-major) or
// a[k lda + m] (MN-major), B(n, k) as b[n ldb + k] or b[k ldb + n]:
//   - y = x W^T (x rows K-major, W [out, in] K-major),
//   - dx = dy W (W read MN-major, never transposed in memory),
//   - dW = dy^T x (both MN-major: the sum runs over the rows of dy and x).
// Every operand tile is staged by cp.async into the 128-byte-swizzled layout
// that wgmma reads (a transposed operand is read by its descriptor, never
// scattered), through a ring of GM_STAGES stages; a block of one or two
// warpgroups (gemm_group<BM>: 64 or 128 rows) owns BM rows x 128 columns
// of C, each warpgroup 64 rows with m64n128k16 products into f32
// registers.
//
// A weight gradient sums over all rows of all objects in one K loop, cut
// into a fixed number of K chunks (gm_k_splits: from the output tiles and
// K alone); each chunk writes an f32 partial and the caller adds the
// partials in chunk order, so no float atomics and the same bits twice. A
// product whose A is read MN-major can also return A's column sums over
// the chunk's rows (a bias gradient: the rows are already in shared
// memory).
//
// Several independent products with the same block shape run as one launch
// (GemmGroup: up to GM_MAX_OPS, blocks laid out op after op).
//
// The bf16 epilogue walks the compute dtype as the JAX kernels do
// (ops/common.py linear): round(acc), + round(bias), round; or, with
// bias_once, acc + bias in f32 and one rounding (kernel #1's walk, which
// #6 recomputes). It also takes exact-erf GELU after the bias (the value
// before it stored as `pre`), GELU's derivative at a stored pre-activation
// as a factor, a bf16 residual added in f32 before the one rounding (#1's
// proj and W2, #2's 1x1 conv), a second (A, B, K) pair that continues the
// same sum (#6: dxn = dqkv Wqkv + ds Wsc), and, where one column tile
// holds the row (N <= 128), a LayerNorm over the row after the rounded
// bias sum, with optional GELU (#2's third downsampler layer).
//
// A can also be the implicit im2col of a 3x3 / stride-2 / pad-1 conv over
// an NHWC input (conv: #2's downsampler layers 3 and 4): row m = output
// pixel, column k = tap * channels + channel; out-of-image taps are
// cp.async's zero fill.
//
// Beside it, the ordered reduce of the K-split partials (reduce_kernel).
#pragma once

#include "common.cuh"
#include "sm90.cuh"

constexpr int GM_BM = 128;           // rows of C per block (two warpgroups;
                                     // 64: one, three blocks an SM)
constexpr int GM_BN = 128;           // columns of C per block
constexpr int GM_BK = 64;            // K per stage
constexpr int GM_STAGES = 3;         // depth of the cp.async ring
constexpr int GM_MAX_OPS = 4;        // products per grouped launch
constexpr int GM_TARGET_BLOCKS = 132;   // K chunks: about one block per SM
constexpr int GM_MIN_CHUNK = 8;      // ... of at least 8 64-row tiles each
constexpr float GM_LN_EPS = 1e-6f;   // the LayerNorm epilogue's (#2's LN2d)

#define WG_D8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 128] += A B^T, both from shared memory; TA / TB: A / B MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d[64 x 32] (+)= A B^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] (+)= A B: A K-major, B MN-major (its rows are K), both in
// shared memory
__device__ __forceinline__ void wgmma_ss_n64_bmn(float (&d)[32], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 128] += A B^T: A bf16 pairs in registers, B K-major in shared
// memory (its rows are N)
__device__ __forceinline__ void wgmma_rs_n128_k(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d[64 x 32] += A B^T: A bf16 pairs in registers, B K-major in shared
// memory (its rows are N)
__device__ __forceinline__ void wgmma_rs_n32_k(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, 1, 1, 1, 0;\n}\n"
      : WG_D8(0), WG_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// rows r0 .. r0 + ROWS - 1, columns c0 .. c0 + COLS - 1 of a row-major bf16
// matrix (row stride ld) into a ROWS x COLS tile at shared dst, by the NT
// threads of the block: 64-column blocks of ROWS rows x 128 bytes, the
// 16-byte chunk j of row r at chunk j ^ (r % 8) (sm90.cuh's layout for 64
// rows). Rows at and past nrows and columns at and past ncols (a multiple
// of 8) are zero-filled.
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void stage_block(uint32_t dst,
                                            const bf16* __restrict__ src,
                                            long ld, int r0, int nrows,
                                            int c0, int ncols) {
  constexpr int C8 = COLS / 8;
  static_assert(ROWS * C8 % NT == 0, "tile chunks must split evenly");
#pragma unroll
  for (int i = 0; i < ROWS * C8 / NT; ++i) {
    const int e = i * NT + (int)threadIdx.x;
    const int r = e / C8, c = (e % C8) * 8;
    const bool ok = r0 + r < nrows && c0 + c < ncols;
    const uint32_t off = (c >> 6) * (ROWS * 128) + r * 128 +
                         ((((c >> 3) & 7) ^ (r & 7)) << 4);
    cp_async16(dst + off, src + (ok ? (size_t)(r0 + r) * ld + c0 + c : 0),
               ok);
  }
}

struct GemmOp {
  const bf16* a;
  const bf16* b;
  long lda, ldb;
  int M, N, K;
  int ta, tb;            // A / B read MN-major
  // a second product summed into the same accumulator (A K-major, no
  // K split): K2 more values of k from a2 / b2 (K2 = 0: none)
  const bf16* a2;
  const bf16* b2;
  long lda2, ldb2;
  int K2;
  // epilogue: an f32 store (out32) of the sum, or a bf16 store (out) of
  // the sum after bias [N] f32 (bias_once: no rounding before the bias),
  // exact GELU and a factor GELU'(dgelu) (dgelu [M, ldo] bf16), with the
  // value after the bias stored as `pre` [M, ldo] bf16
  const float* bias;
  int bias_once, gelu;
  bf16* pre;
  const bf16* dgelu;
  bf16* out;
  float* out32;
  long ldo;
  // a bf16 residual [M, ldr] added before the rounding (or null)
  const bf16* res;
  long ldr;
  // LayerNorm of each row after round(acc + bias) (N <= GM_BN; then GELU
  // when gelu is set), weight and bias [N] f32 (or null)
  const float* lnw;
  const float* lnb;
  // A as the im2col of a 3x3 / stride-2 / pad-1 conv over a [., ih, iw,
  // ic] bf16 input at a (ic % 8 == 0), output grid oh x ow, K = 9 ic
  int conv, ih, iw, ic, oh, ow;
  // K split: f32 partials [splits][M][N] (about `target` blocks, 0:
  // GM_TARGET_BLOCKS), and with ta the column sums of A [splits][M] (or
  // null)
  float* part;
  float* colsum;
  int target;
  // filled by gemm_group
  int splits, tiles_per_split, mt, nt, first_block;
};

struct GemmGroup {
  GemmOp op[GM_MAX_OPS];
  int n;
};

static inline GemmOp gemm_op(const bf16* a, long lda, int ta, const bf16* b,
                             long ldb, int tb, int M, int N, int K) {
  GemmOp o{};
  o.a = a;
  o.lda = lda;
  o.ta = ta;
  o.b = b;
  o.ldb = ldb;
  o.tb = tb;
  o.M = M;
  o.N = N;
  o.K = K;
  o.ldo = N;
  return o;
}

__host__ __device__ inline int gm_cdiv(long a, long b) {
  return (int)((a + b - 1) / b);
}

// K of an op in whole 64-deep tiles of each of its products
static inline int gm_k_depth(const GemmOp& o) {
  return (gm_cdiv(o.K, GM_BK) + gm_cdiv(o.K2, GM_BK)) * GM_BK;
}

// K chunks of a product with `tiles` output tiles summed over K: about
// `target` blocks, chunks of at least GM_MIN_CHUNK 64-deep tiles, none
// empty. Depends on the shapes only.
static inline int gm_k_splits(int tiles, int K, int* tiles_per_split,
                              int target = GM_TARGET_BLOCKS) {
  const int kt = gm_cdiv(K, GM_BK);
  int s = gm_cdiv(target, tiles);
  const int cap = kt / GM_MIN_CHUNK > 1 ? kt / GM_MIN_CHUNK : 1;
  s = s < cap ? s : cap;
  const int tps = gm_cdiv(kt, s);
  *tiles_per_split = tps;
  return gm_cdiv(kt, tps);
}

// rows r0 .. of the conv's im2col (GemmOp conv), columns c0 .. c0 + COLS
// - 1, into a ROWS x COLS tile at shared dst (stage_block's layout); taps
// outside the input, rows at and past M and columns at and past K are
// zero-filled
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void stage_conv(uint32_t dst, const GemmOp& o,
                                           int r0, int c0) {
  constexpr int C8 = COLS / 8;
  static_assert(ROWS * C8 % NT == 0, "tile chunks must split evenly");
#pragma unroll
  for (int i = 0; i < ROWS * C8 / NT; ++i) {
    const int e = i * NT + (int)threadIdx.x;
    const int r = e / C8, c = (e % C8) * 8;
    const int m = r0 + r, k = c0 + c;
    bool ok = m < o.M && k < o.K;
    size_t at = 0;
    if (ok) {
      const int tap = k / o.ic, ch = k - tap * o.ic;
      const int ox = m % o.ow, t = m / o.ow, oy = t % o.oh, n = t / o.oh;
      const int iy = 2 * oy - 1 + tap / 3, ix = 2 * ox - 1 + tap % 3;
      ok = iy >= 0 && iy < o.ih && ix >= 0 && ix < o.iw;
      at = (((size_t)n * o.ih + iy) * o.iw + ix) * o.ic + ch;
    }
    const uint32_t off = (c >> 6) * (ROWS * 128) + r * 128 +
                         ((((c >> 3) & 7) ^ (r & 7)) << 4);
    cp_async16(dst + off, o.a + (ok ? at : 0), ok);
  }
}

template <int BM>
struct GmSmem {
  static constexpr int A_BYTES = BM * GM_BK * 2;
  static constexpr int B_BYTES = GM_BN * GM_BK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int RED = GM_STAGES * STAGE;
  static_assert(BM * (GM_BN + 4) * 4 <= RED, "epilogue tile fits");
  static constexpr int BYTES = RED + 2 * BM * 4 + 1024;
};

// the optional parts of the kernel (GemmGroup's ops select them; each
// combination is its own instantiation, so the others' registers and code
// are the plain kernel's)
enum { GM_RES = 1, GM_CONV = 2, GM_LN = 4 };

// BM rows of C per block, a warpgroup per 64 rows (2 BM threads); EXT: the
// GM_* parts compiled in
template <int BM, int EXT>
__global__ void __launch_bounds__(2 * BM, BM == GM_BM ? 2 : 3)
gemm_group_kernel(const __grid_constant__ GemmGroup G) {
  using SM = GmSmem<BM>;
  constexpr int NT = 2 * BM;
  extern __shared__ unsigned char gm_smem[];
  unsigned char* gen;
  const uint32_t sm = aligned_smem(gm_smem, &gen);

  int p = 0;
  while (p + 1 < G.n && (int)blockIdx.x >= G.op[p + 1].first_block) ++p;
  // a copy in registers: reads through a reference into the parameter
  // space are generic loads, repeated after every store (it may alias)
  const GemmOp o = G.op[p];
  const int local = blockIdx.x - o.first_block;
  const int split = local / (o.mt * o.nt), rem = local % (o.mt * o.nt);
  const int m0 = (rem / o.nt) * BM, n0 = (rem % o.nt) * GM_BN;
  const int kt1 = gm_cdiv(o.K, GM_BK);
  const int kt_all = kt1 + gm_cdiv(o.K2, GM_BK);
  const int kt0 = split * o.tiles_per_split;
  const int nk = min(kt_all, kt0 + o.tiles_per_split) - kt0;
  const int ta = o.ta, tb = o.tb;
  const bool sums = o.colsum && ta && n0 == 0;

  const int tid = threadIdx.x, wg = tid >> 7;
  auto load = [&](int kt, int st) {
    const uint32_t As = sm + st * SM::STAGE, Bs = As + SM::A_BYTES;
    const bf16 *a = o.a, *b = o.b;
    long lda = o.lda, ldb = o.ldb;
    int K = o.K;
    if (kt >= kt1) {                   // the second product
      a = o.a2, b = o.b2, lda = o.lda2, ldb = o.ldb2, K = o.K2;
      kt -= kt1;
    }
    const int k0 = kt * GM_BK;
    if ((EXT & GM_CONV) && o.conv)
      stage_conv<BM, GM_BK, NT>(As, o, m0, k0);
    else if (!ta)
      stage_block<BM, GM_BK, NT>(As, a, lda, m0, o.M, k0, K);
    else
      stage_block<GM_BK, BM, NT>(As, a, lda, k0, K, m0, o.M);
    if (!tb)
      stage_block<GM_BN, GM_BK, NT>(Bs, b, ldb, n0, o.N, k0, K);
    else
      stage_block<GM_BK, GM_BN, NT>(Bs, b, ldb, k0, K, n0, o.N);
  };
#pragma unroll
  for (int s = 0; s < GM_STAGES - 1; ++s) {
    if (s < nk) load(kt0 + s, s);
    cp_async_commit();
  }

  float acc[64];
  zero(acc);
  float cs = 0.f;                      // A's column tid % BM, half the rows
  const int cs_col = tid % BM, cs_r0 = (tid / BM) * (GM_BK / 2);

  for (int i = 0; i < nk; ++i) {
    cp_async_wait<GM_STAGES - 2>();
    fence_proxy_async();
    __syncthreads();                   // tile i landed, tile i - 1 consumed
    if (i + GM_STAGES - 1 < nk)
      load(kt0 + i + GM_STAGES - 1, (i + GM_STAGES - 1) % GM_STAGES);
    cp_async_commit();

    const int st = i % GM_STAGES;
    const uint32_t As = sm + st * SM::STAGE, Bs = As + SM::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GM_BK / 16; ++kk) {
      if (!ta && !tb)
        wgmma_ss_n128<0, 0>(acc, desc_k(As + wg * 64 * 128, kk * 16),
                            desc_k(Bs, kk * 16));
      else if (!ta)
        wgmma_ss_n128<0, 1>(acc, desc_k(As + wg * 64 * 128, kk * 16),
                            desc_mn(Bs, kk * 16, 0));
      else
        wgmma_ss_n128<1, 1>(acc, desc_mn(As, kk * 16, wg * 64),
                            desc_mn(Bs, kk * 16, 0));
    }
    wgmma_commit();
    if (sums) {                        // rows past K are zero-filled
      const unsigned char* Ag = gen + st * SM::STAGE;
      float a = 0.f;
#pragma unroll 8
      for (int r = cs_r0; r < cs_r0 + GM_BK / 2; ++r)
        a += to_f32(*reinterpret_cast<const bf16*>(Ag + sw128_off(r, cs_col)));
      cs += a;
    }
    wgmma_wait<0>();
    fence_regs(acc);
  }

  if (sums) {
    float* red = reinterpret_cast<float*>(gen + SM::RED);
    red[tid] = cs;
    __syncthreads();
    if (tid < BM && m0 + tid < o.M)
      o.colsum[(size_t)split * o.M + m0 + tid] = red[tid] + red[tid + BM];
  }

  // epilogue through shared memory: the f32 tile staged, then each
  // thread takes 4 (f32) or 8 (bf16) columns of a row at a time, so every
  // global load and store is 16 bytes and whole rows per warp (scattered
  // 8-byte stores of the fragments cost several times more). The bf16
  // loop is not unrolled: the GELU code of 64 unrolled elements was slow
  // even where it did not run.
  __syncthreads();                     // the ring is free
  constexpr int LDS = GM_BN + 4;
  float* tile = reinterpret_cast<float*>(gen);
  {
    const int warp = (tid >> 5) & 3, g = (tid & 31) >> 2, q = tid & 3;
    const int rl = wg * 64 + warp * 16 + g;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n = 0; n < GM_BN / 8; ++n)
        *reinterpret_cast<float2*>(tile + (rl + 8 * h) * LDS + 8 * n + 2 * q) =
            make_float2(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
  }
  __syncthreads();
  if ((EXT & GM_LN) && o.lnw) {        // a warp per row, 4 columns a lane
    const int lane = tid & 31, c = 4 * lane;
    const bool okc = c < o.N;
    float b4[4], w4[4], l4[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b4[j] = okc ? __ldg(o.bias + c + j) : 0.f;
      w4[j] = okc ? __ldg(o.lnw + c + j) : 0.f;
      l4[j] = okc ? __ldg(o.lnb + c + j) : 0.f;
    }
    for (int r = tid >> 5; r < BM && m0 + r < o.M; r += NT / 32) {
      float v[4], s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = okc ? rb(tile[r * LDS + c + j] + b4[j]) : 0.f;
        s += v[j];
      }
      const float mu = warp_sum(s) / o.N;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = okc ? v[j] - mu : 0.f;
        q += d * d;
      }
      const float rs = rsqrtf(warp_sum(q) / o.N + GM_LN_EPS);
      uint2 u;
      bf16* ub = reinterpret_cast<bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float y = (v[j] - mu) * rs * w4[j] + l4[j];
        if (o.gelu) y = gelu_erf(y);
        ub[j] = to_bf16(y);
      }
      if (okc) *reinterpret_cast<uint2*>(o.out + (size_t)(m0 + r) * o.ldo + c) = u;
    }
    return;
  }
  if (o.part || o.out32) {
    float* dst = o.part ? o.part + (size_t)split * o.M * o.N : o.out32;
    const long ld = o.part ? o.N : o.ldo;
#pragma unroll 4
    for (int it = 0; it < BM * GM_BN / 4 / NT; ++it) {
      const int e = it * NT + tid, r = e / (GM_BN / 4), c = (e % (GM_BN / 4)) * 4;
      if (m0 + r < o.M && n0 + c < o.N)
        *reinterpret_cast<float4*>(dst + (size_t)(m0 + r) * ld + n0 + c) =
            *reinterpret_cast<const float4*>(tile + r * LDS + c);
    }
    return;
  }
#pragma unroll 1
  for (int it = 0; it < BM * GM_BN / 8 / NT; ++it) {
    const int e = it * NT + tid, r = e / (GM_BN / 8), c = (e % (GM_BN / 8)) * 8;
    if (m0 + r >= o.M || n0 + c >= o.N) continue;
    const size_t at = (size_t)(m0 + r) * o.ldo + n0 + c;
    float v[8], b[8];
    *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(tile + r * LDS + c);
    *reinterpret_cast<float4*>(v + 4) =
        *reinterpret_cast<const float4*>(tile + r * LDS + c + 4);
    if (o.bias) {
      *reinterpret_cast<float4*>(b) =
          __ldg(reinterpret_cast<const float4*>(o.bias + n0 + c));
      *reinterpret_cast<float4*>(b + 4) =
          __ldg(reinterpret_cast<const float4*>(o.bias + n0 + c + 4));
      if (o.bias_once) {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] += b[j];
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = rb(rb(v[j]) + rb(b[j]));
      }
    }
    uint4 u;
    bf16* ub = reinterpret_cast<bf16*>(&u);
    if (o.pre) {
#pragma unroll
      for (int j = 0; j < 8; ++j) ub[j] = to_bf16(v[j]);
      *reinterpret_cast<uint4*>(o.pre + at) = u;
    }
    if (o.gelu) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = gelu_erf(v[j]);
    }
    if (o.dgelu) {
      const uint4 d = __ldg(reinterpret_cast<const uint4*>(o.dgelu + at));
      const bf16* db = reinterpret_cast<const bf16*>(&d);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] *= gelu_erf_grad(to_f32(db[j]));
    }
    if ((EXT & GM_RES) && o.res) {
      const uint4 rr = __ldg(reinterpret_cast<const uint4*>(
          o.res + (size_t)(m0 + r) * o.ldr + n0 + c));
      const bf16* r8 = reinterpret_cast<const bf16*>(&rr);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] += to_f32(r8[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) ub[j] = to_bf16(v[j]);
    *reinterpret_cast<uint4*>(o.out + at) = u;
  }
}

template <int BM, int EXT>
static int gm_launch(const GemmGroup& G, int blocks, cudaStream_t st) {
  const int smem = GmSmem<BM>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      gemm_group_kernel<BM, EXT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  // the largest shared-memory carve-out, so that two (three) blocks share
  // an SM; by default CUDA may choose a carve-out that fits only one
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gemm_group_kernel<BM, EXT>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  gemm_group_kernel<BM, EXT><<<blocks, 2 * BM, smem, st>>>(G);
  return 0;
}

// one launch of the group's products in blocks of BM rows (the caller's
// K-split rule must count tiles of the same BM); fills each op's tiling
// and K chunks (an op with part gets gm_k_splits chunks)
template <int BM = GM_BM>
static int gemm_group(GemmGroup& G, cudaStream_t st) {
  int blocks = 0;
  for (int i = 0; i < G.n; ++i) {
    GemmOp& o = G.op[i];
    // 16-byte chunks: N, the rows' strides, M when it is A's column
    // index, K when an operand holds it along its rows
    // (an A read MN-major takes a B read MN-major: a weight gradient)
    if (o.N % 8 || o.lda % 8 || o.ldb % 8 || o.ldo % 4 || (o.ta && o.M % 8) ||
        ((!o.ta || !o.tb) && o.K % 8) || (o.colsum && !o.ta) ||
        (o.ta && !o.tb) ||
        (o.K2 && (o.ta || o.K2 % 8 || o.lda2 % 8 || o.ldb2 % 8)) ||
        (!o.part && !o.out32 && !o.out) || (o.out && o.out32) ||
        (o.bias && o.N % 8) || (o.res && (o.ldr % 8 || !o.out)) ||
        (o.lnw && (o.N > GM_BN || !o.bias || !o.lnb || !o.out)) ||
        (o.conv && (o.ta || o.ic % 8 || o.K != 9 * o.ic || o.K2)))
      return (int)cudaErrorInvalidValue;
    o.mt = gm_cdiv(o.M, BM);
    o.nt = gm_cdiv(o.N, GM_BN);
    if (o.part) {
      o.splits = gm_k_splits(o.mt * o.nt, gm_k_depth(o), &o.tiles_per_split,
                             o.target ? o.target : GM_TARGET_BLOCKS);
    } else {
      o.splits = 1;
      o.tiles_per_split = gm_cdiv(o.K, GM_BK) + gm_cdiv(o.K2, GM_BK);
    }
    o.first_block = blocks;
    blocks += o.mt * o.nt * o.splits;
  }
  int ext = 0;
  for (int i = 0; i < G.n; ++i)
    ext |= (G.op[i].res ? GM_RES : 0) | (G.op[i].conv ? GM_CONV : 0) |
           (G.op[i].lnw ? GM_LN : 0);
  switch (ext) {
    case 0:
      return gm_launch<BM, 0>(G, blocks, st);
    case GM_RES:
      return gm_launch<BM, GM_RES>(G, blocks, st);
    case GM_CONV:
      return gm_launch<BM, GM_CONV>(G, blocks, st);
    case GM_CONV | GM_LN:
      return gm_launch<BM, GM_CONV | GM_LN>(G, blocks, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// blocks of 128 rows that fill the card: two per SM on 132 SMs
constexpr int GM_FILL_BLOCKS = 264;

// a group without K splits in blocks of 128 rows where K < 192 and they
// fill the card, else of 64 (three blocks an SM: faster from K = 192 on in
// the Hiera forward on the H100, and where 128 would leave the SMs short)
static int gemm_fill(GemmGroup& G, cudaStream_t st) {
  long blocks = 0;
  int k = 0;
  for (int i = 0; i < G.n; ++i) {
    blocks += (long)gm_cdiv(G.op[i].M, GM_BM) * gm_cdiv(G.op[i].N, GM_BN);
    k = G.op[i].K > k ? G.op[i].K : k;
  }
  return blocks >= GM_FILL_BLOCKS && k < 192 ? gemm_group<GM_BM>(G, st)
                                             : gemm_group<64>(G, st);
}

// ---------------------------------------------------------------------------
// Ordered reduce of partials (K-split weight gradients, column sums,
// LayerNorm partials) into the gradient buffer
// ---------------------------------------------------------------------------

constexpr int MAX_RED = 16;
constexpr int RD_THREADS = 256;
constexpr int RD_NARROW = 32, RD_WIDE = 256;   // count bounds of the modes

// out[dst + j] = the sum over i < count of src[i stride + j] in a fixed
// order, for each segment (segments in order of dst, each a multiple of 4
// long, together covering the output); a thread takes 4 outputs at a
// time. A segment runs in items of RD_THREADS / L float4 columns, L lanes
// to a column (L = 1 up to RD_NARROW partials, 8 up to RD_WIDE, 256
// above): lane l adds i = l, l + L, .. in turn, then lane 0 the lane sums
// in lane order.
struct RedSeg {
  const float* src;
  long stride, len, dst;
  int count;
  long item0;                        // the segment's first item
};

struct RedPlan {
  RedSeg seg[MAX_RED];
  int n;
  long total, items;
};

__host__ __device__ inline int rd_lanes(int count) {
  return count <= RD_NARROW ? 1 : count <= RD_WIDE ? 8 : RD_THREADS;
}

__global__ void __launch_bounds__(RD_THREADS)
reduce_kernel(const __grid_constant__ RedPlan P, float* __restrict__ out) {
  __shared__ float4 red[RD_THREADS];
  const int tid = threadIdx.x;
  for (long item = blockIdx.x; item < P.items; item += gridDim.x) {
    int s = 0;
    while (s + 1 < P.n && item >= P.seg[s + 1].item0) ++s;
    const RedSeg& G = P.seg[s];
    const int L = rd_lanes(G.count), cols = RD_THREADS / L;
    const int tx = tid % cols, ly = tid / cols;
    const long j = ((item - G.item0) * cols + tx) * 4;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < G.len) {
      const float* src = G.src + j;
#pragma unroll 4
      for (int k = ly; k < G.count; k += L) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            src + (size_t)k * G.stride));
        t.x += v.x;
        t.y += v.y;
        t.z += v.z;
        t.w += v.w;
      }
    }
    if (L > 1) {                     // uniform over the block
      red[tid] = t;
      __syncthreads();
      if (ly == 0)
        for (int l = 1; l < L; ++l) {
          const float4 v = red[l * cols + tx];
          t.x += v.x;
          t.y += v.y;
          t.z += v.z;
          t.w += v.w;
        }
      __syncthreads();
    }
    if (ly == 0 && j < G.len) *reinterpret_cast<float4*>(out + G.dst + j) = t;
  }
}

static void reduce_add(RedPlan& P, const float* src, long stride, int count,
                       long len) {
  P.seg[P.n] = RedSeg{src, stride, len, P.total, count, P.items};
  P.total += len;
  P.items += gm_cdiv(len / 4, RD_THREADS / rd_lanes(count));
  ++P.n;
}

static void reduce_launch(const RedPlan& P, float* out, cudaStream_t st) {
  const long blocks = P.items < 2048 ? P.items : 2048;
  reduce_kernel<<<(unsigned)blocks, RD_THREADS, 0, st>>>(P, out);
}
