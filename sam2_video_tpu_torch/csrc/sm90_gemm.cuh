// A pipelined batched GEMM for Hopper (sm_90a) on wgmma, for the port's
// row-wise products (the memory-attention layer blocks, #4 and #5):
//   C(m, n) = epilogue(sum_k A(m, k) B(n, k)),
// with A(m, k) read from a row-major matrix as a[m lda + k] (K-major) or
// a[k lda + m] (MN-major), B(n, k) as b[n ldb + k] or b[k ldb + n]:
//   - y = x W^T (x rows K-major, W [out, in] K-major),
//   - dx = dy W (W read MN-major, never transposed in memory),
//   - dW = dy^T x (both MN-major: the sum runs over the rows of dy and x).
// Every operand tile is staged by cp.async into the 128-byte-swizzled layout
// that wgmma reads (a transposed operand is read by its descriptor, never
// scattered), through a ring of GM_STAGES stages; a block of two
// warpgroups owns 128 rows x 128 columns of C, each warpgroup 64 rows with
// m64n128k16 products into f32 registers.
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
// (ops/common.py linear): round(acc), + round(bias), round, ReLU, the ReLU
// backward's mask (from the rounded pre-activation), + residual, round.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

constexpr int GM_BM = 128;           // rows of C per block (two warpgroups)
constexpr int GM_BN = 128;           // columns of C per block
constexpr int GM_THREADS = 256;
constexpr int GM_BK = 64;            // K per stage
constexpr int GM_STAGES = 3;         // depth of the cp.async ring
constexpr int GM_MAX_OPS = 4;        // products per grouped launch
constexpr int GM_TARGET_BLOCKS = 132;   // K chunks: about one block per SM
constexpr int GM_MIN_CHUNK = 8;      // ... of at least 8 64-row tiles each

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
  // epilogue (ignored with part): bias [N] f32, ReLU, mask [M, ldo] bf16
  // (v = mask > 0 ? v : 0), residual [M, ldo] bf16, stores bf16 / f32
  const float* bias;
  int relu;
  const bf16* mask;
  const bf16* res;
  bf16* out;
  float* out32;
  long ldo;
  // K-split weight gradient: f32 partials [splits][M][N], and with ta the
  // column sums of A [splits][M] (or null)
  float* part;
  float* colsum;
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

// K chunks of a weight gradient with `tiles` output tiles summed over K
// rows: about GM_TARGET_BLOCKS blocks, chunks of at least GM_MIN_CHUNK
// 64-row tiles, none empty. Depends on the shapes only.
static inline int gm_k_splits(int tiles, int K, int* tiles_per_split) {
  const int kt = gm_cdiv(K, GM_BK);
  int s = gm_cdiv(GM_TARGET_BLOCKS, tiles);
  const int cap = kt / GM_MIN_CHUNK > 1 ? kt / GM_MIN_CHUNK : 1;
  s = s < cap ? s : cap;
  const int tps = gm_cdiv(kt, s);
  *tiles_per_split = tps;
  return gm_cdiv(kt, tps);
}

struct GmSmem {
  static constexpr int A_BYTES = GM_BM * GM_BK * 2;
  static constexpr int B_BYTES = GM_BN * GM_BK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int RED = GM_STAGES * STAGE;
  static_assert(GM_BM * (GM_BN + 4) * 4 <= RED, "epilogue tile fits");
  static constexpr int BYTES = RED + GM_THREADS * 4 + 1024;
};

__global__ void __launch_bounds__(GM_THREADS)
gemm_group_kernel(const __grid_constant__ GemmGroup G) {
  using SM = GmSmem;
  constexpr int NT = GM_THREADS, BM = GM_BM;
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
  const int kt_all = gm_cdiv(o.K, GM_BK);
  const int kt0 = split * o.tiles_per_split;
  const int nk = min(kt_all, kt0 + o.tiles_per_split) - kt0;
  const int ta = o.ta, tb = o.tb;
  const bool sums = o.colsum && ta && n0 == 0;

  const int tid = threadIdx.x, wg = tid >> 7;
  auto load = [&](int kt, int st) {
    const uint32_t As = sm + st * SM::STAGE, Bs = As + SM::A_BYTES;
    const int k0 = kt * GM_BK;
    if (!ta)
      stage_block<BM, GM_BK, NT>(As, o.a, o.lda, m0, o.M, k0, o.K);
    else
      stage_block<GM_BK, BM, NT>(As, o.a, o.lda, k0, o.K, m0, o.M);
    if (!tb)
      stage_block<GM_BN, GM_BK, NT>(Bs, o.b, o.ldb, n0, o.N, k0, o.K);
    else
      stage_block<GM_BK, GM_BN, NT>(Bs, o.b, o.ldb, k0, o.K, n0, o.N);
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

  // epilogue through shared memory: each warpgroup's 64 x 128 f32 tile is
  // staged, then every thread takes runs of 4 columns of a row, so the
  // residual / mask loads and the stores are whole rows per warp
  __syncthreads();                     // the ring is free
  constexpr int LDS = GM_BN + 4;
  float* tile = reinterpret_cast<float*>(gen) + wg * 64 * LDS;
  {
    const int warp = (tid >> 5) & 3, g = (tid & 31) >> 2, q = tid & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n = 0; n < GM_BN / 8; ++n)
        *reinterpret_cast<float2*>(tile + (warp * 16 + g + 8 * h) * LDS +
                                   8 * n + 2 * q) =
            make_float2(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
  }
  __syncthreads();
  // thread wt takes columns c .. c + 3 of rows rb, rb + 4, ..; every
  // global load is issued before the first store (a load after a store
  // waits for it, and 16 such round trips cost microseconds)
  constexpr int IT = 64 * GM_BN / 4 / 128, CH = GM_BN / 4;
  const int wt = tid & 127, c = (wt % CH) * 4, rb0 = wt / CH;
  const int col = n0 + c, row0 = m0 + wg * 64 + rb0;
  const bool cok = col < o.N;
  if (o.part) {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int row = row0 + 4 * it;
      if (cok && row < o.M)
        *reinterpret_cast<float4*>(o.part + ((size_t)split * o.M + row) * o.N +
                                   col) =
            *reinterpret_cast<const float4*>(tile + (rb0 + 4 * it) * LDS + c);
    }
    return;
  }
  const int colc = cok ? col : 0;
  float4 bias = make_float4(0.f, 0.f, 0.f, 0.f);
  if (o.bias) bias = __ldg(reinterpret_cast<const float4*>(o.bias + colc));
  uint2 res[IT], msk[IT];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int row = min(row0 + 4 * it, o.M - 1);
    const size_t at = (size_t)row * o.ldo + colc;
    res[it] = o.res ? __ldg(reinterpret_cast<const uint2*>(o.res + at))
                    : make_uint2(0, 0);
    msk[it] = o.mask ? __ldg(reinterpret_cast<const uint2*>(o.mask + at))
                     : make_uint2(0x3f803f80u, 0x3f803f80u);   // ones
  }
  const float bb[4] = {bias.x, bias.y, bias.z, bias.w};
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int row = row0 + 4 * it;
    float v[4];
    *reinterpret_cast<float4*>(v) =
        *reinterpret_cast<const float4*>(tile + (rb0 + 4 * it) * LDS + c);
    const bf16* rr = reinterpret_cast<const bf16*>(&res[it]);
    const bf16* mm = reinterpret_cast<const bf16*>(&msk[it]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (o.bias && o.out)
        v[j] = rb(rb(v[j]) + rb(bb[j]));
      else
        v[j] += bb[j];
      if (o.relu) v[j] = fmaxf(v[j], 0.f);
      if (!(to_f32(mm[j]) > 0.f)) v[j] = 0.f;
      v[j] += to_f32(rr[j]);
    }
    if (!cok || row >= o.M) continue;
    const size_t at = (size_t)row * o.ldo + col;
    if (o.out) {
      const __nv_bfloat162 a0 = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 a1 = __floats2bfloat162_rn(v[2], v[3]);
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&a0);
      u.y = *reinterpret_cast<const uint32_t*>(&a1);
      *reinterpret_cast<uint2*>(o.out + at) = u;
    }
    if (o.out32)
      *reinterpret_cast<float4*>(o.out32 + at) = *reinterpret_cast<float4*>(v);
  }
}

// one launch of the group's products; fills each op's tiling and K chunks
// (an op with part gets gm_k_splits chunks)
static int gemm_group(GemmGroup& G, cudaStream_t st) {
  int blocks = 0;
  for (int i = 0; i < G.n; ++i) {
    GemmOp& o = G.op[i];
    // 16-byte chunks: N, the rows' strides, M when it is A's column
    // index, K when an operand holds it along its rows
    // (an A read MN-major takes a B read MN-major: a weight gradient)
    if (o.N % 8 || o.lda % 8 || o.ldb % 8 || o.ldo % 4 || (o.ta && o.M % 8) ||
        ((!o.ta || !o.tb) && o.K % 8) || (o.colsum && !o.ta) ||
        (o.ta && !o.tb))
      return (int)cudaErrorInvalidValue;
    o.mt = gm_cdiv(o.M, GM_BM);
    o.nt = gm_cdiv(o.N, GM_BN);
    if (o.part) {
      o.splits = gm_k_splits(o.mt * o.nt, o.K, &o.tiles_per_split);
    } else {
      o.splits = 1;
      o.tiles_per_split = gm_cdiv(o.K, GM_BK);
    }
    o.first_block = blocks;
    blocks += o.mt * o.nt * o.splits;
  }
  const int smem = GmSmem::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      gemm_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // the largest shared-memory carve-out, so that two blocks share an SM;
  // by default CUDA may choose a carve-out that fits only one
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gemm_group_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  gemm_group_kernel<<<blocks, GM_THREADS, smem, st>>>(G);
  return 0;
}
