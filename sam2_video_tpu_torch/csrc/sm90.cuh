// Hopper (sm_90a) building blocks of the port's pipelined attention kernels:
//   - 64-row tiles of bf16 in shared memory in the 128-byte-swizzled layout
//     that wgmma reads (stage_tile: cp.async with zero fill past the last
//     row, so a ragged tail is masked by the caller only in the softmax);
//   - cp.async commit / wait, the generic-to-async proxy fence;
//   - wgmma descriptors for such a tile read K-major (its rows are M or N
//     and its columns K: q k^T, dout v^T, k q^T, v dout^T) or MN-major (its
//     rows are K: p v, ds k, p^T dout, ds^T q), and the products the
//     kernels run: m64n64k16 with A and B from shared memory (K-major, or
//     both MN-major: k^T-side sums such as dWk = dpre^T kin), and
//     m64n64k16 / m64n128k16 with A from registers (bf16 pairs in the
//     mma.sync m16n8k16 A layout, one warp per 16 rows);
//   - wgmma fence / commit / wait and the register fence that keeps the
//     compiler from touching an accumulator while a product is in flight;
//   - the attention kernels' epilogues (accumulator rows to bf16 or f32)
//     and the combines that merge key splits in split order (#7, #3).
// Accumulators are f32 in the wgmma D layout: thread (warp w, lane l) holds
// rows 16 w + l / 4 (+ 8) and, in its n-th group of four registers,
// columns 8 n + 2 (l % 4) (+ 1): d[4 n + 2 h + e] is row + 8 h, column + e.
#pragma once

#include "common.cuh"

constexpr int TILE_ROWS = 64;               // rows of every staged tile
constexpr int TILE_COL_BYTES = TILE_ROWS * 128;   // one 64-column block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of element (r, c) in a 64-row tile: 64-column blocks of 64
// rows x 128 bytes, the 16-byte chunk j of row r stored at chunk j ^ (r % 8)
// (CUTLASS's Swizzle<3, 4, 3>; the tile base is 1024-byte aligned)
__device__ __forceinline__ uint32_t sw128_off(int r, int c) {
  return (c >> 6) * TILE_COL_BYTES + r * 128 +
         ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread's completed cp.async writes become visible to wgmma (the
// async proxy); a __syncthreads() after it makes every thread's visible
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows r0 .. r0 + 63 of a row-major [n][W] bf16 matrix into the 64-row tile
// at shared address dst (rows at and past n zero-filled), by all NT
// threads of the block, one 16-byte cp.async each per step
template <int W, int NT = 128>
__device__ __forceinline__ void stage_tile(uint32_t dst,
                                           const bf16* __restrict__ src,
                                           int r0, int n) {
  constexpr int C8 = W / 8;
#pragma unroll
  for (int i = 0; i < TILE_ROWS * C8 / NT; ++i) {
    const int e = i * NT + threadIdx.x;
    const int r = e / C8, c = (e % C8) * 8;
    const bool ok = r0 + r < n;
    cp_async16(dst + sw128_off(r, c),
               src + (size_t)(ok ? r0 + r : 0) * W + c, ok);
  }
}

// 64 f32 values v[r0 .. r0 + 63] (zeros at and past n) to shared dst
__device__ __forceinline__ void stage_row_f32(uint32_t dst,
                                              const float* __restrict__ v,
                                              int r0, int n) {
  const int t = threadIdx.x;
  if (t < TILE_ROWS) {
    const bool ok = r0 + t < n;
    cp_async4(dst + 4 * t, v + (ok ? r0 + t : 0), ok);
  }
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand: the tile's 64 rows (M or N), columns k0 .. k0 + 15 (K);
// the start moves by 2 k0 bytes inside a 128-byte row (the hardware
// applies the swizzle to the address), 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int k0) {
  return sw128_desc(tile + (k0 >> 6) * TILE_COL_BYTES + (k0 & 63) * 2, 16,
                    1024);
}

// MN-major B operand: the tile's rows k0 .. k0 + 15 (K, k0 % 16 == 0),
// columns n0 .. (N, n0 % 64 == 0); 64-column blocks TILE_COL_BYTES apart
// (leading byte offset), 8-row groups 1024 bytes apart (stride offset)
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int k0, int n0) {
  return sw128_desc(tile + (n0 >> 6) * TILE_COL_BYTES + k0 * 128,
                    TILE_COL_BYTES, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// orders the accumulator's uses after the wait (and its writes before the
// next product): the registers pass through an empty volatile asm
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// d[64 x 64] (+)= A B^T: A (64 x 16) and B (64 x 16) K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] += A B with both operands MN-major in shared memory: A's
// tile rows are K and its columns M (desc_mn), B's rows K, columns N
__device__ __forceinline__ void wgmma_ss_n64_mn(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x N] (+)= A B: A (64 x 16) bf16 pairs in registers, B (16 x N)
// MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64)
    wgmma_rs_n64(d, a, db, 1);
  else
    wgmma_rs_n128(d, a, db, 1);
}

// the A operands of k16 slice kk of a 64 x N f32 accumulator x (its
// columns become the product's K) as bf16 hi + lo pairs (common.cuh split2)
template <int N>
__device__ __forceinline__ void a_split(const float (&x)[N], int kk,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int j = 8 * kk;
  split2(x[j], x[j + 1], hi[0], lo[0]);
  split2(x[j + 2], x[j + 3], hi[1], lo[1]);
  split2(x[j + 4], x[j + 5], hi[2], lo[2]);
  split2(x[j + 6], x[j + 7], hi[3], lo[3]);
}

// ---------------------------------------------------------------------------
// Epilogues, the backward's row delta and the split combines of the
// attention kernels (one warpgroup owns 64 rows; a block may hold several
// warpgroups)
// ---------------------------------------------------------------------------

// 1024-byte aligned base of the dynamic shared memory (the swizzle atoms
// are 1024 bytes); the launch asks for 1 KB more than the carve
__device__ __forceinline__ uint32_t aligned_smem(unsigned char* raw,
                                                 unsigned char** gen) {
  const uint32_t a = smem_u32(raw);
  const uint32_t b = (a + 1023u) & ~1023u;
  *gen = raw + (b - a);
  return b;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffff, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffff, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffff, v, 1);
  return v + __shfl_xor_sync(0xffffffff, v, 2);
}

// column of accumulator register i (64-wide accumulator, this thread)
__device__ __forceinline__ int acc_col(int i) {
  return (i >> 2) * 8 + 2 * (threadIdx.x & 3) + (i & 1);
}

// store a 64 x NC f32 accumulator's rows (< n) as bf16 (times mul) into a
// row-major [.., ld] matrix at dst (row 0 = the tile's first row)
template <int NC>
__device__ __forceinline__ void store_bf16(const float (&acc)[NC / 2],
                                           bf16* dst, int ld, int rows_left,
                                           float mul) {
  const int warp = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    if (r >= rows_left) continue;
#pragma unroll
    for (int n = 0; n < NC / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r * ld + acc_col(4 * n)) =
          __floats2bfloat162_rn(acc[4 * n + 2 * h] * mul,
                                acc[4 * n + 2 * h + 1] * mul);
  }
}

// the same as f32 pairs
template <int NC>
__device__ __forceinline__ void store_f32(const float (&acc)[NC / 2],
                                          float* dst, int ld, int rows_left) {
  const int warp = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    if (r >= rows_left) continue;
#pragma unroll
    for (int n = 0; n < NC / 8; ++n)
      *reinterpret_cast<float2*>(dst + (size_t)r * ld + acc_col(4 * n)) =
          make_float2(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
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

// out and lse of rows = BH * Lq rows from the S splits' partials (the
// unnormalised f32 outputs [S][rows][DV], then the (row max, row sum)
// pairs [S][rows]), merged in split order: a warp per row
template <int DV>
__global__ void fa_combine_kernel(const float* __restrict__ part, int S,
                                  int rows, bf16* __restrict__ out,
                                  float* __restrict__ lse) {
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float2* ml = reinterpret_cast<const float2*>(part + (size_t)S * rows * DV);
  float M = -INFINITY;
  for (int s = 0; s < S; ++s) M = fmaxf(M, ml[(size_t)s * rows + row].x);
  float tot = 0.f, acc[DV / 32];
#pragma unroll
  for (int i = 0; i < DV / 32; ++i) acc[i] = 0.f;
  for (int s = 0; s < S; ++s) {
    const float2 e = ml[(size_t)s * rows + row];
    const float w = expf(e.x - M);
    tot += w * e.y;
    const float* po = part + ((size_t)s * rows + row) * DV;
#pragma unroll
    for (int i = 0; i < DV / 32; ++i) acc[i] += w * po[lane + 32 * i];
  }
  const float inv = 1.f / tot;
#pragma unroll
  for (int i = 0; i < DV / 32; ++i)
    out[(size_t)row * DV + lane + 32 * i] = to_bf16(acc[i] * inv);
  if (lane == 0) lse[row] = M + logf(tot);
}

// dq = bf16(scale * sum of the S partials [S][n], in split order)
__global__ void fa_dq_combine_kernel(const float* __restrict__ part, int S,
                                     long n, float scale,
                                     bf16* __restrict__ dq) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += part[s * n + i];
    dq[i] = to_bf16(acc * scale);
  }
}
