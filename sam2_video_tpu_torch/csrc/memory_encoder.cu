// Memory encoder forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel
// sam2_video_tpu/ops/memory_encoder_kernel.py:fused_memory_encoder (Pallas
// _kernel): mask [N, 16h, 16w, 1] -> 4 x (3x3 / stride-2 / pad-1 conv ->
// LayerNorm2d -> GELU) -> 1x1 conv + projected pixels -> 2 CXBlocks
// (depthwise 7x7, LN, pw1, GELU, pw2, layer scale, residual) -> out_proj to
// out_dim.
//
// What bounds it on an H100 (384 px, 8 objects, 24 x 24 x 256 per object):
// the function needs ~12.5 GFLOP of products per call (the k3/s2 pyramid
// at its own resolutions 1.8, the 1x1 conv 0.6, two 256 -> 1024 -> 256
// MLPs 9.7, depthwise and out_proj 0.4): about 13 us at 989 TFLOP/s,
// against ~8 MB of inputs, output and weights (2.4 us at 3.35 TB/s). The
// TPU kernel ran the pyramid in a phase-packed 1/16-resolution layout as
// four K = 1024 products (9.7 GFLOP, most of it the zeros of the phase
// routing, for its matrix unit). Here each layer runs at its own
// resolution, 10 device operations per call:
//   - layers 1 and 2 (1 -> 4 and 4 -> 16 channels, 13 MFLOP per object)
//     in one direct kernel on the CUDA cores (ds12_kernel): a block reads
//     its input tile with the halo of both layers once, keeps layer 1 in
//     shared memory and writes layer 2;
//   - layers 3 and 4 as products on the pipelined wgmma GEMM of
//     sm90_gemm.cuh with an implicit-im2col A (cp.async of the nine taps,
//     zero fill outside the image); layer 3's LayerNorm + GELU run in the
//     GEMM's epilogue (its 64 channels fit one column tile), layer 4's in
//     a row kernel; the 1x1 conv adds the projected pixels in its
//     epilogue;
//   - each CXBlock in two kernels: the depthwise 7x7 and the LayerNorm
//     over a tile of 4 x 8 positions whose 3-pixel halo is staged in
//     shared memory (no f32 round trip; cx_dwln_kernel), then the MLP
//     fused per 64 rows (cx_mlp_kernel): the 1024-wide hidden layer is
//     made 128 units at a time in shared memory and consumed at once by
//     pw2 on wgmma, so it never reaches device memory; layer scale and the
//     residual in its epilogue;
//   - out_proj on the same GEMM.
// Rounding points: one per stage, as before (each conv or product rounds
// acc + bias once; LayerNorm and GELU in f32, then one rounding).
// The C entry point launches the chain in order on the caller's stream,
// carves its scratch from one caller-allocated workspace
// (memory_encoder_workspace_bytes) and returns the first CUDA error.

#include "hiera_attn.cuh"
#include "sm90_gemm.cuh"

constexpr int ME_C = 256;            // fuser width (and layer 4's channels)
constexpr int ME_HID = 1024;         // CXBlock hidden width
constexpr float ME_EPS = 1e-6f;      // LayerNorm2d

// ---------------------------------------------------------------------------
// Downsampler layers 1 and 2: the mask [N, Sh, Sw] (16 h x 16 w) -> layer 1
// [Sh/2, Sw/2, 4] -> layer 2 [N, Sh/4, Sw/4, 16], each a 3x3 / stride-2 / pad-1 conv,
// round(acc + bias), LayerNorm over the channels, GELU, round. A block owns
// DS_T x DS_T layer-2 outputs; its layer-1 rows (with the halo, zeros
// outside the image: layer 2's padding) stay in shared memory.
// ---------------------------------------------------------------------------

constexpr int DS_T = 16;                  // layer-2 outputs per block side
constexpr int DS_A1 = 2 * DS_T + 1;       // layer-1 rows / columns a block uses
constexpr int DS_IN = 4 * DS_T + 3;       // input rows / columns
constexpr int DS_THREADS = DS_T * DS_T;   // a thread per layer-2 output

struct Ds12W {
  const float *w1, *b1, *g1, *be1;    // layer 1: W [4][9], bias, LN w, b [4]
  const float *w2, *b2, *g2, *be2;    // layer 2: W [16][4][9], ..., [16]
};

template <int CH>
__device__ __forceinline__ void ln_gelu_round(float (&v)[CH], const float* g,
                                              const float* be) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) s += v[c];
  const float mu = s / CH;
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) q += (v[c] - mu) * (v[c] - mu);
  const float rs = rsqrtf(q / CH + ME_EPS);
#pragma unroll
  for (int c = 0; c < CH; ++c)
    v[c] = rb(gelu_erf((v[c] - mu) * rs * g[c] + be[c]));
}

__global__ void __launch_bounds__(DS_THREADS)
ds12_kernel(const bf16* __restrict__ m, bf16* __restrict__ a2, Ds12W p,
            int Sh, int Sw) {
  __shared__ float xin[DS_IN][DS_IN + 1];
  __shared__ __align__(16) float a1[DS_A1 * DS_A1][4];
  __shared__ float w1s[4 * 9], v1s[3][4];
  __shared__ __align__(16) float w2s[9][4][16];   // [tap][ci][co]
  __shared__ float v2s[3][16];
  const int tid = threadIdx.x, n = blockIdx.z;
  const int Y0 = blockIdx.y * DS_T, X0 = blockIdx.x * DS_T;
  const int H1 = Sh / 2, W1 = Sw / 2, H2 = Sh / 4, W2 = Sw / 4;
  if (tid < 36) w1s[tid] = p.w1[tid];
  if (tid < 4) {
    v1s[0][tid] = p.b1[tid];
    v1s[1][tid] = p.g1[tid];
    v1s[2][tid] = p.be1[tid];
  }
  if (tid < 16) {
    v2s[0][tid] = p.b2[tid];
    v2s[1][tid] = p.g2[tid];
    v2s[2][tid] = p.be2[tid];
  }
  for (int e = tid; e < 16 * 4 * 9; e += DS_THREADS) {   // e = (co 4 + ci) 9 + t
    const int t = e % 9, ci = (e / 9) % 4, co = e / 36;
    w2s[t][ci][co] = p.w2[e];
  }
  // input rows / columns from 4 Y0 - 3, zeros outside (layer 1's padding)
  for (int e = tid; e < DS_IN * DS_IN; e += DS_THREADS) {
    const int r = e / DS_IN, c = e % DS_IN;
    const int y = 4 * Y0 - 3 + r, x = 4 * X0 - 3 + c;
    xin[r][c] = y >= 0 && y < Sh && x >= 0 && x < Sw
                    ? to_f32(m[((size_t)n * Sh + y) * Sw + x])
                    : 0.f;
  }
  __syncthreads();
  // layer 1 at rows / columns from 2 Y0 - 1 (input row 2 y1 - 1 + ky is
  // local row 2 r + ky)
#pragma unroll 1
  for (int e = tid; e < DS_A1 * DS_A1; e += DS_THREADS) {
    const int r = e / DS_A1, c = e % DS_A1;
    const int y1 = 2 * Y0 - 1 + r, x1 = 2 * X0 - 1 + c;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (y1 >= 0 && y1 < H1 && x1 >= 0 && x1 < W1) {
      float xv[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) xv[t] = xin[2 * r + t / 3][2 * c + t % 3];
#pragma unroll
      for (int co = 0; co < 4; ++co) {
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t) acc += w1s[co * 9 + t] * xv[t];
        v[co] = rb(acc + v1s[0][co]);
      }
      ln_gelu_round<4>(v, v1s[1], v1s[2]);
    }
    *reinterpret_cast<float4*>(a1[e]) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();
  // layer 2, one output a thread (layer-1 row 2 y2 - 1 + ky is local row
  // 2 ty + ky); weights read as float4 broadcasts
  const int ty = tid / DS_T, tx = tid % DS_T;
  const int y2 = Y0 + ty, x2 = X0 + tx;
  if (y2 >= H2 || x2 >= W2) return;
  float acc[16];
#pragma unroll
  for (int co = 0; co < 16; ++co) acc[co] = 0.f;
#pragma unroll 1
  for (int t = 0; t < 9; ++t) {
    const float4 a = *reinterpret_cast<const float4*>(
        a1[(2 * ty + t / 3) * DS_A1 + 2 * tx + t % 3]);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int ci = 0; ci < 4; ++ci)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 w = *reinterpret_cast<const float4*>(&w2s[t][ci][4 * j]);
        acc[4 * j] += w.x * av[ci];
        acc[4 * j + 1] += w.y * av[ci];
        acc[4 * j + 2] += w.z * av[ci];
        acc[4 * j + 3] += w.w * av[ci];
      }
  }
#pragma unroll
  for (int co = 0; co < 16; ++co) acc[co] = rb(acc[co] + v2s[0][co]);
  ln_gelu_round<16>(acc, v2s[1], v2s[2]);
  uint4 u[2];
  bf16* ub = reinterpret_cast<bf16*>(u);
#pragma unroll
  for (int co = 0; co < 16; ++co) ub[co] = to_bf16(acc[co]);
  uint4* dst = reinterpret_cast<uint4*>(a2 + (((size_t)n * H2 + y2) * W2 + x2) * 16);
  dst[0] = u[0];
  dst[1] = u[1];
}

// ---------------------------------------------------------------------------
// CXBlock, part 1: y = LN(dwconv7(x) + bias) (zero padding 3), bf16 out. A
// block owns 4 x 8 positions of one object; their 10 x 14 x 256 halo tile
// is staged in shared memory (zeros outside the image). Each thread
// convolves two channels at 16 positions (taps in the reference's order,
// a row of 7 weight pairs in registers at a time) into an f32 tile, then a
// warp per position normalises.
// ---------------------------------------------------------------------------

constexpr int DW_TY = 4, DW_TX = 8;         // positions per block
constexpr int DW_HY = DW_TY + 6, DW_HX = DW_TX + 6;   // with the halo
constexpr int DW_THREADS = 256;
constexpr int DW_HALO = DW_HY * DW_HX * ME_C * 2;     // bf16 bytes
constexpr int DW_SMEM = DW_HALO + DW_TY * DW_TX * ME_C * 4 + 16;

__global__ void __launch_bounds__(DW_THREADS, 2)
cx_dwln_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
               const float* __restrict__ w, const float* __restrict__ bias,
               const float* __restrict__ lnw, const float* __restrict__ lnb,
               int h, int wd) {
  extern __shared__ __align__(16) unsigned char dw_smem[];
  const bf16* halo = reinterpret_cast<const bf16*>(dw_smem);
  float* conv = reinterpret_cast<float*>(dw_smem + DW_HALO);
  const int tid = threadIdx.x, n = blockIdx.z;
  const int Y0 = blockIdx.y * DW_TY, X0 = blockIdx.x * DW_TX;
  const uint32_t hs = smem_u32(dw_smem);
  for (int e = tid; e < DW_HY * DW_HX * (ME_C / 8); e += DW_THREADS) {
    const int pos = e / (ME_C / 8), j = e % (ME_C / 8);
    const int yy = Y0 - 3 + pos / DW_HX, xx = X0 - 3 + pos % DW_HX;
    const bool ok = yy >= 0 && yy < h && xx >= 0 && xx < wd;
    cp_async16(hs + pos * ME_C * 2 + j * 16,
               x + (ok ? (((size_t)n * h + yy) * wd + xx) * ME_C + j * 8 : 0),
               ok);
  }
  cp_async_commit();
  const int cp = tid & 127, py0 = (tid >> 7) * (DW_TY / 2);   // channels 2 cp, + 1
  const float2 b2 = __ldg(reinterpret_cast<const float2*>(bias + 2 * cp));
  float2 acc[DW_TY / 2][DW_TX];
#pragma unroll
  for (int i = 0; i < DW_TY / 2; ++i)
#pragma unroll
    for (int j = 0; j < DW_TX; ++j) acc[i][j] = b2;
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll 1
  for (int ky = 0; ky < 7; ++ky) {
    float2 wk[7];
#pragma unroll
    for (int kx = 0; kx < 7; ++kx)
      wk[kx] = __ldg(reinterpret_cast<const float2*>(w + (ky * 7 + kx) * ME_C + 2 * cp));
#pragma unroll
    for (int i = 0; i < DW_TY / 2; ++i)
#pragma unroll
      for (int j = 0; j < DW_TX; ++j)
#pragma unroll
        for (int kx = 0; kx < 7; ++kx) {
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  halo + ((py0 + i + ky) * DW_HX + j + kx) * ME_C + 2 * cp));
          acc[i][j].x += v.x * wk[kx].x;
          acc[i][j].y += v.y * wk[kx].y;
        }
  }
#pragma unroll
  for (int i = 0; i < DW_TY / 2; ++i)
#pragma unroll
    for (int j = 0; j < DW_TX; ++j)
      *reinterpret_cast<float2*>(conv + ((py0 + i) * DW_TX + j) * ME_C + 2 * cp) =
          acc[i][j];
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  float g8[8], b8[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    g8[e] = __ldg(lnw + 8 * lane + e);
    b8[e] = __ldg(lnb + 8 * lane + e);
  }
  constexpr int PER_WARP = DW_TY * DW_TX / (DW_THREADS / 32);
  for (int i = 0; i < PER_WARP; ++i) {
    const int pos = warp * PER_WARP + i;
    const int yy = Y0 + pos / DW_TX, xx = X0 + pos % DW_TX;
    if (yy >= h || xx >= wd) continue;           // uniform over the warp
    float v[8];
    const float4* src = reinterpret_cast<const float4*>(conv + pos * ME_C + 8 * lane);
    *reinterpret_cast<float4*>(v) = src[0];
    *reinterpret_cast<float4*>(v + 4) = src[1];
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) s += v[e];
    const float mu = warp_sum(s) / ME_C;
    float q = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) q += (v[e] - mu) * (v[e] - mu);
    const float rs = rsqrtf(warp_sum(q) / ME_C + ME_EPS);
    uint4 u;
    bf16* ub = reinterpret_cast<bf16*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) ub[e] = to_bf16((v[e] - mu) * rs * g8[e] + b8[e]);
    *reinterpret_cast<uint4*>(y + (((size_t)n * h + yy) * wd + xx) * ME_C +
                              8 * lane) = u;
  }
}

// ---------------------------------------------------------------------------
// CXBlock, part 2: out = x + gamma (GELU(y W1^T + b1) W2^T + b2), one
// rounding, per 64 rows; two warpgroups. The rows of y stay in shared
// memory; the hidden layer is made MLP_HC units at a time (each warpgroup
// half of them: m64n64 over K 256), rounded to bf16 into shared memory, and
// consumed by pw2 at once (each warpgroup 128 of the 256 output columns:
// m64n128 over the chunk), so it never reaches device memory. W1 and W2
// stream in 64 KB chunks through a two-stage cp.async ring, W1's chunk c
// then W2's.
// ---------------------------------------------------------------------------

constexpr int MLP_ROWS = 64, MLP_HC = 128, MLP_THREADS = 256;
constexpr int MLP_W = MLP_HC * ME_C * 2;   // a W1 [128, 256] or W2 [256, 128] chunk
constexpr int MLP_UNITS = 2 * (ME_HID / MLP_HC);
struct MlpSmem {
  static constexpr int Y = 0;                         // [64, 256] bf16
  static constexpr int RING = Y + MLP_ROWS * ME_C * 2;
  static constexpr int H = RING + 2 * MLP_W;          // [64, 128] bf16
  static constexpr int BYTES = H + MLP_ROWS * MLP_HC * 2 + 1024;
  static_assert(MLP_ROWS * (ME_C + 4) * 4 <= 2 * MLP_W, "epilogue tile fits");
};

__global__ void __launch_bounds__(MLP_THREADS, 1)
cx_mlp_kernel(const bf16* __restrict__ y, const bf16* __restrict__ x,
              const bf16* __restrict__ w1, const float* __restrict__ b1,
              const bf16* __restrict__ w2, const float* __restrict__ b2,
              const float* __restrict__ gamma, bf16* __restrict__ out, int M) {
  extern __shared__ unsigned char mlp_smem[];
  unsigned char* gen;
  const uint32_t sm = aligned_smem(mlp_smem, &gen);
  const uint32_t Ys = sm + MlpSmem::Y, Hs = sm + MlpSmem::H;
  const uint32_t W1s = sm + MlpSmem::RING, W2s = W1s + MLP_W;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, g = (tid & 31) >> 2, q = tid & 3;
  const int r0 = blockIdx.x * MLP_ROWS;
  // unit 2c: W1 rows 128 c .. (hidden units x K 256) into stage 0; unit
  // 2c + 1: W2 columns 128 c .. (256 outputs x K 128) into stage 1
  auto load = [&](int u) {
    const int c = u >> 1;
    if (!(u & 1))
      stage_block<MLP_HC, ME_C, MLP_THREADS>(W1s, w1, ME_C, c * MLP_HC, ME_HID,
                                             0, ME_C);
    else
      stage_block<ME_C, MLP_HC, MLP_THREADS>(W2s, w2, ME_HID, 0, ME_C,
                                             c * MLP_HC, ME_HID);
  };
  stage_block<MLP_ROWS, ME_C, MLP_THREADS>(Ys, y, ME_C, r0, M, 0, ME_C);
  load(0);
  cp_async_commit();
  load(1);
  cp_async_commit();

  float acc[64];
  zero(acc);
  for (int c = 0; c < ME_HID / MLP_HC; ++c) {
    cp_async_wait<1>();                // W1's chunk c (and y) landed
    fence_proxy_async();
    __syncthreads();
    float hacc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < ME_C / 16; ++kk) {
      const int k0 = kk * 16;
      wgmma_ss_n64(hacc, desc_k(Ys, k0),
                   desc_k(W1s + (k0 >> 6) * (MLP_HC * 128) + wg * 64 * 128,
                          k0 & 63),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(hacc);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = warp * 16 + g + 8 * hh;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = wg * 64 + 8 * n + 2 * q, u = c * MLP_HC + col;
        const float v0 = gelu_erf(hacc[4 * n + 2 * hh] + __ldg(b1 + u));
        const float v1 = gelu_erf(hacc[4 * n + 2 * hh + 1] + __ldg(b1 + u + 1));
        *reinterpret_cast<__nv_bfloat162*>(gen + MlpSmem::H + sw128_off(row, col)) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
    fence_proxy_async();               // the hidden chunk, for wgmma
    __syncthreads();                   // ... whole; W1's chunk consumed
    if (2 * c + 2 < MLP_UNITS) load(2 * c + 2);
    cp_async_commit();
    cp_async_wait<1>();                // W2's chunk c landed
    fence_proxy_async();
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < MLP_HC / 16; ++kk) {
      const int k0 = kk * 16;
      wgmma_ss_n128<0, 0>(acc, desc_k(Hs, k0),
                          desc_k(W2s + (k0 >> 6) * (ME_C * 128) +
                                     wg * 128 * 128,
                                 k0 & 63));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();                   // the hidden chunk and W2's consumed
    if (2 * c + 3 < MLP_UNITS) load(2 * c + 3);
    cp_async_commit();
  }

  // epilogue through shared memory (the ring is free): 16-byte loads and
  // stores of whole rows
  constexpr int LDT = ME_C + 4;
  float* tile = reinterpret_cast<float*>(gen + MlpSmem::RING);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = warp * 16 + g + 8 * hh;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      *reinterpret_cast<float2*>(tile + row * LDT + wg * 128 + 8 * n + 2 * q) =
          make_float2(acc[4 * n + 2 * hh], acc[4 * n + 2 * hh + 1]);
  }
  __syncthreads();
#pragma unroll 1
  for (int it = 0; it < MLP_ROWS * ME_C / 8 / MLP_THREADS; ++it) {
    const int e = it * MLP_THREADS + tid, r = e / (ME_C / 8), c = (e % (ME_C / 8)) * 8;
    if (r0 + r >= M) continue;
    const size_t at = (size_t)(r0 + r) * ME_C + c;
    float v[8], bb[8], gg[8];
    *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(tile + r * LDT + c);
    *reinterpret_cast<float4*>(v + 4) =
        *reinterpret_cast<const float4*>(tile + r * LDT + c + 4);
    *reinterpret_cast<float4*>(bb) = __ldg(reinterpret_cast<const float4*>(b2 + c));
    *reinterpret_cast<float4*>(bb + 4) = __ldg(reinterpret_cast<const float4*>(b2 + c + 4));
    *reinterpret_cast<float4*>(gg) = __ldg(reinterpret_cast<const float4*>(gamma + c));
    *reinterpret_cast<float4*>(gg + 4) =
        __ldg(reinterpret_cast<const float4*>(gamma + c + 4));
    const uint4 xr = __ldg(reinterpret_cast<const uint4*>(x + at));
    const bf16* x8 = reinterpret_cast<const bf16*>(&xr);
    uint4 u;
    bf16* ub = reinterpret_cast<bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) ub[j] = to_bf16((v[j] + bb[j]) * gg[j] + to_f32(x8[j]));
    *reinterpret_cast<uint4*>(out + at) = u;
  }
}

// ---------------------------------------------------------------------------
// Weight table, in this order (f32 unless noted):
//   layer 1: W [4, 1, 3, 3] (OIHW), bias, LN weight, LN bias [4]
//   layer 2: W [16, 4, 3, 3], bias, LN weight, LN bias [16]
//   layer 3: W bf16 [64, 9 * 16] (column = (ky 3 + kx) 16 + ci), bias, LN
//            weight, LN bias [64]
//   layer 4: W bf16 [256, 9 * 64], bias, LN weight, LN bias [256]
//   final 1x1: W bf16 [256, 256], bias [256]
//   for each of the 2 CXBlocks: dw [49, 256], dw bias [256], LN w, LN b,
//     pw1 W bf16 [1024, 256], pw1 b [1024], pw2 W bf16 [256, 1024], pw2 b
//     [256], gamma [256]
//   out_proj: W bf16 [out_dim, 256], bias [out_dim]
// ---------------------------------------------------------------------------

constexpr int ME_NUM_WEIGHTS = 4 * 4 + 2 + 2 * 9 + 2;

struct MeBufs {
  bf16 *a2, *a3, *z4, *a4, *xa, *xb, *yb;
};

static MeBufs carve_me(Arena& ar, int N, int h, int w) {
  const long M = (long)N * h * w;
  MeBufs b{};
  b.a2 = ar.take<bf16>(M * 16 * 16);           // [N, 4h, 4w, 16]
  b.a3 = ar.take<bf16>(M * 4 * 64);            // [N, 2h, 2w, 64]
  b.z4 = ar.take<bf16>(M * ME_C);
  b.a4 = ar.take<bf16>(M * ME_C);
  b.xa = ar.take<bf16>(M * ME_C);
  b.xb = ar.take<bf16>(M * ME_C);
  b.yb = ar.take<bf16>(M * ME_C);
  return b;
}

extern "C" long memory_encoder_workspace_bytes(int N, int h, int w) {
  Arena ar{nullptr, 0};
  carve_me(ar, N, h, w);
  return (long)ar.off;
}

// masks [N, 16h, 16w, 1], pix [N, h, w, 256] projected pixel features,
// out [N, h, w, out_dim], all bf16
extern "C" int memory_encoder_fwd(const void* masks, const void* pix,
                                  void* out, const void* const* wt, void* ws,
                                  int N, int h, int w, int out_dim,
                                  void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  if (out_dim % 8 || out_dim > ME_C) return (int)cudaErrorInvalidValue;
  const int M = N * h * w;
  auto bfp = [&](int i) { return static_cast<const bf16*>(wt[i]); };
  auto fp = [&](int i) { return static_cast<const float*>(wt[i]); };
  Arena ar{static_cast<char*>(ws), 0};
  const MeBufs b = carve_me(ar, N, h, w);
  int err;

  // layers 1 and 2
  const Ds12W dp{fp(0), fp(1), fp(2), fp(3), fp(4), fp(5), fp(6), fp(7)};
  ds12_kernel<<<dim3((4 * w + DS_T - 1) / DS_T, (4 * h + DS_T - 1) / DS_T, N),
                DS_THREADS, 0, st>>>(static_cast<const bf16*>(masks), b.a2, dp,
                                     16 * h, 16 * w);

  // layer 3: im2col over a2, LayerNorm + GELU in the epilogue
  GemmGroup G{};
  G.n = 1;
  G.op[0] = gemm_op(b.a2, 16, 0, bfp(8), 9 * 16, 0, N * 4 * h * w, 64, 9 * 16);
  G.op[0].conv = 1;
  G.op[0].ih = 4 * h;
  G.op[0].iw = 4 * w;
  G.op[0].ic = 16;
  G.op[0].oh = 2 * h;
  G.op[0].ow = 2 * w;
  G.op[0].bias = fp(9);
  G.op[0].lnw = fp(10);
  G.op[0].lnb = fp(11);
  G.op[0].gelu = 1;
  G.op[0].out = b.a3;
  if ((err = gemm_fill(G, st))) return err;

  // layer 4: im2col over a3, round(acc + bias); LayerNorm + GELU
  G.op[0] = gemm_op(b.a3, 64, 0, bfp(12), 9 * 64, 0, M, ME_C, 9 * 64);
  G.op[0].conv = 1;
  G.op[0].ih = 2 * h;
  G.op[0].iw = 2 * w;
  G.op[0].ic = 64;
  G.op[0].oh = h;
  G.op[0].ow = w;
  G.op[0].bias = fp(13);
  G.op[0].bias_once = 1;
  G.op[0].out = b.z4;
  if ((err = gemm_fill(G, st))) return err;
  ln_fwd(b.z4, b.a4, fp(14), fp(15), RowMap{h, w, h, w}, M, ME_C, st, 1);

  // final 1x1 conv + projected pixels
  G.op[0] = gemm_op(b.a4, ME_C, 0, bfp(16), ME_C, 0, M, ME_C, ME_C);
  G.op[0].bias = fp(17);
  G.op[0].bias_once = 1;
  G.op[0].res = static_cast<const bf16*>(pix);
  G.op[0].ldr = ME_C;
  G.op[0].out = b.xa;
  if ((err = gemm_fill(G, st))) return err;

  // fuser: 2 CXBlocks
  if ((err = (int)set_smem(cx_dwln_kernel, DW_SMEM))) return err;
  if ((err = (int)set_smem(cx_mlp_kernel, MlpSmem::BYTES))) return err;
  bf16* x_cur = b.xa;
  bf16* x_nxt = b.xb;
  for (int i = 0; i < 2; ++i) {
    const int o = 18 + 9 * i;
    cx_dwln_kernel<<<dim3((w + DW_TX - 1) / DW_TX, (h + DW_TY - 1) / DW_TY, N),
                     DW_THREADS, DW_SMEM, st>>>(x_cur, b.yb, fp(o), fp(o + 1),
                                                fp(o + 2), fp(o + 3), h, w);
    cx_mlp_kernel<<<(M + MLP_ROWS - 1) / MLP_ROWS, MLP_THREADS, MlpSmem::BYTES,
                    st>>>(b.yb, x_cur, bfp(o + 4), fp(o + 5), bfp(o + 6),
                          fp(o + 7), fp(o + 8), x_nxt, M);
    bf16* t = x_cur;
    x_cur = x_nxt;
    x_nxt = t;
  }

  // out_proj
  G.op[0] = gemm_op(x_cur, ME_C, 0, bfp(36), ME_C, 0, M, out_dim, ME_C);
  G.op[0].bias = fp(37);
  G.op[0].bias_once = 1;
  G.op[0].out = static_cast<bf16*>(out);
  if ((err = gemm_fill(G, st))) return err;
  return (int)cudaGetLastError();
}

extern "C" int memory_encoder_num_weights() { return ME_NUM_WEIGHTS; }
