// Hiera block forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel sam2_video_tpu/ops/hiera_block_kernel.py:fused_block
// (Pallas _block_kernel): LN1 (eps 1e-6) -> shortcut proj + 2x2 max-pool on
// dim-change blocks -> qkv -> windowed or global attention, with pad tokens
// as real keys (k = bk, v = bv: the reference pads after norm1) and 2x2
// q-pooling inside each window -> proj + shortcut -> LN2 -> exact-GELU MLP
// -> residual.
//
// What bounds it on an H100 (SAM2-tiny, 384 px, one frame): ~27 GFLOP of
// bf16 products in qkv/proj/MLP plus ~2.5 GFLOP of attention (about 30 us
// at 989 TFLOP/s) against ~21 MB of block inputs, outputs and weights, each
// moved once, across the 12 blocks (about 6 us at 3.35 TB/s), so the
// products bound it. The design:
//   - every dense product on the pipelined wgmma GEMM of sm90_gemm.cuh
//     (cp.async ring, 128- or 64-row blocks: 64 where 128 would leave the
//     SMs short of two blocks each, at the deep stages' 1,152-14,400 rows):
//     qkv and the dim-change shortcut as one grouped launch over the same
//     xn with kernel #1's bias walk (acc + bias in f32, one rounding), proj
//     and W2 with the residual added before that one rounding, W1 with
//     exact-erf GELU;
//   - the attention on hiera_attn.cuh's wgmma passes, the forward-only
//     instances of the ones kernel #6 recomputes with: several small windows
//     share a 64-row tile under a block-diagonal mask, one pass where a
//     packed group's keys fit one 64-key tile, else two passes over the key
//     tiles (exact softmax; p rounded to bf16 after it is normalised);
//   - the token grid padded to whole windows: LN1 writes zero rows at the
//     pad tokens, so qkv there is the rounded bias, the reference's pad
//     keys, and the shortcut's 2x2 max-pool (or, without q-pool, its copy)
//     reads the grid tokens back from the padded rows.
// Rounding points (xn, qkv, the shortcut, O, x1) are the ones #6's
// recompute uses, so its B2 sees the forward's values and its B1 reads the
// x1 this kernel stores (a caller-owned buffer). The C entry point launches
// the block's kernels in order on the caller's stream (5-8 device
// operations), carves its scratch from one caller-allocated
// workspace (hiera_fwd_workspace_bytes) and returns the first CUDA error.

#include "hiera_attn.cuh"
#include "sm90_gemm.cuh"

// ---------------------------------------------------------------------------
// The shortcut of a dim-change block on the output grid, from its values
// sp on the padded grid: the 2x2 max (q_pool) or the grid token itself.
// 8 channels a thread.
// ---------------------------------------------------------------------------

__global__ void shortcut_fwd_kernel(const bf16* __restrict__ sp,
                                    bf16* __restrict__ sc, HGeo g) {
  const int C8 = g.C / 8;
  const long total = (long)g.B * g.Ho * g.Wo * C8;
  const int f = g.q_pool ? 2 : 1;
  for (long e = blockIdx.x * (long)blockDim.x + threadIdx.x; e < total;
       e += (long)gridDim.x * blockDim.x) {
    const int c = (int)(e % C8) * 8;
    const long p = e / C8;
    const int ox = (int)(p % g.Wo), oy = (int)(p / g.Wo % g.Ho);
    const long b = p / ((long)g.Wo * g.Ho);
    const bf16* s = sp + ((b * g.Hp + f * oy) * g.Wp + f * ox) * g.C + c;
    uint4 v = __ldg(reinterpret_cast<const uint4*>(s));
    if (g.q_pool) {
      const long dn = (long)g.Wp * g.C;
      v = bmax8(bmax8(v, __ldg(reinterpret_cast<const uint4*>(s + g.C))),
                bmax8(__ldg(reinterpret_cast<const uint4*>(s + dn)),
                      __ldg(reinterpret_cast<const uint4*>(s + dn + g.C))));
    }
    *reinterpret_cast<uint4*>(sc + p * g.C + c) = v;
  }
}

// ---------------------------------------------------------------------------
// The MLP half of a narrow block (C = 96 or 192, hidden 4 C), fused per 128
// rows: out = x1 + GELU(LN2(x1) W1^T + b1) W2^T + b2 (one rounding), two
// warpgroups of 64 rows each. LN2 of the block's rows goes into shared
// memory (the walk of ln_fwd: the same bits); per chunk of 64 hidden units
// each warpgroup forms h = y W1_c^T (m64n64, K = C), GELU(h + b1) rounded to
// bf16 in registers as the A operand of out += h W2_c^T (m64n32 per 32
// output columns), so the hidden layer never reaches device memory. W1_c
// and W2_c stream through a cp.async ring; the f32 output goes
// through shared memory for 16-byte stores. (Running the next chunk's h
// beside out's product serialised every wgmma of the kernel: ptxas sees
// the GELU read an accumulator while a product is in flight.)
// ---------------------------------------------------------------------------

constexpr int MR_ROWS = 128, MR_HC = 64, MR_THREADS = 256;

template <int C>
struct MrSmem {
  // C = 96: two stages, so that two blocks share an SM; 192: three, one
  static constexpr int STAGES = C <= 96 ? 2 : 3;
  static constexpr int MINB = C <= 96 ? 2 : 1;
  static constexpr int CB = (C + 63) / 64;            // 64-column blocks of y
  static constexpr int Y = 0;                         // 2 x [64, C] bf16
  static constexpr int W1B = MR_HC * CB * 128;        // W1_c [64, C]
  static constexpr int STAGE = W1B + C * 128;         // + W2_c [C, 64]
  static constexpr int RING = Y + 2 * CB * TILE_COL_BYTES;
  static constexpr int LDT = C + 4;                   // f32 output tile
  static constexpr int BYTES = RING + STAGES * STAGE + 1024;
  static_assert(MR_ROWS * LDT * 4 <= STAGES * STAGE, "output tile fits");
};

template <int C>
__global__ void __launch_bounds__(MR_THREADS, MrSmem<C>::MINB)
mlp_rows_kernel(const bf16* __restrict__ x1, const float* __restrict__ lnw,
                const float* __restrict__ lnb, const bf16* __restrict__ w1,
                const float* __restrict__ b1, const bf16* __restrict__ w2,
                const float* __restrict__ b2, bf16* __restrict__ out, int M) {
  using SM = MrSmem<C>;
  constexpr int HID = 4 * C, NCH = HID / MR_HC, NU = C / 32;
  extern __shared__ unsigned char mr_smem[];
  unsigned char* gen;
  const uint32_t sm = aligned_smem(mr_smem, &gen);
  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5;
  const int q = tid & 3;
  const int r0 = blockIdx.x * MR_ROWS;
  const uint32_t Yw = sm + SM::Y + wg * SM::CB * TILE_COL_BYTES;
  auto slot = [&](int c) { return sm + SM::RING + (c % SM::STAGES) * SM::STAGE; };
  auto load = [&](int c) {
    const uint32_t st = slot(c);
    stage_block<MR_HC, C, MR_THREADS>(st, w1, C, c * MR_HC, HID, 0, C);
    stage_block<C, MR_HC, MR_THREADS>(st + SM::W1B, w2, HID, 0, C, c * MR_HC,
                                      HID);
  };
#pragma unroll
  for (int c = 0; c < SM::STAGES - 1; ++c) {
    if (c < NCH) load(c);
    cp_async_commit();
  }
  // y = LN2(x1) of the block's rows (zeros past M), a warp per row
  for (int r = warp; r < MR_ROWS; r += MR_THREADS / 32) {
    uint4 o[1];
    ln_row<1, 32>(x1 + (size_t)(r0 + r) * C, lnw, lnb, C, 0, r0 + r < M, o);
    const int c = 8 * (tid & 31);
    if (c < C)
      *reinterpret_cast<uint4*>(gen + SM::Y + (r >> 6) * SM::CB * TILE_COL_BYTES +
                                sw128_off(r & 63, c)) = o[0];
  }
  fence_proxy_async();

  float acc[NU][16];
#pragma unroll
  for (int j = 0; j < NU; ++j) zero(acc[j]);
  for (int c = 0; c < NCH; ++c) {
    cp_async_wait<SM::STAGES - 2>();
    fence_proxy_async();
    __syncthreads();                   // chunk c landed, c - 1 consumed
    if (c + SM::STAGES - 1 < NCH) load(c + SM::STAGES - 1);
    cp_async_commit();
    const uint32_t W1s = slot(c), W2s = W1s + SM::W1B;
    float h[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
      wgmma_ss_n64(h, desc_k(Yw, kk * 16), desc_k(W1s, kk * 16), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(h);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      h[i] = gelu_erf(h[i] + __ldg(b1 + c * MR_HC + acc_col(i)));
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_bf16(h, kk, a[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < NU; ++j)
        wgmma_rs_n32_k(acc[j], a[kk], desc_k(W2s + j * 32 * 128, kk * 16));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NU; ++j) fence_regs(acc[j]);
  }
  __syncthreads();                     // every warpgroup is done with the ring

  // out = x1 + acc + b2, one rounding; the f32 tile through the ring
  float* tile = reinterpret_cast<float*>(gen + SM::RING);
  {
    const int g = (tid & 31) >> 2, rl = wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
    for (int j = 0; j < NU; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          *reinterpret_cast<float2*>(tile + (rl + 8 * hh) * SM::LDT + 32 * j +
                                     8 * n + 2 * q) =
              make_float2(acc[j][4 * n + 2 * hh], acc[j][4 * n + 2 * hh + 1]);
  }
  __syncthreads();
#pragma unroll 1
  for (int e = tid; e < MR_ROWS * (C / 8); e += MR_THREADS) {
    const int r = e / (C / 8), c = (e % (C / 8)) * 8;
    if (r0 + r >= M) break;
    const size_t at = (size_t)(r0 + r) * C + c;
    float v[8], bb[8];
    *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(tile + r * SM::LDT + c);
    *reinterpret_cast<float4*>(v + 4) =
        *reinterpret_cast<const float4*>(tile + r * SM::LDT + c + 4);
    *reinterpret_cast<float4*>(bb) = __ldg(reinterpret_cast<const float4*>(b2 + c));
    *reinterpret_cast<float4*>(bb + 4) = __ldg(reinterpret_cast<const float4*>(b2 + c + 4));
    const uint4 xr = __ldg(reinterpret_cast<const uint4*>(x1 + at));
    const bf16* x8 = reinterpret_cast<const bf16*>(&xr);
    uint4 u;
    bf16* ub = reinterpret_cast<bf16*>(&u);
#pragma unroll
    for (int k = 0; k < 8; ++k) ub[k] = to_bf16(v[k] + bb[k] + to_f32(x8[k]));
    *reinterpret_cast<uint4*>(out + at) = u;
  }
}

template <int C>
static int mlp_rows(const bf16* x1, const float* lnw, const float* lnb,
                    const bf16* w1, const float* b1, const bf16* w2,
                    const float* b2, bf16* out, long M, cudaStream_t st) {
  const int err = (int)set_smem(mlp_rows_kernel<C>, MrSmem<C>::BYTES);
  if (err) return err;
  mlp_rows_kernel<C><<<(unsigned)((M + MR_ROWS - 1) / MR_ROWS), MR_THREADS,
                       MrSmem<C>::BYTES, st>>>(x1, lnw, lnb, w1, b1, w2, b2,
                                               out, (int)M);
  return 0;
}

// ---------------------------------------------------------------------------
// Workspace and the C entry point. Weight table (ops/hiera_block_kernel.py
// pack): ln1w ln1b Wqkv bqkv Wproj bproj ln2w ln2b W1 b1 W2 b2 Wsc bsc (the
// last two null without a dim change); products bf16 [out, in], the rest
// f32.
// ---------------------------------------------------------------------------

enum { W_LN1W, W_LN1B, W_QKV, W_BQKV, W_PROJ, W_BPROJ, W_LN2W, W_LN2B, W_1,
       W_B1, W_2, W_B2, W_SC, W_BSC };

// the MLP runs fused (mlp_rows) on the narrow blocks
static bool mlp_fused(int C, int hid) {
  return hid == 4 * C && (C == 96 || C == 192);
}

struct FwdBufs {
  bf16 *xn, *qkv, *sp, *sc, *o, *y, *hid;
};

static FwdBufs carve_fwd(Arena& ar, const HGeo& g, int Cin, int hid, int sc) {
  const long Mp = (long)g.B * g.Hp * g.Wp, Mo = (long)g.B * g.Ho * g.Wo;
  FwdBufs b{};
  b.xn = ar.take<bf16>(Mp * Cin);
  b.qkv = ar.take<bf16>(Mp * 3 * g.C);
  b.sp = sc ? ar.take<bf16>(Mp * g.C) : nullptr;
  b.sc = sc ? ar.take<bf16>(Mo * g.C) : nullptr;
  b.o = ar.take<bf16>(Mo * g.C);
  if (!mlp_fused(g.C, hid)) {
    b.y = ar.take<bf16>(Mo * g.C);
    b.hid = ar.take<bf16>(Mo * hid);
  }
  return b;
}

extern "C" long hiera_fwd_workspace_bytes(int B, int H, int W, int Cin, int C,
                                          int heads, int hid, int wsh,
                                          int wsw, int q_pool, int sc) {
  Arena ar{nullptr, 0};
  carve_fwd(ar, hgeo(B, H, W, C, heads, wsh, wsw, q_pool), Cin, hid, sc);
  return (long)ar.off;
}

// x [B, H, W, Cin] bf16 -> out, x1 (the residual after attention) [B, Ho,
// Wo, C] bf16; wsh x wsw the window (global: H x W)
extern "C" int hiera_block_fwd(const void* x_, void* out_, void* x1_,
                               const void* const* w, void* ws, int B, int H,
                               int W, int Cin, int C, int heads, int hid,
                               int wsh, int wsw, int q_pool,
                               void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const int sc = w[W_SC] != nullptr;
  const HGeo g = hgeo(B, H, W, C, heads, wsh, wsw, q_pool);
  if (g.hd > AT_COLS || g.hd % 8 || C % 32 || Cin % 32 || hid % 32 ||
      Cin > LN_MAX_C || C > LN_MAX_C || (q_pool && (wsh % 2 || wsw % 2)) ||
      (q_pool && !sc))
    return (int)cudaErrorInvalidValue;
  Arena ar{static_cast<char*>(ws), 0};
  const FwdBufs b = carve_fwd(ar, g, Cin, hid, sc);
  auto Wt = [&](int i) { return static_cast<const bf16*>(w[i]); };
  auto F = [&](int i) { return static_cast<const float*>(w[i]); };
  const bf16* x = static_cast<const bf16*>(x_);
  bf16* out = static_cast<bf16*>(out_);
  bf16* x1 = static_cast<bf16*>(x1_);
  const long Mp = (long)B * g.Hp * g.Wp, Mo = (long)B * g.Ho * g.Wo;
  const int C3 = 3 * C;
  int err;

  // xn = LN1(x) on the padded grid; qkv (and the shortcut's values) with
  // the bias walk acc + bias, one rounding
  ln_fwd(x, b.xn, F(W_LN1W), F(W_LN1B), RowMap{H, W, g.Hp, g.Wp}, Mp, Cin,
         st);
  GemmGroup G{};
  G.op[G.n] = gemm_op(b.xn, Cin, 0, Wt(W_QKV), Cin, 0, (int)Mp, C3, Cin);
  G.op[G.n].bias = F(W_BQKV);
  G.op[G.n].bias_once = 1;
  G.op[G.n++].out = b.qkv;
  if (sc) {
    G.op[G.n] = gemm_op(b.xn, Cin, 0, Wt(W_SC), Cin, 0, (int)Mp, C, Cin);
    G.op[G.n].bias = F(W_BSC);
    G.op[G.n].bias_once = 1;
    G.op[G.n++].out = b.sp;
  }
  if ((err = gemm_fill(G, st))) return err;
  if (sc) {
    const long n = Mo * C / 8;
    const unsigned blocks = (unsigned)((n + 255) / 256 < 8192 ? (n + 255) / 256
                                                              : 8192);
    shortcut_fwd_kernel<<<blocks, 256, 0, st>>>(b.sp, b.sc, g);
  }

  // O at the kept queries
  const dim3 gq(g.qtiles, heads, g.ngroups);
  if (g.ktiles == 1) {
    if ((err = (int)set_smem(attn_onepass_kernel<false>, A1Smem::BYTES)))
      return err;
    attn_onepass_kernel<false><<<gq, AT_THREADS, A1Smem::BYTES, st>>>(
        b.qkv, nullptr, b.o, nullptr, nullptr, g);
  } else {
    const int bytes = AfSmem::bytes(g.ktiles);
    if ((err = (int)set_smem(attn_fwd_kernel<false>, bytes))) return err;
    attn_fwd_kernel<false><<<gq, AT_THREADS, bytes, st>>>(b.qkv, nullptr,
                                                         b.o, nullptr, g);
  }

  // x1 = O Wproj^T + bproj + shortcut; y = LN2(x1); hid = GELU(y W1^T +
  // b1); out = hid W2^T + b2 + x1
  G = GemmGroup{};
  G.n = 1;
  G.op[0] = gemm_op(b.o, C, 0, Wt(W_PROJ), C, 0, (int)Mo, C, C);
  G.op[0].bias = F(W_BPROJ);
  G.op[0].bias_once = 1;
  G.op[0].res = sc ? b.sc : x;
  G.op[0].ldr = C;
  G.op[0].out = x1;
  if ((err = gemm_fill(G, st))) return err;
  if (mlp_fused(C, hid)) {
    err = C == 96 ? mlp_rows<96>(x1, F(W_LN2W), F(W_LN2B), Wt(W_1), F(W_B1),
                                 Wt(W_2), F(W_B2), out, Mo, st)
                  : mlp_rows<192>(x1, F(W_LN2W), F(W_LN2B), Wt(W_1), F(W_B1),
                                  Wt(W_2), F(W_B2), out, Mo, st);
    if (err) return err;
    return (int)cudaGetLastError();
  }
  ln_fwd(x1, b.y, F(W_LN2W), F(W_LN2B), RowMap{g.Ho, g.Wo, g.Ho, g.Wo}, Mo, C,
         st);
  G.op[0] = gemm_op(b.y, C, 0, Wt(W_1), C, 0, (int)Mo, hid, C);
  G.op[0].bias = F(W_B1);
  G.op[0].bias_once = 1;
  G.op[0].gelu = 1;
  G.op[0].out = b.hid;
  if ((err = gemm_fill(G, st))) return err;
  G.op[0] = gemm_op(b.hid, hid, 0, Wt(W_2), hid, 0, (int)Mo, C, hid);
  G.op[0].bias = F(W_B2);
  G.op[0].bias_once = 1;
  G.op[0].res = x1;
  G.op[0].ldr = C;
  G.op[0].out = out;
  if ((err = gemm_fill(G, st))) return err;
  return (int)cudaGetLastError();
}
