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
// products forward against ~6 MB of inputs, outputs and weights, a few
// microseconds either way. What costs is latency: a chain of ~15 dependent
// steps, most of them over only T = O N token rows, whose weights (~2.9 MB,
// the MLP 2 MB) one SM would stream from L2 for tens of microseconds. So
// each direction is ONE cooperative launch (plus the memset of its grid
// barrier) of one warpgroup per block, two blocks an SM, that walks the
// chain as stages separated by a grid-wide barrier; in each stage every
// block takes jobs of the stage in turn (job j, j + grid, ...):
//   - products as 64 x 64 output tiles on wgmma (m64n64k16, A and B staged
//     by cp.async into 128-byte-swizzled tiles through a 3-deep ring; A or
//     B read K-major or MN-major by the descriptor, so dx = dy W and dW =
//     dy^T x need no transpose): a token product's weight streams through
//     as many SMs as it has 64-column tiles (the MLP's W1 32, W2 4 x 16 K
//     chunks), never through one;
//   - LayerNorms a warp per row; the attentions on the CUDA cores (head
//     dims 16 and 32 and 8-token sides are below one wgmma tile): the self-
//     attention a job per (object, head); token -> image in three stages
//     (the row statistics per (object, head) in torch's summation order,
//     p and a compensated PV per (object, head, key split), the splits
//     merged in order); image -> token a job per 16 image rows of an
//     object, then its out-projection, residual and LN4 per 32 rows.
// The image rows' products (t2i k and v, i2t q) run in one stage beside
// the self-attention's q, k, v.
//
// The backward mirrors it from the forward's saved activations (the
// forward's workspace, which autograd holds; no recompute programs as the
// TPU's B1 / B2): LN4's backward, i2t's out-projection and attention
// backward per 32 image rows (dK and dV summed over the job's rows, then
// over an object's jobs in order), the token chain back to the self-
// attention, t2i's backward per (object, head, key split) from the
// forward's log-sum-exp, and the image rows' input gradients per (object,
// 64 pixel rows, 64 columns), dkpe then summed over the objects in order.
// Weight gradients are float32: over the token rows one product each (K =
// T), over the image rows K-split into chunks of 512 rows; bias and
// LayerNorm gradients column sums per chunk; every group of partials added
// in chunk order in a later stage. No float atomics anywhere (the barrier
// counts in integers): two runs give the same bits.
//
// Rounding points follow the TPU kernel and the plain block: a projection
// rounds its product, adds the rounded bias and rounds (_mm / linear), then
// adds a residual and rounds; residual and pe adds in bf16; softmax in f32,
// its sums in torch's order and the normalised probabilities rounded to
// bf16 before PV (sm_width, below: so the MLP's ReLU mask mostly agrees
// with the plain block's); the backward
// rounds do, dq, dk and dv to bf16 and dp as the plain block's autograd
// does, and the ReLU mask reads the rounded activation.
//
// The C entry points zero the barrier (cudaMemsetAsync) and launch the
// cooperative kernel on the caller's stream, carve scratch from one
// workspace the caller allocates (twoway_workspace_bytes) and return the
// first CUDA error.

#include "sm90_gemm.cuh"

constexpr int C_ = 256;          // transformer dim
constexpr int HEADS = 8;
constexpr int IS = 256;          // self-attention internal dim (head dim 32)
constexpr int IX = 128;          // cross-attention internal dim (head dim 16)
constexpr int HID = 2048;        // MLP hidden dim
constexpr int HS = IS / HEADS, HX = IX / HEADS;
constexpr float EPS = 1e-5f;

constexpr int TB = 128;          // threads a block: one warpgroup
constexpr int BT = 64;           // rows and columns of a product tile
constexpr int RING = 3;          // cp.async ring depth
constexpr int HALF_B = BT * 64 * 2;            // one 64 x 64 bf16 tile
constexpr int STAGE_B = 2 * HALF_B;            // A and B
constexpr int RING_B = RING * STAGE_B;
constexpr int SPLIT_TARGET = 256;   // jobs the t2i key splits aim at
constexpr int SCORE_FLOATS = 4096;  // a t2i split's scores in shared memory
constexpr int MAX_CHUNK = 512;      // keys of a t2i split
constexpr int JR = 32;              // image rows of an i2t job
constexpr int I2T_ROWS = 16;        // image rows of an i2t attention job
constexpr int T2I_KC = 1024;        // keys of a staged t2i chunk (statistics)
constexpr float SCALE_S = 0.17677669529663687f;   // 1 / sqrt(32), rounded
constexpr int IMG_CHUNK = 512;      // image rows per weight-gradient chunk
constexpr int LN_ROWS = 16;         // token rows per LayerNorm-backward job
constexpr unsigned SPIN_LIMIT = 1u << 22;   // barrier polls before a trap

// operand table (ops/twoway_kernel.py pack): bf16 products [out, in], f32
// vectors. TKQ stacks token->image k_proj over image->token q_proj: both
// read K0 + kpe.
enum {
  W_SQKV, B_SQKV, W_SO, B_SO, LN1W, LN1B,
  W_TQ, B_TQ, W_TKQ, B_TKQ, W_TV, B_TV, W_TO, B_TO, LN2W, LN2B,
  W_M1, B_M1, W_M2, B_M2, LN3W, LN3B,
  W_IK, B_IK, W_IV, B_IV, W_IO, B_IO, LN4W, LN4B, W_NUM
};

// f32 gradient layout (the LEAVES order): the token-row gradients, then
// the image-row ones at G_TOKEN + I_*.
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
constexpr long I_TKQ = 0, I_TBKQ = I_TKQ + 2L * IX * C_,
               I_TV = I_TBKQ + 2 * IX, I_TBV = I_TV + (long)IX * C_,
               I_IO = I_TBV + IX, I_IBO = I_IO + (long)C_ * IX,
               I_LN4W = I_IBO + C_, I_LN4B = I_LN4W + C_,
               I_TOTAL = I_LN4B + C_;

extern "C" long twoway_grad_floats() { return G_TOKEN + I_TOTAL; }

__host__ __device__ inline int cdv(long a, long b) { return (int)((a + b - 1) / b); }

// ---------------------------------------------------------------------------
// Buffers and the launch context
// ---------------------------------------------------------------------------

struct FwdBufs {                 // the forward's activations, kept
  unsigned* bar;
  bf16 *kin, *q0, *sqkv, *so, *pre1, *x1, *x1pe, *tq, *to, *pre2, *x2, *r,
      *pre3, *x3pe, *ikv;                            // token rows
  bf16 *kq, *tv, *io, *pre4;                         // image rows
  float *tstat, *tacc, *to32, *lse, *p3;      // t2i's splits, output, W2
};

struct BwdBufs {
  unsigned* bar;
  float *dpre4, *ln4p, *ikvp, *dqd, *dxa, *dpre3, *dx2p, *dpre2, *dqp,
      *dqb, *dpre1, *lnp3, *lnp2, *lnp1, *wtkqp, *wtvp, *wiop, *btkqp, *btvp,
      *biop, *kd;
  bf16 *dpre4b, *dkq, *dikv, *dpre3b, *dh, *dpre2b, *do2, *dvt, *dqt,
      *dpre1b, *dos, *dsqkv;
};

struct Geo {
  int O, N, HW, T, S;
  int rt, rs;                    // 64-row tiles of the token / image rows
  int tiles_hw;                  // 64-row tiles of one object's image rows
  int jobs_hw;                   // JR-row i2t jobs of one object
  int ns, chunk;                 // t2i key splits and keys per split
  int ks3;                       // K chunks of the W2 products
  int img_chunks;                // IMG_CHUNK-row chunks of the image rows
  int g0;                        // row groups of i2t's dK / dV sums
};

static Geo geo(int O, int N, int HW) {
  Geo g{};
  g.O = O, g.N = N, g.HW = HW, g.T = O * N, g.S = O * HW;
  g.rt = cdv(g.T, BT), g.rs = cdv(g.S, BT), g.tiles_hw = cdv(HW, BT);
  g.jobs_hw = cdv(HW, JR);
  int ns = cdv(SPLIT_TARGET, O * HEADS);
  ns = ns < cdv(HW, BT) ? ns : cdv(HW, BT);
  int chunk = cdv(HW, ns);
  if ((long)chunk * N > SCORE_FLOATS) chunk = SCORE_FLOATS / N > 0 ? SCORE_FLOATS / N : 1;
  chunk = chunk < MAX_CHUNK ? chunk : MAX_CHUNK;
  g.chunk = chunk;
  g.ns = cdv(HW, chunk);
  g.ks3 = 1;
  while (g.ks3 < 16 && g.rt * 4 * g.ks3 * 2 <= 128) g.ks3 *= 2;
  g.img_chunks = cdv(g.S, IMG_CHUNK);
  int g0 = 16 / N;
  g.g0 = g0 < 1 ? 1 : g0 > 4 ? 4 : g0;
  return g;
}

static FwdBufs carve_fwd(Arena& ar, const Geo& g) {
  const long T = g.T, S = g.S;
  FwdBufs f{};
  f.bar = ar.take<unsigned>(64);
  f.kin = ar.take<bf16>(S * C_);
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
  f.kq = ar.take<bf16>(S * 2 * IX);
  f.tv = ar.take<bf16>(S * IX);
  f.io = ar.take<bf16>(S * IX);
  f.pre4 = ar.take<bf16>(S * C_);
  f.tstat = ar.take<float>((long)g.O * HEADS * g.N * 2);
  f.tacc = ar.take<float>((long)g.O * HEADS * g.ns * g.N * HX * 2);
  f.to32 = ar.take<float>(T * IX);
  f.lse = ar.take<float>((long)g.O * HEADS * g.N);
  f.p3 = ar.take<float>((long)g.ks3 * T * C_);
  return f;
}

static BwdBufs carve_bwd(Arena& ar, const Geo& g) {
  const long T = g.T, S = g.S;
  const long jobs = (long)g.O * g.jobs_hw, lnj = cdv(T, LN_ROWS);
  const long ic = g.img_chunks;
  BwdBufs b{};
  b.bar = ar.take<unsigned>(64);
  b.dpre4 = ar.take<float>(S * C_);
  b.ln4p = ar.take<float>(jobs * 2 * C_);
  b.ikvp = ar.take<float>(jobs * g.N * 2 * IX);
  b.dqd = ar.take<float>(T * C_);
  b.dxa = ar.take<float>(T * C_);
  b.dpre3 = ar.take<float>(T * C_);
  b.dx2p = ar.take<float>((long)g.ks3 * T * C_);
  b.dpre2 = ar.take<float>(T * C_);
  b.dqp = ar.take<float>((long)g.O * HEADS * g.ns * g.N * HX);
  b.dqb = ar.take<float>(T * C_);
  b.dpre1 = ar.take<float>(T * C_);
  b.lnp3 = ar.take<float>(lnj * 2 * C_);
  b.lnp2 = ar.take<float>(lnj * 2 * C_);
  b.lnp1 = ar.take<float>(lnj * 2 * C_);
  b.wtkqp = ar.take<float>(ic * 2 * IX * C_);
  b.wtvp = ar.take<float>(ic * IX * C_);
  b.wiop = ar.take<float>(ic * C_ * IX);
  b.btkqp = ar.take<float>(ic * 2 * IX);
  b.btvp = ar.take<float>(ic * IX);
  b.biop = ar.take<float>(ic * C_);
  b.kd = ar.take<float>(S * C_);
  b.dpre4b = ar.take<bf16>(S * C_);
  b.dkq = ar.take<bf16>(S * 2 * IX);
  b.dikv = ar.take<bf16>(T * 2 * IX);
  b.dpre3b = ar.take<bf16>(T * C_);
  b.dh = ar.take<bf16>(T * HID);
  b.dpre2b = ar.take<bf16>(T * C_);
  b.do2 = ar.take<bf16>(T * IX);
  b.dvt = ar.take<bf16>(S * IX);
  b.dqt = ar.take<bf16>(T * IX);
  b.dpre1b = ar.take<bf16>(T * C_);
  b.dos = ar.take<bf16>(T * IS);
  b.dsqkv = ar.take<bf16>(T * 3 * IS);
  return b;
}

// bytes of the forward's saved activations (bwd = 0) or of the backward's
// scratch (bwd = 1)
extern "C" long twoway_workspace_bytes(int O, int N, int HW, int bwd) {
  Arena ar{nullptr, 0};
  const Geo g = geo(O, N, HW);
  if (bwd)
    carve_bwd(ar, g);
  else
    carve_fwd(ar, g);
  return (long)ar.off;
}

// byte offset in the forward's saved activations of the MLP's hidden
// relu(x2 W1^T + b1), bf16 [O N, 2048]: its ReLU mask is the one the
// backward reads
extern "C" long twoway_hidden_offset(int O, int N, int HW) {
  char* const base = reinterpret_cast<char*>(uintptr_t{1} << 20);
  Arena ar{base, 0};
  return reinterpret_cast<char*>(carve_fwd(ar, geo(O, N, HW)).r) - base;
}

// a weight-gradient partial sum: G[dst + e] = sum over i < count of
// src[i stride + e], i in order
struct WSeg {
  const float* src;
  long stride, len, dst;
  int count;
};
constexpr int MAX_SEGS = 16;
// the segments of each group, by the stage whose partials they add
constexpr int SEG_LN4 = 0, SEG_LN3 = 2, SEG_LN2 = 4, SEG_IMG = 6, SEG_LN1 = 12,
              SEG_END = 14;

struct Ctx {
  const bf16 *x, *k0, *qpe, *kpe;
  const void* w[W_NUM];
  bf16 *xout, *kout;
  const bf16 *dxo, *dko;          // backward: the outputs' cotangents
  bf16 *dx, *dk0, *dqpe, *dkpe;
  float* G;
  FwdBufs f;
  BwdBufs b;
  Geo g;
  int first, wgrad, nseg;
  WSeg seg[MAX_SEGS];
};

// ---------------------------------------------------------------------------
// Device pieces: the grid barrier, loads, the product tile, epilogues
// ---------------------------------------------------------------------------

// every block arrives, then waits for all gridDim.x (co-resident: a
// cooperative launch); `target` counts the arrivals expected so far and is
// the same in every block. Writes before it are visible after it.
__device__ __forceinline__ void grid_sync(unsigned* count, unsigned& target) {
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    unsigned spins = 0, v;
    while (true) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(v) : "l"(count) : "memory");
      if ((int)(v - target) >= 0) break;
      __nanosleep(32);
      if (++spins > SPIN_LIMIT) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ const float* wf(const Ctx& c, int i) {
  return static_cast<const float*>(c.w[i]);
}
__device__ __forceinline__ const bf16* wb(const Ctx& c, int i) {
  return static_cast<const bf16*>(c.w[i]);
}

// a value written earlier in this launch: through L2 (no stale L1 line)
__device__ __forceinline__ float ldf(const bf16* p) { return to_f32(__ldcg(p)); }

__device__ __forceinline__ void unpack8(uint4 u, float* v) {
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int t = 0; t < 8; ++t) v[t] = to_f32(e[t]);
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 u;
  bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int t = 0; t < 8; ++t) e[t] = to_bf16(v[t]);
  return u;
}

// 16 consecutive bf16 (32-byte aligned) as f32
__device__ __forceinline__ void ld16(const bf16* p, float (&v)[16]) {
  unpack8(__ldcg(reinterpret_cast<const uint4*>(p)), v);
  unpack8(__ldcg(reinterpret_cast<const uint4*>(p + 8)), v + 8);
}

__device__ __forceinline__ void st16(bf16* p, const float (&v)[16]) {
  *reinterpret_cast<uint4*>(p) = pack8(v);
  *reinterpret_cast<uint4*>(p + 8) = pack8(v + 8);
}

__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float dot16(const float (&a)[16], const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < 16; ++d) s += a[d] * b[d];
  return s;
}

__device__ __forceinline__ float wmax(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffff, v, o));
  return v;
}

// The softmax denominators are summed in the order of torch's CUDA softmax
// (ATen's softmax_warp_forward for D <= 1024, cunn_SoftMaxForwardReg
// above; checked bit for bit against torch 2.11.0+cu128 on an H100, and
// tests/test_torch_port_cuda.py test_torch_softmax_sum_order fails if a
// torch build sums otherwise): D <= 1024: sm_width(D) = min(32, next
// power of two of D) lanes, lane l adding j = l, l + width, .. in order
// from 0, then a butterfly over the lanes (tree_sum); D > 1024: 1024
// threads t adding j = t, t + 1024, .., a tree over each warp's 32 sums,
// then over the 32 warps'. The self and i2t PV products are chains of FMAs
// over the keys in order, t2i's a compensated sum (f_t2i_pv). So p and o
// mostly round to bf16 as the plain block's do, and the MLP's ReLU mask
// mostly agrees with it; that closeness is all the order buys: the card
// tests hold the gradients to the plain backward taken through the
// kernel's own ReLU mask (twoway_hidden_offset), whatever the order.
__host__ __device__ inline int sm_width(int D) {
  if (D > 1024) return 1024;
  int w = 1;
  while (w < D && w < 32) w <<= 1;
  return w;
}

// v[0] after v[i] += v[i + off] for i < off, off = W / 2 .. 1 (W a power
// of two): a butterfly's sum as lane 0 sees it
__device__ __forceinline__ float tree_sum(float* v, int W) {
  for (int off = W >> 1; off > 0; off >>= 1)
    for (int i = 0; i < off; ++i) v[i] += v[i + off];
  return v[0];
}

// the same over the lanes of a warp (lanes at and past W do not take
// part); every lane returns it
__device__ __forceinline__ float warp_tree_sum(float v, int W) {
  for (int off = W >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffff, v, off);
  return __shfl_sync(0xffffffff, v, 0);
}

// 16-byte aligned shared memory after n floats at f
__device__ __forceinline__ bf16* kv_after(float* f, int n) {
  return reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(f + n) + 15) & ~(uintptr_t)15);
}

// the layout of f_t2i_stats' shared memory from the dynamic base (the ring
// is free in that stage), in bytes: the keys of a chunk of CH keys, the
// chunk's scores for a group of QG queries, the group's partial sums of the
// softmax denominator, the queries
struct T2iSmem {
  int CH, QG, V, kc, s, part, qs, bytes;
  __host__ __device__ T2iSmem(int HW) {
    V = sm_width(HW);
    CH = HW <= T2I_KC ? HW : T2I_KC / 2;
    QG = HW <= T2I_KC ? 2 : 1;
    kc = 0;
    s = kc + CH * HX * 2;
    part = s + QG * CH * 4;
    qs = part + QG * V * 4;
    bytes = qs + QG * HX * 4;
  }
};

// C(m, n) = sum_k A(m, k) B(n, k): A(m, k) at a[m lda + k] (ta = 0) or
// a[k lda + m] (ta = 1), B(n, k) at b[n ldb + k] or b[k ldb + n]; rows of
// A past M and of B past N read as zeros
struct Prod {
  const bf16* a;
  long lda;
  int ta;
  const bf16* b;
  long ldb;
  int tb;
  int M, N;
};

__device__ __forceinline__ Prod prod(const bf16* a, long lda, int ta,
                                     const bf16* b, long ldb, int tb, int M,
                                     int N) {
  return Prod{a, lda, ta, b, ldb, tb, M, N};
}

// acc = the 64 x 64 tile (m0, n0) of C over k in [k0, k1) (k1 % 8 == 0
// where an operand holds K along its rows), 64-deep chunks through the
// ring; the ring is free again on return. With cs (A read MN-major), also
// A's column sums over the rows [k0, k1) into cs[m0 ..] (a bias gradient:
// the rows are in shared memory already), in a fixed order; gring is the
// ring's generic address.
__device__ void prod_tile(float (&acc)[32], const Prod& p, int m0, int n0,
                          int k0, int k1, uint32_t ring,
                          unsigned char* gring = nullptr,
                          float* cs = nullptr) {
  const int nk = cdv(k1 - k0, 64);
  auto load = [&](int i) {
    const uint32_t As = ring + (i % RING) * STAGE_B, Bs = As + HALF_B;
    const int kc = k0 + 64 * i;
    if (p.ta)
      stage_block<64, 64, TB>(As, p.a, p.lda, kc, k1, m0, p.M);
    else
      stage_block<64, 64, TB>(As, p.a, p.lda, m0, p.M, kc, k1);
    if (p.tb)
      stage_block<64, 64, TB>(Bs, p.b, p.ldb, kc, k1, n0, p.N);
    else
      stage_block<64, 64, TB>(Bs, p.b, p.ldb, n0, p.N, kc, k1);
  };
  zero(acc);
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  float csum = 0.f;                    // column tid % 64, half the rows
  const int cs_col = threadIdx.x & 63, cs_r0 = (threadIdx.x >> 6) * 32;
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<RING - 2>();
    fence_proxy_async();
    __syncthreads();                   // chunk i landed, i - 1 consumed
    if (i + RING - 1 < nk) load(i + RING - 1);
    cp_async_commit();
    const uint32_t As = ring + (i % RING) * STAGE_B, Bs = As + HALF_B;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (!p.ta && !p.tb)
        wgmma_ss_n64(acc, desc_k(As, 16 * kk), desc_k(Bs, 16 * kk), 1);
      else if (!p.ta)
        wgmma_ss_n64_bmn(acc, desc_k(As, 16 * kk), desc_mn(Bs, 16 * kk, 0), 1);
      else
        wgmma_ss_n64_mn(acc, desc_mn(As, 16 * kk, 0), desc_mn(Bs, 16 * kk, 0));
    }
    wgmma_commit();
    if (cs) {                          // rows past k1 are zero-filled
      const unsigned char* Ag = gring + (i % RING) * STAGE_B;
      float a = 0.f;
#pragma unroll 8
      for (int r = cs_r0; r < cs_r0 + 32; ++r)
        a += to_f32(*reinterpret_cast<const bf16*>(Ag + sw128_off(r, cs_col)));
      csum += a;
    }
    wgmma_wait<0>();
    fence_regs(acc);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (cs) {
    float* red = reinterpret_cast<float*>(gring);
    red[threadIdx.x] = csum;
    __syncthreads();
    if (threadIdx.x < 64 && m0 + (int)threadIdx.x < p.M)
      cs[m0 + threadIdx.x] = red[threadIdx.x] + red[threadIdx.x + 64];
    __syncthreads();
  }
}

// f(row, col, v(row, col), v(row, col + 1)) over this thread's accumulator
template <class F>
__device__ __forceinline__ void each_pair(const float (&acc)[32], int m0,
                                          int n0, F f) {
  const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < 8; ++n)
      f(m0 + 16 * w + g + 8 * h, n0 + 8 * n + 2 * q, acc[4 * n + 2 * h],
        acc[4 * n + 2 * h + 1]);
}

// this thread's first accumulator row and column in a tile at (m0, n0)
__device__ __forceinline__ int acc_r0(int m0) {
  return m0 + 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);
}
__device__ __forceinline__ int acc_c0(int n0) {
  return n0 + 2 * (threadIdx.x & 3);
}

// v[4 n + 2 h + e] = src(row r0 + 8 h, column c0 + 8 n + e) (f32 or bf16
// [., ld]), zero past row M: an epilogue's operand, loaded before its
// stores (a load after a store waits for it)
__device__ __forceinline__ void gather(float (&v)[32], const float* src,
                                       long ld, int r0, int c0, int M) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float2 t = make_float2(0.f, 0.f);
      if (r0 + 8 * h < M)
        t = __ldcg(reinterpret_cast<const float2*>(
            src + (long)(r0 + 8 * h) * ld + c0 + 8 * n));
      v[4 * n + 2 * h] = t.x;
      v[4 * n + 2 * h + 1] = t.y;
    }
}
__device__ __forceinline__ void gather(float (&v)[32], const bf16* src,
                                       long ld, int r0, int c0, int M) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float2 t = make_float2(0.f, 0.f);
      if (r0 + 8 * h < M)
        t = __bfloat1622float2(__ldcg(reinterpret_cast<const __nv_bfloat162*>(
            src + (long)(r0 + 8 * h) * ld + c0 + 8 * n)));
      v[4 * n + 2 * h] = t.x;
      v[4 * n + 2 * h + 1] = t.y;
    }
}

// a projection's bf16 walk: round(round(acc) + round(bias)), optionally
// ReLU'd, + a bf16 residual, round; rows below M
__device__ __forceinline__ void epi_linear(const float (&acc)[32], int m0,
                                           int n0, int M, const float* bias,
                                           bool relu, const bf16* res,
                                           long ldr, bf16* out, long ldo) {
  const int r0 = acc_r0(m0), c0 = acc_c0(n0);
  float bv[16], rv[32];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    bv[2 * n] = rb(__ldg(bias + c0 + 8 * n));
    bv[2 * n + 1] = rb(__ldg(bias + c0 + 8 * n + 1));
  }
  if (res) gather(rv, res, ldr, r0, c0, M);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r0 + 8 * h >= M) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int i = 4 * n + 2 * h;
      float v0 = rb(rb(acc[i]) + bv[2 * n]);
      float v1 = rb(rb(acc[i + 1]) + bv[2 * n + 1]);
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      if (res) {
        v0 += rv[i];
        v1 += rv[i + 1];
      }
      st2(out + (long)(r0 + 8 * h) * ldo + c0 + 8 * n, v0, v1);
    }
  }
}

__device__ __forceinline__ void epi_f32(const float (&acc)[32], int m0,
                                        int n0, int M, float* out, long ldo) {
  each_pair(acc, m0, n0, [&](int r, int cc, float a, float b) {
    if (r < M)
      *reinterpret_cast<float2*>(out + (long)r * ldo + cc) = make_float2(a, b);
  });
}

// bf16 store, zero where mask <= 0 (mask null: none)
__device__ __forceinline__ void epi_bf16(const float (&acc)[32], int m0,
                                         int n0, int M, bf16* out, long ldo,
                                         const bf16* mask) {
  const int r0 = acc_r0(m0), c0 = acc_c0(n0);
  float mv[32];
  if (mask) gather(mv, mask, ldo, r0, c0, M);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r0 + 8 * h >= M) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int i = 4 * n + 2 * h;
      float a = acc[i], b = acc[i + 1];
      if (mask) {
        a = mv[i] > 0.f ? a : 0.f;
        b = mv[i + 1] > 0.f ? b : 0.f;
      }
      st2(out + (long)(r0 + 8 * h) * ldo + c0 + 8 * n, a, b);
    }
  }
}

// the 64 x 64 tile (m0, n0) of job j of a product over M x N tiles
__device__ __forceinline__ void tile_at(int j, int N, int& m0, int& n0) {
  m0 = (j / (N / BT)) * BT;
  n0 = (j % (N / BT)) * BT;
}

// a weight gradient over the token rows, dW[M, N] = sum over T rows of
// dy(r, m) x(r, n), tile j, straight into the f32 gradient buffer
__device__ __forceinline__ void wgrad_tok(const Ctx& c, int j, const bf16* dy,
                                          long ldy, const bf16* x, long ldx,
                                          int M, int N, float* out,
                                          uint32_t ring) {
  int m0, n0;
  tile_at(j, N, m0, n0);
  float acc[32];
  prod_tile(acc, prod(dy, ldy, 1, x, ldx, 1, M, N), m0, n0, 0, c.g.T, ring);
  epi_f32(acc, m0, n0, M, out, N);
}

// ... over the image rows, chunk ch of IMG_CHUNK rows into part[ch], and
// with cs the chunk's column sums of dy into cs[ch] (the bias gradient)
__device__ __forceinline__ void wgrad_img(const Ctx& c, int j, const bf16* dy,
                                          long ldy, const bf16* x, long ldx,
                                          int M, int N, float* part,
                                          float* cs, unsigned char* gen,
                                          uint32_t ring) {
  const int tiles = (M / BT) * (N / BT), ch = j / tiles;
  int m0, n0;
  tile_at(j % tiles, N, m0, n0);
  float acc[32];
  const int k0 = ch * IMG_CHUNK;
  const int k1 = k0 + IMG_CHUNK < c.g.S ? k0 + IMG_CHUNK : c.g.S;
  prod_tile(acc, prod(dy, ldy, 1, x, ldx, 1, M, N), m0, n0, k0, k1, ring,
            gen, n0 == 0 ? cs + (long)ch * M : nullptr);
  epi_f32(acc, m0, n0, M, part + (long)ch * M * N, N);
}

// column sums of a bf16 [rows, ld] matrix over the rows [r0, r1) into
// out[col0 ..], a thread per column adding the rows in order
__device__ __forceinline__ void colsum(const bf16* a, long ld, int ncols,
                                       int r0, int r1, int col0, float* out) {
  const int cc = col0 + threadIdx.x;
  if (cc >= ncols) return;
  float s = 0.f;
#pragma unroll 8
  for (int r = r0; r < r1; ++r) s += ldf(a + (long)r * ld + cc);
  out[cc] = s;
}

// the weight-gradient partials of segments [s0, s1), added in order: a
// job per 512 values of a segment, 4 a thread (none without wgrad)
__device__ __forceinline__ int red_jobs(const Ctx& c, int s0, int s1) {
  int n = 0;
  for (int s = s0; c.wgrad && s < s1; ++s) n += cdv(c.seg[s].len, 512);
  return n;
}

__device__ void red_job(const Ctx& c, int s0, int j) {
  int s = s0;
  while (j >= cdv(c.seg[s].len, 512)) j -= cdv(c.seg[s++].len, 512);
  const WSeg& q = c.seg[s];
  const long e = (long)j * 512 + 4 * threadIdx.x;
  if (e >= q.len) return;
  const float* src = q.src + e;
  float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
  int i = 0;
  for (; i + 4 <= q.count; i += 4) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = __ldcg(reinterpret_cast<const float4*>(src + (long)(i + u) * q.stride));
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      t.x += v[u].x;
      t.y += v[u].y;
      t.z += v[u].z;
      t.w += v[u].w;
    }
  }
  for (; i < q.count; ++i) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(src + (long)i * q.stride));
    t.x += v.x;
    t.y += v.y;
    t.z += v.z;
    t.w += v.w;
  }
  *reinterpret_cast<float4*>(c.G + q.dst + e) = t;
}

// ---------------------------------------------------------------------------
// Rows: LayerNorm forward and backward, a warp per row of C_, lane l
// holding columns l + 32 i
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ln_stats(const float (&v)[8], float& mu,
                                         float& rs) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += v[i];
  mu = warp_sum(s) / C_;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) q += (v[i] - mu) * (v[i] - mu);
  rs = rsqrtf(warp_sum(q) / C_ + EPS);
}

// y = LN(v) rounded; ype = bf16(y + pe) where pe is given
__device__ __forceinline__ void ln_out(const float (&v)[8], const float* w,
                                       const float* b, bf16* y, const bf16* pe,
                                       bf16* ype, int lane) {
  float mu, rs;
  ln_stats(v, mu, rs);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int cc = lane + 32 * i;
    const bf16 o = to_bf16((v[i] - mu) * rs * __ldg(w + cc) + __ldg(b + cc));
    y[cc] = o;
    if (ype) ype[cc] = to_bf16(to_f32(o) + to_f32(__ldg(pe + cc)));
  }
}

// the LayerNorm backward of one row: xv the forward's input row, dy the
// incoming gradient; dx = rinv (dxh - mean(dxh) - xhat mean(dxh xhat)),
// dxh = dy w; pw += dy xhat, pb += dy (the LN weight's and bias' sums)
__device__ __forceinline__ void ln_bwd_row(float (&xv)[8], const float* w,
                                           const float (&dy)[8],
                                           float (&dx)[8], float (&pw)[8],
                                           float (&pb)[8], int lane) {
  float mu, rinv;
  ln_stats(xv, mu, rinv);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    xv[i] = (xv[i] - mu) * rinv;
    pw[i] += dy[i] * xv[i];
    pb[i] += dy[i];
    dx[i] = dy[i] * __ldg(w + lane + 32 * i);
    s1 += dx[i];
    s2 += dx[i] * xv[i];
  }
  const float m1 = warp_sum(s1) / C_, m2 = warp_sum(s2) / C_;
#pragma unroll
  for (int i = 0; i < 8; ++i) dx[i] = rinv * (dx[i] - m1 - xv[i] * m2);
}

// the 4 warps' per-lane column sums red[warp][n] (n < 32 * per) added in
// warp order into out[0 .. n)
__device__ __forceinline__ void warps_to(const float* red, int n, float* out) {
  for (int e = threadIdx.x; e < n; e += TB)
    out[e] = ((red[e] + red[n + e]) + red[2 * n + e]) + red[3 * n + e];
}

// ---------------------------------------------------------------------------
// Shared memory (dynamic, 1024-byte aligned): the product ring, then the
// stage's scratch
// ---------------------------------------------------------------------------

constexpr int SCR = RING_B;                      // scratch offset
constexpr int IO_B = BT * IX * 2;                // a 64 x 128 bf16 tile
constexpr int PRE_LD = C_ + 8;                   // bf16 row tile stride
constexpr int PRE_B = BT * PRE_LD * 2;

// the forward's shared memory, the largest stage's: the self-attention's
// head slices and scores, t2i's statistics (from the dynamic base) or its
// splits (scores, queries, statistics), i2t's keys and values, or the
// image tail (io tile, pre4 rows)
static int fwd_smem(const Geo& g) {
  const int self = SCR + (3 * g.N * HS + g.N * g.N) * 4;
  const int t2i = T2iSmem(g.HW).bytes;
  const int pv = SCR + (SCORE_FLOATS + g.N * (HX + 2)) * 4;
  const int tail = SCR + IO_B + PRE_B;
  const int i2t = SCR + g.N * 2 * IX * 2;
  int m = t2i > tail ? t2i : tail;
  m = m > pv ? m : pv;
  m = m > i2t ? m : i2t;
  return 1024 + (m > self ? m : self);
}

// the backward's: i2t (the pre4 tile over the q and do tiles, keys and
// values, statistics, dK / dV and LN sums), t2i splits, the self-
// attention's head slices, ds and p
static int bwd_i2t_red(const Geo& g) {
  const int a = g.g0 * g.N * 2 * IX * 4;
  return a > 4 * 2 * C_ * 4 ? a : 4 * 2 * C_ * 4;
}

static int bwd_smem(const Geo& g) {
  const int i2t = 2 * BT * IX * 2 + g.N * 2 * IX * 2 + BT * HEADS * 3 * 4 +
                  bwd_i2t_red(g);
  const int t2i = SCORE_FLOATS * 4 + g.N * (3 * HX + 2) * 4 + 16 +
                  2 * MAX_CHUNK * HX * 2;
  const int self = (4 * g.N * HS + 2 * g.N * g.N) * 4;
  int m = i2t > t2i ? i2t : t2i;
  m = m > self ? m : self;
  return 1024 + SCR + m;
}

// ===========================================================================
// Forward stages
// ===========================================================================

// kin = K0 + kpe over the image rows, q0 = x + qpe over the token rows
__device__ void f_prep(const Ctx& c) {
  const long img = (long)c.g.S * (C_ / 8);
  const long tok = c.first ? 0 : (long)c.g.T * (C_ / 8);
  for (long e = blockIdx.x * (long)TB + threadIdx.x; e < img + tok;
       e += (long)gridDim.x * TB) {
    float a[8], b[8];
    if (e < img) {
      const long r = e / (C_ / 8);
      const int cc = (int)(e % (C_ / 8)) * 8;
      unpack8(__ldg(reinterpret_cast<const uint4*>(c.k0 + r * C_ + cc)), a);
      unpack8(__ldg(reinterpret_cast<const uint4*>(
                  c.kpe + (r % c.g.HW) * C_ + cc)), b);
#pragma unroll
      for (int t = 0; t < 8; ++t) a[t] += b[t];
      *reinterpret_cast<uint4*>(c.f.kin + r * C_ + cc) = pack8(a);
    } else {
      const long i = (e - img) * 8;
      unpack8(__ldg(reinterpret_cast<const uint4*>(c.x + i)), a);
      unpack8(__ldg(reinterpret_cast<const uint4*>(c.qpe + i)), b);
#pragma unroll
      for (int t = 0; t < 8; ++t) a[t] += b[t];
      *reinterpret_cast<uint4*>(c.f.q0 + i) = pack8(a);
    }
  }
}

// image rows: [t2i k | i2t q] = kin Wtkq^T + b, t2i v = K0 Wtv^T + b;
// token rows: the self-attention's q, k (from x + qpe, or x in the first
// block) and v (from x)
__device__ void f_proj(const Ctx& c, uint32_t ring) {
  const Geo& g = c.g;
  const int n1 = g.rs * 4, n2 = n1 + g.rs * 2, n3 = n2 + g.rt * 12;
  for (int j = blockIdx.x; j < n3; j += gridDim.x) {
    float acc[32];
    int m0, n0;
    if (j < n1) {
      tile_at(j, 2 * IX, m0, n0);
      prod_tile(acc, prod(c.f.kin, C_, 0, wb(c, W_TKQ), C_, 0, g.S, 2 * IX),
                m0, n0, 0, C_, ring);
      epi_linear(acc, m0, n0, g.S, wf(c, B_TKQ), false, nullptr, 0, c.f.kq,
                 2 * IX);
    } else if (j < n2) {
      tile_at(j - n1, IX, m0, n0);
      prod_tile(acc, prod(c.k0, C_, 0, wb(c, W_TV), C_, 0, g.S, IX), m0, n0,
                0, C_, ring);
      epi_linear(acc, m0, n0, g.S, wf(c, B_TV), false, nullptr, 0, c.f.tv, IX);
    } else {
      tile_at(j - n2, 3 * IS, m0, n0);
      const bf16* a = n0 < 2 * IS && !c.first ? c.f.q0 : c.x;
      prod_tile(acc, prod(a, C_, 0, wb(c, W_SQKV), C_, 0, g.T, 3 * IS), m0,
                n0, 0, C_, ring);
      epi_linear(acc, m0, n0, g.T, wf(c, B_SQKV), false, nullptr, 0,
                 c.f.sqkv, 3 * IS);
    }
  }
}

// self-attention, a job per (object, head): the head's q, k and v rows in
// shared memory, the scores (each a sequential sum over the dimension, a
// thread per query and key), then a warp per query, lane = the head's
// dimension: the softmax sum in torch's order, p rounded to bf16, PV a chain
// over the keys
__device__ void f_self(const Ctx& c, unsigned char* gen) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, N = c.g.N;
  const int W = sm_width(N);
  float* sq = reinterpret_cast<float*>(gen + SCR);
  float* sk = sq + N * HS;
  float* sv = sk + N * HS;
  float* S = sv + N * HS;                            // [N][N]
  for (int j = blockIdx.x; j < c.g.O * HEADS; j += gridDim.x) {
    const int o = j / HEADS, h = j % HEADS;
    for (int e = threadIdx.x; e < N * HS; e += TB) {
      const bf16* src = c.f.sqkv + (long)(o * N + e / HS) * 3 * IS + h * HS + e % HS;
      sq[e] = ldf(src);
      sk[e] = ldf(src + IS);
      sv[e] = ldf(src + 2 * IS);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < N * N; e += TB) {
      const float* qi = sq + (e / N) * HS;
      const float* kk = sk + (e % N) * HS;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < HS; ++d) s += qi[d] * kk[d];
      S[e] = s * SCALE_S;
    }
    __syncthreads();
    for (int i = warp; i < N; i += TB / 32) {
      const float* si = S + i * N;
      float m = -INFINITY;
      for (int k = 0; k < N; ++k) m = fmaxf(m, si[k]);
      float part = 0.f;
      for (int k = lane; k < N && lane < W; k += W) part += expf(si[k] - m);
      const float l = warp_tree_sum(part, W);
      float acc = 0.f;
      for (int k = 0; k < N; ++k)
        acc = fmaf(rb(expf(si[k] - m) / l), sv[k * HS + lane], acc);
      c.f.so[(long)(o * N + i) * IS + h * HS + lane] = to_bf16(acc);
    }
    __syncthreads();
  }
}

// out = bf16 walk of a[rows, K] W^T + b (+ res) over the token rows, N
// columns of W [N, K]
__device__ void tok_linear(const Ctx& c, int j, const bf16* a, int K,
                           int wi, int bi, int N, bool relu, const bf16* res,
                           bf16* out, uint32_t ring) {
  int m0, n0;
  tile_at(j, N, m0, n0);
  float acc[32];
  prod_tile(acc, prod(a, K, 0, wb(c, wi), K, 0, c.g.T, N), m0, n0, 0, K, ring);
  epi_linear(acc, m0, n0, c.g.T, wf(c, bi), relu, res, N, out, N);
}

// LayerNorm of the token rows of a bf16 [T, C_] matrix: y, and ype = y +
// qpe where given
__device__ void f_ln(const Ctx& c, const bf16* in, int lw, int lb, bf16* y,
                     bf16* ype) {
  const int lane = threadIdx.x & 31;
  for (int r = blockIdx.x * (TB / 32) + (threadIdx.x >> 5); r < c.g.T;
       r += gridDim.x * (TB / 32)) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = ldf(in + (long)r * C_ + lane + 32 * i);
    ln_out(v, wf(c, lw), wf(c, lb), y + (long)r * C_, c.qpe + (long)r * C_,
           ype ? ype + (long)r * C_ : nullptr, lane);
  }
}

// rows k0 .. k0 + n - 1 of the object's t2i keys (and values) of head h,
// 16 bf16 each, into kc (vc) by cp.async
__device__ __forceinline__ void t2i_stage(const Ctx& c, long kbase, int h,
                                          int k0, int n, bf16* kc, bf16* vc) {
  for (int e = threadIdx.x; e < 2 * n; e += TB) {
    const long key = kbase + k0 + (e >> 1);
    const int half = (e & 1) * 8;
    cp_async16(smem_u32(kc + e * 8), c.f.kq + key * 2 * IX + h * HX + half,
               true);
    if (vc)
      cp_async16(smem_u32(vc + e * 8), c.f.tv + key * IX + h * HX + half,
                 true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

__device__ __forceinline__ float t2i_score(const bf16* kc, int t,
                                           const float* q) {
  float kk[16];
  unpack8(*reinterpret_cast<const uint4*>(kc + t * HX), kk);
  unpack8(*reinterpret_cast<const uint4*>(kc + t * HX + 8), kk + 8);
  return dot16(kk, q) * 0.25f;
}

// x + y = s + e exactly (Knuth's TwoSum)
__device__ __forceinline__ void two_sum(float x, float y, float& s, float& e) {
  s = x + y;
  const float b = s - x;
  e = (x - (s - b)) + (y - b);
}

// token -> image attention in three stages, so that each output rounds as
// the plain block's (sdpa: torch's softmax, then the f32 PV product), with
// the keys split across the block's threads and across jobs:
//   f_t2i_stats, a job per (object, head): the scores of a chunk of keys
//   (the whole row up to 1024), the row max and the softmax denominator in
//   torch's order (partials by lane, or above 1024 keys by 1024 threads,
//   each adding its keys in order, then trees); lse;
//   f_t2i_pv, a job per (object, head, key split): p = bf16(exp(s - M) /
//   L), and per (query, dimension) the split's p V as a compensated sum
//   (TwoSum: p v is exact in f32, and the sum's error stays far below an
//   f32 rounding);
//   f_t2i_merge: the splits' sums added the same way in split order, one
//   rounding: o is the correctly rounded f32 of p V (but at ties), as near
//   to sdpa's f32 product as a sum can be, whatever order cuBLAS takes.
__device__ void f_t2i_stats(const Ctx& c, unsigned char* gen) {
  const Geo& g = c.g;
  const int N = g.N, HW = g.HW, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const T2iSmem L_(HW);
  const int V = L_.V, CH = L_.CH, QG = L_.QG, one = HW <= T2I_KC;
  bf16* kc = reinterpret_cast<bf16*>(gen + L_.kc);
  float* S = reinterpret_cast<float*>(gen + L_.s);       // [QG][CH]
  float* part = reinterpret_cast<float*>(gen + L_.part); // [QG][V]
  float* qs = reinterpret_cast<float*>(gen + L_.qs);     // [QG][16]
  const int groups = cdv(N, QG);
  for (int jq = blockIdx.x; jq < g.O * HEADS * groups; jq += gridDim.x) {
    const int j = jq / groups, i0 = (jq % groups) * QG;
    const int o = j / HEADS, h = j % HEADS;
    const long kbase = (long)o * HW;
    {
      const int nq = N - i0 < QG ? N - i0 : QG;
      float* st = c.f.tstat + ((long)j * N + i0) * 2;    // M, L per query
      for (int e = tid; e < nq * HX; e += TB)
        qs[e] = ldf(c.f.tq + (long)(o * N + i0 + e / HX) * IX + h * HX + e % HX);
      auto scores = [&](int k0, int nk) {
        t2i_stage(c, kbase, h, k0, nk, kc, nullptr);
        for (int e = tid; e < nq * nk; e += TB) {
          const int i = e / nk, t = e % nk;
          S[i * CH + t] = t2i_score(kc, t, qs + i * HX);
        }
        __syncthreads();
      };
      float mx = -INFINITY;                // warp w's query w (and w + 4)
      float mx2 = -INFINITY;
      for (int k0 = 0; k0 < HW; k0 += CH) {
        const int nk = HW - k0 < CH ? HW - k0 : CH;
        scores(k0, nk);
        for (int i = warp; i < nq; i += TB / 32) {
          float m = -INFINITY;
          for (int t = lane; t < nk; t += 32) m = fmaxf(m, S[i * CH + t]);
          m = wmax(m);
          if (i == warp) mx = fmaxf(mx, m);
          else mx2 = fmaxf(mx2, m);
        }
        __syncthreads();
      }
      for (int i = warp; i < nq; i += TB / 32)
        if (lane == 0) st[2 * i] = i == warp ? mx : mx2;
      __threadfence();
      __syncthreads();
      for (int k0 = 0; k0 < HW; k0 += CH) {
        const int nk = HW - k0 < CH ? HW - k0 : CH;
        if (!one) scores(k0, nk);
        for (int e = tid; e < nq * V; e += TB) {
          const int i = e / V, t = e % V;
          const float M = __ldcg(st + 2 * i);
          float s = k0 == 0 ? 0.f : part[e];
          for (int u = t - k0 % V; u < nk; u += V)
            if (u >= 0) s += expf(S[i * CH + u] - M);
          part[e] = s;
        }
        __syncthreads();
      }
      if (V > 32) {                        // the warps' trees, then theirs
        float sums = 0.f;
        if (tid < nq * 32) sums = tree_sum(part + tid * 32, 32);
        __syncthreads();
        if (tid < nq * 32) part[(tid / 32) * V + tid % 32] = sums;
        __syncthreads();
      }
      if (tid < nq) {
        float* p = part + tid * V;
        const float L = tree_sum(p, V > 32 ? V / 32 : V);
        st[2 * tid + 1] = L;
        c.f.lse[(long)j * N + i0 + tid] = __ldcg(st + 2 * tid) + logf(L);
      }
      __syncthreads();
    }
  }
}

__device__ void f_t2i_pv(const Ctx& c, unsigned char* gen) {
  const Geo& g = c.g;
  const int N = g.N, tid = threadIdx.x;
  float* S = reinterpret_cast<float*>(gen + SCR);        // [N][chunk] p
  float* qs = S + SCORE_FLOATS;                          // [N][16]
  float* ml = qs + N * HX;                               // [N] M, L
  bf16* kc = reinterpret_cast<bf16*>(gen);               // [chunk][16]
  bf16* vc = kc + MAX_CHUNK * HX;
  for (int j = blockIdx.x; j < g.O * HEADS * g.ns; j += gridDim.x) {
    const int sp = j % g.ns, oh = j / g.ns, h = oh % HEADS, o = oh / HEADS;
    const int k0 = sp * g.chunk;
    const int nk = k0 + g.chunk < g.HW ? g.chunk : g.HW - k0;
    for (int e = tid; e < N * HX; e += TB)
      qs[e] = ldf(c.f.tq + (long)(o * N + e / HX) * IX + h * HX + e % HX);
    for (int e = tid; e < 2 * N; e += TB)
      ml[e] = __ldcg(c.f.tstat + (long)oh * N * 2 + e);
    t2i_stage(c, (long)o * g.HW, h, k0, nk, kc, vc);
    for (int e = tid; e < N * nk; e += TB) {
      const int i = e / nk, t = e % nk;
      S[e] = rb(expf(t2i_score(kc, t, qs + i * HX) - ml[2 * i]) / ml[2 * i + 1]);
    }
    __syncthreads();
    for (int e = tid; e < N * HX; e += TB) {
      const int i = e / HX, d = e % HX;
      const float* p = S + i * nk;
      float s = 0.f, err = 0.f;
      for (int t = 0; t < nk; ++t) {
        float ts, te;
        two_sum(s, p[t] * to_f32(vc[t * HX + d]), ts, te);
        s = ts;
        err += te;
      }
      float* out = c.f.tacc + ((long)j * N * HX + e) * 2;
      out[0] = s;
      out[1] = err;
    }
    __syncthreads();
  }
}

// o = the splits' compensated sums added in split order, rounded once; to
// (bf16) and to32 (f32: the backward's D = rowsum(do o))
__device__ void f_t2i_merge(const Ctx& c) {
  const Geo& g = c.g;
  const long n = (long)g.O * HEADS * g.N * HX;
  for (long e = blockIdx.x * (long)TB + threadIdx.x; e < n;
       e += (long)gridDim.x * TB) {
    const int d = (int)(e % HX);
    const long row = e / HX;                 // (o h) N + i
    const int i = (int)(row % g.N);
    const long oh = row / g.N;
    const int h = (int)(oh % HEADS), o = (int)(oh / HEADS);
    float s = 0.f, err = 0.f;
    for (int sp = 0; sp < g.ns; ++sp) {
      const float* p = c.f.tacc + (((oh * g.ns + sp) * g.N + i) * HX + d) * 2;
      float ts, te;
      two_sum(s, __ldcg(p), ts, te);
      s = ts;
      err += te + __ldcg(p + 1);
    }
    const float o_ = s + err;
    const long at = (long)(o * g.N + i) * IX + h * HX + d;
    c.f.to[at] = to_bf16(o_);
    c.f.to32[at] = o_;
  }
}

// W2's K chunks: p3[ks] = r[:, chunk] W2[:, chunk]^T (f32)
__device__ void f_mlp2(const Ctx& c, uint32_t ring) {
  const Geo& g = c.g;
  const int tiles = g.rt * (C_ / BT), kc = HID / g.ks3;
  for (int j = blockIdx.x; j < tiles * g.ks3; j += gridDim.x) {
    const int ks = j / tiles;
    int m0, n0;
    tile_at(j % tiles, C_, m0, n0);
    float acc[32];
    prod_tile(acc, prod(c.f.r, HID, 0, wb(c, W_M2), HID, 0, g.T, C_), m0, n0,
              ks * kc, (ks + 1) * kc, ring);
    epi_f32(acc, m0, n0, g.T, c.f.p3 + (long)ks * g.T * C_, C_);
  }
}

// pre3 = bf16(bf16 walk of the chunks' sum + b2, + x2); x3 = LN3(pre3)
// (the block's token output) and x3pe = x3 + qpe
__device__ void f_ln3(const Ctx& c) {
  const Geo& g = c.g;
  const int lane = threadIdx.x & 31;
  const float* b2 = wf(c, B_M2);
  for (int r = blockIdx.x * (TB / 32) + (threadIdx.x >> 5); r < g.T;
       r += gridDim.x * (TB / 32)) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0.f;
    const float* p3 = c.f.p3 + (long)r * C_ + lane;
#pragma unroll 4
    for (int ks = 0; ks < g.ks3; ++ks) {
      float t[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) t[i] = __ldcg(p3 + (long)ks * g.T * C_ + 32 * i);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] += t[i];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int cc = lane + 32 * i;
      v[i] = rb(rb(rb(v[i]) + rb(__ldg(b2 + cc))) +
                ldf(c.f.x2 + (long)r * C_ + cc));
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) c.f.pre3[(long)r * C_ + lane + 32 * i] = to_bf16(v[i]);
    ln_out(v, wf(c, LN3W), wf(c, LN3B), c.xout + (long)r * C_,
           c.qpe + (long)r * C_, c.f.x3pe + (long)r * C_, lane);
  }
}

// image -> token attention, a job per I2T_ROWS image rows of one object:
// the object's N keys and values in shared memory, a thread per (row,
// head): the scores (kept up to 32 keys, in the ring area), the row max,
// the softmax sum in torch's order, p rounded to bf16, io = p V a chain
// over the keys; io (bf16) to device memory
__device__ void f_i2t(const Ctx& c, unsigned char* gen) {
  const Geo& g = c.g;
  const int N = g.N;
  bf16* kv = reinterpret_cast<bf16*>(gen + SCR);          // [N][256]
  float* sc = reinterpret_cast<float*>(gen);              // [32][TB]
  const int jobs = cdv(g.HW, I2T_ROWS);
  const int row = threadIdx.x % I2T_ROWS, h = threadIdx.x / I2T_ROWS;
  for (int j = blockIdx.x; j < g.O * jobs; j += gridDim.x) {
    const int o = j / jobs, t = j % jobs;
    const long r = (long)o * g.HW + t * I2T_ROWS + row;
    const bool live = t * I2T_ROWS + row < g.HW;
    for (int e = threadIdx.x; e < N * (2 * IX / 8); e += TB)
      *reinterpret_cast<uint4*>(kv + e * 8) = __ldcg(
          reinterpret_cast<const uint4*>(c.f.ikv + (long)o * N * 2 * IX + e * 8));
    float q[16];
    if (live) ld16(c.f.kq + r * 2 * IX + IX + h * HX, q);
    __syncthreads();
    if (live) {
      auto row16 = [&](int k, int off, float (&v)[16]) {
        unpack8(*reinterpret_cast<const uint4*>(kv + k * 2 * IX + off + h * HX), v);
        unpack8(*reinterpret_cast<const uint4*>(kv + k * 2 * IX + off + h * HX + 8),
                v + 8);
      };
      auto score = [&](int k) {
        float kk[16];
        row16(k, 0, kk);
        return dot16(q, kk) * 0.25f;
      };
      auto S = [&](int k) {
        return N <= 32 ? sc[k * TB + threadIdx.x] : score(k);
      };
      float m = -INFINITY;
      for (int k = 0; k < N; ++k) {
        const float s = score(k);
        if (N <= 32) sc[k * TB + threadIdx.x] = s;
        m = fmaxf(m, s);
      }
      const int W = sm_width(N);
      float part[32];
      for (int l = 0; l < W; ++l) part[l] = 0.f;
      for (int k = 0; k < N; ++k) part[k % W] += expf(S(k) - m);
      const float l = tree_sum(part, W);
      float out[16];
#pragma unroll
      for (int d = 0; d < 16; ++d) out[d] = 0.f;
      for (int k = 0; k < N; ++k) {
        const float pk = rb(expf(S(k) - m) / l);
        float vv[16];
        row16(k, IX, vv);
#pragma unroll
        for (int d = 0; d < 16; ++d) out[d] = fmaf(pk, vv[d], out[d]);
      }
      st16(c.f.io + r * IX + h * HX, out);
    }
    __syncthreads();
  }
}

// out-projection, residual and LN4 per JR image rows of one object: the
// rows' io (the A operand, swizzled) and K0 staged at the start, pre4 = io
// Wio^T + b + K0 per 64 output columns (Wio streamed through two ring
// slots) into a tile of rows and to device memory (LN4's backward reads
// it), LN4 a warp per row from the tile
__device__ void f_tail(const Ctx& c, unsigned char* gen, uint32_t sm) {
  const Geo& g = c.g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t io_s = sm + SCR;
  bf16* pre = reinterpret_cast<bf16*>(gen + SCR + IO_B);
  auto load_w = [&](int nt) {
    stage_block<64, IX, TB>(sm + (nt & 1) * STAGE_B, wb(c, W_IO), IX, nt * BT,
                            C_, 0, IX);
  };
  for (int j = blockIdx.x; j < g.O * g.jobs_hw; j += gridDim.x) {
    const int o = j / g.jobs_hw, t = j % g.jobs_hw;
    const long r0 = (long)o * g.HW + t * JR;
    const int nr = g.HW - t * JR < JR ? g.HW - t * JR : JR;
    for (int e = threadIdx.x; e < BT * (C_ / 8); e += TB) {
      const int r = e / (C_ / 8), cc = (e % (C_ / 8)) * 8;
      cp_async16(smem_u32(pre + r * PRE_LD + cc),
                 c.k0 + (r < nr ? (r0 + r) * C_ + cc : 0), r < nr);
    }
    stage_block<64, IX, TB>(io_s, c.f.io + r0 * IX, IX, 0, nr, 0, IX);
    load_w(0);
    cp_async_commit();
    load_w(1);
    cp_async_commit();
    for (int nt = 0; nt < C_ / BT; ++nt) {
      cp_async_wait<1>();
      fence_proxy_async();
      __syncthreads();                 // piece nt (and io, K0) landed
      float acc[32];
      zero(acc);
      const uint32_t ws = sm + (nt & 1) * STAGE_B;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < IX / 16; ++kk)
        wgmma_ss_n64(acc, desc_k(io_s, 16 * kk), desc_k(ws, 16 * kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncthreads();                 // slot nt & 1 consumed
      if (nt + 2 < C_ / BT) load_w(nt + 2);
      cp_async_commit();
      const int rr = acc_r0(0), c0 = acc_c0(nt * BT);
      float bv[16];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        bv[2 * n] = rb(__ldg(wf(c, B_IO) + c0 + 8 * n));
        bv[2 * n + 1] = rb(__ldg(wf(c, B_IO) + c0 + 8 * n + 1));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rr + 8 * h;
        if (r >= nr) continue;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          bf16* at = pre + r * PRE_LD + c0 + 8 * n;
          const float2 kk = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
          const float v0 = rb(rb(acc[4 * n + 2 * h]) + bv[2 * n]) + kk.x;
          const float v1 = rb(rb(acc[4 * n + 2 * h + 1]) + bv[2 * n + 1]) + kk.y;
          st2(at, v0, v1);
          st2(c.f.pre4 + (r0 + r) * C_ + c0 + 8 * n, v0, v1);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    for (int r = warp; r < nr; r += TB / 32) {
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = to_f32(pre[r * PRE_LD + lane + 32 * i]);
      ln_out(v, wf(c, LN4W), wf(c, LN4B), c.kout + (r0 + r) * C_, nullptr,
             nullptr, lane);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(TB, 2)
twoway_fwd_kernel(const __grid_constant__ Ctx c) {
  extern __shared__ unsigned char tw_smem[];
  unsigned char* gen;
  const uint32_t sm = aligned_smem(tw_smem, &gen);
  const Geo& g = c.g;
  unsigned target = 0;
  unsigned* bar = c.f.bar;

  f_prep(c);
  grid_sync(bar, target);
  f_proj(c, sm);
  grid_sync(bar, target);
  f_self(c, gen);
  grid_sync(bar, target);
  // A's out-projection (+ x but in the first block), LN1
  for (int j = blockIdx.x; j < g.rt * 4; j += gridDim.x)
    tok_linear(c, j, c.f.so, IS, W_SO, B_SO, C_, false,
               c.first ? nullptr : c.x, c.f.pre1, sm);
  grid_sync(bar, target);
  f_ln(c, c.f.pre1, LN1W, LN1B, c.f.x1, c.f.x1pe);
  grid_sync(bar, target);
  // B: q, the attention, its out-projection + x1, LN2
  for (int j = blockIdx.x; j < g.rt * 2; j += gridDim.x)
    tok_linear(c, j, c.f.x1pe, C_, W_TQ, B_TQ, IX, false, nullptr, c.f.tq, sm);
  grid_sync(bar, target);
  f_t2i_stats(c, gen);
  grid_sync(bar, target);
  f_t2i_pv(c, gen);
  grid_sync(bar, target);
  f_t2i_merge(c);
  grid_sync(bar, target);
  for (int j = blockIdx.x; j < g.rt * 4; j += gridDim.x)
    tok_linear(c, j, c.f.to, IX, W_TO, B_TO, C_, false, c.f.x1, c.f.pre2, sm);
  grid_sync(bar, target);
  f_ln(c, c.f.pre2, LN2W, LN2B, c.f.x2, nullptr);
  grid_sync(bar, target);
  // C: the MLP (W2 in K chunks), LN3
  for (int j = blockIdx.x; j < g.rt * (HID / BT); j += gridDim.x)
    tok_linear(c, j, c.f.x2, C_, W_M1, B_M1, HID, true, nullptr, c.f.r, sm);
  grid_sync(bar, target);
  f_mlp2(c, sm);
  grid_sync(bar, target);
  f_ln3(c);
  grid_sync(bar, target);
  // D: k = x3 + qpe and v = x3 projected, then the image rows' tail
  for (int j = blockIdx.x; j < g.rt * 4; j += gridDim.x) {
    int m0, n0;
    tile_at(j, 2 * IX, m0, n0);
    const bool isk = n0 < IX;
    float acc[32];
    prod_tile(acc, prod(isk ? c.f.x3pe : c.xout, C_, 0,
                        wb(c, isk ? W_IK : W_IV), C_, 0, g.T, IX),
              m0, isk ? n0 : n0 - IX, 0, C_, sm);
    epi_linear(acc, m0, n0, g.T, wf(c, isk ? B_IK : B_IV) - (isk ? 0 : IX),
               false, nullptr, 0, c.f.ikv, 2 * IX);
  }
  grid_sync(bar, target);
  f_i2t(c, gen);
  grid_sync(bar, target);
  f_tail(c, gen, sm);
}

// ===========================================================================
// Backward stages
// ===========================================================================

// LN4's backward, i2t's out-projection backward and attention backward per
// JR image rows of one object (the forward's f_i2t and f_tail mirrored):
//   dpre4 = LN4'(pre4; dk1) from the two row tiles staged in shared memory
//   (f32 and bf16 to device memory; the job's column sums for LN4's weight
//   and bias);
//   do4 = dpre4 Wio (bf16, the tile in shared memory);
//   per (row, head): p, dp = bf16(do v^T), D = sum p dp, ds = p (dp - D)
//   scale, dq = ds K into dkq's i2t half; then dK = ds^T q and dV =
//   bf16(p)^T do over the tile's rows, a thread per (key, head, row group),
//   the groups added in order: the job's partial for the object's keys
__device__ void b_i2t(const Ctx& c, unsigned char* gen, uint32_t sm) {
  const Geo& g = c.g;
  const int N = g.N, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* dyt = reinterpret_cast<bf16*>(gen);                // [64][256] (ring)
  bf16* qs = reinterpret_cast<bf16*>(gen + SCR);           // [64][128]
  bf16* dos = qs + BT * IX;                                // [64][128]
  bf16* xt = qs;                                           // [64][256] first
  bf16* kv = dos + BT * IX;                                // [N][256]
  float* st = reinterpret_cast<float*>(kv + N * 2 * IX);   // [8 * 64][3]
  float* red = st + BT * HEADS * 3;
  for (int j = blockIdx.x; j < g.O * g.jobs_hw; j += gridDim.x) {
    const int o = j / g.jobs_hw, t = j % g.jobs_hw;
    const long r0 = (long)o * g.HW + t * JR;
    const int nr = g.HW - t * JR < JR ? g.HW - t * JR : JR;
    for (int e = threadIdx.x; e < BT * (C_ / 8); e += TB) {
      const int r = e / (C_ / 8), cc = (e % (C_ / 8)) * 8;
      const long at = r < nr ? (r0 + r) * C_ + cc : 0;
      cp_async16(smem_u32(dyt + r * C_ + cc), c.dko + at, r < nr);
      cp_async16(smem_u32(xt + r * C_ + cc), c.f.pre4 + at, r < nr);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // LN4 backward, a warp per row
    float pw[8], pb[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) pw[i] = pb[i] = 0.f;
    for (int r = warp; r < nr; r += TB / 32) {
      const long row = r0 + r;
      float xv[8], dy[8], dx[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        xv[i] = to_f32(xt[r * C_ + lane + 32 * i]);
        dy[i] = to_f32(dyt[r * C_ + lane + 32 * i]);
      }
      ln_bwd_row(xv, wf(c, LN4W), dy, dx, pw, pb, lane);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int cc = lane + 32 * i;
        c.b.dpre4[row * C_ + cc] = dx[i];
        c.b.dpre4b[row * C_ + cc] = to_bf16(dx[i]);
      }
    }
    __syncthreads();                   // the two row tiles are free
    if (c.wgrad) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        red[warp * 2 * C_ + lane + 32 * i] = pw[i];
        red[warp * 2 * C_ + C_ + lane + 32 * i] = pb[i];
      }
    }
    for (int e = threadIdx.x; e < N * (2 * IX / 8); e += TB)
      *reinterpret_cast<uint4*>(kv + e * 8) = __ldcg(
          reinterpret_cast<const uint4*>(c.f.ikv + (long)o * N * 2 * IX + e * 8));
    for (int e = threadIdx.x; e < nr * (IX / 8); e += TB) {
      const int r = e / (IX / 8), cc = (e % (IX / 8)) * 8;
      *reinterpret_cast<uint4*>(qs + r * IX + cc) = __ldcg(
          reinterpret_cast<const uint4*>(c.f.kq + (r0 + r) * 2 * IX + IX + cc));
    }
    __threadfence();
    __syncthreads();
    if (c.wgrad) warps_to(red, 2 * C_, c.b.ln4p + (long)j * 2 * C_);
    // do4 = dpre4 Wio, two 64-column tiles (Wio [256, 128] read MN-major)
    for (int nt = 0; nt < 2; ++nt) {
      float acc[32];
      prod_tile(acc, prod(c.b.dpre4b + r0 * C_, C_, 0, wb(c, W_IO), IX, 1, nr,
                          IX),
                0, nt * BT, 0, C_, sm);
      each_pair(acc, 0, nt * BT, [&](int r, int cc, float a, float b) {
        st2(dos + r * IX + cc, a, b);
      });
    }
    __syncthreads();
    // per (row, head): statistics, D, dq
    for (int p = threadIdx.x; p < BT * HEADS; p += TB) {
      const int row = p & (BT - 1), h = p / BT;
      if (row >= nr) continue;
      float q[16], dd[16];
#pragma unroll
      for (int d = 0; d < 16; ++d) {
        q[d] = to_f32(qs[row * IX + h * HX + d]);
        dd[d] = to_f32(dos[row * IX + h * HX + d]);
      }
      auto key = [&](int k, int off, float (&v)[16]) {
        unpack8(*reinterpret_cast<const uint4*>(kv + k * 2 * IX + off + h * HX), v);
        unpack8(*reinterpret_cast<const uint4*>(kv + k * 2 * IX + off + h * HX + 8),
                v + 8);
      };
      float m = -INFINITY;
      for (int k = 0; k < N; ++k) {
        float kk[16];
        key(k, 0, kk);
        m = fmaxf(m, dot16(q, kk) * 0.25f);
      }
      float l = 0.f;
      for (int k = 0; k < N; ++k) {
        float kk[16];
        key(k, 0, kk);
        l += expf(dot16(q, kk) * 0.25f - m);
      }
      const float inv = 1.f / l;
      float D = 0.f;
      for (int k = 0; k < N; ++k) {
        float kk[16], vv[16];
        key(k, 0, kk);
        key(k, IX, vv);
        D += expf(dot16(q, kk) * 0.25f - m) * inv * rb(dot16(dd, vv));
      }
      float dq[16];
#pragma unroll
      for (int d = 0; d < 16; ++d) dq[d] = 0.f;
      for (int k = 0; k < N; ++k) {
        float kk[16], vv[16];
        key(k, 0, kk);
        key(k, IX, vv);
        const float pk = expf(dot16(q, kk) * 0.25f - m) * inv;
        const float ds = pk * (rb(dot16(dd, vv)) - D) * 0.25f;
#pragma unroll
        for (int d = 0; d < 16; ++d) dq[d] += ds * kk[d];
      }
      st16(c.b.dkq + (r0 + row) * 2 * IX + IX + h * HX, dq);
      st[p * 3] = m;
      st[p * 3 + 1] = inv;
      st[p * 3 + 2] = D;
    }
    __syncthreads();
    // dK, dV: a thread per (key, head, row group)
    const int G0 = g.g0, rows = cdv(JR, G0);
    for (int it = threadIdx.x; it < N * HEADS * G0; it += TB) {
      const int gi = it % G0, kh = it / G0, h = kh % HEADS, k = kh / HEADS;
      float kk[16], vv[16], dk[16], dv[16];
      unpack8(*reinterpret_cast<const uint4*>(kv + k * 2 * IX + h * HX), kk);
      unpack8(*reinterpret_cast<const uint4*>(kv + k * 2 * IX + h * HX + 8), kk + 8);
      unpack8(*reinterpret_cast<const uint4*>(kv + k * 2 * IX + IX + h * HX), vv);
      unpack8(*reinterpret_cast<const uint4*>(kv + k * 2 * IX + IX + h * HX + 8),
              vv + 8);
#pragma unroll
      for (int d = 0; d < 16; ++d) dk[d] = dv[d] = 0.f;
      const int re = (gi + 1) * rows < nr ? (gi + 1) * rows : nr;
      for (int row = gi * rows; row < re; ++row) {
        float q[16], dd[16];
#pragma unroll
        for (int d = 0; d < 16; ++d) {
          q[d] = to_f32(qs[row * IX + h * HX + d]);
          dd[d] = to_f32(dos[row * IX + h * HX + d]);
        }
        const float* s3 = st + (h * BT + row) * 3;
        const float pk = expf(dot16(q, kk) * 0.25f - s3[0]) * s3[1];
        const float ds = pk * (rb(dot16(dd, vv)) - s3[2]) * 0.25f;
        const float pbk = rb(pk);
#pragma unroll
        for (int d = 0; d < 16; ++d) {
          dk[d] += ds * q[d];
          dv[d] += pbk * dd[d];
        }
      }
      float* rr = red + ((long)gi * N + k) * 2 * IX + h * HX;
#pragma unroll
      for (int d = 0; d < 16; ++d) {
        rr[d] = dk[d];
        rr[IX + d] = dv[d];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < N * 2 * IX; e += TB) {
      float s = 0.f;
      for (int gi = 0; gi < G0; ++gi) s += red[(long)gi * N * 2 * IX + e];
      c.b.ikvp[(long)j * N * 2 * IX + e] = s;
    }
    __syncthreads();
  }
}

// LayerNorm backward over the token rows, a job per LN_ROWS rows (4 a
// warp): dy = d0 (bf16) + the sum of np partials (pstride apart, in order)
// + d1 + d2 (each term optional); dx to out32 and out16; the job's column
// sums of dy xhat and dy into part[job][2 C_]
__device__ void b_ln(const Ctx& c, unsigned char* gen, const bf16* x,
                     const float* w, const bf16* d0, const float* d1,
                     const float* d2, const float* dp, int np, long pstride,
                     float* out32, bf16* out16, float* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* red = reinterpret_cast<float*>(gen + SCR);
  for (int j = blockIdx.x; j < cdv(c.g.T, LN_ROWS); j += gridDim.x) {
    float pw[8], pb[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) pw[i] = pb[i] = 0.f;
    for (int rr = 0; rr < LN_ROWS / 4; ++rr) {
      const long r = (long)j * LN_ROWS + warp * (LN_ROWS / 4) + rr;
      if (r >= c.g.T) break;
      const long e0 = r * C_ + lane;
      float xv[8], dy[8], dx[8], t[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        xv[i] = ldf(x + e0 + 32 * i);
        dy[i] = d0 ? to_f32(d0[e0 + 32 * i]) : 0.f;
      }
#pragma unroll 4
      for (int k = 0; k < np; ++k) {
#pragma unroll
        for (int i = 0; i < 8; ++i) t[i] = __ldcg(dp + k * pstride + e0 + 32 * i);
#pragma unroll
        for (int i = 0; i < 8; ++i) dy[i] += t[i];
      }
      const float* extra[2] = {d1, d2};
      for (const float* d : extra) {
        if (!d) continue;
#pragma unroll
        for (int i = 0; i < 8; ++i) t[i] = __ldcg(d + e0 + 32 * i);
#pragma unroll
        for (int i = 0; i < 8; ++i) dy[i] += t[i];
      }
      ln_bwd_row(xv, w, dy, dx, pw, pb, lane);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        out32[e0 + 32 * i] = dx[i];
        out16[e0 + 32 * i] = to_bf16(dx[i]);
      }
    }
    if (c.wgrad) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        red[warp * 2 * C_ + lane + 32 * i] = pw[i];
        red[warp * 2 * C_ + C_ + lane + 32 * i] = pb[i];
      }
      __syncthreads();
      warps_to(red, 2 * C_, part + (long)j * 2 * C_);
      __syncthreads();
    }
  }
}

// token -> image attention backward, a job per (object, head, key split),
// from the forward's lse and D = rowsum(do o) (o the f32 output): a thread
// per key (p = exp(s - lse), dp = bf16(do v^T), ds = p (dp - D) scale, dk
// = ds^T q, dv = bf16(p)^T do, both summed over the N queries in order),
// then a warp per query: the split's dq = ds K partial
__device__ void b_t2i(const Ctx& c, unsigned char* gen) {
  const Geo& g = c.g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, N = g.N;
  float* sc = reinterpret_cast<float*>(gen + SCR);
  float* qd = sc + SCORE_FLOATS;            // [N][16] q, then [N][16] do
  float* ld = qd + 2 * N * HX;              // [N] lse, [N] D
  float* tmp = ld + 2 * N;                  // [N][16] do o
  bf16* kt = kv_after(tmp, N * HX);                   // [chunk][16] k, v
  bf16* vt = kt + MAX_CHUNK * HX;
  for (int j = blockIdx.x; j < g.O * HEADS * g.ns; j += gridDim.x) {
    const int sp = j % g.ns, oh = j / g.ns, h = oh % HEADS, o = oh / HEADS;
    const int k0 = sp * g.chunk;
    const int nk = k0 + g.chunk < g.HW ? g.chunk : g.HW - k0;
    for (int e = threadIdx.x; e < 2 * nk; e += TB) {
      const long key = (long)o * g.HW + k0 + (e >> 1);
      const int half = (e & 1) * 8;
      cp_async16(smem_u32(kt + e * 8), c.f.kq + key * 2 * IX + h * HX + half, true);
      cp_async16(smem_u32(vt + e * 8), c.f.tv + key * IX + h * HX + half, true);
    }
    cp_async_commit();
    for (int e = threadIdx.x; e < N * HX; e += TB) {
      const long at = (long)(o * N + e / HX) * IX + h * HX + e % HX;
      const float dd = ldf(c.b.do2 + at);
      qd[e] = ldf(c.f.tq + at);
      qd[N * HX + e] = dd;
      tmp[e] = dd * __ldcg(c.f.to32 + at);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < N; i += TB) {
      float D = 0.f;
      for (int d = 0; d < HX; ++d) D += tmp[i * HX + d];
      ld[i] = __ldcg(c.f.lse + (long)oh * N + i);
      ld[N + i] = D;
    }
    cp_async_wait<0>();
    __syncthreads();
    for (int t = threadIdx.x; t < nk; t += TB) {
      const long key = (long)o * g.HW + k0 + t;
      float kk[16], vv[16], dk[16], dv[16];
      unpack8(*reinterpret_cast<const uint4*>(kt + t * HX), kk);
      unpack8(*reinterpret_cast<const uint4*>(kt + t * HX + 8), kk + 8);
      unpack8(*reinterpret_cast<const uint4*>(vt + t * HX), vv);
      unpack8(*reinterpret_cast<const uint4*>(vt + t * HX + 8), vv + 8);
#pragma unroll
      for (int d = 0; d < 16; ++d) dk[d] = dv[d] = 0.f;
      for (int i = 0; i < N; ++i) {
        const float* q = qd + i * HX;
        const float* dd = qd + (N + i) * HX;
        const float p = expf(dot16(kk, q) * 0.25f - ld[i]);
        const float ds = p * (rb(dot16(vv, dd)) - ld[N + i]) * 0.25f;
        const float pbk = rb(p);
        sc[i * nk + t] = ds;
#pragma unroll
        for (int d = 0; d < 16; ++d) {
          dk[d] += ds * q[d];
          dv[d] += pbk * dd[d];
        }
      }
      st16(c.b.dkq + key * 2 * IX + h * HX, dk);
      st16(c.b.dvt + key * IX + h * HX, dv);
    }
    __syncthreads();
    for (int i = warp; i < N; i += TB / 32) {
      float acc[16];
#pragma unroll
      for (int d = 0; d < 16; ++d) acc[d] = 0.f;
      for (int t = lane; t < nk; t += 32) {
        float kk[16];
        unpack8(*reinterpret_cast<const uint4*>(kt + t * HX), kk);
        unpack8(*reinterpret_cast<const uint4*>(kt + t * HX + 8), kk + 8);
        const float ds = sc[i * nk + t];
#pragma unroll
        for (int d = 0; d < 16; ++d) acc[d] += ds * kk[d];
      }
      float* out = c.b.dqp + ((long)j * N + i) * HX;
#pragma unroll
      for (int d = 0; d < 16; ++d) {
        const float s = warp_sum(acc[d]);
        if (lane == d) out[d] = s;
      }
    }
    __syncthreads();
  }
}

// self-attention backward, a job per (object, head): the head's q, k, v
// and do rows in shared memory; a warp per query (lane = dimension): p, dp
// = bf16(do v^T), D, ds = p (dp - D) scale, dq = ds K; ds and bf16(p) to
// shared memory; then a warp per key: dk = ds^T q, dv = p^T do (queries
// in order)
__device__ void b_self(const Ctx& c, unsigned char* gen) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, N = c.g.N;
  const float scale = SCALE_S;
  float* sq = reinterpret_cast<float*>(gen + SCR);
  float* sk = sq + N * HS;
  float* sv = sk + N * HS;
  float* sd = sv + N * HS;
  float* dsm = sd + N * HS;
  float* pbm = dsm + N * N;
  for (int j = blockIdx.x; j < c.g.O * HEADS; j += gridDim.x) {
    const int o = j / HEADS, h = j % HEADS;
    for (int e = threadIdx.x; e < N * HS; e += TB) {
      const long row = (long)o * N + e / HS;
      const bf16* src = c.f.sqkv + row * 3 * IS + h * HS + e % HS;
      sq[e] = ldf(src);
      sk[e] = ldf(src + IS);
      sv[e] = ldf(src + 2 * IS);
      sd[e] = ldf(c.b.dos + row * IS + h * HS + e % HS);
    }
    __syncthreads();
    bf16* dbase = c.b.dsqkv + (long)o * N * 3 * IS + h * HS + lane;
    for (int i = warp; i < N; i += TB / 32) {
      const float q = sq[i * HS + lane], dd = sd[i * HS + lane];
      auto score = [&](int k) {
        return warp_sum(q * sk[k * HS + lane]) * scale;
      };
      float m = -INFINITY;
      for (int k = 0; k < N; ++k) m = fmaxf(m, score(k));
      float l = 0.f;
      for (int k = 0; k < N; ++k) l += expf(score(k) - m);
      float D = 0.f;
      for (int k = 0; k < N; ++k)
        D += expf(score(k) - m) / l * rb(warp_sum(dd * sv[k * HS + lane]));
      float dq = 0.f;
      for (int k = 0; k < N; ++k) {
        const float p = expf(score(k) - m) / l;
        const float dp = rb(warp_sum(dd * sv[k * HS + lane]));
        const float ds = p * (dp - D) * scale;
        dq += ds * sk[k * HS + lane];
        if (lane == 0) {
          dsm[i * N + k] = ds;
          pbm[i * N + k] = rb(p);
        }
      }
      dbase[(long)i * 3 * IS] = to_bf16(dq);
    }
    __syncthreads();
    for (int k = warp; k < N; k += TB / 32) {
      float dk = 0.f, dv = 0.f;
      for (int i = 0; i < N; ++i) {
        dk += dsm[i * N + k] * sq[i * HS + lane];
        dv += pbm[i * N + k] * sd[i * HS + lane];
      }
      dbase[(long)k * 3 * IS + IS] = to_bf16(dk);
      dbase[(long)k * 3 * IS + 2 * IS] = to_bf16(dv);
    }
    __syncthreads();
  }
}

// dx = bf16(dy W) over the token rows, dy [T, N] (row stride ldy), W [N,
// K] read MN-major (out32: f32; mask: zero where mask <= 0)
__device__ void tok_dx(const Ctx& c, int j, const bf16* dy, int ldy, int N,
                       const bf16* wt, int K, bf16* out16, float* out32,
                       const bf16* mask, uint32_t ring) {
  int m0, n0;
  tile_at(j, K, m0, n0);
  float acc[32];
  prod_tile(acc, prod(dy, ldy, 0, wt, K, 1, c.g.T, K), m0, n0, 0, N, ring);
  if (out32)
    epi_f32(acc, m0, n0, c.g.T, out32, K);
  else
    epi_bf16(acc, m0, n0, c.g.T, out16, K, mask);
}

// the image rows' input gradients, a job per (object, 64 pixel rows, 64
// columns): dk0 = bf16(dpre4 + dkq Wtkq + dvt Wtv) (K0 feeds LN4's
// residual, both kin products and t2i's v) and kd = dkq Wtkq (f32), the
// object's part of dkpe (kin = K0 + kpe)
__device__ void b_img_dx(const Ctx& c, int j, uint32_t ring) {
  const Geo& g = c.g;
  const int n0 = (j % (C_ / BT)) * BT, t2 = j / (C_ / BT);
  const int m0 = (t2 % g.tiles_hw) * BT, o = t2 / g.tiles_hw;
  const long base = (long)o * g.HW;
  float a[32], b[32], dp[32];
  prod_tile(a, prod(c.b.dkq + base * 2 * IX, 2 * IX, 0, wb(c, W_TKQ), C_, 1,
                    g.HW, C_),
            m0, n0, 0, 2 * IX, ring);
  prod_tile(b, prod(c.b.dvt + base * IX, IX, 0, wb(c, W_TV), C_, 1, g.HW, C_),
            m0, n0, 0, IX, ring);
  const int r0 = acc_r0(m0), c0 = acc_c0(n0);
  gather(dp, c.b.dpre4 + base * C_, C_, r0, c0, g.HW);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r0 + 8 * h >= g.HW) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int i = 4 * n + 2 * h;
      const long at = (base + r0 + 8 * h) * C_ + c0 + 8 * n;
      st2(c.dk0 + at, dp[i] + a[i] + b[i], dp[i + 1] + a[i + 1] + b[i + 1]);
      *reinterpret_cast<float2*>(c.b.kd + at) = make_float2(a[i], a[i + 1]);
    }
  }
}

// dkpe = bf16(the objects' kd added in object order), a job per 512 values
__device__ void b_dkpe(const Ctx& c, int j) {
  const Geo& g = c.g;
  const long e = (long)j * 512 + 4 * threadIdx.x, n = (long)g.HW * C_;
  if (e >= n) return;
  float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int o = 0; o < g.O; ++o) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(c.b.kd + o * n + e));
    t.x += v.x;
    t.y += v.y;
    t.z += v.z;
    t.w += v.w;
  }
  st2(c.dkpe + e, t.x, t.y);
  st2(c.dkpe + e + 2, t.z, t.w);
}

// dx = [dpre1 +] dqk + dv0 and dqpe = dqd + dqb [+ dqk] over the token
// rows, dqk = dsqkv[:, q k] Wsqkv[q k] (the self-attention's q and k read
// x + qpe, or x in the first block), dv0 = dsqkv[:, v] Wsqkv[v]
__device__ void b_tok_dx(const Ctx& c, int j, uint32_t ring) {
  int m0, n0;
  tile_at(j, C_, m0, n0);
  float qk[32], v0[32], dd[32], db[32], d1[32];
  prod_tile(qk, prod(c.b.dsqkv, 3 * IS, 0, wb(c, W_SQKV), C_, 1, c.g.T, C_),
            m0, n0, 0, 2 * IS, ring);
  prod_tile(v0, prod(c.b.dsqkv + 2 * IS, 3 * IS, 0,
                     wb(c, W_SQKV) + 2L * IS * C_, C_, 1, c.g.T, C_),
            m0, n0, 0, IS, ring);
  const int r0 = acc_r0(m0), c0 = acc_c0(n0);
  gather(dd, c.b.dqd, C_, r0, c0, c.g.T);
  gather(db, c.b.dqb, C_, r0, c0, c.g.T);
  if (!c.first) gather(d1, c.b.dpre1, C_, r0, c0, c.g.T);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r0 + 8 * h >= c.g.T) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int i = 4 * n + 2 * h;
      const long at = (long)(r0 + 8 * h) * C_ + c0 + 8 * n;
      if (c.first) {
        st2(c.dx + at, qk[i] + v0[i], qk[i + 1] + v0[i + 1]);
        st2(c.dqpe + at, dd[i] + db[i], dd[i + 1] + db[i + 1]);
      } else {
        st2(c.dx + at, d1[i] + qk[i] + v0[i], d1[i + 1] + qk[i + 1] + v0[i + 1]);
        st2(c.dqpe + at, dd[i] + db[i] + qk[i], dd[i + 1] + db[i + 1] + qk[i + 1]);
      }
    }
  }
}

// column sums of the token rows' bf16 [T, n] gradient into G (a job per
// 128 columns)
__device__ __forceinline__ void tok_bias(const Ctx& c, int j, const bf16* a,
                                         int n, float* out) {
  colsum(a, n, n, 0, c.g.T, j * TB, out);
}

__global__ void __launch_bounds__(TB, 2)
twoway_bwd_kernel(const __grid_constant__ Ctx c) {
  extern __shared__ unsigned char tw_smem[];
  unsigned char* gen;
  const uint32_t sm = aligned_smem(tw_smem, &gen);
  const Geo& g = c.g;
  const int rt = g.rt, wg = c.wgrad;
  unsigned target = 0;
  unsigned* bar = c.b.bar;
  float* G = c.G;

  // ---- D backward, per JR image rows of each object
  b_i2t(c, gen, sm);
  grid_sync(bar, target);
  // the objects' dK, dV (their tiles' partials in order); LN4's sums
  {
    const int n1 = cdv((long)g.T * 2 * IX, TB), n2 = n1 + red_jobs(c, SEG_LN4, SEG_LN3);
    for (int j = blockIdx.x; j < n2; j += gridDim.x) {
      if (j >= n1) {
        red_job(c, SEG_LN4, j - n1);
        continue;
      }
      const long e = (long)j * TB + threadIdx.x;
      if (e >= (long)g.T * 2 * IX) continue;
      const long row = e / (2 * IX);
      const int o = (int)(row / g.N), k = (int)(row % g.N);
      const int cc = (int)(e % (2 * IX));
      const float* src = c.b.ikvp + ((long)o * g.jobs_hw * g.N + k) * 2 * IX + cc;
      float s = 0.f;
#pragma unroll 4
      for (int t = 0; t < g.jobs_hw; ++t) s += __ldcg(src + (long)t * g.N * 2 * IX);
      c.b.dikv[e] = to_bf16(s);
    }
  }
  grid_sync(bar, target);
  // dqd = dK Wik, dxa = dV Wiv (f32); dWik, dWiv and their biases
  {
    const int n1 = rt * 4, n2 = 2 * n1, n3 = n2 + (wg ? 8 : 0),
              n4 = n3 + (wg ? 8 : 0), n5 = n4 + (wg ? 2 : 0);
    for (int j = blockIdx.x; j < n5; j += gridDim.x) {
      if (j < n1)
        tok_dx(c, j, c.b.dikv, 2 * IX, IX, wb(c, W_IK), C_, nullptr, c.b.dqd,
               nullptr, sm);
      else if (j < n2)
        tok_dx(c, j - n1, c.b.dikv + IX, 2 * IX, IX, wb(c, W_IV), C_, nullptr,
               c.b.dxa, nullptr, sm);
      else if (j < n3)
        wgrad_tok(c, j - n2, c.b.dikv, 2 * IX, c.f.x3pe, C_, IX, C_, G + G_IK,
                  sm);
      else if (j < n4)
        wgrad_tok(c, j - n3, c.b.dikv + IX, 2 * IX, c.xout, C_, IX, C_,
                  G + G_IV, sm);
      else
        colsum(c.b.dikv + (j - n4) * IX, 2 * IX, IX, 0, g.T, 0,
               G + (j == n4 ? G_IBK : G_IBV));
    }
  }
  grid_sync(bar, target);
  // ---- C backward: LN3, then the MLP
  b_ln(c, gen, c.f.pre3, wf(c, LN3W), c.dxo, c.b.dqd, c.b.dxa, nullptr, 0, 0,
       c.b.dpre3, c.b.dpre3b, c.b.lnp3);
  grid_sync(bar, target);
  {
    const int n1 = rt * (HID / BT), n2 = n1 + (wg ? 4 * (HID / BT) : 0),
              n3 = n2 + (wg ? 2 : 0), n4 = n3 + red_jobs(c, SEG_LN3, SEG_LN2);
    for (int j = blockIdx.x; j < n4; j += gridDim.x) {
      if (j < n1)
        tok_dx(c, j, c.b.dpre3b, C_, C_, wb(c, W_M2), HID, c.b.dh, nullptr,
               c.f.r, sm);
      else if (j < n2)
        wgrad_tok(c, j - n1, c.b.dpre3b, C_, c.f.r, HID, C_, HID, G + G_M2, sm);
      else if (j < n3)
        tok_bias(c, j - n2, c.b.dpre3b, C_, G + G_MB2);
      else
        red_job(c, SEG_LN3, j - n3);
    }
  }
  grid_sync(bar, target);
  {
    const int tiles = rt * (C_ / BT), kc = HID / g.ks3;
    const int n1 = tiles * g.ks3, n2 = n1 + (wg ? (HID / BT) * 4 : 0),
              n3 = n2 + (wg ? HID / TB : 0);
    for (int j = blockIdx.x; j < n3; j += gridDim.x) {
      if (j < n1) {
        const int ks = j / tiles;
        int m0, n0;
        tile_at(j % tiles, C_, m0, n0);
        float acc[32];
        prod_tile(acc, prod(c.b.dh, HID, 0, wb(c, W_M1), C_, 1, g.T, C_), m0,
                  n0, ks * kc, (ks + 1) * kc, sm);
        epi_f32(acc, m0, n0, g.T, c.b.dx2p + (long)ks * g.T * C_, C_);
      } else if (j < n2) {
        wgrad_tok(c, j - n1, c.b.dh, HID, c.f.x2, C_, HID, C_, G + G_M1, sm);
      } else {
        tok_bias(c, j - n2, c.b.dh, HID, G + G_MB1);
      }
    }
  }
  grid_sync(bar, target);
  // ---- B backward: LN2 (dx2 = the chunks' sum + dpre3), out-projection
  b_ln(c, gen, c.f.pre2, wf(c, LN2W), nullptr, c.b.dpre3, nullptr, c.b.dx2p,
       g.ks3, (long)g.T * C_, c.b.dpre2, c.b.dpre2b, c.b.lnp2);
  grid_sync(bar, target);
  {
    const int n1 = rt * 2, n2 = n1 + (wg ? 8 : 0), n3 = n2 + (wg ? 2 : 0),
              n4 = n3 + red_jobs(c, SEG_LN2, SEG_IMG);
    for (int j = blockIdx.x; j < n4; j += gridDim.x) {
      if (j < n1)
        tok_dx(c, j, c.b.dpre2b, C_, C_, wb(c, W_TO), IX, c.b.do2, nullptr,
               nullptr, sm);
      else if (j < n2)
        wgrad_tok(c, j - n1, c.b.dpre2b, C_, c.f.to, IX, C_, IX, G + G_TO, sm);
      else if (j < n3)
        tok_bias(c, j - n2, c.b.dpre2b, C_, G + G_TBO);
      else
        red_job(c, SEG_LN2, j - n3);
    }
  }
  grid_sync(bar, target);
  b_t2i(c, gen);
  grid_sync(bar, target);
  // dq merged in split order; the image rows' input gradients per object;
  // the image rows' weight gradients in chunks (with their biases' sums)
  {
    const int ic = g.img_chunks;
    const int n1 = cdv((long)g.T * IX, TB);
    const int n2 = n1 + g.O * g.tiles_hw * (C_ / BT);
    const int n3 = n2 + (wg ? ic * 16 : 0), n4 = n3 + (wg ? ic * 8 : 0),
              n5 = n4 + (wg ? ic * 8 : 0);
    for (int j = blockIdx.x; j < n5; j += gridDim.x) {
      if (j < n1) {
        const long e = (long)j * TB + threadIdx.x;
        if (e < (long)g.T * IX) {
          const long row = e / IX;                  // o N + i
          const int cc = (int)(e % IX), h = cc / HX, d = cc % HX;
          const int o = (int)(row / g.N), i = (int)(row % g.N);
          const float* src = c.b.dqp + (((long)o * HEADS + h) * g.ns * g.N + i) * HX + d;
          float s = 0.f;
#pragma unroll 4
          for (int sp = 0; sp < g.ns; ++sp) s += __ldcg(src + (long)sp * g.N * HX);
          c.b.dqt[e] = to_bf16(s);
        }
      } else if (j < n2) {
        b_img_dx(c, j - n1, sm);
      } else if (j < n3) {
        wgrad_img(c, j - n2, c.b.dkq, 2 * IX, c.f.kin, C_, 2 * IX, C_,
                  c.b.wtkqp, c.b.btkqp, gen, sm);
      } else if (j < n4) {
        wgrad_img(c, j - n3, c.b.dvt, IX, c.k0, C_, IX, C_, c.b.wtvp, c.b.btvp,
                  gen, sm);
      } else {
        wgrad_img(c, j - n4, c.b.dpre4b, C_, c.f.io, IX, C_, IX, c.b.wiop,
                  c.b.biop, gen, sm);
      }
    }
  }
  grid_sync(bar, target);
  // dqb = dq Wtq (f32); dWtq and its bias; dkpe; the image rows' sums
  {
    const int n1 = rt * 4, n2 = n1 + (wg ? 8 : 0), n3 = n2 + (wg ? 1 : 0);
    const int n4 = n3 + cdv((long)g.HW * C_, 512);
    const int n5 = n4 + red_jobs(c, SEG_IMG, SEG_LN1);
    for (int j = blockIdx.x; j < n5; j += gridDim.x) {
      if (j < n1)
        tok_dx(c, j, c.b.dqt, IX, IX, wb(c, W_TQ), C_, nullptr, c.b.dqb, nullptr,
               sm);
      else if (j < n2)
        wgrad_tok(c, j - n1, c.b.dqt, IX, c.f.x1pe, C_, IX, C_, G + G_TQ, sm);
      else if (j < n3)
        tok_bias(c, 0, c.b.dqt, IX, G + G_TBQ);
      else if (j < n4)
        b_dkpe(c, j - n3);
      else
        red_job(c, SEG_IMG, j - n4);
    }
  }
  grid_sync(bar, target);
  // ---- A backward: LN1 (dx1 = dpre2 + dqb), out-projection, attention
  b_ln(c, gen, c.f.pre1, wf(c, LN1W), nullptr, c.b.dpre2, c.b.dqb, nullptr, 0,
       0, c.b.dpre1, c.b.dpre1b, c.b.lnp1);
  grid_sync(bar, target);
  {
    const int n1 = rt * 4, n2 = n1 + (wg ? 16 : 0), n3 = n2 + (wg ? 2 : 0),
              n4 = n3 + red_jobs(c, SEG_LN1, SEG_END);
    for (int j = blockIdx.x; j < n4; j += gridDim.x) {
      if (j < n1)
        tok_dx(c, j, c.b.dpre1b, C_, C_, wb(c, W_SO), IS, c.b.dos, nullptr,
               nullptr, sm);
      else if (j < n2)
        wgrad_tok(c, j - n1, c.b.dpre1b, C_, c.f.so, IS, C_, IS, G + G_SO, sm);
      else if (j < n3)
        tok_bias(c, j - n2, c.b.dpre1b, C_, G + G_SBO);
      else
        red_job(c, SEG_LN1, j - n3);
    }
  }
  grid_sync(bar, target);
  b_self(c, gen);
  grid_sync(bar, target);
  // the token inputs' gradients; dWsqkv and its bias
  {
    const int n1 = rt * 4, n2 = n1 + (wg ? 48 : 0), n3 = n2 + (wg ? 6 : 0);
    for (int j = blockIdx.x; j < n3; j += gridDim.x) {
      if (j < n1) {
        b_tok_dx(c, j, sm);
      } else if (j < n2) {
        const int jj = j - n1;         // rows 0..511 from the q / k input
        if (jj < 32)
          wgrad_tok(c, jj, c.b.dsqkv, 3 * IS, c.first ? c.x : c.f.q0, C_,
                    2 * IS, C_, G + G_SQKV, sm);
        else
          wgrad_tok(c, jj - 32, c.b.dsqkv + 2 * IS, 3 * IS, c.x, C_, IS, C_,
                    G + G_SQKV + 2L * IS * C_, sm);
      } else {
        tok_bias(c, j - n2, c.b.dsqkv, 3 * IS, G + G_SBQKV);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Entry points
// ---------------------------------------------------------------------------

// a cooperative launch of every block that fits the card at `smem` bytes
template <class K>
static int launch(K* kern, const Ctx& c, int smem, unsigned* bar,
                  cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  int dev = 0, sms = 0, per = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, TB, smem);
  if (e != cudaSuccess) return (int)e;
  if (per < 1) return (int)cudaErrorInvalidConfiguration;
  per = per < 2 ? per : 2;
  if ((e = cudaMemsetAsync(bar, 0, sizeof(unsigned), st)) != cudaSuccess)
    return (int)e;
  void* args[] = {const_cast<Ctx*>(&c)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                  dim3(sms * per), dim3(TB), args, smem, st);
  return (int)e;
}

static Ctx context(const void* x_, const void* k0_, const void* qpe_,
                   const void* kpe_, const void* const* w, int O, int N,
                   int HW, int first) {
  Ctx c{};
  c.x = static_cast<const bf16*>(x_);
  c.k0 = static_cast<const bf16*>(k0_);
  c.qpe = static_cast<const bf16*>(qpe_);
  c.kpe = static_cast<const bf16*>(kpe_);
  for (int i = 0; i < W_NUM; ++i) c.w[i] = w[i];
  c.g = geo(O, N, HW);
  c.first = first;
  return c;
}

// x, qpe [O, N, 256]; k0 [O, HW, 256]; kpe [HW, 256]; all bf16. Writes
// xout [O, N, 256], kout [O, HW, 256] and the activations into fws.
extern "C" int twoway_fwd(const void* x_, const void* k0_, const void* qpe_,
                          const void* kpe_, const void* const* w, void* xout_,
                          void* kout_, void* fws, int O, int N, int HW,
                          int first, void* stream_ptr) {
  if (O < 1 || N < 1 || HW < 1) return (int)cudaErrorInvalidValue;
  Ctx c = context(x_, k0_, qpe_, kpe_, w, O, N, HW, first);
  c.xout = static_cast<bf16*>(xout_);
  c.kout = static_cast<bf16*>(kout_);
  Arena ar{static_cast<char*>(fws), 0};
  c.f = carve_fwd(ar, c.g);
  const int err = launch(twoway_fwd_kernel, c, fwd_smem(c.g), c.f.bar,
                         static_cast<cudaStream_t>(stream_ptr));
  return err ? err : (int)cudaGetLastError();
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
  if (O < 1 || N < 1 || HW < 1) return (int)cudaErrorInvalidValue;
  Ctx c = context(x_, k0_, qpe_, kpe_, w, O, N, HW, first);
  c.xout = const_cast<bf16*>(static_cast<const bf16*>(x3_));
  Arena af{const_cast<char*>(static_cast<const char*>(fws)), 0};
  c.f = carve_fwd(af, c.g);
  Arena ab{static_cast<char*>(ws), 0};
  c.b = carve_bwd(ab, c.g);
  c.dxo = static_cast<const bf16*>(dx3_);
  c.dko = static_cast<const bf16*>(dk1_);
  c.dx = static_cast<bf16*>(dx_);
  c.dk0 = static_cast<bf16*>(dk0_);
  c.dqpe = static_cast<bf16*>(dqpe_);
  c.dkpe = static_cast<bf16*>(dkpe_);
  c.G = static_cast<float*>(grads);
  c.wgrad = wgrad;
  const Geo& g = c.g;
  const int lnj = cdv(g.T, LN_ROWS), jobs = g.O * g.jobs_hw;
  const int ic = g.img_chunks;
  auto seg = [&](const float* src, long stride, long len, long dst,
                 int count) {
    c.seg[c.nseg++] = WSeg{src, stride, len, dst, count};
  };
  seg(c.b.ln4p, 2L * C_, C_, G_TOKEN + I_LN4W, jobs);             // SEG_LN4
  seg(c.b.ln4p + C_, 2L * C_, C_, G_TOKEN + I_LN4B, jobs);
  seg(c.b.lnp3, 2L * C_, C_, G_LN3W, lnj);                        // SEG_LN3
  seg(c.b.lnp3 + C_, 2L * C_, C_, G_LN3B, lnj);
  seg(c.b.lnp2, 2L * C_, C_, G_LN2W, lnj);                        // SEG_LN2
  seg(c.b.lnp2 + C_, 2L * C_, C_, G_LN2B, lnj);
  seg(c.b.wtkqp, 2L * IX * C_, 2L * IX * C_, G_TOKEN + I_TKQ, ic);  // SEG_IMG
  seg(c.b.btkqp, 2L * IX, 2L * IX, G_TOKEN + I_TBKQ, ic);
  seg(c.b.wtvp, (long)IX * C_, (long)IX * C_, G_TOKEN + I_TV, ic);
  seg(c.b.btvp, IX, IX, G_TOKEN + I_TBV, ic);
  seg(c.b.wiop, (long)C_ * IX, (long)C_ * IX, G_TOKEN + I_IO, ic);
  seg(c.b.biop, C_, C_, G_TOKEN + I_IBO, ic);
  seg(c.b.lnp1, 2L * C_, C_, G_LN1W, lnj);                        // SEG_LN1
  seg(c.b.lnp1 + C_, 2L * C_, C_, G_LN1B, lnj);
  const int err = launch(twoway_bwd_kernel, c, bwd_smem(g), c.b.bar,
                         static_cast<cudaStream_t>(stream_ptr));
  return err ? err : (int)cudaGetLastError();
}
