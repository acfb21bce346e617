// Memory encoder forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel
// sam2_video_tpu/ops/memory_encoder_kernel.py:fused_memory_encoder (Pallas
// _kernel): from the space-to-depth mask [N, h, w, 256],
// 4 x (2x2 phase-routed conv -> phase-packed LayerNorm -> GELU) -> 1x1 conv
// + projected pixels -> 2 CXBlocks (depthwise 7x7, LN, pw1, GELU, pw2,
// layer scale, residual) -> out_proj to out_dim.
//
// What bounds it on an H100 (384 px, 8 objects, 24 x 24 x 256 per object):
// the function needs ~12.5 GFLOP of products per call (the k3/s2 pyramid
// at its own resolutions 1.8, the 1x1 conv 0.6, two 256 -> 1024 -> 256
// MLPs 9.7, depthwise and out_proj 0.4): about 13 us at 989 TFLOP/s,
// against ~8 MB of inputs, output and weights (2.4 us at 3.35 TB/s). The
// four 2x2 convs as K = 1024 products do 9.7 GFLOP where the pyramid needs
// 1.8 (the zeros of the phase routing). The products bound it, so each
// runs on the tensor cores through the shared GEMM: the 2x2 conv reads its
// four shifted taps through an implicit-im2col A loader (no im2col
// buffer), and bias, GELU, layer scale and both residuals ride
// in the GEMM epilogue. The packed LayerNorm is a plain per-phase-group
// reduction (the TPU kernel's group-mean matmul was a trick for its matrix
// unit), and the depthwise 7x7 is a per-channel FMA loop over cached loads.
// The C entry point launches the chain in order on the caller's stream.

#include "common.cuh"

// depthwise 7x7 conv, zero padding 3, f32 out: y = dwconv(x) + bias.
// One block per output position, one thread per channel (coalesced).
__global__ void dwconv7_kernel(const bf16* __restrict__ x,
                               float* __restrict__ y,
                               const float* __restrict__ w,   // [49, C]
                               const float* __restrict__ bias, int h, int wd,
                               int C) {
  const int pos = blockIdx.x;
  const int j = pos % wd, t = pos / wd;
  const int i = t % h, n = t / h;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = bias[c];
    for (int a = 0; a < 7; ++a) {
      const int ii = i + a - 3;
      if (ii < 0 || ii >= h) continue;
      for (int b = 0; b < 7; ++b) {
        const int jj = j + b - 3;
        if (jj < 0 || jj >= wd) continue;
        acc += to_f32(x[(((size_t)n * h + ii) * wd + jj) * C + c]) *
               w[(a * 7 + b) * C + c];
      }
    }
    y[(size_t)pos * C + c] = acc;
  }
}

// Weight pointer table, in this order (bf16 products in torch [out, in]
// layout, everything else f32):
//   for each of the 4 downsampler layers L:
//     conv W [256, 4*256] (column = tap * 256 + packed input lane),
//     conv bias [256] (lane-expanded), LN weight [co_L], LN bias [co_L]
//   final 1x1: W [256, 256], bias [256]
//   for each of the 2 CXBlocks: dw [49, 256], dw bias [256], LN w, LN b,
//     pw1 W [1024, 256], pw1 b [1024], pw2 W [256, 1024], pw2 b [256],
//     gamma [256]
//   out_proj: W [out_dim, 256], bias [out_dim]
constexpr int ME_NUM_WEIGHTS = 4 * 4 + 2 + 2 * 9 + 2;

// C entry point. ms [N,h,w,256] s2d mask, pix [N,h,w,256] projected pixel
// features, out [N,h,w,out_dim], all bf16. Scratch: tmp, act, xa, xb, yb
// bf16 [M, 256]; y32 f32 [M, 256]; hid bf16 [M, 1024]; M = N*h*w.
// phases[L] = packed phases of layer L (64, 16, 4, 1).
extern "C" int memory_encoder_fwd(const void* ms, const void* pix, void* out,
                                  const void* const* wt, const int* phases,
                                  void* tmp, void* act, void* xa, void* xb,
                                  void* yb, void* y32, void* hid, int N,
                                  int h, int w, int out_dim,
                                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int M = N * h * w, C = 256, HID = 1024;
  auto bfp = [](const void* p) { return static_cast<const bf16*>(p); };
  auto fp = [](const void* p) { return static_cast<const float*>(p); };
  bf16* tmp_b = static_cast<bf16*>(tmp);
  bf16* act_b = static_cast<bf16*>(act);

  // downsampler pyramid in the phase-packed 1/16-resolution layout
  const bf16* cur = bfp(ms);
  for (int L = 0; L < 4; ++L) {
    const void* const* lw = wt + 4 * L;
    gemm(Conv2x2A{cur, h, w, C}, bfp(lw[0]), tmp_b, M, C, 4 * C,
         epi(fp(lw[1])), stream);
    layer_norm<bf16>(tmp_b, act_b, fp(lw[2]), fp(lw[3]), M, C, phases[L],
                     1e-6f, 1, stream);
    cur = act_b;
  }

  // final 1x1 conv + projected pixels
  bf16* x_cur = static_cast<bf16*>(xa);
  bf16* x_nxt = static_cast<bf16*>(xb);
  gemm(DenseA{cur, C}, bfp(wt[16]), x_cur, M, C, C,
       epi(fp(wt[17]), 0, nullptr, bfp(pix)), stream);

  // fuser: 2 CXBlocks
  for (int i = 0; i < 2; ++i) {
    const void* const* cw = wt + 18 + 9 * i;
    dwconv7_kernel<<<M, 256, 0, stream>>>(x_cur, static_cast<float*>(y32),
                                          fp(cw[0]), fp(cw[1]), h, w, C);
    layer_norm<float>(static_cast<const float*>(y32), static_cast<bf16*>(yb),
                      fp(cw[2]), fp(cw[3]), M, C, 1, 1e-6f, 0, stream);
    gemm(DenseA{bfp(yb), C}, bfp(cw[4]), static_cast<bf16*>(hid), M, HID, C,
         epi(fp(cw[5]), 1), stream);
    gemm(DenseA{bfp(hid), HID}, bfp(cw[6]), x_nxt, M, C, HID,
         epi(fp(cw[7]), 0, fp(cw[8]), x_cur), stream);
    bf16* t = x_cur;
    x_cur = x_nxt;
    x_nxt = t;
  }

  // out_proj
  gemm(DenseA{x_cur, C}, bfp(wt[36]), static_cast<bf16*>(out), M, out_dim, C,
       epi(fp(wt[37])), stream);
  return (int)cudaGetLastError();
}

extern "C" int memory_encoder_num_weights() { return ME_NUM_WEIGHTS; }
