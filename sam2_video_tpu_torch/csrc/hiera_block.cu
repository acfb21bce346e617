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
// products bound it. The design puts every product on the tensor cores
// (mma.sync m16n8k16, f32 accumulate): the projections and MLP through the
// shared GEMM with bias, GELU and residual fused into its epilogue, and
// the attention per (window, head) over key chunks in shared memory, so a
// window needs no mask: the block-diagonal mask the TPU kernel needed for
// its 128-wide matrix unit disappears (hiera_window.cuh). The C entry point launches the block's kernels in
// order on the caller's stream; x1, the residual after attention, lands in
// a caller-owned buffer, which the trainable block keeps for its backward.

#include "hiera_window.cuh"

// ---------------------------------------------------------------------------
// C entry point: one Hiera block.
//
// Pointers: x [B,H,W,Cin] bf16 -> out [B,Ho,Wo,Cout] bf16. Weights bf16 in
// torch [out, in] layout, biases and LN parameters f32. wsc/bsc null when
// Cin == Cout. Scratch (bf16): xn [B*H*W, Cin], qkv [B*H*W, 3Cout],
// sc_full [B*H*W, Cout] and sc [B*Ho*Wo, Cout] (dim-change blocks only),
// attn, x1, y [B*Ho*Wo, Cout], hid [B*Ho*Wo, hidden].
// wsh/wsw: window size (global: H, W). Returns cudaGetLastError().
// ---------------------------------------------------------------------------

extern "C" int hiera_block_fwd(
    const void* x, void* out, const void* ln1w, const void* ln1b,
    const void* wqkv, const void* bqkv, const void* wproj, const void* bproj,
    const void* ln2w, const void* ln2b, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* wsc, const void* bsc,
    void* xn, void* qkv, void* sc_full, void* sc, void* attn, void* x1,
    void* y, void* hid, int B, int H, int W, int Cin, int Cout, int heads,
    int hidden, int wsh, int wsw, int q_pool, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int Ho = q_pool ? H / 2 : H, Wo = q_pool ? W / 2 : W;
  const int M_in = B * H * W, M_out = B * Ho * Wo;
  auto bfp = [](const void* p) { return static_cast<const bf16*>(p); };
  auto fp = [](const void* p) { return static_cast<const float*>(p); };

  layer_norm<bf16>(bfp(x), static_cast<bf16*>(xn), fp(ln1w), fp(ln1b), M_in,
                   Cin, 1, 1e-6f, 0, stream);

  const bf16* shortcut = bfp(x);
  if (wsc) {
    gemm(DenseA{bfp(xn), Cin}, bfp(wsc), static_cast<bf16*>(sc_full), M_in,
         Cout, Cin, epi(fp(bsc)), stream);
    shortcut = bfp(sc_full);
    if (q_pool) {
      const size_t total = (size_t)M_out * Cout;
      const int blocks = (int)((total + 255) / 256 < 65535 ? (total + 255) / 256 : 65535);
      maxpool2x2_kernel<<<blocks, 256, 0, stream>>>(
          bfp(sc_full), static_cast<bf16*>(sc), B, H, W, Cout);
      shortcut = bfp(sc);
    }
  }

  gemm(DenseA{bfp(xn), Cin}, bfp(wqkv), static_cast<bf16*>(qkv), M_in,
       3 * Cout, Cin, epi(fp(bqkv)), stream);

  window_attention(bfp(qkv), fp(bqkv), static_cast<bf16*>(attn), B, H, W,
                   Cout, heads, wsh, wsw, q_pool, stream);

  gemm(DenseA{bfp(attn), Cout}, bfp(wproj), static_cast<bf16*>(x1), M_out,
       Cout, Cout, epi(fp(bproj), 0, nullptr, shortcut), stream);
  layer_norm<bf16>(bfp(x1), static_cast<bf16*>(y), fp(ln2w), fp(ln2b), M_out,
                   Cout, 1, 1e-6f, 0, stream);
  gemm(DenseA{bfp(y), Cout}, bfp(w1), static_cast<bf16*>(hid), M_out, hidden,
       Cout, epi(fp(b1), 1), stream);
  gemm(DenseA{bfp(hid), hidden}, bfp(w2), static_cast<bf16*>(out), M_out,
       Cout, hidden, epi(fp(b2), 0, nullptr, bfp(x1)), stream);
  return (int)cudaGetLastError();
}
