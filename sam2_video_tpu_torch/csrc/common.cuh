// Device code shared by the port's hand-written kernels (sm_90a):
//   - split2():     f32 values as bf16 hi / lo pairs (#3, #7);
//   - warp_sum(), rb(), gelu_erf() and its derivative: row reductions and
//                   the bf16 walk's pieces;
//   - Arena:        carving of one caller-allocated workspace.
// Nothing here launches a kernel or allocates.
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

constexpr int LN_MAX_C = 1280;         // the widest row a LayerNorm takes
                                       // (SAM2-large's stage 4: 1152)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffff, v, o);
  return v;
}

// round to bf16 and back
__device__ __forceinline__ float rb(float v) { return to_f32(to_bf16(v)); }

// d/dx of exact-erf GELU: Phi(x) + x phi(x)
__device__ __forceinline__ float gelu_erf_grad(float v) {
  return 0.5f * (1.0f + erff(v * 0.70710678118654752f)) +
         v * expf(-0.5f * v * v) * 0.39894228040143268f;
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
