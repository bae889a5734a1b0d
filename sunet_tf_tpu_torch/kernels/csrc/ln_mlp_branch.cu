// The LN + MLP branch of a training block: fc2(gelu(fc1(LN(y)))), no
// residual, no drop-path (autograd applies both outside).
//
// Replaces sunet_tf_tpu/kernels/window_attention.py::_ln_mlp_branch (its
// kernel _mlp_branch_kernel), the forward of ln_mlp_trainable, on the
// blocks trained through the two sublayers (C=768, hidden 3072 at the
// bottleneck of the default model). Rounding points as the JAX kernel: LN
// in fp32, rounded; fc1 accumulated in fp32 plus b1, exact-erf GELU in fp32,
// rounded; fc2 accumulated in fp32 plus b2, rounded. The plain version is
// ln_mlp_branch_reference in kernels/window_attention.py.
//
// What bounds it on Hopper: at batch 4, 4*T*C*hidden = 2.4 GFLOP (2.4 us
// at the bf16 peak) against 9.4 MB of bf16 weights (2.8 us at 3.35 TB/s):
// the bytes. Every CTA of a product streams its weight panel from L2.
//
// Design: three launches over the token rows in the map's own order: the
// LayerNorm row kernel, then the two products on the tiled wmma GEMM of
// train_common.cuh, with bias and GELU (fc1) and bias (fc2) in the
// epilogues. It is not fused_ln_mlp (ln_mlp.cu), which adds y before its
// rounding and keeps fc2's sums in registers over 16-row tiles: at batch 4
// that kernel runs 16 CTAs, the two GEMMs here run 192 (fc1) and 48 (fc2).
#include "train_common.cuh"

namespace sunet {

struct MlpBranchWork {
  bf16 *yn, *h1;
  float* st;
  size_t bytes;
};

inline MlpBranchWork carve_mlp_branch(unsigned char* p, int T, int C, int hidden) {
  Carve cv{p};
  MlpBranchWork w;
  w.yn = cv.take<bf16>((size_t)T * C);
  w.h1 = cv.take<bf16>((size_t)T * hidden);
  w.st = cv.take<float>(2 * (size_t)T);
  w.bytes = cv.used;
  return w;
}

}  // namespace sunet

using namespace sunet;

extern "C" size_t sunet_ln_mlp_branch_workspace(int M, int C, int hidden) {
  return carve_mlp_branch(nullptr, M, C, hidden).bytes;
}

// out (M, C) = round(fc2(round(gelu(fc1(round(LN(y))) + b1))) + b2).
extern "C" int sunet_ln_mlp_branch(const void* y, void* out, const void* g, const void* be,
                                   const void* w1, const void* b1, const void* w2,
                                   const void* b2, void* work, int M, int C, int hidden,
                                   int* launches, void* stream) {
  if (M <= 0 || C % 16 || hidden % 16) return (int)cudaErrorInvalidValue;
  const MlpBranchWork w = carve_mlp_branch((unsigned char*)work, M, C, hidden);
  cudaStream_t st = (cudaStream_t)stream;
  *launches = 0;
  int* n = launches;
  SUNET_TRY(ln_fwd((const bf16*)y, false, nullptr, w.yn, w.st, (const float*)g,
                   (const float*)be, M, C, 0, 0, 0, 0, st, n));
  SUNET_TRY((gemm<false, false>(w.yn, C, (const bf16*)w1, hidden, M, hidden, C, 1,
                                EpiFc1{nullptr, w.h1, (const float*)b1, hidden}, nullptr, st,
                                n)));
  return (int)gemm<false, false>(w.h1, hidden, (const bf16*)w2, C, M, C, hidden, 1,
                                 EpiBias{(bf16*)out, (const float*)b2, C}, nullptr, st, n);
}
