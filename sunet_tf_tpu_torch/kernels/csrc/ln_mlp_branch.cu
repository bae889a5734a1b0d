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
// Design: two launches on gemm_tile.cuh's GEMM over hopper.cuh's mainloop,
// the products of fused_ln_mlp (ln_mlp.cu, #4) without its LayerNorm row
// kernel and its residual:
// 1. fc1: one CTA per 64-row x 128-column tile; its A operand is the
//    LayerNorm of the tile's 64 rows, computed in fp32 and rounded once as
//    it enters shared memory (kLnA, as #3's qkv); w1's boxes by TMA into
//    the ring; the epilogue adds b1, applies the erf GELU and stores h
//    rounded (the only workspace);
// 2. fc2: a cluster of ks CTAs per 64-row x 128-column tile, each over
//    hidden / ks rows of w2 (ks from the launch plan, kernels/
//    window_attention.py::mlp_plan, #4's: 4 for the default model's 8x8
//    map, 96 CTAs at batch 4); the fp32 partials meet in distributed shared
//    memory, rank r sums its 128/ks columns in rank order, adds b2 and
//    rounds once: the same bits every run.
// Rows past the end are zero-filled and not written.
#include "gemm_tile.cuh"

using namespace sunet;

extern "C" size_t sunet_ln_mlp_branch_workspace(int M, int C, int hidden) {
  Carve cv{nullptr};
  cv.take<bf16>((size_t)M * hidden);   // h = round(gelu(fc1))
  return cv.used;
}

// out (M, C) = round(fc2(round(gelu(fc1(round(LN(y))) + b1))) + b2); ks:
// fc2's K split (its cluster size, from the launch plan).
extern "C" int sunet_ln_mlp_branch(const void* y, void* out, const void* g, const void* be,
                                   const void* w1, const void* b1, const void* w2,
                                   const void* b2, void* work, int M, int C, int hidden, int ks,
                                   int* launches, void* stream) {
  if (M <= 0 || C % 16 || C > 256 * kLnChunks || hidden % 16 || ks < 1 ||
      hidden % (16 * ks) || kGemmCols % ks)
    return (int)cudaErrorInvalidValue;
  bf16* h = (bf16*)work;
  cudaStream_t st = (cudaStream_t)stream;
  *launches = 0;
  SUNET_TRY((gemm_tile<kEpiGelu, false, true>(
      GemmArgs{(const bf16*)y, (const float*)b1, nullptr, h, M, C, C, hidden, 1, 0.f, 0,
               (const float*)g, (const float*)be},
      w1, st)));
  ++*launches;
  SUNET_TRY((gemm_tile<kEpiBias, true>(
      GemmArgs{h, (const float*)b2, nullptr, (bf16*)out, M, hidden, hidden / ks, C, ks, 0.f, 0},
      w2, st)));
  ++*launches;
  return 0;
}
