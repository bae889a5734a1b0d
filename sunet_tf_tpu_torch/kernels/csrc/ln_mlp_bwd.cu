// Backward of the LN + MLP branch (no residual).
//
// Replaces sunet_tf_tpu/kernels/window_attention.py::_ln_mlp_bwd (its
// kernel _mlp_bwd_kernel), the backward of ln_mlp_trainable, on the blocks
// trained through the two sublayers (C=768, hidden 3072 at the bottleneck
// of the default model). It recomputes LN(y) and the fc1 pre-activation a,
// then, with the JAX kernel's rounding points: dm = round(dout); dw2 =
// round(gelu(a))^T dm; db2 = sum dm; da = (dm w2^T) * gelu'(a); dab =
// round(da); dw1 = yn^T dab; db1 = sum da (fp32); dyn = dab w1^T; dg, db;
// dy = LN^T(dyn * g) with no residual term (autograd adds the shortcut's).
// GELU and its derivative use the exact erf (erff), as the XLA path; the
// JAX kernel's Abramowitz-Stegun erf is 1.5e-7 from it. The plain version
// is ln_mlp_bwd_reference in kernels/window_attention.py.
//
// What bounds it on Hopper: at batch 4, 10*T*C*hidden = 6.0 GFLOP (6.1 us
// at the bf16 peak) against ~28 MB of bf16 weights and float32 weight
// grads (8.5 us at 3.35 TB/s): the bytes.
//
// Design, first version: the MLP half of the block backward
// (swin_block_bwd.cu) as its own fixed sequence of 15 launches over the
// token rows in the map's own order: the LN row kernels and the tiled wmma
// GEMM with fc1's bias and GELU, and GELU's derivative, in its epilogues
// (train_common.cuh). Weight grads sum over tokens in fixed chunks and then
// in a fixed order: no atomics, the same bits on every run.
#include "train_common.cuh"

namespace sunet {

struct MlpBwdWork {
  bf16 *yn, *h1, *dab;
  float *st, *a, *da, *dyn, *part;
  size_t bytes;
};

inline MlpBwdWork carve_mlp_bwd(unsigned char* p, int T, int C, int hidden) {
  Carve cv{p};
  MlpBwdWork w;
  const size_t tc = (size_t)T * C, th = (size_t)T * hidden;
  w.yn = cv.take<bf16>(tc);
  w.h1 = cv.take<bf16>(th);
  w.dab = cv.take<bf16>(th);
  w.st = cv.take<float>(2 * (size_t)T);
  w.a = cv.take<float>(th);
  w.da = cv.take<float>(th);
  w.dyn = cv.take<float>(tc);
  // partials: the weight-grad splits, the column sums and the LN
  // parameter sums, the largest of them
  size_t part = (size_t)gemm_splits(hidden, C, T) * hidden * C;
  part = std::max(part, (size_t)gemm_splits(C, hidden, T) * C * hidden);
  part = std::max(part, (size_t)((T + kColRows - 1) / kColRows) * hidden);
  part = std::max(part, (size_t)ln_ctas(T) * 2 * C);
  w.part = cv.take<float>(part);
  w.bytes = cv.used;
  return w;
}

}  // namespace sunet

using namespace sunet;

extern "C" size_t sunet_ln_mlp_bwd_workspace(int M, int C, int hidden) {
  return carve_mlp_bwd(nullptr, M, C, hidden).bytes;
}

// y, dout (M, C) bf16 -> dy (M, C) bf16 and the float32 grads of the LN
// scale and bias, w1 (C, hidden), b1, w2 (hidden, C) and b2.
extern "C" int sunet_ln_mlp_bwd(const void* y, const void* dout, const void* g, const void* be,
                                const void* w1, const void* b1, const void* w2, void* dy,
                                void* dg, void* db, void* dw1, void* db1, void* dw2, void* db2,
                                void* work, int M, int C, int hidden, int* launches,
                                void* stream) {
  if (M <= 0 || C % 16 || C > kLnMaxC || hidden % 16) return (int)cudaErrorInvalidValue;
  const MlpBwdWork w = carve_mlp_bwd((unsigned char*)work, M, C, hidden);
  const bf16 *yb = (const bf16*)y, *dm = (const bf16*)dout;
  const bf16 *w1b = (const bf16*)w1, *w2b = (const bf16*)w2;
  const float* gf = (const float*)g;
  cudaStream_t st = (cudaStream_t)stream;
  const int T = M, Hd = hidden;
  *launches = 0;
  int* n = launches;
  auto run = [&]() -> cudaError_t {
    // ---- forward recompute
    SUNET_TRY(ln_fwd(yb, false, nullptr, w.yn, w.st, gf, (const float*)be, T, C, 0, 0, 0, 0, st,
                     n));
    SUNET_TRY((gemm<false, false>(w.yn, C, w1b, Hd, T, Hd, C, 1,
                                  EpiFc1{w.a, w.h1, (const float*)b1, Hd}, nullptr, st, n)));
    // ---- fc2, fc1 and LN backward
    SUNET_TRY(weight_grad(w.h1, Hd, dm, C, Hd, C, T, w.part, (float*)dw2, st, n));
    SUNET_TRY(colsum(dm, T, C, w.part, (float*)db2, st, n));
    SUNET_TRY((gemm<false, true>(dm, C, w2b, C, T, Hd, C, 1, EpiDa{w.da, w.dab, w.a, Hd},
                                 nullptr, st, n)));
    SUNET_TRY(weight_grad(w.yn, C, w.dab, Hd, C, Hd, T, w.part, (float*)dw1, st, n));
    SUNET_TRY(colsum(w.da, T, Hd, w.part, (float*)db1, st, n));
    SUNET_TRY((gemm<false, true>(w.dab, Hd, w1b, Hd, T, C, Hd, 1, EpiF32{w.dyn, C, 0}, nullptr,
                                 st, n)));
    SUNET_TRY(ln_bwd(w.dyn, yb, w.st, gf, (bf16*)dy, w.part, T, C, st, n));
    return ln_param_grads(w.part, (float*)dg, (float*)db, T, C, st, n);
  };
  return (int)run();
}
