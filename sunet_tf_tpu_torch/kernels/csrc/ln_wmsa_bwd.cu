// Backward of the LN + W-MSA + projection sublayer (no residual).
//
// Replaces sunet_tf_tpu/kernels/window_attention.py::_ln_wmsa_bwd_impl
// (its kernel _strip_bwd_kernel), the backward of
// ln_window_attention_trainable, on the blocks trained through the two
// sublayers (C=768 at the 8x8 bottleneck of the default model). x and dout
// come already rolled by the caller, as in the JAX route; the mask (nW, N,
// N), when given, is in those rolled coordinates. From them and the weights
// it recomputes LN -> qkv -> per-head softmax P -> ctx, then returns dx and
// the float32 grads of the LN scale and bias, wqkv, bqkv, wproj, bproj and
// the (h, N, N) rel-pos bias. Rounding points as the JAX kernel: dout in
// bf16; dwproj = ctx^T dout, dbproj = sum dout; dctx = round(dout wproj^T)
// per head; ds = P*(dP - rowsum(dP*P)); dqkv in fp32 (dbqkv) and rounded
// (dwqkv = u^T round(dqkv), du = round(dqkv) wqkv^T); dx = LN^T(du * g)
// with no residual term (autograd adds the shortcut's). The plain version
// is ln_window_attention_bwd_reference in kernels/window_attention.py.
//
// What bounds it on Hopper: at batch 4 and C=768, ~3.3 GFLOP (3.4 us at
// the 989 TFLOP/s bf16 peak) against ~14 MB of bf16 weights and float32
// weight grads (4.2 us at 3.35 TB/s): the bytes, by a little.
//
// Design, first version: the attention half of the block backward
// (swin_block_bwd.cu) as its own fixed sequence of 19 launches over the
// B*H*W tokens in window-major order: the LN row kernels, the tiled wmma
// GEMM with the elementwise step in its epilogue (train_common.cuh), and
// the per-(head, window) attention kernels that recompute P on chip
// (attn_train.cuh). Weight grads sum over tokens in fixed chunks and then
// in a fixed order: no atomics, the same bits on every run. At the
// bottleneck's few tokens its launches are short of CTAs, not of bytes or
// operations. On the H100 its two attention kernels take 0.31 and 0.15 ms
// per call at batch 4 (one CTA per (head, window), 32 CTAs, scalar loops
// over the head's 96 channels), the whole call 0.64 ms at batch 2:
// tensor-core tiles and more CTAs per head are the next step.
#include "attn_train.cuh"

namespace sunet {

struct WmsaBwdArgs {
  const bf16 *x, *dout;
  const float *g, *be;
  const bf16* wqkv;
  const float* bqkv;
  const bf16* wproj;
  const float *bias, *mask;
  bf16* dx;
  float *dg, *db, *dwqkv, *dbqkv, *dwproj, *dbproj, *dbias;
  int B, H, W, C, ws, heads;
  float scale;
};

// The workspace: window-major token rows and the partials of the token
// reductions. With p == nullptr only measures.
struct WmsaBwdWork {
  bf16 *xw, *u, *qkv, *ctx, *doutw, *dctx, *dqkv_b;
  float *st, *dqkv, *du, *part;
  size_t bytes;
};

inline WmsaBwdWork carve_wmsa_bwd(unsigned char* p, int T, int C, int heads, int N) {
  Carve cv{p};
  WmsaBwdWork w;
  const size_t tc = (size_t)T * C;
  w.xw = cv.take<bf16>(tc);
  w.u = cv.take<bf16>(tc);
  w.qkv = cv.take<bf16>(3 * tc);
  w.ctx = cv.take<bf16>(tc);
  w.doutw = cv.take<bf16>(tc);
  w.dctx = cv.take<bf16>(tc);
  w.dqkv_b = cv.take<bf16>(3 * tc);
  w.st = cv.take<float>(2 * (size_t)T);
  w.dqkv = cv.take<float>(3 * tc);
  w.du = cv.take<float>(tc);
  // partials: the weight-grad splits, the column sums, the LN parameter
  // sums and the rel-pos bias chunks, the largest of them
  size_t part = (size_t)gemm_splits(C, C, T) * C * C;
  part = std::max(part, (size_t)gemm_splits(C, 3 * C, T) * 3 * C * C);
  part = std::max(part, (size_t)((T + kColRows - 1) / kColRows) * 3 * C);
  part = std::max(part, (size_t)ln_ctas(T) * 2 * C);
  part = std::max(part, (size_t)attn_chunks(T / N, heads) * heads * N * N);
  w.part = cv.take<float>(part);
  w.bytes = cv.used;
  return w;
}

cudaError_t ln_wmsa_bwd(const WmsaBwdArgs& a, const WmsaBwdWork& w, cudaStream_t st, int* n) {
  const int T = a.B * a.H * a.W, C = a.C, N = a.ws * a.ws;
  const int nW = (a.H / a.ws) * (a.W / a.ws);

  // ---- forward recompute (window-major rows; the caller rolled x)
  SUNET_TRY(ln_fwd(a.x, true, w.xw, w.u, w.st, a.g, a.be, T, C, a.H, a.W, a.ws, 0, st, n));
  SUNET_TRY((gemm<false, false>(w.u, C, a.wqkv, 3 * C, T, 3 * C, C, 1,
                                EpiBias{w.qkv, a.bqkv, 3 * C}, nullptr, st, n)));
  SUNET_TRY(attn_fwd(w.qkv, w.ctx, a.bias, a.mask, T, C, a.heads, N, nW, a.scale, st, n));

  // ---- projection, attention, qkv and LN backward
  SUNET_TRY(gather_rows(a.dout, w.doutw, T, C, a.H, a.W, a.ws, 0, st, n));
  SUNET_TRY(weight_grad(w.ctx, C, w.doutw, C, C, C, T, w.part, a.dwproj, st, n));
  SUNET_TRY(colsum(w.doutw, T, C, w.part, a.dbproj, st, n));
  SUNET_TRY((gemm<false, true>(w.doutw, C, a.wproj, C, T, C, C, 1, EpiBf16{w.dctx, C}, nullptr,
                               st, n)));
  SUNET_TRY(attn_bwd(w.qkv, w.dctx, a.bias, a.mask, w.dqkv, w.dqkv_b, w.part, a.dbias, T, C,
                     a.heads, N, nW, a.scale, st, n));
  SUNET_TRY(weight_grad(w.u, C, w.dqkv_b, 3 * C, C, 3 * C, T, w.part, a.dwqkv, st, n));
  SUNET_TRY(colsum(w.dqkv, T, 3 * C, w.part, a.dbqkv, st, n));
  SUNET_TRY((gemm<false, true>(w.dqkv_b, 3 * C, a.wqkv, 3 * C, T, C, 3 * C, 1,
                               EpiF32{w.du, C, 0}, nullptr, st, n)));
  SUNET_TRY(ln_bwd(w.du, w.xw, w.st, a.g, a.dx, w.part, T, C, a.H, a.W, a.ws, 0, st, n));
  return ln_param_grads(w.part, a.dg, a.db, T, C, st, n);
}

}  // namespace sunet

using namespace sunet;

extern "C" size_t sunet_ln_wmsa_bwd_workspace(int B, int H, int W, int C, int ws, int heads) {
  return carve_wmsa_bwd(nullptr, B * H * W, C, heads, ws * ws).bytes;
}

extern "C" int sunet_ln_wmsa_bwd(const void* x, const void* dout, const void* g, const void* be,
                                 const void* wqkv, const void* bqkv, const void* wproj,
                                 const void* bias, const void* mask, void* dx, void* dg,
                                 void* db, void* dwqkv, void* dbqkv, void* dwproj, void* dbproj,
                                 void* dbias, void* work, int B, int H, int W, int C, int ws,
                                 int heads, float scale, int* launches, void* stream) {
  const int N = ws * ws;
  if (N > 64 || C % 16 || C > kLnMaxC || C % heads || H % ws || W % ws)
    return (int)cudaErrorInvalidValue;
  WmsaBwdArgs a{(const bf16*)x,     (const bf16*)dout,  (const float*)g,     (const float*)be,
                (const bf16*)wqkv,  (const float*)bqkv, (const bf16*)wproj,  (const float*)bias,
                (const float*)mask, (bf16*)dx,          (float*)dg,          (float*)db,
                (float*)dwqkv,      (float*)dbqkv,      (float*)dwproj,      (float*)dbproj,
                (float*)dbias,      B,                  H,                   W,
                C,                  ws,                 heads,               scale};
  const WmsaBwdWork w = carve_wmsa_bwd((unsigned char*)work, B * H * W, C, heads, N);
  *launches = 0;
  return (int)ln_wmsa_bwd(a, w, (cudaStream_t)stream, launches);
}
