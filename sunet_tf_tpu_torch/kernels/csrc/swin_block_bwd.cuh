// The whole Swin block's backward as a fixed sequence of launches, shared
// by the recompute form (swin_block_bwd.cu, kRes unset) and the residual
// route (swin_block_bwd_res.cu, kRes set); the sources' notes say what each
// replaces and how it is built.
#pragma once

#include "attn_train.cuh"

namespace sunet {

struct BwdArgs {
  const bf16 *x, *dout;
  const float *g1, *be1;
  const bf16* wqkv;
  const float* bqkv;
  const bf16* wproj;
  const float* bproj;
  const float *g2, *be2;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float *b2, *bias, *mask, *dp;
  bf16* dx;
  float *dg1, *db1, *dwqkv, *dbqkv, *dwproj, *dbproj, *dg2, *db2, *dw1, *dbm1, *dw2, *dbm2,
      *dbias;
  int B, H, W, C, hidden, ws, heads, shift;
  float scale;
  // the residual route (kRes): the forward's eb, rden and ctx_f (null in
  // the recompute form)
  const bf16* eb = nullptr;
  const float *rden = nullptr, *ctxf = nullptr;
};

// y = round(x + s1[b] * (acc + bproj)): the attention branch's residual.
struct EpiResid {
  bf16* y;
  const bf16* x;
  const float *bproj, *dp;
  int C, hw;
  __device__ float operator()(int m, int n, float v, int) const {
    const size_t e = (size_t)m * C + n;
    y[e] = tobf(bf(x[e]) + dp[2 * (m / hw)] * (v + bproj[n]));
    return 0.f;
  }
};

// The workspace: per-token intermediates and the partials of the token
// reductions. With p == nullptr only measures.
struct BwdWork {
  bf16 *xw, *u, *qkv, *ctx, *y, *yn, *h1, *dm, *dab, *dattn, *dctx, *dqkv_b;
  float *st1, *st2, *a, *da, *dyn, *dy, *dqkv, *du, *dctxf, *part;
  size_t bytes;
};

// res: the residual route's workspace (dctx in fp32 instead of bf16).
inline BwdWork carve_bwd(unsigned char* p, int T, int C, int hidden, int heads, int N,
                         bool res) {
  Carve cv{p};
  BwdWork w;
  const size_t tc = (size_t)T * C, th = (size_t)T * hidden;
  w.xw = cv.take<bf16>(tc);
  w.u = cv.take<bf16>(tc);
  w.qkv = cv.take<bf16>(3 * tc);
  w.ctx = cv.take<bf16>(tc);
  w.y = cv.take<bf16>(tc);
  w.yn = cv.take<bf16>(tc);
  w.h1 = cv.take<bf16>(th);
  w.dm = cv.take<bf16>(tc);
  w.dab = cv.take<bf16>(th);
  w.dattn = cv.take<bf16>(tc);
  w.dctx = res ? nullptr : cv.take<bf16>(tc);
  w.dqkv_b = cv.take<bf16>(3 * tc);
  w.st1 = cv.take<float>(2 * (size_t)T);
  w.st2 = cv.take<float>(2 * (size_t)T);
  w.a = cv.take<float>(th);
  w.da = cv.take<float>(th);
  w.dyn = cv.take<float>(tc);
  w.dy = cv.take<float>(tc);
  w.dqkv = cv.take<float>(3 * tc);
  w.du = cv.take<float>(tc);
  w.dctxf = res ? cv.take<float>(tc) : nullptr;
  // partials: the largest of the weight-grad splits, the column sums, the
  // LN parameter sums and the rel-pos bias chunks
  size_t part = 0;
  const int dims[4][2] = {{hidden, C}, {C, hidden}, {C, C}, {C, 3 * C}};
  for (auto& mn : dims)
    part = std::max(part, (size_t)gemm_splits(mn[0], mn[1], T) * mn[0] * mn[1]);
  part = std::max(part, (size_t)((T + kColRows - 1) / kColRows) * 3 * C);
  part = std::max(part, (size_t)std::max(hidden, 3 * C) * ((T + kColRows - 1) / kColRows));
  part = std::max(part, (size_t)ln_ctas(T) * 2 * C);
  const int nwin = T / N;
  part = std::max(part, (size_t)attn_chunks(nwin, heads) * heads * N * N);
  w.part = cv.take<float>(part);
  w.bytes = cv.used;
  return w;
}

// The launch sequence. kRes: the residual route (swin_block_bwd_res.cu):
// ctx = round(ctx_f) in place of the attention recompute, dctx kept in fp32,
// and the attention backward from the stored state.
template <bool kRes>
cudaError_t block_bwd(const BwdArgs& a, const BwdWork& w, cudaStream_t st, int* n) {
  const int T = a.B * a.H * a.W, C = a.C, Hd = a.hidden, N = a.ws * a.ws;
  const int nW = (a.H / a.ws) * (a.W / a.ws), hw = a.H * a.W;

  // ---- forward recompute
  SUNET_TRY(ln_fwd(a.x, true, w.xw, w.u, w.st1, a.g1, a.be1, T, C, a.H, a.W, a.ws, a.shift, st,
                   n));
  SUNET_TRY((gemm<false, false>(w.u, C, a.wqkv, 3 * C, T, 3 * C, C, 1,
                                EpiBias{w.qkv, a.bqkv, 3 * C}, nullptr, st, n)));
  if constexpr (kRes)
    SUNET_TRY(round_rows(a.ctxf, w.ctx, (size_t)T * C, st, n));
  else
    SUNET_TRY(attn_fwd(w.qkv, w.ctx, a.bias, a.mask, T, C, a.heads, N, nW, a.scale, st, n));
  SUNET_TRY((gemm<false, false>(w.ctx, C, a.wproj, C, T, C, C, 1,
                                EpiResid{w.y, w.xw, a.bproj, a.dp, C, hw}, nullptr, st, n)));
  SUNET_TRY(ln_fwd(w.y, false, nullptr, w.yn, w.st2, a.g2, a.be2, T, C, a.H, a.W, a.ws, a.shift,
                   st, n));
  SUNET_TRY((gemm<false, false>(w.yn, C, a.w1, Hd, T, Hd, C, 1, EpiFc1{w.a, w.h1, a.b1, Hd},
                                nullptr, st, n)));

  // ---- MLP sublayer
  SUNET_TRY(gather_rows(a.dout, a.dp, w.dm, T, C, a.H, a.W, a.ws, a.shift, st, n));
  SUNET_TRY(weight_grad(w.h1, Hd, w.dm, C, Hd, C, T, w.part, a.dw2, st, n));
  SUNET_TRY(colsum(w.dm, T, C, w.part, a.dbm2, st, n));
  SUNET_TRY((gemm<false, true>(w.dm, C, a.w2, C, T, Hd, C, 1, EpiDa{w.da, w.dab, w.a, Hd},
                               nullptr, st, n)));
  SUNET_TRY(weight_grad(w.yn, C, w.dab, Hd, C, Hd, T, w.part, a.dw1, st, n));
  SUNET_TRY(colsum(w.da, T, Hd, w.part, a.dbm1, st, n));
  SUNET_TRY((gemm<false, true>(w.dab, Hd, a.w1, Hd, T, C, Hd, 1, EpiF32{w.dyn, C, 0}, nullptr,
                               st, n)));
  SUNET_TRY(ln_bwd<true>(w.dyn, w.y, w.st2, a.g2, a.dout, nullptr, a.dp, w.dy, w.dattn, nullptr,
                         w.part, T, C, a.H, a.W, a.ws, a.shift, st, n));
  SUNET_TRY(ln_param_grads(w.part, a.dg2, a.db2, T, C, st, n));

  // ---- attention sublayer
  SUNET_TRY(weight_grad(w.ctx, C, w.dattn, C, C, C, T, w.part, a.dwproj, st, n));
  SUNET_TRY(colsum(w.dattn, T, C, w.part, a.dbproj, st, n));
  if constexpr (kRes) {
    SUNET_TRY((gemm<false, true>(w.dattn, C, a.wproj, C, T, C, C, 1, EpiF32{w.dctxf, C, 0},
                                 nullptr, st, n)));
    SUNET_TRY(attn_bwd_res(w.qkv, w.dctxf, a.eb, a.rden, a.ctxf, w.dqkv, w.dqkv_b, w.part,
                           a.dbias, T, C, a.heads, N, a.scale, st, n));
  } else {
    SUNET_TRY((gemm<false, true>(w.dattn, C, a.wproj, C, T, C, C, 1, EpiBf16{w.dctx, C},
                                 nullptr, st, n)));
    SUNET_TRY(attn_bwd(w.qkv, w.dctx, a.bias, a.mask, w.dqkv, w.dqkv_b, w.part, a.dbias, T, C,
                       a.heads, N, nW, a.scale, st, n));
  }
  SUNET_TRY(weight_grad(w.u, C, w.dqkv_b, 3 * C, C, 3 * C, T, w.part, a.dwqkv, st, n));
  SUNET_TRY(colsum(w.dqkv, T, 3 * C, w.part, a.dbqkv, st, n));
  SUNET_TRY((gemm<false, true>(w.dqkv_b, 3 * C, a.wqkv, 3 * C, T, C, 3 * C, 1,
                               EpiF32{w.du, C, 0}, nullptr, st, n)));
  SUNET_TRY(ln_bwd<false>(w.du, w.xw, w.st1, a.g1, nullptr, w.dy, nullptr, nullptr, nullptr, a.dx,
                          w.part, T, C, a.H, a.W, a.ws, a.shift, st, n));
  return ln_param_grads(w.part, a.dg1, a.db1, T, C, st, n);
}

}  // namespace sunet
