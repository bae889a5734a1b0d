// The whole Swin block's backward as a fixed sequence of launches, shared
// by the recompute form (swin_block_bwd.cu, kRes unset: 11 launches) and
// the residual route (swin_block_bwd_res.cu, kRes set: 10 launches); the
// kernels are in block_bwd_hopper.cuh, and the sources' notes say what each
// form replaces. The LN+W-MSA backward (ln_wmsa_bwd.cu, #12) runs the
// attention half of the same sequence on the same plan's chunks.
//
// What bounds it on the H100: the products. The forward recompute and the
// backward are ~5.4 GFLOP at (64,64,96) batch 2 (5.5 us at the 989 TFLOP/s
// bf16 peak) against ~20 MB of activations, intermediates and weights
// (6 us at 3.35 TB/s); every launch is short, so the sequence's length and
// each launch's ramp count as much as either.
//
// Design: every token-row product on the wgmma + TMA mainloop, with its
// elementwise step, its LayerNorm (forward in the A load, backward in the
// epilogue) and its gather in the same launch:
//   1. LN1 + qkv (the LN of x gathered in window order in the A load; the
//      first column tile also writes LN1(x), the gathered x and the stats);
//   2. (recompute form) the attention forward, ctx = round(round(P) @ v);
//   3. proj + residual: y = round(x + s1 (ctx wproj + bproj)); on the
//      residual route A = round(ctx_f), also written as ctx;
//   4. LN2 + fc1: a = yn w1 + b1 (fp32) and round(gelu(a));
//   5. dm w2^T, dm = round(s2 dout) gathered in the A load: da = .. gelu'(a),
//      round(da), and da's column partials (b1's gradient);
//   6. dab w1^T and the LN2 backward on a cluster of ceil(C/128) CTAs per
//      64 rows: dy = dout + LN2^T(..), dattn = round(s1 dy);
//   7. dattn wproj^T: dctx, rounded (recompute form) or fp32 (residual);
//   8. the attention backward on tensor cores, dqkv rounded, with the
//      rel-pos bias and qkv bias partials;
//   9. dqkv wqkv^T and the LN1 backward (cluster as 6): dx = round(dy +
//      LN1^T(..)) at the token's place in the map;
//  10. the four weight gradients in one launch, in token chunks, with the
//      column sums of dm and dattn (b2's and bproj's gradients);
//  11. every partial summed in chunk order.
// Windows above 64 tokens (kBig, swin_block_bwd.cu's big entry) take
// block_bwd_big.cuh's attention: the forward recompute writes each row's
// softmax statistics beside ctx (launch 2), and the backward is two
// launches, dq (with D = rowsum(P dP) and the rel-pos bias partials) and
// dk/dv (12 launches); the rows are C wide with cr real channels (C the
// real width rounded up to 16, zeros past cr: the LayerNorms' statistics
// run over cr, ctx's and dqkv's pad columns are cleared first).
// The SW roll is load/store addressing (token_offset) on x, dout and dx.
// The sums are in fixed order: the same bits on every run. Chunks and plans
// are functions of one image's shape (kernels/window_attention.py::
// block_bwd_plan mirrors them). On the H100 (700 W) a batch-2 call takes
// 0.19-0.28 ms of device time at the default model's widths (35 launches
// took 0.41-0.64 ms); the attention, the A loads the CTAs compute and the
// LN epilogues hold most of it (`python -m
// sunet_tf_tpu_torch.tools.bwd_launches`, PERF.md).
#pragma once

#include "block_bwd_big.cuh"

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
  // the big-window form (kBig): the real channels of the C-wide rows
  int cr = 0;
};

// Whether the kernels take the shape: windows of N = ws^2 <= 64 tokens, N
// a multiple of 16; C a multiple of 16 up to 768 (a cluster of at most 6
// CTAs owns a row); head dim even; hidden a multiple of 16. The head dim:
// on the residual route (res) at most 64 (its per-pair t sums hold 32
// column pairs); in the recompute form whatever the attention's operands
// fit in shared memory (attn_layout: 192 at N = 64), as ln_wmsa_bwd.cu's.
inline bool bwd_takes(int H, int W, int C, int hidden, int ws, int heads, bool res) {
  const int N = ws * ws;
  if (!(ws > 0 && N <= 64 && N % 16 == 0 && C % 16 == 0 && C <= 768 && heads > 0 &&
        C % heads == 0 && (C / heads) % 2 == 0 && hidden % 16 == 0 && hidden > 0 &&
        H % ws == 0 && W % ws == 0))
    return false;
  const int d = C / heads;
  return res ? d <= 64 : bb::attn_layout(N, (d + 15) & ~15).bytes <= kMaxSmem;
}

// The big-window form: N a multiple of 64 above 64 up to bb::kBigMaxTok; C
// (the rows' width) a multiple of 16 up to 768 holding cr real channels (C
// - 16 < cr <= C); the head dim cr / heads even and at most bb::kBigMaxD;
// the attention's launches within shared memory.
inline bool bwd_big_takes(int H, int W, int C, int cr, int hidden, int ws, int heads) {
  const int N = ws * ws;
  if (ws <= 0 || N <= 64 || N % 64 || N > bb::kBigMaxTok || C % 16 || C > 768 || cr > C ||
      cr <= C - 16 || heads <= 0 || cr % heads || hidden % 16 || hidden <= 0 || H % ws ||
      W % ws)
    return false;
  const int d = cr / heads, dp = (d + 15) & ~15;
  return d % 2 == 0 && d <= bb::kBigMaxD && bb::big_dq_smem(N, dp) <= kMaxSmem &&
         bb::big_dkv_smem(N, dp) <= kMaxSmem && bb::big_fwd_smem(N, dp) <= kMaxSmem;
}

// The plan (kernels/window_attention.py::block_bwd_plan): tokens per chunk
// of the weight-gradient launch (~kFillCtas CTAs) and windows per chunk of
// the attention (~kAttnFillCtas CTAs), at kPlanBatch images of this shape.
struct BwdPlan {
  int chunk, nchunks;   // weight gradients: tokens per chunk (a multiple of 64), chunks
  int wpc, achunks;     // attention: windows per chunk, chunks
  int rtiles;           // 64-row tiles
  int nq;               // 64-row blocks of a window in the big form (1 up to 64 tokens)
};

// The chunks of a plan whose weight-gradient launch has `tiles` 64 x 128
// output tiles (kernels/window_attention.py::_bwd_chunks mirrors them).
inline BwdPlan bwd_chunks(int B, int H, int W, int ws, int heads, int tiles) {
  const int hw = H * W, T = B * hw, nW = (H / ws) * (W / ws);
  const int per = std::max(1, (bb::kFillCtas + tiles - 1) / tiles);
  BwdPlan p;
  p.chunk = 64 * (((bb::kPlanBatch * hw + 63) / 64 + per - 1) / per);
  p.nchunks = (T + p.chunk - 1) / p.chunk;
  p.nq = ws * ws > 64 ? ws * ws / 64 : 1;   // the big form's CTAs per (window, head)
  const int achunks_plan = std::max(1, bb::kAttnFillCtas / (heads * p.nq));
  p.wpc = (bb::kPlanBatch * nW + achunks_plan - 1) / achunks_plan;
  p.achunks = (B * nW + p.wpc - 1) / p.wpc;
  p.rtiles = (T + 63) / 64;
  return p;
}

inline BwdPlan bwd_plan(int B, int H, int W, int C, int hidden, int ws, int heads) {
  return bwd_chunks(B, H, W, ws, heads,
                    bb::wg_tiles(hidden, C) + bb::wg_tiles(C, hidden) + bb::wg_tiles(C, C) +
                        bb::wg_tiles(C, 3 * C));
}

// The workspace: per-token intermediates and the partials of the
// reductions. With p == nullptr only measures.
struct BwdWork {
  bf16 *xw, *u, *qkv, *ctx, *y, *yn, *h1, *dm, *dab, *dattn, *dctxb, *dqkv;
  float *st1, *st2, *a, *dy, *dctxf;
  float *rmax, *rinv, *dsum;   // the big form's softmax statistics and D
  float *pw[bb::kWgProducts], *pb2, *pbproj, *pb1, *pln2, *pln1, *pqkv, *pbias;
  size_t bytes;
};

inline BwdWork carve_bwd(unsigned char* p, int B, int H, int W, int C, int hidden, int ws,
                         int heads, bool res, bool big = false) {
  const BwdPlan pl = bwd_plan(B, H, W, C, hidden, ws, heads);
  const int T = B * H * W, N = ws * ws;
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
  w.dctxb = res ? nullptr : cv.take<bf16>(tc);
  w.dqkv = cv.take<bf16>(3 * tc);
  w.st1 = cv.take<float>(2 * (size_t)T);
  w.st2 = cv.take<float>(2 * (size_t)T);
  w.a = cv.take<float>(th);
  w.dy = cv.take<float>(tc);
  w.dctxf = res ? cv.take<float>(tc) : nullptr;
  const size_t th_n = (size_t)T * heads;   // one value per (window, head, row)
  w.rmax = big ? cv.take<float>(th_n) : nullptr;
  w.rinv = big ? cv.take<float>(th_n) : nullptr;
  w.dsum = big ? cv.take<float>(th_n) : nullptr;
  const int mn[bb::kWgProducts][2] = {{hidden, C}, {C, hidden}, {C, C}, {C, 3 * C}};
  for (int i = 0; i < bb::kWgProducts; ++i)
    w.pw[i] = cv.take<float>((size_t)pl.nchunks * mn[i][0] * mn[i][1]);
  w.pb2 = cv.take<float>((size_t)pl.nchunks * C);
  w.pbproj = cv.take<float>((size_t)pl.nchunks * C);
  w.pb1 = cv.take<float>((size_t)pl.rtiles * hidden);
  w.pln2 = cv.take<float>((size_t)pl.rtiles * 2 * C);
  w.pln1 = cv.take<float>((size_t)pl.rtiles * 2 * C);
  w.pqkv = cv.take<float>((size_t)pl.achunks * pl.nq * 3 * C);
  w.pbias = cv.take<float>((size_t)pl.achunks * heads * N * N);
  w.bytes = cv.used;
  return w;
}

// The launch sequence. kRes: the residual route (swin_block_bwd_res.cu):
// ctx = round(ctx_f) in proj's A load in place of the attention recompute,
// dctx kept in fp32, and the attention backward from the stored state.
template <bool kRes, bool kBig = false>
cudaError_t block_bwd(const BwdArgs& a, const BwdWork& w, cudaStream_t st, int* n) {
  static_assert(!(kRes && kBig), "the big-window form is the recompute form's");
  using namespace bb;
  const int T = a.B * a.H * a.W, C = a.C, Hd = a.hidden, N = a.ws * a.ws;
  const int nW = (a.H / a.ws) * (a.W / a.ws);
  const BwdPlan pl = bwd_plan(a.B, a.H, a.W, C, Hd, a.ws, a.heads);
  TokArgs base;
  memset(&base, 0, sizeof(base));
  base.T = T;
  base.C = C;
  base.H = a.H;
  base.W = a.W;
  base.ws = a.ws;
  base.shift = a.shift;
  base.dp = a.dp;
  base.cr = a.cr;

  // ---- forward recompute
  {
    TokArgs t = base;
    t.K = C, t.N = 3 * C, t.src = a.x, t.lg = a.g1, t.lb = a.be1;
    t.side0 = w.u, t.side1 = w.xw, t.stats = w.st1, t.bias = a.bqkv, t.ob = w.qkv;
    SUNET_TRY((tok_gemm<kALn1, false, kEQkv, kBig>(t, nullptr, a.wqkv, C, 3 * C, st, n)));
  }
  bb::BigAttnArgs ba;   // the big form's attention
  memset(&ba, 0, sizeof(ba));
  ba.qkv = w.qkv, ba.dctxb = w.dctxb, ba.bias = a.bias, ba.mask = a.mask, ba.ctx = w.ctx;
  ba.dqkv = w.dqkv, ba.rmax = w.rmax, ba.rinv = w.rinv, ba.dsum = w.dsum, ba.pbias = w.pbias;
  ba.pqkv = w.pqkv, ba.C = C, ba.heads = a.heads, ba.d = a.cr / a.heads, ba.N = N, ba.nW = nW;
  ba.nwin = T / N, ba.wpc = pl.wpc, ba.scale = a.scale;
  AttnArgs at;
  memset(&at, 0, sizeof(at));
  at.qkv = w.qkv;
  at.C = C, at.heads = a.heads, at.d = C / a.heads, at.N = N, at.nW = nW, at.nwin = T / N;
  at.scale = a.scale;
  at.bias = a.bias, at.mask = a.mask;
  if constexpr (kBig) {
    if (a.cr != C) SUNET_TRY(cudaMemsetAsync(w.ctx, 0, (size_t)T * C * sizeof(bf16), st));
    SUNET_TRY(attn_big_fwd(ba, st, n));
  } else if constexpr (!kRes) {
    AttnArgs f = at;
    f.ctx = w.ctx, f.wpc = 1;
    SUNET_TRY(attn_tc<kAttnFwd>(f, st, n));
  }
  {
    TokArgs t = base;
    t.K = C, t.N = C, t.bias = a.bproj, t.rows = w.xw, t.ob = w.y;
    if constexpr (kRes) {
      t.srcf = a.ctxf, t.side0 = w.ctx;
      SUNET_TRY((tok_gemm<kARound, false, kEProj>(t, nullptr, a.wproj, C, C, st, n)));
    } else {
      SUNET_TRY((tok_gemm<kATma, false, kEProj>(t, w.ctx, a.wproj, C, C, st, n)));
    }
  }
  {
    TokArgs t = base;
    t.K = C, t.N = Hd, t.src = w.y, t.lg = a.g2, t.lb = a.be2, t.side0 = w.yn, t.stats = w.st2;
    t.bias = a.b1, t.of = w.a, t.ob = w.h1;
    SUNET_TRY((tok_gemm<kALn2, false, kEFc1, kBig>(t, nullptr, a.w1, C, Hd, st, n)));
  }

  // ---- MLP sublayer
  {
    TokArgs t = base;
    t.K = C, t.N = Hd, t.src = a.dout, t.side0 = w.dm, t.aux = w.a, t.ob = w.dab, t.part = w.pb1;
    SUNET_TRY((tok_gemm<kADm, true, kEDa>(t, nullptr, a.w2, Hd, C, st, n)));
  }
  {
    TokArgs t = base;
    t.K = Hd, t.N = C, t.lg = a.g2, t.stats = w.st2, t.rows = w.y, t.dout = a.dout;
    t.of = w.dy, t.ob = w.dattn, t.part = w.pln2;
    SUNET_TRY((tok_gemm<kATma, true, kELn2, kBig>(t, w.dab, a.w1, C, Hd, st, n)));
  }

  // ---- attention sublayer
  {
    TokArgs t = base;
    t.K = C, t.N = C;
    if constexpr (kRes) {
      t.of = w.dctxf;
      SUNET_TRY((tok_gemm<kATma, true, kEDctxF>(t, w.dattn, a.wproj, C, C, st, n)));
    } else {
      t.ob = w.dctxb;
      SUNET_TRY((tok_gemm<kATma, true, kEDctxB>(t, w.dattn, a.wproj, C, C, st, n)));
    }
  }
  at.dqkv = w.dqkv, at.pbias = w.pbias, at.pqkv = w.pqkv, at.wpc = pl.wpc;
  if constexpr (kBig) {
    if (a.cr != C) SUNET_TRY(cudaMemsetAsync(w.dqkv, 0, (size_t)T * 3 * C * sizeof(bf16), st));
    SUNET_TRY(attn_big_bwd(ba, st, n));
  } else if constexpr (kRes) {
    at.dctxf = w.dctxf, at.eb = a.eb, at.rden = a.rden, at.ctxf = a.ctxf;
    SUNET_TRY(attn_tc<kAttnBwdRes>(at, st, n));
  } else {
    at.dctxb = w.dctxb;
    SUNET_TRY(attn_tc<kAttnBwd>(at, st, n));
  }
  {
    TokArgs t = base;
    t.K = 3 * C, t.N = C, t.lg = a.g1, t.stats = w.st1, t.rows = w.xw, t.aux = w.dy;
    t.ob = a.dx, t.part = w.pln1;
    SUNET_TRY((tok_gemm<kATma, true, kELn1, kBig>(t, w.dqkv, a.wqkv, C, 3 * C, st, n)));
  }

  // ---- the weight gradients: dw2 = h1^T dm (and b2's), dw1 = yn^T dab,
  // dwproj = ctx^T dattn (and bproj's), dwqkv = u^T dqkv
  {
    WgArgs g;
    WgMaps m;
    const bf16* xs[kWgProducts] = {w.h1, w.yn, w.ctx, w.u};
    const bf16* ds[kWgProducts] = {w.dm, w.dab, w.dattn, w.dqkv};
    const int mn[kWgProducts][2] = {{Hd, C}, {C, Hd}, {C, C}, {C, 3 * C}};
    float* pbs[kWgProducts] = {w.pb2, nullptr, w.pbproj, nullptr};
    int first = 0;
    for (int i = 0; i < kWgProducts; ++i) {
      g.p[i] = WgProduct{mn[i][0], mn[i][1], (mn[i][0] + 63) / 64, first, w.pw[i], pbs[i]};
      first += wg_tiles(mn[i][0], mn[i][1]) * pl.nchunks;
      SUNET_TRY(hop::weight_map(&m.x[i], xs[i], T, mn[i][0], 64));
      SUNET_TRY(hop::weight_map(&m.d[i], ds[i], T, mn[i][1], 64));
    }
    g.np = kWgProducts, g.T = T, g.chunk = pl.chunk, g.nchunks = pl.nchunks;
    SUNET_TRY(hop::launch_cluster(wgrad_kernel, dim3(first), kThr, wgrad_smem(), st, 1, g, m));
    SUNET_TRY(launched(n));
  }

  // ---- every partial, summed in order
  SumArgs s;
  memset(&s, 0, sizeof(s));
  const long long hn = (long long)a.heads * N * N;
  const SumSeg segs[kSumSegs] = {
      {w.pw[0], a.dw2, pl.nchunks, Hd * C, (long long)Hd * C},
      {w.pw[1], a.dw1, pl.nchunks, C * Hd, (long long)C * Hd},
      {w.pw[2], a.dwproj, pl.nchunks, C * C, (long long)C * C},
      {w.pw[3], a.dwqkv, pl.nchunks, 3 * C * C, 3LL * C * C},
      {w.pb2, a.dbm2, pl.nchunks, C, C},
      {w.pbproj, a.dbproj, pl.nchunks, C, C},
      {w.pb1, a.dbm1, pl.rtiles, Hd, Hd},
      {w.pqkv, a.dbqkv, pl.achunks * pl.nq, 3 * C, 3 * C},
      {w.pln2, a.dg2, pl.rtiles, C, 2 * C},
      {w.pln2 + C, a.db2, pl.rtiles, C, 2 * C},
      {w.pln1, a.dg1, pl.rtiles, C, 2 * C},
      {w.pln1 + C, a.db1, pl.rtiles, C, 2 * C},
      {w.pbias, a.dbias, pl.achunks, (int)hn, hn}};
  s.total[0] = s.total[1] = 0;
  for (int i = 0; i < kSumSegs; ++i) {
    s.s[i] = segs[i];
    s.total[segs[i].S >= kSumWarpS] += segs[i].L;
  }
  const long long blocks = std::max((s.total[0] + kThr - 1) / kThr,
                                    (s.total[1] + kThr / 32 - 1) / (kThr / 32));
  sum_kernel<<<(int)std::min<long long>(blocks, 2048), kThr, 0, st>>>(s);
  return launched(n);
}

}  // namespace sunet
