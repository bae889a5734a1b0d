// Backward of the LN + W-MSA + projection sublayer (no residual).
//
// Replaces sunet_tf_tpu/kernels/window_attention.py::_ln_wmsa_bwd_impl
// (its kernel _strip_bwd_kernel), the backward of
// ln_window_attention_trainable, on the blocks trained through the two
// sublayers (C=768 at the 8x8 bottleneck of the default model, and C <= 384
// blocks whose head dim the block kernels refuse, e.g. C=384 with 2 heads).
// x and dout come already rolled by the caller, as in the JAX route; the
// mask (nW, N, N), when given, is in those rolled coordinates. From them and
// the weights it recomputes LN -> qkv -> per-head softmax P -> ctx, then
// returns dx and the float32 grads of the LN scale and bias, wqkv, bqkv,
// wproj, bproj and the (h, N, N) rel-pos bias. Rounding points as the JAX
// kernel: dout in bf16; dwproj = ctx^T dout, dbproj = sum dout; dctx =
// round(dout wproj^T) per head; ds = P*(dP - rowsum(dP*P)); dqkv in fp32
// (dbqkv) and rounded (dwqkv = u^T round(dqkv), du = round(dqkv) wqkv^T); dx
// = round(LN^T(du * g)) with no residual term (autograd adds the
// shortcut's). The plain version is ln_window_attention_bwd_reference in
// kernels/window_attention.py.
//
// What bounds it on the H100: at C=768 the weights and their gradients,
// ~14 MB (bf16 wqkv and wproj in, float32 dwqkv and dwproj out: 4.2 us at
// 3.35 TB/s), against ~1.7 GFLOP per 128 tokens (1.7 us at the 989
// TFLOP/s bf16 peak); at the bottleneck's few tokens every launch is short,
// so the launches' ramps and the sequence's length count as much.
//
// Design: the attention half of the block backward (swin_block_bwd.cuh,
// the recompute form), on block_bwd_hopper.cuh's kernels, 7 launches over
// the B*H*W tokens in window-major order:
//   1. LN1 + qkv (shift 0: the caller rolled x; the LN in the A load, which
//      also writes LN1(x), the gathered x and the stats);
//   2. the attention forward, ctx = round(round(P) @ v);
//   3. dctx = round(dout wproj^T), dout gathered into window order in the A
//      load (the dm gather at scale 1, which also writes the gathered dout);
//   4. the attention backward on tensor cores, dqkv rounded, with the
//      rel-pos bias and qkv bias partials per chunk of windows;
//   5. dqkv wqkv^T and the LN1 backward on the ceil(C/128)-CTA cluster (6
//      at C=768): dx = round(LN1^T(du * g)) at the token's place in the map;
//   6. dwproj = ctx^T dout (with dout's column sums, dbproj) and dwqkv =
//      u^T round(dqkv) in one launch of token-chunk partials; with one
//      chunk (every shape of the default model) they are the gradients, so
//      the float32 weight gradients cross HBM once, not as partials and
//      again through the sums;
//   7. every partial summed in chunk order: the same bits on every run.
// The attention takes head dims up to what its shared memory holds (192 at
// N=64; kernels/window_attention.py::ln_wmsa_bwd_why).
#include "swin_block_bwd.cuh"

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

constexpr int kWmsaProducts = 2;   // dwproj, dwqkv

// The plan: the block backward's chunks over the two weight gradients.
inline BwdPlan wmsa_bwd_plan(int B, int H, int W, int C, int ws, int heads) {
  return bwd_chunks(B, H, W, ws, heads, bb::wg_tiles(C, C) + bb::wg_tiles(C, 3 * C));
}

// The workspace: window-major token rows and the partials of the token
// reductions; the weight gradients' partials only with more than one chunk
// (kernels/window_attention.py::ln_wmsa_bwd_workspace mirrors it). With
// p == nullptr only measures.
struct WmsaBwdWork {
  bf16 *xw, *u, *qkv, *ctx, *doutw, *dctxb, *dqkv;
  float *st, *pw[kWmsaProducts], *pbproj, *pln, *pqkv, *pbias;
  size_t bytes;
};

inline WmsaBwdWork carve_wmsa_bwd(unsigned char* p, int B, int H, int W, int C, int ws,
                                  int heads) {
  const BwdPlan pl = wmsa_bwd_plan(B, H, W, C, ws, heads);
  const int T = B * H * W, N = ws * ws;
  Carve cv{p};
  WmsaBwdWork w;
  const size_t tc = (size_t)T * C;
  w.xw = cv.take<bf16>(tc);
  w.u = cv.take<bf16>(tc);
  w.qkv = cv.take<bf16>(3 * tc);
  w.ctx = cv.take<bf16>(tc);
  w.doutw = cv.take<bf16>(tc);
  w.dctxb = cv.take<bf16>(tc);
  w.dqkv = cv.take<bf16>(3 * tc);
  w.st = cv.take<float>(2 * (size_t)T);
  const bool split = pl.nchunks > 1;
  w.pw[0] = split ? cv.take<float>((size_t)pl.nchunks * C * C) : nullptr;
  w.pw[1] = split ? cv.take<float>((size_t)pl.nchunks * C * 3 * C) : nullptr;
  w.pbproj = split ? cv.take<float>((size_t)pl.nchunks * C) : nullptr;
  w.pln = cv.take<float>((size_t)pl.rtiles * 2 * C);
  w.pqkv = cv.take<float>((size_t)pl.achunks * 3 * C);
  w.pbias = cv.take<float>((size_t)pl.achunks * heads * N * N);
  w.bytes = cv.used;
  return w;
}

cudaError_t ln_wmsa_bwd(const WmsaBwdArgs& a, const WmsaBwdWork& w, cudaStream_t st, int* n) {
  using namespace bb;
  const int T = a.B * a.H * a.W, C = a.C, N = a.ws * a.ws;
  const int nW = (a.H / a.ws) * (a.W / a.ws);
  const BwdPlan pl = wmsa_bwd_plan(a.B, a.H, a.W, C, a.ws, a.heads);
  TokArgs base;
  memset(&base, 0, sizeof(base));
  base.T = T;
  base.C = C;
  base.H = a.H;
  base.W = a.W;
  base.ws = a.ws;   // shift 0, no drop-path scales

  // ---- forward recompute
  {
    TokArgs t = base;
    t.K = C, t.N = 3 * C, t.src = a.x, t.lg = a.g, t.lb = a.be;
    t.side0 = w.u, t.side1 = w.xw, t.stats = w.st, t.bias = a.bqkv, t.ob = w.qkv;
    SUNET_TRY((tok_gemm<kALn1, false, kEQkv>(t, nullptr, a.wqkv, C, 3 * C, st, n)));
  }
  AttnArgs at;
  memset(&at, 0, sizeof(at));
  at.qkv = w.qkv;
  at.C = C, at.heads = a.heads, at.d = C / a.heads, at.N = N, at.nW = nW, at.nwin = T / N;
  at.scale = a.scale;
  at.bias = a.bias, at.mask = a.mask;
  {
    AttnArgs f = at;
    f.ctx = w.ctx, f.wpc = 1;
    SUNET_TRY(attn_tc<kAttnFwd>(f, st, n));
  }

  // ---- the projection's and the attention's backward
  {
    TokArgs t = base;
    t.K = C, t.N = C, t.src = a.dout, t.side0 = w.doutw, t.ob = w.dctxb;
    SUNET_TRY((tok_gemm<kADm, true, kEDctxB>(t, nullptr, a.wproj, C, C, st, n)));
  }
  at.dctxb = w.dctxb, at.dqkv = w.dqkv, at.pbias = w.pbias, at.pqkv = w.pqkv, at.wpc = pl.wpc;
  SUNET_TRY(attn_tc<kAttnBwd>(at, st, n));
  {
    TokArgs t = base;
    t.K = 3 * C, t.N = C, t.lg = a.g, t.stats = w.st, t.rows = w.xw, t.ob = a.dx;
    t.part = w.pln;
    SUNET_TRY((tok_gemm<kATma, true, kELn1NoRes>(t, w.dqkv, a.wqkv, C, 3 * C, st, n)));
  }

  // ---- the weight gradients: dwproj = ctx^T dout (and bproj's), dwqkv =
  // u^T dqkv; with one token chunk straight into the gradients
  const bool split = pl.nchunks > 1;
  {
    WgArgs g;
    WgMaps m;
    memset(&g, 0, sizeof(g));
    memset(&m, 0, sizeof(m));
    const bf16* xs[kWmsaProducts] = {w.ctx, w.u};
    const bf16* ds[kWmsaProducts] = {w.doutw, w.dqkv};
    const int ncols[kWmsaProducts] = {C, 3 * C};
    float* outs[kWmsaProducts] = {split ? w.pw[0] : a.dwproj, split ? w.pw[1] : a.dwqkv};
    float* pbs[kWmsaProducts] = {split ? w.pbproj : a.dbproj, nullptr};
    int first = 0;
    for (int i = 0; i < kWmsaProducts; ++i) {
      g.p[i] = WgProduct{C, ncols[i], (C + 63) / 64, first, outs[i], pbs[i]};
      first += wg_tiles(C, ncols[i]) * pl.nchunks;
      SUNET_TRY(hop::weight_map(&m.x[i], xs[i], T, C, 64));
      SUNET_TRY(hop::weight_map(&m.d[i], ds[i], T, ncols[i], 64));
    }
    g.np = kWmsaProducts, g.T = T, g.chunk = pl.chunk, g.nchunks = pl.nchunks;
    SUNET_TRY(hop::launch_cluster(wgrad_kernel, dim3(first), kThr, wgrad_smem(), st, 1, g, m));
    SUNET_TRY(launched(n));
  }

  // ---- every partial, summed in order
  SumArgs s;
  memset(&s, 0, sizeof(s));
  const long long hn = (long long)a.heads * N * N;
  SumSeg segs[kSumSegs];
  int ns = 0;
  if (split) {
    segs[ns++] = {w.pw[0], a.dwproj, pl.nchunks, C * C, (long long)C * C};
    segs[ns++] = {w.pw[1], a.dwqkv, pl.nchunks, 3 * C * C, 3LL * C * C};
    segs[ns++] = {w.pbproj, a.dbproj, pl.nchunks, C, C};
  }
  segs[ns++] = {w.pqkv, a.dbqkv, pl.achunks, 3 * C, 3 * C};
  segs[ns++] = {w.pln, a.dg, pl.rtiles, C, 2 * C};
  segs[ns++] = {w.pln + C, a.db, pl.rtiles, C, 2 * C};
  segs[ns++] = {w.pbias, a.dbias, pl.achunks, (int)hn, hn};
  for (int i = 0; i < ns; ++i) {
    s.s[i] = segs[i];
    s.total[segs[i].S >= kSumWarpS] += segs[i].L;
  }
  const long long blocks = std::max((s.total[0] + kThr - 1) / kThr,
                                    (s.total[1] + kThr / 32 - 1) / (kThr / 32));
  sum_kernel<<<(int)std::min<long long>(std::max(blocks, 1LL), 2048), kThr, 0, st>>>(s);
  return launched(n);
}

}  // namespace sunet

using namespace sunet;

extern "C" size_t sunet_ln_wmsa_bwd_workspace(int B, int H, int W, int C, int ws, int heads) {
  return carve_wmsa_bwd(nullptr, B, H, W, C, ws, heads).bytes;
}

// x, dout, LN g/b, wqkv, bqkv, wproj, rel-pos bias, mask or NULL; dx and the
// seven grads; the workspace; the shape, scale; the launch count. A shape
// outside the design (ln_wmsa_bwd_why) is refused.
extern "C" int sunet_ln_wmsa_bwd(const void* x, const void* dout, const void* g, const void* be,
                                 const void* wqkv, const void* bqkv, const void* wproj,
                                 const void* bias, const void* mask, void* dx, void* dg,
                                 void* db, void* dwqkv, void* dbqkv, void* dwproj, void* dbproj,
                                 void* dbias, void* work, int B, int H, int W, int C, int ws,
                                 int heads, float scale, int* launches, void* stream) {
  const int N = ws * ws;
  if (ws <= 0 || N % 16 || N > 64 || C % 16 || C > 768 || heads <= 0 || C % heads ||
      (C / heads) % 2 || H % ws || W % ws)
    return (int)cudaErrorInvalidValue;
  if (bb::attn_layout(N, (C / heads + 15) & ~15).bytes > kMaxSmem)
    return (int)cudaErrorInvalidConfiguration;
  WmsaBwdArgs a{(const bf16*)x,     (const bf16*)dout,  (const float*)g,     (const float*)be,
                (const bf16*)wqkv,  (const float*)bqkv, (const bf16*)wproj,  (const float*)bias,
                (const float*)mask, (bf16*)dx,          (float*)dg,          (float*)db,
                (float*)dwqkv,      (float*)dbqkv,      (float*)dwproj,      (float*)dbproj,
                (float*)dbias,      B,                  H,                   W,
                C,                  ws,                 heads,               scale};
  const WmsaBwdWork w = carve_wmsa_bwd((unsigned char*)work, B, H, W, C, ws, heads);
  *launches = 0;
  return (int)ln_wmsa_bwd(a, w, (cudaStream_t)stream, launches);
}
