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
// What bounds it on Hopper: at batch 4 (T = 256 rows), 10*T*C*hidden = 6.0
// GFLOP (6.1 us at the bf16 peak) against ~28 MB of bf16 weights and
// float32 weight grads (8.5 us at 3.35 TB/s): the bytes. At the
// bottleneck's few rows every launch is short, so the sequence's length and
// each launch's CTA count matter as much.
//
// Design: the MLP half of the block backward (swin_block_bwd.cuh, steps
// 4-6 and 10-11) on block_bwd_hopper.cuh's kernels, 5 launches over the
// token rows in the map's own order: the geometry handed to the token GEMMs
// is a window of one token and no shift, so token_offset is the identity
// and every launch (the LN A load, the dout A load, the LN backward) reads
// and writes row t at row t.
//   1. LN2 + fc1 (tok_gemm kALn2 / kEFc1): a = yn w1 + b1 (fp32) and
//      round(gelu(a)); column tile 0 also writes yn and the LN statistics.
//   2. dm w2^T with dm = round(dout) (kADm at scale 1 / kEDa): da, round(da)
//      and b1's per-row-tile column partials; column tile 0 writes dm.
//   3. dyn = dab w1^T split over K: the ks CTAs of one 64 x 128 output tile
//      form a cluster, each over hidden/ks of K (one output tile over K =
//      3072 would leave 24 CTAs at batch 4); their fp32 tiles meet in
//      distributed shared memory and are summed in rank order into dyn.
//   4. one launch of two kinds of CTAs: the weight gradients dw2 = h1^T dm
//      (with dm's column sums, b2's gradient) and dw1 = yn^T dab as
//      token-chunk partials (bb::wgrad_cta; with one chunk straight into
//      the gradients), and the LN backward, one warp per row: dy =
//      round(inv (dyn g - mean(dyn g) - xhat mean(dyn g xhat))), with each
//      CTA's 8-row partials of dg = sum dyn xhat and db = sum dyn.
//   5. every partial summed in a fixed order (bb::sum_kernel).
// Plans are functions of one image's shape (kernels/window_attention.py::
// ln_mlp_bwd_plan mirrors mlp_bwd_plan); no sum uses atomics.
#include "block_bwd_hopper.cuh"

namespace sunet {

constexpr int kMlpKsMax = 8;       // the K split's cluster: portable cluster size
constexpr int kMlpLnRows = 8;      // LN backward rows per CTA (one per warp)

// The plan (kernels/window_attention.py::ln_mlp_bwd_plan mirrors it).
struct MlpBwdPlan {
  int ks;               // K split of dab w1^T
  int chunk, nchunks;   // weight gradients: tokens per chunk (a multiple of 64), chunks
  int rtiles, lnctas;   // 64-row tiles; LN backward CTAs
};

inline MlpBwdPlan mlp_bwd_plan(int B, int H, int W, int C, int hidden) {
  using namespace bb;
  const int hw = H * W, T = B * hw;
  MlpBwdPlan p;
  // the largest divisor of dab w1^T's 64-row K chunks, up to a portable
  // cluster, that keeps a kPlanBatch-image launch within kFillCtas CTAs
  const int nch = (hidden + 63) / 64;
  const int tiles = ((kPlanBatch * hw + 63) / 64) * ((C + kCols - 1) / kCols);
  p.ks = 1;
  for (int d = 2; d <= std::min(kMlpKsMax, nch); ++d)
    if (nch % d == 0 && tiles * d <= kFillCtas) p.ks = d;
  const int wtiles = wg_tiles(hidden, C) + wg_tiles(C, hidden);
  const int per = std::max(1, (kFillCtas + wtiles - 1) / wtiles);
  p.chunk = 64 * (((kPlanBatch * hw + 63) / 64 + per - 1) / per);
  p.nchunks = (T + p.chunk - 1) / p.chunk;
  p.rtiles = (T + 63) / 64;
  p.lnctas = (T + kMlpLnRows - 1) / kMlpLnRows;
  return p;
}

// The workspace (kernels/window_attention.py::ln_mlp_bwd_workspace mirrors
// it): the token rows (yn, round(gelu(a)), dm, round(da)), the LN
// statistics, a and dyn in fp32, the weight gradients' partials with more
// than one chunk, b1's and the LN's partials. With p == nullptr only
// measures.
struct MlpBwdWork {
  bf16 *yn, *h1, *dm, *dab;
  float *st, *a, *dyn, *pw2, *pw1, *pb2, *pb1, *pln;
  size_t bytes;
};

inline MlpBwdWork carve_mlp_bwd(unsigned char* p, int B, int H, int W, int C, int hidden) {
  const MlpBwdPlan pl = mlp_bwd_plan(B, H, W, C, hidden);
  const int T = B * H * W;
  Carve cv{p};
  MlpBwdWork w;
  const size_t tc = (size_t)T * C, th = (size_t)T * hidden;
  w.yn = cv.take<bf16>(tc);
  w.h1 = cv.take<bf16>(th);
  w.dm = cv.take<bf16>(tc);
  w.dab = cv.take<bf16>(th);
  w.st = cv.take<float>(2 * (size_t)T);
  w.a = cv.take<float>(th);
  w.dyn = cv.take<float>(tc);
  const bool split = pl.nchunks > 1;
  w.pw2 = split ? cv.take<float>((size_t)pl.nchunks * hidden * C) : nullptr;
  w.pw1 = split ? cv.take<float>((size_t)pl.nchunks * C * hidden) : nullptr;
  w.pb2 = split ? cv.take<float>((size_t)pl.nchunks * C) : nullptr;
  w.pb1 = cv.take<float>((size_t)pl.rtiles * hidden);
  w.pln = cv.take<float>((size_t)pl.lnctas * 2 * C);
  w.bytes = cv.used;
  return w;
}

// ---- launch 3: out (T x N, fp32) = A (T x K) W^T (W: N x K row-major)

struct KsArgs {
  int T, K, N;
  float* out;
};

// One 64 x 128 output tile per cluster of ks CTAs along x (blockIdx.y: the
// column tile, blockIdx.z: the row tile); rank q runs K chunks [q per, (q +
// 1) per) of 64 on the wgmma + TMA ring, then the cluster's fp32 tiles are
// summed in rank order, each rank writing 64 / ks of the rows.
static __global__ void __launch_bounds__(bb::kThr, 1)
    ksplit_kernel(const __grid_constant__ KsArgs a, const __grid_constant__ CUtensorMap ma,
                  const __grid_constant__ CUtensorMap mb) {
  using namespace bb;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + kRingS;
  unsigned char* ring = base + kHead;
  float* cs = reinterpret_cast<float*>(ring);   // the fp32 tile, once the ring is spent
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), ks = (int)cl.num_blocks();
  const int tid = threadIdx.x, wg = tid >> 7, t128 = tid & 127;
  const int n0 = blockIdx.y * kCols, r0 = blockIdx.z * 64;
  const int per = (a.K + 63) / 64 / ks, c0 = rank * per;
  const int nb = min(2, hop::nboxes(a.N - n0));
  if (tid == 0) {
    for (int s = 0; s < kRingS; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], kThr);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int q) {
    const int s = q % kRingS, c = c0 + q;
    unsigned char* slot = ring + (size_t)s * kSlot;
    hop::mbar_expect_tx(&full[s], (uint32_t)(1 + nb) * kBoxB);
    hop::tma_load(slot, &ma, &full[s], c * 64, r0);
    for (int j = 0; j < nb; ++j)
      hop::tma_load(slot + (1 + j) * kBoxB, &mb, &full[s], c * 64, n0 + 64 * j);
  };
  if (tid == 0)
    for (int q = 0; q < min(kRingS, per); ++q) issue(q);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int q = 0; q < per; ++q) {
    const int s = q % kRingS;
    hop::mbar_wait(&full[s], (uint32_t)((q / kRingS) & 1));
    const unsigned char* slot = ring + (size_t)s * kSlot;
    const unsigned char* bbox = slot + (1 + wg) * kBoxB;
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16)
      hop::wgmma64_kmajor(acc, hop::a_desc(slot, kk), hop::a_desc(bbox, kk), 1);
    hop::wg_commit();
    hop::wg_wait0();
    hop::mbar_arrive(&empty[s]);
    if (tid == 0 && q + kRingS < per) {
      hop::mbar_wait(&empty[s], (uint32_t)((q / kRingS) & 1));
      issue(q + kRingS);
    }
  }
  __syncthreads();   // the products are done: the tile takes the ring's place
#pragma unroll
  for (int i = 0; i < 32; ++i)
    cs[hop::acc_row(t128, i) * kCsLd + wg * 64 + hop::acc_col(t128, i)] = acc[i];
  cl.sync();
  const int lo = rank * 64 / ks, hi = (rank + 1) * 64 / ks;
  for (int i = tid; i < (hi - lo) * kCols; i += kThr) {
    const int r = lo + i / kCols, c = i % kCols;
    if (r0 + r >= a.T || n0 + c >= a.N) continue;
    float v = 0.f;
    for (int q = 0; q < ks; ++q)   // split partials in rank order
      v += cl.map_shared_rank(cs, q)[r * kCsLd + c];
    a.out[(size_t)(r0 + r) * a.N + n0 + c] = v;
  }
  cl.sync();   // every rank has read this CTA's tile
}

// ---- launch 4: the weight gradients and the LN backward

struct LnRowsArgs {
  const float* dyn;   // (T, C) fp32
  const bf16* y;      // (T, C): the LN's input rows
  const float* st;    // (mean, inv) per row
  const float* g;
  bf16* dy;
  float* part;        // [CTA][2C]: dg, then db
  int T, C;
};

// kMlpLnRows rows of the LN backward, one per warp: dy = round(inv (dyn g -
// mean(dyn g) - xhat mean(dyn g xhat))); the CTA's column sums of dyn xhat
// and dyn over its rows in row order, staged in the launch's dynamic shared
// memory.
__device__ __forceinline__ void ln_rows(const LnRowsArgs& a, int cta) {
  constexpr int kJ = kLnMaxC / 32;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float(*red)[2][kLnMaxC] = reinterpret_cast<float(*)[2][kLnMaxC]>(smem_raw);   // 48 KB
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, C = a.C;
  const int r = cta * kMlpLnRows + warp;
  float dv[kJ], xh[kJ];
  float m1 = 0.f, m2 = 0.f;
  const float mean = r < a.T ? a.st[2 * (size_t)r] : 0.f;
  const float inv = r < a.T ? a.st[2 * (size_t)r + 1] : 0.f;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int c = lane + 32 * j;
    dv[j] = xh[j] = 0.f;
    if (r < a.T && c < C) {
      dv[j] = a.dyn[(size_t)r * C + c];
      xh[j] = (bf(a.y[(size_t)r * C + c]) - mean) * inv;
      const float dxh = dv[j] * a.g[c];
      m1 += dxh;
      m2 += dxh * xh[j];
    }
  }
  m1 = warp_sum(m1) / C;
  m2 = warp_sum(m2) / C;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int c = lane + 32 * j;
    if (c >= C) continue;
    if (r < a.T) a.dy[(size_t)r * C + c] = tobf(inv * (dv[j] * a.g[c] - m1 - xh[j] * m2));
    red[warp][0][c] = dv[j] * xh[j];
    red[warp][1][c] = dv[j];
  }
  __syncthreads();
  float* out = a.part + (size_t)cta * 2 * C;
  for (int i = threadIdx.x; i < 2 * C; i += bb::kThr) {
    const int k = i / C, c = i % C;
    float s = 0.f;
    for (int w = 0; w < kMlpLnRows; ++w) s += red[w][k][c];   // rows in order
    out[i] = s;
  }
}

// CTAs [0, nwg): the weight-gradient table; the rest: the LN backward.
static __global__ void __launch_bounds__(bb::kThr, 1)
    mlp_tail_kernel(const __grid_constant__ bb::WgArgs g, const __grid_constant__ bb::WgMaps m,
                    const __grid_constant__ LnRowsArgs r, int nwg) {
  if ((int)blockIdx.x < nwg) bb::wgrad_cta(g, m, (int)blockIdx.x);
  else ln_rows(r, (int)blockIdx.x - nwg);
}

struct MlpBwdArgs {
  const bf16 *y, *dout;
  const float *g, *be;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  bf16* dy;
  float *dg, *db, *dw1, *db1, *dw2, *db2;
  int B, H, W, C, hidden;
};

cudaError_t ln_mlp_bwd(const MlpBwdArgs& a, const MlpBwdWork& w, cudaStream_t st, int* n) {
  using namespace bb;
  const int T = a.B * a.H * a.W, C = a.C, Hd = a.hidden;
  const MlpBwdPlan pl = mlp_bwd_plan(a.B, a.H, a.W, C, Hd);
  TokArgs base;
  memset(&base, 0, sizeof(base));
  base.T = T;
  base.C = C;
  base.H = a.H;
  base.W = a.W;
  base.ws = 1;   // a window of one token, no shift: token_offset is the row itself

  // ---- forward recompute: LN2 + fc1
  {
    TokArgs t = base;
    t.K = C, t.N = Hd, t.src = a.y, t.lg = a.g, t.lb = a.be, t.side0 = w.yn, t.stats = w.st;
    t.bias = a.b1, t.of = w.a, t.ob = w.h1;
    SUNET_TRY((tok_gemm<kALn2, false, kEFc1>(t, nullptr, a.w1, C, Hd, st, n)));
  }
  // ---- dm w2^T: da, round(da), b1's column partials
  {
    TokArgs t = base;
    t.K = C, t.N = Hd, t.src = a.dout, t.side0 = w.dm, t.aux = w.a, t.ob = w.dab, t.part = w.pb1;
    SUNET_TRY((tok_gemm<kADm, true, kEDa>(t, nullptr, a.w2, Hd, C, st, n)));
  }
  // ---- dyn = dab w1^T, split over K on clusters of ks CTAs
  {
    CUtensorMap ma, mb;
    SUNET_TRY(hop::weight_map(&ma, w.dab, T, Hd, 64));
    SUNET_TRY(hop::weight_map(&mb, a.w1, C, Hd, 64));
    const KsArgs k{T, Hd, C, w.dyn};
    SUNET_TRY(hop::launch_cluster(ksplit_kernel, dim3(pl.ks, (C + kCols - 1) / kCols, pl.rtiles),
                                  kThr, wgrad_smem(), st, pl.ks, k, ma, mb));
    SUNET_TRY(launched(n));
  }
  // ---- dw2 = h1^T dm (and b2's), dw1 = yn^T dab; the LN backward
  const bool split = pl.nchunks > 1;
  {
    WgArgs g;
    WgMaps m;
    memset(&g, 0, sizeof(g));
    memset(&m, 0, sizeof(m));
    const bf16* xs[2] = {w.h1, w.yn};
    const bf16* ds[2] = {w.dm, w.dab};
    const int mn[2][2] = {{Hd, C}, {C, Hd}};
    float* outs[2] = {split ? w.pw2 : a.dw2, split ? w.pw1 : a.dw1};
    float* pbs[2] = {split ? w.pb2 : a.db2, nullptr};
    int first = 0;
    for (int i = 0; i < 2; ++i) {
      g.p[i] = WgProduct{mn[i][0], mn[i][1], (mn[i][0] + 63) / 64, first, outs[i], pbs[i]};
      first += wg_tiles(mn[i][0], mn[i][1]) * pl.nchunks;
      SUNET_TRY(hop::weight_map(&m.x[i], xs[i], T, mn[i][0], 64));
      SUNET_TRY(hop::weight_map(&m.d[i], ds[i], T, mn[i][1], 64));
    }
    g.np = 2, g.T = T, g.chunk = pl.chunk, g.nchunks = pl.nchunks;
    const LnRowsArgs r{w.dyn, a.y, w.st, a.g, a.dy, w.pln, T, C};
    SUNET_TRY(hop::launch_cluster(mlp_tail_kernel, dim3(first + pl.lnctas), kThr, wgrad_smem(),
                                  st, 1, g, m, r, first));
    SUNET_TRY(launched(n));
  }
  // ---- every partial, summed in order
  SumArgs s;
  memset(&s, 0, sizeof(s));
  SumSeg segs[kSumSegs];
  int ns = 0;
  if (split) {
    segs[ns++] = {w.pw2, a.dw2, pl.nchunks, Hd * C, (long long)Hd * C};
    segs[ns++] = {w.pw1, a.dw1, pl.nchunks, C * Hd, (long long)C * Hd};
    segs[ns++] = {w.pb2, a.db2, pl.nchunks, C, C};
  }
  segs[ns++] = {w.pb1, a.db1, pl.rtiles, Hd, Hd};
  segs[ns++] = {w.pln, a.dg, pl.lnctas, C, 2 * C};
  segs[ns++] = {w.pln + C, a.db, pl.lnctas, C, 2 * C};
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

extern "C" size_t sunet_ln_mlp_bwd_workspace(int B, int H, int W, int C, int hidden) {
  return carve_mlp_bwd(nullptr, B, H, W, C, hidden).bytes;
}

// y, dout (B, H, W, C) bf16 -> dy (B, H, W, C) bf16 and the float32 grads
// of the LN scale and bias, w1 (C, hidden), b1, w2 (hidden, C) and b2. ks:
// the plan's K split (ln_mlp_bwd_plan), refused if it is not this entry's.
extern "C" int sunet_ln_mlp_bwd(const void* y, const void* dout, const void* g, const void* be,
                                const void* w1, const void* b1, const void* w2, void* dy,
                                void* dg, void* db, void* dw1, void* db1, void* dw2, void* db2,
                                void* work, int B, int H, int W, int C, int hidden, int ks,
                                int* launches, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C % 16 || C > kLnMaxC || hidden % 16 || hidden <= 0)
    return (int)cudaErrorInvalidValue;
  if (ks != mlp_bwd_plan(B, H, W, C, hidden).ks) return (int)cudaErrorInvalidValue;
  const MlpBwdArgs a{(const bf16*)y,  (const bf16*)dout, (const float*)g,  (const float*)be,
                     (const bf16*)w1, (const float*)b1,  (const bf16*)w2,  (bf16*)dy,
                     (float*)dg,      (float*)db,        (float*)dw1,      (float*)db1,
                     (float*)dw2,     (float*)db2,       B,                H,
                     W,               C,                 hidden};
  const MlpBwdWork w = carve_mlp_bwd((unsigned char*)work, B, H, W, C, hidden);
  *launches = 0;
  return (int)ln_mlp_bwd(a, w, (cudaStream_t)stream, launches);
}
