// Whole Swin block on a thread-block cluster of G CTAs per (image, window).
//
// Replaces sunet_tf_tpu/kernels/window_attention.py::fused_swin_block (and,
// launched K times, fused_swin_block_chain): LN1 -> window partition -> QKV
// -> per head QK^T*scale + rel-pos bias (+ SW mask) -> row-max softmax -> P@V
// -> proj -> residual -> LN2 -> fc1 -> erf GELU -> fc2 -> residual, with the
// train form's per-image drop-path pair dp[b] = (s1, s2): y = round(x +
// s1*attn), out = round(y + s2*mlp). The rounding points are the JAX
// kernel's (_block_body): LN1 rounded; q, k, v rounded (q after the scale);
// fp32 scores + bias + mask, exact row-max softmax, P rounded, ctx =
// round((P @ v) / sum); y rounded; LN2 rounded; h = round(gelu_erf(fc1 +
// b1)); out = round(y + s2*(fc2 + b2)).
//
// Also replaces fused_swin_block_res (its kernel _block_fwd_res_kernel), the
// residual route's training forward, as the compile-time variant kRes of the
// same kernel: each head's exponentials are rounded to bf16 before the row
// sum (den = sum round(e)), rden = 1 / max(den, 1e-37), ctx_f = (round(e) @
// v) * rden, the block goes on from round(ctx_f), and the attention state
// that swin_block_bwd_res.cu differentiates is stored straight from the
// warps' registers in window-major (rolled) order: eb (B*nW, heads, N, N)
// bf16 (the P@V A fragment's packed pairs), rden (B*nW, heads, N) and ctx_f
// (B*H*W, C) float32; window wg = b*nW + win. Each rank stores its own
// heads' rows and columns.
//
// What bounds it on Hopper: a 64-token window holds 4-16 MFLOP per head
// slice against 0.2-1.8 MB of bf16 weights, which every window reads from
// L2. On one CTA per window the C=384 stage launched 8-16 CTAs on 132 SMs,
// and each warp waited on its own weight loads from L2. Split over a
// cluster, each CTA runs its phases (LayerNorm, four products and their
// epilogues, attention, the seams) one after another on 12 warps: the
// latency of their dependent chains bounds it now, not the tensor cores or
// L2 (phase by phase: sunet_tf_tpu_torch/tools/block_phases.py). The
// residual form adds the stores of its state, ~9 KB per head-window at
// N=64 (23 MB at (64,64,96) batch 4), to the HBM traffic: they leave the
// registers as 4- and 8-byte stores beside the attention's products, and
// the L2 merges them into whole sectors before they reach HBM.
//
// Design:
// - A cluster of G CTAs per window (G from the launch plan, kernels/
//   window_attention.py::block_plan, from one image's shape so that a
//   batch-4 launch fills the card: 1 at C=96, 2 at C=192, 8 at C=384 for
//   the default model's images, at any batch; the residual form takes the
//   same plan). Rank r owns heads
//   [r*h/G, (r+1)*h/G): its q, k, v columns (cg = C/G of each), its cg
//   columns of proj and of the output, hg = hidden/G columns of fc1, and the
//   split-K partial of fc2 over those hg rows of w2.
// - The window is one wgmma row tile (64 tokens; a smaller window leaves
//   rows unused). Each product runs on hopper.cuh's mainloop: the A operand
//   (LN(x), ctx, LN(y), h) in shared memory, weight boxes by TMA into a ring
//   of kRingS slots with full/empty mbarriers, one thread keeping the ring
//   kRingS chunks ahead across products. Three consumer warpgroups split
//   the 64-column boxes of each product.
// - The sublayer seams go through distributed shared memory: each rank
//   writes its ctx columns, the cluster syncs, each rank gathers the others'
//   columns before proj; the same for y before LN2. The fc2 partials (64 x
//   C fp32 each) are reduced per output column slice in rank order 0..G-1,
//   then b2, s2 and y are applied and rounded once: the same bits every run.
//   Nothing between x and out leaves the cluster but the residual form's
//   state.
// - Per-head attention: one warp per (head, 16-row strip), scores, softmax
//   and P in registers (mma.sync m16n8k16; d padded to 16 inside the head
//   only), so the heads need no block barrier between them.
// - The epilogues hand the sums through a staging tile to rolled loops;
//   the per-column arithmetic of the q/k/v epilogue (head, offset) is a
//   table built once per CTA.
// - The SW roll and the window partition are load/store addressing.
#include "common.cuh"
#include "hopper.cuh"

namespace sunet {

namespace cg = cooperative_groups;
using hop::a_off;
using hop::align1024;
using hop::chunk_rows;
using hop::nboxes;
using hop::Product;
using hop::Ring;

constexpr int kWG = 3;                  // consumer warpgroups
constexpr int kCThreads = kWG * 128;
constexpr int kWarpsC = kCThreads / 32;
constexpr int kTile = 64;               // the window's rows: one wgmma row tile
constexpr int kMaxBoxes = 6;            // 64-column boxes of one product, at most
constexpr int kMJ = (kMaxBoxes + kWG - 1) / kWG;   // boxes per warpgroup
constexpr int kEpiCols = 16;            // a warpgroup's staging quarter box (fp32)
constexpr int kEpiLd = kEpiCols + kPadF;
constexpr size_t kEpiBytes = (size_t)kWG * kTile * kEpiLd * 4;
constexpr int kVtLd = kTile + kPad;   // row stride of a head's v, transposed
constexpr int kRingS = 3;               // slots of the weight ring
constexpr int kRingSlot = 24576;        // bytes of a slot

// A measurement build (-DSUNET_PHASE_CLOCK, sunet_tf_tpu_torch/tools/
// block_phases.py) records thread 0's SM clock at each phase boundary of
// every CTA into the buffer given to sunet_swin_block_phase_clock: kPhases
// values per CTA in (blockIdx.y, blockIdx.x) order.
constexpr int kPhases = 13;
#ifdef SUNET_PHASE_CLOCK
__device__ long long* g_phase_clock;
#define PHASE(k)                                                                       \
  do {                                                                                 \
    if (threadIdx.x == 0 && g_phase_clock)                                             \
      g_phase_clock[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * kPhases + (k)] =   \
          clock64();                                                                   \
  } while (0)
#else
#define PHASE(k) \
  do {           \
  } while (0)
#endif

struct ClusterArgs {
  const bf16* x;
  bf16* out;
  const float *g1, *be1, *bqkv, *bproj, *g2, *be2, *b1, *b2, *bias, *mask, *dp;
  int B, H, W, C, hidden, ws, heads, shift;
  float scale;
  int G;
  // the residual form's state (kRes), whole-batch bases; null in #1
  bf16* eb;
  float *rden, *ctxf;
};

struct WeightMaps {
  CUtensorMap qkv, proj, fc1, fc2;
};

// Offsets from the 1024-aligned base of dynamic shared memory (the launch
// plan, kernels/window_attention.py::_block_carve, mirrors it to choose G).
struct BlockCarve {
  size_t vec, xs, ring, abuf, work, stg, total;
  int cg, hg, hr, d, ldq;
};

__host__ __device__ inline BlockCarve block_carve(int C, int hidden, int heads, int G) {
  BlockCarve c;
  c.cg = C / G;
  c.hg = hidden / G;
  c.hr = heads / G;
  c.d = C / heads;
  c.ldq = align_up(c.d, 16) + kPad;
  const size_t hdr = align1024(kTile * 8 + 2 * 8 * (size_t)kRingS + 4 * sizeof(Product));
  // the CTA's bias columns: bqkv (3 cg), bproj (cg), b1 (hg), b2 (cg); then
  // per q/k/v column its offset in the head buffers (q, k and v transposed)
  c.vec = hdr;
  c.xs = c.vec + align1024((size_t)(7 * c.cg + c.hg) * 4);
  c.ring = c.xs + align1024((size_t)kTile * (C + kPad) * 2);
  c.abuf = c.ring + (size_t)kRingS * kRingSlot;
  c.work = c.abuf + hop::a_bytes(C);
  const size_t qkv = align128((size_t)3 * c.hr * kTile * c.ldq * 2);
  const size_t h = hop::a_bytes(c.hg);
  c.stg = c.work + (qkv > h ? qkv : h);
  c.total = 1024 + c.stg + kEpiBytes;
  return c;
}

// LayerNorm of rows t < N of xs (row stride ldx) into dst in the swizzled
// K-major layout: fp32 statistics, eps 1e-5, one warp per row, each lane's
// g and b in registers.
constexpr int kLnPer = kMaxBoxes * 64 / 32;   // columns per lane at C = 384
__device__ __noinline__ void ln_rows_kmajor(const bf16* xs, int ldx, unsigned char* dst, int N,
                                            int C, const float* __restrict__ g,
                                            const float* __restrict__ b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float gv[kLnPer], bv[kLnPer];
#pragma unroll
  for (int u = 0; u < kLnPer; ++u) {
    const int c = lane + 32 * u;
    gv[u] = c < C ? g[c] : 0.f;
    bv[u] = c < C ? b[c] : 0.f;
  }
  for (int r = warp; r < N; r += kWarpsC) {
    const bf16* s = xs + (size_t)r * ldx;
    float xv[kLnPer];
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < kLnPer; ++u) {
      const int c = lane + 32 * u;
      xv[u] = c < C ? bf(s[c]) : 0.f;
      if (c < C) sum += xv[u];
    }
    const float mean = warp_sum(sum) / C;
    float sq = 0.f;
#pragma unroll
    for (int u = 0; u < kLnPer; ++u) {
      const float dd = xv[u] - mean;
      if (lane + 32 * u < C) sq += dd * dd;
    }
    const float inv = rsqrtf(warp_sum(sq) / C + 1e-5f);
#pragma unroll
    for (int u = 0; u < kLnPer; ++u) {
      const int c = lane + 32 * u;
      if (c < C)
        *reinterpret_cast<bf16*>(dst + a_off(r, c)) = tobf((xv[u] - mean) * inv * gv[u] + bv[u]);
    }
  }
}

// Copy n rows of 16 bytes, row i from src(i) to dst + off(i), four loads
// in flight per thread.
template <class Src, class Off>
__device__ inline void copy16(unsigned char* dst, Src src, int n, Off off) {
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * kCThreads) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kCThreads;
      if (i < n) v[u] = src(i);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kCThreads;
      if (i < n) *reinterpret_cast<uint4*>(dst + off(i)) = v[u];
    }
  }
}

// One head's attention for the 16 query rows i0.. of a window of N tokens,
// by one warp, in registers (mma.sync m16n8k16): s = q k^T + bias (+ mask)
// in fp32 (q already scaled and rounded), e = exp(s - rowmax), P =
// round(e), ctx = round((P @ v) / sum(e)); calls store(row, col, ctx) for
// the head's d columns. q, k: (tokens, dp) rows of stride ld, zero past d;
// vt: v transposed, (dp, tokens) rows of stride kVtLd. kRes (the residual
// form): the row sum is over round(e), ctx_f = (P @ v) * rden with rden =
// 1 / max(sum, 1e-37), ctx = round(ctx_f), and eb, rden and ctx_f go to
// `res` (this head of this window).
struct ResHead {
  bf16* eb;      // N x N
  float* rden;   // N
  float* ctxf;   // the head's first column of the window's first row, rows C apart
  int ldc;
};
constexpr int kMaxNt = kTile / 8;      // 8-column tiles of a score row
constexpr int kMaxDt = kTile / 8;      // 8-column tiles of a head (d <= 64)
template <bool kRes, class Store>
__device__ inline void attn_strip(const bf16* q, const bf16* k, const bf16* vt, int ld, int d,
                                  int N, int i0, const float* __restrict__ bias,
                                  const float* __restrict__ mask, int lane, Store store,
                                  const ResHead& res) {
  const int g = lane >> 2, t2 = (lane & 3) * 2, dp = align_up(d, 16);
  float s[kMaxNt][4];
#pragma unroll
  for (int nt = 0; nt < kMaxNt; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  for (int k0 = 0; k0 < dp; k0 += 16) {
    const bf16* qa = q + (i0 + g) * ld + k0 + t2;
    const uint32_t af[4] = {ld32(qa), ld32(qa + 8 * ld), ld32(qa + 8), ld32(qa + 8 * ld + 8)};
#pragma unroll
    for (int nt = 0; nt < kMaxNt; ++nt) {
      if (nt * 8 >= N) break;
      const bf16* kb = k + (nt * 8 + g) * ld + k0 + t2;
      mma16816(s[nt], af, ld32(kb), ld32(kb + 8));
    }
  }
  // + bias (+ mask); the row maxima of rows g and g + 8 over the quad
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < kMaxNt; ++nt) {
    if (nt * 8 >= N) break;
    const int j = nt * 8 + t2;
    const float2 b0 = *reinterpret_cast<const float2*>(bias + (i0 + g) * N + j);
    const float2 b1 = *reinterpret_cast<const float2*>(bias + (i0 + g + 8) * N + j);
    s[nt][0] += b0.x;
    s[nt][1] += b0.y;
    s[nt][2] += b1.x;
    s[nt][3] += b1.y;
    if (mask) {
      const float2 k0v = *reinterpret_cast<const float2*>(mask + (i0 + g) * N + j);
      const float2 k1v = *reinterpret_cast<const float2*>(mask + (i0 + g + 8) * N + j);
      s[nt][0] += k0v.x;
      s[nt][1] += k0v.y;
      s[nt][2] += k1v.x;
      s[nt][3] += k1v.y;
    }
    m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
    m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < kMaxNt; ++nt) {
    if (nt * 8 >= N) break;
    s[nt][0] = expf(s[nt][0] - m0);
    s[nt][1] = expf(s[nt][1] - m0);
    s[nt][2] = expf(s[nt][2] - m1);
    s[nt][3] = expf(s[nt][3] - m1);
    if constexpr (kRes) {   // eb = round(e): the row sum and the stored state take it
#pragma unroll
      for (int u = 0; u < 4; ++u) s[nt][u] = bf(tobf(s[nt][u]));
      const int j = nt * 8 + t2;
      *reinterpret_cast<uint32_t*>(res.eb + (i0 + g) * N + j) = pack_bf2(s[nt][0], s[nt][1]);
      *reinterpret_cast<uint32_t*>(res.eb + (i0 + g + 8) * N + j) = pack_bf2(s[nt][2], s[nt][3]);
    }
    l0 += s[nt][0] + s[nt][1];
    l1 += s[nt][2] + s[nt][3];
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  if constexpr (kRes) {   // l0, l1 hold the reciprocals
    l0 = 1.f / fmaxf(l0, 1e-37f);
    l1 = 1.f / fmaxf(l1, 1e-37f);
    if ((lane & 3) == 0) {
      res.rden[i0 + g] = l0;
      res.rden[i0 + g + 8] = l1;
    }
  } else {
    l0 = fmaxf(l0, 1e-37f);
    l1 = fmaxf(l1, 1e-37f);
  }
  // P @ v: the score tiles 2kt, 2kt + 1 are the A fragment of k-step kt
  float o[kMaxDt][4];
#pragma unroll
  for (int dt = 0; dt < kMaxDt; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < kMaxNt / 2; ++kt) {
    if (kt * 16 >= N) break;
    const uint32_t af[4] = {pack_bf2(s[2 * kt][0], s[2 * kt][1]),
                            pack_bf2(s[2 * kt][2], s[2 * kt][3]),
                            pack_bf2(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                            pack_bf2(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
    for (int dt = 0; dt < kMaxDt; ++dt) {
      if (dt * 8 >= dp) break;
      const bf16* vb = vt + (dt * 8 + g) * kVtLd + kt * 16 + t2;
      mma16816(o[dt], af, ld32(vb), ld32(vb + 8));
    }
  }
#pragma unroll
  for (int dt = 0; dt < kMaxDt; ++dt) {
    const int c = dt * 8 + t2;
    if (c >= d) break;
    if constexpr (kRes) {   // ctx_f = (eb @ v) * rden; d is even: the pair is whole
      const float2 f0 = make_float2(o[dt][0] * l0, o[dt][1] * l0);
      const float2 f1 = make_float2(o[dt][2] * l1, o[dt][3] * l1);
      *reinterpret_cast<float2*>(res.ctxf + (size_t)(i0 + g) * res.ldc + c) = f0;
      *reinterpret_cast<float2*>(res.ctxf + (size_t)(i0 + g + 8) * res.ldc + c) = f1;
      store(i0 + g, c, tobf(f0.x));
      store(i0 + g + 8, c, tobf(f1.x));
      store(i0 + g, c + 1, tobf(f0.y));
      store(i0 + g + 8, c + 1, tobf(f1.y));
      continue;
    }
    store(i0 + g, c, tobf(o[dt][0] / l0));
    store(i0 + g + 8, c, tobf(o[dt][2] / l1));
    if (c + 1 < d) {
      store(i0 + g, c + 1, tobf(o[dt][1] / l0));
      store(i0 + g + 8, c + 1, tobf(o[dt][3] / l1));
    }
  }
}

// The products' epilogues (product_phase).
enum Epi { kEpiQkv, kEpiProj, kEpiFc1, kEpiFc2 };

struct EpiCtx {
  const float *bq, *bp, *bm1;
  const int *qoff, *voff;
  bf16 *qkv, *xs;
  unsigned char* hbuf;
  float *part, *stg;
  int N, C, cg, hg, ldx, ldq, hsz, rank;
  float scale, s1;
};

// One product on the ring and its epilogue:
// - kEpiQkv: q = round(round(qkv + b) * scale), k, v = round(qkv + b) into
//   the head buffers (v transposed);
// - kEpiProj: y = round(x + s1 * (proj + b)) into xs, this rank's columns;
// - kEpiFc1: h = round(gelu_erf(fc1 + b)) into hbuf (K-major);
// - kEpiFc2: the fp32 partial into part (it takes the place of the ring and
//   what follows it, so every thread first finishes with them).
__device__ inline void product_phase(Ring& ring, const Product& p, const void* a, int which,
                                           const EpiCtx& x) {
  const int tid = threadIdx.x, wg = tid >> 7, t128 = tid & 127;
  float acc[kMJ][32];
  hop::run_product<kMJ>(ring, p, a, acc, wg, kWG, tid == 0);
  const int nj = p.nb > wg ? (p.nb - wg + kWG - 1) / kWG : 0;
  if (which == kEpiFc2) {
    __syncthreads();
    const int ldp = x.C + kPadF;
#pragma unroll
    for (int jj = 0; jj < kMJ; ++jj) {
      if (jj >= nj) break;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = hop::acc_row(t128, i), col = (wg + kWG * jj) * 64 + hop::acc_col(t128, i);
        if (col < x.C)
          *reinterpret_cast<float2*>(x.part + row * ldp + col) =
              make_float2(acc[jj][i], acc[jj][i + 1]);
      }
    }
    return;
  }
  // the other three hand their sums, a quarter box at a time, through the
  // warpgroup's staging tile to one rolled loop
  float* st = x.stg + wg * kTile * kEpiLd;
  const int per = p.per;
#pragma unroll
  for (int jj = 0; jj < kMJ; ++jj) {
    if (jj >= nj) break;
    const int j = wg + kWG * jj;
#pragma unroll
    for (int h = 0; h < 64 / kEpiCols; ++h) {
#pragma unroll
      for (int i = 8 * h; i < 8 * h + 8; i += 2)
        *reinterpret_cast<float2*>(st + hop::acc_row(t128, i) * kEpiLd + hop::acc_col(t128, i) -
                                   kEpiCols * h) = make_float2(acc[jj][i], acc[jj][i + 1]);
      hop::bar_sync(1 + wg, hop::kWgThreads);
      for (int e = t128; e < kTile * kEpiCols; e += hop::kWgThreads) {
        const int row = e / kEpiCols, c = kEpiCols * h + e % kEpiCols;
        const float v = st[row * kEpiLd + e % kEpiCols];
        if (which == kEpiQkv) {
          const int part_ = per == 1 ? j : j >> 1, lc = (per == 1 ? 0 : (j & 1) * 64) + c;
          if (row >= x.N || lc >= x.cg) continue;
          bf16 o = tobf(v + x.bq[part_ * x.cg + lc]);
          if (part_ == 0) o = tobf(bf(o) * x.scale);
          if (part_ < 2)
            x.qkv[part_ * x.hsz + x.qoff[lc] + row * x.ldq] = o;
          else
            x.qkv[2 * x.hsz + x.voff[lc] + row] = o;   // v transposed: (d, tokens)
        } else if (which == kEpiProj) {
          const int lc = j * 64 + c;
          if (row >= x.N || lc >= x.cg) continue;
          bf16* y = x.xs + row * x.ldx + x.rank * x.cg + lc;   // y = round(x + s1*(proj + b))
          *y = tobf(bf(*y) + x.s1 * (v + x.bp[lc]));
        } else {
          const int lc = j * 64 + c;
          if (lc >= x.hg) continue;
          const float vv = v + x.bm1[lc];
          *reinterpret_cast<bf16*>(x.hbuf + a_off(row, lc)) =
              tobf(0.5f * vv * (1.f + erff(vv * 0.70710678118654752f)));
        }
      }
      hop::bar_sync(1 + wg, hop::kWgThreads);
    }
  }
}

template <bool kRes>
__global__ void __launch_bounds__(kCThreads, 1)
    swin_cluster_kernel(const __grid_constant__ ClusterArgs a,
                        const __grid_constant__ WeightMaps maps) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  cg::cluster_group cl = cg::this_cluster();
  const int G = a.G, rank = (int)cl.block_rank();
  const int C = a.C, N = a.ws * a.ws, ldx = C + kPad;
  const BlockCarve cv = block_carve(C, a.hidden, a.heads, G);
  const int cg_ = cv.cg, hg = cv.hg, hr = cv.hr, d = cv.d, ldq = cv.ldq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  long long* tok = reinterpret_cast<long long*>(base);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kTile * 8);
  uint64_t* empty = full + kRingS;
  Product* prods = reinterpret_cast<Product*>(empty + kRingS);
  float* bq = reinterpret_cast<float*>(base + cv.vec);
  float* bp = bq + 3 * cg_;
  float* bm1 = bp + cg_;
  float* bm2 = bm1 + hg;
  int* qoff = reinterpret_cast<int*>(bm2 + cg_);
  int* voff = qoff + cg_;
  bf16* xs = reinterpret_cast<bf16*>(base + cv.xs);
  unsigned char* abuf = base + cv.abuf;
  bf16* qkv = reinterpret_cast<bf16*>(base + cv.work);
  unsigned char* hbuf = base + cv.work;                     // fc1 output, K-major (K = hg)
  float* part = reinterpret_cast<float*>(base + cv.ring);   // fc2 partial (after the ring)
  const int ldp = C + kPadF;

  const int win = blockIdx.x / G, b = blockIdx.y, nwx = a.W / a.ws;
  const int wy = win / nwx, wx = win % nwx;
  const float s1 = a.dp ? a.dp[2 * b] : 1.f, s2 = a.dp ? a.dp[2 * b + 1] : 1.f;

  if (tid == 0) {
    for (int s = 0; s < kRingS; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], kCThreads);
    }
    hop::mbar_fence_init();
    const int pq = nboxes(cg_);
    prods[0] = {&maps.qkv, rank * cg_, pq, C, 3 * pq, 0, C, chunk_rows(kRingSlot, 3 * pq, C)};
    prods[1] = {&maps.proj, rank * cg_, pq, 0, pq, 0, C, chunk_rows(kRingSlot, pq, C)};
    const int ph = nboxes(hg), pc = nboxes(C);
    prods[2] = {&maps.fc1, rank * hg, ph, 0, ph, 0, C, chunk_rows(kRingSlot, ph, C)};
    prods[3] = {&maps.fc2, 0, pc, 0, pc, rank * hg, hg, chunk_rows(kRingSlot, pc, hg)};
  }
  for (int i = tid; i < 5 * cg_ + hg; i += kCThreads) {
    float v;
    if (i < 3 * cg_)
      v = a.bqkv ? a.bqkv[(i / cg_) * C + rank * cg_ + i % cg_] : 0.f;
    else if (i < 4 * cg_)
      v = a.bproj[rank * cg_ + i - 3 * cg_];
    else if (i < 4 * cg_ + hg)
      v = a.b1[rank * hg + i - 4 * cg_];
    else
      v = a.b2[rank * cg_ + i - 4 * cg_ - hg];
    bq[i] = v;
  }
  for (int lc = tid; lc < cg_; lc += kCThreads) {
    qoff[lc] = (lc / d) * kTile * ldq + lc % d;
    voff[lc] = (lc / d) * kTile * ldq + (lc % d) * kVtLd;
  }
  for (int t = tid; t < N; t += kCThreads) {
    const int gy = (wy * a.ws + t / a.ws + a.shift) % a.H;
    const int gx = (wx * a.ws + t % a.ws + a.shift) % a.W;
    tok[t] = (((long long)b * a.H + gy) * a.W + gx) * C;
  }
  __syncthreads();
  PHASE(0);
  Ring ring{full, empty, base + cv.ring, kRingS, (uint32_t)kRingSlot, prods, 4, 0, 0, 0, 0};
  if (tid == 0) ring.produce(kRingS);   // the QKV weights, while x loads

  const int cv8 = C / 8;
  copy16(reinterpret_cast<unsigned char*>(xs),
         [&](int i) { return __ldg(reinterpret_cast<const uint4*>(a.x + tok[i / cv8]) + i % cv8); },
         N * cv8, [&](int i) { return ((i / cv8) * ldx + (i % cv8) * 8) * 2; });
  // rows past the window (N < 64) and the heads' pad columns stay zero
  for (int r = N + warp; r < kTile; r += kWarpsC)
    for (int c = lane * 8; c < C; c += 256)
      *reinterpret_cast<uint4*>(abuf + a_off(r, c)) = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < 3 * hr * kTile * ldq / 8; i += kCThreads)
    reinterpret_cast<uint4*>(qkv)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const EpiCtx ex{bq,  bp,  bm1, qoff, voff, qkv, xs, hbuf, part,
                  reinterpret_cast<float*>(base + cv.stg), N, C, cg_, hg, ldx, ldq,
                  hr * kTile * ldq, rank, a.scale, s1};

  // ---- attention sublayer
  PHASE(1);
  ln_rows_kmajor(xs, ldx, abuf, N, C, a.g1, a.be1);
  hop::fence_async_smem();
  __syncthreads();
  PHASE(2);
  product_phase(ring, prods[0], abuf, kEpiQkv, ex);
  if (tid == 0) ring.produce(ring.consumed + kRingS);   // proj weights during attention
  PHASE(3);
  __syncthreads();

  // per (head, 16-row strip): one warp, no block barrier between heads
  const float* mask = a.mask ? a.mask + (size_t)win * N * N : nullptr;
  const size_t wgi = (size_t)b * (gridDim.x / G) + win;   // window-major window index
  for (int item = warp; item < hr * (N / 16); item += kWarpsC) {
    const int hh = item / (N / 16), i0 = (item % (N / 16)) * 16, head = rank * hr + hh;
    ResHead res{};
    if constexpr (kRes)
      res = ResHead{a.eb + (wgi * a.heads + head) * N * N, a.rden + (wgi * a.heads + head) * N,
             a.ctxf + wgi * N * C + head * d, C};
    attn_strip<kRes>(qkv + (size_t)(0 * hr + hh) * kTile * ldq,
                     qkv + (size_t)(1 * hr + hh) * kTile * ldq,
                     qkv + (size_t)(2 * hr + hh) * kTile * ldq, ldq, d, N, i0,
                     a.bias + (size_t)head * N * N, mask, lane,
                     [&](int row, int col, bf16 v) {
                       *reinterpret_cast<bf16*>(abuf + a_off(row, rank * cg_ + hh * d + col)) = v;
                     },
                     res);
  }
  // ctx: every rank's columns, through distributed shared memory
  PHASE(4);
  cl.sync();
  const int n8 = cg_ / 8;
  for (int q = 0; q < G; ++q) {
    if (q == rank) continue;   // ctx gather
    const unsigned char* theirs = cl.map_shared_rank(abuf, q);
    auto off = [&](int i) { return a_off(i / n8, q * cg_ + (i % n8) * 8); };
    copy16(abuf, [&](int i) { return *reinterpret_cast<const uint4*>(theirs + off(i)); }, N * n8,
           off);
  }
  hop::fence_async_smem();
  __syncthreads();
  PHASE(5);
  product_phase(ring, prods[1], abuf, kEpiProj, ex);
  if (tid == 0) ring.produce(ring.consumed + kRingS);   // fc1 weights
  PHASE(6);
  // y: every rank's columns
  cl.sync();
  for (int q = 0; q < G; ++q) {
    if (q == rank) continue;
    const bf16* theirs = cl.map_shared_rank(xs, q);
    auto off = [&](int i) { return (i / n8) * ldx + q * cg_ + (i % n8) * 8; };
    copy16(reinterpret_cast<unsigned char*>(xs),
           [&](int i) { return *reinterpret_cast<const uint4*>(theirs + off(i)); }, N * n8,
           [&](int i) { return off(i) * 2; });
  }
  __syncthreads();

  // ---- MLP sublayer
  PHASE(7);
  ln_rows_kmajor(xs, ldx, abuf, N, C, a.g2, a.be2);
  hop::fence_async_smem();
  __syncthreads();
  PHASE(8);
  product_phase(ring, prods[2], abuf, kEpiFc1, ex);
  hop::fence_async_smem();
  __syncthreads();
  PHASE(9);
  product_phase(ring, prods[3], hbuf, kEpiFc2, ex);
  PHASE(10);
  cl.sync();
  PHASE(11);
  // this rank's output columns: the partials summed in rank order, then
  // out = round(y + s2*(fc2 + b2))
  const int n4 = cg_ / 4;
  for (int i = tid; i < N * n4; i += kCThreads) {
    const int row = i / n4, lc = (i % n4) * 4, col = rank * cg_ + lc;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < G; ++q) {   // fc2 partials in rank order
      const float4 v = *reinterpret_cast<const float4*>(cl.map_shared_rank(part, q) +
                                                        row * ldp + col);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const bf16* y = xs + row * ldx + col;
    bf16* o = a.out + tok[row] + col;
    o[0] = tobf(bf(y[0]) + s2 * (s.x + bm2[lc]));
    o[1] = tobf(bf(y[1]) + s2 * (s.y + bm2[lc + 1]));
    o[2] = tobf(bf(y[2]) + s2 * (s.z + bm2[lc + 2]));
    o[3] = tobf(bf(y[3]) + s2 * (s.w + bm2[lc + 3]));
  }
  cl.sync();   // every rank has read this CTA's partial
  PHASE(12);
}

}  // namespace sunet

using namespace sunet;

#ifdef SUNET_PHASE_CLOCK
// The measurement build's clock buffer (see kPhases); NULL stops recording.
extern "C" int sunet_swin_block_phase_clock(void* buf) {
  return (int)cudaMemcpyToSymbol(g_phase_clock, &buf, sizeof(buf));
}

// How many clusters of G CTAs with `smem` bytes each the card holds at once
// (cudaOccupancyMaxActiveClusters); negative on an error.
extern "C" int sunet_swin_block_max_clusters(int G, long long smem) {
  cudaError_t e = cudaFuncSetAttribute(swin_cluster_kernel<false>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G * 64, 1);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = G;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, swin_cluster_kernel<false>, &cfg);
  return e != cudaSuccess ? -(int)e : n;
}
#endif

namespace sunet {

// Checks the shape and the cluster size G, builds the weight maps and
// launches the kernel (kRes: the residual form with its state buffers).
static cudaError_t launch_block(const ClusterArgs& a, const void* wqkv, const void* wproj,
                                const void* w1, const void* w2, cudaStream_t st) {
  const int N = a.ws * a.ws, C = a.C, hidden = a.hidden, heads = a.heads, G = a.G;
  if (N % 16 || N > kTile || C % 16 || C % heads || hidden % 16 || a.H % a.ws || a.W % a.ws)
    return cudaErrorInvalidValue;
  if (G < 1 || G > 8 || heads % G || C % G || hidden % G || C / heads > kTile)
    return cudaErrorInvalidConfiguration;
  const BlockCarve cv = block_carve(C, hidden, heads, G);
  const size_t smem = cv.total;
  if (smem > kMaxSmem || cv.cg % 8 || cv.hg % 16 || nboxes(cv.cg) * 3 > kMaxBoxes ||
      nboxes(cv.hg) > kMaxBoxes || nboxes(C) > kMaxBoxes ||
      (size_t)kTile * (C + kPadF) * 4 > cv.total - 1024 - cv.ring)
    return cudaErrorInvalidConfiguration;
  WeightMaps m;
  const int pq = nboxes(cv.cg), ph = nboxes(cv.hg), pc = nboxes(C);
  cudaError_t e;
  if ((e = hop::weight_map(&m.qkv, wqkv, C, 3 * C, chunk_rows(kRingSlot, 3 * pq, C))) ||
      (e = hop::weight_map(&m.proj, wproj, C, C, chunk_rows(kRingSlot, pq, C))) ||
      (e = hop::weight_map(&m.fc1, w1, C, hidden, chunk_rows(kRingSlot, ph, C))) ||
      (e = hop::weight_map(&m.fc2, w2, hidden, C, chunk_rows(kRingSlot, pc, cv.hg))))
    return e;
  const dim3 grid((a.H / a.ws) * (a.W / a.ws) * G, a.B);
  if ((e = a.eb ? hop::launch_cluster(swin_cluster_kernel<true>, grid, kCThreads, smem, st, G,
                                      a, m)
                : hop::launch_cluster(swin_cluster_kernel<false>, grid, kCThreads, smem, st, G,
                                      a, m)))
    return e;
  return cudaGetLastError();
}

}  // namespace sunet

// x, out, ln1 g/b, wqkv, bqkv, wproj, bproj, ln2 g/b, w1, b1, w2, b2, bias,
// mask, dp (B, 2) or NULL; then the shape; then the cluster size G (from
// the launch plan). A G whose columns or shared memory the design does not
// take is refused.
extern "C" int sunet_swin_block(const void* x, void* out, const void* g1, const void* be1,
                                const void* wqkv, const void* bqkv, const void* wproj,
                                const void* bproj, const void* g2, const void* be2,
                                const void* w1, const void* b1, const void* w2, const void* b2,
                                const void* bias, const void* mask, const void* dp, int B, int H,
                                int W, int C, int hidden, int ws, int heads, int shift,
                                float scale, int G, void* stream) {
  ClusterArgs a{(const bf16*)x,     (bf16*)out,          (const float*)g1, (const float*)be1,
                (const float*)bqkv, (const float*)bproj, (const float*)g2, (const float*)be2,
                (const float*)b1,   (const float*)b2,    (const float*)bias,
                (const float*)mask, (const float*)dp,    B, H, W, C, hidden, ws, heads, shift,
                scale, G, nullptr, nullptr, nullptr};
  return (int)launch_block(a, wqkv, wproj, w1, w2, (cudaStream_t)stream);
}

// The residual form (#6): sunet_swin_block's pointers, then eb, rden and
// ctx_f (layouts in the header note); then the shape, scale and G.
extern "C" int sunet_swin_block_res(const void* x, void* out, const void* g1, const void* be1,
                                    const void* wqkv, const void* bqkv, const void* wproj,
                                    const void* bproj, const void* g2, const void* be2,
                                    const void* w1, const void* b1, const void* w2,
                                    const void* b2, const void* bias, const void* mask,
                                    const void* dp, void* eb, void* rden, void* ctx, int B,
                                    int H, int W, int C, int hidden, int ws, int heads,
                                    int shift, float scale, int G, void* stream) {
  // the state's pairs: an even head dim
  if (eb == nullptr || rden == nullptr || ctx == nullptr || heads <= 0 || (C / heads) % 2)
    return (int)cudaErrorInvalidValue;
  ClusterArgs a{(const bf16*)x,     (bf16*)out,          (const float*)g1, (const float*)be1,
                (const float*)bqkv, (const float*)bproj, (const float*)g2, (const float*)be2,
                (const float*)b1,   (const float*)b2,    (const float*)bias,
                (const float*)mask, (const float*)dp,    B, H, W, C, hidden, ws, heads, shift,
                scale, G, (bf16*)eb, (float*)rden, (float*)ctx};
  return (int)launch_block(a, wqkv, wproj, w1, w2, (cudaStream_t)stream);
}
