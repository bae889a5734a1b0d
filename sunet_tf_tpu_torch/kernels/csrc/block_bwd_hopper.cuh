// The kernels of the whole Swin block's backward (swin_block_bwd.cuh's
// launch sequence, shared by #8 swin_block_bwd.cu and #7
// swin_block_bwd_res.cu) and of the LN+W-MSA sublayer's backward (#12,
// ln_wmsa_bwd.cu, the attention half of the same sequence):
//
// - tok_gemm: out (T x N) = epilogue(A (T x K) @ B (K x N)) over the
//   window-major token rows, one CTA per 64 rows x 128 columns, on
//   hopper.cuh's wgmma. B comes by TMA in 64 x 64 boxes with the 128-byte
//   swizzle: a weight W read as it is (tnsp-b 1) or as W^T from W's rows
//   (K-major, tnsp-b 0). A is either computed by the CTA's threads into
//   shared memory before the products (the LayerNorm of the rows, with the
//   window gather as addressing; the drop-path scaled dout gather; the
//   rounding of ctx_f), column tile 0 also writing what it computed for
//   later launches, or streamed by TMA beside B (kATma). A 3-slot ring of
//   (A box, two B boxes) runs ahead of the products. The fp32 tile then
//   sits in shared memory (the ring's place) for the epilogue, which writes
//   rows coalesced and forms per-row-tile column partials where a bias
//   gradient needs them. The LayerNorm backward epilogues (kELn2, kELn1,
//   kELn1NoRes):
//   the ceil(C / 128) CTAs of a row tile form a cluster that owns all C
//   columns; each CTA's part of the two row sums meets the others' in
//   distributed shared memory, summed in rank order (the same bits every
//   run). kRealC (the big-window backward's padded widths, block_bwd_big.cuh):
//   the rows hold TokArgs::cr real channels and zeros up to C (a multiple of
//   16), and the LayerNorms' statistics and the backward's means run over
//   the cr real channels; the other instantiations are unchanged.
// - wgrad_kernel: every weight gradient dW = X^T dB of the block in one
//   launch. A table of (product, 64 x 128 output tile, token chunk), chunk
//   fastest; X and dB both token matrices by TMA (X read transposed,
//   tnsp-a 1). Each CTA writes its chunk's fp32 partial; the CTAs of the
//   first row tile of a product with a bf16 bias source also sum dB's
//   columns from the tiles in shared memory (the bias gradient).
// - sum_kernel: one launch that sums every partial of the block's
//   reductions in chunk order (weight and bias gradients, the LNs' (dg,
//   db), the rel-pos bias gradient).
// - attn_tc_kernel: the attention of one head over one window at a time,
//   on mma.sync m16n8k16 in registers, four warps of 16 query rows; the
//   head dim is zero-padded to the k16 step. The products over the head
//   dim (q k^T, dctx v^T) step through it by k16; those that produce its
//   columns (ctx, dq, dk, dv) by 8-column tiles, dk and dv eight tiles (64
//   columns) at a time on fragments of round(ds)^T and round(P)^T loaded
//   once per group, so a head dim is bounded by shared memory alone (192
//   at N=64: C=384 with 2 heads). kAttnFwd recomputes ctx =
//   round(round(P) @ v); kAttnBwd (the recompute form) recomputes P from
//   q, k, the rel-pos bias and the mask; kAttnBwdRes (the residual route)
//   reads the forward's e, rden and ctx_f. dP, dq, dk and dv are all
//   tensor-core products (round(ds) and round(P) pass through shared
//   memory transposed for dk and dv). A CTA walks a chunk of windows of one
//   head, summing ds (the rel-pos bias gradient) and dq/dk/dv's columns
//   (the qkv bias gradient) in registers and shared memory in window order.
//
// Everything here is a template, inline or static, so several sources can
// include the header.
#pragma once

#include <string.h>

#include "hopper.cuh"
#include "train_common.cuh"

namespace sunet {
namespace bb {

namespace cg = cooperative_groups;

constexpr int kThr = 256;          // two warpgroups, one 64-column box each
constexpr int kCols = 128;         // output columns of a token-GEMM CTA
constexpr int kBoxB = 64 * 128;    // one 64 x 64 bf16 TMA box
constexpr int kRingS = 3;          // ring slots
constexpr int kSlot = 3 * kBoxB;   // a slot: an A box and two B boxes
constexpr int kCsLd = kCols + 4;   // row stride of the fp32 output tile
constexpr int kHead = 4096;        // barriers, the LN row sums, the rows' RowInfo
constexpr int kPlanBatch = 4;      // the batch a plan sizes its chunks to
constexpr int kFillCtas = 264;     // CTAs a chunked launch aims at (2 per SM)
static_assert(2 * 64 * kCsLd * 4 <= kRingS * kSlot,
              "the output tile and the LN epilogues' xhat tile take the ring's place");

// A operand of a token GEMM: the LayerNorm of x's rows gathered in window
// order (LN1), of the y rows (LN2), round(s2 * dout) gathered (dm; s2 = 1
// without drop-path scales, #12's dout), round(ctx_f), or a token matrix
// by TMA.
enum AMode { kALn1, kALn2, kADm, kARound, kATma };
// Epilogues: qkv = round(s + bqkv); y = round(xw + s1 (s + bproj)); fc1's a
// = s + b1 and round(gelu(a)); da = s gelu'(a) rounded, with its column
// partials; the LN2 backward (dy, dattn); dctx rounded or fp32; the LN1
// backward (dx), with the residual's dy (the block) or without it (#12).
enum EMode { kEQkv, kEProj, kEFc1, kEDa, kELn2, kEDctxB, kEDctxF, kELn1, kELn1NoRes };

__host__ __device__ constexpr bool ln_bwd_epilogue(int e) {
  return e == kELn1 || e == kELn2 || e == kELn1NoRes;
}

struct TokArgs {
  int T, K, N;              // token rows, depth, output columns
  int tpc;                  // 128-column tiles per CTA (1 but for the LN A loads)
  int C, H, W, ws, shift;   // the block's width and the map's geometry
  const bf16* src;          // kALn1: x (NHWC); kALn2: y rows; kADm: dout (NHWC)
  const float* srcf;        // kARound: ctx_f rows
  const float *lg, *lb;     // the LN's scale and bias (A load), its scale (epilogue)
  const float* dp;          // (B, 2) drop-path scales
  bf16 *side0, *side1;      // column tile 0 of the A load: LN rows / x rows / dm / ctx
  float* stats;             // LN (mean, inv) per row: written by the A load, read by kELn*
  const float* bias;
  const bf16* rows;         // kEProj: xw; kELn2: y; kELn1: xw
  const float* aux;         // kEDa: a; kELn1: dy
  const bf16* dout;         // kELn2: dout (NHWC)
  bf16* ob;                 // bf16 output
  float* of;                // fp32 output
  float* part;              // per row tile partials
  int cr;                   // kRealC: the real channels of the C-wide rows (zeros past them)
};

// Shared-memory bytes of a token GEMM: slack, header, ring, and A (64 x K)
// when the CTA computes it (kernels/window_attention.py::block_bwd_plan
// mirrors it).
__host__ __device__ inline size_t tok_smem(bool a_in_smem, int K) {
  return 1024 + kHead + (size_t)kRingS * kSlot + (a_in_smem ? hop::a_bytes(K) : 0);
}

// Per-row values of a token GEMM's 64 rows, in shared memory: the element
// offset of the row in the A source (the window gather of x or dout) or in
// the epilogue's NHWC map (the LN backwards' dout and dx), -1 past the
// rows; a drop-path scale; the LN statistics the epilogue reads.
struct RowInfo {
  long long off[64];
  float scale[64];
  float mean[64], inv[64];
};

template <int kA, int kE>
__device__ inline void row_setup(const TokArgs& a, RowInfo& ri, long long r0, int valid) {
  const int r = threadIdx.x;
  if (r >= 64) return;
  const int row = (int)(r0 + r), hw = a.H * a.W;
  const bool gather = kA == kALn1 || kA == kADm || ln_bwd_epilogue(kE);
  ri.off[r] = r >= valid ? -1LL
              : gather   ? (long long)token_offset(row, a.H, a.W, a.C, a.ws, a.shift)
                         : (long long)row * a.K;
  if (r < valid) {
    if (kA == kADm) ri.scale[r] = a.dp ? a.dp[2 * (row / hw) + 1] : 1.f;   // s2
    if (kE == kEProj || kE == kELn2) ri.scale[r] = a.dp[2 * (row / hw)];   // s1
    if (ln_bwd_epilogue(kE)) {
      ri.mean[r] = a.stats[2 * (size_t)row];
      ri.inv[r] = a.stats[2 * (size_t)row + 1];
    }
  }
}

// A (64 x K, K % 8 == 0) into shared memory in 16-byte chunks: the
// LayerNorm of the source rows (one warp per row, the row in registers,
// fp32 statistics), round(s2 * dout), or round(ctx_f); zero past the rows
// and past K. Column tile 0 (`side`) also writes it for later launches.
template <int kA, bool kRealC>
__device__ inline void tok_load_a(const TokArgs& a, unsigned char* as, const RowInfo& ri,
                                  long long r0, int valid, bool side) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int K = a.K, k8 = K / 8, n8 = (K + 63) / 64 * 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (kA == kALn1 || kA == kALn2) {
#pragma unroll 2
    for (int r = warp; r < 64; r += kThr / 32) {
      const long long o = ri.off[r];
      uint4 xv[3];   // chunks lane, lane + 32, lane + 64 of the row (K <= 768)
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const int j = lane + 32 * u;
        xv[u] = zero;
        if (o >= 0 && j < k8) xv[u] = __ldg(reinterpret_cast<const uint4*>(a.src + o) + j);
        const bf16* e = reinterpret_cast<const bf16*>(&xv[u]);
#pragma unroll
        for (int q = 0; q < 8; ++q) sum += bf(e[q]);
      }
      const int kn = kRealC ? a.cr : K;   // the channels the statistics run over
      const float mean = warp_sum(sum) / kn;
      float sq = 0.f;
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        if (lane + 32 * u >= k8) continue;
        const bf16* e = reinterpret_cast<const bf16*>(&xv[u]);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float dv = bf(e[q]) - mean;
          if (!kRealC || 8 * (lane + 32 * u) + q < kn) sq += dv * dv;
        }
      }
      const float inv = rsqrtf(warp_sum(sq) / kn + 1e-5f);
      const size_t row = (size_t)(r0 + r);
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const int j = lane + 32 * u;
        if (j >= n8) continue;
        uint4 ov = zero;
        if (o >= 0 && j < k8) {
          const bf16* e = reinterpret_cast<const bf16*>(&xv[u]);
          bf16* ob = reinterpret_cast<bf16*>(&ov);
#pragma unroll
          for (int q = 0; q < 8; ++q)
            ob[q] = tobf((bf(e[q]) - mean) * inv * a.lg[8 * j + q] + a.lb[8 * j + q]);
          if (side) {
            reinterpret_cast<uint4*>(a.side0 + row * K)[j] = ov;
            if (kA == kALn1) reinterpret_cast<uint4*>(a.side1 + row * K)[j] = xv[u];
          }
        }
        *reinterpret_cast<uint4*>(as + hop::a_off(r, 8 * j)) = ov;
      }
      if (side && o >= 0 && lane == 0) {
        a.stats[2 * row] = mean;
        a.stats[2 * row + 1] = inv;
      }
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < 64 * n8; i += kThr) {
      const int r = i / n8, j = i - r * n8;
      const long long o = ri.off[r];
      uint4 ov = zero;
      if (o >= 0 && j < k8) {
        bf16* ob = reinterpret_cast<bf16*>(&ov);
        if constexpr (kA == kADm) {
          const float s2 = ri.scale[r];
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(a.src + o) + j);
          const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
          for (int q = 0; q < 8; ++q) ob[q] = tobf(s2 * bf(e[q]));
        } else {
          const float4* f = reinterpret_cast<const float4*>(a.srcf + o) + 2 * j;
          const float4 f0 = __ldg(f), f1 = __ldg(f + 1);
          const float fv[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
          for (int q = 0; q < 8; ++q) ob[q] = tobf(fv[q]);
        }
        if (side) reinterpret_cast<uint4*>(a.side0 + (size_t)(r0 + r) * K)[j] = ov;
      }
      *reinterpret_cast<uint4*>(as + hop::a_off(r, 8 * j)) = ov;
    }
  }
}

// The LayerNorm backward over the CTA's columns of its 64 rows, the fp32
// products d (= dyn or du) in cs, xhat staged in xs: t = inv (d g -
// mean(d g) - xhat mean(d g xhat)), the two means over all C columns from
// every rank's row sums. kELn2: dy = dout + t (fp32), dattn = round(s1 dy);
// kELn1: dx = round(dy + t) at the token's place in the map; kELn1NoRes:
// dx = round(t) there. Then this row tile's parts of dg = sum d xhat and
// db = sum d.
template <int kE, bool kRealC>
__device__ inline void ln_epilogue(const TokArgs& a, const float* cs, float* xs, float* rs,
                                   float* mrow, const RowInfo& ri, long long r0, int valid,
                                   int n0) {
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, C = a.N;
  const int G = (int)cl.num_blocks();
#pragma unroll 4
  for (int i = tid; i < 64 * kCols / 8; i += kThr) {   // xhat, 8 columns at a time
    const int r = i / (kCols / 8), c = 8 * (i % (kCols / 8)), col = n0 + c;
    float xv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < valid && col < C) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(a.rows + (size_t)(r0 + r) * C + col));
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int q = 0; q < 8; ++q) xv[q] = (bf(e[q]) - ri.mean[r]) * ri.inv[r];
    }
    float4* dst = reinterpret_cast<float4*>(xs + r * kCsLd + c);
    dst[0] = make_float4(xv[0], xv[1], xv[2], xv[3]);
    dst[1] = make_float4(xv[4], xv[5], xv[6], xv[7]);
  }
  __syncthreads();
  for (int r = warp; r < 64; r += kThr / 32) {
    float p1 = 0.f, p2 = 0.f;
    for (int c = lane; c < kCols && n0 + c < C; c += 32) {
      const float dxh = cs[r * kCsLd + c] * a.lg[n0 + c];
      p1 += dxh;
      p2 += dxh * xs[r * kCsLd + c];
    }
    p1 = warp_sum(p1);
    p2 = warp_sum(p2);
    if (lane == 0) {
      rs[2 * r] = p1;
      rs[2 * r + 1] = p2;
    }
  }
  cl.sync();
  if (tid < 64) {
    float m1 = 0.f, m2 = 0.f;
    for (int q = 0; q < G; ++q) {   // LN row sums in rank order
      const float* o = cl.map_shared_rank(rs, q);
      m1 += o[2 * tid];
      m2 += o[2 * tid + 1];
    }
    const int cn = kRealC ? a.cr : C;   // the means run over the real channels
    mrow[2 * tid] = m1 / cn;
    mrow[2 * tid + 1] = m2 / cn;
  }
  cl.sync();   // every rank has read this CTA's sums
#pragma unroll 8
  for (int i = tid; i < 64 * kCols; i += kThr) {
    const int r = i / kCols, c = i % kCols, col = n0 + c;
    if (r >= valid || col >= C) continue;
    const size_t e = (size_t)(r0 + r) * C + col, off = (size_t)ri.off[r] + col;
    const float t = ri.inv[r] * (cs[r * kCsLd + c] * a.lg[col] - mrow[2 * r] -
                                 xs[r * kCsLd + c] * mrow[2 * r + 1]);
    if constexpr (kE == kELn2) {
      const float res = bf(a.dout[off]) + t;
      a.of[e] = res;
      a.ob[e] = tobf(ri.scale[r] * res);
    } else if constexpr (kE == kELn1) {
      a.ob[off] = tobf(a.aux[e] + t);
    } else {
      a.ob[off] = tobf(t);
    }
  }
  if (tid < kCols && n0 + tid < C) {
    float dg = 0.f, db = 0.f;
    for (int r = 0; r < valid; ++r) {
      const float d = cs[r * kCsLd + tid];
      dg += d * xs[r * kCsLd + tid];
      db += d;
    }
    a.part[(size_t)blockIdx.y * 2 * C + n0 + tid] = dg;
    a.part[(size_t)blockIdx.y * 2 * C + C + n0 + tid] = db;
  }
}

template <int kE, bool kRealC>
__device__ inline void tok_epilogue(const TokArgs& a, float* cs, float* xs, float* rs, float* mrow,
                                    const RowInfo& ri, long long r0, int valid, int n0) {
  if constexpr (ln_bwd_epilogue(kE)) {
    ln_epilogue<kE, kRealC>(a, cs, xs, rs, mrow, ri, r0, valid, n0);
  } else if constexpr (kE == kEDa) {
    // da = s gelu'(a), a's tile from device memory: a group's loads before
    // its stores, which the compiler cannot tell from a's memory
    // (interleaved, each load would wait on the stores before it); groups
    // of 8 keep the registers of a kernel with 2 CTAs per SM
    constexpr int kGroup = 8;
    const int tid = threadIdx.x, N = a.N;
#pragma unroll 1
    for (int g = 0; g < 64 * kCols / kThr; g += kGroup) {
      float av[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const int i = tid + (g + k) * kThr, r = i / kCols, col = n0 + i % kCols;
        av[k] = r < valid && col < N ? __ldg(a.aux + (size_t)(r0 + r) * N + col) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const int i = tid + (g + k) * kThr, r = i / kCols, c = i % kCols, col = n0 + c;
        if (r >= valid || col >= N) continue;
        const float t = cs[r * kCsLd + c] * gelu_grad_f(av[k]);
        a.ob[(size_t)(r0 + r) * N + col] = tobf(t);
        cs[r * kCsLd + c] = t;
      }
    }
    __syncthreads();   // the row tile's column sums of da (b1's gradient)
    if (tid < kCols && n0 + tid < N) {
      float s = 0.f;
      for (int r = 0; r < valid; ++r) s += cs[r * kCsLd + tid];
      a.part[(size_t)blockIdx.y * N + n0 + tid] = s;
    }
  } else {
    const int tid = threadIdx.x, N = a.N;
#pragma unroll 8
    for (int i = tid; i < 64 * kCols; i += kThr) {
      const int r = i / kCols, c = i % kCols, col = n0 + c;
      if (r >= valid || col >= N) continue;
      const size_t e = (size_t)(r0 + r) * N + col;
      const float v = cs[r * kCsLd + c];
      if constexpr (kE == kEQkv) {
        a.ob[e] = tobf(v + (a.bias ? a.bias[col] : 0.f));
      } else if constexpr (kE == kEProj) {
        a.ob[e] = tobf(bf(a.rows[e]) + ri.scale[r] * (v + a.bias[col]));
      } else if constexpr (kE == kEFc1) {
        const float t = v + a.bias[col];
        a.of[e] = t;
        a.ob[e] = tobf(gelu_f(t));
      } else if constexpr (kE == kEDctxB) {
        a.ob[e] = tobf(v);
      } else {
        a.of[e] = v;
      }
    }
  }
}

// One 64-row tile (blockIdx.y) x a.tpc 128-column tiles from tile
// blockIdx.x * a.tpc, one after another on the same A; for kELn* the row
// tile's CTAs are one cluster and blockIdx.x is the rank.
template <int kA, bool kBK, int kE, bool kRealC = false>
__global__ void __launch_bounds__(kThr, 1)
    tok_gemm_kernel(const __grid_constant__ TokArgs a, const __grid_constant__ CUtensorMap ma,
                    const __grid_constant__ CUtensorMap mb) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + kRingS;
  float* rs = reinterpret_cast<float*>(base + 256);   // this CTA's LN row sums [64][2]
  float* mrow = rs + 128;                              // the rows' means [64][2]
  RowInfo& ri = *reinterpret_cast<RowInfo*>(base + 1280);
  unsigned char* ring = base + kHead;
  unsigned char* as = ring + (size_t)kRingS * kSlot;
  float* cs = reinterpret_cast<float*>(ring);   // a tile's fp32 sums, once the ring is spent
  float* xs = cs + 64 * kCsLd;                  // the LN epilogues' xhat tile
  const int tid = threadIdx.x, wg = tid >> 7, t128 = tid & 127;
  const long long r0 = (long long)blockIdx.y * 64;
  const int valid = (int)min(64LL, (long long)a.T - r0);
  const int nch = (a.K + 63) / 64;
  const int t0 = blockIdx.x * a.tpc, t1 = min((a.N + kCols - 1) / kCols, t0 + a.tpc);
  if (tid == 0) {
    for (int s = 0; s < kRingS; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], kThr);
    }
    hop::mbar_fence_init();
  }
  row_setup<kA, kE>(a, ri, r0, valid);
  __syncthreads();
  // chunk q of this CTA's sequence: column tile t0 + q / nch, rows c * 64
  // of B (c = q % nch)
  auto issue = [&](int q) {
    const int s = q % kRingS, c = q % nch, n0 = (t0 + q / nch) * kCols;
    const int nb = min(2, hop::nboxes(a.N - n0));
    unsigned char* slot = ring + (size_t)s * kSlot;
    hop::mbar_expect_tx(&full[s], (uint32_t)(((kA == kATma) ? 1 : 0) + nb) * kBoxB);
    if constexpr (kA == kATma) hop::tma_load(slot, &ma, &full[s], c * 64, (int)r0);
    for (int j = 0; j < nb; ++j) {
      if constexpr (kBK) hop::tma_load(slot + (1 + j) * kBoxB, &mb, &full[s], c * 64, n0 + 64 * j);
      else hop::tma_load(slot + (1 + j) * kBoxB, &mb, &full[s], n0 + 64 * j, c * 64);
    }
  };
  if (tid == 0)
    for (int c = 0; c < min(kRingS, nch); ++c) issue(c);
  if constexpr (kA != kATma) {
    tok_load_a<kA, kRealC>(a, as, ri, r0, valid, blockIdx.x == 0);
    hop::fence_async_smem();
  }
  __syncthreads();
  for (int nt = t0; nt < t1; ++nt) {
    const int qb = (nt - t0) * nch, n0 = nt * kCols;
    if (nt > t0 && tid == 0)   // the ring is free again: the tile's first chunks
      for (int c = 0; c < min(kRingS, nch); ++c) issue(qb + c);
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    // A warpgroup without a box (N - n0 <= 64) runs its products on a stale
    // slot and its sums are never written: no branch around the wgmmas.
    for (int c = 0; c < nch; ++c) {
      const int q = qb + c, s = q % kRingS;
      hop::mbar_wait(&full[s], (uint32_t)((q / kRingS) & 1));
      const unsigned char* slot = ring + (size_t)s * kSlot;
      const unsigned char* bbox = slot + (1 + wg) * kBoxB;
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 64; kk += 16) {
        const uint64_t ad = kA == kATma ? hop::a_desc(slot, kk) : hop::a_desc(as, c * 64 + kk);
        if constexpr (kBK) hop::wgmma64_kmajor(acc, ad, hop::a_desc(bbox, kk), 1);
        else hop::wgmma64(acc, ad, hop::b_desc(bbox, kk), 1);
      }
      hop::wg_commit();
      hop::wg_wait0();
      hop::mbar_arrive(&empty[s]);
      if (tid == 0 && c + kRingS < nch) {
        hop::mbar_wait(&empty[s], (uint32_t)((q / kRingS) & 1));
        issue(q + kRingS);
      }
    }
    __syncthreads();   // the tile's products are done: its sums take the ring's place
#pragma unroll
    for (int i = 0; i < 32; ++i)
      cs[hop::acc_row(t128, i) * kCsLd + wg * 64 + hop::acc_col(t128, i)] = acc[i];
    __syncthreads();
    tok_epilogue<kE, kRealC>(a, cs, xs, rs, mrow, ri, r0, valid, n0);
    __syncthreads();   // the epilogue has read the tile before the next tile's loads land
  }
}

// Column tiles per CTA of a token GEMM whose A is the LayerNorm of its rows:
// as many as keep a kPlanBatch-image launch within ~kFillCtas CTAs, so that
// the LN is computed once per row tile where the rows fill the card (the
// other A loads are cheap beside their epilogues, whose tiles then run in
// parallel; kernels/window_attention.py::block_bwd_plan mirrors it).
inline int tok_tiles_per_cta(int tiles, int hw) {
  const int rows = (kPlanBatch * hw + 63) / 64;
  return std::min(tiles, std::max(1, (tiles * rows + kFillCtas - 1) / kFillCtas));
}

// Launch one token GEMM; amat: A's token matrix (T x K) for kATma; w: the
// weight (wrows x wcols, row-major), read as W (kBK false: K x N) or W^T
// (kBK true: N x K).
template <int kA, bool kBK, int kE, bool kRealC = false>
inline cudaError_t tok_gemm(const TokArgs& a, const void* amat, const void* w, int wrows,
                            int wcols, cudaStream_t st, int* n) {
  CUtensorMap ma, mb;
  memset(&ma, 0, sizeof(ma));
  if (kA == kATma) SUNET_TRY(hop::weight_map(&ma, amat, a.T, a.K, 64));
  SUNET_TRY(hop::weight_map(&mb, w, wrows, wcols, 64));
  const int tiles = (a.N + kCols - 1) / kCols;
  const bool ln = ln_bwd_epilogue(kE);
  TokArgs t = a;
  t.tpc = kA == kALn1 || kA == kALn2 ? tok_tiles_per_cta(tiles, a.H * a.W) : 1;
  SUNET_TRY(hop::launch_cluster(tok_gemm_kernel<kA, kBK, kE, kRealC>,
                                dim3((tiles + t.tpc - 1) / t.tpc, (a.T + 63) / 64), kThr,
                                tok_smem(kA != kATma, a.K), st, ln ? tiles : 1, t, ma, mb));
  return launched(n);
}

// ---------------------------------------------------------------- weight gradients

constexpr int kWgProducts = 4;

struct WgProduct {
  int M, N;        // dW is M x N
  int mt, first;   // 64-row tiles of M; the product's first CTA in the table
  float* part;     // [chunk][M][N]
  float* pbias;    // [chunk][N]: column sums of dB (bf16), or null
};

struct WgArgs {
  WgProduct p[kWgProducts];
  int np;                  // products in p (the block's four, #12's two)
  int T, chunk, nchunks;   // tokens, tokens per chunk (a multiple of 64), chunks
};

struct WgMaps {
  CUtensorMap x[kWgProducts], d[kWgProducts];   // X (T x M) and dB (T x N), 64 x 64 boxes
};

__host__ __device__ inline int wg_tiles(int M, int N) {
  return ((M + 63) / 64) * ((N + kCols - 1) / kCols);
}

// CTA `bid` of a weight-gradient launch: product p (in order), then output
// tile (64-row tiles of M fastest), then token chunk, the chunk fastest
// (kernels/window_attention.py::block_bwd_wgrad_table mirrors it). A and m
// are the launch's __grid_constant__ parameters (the tensor maps stay in
// parameter space).
__device__ __forceinline__ void wgrad_cta(const WgArgs& a, const WgMaps& m, int bid) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + kRingS;
  unsigned char* ring = base + kHead;
  const int tid = threadIdx.x, wg = tid >> 7, t128 = tid & 127;
  int pi = 0;
  while (pi + 1 < a.np && bid >= a.p[pi + 1].first) ++pi;
  const WgProduct& p = a.p[pi];
  const int local = bid - p.first;
  const int ch = local % a.nchunks, tile = local / a.nchunks;
  const int m0 = (tile % p.mt) * 64, n0 = (tile / p.mt) * kCols;
  const int t0 = ch * a.chunk, steps = (min(a.T, t0 + a.chunk) - t0 + 63) / 64;
  const int nb = min(2, hop::nboxes(p.N - n0));
  const CUtensorMap* mx = &m.x[pi];
  const CUtensorMap* md = &m.d[pi];
  if (tid == 0) {
    for (int s = 0; s < kRingS; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], kThr);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int c) {
    const int s = c % kRingS;
    unsigned char* slot = ring + (size_t)s * kSlot;
    const int t = t0 + c * 64;
    hop::mbar_expect_tx(&full[s], (uint32_t)(1 + nb) * kBoxB);
    hop::tma_load(slot, mx, &full[s], m0, t);
    for (int j = 0; j < nb; ++j) hop::tma_load(slot + (1 + j) * kBoxB, md, &full[s], n0 + 64 * j, t);
  };
  if (tid == 0)
    for (int c = 0; c < min(kRingS, steps); ++c) issue(c);
  const bool colsum = p.pbias != nullptr && m0 == 0 && t128 < 64;
  float cs = 0.f;   // column wg * 64 + t128 of dB summed over the chunk
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int c = 0; c < steps; ++c) {
    const int s = c % kRingS;
    hop::mbar_wait(&full[s], (uint32_t)((c / kRingS) & 1));
    const unsigned char* slot = ring + (size_t)s * kSlot;
    const unsigned char* dbox = slot + (1 + wg) * kBoxB;
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16)
      hop::wgmma64_tt(acc, hop::b_desc(slot, kk), hop::b_desc(dbox, kk), 1);
    hop::wg_commit();
    if (colsum) {   // the bias gradient: dB's column from the swizzled tile
      for (int r = 0; r < 64; ++r)
        cs += bf(*reinterpret_cast<const bf16*>(
            dbox + r * 128 + ((((t128 >> 3) ^ (r & 7)) << 4) + (t128 & 7) * 2)));
    }
    hop::wg_wait0();
    hop::mbar_arrive(&empty[s]);
    if (tid == 0 && c + kRingS < steps) {
      hop::mbar_wait(&empty[s], (uint32_t)((c / kRingS) & 1));
      issue(c + kRingS);
    }
  }
  float* out = p.part + (size_t)ch * p.M * p.N;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int mm = m0 + hop::acc_row(t128, i), nn = n0 + wg * 64 + hop::acc_col(t128, i);
    if (mm < p.M && nn < p.N) out[(size_t)mm * p.N + nn] = acc[i];   // the chunk's partial
  }
  if (colsum && n0 + wg * 64 + t128 < p.N)
    p.pbias[(size_t)ch * p.N + n0 + wg * 64 + t128] = cs;
}

static __global__ void __launch_bounds__(kThr, 1)
    wgrad_kernel(const __grid_constant__ WgArgs a, const __grid_constant__ WgMaps m) {
  wgrad_cta(a, m, (int)blockIdx.x);
}

inline size_t wgrad_smem() { return 1024 + kHead + (size_t)kRingS * kSlot; }

// ---------------------------------------------------------------- the sums

constexpr int kSumSegs = 13;
constexpr int kSumWarpS = 32;   // a segment of at least this many partials is summed by warps

struct SumSeg {
  const float* src;   // S partials of L values, `stride` floats apart
  float* dst;
  int S, L;
  long long stride;
};

struct SumArgs {
  SumSeg s[kSumSegs];
  long long total[2];   // values of the segments summed by threads, by warps
};

// The segment of the warp (or thread) segments' value `off`, and off
// within it.
__device__ inline const SumSeg& sum_seg(const SumArgs& a, bool warp, long long& off) {
  int k = 0;
  for (;; ++k) {
    if ((a.s[k].S >= kSumWarpS) != warp) continue;
    if (off < a.s[k].L) break;
    off -= a.s[k].L;
  }
  return a.s[k];
}

// dst[i] = sum over z < S of src[z * stride + i] for every segment, z in
// order by one thread where S < kSumWarpS; else by one warp, lane l summing
// z = l, l + 32, ... in order before a fixed butterfly (the same bits every
// run either way).
static __global__ void __launch_bounds__(kThr) sum_kernel(const __grid_constant__ SumArgs a) {
  const int lane = threadIdx.x & 31;
  for (long long i = blockIdx.x * (long long)kThr + threadIdx.x; i < a.total[0];
       i += (long long)gridDim.x * kThr) {
    long long off = i;
    const SumSeg& g = sum_seg(a, false, off);
    float v = 0.f;
#pragma unroll 8
    for (int z = 0; z < g.S; ++z) v += g.src[z * g.stride + off];
    g.dst[off] = v;
  }
  const long long nw = (long long)gridDim.x * (kThr / 32);
  for (long long i = blockIdx.x * (long long)(kThr / 32) + (threadIdx.x >> 5); i < a.total[1];
       i += nw) {
    long long off = i;
    const SumSeg& g = sum_seg(a, true, off);
    float v = 0.f;
#pragma unroll 4
    for (int z = lane; z < g.S; z += 32) v += g.src[z * g.stride + off];
    v = warp_sum(v);
    if (lane == 0) g.dst[off] = v;
  }
}

// ---------------------------------------------------------------- attention

constexpr int kAThr = 128;           // four warps, one per 16 rows of a window
constexpr int kGroupTiles = 8;       // 8-column tiles of dk and dv per pass over the fragments
constexpr int kAttnFillCtas = 528;   // CTAs the backward aims at (4 per SM)

enum AttnMode { kAttnFwd, kAttnBwd, kAttnBwdRes };

struct AttnArgs {
  const bf16* qkv;            // (T, 3C): q (unscaled), k, v
  const bf16* dctxb;          // kAttnBwd: round(dattn wproj^T) (T, C)
  const float* dctxf;         // kAttnBwdRes: dattn wproj^T (T, C)
  const float *bias, *mask;   // kAttnFwd/kAttnBwd: (heads, N, N), (nW, N, N) or null
  const bf16* eb;             // kAttnBwdRes: (nwin, heads, N, N)
  const float *rden, *ctxf;   // kAttnBwdRes: (nwin, heads, N), (T, C)
  bf16* ctx;                  // kAttnFwd: (T, C)
  bf16* dqkv;                 // (T, 3C): round(dq), round(dk), round(dv)
  float *pbias, *pqkv;        // [chunk][heads][N][N], [chunk][3C]
  int C, heads, d, N, nW, nwin, wpc;
  float scale;
};

// Shared memory of the attention for N tokens and the head dim rounded up
// to 16 (dp): q, k (and v, dctx) as N rows of dp + 8; k^T (v^T in the
// forward), q^T and dctx^T as dp rows of N + 8; round(P)^T and round(ds)^T
// as N rows of N + 8; then the backwards' floats (the residual route's
// per-pair t sums for a head dim up to 64, the window's dp column sums per
// warp, the chunk's).
// kernels/window_attention.py::block_bwd_plan mirrors it.
struct AttnLayout {
  int ldd, ldn;   // row strides (elements) of the N x dp and the dp x N, N x N matrices
  size_t q, k, kt, v, o, qt, ot, pt, dst, fl, fwd_bytes, bytes;
};

__host__ __device__ inline AttnLayout attn_layout(int N, int dp) {
  AttnLayout l;
  l.ldd = dp + 8;
  l.ldn = N + 8;
  const size_t rd = align128((size_t)N * l.ldd * 2), tn = align128((size_t)dp * l.ldn * 2),
               nn = align128((size_t)N * l.ldn * 2);
  l.q = 0;
  l.k = rd;
  l.kt = 2 * rd;
  l.fwd_bytes = 2 * rd + tn;
  l.v = l.fwd_bytes;
  l.o = l.v + rd;
  l.qt = l.o + rd;
  l.ot = l.qt + tn;
  l.pt = l.ot + tn;
  l.dst = l.pt + nn;
  l.fl = l.dst + nn;
  l.bytes = l.fl + (size_t)(64 * 32 + 4 * 3 * dp + 3 * dp) * 4;
  return l;
}

__device__ inline uint32_t ldg32(const void* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// The A fragment of rows i0 .. i0 + 15, columns k0 .. k0 + 15 of a bf16
// matrix with row stride ld.
__device__ inline void frag_a(uint32_t (&f)[4], const bf16* m, int ld, int i0, int k0, int g,
                              int t2) {
  const bf16* p = m + (i0 + g) * ld + k0 + t2;
  f[0] = ld32(p);
  f[1] = ld32(p + 8 * ld);
  f[2] = ld32(p + 8);
  f[3] = ld32(p + 8 * ld + 8);
}

// One head of a chunk of windows per CTA: grid (heads, chunks of wpc
// windows). Rows of window wg are tokens wg*N .. wg*N + N - 1.
template <int kMode>
__global__ void __launch_bounds__(kAThr) attn_tc_kernel(const AttnArgs a) {
  extern __shared__ __align__(16) unsigned char sm_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2,
            t2 = (lane & 3) * 2;
  const int hh = blockIdx.x, C = a.C, d = a.d, N = a.N, dp = (d + 15) & ~15;
  const AttnLayout L = attn_layout(N, dp);
  const int ldd = L.ldd, ldn = L.ldn;
  bf16* qs = reinterpret_cast<bf16*>(sm_raw + L.q);     // round(q scale) rows
  bf16* ks = reinterpret_cast<bf16*>(sm_raw + L.k);     // k rows
  bf16* kT = reinterpret_cast<bf16*>(sm_raw + L.kt);    // k^T (v^T in kAttnFwd)
  bf16* vs = reinterpret_cast<bf16*>(sm_raw + L.v);     // v rows
  bf16* os = reinterpret_cast<bf16*>(sm_raw + L.o);     // dctx rows (round(dn), residual route)
  bf16* qT = reinterpret_cast<bf16*>(sm_raw + L.qt);    // round(q scale)^T
  bf16* oT = reinterpret_cast<bf16*>(sm_raw + L.ot);    // dctx^T
  bf16* PT = reinterpret_cast<bf16*>(sm_raw + L.pt);    // round(P)^T (e^T, residual route)
  bf16* dsT = reinterpret_cast<bf16*>(sm_raw + L.dst);  // round(ds)^T
  float* tpair = reinterpret_cast<float*>(sm_raw + L.fl);   // residual route: t per column pair
  float* red = tpair + 64 * 32;                 // [warp][q, k, v][dp columns] of one window
  float* colacc = red + 4 * 3 * dp;             // [q, k, v][dp columns] over the chunk
  const int i0 = warp * 16;
  const bool strip = i0 < N;
  const int w0 = blockIdx.y * a.wpc, w1 = min(a.nwin, w0 + a.wpc);
  const int P = dp >> 1, total = N * P;   // column pairs of a window's rows
  float db[8][4];   // ds of this thread's entries, summed over the chunk's windows
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) db[nt][0] = db[nt][1] = db[nt][2] = db[nt][3] = 0.f;
  if constexpr (kMode != kAttnFwd)
    for (int i = tid; i < 3 * dp; i += kAThr) colacc[i] = 0.f;
  float bsv[8][4];   // the recompute forms: this thread's rel-pos bias entries
  if constexpr (kMode != kAttnBwdRes) {
    const float* bh = a.bias + (size_t)hh * N * N;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int j = nt * 8 + t2, ra = i0 + g, rb = ra + 8;
      const bool in = strip && nt * 8 < N;
      bsv[nt][0] = in ? bh[ra * N + j] : 0.f;
      bsv[nt][1] = in ? bh[ra * N + j + 1] : 0.f;
      bsv[nt][2] = in ? bh[rb * N + j] : 0.f;
      bsv[nt][3] = in ? bh[rb * N + j + 1] : 0.f;
    }
  }

  // round(o) of matrix mat (0 q, 1 k, 2 v) at rows r0 + i0 + g (+8),
  // columns dt*8 + t2 (+1) into dqkv; this warp's column sums into red.
  auto store = [&](int mat, int dt, const float (&o)[4], size_t r0) {
    const int c = dt * 8 + t2;
    float v0 = o[0] + o[2], v1 = o[1] + o[3];
#pragma unroll
    for (int m = 4; m <= 16; m <<= 1) {
      v0 += __shfl_xor_sync(0xffffffffu, v0, m);
      v1 += __shfl_xor_sync(0xffffffffu, v1, m);
    }
    if (c >= d) return;   // d is even: the pair is whole
    const size_t e = (r0 + i0 + g) * 3 * C + mat * C + hh * d + c;
    *reinterpret_cast<uint32_t*>(a.dqkv + e) = pack_bf2(o[0], o[1]);
    *reinterpret_cast<uint32_t*>(a.dqkv + e + 8 * 3 * (size_t)C) = pack_bf2(o[2], o[3]);
    if (g == 0) {
      red[(warp * 3 + mat) * dp + c] = v0;
      red[(warp * 3 + mat) * dp + c + 1] = v1;
    }
  };

  for (int wg = w0; wg < w1; ++wg) {
    const size_t row0 = (size_t)wg * N;
    const size_t sh = (size_t)wg * a.heads + hh;   // the window's head in eb / rden
    // the window's operands, four column pairs per thread per round, every
    // load of a round in flight at once; zero past the head dim
    for (int base = 0; base < total; base += 4 * kAThr) {
      uint32_t rq[4], rk[4], rv[4], ro[4];
      float2 rf[4], rc[4];
      float rr[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * kAThr + tid;
        rq[u] = rk[u] = rv[u] = ro[u] = 0u;
        rf[u] = rc[u] = make_float2(0.f, 0.f);
        rr[u] = 0.f;
        if (i >= total) continue;
        const int t = i / P, c = 2 * (i - t * P);
        if (c >= d) continue;
        const size_t q = (row0 + t) * 3 * C + hh * d + c;
        rq[u] = ldg32(a.qkv + q);
        rk[u] = ldg32(a.qkv + q + C);
        rv[u] = ldg32(a.qkv + q + 2 * C);
        const size_t o = (row0 + t) * C + hh * d + c;
        if constexpr (kMode == kAttnBwd) {
          ro[u] = ldg32(a.dctxb + o);
        } else if constexpr (kMode == kAttnBwdRes) {
          rf[u] = __ldg(reinterpret_cast<const float2*>(a.dctxf + o));
          rc[u] = __ldg(reinterpret_cast<const float2*>(a.ctxf + o));
          rr[u] = __ldg(a.rden + sh * N + t);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * kAThr + tid;
        if (i >= total) continue;
        const int t = i / P, c = 2 * (i - t * P);
        const bf16* qp = reinterpret_cast<const bf16*>(&rq[u]);
        const uint32_t qv = pack_bf2(bf(qp[0]) * a.scale, bf(qp[1]) * a.scale);
        *reinterpret_cast<uint32_t*>(qs + t * ldd + c) = qv;
        *reinterpret_cast<uint32_t*>(ks + t * ldd + c) = rk[u];
        const bf16* vp = reinterpret_cast<const bf16*>(&rv[u]);
        if constexpr (kMode == kAttnFwd) {
          kT[c * ldn + t] = vp[0];
          kT[(c + 1) * ldn + t] = vp[1];
        } else {
          uint32_t ov = ro[u];
          if constexpr (kMode == kAttnBwdRes) {
            const float dn0 = rf[u].x * rr[u], dn1 = rf[u].y * rr[u];
            ov = pack_bf2(dn0, dn1);
            tpair[t * 32 + (c >> 1)] = bf(tobf(dn0 * rc[u].x)) + bf(tobf(dn1 * rc[u].y));
          }
          const bf16* kp = reinterpret_cast<const bf16*>(&rk[u]);
          const bf16* qq = reinterpret_cast<const bf16*>(&qv);
          const bf16* op = reinterpret_cast<const bf16*>(&ov);
          *reinterpret_cast<uint32_t*>(vs + t * ldd + c) = rv[u];
          *reinterpret_cast<uint32_t*>(os + t * ldd + c) = ov;
          kT[c * ldn + t] = kp[0];
          kT[(c + 1) * ldn + t] = kp[1];
          qT[c * ldn + t] = qq[0];
          qT[(c + 1) * ldn + t] = qq[1];
          oT[c * ldn + t] = op[0];
          oT[(c + 1) * ldn + t] = op[1];
        }
      }
    }
    if constexpr (kMode == kAttnBwdRes) {   // e^T
      const uint4* ew = reinterpret_cast<const uint4*>(a.eb + sh * N * N);
      const int n8 = N * N / 8;
      uint4 re[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = u * kAThr + tid;
        re[u] = i < n8 ? __ldg(ew + i) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = u * kAThr + tid;
        if (i >= n8) continue;
        const int ii = (8 * i) / N, j0 = 8 * i - ii * N;
        const bf16* e = reinterpret_cast<const bf16*>(&re[u]);
#pragma unroll
        for (int q = 0; q < 8; ++q) PT[(j0 + q) * ldn + ii] = e[q];
      }
    }
    __syncthreads();

    float s[8][4];   // this strip's scores, then P (fp32); e on the residual route
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    if (strip) {
      if constexpr (kMode != kAttnBwdRes) {
        for (int k0 = 0; k0 < dp; k0 += 16) {
          uint32_t af[4];
          frag_a(af, qs, ldd, i0, k0, g, t2);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            if (nt * 8 >= N) break;
            const bf16* kb = ks + (nt * 8 + g) * ldd + k0 + t2;
            mma16816(s[nt], af, ld32(kb), ld32(kb + 8));
          }
        }
        const float* mw = a.mask ? a.mask + (size_t)(wg % a.nW) * N * N : nullptr;
        const int ra = i0 + g, rb = ra + 8;
        float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt * 8 >= N) break;
          const int j = nt * 8 + t2;
          s[nt][0] += bsv[nt][0];
          s[nt][1] += bsv[nt][1];
          s[nt][2] += bsv[nt][2];
          s[nt][3] += bsv[nt][3];
          if (mw) {
            s[nt][0] += mw[ra * N + j];
            s[nt][1] += mw[ra * N + j + 1];
            s[nt][2] += mw[rb * N + j];
            s[nt][3] += mw[rb * N + j + 1];
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
        for (int nt = 0; nt < 8; ++nt) {
          if (nt * 8 >= N) break;
          s[nt][0] = expf(s[nt][0] - m0);
          s[nt][1] = expf(s[nt][1] - m0);
          s[nt][2] = expf(s[nt][2] - m1);
          s[nt][3] = expf(s[nt][3] - m1);
          l0 += s[nt][0] + s[nt][1];
          l1 += s[nt][2] + s[nt][3];
        }
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          l0 += __shfl_xor_sync(0xffffffffu, l0, o);
          l1 += __shfl_xor_sync(0xffffffffu, l1, o);
        }
        // P = e * (1 / l): a division per entry would take its slow path on
        // the many subnormal e of a near one-hot row
        const float q0 = __frcp_rn(l0), q1 = __frcp_rn(l1);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          s[nt][0] *= q0;
          s[nt][1] *= q0;
          s[nt][2] *= q1;
          s[nt][3] *= q1;
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt * 8 >= N) break;
          const int j = nt * 8 + t2;
          s[nt][0] = bf(PT[j * ldn + i0 + g]);
          s[nt][1] = bf(PT[(j + 1) * ldn + i0 + g]);
          s[nt][2] = bf(PT[j * ldn + i0 + g + 8]);
          s[nt][3] = bf(PT[(j + 1) * ldn + i0 + g + 8]);
        }
      }
    }

    if constexpr (kMode == kAttnFwd) {
      if (strip) {   // ctx = round(round(P) @ v)
        uint32_t pf[4][4];
#pragma unroll
        for (int kt = 0; kt < 4; ++kt) {
          pf[kt][0] = pack_bf2(s[2 * kt][0], s[2 * kt][1]);
          pf[kt][1] = pack_bf2(s[2 * kt][2], s[2 * kt][3]);
          pf[kt][2] = pack_bf2(s[2 * kt + 1][0], s[2 * kt + 1][1]);
          pf[kt][3] = pack_bf2(s[2 * kt + 1][2], s[2 * kt + 1][3]);
        }
        for (int dt = 0; dt * 8 < dp; ++dt) {
          float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kt = 0; kt < 4; ++kt) {
            if (kt * 16 >= N) break;
            const bf16* vb = kT + (dt * 8 + g) * ldn + kt * 16 + t2;
            mma16816(o, pf[kt], ld32(vb), ld32(vb + 8));
          }
          const int c = dt * 8 + t2;
          if (c < d) {   // d is even: the pair is whole
            *reinterpret_cast<uint32_t*>(a.ctx + (row0 + i0 + g) * C + hh * d + c) =
                pack_bf2(o[0], o[1]);
            *reinterpret_cast<uint32_t*>(a.ctx + (row0 + i0 + g + 8) * C + hh * d + c) =
                pack_bf2(o[2], o[3]);
          }
        }
      }
      __syncthreads();
      continue;
    }

    if (strip) {
      // dP = dctx v^T (residual route: round(dn) v^T)
      float dpv[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) dpv[nt][0] = dpv[nt][1] = dpv[nt][2] = dpv[nt][3] = 0.f;
      for (int k0 = 0; k0 < dp; k0 += 16) {
        uint32_t af[4];
        frag_a(af, os, ldd, i0, k0, g, t2);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt * 8 >= N) break;
          const bf16* vb = vs + (nt * 8 + g) * ldd + k0 + t2;
          mma16816(dpv[nt], af, ld32(vb), ld32(vb + 8));
        }
      }
      float rd0 = 0.f, rd1 = 0.f;   // rowsum(dP * P), or the residual route's t
      if constexpr (kMode == kAttnBwd) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt * 8 >= N) break;
          rd0 += dpv[nt][0] * s[nt][0] + dpv[nt][1] * s[nt][1];
          rd1 += dpv[nt][2] * s[nt][2] + dpv[nt][3] * s[nt][3];
        }
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          rd0 += __shfl_xor_sync(0xffffffffu, rd0, o);
          rd1 += __shfl_xor_sync(0xffffffffu, rd1, o);
        }
      } else {
        for (int k = 0; k < P; ++k) {   // the row's column pairs in order
          rd0 += tpair[(i0 + g) * 32 + k];
          rd1 += tpair[(i0 + g + 8) * 32 + k];
        }
      }
      // ds = P (dP - rd): summed for dbias, rounded into registers (dq) and
      // transposed into shared memory (dk), with round(P) (dv)
      uint32_t dsf[4][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt * 8 >= N) break;
        const int j = nt * 8 + t2, ia = i0 + g, ib = ia + 8;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          dpv[nt][u] = s[nt][u] * (dpv[nt][u] - (u < 2 ? rd0 : rd1));
          db[nt][u] += dpv[nt][u];
        }
        dsT[j * ldn + ia] = tobf(dpv[nt][0]);
        dsT[(j + 1) * ldn + ia] = tobf(dpv[nt][1]);
        dsT[j * ldn + ib] = tobf(dpv[nt][2]);
        dsT[(j + 1) * ldn + ib] = tobf(dpv[nt][3]);
        if constexpr (kMode == kAttnBwd) {
          PT[j * ldn + ia] = tobf(s[nt][0]);
          PT[(j + 1) * ldn + ia] = tobf(s[nt][1]);
          PT[j * ldn + ib] = tobf(s[nt][2]);
          PT[(j + 1) * ldn + ib] = tobf(s[nt][3]);
        }
      }
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        if (kt * 16 >= N) break;
        dsf[kt][0] = pack_bf2(dpv[2 * kt][0], dpv[2 * kt][1]);
        dsf[kt][1] = pack_bf2(dpv[2 * kt][2], dpv[2 * kt][3]);
        dsf[kt][2] = pack_bf2(dpv[2 * kt + 1][0], dpv[2 * kt + 1][1]);
        dsf[kt][3] = pack_bf2(dpv[2 * kt + 1][2], dpv[2 * kt + 1][3]);
      }
      // dq = round(ds) k * scale
      for (int dt = 0; dt * 8 < dp; ++dt) {
        float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kt = 0; kt < 4; ++kt) {
          if (kt * 16 >= N) break;
          const bf16* kb = kT + (dt * 8 + g) * ldn + kt * 16 + t2;
          mma16816(o, dsf[kt], ld32(kb), ld32(kb + 8));
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) o[u] *= a.scale;
        store(0, dt, o, row0);
      }
    }
    __syncthreads();   // round(ds)^T and round(P)^T are whole
    if (strip) {   // rows j = i0 .. i0 + 15: dk = round(ds)^T round(q scale), dv = P^T dctx
      for (int t0 = 0; t0 * 8 < dp; t0 += kGroupTiles) {   // eight column tiles at a time
        float ok[kGroupTiles][4], ov[kGroupTiles][4];
#pragma unroll
        for (int j = 0; j < kGroupTiles; ++j)
          ok[j][0] = ok[j][1] = ok[j][2] = ok[j][3] = ov[j][0] = ov[j][1] = ov[j][2] = ov[j][3] = 0.f;
#pragma unroll
        for (int kt = 0; kt < 4; ++kt) {
          if (kt * 16 >= N) break;
          uint32_t fd[4], fp[4];
          frag_a(fd, dsT, ldn, i0, kt * 16, g, t2);
          frag_a(fp, PT, ldn, i0, kt * 16, g, t2);
#pragma unroll
          for (int j = 0; j < kGroupTiles; ++j) {
            const int dt = t0 + j;
            if (dt * 8 >= dp) break;
            const bf16* qb = qT + (dt * 8 + g) * ldn + kt * 16 + t2;
            const bf16* ob = oT + (dt * 8 + g) * ldn + kt * 16 + t2;
            mma16816(ok[j], fd, ld32(qb), ld32(qb + 8));
            mma16816(ov[j], fp, ld32(ob), ld32(ob + 8));
          }
        }
#pragma unroll
        for (int j = 0; j < kGroupTiles; ++j) {
          if ((t0 + j) * 8 >= dp) break;
          store(1, t0 + j, ok[j], row0);   // dk
          store(2, t0 + j, ov[j], row0);   // dv
        }
      }
    }
    __syncthreads();   // red is whole; the operands may be overwritten
    for (int i = tid; i < 3 * dp; i += kAThr) {
      const int c = i % dp;
      if (c >= d) continue;
      float v = 0.f;
      for (int w = 0; w * 16 < N; ++w) v += red[(w * 3 + i / dp) * dp + c];   // warps in order
      colacc[i] += v;
    }
  }
  if constexpr (kMode != kAttnFwd) {
    if (strip) {
      float* out = a.pbias + ((size_t)blockIdx.y * a.heads + hh) * N * N;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt * 8 >= N) break;
        const int j = nt * 8 + t2, ia = i0 + g, ib = ia + 8;
        out[ia * N + j] = db[nt][0];
        out[ia * N + j + 1] = db[nt][1];
        out[ib * N + j] = db[nt][2];
        out[ib * N + j + 1] = db[nt][3];
      }
    }
    for (int i = tid; i < 3 * dp; i += kAThr) {
      const int c = i % dp;
      if (c < d) a.pqkv[(size_t)blockIdx.y * 3 * C + (i / dp) * C + hh * d + c] = colacc[i];
    }
  }
}

// Launch the attention over nwin windows in chunks of a.wpc, grid (heads,
// chunks).
template <int kMode>
inline cudaError_t attn_tc(const AttnArgs& a, cudaStream_t st, int* n) {
  const AttnLayout L = attn_layout(a.N, (a.d + 15) & ~15);
  const size_t smem = kMode == kAttnFwd ? L.fwd_bytes : L.bytes;
  SUNET_TRY(set_smem(attn_tc_kernel<kMode>, smem));
  attn_tc_kernel<kMode>
      <<<dim3(a.heads, (a.nwin + a.wpc - 1) / a.wpc), kAThr, smem, st>>>(a);
  return launched(n);
}

}  // namespace bb
}  // namespace sunet
