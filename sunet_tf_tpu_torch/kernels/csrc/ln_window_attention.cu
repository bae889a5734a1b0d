// LN + window partition + W-MSA + reverse + proj, no residual: three
// launches.
//
// Replaces sunet_tf_tpu/kernels/window_attention.py::fused_ln_window_attention
// on the blocks the whole-block kernel does not take (C=768 at the 8x8
// bottleneck of the default model, where one window holds the whole map;
// head dims above 64, e.g. C=384 with 2 heads). Rounding points as the JAX
// kernel: LN in fp32, rounded; qkv = round(xn @ wqkv + bqkv), q =
// round(q * scale); s = q k^T + bias (+ mask) in fp32, row-max softmax;
// ctx = round((round(e) @ v) / sum(e)); out = round(ctx @ wproj + bproj).
//
// What bounds it on Hopper: at batch 4 (8,8,768) the products are 1.26
// GFLOP (1.3 us at the bf16 peak) against 4.7 MB of bf16 weights and 0.8 MB
// of activations (1.6 us at 3.35 TB/s): the bytes. The attention itself is
// 6 MFLOP per window. A CTA per (window, head) that also ran its head's
// LayerNorm and products on 8 warps put 32 CTAs on 132 SMs at batch 4, each
// waiting on its own weight loads from L2.
//
// Design (ln_mlp.cu's pattern, #4): the products spread over the card, the
// attention stays small.
// 1. LN + qkv: gemm_tile.cuh's GEMM on 64-row x 128-column tiles, each CTA
//    computing the LayerNorm of its 64 rows on the way into its A operand
//    (kLnA: a launch fewer than a separate LN row kernel, whose time is
//    latency alone at these sizes), epilogue kEpiQkv (bias, then q scaled
//    and rounded again); split over K on a cluster of ksq CTAs where the
//    plan says so (kernels/window_attention.py::wmsa_plan, from one image's
//    shape: 1 at the default model's (8,8,768), 72 CTAs at batch 4, since a
//    split of 2 (144 CTAs) runs two waves on 132 SMs).
// 2. Attention: one CTA of four warps per (window, head), a warp per
//    16-row strip; q, k and v come from qkv's token rows (the window
//    partition is addressing) into shared memory in chunks of 96 head
//    columns, all three loads in flight at once (cp.async for q and k);
//    scores, softmax and P in registers (mma.sync m16n8k16), ctx written at
//    the tokens' own rows (the reverse is addressing too).
// 3. The projection: the same GEMM (kEpiBias), split over K on a cluster of
//    ks CTAs summed in rank order before bproj and the one rounding (4 at
//    the default model's (8,8,768): 96 CTAs at batch 4).
// linear_bias_kernel below is the standalone W-MSA's (#15, wmsa_core)
// projection, kept as it was.
#include "common.cuh"
#include "gemm_tile.cuh"

namespace sunet {
namespace wmsa {

constexpr int kAttnThreads = 128;   // four warps, one per 16-row strip of a window
constexpr int kTok = 64;            // tokens of a window, at most
constexpr int kDc = 96;             // head columns per chunk
constexpr int kQkLd = kDc + kPad;   // row stride of the q and k chunks
constexpr int kVtLd = kTok + kPad;  // row stride of the v chunk, transposed
constexpr int kNt = kTok / 8;       // 8-column tiles of a score row
constexpr int kDt = kDc / 8;        // 8-column tiles of a head chunk

struct AttnArgs {
  const bf16* qkv;     // (M, 3C): q (scaled, rounded), k, v
  bf16* ctx;           // (M, C)
  const float* bias;   // (heads, N, N)
  const float* mask;   // (nW, N, N) or null
  int H, W, C, ws, heads;
};

__device__ inline void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(hop::smem_u32(dst)), "l"(src)
               : "memory");
}

// Columns [c0, c0 + dc) of head hh's q and k (into qs, ks: rows of kQkLd)
// and v (into vt, transposed: vt[c * kVtLd + t]) for the N tokens, zero up
// to dcp columns; every load in flight at once. Ends with a block barrier.
__device__ inline void load_head(const AttnArgs& a, const long long* tok, int N, int hh, int d,
                                 int c0, int dc, int dcp, bf16* qs, bf16* ks, bf16* vt) {
  const size_t ld3 = 3 * (size_t)a.C;
  const int col0 = hh * d + c0;
  if (d % 8 == 0) {
    constexpr int kLoads = kTok * (kDc / 8) / kAttnThreads;   // per thread, at most
    const int n8 = dcp / 8;
    uint4 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = threadIdx.x + u * kAttnThreads, t = i / n8, c = (i % n8) * 8;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (t >= N) continue;
      if (c < dc) {
        const bf16* src = a.qkv + tok[t] * ld3 + col0 + c;
        cp_async16(qs + t * kQkLd + c, src);
        cp_async16(ks + t * kQkLd + c, src + a.C);
        v[u] = __ldg(reinterpret_cast<const uint4*>(src + 2 * a.C));
      } else {
        *reinterpret_cast<uint4*>(qs + t * kQkLd + c) = v[u];
        *reinterpret_cast<uint4*>(ks + t * kQkLd + c) = v[u];
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = threadIdx.x + u * kAttnThreads, t = i / n8, c = (i % n8) * 8;
      if (t >= N) continue;
      const bf16* e = reinterpret_cast<const bf16*>(&v[u]);
#pragma unroll
      for (int q = 0; q < 8; ++q) vt[(c + q) * kVtLd + t] = e[q];
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  } else {
    for (int i = threadIdx.x; i < N * dcp; i += kAttnThreads) {
      const int t = i / dcp, c = i % dcp;
      const bf16* src = a.qkv + tok[t] * ld3 + col0 + c;
      const bool in = c < dc;
      qs[t * kQkLd + c] = in ? src[0] : tobf(0.f);
      ks[t * kQkLd + c] = in ? src[a.C] : tobf(0.f);
      vt[c * kVtLd + t] = in ? src[2 * a.C] : tobf(0.f);
    }
  }
  __syncthreads();
}

// One (window, head): s = q k^T + bias (+ mask) in fp32 over the head's
// column chunks, e = exp(s - rowmax), P = round(e), ctx = round((P @ v) /
// sum(e)) per column chunk.
__global__ void __launch_bounds__(kAttnThreads) attn_kernel(const AttnArgs a) {
  __shared__ __align__(16) bf16 qs[kTok * kQkLd];
  __shared__ __align__(16) bf16 ks[kTok * kQkLd];
  __shared__ __align__(16) bf16 vt[kDc * kVtLd];
  __shared__ long long tok[kTok];
  const int N = a.ws * a.ws, C = a.C, d = C / a.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2, i0 = warp * 16;
  const bool strip = i0 < N;
  const int nwx = a.W / a.ws, win = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int wy = win / nwx, wx = win % nwx;
  for (int t = threadIdx.x; t < N; t += kAttnThreads)
    tok[t] = ((long long)b * a.H + wy * a.ws + t / a.ws) * a.W + wx * a.ws + t % a.ws;
  __syncthreads();

  float s[kNt][4];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  // one chunk (d <= kDc, the default model's 96) keeps q, k and v in shared
  // memory from the scores to P @ v; a wider head loads v again per chunk
  const bool one = d <= kDc;
  for (int c0 = 0; c0 < d; c0 += kDc) {
    const int dc = min(kDc, d - c0), dcp = align_up(dc, 16);
    load_head(a, tok, N, hh, d, c0, dc, dcp, qs, ks, vt);
    if (strip) {
      for (int k0 = 0; k0 < dcp; k0 += 16) {
        const bf16* qa = qs + (i0 + g) * kQkLd + k0 + t2;
        const uint32_t af[4] = {ld32(qa), ld32(qa + 8 * kQkLd), ld32(qa + 8),
                                ld32(qa + 8 * kQkLd + 8)};
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          if (nt * 8 >= N) break;
          const bf16* kb = ks + (nt * 8 + g) * kQkLd + k0 + t2;
          mma16816(s[nt], af, ld32(kb), ld32(kb + 8));
        }
      }
    }
    if (!one) __syncthreads();
  }

  // + bias (+ mask); the row maxima of rows g and g + 8 over the quad
  const float* bias = a.bias + (size_t)hh * N * N;
  const float* mask = a.mask ? a.mask + (size_t)win * N * N : nullptr;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    if (!strip || nt * 8 >= N) break;
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
  for (int nt = 0; nt < kNt; ++nt) {
    if (!strip || nt * 8 >= N) break;
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
  l0 = fmaxf(l0, 1e-37f);
  l1 = fmaxf(l1, 1e-37f);
  // P: the score tiles 2kt, 2kt + 1 are the A fragment of k-step kt
  uint32_t pf[kNt / 2][4];
#pragma unroll
  for (int kt = 0; kt < kNt / 2; ++kt) {
    pf[kt][0] = pack_bf2(s[2 * kt][0], s[2 * kt][1]);
    pf[kt][1] = pack_bf2(s[2 * kt][2], s[2 * kt][3]);
    pf[kt][2] = pack_bf2(s[2 * kt + 1][0], s[2 * kt + 1][1]);
    pf[kt][3] = pack_bf2(s[2 * kt + 1][2], s[2 * kt + 1][3]);
  }
  for (int c0 = 0; c0 < d; c0 += kDc) {
    const int dc = min(kDc, d - c0), dcp = align_up(dc, 16);
    if (!one) load_head(a, tok, N, hh, d, c0, dc, dcp, qs, ks, vt);
    if (strip) {
      float o[kDt][4];
#pragma unroll
      for (int dt = 0; dt < kDt; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
#pragma unroll
      for (int kt = 0; kt < kNt / 2; ++kt) {
        if (kt * 16 >= N) break;
#pragma unroll
        for (int dt = 0; dt < kDt; ++dt) {
          if (dt * 8 >= dcp) break;
          const bf16* vb = vt + (dt * 8 + g) * kVtLd + kt * 16 + t2;
          mma16816(o[dt], pf[kt], ld32(vb), ld32(vb + 8));
        }
      }
      bf16* out = a.ctx + hh * d + c0;
#pragma unroll
      for (int dt = 0; dt < kDt; ++dt) {
        const int c = dt * 8 + t2;
        if (c >= dc) break;
        const float r0[2] = {o[dt][0] / l0, o[dt][1] / l0}, r1[2] = {o[dt][2] / l1, o[dt][3] / l1};
        for (int u = 0; u < 2 && c + u < dc; ++u) {
          out[tok[i0 + g] * C + c + u] = tobf(r0[u]);       // ctx of this head
          out[tok[i0 + g + 8] * C + c + u] = tobf(r1[u]);
        }
      }
    }
    if (!one) __syncthreads();
  }
}

struct Work {
  bf16 *qkv, *ctx;
  size_t bytes;
};

inline Work carve(unsigned char* p, int M, int C) {
  Carve cv{p};
  Work w;
  w.qkv = cv.take<bf16>((size_t)M * 3 * C);
  w.ctx = cv.take<bf16>((size_t)M * C);
  w.bytes = cv.used;
  return w;
}

}  // namespace wmsa

// out[M x Nout] = round(A[M x K] @ W[K x Nout] + bias), 64x64 tiles per CTA,
// A straight from global memory. M, K, Nout multiples of 16.
__global__ void __launch_bounds__(kThreads)
    linear_bias_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Wt,
                       const float* __restrict__ bias, bf16* __restrict__ out,
                       int M, int K, int Nout) {
  __shared__ __align__(128) unsigned char warp_buf[kWarps * 16 * (kBtLd * 2 + kStgLd * 4)];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* bt;
  float* stg;
  carve_warp(warp_buf, warp, bt, stg);
  for (int t = warp; t < 16; t += kWarps) {
    const int row0 = blockIdx.x * 64 + (t / 4) * 16;
    const int col0 = blockIdx.y * 64 + (t % 4) * 16;
    if (row0 >= M || col0 >= Nout) continue;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    mma_block<1, 1>(&acc, A + (size_t)row0 * K, K, 1, Wt, Nout, 0, col0, 0, 1, 16, K, bt, lane);
    epilogue(acc, stg, lane, [&](int r, int c, float v) {
      out[(size_t)(row0 + r) * Nout + col0 + c] = tobf(v + bias[col0 + c]);
    });
  }
}

}  // namespace sunet

using namespace sunet;

extern "C" size_t sunet_ln_wmsa_workspace(int M, int C) { return wmsa::carve(nullptr, M, C).bytes; }

// out (B, H, W, C) = round(proj(W-MSA(round(LN(x)))) + bproj), x pre-rolled;
// ksq, ks: the K splits of the qkv product and the projection (their
// cluster sizes, from the launch plan).
extern "C" int sunet_ln_wmsa(const void* x, void* out, const void* g, const void* be,
                             const void* wqkv, const void* bqkv, const void* wproj,
                             const void* bproj, const void* bias, const void* mask, void* work,
                             int B, int H, int W, int C, int ws, int heads, float scale, int ksq,
                             int ks, int* launches, void* stream) {
  const int N = ws * ws, M = B * H * W;
  if (N % 16 || N > wmsa::kTok || C % 16 || C > 256 * kLnChunks || C % heads || H % ws ||
      W % ws || M <= 0)
    return (int)cudaErrorInvalidValue;
  if (ksq < 1 || C % (16 * ksq) || kGemmCols % ksq || ks < 1 || C % (16 * ks) || kGemmCols % ks)
    return (int)cudaErrorInvalidValue;
  const wmsa::Work w = wmsa::carve((unsigned char*)work, M, C);
  cudaStream_t st = (cudaStream_t)stream;
  *launches = 0;
  SUNET_TRY((gemm_tile<kEpiQkv, true, true>(
      GemmArgs{(const bf16*)x, (const float*)bqkv, nullptr, w.qkv, M, C, C / ksq, 3 * C, ksq,
               scale, C, (const float*)g, (const float*)be},
      wqkv, st)));
  ++*launches;
  const wmsa::AttnArgs aa{w.qkv, w.ctx, (const float*)bias, (const float*)mask, H, W, C, ws,
                          heads};
  wmsa::attn_kernel<<<dim3((H / ws) * (W / ws), heads, B), wmsa::kAttnThreads, 0, st>>>(aa);
  SUNET_TRY(launched(launches));
  SUNET_TRY((gemm_tile<kEpiBias, true>(
      GemmArgs{w.ctx, (const float*)bproj, nullptr, (bf16*)out, M, C, C / ks, C, ks, 0.f, 0},
      wproj, st)));
  ++*launches;
  return 0;
}

// The standalone W-MSA's projection (#15, wmsa_core): out (M, Nout) =
// round(A (M, K) @ W (K, Nout) + bias).
extern "C" int sunet_linear_bias(const void* A, const void* Wt, const void* bias, void* out,
                                 int M, int K, int Nout, void* stream) {
  if (M % 16 || K % 16 || Nout % 16) return (int)cudaErrorInvalidValue;
  linear_bias_kernel<<<dim3((M + 63) / 64, (Nout + 63) / 64), kThreads, 0,
                       (cudaStream_t)stream>>>((const bf16*)A, (const bf16*)Wt,
                                               (const float*)bias, (bf16*)out, M, K, Nout);
  return (int)cudaGetLastError();
}
