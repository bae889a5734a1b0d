// The windowed attention of the LN+W-MSA kernel (ln_window_attention.cu,
// #3) and of the standalone W-MSA (window_attention.cu, #15), between their
// qkv and projection products on gemm_tile.cuh: one CTA of four warps per
// (window, head), a warp per 16-row strip; q, k and v come from qkv's
// token rows into shared memory in chunks of 96 head columns, all three
// loads in flight at once (cp.async for q and k); scores, softmax and P in
// registers (mma.sync m16n8k16), ctx written at the tokens' own rows.
// Rounding points: s = q k^T + bias (+ mask) in fp32, row-max softmax, ctx
// = round((round(e) @ v) / sum(e)).
//
// Windows above kTok tokens (WIN 16: 256, the scaled config) take a second
// form, attn_big_kernel: a CTA of four warps per 64 query rows of a (window,
// head), the window's k and v^T whole in shared memory (dynamic, big_smem),
// and two passes over the keys in chunks of 64, each holding one 16 x 64
// score tile per warp in registers: the first takes the exact row max, the
// second recomputes the scores, exponentiates, sums and accumulates round(e)
// @ v; the divide comes after, as above. No online rescale: the rounding
// points stay those of the row-max softmax. A 16 x 256 strip held whole
// would take 128 fp32 registers a thread.
//
// Everything here is a template, inline or static, so several sources can
// include the header.
#pragma once

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
// kWin: the tokens are window rows (#15: token i of window t = b nW + win
// is row t N + i, the mask that of window t % nW); else the window
// partition of an (H, W) map is addressing (#3).
template <bool kWin>
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
  int mwin = win;   // the mask's window
  if constexpr (kWin) {
    const long long t0 = ((long long)b * gridDim.x + win) * N;
    for (int t = threadIdx.x; t < N; t += kAttnThreads) tok[t] = t0 + t;
    mwin = (int)(((long long)b * gridDim.x + win) % gridDim.x);
  } else {
    for (int t = threadIdx.x; t < N; t += kAttnThreads)
      tok[t] = ((long long)b * a.H + wy * a.ws + t / a.ws) * a.W + wx * a.ws + t % a.ws;
  }
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
  const float* mask = a.mask ? a.mask + (size_t)mwin * N * N : nullptr;
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

constexpr int kTokBig = 256;      // tokens of a window, at most, in the big form
constexpr int kDcBig = 64;        // head dim, at most, in the big form (one chunk)
constexpr int kRowsBig = 64;      // query rows of a big-form CTA: four warps of 16

// Dynamic shared memory of the big form (kernels/window_attention.py::
// attn_big_smem mirrors it): token offsets, 64 q rows and N k rows of dp +
// kPad, v^T as dp rows of N + kPad; dp = the head dim rounded up to 16.
__host__ __device__ inline size_t big_smem(int N, int d) {
  const int dp = align_up(d, 16);
  return (size_t)N * 8 + (size_t)(kRowsBig + N) * (dp + kPad) * 2 + (size_t)dp * (N + kPad) * 2;
}

// One 16 x 64 score tile of key chunk kc for this warp's rows: q k^T (q's
// fragments af, nk k16 steps) + bias (+ mask) at window rows r0, r0 + 8.
__device__ inline void big_scores(float (&s)[8][4], const uint32_t (&af)[kDcBig / 16][4],
                                  const bf16* ks, int ld, int nk, int kc, int g, int t2,
                                  const float* bias, const float* mask, int N, int r0) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kDcBig / 16; ++kk) {
    if (kk >= nk) break;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const bf16* kb = ks + (kc * 64 + nt * 8 + g) * ld + kk * 16 + t2;
      mma16816(s[nt], af[kk], ld32(kb), ld32(kb + 8));
    }
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j = kc * 64 + nt * 8 + t2;
    const float2 b0 = *reinterpret_cast<const float2*>(bias + (size_t)r0 * N + j);
    const float2 b1 = *reinterpret_cast<const float2*>(bias + (size_t)(r0 + 8) * N + j);
    s[nt][0] += b0.x;
    s[nt][1] += b0.y;
    s[nt][2] += b1.x;
    s[nt][3] += b1.y;
    if (mask) {
      const float2 k0v = *reinterpret_cast<const float2*>(mask + (size_t)r0 * N + j);
      const float2 k1v = *reinterpret_cast<const float2*>(mask + (size_t)(r0 + 8) * N + j);
      s[nt][0] += k0v.x;
      s[nt][1] += k0v.y;
      s[nt][2] += k1v.x;
      s[nt][3] += k1v.y;
    }
  }
}

// The big form over an (H, W) map's windows (the window partition is
// addressing, as attn_kernel<false>): grid (windows, heads, B * N / 64).
static __global__ void __launch_bounds__(kAttnThreads) attn_big_kernel(const AttnArgs a) {
  extern __shared__ __align__(16) unsigned char big_raw[];
  const int N = a.ws * a.ws, C = a.C, d = C / a.heads, dp = align_up(d, 16);
  const int ld = dp + kPad, ldv = N + kPad, nq = N / kRowsBig;
  long long* tok = reinterpret_cast<long long*>(big_raw);
  bf16* qs = reinterpret_cast<bf16*>(big_raw + (size_t)N * 8);
  bf16* ks = qs + kRowsBig * ld;
  bf16* vt = ks + (size_t)N * ld;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2, i0 = warp * 16;
  const int nwx = a.W / a.ws, win = blockIdx.x, hh = blockIdx.y;
  const int b = blockIdx.z / nq, q0 = (blockIdx.z % nq) * kRowsBig;
  const int wy = win / nwx, wx = win % nwx;
  for (int t = threadIdx.x; t < N; t += kAttnThreads)
    tok[t] = ((long long)b * a.H + wy * a.ws + t / a.ws) * a.W + wx * a.ws + t % a.ws;
  __syncthreads();

  // q (this CTA's rows), k and v^T of head hh, zero past d
  const size_t ld3 = 3 * (size_t)C;
  const int col0 = hh * d;
  if (((d | C) & 1) == 0) {   // column pairs: 4-byte loads
    const int dp2 = dp / 2;
    for (int i = threadIdx.x; i < N * dp2; i += kAttnThreads) {
      const int t = i / dp2, c = (i % dp2) * 2;
      uint32_t kv = 0u, vv = 0u;
      if (c < d) {
        const bf16* src = a.qkv + tok[t] * ld3 + col0 + c;
        kv = ld32(src + C);
        vv = ld32(src + 2 * C);
      }
      *reinterpret_cast<uint32_t*>(ks + t * ld + c) = kv;
      vt[c * ldv + t] = __ushort_as_bfloat16((unsigned short)(vv & 0xffffu));
      vt[(c + 1) * ldv + t] = __ushort_as_bfloat16((unsigned short)(vv >> 16));
    }
    for (int i = threadIdx.x; i < kRowsBig * dp2; i += kAttnThreads) {
      const int t = i / dp2, c = (i % dp2) * 2;
      *reinterpret_cast<uint32_t*>(qs + t * ld + c) =
          c < d ? ld32(a.qkv + tok[q0 + t] * ld3 + col0 + c) : 0u;
    }
  } else {
    for (int i = threadIdx.x; i < N * dp; i += kAttnThreads) {
      const int t = i / dp, c = i % dp;
      const bf16* src = a.qkv + tok[t] * ld3 + col0 + c;
      ks[t * ld + c] = c < d ? src[C] : tobf(0.f);
      vt[c * ldv + t] = c < d ? src[2 * C] : tobf(0.f);
      if (t < kRowsBig) qs[t * ld + c] = c < d ? a.qkv[tok[q0 + t] * ld3 + col0 + c] : tobf(0.f);
    }
  }
  __syncthreads();

  const int nk = dp / 16, r0 = q0 + i0 + g;   // window rows r0 and r0 + 8 of this thread
  uint32_t af[kDcBig / 16][4];
#pragma unroll
  for (int kk = 0; kk < kDcBig / 16; ++kk) {
    if (kk >= nk) break;
    const bf16* qa = qs + (i0 + g) * ld + kk * 16 + t2;
    af[kk][0] = ld32(qa);
    af[kk][1] = ld32(qa + 8 * ld);
    af[kk][2] = ld32(qa + 8);
    af[kk][3] = ld32(qa + 8 * ld + 8);
  }
  const float* bias = a.bias + (size_t)hh * N * N;
  const float* mask = a.mask ? a.mask + (size_t)win * N * N : nullptr;
  float s[8][4];
  // pass 1: the exact row maxima
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int kc = 0; kc < N / 64; ++kc) {
    big_scores(s, af, ks, ld, nk, kc, g, t2, bias, mask, N, r0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
      m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  // pass 2: e = exp(s - max), its row sums, round(e) @ v
  float acc[kDcBig / 8][4];
#pragma unroll
  for (int dt = 0; dt < kDcBig / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  for (int kc = 0; kc < N / 64; ++kc) {
    big_scores(s, af, ks, ld, nk, kc, g, t2, bias, mask, N, r0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - m0);
      s[nt][1] = expf(s[nt][1] - m0);
      s[nt][2] = expf(s[nt][2] - m1);
      s[nt][3] = expf(s[nt][3] - m1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      const uint32_t pf[4] = {pack_bf2(s[2 * kt][0], s[2 * kt][1]),
                              pack_bf2(s[2 * kt][2], s[2 * kt][3]),
                              pack_bf2(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                              pack_bf2(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
      for (int dt = 0; dt < kDcBig / 8; ++dt) {
        if (dt * 8 >= dp) break;
        const bf16* vb = vt + (dt * 8 + g) * ldv + kc * 64 + kt * 16 + t2;
        mma16816(acc[dt], pf, ld32(vb), ld32(vb + 8));
      }
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  l0 = fmaxf(l0, 1e-37f), l1 = fmaxf(l1, 1e-37f);
  bf16* out = a.ctx + col0;
  const long long o0 = tok[r0] * C, o1 = tok[r0 + 8] * C;
#pragma unroll
  for (int dt = 0; dt < kDcBig / 8; ++dt) {
    const int c = dt * 8 + t2;
    if (c >= d) break;
    for (int u = 0; u < 2 && c + u < d; ++u) {
      out[o0 + c + u] = tobf(acc[dt][u] / l0);
      out[o1 + c + u] = tobf(acc[dt][2 + u] / l1);
    }
  }
}

// The attention launch over an (H, W) map's windows, its form by the
// window: attn_kernel<false> up to kTok tokens, attn_big_kernel above.
inline cudaError_t launch_attn(const AttnArgs& a, int B, cudaStream_t st, int* launches) {
  const int N = a.ws * a.ws, nW = (a.H / a.ws) * (a.W / a.ws);
  if (N <= kTok) {
    attn_kernel<false><<<dim3(nW, a.heads, B), kAttnThreads, 0, st>>>(a);
    return launched(launches);
  }
  const size_t smem = big_smem(N, a.C / a.heads);
  SUNET_TRY(set_smem(attn_big_kernel, smem));
  attn_big_kernel<<<dim3(nW, a.heads, B * (N / kRowsBig)), kAttnThreads, smem, st>>>(a);
  return launched(launches);
}

// Whether the attention takes windows of N tokens at head dim d.
__host__ __device__ inline bool attn_takes(int N, int d) {
  return N % 16 == 0 && (N <= kTok || (N % kRowsBig == 0 && N <= kTokBig && d <= kDcBig));
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

}  // namespace sunet
