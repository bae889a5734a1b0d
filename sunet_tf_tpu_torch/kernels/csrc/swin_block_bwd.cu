// Backward of the whole Swin block, the recompute form.
//
// Replaces sunet_tf_tpu/kernels/window_attention.py::_block_bwd_impl (its
// kernel _block_bwd_kernel): from x (unrolled), dout and the block's
// weights it recomputes LN1 -> qkv -> per-head softmax P -> ctx -> y ->
// LN2 -> fc1 pre-activation, then returns dx and the float32 grads of the
// 12 block parameters and of the (h, N, N) rel-pos bias. Rounding points
// and the per-head attention backward (P-based: ds = P*(dP - rowsum(dP*P)))
// follow the JAX kernel; the plain version is swin_block_bwd_reference in
// kernels/window_attention.py.
//
// What bounds it on Hopper: the products. Forward recompute plus backward
// is ~3x the block's forward work: at (64,64,96) batch 2 about 5.4 GFLOP
// (5 us at the 989 TFLOP/s bf16 peak) against ~20 MB of activations and
// intermediates, which stay in the 50 MB L2 at these shapes (HBM bound
// ~6 us at 3.35 TB/s).
//
// Design, first version (right and simple): one 64-token window's backward
// live set (x, LN1(x), q/k/v, ctx, y, LN2(y), the fp32 fc1 pre-activation,
// 384 KB at C=384, and their gradients) does not fit one CTA's 227 KB, so
// the block runs as a fixed sequence of launches over all B*H*W tokens in
// window-major (rolled) order, with the per-token intermediates in device
// memory: row kernels (LayerNorm forward and backward, the dout gather), a
// tiled bf16 tensor-core GEMM (train_common.cuh) for every product with its
// elementwise step in the epilogue, and a per-(head, window) attention
// kernel that recomputes P on chip. The SW roll is load/store addressing
// (token_offset) on x, dout and dx. Weight grads sum over tokens in fixed
// chunks, then in a fixed order (deterministic). Fusing the sequence back
// into fewer, larger kernels (wgmma, TMA) is later work.
#include "train_common.cuh"

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
};

constexpr int kLnRows = 64;   // rows per CTA of the row kernels (8 per warp)
constexpr int kLnCols = 12;   // columns per lane: C <= 384

__device__ inline float gelu_f(float v) { return 0.5f * v * (1.f + erff(v * 0.70710678118654752f)); }
__device__ inline float gelu_grad_f(float v) {
  return 0.5f * (1.f + erff(v * 0.70710678118654752f)) +
         v * expf(-0.5f * v * v) * 0.3989422804014327f;
}

// LayerNorm of T rows: src rows (gathered from the NHWC map by
// token_offset when `gather`), copy (gather only) keeps the window-major
// rows, out = round(xhat * g + b), stats = (mean, inv) per row.
__global__ void __launch_bounds__(kThreads)
    ln_fwd_kernel(const bf16* __restrict__ src, bool gather, bf16* __restrict__ copy,
                  bf16* __restrict__ out, float* __restrict__ stats, const float* __restrict__ g,
                  const float* __restrict__ b, int T, int C, int H, int W, int ws, int shift) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = 0; i < kLnRows / kWarps; ++i) {
    const int r = blockIdx.x * kLnRows + warp * (kLnRows / kWarps) + i;
    if (r >= T) return;
    const bf16* s = gather ? src + token_offset(r, H, W, C, ws, shift) : src + (size_t)r * C;
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) sum += bf(s[c]);
    const float mean = warp_sum(sum) / C;
    float sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = bf(s[c]) - mean;
      sq += d * d;
    }
    const float inv = rsqrtf(warp_sum(sq) / C + 1e-5f);
    for (int c = lane; c < C; c += 32) {
      const bf16 v = s[c];
      if (copy) copy[(size_t)r * C + c] = v;
      out[(size_t)r * C + c] = tobf((bf(v) - mean) * inv * g[c] + b[c]);
    }
    if (lane == 0) {
      stats[2 * r] = mean;
      stats[2 * r + 1] = inv;
    }
  }
}

// dm = round(s2[b] * dout), dout gathered into window-major rows.
__global__ void dm_kernel(const bf16* __restrict__ dout, const float* __restrict__ dp,
                          bf16* __restrict__ dm, int T, int C, int H, int W, int ws, int shift) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= T) return;
  const bf16* s = dout + token_offset(r, H, W, C, ws, shift);
  const float s2 = dp[2 * (r / (H * W)) + 1];
  for (int c = lane; c < C; c += 32) dm[(size_t)r * C + c] = tobf(s2 * bf(s[c]));
}

// LayerNorm backward over T rows: xhat from x (window-major bf16) and its
// stats, dxhat = d * g, res = base + inv*(dxhat - mean(dxhat) - xhat *
// mean(dxhat * xhat)). LN2 (kLn2): base = dout (gathered), writes dy =
// res (fp32) and dattn = round(s1[b] * res). LN1: base = dy, writes dx =
// round(res) scattered to the NHWC map. Both write per-CTA partials of
// dg = sum d*xhat and db = sum d as part[cta][0:C) and part[cta][C:2C).
template <bool kLn2>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_kernel(const float* __restrict__ d, const bf16* __restrict__ x,
                  const float* __restrict__ stats, const float* __restrict__ g,
                  const bf16* __restrict__ dout, const float* __restrict__ dy_in,
                  const float* __restrict__ dp, float* __restrict__ dy_out,
                  bf16* __restrict__ dattn, bf16* __restrict__ dx, float* __restrict__ part,
                  int T, int C, int H, int W, int ws, int shift) {
  __shared__ float red[kWarps][2 * kLnCols * 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float pdg[kLnCols], pdb[kLnCols];
#pragma unroll
  for (int j = 0; j < kLnCols; ++j) pdg[j] = pdb[j] = 0.f;
  for (int i = 0; i < kLnRows / kWarps; ++i) {
    const int r = blockIdx.x * kLnRows + warp * (kLnRows / kWarps) + i;
    if (r >= T) break;
    const float mean = stats[2 * r], inv = stats[2 * r + 1];
    float dv[kLnCols], xh[kLnCols];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < kLnCols; ++j) {
      const int c = lane + 32 * j;
      dv[j] = xh[j] = 0.f;
      if (c < C) {
        dv[j] = d[(size_t)r * C + c];
        xh[j] = (bf(x[(size_t)r * C + c]) - mean) * inv;
        pdg[j] += dv[j] * xh[j];
        pdb[j] += dv[j];
        const float dxh = dv[j] * g[c];
        m1 += dxh;
        m2 += dxh * xh[j];
      }
    }
    m1 = warp_sum(m1) / C;
    m2 = warp_sum(m2) / C;
    const size_t off = token_offset(r, H, W, C, ws, shift);
    const float s1 = kLn2 ? dp[2 * (r / (H * W))] : 0.f;
#pragma unroll
    for (int j = 0; j < kLnCols; ++j) {
      const int c = lane + 32 * j;
      if (c >= C) continue;
      const float t = inv * (dv[j] * g[c] - m1 - xh[j] * m2);
      if (kLn2) {
        const float res = bf(dout[off + c]) + t;
        dy_out[(size_t)r * C + c] = res;
        dattn[(size_t)r * C + c] = tobf(s1 * res);
      } else {
        dx[off + c] = tobf(dy_in[(size_t)r * C + c] + t);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kLnCols; ++j) {
    red[warp][j * 32 + lane] = pdg[j];
    red[warp][(kLnCols + j) * 32 + lane] = pdb[j];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float sg = 0.f, sb = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      sg += red[w][c];
      sb += red[w][kLnCols * 32 + c];
    }
    part[(size_t)blockIdx.x * 2 * C + c] = sg;
    part[(size_t)blockIdx.x * 2 * C + C + c] = sb;
  }
}

// ---- GEMM epilogues (m: window-major token row, n: output column)

struct EpiQkv {   // qkv = round(acc + bqkv)
  bf16* out;
  const float* bqkv;
  int ld;
  __device__ float operator()(int m, int n, float v, int) const {
    out[(size_t)m * ld + n] = tobf(v + (bqkv ? bqkv[n] : 0.f));
    return 0.f;
  }
};

struct EpiResid {   // y = round(x + s1[b] * (acc + bproj))
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

struct EpiFc1 {   // a = acc + b1 (fp32), h = round(gelu(a))
  float* a;
  bf16* h;
  const float* b1;
  int ld;
  __device__ float operator()(int m, int n, float v, int) const {
    const size_t e = (size_t)m * ld + n;
    const float t = v + b1[n];
    a[e] = t;
    h[e] = tobf(gelu_f(t));
    return 0.f;
  }
};

struct EpiDa {   // da = acc * gelu'(a) (fp32) and round(da)
  float* da;
  bf16* dab;
  const float* a;
  int ld;
  __device__ float operator()(int m, int n, float v, int) const {
    const size_t e = (size_t)m * ld + n;
    const float t = v * gelu_grad_f(a[e]);
    da[e] = t;
    dab[e] = tobf(t);
    return 0.f;
  }
};

struct EpiBf16 {
  bf16* out;
  int ld;
  __device__ float operator()(int m, int n, float v, int) const {
    out[(size_t)m * ld + n] = tobf(v);
    return 0.f;
  }
};

// ---- attention, one head of N tokens per step; q/k/v rows of window wg
// start at token wg*N of the (T, 3C) qkv matrix.

struct AttnSmem {
  bf16 *q, *k, *v, *o;   // N x d each: round(q*scale), k, v, and dctx (bwd)
  float *p, *s;          // N x (N+1): probabilities, scores / gradients
  float* rd;             // N row sums
};

__host__ __device__ inline size_t attn_smem_bytes(int N, int d) {
  return align128((size_t)4 * N * d * 2) + 2 * align128((size_t)N * (N + 1) * 4) +
         align128((size_t)N * 4);
}

__device__ inline AttnSmem carve_attn(unsigned char* p, int N, int d) {
  AttnSmem a;
  a.q = reinterpret_cast<bf16*>(p);
  a.k = a.q + N * d;
  a.v = a.k + N * d;
  a.o = a.v + N * d;
  p += align128((size_t)4 * N * d * 2);
  a.p = reinterpret_cast<float*>(p);
  p += align128((size_t)N * (N + 1) * 4);
  a.s = reinterpret_cast<float*>(p);
  p += align128((size_t)N * (N + 1) * 4);
  a.rd = reinterpret_cast<float*>(p);
  return a;
}

// Loads q (scaled, rounded), k, v of head hh, window wg, and P = softmax(q
// k^T + bias + mask) in fp32 into sm.p. Ends with a block barrier.
__device__ void attn_probs(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                           const float* __restrict__ mask, int C, int d, int N, int nW, int hh,
                           int wg, float scale, const AttnSmem& sm) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, ld = N + 1;
  const size_t row0 = (size_t)wg * N;
  for (int i = tid; i < N * d; i += kThreads) {
    const size_t base = (row0 + i / d) * 3 * C + hh * d + i % d;
    sm.q[i] = tobf(bf(qkv[base]) * scale);
    sm.k[i] = qkv[base + C];
    sm.v[i] = qkv[base + 2 * C];
  }
  __syncthreads();
  const float* bh = bias + (size_t)hh * N * N;
  const float* mw = mask ? mask + (size_t)(wg % nW) * N * N : nullptr;
  for (int e = tid; e < N * N; e += kThreads) {
    const int i = e / N, j = e % N;
    float s = 0.f;
    for (int c = 0; c < d; ++c) s += bf(sm.q[i * d + c]) * bf(sm.k[j * d + c]);
    s += bh[e];
    if (mw) s += mw[e];
    sm.p[i * ld + j] = s;
  }
  __syncthreads();
  for (int i = warp; i < N; i += kWarps) {
    float* pi = sm.p + i * ld;
    float m = -INFINITY;
    for (int j = lane; j < N; j += 32) m = fmaxf(m, pi[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(pi[j] - m);
      pi[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < N; j += 32) pi[j] /= sum;
  }
  __syncthreads();
}

// ctx = round(round(P) @ v) per (head, window): grid (heads, B*nW).
__global__ void __launch_bounds__(kThreads)
    attn_fwd_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ ctx,
                    const float* __restrict__ bias, const float* __restrict__ mask, int C,
                    int d, int N, int nW, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnSmem sm = carve_attn(smem, N, d);
  const int hh = blockIdx.x, wg = blockIdx.y;
  attn_probs(qkv, bias, mask, C, d, N, nW, hh, wg, scale, sm);
  for (int e = threadIdx.x; e < N * d; e += kThreads) {
    const int i = e / d, c = e % d;
    float acc = 0.f;
    for (int j = 0; j < N; ++j) acc += bf(tobf(sm.p[i * (N + 1) + j])) * bf(sm.v[j * d + c]);
    ctx[((size_t)wg * N + i) * C + hh * d + c] = tobf(acc);
  }
}

// Attention backward per (head, chunk of windows): grid (heads, chunks).
// dP = dctx v^T; ds = P*(dP - rowsum(dP*P)); dv = round(P)^T dctx; dq =
// round(ds) k * scale; dk = round(ds)^T round(q*scale). dq/dk/dv go to
// the (T, 3C) fp32 matrix and its bf16 copy; the chunk's sum of ds over
// its windows to part[chunk][head][N][N].
__global__ void __launch_bounds__(kThreads)
    attn_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dctx,
                    const float* __restrict__ bias, const float* __restrict__ mask,
                    float* __restrict__ dqkv, bf16* __restrict__ dqkv_b,
                    float* __restrict__ part, int C, int d, int N, int nW, int nwin, int wpc,
                    float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnSmem sm = carve_attn(smem, N, d);
  const int hh = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, ld = N + 1;
  float db[16];   // this thread's entries e = tid + r*kThreads of ds summed (N*N <= 4096)
#pragma unroll
  for (int r = 0; r < 16; ++r) db[r] = 0.f;
  const int w0 = blockIdx.y * wpc, w1 = min(nwin, w0 + wpc);
  for (int wg = w0; wg < w1; ++wg) {
    const size_t row0 = (size_t)wg * N;
    for (int i = tid; i < N * d; i += kThreads)
      sm.o[i] = dctx[(row0 + i / d) * C + hh * d + i % d];
    attn_probs(qkv, bias, mask, C, d, N, nW, hh, wg, scale, sm);
    for (int e = tid; e < N * N; e += kThreads) {
      const int i = e / N, j = e % N;
      float s = 0.f;
      for (int c = 0; c < d; ++c) s += bf(sm.o[i * d + c]) * bf(sm.v[j * d + c]);
      sm.s[i * ld + j] = s;
    }
    __syncthreads();
    for (int i = warp; i < N; i += kWarps) {
      float t = 0.f;
      for (int j = lane; j < N; j += 32) t += sm.s[i * ld + j] * sm.p[i * ld + j];
      t = warp_sum(t);
      if (lane == 0) sm.rd[i] = t;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int e = tid + r * kThreads;
      if (e >= N * N) break;
      const int i = e / N, j = e % N;
      const float p = sm.p[i * ld + j];
      const float ds = p * (sm.s[i * ld + j] - sm.rd[i]);
      db[r] += ds;
      sm.s[i * ld + j] = bf(tobf(ds));
      sm.p[i * ld + j] = bf(tobf(p));
    }
    __syncthreads();
    for (int e = tid; e < N * d; e += kThreads) {
      const int i = e / d, c = e % d;   // token i, channel c
      float aq = 0.f, ak = 0.f, av = 0.f;
      for (int j = 0; j < N; ++j) {
        aq += sm.s[i * ld + j] * bf(sm.k[j * d + c]);
        ak += sm.s[j * ld + i] * bf(sm.q[j * d + c]);
        av += sm.p[j * ld + i] * bf(sm.o[j * d + c]);
      }
      aq *= scale;
      const size_t o = (row0 + i) * 3 * C + hh * d + c;
      dqkv[o] = aq;
      dqkv[o + C] = ak;
      dqkv[o + 2 * C] = av;
      dqkv_b[o] = tobf(aq);
      dqkv_b[o + C] = tobf(ak);
      dqkv_b[o + 2 * C] = tobf(av);
    }
    __syncthreads();
  }
  float* out = part + ((size_t)blockIdx.y * gridDim.x + hh) * N * N;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int e = tid + r * kThreads;
    if (e < N * N) out[e] = db[r];
  }
}

// Window chunks of the attention backward: ~2 CTAs per SM over all heads.
inline int attn_wpc(int nwin, int heads) {
  const int chunks = std::max(1, std::min(nwin, 264 / heads));
  return (nwin + chunks - 1) / chunks;
}

// The workspace: per-token intermediates and the partials of the token
// reductions. With p == nullptr only measures.
struct BwdWork {
  bf16 *xw, *u, *qkv, *ctx, *y, *yn, *h1, *dm, *dab, *dattn, *dctx, *dqkv_b;
  float *st1, *st2, *a, *da, *dyn, *dy, *dqkv, *du, *part;
  size_t bytes;
};

inline BwdWork carve_bwd(unsigned char* p, int T, int C, int hidden, int heads, int N) {
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
  w.dctx = cv.take<bf16>(tc);
  w.dqkv_b = cv.take<bf16>(3 * tc);
  w.st1 = cv.take<float>(2 * (size_t)T);
  w.st2 = cv.take<float>(2 * (size_t)T);
  w.a = cv.take<float>(th);
  w.da = cv.take<float>(th);
  w.dyn = cv.take<float>(tc);
  w.dy = cv.take<float>(tc);
  w.dqkv = cv.take<float>(3 * tc);
  w.du = cv.take<float>(tc);
  // partials: the largest of the weight-grad splits, the column sums, the
  // LN parameter sums and the rel-pos bias chunks
  size_t part = 0;
  const int dims[4][2] = {{hidden, C}, {C, hidden}, {C, C}, {C, 3 * C}};
  for (auto& mn : dims)
    part = std::max(part, (size_t)gemm_splits(mn[0], mn[1], T) * mn[0] * mn[1]);
  part = std::max(part, (size_t)((T + kColRows - 1) / kColRows) * 3 * C);
  part = std::max(part, (size_t)std::max(hidden, 3 * C) * ((T + kColRows - 1) / kColRows));
  part = std::max(part, (size_t)((T + kLnRows - 1) / kLnRows) * 2 * C);
  const int nwin = T / N;
  part = std::max(part, (size_t)((nwin + attn_wpc(nwin, heads) - 1) / attn_wpc(nwin, heads)) *
                            heads * N * N);
  w.part = cv.take<float>(part);
  w.bytes = cv.used;
  return w;
}

cudaError_t block_bwd(const BwdArgs& a, const BwdWork& w, cudaStream_t st, int* n) {
  const int T = a.B * a.H * a.W, C = a.C, Hd = a.hidden, N = a.ws * a.ws;
  const int d = C / a.heads, nW = (a.H / a.ws) * (a.W / a.ws), nwin = T / N;
  const int hw = a.H * a.W;
  const int ln_ctas = (T + kLnRows - 1) / kLnRows;

  // ---- forward recompute
  ln_fwd_kernel<<<ln_ctas, kThreads, 0, st>>>(a.x, true, w.xw, w.u, w.st1, a.g1, a.be1, T, C,
                                                a.H, a.W, a.ws, a.shift);
  SUNET_TRY(launched(n));
  SUNET_TRY((gemm<false, false>(w.u, C, a.wqkv, 3 * C, T, 3 * C, C, 1,
                                EpiQkv{w.qkv, a.bqkv, 3 * C}, nullptr, st, n)));
  const size_t asmem = attn_smem_bytes(N, d);
  SUNET_TRY(set_smem(attn_fwd_kernel, asmem));
  attn_fwd_kernel<<<dim3(a.heads, nwin), kThreads, asmem, st>>>(w.qkv, w.ctx, a.bias, a.mask,
                                                                 C, d, N, nW, a.scale);
  SUNET_TRY(launched(n));
  SUNET_TRY((gemm<false, false>(w.ctx, C, a.wproj, C, T, C, C, 1,
                                EpiResid{w.y, w.xw, a.bproj, a.dp, C, hw}, nullptr, st, n)));
  ln_fwd_kernel<<<ln_ctas, kThreads, 0, st>>>(w.y, false, nullptr, w.yn, w.st2, a.g2, a.be2, T,
                                                C, a.H, a.W, a.ws, a.shift);
  SUNET_TRY(launched(n));
  SUNET_TRY((gemm<false, false>(w.yn, C, a.w1, Hd, T, Hd, C, 1, EpiFc1{w.a, w.h1, a.b1, Hd},
                                nullptr, st, n)));

  // ---- MLP sublayer
  dm_kernel<<<(T + kWarps - 1) / kWarps, kThreads, 0, st>>>(a.dout, a.dp, w.dm, T, C, a.H, a.W,
                                                            a.ws, a.shift);
  SUNET_TRY(launched(n));
  SUNET_TRY(weight_grad(w.h1, Hd, w.dm, C, Hd, C, T, w.part, a.dw2, st, n));
  SUNET_TRY(colsum(w.dm, T, C, w.part, a.dbm2, st, n));
  SUNET_TRY((gemm<false, true>(w.dm, C, a.w2, C, T, Hd, C, 1, EpiDa{w.da, w.dab, w.a, Hd},
                               nullptr, st, n)));
  SUNET_TRY(weight_grad(w.yn, C, w.dab, Hd, C, Hd, T, w.part, a.dw1, st, n));
  SUNET_TRY(colsum(w.da, T, Hd, w.part, a.dbm1, st, n));
  SUNET_TRY((gemm<false, true>(w.dab, Hd, a.w1, Hd, T, C, Hd, 1, EpiF32{w.dyn, C, 0}, nullptr,
                               st, n)));
  ln_bwd_kernel<true><<<ln_ctas, kThreads, 0, st>>>(w.dyn, w.y, w.st2, a.g2, a.dout, nullptr,
                                                     a.dp, w.dy, w.dattn, nullptr, w.part, T, C,
                                                     a.H, a.W, a.ws, a.shift);
  SUNET_TRY(launched(n));
  SUNET_TRY(reduce_splits(w.part, a.dg2, ln_ctas, C, 2 * C, st, n));
  SUNET_TRY(reduce_splits(w.part + C, a.db2, ln_ctas, C, 2 * C, st, n));

  // ---- attention sublayer
  SUNET_TRY(weight_grad(w.ctx, C, w.dattn, C, C, C, T, w.part, a.dwproj, st, n));
  SUNET_TRY(colsum(w.dattn, T, C, w.part, a.dbproj, st, n));
  SUNET_TRY((gemm<false, true>(w.dattn, C, a.wproj, C, T, C, C, 1, EpiBf16{w.dctx, C}, nullptr,
                               st, n)));
  const int wpc = attn_wpc(nwin, a.heads), chunks = (nwin + wpc - 1) / wpc;
  SUNET_TRY(set_smem(attn_bwd_kernel, asmem));
  attn_bwd_kernel<<<dim3(a.heads, chunks), kThreads, asmem, st>>>(
      w.qkv, w.dctx, a.bias, a.mask, w.dqkv, w.dqkv_b, w.part, C, d, N, nW, nwin, wpc, a.scale);
  SUNET_TRY(launched(n));
  SUNET_TRY(reduce_splits(w.part, a.dbias, chunks, (size_t)a.heads * N * N,
                          (size_t)a.heads * N * N, st, n));
  SUNET_TRY(weight_grad(w.u, C, w.dqkv_b, 3 * C, C, 3 * C, T, w.part, a.dwqkv, st, n));
  SUNET_TRY(colsum(w.dqkv, T, 3 * C, w.part, a.dbqkv, st, n));
  SUNET_TRY((gemm<false, true>(w.dqkv_b, 3 * C, a.wqkv, 3 * C, T, C, 3 * C, 1,
                               EpiF32{w.du, C, 0}, nullptr, st, n)));
  ln_bwd_kernel<false><<<ln_ctas, kThreads, 0, st>>>(w.du, w.xw, w.st1, a.g1, nullptr, w.dy,
                                                      nullptr, nullptr, nullptr, a.dx, w.part, T,
                                                      C, a.H, a.W, a.ws, a.shift);
  SUNET_TRY(launched(n));
  SUNET_TRY(reduce_splits(w.part, a.dg1, ln_ctas, C, 2 * C, st, n));
  SUNET_TRY(reduce_splits(w.part + C, a.db1, ln_ctas, C, 2 * C, st, n));
  return cudaSuccess;
}

}  // namespace sunet

using namespace sunet;

extern "C" size_t sunet_swin_block_bwd_workspace(int B, int H, int W, int C, int hidden, int ws,
                                                 int heads) {
  return carve_bwd(nullptr, B * H * W, C, hidden, heads, ws * ws).bytes;
}

extern "C" int sunet_swin_block_bwd(
    const void* x, const void* dout, const void* g1, const void* be1, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* g2, const void* be2,
    const void* w1, const void* b1, const void* w2, const void* b2, const void* bias,
    const void* mask, const void* dp, void* dx, void* dg1, void* db1, void* dwqkv, void* dbqkv,
    void* dwproj, void* dbproj, void* dg2, void* db2, void* dw1, void* dbm1, void* dw2,
    void* dbm2, void* dbias, void* work, int B, int H, int W, int C, int hidden, int ws,
    int heads, int shift, float scale, int* launches, void* stream) {
  const int N = ws * ws;
  if (N > 64 || C % 32 || C > 32 * kLnCols || C % heads || hidden % 16 || H % ws || W % ws ||
      dp == nullptr)
    return (int)cudaErrorInvalidValue;
  BwdArgs a{(const bf16*)x,     (const bf16*)dout,  (const float*)g1,   (const float*)be1,
            (const bf16*)wqkv,  (const float*)bqkv, (const bf16*)wproj, (const float*)bproj,
            (const float*)g2,   (const float*)be2,  (const bf16*)w1,    (const float*)b1,
            (const bf16*)w2,    (const float*)b2,   (const float*)bias, (const float*)mask,
            (const float*)dp,   (bf16*)dx,          (float*)dg1,        (float*)db1,
            (float*)dwqkv,      (float*)dbqkv,      (float*)dwproj,     (float*)dbproj,
            (float*)dg2,        (float*)db2,        (float*)dw1,        (float*)dbm1,
            (float*)dw2,        (float*)dbm2,       (float*)dbias,      B,
            H,                  W,                  C,                  hidden,
            ws,                 heads,              shift,              scale};
  const BwdWork w = carve_bwd((unsigned char*)work, B * H * W, C, hidden, heads, N);
  *launches = 0;
  return (int)block_bwd(a, w, (cudaStream_t)stream, launches);
}
