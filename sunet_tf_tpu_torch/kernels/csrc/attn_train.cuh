// The per-(head, window) attention forward and backward of the LN+W-MSA
// backward (#12): both recompute the softmax P on chip from the (T, 3C)
// qkv matrix of window-major token rows, in float32, one head of one
// window per step. Static kernels, as in train_common.cuh.
#pragma once

#include "train_common.cuh"

namespace sunet {

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
static __device__ void attn_probs(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                                  const float* __restrict__ mask, int C, int d, int N, int nW,
                                  int hh, int wg, float scale, const AttnSmem& sm) {
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
static __global__ void __launch_bounds__(kThreads)
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
static __global__ void __launch_bounds__(kThreads)
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

inline int attn_chunks(int nwin, int heads) {
  const int wpc = attn_wpc(nwin, heads);
  return (nwin + wpc - 1) / wpc;
}

// ctx (T, C) from the (T, 3C) qkv matrix of nwin = T/N windows.
inline cudaError_t attn_fwd(const bf16* qkv, bf16* ctx, const float* bias, const float* mask,
                            int T, int C, int heads, int N, int nW, float scale, cudaStream_t st,
                            int* launches) {
  const int d = C / heads;
  const size_t smem = attn_smem_bytes(N, d);
  SUNET_TRY(set_smem(attn_fwd_kernel, smem));
  attn_fwd_kernel<<<dim3(heads, T / N), kThreads, smem, st>>>(qkv, ctx, bias, mask, C, d, N, nW,
                                                             scale);
  return launched(launches);
}

// dqkv (fp32 and bf16) and dbias (h, N, N) from dctx; part holds
// attn_chunks * heads * N * N floats.
inline cudaError_t attn_bwd(const bf16* qkv, const bf16* dctx, const float* bias,
                            const float* mask, float* dqkv, bf16* dqkv_b, float* part,
                            float* dbias, int T, int C, int heads, int N, int nW, float scale,
                            cudaStream_t st, int* launches) {
  const int d = C / heads, nwin = T / N;
  const int wpc = attn_wpc(nwin, heads), chunks = attn_chunks(nwin, heads);
  const size_t smem = attn_smem_bytes(N, d);
  SUNET_TRY(set_smem(attn_bwd_kernel, smem));
  attn_bwd_kernel<<<dim3(heads, chunks), kThreads, smem, st>>>(
      qkv, dctx, bias, mask, dqkv, dqkv_b, part, C, d, N, nW, nwin, wpc, scale);
  SUNET_TRY(launched(launches));
  return reduce_splits(part, dbias, chunks, (size_t)heads * N * N, (size_t)heads * N * N, st,
                       launches);
}

}  // namespace sunet
