// Shared pieces of the SUNet Hopper kernels: bf16 tensor-core tiles
// (nvcuda::wmma 16x16x16, fp32 accumulation), per-warp staging, warp
// reductions, row LayerNorm, one head of windowed attention and the
// LN'd-rows MLP. Every kernel runs 8 warps (256 threads) per CTA.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace sunet {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kHC = 128;                // MLP hidden columns per chunk
// Shared-memory matrices pad each row by 16 bytes (8 bf16, 4 floats): with
// row strides that are multiples of 128 bytes, the 8 rows an ldmatrix phase
// reads would all fall in the same banks.
constexpr int kPad = 8;
constexpr int kPadF = 4;
constexpr int kHB = kHC + kPad;         // row stride of the MLP hidden chunk
constexpr int kBtLd = 16 + kPad;        // row stride of a warp's staged B tile
constexpr int kStgLd = 16 + kPadF;      // row stride of a warp's fp32 staging tile
constexpr size_t kMaxSmem = 232448;     // dynamic shared memory per block (H100)

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__host__ __device__ inline int align_up(int v, int a) { return (v + a - 1) / a * a; }
__host__ __device__ inline size_t align128(size_t v) { return (v + 127) & ~size_t(127); }

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float bf(bf16 v) { return __bfloat162float(v); }
__device__ inline bf16 tobf(float v) { return __float2bfloat16(v); }

// Hand each element (row, col, value) of a 16x16 accumulator to f, through
// the warp's fp32 staging tile.
template <class F>
__device__ inline void epilogue(const FragC& acc, float* stg, int lane, F f) {
  wmma::store_matrix_sync(stg, acc, kStgLd, wmma::mem_row_major);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = lane * 8 + i;
    f(e >> 4, e & 15, stg[(e >> 4) * kStgLd + (e & 15)]);
  }
  __syncwarp();
}

// Register-tiled product of a warp: for row tiles i < nr <= MR and column
// tiles j < nc <= MC,
//   acc[i*MC + j] += A[16i : 16i+16, 0:K] @ W[r0 : r0+K, c0 + j*cs : +16].
// A is row-major (lda; shared or global memory), W row-major in global
// memory. Each
// 16-deep step loads every weight tile once for all nr rows and issues up
// to MR*MC independent products. The loop is bound by the latency of the
// weight loads from L2, so they are issued ahead of the products: full,
// 32-byte aligned tiles load straight into fragments U steps ahead (U*MC
// tiles in flight); any other tile (MC == 1 only: a head narrower than 16
// columns or starting mid-tile) is staged through the warp's buffer with
// columns >= nv zeroed, the next step's elements fetched into registers
// while the current step multiplies.
constexpr int kMR = 4;   // row tiles of a 64-token window

// This lane's 8 elements of the 16x16 tile at (r0, c0), columns >= nv zero.
__device__ inline uint4 fetch_b(const bf16* __restrict__ W, int ld, int r0, int c0,
                                int nv, int lane) {
  const int r = lane >> 1, cb = (lane & 1) * 8;
  const bf16* src = W + (size_t)(r0 + r) * ld + c0 + cb;
  if (nv >= 16 && (reinterpret_cast<uintptr_t>(src) & 15) == 0)
    return __ldg(reinterpret_cast<const uint4*>(src));
  unsigned short h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = cb + i < nv ? __bfloat16_as_ushort(src[i]) : 0;
  return make_uint4(h[0] | (unsigned)h[1] << 16, h[2] | (unsigned)h[3] << 16,
                    h[4] | (unsigned)h[5] << 16, h[6] | (unsigned)h[7] << 16);
}

template <int MR, int MC>
__device__ inline void mma_block(FragC* acc, const bf16* A, int lda, int nr,
                                 const bf16* __restrict__ W, int ldw, int r0,
                                 int c0, int cs, int nc, int nv, int K, bf16* bt,
                                 int lane) {
  constexpr int U = MC >= 4 ? 1 : 4 / MC;
  const bf16* w = W + (size_t)r0 * ldw + c0;
  auto products = [&](const FragB* b, int k) {
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      if (i < nr) {
        FragA a;
        wmma::load_matrix_sync(a, A + (size_t)i * 16 * lda + k, lda);
#pragma unroll
        for (int j = 0; j < MC; ++j)
          if (j < nc) wmma::mma_sync(acc[i * MC + j], a, b[j], acc[i * MC + j]);
      }
    }
  };
  if (nv >= 16 && ldw % 16 == 0 && cs % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(w) & 31) == 0) {
    int k = 0;
    for (; k + 16 * U <= K; k += 16 * U) {
      FragB b[U][MC];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < MC; ++j)
          if (j < nc)
            wmma::load_matrix_sync(b[u][j], w + (size_t)(k + 16 * u) * ldw + j * cs, ldw);
#pragma unroll
      for (int u = 0; u < U; ++u) products(b[u], k + 16 * u);
    }
    for (; k < K; k += 16) {
      FragB b[MC];
#pragma unroll
      for (int j = 0; j < MC; ++j)
        if (j < nc) wmma::load_matrix_sync(b[j], w + (size_t)k * ldw + j * cs, ldw);
      products(b, k);
    }
    return;
  }
  uint4* slot = reinterpret_cast<uint4*>(bt + (lane >> 1) * kBtLd + (lane & 1) * 8);
  uint4 next = fetch_b(W, ldw, r0, c0, nv, lane);
  for (int k = 0; k < K; k += 16) {
    *slot = next;
    __syncwarp();
    if (k + 16 < K) next = fetch_b(W, ldw, r0 + k + 16, c0, nv, lane);
    FragB b[MC];
    wmma::load_matrix_sync(b[0], bt, kBtLd);
    products(b, k);
    __syncwarp();
  }
}

template <int T>
__device__ inline void zero(FragC (&acc)[T]) {
#pragma unroll
  for (int i = 0; i < T; ++i) wmma::fill_fragment(acc[i], 0.f);
}

// Column tiles warp, warp + kWarps, ... below n: how many this warp owns.
__device__ inline int owned(int n, int warp) { return (n - warp + kWarps - 1) / kWarps; }

// LayerNorm of R rows of C channels (row stride ld), fp32 statistics, eps
// 1e-5, one warp per row: dst = round((x - mean) * inv * g + b). dst may
// alias src.
__device__ inline void layer_norm_rows(const bf16* src, bf16* dst, int ld, int R,
                                       int C, const float* __restrict__ g,
                                       const float* __restrict__ b, int warp,
                                       int lane) {
  for (int r = warp; r < R; r += kWarps) {
    const bf16* s = src + (size_t)r * ld;
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) sum += bf(s[c]);
    const float mean = warp_sum(sum) / C;
    float sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = bf(s[c]) - mean;
      sq += d * d;
    }
    const float inv = rsqrtf(warp_sum(sq) / C + 1e-5f);
    bf16* o = dst + (size_t)r * ld;
    for (int c = lane; c < C; c += 32) o[c] = tobf((bf(s[c]) - mean) * inv * g[c] + b[c]);
  }
}

// Shared-memory working set of one attention head (N tokens, head dim
// padded to dp): q, k, v (N x dp bf16, row stride ldq), scores (N x N fp32,
// stride lds), exponentials (N x N bf16, stride ldp), row denominators.
struct HeadSmem {
  bf16* q;
  bf16* k;
  bf16* v;
  float* s;
  bf16* p;
  float* den;
  int ldq, lds, ldp;
};

__host__ __device__ inline size_t head_smem_bytes(int N, int dp) {
  return align128((size_t)3 * N * (dp + kPad) * 2) + align128((size_t)N * (N + kPadF) * 4) +
         align128((size_t)N * (N + kPad) * 2) + align128((size_t)N * 4);
}

__device__ inline HeadSmem carve_head(unsigned char* base, int N, int dp) {
  HeadSmem h;
  h.ldq = dp + kPad;
  h.lds = N + kPadF;
  h.ldp = N + kPad;
  h.q = reinterpret_cast<bf16*>(base);
  h.k = h.q + N * h.ldq;
  h.v = h.k + N * h.ldq;
  base += align128((size_t)3 * N * h.ldq * 2);
  h.s = reinterpret_cast<float*>(base);
  base += align128((size_t)N * h.lds * 4);
  h.p = reinterpret_cast<bf16*>(base);
  base += align128((size_t)N * h.ldp * 2);
  h.den = reinterpret_cast<float*>(base);
  return h;
}

// Per-warp buffers: a 16x16 bf16 B tile and a 16x16 fp32 staging tile.
__host__ __device__ inline size_t warp_smem_bytes() {
  return (size_t)kWarps * 16 * (kBtLd * 2 + kStgLd * 4);
}

__device__ inline void carve_warp(unsigned char* p, int warp, bf16*& bt, float*& stg) {
  bt = reinterpret_cast<bf16*>(p) + warp * 16 * kBtLd;
  stg = reinterpret_cast<float*>(p + (size_t)kWarps * 16 * kBtLd * 2) + warp * 16 * kStgLd;
}

// One head hh of windowed attention over N tokens whose LN'd rows are xn
// (N x C bf16, shared, row stride ldx). qkv = round(xn @ wqkv + bqkv); q = round(q * scale);
// s = q k^T + bias[hh] (+ mask); e = exp(s - rowmax); ctx = round((e_bf16 @
// v) / sum(e)). Calls store(token, channel, ctx) for the head's d channels.
// Ends with a block barrier.
template <class Store>
__device__ void attn_head(const bf16* xn, int ldx, int C, int N, int d, int dp, int hh,
                          const bf16* __restrict__ wqkv,
                          const float* __restrict__ bqkv,
                          const float* __restrict__ bias,
                          const float* __restrict__ mask, float scale,
                          const HeadSmem& sm, bf16* bt, float* stg, int warp,
                          int lane, Store store) {
  const int rt_n = N / 16, ct_n = dp / 16;
  // q/k/v column tile x group of row tiles per work item: all row tiles,
  // or half of them where that would leave warps idle (small heads)
  const int nr = (3 * ct_n >= kWarps || rt_n == 1) ? rt_n : (rt_n + 1) / 2;
  const int rg_n = (rt_n + nr - 1) / nr;
  for (int t = warp; t < 3 * ct_n * rg_n; t += kWarps) {
    const int which = t / (ct_n * rg_n), rem = t % (ct_n * rg_n);
    const int ct = rem / rg_n, rt0 = (rem % rg_n) * nr;
    const int nri = min(nr, rt_n - rt0);
    const int c0 = which * C + hh * d + ct * 16;
    const int nv = min(16, d - ct * 16);
    FragC acc[kMR];
    zero(acc);
    mma_block<kMR, 1>(acc, xn + rt0 * 16 * ldx, ldx, nri, wqkv, 3 * C, 0, c0, 0, 1, nv,
                      C, bt, lane);
    bf16* dst = (which == 0 ? sm.q : which == 1 ? sm.k : sm.v) + rt0 * 16 * sm.ldq + ct * 16;
#pragma unroll
    for (int i = 0; i < kMR; ++i) {
      if (i >= nri) continue;
      bf16* di = dst + i * 16 * sm.ldq;
      epilogue(acc[i], stg, lane, [&](int r, int c, float v) {
        bf16 o = tobf(0.f);
        if (c < nv) {
          o = tobf(v + (bqkv ? bqkv[c0 + c] : 0.f));
          if (which == 0) o = tobf(bf(o) * scale);
        }
        di[r * sm.ldq + c] = o;
      });
    }
  }
  __syncthreads();
  for (int t = warp; t < rt_n * rt_n; t += kWarps) {
    const int rt = t / rt_n, ct = t % rt_n;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    FragA a;
    FragBt b;
    for (int k = 0; k < dp; k += 16) {
      wmma::load_matrix_sync(a, sm.q + rt * 16 * sm.ldq + k, sm.ldq);
      wmma::load_matrix_sync(b, sm.k + ct * 16 * sm.ldq + k, sm.ldq);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(sm.s + rt * 16 * sm.lds + ct * 16, acc, sm.lds,
                            wmma::mem_row_major);
  }
  __syncthreads();
  const float* bh = bias + (size_t)hh * N * N;
  for (int i = warp; i < N; i += kWarps) {
    float m = -INFINITY;
    float* si = sm.s + i * sm.lds;
    for (int j = lane; j < N; j += 32) {
      float v = si[j] + bh[i * N + j];
      if (mask) v += mask[i * N + j];
      si[j] = v;
      m = fmaxf(m, v);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(si[j] - m);
      sum += e;
      sm.p[i * sm.ldp + j] = tobf(e);
    }
    sum = warp_sum(sum);
    if (lane == 0) sm.den[i] = fmaxf(sum, 1e-37f);
  }
  __syncthreads();
  for (int t = warp; t < rt_n * ct_n; t += kWarps) {
    const int rt = t / ct_n, ct = t % ct_n;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    FragA a;
    FragB b;
    for (int k = 0; k < N; k += 16) {
      wmma::load_matrix_sync(a, sm.p + rt * 16 * sm.ldp + k, sm.ldp);
      wmma::load_matrix_sync(b, sm.v + k * sm.ldq + ct * 16, sm.ldq);
      wmma::mma_sync(acc, a, b, acc);
    }
    epilogue(acc, stg, lane, [&](int r, int c, float v) {
      const int col = ct * 16 + c;
      if (col < d) store(rt * 16 + r, hh * d + col, tobf(v / sm.den[rt * 16 + r]));
    });
  }
  __syncthreads();
}

// MLP over R rows (R % 16 == 0, R <= 16*MR): out = round(y + s2*(gelu(yn @
// w1 + b1) @ w2 + b2)), s2 the branch's drop-path scale (1 at inference), the fc1 output rounded to bf16 after an exact-erf GELU
// in fp32. yn, y: R x C bf16 (shared, row stride ldy); hbuf: R x kHC bf16
// (shared, row stride kHB). The
// hidden dimension is walked in kHC-column chunks; warp w computes fc1
// column tile w of a chunk and owns fc2 output column tiles w, w + 8, ...
// (at most MC) for all rows, their sums held in registers across chunks.
// Calls store(row, channel, value).
template <int MR, int MC, class Store>
__device__ void mlp_rows(const bf16* yn, const bf16* y, int ldy, bf16* hbuf, int R, int C,
                         int hidden, const bf16* __restrict__ w1,
                         const float* __restrict__ b1, const bf16* __restrict__ w2,
                         const float* __restrict__ b2, float s2, bf16* bt, float* stg,
                         int warp, int lane, Store store) {
  const int rt_n = R / 16, nc = owned(C / 16, warp);
  FragC acc[MR * MC];
  zero(acc);
  for (int h0 = 0; h0 < hidden; h0 += kHC) {
    const int hct = min(kHC, hidden - h0) / 16;
    if (warp < hct) {
      FragC a1[MR];
      zero(a1);
      const int c0 = h0 + warp * 16;
      mma_block<MR, 1>(a1, yn, ldy, rt_n, w1, hidden, 0, c0, 0, 1, 16, C, bt, lane);
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        if (i >= rt_n) continue;
        epilogue(a1[i], stg, lane, [&](int r, int c, float v) {
          v += b1[c0 + c];
          hbuf[(i * 16 + r) * kHB + warp * 16 + c] =
              tobf(0.5f * v * (1.f + erff(v * 0.70710678118654752f)));
        });
      }
    }
    __syncthreads();
    if (nc > 0)
      mma_block<MR, MC>(acc, hbuf, kHB, rt_n, w2, C, h0, warp * 16, kWarps * 16, nc,
                        16, hct * 16, bt, lane);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < MR; ++i) {
#pragma unroll
    for (int j = 0; j < MC; ++j) {
      if (i >= rt_n || j >= nc) continue;
      const int ct = warp + j * kWarps;
      epilogue(acc[i * MC + j], stg, lane, [&](int r, int c, float v) {
        const int row = i * 16 + r, col = ct * 16 + c;
        store(row, col, tobf(bf(y[row * ldy + col]) + s2 * (v + b2[col])));
      });
    }
  }
}

// Instantiate kernel<MC> for the smallest MC in {1, 2, 3, 6} (6 only when
// MaxMC allows it) that holds `need` column tiles per warp; returns the
// launch status.
template <int MaxMC, class Launch>
inline cudaError_t dispatch_mc(int need, Launch launch) {
  if (need <= 1) return launch(std::integral_constant<int, 1>());
  if (need <= 2) return launch(std::integral_constant<int, 2>());
  if (need <= 3) return launch(std::integral_constant<int, 3>());
  if constexpr (MaxMC >= 6) {
    if (need <= 6) return launch(std::integral_constant<int, 6>());
  }
  return cudaErrorInvalidValue;
}

template <class Kernel>
inline cudaError_t set_smem(Kernel k, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace sunet
