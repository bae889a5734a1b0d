// Shared pieces of the SUNet Hopper kernels: bf16 tensor-core tiles
// (nvcuda::wmma 16x16x16, fp32 accumulation), per-warp staging, warp
// reductions and one head of windowed attention. The wmma kernels run 8
// warps (256 threads) per CTA.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace sunet {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// Shared-memory matrices pad each row by 16 bytes (8 bf16, 4 floats): with
// row strides that are multiples of 128 bytes, the 8 rows an ldmatrix phase
// reads would all fall in the same banks.
constexpr int kPad = 8;
constexpr int kPadF = 4;
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

// Two bf16 (lo, hi) in one 32-bit register, and a 32-bit load of two.
__device__ inline uint32_t pack_bf2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(tobf(lo)) |
         ((uint32_t)__bfloat16_as_ushort(tobf(hi)) << 16);
}
__device__ inline uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// d (16x8 fp32) += a (16x16 bf16, row) @ b (16x8 bf16, col): the mma.sync
// tile of the per-(window, head) attention kernels (#1, #3, the block
// backward).
__device__ inline void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

template <class Kernel>
inline cudaError_t set_smem(Kernel k, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace sunet
