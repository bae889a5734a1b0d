// Shared pieces of the training kernels (the block backward and the LN+W-MSA
// and LN+MLP backwards on block_bwd_hopper.cuh, the LN+MLP branch, the split
// x4 head's backward): a tiled bf16 WMMA GEMM with fp32 accumulation and a
// per-element epilogue (the LN+MLP branch's and the split head's backward's
// products), deterministic token reductions (split partials summed in a
// fixed order), the token-index map of a window-major (rolled, partitioned)
// token order, GELU and its derivative, and the LayerNorm row kernel for C
// <= 768.
//
// Kernels defined here are templates or static, so every source that
// includes the header gets its own copy and the link sees no duplicates.
//
// Weight gradients are dW = A^T dB over every token of the batch. The TPU
// kernels carry these sums across their sequential grid; here the CTAs run
// in parallel, so each CTA sums a fixed chunk of tokens into its own
// partial and reduce_splits adds the partials in split order: no atomics,
// the same bits on every run.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace sunet {

constexpr int kGM = 64, kGN = 64, kGK = 32;   // GEMM CTA tile
constexpr int kLdaR = kGK + kPad;             // smem row strides of the tiles
constexpr int kLdaC = kGM + kPad;
constexpr int kLdbR = kGN + kPad;
constexpr int kLdbC = kGK + kPad;
constexpr int kLdc = kGN + kPadF;

// Out(m, n) = sum_k A(m, k) B(k, n), k over [z*kc, min(K, (z+1)*kc)) for
// split z = blockIdx.z. A(m, k) = A[m*lda + k], or A[k*lda + m] when ACOL;
// B(k, n) = B[k*ldb + n], or B[n*ldb + k] when BCOL. The contiguous axis
// of each operand must be a multiple of 8 elements (16-byte loads); M, N
// and K may be ragged (zero-filled). Each element of the tile goes to
// epi(m, n, v, z), which returns a float "side" value: the CTA sums those
// in a fixed order and, when side != nullptr, writes the sum to
// side[CTA index] (per-CTA partials of a reduction the epilogue computes).
template <bool ACOL, bool BCOL, class Epi>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ Bm, int ldb,
                int M, int N, int K, int kc, Epi epi, float* side) {
  constexpr int kAsz = ACOL ? kGK * kLdaC : kGM * kLdaR;
  constexpr int kBsz = BCOL ? kGN * kLdbC : kGK * kLdbR;
  __shared__ __align__(128) bf16 As[kAsz];
  __shared__ __align__(128) bf16 Bs[kBsz];
  __shared__ __align__(128) float Cs[kGM * kLdc];
  __shared__ float red[kWarps];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int kb = blockIdx.z * kc, ke = min(K, kb + kc);
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  // one 16-byte vector of each tile per thread
  auto load_a = [&](int k0) -> uint4 {
    if (!ACOL) {
      const int r = tid >> 2, c = (tid & 3) * 8, m = m0 + r, k = k0 + c;
      return (m < M && k < ke) ? __ldg(reinterpret_cast<const uint4*>(A + (size_t)m * lda + k))
                               : zero4;
    }
    const int r = tid >> 3, c = (tid & 7) * 8, k = k0 + r, m = m0 + c;
    return (k < ke && m < M) ? __ldg(reinterpret_cast<const uint4*>(A + (size_t)k * lda + m))
                             : zero4;
  };
  auto load_b = [&](int k0) -> uint4 {
    if (!BCOL) {
      const int r = tid >> 3, c = (tid & 7) * 8, k = k0 + r, n = n0 + c;
      return (k < ke && n < N) ? __ldg(reinterpret_cast<const uint4*>(Bm + (size_t)k * ldb + n))
                               : zero4;
    }
    const int r = tid >> 2, c = (tid & 3) * 8, n = n0 + r, k = k0 + c;
    return (n < N && k < ke) ? __ldg(reinterpret_cast<const uint4*>(Bm + (size_t)n * ldb + k))
                             : zero4;
  };
  auto store_a = [&](uint4 v) {
    if (!ACOL) *reinterpret_cast<uint4*>(As + (tid >> 2) * kLdaR + (tid & 3) * 8) = v;
    else *reinterpret_cast<uint4*>(As + (tid >> 3) * kLdaC + (tid & 7) * 8) = v;
  };
  auto store_b = [&](uint4 v) {
    if (!BCOL) *reinterpret_cast<uint4*>(Bs + (tid >> 3) * kLdbR + (tid & 7) * 8) = v;
    else *reinterpret_cast<uint4*>(Bs + (tid >> 2) * kLdbC + (tid & 3) * 8) = v;
  };

  typedef typename std::conditional<ACOL, wmma::col_major, wmma::row_major>::type ALay;
  typedef typename std::conditional<BCOL, wmma::col_major, wmma::row_major>::type BLay;
  const int wm = warp & 3, wn = warp >> 2;   // warp tile: rows 16*wm, cols 32*wn
  FragC acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  uint4 ra = kb < ke ? load_a(kb) : zero4, rb = kb < ke ? load_b(kb) : zero4;
  for (int k0 = kb; k0 < ke; k0 += kGK) {
    store_a(ra);
    store_b(rb);
    __syncthreads();
    if (k0 + kGK < ke) {   // next tile's loads in flight during the products
      ra = load_a(k0 + kGK);
      rb = load_b(k0 + kGK);
    }
#pragma unroll
    for (int kk = 0; kk < kGK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALay> fa;
      if (!ACOL) wmma::load_matrix_sync(fa, As + wm * 16 * kLdaR + kk, kLdaR);
      else wmma::load_matrix_sync(fa, As + kk * kLdaC + wm * 16, kLdaC);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLay> fb;
        const int nn = wn * 32 + j * 16;
        if (!BCOL) wmma::load_matrix_sync(fb, Bs + kk * kLdbR + nn, kLdbR);
        else wmma::load_matrix_sync(fb, Bs + nn * kLdbC + kk, kLdbC);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(Cs + wm * 16 * kLdc + wn * 32 + j * 16, acc[j], kLdc,
                            wmma::mem_row_major);
  __syncthreads();
  float s = 0.f;
  for (int i = tid; i < kGM * kGN; i += kThreads) {
    const int r = i / kGN, c = i % kGN, m = m0 + r, n = n0 + c;
    if (m < M && n < N) s += epi(m, n, Cs[r * kLdc + c], (int)blockIdx.z);
  }
  if (side != nullptr) {
    s = warp_sum(s);
    if (lane == 0) red[warp] = s;
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w) t += red[w];
      side[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = t;
    }
  }
}

// Splits of the K range for a product with M x N outputs: enough CTAs to
// fill the card (~2 per SM), each split at least 256 deep.
inline int gemm_splits(int M, int N, int K) {
  const int tiles = ((M + kGM - 1) / kGM) * ((N + kGN - 1) / kGN);
  const int s = (264 + tiles - 1) / tiles;
  return std::max(1, std::min(s, K / 256));
}

// Launches the GEMM with `splits` K splits (chunks a multiple of kGK);
// returns the launch status and adds one to *launches.
template <bool ACOL, bool BCOL, class Epi>
inline cudaError_t gemm(const bf16* A, int lda, const bf16* Bm, int ldb, int M, int N, int K,
                        int splits, Epi epi, float* side, cudaStream_t st, int* launches) {
  const int kc = ((K + splits - 1) / splits + kGK - 1) / kGK * kGK;
  const dim3 grid((N + kGN - 1) / kGN, (M + kGM - 1) / kGM, splits);
  gemm_kernel<ACOL, BCOL, Epi><<<grid, kThreads, 0, st>>>(A, lda, Bm, ldb, M, N, K, kc, epi,
                                                         side);
  ++*launches;
  return cudaGetLastError();
}

// Grid size of a gemm() launch (the number of side partials it writes).
inline int gemm_ctas(int M, int N, int splits) {
  return ((N + kGN - 1) / kGN) * ((M + kGM - 1) / kGM) * splits;
}

// Epilogue: out[z][m][n] = v (split partials, zstride floats apart).
struct EpiF32 {
  float* out;
  int ldo;
  size_t zstride;
  __device__ float operator()(int m, int n, float v, int z) const {
    out[z * zstride + (size_t)m * ldo + n] = v;
    return 0.f;
  }
};

// out[i] = sum over s < S of part[s*stride + i] (i < L), s in order.
static __global__ void reduce_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                     int S, size_t L, size_t stride) {
  for (size_t i = blockIdx.x * (size_t)kThreads + threadIdx.x; i < L;
       i += (size_t)gridDim.x * kThreads) {
    float s = 0.f;
    for (int z = 0; z < S; ++z) s += part[z * stride + i];
    out[i] = s;
  }
}

inline cudaError_t reduce_splits(const float* part, float* out, int S, size_t L, size_t stride,
                                 cudaStream_t st, int* launches) {
  const int blocks = (int)std::min<size_t>((L + kThreads - 1) / kThreads, 1024);
  reduce_splits_kernel<<<blocks, kThreads, 0, st>>>(part, out, S, L, stride);
  ++*launches;
  return cudaGetLastError();
}

// A weight gradient dW (M x N) = A^T dB summed over K tokens: split
// partials into `part`, then the fixed-order sum into `out`.
template <bool BCOL = false>
inline cudaError_t weight_grad(const bf16* A, int lda, const bf16* dB, int ldb, int M, int N,
                               int K, float* part, float* out, cudaStream_t st, int* launches) {
  const int S = gemm_splits(M, N, K);
  cudaError_t e = gemm<true, BCOL>(A, lda, dB, ldb, M, N, K, S,
                                   EpiF32{part, N, (size_t)M * N}, nullptr, st, launches);
  if (e != cudaSuccess) return e;
  return reduce_splits(part, out, S, (size_t)M * N, (size_t)M * N, st, launches);
}

// Column sums of an M x N matrix (float or bf16), rows split in chunks of
// kColRows: partials part[chunk][n], then the fixed-order sum.
constexpr int kColRows = 256;

template <class T>
__global__ void colsum_kernel(const T* __restrict__ src, int M, int N, float* __restrict__ part) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const int r0 = blockIdx.y * kColRows, r1 = min(M, r0 + kColRows);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) {
    if constexpr (std::is_same<T, float>::value) s += src[(size_t)r * N + n];
    else s += bf(src[(size_t)r * N + n]);
  }
  part[(size_t)blockIdx.y * N + n] = s;
}

template <class T>
inline cudaError_t colsum(const T* src, int M, int N, float* part, float* out, cudaStream_t st,
                          int* launches) {
  const int S = (M + kColRows - 1) / kColRows;
  colsum_kernel<T><<<dim3((N + kThreads - 1) / kThreads, S), kThreads, 0, st>>>(src, M, N, part);
  ++*launches;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce_splits(part, out, S, (size_t)N, (size_t)N, st, launches);
}

// Element offset of window-major token t in an NHWC map rolled by -shift:
// t = ((b*nW + win)*N + n); token n of window win sits at image row
// (wy*ws + n/ws + shift) % H and column (wx*ws + n%ws + shift) % W.
__device__ inline size_t token_offset(int t, int H, int W, int C, int ws, int shift) {
  const int N = ws * ws, hw = H * W, nwx = W / ws;
  const int b = t / hw, r = t % hw, win = r / N, n = r % N;
  const int gy = ((win / nwx) * ws + n / ws + shift) % H;
  const int gx = ((win % nwx) * ws + n % ws + shift) % W;
  return (((size_t)b * H + gy) * W + gx) * C;
}

#define SUNET_TRY(expr)               \
  do {                                \
    cudaError_t e_ = (expr);          \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

// After a raw <<<>>> launch: count it and return its status.
inline cudaError_t launched(int* launches) {
  ++*launches;
  return cudaGetLastError();
}

// Bump allocator over one device workspace (128-byte aligned pieces).
struct Carve {
  unsigned char* p;
  size_t used = 0;
  template <class T>
  T* take(size_t n) {
    T* r = reinterpret_cast<T*>(p ? p + used : nullptr);
    used += align128(n * sizeof(T));
    return r;
  }
};

// ---- row kernels

constexpr int kLnRows = 64;    // rows per CTA of the row kernels (8 per warp)
constexpr int kLnMaxC = 768;   // widest LayerNorm row of the training kernels

inline int ln_ctas(int T) { return (T + kLnRows - 1) / kLnRows; }

__device__ inline float gelu_f(float v) { return 0.5f * v * (1.f + erff(v * 0.70710678118654752f)); }
__device__ inline float gelu_grad_f(float v) {
  return 0.5f * (1.f + erff(v * 0.70710678118654752f)) +
         v * expf(-0.5f * v * v) * 0.3989422804014327f;
}

// LayerNorm of T rows: src rows (gathered from the NHWC map by
// token_offset when `gather`, else src's own rows), copy (gather only)
// keeps the gathered rows, out = round(xhat * g + b), stats = (mean, inv)
// per row. Every caller takes src's own rows; the kernel keeps the gather
// because the same kernel without it ran slower on the H100 (#4 0.067
// against 0.063 ms at (8,8,768), PERF.md).
static __global__ void __launch_bounds__(kThreads)
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

inline cudaError_t ln_fwd(const bf16* src, bool gather, bf16* copy, bf16* out, float* stats,
                          const float* g, const float* b, int T, int C, int H, int W, int ws,
                          int shift, cudaStream_t st, int* launches) {
  ln_fwd_kernel<<<ln_ctas(T), kThreads, 0, st>>>(src, gather, copy, out, stats, g, b, T, C, H,
                                                 W, ws, shift);
  return launched(launches);
}

// ---- token-row GEMM epilogues (m: token row, n: output column)

struct EpiBias {   // out = round(acc + bias), bias optional
  bf16* out;
  const float* bias;
  int ld;
  __device__ float operator()(int m, int n, float v, int) const {
    out[(size_t)m * ld + n] = tobf(v + (bias ? bias[n] : 0.f));
    return 0.f;
  }
};

struct EpiFc1 {   // a = acc + b1 (fp32, when a is given), h = round(gelu(acc + b1))
  float* a;
  bf16* h;
  const float* b1;
  int ld;
  __device__ float operator()(int m, int n, float v, int) const {
    const size_t e = (size_t)m * ld + n;
    const float t = v + b1[n];
    if (a) a[e] = t;
    h[e] = tobf(gelu_f(t));
    return 0.f;
  }
};

}  // namespace sunet
