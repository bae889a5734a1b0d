// The float32 product tile of the float32 kernel forms (#3 and #4 in
// csrc/f32_block.cu, #5 in csrc/f32_up4.cu): out = epilogue(A @ W + bias)
// over token rows, in full float32 on the CUDA cores (FFMA); the whole
// block's kernel (#1/#2, csrc/f32_swin_block.cu) shares its A operand
// (a_operand), row map, LN statistics and GELU. No operand is
// rounded to TF32 or any narrower type, so a product sits where cuBLAS's
// float32 GEMM with TF32 off sits, not where single-pass TF32 does (2^-11
// of each operand, ~1e-3 at the stem).
//
// What bounds it on Hopper: FFMA, 67 TFLOP/s on the H100 against 495 TF32
// (165 for the 3xTF32 split a tensor-core form would need). A 64 x 64
// output tile per CTA of 256 threads, each thread 4 x 4 outputs from
// float4 reads of a 16-deep shared-memory stage (A transposed, W as is),
// the next stage's global loads in flight in registers while the current
// one is multiplied. Each 16-deep stage is summed into its own partial and
// then added to the running sum (blocked summation: the error grows with
// K/16 + 16 terms, not K). Every output element is one thread's sum over
// K in one order: the same bits at any batch and every run.
//
// Around the product, what the forms need of it:
// - A's rows through a row map (RowMap): the map's own rows, the window-
//   major rows of the map rolled by -shift (the SW roll as load/store
//   addressing, csrc/swin_cluster.cu's rule), or the x4 head's (pixel,
//   subpixel) rows written to the 4x pixel map;
// - a LayerNorm of A's rows over K (float32 statistics, two passes over the
//   row, computed per CTA for its 64 rows, or read from a statistics
//   launch's output, ln_stats) applied as A is loaded;
// - the epilogues: + bias, then exact-erf GELU, PReLU, a residual row
//   (through its own map), or the x4 head's edge-clamped bilinear stencil.
#pragma once

#include "common.cuh"

namespace f32 {

constexpr int kBM = 64;        // output rows of a CTA
constexpr int kBN = 64;        // output columns of a CTA
constexpr int kBK = 16;        // depth of one shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr float kLnEps = 1e-5f;

// A as the product reads it: the float32 value, unrounded.
__device__ __forceinline__ float a_operand(float v) { return v; }

enum MapKind { kRows = 0, kWindows = 1, kPhases = 2 };

// Row r of a product -> the row of the tensor it reads or writes.
struct RowMap {
  int kind;
  int H, W;    // kWindows: the map; kPhases: the low-resolution map
  int ws, shift;

  __host__ __device__ long long at(long long r) const {
    if (kind == kRows) return r;
    if (kind == kWindows) {
      // window-major rows of roll(map, -shift): (b, window row, window col,
      // token row, token col) -> the map's (b, h, w)
      const int N = ws * ws, nw = W / ws, nh = H / ws;
      const long long win = r / N;
      const int t = (int)(r % N);
      const int ww = (int)(win % nw);
      const long long rest = win / nw;
      const int wh = (int)(rest % nh);
      const long long b = rest / nh;
      const int h = (wh * ws + t / ws + shift) % H, w = (ww * ws + t % ws + shift) % W;
      return (b * H + h) * W + w;
    }
    // kPhases: r = pixel * 16 + subpixel (i, j) of the low-res (H, W) map
    // -> the row of pixel (4h + i, 4w + j) of the (4H, 4W) map
    const long long t = r >> 4;
    const int s = (int)(r & 15);
    const int w = (int)(t % W);
    const long long rest = t / W;
    const int h = (int)(rest % H);
    const long long b = rest / H;
    return (b * 4 * H + 4 * h + s / 4) * (4LL * W) + 4 * w + s % 4;
  }
};

enum Epilogue { kNone = 0, kGelu = 1, kPrelu = 2, kResidual = 3, kStencil = 4 };

struct Gemm {
  const float* a;       // A rows: a + amap.at(r) * lda, K values
  RowMap amap;
  int lda;
  const float* ln_g;    // LayerNorm of A's rows over K (scale, bias), or null
  const float* ln_b;
  const float* stats;   // its (mean, 1/sqrt(var + eps)) per row r (ln_stats), or null
  const float* w;       // K x N, row-major, leading dimension ldw
  int ldw;
  const float* bias;    // N values, or null
  float* out;           // out + omap.at(r) * ldo
  RowMap omap;
  int ldo;
  int epi;
  const float* res;     // kResidual: res + rmap.at(r) * ldr
  RowMap rmap;
  int ldr;
  const float* alpha;   // kPrelu: the slope (one value on the device)
  const float* xb;      // kStencil: (B, H, W, N) rows of the bilinear branch,
  int sh, sw;           //   the low-resolution map's H and W
  int M, N, K;
};

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// The half-pixel x4 phase weights (kernels/upsample.py P4): output row
// 4h + p samples taps (h - 1, h) for p = 0, 1 and (h, h + 1) for p = 2, 3.
__device__ __forceinline__ float p4(int p, int k) {
  const float a = p == 0 ? 0.375f : p == 1 ? 0.125f : p == 2 ? 0.875f : 0.625f;
  return k == 0 ? a : 1.0f - a;
}

// Subpixel s's bilinear value of column c at low-res pixel t: the
// separable edge-clamped stencil, along H first, then along W.
__device__ __forceinline__ float stencil(const Gemm& g, long long t, int s, int c) {
  const int i = s / 4, j = s % 4;
  const int w = (int)(t % g.sw);
  const long long rest = t / g.sw;
  const int h = (int)(rest % g.sh);
  const long long base = (rest / g.sh) * g.sh;
  const int h0 = i < 2 ? max(h - 1, 0) : h, h1 = i < 2 ? h : min(h + 1, g.sh - 1);
  const int w0 = j < 2 ? max(w - 1, 0) : w, w1 = j < 2 ? w : min(w + 1, g.sw - 1);
  auto X = [&](int hh, int ww) { return g.xb[((base + hh) * g.sw + ww) * g.N + c]; };
  const float u0 = p4(i, 0) * X(h0, w0) + p4(i, 1) * X(h1, w0);
  const float u1 = p4(i, 0) * X(h0, w1) + p4(i, 1) * X(h1, w1);
  return p4(j, 0) * u0 + p4(j, 1) * u1;
}

// (mean, 1/sqrt(var + eps)) of one row of K floats, float32, two passes,
// reduced over a warp (every lane gets them).
__device__ __forceinline__ float2 row_stats(const float* row, int K, int lane) {
  float s = 0.f;
  for (int k = lane * 4; k < K; k += 128) {
    const float4 v = ld4(row + k);
    s += (v.x + v.y) + (v.z + v.w);
  }
  const float mean = sunet::warp_sum(s) / K;
  float q = 0.f;
  for (int k = lane * 4; k < K; k += 128) {
    const float4 v = ld4(row + k);
    const float a = v.x - mean, b = v.y - mean, c = v.z - mean, d = v.w - mean;
    q += (a * a + b * b) + (c * c + d * d);
  }
  return make_float2(mean, 1.0f / sqrtf(sunet::warp_sum(q) / K + kLnEps));
}

// stats (M, 2) = row_stats of each row a + amap.at(r) * lda: a warp a row.
// (static: each source that includes this header has its own copy.)
static __global__ void __launch_bounds__(kThreads)
ln_stats_kernel(const float* __restrict__ a, RowMap amap, int lda, int M, int K,
                float* __restrict__ stats) {
  const long long r = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (r >= M) return;
  const float2 st = row_stats(a + amap.at(r) * lda, K, threadIdx.x & 31);
  if ((threadIdx.x & 31) == 0) reinterpret_cast<float2*>(stats)[r] = st;
}

inline cudaError_t ln_stats(const float* a, RowMap amap, int lda, long long M, int K,
                            float* stats, cudaStream_t stream) {
  if (M <= 0 || K <= 0 || K % 4 || lda % 4) return cudaErrorInvalidValue;
  const long long blocks = (M * 32 + kThreads - 1) / kThreads;
  ln_stats_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(a, amap, lda, (int)M, K, stats);
  return cudaGetLastError();
}

// One 64 x 64 output tile (row tile tm, column tile tn) of the product, by
// the CTA's 256 threads; a CTA may run several tiles one after another.
template <bool kLN>
__device__ __forceinline__ void gemm_tile(const Gemm& g, long long tm, int tn) {
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN + 4];
  __shared__ long long arow[kBM];
  __shared__ float mean_s[kBM], rstd_s[kBM];
  const int tid = threadIdx.x;
  const long long m0 = tm * kBM;
  const int n0 = tn * kBN;
  __syncthreads();   // the CTA's previous tile is done with the shared arrays
  if (tid < kBM) arow[tid] = m0 + tid < g.M ? g.amap.at(m0 + tid) * g.lda : -1;
  __syncthreads();
  if (kLN) {
    const int warp = tid >> 5, lane = tid & 31;
    for (int i = warp; i < kBM; i += kThreads / 32) {
      float2 st = make_float2(0.f, 0.f);
      if (arow[i] >= 0)
        st = g.stats ? reinterpret_cast<const float2*>(g.stats)[m0 + i]
                     : row_stats(g.a + arow[i], g.K, lane);
      if (lane == 0) {
        mean_s[i] = st.x;
        rstd_s[i] = st.y;
      }
    }
    __syncthreads();
  }

  // loaders: A as (row am, depth ak .. ak + 3), W as (depth wk, columns wn .. wn + 3)
  const int am = tid >> 2, ak = (tid & 3) * 4;
  const int wk = tid >> 4, wn = (tid & 15) * 4;
  float4 ra, rb;
  auto load = [&](int k0) {
    ra = make_float4(0.f, 0.f, 0.f, 0.f);
    if (arow[am] >= 0) {
      ra = ld4(g.a + arow[am] + k0 + ak);
      if (kLN) {
        const float mu = mean_s[am], r = rstd_s[am];
        const float4 gg = ld4(g.ln_g + k0 + ak), bb = ld4(g.ln_b + k0 + ak);
        ra.x = (ra.x - mu) * r * gg.x + bb.x;
        ra.y = (ra.y - mu) * r * gg.y + bb.y;
        ra.z = (ra.z - mu) * r * gg.z + bb.z;
        ra.w = (ra.w - mu) * r * gg.w + bb.w;
      }
    }
    rb = n0 + wn < g.N ? ld4(g.w + (long long)(k0 + wk) * g.ldw + n0 + wn)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  };

  const int ty = tid >> 4, tx = tid & 15;
  float acc[4][4] = {};
  load(0);
  for (int k0 = 0; k0 < g.K; k0 += kBK) {
    As[ak + 0][am] = a_operand(ra.x);
    As[ak + 1][am] = a_operand(ra.y);
    As[ak + 2][am] = a_operand(ra.z);
    As[ak + 3][am] = a_operand(ra.w);
    *reinterpret_cast<float4*>(&Bs[wk][wn]) = rb;
    __syncthreads();
    if (k0 + kBK < g.K) load(k0 + kBK);
    float part[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }

  const int n = n0 + tx * 4;
  if (n >= g.N) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = m0 + ty * 4 + i;
    if (r >= g.M) break;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float o = acc[i][j];
      if (g.bias) o += g.bias[n + j];
      if (g.epi == kGelu) {
        o = gelu_erf(o);
      } else if (g.epi == kPrelu) {
        o = o >= 0.f ? o : *g.alpha * o;
      } else if (g.epi == kResidual) {
        o = g.res[g.rmap.at(r) * g.ldr + n + j] + o;
      } else if (g.epi == kStencil) {
        o = o + stencil(g, r >> 4, (int)(r & 15), n + j);
      }
      v[j] = o;
    }
    *reinterpret_cast<float4*>(g.out + g.omap.at(r) * g.ldo + n) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <bool kLN>
__global__ void __launch_bounds__(kThreads) gemm_kernel(const Gemm g) {
  gemm_tile<kLN>(g, blockIdx.y, blockIdx.x);
}

// The tiles of a product: row tiles x column tiles.
__host__ __device__ inline long long gemm_tiles(const Gemm& g) {
  return (long long)((g.M + kBM - 1) / kBM) * ((g.N + kBN - 1) / kBN);
}

// Shape rules of the tile: K a multiple of kBK, N, the leading dimensions
// and every row's start a multiple of 4 floats (float4 loads and stores).
inline bool gemm_takes(const Gemm& g) {
  return g.M > 0 && g.N > 0 && g.K > 0 && g.K % kBK == 0 && g.N % 4 == 0 && g.lda % 4 == 0 &&
         g.ldw % 4 == 0 && g.ldo % 4 == 0 && (g.epi != kResidual || g.ldr % 4 == 0) &&
         (g.M + kBM - 1) / kBM <= 65535;
}

inline cudaError_t gemm(const Gemm& g, cudaStream_t stream) {
  if (!gemm_takes(g)) return cudaErrorInvalidValue;
  const dim3 grid((g.N + kBN - 1) / kBN, (unsigned)((g.M + kBM - 1) / kBM));
  if (g.ln_g)
    gemm_kernel<true><<<grid, kThreads, 0, stream>>>(g);
  else
    gemm_kernel<false><<<grid, kThreads, 0, stream>>>(g);
  return cudaGetLastError();
}

inline Gemm product(const float* a, int lda, const float* w, int ldw, const float* bias,
                    float* out, int ldo, long long M, int N, int K) {
  Gemm g{};
  g.a = a;
  g.lda = lda;
  g.w = w;
  g.ldw = ldw;
  g.bias = bias;
  g.out = out;
  g.ldo = ldo;
  g.M = (int)M;
  g.N = N;
  g.K = K;
  g.amap.kind = g.omap.kind = g.rmap.kind = kRows;
  return g;
}

__host__ __device__ inline RowMap windows(int H, int W, int ws, int shift) {
  RowMap m{};
  m.kind = kWindows;
  m.H = H;
  m.W = W;
  m.ws = ws;
  m.shift = shift;
  return m;
}

}  // namespace f32
