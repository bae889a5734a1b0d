// The float32 form of the whole Swin block (#1, and #2's K launches of it)
// for a float32 model: one launch, one CTA per window.
//
// Replaces, in float32, sunet_tf_tpu/kernels/window_attention.py::
// fused_swin_block (#1) and fused_swin_block_chain (#2): LN1 -> W-MSA (the
// SW roll as load/store addressing, csrc/swin_cluster.cu's rule) -> proj ->
// residual -> LN2 -> MLP -> residual, every intermediate float32 (LN
// output, q/k/v, probabilities, context, hidden), LayerNorm statistics,
// the row-max softmax and every sum float32, the exact erf GELU.
//
// What bounds it on Hopper: FFMA. A batch-2 (64,64,96) block is ~2.0
// GFLOP, 30 us at 67 TFLOP/s; a C=384 block's 7.1 MB of float32 weights is
// read by every window, from L2 (50 MB). The bf16 cluster kernel's carve
// does not carry over: in float32 one C=384 window's x is 96 KB and its
// hidden map 384 KB, above the 227 KB a CTA holds. So a CTA of 256 threads
// keeps one window's rows in shared memory (LN1(x), then y = x + attn, then
// LN2(y)), and everything wider streams:
//   - q, k and v are made a group of heads at a time (Gc = lcm(head dim,
//     32) channels: 96 at the default model's head dims 12, 24, 48), 32
//     columns per product pass; each head's attention writes its context
//     over its own q columns; the projection's sums for all C columns stay
//     in registers across the groups (4 rows x 2 columns per 32-column
//     block per thread: 96 floats at C=384);
//   - y is written to the output rows as well, the MLP's residual;
//   - the hidden map streams in 64-column chunks: gelu(LN2(y) @ w1 chunk)
//     in shared memory, then fc2's sums for all C columns accumulate in
//     registers over the chunks;
//   - the weights stream through a 16-row shared-memory stage per product.
// Each output element is one thread's sum in one order: the same bits at
// any batch. The kernel is built for C a multiple of 32 in
// F32_BLOCK_WIDTHS (kernels/window_attention.py): a template on C / 32.
#include "f32_tile.cuh"

namespace f32 {

constexpr int kWinRows = 64;        // rows of a window's tile (N <= 64; rows past N are zeros)
constexpr int kStage = 16;       // rows of a weight stage
constexpr int kHidChunk = 64;    // hidden columns of an MLP chunk
constexpr int kBlockThreads = 256;

// Shared memory of the block kernel, in floats: the weight stage (kStage
// rows of max(C, 64) + 4), the window's rows (64 x (C + 4)), the scores
// (64 x 65), their row sums, the LN statistics, and the group's q/k/v (or
// the hidden chunk) as 64 rows of max(3 Gc, 64) + 1.
struct BlockCarve {
  int ldw, ldx, ldt;
  int w, x, s, den, st, t, floats;
};

__host__ __device__ inline BlockCarve block_carve(int C, int Gc) {
  BlockCarve c;
  c.ldw = (C > kHidChunk ? C : kHidChunk) + 4;
  c.ldx = C + 4;
  c.ldt = (3 * Gc > kHidChunk ? 3 * Gc : kHidChunk) + 1;
  c.w = 0;
  c.x = c.w + kStage * c.ldw;
  c.s = c.x + kWinRows * c.ldx;
  c.den = c.s + kWinRows * (kWinRows + 1);
  c.st = c.den + kWinRows;
  c.t = c.st + 2 * kWinRows;
  c.floats = c.t + kWinRows * c.ldt;
  return c;
}

struct BlockArgs {
  const float *x, *g1, *be1, *wqkv, *bqkv, *wproj, *bproj, *g2, *be2, *w1, *b1, *w2, *b2, *bias,
      *mask;
  float* out;
  int H, W, ws, heads, shift, hidden, Gc;
  float scale;
};

// acc (each thread's 4 rows x 2 columns of each of NB 32-column blocks) +=
// A (kWinRows x K, shared memory, row stride lda) @ W[0:K, col0 : col0 + 32 NB]
// (global, row stride ldg), W staged kStage rows at a time.
template <int NB>
__device__ __forceinline__ void window_product(float (&acc)[4][2 * NB], const float* A, int lda, int K,
                                        const float* __restrict__ W, int ldg, int col0,
                                        float* Ws, int ldw) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int k0 = 0; k0 < K; k0 += kStage) {
    for (int e = tid; e < kStage * 8 * NB; e += kBlockThreads) {
      const int kk = e / (8 * NB), c4 = (e % (8 * NB)) * 4;
      *reinterpret_cast<float4*>(Ws + kk * ldw + c4) =
          ld4(W + (long long)(k0 + kk) * ldg + col0 + c4);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kStage; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_operand(A[(ty * 4 + i) * lda + k0 + kk]);
#pragma unroll
      for (int jb = 0; jb < NB; ++jb) {
        const float2 b = *reinterpret_cast<const float2*>(Ws + kk * ldw + jb * 32 + tx * 2);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][2 * jb] = fmaf(a[i], b.x, acc[i][2 * jb]);
          acc[i][2 * jb + 1] = fmaf(a[i], b.y, acc[i][2 * jb + 1]);
        }
      }
    }
    __syncthreads();
  }
}

// rows [0, N) of X (row stride ldx, C values) -> LN(row) * g + b in place,
// a warp a row.
__device__ __forceinline__ void layer_norm_rows(float* X, int ldx, int C, int N, const float* g,
                                                const float* b, float* st) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < N; r += kBlockThreads / 32) {
    const float2 s = row_stats(X + r * ldx, C, lane);
    if (lane == 0) reinterpret_cast<float2*>(st)[r] = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < N * C; e += kBlockThreads) {
    const int r = e / C, c = e % C;
    const float2 s = reinterpret_cast<const float2*>(st)[r];
    X[r * ldx + c] = (X[r * ldx + c] - s.x) * s.y * g[c] + b[c];
  }
}

template <int NBC>
__global__ void __launch_bounds__(kBlockThreads, 1) swin_block_kernel(const BlockArgs a) {
  extern __shared__ __align__(16) float sm[];
  constexpr int C = NBC * 32;
  const int Gc = a.Gc, d = C / a.heads, N = a.ws * a.ws;
  const BlockCarve cv = block_carve(C, Gc);
  float* Ws = sm + cv.w;
  float* Xs = sm + cv.x;
  float* S = sm + cv.s;
  float* den = sm + cv.den;
  float* T = sm + cv.t;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const long long win = blockIdx.x;
  const RowMap map = windows(a.H, a.W, a.ws, a.shift);
  const int nW = (a.H / a.ws) * (a.W / a.ws);

  // the window's rows of x (rolled by -shift), then LN1 in place
  for (int e = tid; e < kWinRows * (C / 4); e += kBlockThreads) {
    const int r = e / (C / 4), c4 = (e % (C / 4)) * 4;
    const float4 v = r < N ? ld4(a.x + map.at(win * N + r) * C + c4)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(Xs + r * cv.ldx + c4) = v;
  }
  __syncthreads();
  layer_norm_rows(Xs, cv.ldx, C, N, a.g1, a.be1, sm + cv.st);
  __syncthreads();

  float accp[4][2 * NBC] = {};   // the projection's sums over every head
  for (int g0 = 0; g0 < C; g0 += Gc) {
    // q (scaled), k, v of the group's heads: T's columns [p Gc, (p + 1) Gc)
    for (int p = 0; p < 3; ++p)
      for (int c0 = 0; c0 < Gc; c0 += 32) {
        float acc[4][2] = {};
        window_product<1>(acc, Xs, cv.ldx, C, a.wqkv, 3 * C, p * C + g0 + c0, Ws, cv.ldw);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = c0 + tx * 2 + j;
            const float v = acc[i][j] + a.bqkv[p * C + g0 + col];
            T[(ty * 4 + i) * cv.ldt + p * Gc + col] = p == 0 ? v * a.scale : v;
          }
      }
    __syncthreads();
    for (int hh = 0; hh < Gc / d; ++hh) {
      const int h = g0 / d + hh;
      float* q = T + hh * d;
      const float* k = T + Gc + hh * d;
      const float* v = T + 2 * Gc + hh * d;
      if (ty * 4 < N && tx * 4 < N) {
        float s[4][4] = {};
        for (int c = 0; c < d; ++c) {
          float qv[4], kv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            qv[i] = q[(ty * 4 + i) * cv.ldt + c];
            kv[i] = k[(tx * 4 + i) * cv.ldt + c];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }
        const float* bh = a.bias + (size_t)h * N * N;
        const float* mw = a.mask ? a.mask + (size_t)(win % nW) * N * N : nullptr;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = ty * 4 + i, c = tx * 4 + j;
            float t = s[i][j] + bh[r * N + c];
            if (mw) t = t + mw[r * N + c];
            S[r * (kWinRows + 1) + c] = t;
          }
      }
      __syncthreads();
      for (int r = warp; r < N; r += kBlockThreads / 32) {
        float mx = -INFINITY;
        for (int j = lane; j < N; j += 32) mx = fmaxf(mx, S[r * (kWinRows + 1) + j]);
        mx = sunet::warp_max(mx);
        float sum = 0.f;
        for (int j = lane; j < N; j += 32) {
          const float e = expf(S[r * (kWinRows + 1) + j] - mx);
          S[r * (kWinRows + 1) + j] = e;
          sum += e;
        }
        sum = sunet::warp_sum(sum);
        if (lane == 0) den[r] = fmaxf(sum, 1e-37f);
      }
      __syncthreads();
      // the head's context over its own q columns (q is spent)
      for (int e = tid; e < N * d; e += kBlockThreads) {
        const int i = e / d, c = e % d;
        float acc = 0.f;
        for (int j = 0; j < N; ++j) acc = fmaf(S[i * (kWinRows + 1) + j], v[j * cv.ldt + c], acc);
        q[i * cv.ldt + c] = acc / den[i];
      }
      __syncthreads();
    }
    // the group's context (T's first Gc columns) through its rows of wproj
    window_product<NBC>(accp, T, cv.ldt, Gc, a.wproj + (long long)g0 * C, C, 0, Ws, cv.ldw);
  }

  // y = x + (ctx @ wproj + bproj): into Xs and the output rows (the MLP's
  // residual, read back by the same thread), then LN2 in place
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= N) break;
    const long long row = map.at(win * N + r) * C;
#pragma unroll
    for (int jb = 0; jb < NBC; ++jb)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = jb * 32 + tx * 2 + j;
        const float y = a.x[row + c] + (accp[i][2 * jb + j] + a.bproj[c]);
        Xs[r * cv.ldx + c] = y;
        a.out[row + c] = y;
      }
  }
  __syncthreads();
  layer_norm_rows(Xs, cv.ldx, C, N, a.g2, a.be2, sm + cv.st);
  __syncthreads();

  float acc2[4][2 * NBC] = {};   // fc2's sums over the hidden chunks
  for (int j0 = 0; j0 < a.hidden; j0 += kHidChunk) {   // every hidden column chunk
    float hc[4][4] = {};
    window_product<2>(hc, Xs, cv.ldx, C, a.w1, a.hidden, j0, Ws, cv.ldw);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jb = 0; jb < 2; ++jb)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = jb * 32 + tx * 2 + j;
          T[(ty * 4 + i) * cv.ldt + c] = gelu_erf(hc[i][2 * jb + j] + a.b1[j0 + c]);
        }
    __syncthreads();
    window_product<NBC>(acc2, T, cv.ldt, kHidChunk, a.w2 + (long long)j0 * C, C, 0, Ws, cv.ldw);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= N) break;
    const long long row = map.at(win * N + r) * C;
#pragma unroll
    for (int jb = 0; jb < NBC; ++jb)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = jb * 32 + tx * 2 + j;
        a.out[row + c] = a.out[row + c] + (acc2[i][2 * jb + j] + a.b2[c]);
      }
  }
}

inline int gcd_i(int a, int b) { return b ? gcd_i(b, a % b) : a; }

template <int NBC>
cudaError_t launch_block(const BlockArgs& a, long long windows, size_t smem, cudaStream_t s) {
  cudaError_t err = sunet::set_smem(swin_block_kernel<NBC>, smem);
  if (err != cudaSuccess) return err;
  swin_block_kernel<NBC><<<(unsigned)windows, kBlockThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace f32

using namespace f32;

// out (B, H, W, C) = the whole Swin block of x (unrolled; the SW roll by
// shift as addressing), float32 throughout; mask (nW, N, N) in rolled
// coordinates or NULL. One launch, one CTA per window.
extern "C" int sunet_f32_block(const void* x, void* out, const void* g1, const void* be1,
                               const void* wqkv, const void* bqkv, const void* wproj,
                               const void* bproj, const void* g2, const void* be2, const void* w1,
                               const void* b1, const void* w2, const void* b2, const void* bias,
                               const void* mask, int B, int H, int W, int C, int hidden, int ws,
                               int heads, int shift, float scale, void* stream) {
  const int N = ws * ws;
  if (B <= 0 || C <= 0 || C % 32 || heads <= 0 || C % heads || N % 16 || N > kWinRows || H % ws ||
      W % ws || hidden <= 0 || hidden % kHidChunk || shift < 0 || shift >= ws)
    return cudaErrorInvalidValue;
  const int d = C / heads, Gc = d / gcd_i(d, 32) * 32;
  if (C % Gc) return cudaErrorInvalidValue;
  const size_t smem = (size_t)block_carve(C, Gc).floats * sizeof(float);
  const long long windows = (long long)B * (H / ws) * (W / ws);
  if (windows > 0x7fffffffLL) return cudaErrorInvalidValue;
  BlockArgs a{(const float*)x, (const float*)g1, (const float*)be1, (const float*)wqkv,
              (const float*)bqkv, (const float*)wproj, (const float*)bproj, (const float*)g2,
              (const float*)be2, (const float*)w1, (const float*)b1, (const float*)w2,
              (const float*)b2, (const float*)bias, (const float*)mask, (float*)out,
              H, W, ws, heads, shift, hidden, Gc, scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch (C / 32) {
    case 1: return launch_block<1>(a, windows, smem, s);
    case 2: return launch_block<2>(a, windows, smem, s);
    case 3: return launch_block<3>(a, windows, smem, s);
    case 4: return launch_block<4>(a, windows, smem, s);
    case 6: return launch_block<6>(a, windows, smem, s);
    case 8: return launch_block<8>(a, windows, smem, s);
    case 12: return launch_block<12>(a, windows, smem, s);
    default: return cudaErrorInvalidValue;
  }
}
