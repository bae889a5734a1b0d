// The token-row GEMM of the split sublayer kernels, on hopper.cuh's
// mainloop: out (M x ncols) = epilogue(A (M x K) @ W (K x ncols)), one CTA
// per 64-row x 128-column tile. Shared by the LN+MLP kernel (ln_mlp.cu,
// #4: fc1 and fc2) and the LN+W-MSA kernel (ln_window_attention.cu, #3:
// qkv and the projection).
//
// A's 64 rows sit in shared memory in the swizzled K-major layout (with
// kLnA, the LayerNorm of the rows of a.a, computed on the way in); W's
// 64-column boxes come by TMA into a kGemmRingS-slot ring; the two
// warpgroups take one box each. Split over K (kSplit), a cluster of G CTAs
// shares one output tile, rank r over rows [r*K, (r+1)*K) of W; the fp32
// partials meet in distributed shared memory and rank r sums its 128/G
// columns in rank order 0..G-1 before the epilogue: the same bits every
// run. Rows past the end are zero-filled and not written.
//
// The general mode (kMode = kModeGeneral, the block kernel's sequence form,
// swin_block_seq.cu) adds, at a run-time cost the other launches do not
// pay: padded widths (the scaled config's C=180 and C=360, whose depths are
// not whole k16 steps): A's columns at or past lda are zeros in shared
// memory and W's rows past lda are TMA's zero fill, so a product may run
// over K * G > lda, and rows of lda not a multiple of 8 load in 8-byte
// chunks; and `roll`: A's rows (kRollA), the residual's (kRollY) or the
// output's (kRollOut) are those of the token map rolled by -shift
// (roll_row), the SW-MSA roll as addressing. The training form of the
// sequence form (kModeGeneral | kModeDrop) also scales kEpiResid's branch by
// the row's image's drop-path scale (GemmArgs::dp), at the rounding point
// of swin_cluster.cu's train form: round(y + s * (acc + bias)). In any mode
// W may be stored with more columns than the output has (wcols, its rows
// whole 16-byte units).
//
// Epilogues (each rounds once, after the whole fp32 sum):
// - kEpiGelu: round(gelu_erf(s + bias)) (fc1);
// - kEpiResid: round(y + (s + bias)) (fc2, y the residual);
// - kEpiBias: round(s + bias) (the W-MSA projection);
// - kEpiQkv: v = round(s + bias), and round(v * scale) in the first qcols
//   columns (q).
//
// Everything here is a template or inline, so several sources can include
// the header.
#pragma once

#include <type_traits>

#include "hopper.cuh"
#include "train_common.cuh"

namespace sunet {

namespace cg = cooperative_groups;

constexpr int kGemmThreads = 256;   // two warpgroups, one 64-column box each
constexpr int kGemmCols = 128;      // output columns of a CTA
constexpr int kGemmPartLd = kGemmCols + kPadF;
constexpr int kGemmRingS = 4;       // slots of the weight ring
constexpr int kGemmRingSlot = 16384;   // bytes of a slot
static_assert((size_t)64 * kGemmPartLd * 4 <= (size_t)kGemmRingS * kGemmRingSlot,
              "the split partial takes the place of the ring");

enum GemmEpi { kEpiGelu, kEpiResid, kEpiBias, kEpiQkv };
enum GemmRoll { kRollA = 1, kRollY = 2, kRollOut = 4 };
enum GemmMode { kModePlain = 0, kModeGeneral = 1, kModeDrop = 2 };   // flags

struct GemmArgs {
  const bf16* a;    // A rows (M x lda); W has lda rows
  const float* bias;
  const bf16* y;    // kEpiResid: the residual (M x ncols)
  bf16* out;        // M x ncols
  int M, lda, K, ncols;
  int G;            // the cluster size (K split); 1 without kSplit
  float scale;      // kEpiQkv: q's scale, on its first qcols columns
  int qcols;
  const float* ln_g;   // kLnA: the LayerNorm's scale and bias (lda values)
  const float* ln_b;
  int wcols;        // columns W is stored with (0: ncols)
  int roll;         // kModeGeneral: GemmRoll flags, rows addressed in the map rolled by -shift
  int H, W, shift;  // that map: images of H x W token rows
  const float* dp;  // kModeDrop: (B, 2) per-image drop-path scales, kEpiResid's ..
  int dpi;          // .. column dpi (0: the attention branch, 1: the MLP branch)
};

// kLnA: chunks of a row per lane (lda <= 2048 in 16-byte chunks, 1024 in
// 8-byte ones)
constexpr int kLnChunks = 8;

// Row of the token map (B images of H x W) that row r of the map rolled by
// -shift holds: (y, x) -> ((y + shift) % H, (x + shift) % W).
__device__ inline long long roll_row(const GemmArgs& a, long long r) {
  const int hw = a.H * a.W, b = (int)(r / hw), rem = (int)(r - (long long)b * hw);
  const int y = rem / a.W, x = rem - y * a.W;
  return (long long)b * hw + ((y + a.shift) % a.H) * a.W + (x + a.shift) % a.W;
}

// Shared-memory bytes of one GEMM launch over K rows of W: slack, header,
// ring, A (64 x K) (kernels/window_attention.py::mlp_smem mirrors it).
__host__ __device__ inline size_t gemm_smem(int K) {
  return 1024 + 1024 + (size_t)kGemmRingS * kGemmRingSlot + hop::a_bytes(K);
}

template <int kEpi, int kMode>
__device__ inline void gemm_store(const GemmArgs& a, long long row, int col, float s) {
  long long ro = row, ry = row;
  if constexpr ((kMode & kModeGeneral) != 0) {
    if (a.roll & kRollOut) ro = roll_row(a, row);
    if (a.roll & kRollY) ry = roll_row(a, row);
  }
  const size_t o = (size_t)ro * a.ncols + col;
  if constexpr (kEpi == kEpiGelu) {
    const float v = s + a.bias[col];
    a.out[o] = tobf(0.5f * v * (1.f + erff(v * 0.70710678118654752f)));
  } else if constexpr (kEpi == kEpiResid) {
    if constexpr ((kMode & kModeDrop) != 0)
      a.out[o] = tobf(bf(a.y[(size_t)ry * a.ncols + col]) +
                      a.dp[2 * (row / ((long long)a.H * a.W)) + a.dpi] * (s + a.bias[col]));
    else
      a.out[o] = tobf(bf(a.y[(size_t)ry * a.ncols + col]) + (s + a.bias[col]));
  } else if constexpr (kEpi == kEpiBias) {
    a.out[o] = tobf(s + a.bias[col]);
  } else {
    const bf16 v = tobf(s + a.bias[col]);
    a.out[o] = col < a.qcols ? tobf(bf(v) * a.scale) : v;
  }
}

// Row r of A's tile (r < valid): its row of a.a.
template <int kMode>
__device__ inline const bf16* gemm_a_row(const GemmArgs& a, long long r0, int r) {
  if constexpr ((kMode & kModeGeneral) != 0)
    if (a.roll & kRollA) return a.a + roll_row(a, r0 + r) * a.lda;
  return a.a + (r0 + r) * a.lda;
}

// kLnA's rows in chunks of V elements (8: 16-byte loads, 4: 8-byte ones):
// round(LN(row)) over the whole row of lda values (fp32 statistics, as
// train_common.cuh's ln_fwd_kernel), one warp per row, this CTA's columns
// k0 .. k0 + K of it.
template <int V, int kMode>
__device__ inline void gemm_ln_rows(const GemmArgs& a, unsigned char* as, long long r0, int valid,
                                    int k0) {
  typedef typename std::conditional<V == 8, uint4, uint2>::type Vec;
  const int tid = threadIdx.x, K = a.K;
  const int warp = tid >> 5, lane = tid & 31, nv = a.lda / V;
  for (int r = warp; r < 64; r += kGemmThreads / 32) {
    Vec xv[kLnChunks];
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < kLnChunks; ++u) {
      const int j = lane + 32 * u;
      xv[u] = Vec{};
      if (r < valid && j < nv)
        xv[u] = __ldg(reinterpret_cast<const Vec*>(gemm_a_row<kMode>(a, r0, r)) + j);
      const bf16* e = reinterpret_cast<const bf16*>(&xv[u]);
#pragma unroll
      for (int q = 0; q < V; ++q) sum += bf(e[q]);
    }
    const float mean = warp_sum(sum) / a.lda;
    float sq = 0.f;
#pragma unroll
    for (int u = 0; u < kLnChunks; ++u) {
      if (lane + 32 * u >= nv) continue;
      const bf16* e = reinterpret_cast<const bf16*>(&xv[u]);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float dv = bf(e[q]) - mean;
        sq += dv * dv;
      }
    }
    const float inv = rsqrtf(warp_sum(sq) / a.lda + 1e-5f);
#pragma unroll
    for (int u = 0; u < kLnChunks; ++u) {
      const int c = (lane + 32 * u) * V - k0;
      // a chunk past lda (kModeGeneral's padded K) is the zero fill's
      if (((kMode & kModeGeneral) != 0 && lane + 32 * u >= nv) || c < 0 || c >= K) continue;
      const bf16* e = reinterpret_cast<const bf16*>(&xv[u]);
      Vec o;
      bf16* ov = reinterpret_cast<bf16*>(&o);
#pragma unroll
      for (int q = 0; q < V; ++q)
        ov[q] = r < valid ? tobf((bf(e[q]) - mean) * inv * a.ln_g[k0 + c + q] + a.ln_b[k0 + c + q])
                          : tobf(0.f);
      *reinterpret_cast<Vec*>(as + hop::a_off(r, c)) = o;
    }
  }
}

// A (64 x K, columns k0 ..) from the rows of a.a: copied, or with kLnA
// round(LN(row)) (gemm_ln_rows). Rows past `valid` are zeros; in
// kModeGeneral so are the columns at or past lda, and rows of lda not a
// multiple of 8 load in 8-byte chunks.
template <bool kLnA, int kMode>
__device__ inline void gemm_load_a(const GemmArgs& a, unsigned char* as, long long r0, int valid,
                                   int k0) {
  const int tid = threadIdx.x, K = a.K;
  if constexpr (kLnA) {
    if ((kMode & kModeGeneral) != 0 && a.lda % 8)
      gemm_ln_rows<4, kMode>(a, as, r0, valid, k0);
    else
      gemm_ln_rows<8, kMode>(a, as, r0, valid, k0);
    if constexpr ((kMode & kModeGeneral) != 0) {
      const int z0 = max(0, a.lda - k0), zq = (K - z0) / 4;   // the pad columns
      for (int i = tid; i < 64 * zq; i += kGemmThreads)
        *reinterpret_cast<uint2*>(as + hop::a_off(i / zq, z0 + (i % zq) * 4)) = make_uint2(0u, 0u);
    }
  } else if ((kMode & kModeGeneral) != 0 && a.lda % 8) {
    const int k4 = K / 4;
    for (int i = tid; i < 64 * k4; i += kGemmThreads) {
      const int r = i / k4, c = (i % k4) * 4;
      uint2 v = make_uint2(0u, 0u);
      if (r < valid && k0 + c < a.lda)
        v = __ldg(reinterpret_cast<const uint2*>(gemm_a_row<kMode>(a, r0, r) + k0 + c));
      *reinterpret_cast<uint2*>(as + hop::a_off(r, c)) = v;
    }
  } else {
    const int k8 = K / 8;
    for (int i = tid; i < 64 * k8; i += kGemmThreads) {
      const int r = i / k8, c = (i % k8) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid && (kMode == kModePlain || k0 + c < a.lda))
        v = __ldg(reinterpret_cast<const uint4*>(gemm_a_row<kMode>(a, r0, r) + k0 + c));
      *reinterpret_cast<uint4*>(as + hop::a_off(r, c)) = v;
    }
  }
}

// One 64-row tile (blockIdx.y) x 128 output columns; kSplit: cluster rank
// = K slice.
template <int kEpi, bool kSplit, bool kLnA = false, int kMode = kModePlain>
__global__ void __launch_bounds__(kGemmThreads, 1)
    gemm_tile_kernel(const __grid_constant__ GemmArgs a, const __grid_constant__ CUtensorMap map) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x, wg = tid >> 7, t128 = tid & 127;
  const int G = a.G;
  const int rank = kSplit ? (int)cg::this_cluster().block_rank() : 0;
  const int n0 = (blockIdx.x / G) * kGemmCols;
  const long long r0 = (long long)blockIdx.y * 64;
  const int valid = (int)min(64LL, a.M - r0);
  const int K = a.K, k0 = rank * K;   // this CTA's rows of W (columns of A)
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + kGemmRingS;
  hop::Product* prod = reinterpret_cast<hop::Product*>(empty + kGemmRingS);
  unsigned char* slots = base + 1024;
  unsigned char* as = slots + (size_t)kGemmRingS * kGemmRingSlot;
  if (tid == 0) {
    for (int s = 0; s < kGemmRingS; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], kGemmThreads);
    }
    hop::mbar_fence_init();
    const int nb = min(2, hop::nboxes(a.ncols - n0));
    *prod = {&map, n0, nb, 0, nb, k0, K, hop::chunk_rows(kGemmRingSlot, 2, K)};
  }
  __syncthreads();
  hop::Ring ring{full, empty, slots, kGemmRingS, (uint32_t)kGemmRingSlot, prod, 1, 0, 0, 0, 0};
  if (tid == 0) ring.produce(kGemmRingS);
  gemm_load_a<kLnA, kMode>(a, as, r0, valid, k0);
  hop::fence_async_smem();
  __syncthreads();
  float acc[1][32];
  hop::run_product<1>(ring, *prod, as, acc, wg, 2, tid == 0);
  const bool mine = wg < prod->nb;
  if constexpr (!kSplit) {
    if (mine) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = hop::acc_row(t128, i), col = n0 + wg * 64 + hop::acc_col(t128, i);
        if (row >= valid || col >= a.ncols) continue;
        gemm_store<kEpi, kMode>(a, r0 + row, col, acc[0][i]);
      }
    }
  } else {
    cg::cluster_group cl = cg::this_cluster();
    __syncthreads();   // the ring is spent: the partial takes its place
    float* part = reinterpret_cast<float*>(slots);
    if (mine) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        part[hop::acc_row(t128, i) * kGemmPartLd + wg * 64 + hop::acc_col(t128, i)] = acc[0][i];
    }
    cl.sync();
    // this rank's columns: the partials summed in rank order, then the
    // epilogue
    const int nc = kGemmCols / G;
    for (int i = tid; i < valid * nc; i += kGemmThreads) {
      const int row = i / nc, c = rank * nc + i % nc, col = n0 + c;
      if (col >= a.ncols) continue;
      float s = 0.f;
      for (int q = 0; q < G; ++q)   // split partials in rank order
        s += cl.map_shared_rank(part, q)[row * kGemmPartLd + c];
      gemm_store<kEpi, kMode>(a, r0 + row, col, s);
    }
    cl.sync();   // every rank has read this CTA's partial
  }
}

// Launch one GEMM: grid (column tiles x G, row tiles), the weight map's
// boxes sized to the ring's chunks.
template <int kEpi, bool kSplit, bool kLnA = false, int kMode = kModePlain>
inline cudaError_t gemm_tile(const GemmArgs& a, const void* w, cudaStream_t st) {
  CUtensorMap m;
  cudaError_t e = hop::weight_map(&m, w, a.lda, a.wcols ? a.wcols : a.ncols,
                                  hop::chunk_rows(kGemmRingSlot, 2, a.K));
  if (e != cudaSuccess) return e;
  return hop::launch_cluster(gemm_tile_kernel<kEpi, kSplit, kLnA, kMode>,
                             dim3((a.ncols + kGemmCols - 1) / kGemmCols * a.G, (a.M + 63) / 64),
                             kGemmThreads, gemm_smem(a.K), st, a.G, a, m);
}

// gemm_tile on a K split of a.G CTAs, or without the split where a.G is 1.
template <int kEpi, bool kLnA = false, int kMode = kModePlain>
inline cudaError_t gemm_tile_ks(const GemmArgs& a, const void* w, cudaStream_t st) {
  return a.G == 1 ? gemm_tile<kEpi, false, kLnA, kMode>(a, w, st)
                  : gemm_tile<kEpi, true, kLnA, kMode>(a, w, st);
}

}  // namespace sunet
