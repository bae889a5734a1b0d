// y + fc2(gelu(fc1(LN(y)))) over token rows: three launches.
//
// Replaces sunet_tf_tpu/kernels/window_attention.py::fused_ln_mlp on the
// blocks above the whole-block cap (C=768, hidden 3072 at the bottleneck).
// Rounding points as the JAX kernel: LN in fp32, rounded; fc1 accumulated in
// fp32 plus b1, exact-erf GELU in fp32, rounded; out = round(y + (fc2 +
// b2)), fc2 accumulated in fp32.
//
// What bounds it on Hopper: at batch 4, 4*T*C*hidden = 2.4 GFLOP (2.4 us at
// the bf16 peak) against 9.4 MB of bf16 weights (2.8 us at 3.35 TB/s): the
// bytes. A kernel over 16-row tiles ran 16 CTAs at batch 4, each streaming
// all 9.4 MB from L2.
//
// Design (#13's sequence, ln_mlp_branch.cu, on hopper.cuh's mainloop):
// 1. the LayerNorm row kernel of train_common.cuh (ln_fwd) into yn;
// 2. fc1: one CTA per 64-row x 128-column tile (4 x 24 = 96 CTAs at batch
//    4), A = yn's 64 rows in shared memory, w1's boxes by TMA into the ring,
//    the two warpgroups one 64-column box each; the epilogue adds b1, applies
//    the erf GELU and stores h rounded;
// 3. fc2: a cluster of KS CTAs per 64-row x 128-column tile, each over hidden
//    / KS rows of w2 (KS from the launch plan, kernels/window_attention.py::
//    mlp_plan, from one image's rows: 4 for the default model's 8x8 map, 96
//    CTAs at batch 4); the fp32 partials meet in distributed
//    shared memory, and rank r sums its 128/KS columns in rank order, adds b2
//    and y and rounds once: the same bits every run.
// Rows past the end are zero-filled and not written.
#include "hopper.cuh"
#include "train_common.cuh"

namespace sunet {

namespace cg = cooperative_groups;
using hop::a_off;

constexpr int kMlpThreads = 256;   // two warpgroups, one 64-column box each
constexpr int kMlpCols = 128;      // output columns of a CTA
constexpr int kPartLd = kMlpCols + kPadF;
constexpr int kRingS = 4;          // slots of the weight ring
constexpr int kRingSlot = 16384;   // bytes of a slot
static_assert((size_t)64 * kPartLd * 4 <= (size_t)kRingS * kRingSlot,
              "the fc2 partial takes the place of the ring");

struct MlpArgs {
  const bf16* a;    // A rows (M x lda): yn (fc1) or h (fc2)
  const float* bias;
  const bf16* y;    // fc2: the residual
  bf16* out;        // fc1: h (M x hidden); fc2: out (M x C)
  int M, lda, K, ncols;
  int G;            // fc2: the cluster size (K split); fc1: 1
};

// Shared-memory bytes of one GEMM launch: header, ring, A (64 x K)
// (kernels/window_attention.py::mlp_smem mirrors it).
__host__ __device__ inline size_t mlp_gemm_smem(int K) {
  return 1024 + 1024 + (size_t)kRingS * kRingSlot + hop::a_bytes(K);
}

// fc1 (kFc2 false) or fc2 (kFc2: cluster rank = K slice), on one 64-row
// tile (blockIdx.y) and 128 output columns.
template <bool kFc2>
__global__ void __launch_bounds__(kMlpThreads, 1)
    mlp_gemm_kernel(const __grid_constant__ MlpArgs a, const __grid_constant__ CUtensorMap map) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x, wg = tid >> 7, t128 = tid & 127;
  const int G = a.G;
  const int rank = kFc2 ? (int)cg::this_cluster().block_rank() : 0;
  const int n0 = (blockIdx.x / G) * kMlpCols;
  const long long r0 = (long long)blockIdx.y * 64;
  const int valid = (int)min(64LL, a.M - r0);
  const int K = a.K, k0 = rank * K;   // this CTA's rows of W (columns of A)
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + kRingS;
  hop::Product* prod = reinterpret_cast<hop::Product*>(empty + kRingS);
  unsigned char* slots = base + 1024;
  unsigned char* as = slots + (size_t)kRingS * kRingSlot;
  if (tid == 0) {
    for (int s = 0; s < kRingS; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], kMlpThreads);
    }
    hop::mbar_fence_init();
    const int nb = min(2, hop::nboxes(a.ncols - n0));
    *prod = {&map, n0, nb, 0, nb, k0, K, hop::chunk_rows(kRingSlot, 2, K)};
  }
  __syncthreads();
  hop::Ring ring{full, empty, slots, kRingS, (uint32_t)kRingSlot, prod, 1, 0, 0, 0, 0};
  if (tid == 0) ring.produce(kRingS);
  const int k8 = K / 8;
  for (int i = tid; i < 64 * k8; i += kMlpThreads) {
    const int r = i / k8, c = (i % k8) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) v = __ldg(reinterpret_cast<const uint4*>(a.a + (r0 + r) * a.lda + k0 + c));
    *reinterpret_cast<uint4*>(as + a_off(r, c)) = v;
  }
  hop::fence_async_smem();
  __syncthreads();
  float acc[1][32];
  hop::run_product<1>(ring, *prod, as, acc, wg, 2, tid == 0);
  const bool mine = wg < prod->nb;
  if constexpr (!kFc2) {
    if (mine) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = hop::acc_row(t128, i), col = n0 + wg * 64 + hop::acc_col(t128, i);
        if (row >= valid || col >= a.ncols) continue;
        const float v = acc[0][i] + a.bias[col];
        a.out[(r0 + row) * a.ncols + col] = tobf(0.5f * v * (1.f + erff(v * 0.70710678118654752f)));
      }
    }
  } else {
    cg::cluster_group cl = cg::this_cluster();
    __syncthreads();   // the ring is spent: the partial takes its place
    float* part = reinterpret_cast<float*>(slots);
    if (mine) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        part[hop::acc_row(t128, i) * kPartLd + wg * 64 + hop::acc_col(t128, i)] = acc[0][i];
    }
    cl.sync();
    // this rank's columns: the partials summed in rank order, then
    // out = round(y + (fc2 + b2))
    const int nc = kMlpCols / G;
    for (int i = tid; i < valid * nc; i += kMlpThreads) {
      const int row = i / nc, c = rank * nc + i % nc, col = n0 + c;
      if (col >= a.ncols) continue;
      float s = 0.f;
      for (int q = 0; q < G; ++q)   // fc2 partials in rank order
        s += cl.map_shared_rank(part, q)[row * kPartLd + c];
      const size_t o = (r0 + row) * a.ncols + col;
      a.out[o] = tobf(bf(a.y[o]) + (s + a.bias[col]));
    }
    cl.sync();   // every rank has read this CTA's partial
  }
}

struct MlpWork {
  bf16 *yn, *h;
  float* st;
  size_t bytes;
};

inline MlpWork carve_mlp(unsigned char* p, int M, int C, int hidden) {
  Carve cv{p};
  MlpWork w;
  w.yn = cv.take<bf16>((size_t)M * C);
  w.h = cv.take<bf16>((size_t)M * hidden);
  w.st = cv.take<float>(2 * (size_t)M);
  w.bytes = cv.used;
  return w;
}

}  // namespace sunet

using namespace sunet;

extern "C" size_t sunet_ln_mlp_workspace(int M, int C, int hidden) {
  return carve_mlp(nullptr, M, C, hidden).bytes;
}

// out (M, C) = round(y + fc2(round(gelu(fc1(round(LN(y))) + b1))) + b2);
// ks: fc2's K split (its cluster size, from the launch plan).
extern "C" int sunet_ln_mlp(const void* y, void* out, const void* g, const void* be,
                            const void* w1, const void* b1, const void* w2, const void* b2,
                            void* work, int M, int C, int hidden, int ks, int* launches,
                            void* stream) {
  if (M <= 0 || C % 16 || hidden % 16 || ks < 1 || hidden % (16 * ks) || kMlpCols % ks)
    return (int)cudaErrorInvalidValue;
  const MlpWork w = carve_mlp((unsigned char*)work, M, C, hidden);
  cudaStream_t st = (cudaStream_t)stream;
  *launches = 0;
  SUNET_TRY(ln_fwd((const bf16*)y, false, nullptr, w.yn, w.st, (const float*)g,
                   (const float*)be, M, C, 0, 0, 0, 0, st, launches));
  const int tiles = (M + 63) / 64, kh = hidden / ks;
  CUtensorMap m1, m2;
  cudaError_t e;
  if ((e = hop::weight_map(&m1, w1, C, hidden, hop::chunk_rows(kRingSlot, 2, C))) ||
      (e = hop::weight_map(&m2, w2, hidden, C, hop::chunk_rows(kRingSlot, 2, kh))))
    return (int)e;
  MlpArgs a1{w.yn, (const float*)b1, nullptr, w.h, M, C, C, hidden, 1};
  SUNET_TRY(hop::launch_cluster(mlp_gemm_kernel<false>,
                                dim3((hidden + kMlpCols - 1) / kMlpCols, tiles), kMlpThreads,
                                mlp_gemm_smem(C), st, 1, a1, m1));
  ++*launches;
  MlpArgs a2{w.h, (const float*)b2, (const bf16*)y, (bf16*)out, M, hidden, kh, C, ks};
  SUNET_TRY(hop::launch_cluster(mlp_gemm_kernel<true>,
                                dim3((C + kMlpCols - 1) / kMlpCols * ks, tiles), kMlpThreads,
                                mlp_gemm_smem(kh), st, ks, a2, m2));
  ++*launches;
  return 0;
}
