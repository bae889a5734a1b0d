// y + fc2(gelu(fc1(LN(y)))) over token rows.
//
// Replaces sunet_tf_tpu/kernels/window_attention.py::fused_ln_mlp on the
// blocks above the whole-block cap (C=768, hidden 3072 at the bottleneck).
//
// What bounds it on Hopper: 9.4 MB of bf16 fc1+fc2 weights against 256 token
// rows at batch 4: every CTA streams the whole weight set from L2, so fewer,
// taller row tiles move fewer bytes, while more CTAs fill more SMs.
//
// Design: one CTA per 16-row tile (16 CTAs at batch 4 — an occupancy limit
// that later work lifts by splitting the hidden dimension across CTAs).
// LN(y) and y stay in shared memory (48 KB at C=768); the hidden dimension
// is walked in 128-column chunks, each fc1 chunk going through an exact-erf
// GELU into shared memory and straight into the fc2 sums, which live in
// registers (48 tiles of 16x16 fp32, 6 column tiles per warp). Rows past the end
// are zero-filled and not written.
#include "common.cuh"

namespace sunet {

constexpr int kRows = 16;

struct MlpArgs {
  const bf16* y;
  bf16* out;
  const float* g;
  const float* be;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* b2;
  int M, C, hidden;
};

// y | LN(y) | hidden chunk | warps
__host__ __device__ inline size_t mlp_smem_bytes(int C) {
  return 2 * align128((size_t)kRows * (C + kPad) * 2) + align128((size_t)kRows * kHB * 2) +
         warp_smem_bytes();
}

template <int MC>
__global__ void __launch_bounds__(kThreads) ln_mlp_kernel(MlpArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.C, ldy = C + kPad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* p = smem;
  bf16* ys = reinterpret_cast<bf16*>(p);
  p += align128((size_t)kRows * ldy * 2);
  bf16* yn = reinterpret_cast<bf16*>(p);
  p += align128((size_t)kRows * ldy * 2);
  bf16* hbuf = reinterpret_cast<bf16*>(p);
  p += align128((size_t)kRows * kHB * 2);
  bf16* bt;
  float* stg;
  carve_warp(p, warp, bt, stg);

  const long long r0 = (long long)blockIdx.x * kRows;
  const int valid = (int)min((long long)kRows, a.M - r0);
  const int cv = C / 8;
  for (int i = threadIdx.x; i < kRows * cv; i += kThreads) {
    const int t = i / cv, c8 = i % cv;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t < valid) v = __ldg(reinterpret_cast<const uint4*>(a.y + (r0 + t) * C) + c8);
    reinterpret_cast<uint4*>(ys + t * ldy)[c8] = v;
  }
  __syncthreads();
  layer_norm_rows(ys, yn, ldy, kRows, C, a.g, a.be, warp, lane);
  __syncthreads();
  mlp_rows<1, MC>(yn, ys, ldy, hbuf, kRows, C, a.hidden, a.w1, a.b1, a.w2, a.b2, bt,
                 stg, warp, lane, [&](int t, int c, bf16 v) {
                   if (t < valid) a.out[(r0 + t) * C + c] = v;
                 });
}

}  // namespace sunet

using namespace sunet;

extern "C" int sunet_ln_mlp(const void* y, void* out, const void* g, const void* be,
                            const void* w1, const void* b1, const void* w2,
                            const void* b2, int M, int C, int hidden, void* stream) {
  if (C % 16 || hidden % 16 || M <= 0) return (int)cudaErrorInvalidValue;
  MlpArgs a{(const bf16*)y,  (bf16*)out,        (const float*)g, (const float*)be,
            (const bf16*)w1, (const float*)b1, (const bf16*)w2, (const float*)b2,
            M,               C,                hidden};
  const size_t smem = mlp_smem_bytes(C);
  const int need = (C / 16 + kWarps - 1) / kWarps;
  return (int)dispatch_mc<6>(need, [&](auto mc) -> cudaError_t {
    auto k = ln_mlp_kernel<decltype(mc)::value>;
    cudaError_t e = set_smem(k, smem);
    if (e != cudaSuccess) return e;
    k<<<(M + kRows - 1) / kRows, kThreads, smem, (cudaStream_t)stream>>>(a);
    return cudaGetLastError();
  });
}
