// Split x4 dual up-sample head: writes the up-sampled map.
//
// Replaces sunet_tf_tpu/kernels/upsample.py::fused_dual_upsample4 (its
// kernel _up4_kernel), the model's x4 head where the conv-fused head does
// not apply (16 * out_chans > 128): from x (B, H, W, C) it writes (B, 4H,
// 4W, C) in bf16, pixel (4h+i, 4w+j) being phase map s = i*4+j at (h, w).
// The phase maps are up4_common.cuh's, as in up4_conv.cu (#5): pixel-shuffle
// branch round(prelu(x @ wexp[s])) @ wpf in fp32; bilinear branch
// round(prelu(x @ wb1 + bb1)) @ wbf kept in fp32 through the half-pixel x4
// stencil with EDGE-CLAMPED taps; one rounding of the sum.
//
// What bounds it on Hopper: the 16x output. At (64,64,96) batch 2 it writes
// 25 MB of bf16 against 1.6 MB read and 5.8 GFLOP of products (68 C^2 per
// low-res pixel): ~8 us at 3.35 TB/s, the bytes bound.
//
// Design, first version (right and simple): one CTA per tile of 4 x 8
// low-res pixels. It loads the tile with a 1-pixel halo, clamped at the
// image edge (the bilinear rule), runs the bilinear branch over the halo
// region into fp32 shared memory, then per subpixel the expand and folded
// projections over the tile's own 32 pixels, and stores each phase map
// straight to its pixels of the output (store addressing: no phase-space
// tensor and no permute). A tile that overhangs the image edge computes
// clamped pixels and stores only the pixels inside.
#include "up4_common.cuh"

namespace sunet {

constexpr int kSplitTH = 4, kSplitTW = 8, kSplitTP = kSplitTH * kSplitTW;   // low-res tile
constexpr int kSplitHW = kSplitTW + 2, kSplitH = (kSplitTH + 2) * kSplitHW;  // 1-halo
constexpr int kSplitHR = 64;   // 1-halo rows padded to 16-row tiles

struct Up4SplitArgs {
  const bf16* x;
  bf16* out;           // (B, 4H, 4W, C)
  const bf16* wexp;    // (16, C, C)
  const bf16* wb1;     // (C, C)
  const float* bb1;    // (C,)
  const bf16* wpf;     // (C, C)
  const bf16* wbf;     // (C, C)
  const float* alphas;  // (alpha_p, alpha_b)
  int B, H, W, C;
};

// x 1-halo | x tile | z | xb (fp32) | warps
__host__ __device__ inline size_t up4_split_smem_bytes(int C) {
  const int ld = C + kPad;
  return align128((size_t)kSplitHR * ld * 2) + align128((size_t)kSplitTP * ld * 2) +
         align128((size_t)kSplitHR * ld * 2) + align128((size_t)kSplitHR * (C + kPadF) * 4) +
         warp_smem_bytes();
}

__global__ void __launch_bounds__(kThreads) up4_split_kernel(Up4SplitArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.C, H = a.H, W = a.W, ld = C + kPad, ldb = C + kPadF;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* p = smem;
  bf16* x1 = reinterpret_cast<bf16*>(p);
  p += align128((size_t)kSplitHR * ld * 2);
  bf16* xt = reinterpret_cast<bf16*>(p);
  p += align128((size_t)kSplitTP * ld * 2);
  bf16* z = reinterpret_cast<bf16*>(p);
  p += align128((size_t)kSplitHR * ld * 2);
  float* xb = reinterpret_cast<float*>(p);
  p += align128((size_t)kSplitHR * ldb * 4);
  bf16* bt;
  float* stg;
  carve_warp(p, warp, bt, stg);

  const int w0 = blockIdx.x * kSplitTW, h0 = blockIdx.y * kSplitTH, b = blockIdx.z;
  const float ap = a.alphas[0], ab = a.alphas[1];
  const int cv = C / 8;
  // input with a 1-pixel halo, edge-clamped; rows past kSplitH are zero
  load_region_clamped(a.x, x1, ld, kSplitHR, kSplitTH + 2, kSplitHW, h0 - 1, w0 - 1, b, H, W,
                      C);
  __syncthreads();
  // the tile's own pixels are the halo region's interior
  for (int i = threadIdx.x; i < kSplitTP * cv; i += kThreads) {
    const int q = i / cv, c8 = i % cv;
    reinterpret_cast<uint4*>(xt + q * ld)[c8] = reinterpret_cast<const uint4*>(
        x1 + ((q / kSplitTW + 1) * kSplitHW + q % kSplitTW + 1) * ld)[c8];
  }

  // ---- bilinear branch at low res, fp32: xb = prelu(x @ wb1 + bb1) @ wbf
  bilinear_rows(x1, ld, kSplitHR / 16, z, xb, ldb, a.wb1, a.bb1, a.wbf, ab, C, bt, stg, warp, lane);

  // ---- per subpixel: pixel-shuffle branch + stencil, one rounding, stored
  // at output pixel (4h+pi, 4w+pj)
  const size_t W4 = (size_t)4 * W;
  for (int s = 0; s < 16; ++s) {
    const int pi = s / 4, pj = s % 4;
    shuffle_rows(xt, ld, kSplitTP / 16, z, s, a.wexp, a.wpf, ap, C, bt, stg, warp, lane,
                 [&](int q, int col, float v) {
                   const int tr = q / kSplitTW, tc = q % kSplitTW;
                   const int gy = h0 + tr, gx = w0 + tc;
                   if (gy >= H || gx >= W) return;
                   const size_t pix = ((size_t)b * 4 * H + 4 * gy + pi) * W4 + 4 * gx + pj;
                   a.out[pix * C + col] =
                       tobf(v + stencil4(xb, ldb, kSplitHW, tr + 1, tc + 1, pi, pj, col));
                 });
  }
}

}  // namespace sunet

using namespace sunet;

extern "C" int sunet_up4(const void* x, void* out, const void* wexp, const void* wb1,
                         const void* bb1, const void* wpf, const void* wbf, const void* alphas,
                         int B, int H, int W, int C, void* stream) {
  if (C % 16 || B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  Up4SplitArgs a{(const bf16*)x,   (bf16*)out,        (const bf16*)wexp, (const bf16*)wb1,
                 (const float*)bb1, (const bf16*)wpf, (const bf16*)wbf, (const float*)alphas,
                 B,                H,                 W,                 C};
  const size_t smem = up4_split_smem_bytes(C);
  cudaError_t e = set_smem(up4_split_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  up4_split_kernel<<<dim3((W + kSplitTW - 1) / kSplitTW, (H + kSplitTH - 1) / kSplitTH, B),
                     kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
