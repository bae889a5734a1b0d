// Backward of the split x4 dual up-sample head.
//
// Replaces sunet_tf_tpu/kernels/upsample.py::_up4_bwd_impl (its kernel
// _up4_bwd_kernel), the backward of fused_dual_upsample4 (up4.cu, #10) behind
// dual_upsample4_trainable: from x (B, H, W, C), the pixel-space cotangent
// dout (B, 4H, 4W, C) and the head's weights it recomputes the subpixel
// pre-activations and returns dx, dW_exp (C, 16C), dW_b1, db_b1, dwpf, dwbf
// and the two PReLU-slope sums. The plain version is up4_bwd_reference in
// kernels/upsample.py; the rounding points are the JAX kernel's: dout
// rounded to bf16; dP = dout wpf^T rounded before the PReLU derivative; dz
// rounded for dW_exp and dx; the bilinear adjoint in fp32 on the rounded
// dout, its result rounded for dwbf and the 1x1 chain.
//
// What bounds it on Hopper: the products, 85 C^2 multiply-adds per low-res
// pixel (the expand and its projection recomputed, two products per head
// product): 12.8 GFLOP at (64,64,96) batch 2, ~13 us at the bf16 peak.
//
// Design, first version (right and simple): #9's launch sequence
// (up4_conv_bwd.cu) without the conv adjoint and the per-slot conv grads.
// The subpixel products run over the (16M, C) matrices in the pixel order
// of the up-sampled map, so dout is read as it arrives: the expand's
// epilogue scatters each subpixel's pre-activation to its pixel row, and the
// dP product's epilogue maps each pixel row back to (pixel, subpixel) for the
// (M, 16C) dz (up4_bwd.cuh's PixelRows). The W-axis stencil adjoint reads
// dout in pixel space; the H-axis adjoint and the bilinear chain are #9's.
// Weight grads sum over fixed pixel chunks, then in a fixed order; the slope
// sums reduce per-CTA partials in a fixed order: the same bits every run.
// 20 launches.
#include "up4_bwd.cuh"

namespace sunet {

struct Up4SplitBwdArgs {
  const bf16 *x, *dout, *wexp, *wb1;
  const float* bb1;
  const bf16 *wpf, *wbf;
  const float* alphas;
  bf16* dx;
  float *dwexp, *dalphas, *dwb1, *dbb1, *dwpf, *dwbf;
  int B, H, W, C;
};

// W-axis adjoint of the pixel-space cotangent: dyh[i][m][c] = sum over
// phases j of the adjoint of dout's pixels (4h+i, 4u+j), fp32.
__global__ void stencil_w_adj_pix_kernel(const bf16* __restrict__ dout, float* __restrict__ dyh,
                                         int M, int H, int W, int C) {
  const size_t total = (size_t)4 * M * C;
  for (size_t e = blockIdx.x * (size_t)kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const int c = e % C;
    const size_t r = e / C;
    const int m = r % M, i = r / M, w = m % W, h = (m / W) % H, b = m / (H * W);
    const bf16* row = dout + ((size_t)b * 4 * H + 4 * h + i) * 4 * W * C + c;
    float acc = 0.f;
    for (int j = 0; j < 4; ++j)
      acc += stencil_adj(w, W, j, [&](int u) { return bf(row[(size_t)(4 * u + j) * C]); });
    dyh[e] = acc;
  }
}

struct Up4SplitWork {
  float *zb, *zf, *dx, *dyh, *dzb, *part, *side;
  bf16 *abv, *a, *dz, *dxb, *dzb_b;
  size_t bytes;
};

inline Up4SplitWork carve_up4_split(unsigned char* p, int M, int C) {
  Carve cv{p};
  Up4SplitWork w;
  const size_t mc = (size_t)M * C;
  w.zb = cv.take<float>(mc);
  w.zf = cv.take<float>(16 * mc);
  w.dx = cv.take<float>(mc);
  w.dyh = cv.take<float>(4 * mc);
  w.dzb = cv.take<float>(mc);
  w.abv = cv.take<bf16>(mc);
  w.a = cv.take<bf16>(16 * mc);
  w.dz = cv.take<bf16>(16 * mc);
  w.dxb = cv.take<bf16>(mc);
  w.dzb_b = cv.take<bf16>(mc);
  size_t part = (size_t)((M + kColRows - 1) / kColRows) * C;
  const int dims[3][3] = {{C, C, 16 * M}, {C, 16 * C, M}, {C, C, M}};
  for (auto& d : dims) part = std::max(part, (size_t)gemm_splits(d[0], d[1], d[2]) * d[0] * d[1]);
  w.part = cv.take<float>(part);
  w.side = cv.take<float>(gemm_ctas(16 * M, C, 1));
  w.bytes = cv.used;
  return w;
}

cudaError_t up4_split_bwd(const Up4SplitBwdArgs& a, const Up4SplitWork& w, cudaStream_t st,
                          int* n) {
  const int M = a.B * a.H * a.W, C = a.C;
  const float *ap = a.alphas, *ab = a.alphas + 1;   // the PReLU slopes (device)
  const PixelRows pix{a.H, a.W};

  // ---- forward recompute: the bilinear pre-activation, the subpixel ones
  // in pixel order
  SUNET_TRY((gemm<false, false>(a.x, C, a.wb1, C, M, C, C, 1,
                                EpiPrelu{w.zb, w.abv, a.bb1, ab, C}, nullptr, st, n)));
  SUNET_TRY((gemm<false, false>(a.x, C, a.wexp, 16 * C, M, 16 * C, C, 1,
                                EpiPreluPhase<PixelRows>{w.zf, w.a, ap, pix, C}, nullptr, st,
                                n)));

  // ---- pixel-shuffle branch, over the up-sampled map's pixels
  SUNET_TRY(weight_grad(w.a, C, a.dout, C, C, C, 16 * M, w.part, a.dwpf, st, n));
  SUNET_TRY((gemm<false, true>(a.dout, C, a.wpf, C, 16 * M, C, C, 1,
                               EpiPreluBwdPhase<PixelRows, true>{w.dz, w.zf, ap, pix, C}, w.side,
                               st, n)));
  SUNET_TRY(reduce_splits(w.side, a.dalphas, gemm_ctas(16 * M, C, 1), 1, 1, st, n));
  SUNET_TRY(weight_grad(a.x, C, w.dz, 16 * C, C, 16 * C, M, w.part, a.dwexp, st, n));
  SUNET_TRY((gemm<false, true>(w.dz, 16 * C, a.wexp, 16 * C, M, C, 16 * C, 1,
                               EpiF32{w.dx, C, 0}, nullptr, st, n)));

  // ---- bilinear branch: the stencil adjoints, then the 1x1 chain
  stencil_w_adj_pix_kernel<<<grid_for((size_t)4 * M * C), kThreads, 0, st>>>(a.dout, w.dyh, M,
                                                                             a.H, a.W, C);
  SUNET_TRY(launched(n));
  stencil_h_adj_kernel<<<grid_for((size_t)M * C), kThreads, 0, st>>>(w.dyh, w.dxb, M, a.H, a.W,
                                                                     C);
  SUNET_TRY(launched(n));
  return up4_bilinear_bwd(a.x, w.abv, w.dxb, w.zb, a.wbf, a.wb1, ab, w.dx, w.dzb, w.dzb_b,
                          a.dwbf, a.dalphas + 1, a.dwb1, a.dbb1, a.dx, w.part, w.side, M, C, st,
                          n);
}

}  // namespace sunet

using namespace sunet;

extern "C" size_t sunet_up4_bwd_workspace(int B, int H, int W, int C) {
  return carve_up4_split(nullptr, B * H * W, C).bytes;
}

extern "C" int sunet_up4_bwd(const void* x, const void* dout, const void* wexp, const void* wb1,
                             const void* bb1, const void* wpf, const void* wbf,
                             const void* alphas, void* dx, void* dwexp, void* dalphas,
                             void* dwb1, void* dbb1, void* dwpf, void* dwbf, void* work, int B,
                             int H, int W, int C, int* launches, void* stream) {
  if (C % 16 || B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  Up4SplitBwdArgs a{(const bf16*)x,    (const bf16*)dout, (const bf16*)wexp,  (const bf16*)wb1,
                    (const float*)bb1, (const bf16*)wpf,  (const bf16*)wbf,   (const float*)alphas,
                    (bf16*)dx,         (float*)dwexp,     (float*)dalphas,    (float*)dwb1,
                    (float*)dbb1,      (float*)dwpf,      (float*)dwbf,       B,
                    H,                 W,                 C};
  const Up4SplitWork w = carve_up4_split((unsigned char*)work, B * H * W, C);
  *launches = 0;
  return (int)up4_split_bwd(a, w, (cudaStream_t)stream, launches);
}
