// Shared pieces of the x4 head's backward kernels. The split head's (#11,
// up4_bwd.cu) runs the tiled GEMM of train_common.cuh over all low-res
// pixels with the head's elementwise steps in its epilogues: the PReLU
// forward recompute and the subpixel scatter of the expand product
// (EpiPrelu, EpiPreluPhase), the PReLU derivatives with their slope
// partials (EpiPreluBwdPhase, EpiPreluBwd); the stencil adjoints
// (stencil_adj, the H-axis kernel); and the bilinear branch's chain from
// its rounded stencil adjoint to dx (up4_bilinear_bwd). The conv-fused
// head's (#9, up4_conv_bwd.cu) runs on hopper.cuh's wgmma and shares the
// phase weights kQ4, the PReLU and the stencil's clamped taps
// (stencil_taps).
//
// The 16 subpixel maps of #11's expand product are (16M, C) matrices in
// the pixel order of the (B, 4H, 4W) up-sampled map (PixelRows: its
// cotangent arrives in pixel space; the pixel -> phase addressing is in the
// epilogues, not in a permuted copy).
//
// Everything here is static, inline or a template, so several sources can
// include the header.
#pragma once

#include "train_common.cuh"

namespace sunet {

static __constant__ float kQ4[4][2] = {{0.375f, 0.625f}, {0.125f, 0.875f},
                                       {0.875f, 0.125f}, {0.625f, 0.375f}};

__device__ inline float prelu_f(float v, float a) { return fmaxf(v, 0.f) + a * fminf(v, 0.f); }

// Row maps of the subpixel matrices (m: low-res pixel b*H*W + h*W + w;
// s: subpixel i*4 + j).
struct PixelRows {   // row of pixel (b, 4h+i, 4w+j) of the (B, 4H, 4W) map
  int H, W;
  __device__ size_t row(int m, int s) const {
    const int w = m % W, h = (m / W) % H, b = m / (H * W);
    return ((size_t)b * 4 * H + 4 * h + s / 4) * 4 * W + 4 * w + s % 4;
  }
  __device__ void split(int r, int& m, int& s) const {
    const int X = r % (4 * W), rest = r / (4 * W), Y = rest % (4 * H), b = rest / (4 * H);
    s = (Y % 4) * 4 + X % 4;
    m = ((b * H) + Y / 4) * W + X / 4;
  }
};

// ---- epilogues (m: low-res pixel row b*H*W + h*W + w; s: subpixel)

struct EpiPrelu {   // z = acc + bias; pre = z (fp32), act = round(prelu(z))
  float* pre;
  bf16* act;
  const float* bias;
  const float* alpha;
  int ld;
  __device__ float operator()(int m, int n, float v, int) const {
    const size_t e = (size_t)m * ld + n;
    const float z = v + bias[n];
    pre[e] = z;
    act[e] = tobf(prelu_f(z, *alpha));
    return 0.f;
  }
};

// column n = c*16 + s of x @ w_exp -> row rows.row(m, s), column c
template <class Rows>
struct EpiPreluPhase {
  float* pre;
  bf16* act;
  const float* alpha;
  Rows rows;
  int C;
  __device__ float operator()(int m, int n, float v, int) const {
    const size_t e = rows.row(m, n % 16) * C + n / 16;
    pre[e] = v;
    act[e] = tobf(prelu_f(v, *alpha));
    return 0.f;
  }
};

// dz = prelu'(z) * acc for the subpixel branch, scattered back to the
// (M, 16C) column order c*16 + s; side: min(z, 0) * acc (the slope grad).
// kRoundDa: acc is rounded to bf16 first (#11's rounding point).
template <class Rows, bool kRoundDa>
struct EpiPreluBwdPhase {
  bf16* dz;
  const float* z;
  const float* alpha;
  Rows rows;
  int C;
  __device__ float operator()(int r, int n, float v, int) const {
    if (kRoundDa) v = bf(tobf(v));
    const float zz = z[(size_t)r * C + n];
    int m, s;
    rows.split(r, m, s);
    dz[(size_t)m * 16 * C + n * 16 + s] = tobf(zz > 0.f ? v : *alpha * v);
    return fminf(zz, 0.f) * v;
  }
};

// dz = prelu'(z) * acc for the bilinear branch: fp32 and rounded copies.
struct EpiPreluBwd {
  float* dz;
  bf16* dzb;
  const float* z;
  const float* alpha;
  int C;
  __device__ float operator()(int m, int n, float v, int) const {
    const size_t e = (size_t)m * C + n;
    const float zz = z[e], t = zz > 0.f ? v : *alpha * v;
    dz[e] = t;
    dzb[e] = tobf(t);
    return fminf(zz, 0.f) * v;
  }
};

struct EpiAddBf16 {   // out = round(base + acc)
  bf16* out;
  const float* base;
  int C;
  __device__ float operator()(int m, int n, float v, int) const {
    const size_t e = (size_t)m * C + n;
    out[e] = tobf(base[e] + v);
    return 0.f;
  }
};

// The two taps (lo, hi) of phase p at source index u of one axis (size n)
// of the x4 stencil: (u-1, u) for p = 0, 1 and (u, u+1) for p = 2, 3,
// clamped at the edges.
__device__ inline void stencil_taps(int u, int n, int p, int& lo, int& hi) {
  lo = p < 2 ? max(u - 1, 0) : u;
  hi = p < 2 ? u : min(u + 1, n - 1);
}

// Adjoint of one axis of the clamped x4 stencil at target index t (size
// n): sum over source indices u of g(u) * (a_p [lo(u) == t] + b_p [hi(u) ==
// t]) for phase p.
template <class G>
__device__ inline float stencil_adj(int t, int n, int p, G g) {
  float acc = 0.f;
  for (int u = max(t - 1, 0); u <= min(t + 1, n - 1); ++u) {
    int lo, hi;
    stencil_taps(u, n, p, lo, hi);
    const float v = g(u);
    if (lo == t) acc += kQ4[p][0] * v;
    if (hi == t) acc += kQ4[p][1] * v;
  }
  return acc;
}

// H-axis adjoint: dxb[m][c] = round(sum over phases i of the adjoint of dyh[i]).
static __global__ void stencil_h_adj_kernel(const float* __restrict__ dyh,
                                            bf16* __restrict__ dxb, int M, int H, int W, int C) {
  const size_t total = (size_t)M * C;
  for (size_t e = blockIdx.x * (size_t)kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const int c = e % C, m = e / C, w = m % W, h = (m / W) % H, b = m / (H * W);
    float acc = 0.f;
    for (int i = 0; i < 4; ++i)
      acc += stencil_adj(h, H, i, [&](int u) {
        return dyh[((size_t)i * M + ((size_t)b * H + u) * W + w) * C + c];
      });
    dxb[e] = tobf(acc);
  }
}

inline int grid_for(size_t n) { return (int)std::min<size_t>((n + kThreads - 1) / kThreads, 4096); }

// The bilinear branch's backward from its rounded stencil adjoint dxb
// (M, C): dwbf = abv^T dxb, dzb = prelu'(zb) * (dxb wbf^T) (fp32 and
// rounded, into dzb / dzb_b) with the slope sum into *dab, dwb1 = x^T
// round(dzb), dbb1 = sum dzb, then dx = round(dx32 + round(dzb) wb1^T).
// 9 launches; part and side are scratch for the split partials.
inline cudaError_t up4_bilinear_bwd(const bf16* x, const bf16* abv, const bf16* dxb,
                                    const float* zb, const bf16* wbf, const bf16* wb1,
                                    const float* ab, const float* dx32, float* dzb, bf16* dzb_b,
                                    float* dwbf, float* dab, float* dwb1, float* dbb1, bf16* dx,
                                    float* part, float* side, int M, int C, cudaStream_t st,
                                    int* n) {
  SUNET_TRY(weight_grad(abv, C, dxb, C, C, C, M, part, dwbf, st, n));
  SUNET_TRY((gemm<false, true>(dxb, C, wbf, C, M, C, C, 1, EpiPreluBwd{dzb, dzb_b, zb, ab, C},
                               side, st, n)));
  SUNET_TRY(reduce_splits(side, dab, gemm_ctas(M, C, 1), 1, 1, st, n));
  SUNET_TRY(weight_grad(x, C, dzb_b, C, C, C, M, part, dwb1, st, n));
  SUNET_TRY(colsum(dzb, M, C, part, dbb1, st, n));
  return gemm<false, true>(dzb_b, C, wb1, C, M, C, C, 1, EpiAddBf16{dx, dx32, C}, nullptr, st,
                           n);
}

}  // namespace sunet
