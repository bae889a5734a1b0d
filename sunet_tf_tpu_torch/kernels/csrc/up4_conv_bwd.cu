// Backward of the x4 dual up-sample head + 3x3 output conv, phase space.
//
// Replaces sunet_tf_tpu/kernels/upsample.py::_up4c_bwd_impl (its kernel
// _up4c_bwd_kernel): from x (B, H, W, C), the phase-space cotangent dout
// (B, H, W, 16*out) and the head's weights it recomputes the 16 phase maps
// and returns dx, dW_exp, dW_b1, db_b1, dwpf, dwbf, the two PReLU-slope
// sums and the per-slot conv grads dwfold (36, C, 16*out), which the
// wrapper unfolds to (3, 3, C, out) (JAX unfold_output_conv4_grad). The
// plain version is up4_conv_bwd_reference in kernels/upsample.py; the
// rounding points are the JAX kernel's.
//
// Edge rules carried over from the forward: the bilinear taps CLAMP at the
// image edge (their adjoint folds the clamped taps back onto the edge
// pixel), the 3x3 conv ZERO-pads (taps off the image read and receive
// nothing).
//
// What bounds it on Hopper: the products, ~2x the head's forward work
// (about 4.9 GFLOP at (64,64,96) batch 2, 5 us at the bf16 peak), and the
// 16 phase maps with their gradients, ~0.3 GB at batch 2 in this version
// (~0.1 ms at 3.35 TB/s).
//
// Design, first version (right and simple): a fixed sequence of launches
// over all B*H*W low-res pixels. The products run through the tiled GEMM
// of train_common.cuh with each elementwise step (PReLU and its
// derivative, the bilinear stencil, the phase-major scatter) in its
// epilogue; the 16 phase maps, the conv adjoint dY and the stencil
// adjoints are kept in device memory between launches (the TPU kernel kept
// them in VMEM; fusing them back on chip is later work). The conv adjoint,
// the per-slot conv grads and the stencil adjoints are small direct
// kernels. Weight grads sum over pixels in fixed chunks, then in a fixed
// order; the PReLU-slope sums reduce per-CTA partials in a fixed order.
#include "train_common.cuh"

namespace sunet {

__constant__ float kQ4[4][2] = {{0.375f, 0.625f}, {0.125f, 0.875f},
                                {0.875f, 0.125f}, {0.625f, 0.375f}};

__device__ inline float prelu_f(float v, float a) { return fmaxf(v, 0.f) + a * fminf(v, 0.f); }

struct Up4BwdArgs {
  const bf16 *x, *dout, *wexp, *wb1;
  const float* bb1;
  const bf16 *wpf, *wbf, *wconv;
  const float* alphas;
  bf16* dx;
  float *dwexp, *dalphas, *dwb1, *dbb1, *dwpf, *dwbf, *dwfold;
  int B, H, W, C, out;
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

struct EpiPreluPhase {   // column n = c*16 + s of x @ w_exp -> phase-major rows s*M + m
  float* pre;
  bf16* act;
  const float* alpha;
  int M, C;
  __device__ float operator()(int m, int n, float v, int) const {
    const size_t e = ((size_t)(n % 16) * M + m) * C + n / 16;
    pre[e] = v;
    act[e] = tobf(prelu_f(v, *alpha));
    return 0.f;
  }
};

// y_s = round(ps + stencil_s(xb)): the separable half-pixel x4 bilinear
// stencil of phase s = (i, j) with edge-clamped taps.
struct EpiStencil {
  bf16* y;
  const float* xb;
  int M, H, W, C;
  __device__ float operator()(int r, int n, float v, int) const {
    const int s = r / M, m = r % M, i = s / 4, j = s % 4;
    const int w = m % W, h = (m / W) % H, b = m / (H * W);
    const int rlo = i < 2 ? max(h - 1, 0) : h, rhi = i < 2 ? h : min(h + 1, H - 1);
    const int clo = j < 2 ? max(w - 1, 0) : w, chi = j < 2 ? w : min(w + 1, W - 1);
    auto at = [&](int hh, int ww) { return xb[(((size_t)b * H + hh) * W + ww) * C + n]; };
    const float yl = kQ4[i][0] * at(rlo, clo) + kQ4[i][1] * at(rhi, clo);
    const float yr = kQ4[i][0] * at(rlo, chi) + kQ4[i][1] * at(rhi, chi);
    y[(size_t)r * C + n] = tobf(v + (kQ4[j][0] * yl + kQ4[j][1] * yr));
    return 0.f;
  }
};

// dz = prelu'(z) * acc for the subpixel branch, scattered back to the
// (M, 16C) column order c*16 + s; side: min(z, 0) * acc (the slope grad).
struct EpiPreluBwdPhase {
  bf16* dz;
  const float* z;
  const float* alpha;
  int M, C;
  __device__ float operator()(int r, int n, float v, int) const {
    const float zz = z[(size_t)r * C + n];
    const int s = r / M, m = r % M;
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

// Conv adjoint: dY[s][m][c] at pixel P = (4h+i, 4w+j) = sum over taps
// (dy, dx) and out o of dout_pix[P - (dy, dx)][o] * wconv[dy+1][dx+1][c][o],
// taps off the image skipped (zero padding); fp32 and rounded copies.
__global__ void conv_adjoint_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ wconv,
                                    float* __restrict__ dyf, bf16* __restrict__ dyb, int M,
                                    int H, int W, int C, int out) {
  const size_t total = (size_t)16 * M * C;
  const int O = 16 * out;
  for (size_t e = blockIdx.x * (size_t)kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const int c = e % C;
    const size_t r = e / C;
    const int m = r % M, s = r / M, i = s / 4, j = s % 4;
    const int w = m % W, h = (m / W) % H, b = m / (H * W);
    const int py = 4 * h + i, px = 4 * w + j;
    float acc = 0.f;
    for (int dy = -1; dy <= 1; ++dy) {
      const int qy = py - dy;
      if (qy < 0 || qy >= 4 * H) continue;
      for (int dx = -1; dx <= 1; ++dx) {
        const int qx = px - dx;
        if (qx < 0 || qx >= 4 * W) continue;
        const bf16* d = dout + (((size_t)b * H + qy / 4) * W + qx / 4) * O +
                        ((qy % 4) * 4 + qx % 4) * out;
        const bf16* wv = wconv + ((size_t)((dy + 1) * 3 + dx + 1) * C + c) * out;
        for (int o = 0; o < out; ++o) acc += bf(d[o]) * bf(wv[o]);
      }
    }
    dyf[e] = acc;
    dyb[e] = tobf(acc);
  }
}

// Per-slot conv grads over a chunk of pixels: part[z][slot][c][col] = sum
// over pixels m of the chunk of t_slot[m][c] * dout[m][col], t_slot the
// phase map (pi, pj) of slot (uh, uw) shifted by (dh, dw), zero off the
// image. grid (36 slots, chunks).
constexpr int kFoldRows = 32;
constexpr int kFoldOut = 48;   // outputs per thread: C*16*out <= 256*48
__constant__ int kSlotOff[6] = {-1, 0, 0, 0, 0, 1};
__constant__ int kSlotPh[6] = {3, 0, 1, 2, 3, 0};

__global__ void __launch_bounds__(kThreads)
    dwfold_kernel(const bf16* __restrict__ y, const bf16* __restrict__ dout,
                  float* __restrict__ part, int M, int H, int W, int C, int O, int rows) {
  __shared__ bf16 ty[kFoldRows * 96];
  __shared__ bf16 td[kFoldRows * 128];
  const int slot = blockIdx.x, uh = slot / 6, uw = slot % 6;
  const int dh = kSlotOff[uh], dw = kSlotOff[uw], ph = kSlotPh[uh] * 4 + kSlotPh[uw];
  const int n_out = C * O;
  float acc[kFoldOut];
#pragma unroll
  for (int q = 0; q < kFoldOut; ++q) acc[q] = 0.f;
  const int m0 = blockIdx.y * rows, m1 = min(M, m0 + rows);
  for (int mb = m0; mb < m1; mb += kFoldRows) {
    for (int e = threadIdx.x; e < kFoldRows * C; e += kThreads) {
      const int r = e / C, c = e % C, m = mb + r;
      float v = 0.f;
      if (m < m1) {
        const int w = m % W, h = (m / W) % H, b = m / (H * W);
        const int hh = h + dh, ww = w + dw;
        if (hh >= 0 && hh < H && ww >= 0 && ww < W)
          v = bf(y[((size_t)ph * M + ((size_t)b * H + hh) * W + ww) * C + c]);
      }
      ty[e] = tobf(v);
    }
    for (int e = threadIdx.x; e < kFoldRows * O; e += kThreads) {
      const int r = e / O, m = mb + r;
      td[e] = m < m1 ? dout[(size_t)m * O + e % O] : tobf(0.f);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kFoldOut; ++q) {
      const int o = threadIdx.x + q * kThreads;
      if (o >= n_out) break;
      const int c = o / O, col = o % O;
      float s = 0.f;
      for (int r = 0; r < kFoldRows; ++r) s += bf(ty[r * C + c]) * bf(td[r * O + col]);
      acc[q] += s;
    }
    __syncthreads();
  }
  float* dst = part + ((size_t)blockIdx.y * 36 + slot) * n_out;
#pragma unroll
  for (int q = 0; q < kFoldOut; ++q) {
    const int o = threadIdx.x + q * kThreads;
    if (o < n_out) dst[o] = acc[q];
  }
}

// Adjoint of one axis of the clamped x4 stencil at target index t (size
// n): sum over source indices u of g(u) * (a_p [lo(u) == t] + b_p [hi(u) ==
// t]) for phase p.
template <class G>
__device__ inline float stencil_adj(int t, int n, int p, G g) {
  float acc = 0.f;
  for (int u = max(t - 1, 0); u <= min(t + 1, n - 1); ++u) {
    const int lo = p < 2 ? max(u - 1, 0) : u, hi = p < 2 ? u : min(u + 1, n - 1);
    const float v = g(u);
    if (lo == t) acc += kQ4[p][0] * v;
    if (hi == t) acc += kQ4[p][1] * v;
  }
  return acc;
}

// W-axis adjoint: dyh[i][m][c] = sum over phases j of the adjoint of dY[i*4+j].
__global__ void stencil_w_adj_kernel(const float* __restrict__ dyf, float* __restrict__ dyh,
                                     int M, int H, int W, int C) {
  const size_t total = (size_t)4 * M * C;
  for (size_t e = blockIdx.x * (size_t)kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const int c = e % C;
    const size_t r = e / C;
    const int m = r % M, i = r / M, w = m % W, row = m - w;
    float acc = 0.f;
    for (int j = 0; j < 4; ++j)
      acc += stencil_adj(w, W, j, [&](int u) {
        return dyf[((size_t)(i * 4 + j) * M + row + u) * C + c];
      });
    dyh[e] = acc;
  }
}

// H-axis adjoint: dxb[m][c] = round(sum over phases i of the adjoint of dyh[i]).
__global__ void stencil_h_adj_kernel(const float* __restrict__ dyh, bf16* __restrict__ dxb,
                                     int M, int H, int W, int C) {
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

struct Up4Work {
  float *zb, *xb, *zf, *dyf, *dx, *dyh, *dzb, *part, *side;
  bf16 *abv, *a, *y, *dyb, *dz, *dxb, *dzb_b;
  int fold_splits;
  size_t bytes;
};

inline Up4Work carve_up4(unsigned char* p, int M, int C, int out) {
  Carve cv{p};
  Up4Work w;
  const size_t mc = (size_t)M * C;
  w.zb = cv.take<float>(mc);
  w.xb = cv.take<float>(mc);
  w.zf = cv.take<float>(16 * mc);
  w.dyf = cv.take<float>(16 * mc);
  w.dx = cv.take<float>(mc);
  w.dyh = cv.take<float>(4 * mc);
  w.dzb = cv.take<float>(mc);
  w.abv = cv.take<bf16>(mc);
  w.a = cv.take<bf16>(16 * mc);
  w.y = cv.take<bf16>(16 * mc);
  w.dyb = cv.take<bf16>(16 * mc);
  w.dz = cv.take<bf16>(16 * mc);
  w.dxb = cv.take<bf16>(mc);
  w.dzb_b = cv.take<bf16>(mc);
  const int O = 16 * out;
  w.fold_splits = std::max(1, std::min(M / 256, (264 + 35) / 36));
  size_t part = (size_t)w.fold_splits * 36 * C * O;
  const int dims[3][3] = {{C, C, 16 * M}, {C, 16 * C, M}, {C, C, M}};
  for (auto& d : dims) part = std::max(part, (size_t)gemm_splits(d[0], d[1], d[2]) * d[0] * d[1]);
  part = std::max(part, (size_t)((M + kColRows - 1) / kColRows) * C);
  w.part = cv.take<float>(part);
  w.side = cv.take<float>(gemm_ctas(16 * M, C, 1));
  w.bytes = cv.used;
  return w;
}

cudaError_t up4_bwd(const Up4BwdArgs& a, const Up4Work& w, cudaStream_t st, int* n) {
  const int M = a.B * a.H * a.W, C = a.C, O = 16 * a.out;
  const float *ap = a.alphas, *ab = a.alphas + 1;   // the PReLU slopes (device)

  // ---- forward recompute: bilinear branch at low res, the 16 phase maps
  SUNET_TRY((gemm<false, false>(a.x, C, a.wb1, C, M, C, C, 1,
                                    EpiPrelu{w.zb, w.abv, a.bb1, ab, C}, nullptr, st, n)));
  SUNET_TRY((gemm<false, false>(w.abv, C, a.wbf, C, M, C, C, 1, EpiF32{w.xb, C, 0}, nullptr,
                                    st, n)));
  SUNET_TRY((gemm<false, false>(a.x, C, a.wexp, 16 * C, M, 16 * C, C, 1,
                                    EpiPreluPhase{w.zf, w.a, ap, M, C}, nullptr, st, n)));
  SUNET_TRY((gemm<false, false>(w.a, C, a.wpf, C, 16 * M, C, C, 1,
                                    EpiStencil{w.y, w.xb, M, a.H, a.W, C}, nullptr, st, n)));

  // ---- the conv: per-slot grads, then its adjoint into the phase maps
  const int rows = ((M + w.fold_splits - 1) / w.fold_splits + kFoldRows - 1) / kFoldRows *
                   kFoldRows;
  dwfold_kernel<<<dim3(36, w.fold_splits), kThreads, 0, st>>>(w.y, a.dout, w.part, M, a.H, a.W,
                                                             C, O, rows);
  SUNET_TRY(launched(n));
  SUNET_TRY(reduce_splits(w.part, a.dwfold, w.fold_splits, (size_t)36 * C * O,
                              (size_t)36 * C * O, st, n));
  conv_adjoint_kernel<<<grid_for((size_t)16 * M * C), kThreads, 0, st>>>(
      a.dout, a.wconv, w.dyf, w.dyb, M, a.H, a.W, C, a.out);
  SUNET_TRY(launched(n));

  // ---- pixel-shuffle branch
  SUNET_TRY(weight_grad(w.a, C, w.dyb, C, C, C, 16 * M, w.part, a.dwpf, st, n));
  SUNET_TRY((gemm<false, true>(w.dyb, C, a.wpf, C, 16 * M, C, C, 1,
                                   EpiPreluBwdPhase{w.dz, w.zf, ap, M, C}, w.side, st, n)));
  SUNET_TRY(reduce_splits(w.side, a.dalphas, gemm_ctas(16 * M, C, 1), 1, 1, st, n));
  SUNET_TRY(weight_grad(a.x, C, w.dz, 16 * C, C, 16 * C, M, w.part, a.dwexp, st, n));
  SUNET_TRY((gemm<false, true>(w.dz, 16 * C, a.wexp, 16 * C, M, C, 16 * C, 1,
                                   EpiF32{w.dx, C, 0}, nullptr, st, n)));

  // ---- bilinear branch: the stencil adjoints, then the 1x1 chain
  stencil_w_adj_kernel<<<grid_for((size_t)4 * M * C), kThreads, 0, st>>>(w.dyf, w.dyh, M, a.H,
                                                                         a.W, C);
  SUNET_TRY(launched(n));
  stencil_h_adj_kernel<<<grid_for((size_t)M * C), kThreads, 0, st>>>(w.dyh, w.dxb, M, a.H, a.W,
                                                                     C);
  SUNET_TRY(launched(n));
  SUNET_TRY(weight_grad(w.abv, C, w.dxb, C, C, C, M, w.part, a.dwbf, st, n));
  SUNET_TRY((gemm<false, true>(w.dxb, C, a.wbf, C, M, C, C, 1,
                                   EpiPreluBwd{w.dzb, w.dzb_b, w.zb, ab, C}, w.side, st, n)));
  SUNET_TRY(reduce_splits(w.side, a.dalphas + 1, gemm_ctas(M, C, 1), 1, 1, st, n));
  SUNET_TRY(weight_grad(a.x, C, w.dzb_b, C, C, C, M, w.part, a.dwb1, st, n));
  SUNET_TRY(colsum(w.dzb, M, C, w.part, a.dbb1, st, n));
  SUNET_TRY((gemm<false, true>(w.dzb_b, C, a.wb1, C, M, C, C, 1,
                                   EpiAddBf16{a.dx, w.dx, C}, nullptr, st, n)));
  return cudaSuccess;
}

}  // namespace sunet

using namespace sunet;

extern "C" size_t sunet_up4_conv_bwd_workspace(int B, int H, int W, int C, int out) {
  return carve_up4(nullptr, B * H * W, C, out).bytes;
}

extern "C" int sunet_up4_conv_bwd(const void* x, const void* dout, const void* wexp,
                                  const void* wb1, const void* bb1, const void* wpf,
                                  const void* wbf, const void* wconv, const void* alphas,
                                  void* dx, void* dwexp, void* dalphas, void* dwb1, void* dbb1,
                                  void* dwpf, void* dwbf, void* dwfold, void* work, int B, int H,
                                  int W, int C, int out, int* launches, void* stream) {
  if (C % 16 || C > 96 || out < 1 || out > 8) return (int)cudaErrorInvalidValue;
  Up4BwdArgs a{(const bf16*)x,    (const bf16*)dout,    (const bf16*)wexp, (const bf16*)wb1,
               (const float*)bb1, (const bf16*)wpf,     (const bf16*)wbf,  (const bf16*)wconv,
               (const float*)alphas, (bf16*)dx,         (float*)dwexp,     (float*)dalphas,
               (float*)dwb1,      (float*)dbb1,         (float*)dwpf,      (float*)dwbf,
               (float*)dwfold,    B,                    H,                 W,
               C,                 out};
  const Up4Work w = carve_up4((unsigned char*)work, B * H * W, C, out);
  *launches = 0;
  return (int)up4_bwd(a, w, (cudaStream_t)stream, launches);
}
