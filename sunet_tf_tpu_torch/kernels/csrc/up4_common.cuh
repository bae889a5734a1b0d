// Pieces of the x4 dual up-sample head's forward kernels: the split head
// that writes the up-sampled map (up4.cu, #10) uses all of them, the
// conv-fused phase-space head (up4_conv.cu, #5) the phase weights and PReLU.
//
// They compute the head's 16 phase maps of a tile of low-res pixels with the
// JAX kernels' rounding points: pixel-shuffle branch round(prelu(x @
// wexp[s])) @ wpf accumulated in fp32; bilinear branch round(prelu(x @ wb1 +
// bb1)) @ wbf kept in fp32 (never rounded) through the separable half-pixel
// x4 stencil; phase map = round(sum). The caller decides where a phase map
// goes (#10: the pixel-space output).
//
// Everything here is static or a template, so several sources can include
// the header.
#pragma once

#include "common.cuh"

namespace sunet {

// Half-pixel x4 phase weights: output row 4h+p samples input at h +
// (2p-3)/8 -> taps (h-1, h) for p = 0, 1 and (h, h+1) for p = 2, 3.
static __constant__ float kP4[4][2] = {{0.375f, 0.625f}, {0.125f, 0.875f},
                                       {0.875f, 0.125f}, {0.625f, 0.375f}};

__device__ inline float prelu(float v, float a) { return fmaxf(v, 0.f) + a * fminf(v, 0.f); }

// Rows q < rows*cols of the (rows x cols) region of image b whose top-left
// pixel is (gy0, gx0), pixel coordinates clamped into the image (the
// bilinear rule), into dst (row stride ld); rows q in [rows*cols, nrows)
// zero. C a multiple of 8.
__device__ inline void load_region_clamped(const bf16* __restrict__ x, bf16* dst, int ld,
                                           int nrows, int rows, int cols, int gy0, int gx0,
                                           int b, int H, int W, int C) {
  const int cv = C / 8;
  for (int i = threadIdx.x; i < nrows * cv; i += kThreads) {
    const int q = i / cv, c8 = i % cv;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q < rows * cols) {
      const int gy = min(max(gy0 + q / cols, 0), H - 1);
      const int gx = min(max(gx0 + q % cols, 0), W - 1);
      v = __ldg(reinterpret_cast<const uint4*>(x + (((size_t)b * H + gy) * W + gx) * C) + c8);
    }
    reinterpret_cast<uint4*>(dst + q * ld)[c8] = v;
  }
}

// Bilinear branch at low res over nrt 16-row tiles of xs (row stride ld):
// z = round(prelu(xs @ wb1 + bb1)) (scratch, stride ld), then xb = z @ wbf
// in fp32 (stride ldb). Ends with a block barrier.
__device__ inline void bilinear_rows(const bf16* xs, int ld, int nrt, bf16* z, float* xb,
                                     int ldb, const bf16* __restrict__ wb1,
                                     const float* __restrict__ bb1,
                                     const bf16* __restrict__ wbf, float ab, int C, bf16* bt,
                                     float* stg, int warp, int lane) {
  const int ct_n = C / 16;
  for (int t = warp; t < nrt * ct_n; t += kWarps) {
    const int rt = t / ct_n, ct = t % ct_n;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    mma_block<1, 1>(&acc, xs + rt * 16 * ld, ld, 1, wb1, C, 0, ct * 16, 0, 1, 16, C, bt, lane);
    epilogue(acc, stg, lane, [&](int r, int c, float v) {
      z[(rt * 16 + r) * ld + ct * 16 + c] = tobf(prelu(v + bb1[ct * 16 + c], ab));
    });
  }
  __syncthreads();
  for (int t = warp; t < nrt * ct_n; t += kWarps) {
    const int rt = t / ct_n, ct = t % ct_n;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    mma_block<1, 1>(&acc, z + rt * 16 * ld, ld, 1, wbf, C, 0, ct * 16, 0, 1, 16, C, bt, lane);
    wmma::store_matrix_sync(xb + rt * 16 * ldb + ct * 16, acc, ldb, wmma::mem_row_major);
  }
  __syncthreads();
}

// The bilinear branch's value at phase (pi, pj) of the pixel at (r, c) of
// the xb region (row width rw pixels, at least a 1-pixel halo around it),
// channel col: the separable half-pixel x4 stencil, fp32.
__device__ inline float stencil4(const float* xb, int ldb, int rw, int r, int c, int pi, int pj,
                                 int col) {
  const int rlo = pi < 2 ? r - 1 : r, clo = pj < 2 ? c - 1 : c;
  const float* lo = xb + (rlo * rw) * ldb + col;
  const float* hi = lo + rw * ldb;
  const float yl = kP4[pi][0] * lo[clo * ldb] + kP4[pi][1] * hi[clo * ldb];
  const float yr = kP4[pi][0] * lo[(clo + 1) * ldb] + kP4[pi][1] * hi[(clo + 1) * ldb];
  return kP4[pj][0] * yl + kP4[pj][1] * yr;
}

// Pixel-shuffle branch of subpixel s over nrt 16-row tiles of xs (row
// stride ld): z = round(prelu(xs @ wexp[s])) (scratch, stride ld), then
// store(q, col, v) with v = (z @ wpf)[q][col] in fp32, for each row q and
// column col. Ends with a block barrier.
template <class Store>
__device__ inline void shuffle_rows(const bf16* xs, int ld, int nrt, bf16* z, int s,
                                    const bf16* __restrict__ wexp, const bf16* __restrict__ wpf,
                                    float ap, int C, bf16* bt, float* stg, int warp, int lane,
                                    Store store) {
  const int ct_n = C / 16;
  for (int t = warp; t < nrt * ct_n; t += kWarps) {
    const int rt = t / ct_n, ct = t % ct_n;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    mma_block<1, 1>(&acc, xs + rt * 16 * ld, ld, 1, wexp + (size_t)s * C * C, C, 0, ct * 16, 0,
                    1, 16, C, bt, lane);
    epilogue(acc, stg, lane, [&](int r, int c, float v) {
      z[(rt * 16 + r) * ld + ct * 16 + c] = tobf(prelu(v, ap));
    });
  }
  __syncthreads();
  for (int t = warp; t < nrt * ct_n; t += kWarps) {
    const int rt = t / ct_n, ct = t % ct_n;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    mma_block<1, 1>(&acc, z + rt * 16 * ld, ld, 1, wpf, C, 0, ct * 16, 0, 1, 16, C, bt, lane);
    epilogue(acc, stg, lane,
             [&](int r, int c, float v) { store(rt * 16 + r, ct * 16 + c, v); });
  }
  __syncthreads();
}

}  // namespace sunet
