// x4 dual up-sample head + 3x3 output conv, in phase space.
//
// Replaces sunet_tf_tpu/kernels/upsample.py::fused_dual_upsample4_conv_phase:
// from x (B, H, W, C) it writes (B, H, W, 16*out), channel (i*4+j)*out + o at
// base (h, w) being the output conv at pixel (4h+i, 4w+j). Pixel-shuffle
// branch: per subpixel s, prelu(x @ wexp[s]) @ wpf. Bilinear branch:
// prelu(x @ wb1 + bb1) @ wbf at low res, then the separable half-pixel x4
// stencil with EDGE-CLAMPED taps (+-1 low-res pixel). Phase map = round(sum).
// The 3x3 bias-free conv then reads +-1 output pixel with ZERO padding at the
// image edge. The two edge rules differ.
//
// What bounds it on Hopper: the head is 36 C x C products per low-res pixel
// (2.4 GFLOP at batch 4, 64x64, C=96) against 3 MB of input; the 4x map it
// implies would be 50 MB of bf16 at batch 4, which this kernel never writes.
//
// Design: one CTA per tile of 2 x 8 low-res pixels. It loads the tile with a
// 2-pixel halo, clamped at the image edge (the bilinear rule), runs the
// bilinear branch there, then for each of the 16 subpixels the expand and
// folded projections over the 1-pixel halo and the stencil, keeping all 16
// phase maps of the 4 x 10 halo region in shared memory in bf16 (123 KB at
// C=96). The conv then runs directly over C per (pixel, phase, out) with the
// zero-pad test on the conv tap's true image position; the JAX kernel's
// 36-slot fold matmul was a TPU lane-layout device Hopper does not need.
// Halo pixels are recomputed by neighbour tiles (2.5x the pixel-shuffle
// work of the tile itself), the price of keeping the phase maps on chip.
// The tile loader, the two branches and the stencil are up4_common.cuh's,
// shared with the split head (up4.cu).
#include "up4_common.cuh"

namespace sunet {

constexpr int kTH = 2, kTW = 8;                  // low-res tile
constexpr int kE2W = kTW + 4, kE2 = (kTH + 4) * kE2W, kE2R = 80;   // 2-halo
constexpr int kE1W = kTW + 2, kE1 = (kTH + 2) * kE1W, kE1R = 48;   // 1-halo

struct Up4Args {
  const bf16* x;
  bf16* dst;          // (B, H, W, 16*out)
  const bf16* wexp;   // (16, C, C)
  const bf16* wb1;    // (C, C)
  const float* bb1;   // (C,)
  const bf16* wpf;    // (C, C)
  const bf16* wbf;    // (C, C)
  const bf16* wconv;  // (3, 3, C, out)
  const float* alphas;  // (alpha_p, alpha_b)
  int B, H, W, C, out;
};

// x 2-halo | x 1-halo | z | xb (fp32) | 16 phase maps | conv weights | warps;
// the matrices fed to tensor-core tiles have padded rows (C + kPad).
__host__ __device__ inline size_t up4_smem_bytes(int C, int out) {
  const int ld = C + kPad;
  return align128((size_t)kE2R * ld * 2) + align128((size_t)kE1R * ld * 2) +
         align128((size_t)kE2R * ld * 2) + align128((size_t)kE2R * (C + kPadF) * 4) +
         align128((size_t)16 * kE1 * C * 2) + align128((size_t)9 * C * out * 2) +
         warp_smem_bytes();
}

__global__ void __launch_bounds__(kThreads) up4_conv_kernel(Up4Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.C, H = a.H, W = a.W, ld = C + kPad, ldb = C + kPadF;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* p = smem;
  bf16* x2 = reinterpret_cast<bf16*>(p);
  p += align128((size_t)kE2R * ld * 2);
  bf16* x1 = reinterpret_cast<bf16*>(p);
  p += align128((size_t)kE1R * ld * 2);
  bf16* z = reinterpret_cast<bf16*>(p);
  p += align128((size_t)kE2R * ld * 2);
  float* xb = reinterpret_cast<float*>(p);
  p += align128((size_t)kE2R * ldb * 4);
  bf16* y = reinterpret_cast<bf16*>(p);
  p += align128((size_t)16 * kE1 * C * 2);
  bf16* wc = reinterpret_cast<bf16*>(p);
  p += align128((size_t)9 * C * a.out * 2);
  bf16* bt;
  float* stg;
  carve_warp(p, warp, bt, stg);

  const int w0 = blockIdx.x * kTW, h0 = blockIdx.y * kTH, b = blockIdx.z;
  const float ap = a.alphas[0], ab = a.alphas[1];
  const int cv = C / 8;
  // input with a 2-pixel halo, edge-clamped; rows past kE2 are zero
  load_region_clamped(a.x, x2, ld, kE2R, kTH + 4, kE2W, h0 - 2, w0 - 2, b, H, W, C);
  for (int i = threadIdx.x; i < 9 * C * a.out; i += kThreads) wc[i] = a.wconv[i];
  __syncthreads();
  // the 1-halo rows are a subset of the 2-halo ones
  for (int i = threadIdx.x; i < kE1R * cv; i += kThreads) {
    const int q = i / cv, c8 = i % cv;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q < kE1) v = reinterpret_cast<const uint4*>(x2 + ((q / kE1W + 1) * kE2W + q % kE1W + 1) * ld)[c8];
    reinterpret_cast<uint4*>(x1 + q * ld)[c8] = v;
  }

  // ---- bilinear branch at low res: xb = prelu(x @ wb1 + bb1) @ wbf
  bilinear_rows(x2, ld, kE2R / 16, z, xb, ldb, a.wb1, a.bb1, a.wbf, ab, C, bt, stg, warp, lane);

  // ---- 16 phase maps over the 1-halo region
  for (int s = 0; s < 16; ++s) {
    const int pi = s / 4, pj = s % 4;
    shuffle_rows(x1, ld, kE1R / 16, z, s, a.wexp, a.wpf, ap, C, bt, stg, warp, lane,
                 [&](int q, int col, float v) {
                   if (q >= kE1) return;
                   // stencil taps in 2-halo coordinates around this pixel
                   const int r2 = q / kE1W + 1, c2 = q % kE1W + 1;
                   y[((size_t)s * kE1 + q) * C + col] =
                       tobf(v + stencil4(xb, ldb, kE2W, r2, c2, pi, pj, col));
                 });
  }

  // ---- 3x3 conv over the phase maps, zero padding at the image edge
  const int nout = kTH * kTW * 16 * a.out;
  for (int idx = threadIdx.x; idx < nout; idx += kThreads) {
    const int o = idx % a.out, ph = (idx / a.out) % 16, px = idx / (a.out * 16);
    const int tr = px / kTW, tc = px % kTW, i = ph / 4, j = ph % 4;
    float acc = 0.f;
    for (int dy = -1; dy <= 1; ++dy) {
      const int hi = i + dy, ro = hi < 0 ? -1 : (hi > 3 ? 1 : 0);
      const int gy = h0 + tr + ro;
      if (gy < 0 || gy >= H) continue;
      for (int dx = -1; dx <= 1; ++dx) {
        const int wi = j + dx, co = wi < 0 ? -1 : (wi > 3 ? 1 : 0);
        const int gx = w0 + tc + co;
        if (gx < 0 || gx >= W) continue;
        const int sph = (hi - 4 * ro) * 4 + (wi - 4 * co);
        const bf16* yv = y + ((size_t)sph * kE1 + (tr + ro + 1) * kE1W + tc + co + 1) * C;
        const bf16* wv = wc + ((dy + 1) * 3 + dx + 1) * C * a.out + o;
        for (int c = 0; c < C; ++c) acc += bf(yv[c]) * bf(wv[c * a.out]);
      }
    }
    a.dst[(((size_t)b * H + h0 + tr) * W + w0 + tc) * 16 * a.out + ph * a.out + o] = tobf(acc);
  }
}

}  // namespace sunet

using namespace sunet;

extern "C" int sunet_up4_conv_phase(const void* x, void* dst, const void* wexp,
                                    const void* wb1, const void* bb1, const void* wpf,
                                    const void* wbf, const void* wconv,
                                    const void* alphas, int B, int H, int W, int C,
                                    int out, void* stream) {
  if (C % 16 || H % kTH || W % kTW || out < 1) return (int)cudaErrorInvalidValue;
  Up4Args a{(const bf16*)x,   (bf16*)dst,        (const bf16*)wexp,
            (const bf16*)wb1, (const float*)bb1, (const bf16*)wpf,
            (const bf16*)wbf, (const bf16*)wconv, (const float*)alphas,
            B,                H,                 W,
            C,                out};
  const size_t smem = up4_smem_bytes(C, out);
  cudaError_t e = set_smem(up4_conv_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  up4_conv_kernel<<<dim3(W / kTW, H / kTH, B), kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
