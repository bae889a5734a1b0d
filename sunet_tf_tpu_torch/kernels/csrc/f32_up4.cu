// The float32 form of the conv-fused x4 head (#5): the dual x4 up-sample and
// the 3x3 bias-free output conv in phase space, for a float32 model.
//
// Replaces, in float32, sunet_tf_tpu/kernels/upsample.py::
// fused_dual_upsample4_conv_phase: per subpixel s, prelu(x @ w_exp_s) @ wpf;
// the bilinear branch prelu(x @ w_b1 + b_b1) @ wbf at low resolution through
// the separable half-pixel x4 stencil with edge-clamped taps; their sum the
// phase map; then the 3x3 conv with zero padding at the image edge, written
// as (B, H, W, 16 * out): channels (i*4+j)*out .. +out at (h, w) hold pixel
// (4h+i, 4w+j). Every value float32, no rounding between the steps.
//
// What bounds it on Hopper: at (64,64,96) batch 2 the products are ~5
// GFLOP of FFMA (75 us at 67 TFLOP/s); the 4x map is 50 MB of float32. The
// bf16 kernel (csrc/up4_conv.cu) keeps a tile's 16 phase maps in shared
// memory and never writes the 4x map; in float32 one 6 x 8 tile's maps with
// their halo are 491 KB at C=96, above the 227 KB a CTA holds. This form
// writes the 4x map once and reads it once (L2 at batch 1, device memory
// above), in one cooperative launch: every CTA resident at once, walking
// the tiles of five phases with a grid-wide barrier between them:
//
//   1. zb = prelu(x @ w_b1 + b_b1, alpha_b)           (f32_tile.cuh tiles)
//   2. xb = zb @ wbf
//   3. z = prelu(x @ w_exp, alpha_p), w_exp's columns in subpixel-major order
//      (s * C + c), so z's rows are (pixel, subpixel) rows of C values
//   4. the 4x map at (4h+i, 4w+j) = z[(h, w), s] @ wpf + the stencil of xb
//      (the product's kStencil epilogue, rows written through kPhases)
//   5. the 3x3 conv over the 4x map, one thread per output pixel of a 16 x
//      16 tile, the tile's input with its 1-pixel halo staged in shared
//      memory 16 channels at a time, the weights beside it; written in
//      phase layout.
#include <cooperative_groups.h>

#include "f32_tile.cuh"

namespace f32 {

constexpr int kConvTile = 16;                    // output pixels per tile side
constexpr int kConvHalo = kConvTile + 2;
constexpr int kConvCc = 16;                      // channels per shared-memory stage
constexpr int kConvMaxOut = 8;

// One 16 x 16 tile (tile column tx0, row ty0, image b) of out (B, H, W, 16
// * O) in phase layout = conv3x3(Y) with zero padding, Y the (B, 4H, 4W, C)
// map, wconv (3, 3, C, O) HWIO.
__device__ __forceinline__ void conv_tile(const float* __restrict__ Y,
                                          const float* __restrict__ wconv,
                                          float* __restrict__ out, int H, int W, int C, int O,
                                          int tx0, int ty0, long long b) {
  __shared__ float Ys[kConvHalo * kConvHalo][kConvCc + 1];
  __shared__ __align__(16) float Ws[9 * kConvCc][kConvMaxOut];
  const int H4 = 4 * H, W4 = 4 * W;
  const int tid = threadIdx.x, tx = tid % kConvTile, ty = tid / kConvTile;
  const int x0 = tx0 * kConvTile, y0 = ty0 * kConvTile;
  float acc[kConvMaxOut] = {};
  __syncthreads();   // the CTA's previous tile is done with the shared arrays
  for (int c0 = 0; c0 < C; c0 += kConvCc) {
    for (int e = tid; e < kConvHalo * kConvHalo * kConvCc; e += kConvTile * kConvTile) {
      const int p = e / kConvCc, c = e % kConvCc;
      const int yy = y0 - 1 + p / kConvHalo, xx = x0 - 1 + p % kConvHalo;
      float v = 0.f;
      if (c0 + c < C && yy >= 0 && yy < H4 && xx >= 0 && xx < W4)
        v = Y[((b * H4 + yy) * W4 + xx) * C + c0 + c];
      Ys[p][c] = v;
    }
    for (int e = tid; e < 9 * kConvCc * kConvMaxOut; e += kConvTile * kConvTile) {
      const int tap = e / (kConvCc * kConvMaxOut), c = (e / kConvMaxOut) % kConvCc,
                o = e % kConvMaxOut;
      Ws[tap * kConvCc + c][o] =
          c0 + c < C && o < O ? wconv[((long long)tap * C + c0 + c) * O + o] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float* yrow = Ys[(ty + tap / 3) * kConvHalo + tx + tap % 3];
#pragma unroll
      for (int c = 0; c < kConvCc; ++c) {
        const float y = yrow[c];
        const float4 w0 = *reinterpret_cast<const float4*>(&Ws[tap * kConvCc + c][0]);
        const float4 w1 = *reinterpret_cast<const float4*>(&Ws[tap * kConvCc + c][4]);
        acc[0] = fmaf(y, w0.x, acc[0]);
        acc[1] = fmaf(y, w0.y, acc[1]);
        acc[2] = fmaf(y, w0.z, acc[2]);
        acc[3] = fmaf(y, w0.w, acc[3]);
        acc[4] = fmaf(y, w1.x, acc[4]);
        acc[5] = fmaf(y, w1.y, acc[5]);
        acc[6] = fmaf(y, w1.z, acc[6]);
        acc[7] = fmaf(y, w1.w, acc[7]);
      }
    }
    __syncthreads();
  }
  const int py = y0 + ty, px = x0 + tx;
  if (py >= H4 || px >= W4) return;
  float* o = out + ((b * H + py / 4) * W + px / 4) * 16 * O + ((py % 4) * 4 + px % 4) * O;
#pragma unroll
  for (int k = 0; k < kConvMaxOut; ++k)
    if (k < O) o[k] = acc[k];
}

struct UpArgs {
  Gemm g[4];   // zb, xb, z, the 4x map
  const float *y, *wconv;
  float* out;
  int H, W, C, O, B;
};

// The five phases, each CTA taking every gridDim.x-th tile, a grid-wide
// barrier after each of the four products.
__global__ void __launch_bounds__(kThreads) up4_f32_kernel(const UpArgs a) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int p = 0; p < 4; ++p) {
    const Gemm& g = a.g[p];
    const int nt = (g.N + kBN - 1) / kBN;
    for (long long t = blockIdx.x; t < gemm_tiles(g); t += gridDim.x)
      gemm_tile<false>(g, t / nt, (int)(t % nt));
    grid.sync();
  }
  const int cx = (4 * a.W + kConvTile - 1) / kConvTile, cy = (4 * a.H + kConvTile - 1) / kConvTile;
  for (long long t = blockIdx.x; t < (long long)cx * cy * a.B; t += gridDim.x)
    conv_tile(a.y, a.wconv, a.out, a.H, a.W, a.C, a.O, (int)(t % cx), (int)(t / cx % cy),
              t / ((long long)cx * cy));
}

struct UpWork {
  float *zb, *xb, *z, *y;
  size_t bytes;
};

inline UpWork carve_up(unsigned char* p, long long T, int C) {
  UpWork w{};
  size_t off = 0;
  auto take = [&](long long n) {
    float* q = reinterpret_cast<float*>(p + off);
    off += sunet::align128((size_t)n * sizeof(float));
    return q;
  };
  w.zb = take(T * C);
  w.xb = take(T * C);
  w.z = take(T * 16 * C);
  w.y = take(T * 16 * C);
  w.bytes = off;
  return w;
}

}  // namespace f32

using namespace f32;

extern "C" size_t sunet_f32_up4_conv_workspace(int B, int H, int W, int C) {
  return carve_up(nullptr, (long long)B * H * W, C).bytes;
}

// out (B, H, W, 16 * out_ch) of x (B, H, W, C); wexp (C, 16C) with its
// columns in subpixel-major order (s * C + c); wb1, wpf, wbf (C, C); bb1
// (C); wconv (3, 3, C, out_ch); alphas (alpha_p, alpha_b). One cooperative
// launch of as many CTAs as the card holds at once.
extern "C" int sunet_f32_up4_conv(const void* x, void* out, const void* wexp, const void* wb1,
                                  const void* bb1, const void* wpf, const void* wbf,
                                  const void* wconv, const void* alphas, void* work, int B, int H,
                                  int W, int C, int out_ch, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 16 || out_ch < 1 || out_ch > kConvMaxOut)
    return cudaErrorInvalidValue;
  const long long T = (long long)B * H * W;
  const UpWork w = carve_up((unsigned char*)work, T, C);
  const float* xf = (const float*)x;
  const float* al = (const float*)alphas;
  UpArgs a{};
  a.g[0] = product(xf, C, (const float*)wb1, C, (const float*)bb1, w.zb, C, T, C, C);
  a.g[0].epi = kPrelu;
  a.g[0].alpha = al + 1;
  a.g[1] = product(w.zb, C, (const float*)wbf, C, nullptr, w.xb, C, T, C, C);
  a.g[2] = product(xf, C, (const float*)wexp, 16 * C, nullptr, w.z, 16 * C, T, 16 * C, C);
  a.g[2].epi = kPrelu;
  a.g[2].alpha = al;
  a.g[3] = product(w.z, C, (const float*)wpf, C, nullptr, w.y, C, 16 * T, C, C);
  a.g[3].epi = kStencil;
  a.g[3].xb = w.xb;
  a.g[3].sh = H;
  a.g[3].sw = W;
  a.g[3].omap.kind = kPhases;
  a.g[3].omap.H = H;
  a.g[3].omap.W = W;
  for (const Gemm& g : a.g)
    if (!gemm_takes(g)) return cudaErrorInvalidValue;
  a.y = w.y;
  a.wconv = (const float*)wconv;
  a.out = (float*)out;
  a.H = H;
  a.W = W;
  a.C = C;
  a.O = out_ch;
  a.B = B;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, up4_f32_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)up4_f32_kernel, dim3(sms * per_sm),
                                    dim3(kThreads), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
