// Split x4 dual up-sample head: writes the up-sampled map, two launches.
//
// Replaces sunet_tf_tpu/kernels/upsample.py::fused_dual_upsample4 (its
// kernel _up4_kernel), the model's x4 head where the conv-fused head does
// not apply (16 * out_chans > 128): from x (B, H, W, C) it writes (B, 4H,
// 4W, C) in bf16, pixel (4h+i, 4w+j) being phase map s = i*4+j at (h, w).
// Rounding points (the JAX kernel's): a_s = round(prelu(x wexp_s)), the
// pixel-shuffle branch a_s wpf accumulated in fp32; abv = round(prelu(x
// wb1 + bb1)), xb = abv wbf kept in fp32 (never rounded) through the
// half-pixel x4 stencil with EDGE-CLAMPED taps; one rounding of the sum.
//
// What bounds it on Hopper: the 16x output. At (64,64,96) batch 2 it writes
// 25 MB of bf16 against 1.6 MB read and 5.8 GFLOP of products (68 C^2 per
// low-res pixel): ~8 us at 3.35 TB/s, the bytes bound.
//
// Design: every product on hopper.cuh's wgmma, operands in shared memory in
// the 128-byte swizzled layout, x tiles, weights and stencil taps by TMA,
// the output written by TMA:
//   1. prep: 64-pixel strips of x (up4_bwd.cuh's prep_strip, shared with
//      #9 and #11): abv = round(prelu(x wb1 + bb1)), xb = abv wbf in fp32,
//      written into a map with a one-pixel border that repeats the edge
//      (B, H + 2, W + 2, C), so that the clamp is in the data; a few CTAs
//      lay w_exp out by phase (up4_bwd.cuh's prep_copy).
//   2. phase: CTA (chunk of 8 x 8 low-res tiles, phase s = 4i + j). wexp_s
//      and wpf stream through hop::Ring's weight ring, held for the whole
//      chunk where both fit the ring (C <= 128: loaded once per CTA), else
//      reloaded per tile. Per tile: x's 64 rows arrive by TMA (the next
//      tile's as soon as this one's expand is done); a = round(prelu(x
//      wexp_s)) goes into the swizzled A operand, then Y = a wpf; the
//      epilogue adds stencil_s(xb) from the 9 x 9 pixel box of the bordered
//      xb that phase s reads (TMA, 32 channels a box, 128-byte swizzle),
//      rounds once and stages each 64-column box, which one TMA store
//      writes to the phase's pixels (element strides 4 on both pixel axes;
//      TMA skips what lies past the image, so ragged maps need no
//      masking). A tile's chain is serial and latency-bound, so where C <=
//      128 each warpgroup runs its own tiles on its own buffers and the
//      two chains overlap; wider, both warpgroups run each tile (warpgroup
//      w: 64-column boxes w, w + 2).
// Plans are functions of one image's shape (kernels/upsample.py::
// up4_split_plan mirrors up4_split_plan); the same bits every run.
#include "up4_bwd.cuh"

namespace sunet {
namespace u4f {

using namespace u4;

constexpr int kUpChunks = 16;      // tile chunks of the phase launch at kPlanBatch images
constexpr int kSlot = 32768;       // bytes of a weight-ring slot: one K chunk of every box
constexpr int kTapRows = 81;       // a phase's stencil taps of an 8 x 8 tile: 9 x 9 pixels
constexpr int kTapHalf = 11264;    // one 32-channel tap box (81 rows of 128 bytes), 1024-aligned

// Weight-ring slots: two hold both products' weights where C <= 128.
__host__ __device__ constexpr int ring_slots(int nbx) { return nbx <= 2 ? 2 : 3; }

struct Up4SplitPlan {
  int tpc, ntiles, nchunks, nstrips;
};

// The plan (kernels/upsample.py::up4_split_plan mirrors it): 8 x 8 tiles
// per chunk of the phase launch, from kPlanBatch images of this shape.
inline Up4SplitPlan up4_split_plan(int B, int H, int W) {
  const int tiles = ((H + kDxbT - 1) / kDxbT) * ((W + kDxbT - 1) / kDxbT);
  Up4SplitPlan p;
  p.tpc = (bb::kPlanBatch * tiles + kUpChunks - 1) / kUpChunks;
  p.ntiles = B * tiles;
  p.nchunks = (p.ntiles + p.tpc - 1) / p.tpc;
  p.nstrips = (B * H * W + 63) / 64;
  return p;
}

// Tile chains of a phase CTA: where C <= 128 each warpgroup runs its own
// tiles, else both run each tile.
__host__ __device__ constexpr int tile_groups(int nbx) { return nbx <= 2 ? 2 : 1; }

// Shared-memory bytes (after the 1024 of alignment slack): header, weight
// ring, and per tile chain the x tile, a (also the output staging of a
// chain of its own), the stencil taps of its boxes (a pair of boxes at a
// time where one chain owns more) and, one chain, two output staging boxes.
inline size_t phase_smem(int nbx) {
  const int ng = tile_groups(nbx);
  const size_t group = (size_t)(2 * nbx + (ng == 1 ? 2 : 0)) * kBox +
                       (size_t)(ng == 2 ? 2 * nbx : 4) * kTapHalf;
  return 1024 + 1024 + (size_t)ring_slots(nbx) * kSlot + ng * group;
}
inline size_t prep_smem(int nbx) { return 1024 + strip_smem(nbx, true); }

struct Work {
  float* xbp;   // (B, H + 2, W + 2, C)
  bf16* wst;    // w_exp by phase (16C, C)
  size_t bytes;
};

// The workspace (kernels/upsample.py::up4_split_workspace mirrors it).
inline Work carve(unsigned char* p, int B, int H, int W, int C) {
  Carve cv{p};
  Work w;
  w.xbp = cv.take<float>((size_t)B * (H + 2) * (W + 2) * C);
  w.wst = cv.take<bf16>((size_t)16 * C * C);
  w.bytes = cv.used;
  return w;
}

// TMA: smem box -> the box of the 4-d `map` at (c0, c1, c2, c3), one bulk group.
__device__ inline void tma_store4(const CUtensorMap* map, const void* src, int c0, int c1, int c2,
                                  int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(hop::smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
__device__ inline void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ inline void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;" ::: "memory"); }

// Map of the bordered fp32 xb (B, H + 2, W + 2, C) in boxes of 32 channels x
// 9 x 9 pixels, 128-byte swizzle: a box lands as 81 rows (pixel y * 9 + x)
// of 128 bytes.
inline cudaError_t tap_map(CUtensorMap* m, const float* xbp, int B, int H, int W, int C) {
  const hop::EncodeTiledFn f = hop::encode_tiled();
  if (f == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dim[4] = {(cuuint64_t)C, (cuuint64_t)W + 2, (cuuint64_t)H + 2, (cuuint64_t)B};
  const cuuint64_t stride[3] = {(cuuint64_t)C * 4, (cuuint64_t)(W + 2) * C * 4,
                                (cuuint64_t)(H + 2) * (W + 2) * C * 4};
  const cuuint32_t box[4] = {32, 9, 9, 1};
  const cuuint32_t es[4] = {1, 1, 1, 1};
  const CUresult r = f(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(xbp), dim,
                       stride, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Channel cc (< 32) of row r of a 128-byte swizzled tap box.
__device__ inline float2 tap2(const unsigned char* box, int r, int cc) {
  return *reinterpret_cast<const float2*>(box + r * 128 + ((((cc >> 2) ^ r) & 7) << 4) +
                                          (cc & 3) * 4);
}

// ---------------------------------------------------------------- launch 1

template <int NBX>
__global__ void __launch_bounds__(kThr, 1)
    prep_kernel(const __grid_constant__ PrepArgs a, const __grid_constant__ CUtensorMap mx,
                const __grid_constant__ CUtensorMap mwb1, const __grid_constant__ CUtensorMap mwbf) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = align1k(smem_raw);
  if ((int)blockIdx.x < a.nstrips) prep_strip<NBX, true, true>(a, &mx, &mwb1, &mwbf, base, blockIdx.x);
  else prep_copy(a, blockIdx.x - a.nstrips);
}

// ---------------------------------------------------------------- launch 2

struct PhaseArgs {
  const float* alphas;
  int H, W, C, tpc, ntiles;
};

// CTA (chunk of 8 x 8 tiles, phase s); a tile's 64 rows are its pixels (h0
// + r / 8, w0 + r % 8), those off the image zero (and never stored). Where
// C <= 128 (NG = 2 tile chains) warpgroup w runs tiles t0 + w, t0 + w + 2,
// ... through the whole chain on its own buffers, the two chains sharing
// only the weights, held in the ring; wider (NG = 1) both warpgroups run
// each tile, warpgroup w owning the column boxes w, w + 2.
template <int NBX>
__global__ void __launch_bounds__(kThr, 1)
    phase_kernel(const __grid_constant__ PhaseArgs a, const __grid_constant__ CUtensorMap mx,
                 const __grid_constant__ CUtensorMap mwst, const __grid_constant__ CUtensorMap mwpf,
                 const __grid_constant__ CUtensorMap mtap, const __grid_constant__ CUtensorMap mout) {
  // ring slots; tile chains; tap loads per tile (NG = 1: a pair of column
  // boxes each); threads of a chain
  constexpr int S = ring_slots(NBX), NG = tile_groups(NBX);
  constexpr int NP = NG == 2 ? 1 : (NBX + 1) / 2, GT = kThr / NG;
  constexpr size_t kGroup =
      (size_t)(2 * NBX + (NG == 1 ? 2 : 0)) * kBox + (size_t)(NG == 2 ? 2 * NBX : 4) * kTapHalf;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = align1k(smem_raw);
  const int chunk = blockIdx.x, s = blockIdx.y, pi = s >> 2, pj = s & 3;
  const int H = a.H, W = a.W, C = a.C;
  const int t0 = chunk * a.tpc, t1 = min(a.ntiles, t0 + a.tpc);
  if (t0 >= t1) return;
  const int nth = (H + kDxbT - 1) / kDxbT, ntw = (W + kDxbT - 1) / kDxbT;
  const int tid = threadIdx.x, wg = tid >> 7, t128 = tid & 127;
  // this thread's chain and its rank there; this warpgroup's first column
  // box and box stride
  const int g = NG == 2 ? wg : 0, gt = NG == 2 ? t128 : tid;
  const int bw = NG == 2 ? 0 : wg, nbw = NG == 2 ? 1 : 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + S;
  uint64_t* xbar = empty + S;   // [NG]
  uint64_t* tbar = xbar + NG;   // [NG]
  hop::Product* prods = reinterpret_cast<hop::Product*>(base + 128);
  unsigned char* ring = base + 1024;
  unsigned char* X = ring + (size_t)S * kSlot + g * kGroup;   // the chain's x tile: NBX panels
  unsigned char* A = X + NBX * kBox;                           // a: NBX panels
  unsigned char* Tap = A + NBX * kBox;                         // [box][2 halves] of stencil taps
  unsigned char* Stg = Tap + 4 * kTapHalf;                     // NG = 1: [2] output boxes
  const float ap = a.alphas[0];
  const float ki0 = kQ4[pi][0], ki1 = kQ4[pi][1], kj0 = kQ4[pj][0], kj1 = kQ4[pj][1];
  auto sync = [&]() { hop::bar_sync(1 + g, GT); };   // the chain's threads
  auto tile_at = [&](int t, int& b, int& h0, int& w0) {
    b = t / (nth * ntw);
    h0 = kDxbT * ((t / ntw) % nth);
    w0 = kDxbT * (t % ntw);
  };
  auto issue_x = [&](int t) {
    int b, h0, w0;
    tile_at(t, b, h0, w0);
    hop::mbar_expect_tx(&xbar[g], (uint32_t)NBX * kBox);
    for (int cb = 0; cb < NBX; ++cb) tma_load4(X + cb * kBox, &mx, &xbar[g], 64 * cb, w0, h0, b);
  };
  // the taps of boxes 2p, 2p + 1: phase s reads bordered rows from h0 + (i
  // >= 2) and columns from w0 + (j >= 2), 9 of each
  auto issue_taps = [&](int t, int p) {
    int b, h0, w0;
    tile_at(t, b, h0, w0);
    uint32_t bytes = 0;
    for (int q = 0; q < 4; ++q)
      if (128 * p + 32 * q < C) bytes += kTapRows * 128;
    hop::mbar_expect_tx(&tbar[g], bytes);
    for (int q = 0; q < 4; ++q)
      if (128 * p + 32 * q < C)
        tma_load4(Tap + q * kTapHalf, &mtap, &tbar[g], 128 * p + 32 * q, w0 + (pj >> 1),
                  h0 + (pi >> 1), b);
  };
  if (tid == 0) {
    for (int q = 0; q < S; ++q) {
      hop::mbar_init(&full[q], 1);
      hop::mbar_init(&empty[q], kThr);
    }
    for (int q = 0; q < NG; ++q) {
      hop::mbar_init(&xbar[q], 1);
      hop::mbar_init(&tbar[q], 1);
    }
    hop::mbar_fence_init();
    const int bk = hop::chunk_rows(kSlot, NBX, C);
    prods[0] = {&mwst, 0, NBX, 0, NBX, s * C, C, bk};   // wexp_s: rows s C .. of w_exp by phase
    prods[1] = {&mwpf, 0, NBX, 0, NBX, 0, C, bk};
  }
  __syncthreads();
  if (gt == 0 && t0 + g < t1) {
    issue_x(t0 + g);
    issue_taps(t0 + g, 0);
  }
  // both products' chunks fit the ring: loaded once, read by every tile
  // (always where NG = 2: the chains consume it at their own pace)
  const bool resident = prods[0].chunks() + prods[1].chunks() <= S;
  hop::Ring rg{full, empty, ring, S, (uint32_t)kSlot, prods, 2, 0, 0, 0, 0};
  float acc[2][32];
  int tphase = 0;   // completions of tbar[g] awaited so far
  for (int t = t0 + g, n = 0; t < t1; t += NG, ++n) {
    int b, h0, w0;
    tile_at(t, b, h0, w0);
    if (resident) {
      rg.consumed = 0;
    } else if (tid == 0) {   // the tile's two products again, through the ring
      rg.pi = 0;
      rg.pc = 0;
    }
    hop::mbar_wait(&xbar[g], (uint32_t)(n & 1));
    // a = round(prelu(x wexp_s)) into the A operand
    hop::run_product<2>(rg, prods[0], X, acc, bw, nbw, tid == 0);
    if (NG == 2) {   // the last tile's stores have read A
      if (gt == 0) bulk_wait_read();
      sync();
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int nb = bw + nbw * jj;
      if (nb >= NBX) continue;
#pragma unroll
      for (int i = 0; i < 32; i += 2)
        *reinterpret_cast<uint32_t*>(
            A + hop::a_off(hop::acc_row(t128, i), 64 * nb + hop::acc_col(t128, i))) =
            pack_bf2(prelu_f(acc[jj][i], ap), prelu_f(acc[jj][i + 1], ap));
    }
    hop::fence_async_smem();
    sync();   // a is whole, x is read: the chain's next x may land
    if (gt == 0 && t + NG < t1) issue_x(t + NG);
    // Y = a wpf, + the stencil, rounded once, stored box by box
    hop::run_product<2>(rg, prods[1], A, acc, bw, nbw, tid == 0);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      if (jj < NP) {
        if (jj > 0) {   // the previous pair's taps are read: this pair's
          hop::fence_async_smem();
          sync();
          if (gt == 0) issue_taps(t, jj);
        }
        hop::mbar_wait(&tbar[g], (uint32_t)(tphase++ & 1));
      }
      const int nb = bw + nbw * jj;
      if (nb >= NBX) continue;
      // the staging: a's own panel of the box (its chain's product is
      // done), or this warpgroup's box once the last store has read it
      unsigned char* stg = NG == 2 ? A + nb * kBox : Stg + wg * kBox;
      if (NG == 1 && t128 == 0) bulk_wait_read();
      hop::bar_sync(3 + wg, 128);
      const unsigned char* tbx = Tap + 2 * (NG == 2 ? nb : nb & 1) * kTapHalf;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = hop::acc_row(t128, i), col = hop::acc_col(t128, i);
        const int r = (row >> 3) * 9 + (row & 7), cc = col & 31;
        const unsigned char* tb = tbx + (col >> 5) * kTapHalf;
        const float2 t00 = tap2(tb, r, cc), t01 = tap2(tb, r + 1, cc);
        const float2 t10 = tap2(tb, r + 9, cc), t11 = tap2(tb, r + 10, cc);
        const float y0 = kj0 * (ki0 * t00.x + ki1 * t10.x) + kj1 * (ki0 * t01.x + ki1 * t11.x);
        const float y1 = kj0 * (ki0 * t00.y + ki1 * t10.y) + kj1 * (ki0 * t01.y + ki1 * t11.y);
        *reinterpret_cast<uint32_t*>(stg + hop::a_off(row, col)) =
            pack_bf2(acc[jj][i] + y0, acc[jj][i + 1] + y1);
      }
      hop::fence_async_smem();
      hop::bar_sync(3 + wg, 128);
      if (t128 == 0) tma_store4(&mout, stg, 64 * nb, 4 * w0 + pj, 4 * h0 + pi, b);
    }
    hop::fence_async_smem();
    sync();   // the taps are read: the chain's next may land
    if (gt == 0 && t + NG < t1) issue_taps(t + NG, 0);
  }
  if (t128 == 0) bulk_wait();
}

// ---------------------------------------------------------------- the sequence

struct Args {
  const bf16 *x, *wexp, *wb1;
  const float* bb1;
  const bf16 *wpf, *wbf;
  const float* alphas;
  bf16* out;
  int B, H, W, C;
};

template <int NBX>
cudaError_t split_fwd(const Args& a, const Work& w, const Up4SplitPlan& pl, cudaStream_t st,
                      int* n) {
  const int M = a.B * a.H * a.W, C = a.C;
  CUtensorMap mx, mx4, mwb1, mwbf, mwst, mwpf, mtap, mout;
  const int bk = hop::chunk_rows(kSlot, NBX, C);
  SUNET_TRY(hop::weight_map(&mx, a.x, M, C, 64));
  SUNET_TRY(tile_map(&mx4, a.x, a.B, a.H, a.W, C));
  SUNET_TRY(hop::weight_map(&mwb1, a.wb1, C, C, 64));
  SUNET_TRY(hop::weight_map(&mwbf, a.wbf, C, C, 64));
  SUNET_TRY(hop::weight_map(&mwst, w.wst, 16 * C, C, bk));
  SUNET_TRY(hop::weight_map(&mwpf, a.wpf, C, C, bk));
  SUNET_TRY(tap_map(&mtap, w.xbp, a.B, a.H, a.W, C));
  SUNET_TRY(tile_map(&mout, a.out, a.B, 4 * a.H, 4 * a.W, C, 4));
  {
    const PrepArgs p{nullptr, a.wexp, nullptr, a.bb1,   a.alphas, nullptr, w.xbp, nullptr,
                     nullptr, w.wst,  nullptr, a.B,     a.H,      a.W,     C,     0,
                     pl.nstrips, 0};
    SUNET_TRY(hop::launch_cluster(prep_kernel<NBX>, dim3(pl.nstrips + kCopyCtas), kThr,
                                  prep_smem(NBX), st, 1, p, mx, mwb1, mwbf));
    SUNET_TRY(launched(n));
  }
  const PhaseArgs p{a.alphas, a.H, a.W, C, pl.tpc, pl.ntiles};
  SUNET_TRY(hop::launch_cluster(phase_kernel<NBX>, dim3(pl.nchunks, 16), kThr, phase_smem(NBX),
                                st, 1, p, mx4, mwst, mwpf, mtap, mout));
  return launched(n);
}

}  // namespace u4f
}  // namespace sunet

using namespace sunet;

extern "C" size_t sunet_up4_workspace(int B, int H, int W, int C) {
  return u4f::carve(nullptr, B, H, W, C).bytes;
}

// x (B, H, W, C), out (B, 4H, 4W, C), w_exp (C, 16C), wb1, bb1, wpf, wbf,
// alphas (alpha_p, alpha_b); the workspace; the shape; tpc, the plan's tiles
// per chunk of the phase launch (up4_split_plan), refused if it is not this
// entry's; the launch count. C a multiple of 16 up to 256, any H and W.
extern "C" int sunet_up4(const void* x, void* out, const void* wexp, const void* wb1,
                         const void* bb1, const void* wpf, const void* wbf, const void* alphas,
                         void* work, int B, int H, int W, int C, int tpc, int* launches,
                         void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 16 || C % 16 || C > 256) return (int)cudaErrorInvalidValue;
  const u4f::Up4SplitPlan pl = u4f::up4_split_plan(B, H, W);
  if (tpc != pl.tpc) return (int)cudaErrorInvalidValue;
  const u4f::Args a{(const bf16*)x,   (const bf16*)wexp, (const bf16*)wb1,    (const float*)bb1,
                    (const bf16*)wpf, (const bf16*)wbf,  (const float*)alphas, (bf16*)out,
                    B,                H,                 W,                    C};
  const u4f::Work w = u4f::carve((unsigned char*)work, B, H, W, C);
  *launches = 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (u4::nboxes(C)) {
    case 1: return (int)u4f::split_fwd<1>(a, w, pl, st, launches);
    case 2: return (int)u4f::split_fwd<2>(a, w, pl, st, launches);
    case 3: return (int)u4f::split_fwd<3>(a, w, pl, st, launches);
    default: return (int)u4f::split_fwd<4>(a, w, pl, st, launches);
  }
}
