// Shared pieces of the x4 head's two backward kernels on hopper.cuh's
// wgmma: the conv-fused head's (#9, up4_conv_bwd.cu) and the split head's
// (#11, up4_bwd.cu). Both run five launches: prep (their own), phase (their
// own), then the three launches here:
//   3. pixel: per 64-pixel strip, dzb = prelu'(zb) (dxb wbf^T) with the
//      slope and db_b1 partials, round(dzb) written, and dx = round(dz
//      wexp^T + round(dzb) wb1^T) over K = 16 C + C, dz and w_exp by phase
//      streamed by TMA through a ring;
//   4. the weight gradients dwexp = x^T dz, dwbf = abv^T dxb, dwb1 = x^T
//      round(dzb) as token-chunk partials (bb::wgrad_kernel);
//   5. every partial summed in a fixed order, dwexp back to w_exp's column
//      order c * 16 + s (and #9's conv fold unfolded to (3, 3, C, out)).
// Also shared: the launch plan (kernels/upsample.py::up4_conv_bwd_plan and
// up4_bwd_plan mirror it), the workspace, the prep launch's strips (zb =
// x wb1 + bb1, abv = round(prelu(zb)), with #9 also xb = abv wbf) and its
// weight layout (w_exp by phase), the x4 stencil's phase weights kQ4 and
// clamped taps, and the PReLU.
//
// C is held as NBX 64-column boxes (a template parameter, 1 to 4: C up to
// 256). A CTA's two warpgroups take one 64-column output box each, NBX > 2
// in pairs of boxes. No sum uses atomics: the same bits every run.
//
// Everything here is static, inline or a template, so several sources can
// include the header.
#pragma once

#include "block_bwd_hopper.cuh"

namespace sunet {

static __constant__ float kQ4[4][2] = {{0.375f, 0.625f}, {0.125f, 0.875f},
                                       {0.875f, 0.125f}, {0.625f, 0.375f}};

__device__ inline float prelu_f(float v, float a) { return fmaxf(v, 0.f) + a * fminf(v, 0.f); }

// The two taps (lo, hi) of phase p at source index u of one axis (size n)
// of the x4 stencil: (u-1, u) for p = 0, 1 and (u, u+1) for p = 2, 3,
// clamped at the edges.
__device__ inline void stencil_taps(int u, int n, int p, int& lo, int& hi) {
  lo = p < 2 ? max(u - 1, 0) : u;
  hi = p < 2 ? u : min(u + 1, n - 1);
}

namespace u4 {

using bb::kThr;
constexpr int kBox = 64 * 128;        // one 64 x 64 bf16 box or A panel (128-byte rows)
constexpr int kPhaseChunks = 8;       // tile chunks of the phase launch at kPlanBatch images
constexpr int kCopyCtas = 16;         // the prep launch's weight-layout CTAs
constexpr int kDxbT = 8;              // the phase launch's and the stencil adjoint's tile: 8 x 8 pixels

// A measurement build (-DSUNET_PHASE_CLOCK, sunet_tf_tpu_torch/tools/
// block_phases.py) adds thread 0's SM clock cycles per phase of a phase
// launch into the buffer g_phase_clock of the including source, kPhPhases
// (its own) values per CTA in launch order (x fastest).
#ifdef SUNET_PHASE_CLOCK
#define PH_PHASE(k)                                                                    \
  do {                                                                                 \
    if (tid == 0 && g_phase_clock) {                                                   \
      const long long now = clock64();                                                 \
      g_phase_clock[(((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +       \
                     blockIdx.x) * kPhPhases + (k)] += now - clk;                      \
      clk = now;                                                                       \
    }                                                                                  \
  } while (0)
#else
#define PH_PHASE(k) \
  do {              \
  } while (0)
#endif

__host__ __device__ inline int nboxes(int C) { return (C + 63) / 64; }

struct Up4BwdPlan {
  int ntiles;                 // 64-pixel strips (prep, pixel)
  int tpc, ptiles, nchunks;   // phase launch: 8 x 8 tiles per chunk, tiles, chunks
  int ndxb;                   // 8 x 8 tiles of the stencil adjoint (= ptiles)
  int wchunk, wnchunks;       // weight gradients: tokens per chunk, chunks
  int k16;                    // K of #9's conv adjoint product (0 for #11: out = 0)
};

// The plan; out = 0 for the split head (kernels/upsample.py::
// up4_conv_bwd_plan and up4_bwd_plan mirror it).
inline Up4BwdPlan up4_bwd_plan(int B, int H, int W, int C, int out) {
  const int hw = H * W, M = B * hw, strips = (bb::kPlanBatch * hw + 63) / 64;
  const int tiles = ((H + kDxbT - 1) / kDxbT) * ((W + kDxbT - 1) / kDxbT);
  Up4BwdPlan p;
  p.ntiles = (M + 63) / 64;
  p.tpc = (bb::kPlanBatch * tiles + kPhaseChunks - 1) / kPhaseChunks;
  p.ptiles = B * tiles;
  p.nchunks = (p.ptiles + p.tpc - 1) / p.tpc;
  p.ndxb = B * tiles;
  const int wt = bb::wg_tiles(C, 16 * C) + 2 * bb::wg_tiles(C, C);
  const int per = std::max(1, (bb::kFillCtas + wt - 1) / wt);
  p.wchunk = 64 * ((strips + per - 1) / per);
  p.wnchunks = (M + p.wchunk - 1) / p.wchunk;
  p.k16 = (9 * out + 15) / 16 * 16;
  return p;
}

struct Up4Work {
  float *zb, *xb, *ppf, *pfold, *pap, *pab, *pbb1, *pw[3];
  bf16 *abv, *dxb, *dzb, *dz, *wst, *wct;
  bf16* am;   // #9's wide form (C above 96): a = round(prelu(z)), (M, 16C)
  size_t bytes;
};

// The workspace (kernels/upsample.py::up4_conv_bwd_workspace and
// up4_bwd_workspace mirror it); out = 0 for the split head, which keeps no
// xb, conv weights or fold and one slope partial per (chunk, phase, column
// box), as #9's wide form (C above 96), which also keeps the map of a.
// With p == nullptr only measures.
inline Up4Work carve_up4(unsigned char* p, const Up4BwdPlan& pl, int M, int C, int out) {
  Carve cv{p};
  Up4Work w;
  const size_t mc = (size_t)M * C;
  const bool wide = out && C > 96;
  w.zb = cv.take<float>(mc);
  w.xb = cv.take<float>(out ? mc : 0);
  w.abv = cv.take<bf16>(mc);
  w.dxb = cv.take<bf16>(mc);
  w.dzb = cv.take<bf16>(mc);
  w.dz = cv.take<bf16>(16 * mc);
  w.wst = cv.take<bf16>((size_t)16 * C * C);
  w.wct = cv.take<bf16>((size_t)9 * out * C);
  w.ppf = cv.take<float>((size_t)pl.nchunks * 16 * C * C);
  w.pfold = cv.take<float>((size_t)pl.nchunks * 36 * C * 16 * out);
  w.pap = cv.take<float>((size_t)pl.nchunks * 16 * (out && !wide ? 1 : nboxes(C)));
  w.pab = cv.take<float>((size_t)pl.ntiles);
  w.pbb1 = cv.take<float>((size_t)pl.ntiles * C);
  w.pw[0] = cv.take<float>((size_t)pl.wnchunks * C * 16 * C);
  w.pw[1] = cv.take<float>((size_t)pl.wnchunks * C * C);
  w.pw[2] = cv.take<float>((size_t)pl.wnchunks * C * C);
  w.am = cv.take<bf16>(wide ? 16 * mc : 0);
  w.bytes = cv.used;
  return w;
}

// ---------------------------------------------------------------- products

__device__ inline unsigned char* align1k(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}

template <int N>
__device__ inline void zero(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = 0.f;
}

// Stage n items (item e: v = load(e), then store(e, v)) by the CTA's
// threads, kBatch loads in flight per thread before their stores: the
// stores go through generic pointers, which the compiler cannot tell from
// the loads' memory, so interleaved they would wait on each load in turn.
// The loaders are branch-free (an item off the data loads from a valid
// address and selects zero), so that the batch's loads issue back to back.
template <int kBatch, class T, class Load, class Store>
__device__ inline void stage(int n, Load load, Store store) {
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * kThr) {
    T v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) v[k] = load(min(e0 + k * kThr, n - 1));
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int e = e0 + k * kThr;
      if (e < n) store(e, v[k]);
    }
  }
}

// acc = A (64 x K, swizzled K-major panels at a) @ W[0:K, 64 nb: 64 nb + 64],
// W held as 64 x 64 boxes, box (row block kc, column block nb) at (NBX kc +
// nb) * kBox.
template <int NBX>
__device__ inline void mm_w(float (&acc)[32], const unsigned char* a, const unsigned char* w,
                            int nb, int K) {
  zero(acc);
  hop::wg_fence();
  for (int kk = 0; kk < K; kk += 16)
    hop::wgmma64(acc, hop::a_desc(a, kk),
                 hop::b_desc(w + (NBX * (kk >> 6) + nb) * kBox, kk & 63), 1);
  hop::wg_commit();
  hop::wg_wait0();
}

// acc = A (64 x K) @ W^T[0:K, 64 nb: 64 nb + 64] from boxes of W's rows 64
// nb .. (the output columns, read K-major): box (nb, column block kc) at
// (NBX nb + kc) * kBox.
template <int NBX>
__device__ inline void mm_wt(float (&acc)[32], const unsigned char* a, const unsigned char* w,
                             int nb, int K) {
  zero(acc);
  hop::wg_fence();
  for (int kk = 0; kk < K; kk += 16)
    hop::wgmma64_kmajor(acc, hop::a_desc(a, kk),
                        hop::a_desc(w + (NBX * nb + (kk >> 6)) * kBox, kk & 63), 1);
  hop::wg_commit();
  hop::wg_wait0();
}

// One axis of the clamped x4 stencil: the weight with which high-res index
// P (phase P & 3 of source u = P >> 2, u inside the axis of size n) reaches
// target t.
__device__ inline float tap_coef(int P, int t, int n) {
  const int u = P >> 2, i = P & 3;
  int lo, hi;
  stencil_taps(u, n, i, lo, hi);
  return (lo == t ? kQ4[i][0] : 0.f) + (hi == t ? kQ4[i][1] : 0.f);
}

// TMA: the box of the 4-d `map` at (c0, c1, c2, c3) into dst, completing on bar.
__device__ inline void tma_load4(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                 int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(hop::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(hop::smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Map of a (B, H, W, C) bf16 map in boxes of 64 channels x an 8 x 8 pixel
// tile, every `step`-th pixel of an (8 step) x (8 step) region along both
// pixel axes (the TMA element strides): a box lands as 64 rows (pixel (h0
// + step (r / 8), w0 + step (r % 8))) of 128 bytes with the 128-byte
// swizzle, the A operand's layout; pixels and channels off the tensor fill
// zeros.
inline cudaError_t tile_map(CUtensorMap* m, const void* x, int B, int H, int W, int C,
                            int step = 1) {
  const hop::EncodeTiledFn f = hop::encode_tiled();
  if (f == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  if (C % 8 || (reinterpret_cast<uintptr_t>(x) & 15)) return cudaErrorInvalidValue;
  const cuuint64_t dim[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t stride[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)(kDxbT * step), (cuuint32_t)(kDxbT * step), 1};
  const cuuint32_t es[4] = {1, (cuuint32_t)step, (cuuint32_t)step, 1};
  const CUresult r = f(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dim, stride,
                       box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- launch 1 (shared parts)

struct PrepArgs {
  const bf16 *dout, *wexp, *wconv;
  const float *bb1, *alphas;
  float *zb, *xb;
  bf16 *abv, *dxb, *wst, *wct;
  int B, H, W, C, out, nstrips, ndxb;
};

// Shared-memory bytes of a strip (after the 1024 of alignment slack); with
// xb at four column boxes wbf takes wb1's place (both would not fit).
__host__ __device__ inline size_t strip_smem(int nbx, bool xb) {
  const int wts = xb && nbx <= 3 ? 2 : 1;
  return 1024 + (size_t)(nbx + wts * nbx * nbx + (xb ? nbx : 0)) * kBox;
}

// The bordered xb map (B, H + 2, W + 2, C) of the split head's forward
// (#10): pixel (h, w) at (h + 1, w + 1), and an edge pixel also at the
// border cells beside it, so that every clamped stencil tap is a plain read.
// Pixel m's cells: element offsets of rows {h + 1, 0 at the top edge, H + 1
// at the bottom} x columns likewise, cell 0 the interior one.
struct Bordered {
  size_t off[9];
  unsigned valid;
};

__device__ inline Bordered bordered_cells(int m, int H, int W, int C) {
  const int w = m % W, h = (m / W) % H, b = m / (H * W);
  const int ys[3] = {h + 1, h == 0 ? 0 : -1, h == H - 1 ? H + 1 : -1};
  const int xs[3] = {w + 1, w == 0 ? 0 : -1, w == W - 1 ? W + 1 : -1};
  Bordered c;
  c.valid = 0;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int y = ys[k / 3], x = xs[k % 3];
    c.valid |= (y >= 0 && x >= 0 ? 1u : 0u) << k;
    c.off[k] = (((size_t)b * (H + 2) + max(y, 0)) * (W + 2) + max(x, 0)) * C;
  }
  return c;
}

__device__ inline void store_bordered(float* xbp, const Bordered& c, int col, float v) {
#pragma unroll
  for (int k = 0; k < 9; ++k)
    if (c.valid >> k & 1) xbp[c.off[k] + col] = v;
}

// Strip: zb = x wb1 + bb1, abv = round(prelu(zb)); kXb also xb = abv wbf
// (#9, and #10 with kBorder: xb alone, into the bordered map a.xb, no zb
// or abv). Warpgroup wg takes the output boxes wg, wg + 2, ...
template <int NBX, bool kXb, bool kBorder = false>
__device__ inline void prep_strip(const PrepArgs& a, const CUtensorMap* mx,
                                  const CUtensorMap* mwb1, const CUtensorMap* mwbf,
                                  unsigned char* base, int strip) {
  constexpr bool kTurn = kXb && NBX > 3;   // wbf loaded into wb1's place after zb
  uint64_t* bar = reinterpret_cast<uint64_t*>(base);
  unsigned char* X = base + 1024;
  unsigned char* Wb1 = X + NBX * kBox;
  unsigned char* Wbf = kTurn ? Wb1 : Wb1 + NBX * NBX * kBox;
  unsigned char* A2 = Wbf + NBX * NBX * kBox;
  const int tid = threadIdx.x, wg = tid >> 7, t128 = tid & 127, C = a.C;
  const int M = a.B * a.H * a.W, m0 = strip * 64;
  const float ab = a.alphas[1];
  if (tid == 0) {
    hop::mbar_init(bar, 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hop::mbar_expect_tx(bar, (uint32_t)(NBX + (kXb && !kTurn ? 2 : 1) * NBX * NBX) * kBox);
    for (int cb = 0; cb < NBX; ++cb) hop::tma_load(X + cb * kBox, mx, bar, 64 * cb, m0);
    for (int rb = 0; rb < NBX; ++rb)
      for (int cb = 0; cb < NBX; ++cb) {
        hop::tma_load(Wb1 + (NBX * rb + cb) * kBox, mwb1, bar, 64 * cb, 64 * rb);
        if (kXb && !kTurn)
          hop::tma_load(Wbf + (NBX * rb + cb) * kBox, mwbf, bar, 64 * cb, 64 * rb);
      }
  }
  hop::mbar_wait(bar, 0);
  float acc[32];
  for (int nb = wg; nb < NBX; nb += 2) {
    mm_w<NBX>(acc, X, Wb1, nb, C);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = hop::acc_row(t128, i), col = 64 * nb + hop::acc_col(t128, i);
      const int m = m0 + row;
      bf16 v = tobf(0.f);
      if (m < M && col < C) {
        const float z = acc[i] + a.bb1[col];
        v = tobf(prelu_f(z, ab));
        if constexpr (!kBorder) {
          a.zb[(size_t)m * C + col] = z;
          a.abv[(size_t)m * C + col] = v;
        }
      }
      if (kXb) *reinterpret_cast<bf16*>(A2 + hop::a_off(row, col)) = v;
    }
  }
  if constexpr (kXb) {
    hop::fence_async_smem();
    __syncthreads();
    if constexpr (kTurn) {   // wb1 is read: wbf takes its place
      if (tid == 0) {
        hop::mbar_expect_tx(bar, (uint32_t)NBX * NBX * kBox);
        for (int rb = 0; rb < NBX; ++rb)
          for (int cb = 0; cb < NBX; ++cb)
            hop::tma_load(Wbf + (NBX * rb + cb) * kBox, mwbf, bar, 64 * cb, 64 * rb);
      }
      hop::mbar_wait(bar, 1);
    }
    [[maybe_unused]] Bordered cells[2];   // kBorder: the cells of the thread's two rows
    if constexpr (kBorder) {
#pragma unroll
      for (int q = 0; q < 2; ++q)
        cells[q] = bordered_cells(min(m0 + hop::acc_row(t128, 2 * q), M - 1), a.H, a.W, C);
    }
    for (int nb = wg; nb < NBX; nb += 2) {
      mm_w<NBX>(acc, A2, Wbf, nb, C);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = hop::acc_row(t128, i), col = 64 * nb + hop::acc_col(t128, i);
        if (m0 + row >= M || col >= C) continue;
        if constexpr (kBorder) store_bordered(a.xb, cells[(i >> 1) & 1], col, acc[i]);
        else a.xb[(size_t)(m0 + row) * C + col] = acc[i];
      }
    }
  }
}

// w_exp (C, 16C), column n * 16 + s -> wst (16C, C), row s * C + k; wconv
// (3, 3, C, out) -> wct (9 out, C), row tap * out + o (#9 only).
// The CTA's share of w_exp is read in w_exp's own order (coalesced), eight
// loads in flight per thread before their stores.
__device__ inline void prep_copy(const PrepArgs& a, int cta) {
  const int C = a.C, out = a.out, n = 16 * C * C, per = (n + kCopyCtas - 1) / kCopyCtas;
  const int e0 = cta * per, cnt = min(n, e0 + per) - e0;
  stage<8, bf16>(
      cnt, [&](int e) { return a.wexp[e0 + e]; },
      [&](int e, bf16 v) {
        const int k = (e0 + e) / (16 * C), col = (e0 + e) % (16 * C);
        a.wst[((size_t)(col % 16) * C + k) * C + col / 16] = v;
      });
  const int stride = kCopyCtas * kThr, i0 = cta * kThr + threadIdx.x;
  for (int i = i0; i < 9 * out * C; i += stride) {
    const int k = i / C, c = i % C;
    a.wct[i] = a.wconv[((k / out) * C + c) * out + k % out];
  }
}

// ---------------------------------------------------------------- launch 3

struct PixelArgs {
  const float *zb, *alphas;
  bf16 *dzb, *dx;
  float *pab, *pbb1;   // [strip], [strip][C]
  int M, C;
};

constexpr int kPixS = 3, kPixSlot = 3 * kBox;   // ring: slots of (dz box, wst boxes)

// Shared-memory bytes of the pixel launch: up to two output boxes (one
// pair) wbf and wb1 are held whole, the fp32 dzb of a pair in its own
// buffer; wider, one pair's weights at a time and dzb over the ring.
__host__ __device__ inline size_t pixel_smem(int nbx) {
  const bool all = nbx <= 2;
  return 2048 + (size_t)((all ? 4 : 2) * nbx + 2 * nbx + 3 * kPixS) * kBox +
         (all ? 64 * 128 * 4 : 0);
}

// The strip's dzb pair by pair (warpgroup wg: output box 2p + wg), then dx
// pair by pair: dz's 64-column boxes with the pair's w_exp rows by phase
// through the ring (chunk q of a pair: phase q / NBX, K box q % NBX), then
// round(dzb) wb1^T.
template <int NBX>
__global__ void __launch_bounds__(kThr, 1)
    pixel_kernel(const __grid_constant__ PixelArgs a, const __grid_constant__ CUtensorMap mdxb,
                 const __grid_constant__ CUtensorMap mdz, const __grid_constant__ CUtensorMap mwst,
                 const __grid_constant__ CUtensorMap mwbf, const __grid_constant__ CUtensorMap mwb1) {
  constexpr int NP = (NBX + 1) / 2, nch = 16 * NBX;
  constexpr bool kAll = NP == 1;   // wbf and wb1 held whole, loaded once
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = align1k(smem_raw);
  uint64_t* wbar = reinterpret_cast<uint64_t*>(base);
  uint64_t* full = wbar + 1;
  uint64_t* empty = full + kPixS;
  float* red = reinterpret_cast<float*>(base + 128);
  unsigned char* Wbf = base + 1024;   // a pair's wbf rows: box (nb, kc) at NBX nb + kc
  unsigned char* Wb1 = kAll ? Wbf + 2 * NBX * kBox : Wbf;
  unsigned char* A0 = Wb1 + 2 * NBX * kBox;   // dxb
  unsigned char* A1 = A0 + NBX * kBox;        // round(dzb)
  unsigned char* ring = A1 + NBX * kBox;
  float* cs = reinterpret_cast<float*>(kAll ? ring + kPixS * kPixSlot : ring);   // [64][128] fp32 dzb
  const int tid = threadIdx.x, wg = tid >> 7, t128 = tid & 127, C = a.C, M = a.M;
  const int strip = blockIdx.x, m0 = strip * 64;
  const float ab = a.alphas[1];
  if (tid == 0) {
    hop::mbar_init(wbar, 1);
    for (int i = 0; i < kPixS; ++i) {
      hop::mbar_init(&full[i], 1);
      hop::mbar_init(&empty[i], kThr);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int q) {
    const int sl = q % kPixS, p = q / nch, ph = (q % nch) / NBX, kc = q % NBX;
    const int nbp = min(2, NBX - 2 * p);
    unsigned char* slot = ring + (size_t)sl * kPixSlot;
    hop::mbar_expect_tx(&full[sl], (uint32_t)(1 + nbp) * kBox);
    hop::tma_load(slot, &mdz, &full[sl], ph * C + 64 * kc, m0);
    for (int j = 0; j < nbp; ++j)
      hop::tma_load(slot + (1 + j) * kBox, &mwst, &full[sl], 64 * kc, ph * C + 64 * (2 * p + j));
  };
  // the pair's rows of w (64 (2p + nb) ..) as NBX column boxes each
  auto load_pair = [&](unsigned char* dst, const CUtensorMap* m, int p) {
    for (int nb = 0; nb < min(2, NBX - 2 * p); ++nb)
      for (int kc = 0; kc < NBX; ++kc)
        hop::tma_load(dst + (NBX * nb + kc) * kBox, m, wbar, 64 * kc, 64 * (2 * p + nb));
  };
  const int npair0 = min(2, NBX);
  if (tid == 0) {
    hop::mbar_expect_tx(wbar, (uint32_t)((kAll ? 2 : 1) * npair0 * NBX + NBX) * kBox);
    load_pair(Wbf, &mwbf, 0);
    if (kAll) load_pair(Wb1, &mwb1, 0);
    for (int cb = 0; cb < NBX; ++cb) hop::tma_load(A0 + cb * kBox, &mdxb, wbar, 64 * cb, m0);
    if (kAll)
      for (int q = 0; q < kPixS; ++q) issue(q);
  }
  int wphase = 0;   // completions of wbar awaited so far
  // dzb = prelu'(zb) (dxb wbf^T): fp32 into cs, rounded into A1 and out
  float acc[32], abs_ = 0.f;
  for (int p = 0; p < NP; ++p) {
    if (!kAll && p > 0) {   // the previous pair's wbf is read: the next pair's
      __syncthreads();
      if (tid == 0) {
        hop::mbar_expect_tx(wbar, (uint32_t)min(2, NBX - 2 * p) * NBX * kBox);
        load_pair(Wbf, &mwbf, p);
      }
    }
    hop::mbar_wait(wbar, (uint32_t)(wphase++ & 1));
    const int nb = 2 * p + wg;
    if (nb < NBX) {
      float zbv[32];   // every load before the epilogue's stores
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = hop::acc_row(t128, i), col = 64 * nb + hop::acc_col(t128, i);
        zbv[i] = m0 + row < M && col < C ? __ldg(a.zb + (size_t)(m0 + row) * C + col) : 0.f;
      }
      mm_wt<NBX>(acc, A0, Wbf, wg, C);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = hop::acc_row(t128, i), c = 64 * wg + hop::acc_col(t128, i);
        const int col = 64 * nb + hop::acc_col(t128, i), m = m0 + row;
        float d = 0.f;
        if (m < M && col < C) {
          const float zz = zbv[i];
          d = zz > 0.f ? acc[i] : ab * acc[i];
          abs_ += fminf(zz, 0.f) * acc[i];
          a.dzb[(size_t)m * C + col] = tobf(d);
        }
        cs[row * 128 + c] = d;
        *reinterpret_cast<bf16*>(A1 + hop::a_off(row, col)) = tobf(d);
      }
    }
    hop::fence_async_smem();
    __syncthreads();
    if (tid < 128 && 128 * p + tid < C) {   // bb1's column partial: rows in order
      float v = 0.f;
      for (int r = 0; r < 64; ++r) v += cs[r * 128 + tid];
      a.pbb1[(size_t)strip * C + 128 * p + tid] = v;
    }
  }
  abs_ = warp_sum(abs_);
  if ((tid & 31) == 0) red[tid >> 5] = abs_;
  hop::fence_async_smem();   // cs's reads before the TMA writes that take its place
  __syncthreads();
  if (tid == 0) {
    float v = 0.f;
    for (int w = 0; w < kThr / 32; ++w) v += red[w];
    a.pab[strip] = v;
    if (!kAll) {   // cs is read: the ring and the first pair's wb1 take its place
      hop::mbar_expect_tx(wbar, (uint32_t)npair0 * NBX * kBox);
      load_pair(Wb1, &mwb1, 0);
      for (int q = 0; q < kPixS; ++q) issue(q);
    }
  }
  // dx = round(dz wexp^T + round(dzb) wb1^T)
  for (int p = 0; p < NP; ++p) {
    const bool mine = 2 * p + wg < NBX;
    zero(acc);
    for (int qq = 0; qq < nch; ++qq) {
      const int q = p * nch + qq, sl = q % kPixS;
      hop::mbar_wait(&full[sl], (uint32_t)((q / kPixS) & 1));
      const unsigned char* slot = ring + (size_t)sl * kPixSlot;
      if (mine) {
        hop::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 64; kk += 16)
          hop::wgmma64_kmajor(acc, hop::a_desc(slot, kk), hop::a_desc(slot + (1 + wg) * kBox, kk),
                              1);
        hop::wg_commit();
        hop::wg_wait0();
      }
      hop::mbar_arrive(&empty[sl]);
      if (tid == 0 && q + kPixS < NP * nch) {
        hop::mbar_wait(&empty[sl], (uint32_t)((q / kPixS) & 1));
        issue(q + kPixS);
      }
    }
    if (!kAll) hop::mbar_wait(wbar, (uint32_t)(wphase++ & 1));   // this pair's wb1
    if (mine) {
      hop::wg_fence();
      for (int kk = 0; kk < C; kk += 16)
        hop::wgmma64_kmajor(acc, hop::a_desc(A1, kk),
                            hop::a_desc(Wb1 + (NBX * wg + (kk >> 6)) * kBox, kk & 63), 1);
      hop::wg_commit();
      hop::wg_wait0();
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = hop::acc_row(t128, i), col = 64 * (2 * p + wg) + hop::acc_col(t128, i);
        if (m0 + row < M && col < C) a.dx[(size_t)(m0 + row) * C + col] = tobf(acc[i]);
      }
    }
    if (!kAll && p + 1 < NP) {   // this pair's wb1 is read: the next pair's
      __syncthreads();
      if (tid == 0) {
        hop::mbar_expect_tx(wbar, (uint32_t)min(2, NBX - 2 * (p + 1)) * NBX * kBox);
        load_pair(Wb1, &mwb1, p + 1);
      }
    }
  }
}

// ---------------------------------------------------------------- launch 5

struct SumArgs {
  const float *pw0, *pw1, *pw2, *ppf, *pfold, *pap, *pab, *pbb1;
  float *dwexp, *dwbf, *dwb1, *dwpf, *dwconv, *dbb1, *dalphas;
  int C, out, nchunks, ntiles, wnchunks, npap;
};

// The slot of output phase i with conv tap d along one axis
// (kernels/upsample.py::_slot).
__device__ inline int conv_slot(int i, int d) {
  const int hi = i + d;
  return hi < 0 ? 0 : (hi > 3 ? 5 : 1 + hi);
}

// One thread per output value, its partials summed in a fixed order.
static __global__ void __launch_bounds__(kThr) sum_kernel(const __grid_constant__ SumArgs a) {
  const int C = a.C, O = 16 * a.out;
  const long long n0 = 16LL * C * C, n1 = (long long)C * C, n4 = 9LL * C * a.out;
  const long long total = n0 + 3 * n1 + n4 + C + 2;
  for (long long i = blockIdx.x * (long long)kThr + threadIdx.x; i < total;
       i += (long long)gridDim.x * kThr) {
    long long e = i;
    float v = 0.f;
    if (e < n0) {   // dwexp in w_exp's column order c * 16 + s
      const int c = (int)(e / (16 * C)), col = (int)(e % (16 * C)), n = col / 16, s = col % 16;
      for (int z = 0; z < a.wnchunks; ++z) v += a.pw0[((size_t)z * C + c) * 16 * C + s * C + n];
      a.dwexp[e] = v;
      continue;
    }
    e -= n0;
    if (e < 2 * n1) {   // dwbf, dwb1
      const float* p = e < n1 ? a.pw1 : a.pw2;
      const long long k = e % n1;
      for (int z = 0; z < a.wnchunks; ++z) v += p[(size_t)z * n1 + k];
      (e < n1 ? a.dwbf : a.dwb1)[k] = v;
      continue;
    }
    e -= 2 * n1;
    if (e < n1) {   // dwpf over (chunk, phase) in order
      for (int z = 0; z < 16 * a.nchunks; ++z) v += a.ppf[(size_t)z * n1 + e];
      a.dwpf[e] = v;
      continue;
    }
    e -= n1;
    if (e < n4) {   // #9's dwconv (3, 3, C, out): every output phase's slot
      const int o = (int)(e % a.out), c = (int)((e / a.out) % C), tap = (int)(e / (a.out * C));
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) {
          const int slot = conv_slot(i, dy) * 6 + conv_slot(j, dx);
          for (int z = 0; z < a.nchunks; ++z)
            v += a.pfold[(((size_t)z * 36 + slot) * C + c) * O + (i * 4 + j) * a.out + o];
        }
      a.dwconv[e] = v;
      continue;
    }
    e -= n4;
    if (e < C) {   // dbb1 over the strips
      for (int z = 0; z < a.ntiles; ++z) v += a.pbb1[(size_t)z * C + e];
      a.dbb1[e] = v;
      continue;
    }
    e -= C;
    if (e == 0)
      for (int z = 0; z < a.npap; ++z) v += a.pap[z];
    else
      for (int z = 0; z < a.ntiles; ++z) v += a.pab[z];
    a.dalphas[e] = v;
  }
}

// ---------------------------------------------------------------- launches 3-5

// What launches 3-5 read and write beside the workspace.
struct Up4Tail {
  const bf16 *x, *wb1, *wbf;
  const float* alphas;
  bf16* dx;
  float *dwexp, *dalphas, *dwb1, *dbb1, *dwpf, *dwbf, *dwconv;   // dwconv: #9 only
  int B, H, W, C, out;
  int npap;   // slope partials of the phase launch
};

template <int NBX>
cudaError_t up4_bwd_tail(const Up4Tail& a, const Up4Work& w, const Up4BwdPlan& pl,
                         cudaStream_t st, int* n) {
  const int M = a.B * a.H * a.W, C = a.C;
  CUtensorMap mwb1, mwbf, mwst, mdz, mdxb;
  SUNET_TRY(hop::weight_map(&mwb1, a.wb1, C, C, 64));
  SUNET_TRY(hop::weight_map(&mwbf, a.wbf, C, C, 64));
  SUNET_TRY(hop::weight_map(&mwst, w.wst, 16 * C, C, 64));
  SUNET_TRY(hop::weight_map(&mdz, w.dz, M, 16 * C, 64));
  SUNET_TRY(hop::weight_map(&mdxb, w.dxb, M, C, 64));
  {
    const PixelArgs p{w.zb, a.alphas, w.dzb, a.dx, w.pab, w.pbb1, M, C};
    SUNET_TRY(hop::launch_cluster(pixel_kernel<NBX>, dim3(pl.ntiles), kThr, pixel_smem(NBX), st,
                                  1, p, mdxb, mdz, mwst, mwbf, mwb1));
    SUNET_TRY(launched(n));
  }
  {
    using namespace bb;
    WgArgs g;
    WgMaps m;
    memset(&g, 0, sizeof(g));
    memset(&m, 0, sizeof(m));
    const bf16* xs[3] = {a.x, w.abv, a.x};
    const bf16* ds[3] = {w.dz, w.dxb, w.dzb};
    const int ncols[3] = {16 * C, C, C};
    int first = 0;
    for (int i = 0; i < 3; ++i) {
      g.p[i] = WgProduct{C, ncols[i], (C + 63) / 64, first, w.pw[i], nullptr};
      first += wg_tiles(C, ncols[i]) * pl.wnchunks;
      SUNET_TRY(hop::weight_map(&m.x[i], xs[i], M, C, 64));
      SUNET_TRY(hop::weight_map(&m.d[i], ds[i], M, ncols[i], 64));
    }
    g.np = 3, g.T = M, g.chunk = pl.wchunk, g.nchunks = pl.wnchunks;
    SUNET_TRY(hop::launch_cluster(wgrad_kernel, dim3(first), kThr, wgrad_smem(), st, 1, g, m));
    SUNET_TRY(launched(n));
  }
  const SumArgs s{w.pw[0],  w.pw[1], w.pw[2], w.ppf,      w.pfold,   w.pap,       w.pab,
                  w.pbb1,   a.dwexp, a.dwbf,  a.dwb1,     a.dwpf,    a.dwconv,    a.dbb1,
                  a.dalphas, C,      a.out,   pl.nchunks, pl.ntiles, pl.wnchunks, a.npap};
  const long long total = 19LL * C * C + 9LL * C * a.out + C + 2;
  sum_kernel<<<(int)std::min<long long>((total + kThr - 1) / kThr, 2048), kThr, 0, st>>>(s);
  return launched(n);
}

}  // namespace u4
}  // namespace sunet
