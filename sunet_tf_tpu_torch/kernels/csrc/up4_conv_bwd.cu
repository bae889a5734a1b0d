// Backward of the x4 dual up-sample head + 3x3 output conv, phase space.
//
// Replaces sunet_tf_tpu/kernels/upsample.py::_up4c_bwd_impl (its kernel
// _up4c_bwd_kernel): from x (B, H, W, C), the phase-space cotangent dout
// (B, H, W, 16*out) and the head's weights it recomputes the 16 phase maps
// and returns dx, dW_exp, dW_b1, db_b1, dwpf, dwbf, the two PReLU-slope sums
// and the conv grads dwconv (3, 3, C, out). The plain version is
// up4_conv_bwd_reference in kernels/upsample.py; the rounding points are
// the JAX kernel's: y_s = round(a_s wpf + stencil_s(xb)), dY (the conv's
// adjoint, fp32), dyb = round(dY), dz = round(prelu'(z) dyb wpf^T), dxb =
// round(stencil^T(dY)), round(dzb), dx = round(sum).
//
// Edge rules carried over from the forward: the bilinear taps CLAMP at the
// image edge (their adjoint folds the clamped taps back onto the edge
// pixel), the 3x3 conv ZERO-pads (taps off the image read and receive
// nothing).
//
// What bounds it on Hopper: the products, ~33 GFLOP at (64,64,96) batch 4
// (33 us at the bf16 peak), and the phase maps' bytes: a 16-phase map of
// batch 4 is 16 M C = 25.2M elements (50 MB in bf16). The first version
// (25 launches) wrote six of them (zf and dY in fp32, a, y, dyb and dz),
// ~0.4 GB, and folded the conv on CUDA cores, 36 passes over y.
//
// Design: five launches, every product on hopper.cuh's wgmma (operands in
// shared memory in the 128-byte swizzled layout, weights and token tiles by
// TMA), one 16-phase map (dz, bf16) through device memory:
//   1. prep: three kinds of CTAs in one launch. 64-pixel strips: zb = x wb1
//      + bb1, abv = round(prelu(zb)), xb = abv wbf (two chained products;
//      zb, abv, xb written, M C each). 8 x 8 pixel tiles: dxb =
//      round(stencil^T(conv^T(dout))) on CUDA cores from dout staged with a
//      two-pixel halo: per pixel the clamped stencil's and the conv's taps
//      fold into 9 * out sums of dout, then one product with the conv
//      weights (every term is exact in fp32; only the order of the fp32
//      sums moves). A few CTAs lay the weights out for launches 2-3 (w_exp
//      by phase, the conv weights by tap).
//   2. phase: CTA (chunk of 8 x 8 pixel tiles, phase s, fold column box
//      q). Per tile: z = x wexp_s, a = round(prelu(z)); y = round(a wpf +
//      stencil_s(xb)) into shared memory only (the stencil from the tile's
//      9 x 9 xb neighbourhood, staged once: a third of the L2 reads of four
//      taps per pixel, which bounded the first cut); the 3x3 conv's fold
//      dwconv_slot += y^T dout(m - slot shift) for the slots that read
//      phase s (1, 2 or 4; dout staged shifted and masked where the shift
//      leaves the image: the conv's zero padding); on q = 0 also dY =
//      dout_taps wconv (the conv adjoint as a K = 9 out product), dyb =
//      round(dY), dP = dyb wpf^T, dz = round(prelu'(z) dP) (written, phase
//      s at columns s C of an (M, 16 C) map), dwpf += a^T dyb. The fold,
//      dwpf and the slope sum stay in registers over the chunk and leave
//      as one partial per CTA. y, a, z, dY and dyb never reach device
//      memory. Independent products go out as one wgmma group (z with dY,
//      y with dP, the fold with dwpf, the last beside the dz store).
//   3. pixel: per 64-pixel strip, dzb = prelu'(zb) (dxb wbf^T) (slope and
//      column partials, round(dzb) written), dx = round(dz wexp^T +
//      round(dzb) wb1^T) over K = 16 C + C, dz streamed by TMA.
//   4. the weight gradients dwexp = x^T dz, dwbf = abv^T dxb, dwb1 = x^T
//      round(dzb) as token-chunk partials (bb::wgrad_kernel).
//   5. every partial summed in a fixed order, dwexp back to w_exp's column
//      order c * 16 + s and the fold unfolded to (3, 3, C, out).
// Bytes per launch at batch 4 (64,64,96): 1 reads x and dout, writes zb,
// xb (6.3 MB each), abv, dxb (3.1 MB each); 2 reads x and xb's
// neighbourhoods (L2, once per phase) and dout, writes dz (50 MB); 3 reads
// dz, dxb, zb, writes dx,
// round(dzb); 4 reads x, dz, abv, dxb, round(dzb); partials are a few MB.
// Plans are functions of one image's shape (kernels/upsample.py::
// up4_conv_bwd_plan mirrors up4_bwd_plan); no sum uses atomics.
#include "block_bwd_hopper.cuh"
#include "up4_bwd.cuh"

namespace sunet {
namespace u4 {

using bb::kThr;
constexpr int kBox = 64 * 128;        // one 64 x 64 bf16 box or A panel (128-byte rows)
constexpr int kPhaseChunks = 8;       // tile chunks of the phase launch at kPlanBatch images
constexpr int kCopyCtas = 16;         // the prep launch's weight-layout CTAs
constexpr int kWcRows = 80;           // K of the conv adjoint's product: 9 * out to 16, out <= 8
constexpr int kDxbT = 8;              // the stencil adjoint's tile: 8 x 8 pixels

// Per-axis conv slots: base offset and phase (kernels/upsample.py::USLOTS);
// the slots that read phase p along one axis.
static __constant__ int kSlotOff[6] = {-1, 0, 0, 0, 0, 1};
static __constant__ int kUn[4] = {2, 1, 1, 2};
static __constant__ int kUs[4][2] = {{1, 5}, {2, 2}, {3, 3}, {0, 4}};

struct Up4BwdPlan {
  int ntiles;                 // 64-pixel strips (prep, pixel)
  int tpc, ptiles, nchunks;   // phase launch: 8 x 8 tiles per chunk, tiles, chunks
  int ndxb;                   // 8 x 8 tiles of the stencil adjoint (= ptiles)
  int wchunk, wnchunks;       // weight gradients: tokens per chunk, chunks
  int k16;                    // K of the conv adjoint's product
};

// The plan (kernels/upsample.py::up4_conv_bwd_plan mirrors it).
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

// Shared-memory bytes of the three launches of our own (1024 of alignment
// slack, then a 1024-byte header; kernels/upsample.py mirrors them).
inline size_t prep_smem(int C, int out) {
  const size_t strip = 1024 + 12 * (size_t)kBox;
  const size_t dxb = 4 * ((size_t)144 * 16 * out + 42 * 8 * 3 * out + 64 * 9 * out + 9 * C * out);
  return 1024 + std::max(strip, dxb);
}
constexpr size_t kPhaseSmem =
    1024 + 1024 + 8 * kBox + 2 * kWcRows * 128 + 13 * kBox + 81 * (96 + 4) * 4;
constexpr size_t kPixelSmem = 1024 + 1024 + 12 * kBox + 3 * 3 * kBox + 64 * 96 * 4;

struct Up4Work {
  float *zb, *xb, *ppf, *pfold, *pap, *pab, *pbb1, *pw[3];
  bf16 *abv, *dxb, *dzb, *dz, *wst, *wct;
  size_t bytes;
};

// The workspace (kernels/upsample.py::up4_conv_bwd_workspace mirrors it).
// With p == nullptr only measures.
inline Up4Work carve_up4(unsigned char* p, const Up4BwdPlan& pl, int M, int C, int out) {
  Carve cv{p};
  Up4Work w;
  const size_t mc = (size_t)M * C;
  w.zb = cv.take<float>(mc);
  w.xb = cv.take<float>(mc);
  w.abv = cv.take<bf16>(mc);
  w.dxb = cv.take<bf16>(mc);
  w.dzb = cv.take<bf16>(mc);
  w.dz = cv.take<bf16>(16 * mc);
  w.wst = cv.take<bf16>((size_t)16 * C * C);
  w.wct = cv.take<bf16>((size_t)9 * out * C);
  w.ppf = cv.take<float>((size_t)pl.nchunks * 16 * C * C);
  w.pfold = cv.take<float>((size_t)pl.nchunks * 36 * C * 16 * out);
  w.pap = cv.take<float>((size_t)pl.nchunks * 16);
  w.pab = cv.take<float>((size_t)pl.ntiles);
  w.pbb1 = cv.take<float>((size_t)pl.ntiles * C);
  w.pw[0] = cv.take<float>((size_t)pl.wnchunks * C * 16 * C);
  w.pw[1] = cv.take<float>((size_t)pl.wnchunks * C * C);
  w.pw[2] = cv.take<float>((size_t)pl.wnchunks * C * C);
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

__device__ inline float4 axpy4(float a, float4 x, float b, float4 y) {
  return make_float4(a * x.x + b * y.x, a * x.y + b * y.y, a * x.z + b * y.z, a * x.w + b * y.w);
}

// acc = A (64 x K, swizzled K-major panels at a) @ W[0:K, 64 nb: 64 nb + 64],
// W held as 64 x 64 boxes, box (row block kc, column block nb) at (2 kc +
// nb) * kBox.
__device__ inline void mm_w(float (&acc)[32], const unsigned char* a, const unsigned char* w,
                            int nb, int K) {
  zero(acc);
  hop::wg_fence();
  for (int kk = 0; kk < K; kk += 16)
    hop::wgmma64(acc, hop::a_desc(a, kk), hop::b_desc(w + (2 * (kk >> 6) + nb) * kBox, kk & 63),
                 1);
  hop::wg_commit();
  hop::wg_wait0();
}

// acc = A (64 x K) @ W^T[0:K, 64 nb: 64 nb + 64] from the same boxes (W's
// rows 64 nb .. are the output columns, read K-major).
__device__ inline void mm_wt(float (&acc)[32], const unsigned char* a, const unsigned char* w,
                             int nb, int K) {
  zero(acc);
  hop::wg_fence();
  for (int kk = 0; kk < K; kk += 16)
    hop::wgmma64_kmajor(acc, hop::a_desc(a, kk),
                        hop::a_desc(w + (2 * nb + (kk >> 6)) * kBox, kk & 63), 1);
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

// Map of x (B, H, W, C) bf16 in boxes of 64 channels x an 8 x 8 pixel tile:
// a box lands as 64 rows (pixel (h0 + r / 8, w0 + r % 8)) of 128 bytes
// with the 128-byte swizzle, the A operand's layout; pixels and channels
// off the tensor fill zeros.
inline cudaError_t tile_map(CUtensorMap* m, const void* x, int B, int H, int W, int C) {
  const hop::EncodeTiledFn f = hop::encode_tiled();
  if (f == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  if (C % 8 || (reinterpret_cast<uintptr_t>(x) & 15)) return cudaErrorInvalidValue;
  const cuuint64_t dim[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t stride[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {64, kDxbT, kDxbT, 1};
  const cuuint32_t es[4] = {1, 1, 1, 1};
  const CUresult r = f(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dim, stride,
                       box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- launch 1

struct PrepArgs {
  const bf16 *dout, *wexp, *wconv;
  const float *bb1, *alphas;
  float *zb, *xb;
  bf16 *abv, *dxb, *wst, *wct;
  int B, H, W, C, out, nstrips, ndxb;
};

// Strip: zb = x wb1 + bb1, abv = round(prelu(zb)), xb = abv wbf.
template <int NBX>
__device__ inline void prep_strip(const PrepArgs& a, const CUtensorMap* mx,
                                  const CUtensorMap* mwb1, const CUtensorMap* mwbf,
                                  unsigned char* base, int strip) {
  uint64_t* bar = reinterpret_cast<uint64_t*>(base);
  unsigned char* X = base + 1024;
  unsigned char* Wb1 = X + 2 * kBox;
  unsigned char* Wbf = Wb1 + 4 * kBox;
  unsigned char* A2 = Wbf + 4 * kBox;
  const int tid = threadIdx.x, wg = tid >> 7, t128 = tid & 127, C = a.C;
  const int M = a.B * a.H * a.W, m0 = strip * 64;
  const float ab = a.alphas[1];
  if (tid == 0) {
    hop::mbar_init(bar, 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hop::mbar_expect_tx(bar, (uint32_t)(NBX + 2 * NBX * NBX) * kBox);
    for (int cb = 0; cb < NBX; ++cb) hop::tma_load(X + cb * kBox, mx, bar, 64 * cb, m0);
    for (int rb = 0; rb < NBX; ++rb)
      for (int cb = 0; cb < NBX; ++cb) {
        hop::tma_load(Wb1 + (2 * rb + cb) * kBox, mwb1, bar, 64 * cb, 64 * rb);
        hop::tma_load(Wbf + (2 * rb + cb) * kBox, mwbf, bar, 64 * cb, 64 * rb);
      }
  }
  hop::mbar_wait(bar, 0);
  float acc[32];
  if (wg < NBX) {
    mm_w(acc, X, Wb1, wg, C);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = hop::acc_row(t128, i), col = 64 * wg + hop::acc_col(t128, i);
      const int m = m0 + row;
      bf16 v = tobf(0.f);
      if (m < M && col < C) {
        const float z = acc[i] + a.bb1[col];
        v = tobf(prelu_f(z, ab));
        a.zb[(size_t)m * C + col] = z;
        a.abv[(size_t)m * C + col] = v;
      }
      *reinterpret_cast<bf16*>(A2 + hop::a_off(row, col)) = v;
    }
  }
  hop::fence_async_smem();
  __syncthreads();
  if (wg < NBX) {
    mm_w(acc, A2, Wbf, wg, C);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = hop::acc_row(t128, i), col = 64 * wg + hop::acc_col(t128, i);
      if (m0 + row < M && col < C) a.xb[(size_t)(m0 + row) * C + col] = acc[i];
    }
  }
}

// 8 x 8 tile: dxb = round(stencil^T(conv^T(dout))). With Q a high-res
// dout index and P = Q + tap one of the stencil's sources, per axis
// coefficient tap_coef(P, t): R sums the W axis for every high-res row the
// tile needs, Hm the H axis per (pixel, conv tap, out), then dxb = Hm .
// wconv over the 9 * out (tap, out) pairs.
__device__ inline void prep_dxb(const PrepArgs& a, unsigned char* base, int tile) {
  const int H = a.H, W = a.W, C = a.C, out = a.out, O = 16 * out, tid = threadIdx.x;
  const int nth = (H + kDxbT - 1) / kDxbT, ntw = (W + kDxbT - 1) / kDxbT;
  const int b = tile / (nth * ntw), rem = tile % (nth * ntw);
  const int th0 = (rem / ntw) * kDxbT, tw0 = (rem % ntw) * kDxbT;
  float* D = reinterpret_cast<float*>(base);   // [12][12][O]: low-res rows th0-2 .., cols tw0-2 ..
  float* R = D + 144 * O;                      // [42][8][3][out]: high-res row 4 (th0 - 2) + 3 + qh
  float* Hm = R + 42 * 8 * 3 * out;            // [64][9][out]
  float* Wf = Hm + 64 * 9 * out;               // [9][C][out]
  stage<9, float>(
      144 * O,
      [&](int i) {
        const int lr = i / (12 * O), lc = (i / O) % 12, ch = i % O;
        const int hh = th0 - 2 + lr, ww = tw0 - 2 + lc;
        const bool ok = hh >= 0 && hh < H && ww >= 0 && ww < W;
        const bf16* src = ok ? a.dout + (((size_t)b * H + hh) * W + ww) * O + ch : a.dout;
        const float v = bf(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(src))));
        return ok ? v : 0.f;
      },
      [&](int i, float v) { D[i] = v; });
  for (int i = tid; i < 9 * C * out; i += kThr) Wf[i] = bf(a.wconv[i]);
  __syncthreads();
  for (int i = tid; i < 42 * 8 * 3 * out; i += kThr) {
    const int o = i % out, dxi = (i / out) % 3, pw = (i / (3 * out)) % 8, qh = i / (24 * out);
    const int tw = tw0 + pw, qhl = qh + 3;
    const float* drow = D + (qhl >> 2) * 12 * O + (qhl & 3) * 4 * out + o;
    float s = 0.f;
    if (tw < W)
      for (int P = 4 * (tw - 1); P <= 4 * tw + 7; ++P) {
        if ((P >> 2) < 0 || (P >> 2) >= W) continue;
        const int qwl = P - (dxi - 1) - 4 * (tw0 - 2);
        s += tap_coef(P, tw, W) * drow[(qwl >> 2) * O + (qwl & 3) * out];
      }
    R[i] = s;
  }
  __syncthreads();
  for (int i = tid; i < 64 * 9 * out; i += kThr) {
    const int o = i % out, tap = (i / out) % 9, px = i / (9 * out);
    const int th = th0 + px / kDxbT, pw = px % kDxbT, dy = tap / 3 - 1, dxi = tap % 3;
    float s = 0.f;
    if (th < H)
      for (int P = 4 * (th - 1); P <= 4 * th + 7; ++P) {
        if ((P >> 2) < 0 || (P >> 2) >= H) continue;
        const int qh = P - dy - 4 * (th0 - 2) - 3;
        s += tap_coef(P, th, H) * R[((qh * 8 + pw) * 3 + dxi) * out + o];
      }
    Hm[i] = s;
  }
  __syncthreads();
  for (int i = tid; i < 64 * C; i += kThr) {
    const int px = i / C, c = i % C, th = th0 + px / kDxbT, tw = tw0 + px % kDxbT;
    if (th >= H || tw >= W) continue;
    const float* hm = Hm + px * 9 * out;
    float s = 0.f;
    for (int k = 0; k < 9 * out; ++k) s += hm[k] * Wf[((k / out) * C + c) * out + k % out];
    a.dxb[(((size_t)b * H + th) * W + tw) * C + c] = tobf(s);
  }
}

// w_exp (C, 16C), column n * 16 + s -> wst (16C, C), row s * C + k; wconv
// (3, 3, C, out) -> wct (9 out, C), row tap * out + o.
__device__ inline void prep_copy(const PrepArgs& a, int cta) {
  const int C = a.C, out = a.out;
  const int stride = kCopyCtas * kThr, i0 = cta * kThr + threadIdx.x;
  for (int i = i0; i < 16 * C * C; i += stride) {
    const int s = i / (C * C), k = (i / C) % C, n = i % C;
    a.wst[i] = a.wexp[(size_t)k * 16 * C + n * 16 + s];
  }
  for (int i = i0; i < 9 * out * C; i += stride) {
    const int k = i / C, c = i % C;
    a.wct[i] = a.wconv[((k / out) * C + c) * out + k % out];
  }
}

template <int NBX>
__global__ void __launch_bounds__(kThr, 1)
    prep_kernel(const __grid_constant__ PrepArgs a, const __grid_constant__ CUtensorMap mx,
                const __grid_constant__ CUtensorMap mwb1, const __grid_constant__ CUtensorMap mwbf) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = align1k(smem_raw);
  const int bid = blockIdx.x;
  if (bid < a.nstrips) prep_strip<NBX>(a, &mx, &mwb1, &mwbf, base, bid);
  else if (bid < a.nstrips + a.ndxb) prep_dxb(a, base, bid - a.nstrips);
  else prep_copy(a, bid - a.nstrips - a.ndxb);
}

// ---------------------------------------------------------------- launch 2

// A measurement build (-DSUNET_PHASE_CLOCK, sunet_tf_tpu_torch/tools/
// block_phases.py --kernel up4_bwd) adds thread 0's SM clock cycles per
// phase of the phase launch (kPhPhases: setup, the staged gathers (dout
// shifted, the xb neighbourhood, the conv adjoint's A), the wait for x, z
// with dY, y with dP, the fold and dwpf with the dz store, the partials)
// over the CTA's tiles into the buffer given to
// sunet_up4_conv_bwd_phase_clock, kPhPhases values per CTA in launch order
// (x fastest).
constexpr int kPhPhases = 7;
#ifdef SUNET_PHASE_CLOCK
__device__ long long* g_phase_clock;
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

struct PhaseArgs {
  const bf16* dout;
  const float *xb, *alphas;
  bf16* dz;                    // (M, 16C): phase s at columns s * C
  float *ppf, *pfold, *pap;    // [chunk][16][C][C], [chunk][36][C][16 out], [chunk][16]
  int B, H, W, C, out, tpc, ntiles, k16;
};

// The xb neighbourhood of an 8 x 8 tile for one phase: 9 x 9 pixels (rows
// h0 - 1 .. h0 + 7 for i < 2, h0 .. h0 + 8 else; the same for columns),
// clamped at the image's edge, fp32 with a padded pixel pitch.
constexpr int kNbPitch = 96 + 4;
constexpr int kNbBytes = 81 * kNbPitch * 4;

// CTA (chunk of 8 x 8 pixel tiles, phase s, fold box q); a tile's 64 rows
// are its pixels (h0 + r / 8, w0 + r % 8), those off the image zero.
template <int NBX>
__global__ void __launch_bounds__(kThr, 1)
    phase_kernel(const __grid_constant__ PhaseArgs a, const __grid_constant__ CUtensorMap mx,
                 const __grid_constant__ CUtensorMap mwst, const __grid_constant__ CUtensorMap mwpf,
                 const __grid_constant__ CUtensorMap mwct) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = align1k(smem_raw);
  const int chunk = blockIdx.x, s = blockIdx.y, q = blockIdx.z, pi = s >> 2, pj = s & 3;
  const int H = a.H, W = a.W, C = a.C, out = a.out, O = 16 * out;
  const int nu = kUn[pj], ncol = kUn[pi] * nu * O;   // the fold's columns: phase s's slots x O
  const int t0 = chunk * a.tpc, t1 = min(a.ntiles, t0 + a.tpc);
  if (64 * q >= ncol || t0 >= t1) return;
  const bool lead = q == 0;   // the CTA of box 0 also runs the input-gradient chain
  const int nth = (H + kDxbT - 1) / kDxbT, ntw = (W + kDxbT - 1) / kDxbT;
  uint64_t* wbar = reinterpret_cast<uint64_t*>(base);
  uint64_t* xbar = wbar + 1;   // [2]
  float* red = reinterpret_cast<float*>(base + 64);
  unsigned char* Wx = base + 1024;        // wexp_s, 4 boxes
  unsigned char* Wp = Wx + 4 * kBox;      // wpf, 4 boxes
  unsigned char* Wc = Wp + 4 * kBox;      // wct, 2 boxes of k16 rows
  unsigned char* X = Wc + 2 * kWcRows * 128;   // [2][2 panels]
  unsigned char* Aa = X + 4 * kBox;
  unsigned char* Y = Aa + 2 * kBox;
  unsigned char* Dg = Y + 2 * kBox;       // the conv adjoint's A; then dz staged for the store
  unsigned char* Ad = Dg + 2 * kBox;      // round(dY)
  unsigned char* Dsh = Ad + 2 * kBox;     // dout shifted by the slots of box q
  float* Nb = reinterpret_cast<float*>(Dsh + kBox);   // the tile's xb neighbourhood
  const int tid = threadIdx.x, wg = tid >> 7, t128 = tid & 127;
#ifdef SUNET_PHASE_CLOCK
  long long clk = clock64();
#endif
  const float ap = a.alphas[0];
  if (tid == 0) {
    hop::mbar_init(wbar, 1);
    hop::mbar_init(&xbar[0], 1);
    hop::mbar_init(&xbar[1], 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  auto tile_at = [&](int t, int& b, int& h0, int& w0) {
    b = t / (nth * ntw);
    h0 = kDxbT * ((t / ntw) % nth);
    w0 = kDxbT * (t % ntw);
  };
  auto issue_x = [&](int t, int buf) {
    int b, h0, w0;
    tile_at(t, b, h0, w0);
    hop::mbar_expect_tx(&xbar[buf], (uint32_t)NBX * kBox);
    for (int cb = 0; cb < NBX; ++cb)
      tma_load4(X + (2 * buf + cb) * kBox, &mx, &xbar[buf], 64 * cb, w0, h0, b);
  };
  if (tid == 0) {
    hop::mbar_expect_tx(wbar, (uint32_t)(2 * NBX * NBX * kBox + NBX * a.k16 * 128));
    for (int rb = 0; rb < NBX; ++rb)
      for (int cb = 0; cb < NBX; ++cb) {
        hop::tma_load(Wx + (2 * rb + cb) * kBox, &mwst, wbar, 64 * cb, s * C + 64 * rb);
        hop::tma_load(Wp + (2 * rb + cb) * kBox, &mwpf, wbar, 64 * cb, 64 * rb);
      }
    for (int cb = 0; cb < NBX; ++cb)
      hop::tma_load(Wc + cb * kWcRows * 128, &mwct, wbar, 64 * cb, 0);
    issue_x(t0, 0);
  }
  float z[32], acc[32], fold[32], pf[NBX][32];
  zero(fold);
#pragma unroll
  for (int j = 0; j < NBX; ++j) zero(pf[j]);
  float aps = 0.f;
  // this thread's column chunk of Dsh (64 q + 8 (tid % 8)): its slot's
  // shift and dout column, every tile
  const int dcol = 64 * q + (tid & 7) * 8, dsi = min(dcol, ncol - 1) / O;
  const bool dcol_ok = dcol < ncol;
  const int do0 = dcol % O, ddh = kSlotOff[kUs[pi][dsi / nu]], ddw = kSlotOff[kUs[pj][dsi % nu]];
  PH_PHASE(0);
  for (int t = t0; t < t1; ++t) {
    const int it = t - t0, buf = it & 1;
    int b, h0, w0;
    tile_at(t, b, h0, w0);
    if (tid == 0 && t + 1 < t1) issue_x(t + 1, buf ^ 1);
    // dout shifted by each slot of box q, zero where the shift leaves the
    // image (the conv's zero padding) or past the pixels
    stage<2, uint4>(
        64 * 8,
        [&](int e) {
          const int r = e >> 3;
          const int hh = h0 + (r >> 3) - ddh, ww = w0 + (r & 7) - ddw;
          const bool ok = dcol_ok && h0 + (r >> 3) < H && w0 + (r & 7) < W && hh >= 0 &&
                          hh < H && ww >= 0 && ww < W;
          const bf16* src = ok ? a.dout + (((size_t)b * H + hh) * W + ww) * O + do0 : a.dout;
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
          return ok ? v : make_uint4(0u, 0u, 0u, 0u);
        },
        [&](int e, uint4 v) { *reinterpret_cast<uint4*>(Dsh + hop::a_off(e >> 3, (e & 7) * 8)) = v; });
    // xb's 9 x 9 neighbourhood for phase s, edge-clamped, 4 channels at a time
    const int rb0 = pi < 2 ? h0 - 1 : h0, cb0 = pj < 2 ? w0 - 1 : w0;
    stage<8, float4>(
        81 * C / 4,
        [&](int e) {
          const int px = e / (C / 4), c4 = 4 * (e - px * (C / 4));
          const int hh = min(max(rb0 + px / 9, 0), H - 1), ww = min(max(cb0 + px % 9, 0), W - 1);
          return __ldg(reinterpret_cast<const float4*>(
              a.xb + (((size_t)b * H + hh) * W + ww) * C + c4));
        },
        [&](int e, float4 v) {
          const int px = e / (C / 4);
          *reinterpret_cast<float4*>(Nb + px * kNbPitch + 4 * (e - px * (C / 4))) = v;
        });
    if (lead)   // the conv adjoint's A: dout at the 9 taps of phase s's pixels
      stage<4, float>(
          64 * a.k16,
          [&](int e) {
            const int r = e / a.k16, k = e - r * a.k16, tap = k / out, o = k - tap * out;
            const int h = h0 + (r >> 3), w = w0 + (r & 7);
            const int py = 4 * h + pi - (tap / 3 - 1), px = 4 * w + pj - (tap % 3 - 1);
            const bool ok = h < H && w < W && k < 9 * out && py >= 0 && py < 4 * H && px >= 0 &&
                            px < 4 * W;
            const bf16* src = ok ? a.dout + (((size_t)b * H + (py >> 2)) * W + (px >> 2)) * O +
                                       ((py & 3) * 4 + (px & 3)) * out + o
                                 : a.dout;
            const float v = bf(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(src))));
            return ok ? v : 0.f;
          },
          [&](int e, float v) {
            *reinterpret_cast<bf16*>(Dg + hop::a_off(e / a.k16, e % a.k16)) = tobf(v);
          });
    hop::fence_async_smem();
    PH_PHASE(1);
    hop::mbar_wait(wbar, 0);
    hop::mbar_wait(&xbar[buf], (uint32_t)((it >> 1) & 1));
    __syncthreads();
    PH_PHASE(2);
    // z = x wexp_s and dY = dout_taps wct in one group; a = round(prelu(z)),
    // dyb = round(dY)
    if (wg < NBX) {
      const unsigned char* x = X + 2 * buf * kBox;
      zero(z);
      zero(acc);
      hop::wg_fence();
      for (int kk = 0; kk < C; kk += 16)
        hop::wgmma64(z, hop::a_desc(x, kk),
                     hop::b_desc(Wx + (2 * (kk >> 6) + wg) * kBox, kk & 63), 1);
      if (lead)
        for (int kk = 0; kk < a.k16; kk += 16)
          hop::wgmma64(acc, hop::a_desc(Dg, kk), hop::b_desc(Wc + wg * kWcRows * 128, kk), 1);
      hop::wg_commit();
      hop::wg_wait0();
#pragma unroll
      for (int i = 0; i < 32; i += 2) {   // column pairs: one 4-byte store each
        const uint32_t o = hop::a_off(hop::acc_row(t128, i), 64 * wg + hop::acc_col(t128, i));
        *reinterpret_cast<uint32_t*>(Aa + o) = pack_bf2(prelu_f(z[i], ap), prelu_f(z[i + 1], ap));
        if (lead) *reinterpret_cast<uint32_t*>(Ad + o) = pack_bf2(acc[i], acc[i + 1]);
      }
    }
    hop::fence_async_smem();
    __syncthreads();
    PH_PHASE(3);
    // y = a wpf and dP = dyb wpf^T in one group; y = round(y + stencil_s(xb))
    // from the neighbourhood (the H taps, then the W taps: the forward's
    // order), dz = round(prelu'(z) dP) staged row-major in Dg
    if (wg < NBX) {
      float dp[32];
      zero(acc);
      zero(dp);
      hop::wg_fence();
      for (int kk = 0; kk < C; kk += 16)
        hop::wgmma64(acc, hop::a_desc(Aa, kk),
                     hop::b_desc(Wp + (2 * (kk >> 6) + wg) * kBox, kk & 63), 1);
      if (lead)
        for (int kk = 0; kk < C; kk += 16)
          hop::wgmma64_kmajor(dp, hop::a_desc(Ad, kk),
                              hop::a_desc(Wp + (2 * wg + (kk >> 6)) * kBox, kk & 63), 1);
      hop::wg_commit();
      hop::wg_wait0();
      bf16* st = reinterpret_cast<bf16*>(Dg);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {   // column pairs: one 4-byte store each
        const int row = hop::acc_row(t128, i), col = 64 * wg + hop::acc_col(t128, i);
        const int ph = row >> 3, pw = row & 7;
        float y2[2] = {0.f, 0.f};
        if (h0 + ph < H && w0 + pw < W && col < C) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float* nb = Nb + (ph * 9 + pw) * kNbPitch + col + u;
            const float yl = kQ4[pi][0] * nb[0] + kQ4[pi][1] * nb[9 * kNbPitch];
            const float yr = kQ4[pi][0] * nb[kNbPitch] + kQ4[pi][1] * nb[10 * kNbPitch];
            y2[u] = acc[i + u] + (kQ4[pj][0] * yl + kQ4[pj][1] * yr);
          }
        }
        *reinterpret_cast<uint32_t*>(Y + hop::a_off(row, col)) = pack_bf2(y2[0], y2[1]);
        if (lead && col < C) {
          *reinterpret_cast<uint32_t*>(st + row * C + col) =
              pack_bf2(z[i] > 0.f ? dp[i] : ap * dp[i], z[i + 1] > 0.f ? dp[i + 1] : ap * dp[i + 1]);
          aps += fminf(z[i], 0.f) * dp[i];
          aps += fminf(z[i + 1], 0.f) * dp[i + 1];
        }
      }
    }
    hop::fence_async_smem();
    __syncthreads();
    PH_PHASE(4);
    // the fold (y^T dout_shifted for box q's slot columns) and dwpf += a^T
    // dyb in one group, while the threads store dz (phase s at columns s C)
    if (wg < NBX) {
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 64; kk += 16) {
        hop::wgmma64_tt(fold, hop::b_desc(Y + wg * kBox, kk), hop::b_desc(Dsh, kk), 1);
        if (lead)
#pragma unroll
          for (int nb = 0; nb < NBX; ++nb)
            hop::wgmma64_tt(pf[nb], hop::b_desc(Aa + wg * kBox, kk),
                            hop::b_desc(Ad + nb * kBox, kk), 1);
      }
      hop::wg_commit();
    }
    if (lead) {
      const bf16* st = reinterpret_cast<const bf16*>(Dg);
      const int c8 = C / 8;
      for (int e = tid; e < 64 * c8; e += kThr) {
        const int row = e / c8, j = e % c8, h = h0 + (row >> 3), w = w0 + (row & 7);
        if (h < H && w < W)
          reinterpret_cast<uint4*>(a.dz + (((size_t)b * H + h) * W + w) * 16 * C + s * C)[j] =
              reinterpret_cast<const uint4*>(st + row * C)[j];
      }
    }
    if (wg < NBX) hop::wg_wait0();
    __syncthreads();   // the tile's buffers are free
    PH_PHASE(5);
  }
  // the chunk's partials
  if (wg < NBX) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 64 * wg + hop::acc_row(t128, i), col = 64 * q + hop::acc_col(t128, i);
      if (c < C && col < ncol) {
        const int si = col / O;
        const int slot = kUs[pi][si / nu] * 6 + kUs[pj][si % nu];
        a.pfold[(((size_t)chunk * 36 + slot) * C + c) * O + col % O] = fold[i];
      }
    }
    if (lead)
#pragma unroll
      for (int nb = 0; nb < NBX; ++nb)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int c = 64 * wg + hop::acc_row(t128, i), c2 = 64 * nb + hop::acc_col(t128, i);
          if (c < C && c2 < C)
            a.ppf[(((size_t)chunk * 16 + s) * C + c) * C + c2] = pf[nb][i];
        }
  }
  if (lead) {   // the slope sum: warps in order
    aps = warp_sum(aps);
    if ((tid & 31) == 0) red[tid >> 5] = aps;
    __syncthreads();
    if (tid == 0) {
      float v = 0.f;
      for (int w = 0; w < kThr / 32; ++w) v += red[w];
      a.pap[chunk * 16 + s] = v;
    }
  }
  PH_PHASE(6);
}

// ---------------------------------------------------------------- launch 3

struct PixelArgs {
  const float *zb, *alphas;
  bf16 *dzb, *dx;
  float *pab, *pbb1;   // [strip], [strip][C]
  int M, C;
};

template <int NBX>
__global__ void __launch_bounds__(kThr, 1)
    pixel_kernel(const __grid_constant__ PixelArgs a, const __grid_constant__ CUtensorMap mdxb,
                 const __grid_constant__ CUtensorMap mdz, const __grid_constant__ CUtensorMap mwst,
                 const __grid_constant__ CUtensorMap mwbf, const __grid_constant__ CUtensorMap mwb1) {
  constexpr int kS = 3, kSlotB = (1 + 2) * kBox;   // ring: slots of (dz box, wst boxes)
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = align1k(smem_raw);
  uint64_t* wbar = reinterpret_cast<uint64_t*>(base);
  uint64_t* full = wbar + 1;
  uint64_t* empty = full + kS;
  float* red = reinterpret_cast<float*>(base + 128);
  unsigned char* Wbf = base + 1024;
  unsigned char* Wb1 = Wbf + 4 * kBox;
  unsigned char* A0 = Wb1 + 4 * kBox;   // dxb
  unsigned char* A1 = A0 + 2 * kBox;    // round(dzb)
  unsigned char* ring = A1 + 2 * kBox;
  float* cs = reinterpret_cast<float*>(ring + kS * kSlotB);   // [64][C] fp32 dzb
  const int tid = threadIdx.x, wg = tid >> 7, t128 = tid & 127, C = a.C, M = a.M;
  const int strip = blockIdx.x, m0 = strip * 64, nch = 16 * NBX;
  const float ab = a.alphas[1];
  if (tid == 0) {
    hop::mbar_init(wbar, 1);
    for (int i = 0; i < kS; ++i) {
      hop::mbar_init(&full[i], 1);
      hop::mbar_init(&empty[i], kThr);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();
  // chunk q of dz wexp^T: phase q / NBX, K columns 64 (q % NBX) of it
  auto issue = [&](int q) {
    const int sl = q % kS, ph = q / NBX, kc = q % NBX;
    unsigned char* slot = ring + (size_t)sl * kSlotB;
    hop::mbar_expect_tx(&full[sl], (uint32_t)(1 + NBX) * kBox);
    hop::tma_load(slot, &mdz, &full[sl], ph * C + 64 * kc, m0);
    for (int j = 0; j < NBX; ++j)
      hop::tma_load(slot + (1 + j) * kBox, &mwst, &full[sl], 64 * kc, ph * C + 64 * j);
  };
  if (tid == 0) {
    hop::mbar_expect_tx(wbar, (uint32_t)(2 * NBX * NBX + NBX) * kBox);
    for (int rb = 0; rb < NBX; ++rb)
      for (int cb = 0; cb < NBX; ++cb) {
        hop::tma_load(Wbf + (2 * rb + cb) * kBox, &mwbf, wbar, 64 * cb, 64 * rb);
        hop::tma_load(Wb1 + (2 * rb + cb) * kBox, &mwb1, wbar, 64 * cb, 64 * rb);
      }
    for (int cb = 0; cb < NBX; ++cb) hop::tma_load(A0 + cb * kBox, &mdxb, wbar, 64 * cb, m0);
    for (int q = 0; q < kS; ++q) issue(q);
  }
  hop::mbar_wait(wbar, 0);
  // dzb = prelu'(zb) (dxb wbf^T): fp32 into cs, rounded into A1 and out
  float acc[32], abs_ = 0.f;
  if (wg < NBX) {
    float zbv[32];   // every load before the epilogue's stores
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = hop::acc_row(t128, i), col = 64 * wg + hop::acc_col(t128, i);
      zbv[i] = m0 + row < M && col < C ? __ldg(a.zb + (size_t)(m0 + row) * C + col) : 0.f;
    }
    mm_wt(acc, A0, Wbf, wg, C);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = hop::acc_row(t128, i), col = 64 * wg + hop::acc_col(t128, i);
      const int m = m0 + row;
      float d = 0.f;
      if (m < M && col < C) {
        const float zz = zbv[i];
        d = zz > 0.f ? acc[i] : ab * acc[i];
        abs_ += fminf(zz, 0.f) * acc[i];
        a.dzb[(size_t)m * C + col] = tobf(d);
      }
      if (col < C) cs[row * C + col] = d;
      *reinterpret_cast<bf16*>(A1 + hop::a_off(row, col)) = tobf(d);
    }
  }
  hop::fence_async_smem();
  abs_ = warp_sum(abs_);
  if ((tid & 31) == 0) red[tid >> 5] = abs_;
  __syncthreads();
  if (tid < C) {   // bb1's column partial: rows in order
    float v = 0.f;
    for (int r = 0; r < 64; ++r) v += cs[r * C + tid];
    a.pbb1[(size_t)strip * C + tid] = v;
  }
  if (tid == 0) {
    float v = 0.f;
    for (int w = 0; w < kThr / 32; ++w) v += red[w];
    a.pab[strip] = v;
  }
  // dx = round(dz wexp^T + round(dzb) wb1^T)
  zero(acc);
  for (int q = 0; q < nch; ++q) {
    const int sl = q % kS;
    hop::mbar_wait(&full[sl], (uint32_t)((q / kS) & 1));
    const unsigned char* slot = ring + (size_t)sl * kSlotB;
    if (wg < NBX) {
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 64; kk += 16)
        hop::wgmma64_kmajor(acc, hop::a_desc(slot, kk), hop::a_desc(slot + (1 + wg) * kBox, kk),
                            1);
      hop::wg_commit();
      hop::wg_wait0();
    }
    hop::mbar_arrive(&empty[sl]);
    if (tid == 0 && q + kS < nch) {
      hop::mbar_wait(&empty[sl], (uint32_t)((q / kS) & 1));
      issue(q + kS);
    }
  }
  if (wg < NBX) {
    hop::wg_fence();
    for (int kk = 0; kk < C; kk += 16)
      hop::wgmma64_kmajor(acc, hop::a_desc(A1, kk),
                          hop::a_desc(Wb1 + (2 * wg + (kk >> 6)) * kBox, kk & 63), 1);
    hop::wg_commit();
    hop::wg_wait0();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = hop::acc_row(t128, i), col = 64 * wg + hop::acc_col(t128, i);
      if (m0 + row < M && col < C) a.dx[(size_t)(m0 + row) * C + col] = tobf(acc[i]);
    }
  }
}

// ---------------------------------------------------------------- launch 5

struct SumArgs9 {
  const float *pw0, *pw1, *pw2, *ppf, *pfold, *pap, *pab, *pbb1;
  float *dwexp, *dwbf, *dwb1, *dwpf, *dwconv, *dbb1, *dalphas;
  int C, out, nchunks, ntiles, wnchunks;
};

// The slot of output phase i with conv tap d along one axis
// (kernels/upsample.py::_slot).
__device__ inline int conv_slot(int i, int d) {
  const int hi = i + d;
  return hi < 0 ? 0 : (hi > 3 ? 5 : 1 + hi);
}

// One thread per output value, its partials summed in a fixed order.
static __global__ void __launch_bounds__(kThr) sum9_kernel(const __grid_constant__ SumArgs9 a) {
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
    if (e < n4) {   // dwconv (3, 3, C, out): every output phase's slot
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
      for (int z = 0; z < 16 * a.nchunks; ++z) v += a.pap[z];
    else
      for (int z = 0; z < a.ntiles; ++z) v += a.pab[z];
    a.dalphas[e] = v;
  }
}

// ---------------------------------------------------------------- the sequence

struct Up4BwdArgs {
  const bf16 *x, *dout, *wexp, *wb1;
  const float* bb1;
  const bf16 *wpf, *wbf, *wconv;
  const float* alphas;
  bf16* dx;
  float *dwexp, *dalphas, *dwb1, *dbb1, *dwpf, *dwbf, *dwconv;
  int B, H, W, C, out;
};

template <int NBX>
cudaError_t up4_bwd(const Up4BwdArgs& a, const Up4Work& w, const Up4BwdPlan& pl,
                    cudaStream_t st, int* n) {
  const int M = a.B * a.H * a.W, C = a.C;
  CUtensorMap mx, mx4, mwb1, mwbf, mwpf, mwst, mwct, mdz, mdxb;
  SUNET_TRY(hop::weight_map(&mx, a.x, M, C, 64));
  SUNET_TRY(tile_map(&mx4, a.x, a.B, a.H, a.W, C));
  SUNET_TRY(hop::weight_map(&mwb1, a.wb1, C, C, 64));
  SUNET_TRY(hop::weight_map(&mwbf, a.wbf, C, C, 64));
  SUNET_TRY(hop::weight_map(&mwpf, a.wpf, C, C, 64));
  SUNET_TRY(hop::weight_map(&mwst, w.wst, 16 * C, C, 64));
  SUNET_TRY(hop::weight_map(&mwct, w.wct, 9 * a.out, C, pl.k16));
  SUNET_TRY(hop::weight_map(&mdz, w.dz, M, 16 * C, 64));
  SUNET_TRY(hop::weight_map(&mdxb, w.dxb, M, C, 64));
  {
    const PrepArgs p{a.dout, a.wexp, a.wconv, a.bb1, a.alphas, w.zb,  w.xb,       w.abv,
                     w.dxb,  w.wst,  w.wct,   a.B,   a.H,      a.W,   C,          a.out,
                     pl.ntiles, pl.ndxb};
    SUNET_TRY(hop::launch_cluster(prep_kernel<NBX>, dim3(pl.ntiles + pl.ndxb + kCopyCtas), kThr,
                                  prep_smem(C, a.out), st, 1, p, mx, mwb1, mwbf));
    SUNET_TRY(launched(n));
  }
  {
    const PhaseArgs p{a.dout, w.xb, a.alphas, w.dz, w.ppf, w.pfold, w.pap, a.B, a.H, a.W,
                      C,      a.out, pl.tpc,  pl.ptiles, pl.k16};
    SUNET_TRY(hop::launch_cluster(phase_kernel<NBX>, dim3(pl.nchunks, 16, a.out), kThr,
                                  kPhaseSmem, st, 1, p, mx4, mwst, mwpf, mwct));
    SUNET_TRY(launched(n));
  }
  {
    const PixelArgs p{w.zb, a.alphas, w.dzb, a.dx, w.pab, w.pbb1, M, C};
    SUNET_TRY(hop::launch_cluster(pixel_kernel<NBX>, dim3(pl.ntiles), kThr, kPixelSmem, st, 1, p,
                                  mdxb, mdz, mwst, mwbf, mwb1));
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
  const SumArgs9 s{w.pw[0],  w.pw[1], w.pw[2], w.ppf,     w.pfold,   w.pap,      w.pab,
                   w.pbb1,   a.dwexp, a.dwbf,  a.dwb1,    a.dwpf,    a.dwconv,   a.dbb1,
                   a.dalphas, C,      a.out,   pl.nchunks, pl.ntiles, pl.wnchunks};
  const long long total = 19LL * C * C + 9LL * C * a.out + C + 2;
  sum9_kernel<<<(int)std::min<long long>((total + kThr - 1) / kThr, 2048), kThr, 0, st>>>(s);
  return launched(n);
}

}  // namespace u4
}  // namespace sunet

using namespace sunet;

#ifdef SUNET_PHASE_CLOCK
// The measurement build's per-phase cycle buffer (see kPhPhases); NULL stops
// recording.
extern "C" int sunet_up4_conv_bwd_phase_clock(void* buf) {
  return (int)cudaMemcpyToSymbol(u4::g_phase_clock, &buf, sizeof(buf));
}
#endif

extern "C" size_t sunet_up4_conv_bwd_workspace(int B, int H, int W, int C, int out) {
  return u4::carve_up4(nullptr, u4::up4_bwd_plan(B, H, W, C, out), B * H * W, C, out).bytes;
}

// x, dout, w_exp (C, 16C), wb1, bb1, wpf, wbf, wconv (3, 3, C, out),
// alphas; dx and the grads (dw_exp (C, 16C), dalphas (2), dwb1, dbb1, dwpf,
// dwbf, dwconv (3, 3, C, out)); the workspace; the shape; tpc, the plan's
// tiles per chunk of the phase launch (up4_conv_bwd_plan), refused if it is
// not this entry's; the launch count. C a multiple of 16 up to 96, 1 <= out
// <= 8, any H and W.
extern "C" int sunet_up4_conv_bwd(const void* x, const void* dout, const void* wexp,
                                  const void* wb1, const void* bb1, const void* wpf,
                                  const void* wbf, const void* wconv, const void* alphas,
                                  void* dx, void* dwexp, void* dalphas, void* dwb1, void* dbb1,
                                  void* dwpf, void* dwbf, void* dwconv, void* work, int B, int H,
                                  int W, int C, int out, int tpc, int* launches, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 16 || C % 16 || C > 96 || out < 1 || out > 8)
    return (int)cudaErrorInvalidValue;
  const u4::Up4BwdPlan pl = u4::up4_bwd_plan(B, H, W, C, out);
  if (tpc != pl.tpc) return (int)cudaErrorInvalidValue;
  const u4::Up4BwdArgs a{(const bf16*)x,    (const bf16*)dout, (const bf16*)wexp,
                         (const bf16*)wb1,  (const float*)bb1, (const bf16*)wpf,
                         (const bf16*)wbf,  (const bf16*)wconv, (const float*)alphas,
                         (bf16*)dx,         (float*)dwexp,     (float*)dalphas,
                         (float*)dwb1,      (float*)dbb1,      (float*)dwpf,
                         (float*)dwbf,      (float*)dwconv,    B,
                         H,                 W,                 C,
                         out};
  const u4::Up4Work w = u4::carve_up4((unsigned char*)work, pl, B * H * W, C, out);
  *launches = 0;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(C <= 64 ? u4::up4_bwd<1>(a, w, pl, st, launches)
                       : u4::up4_bwd<2>(a, w, pl, st, launches));
}
