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
//   3-5. up4_bwd.cuh's launches, shared with the split head's backward
//      (#11): pixel (per 64-pixel strip, dzb = prelu'(zb) (dxb wbf^T) with
//      the slope and column partials, round(dzb) written, dx = round(dz
//      wexp^T + round(dzb) wb1^T) over K = 16 C + C, dz streamed by TMA);
//      the weight gradients dwexp = x^T dz, dwbf = abv^T dxb, dwb1 = x^T
//      round(dzb) as token-chunk partials (bb::wgrad_kernel); every partial
//      summed in a fixed order, dwexp back to w_exp's column order c * 16 +
//      s and the fold unfolded to (3, 3, C, out).
// Bytes per launch at batch 4 (64,64,96): 1 reads x and dout, writes zb,
// xb (6.3 MB each), abv, dxb (3.1 MB each); 2 reads x and xb's
// neighbourhoods (L2, once per phase) and dout, writes dz (50 MB); 3 reads
// dz, dxb, zb, writes dx, round(dzb); 4 reads x, dz, abv, dxb, round(dzb);
// partials are a few MB. Plans are functions of one image's shape
// (kernels/upsample.py::up4_conv_bwd_plan mirrors up4_bwd_plan); no sum
// uses atomics.
#include "up4_bwd.cuh"

namespace sunet {
namespace u4 {

constexpr int kWcRows = 80;   // K of the conv adjoint's product: 9 * out to 16, out <= 8

// Per-axis conv slots: base offset and phase (kernels/upsample.py::USLOTS);
// the slots that read phase p along one axis.
static __constant__ int kSlotOff[6] = {-1, 0, 0, 0, 0, 1};
static __constant__ int kUn[4] = {2, 1, 1, 2};
static __constant__ int kUs[4][2] = {{1, 5}, {2, 2}, {3, 3}, {0, 4}};

// Shared-memory bytes of the two launches of our own (1024 of alignment
// slack, then a 1024-byte header; kernels/upsample.py mirrors them).
inline size_t prep_smem(int C, int out) {
  const size_t strip = strip_smem(nboxes(C), true);
  const size_t dxb = 4 * ((size_t)144 * 16 * out + 42 * 8 * 3 * out + 64 * 9 * out + 9 * C * out);
  return 1024 + std::max(strip, dxb);
}
constexpr size_t kPhaseSmem =
    1024 + 1024 + 8 * kBox + 2 * kWcRows * 128 + 13 * kBox + 81 * (96 + 4) * 4;

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

template <int NBX>
__global__ void __launch_bounds__(kThr, 1)
    prep_kernel(const __grid_constant__ PrepArgs a, const __grid_constant__ CUtensorMap mx,
                const __grid_constant__ CUtensorMap mwb1, const __grid_constant__ CUtensorMap mwbf) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = align1k(smem_raw);
  const int bid = blockIdx.x;
  if (bid < a.nstrips) prep_strip<NBX, true>(a, &mx, &mwb1, &mwbf, base, bid);
  else if (bid < a.nstrips + a.ndxb) prep_dxb(a, base, bid - a.nstrips);
  else prep_copy(a, bid - a.nstrips - a.ndxb);
}

// ---------------------------------------------------------------- launch 2

// A measurement build (-DSUNET_PHASE_CLOCK, sunet_tf_tpu_torch/tools/
// block_phases.py --kernel up4_conv_bwd) adds thread 0's SM clock cycles per
// phase of the phase launch (kPhPhases: setup, the staged gathers (dout
// shifted, the xb neighbourhood, the conv adjoint's A), the wait for x, z
// with dY, y with dP, the fold and dwpf with the dz store, the partials)
// over the CTA's tiles into the buffer given to
// sunet_up4_conv_bwd_phase_clock, kPhPhases values per CTA in launch order
// (x fastest).
constexpr int kPhPhases = 7;
#ifdef SUNET_PHASE_CLOCK
__device__ long long* g_phase_clock;
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
cudaError_t conv_bwd(const Up4BwdArgs& a, const Up4Work& w, const Up4BwdPlan& pl,
                     cudaStream_t st, int* n) {
  const int M = a.B * a.H * a.W, C = a.C;
  CUtensorMap mx, mx4, mwb1, mwbf, mwpf, mwst, mwct;
  SUNET_TRY(hop::weight_map(&mx, a.x, M, C, 64));
  SUNET_TRY(tile_map(&mx4, a.x, a.B, a.H, a.W, C));
  SUNET_TRY(hop::weight_map(&mwb1, a.wb1, C, C, 64));
  SUNET_TRY(hop::weight_map(&mwbf, a.wbf, C, C, 64));
  SUNET_TRY(hop::weight_map(&mwpf, a.wpf, C, C, 64));
  SUNET_TRY(hop::weight_map(&mwst, w.wst, 16 * C, C, 64));
  SUNET_TRY(hop::weight_map(&mwct, w.wct, 9 * a.out, C, pl.k16));
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
  const Up4Tail t{a.x,    a.wb1,  a.wbf,  a.alphas, a.dx, a.dwexp, a.dalphas, a.dwb1,
                  a.dbb1, a.dwpf, a.dwbf, a.dwconv, a.B,  a.H,     a.W,       C,
                  a.out,  16 * pl.nchunks};
  return up4_bwd_tail<NBX>(t, w, pl, st, n);
}

// ---------------------------------------------------------------- the wide form

// C above 96 (the scaled config's 180, run over 192): the phase launch above
// holds every 64-column box of z, y, dY and dP in its two warpgroups and
// both C x C weights whole, which does not fit at three boxes. The wide form
// splits it in two launches, each CTA over one output box (or a pair) at a
// time, as up4_bwd.cu's phase launch (#11) does:
//   2a. phase_box: CTA (column box q, chunk of 8 x 8 tiles, phase s). Per
//       tile the conv adjoint dY = dout_taps wct for every box (the two
//       warpgroups' boxes wg, wg + 2), dyb = round(dY) into shared memory;
//       warpgroup 0 z = x wexp_s and warpgroup 1 dP = dyb wpf^T for box q;
//       a = round(prelu(z)) (written, phase s at columns s C + 64 q of an
//       (M, 16 C) map, for 2b), dz = round(prelu'(z) dP) (written as the
//       narrow form writes it), dwpf's rows of box q += a^T dyb, the slope
//       sum; one partial per CTA.
//   2b. fold: CTA (chunk, phase s, pair p of channel boxes x fold box qo).
//       Per tile y = round(a wpf + stencil_s(xb)) for the pair's boxes (a
//       from 2a's map by TMA, the xb neighbourhood of the pair's channels)
//       and the fold dwconv_slot += y^T dout(m - slot shift), as above.
// The rounding points and the order of every fp32 sum within a tile are the
// narrow form's; a costs one more 16-phase map through device memory.
constexpr int kWideMaxBoxes = 3;   // C up to 192

inline size_t box_smem(int nbx) {
  return 2048 + (size_t)(2 * nbx + 2 * nbx + nbx + 2 + 2) * kBox + (size_t)nbx * kWcRows * 128 +
         32 * 128 * 4;
}
constexpr int kPairPitch = 128 + 4;   // the pair's xb neighbourhood: 128 channels a pixel
inline size_t fold_smem(int nbx) {
  return 2048 + (size_t)(2 * nbx + 2 * nbx + 2 + 1) * kBox + (size_t)81 * kPairPitch * 4;
}

struct BoxArgs {
  const bf16* dout;
  const float* alphas;
  bf16 *dz, *am;       // (M, 16C): phase s at columns s * C
  float *ppf, *pap;    // [chunk][16][C][C], [chunk][16][NBX]
  int B, H, W, C, out, tpc, ntiles, k16;
};

template <int NBX>
__global__ void __launch_bounds__(kThr, 1)
    phase_box_kernel(const __grid_constant__ BoxArgs a, const __grid_constant__ CUtensorMap mx,
                     const __grid_constant__ CUtensorMap mwst,
                     const __grid_constant__ CUtensorMap mwpf,
                     const __grid_constant__ CUtensorMap mwct) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = align1k(smem_raw);
  const int q = blockIdx.x, chunk = blockIdx.y, s = blockIdx.z, pi = s >> 2, pj = s & 3;
  const int H = a.H, W = a.W, C = a.C, out = a.out, O = 16 * out;
  const int t0 = chunk * a.tpc, t1 = min(a.ntiles, t0 + a.tpc);
  if (t0 >= t1) return;
  const int nth = (H + kDxbT - 1) / kDxbT, ntw = (W + kDxbT - 1) / kDxbT;
  uint64_t* wbar = reinterpret_cast<uint64_t*>(base);
  uint64_t* tbar = wbar + 1;   // [2]
  float* red = reinterpret_cast<float*>(base + 64);
  unsigned char* Wx = base + 1024;           // wexp_s, column box q: NBX boxes of K
  unsigned char* Wp = Wx + NBX * kBox;       // wpf, row box q: NBX boxes of K
  unsigned char* X = Wp + NBX * kBox;        // [2][NBX panels]: the x tile
  unsigned char* Dy = X + 2 * NBX * kBox;    // round(dY), NBX panels (A layout)
  unsigned char* Dg = Dy + NBX * kBox;       // the conv adjoint's A (64 x k16)
  unsigned char* Aa = Dg + 2 * kBox;         // a = round(prelu(z)), box q
  unsigned char* Dst = Aa + kBox;            // dz staged (Aa's layout)
  unsigned char* Wc = Dst + kBox;            // wct: NBX boxes of k16 rows
  float* Dp = reinterpret_cast<float*>(Wc + NBX * kWcRows * 128);   // dP in accumulator order
  const int tid = threadIdx.x, wg = tid >> 7, t128 = tid & 127;
  const float ap = a.alphas[0];
  if (tid == 0) {
    hop::mbar_init(wbar, 1);
    hop::mbar_init(&tbar[0], 1);
    hop::mbar_init(&tbar[1], 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  auto tile_at = [&](int t, int& b, int& h0, int& w0) {
    b = t / (nth * ntw);
    h0 = kDxbT * ((t / ntw) % nth);
    w0 = kDxbT * (t % ntw);
  };
  auto issue = [&](int t, int buf) {
    int b, h0, w0;
    tile_at(t, b, h0, w0);
    hop::mbar_expect_tx(&tbar[buf], (uint32_t)NBX * kBox);
    for (int cb = 0; cb < NBX; ++cb)
      tma_load4(X + (NBX * buf + cb) * kBox, &mx, &tbar[buf], 64 * cb, w0, h0, b);
  };
  if (tid == 0) {
    hop::mbar_expect_tx(wbar, (uint32_t)(2 * NBX * kBox + NBX * a.k16 * 128));
    for (int kc = 0; kc < NBX; ++kc) {
      hop::tma_load(Wx + kc * kBox, &mwst, wbar, 64 * q, s * C + 64 * kc);
      hop::tma_load(Wp + kc * kBox, &mwpf, wbar, 64 * kc, 64 * q);
      hop::tma_load(Wc + kc * kWcRows * 128, &mwct, wbar, 64 * kc, 0);
    }
    issue(t0, 0);
  }
  float acc[32], pf[2][32];
  zero(pf[0]);
  zero(pf[1]);
  float aps = 0.f;
  for (int t = t0; t < t1; ++t) {
    const int it = t - t0, buf = it & 1;
    int b, h0, w0;
    tile_at(t, b, h0, w0);
    if (tid == 0 && t + 1 < t1) issue(t + 1, buf ^ 1);
    // the conv adjoint's A: dout at the 9 taps of phase s's pixels
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
    hop::mbar_wait(wbar, 0);
    __syncthreads();
    // dyb = round(dout_taps wct), every box: warpgroup wg's boxes wg, wg + 2
    for (int nb = wg; nb < NBX; nb += 2) {
      zero(acc);
      hop::wg_fence();
      for (int kk = 0; kk < a.k16; kk += 16)
        hop::wgmma64(acc, hop::a_desc(Dg, kk), hop::b_desc(Wc + nb * kWcRows * 128, kk), 1);
      hop::wg_commit();
      hop::wg_wait0();
#pragma unroll
      for (int i = 0; i < 32; i += 2)
        *reinterpret_cast<uint32_t*>(
            Dy + hop::a_off(hop::acc_row(t128, i), 64 * nb + hop::acc_col(t128, i))) =
            pack_bf2(acc[i], acc[i + 1]);
    }
    hop::fence_async_smem();
    hop::mbar_wait(&tbar[buf], (uint32_t)((it >> 1) & 1));
    __syncthreads();
    // warpgroup 0: z = x wexp_s; warpgroup 1: dP = dyb wpf^T (box q)
    const unsigned char* x = X + NBX * buf * kBox;
    zero(acc);
    hop::wg_fence();
    if (wg == 0) {
      for (int kk = 0; kk < C; kk += 16)
        hop::wgmma64(acc, hop::a_desc(x, kk), hop::b_desc(Wx + (kk >> 6) * kBox, kk & 63), 1);
    } else {
      for (int kk = 0; kk < C; kk += 16)
        hop::wgmma64_kmajor(acc, hop::a_desc(Dy, kk), hop::a_desc(Wp + (kk >> 6) * kBox, kk & 63),
                            1);
    }
    hop::wg_commit();
    hop::wg_wait0();
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 32; i += 2)   // column pairs: one 4-byte store each
        *reinterpret_cast<uint32_t*>(
            Aa + hop::a_off(hop::acc_row(t128, i), hop::acc_col(t128, i))) =
            pack_bf2(prelu_f(acc[i], ap), prelu_f(acc[i + 1], ap));
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) Dp[i * 128 + t128] = acc[i];
    }
    hop::fence_async_smem();
    __syncthreads();
    // dwpf's rows of box q += a^T dyb (warpgroup wg: dyb's boxes wg, wg + 2)
    // while warpgroup 0 forms dz = round(prelu'(z) dP)
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (wg + 2 * j < NBX)
          hop::wgmma64_tt(pf[j], hop::b_desc(Aa, kk), hop::b_desc(Dy + (wg + 2 * j) * kBox, kk), 1);
    hop::wg_commit();
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = hop::acc_row(t128, i), col = hop::acc_col(t128, i);
        const float d0 = Dp[i * 128 + t128], d1 = Dp[(i + 1) * 128 + t128];
        *reinterpret_cast<uint32_t*>(Dst + hop::a_off(row, col)) =
            pack_bf2(acc[i] > 0.f ? d0 : ap * d0, acc[i + 1] > 0.f ? d1 : ap * d1);
        aps += fminf(acc[i], 0.f) * d0;
        aps += fminf(acc[i + 1], 0.f) * d1;
      }
    }
    hop::wg_wait0();
    __syncthreads();
    for (int e = tid; e < 2 * 64 * 8; e += kThr) {   // dz and a: 8 columns a store
      const int which = e >> 9, row = (e >> 3) & 63, j = e & 7;
      const int h = h0 + (row >> 3), w = w0 + (row & 7), col = 64 * q + 8 * j;
      if (h < H && w < W && col < C)
        *reinterpret_cast<uint4*>((which ? a.am : a.dz) + (((size_t)b * H + h) * W + w) * 16 * C +
                                  s * C + col) =
            *reinterpret_cast<const uint4*>((which ? Aa : Dst) + hop::a_off(row, 8 * j));
    }
    __syncthreads();   // the tile's buffers are free
  }
  // the chunk's partials
#pragma unroll
  for (int j = 0; j < 2; ++j)
    if (wg + 2 * j < NBX)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 64 * q + hop::acc_row(t128, i), c2 = 64 * (wg + 2 * j) + hop::acc_col(t128, i);
        if (c < C && c2 < C) a.ppf[(((size_t)chunk * 16 + s) * C + c) * C + c2] = pf[j][i];
      }
  aps = warp_sum(aps);   // the slope sum: warps in order
  if ((tid & 31) == 0) red[tid >> 5] = aps;
  __syncthreads();
  if (tid == 0) {
    float v = 0.f;
    for (int w = 0; w < kThr / 32; ++w) v += red[w];
    a.pap[((size_t)chunk * 16 + s) * NBX + q] = v;
  }
}

struct FoldArgs {
  const bf16* dout;
  const float* xb;
  float* pfold;   // [chunk][36][C][16 out]
  int B, H, W, C, out, tpc, ntiles;
};

// CTA (chunk, phase s, channel pair p * out + fold box qo): warpgroup wg
// owns channel box 2 p + wg (none past NBX).
template <int NBX>
__global__ void __launch_bounds__(kThr, 1)
    fold_kernel(const __grid_constant__ FoldArgs a, const __grid_constant__ CUtensorMap ma4,
                const __grid_constant__ CUtensorMap mwpf) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = align1k(smem_raw);
  const int chunk = blockIdx.x, s = blockIdx.y, pi = s >> 2, pj = s & 3;
  const int p = blockIdx.z / a.out, q = blockIdx.z % a.out;
  const int H = a.H, W = a.W, C = a.C, out = a.out, O = 16 * out;
  const int nu = kUn[pj], ncol = kUn[pi] * nu * O;   // the fold's columns: phase s's slots x O
  const int t0 = chunk * a.tpc, t1 = min(a.ntiles, t0 + a.tpc);
  if (64 * q >= ncol || t0 >= t1) return;
  const int nth = (H + kDxbT - 1) / kDxbT, ntw = (W + kDxbT - 1) / kDxbT;
  const int box = 2 * p + (threadIdx.x >> 7);   // this warpgroup's channel box
  const int npair = min(2, NBX - 2 * p), c0 = 128 * p, nc = min(128, C - c0);
  uint64_t* wbar = reinterpret_cast<uint64_t*>(base);
  uint64_t* abar = wbar + 1;   // [2]
  unsigned char* Wp = base + 1024;          // wpf's columns of the pair: box (kc, j) at 2 kc + j
  unsigned char* A = Wp + 2 * NBX * kBox;   // [2][NBX panels]: a's phase-s tile
  unsigned char* Y = A + 2 * NBX * kBox;    // y of the pair's boxes
  unsigned char* Dsh = Y + 2 * kBox;        // dout shifted by the slots of box qo
  float* Nb = reinterpret_cast<float*>(Dsh + kBox);   // the pair's xb neighbourhood
  const int tid = threadIdx.x, wg = tid >> 7, t128 = tid & 127;
  if (tid == 0) {
    hop::mbar_init(wbar, 1);
    hop::mbar_init(&abar[0], 1);
    hop::mbar_init(&abar[1], 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  auto tile_at = [&](int t, int& b, int& h0, int& w0) {
    b = t / (nth * ntw);
    h0 = kDxbT * ((t / ntw) % nth);
    w0 = kDxbT * (t % ntw);
  };
  auto issue = [&](int t, int buf) {
    int b, h0, w0;
    tile_at(t, b, h0, w0);
    hop::mbar_expect_tx(&abar[buf], (uint32_t)NBX * kBox);
    for (int cb = 0; cb < NBX; ++cb)
      tma_load4(A + (NBX * buf + cb) * kBox, &ma4, &abar[buf], s * C + 64 * cb, w0, h0, b);
  };
  if (tid == 0) {
    hop::mbar_expect_tx(wbar, (uint32_t)(NBX * npair * kBox));
    for (int kc = 0; kc < NBX; ++kc)
      for (int j = 0; j < npair; ++j)
        hop::tma_load(Wp + (2 * kc + j) * kBox, &mwpf, wbar, 64 * (2 * p + j), 64 * kc);
    issue(t0, 0);
  }
  float acc[32], fold[32];
  zero(fold);
  const int dcol = 64 * q + (tid & 7) * 8, dsi = min(dcol, ncol - 1) / O;
  const bool dcol_ok = dcol < ncol;
  const int do0 = dcol % O, ddh = kSlotOff[kUs[pi][dsi / nu]], ddw = kSlotOff[kUs[pj][dsi % nu]];
  for (int t = t0; t < t1; ++t) {
    const int it = t - t0, buf = it & 1;
    int b, h0, w0;
    tile_at(t, b, h0, w0);
    if (tid == 0 && t + 1 < t1) issue(t + 1, buf ^ 1);
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
    // xb's 9 x 9 neighbourhood for phase s, the pair's channels, edge-clamped
    const int rb0 = pi < 2 ? h0 - 1 : h0, cb0 = pj < 2 ? w0 - 1 : w0, n4 = nc / 4;
    stage<8, float4>(
        81 * n4,
        [&](int e) {
          const int px = e / n4, c4 = 4 * (e - px * n4);
          const int hh = min(max(rb0 + px / 9, 0), H - 1), ww = min(max(cb0 + px % 9, 0), W - 1);
          return __ldg(reinterpret_cast<const float4*>(
              a.xb + (((size_t)b * H + hh) * W + ww) * C + c0 + c4));
        },
        [&](int e, float4 v) {
          const int px = e / n4;
          *reinterpret_cast<float4*>(Nb + px * kPairPitch + 4 * (e - px * n4)) = v;
        });
    hop::fence_async_smem();
    hop::mbar_wait(wbar, 0);
    hop::mbar_wait(&abar[buf], (uint32_t)((it >> 1) & 1));
    __syncthreads();
    // y = round(a wpf + stencil_s(xb)) for this warpgroup's box (the H
    // taps, then the W taps: the forward's order)
    if (box < NBX) {
      const unsigned char* at = A + NBX * buf * kBox;
      zero(acc);
      hop::wg_fence();
      for (int kk = 0; kk < C; kk += 16)
        hop::wgmma64(acc, hop::a_desc(at, kk), hop::b_desc(Wp + (2 * (kk >> 6) + wg) * kBox, kk & 63),
                     1);
      hop::wg_commit();
      hop::wg_wait0();
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = hop::acc_row(t128, i), lc = 64 * wg + hop::acc_col(t128, i);
        const int ph = row >> 3, pw = row & 7;
        float y2[2] = {0.f, 0.f};
        if (h0 + ph < H && w0 + pw < W && c0 + lc < C) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float* nb = Nb + (ph * 9 + pw) * kPairPitch + lc + u;
            const float yl = kQ4[pi][0] * nb[0] + kQ4[pi][1] * nb[9 * kPairPitch];
            const float yr = kQ4[pi][0] * nb[kPairPitch] + kQ4[pi][1] * nb[10 * kPairPitch];
            y2[u] = acc[i + u] + (kQ4[pj][0] * yl + kQ4[pj][1] * yr);
          }
        }
        *reinterpret_cast<uint32_t*>(Y + hop::a_off(row, lc)) = pack_bf2(y2[0], y2[1]);
      }
    }
    hop::fence_async_smem();
    __syncthreads();
    if (box < NBX) {   // the fold: y^T dout_shifted for box qo's slot columns
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 64; kk += 16)
        hop::wgmma64_tt(fold, hop::b_desc(Y + wg * kBox, kk), hop::b_desc(Dsh, kk), 1);
      hop::wg_commit();
      hop::wg_wait0();
    }
    __syncthreads();   // the tile's buffers are free
  }
  if (box < NBX) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 64 * box + hop::acc_row(t128, i), col = 64 * q + hop::acc_col(t128, i);
      if (c < C && col < ncol) {
        const int si = col / O;
        const int slot = kUs[pi][si / nu] * 6 + kUs[pj][si % nu];
        a.pfold[(((size_t)chunk * 36 + slot) * C + c) * O + col % O] = fold[i];
      }
    }
  }
}

template <int NBX>
cudaError_t conv_bwd_wide(const Up4BwdArgs& a, const Up4Work& w, const Up4BwdPlan& pl,
                          cudaStream_t st, int* n) {
  static_assert(NBX >= 2 && NBX <= kWideMaxBoxes, "the wide form takes C from 65 to 192");
  const int M = a.B * a.H * a.W, C = a.C;
  CUtensorMap mx, mx4, mwb1, mwbf, mwpf, mwst, mwct, ma4;
  SUNET_TRY(hop::weight_map(&mx, a.x, M, C, 64));
  SUNET_TRY(tile_map(&mx4, a.x, a.B, a.H, a.W, C));
  SUNET_TRY(tile_map(&ma4, w.am, a.B, a.H, a.W, 16 * C));
  SUNET_TRY(hop::weight_map(&mwb1, a.wb1, C, C, 64));
  SUNET_TRY(hop::weight_map(&mwbf, a.wbf, C, C, 64));
  SUNET_TRY(hop::weight_map(&mwpf, a.wpf, C, C, 64));
  SUNET_TRY(hop::weight_map(&mwst, w.wst, 16 * C, C, 64));
  SUNET_TRY(hop::weight_map(&mwct, w.wct, 9 * a.out, C, pl.k16));
  {
    const PrepArgs p{a.dout, a.wexp, a.wconv, a.bb1, a.alphas, w.zb,  w.xb,       w.abv,
                     w.dxb,  w.wst,  w.wct,   a.B,   a.H,      a.W,   C,          a.out,
                     pl.ntiles, pl.ndxb};
    SUNET_TRY(hop::launch_cluster(prep_kernel<NBX>, dim3(pl.ntiles + pl.ndxb + kCopyCtas), kThr,
                                  prep_smem(C, a.out), st, 1, p, mx, mwb1, mwbf));
    SUNET_TRY(launched(n));
  }
  {
    const BoxArgs p{a.dout, a.alphas, w.dz, w.am, w.ppf, w.pap, a.B, a.H, a.W, C, a.out, pl.tpc,
                    pl.ptiles, pl.k16};
    SUNET_TRY(hop::launch_cluster(phase_box_kernel<NBX>, dim3(NBX, pl.nchunks, 16), kThr,
                                  box_smem(NBX), st, 1, p, mx4, mwst, mwpf, mwct));
    SUNET_TRY(launched(n));
  }
  {
    const FoldArgs p{a.dout, w.xb, w.pfold, a.B, a.H, a.W, C, a.out, pl.tpc, pl.ptiles};
    SUNET_TRY(hop::launch_cluster(fold_kernel<NBX>, dim3(pl.nchunks, 16, (NBX + 1) / 2 * a.out),
                                  kThr, fold_smem(NBX), st, 1, p, ma4, mwpf));
    SUNET_TRY(launched(n));
  }
  const Up4Tail t{a.x,    a.wb1,  a.wbf,  a.alphas, a.dx, a.dwexp, a.dalphas, a.dwb1,
                  a.dbb1, a.dwpf, a.dwbf, a.dwconv, a.B,  a.H,     a.W,       C,
                  a.out,  16 * pl.nchunks * NBX};
  return up4_bwd_tail<NBX>(t, w, pl, st, n);
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
// not this entry's; the launch count. C a multiple of 16 up to 192 (above
// 96 the wide form, six launches; kernels/upsample.py pads C=180 to 192),
// 1 <= out <= 8, any H and W.
extern "C" int sunet_up4_conv_bwd(const void* x, const void* dout, const void* wexp,
                                  const void* wb1, const void* bb1, const void* wpf,
                                  const void* wbf, const void* wconv, const void* alphas,
                                  void* dx, void* dwexp, void* dalphas, void* dwb1, void* dbb1,
                                  void* dwpf, void* dwbf, void* dwconv, void* work, int B, int H,
                                  int W, int C, int out, int tpc, int* launches, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 16 || C % 16 || C > 64 * u4::kWideMaxBoxes || out < 1 ||
      out > 8)
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
  if (C <= 96)
    return (int)(C <= 64 ? u4::conv_bwd<1>(a, w, pl, st, launches)
                         : u4::conv_bwd<2>(a, w, pl, st, launches));
  return (int)(C <= 128 ? u4::conv_bwd_wide<2>(a, w, pl, st, launches)
                        : u4::conv_bwd_wide<3>(a, w, pl, st, launches));
}
