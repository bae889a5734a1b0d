// Backward of the split x4 dual up-sample head.
//
// Replaces sunet_tf_tpu/kernels/upsample.py::_up4_bwd_impl (its kernel
// _up4_bwd_kernel), the backward of fused_dual_upsample4 (up4.cu, #10) behind
// dual_upsample4_trainable: from x (B, H, W, C), the pixel-space cotangent
// dout (B, 4H, 4W, C) and the head's weights it recomputes the subpixel
// pre-activations and returns dx, dW_exp (C, 16C), dW_b1, db_b1, dwpf, dwbf
// and the two PReLU-slope sums. The plain version is up4_bwd_reference in
// kernels/upsample.py; the rounding points are the JAX kernel's: dout
// rounded to bf16; dP = dout_s wpf^T rounded before the PReLU derivative;
// dz = round(prelu'(z) dP) for dW_exp and dx; the bilinear adjoint in fp32
// on the rounded dout, its result dxb rounded for dwbf and the 1x1 chain.
//
// What bounds it on Hopper: the products, 85 C^2 multiply-adds per low-res
// pixel (the expand recomputed, dP, dwpf, dx, dW_exp: five per subpixel,
// and five of the bilinear branch): 12.8 GFLOP at (64,64,96) batch 2, ~13
// us at the bf16 peak; and the bytes: dout is 16 M C (25 MB in bf16 at
// batch 2), and dz, the one 16-phase map through device memory, as large.
//
// Design: #9's five launches (up4_conv_bwd.cu) without the conv; launches
// 3-5 are up4_bwd.cuh's, shared with #9. Every product on hopper.cuh's
// wgmma, operands in shared memory in the 128-byte swizzled layout, weights
// and token tiles by TMA:
//   1. prep: three kinds of CTAs in one launch. 64-pixel strips: zb = x wb1
//      + bb1, abv = round(prelu(zb)). (8 x 8 pixel tile, 16 channels): dxb
//      = round(stencil^T(dout)) on CUDA cores from the pixel-space dout
//      staged with the clamped stencil's halo (40 x 40 pixels), the W axis
//      summed per staged row, then the H axis. A few CTAs lay w_exp out by
//      phase.
//   2. phase: CTA (column box q, chunk of 8 x 8 pixel tiles, phase s). Per
//      tile, the x tile and dout's phase-s tile (pixels (4h+i, 4w+j): a TMA
//      box with element strides 4 on both pixel axes, zero past the image)
//      arrive by TMA one tile ahead; warpgroup 0 computes z = x wexp_s and
//      warpgroup 1 dP = dout_s wpf^T for box q's 64 columns; a =
//      round(prelu(z)), dz = round(prelu'(z) round(dP)) (written, phase s at
//      columns s C + 64 q of an (M, 16 C) map); both warpgroups add dwpf's
//      rows of box q += a^T dout_s. dwpf and the slope sum stay in registers
//      over the chunk and leave as one partial per CTA; z, a and dP never
//      reach device memory. With one box per CTA the phase launch takes C up
//      to 256 within its shared memory.
//   3-5. pixel (dzb, dx), the weight gradients, the sums (up4_bwd.cuh).
// Bytes per launch at batch 2 (64,64,96): 1 reads x and dout (25 MB, the
// halo from L2), writes zb (3.1 MB), abv, dxb (1.6 MB each); 2 reads x and
// dout_s per column box (the second from L2), writes dz (25 MB); 3 reads dz,
// dxb, zb, writes dx, round(dzb); 4 reads x, dz, abv, dxb, round(dzb).
// Plans are functions of one image's shape (kernels/upsample.py::
// up4_bwd_plan mirrors up4_bwd_plan with out = 0); no sum uses atomics.
#include "up4_bwd.cuh"

namespace sunet {
namespace u4s {

using namespace u4;

// ---------------------------------------------------------------- launch 1

constexpr int kDxC = 16;                // channels of a CTA of the stencil adjoint
constexpr int kDxR = 4 * (kDxbT + 2);   // high-res rows (and columns) a tile's sources span
constexpr size_t kDxbBytes =
    (size_t)kDxR * kDxR * kDxC * 2 + (size_t)kDxR * kDxbT * kDxC * 4 + 2 * kDxbT * 12 * 4;

// Shared-memory bytes of the two launches of our own (kernels/upsample.py::
// up4_bwd_plan mirrors them).
inline size_t prep_smem(int nbx) { return 1024 + std::max(strip_smem(nbx, false), kDxbBytes); }
inline size_t phase_smem(int nbx) { return 2048 + (size_t)(6 * nbx + 3) * kBox; }

// (8 x 8 tile, kDxC channels from c0): dxb = round(stencil^T(dout)).
// Target t of an axis receives from the high-res indices P = 4 (t - 1) +
// k, k < 12, with weight tap_coef(P, t); D holds dout over the tile's 40 x
// 40 high-res sources, R the W axis summed per high-res row, then the H
// axis gives dxb.
__device__ inline void prep_dxb(const PrepArgs& a, unsigned char* base, int cta) {
  const int H = a.H, W = a.W, C = a.C, tid = threadIdx.x;
  const int nth = (H + kDxbT - 1) / kDxbT, ntw = (W + kDxbT - 1) / kDxbT;
  const int tile = cta / (C / kDxC), c0 = (cta % (C / kDxC)) * kDxC;
  const int b = tile / (nth * ntw), rem = tile % (nth * ntw);
  const int th0 = (rem / ntw) * kDxbT, tw0 = (rem % ntw) * kDxbT;
  const int Y0 = 4 * (th0 - 1), X0 = 4 * (tw0 - 1);   // D's first high-res row and column
  bf16* D = reinterpret_cast<bf16*>(base);            // [40][40][kDxC]
  float* R = reinterpret_cast<float*>(D + kDxR * kDxR * kDxC);   // [40][8][kDxC]
  float* cw = R + kDxR * kDxbT * kDxC;                // [8][12]: W-axis weights of target tw0 + p
  float* ch = cw + kDxbT * 12;                        // [8][12]: H axis
  if (tid < 2 * kDxbT * 12) {
    const bool w_axis = tid < kDxbT * 12;
    const int i = tid % (kDxbT * 12), p = i / 12, k = i % 12, n = w_axis ? W : H;
    const int t = (w_axis ? tw0 : th0) + p, P = 4 * (t - 1) + k;
    (w_axis ? cw : ch)[i] = t < n && P >= 0 && (P >> 2) < n ? tap_coef(P, t, n) : 0.f;
  }
  stage<7, uint4>(
      kDxR * kDxR * 2,
      [&](int e) {
        const int px = e >> 1, Y = Y0 + px / kDxR, X = X0 + px % kDxR;
        const bool ok = Y >= 0 && Y < 4 * H && X >= 0 && X < 4 * W;
        const bf16* src =
            ok ? a.dout + (((size_t)b * 4 * H + Y) * 4 * W + X) * C + c0 + 8 * (e & 1) : a.dout;
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
        return ok ? v : make_uint4(0u, 0u, 0u, 0u);
      },
      [&](int e, uint4 v) { *reinterpret_cast<uint4*>(D + (e >> 1) * kDxC + 8 * (e & 1)) = v; });
  __syncthreads();   // D and the weights
  for (int i = tid; i < kDxR * kDxbT * kDxC; i += kThr) {
    const int c = i % kDxC, p = (i / kDxC) % kDxbT, r = i / (kDxbT * kDxC);
    const bf16* d = D + (r * kDxR + 4 * p) * kDxC + c;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 12; ++k) s += cw[p * 12 + k] * bf(d[k * kDxC]);
    R[i] = s;
  }
  __syncthreads();
  for (int i = tid; i < kDxbT * kDxbT * kDxC; i += kThr) {
    const int c = i % kDxC, px = i / kDxC, ph = px / kDxbT, pw = px % kDxbT;
    const int h = th0 + ph, w = tw0 + pw;
    if (h >= H || w >= W) continue;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 12; ++k) s += ch[ph * 12 + k] * R[((4 * ph + k) * kDxbT + pw) * kDxC + c];
    a.dxb[(((size_t)b * H + h) * W + w) * C + c0 + c] = tobf(s);
  }
}

template <int NBX>
__global__ void __launch_bounds__(kThr, 1)
    prep_kernel(const __grid_constant__ PrepArgs a, const __grid_constant__ CUtensorMap mx,
                const __grid_constant__ CUtensorMap mwb1) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = align1k(smem_raw);
  const int bid = blockIdx.x;
  if (bid < a.nstrips) prep_strip<NBX, false>(a, &mx, &mwb1, nullptr, base, bid);
  else if (bid < a.nstrips + a.ndxb) prep_dxb(a, base, bid - a.nstrips);
  else prep_copy(a, bid - a.nstrips - a.ndxb);
}

// ---------------------------------------------------------------- launch 2

// A measurement build (-DSUNET_PHASE_CLOCK, sunet_tf_tpu_torch/tools/
// block_phases.py --kernel up4_bwd) adds thread 0's SM clock cycles per
// phase of the phase launch (kPhPhases: setup, the wait for the tiles, z
// beside dP, dz beside dwpf, the dz store, the partials) over the CTA's
// tiles into the buffer given to sunet_up4_bwd_phase_clock, kPhPhases
// values per CTA in launch order (x fastest).
constexpr int kPhPhases = 6;
#ifdef SUNET_PHASE_CLOCK
__device__ long long* g_phase_clock;
#endif

struct PhaseArgs {
  const float* alphas;
  bf16* dz;            // (M, 16C): phase s at columns s * C
  float *ppf, *pap;    // [chunk][16][C][C], [chunk][16][NBX]
  int B, H, W, C, tpc, ntiles;
};

// CTA (column box q, chunk of 8 x 8 pixel tiles, phase s); a tile's 64
// rows are its pixels (h0 + r / 8, w0 + r % 8), those off the image zero.
template <int NBX>
__global__ void __launch_bounds__(kThr, 1)
    phase_kernel(const __grid_constant__ PhaseArgs a, const __grid_constant__ CUtensorMap mx,
                 const __grid_constant__ CUtensorMap mdo, const __grid_constant__ CUtensorMap mwst,
                 const __grid_constant__ CUtensorMap mwpf) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = align1k(smem_raw);
  const int q = blockIdx.x, chunk = blockIdx.y, s = blockIdx.z, pi = s >> 2, pj = s & 3;
  const int H = a.H, W = a.W, C = a.C;
  const int t0 = chunk * a.tpc, t1 = min(a.ntiles, t0 + a.tpc);
  if (t0 >= t1) return;
  const int nth = (H + kDxbT - 1) / kDxbT, ntw = (W + kDxbT - 1) / kDxbT;
  uint64_t* wbar = reinterpret_cast<uint64_t*>(base);
  uint64_t* tbar = wbar + 1;   // [2]
  float* red = reinterpret_cast<float*>(base + 64);
  unsigned char* Wx = base + 1024;          // wexp_s, column box q: NBX boxes of K
  unsigned char* Wp = Wx + NBX * kBox;      // wpf, row box q: NBX boxes of K
  unsigned char* X = Wp + NBX * kBox;       // [2][NBX panels]: the x tile
  unsigned char* D = X + 2 * NBX * kBox;    // [2][NBX panels]: dout's phase-s tile
  unsigned char* Aa = D + 2 * NBX * kBox;   // a = round(prelu(z)), box q
  unsigned char* Dst = Aa + kBox;           // dz staged (64 x 64, Aa's swizzled layout)
  bf16* Dp = reinterpret_cast<bf16*>(Dst + kBox);   // round(dP) in accumulator order
  const int tid = threadIdx.x, wg = tid >> 7, t128 = tid & 127;
#ifdef SUNET_PHASE_CLOCK
  long long clk = clock64();
#endif
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
    hop::mbar_expect_tx(&tbar[buf], (uint32_t)2 * NBX * kBox);
    for (int cb = 0; cb < NBX; ++cb) {
      tma_load4(X + (NBX * buf + cb) * kBox, &mx, &tbar[buf], 64 * cb, w0, h0, b);
      tma_load4(D + (NBX * buf + cb) * kBox, &mdo, &tbar[buf], 64 * cb, 4 * w0 + pj, 4 * h0 + pi,
                b);
    }
  };
  if (tid == 0) {
    hop::mbar_expect_tx(wbar, (uint32_t)2 * NBX * kBox);
    for (int kc = 0; kc < NBX; ++kc) {
      hop::tma_load(Wx + kc * kBox, &mwst, wbar, 64 * q, s * C + 64 * kc);
      hop::tma_load(Wp + kc * kBox, &mwpf, wbar, 64 * kc, 64 * q);
    }
    issue(t0, 0);
  }
  float acc[32], pf[2][32];
  zero(pf[0]);
  zero(pf[1]);
  float aps = 0.f;
  hop::mbar_wait(wbar, 0);
  PH_PHASE(0);
  for (int t = t0; t < t1; ++t) {
    const int it = t - t0, buf = it & 1;
    int b, h0, w0;
    tile_at(t, b, h0, w0);
    if (tid == 0 && t + 1 < t1) issue(t + 1, buf ^ 1);
    const unsigned char* x = X + NBX * buf * kBox;
    const unsigned char* d = D + NBX * buf * kBox;
    hop::mbar_wait(&tbar[buf], (uint32_t)((it >> 1) & 1));
    PH_PHASE(1);
    // warpgroup 0: z = x wexp_s; warpgroup 1: dP = dout_s wpf^T (box q)
    zero(acc);
    hop::wg_fence();
    if (wg == 0) {
      for (int kk = 0; kk < C; kk += 16)
        hop::wgmma64(acc, hop::a_desc(x, kk), hop::b_desc(Wx + (kk >> 6) * kBox, kk & 63), 1);
    } else {
      for (int kk = 0; kk < C; kk += 16)
        hop::wgmma64_kmajor(acc, hop::a_desc(d, kk), hop::a_desc(Wp + (kk >> 6) * kBox, kk & 63),
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
      for (int i = 0; i < 32; ++i) Dp[i * 128 + t128] = tobf(acc[i]);
    }
    hop::fence_async_smem();
    __syncthreads();
    PH_PHASE(2);
    // dwpf's rows of box q += a^T dout_s (warpgroup wg: dout's boxes wg,
    // wg + 2) while warpgroup 0 forms dz = round(prelu'(z) round(dP))
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (wg + 2 * j < NBX)
          hop::wgmma64_tt(pf[j], hop::b_desc(Aa, kk), hop::b_desc(d + (wg + 2 * j) * kBox, kk), 1);
    hop::wg_commit();
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = hop::acc_row(t128, i), col = hop::acc_col(t128, i);
        const float d0 = bf(Dp[i * 128 + t128]), d1 = bf(Dp[(i + 1) * 128 + t128]);
        *reinterpret_cast<uint32_t*>(Dst + hop::a_off(row, col)) =
            pack_bf2(acc[i] > 0.f ? d0 : ap * d0, acc[i + 1] > 0.f ? d1 : ap * d1);
        aps += fminf(acc[i], 0.f) * d0;
        aps += fminf(acc[i + 1], 0.f) * d1;
      }
    }
    hop::wg_wait0();
    __syncthreads();
    PH_PHASE(3);
    for (int e = tid; e < 64 * 8; e += kThr) {   // dz: 8 columns a store
      const int row = e >> 3, j = e & 7, h = h0 + (row >> 3), w = w0 + (row & 7);
      const int col = 64 * q + 8 * j;
      if (h < H && w < W && col < C)
        *reinterpret_cast<uint4*>(a.dz + (((size_t)b * H + h) * W + w) * 16 * C + s * C + col) =
            *reinterpret_cast<const uint4*>(Dst + hop::a_off(row, 8 * j));
    }
    __syncthreads();   // the tile's buffers are free
    PH_PHASE(4);
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
  PH_PHASE(5);
}

// ---------------------------------------------------------------- the sequence

struct Args {
  const bf16 *x, *dout, *wexp, *wb1;
  const float* bb1;
  const bf16 *wpf, *wbf;
  const float* alphas;
  bf16* dx;
  float *dwexp, *dalphas, *dwb1, *dbb1, *dwpf, *dwbf;
  int B, H, W, C;
};

template <int NBX>
cudaError_t split_bwd(const Args& a, const Up4Work& w, const Up4BwdPlan& pl, cudaStream_t st,
                      int* n) {
  const int M = a.B * a.H * a.W, C = a.C;
  CUtensorMap mx, mx4, mdo, mwb1, mwpf, mwst;
  SUNET_TRY(hop::weight_map(&mx, a.x, M, C, 64));
  SUNET_TRY(tile_map(&mx4, a.x, a.B, a.H, a.W, C));
  SUNET_TRY(tile_map(&mdo, a.dout, a.B, 4 * a.H, 4 * a.W, C, 4));
  SUNET_TRY(hop::weight_map(&mwb1, a.wb1, C, C, 64));
  SUNET_TRY(hop::weight_map(&mwpf, a.wpf, C, C, 64));
  SUNET_TRY(hop::weight_map(&mwst, w.wst, 16 * C, C, 64));
  {
    const int ndxb = pl.ndxb * (C / kDxC);   // (tile, channel chunk) CTAs
    const PrepArgs p{a.dout, a.wexp, nullptr, a.bb1,    a.alphas, w.zb, nullptr, w.abv, w.dxb,
                     w.wst,  nullptr, a.B,    a.H,      a.W,      C,    0,       pl.ntiles,
                     ndxb};
    SUNET_TRY(hop::launch_cluster(prep_kernel<NBX>, dim3(pl.ntiles + ndxb + kCopyCtas), kThr,
                                  prep_smem(NBX), st, 1, p, mx, mwb1));
    SUNET_TRY(launched(n));
  }
  {
    const PhaseArgs p{a.alphas, w.dz, w.ppf, w.pap, a.B, a.H, a.W, C, pl.tpc, pl.ptiles};
    SUNET_TRY(hop::launch_cluster(phase_kernel<NBX>, dim3(NBX, pl.nchunks, 16), kThr,
                                  phase_smem(NBX), st, 1, p, mx4, mdo, mwst, mwpf));
    SUNET_TRY(launched(n));
  }
  const Up4Tail t{a.x,    a.wb1,  a.wbf,  a.alphas, a.dx, a.dwexp, a.dalphas, a.dwb1,
                  a.dbb1, a.dwpf, a.dwbf, nullptr,  a.B,  a.H,     a.W,       C,
                  0,      16 * pl.nchunks * NBX};
  return up4_bwd_tail<NBX>(t, w, pl, st, n);
}

}  // namespace u4s
}  // namespace sunet

using namespace sunet;

#ifdef SUNET_PHASE_CLOCK
// The measurement build's per-phase cycle buffer (see kPhPhases); NULL stops
// recording.
extern "C" int sunet_up4_bwd_phase_clock(void* buf) {
  return (int)cudaMemcpyToSymbol(u4s::g_phase_clock, &buf, sizeof(buf));
}
#endif

extern "C" size_t sunet_up4_bwd_workspace(int B, int H, int W, int C) {
  return u4::carve_up4(nullptr, u4::up4_bwd_plan(B, H, W, C, 0), B * H * W, C, 0).bytes;
}

// x, dout (B, 4H, 4W, C), w_exp (C, 16C), wb1, bb1, wpf, wbf, alphas; dx
// and the grads (dw_exp (C, 16C), dalphas (2), dwb1, dbb1, dwpf, dwbf); the
// workspace; the shape; tpc, the plan's tiles per chunk of the phase launch
// (up4_bwd_plan), refused if it is not this entry's; the launch count. C a
// multiple of 16 up to 256, any H and W.
extern "C" int sunet_up4_bwd(const void* x, const void* dout, const void* wexp, const void* wb1,
                             const void* bb1, const void* wpf, const void* wbf,
                             const void* alphas, void* dx, void* dwexp, void* dalphas,
                             void* dwb1, void* dbb1, void* dwpf, void* dwbf, void* work, int B,
                             int H, int W, int C, int tpc, int* launches, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 16 || C % 16 || C > 256) return (int)cudaErrorInvalidValue;
  const u4::Up4BwdPlan pl = u4::up4_bwd_plan(B, H, W, C, 0);
  if (tpc != pl.tpc) return (int)cudaErrorInvalidValue;
  const u4s::Args a{(const bf16*)x,   (const bf16*)dout, (const bf16*)wexp, (const bf16*)wb1,
                    (const float*)bb1, (const bf16*)wpf, (const bf16*)wbf,  (const float*)alphas,
                    (bf16*)dx,        (float*)dwexp,     (float*)dalphas,   (float*)dwb1,
                    (float*)dbb1,     (float*)dwpf,      (float*)dwbf,      B,
                    H,                W,                 C};
  const u4::Up4Work w = u4::carve_up4((unsigned char*)work, pl, B * H * W, C, 0);
  *launches = 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (u4::nboxes(C)) {
    case 1: return (int)u4s::split_bwd<1>(a, w, pl, st, launches);
    case 2: return (int)u4s::split_bwd<2>(a, w, pl, st, launches);
    case 3: return (int)u4s::split_bwd<3>(a, w, pl, st, launches);
    default: return (int)u4s::split_bwd<4>(a, w, pl, st, launches);
  }
}
