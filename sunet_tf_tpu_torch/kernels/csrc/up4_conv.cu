// x4 dual up-sample head + 3x3 output conv, in phase space.
//
// Replaces sunet_tf_tpu/kernels/upsample.py::fused_dual_upsample4_conv_phase:
// from x (B, H, W, C) it writes (B, H, W, 16*out), channel (i*4+j)*out + o at
// base (h, w) being the output conv at pixel (4h+i, 4w+j). Pixel-shuffle
// branch: per subpixel s, z = round(prelu(x @ wexp[s])), then z @ wpf.
// Bilinear branch: xb = round(prelu(x @ wb1 + bb1)) @ wbf at low res, kept in
// fp32, then the separable half-pixel x4 stencil with EDGE-CLAMPED taps (+-1
// low-res pixel). Phase map = round(sum). The 3x3 bias-free conv then reads
// +-1 output pixel with ZERO padding at the image edge, sums in fp32 and
// rounds once. The two edge rules differ.
//
// What bounds it on Hopper: the head is 34 C x C products per low-res pixel
// and the conv 144 C*out multiply-adds: 10.7 GFLOP at batch 4, 64x64, C=96,
// out 1 (11 us at the bf16 peak) against 3 MB of input and 0.5 MB of output:
// the operations. The 4x map it implies (50 MB of bf16 at batch 4) is never
// written. The per-CTA chain of products and epilogues (latency), not the
// tensor cores, is what this design is bound by in practice.
//
// Design (hopper.cuh's TMA ring + wgmma mainloop, 1 or 2 warpgroups per CTA,
// each with its own tile; the plan, kernels/upsample.py::up4_plan, picks 2
// where both fit in shared memory):
// - A tile is 6 x 8 low-res pixels. Its 48 pixels and the 15 halo pixels
//   that one subpixel's conv taps read (one halo row of 8, one halo column
//   of 6, a corner) fit one 64-row wgmma tile: a subpixel s = (i, j) takes
//   the top halo row where i = 3 and the bottom one where i = 0, the left
//   column where j = 3 and the right one where j = 0, and the corner where
//   both hold (halo_src). No halo phase the conv does not read is computed.
// - The weights (wb1, wbf, then wexp[s] and wpf for each s) stream once per
//   CTA through a ring of kRingS TMA slots in 64-column boxes, shared by the
//   CTA's warpgroups; the conv's weights sit in shared memory, K-major.
// - The bilinear branch runs first, on two 64-row tiles (the 48 pixels, the
//   32 halo pixels), into xb over the tile's 1-pixel halo region (fp32):
//   every stencil tap of a phase the conv reads lies there.
// - Per subpixel s: x rows @ wexp[s] -> PReLU -> round into the swizzled A
//   operand; @ wpf; + the stencil -> round: the phase map Y_s; then Y_s @
//   Wc (N = 9*out, each tap's out columns) on wgmma m64n16 (K-major B), and
//   each (row, tap) sum is added in fp32 to the output it feeds in the
//   tile's 48 x 16 x out accumulator. Within one s each output takes at
//   most one term, and the s run in order: a fixed summation order.
// - Pixel coordinates of x are clamped into the image (the bilinear rule);
//   a phase-map row outside the image feeds nothing (the conv's zero pad);
//   outputs outside the image are not written.
// Grid: ceil(tiles / T) CTAs of T warpgroups (T from the plan); at batch 4,
// (64,64,96), out 1: 352 tiles on 176 CTAs of two warpgroups.
// C not a multiple of 16 (the scaled config's 180): every product and
// shared-memory layout runs over Cp = C rounded up to 16 (192, three
// 64-column boxes); the caller pads the weights with zeros to Cp (wexp (16,
// Cp, Cp), wb1, wpf, wbf (Cp, Cp), bb1 (Cp)), x's rows (C values) load in
// 8-byte chunks with zeros past C, so every pad column stays zero.
#include "hopper.cuh"
#include "up4_common.cuh"

namespace sunet {
namespace up4c {

using hop::a_bytes;
using hop::a_off;
using hop::align1024;

constexpr int kTH = 6, kTW = 8;                   // low-res tile
constexpr int kIn = kTH * kTW;                    // its pixels: rows 0..47 of a shuffle tile
constexpr int kR1W = kTW + 2, kR1 = (kTH + 2) * kR1W;   // the 1-pixel halo region (xb)
constexpr int kPool = 2 * kTW + 2 * kTH + 4;      // halo pixels
constexpr int kRingS = 3;                         // slots of the weight ring
constexpr int kRingSlot = 12288;                  // bytes of a slot
constexpr int kProducts = 4 + 2 * 16;             // (wb1, wbf) x 2 tiles, (wexp[s], wpf) x 16
constexpr int kHeader = 2048;                     // barriers, product table
static_assert(64 + kProducts * sizeof(hop::Product) <= kHeader, "header");

// Halo pixel p (0 .. kPool-1) in tile coordinates: the top row (y = -1),
// the bottom row (y = kTH), the left column (x = -1), the right column (x =
// kTW), then the corners TL, TR, BL, BR.
__host__ __device__ inline void pool_pixel(int p, int& y, int& x) {
  if (p < kTW) {
    y = -1, x = p;
  } else if (p < 2 * kTW) {
    y = kTH, x = p - kTW;
  } else if (p < 2 * kTW + kTH) {
    y = p - 2 * kTW, x = -1;
  } else if (p < 2 * kTW + 2 * kTH) {
    y = p - 2 * kTW - kTH, x = kTW;
  } else {
    const int c = p - 2 * kTW - 2 * kTH;
    y = c < 2 ? -1 : kTH, x = (c & 1) ? kTW : -1;
  }
}

// The halo pixel that row r (kIn .. 63) of subpixel (i, j)'s tile holds,
// -1 for none: the phases of the halo that the 3x3 conv reads.
__host__ __device__ inline int halo_src(int i, int j, int r) {
  const int q = r - kIn;
  if (q < kTW) return i == 3 ? q : (i == 0 ? kTW + q : -1);   // top / bottom row
  if (q < kTW + kTH)                                           // left / right column
    return j == 3 ? 2 * kTW + q - kTW : (j == 0 ? 2 * kTW + kTH + q - kTW : -1);
  if (q == kTW + kTH && (i == 3 || i == 0) && (j == 3 || j == 0))   // a corner
    return 2 * kTW + 2 * kTH + (i == 0) * 2 + (j == 0);
  return -1;
}

// The pixel (tile coordinates) of row r of subpixel (i, j)'s tile.
__device__ inline bool row_pixel(int i, int j, int r, int& y, int& x) {
  if (r < kIn) {
    y = r / kTW, x = r % kTW;
    return true;
  }
  const int p = halo_src(i, j, r);
  if (p < 0) return false;
  pool_pixel(p, y, x);
  return true;
}

// Rows of the conv's weights, K-major: N = 9 * out rounded up to 16.
__host__ __device__ inline int conv_rows(int out) { return (9 * out + 15) / 16 * 16; }

__host__ __device__ inline size_t wc_bytes(int C, int out) {
  return (size_t)(C + 63) / 64 * conv_rows(out) * 128;
}

// One warpgroup's tile: x rows (tile, halo), z / Y, xb, the output sums.
__host__ __device__ inline size_t xb_bytes(int C) {
  return align1024((size_t)kR1 * (C + kPadF) * 4);
}
__host__ __device__ inline size_t wg_bytes(int C, int out) {
  return 3 * a_bytes(C) + xb_bytes(C) + align1024((size_t)kIn * 16 * out * 4);
}

// Dynamic shared memory of a CTA of T warpgroups (kernels/upsample.py::
// up4_smem mirrors it): slack, header, ring, conv weights, the tiles.
__host__ __device__ inline size_t smem_bytes(int C, int out, int T) {
  return 1024 + kHeader + (size_t)kRingS * kRingSlot + wc_bytes(C, out) + T * wg_bytes(C, out);
}

// Offset of element (r, k) of a K-major operand of `rows` rows (a multiple
// of 8) in the 128-byte swizzled layout: 64-column panels of rows * 128 B.
__device__ inline uint32_t kmaj_off(int r, int k, int rows) {
  return (uint32_t)((k >> 6) * rows * 128 + (r >> 3) * 1024 + (r & 7) * 128 +
                    ((((k >> 3) & 7) ^ (r & 7)) << 4) + (k & 7) * 2);
}

// A measurement build (-DSUNET_PHASE_CLOCK, sunet_tf_tpu_torch/tools/
// block_phases.py --kernel up4) adds thread t == 0 of every warpgroup's SM
// clock cycles per phase (kUpPhases: setup, bilinear, halo rows + x @
// wexp[s], its epilogue, @ wpf, the stencil epilogue, the conv terms, the
// output) into the buffer given to sunet_up4_conv_phase_clock, kUpPhases
// values per warpgroup in (blockIdx.x, warpgroup) order.
constexpr int kUpPhases = 8;
#ifdef SUNET_PHASE_CLOCK
__device__ long long* g_up4_clock;
#define UP4_PHASE(k)                                                                 \
  do {                                                                               \
    if (t == 0 && g_up4_clock) {                                                     \
      const long long now = clock64();                                               \
      g_up4_clock[((size_t)blockIdx.x * a.T + wg) * kUpPhases + (k)] += now - clk;   \
      clk = now;                                                                     \
    }                                                                                \
  } while (0)
#else
#define UP4_PHASE(k) \
  do {               \
  } while (0)
#endif

struct Args {
  const bf16* x;        // (B, H, W, Cx)
  bf16* dst;            // (B, H, W, 16*out)
  const float* bb1;     // (C,)
  const bf16* wconv;    // (3, 3, Cx, out)
  const float* alphas;  // (alpha_p, alpha_b)
  int B, H, W, C, out;  // C: the padded width Cp
  int nty, ntx, ntiles, T;
  int Cx;               // x's channels
};

struct Maps {
  CUtensorMap wexp, wb1, wpf, wbf;   // wexp: (16C, C), s-major; the others (C, C)
};

// The conv terms of subpixel (pi, pj)'s phase map Y (64 x C, K-major):
// D (64 x 16*NT) = Y @ the conv weights (C x 16*NT, row n = tap * out + o),
// then each term of a row h whose pixel (py, px) lies in the image (has)
// is added to the output it feeds: phase (pi - dy, pj - dx) of the pixel
// that tap (dy, dx) reaches from this one, where it lies in the tile.
// inv_out = ceil(2^16 / out): (col * inv_out) >> 16 = col / out for col <
// 80.
template <int NT>
__device__ inline void conv_terms(const unsigned char* y, const unsigned char* wc, int C, int out,
                                  int inv_out, int pi, int pj, int t, const bool (&has)[2],
                                  const int (&py)[2], const int (&px)[2], float* acc) {
  float d[NT][8];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 8; ++i) d[nt][i] = 0.f;
  const uint32_t wb = hop::smem_u32(wc);
  hop::wg_fence();
  for (int k0 = 0; k0 < C; k0 += 16) {
    const uint64_t ad = hop::a_desc(y, k0);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      hop::wgmma16_kmajor(
          d[nt], ad,
          hop::make_desc(wb + (uint32_t)(k0 >> 6) * (NT * 16 * 128) + nt * 2048 + (k0 & 63) * 2,
                         16, 1024, 1),
          1);
  }
  hop::wg_commit();
  hop::wg_wait0();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!has[h]) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (((i >> 1) & 1) != h) continue;
        const int col = nt * 16 + hop::acc_col(t, i);
        if (col >= 9 * out) continue;
        const int tap = (col * inv_out) >> 16, o = col - tap * out;
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
        int ti = pi - dy, oy = py[h], tj = pj - dx, ox = px[h];
        if (ti < 0) ti += 4, oy -= 1;
        if (ti > 3) ti -= 4, oy += 1;
        if (tj < 0) tj += 4, ox -= 1;
        if (tj > 3) tj -= 4, ox += 1;
        if (oy < 0 || oy >= kTH || ox < 0 || ox >= kTW) continue;
        acc[((oy * kTW + ox) * 16 + ti * 4 + tj) * out + o] += d[nt][i];
      }
  }
}

__device__ inline uint32_t pack2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(tobf(lo)) |
         ((uint32_t)__bfloat16_as_ushort(tobf(hi)) << 16);
}

template <int MJ>
__global__ void __launch_bounds__(256, 1)
    up4_conv_kernel(const __grid_constant__ Args a, const __grid_constant__ Maps maps) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, nthreads = 128 * a.T;
#ifdef SUNET_PHASE_CLOCK
  long long clk = clock64();
#endif
  const int C = a.C, Cx = a.Cx, out = a.out, H = a.H, W = a.W, ldb = C + kPadF;
  const int Nc = conv_rows(out);
  const int inv_out = ((1 << 16) + out - 1) / out;
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + kRingS;
  hop::Product* prod = reinterpret_cast<hop::Product*>(base + 64);
  unsigned char* slots = base + kHeader;
  unsigned char* wc = slots + (size_t)kRingS * kRingSlot;
  unsigned char* xa = wc + wc_bytes(C, out) + wg * wg_bytes(C, out);
  unsigned char* xh = xa + a_bytes(C);
  unsigned char* z = xh + a_bytes(C);
  float* xb = reinterpret_cast<float*>(z + a_bytes(C));
  float* acc = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(xb) + xb_bytes(C));

  if (tid == 0) {
    for (int s = 0; s < kRingS; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], nthreads);
    }
    hop::mbar_fence_init();
    const int nb = hop::nboxes(C), bk = hop::chunk_rows(kRingSlot, nb, C);
    for (int p = 0; p < 4; ++p) prod[p] = {p % 2 ? &maps.wbf : &maps.wb1, 0, nb, 0, nb, 0, C, bk};
    for (int s = 0; s < 16; ++s) {
      prod[4 + 2 * s] = {&maps.wexp, 0, nb, 0, nb, s * C, C, bk};
      prod[5 + 2 * s] = {&maps.wpf, 0, nb, 0, nb, 0, C, bk};
    }
  }
  // the conv's weights, K-major: row n = tap * out + o, column c
  const int kc = (C + 63) / 64 * 64;
  for (int e = tid; e < Nc * kc; e += nthreads) {
    const int n = e / kc, k = e % kc;
    const bf16 v = n < 9 * out && k < Cx ? a.wconv[((n / out) * Cx + k) * out + n % out]
                                         : tobf(0.f);
    *reinterpret_cast<bf16*>(wc + kmaj_off(n, k, Nc)) = v;
  }
  // this warpgroup's tile (a warpgroup past the last tile repeats it and
  // writes nothing)
  const int tile = blockIdx.x * a.T + wg;
  const bool live = tile < a.ntiles;
  const int tl = live ? tile : a.ntiles - 1;
  const int b = tl / (a.nty * a.ntx);
  const int ty0 = (tl / a.ntx) % a.nty * kTH, tx0 = tl % a.ntx * kTW;
  // x rows, pixel coordinates clamped into the image: xa = the tile's
  // pixels (rows kIn.. take each subpixel's halo later), xh = the halo;
  // columns at or past Cx are zeros
  const int c8n = C / 8;
  auto ldx = [&](int y, int x, int c) {
    const int gy = min(max(ty0 + y, 0), H - 1), gx = min(max(tx0 + x, 0), W - 1);
    const bf16* p = a.x + (((size_t)b * H + gy) * W + gx) * Cx + c;
    if (Cx % 8 == 0)
      return c < Cx ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
    const uint2 lo = c < Cx ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0u, 0u);
    const uint2 hi = c + 4 < Cx ? __ldg(reinterpret_cast<const uint2*>(p + 4)) : make_uint2(0u, 0u);
    return make_uint4(lo.x, lo.y, hi.x, hi.y);
  };
  for (int e = t; e < 64 * c8n; e += 128) {
    const int r = e / c8n, c = (e % c8n) * 8;
    uint4 va = make_uint4(0u, 0u, 0u, 0u), vh = va;
    if (r < kIn) va = ldx(r / kTW, r % kTW, c);
    if (r < kPool) {
      int y, x;
      pool_pixel(r, y, x);
      vh = ldx(y, x, c);
    }
    *reinterpret_cast<uint4*>(xa + a_off(r, c)) = va;
    *reinterpret_cast<uint4*>(xh + a_off(r, c)) = vh;
  }
  for (int e = t; e < kIn * 16 * out; e += 128) acc[e] = 0.f;
  hop::fence_async_smem();
  __syncthreads();

  hop::Ring ring{full, empty, slots, kRingS, (uint32_t)kRingSlot, prod, kProducts, 0, 0, 0, 0};
  const bool producer = tid == 0;
  if (producer) ring.produce(kRingS);
  UP4_PHASE(0);
  const int bar = 1 + wg;
  // this thread's two accumulator rows
  const int rows[2] = {hop::acc_row(t, 0), hop::acc_row(t, 2)};
  const float ap = a.alphas[0], ab = a.alphas[1];
  float d[MJ][32];

  // ---- bilinear branch: xb = round(prelu(x @ wb1 + bb1)) @ wbf over the
  // halo region, fp32; tile 0 = the pixels, tile 1 = the halo
  for (int pass = 0; pass < 2; ++pass) {
    hop::run_product<MJ>(ring, prod[2 * pass], pass ? xh : xa, d, 0, 1, producer);
#pragma unroll
    for (int jj = 0; jj < MJ; ++jj)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = hop::acc_row(t, i), col = jj * 64 + hop::acc_col(t, i);
        if (col < C)
          *reinterpret_cast<uint32_t*>(z + a_off(row, col)) =
              pack2(prelu(d[jj][i] + a.bb1[col], ab), prelu(d[jj][i + 1] + a.bb1[col + 1], ab));
      }
    hop::fence_async_smem();
    hop::bar_sync(bar, 128);
    hop::run_product<MJ>(ring, prod[2 * pass + 1], z, d, 0, 1, producer);
    int off[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int y = 0, x = 0;
      const bool ok = pass ? rows[h] < kPool : rows[h] < kIn;
      if (ok && pass) pool_pixel(rows[h], y, x);
      if (ok && !pass) y = rows[h] / kTW, x = rows[h] % kTW;
      off[h] = ok ? ((y + 1) * kR1W + x + 1) * ldb : -1;
    }
#pragma unroll
    for (int jj = 0; jj < MJ; ++jj)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1, col = jj * 64 + hop::acc_col(t, i);
        if (off[h] >= 0 && col < C) xb[off[h] + col] = d[jj][i];
      }
    hop::bar_sync(bar, 128);
  }
  UP4_PHASE(1);

  // ---- per subpixel: the phase map over the tile and the halo pixels the
  // conv reads, then its conv terms
  for (int s = 0; s < 16; ++s) {
    const int pi = s >> 2, pj = s & 3;
    // rows kIn.. of xa: this subpixel's halo pixels
    for (int e = t; e < (64 - kIn) * c8n; e += 128) {
      const int r = kIn + e / c8n, c = (e % c8n) * 8;
      const int p = halo_src(pi, pj, r);
      if (p >= 0)
        *reinterpret_cast<uint4*>(xa + a_off(r, c)) =
            *reinterpret_cast<const uint4*>(xh + a_off(p, c));
    }
    hop::fence_async_smem();
    hop::bar_sync(bar, 128);
    hop::run_product<MJ>(ring, prod[4 + 2 * s], xa, d, 0, 1, producer);
    UP4_PHASE(2);
#pragma unroll
    for (int jj = 0; jj < MJ; ++jj)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = hop::acc_row(t, i), col = jj * 64 + hop::acc_col(t, i);
        if (col < C)
          *reinterpret_cast<uint32_t*>(z + a_off(row, col)) =
              pack2(prelu(d[jj][i], ap), prelu(d[jj][i + 1], ap));
      }
    hop::fence_async_smem();
    hop::bar_sync(bar, 128);
    UP4_PHASE(3);
    hop::run_product<MJ>(ring, prod[5 + 2 * s], z, d, 0, 1, producer);
    UP4_PHASE(4);
    int py[2] = {0, 0}, px[2] = {0, 0};
    bool has[2];
    const float* q00[2];   // the stencil's taps of each row: (rlo, clo); then + ldb,
                           // + kR1W * ldb for the next column and row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      has[h] = row_pixel(pi, pj, rows[h], py[h], px[h]);
      const int r = py[h] + 1, c = px[h] + 1;
      q00[h] = xb + ((pi < 2 ? r - 1 : r) * kR1W + (pj < 2 ? c - 1 : c)) * ldb;
    }
    const float a0 = kP4[pi][0], a1 = kP4[pi][1], b0 = kP4[pj][0], b1 = kP4[pj][1];
    hop::bar_sync(bar, 128);   // every warp's products have read z
    // Y_s = round(z @ wpf + the stencil of xb), into z
#pragma unroll
    for (int jj = 0; jj < MJ; ++jj)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int h = (i >> 1) & 1, row = rows[h], col = jj * 64 + hop::acc_col(t, i);
        if (col >= C) continue;
        float v0 = d[jj][i], v1 = d[jj][i + 1];
        if (has[h]) {
          const float2 lo_l = *reinterpret_cast<const float2*>(q00[h] + col);
          const float2 lo_r = *reinterpret_cast<const float2*>(q00[h] + ldb + col);
          const float2 hi_l = *reinterpret_cast<const float2*>(q00[h] + kR1W * ldb + col);
          const float2 hi_r = *reinterpret_cast<const float2*>(q00[h] + (kR1W + 1) * ldb + col);
          v0 += b0 * (a0 * lo_l.x + a1 * hi_l.x) + b1 * (a0 * lo_r.x + a1 * hi_r.x);
          v1 += b0 * (a0 * lo_l.y + a1 * hi_l.y) + b1 * (a0 * lo_r.y + a1 * hi_r.y);
        }
        *reinterpret_cast<uint32_t*>(z + a_off(row, col)) = pack2(v0, v1);
      }
    hop::fence_async_smem();
    hop::bar_sync(bar, 128);
    UP4_PHASE(5);
    // the conv terms of Y_s; a phase-map row outside the image feeds nothing
    // (the zero pad)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gy = ty0 + py[h], gx = tx0 + px[h];
      has[h] = has[h] && gy >= 0 && gy < H && gx >= 0 && gx < W;
    }
    switch (Nc / 16) {
      case 1: conv_terms<1>(z, wc, C, out, inv_out, pi, pj, t, has, py, px, acc); break;
      case 2: conv_terms<2>(z, wc, C, out, inv_out, pi, pj, t, has, py, px, acc); break;
      case 3: conv_terms<3>(z, wc, C, out, inv_out, pi, pj, t, has, py, px, acc); break;
      case 4: conv_terms<4>(z, wc, C, out, inv_out, pi, pj, t, has, py, px, acc); break;
      default: conv_terms<5>(z, wc, C, out, inv_out, pi, pj, t, has, py, px, acc); break;
    }
    UP4_PHASE(6);
  }
  hop::bar_sync(bar, 128);
  if (!live) return;
  for (int e = t; e < kIn * 16 * out; e += 128) {
    const int p = e / (16 * out), gy = ty0 + p / kTW, gx = tx0 + p % kTW;
    if (gy < H && gx < W)
      a.dst[(((size_t)b * H + gy) * W + gx) * 16 * out + e % (16 * out)] = tobf(acc[e]);
  }
  UP4_PHASE(7);
}

}  // namespace up4c
}  // namespace sunet

using namespace sunet;

#ifdef SUNET_PHASE_CLOCK
// The measurement build's per-phase cycle buffer (see kUpPhases); NULL
// stops recording.
extern "C" int sunet_up4_conv_phase_clock(void* buf) {
  return (int)cudaMemcpyToSymbol(up4c::g_up4_clock, &buf, sizeof(buf));
}
#endif

// dst (B, H, W, 16*out) from x (B, H, W, Cx): with C = Cx rounded up to 16,
// wexp (16, C, C) s-major; wb1, wpf, wbf (C, C); bb1 (C,), zeros past Cx;
// wconv (3, 3, Cx, out); alphas (alpha_p, alpha_b); T: tiles (warpgroups)
// per CTA, from the plan.
extern "C" int sunet_up4_conv_phase(const void* x, void* dst, const void* wexp,
                                    const void* wb1, const void* bb1, const void* wpf,
                                    const void* wbf, const void* wconv,
                                    const void* alphas, int B, int H, int W, int Cx,
                                    int out, int T, void* stream) {
  using namespace up4c;
  const int C = align_up(Cx, 16), nb = hop::nboxes(C);
  if (B < 1 || H < 1 || W < 1 || Cx % 4 || nb > 3 || out < 1 || out > 8 || T < 1 || T > 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C, out, T);
  const int bk = hop::chunk_rows(kRingSlot, nb, C);
  Maps m;
  cudaError_t e;
  if ((e = hop::weight_map(&m.wexp, wexp, 16 * C, C, bk)) ||
      (e = hop::weight_map(&m.wb1, wb1, C, C, bk)) ||
      (e = hop::weight_map(&m.wpf, wpf, C, C, bk)) ||
      (e = hop::weight_map(&m.wbf, wbf, C, C, bk)))
    return (int)e;
  const int nty = (H + kTH - 1) / kTH, ntx = (W + kTW - 1) / kTW, ntiles = B * nty * ntx;
  const Args a{(const bf16*)x, (bf16*)dst, (const float*)bb1, (const bf16*)wconv,
               (const float*)alphas, B, H, W, C, out, nty, ntx, ntiles, T, Cx};
  const dim3 grid((ntiles + T - 1) / T);
  cudaStream_t st = (cudaStream_t)stream;
  switch (nb) {
    case 1: return (int)hop::launch_cluster(up4_conv_kernel<1>, grid, 128 * T, smem, st, 1, a, m);
    case 2: return (int)hop::launch_cluster(up4_conv_kernel<2>, grid, 128 * T, smem, st, 1, a, m);
    default: return (int)hop::launch_cluster(up4_conv_kernel<3>, grid, 128 * T, smem, st, 1, a, m);
  }
}
