// The attention of the whole-block backward (swin_block_bwd.cuh, the
// recompute form #8) for windows above 64 tokens (WIN 16: 256, the scaled
// config): the big-window counterpart of block_bwd_hopper.cuh's
// attn_tc_kernel, whose whole-window operands (~413 KB at N = 256 and a
// head dim padded to 32) do not fit a CTA's shared memory.
//
// Replaces, with swin_block_bwd.cu's big entry, the per-head attention of
// sunet_tf_tpu/kernels/window_attention.py::_block_bwd_kernel
// (_attn_core_fwd_res and _attn_core_bwd, the perhead layout JAX takes at
// N = 256). Its rounding points are those of the N <= 64 form: qs =
// round(q scale); s = qs k^T + bias (+ mask) in fp32; P = exp(s - rowmax) *
// (1 / rowsum) in fp32; ctx = round(round(P) @ v); dP = dctx v^T (dctx
// rounded); D = rowsum(P * dP) in fp32 (JAX's form: jnp.sum(dp * p)); ds =
// P (dP - D); dbias = sum of ds over windows; dq = round(ds) k * scale, dk
// = round(ds)^T qs, dv = round(P)^T dctx, each rounded into dqkv, their
// fp32 column sums the qkv bias gradient.
//
// What bounds it on Hopper: at (128,128,180) batch 4 (256 windows of 256
// tokens, 6 heads of 30 columns) the attention's products are ~2.6 GFLOP
// forward (the scores three times) and ~5 GFLOP backward (2.6 us and 5 us
// at the bf16 peak) against ~100 MB of operands and the rel-pos bias
// gradient's partials (~30 us at 3.35 TB/s): the bytes, and in practice the
// mma.sync issue and the scores recomputed in every launch.
//
// Design: a CTA of four warps per 64 rows of a (window, head), each warp a
// 16-row strip holding one 16 x 64 score tile in registers at a time, the
// keys (or queries) in chunks of 64 (the pattern of wmsa_attn.cuh's
// attn_big_kernel):
//   big_fwd_kernel: (head, 64 query rows, window): pass 1 the exact row
//     maximum, pass 2 the row sum of exp(s - max), pass 3 P and round(P) @
//     v; ctx written, and the row's max and 1 / sum (fp32), which the two
//     backward launches read, so every launch sees the same P;
//   big_dq_kernel: (head, 64 query rows, chunk of windows): per window pass
//     1 D = rowsum(P dP) (written for the next launch), pass 2 ds and dq +=
//     round(ds) k; ds summed into the rel-pos bias gradient's 64 x N rows in
//     shared memory over the chunk's windows;
//   big_dkv_kernel: (head, 64 key rows, chunk of windows): per window the
//     queries in chunks of 64, P^T, dP^T and ds^T recomputed transposed
//     (keys as rows), dk += round(ds)^T qs, dv += round(P)^T dctx.
// The rel-pos bias partials are [chunk][head][N][N] (each row written by one
// dq CTA), the qkv bias partials [chunk * N / 64 + block][3C]; swin_block_bwd
// .cuh's sum launch adds them in chunk order (the same bits every run).
// The kernels are templates (instantiated where swin_block_bwd.cu launches
// them), so the other sources that include the header do not compile them.
// C is the row stride of the (padded) token rows; the head columns are hh d
// .. hh d + d - 1 of each of q, k, v (at 0, C, 2C) with d = the real width
// over the heads: columns past heads * d are never read or written here.
#pragma once

#include "block_bwd_hopper.cuh"

namespace sunet {
namespace bb {

constexpr int kBigRows = 64;      // rows of a big-form CTA: four warps of 16
constexpr int kBigMaxTok = 256;   // tokens of a window, at most
constexpr int kBigMaxD = 64;      // head dim, at most (four k16 steps)

struct BigAttnArgs {
  const bf16* qkv;             // (T, 3C): q (unscaled), k, v
  const bf16* dctxb;           // (T, C): round(dattn wproj^T)
  const float *bias, *mask;    // (heads, N, N), (nW, N, N) or null
  bf16* ctx;                   // (T, C)
  bf16* dqkv;                  // (T, 3C)
  float *rmax, *rinv, *dsum;   // (nwin, heads, N): row max, 1 / row sum, D
  float *pbias, *pqkv;         // [chunk][heads][N][N], [chunk * nq + block][3C]
  int C, heads, d, N, nW, nwin, wpc;
  float scale;
};

// Shared-memory bytes of the three launches for N tokens and a head dim
// padded to dp (kernels/window_attention.py::_big_attn_smem mirrors them):
// bf16 rows of dp + 8, transposed rows of N + 8, fp32 partials.
__host__ __device__ inline size_t big_rows(int n, int dp) { return align128((size_t)n * (dp + 8) * 2); }
__host__ __device__ inline size_t big_trans(int N, int dp) { return align128((size_t)dp * (N + 8) * 2); }
__host__ __device__ inline size_t big_fwd_smem(int N, int dp) {
  return big_rows(kBigRows, dp) + big_rows(N, dp) + big_trans(N, dp);
}
__host__ __device__ inline size_t big_dq_smem(int N, int dp) {
  return 2 * big_rows(kBigRows, dp) + 2 * big_rows(N, dp) + big_trans(N, dp) +
         (size_t)kBigRows * (N + 4) * 4 + (size_t)5 * dp * 4;
}
__host__ __device__ inline size_t big_dkv_smem(int N, int dp) {
  return 2 * big_rows(kBigRows, dp) + 2 * big_rows(N, dp) + 2 * big_trans(N, dp) +
         (size_t)3 * N * 4 + (size_t)10 * dp * 4;
}

// Rows t0 .. t0 + n - 1 of window `row0`'s head hh columns of matrix mat (0
// q, scaled and rounded; 1 k; 2 v; 3 dctx) into `rows` (row stride ld) and,
// where tr is given, transposed into tr (dp rows of stride ldn, column t);
// zero from d to dp. Ends with no barrier.
__device__ inline void big_load(const BigAttnArgs& a, int hh, int mat, size_t row0, int t0,
                                int n, int dp, bf16* rows, int ld, bf16* tr, int ldn) {
  const int P = dp >> 1, d = a.d, C = a.C;
  for (int i = threadIdx.x; i < n * P; i += kAThr) {
    const int t = i / P, c = 2 * (i - t * P);
    uint32_t v = 0u;
    if (c < d) {
      const size_t r = row0 + t0 + t;
      v = mat == 3 ? ldg32(a.dctxb + r * C + hh * d + c)
                   : ldg32(a.qkv + r * 3 * C + (size_t)mat * C + hh * d + c);
      if (mat == 0) {
        const bf16* e = reinterpret_cast<const bf16*>(&v);
        v = pack_bf2(bf(e[0]) * a.scale, bf(e[1]) * a.scale);
      }
    }
    if (rows) *reinterpret_cast<uint32_t*>(rows + t * ld + c) = v;
    if (tr) {
      tr[c * ldn + t] = __ushort_as_bfloat16((unsigned short)(v & 0xffffu));
      tr[(c + 1) * ldn + t] = __ushort_as_bfloat16((unsigned short)(v >> 16));
    }
  }
}

// A fragments of rows i0 .. i0 + 15 of a row matrix, nk k16 steps.
__device__ inline void big_frags(uint32_t (&f)[kBigMaxD / 16][4], const bf16* m, int ld, int i0,
                                 int nk, int g, int t2) {
#pragma unroll
  for (int kk = 0; kk < kBigMaxD / 16; ++kk)
    if (kk < nk) frag_a(f[kk], m, ld, i0, kk * 16, g, t2);
}

// A 16 x 64 tile: this warp's rows (fragments f) times rows j0 .. j0 + 63 of
// the row matrix b, over nk k16 steps.
__device__ inline void big_tile(float (&s)[8][4], const uint32_t (&f)[kBigMaxD / 16][4],
                                const bf16* b, int ld, int j0, int nk, int g, int t2) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kBigMaxD / 16; ++kk) {
    if (kk >= nk) break;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const bf16* kb = b + (j0 + nt * 8 + g) * ld + kk * 16 + t2;
      mma16816(s[nt], f[kk], ld32(kb), ld32(kb + 8));
    }
  }
}

// The scores of query rows ra, ra + 8 against keys j0 .. j0 + 63: q k^T +
// bias (+ mask), the fp32 order of attn_tc_kernel.
__device__ inline void big_scores(float (&s)[8][4], const uint32_t (&qf)[kBigMaxD / 16][4],
                                  const bf16* ks, int ld, int j0, int nk, int g, int t2,
                                  const float* bias, const float* mask, int N, int ra) {
  big_tile(s, qf, ks, ld, j0, nk, g, t2);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j = j0 + nt * 8 + t2;
    const float2 b0 = *reinterpret_cast<const float2*>(bias + (size_t)ra * N + j);
    const float2 b1 = *reinterpret_cast<const float2*>(bias + (size_t)(ra + 8) * N + j);
    s[nt][0] += b0.x;
    s[nt][1] += b0.y;
    s[nt][2] += b1.x;
    s[nt][3] += b1.y;
    if (mask) {
      const float2 k0 = *reinterpret_cast<const float2*>(mask + (size_t)ra * N + j);
      const float2 k1 = *reinterpret_cast<const float2*>(mask + (size_t)(ra + 8) * N + j);
      s[nt][0] += k0.x;
      s[nt][1] += k0.y;
      s[nt][2] += k1.x;
      s[nt][3] += k1.y;
    }
  }
}

// round(o) of matrix mat (0 q, 1 k, 2 v) at window rows ra, ra + 8 (token
// rows row0 + ..), head columns dt * 8 + t2 (+1) into dqkv; the warp's
// column sums of the fp32 o into red[mat-slot][dp].
__device__ inline void big_store(const BigAttnArgs& a, int hh, int mat, int dt, const float (&o)[4],
                                 size_t row0, int ra, int g, int t2, float* red) {
  const int c = dt * 8 + t2, C = a.C;
  float v0 = o[0] + o[2], v1 = o[1] + o[3];
#pragma unroll
  for (int m = 4; m <= 16; m <<= 1) {
    v0 += __shfl_xor_sync(0xffffffffu, v0, m);
    v1 += __shfl_xor_sync(0xffffffffu, v1, m);
  }
  if (c >= a.d) return;   // d is even: the pair is whole
  const size_t e = (row0 + ra) * 3 * C + (size_t)mat * C + hh * a.d + c;
  *reinterpret_cast<uint32_t*>(a.dqkv + e) = pack_bf2(o[0], o[1]);
  *reinterpret_cast<uint32_t*>(a.dqkv + e + 8 * 3 * (size_t)C) = pack_bf2(o[2], o[3]);
  if (g == 0) {
    red[c] = v0;
    red[c + 1] = v1;
  }
}

// Four warps' column sums red[warp * ld + c] added, in warp order, to acc.
__device__ inline void big_colsum(float* acc, const float* red, int ld, int n) {
  for (int c = threadIdx.x; c < n; c += kAThr) {
    float v = 0.f;
    for (int w = 0; w < kAThr / 32; ++w) v += red[w * ld + c];
    acc[c] += v;
  }
}

// ---------------------------------------------------------------- forward recompute

// Grid (heads, N / 64 query blocks, windows).
template <int kUnused = 0>
__global__ void __launch_bounds__(kAThr) big_fwd_kernel(const BigAttnArgs a) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int hh = blockIdx.x, qb = blockIdx.y, wg = blockIdx.z;
  const int N = a.N, d = a.d, dp = (d + 15) & ~15, ld = dp + 8, ldn = N + 8, nk = dp / 16;
  bf16* qs = reinterpret_cast<bf16*>(sm);
  bf16* ks = reinterpret_cast<bf16*>(sm + big_rows(kBigRows, dp));
  bf16* vT = reinterpret_cast<bf16*>(sm + big_rows(kBigRows, dp) + big_rows(N, dp));
  const size_t row0 = (size_t)wg * N;
  big_load(a, hh, 0, row0, qb * kBigRows, kBigRows, dp, qs, ld, nullptr, 0);
  big_load(a, hh, 1, row0, 0, N, dp, ks, ld, nullptr, 0);
  big_load(a, hh, 2, row0, 0, N, dp, nullptr, 0, vT, ldn);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t2 = (lane & 3) * 2;
  const int i0 = warp * 16, ra = qb * kBigRows + i0 + g;
  uint32_t qf[kBigMaxD / 16][4];
  big_frags(qf, qs, ld, i0, nk, g, t2);
  const float* bias = a.bias + (size_t)hh * N * N;
  const float* mask = a.mask ? a.mask + (size_t)(wg % a.nW) * N * N : nullptr;
  float s[8][4];
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int kc = 0; kc < N / 64; ++kc) {   // pass 1: the exact row maxima
    big_scores(s, qf, ks, ld, kc * 64, nk, g, t2, bias, mask, N, ra);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
      m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  float l0 = 0.f, l1 = 0.f;
  for (int kc = 0; kc < N / 64; ++kc) {   // pass 2: the row sums
    big_scores(s, qf, ks, ld, kc * 64, nk, g, t2, bias, mask, N, ra);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      l0 += expf(s[nt][0] - m0) + expf(s[nt][1] - m0);
      l1 += expf(s[nt][2] - m1) + expf(s[nt][3] - m1);
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  // P = e * (1 / l), as attn_tc_kernel (no divide on the subnormal e)
  const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);
  float acc[kBigMaxD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kBigMaxD / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  for (int kc = 0; kc < N / 64; ++kc) {   // pass 3: round(P) @ v
    big_scores(s, qf, ks, ld, kc * 64, nk, g, t2, bias, mask, N, ra);
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      const int a0 = 2 * kt, a1 = 2 * kt + 1;
      const uint32_t pf[4] = {pack_bf2(expf(s[a0][0] - m0) * r0, expf(s[a0][1] - m0) * r0),
                              pack_bf2(expf(s[a0][2] - m1) * r1, expf(s[a0][3] - m1) * r1),
                              pack_bf2(expf(s[a1][0] - m0) * r0, expf(s[a1][1] - m0) * r0),
                              pack_bf2(expf(s[a1][2] - m1) * r1, expf(s[a1][3] - m1) * r1)};
#pragma unroll
      for (int dt = 0; dt < kBigMaxD / 8; ++dt) {
        if (dt * 8 >= dp) break;
        const bf16* vb = vT + (dt * 8 + g) * ldn + kc * 64 + kt * 16 + t2;
        mma16816(acc[dt], pf, ld32(vb), ld32(vb + 8));
      }
    }
  }
#pragma unroll
  for (int dt = 0; dt < kBigMaxD / 8; ++dt) {
    const int c = dt * 8 + t2;
    if (c >= d) break;   // d is even: the pair is whole
    *reinterpret_cast<uint32_t*>(a.ctx + (row0 + ra) * a.C + hh * d + c) =
        pack_bf2(acc[dt][0], acc[dt][1]);
    *reinterpret_cast<uint32_t*>(a.ctx + (row0 + ra + 8) * a.C + hh * d + c) =
        pack_bf2(acc[dt][2], acc[dt][3]);
  }
  if (t2 == 0) {
    const size_t st = ((size_t)wg * a.heads + hh) * N + ra;
    a.rmax[st] = m0;
    a.rmax[st + 8] = m1;
    a.rinv[st] = r0;
    a.rinv[st + 8] = r1;
  }
}

// ---------------------------------------------------------------- dq (and D, dbias)

// Grid (heads, N / 64 query blocks, chunks of wpc windows).
template <int kUnused = 0>
__global__ void __launch_bounds__(kAThr) big_dq_kernel(const BigAttnArgs a) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int hh = blockIdx.x, qb = blockIdx.y, nq = gridDim.y;
  const int N = a.N, d = a.d, dp = (d + 15) & ~15, ld = dp + 8, ldn = N + 8, nk = dp / 16;
  const int ldb = N + 4;
  bf16* qs = reinterpret_cast<bf16*>(sm);
  bf16* os = reinterpret_cast<bf16*>(sm + big_rows(kBigRows, dp));
  bf16* ks = reinterpret_cast<bf16*>(sm + 2 * big_rows(kBigRows, dp));
  bf16* vs = reinterpret_cast<bf16*>(sm + 2 * big_rows(kBigRows, dp) + big_rows(N, dp));
  bf16* kT = reinterpret_cast<bf16*>(sm + 2 * big_rows(kBigRows, dp) + 2 * big_rows(N, dp));
  float* dbs = reinterpret_cast<float*>(sm + 2 * big_rows(kBigRows, dp) + 2 * big_rows(N, dp) +
                                        big_trans(N, dp));   // [64][N + 4]: ds over the chunk
  float* red = dbs + kBigRows * ldb;   // [warp][dp]
  float* colacc = red + 4 * dp;        // [dp]: dq's column sums over the chunk
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t2 = (lane & 3) * 2;
  const int i0 = warp * 16, ra = qb * kBigRows + i0 + g;
  for (int i = threadIdx.x; i < kBigRows * ldb; i += kAThr) dbs[i] = 0.f;
  for (int i = threadIdx.x; i < dp; i += kAThr) colacc[i] = 0.f;
  const float* bias = a.bias + (size_t)hh * N * N;
  const int w0 = blockIdx.z * a.wpc, w1 = min(a.nwin, w0 + a.wpc);
  for (int wg = w0; wg < w1; ++wg) {
    const size_t row0 = (size_t)wg * N;
    big_load(a, hh, 0, row0, qb * kBigRows, kBigRows, dp, qs, ld, nullptr, 0);
    big_load(a, hh, 3, row0, qb * kBigRows, kBigRows, dp, os, ld, nullptr, 0);
    big_load(a, hh, 1, row0, 0, N, dp, ks, ld, kT, ldn);
    big_load(a, hh, 2, row0, 0, N, dp, vs, ld, nullptr, 0);
    __syncthreads();
    const size_t st = ((size_t)wg * a.heads + hh) * N + ra;
    const float m0 = a.rmax[st], m1 = a.rmax[st + 8], r0 = a.rinv[st], r1 = a.rinv[st + 8];
    const float* mask = a.mask ? a.mask + (size_t)(wg % a.nW) * N * N : nullptr;
    uint32_t qf[kBigMaxD / 16][4], of[kBigMaxD / 16][4];
    big_frags(qf, qs, ld, i0, nk, g, t2);
    big_frags(of, os, ld, i0, nk, g, t2);
    float s[8][4], dpv[8][4];
    float rd0 = 0.f, rd1 = 0.f;   // D = rowsum(P dP)
    for (int kc = 0; kc < N / 64; ++kc) {
      big_scores(s, qf, ks, ld, kc * 64, nk, g, t2, bias, mask, N, ra);
      big_tile(dpv, of, vs, ld, kc * 64, nk, g, t2);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        rd0 += dpv[nt][0] * (expf(s[nt][0] - m0) * r0) + dpv[nt][1] * (expf(s[nt][1] - m0) * r0);
        rd1 += dpv[nt][2] * (expf(s[nt][2] - m1) * r1) + dpv[nt][3] * (expf(s[nt][3] - m1) * r1);
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      rd0 += __shfl_xor_sync(0xffffffffu, rd0, o);
      rd1 += __shfl_xor_sync(0xffffffffu, rd1, o);
    }
    if (t2 == 0) {
      a.dsum[st] = rd0;
      a.dsum[st + 8] = rd1;
    }
    float dq[kBigMaxD / 8][4];
#pragma unroll
    for (int dt = 0; dt < kBigMaxD / 8; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;
    for (int kc = 0; kc < N / 64; ++kc) {
      big_scores(s, qf, ks, ld, kc * 64, nk, g, t2, bias, mask, N, ra);
      big_tile(dpv, of, vs, ld, kc * 64, nk, g, t2);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {   // ds = P (dP - D), summed for dbias
        const int j = kc * 64 + nt * 8 + t2;
        dpv[nt][0] = expf(s[nt][0] - m0) * r0 * (dpv[nt][0] - rd0);
        dpv[nt][1] = expf(s[nt][1] - m0) * r0 * (dpv[nt][1] - rd0);
        dpv[nt][2] = expf(s[nt][2] - m1) * r1 * (dpv[nt][2] - rd1);
        dpv[nt][3] = expf(s[nt][3] - m1) * r1 * (dpv[nt][3] - rd1);
        float* b0 = dbs + (i0 + g) * ldb + j;
        float* b1 = b0 + 8 * ldb;
        b0[0] += dpv[nt][0];
        b0[1] += dpv[nt][1];
        b1[0] += dpv[nt][2];
        b1[1] += dpv[nt][3];
      }
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {   // dq += round(ds) k
        const int a0 = 2 * kt, a1 = 2 * kt + 1;
        const uint32_t df[4] = {pack_bf2(dpv[a0][0], dpv[a0][1]), pack_bf2(dpv[a0][2], dpv[a0][3]),
                                pack_bf2(dpv[a1][0], dpv[a1][1]), pack_bf2(dpv[a1][2], dpv[a1][3])};
#pragma unroll
        for (int dt = 0; dt < kBigMaxD / 8; ++dt) {
          if (dt * 8 >= dp) break;
          const bf16* kb = kT + (dt * 8 + g) * ldn + kc * 64 + kt * 16 + t2;
          mma16816(dq[dt], df, ld32(kb), ld32(kb + 8));
        }
      }
    }
#pragma unroll
    for (int dt = 0; dt < kBigMaxD / 8; ++dt) {
      if (dt * 8 >= dp) break;
#pragma unroll
      for (int u = 0; u < 4; ++u) dq[dt][u] *= a.scale;
      big_store(a, hh, 0, dt, dq[dt], row0, ra, g, t2, red + warp * dp);
    }
    __syncthreads();   // red is whole; the operands may be overwritten
    big_colsum(colacc, red, dp, d);
  }
  __syncthreads();
  float* out = a.pbias + (((size_t)blockIdx.z * a.heads + hh) * N + qb * kBigRows) * N;
  for (int i = threadIdx.x; i < kBigRows * N; i += kAThr) out[i] = dbs[(i / N) * ldb + i % N];
  for (int c = threadIdx.x; c < d; c += kAThr)
    a.pqkv[((size_t)blockIdx.z * nq + qb) * 3 * a.C + hh * d + c] = colacc[c];
}

// ---------------------------------------------------------------- dk, dv

// Grid (heads, N / 64 key blocks, chunks of wpc windows). The warp's rows
// are keys jr, jr + 8; its tiles' columns queries.
template <int kUnused = 0>
__global__ void __launch_bounds__(kAThr) big_dkv_kernel(const BigAttnArgs a) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int hh = blockIdx.x, kb = blockIdx.y, nq = gridDim.y;
  const int N = a.N, d = a.d, dp = (d + 15) & ~15, ld = dp + 8, ldn = N + 8, nk = dp / 16;
  const size_t r64 = big_rows(kBigRows, dp), rN = big_rows(N, dp), tN = big_trans(N, dp);
  bf16* ks = reinterpret_cast<bf16*>(sm);
  bf16* vs = reinterpret_cast<bf16*>(sm + r64);
  bf16* qs = reinterpret_cast<bf16*>(sm + 2 * r64);
  bf16* os = reinterpret_cast<bf16*>(sm + 2 * r64 + rN);
  bf16* qT = reinterpret_cast<bf16*>(sm + 2 * r64 + 2 * rN);
  bf16* oT = reinterpret_cast<bf16*>(sm + 2 * r64 + 2 * rN + tN);
  float* sm_m = reinterpret_cast<float*>(sm + 2 * r64 + 2 * rN + 2 * tN);   // [N] row max
  float* sm_r = sm_m + N;                                                 // [N] 1 / row sum
  float* sm_d = sm_r + N;                                                 // [N] D
  float* red = sm_d + N;          // [warp][k, v][dp]
  float* colacc = red + 8 * dp;   // [k, v][dp]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t2 = (lane & 3) * 2;
  const int i0 = warp * 16, jr = kb * kBigRows + i0 + g;   // this thread's key rows jr, jr + 8
  for (int i = threadIdx.x; i < 2 * dp; i += kAThr) colacc[i] = 0.f;
  const float* bias = a.bias + (size_t)hh * N * N;
  const int w0 = blockIdx.z * a.wpc, w1 = min(a.nwin, w0 + a.wpc);
  for (int wg = w0; wg < w1; ++wg) {
    const size_t row0 = (size_t)wg * N;
    big_load(a, hh, 1, row0, kb * kBigRows, kBigRows, dp, ks, ld, nullptr, 0);
    big_load(a, hh, 2, row0, kb * kBigRows, kBigRows, dp, vs, ld, nullptr, 0);
    big_load(a, hh, 0, row0, 0, N, dp, qs, ld, qT, ldn);
    big_load(a, hh, 3, row0, 0, N, dp, os, ld, oT, ldn);
    const size_t st0 = ((size_t)wg * a.heads + hh) * N;
    for (int i = threadIdx.x; i < N; i += kAThr) {
      sm_m[i] = a.rmax[st0 + i];
      sm_r[i] = a.rinv[st0 + i];
      sm_d[i] = a.dsum[st0 + i];
    }
    __syncthreads();
    const float* mask = a.mask ? a.mask + (size_t)(wg % a.nW) * N * N : nullptr;
    uint32_t kf[kBigMaxD / 16][4], vf[kBigMaxD / 16][4];
    big_frags(kf, ks, ld, i0, nk, g, t2);
    big_frags(vf, vs, ld, i0, nk, g, t2);
    float dk[kBigMaxD / 8][4], dv[kBigMaxD / 8][4];
#pragma unroll
    for (int dt = 0; dt < kBigMaxD / 8; ++dt)
#pragma unroll
      for (int u = 0; u < 4; ++u) dk[dt][u] = dv[dt][u] = 0.f;
    float s[8][4], dpv[8][4];
    for (int qc = 0; qc < N / 64; ++qc) {
      big_tile(s, kf, qs, ld, qc * 64, nk, g, t2);    // s^T: k q^T
      big_tile(dpv, vf, os, ld, qc * 64, nk, g, t2);  // dP^T: v dctx^T
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int i = qc * 64 + nt * 8 + t2;   // query columns i, i + 1
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int q = i + (u & 1), j = jr + (u >> 1) * 8;
          float v = s[nt][u] + bias[(size_t)q * N + j];
          if (mask) v += mask[(size_t)q * N + j];
          const float p = expf(v - sm_m[q]) * sm_r[q];
          s[nt][u] = p;                                 // P^T
          dpv[nt][u] = p * (dpv[nt][u] - sm_d[q]);      // ds^T
        }
      }
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {   // dk += round(ds)^T qs, dv += round(P)^T dctx
        const int a0 = 2 * kt, a1 = 2 * kt + 1;
        const uint32_t df[4] = {pack_bf2(dpv[a0][0], dpv[a0][1]), pack_bf2(dpv[a0][2], dpv[a0][3]),
                                pack_bf2(dpv[a1][0], dpv[a1][1]), pack_bf2(dpv[a1][2], dpv[a1][3])};
        const uint32_t pf[4] = {pack_bf2(s[a0][0], s[a0][1]), pack_bf2(s[a0][2], s[a0][3]),
                                pack_bf2(s[a1][0], s[a1][1]), pack_bf2(s[a1][2], s[a1][3])};
#pragma unroll
        for (int dt = 0; dt < kBigMaxD / 8; ++dt) {
          if (dt * 8 >= dp) break;
          const int off = (dt * 8 + g) * ldn + qc * 64 + kt * 16 + t2;
          mma16816(dk[dt], df, ld32(qT + off), ld32(qT + off + 8));
          mma16816(dv[dt], pf, ld32(oT + off), ld32(oT + off + 8));
        }
      }
    }
#pragma unroll
    for (int dt = 0; dt < kBigMaxD / 8; ++dt) {
      if (dt * 8 >= dp) break;
      big_store(a, hh, 1, dt, dk[dt], row0, jr, g, t2, red + (2 * warp) * dp);
      big_store(a, hh, 2, dt, dv[dt], row0, jr, g, t2, red + (2 * warp + 1) * dp);
    }
    __syncthreads();   // red is whole; the operands may be overwritten
    big_colsum(colacc, red, 2 * dp, 2 * dp);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * dp; i += kAThr) {
    const int c = i % dp;
    if (c < d)
      a.pqkv[((size_t)blockIdx.z * nq + kb) * 3 * a.C + (size_t)(1 + i / dp) * a.C + hh * d + c] =
          colacc[i];
  }
}

// The three launches: the forward recompute (ctx, the row statistics), or
// the backward's dq and dk/dv, over nwin windows in chunks of a.wpc.
inline cudaError_t attn_big_fwd(const BigAttnArgs& a, cudaStream_t st, int* n) {
  const int dp = (a.d + 15) & ~15;
  const size_t smem = big_fwd_smem(a.N, dp);
  SUNET_TRY(set_smem(big_fwd_kernel<>, smem));
  big_fwd_kernel<><<<dim3(a.heads, a.N / kBigRows, a.nwin), kAThr, smem, st>>>(a);
  return launched(n);
}

inline cudaError_t attn_big_bwd(const BigAttnArgs& a, cudaStream_t st, int* n) {
  const int dp = (a.d + 15) & ~15, chunks = (a.nwin + a.wpc - 1) / a.wpc;
  const dim3 grid(a.heads, a.N / kBigRows, chunks);
  SUNET_TRY(set_smem(big_dq_kernel<>, big_dq_smem(a.N, dp)));
  big_dq_kernel<><<<grid, kAThr, big_dq_smem(a.N, dp), st>>>(a);
  SUNET_TRY(launched(n));
  SUNET_TRY(set_smem(big_dkv_kernel<>, big_dkv_smem(a.N, dp)));
  big_dkv_kernel<><<<grid, kAThr, big_dkv_smem(a.N, dp), st>>>(a);
  return launched(n);
}

}  // namespace bb
}  // namespace sunet
