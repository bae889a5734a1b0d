// Backward of the whole Swin block, the recompute form.
//
// Replaces sunet_tf_tpu/kernels/window_attention.py::_block_bwd_impl (its
// kernel _block_bwd_kernel): from x (unrolled), dout and the block's
// weights it recomputes LN1 -> qkv -> per-head softmax P -> ctx -> y ->
// LN2 -> fc1 pre-activation, then returns dx and the float32 grads of the
// 12 block parameters and of the (h, N, N) rel-pos bias. Rounding points
// and the per-head attention backward (P-based: ds = P*(dP - rowsum(dP*P)))
// follow the JAX kernel; the plain version is swin_block_bwd_reference in
// kernels/window_attention.py.
//
// What bounds it on Hopper: the products. Forward recompute plus backward
// is ~3x the block's forward work: at (64,64,96) batch 2 about 5.4 GFLOP
// (5.5 us at the 989 TFLOP/s bf16 peak) against ~20 MB of activations and
// intermediates, which stay in the 50 MB L2 at these shapes (HBM bound
// ~6 us at 3.35 TB/s). Each launch is short, so its ramp and the latency
// of its serial phases count as much as either.
//
// Design (swin_block_bwd.cuh, kernels in block_bwd_hopper.cuh): 11
// launches, every token-row product on hopper.cuh's wgmma + TMA mainloop
// with the LN forward in its A load and the LN backward in a cluster
// epilogue, the attention forward and backward per (head, window) on
// mma.sync, the four weight gradients in one launch of token-chunk
// partials, and one launch that sums every partial in a fixed order.
// Device time on the H100 (700 W), batch 2: 0.26 ms at (64,64,96), 0.19 ms
// at (32,32,192) and (16,16,384); 35 launches took 0.64 / 0.47 / 0.55 ms
// (PERF.md). Up to 64 tokens a window the head dim is any even one whose
// attention operands fit shared memory (up to 192 at 64 tokens: the
// default model's C=768 stage at 96, C=384 with 2 heads at 192), the
// attention on the same kernel as ln_wmsa_bwd.cu's; the residual route
// (swin_block_bwd_res.cu) keeps 64. Windows above 64 tokens take the big
// entry below (block_bwd_big.cuh's attention).
#include "swin_block_bwd.cuh"

using namespace sunet;

extern "C" size_t sunet_swin_block_bwd_workspace(int B, int H, int W, int C, int hidden, int ws,
                                                 int heads) {
  if (!bwd_takes(H, W, C, hidden, ws, heads, false) || B <= 0) return 0;
  return carve_bwd(nullptr, B, H, W, C, hidden, ws, heads, false).bytes;
}

extern "C" int sunet_swin_block_bwd(
    const void* x, const void* dout, const void* g1, const void* be1, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* g2, const void* be2,
    const void* w1, const void* b1, const void* w2, const void* b2, const void* bias,
    const void* mask, const void* dp, void* dx, void* dg1, void* db1, void* dwqkv, void* dbqkv,
    void* dwproj, void* dbproj, void* dg2, void* db2, void* dw1, void* dbm1, void* dw2,
    void* dbm2, void* dbias, void* work, int B, int H, int W, int C, int hidden, int ws,
    int heads, int shift, float scale, int* launches, void* stream) {
  if (!bwd_takes(H, W, C, hidden, ws, heads, false) || B <= 0 || dp == nullptr)
    return (int)cudaErrorInvalidValue;
  BwdArgs a{(const bf16*)x,     (const bf16*)dout,  (const float*)g1,   (const float*)be1,
            (const bf16*)wqkv,  (const float*)bqkv, (const bf16*)wproj, (const float*)bproj,
            (const float*)g2,   (const float*)be2,  (const bf16*)w1,    (const float*)b1,
            (const bf16*)w2,    (const float*)b2,   (const float*)bias, (const float*)mask,
            (const float*)dp,   (bf16*)dx,          (float*)dg1,        (float*)db1,
            (float*)dwqkv,      (float*)dbqkv,      (float*)dwproj,     (float*)dbproj,
            (float*)dg2,        (float*)db2,        (float*)dw1,        (float*)dbm1,
            (float*)dw2,        (float*)dbm2,       (float*)dbias,      B,
            H,                  W,                  C,                  hidden,
            ws,                 heads,              shift,              scale};
  const BwdWork w = carve_bwd((unsigned char*)work, B, H, W, C, hidden, ws, heads, false);
  *launches = 0;
  return (int)block_bwd<false>(a, w, (cudaStream_t)stream, launches);
}

// The big-window form (windows above 64 tokens, WIN 16: the scaled config's
// C=180 / 360 / 720 stages): the same sequence with block_bwd_big.cuh's
// attention, 12 launches. C is the width of every row (a multiple of 16),
// cr <= C its real channels: x, dout, dx and the weights come zero-padded
// to C by the caller (kernels/window_attention.py::swin_block_bwd), which
// also slices the grads back to cr.
extern "C" size_t sunet_swin_block_bwd_big_workspace(int B, int H, int W, int C, int cr,
                                                     int hidden, int ws, int heads) {
  if (!bwd_big_takes(H, W, C, cr, hidden, ws, heads) || B <= 0) return 0;
  return carve_bwd(nullptr, B, H, W, C, hidden, ws, heads, false, true).bytes;
}

extern "C" int sunet_swin_block_bwd_big(
    const void* x, const void* dout, const void* g1, const void* be1, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* g2, const void* be2,
    const void* w1, const void* b1, const void* w2, const void* b2, const void* bias,
    const void* mask, const void* dp, void* dx, void* dg1, void* db1, void* dwqkv, void* dbqkv,
    void* dwproj, void* dbproj, void* dg2, void* db2, void* dw1, void* dbm1, void* dw2,
    void* dbm2, void* dbias, void* work, int B, int H, int W, int C, int cr, int hidden, int ws,
    int heads, int shift, float scale, int* launches, void* stream) {
  if (!bwd_big_takes(H, W, C, cr, hidden, ws, heads) || B <= 0 || dp == nullptr || shift < 0 ||
      shift >= ws)
    return (int)cudaErrorInvalidValue;
  BwdArgs a{(const bf16*)x,     (const bf16*)dout,  (const float*)g1,   (const float*)be1,
            (const bf16*)wqkv,  (const float*)bqkv, (const bf16*)wproj, (const float*)bproj,
            (const float*)g2,   (const float*)be2,  (const bf16*)w1,    (const float*)b1,
            (const bf16*)w2,    (const float*)b2,   (const float*)bias, (const float*)mask,
            (const float*)dp,   (bf16*)dx,          (float*)dg1,        (float*)db1,
            (float*)dwqkv,      (float*)dbqkv,      (float*)dwproj,     (float*)dbproj,
            (float*)dg2,        (float*)db2,        (float*)dw1,        (float*)dbm1,
            (float*)dw2,        (float*)dbm2,       (float*)dbias,      B,
            H,                  W,                  C,                  hidden,
            ws,                 heads,              shift,              scale};
  a.cr = cr;
  const BwdWork w = carve_bwd((unsigned char*)work, B, H, W, C, hidden, ws, heads, false, true);
  *launches = 0;
  return (int)block_bwd<false, true>(a, w, (cudaStream_t)stream, launches);
}
