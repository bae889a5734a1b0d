// Backward of the whole Swin block from the residual route's stored
// attention state.
//
// Replaces sunet_tf_tpu/kernels/window_attention.py::_block_bwd_impl_res
// (its kernel _block_bwd_res_kernel), the backward of
// swin_block_trainable_res, which the JAX package trains every block with
// when its attention takes the blockdiag layout in both directions (C=96
// and C=192 of the default model). From x (unrolled), dout, the block's
// weights and the forward's eb (B*nW, heads, N, N) bf16, rden (B*nW,
// heads, N) and ctx_f (T, C) fp32 (swin_cluster.cu's kRes form, window-major
// rolled token order), it returns dx and the float32 grads of the 12 block
// parameters and of the (h, N, N) rel-pos bias. It recomputes LN1 and qkv
// (q, k and v are still needed) but no scores and no softmax; the rel-pos
// bias and the mask are not read. Rounding points as the JAX kernel: the
// attention output is round(ctx_f) @ wproj; dctx = dattn wproj^T stays in
// fp32; the attention backward is JAX's blockdiag form with the stored
// reciprocal (attn_tc_kernel<kAttnBwdRes> in block_bwd_hopper.cuh). The
// plain version is swin_block_bwd_res_reference in
// kernels/window_attention.py.
//
// What bounds it on Hopper: the recompute form's products less its
// attention recompute, at (64,64,96) batch 2 about 5.2 GFLOP (5.3 us at the
// 989 TFLOP/s bf16 peak), against ~17 MB of x, dout, dx, the residuals
// (eb alone 8.4 MB) and the weights and their grads (5.1 us at 3.35 TB/s):
// the two about even.
//
// Design: the recompute form's launch sequence (swin_block_bwd.cuh) with
// no attention forward (proj's A load rounds ctx_f, and writes it as ctx
// for dwproj) and the attention backward reading e, rden and ctx_f: 10
// launches, the same bits on every run. Device time on the H100 (700 W):
// 0.26 ms at (64,64,96), 0.19 ms at (32,32,192) at batch 2, 0.40 / 0.28 ms
// at batch 4; 35 launches took 0.50 / 0.41 ms at batch 2 (PERF.md).
#include "swin_block_bwd.cuh"

using namespace sunet;

extern "C" size_t sunet_swin_block_bwd_res_workspace(int B, int H, int W, int C, int hidden,
                                                     int ws, int heads) {
  if (!bwd_takes(H, W, C, hidden, ws, heads, true) || B <= 0) return 0;
  return carve_bwd(nullptr, B, H, W, C, hidden, ws, heads, true).bytes;
}

extern "C" int sunet_swin_block_bwd_res(
    const void* x, const void* dout, const void* eb, const void* rden, const void* ctxf,
    const void* g1, const void* be1, const void* wqkv, const void* bqkv, const void* wproj,
    const void* bproj, const void* g2, const void* be2, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* dp, void* dx, void* dg1, void* db1,
    void* dwqkv, void* dbqkv, void* dwproj, void* dbproj, void* dg2, void* db2, void* dw1,
    void* dbm1, void* dw2, void* dbm2, void* dbias, void* work, int B, int H, int W, int C,
    int hidden, int ws, int heads, int shift, float scale, int* launches, void* stream) {
  if (!bwd_takes(H, W, C, hidden, ws, heads, true) || B <= 0 || dp == nullptr || eb == nullptr ||
      rden == nullptr || ctxf == nullptr)
    return (int)cudaErrorInvalidValue;
  BwdArgs a{(const bf16*)x,     (const bf16*)dout,  (const float*)g1,   (const float*)be1,
            (const bf16*)wqkv,  (const float*)bqkv, (const bf16*)wproj, (const float*)bproj,
            (const float*)g2,   (const float*)be2,  (const bf16*)w1,    (const float*)b1,
            (const bf16*)w2,    (const float*)b2,   nullptr,            nullptr,
            (const float*)dp,   (bf16*)dx,          (float*)dg1,        (float*)db1,
            (float*)dwqkv,      (float*)dbqkv,      (float*)dwproj,     (float*)dbproj,
            (float*)dg2,        (float*)db2,        (float*)dw1,        (float*)dbm1,
            (float*)dw2,        (float*)dbm2,       (float*)dbias,      B,
            H,                  W,                  C,                  hidden,
            ws,                 heads,              shift,              scale,
            (const bf16*)eb,    (const float*)rden, (const float*)ctxf};
  const BwdWork w = carve_bwd((unsigned char*)work, B, H, W, C, hidden, ws, heads, true);
  *launches = 0;
  return (int)block_bwd<true>(a, w, (cudaStream_t)stream, launches);
}
