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
// (5 us at the 989 TFLOP/s bf16 peak) against ~20 MB of activations and
// intermediates, which stay in the 50 MB L2 at these shapes (HBM bound
// ~6 us at 3.35 TB/s).
//
// Design, first version (right and simple): one 64-token window's backward
// live set (x, LN1(x), q/k/v, ctx, y, LN2(y), the fp32 fc1 pre-activation,
// 384 KB at C=384, and their gradients) does not fit one CTA's 227 KB, so
// the block runs as a fixed sequence of launches over all B*H*W tokens in
// window-major (rolled) order, with the per-token intermediates in device
// memory: row kernels (LayerNorm forward and backward, the dout gather), a
// tiled bf16 tensor-core GEMM (train_common.cuh) for every product with its
// elementwise step in the epilogue, and a per-(head, window) attention
// kernel that recomputes P on chip. The SW roll is load/store addressing
// (token_offset) on x, dout and dx. Weight grads sum over tokens in fixed
// chunks, then in a fixed order (deterministic). Fusing the sequence back
// into fewer, larger kernels (wgmma, TMA) is later work.
#include "swin_block_bwd.cuh"

using namespace sunet;

extern "C" size_t sunet_swin_block_bwd_workspace(int B, int H, int W, int C, int hidden, int ws,
                                                 int heads) {
  return carve_bwd(nullptr, B * H * W, C, hidden, heads, ws * ws, false).bytes;
}

extern "C" int sunet_swin_block_bwd(
    const void* x, const void* dout, const void* g1, const void* be1, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* g2, const void* be2,
    const void* w1, const void* b1, const void* w2, const void* b2, const void* bias,
    const void* mask, const void* dp, void* dx, void* dg1, void* db1, void* dwqkv, void* dbqkv,
    void* dwproj, void* dbproj, void* dg2, void* db2, void* dw1, void* dbm1, void* dw2,
    void* dbm2, void* dbias, void* work, int B, int H, int W, int C, int hidden, int ws,
    int heads, int shift, float scale, int* launches, void* stream) {
  const int N = ws * ws;
  if (N > 64 || C % 32 || C > kLnMaxC || C % heads || hidden % 16 || H % ws || W % ws ||
      dp == nullptr)
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
  const BwdWork w = carve_bwd((unsigned char*)work, B * H * W, C, hidden, heads, N, false);
  *launches = 0;
  return (int)block_bwd<false>(a, w, (cudaStream_t)stream, launches);
}
