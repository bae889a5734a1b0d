"""Swin-block kernels: wrappers over the hand-written CUDA kernels, each
with its plain PyTorch version beside it.

Counterparts of ``sunet_tf_tpu/kernels/window_attention.py``:

- :func:`fused_swin_block` (JAX ``fused_swin_block``): one whole block,
  LN1 -> W-MSA (+ in-kernel SW roll) -> proj -> residual -> LN2 -> MLP ->
  residual. CUDA: ``csrc/swin_block.cu``.
- :func:`fused_swin_block_chain` (JAX ``fused_swin_block_chain``): K
  consecutive blocks with a bf16 cast at each seam; launches the block
  kernel K times (keeping the map on chip between blocks is open work).
- :func:`fused_ln_window_attention` (JAX ``fused_ln_window_attention``):
  LN -> W-MSA -> proj, no residual; two launches (per-head ctx, then the
  projection). CUDA: ``csrc/ln_window_attention.cu``.
- :func:`fused_ln_mlp` (JAX ``fused_ln_mlp``): ``y + fc2(gelu(fc1(LN(y))))``.
  CUDA: ``csrc/ln_mlp.cu``.
- :func:`swin_block_bwd` (JAX ``_block_bwd_impl``): the whole block's
  backward, recompute form. CUDA: ``csrc/swin_block_bwd.cu``.
  :class:`SwinBlockTrainable` pairs it with :func:`fused_swin_block`'s
  train form (per-image drop-path scales) for autograd.

Arguments follow the JAX functions: NHWC activations, weight matrices in
(in, out) layout and in the compute dtype, LN parameters and biases in any
float dtype (used as float32), rel-pos bias (h, N, N), mask (nW, N, N) in
rolled coordinates or None.

Rounding points (those of the JAX kernel body ``_block_body``): LN stats in
float32; qkv accumulated in float32 then rounded; ``q*scale`` rounded;
scores float32 + bias + mask; exact row-max softmax with the divide after
``P@V`` (P rounded); ctx rounded; ``y = round(x + attn)``; fc1 accumulated
in float32 -> exact-erf GELU in float32 -> rounded -> fc2 accumulated in
float32; output rounded. GELU is the exact erf form of the XLA path, not
the JAX kernels' tanh form.

Dispatch: a tensor on the CPU goes to the plain version; a CUDA tensor
launches the kernel or raises. There is no fallback between the two. Each
wrapper's count goes up by one per kernel launch (``_build.LaunchCount``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from sunet_tf_tpu_torch.kernels import _build
from sunet_tf_tpu_torch.ops.window import roll2d, window_partition, window_reverse

BF16 = torch.bfloat16
# Largest C the whole-block kernel takes: shared memory of one CTA holds
# x, LN(x) and ctx for a 64-token window plus one head's q/k/v and scores
# (215,808 bytes at C=384, of 232,448). Wider blocks take the split
# LN+W-MSA / LN+MLP kernels.
BLOCK_KERNEL_MAX_C = 384
# Kernel launches one swin_block_bwd call makes (csrc/swin_block_bwd.cu:
# the forward recompute, the backward products and the token reductions).
SWIN_BLOCK_BWD_LAUNCHES = 35


@contextlib.contextmanager
def exact_fp32():
    """float32 products in float32: no TF32 in cuBLAS or cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with float32 accumulation of the (possibly bf16) operands."""
    return torch.matmul(a.float(), b.float())


def _ln_stats(x: torch.Tensor, eps: float = 1e-5):
    """(xhat, inv) of a LayerNorm over the last axis, float32."""
    xf = x.float()
    xc = xf - xf.mean(-1, keepdim=True)
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    return xc * inv, inv


def ln32(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
         eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in float32 (float32 result)."""
    return _ln_stats(x, eps)[0] * g.float() + b.float()


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))


def attn_core_reference(q, k, v, bias, mask, *, num_heads: int, scale: float):
    """Windowed multi-head attention core: q, k, v (Bn, N, C) in the compute
    dtype -> float32 ctx (Bn, N, C), exact row-max softmax, divide after P@V."""
    Bn, N, C = q.shape
    h = num_heads
    d = C // h
    dt = q.dtype
    qs = (q.float() * scale).to(dt)
    heads = lambda t: t.reshape(Bn, N, h, d).permute(0, 2, 1, 3)
    s = mm32(heads(qs), heads(k).transpose(-1, -2)) + bias.float()[None]
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(Bn // nW, nW, h, N, N)
             + mask.float()[None, :, None]).reshape(Bn, h, N, N)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    den = e.sum(-1, keepdim=True)
    ctx = mm32(e.to(dt), heads(v)) / den.clamp_min(1e-37)
    return ctx.permute(0, 2, 1, 3).reshape(Bn, N, C)


def _qkv_ctx(xn, wqkv, bqkv, bias, mask, ws, num_heads, scale):
    """LN'd NHWC map -> rounded ctx windows (B*nW, N, C)."""
    dt = xn.dtype
    C = xn.shape[-1]
    xw = window_partition(xn, ws)
    qkv = mm32(xw, wqkv)
    if bqkv is not None:
        qkv = qkv + bqkv.float()
    qkv = qkv.to(dt)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    return attn_core_reference(q, k, v, bias, mask, num_heads=num_heads,
                               scale=scale).to(dt)


def _mlp_tail(y, ln, w1, b1, w2, b2, s2=None):
    """round(y + s2 * fc2(gelu(fc1(LN(y))))); s2 per image or None (1)."""
    dt = y.dtype
    yn = ln32(y, *ln).to(dt)
    h1 = gelu_erf(mm32(yn, w1) + b1.float()).to(dt)
    m = mm32(h1, w2) + b2.float()
    return (y.float() + (m if s2 is None else s2 * m)).to(dt)


def _dp_scales(dp, B: int):
    """(B, 2) drop-path scales -> two (B, 1, 1, 1) float32 tensors (or None)."""
    if dp is None:
        return None, None
    dp = dp.float().reshape(B, 2)
    return dp[:, 0].reshape(B, 1, 1, 1), dp[:, 1].reshape(B, 1, 1, 1)


def gelu_erf_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx of the exact-erf GELU: Phi(x) + x * phi(x)."""
    cdf = 0.5 * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))
    return cdf + x * torch.exp(-0.5 * x * x) * (1.0 / math.sqrt(2.0 * math.pi))


def _ln_bwd_dx(dxhat, xhat, inv):
    """LN input cotangent inv * (dxhat - mean(dxhat) - xhat * mean(dxhat*xhat))."""
    return inv * (dxhat - dxhat.mean(-1, keepdim=True)
                  - xhat * (dxhat * xhat).mean(-1, keepdim=True))


# ---------------------------------------------------------------- plain versions


def fused_swin_block_reference(x, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1,
                               w2, b2, bias, mask, drop_path_scale=None, *,
                               ws: int, num_heads: int, scale: float,
                               shift: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_swin_block`."""
    with exact_fp32():
        dt = x.dtype
        B, H, W, C = x.shape
        s1, s2 = _dp_scales(drop_path_scale, B)
        xr = roll2d(x, -shift)
        ctx = _qkv_ctx(ln32(xr, *ln1).to(dt), wqkv, bqkv, bias, mask, ws,
                       num_heads, scale)
        attn = window_reverse(mm32(ctx, wproj) + bproj.float(), ws, H, W)
        y = (xr.float() + (attn if s1 is None else s1 * attn)).to(dt)
        return roll2d(_mlp_tail(y, ln2, w1, b1, w2, b2, s2), shift)


def swin_block_bwd_reference(x, dout, ln1, wqkv, bqkv, wproj, bproj, ln2, w1,
                             b1, w2, b2, bias, mask, drop_path_scale, *,
                             ws: int, num_heads: int, scale: float,
                             shift: int = 0) -> tuple:
    """Plain PyTorch version of :func:`swin_block_bwd`, written step by step
    after the JAX ``_block_bwd_kernel`` with its rounding points: the block
    is recomputed (LN1, qkv, per-head softmax P in float32, ctx =
    round(round(P) @ v), y, LN2, fc1 pre-activation a), then

      dm = round(s2*dout); dw2 = hgelu^T dm; da = (dm w2^T) * gelu'(a);
      dab = round(da); dw1 = yn^T dab; dy = dout + LN2^T(dab w1^T);
      dattn = round(s1*dy); dwproj = ctx^T dattn; dctx = dattn wproj^T;
      per head: dP = round(dctx) v^T, dv = round(P)^T round(dctx),
      ds = P*(dP - rowsum(dP*P)), dq = round(ds) k * scale,
      dk = round(ds)^T round(q*scale); dbias = sum of ds over windows;
      dwqkv = u^T round(dqkv); dx = dy + LN1^T(round(dqkv) wqkv^T).

    Returns (dx in x's dtype, then float32 grads of ln1 g/b, wqkv, bqkv,
    wproj, bproj, ln2 g/b, w1, b1, w2, b2 and bias (h, N, N)). Weight
    grads are (in, out) like the weights."""
    with exact_fp32():
        dt = x.dtype
        B, H, W, C = x.shape
        h, d, N = num_heads, C // num_heads, ws * ws
        nW = (H // ws) * (W // ws)
        s1, s2 = _dp_scales(drop_path_scale, B)
        if s1 is None:
            s1 = s2 = torch.ones(B, 1, 1, 1, device=x.device)
        f = lambda t: t.float()
        win = lambda t: window_partition(t, ws).reshape(-1, t.shape[-1])
        unwin = lambda t: window_reverse(t.reshape(-1, N, t.shape[-1]), ws, H, W)
        heads = lambda t: t.reshape(B * nW, N, h, d).permute(0, 2, 1, 3)
        unheads = lambda t: t.permute(0, 2, 1, 3).reshape(B * nW * N, C)

        # forward recompute
        xr = roll2d(x, -shift)
        xhat1, inv1 = _ln_stats(xr)
        u = (xhat1 * f(ln1[0]) + f(ln1[1])).to(dt)
        uw = win(u)
        qkv = mm32(uw, wqkv)
        if bqkv is not None:
            qkv = qkv + f(bqkv)
        qkv = qkv.to(dt)
        q, k, v = (heads(qkv[:, i * C:(i + 1) * C]) for i in range(3))
        qs = (q.float() * scale).to(dt)
        s = mm32(qs, k.transpose(-1, -2)) + f(bias)[None]
        if mask is not None:
            s = (s.reshape(B, nW, h, N, N) + f(mask)[None, :, None]).reshape(
                B * nW, h, N, N)
        P = torch.softmax(s, dim=-1)
        ctx = unheads(mm32(P.to(dt), v)).to(dt)                   # (T, C)
        attn = unwin(mm32(ctx, wproj) + f(bproj))
        y = (xr.float() + s1 * attn).to(dt)
        yhat2, inv2 = _ln_stats(y)
        yn = (yhat2 * f(ln2[0]) + f(ln2[1])).to(dt).reshape(-1, C)
        a = mm32(yn, w1) + f(b1)
        hgelu = gelu_erf(a).to(dt)

        # MLP sublayer
        dout32 = roll2d(dout.to(dt), -shift).float()
        dm = (s2 * dout32).to(dt).reshape(-1, C)
        dw2 = mm32(hgelu.t(), dm)
        dbm2 = dm.float().sum(0)
        da = mm32(dm, w2.t()) * gelu_erf_grad(a)
        dab = da.to(dt)
        dw1 = mm32(yn.t(), dab)
        dbm1 = da.sum(0)
        dyn = mm32(dab, w1.t()).reshape(B, H, W, C)
        dg2 = (dyn * yhat2).sum((0, 1, 2))
        db2 = dyn.sum((0, 1, 2))
        dy = dout32 + _ln_bwd_dx(dyn * f(ln2[0]), yhat2, inv2)

        # attention sublayer
        dattn = win((s1 * dy).to(dt))                              # (T, C)
        dwproj = mm32(ctx.t(), dattn)
        dbproj = dattn.float().sum(0)
        dctx = heads(mm32(dattn, wproj.t()).to(dt))
        dP = mm32(dctx, v.transpose(-1, -2))
        dv = mm32(P.to(dt).transpose(-1, -2), dctx)
        ds = P * (dP - (dP * P).sum(-1, keepdim=True))
        dbias = ds.sum(0)
        dsb = ds.to(dt)
        dq = mm32(dsb, k) * scale
        dk = mm32(dsb.transpose(-1, -2), qs)
        dqkv = torch.cat([unheads(dq), unheads(dk), unheads(dv)], dim=-1)
        dqkv_b = dqkv.to(dt)
        dwqkv = mm32(uw.t(), dqkv_b)
        dbqkv = dqkv.sum(0)
        du = unwin(mm32(dqkv_b, wqkv.t()))
        dg1 = (du * xhat1).sum((0, 1, 2))
        db1 = du.sum((0, 1, 2))
        dx = dy + _ln_bwd_dx(du * f(ln1[0]), xhat1, inv1)
        dx = roll2d(dx, shift).to(dt)
        return (dx, dg1, db1, dwqkv, dbqkv, dwproj, dbproj, dg2, db2, dw1,
                dbm1, dw2, dbm2, dbias)


def fused_ln_window_attention_reference(x, ln_scale, ln_bias, wqkv, bqkv,
                                        wproj, bproj, bias, mask, *, ws: int,
                                        num_heads: int,
                                        scale: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_ln_window_attention`."""
    with exact_fp32():
        dt = x.dtype
        B, H, W, C = x.shape
        ctx = _qkv_ctx(ln32(x, ln_scale, ln_bias).to(dt), wqkv, bqkv, bias,
                       mask, ws, num_heads, scale)
        out = (mm32(ctx, wproj) + bproj.float()).to(dt)
        return window_reverse(out, ws, H, W)


def fused_ln_mlp_reference(y, ln, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_ln_mlp`."""
    with exact_fp32():
        return _mlp_tail(y, ln, w1, b1, w2, b2)


# ---------------------------------------------------------------- CUDA launches


def _f32(t: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    return None if t is None else t.to(device=device, dtype=torch.float32).contiguous()


def _check_x(name: str, x: torch.Tensor):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensor on {x.device}; the kernel takes CUDA "
                         "tensors and the plain version CPU tensors")
    if x.dtype != BF16:
        raise NotImplementedError(
            f"{name}: the CUDA kernel takes bfloat16, got {x.dtype} (float32 "
            "kernels are ROADMAP queue B, 'fp32 kernels'; use backend='eager')")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous NHWC tensor, got "
                         f"shape {tuple(x.shape)}")


def _check_w(name: str, x: torch.Tensor, **ws):
    for wname, (w, shape) in ws.items():
        if w.device != x.device or w.dtype != BF16 or not w.is_contiguous():
            raise ValueError(f"{name}: {wname} must be a contiguous bfloat16 "
                             f"tensor on {x.device}")
        if tuple(w.shape) != tuple(shape):
            raise ValueError(f"{name}: {wname} has shape {tuple(w.shape)}, "
                             f"expected {tuple(shape)}")


def _check_window(name: str, H, W, C, ws, num_heads, bias, mask):
    N = ws * ws
    if H % ws or W % ws:
        raise ValueError(f"{name}: ({H},{W}) not divisible by window {ws}")
    if N % 16 or N > 64:
        raise ValueError(f"{name}: window {ws} gives {N} tokens; the kernel "
                         "takes 16, 32, 48 or 64")
    if C % 16 or C % num_heads:
        raise ValueError(f"{name}: C={C} must be a multiple of 16 and of heads")
    if tuple(bias.shape) != (num_heads, N, N):
        raise ValueError(f"{name}: bias shape {tuple(bias.shape)}")
    nW = (H // ws) * (W // ws)
    if mask is not None and tuple(mask.shape) != (nW, N, N):
        raise ValueError(f"{name}: mask shape {tuple(mask.shape)}")


def _check_block(name, x, wqkv, wproj, w1, w2, bias, mask, ws, num_heads,
                 shift, dp):
    _check_x(name, x)
    B, H, W, C = x.shape
    hidden = w1.shape[1]
    if C > BLOCK_KERNEL_MAX_C:
        raise ValueError(f"{name}: C={C} above the block-kernel cap "
                         f"{BLOCK_KERNEL_MAX_C}; route through "
                         "fused_ln_window_attention + fused_ln_mlp")
    if hidden % 16:
        raise ValueError(f"{name}: hidden {hidden} not a multiple of 16")
    _check_w(name, x, wqkv=(wqkv, (C, 3 * C)), wproj=(wproj, (C, C)),
             w1=(w1, (C, hidden)), w2=(w2, (hidden, C)))
    _check_window(name, H, W, C, ws, num_heads, bias, mask)
    if not 0 <= shift < ws:
        raise ValueError(f"{name}: shift {shift} outside [0, {ws})")
    if dp is not None and tuple(dp.shape) != (B, 2):
        raise ValueError(f"{name}: drop_path_scale shape {tuple(dp.shape)}, "
                         f"expected {(B, 2)}")


def _launch_block(x, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2, b2, bias,
                  mask, dp=None, *, ws: int, num_heads: int, scale: float,
                  shift: int) -> torch.Tensor:
    _check_block("fused_swin_block", x, wqkv, wproj, w1, w2, bias, mask, ws,
                 num_heads, shift, dp)
    B, H, W, C = x.shape
    dev = x.device
    f = lambda t: _f32(t, dev)
    args = [f(ln1[0]), f(ln1[1]), wqkv, f(bqkv), wproj, f(bproj),
            f(ln2[0]), f(ln2[1]), w1, f(b1), w2, f(b2), f(bias), f(mask), f(dp)]
    out = torch.empty_like(x)
    lib = _build.library()
    err = lib.sunet_swin_block(
        _build.ptr(x), _build.ptr(out), *[_build.ptr(a) for a in args],
        B, H, W, C, w1.shape[1], ws, num_heads, shift, float(scale),
        _build.stream())
    _build.check("fused_swin_block", err)
    return out


# ---------------------------------------------------------------- wrappers


def fused_swin_block(x, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2, b2,
                     bias, mask, drop_path_scale=None, *, ws: int,
                     num_heads: int, scale: float,
                     shift: int = 0) -> torch.Tensor:
    """One whole Swin block over an NHWC map, x UNROLLED (caller
    coordinates). With ``shift > 0`` the SW-MSA roll and unroll happen
    inside the kernel as load/store addressing; ``mask`` is the
    rolled-space SW-MSA mask (None when shift == 0). ``drop_path_scale``:
    optional (B, 2) float32 per-image scales of the attention and MLP
    branches (stochastic depth); None means ones."""
    count = _build.counter("fused_swin_block")
    if x.device.type == "cpu":
        count.cpu += 1
        return fused_swin_block_reference(
            x, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2, b2, bias, mask,
            drop_path_scale, ws=ws, num_heads=num_heads, scale=scale,
            shift=shift)
    out = _launch_block(x, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2, b2,
                        bias, mask, drop_path_scale, ws=ws,
                        num_heads=num_heads, scale=scale, shift=shift)
    count.cuda += 1
    return out


def swin_block_bwd(x, dout, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2,
                   b2, bias, mask, drop_path_scale, *, ws: int,
                   num_heads: int, scale: float, shift: int = 0) -> tuple:
    """Backward of :func:`fused_swin_block` (JAX ``_block_bwd_impl``, the
    recompute form): x UNROLLED as in the forward, dout its cotangent.
    Returns (dx, then float32 grads of ln1 g/b, wqkv, bqkv, wproj, bproj,
    ln2 g/b, w1, b1, w2, b2, bias). CUDA: ``csrc/swin_block_bwd.cu``, a
    fixed sequence of launches, each counted."""
    name = "swin_block_bwd"
    count = _build.counter(name)
    if x.device.type == "cpu":
        count.cpu += SWIN_BLOCK_BWD_LAUNCHES
        return swin_block_bwd_reference(
            x, dout, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2, b2, bias,
            mask, drop_path_scale, ws=ws, num_heads=num_heads, scale=scale,
            shift=shift)
    _check_block(name, x, wqkv, wproj, w1, w2, bias, mask, ws, num_heads,
                 shift, drop_path_scale)
    B, H, W, C = x.shape
    hidden = w1.shape[1]
    dev = x.device
    f = lambda t: _f32(t, dev)
    dout = dout.to(BF16).contiguous()
    dp = (torch.ones(B, 2, device=dev) if drop_path_scale is None
          else f(drop_path_scale))
    lib = _build.library()
    ws_bytes = lib.sunet_swin_block_bwd_workspace(B, H, W, C, hidden, ws,
                                                  num_heads)
    work = torch.empty(ws_bytes, device=dev, dtype=torch.uint8)
    dx = torch.empty_like(x)
    z = lambda *s: torch.empty(*s, device=dev, dtype=torch.float32)
    grads = [z(C), z(C), z(C, 3 * C), z(3 * C), z(C, C), z(C), z(C), z(C),
             z(C, hidden), z(hidden), z(hidden, C), z(C),
             z(num_heads, ws * ws, ws * ws)]
    args = [f(ln1[0]), f(ln1[1]), wqkv, f(bqkv), wproj, f(bproj), f(ln2[0]),
            f(ln2[1]), w1, f(b1), w2, f(b2), f(bias), f(mask), dp]
    launches = _build.c_int(0)
    err = lib.sunet_swin_block_bwd(
        _build.ptr(x), _build.ptr(dout), *[_build.ptr(a) for a in args],
        _build.ptr(dx), *[_build.ptr(g) for g in grads], _build.ptr(work),
        B, H, W, C, hidden, ws, num_heads, shift, float(scale),
        _build.byref(launches), _build.stream())
    _build.check(name, err)
    count.cuda += launches.value
    return (dx, *grads)


class SwinBlockTrainable(torch.autograd.Function):
    """Differentiable whole Swin block (JAX ``swin_block_trainable``):
    forward = the block kernel with per-image drop-path scales ``dp``,
    backward = :func:`swin_block_bwd`. Weights come in float32, (in, out)
    layout, and are cast to x's dtype for the kernels; their grads come back
    in float32. ``dp``, ``mask`` and the static arguments get no gradient."""

    @staticmethod
    def forward(ctx, x, ln1_s, ln1_b, wqkv, bqkv, wproj, bproj, ln2_s, ln2_b,
                w1, b1, w2, b2, bias, dp, mask, ws, num_heads, scale, shift):
        dt = x.dtype
        cast = lambda w: w.detach().to(dt).contiguous()
        x = x.contiguous()
        p = (ln1_s.detach(), ln1_b.detach(), cast(wqkv),
             None if bqkv is None else bqkv.detach(), cast(wproj),
             bproj.detach(), ln2_s.detach(), ln2_b.detach(), cast(w1),
             b1.detach(), cast(w2), b2.detach(), bias.detach())
        ctx.save_for_backward(x, dp, mask, *p)
        ctx.static = (ws, num_heads, scale, shift)
        return fused_swin_block(
            x, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10],
            p[11], p[12], mask, dp, ws=ws, num_heads=num_heads, scale=scale,
            shift=shift)

    @staticmethod
    def backward(ctx, dout):
        ws, num_heads, scale, shift = ctx.static
        x, dp, mask, *p = ctx.saved_tensors
        g = list(swin_block_bwd(
            x, dout.contiguous(), p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8],
            p[9], p[10], p[11], p[12], mask, dp, ws=ws, num_heads=num_heads,
            scale=scale, shift=shift))
        if p[3] is None:
            g[4] = None
        return (*g, None, None, None, None, None, None)


def fused_swin_block_chain(x, params_list: list, biases: list, mask, *,
                           ws: int, num_heads: int, scale: float,
                           shifts: tuple) -> torch.Tensor:
    """K consecutive Swin blocks (inference), x UNROLLED.

    params_list: K 12-tuples (ln1_s, ln1_b, wqkv, bqkv, wproj, bproj, ln2_s,
    ln2_b, w1, b1, w2, b2); biases: K (h, N, N); shifts: K shift sizes (0 =
    W-MSA, >0 = SW-MSA with the shared rolled-space ``mask``). Equals K
    :func:`fused_swin_block` calls exactly: the output of each block is
    rounded to the compute dtype at the seam."""
    K = len(params_list)
    if not (K == len(biases) == len(shifts) and K >= 1):
        raise ValueError("fused_swin_block_chain: params, biases and shifts "
                         "must have the same length >= 1")
    count = _build.counter("fused_swin_block_chain")
    on_cpu = x.device.type == "cpu"
    run = fused_swin_block_reference if on_cpu else _launch_block
    for p, bias, s in zip(params_list, biases, shifts):
        x = run(x, p[0:2], *p[2:6], p[6:8], *p[8:12], bias, mask if s else None,
                ws=ws, num_heads=num_heads, scale=scale, shift=s)
        if on_cpu:
            count.cpu += 1
        else:
            count.cuda += 1
    return x


def fused_ln_window_attention(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                              bias, mask, *, ws: int, num_heads: int,
                              scale: float) -> torch.Tensor:
    """LN + window partition + W-MSA + reverse + proj; x RAW (pre-LN) and
    already rolled by the caller. Returns the sublayer output before the
    residual, NHWC, in x's dtype."""
    name = "fused_ln_window_attention"
    count = _build.counter(name)
    if x.device.type == "cpu":
        count.cpu += 2  # stands in for the ctx and projection launches
        return fused_ln_window_attention_reference(
            x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, bias, mask,
            ws=ws, num_heads=num_heads, scale=scale)
    _check_x(name, x)
    B, H, W, C = x.shape
    _check_w(name, x, wqkv=(wqkv, (C, 3 * C)), wproj=(wproj, (C, C)))
    _check_window(name, H, W, C, ws, num_heads, bias, mask)
    dev = x.device
    f = lambda t: _f32(t, dev)
    lib = _build.library()
    ctx = torch.empty_like(x)
    args = [f(ln_scale), f(ln_bias), wqkv, f(bqkv), f(bias), f(mask)]
    err = lib.sunet_ln_wmsa_ctx(
        _build.ptr(x), _build.ptr(ctx), *[_build.ptr(a) for a in args],
        B, H, W, C, ws, num_heads, float(scale), _build.stream())
    _build.check(name, err)
    count.cuda += 1
    out = torch.empty_like(x)
    err = lib.sunet_linear_bias(
        _build.ptr(ctx), _build.ptr(wproj), _build.ptr(f(bproj)),
        _build.ptr(out), B * H * W, C, C, _build.stream())
    _build.check(name, err)
    count.cuda += 1
    return out


def fused_ln_mlp(y, ln, w1, b1, w2, b2) -> torch.Tensor:
    """y + fc2(gelu(fc1(LN(y)))) over an NHWC map, in y's dtype."""
    name = "fused_ln_mlp"
    count = _build.counter(name)
    if y.device.type == "cpu":
        count.cpu += 1
        return fused_ln_mlp_reference(y, ln, w1, b1, w2, b2)
    _check_x(name, y)
    B, H, W, C = y.shape
    hidden = w1.shape[1]
    if C % 16 or hidden % 16 or C > 768:
        raise ValueError(f"{name}: C={C}, hidden={hidden}: the kernel takes "
                         "multiples of 16 and C <= 768")
    _check_w(name, y, w1=(w1, (C, hidden)), w2=(w2, (hidden, C)))
    dev = y.device
    f = lambda t: _f32(t, dev)
    out = torch.empty_like(y)
    args = [f(ln[0]), f(ln[1]), w1, f(b1), w2, f(b2)]
    err = _build.library().sunet_ln_mlp(
        _build.ptr(y), _build.ptr(out), *[_build.ptr(a) for a in args],
        B * H * W, C, hidden, _build.stream())
    _build.check(name, err)
    count.cuda += 1
    return out
