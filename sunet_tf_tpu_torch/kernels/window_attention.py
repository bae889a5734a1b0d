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


def ln32(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
         eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in float32 (float32 result)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    return xc * inv * g.float() + b.float()


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


def _mlp_tail(y, ln, w1, b1, w2, b2):
    """round(y + fc2(gelu(fc1(LN(y)))))."""
    dt = y.dtype
    yn = ln32(y, *ln).to(dt)
    h1 = gelu_erf(mm32(yn, w1) + b1.float()).to(dt)
    return (y.float() + mm32(h1, w2) + b2.float()).to(dt)


# ---------------------------------------------------------------- plain versions


def fused_swin_block_reference(x, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1,
                               w2, b2, bias, mask, *, ws: int, num_heads: int,
                               scale: float, shift: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_swin_block`."""
    with exact_fp32():
        dt = x.dtype
        B, H, W, C = x.shape
        xr = roll2d(x, -shift)
        ctx = _qkv_ctx(ln32(xr, *ln1).to(dt), wqkv, bqkv, bias, mask, ws,
                       num_heads, scale)
        attn = window_reverse(mm32(ctx, wproj) + bproj.float(), ws, H, W)
        y = (xr.float() + attn).to(dt)
        return roll2d(_mlp_tail(y, ln2, w1, b1, w2, b2), shift)


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


def _launch_block(x, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2, b2, bias,
                  mask, *, ws: int, num_heads: int, scale: float,
                  shift: int) -> torch.Tensor:
    name = "fused_swin_block"
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
    dev = x.device
    f = lambda t: _f32(t, dev)
    args = [f(ln1[0]), f(ln1[1]), wqkv, f(bqkv), wproj, f(bproj),
            f(ln2[0]), f(ln2[1]), w1, f(b1), w2, f(b2), f(bias), f(mask)]
    out = torch.empty_like(x)
    lib = _build.library()
    err = lib.sunet_swin_block(
        _build.ptr(x), _build.ptr(out), *[_build.ptr(a) for a in args],
        B, H, W, C, hidden, ws, num_heads, shift, float(scale), _build.stream())
    _build.check(name, err)
    return out


# ---------------------------------------------------------------- wrappers


def fused_swin_block(x, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2, b2,
                     bias, mask, *, ws: int, num_heads: int, scale: float,
                     shift: int = 0) -> torch.Tensor:
    """One whole Swin block over an NHWC map, x UNROLLED (caller
    coordinates). With ``shift > 0`` the SW-MSA roll and unroll happen
    inside the kernel as load/store addressing; ``mask`` is the
    rolled-space SW-MSA mask (None when shift == 0)."""
    count = _build.counter("fused_swin_block")
    if x.device.type == "cpu":
        count.cpu += 1
        return fused_swin_block_reference(
            x, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2, b2, bias, mask,
            ws=ws, num_heads=num_heads, scale=scale, shift=shift)
    out = _launch_block(x, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2, b2,
                        bias, mask, ws=ws, num_heads=num_heads, scale=scale,
                        shift=shift)
    count.cuda += 1
    return out


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
