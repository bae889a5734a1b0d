"""The x4 dual up-sample head fused with the 3x3 output conv, in phase space.

Counterpart of ``sunet_tf_tpu/kernels/upsample.py::
fused_dual_upsample4_conv_phase``: from a low-res map x (B, H, W, C) it
returns (B, H, W, 16*out) where channels (i*4+j)*out .. +out at base (h, w)
hold the output conv at pixel (4h+i, 4w+j). The 4x-upsampled map never
exists in device memory. CUDA: ``csrc/up4_conv.cu``.

Head math (the three weight-space folds of the JAX ``DualUpsample``):
pixel-shuffle branch ``prelu(x @ w_exp_s) @ wpf`` per subpixel s; bilinear
branch ``prelu(x @ w_b1 + b_b1) @ wbf`` at low res, then the separable
half-pixel x4 stencil with EDGE-CLAMPED taps; phase map = round(sum). The
3x3 bias-free output conv then runs over the phase maps with ZERO padding
at the image edge. The two edge rules differ on purpose.

Dispatch as in :mod:`.window_attention`: CPU tensor -> plain version, CUDA
tensor -> kernel or raise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sunet_tf_tpu_torch.kernels import _build
from sunet_tf_tpu_torch.kernels.window_attention import (BF16, _check_w,
                                                         _check_x, exact_fp32,
                                                         mm32)

# Half-pixel x4 phase weights: output row 4h+p samples input at
# h + (2p-3)/8 -> taps (h-1, h) for p = 0, 1 and (h, h+1) for p = 2, 3.
P4 = ((0.375, 0.625), (0.125, 0.875), (0.875, 0.125), (0.625, 0.375))
# The kernel stages the 16 phase maps of a tile in shared memory: C <= 96.
UP4_KERNEL_MAX_C = 96
UP4_KERNEL_MAX_OUT = 8


def _prelu(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0) + a * torch.clamp_max(x, 0)


def _stencil_x4(t: torch.Tensor, axis: int) -> list:
    """The 4 half-pixel phases of a x4 bilinear up-sample along ``axis``
    (edge-clamped taps), each the input's size."""
    n = t.shape[axis]
    pad = torch.cat([t.narrow(axis, 0, 1), t, t.narrow(axis, n - 1, 1)], axis)
    lo, mid, hi = (pad.narrow(axis, o, n) for o in range(3))
    taps = ((lo, mid), (lo, mid), (mid, hi), (mid, hi))
    return [a * u + b * v for (a, b), (u, v) in zip(P4, taps)]


def phase_to_pixel(o: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 16*out) phase tensor -> (B, 4H, 4W, out) pixels."""
    B, H, W, O = o.shape
    out_ch = O // 16
    o = o.reshape(B, H, W, 4, 4, out_ch).permute(0, 1, 3, 2, 4, 5)
    return o.reshape(B, 4 * H, 4 * W, out_ch)


def _pixel_to_phase(p: torch.Tensor) -> torch.Tensor:
    B, H4, W4, out_ch = p.shape
    H, W = H4 // 4, W4 // 4
    p = p.reshape(B, H, 4, W, 4, out_ch).permute(0, 1, 3, 2, 4, 5)
    return p.reshape(B, H, W, 16 * out_ch)


def fused_dual_upsample4_conv_phase_reference(x, w_exp, alpha_p, w_b1, b_b1,
                                              alpha_b, wpf, wbf, wconv):
    """Plain PyTorch version of :func:`fused_dual_upsample4_conv_phase`."""
    with exact_fp32():
        dt = x.dtype
        B, H, W, C = x.shape
        ap = alpha_p.float().reshape(())
        ab = alpha_b.float().reshape(())
        zb = _prelu(mm32(x, w_b1) + b_b1.float(), ab).to(dt)
        xb = mm32(zb, wbf)
        yh = _stencil_x4(xb, 1)
        st = [_stencil_x4(t, 2) for t in yh]          # st[i][j]
        wexp_s = w_exp.reshape(C, C, 16).permute(2, 0, 1)
        ys = []
        for s in range(16):
            z = _prelu(mm32(x, wexp_s[s]), ap).to(dt)
            ys.append((mm32(z, wpf) + st[s // 4][s % 4]).to(dt))
        # pixel-space head map, then the zero-padded 3x3 conv in float32
        y = torch.stack(ys).reshape(4, 4, B, H, W, C)
        y = y.permute(2, 3, 0, 4, 1, 5).reshape(B, 4 * H, 4 * W, C)
        o = F.conv2d(y.float().permute(0, 3, 1, 2),
                     wconv.float().permute(3, 2, 0, 1), padding=1)
        return _pixel_to_phase(o.permute(0, 2, 3, 1)).to(dt)


def fused_dual_upsample4_conv_phase(x, w_exp, alpha_p, w_b1, b_b1, alpha_b,
                                    wpf, wbf, wconv) -> torch.Tensor:
    """x4 dual up-sample + 3x3 output conv (no bias) in phase space.

    x: (B, H, W, C); w_exp: (C, 16C) pixel-shuffle expand, (in, out) layout;
    w_b1: (C, C), b_b1: (C,); wpf, wbf: (C, C) folded projections;
    wconv: (3, 3, C, out) HWIO. Returns (B, H, W, 16*out) in x's dtype."""
    name = "fused_dual_upsample4_conv_phase"
    count = _build.counter(name)
    if x.device.type == "cpu":
        count.cpu += 1
        return fused_dual_upsample4_conv_phase_reference(
            x, w_exp, alpha_p, w_b1, b_b1, alpha_b, wpf, wbf, wconv)
    _check_x(name, x)
    B, H, W, C = x.shape
    out_ch = wconv.shape[-1]
    if C % 16 or C > UP4_KERNEL_MAX_C or not 1 <= out_ch <= UP4_KERNEL_MAX_OUT:
        raise ValueError(f"{name}: C={C}, out={out_ch}: the kernel takes C a "
                         f"multiple of 16 up to {UP4_KERNEL_MAX_C} and "
                         f"1 <= out <= {UP4_KERNEL_MAX_OUT}")
    if H % 2 or W % 8:
        raise ValueError(f"{name}: ({H},{W}) must be multiples of (2, 8)")
    _check_w(name, x, w_exp=(w_exp, (C, 16 * C)), w_b1=(w_b1, (C, C)),
             wpf=(wpf, (C, C)), wbf=(wbf, (C, C)),
             wconv=(wconv, (3, 3, C, out_ch)))
    wexp_s = w_exp.reshape(C, C, 16).permute(2, 0, 1).contiguous()
    alphas = torch.stack([alpha_p.reshape(()), alpha_b.reshape(())]).to(
        device=x.device, dtype=torch.float32)
    bb1 = b_b1.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty((B, H, W, 16 * out_ch), device=x.device, dtype=BF16)
    err = _build.library().sunet_up4_conv_phase(
        _build.ptr(x), _build.ptr(out), _build.ptr(wexp_s), _build.ptr(w_b1),
        _build.ptr(bb1), _build.ptr(wpf), _build.ptr(wbf), _build.ptr(wconv),
        _build.ptr(alphas), B, H, W, C, out_ch, _build.stream())
    _build.check(name, err)
    count.cuda += 1
    return out
