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

Training: :func:`up4_conv_bwd` (JAX ``_up4c_bwd_impl``, CUDA
``csrc/up4_conv_bwd.cu``) is its backward, and
:class:`DualUpsample4ConvTrainable` pairs the two for autograd.

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
# Kernel launches one up4_conv_bwd call makes (csrc/up4_conv_bwd.cu).
UP4_CONV_BWD_LAUNCHES = 25


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


def _stencil_x4_adjoint(gs: list, axis: int) -> torch.Tensor:
    """Adjoint of :func:`_stencil_x4`: the 4 phase cotangents -> the
    input's cotangent (edge-clamped taps fold back onto the edge)."""
    n = gs[0].shape[axis]
    (a0, b0), (a1, b1), (a2, b2), (a3, b3) = P4
    lo = a0 * gs[0] + a1 * gs[1]
    mid = b0 * gs[0] + b1 * gs[1] + a2 * gs[2] + a3 * gs[3]
    hi = b2 * gs[2] + b3 * gs[3]
    # pad index p = input index + 1; lo reads pad[i], mid pad[i+1], hi pad[i+2]
    d = mid.clone()
    d.narrow(axis, 0, n - 1).add_(lo.narrow(axis, 1, n - 1))
    d.narrow(axis, 1, n - 1).add_(hi.narrow(axis, 0, n - 1))
    d.narrow(axis, 0, 1).add_(lo.narrow(axis, 0, 1))
    d.narrow(axis, n - 1, 1).add_(hi.narrow(axis, n - 1, 1))
    return d


# Per-axis (base offset, phase) slots of the phase-space 3x3 conv: output
# phase i with tap dy reads phase (i+dy) % 4 at base offset floor((i+dy)/4).
USLOTS = ((-1, 3), (0, 0), (0, 1), (0, 2), (0, 3), (1, 0))


def _slot(i: int, dy: int) -> int:
    hi = i + dy
    return USLOTS.index((-1 if hi < 0 else (1 if hi > 3 else 0), hi % 4))


def fold_output_conv4(wconv: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, out) conv weights -> (36*C, 16*out) phase-space fold (JAX
    ``fold_output_conv4``): the column block of output phase (i, j) holds
    its 9 taps, one per (slot_h, slot_w) row block."""
    _, _, C, out = wconv.shape
    w = wconv.new_zeros((36 * C, 16 * out), dtype=torch.float32)
    for i in range(4):
        for j in range(4):
            col = (i * 4 + j) * out
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    slot = _slot(i, dy) * 6 + _slot(j, dx)
                    w[slot * C:(slot + 1) * C, col:col + out] = wconv[dy + 1, dx + 1]
    return w


def unfold_output_conv4_grad(dwfold: torch.Tensor, C: int,
                             out_ch: int) -> torch.Tensor:
    """Adjoint of :func:`fold_output_conv4`: (36, C, 16*out) per-slot grads
    -> (3, 3, C, out) conv weight grads."""
    dw = dwfold.new_zeros((3, 3, C, out_ch))
    for i in range(4):
        for j in range(4):
            col = (i * 4 + j) * out_ch
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    slot = _slot(i, dy) * 6 + _slot(j, dx)
                    dw[dy + 1, dx + 1] += dwfold[slot, :, col:col + out_ch]
    return dw


def _phase_slots(y: torch.Tensor) -> list:
    """y: (16, B, H, W, C) phase maps -> the 36 conv slots (B, H, W, C),
    slot (uh, uw) = phase (pi, pj) shifted by (dh, dw), zero off the image."""
    _, B, H, W, C = y.shape
    out = []
    for dh, pi in USLOTS:
        for dw, pj in USLOTS:
            t = F.pad(y[pi * 4 + pj], (0, 0, 1, 1, 1, 1))
            out.append(t[:, 1 + dh:1 + dh + H, 1 + dw:1 + dw + W])
    return out


def up4_conv_bwd_reference(x, w_exp, alpha_p, w_b1, b_b1, alpha_b, wpf, wbf,
                           wconv, dout) -> tuple:
    """Plain PyTorch version of :func:`up4_conv_bwd`, after the JAX
    ``_up4c_bwd_kernel`` and its rounding points: the 16 phase maps are
    recomputed (bf16), dwfold = slot^T round(dout) per conv slot, the conv
    adjoint dY (float32, zero padding), then per subpixel s: dwpf +=
    a_s^T round(dY_s), dz = prelu'(z_s) * (round(dY_s) wpf^T), dwexp_s =
    x^T round(dz), dx += round(dz) wexp_s^T; the bilinear stencil adjoint
    (edge-clamped) gives dxb, then dwbf = a_b^T round(dxb), dzb = prelu'(zb)
    * (round(dxb) wbf^T), dwb1 = x^T round(dzb), dbb1 = sum dzb, dx +=
    round(dzb) wb1^T.

    Returns (dx in x's dtype, dw_exp (C, 16C), dalpha_p, dw_b1, db_b1,
    dalpha_b, dwpf, dwbf, dwconv (3, 3, C, out)), grads float32."""
    with exact_fp32():
        dt = x.dtype
        B, H, W, C = x.shape
        out_ch = wconv.shape[-1]
        ap = alpha_p.float().reshape(())
        ab = alpha_b.float().reshape(())
        rows = lambda t: t.reshape(-1, t.shape[-1])
        xr = rows(x)
        # forward recompute
        zb = mm32(x, w_b1) + b_b1.float()
        abv = _prelu(zb, ab).to(dt)
        xb = mm32(abv, wbf)
        st = [_stencil_x4(t, 2) for t in _stencil_x4(xb, 1)]
        wexp_s = w_exp.reshape(C, C, 16).permute(2, 0, 1)
        z = [mm32(x, wexp_s[s]) for s in range(16)]
        a = [_prelu(zs, ap).to(dt) for zs in z]
        y = torch.stack([(mm32(a[s], wpf) + st[s // 4][s % 4]).to(dt)
                         for s in range(16)])
        # the conv: dwfold over the 36 slots, then the adjoint into the phases
        dob = dout.to(dt)
        dwfold = torch.stack([mm32(rows(t).t(), rows(dob)) for t in _phase_slots(y)])
        dwconv = unfold_output_conv4_grad(dwfold, C, out_ch)
        ypix = y.reshape(4, 4, B, H, W, C).permute(2, 3, 0, 4, 1, 5).reshape(
            B, 4 * H, 4 * W, C)
        dY = torch.nn.grad.conv2d_input(
            ypix.permute(0, 3, 1, 2).shape,
            wconv.float().permute(3, 2, 0, 1),
            phase_to_pixel(dob).float().permute(0, 3, 1, 2), padding=1)
        dY = dY.permute(0, 2, 3, 1).reshape(B, H, 4, W, 4, C)
        dys = [dY[:, :, s // 4, :, s % 4] for s in range(16)]
        # pixel-shuffle branch
        dwpf = torch.zeros(C, C, device=x.device)
        dwexp = []
        dap = torch.zeros((), device=x.device)
        dx = torch.zeros(B * H * W, C, device=x.device)
        for s in range(16):
            dyb = rows(dys[s].to(dt))
            dwpf += mm32(rows(a[s]).t(), dyb)
            dpre = mm32(dyb, wpf.t())
            zs = rows(z[s])
            dz = torch.where(zs > 0, dpre, ap * dpre)
            dap = dap + (torch.clamp_max(zs, 0) * dpre).sum()
            dzb = dz.to(dt)
            dwexp.append(mm32(xr.t(), dzb))
            dx += mm32(dzb, wexp_s[s].t())
        # bilinear branch
        dyh = [_stencil_x4_adjoint(dys[4 * i:4 * i + 4], 2) for i in range(4)]
        dxb = rows(_stencil_x4_adjoint(dyh, 1).to(dt))
        dwbf = mm32(rows(abv).t(), dxb)
        dabm = mm32(dxb, wbf.t())
        zbr = rows(zb)
        dzb = torch.where(zbr > 0, dabm, ab * dabm)
        dab = (torch.clamp_max(zbr, 0) * dabm).sum()
        dzb_b = dzb.to(dt)
        dwb1 = mm32(xr.t(), dzb_b)
        dbb1 = dzb.sum(0)
        dx += mm32(dzb_b, w_b1.t())
        dw_exp = torch.stack(dwexp).permute(1, 2, 0).reshape(C, 16 * C)
        return (dx.reshape(B, H, W, C).to(dt), dw_exp,
                dap.reshape(alpha_p.shape), dwb1, dbb1,
                dab.reshape(alpha_b.shape), dwpf, dwbf, dwconv)


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
    _check_up4(name, x, w_exp, w_b1, wpf, wbf, wconv)
    B, H, W, C = x.shape
    out_ch = wconv.shape[-1]
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


def _check_up4(name, x, w_exp, w_b1, wpf, wbf, wconv):
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


def up4_conv_bwd(x, w_exp, alpha_p, w_b1, b_b1, alpha_b, wpf, wbf, wconv,
                 dout) -> tuple:
    """Backward of :func:`fused_dual_upsample4_conv_phase` (JAX
    ``_up4c_bwd_impl``): dout (B, H, W, 16*out) phase-space cotangent.
    Returns (dx, dw_exp (C, 16C), dalpha_p, dw_b1, db_b1, dalpha_b, dwpf,
    dwbf, dwconv (3, 3, C, out)), the grads float32. CUDA:
    ``csrc/up4_conv_bwd.cu``, a fixed sequence of launches, each counted;
    its per-slot conv grads (36, C, 16*out) are unfolded here."""
    name = "up4_conv_bwd"
    count = _build.counter(name)
    if x.device.type == "cpu":
        count.cpu += UP4_CONV_BWD_LAUNCHES
        return up4_conv_bwd_reference(x, w_exp, alpha_p, w_b1, b_b1, alpha_b,
                                      wpf, wbf, wconv, dout)
    _check_up4(name, x, w_exp, w_b1, wpf, wbf, wconv)
    B, H, W, C = x.shape
    out_ch = wconv.shape[-1]
    dev = x.device
    dout = dout.to(BF16).contiguous()
    if tuple(dout.shape) != (B, H, W, 16 * out_ch):
        raise ValueError(f"{name}: dout shape {tuple(dout.shape)}")
    alphas = torch.stack([alpha_p.reshape(()), alpha_b.reshape(())]).to(
        device=dev, dtype=torch.float32)
    bb1 = b_b1.to(device=dev, dtype=torch.float32).contiguous()
    lib = _build.library()
    work = torch.empty(lib.sunet_up4_conv_bwd_workspace(B, H, W, C, out_ch),
                       device=dev, dtype=torch.uint8)
    z = lambda *s: torch.empty(*s, device=dev, dtype=torch.float32)
    dx = torch.empty_like(x)
    # dw_exp in w_exp's (C, 16C) layout, dalphas (2,), dwb1, dbb1, dwpf,
    # dwbf, dwfold (36, C, 16*out)
    grads = [z(C, 16 * C), z(2), z(C, C), z(C), z(C, C), z(C, C),
             z(36, C, 16 * out_ch)]
    launches = _build.c_int(0)
    err = lib.sunet_up4_conv_bwd(
        _build.ptr(x), _build.ptr(dout), _build.ptr(w_exp), _build.ptr(w_b1),
        _build.ptr(bb1), _build.ptr(wpf), _build.ptr(wbf), _build.ptr(wconv),
        _build.ptr(alphas), _build.ptr(dx), *[_build.ptr(g) for g in grads],
        _build.ptr(work), B, H, W, C, out_ch, _build.byref(launches),
        _build.stream())
    _build.check(name, err)
    count.cuda += launches.value
    dw_exp, dal, dwb1, dbb1, dwpf, dwbf, dwfold = grads
    return (dx, dw_exp, dal[0].reshape(alpha_p.shape), dwb1, dbb1,
            dal[1].reshape(alpha_b.shape), dwpf, dwbf,
            unfold_output_conv4_grad(dwfold, C, out_ch))


class DualUpsample4ConvTrainable(torch.autograd.Function):
    """Differentiable phase-space x4 head + 3x3 output conv (JAX
    ``dual_upsample4_conv_trainable``): forward =
    :func:`fused_dual_upsample4_conv_phase`, backward = :func:`up4_conv_bwd`.
    Weights come in float32 and are cast to x's dtype for the kernels;
    their grads come back in float32. Returns the (B, H, W, 16*out) phase
    map; :func:`phase_to_pixel` gives pixels."""

    @staticmethod
    def forward(ctx, x, w_exp, alpha_p, w_b1, b_b1, alpha_b, wpf, wbf, wconv):
        dt = x.dtype
        cast = lambda w: w.detach().to(dt).contiguous()
        x = x.contiguous()
        p = (cast(w_exp), alpha_p.detach(), cast(w_b1), b_b1.detach(),
             alpha_b.detach(), cast(wpf), cast(wbf), cast(wconv))
        ctx.save_for_backward(x, *p)
        return fused_dual_upsample4_conv_phase(x, *p)

    @staticmethod
    def backward(ctx, dout):
        x, *p = ctx.saved_tensors
        return up4_conv_bwd(x, *p, dout.contiguous())
