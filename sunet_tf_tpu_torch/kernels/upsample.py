"""The x4 dual up-sample head: fused with the 3x3 output conv in phase
space, or split, writing the up-sampled map.

Counterparts of ``sunet_tf_tpu/kernels/upsample.py``:

- :func:`fused_dual_upsample4_conv_phase` (JAX
  ``fused_dual_upsample4_conv_phase``): from a low-res map x (B, H, W, C) it
  returns (B, H, W, 16*out) where channels (i*4+j)*out .. +out at base (h,
  w) hold the output conv at pixel (4h+i, 4w+j). The 4x-upsampled map never
  exists in device memory. CUDA: ``csrc/up4_conv.cu``. The model's head
  where 16 * out_chans <= 128. C not a multiple of 16 (the scaled config's
  180) runs over C rounded up to 16, the weights zero-padded
  (:func:`up4_conv_operands`). A float32 x takes its float32 form,
  ``csrc/f32_up4.cu``: one cooperative launch (:func:`f32_up4_plan`), the
  4x map written to and read from device memory.
- :func:`fused_dual_upsample4` (JAX ``fused_dual_upsample4``): the split
  head, (B, 4H, 4W, C) in x's dtype; the model's output conv follows it as
  a plain convolution. CUDA: ``csrc/up4.cu`` (two launches). The model's
  head where 16 * out_chans > 128.

Head math (the three weight-space folds of the JAX ``DualUpsample``):
pixel-shuffle branch ``prelu(x @ w_exp_s) @ wpf`` per subpixel s; bilinear
branch ``prelu(x @ w_b1 + b_b1) @ wbf`` at low res, then the separable
half-pixel x4 stencil with EDGE-CLAMPED taps; phase map = round(sum). The
3x3 bias-free output conv then runs over the phase maps with ZERO padding
at the image edge. The two edge rules differ on purpose.

Training: :func:`up4_conv_bwd` (JAX ``_up4c_bwd_impl``, CUDA
``csrc/up4_conv_bwd.cu``) is the conv-fused head's backward, and
:class:`DualUpsample4ConvTrainable` pairs the two for autograd;
:func:`up4_bwd` (JAX ``_up4_bwd_impl``, CUDA ``csrc/up4_bwd.cu``) is the
split head's, and :class:`DualUpsample4Trainable` (JAX
``dual_upsample4_trainable``) pairs it with :func:`fused_dual_upsample4`.
The split head's rounding points differ from the conv head's only after the
phase maps: its cotangent arrives in pixel space, and dP = dout wpf^T is
rounded before the PReLU derivative.

Dispatch as in :mod:`.window_attention`: CPU tensor -> plain version, CUDA
tensor -> kernel or raise.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from sunet_tf_tpu_torch.kernels import _build
from sunet_tf_tpu_torch.kernels.window_attention import (BF16, BWD_FILL_CTAS, F32_GEMM_SMEM,
                                                         PLAN_BATCH, SMEM_MAX, _a_bytes,
                                                         _bwd_tok_smem, _cdiv, _check_w,
                                                         _check_x, _chunk_rows, _f32_ctas,
                                                         _gate, _pad128, _up, _wg_tiles,
                                                         exact_fp32, mm32, wide)

# Half-pixel x4 phase weights: output row 4h+p samples input at
# h + (2p-3)/8 -> taps (h-1, h) for p = 0, 1 and (h, h+1) for p = 2, 3.
P4 = ((0.375, 0.625), (0.125, 0.875), (0.875, 0.125), (0.625, 0.375))
# The conv-fused head's backward (csrc/up4_conv_bwd.cu) holds a tile's
# operands as two 64-column panels in shared memory: C <= 96; above, its
# wide form (each CTA of the phase work over one 64-column box, or a pair)
# takes C up to UP4_CONV_BWD_WIDE_MAX_C, C % 16 != 0 (the scaled config's
# 180) padded to 16 inside as the forward pads it.
UP4_KERNEL_MAX_C = 96
UP4_CONV_BWD_WIDE_MAX_C = 192
UP4_KERNEL_MAX_OUT = 8
# The conv-fused head's forward (csrc/up4_conv.cu): a tile of UP4_TILE
# low-res pixels per warpgroup, one or two warpgroups per CTA (up4_plan);
# its shared memory holds C up to this width.
UP4_CONV_KERNEL_MAX_C = 192
UP4_TILE = (6, 8)
_UP4_RING = (3, 12288)   # csrc/up4_conv.cu kRingS, kRingSlot
_UP4_HEADER = 2048       # csrc/up4_conv.cu kHeader
# The float32 form of the conv-fused head (csrc/f32_up4.cu), one cooperative
# launch: the four products on csrc/f32_tile.cuh's tiles (zb, xb, z, the 4x
# map with the stencil in the epilogue), then the 3x3 conv over 16 x 16
# output tiles, their input staged 16 channels at a time (kConvTile,
# kConvCc), a grid-wide barrier between the phases.
_UP4_F32_CONV_TILE = 16
_UP4_F32_CONV_SMEM = ((_UP4_F32_CONV_TILE + 2) ** 2 * (16 + 1) + 9 * 16 * UP4_KERNEL_MAX_OUT) * 4
# Kernel launches one up4_conv_bwd call makes (csrc/up4_conv_bwd.cu): prep,
# phase, pixel, the weight gradients, the sums; the wide form (C above
# UP4_KERNEL_MAX_C) splits the phase launch in two (phase by box, the fold).
UP4_CONV_BWD_LAUNCHES = 5
UP4_CONV_BWD_WIDE_LAUNCHES = 6
# The split head's kernels (csrc/up4.cu, up4_bwd.cu) keep one tile's working
# set in shared memory: C a multiple of 16 up to this width.
UP4_SPLIT_KERNEL_MAX_C = 256
# Kernel launches one fused_dual_upsample4 call makes (csrc/up4.cu): prep,
# phase.
UP4_SPLIT_LAUNCHES = 2
# Kernel launches one up4_bwd call makes (csrc/up4_bwd.cu): prep, phase,
# pixel, the weight gradients, the sums.
UP4_BWD_LAUNCHES = 5


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


def _phases_to_pixel(y: torch.Tensor) -> torch.Tensor:
    """(16, B, H, W, C) phase maps, s = i*4+j -> (B, 4H, 4W, C) pixels."""
    _, B, H, W, C = y.shape
    return y.reshape(4, 4, B, H, W, C).permute(2, 3, 0, 4, 1, 5).reshape(
        B, 4 * H, 4 * W, C)


def _pixel_phases(p: torch.Tensor) -> list:
    """(B, 4H, 4W, C) pixels -> the 16 phase maps (B, H, W, C), s = i*4+j."""
    return [p[:, s // 4::4, s % 4::4] for s in range(16)]


def _pixel_to_phase(p: torch.Tensor) -> torch.Tensor:
    B, H4, W4, out_ch = p.shape
    H, W = H4 // 4, W4 // 4
    p = p.reshape(B, H, 4, W, 4, out_ch).permute(0, 1, 3, 2, 4, 5)
    return p.reshape(B, H, W, 16 * out_ch)


def _phase_maps(x, w_exp, alpha_p, w_b1, b_b1, alpha_b, wpf, wbf) -> torch.Tensor:
    """The head's 16 phase maps (16, B, H, W, C) in x's dtype, at the JAX
    kernels' rounding points (``_up4_kernel``, ``_up4_conv_kernel``): per
    subpixel s, round(prelu(x @ w_exp_s)) @ wpf in float32; the bilinear
    branch round(prelu(x @ w_b1 + b_b1)) @ wbf in float32 through the
    float32 stencil; one rounding of the sum. Call inside exact_fp32()."""
    dt = x.dtype
    C = x.shape[-1]
    ap = wide(alpha_p).reshape(())
    ab = wide(alpha_b).reshape(())
    zb = _prelu(mm32(x, w_b1) + wide(b_b1), ab).to(dt)
    xb = mm32(zb, wbf)
    st = [_stencil_x4(t, 2) for t in _stencil_x4(xb, 1)]   # st[i][j]
    wexp_s = w_exp.reshape(C, C, 16).permute(2, 0, 1)
    ys = []
    for s in range(16):
        z = _prelu(mm32(x, wexp_s[s]), ap).to(dt)
        ys.append((mm32(z, wpf) + st[s // 4][s % 4]).to(dt))
    return torch.stack(ys)


def fused_dual_upsample4_reference(x, w_exp, alpha_p, w_b1, b_b1, alpha_b,
                                   wpf, wbf) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_dual_upsample4` (JAX
    ``_up4_kernel``): the phase maps of :func:`_phase_maps` at their
    pixels, (B, 4H, 4W, C) in x's dtype."""
    with exact_fp32():
        return _phases_to_pixel(_phase_maps(x, w_exp, alpha_p, w_b1, b_b1,
                                            alpha_b, wpf, wbf))


def fused_dual_upsample4_conv_phase_reference(x, w_exp, alpha_p, w_b1, b_b1,
                                              alpha_b, wpf, wbf, wconv):
    """Plain PyTorch version of :func:`fused_dual_upsample4_conv_phase`."""
    with exact_fp32():
        # pixel-space head map, then the zero-padded 3x3 conv in float32
        y = _phases_to_pixel(_phase_maps(x, w_exp, alpha_p, w_b1, b_b1,
                                         alpha_b, wpf, wbf))
        o = F.conv2d(wide(y).permute(0, 3, 1, 2),
                     wide(wconv).permute(3, 2, 0, 1), padding=1)
        return _pixel_to_phase(o.permute(0, 2, 3, 1)).to(x.dtype)


# ---------------------------------------------------------------- the
# conv-fused forward's tiles (csrc/up4_conv.cu), in plain Python: the halo
# of a tile, the rows of one subpixel's 64-row wgmma tile, the launch plan.


def up4_halo_pixels() -> list:
    """The halo pixels of a UP4_TILE tile, (y, x) in tile coordinates, in
    the kernel's order (``pool_pixel``): the top row, the bottom row, the
    left column, the right column, the corners TL, TR, BL, BR."""
    TH, TW = UP4_TILE
    return ([(-1, x) for x in range(TW)] + [(TH, x) for x in range(TW)]
            + [(y, -1) for y in range(TH)] + [(y, TW) for y in range(TH)]
            + [(-1, -1), (-1, TW), (TH, -1), (TH, TW)])


def up4_halo_src(i: int, j: int, r: int) -> int:
    """The halo pixel (index into :func:`up4_halo_pixels`) that row r of
    subpixel (i, j)'s 64-row tile holds, -1 for none (``halo_src``): rows
    below TH*TW are the tile's pixels; then the top halo row where i = 3 or
    the bottom one where i = 0, the left halo column where j = 3 or the
    right one where j = 0, and the corner where both hold."""
    TH, TW = UP4_TILE
    q = r - TH * TW
    if q < TW:
        return q if i == 3 else (TW + q if i == 0 else -1)
    if q < TW + TH:
        return 2 * TW + q - TW if j == 3 else (2 * TW + TH + q - TW if j == 0 else -1)
    if q == TW + TH and i in (0, 3) and j in (0, 3):
        return 2 * TW + 2 * TH + (i == 0) * 2 + (j == 0)
    return -1


def up4_tile_rows(i: int, j: int) -> list:
    """(row, (y, x)) of every row of subpixel (i, j)'s 64-row tile that
    holds a pixel: the tile's own, then the halo pixels whose phase (i, j)
    the 3x3 conv reads."""
    TH, TW = UP4_TILE
    halo = up4_halo_pixels()
    rows = [(r, (r // TW, r % TW)) for r in range(TH * TW)]
    return rows + [(r, halo[up4_halo_src(i, j, r)]) for r in range(TH * TW, 64)
                   if up4_halo_src(i, j, r) >= 0]


def up4_smem(C: int, out: int, T: int) -> int:
    """Dynamic shared memory of a CTA of csrc/up4_conv.cu with T warpgroups
    (``smem_bytes``): slack, header, ring, the conv's weights (K-major, 9 *
    out rows rounded up to 16), and per warpgroup the x rows of the tile and
    of its halo, z / Y (64 x C each), xb over the 1-pixel halo region
    (float32, rows of C + 4) and the tile's output sums (float32)."""
    TH, TW = UP4_TILE
    S, slot = _UP4_RING
    conv = -(-C // 64) * _up(9 * out, 16) * 128
    wg = (3 * _a_bytes(C) + _up((TH + 2) * (TW + 2) * (C + 4) * 4, 1024)
          + _up(TH * TW * 16 * out * 4, 1024))
    return 1024 + _UP4_HEADER + S * slot + conv + T * wg


@functools.lru_cache(maxsize=None)
def up4_plan(C: int, out: int) -> dict:
    """Launch plan of csrc/up4_conv.cu: Cp, the width its products and
    shared memory run over (C rounded up to 16: 180 -> 192, the weights
    zero-padded to it); T, the tiles (warpgroups) per CTA, 2 where two fit
    SMEM_MAX, else 1; its shared memory. A function of C and out alone (a
    tile is UP4_TILE pixels at any image size and batch). Raises ValueError
    outside the design."""
    Cp = _up(C, 16)
    if C % 4 or not 16 <= Cp <= UP4_CONV_KERNEL_MAX_C or not 1 <= out <= UP4_KERNEL_MAX_OUT:
        raise ValueError(f"up4_plan: C={C}, out={out}: the kernel takes C a multiple of 4 "
                         f"(8-byte row chunks) up to {UP4_CONV_KERNEL_MAX_C} and "
                         f"1 <= out <= {UP4_KERNEL_MAX_OUT}")
    T = next(T for T in (2, 1, 0) if T == 0 or up4_smem(Cp, out, T) <= SMEM_MAX)
    if not T:
        raise ValueError(f"up4_plan: C={C}, out={out}: one tile does not fit {SMEM_MAX} bytes")
    return {"T": T, "smem": up4_smem(Cp, out, T), "Cp": Cp}


@functools.lru_cache(maxsize=None)
def f32_up4_plan(H: int, W: int, C: int, out: int) -> dict:
    """Launch plan of #5's float32 form (csrc/f32_up4.cu, one cooperative
    launch) for (H, W, C) images: each phase's shared-memory bytes and tiles
    at PLAN_BATCH images. Raises ValueError outside the design (C a
    multiple of 16, 1 <= out <= UP4_KERNEL_MAX_OUT)."""
    if H <= 0 or W <= 0 or C <= 0 or C % 16 or not 1 <= out <= UP4_KERNEL_MAX_OUT:
        raise ValueError(f"f32_up4_plan: H={H}, W={W}, C={C}, out={out}: the float32 form "
                         f"takes C a multiple of 16 and 1 <= out <= {UP4_KERNEL_MAX_OUT}")
    M, t = H * W, _UP4_F32_CONV_TILE
    return {"smem_gemm": F32_GEMM_SMEM, "smem_conv": _UP4_F32_CONV_SMEM,
            "tiles": {"zb": _f32_ctas(M, C), "xb": _f32_ctas(M, C), "z": _f32_ctas(M, 16 * C),
                      "map": _f32_ctas(16 * M, C),
                      "conv": PLAN_BATCH * _cdiv(4 * H, t) * _cdiv(4 * W, t)}}


# The x4 head's backward kernels (#9, csrc/up4_conv_bwd.cu; #11,
# csrc/up4_bwd.cu; their shared launches csrc/up4_bwd.cuh): the phase
# launch's chunks of 8 x 8 tiles, 8 x 8 tiles of the stencil adjoint, #9's
# conv adjoint's K (9 * out) padded to 16 and at most this.
UP4_BWD_PHASE_CHUNKS = 8     # kPhaseChunks
UP4_BWD_DXB_TILE = 8         # kDxbT
_UP4_BWD_WC_ROWS = 80        # kWcRows
_UP4_BWD_BOX = 64 * 128      # kBox
_UP4_BWD_DXB_BYTES = 40 * 40 * 16 * 2 + 40 * 8 * 16 * 4 + 2 * 8 * 12 * 4   # #11's kDxbBytes


def _up4_pixel_smem(C: int) -> int:
    """Shared memory of the pixel launch (csrc/up4_bwd.cuh pixel_smem): wbf
    and wb1 whole up to two 64-column boxes of C (with the fp32 dzb of a
    pair), wider one pair of boxes at a time; dxb, round(dzb), the ring."""
    nbx = _cdiv(C, 64)
    full = nbx <= 2
    return (2048 + ((4 if full else 2) * nbx + 2 * nbx + 9) * _UP4_BWD_BOX
            + (64 * 128 * 4 if full else 0))


def _up4_wgrad_plan(H: int, W: int, C: int) -> tuple:
    """Tokens per chunk and tiles (dwexp, dwbf, dwb1) of the x4 head
    backward's weight-gradient launch (csrc/up4_bwd.cuh up4_bwd_plan)."""
    tplan = _cdiv(PLAN_BATCH * H * W, 64)
    wtiles = (_wg_tiles(C, 16 * C), _wg_tiles(C, C), _wg_tiles(C, C))
    per = max(1, _cdiv(BWD_FILL_CTAS, sum(wtiles)))
    return 64 * _cdiv(tplan, per), wtiles


def _up4_tiles_per_chunk(H: int, W: int) -> int:
    tiles = _cdiv(H, UP4_BWD_DXB_TILE) * _cdiv(W, UP4_BWD_DXB_TILE)
    return _cdiv(PLAN_BATCH * tiles, UP4_BWD_PHASE_CHUNKS)


def up4_conv_bwd_launches(C: int) -> int:
    """Kernel launches of one :func:`up4_conv_bwd` call at width C."""
    return UP4_CONV_BWD_LAUNCHES if _up(C, 16) <= UP4_KERNEL_MAX_C else UP4_CONV_BWD_WIDE_LAUNCHES


def up4_conv_bwd_plan(H: int, W: int, C: int, out: int) -> dict:
    """Launch plan of the conv-fused head's backward (#9) for (H, W, C)
    images, a function of one image's shape (``up4_bwd_plan`` in
    csrc/up4_conv_bwd.cu mirrors it): Cp, the width it runs over (C rounded
    up to 16, 180 -> 192, the operands zero-padded to it); "wide", whether
    it takes the wide form (Cp above UP4_KERNEL_MAX_C: the phase work by
    64-column box and the fold in two launches); 8 x 8 pixel tiles per chunk
    of the phase launch (PLAN_BATCH images' tiles in UP4_BWD_PHASE_CHUNKS
    chunks), the fold's 64-column boxes per phase (its slots x 16 * out
    columns), the conv adjoint's K, the weight-gradient launch's tokens per
    chunk and tiles (dwexp, dwbf, dwb1), each launch's shared-memory bytes.
    Raises ValueError on a shape outside the design."""
    Cp = _up(C, 16)
    if C % 4 or not 16 <= Cp <= UP4_CONV_BWD_WIDE_MAX_C or not 1 <= out <= UP4_KERNEL_MAX_OUT:
        raise ValueError(f"up4_conv_bwd_plan: C={C}, out={out}: the kernel takes C a "
                         f"multiple of 4 (padded to 16) up to {UP4_CONV_BWD_WIDE_MAX_C} and "
                         f"1 <= out <= {UP4_KERNEL_MAX_OUT}")
    if H < 1 or W < 1:
        raise ValueError(f"up4_conv_bwd_plan: ({H},{W}) is empty")
    C = Cp
    wide = C > UP4_KERNEL_MAX_C
    wchunk, wtiles = _up4_wgrad_plan(H, W, C)
    nslots = [len([u for u in USLOTS if u[1] == p]) for p in range(4)]
    box = _UP4_BWD_BOX
    dxb = 4 * (144 * 16 * out + 42 * 8 * 3 * out + 64 * 9 * out + 9 * C * out)
    nbx = _cdiv(C, 64)
    return {"tiles_per_chunk": _up4_tiles_per_chunk(H, W),
            "fold_boxes": tuple(_cdiv(nslots[s // 4] * nslots[s % 4] * 16 * out, 64)
                                for s in range(16)),
            "k16": _up(9 * out, 16), "wgrad_chunk_tokens": wchunk,
            "wgrad_tiles": wtiles, "dxb_tile": (UP4_BWD_DXB_TILE, UP4_BWD_DXB_TILE),
            "Cp": Cp, "wide": wide,
            "smem": {"prep": 1024 + max(1024 + (2 * nbx + 2 * nbx * nbx) * box, dxb),
                     **({"phase_box": 2048 + (5 * nbx + 4) * box
                         + nbx * _UP4_BWD_WC_ROWS * 128 + 32 * 128 * 4,
                         "fold": 2048 + (4 * nbx + 3) * box + 81 * (128 + 4) * 4} if wide else
                        {"phase": 2048 + 21 * box + 2 * _UP4_BWD_WC_ROWS * 128 + 81 * 100 * 4}),
                     "pixel": _up4_pixel_smem(C),
                     "wgrad": _bwd_tok_smem(0, False)}}


def up4_conv_bwd_workspace(B: int, H: int, W: int, C: int, out: int) -> int:
    """Bytes of the conv-fused head's backward workspace (``carve_up4`` in
    csrc/up4_conv_bwd.cu): zb and xb (float32), abv, dxb, round(dzb) (M x
    C), dz (M x 16C), w_exp by phase and the conv weights by tap, then the
    partials: dwpf and the fold per (chunk, phase), the slope sums, the
    64-pixel strips' slope and db_b1 sums, the weight gradients' token
    chunks."""
    plan = up4_conv_bwd_plan(H, W, C, out)
    C, wide = plan["Cp"], plan["wide"]
    M = B * H * W
    ntiles = _cdiv(M, 64)
    nch = _cdiv(B * _cdiv(H, UP4_BWD_DXB_TILE) * _cdiv(W, UP4_BWD_DXB_TILE),
                plan["tiles_per_chunk"])
    wnch = _cdiv(M, plan["wgrad_chunk_tokens"])
    pieces = [4 * M * C, 4 * M * C, 2 * M * C, 2 * M * C, 2 * M * C, 2 * 16 * M * C,
              2 * 16 * C * C, 2 * 9 * out * C, 4 * nch * 16 * C * C,
              4 * nch * 36 * C * 16 * out, 4 * nch * 16 * (_cdiv(C, 64) if wide else 1),
              4 * ntiles, 4 * ntiles * C,
              4 * wnch * C * 16 * C, 4 * wnch * C * C, 4 * wnch * C * C,
              2 * 16 * M * C if wide else 0]
    return sum(_pad128(n) for n in pieces)


def up4_bwd_plan(H: int, W: int, C: int) -> dict:
    """Launch plan of the split head's backward (#11) for (H, W, C) images,
    a function of one image's shape (``up4_bwd_plan`` in csrc/up4_bwd.cuh
    with out = 0 mirrors it): 8 x 8 pixel tiles per chunk of the phase
    launch (#9's), its CTAs per (chunk, phase) (one per 64-column box of
    C), the weight-gradient launch's tokens per chunk and tiles (dwexp,
    dwbf, dwb1), each launch's shared-memory bytes. Raises ValueError on a
    shape outside the design."""
    if C % 16 or not 16 <= C <= UP4_SPLIT_KERNEL_MAX_C:
        raise ValueError(f"up4_bwd_plan: C={C}: the kernel takes C a multiple of 16 up to "
                         f"{UP4_SPLIT_KERNEL_MAX_C}")
    if H < 1 or W < 1:
        raise ValueError(f"up4_bwd_plan: ({H},{W}) is empty")
    nbx = _cdiv(C, 64)
    wchunk, wtiles = _up4_wgrad_plan(H, W, C)
    box = _UP4_BWD_BOX
    return {"tiles_per_chunk": _up4_tiles_per_chunk(H, W), "column_boxes": nbx,
            "wgrad_chunk_tokens": wchunk, "wgrad_tiles": wtiles,
            "dxb_tile": (UP4_BWD_DXB_TILE, UP4_BWD_DXB_TILE),
            "smem": {"prep": 1024 + max(1024 + (nbx + nbx * nbx) * box, _UP4_BWD_DXB_BYTES),
                     "phase": 2048 + (6 * nbx + 3) * box,
                     "pixel": _up4_pixel_smem(C),
                     "wgrad": _bwd_tok_smem(0, False)}}


def up4_bwd_workspace(B: int, H: int, W: int, C: int) -> int:
    """Bytes of the split head's backward workspace (``carve_up4`` in
    csrc/up4_bwd.cuh with out = 0): zb (float32), abv, dxb, round(dzb) (M x
    C), dz (M x 16C), w_exp by phase, then the partials: dwpf per (chunk,
    phase), the slope per (chunk, phase, column box), the 64-pixel strips'
    slope and db_b1 sums, the weight gradients' token chunks."""
    plan = up4_bwd_plan(H, W, C)
    M = B * H * W
    ntiles = _cdiv(M, 64)
    nch = _cdiv(B * _cdiv(H, UP4_BWD_DXB_TILE) * _cdiv(W, UP4_BWD_DXB_TILE),
                plan["tiles_per_chunk"])
    wnch = _cdiv(M, plan["wgrad_chunk_tokens"])
    pieces = [4 * M * C, 2 * M * C, 2 * M * C, 2 * M * C, 2 * 16 * M * C, 2 * 16 * C * C,
              4 * nch * 16 * C * C, 4 * nch * 16 * plan["column_boxes"], 4 * ntiles,
              4 * ntiles * C, 4 * wnch * C * 16 * C, 4 * wnch * C * C, 4 * wnch * C * C]
    return sum(_pad128(n) for n in pieces)


# The split head's forward (#10, csrc/up4.cu): chunks of 8 x 8 tiles of its
# phase launch at PLAN_BATCH images, the weight ring's slot bytes, one
# 32-channel box of a phase's 9 x 9 stencil taps (81 rows of 128 bytes,
# rounded up to 1024).
UP4_SPLIT_CHUNKS = 16    # kUpChunks
_UP4_SPLIT_SLOT = 32768  # kSlot
_UP4_TAP_HALF = 11264    # kTapHalf


def up4_split_plan(H: int, W: int, C: int) -> dict:
    """Launch plan of the split head's forward (#10) for (H, W, C) images, a
    function of one image's shape (``up4_split_plan`` in csrc/up4.cu
    mirrors it): 8 x 8 tiles per chunk of the phase launch (PLAN_BATCH
    images' tiles in UP4_SPLIT_CHUNKS chunks), its 64-column boxes of C,
    the weight ring's slots and rows per chunk, whether wexp_s and wpf stay
    in the ring for a CTA's whole chunk (both products' chunks fit its
    slots) or stream per tile, its tile chains per CTA (2 where C <= 128:
    one per warpgroup), each launch's shared-memory bytes. Raises
    ValueError on a shape outside the design."""
    if C % 16 or not 16 <= C <= UP4_SPLIT_KERNEL_MAX_C:
        raise ValueError(f"up4_split_plan: C={C}: the kernel takes C a multiple of 16 up to "
                         f"{UP4_SPLIT_KERNEL_MAX_C}")
    if H < 1 or W < 1:
        raise ValueError(f"up4_split_plan: ({H},{W}) is empty")
    nbx = _cdiv(C, 64)
    slots = 2 if nbx <= 2 else 3
    bk = _chunk_rows(_UP4_SPLIT_SLOT, nbx, C)
    tiles = _cdiv(H, UP4_BWD_DXB_TILE) * _cdiv(W, UP4_BWD_DXB_TILE)
    box = _UP4_BWD_BOX
    weights = 2 if nbx <= 3 else 1   # wb1 and wbf at once, or wbf in wb1's place
    chains = 2 if nbx <= 2 else 1
    # per chain: x, a, its boxes' taps (a pair at a time) and, one chain,
    # two staging boxes
    chain = ((2 * nbx + (2 if chains == 1 else 0)) * box
             + (2 * nbx if chains == 2 else 4) * _UP4_TAP_HALF)
    return {"tiles_per_chunk": _cdiv(PLAN_BATCH * tiles, UP4_SPLIT_CHUNKS),
            "column_boxes": nbx, "ring_slots": slots, "chunk_rows": bk,
            "weights_resident": 2 * (C // bk) <= slots, "tile_chains": chains,
            "smem": {"prep": 2048 + (2 * nbx + weights * nbx * nbx) * box,
                     "phase": 2048 + slots * _UP4_SPLIT_SLOT + chains * chain}}


def up4_split_workspace(B: int, H: int, W: int, C: int) -> int:
    """Bytes of the split head's forward workspace (``carve`` in
    csrc/up4.cu): xb (float32) with its one-pixel border, (B, H + 2, W + 2,
    C), and w_exp by phase (16C x C, bf16)."""
    return _pad128(4 * B * (H + 2) * (W + 2) * C) + _pad128(2 * 16 * C * C)


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


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


def _head_recompute(x, w_exp, alpha_p, w_b1, b_b1, alpha_b) -> tuple:
    """The backward kernels' forward recompute: (zb float32, abv = round(prelu
    (zb)), the 16 subpixel pre-activations z_s float32, a_s =
    round(prelu(z_s)), w_exp as (16, C, C))."""
    dt = x.dtype
    C = x.shape[-1]
    ap = wide(alpha_p).reshape(())
    ab = wide(alpha_b).reshape(())
    zb = mm32(x, w_b1) + wide(b_b1)
    wexp_s = w_exp.reshape(C, C, 16).permute(2, 0, 1)
    z = [mm32(x, wexp_s[s]) for s in range(16)]
    return (zb, _prelu(zb, ab).to(dt), z, [_prelu(zs, ap).to(dt) for zs in z],
            wexp_s)


def _shuffle_bwd(x, z, a, dys, wexp_s, wpf, alpha_p, round_dp: bool) -> tuple:
    """Pixel-shuffle branch backward from the 16 subpixel cotangents ``dys``
    (rows, x's dtype): dwpf += a_s^T dy_s; dP = dy_s wpf^T (rounded to x's
    dtype when ``round_dp``, the split head's point); dz = prelu'(z_s) * dP;
    dw_exp_s = x^T round(dz), dx += round(dz) w_exp_s^T. Returns (dwpf,
    dw_exp (C, 16C), dalpha_p, dx rows), float32."""
    dt = x.dtype
    C = x.shape[-1]
    ap = wide(alpha_p).reshape(())
    xr = _rows(x)
    z0 = lambda *s: torch.zeros(*s, device=x.device, dtype=ap.dtype)
    dwpf = z0(C, C)
    dwexp = []
    dap = z0(())
    dx = z0(xr.shape[0], C)
    for s in range(16):
        dwpf += mm32(_rows(a[s]).t(), dys[s])
        dpre = mm32(dys[s], wpf.t())
        if round_dp:
            dpre = wide(dpre.to(dt))
        zs = _rows(z[s])
        dz = torch.where(zs > 0, dpre, ap * dpre)
        dap = dap + (torch.clamp_max(zs, 0) * dpre).sum()
        dzb = dz.to(dt)
        dwexp.append(mm32(xr.t(), dzb))
        dx += mm32(dzb, wexp_s[s].t())
    return dwpf, torch.stack(dwexp).permute(1, 2, 0).reshape(C, 16 * C), dap, dx


def _bilinear_bwd(x, zb, abv, dxb, wbf, w_b1, alpha_b) -> tuple:
    """Bilinear branch backward from its rounded stencil adjoint ``dxb``
    (rows): dwbf = abv^T dxb, dzb = prelu'(zb) * (dxb wbf^T), dwb1 = x^T
    round(dzb), dbb1 = sum dzb. Returns (dwbf, dalpha_b, dwb1, dbb1, the dx
    rows round(dzb) w_b1^T), float32."""
    ab = wide(alpha_b).reshape(())
    dwbf = mm32(_rows(abv).t(), dxb)
    dabm = mm32(dxb, wbf.t())
    zbr = _rows(zb)
    dzb = torch.where(zbr > 0, dabm, ab * dabm)
    dab = (torch.clamp_max(zbr, 0) * dabm).sum()
    dzb_b = dzb.to(x.dtype)
    return dwbf, dab, mm32(_rows(x).t(), dzb_b), dzb.sum(0), mm32(dzb_b, w_b1.t())


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
        zb, abv, z, a, wexp_s = _head_recompute(x, w_exp, alpha_p, w_b1, b_b1,
                                                alpha_b)
        xb = mm32(abv, wbf)
        st = [_stencil_x4(t, 2) for t in _stencil_x4(xb, 1)]
        y = torch.stack([(mm32(a[s], wpf) + st[s // 4][s % 4]).to(dt)
                         for s in range(16)])
        # the conv: dwfold over the 36 slots, then the adjoint into the phases
        dob = dout.to(dt)
        dwfold = torch.stack([mm32(_rows(t).t(), _rows(dob)) for t in _phase_slots(y)])
        dwconv = unfold_output_conv4_grad(dwfold, C, out_ch)
        ypix = _phases_to_pixel(y)
        dY = torch.nn.grad.conv2d_input(
            ypix.permute(0, 3, 1, 2).shape,
            wide(wconv).permute(3, 2, 0, 1),
            wide(phase_to_pixel(dob)).permute(0, 3, 1, 2), padding=1)
        dY = dY.permute(0, 2, 3, 1).reshape(B, H, 4, W, 4, C)
        dys = [dY[:, :, s // 4, :, s % 4] for s in range(16)]
        dwpf, dw_exp, dap, dx = _shuffle_bwd(
            x, z, a, [_rows(d.to(dt)) for d in dys], wexp_s, wpf, alpha_p,
            round_dp=False)
        # the bilinear branch from the edge-clamped stencil's adjoint
        dyh = [_stencil_x4_adjoint(dys[4 * i:4 * i + 4], 2) for i in range(4)]
        dxb = _rows(_stencil_x4_adjoint(dyh, 1).to(dt))
        dwbf, dab, dwb1, dbb1, dxl = _bilinear_bwd(x, zb, abv, dxb, wbf, w_b1,
                                                   alpha_b)
        dx += dxl
        return (dx.reshape(B, H, W, C).to(dt), dw_exp,
                dap.reshape(alpha_p.shape), dwb1, dbb1,
                dab.reshape(alpha_b.shape), dwpf, dwbf, dwconv)


def up4_bwd_reference(x, w_exp, alpha_p, w_b1, b_b1, alpha_b, wpf, wbf,
                      dout) -> tuple:
    """Plain PyTorch version of :func:`up4_bwd`, after the JAX
    ``_up4_bwd_kernel`` and its rounding points: dout (B, 4H, 4W, C) rounded
    to x's dtype; per subpixel s (dout's pixels (4h+i, 4w+j)) dwpf += a_s^T
    dout_s, dP = round(dout_s wpf^T), dz = prelu'(z_s) * dP, dwexp_s = x^T
    round(dz), dx += round(dz) wexp_s^T, the slope grad sum(min(z_s, 0) *
    dP); the bilinear stencil's adjoint (edge-clamped) in float32 on the
    rounded dout gives dxb, rounded, then the bilinear chain as in
    :func:`up4_conv_bwd_reference`.

    Returns (dx in x's dtype, dw_exp (C, 16C), dalpha_p, dw_b1, db_b1,
    dalpha_b, dwpf, dwbf), grads float32."""
    with exact_fp32():
        dt = x.dtype
        B, H, W, C = x.shape
        zb, abv, z, a, wexp_s = _head_recompute(x, w_exp, alpha_p, w_b1, b_b1,
                                                alpha_b)
        dys = _pixel_phases(dout.to(dt))
        dwpf, dw_exp, dap, dx = _shuffle_bwd(
            x, z, a, [_rows(d) for d in dys], wexp_s, wpf, alpha_p, round_dp=True)
        dyf = [wide(d) for d in dys]
        dyh = [_stencil_x4_adjoint(dyf[4 * i:4 * i + 4], 2) for i in range(4)]
        dxb = _rows(_stencil_x4_adjoint(dyh, 1).to(dt))
        dwbf, dab, dwb1, dbb1, dxl = _bilinear_bwd(x, zb, abv, dxb, wbf, w_b1,
                                                   alpha_b)
        dx += dxl
        return (dx.reshape(B, H, W, C).to(dt), dw_exp,
                dap.reshape(alpha_p.shape), dwb1, dbb1,
                dab.reshape(alpha_b.shape), dwpf, dwbf)


def _alphas_bias(alpha_p, b_b1, alpha_b, dev) -> tuple:
    """The two PReLU slopes as one float32 (2,) tensor, and b_b1 in float32."""
    alphas = torch.stack([alpha_p.reshape(()), alpha_b.reshape(())]).to(
        device=dev, dtype=torch.float32)
    return alphas, b_b1.to(device=dev, dtype=torch.float32).contiguous()


def up4_conv_operands(w_exp, w_b1, b_b1, wpf, wbf, Cp: int) -> tuple:
    """The conv-fused head's weights as csrc/up4_conv.cu takes them, every
    C x C matrix and b_b1 zero-padded to Cp (a copy per call, as the (16,
    C, C) layout already is): (wexp (16, Cp, Cp), subpixel s's expand
    weights; w_b1, b_b1 float32, wpf, wbf)."""
    C = w_b1.shape[0]
    pad = Cp - C
    sq = lambda w: F.pad(w, (0, pad, 0, pad)).contiguous()
    return (sq(w_exp.reshape(C, C, 16).permute(2, 0, 1)), sq(w_b1),
            F.pad(b_b1.to(device=w_b1.device, dtype=torch.float32), (0, pad)).contiguous(),
            sq(wpf), sq(wbf))


def fused_dual_upsample4_conv_phase(x, w_exp, alpha_p, w_b1, b_b1, alpha_b,
                                    wpf, wbf, wconv) -> torch.Tensor:
    """x4 dual up-sample + 3x3 output conv (no bias) in phase space.

    x: (B, H, W, C); w_exp: (C, 16C) pixel-shuffle expand, (in, out) layout;
    w_b1: (C, C), b_b1: (C,); wpf, wbf: (C, C) folded projections;
    wconv: (3, 3, C, out) HWIO. Returns (B, H, W, 16*out) in x's dtype.
    Inside a trace it is the op ``sunet::fused_dual_upsample4_conv_phase``
    (``kernels/ops.py``)."""
    if torch.compiler.is_compiling():
        return torch.ops.sunet.fused_dual_upsample4_conv_phase(x, w_exp, alpha_p, w_b1, b_b1,
                                                               alpha_b, wpf, wbf, wconv)
    return _conv_phase_impl(x, w_exp, alpha_p, w_b1, b_b1, alpha_b, wpf, wbf, wconv)


def _conv_phase_impl(x, w_exp, alpha_p, w_b1, b_b1, alpha_b, wpf, wbf, wconv) -> torch.Tensor:
    name = "fused_dual_upsample4_conv_phase"
    count = _build.counter(name)
    if x.device.type == "cpu":
        count.cpu += 1
        return fused_dual_upsample4_conv_phase_reference(
            x, w_exp, alpha_p, w_b1, b_b1, alpha_b, wpf, wbf, wconv)
    _check_up4(name, x, w_exp, w_b1, wpf, wbf, wconv, max_c=UP4_CONV_KERNEL_MAX_C, c_align=4)
    B, H, W, C = x.shape
    out_ch = wconv.shape[-1]
    if x.dtype == torch.float32:
        out = _conv_phase_f32(x, w_exp, alpha_p, w_b1, b_b1, alpha_b, wpf, wbf, wconv)
        count.cuda += 1
        return out
    plan = up4_plan(C, out_ch)
    wexp_s, w_b1, bb1, wpf, wbf = up4_conv_operands(w_exp, w_b1, b_b1, wpf, wbf, plan["Cp"])
    alphas, _ = _alphas_bias(alpha_p, b_b1, alpha_b, x.device)
    out = torch.empty((B, H, W, 16 * out_ch), device=x.device, dtype=BF16)
    err = _build.library().sunet_up4_conv_phase(
        _build.ptr(x), _build.ptr(out), _build.ptr(wexp_s), _build.ptr(w_b1),
        _build.ptr(bb1), _build.ptr(wpf), _build.ptr(wbf), _build.ptr(wconv),
        _build.ptr(alphas), B, H, W, C, out_ch, plan["T"], _build.stream())
    _build.check(name, err)
    count.cuda += 1
    return out


def f32_up4_wexp(w_exp: torch.Tensor) -> torch.Tensor:
    """w_exp (C, 16C), column c * 16 + s feeding subpixel s's channel c, as
    #5's float32 form takes it: column s * C + c (subpixel-major), so that
    the expand product's rows are (pixel, subpixel) rows of C values."""
    C = w_exp.shape[0]
    return w_exp.reshape(C, C, 16).transpose(1, 2).reshape(C, 16 * C).contiguous()


def _conv_phase_f32(x, w_exp, alpha_p, w_b1, b_b1, alpha_b, wpf, wbf, wconv) -> torch.Tensor:
    """#5's float32 form (csrc/f32_up4.cu), one launch, w_exp in
    subpixel-major columns (:func:`f32_up4_wexp`, a copy per call)."""
    name = "fused_dual_upsample4_conv_phase"
    B, H, W, C = x.shape
    out_ch = wconv.shape[-1]
    f32_up4_plan(H, W, C, out_ch)   # raises on a shape outside the design
    wexp = f32_up4_wexp(w_exp)
    alphas, bb1 = _alphas_bias(alpha_p, b_b1, alpha_b, x.device)
    lib = _build.library()
    work = torch.empty(lib.sunet_f32_up4_conv_workspace(B, H, W, C), device=x.device,
                       dtype=torch.uint8)
    out = torch.empty((B, H, W, 16 * out_ch), device=x.device, dtype=x.dtype)
    err = lib.sunet_f32_up4_conv(
        _build.ptr(x), _build.ptr(out), _build.ptr(wexp), _build.ptr(w_b1), _build.ptr(bb1),
        _build.ptr(wpf), _build.ptr(wbf), _build.ptr(wconv), _build.ptr(alphas),
        _build.ptr(work), B, H, W, C, out_ch, _build.stream())
    _build.check(name, err)
    return out


def _check_up4(name, x, w_exp, w_b1, wpf, wbf, wconv, *, max_c=UP4_KERNEL_MAX_C,
               c_align: int = 16):
    """The conv-fused head's kernels take C a multiple of ``c_align`` (16;
    the forward 4, padded to 16 inside; 16 in float32) with C rounded up to
    16 at most max_c, and 1 <= out <= UP4_KERNEL_MAX_OUT, any H and W."""
    _check_x(name, x)
    if x.dtype == torch.float32:
        c_align = 16
    B, H, W, C = x.shape
    out_ch = wconv.shape[-1]
    if C % c_align or _up(C, 16) > max_c or not 1 <= out_ch <= UP4_KERNEL_MAX_OUT:
        raise ValueError(f"{name}: C={C}, out={out_ch}: the kernel takes C a "
                         f"multiple of {c_align} up to {max_c} and "
                         f"1 <= out <= {UP4_KERNEL_MAX_OUT}")
    _check_w(name, x, w_exp=(w_exp, (C, 16 * C)), w_b1=(w_b1, (C, C)),
             wpf=(wpf, (C, C)), wbf=(wbf, (C, C)),
             wconv=(wconv, (3, 3, C, out_ch)))


def up4_conv_bwd(x, w_exp, alpha_p, w_b1, b_b1, alpha_b, wpf, wbf, wconv,
                 dout) -> tuple:
    """Backward of :func:`fused_dual_upsample4_conv_phase` (JAX
    ``_up4c_bwd_impl``): dout (B, H, W, 16*out) phase-space cotangent.
    Returns (dx, dw_exp (C, 16C), dalpha_p, dw_b1, db_b1, dalpha_b, dwpf,
    dwbf, dwconv (3, 3, C, out)), the grads float32. CUDA:
    ``csrc/up4_conv_bwd.cu``, :func:`up4_conv_bwd_launches` launches
    (:func:`up4_conv_bwd_plan`), each counted; any H and W; C a multiple of
    4 up to UP4_CONV_BWD_WIDE_MAX_C, run over C rounded up to 16 (the scaled
    config's 180 over 192, as the forward), the returned gradients at C."""
    name = "up4_conv_bwd"
    count = _build.counter(name)
    C = x.shape[-1]
    if x.device.type == "cpu":
        count.cpu += up4_conv_bwd_launches(C)
        return up4_conv_bwd_reference(x, w_exp, alpha_p, w_b1, b_b1, alpha_b,
                                      wpf, wbf, wconv, dout)
    _check_up4(name, x, w_exp, w_b1, wpf, wbf, wconv, max_c=UP4_CONV_BWD_WIDE_MAX_C, c_align=4)
    B, H, W, C = x.shape
    out_ch = wconv.shape[-1]
    plan = up4_conv_bwd_plan(H, W, C, out_ch)
    dev = x.device
    dout = dout.to(BF16).contiguous()
    if tuple(dout.shape) != (B, H, W, 16 * out_ch):
        raise ValueError(f"{name}: dout shape {tuple(dout.shape)}")
    Cr, C = C, plan["Cp"]
    if C != Cr:   # the operands zero-padded to Cp: the pad channels add nothing
        x, w_exp, w_b1, b_b1, wpf, wbf, wconv = up4_bwd_pad_operands(
            C, x, w_exp, w_b1, b_b1, wpf, wbf, wconv)
    alphas, bb1 = _alphas_bias(alpha_p, b_b1, alpha_b, dev)
    lib = _build.library()
    work = torch.empty(lib.sunet_up4_conv_bwd_workspace(B, H, W, C, out_ch),
                       device=dev, dtype=torch.uint8)
    z = lambda *s: torch.empty(*s, device=dev, dtype=torch.float32)
    dx = torch.empty_like(x)
    # dw_exp in w_exp's (C, 16C) layout, dalphas (2,), dwb1, dbb1, dwpf,
    # dwbf, dwconv (3, 3, C, out)
    grads = [z(C, 16 * C), z(2), z(C, C), z(C), z(C, C), z(C, C),
             z(3, 3, C, out_ch)]
    launches = _build.c_int(0)
    err = lib.sunet_up4_conv_bwd(
        _build.ptr(x), _build.ptr(dout), _build.ptr(w_exp), _build.ptr(w_b1),
        _build.ptr(bb1), _build.ptr(wpf), _build.ptr(wbf), _build.ptr(wconv),
        _build.ptr(alphas), _build.ptr(dx), *[_build.ptr(g) for g in grads],
        _build.ptr(work), B, H, W, C, out_ch, plan["tiles_per_chunk"],
        _build.byref(launches), _build.stream())
    _build.check(name, err)
    count.cuda += launches.value
    dw_exp, dal, dwb1, dbb1, dwpf, dwbf, dwconv = grads
    if C != Cr:   # the pad channels' gradients dropped
        sq = lambda g: g[:Cr, :Cr]
        dx = dx[..., :Cr].contiguous()
        dw_exp = dw_exp.reshape(C, C, 16)[:Cr, :Cr].reshape(Cr, 16 * Cr)
        dwb1, dbb1, dwpf, dwbf, dwconv = sq(dwb1), dbb1[:Cr], sq(dwpf), sq(dwbf), dwconv[:, :, :Cr]
    return (dx, dw_exp, dal[0].reshape(alpha_p.shape), dwb1, dbb1,
            dal[1].reshape(alpha_b.shape), dwpf, dwbf, dwconv)


def up4_bwd_pad_operands(Cp: int, x, w_exp, w_b1, b_b1, wpf, wbf, wconv) -> tuple:
    """#9's operands at width Cp >= C (:func:`up4_conv_bwd_plan`'s "Cp"): x
    with Cp - C zero channels, every C axis of the weights zero-padded (w_exp
    (C, 16C) in its column order c * 16 + s). The pad channels' z, a, xb and
    dY are zeros, so they add nothing to the real channels' gradients."""
    C = x.shape[-1]
    pad = Cp - C
    square = lambda w: F.pad(w, (0, pad, 0, pad)).contiguous()
    return (F.pad(x, (0, pad)).contiguous(),
            F.pad(w_exp.reshape(C, C, 16), (0, 0, 0, pad, 0, pad)).reshape(Cp, 16 * Cp),
            square(w_b1), F.pad(b_b1, (0, pad)), square(wpf), square(wbf),
            F.pad(wconv, (0, 0, 0, pad)).contiguous())


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
        _gate("fused_dual_upsample4_conv_phase", x, train=True)
        return _conv_phase_impl(x, *p)

    @staticmethod
    def backward(ctx, dout):
        x, *p = ctx.saved_tensors
        return up4_conv_bwd(x, *p, dout.contiguous())


def _check_up4_split(name, x, w_exp, w_b1, wpf, wbf):
    _check_x(name, x)
    C = x.shape[-1]
    if C % 16 or C > UP4_SPLIT_KERNEL_MAX_C:
        raise ValueError(f"{name}: C={C}: the kernel takes C a multiple of 16 "
                         f"up to {UP4_SPLIT_KERNEL_MAX_C}")
    _check_w(name, x, w_exp=(w_exp, (C, 16 * C)), w_b1=(w_b1, (C, C)),
             wpf=(wpf, (C, C)), wbf=(wbf, (C, C)))


def fused_dual_upsample4(x, w_exp, alpha_p, w_b1, b_b1, alpha_b, wpf,
                         wbf) -> torch.Tensor:
    """Split x4 dual up-sample head (JAX ``fused_dual_upsample4``).

    x: (B, H, W, C); w_exp: (C, 16C) pixel-shuffle expand, (in, out) layout,
    column c*16 + i*4 + j feeding pixel (4h+i, 4w+j) channel c; w_b1: (C,
    C), b_b1: (C,); wpf, wbf: (C, C) folded projections. Returns (B, 4H, 4W,
    C) in x's dtype. CUDA: ``csrc/up4.cu``, UP4_SPLIT_LAUNCHES launches
    (:func:`up4_split_plan`), each counted; any H and W. Inside a trace it
    is the op ``sunet::fused_dual_upsample4``."""
    if torch.compiler.is_compiling():
        return torch.ops.sunet.fused_dual_upsample4(x, w_exp, alpha_p, w_b1, b_b1, alpha_b, wpf,
                                                    wbf)
    return _split_head_impl(x, w_exp, alpha_p, w_b1, b_b1, alpha_b, wpf, wbf)


def _split_head_impl(x, w_exp, alpha_p, w_b1, b_b1, alpha_b, wpf, wbf) -> torch.Tensor:
    name = "fused_dual_upsample4"
    count = _build.counter(name)
    if x.device.type == "cpu":
        count.cpu += UP4_SPLIT_LAUNCHES
        return fused_dual_upsample4_reference(x, w_exp, alpha_p, w_b1, b_b1,
                                              alpha_b, wpf, wbf)
    _check_up4_split(name, x, w_exp, w_b1, wpf, wbf)
    B, H, W, C = x.shape
    plan = up4_split_plan(H, W, C)
    alphas, bb1 = _alphas_bias(alpha_p, b_b1, alpha_b, x.device)
    lib = _build.library()
    work = torch.empty(lib.sunet_up4_workspace(B, H, W, C), device=x.device,
                       dtype=torch.uint8)
    out = torch.empty((B, 4 * H, 4 * W, C), device=x.device, dtype=BF16)
    launches = _build.c_int(0)
    err = lib.sunet_up4(
        _build.ptr(x), _build.ptr(out), _build.ptr(w_exp), _build.ptr(w_b1),
        _build.ptr(bb1), _build.ptr(wpf), _build.ptr(wbf), _build.ptr(alphas),
        _build.ptr(work), B, H, W, C, plan["tiles_per_chunk"], _build.byref(launches),
        _build.stream())
    _build.check(name, err)
    count.cuda += launches.value
    return out


def up4_bwd(x, w_exp, alpha_p, w_b1, b_b1, alpha_b, wpf, wbf, dout) -> tuple:
    """Backward of :func:`fused_dual_upsample4` (JAX ``_up4_bwd_impl``):
    dout (B, 4H, 4W, C) pixel-space cotangent. Returns (dx, dw_exp (C,
    16C), dalpha_p, dw_b1, db_b1, dalpha_b, dwpf, dwbf), the grads float32.
    CUDA: ``csrc/up4_bwd.cu``, UP4_BWD_LAUNCHES launches
    (:func:`up4_bwd_plan`), each counted; any H and W."""
    name = "up4_bwd"
    count = _build.counter(name)
    if x.device.type == "cpu":
        count.cpu += UP4_BWD_LAUNCHES
        return up4_bwd_reference(x, w_exp, alpha_p, w_b1, b_b1, alpha_b, wpf,
                                 wbf, dout)
    _check_up4_split(name, x, w_exp, w_b1, wpf, wbf)
    B, H, W, C = x.shape
    plan = up4_bwd_plan(H, W, C)
    dev = x.device
    if tuple(dout.shape) != (B, 4 * H, 4 * W, C) or dout.device != dev:
        raise ValueError(f"{name}: dout {tuple(dout.shape)} on {dout.device}, "
                         f"expected {(B, 4 * H, 4 * W, C)} on {dev}")
    dout = dout.to(BF16).contiguous()
    alphas, bb1 = _alphas_bias(alpha_p, b_b1, alpha_b, dev)
    lib = _build.library()
    work = torch.empty(lib.sunet_up4_bwd_workspace(B, H, W, C), device=dev,
                       dtype=torch.uint8)
    z = lambda *s: torch.empty(*s, device=dev, dtype=torch.float32)
    dx = torch.empty_like(x)
    # dw_exp in w_exp's (C, 16C) layout, dalphas (2,), dwb1, dbb1, dwpf, dwbf
    grads = [z(C, 16 * C), z(2), z(C, C), z(C), z(C, C), z(C, C)]
    launches = _build.c_int(0)
    err = lib.sunet_up4_bwd(
        _build.ptr(x), _build.ptr(dout), _build.ptr(w_exp), _build.ptr(w_b1),
        _build.ptr(bb1), _build.ptr(wpf), _build.ptr(wbf), _build.ptr(alphas),
        _build.ptr(dx), *[_build.ptr(g) for g in grads], _build.ptr(work),
        B, H, W, C, plan["tiles_per_chunk"], _build.byref(launches), _build.stream())
    _build.check(name, err)
    count.cuda += launches.value
    dw_exp, dal, dwb1, dbb1, dwpf, dwbf = grads
    return (dx, dw_exp, dal[0].reshape(alpha_p.shape), dwb1, dbb1,
            dal[1].reshape(alpha_b.shape), dwpf, dwbf)


class DualUpsample4Trainable(torch.autograd.Function):
    """Differentiable split x4 head (JAX ``dual_upsample4_trainable``):
    forward = :func:`fused_dual_upsample4`, backward = :func:`up4_bwd`.
    Weights come in float32 and are cast to x's dtype for the kernels;
    their grads come back in float32. Returns (B, 4H, 4W, C)."""

    @staticmethod
    def forward(ctx, x, w_exp, alpha_p, w_b1, b_b1, alpha_b, wpf, wbf):
        dt = x.dtype
        cast = lambda w: w.detach().to(dt).contiguous()
        x = x.contiguous()
        p = (cast(w_exp), alpha_p.detach(), cast(w_b1), b_b1.detach(),
             alpha_b.detach(), cast(wpf), cast(wbf))
        ctx.save_for_backward(x, *p)
        return _split_head_impl(x, *p)

    @staticmethod
    def backward(ctx, dout):
        x, *p = ctx.saved_tensors
        return up4_bwd(x, *p, dout.contiguous())
