"""Windowing primitives for shifted-window attention on NHWC tensors.

Same contracts as ``sunet_tf_tpu/ops/window.py``:

- ``window_partition`` / ``window_reverse`` are exact inverses and tile a
  (B, H, W, C) map into (B * nW, ws*ws, C) windows in row-major window order.
- ``relative_position_index`` is the Swin pairwise index into the
  ((2*wh-1)*(2*ww-1),) relative-position-bias table.
- ``shift_attn_mask`` is the 9-region SW-MSA mask with 0 / -100 entries,
  indexed by the window's position in ROLLED coordinates.
- ``effective_window``: when ``min(resolution) <= window_size`` the window
  shrinks to the resolution and the shift is disabled (the 8x8 bottleneck
  of the default model runs one unshifted 8x8 window).

The two index builders are numpy and cached: they depend on shapes only.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

MASK_NEG = -100.0


def effective_window(resolution: tuple, window_size: int, shift_size: int) -> tuple:
    """Auto-degrade (window, shift) when the window exceeds the resolution."""
    if min(resolution) <= window_size:
        return min(resolution), 0
    return window_size, shift_size


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nH * nW, ws*ws, C), windows in row-major order."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_reverse(windows: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    """Inverse of :func:`window_partition`: (B*nW, ws*ws, C) -> (B, H, W, C)."""
    nW = (H // ws) * (W // ws)
    B = windows.shape[0] // nW
    C = windows.shape[-1]
    x = windows.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


@functools.lru_cache(maxsize=None)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """Pairwise relative-position index, shape (wh*ww, wh*ww), int32."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def shift_attn_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """Additive SW-MSA mask, shape (nW, ws*ws, ws*ws), float32 {0, -100}.

    All zeros when shift == 0.
    """
    n = ws * ws
    nW = (H // ws) * (W // ws)
    if shift == 0:
        return np.zeros((nW, n, n), dtype=np.float32)
    img = np.zeros((1, H, W, 1), dtype=np.float32)
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for wsl in slices:
            img[:, hs, wsl, :] = cnt
            cnt += 1
    m = img.reshape(1, H // ws, ws, W // ws, ws, 1).transpose(0, 1, 3, 2, 4, 5)
    m = m.reshape(-1, n)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, np.float32(MASK_NEG), np.float32(0.0))


def roll2d(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Cyclic shift on the two spatial axes of an NHWC tensor."""
    if shift == 0:
        return x
    return torch.roll(x, shifts=(shift, shift), dims=(1, 2))
