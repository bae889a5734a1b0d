"""NHWC image ops used by the dual up-sample (``sunet_tf_tpu/ops/image.py``).

- ``pixel_shuffle`` keeps torch.nn.PixelShuffle's channel order
  (out[b, h*r+i, w*r+j, c] = in[b, h, w, c*r*r + i*r + j]).
- ``bilinear_resize`` is the half-pixel (``align_corners=False``) bilinear
  up-sample with edge clamping that jax.image.resize also computes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H, W, C*r*r) -> (B, H*r, W*r, C)."""
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)


def bilinear_resize(x: torch.Tensor, scale: int) -> torch.Tensor:
    """NHWC bilinear up-sample by an integer factor, half-pixel centres."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=scale,
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)
