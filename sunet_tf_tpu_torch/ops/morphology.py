"""Boundary-ring loss weights on the device (``sunet_tf_tpu/ops/morphology.py``).

Binary dilation with an all-ones 3x3 footprint is a 3x3 max-pool. Weights
(reference train.py:200-249): foreground 3.0, ring i of the k=2 dilation
rings ring_w[i] (3, 2), background 0; all-zero weights fall back to ones;
then normalised so that the BATCH mean is 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

STROKE_W = 3.0
RING_W = (3.0, 2.0, 1.0)
K_RINGS = 2


def binary_dilate3x3(x: torch.Tensor) -> torch.Tensor:
    """8-connected dilation of an NHWC {0, 1} float map."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=1, padding=1)
    return y.permute(0, 2, 3, 1)


def boundary_ring_weights(target: torch.Tensor, k: int = K_RINGS,
                          stroke_w: float = STROKE_W, ring_w: tuple = RING_W,
                          bg_min: float = 0.0, normalize_to_mean_one: bool = True,
                          threshold: float = 0.5) -> torch.Tensor:
    """Per-pixel loss weights for a (B, H, W, 1) target in [0, 1]."""
    fg = (target > threshold).float()
    weights = torch.where(fg > 0, torch.full_like(fg, stroke_w),
                          torch.full_like(fg, bg_min))
    prev = fg
    for i in range(k):
        dil = binary_dilate3x3(prev)
        wv = ring_w[i] if i < len(ring_w) else ring_w[-1]
        weights = torch.where(dil - prev > 0, torch.full_like(fg, wv), weights)
        prev = dil
    weights = torch.where(weights.sum() == 0.0, torch.ones_like(weights), weights)
    if normalize_to_mean_one:
        weights = weights / weights.mean().clamp_min(1e-8)
    return weights
