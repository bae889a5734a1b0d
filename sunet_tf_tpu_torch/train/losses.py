"""Losses (``sunet_tf_tpu/train/losses.py``, reference train.py:187-197).

Charbonnier and MSE in float32 (float64 for float64 operands), with an optional per-pixel weight under the
reference's sum(l * w) / max(sum(w), 1e-8) normalisation; the per-sample
variants reduce over each image's own pixels (the batch-1 eval protocol).
"""

from __future__ import annotations

from typing import Optional

import torch

from sunet_tf_tpu_torch.kernels.window_attention import wide


def _reduce(l: torch.Tensor, weight: Optional[torch.Tensor], dims) -> torch.Tensor:
    if weight is None:
        return l.mean(dim=dims) if dims else l.mean()
    w = wide(weight)
    if not dims:
        return (l * w).sum() / w.sum().clamp_min(1e-8)
    return (l * w).sum(dim=dims) / w.sum(dim=dims).clamp_min(1e-8)


def charbonnier(pred, target, eps: float = 1e-3) -> torch.Tensor:
    """The per-pixel Charbonnier loss, float32 (float64 for float64 operands)."""
    diff = wide(pred) - wide(target)
    return torch.sqrt(diff * diff + eps * eps)


def squared_error(pred, target) -> torch.Tensor:
    """The per-pixel squared error, float32 (float64 for float64 operands)."""
    return (wide(pred) - wide(target)) ** 2


def charbonnier_loss(pred, target, weight=None, eps: float = 1e-3) -> torch.Tensor:
    return _reduce(charbonnier(pred, target, eps), weight, None)


def mse_loss(pred, target, weight=None) -> torch.Tensor:
    return _reduce(squared_error(pred, target), weight, None)


def charbonnier_per_sample(pred, target, weight=None, eps: float = 1e-3) -> torch.Tensor:
    l = charbonnier(pred, target, eps)
    return _reduce(l, weight, tuple(range(1, l.dim())))


def mse_per_sample(pred, target, weight=None) -> torch.Tensor:
    l = squared_error(pred, target)
    return _reduce(l, weight, tuple(range(1, l.dim())))
