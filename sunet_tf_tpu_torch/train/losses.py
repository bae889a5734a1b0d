"""Losses (``sunet_tf_tpu/train/losses.py``, reference train.py:187-197).

Charbonnier and MSE in float32, with an optional per-pixel weight under the
reference's sum(l * w) / max(sum(w), 1e-8) normalisation; the per-sample
variants reduce over each image's own pixels (the batch-1 eval protocol).
"""

from __future__ import annotations

from typing import Optional

import torch


def _reduce(l: torch.Tensor, weight: Optional[torch.Tensor], dims) -> torch.Tensor:
    if weight is None:
        return l.mean(dim=dims) if dims else l.mean()
    w = weight.float()
    if not dims:
        return (l * w).sum() / w.sum().clamp_min(1e-8)
    return (l * w).sum(dim=dims) / w.sum(dim=dims).clamp_min(1e-8)


def charbonnier_loss(pred, target, weight=None, eps: float = 1e-3) -> torch.Tensor:
    diff = pred.float() - target.float()
    return _reduce(torch.sqrt(diff * diff + eps * eps), weight, None)


def mse_loss(pred, target, weight=None) -> torch.Tensor:
    return _reduce((pred.float() - target.float()) ** 2, weight, None)


def charbonnier_per_sample(pred, target, weight=None, eps: float = 1e-3) -> torch.Tensor:
    diff = pred.float() - target.float()
    l = torch.sqrt(diff * diff + eps * eps)
    return _reduce(l, weight, tuple(range(1, l.dim())))


def mse_per_sample(pred, target, weight=None) -> torch.Tensor:
    l = (pred.float() - target.float()) ** 2
    return _reduce(l, weight, tuple(range(1, l.dim())))
