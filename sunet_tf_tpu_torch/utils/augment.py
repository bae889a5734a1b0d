"""MixUp and Gaussian blur (``sunet_tf_tpu/utils/augment.py``; the
reference's utils/dataset_utils.py MixUp_AUG and utils/GaussianBlur.py,
whose get_gaussian_kernel raised NameError if called).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


class MixUp:
    """Mixes each sample with its partner in the flipped batch by lam ~
    Beta(alpha, alpha), one lam per sample (the reference's MixUp_AUG).

    ``torch.distributions.Beta`` takes no generator, so lam comes from a
    numpy ``Generator`` seeded by one value drawn from the caller's
    ``torch.Generator`` (:meth:`lam`): the same torch generator state gives
    the same lam."""

    def __init__(self, alpha: float = 0.6):
        self.alpha = alpha

    def lam(self, generator: torch.Generator, batch: int) -> torch.Tensor:
        """(batch, 1, 1, 1) float32 Beta(alpha, alpha) draws, on the CPU."""
        seed = int(torch.randint(0, 1 << 62, (1,), generator=generator,
                                 device=generator.device).item())
        lam = np.random.default_rng(seed).beta(self.alpha, self.alpha, (batch, 1, 1, 1))
        return torch.from_numpy(lam.astype(np.float32))

    @staticmethod
    def mix(lam: torch.Tensor, target: torch.Tensor, inp: torch.Tensor) -> tuple:
        """(lam * target + (1 - lam) * flipped target, the same of inp)."""
        lam = lam.to(device=target.device, dtype=target.dtype)
        return (lam * target + (1 - lam) * target.flip(0),
                lam * inp + (1 - lam) * inp.flip(0))

    def __call__(self, generator: torch.Generator, target: torch.Tensor,
                 inp: torch.Tensor) -> tuple:
        return self.mix(self.lam(generator, target.shape[0]), target, inp)


def gaussian_blur_kernel(kernel_size: int = 5, sigma: float = 2.0) -> np.ndarray:
    """(k, k) normalised 2D Gaussian, float32 (the reference's math)."""
    ax = np.arange(kernel_size, dtype=np.float64)
    xx, yy = np.meshgrid(ax, ax, indexing="ij")
    mean = (kernel_size - 1) / 2.0
    var = float(sigma) ** 2
    k = (1.0 / (2.0 * np.pi * var)) * np.exp(
        -((xx - mean) ** 2 + (yy - mean) ** 2) / (2.0 * var))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(x: torch.Tensor, kernel_size: int = 5, sigma: float = 2.0) -> torch.Tensor:
    """Depthwise Gaussian blur of an NHWC tensor with SAME zero padding:
    (k - 1) // 2 before and k // 2 after on each axis (asymmetric for an
    even k, as XLA's SAME)."""
    C = x.shape[-1]
    k = torch.from_numpy(gaussian_blur_kernel(kernel_size, sigma)).to(x.device, x.dtype)
    lo, hi = (kernel_size - 1) // 2, kernel_size // 2
    xp = F.pad(x.permute(0, 3, 1, 2), (lo, hi, lo, hi))
    y = F.conv2d(xp, k.expand(C, 1, kernel_size, kernel_size), groups=C)
    return y.permute(0, 2, 3, 1)
