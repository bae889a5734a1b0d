"""NHWC image ops (``sunet_tf_tpu/ops/image.py``).

- ``pixel_shuffle`` keeps torch.nn.PixelShuffle's channel order
  (out[b, h*r+i, w*r+j, c] = in[b, h, w, c*r*r + i*r + j]).
- ``bilinear_resize`` is the half-pixel (``align_corners=False``) bilinear
  up-sample with edge clamping that jax.image.resize also computes.
- ``psnr`` clamps to [0, 1] (reference utils/image_utils.py:6-10); ``ssim``
  uses the pytorch_msssim / MATLAB defaults (gaussian 11x11, sigma 1.5).
- ``dihedral_batch`` applies the reference's 9-valued augmentation op
  index; ``add_awgn`` and ``random_crop_pair`` draw from an explicit
  generator; ``center_crop`` rounds as torchvision's center_crop.
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


# Rec.601 luma weights (the reference's target conversion, train.py:328-329).
_LUMA = (0.2989, 0.5870, 0.1140)


def rgb_to_gray(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) -> (..., H, W, 1) Rec.601 luma."""
    return _LUMA[0] * x[..., 0:1] + _LUMA[1] * x[..., 1:2] + _LUMA[2] * x[..., 2:3]


def psnr(target: torch.Tensor, pred: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """PSNR over the whole batch, both images clamped to [0, data_range]."""
    t = target.float().clamp(0.0, data_range)
    p = pred.float().clamp(0.0, data_range)
    rmse = torch.sqrt(torch.mean((t - p) ** 2))
    return 20.0 * torch.log10(data_range / rmse.clamp_min(1e-12))


def psnr_per_sample(target: torch.Tensor, pred: torch.Tensor,
                    data_range: float = 1.0) -> torch.Tensor:
    """(B,) PSNR per image (the reference's batch-1 eval protocol)."""
    t = target.float().clamp(0.0, data_range)
    p = pred.float().clamp(0.0, data_range)
    rmse = torch.sqrt(torch.mean((t - p) ** 2, dim=tuple(range(1, t.dim()))))
    return 20.0 * torch.log10(data_range / rmse.clamp_min(1e-12))


def _gaussian_kernel1d(size: int, sigma: float, device) -> torch.Tensor:
    coords = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def ssim_per_sample(target: torch.Tensor, pred: torch.Tensor, data_range: float = 1.0,
                    kernel_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
                    k2: float = 0.03) -> torch.Tensor:
    """(B,) mean SSIM per NHWC image: separable depthwise gaussian, VALID
    windows (pytorch_msssim / MATLAB defaults), float32 without TF32."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    x = target.float().permute(0, 3, 1, 2)
    y = pred.float().permute(0, 3, 1, 2)
    C = x.shape[1]
    g = _gaussian_kernel1d(kernel_size, sigma, x.device)
    kh = g.reshape(1, 1, kernel_size, 1).repeat(C, 1, 1, 1)
    kw = g.reshape(1, 1, 1, kernel_size).repeat(C, 1, 1, 1)
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        blur = lambda t: F.conv2d(F.conv2d(t, kh, groups=C), kw, groups=C)
        mu_x, mu_y = blur(x), blur(y)
        sxx = blur(x * x) - mu_x * mu_x
        syy = blur(y * y) - mu_y * mu_y
        sxy = blur(x * y) - mu_x * mu_y
    finally:
        torch.backends.cudnn.allow_tf32 = old
    num = (2.0 * mu_x * mu_y + c1) * (2.0 * sxy + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (sxx + syy + c2)
    return (num / den).mean(dim=(1, 2, 3))


def ssim(target: torch.Tensor, pred: torch.Tensor, **kw) -> torch.Tensor:
    """Mean SSIM over a batch of NHWC images (mean of the per-image means,
    equal to the JAX package's pooled mean for same-size images)."""
    return ssim_per_sample(target, pred, **kw).mean()


# Every dihedral op factors as (transpose?) then (flip H?) then (flip W?);
# tables indexed by the reference op id 0..8 (dataset_RGB.py:63-84: 0 and 8
# are identity, 1 flip rows, 2 flip cols, 3 rot90, 4 rot180, 5 rot270, 6
# rot90 of flip rows, 7 rot90 of flip cols).
_DH_TR = (0, 0, 0, 1, 0, 1, 1, 1, 0)
_DH_FH = (0, 1, 0, 1, 1, 0, 1, 0, 0)
_DH_FW = (0, 0, 1, 0, 1, 1, 1, 0, 0)


def dihedral(img: torch.Tensor, op: int) -> torch.Tensor:
    """One of the 8-way dihedral ops on an (H, W, C) image (square for the
    transposing ops)."""
    return dihedral_batch(img[None], torch.tensor([int(op)]))[0]


def dihedral_batch(imgs: torch.Tensor, ops: torch.Tensor) -> torch.Tensor:
    """Per-image dihedral ops on a (B, H, W, C) batch of square images; any
    dtype (the training step runs it on uint8)."""
    def pick(table):
        t = torch.tensor(table, dtype=torch.bool, device=imgs.device)
        return t[ops.to(imgs.device).long()].reshape(-1, 1, 1, 1)

    x = torch.where(pick(_DH_TR), imgs.transpose(1, 2), imgs)
    x = torch.where(pick(_DH_FH), x.flip(1), x)
    return torch.where(pick(_DH_FW), x.flip(2), x)


def add_awgn(generator: torch.Generator, clean: torch.Tensor,
             sigma: float) -> torch.Tensor:
    """Additive white Gaussian noise from ``generator``: clean in [0, 1],
    sigma on the 0-255 scale."""
    noise = torch.randn(clean.shape, generator=generator, device=clean.device,
                        dtype=clean.dtype)
    return clean + (sigma / 255.0) * noise


def random_crop_pair(generator: torch.Generator, inp: torch.Tensor, tar: torch.Tensor,
                     ps: int) -> tuple:
    """Aligned random crop of an (H, W, C) pair to (ps, ps, C): the row,
    then the column offset drawn from ``generator``."""
    H, W = inp.shape[0], inp.shape[1]
    r, c = (int(torch.randint(0, n - ps + 1, (1,), generator=generator,
                              device=generator.device).item()) for n in (H, W))
    return inp[r:r + ps, c:c + ps], tar[r:r + ps, c:c + ps]


def center_crop(img: torch.Tensor, ps: int) -> torch.Tensor:
    """Center crop of an (H, W, C) image to (ps, ps, C) (the reference's
    val crop, dataset_RGB.py:120-122; torchvision's rounding)."""
    H, W = img.shape[0], img.shape[1]
    top = int(round((H - ps) / 2.0))
    left = int(round((W - ps) / 2.0))
    return img[top:top + ps, left:left + ps]
