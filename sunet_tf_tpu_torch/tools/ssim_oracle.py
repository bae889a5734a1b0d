"""Independent float64 SSIM oracle on scipy (the port's copy of the JAX
repo's ``tools/ssim_oracle.py``).

The skimage ``structural_similarity`` protocol with
``gaussian_weights=True, sigma=1.5, use_sample_covariance=False,
data_range=1``: scipy's gaussian filter in float64, per-channel SSIM maps
cropped to the windows that never touch the border (the valid
convolution), channel-averaged. A compute path apart from
``ops.image.ssim_per_sample`` (separable float32 convolutions in torch), so
that a k1/k2, kernel-normalisation or padding slip there cannot cancel
out; the reference reports half of its evaluation as SSIM.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter


def ssim_oracle_single(target: np.ndarray, pred: np.ndarray,
                       data_range: float = 1.0, sigma: float = 1.5,
                       truncate: float = 3.5, k1: float = 0.01,
                       k2: float = 0.03) -> float:
    """Mean SSIM of one (H, W, C) or (H, W) image pair, float64.

    truncate=3.5, sigma=1.5 give radius int(3.5*1.5+0.5)=5: the 11x11
    window of skimage's win_size rule."""
    x = np.asarray(target, np.float64)
    y = np.asarray(pred, np.float64)
    if x.ndim == 2:
        x, y = x[..., None], y[..., None]
    pad = int(truncate * sigma + 0.5)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    def filt(a):
        return gaussian_filter(a, sigma, truncate=truncate, mode="reflect")

    vals = []
    for c in range(x.shape[-1]):
        xc, yc = x[..., c], y[..., c]
        ux, uy = filt(xc), filt(yc)
        vx = filt(xc * xc) - ux * ux
        vy = filt(yc * yc) - uy * uy
        vxy = filt(xc * yc) - ux * uy
        s = (((2.0 * ux * uy + c1) * (2.0 * vxy + c2))
             / ((ux * ux + uy * uy + c1) * (vx + vy + c2)))
        # the windows that reach the border see the reflection: cropped,
        # so that every value left is the valid convolution's
        vals.append(float(s[pad:-pad, pad:-pad].mean()))
    return float(np.mean(vals))


def ssim_oracle(targets: np.ndarray, preds: np.ndarray,
                data_range: float = 1.0, **kw) -> np.ndarray:
    """(B,) per-image oracle SSIM of (B, H, W, C) batches."""
    return np.asarray([ssim_oracle_single(t, p, data_range, **kw)
                       for t, p in zip(targets, preds)])
