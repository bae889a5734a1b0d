"""RGB <-> HSV / HSL converters on (..., 3) tensors (``sunet_tf_tpu/utils/
color.py``; the reference's utils/image_utils.py:29-104).

All channels in [0, 1]; hue is fractional (h in [0, 1) is degrees / 360).
Branchless (``torch.where``); JAX's float ``%`` is ``torch.remainder`` (the
sign of the divisor), not ``torch.fmod``, which differs on negatives.
"""

from __future__ import annotations

import torch


def _hue(rgb: torch.Tensor, cmax: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    safe = torch.where(delta == 0, torch.ones_like(delta), delta)
    h = torch.where(cmax == r, torch.remainder((g - b) / safe, 6.0),
                    torch.where(cmax == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
    return torch.where(delta == 0, torch.zeros_like(h), h) / 6.0


def _from_sextant(h: torch.Tensor, c: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """RGB of hue ``h``, chroma ``c`` and offset ``m``."""
    x = c * (1.0 - torch.abs(torch.remainder(h * 6.0, 2.0) - 1.0))
    idx = torch.remainder(torch.floor(h * 6.0).to(torch.int32), 6)
    z = torch.zeros_like(c)

    def pick(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(idx == k, vals[k], out)
        return out

    r = pick(c, x, z, z, x, c)
    g = pick(x, c, c, x, z, z)
    b = pick(z, z, x, c, c, x)
    return torch.stack([r + m, g + m, b + m], dim=-1)


def rgb2hsv(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB -> HSV."""
    cmax, cmin = rgb.amax(-1), rgb.amin(-1)
    delta = cmax - cmin
    s = torch.where(cmax == 0, torch.zeros_like(cmax),
                    delta / torch.where(cmax == 0, torch.ones_like(cmax), cmax))
    return torch.stack([_hue(rgb, cmax, delta), s, cmax], dim=-1)


def hsv2rgb(hsv: torch.Tensor) -> torch.Tensor:
    """(..., 3) HSV -> RGB."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    c = v * s
    return _from_sextant(h, c, v - c)


def rgb2hsl(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB -> HSL."""
    cmax, cmin = rgb.amax(-1), rgb.amin(-1)
    delta = cmax - cmin
    l = (cmax + cmin) / 2.0
    denom = 1.0 - torch.abs(2.0 * l - 1.0)
    s = torch.where((l <= 0.0) | (l >= 1.0), torch.zeros_like(l),
                    delta / torch.where(denom == 0, torch.ones_like(denom), denom))
    return torch.stack([_hue(rgb, cmax, delta), s, l], dim=-1)


def hsl2rgb(hsl: torch.Tensor) -> torch.Tensor:
    """(..., 3) HSL -> RGB."""
    h, s, l = hsl[..., 0], hsl[..., 1], hsl[..., 2]
    c = (1.0 - torch.abs(2.0 * l - 1.0)) * s
    return _from_sextant(h, c, l - c / 2.0)
