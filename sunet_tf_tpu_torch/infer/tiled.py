"""Fixed-size padded inference (counterpart of the first part of
``sunet_tf_tpu/infer/tiled.py``): reflect-pad to the model's granularity,
run, crop back."""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F


def required_granularity(patch_size: int, num_stages: int, win_size: int) -> int:
    """Smallest g such that any HxW with g | H, W runs through every stage."""
    return patch_size * (2 ** (num_stages - 1)) * win_size


def reflect_pad_nhwc(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Reflect-pad the bottom and right of an NHWC tensor.

    Raises where a pad reaches the input's size: reflection is defined for
    pads smaller than the size (numpy's ``pad`` reflects again past it)."""
    if ph == 0 and pw == 0:
        return x
    H, W = x.shape[1], x.shape[2]
    if ph >= H or pw >= W:
        raise ValueError(f"reflect pad ({ph}, {pw}) must be smaller than the "
                         f"image ({H}, {W}); resize the image or use a "
                         "smaller granularity")
    y = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="reflect")
    return y.permute(0, 2, 3, 1)


def padded_inference(model_fn: Callable, img: torch.Tensor,
                     granularity: int) -> torch.Tensor:
    """Run ``model_fn`` at the reflect-padded size, crop back to the input."""
    B, H, W, C = img.shape
    Hp = math.ceil(H / granularity) * granularity
    Wp = math.ceil(W / granularity) * granularity
    y = model_fn(reflect_pad_nhwc(img, Hp - H, Wp - W))
    return y[:, :H, :W, :]
