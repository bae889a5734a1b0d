"""Fixed-size padded inference (counterpart of the first part of
``sunet_tf_tpu/infer/tiled.py``): reflect-pad to the model's granularity,
run, crop back."""

from __future__ import annotations

import math
from typing import Callable

import torch


def required_granularity(patch_size: int, num_stages: int, win_size: int) -> int:
    """Smallest g such that any HxW with g | H, W runs through every stage."""
    return patch_size * (2 ** (num_stages - 1)) * win_size


def _reflect_index(n: int, pad: int) -> torch.Tensor:
    """Source rows of ``n + pad`` reflect-padded rows: the index folds with
    period 2(n - 1), so a pad past the size reflects again (numpy's and
    ``jnp.pad``'s ``mode="reflect"``); a size of 1 repeats its one row."""
    i = torch.arange(n + pad)
    if n == 1:
        return torch.zeros_like(i)
    m = i % (2 * (n - 1))
    return torch.where(m < n, m, 2 * (n - 1) - m)


def reflect_pad_nhwc(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Reflect-pad the bottom and right of an NHWC tensor, reflecting again
    where a pad reaches the input's size."""
    if ph == 0 and pw == 0:
        return x
    H, W = x.shape[1], x.shape[2]
    y = x.index_select(1, _reflect_index(H, ph).to(x.device))
    return y.index_select(2, _reflect_index(W, pw).to(x.device))


def padded_inference(model_fn: Callable, img: torch.Tensor,
                     granularity: int) -> torch.Tensor:
    """Run ``model_fn`` at the reflect-padded size, crop back to the input."""
    B, H, W, C = img.shape
    Hp = math.ceil(H / granularity) * granularity
    Wp = math.ceil(W / granularity) * granularity
    y = model_fn(reflect_pad_nhwc(img, Hp - H, Wp - W))
    return y[:, :H, :W, :]
