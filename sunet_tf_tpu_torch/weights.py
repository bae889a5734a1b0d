"""Load reference-format SUNet weights into the port.

The reference format is the ``state_dict`` the original torch code saves and
``tools/export_torch_checkpoint.py::params_to_state_dict`` writes: keys under
``swin_unet.``, tensors in torch layouts. The port's module tree carries the
same names, so loading is ``load_state_dict(strict=True)`` once two kinds of
buffer are set aside: ``relative_position_index`` and the SW-MSA
``attn_mask``, which the port computes from shapes at call time. Each is
checked against the port's own and dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from sunet_tf_tpu_torch.ops.window import relative_position_index, shift_attn_mask

PREFIX = "swin_unet."


def _expected_buffer(model, key: str) -> np.ndarray:
    if key.endswith(".attn.relative_position_index"):
        attn = model.get_submodule(key[: -len(".relative_position_index")])
        ws = attn.window_size
        return relative_position_index(ws, ws).astype(np.int64)
    block = model.get_submodule(key[: -len(".attn_mask")])
    H, W = block.input_resolution
    return shift_attn_mask(H, W, block.window_size, block.shift_size)


def load_reference_state_dict(model: torch.nn.Module, sd) -> torch.nn.Module:
    """Load ``sd`` (a dict of numpy arrays or tensors, or a reference
    ``.pth`` payload ``{'state_dict': ...}``) into ``model``; returns it."""
    if "state_dict" in sd:
        sd = sd["state_dict"]
    params = {}
    for key, value in sd.items():
        key = key.removeprefix(PREFIX)
        if key.endswith((".relative_position_index", ".attn_mask")):
            want = _expected_buffer(model, key)
            got = np.asarray(value.cpu() if torch.is_tensor(value) else value)
            if got.shape != want.shape or not np.array_equal(got, want):
                raise ValueError(f"{key}: buffer differs from the one this "
                                 "model computes for its shapes")
            continue
        params[key] = (value if torch.is_tensor(value)
                       else torch.from_numpy(np.array(value)))
    model.load_state_dict(params, strict=True)
    return model


def load_reference_checkpoint(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a reference ``.pth`` file into ``model``."""
    return load_reference_state_dict(
        model, torch.load(path, map_location="cpu", weights_only=True))
