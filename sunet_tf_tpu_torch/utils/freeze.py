"""Parameter freezing (``sunet_tf_tpu/utils/freeze.py``; the reference's
utils/model_utils.py:6-18 freeze / unfreeze).

A frozen parameter takes no gradient (``requires_grad_(False)``) and the
optimizer is built over the trainable ones alone, so frozen parameters get
no update and hold no Adam state (JAX: ``optax.multi_transform`` with
``set_to_zero``). The trainer does not wire freezing, as JAX's does not.
"""

from __future__ import annotations

from typing import Callable

import torch

from sunet_tf_tpu_torch.train.adam import AdamLP


def freeze_mask(model: torch.nn.Module, predicate: Callable[[str], bool]) -> dict:
    """{parameter name: trainable}: ``predicate`` gets each parameter's
    name in the model's ``state_dict`` (the reference checkpoint's key
    without its ``swin_unet.`` prefix) and returns True where it trains."""
    return {name: bool(predicate(name)) for name, _ in model.named_parameters()}


def partition_trainable(model: torch.nn.Module, mask: dict, lr_schedule, **adam_kw) -> AdamLP:
    """Freeze the parameters ``mask`` marks False and return an
    :class:`AdamLP` (``lr_schedule`` and ``adam_kw`` as its own) over the
    others."""
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    return AdamLP(model.parameters(), lr_schedule, **adam_kw)
