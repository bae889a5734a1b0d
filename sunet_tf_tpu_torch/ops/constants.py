"""Tensors that a forward builds from shapes alone (the SW-MSA masks, the
relative-position index, the tiled fold's coverage counts), cached per key
on their device.

The cache also serves ``torch.export`` (``infer/export.py``): a trace reads
the real tensor that a live run of the same shapes cached, and the exported
program holds it once, as a constant on its device. A tensor first built
inside a trace is not cached (it is fake there); the program then builds it
on each call.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

MAX_ENTRIES = 256
_CACHE: OrderedDict = OrderedDict()


def shape_constant(key: tuple, build) -> torch.Tensor:
    """``build()``'s tensor for ``key`` (which names its shapes and device),
    built once and kept (the least recently used beyond MAX_ENTRIES
    dropped). Built outside inference mode, so training may save it for
    backward."""
    t = _CACHE.get(key)
    if t is not None:
        _CACHE.move_to_end(key)
        return t
    if torch.compiler.is_compiling():
        return build()
    with torch.inference_mode(False):
        t = build()
    _CACHE[key] = t
    if len(_CACHE) > MAX_ENTRIES:
        _CACHE.popitem(last=False)
    return t
