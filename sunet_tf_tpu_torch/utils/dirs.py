"""Directory helpers (``sunet_tf_tpu/utils/dirs.py``; the reference's
utils/dir_utils.py)."""

from __future__ import annotations

import glob
import os

from sunet_tf_tpu_torch.data.pipeline import natural_sorted


def mkdir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def mkdirs(paths) -> None:
    for p in paths if isinstance(paths, (list, tuple)) else [paths]:
        mkdir(p)


def get_last_path(path: str, suffix: str) -> str:
    """The last entry, in natural order, of ``path`` matching ``*suffix``
    (reference utils/dir_utils.py:19-21)."""
    matches = natural_sorted(glob.glob(os.path.join(path, f"*{suffix}")))
    if not matches:
        raise FileNotFoundError(f"no '*{suffix}' under {path}")
    return matches[-1]
