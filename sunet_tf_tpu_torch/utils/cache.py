"""Where the kernel library builds and is cached (the counterpart of
``sunet_tf_tpu/utils/cache.py``'s persistent compilation cache).

``kernels/_build.py`` compiles the CUDA sources once per hash of sources
and flags and keeps the library in its build directory; a later process
with the same sources loads it without compiling. The directory is chosen
by priority: the argument, then ``SUNET_KERNEL_CACHE_DIR``, then
``kernels/_build/`` beside the sources (git-ignored).
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path
from typing import Optional

ENV = "SUNET_KERNEL_CACHE_DIR"


def enable_kernel_cache(cache_dir: Optional[str] = None) -> str:
    """Make ``cache_dir`` (else ``$SUNET_KERNEL_CACHE_DIR``, else
    ``kernels/_build/``) the kernel library's build directory and return
    it. Once this process has loaded the library it has no effect: it
    warns and returns the directory in use."""
    from sunet_tf_tpu_torch.kernels import _build

    if _build.loaded():
        warnings.warn("enable_kernel_cache: the kernel library is already loaded in "
                      f"this process from {_build.BUILD_DIR}; the build directory "
                      "stays as it is", stacklevel=2)
        return str(_build.BUILD_DIR)
    _build.BUILD_DIR = Path(cache_dir or os.environ.get(ENV) or _build.DEFAULT_BUILD_DIR)
    return str(_build.BUILD_DIR)
