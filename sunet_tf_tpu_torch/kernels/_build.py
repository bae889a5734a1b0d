"""Build and load the hand-written CUDA kernels, and count their launches.

All ``csrc/*.cu`` sources compile in ONE ``nvcc`` call into a shared library
with a plain C interface, loaded with ``ctypes``. The build runs at the
first CUDA call (never at import: the CPU tests import every module), into
``kernels/_build/`` (git-ignored), and is cached by a hash of the sources
and flags. A build error raises with nvcc's output.

Every C entry point takes raw device pointers and the CUDA stream as
``void*``, launches on that stream without synchronising, and returns
``cudaGetLastError()``; :func:`check` raises if it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points in csrc/*.cu (all return cudaError_t).
SIGNATURES = {
    # x, out, ln1 g/b, wqkv, bqkv, wproj, bproj, ln2 g/b, w1, b1, w2, b2,
    # bias, mask, B, H, W, C, hidden, ws, heads, shift, scale, stream
    "sunet_swin_block": [_P] * 16 + [_I] * 8 + [_F, _P],
    # x, ctx, ln g/b, wqkv, bqkv, bias, mask, B, H, W, C, ws, heads, scale,
    # stream
    "sunet_ln_wmsa_ctx": [_P] * 8 + [_I] * 6 + [_F, _P],
    # A, W, bias, out, M, K, Nout, stream
    "sunet_linear_bias": [_P] * 4 + [_I] * 3 + [_P],
    # y, out, ln g/b, w1, b1, w2, b2, M, C, hidden, stream
    "sunet_ln_mlp": [_P] * 8 + [_I] * 3 + [_P],
    # x, out, wexp(16,C,C), wb1, bb1, wpf, wbf, wconv(3,3,C,out), alphas,
    # B, H, W, C, out_ch, stream
    "sunet_up4_conv_phase": [_P] * 9 + [_I] * 5 + [_P],
}


class LaunchCount:
    """Plain-integer counts for one wrapper. ``cuda``: kernel launches, one
    added at each launch. ``cpu``: the launches that the plain version stood
    in for on a CPU tensor, in the same units, so one router prediction
    (``SUNet.expected_launches``) holds for both."""

    def __init__(self):
        self.cuda = 0
        self.cpu = 0

    def reset(self):
        self.cuda = 0
        self.cpu = 0


COUNTS: dict = {}


def counter(name: str) -> LaunchCount:
    return COUNTS.setdefault(name, LaunchCount())


def reset_counts():
    for c in COUNTS.values():
        c.reset()


class _Library:
    lib = None
    seconds = 0.0
    log = ""
    lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(target: Path) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, target)  # atomic: a concurrent process never loads half a file
    return proc.stdout + proc.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    with _Library.lock:
        if _Library.lib is None:
            t0 = time.perf_counter()
            target = BUILD_DIR / f"libsunet_kernels_{_digest()}.so"
            if not target.exists():
                _Library.log = _compile(target)
            lib = ctypes.CDLL(str(target))
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _Library.seconds = time.perf_counter() - t0
            _Library.lib = lib
        return _Library.lib


def build_info() -> tuple:
    """(seconds the first library() call took, nvcc's output) of this process."""
    return _Library.seconds, _Library.log


def check(name: str, err: int):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def ptr(t):
    """Device pointer of a tensor (None -> NULL)."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
