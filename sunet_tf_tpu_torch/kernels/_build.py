"""Build and load the hand-written CUDA kernels, and count their launches.

Each ``csrc/*.cu`` source compiles to an object in its own ``nvcc``
process, all started together, and one more ``nvcc`` call links them into a
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at the first CUDA call (never at import: the CPU tests import every
module), into ``kernels/_build/`` (git-ignored), and is cached by a hash of
the sources and flags. A build error raises with nvcc's output.

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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
c_int = ctypes.c_int
byref = ctypes.byref
# C signatures of the entry points in csrc/*.cu (all return cudaError_t,
# except the *_workspace sizes, which return size_t).
SIGNATURES = {
    # x, out, ln1 g/b, wqkv, bqkv, wproj, bproj, ln2 g/b, w1, b1, w2, b2,
    # bias, mask, dp (B, 2) or NULL, B, H, W, C, hidden, ws, heads, shift,
    # scale, stream
    "sunet_swin_block": [_P] * 17 + [_I] * 8 + [_F, _P],
    # x, dout, ln1 g/b, wqkv, bqkv, wproj, bproj, ln2 g/b, w1, b1, w2, b2,
    # bias, mask, dp, dx, 13 grads (ln1 g/b, wqkv, bqkv, wproj, bproj, ln2
    # g/b, w1, b1, w2, b2, bias), workspace, B, H, W, C, hidden, ws, heads,
    # shift, scale, int* launches, stream
    "sunet_swin_block_bwd": [_P] * 32 + [_I] * 8 + [_F, _P, _P],
    # B, H, W, C, hidden, ws, heads -> workspace bytes
    "sunet_swin_block_bwd_workspace": [_I] * 7,
    # x, dout, w_exp (C, 16C), wb1, bb1, wpf, wbf, wconv, alphas, dx,
    # dw_exp, dalphas, dwb1, dbb1, dwpf, dwbf, dwfold, workspace, B, H, W,
    # C, out, int* launches, stream
    "sunet_up4_conv_bwd": [_P] * 18 + [_I] * 5 + [_P, _P],
    # B, H, W, C, out -> workspace bytes
    "sunet_up4_conv_bwd_workspace": [_I] * 5,
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
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    nvcc = _nvcc()
    procs = []
    for cu in sorted(CSRC.glob("*.cu")):
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o",
               str(work / (cu.stem + ".o")), str(cu)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    if not failed:
        cmd = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
               "-o", str(work / "lib.so"), *sorted(str(o) for o in work.glob("*.o"))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed.append(f"link failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        else:
            # atomic: a concurrent process never loads half a file
            os.replace(work / "lib.so", target)
    shutil.rmtree(work, ignore_errors=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    return "\n".join(log)


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
                fn.restype = (ctypes.c_size_t if name.endswith("_workspace")
                              else ctypes.c_int)
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
