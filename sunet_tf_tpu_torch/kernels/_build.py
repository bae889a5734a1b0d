"""Build and load the hand-written CUDA kernels, and count their launches.

Each ``csrc/*.cu`` source compiles to an object in its own ``nvcc``
process, all started together, and one more ``nvcc`` call links them into a
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at the first CUDA call (never at import: the CPU tests import every
module), into ``BUILD_DIR`` (``kernels/_build/``, git-ignored, unless
``utils/cache.py`` moves it), and is cached by a hash of
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
DEFAULT_BUILD_DIR = Path(__file__).resolve().parent / "_build"
# where the library builds and is cached (utils/cache.py can move it)
BUILD_DIR = DEFAULT_BUILD_DIR
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
    # device -> cudaError_t of setting it (csrc/runtime.cu)
    "sunet_thread_init": [_I],
    # x, out, ln1 g/b, wqkv, bqkv, wproj, bproj, ln2 g/b, w1, b1, w2, b2,
    # bias, mask, dp (B, 2) or NULL, B, H, W, C, hidden, ws, heads, shift,
    # scale, the launch plan's cluster size G, stream
    "sunet_swin_block": [_P] * 17 + [_I] * 8 + [_F, _I, _P],
    # sunet_swin_block's pointers, then eb, rden, ctx_f; B, H, W, C, hidden,
    # ws, heads, shift, scale, the launch plan's cluster size G, stream
    "sunet_swin_block_res": [_P] * 20 + [_I] * 8 + [_F, _I, _P],
    # x, dout, ln1 g/b, wqkv, bqkv, wproj, bproj, ln2 g/b, w1, b1, w2, b2,
    # bias, mask, dp, dx, 13 grads (ln1 g/b, wqkv, bqkv, wproj, bproj, ln2
    # g/b, w1, b1, w2, b2, bias), workspace, B, H, W, C, hidden, ws, heads,
    # shift, scale, int* launches, stream
    "sunet_swin_block_bwd": [_P] * 32 + [_I] * 8 + [_F, _P, _P],
    # B, H, W, C, hidden, ws, heads -> workspace bytes
    "sunet_swin_block_bwd_workspace": [_I] * 7,
    # sunet_swin_block_bwd's pointers; B, H, W, C (the padded width), cr
    # (the real channels), hidden, ws, heads, shift, scale, int* launches,
    # stream
    "sunet_swin_block_bwd_big": [_P] * 32 + [_I] * 9 + [_F, _P, _P],
    # B, H, W, C, cr, hidden, ws, heads -> workspace bytes
    "sunet_swin_block_bwd_big_workspace": [_I] * 8,
    # x, dout, eb, rden, ctx_f, ln1 g/b, wqkv, bqkv, wproj, bproj, ln2 g/b,
    # w1, b1, w2, b2, dp, dx, 13 grads, workspace, B, H, W, C, hidden, ws,
    # heads, shift, scale, int* launches, stream
    "sunet_swin_block_bwd_res": [_P] * 33 + [_I] * 8 + [_F, _P, _P],
    # B, H, W, C, hidden, ws, heads -> workspace bytes
    "sunet_swin_block_bwd_res_workspace": [_I] * 7,
    # x, dout, w_exp (C, 16C), wb1, bb1, wpf, wbf, wconv, alphas, dx,
    # dw_exp, dalphas, dwb1, dbb1, dwpf, dwbf, dwconv (3, 3, C, out),
    # workspace, B, H, W, C, out, the launch plan's tiles per chunk, int*
    # launches, stream
    "sunet_up4_conv_bwd": [_P] * 18 + [_I] * 6 + [_P, _P],
    # B, H, W, C, out -> workspace bytes
    "sunet_up4_conv_bwd_workspace": [_I] * 5,
    # x, dout, ln g/b, wqkv, bqkv, wproj, bias, mask, dx, 7 grads (ln g/b,
    # wqkv, bqkv, wproj, bproj, bias), workspace, B, H, W, C, ws, heads,
    # scale, int* launches, stream
    "sunet_ln_wmsa_bwd": [_P] * 18 + [_I] * 6 + [_F, _P, _P],
    # B, H, W, C, ws, heads -> workspace bytes
    "sunet_ln_wmsa_bwd_workspace": [_I] * 6,
    # y, out, ln g/b, w1, b1, w2, b2, workspace, M, C, hidden, ks (the
    # launch plan's K split of fc2), int* launches, stream
    "sunet_ln_mlp_branch": [_P] * 9 + [_I] * 4 + [_P, _P],
    # M, C, hidden -> workspace bytes
    "sunet_ln_mlp_branch_workspace": [_I] * 3,
    # y, dout, ln g/b, w1, b1, w2, dy, 6 grads (ln g/b, w1, b1, w2, b2),
    # workspace, B, H, W, C, hidden, the launch plan's K split ks, int*
    # launches, stream
    "sunet_ln_mlp_bwd": [_P] * 15 + [_I] * 6 + [_P, _P],
    # B, H, W, C, hidden -> workspace bytes
    "sunet_ln_mlp_bwd_workspace": [_I] * 5,
    # x, out, ln g/b, wqkv, bqkv, wproj, bproj, bias, mask, workspace, B, H,
    # W, C, ws, heads, scale, the launch plan's K splits (qkv, proj), int*
    # launches, stream
    "sunet_ln_wmsa": [_P] * 11 + [_I] * 6 + [_F, _I, _I, _P, _P],
    # M, C -> workspace bytes
    "sunet_ln_wmsa_workspace": [_I] * 2,
    # y, out, ln g/b, w1, b1, w2, b2, workspace, M, C, hidden, the launch
    # plan's K splits of fc1 and fc2, int* launches, stream
    "sunet_ln_mlp": [_P] * 9 + [_I] * 5 + [_P, _P],
    # x, out, ln1 g/b, wqkv, bqkv, wproj, bproj, ln2 g/b, w1, b1, w2, b2,
    # bias, mask, dp (B, 2) or NULL, workspace, B, H, W, C, hidden, ws, heads,
    # shift, scale, the launch plan's depth Kp and K splits (qkv, proj, fc1,
    # fc2), int* launches, stream
    "sunet_swin_block_seq": [_P] * 18 + [_I] * 8 + [_F] + [_I] * 5 + [_P, _P],
    # M, C, hidden -> workspace bytes
    "sunet_swin_block_seq_workspace": [_I] * 3,
    # M, C, hidden -> workspace bytes
    "sunet_ln_mlp_workspace": [_I] * 3,
    # x, out, wexp(16,C,C), wb1, bb1, wpf, wbf, wconv(3,3,C,out), alphas,
    # B, H, W, C, out_ch, the launch plan's tiles per CTA, stream
    "sunet_up4_conv_phase": [_P] * 9 + [_I] * 6 + [_P],
    # x, out (B, 4H, 4W, C), w_exp (C, 16C), wb1, bb1, wpf, wbf, alphas,
    # workspace, B, H, W, C, the launch plan's tiles per chunk, int*
    # launches, stream
    "sunet_up4": [_P] * 9 + [_I] * 5 + [_P, _P],
    # B, H, W, C -> workspace bytes
    "sunet_up4_workspace": [_I] * 4,
    # x, dout (B, 4H, 4W, C), w_exp (C, 16C), wb1, bb1, wpf, wbf, alphas, dx,
    # dw_exp, dalphas, dwb1, dbb1, dwpf, dwbf, workspace, B, H, W, C, the
    # launch plan's tiles per chunk, int* launches, stream
    "sunet_up4_bwd": [_P] * 16 + [_I] * 5 + [_P, _P],
    # B, H, W, C -> workspace bytes
    "sunet_up4_bwd_workspace": [_I] * 4,
    # xw, out, wqkv, bqkv, wproj, bproj, bias, mask, workspace, T, nW, ws,
    # C, heads, scale, the launch plan's K splits (qkv, proj), int*
    # launches, stream
    "sunet_wmsa_core": [_P] * 9 + [_I] * 5 + [_F, _I, _I, _P, _P],
    # x, out, n, op, T, stream
    "sunet_alu_chain": [_P, _P, ctypes.c_longlong, _I, _I, _P],
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


def _digest(flags: tuple = NVCC_FLAGS) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(target: Path, flags: tuple = NVCC_FLAGS) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    nvcc = _nvcc()
    procs = []
    for cu in sorted(CSRC.glob("*.cu")):
        cmd = [nvcc, *flags, "-I", str(CSRC), "-c", "-o",
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


def _load(target: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(target))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = (ctypes.c_size_t if name.endswith("_workspace")
                      else ctypes.c_int)
    return lib


def loaded() -> bool:
    """Whether this process has loaded a kernel library."""
    return _Library.lib is not None


def library_path() -> Path:
    """Where :func:`library` builds the kernel library of these sources."""
    return BUILD_DIR / f"libsunet_kernels_{_digest()}.so"


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    with _Library.lock:
        if _Library.lib is None:
            t0 = time.perf_counter()
            target = library_path()
            if not target.exists():
                _Library.log = _compile(target)
            _Library.lib = _load(target)
            _Library.seconds = time.perf_counter() - t0
        return _Library.lib


def use_variant(defines: tuple) -> ctypes.CDLL:
    """Build the kernels with extra ``-D`` macros (e.g. a measurement
    build) into their own library, and make it the one the wrappers call
    in this process."""
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    target = BUILD_DIR / f"libsunet_kernels_{_digest(flags)}.so"
    with _Library.lock:
        if not target.exists():
            _Library.log = _compile(target, flags)
        _Library.lib = _load(target)
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


_THREAD = threading.local()


def stream() -> ctypes.c_void_p:
    """The current CUDA stream, for a launch from this host thread. The
    first launch on a device from a thread first sets up the library's own
    CUDA runtime there (``csrc/runtime.cu``)."""
    dev = torch.cuda.current_device()
    ready = _THREAD.__dict__.setdefault("devices", set())
    if dev not in ready:
        check("sunet_thread_init", library().sunet_thread_init(dev))
        ready.add(dev)
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
