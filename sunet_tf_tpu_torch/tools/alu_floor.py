"""ALU-rate probe of the card: the elementwise rates that bound the
softmax and GELU passes of the port's kernels.

    python -m sunet_tf_tpu_torch.tools.alu_floor [--t 2048]

Counterpart of ``tools/vpu_floor.py`` (its ``rate``, a TPU vector-unit
microbenchmark): a (4096, 512) float32 array goes T times through one
elementwise chain in one launch of ``csrc/alu_floor.cu`` (:func:`alu_chain`),
each step depending on the last:

- ``fma``:  y * 0.999 + 0.001
- ``exp``:  exp(-y) * 0.5 + 0.25
- ``tanh``: tanh(y) * 0.9 + 0.05
- ``gelu``: tanh-form GELU(y) * 0.9 + 0.05 (JAX ``gelu(approximate=True)``)

:func:`rate` times chains of 16 and of 2 such launches, each fed the last's
output, with CUDA events (the best of three each), and divides their
difference by 14: the time of one launch with the launch gaps taken out.
It prints Gelem/s per op (elements times T over that time) beside the
card's name and power limit. The port's kernels use the exact erf GELU, not
the tanh form: the ``gelu`` rate stands in for theirs.

The probe measures the card; it refuses to run without one. On a CPU tensor
:func:`alu_chain` runs its plain version, :func:`alu_chain_reference`.
"""

from __future__ import annotations

import argparse
import math
import subprocess

import torch

from sunet_tf_tpu_torch.kernels import _build

OPS = ("fma", "exp", "tanh", "gelu")
ROWS, LANES = 4096, 512
T = 2048   # chain steps per launch


def alu_step_reference(y: torch.Tensor, op: str) -> torch.Tensor:
    """One step of op's chain in torch ops, float32."""
    if op == "fma":
        return y * 0.999 + 0.001
    if op == "exp":
        return torch.exp(-y) * 0.5 + 0.25
    if op == "tanh":
        return torch.tanh(y) * 0.9 + 0.05
    if op == "gelu":
        cdf = 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                      * (y + 0.044715 * (y * y * y))))
        return y * cdf * 0.9 + 0.05
    raise ValueError(f"op {op!r} not in {OPS}")


def alu_chain_reference(x: torch.Tensor, op: str, steps: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`alu_chain`."""
    y = x.float()
    for _ in range(steps):
        y = alu_step_reference(y, op)
    return y


def alu_chain(x: torch.Tensor, op: str, steps: int) -> torch.Tensor:
    """``steps`` applications of op's chain to the float32 array x, in one
    launch of the CUDA kernel; the plain version on a CPU tensor."""
    name = "alu_chain"
    count = _build.counter(name)
    if op not in OPS:
        raise ValueError(f"{name}: op {op!r} not in {OPS}")
    if x.device.type == "cpu":
        count.cpu += 1
        return alu_chain_reference(x, op, steps)
    if x.device.type != "cuda" or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous float32 CUDA tensor, got "
                         f"{x.dtype} on {x.device}")
    out = torch.empty_like(x)
    err = _build.library().sunet_alu_chain(
        _build.ptr(x), _build.ptr(out), x.numel(), OPS.index(op), int(steps),
        _build.stream())
    _build.check(name, err)
    count.cuda += 1
    return out


def rate(op: str, steps: int = T) -> tuple:
    """(Gelem/s, ms per launch) of op's chain of ``steps`` on the card, on
    uniform [0, 1) values from a fixed seed."""
    if not torch.cuda.is_available():
        raise RuntimeError("alu_floor: no CUDA device; the probe measures the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(ROWS, LANES, device="cuda", generator=gen)

    def timed(n: int, reps: int = 3) -> float:
        best = math.inf
        for _ in range(reps):
            s, e = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            y = x
            s.record()
            for _ in range(n):
                y = alu_chain(y, op, steps)
            e.record()
            torch.cuda.synchronize()
            best = min(best, s.elapsed_time(e))
        return best

    timed(2, reps=1)
    timed(16, reps=1)
    ms = (timed(16) - timed(2)) / 14
    return ROWS * LANES * steps / (ms * 1e-3) / 1e9, ms


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return (smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip()
            else f"nvidia-smi unavailable ({torch.cuda.get_device_name(0)})")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--t", type=int, default=T, help="chain steps per launch")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("alu_floor: no CUDA device; the probe measures the card")
    print(card())
    rates = {}
    for op in OPS:
        r, ms = rate(op, args.t)
        rates[op] = (r, ms)
        print(f"{op:5s}: {r:8.1f} Gelem/s  ({ms:.4f} ms/launch, T={args.t}, "
              f"{ROWS}x{LANES} float32)")
    return rates


if __name__ == "__main__":
    main()
