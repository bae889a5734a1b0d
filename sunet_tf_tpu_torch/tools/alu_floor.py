"""ALU-rate probe of the card: the elementwise rates that bound the
softmax and GELU passes of the port's kernels.

    python -m sunet_tf_tpu_torch.tools.alu_floor [--t 2048] [--sass]

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
the tanh form: the ``gelu`` rate stands in for theirs. ``--sass`` prints
instead each chain step's instructions per pipe (FP32, ALU, MUFU) as the
card's compiler built them (:func:`sass_step_counts`): the counts that the
probe's bound divides by each pipe's rate (``chip_smoke.alu_cost``).

The probe measures the card; it refuses to run without one. On a CPU tensor
:func:`alu_chain` runs its plain version, :func:`alu_chain_reference`.
"""

from __future__ import annotations

import argparse
import math
import os
import re
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


# Pipes of the SASS instructions a chain step issues, and each pipe's
# results per SM and clock on compute capability 9.0 (the CUDA C++
# Programming Guide's arithmetic-instruction throughput table): the FP32
# pipe (add, multiply, fused multiply-add: 128), the ALU pipe (compares,
# selects, min/max, integer and logic ops: 64) and the special-function
# unit (MUFU: reciprocal, exp2, tanh, ...: 16). Moves, branches and the
# loop's own counter are not counted.
PIPE_RATES = {"fp32": 128, "alu": 64, "mufu": 16}
_PIPES = {"fp32": ("FFMA", "FMUL", "FADD", "FFMA32I", "FMUL32I", "FADD32I"),
          "alu": ("FSETP", "FSEL", "FMNMX", "FSET", "ISETP", "IADD3", "LOP3", "SEL", "SHF",
                  "LEA", "PRMT", "IMNMX", "ISET", "PLOP3"),
          "mufu": ("MUFU",)}
# The closing y * a + b of each op's step: an FFMA whose last operand is b.
_STEP_END = {"fma": "0.0010000000474974513054", "exp": "0.25",
             "tanh": "0.050000000745058059692", "gelu": "0.050000000745058059692"}


def _sass_functions(text: str) -> dict:
    """{mangled name: [(address, opcode, operands)]} of a cuobjdump -sass
    listing (predicates dropped)."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);",
                     line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3).strip()))
    return funcs


def sass_step_counts(text: str) -> dict:
    """Per op of the probe, one chain step's instructions per pipe, from a
    cuobjdump -sass listing of the kernel library: of the innermost loops
    of alu_chain_kernel<op> (a branch back to a lower address with no loop
    inside), the one of the most steps (the unrolled chain the launch spends
    its time in), its counts divided by its steps (the FFMA that closes each
    step, y * a + b with the op's own b)."""
    out = {}
    for name, ins in _sass_functions(text).items():
        if "alu_chain_kernel" not in name:
            continue
        op = OPS[int(name.split("ILi")[1].split("E")[0])]
        loops = []
        for addr, opc, arg in ins:
            if opc == "BRA" and arg.startswith("0x") and int(arg, 16) < addr:
                loops.append((int(arg, 16), addr))
        best = None
        for lo, hi in loops:
            if any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b in loops):
                continue   # not innermost
            body = [(o, a) for addr, o, a in ins if lo <= addr <= hi]
            steps = sum(1 for o, a in body if o == "FFMA" and a.endswith(_STEP_END[op]))
            if steps and (best is None or steps > best[0]):
                best = (steps, body)
        if best is None:
            raise RuntimeError(f"alu_floor: no chain loop found in {name}")
        steps, body = best
        cnt = {p: sum(1 for o, _ in body if o.split(".")[0] in names) / steps
               for p, names in _PIPES.items()}
        out[op] = {"steps": steps, **cnt, "body": [f"{o} {a}" for o, a in body]}
    return out


def sass_listing() -> str:
    """cuobjdump -sass of the kernel library (built if need be), by the CUDA
    toolkit's cuobjdump beside nvcc."""
    _build.library()
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", str(_build.library_path())], capture_output=True,
                          text=True, check=True).stdout


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return (smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip()
            else f"nvidia-smi unavailable ({torch.cuda.get_device_name(0)})")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--t", type=int, default=T, help="chain steps per launch")
    ap.add_argument("--sass", action="store_true",
                    help="print each chain step's instructions per pipe (cuobjdump) instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("alu_floor: no CUDA device; the probe measures the card")
    print(card())
    if args.sass:
        counts = sass_step_counts(sass_listing())
        for op in OPS:
            c = counts[op]
            print(f"{op:5s}: per step " + ", ".join(f"{p} {c[p]:g}" for p in PIPE_RATES)
                  + f" (a loop of {c['steps']} steps)")
            for line in c["body"]:
                print(f"    {line}")
        return counts
    rates = {}
    for op in OPS:
        r, ms = rate(op, args.t)
        rates[op] = (r, ms)
        print(f"{op:5s}: {r:8.1f} Gelem/s  ({ms:.4f} ms/launch, T={args.t}, "
              f"{ROWS}x{LANES} float32)")
    return rates


if __name__ == "__main__":
    main()
