"""Where one launch of the cluster block kernel (#1, ``csrc/swin_cluster.cu``)
spends its time, phase by phase, on the card.

    python -m sunet_tf_tpu_torch.tools.block_phases [--batch 4]

Builds the kernels with ``-DSUNET_PHASE_CLOCK`` (a library of its own, beside
the normal one), which makes thread 0 of every CTA record its SM clock at
each phase boundary. Runs ``fused_swin_block`` at the default model's three
block widths, (64,64,96), (32,32,192) and (16,16,384), window 8, 8 heads,
shift 0, bf16, seeded weights, and prints per width the launch plan, the
median over CTAs of each phase's clock cycles and of a CTA's total, how
many of its clusters the card holds at once (the occupancy API), beside
the card's name and power limit (the launch's time is chip_smoke.py's and
chip_ab.py's reading). The clocks are per SM (not comparable across SMs),
so only differences within one CTA are used. These shares are the per-layer
metric of #1's redesign (PERF.md, Layers): which phases to overlap next.
Refuses to run without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from sunet_tf_tpu_torch.kernels import _build
from sunet_tf_tpu_torch.kernels import window_attention as wa

# the phase ends, in kernel order (kPhases = 13 boundaries)
PHASES = ("x in", "LN1", "qkv", "attention", "ctx gather", "proj", "y gather", "LN2",
          "fc1", "fc2", "partials", "reduce + out")
SHAPES = ((64, 96), (32, 192), (16, 384))


def block_args(B: int, H: int, C: int, gen) -> tuple:
    n = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    w = lambda i, o: (n(i, o) / i ** 0.5).to(torch.bfloat16)
    x = n(B, H, H, C).to(torch.bfloat16)
    return (x, (1 + 0.1 * n(C), 0.1 * n(C)), w(C, 3 * C), 0.1 * n(3 * C), w(C, C), 0.1 * n(C),
            (1 + 0.1 * n(C), 0.1 * n(C)), w(C, 4 * C), 0.1 * n(4 * C), w(4 * C, C), 0.1 * n(C),
            n(8, 64, 64), None)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    B = ap.parse_args().batch
    if not torch.cuda.is_available():
        raise SystemExit("block_phases: torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi unavailable")
    lib = _build.use_variant(("SUNET_PHASE_CLOCK",))
    lib.sunet_swin_block_phase_clock.argtypes = [ctypes.c_void_p]
    lib.sunet_swin_block_max_clusters.argtypes = [ctypes.c_int, ctypes.c_longlong]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for H, C in SHAPES:
        args = block_args(B, H, C, gen)
        plan = wa.block_plan(H, H, C, 4 * C, 8, 8)
        ctas = B * plan["ctas_per_image"]
        clocks = torch.zeros(ctas, len(PHASES) + 1, dtype=torch.int64, device="cuda")
        run = lambda: wa.fused_swin_block(*args, ws=8, num_heads=8, scale=8.0)
        _build.check("block_phases", lib.sunet_swin_block_phase_clock(
            ctypes.c_void_p(clocks.data_ptr())))
        run()
        torch.cuda.synchronize()
        _build.check("block_phases", lib.sunet_swin_block_phase_clock(None))
        c = clocks.cpu().double()
        phase = (c[:, 1:] - c[:, :-1]).median(0).values
        total = float((c[:, -1] - c[:, 0]).median())
        held = lib.sunet_swin_block_max_clusters(plan["G"], plan["smem"])
        print(f"({H},{H},{C}) batch {B}: cluster {plan['G']}, {ctas} CTAs, {plan['smem']} bytes "
              f"of shared memory, {held} clusters held at once; per CTA {total:.0f} cycles")
        print("  " + ", ".join(f"{name} {v:.0f} ({v / total:.0%})"
                               for name, v in zip(PHASES, phase.tolist())))


if __name__ == "__main__":
    main()
