#!/usr/bin/env python3
"""Calibrate chip_smoke's limits for the backward kernels on one NVIDIA GPU.

    python3 chip_mutants.py [--out PATH]

Runs chip_smoke's backward checks (``compare_grads`` on the block backward
at (64,64,96), (32,32,192), (16,16,384), shift 0 and 4, batch 2, and on the
x4-head backward at (64,64,96) out 1) with failures reported instead of
raised, in four settings:

- ``kernel``: the CUDA kernels against their plain versions, two input
  seeds, logit gain 1 and 0.25 (the sound readings the limits must pass);
- ``floor``: the plain version run on the CPU against itself on the card
  (the spread of a reordering alone);
- one run per mutant: a copy of the repository under a temporary directory
  with one deliberate fault in a kernel source, built and checked there
  (each must fail).

Every reading goes to ``--out`` (default: beside the built kernels, in
``sunet_tf_tpu_torch/kernels/_build/``, git-ignored); the last lines
summarise the failing checks per setting. Needs one GPU; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# name: (source file under kernels/csrc, text, replacement)
MUTANTS = {
    "tanh_gelu_grad": ("swin_block_bwd.cu", """__device__ inline float gelu_grad_f(float v) {
  return 0.5f * (1.f + erff(v * 0.70710678118654752f)) +
         v * expf(-0.5f * v * v) * 0.3989422804014327f;
}""", """__device__ inline float gelu_grad_f(float v) {
  const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v), t = tanhf(u);
  return 0.5f * (1.f + t) +
         0.5f * v * (1.f - t * t) * 0.7978845608028654f * (1.f + 0.134145f * v * v);
}"""),
    "dp_missing_from_dm": ("swin_block_bwd.cu", "const float s2 = dp[2 * (r / (H * W)) + 1];",
                           "const float s2 = 1.f;"),
    "ln_bwd_no_mean": ("swin_block_bwd.cu", "    m1 = warp_sum(m1) / C;\n", "    m1 = 0.f;\n"),
    "up4_prelu_slope_ignored": (
        "up4_conv_bwd.cu",
        "dz[(size_t)m * 16 * C + n * 16 + s] = tobf(zz > 0.f ? v : *alpha * v);",
        "dz[(size_t)m * 16 * C + n * 16 + s] = tobf(v);"),
    "up4_stencil_edge_not_folded": (
        "up4_conv_bwd.cu",
        "const int lo = p < 2 ? max(u - 1, 0) : u, hi = p < 2 ? u : min(u + 1, n - 1);",
        "const int lo = p < 2 ? u - 1 : u, hi = p < 2 ? u : u + 1;"),
}

# Run inside a checkout: the backward checks of chip_smoke in one setting.
CASES = r'''
import sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from sunet_tf_tpu_torch.kernels import upsample as up
from sunet_tf_tpu_torch.kernels import window_attention as wa
from sunet_tf_tpu_torch.ops.window import shift_attn_mask

mode, seed, gain = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
fails = []
cs.check = lambda cond, msg: cond or fails.append(msg)
gen = torch.Generator(device="cuda").manual_seed(seed)
B, ws, heads, scale = 2, 8, 8, 8.0
dp = torch.tensor([[1 / 0.9, 1 / 0.9], [1 / 0.9, 0.0]], device="cuda")
cpu = lambda t: (None if t is None else tuple(cpu(u) for u in t) if isinstance(t, tuple)
                 else t.cpu())
tag = f"[{mode} seed {seed} gain {gain:g}]"
for H, C in ((64, 96), (32, 192), (16, 384)):
    for shift in (0, 4):
        p = cs.block_params(C, heads, ws * ws, gen, qkv_gain=gain)
        x = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
        dout = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
        mask = (torch.as_tensor(shift_attn_mask(H, H, ws, shift), device="cuda")
                if shift else None)
        args = (x, dout, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10], p[11],
                p[12], mask, dp)
        kw = dict(ws=ws, num_heads=heads, scale=scale, shift=shift)
        ref = wa.swin_block_bwd_reference(*args, **kw)
        got = (wa.swin_block_bwd_reference(*cpu(args), **kw) if mode == "floor"
               else wa.swin_block_bwd(*args, **kw))
        cs.compare_grads(f"swin_block_bwd ({H},{H},{C}) shift {shift} {tag}",
                         tuple(g.cuda() for g in got), ref, cs.BLOCK_GRADS)
n = lambda *s: torch.randn(*s, device="cuda", generator=gen)
bw = lambda i, o: (n(i, o) / i ** 0.5).to(torch.bfloat16)
H, C = 64, 96
hp = (n(B, H, H, C).to(torch.bfloat16), bw(C, 16 * C), torch.full((1,), 0.25, device="cuda"),
      bw(C, C), 0.1 * n(C), torch.full((1,), 0.2, device="cuda"), bw(C, C), bw(C, C),
      (n(3, 3, C, 1) / (9 * C) ** 0.5).to(torch.bfloat16), n(B, H, H, 16).to(torch.bfloat16))
ref = up.up4_conv_bwd_reference(*hp)
got = (up.up4_conv_bwd_reference(*cpu(hp)) if mode == "floor" else up.up4_conv_bwd(*hp))
cs.compare_grads(f"up4_conv_bwd (64,64,96) out 1 {tag}", tuple(g.cuda() for g in got), ref,
                 cs.UP4_GRADS)
print(f"SUMMARY {tag}: {len(fails)} failing checks", flush=True)
for f in fails:
    print(f"  failing: {f}", flush=True)
'''


def run(cwd: Path, mode: str, seed: int, gain: float, log) -> list:
    proc = subprocess.run([sys.executable, "-c", CASES, mode, str(seed), str(gain)], cwd=cwd,
                          capture_output=True, text=True)
    log.write(proc.stdout + proc.stderr)
    log.flush()
    if proc.returncode != 0:
        raise SystemExit(f"chip_mutants: {mode} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    return [ln for ln in proc.stdout.splitlines() if ln.startswith("SUMMARY")]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "sunet_tf_tpu_torch" / "kernels" / "_build"
                                         / "chip_mutants.log"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_mutants: torch.cuda.is_available() is false")
    if not (ROOT / "sunet_tf_tpu_torch").is_dir():
        raise SystemExit(f"chip_mutants: package sunet_tf_tpu_torch not found at {ROOT}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    summary = []
    with open(out, "w") as log, tempfile.TemporaryDirectory() as tmp:
        for seed in (4321, 99):
            for gain in (1.0, 0.25):
                summary += run(ROOT, "kernel", seed, gain, log)
        summary += run(ROOT, "floor", 4321, 1.0, log)
        for name, (src, old, new) in MUTANTS.items():
            copy = Path(tmp) / name
            shutil.copytree(ROOT, copy, ignore=shutil.ignore_patterns(
                "_build", ".git", "__pycache__"))
            path = copy / "sunet_tf_tpu_torch" / "kernels" / "csrc" / src
            text = path.read_text()
            if text.count(old) != 1:
                raise SystemExit(f"chip_mutants: {name}: the text to mutate is not in {src}")
            path.write_text(text.replace(old, new))
            summary += run(copy, name, 4321, 1.0, log)
    print("\n".join(summary))
    print(f"chip_mutants: readings in {out}")


if __name__ == "__main__":
    main()
