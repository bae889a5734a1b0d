#!/usr/bin/env python3
"""Hold this tree's training kernels against another checkout's, bit for bit, on one NVIDIA GPU.

    python3 chip_ab.py --other DIR

For a change to a shared kernel source that must leave the existing kernels'
results as they were. Each tree runs in its own process, with its own kernel
build (into its own ``sunet_tf_tpu_torch/kernels/_build/``), on the same
seeded inputs: the block kernel's inference launch and its train form (#1)
and the recompute block backward (#8), at (64,64,96), (32,32,192) and
(16,16,384), shift 0 and 4, batch 2, bf16, with ``chip_smoke.block_params``
weights, the C=768 training sublayers of ``chip_smoke.sublayer_cases``
(#12, #13, #14), and the conv-fused x4 head (#5) and its backward (#9) at
(64,64,96), out 1 and 3. Every output must be equal bit for bit; the exit
code is 1 where one differs. The trees run in turns (other, this, this,
other), each printing the times of #5 and #9 (CUDA events, medians of 20). The other tree needs
``chip_smoke.block_params``, ``chip_smoke.sublayer_cases`` and the wrappers
``fused_swin_block``, ``swin_block_bwd``, ``fused_dual_upsample4_conv_phase``
and ``up4_conv_bwd``. Needs one GPU; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Run inside a checkout: save the kernels' outputs to argv[1].
OUTPUTS = r'''
import sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from sunet_tf_tpu_torch.kernels import upsample as up
from sunet_tf_tpu_torch.kernels import window_attention as wa
from sunet_tf_tpu_torch.ops.window import shift_attn_mask

gen = torch.Generator(device="cuda").manual_seed(2024)
B, ws, heads, scale = 2, 8, 8, 8.0
dp = torch.tensor([[1 / 0.9, 1 / 0.9], [1 / 0.9, 0.0]], device="cuda")
outs = {}
for H, C in ((64, 96), (32, 192), (16, 384)):
    for shift in (0, 4):
        p = cs.block_params(C, heads, ws * ws, gen)
        x = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
        dout = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
        mask = (torch.as_tensor(shift_attn_mask(H, H, ws, shift), device="cuda")
                if shift else None)
        kw = dict(ws=ws, num_heads=heads, scale=scale, shift=shift)
        blk = (x, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10], p[11], p[12],
               mask)
        case = f"({H},{H},{C}) shift {shift}"
        outs[f"fused_swin_block {case}"] = wa.fused_swin_block(*blk, **kw)
        outs[f"fused_swin_block train form {case}"] = wa.fused_swin_block(*blk, dp, **kw)
        for i, g in enumerate(wa.swin_block_bwd(x, dout, *blk[1:], dp, **kw)):
            outs[f"swin_block_bwd {case} output {i}"] = g
for name, case, kernel, _, args, kw, _, _ in cs.sublayer_cases(gen):
    out = kernel(*args, **kw)
    for i, g in enumerate(out if isinstance(out, tuple) else (out,)):
        outs[f"{name} {case} output {i}"] = g
n = lambda *s: torch.randn(*s, device="cuda", generator=gen)
bw = lambda i, o: (n(i, o) / i ** 0.5).to(torch.bfloat16)
H, C = 64, 96
for out_ch in (1, 3):
    hp = (n(B, H, H, C).to(torch.bfloat16), bw(C, 16 * C), torch.full((1,), 0.25, device="cuda"),
          bw(C, C), 0.1 * n(C), torch.full((1,), 0.2, device="cuda"), bw(C, C), bw(C, C),
          (n(3, 3, C, out_ch) / (9 * C) ** 0.5).to(torch.bfloat16))
    outs[f"fused_dual_upsample4_conv_phase out {out_ch}"] = up.fused_dual_upsample4_conv_phase(*hp)
    dout = n(B, H, H, 16 * out_ch).to(torch.bfloat16)
    for i, g in enumerate(up.up4_conv_bwd(*hp, dout)):
        outs[f"up4_conv_bwd out {out_ch} output {i}"] = g
    print(f"TIME up4 head out {out_ch}: fused_dual_upsample4_conv_phase "
          f"{cs.time_ms(lambda: up.fused_dual_upsample4_conv_phase(*hp)):.4f} ms, up4_conv_bwd "
          f"{cs.time_ms(lambda: up.up4_conv_bwd(*hp, dout)):.4f} ms", flush=True)
torch.save({k: v.cpu() for k, v in outs.items()}, sys.argv[1])
'''


def outputs(tree: Path, path: Path):
    proc = subprocess.run([sys.executable, "-c", OUTPUTS, str(path)], cwd=tree,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"chip_ab: {tree} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    for line in proc.stdout.splitlines():
        if line.startswith("TIME"):
            print(f"{tree}: {line}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    other = Path(ap.parse_args().other).resolve()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_ab: torch.cuda.is_available() is false")
    with tempfile.TemporaryDirectory() as tmp:
        got = {}
        # in turns (other, this, this, other): the x4 head's times compare
        # the two trees on one card
        for label, tree in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
            outputs(tree, Path(tmp) / f"{label}.pt")
            got[label] = torch.load(Path(tmp) / f"{label}.pt")
    a, b = got["other"], got["this"]
    if a.keys() != b.keys():
        raise SystemExit("chip_ab: the two trees gave different outputs")
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    print(f"chip_ab: {len(a) - len(differ)} of {len(a)} outputs equal bit for bit "
          f"({other} against {ROOT})")
    for k in differ:
        print(f"  differs: {k}: max|diff| {float((a[k].float() - b[k].float()).abs().max()):.3e}")
    sys.exit(1 if differ else 0)


if __name__ == "__main__":
    main()
