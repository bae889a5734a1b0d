"""Where one launch of the cluster block kernel (#1, ``csrc/swin_cluster.cu``;
its residual form #6), of the conv-fused x4 head (#5, ``csrc/up4_conv.cu``)
or of the phase launch of either x4 head's backward (#9, #11) spends its
time, phase by phase, on the card.

    python -m sunet_tf_tpu_torch.tools.block_phases [--batch 4]
        [--kernel block|block_res|up4|up4_conv_bwd|up4_bwd]

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
``--kernel block_res``: the residual form (#6, ``fused_swin_block_res``) at
the widths the residual route trains, (64,64,96) and (32,32,192), with
drop-path scales 1/0.9: its "attention" phase holds the stores of eb,
rden and ctx_f.
``--kernel up4``: the x4 head at the default model's (64,64,96), out 1;
thread 0 of every warpgroup (one tile each) adds its cycles per phase
(setup, the bilinear branch, per subpixel the halo rows and x @ wexp[s],
its PReLU epilogue, @ wpf, the stencil epilogue, the conv terms; the
output), and the median over warpgroups of each is printed with its share.
``--kernel up4_conv_bwd``: the phase launch of the conv-fused head's
backward (#9, ``csrc/up4_conv_bwd.cu``) at (64,64,96), out 1: thread 0 of
every CTA adds its cycles per phase over its chunk of 8 x 8 tiles (setup,
the staged gathers, the wait for x, z with dY, y with dP, the fold and dwpf
with the dz store, the partials), and the median over the CTAs of box 0 of
each is printed with its share and per tile.
``--kernel up4_bwd``: the phase launch of the split head's backward (#11,
``csrc/up4_bwd.cu``) at (64,64,96): the same per CTA (setup, the wait for
the x and dout tiles, z beside dP, dz beside dwpf, the dz store, the
partials), the median over every CTA.
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
UP4_PHASES = ("setup", "bilinear", "halo + x @ wexp", "PReLU epilogue", "@ wpf",
              "stencil epilogue", "conv terms", "output")
UP4_CONV_BWD_PHASES = ("setup", "gathers", "wait x", "z, dY", "y, dP", "fold, dwpf, dz store",
                       "partials")
UP4_BWD_PHASES = ("setup", "wait tiles", "z | dP", "dz | dwpf", "dz store", "partials")


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
    ap.add_argument("--kernel", choices=("block", "block_res", "up4", "up4_conv_bwd", "up4_bwd"),
                    default="block")
    args = ap.parse_args()
    B = args.batch
    if not torch.cuda.is_available():
        raise SystemExit("block_phases: torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi unavailable")
    lib = _build.use_variant(("SUNET_PHASE_CLOCK",))
    if args.kernel == "up4":
        return up4_phases(lib, B)
    if args.kernel == "up4_conv_bwd":
        return up4_conv_bwd_phases(lib, B)
    if args.kernel == "up4_bwd":
        return up4_bwd_phases(lib, B)
    lib.sunet_swin_block_phase_clock.argtypes = [ctypes.c_void_p]
    lib.sunet_swin_block_max_clusters.argtypes = [ctypes.c_int, ctypes.c_longlong]
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = args.kernel == "block_res"
    dp = torch.full((B, 2), 1 / 0.9, device="cuda")
    for H, C in SHAPES[:2] if res else SHAPES:
        args = block_args(B, H, C, gen)
        plan = wa.block_plan(H, H, C, 4 * C, 8, 8)
        ctas = B * plan["ctas_per_image"]
        clocks = torch.zeros(ctas, len(PHASES) + 1, dtype=torch.int64, device="cuda")
        run = ((lambda: wa.fused_swin_block_res(*args, dp, ws=8, num_heads=8, scale=8.0)) if res
               else (lambda: wa.fused_swin_block(*args, ws=8, num_heads=8, scale=8.0)))
        _build.check("block_phases", lib.sunet_swin_block_phase_clock(
            ctypes.c_void_p(clocks.data_ptr())))
        run()
        torch.cuda.synchronize()
        _build.check("block_phases", lib.sunet_swin_block_phase_clock(None))
        c = clocks.cpu().double()
        phase = (c[:, 1:] - c[:, :-1]).median(0).values
        total = float((c[:, -1] - c[:, 0]).median())
        held = lib.sunet_swin_block_max_clusters(plan["G"], plan["smem"])
        print(f"{'#6 ' if res else ''}({H},{H},{C}) batch {B}: cluster {plan['G']}, {ctas} CTAs, "
              f"{plan['smem']} bytes "
              f"of shared memory, {held} clusters held at once; per CTA {total:.0f} cycles")
        print("  " + ", ".join(f"{name} {v:.0f} ({v / total:.0%})"
                               for name, v in zip(PHASES, phase.tolist())))


def up4_phases(lib, B: int):
    """#5's cycles per phase and warpgroup at (64,64,96), out 1."""
    from sunet_tf_tpu_torch.kernels import upsample as up

    lib.sunet_up4_conv_phase_clock.argtypes = [ctypes.c_void_p]
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    w = lambda i, o: (n(i, o) / i ** 0.5).to(torch.bfloat16)
    H, C, out = 64, 96, 1
    hp = (n(B, H, H, C).to(torch.bfloat16), w(C, 16 * C), torch.full((1,), 0.25, device="cuda"),
          w(C, C), 0.1 * n(C), torch.full((1,), 0.2, device="cuda"), w(C, C), w(C, C),
          (n(3, 3, C, out) / (9 * C) ** 0.5).to(torch.bfloat16))
    plan = up.up4_plan(C, out)
    TH, TW = up.UP4_TILE
    tiles = B * -(-H // TH) * -(-H // TW)
    wgs = -(-tiles // plan["T"]) * plan["T"]
    clocks = torch.zeros(wgs, len(UP4_PHASES), dtype=torch.int64, device="cuda")
    _build.check("block_phases", lib.sunet_up4_conv_phase_clock(ctypes.c_void_p(clocks.data_ptr())))
    up.fused_dual_upsample4_conv_phase(*hp)
    torch.cuda.synchronize()
    _build.check("block_phases", lib.sunet_up4_conv_phase_clock(None))
    c = clocks[:tiles].cpu().double()
    phase = c.median(0).values
    total = float(c.sum(1).median())
    print(f"up4 ({H},{H},{C}) out {out} batch {B}: {tiles} tiles, {plan['T']} per CTA, "
          f"{plan['smem']} bytes of shared memory; per warpgroup {total:.0f} cycles")
    print("  " + ", ".join(f"{name} {v:.0f} ({v / total:.0%})"
                           for name, v in zip(UP4_PHASES, phase.tolist())))


def up4_conv_bwd_phases(lib, B: int):
    """#9's phase launch: cycles per phase and CTA at (64,64,96), out 1."""
    from sunet_tf_tpu_torch.kernels import upsample as up

    lib.sunet_up4_conv_bwd_phase_clock.argtypes = [ctypes.c_void_p]
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    w = lambda i, o: (n(i, o) / i ** 0.5).to(torch.bfloat16)
    H, C, out = 64, 96, 1
    hp = (n(B, H, H, C).to(torch.bfloat16), w(C, 16 * C), torch.full((1,), 0.25, device="cuda"),
          w(C, C), 0.1 * n(C), torch.full((1,), 0.2, device="cuda"), w(C, C), w(C, C),
          (n(3, 3, C, out) / (9 * C) ** 0.5).to(torch.bfloat16),
          n(B, H, H, 16 * out).to(torch.bfloat16))
    plan = up.up4_conv_bwd_plan(H, H, C, out)
    tpc = plan["tiles_per_chunk"]
    tiles = (-(-H // 8)) ** 2
    nch = -(-(B * tiles) // tpc)
    clocks = torch.zeros(out, 16, nch, len(UP4_CONV_BWD_PHASES), dtype=torch.int64,
                         device="cuda")
    _build.check("block_phases",
                 lib.sunet_up4_conv_bwd_phase_clock(ctypes.c_void_p(clocks.data_ptr())))
    up.up4_conv_bwd(*hp)
    torch.cuda.synchronize()
    _build.check("block_phases", lib.sunet_up4_conv_bwd_phase_clock(None))
    c = clocks[0].reshape(16 * nch, -1).cpu().double()
    phase = c.median(0).values
    total = float(c.sum(1).median())
    print(f"up4_conv_bwd phase launch ({H},{H},{C}) out {out} batch {B}: {16 * nch} CTAs of "
          f"{tpc} tiles, {plan['smem']['phase']} bytes of shared memory; per CTA {total:.0f} "
          f"cycles, {total / tpc:.0f} per tile")
    print("  " + ", ".join(f"{name} {v:.0f} ({v / total:.0%})"
                           for name, v in zip(UP4_CONV_BWD_PHASES, phase.tolist())))


def up4_bwd_phases(lib, B: int):
    """#11's phase launch: cycles per phase and CTA at (64,64,96)."""
    from sunet_tf_tpu_torch.kernels import upsample as up

    lib.sunet_up4_bwd_phase_clock.argtypes = [ctypes.c_void_p]
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    w = lambda i, o: (n(i, o) / i ** 0.5).to(torch.bfloat16)
    H, C = 64, 96
    hp = (n(B, H, H, C).to(torch.bfloat16), w(C, 16 * C), torch.full((1,), 0.25, device="cuda"),
          w(C, C), 0.1 * n(C), torch.full((1,), 0.2, device="cuda"), w(C, C), w(C, C),
          n(B, 4 * H, 4 * H, C).to(torch.bfloat16))
    plan = up.up4_bwd_plan(H, H, C)
    tpc, nbx = plan["tiles_per_chunk"], plan["column_boxes"]
    nch = -(-(B * (-(-H // 8)) ** 2) // tpc)
    clocks = torch.zeros(16, nch, nbx, len(UP4_BWD_PHASES), dtype=torch.int64, device="cuda")
    _build.check("block_phases", lib.sunet_up4_bwd_phase_clock(ctypes.c_void_p(clocks.data_ptr())))
    up.up4_bwd(*hp)
    torch.cuda.synchronize()
    _build.check("block_phases", lib.sunet_up4_bwd_phase_clock(None))
    c = clocks.reshape(16 * nch * nbx, -1).cpu().double()
    phase = c.median(0).values
    total = float(c.sum(1).median())
    print(f"up4_bwd phase launch ({H},{H},{C}) batch {B}: {16 * nch * nbx} CTAs of {tpc} tiles, "
          f"{plan['smem']['phase']} bytes of shared memory; per CTA {total:.0f} cycles, "
          f"{total / tpc:.0f} per tile")
    print("  " + ", ".join(f"{name} {v:.0f} ({v / total:.0%})"
                           for name, v in zip(UP4_BWD_PHASES, phase.tolist())))


if __name__ == "__main__":
    main()
