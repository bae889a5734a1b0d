"""Where one call of the whole-block backward (#8 ``swin_block_bwd``, #7
``swin_block_bwd_res``; ``csrc/swin_block_bwd.cuh``), of the LN+W-MSA
backward (#12 ``ln_window_attention_bwd``, ``csrc/ln_wmsa_bwd.cu``) or of
the LN+MLP backward (#14 ``ln_mlp_bwd``, ``csrc/ln_mlp_bwd.cu``), all on the
same kernels, of the x4 head's backwards (#9 ``up4_conv_bwd``,
``csrc/up4_conv_bwd.cu``; #11 ``up4_bwd``, ``csrc/up4_bwd.cu``) or of the
LN+MLP branch forward (#13 ``ln_mlp_branch``, ``csrc/ln_mlp_branch.cu``),
of the split x4 head's forward (#10 ``fused_dual_upsample4``,
``csrc/up4.cu``) or of the standalone W-MSA (#15 ``wmsa_core``,
``csrc/window_attention.cu``) spends its device time, launch by launch, on
the card.

    python -m sunet_tf_tpu_torch.tools.bwd_launches [--batch 2,4] [--shift 4] [--only 10,15]
    python -m sunet_tf_tpu_torch.tools.bwd_launches --scaled [--batch 2,4]

Runs each form at the default model's block widths, (64,64,96),
(32,32,192) and (16,16,384) for #8 and the first two for #7 (the widths the
default training route sends there), window 8, 8 heads, QK_SCALE 8,
drop-path scales 1/0.9, bf16, seeded weights, and #12 at the default
model's bottleneck (8,8,768), at (16,16,768) with the shift and its mask,
and at (16,16,384) with 2 heads (head dim 192), #13 and #14 at (8,8,768)
and (16,16,768), #9 at (64,64,96) out 1, #10 and #11 at (64,64,96) (the
16-band model's head), #15 over the windows of a (64,64,96) map, shift 0
and 4 (``--only``: those kernels' cases alone), and prints per case the
device time of each of its launches (torch.profiler, mean over 5 calls
after 3 warm-up calls, in launch order), their sum (the device-busy time of
a call) and the launch count, beside the card's name and power limit.
``--scaled``: the scaled config's training forms instead, #8's big-window
form at (128,128,180), (64,64,360) and (32,32,720), shift 8, head dim 30,
QK scale 30^-0.5, and #9's wide form at (128,128,180) out 1 (C padded to
192). These are the per-layer metric of the redesign (PERF.md, Layers):
which launch to shorten next. Refuses to run without a card.
"""

from __future__ import annotations

import argparse
import collections
import re
import subprocess

import torch

from sunet_tf_tpu_torch.kernels import upsample as up
from sunet_tf_tpu_torch.kernels import window_attention as wa
from sunet_tf_tpu_torch.ops.window import shift_attn_mask, window_partition

SHAPES = ((64, 96, True), (32, 192, True), (16, 384, False))   # H, C, also on #7


def block_args(B: int, H: int, C: int, gen) -> tuple:
    """x, dout and the block's parameters (ln1, wqkv, bqkv, wproj, bproj,
    ln2, w1, b1, w2, b2, rel-pos bias), unit-scale inputs, weights ~ N(0,
    1/fan_in)."""
    n = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    w = lambda i, o: (n(i, o) / i ** 0.5).to(torch.bfloat16)
    return (n(B, H, H, C).to(torch.bfloat16), n(B, H, H, C).to(torch.bfloat16),
            (1 + 0.1 * n(C), 0.1 * n(C)), w(C, 3 * C), 0.1 * n(3 * C), w(C, C), 0.1 * n(C),
            (1 + 0.1 * n(C), 0.1 * n(C)), w(C, 4 * C), 0.1 * n(4 * C), w(4 * C, C), 0.1 * n(C),
            n(8, 64, 64))


def scaled_cases(B: int, gen) -> list:
    """(name, call) of the scaled config's training forms at batch B: #8's
    big-window form at its three widths, shift 8, and #9's wide form."""
    n = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    w = lambda i, o: (n(i, o) / i ** 0.5).to(torch.bfloat16)
    dp = torch.full((B, 2), 1 / 0.9, device="cuda")
    cases = []
    for H, C, heads in ((128, 180, 6), (64, 360, 12), (32, 720, 24)):
        x, dout, *p = block_args(B, H, C, gen)
        p[-1] = n(heads, 256, 256)
        mask = torch.as_tensor(shift_attn_mask(H, H, 16, 8), device="cuda")
        kw = dict(ws=16, num_heads=heads, scale=30 ** -0.5, shift=8)
        cases.append((f"#8 swin_block_bwd ({H},{H},{C}) shift 8, {heads} heads",
                      lambda x=x, dout=dout, p=p, mask=mask, kw=kw: wa.swin_block_bwd(
                          x, dout, *p, mask, dp, **kw)))
    C = 180
    hp = (n(B, 128, 128, C).to(torch.bfloat16), w(C, 16 * C), torch.full((1,), 0.25, device="cuda"),
          w(C, C), 0.1 * n(C), torch.full((1,), 0.2, device="cuda"), w(C, C), w(C, C),
          (n(3, 3, C, 1) / (9 * C) ** 0.5).to(torch.bfloat16),
          n(B, 128, 128, 16).to(torch.bfloat16))
    cases.append(("#9 up4_conv_bwd (128,128,180) out 1", lambda: up.up4_conv_bwd(*hp)))
    return cases


def launches(fn, calls: int = 5) -> list:
    """[(kernel name, mean device us per call)] of fn's launches, in order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    per = len(evs) // calls
    tot = collections.defaultdict(float)
    for i, e in enumerate(evs[:per * calls]):
        tot[i % per] += (e.time_range.end - e.time_range.start) / calls
    names = [re.sub(r"^void |sunet::(bb::|u4[sf]?::|wmsa::)?|\(.*$", "", evs[i].name)
             for i in range(per)]
    return [(names[i], tot[i]) for i in range(per)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", default="2,4")
    ap.add_argument("--shift", type=int, default=4)
    ap.add_argument("--only", default="", help="kernel numbers, e.g. 10,15 (default: all)")
    ap.add_argument("--scaled", action="store_true",
                    help="the scaled config's training forms (#8 big-window, #9 wide)")
    args = ap.parse_args()
    only = {f"#{k}" for k in args.only.split(",") if k}
    if not torch.cuda.is_available():
        raise SystemExit("bwd_launches: torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else 'unknown'}")
    gen = torch.Generator(device="cuda").manual_seed(7)
    ws, heads, scale, shift = 8, 8, 8.0, args.shift
    if args.scaled:
        for B in (int(b) for b in args.batch.split(",")):
            for name, fn in scaled_cases(B, gen):
                got = launches(fn)
                print(f"{name} batch {B}: {len(got)} launches, "
                      f"{sum(t for _, t in got) / 1000:.4f} ms device busy")
                for kname, t in got:
                    print(f"  {t:9.2f} us  {kname}")
        return
    for B in (int(b) for b in args.batch.split(",")):
        dp = torch.full((B, 2), 1 / 0.9, device="cuda")
        for H, C, res in SHAPES:
            x, dout, *p = block_args(B, H, C, gen)
            mask = (torch.as_tensor(shift_attn_mask(H, H, ws, shift), device="cuda")
                    if shift else None)
            kw = dict(ws=ws, num_heads=heads, scale=scale, shift=shift)
            shape = f"({H},{H},{C}) shift {shift}"
            cases = [(f"#8 swin_block_bwd {shape}", lambda: wa.swin_block_bwd(
                x, dout, *p, mask, dp, **kw))]
            if res:
                _, *st = wa.fused_swin_block_res(x, *p, mask, dp, **kw)
                cases.append((f"#7 swin_block_bwd_res {shape}", lambda: wa.swin_block_bwd_res(
                    x, dout, *st, *p[:-1], dp, **kw)))
            if C == 384:   # #12, beside the block backward's widths
                for Hw, Cw, hw_heads, sh in ((8, 768, 8, 0), (16, 768, 8, shift), (16, 384, 2, 0)):
                    xw, dw, *q = block_args(B, Hw, Cw, gen)
                    bias = torch.randn(hw_heads, 64, 64, device="cuda", generator=gen)
                    mw = (torch.as_tensor(shift_attn_mask(Hw, Hw, ws, sh), device="cuda")
                          if sh else None)
                    cases.append((f"#12 ln_window_attention_bwd ({Hw},{Hw},{Cw}) {hw_heads} heads"
                                  f" shift {sh}", lambda xw=xw, dw=dw, q=q, bias=bias, mw=mw,
                                  hh=hw_heads: wa.ln_window_attention_bwd(
                                      xw, dw, *q[0], *q[1:4], bias, mw, ws=ws, num_heads=hh,
                                      scale=scale)))
            if C == 384:   # #13 and #14 at the bottleneck, and a map of 4 windows
                for Hm in (8, 16):
                    ym, dm, *q = block_args(B, Hm, 768, gen)
                    cases.append((f"#13 ln_mlp_branch ({Hm},{Hm},768)", lambda ym=ym, q=q:
                                  wa.ln_mlp_branch(ym, q[5], *q[6:10])))
                    cases.append((f"#14 ln_mlp_bwd ({Hm},{Hm},768)", lambda ym=ym, dm=dm, q=q:
                                  wa.ln_mlp_bwd(ym, dm, q[5], *q[6:9])))
            if C == 384:   # #9 at the default model's head, out 1
                n = lambda *s: torch.randn(*s, device="cuda", generator=gen)
                w = lambda i, o: (n(i, o) / i ** 0.5).to(torch.bfloat16)
                hp = (n(B, 64, 64, 96).to(torch.bfloat16), w(96, 16 * 96),
                      torch.full((1,), 0.25, device="cuda"), w(96, 96), 0.1 * n(96),
                      torch.full((1,), 0.2, device="cuda"), w(96, 96), w(96, 96),
                      (n(3, 3, 96, 1) / (9 * 96) ** 0.5).to(torch.bfloat16),
                      n(B, 64, 64, 16).to(torch.bfloat16))
                cases.append(("#9 up4_conv_bwd (64,64,96) out 1",
                              lambda hp=hp: up.up4_conv_bwd(*hp)))
                sp = (*hp[:8], n(B, 256, 256, 96).to(torch.bfloat16))
                cases.append(("#11 up4_bwd (64,64,96)", lambda sp=sp: up.up4_bwd(*sp)))
                cases.append(("#10 fused_dual_upsample4 (64,64,96)",
                              lambda hp=hp: up.fused_dual_upsample4(*hp[:8])))
                # #15 over the windows of a (64,64,96) map, as fused_window_attention
                # hands them over
                wp = block_args(B, 64, 96, gen)
                xw = window_partition(wp[0], ws).contiguous()
                for sh in (0, shift):
                    mw = (torch.as_tensor(shift_attn_mask(64, 64, ws, sh), device="cuda")
                          if sh else None)
                    cases.append((f"#15 wmsa_core (64,64,96) shift {sh}",
                                  lambda mw=mw, wp=wp, xw=xw: wa.wmsa_core(
                                      xw, *wp[3:7], wp[12], mw, num_heads=heads,
                                      scale=scale)))
            if only:
                cases = [c for c in cases if c[0].split()[0] in only]
            for name, fn in cases:
                got = launches(fn)
                print(f"{name} batch {B}: {len(got)} launches, "
                      f"{sum(t for _, t in got) / 1000:.4f} ms device busy")
                for kname, t in got:
                    print(f"  {t:9.2f} us  {kname}")


if __name__ == "__main__":
    main()
