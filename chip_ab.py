#!/usr/bin/env python3
"""Hold this tree's kernels against another checkout's on one NVIDIA GPU: bit for bit where a kernel must not move, against the same plain version where its design changed.

    python3 chip_ab.py --other DIR

Each tree runs in its own process, with its own kernel build (into its own
``sunet_tf_tpu_torch/kernels/_build/``), on the same seeded inputs, batch 2,
bf16, ``chip_smoke.block_params`` weights.

- Bit for bit (the exit code is 1 where one differs): the block kernel
  (#1) at (64,64,96), (32,32,192) and (16,16,384), shift 0 and 4, inference
  and train form, and at batch 4 (shift 4); the block backward, the
  recompute form (#8) at the three widths and the residual route's (#7) at
  the first two, shift 0 and 4, #7 from the plain version's stored state
  (the same input in both trees); the LN+MLP kernel (#4) at (8,8,768),
  batch 2 and 4, the LN+W-MSA kernel (#3) at (8,8,768), batch 2 and 4,
  and at (16,16,768), shift 4 with the mask, the conv-fused x4 head (#5)
  and its backward (#9) at (64,64,96), out 1 and 3, #5 also out 1 at batch
  4; the scaled geometry's inference forms (``chip_smoke.scaled_cases``:
  #1's sequence form, #3's big-window attention, #4 at C=1440, #5 at
  C=180); the default model's fused bf16 forward at 256x256 batch 4.
- Against the plain version, both trees' readings printed (``PLAIN``
  lines): the residual route's block forward (#6: output and stored state)
  at (64,64,96) and (32,32,192), shift 0 and 4, the LN+MLP branch (#13)
  and the LN+W-MSA and LN+MLP backwards (#12, #14) of
  ``chip_smoke.sublayer_cases``, the split head's backward (#11) at
  (64,64,96), batch 2 and 4 (dx and the worst weight gradient), the split
  head (#10) at (64,64,96), batch 2 and 4, and the standalone W-MSA (#15)
  at (64,64,96), shift 0 and 4. Their fp32
  summation order is a design choice of each tree, so their bits may
  differ; a kernel whose redesign lies between the two trees moves here.
- Times (``TIME`` lines), each by this script's own ``time_ms`` and
  ``device_ms``, the same code for both trees: CUDA events, medians of 20,
  with the card spinning first so that the host's pace of launches does not
  count; and the device time of the wrapper's kernels from torch.profiler,
  mean per call. #1 at (64,64,96), (32,32,192), (16,16,384), #4, #13, #14
  and #3 at (8,8,768) and #5 and #9 at (64,64,96) out 1, batch 2 and 4, #9
  out 3 (batch 2), #10 and #11 at (64,64,96), batch 2 and 4, #15 at
  (64,64,96) shift 0 and 4 (batch 2), #8 at
  the three widths and #6 and #7 at C=96 and 192 (shift 4, batch 2 and 4),
  #12 at (8,8,768) (batch 2 and 4) and at (16,16,768) shift 4, the default
  model's fused bf16 forward at 256x256 batch 4 (also paced by the host:
  events around each call with nothing queued ahead, as a caller who waits
  on each call sees it), and its batch-4 training step (forward and
  backward, no optimizer) on the residual route and with
  ``ROUTE_TRAIN_RESID`` off: the profiler's device time per step and the
  step paced by the host (median of 10). The trees run in turns (other,
  this, this, other).

The other tree needs ``chip_smoke.block_params``,
``chip_smoke.sublayer_cases``, ``chip_smoke.split_head_args``,
``models.sunet.build_model`` and the wrappers. Needs one GPU; imports nothing of JAX.
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
import statistics
import sys
import time
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, ".")
import chip_smoke as cs
from sunet_tf_tpu_torch.config import Config
from sunet_tf_tpu_torch.kernels import upsample as up
from sunet_tf_tpu_torch.kernels import window_attention as wa
from sunet_tf_tpu_torch.models.sunet import build_model
from sunet_tf_tpu_torch.ops.window import shift_attn_mask


def time_ms(fn, iters=20, device=True):
    """Median of CUDA-event times of fn; with ``device`` the card first
    spins (torch.cuda._sleep) for longer than the host takes to enqueue
    every call, so the events time the device's work alone."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if device:
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda._sleep(int(min(2.0, 2 * (iters + 1) * host_s) * 2e9))
    evs = []
    for _ in range(iters):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
        if not device:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


def device_ms(fn, n=20):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(ev.time_range.end - ev.time_range.start for ev in prof.events()
               if ev.device_type == DeviceType.CUDA) / n / 1000


def plain_outs(name, got, ref):
    """Each output's distance from the plain version."""
    print(f"PLAIN {name}: " + "; ".join(
        f"output {i} max|diff| {float((g.float() - r.float()).abs().max()):.3e} mean|diff| "
        f"{float((g.float() - r.float()).abs().mean()):.3e}" for i, (g, r) in
        enumerate(zip(got, ref))), flush=True)


def plain_grads(name, got, ref):
    """dx's and the worst weight gradient's distance from the plain version."""
    d = (got[0].float() - ref[0].float()).abs()
    rel = max(float((g - r).abs().mean()) / max(float(r.abs().mean()), 1e-30)
              for g, r in zip(got[1:], ref[1:]))
    print(f"PLAIN {name}: dx max|diff| {float(d.max()):.3e} mean|diff| {float(d.mean()):.3e}; "
          f"worst weight grad mean|diff|/mean|ref| {rel:.3e}", flush=True)


def timed(name, fn):
    print(f"TIME {name}: {time_ms(fn):.4f} ms events, {device_ms(fn):.4f} ms device",
          flush=True)


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
        bargs = (x, dout, *blk[1:], dp)
        for i, g in enumerate(wa.swin_block_bwd(*bargs, **kw)):
            outs[f"swin_block_bwd {case} output {i}"] = g
        if C < 384:
            ref = wa.fused_swin_block_res_reference(*blk, dp, **kw)
            plain_outs(f"fused_swin_block_res {case}", wa.fused_swin_block_res(*blk, dp, **kw),
                       ref)
            rargs = (x, dout, *ref[1:], *blk[1:-2], dp)
            for i, g in enumerate(wa.swin_block_bwd_res(*rargs, **kw)):
                outs[f"swin_block_bwd_res {case} output {i}"] = g
for name, case, kernel, plain, args, kw, _, _ in cs.sublayer_cases(gen):
    out = kernel(*args, **kw)
    if name in ("ln_window_attention_bwd", "ln_mlp_bwd"):
        plain_grads(f"{name} {case}", out, plain(*args, **kw))
        timed(f"{name} {case}", lambda: kernel(*args, **kw))
        continue
    if name == "ln_mlp_branch":
        plain_outs(f"{name} {case}", (out,), (plain(*args, **kw),))
        timed(f"{name} {case}", lambda: kernel(*args, **kw))
        continue
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
    timed(f"up4_conv_bwd out {out_ch}", lambda: up.up4_conv_bwd(*hp, dout))
H, C = 8, 768
p = cs.block_params(C, heads, ws * ws, gen)
y = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
outs[f"fused_ln_mlp ({H},{H},{C})"] = wa.fused_ln_mlp(y, p[6:8], *p[8:12])
# batch 4, the main path's grid
y = torch.randn(4, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
outs[f"fused_ln_mlp batch 4 ({H},{H},{C})"] = wa.fused_ln_mlp(y, p[6:8], *p[8:12])
for H, C in ((64, 96), (32, 192), (16, 384)):
    p = cs.block_params(C, heads, ws * ws, gen)
    x = torch.randn(4, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
    mask = torch.as_tensor(shift_attn_mask(H, H, ws, 4), device="cuda")
    blk = (x, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10], p[11], p[12], mask)
    kw = dict(ws=ws, num_heads=heads, scale=scale, shift=4)
    outs[f"fused_swin_block batch 4 ({H},{H},{C}) shift 4"] = wa.fused_swin_block(*blk, **kw)
# the split head (#10) and the standalone W-MSA (#15), which share headers
# and kernels with #3, #5, #9 and #11
hp = cs.split_head_args(gen, B, 64, 64, 96)
plain_outs("fused_dual_upsample4 (64,64,96)", (up.fused_dual_upsample4(*hp),),
           (up.fused_dual_upsample4_reference(*hp),))
timed("fused_dual_upsample4 batch 2 (64,64,96)", lambda: up.fused_dual_upsample4(*hp))
dout = torch.randn(B, 256, 256, 96, device="cuda", generator=gen).to(torch.bfloat16)
plain_grads("up4_bwd (64,64,96)", up.up4_bwd(*hp, dout), up.up4_bwd_reference(*hp, dout))
timed("up4_bwd batch 2 (64,64,96)", lambda: up.up4_bwd(*hp, dout))
for shift in (0, 4):
    p = cs.block_params(96, heads, ws * ws, gen)
    x = torch.randn(B, 64, 64, 96, device="cuda", generator=gen).to(torch.bfloat16)
    mask = (torch.as_tensor(shift_attn_mask(64, 64, ws, shift), device="cuda")
            if shift else None)
    wargs = (x, p[2], p[3], p[4], p[5], p[12], mask)
    wkw = dict(ws=ws, num_heads=heads, scale=scale)
    plain_outs(f"wmsa_core (64,64,96) shift {shift}", (wa.fused_window_attention(*wargs, **wkw),),
               (wa.fused_window_attention_reference(*wargs, **wkw),))
    timed(f"wmsa_core batch 2 (64,64,96) shift {shift}",
          lambda: wa.fused_window_attention(*wargs, **wkw))
# #3 at the main path's (8,8,768), batch 2 and 4, and with the SW mask; #5
# at batch 4
for Bt, H, shift in ((2, 8, 0), (4, 8, 0), (2, 16, 4)):
    p = cs.block_params(768, heads, ws * ws, gen)
    x = torch.randn(Bt, H, H, 768, device="cuda", generator=gen).to(torch.bfloat16)
    mask = (torch.as_tensor(shift_attn_mask(H, H, ws, shift), device="cuda")
            if shift else None)
    args = (x, *p[0:6], p[12], mask)
    kw = dict(ws=ws, num_heads=heads, scale=scale)
    outs[f"fused_ln_window_attention batch {Bt} ({H},{H},768) shift {shift}"] = (
        wa.fused_ln_window_attention(*args, **kw))
    if not shift:
        timed(f"fused_ln_window_attention batch {Bt} ({H},{H},768)",
              lambda: wa.fused_ln_window_attention(*args, **kw))
for Bt in (2, 4):
    H, C = 64, 96
    hp = (n(Bt, H, H, C).to(torch.bfloat16), bw(C, 16 * C),
          torch.full((1,), 0.25, device="cuda"), bw(C, C), 0.1 * n(C),
          torch.full((1,), 0.2, device="cuda"), bw(C, C), bw(C, C),
          (n(3, 3, C, 1) / (9 * C) ** 0.5).to(torch.bfloat16))
    if Bt == 4:
        outs["fused_dual_upsample4_conv_phase batch 4 out 1"] = (
            up.fused_dual_upsample4_conv_phase(*hp))
    timed(f"fused_dual_upsample4_conv_phase batch {Bt} out 1",
          lambda: up.fused_dual_upsample4_conv_phase(*hp))
    dout = n(Bt, H, H, 16).to(torch.bfloat16)
    timed(f"up4_conv_bwd batch {Bt} out 1", lambda: up.up4_conv_bwd(*hp, dout))
# #11 at batch 4 (its own generator: the cases above keep their inputs)
sgen4 = torch.Generator(device="cuda").manual_seed(2025)
hp4 = cs.split_head_args(sgen4, 4, 64, 64, 96)
dout4 = torch.randn(4, 256, 256, 96, device="cuda", generator=sgen4).to(torch.bfloat16)
plain_grads("up4_bwd batch 4 (64,64,96)", up.up4_bwd(*hp4, dout4),
            up.up4_bwd_reference(*hp4, dout4))
timed("up4_bwd batch 4 (64,64,96)", lambda: up.up4_bwd(*hp4, dout4))
plain_outs("fused_dual_upsample4 batch 4 (64,64,96)", (up.fused_dual_upsample4(*hp4),),
           (up.fused_dual_upsample4_reference(*hp4),))
timed("fused_dual_upsample4 batch 4 (64,64,96)", lambda: up.fused_dual_upsample4(*hp4))
for Bt in (2, 4):
    for H, C in ((64, 96), (32, 192), (16, 384), (8, 768)):
        p = cs.block_params(C, heads, ws * ws, gen)
        x = torch.randn(Bt, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
        if C == 768:
            timed(f"fused_ln_mlp batch {Bt} ({H},{H},{C})",
                  lambda: wa.fused_ln_mlp(x, p[6:8], *p[8:12]))
            timed(f"ln_mlp_branch batch {Bt} ({H},{H},{C})",
                  lambda: wa.ln_mlp_branch(x, p[6:8], *p[8:12]))
            timed(f"ln_mlp_bwd batch {Bt} ({H},{H},{C})",
                  lambda: wa.ln_mlp_bwd(x, x, p[6:8], *p[8:11]))
        else:
            blk = (x, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10], p[11], p[12],
                   None)
            timed(f"fused_swin_block batch {Bt} ({H},{H},{C})",
                  lambda: wa.fused_swin_block(*blk, ws=ws, num_heads=heads, scale=scale))
# the block backward (#8 recompute form at the three widths, #7 at C=96 and
# 192), batch 2 and 4
for Bt in (2, 4):
    dpt = torch.full((Bt, 2), 1 / 0.9, device="cuda")
    for H, C in ((64, 96), (32, 192), (16, 384)):
        p = cs.block_params(C, heads, ws * ws, gen)
        x = torch.randn(Bt, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
        dout = torch.randn(Bt, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
        mask = torch.as_tensor(shift_attn_mask(H, H, ws, 4), device="cuda")
        kw = dict(ws=ws, num_heads=heads, scale=scale, shift=4)
        blk = (x, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10], p[11], p[12], mask)
        bargs = (x, dout, *blk[1:], dpt)
        timed(f"swin_block_bwd batch {Bt} ({H},{H},{C})",
              lambda: wa.swin_block_bwd(*bargs, **kw))
        if C < 384:
            res = wa.fused_swin_block_res(*blk, dpt, **kw)
            rargs = (x, dout, *res[1:], *blk[1:-2], dpt)
            timed(f"swin_block_bwd_res batch {Bt} ({H},{H},{C})",
                  lambda: wa.swin_block_bwd_res(*rargs, **kw))
            timed(f"fused_swin_block_res batch {Bt} ({H},{H},{C})",
                  lambda: wa.fused_swin_block_res(*blk, dpt, **kw))
# the LN+W-MSA backward (#12) at the main path's (8,8,768), batch 4
p = cs.block_params(768, heads, ws * ws, gen)
x = torch.randn(4, 8, 8, 768, device="cuda", generator=gen).to(torch.bfloat16)
dout = torch.randn(4, 8, 8, 768, device="cuda", generator=gen).to(torch.bfloat16)
wargs = (x, dout, *p[0:5], p[12], None)
timed("ln_window_attention_bwd batch 4 (8,8,768)",
      lambda: wa.ln_window_attention_bwd(*wargs, ws=ws, num_heads=heads, scale=scale))
model = build_model(Config(), device="cuda", backend="fused", seed=0)
img = torch.rand(4, 256, 256, 3, device="cuda", generator=gen)
with torch.inference_mode():
    fwd = lambda: model(img)
    outs["forward batch 4 (Config(), 256x256, fused bf16)"] = fwd()
    print(f"TIME forward batch 4 (Config(), 256x256, fused bf16): {time_ms(fwd, 10):.4f} ms "
          f"events, {time_ms(fwd, 10, device=False):.4f} ms paced by the host, "
          f"{device_ms(fwd, 5):.4f} ms device", flush=True)
# the training step's device time on both routes (batch 4: forward,
# backward, no optimizer), by the profiler's kernel durations
from sunet_tf_tpu_torch.models import layers
model.train().requires_grad_(True)
sgen = torch.Generator(device="cuda")


def train_step():
    sgen.manual_seed(0)
    model.zero_grad(set_to_none=True)
    model(img, sgen).float().square().mean().backward()


for resid in (True, False):
    layers.ROUTE_TRAIN_RESID = resid
    print(f"TIME train step batch 4 ({'residual route' if resid else 'ROUTE_TRAIN_RESID off'}):"
          f" {device_ms(train_step, 3):.4f} ms device busy, "
          f"{time_ms(train_step, 10, device=False):.4f} ms paced by the host", flush=True)
layers.ROUTE_TRAIN_RESID = True
# the scaled geometry's inference forms (chip_smoke.scaled_cases: #1's
# sequence form on gemm_tile.cuh's general mode, #3's big-window attention,
# #4 at C=1440, #5 at C=180), drawn last so that the cases above keep their
# inputs, and #1's sequence form timed at (128,128,180) shift 8
model = None
torch.cuda.empty_cache()
scgen = torch.Generator(device="cuda").manual_seed(1414)
for c in cs.scaled_cases(scgen):
    outs[f"{c['name']} [scaled] {c['case']}"] = c["fn"](*c["args"], **c["kw"])
    if c["name"] == "fused_swin_block" and c["case"].startswith("(128,128,180) shift 8") \
            and c["case"].endswith("(1, 1, 1, 1)"):
        timed("fused_swin_block [scaled] (128,128,180) shift 8",
              lambda c=c: c["fn"](*c["args"], **c["kw"]))
torch.save({k: v.cpu() for k, v in outs.items()}, sys.argv[1])
'''


def outputs(tree: Path, path: Path):
    proc = subprocess.run([sys.executable, "-c", OUTPUTS, str(path)], cwd=tree,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"chip_ab: {tree} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    for line in proc.stdout.splitlines():
        if line.startswith(("TIME", "PLAIN")):
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
        # in turns (other, this, this, other): the times compare the two
        # trees on one card
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
