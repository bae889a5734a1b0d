#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi); fails without CUDA.
2. Builds the hand-written CUDA kernels (one nvcc call) and prints the time.
3. One phase per kernel at the default model's shapes, batch 2, bf16:
   kernel vs its plain PyTorch version (max and mean |diff| against a
   stated tolerance) and the median time of each over 20 CUDA-event-timed
   runs after warm-up.
4. The slice: the default SUNet (99,681,993 parameters, seeded weights) at
   256x256 batch 4 through backend="fused"; the kernels' launch counts must
   equal the router's prediction; the output is held against
   backend="eager" on the same weights (finite, mean |diff| <= 5e-3); one
   forward is traced with torch.profiler for its device time by kernel.
5. The entry point: ``sunet_tf_tpu_torch.demo.main`` on synthetic PNGs.

Prints a JSON line of per-kernel results, then, as the last line,
``{"ok": true, "device": {...}}``. Any failed check raises (exit code != 0)
before that line. Needs one GPU; imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# nvcc's log and the per-kernel JSON go beside the built library (git-ignored)
OUT_DIR = ROOT / "sunet_tf_tpu_torch" / "kernels" / "_build"

# Tolerance for a bf16 kernel against its plain version on unit-scale data:
# bf16 keeps 8 mantissa bits (one ulp of 1 is 0.0078) and the kernel sums
# in another order, so an element may differ by a few ulps where a rounding
# flips; on average the two agree to well under one ulp. The mean limit is
# about three times the largest single-block reading on the H100 (9.8e-5)
# and below what one wrong rounding point or the tanh form of GELU reads
# there (4.5e-4 and up; PERF.md).
MAX_TOL = 3e-2
MEAN_TOL = 3e-4
# A token whose attention row, in some head, has its top two logits closer
# than this share of the larger |q_i k_i| term of either key lies on a near
# tie: one bf16 rounding flip of q or k, in either version, may pick the
# other key. With logits of 1e4 and more the softmax is one-hot, and such a
# token may differ by the gap between two value rows.
NEAR_TIE = 2.0 ** -6
SLICE_MEAN_TOL = 5e-3   # fused vs eager forward (the JAX bench.py gate)

WA = "sunet_tf_tpu/kernels/window_attention.py"
REPLACES = {
    "fused_swin_block": (f"{WA}:1582", "sunet_tf_tpu_torch/kernels/csrc/swin_block.cu"),
    "fused_swin_block_chain": (f"{WA}:1741", "sunet_tf_tpu_torch/kernels/csrc/swin_block.cu"),
    "fused_ln_window_attention": (f"{WA}:2742",
                                  "sunet_tf_tpu_torch/kernels/csrc/ln_window_attention.cu"),
    "fused_ln_mlp": (f"{WA}:1350", "sunet_tf_tpu_torch/kernels/csrc/ln_mlp.cu"),
    "fused_dual_upsample4_conv_phase": ("sunet_tf_tpu/kernels/upsample.py:589",
                                        "sunet_tf_tpu_torch/kernels/csrc/up4_conv.cu"),
}


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


def compare(name: str, got, ref, near_tie=None) -> tuple:
    """Hold a kernel's output against its plain version; ``near_tie`` (a
    (B, H, W) bool map) leaves those tokens out of the tolerances, and then
    every token beyond the max tolerance must lie on a near tie."""
    import torch

    torch.cuda.synchronize()
    g, r = got.float(), ref.float()
    check(bool(torch.isfinite(g).all()), f"{name}: non-finite kernel output")
    d = (g - r).abs()
    mx, mean = float(d.max()), float(d.mean())
    tol_max = MAX_TOL * max(1.0, float(r.abs().max()))
    tol_mean = MEAN_TOL * max(1.0, float(r.abs().mean()))
    line = (f"  {name}: max|diff| {mx:.3e} (tol {tol_max:.3e}) mean|diff| {mean:.3e} "
            f"(tol {tol_mean:.3e}) max|ref| {float(r.abs().max()):.3e}")
    if near_tie is None:
        ok = mx <= tol_max and mean <= tol_mean
    else:
        beyond = (d > tol_max).any(-1)
        off = ~near_tie
        unexplained = int((beyond & off).sum())
        mx_off, mean_off = float(d[off].max()), float(d[off].mean())
        ok = mx_off <= tol_max and mean_off <= tol_mean and unexplained == 0
        line += (f"; near-tie tokens {float(near_tie.float().mean()):.3e} of all; "
                 f"tokens beyond max tol {int(beyond.sum())}, {unexplained} of them "
                 f"off near ties; off near ties max|diff| {mx_off:.3e} "
                 f"mean|diff| {mean_off:.3e}")
    print(f"{line} {'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: kernel disagrees with its plain version")
    return mx, mean


def near_tie_tokens(x, p, mask, *, ws: int, heads: int, scale: float, shift: int):
    """((B, H, W) bool, max |logit|): the tokens whose attention row, in
    some head, has its top two logits within NEAR_TIE of the larger |q_i
    k_i| term of either key, with q, k and the logits computed as the plain
    version computes them."""
    import torch

    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.ops.window import roll2d, window_partition, window_reverse

    B, H, W, C = x.shape
    d = C // heads
    with wa.exact_fp32():
        xn = wa.ln32(roll2d(x, -shift), *p[0:2]).to(torch.bfloat16)
        qkv = (wa.mm32(window_partition(xn, ws), p[2]) + p[3]).to(torch.bfloat16)
        Bn, N, _ = qkv.shape
        split = lambda t: t.float().reshape(Bn, N, heads, d).transpose(1, 2)
        q = split((qkv[..., :C].float() * scale).to(torch.bfloat16))
        k = split(qkv[..., C:2 * C])
        s = q @ k.transpose(-1, -2) + p[12].float()
        if mask is not None:
            nW = mask.shape[0]
            s = (s.reshape(Bn // nW, nW, heads, N, N) + mask[None, :, None]).reshape(
                Bn, heads, N, N)
        top, idx = s.topk(2, dim=-1)
        # largest |q_i k_i| term against each of the two top keys
        term = lambda j: (q.abs() * k.abs().gather(
            2, idx[..., j:j + 1].expand(-1, -1, -1, d))).amax(-1)
        tie = (top[..., 0] - top[..., 1]) < NEAR_TIE * (term(0) + term(1))
        tie = tie.any(1).float()[..., None]                       # (Bn, N, 1)
    tie = roll2d(window_reverse(tie, ws, H, W), shift)[..., 0] > 0.5
    return tie, float(s.abs().max())


def block_params(C: int, heads: int, N: int, gen, *, qkv_gain: float = 1.0):
    import torch

    dev = "cuda"
    n = lambda *s: torch.randn(*s, device=dev, generator=gen)
    w = lambda i, o, g=1.0: (n(i, o) * (g / i ** 0.5)).to(torch.bfloat16)
    hid = 4 * C
    return (1 + 0.1 * n(C), 0.1 * n(C), w(C, 3 * C, qkv_gain), 0.1 * n(3 * C),
            w(C, C), 0.1 * n(C), 1 + 0.1 * n(C), 0.1 * n(C), w(C, hid),
            0.1 * n(hid), w(hid, C), 0.1 * n(C), n(heads, N, N))


def kernel_phases(results: dict):
    import torch

    from sunet_tf_tpu_torch.kernels import upsample as up
    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.ops.window import shift_attn_mask

    gen = torch.Generator(device="cuda").manual_seed(1234)
    B, ws, heads, scale = 2, 8, 8, 8.0
    N = ws * ws

    def record(name, case, got_fn, ref_fn, near_tie=None, plain_fn=None):
        """``plain_fn``, when given, is the whole plain version to time, where
        ``ref_fn`` computes only the part the comparison needs."""
        got, ref = got_fn(), ref_fn()
        mx, mean = compare(f"{name} {case}", got, ref, near_tie)
        ms, plain_ms = time_ms(got_fn), time_ms(plain_fn or ref_fn)
        print(f"    time {ms:.4f} ms kernel, {plain_ms:.4f} ms plain")
        r = results.setdefault(name, {"max_abs_err": 0.0, "cases": []})
        r["max_abs_err"] = max(r["max_abs_err"], mx)
        r["cases"].append({"case": case, "max_abs_err": mx, "mean_abs_err": mean,
                           "ms": ms, "plain_ms": plain_ms})

    def block_args(p, x, mask):
        return (x, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10], p[11],
                p[12], mask)

    print("phase: kernels vs plain versions (bf16, batch 2)")
    # qkv gain: weights scaled so that logits reach ~1e4 (trained QK_SCALE=8
    # weights do) and ~2e5 (one-hot rows; near ties are left out)
    for H, C, shift, gain in ((64, 96, 0, 1.0), (64, 96, 4, 1.0), (32, 192, 0, 1.0),
                              (32, 192, 4, 1.0), (16, 384, 0, 1.0), (16, 384, 4, 1.0),
                              (32, 192, 4, 7.5), (32, 192, 4, 30.0)):
        p = block_params(C, heads, N, gen, qkv_gain=gain)
        x = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
        mask = (torch.as_tensor(shift_attn_mask(H, H, ws, shift), device="cuda")
                if shift else None)
        args = block_args(p, x, mask)
        kw = dict(ws=ws, num_heads=heads, scale=scale, shift=shift)
        case = f"({H},{H},{C}) shift {shift}" + (f" qkv x{gain:g}" if gain != 1 else "")
        tie = None
        if gain != 1.0:
            tie, logit = near_tie_tokens(x, p, mask, ws=ws, heads=heads, scale=scale,
                                         shift=shift)
            print(f"  qkv x{gain:g}: max |logit| {logit:.3e}")
        record("fused_swin_block", case, lambda: wa.fused_swin_block(*args, **kw),
               lambda: wa.fused_swin_block_reference(*args, **kw), near_tie=tie)

    # The chain W -> SW at C=192. Its second block is held against the plain
    # version fed the kernel's own first-block output, which isolates the
    # kernel's error from the second block's response to the first block's
    # rounding; both that response and the whole chain against two plain
    # blocks are printed.
    H, C = 32, 192
    ps = [block_params(C, heads, N, gen) for _ in range(2)]
    x = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
    mask = torch.as_tensor(shift_attn_mask(H, H, ws, 4), device="cuda")
    bkw = dict(ws=ws, num_heads=heads, scale=scale)
    chain = lambda: wa.fused_swin_block_chain(x, [p[:12] for p in ps],
                                              [p[12] for p in ps], mask,
                                              shifts=(0, 4), **bkw)
    first = wa.fused_swin_block(*block_args(ps[0], x, None), shift=0, **bkw)
    second_ref = lambda y: wa.fused_swin_block_reference(*block_args(ps[1], y, mask),
                                                         shift=4, **bkw)
    plain_chain = lambda: second_ref(wa.fused_swin_block_reference(
        *block_args(ps[0], x, None), shift=0, **bkw))
    record("fused_swin_block_chain", f"({H},{H},{C}) K=2, 2nd block",
           chain, lambda: second_ref(first), plain_fn=plain_chain)
    two_refs = plain_chain()
    for what, a, b in (("chain vs two plain blocks", chain(), two_refs),
                       ("plain 2nd block on kernel vs plain 1st", second_ref(first),
                        two_refs)):
        dd = (a.float() - b.float()).abs()
        print(f"  {what}: max|diff| {float(dd.max()):.3e} mean|diff| "
              f"{float(dd.mean()):.3e}")
    two_blocks = wa.fused_swin_block(*block_args(ps[1], first, mask), shift=4, **bkw)
    check(torch.equal(chain(), two_blocks), "chain differs from two block launches")
    print("  fused_swin_block_chain == two fused_swin_block launches, bit for bit")

    H, C = 8, 768
    p = block_params(C, heads, N, gen)
    x = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
    record("fused_ln_window_attention", f"({H},{H},{C})",
           lambda: wa.fused_ln_window_attention(x, *p[0:6], p[12], None, **bkw),
           lambda: wa.fused_ln_window_attention_reference(x, *p[0:6], p[12], None, **bkw))
    record("fused_ln_mlp", f"({H},{H},{C})",
           lambda: wa.fused_ln_mlp(x, p[6:8], *p[8:12]),
           lambda: wa.fused_ln_mlp_reference(x, p[6:8], *p[8:12]))

    H, C = 64, 96
    n = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    bw = lambda i, o: (n(i, o) / i ** 0.5).to(torch.bfloat16)
    for out_ch in (1, 3):
        x = n(B, H, H, C).to(torch.bfloat16)
        hp = (x, bw(C, 16 * C), torch.full((1,), 0.25, device="cuda"), bw(C, C),
              0.1 * n(C), torch.full((1,), 0.2, device="cuda"), bw(C, C), bw(C, C),
              (n(3, 3, C, out_ch) / (9 * C) ** 0.5).to(torch.bfloat16))
        record("fused_dual_upsample4_conv_phase", f"({H},{H},{C}) out {out_ch}",
               lambda: up.fused_dual_upsample4_conv_phase(*hp),
               lambda: up.fused_dual_upsample4_conv_phase_reference(*hp))


def slice_phase(results: dict) -> dict:
    import torch

    from sunet_tf_tpu_torch.config import Config
    from sunet_tf_tpu_torch.kernels import _build
    from sunet_tf_tpu_torch.models.sunet import build_model, param_count

    print("phase: slice (default SUNet, 256x256, batch 4, bf16)")
    cfg = Config()
    fused = build_model(cfg, device="cuda", backend="fused", seed=0)
    eager = build_model(cfg, device="cuda", backend="eager", seed=0)
    eager.load_state_dict(fused.state_dict())
    n_params = param_count(fused)
    print(f"  parameters: {n_params}")
    check(n_params == 99_681_993, f"parameter count {n_params}")
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.rand(4, 256, 256, 3, device="cuda", generator=gen)
    want = fused.expected_launches(tuple(x.shape))
    with torch.inference_mode():
        torch.cuda.synchronize()
        _build.reset_counts()
        y_fused = fused(x)
        torch.cuda.synchronize()
        launches = {k: _build.counter(k).cuda for k in want}
        cpu_calls = {k: _build.counter(k).cpu for k in want}
        print(f"  launches: {launches} (router predicts {want})")
        check(launches == want, "launch counts differ from the router's prediction")
        check(all(v > 0 for v in launches.values()), "a kernel was not launched")
        check(not any(cpu_calls.values()), f"plain versions ran: {cpu_calls}")
        y_eager = eager(x)
        torch.cuda.synchronize()
        check(tuple(y_fused.shape) == (4, 256, 256, 1), f"shape {tuple(y_fused.shape)}")
        check(bool(torch.isfinite(y_fused).all()), "non-finite fused output")
        check(bool(torch.isfinite(y_eager).all()), "non-finite eager output")
        d = (y_fused - y_eager).abs()
        mean, mx = float(d.mean()), float(d.max())
        print(f"  fused vs eager: mean|diff| {mean:.3e} (tol {SLICE_MEAN_TOL:g}) "
              f"max|diff| {mx:.3e} mean|y| {float(y_eager.abs().mean()):.3e}")
        check(mean <= SLICE_MEAN_TOL, "fused forward disagrees with eager")
        fused_ms = time_ms(lambda: fused(x), iters=10)
        eager_ms = time_ms(lambda: eager(x), iters=10)
        print(f"  forward ms (batch 4): fused {fused_ms:.3f}, eager {eager_ms:.3f}; "
              f"{4000.0 / fused_ms:.1f} img/s fused")
        trace = trace_forward(fused, x)
    for k, v in launches.items():
        results.setdefault(k, {"max_abs_err": 0.0, "cases": []})["launches"] = v
    del fused, eager
    torch.cuda.empty_cache()
    return {"fused_ms": fused_ms, "eager_ms": eager_ms, "mean_abs_diff": mean,
            "trace": trace}


def trace_forward(model, x) -> dict:
    """Device time of one forward by kernel, from torch.profiler: the port's
    kernels by name (the block kernel by its column-tile count MC: 1, 2, 3
    at C=96, 192, 384), everything else as plain torch ops; the device's
    busy share of the forward's CUDA-event time."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s.record()
        model(x)
        e.record()
        torch.cuda.synchronize()
    wall_ms = s.elapsed_time(e)
    spans, groups, plain = [], {}, {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        t0, t1 = ev.time_range.start, ev.time_range.end
        spans.append((t0, t1))
        m = re.search(r"sunet::(\w+(?:<\d+>)?)", ev.name)
        key = m.group(1) if m else "plain torch ops"
        n, us = groups.get(key, (0, 0.0))
        groups[key] = (n + 1, us + (t1 - t0))
        if not m:
            n, us = plain.get(ev.name, (0, 0.0))
            plain[ev.name] = (n + 1, us + (t1 - t0))
    if not spans:
        print("  trace: no device events recorded (device time split not measured)")
        return {}
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    print(f"  trace of one fused forward: {len(spans)} device events, busy "
          f"{busy / 1000:.3f} ms of {wall_ms:.3f} ms (idle share "
          f"{1 - busy / 1000 / wall_ms:.3f})")
    for key, (n, us) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        print(f"    {key}: {n} launches, {us / 1000:.3f} ms")
    print("    largest plain torch kernels:")
    for name, (n, us) in sorted(plain.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"      {n} x {us / 1000:.3f} ms  {name[:100]}")
    return {"wall_ms": wall_ms, "busy_ms": busy / 1000,
            "groups": {k: {"launches": n, "ms": us / 1000} for k, (n, us) in groups.items()}}


def demo_phase():
    import numpy as np
    from PIL import Image

    from sunet_tf_tpu_torch import demo

    print("phase: demo entry point")
    rng = np.random.default_rng(3)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp, "in"), Path(tmp, "out")
        src.mkdir()
        sizes = {"a_256": (256, 256), "b_256": (256, 256), "c_200x300": (200, 300)}
        for name, (h, w) in sizes.items():
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                src / f"{name}.png")
        written = demo.main(["--input_dir", str(src), "--result_dir", str(dst),
                             "--batch", "2", "--device", "cuda"])
        check(len(written) == len(sizes), f"demo wrote {len(written)} files")
        for name, (h, w) in sizes.items():
            img = Image.open(dst / f"{name}.bmp")
            check(img.size == (w, h), f"{name}.bmp has size {img.size}")
        print(f"  wrote {len(written)} .bmp files of the input sizes")


def main():
    try:
        import torch
    except ImportError as e:
        raise SystemExit(f"chip_smoke: torch missing: {e}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    if not (ROOT / "sunet_tf_tpu_torch").is_dir():
        raise SystemExit(f"chip_smoke: package sunet_tf_tpu_torch not found at {ROOT}")
    sys.path.insert(0, str(ROOT))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip()
          else f"nvidia-smi unavailable: {smi.stderr.strip()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    from sunet_tf_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    seconds, log = _build.build_info()
    (OUT_DIR / "kernel_build.log").write_text(log)
    spills = [ln.strip() for ln in log.splitlines() if "spill" in ln and " 0 bytes spill" not in ln]
    print(f"kernel build: {seconds:.1f} s ({time.perf_counter() - t0:.1f} s wall); "
          f"ptxas spill lines with spills: {len(spills)}")
    for ln in spills:
        print(f"  {ln}")

    results: dict = {}
    kernel_phases(results)
    slice_stats = slice_phase(results)
    demo_phase()

    kernels = []
    for name, (replaces, source) in REPLACES.items():
        r = results[name]
        first = r["cases"][0]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": r["launches"],
                        "max_abs_err": r["max_abs_err"], "ms": first["ms"],
                        "plain_ms": first["plain_ms"], "cases": r["cases"]})
    line = {"kernels": kernels, "slice": slice_stats}
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(line, indent=1))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
