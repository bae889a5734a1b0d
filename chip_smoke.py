#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--phases kernels,train_kernels,slice,demo,train]

1. Prints the card's name and power limit (nvidia-smi); fails without CUDA.
2. Builds the hand-written CUDA kernels (one nvcc per source, in parallel,
   then a link) and prints the time.
3. One phase per kernel at the default model's shapes, batch 2, bf16:
   kernel vs its plain PyTorch version (max and mean |diff| against a
   stated tolerance), the median time of each over 20 CUDA-event-timed
   runs after warm-up, and the kernel's bound (bytes or operations over
   the card's published peak rates). The training kernels: the block
   kernel's train form (drop-path scales), the block backward and the x4
   head backward, dx and every weight grad held against the plain version.
4. The inference slice: the default SUNet (99,681,993 parameters, seeded
   weights) at 256x256 batch 4 through backend="fused"; the kernels' launch
   counts must equal the router's prediction; the output is held against
   backend="eager" on the same weights (finite, mean |diff| <= 5e-3); one
   forward is traced with torch.profiler for its device time by kernel.
5. The entry point: ``sunet_tf_tpu_torch.demo.main`` on synthetic PNGs.
6. The training slice: one training step of the default SUNet at 256x256
   batch 4 on a synthetic dataset, fused vs eager on the same weights,
   batch and drop-path draws (loss and every parameter's gradient), launch
   counts equal to ``expected_launches(train=True)``, train-step times,
   peak memory, a profiler trace of one step; then ``python -m
   sunet_tf_tpu_torch.train`` for 1 epoch of 3 steps and a val pass.

Prints a JSON line of per-kernel results, then, as the last line,
``{"ok": true, "device": {...}}``. Any failed check raises (exit code != 0)
before that line; ``--phases`` runs a subset and then prints no result
lines. Needs one GPU; imports nothing of JAX.
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
# The backward kernels against their plain versions. The two share every
# rounding point and sum the same bf16 products in another order, so they
# differ where a bf16 rounding flips; a backward passes ~7 such points (y,
# LN2(y), gelu(a), dab, dattn, dctx, dqkv) against the forward's ~5, and a
# flip early on moves everything after it. dx: max |diff| <= BWD_MAX_TOL *
# max(1, max|ref|), mean |diff| <= BWD_MEAN_TOL * max(1, mean|ref|); every
# float32 weight grad: mean |diff| <= GRAD_MEAN_TOL * mean |ref|. Sound
# readings on the H100 and the mutants' readings are in PERF.md.
BWD_MAX_TOL = 1e-1
BWD_MEAN_TOL = 2e-3
GRAD_MEAN_TOL = 1e-2
# Training step: the fused route and the eager route in bf16 are both held
# against the eager route in float32 on the same weights, batch and
# drop-path draws. Loss relative difference <= TRAIN_LOSS_RTOL; per
# parameter tensor, cosine >= TRAIN_GRAD_COS and relative L2 <=
# TRAIN_GRAD_RL2, or, where the eager bf16 route itself is farther from
# float32 than that, within GRAD_NOISE_FACTOR times the eager bf16 route's
# own distance: bf16 compute alone moves the gradients of a freshly
# initialised model that far (the rel-pos bias tables most; PERF.md).
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_COS = 0.999
TRAIN_GRAD_RL2 = 5e-2
GRAD_NOISE_FACTOR = 2.0
# Published peaks of one H100 SXM (NVIDIA data sheet, dense): bf16 tensor
# cores and HBM3 bandwidth; the bounds below are against these.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

WA = "sunet_tf_tpu/kernels/window_attention.py"
REPLACES = {
    "fused_swin_block": (f"{WA}:1582", "sunet_tf_tpu_torch/kernels/csrc/swin_block.cu"),
    "fused_swin_block_chain": (f"{WA}:1741", "sunet_tf_tpu_torch/kernels/csrc/swin_block.cu"),
    "fused_ln_window_attention": (f"{WA}:2742",
                                  "sunet_tf_tpu_torch/kernels/csrc/ln_window_attention.cu"),
    "fused_ln_mlp": (f"{WA}:1350", "sunet_tf_tpu_torch/kernels/csrc/ln_mlp.cu"),
    "fused_dual_upsample4_conv_phase": ("sunet_tf_tpu/kernels/upsample.py:589",
                                        "sunet_tf_tpu_torch/kernels/csrc/up4_conv.cu"),
    "swin_block_bwd": (f"{WA}:2031", "sunet_tf_tpu_torch/kernels/csrc/swin_block_bwd.cu"),
    "up4_conv_bwd": ("sunet_tf_tpu/kernels/upsample.py:939",
                     "sunet_tf_tpu_torch/kernels/csrc/up4_conv_bwd.cu"),
}


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over the bf16 tensor-core peak and the bytes over the HBM rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def block_cost(B: int, H: int, C: int, ws: int = 8, blocks: int = 1) -> dict:
    """One Swin block forward (kernels #1, #2): products qkv, proj, fc1, fc2
    and the two attention products; bytes: x in, out, bf16 weights."""
    T, N, hid = B * H * H, ws * ws, 4 * C
    flops = blocks * (2 * T * C * (4 * C + 2 * hid) + 4 * T * N * C)
    return bound(flops, 2 * T * C * 2 + blocks * (4 * C * C + 2 * C * hid) * 2)


def block_bwd_cost(B: int, H: int, C: int, ws: int = 8) -> dict:
    """Backward of one block (#8, recompute form): the forward recomputed up
    to the fc1 pre-activation, then two products per forward product (the
    input and weight grads) and four attention products; bytes: x and dout
    in, dx out, bf16 weights in, float32 grads out."""
    T, N, hid = B * H * H, ws * ws, 4 * C
    recompute = 2 * T * C * (4 * C + hid) + 4 * T * N * C
    backward = 2 * 2 * T * C * (4 * C + 2 * hid) + 8 * T * N * C
    w = 4 * C * C + 2 * C * hid
    return bound(recompute + backward, 3 * T * C * 2 + w * 2 + w * 4)


def up4_cost(B: int, H: int, C: int, out: int) -> dict:
    """x4 head + conv forward (#5), per low-res pixel: 34 C^2 multiply-adds
    of the head, 144 C*out of the conv; bytes: x in, phase map out, bf16
    weights."""
    M = B * H * H
    return bound(M * (68 * C * C + 288 * C * out),
                 M * C * 2 + M * 16 * out * 2 + 19 * C * C * 2)


def up4_bwd_cost(B: int, H: int, C: int, out: int) -> dict:
    """Backward of the head + conv (#9): the head recomputed, two products
    per head product, the conv's input and per-slot weight grads; bytes: x
    and dout in, dx out, bf16 weights in, float32 grads out."""
    M = B * H * H
    return bound(M * (3 * 68 * C * C + (288 + 1152) * C * out),
                 2 * M * C * 2 + M * 16 * out * 2 + 19 * C * C * 2
                 + (19 * C * C + 36 * C * 16 * out) * 4)


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


def compare(name: str, got, ref, near_tie=None, max_tol: float = MAX_TOL,
            mean_tol: float = MEAN_TOL) -> tuple:
    """Hold a kernel's output against its plain version; ``near_tie`` (a
    (B, H, W) bool map) leaves those tokens out of the tolerances, and then
    every token beyond the max tolerance must lie on a near tie."""
    import torch

    torch.cuda.synchronize()
    g, r = got.float(), ref.float()
    check(bool(torch.isfinite(g).all()), f"{name}: non-finite kernel output")
    d = (g - r).abs()
    mx, mean = float(d.max()), float(d.mean())
    tol_max = max_tol * max(1.0, float(r.abs().max()))
    tol_mean = mean_tol * max(1.0, float(r.abs().mean()))
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


def record_time(results: dict, name: str, case: str, got_fn, plain_fn, cost: dict,
                mx: float, mean: float):
    """Time a kernel and its plain version (CUDA events, medians) and file
    the case with its bound under ``name``."""
    ms, plain_ms = time_ms(got_fn), time_ms(plain_fn)
    print(f"    time {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, bound "
          f"{cost['bound_ms']:.4f} ms ({cost['bound_by']})")
    r = results.setdefault(name, {"max_abs_err": 0.0, "cases": []})
    r["max_abs_err"] = max(r["max_abs_err"], mx)
    r["cases"].append({"case": case, "max_abs_err": mx, "mean_abs_err": mean, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": cost["bound_ms"],
                       "bound_by": cost["bound_by"], "library_ms": None})


def compare_grads(name: str, got: tuple, ref: tuple, labels: tuple) -> tuple:
    """dx (got[0]) under the backward limits, every other (float32) grad
    under mean |diff| <= GRAD_MEAN_TOL * mean |ref|; returns dx's (max,
    mean)."""
    import torch

    mx, mean = compare(f"{name} dx", got[0], ref[0], max_tol=BWD_MAX_TOL,
                       mean_tol=BWD_MEAN_TOL)
    bad = []
    rels = {}
    for lab, g, r in zip(labels, got[1:], ref[1:]):
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite {lab}")
        rels[lab] = float((g - r).abs().mean()) / max(float(r.abs().mean()), 1e-30)
        if rels[lab] > GRAD_MEAN_TOL:
            bad.append(f"{lab} {rels[lab]:.3e}")
    print(f"  {name} weight grads mean|diff|/mean|ref| (tol {GRAD_MEAN_TOL:g}): "
          + " ".join(f"{k} {v:.2e}" for k, v in rels.items())
          + (" ok" if not bad else " FAIL " + ", ".join(bad)))
    check(not bad, f"{name}: weight grads disagree with the plain version: {bad}")
    return mx, mean


BLOCK_GRADS = ("dln1_g", "dln1_b", "dwqkv", "dbqkv", "dwproj", "dbproj", "dln2_g",
               "dln2_b", "dw1", "db1", "dw2", "db2", "dbias")
UP4_GRADS = ("dw_exp", "dalpha_p", "dw_b1", "db_b1", "dalpha_b", "dwpf", "dwbf", "dwconv")


def train_kernel_phases(results: dict):
    """The training kernels: #1's train form, #8 and #9 against their plain
    versions."""
    import torch

    from sunet_tf_tpu_torch.kernels import upsample as up
    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.ops.window import shift_attn_mask

    gen = torch.Generator(device="cuda").manual_seed(4321)
    B, ws, heads, scale = 2, 8, 8, 8.0
    N = ws * ws
    # drop-path scales: image 0 keeps both branches, image 1 drops its MLP
    dp = torch.tensor([[1 / 0.9, 1 / 0.9], [1 / 0.9, 0.0]], device="cuda")
    print("phase: training kernels vs plain versions (bf16, batch 2)")
    for H, C, shift in ((64, 96, 4), (16, 384, 0)):
        p = block_params(C, heads, N, gen)
        x = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
        mask = (torch.as_tensor(shift_attn_mask(H, H, ws, shift), device="cuda")
                if shift else None)
        args = (x, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10], p[11],
                p[12], mask)
        kw = dict(ws=ws, num_heads=heads, scale=scale, shift=shift)
        case = f"({H},{H},{C}) shift {shift} train form"
        got_fn = lambda: wa.fused_swin_block(*args, dp, **kw)
        mx, mean = compare(f"fused_swin_block {case}", got_fn(),
                           wa.fused_swin_block_reference(*args, dp, **kw))
        record_time(results, "fused_swin_block", case, got_fn,
                    lambda: wa.fused_swin_block_reference(*args, dp, **kw),
                    block_cost(B, H, C), mx, mean)
        ones = wa.fused_swin_block(*args, torch.ones(B, 2, device="cuda"), **kw)
        check(torch.equal(ones, wa.fused_swin_block(*args, **kw)),
              "train form with dp = ones differs from the inference launch")
        print(f"  ({H},{H},{C}) shift {shift}: dp = ones equals the inference launch "
              "bit for bit")

    for H, C in ((64, 96), (32, 192), (16, 384)):
        for shift in (0, 4):
            p = block_params(C, heads, N, gen)
            x = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
            dout = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
            mask = (torch.as_tensor(shift_attn_mask(H, H, ws, shift), device="cuda")
                    if shift else None)
            args = (x, dout, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10],
                    p[11], p[12], mask, dp)
            kw = dict(ws=ws, num_heads=heads, scale=scale, shift=shift)
            case = f"({H},{H},{C}) shift {shift}"
            got_fn = lambda: wa.swin_block_bwd(*args, **kw)
            ref_fn = lambda: wa.swin_block_bwd_reference(*args, **kw)
            got = got_fn()
            mx, mean = compare_grads(f"swin_block_bwd {case}", got, ref_fn(), BLOCK_GRADS)
            check(all(torch.equal(a, b) for a, b in zip(got, got_fn())),
                  f"swin_block_bwd {case}: two runs differ (the reductions must be "
                  "deterministic)")
            record_time(results, "swin_block_bwd", case, got_fn, ref_fn,
                        block_bwd_cost(B, H, C), mx, mean)

    H, C, out_ch = 64, 96, 1
    n = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    bw = lambda i, o: (n(i, o) / i ** 0.5).to(torch.bfloat16)
    hp = (n(B, H, H, C).to(torch.bfloat16), bw(C, 16 * C),
          torch.full((1,), 0.25, device="cuda"), bw(C, C), 0.1 * n(C),
          torch.full((1,), 0.2, device="cuda"), bw(C, C), bw(C, C),
          (n(3, 3, C, out_ch) / (9 * C) ** 0.5).to(torch.bfloat16),
          n(B, H, H, 16 * out_ch).to(torch.bfloat16))
    case = f"({H},{H},{C}) out {out_ch}"
    got_fn = lambda: up.up4_conv_bwd(*hp)
    ref_fn = lambda: up.up4_conv_bwd_reference(*hp)
    got = got_fn()
    mx, mean = compare_grads(f"up4_conv_bwd {case}", got, ref_fn(), UP4_GRADS)
    check(all(torch.equal(a, b) for a, b in zip(got, got_fn())),
          f"up4_conv_bwd {case}: two runs differ (the reductions must be deterministic)")
    print("  both backward kernels: two runs equal bit for bit")
    record_time(results, "up4_conv_bwd", case, got_fn, ref_fn, up4_bwd_cost(B, H, C, out_ch),
                mx, mean)


def kernel_phases(results: dict):
    import torch

    from sunet_tf_tpu_torch.kernels import upsample as up
    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.ops.window import shift_attn_mask

    gen = torch.Generator(device="cuda").manual_seed(1234)
    B, ws, heads, scale = 2, 8, 8, 8.0
    N = ws * ws

    def record(name, case, got_fn, ref_fn, cost, near_tie=None, plain_fn=None):
        """``plain_fn``, when given, is the whole plain version to time, where
        ``ref_fn`` computes only the part the comparison needs."""
        got, ref = got_fn(), ref_fn()
        mx, mean = compare(f"{name} {case}", got, ref, near_tie)
        record_time(results, name, case, got_fn, plain_fn or ref_fn, cost, mx, mean)

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
               lambda: wa.fused_swin_block_reference(*args, **kw), block_cost(B, H, C),
               near_tie=tie)

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
           chain, lambda: second_ref(first), block_cost(B, H, C, blocks=2),
           plain_fn=plain_chain)
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
    T = B * H * H
    record("fused_ln_window_attention", f"({H},{H},{C})",
           lambda: wa.fused_ln_window_attention(x, *p[0:6], p[12], None, **bkw),
           lambda: wa.fused_ln_window_attention_reference(x, *p[0:6], p[12], None, **bkw),
           bound(2 * T * C * 4 * C + 4 * T * N * C, 2 * T * C * 2 + 4 * C * C * 2))
    record("fused_ln_mlp", f"({H},{H},{C})",
           lambda: wa.fused_ln_mlp(x, p[6:8], *p[8:12]),
           lambda: wa.fused_ln_mlp_reference(x, p[6:8], *p[8:12]),
           bound(4 * T * C * 4 * C, 2 * T * C * 2 + 2 * C * 4 * C * 2))

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
               lambda: up.fused_dual_upsample4_conv_phase_reference(*hp),
               up4_cost(B, H, C, out_ch))


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
        trace = trace_step(lambda: fused(x), "fused forward")
    for k, v in launches.items():
        results.setdefault(k, {"max_abs_err": 0.0, "cases": []})["launches"] = v
    del fused, eager
    torch.cuda.empty_cache()
    return {"fused_ms": fused_ms, "eager_ms": eager_ms, "mean_abs_diff": mean,
            "trace": trace}


def trace_step(fn, label: str) -> dict:
    """Device time of one call of ``fn`` by kernel, from torch.profiler: the
    port's kernels by name (the block kernel by its column-tile count MC: 1,
    2, 3 at C=96, 192, 384; the backward's GEMMs by their operand layouts),
    everything else as plain torch ops; the device's busy share of the
    call's CUDA-event time."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
    wall_ms = s.elapsed_time(e)
    spans, groups, plain = [], {}, {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        t0, t1 = ev.time_range.start, ev.time_range.end
        spans.append((t0, t1))
        m = re.search(r"sunet::(\w+(?:<[\w, ]+>)?)", ev.name)
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
    print(f"  trace of one {label}: {len(spans)} device events, busy "
          f"{busy / 1000:.3f} ms of {wall_ms:.3f} ms (idle share "
          f"{1 - busy / 1000 / wall_ms:.3f})")
    for key, (n, us) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        print(f"    {key}: {n} launches, {us / 1000:.3f} ms")
    print("    largest plain torch kernels:")
    for name, (n, us) in sorted(plain.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"      {n} x {us / 1000:.3f} ms  {name[:100]}")
    return {"wall_ms": wall_ms, "busy_ms": busy / 1000,
            "groups": {k: {"launches": n, "ms": us / 1000} for k, (n, us) in groups.items()}}


def train_phase(results: dict) -> dict:
    """One training step of the default SUNet, fused vs eager, then the
    training entry point."""
    import csv

    import numpy as np
    import torch
    import yaml

    from sunet_tf_tpu_torch.config import Config, config_to_dict
    from sunet_tf_tpu_torch.data.pipeline import PairDataset, batch_iterator
    from sunet_tf_tpu_torch.data.synth import generate_dataset
    from sunet_tf_tpu_torch.kernels import _build
    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.models.sunet import TRAIN_WRAPPERS, build_model
    from sunet_tf_tpu_torch.train.loop import (build_steps, loss_and_metrics, prepare,
                                               step_generators, to_device)
    from sunet_tf_tpu_torch.train.trainer import make_optimizer

    print("phase: training slice (default SUNet, 256x256, batch 4, bf16 compute, "
          "float32 parameters)")
    cfg, task = Config(), "mask"
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        generate_dataset(str(tmp / "train"), 12, size=256, seed=0)
        generate_dataset(str(tmp / "val"), 2, size=256, seed=1)
        ds = PairDataset(str(tmp / "train"), 256, train=True, seed=0)
        batch = to_device(next(batch_iterator(ds, 4, shuffle=True, drop_last=True, seed=0)),
                          "cuda")
        # the fused route and the eager route in the compute dtype (bf16), and
        # the eager route in float32, the oracle of both
        models = {"fused": build_model(cfg, device="cuda", backend="fused", seed=0),
                  "eager": build_model(cfg, device="cuda", backend="eager", seed=0),
                  "eager_fp32": build_model(cfg.replace(compute_dtype="float32"),
                                            device="cuda", backend="eager", seed=0)}
        for be in ("eager", "eager_fp32"):
            models[be].load_state_dict(models["fused"].state_dict())
        inp, tar = prepare(batch, task, 50.0, step_generators(0, 0, "cuda")[0])
        valid = torch.ones(4, device="cuda")
        want = models["fused"].expected_launches(tuple(inp.shape), train=True)
        step, grads = {}, {}
        for be, m in models.items():
            m.train().requires_grad_(True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_counts()
            with wa.exact_fp32():
                loss, _, _ = loss_and_metrics(m, inp, tar, step_generators(0, 0, "cuda")[1],
                                              valid, task)
                loss.backward()
            torch.cuda.synchronize()
            step[be] = {"loss": loss.item(),
                        "launches": {k: _build.counter(k).cuda for k in TRAIN_WRAPPERS},
                        "cpu": {k: _build.counter(k).cpu for k in TRAIN_WRAPPERS},
                        "peak_bytes": torch.cuda.max_memory_allocated()}
            grads[be] = {n: p.grad.double().flatten() for n, p in m.named_parameters()
                         if p.grad is not None}
            m.zero_grad(set_to_none=True)
        launches = step["fused"]["launches"]
        print(f"  launches per training step: {launches} (router predicts {want})")
        check(launches == want, "training launch counts differ from expected_launches")
        check(all(launches[k] > 0 for k in ("fused_swin_block", "swin_block_bwd",
                                             "fused_dual_upsample4_conv_phase",
                                             "up4_conv_bwd")),
              "a training kernel was not launched")
        check(not any(step["fused"]["cpu"].values()), "plain versions ran in training")
        for be in ("eager", "eager_fp32"):
            check(not any(step[be]["launches"].values()), f"{be} route launched kernels")
        ref = grads["eager_fp32"]

        def agree(be: str, noise: dict = None) -> dict:
            """Loss and per-parameter gradient agreement of route ``be`` with
            the float32 eager route; ``noise``: the eager bf16 route's own
            (cos, rl2) per tensor, which widens the limits where it is
            farther."""
            lr, lo = step[be]["loss"], step["eager_fp32"]["loss"]
            r = {"loss_rel_diff": abs(lr - lo) / max(abs(lo), 1e-12), "bad": [],
                 "cos": (1.0, ""), "rl2": (0.0, ""), "n": 0, "per": {}, "strict": 0}
            for name, b in ref.items():
                if not bool(b.any()):
                    continue
                a = grads[be].get(name)
                check(a is not None and bool(torch.isfinite(a).all()),
                      f"{be} grad of {name} missing or non-finite")
                cos = float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))
                rl2 = float((a - b).norm() / b.norm())
                r["n"] += 1
                r["per"][name] = (cos, rl2)
                r["cos"] = min(r["cos"], (cos, name))
                r["rl2"] = max(r["rl2"], (rl2, name))
                cos_lim, rl2_lim = TRAIN_GRAD_COS, TRAIN_GRAD_RL2
                r["strict"] += cos >= cos_lim and rl2 <= rl2_lim
                if noise is not None:
                    ce, re = noise[name]
                    cos_lim = min(cos_lim, 1.0 - GRAD_NOISE_FACTOR * (1.0 - ce))
                    rl2_lim = max(rl2_lim, GRAD_NOISE_FACTOR * re)
                if cos < cos_lim or rl2 > rl2_lim:
                    r["bad"].append(f"{name} cos {cos:.5f} (limit {cos_lim:.5f}) rl2 "
                                    f"{rl2:.3e} (limit {rl2_lim:.3e})")
            print(f"  {be} vs eager float32: loss {lr:.6f} vs {lo:.6f} (rel diff "
                  f"{r['loss_rel_diff']:.3e}); {r['n']} gradient tensors, worst cosine "
                  f"{r['cos'][0]:.6f} ({r['cos'][1]}), worst relative L2 {r['rl2'][0]:.3e} "
                  f"({r['rl2'][1]}); {r['strict']} within cos {TRAIN_GRAD_COS} and rl2 "
                  f"{TRAIN_GRAD_RL2:g}")
            return r

        eager_r = agree("eager")
        fused_r = agree("fused", noise=eager_r["per"])
        closer = sum(fused_r["per"][k][1] <= eager_r["per"][k][1] for k in fused_r["per"])
        print(f"  the fused route is closer to float32 than the eager bf16 route in "
              f"{closer} of {fused_r['n']} tensors")
        for b in fused_r["bad"][:20]:
            print(f"    FAIL {b}")
        check(np.isfinite(step["fused"]["loss"]), "non-finite training loss")
        check(fused_r["loss_rel_diff"] <= TRAIN_LOSS_RTOL,
              "fused training loss disagrees with eager")
        check(not fused_r["bad"], f"{len(fused_r['bad'])} fused parameter gradients "
              "disagree with eager float32")
        lf, le = step["fused"]["loss"], step["eager_fp32"]["loss"]
        rel, worst_cos, worst_rl2 = (fused_r["loss_rel_diff"], fused_r["cos"][0],
                                     fused_r["rl2"][0])
        del grads, ref
        models.pop("eager_fp32")
        torch.cuda.empty_cache()

        # train-step times (forward, backward, Adam update), peak memory
        times, fns = {}, {}
        for be, m in models.items():
            fns[be] = build_steps(m, make_optimizer(cfg, m, 1), task=task, seed=0)
            counter = iter(range(1, 10_000))
            run = lambda f=fns[be]: f.train_step(batch, next(counter), f.init_metrics())
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            run()
            torch.cuda.synchronize()
            step[be]["step_peak_bytes"] = torch.cuda.max_memory_allocated()
            step[be]["step_added_bytes"] = step[be]["step_peak_bytes"] - base
            times[be] = time_ms(run, iters=10, warmup=2)
        for be in models:
            print(f"  {be}: train step {times[be]:.3f} ms (median of 10); peak memory "
                  f"over a step {step[be]['step_peak_bytes'] / 2**30:.3f} GiB, of which "
                  f"{step[be]['step_added_bytes'] / 2**30:.3f} GiB above what was "
                  "allocated before it (both models' weights, grads and Adam state "
                  "stay resident)")
        counter = iter(range(100, 10_000))
        trace = trace_step(lambda: fns["fused"].train_step(batch, next(counter),
                                                            fns["fused"].init_metrics()),
                           "fused training step")
        del models, fns
        torch.cuda.empty_cache()
        for k, v in launches.items():
            results.setdefault(k, {"max_abs_err": 0.0, "cases": []})["train_launches"] = v

        # the entry point: python -m sunet_tf_tpu_torch.train
        print("phase: training entry point (1 epoch of 3 steps, one val pass)")
        raw = config_to_dict(cfg)
        raw["TRAINING"].update({"TRAIN_DIR": str(tmp / "train"), "VAL_DIR": str(tmp / "val"),
                                "SAVE_DIR": str(tmp / "ck")})
        (tmp / "training.yaml").write_text(yaml.safe_dump(raw))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "sunet_tf_tpu_torch.train", "--config",
             str(tmp / "training.yaml"), "--epochs", "1", "--steps-per-epoch", "3",
             "--device", "cuda"], cwd=ROOT, capture_output=True, text=True, timeout=900)
        fit_s = time.perf_counter() - t0
        print("\n".join("  | " + ln for ln in proc.stdout.strip().splitlines()[-6:]))
        check(proc.returncode == 0, f"training CLI exited {proc.returncode}: "
              f"{proc.stderr.strip()[-2000:]}")
        ckpt = tmp / "ck" / cfg.mode / "models" / "latest.pth"
        check(ckpt.is_file(), "no latest checkpoint written")
        with open(tmp / "ck" / cfg.mode / "log" / "metrics_per_epoch.csv") as f:
            rows = list(csv.DictReader(f))
        check(len(rows) == 1 and np.isfinite(float(rows[0]["Train_LOSS"]))
              and rows[0].get("Val_LOSS", "") != "", f"metrics rows {rows}")
        print(f"  CLI: {fit_s:.1f} s wall, train loss {float(rows[0]['Train_LOSS']):.6f}, "
              f"val loss {float(rows[0]['Val_LOSS']):.6f}, checkpoint "
              f"{ckpt.stat().st_size / 2**20:.1f} MiB")
    out.update({"fused_step_ms": times["fused"], "eager_step_ms": times["eager"],
                "loss_fused": lf, "loss_eager": le, "loss_rel_diff": rel,
                "worst_grad_cos": worst_cos, "worst_grad_rel_l2": worst_rl2,
                "peak_bytes": {be: step[be].get("step_peak_bytes") for be in step},
                "step_added_bytes": {be: step[be].get("step_added_bytes") for be in step},
                "launches": launches, "trace": trace, "cli_seconds": fit_s})
    return out


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


PHASES = ("kernels", "train_kernels", "slice", "demo", "train")


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    phases = [p for p in ap.parse_args().phases.split(",") if p]
    if not set(phases) <= set(PHASES):
        raise SystemExit(f"chip_smoke: unknown phases {sorted(set(phases) - set(PHASES))}")
    t_start = time.perf_counter()
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
    stats: dict = {}
    if "kernels" in phases:
        kernel_phases(results)
    if "train_kernels" in phases:
        train_kernel_phases(results)
    if "slice" in phases:
        stats["slice"] = slice_phase(results)
    if "demo" in phases:
        demo_phase()
    if "train" in phases:
        stats["train"] = train_phase(results)
    total_s = time.perf_counter() - t_start
    print(f"chip_smoke: phases {','.join(phases)} passed in {total_s:.1f} s wall")
    if list(phases) != list(PHASES):
        return

    kernels = []
    for name, (replaces, source) in REPLACES.items():
        r = results[name]
        first = r["cases"][0]
        launches = r["launches"] if "launches" in r else r["train_launches"]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": r["max_abs_err"], "ms": first["ms"],
                        "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
                        "bound_by": first["bound_by"], "library_ms": None,
                        "train_launches": r.get("train_launches", 0), "cases": r["cases"]})
    line = {"kernels": kernels, **stats, "wall_seconds": total_s}
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(line, indent=1))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
