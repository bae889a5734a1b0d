#!/usr/bin/env python3
"""Calibrate chip_smoke's limits for the backward kernels on one NVIDIA GPU.

    python3 chip_mutants.py [--out PATH] [--step-only]

Runs chip_smoke's backward checks (``compare_grads`` on the block backward
at (64,64,96), (32,32,192), (16,16,384), shift 0 and 4, batch 2, on the
x4-head backward at (64,64,96) out 1, and on the C=768 training sublayers
of ``chip_smoke.sublayer_cases``: the LN+W-MSA backward at (8,8,768) and
(16,16,768) shift 4, the LN+MLP branch and its backward at (8,8,768)) with
failures reported instead of raised, and the training step's gradients,
in these settings:

- ``kernel``: the CUDA kernels against their plain versions, two input
  seeds, logit gain 1 and 0.25 (the sound readings the limits must pass);
- ``floor``: the plain version run on the CPU against itself on the card
  (the spread of a reordering alone);
- one run per mutant: a copy of the repository under a temporary directory
  with one deliberate fault in a kernel source, built and checked there
  (each must fail);
- ``step`` (alone with ``--step-only``): the limit of chip_smoke's training
  gate for the one-value parameters (the PReLU slopes). chip_smoke's batch-4
  step of the default SUNet runs on the float32 eager route and twice on
  each of six bf16 variants that differ only in where they round (the
  fused route; with its C=768 blocks on eager autograd; with the C=768
  sublayer kernels replaced by their plain versions; the fused and the
  eager route each with the drop-path product taken in float32; the eager
  route). Each run's relative error of every one-value gradient, and the
  relative L2 error of the C=768 stage's output; the largest error must
  stay within ``chip_smoke.ONE_VALUE_NOISE``.

Every reading goes to ``--out`` (default: beside the built kernels, in
``sunet_tf_tpu_torch/kernels/_build/``, git-ignored); the last lines
summarise the failing checks per setting. Needs one GPU; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# name: (source file under kernels/csrc, text, replacement)
MUTANTS = {
    "tanh_gelu_grad": ("train_common.cuh", """__device__ inline float gelu_grad_f(float v) {
  return 0.5f * (1.f + erff(v * 0.70710678118654752f)) +
         v * expf(-0.5f * v * v) * 0.3989422804014327f;
}""", """__device__ inline float gelu_grad_f(float v) {
  const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v), t = tanhf(u);
  return 0.5f * (1.f + t) +
         0.5f * v * (1.f - t * t) * 0.7978845608028654f * (1.f + 0.134145f * v * v);
}"""),
    "dp_missing_from_dm": ("train_common.cuh",
                           "const float s2 = dp ? dp[2 * (r / (H * W)) + 1] : 1.f;",
                           "const float s2 = 1.f;"),
    # every LN backward, the 12- and the 24-column (C=768) instances
    "ln_bwd_no_mean": ("train_common.cuh", "    m1 = warp_sum(m1) / C;\n", "    m1 = 0.f;\n"),
    "ds_no_rowsum": ("attn_train.cuh", "const float ds = p * (sm.s[i * ld + j] - sm.rd[i]);",
                     "const float ds = p * sm.s[i * ld + j];"),
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
for name, case, kernel, plain, args, kw, _, labels in cs.sublayer_cases(gen, gain=gain):
    ref = plain(*args, **kw)
    got = plain(*cpu(args), **kw) if mode == "floor" else kernel(*args, **kw)
    if labels is None:
        cs.compare(f"{name} {case} {tag}", got.cuda(), ref)
    else:
        cs.compare_grads(f"{name} {case} {tag}", tuple(g.cuda() for g in got), ref, labels)
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


@contextlib.contextmanager
def patched(patches: list):
    """Sets each (module, name, value) for the duration."""
    old = [(m, a, getattr(m, a)) for m, a, _ in patches]
    for m, a, v in patches:
        setattr(m, a, v)
    try:
        yield
    finally:
        for m, a, v in old:
            setattr(m, a, v)


def step_noise(log) -> list:
    """The ``step`` setting: one-value gradients of the training step under
    bf16 rounding variants, against the float32 eager route."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from sunet_tf_tpu_torch.config import Config
    from sunet_tf_tpu_torch.data.pipeline import PairDataset, batch_iterator
    from sunet_tf_tpu_torch.data.synth import generate_dataset
    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.models import layers
    from sunet_tf_tpu_torch.models.sunet import build_model
    from sunet_tf_tpu_torch.train.loop import (loss_and_metrics, prepare, step_generators,
                                               to_device)

    def say(line: str):
        print(line, flush=True)
        log.write(line + "\n")

    cfg, task = Config(), "mask"
    with tempfile.TemporaryDirectory() as tmp:
        generate_dataset(tmp + "/train", 12, size=256, seed=0)
        ds = PairDataset(tmp + "/train", 256, train=True, seed=0)
        batch = to_device(next(batch_iterator(ds, 4, shuffle=True, drop_last=True, seed=0)),
                          "cuda")
    models = {"fused": build_model(cfg, device="cuda", backend="fused", seed=0),
              "eager": build_model(cfg, device="cuda", backend="eager", seed=0),
              "eager_fp32": build_model(cfg.replace(compute_dtype="float32"), device="cuda",
                                        backend="eager", seed=0)}
    for be in ("eager", "eager_fp32"):
        models[be].load_state_dict(models["fused"].state_dict())
    inp, tar = prepare(batch, task, 50.0, step_generators(0, 0, "cuda")[0])
    valid = torch.ones(4, device="cuda")
    acts = {}
    for be, m in models.items():
        m.layers[-1].register_forward_hook(
            lambda mod, args, out, be=be: acts.__setitem__(be, out.detach().float()))

    def step(be: str) -> tuple:
        m = models[be]
        m.train().requires_grad_(True)
        with wa.exact_fp32():
            loss, _, _ = loss_and_metrics(m, inp, tar, step_generators(0, 0, "cuda")[1], valid,
                                          task)
            loss.backward()
        g = {n: p.grad.double().flatten().clone() for n, p in m.named_parameters()
             if p.grad is not None}
        m.zero_grad(set_to_none=True)
        return float(loss.detach()), g, acts[be]

    rl2 = lambda a, b: float((a - b).norm() / b.norm())
    loss32, ref, ref_act = step("eager_fp32")
    one = sorted(n for n, v in ref.items() if v.numel() == 1)
    say("[step] one-value gradients (float32 route): "
        + " ".join(f"{n} {ref[n].item():.3e}" for n in one))
    dp32 = lambda x, s: (x.float() * s.reshape((-1,) + (1,) * (x.dim() - 1))).to(x.dtype)
    sublayers = ("fused_ln_window_attention", "ln_window_attention_bwd", "ln_mlp_branch",
                 "ln_mlp_bwd")
    variants = (
        ("fused", "fused", []),
        ("fused, C=768 on eager autograd", "fused",
         [(layers, "ROUTE_TRAIN_SPLIT_MAX_C", layers.ROUTE_TRAIN_BLOCK_MAX_C)]),
        ("fused, C=768 sublayers by their plain versions", "fused",
         [(wa, n, getattr(wa, n + "_reference")) for n in sublayers]),
        ("fused, drop-path product in float32", "fused", [(layers, "drop_path", dp32)]),
        ("eager", "eager", []),
        ("eager, drop-path product in float32", "eager", [(layers, "drop_path", dp32)]))
    worst = (0.0, "", "")
    for label, be, patches in variants:
        runs = []
        for run in (1, 2):
            with patched(patches):
                loss, g, act = step(be)
            runs.append(g)
            err = {n: float((g[n] - ref[n]) / ref[n]) for n in one}
            worst = max(worst, *((abs(e), n, label) for n, e in err.items()))
            say(f"[step] {label}, run {run}: loss rel err {abs(loss - loss32) / loss32:.3e}; "
                f"C=768 stage output rl2 {rl2(act, ref_act):.3e}; one-value gradients' "
                "relative errors: " + " ".join(f"{n} {e:+.3e}" for n, e in err.items()))
        same = sum(torch.equal(runs[0][n], runs[1][n]) for n in runs[0])
        say(f"[step] {label}: {same} of {len(runs[0])} gradient tensors bit-identical "
            "between its two runs")
    covered = worst[0] <= cs.ONE_VALUE_NOISE
    return [f"SUMMARY [step]: largest one-value relative error {worst[0]:.4e} ({worst[1]}, "
            f"{worst[2]}); chip_smoke.ONE_VALUE_NOISE {cs.ONE_VALUE_NOISE} "
            + ("covers it" if covered else "DOES NOT cover it")]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "sunet_tf_tpu_torch" / "kernels" / "_build"
                                         / "chip_mutants.log"))
    ap.add_argument("--step-only", action="store_true",
                    help="run the step setting alone")
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
        if not args.step_only:
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
        summary += step_noise(log)
    print("\n".join(summary))
    print(f"chip_mutants: readings in {out}")


if __name__ == "__main__":
    main()
