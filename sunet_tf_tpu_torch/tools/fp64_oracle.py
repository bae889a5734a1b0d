"""The float64 oracle: the port's eager model with float64 parameters and
every product in float64, the arbiter of how far each route's rounding
moves an output (the counterpart of the JAX repo's ``tools/fp64_oracle.py``,
which ran the reference's torch code in ``.double()``; that code is not
part of this package, so the oracle is the port's own eager route, held
against the JAX XLA forward on the CPU by ``tests/test_torch_port_parity.py``).

Reads the checkpoint and ``RESULTS.json`` of ``tools/parity_run.py``, takes
the ``--n-worst`` validation images by |fused bf16 PSNR - oracle PSNR|,
runs each route of the port on them (fused bf16, eager bf16, eager
float32) and the oracle, and appends an ``"fp64_oracle"`` section to
``RESULTS.json``: per route the PSNR, mean |out - fp64|, |PSNR - PSNR_fp64|,
and whether the fused route sits as close to exact as the eager route in
its dtype (``fused_closer_or_equal_to_exact``).

Usage:
    python -m sunet_tf_tpu_torch.tools.fp64_oracle [--out runs/parity_torch]
        [--data <out>/data] [--n-worst 2] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from sunet_tf_tpu_torch.models.sunet import SUNet, route_copy


def oracle_model(model: SUNet) -> SUNet:
    """A float64 eager copy of ``model``: the same weights, on the same
    device."""
    return route_copy(model, dtype=torch.float64, backend="eager")


def np_psnr(target: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """(B,) PSNR of (B, H, W, C) batches after clipping to [0, 1], in numpy
    (the reference's utils/image_utils.py:6-10)."""
    t = np.clip(target, 0.0, 1.0)
    p = np.clip(pred, 0.0, 1.0)
    rmse = np.sqrt(np.mean((t - p) ** 2, axis=(1, 2, 3)))
    return 20.0 * np.log10(1.0 / np.maximum(rmse, 1e-12))


def oracle_section(outs: dict, targets: np.ndarray, images: list) -> dict:
    """The report on ``images`` from each route's outputs ``outs`` (name ->
    (B, H, W, C) float64, "fp64_oracle" among them) and their targets."""
    r4 = lambda v: [round(float(x), 4) for x in v]
    ref = outs["fp64_oracle"]
    psnr = {k: np_psnr(targets, v) for k, v in outs.items()}
    routes = [k for k in outs if k != "fp64_oracle"]
    gap = {k: np.abs(psnr[k] - psnr["fp64_oracle"]) for k in routes}
    section = {
        "images": list(images),
        "psnr": {k: r4(v) for k, v in psnr.items()},
        "mean_abs_out_diff_vs_fp64": {
            k: [float(np.mean(np.abs(outs[k][i] - ref[i]))) for i in range(len(ref))]
            for k in routes},
        "psnr_abs_err_vs_fp64": {k: r4(v) for k, v in gap.items()},
    }
    # the fused route is not the diverging side where its PSNR sits no
    # farther from the oracle's than the eager route's in the same dtype
    if "fused_bfloat16" in gap and "eager_bfloat16" in gap:
        section["fused_closer_or_equal_to_exact"] = bool(
            np.all(gap["fused_bfloat16"] <= gap["eager_bfloat16"] + 1e-4))
    return section


def main(argv=None) -> dict:
    from sunet_tf_tpu_torch.tools import parity_run as pr

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=pr.DEFAULT_OUT)
    ap.add_argument("--data", default=None, help="default: <out>/data")
    ap.add_argument("--n-worst", type=int, default=2)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    res_path = os.path.join(args.out, "RESULTS.json")
    with open(res_path) as f:
        results = json.load(f)
    cfg = pr.cfg_from_results(results, args.out, args.data)
    deltas = np.abs(np.asarray(results["per_image_delta_vs_oracle_db"]))
    worst = np.argsort(-deltas, kind="stable")[: args.n_worst].tolist()
    print(f"# arbitrating images {worst} (|fused bf16 - oracle| {deltas[worst]} dB)")
    noisy, targets = pr.val_arrays(cfg)
    model = pr.load_trained(cfg, device)
    t0 = time.time()
    outs = pr.route_outputs(model, noisy[worst], device)
    print(f"# routes and oracle: {time.time() - t0:.1f} s")
    section = oracle_section(outs, targets[worst], worst)
    results["fp64_oracle"] = section
    with open(res_path, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(section, indent=1))
    return section


if __name__ == "__main__":
    main()
