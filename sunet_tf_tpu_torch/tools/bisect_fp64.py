"""Bisect a route's distance to the float64 oracle on trained weights (the
counterpart of the JAX repo's ``tools/bisect_fp64.py``).

(a) Toggles the port's one model-level rewrite, the folded stem
(``SUNet._stem``: conv_first 3x3 and the patch-embed conv folded into one
(p+2)x(p+2) stride-p conv) against conv_first then the patch-embed conv
(``SUNet.fold_stem = False``), and reads each form on eager float32, eager
bf16 and fused bf16 against the oracle: mean |out - fp64| and PSNR.
(b) The probe comparison of ``bisect_probes`` on the same images.

Reads the checkpoint and ``RESULTS.json`` of ``tools/parity_run.py`` and
appends a ``"bisect_fp64"`` section to ``RESULTS.json``.

Usage:
    python -m sunet_tf_tpu_torch.tools.bisect_fp64 [--out runs/parity_torch]
        [--data <out>/data] [--n-worst 2] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def stem_forms(model, noisy: np.ndarray, targets: np.ndarray, device) -> dict:
    """Phase (a): each route with the folded and the unfolded stem against
    the oracle (mean |out - fp64|, PSNR per image), and the oracle's PSNR."""
    from sunet_tf_tpu_torch.kernels.window_attention import exact_fp32
    from sunet_tf_tpu_torch.models.sunet import route_copy
    from sunet_tf_tpu_torch.tools.fp64_oracle import np_psnr, oracle_model
    from sunet_tf_tpu_torch.tools.parity_run import ROUTES

    x = torch.as_tensor(noisy, device=device)
    with torch.no_grad(), exact_fp32():
        ref = oracle_model(model)(x).cpu().numpy()
        report = {"fp64_psnr": [round(float(v), 4) for v in np_psnr(targets, ref)]}
        for name, be, dt in ROUTES:
            m = route_copy(model, dtype=dt, backend=be)
            for fold in (True, False):
                m.fold_stem = fold
                out = m(x).double().cpu().numpy()
                report[f"{name}, {'folded' if fold else 'unfolded'} stem"] = {
                    "mean_abs_vs_fp64": float(np.mean(np.abs(out - ref))),
                    "psnr": [round(float(v), 4) for v in np_psnr(targets, out)]}
    return report


def main(argv=None) -> dict:
    from sunet_tf_tpu_torch.tools import bisect_probes as bp
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
    idx = np.argsort(-deltas, kind="stable")[: args.n_worst].tolist()
    noisy, targets = pr.val_arrays(cfg)
    noisy, targets = noisy[idx], targets[idx]
    model = pr.load_trained(cfg, device)
    t0 = time.time()
    section = {"images": idx, "stem": stem_forms(model, noisy, targets, device)}
    for k, v in section["stem"].items():
        print(f"# (a) {k}: {v}")
    section["probes"] = bp.probe_report(model, torch.as_tensor(noisy, device=device))
    bp.print_report(section["probes"])
    section["time_s"] = round(time.time() - t0, 1)
    results["bisect_fp64"] = section
    with open(res_path, "w") as f:
        json.dump(results, f, indent=1)
    return section


if __name__ == "__main__":
    main()
