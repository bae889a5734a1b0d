"""Directory-against-directory PSNR/SSIM (counterpart of ``cli/evaluate.py``,
the reference's evaluation.m without MATLAB).

Pairs the .jpg/.jpeg/.png/.bmp files of --gt_dir and --pred_dir in natural
sort order (the two must hold as many), and per pair computes PSNR on RGB in
[0, 1] and SSIM on the Rec.601 gray image (``ops.image.psnr``, ``ssim``,
``rgb_to_gray``); prints each pair's values and the directory means. With
--noisy_dir it also scores the degraded inputs against the ground truth.

    python -m sunet_tf_tpu_torch.evaluate --gt_dir GT/ --pred_dir results/ \
        [--noisy_dir noisy/] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from PIL import Image

from sunet_tf_tpu_torch.demo import list_images
from sunet_tf_tpu_torch.ops.image import psnr, rgb_to_gray, ssim


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="PSNR/SSIM directory evaluation")
    p.add_argument("--gt_dir", required=True)
    p.add_argument("--pred_dir", required=True)
    p.add_argument("--noisy_dir", default=None,
                   help="also score the degraded inputs, as evaluation.m does")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> list:
    """Score the directories; returns one dict per pair (name, psnr, ssim,
    and psnr_noisy, ssim_noisy with --noisy_dir)."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")

    def load(f):
        img = np.asarray(Image.open(f).convert("RGB"), np.float32) / 255.0
        return torch.from_numpy(img)[None].to(device)

    def score(gt, other):
        return float(psnr(gt, other)), float(ssim(rgb_to_gray(gt), rgb_to_gray(other)))

    gts, preds = list_images(args.gt_dir), list_images(args.pred_dir)
    if len(gts) != len(preds):
        raise ValueError(f"{len(gts)} GT vs {len(preds)} predictions")
    noisies = list_images(args.noisy_dir) if args.noisy_dir else [None] * len(gts)

    rows = []
    for g, pr, nz in zip(gts, preds, noisies):
        gt = load(g)
        row = {"name": os.path.basename(g)}
        row["psnr"], row["ssim"] = score(gt, load(pr))
        extra = ""
        if nz:
            row["psnr_noisy"], row["ssim_noisy"] = score(gt, load(nz))
            extra = f"  (noisy: {row['psnr_noisy']:.2f}/{row['ssim_noisy']:.4f})"
        rows.append(row)
        print(f"{row['name']}: PSNR {row['psnr']:.2f} dB  SSIM {row['ssim']:.4f}{extra}")

    print("-" * 60)
    print(f"mean PSNR: {np.mean([r['psnr'] for r in rows]):.4f} dB")
    print(f"mean SSIM: {np.mean([r['ssim'] for r in rows]):.4f}")
    if args.noisy_dir:
        print(f"mean noisy PSNR: {np.mean([r['psnr_noisy'] for r in rows]):.4f} dB")
        print(f"mean noisy SSIM: {np.mean([r['ssim_noisy'] for r in rows]):.4f}")
    return rows


if __name__ == "__main__":
    main()
