"""Tiled inference on a folder of images of any size (counterpart of
``cli/demo_any_resolution.py``).

Every .jpg/.jpeg/.png/.bmp in --input_dir is restored by overlap-tiled
inference (``infer.tiled.TiledRunner.run_corpus``: --size tiles at --stride,
fold-average reconstruction, images that pad to the same canvas batched
into one forward) and written as a .bmp of its own size into --result_dir.
With --mask_dir, each output is scored against the mask of the same file
name at the reference thresholds (prediction > 127, mask > 200) and the
TPR/FPR rows go to tpr_fpr_results.txt.

    python -m sunet_tf_tpu_torch.demo_any_resolution --input_dir in/ \
        --result_dir out/ [--mask_dir masks/] [--weights model.pth] \
        [--config training.yaml] [--size 256] [--stride 128] \
        [--tile_batch 64] [--square_pad] [--out_chans 1] \
        [--backend fused|eager] [--device cuda]

Images are decoded in chunks of at most ``CHUNK_IMAGES`` images and
``CHUNK_PIXELS`` pixels (an image above the pixel budget is a chunk of its
own), so a folder of large images does not fill the host's memory; the
chunks change no output. --weights takes a reference-format .pth; without
it the weights are random (seed 0).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from PIL import Image

from sunet_tf_tpu_torch.demo import add_model_args, build_demo_model, list_images, save_image
from sunet_tf_tpu_torch.infer.tiled import TiledRunner
from sunet_tf_tpu_torch.ops.metrics import tpr_fpr

CHUNK_IMAGES = 256
CHUNK_PIXELS = 1 << 26


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Demo Image Restoration (any resolution)")
    p.add_argument("--input_dir", required=True)
    p.add_argument("--mask_dir", default=None)
    p.add_argument("--result_dir", required=True)
    p.add_argument("--size", type=int, default=256, help="tile side")
    p.add_argument("--stride", type=int, default=128)
    p.add_argument("--tile_batch", type=int, default=64,
                   help="tiles per forward; up to this many run as one batch "
                        "(1024^2 at stride 128 = 49 tiles)")
    p.add_argument("--square_pad", action="store_true",
                   help="the reference's square canvas")
    add_model_args(p)
    return p.parse_args(argv)


def decode_chunks(files: list, max_images: int, max_pixels: int) -> list:
    """Split ``files`` into runs of at most ``max_images`` files and
    ``max_pixels`` pixels (read from the headers); a file above the pixel
    budget is a run of its own."""
    chunks, cur, pixels = [], [], 0
    for f in files:
        with Image.open(f) as im:
            w, h = im.size
        if cur and (len(cur) == max_images or pixels + w * h > max_pixels):
            chunks.append(cur)
            cur, pixels = [], 0
        cur.append(f)
        pixels += w * h
    if cur:
        chunks.append(cur)
    return chunks


def main(argv=None) -> list:
    """Run the demo; returns the paths written (the .bmp files)."""
    args = parse_args(argv)
    _, model = build_demo_model(args)
    files = list_images(args.input_dir)
    if not files:
        raise SystemExit(f"No image files found in {args.input_dir}")
    os.makedirs(args.result_dir, exist_ok=True)
    runner = TiledRunner(model, kernel=args.size, stride=args.stride,
                         tile_batch=args.tile_batch, square_pad=args.square_pad)

    print("Restoring images...")
    written = []
    with open(os.path.join(args.result_dir, "tpr_fpr_results.txt"), "w") as rf:
        rf.write("Filename\tTPR\tFPR\n")
        for chunk in decode_chunks(files, CHUNK_IMAGES, CHUNK_PIXELS):
            images = [np.asarray(Image.open(f).convert("RGB"), np.float32) / 255.0
                      for f in chunk]
            with torch.inference_mode():
                outs = runner.run_corpus(images)
            for f, y in zip(chunk, outs):
                written.append(_write_result(f, y[0].numpy(), args, rf))
    print(f"\nAll results saved in: {args.result_dir}")
    return written


def _write_result(f: str, y: np.ndarray, args, rf) -> str:
    """Write one output as .bmp and, with --mask_dir, its TPR/FPR row."""
    name = os.path.basename(f)
    path = os.path.join(args.result_dir, os.path.splitext(name)[0] + ".bmp")
    out = save_image(path, y)
    if args.mask_dir:
        mask_path = os.path.join(args.mask_dir, name)
        if os.path.exists(mask_path):
            mask = np.asarray(Image.open(mask_path).convert("L"))
            pred_gray = (0.2989 * out[..., 0] + 0.5870 * out[..., 1]
                         + 0.1140 * out[..., 2]).astype(np.uint8)
            tpr, fpr = tpr_fpr(pred_gray, mask)
            print(f"{name} — TPR: {tpr:.4f}, FPR: {fpr:.4f}")
            rf.write(f"{name}\t{tpr:.4f}\t{fpr:.4f}\n")
        else:
            print(f"Mask not found for {f}, skipping TPR/FPR.")
    return path


if __name__ == "__main__":
    main()
