"""Fixed-size inference on a folder of images (counterpart of ``cli/demo.py``).

Reads every .jpg/.jpeg/.png/.bmp in --input_dir, groups images by shape,
reflect-pads each group to the model's granularity, runs the forward in
batches of --batch, clamps to [0, 1] and writes .bmp files of the input size
into --result_dir.

    python -m sunet_tf_tpu_torch.demo --input_dir in/ --result_dir out/ \
        [--weights model.pth] [--config training.yaml] [--batch 8] \
        [--out_chans 1] [--backend fused|eager] [--device cuda]

--weights takes a reference-format .pth (``{'state_dict': ...}``, as
``tools/export_torch_checkpoint.py`` writes); without it the weights are
random (seed 0).
"""

from __future__ import annotations

import argparse
import glob
import os
import re
from collections import defaultdict

import numpy as np
import torch
from PIL import Image

from sunet_tf_tpu_torch.config import Config, load_config
from sunet_tf_tpu_torch.infer.tiled import padded_inference, required_granularity
from sunet_tf_tpu_torch.models.sunet import build_model
from sunet_tf_tpu_torch.weights import load_reference_checkpoint

_NAT_SPLIT = re.compile(r"(\d+)")
IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def natural_sorted(names):
    """Sort with numeric runs compared as integers."""
    def key(s):
        return tuple(int(t) if t.isdigit() else t.lower()
                     for t in _NAT_SPLIT.split(str(s)))

    return sorted(names, key=key)


def list_images(d: str) -> list:
    """The .jpg/.jpeg/.png/.bmp files of directory ``d``, naturally sorted."""
    return natural_sorted(f for f in glob.glob(os.path.join(d, "*.*"))
                          if f.lower().endswith(IMAGE_EXTS))


def add_model_args(p: argparse.ArgumentParser) -> None:
    """The model options the demo entry points share (``build_demo_model``)."""
    p.add_argument("--weights", default=None,
                   help="reference-format .pth; random weights if omitted")
    p.add_argument("--config", default="training.yaml")
    p.add_argument("--out_chans", type=int, default=None,
                   help="model head channels (3 = RGB, 1 = mask logits)")
    p.add_argument("--backend", default="fused", choices=["fused", "eager"])
    p.add_argument("--device", default="cuda")


def build_demo_model(args) -> tuple:
    """(config, model) from the ``add_model_args`` options: the YAML config
    if it exists, else ``Config()``; random weights (seed 0) unless
    --weights. Without a card, a CUDA --device stops with a message."""
    cfg = load_config(args.config) if os.path.exists(args.config) else Config()
    if args.out_chans is not None:
        cfg = cfg.replace(swinunet=cfg.swinunet.__class__(
            **{**cfg.swinunet.__dict__, "out_chans": args.out_chans}))
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")
    model = build_model(cfg, device=args.device, backend=args.backend)
    if args.weights:
        load_reference_checkpoint(model, args.weights)
    return cfg, model


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Demo Image Restoration")
    p.add_argument("--input_dir", required=True)
    p.add_argument("--result_dir", required=True)
    p.add_argument("--batch", type=int, default=8)
    add_model_args(p)
    return p.parse_args(argv)


def save_image(path: str, y: np.ndarray) -> np.ndarray:
    """Write an (H, W, C) float image in [0, 1] (C = 1 repeated to RGB) as
    8-bit RGB; returns the uint8 array written."""
    if y.shape[-1] == 1:
        y = np.repeat(y, 3, axis=-1)
    out = (np.clip(y, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    Image.fromarray(out).save(path)
    return out


def main(argv=None) -> list:
    """Run the demo; returns the paths written."""
    args = parse_args(argv)
    cfg, model = build_demo_model(args)
    device = torch.device(args.device)
    sw = cfg.swinunet
    gran = required_granularity(sw.patch_size, sw.num_stages, sw.win_size)

    files = list_images(args.input_dir)
    if not files:
        raise SystemExit(f"No files found at {args.input_dir}")
    os.makedirs(args.result_dir, exist_ok=True)

    by_shape = defaultdict(list)
    for f in files:
        img = np.asarray(Image.open(f).convert("RGB"), np.float32) / 255.0
        by_shape[img.shape].append((f, img))

    written = []
    bsz = max(args.batch, 1)
    with torch.inference_mode():
        for items in by_shape.values():
            for start in range(0, len(items), bsz):
                chunk = items[start:start + bsz]
                x = torch.from_numpy(np.stack([im for _, im in chunk])).to(device)
                y = padded_inference(model, x, gran).clamp(0.0, 1.0)
                for (f, _), yi in zip(chunk, y.cpu().numpy()):
                    name = os.path.splitext(os.path.basename(f))[0]
                    path = os.path.join(args.result_dir, name + ".bmp")
                    save_image(path, yi)
                    written.append(path)
    print(f"{len(written)} files saved at {args.result_dir}")
    return written


if __name__ == "__main__":
    main()
