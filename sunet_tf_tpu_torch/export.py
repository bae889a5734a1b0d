"""Export the fused forward as ahead-of-time serving artifacts (counterpart of
``cli/export.py``, on ``torch.export``).

    python -m sunet_tf_tpu_torch.export --out runs/export --batches 1,4 \
        [--config training.yaml] [--weights model.pth] [--resolution 256] \
        [--tiled 1024x1024 --tile-kernel 256 --tile-stride 128] [--check] \
        [--device cuda|cpu]

Writes one ``forward_b{N}.pt2`` per batch bucket (and, with --tiled, one
``tiled_{Xh}x{Xw}.pt2`` per canvas) with its ``meta.json``
(``infer/export.py``). The artifacts hold no weights: a serving process
loads a checkpoint and calls ``ServingModel(dir)(params, x)``. --weights
takes the checkpoints ``demo.py`` loads (a reference-format .pth or one of
``ckpt.py``'s); the artifact is the same without it. --check reloads every
artifact and asserts that it equals the live fused model (and the live
``TiledRunner``) bit for bit. An artifact runs on the device it was
exported on.
"""

from __future__ import annotations

import argparse
import os
import time

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Export SUNet serving artifacts (torch.export)")
    ap.add_argument("--out", required=True, help="artifact directory")
    ap.add_argument("--config", default=None, help="training.yaml (Config() if omitted)")
    ap.add_argument("--weights", default=None,
                    help="checkpoint the --check runs with (the artifact is weights-agnostic)")
    ap.add_argument("--batches", default="1",
                    help="comma-separated static batch buckets, e.g. 1,4,8")
    ap.add_argument("--resolution", type=int, default=None,
                    help="input resolution (default: the config's img_size)")
    ap.add_argument("--check", action="store_true",
                    help="reload the artifacts and assert parity with the live model")
    ap.add_argument("--tiled", default=None,
                    help="also export tiled canvas buckets for images of any size: "
                         "comma-separated XhxXw shapes (multiples of --tile-kernel), "
                         "e.g. 1024x1024,512x768")
    ap.add_argument("--tile-kernel", type=int, default=256)
    ap.add_argument("--tile-stride", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _sizes(meta: dict) -> str:
    return ", ".join(f"{k}: {v / 1e6:.3f} MB" for k, v in meta["bytes"].items())


def main(argv=None) -> dict:
    """Export (and with --check verify) the artifacts; returns their metas."""
    args = parse_args(argv)
    from sunet_tf_tpu_torch.config import Config, load_config
    from sunet_tf_tpu_torch.infer.export import (
        ServingModel,
        TiledServingModel,
        save_exported,
        save_exported_tiled,
    )
    from sunet_tf_tpu_torch.infer.tiled import TiledRunner
    from sunet_tf_tpu_torch.models.sunet import build_model, resolve_device
    from sunet_tf_tpu_torch.weights import load_reference_checkpoint

    cfg = load_config(args.config) if args.config else Config()
    sw = cfg.swinunet
    device = resolve_device(args.device)
    res = args.resolution or sw.img_size
    batches = [int(b) for b in args.batches.split(",")]
    model = build_model(cfg, device=device, backend="fused")
    if args.weights:
        load_reference_checkpoint(model, args.weights)

    t0 = time.perf_counter()
    meta = save_exported(args.out, model, res, batches=batches,
                         extra_meta={"img_size": sw.img_size})
    print(f"exported batches {meta['batches']} at {res}x{res} for {meta['device']} in "
          f"{time.perf_counter() - t0:.1f} s -> {args.out} ({_sizes(meta)})")
    out = {"forward": meta}
    if args.tiled:
        buckets = [tuple(int(v) for v in b.split("x")) for b in args.tiled.split(",")]
        t0 = time.perf_counter()
        out["tiled"] = save_exported_tiled(args.out, model, buckets, kernel=args.tile_kernel,
                                           stride=args.tile_stride)
        print(f"exported tiled buckets {out['tiled']['buckets']} (kernel {args.tile_kernel}, "
              f"stride {args.tile_stride}) in {time.perf_counter() - t0:.1f} s "
              f"({_sizes(out['tiled'])})")
    if not args.check:
        return out

    gen = torch.Generator(device=device).manual_seed(0)
    sm = ServingModel(args.out, device=device)
    with torch.inference_mode():
        for b in meta["batches"]:
            x = torch.rand(b, res, res, sw.in_chans, device=device, generator=gen)
            diff = float((sm(model, x) - model(x)).abs().max())
            print(f"check: bucket {b} reloaded vs live max|diff| = {diff:.2e}")
            if diff != 0.0:
                raise SystemExit(f"the bucket-{b} artifact diverges from the live model")
        if args.tiled:
            Xh, Xw = out["tiled"]["buckets"][0]
            img = torch.rand(1, Xh - 7, Xw - 13, sw.in_chans, device=device, generator=gen)
            got = TiledServingModel(args.out, device=device)(model, img)
            live = TiledRunner(model, kernel=args.tile_kernel, stride=args.tile_stride)(img)
            diff = float((got - live).abs().max())
            print(f"check: tiled {Xh}x{Xw} reloaded vs live TiledRunner max|diff| = {diff:.2e}")
            if diff != 0.0:
                raise SystemExit("the tiled artifact diverges from the live TiledRunner")
    return out


if __name__ == "__main__":
    main()
