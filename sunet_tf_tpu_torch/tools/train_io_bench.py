"""Training throughput with the input read from disk (the counterpart of
``tools/train_io_bench.py``): ``Trainer.train_epoch`` of the denoise task
fed from an on-disk PNG corpus through each input path.

    python -m sunet_tf_tpu_torch.tools.train_io_bench [--data runs/io_bench] [--n 1280] \
        [--batch 32] [--epochs 3] [--out runs/io_bench/train_io_bench.json] [--cpu --tiny]

Variants:

- ``cached_workers0``: the in-process pipeline with the decoded-pair LRU
  cache (the steady state of a patch corpus that fits the 4 GiB cache);
- ``nocache_workers0``: the same with the cache off (``SUNET_CACHE_BYTES=1``):
  whether one host thread decodes fast enough for a corpus larger than
  host memory;
- ``workers2`` / ``workers4``: ``TPU.DATA_WORKERS`` 2 and 4, the
  DataLoader workers of ``data/workers.py``, cache off;
- ``packed_memmap``: the corpus packed once into uint8 memmap shards
  (``data/packed.py``), an epoch streaming raw bytes.

The corpus is ``data/synth.py``'s, ``--n`` pairs at 256² (made once under
``--data``). The model is ``Config()`` with OUT_CHANS 3 (``--tiny``:
``tiny_config()`` at 64²) on the card (``--cpu``: on the CPU). Each variant
builds its own Trainer and runs ``--epochs`` epochs; an epoch is timed on the
host clock from a synchronised device to its end, so a step's time is the
pace the host and the input path set. Prints the card's name and power
limit, one line per variant (img/s per epoch, the best epoch after the
first, host-paced ms a step) and writes the report as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

VARIANTS = ("cached_workers0", "nocache_workers0", "workers2", "workers4", "packed_memmap")


def bench_config(train_dir: str, batch: int, epochs: int, save_dir: str, tiny: bool = False):
    """The benchmark's denoise config: ``Config()`` with OUT_CHANS 3 (or
    ``tiny_config()``), the 256² (64²) corpus at ``train_dir``."""
    import dataclasses

    from sunet_tf_tpu_torch.config import Config, OptimConfig, TrainingConfig, tiny_config

    base = tiny_config() if tiny else Config()
    ps = base.training.train_ps
    return base.replace(
        swinunet=dataclasses.replace(base.swinunet, out_chans=3),
        optim=OptimConfig(batch=batch, epochs=epochs),
        training=TrainingConfig(train_ps=ps, val_ps=ps, train_dir=train_dir,
                                save_dir=save_dir, seed=85))


def variant_setup(name: str, cfg, packed_dir: str) -> tuple:
    """(config, environment, packed dir or None) of variant ``name``."""
    if name == "cached_workers0":
        return cfg, {}, None
    if name.startswith("workers"):
        cfg = cfg.replace(data_workers=int(name[len("workers"):]))
    return cfg, {"SUNET_CACHE_BYTES": "1"}, packed_dir if name == "packed_memmap" else None


def run_variant(name: str, cfg, epochs: int, env: dict, packed_dir=None,
                device: str = "cuda") -> dict:
    """``epochs`` epochs of ``Trainer.train_epoch`` under ``env``:
    {"epochs_img_per_s", "step_ms", "steady_img_per_s"}."""
    from sunet_tf_tpu_torch.data.packed import PackedPairDataset
    from sunet_tf_tpu_torch.train.trainer import Trainer

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    try:
        t = Trainer(cfg, task="denoise", sigma=50.0, device=device, verbose=False)
        if packed_dir is not None:
            t.train_ds = PackedPairDataset(packed_dir, cfg.training.train_ps, train=True,
                                           seed=cfg.training.seed)
        rates, step_ms = [], []
        for epoch in range(1, epochs + 1):
            sync()
            t0 = time.perf_counter()
            out = t.train_epoch(epoch)
            sync()
            dt = time.perf_counter() - t0
            imgs = out["steps"] * cfg.optim.batch
            rates.append(imgs / dt)
            step_ms.append(dt * 1000.0 / out["steps"])
            print(f"#   {name} epoch {epoch}: {imgs} imgs in {dt:.3f} s = {rates[-1]:.2f} img/s, "
                  f"{step_ms[-1]:.3f} ms a step (host-paced)", flush=True)
        del t
        return {"epochs_img_per_s": rates, "step_ms": step_ms,
                "steady_img_per_s": max(rates[1:] or rates)}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def main(argv=None):
    ap = argparse.ArgumentParser(description="Training throughput with disk input")
    ap.add_argument("--data", default=os.path.join("runs", "io_bench"))
    ap.add_argument("--n", type=int, default=1280)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--out", default=None, help="JSON report (default: <data>/train_io_bench.json)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--tiny", action="store_true", help="tiny_config() at 64x64")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_io_bench: no CUDA device (pass --cpu to run on the CPU)")

    from sunet_tf_tpu_torch.data.packed import pack_pair_dataset
    from sunet_tf_tpu_torch.data.synth import generate_dataset

    size = 64 if args.tiny else 256
    tdir = os.path.join(args.data, "train")
    if not os.path.isdir(os.path.join(tdir, "input")):
        t0 = time.perf_counter()
        generate_dataset(tdir, args.n, size, seed=11, pair_mode="same")
        print(f"# corpus: {args.n} x {size}^2 pairs in {time.perf_counter() - t0:.1f} s")
    packed_dir = os.path.join(args.data, "packed")
    if not os.path.exists(os.path.join(packed_dir, "input.npy")):
        t0 = time.perf_counter()
        pack_pair_dataset(tdir, packed_dir, size)
        print(f"# packed shards in {time.perf_counter() - t0:.1f} s")
    if device == "cuda":
        from sunet_tf_tpu_torch.tools.alu_floor import card

        print(card())
    report = {"device": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
              "batch": args.batch, "n": args.n}
    with tempfile.TemporaryDirectory(dir=args.data) as save_dir:
        cfg = bench_config(tdir, args.batch, args.epochs, save_dir, tiny=args.tiny)
        for name in VARIANTS:
            vcfg, env, packed = variant_setup(name, cfg, packed_dir)
            report[name] = run_variant(name, vcfg, args.epochs, env, packed, device)
    for name in VARIANTS:
        r = report[name]
        print(f"{name}: img/s per epoch {[round(x, 2) for x in r['epochs_img_per_s']]}, "
              f"steady {r['steady_img_per_s']:.2f} img/s, "
              f"{min(r['step_ms']):.3f} ms a step at best")
    out = args.out or os.path.join(args.data, "train_io_bench.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"report: {out}")


if __name__ == "__main__":
    main()
