"""Training CLI (``cli/train.py``'s counterpart).

    python -m sunet_tf_tpu_torch.train --config training.yaml \
        [--task mask|denoise] [--sigma 50] [--epochs N] [--steps-per-epoch N] \
        [--train-dir D] [--val-dir D] [--save-dir D] [--device cuda|cpu] \
        [--backend fused|eager]

Reads a reference-schema training.yaml (defaults when the file is missing),
builds the Trainer on --device (the card unless asked for the CPU) and runs
the fit loop. Returns the fit summary from ``main``.
"""

from __future__ import annotations

import argparse
import os

from sunet_tf_tpu_torch.config import Config, load_config
from sunet_tf_tpu_torch.models.sunet import param_count
from sunet_tf_tpu_torch.train.trainer import Trainer


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train SUNet (PyTorch/CUDA)")
    p.add_argument("--config", default="training.yaml")
    p.add_argument("--task", default=None, choices=[None, "mask", "denoise"],
                   help="default: mask if OUT_CHANS==1 else denoise")
    p.add_argument("--sigma", type=float, default=50.0,
                   help="AWGN sigma (0-255 scale) for the denoise task")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--train-dir", default=None)
    p.add_argument("--val-dir", default=None)
    p.add_argument("--save-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default="fused", choices=["fused", "eager"])
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = load_config(args.config) if os.path.exists(args.config) else Config()
    tr = dict(cfg.training.__dict__)
    for key, val in (("train_dir", args.train_dir), ("val_dir", args.val_dir),
                     ("save_dir", args.save_dir), ("steps_per_epoch", args.steps_per_epoch)):
        if val:
            tr[key] = val
    if args.resume:
        tr["resume"] = True
    op = dict(cfg.optim.__dict__)
    if args.epochs:
        op["epochs"] = args.epochs
    cfg = cfg.replace(training=cfg.training.__class__(**tr), optim=cfg.optim.__class__(**op))

    print("==> Build the model")
    trainer = Trainer(cfg, task=args.task, sigma=args.sigma, device=args.device,
                      backend=args.backend)
    print(f"""==> Training details:
------------------------------------------------------------------
    Mode / task:        {cfg.mode} / {trainer.task}
    Device / backend:   {trainer.device} / {args.backend}
    Train patch size:   {cfg.training.train_ps}
    Model parameters:   {param_count(trainer.model)}
    Start/End epochs:   {trainer.start_epoch}~{cfg.optim.epochs}
    Batch size:         {cfg.optim.batch}
    Learning rate:      {cfg.optim.lr_initial}
------------------------------------------------------------------""")
    return trainer.fit()


if __name__ == "__main__":
    main()
