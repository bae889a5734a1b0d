"""Print the learning rate of each epoch under the reference recipe (the
counterpart of ``cli/lr_schedule.py``; the reference's warmup_scheduler/run.py
demo), from ``train/schedule.py``.

    python -m sunet_tf_tpu_torch.lr_schedule [--epochs 20] [--lr 2e-4] [--lr-min 1e-6] \
        [--warmup 3]
"""

from __future__ import annotations

import argparse

from sunet_tf_tpu_torch.train.schedule import reference_lr_schedule


def main(argv=None):
    p = argparse.ArgumentParser(description="LR schedule demo")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--lr-min", type=float, default=1e-6)
    p.add_argument("--warmup", type=int, default=3)
    args = p.parse_args(argv)
    print(f"{'epoch':>6}  {'lr':>12}")
    for e in range(1, args.epochs + 1):
        lr = reference_lr_schedule(e, args.lr, args.lr_min, args.epochs, args.warmup)
        print(f"{e:>6}  {lr:>12.8f}")


if __name__ == "__main__":
    main()
