"""Scalar logging (CSV, console, optional TensorBoard) and ROC/PR/overlay
plots (``sunet_tf_tpu/obs.py``'s MetricsLogger), the attention-logit
extrema of a model (``attention_logit_stats``) and a profiler trace
(``profile_trace``).

The reference's sinks: tensorboardX scalars per split, per-epoch ROC/PR
curve PNGs, cumulative overlay dashboards (high-is-good and low-is-good
panels, train.py:375-416,479-531,589-712) and an end-of-run
metrics_per_epoch.csv (train.py:766-810). matplotlib and tensorboardX are
optional: without them the logger writes the CSV and the trainer prints to
the console.
"""

from __future__ import annotations

import csv
import os
from collections import defaultdict
from typing import Optional


class MetricsLogger:
    def __init__(self, log_dir: str, enable_tb: bool = True,
                 enable_plots: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.history: dict = defaultdict(dict)  # {(split, metric): {epoch: v}}
        self.writer = None
        if enable_tb:
            try:
                from tensorboardX import SummaryWriter

                self.writer = SummaryWriter(log_dir=log_dir)
            except Exception:
                self.writer = None
        self.enable_plots = enable_plots
        self.plots_root = os.path.join(log_dir, "plots")
        if enable_plots:
            os.makedirs(self.plots_root, exist_ok=True)

    def log(self, split: str, metric: str, value: float, epoch: int) -> None:
        self.history[(split, metric)][epoch] = float(value)
        if self.writer is not None:
            self.writer.add_scalar(f"{split}/{metric}", float(value), epoch)

    def log_dict(self, split: str, scalars: dict, epoch: int) -> None:
        for k, v in scalars.items():
            self.log(split, k, v, epoch)

    # ------------------------------------------------------------------
    # plots
    # ------------------------------------------------------------------

    def _plt(self):
        if not self.enable_plots:
            return None
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            return plt
        except Exception:
            return None

    def plot_roc_pr(self, split: str, epoch: int, fpr, tpr, recall, precision,
                    auroc: float, auprc: float) -> None:
        plt = self._plt()
        if plt is None:
            return
        for sub, (x, y, label, xl, yl) in {
            "roc": (fpr, tpr, f"AUROC={auroc:.4f}", "FPR", "TPR"),
            "pr": (recall, precision, f"AP={auprc:.4f}", "Recall", "Precision"),
        }.items():
            d = os.path.join(self.plots_root, sub, split)
            os.makedirs(d, exist_ok=True)
            fig = plt.figure(figsize=(6, 6))
            plt.plot(x, y, label=label)
            if sub == "roc":
                plt.plot([0, 1], [0, 1], "--", linewidth=1, color="gray")
            plt.xlabel(xl)
            plt.ylabel(yl)
            plt.title(f"{split} {sub.upper()} (epoch {epoch})")
            plt.legend()
            plt.grid(True)
            plt.tight_layout()
            fig.savefig(os.path.join(d, f"{sub}_{split}_epoch_{epoch:03d}.png"))
            plt.close(fig)

    # The reference renders four cumulative overlay chart sets per epoch —
    # train, val, train+val, train+val+test — each split into a
    # high-is-good and a low-is-good panel (reference train.py:592-712).
    OVERLAY_SETS = (
        ("train", ("train",)),
        ("val", ("val",)),
        ("train_val", ("train", "val")),
        ("train_val_test", ("train", "val", "test")),
    )

    def plot_overlays(self, epoch: int) -> None:
        """High-is-good (AUROC/AUPRC/PSNR) and low-is-good (loss/MSE) panels,
        cumulative up to this epoch, for each of the reference's four
        split combinations."""
        plt = self._plt()
        if plt is None:
            return
        groups = {
            "high": ("auroc", "auprc", "psnr", "ssim"),
            "low": ("loss", "mse", "mse_w"),
        }
        colors = {"train": "tab:blue", "val": "tab:red", "test": "tab:green"}
        for set_name, splits in self.OVERLAY_SETS:
            d = os.path.join(self.plots_root, "overlay", set_name)
            wrote_any = False
            for gname, metrics in groups.items():
                series = [(s, m, h) for (s, m), h in self.history.items()
                          if m in metrics and s in splits and h]
                if not series:
                    continue
                os.makedirs(d, exist_ok=True)
                wrote_any = True
                fig = plt.figure(figsize=(12, 7))
                for split, metric, h in sorted(series):
                    xs = sorted(h)
                    plt.plot(xs, [h[x] for x in xs], marker="o",
                             color=colors.get(split, "black"),
                             linestyle={"auroc": "-", "psnr": "-", "loss": "-",
                                        "auprc": "--", "ssim": "--", "mse": "-.",
                                        "mse_w": ":"}.get(metric, "-"),
                             label=f"{split} {metric}")
                plt.xlabel("Epoch")
                plt.ylabel("higher is better" if gname == "high"
                           else "lower is better")
                plt.title(f"{set_name} {gname}-metrics overlay "
                          f"(up to epoch {epoch})")
                plt.grid(True)
                plt.legend(loc="best")
                plt.tight_layout()
                fig.savefig(os.path.join(
                    d, f"{gname}_metrics_up_to_epoch_{epoch:03d}.png"))
                plt.close(fig)

    # ------------------------------------------------------------------
    # CSV
    # ------------------------------------------------------------------

    def write_csv(self, path: Optional[str] = None) -> str:
        """metrics_per_epoch.csv with Split_Metric columns (reference
        train.py:766-810 format)."""
        path = path or os.path.join(self.log_dir, "metrics_per_epoch.csv")
        epochs = sorted({e for h in self.history.values() for e in h})
        cols = sorted(self.history.keys())
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["Epoch"] + [f"{s.capitalize()}_{m.upper()}" for s, m in cols])
            for e in epochs:
                w.writerow([e] + [
                    f"{self.history[c][e]:.6f}" if e in self.history[c] else ""
                    for c in cols
                ])
        return path

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


def attention_logit_stats(model, x) -> dict:
    """Global max and min of the attention logits over every W-MSA of
    ``model`` for the input batch ``x`` (B, H, W, in_chans), taken after the
    rel-pos bias and before the SW mask, as JAX's ``attention_logit_stats``
    takes them: the eager route in float32 on ``model``'s weights
    (``models.sunet.route_copy``), through ``layers.LOGIT_STATS``.

    Purpose: to read on trained weights how far the logits reach: the
    recipe's constant QK_SCALE=8 lets them grow (JAX's "shift" softmax is
    exact only for logits in (-47, 80]; the port's row-max form keeps no
    such band, and its rows turn near one-hot as the logits grow)."""
    import torch

    from sunet_tf_tpu_torch.kernels.window_attention import exact_fp32
    from sunet_tf_tpu_torch.models import layers
    from sunet_tf_tpu_torch.models.sunet import route_copy

    eager = route_copy(model, dtype=torch.float32, backend="eager")
    x = torch.as_tensor(x, device=next(eager.parameters()).device)
    stats = layers.LOGIT_STATS
    stats.enabled, stats.hi, stats.lo = True, None, None
    try:
        with torch.no_grad(), exact_fp32():
            eager(x.float())
        return {"logit_max": float(stats.hi), "logit_min": float(stats.lo)}
    finally:
        stats.enabled, stats.hi, stats.lo = False, None, None


class profile_trace:
    """Context manager around ``torch.profiler.profile`` (CPU, and CUDA
    where a card is present) that writes a Chrome trace,
    ``<log_dir>/trace.json``, on exit (JAX's ``profile_trace`` writes an
    XProf trace). Usage:

        with profile_trace(log_dir) as p:
            step(...)  # traced region
        p.prof.key_averages()
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.prof = None

    def __enter__(self):
        import torch

        os.makedirs(self.log_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        self.prof.export_chrome_trace(os.path.join(self.log_dir, "trace.json"))
        return False
