"""Checkpoints with ``torch.save`` (``sunet_tf_tpu/ckpt.py``).

Layout: <save_dir>/<mode>/models/{latest,best_<metric>}.pth, each a dict
{"epoch", "state_dict", "optimizer"?, "meta"}. ``state_dict`` carries the
parameters under the reference keys (``swin_unet.`` prefix, torch layouts),
so ``weights.load_reference_checkpoint`` reads a saved model, and the
reference's own loaders do too. Writes go to a temporary file first, then
replace the target.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from sunet_tf_tpu_torch.weights import PREFIX, load_reference_state_dict


def save_checkpoint(directory: str, name: str, model: torch.nn.Module,
                    optimizer=None, epoch: int = 0,
                    extra: Optional[dict] = None) -> str:
    """Save ``model`` (and the optimizer's state) as <directory>/<name>.pth;
    returns the path."""
    os.makedirs(directory, exist_ok=True)
    payload = {
        "epoch": int(epoch),
        "state_dict": {PREFIX + k: v.detach().cpu()
                       for k, v in model.state_dict().items()},
        "meta": dict(extra or {}),
    }
    if optimizer is not None:
        payload["optimizer"] = {k: ([t.detach().cpu() for t in v] if isinstance(v, list) else v)
                                for k, v in optimizer.state_dict().items()}
    path = os.path.join(directory, f"{name}.pth")
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, model: torch.nn.Module, optimizer=None) -> dict:
    """Load a checkpoint into ``model`` (and ``optimizer`` when given and
    saved); returns {"epoch", "meta"}."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    with torch.no_grad():
        load_reference_state_dict(model, payload)
    if optimizer is not None and "optimizer" in payload:
        optimizer.load_state_dict(payload["optimizer"])
    return {"epoch": int(payload["epoch"]), "meta": payload.get("meta", {})}


def latest_path(directory: str) -> Optional[str]:
    p = os.path.join(directory, "latest.pth")
    return p if os.path.isfile(p) else None


class BestTracker:
    """Best value per metric; each new best saves best_<metric>.pth."""

    def __init__(self, directory: str, metrics: tuple, mode: str = "max"):
        self.directory = directory
        self.best = {m: (-np.inf if mode == "max" else np.inf) for m in metrics}
        self.best_epoch = {m: None for m in metrics}
        self.mode = mode

    def update(self, metric: str, value: float, epoch: int, model) -> bool:
        if metric not in self.best or value is None or np.isnan(value):
            return False
        better = value > self.best[metric] if self.mode == "max" else value < self.best[metric]
        if better:
            self.best[metric] = float(value)
            self.best_epoch[metric] = epoch
            save_checkpoint(self.directory, f"best_{metric}", model, epoch=epoch)
        return better

    def summary(self) -> dict:
        return {m: {"value": self.best[m], "epoch": self.best_epoch[m]} for m in self.best}

    def state(self) -> dict:
        """JSON-safe snapshot (None = never updated)."""
        return {m: {"value": float(self.best[m]) if np.isfinite(self.best[m]) else None,
                    "epoch": self.best_epoch[m]}
                for m in self.best}

    def load_state(self, state: Optional[dict]) -> None:
        for m, s in (state or {}).items():
            if m in self.best and s.get("value") is not None:
                self.best[m] = float(s["value"])
                self.best_epoch[m] = s.get("epoch")
