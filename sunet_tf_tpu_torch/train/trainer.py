"""Training orchestration (``sunet_tf_tpu/train/trainer.py``).

Per epoch, as the reference train.py:305-739: a training pass, validation
(and an optional test split) every VAL_AFTER_EVERY epochs with loss, MSE,
weighted MSE and AUROC/AUPRC (mask task) or PSNR/SSIM (denoise task), CSV
(+ TensorBoard and plots when installed), a 'latest' checkpoint each epoch,
best-by-metric checkpoints, the closed-form LR schedule, and resume. The
model runs on ``device`` (the card unless the caller asks for the CPU);
metrics accumulate on the device and reach the host once per epoch.

In a process group (``parallel/``, e.g. under torchrun) the trainer lays
the ranks out as JAX's trainer lays out devices: spatial size
``TPU.SPATIAL``, data size ``TPU.DATA_PARALLEL`` or else the largest
divisor of ``OPTIM.BATCH`` up to world size / spatial. Every rank builds the
same seeded model, iterates the same global batches (the same shuffle, the
trailing batch padded to a multiple of the data size, pad rows masked by
"valid") and the step keeps its rows; with ``TPU.SPATIAL > 1`` the Swin
stages the spatial runner takes run per H shard on the block kernels. Rank
0 alone writes checkpoints, the CSV, TensorBoard and plots, and prints;
resume reads on every rank.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from sunet_tf_tpu_torch.ckpt import BestTracker, latest_path, restore_checkpoint, save_checkpoint
from sunet_tf_tpu_torch.config import Config
from sunet_tf_tpu_torch.data.pipeline import PairDataset, Prefetcher, batch_iterator
from sunet_tf_tpu_torch.models.sunet import build_model, resolve_device
from sunet_tf_tpu_torch.obs import MetricsLogger
from sunet_tf_tpu_torch.ops.metrics import (auprc_from_histograms, auroc_from_histograms,
                                            pr_curve_from_histograms,
                                            roc_curve_from_histograms)
from sunet_tf_tpu_torch.parallel.mesh import make_mesh
from sunet_tf_tpu_torch.train.adam import AdamLP
from sunet_tf_tpu_torch.train.loop import build_steps, to_device
from sunet_tf_tpu_torch.train.schedule import lr_for_step


def assert_finite_loss(loss: float, epoch: int) -> None:
    """A non-finite training loss fails the run instead of writing a
    corrupt checkpoint."""
    if not np.isfinite(loss):
        raise FloatingPointError(f"non-finite training loss ({loss}) at epoch {epoch}")


def make_optimizer(cfg: Config, model, steps_per_epoch: int) -> AdamLP:
    """Adam(beta1, beta2, eps) under the reference LR schedule, moments
    stored as cfg.opt_mu_dtype / cfg.opt_nu_dtype."""
    o = cfg.optim
    return AdamLP(
        model.parameters(),
        lambda count: lr_for_step(count, steps_per_epoch, o.lr_initial, o.lr_min,
                                  o.epochs, o.warmup_epochs),
        b1=o.beta1, b2=o.beta2, eps=o.eps, mu_dtype=cfg.opt_mu_dtype,
        nu_dtype="float32" if cfg.opt_nu_dtype == "float32" else "bfloat16",
        stochastic_round_nu=cfg.opt_nu_dtype == "bfloat16_sr", sr_seed=cfg.training.seed)


class _Quiet:
    """The logger of a rank other than 0: keeps nothing, writes nothing."""

    def __getattr__(self, name):
        return lambda *a, **k: None


def mesh_for(cfg: Config, world: int) -> tuple:
    """JAX's layout (``trainer.py``): (data, spatial) with spatial =
    TPU.SPATIAL and data = TPU.DATA_PARALLEL or the largest divisor of
    OPTIM.BATCH up to world // spatial."""
    sp = max(1, cfg.spatial)
    d = cfg.data_parallel or max(1, world // sp)
    while cfg.optim.batch % d:
        d -= 1
    return d, sp


class Trainer:
    def __init__(self, cfg: Config, task: Optional[str] = None, sigma: float = 50.0,
                 device="cuda", backend: str = "fused", verbose: bool = True, mesh=None):
        """``mesh``: a ``parallel.mesh.Mesh``; by default, in a process group
        the mesh ``mesh_for`` gives over it, else none (one process)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        if mesh is None and (dist.is_initialized() or cfg.spatial > 1):
            world = dist.get_world_size() if dist.is_initialized() else 1
            mesh = make_mesh(*mesh_for(cfg, world))
        self.mesh = mesh
        self.is_main = mesh is None or mesh.rank == 0
        verbose = verbose and self.is_main
        self.task = task or ("mask" if cfg.swinunet.out_chans == 1 else "denoise")
        self.sigma = sigma
        self.verbose = verbose
        sw = cfg.swinunet
        if self.task == "mask" and sw.out_chans != 1:
            raise ValueError(f"task 'mask' requires OUT_CHANS=1, got {sw.out_chans}")
        if self.task == "denoise" and sw.out_chans != sw.in_chans:
            raise ValueError(f"task 'denoise' requires OUT_CHANS==IN_CHANS "
                             f"({sw.in_chans}), got {sw.out_chans}")
        tr = cfg.training
        self.model = build_model(cfg, device=self.device, backend=backend,
                                 seed=tr.seed).train().requires_grad_(True)
        self.train_ds = (PairDataset(tr.train_dir, tr.train_ps, train=True, seed=tr.seed)
                         if tr.train_dir else None)
        self.val_ds = PairDataset(tr.val_dir, tr.val_ps, train=False) if tr.val_dir else None
        self.test_ds = (PairDataset(tr.test_dir, tr.val_ps, train=False)
                        if tr.test_dir and os.path.isdir(tr.test_dir) else None)
        n_train = len(self.train_ds) if self.train_ds else 1
        # what train_epoch runs: floor when the set exceeds one batch, else
        # one (partial) batch
        self.steps_per_epoch = tr.steps_per_epoch or max(1, n_train // cfg.optim.batch)
        self.optimizer = make_optimizer(cfg, self.model, self.steps_per_epoch)
        self.stage_runner = None
        if mesh is not None and mesh.shape["spatial"] > 1 and backend == "fused":
            from sunet_tf_tpu_torch.parallel.spatial import SpatialStageRunner

            self.stage_runner = SpatialStageRunner(
                mesh, dropout=sw.drop_rate > 0 or sw.attn_drop_rate > 0)
        self.fns = build_steps(self.model, self.optimizer, task=self.task, sigma=sigma,
                               seed=tr.seed, mesh=mesh, stage_runner=self.stage_runner)
        self.model_dir = os.path.join(tr.save_dir, cfg.mode, "models")
        self.best = BestTracker(self.model_dir,
                                ("auroc", "auprc") if self.task == "mask" else ("psnr", "ssim"))
        if self.is_main:
            self.logger = MetricsLogger(os.path.join(tr.save_dir, cfg.mode, "log"))
        else:
            self.logger = _Quiet()
            self.best.update = lambda *a, **k: False
        self.start_epoch = 1
        if tr.resume:
            self._resume()

    def _resume(self):
        p = latest_path(self.model_dir)
        if p is None:
            if self.verbose:
                print("==> RESUME requested but no latest checkpoint found")
            return
        restored = restore_checkpoint(p, self.model, self.optimizer)
        self.start_epoch = restored["epoch"] + 1
        self.best.load_state(restored["meta"].get("best"))
        if self.verbose:
            print(f"==> Resumed from {p} at epoch {self.start_epoch}")

    def _batches(self, it):
        return Prefetcher(it, put=lambda b: to_device(b, self.device))

    def train_epoch(self, epoch: int) -> dict:
        if self.train_ds is None:
            raise ValueError("no TRAIN_DIR configured")
        cfg = self.cfg
        it = batch_iterator(self.train_ds, cfg.optim.batch, shuffle=True,
                            drop_last=len(self.train_ds) > cfg.optim.batch,
                            seed=cfg.training.seed + epoch, pad_to=self._data_size())
        acc: dict = {}
        n = 0
        hists = self.fns.init_metrics()
        for batch, _names in self._batches(it):
            scalars, hists = self.fns.train_step(
                batch, (epoch - 1) * self.steps_per_epoch + n, hists)
            for k, v in scalars.items():
                acc.setdefault(k, []).append(v)
            n += 1
            if cfg.training.steps_per_epoch and n >= self.steps_per_epoch:
                break
        out = {k: float(torch.stack(v).mean()) for k, v in acc.items()}
        if "loss" in out:
            assert_finite_loss(out["loss"], epoch)
        out["steps"] = n
        if self.task == "mask" and hists:
            out["auroc"] = auroc_from_histograms(hists)
            out["auprc"] = auprc_from_histograms(hists)
            out["_hists"] = hists
        return out

    def _data_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape["data"]

    def eval_epoch(self, ds: PairDataset, batch_size: int = 0) -> dict:
        """Exact per-sample means over ``ds`` at any batch size; with a mesh
        the batches are padded to a multiple of the data size (pad rows
        masked by "valid") and each rank evaluates its rows."""
        d = self._data_size()
        batch_size = batch_size or max(d, min(self.cfg.optim.batch, len(ds)))
        hists = self.fns.init_metrics()
        sums: dict = {}
        for batch, _names in self._batches(batch_iterator(ds, batch_size, shuffle=False,
                                                          pad_to=d)):
            s, hists = self.fns.eval_step(batch, hists)
            for k, v in s.items():
                sums[k] = sums.get(k, 0.0) + float(v)
        n = max(sums.pop("n", 0.0), 1e-12)
        out = {k: v / n for k, v in sums.items()}
        if self.task == "mask" and hists:
            out["auroc"] = auroc_from_histograms(hists)
            out["auprc"] = auprc_from_histograms(hists)
            out["_hists"] = hists
        return out

    def _plot_curves(self, split: str, epoch: int, hists, scalars) -> None:
        if hists is None or np.isnan(scalars.get("auroc", np.nan)):
            return
        fpr, tpr = roc_curve_from_histograms(hists)
        rec, prec = pr_curve_from_histograms(hists)
        self.logger.plot_roc_pr(split, epoch, fpr, tpr, rec, prec, scalars["auroc"],
                                scalars["auprc"])

    def fit(self) -> dict:
        cfg = self.cfg
        val_after = max(1, cfg.training.val_after_every)
        t_start = time.time()
        for epoch in range(self.start_epoch, cfg.optim.epochs + 1):
            t0 = time.time()
            tr = self.train_epoch(epoch)
            tr_hists = tr.pop("_hists", None)
            self.logger.log_dict("train", {k: v for k, v in tr.items() if k != "steps"}, epoch)
            self._plot_curves("train", epoch, tr_hists, tr)
            if epoch % val_after == 0 and self.val_ds is not None:
                va = self.eval_epoch(self.val_ds)
                self._plot_curves("val", epoch, va.pop("_hists", None), va)
                self.logger.log_dict("val", va, epoch)
                for m in self.best.best:
                    if m in va:
                        self.best.update(m, va[m], epoch, self.model)
                if self.test_ds is not None:
                    te = self.eval_epoch(self.test_ds)
                    self._plot_curves("test", epoch, te.pop("_hists", None), te)
                    self.logger.log_dict("test", te, epoch)
            self.logger.plot_overlays(epoch)
            if self.is_main:
                save_checkpoint(self.model_dir, "latest", self.model, self.optimizer,
                                epoch=epoch, extra={"best": self.best.state()})
            if self.verbose:
                msg = "  ".join(f"{k}={v:.6f}" for k, v in tr.items() if k != "steps")
                print(f"Epoch {epoch}\ttime {time.time() - t0:.1f}s\t{msg}")
        self.logger.write_csv()
        self.logger.close()
        summary = {"best": self.best.summary(), "total_time_s": time.time() - t_start}
        if self.verbose:
            print("==> Best:", summary["best"])
        return summary
