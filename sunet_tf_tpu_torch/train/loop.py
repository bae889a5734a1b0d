"""Training and evaluation steps (``sunet_tf_tpu/train/loop.py``).

Tasks (the reference's two workloads):

- ``denoise``: input = clean + AWGN(sigma) drawn on the device; target =
  clean RGB; unweighted Charbonnier; PSNR tracked.
- ``mask``: input as loaded; target = Rec.601 gray of the target image;
  boundary-ring-weighted Charbonnier on the raw logits (reference
  train.py:328-344); MSE, weighted MSE and streaming AUROC/AUPRC
  histograms tracked.

Batches arrive as uint8 NHWC; normalisation to [0, 1], the dihedral
augmentation, the noise and the boundary weights run on the device. The
randomness of step k (augmentation ops, noise, stochastic depth) comes from
generators seeded with (seed, k), so a resumed run draws what an unbroken
one would. The mesh, shard_map and spatial branches of the JAX loop are the
``parallel/`` slice's work.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from sunet_tf_tpu_torch.ops.image import (add_awgn, dihedral_batch, psnr,
                                          psnr_per_sample, rgb_to_gray,
                                          ssim_per_sample)
from sunet_tf_tpu_torch.ops.metrics import (DEFAULT_BINS, init_histograms,
                                            update_histograms)
from sunet_tf_tpu_torch.ops.morphology import boundary_ring_weights
from sunet_tf_tpu_torch.train.losses import (charbonnier_loss,
                                             charbonnier_per_sample, mse_loss,
                                             mse_per_sample)

TASKS = ("denoise", "mask")


@dataclasses.dataclass
class TrainStepFns:
    train_step: Callable
    eval_step: Callable
    init_metrics: Callable


def step_generators(seed: int, step: int, device) -> tuple:
    """(data generator, model generator) of training step ``step``."""
    base = (int(seed) * 1_000_003 + int(step)) * 2
    mk = lambda s: torch.Generator(device=device).manual_seed(s)
    return mk(base), mk(base + 1)


def to_device(batch: dict, device) -> dict:
    """numpy uint8 batch -> device tensors (``names`` left as they are)."""
    return {k: (torch.as_tensor(v).to(device, non_blocking=True) if k != "names" else v)
            for k, v in batch.items()}


def prepare(batch: dict, task: str, sigma: float, generator: torch.Generator) -> tuple:
    """uint8 batch -> float (input, target) on the device: dihedral
    augmentation on the uint8 arrays, /255, AWGN (denoise) or the gray mask
    target (mask)."""
    inp, tar = batch["input"], batch["target"]
    ops = torch.randint(0, 9, (inp.shape[0],), generator=generator, device=generator.device)
    inp, tar = dihedral_batch(inp, ops), dihedral_batch(tar, ops)
    inp = inp.float() / 255.0
    tar = tar.float() / 255.0
    if task == "denoise":
        inp = add_awgn(generator, tar, sigma).clamp(0.0, 1.0)
    elif tar.shape[-1] == 3:
        tar = rgb_to_gray(tar)
    return inp, tar


def loss_and_metrics(model, inp, tar, generator, valid, task: str) -> tuple:
    """(loss, logits, weights) of the training forward; ``valid`` (B,) 0/1
    masks padded samples out of the loss under the sum(l*w)/sum(w)
    normalisation. As in the JAX step, the denoise weight is the (B, 1, 1,
    1) mask itself, so that loss is the per-image sum of the pixel losses
    over the valid images, not their mean (ROADMAP: JAX-package
    questions)."""
    logits = model(inp, generator=generator)
    v4 = valid.reshape(-1, 1, 1, 1)
    if task == "denoise":
        return charbonnier_loss(logits, tar, v4), logits, None
    weights = boundary_ring_weights(tar)
    return charbonnier_loss(logits, tar, weights * v4), logits, weights


def train_scalars(task: str, logits, tar, weights, valid) -> dict:
    """The logged MSE scalars of a training step, weighted as the JAX step
    weighs them: by the (B, 1, 1, 1) valid mask (and the boundary weights
    for ``mse_w``)."""
    v4 = valid.reshape(-1, 1, 1, 1)
    scalars = {"mse": mse_loss(logits, tar, v4)}
    if task == "mask":
        scalars["mse_w"] = mse_loss(logits, tar, weights * v4)
    return scalars


def build_steps(model, optimizer, task: str = "denoise", sigma: float = 50.0,
                seed: int = 0) -> TrainStepFns:
    """The step functions over ``model`` (parameters requiring grad) and
    ``optimizer`` (train/adam.py). ``train_step(batch, step, hists)`` ->
    (scalars, hists); ``eval_step(batch, hists)`` -> (per-sample sums with
    the valid count "n", hists). Scalars stay on the device."""
    if task not in TASKS:
        raise ValueError(f"task {task!r} not in {TASKS}")
    device = next(model.parameters()).device

    def valid_of(batch, n):
        v = batch.get("valid")
        return torch.ones(n, device=device) if v is None else v.float()

    def train_step(batch, step: int, hists):
        g_data, g_model = step_generators(seed, step, device)
        inp, tar = prepare(batch, task, sigma, g_data)
        v = valid_of(batch, inp.shape[0])
        loss, logits, weights = loss_and_metrics(model, inp, tar, g_model, v, task)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        logits = logits.detach()
        scalars = {"loss": loss.detach(), **train_scalars(task, logits, tar, weights, v)}
        if task == "denoise":
            scalars["psnr"] = psnr(tar, logits.clamp(0.0, 1.0))
        else:
            hists = update_histograms(hists, torch.sigmoid(logits), (tar > 0.5).float(),
                                      sample_weight=v)
        return scalars, hists

    def init_metrics():
        return init_histograms(DEFAULT_BINS, device) if task == "mask" else {}

    @torch.no_grad()
    def eval_step(batch, hists):
        inp = batch["input"].float() / 255.0
        tar = batch["target"].float() / 255.0
        v = valid_of(batch, inp.shape[0])
        if task == "denoise":
            logits = model(inp)
            pred = logits.clamp(0.0, 1.0)
            tg = rgb_to_gray(tar) if tar.shape[-1] == 3 else tar
            pg = rgb_to_gray(pred) if pred.shape[-1] == 3 else pred
            return {"loss": (charbonnier_per_sample(logits, tar) * v).sum(),
                    "mse": (mse_per_sample(logits, tar) * v).sum(),
                    "psnr": (psnr_per_sample(tar, pred) * v).sum(),
                    "ssim": (ssim_per_sample(tg, pg) * v).sum(),
                    "n": v.sum()}, hists
        if tar.shape[-1] == 3:
            tar = rgb_to_gray(tar)
        logits = model(inp)
        weights = boundary_ring_weights(tar)
        sums = {"loss": (charbonnier_per_sample(logits, tar, weights) * v).sum(),
                "mse": (mse_per_sample(logits, tar) * v).sum(),
                "mse_w": (mse_per_sample(logits, tar, weights) * v).sum(),
                "n": v.sum()}
        hists = update_histograms(hists, torch.sigmoid(logits), (tar > 0.5).float(),
                                  sample_weight=v)
        return sums, hists

    return TrainStepFns(train_step=train_step, eval_step=eval_step,
                        init_metrics=init_metrics)
