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
one would.

With a mesh (``parallel/mesh.py``; JAX's ``mesh`` and ``shard_map``
branches), every rank gets the global batch and draws the augmentation and
the noise for all of it, so ``prepare`` gives each rank its rows of the
one-process step; the model runs on the rank's rows (and, with a spatial
stage runner, the Swin stages it takes on the rank's share of their rows).
The loss is the global one, sum(l*w) / sum(w) over the global batch: the
weights' sum is all-reduced over the data group first, and each rank's
sum(l*w) divided by it, so that the sum of the ranks' gradients over the
data group is the global gradient (a mean of per-rank losses would weigh
the ranks alike whatever their valid rows). The spatial runner's Swin
weights first get their per-shard gradients summed over the spatial group
(and the replicated layers' gradients, whole on every rank, averaged over
it, so that the replicas' bits stay equal). Stochastic depth draws from the
step's model generator at data size 1 (as one process) and, above, from one
with the rank's data coordinate folded in (JAX ``fold_in(key,
axis_index('data'))``): the ranks of one data coordinate draw alike. Logged
scalars, evaluation sums and histograms are the global ones.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

from sunet_tf_tpu_torch.kernels.window_attention import exact_fp32
from sunet_tf_tpu_torch.ops.image import (add_awgn, dihedral_batch, psnr,
                                          psnr_per_sample, rgb_to_gray,
                                          ssim_per_sample)
from sunet_tf_tpu_torch.ops.metrics import (DEFAULT_BINS, init_histograms,
                                            update_histograms)
from sunet_tf_tpu_torch.ops.morphology import boundary_ring_weights
from sunet_tf_tpu_torch.parallel import comm
from sunet_tf_tpu_torch.parallel.mesh import data_rows
from sunet_tf_tpu_torch.train.losses import (charbonnier, charbonnier_loss,
                                             charbonnier_per_sample, mse_loss,
                                             mse_per_sample, squared_error)

TASKS = ("denoise", "mask")
# Elements of one all-reduce of the gradients (64 MB of float32).
GRAD_BUCKET = 1 << 24


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


def model_generator(seed: int, step: int, device, data_index: int = 0,
                    data_size: int = 1) -> torch.Generator:
    """The stochastic-depth generator of step ``step`` on a rank at data
    coordinate ``data_index``: ``step_generators``' second one at data size
    1, else one with the coordinate folded into its seed."""
    g = step_generators(seed, step, device)[1]
    if data_size == 1:
        return g
    return torch.Generator(device=device).manual_seed(
        (g.initial_seed() * 1_000_003 + data_index + 1) % (1 << 63))


def to_device(batch: dict, device) -> dict:
    """numpy uint8 batch -> device tensors (``names`` left as they are)."""
    return {k: (torch.as_tensor(v).to(device, non_blocking=True) if k != "names" else v)
            for k, v in batch.items()}


def prepare(batch: dict, task: str, sigma: float, generator: torch.Generator,
            augment: bool = True) -> tuple:
    """uint8 batch -> float (input, target) on the device: dihedral
    augmentation on the uint8 arrays (unless ``augment`` is off, JAX's
    ``build_steps(augment=False)``), /255, AWGN (denoise) or the gray mask
    target (mask)."""
    inp, tar = batch["input"], batch["target"]
    if augment:
        ops = torch.randint(0, 9, (inp.shape[0],), generator=generator, device=generator.device)
        inp, tar = dihedral_batch(inp, ops), dihedral_batch(tar, ops)
    inp = inp.float() / 255.0
    tar = tar.float() / 255.0
    if task == "denoise":
        inp = add_awgn(generator, tar, sigma).clamp(0.0, 1.0)
    elif tar.shape[-1] == 3:
        tar = rgb_to_gray(tar)
    return inp, tar


def global_weighted_mean(mesh, l: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """This rank's share of the global sum(l*w) / max(sum(w), 1e-8) of the
    losses' ``_reduce``: its sum(l*w) over the sum of ``weight`` all-reduced
    over the data group (without a gradient), so that the ranks' shares sum
    to the global mean and so do their gradients. The one-process mesh
    (and a data size of 1) gives ``_reduce``'s bits."""
    w = weight.float()
    den = comm.all_reduce_sum(mesh, mesh.data_group, w.sum().detach())
    return (l * w).sum() / den.clamp_min(1e-8)


def loss_and_metrics(model, inp, tar, generator, valid, task: str, mesh=None,
                     stage_runner=None, weights=None) -> tuple:
    """(loss, logits, weights) of the training forward; ``valid`` (B,) 0/1
    masks padded samples out of the loss under the sum(l*w)/sum(w)
    normalisation. As in the JAX step, the denoise weight is the (B, 1, 1,
    1) mask itself, so that loss is the per-image sum of the pixel losses
    over the valid images, not their mean (ROADMAP: JAX-package
    questions). With ``mesh``, the rank's share of the global loss
    (:func:`global_weighted_mean`) of its rows, and ``weights`` its rows of
    the boundary weights of the global batch (normalised to the global
    batch's mean, as JAX's step normalises them); ``stage_runner``: the
    spatial tier's (``SUNet.forward``)."""
    logits = (model(inp, generator=generator) if stage_runner is None
              else model(inp, generator=generator, stage_runner=stage_runner))
    v4 = valid.reshape(-1, 1, 1, 1)
    if task == "mask" and weights is None:
        weights = boundary_ring_weights(tar)
    w = v4 if weights is None else weights * v4
    if mesh is None:
        return charbonnier_loss(logits, tar, w), logits, weights
    return global_weighted_mean(mesh, charbonnier(logits, tar), w), logits, weights


def train_scalars(task: str, logits, tar, weights, valid, mesh=None) -> dict:
    """The logged MSE scalars of a training step, weighted as the JAX step
    weighs them: by the (B, 1, 1, 1) valid mask (and the boundary weights
    for ``mse_w``). With ``mesh``, each rank's share of the global value."""
    v4 = valid.reshape(-1, 1, 1, 1)
    if mesh is None:
        mse = lambda w: mse_loss(logits, tar, w)
    else:
        mse = lambda w: global_weighted_mean(mesh, squared_error(logits, tar), w)
    scalars = {"mse": mse(v4)}
    if task == "mask":
        scalars["mse_w"] = mse(weights * v4)
    return scalars


def global_psnr(mesh, target: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """``ops.image.psnr`` over the global batch: the mean squared error of
    the rank's rows averaged over the data group (equal rows a rank)."""
    t = target.float().clamp(0.0, 1.0)
    p = pred.float().clamp(0.0, 1.0)
    mse = comm.all_reduce_sum(mesh, mesh.data_group, torch.mean((t - p) ** 2))
    rmse = torch.sqrt(mse / mesh.shape["data"])
    return 20.0 * torch.log10(1.0 / rmse.clamp_min(1e-12))


def _flat_all_reduce(mesh, group, tensors: list, scale: float = 1.0):
    """Sum each tensor of ``tensors`` over ``group`` in place (times
    ``scale``), through flat buckets of up to GRAD_BUCKET elements."""
    i = 0
    while i < len(tensors):
        j, n = i, 0
        while j < len(tensors) and (j == i or n + tensors[j].numel() <= GRAD_BUCKET):
            n += tensors[j].numel()
            j += 1
        chunk = tensors[i:j]
        flat = torch.cat([t.reshape(-1) for t in chunk])
        comm.all_reduce_sum(mesh, group, flat)
        if scale != 1.0:
            flat.mul_(scale)
        for t, part in zip(chunk, flat.split([t.numel() for t in chunk])):
            t.copy_(part.view_as(t))
        i = j


def reduce_gradients(params: list, mesh, partial: list = ()) -> None:
    """The step's gradient from the ranks' gradients: ``partial`` (the
    spatial runner's Swin weights, a share per spatial rank) summed over the
    spatial group; the other parameters' gradients (whole on every spatial
    rank: those layers run replicated) averaged over it, which only makes
    the replicas' bits equal where a plain op's backward adds in an order of
    its own (atomics); then every gradient summed over the data group (each
    rank's is that of its share of the global loss). The same parameters
    have a gradient on every rank."""
    sp = [p.grad for p in partial if p.grad is not None]
    if sp:
        _flat_all_reduce(mesh, mesh.spatial_group, sp)
    if mesh.shape["spatial"] > 1:
        mine = {id(p) for p in partial}
        _flat_all_reduce(mesh, mesh.spatial_group, [p.grad for p in params if p.grad is not None
                                                   and id(p) not in mine],
                         1.0 / mesh.shape["spatial"])
    _flat_all_reduce(mesh, mesh.data_group, [p.grad for p in params if p.grad is not None])


def step_precision(model):
    """The context a training step of ``model`` runs in: a float32 (or
    float64) model's step, its backward included, with TF32 off in cuBLAS
    and cuDNN (``exact_fp32``; the forward sets it for itself, but autograd
    runs the backward after the forward has returned), the caller's flags
    restored after it, also on error; a bf16 model's as the caller has it.
    The flags are process-wide: a bf16 caller in another thread of the
    process sees TF32 off while such a step runs."""
    if getattr(model, "dtype", torch.bfloat16) != torch.bfloat16:
        return exact_fp32()
    return contextlib.nullcontext()


def build_steps(model, optimizer, task: str = "denoise", sigma: float = 50.0,
                seed: int = 0, augment: bool = True, mesh=None,
                stage_runner=None) -> TrainStepFns:
    """The step functions over ``model`` (parameters requiring grad) and
    ``optimizer`` (train/adam.py, or any with ``zero_grad`` and ``step``).
    ``train_step(batch, step, hists)`` -> (scalars, hists); ``eval_step(batch,
    hists)`` -> (per-sample sums with the valid count "n", hists). Scalars
    stay on the device. ``mesh``: every rank is given the global batch and
    runs its rows (see the module's text); ``stage_runner``: the spatial
    tier's (``parallel.spatial.SpatialStageRunner``)."""
    if task not in TASKS:
        raise ValueError(f"task {task!r} not in {TASKS}")
    device = next(model.parameters()).device
    params = [p for p in model.parameters() if p.requires_grad]

    def valid_of(batch, n):
        v = batch.get("valid")
        return torch.ones(n, device=device) if v is None else v.float()

    def train_step(batch, step: int, hists):
        with step_precision(model):
            return _train_step(batch, step, hists)

    def _train_step(batch, step: int, hists):
        g_data, g_model = step_generators(seed, step, device)
        inp, tar = prepare(batch, task, sigma, g_data, augment)
        v = valid_of(batch, inp.shape[0])
        weights = None
        if mesh is not None:
            rows = data_rows(mesh, inp.shape[0])
            if task == "mask":
                weights = boundary_ring_weights(tar)[rows]
            inp, tar, v = inp[rows], tar[rows], v[rows]
            g_model = model_generator(seed, step, device, mesh.data_index, mesh.shape["data"])
        if stage_runner is not None:
            stage_runner.partial_params.clear()
        loss, logits, weights = loss_and_metrics(model, inp, tar, g_model, v, task, mesh,
                                                 stage_runner, weights)
        optimizer.zero_grad()
        loss.backward()
        if mesh is not None:
            partial = [] if stage_runner is None else list(stage_runner.partial_params.values())
            reduce_gradients(params, mesh, partial)
        optimizer.step()
        logits = logits.detach()
        loss = loss.detach()
        scalars = {"loss": loss, **train_scalars(task, logits, tar, weights, v, mesh)}
        if mesh is not None:
            for k in scalars:
                comm.all_reduce_sum(mesh, mesh.data_group, scalars[k])
        if task == "denoise":
            scalars["psnr"] = (psnr(tar, logits.clamp(0.0, 1.0)) if mesh is None
                               else global_psnr(mesh, tar, logits.clamp(0.0, 1.0)))
        else:
            hists = _add_histograms(mesh, hists, torch.sigmoid(logits), (tar > 0.5).float(), v)
        return scalars, hists

    def init_metrics():
        return init_histograms(DEFAULT_BINS, device) if task == "mask" else {}

    def forward(inp):
        return model(inp) if stage_runner is None else model(inp, stage_runner=stage_runner)

    def total(t):
        """The sum of a per-sample vector over the global batch: with a mesh
        the vectors of the data group gathered first, in rank order."""
        if mesh is not None:
            t = comm.all_gather_cat(mesh, mesh.data_group, t)
        return t.sum()

    @torch.no_grad()
    def eval_step(batch, hists):
        inp = batch["input"].float() / 255.0
        tar = batch["target"].float() / 255.0
        v = valid_of(batch, inp.shape[0])
        if task == "mask" and tar.shape[-1] == 3:
            tar = rgb_to_gray(tar)
        # the boundary weights of the global batch (its mean and its
        # all-background fallback are the batch's), then this rank's rows
        weights = boundary_ring_weights(tar) if task == "mask" else None
        if mesh is not None:
            rows = data_rows(mesh, inp.shape[0])
            inp, tar, v = inp[rows], tar[rows], v[rows]
            weights = None if weights is None else weights[rows]
        if task == "denoise":
            logits = forward(inp)
            pred = logits.clamp(0.0, 1.0)
            tg = rgb_to_gray(tar) if tar.shape[-1] == 3 else tar
            pg = rgb_to_gray(pred) if pred.shape[-1] == 3 else pred
            return {"loss": total(charbonnier_per_sample(logits, tar) * v),
                    "mse": total(mse_per_sample(logits, tar) * v),
                    "psnr": total(psnr_per_sample(tar, pred) * v),
                    "ssim": total(ssim_per_sample(tg, pg) * v),
                    "n": total(v)}, hists
        logits = forward(inp)
        sums = {"loss": total(charbonnier_per_sample(logits, tar, weights) * v),
                "mse": total(mse_per_sample(logits, tar) * v),
                "mse_w": total(mse_per_sample(logits, tar, weights) * v),
                "n": total(v)}
        hists = _add_histograms(mesh, hists, torch.sigmoid(logits), (tar > 0.5).float(), v)
        return sums, hists

    return TrainStepFns(train_step=train_step, eval_step=eval_step,
                        init_metrics=init_metrics)


def _add_histograms(mesh, hists: dict, scores, labels, valid) -> dict:
    """``update_histograms``; with a mesh, this batch's counts summed over
    the data group before they are added."""
    if mesh is None:
        return update_histograms(hists, scores, labels, sample_weight=valid)
    inc = update_histograms({k: torch.zeros_like(h) for k, h in hists.items()}, scores, labels,
                            sample_weight=valid)
    return {k: hists[k] + comm.all_reduce_sum(mesh, mesh.data_group, inc[k]) for k in hists}
