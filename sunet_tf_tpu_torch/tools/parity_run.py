"""The parity run: train the reference recipe end to end on the port, then
validate the trained weights across its routes against its float64 oracle
(the counterpart of the JAX repo's ``tools/parity_run.py``).

No dataset can be fetched, so the run trains on the deterministic
procedural corpus of ``data/synth.py`` (fresh AWGN sigma 50 on every
training step; the validation split's noise written once, as the
reference's offline-prepared noisy/clean pairs). The recipe is the
reference's (training.yaml): batch 4, Adam 2e-4 -> 1e-6, 3 warm-up epochs
and cosine, 256² patches, seed 85, on the fused route (the card's
kernels), with the epoch count and ``STEPS_PER_EPOCH`` cut to the run's
length.

Then, on the trained weights:
- ``Trainer.eval_epoch`` on the fused and on the eager route;
- each validation image through fused bf16, eager bf16, eager float32 and
  the float64 oracle (``fp64_oracle.oracle_model``, in the place of the JAX
  tool's ``torch_reference`` column): PSNR (``fp64_oracle.np_psnr``) and
  SSIM (``ssim_oracle``, float64 scipy, RGB channel mean) per image and
  their means, each route's gap to the oracle, the fused route's mean
  |diff| against eager bf16 (``fused_vs_eager_mean_abs``) and the
  attention-logit extrema (``obs.attention_logit_stats``, two images).

Gates, written into ``RESULTS.json``:
- ``parity_within_0.05dB``: eager float32 within 0.05 dB of the oracle on
  every image;
- ``quality_no_regression_0.05dB``: fused bf16 PSNR >= eager bf16 PSNR -
  0.05 dB on every image (the kernels lose nothing against plain PyTorch
  in the same dtype; the port has no float32 kernels to gate);
- ``ssim_no_regression_0.002``: the same comparison for SSIM.

Usage:
    python -m sunet_tf_tpu_torch.tools.parity_run [--out runs/parity_torch]
        [--data <out>/data] [--n-train 400] [--n-val 8] [--batch 4]
        [--epochs 40] [--steps-per-epoch 250] [--val-every 10]
        [--skip-train] [--cpu] [--tiny]

``--cpu`` runs on the CPU (the wrappers' plain versions) and ``--tiny`` at
``config.tiny_config()`` (64² images), which is how it runs without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from sunet_tf_tpu_torch.config import Config, tiny_config
from sunet_tf_tpu_torch.tools.fp64_oracle import np_psnr, oracle_model

SIGMA = 50.0
DEFAULT_OUT = "runs/parity_torch"
# the port's routes: (name, backend, compute dtype)
ROUTES = (("fused_bfloat16", "fused", torch.bfloat16),
          ("eager_bfloat16", "eager", torch.bfloat16),
          ("eager_float32", "eager", torch.float32))
PSNR_GATE_DB = 0.05
SSIM_GATE = 0.002


def make_data(root: str, n_train: int, n_val: int, size: int = 256) -> tuple:
    """The synthetic corpus under ``root`` (train: identical pairs, fresh
    noise each step; val: AWGN sigma 50 written once), made once."""
    from sunet_tf_tpu_torch.data.synth import generate_dataset

    tdir, vdir = os.path.join(root, "train"), os.path.join(root, "val")
    if not os.path.isdir(os.path.join(vdir, "input")):
        t0 = time.time()
        generate_dataset(tdir, n_train, size, seed=1, pair_mode="same")
        generate_dataset(vdir, n_val, size, seed=2, pair_mode="awgn", sigma=SIGMA)
        print(f"# data: {n_train}+{n_val} images in {time.time() - t0:.1f} s")
    return tdir, vdir


def build_cfg(base: Config, tdir: str, vdir: str, out: str, *, batch: int = 4,
              epochs: int = 40, steps_per_epoch: int = 250, val_every: int = 10) -> Config:
    """``base`` (``Config()``, or ``tiny_config()`` on the CPU) with the
    reference recipe: denoising with 3 output channels, batch ``batch``,
    Adam 2e-4 -> 1e-6 over ``epochs`` epochs of ``steps_per_epoch`` steps
    with 3 warm-up epochs, patches at the model's image size, seed 85,
    bf16 compute, checkpoints under ``out``."""
    size = base.swinunet.img_size
    return base.replace(
        swinunet=dataclasses.replace(base.swinunet, out_chans=3),
        optim=dataclasses.replace(base.optim, batch=batch, epochs=epochs, lr_initial=2e-4,
                                  lr_min=1e-6, warmup_epochs=3),
        training=dataclasses.replace(
            base.training, train_ps=size, val_ps=size, train_dir=tdir, val_dir=vdir,
            save_dir=out, seed=85, val_after_every=val_every,
            steps_per_epoch=steps_per_epoch),
        compute_dtype="bfloat16")


def cfg_from_results(results: dict, out: str, data=None) -> Config:
    """The run's Config from its ``RESULTS.json`` recipe (the model, the
    corpus under ``data`` or ``<out>/data`` and the checkpoint under
    ``out``)."""
    rc = results["recipe"]
    root = data or os.path.join(out, "data")
    return build_cfg(tiny_config() if rc.get("tiny") else Config(),
                     os.path.join(root, "train"), os.path.join(root, "val"), out,
                     batch=rc["batch"], epochs=rc["epochs"],
                     steps_per_epoch=rc["steps_per_epoch"], val_every=rc["val_every"])


def train(cfg: Config, device) -> tuple:
    """``Trainer(cfg, backend="fused").fit()`` on ``device``: (the trained
    model, a summary of the run)."""
    from sunet_tf_tpu_torch.train.trainer import Trainer

    t = Trainer(cfg, task="denoise", sigma=SIGMA, device=device, backend="fused")
    t0 = time.time()
    summary = t.fit()
    hist = t.logger.history
    per_epoch = lambda split, m: [round(hist[(split, m)][e], 6)
                                  for e in sorted(hist.get((split, m), {}))]
    return t.model, {"train_time_s": round(time.time() - t0, 1), "best": summary["best"],
                     "steps": cfg.optim.epochs * t.steps_per_epoch,
                     "train_loss": per_epoch("train", "loss"),
                     "val_psnr": per_epoch("val", "psnr")}


def load_trained(cfg: Config, device):
    """The fused-route model of ``cfg`` on ``device`` with the run's latest
    checkpoint."""
    from sunet_tf_tpu_torch.ckpt import latest_path, restore_checkpoint
    from sunet_tf_tpu_torch.models.sunet import build_model

    path = latest_path(os.path.join(cfg.training.save_dir, cfg.mode, "models"))
    if path is None:
        raise FileNotFoundError("no checkpoint: run tools/parity_run.py first")
    model = build_model(cfg, device=device, backend="fused", seed=cfg.training.seed)
    restore_checkpoint(path, model)
    return model


def val_arrays(cfg: Config) -> tuple:
    """(noisy, targets): the validation split as float32 (N, H, W, 3) in [0,
    1], in file order."""
    from sunet_tf_tpu_torch.data.pipeline import PairDataset, batch_iterator

    ds = PairDataset(cfg.training.val_dir, cfg.training.val_ps, train=False)
    batches = list(batch_iterator(ds, 1, shuffle=False))
    cat = lambda k: np.concatenate([b[k] for b in batches]).astype(np.float32) / 255.0
    return cat("input"), cat("target")


def route_outputs(model, noisy: np.ndarray, device, with_oracle: bool = True) -> dict:
    """Each route's output (name -> float64 (N, H, W, C)) on ``noisy``, one
    image at a time, on ``model``'s weights; "fp64_oracle" too. float32
    products run in float32 (no TF32, which cuDNN's convolutions take by
    default on the card)."""
    from sunet_tf_tpu_torch.kernels.window_attention import exact_fp32
    from sunet_tf_tpu_torch.models.sunet import route_copy

    models = {name: route_copy(model, dtype=dt, backend=be) for name, be, dt in ROUTES}
    if with_oracle:
        models["fp64_oracle"] = oracle_model(model)
    outs = {}
    with torch.no_grad(), exact_fp32():
        for name, m in models.items():
            outs[name] = np.concatenate([
                m(torch.as_tensor(noisy[i:i + 1], device=device)).double().cpu().numpy()
                for i in range(len(noisy))])
    return outs


def eval_route(cfg: Config, model, backend: str, device) -> dict:
    """``Trainer.eval_epoch`` over the validation split on ``backend``
    with ``model``'s weights (the trainer's log under <out>/eval_<backend>)."""
    from sunet_tf_tpu_torch.train.trainer import Trainer

    cfg_e = cfg.replace(training=dataclasses.replace(
        cfg.training, save_dir=os.path.join(cfg.training.save_dir, f"eval_{backend}")))
    t = Trainer(cfg_e, task="denoise", sigma=SIGMA, device=device, backend=backend,
                verbose=False)
    with torch.no_grad():
        t.model.load_state_dict(model.state_dict())
    ev = t.eval_epoch(t.val_ds)
    ev.pop("_hists", None)
    return {k: round(float(v), 4) for k, v in ev.items()}


def evaluate(cfg: Config, model, device) -> dict:
    """The validation of the trained ``model`` across the routes (the
    module's text): every key of ``RESULTS.json`` but the recipe and the
    training summary."""
    from sunet_tf_tpu_torch.obs import attention_logit_stats
    from sunet_tf_tpu_torch.tools.ssim_oracle import ssim_oracle

    res = {f"val_{be}": eval_route(cfg, model, be, device) for be in ("fused", "eager")}
    for be in ("fused", "eager"):
        print(f"# val[{be}]: {res[f'val_{be}']}")
    noisy, targets = val_arrays(cfg)
    t0 = time.time()
    outs = route_outputs(model, noisy, device)
    res["routes_time_s"] = round(time.time() - t0, 1)
    res["fused_vs_eager_mean_abs"] = float(np.mean(np.abs(outs["fused_bfloat16"]
                                                          - outs["eager_bfloat16"])))
    res["attn_logits"] = attention_logit_stats(model, noisy[:2])

    cols = {"noisy": noisy, **outs}
    psnr = {k: np_psnr(targets, v) for k, v in cols.items()}
    ssim = {k: ssim_oracle(targets, np.clip(v, 0.0, 1.0)) for k, v in cols.items()}
    res["per_image_psnr"] = {k: [round(float(x), 4) for x in v] for k, v in psnr.items()}
    res["psnr_mean"] = {k: round(float(v.mean()), 4) for k, v in psnr.items()}
    res["per_image_ssim"] = {k: [round(float(x), 5) for x in v] for k, v in ssim.items()}
    res["ssim_mean"] = {k: round(float(v.mean()), 5) for k, v in ssim.items()}
    routes = [name for name, _, _ in ROUTES]
    o_p, o_s = psnr["fp64_oracle"], ssim["fp64_oracle"]
    res["psnr_gap_db"] = {k: float(np.max(np.abs(psnr[k] - o_p))) for k in routes}
    res["ssim_gap_vs_oracle"] = {k: float(np.max(np.abs(ssim[k] - o_s))) for k in routes}
    res["mean_abs_vs_oracle"] = {k: float(np.mean(np.abs(outs[k] - outs["fp64_oracle"])))
                                 for k in routes}
    res["per_image_delta_vs_oracle_db"] = [round(float(x), 5)
                                           for x in psnr["fused_bfloat16"] - o_p]
    res["parity_within_0.05dB"] = bool(np.all(np.abs(psnr["eager_float32"] - o_p)
                                              <= PSNR_GATE_DB))
    res["quality_no_regression_0.05dB"] = bool(np.all(
        psnr["fused_bfloat16"] - psnr["eager_bfloat16"] >= -PSNR_GATE_DB))
    res["ssim_no_regression_0.002"] = bool(np.all(
        ssim["fused_bfloat16"] - ssim["eager_bfloat16"] >= -SSIM_GATE))
    return res


GATES = ("parity_within_0.05dB", "quality_no_regression_0.05dB", "ssim_no_regression_0.002")


def run(cfg: Config, device, *, skip_train: bool = False, recipe: dict = None) -> dict:
    """Train (unless ``skip_train``) and validate; writes and returns
    ``<save_dir>/RESULTS.json``."""
    out = cfg.training.save_dir
    path = os.path.join(out, "RESULTS.json")
    results = {}
    if skip_train and os.path.isfile(path):
        with open(path) as f:
            results = {k: v for k, v in json.load(f).items()
                       if k in ("recipe", "training")}
    results["recipe"] = recipe or results.get("recipe", {})
    if skip_train:
        model = load_trained(cfg, device)
    else:
        model, results["training"] = train(cfg, device)
        print(f"# trained {results['training']['steps']} steps in "
              f"{results['training']['train_time_s']} s")
    model.eval().requires_grad_(False)
    results.update(evaluate(cfg, model, device))
    os.makedirs(out, exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", default=None, help="default: <out>/data")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--n-train", type=int, default=400)
    ap.add_argument("--n-val", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--steps-per-epoch", type=int, default=250)
    ap.add_argument("--val-every", type=int, default=10)
    ap.add_argument("--skip-train", action="store_true",
                    help="evaluate the run's latest checkpoint")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--tiny", action="store_true", help="config.tiny_config() at 64²")
    args = ap.parse_args(argv)
    base = tiny_config() if args.tiny else Config()
    tdir, vdir = make_data(args.data or os.path.join(args.out, "data"), args.n_train,
                           args.n_val, base.swinunet.img_size)
    cfg = build_cfg(base, tdir, vdir, args.out, batch=args.batch, epochs=args.epochs,
                    steps_per_epoch=args.steps_per_epoch, val_every=args.val_every)
    recipe = {"batch": args.batch, "epochs": args.epochs,
              "steps_per_epoch": args.steps_per_epoch, "val_every": args.val_every,
              "n_train": args.n_train, "n_val": args.n_val, "sigma": SIGMA,
              "lr": [2e-4, 1e-6], "warmup": 3, "tiny": args.tiny}
    results = run(cfg, "cpu" if args.cpu else "cuda", skip_train=args.skip_train,
                  recipe=recipe)
    print(json.dumps({k: v for k, v in results.items()
                      if k not in ("per_image_psnr", "per_image_ssim")}, indent=1))
    return results


if __name__ == "__main__":
    main()
