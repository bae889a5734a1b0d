"""Throughput of tiled inference over a corpus of mixed sizes: one image at a
time against ``TiledRunner.run_corpus`` (counterpart of
``tools/corpus_bench.py``).

    python -m sunet_tf_tpu_torch.tools.corpus_bench

The reference's arbitrary-resolution demo runs its images one by one;
``run_corpus`` batches the images that pad to the same canvas, so that small
canvases fill the model's batched forward. Both run the default SUNet
(``Config()``, backend="fused", bf16, seeded weights) at 256 tiles, stride
128, 64 tiles per forward, over 20 images from numpy seed 0: 8 of 256x256,
4 of 200x180, 4 of 300x280 and 4 of 500x400, on the card. Each way is timed
by the host clock from a synchronised card to every output on the host,
the best of 3 after a warm-up. Prints the card's name and power limit,
both rates in images/s, the speedup and the largest |difference| between
the two ways' outputs. It measures the card; it refuses to run without one.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

SIZES = [(256, 256)] * 8 + [(200, 180)] * 4 + [(300, 280)] * 4 + [(500, 400)] * 4


def corpus(seed: int = 0) -> list:
    """The 20 float32 (H, W, 3) images in [0, 1]."""
    r = np.random.default_rng(seed)
    return [r.random((h, w, 3)).astype(np.float32) for h, w in SIZES]


def best_time(fn, reps: int = 3) -> tuple:
    """(best seconds of ``reps`` calls, the last call's result), each call
    timed from a synchronised card to its end."""
    best, out = float("inf"), None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best, out


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("corpus_bench: no CUDA device; the benchmark measures the card")

    from sunet_tf_tpu_torch.config import Config
    from sunet_tf_tpu_torch.infer.tiled import TiledRunner
    from sunet_tf_tpu_torch.models.sunet import build_model
    from sunet_tf_tpu_torch.tools.alu_floor import card

    print(card())
    model = build_model(Config(), device="cuda", backend="fused", seed=0)
    runner = TiledRunner(model, kernel=256, stride=128, tile_batch=64)
    images = [torch.from_numpy(im).cuda() for im in corpus()]

    def serial():
        return [runner(im[None]).cpu() for im in images]

    def batched():
        return runner.run_corpus(images)

    with torch.inference_mode():
        serial()
        batched()
        t_serial, o_s = best_time(serial)
        t_corpus, o_c = best_time(batched)
    diffs = [(a - b).abs() for a, b in zip(o_s, o_c)]
    worst = max(float(d.max()) for d in diffs)
    mean = float(torch.cat([d.flatten() for d in diffs]).mean())
    n = len(images)
    print(f"serial : {t_serial:.3f}s  ({n / t_serial:.2f} img/s)")
    print(f"corpus : {t_corpus:.3f}s  ({n / t_corpus:.2f} img/s)")
    print(f"speedup: {t_serial / t_corpus:.2f}x   max|diff|={worst:.2e} mean|diff|={mean:.2e}")
    return {"serial_s": t_serial, "corpus_s": t_corpus, "serial_img_per_s": n / t_serial,
            "corpus_img_per_s": n / t_corpus, "speedup": t_serial / t_corpus,
            "max_abs_diff": worst, "mean_abs_diff": mean, "sizes": SIZES,
            "serial": o_s, "corpus": o_c}


if __name__ == "__main__":
    main()
