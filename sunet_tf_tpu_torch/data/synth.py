"""Procedural natural-image dataset for recipe runs without data (a copy of
``sunet_tf_tpu/data/synth.py``).

This module synthesizes
deterministic images with natural-image statistics (multi-scale structure,
edges, smooth gradients, texture) so that:

- the full reference recipe (256^2 patches, AWGN sigma, warmup-cosine,
  Charbonnier — reference training.yaml:28-44, train.py:126-135) runs
  end to end and converges to non-trivial PSNR;
- the kernels are exercised on natural-image statistics.

Each image: random low-frequency value noise at several octaves (bilinear
upsampled coarse grids) + random soft-edged shapes + a global gradient,
per-channel correlated — cheap on a 1-core host (~10 ms/image at 256^2).

    python -m sunet_tf_tpu_torch.data.synth --out data/train [--n 400 --size 256 \
        --seed 0 --pair_mode same|awgn --sigma 50]
"""

from __future__ import annotations

import os

import numpy as np


def _upsample_bilinear(grid: np.ndarray, size: int) -> np.ndarray:
    """(g, g, C) -> (size, size, C) bilinear, half-pixel convention."""
    g = grid.shape[0]
    coords = (np.arange(size, dtype=np.float32) + 0.5) * (g / size) - 0.5
    c0 = np.clip(np.floor(coords).astype(np.int32), 0, g - 1)
    c1 = np.minimum(c0 + 1, g - 1)
    f = (coords - c0).astype(np.float32)
    rows = (grid[c0] * (1 - f)[:, None, None] + grid[c1] * f[:, None, None])
    cols = (rows[:, c0] * (1 - f)[None, :, None]
            + rows[:, c1] * f[None, :, None])
    return cols


def synth_image(rng: np.random.Generator, size: int = 256) -> np.ndarray:
    """One (size, size, 3) uint8 procedural 'natural' image."""
    img = np.zeros((size, size, 3), np.float32)

    # multi-octave value noise with 1/f-ish amplitude decay
    octave = 4
    amp = 1.0
    while octave <= size:
        grid = rng.normal(0.0, 1.0, (octave, octave, 3)).astype(np.float32)
        # correlate channels (natural images have high RGB correlation)
        luma = grid.mean(axis=-1, keepdims=True)
        grid = 0.8 * luma + 0.2 * grid
        img += amp * _upsample_bilinear(grid, size)
        amp *= 0.55
        octave *= 4

    # global linear gradient
    gx, gy = rng.normal(0.0, 0.4, 2)
    ramp = (np.linspace(-1, 1, size, dtype=np.float32)[:, None] * gy
            + np.linspace(-1, 1, size, dtype=np.float32)[None, :] * gx)
    img += ramp[:, :, None]

    # soft-edged random shapes (disks / rotated rectangles) => real edges
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for _ in range(int(rng.integers(3, 9))):
        cy, cx = rng.uniform(0, size, 2)
        color = rng.normal(0.0, 0.8, 3).astype(np.float32)
        if rng.random() < 0.5:
            r = rng.uniform(size * 0.05, size * 0.3)
            d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) - r
        else:
            th = rng.uniform(0, np.pi)
            u = (yy - cy) * np.cos(th) + (xx - cx) * np.sin(th)
            v = -(yy - cy) * np.sin(th) + (xx - cx) * np.cos(th)
            hu, hv = rng.uniform(size * 0.05, size * 0.25, 2)
            d = np.maximum(np.abs(u) - hu, np.abs(v) - hv)
        edge = rng.uniform(0.8, 4.0)  # softness in pixels
        m = 1.0 / (1.0 + np.exp(np.clip(d / edge, -30, 30)))
        img += m[:, :, None] * color[None, None]

    # normalize robustly to [0, 1]
    lo, hi = np.percentile(img, [2.0, 98.0])
    img = (img - lo) / max(hi - lo, 1e-6)
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def generate_dataset(root: str, n: int, size: int = 256, seed: int = 0,
                     pair_mode: str = "same", sigma: float = 50.0) -> None:
    """Write n images to <root>/{input,target}/ (PairDataset layout).

    pair_mode:
      'same' — identical pairs; the denoise task synthesizes fresh AWGN on
               device every step (BASELINE.json; data/patches.py flag).
      'awgn' — input = target + N(0, sigma/255) clipped (deterministic by
               seed): the reference's offline-prepared noisy/clean pairs
               for *evaluation* sets, where the noise must be fixed.
    """
    from PIL import Image

    assert pair_mode in ("same", "awgn")
    for sub in ("input", "target"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img = synth_image(rng, size)
        name = f"synth_{i:05d}.png"
        Image.fromarray(img).save(os.path.join(root, "target", name))
        if pair_mode == "awgn":
            noisy = (img.astype(np.float32)
                     + rng.normal(0.0, sigma, img.shape).astype(np.float32))
            img = np.clip(noisy, 0.0, 255.0).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, "input", name))


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Generate a synthetic dataset")
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=400)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pair_mode", default="same", choices=["same", "awgn"])
    p.add_argument("--sigma", type=float, default=50.0)
    a = p.parse_args(argv)
    generate_dataset(a.out, a.n, a.size, a.seed, a.pair_mode, a.sigma)
    print(f"wrote {a.n} {a.size}x{a.size} image pairs to {a.out}")


if __name__ == "__main__":
    main()
