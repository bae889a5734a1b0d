"""Offline patch extraction (``sunet_tf_tpu/data/patches.py`` and its CLI
``cli/generate_patches.py``; the reference's generate_patches.py:12-66).

The target folder is deleted and made again; the files of ``src_dir``
matching ``pattern`` are paired (``tagged``: names containing ``clean_tag``
with names containing ``degraded_tag``, the reference's 'GT' / 'hazy';
``same``: every image is its own clean target, the denoise workflow whose
noise the training step draws on the device). Pair ``i`` gives
``num_patches`` aligned random crops, drawn from numpy's ``default_rng(seed
+ i)``, written as ``input/{i}_{j}.png`` and ``target/{i}_{j}.png`` (j from
1); an image smaller than ``ps`` is first reflect-padded at its bottom and
right. Pairs run on a thread pool of ``num_workers``.

    python -m sunet_tf_tpu_torch.data.patches --src_dir DIV2K/ --tar_dir data/train \\
        [--ps 256 --num_patches 100 --num_cores 4 --pair_mode tagged|same \\
         --clean_tag GT --degraded_tag hazy --pattern '*/*.*']
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from sunet_tf_tpu_torch.data.pipeline import load_image_u8, natural_sorted


def _save(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img).save(path)


def find_pairs(src_dir: str, clean_tag: str = "GT", degraded_tag: str = "hazy",
               pattern: str = "*/*.*", pair_mode: str = "tagged") -> list:
    """-> [(degraded_path, clean_path)]."""
    files = natural_sorted(glob.glob(os.path.join(src_dir, pattern)))
    files = [f for f in files if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp"))]
    if pair_mode == "same":
        return [(f, f) for f in files]
    clean = [f for f in files if clean_tag in os.path.basename(f)]
    degraded = [f for f in files if degraded_tag in os.path.basename(f)]
    if len(clean) != len(degraded):
        raise ValueError(f"unpaired dataset: {len(clean)} '{clean_tag}' vs "
                         f"{len(degraded)} '{degraded_tag}' files")
    return list(zip(degraded, clean))


def generate_patches(src_dir: str, tar_dir: str, ps: int = 256, num_patches: int = 100,
                     num_workers: int = 4, pair_mode: str = "tagged", clean_tag: str = "GT",
                     degraded_tag: str = "hazy", pattern: str = "*/*.*", seed: int = 0) -> int:
    """Write the aligned random patches; returns the number of pairs written."""
    if os.path.exists(tar_dir):
        shutil.rmtree(tar_dir)
    inp_dir = os.path.join(tar_dir, "input")
    out_dir = os.path.join(tar_dir, "target")
    os.makedirs(inp_dir)
    os.makedirs(out_dir)
    pairs = find_pairs(src_dir, clean_tag, degraded_tag, pattern, pair_mode)

    def work(args):
        i, (deg_path, clean_path) = args
        rng = np.random.default_rng(seed + i)
        deg = load_image_u8(deg_path)
        clean = deg if deg_path == clean_path else load_image_u8(clean_path)
        h, w = clean.shape[:2]
        if h < ps or w < ps:
            pad = ((0, max(ps - h, 0)), (0, max(ps - w, 0)), (0, 0))
            deg = np.pad(deg, pad, mode="reflect")
            clean = np.pad(clean, pad, mode="reflect")
            h, w = clean.shape[:2]
        for j in range(num_patches):
            r = int(rng.integers(0, h - ps + 1))
            c = int(rng.integers(0, w - ps + 1))
            _save(os.path.join(inp_dir, f"{i}_{j + 1}.png"), deg[r:r + ps, c:c + ps])
            _save(os.path.join(out_dir, f"{i}_{j + 1}.png"), clean[r:r + ps, c:c + ps])
        return num_patches

    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as ex:
        return sum(ex.map(work, enumerate(pairs)))


def main(argv=None):
    p = argparse.ArgumentParser(description="Generate patches from full-resolution images")
    p.add_argument("--src_dir", required=True)
    p.add_argument("--tar_dir", required=True)
    p.add_argument("--ps", type=int, default=256)
    p.add_argument("--num_patches", type=int, default=100)
    p.add_argument("--num_cores", type=int, default=4)
    p.add_argument("--pair_mode", default="tagged", choices=["tagged", "same"],
                   help="'tagged': pair *GT* with *hazy* files (reference); "
                        "'same': clean-only dataset, noise added on the device")
    p.add_argument("--clean_tag", default="GT")
    p.add_argument("--degraded_tag", default="hazy")
    p.add_argument("--pattern", default="*/*.*")
    args = p.parse_args(argv)
    n = generate_patches(args.src_dir, args.tar_dir, ps=args.ps, num_patches=args.num_patches,
                         num_workers=args.num_cores, pair_mode=args.pair_mode,
                         clean_tag=args.clean_tag, degraded_tag=args.degraded_tag,
                         pattern=args.pattern)
    print(f"wrote {n} patch pairs to {args.tar_dir}")


if __name__ == "__main__":
    main()
