"""Host input pipeline: pairing, decode, crop, batching, prefetch (a copy
of ``sunet_tf_tpu/data/pipeline.py``).

Layout contract is the reference's: a data root containing ``input/`` and
``target/`` subdirectories with matching sorted filenames
(reference dataset_RGB.py:17-21). Recognized extensions per
dataset_RGB.py:9-10.

Division of labor (vs the reference, which did everything on host,
single-threaded, num_workers=0 — train.py:156):

- host: decode to uint8, reflect-pad if smaller than the patch
  (dataset_RGB.py:45-48), random/center crop (cheap numpy slicing),
  batch assembly, background-thread prefetch (double buffering).
- device (inside the train step): /255 normalization, 8-way dihedral
  augmentation, AWGN synthesis, everything after.

Batches are dicts of uint8 numpy arrays {input, target} shaped (B, ps, ps, C)
so the host->device copy is 4x smaller than float32. ``Prefetcher``'s
``put`` moves a batch to the device in the background thread.
"""

from __future__ import annotations

import os
import queue
import re
import threading
from typing import Iterator, Optional

import numpy as np

IMAGE_EXTS = (".jpeg", ".jpg", ".png", ".gif", ".bmp")


def is_image_file(name: str) -> bool:
    return name.lower().endswith(IMAGE_EXTS)


_NAT_SPLIT = re.compile(r"(\d+)")


def natural_sorted(names):
    """Natural sort (natsort-equivalent for filenames): numeric runs compare
    as integers (reference utils/dir_utils.py:19-21 used natsort)."""

    def key(s):
        return tuple(int(t) if t.isdigit() else t.lower()
                     for t in _NAT_SPLIT.split(str(s)))

    return sorted(names, key=key)


def list_image_pairs(root: str) -> list:
    """[(input_path, target_path)] with sorted-name pairing
    (reference dataset_RGB.py:17-21 pairs by independent sorted listings)."""
    inp_dir = os.path.join(root, "input")
    tar_dir = os.path.join(root, "target")
    inps = sorted(x for x in os.listdir(inp_dir) if is_image_file(x))
    tars = sorted(x for x in os.listdir(tar_dir) if is_image_file(x))
    assert len(inps) == len(tars), (
        f"input/target count mismatch: {len(inps)} vs {len(tars)}")
    return [(os.path.join(inp_dir, a), os.path.join(tar_dir, b))
            for a, b in zip(inps, tars)]


def load_image_u8(path: str) -> np.ndarray:
    """Decode to (H, W, 3) uint8 RGB."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def reflect_pad_to(img: np.ndarray, ps: int) -> np.ndarray:
    """Reflect-pad bottom/right so both dims are >= ps
    (reference dataset_RGB.py:45-48 pads (0,0,padw,padh) reflect)."""
    h, w = img.shape[:2]
    padh = max(ps - h, 0)
    padw = max(ps - w, 0)
    if padh or padw:
        img = np.pad(img, ((0, padh), (0, padw), (0, 0)), mode="reflect")
    return img


def center_crop_np(img: np.ndarray, ps: int) -> np.ndarray:
    h, w = img.shape[:2]
    top = int(round((h - ps) / 2.0))
    left = int(round((w - ps) / 2.0))
    return img[top : top + ps, left : left + ps]


class PairDataset:
    """Decoded-image pair dataset with train (random crop) / eval
    (center crop) modes.

    Decoded pairs are kept in a bounded LRU cache (default 4 GiB,
    SUNET_CACHE_BYTES overrides, cache=False disables): patch folders fit
    entirely and skip re-decoding after the first epoch, while full-size
    corpora (DIV2K-scale) evict instead of growing RSS without bound.
    """

    def __init__(self, root: str, patch_size: int, train: bool = True,
                 cache: bool = True, seed: int = 85,
                 cache_bytes: Optional[int] = None):
        import collections

        self.pairs = list_image_pairs(root)
        self.root = root  # the Trainer hands it to data/workers.py
        self.ps = patch_size
        self.train = train
        self.rng = np.random.default_rng(seed)
        self._cache = collections.OrderedDict() if cache else None
        if cache_bytes is None:
            cache_bytes = int(os.environ.get("SUNET_CACHE_BYTES",
                                             4 * 1024 ** 3))
        self._cache_budget = cache_bytes
        self._cache_bytes = 0

    def __len__(self):
        return len(self.pairs)

    def _load(self, i: int):
        if self._cache is not None and i in self._cache:
            self._cache.move_to_end(i)
            return self._cache[i]
        ip, tp = self.pairs[i]
        inp, tar = load_image_u8(ip), load_image_u8(tp)
        if self._cache is not None:
            nbytes = inp.nbytes + tar.nbytes
            if nbytes <= self._cache_budget:
                self._cache[i] = (inp, tar)
                self._cache_bytes += nbytes
                while self._cache_bytes > self._cache_budget:
                    _, (a, b) = self._cache.popitem(last=False)
                    self._cache_bytes -= a.nbytes + b.nbytes
        return inp, tar

    def get(self, i: int):
        """-> (input u8 (ps,ps,3), target u8 (ps,ps,3), name)"""
        inp, tar = self._load(i)
        ps = self.ps
        name = os.path.splitext(os.path.basename(self.pairs[i][1]))[0]
        if self.train:
            inp = reflect_pad_to(inp, ps)
            tar = reflect_pad_to(tar, ps)
            h, w = tar.shape[:2]
            r = int(self.rng.integers(0, h - ps + 1))
            c = int(self.rng.integers(0, w - ps + 1))
            return inp[r : r + ps, c : c + ps], tar[r : r + ps, c : c + ps], name
        # eval: reflect-pad then center crop (the reference's val loader
        # crashed on images smaller than VAL_PS).
        inp = reflect_pad_to(inp, ps)
        tar = reflect_pad_to(tar, ps)
        return center_crop_np(inp, ps), center_crop_np(tar, ps), name


class InputDataset:
    """Input-only dataset, the reference's DataLoaderTest
    (dataset_RGB.py:132-151): the images listed directly in ``inp_dir``
    (no input/-target/ layout), natural-sorted, yielded as (uint8 RGB
    array, stem name) with no crop or resize; pair with
    ``infer.tiled.padded_inference`` / ``tiled_inference`` for the
    forward."""

    def __init__(self, inp_dir: str):
        self.files = [os.path.join(inp_dir, f)
                      for f in natural_sorted(f for f in os.listdir(inp_dir)
                                              if is_image_file(f))]

    def __len__(self):
        return len(self.files)

    def get(self, i: int):
        """-> (u8 (H, W, 3), name) (reference dataset_RGB.py:143-151)."""
        img = load_image_u8(self.files[i])
        return img, os.path.splitext(os.path.basename(self.files[i]))[0]

    def iter_batches(self, batch: int) -> Iterator[dict]:
        """Yield {'input': u8 (B,H,W,3), 'names': [...]} stacks, same-shape
        images grouped in order of first appearance, so that a corpus of
        one size runs as full batches."""
        groups: dict = {}
        for i in range(len(self)):
            img, name = self.get(i)
            groups.setdefault(img.shape, []).append((img, name))
        for items in groups.values():
            for s in range(0, len(items), batch):
                chunk = items[s:s + batch]
                yield {"input": np.stack([a for a, _ in chunk]),
                       "names": [n for _, n in chunk]}


def batch_iterator(ds: PairDataset, batch: int, shuffle: bool = True,
                   drop_last: bool = False, seed: int = 0,
                   pad_to: int = 0) -> Iterator[dict]:
    """Yield {'input','target'} uint8 batches (+ 'names' list).

    pad_to > 1 pads a trailing partial batch (by wrapping around to the
    epoch's first samples) so its leading dim is a multiple of pad_to. Pad
    rows carry "valid"=0 so exact eval paths can mask them out.
    """
    order = np.arange(len(ds))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for start in range(0, len(order), batch):
        idx = order[start : start + batch]
        if drop_last and idx.size < batch:
            return
        n_real = idx.size
        if pad_to > 1 and idx.size % pad_to:
            need = -(-idx.size // pad_to) * pad_to - idx.size
            idx = np.concatenate([idx, np.resize(order, need)])
        valid = np.zeros((idx.size,), np.float32)
        valid[:n_real] = 1.0
        items = [ds.get(int(i)) for i in idx]
        yield {
            "input": np.stack([it[0] for it in items]),
            "target": np.stack([it[1] for it in items]),
            "valid": valid,
            "names": [it[2] for it in items],
        }


class Prefetcher:
    """Background-thread batch prefetch with an optional ``put`` function
    (e.g. a copy to the device) so the copy overlaps compute."""

    def __init__(self, it: Iterator, put=None, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.put = put

        def run():
            try:
                for item in it:
                    names = item.pop("names", None)
                    if self.put is not None:
                        item = self.put(item)
                    self.q.put((item, names))
                self.q.put(None)
            except BaseException as e:  # noqa: BLE001 — re-raised in consumer
                # A decode/IO error must fail the epoch loudly, not truncate
                # it silently (the sentinel alone would read as "epoch done").
                self.q.put(e)

        self.t = threading.Thread(target=run, daemon=True)
        self.t.start()

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
