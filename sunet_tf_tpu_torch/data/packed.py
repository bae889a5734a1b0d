"""Packed uint8 memmap shards: decode-free training input (a copy of
``sunet_tf_tpu/data/packed.py``).

PNG decode on a host core is the input path's cost for a corpus that does
not fit the decoded-pair cache (``tools/train_io_bench.py``). Paying it once,
offline: ``pack_pair_dataset`` writes the whole corpus as two raw uint8
``.npy`` arrays (``input.npy`` / ``target.npy``, shape (N, ps, ps, 3)) and
``names.json``; ``PackedPairDataset`` memory-maps them and serves pairs as
slices, so an epoch reads bytes at disk or page-cache speed with no codec
work. It has ``PairDataset``'s ``len`` / ``get`` contract, so
``batch_iterator`` and the ``Trainer`` take it unchanged. numpy only.
"""

from __future__ import annotations

import json
import os

import numpy as np

from sunet_tf_tpu_torch.data.pipeline import (center_crop_np, list_image_pairs, load_image_u8,
                                              reflect_pad_to)


def pack_pair_dataset(root: str, out_dir: str, ps: int) -> dict:
    """Decode an input/-target/ image-pair folder into packed shards: each
    image reflect-padded to at least (ps, ps), then center-cropped to (ps,
    ps) (the identity on a patch corpus of ``data/patches.py``)."""
    pairs = list_image_pairs(root)
    os.makedirs(out_dir, exist_ok=True)
    n = len(pairs)
    inp = np.lib.format.open_memmap(os.path.join(out_dir, "input.npy"), mode="w+",
                                    dtype=np.uint8, shape=(n, ps, ps, 3))
    tar = np.lib.format.open_memmap(os.path.join(out_dir, "target.npy"), mode="w+",
                                    dtype=np.uint8, shape=(n, ps, ps, 3))
    names = []
    for i, (ip, tp) in enumerate(pairs):
        inp[i] = center_crop_np(reflect_pad_to(load_image_u8(ip), ps), ps)
        tar[i] = center_crop_np(reflect_pad_to(load_image_u8(tp), ps), ps)
        names.append(os.path.splitext(os.path.basename(tp))[0])
    inp.flush()
    tar.flush()
    with open(os.path.join(out_dir, "names.json"), "w") as f:
        json.dump({"ps": ps, "names": names}, f)
    return {"n": n, "ps": ps}


class PackedPairDataset:
    """Memmap-backed stand-in for ``PairDataset``: train random crop (from
    numpy's ``default_rng(seed)``, row then column) or eval center crop;
    the crop is the identity where ``patch_size`` is the packed size."""

    def __init__(self, packed_dir: str, patch_size: int, train: bool = True, seed: int = 85):
        with open(os.path.join(packed_dir, "names.json")) as f:
            meta = json.load(f)
        self.names = meta["names"]
        self.packed_ps = int(meta["ps"])
        if patch_size > self.packed_ps:
            raise ValueError(f"patch_size {patch_size} exceeds the packed size "
                             f"{self.packed_ps}")
        self.ps = patch_size
        self.train = train
        self.rng = np.random.default_rng(seed)
        self._inp = np.load(os.path.join(packed_dir, "input.npy"), mmap_mode="r")
        self._tar = np.load(os.path.join(packed_dir, "target.npy"), mmap_mode="r")

    def __len__(self):
        return len(self.names)

    def get(self, i: int):
        """-> (input u8 (ps,ps,3), target u8 (ps,ps,3), name)"""
        inp, tar = self._inp[i], self._tar[i]
        ps = self.ps
        if ps == self.packed_ps:
            return inp, tar, self.names[i]
        if self.train:
            r = int(self.rng.integers(0, self.packed_ps - ps + 1))
            c = int(self.rng.integers(0, self.packed_ps - ps + 1))
            return inp[r:r + ps, c:c + ps], tar[r:r + ps, c:c + ps], self.names[i]
        return (center_crop_np(np.asarray(inp), ps), center_crop_np(np.asarray(tar), ps),
                self.names[i])
