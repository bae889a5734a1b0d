"""Multiprocess decode on ``torch.utils.data.DataLoader`` workers (the
counterpart of ``sunet_tf_tpu/data/grain_pipeline.py``).

The default pipeline (``data/pipeline.py``) decodes in one background
thread: enough for cached patch folders, one host core's work for a corpus
that does not fit the cache. Here ``workers`` spawned processes decode and
crop the records of each batch (the reference ran ``num_workers=0``,
train.py:156). The ``Trainer`` takes this path under ``TPU.DATA_WORKERS >
0``.

Contract (``batch_iterator``'s): yields ``{"input": u8 (B,ps,ps,3),
"target": u8 (B,ps,ps,3), "valid": f32 (B,), "names": [...]}``, the arrays
as CPU tensors (pinned when ``pin_memory``, so that the copy to the card
can run asynchronously). Names come back as record indices and are looked
up in the parent. ``pad_to > 1`` pads a trailing partial batch to a
multiple of ``pad_to`` by repeating its own rows, which carry valid = 0
(grain_pipeline's rule, not ``batch_iterator``'s wrap to the epoch's first
records).

Determinism: the order is ``batch_iterator``'s shuffle of ``seed``; a
record's train crop comes from numpy's ``default_rng((seed, record))``, so
the batches do not depend on the worker count (0 runs in this process).
The workers come from an explicit ``"spawn"`` context (forking a process
that holds the CUDA runtime, or JAX's threads in the tests, can hang);
a batch that takes longer than ``WORKER_TIMEOUT_S`` raises, and so does a
worker that fails: nothing falls back to the in-process pipeline.
"""

from __future__ import annotations

import multiprocessing as mp
import os
from typing import Iterator

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset

from sunet_tf_tpu_torch.data.pipeline import (center_crop_np, list_image_pairs, load_image_u8,
                                              reflect_pad_to)

# Seconds a worker may take to deliver one batch before the epoch raises.
WORKER_TIMEOUT_S = 300.0


class PairRecords(Dataset):
    """Decode-on-access pairs of an input/-target/ root: reflect-pad below
    ``ps``, then the train crop of :func:`train_crop` or the center crop;
    each item (input u8, target u8, record index)."""

    def __init__(self, root: str, ps: int, train: bool, seed: int):
        self.pairs = list_image_pairs(root)
        self.ps, self.train, self.seed = ps, train, seed

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, i: int):
        ip, tp = self.pairs[i]
        inp = reflect_pad_to(load_image_u8(ip), self.ps)
        tar = reflect_pad_to(load_image_u8(tp), self.ps)
        if self.train:
            inp, tar = train_crop(inp, tar, self.ps, self.seed, i)
        else:
            inp, tar = center_crop_np(inp, self.ps), center_crop_np(tar, self.ps)
        return np.ascontiguousarray(inp), np.ascontiguousarray(tar), i


def train_crop(inp: np.ndarray, tar: np.ndarray, ps: int, seed: int, record: int) -> tuple:
    """Record ``record``'s aligned random crop: row, then column offset from
    ``default_rng((seed, record))``."""
    rng = np.random.default_rng((seed, record))
    h, w = tar.shape[:2]
    r = int(rng.integers(0, h - ps + 1))
    c = int(rng.integers(0, w - ps + 1))
    return inp[r:r + ps, c:c + ps], tar[r:r + ps, c:c + ps]


def _collate(items: list) -> tuple:
    return (torch.from_numpy(np.stack([it[0] for it in items])),
            torch.from_numpy(np.stack([it[1] for it in items])),
            torch.tensor([it[2] for it in items], dtype=torch.int64))


def worker_batch_iterator(root: str, patch_size: int, batch: int, train: bool = True,
                          shuffle: bool = True, drop_last: bool = True, seed: int = 0,
                          workers: int = 0, pad_to: int = 0,
                          pin_memory: bool = False) -> Iterator[dict]:
    """``batch_iterator`` over the pairs of ``root``, decoded and cropped in
    ``workers`` spawned processes (0: in this process)."""
    src = PairRecords(root, patch_size, train, seed)
    stems = [os.path.splitext(os.path.basename(tp))[0] for _, tp in src.pairs]
    order = np.arange(len(src))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    loader = DataLoader(
        src, batch_size=batch, sampler=order.tolist(), drop_last=drop_last,
        collate_fn=_collate, num_workers=int(workers), pin_memory=pin_memory,
        timeout=WORKER_TIMEOUT_S if workers > 0 else 0,
        multiprocessing_context=mp.get_context("spawn") if workers > 0 else None)
    for inp, tar, idx in loader:
        n_real = inp.shape[0]
        if pad_to > 1 and n_real % pad_to:
            need = -(-n_real // pad_to) * pad_to - n_real
            rows = torch.from_numpy(np.resize(np.arange(n_real), need))
            inp, tar, idx = (torch.cat([t, t[rows]]) for t in (inp, tar, idx))
            if pin_memory:
                inp, tar = inp.pin_memory(), tar.pin_memory()
        valid = torch.zeros(inp.shape[0], dtype=torch.float32)
        valid[:n_real] = 1.0
        yield {"input": inp, "target": tar, "valid": valid,
               "names": [stems[int(i)] for i in idx]}
