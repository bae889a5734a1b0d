"""Inference paths (counterpart of ``sunet_tf_tpu/infer/tiled.py``):
fixed-size padded inference and batched overlap-tiled inference.

Padded: reflect-pad to the model's granularity, run, crop back.

Tiled (the reference's arbitrary-resolution path): the image sits centred on
a zero canvas that is a multiple of the tile size, overlapping stride-s
tiles are cut from it, the model runs on all of them as one batched forward
(balanced chunks beyond ``tile_batch``), and the outputs fold back by
overlap-add divided by the number of tiles that cover each pixel. Padding is
rectangular by default (each side rounded up to a tile multiple);
``square_pad=True`` gives the reference's square canvas. The canvas
geometry, tile order and fold are the JAX package's, and the fold adds the
tiles in its order, so that both sum each pixel the same way.

With a mesh (``parallel/mesh.py``) the tiles are split over its data ranks
in order (zero tiles pad them to a multiple, since an all-gather takes equal
shares), each rank runs its share in its own ``tile_batch`` chunks, and
the outputs are all-gathered, the pad tiles dropped and folded on every
rank. A tile's bits do not depend on the batch it runs in (the kernels'
launch plans are functions of one image's shape), so the output equals the
one-process output bit for bit.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from sunet_tf_tpu_torch.ops.constants import shape_constant
from sunet_tf_tpu_torch.parallel import comm


def required_granularity(patch_size: int, num_stages: int, win_size: int) -> int:
    """Smallest g such that any HxW with g | H, W runs through every stage."""
    return patch_size * (2 ** (num_stages - 1)) * win_size


def _reflect_index(n: int, pad: int) -> torch.Tensor:
    """Source rows of ``n + pad`` reflect-padded rows: the index folds with
    period 2(n - 1), so a pad past the size reflects again (numpy's and
    ``jnp.pad``'s ``mode="reflect"``); a size of 1 repeats its one row."""
    i = torch.arange(n + pad)
    if n == 1:
        return torch.zeros_like(i)
    m = i % (2 * (n - 1))
    return torch.where(m < n, m, 2 * (n - 1) - m)


def reflect_pad_nhwc(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Reflect-pad the bottom and right of an NHWC tensor, reflecting again
    where a pad reaches the input's size."""
    if ph == 0 and pw == 0:
        return x
    H, W = x.shape[1], x.shape[2]
    y = x.index_select(1, _reflect_index(H, ph).to(x.device))
    return y.index_select(2, _reflect_index(W, pw).to(x.device))


def padded_inference(model_fn: Callable, img: torch.Tensor,
                     granularity: int) -> torch.Tensor:
    """Run ``model_fn`` at the reflect-padded size, crop back to the input."""
    B, H, W, C = img.shape
    Hp = math.ceil(H / granularity) * granularity
    Wp = math.ceil(W / granularity) * granularity
    y = model_fn(reflect_pad_nhwc(img, Hp - H, Wp - W))
    return y[:, :H, :W, :]


def _tile_starts(X: int, kernel: int, stride: int) -> list:
    """Tile start offsets 0, s, 2s, ... while start + kernel <= X
    (``Tensor.unfold``'s windows)."""
    return list(range(0, X - kernel + 1, stride))


def canvas_shape(H: int, W: int, kernel: int, square_pad: bool) -> tuple:
    """The zero canvas (Xh, Xw) an HxW image is placed on, centred at
    (top, left): each side rounded up to a multiple of ``kernel``, or both
    to the longer one's with ``square_pad``. The canvas is the image's
    bucket: images on the same canvas run as one batch."""
    if square_pad:
        X = int(math.ceil(max(H, W) / kernel) * kernel)
        Xh = Xw = X
    else:
        Xh = int(math.ceil(H / kernel) * kernel)
        Xw = int(math.ceil(W / kernel) * kernel)
    return Xh, Xw, (Xh - H) // 2, (Xw - W) // 2


def _place(imgs: torch.Tensor, Xh: int, Xw: int, top: int, left: int) -> torch.Tensor:
    """(B, H, W, C) images centred on a (B, Xh, Xw, C) zero canvas."""
    B, H, W, C = imgs.shape
    canvas = imgs.new_zeros((B, Xh, Xw, C))
    canvas[:, top:top + H, left:left + W] = imgs
    return canvas


def _gather_tiles(canvases: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """(B, Xh, Xw, C) -> (B*T, kernel, kernel, C) overlapping tiles, image by
    image, row-major over (row start, column start)."""
    B, _, _, C = canvases.shape
    t = canvases.unfold(1, kernel, stride).unfold(2, kernel, stride)
    # (B, n_rows, n_cols, C, kh, kw) -> (B, n_rows, n_cols, kh, kw, C)
    return t.permute(0, 1, 2, 4, 5, 3).reshape(-1, kernel, kernel, C)


def _inv_tile_counts(Xh: int, Xw: int, kernel: int, stride: int,
                     device: torch.device) -> torch.Tensor:
    """1 / (the number of tiles that cover each stride x stride block of the
    canvas), float32, as a (1, Xh/s, 1, Xw/s, 1, 1) tensor on ``device``:
    built on the host once per canvas shape and moved once."""
    return shape_constant(("inv_tile_counts", Xh, Xw, kernel, stride, device),
                          lambda: _build_inv_tile_counts(Xh, Xw, kernel, stride, device))


def _build_inv_tile_counts(Xh: int, Xw: int, kernel: int, stride: int,
                           device: torch.device) -> torch.Tensor:
    q = kernel // stride
    n_rows = len(_tile_starts(Xh, kernel, stride))
    n_cols = len(_tile_starts(Xw, kernel, stride))
    wgt = np.zeros((Xh // stride, Xw // stride), np.float32)
    for i in range(q):
        for j in range(q):
            wgt[i:i + n_rows, j:j + n_cols] += 1.0
    inv = np.float32(1.0) / wgt
    return torch.from_numpy(inv).reshape(1, Xh // stride, 1, Xw // stride, 1, 1).to(device)


def _fold_tiles(outs: torch.Tensor, B: int, Xh: int, Xw: int, kernel: int,
                stride: int) -> torch.Tensor:
    """(B*T, kernel, kernel, C) tile outputs -> (B, Xh, Xw, C) float32:
    overlap-add, then the average over the covering tiles. The q^2 shifted
    adds run in the JAX package's (i, j) order from zeros (``F.fold`` adds
    in an order of its own), and the average multiplies by the float32
    reciprocal of the count, which is what XLA makes of JAX's division by
    the constant count map: each pixel gets JAX's bits."""
    q, s = kernel // stride, stride
    out_c = outs.shape[-1]
    n_rows = len(_tile_starts(Xh, kernel, stride))
    n_cols = len(_tile_starts(Xw, kernel, stride))
    # (B, n_rows, n_cols, q, s, q, s, C): tile (r, c), its stride block (i, j)
    ob = outs.float().reshape(B, n_rows, n_cols, q, s, q, s, out_c)
    acc = outs.new_zeros((B, Xh, Xw, out_c), dtype=torch.float32)
    blocks = acc.view(B, Xh // s, s, Xw // s, s, out_c)
    for i in range(q):
        for j in range(q):
            # block (i, j) of tile (r, c) lands on canvas block (r + i, c + j)
            blocks[:, i:i + n_rows, :, j:j + n_cols] += ob[:, :, :, i, :, j].permute(
                0, 1, 3, 2, 4, 5)
    blocks *= _inv_tile_counts(Xh, Xw, kernel, stride, acc.device)
    return acc


def _run_tiles(run: Callable, tiles: torch.Tensor, tile_batch: int, mesh=None) -> torch.Tensor:
    """Forward all tiles: one batched forward when T <= tile_batch, else
    ceil(T / tile_batch) balanced chunks (65 tiles at 64: 33 + 32), written
    into one output. ``mesh``: this rank runs its share of the tiles (zero
    tiles pad T to a multiple of the data size) and the outputs of the data
    group are all-gathered."""
    T = tiles.shape[0]
    if mesh is not None:
        D = mesh.shape["data"]
        pad = (-T) % D
        if pad:
            tiles = torch.cat([tiles, tiles.new_zeros((pad,) + tiles.shape[1:])])
        k = tiles.shape[0] // D
        mine = _run_tiles(run, tiles[mesh.data_index * k:(mesh.data_index + 1) * k], tile_batch)
        return comm.all_gather_cat(mesh, mesh.data_group, mine)[:T]
    if T <= tile_batch:
        return run(tiles)
    n_chunks = -(-T // tile_batch)
    chunk = -(-T // n_chunks)
    first = run(tiles[:chunk])
    out = first.new_empty((T,) + first.shape[1:])
    out[:chunk] = first
    for s in range(chunk, T, chunk):
        out[s:s + chunk] = run(tiles[s:s + chunk])
    return out


def _tiled_core(model_fn: Callable, canvases: torch.Tensor, kernel: int, stride: int,
                tile_batch: int, mesh=None) -> torch.Tensor:
    """(b, Xh, Xw, C) canvases -> (b, Xh, Xw, C_out) folded float32 outputs:
    the tiles of every canvas go through the same batched forwards (with
    ``mesh``, split over its data ranks)."""
    b, Xh, Xw, _ = canvases.shape
    tiles = _gather_tiles(canvases, kernel, stride)
    outs = _run_tiles(model_fn, tiles, tile_batch, mesh)
    return _fold_tiles(outs, b, Xh, Xw, kernel, stride)


def tiled_inference(model_fn: Callable, img: torch.Tensor, kernel: int = 256,
                    stride: int = 128, tile_batch: int = 64,
                    square_pad: bool = False, mesh=None) -> torch.Tensor:
    """Overlap-tiled inference over (B, H, W, C) images of one size, on
    ``img.device``: the tiles of all B images run through one batched
    forward (chunks beyond ``tile_batch`` tiles) and fold back by
    overlap-add over the covering-tile count. Returns (B, H, W, C_out)
    float32.

    ``model_fn`` maps (N, kernel, kernel, C) -> (N, kernel, kernel, C_out):
    a model or any callable. Wrap the call in ``torch.inference_mode()``
    for inference. ``mesh``: the tiles are split over its data ranks, each
    of which calls with the same ``img`` and gets the whole output.
    """
    B, H, W, C = img.shape
    if not (0 < stride <= kernel and kernel % stride == 0):
        raise ValueError(f"stride {stride} must divide kernel {kernel}")
    Xh, Xw, top, left = canvas_shape(H, W, kernel, square_pad)
    folded = _tiled_core(model_fn, _place(img, Xh, Xw, top, left), kernel, stride,
                         tile_batch, mesh)
    return folded[:, top:top + H, left:left + W]


def _model_device(model_fn: Callable) -> Optional[torch.device]:
    params = getattr(model_fn, "parameters", None)
    p = next(params(), None) if callable(params) else None
    return None if p is None else p.device


class TiledRunner:
    """Tiled inference for corpora of mixed sizes.

    Images that pad to the same canvas (``canvas_shape``, the bucket) share
    one batched forward: ``run_corpus`` stacks same-bucket canvases, each
    image placed and cropped at its own offsets. A 400x520 and a 300x500
    image share a 512x768 bucket at kernel 256. The geometry, tile order
    and fold are ``tiled_inference``'s. ``__call__`` runs on its input's
    device; ``run_corpus`` on the device of ``model_fn``'s parameters,
    else the card. ``mesh``: every forward's tiles are split over its data
    ranks (each rank makes the same calls and gets every output).
    """

    def __init__(self, model_fn: Callable, kernel: int = 256, stride: int = 128,
                 tile_batch: int = 64, square_pad: bool = False, mesh=None):
        if not (0 < stride <= kernel and kernel % stride == 0):
            raise ValueError(f"stride {stride} must divide kernel {kernel}")
        self.model_fn = model_fn
        self.kernel = kernel
        self.stride = stride
        self.tile_batch = tile_batch
        self.square_pad = square_pad
        self.mesh = mesh

    def bucket(self, H: int, W: int) -> tuple:
        """The (Xh, Xw) canvas an HxW image runs on."""
        Xh, Xw, _, _ = canvas_shape(H, W, self.kernel, self.square_pad)
        return Xh, Xw

    def tiles_per_canvas(self, Xh: int, Xw: int) -> int:
        return (len(_tile_starts(Xh, self.kernel, self.stride))
                * len(_tile_starts(Xw, self.kernel, self.stride)))

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, H, W, C_out) float32: ``tiled_inference``."""
        return tiled_inference(self.model_fn, img, self.kernel, self.stride,
                               self.tile_batch, self.square_pad, self.mesh)

    def run_corpus(self, images, canvas_batch: Optional[int] = None) -> list:
        """Tiled inference over images of mixed sizes, each (H, W, C) or
        (1, H, W, C), numpy or torch. Groups the images by bucket and runs
        ``canvas_batch`` same-bucket canvases per forward (default
        ceil(tile_batch / T) for T tiles per canvas, so that a forward
        carries about ``tile_batch`` tiles; the last batch of a bucket is
        shorter). Each batch's outputs come to the host in one copy and are
        cropped there. Returns host float32 tensors (1, H, W, C_out), in
        input order.

        The JAX package pads each batch to a power of two, which bounds its
        compiles per bucket; eager PyTorch compiles nothing, so batches run
        at their own size."""
        device = _model_device(self.model_fn)
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("CUDA is not available; run_corpus runs on the card "
                                   "unless model_fn's parameters are on the CPU")
            device = torch.device("cuda")
        results: list = [None] * len(images)
        groups: dict = {}
        for i, im in enumerate(images):
            im = torch.as_tensor(im)
            if im.dim() == 3:
                im = im[None]
            if im.shape[0] != 1:
                raise ValueError(f"run_corpus takes single images, got {tuple(im.shape)}")
            Xh, Xw, top, left = canvas_shape(im.shape[1], im.shape[2], self.kernel,
                                             self.square_pad)
            groups.setdefault((Xh, Xw), []).append((i, im, top, left))
        for (Xh, Xw), items in groups.items():
            T = self.tiles_per_canvas(Xh, Xw)
            cb = canvas_batch or max(1, -(-self.tile_batch // T))
            for s in range(0, len(items), cb):
                chunk = items[s:s + cb]
                first = chunk[0][1]
                canvases = torch.zeros((len(chunk), Xh, Xw, first.shape[-1]),
                                       dtype=first.dtype, device=device)
                for k, (_, im, top, left) in enumerate(chunk):
                    canvases[k, top:top + im.shape[1], left:left + im.shape[2]] = im[0]
                folded = _tiled_core(self.model_fn, canvases, self.kernel, self.stride,
                                     self.tile_batch, self.mesh).cpu()
                for (i, im, top, left), f in zip(chunk, folded):
                    results[i] = f[None, top:top + im.shape[1], left:left + im.shape[2]]
        return results
