"""The spatial tier: activation rows H sharded over the mesh's ``spatial``
group (``sunet_tf_tpu/parallel/spatial.py``).

A Swin block is row-local but for the SW-MSA roll, so a stage sharded over
H needs one exchange of ``shift`` rows per roll (``spatial_roll_h``) and,
for a 3x3 convolution, a halo of one row from each neighbour
(``halo_exchange_rows``). Each is an autograd Function whose backward is
the exchange's transpose: the roll's is the opposite roll, the halo's sends
the halo's gradient back to the rows it came from (JAX's ppermute
transposes to a ppermute).

``SpatialStageRunner`` (JAX ``PallasSpatialStageRunner``) runs the stages
it takes per shard on the block kernels: each rank takes its rows of the
stage's input (every rank of a spatial group holds the whole input; the
layers outside the stages run replicated there), rolls W locally and H by
one exchange, runs the block kernel at shift 0 with its slice of the
global SW-MSA mask (inference: ``fused_swin_block``; training: the B5
form ``swin_block_trainable_dynmask``, the recompute route at every width,
as JAX's runner), unrolls, and all-gathers the rows at the stage's end.
Each shard's launch takes the whole map's plan (``plan_hw``), so that its
windows get the bits they get unsharded. The gradient: the row slice's backward all-gathers the input gradient
(every rank's upstream layers need all of it), the all-gather's backward
takes the rank's own rows and sums nothing, and the stage's Swin weights
get a partial gradient per spatial rank, which the training step sums over
the spatial group (``partial_params``); the replicated layers' gradients
are whole on every rank and are not summed (the step averages them there,
which keeps the replicas' bits equal where a plain op's backward adds in
an order of its own).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from sunet_tf_tpu_torch.kernels import window_attention as wa
from sunet_tf_tpu_torch.models.layers import drop_path_scales, layer_norm
from sunet_tf_tpu_torch.ops.window import window_partition, window_reverse
from sunet_tf_tpu_torch.parallel import comm


def _neighbours(mesh) -> tuple:
    """(spatial index, spatial size, previous rank, next rank), cyclic."""
    peers = mesh.spatial_peers()
    n, i = len(peers), mesh.spatial_index
    return i, n, peers[(i - 1) % n], peers[(i + 1) % n]


def _halo_fwd(mesh, x: torch.Tensor, halo: int, mode: str, dim: int) -> torch.Tensor:
    i, n, prev, nxt = _neighbours(mesh)
    L = x.shape[dim]
    sends, recvs = [], []
    shape = list(x.shape)
    shape[dim] = halo
    if i > 0:
        sends.append((x.narrow(dim, 0, halo), prev, comm.TAG_UP))
        recvs.append((shape, x.dtype, prev, comm.TAG_DOWN))
    if i < n - 1:
        sends.append((x.narrow(dim, L - halo, halo), nxt, comm.TAG_DOWN))
        recvs.append((shape, x.dtype, nxt, comm.TAG_UP))
    got = comm.exchange(mesh, mesh.spatial_group, sends, recvs)
    if mode == "zero":
        fill_top = fill_bot = x.new_zeros(shape)
    else:
        fill_top = x.narrow(dim, 0, 1).expand(shape)
        fill_bot = x.narrow(dim, L - 1, 1).expand(shape)
    above = got.pop(0) if i > 0 else fill_top
    below = got.pop(0) if i < n - 1 else fill_bot
    return torch.cat([above, x, below], dim=dim)


def _halo_bwd(mesh, g: torch.Tensor, halo: int, mode: str, dim: int) -> torch.Tensor:
    i, n, prev, nxt = _neighbours(mesh)
    L = g.shape[dim] - 2 * halo
    g_above, g_below = g.narrow(dim, 0, halo), g.narrow(dim, halo + L, halo)
    dx = g.narrow(dim, halo, L).clone()
    sends, recvs = [], []
    shape = list(g_above.shape)
    if i > 0:       # my top halo came from the previous rank's last rows
        sends.append((g_above, prev, comm.TAG_UP))
        recvs.append((shape, g.dtype, prev, comm.TAG_DOWN))
    if i < n - 1:   # my bottom halo came from the next rank's first rows
        sends.append((g_below, nxt, comm.TAG_DOWN))
        recvs.append((shape, g.dtype, nxt, comm.TAG_UP))
    got = comm.exchange(mesh, mesh.spatial_group, sends, recvs)
    if i > 0:
        dx.narrow(dim, 0, halo).add_(got.pop(0))
    elif mode == "edge":
        dx.narrow(dim, 0, 1).add_(g_above.sum(dim, keepdim=True))
    if i < n - 1:
        dx.narrow(dim, L - halo, halo).add_(got.pop(0))
    elif mode == "edge":
        dx.narrow(dim, L - 1, 1).add_(g_below.sum(dim, keepdim=True))
    return dx


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, halo, mode, dim):
        ctx.args = (mesh, halo, mode, dim)
        return _halo_fwd(mesh, x, halo, mode, dim)

    @staticmethod
    def backward(ctx, g):
        return (_halo_bwd(*ctx.args[:1], g.contiguous(), *ctx.args[1:]), None, None, None, None)


def halo_exchange_rows(x: torch.Tensor, mesh, halo: int, mode: str = "edge",
                       dim: int = 0) -> torch.Tensor:
    """This rank's shard ``x`` with ``halo`` rows (along ``dim``; JAX's
    (local_H, W, C) has them at 0) of each neighbouring shard of the spatial
    group added before and after it. At the global border, ``mode`` "edge"
    repeats the outermost row (``np.pad(mode='edge')`` for any halo up to
    the local rows) and "zero" adds zero rows (a SAME convolution's
    padding). Returns local rows + 2 * halo rows; differentiable."""
    if mode not in ("edge", "zero"):
        raise ValueError(f"mode {mode!r} not in ('edge', 'zero')")
    if not 0 < halo <= x.shape[dim]:
        raise ValueError(f"halo {halo} outside [1, {x.shape[dim]}] (the local rows)")
    return _Halo.apply(x, mesh, halo, mode, dim)


def _roll_h(mesh, x: torch.Tensor, shift: int) -> torch.Tensor:
    if shift == 0:
        return x
    i, n, prev, nxt = _neighbours(mesh)
    if n == 1:
        return torch.roll(x, shift, dims=1)
    s = abs(shift)
    shape = (x.shape[0], s) + tuple(x.shape[2:])
    if shift < 0:   # up: my rows [s:], then the next shard's first s rows
        recv, = comm.exchange(mesh, mesh.spatial_group, [(x[:, :s], prev, comm.TAG_UP)],
                              [(shape, x.dtype, nxt, comm.TAG_UP)])
        return torch.cat([x[:, s:], recv], dim=1)
    # down: the previous shard's last s rows, then my rows [:-s]
    recv, = comm.exchange(mesh, mesh.spatial_group, [(x[:, -s:], nxt, comm.TAG_DOWN)],
                          [(shape, x.dtype, prev, comm.TAG_DOWN)])
    return torch.cat([recv, x[:, :-s]], dim=1)


class _RollH(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, shift):
        ctx.args = (mesh, shift)
        return _roll_h(mesh, x, shift)

    @staticmethod
    def backward(ctx, g):
        mesh, shift = ctx.args
        return _roll_h(mesh, g.contiguous(), -shift), None, None


def spatial_roll_h(x: torch.Tensor, shift: int, mesh) -> torch.Tensor:
    """The global cyclic roll by ``shift`` along H of a (B, local_H, W, C)
    shard, by one exchange of |shift| rows with a neighbour (|shift| <=
    local_H); differentiable (the backward is the opposite roll)."""
    if abs(shift) > x.shape[1]:
        raise ValueError(f"shift {shift} exceeds the local rows {x.shape[1]}")
    if shift == 0:
        return x
    return _RollH.apply(x, mesh, shift)


class _RowsOf(torch.autograd.Function):
    """This rank's rows (dim 1) of a tensor every rank of the spatial group
    holds whole; the backward all-gathers the rows' gradients."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        L = x.shape[1] // mesh.shape["spatial"]
        return x[:, mesh.spatial_index * L:(mesh.spatial_index + 1) * L].contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return comm.all_gather_cat(mesh, mesh.spatial_group, g.contiguous(), dim=1), None


class _GatherRows(torch.autograd.Function):
    """The rows (dim 1) of every rank of the spatial group, whole; the
    backward takes this rank's rows of the gradient (every rank holds the
    same whole gradient: the layers after the stage are replicated)."""

    @staticmethod
    def forward(ctx, xl, mesh):
        ctx.mesh = mesh
        return comm.all_gather_cat(mesh, mesh.spatial_group, xl, dim=1)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        L = g.shape[1] // mesh.shape["spatial"]
        return g[:, mesh.spatial_index * L:(mesh.spatial_index + 1) * L].contiguous(), None


def rows_of(x: torch.Tensor, mesh) -> torch.Tensor:
    return _RowsOf.apply(x, mesh)


def gather_rows(xl: torch.Tensor, mesh) -> torch.Tensor:
    return _GatherRows.apply(xl, mesh)


def _mask_rows(blk, H: int, W: int, local_h: int, mesh, device) -> Optional[torch.Tensor]:
    """This shard's (nW_local, N, N) slice of the block's rolled-space SW-MSA
    mask of the whole H x W map: window rows from s * nW_local."""
    mask = blk.mask(H, W, device)
    if mask is None:
        return None
    ws = blk.window_size
    n_local = (local_h // ws) * (W // ws)
    return mask[mesh.spatial_index * n_local:(mesh.spatial_index + 1) * n_local]


def _check_geometry(mesh, blocks, H: int):
    n_sp = mesh.shape["spatial"]
    for blk in blocks:
        if H % (n_sp * blk.window_size):
            raise ValueError(f"H={H} not divisible into {n_sp} shards of window "
                             f"{blk.window_size} rows")
        if blk.shift_size > H // n_sp:
            raise ValueError("shift exceeds a local shard")


def run_swin_blocks_spatial(mesh, blocks, x: torch.Tensor) -> torch.Tensor:
    """A stage's Swin blocks over (B, H, W, C), H sharded over the spatial
    group, in plain PyTorch (the eager blocks' math, JAX
    ``run_swin_blocks_spatial``): per shifted block the W roll is local and
    the H roll one exchange, attention and MLP are row-local, and each shard
    applies its slice of the global mask. ``x`` is whole on every rank of the
    spatial group, and so is the result. Needs H % (spatial * ws) == 0 and
    shift <= H / spatial."""
    B, H, W, C = x.shape
    _check_geometry(mesh, blocks, H)
    xl = rows_of(x, mesh)
    for blk in blocks:
        ws, ss = blk.window_size, blk.shift_size
        Lh = xl.shape[1]
        xn = layer_norm(xl, blk.norm1)
        if ss > 0:
            xn = spatial_roll_h(torch.roll(xn, -ss, dims=2), -ss, mesh)
        xw = blk.attn(window_partition(xn, ws), _mask_rows(blk, H, W, Lh, mesh, x.device))
        xn = window_reverse(xw, ws, Lh, W)
        if ss > 0:
            xn = torch.roll(spatial_roll_h(xn, ss, mesh), ss, dims=2)
        xl = xl + xn
        xl = xl + blk.mlp(layer_norm(xl, blk.norm2))
    return gather_rows(xl, mesh)


class SpatialStageRunner:
    """Runs a Swin stage with H sharded over the mesh's spatial group, each
    block on the block kernel per shard (JAX ``PallasSpatialStageRunner``).
    ``SwinStage.forward(..., runner=)`` asks ``applies`` per stage and runs
    the stage replicated where it refuses (and never asks under
    ``USE_CHECKPOINTS``, where the Trainer builds no runner, as JAX's
    stages skip it). ``dropout``: the model trains or runs with dropout
    (JAX ``_can_fuse`` false: the runner refuses every stage). ``partial_params``: the parameters of the stages run in training
    since it was last cleared, whose gradients are partial per spatial rank
    (the training step clears it before the forward and sums their
    gradients over the spatial group after the backward)."""

    def __init__(self, mesh, dropout: bool = False):
        self.mesh = mesh
        self.n_sp = mesh.shape["spatial"]
        self.dropout = dropout
        self.partial_params: dict = {}

    def applies(self, blocks, shape, train: bool) -> bool:
        """JAX's gate on global shapes alone (so every rank decides alike):
        the batch divides the data ranks (``shape``'s batch is this rank's,
        already divided), H % (spatial * ws) == 0 and W % ws == 0, the shift
        at most the local rows, no dropout; and the port's block-kernel
        route for each block: C within the router's cap for the window
        (inference ``ROUTE_BLOCK_MAX_C``; training
        ``trains_on_block_kernels``: 384 up to 64 tokens a window, 768 above,
        JAX's train cap) and a kernel plan for its shape."""
        B, H, W, C = shape
        if self.dropout:
            return False
        for blk in blocks:
            ws, ss = blk.window_size, blk.shift_size
            if H % (self.n_sp * ws) or W % ws or ss > H // self.n_sp:
                return False
            if blk.backend != "fused" or blk.dim != C:
                return False
            if train and not blk.trains_on_block_kernels():
                return False
            if not train and not (C <= wa.BLOCK_KERNEL_MAX_C and blk.takes_block_kernel()):
                return False
        return True

    def __call__(self, blocks, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        mesh = self.mesh
        B, H, W, C = x.shape
        _check_geometry(mesh, blocks, H)
        xl = rows_of(x, mesh)
        for blk in blocks:
            ws, ss, a, m = blk.window_size, blk.shift_size, blk.attn, blk.mlp
            Lh = xl.shape[1]
            xr = xl
            if ss > 0:
                xr = spatial_roll_h(torch.roll(xl, -ss, dims=2), -ss, mesh)
            mask = _mask_rows(blk, H, W, Lh, mesh, x.device)
            if generator is None:
                p = blk.kernel_params(xr.dtype)
                out = wa.fused_swin_block(
                    xr.contiguous(), p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9],
                    p[10], p[11], p[12], mask, ws=ws, num_heads=a.num_heads, scale=a.scale,
                    shift=0, plan_hw=(H, W))
            else:
                dp = drop_path_scales(xr.shape[0], blk.drop_path_rate, generator, x.device)
                t = lambda lin: lin.weight.t()
                out = wa.swin_block_trainable_dynmask(
                    xr, blk.norm1.weight, blk.norm1.bias, t(a.qkv), a.qkv.bias, t(a.proj),
                    a.proj.bias, blk.norm2.weight, blk.norm2.bias, t(m.fc1), m.fc1.bias,
                    t(m.fc2), m.fc2.bias, a.bias_matrix(), dp, mask, ws, a.num_heads, a.scale,
                    (H, W))
                for prm in blk.parameters():
                    self.partial_params.setdefault(id(prm), prm)
            if ss > 0:
                out = torch.roll(spatial_roll_h(out, ss, mesh), ss, dims=2)
            xl = out
        return gather_rows(xl, mesh)


def spatial_conv3x3(mesh, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None):
    """A 3x3 SAME convolution over (B, local_H, W, C) shards of an image
    sharded over the spatial group (JAX ``spatial_conv3x3``): a "zero" halo
    of one row from each neighbour, then the rows VALID and the columns
    SAME. ``kernel``: (3, 3, C_in, C_out), JAX's HWIO. Returns the function
    of the shard; differentiable."""
    w = kernel.permute(3, 2, 0, 1)

    def conv(x: torch.Tensor) -> torch.Tensor:
        padded = halo_exchange_rows(x, mesh, 1, mode="zero", dim=1)
        y = F.conv2d(padded.permute(0, 3, 1, 2), w.to(x.dtype), padding=(0, 1))
        y = y.permute(0, 2, 3, 1)
        return y if bias is None else y + bias.to(y.dtype)

    return conv
