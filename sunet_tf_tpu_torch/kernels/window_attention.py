"""Swin-block kernels: wrappers over the hand-written CUDA kernels, each
with its plain PyTorch version beside it.

Counterparts of ``sunet_tf_tpu/kernels/window_attention.py``:

- :func:`fused_swin_block` (JAX ``fused_swin_block``): one whole block,
  LN1 -> W-MSA (+ in-kernel SW roll) -> proj -> residual -> LN2 -> MLP ->
  residual. CUDA: ``csrc/swin_cluster.cu``, a cluster of CTAs per window
  (:func:`block_plan`); windows above 64 tokens (WIN 16) take the
  sequence form, ``csrc/swin_block_seq.cu``: five launches on
  ``gemm_tile.cuh`` and ``wmsa_attn.cuh`` with the roll as row addressing
  (:func:`block_seq_plan`).
- :func:`fused_swin_block_chain` (JAX ``fused_swin_block_chain``): K
  consecutive blocks with a bf16 cast at each seam; launches the block
  kernel (either form) K times (keeping the map on chip between blocks is
  open work).
- :func:`fused_ln_window_attention` (JAX ``fused_ln_window_attention``):
  LN -> W-MSA -> proj, no residual; three launches (LN and the qkv product,
  attention per (window, head), or per 64 query rows of it above 64
  tokens, the projection; :func:`wmsa_plan`). CUDA:
  ``csrc/ln_window_attention.cu`` (+ ``gemm_tile.cuh``).
- :func:`fused_ln_mlp` (JAX ``fused_ln_mlp``): ``y + fc2(gelu(fc1(LN(y))))``.
  CUDA: ``csrc/ln_mlp.cu``, three launches (:func:`mlp_plan`).
- :func:`fused_window_attention` (JAX ``fused_window_attention``): W-MSA
  with its qkv bias and output projection over a pre-normalized,
  pre-rolled map, no LayerNorm; the partition and reverse are torch ops
  around :func:`wmsa_core` (JAX ``wmsa_core``: pre-partitioned windows),
  two launches (per-head ctx, then the projection). CUDA:
  ``csrc/window_attention.cu``. No model route calls it, as in JAX.
- :func:`swin_block_bwd` (JAX ``_block_bwd_impl``): the whole block's
  backward, recompute form, at any even head dim whose attention operands
  fit shared memory (up to 192 at 64 tokens). CUDA:
  ``csrc/swin_block_bwd.cu``; windows above 64 tokens take its big-window
  form (``csrc/block_bwd_big.cuh``'s attention, over rows of C rounded up
  to 16, :func:`block_bwd_width`). :class:`SwinBlockTrainable` pairs it
  with :func:`fused_swin_block`'s train form (per-image drop-path scales,
  up to C = TRAIN_BLOCK_MAX_C: the cluster kernel where it takes the
  block, else the sequence form, also at 64 tokens a window) for autograd.
- The residual route, JAX's default training block where the attention
  takes the blockdiag layout (:func:`bwd_residuals_enabled`):
  :func:`fused_swin_block_res` (JAX ``fused_swin_block_res``, CUDA
  ``csrc/swin_cluster.cu``'s residual form, on :func:`block_plan`'s
  cluster) is the train-form block that also returns the softmax state
  (eb, rden, ctx_f), and
  :func:`swin_block_bwd_res` (JAX ``_block_bwd_impl_res``, CUDA
  ``csrc/swin_block_bwd_res.cu``) the block backward from that state, with
  no score or softmax recompute; :class:`SwinBlockTrainableRes` pairs them
  (JAX ``swin_block_trainable_res``).
- The two training sublayers of the blocks above the block-kernel cap:
  :func:`ln_window_attention_bwd` (JAX ``_ln_wmsa_bwd_impl``, CUDA
  ``csrc/ln_wmsa_bwd.cu``: the attention half of the block backward's
  launches, :func:`ln_wmsa_bwd_plan`) is the backward of
  :func:`fused_ln_window_attention`, and :class:`LnWindowAttentionTrainable`
  pairs the two (JAX ``ln_window_attention_trainable``);
  :func:`ln_mlp_branch` (JAX ``_ln_mlp_branch``, CUDA
  ``csrc/ln_mlp_branch.cu``), ``fc2(gelu(fc1(LN(y))))`` without the
  residual, and its backward :func:`ln_mlp_bwd` (JAX ``_ln_mlp_bwd``, CUDA
  ``csrc/ln_mlp_bwd.cu``) make :class:`LnMlpTrainable` (JAX
  ``ln_mlp_trainable``).

Arguments follow the JAX functions: NHWC activations, weight matrices in
(in, out) layout and in the compute dtype (the block wrappers also take
them with their columns zero-padded to multiples of 8, :func:`wcols`, as
the model's weight cache stores them), LN parameters and biases in any
float dtype (used as float32), rel-pos bias (h, N, N), mask (nW, N, N) in
rolled coordinates or None.

Rounding points (those of the JAX kernel body ``_block_body``): LN stats in
float32; qkv accumulated in float32 then rounded; ``q*scale`` rounded;
scores float32 + bias + mask; exact row-max softmax with the divide after
``P@V`` (P rounded); ctx rounded; ``y = round(x + attn)``; fc1 accumulated
in float32 -> exact-erf GELU in float32 -> rounded -> fc2 accumulated in
float32; output rounded. GELU is the exact erf form of the XLA path, not
the JAX kernels' tanh form.

Dispatch: a tensor on the CPU goes to the plain version; a CUDA tensor
launches the kernel or raises. There is no fallback between the two. Each
wrapper's count goes up by one per kernel launch (``_build.LaunchCount``).
A float32 CUDA tensor takes the inference wrappers' float32 forms
(csrc/f32_swin_block.cu, csrc/f32_block.cu; every value float32, FFMA
products); :func:`dtype_why` says which dtype each kernel takes, and names
the ROADMAP item of each call it refuses.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional

import torch

from sunet_tf_tpu_torch.kernels import _build
from sunet_tf_tpu_torch.ops.window import roll2d, window_partition, window_reverse

BF16 = torch.bfloat16
# Largest C the whole-block kernel takes: fc2's output columns are at most
# six 64-column boxes, whose sums the CTA's warpgroups hold in registers
# (csrc/swin_cluster.cu kMaxBoxes). Wider blocks take the split LN+W-MSA /
# LN+MLP kernels.
BLOCK_KERNEL_MAX_C = 384
# Widest C of the block kernels' training forms (the sequence form with
# drop-path scales, csrc/swin_block_seq.cu, at any window the cluster kernel
# does not take, and the block backward): JAX's train cap
# (``_kernel_max_c(train=True)``, SUNET_TRAIN_KERNEL_MAX_C=768); the default
# model's C=768 stage and the scaled config's C=720 are its widest uses.
TRAIN_BLOCK_MAX_C = 768
# Kernel launches one call of each training wrapper makes (the forward
# recompute, the backward products and the token reductions of
# csrc/swin_block_bwd.cuh, ln_wmsa_bwd.cu, ln_mlp_bwd.cu; the two products
# of ln_mlp_branch.cu, fc1 with the LN in its A load). The block backward:
# LN1 + qkv, the attention forward, proj, LN2 + fc1, dm w2^T, dab w1^T + the
# LN2 backward, dctx, the attention backward, dqkv wqkv^T + the LN1
# backward, the weight gradients, the sums; the residual route reads ctx
# from its residuals and skips the attention forward. The LN+W-MSA
# backward: its attention half,
# LN1 + qkv, the attention forward, dctx, the attention backward, dqkv
# wqkv^T + the LN1 backward, the weight gradients, the sums. The LN+MLP
# backward: its MLP half, LN2 + fc1, dm w2^T, dab w1^T split over K, the
# weight gradients with the LN2 backward, the sums.
SWIN_BLOCK_BWD_LAUNCHES = 11
# The block backward above 64 tokens a window (csrc/block_bwd_big.cuh's
# attention): the attention forward recompute with its row statistics, then
# dq (with D and the rel-pos bias partials) and dk/dv in place of the one
# attention backward launch.
SWIN_BLOCK_BWD_BIG_LAUNCHES = 12
SWIN_BLOCK_BWD_RES_LAUNCHES = 10
LN_WMSA_BWD_LAUNCHES = 7
LN_MLP_BRANCH_LAUNCHES = 2
LN_MLP_LAUNCHES = 3                # fused_ln_mlp: LN, fc1, fc2 (csrc/ln_mlp.cu)
# fused_ln_window_attention: LN + qkv, attention, projection
# (csrc/ln_window_attention.cu)
LN_WMSA_LAUNCHES = 3
# wmsa_core: the same three without the LayerNorm (csrc/window_attention.cu)
WMSA_CORE_LAUNCHES = 3
LN_MLP_BWD_LAUNCHES = 5
# Widest C of the training sublayer kernels (the LN backward's rows).
SPLIT_TRAIN_MAX_C = 768


def _pad128(v: int) -> int:
    return -(-v // 128) * 128


# ---------------------------------------------------------------- launch plans
# of the cluster kernels (csrc/swin_cluster.cu for #1 and #2; gemm_tile.cuh's
# GEMM in csrc/ln_mlp.cu for #4 and csrc/ln_window_attention.cu for #3):
# cluster size and shared-memory bytes, in plain Python. A plan
# depends on one image's shape and not on the batch, so an image gives the
# same bits at any batch. The C entry points take the cluster size alone
# and lay out their shared memory from the same constants (the ring's
# slots and slot bytes are compile-time constants there).

SMEM_MAX = 232448     # dynamic shared memory of one CTA on the H100
CLUSTER_MAX = 8       # the portable thread-block cluster size
FILL_CTAS = 96        # CTAs a launch aims at: most of the H100's 132 SMs
WAVE_CTAS = 132       # one CTA per SM: the H100's SMs
PLAN_BATCH = 4        # the batch whose launch a plan sizes to FILL_CTAS
BLOCK_RING = (3, 24576)   # (slots, slot bytes): swin_cluster.cu kRingS, kRingSlot
MLP_RING = (4, 16384)     # gemm_tile.cuh kGemmRingS, kGemmRingSlot
_TILE = 64            # rows of a wgmma tile: one window, or 64 tokens
_BOX = 64             # columns of a weight box
_BOXES_PER_PRODUCT = 6   # 64-column boxes of one product (csrc/swin_cluster.cu kMaxBoxes)
_PRODUCT_BYTES = 40   # sizeof(hop::Product)
_CONSUMER_WGS = 3     # warpgroups of the block kernel (csrc/swin_cluster.cu kWG)


def _up(v: int, a: int) -> int:
    return -(-v // a) * a


def _cdiv(v: int, a: int) -> int:
    return -(-v // a)


def _boxes(cols: int) -> int:
    """64-column weight boxes of a product of ``cols`` columns."""
    return -(-cols // _BOX)


def _chunk_rows(slot: int, nb: int, K: int) -> int:
    """Rows per ring chunk of a product of nb weight boxes over K rows
    (``hop::chunk_rows``): the most k16 steps that fit a slot and divide K,
    at most 256; 0 when none does."""
    return next((bk for bk in range(256, 0, -16) if bk * nb * 128 <= slot and K % bk == 0), 0)


def _a_bytes(K: int) -> int:
    """Bytes of a 64 x K wgmma A operand: 8 KB panels of 64 columns."""
    return -(-K // 64) * _TILE * 128


def _block_carve(C: int, hidden: int, heads: int, G: int) -> tuple:
    """(offset of the ring, total bytes) of the cluster block kernel's
    dynamic shared memory (``block_carve`` in csrc/swin_cluster.cu), after
    1024 bytes of alignment slack: a header (token offsets, the ring's
    barriers, the product table), the CTA's bias columns and its q/k/v
    columns' offsets in the head buffers, x/y rows, the ring, the K-major A
    operand, the larger of the CTA's heads' q, k and v and the fc1 output,
    and the epilogues' staging tiles. The fc2 partial (64 x (C + 4) fp32)
    later takes the place of the ring and what follows it."""
    S, slot = BLOCK_RING
    cg, hg, hr, d = C // G, hidden // G, heads // G, C // heads
    ldq = _up(d, 16) + 8
    ring = (_up(_TILE * 8 + 16 * S + 4 * _PRODUCT_BYTES, 1024) + _up((7 * cg + hg) * 4, 1024)
            + _up(_TILE * (C + 8) * 2, 1024))
    abuf = _a_bytes(C)
    attn = _up(3 * hr * _TILE * ldq * 2, 128)
    h = _a_bytes(hg)
    staging = _CONSUMER_WGS * _TILE * (16 + 4) * 4   # each warpgroup's quarter box of sums
    return ring, 1024 + ring + S * slot + abuf + max(attn, h) + staging


@functools.lru_cache(maxsize=None)
def _cluster_sizes(C: int, hidden: int, heads: int) -> tuple:
    """((G, shared-memory bytes), ...) of every cluster size the block
    kernel takes for a block of this width, G ascending: G <= CLUSTER_MAX
    divides heads, C and hidden; each of the CTA's four products (q/k/v,
    proj, fc1, fc2) has at most six 64-column boxes; its shared memory fits
    SMEM_MAX. Empty for a width outside the design."""
    if (C % 16 or hidden % 16 or C % heads or C // heads > _TILE
            or _boxes(C) > _BOXES_PER_PRODUCT):
        return ()
    slot = BLOCK_RING[1]
    sizes = []
    for G in range(1, CLUSTER_MAX + 1):
        if heads % G or C % G or hidden % G:
            continue
        cg, hg = C // G, hidden // G
        nq, nh, nc = _boxes(cg), _boxes(hg), _boxes(C)
        if cg % 8 or hg % 16 or max(3 * nq, nh) > _BOXES_PER_PRODUCT:
            continue
        ring, smem = _block_carve(C, hidden, heads, G)
        chunks = (_chunk_rows(slot, 3 * nq, C), _chunk_rows(slot, nq, C),
                  _chunk_rows(slot, nh, C), _chunk_rows(slot, nc, hg))
        if smem <= SMEM_MAX and _TILE * (C + 4) * 4 <= smem - 1024 - ring and all(chunks):
            sizes.append((G, smem))
    return tuple(sizes)


def block_kernel_takes(C: int, hidden: int, heads: int) -> bool:
    """Whether the whole-block kernel has a cluster size for a block of
    width C, MLP width ``hidden`` and ``heads`` heads. The inference router
    sends a block within its cap that the kernel does not take (a head dim
    above 64, or no cluster size that divides the heads) to the split
    LN+W-MSA / LN+MLP kernels, as it sends the wider ones; a training call
    takes the sequence form there (:func:`seq_form`)."""
    return bool(_cluster_sizes(C, hidden, heads))


def cluster_takes(C: int, hidden: int, heads: int, ws: int) -> bool:
    """Whether :func:`fused_swin_block` runs the block on the cluster kernel
    (csrc/swin_cluster.cu): windows up to 64 tokens, C <= BLOCK_KERNEL_MAX_C
    and a cluster size (:func:`block_kernel_takes`)."""
    return ws * ws <= _TILE and C <= BLOCK_KERNEL_MAX_C and block_kernel_takes(C, hidden, heads)


def seq_form(C: int, hidden: int, heads: int, ws: int, train: bool) -> bool:
    """Whether a :func:`fused_swin_block` call takes the sequence form
    (csrc/swin_block_seq.cu): above 64 tokens a window always; up to 64 a
    training call (drop-path scales given) of a block the cluster kernel
    does not take (:func:`cluster_takes`: C above 384, a head dim above
    64, no cluster size), JAX's train route up to its cap of 768. An
    inference call there is refused, as JAX's inference cap is 384."""
    return ws * ws > _TILE or (train and not cluster_takes(C, hidden, heads, ws))


@functools.lru_cache(maxsize=None)
def block_plan(H: int, W: int, C: int, hidden: int, ws: int, heads: int) -> dict:
    """Launch plan of the cluster block kernel for (H, W, C) images: the
    smallest cluster size G (CTAs per window, :func:`_cluster_sizes`) whose
    launch at PLAN_BATCH images has at least FILL_CTAS CTAs, or the largest
    G when none does. Returns G, the shared-memory bytes of a CTA and the
    CTAs per image. Raises ValueError on a shape outside the design."""
    N = ws * ws
    why = None
    if N % 16 or N > _TILE:
        why = f"window of {N} tokens (the kernel takes N % 16 == 0, N <= {_TILE})"
    elif C % 16 or C % heads or hidden % 16:
        why = "C and hidden must be multiples of 16 and C of heads"
    elif _boxes(C) > _BOXES_PER_PRODUCT:
        why = f"C above {_BOX * _BOXES_PER_PRODUCT} (fc2's output columns)"
    elif C // heads > _TILE:
        why = f"head dim {C // heads} above {_TILE}"
    elif not _cluster_sizes(C, hidden, heads):
        why = (f"no cluster size up to {CLUSTER_MAX} divides heads, C and hidden with its "
               f"columns and shared memory ({SMEM_MAX} bytes) in the design")
    if why:
        raise ValueError(f"block_plan: C={C}, hidden={hidden}, heads={heads}, ws={ws}: {why}")
    windows = (H // ws) * (W // ws)
    G, smem = next(((G, m) for G, m in _cluster_sizes(C, hidden, heads)
                    if PLAN_BATCH * windows * G >= FILL_CTAS),
                   _cluster_sizes(C, hidden, heads)[-1])
    return {"G": G, "smem": smem, "ctas_per_image": windows * G}


def mlp_smem(K: int) -> int:
    """Shared-memory bytes of one launch of gemm_tile.cuh's GEMM over K
    rows of W: slack, header, ring, the 64 x K A operand."""
    S, slot = MLP_RING
    return 1024 + 1024 + S * slot + _a_bytes(K)


def _k_splits(M: int, K: int, ncols: int) -> list:
    """(ks, shared-memory bytes, CTAs at PLAN_BATCH images of M rows) of
    every K split gemm_tile.cuh's GEMM takes for a product of K rows of W
    and ncols columns on 64 x 128 tiles: ks (its cluster size) a power of
    two <= CLUSTER_MAX dividing K / 16 (and 128), its 64 x K/ks operand
    within SMEM_MAX, its ring chunks a whole number of k16 steps."""
    slot = MLP_RING[1]
    ctas = -(-PLAN_BATCH * M // _TILE) * -(-ncols // 128)
    splits, ks = [], 1
    while ks <= CLUSTER_MAX:
        if (K % (16 * ks) == 0 and mlp_smem(K // ks) <= SMEM_MAX
                and _chunk_rows(slot, 2, K // ks)):
            splits.append((ks, mlp_smem(K // ks), ctas * ks))
        ks *= 2
    return splits


def _fill(splits: list) -> tuple:
    """The smallest K split whose launch at PLAN_BATCH images has at least
    FILL_CTAS CTAs, or the largest when none does; of those with at most
    WAVE_CTAS CTAs (one CTA per SM, one wave) where any has, since a split
    past it runs a second wave."""
    if any(s[2] <= WAVE_CTAS for s in splits):
        splits = [s for s in splits if s[2] <= WAVE_CTAS]
    return next((s for s in splits if s[2] >= FILL_CTAS), splits[-1])


@functools.lru_cache(maxsize=None)
def mlp_plan(M: int, C: int, hidden: int) -> dict:
    """Launch plan of fused_ln_mlp's two products for images of M token
    rows each, on 64 x 128 tiles: fc1 times a K split ks1 and fc2 times a
    K split ks (their cluster sizes, each by :func:`_fill` over
    :func:`_k_splits`; fc1's split only where its 64 x C operand does not
    fit, C=1440 of the scaled config). Raises ValueError on a shape outside
    the design."""
    if M <= 0 or C % 16 or hidden % 16:
        raise ValueError(f"mlp_plan: M={M} rows per image, C={C}, hidden={hidden}: the kernel "
                         "takes M > 0 and multiples of 16")
    fc1 = _k_splits(M, C, hidden)
    if not fc1:
        raise ValueError(f"mlp_plan: C={C}: fc1's 64 x C operand does not fit {SMEM_MAX} "
                         "bytes at any K split")
    splits = _k_splits(M, hidden, C)
    if not splits:
        raise ValueError(f"mlp_plan: hidden={hidden}: no K split fits {SMEM_MAX} bytes")
    ks1, smem1, ctas1 = _fill(fc1)
    ks, smem, ctas = _fill(splits)
    return {"ks": ks, "ks1": ks1, "smem_fc1": smem1, "smem_fc2": smem,
            "ctas_fc1": ctas1, "ctas_fc2": ctas}


# Windows above 64 tokens (WIN 16: 256) in the forward kernels: the
# attention launch of csrc/wmsa_attn.cuh's second form (a CTA of four warps
# per 64 query rows of a (window, head), two passes over the keys) takes N
# a multiple of 64 up to BIG_WINDOW_MAX_TOKENS and a head dim up to
# BIG_WINDOW_MAX_HEAD_DIM (kTokBig, kDcBig); so does the block backward's
# big-window form (csrc/block_bwd_big.cuh kBigMaxTok, kBigMaxD).
BIG_WINDOW_MAX_TOKENS = 256
BIG_WINDOW_MAX_HEAD_DIM = 64
# fused_swin_block on such windows (csrc/swin_block_seq.cu): LN1 + qkv, the
# attention, proj + the residual, LN2 + fc1, fc2 + the residual.
SWIN_BLOCK_SEQ_LAUNCHES = 5
# Finer counts of two wrappers' launches by form (added where the launches
# are, beside the wrapper's own count): the sequence form's train form at
# windows up to 64 tokens (fused_swin_block's), and the recompute block
# backward at a head dim above BWD_RES_MAX_HEAD_DIM (swin_block_bwd's).
SEQ64_FORM = "fused_swin_block[train64]"
BWD_WIDE_HEAD_FORM = "swin_block_bwd[wide_head]"


def window_why(N: int, d: int) -> Optional[str]:
    """Why the forward window kernels do not take windows of N tokens at
    head dim d (None when they do): N a multiple of 16 up to 64 (one wgmma
    tile, the attention's registers), or above that a multiple of 64 up to
    BIG_WINDOW_MAX_TOKENS at a head dim up to BIG_WINDOW_MAX_HEAD_DIM."""
    if N <= 0 or N % 16:
        return f"window of {N} tokens (the kernels take N % 16 == 0)"
    if N <= _TILE:
        return None
    if N % _TILE or N > BIG_WINDOW_MAX_TOKENS:
        return (f"window of {N} tokens (above {_TILE} the kernels take multiples of {_TILE} "
                f"up to {BIG_WINDOW_MAX_TOKENS})")
    if d > BIG_WINDOW_MAX_HEAD_DIM:
        return f"head dim {d} above {BIG_WINDOW_MAX_HEAD_DIM} at {N} tokens"
    return None


def attn_big_smem(N: int, d: int) -> int:
    """Dynamic shared memory of the big-window attention launch
    (``wmsa::big_smem``): the token offsets, the CTA's 64 q rows and the N
    k rows of dp + 8 bf16, v^T as dp rows of N + 8; dp is the head dim
    rounded up to 16."""
    dp = _up(d, 16)
    return N * 8 + (_TILE + N) * (dp + 8) * 2 + dp * (N + 8) * 2


def kpad(C: int) -> int:
    """The depth of a product over C-wide rows: C, or where C is not a
    multiple of 16 (the k16 steps) C rounded up to whole 64-column panels
    (C=180 -> 192); A's columns past C are zeros in shared memory and W's
    rows past C are TMA's zero fill."""
    return C if C % 16 == 0 else _up(C, 64)


def wcols(n: int) -> int:
    """Columns a weight matrix of n columns is stored with for the kernels:
    n rounded up to 8, so that its rows are whole 16-byte units (TMA's
    global stride); the pad columns are zeros (C=180: wqkv 540 -> 544,
    wproj and w2 180 -> 184)."""
    return _up(n, 8)


def _seq_why(H: int, W: int, C: int, hidden: int, ws: int, heads: int,
             train: bool = False) -> Optional[str]:
    N = ws * ws
    if H % ws or W % ws:
        return f"({H},{W}) not divisible by window {ws}"
    if N <= _TILE and not train:
        return (f"window of {N} tokens: the cluster form (block_plan) takes N <= {_TILE}; the "
                "sequence form takes it in training alone")
    if C % 4 or heads <= 0 or C % heads or hidden % 16:
        return ("C must be a multiple of 4 (8-byte row chunks) and of heads, hidden of 16")
    why = window_why(N, C // heads)
    if why:
        return why
    Kp = kpad(C)
    for name, K, cols in (("qkv", Kp, 3 * C), ("proj", Kp, C), ("fc1", Kp, hidden),
                          ("fc2", hidden, C)):
        if not _k_splits(H * W, K, cols):
            return f"no K split of {name}'s {K}-deep product fits {SMEM_MAX} bytes"
    if N > _TILE and attn_big_smem(N, C // heads) > SMEM_MAX:
        return f"the attention's shared memory at {N} tokens exceeds {SMEM_MAX} bytes"
    return None


def block_seq_takes(C: int, hidden: int, heads: int, ws: int, train: bool = False) -> bool:
    """Whether the sequence form of the block kernel takes blocks of width
    C, MLP width ``hidden``, ``heads`` heads and window ``ws`` (on a map of
    one window; the router's question); ``train``: a training call, which
    it also takes at windows up to 64 tokens."""
    return _seq_why(ws, ws, C, hidden, ws, heads, train) is None


@functools.lru_cache(maxsize=None)
def block_seq_plan(H: int, W: int, C: int, hidden: int, ws: int, heads: int,
                   train: bool = False) -> dict:
    """Launch plan of :func:`fused_swin_block`'s sequence form
    (csrc/swin_block_seq.cu) for (H, W, C) images with windows above 64
    tokens, or with ``train`` (its train form) at any window: the depth Kp
    of the C-deep products (:func:`kpad`), the K splits of qkv (ksq), proj
    (ksp), fc1 (ks1) and fc2 (ks2), each by :func:`_fill` over
    :func:`_k_splits` of one image's rows, the attention's dynamic shared
    memory (0 up to 64 tokens: wmsa_attn.cuh's attn_kernel, static) and
    the CTAs of each launch at PLAN_BATCH images. A function of one image's
    shape, never the batch. Raises ValueError on a shape outside the
    design."""
    why = _seq_why(H, W, C, hidden, ws, heads, train)
    if why:
        raise ValueError(f"block_seq_plan: H={H}, W={W}, C={C}, hidden={hidden}, ws={ws}, "
                         f"heads={heads}: {why}")
    M, Kp, N = H * W, kpad(C), ws * ws
    plan = {"Kp": Kp, "attn_smem": attn_big_smem(N, C // heads) if N > _TILE else 0,
            "ctas_attn": PLAN_BATCH * (M // N) * heads * max(1, N // _TILE)}
    for split, product, K, cols in (("ksq", "qkv", Kp, 3 * C), ("ksp", "proj", Kp, C),
                                    ("ks1", "fc1", Kp, hidden), ("ks2", "fc2", hidden, C)):
        plan[split], plan["smem_" + product], plan["ctas_" + product] = _fill(
            _k_splits(M, K, cols))
    return plan


def block_launches(ws: int, seq: bool = False) -> int:
    """Kernel launches of one :func:`fused_swin_block` call with window
    ``ws``: the cluster form's one (or the float32 form's, also one), or
    the sequence form's SWIN_BLOCK_SEQ_LAUNCHES above 64 tokens or where
    ``seq`` (:func:`seq_form`) says the call takes it."""
    return SWIN_BLOCK_SEQ_LAUNCHES if seq or ws * ws > _TILE else 1


def train_block_launches(C: int, hidden: int, heads: int, ws: int) -> int:
    """Kernel launches of one training call of :func:`fused_swin_block`
    (drop-path scales given) for the block: :func:`block_launches` of the
    form :func:`seq_form` picks."""
    return block_launches(ws, seq_form(C, hidden, heads, ws, True))


# ---------------------------------------------------------------- float32 forms
# of #1/#2 (csrc/f32_swin_block.cu: one launch, a CTA per window), #3 and #4
# (csrc/f32_block.cu) and #5 (csrc/f32_up4.cu, kernels/upsample.py): FFMA
# products, #3-#5 as sequences of launches of csrc/f32_tile.cuh's token-row
# product (64 x 64 output tiles, no K split) with, for #3, a float32
# attention kernel per (window, head). Each launches as many kernels a call
# as its bf16 form (#3: LN + qkv, attention, proj; #4: the LN statistics,
# fc1 + GELU on LN(y), fc2 + y; #5: one cooperative launch over its five
# phases), so one router prediction holds for both dtypes. A plan is a
# function of one image's shape: every output element is one thread's sum
# in one order, so an image gets the same bits at any batch.
F32_TILE = (64, 64)          # f32_tile.cuh kBM, kBN
# the widths #1's float32 kernel is built for (a template on C / 32:
# f32_swin_block.cu's switch), and its hidden chunk
F32_BLOCK_WIDTHS = (32, 64, 96, 128, 192, 256, 384)
_F32_HID_CHUNK = 64
# the product tile's static shared memory (f32_tile.cuh gemm_kernel): A and
# W stages of 16 x (64 + 4) floats, the rows' offsets and LN statistics
F32_GEMM_SMEM = 2 * 16 * (64 + 4) * 4 + 64 * 8 + 2 * 64 * 4
# the wrappers whose CUDA kernels have a float32 form (the inference forms of
# #1-#5); every other wrapper's kernel takes bfloat16 alone
F32_WRAPPERS = ("fused_swin_block", "fused_swin_block_chain", "fused_ln_window_attention",
                "fused_ln_mlp", "fused_dual_upsample4_conv_phase")
# ROADMAP B2's open items, named where a float32 call is refused
F32_TRAIN_ITEM = ("ROADMAP B2, 'float32 training forms' (#6/#7, #1's train form + #8, #9, "
                  "#12/#13/#14, #11)")
F32_SEQ_ITEM = ("ROADMAP B2, 'the sequence form and #3/#4 at scaled_config()'s widths and "
                "256-token windows in float32'")
F32_SPLIT_HEAD_ITEM = "ROADMAP B2, '#10 (the split x4 head) in float32'"
F32_WMSA_CORE_ITEM = "ROADMAP B2, '#15 (the standalone W-MSA) in float32'"
F32_SPATIAL_ITEM = "ROADMAP B2, 'the spatial runner in float32'"
F32_DYNMASK_ITEM = F32_SPATIAL_ITEM + " (the B5 dynmask form)"
F16_ITEM = "ROADMAP B2, 'TPU.COMPUTE_DTYPE: float16'"
# where a wrapper outside F32_WRAPPERS is refused float32
_F32_ITEMS = {"fused_dual_upsample4": F32_SPLIT_HEAD_ITEM, "wmsa_core": F32_WMSA_CORE_ITEM,
              "swin_block_trainable_dynmask": F32_DYNMASK_ITEM}


def dtype_why(name: str, dtype: torch.dtype, *, tokens: int = 0,
              train: bool = False) -> Optional[str]:
    """Why wrapper ``name``'s CUDA kernel does not take tensors of ``dtype``
    (None when it does), naming the ROADMAP item that would: bfloat16
    everywhere; float32 in the inference forms of #1-#5 (F32_WRAPPERS) at
    windows of ``tokens`` <= 64 without drop-path scales or a training
    caller (``train``); float16 and float64 nowhere (float64 runs on the
    eager route and the plain versions)."""
    if dtype == BF16:
        return None
    eager = "; use backend='eager'"
    if dtype == torch.float32:
        if name not in F32_WRAPPERS:
            item = _F32_ITEMS.get(name, F32_TRAIN_ITEM)
            return f"{name}: the CUDA kernel takes bfloat16, got float32 ({item}){eager}"
        if train:
            return (f"{name}: the float32 form is an inference form; training in float32 is "
                    f"{F32_TRAIN_ITEM}{eager}")
        if tokens > _TILE:
            return (f"{name}: the float32 form takes windows up to {_TILE} tokens, got "
                    f"{tokens} ({F32_SEQ_ITEM}){eager}")
        return None
    if dtype == torch.float16:
        return f"{name}: no CUDA kernel takes float16 ({F16_ITEM}){eager}"
    return (f"{name}: no CUDA kernel takes {dtype} (float64 runs on the eager route and the "
            f"plain versions){eager}")


def _gate(name: str, x: torch.Tensor, *, tokens: int = 0, train: bool = False):
    """Raise :func:`dtype_why`'s NotImplementedError where ``name``'s CUDA
    kernel does not take x's dtype; a CPU tensor runs the plain version in
    any dtype."""
    if x.device.type == "cuda":
        why = dtype_why(name, x.dtype, tokens=tokens, train=train)
        if why:
            raise NotImplementedError(why)


def f32_attn_smem(N: int, d: int) -> int:
    """Dynamic shared memory of the float32 attention kernel
    (``f32::attn_smem``): q * scale and k transposed, v, the N x (N + 1)
    scores and the row sums, float32."""
    return (3 * d * N + N * (N + 1) + N) * 4


def _f32_ctas(M: int, cols: int) -> int:
    """CTAs of one f32_tile.cuh product over PLAN_BATCH images of M rows."""
    return _cdiv(PLAN_BATCH * M, F32_TILE[0]) * _cdiv(cols, F32_TILE[1])


def _f32_window_why(H: int, W: int, C: int, ws: int, heads: int) -> Optional[str]:
    N = ws * ws
    if N <= 0 or N % 16 or N > _TILE:
        return f"window of {N} tokens (the float32 forms take N % 16 == 0, N <= {_TILE})"
    if H % ws or W % ws:
        return f"({H},{W}) not divisible by window {ws}"
    if C % 16 or heads <= 0 or C % heads:
        return "C must be a multiple of 16 and of heads"
    if f32_attn_smem(N, C // heads) > SMEM_MAX:
        return (f"head dim {C // heads}: the attention's {f32_attn_smem(N, C // heads)} bytes "
                f"exceed {SMEM_MAX}")
    return None


def f32_block_smem(C: int, Gc: int) -> int:
    """Dynamic shared memory of #1's float32 kernel (``block_carve`` in
    csrc/f32_swin_block.cu): a 16-row weight stage of max(C, 64) + 4
    floats, the window's 64 rows of C + 4, the 64 x 65 scores, their row
    sums and the LN statistics, and the head group's q/k/v (or a hidden
    chunk) as 64 rows of max(3 Gc, 64) + 1."""
    ldw, ldx, ldt = max(C, _F32_HID_CHUNK) + 4, C + 4, max(3 * Gc, _F32_HID_CHUNK) + 1
    return (16 * ldw + _TILE * ldx + _TILE * (_TILE + 1) + 3 * _TILE + _TILE * ldt) * 4


@functools.lru_cache(maxsize=None)
def f32_block_plan(H: int, W: int, C: int, hidden: int, ws: int, heads: int) -> dict:
    """Launch plan of #1's float32 form (csrc/f32_swin_block.cu, one launch,
    a CTA per window) for (H, W, C) images: Gc, the channels of a head
    group whose q, k and v it makes at a time (lcm(head dim, 32)), its
    shared-memory bytes and CTAs per image. Raises ValueError on a shape
    outside the design."""
    why = _f32_window_why(H, W, C, ws, heads)
    if why is None and C not in F32_BLOCK_WIDTHS:
        why = f"C not among the widths the kernel is built for, {F32_BLOCK_WIDTHS}"
    if why is None and (hidden <= 0 or hidden % _F32_HID_CHUNK):
        why = f"hidden must be a multiple of {_F32_HID_CHUNK}"
    Gc = 0
    if why is None:
        d = C // heads
        Gc = d // math.gcd(d, 32) * 32
        if C % Gc:
            why = f"head groups of lcm({d}, 32) = {Gc} channels do not divide C"
        elif f32_block_smem(C, Gc) > SMEM_MAX:
            why = f"{f32_block_smem(C, Gc)} bytes of shared memory exceed {SMEM_MAX}"
    if why:
        raise ValueError(f"f32_block_plan: H={H}, W={W}, C={C}, hidden={hidden}, ws={ws}, "
                         f"heads={heads}: {why}")
    return {"Gc": Gc, "smem": f32_block_smem(C, Gc), "ctas_per_image": (H // ws) * (W // ws)}


@functools.lru_cache(maxsize=None)
def f32_wmsa_plan(H: int, W: int, C: int, heads: int, ws: int) -> dict:
    """Launch plan of #3's float32 form (csrc/f32_block.cu, LN_WMSA_LAUNCHES
    launches): shared-memory bytes and CTAs at PLAN_BATCH images. Raises
    ValueError on a shape outside the design."""
    why = _f32_window_why(H, W, C, ws, heads)
    if why:
        raise ValueError(f"f32_wmsa_plan: H={H}, W={W}, C={C}, heads={heads}, ws={ws}: {why}")
    M, N = H * W, ws * ws
    return {"smem_gemm": F32_GEMM_SMEM,
            "smem_attn": f32_attn_smem(N, C // heads),
            "ctas": {"qkv": _f32_ctas(M, 3 * C), "attn": PLAN_BATCH * (M // N) * heads,
                     "proj": _f32_ctas(M, C)}}


@functools.lru_cache(maxsize=None)
def f32_mlp_plan(M: int, C: int, hidden: int) -> dict:
    """Launch plan of #4's float32 form (csrc/f32_block.cu, LN_MLP_LAUNCHES) for
    images of M token rows. Raises ValueError on a shape outside the
    design."""
    if M <= 0 or C <= 0 or C % 16 or hidden <= 0 or hidden % 16:
        raise ValueError(f"f32_mlp_plan: M={M}, C={C}, hidden={hidden}: the float32 form "
                         "takes M > 0 and multiples of 16")
    return {"smem_gemm": F32_GEMM_SMEM,
            "ctas": {"stats": _cdiv(PLAN_BATCH * M, 8), "fc1": _f32_ctas(M, hidden),
                     "fc2": _f32_ctas(M, C)}}


@functools.lru_cache(maxsize=None)
def wmsa_plan(H: int, W: int, C: int, heads: int, ws: int) -> dict:
    """Launch plan of fused_ln_window_attention for (H, W, C) images: the K
    splits of its qkv product (ksq) and of the projection (ks), each by
    :func:`_fill` over :func:`_k_splits`, and the CTAs of
    each launch at PLAN_BATCH images (the attention: one per window and
    head, times N / 64 above 64 tokens). A function of one image's shape,
    never the batch. Raises ValueError on a shape outside the design."""
    N = ws * ws
    why = (f"({H},{W}) not divisible by the window" if H % ws or W % ws
           else window_why(N, C // max(heads, 1)))
    if why is None and (C % 16 or C % heads or C > 2048):
        why = "C must be a multiple of 16 and of heads, at most 2048"
    if why is None and not _k_splits(H * W, C, 3 * C):
        why = f"no K split of the {C}-deep products fits {SMEM_MAX} bytes"
    if why:
        raise ValueError(f"wmsa_plan: H={H}, W={W}, C={C}, heads={heads}, ws={ws}: {why}")
    ksq, smem_qkv, ctas_qkv = _fill(_k_splits(H * W, C, 3 * C))
    ks, smem_proj, ctas_proj = _fill(_k_splits(H * W, C, C))
    return {"ksq": ksq, "ks": ks, "smem_qkv": smem_qkv, "smem_proj": smem_proj,
            "ctas_qkv": ctas_qkv,
            "ctas_attn": PLAN_BATCH * (H // ws) * (W // ws) * heads * max(1, N // _TILE),
            "ctas_proj": ctas_proj}


# The block backward's kernels (csrc/block_bwd_hopper.cuh, the launch
# sequence in csrc/swin_block_bwd.cuh): token GEMMs on 64-row x 128-column
# tiles with a ring of (A box, two B boxes) of 64 x 64 bf16, the LN
# backward epilogues on a cluster of ceil(C / 128) CTAs per row tile, the
# weight gradients in token chunks, the attention per (head, chunk of
# windows) on four warps.
BWD_RING = (3, 3 * 8192)   # block_bwd_hopper.cuh kRingS, kSlot
_BWD_HEAD = 4096           # kHead: barriers, the LN row sums, the rows' RowInfo
_BWD_COLS = 128            # kCols: output columns of a token-GEMM CTA
BWD_FILL_CTAS = 264        # kFillCtas: CTAs the weight-gradient launch aims at (2 per SM)
BWD_ATTN_FILL_CTAS = 528   # kAttnFillCtas: CTAs the attention backward aims at (4 per SM)
BWD_MAX_C = 768            # a cluster of at most 6 CTAs owns a row
# The block backward's head dim. The residual route (#7): its per-pair t
# sums hold 32 column pairs. The recompute form (#8) and the LN+W-MSA
# backward (#12) run attn_tc_kernel's recompute modes, whose head dim shared
# memory alone bounds (_attn_bwd_why: an even head dim up to 192 at 64
# tokens). The big-window form: BIG_WINDOW_MAX_HEAD_DIM.
BWD_RES_MAX_HEAD_DIM = 64


def _bwd_tok_smem(K: int, a_in_smem: bool) -> int:
    """Shared-memory bytes of one token GEMM of the block backward
    (``bb::tok_smem``): slack, header, ring, and A (64 x K) when the CTA
    computes it (the LN, dm and round(ctx_f) A loads)."""
    S, slot = BWD_RING
    return 1024 + _BWD_HEAD + S * slot + (_a_bytes(K) if a_in_smem else 0)


def _attn_smem(N: int, d: int) -> tuple:
    """(forward, backward) shared-memory bytes of the block backward's
    attention (``bb::attn_layout``): q, k (and v, dctx) as N rows of dp + 8
    bf16, k^T (v^T), q^T and dctx^T as dp rows of N + 8, round(P)^T and
    round(ds)^T as N rows of N + 8, then the backwards' floats (the
    residual route's 64 x 32 pair sums, four warps' and the chunk's q, k,
    v column sums, dp each); dp is the head dim rounded up to 16."""
    dp = _up(d, 16)
    rd, tn, nn = (_pad128(N * (dp + 8) * 2), _pad128(dp * (N + 8) * 2),
                  _pad128(N * (N + 8) * 2))
    fwd = 2 * rd + tn
    return fwd, fwd + 2 * rd + 2 * tn + 2 * nn + (64 * 32 + 4 * 3 * dp + 3 * dp) * 4


def _bwd_products(C: int, hidden: int) -> tuple:
    """(M, N) of the block's four weight gradients in the weight-gradient
    launch's order: dw2, dw1, dwproj, dwqkv."""
    return ((hidden, C), (C, hidden), (C, C), (C, 3 * C))


def _wg_tiles(M: int, N: int) -> int:
    """64 x 128 output tiles of an M x N weight gradient."""
    return _cdiv(M, _TILE) * _cdiv(N, _BWD_COLS)


def _attn_bwd_why(d: int, N: int) -> Optional[str]:
    """Why the recompute attention of the backward kernels (attn_tc_kernel)
    does not take head dim d at N tokens: an odd head dim, or operands
    beyond shared memory."""
    if d % 2:
        return f"head dim {d} is odd (the attention loads column pairs)"
    smem = _attn_smem(N, d)[1]
    if smem > SMEM_MAX:
        return (f"head dim {d} needs {smem} bytes of the attention's shared memory at "
                f"{N} tokens, above {SMEM_MAX}")
    return None


def _bwd_width_why(C: int, hidden: int, heads: int, N: int, *, res: bool = False,
                   big: bool = False) -> Optional[str]:
    align = 4 if big else 16
    if C % align or hidden % 16 or hidden <= 0:
        if align == 16:
            return f"C={C} and hidden={hidden} must be multiples of 16"
        return f"C={C} must be a multiple of {align} and hidden={hidden} of 16"
    if C > BWD_MAX_C:
        return f"C={C} above {BWD_MAX_C} (a cluster of at most 6 CTAs owns a row)"
    if heads <= 0 or C % heads:
        return f"C={C} not divisible by {heads} heads"
    d = C // heads
    if big:
        if d > BIG_WINDOW_MAX_HEAD_DIM:
            return f"head dim {d} above {BIG_WINDOW_MAX_HEAD_DIM}"
        if d % 2:
            return f"head dim {d} is odd (the attention loads column pairs)"
        return None
    if res and d > BWD_RES_MAX_HEAD_DIM:
        return (f"head dim {d} above {BWD_RES_MAX_HEAD_DIM} (the residual route's per-pair "
                "sums)")
    return _attn_bwd_why(d, N)


def block_bwd_width(C: int, ws: int) -> int:
    """The width of the rows the block backward's kernels run over: C, or
    above 64 tokens a window C rounded up to 16 (C=180 -> 192, C=360 ->
    368), the pad channels zeros that the wrapper adds and takes off."""
    return C if ws * ws <= _TILE else _up(C, 16)


def block_bwd_why(C: int, hidden: int, heads: int, ws: int, res: bool = False) -> Optional[str]:
    """Why the block backward's kernels do not take a block of width C, MLP
    width ``hidden``, ``heads`` heads and window ``ws`` (None when they do);
    ``res``: the residual route's (#7), else the recompute form's (#8).
    Up to 64 tokens the window's rule is every window kernel's
    (``_check_window``), C a multiple of 16 up to BWD_MAX_C and an even head
    dim whose attention operands fit SMEM_MAX (up to 192 at 64 tokens), at
    most BWD_RES_MAX_HEAD_DIM on the residual route; above, the big-window
    form (csrc/block_bwd_big.cuh): N a multiple of 64 up to
    BIG_WINDOW_MAX_TOKENS, C a multiple of 4 up to BWD_MAX_C (run over
    :func:`block_bwd_width`), an even head dim up to
    BIG_WINDOW_MAX_HEAD_DIM whose launches fit SMEM_MAX."""
    N = ws * ws
    if N <= _TILE:
        if N % 16 or N == 0:
            return f"window {ws} gives {N} tokens; the kernel takes 16, 32, 48 or 64"
        return _bwd_width_why(C, hidden, heads, N, res=res)
    if N % _TILE or N > BIG_WINDOW_MAX_TOKENS:
        return (f"window {ws} gives {N} tokens; above {_TILE} the kernel takes multiples of "
                f"{_TILE} up to {BIG_WINDOW_MAX_TOKENS}")
    why = _bwd_width_why(C, hidden, heads, N, big=True)
    if why is None and max(_big_attn_smem(N, C // heads)) > SMEM_MAX:
        why = f"the big-window attention's shared memory at {N} tokens exceeds {SMEM_MAX} bytes"
    return why


def block_bwd_takes(C: int, hidden: int, heads: int, ws: int = 8, res: bool = False) -> bool:
    """Whether the block backward's kernels take a block of width C, MLP
    width ``hidden``, ``heads`` heads and window ``ws`` (the router's
    question; ``res``: the residual route's kernels). Up to 64 tokens the
    window's rule is every window kernel's, the split kernels' too; above,
    whether the big-window form takes it (:func:`block_bwd_why`)."""
    N = ws * ws
    if N <= _TILE:
        return _bwd_width_why(C, hidden, heads, N, res=res) is None
    return block_bwd_why(C, hidden, heads, ws) is None


def block_bwd_launches(ws: int) -> int:
    """Kernel launches of one :func:`swin_block_bwd` call with window ws:
    SWIN_BLOCK_BWD_LAUNCHES, or SWIN_BLOCK_BWD_BIG_LAUNCHES above 64 tokens."""
    return SWIN_BLOCK_BWD_LAUNCHES if ws * ws <= _TILE else SWIN_BLOCK_BWD_BIG_LAUNCHES


def _big_attn_smem(N: int, d: int) -> tuple:
    """(forward, dq, dk/dv) shared-memory bytes of the big-window block
    backward's attention launches (``bb::big_fwd_smem``, ``big_dq_smem``,
    ``big_dkv_smem``): bf16 rows of dp + 8, transposed rows of N + 8, the
    dq launch's 64 x (N + 4) fp32 rel-pos bias rows, the statistics and
    column sums; dp is the head dim rounded up to 16."""
    dp = _up(d, 16)
    r64, rN, tN = (_pad128(_TILE * (dp + 8) * 2), _pad128(N * (dp + 8) * 2),
                   _pad128(dp * (N + 8) * 2))
    return (r64 + rN + tN, 2 * r64 + 2 * rN + tN + _TILE * (N + 4) * 4 + 5 * dp * 4,
            2 * r64 + 2 * rN + 2 * tN + 3 * N * 4 + 10 * dp * 4)


@functools.lru_cache(maxsize=None)
def block_bwd_plan(H: int, W: int, C: int, hidden: int, ws: int, heads: int) -> dict:
    """Launch plan of the block backward (#7, #8) for (H, W, C) images, a
    function of one image's shape (``bwd_plan`` in csrc/swin_block_bwd.cuh
    mirrors it): the LN backward epilogues' cluster size G (CTAs per 64
    rows), the 128-column tiles per CTA of the two products whose A is a
    LayerNorm (LN1 + qkv, LN2 + fc1: the LN computed once for as many tiles
    as keep ~BWD_FILL_CTAS CTAs at PLAN_BATCH images), the
    weight-gradient launch's tokens per chunk (a multiple of
    64, ~BWD_FILL_CTAS CTAs at PLAN_BATCH images) and 64 x 128 tiles per
    product, the attention's windows per chunk (~BWD_ATTN_FILL_CTAS CTAs
    over the heads at PLAN_BATCH images) and each launch's shared-memory
    bytes.
    Raises ValueError on a shape outside the design, with the wrappers'
    reason."""
    why = block_bwd_why(C, hidden, heads, ws)
    if why is None and (H % ws or W % ws):
        why = f"({H},{W}) not divisible by window {ws}"
    if why:
        raise ValueError(f"block_bwd_plan: H={H}, W={W}, C={C}, hidden={hidden}, ws={ws}, "
                         f"heads={heads}: {why}")
    Cp = block_bwd_width(C, ws)
    tiles = tuple(_wg_tiles(M, N) for M, N in _bwd_products(Cp, hidden))
    plan = _bwd_plan_of(H, W, Cp, ws, heads, tiles, {"qkv": 3 * Cp, "fc1": hidden},
                        head_dim=C // heads)
    plan["Cp"] = Cp
    return plan


def _bwd_plan_of(H: int, W: int, C: int, ws: int, heads: int, tiles: tuple,
                 ln_cols: dict, head_dim: Optional[int] = None) -> dict:
    """The plan of a launch sequence on the block backward's kernels whose
    weight-gradient launch has ``tiles`` output tiles per product and whose
    LN A loads produce ``ln_cols`` columns (``bwd_chunks`` in
    csrc/swin_block_bwd.cuh); above 64 tokens a window the attention's
    chunks count its nq = N / 64 row blocks per (window, head) and
    ``head_dim`` (the real width over the heads) sizes its launches."""
    hw, nW, N = H * W, (H // ws) * (W // ws), ws * ws
    nq = N // _TILE if N > _TILE else 1
    per = max(1, _cdiv(BWD_FILL_CTAS, sum(tiles)))
    chunk = _TILE * _cdiv(_cdiv(PLAN_BATCH * hw, _TILE), per)
    wpc = _cdiv(PLAN_BATCH * nW, max(1, BWD_ATTN_FILL_CTAS // (heads * nq)))
    rows = _cdiv(PLAN_BATCH * hw, _TILE)
    tpc = {name: min(t, max(1, _cdiv(t * rows, BWD_FILL_CTAS)))
           for name, t in ((n, _cdiv(cols, _BWD_COLS)) for n, cols in ln_cols.items())}
    smem = {"gemm_a_in_smem": _bwd_tok_smem(C, True), "gemm_a_by_tma": _bwd_tok_smem(0, False),
            "wgrad": _bwd_tok_smem(0, False)}
    if nq > 1:
        smem["attn_fwd"], smem["attn_dq"], smem["attn_dkv"] = _big_attn_smem(
            N, head_dim or C // heads)
    else:
        smem["attn_fwd"], smem["attn"] = _attn_smem(N, C // heads)
    return {"G": _cdiv(C, _BWD_COLS), "chunk_tokens": chunk, "wgrad_tiles": tiles,
            "windows_per_chunk": wpc, "tiles_per_cta": tpc, "smem": smem, "nq": nq}


def block_bwd_wgrad_table(H: int, W: int, C: int, hidden: int, ws: int, heads: int,
                          B: int) -> list:
    """The weight-gradient launch's table at batch B, CTA by CTA, as
    ``bb::wgrad_kernel`` decodes blockIdx.x: (product, 64-row tile of M,
    128-column tile of N, token chunk); products in order, then tiles (the
    row tile fastest), then chunks, the chunk fastest."""
    plan = block_bwd_plan(H, W, C, hidden, ws, heads)
    nch = _cdiv(B * H * W, plan["chunk_tokens"])
    firsts, first = [], 0
    for t in plan["wgrad_tiles"]:
        firsts.append(first)
        first += t * nch
    table = []
    for bid in range(first):
        p = 0
        while p + 1 < len(firsts) and bid >= firsts[p + 1]:
            p += 1
        local = bid - firsts[p]
        ch, tile = local % nch, local // nch
        mt = _cdiv(_bwd_products(C, hidden)[p][0], _TILE)
        table.append((p, tile % mt, tile // mt, ch))
    return table


# The LN+W-MSA backward (#12, csrc/ln_wmsa_bwd.cu) on the same kernels: its
# weight gradients are dwproj (C x C) and dwqkv (C x 3C).


def _ln_wmsa_bwd_width_why(C: int, heads: int, N: int) -> Optional[str]:
    if C % 16:
        return f"C={C} must be a multiple of 16"
    if C > BWD_MAX_C:
        return f"C={C} above {BWD_MAX_C} (a cluster of at most 6 CTAs owns a row)"
    if heads <= 0 or C % heads:
        return f"C={C} not divisible by {heads} heads"
    return _attn_bwd_why(C // heads, N)


def ln_wmsa_bwd_why(C: int, heads: int, ws: int) -> Optional[str]:
    """Why the LN+W-MSA backward's kernels do not take a sublayer of width C
    with ``heads`` heads and window ``ws`` (None when they do): the window
    kernels' window rule; C a multiple of 16 up to 768; an even head dim
    whose attention operands fit shared memory (up to 192 at 64 tokens)."""
    N = ws * ws
    if N % 16 or N > _TILE or N == 0:
        return f"window {ws} gives {N} tokens; the kernel takes 16, 32, 48 or 64"
    return _ln_wmsa_bwd_width_why(C, heads, N)


def ln_wmsa_bwd_takes(C: int, heads: int, ws: int) -> bool:
    """Whether the LN+W-MSA backward's kernels take the sublayer (the
    router's question: the window's rule is every window kernel's)."""
    return _ln_wmsa_bwd_width_why(C, heads, ws * ws) is None


@functools.lru_cache(maxsize=None)
def ln_wmsa_bwd_plan(H: int, W: int, C: int, ws: int, heads: int) -> dict:
    """Launch plan of the LN+W-MSA backward (#12) for (H, W, C) images, a
    function of one image's shape (``wmsa_bwd_plan`` in csrc/ln_wmsa_bwd.cu
    mirrors it): :func:`block_bwd_plan`'s quantities over its two weight
    gradients (dwproj, dwqkv) and its one LN A load (qkv). Raises ValueError
    on a shape outside the design, with the wrapper's reason."""
    why = ln_wmsa_bwd_why(C, heads, ws)
    if why is None and (H % ws or W % ws):
        why = f"({H},{W}) not divisible by window {ws}"
    if why:
        raise ValueError(f"ln_wmsa_bwd_plan: H={H}, W={W}, C={C}, ws={ws}, heads={heads}: {why}")
    return _bwd_plan_of(H, W, C, ws, heads, (_wg_tiles(C, C), _wg_tiles(C, 3 * C)),
                        {"qkv": 3 * C})


def ln_wmsa_bwd_workspace(B: int, H: int, W: int, C: int, ws: int, heads: int) -> int:
    """Bytes of the LN+W-MSA backward's workspace (``carve_wmsa_bwd`` in
    csrc/ln_wmsa_bwd.cu): the token rows (x and LN1(x) gathered, qkv, ctx,
    dout gathered, round(dctx), round(dqkv)), the LN statistics, the
    weight gradients' token-chunk partials (none with one chunk: the launch
    writes the gradients), and the LN, qkv-bias and rel-pos-bias partials."""
    plan = ln_wmsa_bwd_plan(H, W, C, ws, heads)
    T, N, nW = B * H * W, ws * ws, (H // ws) * (W // ws)
    nch = _cdiv(T, plan["chunk_tokens"])
    achunks = _cdiv(B * nW, plan["windows_per_chunk"])
    rows = [_pad128(n * T * C * 2) for n in (1, 1, 3, 1, 1, 1, 3)] + [_pad128(2 * T * 4)]
    parts = ([nch * C * C, nch * 3 * C * C, nch * C] if nch > 1 else []) + [
        _cdiv(T, _TILE) * 2 * C, achunks * 3 * C, achunks * heads * N * N]
    return sum(rows) + sum(_pad128(4 * n) for n in parts)


# The LN+MLP backward (#14, csrc/ln_mlp_bwd.cu) on the same kernels, over
# the map's own rows: dab w1^T split over K on clusters of ks CTAs, and the
# LN backward one warp per row, MLP_BWD_LN_ROWS rows per CTA.
MLP_BWD_KS_MAX = 8      # kMlpKsMax: a portable cluster
MLP_BWD_LN_ROWS = 8     # kMlpLnRows


@functools.lru_cache(maxsize=None)
def ln_mlp_bwd_plan(H: int, W: int, C: int, hidden: int) -> dict:
    """Launch plan of the LN+MLP backward (#14) for (H, W, C) images, a
    function of one image's shape (``mlp_bwd_plan`` in csrc/ln_mlp_bwd.cu
    mirrors it): the K split ks of dab w1^T (the largest divisor of its
    64-row K chunks, up to MLP_BWD_KS_MAX, that keeps a PLAN_BATCH-image
    launch within BWD_FILL_CTAS CTAs), fc1's 128-column tiles per CTA (the
    LN A load), the weight-gradient launch's tokens per chunk and tiles
    (dw2, dw1) and each launch's shared-memory bytes. Raises ValueError on a
    shape outside the design."""
    if C % 16 or hidden % 16 or hidden <= 0 or C <= 0 or C > SPLIT_TRAIN_MAX_C:
        raise ValueError(f"ln_mlp_bwd_plan: C={C}, hidden={hidden}: the kernel takes "
                         f"multiples of 16 and C <= {SPLIT_TRAIN_MAX_C}")
    hw = H * W
    rows = _cdiv(PLAN_BATCH * hw, _TILE)
    nch = _cdiv(hidden, _TILE)
    tiles = rows * _cdiv(C, _BWD_COLS)
    ks = max(d for d in range(1, min(MLP_BWD_KS_MAX, nch) + 1)
             if nch % d == 0 and (d == 1 or tiles * d <= BWD_FILL_CTAS))
    wtiles = (_wg_tiles(hidden, C), _wg_tiles(C, hidden))
    per = max(1, _cdiv(BWD_FILL_CTAS, sum(wtiles)))
    fc1 = _cdiv(hidden, _BWD_COLS)
    return {"ks": ks, "chunk_tokens": _TILE * _cdiv(rows, per), "wgrad_tiles": wtiles,
            "tiles_per_cta": {"fc1": min(fc1, max(1, _cdiv(fc1 * rows, BWD_FILL_CTAS)))},
            "smem": {"gemm_a_in_smem": _bwd_tok_smem(C, True),
                     "ksplit": _bwd_tok_smem(0, False), "tail": _bwd_tok_smem(0, False)}}


def ln_mlp_bwd_workspace(B: int, H: int, W: int, C: int, hidden: int) -> int:
    """Bytes of the LN+MLP backward's workspace (``carve_mlp_bwd`` in
    csrc/ln_mlp_bwd.cu): the token rows (yn, round(gelu(a)), dm, round(da)),
    the LN statistics, a and dyn in float32, the weight gradients' partials
    when there is more than one chunk, b1's per-row-tile and the LN's
    per-CTA partials."""
    plan = ln_mlp_bwd_plan(H, W, C, hidden)
    T = B * H * W
    nch = _cdiv(T, plan["chunk_tokens"])
    pieces = [2 * T * C, 2 * T * hidden, 2 * T * C, 2 * T * hidden, 4 * 2 * T,
              4 * T * hidden, 4 * T * C]
    if nch > 1:
        pieces += [4 * nch * hidden * C, 4 * nch * C * hidden, 4 * nch * C]
    pieces += [4 * _cdiv(T, _TILE) * hidden, 4 * _cdiv(T, MLP_BWD_LN_ROWS) * 2 * C]
    return sum(_pad128(n) for n in pieces)


def bwd_residuals_enabled(C: int, num_heads: int, N: int) -> bool:
    """Whether a block of width C, ``num_heads`` heads and N-token windows
    trains on the residual route: JAX ``bwd_residuals_enabled`` at the JAX
    package's defaults (``SUNET_BWD_RESID=1``, the rowmax softmax, automatic
    layouts). It holds when the attention takes the blockdiag layout in both
    directions (``_attn_layout``, ``_attn_layout_bwd``), which JAX picks iff
    pad128(C) * N <= pad128(d) * pad128(N), ties to blockdiag. The port's
    softmax is always the rowmax form."""
    d = C // num_heads
    return _pad128(C) * N <= _pad128(d) * _pad128(N)


@contextlib.contextmanager
def exact_fp32():
    """float32 products in float32: no TF32 in cuBLAS or cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or in its own dtype where that is wider (float64):
    the "at least float32" of the plain versions and the eager route, so
    that bf16 and float32 compute as in float32 and float64 stays float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with float32 accumulation of the (possibly bf16) operands; in
    float64 where either operand is float64."""
    ct = torch.promote_types(torch.promote_types(a.dtype, b.dtype), torch.float32)
    return torch.matmul(a.to(ct), b.to(ct))


def _ln_stats(x: torch.Tensor, eps: float = 1e-5):
    """(xhat, inv) of a LayerNorm over the last axis, float32."""
    xf = wide(x)
    xc = xf - xf.mean(-1, keepdim=True)
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    return xc * inv, inv


def ln32(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
         eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in float32 (float32 result)."""
    return _ln_stats(x, eps)[0] * wide(g) + wide(b)


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))


def attn_core_reference(q, k, v, bias, mask, *, num_heads: int, scale: float):
    """Windowed multi-head attention core: q, k, v (Bn, N, C) in the compute
    dtype -> float32 ctx (Bn, N, C), exact row-max softmax, divide after P@V."""
    Bn, N, C = q.shape
    h = num_heads
    d = C // h
    dt = q.dtype
    qs = (wide(q) * scale).to(dt)
    heads = lambda t: t.reshape(Bn, N, h, d).permute(0, 2, 1, 3)
    s = mm32(heads(qs), heads(k).transpose(-1, -2)) + wide(bias)[None]
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(Bn // nW, nW, h, N, N)
             + wide(mask)[None, :, None]).reshape(Bn, h, N, N)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    den = e.sum(-1, keepdim=True)
    ctx = mm32(e.to(dt), heads(v)) / den.clamp_min(1e-37)
    return ctx.permute(0, 2, 1, 3).reshape(Bn, N, C)


def _window_ctx(xw, wqkv, bqkv, bias, mask, num_heads, scale):
    """Windows (Bn, N, C) in the compute dtype -> rounded ctx windows."""
    dt = xw.dtype
    C = xw.shape[-1]
    qkv = mm32(xw, wqkv)
    if bqkv is not None:
        qkv = qkv + wide(bqkv)
    qkv = qkv.to(dt)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    return attn_core_reference(q, k, v, bias, mask, num_heads=num_heads,
                               scale=scale).to(dt)


def _qkv_ctx(xn, wqkv, bqkv, bias, mask, ws, num_heads, scale):
    """LN'd NHWC map -> rounded ctx windows (B*nW, N, C)."""
    return _window_ctx(window_partition(xn, ws), wqkv, bqkv, bias, mask,
                       num_heads, scale)


def _mlp_branch32(y, ln, w1, b1, w2, b2):
    """fc2(round(gelu(fc1(round(LN(y)))))) + b2 in float32."""
    dt = y.dtype
    yn = ln32(y, *ln).to(dt)
    h1 = gelu_erf(mm32(yn, w1) + wide(b1)).to(dt)
    return mm32(h1, w2) + wide(b2)


def _mlp_tail(y, ln, w1, b1, w2, b2, s2=None):
    """round(y + s2 * fc2(gelu(fc1(LN(y))))); s2 per image or None (1)."""
    m = _mlp_branch32(y, ln, w1, b1, w2, b2)
    return (wide(y) + (m if s2 is None else s2 * m)).to(y.dtype)


def _dp_scales(dp, B: int):
    """(B, 2) drop-path scales -> two (B, 1, 1, 1) float32 tensors (or None)."""
    if dp is None:
        return None, None
    dp = wide(dp).reshape(B, 2)
    return dp[:, 0].reshape(B, 1, 1, 1), dp[:, 1].reshape(B, 1, 1, 1)


def gelu_erf_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx of the exact-erf GELU: Phi(x) + x * phi(x)."""
    cdf = 0.5 * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))
    return cdf + x * torch.exp(-0.5 * x * x) * (1.0 / math.sqrt(2.0 * math.pi))


def _ln_bwd_dx(dxhat, xhat, inv):
    """LN input cotangent inv * (dxhat - mean(dxhat) - xhat * mean(dxhat*xhat))."""
    return inv * (dxhat - dxhat.mean(-1, keepdim=True)
                  - xhat * (dxhat * xhat).mean(-1, keepdim=True))


def _qkv_heads(uw, wqkv, bqkv, *, num_heads: int, N: int, scale: float) -> tuple:
    """qkv = round(uw @ wqkv + bqkv) of the LN'd rows ``uw`` (T, C) in
    window-major order, split per (window, head) (Bn, h, N, d):
    (round(q*scale), k, v)."""
    dt = uw.dtype
    T, C = uw.shape
    qkv = mm32(uw, wqkv)
    if bqkv is not None:
        qkv = qkv + wide(bqkv)
    qkv = qkv.to(dt)
    q, k, v = (qkv[:, i * C:(i + 1) * C].reshape(T // N, N, num_heads, C // num_heads)
               .permute(0, 2, 1, 3) for i in range(3))
    return (wide(q) * scale).to(dt), k, v


def _scores(qs, k, bias, mask):
    """float32 logits qs k^T + bias (+ the window's mask), (Bn, h, N, N)."""
    Bn, h, N, _ = qs.shape
    s = mm32(qs, k.transpose(-1, -2)) + wide(bias)[None]
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(Bn // nW, nW, h, N, N) + wide(mask)[None, :, None]).reshape(
            Bn, h, N, N)
    return s


def _wmsa_recompute(uw, wqkv, bqkv, bias, mask, *, num_heads: int,
                    scale: float) -> tuple:
    """Forward recompute of the attention sublayer from its LN'd rows ``uw``
    (T, C) in window-major order: (round(q*scale), k, v) per (window, head)
    (Bn, h, N, d), the float32 softmax P (Bn, h, N, N) and ctx =
    round(round(P) @ v) as rows (T, C)."""
    T, C = uw.shape
    qs, k, v = _qkv_heads(uw, wqkv, bqkv, num_heads=num_heads, N=bias.shape[-1],
                          scale=scale)
    P = torch.softmax(_scores(qs, k, bias, mask), dim=-1)
    ctx = mm32(P.to(uw.dtype), v).permute(0, 2, 1, 3).reshape(T, C).to(uw.dtype)
    return qs, k, v, P, ctx


def _attn_res_state(qs, k, v, bias, mask) -> tuple:
    """The residual route's attention forward (JAX ``_bd_fwd_core`` and the
    normalisation of ``_block_fwd_res_kernel``): e = exp(s - rowmax_head(s))
    rounded to the compute dtype (eb), den = sum of the rounded e, rden =
    1/max(den, 1e-37), ctx_f = (eb @ v) * rden. Returns (eb (Bn, h, N, N),
    rden (Bn, h, N) float32, ctx_f as float32 rows (T, C))."""
    Bn, h, N, d = qs.shape
    s = _scores(qs, k, bias, mask)
    eb = torch.exp(s - s.amax(-1, keepdim=True)).to(qs.dtype)
    rden = 1.0 / wide(eb).sum(-1).clamp_min(1e-37)
    ctx_f = mm32(eb, v) * rden[..., None]
    return eb, rden, ctx_f.permute(0, 2, 1, 3).reshape(Bn * N, h * d)


def _qkv_bwd(uw, ds, qs, k, dv, wqkv, *, scale: float) -> tuple:
    """The attention backward's common tail from the float32 score cotangent
    ``ds`` and dv (Bn, h, N, ...): dbias = sum of ds over windows, dq =
    round(ds) k * scale, dk = round(ds)^T round(q*scale). Returns (du =
    round(dqkv) wqkv^T as float32 rows, dwqkv = uw^T round(dqkv), dbqkv,
    dbias)."""
    dt = uw.dtype
    T, C = uw.shape
    unheads = lambda t: t.permute(0, 2, 1, 3).reshape(T, C)
    dsb = ds.to(dt)
    dq = mm32(dsb, k) * scale
    dk = mm32(dsb.transpose(-1, -2), qs)
    dqkv = torch.cat([unheads(dq), unheads(dk), unheads(dv)], dim=-1)
    dqkv_b = dqkv.to(dt)
    return mm32(dqkv_b, wqkv.t()), mm32(uw.t(), dqkv_b), dqkv.sum(0), ds.sum(0)


def _wmsa_bwd(uw, dattn, rec, wqkv, wproj, *, scale: float) -> tuple:
    """Backward of the attention sublayer from the cotangent ``dattn`` (T,
    C, window-major rows, compute dtype) of its projection output, ``rec``
    from :func:`_wmsa_recompute`: dctx = round(dattn wproj^T); per head dP
    = dctx v^T, dv = round(P)^T dctx, ds = P*(dP - rowsum(dP*P)), then
    :func:`_qkv_bwd`. Returns (du, dwqkv, dbqkv, dwproj = ctx^T dattn,
    dbproj, dbias)."""
    qs, k, v, P, ctx = rec
    T, C = uw.shape
    Bn, h, N, d = k.shape
    dctx = mm32(dattn, wproj.t()).to(uw.dtype).reshape(Bn, N, h, d).permute(0, 2, 1, 3)
    dP = mm32(dctx, v.transpose(-1, -2))
    dv = mm32(P.to(uw.dtype).transpose(-1, -2), dctx)
    ds = P * (dP - (dP * P).sum(-1, keepdim=True))
    du, dwqkv, dbqkv, dbias = _qkv_bwd(uw, ds, qs, k, dv, wqkv, scale=scale)
    return du, dwqkv, dbqkv, mm32(ctx.t(), dattn), wide(dattn).sum(0), dbias


def _wmsa_bwd_res(uw, dattn, qkv, eb, rden, ctx_f, wqkv, wproj, *, scale: float) -> tuple:
    """Backward of the attention sublayer on the residual route (JAX
    ``_attn_core_bwd``, blockdiag, ``recip=True``), from the stored eb,
    rden and ctx_f and ``qkv`` = (round(q*scale), k, v) of
    :func:`_qkv_heads`: dctx = dattn wproj^T in float32; dn = dctx * rden;
    de = round(dn) v^T - rowsum_head(round(dn * ctx_f)); ds = eb * de; dv =
    eb^T round(dn); then :func:`_qkv_bwd`. Returns (du, dwqkv, dbqkv,
    dwproj = round(ctx_f)^T dattn, dbproj, dbias)."""
    qs, k, v = qkv
    dt = uw.dtype
    T, C = uw.shape
    Bn, h, N, d = k.shape
    heads = lambda t: t.reshape(Bn, N, h, d).permute(0, 2, 1, 3)
    dn = heads(mm32(dattn, wproj.t())) * rden[..., None]
    t = wide((dn * heads(ctx_f)).to(dt)).sum(-1, keepdim=True)
    dnb = dn.to(dt)
    ds = wide(eb) * (mm32(dnb, v.transpose(-1, -2)) - t)
    dv = mm32(eb.transpose(-1, -2), dnb)
    du, dwqkv, dbqkv, dbias = _qkv_bwd(uw, ds, qs, k, dv, wqkv, scale=scale)
    return (du, dwqkv, dbqkv, mm32(ctx_f.to(dt).t(), dattn), wide(dattn).sum(0),
            dbias)


def _mlp_recompute(rows, ln, w1, b1) -> tuple:
    """Forward recompute of the MLP branch over token rows (T, C): (xhat,
    inv) of its LN in float32, yn = round(LN(rows)), the float32 fc1
    pre-activation a and round(gelu(a))."""
    yhat, inv = _ln_stats(rows)
    yn = (yhat * wide(ln[0]) + wide(ln[1])).to(rows.dtype)
    a = mm32(yn, w1) + wide(b1)
    return yhat, inv, yn, a, gelu_erf(a).to(rows.dtype)


def _mlp_bwd(dm, rec, ln_scale, w1, w2) -> tuple:
    """Backward of the MLP branch from its output cotangent ``dm`` (T, C,
    compute dtype), ``rec`` from :func:`_mlp_recompute`: dw2 = hgelu^T dm;
    da = (dm w2^T) * gelu'(a); dab = round(da); dw1 = yn^T dab; dyn = dab
    w1^T. Returns (LN^T(dyn * g) as float32 rows, dg, db, dw1, db1, dw2,
    db2)."""
    yhat, inv, yn, a, hgelu = rec
    dw2 = mm32(hgelu.t(), dm)
    db2 = wide(dm).sum(0)
    da = mm32(dm, w2.t()) * gelu_erf_grad(a)
    dab = da.to(dm.dtype)
    dw1 = mm32(yn.t(), dab)
    dyn = mm32(dab, w1.t())
    return (_ln_bwd_dx(dyn * wide(ln_scale), yhat, inv), (dyn * yhat).sum(0),
            dyn.sum(0), dw1, da.sum(0), dw2, db2)


# ---------------------------------------------------------------- plain versions


def fused_swin_block_reference(x, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1,
                               w2, b2, bias, mask, drop_path_scale=None, *,
                               ws: int, num_heads: int, scale: float,
                               shift: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_swin_block`."""
    with exact_fp32():
        dt = x.dtype
        B, H, W, C = x.shape
        s1, s2 = _dp_scales(drop_path_scale, B)
        xr = roll2d(x, -shift)
        ctx = _qkv_ctx(ln32(xr, *ln1).to(dt), wqkv, bqkv, bias, mask, ws,
                       num_heads, scale)
        attn = window_reverse(mm32(ctx, wproj) + wide(bproj), ws, H, W)
        y = (wide(xr) + (attn if s1 is None else s1 * attn)).to(dt)
        return roll2d(_mlp_tail(y, ln2, w1, b1, w2, b2, s2), shift)


def fused_swin_block_res_reference(x, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1,
                                   w2, b2, bias, mask, drop_path_scale=None, *,
                                   ws: int, num_heads: int, scale: float,
                                   shift: int = 0) -> tuple:
    """Plain PyTorch version of :func:`fused_swin_block_res`, step by step
    after the JAX ``_block_fwd_res_kernel``: the block of
    :func:`fused_swin_block_reference` with the residual route's attention
    (:func:`_attn_res_state`) and round(ctx_f) into the projection. Returns
    (out, eb (B*nW, h, N, N) in x's dtype, rden (B*nW, h, N) float32, ctx_f
    (B*H*W, C) float32), the residuals in window-major (rolled) order."""
    with exact_fp32():
        dt = x.dtype
        B, H, W, C = x.shape
        s1, s2 = _dp_scales(drop_path_scale, B)
        xr = roll2d(x, -shift)
        uw = window_partition(ln32(xr, *ln1).to(dt), ws).reshape(-1, C)
        qs, k, v = _qkv_heads(uw, wqkv, bqkv, num_heads=num_heads, N=ws * ws, scale=scale)
        eb, rden, ctx_f = _attn_res_state(qs, k, v, bias, mask)
        attn = window_reverse((mm32(ctx_f.to(dt), wproj) + wide(bproj)).reshape(
            -1, ws * ws, C), ws, H, W)
        y = (wide(xr) + (attn if s1 is None else s1 * attn)).to(dt)
        return roll2d(_mlp_tail(y, ln2, w1, b1, w2, b2, s2), shift), eb, rden, ctx_f


def _block_bwd_plain(x, dout, ln1, wproj, bproj, ln2, w1, b1, w2, b2, drop_path_scale,
                     attention, *, ws: int, shift: int) -> tuple:
    """The whole block's backward, step by step after the JAX block backward
    kernels with their rounding points, for either attention route:
    ``attention(uw)`` takes the LN1 rows ``uw`` (window-major) and returns
    (ctx rows in the compute dtype, ``bwd``), ``bwd(dattn)`` the attention
    sublayer's (du, dwqkv, dbqkv, dwproj, dbproj, dbias). Then

      y = round(x + s1 * (ctx wproj + bproj)); LN2(y) and the fc1
      pre-activation a recomputed; dm = round(s2*dout); dw2 = hgelu^T dm;
      da = (dm w2^T) * gelu'(a); dab = round(da); dw1 = yn^T dab;
      dy = dout + LN2^T(dab w1^T); dattn = round(s1*dy) into ``bwd``;
      dx = dy + LN1^T(du).

    Returns (dx in x's dtype, then float32 grads of ln1 g/b, wqkv, bqkv,
    wproj, bproj, ln2 g/b, w1, b1, w2, b2 and bias (h, N, N)). Weight
    grads are (in, out) like the weights."""
    with exact_fp32():
        dt = x.dtype
        B, H, W, C = x.shape
        s1, s2 = _dp_scales(drop_path_scale, B)
        if s1 is None:
            s1 = s2 = torch.ones(B, 1, 1, 1, device=x.device)
        f = lambda t: wide(t)
        win = lambda t: window_partition(t, ws).reshape(-1, t.shape[-1])
        unwin = lambda t: window_reverse(t.reshape(-1, ws * ws, t.shape[-1]), ws, H, W)

        # forward recompute
        xr = roll2d(x, -shift)
        xhat1, inv1 = _ln_stats(xr)
        uw = win((xhat1 * f(ln1[0]) + f(ln1[1])).to(dt))
        ctx, attn_bwd = attention(uw)
        attn = unwin(mm32(ctx, wproj) + f(bproj))
        y = (wide(xr) + s1 * attn).to(dt)
        mlp = _mlp_recompute(y.reshape(-1, C), ln2, w1, b1)

        # MLP sublayer
        dout32 = wide(roll2d(dout.to(dt), -shift))
        dm = (s2 * dout32).to(dt).reshape(-1, C)
        dy2, dg2, db2, dw1, dbm1, dw2, dbm2 = _mlp_bwd(dm, mlp, ln2[0], w1, w2)
        dy = dout32 + dy2.reshape(B, H, W, C)

        # attention sublayer
        du, dwqkv, dbqkv, dwproj, dbproj, dbias = attn_bwd(win((s1 * dy).to(dt)))
        du = unwin(du)
        dg1 = (du * xhat1).sum((0, 1, 2))
        db1 = du.sum((0, 1, 2))
        dx = dy + _ln_bwd_dx(du * f(ln1[0]), xhat1, inv1)
        dx = roll2d(dx, shift).to(dt)
        return (dx, dg1, db1, dwqkv, dbqkv, dwproj, dbproj, dg2, db2, dw1,
                dbm1, dw2, dbm2, dbias)


def swin_block_bwd_reference(x, dout, ln1, wqkv, bqkv, wproj, bproj, ln2, w1,
                             b1, w2, b2, bias, mask, drop_path_scale, *,
                             ws: int, num_heads: int, scale: float,
                             shift: int = 0) -> tuple:
    """Plain PyTorch version of :func:`swin_block_bwd` (JAX
    ``_block_bwd_kernel``): :func:`_block_bwd_plain` with the attention
    recomputed (per-head softmax P in float32, ctx = round(round(P) @ v))
    and differentiated through P (:func:`_wmsa_bwd`: per head dP =
    round(dctx) v^T, dv = round(P)^T round(dctx), ds = P*(dP -
    rowsum(dP*P)), dq = round(ds) k * scale, dk = round(ds)^T
    round(q*scale))."""
    def attention(uw):
        rec = _wmsa_recompute(uw, wqkv, bqkv, bias, mask, num_heads=num_heads,
                              scale=scale)
        return rec[4], lambda dattn: _wmsa_bwd(uw, dattn, rec, wqkv, wproj, scale=scale)

    return _block_bwd_plain(x, dout, ln1, wproj, bproj, ln2, w1, b1, w2, b2,
                            drop_path_scale, attention, ws=ws, shift=shift)


def swin_block_bwd_res_reference(x, dout, eb, rden, ctx, ln1, wqkv, bqkv, wproj,
                                 bproj, ln2, w1, b1, w2, b2, drop_path_scale, *,
                                 ws: int, num_heads: int, scale: float,
                                 shift: int = 0) -> tuple:
    """Plain PyTorch version of :func:`swin_block_bwd_res` (JAX
    ``_block_bwd_res_kernel``): :func:`_block_bwd_plain` with LN1 and qkv
    recomputed, ctx = round(ctx_f) from the residuals and the attention
    backward from the stored state (:func:`_wmsa_bwd_res`); no scores, no
    softmax, no rel-pos bias or mask."""
    def attention(uw):
        qkv = _qkv_heads(uw, wqkv, bqkv, num_heads=num_heads, N=ws * ws, scale=scale)
        return ctx.to(uw.dtype), lambda dattn: _wmsa_bwd_res(
            uw, dattn, qkv, eb, rden, ctx, wqkv, wproj, scale=scale)

    return _block_bwd_plain(x, dout, ln1, wproj, bproj, ln2, w1, b1, w2, b2,
                            drop_path_scale, attention, ws=ws, shift=shift)


def ln_window_attention_bwd_reference(x, dout, ln_scale, ln_bias, wqkv, bqkv,
                                      wproj, bias, mask, *, ws: int,
                                      num_heads: int, scale: float) -> tuple:
    """Plain PyTorch version of :func:`ln_window_attention_bwd`, step by step
    after the JAX ``_strip_bwd_kernel`` with its rounding points: LN, qkv,
    per-head softmax P and ctx recomputed from x (rolled by the caller);
    dwproj = ctx^T round(dout), dbproj = sum round(dout), dctx =
    round(round(dout) wproj^T), the per-head attention backward of
    :func:`_wmsa_bwd`, dwqkv = u^T round(dqkv), du = round(dqkv) wqkv^T,
    dx = LN^T(du * g) with no residual term.

    Returns (dx in x's dtype, then float32 grads of the LN scale and bias,
    wqkv, bqkv, wproj, bproj and bias (h, N, N)); weight grads are (in,
    out) like the weights."""
    with exact_fp32():
        dt = x.dtype
        B, H, W, C = x.shape
        win = lambda t: window_partition(t, ws).reshape(-1, C)
        xhat, inv = _ln_stats(x)
        uw = win((xhat * wide(ln_scale) + wide(ln_bias)).to(dt))
        rec = _wmsa_recompute(uw, wqkv, bqkv, bias, mask, num_heads=num_heads,
                              scale=scale)
        du, dwqkv, dbqkv, dwproj, dbproj, dbias = _wmsa_bwd(
            uw, win(dout.to(dt)), rec, wqkv, wproj, scale=scale)
        du = window_reverse(du.reshape(-1, ws * ws, C), ws, H, W)
        dx = _ln_bwd_dx(du * wide(ln_scale), xhat, inv).to(dt)
        return (dx, (du * xhat).sum((0, 1, 2)), du.sum((0, 1, 2)), dwqkv,
                dbqkv, dwproj, dbproj, dbias)


def wmsa_core_reference(xw, wqkv, bqkv, wproj, bproj, bias, mask, *,
                        num_heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`wmsa_core`, at the JAX ``_kernel``'s
    rounding points: qkv in float32 + bias, rounded; the attention core of
    :func:`attn_core_reference`, rounded; the projection in float32 + bias,
    rounded to xw's dtype."""
    with exact_fp32():
        ctx = _window_ctx(xw, wqkv, bqkv, bias, mask, num_heads, scale)
        return (mm32(ctx, wproj) + wide(bproj)).to(xw.dtype)


def fused_window_attention_reference(x, wqkv, bqkv, wproj, bproj, bias, mask,
                                     *, ws: int, num_heads: int,
                                     scale: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_window_attention`: the window
    partition, :func:`wmsa_core_reference`, the reverse."""
    H, W = x.shape[1:3]
    out = wmsa_core_reference(window_partition(x, ws), wqkv, bqkv, wproj, bproj,
                              bias, mask, num_heads=num_heads, scale=scale)
    return window_reverse(out, ws, H, W)


def fused_ln_window_attention_reference(x, ln_scale, ln_bias, wqkv, bqkv,
                                        wproj, bproj, bias, mask, *, ws: int,
                                        num_heads: int,
                                        scale: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_ln_window_attention`."""
    with exact_fp32():
        return fused_window_attention_reference(
            ln32(x, ln_scale, ln_bias).to(x.dtype), wqkv, bqkv, wproj, bproj,
            bias, mask, ws=ws, num_heads=num_heads, scale=scale)


def fused_ln_mlp_reference(y, ln, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_ln_mlp`."""
    with exact_fp32():
        return _mlp_tail(y, ln, w1, b1, w2, b2)


def ln_mlp_branch_reference(y, ln, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version of :func:`ln_mlp_branch` (JAX
    ``_mlp_branch_kernel``): fc2(round(gelu(fc1(round(LN(y)))))) + b2,
    rounded to y's dtype, no residual."""
    with exact_fp32():
        return _mlp_branch32(y, ln, w1, b1, w2, b2).to(y.dtype)


def ln_mlp_bwd_reference(y, dout, ln, w1, b1, w2) -> tuple:
    """Plain PyTorch version of :func:`ln_mlp_bwd`, step by step after the
    JAX ``_mlp_bwd_kernel`` with its rounding points: LN(y) and the fc1
    pre-activation a recomputed, then the branch backward of
    :func:`_mlp_bwd` from dm = round(dout), and dy = LN^T(dyn * g) with no
    residual term. Returns (dy in y's dtype, then float32 grads of the LN
    scale and bias, w1 (C, hidden), b1, w2 (hidden, C) and b2)."""
    with exact_fp32():
        dt = y.dtype
        C = y.shape[-1]
        rec = _mlp_recompute(y.reshape(-1, C), ln, w1, b1)
        dy, *grads = _mlp_bwd(dout.to(dt).reshape(-1, C), rec, ln[0], w1, w2)
        return (dy.reshape(y.shape).to(dt), *grads)


# ---------------------------------------------------------------- CUDA launches


def _f32(t: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    return None if t is None else t.to(device=device, dtype=torch.float32).contiguous()


def _workspace(lib_fn, dev, *dims) -> torch.Tensor:
    """A kernel's device workspace: ``lib_fn(*dims)`` bytes."""
    return torch.empty(lib_fn(*dims), device=dev, dtype=torch.uint8)


def _check_x(name: str, x: torch.Tensor):
    """x a contiguous NHWC CUDA tensor of a dtype that ``name``'s kernel
    takes (:func:`dtype_why`; a caller whose window or training use
    matters gates first with :func:`_gate`)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensor on {x.device}; the kernel takes CUDA "
                         "tensors and the plain version CPU tensors")
    _gate(name, x)
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous NHWC tensor, got "
                         f"shape {tuple(x.shape)}")


def _check_w(name: str, x: torch.Tensor, **ws):
    for wname, (w, shape) in ws.items():
        if w.device != x.device or w.dtype != x.dtype or not w.is_contiguous():
            raise ValueError(f"{name}: {wname} must be a contiguous {x.dtype} "
                             f"tensor on {x.device}")
        if tuple(w.shape) != tuple(shape):
            raise ValueError(f"{name}: {wname} has shape {tuple(w.shape)}, "
                             f"expected {tuple(shape)}")


def _unpadded(w: torch.Tensor, cols: int) -> torch.Tensor:
    """A weight matrix of ``cols`` columns given as the kernels store it
    (:func:`wcols`: zero pad columns) as its (rows, cols) view; one given
    at (rows, cols) as it is."""
    return w if w.shape[-1] == cols else w[:, :cols]


def _kernel_ws(name: str, x: torch.Tensor, **ws) -> list:
    """Each weight matrix ``wname=(w, (rows, cols))`` as the kernels take
    it: a contiguous bfloat16 (rows, wcols(cols)) tensor on x's device. One
    given at (rows, cols) with cols not a multiple of 8 is padded here, a
    copy per call (the model's weight cache stores the padded form,
    ``SwinBlock.kernel_params``)."""
    out = []
    for wname, (w, (rows, cols)) in ws.items():
        if tuple(w.shape) == (rows, cols) and wcols(cols) != cols:
            w = torch.nn.functional.pad(w, (0, wcols(cols) - cols))
        _check_w(name, x, **{wname: (w, (rows, wcols(cols)))})
        out.append(w)
    return out


def _check_window(name: str, H, W, C, ws, num_heads, bias, mask, *,
                  no_bias: bool = False, c_align: int = 16):
    """``no_bias``: the kernel reads no rel-pos bias (the residual route's
    backward), and ``bias`` must be None. ``c_align``: the multiple C must
    be (4 for the block kernel's sequence form, whose launches load rows in
    8-byte chunks)."""
    N = ws * ws
    if H % ws or W % ws:
        raise ValueError(f"{name}: ({H},{W}) not divisible by window {ws}")
    why = window_why(N, C // max(num_heads, 1))
    if why:
        raise ValueError(f"{name}: {why}")
    if C % c_align or C % num_heads:
        raise ValueError(f"{name}: C={C} must be a multiple of {c_align} and of heads")
    if no_bias:
        if bias is not None:
            raise ValueError(f"{name}: takes no rel-pos bias")
    elif bias is None or tuple(bias.shape) != (num_heads, N, N):
        raise ValueError(f"{name}: bias shape "
                         f"{None if bias is None else tuple(bias.shape)}")
    nW = (H // ws) * (W // ws)
    if mask is not None and tuple(mask.shape) != (nW, N, N):
        raise ValueError(f"{name}: mask shape {tuple(mask.shape)}")


def _check_block(name, x, wqkv, wproj, w1, w2, bias, mask, ws, num_heads,
                 shift, dp, *, no_bias: bool = False, cap: Optional[int] = BLOCK_KERNEL_MAX_C):
    """``cap``: the widest C the kernel takes (None: the caller's design
    check says)."""
    _check_x(name, x)
    B, H, W, C = x.shape
    hidden = w1.shape[1]
    if cap is not None and C > cap:
        raise ValueError(f"{name}: C={C} above the block-kernel cap "
                         f"{cap}; route through "
                         "fused_ln_window_attention + fused_ln_mlp")
    if hidden % 16:
        raise ValueError(f"{name}: hidden {hidden} not a multiple of 16")
    _check_w(name, x, wqkv=(wqkv, (C, 3 * C)), wproj=(wproj, (C, C)),
             w1=(w1, (C, hidden)), w2=(w2, (hidden, C)))
    _check_window(name, H, W, C, ws, num_heads, bias, mask, no_bias=no_bias)
    if not 0 <= shift < ws:
        raise ValueError(f"{name}: shift {shift} outside [0, {ws})")
    if dp is not None and tuple(dp.shape) != (B, 2):
        raise ValueError(f"{name}: drop_path_scale shape {tuple(dp.shape)}, "
                         f"expected {(B, 2)}")


def _check_bwd_design(name: str, C: int, hidden: int, heads: int, ws: int):
    """The block backward's design limits of wrapper ``name``'s route: the
    residual route's for swin_block_bwd_res, else the recompute form's."""
    why = block_bwd_why(C, hidden, heads, ws, res=name == "swin_block_bwd_res")
    if why:
        raise ValueError(f"{name}: {why}")


def _launch_block(x, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2, b2, bias,
                  mask, dp=None, *, ws: int, num_heads: int, scale: float,
                  shift: int, res: bool = False, plan_hw: Optional[tuple] = None):
    """One launch of the block kernel; ``res``: its residual form, which
    returns (out, eb, rden, ctx_f). ``plan_hw``: the (H, W) whose plan the
    launch takes (default x's)."""
    name = "fused_swin_block_res" if res else "fused_swin_block"
    _check_block(name, x, wqkv, wproj, w1, w2, bias, mask, ws, num_heads, shift, dp)
    B, H, W, C = x.shape
    dev = x.device
    f = lambda t: _f32(t, dev)
    args = [f(ln1[0]), f(ln1[1]), wqkv, f(bqkv), wproj, f(bproj),
            f(ln2[0]), f(ln2[1]), w1, f(b1), w2, f(b2), f(bias), f(mask), f(dp)]
    out = torch.empty_like(x)
    plan = block_plan(*(plan_hw or (H, W)), C, w1.shape[1], ws, num_heads)
    lib = _build.library()
    dims = (B, H, W, C, w1.shape[1], ws, num_heads, shift, float(scale), plan["G"],
            _build.stream())
    ptrs = [_build.ptr(a) for a in [x, out, *args]]
    if not res:
        _build.check(name, lib.sunet_swin_block(*ptrs, *dims))
        return out
    if (C // num_heads) % 2:
        raise ValueError(f"{name}: head dim {C // num_heads} is odd (the state's stores are "
                         "column pairs)")
    N = ws * ws
    nwin = B * (H // ws) * (W // ws)
    state = (torch.empty(nwin, num_heads, N, N, device=dev, dtype=x.dtype),
             torch.empty(nwin, num_heads, N, device=dev, dtype=torch.float32),
             torch.empty(B * H * W, C, device=dev, dtype=torch.float32))
    _build.check(name, lib.sunet_swin_block_res(
        *ptrs, *[_build.ptr(t) for t in state], *dims))
    return (out, *state)


def _launch_block_seq(x, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2, b2, bias,
                      mask, dp=None, *, ws: int, num_heads: int, scale: float,
                      shift: int, plan_hw: Optional[tuple] = None) -> tuple:
    """The block kernel's sequence form (csrc/swin_block_seq.cu) for
    windows above 64 tokens: (out, kernel launches). ``dp`` (B, 2): its
    train form, up to C = TRAIN_BLOCK_MAX_C and also at windows up to 64
    tokens (the blocks the cluster kernel does not take); without it the
    inference cap BLOCK_KERNEL_MAX_C holds (JAX
    ``SUNET_INFER_KERNEL_MAX_C``) and windows above 64 tokens."""
    name = "fused_swin_block"
    _gate(name, x, tokens=ws * ws, train=dp is not None)
    _check_x(name, x)
    B, H, W, C = x.shape
    hidden = w1.shape[1]
    cap = BLOCK_KERNEL_MAX_C if dp is None else TRAIN_BLOCK_MAX_C
    if C > cap:
        raise ValueError(f"{name}: C={C} above the block-kernel cap {cap}; "
                         "route through fused_ln_window_attention + fused_ln_mlp")
    if dp is not None and tuple(dp.shape) != (B, 2):
        raise ValueError(f"{name}: drop_path_scale shape {tuple(dp.shape)}, expected {(B, 2)}")
    wqkv, wproj, w1, w2 = _kernel_ws(name, x, wqkv=(wqkv, (C, 3 * C)), wproj=(wproj, (C, C)),
                                     w1=(w1, (C, hidden)), w2=(w2, (hidden, C)))
    _check_window(name, H, W, C, ws, num_heads, bias, mask, c_align=4)
    if not 0 <= shift < ws:
        raise ValueError(f"{name}: shift {shift} outside [0, {ws})")
    plan = block_seq_plan(*(plan_hw or (H, W)), C, hidden, ws, num_heads, train=dp is not None)
    dev = x.device
    f = lambda t: _f32(t, dev)
    if bqkv is None:
        bqkv = torch.zeros(3 * C, device=dev)
    _check_vec(name, ln1_scale=(ln1[0], C), ln1_bias=(ln1[1], C), bqkv=(bqkv, 3 * C),
               bproj=(bproj, C), ln2_scale=(ln2[0], C), ln2_bias=(ln2[1], C), b1=(b1, hidden),
               b2=(b2, C))
    lib = _build.library()
    work = _workspace(lib.sunet_swin_block_seq_workspace, dev, B * H * W, C, hidden)
    out = torch.empty_like(x)
    args = [f(ln1[0]), f(ln1[1]), wqkv, f(bqkv), wproj, f(bproj), f(ln2[0]), f(ln2[1]), w1,
            f(b1), w2, f(b2), f(bias), f(mask), f(dp)]
    launches = _build.c_int(0)
    err = lib.sunet_swin_block_seq(
        _build.ptr(x), _build.ptr(out), *[_build.ptr(a) for a in args], _build.ptr(work),
        B, H, W, C, hidden, ws, num_heads, shift, float(scale), plan["Kp"], plan["ksq"],
        plan["ksp"], plan["ks1"], plan["ks2"], _build.byref(launches), _build.stream())
    _build.check(name, err)
    return out, launches.value


def _launch_block_f32(x, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2, b2, bias, mask, *,
                      ws: int, num_heads: int, scale: float, shift: int) -> tuple:
    """#1's float32 form (csrc/f32_swin_block.cu), one launch."""
    name = "fused_swin_block"
    _gate(name, x, tokens=ws * ws)
    _check_x(name, x)
    B, H, W, C = x.shape
    hidden = w1.shape[1]
    if C > BLOCK_KERNEL_MAX_C:
        raise ValueError(f"{name}: C={C} above the block-kernel cap {BLOCK_KERNEL_MAX_C}; "
                         "route through fused_ln_window_attention + fused_ln_mlp")
    wqkv, wproj, w2 = (_unpadded(wqkv, 3 * C).contiguous(), _unpadded(wproj, C).contiguous(),
                       _unpadded(w2, C).contiguous())
    _check_w(name, x, wqkv=(wqkv, (C, 3 * C)), wproj=(wproj, (C, C)), w1=(w1, (C, hidden)),
             w2=(w2, (hidden, C)))
    _check_window(name, H, W, C, ws, num_heads, bias, mask)
    if not 0 <= shift < ws:
        raise ValueError(f"{name}: shift {shift} outside [0, {ws})")
    f32_block_plan(H, W, C, hidden, ws, num_heads)   # raises on a shape outside the design
    dev = x.device
    f = lambda t: _f32(t, dev)
    if bqkv is None:
        bqkv = torch.zeros(3 * C, device=dev)
    _check_vec(name, ln1_scale=(ln1[0], C), ln1_bias=(ln1[1], C), bqkv=(bqkv, 3 * C),
               bproj=(bproj, C), ln2_scale=(ln2[0], C), ln2_bias=(ln2[1], C), b1=(b1, hidden),
               b2=(b2, C))
    out = torch.empty_like(x)
    args = [f(ln1[0]), f(ln1[1]), wqkv, f(bqkv), wproj, f(bproj), f(ln2[0]), f(ln2[1]), w1,
            f(b1), w2, f(b2), f(bias), f(mask)]
    err = _build.library().sunet_f32_block(
        _build.ptr(x), _build.ptr(out), *[_build.ptr(a) for a in args], B, H, W, C, hidden, ws,
        num_heads, shift, float(scale), _build.stream())
    _build.check(name, err)
    return out


# ---------------------------------------------------------------- wrappers


def fused_swin_block(x, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2, b2,
                     bias, mask, drop_path_scale=None, *, ws: int,
                     num_heads: int, scale: float,
                     shift: int = 0, plan_hw: Optional[tuple] = None) -> torch.Tensor:
    """One whole Swin block over an NHWC map, x UNROLLED (caller
    coordinates). With ``shift > 0`` the SW-MSA roll and unroll happen
    inside the kernel as load/store addressing; ``mask`` is the
    rolled-space SW-MSA mask (None when shift == 0). ``drop_path_scale``:
    optional (B, 2) float32 per-image scales of the attention and MLP
    branches (stochastic depth); None means ones.

    The form follows from the window and the call (:func:`seq_form`): up
    to 64 tokens the cluster kernel (csrc/swin_cluster.cu, one launch,
    :func:`block_plan`); above, the sequence form (csrc/swin_block_seq.cu,
    SWIN_BLOCK_SEQ_LAUNCHES launches on gemm_tile.cuh and wmsa_attn.cuh's
    attention, :func:`block_seq_plan`), whose train form
    (``drop_path_scale`` given) takes C up to TRAIN_BLOCK_MAX_C, its
    inference form up to BLOCK_KERNEL_MAX_C. The train form also takes the
    blocks up to 64 tokens that the cluster kernel refuses (C above 384, a
    head dim above 64, no cluster size), with the 64-token attention; an
    inference call of such a block raises. The
    weight matrices may come with their columns padded as the kernels store
    them (:func:`wcols`). ``plan_hw``: the (H, W) of the map whose launch
    plan the call takes, x's by default; a spatial shard of a larger map
    takes the map's, so that its windows get the unsharded map's bits
    (``parallel/spatial.py``). Inside a trace it is the op
    ``sunet::fused_swin_block`` (``kernels/ops.py``), with x's plan."""
    if torch.compiler.is_compiling():
        if plan_hw is not None:
            raise NotImplementedError("fused_swin_block: plan_hw inside a trace (the "
                                      "parallel tier is not exported)")
        return torch.ops.sunet.fused_swin_block(
            x, ln1[0], ln1[1], wqkv, bqkv, wproj, bproj, ln2[0], ln2[1], w1, b1, w2, b2, bias,
            mask, drop_path_scale, ws=ws, num_heads=num_heads, scale=scale, shift=shift)
    return _counted_block("fused_swin_block", x, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2,
                          b2, bias, mask, drop_path_scale, ws=ws, num_heads=num_heads,
                          scale=scale, shift=shift, plan_hw=plan_hw)


def _counted_block(name, x, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2, b2, bias, mask,
                   dp=None, *, ws: int, num_heads: int, scale: float, shift: int,
                   plan_hw: Optional[tuple] = None):
    """One block by the form its window, training use, dtype and device
    take, its launches added to wrapper ``name``'s count: the plain version
    on a CPU tensor (the weights unpadded), else the cluster kernel or the
    sequence form (:func:`seq_form`; its train form at 64 tokens a window
    also counted under SEQ64_FORM), on the plan of ``plan_hw`` (default
    x's (H, W)), or in float32 the float32 form (an inference form: a call
    with ``dp`` is a training call)."""
    count = _build.counter(name)
    kw = dict(ws=ws, num_heads=num_heads, scale=scale, shift=shift)
    C = x.shape[-1]
    seq = seq_form(C, w1.shape[1], num_heads, ws, dp is not None)
    form = _build.counter(SEQ64_FORM) if seq and ws * ws <= _TILE else None
    if x.device.type == "cpu":
        count.cpu += block_launches(ws, seq)
        if form:
            form.cpu += block_launches(ws, seq)
        return fused_swin_block_reference(
            x, ln1, _unpadded(wqkv, 3 * C), bqkv, _unpadded(wproj, C), bproj, ln2, w1, b1,
            _unpadded(w2, C), b2, bias, mask, dp, **kw)
    _gate(name, x, tokens=ws * ws, train=dp is not None)
    if x.dtype == torch.float32:
        out = _launch_block_f32(x, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2, b2, bias,
                                mask, **kw)
        count.cuda += 1
        return out
    if seq:
        out, n = _launch_block_seq(x, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2, b2, bias,
                                   mask, dp, plan_hw=plan_hw, **kw)
        count.cuda += n
        if form:
            form.cuda += n
        return out
    out = _launch_block(x, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2, b2, bias, mask, dp,
                        plan_hw=plan_hw, **kw)
    count.cuda += 1
    return out


def swin_block_bwd(x, dout, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2,
                   b2, bias, mask, drop_path_scale, *, ws: int,
                   num_heads: int, scale: float, shift: int = 0) -> tuple:
    """Backward of :func:`fused_swin_block` (JAX ``_block_bwd_impl``, the
    recompute form): x UNROLLED as in the forward, dout its cotangent.
    Returns (dx, then float32 grads of ln1 g/b, wqkv, bqkv, wproj, bproj,
    ln2 g/b, w1, b1, w2, b2, bias). CUDA: ``csrc/swin_block_bwd.cu``, the
    SWIN_BLOCK_BWD_LAUNCHES launches of ``csrc/swin_block_bwd.cuh``
    (:func:`block_bwd_plan`), each counted (at a head dim above
    BWD_RES_MAX_HEAD_DIM also under BWD_WIDE_HEAD_FORM), up to 64 tokens a
    window at C up to BWD_MAX_C and an even head dim whose attention fits
    shared memory (:func:`block_bwd_why`); above 64 tokens a window its
    big-window form's SWIN_BLOCK_BWD_BIG_LAUNCHES over C rounded up to 16
    (the operands zero-padded and the grads cut back here,
    :func:`pad_block_operands`), C a multiple of 4 up to BWD_MAX_C. The
    weight matrices may come with their columns padded (:func:`wcols`)."""
    name = "swin_block_bwd"
    count = _build.counter(name)
    C = x.shape[-1]
    wide = (_build.counter(BWD_WIDE_HEAD_FORM) if ws * ws <= _TILE and num_heads > 0
            and C // num_heads > BWD_RES_MAX_HEAD_DIM else None)
    if x.device.type == "cpu":
        count.cpu += block_bwd_launches(ws)
        if wide:
            wide.cpu += block_bwd_launches(ws)
        return swin_block_bwd_reference(
            x, dout, ln1, _unpadded(wqkv, 3 * C), bqkv, _unpadded(wproj, C), bproj, ln2, w1,
            b1, _unpadded(w2, C), b2, bias, mask, drop_path_scale, ws=ws,
            num_heads=num_heads, scale=scale, shift=shift)
    if ws * ws > _TILE:
        g, n = _swin_block_bwd_big(x, dout, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2, b2,
                                   bias, mask, drop_path_scale, ws=ws, num_heads=num_heads,
                                   scale=scale, shift=shift)
        count.cuda += n
        return g
    _check_block(name, x, wqkv, wproj, w1, w2, bias, mask, ws, num_heads,
                 shift, drop_path_scale, cap=None)
    B, H, W, C = x.shape
    hidden = w1.shape[1]
    _check_bwd_design(name, C, hidden, num_heads, ws)
    dev = x.device
    f = lambda t: _f32(t, dev)
    dout = dout.to(BF16).contiguous()
    dp = (torch.ones(B, 2, device=dev) if drop_path_scale is None
          else f(drop_path_scale))
    lib = _build.library()
    work = _workspace(lib.sunet_swin_block_bwd_workspace, dev, B, H, W, C, hidden,
                      ws, num_heads)
    dx = torch.empty_like(x)
    z = lambda *s: torch.empty(*s, device=dev, dtype=torch.float32)
    grads = [z(C), z(C), z(C, 3 * C), z(3 * C), z(C, C), z(C), z(C), z(C),
             z(C, hidden), z(hidden), z(hidden, C), z(C),
             z(num_heads, ws * ws, ws * ws)]
    args = [f(ln1[0]), f(ln1[1]), wqkv, f(bqkv), wproj, f(bproj), f(ln2[0]),
            f(ln2[1]), w1, f(b1), w2, f(b2), f(bias), f(mask), dp]
    launches = _build.c_int(0)
    err = lib.sunet_swin_block_bwd(
        _build.ptr(x), _build.ptr(dout), *[_build.ptr(a) for a in args],
        _build.ptr(dx), *[_build.ptr(g) for g in grads], _build.ptr(work),
        B, H, W, C, hidden, ws, num_heads, shift, float(scale),
        _build.byref(launches), _build.stream())
    _build.check(name, err)
    count.cuda += launches.value
    if wide:
        wide.cuda += launches.value
    return (dx, *grads)


def _pad_rows(t: torch.Tensor, Cp: int, blocks: int = 1) -> torch.Tensor:
    """t's last axis, ``blocks`` blocks of C values (q, k, v for 3), each
    zero-padded to Cp."""
    C = t.shape[-1] // blocks
    if C == Cp:
        return t.contiguous()
    t = t.reshape(*t.shape[:-1], blocks, C)
    return torch.nn.functional.pad(t, (0, Cp - C)).reshape(*t.shape[:-2], blocks * Cp)


def _unpad_rows(t: torch.Tensor, C: int, blocks: int = 1) -> torch.Tensor:
    """The inverse of :func:`_pad_rows`: each of the last axis's blocks cut
    back to C values."""
    Cp = t.shape[-1] // blocks
    if C == Cp:
        return t
    return t.reshape(*t.shape[:-1], blocks, Cp)[..., :C].reshape(*t.shape[:-1], blocks * C)


def pad_block_operands(C: int, Cp: int, x, dout, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1,
                       w2, b2) -> tuple:
    """The block backward's operands at width Cp >= C (the big-window form's
    rows, :func:`block_bwd_width`): x and dout with Cp - C zero channels;
    the LN parameters, biases and the weights' C-sized axes zero-padded,
    qkv's q, k and v blocks each to Cp. Every product then gives zeros in
    the pad channels, and the pad rows and columns of the weights take no
    part in the real ones."""
    v = lambda t, blocks=1: _pad_rows(t, Cp, blocks)
    rows = lambda w: (w.contiguous() if C == Cp
                      else torch.nn.functional.pad(w, (0, 0, 0, Cp - C)).contiguous())
    return (v(x), v(dout), (v(ln1[0]), v(ln1[1])), rows(v(wqkv, 3)), v(bqkv, 3),
            rows(v(wproj)), v(bproj), (v(ln2[0]), v(ln2[1])), rows(w1), b1, v(w2), v(b2))


def unpad_block_grads(C: int, grads: tuple) -> tuple:
    """:func:`swin_block_bwd`'s (dx, 13 grads) at width Cp cut back to C
    (the pad channels' gradients dropped)."""
    (dx, dg1, db1, dwqkv, dbqkv, dwproj, dbproj, dg2, db2, dw1, dbm1, dw2, dbm2,
     dbias) = grads
    Cp = dx.shape[-1]
    if C == Cp:
        return grads
    r = lambda t: _unpad_rows(t, C)
    return (r(dx).contiguous(), r(dg1), r(db1), _unpad_rows(dwqkv[:C], C, 3),
            _unpad_rows(dbqkv, C, 3), r(dwproj[:C]), r(dbproj), r(dg2), r(db2), dw1[:C],
            dbm1, r(dw2), r(dbm2), dbias)


def _swin_block_bwd_big(x, dout, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2, b2, bias,
                        mask, drop_path_scale, *, ws: int, num_heads: int, scale: float,
                        shift: int) -> tuple:
    """:func:`swin_block_bwd` above 64 tokens a window: the big-window form
    (csrc/swin_block_bwd.cu's big entry, csrc/block_bwd_big.cuh's
    attention) over rows of :func:`block_bwd_width` channels. Returns
    (dx and the grads, kernel launches)."""
    name = "swin_block_bwd"
    _check_x(name, x)
    B, H, W, C = x.shape
    hidden = w1.shape[1]
    wqkv, wproj, w2 = (_unpadded(wqkv, 3 * C), _unpadded(wproj, C), _unpadded(w2, C))
    _check_w(name, x, wqkv=(wqkv.contiguous(), (C, 3 * C)), wproj=(wproj.contiguous(), (C, C)),
             w1=(w1, (C, hidden)), w2=(w2.contiguous(), (hidden, C)))
    _check_bwd_design(name, C, hidden, num_heads, ws)
    _check_window(name, H, W, C, ws, num_heads, bias, mask, c_align=4)
    if not 0 <= shift < ws:
        raise ValueError(f"{name}: shift {shift} outside [0, {ws})")
    if drop_path_scale is not None and tuple(drop_path_scale.shape) != (B, 2):
        raise ValueError(f"{name}: drop_path_scale shape {tuple(drop_path_scale.shape)}, "
                         f"expected {(B, 2)}")
    dout = _check_dout(name, x, dout)
    dev = x.device
    f = lambda t: _f32(t, dev)
    if bqkv is None:
        bqkv = torch.zeros(3 * C, device=dev)
    _check_vec(name, ln1_scale=(ln1[0], C), ln1_bias=(ln1[1], C), bqkv=(bqkv, 3 * C),
               bproj=(bproj, C), ln2_scale=(ln2[0], C), ln2_bias=(ln2[1], C), b1=(b1, hidden),
               b2=(b2, C))
    Cp = block_bwd_plan(H, W, C, hidden, ws, num_heads)["Cp"]
    xp, dp_out, ln1p, wqkvp, bqkvp, wprojp, bprojp, ln2p, w1p, b1p, w2p, b2p = (
        pad_block_operands(C, Cp, x, dout, (f(ln1[0]), f(ln1[1])), wqkv, f(bqkv), wproj,
                           f(bproj), (f(ln2[0]), f(ln2[1])), w1, f(b1), w2, f(b2)))
    dp = (torch.ones(B, 2, device=dev) if drop_path_scale is None else f(drop_path_scale))
    lib = _build.library()
    work = _workspace(lib.sunet_swin_block_bwd_big_workspace, dev, B, H, W, Cp, C, hidden, ws,
                      num_heads)
    dx = torch.empty_like(xp)
    z = lambda *s: torch.empty(*s, device=dev, dtype=torch.float32)
    grads = [z(Cp), z(Cp), z(Cp, 3 * Cp), z(3 * Cp), z(Cp, Cp), z(Cp), z(Cp), z(Cp),
             z(Cp, hidden), z(hidden), z(hidden, Cp), z(Cp), z(num_heads, ws * ws, ws * ws)]
    args = [*ln1p, wqkvp, bqkvp, wprojp, bprojp, *ln2p, w1p, b1p, w2p, b2p, f(bias), f(mask), dp]
    launches = _build.c_int(0)
    err = lib.sunet_swin_block_bwd_big(
        _build.ptr(xp), _build.ptr(dp_out), *[_build.ptr(a) for a in args], _build.ptr(dx),
        *[_build.ptr(g) for g in grads], _build.ptr(work), B, H, W, Cp, C, hidden, ws,
        num_heads, shift, float(scale), _build.byref(launches), _build.stream())
    _build.check(name, err)
    return unpad_block_grads(C, (dx, *grads)), launches.value


class SwinBlockTrainable(torch.autograd.Function):
    """Differentiable whole Swin block (JAX ``swin_block_trainable``):
    forward = the block kernel's train form with per-image drop-path scales
    ``dp`` (the cluster kernel, or the sequence form, :func:`seq_form`),
    backward = :func:`swin_block_bwd`. Weights come in float32, (in, out)
    layout, and are cast to x's dtype for the kernels; their grads come back
    in float32. ``dp``, ``mask`` and the static arguments get no gradient.
    ``plan_hw``: the forward's launch plan's (H, W) (:func:`fused_swin_block`)."""

    @staticmethod
    def forward(ctx, x, ln1_s, ln1_b, wqkv, bqkv, wproj, bproj, ln2_s, ln2_b,
                w1, b1, w2, b2, bias, dp, mask, ws, num_heads, scale, shift, plan_hw=None):
        dt = x.dtype
        cast = lambda w: w.detach().to(dt).contiguous()
        x = x.contiguous()
        p = (ln1_s.detach(), ln1_b.detach(), cast(wqkv),
             None if bqkv is None else bqkv.detach(), cast(wproj),
             bproj.detach(), ln2_s.detach(), ln2_b.detach(), cast(w1),
             b1.detach(), cast(w2), b2.detach(), bias.detach())
        ctx.save_for_backward(x, dp, mask, *p)
        ctx.static = (ws, num_heads, scale, shift)
        _gate("fused_swin_block", x, tokens=ws * ws, train=True)
        return _counted_block(
            "fused_swin_block", x, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10],
            p[11], p[12], mask, dp, ws=ws, num_heads=num_heads, scale=scale, shift=shift,
            plan_hw=plan_hw)

    @staticmethod
    def backward(ctx, dout):
        ws, num_heads, scale, shift = ctx.static
        x, dp, mask, *p = ctx.saved_tensors
        g = list(swin_block_bwd(
            x, dout.contiguous(), p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8],
            p[9], p[10], p[11], p[12], mask, dp, ws=ws, num_heads=num_heads,
            scale=scale, shift=shift))
        if p[3] is None:
            g[4] = None
        return (*g, None, None, None, None, None, None, None)


def swin_block_trainable_dynmask(x, ln1_s, ln1_b, wqkv, bqkv, wproj, bproj, ln2_s, ln2_b, w1,
                                 b1, w2, b2, bias, dp, mask, ws: int, num_heads: int,
                                 scale: float, plan_hw: Optional[tuple] = None) -> torch.Tensor:
    """:class:`SwinBlockTrainable` at shift 0 with the SW-MSA mask as an
    input (JAX ``swin_block_trainable_dynmask``, B5): the spatial runner
    rolls its shard outside the kernel (W locally, H by one exchange) and
    passes its (nW_local, N, N) slice of the global rolled-space mask, which
    takes no gradient (None at a block without shift). Forward: the block
    kernel's train form (its sequence form above 64 tokens a window and at
    a block the cluster kernel refuses);
    backward: :func:`swin_block_bwd` (its big-window form above 64), both
    reading the mask at shift 0. ``plan_hw``: the whole map's (H, W), whose
    launch plan the shard's forward takes."""
    _gate("swin_block_trainable_dynmask", x, tokens=ws * ws, train=True)
    if mask is not None:
        mask = mask.detach().contiguous()
    return SwinBlockTrainable.apply(x, ln1_s, ln1_b, wqkv, bqkv, wproj, bproj, ln2_s, ln2_b, w1,
                                    b1, w2, b2, bias, dp, mask, ws, num_heads, scale, 0, plan_hw)


def fused_swin_block_res(x, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2, b2,
                         bias, mask, drop_path_scale=None, *, ws: int,
                         num_heads: int, scale: float, shift: int = 0) -> tuple:
    """The residual route's training forward (JAX ``fused_swin_block_res``):
    the block of :func:`fused_swin_block` whose softmax normalises by the
    reciprocal of the rounded exponentials' sum, and which also returns the
    attention state its backward :func:`swin_block_bwd_res` differentiates.
    Returns (out, eb (B*nW, h, N, N) in x's dtype, rden (B*nW, h, N)
    float32, ctx_f (B*H*W, C) float32), the residuals in window-major order
    of the rolled map. CUDA: ``csrc/swin_cluster.cu``'s residual form, one
    launch on :func:`block_plan`'s cluster."""
    count = _build.counter("fused_swin_block_res")
    if x.device.type == "cpu":
        count.cpu += 1
        return fused_swin_block_res_reference(
            x, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2, b2, bias, mask,
            drop_path_scale, ws=ws, num_heads=num_heads, scale=scale, shift=shift)
    out = _launch_block(x, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2, b2, bias,
                        mask, drop_path_scale, ws=ws, num_heads=num_heads, scale=scale,
                        shift=shift, res=True)
    count.cuda += 1
    return out


def _check_res(name: str, x, eb, rden, ctx, ws: int, num_heads: int):
    """The residuals have the layouts :func:`fused_swin_block_res` gives."""
    B, H, W, C = x.shape
    N = ws * ws
    nwin = B * (H // ws) * (W // ws)
    for rname, t, shape, dtype in (("eb", eb, (nwin, num_heads, N, N), BF16),
                                   ("rden", rden, (nwin, num_heads, N), torch.float32),
                                   ("ctx", ctx, (B * H * W, C), torch.float32)):
        if (t.device != x.device or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {rname} must be a contiguous {dtype} tensor of "
                             f"shape {shape} on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def swin_block_bwd_res(x, dout, eb, rden, ctx, ln1, wqkv, bqkv, wproj, bproj, ln2,
                       w1, b1, w2, b2, drop_path_scale, *, ws: int, num_heads: int,
                       scale: float, shift: int = 0) -> tuple:
    """Backward of :func:`fused_swin_block_res` (JAX ``_block_bwd_impl_res``)
    from x (unrolled, as in the forward), its output's cotangent ``dout``
    and the forward's residuals eb, rden and ctx; no rel-pos bias or mask.
    Returns (dx, then float32 grads of ln1 g/b, wqkv, bqkv, wproj, bproj,
    ln2 g/b, w1, b1, w2, b2, bias). CUDA: ``csrc/swin_block_bwd_res.cu``, the
    SWIN_BLOCK_BWD_RES_LAUNCHES launches of ``csrc/swin_block_bwd.cuh``
    (:func:`block_bwd_plan`), each counted."""
    name = "swin_block_bwd_res"
    count = _build.counter(name)
    if x.device.type == "cpu":
        count.cpu += SWIN_BLOCK_BWD_RES_LAUNCHES
        return swin_block_bwd_res_reference(
            x, dout, eb, rden, ctx, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2, b2,
            drop_path_scale, ws=ws, num_heads=num_heads, scale=scale, shift=shift)
    _check_block(name, x, wqkv, wproj, w1, w2, None, None, ws, num_heads, shift,
                 drop_path_scale, no_bias=True)
    _check_res(name, x, eb, rden, ctx, ws, num_heads)
    dout = _check_dout(name, x, dout)
    B, H, W, C = x.shape
    hidden = w1.shape[1]
    _check_bwd_design(name, C, hidden, num_heads, ws)
    dev = x.device
    f = lambda t: _f32(t, dev)
    dp = (torch.ones(B, 2, device=dev) if drop_path_scale is None
          else f(drop_path_scale))
    lib = _build.library()
    work = _workspace(lib.sunet_swin_block_bwd_res_workspace, dev, B, H, W, C, hidden,
                      ws, num_heads)
    dx = torch.empty_like(x)
    z = lambda *s: torch.empty(*s, device=dev, dtype=torch.float32)
    grads = [z(C), z(C), z(C, 3 * C), z(3 * C), z(C, C), z(C), z(C), z(C),
             z(C, hidden), z(hidden), z(hidden, C), z(C),
             z(num_heads, ws * ws, ws * ws)]
    args = [eb, rden, ctx, f(ln1[0]), f(ln1[1]), wqkv, f(bqkv), wproj, f(bproj),
            f(ln2[0]), f(ln2[1]), w1, f(b1), w2, f(b2), dp]
    launches = _build.c_int(0)
    err = lib.sunet_swin_block_bwd_res(
        _build.ptr(x), _build.ptr(dout), *[_build.ptr(a) for a in args],
        _build.ptr(dx), *[_build.ptr(g) for g in grads], _build.ptr(work),
        B, H, W, C, hidden, ws, num_heads, shift, float(scale),
        _build.byref(launches), _build.stream())
    _build.check(name, err)
    count.cuda += launches.value
    return (dx, *grads)


class SwinBlockTrainableRes(torch.autograd.Function):
    """Differentiable whole Swin block on the residual route (JAX
    ``swin_block_trainable_res``): forward = :func:`fused_swin_block_res`
    with per-image drop-path scales ``dp``, whose residuals are saved for
    backward = :func:`swin_block_bwd_res`. Arguments, casts and returned
    grads as :class:`SwinBlockTrainable`'s; ``dp``, ``mask`` and the static
    arguments get no gradient."""

    @staticmethod
    def forward(ctx, x, ln1_s, ln1_b, wqkv, bqkv, wproj, bproj, ln2_s, ln2_b,
                w1, b1, w2, b2, bias, dp, mask, ws, num_heads, scale, shift):
        dt = x.dtype
        cast = lambda w: w.detach().to(dt).contiguous()
        x = x.contiguous()
        p = (ln1_s.detach(), ln1_b.detach(), cast(wqkv),
             None if bqkv is None else bqkv.detach(), cast(wproj),
             bproj.detach(), ln2_s.detach(), ln2_b.detach(), cast(w1),
             b1.detach(), cast(w2), b2.detach())
        out, eb, rden, cf = fused_swin_block_res(
            x, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10], p[11],
            bias.detach(), mask, dp, ws=ws, num_heads=num_heads, scale=scale,
            shift=shift)
        ctx.save_for_backward(x, dp, eb, rden, cf, *p)
        ctx.static = (ws, num_heads, scale, shift)
        return out

    @staticmethod
    def backward(ctx, dout):
        ws, num_heads, scale, shift = ctx.static
        x, dp, eb, rden, cf, *p = ctx.saved_tensors
        g = list(swin_block_bwd_res(
            x, dout.contiguous(), eb, rden, cf, p[0:2], p[2], p[3], p[4], p[5], p[6:8],
            p[8], p[9], p[10], p[11], dp, ws=ws, num_heads=num_heads, scale=scale,
            shift=shift))
        if p[3] is None:
            g[4] = None
        return (*g, None, None, None, None, None, None)


def fused_swin_block_chain(x, params_list: list, biases: list, mask, *,
                           ws: int, num_heads: int, scale: float,
                           shifts: tuple) -> torch.Tensor:
    """K consecutive Swin blocks (inference), x UNROLLED.

    params_list: K 12-tuples (ln1_s, ln1_b, wqkv, bqkv, wproj, bproj, ln2_s,
    ln2_b, w1, b1, w2, b2); biases: K (h, N, N); shifts: K shift sizes (0 =
    W-MSA, >0 = SW-MSA with the shared rolled-space ``mask``). Equals K
    :func:`fused_swin_block` calls exactly: the output of each block is
    rounded to the compute dtype at the seam. Inside a trace it is the op
    ``sunet::fused_swin_block_chain``, the K 12-tuples flat in one list."""
    if torch.compiler.is_compiling():
        C = x.shape[-1]
        flat = [t if t is not None else x.new_zeros(3 * C, dtype=torch.float32)
                for p in params_list for t in p]
        return torch.ops.sunet.fused_swin_block_chain(
            x, flat, list(biases), mask, ws=ws, num_heads=num_heads, scale=scale,
            shifts=list(shifts))
    return _chain_impl(x, params_list, biases, mask, ws=ws, num_heads=num_heads, scale=scale,
                       shifts=shifts)


def _chain_impl(x, params_list: list, biases: list, mask, *, ws: int, num_heads: int,
                scale: float, shifts: tuple) -> torch.Tensor:
    K = len(params_list)
    if not (K == len(biases) == len(shifts) and K >= 1):
        raise ValueError("fused_swin_block_chain: params, biases and shifts "
                         "must have the same length >= 1")
    for p, bias, s in zip(params_list, biases, shifts):
        x = _counted_block("fused_swin_block_chain", x, p[0:2], *p[2:6], p[6:8], *p[8:12], bias,
                           mask if s else None, ws=ws, num_heads=num_heads, scale=scale,
                           shift=s)
    return x


def fused_ln_window_attention(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                              bias, mask, *, ws: int, num_heads: int,
                              scale: float) -> torch.Tensor:
    """LN + window partition + W-MSA + reverse + proj; x RAW (pre-LN) and
    already rolled by the caller. Returns the sublayer output before the
    residual, NHWC, in x's dtype. CUDA: ``csrc/ln_window_attention.cu``,
    LN_WMSA_LAUNCHES launches (:func:`wmsa_plan`), each counted. Inside a
    trace it is the op ``sunet::fused_ln_window_attention``."""
    if torch.compiler.is_compiling():
        return torch.ops.sunet.fused_ln_window_attention(
            x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, bias, mask, ws=ws,
            num_heads=num_heads, scale=scale)
    return _ln_window_attention_impl(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, bias,
                                     mask, ws=ws, num_heads=num_heads, scale=scale)


def _ln_window_attention_impl(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, bias, mask, *,
                              ws: int, num_heads: int, scale: float) -> torch.Tensor:
    name = "fused_ln_window_attention"
    count = _build.counter(name)
    C = x.shape[-1]
    if x.device.type == "cpu":
        count.cpu += LN_WMSA_LAUNCHES
        return fused_ln_window_attention_reference(
            x, ln_scale, ln_bias, _unpadded(wqkv, 3 * C), bqkv, _unpadded(wproj, C), bproj,
            bias, mask, ws=ws, num_heads=num_heads, scale=scale)
    _gate(name, x, tokens=ws * ws)
    _check_x(name, x)
    B, H, W, C = x.shape
    if x.dtype == torch.float32:
        wqkv, wproj = _unpadded(wqkv, 3 * C).contiguous(), _unpadded(wproj, C).contiguous()
    _check_w(name, x, wqkv=(wqkv, (C, 3 * C)), wproj=(wproj, (C, C)))
    _check_window(name, H, W, C, ws, num_heads, bias, mask)
    dev = x.device
    f = lambda t: _f32(t, dev)
    if bqkv is None:
        bqkv = torch.zeros(3 * C, device=dev)
    lib = _build.library()
    if x.dtype == torch.float32:
        f32_wmsa_plan(H, W, C, num_heads, ws)   # raises on a shape outside the design
        _check_vec(name, ln_scale=(ln_scale, C), ln_bias=(ln_bias, C), bqkv=(bqkv, 3 * C),
                   bproj=(bproj, C))
        work = _workspace(lib.sunet_f32_ln_wmsa_workspace, dev, B * H * W, C)
        out = torch.empty_like(x)
        launches = _build.c_int(0)
        err = lib.sunet_f32_ln_wmsa(
            _build.ptr(x), _build.ptr(out),
            *[_build.ptr(a) for a in (f(ln_scale), f(ln_bias), wqkv, f(bqkv), wproj, f(bproj),
                                       f(bias), f(mask))],
            _build.ptr(work), B, H, W, C, ws, num_heads, float(scale),
            _build.byref(launches), _build.stream())
        _build.check(name, err)
        count.cuda += launches.value
        return out
    plan = wmsa_plan(H, W, C, num_heads, ws)
    work = _workspace(lib.sunet_ln_wmsa_workspace, dev, B * H * W, C)
    out = torch.empty_like(x)
    args = [f(ln_scale), f(ln_bias), wqkv, f(bqkv), wproj, f(bproj), f(bias), f(mask)]
    launches = _build.c_int(0)
    err = lib.sunet_ln_wmsa(
        _build.ptr(x), _build.ptr(out), *[_build.ptr(a) for a in args], _build.ptr(work),
        B, H, W, C, ws, num_heads, float(scale), plan["ksq"], plan["ks"],
        _build.byref(launches), _build.stream())
    _build.check(name, err)
    count.cuda += launches.value
    return out


def _check_windows(name, xw, wqkv, bqkv, wproj, bproj, bias, mask, num_heads):
    """wmsa_core's checks: xw a contiguous (T, N, C) bf16 CUDA tensor of
    square windows, T a multiple of the masks' nW, the weights, and the
    window checks of the nW windows of one image side by side."""
    if xw.device.type != "cuda":
        raise ValueError(f"{name}: tensor on {xw.device}; the kernel takes CUDA "
                         "tensors and the plain version CPU tensors")
    _gate(name, xw)
    if xw.dtype != BF16 or xw.dim() != 3 or not xw.is_contiguous():
        raise ValueError(f"{name}: xw must be a contiguous (T, N, C) bfloat16 "
                         f"tensor, got {xw.dtype} {tuple(xw.shape)}")
    T, N, C = xw.shape
    ws = math.isqrt(N)
    _check_w(name, xw, wqkv=(wqkv, (C, 3 * C)), wproj=(wproj, (C, C)))
    nW = 1 if mask is None else mask.shape[0]
    if ws * ws != N or T % nW:
        raise ValueError(f"{name}: {T} windows of {N} tokens with {nW} masks")
    if N > _TILE:
        raise ValueError(f"{name}: windows of {N} tokens; the standalone W-MSA takes at most "
                         f"{_TILE} (no model route runs it on larger windows)")
    _check_window(name, ws, ws * nW, C, ws, num_heads, bias, mask)
    _check_vec(name, bqkv=(bqkv, 3 * C), bproj=(bproj, C))


def wmsa_core(xw, wqkv, bqkv, wproj, bproj, bias, mask, *, num_heads: int,
              scale: float) -> torch.Tensor:
    """W-MSA over pre-partitioned windows (JAX ``wmsa_core``): xw (T, N, C),
    T = B * nW windows in image-major order; bqkv may be None; mask (nW,
    N, N) additive or None, window t taking mask[t % nW]. Returns (T, N, C)
    in xw's dtype. CUDA: ``csrc/window_attention.cu``, WMSA_CORE_LAUNCHES
    launches (qkv, attention, projection; :func:`wmsa_plan` over one image's
    windows side by side), each counted."""
    name = "wmsa_core"
    count = _build.counter(name)
    T, N, C = xw.shape
    ws = math.isqrt(N)
    if xw.device.type == "cpu":
        count.cpu += WMSA_CORE_LAUNCHES
        return wmsa_core_reference(xw, wqkv, bqkv, wproj, bproj, bias, mask,
                                   num_heads=num_heads, scale=scale)
    _check_windows(name, xw, wqkv, bqkv, wproj, bproj, bias, mask, num_heads)
    nW = 1 if mask is None else mask.shape[0]
    # the nW windows of one image, side by side: a (ws, nW*ws) map
    plan = wmsa_plan(ws, ws * nW, C, num_heads, ws)
    dev = xw.device
    f = lambda t: _f32(t, dev)
    if bqkv is None:
        bqkv = torch.zeros(3 * C, device=dev)
    lib = _build.library()
    work = _workspace(lib.sunet_ln_wmsa_workspace, dev, T * N, C)
    out = torch.empty_like(xw)
    launches = _build.c_int(0)
    err = lib.sunet_wmsa_core(
        _build.ptr(xw), _build.ptr(out), _build.ptr(wqkv), _build.ptr(f(bqkv)),
        _build.ptr(wproj), _build.ptr(f(bproj)), _build.ptr(f(bias)), _build.ptr(f(mask)),
        _build.ptr(work), T, nW, ws, C, num_heads, float(scale), plan["ksq"], plan["ks"],
        _build.byref(launches), _build.stream())
    _build.check(name, err)
    count.cuda += launches.value
    return out


def fused_window_attention(x, wqkv, bqkv, wproj, bproj, bias, mask, *, ws: int,
                           num_heads: int, scale: float) -> torch.Tensor:
    """W-MSA sublayer over a pre-normalized, pre-rolled NHWC map (JAX
    ``fused_window_attention``): x (B, H, W, C) -> the attention output
    before the residual, same shape and dtype. The window partition and
    reverse are torch ops around :func:`wmsa_core`."""
    H, W = x.shape[1:3]
    if H % ws or W % ws:
        raise ValueError(f"fused_window_attention: ({H},{W}) not divisible by "
                         f"window {ws}")
    out = wmsa_core(window_partition(x, ws).contiguous(), wqkv, bqkv, wproj,
                    bproj, bias, mask, num_heads=num_heads, scale=scale)
    return window_reverse(out, ws, H, W)


def fused_ln_mlp(y, ln, w1, b1, w2, b2) -> torch.Tensor:
    """y + fc2(gelu(fc1(LN(y)))) over an NHWC map, in y's dtype. CUDA:
    ``csrc/ln_mlp.cu``, three launches (LN, fc1, fc2 on a K-split cluster;
    :func:`mlp_plan`), each counted. Inside a trace it is the op
    ``sunet::fused_ln_mlp``."""
    if torch.compiler.is_compiling():
        return torch.ops.sunet.fused_ln_mlp(y, ln[0], ln[1], w1, b1, w2, b2)
    return _ln_mlp_impl(y, ln, w1, b1, w2, b2)


def _ln_mlp_impl(y, ln, w1, b1, w2, b2) -> torch.Tensor:
    name = "fused_ln_mlp"
    count = _build.counter(name)
    if y.device.type == "cpu":
        count.cpu += LN_MLP_LAUNCHES
        return fused_ln_mlp_reference(y, ln, w1, b1, _unpadded(w2, y.shape[-1]), b2)
    _check_x(name, y)
    B, H, W, C = y.shape
    hidden = w1.shape[1]
    if C % 16 or hidden % 16:
        raise ValueError(f"{name}: C={C}, hidden={hidden}: the kernel takes "
                         "multiples of 16")
    _check_w(name, y, w1=(w1, (C, hidden)), w2=(w2, (hidden, C)))
    _check_vec(name, ln_scale=(ln[0], C), ln_bias=(ln[1], C), b1=(b1, hidden), b2=(b2, C))
    M = B * H * W
    dev = y.device
    f = lambda t: _f32(t, dev)
    lib = _build.library()
    if y.dtype == torch.float32:
        f32_mlp_plan(H * W, C, hidden)   # raises on a width outside the design
        work = _workspace(lib.sunet_f32_ln_mlp_workspace, dev, M, hidden)
        out = torch.empty_like(y)
        launches = _build.c_int(0)
        err = lib.sunet_f32_ln_mlp(
            _build.ptr(y), _build.ptr(out),
            *[_build.ptr(a) for a in (f(ln[0]), f(ln[1]), w1, f(b1), w2, f(b2))],
            _build.ptr(work), M, C, hidden, _build.byref(launches), _build.stream())
        _build.check(name, err)
        count.cuda += launches.value
        return out
    plan = mlp_plan(H * W, C, hidden)   # raises on a width outside the design
    work = _workspace(lib.sunet_ln_mlp_workspace, dev, M, C, hidden)
    out = torch.empty_like(y)
    args = [f(ln[0]), f(ln[1]), w1, f(b1), w2, f(b2)]
    launches = _build.c_int(0)
    err = lib.sunet_ln_mlp(
        _build.ptr(y), _build.ptr(out), *[_build.ptr(a) for a in args], _build.ptr(work),
        M, C, hidden, plan["ks1"], plan["ks"], _build.byref(launches),
        _build.stream())
    _build.check(name, err)
    count.cuda += launches.value
    return out


# ---------------------------------------------------------------- training sublayers


def _check_vec(name: str, **vecs):
    """Each given vector (None allowed) holds exactly its length of values."""
    for vname, (v, n) in vecs.items():
        if v is not None and v.numel() != n:
            raise ValueError(f"{name}: {vname} has {v.numel()} values, expected {n}")


def _check_dout(name: str, x: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    if tuple(dout.shape) != tuple(x.shape) or dout.device != x.device:
        raise ValueError(f"{name}: dout {tuple(dout.shape)} on {dout.device}, expected "
                         f"{tuple(x.shape)} on {x.device}")
    return dout.to(BF16).contiguous()


def ln_window_attention_bwd(x, dout, ln_scale, ln_bias, wqkv, bqkv, wproj, bias,
                            mask, *, ws: int, num_heads: int,
                            scale: float) -> tuple:
    """Backward of :func:`fused_ln_window_attention` (JAX
    ``_ln_wmsa_bwd_impl``): x as in the forward (raw, rolled by the caller),
    dout the cotangent of its output. Returns (dx, then float32 grads of the
    LN scale and bias, wqkv, bqkv, wproj, bproj and bias). CUDA:
    ``csrc/ln_wmsa_bwd.cu``, the LN_WMSA_BWD_LAUNCHES launches of the block
    backward's kernels (:func:`ln_wmsa_bwd_plan`), each counted."""
    name = "ln_window_attention_bwd"
    count = _build.counter(name)
    if x.device.type == "cpu":
        count.cpu += LN_WMSA_BWD_LAUNCHES
        return ln_window_attention_bwd_reference(
            x, dout, ln_scale, ln_bias, wqkv, bqkv, wproj, bias, mask, ws=ws,
            num_heads=num_heads, scale=scale)
    _check_x(name, x)
    B, H, W, C = x.shape
    ln_wmsa_bwd_plan(H, W, C, ws, num_heads)   # raises on a shape outside the design
    _check_w(name, x, wqkv=(wqkv, (C, 3 * C)), wproj=(wproj, (C, C)))
    _check_window(name, H, W, C, ws, num_heads, bias, mask)
    _check_vec(name, ln_scale=(ln_scale, C), ln_bias=(ln_bias, C), bqkv=(bqkv, 3 * C))
    dout = _check_dout(name, x, dout)
    dev = x.device
    f = lambda t: _f32(t, dev)
    lib = _build.library()
    work = _workspace(lib.sunet_ln_wmsa_bwd_workspace, dev, B, H, W, C, ws, num_heads)
    dx = torch.empty_like(x)
    z = lambda *s: torch.empty(*s, device=dev, dtype=torch.float32)
    grads = [z(C), z(C), z(C, 3 * C), z(3 * C), z(C, C), z(C),
             z(num_heads, ws * ws, ws * ws)]
    args = [f(ln_scale), f(ln_bias), wqkv, f(bqkv), wproj, f(bias), f(mask)]
    launches = _build.c_int(0)
    err = lib.sunet_ln_wmsa_bwd(
        _build.ptr(x), _build.ptr(dout), *[_build.ptr(a) for a in args],
        _build.ptr(dx), *[_build.ptr(g) for g in grads], _build.ptr(work),
        B, H, W, C, ws, num_heads, float(scale), _build.byref(launches),
        _build.stream())
    _build.check(name, err)
    count.cuda += launches.value
    return (dx, *grads)


def _check_mlp(name, y, ln, w1, b1, w2, b2=None):
    _check_x(name, y)
    C, hidden = y.shape[-1], w1.shape[1]
    if C % 16 or hidden % 16 or C > SPLIT_TRAIN_MAX_C:
        raise ValueError(f"{name}: C={C}, hidden={hidden}: the kernel takes "
                         f"multiples of 16 and C <= {SPLIT_TRAIN_MAX_C}")
    _check_w(name, y, w1=(w1, (C, hidden)), w2=(w2, (hidden, C)))
    _check_vec(name, ln_scale=(ln[0], C), ln_bias=(ln[1], C), b1=(b1, hidden), b2=(b2, C))


def ln_mlp_branch(y, ln, w1, b1, w2, b2) -> torch.Tensor:
    """fc2(gelu(fc1(LN(y)))) over an NHWC map, in y's dtype, without the
    residual (JAX ``_ln_mlp_branch``). CUDA: ``csrc/ln_mlp_branch.cu``, two
    launches (fc1 with the LayerNorm in its A load, fc2 on a K-split
    cluster; #4's plan, :func:`mlp_plan`), each counted."""
    name = "ln_mlp_branch"
    count = _build.counter(name)
    if y.device.type == "cpu":
        count.cpu += LN_MLP_BRANCH_LAUNCHES
        return ln_mlp_branch_reference(y, ln, w1, b1, w2, b2)
    _check_mlp(name, y, ln, w1, b1, w2, b2)
    B, H, W, C = y.shape
    hidden = w1.shape[1]
    plan = mlp_plan(H * W, C, hidden)
    dev = y.device
    f = lambda t: _f32(t, dev)
    lib = _build.library()
    work = _workspace(lib.sunet_ln_mlp_branch_workspace, dev, B * H * W, C, hidden)
    out = torch.empty_like(y)
    args = [f(ln[0]), f(ln[1]), w1, f(b1), w2, f(b2)]
    launches = _build.c_int(0)
    err = lib.sunet_ln_mlp_branch(
        _build.ptr(y), _build.ptr(out), *[_build.ptr(a) for a in args],
        _build.ptr(work), B * H * W, C, hidden, plan["ks"], _build.byref(launches),
        _build.stream())
    _build.check(name, err)
    count.cuda += launches.value
    return out


def ln_mlp_bwd(y, dout, ln, w1, b1, w2) -> tuple:
    """Backward of :func:`ln_mlp_branch` (JAX ``_ln_mlp_bwd``). Returns (dy,
    then float32 grads of the LN scale and bias, w1, b1, w2 and b2). CUDA:
    ``csrc/ln_mlp_bwd.cu``, the LN_MLP_BWD_LAUNCHES launches of the block
    backward's kernels over the map's own rows (:func:`ln_mlp_bwd_plan`),
    each counted."""
    name = "ln_mlp_bwd"
    count = _build.counter(name)
    if y.device.type == "cpu":
        count.cpu += LN_MLP_BWD_LAUNCHES
        return ln_mlp_bwd_reference(y, dout, ln, w1, b1, w2)
    _check_mlp(name, y, ln, w1, b1, w2)
    dout = _check_dout(name, y, dout)
    B, H, W, C = y.shape
    hidden = w1.shape[1]
    plan = ln_mlp_bwd_plan(H, W, C, hidden)
    dev = y.device
    f = lambda t: _f32(t, dev)
    lib = _build.library()
    work = _workspace(lib.sunet_ln_mlp_bwd_workspace, dev, B, H, W, C, hidden)
    dy = torch.empty_like(y)
    z = lambda *s: torch.empty(*s, device=dev, dtype=torch.float32)
    grads = [z(C), z(C), z(C, hidden), z(hidden), z(hidden, C), z(C)]
    args = [f(ln[0]), f(ln[1]), w1, f(b1), w2]
    launches = _build.c_int(0)
    err = lib.sunet_ln_mlp_bwd(
        _build.ptr(y), _build.ptr(dout), *[_build.ptr(a) for a in args],
        _build.ptr(dy), *[_build.ptr(g) for g in grads], _build.ptr(work),
        B, H, W, C, hidden, plan["ks"], _build.byref(launches), _build.stream())
    _build.check(name, err)
    count.cuda += launches.value
    return (dy, *grads)


class LnWindowAttentionTrainable(torch.autograd.Function):
    """Differentiable LN + W-MSA + projection sublayer (JAX
    ``ln_window_attention_trainable``): forward = :func:`fused_ln_window_attention`,
    backward = :func:`ln_window_attention_bwd`. x comes rolled by the
    caller; the output is the sublayer's before the residual. Weights come
    in float32, (in, out) layout, and are cast to x's dtype for the kernels;
    their grads come back in float32. ``mask`` and the static arguments get
    no gradient."""

    @staticmethod
    def forward(ctx, x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, bias, mask, ws,
                num_heads, scale):
        dt = x.dtype
        cast = lambda w: w.detach().to(dt).contiguous()
        x = x.contiguous()
        p = (ln_s.detach(), ln_b.detach(), cast(wqkv),
             None if bqkv is None else bqkv.detach(), cast(wproj), bias.detach())
        ctx.save_for_backward(x, mask, *p)
        ctx.static = (ws, num_heads, scale)
        _gate("fused_ln_window_attention", x, tokens=ws * ws, train=True)
        return _ln_window_attention_impl(x, *p[:5], bproj.detach(), p[5], mask,
                                         ws=ws, num_heads=num_heads, scale=scale)

    @staticmethod
    def backward(ctx, dout):
        ws, num_heads, scale = ctx.static
        x, mask, *p = ctx.saved_tensors
        g = list(ln_window_attention_bwd(x, dout, *p, mask, ws=ws,
                                         num_heads=num_heads, scale=scale))
        if p[3] is None:
            g[4] = None
        return (*g, None, None, None, None)


class LnMlpTrainable(torch.autograd.Function):
    """Differentiable LN + MLP branch without the residual (JAX
    ``ln_mlp_trainable``): forward = :func:`ln_mlp_branch`, backward =
    :func:`ln_mlp_bwd`. Weights come in float32, (in, out) layout, cast to
    y's dtype for the kernels; their grads come back in float32."""

    @staticmethod
    def forward(ctx, y, ln_s, ln_b, w1, b1, w2, b2):
        dt = y.dtype
        cast = lambda w: w.detach().to(dt).contiguous()
        y = y.contiguous()
        p = (ln_s.detach(), ln_b.detach(), cast(w1), b1.detach(), cast(w2))
        ctx.save_for_backward(y, *p)
        return ln_mlp_branch(y, p[0:2], *p[2:5], b2.detach())

    @staticmethod
    def backward(ctx, dout):
        y, ln_s, ln_b, w1, b1, w2 = ctx.saved_tensors
        return ln_mlp_bwd(y, dout, (ln_s, ln_b), w1, b1, w2)
