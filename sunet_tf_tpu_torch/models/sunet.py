"""SUNet: Swin-Transformer UNet (counterpart of ``sunet_tf_tpu/models/sunet.py``).

  composite stem conv (conv_first 3x3 folded with the patch-embed conv) + LN
  4 encoder stages at dims (C, 2C, 4C, 8C), PatchMerging between them
  bottleneck LN(8C), DualUpsample x2 (8C -> 4C)
  3 decoder stages with UNet skip concat + Linear(2D -> D)
  LN(C), DualUpsample x4 back to pixel resolution, 3x3 output conv

Kept as in the reference: no global residual; an unused top-level PReLU
(so the default config counts 99,681,993 parameters); grayscale input
repeated to 3 channels when in_chans == 3.

Training (a generator passed to ``forward``) draws, in call order: the
features dropout after the stem (``DROP_RATE``, JAX ``sunet.py``), then each
block's draws (``SwinBlock.draws``) as the blocks run. ``USE_CHECKPOINTS``
runs each block of a training forward under
``torch.utils.checkpoint.checkpoint`` (JAX ``jax.checkpoint`` per block):
the block's draws are made before it, so the recompute in backward draws
nothing from the caller's generator and takes the same masks; the loss, the
gradients and the generator's state after the step equal those without it.
Under it inference takes no chain and no stage runner (JAX ``SwinStage``).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from sunet_tf_tpu_torch.config import Config, SwinUNetConfig
from sunet_tf_tpu_torch.kernels import upsample as up_kernels
from sunet_tf_tpu_torch.kernels import window_attention as wa
from sunet_tf_tpu_torch.models import layers
from sunet_tf_tpu_torch.models.layers import (
    Conv3x3,
    DualUpsample,
    PatchEmbed,
    PatchMerging,
    PReLU,
    SwinBlock,
    chain_fusable_len,
    layer_norm,
    linear,
    run_fused_chain,
    torch_default_init_,
)

BACKENDS = ("fused", "eager")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
INFER_WRAPPERS = ("fused_swin_block", "fused_swin_block_chain",
                  "fused_ln_window_attention", "fused_ln_mlp",
                  "fused_dual_upsample4_conv_phase", "fused_dual_upsample4")
TRAIN_WRAPPERS = INFER_WRAPPERS + ("fused_swin_block_res", "swin_block_bwd",
                                  "swin_block_bwd_res", "ln_window_attention_bwd",
                                  "ln_mlp_branch", "ln_mlp_bwd", "up4_conv_bwd",
                                  "up4_bwd")


def _train_launches(blk) -> int:
    """Launches of one training forward of ``blk`` on the block kernel's
    train form: the cluster kernel's one, or the sequence form's
    (``wa.train_block_launches``)."""
    return wa.train_block_launches(blk.dim, blk.mlp.fc1.out_features, blk.attn.num_heads,
                                   blk.window_size)


def conv_fused_head(out_chans: int) -> bool:
    """Whether the fused route runs the x4 head fused with the output conv
    (phase space, 16 * out_chans output lanes) or, for wider outputs, the
    split head and then the conv: JAX's rule (``sunet.py``)."""
    return 16 * out_chans <= 128


def _dpr_schedule(depths: tuple, drop_path_rate: float) -> list:
    """Stochastic-depth rate of every encoder block, linspace(0, rate,
    sum(depths)) (reference model/SUNet_detail.py:628); decoder stages reuse
    the rates of the encoder stage they mirror."""
    total = sum(depths)
    if total <= 1:
        return [0.0] * total
    return [float(v) for v in np.linspace(0.0, drop_path_rate, total)]


class SwinStage(nn.Module):
    """Swin blocks with alternating 0 / ws//2 shifts, then an optional
    ``downsample`` (PatchMerging, encoder) or ``upsample`` (DualUpsample x2,
    decoder) under the reference's attribute names."""

    def __init__(self, dim: int, input_resolution: tuple, depth: int,
                 num_heads: int, *, window_size: int, mlp_ratio: float,
                 qkv_bias: bool, qk_scale: Optional[float],
                 drop_path_rates: list, resample: Optional[str] = None,
                 backend: str = "eager", drop: float = 0.0, attn_drop: float = 0.0,
                 use_checkpoint: bool = False):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, input_resolution, num_heads,
                      window_size=window_size,
                      shift_size=0 if i % 2 == 0 else window_size // 2,
                      mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                      qk_scale=qk_scale, drop=drop, attn_drop=attn_drop,
                      drop_path_rate=drop_path_rates[i], backend=backend)
            for i in range(depth)])
        self.use_checkpoint = use_checkpoint
        self.resample = resample
        if resample == "down":
            self.downsample = PatchMerging(dim)
        elif resample == "up":
            self.upsample = DualUpsample(dim, 2)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                runner=None) -> torch.Tensor:
        """``runner``: the spatial tier's stage runner
        (``parallel.spatial.SpatialStageRunner``); where it ``applies``, the
        blocks run through it, H sharded over its spatial group (never under
        ``use_checkpoint``)."""
        blocks = list(self.blocks)
        if (runner is not None and not self.use_checkpoint
                and runner.applies(blocks, tuple(x.shape), generator is not None)):
            return self._resample(runner(blocks, x, generator))
        i = 0
        while i < len(blocks):
            blk = blocks[i]
            if generator is not None:   # training: one block at a time
                if self.use_checkpoint:
                    x = checkpoint(blk.train_forward, x, *blk.draws(x, generator),
                                   use_reentrant=False)
                else:
                    x = blk(x, generator)
                i += 1
                continue
            k = 0 if self.use_checkpoint else chain_fusable_len(blocks, i, x)
            if k >= 2:
                x = run_fused_chain(blocks[i:i + k], x)
                i += k
                continue
            x = blk(x)
            i += 1
        return self._resample(x)

    def _resample(self, x: torch.Tensor) -> torch.Tensor:
        if self.resample == "down":
            return self.downsample(x)
        if self.resample == "up":
            return self.upsample(x)
        return x


class SUNet(nn.Module):
    def __init__(self, cfg: SwinUNetConfig, *, dtype: torch.dtype = torch.bfloat16,
                 backend: str = "fused"):
        super().__init__()
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        self.cfg = cfg
        self.dtype = dtype
        self.backend = backend
        C = cfg.emb_dim
        n = cfg.num_stages
        pres = cfg.patches_resolution
        depths = cfg.depth_en
        dpr = _dpr_schedule(depths, cfg.drop_path_rate)
        rates = lambda i: dpr[sum(depths[:i]):sum(depths[:i + 1])]
        common = dict(window_size=cfg.win_size, mlp_ratio=cfg.mlp_ratio,
                      qkv_bias=cfg.qkv_bias, qk_scale=cfg.qk_scale,
                      backend=backend, drop=cfg.drop_rate,
                      attn_drop=cfg.attn_drop_rate, use_checkpoint=cfg.use_checkpoint)

        self.prelu = PReLU()  # unused, kept for parameter parity
        self.conv_first = Conv3x3(cfg.in_chans, C, bias=True)
        self.patch_embed = PatchEmbed(C, C, cfg.patch_size,
                                      patch_norm=cfg.patch_norm)
        if cfg.ape:
            self.absolute_pos_embed = nn.Parameter(
                torch.zeros(1, pres[0] * pres[1], C))
        else:
            self.absolute_pos_embed = None
        self.layers = nn.ModuleList([
            SwinStage(C * 2**i, (pres[0] // 2**i, pres[1] // 2**i), depths[i],
                      cfg.head_num[i], drop_path_rates=rates(i),
                      resample="down" if i < n - 1 else None, **common)
            for i in range(n)])
        self.norm = nn.LayerNorm(C * 2 ** (n - 1), eps=1e-5)
        # layers_up[0] is the bare x2 up-sample at the bottleneck; decoder
        # stage j is layers_up[j+1], mirroring encoder stage n-2-j.
        self.layers_up = nn.ModuleList([DualUpsample(C * 2 ** (n - 1), 2)])
        self.concat_back_dim = nn.ModuleList([nn.Identity()])
        for j in range(n - 1):
            enc_i = n - 2 - j
            dim = C * 2**enc_i
            res = (pres[0] // 2**enc_i, pres[1] // 2**enc_i)
            self.concat_back_dim.append(nn.Linear(2 * dim, dim))
            self.layers_up.append(SwinStage(
                dim, res, depths[enc_i], cfg.head_num[enc_i],
                drop_path_rates=rates(enc_i),
                resample="up" if j < n - 2 else None, **common))
        self.norm_up = nn.LayerNorm(C, eps=1e-5)
        self.up = DualUpsample(C, 4)
        self.output = Conv3x3(C, cfg.out_chans, bias=False)
        # False runs conv_first and the patch-embed conv one after the
        # other instead of folded (tools/bisect_fp64.py reads both forms)
        self.fold_stem = True
        # a dict the forward fills with its probe points (probe_names)
        self.taps: Optional[dict] = None

    def _tap(self, name: str, t: torch.Tensor) -> torch.Tensor:
        if self.taps is not None:
            self.taps[name] = t.detach()
        return t

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        """conv_first (3x3, pad 1) and the patch-embed conv (k = s = p)
        folded into one (p+2)x(p+2) stride-p pad-1 conv, then LN; the fold in
        float32 (float64 for a float64 x)."""
        p = self.cfg.patch_size
        ct = torch.promote_types(x.dtype, torch.float32)
        if not self.fold_stem:
            pe = self.patch_embed.proj
            y = F.conv2d(self.conv_first(x).permute(0, 3, 1, 2), pe.weight.to(x.dtype),
                         pe.bias.to(x.dtype), stride=p).permute(0, 2, 3, 1)
            return y if self.patch_embed.norm is None else layer_norm(y, self.patch_embed.norm)
        w1 = self.conv_first.weight.to(ct)            # (C, in, 3, 3)
        w2 = self.patch_embed.proj.weight.to(ct)      # (C, C, p, p)
        wc = w1.new_zeros(w2.shape[0], w1.shape[1], p + 2, p + 2)
        for a in range(3):
            for b in range(3):
                wc[:, :, a:a + p, b:b + p] += torch.einsum(
                    "ocij,ca->oaij", w2, w1[:, :, a, b])
        bc = (torch.einsum("c,ocij->o", self.conv_first.bias.to(ct), w2)
              + self.patch_embed.proj.bias.to(ct))
        y = F.conv2d(x.permute(0, 3, 1, 2), wc.to(x.dtype), stride=p, padding=1)
        y = (y.permute(0, 2, 3, 1).to(ct) + bc).to(x.dtype)
        if self.patch_embed.norm is not None:
            y = layer_norm(y, self.patch_embed.norm)
        return y

    def fused_why(self, train: bool = False) -> Optional[str]:
        """Why the fused route on the card does not run this model (None
        when it does): bfloat16 runs everywhere; float32 runs the float32
        inference forms of #1-#5 (ROADMAP B2, serving half), so a training
        forward, a window above 64 tokens or the split x4 head (#10) is
        refused with its ROADMAP item; no other dtype has kernels."""
        if self.backend != "fused" or self.dtype == torch.bfloat16:
            return None
        eager = " Use backend='eager' for a float32 model there."
        if self.dtype != torch.float32:
            return (f"backend='fused' on CUDA runs bfloat16 and float32 kernels, not "
                    f"{self.dtype}.{eager}")
        if train:
            return (f"backend='fused' in float32 runs inference kernels only: training in "
                    f"float32 is {wa.F32_TRAIN_ITEM}.{eager}")
        blocks = [b for st in list(self.layers) + list(self.layers_up[1:]) for b in st.blocks]
        big = max(b.window_size ** 2 for b in blocks)
        if big > 64:
            return (f"backend='fused' in float32 takes windows up to 64 tokens, this model has "
                    f"{big} ({wa.F32_SEQ_ITEM}).{eager}")
        if not conv_fused_head(self.cfg.out_chans):
            return (f"backend='fused' in float32 runs the conv-fused x4 head; OUT_CHANS="
                    f"{self.cfg.out_chans} takes the split head ({wa.F32_SPLIT_HEAD_ITEM})."
                    f"{eager}")
        return None

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                stage_runner=None) -> torch.Tensor:
        """x: (B, H, W, in_chans) in [0, 1] -> (B, H, W, out_chans) float32
        logits (float64 from a float64 eager model). With ``generator`` this
        is the training forward (JAX ``key``): stochastic depth and dropout
        drawn from it, the blocks and the x4 head
        on their trainable routes; without it, inference. ``stage_runner``:
        the spatial tier's runner (``parallel.spatial.SpatialStageRunner``),
        which each Swin stage asks whether it takes the stage; the other
        layers run replicated on every rank of its spatial group.

        A float32 (or float64) model computes in float32 on the card: its
        forward runs with TF32 off in cuBLAS and cuDNN (``wa.exact_fp32``,
        JAX's ``default_matmul_precision("highest")``), the caller's flags
        restored after; a bf16 model leaves them as it finds them. Autograd
        runs a backward after this returns: the training step holds the
        flags over it (``train/loop.py``)."""
        if x.device.type == "cuda":
            why = self.fused_why(train=generator is not None)
            if (why is None and stage_runner is not None and self.backend == "fused"
                    and self.dtype != torch.bfloat16):
                why = (f"the spatial stage runner runs bfloat16 kernels, not {self.dtype} "
                       f"({wa.F32_SPATIAL_ITEM}); run without it, or on backend='eager'")
            if why:
                raise NotImplementedError(why)
        exact = wa.exact_fp32() if self.dtype != torch.bfloat16 else contextlib.nullcontext()
        with exact:
            return self._forward(x, generator, stage_runner)

    def _forward(self, x: torch.Tensor, generator, stage_runner) -> torch.Tensor:
        cfg = self.cfg
        if x.shape[-1] == 1 and cfg.in_chans == 3:
            x = x.repeat(1, 1, 1, 3)
        x = x.to(self.dtype)
        n = cfg.num_stages
        gran = cfg.patch_size * 2 ** (n - 1)
        if x.shape[1] % gran or x.shape[2] % gran:
            raise ValueError(f"input {x.shape[1]}x{x.shape[2]} must be "
                             f"divisible by {gran}")
        tap = self._tap
        feats = tap("stem", self._stem(x))
        if self.absolute_pos_embed is not None:
            feats = feats + self.absolute_pos_embed.to(feats.dtype).reshape(
                1, feats.shape[1], feats.shape[2], -1)
        feats = layers.dropout(feats, cfg.drop_rate, generator)
        skips = []
        for i, layer in enumerate(self.layers):
            skips.append(feats)
            feats = tap(f"enc{i}", layer(feats, generator, stage_runner))
        feats = tap("norm", layer_norm(feats, self.norm))
        feats = tap("up0", self.layers_up[0](feats))
        for j in range(1, n):
            feats = torch.cat([feats, skips[n - 1 - j]], dim=-1)
            lin = self.concat_back_dim[j]
            feats = tap(f"concat{j}", linear(feats, lin.weight, lin.bias))
            feats = tap(f"up{j}", self.layers_up[j](feats, generator, stage_runner))
        feats = tap("norm_up", layer_norm(feats, self.norm_up))
        return tap("output", self._head(feats, generator))

    def _head(self, feats: torch.Tensor, generator) -> torch.Tensor:
        """The x4 head and the output conv: float32 logits (float64 from a
        float64 eager model)."""
        if self.backend != "fused":
            return wa.wide(self.output(self.up(feats)))
        if conv_fused_head(self.cfg.out_chans):
            wconv = self.output.weight.permute(2, 3, 1, 0)
            if generator is not None:
                return wa.wide(self.up.conv_head_trainable(feats, wconv))
            return self.up.fused_conv_head(
                feats, wconv.contiguous().to(feats.dtype)).float()
        # the split head, then the output conv as a plain convolution (JAX
        # runs it in XLA)
        head = self.up.head_trainable if generator is not None else self.up.fused_head
        return wa.wide(self.output(head(feats)))

    def flops(self, resolution: Optional[tuple] = None) -> int:
        """Analytic forward FLOPs (multiply-accumulate counted as 2), the
        whole network including the decoder."""
        cfg = self.cfg
        H = W = cfg.img_size
        if resolution is not None:
            H, W = resolution
        p = cfg.patch_size
        C = cfg.emb_dim
        n = cfg.num_stages
        total = 2 * H * W * 9 * cfg.in_chans * C
        hp, wp = H // p, W // p
        total += 2 * hp * wp * C * C * p * p

        def block_flops(h, w, D, heads, ws):
            nW = (h // ws) * (w // ws)
            N = ws * ws
            f = 2 * h * w * D * 3 * D
            f += 2 * nW * heads * N * N * (D // heads) * 2
            f += 2 * h * w * D * D
            f += 2 * 2 * h * w * D * int(D * cfg.mlp_ratio)
            return f

        def up_flops(h, w, D, factor):
            expand = 2 * D if factor == 2 else 16 * D
            out = D // 2 if factor == 2 else D
            f = 2 * h * w * D * expand
            f += 2 * (h * factor) * (w * factor) * out * out
            f += 2 * h * w * D * D + 2 * (h * factor) * (w * factor) * D * out
            f += 2 * (h * factor) * (w * factor) * (2 * out) * out
            return f

        for i in range(n):
            h, w, D = hp // 2**i, wp // 2**i, C * 2**i
            ws = min(cfg.win_size, h, w)
            total += cfg.depth_en[i] * block_flops(h, w, D, cfg.head_num[i], ws)
            if i < n - 1:
                total += 2 * (h // 2) * (w // 2) * 4 * D * 2 * D
        bh, bw, bD = hp // 2 ** (n - 1), wp // 2 ** (n - 1), C * 2 ** (n - 1)
        total += up_flops(bh, bw, bD, 2)
        for j in range(n - 1):
            enc_i = n - 2 - j
            h, w, D = hp // 2**enc_i, wp // 2**enc_i, C * 2**enc_i
            ws = min(cfg.win_size, h, w)
            total += 2 * h * w * 2 * D * D
            total += cfg.depth_en[enc_i] * block_flops(h, w, D, cfg.head_num[enc_i], ws)
            if j < n - 2:
                total += up_flops(h, w, D, 2)
        total += up_flops(hp, wp, C, 4)
        total += 2 * H * W * 9 * C * cfg.out_chans
        return int(total)

    def expected_launches(self, x_shape: tuple, train: bool = False, runner=None) -> dict:
        """Kernel launches one fused forward of an input of ``x_shape``
        makes, per wrapper, as the router decides them: a block launches the
        block kernel once, or its sequence form's
        ``wa.SWIN_BLOCK_SEQ_LAUNCHES`` above 64 tokens a window
        (``wa.block_launches``), a chain of K blocks K times that, LN+W-MSA
        launches three kernels
        (``wa.LN_WMSA_LAUNCHES``), LN+MLP three,
        a block within the cap whose shape the block kernel does not take
        (``SwinBlock.takes_block_kernel``) the split kernels; the x4 head
        one launch where it is the conv-fused head, else the split head's
        two (``up_kernels.UP4_SPLIT_LAUNCHES``).
        ``train=True``: one training step, forward and backward, by the
        training rule: a block that trains on the block kernels
        (``trains_on_block_kernels``: up to ROUTE_TRAIN_BLOCK_MAX_C, 768)
        launches
        the block kernel's train form (``wa.train_block_launches``: the
        cluster kernel's one launch, or the sequence form's 5 above 64 tokens
        and where the cluster kernel refuses the block, the C=768 stage) and
        its backward's fixed sequence (``wa.block_bwd_launches``: 11, or 12
        above 64 tokens),
        on the residual route where ``trains_on_residuals`` holds (JAX
        ``swin_block_trainable_res``), else on the recompute one (JAX
        ``swin_block_trainable``); another that trains on the sublayer
        kernels (``trains_on_split_kernels``) the LN+W-MSA pair, LN+W-MSA
        backward, LN+MLP branch and LN+MLP backward sequences (JAX
        ``ln_window_attention_trainable`` + ``ln_mlp_trainable``); any other
        runs plain autograd and launches nothing. The x4 head launches its
        forward kernel and its backward's sequence: the conv-fused head's
        where ``conv_fused_head`` holds, else the split head's.
        A block with a dropout rate above 0 (``SwinBlock.has_dropout``)
        trains on eager autograd and launches nothing; under
        ``use_checkpoint`` inference takes no chain (each block on its own)
        and no stage runner, and in training each block's forward kernels
        launch twice (the recompute in backward runs the block's forward
        again), its backward's once.
        ``runner``: a spatial stage runner; each block of a stage it
        ``applies`` to launches the block kernel (``wa.block_launches``; in
        training its train form, ``wa.train_block_launches``), in training
        also its recompute backward (``wa.block_bwd_launches``),
        at shift 0 with a mask slice (no chain, no residual route).
        A float32 model's inference gives the same counts: each wrapper is
        called as often as in bf16 (the routes do not depend on the dtype,
        as in JAX) and each float32 form launches as many kernels as its
        bf16 form."""
        counts = dict.fromkeys(TRAIN_WRAPPERS if train else INFER_WRAPPERS, 0)
        if self.backend != "fused":
            return counts
        H = x_shape[1] // self.cfg.patch_size
        W = x_shape[2] // self.cfg.patch_size
        n = self.cfg.num_stages
        stages = [(s, i) for i, s in enumerate(self.layers)]
        stages += [(s, n - 1 - j) for j, s in enumerate(self.layers_up[1:], 1)]
        if runner is not None:
            kept = []
            for stage, level in stages:
                shape = (x_shape[0], H >> level, W >> level, stage.blocks[0].dim)
                if stage.use_checkpoint or not runner.applies(list(stage.blocks), shape, train):
                    kept.append((stage, level))
                    continue
                for blk in stage.blocks:
                    counts["fused_swin_block"] += (_train_launches(blk) if train
                                                   else wa.block_launches(blk.window_size))
                    if train:
                        counts["swin_block_bwd"] += wa.block_bwd_launches(blk.window_size)
            stages = kept
        if train:
            for stage, _ in stages:
                # the recompute in backward runs each forward once more
                fwd = 2 if stage.use_checkpoint else 1
                for blk in stage.blocks:
                    if blk.has_dropout():
                        continue
                    if blk.trains_on_block_kernels():
                        if blk.trains_on_residuals():
                            counts["fused_swin_block_res"] += fwd
                            counts["swin_block_bwd_res"] += wa.SWIN_BLOCK_BWD_RES_LAUNCHES
                        else:
                            counts["fused_swin_block"] += fwd * _train_launches(blk)
                            counts["swin_block_bwd"] += wa.block_bwd_launches(blk.window_size)
                    elif blk.trains_on_split_kernels():
                        counts["fused_ln_window_attention"] += fwd * wa.LN_WMSA_LAUNCHES
                        counts["ln_window_attention_bwd"] += wa.LN_WMSA_BWD_LAUNCHES
                        counts["ln_mlp_branch"] += fwd * wa.LN_MLP_BRANCH_LAUNCHES
                        counts["ln_mlp_bwd"] += wa.LN_MLP_BWD_LAUNCHES
            if conv_fused_head(self.cfg.out_chans):
                counts["fused_dual_upsample4_conv_phase"] += 1
                counts["up4_conv_bwd"] += up_kernels.up4_conv_bwd_launches(self.cfg.emb_dim)
            else:
                counts["fused_dual_upsample4"] += up_kernels.UP4_SPLIT_LAUNCHES
                counts["up4_bwd"] += up_kernels.UP4_BWD_LAUNCHES
            return counts
        for stage, level in stages:
            probe = torch.empty((1, H >> level, W >> level,
                                 stage.blocks[0].dim), device="meta")
            blocks = list(stage.blocks)
            i = 0
            while i < len(blocks):
                k = 0 if stage.use_checkpoint else chain_fusable_len(blocks, i, probe)
                if k >= 2:
                    counts["fused_swin_block_chain"] += sum(
                        wa.block_launches(b.window_size) for b in blocks[i:i + k])
                    i += k
                    continue
                if (blocks[i].dim <= layers.ROUTE_BLOCK_MAX_C
                        and blocks[i].takes_block_kernel()):
                    counts["fused_swin_block"] += wa.block_launches(blocks[i].window_size)
                else:
                    counts["fused_ln_window_attention"] += wa.LN_WMSA_LAUNCHES
                    counts["fused_ln_mlp"] += wa.LN_MLP_LAUNCHES
                i += 1
        if conv_fused_head(self.cfg.out_chans):
            counts["fused_dual_upsample4_conv_phase"] += 1
        else:
            counts["fused_dual_upsample4"] += up_kernels.UP4_SPLIT_LAUNCHES
        return counts


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device when CUDA is absent
    raises (the port runs on the card unless the caller asks for the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def build_model(cfg: Config, *, device="cuda", backend: str = "fused",
                seed: int = 0) -> SUNet:
    """A SUNet for ``cfg`` on ``device`` (the card unless the caller asks
    for "cpu" or "meta"), compute dtype from ``cfg.compute_dtype``, weights
    drawn from ``torch.Generator`` seeded with ``seed`` (the same weights on
    every device), in eval mode with frozen parameters (the Trainer turns
    on their grads). ``device="meta"`` builds shapes only."""
    device = resolve_device(device)
    with device:
        model = SUNet(cfg.swinunet, dtype=DTYPES[cfg.compute_dtype],
                      backend=backend)
    if device.type != "meta":
        torch_default_init_(model, torch.Generator().manual_seed(seed))
    return model.eval().requires_grad_(False)


def probe_names(num_stages: int) -> tuple:
    """The forward's probe points in pipeline order (``SUNet.taps``): the
    stem, each encoder stage, the bottleneck norm, layers_up[0], each
    decoder stage's concat Linear and the stage, norm_up, the output."""
    n = num_stages
    return ("stem", *(f"enc{i}" for i in range(n)), "norm", "up0",
            *(p for j in range(1, n) for p in (f"concat{j}", f"up{j}")), "norm_up", "output")


def route_copy(model: SUNet, *, dtype: torch.dtype, backend: str) -> SUNet:
    """A copy of ``model`` with its weights, on its device, that computes in
    ``dtype`` on ``backend``, in eval mode with frozen parameters. Its
    parameters are float64 where ``dtype`` is (the float64 oracle: every
    product of the eager route in float64), else float32."""
    device = next(model.parameters()).device
    with device:
        copy = SUNet(model.cfg, dtype=dtype, backend=backend)
    copy.load_state_dict(model.state_dict())
    if dtype == torch.float64:
        copy.double()
    return copy.eval().requires_grad_(False)


def param_count(model: nn.Module) -> int:
    return sum(int(np.prod(p.shape)) for p in model.parameters())
