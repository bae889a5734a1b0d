"""SUNet: Swin-Transformer UNet (counterpart of ``sunet_tf_tpu/models/sunet.py``).

  composite stem conv (conv_first 3x3 folded with the patch-embed conv) + LN
  4 encoder stages at dims (C, 2C, 4C, 8C), PatchMerging between them
  bottleneck LN(8C), DualUpsample x2 (8C -> 4C)
  3 decoder stages with UNet skip concat + Linear(2D -> D)
  LN(C), DualUpsample x4 back to pixel resolution, 3x3 output conv

Kept as in the reference: no global residual; an unused top-level PReLU
(so the default config counts 99,681,993 parameters); grayscale input
repeated to 3 channels when in_chans == 3.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

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
                  "fused_dual_upsample4_conv_phase")
TRAIN_WRAPPERS = INFER_WRAPPERS + ("swin_block_bwd", "up4_conv_bwd")


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
                 backend: str = "eager"):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, input_resolution, num_heads,
                      window_size=window_size,
                      shift_size=0 if i % 2 == 0 else window_size // 2,
                      mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                      qk_scale=qk_scale, drop_path_rate=drop_path_rates[i],
                      backend=backend)
            for i in range(depth)])
        self.resample = resample
        if resample == "down":
            self.downsample = PatchMerging(dim)
        elif resample == "up":
            self.upsample = DualUpsample(dim, 2)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        blocks = list(self.blocks)
        i = 0
        while i < len(blocks):
            if generator is not None:   # training: one block at a time
                x = blocks[i](x, generator)
                i += 1
                continue
            k = chain_fusable_len(blocks, i, x)
            if k >= 2:
                x = run_fused_chain(blocks[i:i + k], x)
                i += k
                continue
            x = blocks[i](x)
            i += 1
        if self.resample == "down":
            x = self.downsample(x)
        elif self.resample == "up":
            x = self.upsample(x)
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
                      backend=backend)

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

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        """conv_first (3x3, pad 1) and the patch-embed conv (k = s = p)
        folded into one (p+2)x(p+2) stride-p pad-1 conv, then LN."""
        p = self.cfg.patch_size
        w1 = self.conv_first.weight.float()           # (C, in, 3, 3)
        w2 = self.patch_embed.proj.weight.float()     # (C, C, p, p)
        wc = w1.new_zeros(w2.shape[0], w1.shape[1], p + 2, p + 2)
        for a in range(3):
            for b in range(3):
                wc[:, :, a:a + p, b:b + p] += torch.einsum(
                    "ocij,ca->oaij", w2, w1[:, :, a, b])
        bc = (torch.einsum("c,ocij->o", self.conv_first.bias.float(), w2)
              + self.patch_embed.proj.bias.float())
        y = F.conv2d(x.permute(0, 3, 1, 2), wc.to(x.dtype), stride=p, padding=1)
        y = (y.permute(0, 2, 3, 1).float() + bc).to(x.dtype)
        if self.patch_embed.norm is not None:
            y = layer_norm(y, self.patch_embed.norm)
        return y

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, H, W, in_chans) in [0, 1] -> (B, H, W, out_chans) float32
        logits. With ``generator`` this is the training forward (JAX
        ``key``): stochastic depth drawn from it, the blocks and the x4 head
        on their trainable routes; without it, inference."""
        cfg = self.cfg
        if (self.backend == "fused" and x.device.type == "cuda"
                and self.dtype != torch.bfloat16):
            raise NotImplementedError(
                "backend='fused' on CUDA runs bfloat16 kernels only; float32 "
                "kernels are ROADMAP queue B 'fp32 kernels'. Use "
                "backend='eager' for a float32 forward.")
        if generator is not None and (cfg.drop_rate > 0 or cfg.attn_drop_rate > 0):
            raise NotImplementedError(
                "training with DROP_RATE or ATTN_DROP_RATE > 0 is not ported "
                "(the reference recipe trains with both at 0)")
        if x.shape[-1] == 1 and cfg.in_chans == 3:
            x = x.repeat(1, 1, 1, 3)
        x = x.to(self.dtype)
        n = cfg.num_stages
        gran = cfg.patch_size * 2 ** (n - 1)
        if x.shape[1] % gran or x.shape[2] % gran:
            raise ValueError(f"input {x.shape[1]}x{x.shape[2]} must be "
                             f"divisible by {gran}")
        feats = self._stem(x)
        if self.absolute_pos_embed is not None:
            feats = feats + self.absolute_pos_embed.to(feats.dtype).reshape(
                1, feats.shape[1], feats.shape[2], -1)
        skips = []
        for layer in self.layers:
            skips.append(feats)
            feats = layer(feats, generator)
        feats = layer_norm(feats, self.norm)
        feats = self.layers_up[0](feats)
        for j in range(1, n):
            feats = torch.cat([feats, skips[n - 1 - j]], dim=-1)
            lin = self.concat_back_dim[j]
            feats = self.layers_up[j](linear(feats, lin.weight, lin.bias), generator)
        feats = layer_norm(feats, self.norm_up)
        if self.backend == "fused" and 16 * cfg.out_chans <= 128:
            wconv = self.output.weight.permute(2, 3, 1, 0)
            if generator is not None:
                return self.up.conv_head_trainable(feats, wconv).float()
            return self.up.fused_conv_head(
                feats, wconv.contiguous().to(feats.dtype)).float()
        return self.output(self.up(feats)).float()

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

    def expected_launches(self, x_shape: tuple, train: bool = False) -> dict:
        """Kernel launches one fused forward of an input of ``x_shape``
        makes, per wrapper, as the router decides them: a chain of K blocks
        launches the block kernel K times, LN+W-MSA launches two kernels.
        ``train=True``: one training step, forward and backward (every block
        up to ROUTE_TRAIN_BLOCK_MAX_C launches the block kernel once and
        its backward's fixed sequence; the x4 head its forward kernel and
        its backward's sequence; wider blocks run plain autograd)."""
        counts = dict.fromkeys(TRAIN_WRAPPERS if train else INFER_WRAPPERS, 0)
        if self.backend != "fused":
            return counts
        if train:
            for stage in list(self.layers) + list(self.layers_up[1:]):
                for blk in stage.blocks:
                    if blk.dim <= layers.ROUTE_TRAIN_BLOCK_MAX_C:
                        counts["fused_swin_block"] += 1
                        counts["swin_block_bwd"] += wa.SWIN_BLOCK_BWD_LAUNCHES
            if 16 * self.cfg.out_chans <= 128:
                counts["fused_dual_upsample4_conv_phase"] += 1
                counts["up4_conv_bwd"] += up_kernels.UP4_CONV_BWD_LAUNCHES
            return counts
        H = x_shape[1] // self.cfg.patch_size
        W = x_shape[2] // self.cfg.patch_size
        n = self.cfg.num_stages
        stages = [(s, i) for i, s in enumerate(self.layers)]
        stages += [(s, n - 1 - j) for j, s in enumerate(self.layers_up[1:], 1)]
        for stage, level in stages:
            probe = torch.empty((1, H >> level, W >> level,
                                 stage.blocks[0].dim), device="meta")
            blocks = list(stage.blocks)
            i = 0
            while i < len(blocks):
                k = chain_fusable_len(blocks, i, probe)
                if k >= 2:
                    counts["fused_swin_block_chain"] += k
                    i += k
                    continue
                if blocks[i].dim <= layers.ROUTE_BLOCK_MAX_C:
                    counts["fused_swin_block"] += 1
                else:
                    counts["fused_ln_window_attention"] += 2
                    counts["fused_ln_mlp"] += 1
                i += 1
        if 16 * self.cfg.out_chans <= 128:
            counts["fused_dual_upsample4_conv_phase"] += 1
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


def param_count(model: nn.Module) -> int:
    return sum(int(np.prod(p.shape)) for p in model.parameters())
