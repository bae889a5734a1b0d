"""SUNet building blocks as torch modules, NHWC at every public call.

Counterparts of ``sunet_tf_tpu/models/layers.py``. Attribute names follow
the reference checkpoint keys (``tools/export_torch_checkpoint.py``), so a
reference ``state_dict`` loads with ``load_state_dict``: Linear weights are
(out, in), 1x1 convs are Conv2d weights (out, in, 1, 1), PReLU slopes are
``weight``.

Mixed precision as in the JAX package: parameters are stored in float32 and
cast to the activation dtype at each product; LayerNorm and softmax run in
float32.

Two routes per block, chosen by ``backend``:

- ``"eager"``: plain PyTorch with the JAX XLA path's semantics. It is the
  oracle for every kernel, and runs in float32 (or float64) what the
  fused route's float32 forms do not take (``SUNet.fused_why``).
- ``"fused"``: the JAX Pallas path's routing (``SwinBlock.__call__``,
  ``chain_fusable_len``): whole-block kernel at C <= ``ROUTE_BLOCK_MAX_C``,
  W->SW pair chains at C >= ``ROUTE_PAIR_MIN_C``, and the split LN+W-MSA /
  LN+MLP kernels above the cap. The block kernel's form follows from the
  window: the cluster kernel up to 64 tokens, the sequence form above
  (WIN 16's 256 tokens, the scaled config's C=180 and C=360 stages;
  ``wa.block_seq_plan``). A block within the cap whose shape neither form
  takes (``SwinBlock.takes_block_kernel``: a head dim above 64, or no
  cluster size that divides the heads) also takes the split kernels, where
  JAX runs its block kernel: the two routes round y once more apart (y = x
  + round(attn) instead of round(x + attn)). The SW roll always happens
  inside the block kernel (load/store addressing), at any map size. JAX
  runs the "shift" softmax where scale * sqrt(head dim) = 1 (the scaled
  config, ``softmax_autoselect``); the port's kernels keep the row-max
  softmax, exact alike for logits in (-47, 80].

Training (a ``torch.Generator`` passed to ``forward``) draws per-image
stochastic-depth scales from it. On the fused route a block trains by its
width, a routing rule of the configuration and never a reaction to a kernel
failing:

- windows above 64 tokens (WIN 16: the scaled config's C=180, 360 and 720
  stages, 48 of its 56 blocks), C <= ``ROUTE_TRAIN_BLOCK_MAX_C`` (768,
  JAX's train cap ``_kernel_max_c(train=True)``) whose shape the sequence form
  (``wa.block_seq_takes``) and the big-window block backward
  (``wa.block_bwd_takes`` with the window: N a multiple of 64 up to 256, C
  a multiple of 4, an even head dim up to 64) take: ``SwinBlockTrainable``,
  the sequence form's train form (drop-path scales in its residual
  epilogues) and ``swin_block_bwd``'s big-window form, the recompute route,
  as JAX there (``bwd_residuals_enabled`` is false at N = 256);
- up to 64 tokens, C <= ``ROUTE_TRAIN_BLOCK_MAX_C`` (768, the same cap:
  JAX trains every such block on its block kernel) whose shape the block
  backward's kernels take (``wa.block_bwd_takes``: an even head dim whose
  attention fits their shared memory, up to 192 at 64 tokens) and the
  block kernel's train form takes: the cluster kernel where it has a plan
  (``wa.cluster_takes``: C <= 384, a head dim up to 64, a cluster size),
  else the sequence form at 64 tokens (``wa.block_seq_takes(train=True)``:
  the default model's C=768 stage, head dim 96, and C=384 with 2 heads,
  head dim 192). Where the attention takes JAX's blockdiag layout
  (``wa.bwd_residuals_enabled``: C=96 and 192 at WIN 8, 8 heads),
  ``ROUTE_TRAIN_RESID`` is set and the residual forms take the block (the
  cluster kernel's residual form and ``swin_block_bwd_res``: a head dim up
  to 64), ``SwinBlockTrainableRes``, the residual route, JAX's default
  there (``swin_block_trainable_res``): the block kernel's residual form
  stores the softmax state and ``swin_block_bwd_res`` differentiates it
  without recomputing it; else ``SwinBlockTrainable``, the block kernel's
  train form and ``swin_block_bwd`` backward, which recomputes the
  attention (JAX ``swin_block_trainable``, and every block of this width
  under ``SUNET_BWD_RESID=0``). A blockdiag block at a head dim above 64
  (C=192 with 2 heads) takes the recompute route where JAX takes its
  residual one: the same function with other bf16 rounding points;
- the others up to ``ROUTE_TRAIN_SPLIT_MAX_C`` (768) whose attention the
  LN+W-MSA backward takes (``wa.ln_wmsa_bwd_takes``; windows up to 64
  tokens): the two sublayers, ``LnWindowAttentionTrainable`` and
  ``LnMlpTrainable``, with the residuals and drop-path in autograd (JAX's
  sublayer route, ``ln_window_attention_trainable`` + ``ln_mlp_trainable``,
  taken under ``SUNET_TRAIN_BLOCK_KERNEL=0``, and here wherever
  ``ROUTE_TRAIN_BLOCK_MAX_C`` is set below a block's width);
- the rest (the scaled config's C=1440 bottleneck, a head dim whose
  attention neither backward's shared memory holds): autograd of the eager
  block, as JAX above ``SUNET_TRAIN_KERNEL_MAX_C=768``.

Training never takes the chain route.

Dropout (``SWINUNET.DROP_RATE`` after the GELU, after fc2 and after the
projection; ``ATTN_DROP_RATE`` on the float32 attention probabilities, JAX
``_dropout``) is active in training alone. A block with either rate above 0
trains on the eager block on both routes, as JAX's ``_can_fuse`` routes it;
its inference keeps every kernel route. One training forward of a block
draws from the caller's generator, in this order: the drop-path scales of
its two branches (nothing at rate 0), then, with a dropout rate above 0, one
seed for a block-local generator (``block_seed``; JAX's ``fold_in(key,
i)``) from which its four dropout sites draw their masks in call order
(probabilities, projection, GELU, fc2). The block's training computation
(``SwinBlock.train_forward``) is a pure function of its input and those
draws, so that activation checkpointing can run it again in backward and
draw the same masks.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from sunet_tf_tpu_torch.kernels import upsample as up_kernels
from sunet_tf_tpu_torch.kernels import window_attention as wa
from sunet_tf_tpu_torch.ops.constants import shape_constant
from sunet_tf_tpu_torch.ops.image import bilinear_resize, pixel_shuffle
from sunet_tf_tpu_torch.ops.window import (
    effective_window,
    relative_position_index,
    roll2d,
    shift_attn_mask,
    window_partition,
    window_reverse,
)

# Routing thresholds of the fused route (the JAX defaults of
# SUNET_PAIR_MIN_C and SUNET_INFER_KERNEL_MAX_C).
ROUTE_PAIR_MIN_C = 192
ROUTE_BLOCK_MAX_C = wa.BLOCK_KERNEL_MAX_C
# Longest run of blocks fused into one chain (W->SW pairs).
ROUTE_CHAIN_MAX = 2
# Widest block trained through the block kernels, at any window (JAX
# SUNET_TRAIN_KERNEL_MAX_C=768: the cluster kernel, or the sequence form's
# train form where the cluster kernel refuses the block or the window is
# above 64 tokens); the blocks the block kernels refuse, and any wider than
# this cap up to ROUTE_TRAIN_SPLIT_MAX_C with windows up to 64 tokens,
# train through the two sublayer kernels, the rest through autograd of the
# eager block.
ROUTE_TRAIN_BLOCK_MAX_C = wa.TRAIN_BLOCK_MAX_C
ROUTE_TRAIN_SPLIT_MAX_C = wa.SPLIT_TRAIN_MAX_C
# Train the blockdiag-layout blocks within ROUTE_TRAIN_BLOCK_MAX_C on the
# residual route (JAX's default); False is JAX's SUNET_BWD_RESID=0, the
# recompute backward for every such block.
ROUTE_TRAIN_RESID = True


class _LogitStats:
    """Process-wide opt-in for the attention-logit extrema
    (``obs.attention_logit_stats``; JAX's ``_LOGIT_STATS``): while
    ``enabled``, each eager W-MSA folds the global max and min of its
    logits after the rel-pos bias and before the SW mask into ``hi`` and
    ``lo`` (device scalars)."""

    enabled = False
    hi: Optional[torch.Tensor] = None
    lo: Optional[torch.Tensor] = None

    def observe(self, logits: torch.Tensor) -> None:
        hi, lo = logits.amax().detach(), logits.amin().detach()
        self.hi = hi if self.hi is None else torch.maximum(self.hi, hi)
        self.lo = lo if self.lo is None else torch.minimum(self.lo, lo)


LOGIT_STATS = _LogitStats()


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w.T + b in x's dtype (w in torch (out, in) layout)."""
    return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm in float32 (float64 for a float64 x), result in x's dtype."""
    xw = wa.wide(x)
    return F.layer_norm(xw, norm.normalized_shape, norm.weight.to(xw.dtype),
                        norm.bias.to(xw.dtype), norm.eps).to(x.dtype)


def kernel_weights(module: nn.Module, dtype, build):
    """``build()`` cached on ``module`` per dtype until any of its parameters
    changes (in-place updates such as ``load_state_dict`` bump a tensor's
    version). Inside a trace (``torch.export``) nothing is cached: the casts
    and pads are nodes of the graph, computed from the weights it is called
    with."""
    if torch.compiler.is_compiling():
        return build()
    key = (dtype,) + tuple((p.data_ptr(), p._version)
                           for p in module.parameters())
    cached = getattr(module, "_kernel_cache", None)
    if cached is None or cached[0] != key:
        cached = (key, build())
        module._kernel_cache = cached
    return cached[1]


def _frozen(t: torch.Tensor) -> torch.Tensor:
    """``t`` without autograd history; in a trace, ``t`` itself (the
    exported program runs without autograd, and a detach would be a node
    of it)."""
    return t if torch.compiler.is_compiling() else t.detach()


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous float32 tensor without autograd history, with
    no op where it already is one."""
    t = _frozen(t)
    t = t if t.dtype == torch.float32 else t.float()
    return t if t.is_contiguous() else t.contiguous()


def drop_path_scales(batch: int, rate: float,
                     generator: Optional[torch.Generator], device) -> torch.Tensor:
    """(batch, 2) float32 per-image stochastic-depth scales of a block's
    attention and MLP branches: keep/(1 - rate) with keep ~ Bernoulli(1 -
    rate), drawn from ``generator`` on its device (ones without a generator
    or at rate 0, as the JAX ``drop_path``)."""
    if generator is None or rate <= 0.0:
        return torch.ones(batch, 2, device=device)
    keep = 1.0 - rate
    p = torch.full((2, batch), keep, device=generator.device)
    return (torch.bernoulli(p, generator=generator) / keep).t().contiguous().to(device)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """JAX ``_dropout``: where(keep, x / (1 - rate), 0) with keep ~
    Bernoulli(1 - rate) per element, drawn from ``generator`` as float32
    uniforms (so a bf16 and a float32 model draw the same mask); x itself
    without a generator or at rate 0. The quotient is rounded once to x's
    dtype (a division, not a product with 1 / (1 - rate)); the divisor
    stays unrounded. JAX rounds its weakly typed scalar to x's dtype first,
    which in bf16 divides by 0.8984375 for 0.9 (kept values 0.17% larger):
    the port keeps bf16 and float32 computing one function, and equals JAX
    in float32."""
    if generator is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def block_seed(generator: torch.Generator) -> int:
    """One seed for a block-local generator, drawn from ``generator`` (on
    the card a read of one value, which waits for the device)."""
    return int(torch.randint(0, 1 << 62, (1,), generator=generator,
                             device=generator.device).item())


def drop_path(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-sample stochastic depth: x scaled by its image's (B,) scale."""
    return x * scale.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)


def _mask_tensor(H: int, W: int, ws: int, shift: int, device: torch.device) -> torch.Tensor:
    return shape_constant(("sw_mask", H, W, ws, shift, device), lambda: torch.as_tensor(
        shift_attn_mask(H, W, ws, shift), device=device))


class PReLU(nn.Module):
    """Single-slope PReLU, init 0.25 (torch nn.PReLU default)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.weight.to(x.dtype)
        return torch.clamp_min(x, 0) + a * torch.clamp_max(x, 0)


class Conv1x1(nn.Conv2d):
    """1x1 convolution applied as a channel-axis Linear on NHWC input."""

    def __init__(self, in_ch: int, out_ch: int, bias: bool = True):
        super().__init__(in_ch, out_ch, 1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight.flatten(1), self.bias)

    def kernel(self) -> torch.Tensor:
        """(in, out) float32 matrix, the JAX kernel layout."""
        return self.weight.flatten(1).t()


class Conv3x3(nn.Conv2d):
    """3x3 SAME convolution on NHWC input, in x's dtype."""

    def __init__(self, in_ch: int, out_ch: int, bias: bool = True):
        super().__init__(in_ch, out_ch, 3, padding=1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                     None if self.bias is None else self.bias.to(x.dtype),
                     padding=1)
        return y.permute(0, 2, 3, 1)


class Mlp(nn.Module):
    """fc1 -> exact-erf GELU -> dropout -> fc2 -> dropout (``drop``, with a
    generator)."""

    def __init__(self, dim: int, hidden: int, drop: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.drop = drop

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = dropout(F.gelu(linear(x, self.fc1.weight, self.fc1.bias)), self.drop, generator)
        return dropout(linear(h, self.fc2.weight, self.fc2.bias), self.drop, generator)


class WindowAttention(nn.Module):
    """W-MSA with learnable relative-position bias; logits and softmax in
    float32; the additive 0/-100 SW mask per window."""

    def __init__(self, dim: int, window_size: int, num_heads: int, *,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.dim = dim
        self.window_size = window_size
        self.num_heads = num_heads
        self.scale = (float(qk_scale) if qk_scale is not None
                      else (dim // num_heads) ** -0.5)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def bias_matrix(self) -> torch.Tensor:
        """(num_heads, N, N) relative-position bias, float32 (float64 from a
        float64 table)."""
        ws = self.window_size
        n = ws * ws
        dev = self.relative_position_bias_table.device
        idx = shape_constant(("rel_index", ws, dev), lambda: torch.as_tensor(
            relative_position_index(ws, ws).reshape(-1), dtype=torch.long, device=dev))
        bias = wa.wide(self.relative_position_bias_table[idx])
        return bias.reshape(n, n, self.num_heads).permute(2, 0, 1)

    def forward(self, xw: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """xw: (B*nW, N, C) windows; mask: (nW, N, N) or None; dropout of
        the float32 probabilities and of the projection from
        ``generator``."""
        Bn, N, C = xw.shape
        h, d = self.num_heads, C // self.num_heads
        dt = xw.dtype
        qkv = linear(xw, self.qkv.weight, self.qkv.bias)
        qkv = qkv.reshape(Bn, N, 3, h, d).permute(2, 0, 3, 1, 4)
        q = qkv[0] * torch.tensor(self.scale, dtype=dt)
        k, v = qkv[1], qkv[2]
        attn = wa.mm32(q, k.transpose(-1, -2)) + self.bias_matrix()[None]
        if LOGIT_STATS.enabled:
            LOGIT_STATS.observe(attn)
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(Bn // nW, nW, h, N, N)
                    + mask[None, :, None]).reshape(Bn, h, N, N)
        attn = dropout(torch.softmax(attn, dim=-1), self.attn_drop, generator)
        out = wa.mm32(attn.to(dt), v).to(dt)
        out = out.permute(0, 2, 1, 3).reshape(Bn, N, C)
        return dropout(linear(out, self.proj.weight, self.proj.bias), self.proj_drop,
                       generator)


class SwinBlock(nn.Module):
    """LN -> (shift) -> W-MSA -> (unshift) -> residual -> LN -> MLP ->
    residual. (window, shift) are resolved from the stage's resolution; the
    SW mask is rebuilt from the actual input shape at call time."""

    def __init__(self, dim: int, input_resolution: tuple, num_heads: int, *,
                 window_size: int, shift_size: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path_rate: float = 0.0, backend: str = "eager"):
        super().__init__()
        ws, ss = effective_window(input_resolution, window_size, shift_size)
        self.window_size = ws
        self.shift_size = ss
        self.dim = dim
        self.input_resolution = tuple(input_resolution)
        self.drop_path_rate = drop_path_rate
        self.backend = backend
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, ws, num_heads, qkv_bias=qkv_bias,
                                    qk_scale=qk_scale, attn_drop=attn_drop,
                                    proj_drop=drop)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop=drop)

    def has_dropout(self) -> bool:
        """Whether training draws dropout masks (JAX ``not _can_fuse``):
        then it runs the eager block on every route."""
        return self.attn.attn_drop > 0.0 or self.mlp.drop > 0.0

    def mask(self, H: int, W: int, device) -> Optional[torch.Tensor]:
        if self.shift_size == 0:
            return None
        return _mask_tensor(H, W, self.window_size, self.shift_size,
                            torch.device(device))

    def kernel_params(self, dtype) -> tuple:
        """The 12 block operands in the kernels' layout: LN params float32,
        weight matrices (in, out) in ``dtype`` with their columns padded with
        zeros to multiples of 8 (``wa.wcols``: wqkv, wproj and w2 at C=180,
        so that TMA reads their rows; the wrappers take either form),
        biases float32."""
        def build():
            a, m = self.attn, self.mlp

            def w(lin):
                t = _frozen(lin.weight).t()
                pad = wa.wcols(t.shape[1]) - t.shape[1]
                if pad:
                    t = F.pad(t, (0, pad))
                # one copy: the cast writes the (in, out) layout (in float32,
                # where there is no cast, the copy is contiguous())
                return t.to(dtype, memory_format=torch.contiguous_format).contiguous()
            f = _f32
            bqkv = (f(a.qkv.bias) if a.qkv.bias is not None
                    else torch.zeros(3 * self.dim, device=a.qkv.weight.device))
            return (f(self.norm1.weight), f(self.norm1.bias), w(a.qkv), bqkv,
                    w(a.proj), f(a.proj.bias), f(self.norm2.weight),
                    f(self.norm2.bias), w(m.fc1), f(m.fc1.bias), w(m.fc2),
                    f(m.fc2.bias), _frozen(self.attn.bias_matrix()).contiguous())
        return kernel_weights(self, dtype, build)

    def _fused_block(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[1], x.shape[2]
        p = self.kernel_params(x.dtype)
        a = self.attn
        return wa.fused_swin_block(
            x, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10],
            p[11], p[12], self.mask(H, W, x.device), ws=self.window_size,
            num_heads=a.num_heads, scale=a.scale, shift=self.shift_size)

    def _fused_split(self, x: torch.Tensor) -> torch.Tensor:
        """Blocks above the block-kernel cap: LN+W-MSA kernel, residual,
        LN+MLP kernel (JAX ``_attention_fused`` + ``fused_ln_mlp``)."""
        B, H, W, C = x.shape
        ss = self.shift_size
        p = self.kernel_params(x.dtype)
        a = self.attn
        att = wa.fused_ln_window_attention(
            roll2d(x, -ss), p[0], p[1], p[2], p[3], p[4], p[5], p[12],
            self.mask(H, W, x.device), ws=self.window_size,
            num_heads=a.num_heads, scale=a.scale)
        x = x + roll2d(att, ss)
        return wa.fused_ln_mlp(x, p[6:8], p[8], p[9], p[10], p[11])

    def takes_block_kernel(self) -> bool:
        """Whether the whole-block kernel has a launch plan for this block's
        shape in the form its window takes: the cluster form up to 64 tokens
        (``wa.block_kernel_takes``), the sequence form above
        (``wa.block_seq_takes``); the router's caps still apply."""
        hidden, heads, ws = self.mlp.fc1.out_features, self.attn.num_heads, self.window_size
        if ws * ws > 64:
            return wa.block_seq_takes(self.dim, hidden, heads, ws)
        return wa.block_kernel_takes(self.dim, hidden, heads)

    def trains_on_block_kernels(self) -> bool:
        """Whether training takes the block kernels (the residual route or
        the recompute one) rather than the sublayer kernels: C <=
        ROUTE_TRAIN_BLOCK_MAX_C, the block backward's kernels take the
        block (``wa.block_bwd_takes``) and its forward runs on the cluster
        kernel (``wa.cluster_takes``) or on the sequence form's train form
        (above 64 tokens, or where the cluster kernel refuses the block)."""
        C, hidden, heads, ws = self.dim, self.mlp.fc1.out_features, self.attn.num_heads, \
            self.window_size
        return (C <= ROUTE_TRAIN_BLOCK_MAX_C and wa.block_bwd_takes(C, hidden, heads, ws)
                and (wa.cluster_takes(C, hidden, heads, ws)
                     or wa.block_seq_takes(C, hidden, heads, ws, train=True)))

    def trains_on_split_kernels(self) -> bool:
        """Whether training takes the two sublayer kernels (when it does not
        take the block kernels), whose backward takes windows up to 64
        tokens; else the eager block."""
        return (self.dim <= ROUTE_TRAIN_SPLIT_MAX_C and self.window_size ** 2 <= 64
                and wa.ln_wmsa_bwd_takes(self.dim, self.attn.num_heads, self.window_size))

    def trains_on_residuals(self) -> bool:
        """Whether training takes the residual route (when the block trains
        through the block kernels): JAX's rule up to 64 tokens a window,
        where the residual forms take the block (the cluster kernel's
        residual form, and ``swin_block_bwd_res`` at a head dim up to 64;
        JAX's rule is false at the default model's C=384 and C=768);
        above, the recompute route (at the scaled config's widths JAX's
        rule says so too; at a width where it would pick the blockdiag
        layout at 256 tokens, the shrunk test config's C=60 and 120, the two
        routes differ in bf16 rounding points alone)."""
        C, hidden, heads, ws = self.dim, self.mlp.fc1.out_features, self.attn.num_heads, \
            self.window_size
        return (ROUTE_TRAIN_RESID and ws * ws <= 64
                and wa.bwd_residuals_enabled(C, heads, ws * ws)
                and wa.cluster_takes(C, hidden, heads, ws)
                and wa.block_bwd_takes(C, hidden, heads, ws, res=True))

    def _train_block(self, x: torch.Tensor, dp: torch.Tensor) -> torch.Tensor:
        """Training through the block kernels (JAX ``_trainable_block``), on
        the residual route or the recompute one: autograd reaches the
        float32 parameters through the (in, out) weight views and the
        rel-pos bias gather."""
        a, m = self.attn, self.mlp
        H, W = x.shape[1], x.shape[2]
        t = lambda lin: lin.weight.t()
        fn = (wa.SwinBlockTrainableRes if self.trains_on_residuals()
              else wa.SwinBlockTrainable)
        return fn.apply(
            x, self.norm1.weight, self.norm1.bias, t(a.qkv), a.qkv.bias,
            t(a.proj), a.proj.bias, self.norm2.weight, self.norm2.bias,
            t(m.fc1), m.fc1.bias, t(m.fc2), m.fc2.bias, a.bias_matrix(), dp,
            self.mask(H, W, x.device), self.window_size, a.num_heads, a.scale,
            self.shift_size)

    def _train_split(self, x: torch.Tensor, dp: torch.Tensor) -> torch.Tensor:
        """Training through the two sublayer kernels (the JAX sublayer
        route, ``layers.py`` ``SwinBlock.__call__``): x + drop_path(roll(
        LN+W-MSA(roll(x, -ss)), ss)), then y + drop_path(LN+MLP(y)); the
        roll, the residuals and drop-path run in autograd."""
        a, m = self.attn, self.mlp
        H, W = x.shape[1], x.shape[2]
        ss = self.shift_size
        t = lambda lin: lin.weight.t()
        att = wa.LnWindowAttentionTrainable.apply(
            roll2d(x, -ss), self.norm1.weight, self.norm1.bias, t(a.qkv), a.qkv.bias,
            t(a.proj), a.proj.bias, a.bias_matrix(), self.mask(H, W, x.device),
            self.window_size, a.num_heads, a.scale)
        x = x + drop_path(roll2d(att, ss), dp[:, 0])
        y = wa.LnMlpTrainable.apply(x, self.norm2.weight, self.norm2.bias, t(m.fc1),
                                    m.fc1.bias, t(m.fc2), m.fc2.bias)
        return x + drop_path(y, dp[:, 1])

    def _eager(self, x: torch.Tensor, dp: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The plain block; ``generator``: the block-local generator of its
        dropout masks."""
        B, H, W, C = x.shape
        ws, ss = self.window_size, self.shift_size
        h = roll2d(layer_norm(x, self.norm1), -ss)
        h = self.attn(window_partition(h, ws), self.mask(H, W, x.device), generator)
        h = roll2d(window_reverse(h, ws, H, W), ss)
        x = x + (h if dp is None else drop_path(h, dp[:, 0]))
        h = self.mlp(layer_norm(x, self.norm2), generator)
        return x + (h if dp is None else drop_path(h, dp[:, 1]))

    def draws(self, x: torch.Tensor, generator: torch.Generator) -> tuple:
        """The randomness of one training forward of this block, drawn from
        ``generator`` in the documented order: (drop-path scales (B, 2),
        the dropout seed or None)."""
        dp = drop_path_scales(x.shape[0], self.drop_path_rate, generator, x.device)
        return dp, (block_seed(generator) if self.has_dropout() else None)

    def train_forward(self, x: torch.Tensor, dp: torch.Tensor,
                      seed: Optional[int]) -> torch.Tensor:
        """The training forward as a pure function of ``x`` and the draws
        of :meth:`draws` (what activation checkpointing runs again)."""
        if seed is not None:
            return self._eager(x, dp, torch.Generator(device=x.device).manual_seed(seed))
        if self.backend == "fused" and self.trains_on_block_kernels():
            return self._train_block(x, dp)
        if self.backend == "fused" and self.trains_on_split_kernels():
            return self._train_split(x, dp)
        return self._eager(x, dp)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Inference without ``generator``; training with it (stochastic
        depth and dropout drawn from it)."""
        B, H, W, C = x.shape
        ws = self.window_size
        if H % ws or W % ws:
            raise ValueError(f"resolution ({H},{W}) not divisible by window {ws}")
        if generator is not None:
            return self.train_forward(x, *self.draws(x, generator))
        if self.backend == "eager":
            return self._eager(x)
        if self.dim <= ROUTE_BLOCK_MAX_C and self.takes_block_kernel():
            return self._fused_block(x)
        return self._fused_split(x)


def chain_fusable_len(blocks: list, start: int, x: torch.Tensor) -> int:
    """Length K >= 2 of the run of consecutive fused blocks from ``start``
    that runs as one chain, else 0: C within [ROUTE_PAIR_MIN_C,
    ROUTE_BLOCK_MAX_C], same dim, window, heads and scale, one shift among
    the SW blocks, K <= ROUTE_CHAIN_MAX."""
    C = x.shape[-1]
    if C < ROUTE_PAIR_MIN_C or C > ROUTE_BLOCK_MAX_C:
        return 0
    b0 = blocks[start]
    if b0.backend != "fused" or b0.dim != C or not b0.takes_block_kernel():
        return 0
    n = 1
    ss = b0.shift_size or None
    while start + n < len(blocks) and n < ROUTE_CHAIN_MAX:
        b = blocks[start + n]
        if not (b.backend == "fused" and b.dim == C
                and b.window_size == b0.window_size
                and b.attn.num_heads == b0.attn.num_heads
                and b.mlp.fc1.out_features == b0.mlp.fc1.out_features
                and b.attn.scale == b0.attn.scale):
            break
        if b.shift_size > 0:
            if ss is None:
                ss = b.shift_size
            elif b.shift_size != ss:
                break
        n += 1
    return n if n >= 2 else 0


def run_fused_chain(blocks: list, x: torch.Tensor) -> torch.Tensor:
    """Run consecutive blocks through the chain kernel (gate with
    :func:`chain_fusable_len`)."""
    B, H, W, C = x.shape
    shifts = tuple(b.shift_size for b in blocks)
    params = [b.kernel_params(x.dtype) for b in blocks]
    sw = next((b for b in blocks if b.shift_size), None)
    a = blocks[0].attn
    return wa.fused_swin_block_chain(
        x, [p[:12] for p in params], [p[12] for p in params],
        None if sw is None else sw.mask(H, W, x.device),
        ws=blocks[0].window_size, num_heads=a.num_heads, scale=a.scale,
        shifts=shifts)


class PatchMerging(nn.Module):
    """2x2 space-to-depth [ee, oe, eo, oo] -> LN(4C) -> Linear(4C -> 2C)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        if H % 2 or W % 2:
            raise ValueError(f"({H},{W}) not even")
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return linear(layer_norm(x, self.norm), self.reduction.weight)


class PatchEmbed(nn.Module):
    """k = s = patch_size conv + LN; SUNet folds its conv into the stem."""

    def __init__(self, in_ch: int, embed_dim: int, patch_size: int, *,
                 patch_norm: bool = True):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, embed_dim, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5) if patch_norm else None


class DualUpsample(nn.Module):
    """Dual up-sample: pixel-shuffle branch + bilinear branch, 1x1 mix.

    factor 2: C -> C/2 at 2x; factor 4: C -> C at 4x. Branch p: 1x1 expand
    (no bias) -> PReLU -> PixelShuffle -> 1x1; branch b: 1x1 (bias) ->
    PReLU -> bilinear -> 1x1; ``conv`` mixes the concat. Computed with the
    JAX package's three weight-space folds: branch b runs at low res and
    resizes last, the concat+mix splits into two projections, and each
    branch's second 1x1 folds into its mix projection.
    """

    def __init__(self, in_ch: int, factor: int):
        super().__init__()
        if factor not in (2, 4):
            raise ValueError(f"factor {factor} not in (2, 4)")
        self.factor = factor
        out_ch = in_ch // 2 if factor == 2 else in_ch
        expand = 2 * in_ch if factor == 2 else 16 * in_ch
        self.up_p = nn.ModuleList([Conv1x1(in_ch, expand, bias=False), PReLU(),
                                   nn.PixelShuffle(factor),
                                   Conv1x1(out_ch, out_ch, bias=False)])
        self.up_b = nn.ModuleList([Conv1x1(in_ch, in_ch, bias=True), PReLU(),
                                   nn.Identity(),
                                   Conv1x1(in_ch, out_ch, bias=False)])
        self.conv = Conv1x1(2 * out_ch, out_ch, bias=False)

    def folded(self, dtype=torch.float32) -> tuple:
        """(wpf, wbf): each branch's second 1x1 times its mix half, (in, out),
        folded in float32 (float64 for ``dtype`` float64)."""
        out_ch = self.conv.out_channels
        ct = torch.promote_types(dtype, torch.float32)
        mix = self.conv.kernel().to(ct)
        return (self.up_p[3].kernel().to(ct) @ mix[:out_ch],
                self.up_b[3].kernel().to(ct) @ mix[out_ch:])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        wpf, wbf = self.folded(dt)
        xp = pixel_shuffle(self.up_p[1](self.up_p[0](x)), self.factor)
        xb = self.up_b[1](self.up_b[0](x))
        return (torch.matmul(xp, wpf.to(dt))
                + bilinear_resize(torch.matmul(xb, wbf.to(dt)), self.factor))

    def _kernel_params(self, dt) -> tuple:
        """The x4 head's weights for the kernels, cached per dtype: w_exp,
        alpha_p, w_b1, b_b1, alpha_b, wpf, wbf."""
        def build():
            wpf, wbf = self.folded()
            w = lambda t: _frozen(t).to(dt, memory_format=torch.contiguous_format).contiguous()
            return (w(self.up_p[0].kernel()), _frozen(self.up_p[1].weight),
                    w(self.up_b[0].kernel()), _frozen(self.up_b[0].bias),
                    _frozen(self.up_b[1].weight), w(wpf), w(wbf))

        return kernel_weights(self, dt, build)

    def fused_head(self, x: torch.Tensor) -> torch.Tensor:
        """The x4 head through the split-head kernel (JAX
        ``fused_dual_upsample4``): (B, 4H, 4W, C) in x's dtype."""
        if self.factor != 4:
            raise ValueError("fused_head needs the x4 head")
        return up_kernels.fused_dual_upsample4(x, *self._kernel_params(x.dtype))

    def head_trainable(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable x4 head, float32 weights: the split-head kernel
        forward and ``up4_bwd`` backward (JAX ``dual_upsample4_trainable``);
        autograd carries the grads of wpf and wbf back through the
        weight-space folds. Returns (B, 4H, 4W, C) in x's dtype."""
        if self.factor != 4:
            raise ValueError("head_trainable needs the x4 head")
        wpf, wbf = self.folded()
        return up_kernels.DualUpsample4Trainable.apply(
            x, self.up_p[0].kernel(), self.up_p[1].weight, self.up_b[0].kernel(),
            self.up_b[0].bias, self.up_b[1].weight, wpf, wbf)

    def fused_conv_head(self, x: torch.Tensor, wconv: torch.Tensor) -> torch.Tensor:
        """x4 head AND a following 3x3 bias-free conv ``wconv`` (3, 3, C,
        out) through the phase-space kernel; returns pixel-space (B, 4H, 4W,
        out) in x's dtype."""
        if self.factor != 4:
            raise ValueError("fused_conv_head needs the x4 head")
        return up_kernels.phase_to_pixel(up_kernels.fused_dual_upsample4_conv_phase(
            x, *self._kernel_params(x.dtype), wconv))

    def conv_head_trainable(self, x: torch.Tensor,
                            wconv: torch.Tensor) -> torch.Tensor:
        """Differentiable x4 head + 3x3 bias-free conv ``wconv`` (3, 3, C,
        out), float32: the phase-space kernel forward and ``up4_conv_bwd``
        backward (JAX ``conv_head_trainable``); autograd carries the grads
        of wpf and wbf back through the weight-space folds. Returns
        pixel-space (B, 4H, 4W, out) in x's dtype."""
        if self.factor != 4:
            raise ValueError("conv_head_trainable needs the x4 head")
        wpf, wbf = self.folded()
        phase = up_kernels.DualUpsample4ConvTrainable.apply(
            x, self.up_p[0].kernel(), self.up_p[1].weight, self.up_b[0].kernel(),
            self.up_b[0].bias, self.up_b[1].weight, wpf, wbf, wconv)
        return up_kernels.phase_to_pixel(phase)


def torch_default_init_(module: nn.Module, gen: torch.Generator):
    """The reference initialisation, drawn on the CPU from ``gen``: Linear
    N(0, 0.02) with zero bias, LayerNorm ones/zeros, rel-pos tables
    N(0, 0.02), convs kaiming-uniform(a=sqrt(5)) (U(+-1/sqrt(fan_in))),
    PReLU 0.25."""
    def put(t: torch.Tensor, src: torch.Tensor):
        with torch.no_grad():
            t.copy_(src)

    for m in module.modules():
        if isinstance(m, nn.Linear):
            put(m.weight, torch.empty(m.weight.shape).normal_(0, 0.02, generator=gen))
            if m.bias is not None:
                put(m.bias, torch.zeros(m.bias.shape))
        elif isinstance(m, nn.LayerNorm):
            put(m.weight, torch.ones(m.weight.shape))
            put(m.bias, torch.zeros(m.bias.shape))
        elif isinstance(m, nn.Conv2d):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            put(m.weight, torch.empty(m.weight.shape).uniform_(-bound, bound,
                                                               generator=gen))
            if m.bias is not None:
                put(m.bias, torch.empty(m.bias.shape).uniform_(-bound, bound,
                                                               generator=gen))
        elif isinstance(m, WindowAttention):
            t = m.relative_position_bias_table
            put(t, torch.empty(t.shape).normal_(0, 0.02, generator=gen))
        elif isinstance(m, PReLU):
            put(m.weight, torch.full(m.weight.shape, 0.25))
