#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--phases kernels,fp32,train_kernels,slice,demo,tiled,export,
                           parallel,train,parity,bands,entries,scaled,scaled_train,data]

1. Prints the card's name and power limit (nvidia-smi); fails without CUDA.
2. Builds the hand-written CUDA kernels (one nvcc per source, in parallel,
   then a link) and prints the time.
3. One phase per kernel at the default model's shapes, batch 2, bf16
   (and #1, #3, #4 and #5 also at batch 4 with each launch plan asserted,
   #1 at head counts whose cluster size is not a power of two, #3 at
   (16,16,768) with the SW mask and at C=384 with 2 heads (head dim 192),
   #5 on a map that is not a multiple of its 6 x 8 tile, on a map of one
   tile and at C=192, out 8; #1-#5 and #10 at batch 5 on the main path's
   shapes, the tiled path's odd batch):
   kernel vs its plain PyTorch version (max and mean |diff| against a
   stated tolerance), the median device time of each over 20
   CUDA-event-timed runs after warm-up (the card spins first, so the host's
   pace of launches does not count), and the kernel's bound (bytes or operations over
   the card's published peak rates); where a call launches several kernels
   (#9, #12, #14), its launches per call against the wrapper's constant. The forward
   kernels also include the
   split x4 head (#10, also at batch 4, on a map that is not a multiple of
   its tile and at C=256, its cap, each with its plan asserted and two runs
   equal bit for bit) and the standalone W-MSA (#15, shift 0 and 4, and
   without a qkv bias, with one PyTorch call for the same function timed
   beside it). The training kernels: the block kernel's
   train form (drop-path scales), the block backward (also at batch 4: the
   residual route's at C=96 and 192, the recompute form's at C=384, the
   default route's rule), the x4 head backward (#9, also at batch 4 out 1
   and 3, at out 8 and on a (34,40) map of partial tiles, its plan
   asserted),
   the C=768 sublayers (the LN+W-MSA backward, the LN+MLP branch, also on a
   (16,16,768) map, and its backward; the LN+W-MSA backward also at batch
   4 and at C=384 with 2
   heads, head dim 192; the LN+MLP backward also at batch 4 and on a
   (16,16,768) map whose window order is not its row order, its K split
   asserted and its workspace held to the mirror), the C=768 stage's
   training forms (``c768_train_cases``: #1's train form on the sequence
   form at 64-token windows and #8 at head dim 96, at batch 4 (8,8,768),
   a masked (16,16,768) map, that map at ~1e4 logits and (16,16,384) with
   2 heads, each timed beside the sublayer kernels for the same block),
   the residual route of the C=96/192 blocks (the
   block forward that stores the softmax state, at shift 0 and 4, batch 2
   and 4 on the main path's cluster sizes, output and state held against
   the plain version, and the backward from that state), and the split
   head's backward (#11, also on a (30,44) map of partial tiles and at C=256,
   its cap), dx and every weight grad held against the plain version.
   The float32 route (phase ``fp32``, ROADMAP B2's serving half): each
   float32 form of #1-#5 (csrc/f32_swin_block.cu, f32_block.cu, f32_up4.cu) at the
   default model's shapes, batch 2 (#1 at C=96/192/384 shift 0 and 4 and
   at ~1e4 logits, #2's K=2 chains, bit for bit against two block launches,
   #3 at (8,8,768), ~1e4 logits and on a masked (16,16,768) map, #4 at
   (8,8,768), #5 at (64,64,96) out 1 and 3 and on a (34,40,96) map), held
   with its float32 plain version against the plain version in float64 on
   float64 copies (rl2 and max |diff| within FP32_FACTOR of the plain
   version's, rl2 <= FP32_RL2_MAX; at ~1e4 logits the factor alone) and
   timed beside the bf16 kernel; then ``Config()`` in float32 on the eager
   route at 128², batch 1, on the card and on the CPU against its float64
   copy (forward, stem and one training step's gradients; the card within
   FP32_FACTOR of the CPU, the forward within FP32_RL2_MAX; a control with
   the TF32 guards taken out must fail); then the fused float32 ``Config()``
   at 256² batch 4 (launches equal to ``expected_launches``, no plain
   version, within the gates against eager float32 and float64, its
   exported program bit for bit) and its times beside eager float32 and
   fused bf16; a float32 training forward, 256-token windows and a spatial
   stage runner must raise NotImplementedError naming their ROADMAP item
   before any launch. Its cases and launches are filed under the wrapper's
   name + ``[fp32]``.
4. The inference slice: the default SUNet (99,681,993 parameters, seeded
   weights) at 256x256 batch 4 through backend="fused"; the kernels' launch
   counts must equal the router's prediction, and every launch plan it
   takes must be one that 3. held against its plain version; the output is held against
   backend="eager" on the same weights (finite, mean |diff| <= 5e-3); the
   forward's device time and its time paced by the host; one forward is
   traced with torch.profiler for its device time by kernel.
5. The entry point: ``sunet_tf_tpu_torch.demo.main`` on synthetic PNGs.
   Then tiled inference (``infer.tiled``): ``Config()`` on a 1024x1024 image
   at 256 tiles, stride 128 (49 tiles in one forward) through
   backend="fused", launches, plans and output checked as in 4., against
   eager (mean |diff| <= 5e-3); identity reconstruction at 1000x1500 on both
   canvases (max |diff| <= 1e-6); tile_batch 16 against 64; device and
   host-paced times, a trace, and the gather / forward / fold device time;
   ``tools/corpus_bench.py``'s corpus one image at a time against
   ``run_corpus``; ``demo_any_resolution.main`` (with masks) and
   ``evaluate.main`` on its inputs and outputs.
   Then the serving artifacts (phase ``export``, ``infer/export.py``):
   ``Config()`` exported by ``torch.export`` at batch buckets 1 and 4, the
   kernels as ``sunet::`` ops, reloaded in this run; requests of n = 1, 3
   (bucket 4's zero-padded tail) and 4 equal to the live fused forward of
   the batch each ran, bit for bit, each with the router's launch counts
   and no plain version run; bucket 4 against eager (mean |diff| <= 5e-3);
   the artifact with perturbed weights; each .pt2 under 5% of the weights'
   float32 bytes; device busy time (profiler) and host-paced time of the
   artifact and the live model at batch 1 and 4; an op's dispatch cost;
   a 1024x1024 canvas's tiled artifact against the live ``TiledRunner``
   on a 1017x1011 image; the 16-band model's and ``scaled_config()``'s
   batch-1 buckets, bit for bit.
6. The training slice: one training step of the default SUNet at 256x256
   batch 4 on a synthetic dataset, fused vs eager on the same weights,
   batch and drop-path draws (loss and every parameter's gradient), launch
   counts equal to ``expected_launches(train=True)`` with every block on a
   kernel route (C=96/192 the residual route, C=384 the block kernels with
   the recompute backward, the C=768 stage the sequence form's train form
   and #8 at head dim 96, its launches also counted by form) and every
   launch plan held by 3., the same step with ``ROUTE_TRAIN_RESID`` off
   (every block on the recompute backward) and on the route the C=768
   stage took before (``fused_sublayer``: #3, #12, #13, #14, the model
   path of those kernels), each held against float32 eager; then fault
   C2's arbiter: the step on the two fused routes and on both with every
   kernel by its plain version against the eager model in float64 (float64
   parameters and products; the same weights, batches and drop-path draws)
   over C2_DRAWS batches, per stage the geometric means of 1 - cos and of
   the relative L2 distance, each fused route's within C2_FACTOR times its
   plain route's, and each tensor's scale z within C2_SCALE_Z; train-step
   times, peak memory and a profiler trace of one step of each fused route;
   then ``python -m sunet_tf_tpu_torch.train`` for 1 epoch of 3 steps and a
   val pass.
   Then the parity phase (``parity``): ``python -m
   sunet_tf_tpu_torch.tools.parity_run`` (its own process) trains
   ``Config()`` for 40 fused steps at batch 4 on a synthetic corpus and
   validates the trained weights on fused bf16, eager bf16 and eager
   float32 against the float64 oracle (PSNR, SSIM, gaps, attention-logit
   extrema); ``tools.fp64_oracle`` and ``tools.bisect_fp64`` then read its
   checkpoint. It fails unless every gate of its RESULTS.json holds, fused
   vs eager bf16 reads mean |diff| <= 5e-3, every oracle probe is float64
   and agrees with the oracle on the CPU within ORACLE_CPU_RL2, and the
   loss is finite.
7. The split head's path: ``Config()`` with IN_CHANS = OUT_CHANS = 16 (a
   16-band denoise SUNet) through the slice of 4. and one tiled call on a
   (1, 512, 384, 16) image (a 512x512 canvas, 9 tiles), then one denoise
   training step on the fused route (the head on #10 + #11) under the gate
   of 6., with its time, added memory and a profiler trace.
8. The entry points with no model route: ``kernels.fused_window_attention``
   (#15) once, and the ALU-rate probe ``tools/alu_floor.py`` (#16): each
   chain's instructions per pipe read from this build's SASS and held to
   ALU_OPS (its bound's counts), each chain against its plain version at
   T=16, then its rates at T=2048.

9. The scaled SUNet (phase ``scaled``): its kernel forms against their
   plain versions at batch 2, plans asserted (``scaled_cases``: #1's
   sequence form for 256-token windows at (128,128,180) shift 0 and 8 and
   (64,64,360), each residual branch alone under the forward limits and
   the whole block under SEQ_BLOCK_MEAN_TOL; #2 K=2 at C=360, also bit for
   bit against two block launches; #3 at (32,32,720) shift 8 and
   (16,16,1440), also with ~1e3 logits; #4 at C=720 and 1440 (fc1 on a K
   split); #5 at (128,128,180) out 1 and 3, padded to 192; fault C4's
   reading on each whole block of #1: the kernel's and the plain version's
   mean |diff| to the plain version in float64 on float64 copies of the
   same draws, their ratio within C4_RATIO); then
   ``scaled_config()`` (350,723,145 parameters, seeded weights) fused at
   512², batch 8: launches equal to the router's prediction with every
   block on a kernel, every plan held by those checks, against eager (mean
   |diff| <= 5e-3), device-paced and host-paced img/s, a trace's busy and
   idle share, the forward's added peak memory; then ``python -m
   sunet_tf_tpu_torch.demo --config`` with the config's YAML on three 512²
   PNGs (its own process). Its kernels' cases and
   launches are filed under the wrapper's name + ``[scaled]``.
10. The scaled SUNet's training step (phase ``scaled_train``): its kernel
   forms against their plain versions at batch 2, plans asserted
   (``scaled_train_cases``: #1's train form, the sequence form with
   drop-path scales drawn from a generator, at (128,128,180), (64,64,360)
   and (32,32,720) shift 8, each branch alone and the whole block, with
   C4's float64 reading on the whole block; #8's
   big-window form (csrc/block_bwd_big.cuh's attention) at (128,128,180)
   shift 0 and 8, (64,64,360) and (32,32,720) shift 8 under the backward
   limits; #5 at (128,128,180) out 1; #9's wide form at (128,128,180) out
   1, C padded to 192, and (32,32,128)); then one training step of
   ``scaled_config()`` at 512², batch 4 (OPTIM.BATCH), on a generated
   corpus: launches equal to ``expected_launches(train=True)`` (48 blocks
   on #1 + #8, the 8 C=1440 blocks on eager autograd, the head on #5 +
   #9), every plan held by those checks, the training gate against eager
   float32 (batch 2 where the gate's steps do not fit at 4, the reason
   printed), the timed and traced fused step (host-paced ms, device busy
   ms, idle share, memory a steady step adds) and the C=1440 stage's eager
   forward + backward; then ``python -m sunet_tf_tpu_torch.train`` with
   the config's YAML for 2 steps (its own process). Cases and training
   launches are filed under the wrapper's name + ``[scaled]``.

11. The parallel tier (phase ``parallel``, after ``export``): the B5 form
   against its plain versions (``b5_cases``: #1's inference and train forms
   and #8 at shift 0 with a shard's slice of the SW-MSA mask, on the
   shards of ``Config()``'s three kernel stages at 256² over two spatial
   ranks, the train form on the sequence form at 64 tokens (on the whole
   map's plan) and #8 at head dim 96 on a (8,16,768) shard of the C=768
   stage at 512², and the sequence form's train form and #8's big-window
   form on ``scaled_config()``'s first stage's shard;
   ``swin_block_trainable_dynmask`` equal to the wrapper calls it makes);
   then ranks spawned by
   ``parallel.launch.run_ranks`` on the kernels built here: world size 1
   over NCCL, ``Config()`` at batch 4 (the training step, an eval pass and
   a 1024x1024 tiled image with the mesh equal to the same without it, bit
   for bit, under deterministic algorithms, the one-process step twice as
   the control); two ranks sharing the card over gloo (deterministic
   algorithms too): the data tier (2,
   1) at batch 4 and with 3 valid rows (2 + 1) against the one-process
   step in each rank (logits, loss within 1e-5, every gradient under the
   training gate, both ranks' parameters equal bit for bit), the spatial
   tier (1, 2) at batch 2 (the forward against the unsharded one under the
   forward gate, one step against the one-process step on the recompute
   route under the training gate, the stages the runner took, launches
   equal to ``expected_launches(runner=)``), the tiled image over the two
   data ranks bit for bit, and each rank's host-paced step ms (two ranks
   sharing one H100, not a scaling figure). Its kernels are filed under
   ``fused_swin_block[B5]``, ``swin_block_trainable_dynmask`` and
   ``swin_block_trainable_dynmask_bwd`` (launches: the spatial forward's
   and training step's), the scaled shard's under the ``[scaled]`` names.
12. Dropout, USE_CHECKPOINTS and the data tier (phase ``data``, after
   ``train``): ``Config()`` at 256x256, batch 4, with DROP_RATE =
   ATTN_DROP_RATE = 0.1: the fused step launches no block kernel (every
   block on eager autograd, as JAX routes a block with dropout) and the x4
   head's #5 and #9, and passes the training gate against float32 eager
   with the same generator seed, so the same masks; so does the step under
   USE_CHECKPOINTS, with the same loss bits and the generator in the same
   state after it; each dropout site runs in its dtype (the probabilities
   in float32) and keeps within KEEP_SIGMAS binomial sigmas of 0.9. At rates
   0 the step equals the step with the dropout machinery taken out, bit for
   bit, the generator draws only the drop-path scales, and under
   USE_CHECKPOINTS the block kernels' Functions run inside checkpoint (each
   block's forward launched twice) with the same loss bits and gradients
   within the strict gate; the memory a step adds with and without
   checkpointing. Then the data tier: ``data/synth.py`` -> ``python -m
   sunet_tf_tpu_torch.data.patches`` -> ``pack_pair_dataset`` (64 pairs of
   256x256), the DataLoader workers at 0 and 2 giving the same epoch bit
   for bit, and one epoch of ``Trainer.train_epoch`` through each variant
   of ``tools/train_io_bench.py`` (img/s, host-paced ms a step).

Prints a JSON line of per-kernel results (with the float64 readings of C2
and C4 under "float64"), then, as the last line,
``{"ok": true, "device": {...}}``. Any failed check raises (exit code != 0)
before that line; ``--phases`` runs a subset and then prints no result
lines. Needs one GPU; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# nvcc's log and the per-kernel JSON go beside the built library (git-ignored)
OUT_DIR = ROOT / "sunet_tf_tpu_torch" / "kernels" / "_build"

# Tolerance for a bf16 kernel against its plain version on unit-scale data:
# bf16 keeps 8 mantissa bits (one ulp of 1 is 0.0078) and the kernel sums
# in another order, so an element may differ by a few ulps where a rounding
# flips; on average the two agree to well under one ulp. The mean limit is
# about three times the largest single-block reading on the H100 (9.8e-5)
# and below what one wrong rounding point or the tanh form of GELU reads
# there (4.5e-4 and up; PERF.md).
MAX_TOL = 3e-2
MEAN_TOL = 3e-4
# A token whose attention row, in some head, has its top two logits closer
# than this share of the larger |q_i k_i| term of either key lies on a near
# tie: one bf16 rounding flip of q or k, in either version, may pick the
# other key. With logits of 1e4 and more the softmax is one-hot, and such a
# token may differ by the gap between two value rows.
NEAR_TIE = 2.0 ** -6
# The residual forward's rden against the row sums of its own eb, float32
# precision (check_res_state).
RES_DEN_TOL = 1e-5
SLICE_MEAN_TOL = 5e-3   # fused vs eager forward (the JAX bench.py gate)
# The block kernel's sequence form (#1 and #2 at windows of 256 tokens, head
# dim 30, QK scale 30^-0.5: the scaled config): its softmax is far from
# one-hot, so the MLP half turns the attention half's rounding flips into
# many more. Each half alone (the other branch's output weights zeroed)
# reads far under MEAN_TOL on the H100 (up to 3.0e-5 and 6.0e-6), and is
# held to it; the whole block reads up to 3.9e-4 at (64,64,360), where the
# plain version on the CPU against itself on the card (a reordering alone,
# chip_mutants.py's floor setting) reads 1.9e-4 (PERF.md). The whole block,
# and the chain's second block on the kernel's first, are held to
# SEQ_BLOCK_MEAN_TOL: about 2.5 times the largest sound reading.
SEQ_BLOCK_MEAN_TOL = 1e-3
# Fault C4 (ROADMAP): does #1's sequence form sit farther from the exact
# block than its plain version? Both read against the plain version run in
# float64 on float64 copies of the same bf16 draws (every rounding point
# gone): the kernel's mean |diff| to it over the plain version's must stay
# within C4_RATIO on every whole-block case of the scaled phases.
C4_RATIO = 1.5
# float64 readings of the run (C4's, C2's), filed into the result line
FLOAT64_READINGS: dict = {}
# The names the C=768 stage's training forms are filed under (the wrappers'
# counts by form: window_attention.SEQ64_FORM, BWD_WIDE_HEAD_FORM).
SEQ64 = "fused_swin_block[train64]"
WIDE_HEAD = "swin_block_bwd[wide_head]"
# The backward kernels against their plain versions. The two share every
# rounding point and sum the same bf16 products in another order, so they
# differ where a bf16 rounding flips; a backward passes ~7 such points (y,
# LN2(y), gelu(a), dab, dattn, dctx, dqkv) against the forward's ~5, and a
# flip early on moves everything after it. dx: max |diff| <= BWD_MAX_TOL *
# max(1, max|ref|), mean |diff| <= BWD_MEAN_TOL * max(1, mean|ref|); every
# float32 weight grad: mean |diff| <= GRAD_MEAN_TOL * mean |ref|. Sound
# readings on the H100 and the mutants' readings are in PERF.md.
BWD_MAX_TOL = 1e-1
BWD_MEAN_TOL = 2e-3
GRAD_MEAN_TOL = 1e-2
# A backward kernel whose dx mean limit is its own, by the same rule (twice
# the largest sound reading: the kernel and the plain version on the CPU,
# each against the plain version on the card, over many draws of inputs,
# ``chip_mutants.py --dx-draws``; PERF.md). The LN+W-MSA backward (#12) at
# C=768: 64 draws read up to 5.11e-3 (the kernel) and 4.18e-3 (the plain
# version on the CPU) of max(1, mean|ref|), where a near-one-hot softmax
# row at QK_SCALE 8 turns one bf16 rounding flip into a different key.
# The block backward above head dim 64 (#8 at the C=768 stage's head dim
# 96 and at C=384 with 2 heads, WIDE_HEAD), the same near-one-hot rows: 24
# draws of C768_CASES' logit-gain-1 cases read up to 1.0755e-2 (the kernel)
# and 9.14e-3 (the plain version on the CPU), both at one draw of (8,8,768);
# medians 1.1e-3 to 1.9e-3 (the kernel), 4.6e-4 to 9.2e-4 (the CPU).
DX_MEAN_TOL = {"ln_window_attention_bwd": 1.03e-2, WIDE_HEAD: 2.16e-2}


def dx_mean_tol(kernel: str) -> float:
    return DX_MEAN_TOL.get(kernel, BWD_MEAN_TOL)


# A backward kernel whose weight-gradient mean limit is its own, by the same
# rule over the same draws (``chip_mutants.py --dx-draws``, every grad read).
# WIDE_HEAD: 24 draws read up to 6.1253e-2 (the kernel) and 6.0998e-2 (the
# plain version on the CPU), both dln1_b at the draw of DX_MEAN_TOL's
# largest; medians 3.8e-3 to 4.7e-3 (the kernel), 1.6e-3 to 3.1e-3 (the
# CPU). Against float64 (``f64_grads_reading``, which every WIDE_HEAD case
# also passes) the kernel's distance was within 1.181 times the plain
# version's on every output of every draw (the CPU's too: 1.181).
GRAD_MEAN_TOLS = {WIDE_HEAD: 1.23e-1}


def grad_mean_tol(kernel: str) -> float:
    return GRAD_MEAN_TOLS.get(kernel, GRAD_MEAN_TOL)
# Training step: the fused routes and the eager route in bf16 are held
# against the eager route in float32 on the same weights, batch and
# drop-path draws. Loss relative difference <= TRAIN_LOSS_RTOL; per
# parameter tensor, cosine >= TRAIN_GRAD_COS and relative L2 <=
# TRAIN_GRAD_RL2, or, where a kernel-free eager bf16 route is farther from
# float32 than that, within GRAD_NOISE_FACTOR times the farthest of
# NOISE_ROUTES' own distances. The NOISE_ROUTES run no code of the fused
# route: the eager route (the XLA path's rounding) and the eager route with
# JAX's residual-route attention (ResAttention below: the rounding points
# of the JAX package's residual kernels, written here) in the blocks that
# the fused route trains on residuals, each also with the drop-path product
# in float32 (another place to round). bf16 compute alone moves the
# gradients of a freshly initialised model that far (the rel-pos bias
# tables most; PERF.md).
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_COS = 0.999
TRAIN_GRAD_RL2 = 5e-2
GRAD_NOISE_FACTOR = 2.0
# Fault C2 (ROADMAP): do the fused training routes' kernels move the
# gradients farther from exact than their plain versions do? The arbiter is
# the eager model in float64 (float64 parameters, every product in
# float64) on the same weights, batch and drop-path draws, over C2_DRAWS
# batches. Per stage (``grad_stage``) and route, the geometric mean over
# the stage's parameter tensors and the draws of (1 - cos) and of the
# relative L2 distance to float64; each fused route's must stay within
# C2_FACTOR times its plain route's (the same route with every wrapper's
# plain version in place of its kernel). A geometric mean cannot see one
# tensor's gradient scaled, which leaves its direction as it is: per stage
# also the largest over its tensors (of more than one value) of |s - s_plain|
# / rl2_plain, s a route's share of the exact gradient less one (g.g64 /
# |g64|^2 - 1, pooled over the draws), must stay within C2_SCALE_Z. On the
# H100 the sound routes read at most 0.35 (a rel-pos table of layers.3);
# the C=96 wqkv gradient scaled by 1.01 (chip_mutants.py) reads 1.87.
C2_DRAWS = 3
C2_FACTOR = 2.0
C2_SCALE_Z = 1.0
C2_ROUTES = ("fused", "fused_recompute")
NOISE_ROUTES = ("eager", "eager_dp32", "eager_res", "eager_res_dp32")
# A one-value parameter (a PReLU slope) has a gradient that is one
# cancelling sum, whose relative error moves with where the bf16 roundings
# upstream fall. ONE_VALUE_NOISE is the largest such error that
# chip_mutants.py's step setting read on the H100 over its bf16 rounding
# variants of the step (two runs each, every slope; PERF.md); a one-value
# gradient's relative L2 limit is GRAD_NOISE_FACTOR times that, far below
# what a dropped (1) or sign-flipped (2) slope gradient reads.
ONE_VALUE_NOISE = 0.2716
# Published peaks of one H100 SXM (NVIDIA data sheet, dense): bf16 tensor
# cores, float32 outside the tensor cores (the ALU-rate probe) and HBM3
# bandwidth; the bounds below are against these.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

WA = "sunet_tf_tpu/kernels/window_attention.py"
REPLACES = {
    "fused_swin_block": (f"{WA}:1582", "sunet_tf_tpu_torch/kernels/csrc/swin_cluster.cu"),
    "fused_swin_block_chain": (f"{WA}:1741", "sunet_tf_tpu_torch/kernels/csrc/swin_cluster.cu"),
    "fused_ln_window_attention": (f"{WA}:2742",
                                  "sunet_tf_tpu_torch/kernels/csrc/ln_window_attention.cu"),
    "fused_ln_mlp": (f"{WA}:1350", "sunet_tf_tpu_torch/kernels/csrc/ln_mlp.cu"),
    "fused_dual_upsample4_conv_phase": ("sunet_tf_tpu/kernels/upsample.py:589",
                                        "sunet_tf_tpu_torch/kernels/csrc/up4_conv.cu"),
    "swin_block_bwd": (f"{WA}:2031", "sunet_tf_tpu_torch/kernels/csrc/swin_block_bwd.cu"),
    # the C=768 stage's training forms: #1's train form on the sequence form
    # at 64-token windows, and #8 at a head dim above 64 (96 there)
    SEQ64: (f"{WA}:1582", "sunet_tf_tpu_torch/kernels/csrc/swin_block_seq.cu"),
    WIDE_HEAD: (f"{WA}:2031", "sunet_tf_tpu_torch/kernels/csrc/swin_block_bwd.cu"),
    "fused_swin_block_res": (f"{WA}:2315", "sunet_tf_tpu_torch/kernels/csrc/swin_cluster.cu"),
    "swin_block_bwd_res": (f"{WA}:2535",
                           "sunet_tf_tpu_torch/kernels/csrc/swin_block_bwd_res.cu"),
    "ln_window_attention_bwd": (f"{WA}:346", "sunet_tf_tpu_torch/kernels/csrc/ln_wmsa_bwd.cu"),
    "ln_mlp_branch": (f"{WA}:1481", "sunet_tf_tpu_torch/kernels/csrc/ln_mlp_branch.cu"),
    "ln_mlp_bwd": (f"{WA}:1523", "sunet_tf_tpu_torch/kernels/csrc/ln_mlp_bwd.cu"),
    "up4_conv_bwd": ("sunet_tf_tpu/kernels/upsample.py:939",
                     "sunet_tf_tpu_torch/kernels/csrc/up4_conv_bwd.cu"),
    "fused_dual_upsample4": ("sunet_tf_tpu/kernels/upsample.py:146",
                             "sunet_tf_tpu_torch/kernels/csrc/up4.cu"),
    "up4_bwd": ("sunet_tf_tpu/kernels/upsample.py:342",
                "sunet_tf_tpu_torch/kernels/csrc/up4_bwd.cu"),
    "wmsa_core": (f"{WA}:120", "sunet_tf_tpu_torch/kernels/csrc/window_attention.cu"),
    "alu_chain": ("tools/vpu_floor.py:68", "sunet_tf_tpu_torch/kernels/csrc/alu_floor.cu"),
    # the scaled config's geometry (WIN 16: 256 tokens a window, head dim 30,
    # C=180 not a multiple of 16): #1's and #2's sequence form, #3's
    # big-window attention, #4 at C=1440, #5 at C=180
    "fused_swin_block[scaled]": (f"{WA}:1582",
                                 "sunet_tf_tpu_torch/kernels/csrc/swin_block_seq.cu"),
    "fused_swin_block_chain[scaled]": (f"{WA}:1741",
                                       "sunet_tf_tpu_torch/kernels/csrc/swin_block_seq.cu"),
    "fused_ln_window_attention[scaled]": (f"{WA}:2742",
                                          "sunet_tf_tpu_torch/kernels/csrc/ln_window_attention.cu"),
    "fused_ln_mlp[scaled]": (f"{WA}:1350", "sunet_tf_tpu_torch/kernels/csrc/ln_mlp.cu"),
    "fused_dual_upsample4_conv_phase[scaled]": ("sunet_tf_tpu/kernels/upsample.py:589",
                                                "sunet_tf_tpu_torch/kernels/csrc/up4_conv.cu"),
    # its training step: #8's big-window form (csrc/block_bwd_big.cuh's
    # attention) up to C=720 and #9's wide form at C=180 (#1's train form is
    # filed under fused_swin_block[scaled])
    "swin_block_bwd[scaled]": (f"{WA}:2031", "sunet_tf_tpu_torch/kernels/csrc/swin_block_bwd.cu"),
    # the spatial tier's per-shard forms (B5): #1 at shift 0 with a shard's
    # slice of the SW-MSA mask (inference), its train form and #8 there
    # (JAX swin_block_trainable_dynmask and its backward)
    "fused_swin_block[B5]": (f"{WA}:1582", "sunet_tf_tpu_torch/kernels/csrc/swin_cluster.cu"),
    "swin_block_trainable_dynmask": (f"{WA}:2188",
                                     "sunet_tf_tpu_torch/kernels/csrc/swin_cluster.cu"),
    "swin_block_trainable_dynmask_bwd": (f"{WA}:2031",
                                         "sunet_tf_tpu_torch/kernels/csrc/swin_block_bwd.cu"),
    "up4_conv_bwd[scaled]": ("sunet_tf_tpu/kernels/upsample.py:939",
                             "sunet_tf_tpu_torch/kernels/csrc/up4_conv_bwd.cu"),
    # the float32 forms of the inference kernels (phase fp32; a float32
    # model's fused forward on the card): #1 and #2 in csrc/f32_swin_block.cu,
    # #3 and #4 in csrc/f32_block.cu, #5 in csrc/f32_up4.cu, the latter's
    # products on csrc/f32_tile.cuh
    "fused_swin_block[fp32]": (f"{WA}:1582",
                               "sunet_tf_tpu_torch/kernels/csrc/f32_swin_block.cu"),
    "fused_swin_block_chain[fp32]": (f"{WA}:1741",
                                     "sunet_tf_tpu_torch/kernels/csrc/f32_swin_block.cu"),
    "fused_ln_window_attention[fp32]": (f"{WA}:2742",
                                        "sunet_tf_tpu_torch/kernels/csrc/f32_block.cu"),
    "fused_ln_mlp[fp32]": (f"{WA}:1350", "sunet_tf_tpu_torch/kernels/csrc/f32_block.cu"),
    "fused_dual_upsample4_conv_phase[fp32]": ("sunet_tf_tpu/kernels/upsample.py:589",
                                              "sunet_tf_tpu_torch/kernels/csrc/f32_up4.cu"),
}
# The scaled phase files its cases and launches under a wrapper's name with
# this suffix.
SCALED = "[scaled]"
# ... and the fp32 phase its float32 forms' cases and launches with this one.
FP32 = "[fp32]"


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over the bf16 tensor-core peak and the bytes over the HBM rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def block_cost(B: int, H: int, C: int, ws: int = 8, blocks: int = 1, heads: int = 0,
               masked: bool = False, W: int = 0) -> dict:
    """One Swin block forward (kernels #1, #2) on an H x W map (W = H by
    default): products qkv, proj, fc1, fc2 and the two attention products;
    bytes: x in, out, bf16 weights, and with ``heads`` the float32 rel-pos
    bias (and the SW mask where ``masked``), which at 256 tokens a window
    are megabytes."""
    W = W or H
    T, N, hid = B * H * W, ws * ws, 4 * C
    flops = blocks * (2 * T * C * (4 * C + 2 * hid) + 4 * T * N * C)
    tables = blocks * heads * N * N * 4 + ((H // ws) * (W // ws) * N * N * 4 if masked else 0)
    return bound(flops, 2 * T * C * 2 + blocks * (4 * C * C + 2 * C * hid) * 2 + tables)


def block_bwd_cost(B: int, H: int, C: int, ws: int = 8, heads: int = 0,
                   masked: bool = False, W: int = 0) -> dict:
    """Backward of one block (#8, recompute form) on an H x W map (W = H by
    default): the forward recomputed up to the fc1 pre-activation, then two
    products per forward product (the input and weight grads) and four
    attention products; bytes: x and dout in, dx out, bf16 weights in,
    float32 grads out, and with ``heads`` the float32 rel-pos bias read and
    its gradient written (and the SW mask where ``masked``), megabytes at
    256 tokens a window."""
    W = W or H
    T, N, hid = B * H * W, ws * ws, 4 * C
    recompute = 2 * T * C * (4 * C + hid) + 4 * T * N * C
    backward = 2 * 2 * T * C * (4 * C + 2 * hid) + 8 * T * N * C
    w = 4 * C * C + 2 * C * hid
    tables = 2 * heads * N * N * 4 + ((H // ws) * (W // ws) * N * N * 4 if masked else 0)
    return bound(recompute + backward, 3 * T * C * 2 + w * 2 + w * 4 + tables)


def res_bytes(B: int, H: int, C: int, ws: int = 8, heads: int = 8) -> int:
    """Bytes of the residual route's stored state: eb (bf16, one N x N map
    per head and window), rden and ctx_f (float32)."""
    T, N = B * H * H, ws * ws
    nwin = T // N
    return nwin * heads * N * N * 2 + nwin * heads * N * 4 + T * C * 4


def block_res_cost(B: int, H: int, C: int, ws: int = 8, heads: int = 8) -> dict:
    """The residual route's block forward (#6): #1's operations and bytes
    plus the stored state written."""
    c = block_cost(B, H, C, ws)
    return bound(c["flops"], c["bytes"] + res_bytes(B, H, C, ws, heads))


def block_bwd_res_cost(B: int, H: int, C: int, ws: int = 8, heads: int = 8) -> dict:
    """Backward of one block from the residuals (#7): #8's operations
    without the score product and the attention recompute (LN1 and qkv,
    proj and fc1 are recomputed); bytes: #8's plus the stored state read."""
    T, N, hid = B * H * H, ws * ws, 4 * C
    recompute = 2 * T * C * (4 * C + hid)
    backward = 2 * 2 * T * C * (4 * C + 2 * hid) + 8 * T * N * C
    c = block_bwd_cost(B, H, C, ws)
    return bound(recompute + backward, c["bytes"] + res_bytes(B, H, C, ws, heads))


def ln_wmsa_bwd_cost(B: int, H: int, C: int, ws: int = 8, heads: int = 8,
                     masked: bool = False) -> dict:
    """Backward of the LN+W-MSA sublayer (#12): qkv and the two attention
    products recomputed, then dwproj, dctx, the four attention products,
    dwqkv and du; bytes: x and dout in, dx out, bf16 wqkv/wproj and the
    float32 LN, bias and rel-pos (and mask) inputs in, float32 grads out."""
    T, N = B * H * H, ws * ws
    flops = 2 * T * C * 3 * C * 3 + 2 * T * C * C * 2 + 12 * T * N * C
    small = (2 * C + 3 * C + heads * N * N) * 4
    mask = (H // ws) ** 2 * N * N * 4 if masked else 0
    return bound(flops, 3 * T * C * 2 + 4 * C * C * 2 + small + mask
                 + (4 * C * C + 6 * C + heads * N * N) * 4)


def ln_mlp_branch_cost(B: int, H: int, C: int) -> dict:
    """LN+MLP branch forward (#13): fc1 and fc2; bytes: y in, out, bf16
    weights, float32 LN and biases."""
    T, hid = B * H * H, 4 * C
    return bound(4 * T * C * hid, 2 * T * C * 2 + 2 * C * hid * 2 + (3 * C + hid) * 4)


def ln_mlp_bwd_cost(B: int, H: int, C: int) -> dict:
    """Backward of the LN+MLP branch (#14): fc1 recomputed, then dw2, da, dw1
    and dyn; bytes: y and dout in, dy out, bf16 w1/w2 and the float32 LN and
    b1 in, float32 grads out."""
    T, hid = B * H * H, 4 * C
    return bound(10 * T * C * hid, 3 * T * C * 2 + 2 * C * hid * 2 + (2 * C + hid) * 4
                 + (2 * C * hid + 3 * C + hid) * 4)


def up4_cost(B: int, H: int, C: int, out: int, W: int = None) -> dict:
    """x4 head + conv forward (#5), per low-res pixel: 34 C^2 multiply-adds
    of the head, 144 C*out of the conv; bytes: x in, phase map out, bf16
    weights. W defaults to H."""
    M = B * H * (W or H)
    return bound(M * (68 * C * C + 288 * C * out),
                 M * C * 2 + M * 16 * out * 2 + 19 * C * C * 2)


def up4_bwd_cost(B: int, H: int, C: int, out: int, W: int = None) -> dict:
    """Backward of the head + conv (#9): the head recomputed, two products
    per head product, the conv's input and per-slot weight grads; bytes: x
    and dout in, dx out, bf16 weights in, float32 grads out (the conv's
    (3, 3, C, out)). W defaults to H."""
    M = B * H * (W or H)
    return bound(M * (3 * 68 * C * C + (288 + 1152) * C * out),
                 2 * M * C * 2 + M * 16 * out * 2 + 19 * C * C * 2
                 + (19 * C * C + 9 * C * out + C + 2) * 4)


def up4_split_cost(B: int, H: int, W: int, C: int) -> dict:
    """The split x4 head (#10), per low-res pixel: #5's 34 C^2
    multiply-adds of the head; bytes: x in, the (B, 4H, 4W, C) map out, bf16
    weights."""
    M = B * H * W
    return bound(M * 68 * C * C, M * C * 2 + 16 * M * C * 2 + 19 * C * C * 2)


def up4_split_bwd_cost(B: int, H: int, W: int, C: int) -> dict:
    """Backward of the split head (#11), per low-res pixel: the expand and
    the bilinear 1x1 recomputed (17 C^2 multiply-adds), then two products
    per head product except the bilinear projection's recompute (68 C^2):
    85 C^2; bytes: x and the pixel-space dout in, dx out, bf16 weights in,
    float32 grads out."""
    M = B * H * W
    return bound(M * 170 * C * C, 2 * M * C * 2 + 16 * M * C * 2 + 19 * C * C * 2
                 + (19 * C * C + C + 2) * 4)


def ln_wmsa_cost(B: int, H: int, C: int, ws: int = 8, heads: int = 8,
                 masked: bool = False) -> dict:
    """LN + W-MSA (#3): #15's operations and bytes and the float32 LN
    scale and bias."""
    c = wmsa_cost(B, H, C, ws, heads, masked)
    return bound(c["flops"], c["bytes"] + 2 * C * 4)


def wmsa_cost(B: int, H: int, C: int, ws: int = 8, heads: int = 8,
              masked: bool = False) -> dict:
    """W-MSA over windows (#15): qkv and the projection, the two attention
    products; bytes: x in, out, bf16 wqkv/wproj, the float32 biases,
    rel-pos bias (and mask)."""
    T, N = B * H * H, ws * ws
    mask = (H // ws) ** 2 * N * N * 4 if masked else 0
    return bound(2 * T * C * 4 * C + 4 * T * N * C,
                 2 * T * C * 2 + 4 * C * C * 2 + (4 * C + heads * N * N) * 4 + mask)


# Instructions per element and step of each chain of the ALU-rate probe
# (#16), per pipe, as the card's compiler builds csrc/alu_floor.cu (read
# with ``python -m sunet_tf_tpu_torch.tools.alu_floor --sass``: cuobjdump
# of the built library, the main unrolled loop of each chain over its
# steps; PERF.md), and each pipe's results per SM and clock
# (``alu_floor.PIPE_RATES``, compute capability 9.0): fma 1 FFMA; exp 7
# FP32, 1.5 ALU (the loop counter over 4 steps among them), 1 MUFU.EX2;
# tanh 10 FP32, 4.5 ALU, 2 MUFU (EX2 and RCP; both of tanhf's branches are
# computed and one selected); gelu 17 FP32, 4.5 ALU, 2 MUFU. The entries
# phase reads them again from this run's build and fails if they moved.
ALU_OPS = {"fma": {"fp32": 1.0, "alu": 0.125, "mufu": 0.0},
           "exp": {"fp32": 7.0, "alu": 1.5, "mufu": 1.0},
           "tanh": {"fp32": 10.0, "alu": 4.5, "mufu": 2.0},
           "gelu": {"fp32": 17.0, "alu": 4.5, "mufu": 2.0}}
H100_SMS = 132
# The clock at which the FP32 pipes give PEAK_FP32_FLOPS (128 FMA lanes per
# SM, 2 operations each): 1.98 GHz.
H100_CLOCK = PEAK_FP32_FLOPS / (H100_SMS * 128 * 2)


def alu_cost(op: str, n: int, steps: int) -> dict:
    """One launch of the probe's chain over n float32 values: per element
    and step, each pipe's instructions (ALU_OPS) over its rate per SM and
    clock, the largest, over the card's SMs at H100_CLOCK; and 8 bytes per
    value."""
    from sunet_tf_tpu_torch.tools.alu_floor import PIPE_RATES

    c = ALU_OPS[op]
    clocks = max(c[p] / rate for p, rate in PIPE_RATES.items())
    t_ops = n * steps * clocks / (H100_SMS * H100_CLOCK) * 1e3
    nbytes = 8 * n
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    pipe = max(PIPE_RATES, key=lambda p: c[p] / PIPE_RATES[p])
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "pipe": pipe, "flops": 2 * n * steps * c["fp32"], "bytes": nbytes}


def grad_distance(a, b) -> tuple:
    """(cosine, relative L2) of a gradient ``a`` against the float32 one ``b``
    (flat float64 tensors)."""
    return (float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300)),
            float((a - b).norm() / b.norm()))


def grad_limits(numel: int, noise: tuple = None) -> tuple:
    """(cosine, relative L2) limits of the training gate for a gradient
    tensor of ``numel`` values; ``noise``: the (cos, rl2) of the farthest
    NOISE_ROUTES route for it, which widens them where it is farther."""
    cos_lim, rl2_lim = TRAIN_GRAD_COS, TRAIN_GRAD_RL2
    if numel == 1:
        rl2_lim = GRAD_NOISE_FACTOR * ONE_VALUE_NOISE
    if noise is not None:
        ce, re = noise
        cos_lim = min(cos_lim, 1.0 - GRAD_NOISE_FACTOR * (1.0 - ce))
        rl2_lim = max(rl2_lim, GRAD_NOISE_FACTOR * re)
    return cos_lim, rl2_lim


def gate_share(cos: float, rl2: float, cos_lim: float, rl2_lim: float) -> float:
    """How much of its gate limits a reading uses (> 1: beyond them)."""
    return max(rl2 / rl2_lim, (1 - cos) / max(1 - cos_lim, 1e-12))


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, iters: int = 20, warmup: int = 3, device: bool = True) -> float:
    """Median time of ``fn`` over ``iters`` CUDA-event-timed calls. With
    ``device`` the card first spins (``torch.cuda._sleep``) for longer than
    the host takes to enqueue every call, so the events time the device's
    work and not the host's pace of launches; without it they time both, as
    a caller who waits on each call sees them."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if device:
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        # about 2e9 cycles per second, twice the host's time to enqueue them all
        torch.cuda._sleep(int(min(2.0, 2 * (iters + 1) * host_s) * 2e9))
    evs = []
    for _ in range(iters):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


def compare(name: str, got, ref, near_tie=None, max_tol: float = MAX_TOL,
            mean_tol: float = MEAN_TOL) -> tuple:
    """Hold a kernel's output against its plain version; ``near_tie`` (a
    (B, H, W) bool map) leaves those tokens out of the tolerances, and then
    every token beyond the max tolerance must lie on a near tie."""
    import torch

    torch.cuda.synchronize()
    g, r = got.float(), ref.float()
    check(bool(torch.isfinite(g).all()), f"{name}: non-finite kernel output")
    d = (g - r).abs()
    mx, mean = float(d.max()), float(d.mean())
    tol_max = max_tol * max(1.0, float(r.abs().max()))
    tol_mean = mean_tol * max(1.0, float(r.abs().mean()))
    line = (f"  {name}: max|diff| {mx:.3e} (tol {tol_max:.3e}) mean|diff| {mean:.3e} "
            f"(tol {tol_mean:.3e}) max|ref| {float(r.abs().max()):.3e}")
    if near_tie is None:
        ok = mx <= tol_max and mean <= tol_mean
    else:
        beyond = (d > tol_max).any(-1)
        off = ~near_tie
        unexplained = int((beyond & off).sum())
        mx_off, mean_off = float(d[off].max()), float(d[off].mean())
        ok = mx_off <= tol_max and mean_off <= tol_mean and unexplained == 0
        line += (f"; near-tie tokens {float(near_tie.float().mean()):.3e} of all; "
                 f"tokens beyond max tol {int(beyond.sum())}, {unexplained} of them "
                 f"off near ties; off near ties max|diff| {mx_off:.3e} "
                 f"mean|diff| {mean_off:.3e}")
    print(f"{line} {'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: kernel disagrees with its plain version")
    return mx, mean


def _plain_qk(x, p, mask, *, ws: int, heads: int, scale: float, shift: int) -> tuple:
    """round(q*scale), k and v per (window, head) (Bn, h, N, d) and the
    logits (Bn, h, N, N), float32, computed as the plain version computes
    them."""
    import torch

    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.ops.window import roll2d, window_partition

    B, H, W, C = x.shape
    d = C // heads
    with wa.exact_fp32():
        xn = wa.ln32(roll2d(x, -shift), *p[0:2]).to(torch.bfloat16)
        qkv = (wa.mm32(window_partition(xn, ws), p[2]) + p[3]).to(torch.bfloat16)
        Bn, N, _ = qkv.shape
        split = lambda t: t.float().reshape(Bn, N, heads, d).transpose(1, 2)
        q = split((qkv[..., :C].float() * scale).to(torch.bfloat16))
        k = split(qkv[..., C:2 * C])
        s = q @ k.transpose(-1, -2) + p[12].float()
        if mask is not None:
            nW = mask.shape[0]
            s = (s.reshape(Bn // nW, nW, heads, N, N) + mask[None, :, None]).reshape(
                Bn, heads, N, N)
    return q, k, split(qkv[..., 2 * C:]), s


def near_tie_tokens(x, p, mask, *, ws: int, heads: int, scale: float, shift: int):
    """((B, H, W) bool, max |logit|): the tokens whose attention row, in
    some head, has its top two logits within NEAR_TIE of the larger |q_i
    k_i| term of either key, with q, k and the logits computed as the plain
    version computes them."""
    import torch

    from sunet_tf_tpu_torch.ops.window import roll2d, window_reverse

    B, H, W, C = x.shape
    d = C // heads
    q, k, _, s = _plain_qk(x, p, mask, ws=ws, heads=heads, scale=scale, shift=shift)
    top, idx = s.topk(2, dim=-1)
    # largest |q_i k_i| term against each of the two top keys
    term = lambda j: (q.abs() * k.abs().gather(
        2, idx[..., j:j + 1].expand(-1, -1, -1, d))).amax(-1)
    tie = (top[..., 0] - top[..., 1]) < NEAR_TIE * (term(0) + term(1))
    tie = tie.any(1).float()[..., None]                       # (Bn, N, 1)
    tie = roll2d(window_reverse(tie, ws, H, W), shift)[..., 0] > 0.5
    return tie, float(s.abs().max())


def check_res_state(name: str, got: tuple, ref: tuple, x, p, mask, *, ws: int, heads: int,
                    scale: float, shift: int):
    """Hold the residual route's stored state (eb, rden, ctx_f) against the
    plain version's. Against the plain state: mean |diff| <= MEAN_TOL *
    max(1, mean|ref|); the largest differences are printed but are no limit,
    since the two round the same float32 products summed in other orders
    and a q or k element near a bf16 rounding boundary may round either way,
    which at QK_SCALE 8 moves single exponentials by up to ~10%. Elementwise,
    through relations that no such flip changes: every (window, head, row)
    of eb has its largest value exactly 1 (the per-head row max) and none
    outside [0, 1]; rden * sum_j eb of the kernel's own eb is 1 within
    RES_DEN_TOL (the JAX rounding point: the sum of the rounded
    exponentials); ctx_f equals (eb @ v) * rden of the kernel's own eb and
    rden and the plain version's v (whose own flips move it by one bf16 ulp
    at most), under the forward limits."""
    import torch

    from sunet_tf_tpu_torch.kernels import window_attention as wa

    torch.cuda.synchronize()
    for lab, g, r in zip(("eb", "rden", "ctx_f"), got, ref):
        g, r = g.double(), r.double()
        check(bool(torch.isfinite(g).all()), f"{name} {lab}: non-finite kernel output")
        d = (g - r).abs()
        mean, tol = float(d.mean()), MEAN_TOL * max(1.0, float(r.abs().mean()))
        beyond = int((d > MAX_TOL * max(1.0, float(r.abs().max()))).sum())
        print(f"  {name} {lab} vs plain: mean|diff| {mean:.3e} (tol {tol:.3e}); max|diff| "
              f"{float(d.max()):.3e}, {beyond} of {d.numel()} elements beyond {MAX_TOL:g} * "
              f"max(1, max|ref|) (no limit) {'ok' if mean <= tol else 'FAIL'}")
        check(mean <= tol, f"{name} {lab}: stored state disagrees with its plain version")
    eb, rden, ctx = got
    ebf = eb.float()
    top = ebf.amax(-1)
    print(f"  {name} eb: row maxima in [{float(top.min())}, {float(top.max())}], values in "
          f"[{float(ebf.min())}, {float(ebf.max())}]")
    check(bool((top == 1).all()) and float(ebf.min()) >= 0,
          f"{name} eb: a row's largest exponential is not exactly 1")
    # rden * sum(eb) of the kernel's own eb is 1 up to the float32 sum of N
    # values in [0, 1] (at most (N - 1) * 2^-24 relative, 3.8e-6 at N = 64)
    # and the reciprocal's rounding: no bf16 flip moves it, and a row sum
    # over the unrounded exponentials would be off by their roundings
    unit = float((rden.double() * ebf.double().sum(-1) - 1).abs().max())
    print(f"  {name} rden * sum(eb): largest |diff| from 1 {unit:.3e} (tol {RES_DEN_TOL:g}) "
          f"{'ok' if unit <= RES_DEN_TOL else 'FAIL'}")
    check(unit <= RES_DEN_TOL, f"{name} rden: not the reciprocal of the rounded row sum")
    _, _, v, _ = _plain_qk(x, p, mask, ws=ws, heads=heads, scale=scale, shift=shift)
    Bn, h, N, d = v.shape
    with wa.exact_fp32():
        num = ebf @ v
    compare(f"{name} ctx_f vs (eb @ v) * rden", ctx,
            (num * rden[..., None]).transpose(1, 2).reshape(Bn * N, h * d))


def block_params(C: int, heads: int, N: int, gen, *, qkv_gain: float = 1.0):
    import torch

    dev = "cuda"
    n = lambda *s: torch.randn(*s, device=dev, generator=gen)
    w = lambda i, o, g=1.0: (n(i, o) * (g / i ** 0.5)).to(torch.bfloat16)
    hid = 4 * C
    return (1 + 0.1 * n(C), 0.1 * n(C), w(C, 3 * C, qkv_gain), 0.1 * n(3 * C),
            w(C, C), 0.1 * n(C), 1 + 0.1 * n(C), 0.1 * n(C), w(C, hid),
            0.1 * n(hid), w(hid, C), 0.1 * n(C), n(heads, N, N))


def record_time(results: dict, name: str, case: str, got_fn, plain_fn, cost: dict,
                mx: float, mean: float, library_fn=None):
    """Time a kernel, its plain version and, where one PyTorch call computes
    the same function, that call ``library_fn`` (CUDA events, medians) and
    file the case with its bound under ``name``."""
    ms, plain_ms = time_ms(got_fn), time_ms(plain_fn)
    library_ms = None if library_fn is None else time_ms(library_fn)
    print(f"    time {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
          + ("" if library_ms is None else f"{library_ms:.4f} ms library, ")
          + f"bound {cost['bound_ms']:.4f} ms ({cost['bound_by']})")
    file_case(results, name, {"case": case, "max_abs_err": mx, "mean_abs_err": mean,
                              "ms": ms, "plain_ms": plain_ms, "bound_ms": cost["bound_ms"],
                              "bound_by": cost["bound_by"], "library_ms": library_ms})


def file_case(results: dict, name: str, case: dict):
    r = results.setdefault(name, {"max_abs_err": 0.0, "cases": []})
    r["max_abs_err"] = max(r["max_abs_err"], case["max_abs_err"])
    r["cases"].append(case)


def compare_grads(name: str, got: tuple, ref: tuple, labels: tuple) -> tuple:
    """dx (got[0]) under the backward limits, every other (float32) grad
    under mean |diff| <= GRAD_MEAN_TOL * mean |ref|; returns dx's (max,
    mean)."""
    import torch

    mx, mean = compare(f"{name} dx", got[0], ref[0], max_tol=BWD_MAX_TOL,
                       mean_tol=dx_mean_tol(name.split()[0]))
    bad = []
    rels = {}
    tol = grad_mean_tol(name.split()[0])
    for lab, g, r in zip(labels, got[1:], ref[1:]):
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite {lab}")
        rels[lab] = float((g - r).abs().mean()) / max(float(r.abs().mean()), 1e-30)
        if rels[lab] > tol:
            bad.append(f"{lab} {rels[lab]:.3e}")
    print(f"  {name} weight grads mean|diff|/mean|ref| (tol {tol:g}): "
          + " ".join(f"{k} {v:.2e}" for k, v in rels.items())
          + (" ok" if not bad else " FAIL " + ", ".join(bad)))
    check(not bad, f"{name}: weight grads disagree with the plain version: {bad}")
    return mx, mean


BLOCK_GRADS = ("dln1_g", "dln1_b", "dwqkv", "dbqkv", "dwproj", "dbproj", "dln2_g",
               "dln2_b", "dw1", "db1", "dw2", "db2", "dbias")
WMSA_GRADS = ("dln_g", "dln_b", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias")
MLP_GRADS = ("dln_g", "dln_b", "dw1", "db1", "dw2", "db2")
UP4_GRADS = ("dw_exp", "dalpha_p", "dw_b1", "db_b1", "dalpha_b", "dwpf", "dwbf", "dwconv")
UP4_SPLIT_GRADS = UP4_GRADS[:-1]


def sublayer_cases(gen, B: int = 2, ws: int = 8, heads: int = 8, scale: float = 8.0,
                   gain: float = 1.0) -> list:
    """The C=768 training sublayers' cases, (name, case, kernel wrapper,
    plain version, args, kwargs, cost, grad labels or None for a forward):
    #13 and #14 at the default bottleneck (8,8,768), #12 there and on a
    shifted, masked (16,16,768) map, #13 also on that map. ``gain`` scales
    the qkv weights."""
    import torch

    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.ops.window import shift_attn_mask

    C, N = 768, ws * ws
    cases = []
    for H, shift in ((8, 0), (16, 4)):
        p = block_params(C, heads, N, gen, qkv_gain=gain)
        x = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
        dout = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
        mask = (torch.as_tensor(shift_attn_mask(H, H, ws, shift), device="cuda")
                if shift else None)
        case = f"({H},{H},{C}) shift {shift}"
        mlp = (p[6:8], p[8], p[9], p[10])
        cases.append(("ln_mlp_branch", f"({H},{H},{C})", wa.ln_mlp_branch,
                      wa.ln_mlp_branch_reference,
                      (x, *mlp, p[11]), {}, ln_mlp_branch_cost(B, H, C), None))
        if shift == 0:
            cases.append(("ln_mlp_bwd", case, wa.ln_mlp_bwd, wa.ln_mlp_bwd_reference,
                          (x, dout, *mlp), {}, ln_mlp_bwd_cost(B, H, C), MLP_GRADS))
        cases.append(("ln_window_attention_bwd", case, wa.ln_window_attention_bwd,
                      wa.ln_window_attention_bwd_reference, (x, dout, *p[0:5], p[12], mask),
                      dict(ws=ws, num_heads=heads, scale=scale),
                      ln_wmsa_bwd_cost(B, H, C, ws, heads, masked=shift > 0), WMSA_GRADS))
    return cases


# The C=768 stage's training forms (JAX's default training route there):
# #1's train form on the sequence form at 64-token windows (filed under
# SEQ64) and #8 at a head dim above 64 (WIDE_HEAD), at C768_CASES' shapes:
# (batch, H, C, heads, shift, qkv gain, the sequence form's K splits of qkv,
# proj, fc1, fc2). The default bottleneck at the training step's batch; a
# shifted, masked 16 x 16 map (the stage at 512x512); that map with logits
# at ~1e4 (trained QK_SCALE=8 weights reach them; near ties left out of the
# forward's limits); C=384 with 2 heads (head dim 192), the block within the
# cluster kernel's cap that it refuses.
C768_CASES = ((4, 8, 768, 8, 0, 1.0, (1, 4, 1, 4)), (2, 16, 768, 8, 4, 1.0, (1, 1, 1, 4)),
              (2, 16, 768, 8, 4, 6.0, (1, 1, 1, 4)), (2, 16, 384, 2, 4, 1.0, (1, 2, 1, 2)))


def c768_train_cases(gen) -> list:
    """The cases of C768_CASES, each with its launch plans asserted, as
    dicts of the name they are filed under, the wrapper's ``counter``,
    ``case``, the kernel wrapper ``fn``, its ``plain`` version, ``args``,
    ``kw``, ``cost``, the grads' labels (None for a forward), the mean
    limit, the near-tie tokens (``tie``, None below logit gain 1), the
    launches of one call, whether it is timed, ``f64``: held by
    :func:`f64_grads_reading` alone (#8 at ~1e4 logits; every other
    backward case by it and by the backward limits), and ``sub``: the
    sublayer route's kernels for the same block (#3 + #13 beside a forward,
    #12 + #14 beside a backward; the route the stage took before), timed
    beside it. A forward at gain 1 is checked per residual branch under the
    forward limits and as a whole block under SEQ_BLOCK_MEAN_TOL (as the
    scaled config's sequence form)."""
    import torch

    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.ops.window import roll2d, shift_attn_mask

    ws, scale, N = 8, 8.0, 64
    cases = []
    for B, H, C, heads, shift, gain, splits in C768_CASES:
        hid = 4 * C
        plan = wa.block_seq_plan(H, H, C, hid, ws, heads, train=True)
        check((plan["ksq"], plan["ksp"], plan["ks1"], plan["ks2"]) == splits
              and plan["Kp"] == C, f"{SEQ64} ({H},{H},{C}): plan {plan}, expected {splits}")
        bplan = wa.block_bwd_plan(H, H, C, hid, ws, heads)
        check(max(bplan["smem"].values()) <= wa.SMEM_MAX and bplan["G"] == -(-C // 128),
              f"{WIDE_HEAD} ({H},{H},{C}): plan {bplan}")
        p = block_params(C, heads, N, gen, qkv_gain=gain)
        x = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
        dout = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
        dp = torch.tensor([[1 / 0.9, 1 / 0.9], [1 / 0.9, 0.0], [0.0, 1 / 0.9],
                           [1 / 0.9, 1 / 0.9]][:B], device="cuda")
        mask = (torch.as_tensor(shift_attn_mask(H, H, ws, shift), device="cuda")
                if shift else None)
        kw = dict(ws=ws, num_heads=heads, scale=scale, shift=shift)
        case = (f"batch {B} ({H},{H},{C}) shift {shift}, {heads} heads (head dim {C // heads})"
                + (f", qkv x{gain:g}" if gain != 1 else ""))
        tie = None
        if gain != 1:
            tie, logit = near_tie_tokens(x, p, mask, ws=ws, heads=heads, scale=scale,
                                         shift=shift)
            print(f"  {case}: max |logit| {logit:.3e}")
            case += f" (max |logit| {logit:.1e})"
        xr = roll2d(x, -shift)
        sub_fwd = lambda xr=xr, x=x, p=p, mask=mask, kw=kw: (
            wa.fused_ln_window_attention(xr, *p[0:6], p[12], mask, ws=ws,
                                         num_heads=kw["num_heads"], scale=scale),
            wa.ln_mlp_branch(x, p[6:8], p[8], p[9], p[10], p[11]))
        sub_bwd = lambda xr=xr, x=x, dout=dout, p=p, mask=mask, kw=kw: (
            wa.ln_window_attention_bwd(xr, dout, *p[0:5], p[12], mask, ws=ws,
                                       num_heads=kw["num_heads"], scale=scale),
            wa.ln_mlp_bwd(x, dout, p[6:8], p[8], p[9], p[10]))
        halves = seq_halves(p) if gain == 1 else {"block": p}
        for half, q in halves.items():
            cases.append(dict(
                f64=False, name=SEQ64, counter="fused_swin_block", case=f"{case}, {half}"
                + (f", splits {splits}" if half == "block" else ""),
                fn=wa.fused_swin_block, plain=wa.fused_swin_block_reference,
                args=(x, q[0:2], q[2], q[3], q[4], q[5], q[6:8], q[8], q[9], q[10], q[11],
                      q[12], mask, dp), kw=kw,
                cost=block_cost(B, H, C, ws, heads=heads, masked=shift > 0), grads=None,
                mean_tol=SEQ_BLOCK_MEAN_TOL if half == "block" else MEAN_TOL, tie=tie,
                launches=wa.SWIN_BLOCK_SEQ_LAUNCHES, timed=half == "block", sub=sub_fwd))
        cases.append(dict(
            name=WIDE_HEAD, counter="swin_block_bwd",
            case=f"{case}, {bplan['chunk_tokens']} tokens per chunk", fn=wa.swin_block_bwd,
            plain=wa.swin_block_bwd_reference,
            args=(x, dout, p[0:2], *p[2:6], p[6:8], *p[8:12], p[12], mask, dp), kw=kw,
            cost=block_bwd_cost(B, H, C, ws, heads=heads, masked=shift > 0), grads=BLOCK_GRADS,
            mean_tol=None, tie=None, launches=wa.SWIN_BLOCK_BWD_LAUNCHES, timed=True,
            sub=sub_bwd, f64=gain != 1))
    return cases


def f64_grads_reading(label: str, got: tuple, ref: tuple, plain, args: tuple, kw: dict,
                      labels: tuple) -> tuple:
    """A backward held by float64, as C4 holds the sequence form. At QK
    scale 8 a softmax row is near one-hot, and one bf16 rounding flip of q
    or k at a near tie moves a whole row's dq and its keys' dk, dv, in the
    plain version as in the kernel: at logits of ~1e4 (a quarter of the
    rows on near ties) by up to a fifth of max |dx|, so that no
    elementwise limit against the plain version holds, and at logit gain 1
    enough to widen the elementwise readings (WIDE_HEAD's limits), where
    this reading stays sharp. Per output (dx and every grad): mean |kernel - f64|
    and mean |plain - f64|, f64 the plain version on float64 copies of the
    arguments (no rounding point, no flip); the kernel's within C4_RATIO of
    the plain version's. Returns dx's (max, mean) |kernel - plain|."""
    import torch

    torch.cuda.synchronize()
    with torch.no_grad():
        f64 = plain(*float64_copy(args), **kw)
    ratios = {}
    for lab, g, r, e in zip(("dx",) + labels, got, ref, f64):
        check(bool(torch.isfinite(g).all()), f"{label}: non-finite {lab}")
        k = float((g.double() - e).abs().mean())
        pl = float((r.double() - e).abs().mean())
        ratios[lab] = (k, pl, k / max(pl, 1e-300))
    worst = max(ratios, key=lambda n: ratios[n][2])
    print(f"  {label} vs float64: mean |kernel - f64| / mean |plain - f64| per output: "
          + " ".join(f"{n} {v[2]:.3f}" for n, v in ratios.items())
          + f"; largest {worst} {ratios[worst][2]:.3f} (limit {C4_RATIO})")
    FLOAT64_READINGS.setdefault("c768", []).append(
        {"case": label, **{n: {"kernel_vs_f64": v[0], "plain_vs_f64": v[1], "ratio": v[2]}
                           for n, v in ratios.items()}})
    check(ratios[worst][2] <= C4_RATIO, f"{label}: {worst} sits {ratios[worst][2]:.3f} times as "
          f"far from float64 as its plain version's (C4_RATIO {C4_RATIO})")
    d = (got[0].float() - ref[0].float()).abs()
    return float(d.max()), float(d.mean())


def c768_kernel_checks(results: dict):
    """C768_CASES against their plain versions: forwards under the forward
    limits (near ties left out at logit gain 6), backwards against float64
    (:func:`f64_grads_reading`) and, but at logit gain 6, under the
    backward limits (WIDE_HEAD's own), two runs bit for bit; launches per
    call, by the wrapper and by the form; each timed case filed with its
    bound and the sublayer route's time for the same block."""
    import torch

    from sunet_tf_tpu_torch.kernels import window_attention as wa

    check(wa.SEQ64_FORM == SEQ64 and wa.BWD_WIDE_HEAD_FORM == WIDE_HEAD,
          "the form counters' names differ from chip_smoke's")
    print("phase: the C=768 stage's training forms (#1's train form at 64 tokens, #8 above "
          "head dim 64) vs plain versions (bf16)")
    for c in c768_train_cases(torch.Generator(device="cuda").manual_seed(4327)):
        got = lambda: c["fn"](*c["args"], **c["kw"])
        ref = lambda: c["plain"](*c["args"], **c["kw"])
        label = f"{c['name']} {c['case']}"
        if c["grads"] is None:
            mx, mean = compare(label, got(), ref(), c["tie"], mean_tol=c["mean_tol"])
        else:
            g, r = got(), ref()
            mx, mean = f64_grads_reading(label, g, r, c["plain"], c["args"], c["kw"],
                                         c["grads"])
            if not c["f64"]:
                mx, mean = compare_grads(label, g, r, c["grads"])
            check(all(torch.equal(a, b) for a, b in zip(g, got())),
                  f"{label}: two runs differ (the reductions must be deterministic)")
        if c["timed"]:
            launches_per_call(c["counter"], got, c["launches"])
            launches_per_call(c["name"], got, c["launches"])
            record_time(results, c["name"], c["case"], got, ref, c["cost"], mx, mean)
            sub_ms = time_ms(c["sub"])
            results[c["name"]]["cases"][-1]["sublayer_ms"] = sub_ms
            print(f"    the sublayer route's kernels for the same block ("
                  + ("#3 + #13" if c["grads"] is None else "#12 + #14")
                  + f"): {sub_ms:.4f} ms")


def launches_per_call(name: str, fn, want: int):
    """One call of ``fn`` launches ``want`` kernels of wrapper ``name``."""
    import torch

    from sunet_tf_tpu_torch.kernels import _build

    torch.cuda.synchronize()
    before = _build.counter(name).cuda
    fn()
    got = _build.counter(name).cuda - before
    print(f"    launches per call {got} (the wrapper's constant {want}) "
          f"{'ok' if got == want else 'FAIL'}")
    check(got == want, f"{name}: {got} launches per call, expected {want}")


def train_kernel_phases(results: dict):
    """The training kernels: #1's train form, #8, the residual route's #6
    and #7, #9 and the C=768 sublayers #12, #13, #14 against their plain
    versions."""
    import torch

    from sunet_tf_tpu_torch.kernels import _build
    from sunet_tf_tpu_torch.kernels import upsample as up
    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.ops.window import shift_attn_mask

    gen = torch.Generator(device="cuda").manual_seed(4321)
    B, ws, heads, scale = 2, 8, 8, 8.0
    N = ws * ws
    # drop-path scales: image 0 keeps both branches, image 1 drops its MLP
    dp = torch.tensor([[1 / 0.9, 1 / 0.9], [1 / 0.9, 0.0]], device="cuda")
    print("phase: training kernels vs plain versions (bf16, batch 2)")
    for H, C, shift in ((64, 96, 4), (16, 384, 0)):
        p = block_params(C, heads, N, gen)
        x = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
        mask = (torch.as_tensor(shift_attn_mask(H, H, ws, shift), device="cuda")
                if shift else None)
        args = (x, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10], p[11],
                p[12], mask)
        kw = dict(ws=ws, num_heads=heads, scale=scale, shift=shift)
        case = f"({H},{H},{C}) shift {shift} train form"
        got_fn = lambda: wa.fused_swin_block(*args, dp, **kw)
        mx, mean = compare(f"fused_swin_block {case}", got_fn(),
                           wa.fused_swin_block_reference(*args, dp, **kw))
        record_time(results, "fused_swin_block", case, got_fn,
                    lambda: wa.fused_swin_block_reference(*args, dp, **kw),
                    block_cost(B, H, C), mx, mean)
        ones = wa.fused_swin_block(*args, torch.ones(B, 2, device="cuda"), **kw)
        check(torch.equal(ones, wa.fused_swin_block(*args, **kw)),
              "train form with dp = ones differs from the inference launch")
        print(f"  ({H},{H},{C}) shift {shift}: dp = ones equals the inference launch "
              "bit for bit")

    for H, C in ((64, 96), (32, 192), (16, 384)):
        for shift in (0, 4):
            p = block_params(C, heads, N, gen)
            x = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
            dout = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
            mask = (torch.as_tensor(shift_attn_mask(H, H, ws, shift), device="cuda")
                    if shift else None)
            args = (x, dout, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10],
                    p[11], p[12], mask, dp)
            kw = dict(ws=ws, num_heads=heads, scale=scale, shift=shift)
            case = f"({H},{H},{C}) shift {shift}"
            got_fn = lambda: wa.swin_block_bwd(*args, **kw)
            ref_fn = lambda: wa.swin_block_bwd_reference(*args, **kw)
            got = got_fn()
            mx, mean = compare_grads(f"swin_block_bwd {case}", got, ref_fn(), BLOCK_GRADS)
            check(all(torch.equal(a, b) for a, b in zip(got, got_fn())),
                  f"swin_block_bwd {case}: two runs differ (the reductions must be "
                  "deterministic)")
            record_time(results, "swin_block_bwd", case, got_fn, ref_fn,
                        block_bwd_cost(B, H, C), mx, mean)

    # the residual route (C=96/192): the forward's output and stored state,
    # then the backward from that state; its own generator, so that the
    # other kernels' cases keep their inputs
    rgen = torch.Generator(device="cuda").manual_seed(4322)
    for H, C, shift in ((64, 96, 4), (32, 192, 0)):
        p = block_params(C, heads, N, rgen)
        x = torch.randn(B, H, H, C, device="cuda", generator=rgen).to(torch.bfloat16)
        mask = (torch.as_tensor(shift_attn_mask(H, H, ws, shift), device="cuda")
                if shift else None)
        args = (x, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10], p[11],
                p[12], mask, dp)
        kw = dict(ws=ws, num_heads=heads, scale=scale, shift=shift)
        case = f"({H},{H},{C}) shift {shift}"
        got_fn = lambda: wa.fused_swin_block_res(*args, **kw)
        ref_fn = lambda: wa.fused_swin_block_res_reference(*args, **kw)
        got, ref = got_fn(), ref_fn()
        mx, mean = compare(f"fused_swin_block_res {case} out", got[0], ref[0])
        check_res_state(f"fused_swin_block_res {case}", got[1:], ref[1:], x, p, mask, ws=ws,
                        heads=heads, scale=scale, shift=shift)
        record_time(results, "fused_swin_block_res", case, got_fn, ref_fn,
                    block_res_cost(B, H, C, ws, heads), mx, mean)
    for H, C in ((64, 96), (32, 192)):
        for shift in (0, 4):
            p = block_params(C, heads, N, rgen)
            x = torch.randn(B, H, H, C, device="cuda", generator=rgen).to(torch.bfloat16)
            dout = torch.randn(B, H, H, C, device="cuda", generator=rgen).to(torch.bfloat16)
            mask = (torch.as_tensor(shift_attn_mask(H, H, ws, shift), device="cuda")
                    if shift else None)
            kw = dict(ws=ws, num_heads=heads, scale=scale, shift=shift)
            _, *res = wa.fused_swin_block_res(x, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8],
                                              p[9], p[10], p[11], p[12], mask, dp, **kw)
            args = (x, dout, *res, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10],
                    p[11], dp)
            case = f"({H},{H},{C}) shift {shift}"
            got_fn = lambda: wa.swin_block_bwd_res(*args, **kw)
            ref_fn = lambda: wa.swin_block_bwd_res_reference(*args, **kw)
            got = got_fn()
            mx, mean = compare_grads(f"swin_block_bwd_res {case}", got, ref_fn(), BLOCK_GRADS)
            check(all(torch.equal(a, b) for a, b in zip(got, got_fn())),
                  f"swin_block_bwd_res {case}: two runs differ (the reductions must be "
                  "deterministic)")
            record_time(results, "swin_block_bwd_res", case, got_fn, ref_fn,
                        block_bwd_res_cost(B, H, C, ws, heads), mx, mean)

    # the block backward at batch 4, the training step's grid, by the default
    # route's rule: #7 at C=96 and C=192, #8 at C=384; its own generator, so
    # that the other kernels' cases keep their inputs
    bgen = torch.Generator(device="cuda").manual_seed(4324)
    dp4 = torch.tensor([[1 / 0.9, 1 / 0.9], [1 / 0.9, 0.0], [0.0, 1 / 0.9], [1 / 0.9, 1 / 0.9]],
                       device="cuda")
    for H, C, shift, res in ((64, 96, 4, True), (32, 192, 0, True), (16, 384, 4, False)):
        p = block_params(C, heads, N, bgen)
        x = torch.randn(4, H, H, C, device="cuda", generator=bgen).to(torch.bfloat16)
        dout = torch.randn(4, H, H, C, device="cuda", generator=bgen).to(torch.bfloat16)
        mask = (torch.as_tensor(shift_attn_mask(H, H, ws, shift), device="cuda")
                if shift else None)
        kw = dict(ws=ws, num_heads=heads, scale=scale, shift=shift)
        case = f"batch 4 ({H},{H},{C}) shift {shift}"
        if res:
            name = "swin_block_bwd_res"
            _, *state = wa.fused_swin_block_res(x, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8],
                                                p[9], p[10], p[11], p[12], mask, dp4, **kw)
            args = (x, dout, *state, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10],
                    p[11], dp4)
            got_fn = lambda: wa.swin_block_bwd_res(*args, **kw)
            ref_fn = lambda: wa.swin_block_bwd_res_reference(*args, **kw)
            cost = block_bwd_res_cost(4, H, C, ws, heads)
        else:
            name = "swin_block_bwd"
            args = (x, dout, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10], p[11],
                    p[12], mask, dp4)
            got_fn = lambda: wa.swin_block_bwd(*args, **kw)
            ref_fn = lambda: wa.swin_block_bwd_reference(*args, **kw)
            cost = block_bwd_cost(4, H, C)
        got = got_fn()
        mx, mean = compare_grads(f"{name} {case}", got, ref_fn(), BLOCK_GRADS)
        check(all(torch.equal(a, b) for a, b in zip(got, got_fn())),
              f"{name} {case}: two runs differ (the reductions must be deterministic)")
        record_time(results, name, case, got_fn, ref_fn, cost, mx, mean)

    H, C, out_ch = 64, 96, 1
    n = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    bw = lambda i, o: (n(i, o) / i ** 0.5).to(torch.bfloat16)
    hp = (n(B, H, H, C).to(torch.bfloat16), bw(C, 16 * C),
          torch.full((1,), 0.25, device="cuda"), bw(C, C), 0.1 * n(C),
          torch.full((1,), 0.2, device="cuda"), bw(C, C), bw(C, C),
          (n(3, 3, C, out_ch) / (9 * C) ** 0.5).to(torch.bfloat16),
          n(B, H, H, 16 * out_ch).to(torch.bfloat16))
    case = f"({H},{H},{C}) out {out_ch}"
    got_fn = lambda: up.up4_conv_bwd(*hp)
    ref_fn = lambda: up.up4_conv_bwd_reference(*hp)
    got = got_fn()
    mx, mean = compare_grads(f"up4_conv_bwd {case}", got, ref_fn(), UP4_GRADS)
    check(all(torch.equal(a, b) for a, b in zip(got, got_fn())),
          f"up4_conv_bwd {case}: two runs differ (the reductions must be deterministic)")
    print("  the block backward kernels (both routes) and the head backward: two runs "
          "equal bit for bit")
    record_time(results, "up4_conv_bwd", case, got_fn, ref_fn, up4_bwd_cost(B, H, C, out_ch),
                mx, mean)
    # #9 on the training step's batch 4, at out 3 and 8 (the fold's 64-column
    # boxes per phase: 1, 3, 8), and on a (34,40) map of partial tiles (every
    # border of the fold's zero padding and of the stencil's clamp), each
    # with its plan asserted; its own generator, so that the other kernels'
    # cases keep their inputs
    hgen = torch.Generator(device="cuda").manual_seed(4326)
    hn = lambda *s: torch.randn(*s, device="cuda", generator=hgen)
    hw_ = lambda i, o: (hn(i, o) / i ** 0.5).to(torch.bfloat16)
    for Bc, H, W, C, out_ch, tpc in ((4, 64, 64, 96, 1, 32), (4, 64, 64, 96, 3, 32),
                                     (2, 64, 64, 96, 8, 32), (2, 34, 40, 96, 1, 13)):
        plan = up.up4_conv_bwd_plan(H, W, C, out_ch)
        check(plan["tiles_per_chunk"] == tpc and max(plan["fold_boxes"]) == out_ch,
              f"up4_conv_bwd ({H},{W},{C}) out {out_ch}: plan {plan}, expected {tpc} tiles "
              f"per chunk")
        hp = (hn(Bc, H, W, C).to(torch.bfloat16), hw_(C, 16 * C),
              torch.full((1,), 0.25, device="cuda"), hw_(C, C), 0.1 * hn(C),
              torch.full((1,), 0.2, device="cuda"), hw_(C, C), hw_(C, C),
              (hn(3, 3, C, out_ch) / (9 * C) ** 0.5).to(torch.bfloat16),
              hn(Bc, H, W, 16 * out_ch).to(torch.bfloat16))
        case = f"batch {Bc} ({H},{W},{C}) out {out_ch}, {tpc} tiles per chunk"
        got_fn = lambda: up.up4_conv_bwd(*hp)
        ref_fn = lambda: up.up4_conv_bwd_reference(*hp)
        got = got_fn()
        mx, mean = compare_grads(f"up4_conv_bwd {case}", got, ref_fn(), UP4_GRADS)
        check(all(torch.equal(a, b) for a, b in zip(got, got_fn())),
              f"up4_conv_bwd {case}: two runs differ (the reductions must be deterministic)")
        launches_per_call("up4_conv_bwd", got_fn, up.UP4_CONV_BWD_LAUNCHES)
        record_time(results, "up4_conv_bwd", case, got_fn, ref_fn,
                    up4_bwd_cost(Bc, H, C, out_ch, W), mx, mean)
    print("  the head backward: plans as mirrored, two runs equal bit for bit")

    per_call = {"ln_mlp_branch": wa.LN_MLP_BRANCH_LAUNCHES, "ln_mlp_bwd": wa.LN_MLP_BWD_LAUNCHES,
                "ln_window_attention_bwd": wa.LN_WMSA_BWD_LAUNCHES}
    for name, case, kernel, plain, args, kw, cost, labels in sublayer_cases(gen, B, ws, heads,
                                                                          scale):
        got_fn = lambda: kernel(*args, **kw)
        ref_fn = lambda: plain(*args, **kw)
        got = got_fn()
        if labels is None:
            mx, mean = compare(f"{name} {case}", got, ref_fn())
        else:
            mx, mean = compare_grads(f"{name} {case}", got, ref_fn(), labels)
            check(all(torch.equal(a, b) for a, b in zip(got, got_fn())),
                  f"{name} {case}: two runs differ (the reductions must be deterministic)")
        launches_per_call(name, got_fn, per_call[name])
        record_time(results, name, case, got_fn, ref_fn, cost, mx, mean)
    print("  the sublayer backward kernels: two runs equal bit for bit")
    c768_kernel_checks(results)

    # the residual forward (#6) on the main path's grid, shift 0 and 4 at
    # batch 2 and 4 with the cluster size of each width asserted, and the
    # LN+W-MSA backward (#12) on the main path's batch 4 and at C=384 with 2
    # heads (head dim 192, which the block backward refuses), its workspace
    # against the Python mirror; their own generator, so that the other
    # kernels' cases keep their inputs
    ngen = torch.Generator(device="cuda").manual_seed(4325)
    dpb = {2: dp, 4: torch.tensor([[1 / 0.9, 1 / 0.9], [1 / 0.9, 0.0], [0.0, 1 / 0.9],
                                   [1 / 0.9, 1 / 0.9]], device="cuda")}
    for Bc, H, C, shift, G in ((2, 64, 96, 0, 1), (2, 32, 192, 4, 2), (4, 64, 96, 0, 1),
                               (4, 64, 96, 4, 1), (4, 32, 192, 0, 2), (4, 32, 192, 4, 2)):
        plan = wa.block_plan(H, H, C, 4 * C, ws, heads)
        check(plan["G"] == G, f"fused_swin_block_res ({H},{H},{C}): plan {plan}, expected G={G}")
        p = block_params(C, heads, N, ngen)
        x = torch.randn(Bc, H, H, C, device="cuda", generator=ngen).to(torch.bfloat16)
        mask = (torch.as_tensor(shift_attn_mask(H, H, ws, shift), device="cuda")
                if shift else None)
        args = (x, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10], p[11],
                p[12], mask, dpb[Bc])
        kw = dict(ws=ws, num_heads=heads, scale=scale, shift=shift)
        case = f"batch {Bc} ({H},{H},{C}) shift {shift}, G={G}"
        got_fn = lambda: wa.fused_swin_block_res(*args, **kw)
        ref_fn = lambda: wa.fused_swin_block_res_reference(*args, **kw)
        got, ref = got_fn(), ref_fn()
        mx, mean = compare(f"fused_swin_block_res {case} out", got[0], ref[0])
        check_res_state(f"fused_swin_block_res {case}", got[1:], ref[1:], x, p, mask, ws=ws,
                        heads=heads, scale=scale, shift=shift)
        check(all(torch.equal(a, b) for a, b in zip(got, got_fn())),
              f"fused_swin_block_res {case}: two runs differ")
        launches_per_call("fused_swin_block_res", got_fn, 1)
        record_time(results, "fused_swin_block_res", case, got_fn, ref_fn,
                    block_res_cost(Bc, H, C, ws, heads), mx, mean)
    print("  the residual forward: output and state of two runs equal bit for bit")
    lib = _build.library()
    for Bc, H, C, hc, shift in ((4, 8, 768, 8, 0), (2, 16, 384, 2, 0), (2, 16, 384, 2, 4)):
        plan = wa.ln_wmsa_bwd_plan(H, H, C, ws, hc)
        work = wa.ln_wmsa_bwd_workspace(Bc, H, H, C, ws, hc)
        got_work = lib.sunet_ln_wmsa_bwd_workspace(Bc, H, H, C, ws, hc)
        check(work == got_work, f"ln_window_attention_bwd ({H},{H},{C}): workspace {got_work} "
              f"bytes, the Python mirror {work}")
        p = block_params(C, hc, N, ngen)
        x = torch.randn(Bc, H, H, C, device="cuda", generator=ngen).to(torch.bfloat16)
        dout = torch.randn(Bc, H, H, C, device="cuda", generator=ngen).to(torch.bfloat16)
        mask = (torch.as_tensor(shift_attn_mask(H, H, ws, shift), device="cuda")
                if shift else None)
        args = (x, dout, *p[0:5], p[12], mask)
        kw = dict(ws=ws, num_heads=hc, scale=scale)
        case = (f"batch {Bc} ({H},{H},{C}) shift {shift}, {hc} heads (head dim {C // hc}), "
                f"{plan['chunk_tokens']} tokens per chunk")
        name = "ln_window_attention_bwd"
        got_fn = lambda: wa.ln_window_attention_bwd(*args, **kw)
        ref_fn = lambda: wa.ln_window_attention_bwd_reference(*args, **kw)
        got = got_fn()
        mx, mean = compare_grads(f"{name} {case}", got, ref_fn(), WMSA_GRADS)
        check(all(torch.equal(a, b) for a, b in zip(got, got_fn())),
              f"{name} {case}: two runs differ (the reductions must be deterministic)")
        launches_per_call(name, got_fn, wa.LN_WMSA_BWD_LAUNCHES)
        record_time(results, name, case, got_fn, ref_fn,
                    ln_wmsa_bwd_cost(Bc, H, C, ws, hc, masked=shift > 0), mx, mean)
    print("  the LN+W-MSA backward: workspace equal to the mirror, two runs equal bit for bit")
    # the LN+MLP backward (#14) on the main path's batch 4, and on a
    # (16,16,768) map, whose window order is not its row order, each with its
    # K split asserted and its workspace held to the mirror
    for Bc, H, ks in ((4, 8, 8), (2, 16, 2)):
        C, hidden = 768, 3072
        plan = wa.ln_mlp_bwd_plan(H, H, C, hidden)
        check(plan["ks"] == ks, f"ln_mlp_bwd ({H},{H},{C}): plan {plan}, expected ks={ks}")
        work = wa.ln_mlp_bwd_workspace(Bc, H, H, C, hidden)
        got_work = lib.sunet_ln_mlp_bwd_workspace(Bc, H, H, C, hidden)
        check(work == got_work, f"ln_mlp_bwd ({H},{H},{C}): workspace {got_work} bytes, the "
              f"Python mirror {work}")
        p = block_params(C, heads, N, ngen)
        x = torch.randn(Bc, H, H, C, device="cuda", generator=ngen).to(torch.bfloat16)
        dout = torch.randn(Bc, H, H, C, device="cuda", generator=ngen).to(torch.bfloat16)
        args = (x, dout, p[6:8], p[8], p[9], p[10])
        case = f"batch {Bc} ({H},{H},{C}), K split {ks}"
        got_fn = lambda: wa.ln_mlp_bwd(*args)
        ref_fn = lambda: wa.ln_mlp_bwd_reference(*args)
        got = got_fn()
        mx, mean = compare_grads(f"ln_mlp_bwd {case}", got, ref_fn(), MLP_GRADS)
        check(all(torch.equal(a, b) for a, b in zip(got, got_fn())),
              f"ln_mlp_bwd {case}: two runs differ (the reductions must be deterministic)")
        launches_per_call("ln_mlp_bwd", got_fn, wa.LN_MLP_BWD_LAUNCHES)
        record_time(results, "ln_mlp_bwd", case, got_fn, ref_fn, ln_mlp_bwd_cost(Bc, H, C), mx,
                    mean)
    print("  the LN+MLP backward: workspace equal to the mirror, two runs equal bit for bit")

    # the split head's backward (#11), pixel-space dout: the main path's
    # (64,64,96), a map whose H and W are not multiples of 4 and 8, and C =
    # 256 (the cap: four column boxes, the pixel launch's pairs); its own
    # generator, so that the other kernels' cases keep their inputs
    sgen = torch.Generator(device="cuda").manual_seed(4323)
    for Hh, Ww, C, tpc in ((64, 64, 96, 32), (30, 44, 96, 12), (16, 16, 256, 2)):
        plan = up.up4_bwd_plan(Hh, Ww, C)
        work, got_work = up.up4_bwd_workspace(B, Hh, Ww, C), lib.sunet_up4_bwd_workspace(
            B, Hh, Ww, C)
        check(plan["tiles_per_chunk"] == tpc and work == got_work,
              f"up4_bwd ({Hh},{Ww},{C}): plan {plan}, expected {tpc} tiles per chunk; "
              f"workspace {got_work} bytes, the mirror {work}")
        hp = (*split_head_args(sgen, B, Hh, Ww, C),
              torch.randn(B, 4 * Hh, 4 * Ww, C, device="cuda", generator=sgen).to(
                  torch.bfloat16))
        case = f"({Hh},{Ww},{C}), {tpc} tiles per chunk"
        got_fn = lambda: up.up4_bwd(*hp)
        ref_fn = lambda: up.up4_bwd_reference(*hp)
        got = got_fn()
        mx, mean = compare_grads(f"up4_bwd {case}", got, ref_fn(), UP4_SPLIT_GRADS)
        check(all(torch.equal(a, b) for a, b in zip(got, got_fn())),
              f"up4_bwd {case}: two runs differ (the reductions must be deterministic)")
        launches_per_call("up4_bwd", got_fn, up.UP4_BWD_LAUNCHES)
        record_time(results, "up4_bwd", case, got_fn, ref_fn,
                    up4_split_bwd_cost(B, Hh, Ww, C), mx, mean)
    print("  the split head's backward: plans and workspace as mirrored, two runs equal bit "
          "for bit")


def split_head_args(gen, B: int, H: int, W: int, C: int) -> tuple:
    """Seeded inputs of the split x4 head (#10, #11): x, w_exp, alpha_p,
    w_b1, b_b1, alpha_b, wpf, wbf; unit-scale x, weights ~ N(0, 1/fan_in)."""
    import torch

    n = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    bw = lambda i, o: (n(i, o) / i ** 0.5).to(torch.bfloat16)
    return (n(B, H, W, C).to(torch.bfloat16), bw(C, 16 * C),
            torch.full((1,), 0.25, device="cuda"), bw(C, C), 0.1 * n(C),
            torch.full((1,), 0.2, device="cuda"), bw(C, C), bw(C, C))


def wmsa_library(xw, wqkv, bqkv, wproj, bproj, bias, mask, *, heads: int, scale: float):
    """One PyTorch call that computes W-MSA over the windows xw (T, N, C):
    ``F.multi_head_attention_forward`` (sequence N, batch T), its q rows
    and q bias scaled by scale * sqrt(d) so that its own 1/sqrt(d) leaves
    ``scale``, the rel-pos bias plus each window's mask as its additive
    attn_mask. A yardstick of speed for #15, timed here only: the port
    never calls it. Returns the call."""
    import math

    import torch
    import torch.nn.functional as F

    T, N, C = xw.shape
    qs = torch.ones(3 * C, device=xw.device)
    qs[:C] = scale * math.sqrt(C // heads)
    w_in = (wqkv.float().t() * qs[:, None]).to(xw.dtype).contiguous()
    b_in = (bqkv.float() * qs).to(xw.dtype)
    am = bias.float()[None].expand(T, -1, -1, -1)
    if mask is not None:
        am = am + mask.float().repeat(T // mask.shape[0], 1, 1)[:, None]
    am = am.reshape(T * heads, N, N).to(xw.dtype).contiguous()
    seq = xw.transpose(0, 1)
    w_out, b_out = wproj.t().contiguous(), bproj.to(xw.dtype)
    return lambda: F.multi_head_attention_forward(
        seq, seq, seq, C, heads, w_in, b_in, None, None, False, 0.0, w_out, b_out,
        training=False, need_weights=False, attn_mask=am)[0]


def kernel_phases(results: dict):
    import torch

    from sunet_tf_tpu_torch.kernels import upsample as up
    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.ops.window import shift_attn_mask, window_partition

    gen = torch.Generator(device="cuda").manual_seed(1234)
    B, ws, heads, scale = 2, 8, 8, 8.0
    N = ws * ws

    def record(name, case, got_fn, ref_fn, cost, near_tie=None, plain_fn=None,
               library_fn=None):
        """``plain_fn``, when given, is the whole plain version to time, where
        ``ref_fn`` computes only the part the comparison needs."""
        got, ref = got_fn(), ref_fn()
        mx, mean = compare(f"{name} {case}", got, ref, near_tie)
        record_time(results, name, case, got_fn, plain_fn or ref_fn, cost, mx, mean,
                    library_fn)

    def block_args(p, x, mask):
        return (x, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10], p[11],
                p[12], mask)

    print("phase: kernels vs plain versions (bf16, batch 2)")
    # qkv gain: weights scaled so that logits reach ~1e4 (trained QK_SCALE=8
    # weights do) and ~2e5 (one-hot rows; near ties are left out)
    for H, C, shift, gain in ((64, 96, 0, 1.0), (64, 96, 4, 1.0), (32, 192, 0, 1.0),
                              (32, 192, 4, 1.0), (16, 384, 0, 1.0), (16, 384, 4, 1.0),
                              (32, 192, 4, 7.5), (32, 192, 4, 30.0)):
        p = block_params(C, heads, N, gen, qkv_gain=gain)
        x = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
        mask = (torch.as_tensor(shift_attn_mask(H, H, ws, shift), device="cuda")
                if shift else None)
        args = block_args(p, x, mask)
        kw = dict(ws=ws, num_heads=heads, scale=scale, shift=shift)
        case = f"({H},{H},{C}) shift {shift}" + (f" qkv x{gain:g}" if gain != 1 else "")
        tie = None
        if gain != 1.0:
            tie, logit = near_tie_tokens(x, p, mask, ws=ws, heads=heads, scale=scale,
                                         shift=shift)
            print(f"  qkv x{gain:g}: max |logit| {logit:.3e}")
        record("fused_swin_block", case, lambda: wa.fused_swin_block(*args, **kw),
               lambda: wa.fused_swin_block_reference(*args, **kw), block_cost(B, H, C),
               near_tie=tie)

    # The main path's grid: batch 4, the inference and train forms, with the
    # cluster size of each width asserted (a plan is a function of one
    # image's shape, so batch 2 above ran the same ones); then head counts
    # whose cluster size is not a power of two (G = 3 and 6).
    dp4 = torch.tensor([[1 / 0.9, 1 / 0.9], [1 / 0.9, 0.0], [0.0, 1 / 0.9], [1.0, 1.0]],
                       device="cuda")
    for Bc, H, C, hc, shift, G, train in (
            (4, 64, 96, 8, 4, 1, False), (4, 32, 192, 8, 0, 2, False),
            (4, 32, 192, 8, 4, 2, False), (4, 32, 192, 8, 4, 2, True),
            (4, 16, 384, 8, 4, 8, False), (4, 16, 384, 8, 0, 8, True),
            (2, 32, 192, 3, 4, 3, False), (2, 16, 384, 6, 4, 6, False)):
        check(wa.block_plan(H, H, C, 4 * C, ws, hc)["G"] == G,
              f"({H},{H},{C}) {hc} heads: cluster size {wa.block_plan(H, H, C, 4 * C, ws, hc)}, "
              f"expected {G}")
        p = block_params(C, hc, N, gen)
        x = torch.randn(Bc, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
        mask = (torch.as_tensor(shift_attn_mask(H, H, ws, shift), device="cuda")
                if shift else None)
        args = block_args(p, x, mask) + ((dp4[:Bc],) if train else ())
        kw = dict(ws=ws, num_heads=hc, scale=scale, shift=shift)
        case = (f"batch {Bc} ({H},{H},{C}) shift {shift}" + (f" {hc} heads" if hc != heads else "")
                + (" train form" if train else "") + f", G={G}")
        record("fused_swin_block", case, lambda: wa.fused_swin_block(*args, **kw),
               lambda: wa.fused_swin_block_reference(*args, **kw), block_cost(Bc, H, C))

    # The chain W -> SW at C=192. Its second block is held against the plain
    # version fed the kernel's own first-block output, which isolates the
    # kernel's error from the second block's response to the first block's
    # rounding; both that response and the whole chain against two plain
    # blocks are printed.
    H, C = 32, 192
    ps = [block_params(C, heads, N, gen) for _ in range(2)]
    x = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
    mask = torch.as_tensor(shift_attn_mask(H, H, ws, 4), device="cuda")
    bkw = dict(ws=ws, num_heads=heads, scale=scale)
    chain = lambda: wa.fused_swin_block_chain(x, [p[:12] for p in ps],
                                              [p[12] for p in ps], mask,
                                              shifts=(0, 4), **bkw)
    first = wa.fused_swin_block(*block_args(ps[0], x, None), shift=0, **bkw)
    second_ref = lambda y: wa.fused_swin_block_reference(*block_args(ps[1], y, mask),
                                                         shift=4, **bkw)
    plain_chain = lambda: second_ref(wa.fused_swin_block_reference(
        *block_args(ps[0], x, None), shift=0, **bkw))
    record("fused_swin_block_chain", f"({H},{H},{C}) K=2, 2nd block",
           chain, lambda: second_ref(first), block_cost(B, H, C, blocks=2),
           plain_fn=plain_chain)
    two_refs = plain_chain()
    for what, a, b in (("chain vs two plain blocks", chain(), two_refs),
                       ("plain 2nd block on kernel vs plain 1st", second_ref(first),
                        two_refs)):
        dd = (a.float() - b.float()).abs()
        print(f"  {what}: max|diff| {float(dd.max()):.3e} mean|diff| "
              f"{float(dd.mean()):.3e}")
    two_blocks = wa.fused_swin_block(*block_args(ps[1], first, mask), shift=4, **bkw)
    check(torch.equal(chain(), two_blocks), "chain differs from two block launches")
    print("  fused_swin_block_chain == two fused_swin_block launches, bit for bit")

    H, C = 8, 768
    p = block_params(C, heads, N, gen)
    x = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
    T = B * H * H
    record("fused_ln_window_attention", f"({H},{H},{C})",
           lambda: wa.fused_ln_window_attention(x, *p[0:6], p[12], None, **bkw),
           lambda: wa.fused_ln_window_attention_reference(x, *p[0:6], p[12], None, **bkw),
           ln_wmsa_cost(B, H, C))
    # #3 on the main path's grid (batch 4) and where the router also sends
    # blocks: the SW mask on a map of 4 windows, a head dim of 192; each
    # with its K splits (qkv, projection) asserted
    for Bc, Hc, Cc, hc, shift, splits in ((4, 8, 768, 8, 0, (1, 4)), (2, 16, 768, 8, 4, (1, 1)),
                                         (2, 16, 384, 2, 0, (1, 2))):
        plan = wa.wmsa_plan(Hc, Hc, Cc, hc, ws)
        check((plan["ksq"], plan["ks"]) == splits,
              f"fused_ln_window_attention ({Hc},{Hc},{Cc}) {hc} heads: plan {plan}, "
              f"expected K splits {splits}")
        pc = block_params(Cc, hc, N, gen)
        xc = torch.randn(Bc, Hc, Hc, Cc, device="cuda", generator=gen).to(torch.bfloat16)
        mc = (torch.as_tensor(shift_attn_mask(Hc, Hc, ws, shift), device="cuda")
              if shift else None)
        kwc = dict(ws=ws, num_heads=hc, scale=scale)
        record("fused_ln_window_attention",
               f"batch {Bc} ({Hc},{Hc},{Cc}) shift {shift}, {hc} heads, ksq={splits[0]} "
               f"ks={splits[1]}",
               lambda: wa.fused_ln_window_attention(xc, *pc[0:6], pc[12], mc, **kwc),
               lambda: wa.fused_ln_window_attention_reference(xc, *pc[0:6], pc[12], mc, **kwc),
               ln_wmsa_cost(Bc, Hc, Cc, ws, hc, masked=shift > 0))
    record("fused_ln_mlp", f"({H},{H},{C})",
           lambda: wa.fused_ln_mlp(x, p[6:8], *p[8:12]),
           lambda: wa.fused_ln_mlp_reference(x, p[6:8], *p[8:12]),
           bound(4 * T * C * 4 * C, 2 * T * C * 2 + 2 * C * 4 * C * 2))
    # the main path's grid: batch 4, its K split asserted
    check(wa.mlp_plan(H * H, C, 4 * C)["ks"] == 4, f"fused_ln_mlp K split "
          f"{wa.mlp_plan(H * H, C, 4 * C)}, expected 4")
    y4 = torch.randn(4, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
    record("fused_ln_mlp", f"batch 4 ({H},{H},{C}), ks=4",
           lambda: wa.fused_ln_mlp(y4, p[6:8], *p[8:12]),
           lambda: wa.fused_ln_mlp_reference(y4, p[6:8], *p[8:12]),
           bound(4 * 2 * T * C * 4 * C, 2 * 2 * T * C * 2 + 2 * C * 4 * C * 2))

    H, C = 64, 96
    n = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    bw = lambda i, o: (n(i, o) / i ** 0.5).to(torch.bfloat16)

    def head_args(Bh, Hh, Wh, Ch, out_ch):
        return (n(Bh, Hh, Wh, Ch).to(torch.bfloat16), bw(Ch, 16 * Ch),
                torch.full((1,), 0.25, device="cuda"), bw(Ch, Ch), 0.1 * n(Ch),
                torch.full((1,), 0.2, device="cuda"), bw(Ch, Ch), bw(Ch, Ch),
                (n(3, 3, Ch, out_ch) / (9 * Ch) ** 0.5).to(torch.bfloat16))

    for out_ch in (1, 3):
        hp = head_args(B, H, H, C, out_ch)
        record("fused_dual_upsample4_conv_phase", f"({H},{H},{C}) out {out_ch}",
               lambda: up.fused_dual_upsample4_conv_phase(*hp),
               lambda: up.fused_dual_upsample4_conv_phase_reference(*hp),
               up4_cost(B, H, C, out_ch))
    # #5 on the main path's grid (batch 4), on a map that is not a multiple
    # of the 6 x 8 tile, on a map of one tile, and at C=192 (one tile per
    # CTA); each with its tiles per CTA asserted
    for Bh, Hh, Wh, Ch, out_ch, T in ((4, 64, 64, 96, 1, 2), (4, 64, 64, 96, 3, 2),
                                      (2, 34, 40, 96, 1, 2), (2, 6, 8, 96, 1, 2),
                                      (2, 16, 24, 192, 8, 1)):
        check(up.up4_plan(Ch, out_ch)["T"] == T, f"fused_dual_upsample4_conv_phase C={Ch} "
              f"out {out_ch}: plan {up.up4_plan(Ch, out_ch)}, expected {T} tiles per CTA")
        hp = head_args(Bh, Hh, Wh, Ch, out_ch)
        record("fused_dual_upsample4_conv_phase",
               f"batch {Bh} ({Hh},{Wh},{Ch}) out {out_ch}, T={T}",
               lambda: up.fused_dual_upsample4_conv_phase(*hp),
               lambda: up.fused_dual_upsample4_conv_phase_reference(*hp),
               up4_cost(Bh, Hh, Ch, out_ch, W=Wh))

    # the split head (#10): the main path's (64,64,96) at batch 2 and 4, a
    # map whose H and W are not multiples of the kernel's 8 x 8 tile, and
    # C = 256, its cap (four column boxes, the weights streamed per tile);
    # each with its plan asserted and two runs equal bit for bit
    for Bh, Hh, Ww, Ch, tpc in ((B, 64, 64, 96, 16), (4, 64, 64, 96, 16), (B, 30, 44, 96, 6),
                                (B, 16, 16, 256, 1)):
        plan = up.up4_split_plan(Hh, Ww, Ch)
        check(plan["tiles_per_chunk"] == tpc and plan["weights_resident"] == (Ch <= 128),
              f"fused_dual_upsample4 ({Hh},{Ww},{Ch}): plan {plan}")
        hp = split_head_args(gen, Bh, Hh, Ww, Ch)
        check(torch.equal(up.fused_dual_upsample4(*hp), up.fused_dual_upsample4(*hp)),
              f"fused_dual_upsample4 ({Hh},{Ww},{Ch}): two runs differ")
        record("fused_dual_upsample4", f"batch {Bh} ({Hh},{Ww},{Ch})",
               lambda: up.fused_dual_upsample4(*hp),
               lambda: up.fused_dual_upsample4_reference(*hp),
               up4_split_cost(Bh, Hh, Ww, Ch))

    odd_batch_cases(record, gen, head_args, block_args)

    # the standalone W-MSA (#15) over a pre-rolled map, shift 0 and 4 (the
    # SW mask), and without a qkv bias, with one PyTorch call for the same
    # function as a yardstick
    H, C = 64, 96
    for shift, qkv_bias in ((0, True), (4, True), (4, False)):
        p = block_params(C, heads, N, gen)
        x = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
        mask = (torch.as_tensor(shift_attn_mask(H, H, ws, shift), device="cuda")
                if shift else None)
        args = (x, p[2], p[3] if qkv_bias else None, p[4], p[5], p[12], mask)
        lib_args = (p[2], p[3] if qkv_bias else torch.zeros_like(p[3]), *args[3:])
        record("wmsa_core", f"({H},{H},{C}) shift {shift}"
               + ("" if qkv_bias else ", bqkv None"),
               lambda: wa.fused_window_attention(*args, **bkw),
               lambda: wa.fused_window_attention_reference(*args, **bkw),
               wmsa_cost(B, H, C, ws, heads, masked=shift > 0),
               library_fn=wmsa_library(window_partition(x, ws).contiguous(), *lib_args,
                                       heads=heads, scale=scale))


ODD_BATCH = 5


def odd_batch_cases(record, gen, head_args, block_args):
    """#1-#5 and #10 at an odd batch (``ODD_BATCH``) on the main path's
    shapes, each against its plain version with its plan asserted: the tiled
    path runs the model on 49 tiles per forward, and a grid that pairs work
    across images (#5 two tiles a CTA, #10 two chains a CTA) shows a tail
    only at an odd batch."""
    import torch

    from sunet_tf_tpu_torch.kernels import upsample as up
    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.ops.window import shift_attn_mask

    B, ws, heads, scale = ODD_BATCH, 8, 8, 8.0
    N = ws * ws
    bkw = dict(ws=ws, num_heads=heads, scale=scale)
    rand = lambda *s: torch.randn(*s, device="cuda", generator=gen).to(torch.bfloat16)
    sw_mask = lambda H: torch.as_tensor(shift_attn_mask(H, H, ws, 4), device="cuda")

    H, C = 64, 96
    plan = wa.block_plan(H, H, C, 4 * C, ws, heads)
    check(plan["G"] == 1, f"fused_swin_block ({H},{H},{C}): plan {plan}, expected G=1")
    p, x, mask = block_params(C, heads, N, gen), rand(B, H, H, C), sw_mask(H)
    args = block_args(p, x, mask)
    record("fused_swin_block", f"batch {B} ({H},{H},{C}) shift 4, G=1",
           lambda: wa.fused_swin_block(*args, shift=4, **bkw),
           lambda: wa.fused_swin_block_reference(*args, shift=4, **bkw), block_cost(B, H, C))

    H, C = 32, 192
    plan = wa.block_plan(H, H, C, 4 * C, ws, heads)
    check(plan["G"] == 2, f"fused_swin_block_chain ({H},{H},{C}): plan {plan}, expected G=2")
    ps, x, mask = [block_params(C, heads, N, gen) for _ in range(2)], rand(B, H, H, C), sw_mask(H)
    first = wa.fused_swin_block(*block_args(ps[0], x, None), shift=0, **bkw)
    second_ref = lambda y: wa.fused_swin_block_reference(*block_args(ps[1], y, mask), shift=4,
                                                         **bkw)
    record("fused_swin_block_chain", f"batch {B} ({H},{H},{C}) K=2, 2nd block, G=2",
           lambda: wa.fused_swin_block_chain(x, [q[:12] for q in ps], [q[12] for q in ps], mask,
                                             shifts=(0, 4), **bkw),
           lambda: second_ref(first), block_cost(B, H, C, blocks=2),
           plain_fn=lambda: second_ref(wa.fused_swin_block_reference(
               *block_args(ps[0], x, None), shift=0, **bkw)))

    H, C = 8, 768
    plan = wa.wmsa_plan(H, H, C, heads, ws)
    check((plan["ksq"], plan["ks"]) == (1, 4), f"fused_ln_window_attention ({H},{H},{C}): plan "
          f"{plan}, expected K splits (1, 4)")
    plan = wa.mlp_plan(H * H, C, 4 * C)
    check(plan["ks"] == 4, f"fused_ln_mlp ({H},{H},{C}): plan {plan}, expected ks=4")
    p, x = block_params(C, heads, N, gen), rand(B, H, H, C)
    record("fused_ln_window_attention", f"batch {B} ({H},{H},{C}), ksq=1 ks=4",
           lambda: wa.fused_ln_window_attention(x, *p[0:6], p[12], None, **bkw),
           lambda: wa.fused_ln_window_attention_reference(x, *p[0:6], p[12], None, **bkw),
           ln_wmsa_cost(B, H, C))
    T = B * H * H
    record("fused_ln_mlp", f"batch {B} ({H},{H},{C}), ks=4",
           lambda: wa.fused_ln_mlp(x, p[6:8], *p[8:12]),
           lambda: wa.fused_ln_mlp_reference(x, p[6:8], *p[8:12]),
           bound(4 * T * C * 4 * C, 2 * T * C * 2 + 2 * C * 4 * C * 2))

    H, C = 64, 96
    plan = up.up4_plan(C, 1)
    check(plan["T"] == 2, f"fused_dual_upsample4_conv_phase C={C} out 1: plan {plan}, "
          "expected 2 tiles per CTA")
    hp = head_args(B, H, H, C, 1)
    record("fused_dual_upsample4_conv_phase", f"batch {B} ({H},{H},{C}) out 1, T=2",
           lambda: up.fused_dual_upsample4_conv_phase(*hp),
           lambda: up.fused_dual_upsample4_conv_phase_reference(*hp), up4_cost(B, H, C, 1))
    plan = up.up4_split_plan(H, H, C)
    check(plan["tiles_per_chunk"] == 16, f"fused_dual_upsample4 ({H},{H},{C}): plan {plan}")
    sp = split_head_args(gen, B, H, H, C)
    record("fused_dual_upsample4", f"batch {B} ({H},{H},{C}), 16 tiles a chunk",
           lambda: up.fused_dual_upsample4(*sp),
           lambda: up.fused_dual_upsample4_reference(*sp), up4_split_cost(B, H, H, C))


def slice_phase(results: dict, cfg=None, label: str = "default SUNet",
                n_params: int = 99_681_993, report: tuple = None) -> dict:
    """The inference slice of ``cfg`` (default: ``Config()``) at 256x256
    batch 4 through backend="fused": launch counts equal to the router's
    prediction, the output against backend="eager", forward times, a trace.
    ``report``: the wrappers whose launches this run files as their main
    path's (default: every one it launches)."""
    import torch

    from sunet_tf_tpu_torch.config import Config
    from sunet_tf_tpu_torch.models.sunet import build_model, conv_fused_head, param_count

    cfg = cfg or Config()
    sw = cfg.swinunet
    print(f"phase: slice ({label}, 256x256, batch 4, bf16)")
    fused = build_model(cfg, device="cuda", backend="fused", seed=0)
    eager = build_model(cfg, device="cuda", backend="eager", seed=0)
    eager.load_state_dict(fused.state_dict())
    count = param_count(fused)
    print(f"  parameters: {count}")
    check(n_params is None or count == n_params, f"parameter count {count}")
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.rand(4, 256, 256, sw.in_chans, device="cuda", generator=gen)
    want = fused.expected_launches(tuple(x.shape))
    # the x4 head this configuration does not run
    other_head = ("fused_dual_upsample4" if conv_fused_head(sw.out_chans)
                  else "fused_dual_upsample4_conv_phase")
    with torch.inference_mode():
        y_fused, launches = run_counted(lambda: fused(x), want, other_head)
        check(tuple(y_fused.shape) == (4, 256, 256, sw.out_chans),
              f"shape {tuple(y_fused.shape)}")
        mean, _ = fused_vs_eager(y_fused, eager(x))
        fused_ms = time_ms(lambda: fused(x), iters=10)
        eager_ms = time_ms(lambda: eager(x), iters=10)
        fused_wall = time_ms(lambda: fused(x), iters=10, device=False)
        eager_wall = time_ms(lambda: eager(x), iters=10, device=False)
        print(f"  forward ms (batch 4), device: fused {fused_ms:.3f}, eager {eager_ms:.3f}; "
              f"{4000.0 / fused_ms:.1f} img/s fused; paced by the host: fused "
              f"{fused_wall:.3f}, eager {eager_wall:.3f}; {4000.0 / fused_wall:.1f} img/s fused")
        trace = trace_step(lambda: fused(x), f"fused forward, {label}")
    for k in report or [k for k, v in launches.items() if v > 0]:
        results.setdefault(k, {"max_abs_err": 0.0, "cases": []})["launches"] = launches[k]
    del fused, eager
    torch.cuda.empty_cache()
    return {"fused_ms": fused_ms, "eager_ms": eager_ms, "fused_wall_ms": fused_wall,
            "eager_wall_ms": eager_wall, "mean_abs_diff": mean,
            "launches": launches, "trace": trace}


def fused_vs_eager(y_fused, y_eager, what: str = "fused vs eager") -> tuple:
    """Both outputs finite and their mean |diff| within SLICE_MEAN_TOL;
    returns (mean, max) |diff|."""
    import torch

    check(bool(torch.isfinite(y_fused).all()), f"{what}: non-finite fused output")
    check(bool(torch.isfinite(y_eager).all()), f"{what}: non-finite eager output")
    d = (y_fused - y_eager).abs()
    mean, mx = float(d.mean()), float(d.max())
    print(f"  {what}: mean|diff| {mean:.3e} (tol {SLICE_MEAN_TOL:g}) max|diff| {mx:.3e} "
          f"mean|y| {float(y_eager.abs().mean()):.3e}")
    check(mean <= SLICE_MEAN_TOL, f"{what}: the outputs disagree")
    return mean, mx


def run_counted(fn, want: dict, other_head: str) -> tuple:
    """Run ``fn`` once with every launch count at 0 and the launch plans
    recorded; check the kernels' launches against ``want`` (the router's
    prediction), every kernel but ``other_head`` (the x4 head the model does
    not run) launched, no plain version run, and every plan one that the
    per-kernel checks held. Returns (fn's result, the launches)."""
    import torch

    from sunet_tf_tpu_torch.kernels import _build

    torch.cuda.synchronize()
    _build.reset_counts()
    with plans_taken(set()) as plans:
        y = fn()
    torch.cuda.synchronize()
    launches = {k: _build.counter(k).cuda for k in want}
    cpu_calls = {k: _build.counter(k).cpu for k in want}
    print(f"  launches: {launches} (router predicts {want})")
    check(launches == want, "launch counts differ from the router's prediction")
    check(all(v > 0 for k, v in launches.items() if k != other_head),
          "a kernel was not launched")
    check(not any(cpu_calls.values()), f"plain versions ran: {cpu_calls}")
    print(f"  launch plans: {sorted(plans)}")
    if HELD_PLANS:   # the per-kernel checks ran in this process
        check(plans <= HELD_PLANS, "launch plans of the main path that no per-kernel "
              f"check held against its plain version: {sorted(plans - HELD_PLANS)}")
    return y, launches


def trace_step(fn, label: str, detail: bool = True) -> dict:
    """Device time of one call of ``fn`` by kernel, from torch.profiler: the
    port's kernels by name with their namespaces (the block kernel's two
    forms by their template flag; the backward's GEMMs by their operand
    layouts),
    everything else as plain torch ops; the device's busy share of the
    call's CUDA-event time."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
    wall_ms = s.elapsed_time(e)
    spans, groups, plain = [], {}, {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        t0, t1 = ev.time_range.start, ev.time_range.end
        spans.append((t0, t1))
        m = re.search(r"sunet::((?:\w+::)*\w+(?:<[\w, ]+>)?)", ev.name)
        key = m.group(1) if m else "plain torch ops"
        n, us = groups.get(key, (0, 0.0))
        groups[key] = (n + 1, us + (t1 - t0))
        if not m:
            n, us = plain.get(ev.name, (0, 0.0))
            plain[ev.name] = (n + 1, us + (t1 - t0))
    if not spans:
        print("  trace: no device events recorded (device time split not measured)")
        return {}
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    print(f"  trace of one {label}: {len(spans)} device events, busy "
          f"{busy / 1000:.3f} ms of {wall_ms:.3f} ms (idle share "
          f"{1 - busy / 1000 / wall_ms:.3f})")
    if not detail:
        return {"wall_ms": wall_ms, "busy_ms": busy / 1000, "device_events": len(spans)}
    for key, (n, us) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        print(f"    {key}: {n} launches, {us / 1000:.3f} ms")
    print("    largest plain torch kernels:")
    for name, (n, us) in sorted(plain.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"      {n} x {us / 1000:.3f} ms  {name[:100]}")
    print("    host: largest ops by self CPU time:")
    for ev in sorted(prof.key_averages(), key=lambda ev: -ev.self_cpu_time_total)[:8]:
        print(f"      {ev.count} x {ev.self_cpu_time_total / 1000:.3f} ms  {ev.key[:100]}")
    return {"wall_ms": wall_ms, "busy_ms": busy / 1000,
            "groups": {k: {"launches": n, "ms": us / 1000} for k, (n, us) in groups.items()}}


@contextlib.contextmanager
def patched(patches: list):
    """Sets each (module, name, value) for the duration."""
    old = [(m, a, getattr(m, a)) for m, a, _ in patches]
    for m, a, v in patches:
        setattr(m, a, v)
    try:
        yield
    finally:
        for m, a, v in old:
            setattr(m, a, v)


# The launch plans (#1's and #6's cluster size, #4's K split, #3's K
# splits, #5's tiles per CTA, #12's chunks) that the per-kernel checks held
# against their plain versions, filled by plans_taken.
HELD_PLANS: set = set()


@contextlib.contextmanager
def plans_taken(into: set):
    """Record into ``into`` each launch plan the wrappers take for the
    duration: ("fused_swin_block" or "fused_swin_block_res", C, hidden,
    heads, G), ("fused_swin_block[seq]", C, hidden, heads, ws, Kp, ksq, ksp,
    ks1, ks2) (#1's sequence form, #2's too), ("fused_ln_mlp", C, hidden,
    ks1, ks), ("fused_ln_window_attention",
    C, heads, ws, ksq, ks), ("ln_window_attention_bwd", C, heads, ws, tokens
    per chunk, windows per chunk), ("ln_mlp_bwd", C, hidden, ks, tokens per
    chunk), ("swin_block_bwd", C, hidden, heads, ws, Cp, tokens per chunk,
    windows per chunk) (#8's big-window form, whose wrapper takes it),
    ("fused_dual_upsample4_conv_phase", C, out, T), ("up4_conv_bwd",
    C, out, tiles per chunk, tokens per chunk), ("up4_bwd", C, tiles per
    chunk, tokens per chunk), ("ln_mlp_branch", C, hidden, ks1, ks) (#13 takes
    #4's plan), ("fused_dual_upsample4", C, tiles per chunk) and
    ("wmsa_core", C, heads, ws, ksq, ks) (#15 takes #3's plan over one
    image's windows); the float32 forms' ("fused_swin_block[fp32]", C,
    hidden, heads, ws), ("fused_ln_window_attention[fp32]", C, heads, ws),
    ("fused_ln_mlp[fp32]", C, hidden) and
    ("fused_dual_upsample4_conv_phase[fp32]", C, out) (fixed tiles: a
    shape's plan changes no bit)."""
    from sunet_tf_tpu_torch.kernels import upsample as up
    from sunet_tf_tpu_torch.kernels import window_attention as wa

    block_plan, mlp_plan, wmsa_plan, up4_plan = wa.block_plan, wa.mlp_plan, wa.wmsa_plan, up.up4_plan
    seq_plan = wa.block_seq_plan
    launch_block, wmsa_bwd_plan = wa._launch_block, wa.ln_wmsa_bwd_plan
    mlp_bwd_plan, up4_bwd_plan = wa.ln_mlp_bwd_plan, up.up4_conv_bwd_plan
    block_bwd_plan = wa.block_bwd_plan
    split_bwd_plan, mlp_branch = up.up4_bwd_plan, wa.ln_mlp_branch
    split_plan, wmsa_core = up.up4_split_plan, wa.wmsa_core
    form = ["fused_swin_block"]   # the block kernel's form being launched
    mlp_form = ["fused_ln_mlp"]   # the caller of mlp_plan
    wmsa_form = ["fused_ln_window_attention"]   # the caller of wmsa_plan

    def launch(*args, res=False, **kw):
        form[0] = "fused_swin_block_res" if res else "fused_swin_block"
        try:
            return launch_block(*args, res=res, **kw)
        finally:
            form[0] = "fused_swin_block"

    def block(H, W, C, hidden, ws, heads):
        plan = block_plan(H, W, C, hidden, ws, heads)
        into.add((form[0], C, hidden, heads, plan["G"]))
        return plan

    def seq(H, W, C, hidden, ws, heads, train=False):
        plan = seq_plan(H, W, C, hidden, ws, heads, train=train)
        into.add(("fused_swin_block[seq]", C, hidden, heads, ws, plan["Kp"], plan["ksq"],
                  plan["ksp"], plan["ks1"], plan["ks2"]))
        return plan

    def wmsa_bwd(H, W, C, ws, heads):
        plan = wmsa_bwd_plan(H, W, C, ws, heads)
        into.add(("ln_window_attention_bwd", C, heads, ws, plan["chunk_tokens"],
                  plan["windows_per_chunk"]))
        return plan

    def mlp_bwd(H, W, C, hidden):
        plan = mlp_bwd_plan(H, W, C, hidden)
        into.add(("ln_mlp_bwd", C, hidden, plan["ks"], plan["chunk_tokens"]))
        return plan

    def block_bwd(H, W, C, hidden, ws, heads):
        plan = block_bwd_plan(H, W, C, hidden, ws, heads)
        into.add(("swin_block_bwd", C, hidden, heads, ws, plan["Cp"], plan["chunk_tokens"],
                  plan["windows_per_chunk"]))
        return plan

    def head_bwd(H, W, C, out):
        plan = up4_bwd_plan(H, W, C, out)
        into.add(("up4_conv_bwd", C, out, plan["tiles_per_chunk"], plan["wgrad_chunk_tokens"]))
        return plan

    def branch(*args, **kw):
        mlp_form[0] = "ln_mlp_branch"
        try:
            return mlp_branch(*args, **kw)
        finally:
            mlp_form[0] = "fused_ln_mlp"

    def split_bwd(H, W, C):
        plan = split_bwd_plan(H, W, C)
        into.add(("up4_bwd", C, plan["tiles_per_chunk"], plan["wgrad_chunk_tokens"]))
        return plan

    def mlp(M, C, hidden):
        plan = mlp_plan(M, C, hidden)
        into.add((mlp_form[0], C, hidden, plan["ks1"], plan["ks"]))
        return plan

    def wmsa(H, W, C, heads, ws):
        plan = wmsa_plan(H, W, C, heads, ws)
        into.add((wmsa_form[0], C, heads, ws, plan["ksq"], plan["ks"]))
        return plan

    def core(*args, **kw):
        wmsa_form[0] = "wmsa_core"
        try:
            return wmsa_core(*args, **kw)
        finally:
            wmsa_form[0] = "fused_ln_window_attention"

    def split(H, W, C):
        plan = split_plan(H, W, C)
        into.add(("fused_dual_upsample4", C, plan["tiles_per_chunk"]))
        return plan

    def head(C, out):
        plan = up4_plan(C, out)
        into.add(("fused_dual_upsample4_conv_phase", C, out, plan["T"]))
        return plan

    f32_block, f32_wmsa, f32_mlp, f32_up4 = (wa.f32_block_plan, wa.f32_wmsa_plan,
                                             wa.f32_mlp_plan, up.f32_up4_plan)

    def block32(H, W, C, hidden, ws, heads):
        into.add(("fused_swin_block" + FP32, C, hidden, heads, ws))
        return f32_block(H, W, C, hidden, ws, heads)

    def wmsa32(H, W, C, heads, ws):
        into.add(("fused_ln_window_attention" + FP32, C, heads, ws))
        return f32_wmsa(H, W, C, heads, ws)

    def mlp32(M, C, hidden):
        into.add(("fused_ln_mlp" + FP32, C, hidden))
        return f32_mlp(M, C, hidden)

    def head32(H, W, C, out):
        into.add(("fused_dual_upsample4_conv_phase" + FP32, C, out))
        return f32_up4(H, W, C, out)

    with patched([(wa, "block_plan", block), (wa, "block_seq_plan", seq),
                  (wa, "mlp_plan", mlp), (wa, "wmsa_plan", wmsa),
                  (up, "up4_plan", head), (wa, "_launch_block", launch),
                  (wa, "ln_wmsa_bwd_plan", wmsa_bwd), (wa, "ln_mlp_bwd_plan", mlp_bwd),
                  (up, "up4_conv_bwd_plan", head_bwd), (up, "up4_bwd_plan", split_bwd),
                  (wa, "block_bwd_plan", block_bwd),
                  (wa, "ln_mlp_branch", branch), (up, "up4_split_plan", split),
                  (wa, "wmsa_core", core), (wa, "f32_block_plan", block32),
                  (wa, "f32_wmsa_plan", wmsa32), (wa, "f32_mlp_plan", mlp32),
                  (up, "f32_up4_plan", head32)]):
        yield into


def drop_path_f32(x, scale):
    """``layers.drop_path`` with the product taken in float32."""
    return (x.float() * scale.reshape((-1,) + (1,) * (x.dim() - 1))).to(x.dtype)


@functools.lru_cache(maxsize=None)
def res_attention():
    """The attention core of JAX's residual route (the JAX package's
    ``window_attention.py``: the forward ``_block_fwd_res_kernel`` and the
    blockdiag half of ``_attn_core_bwd`` with ``recip=True``) as an autograd
    Function of plain torch ops, written here and sharing no code with the
    port's kernels, wrappers or Functions. Per (window, head): qs =
    round(q * scale); e = exp(s - rowmax(s)) of s = qs k^T + bias (+ mask),
    eb = round(e); rden = 1 / max(sum(eb), 1e-37); ctx_f = (eb @ v) * rden,
    returned rounded. Backward: dn = dctx * rden; t = dn * ctx_f; de =
    round(dn) v^T - rowsum(round(t)); ds = eb * de; dq = round(ds) k *
    scale, dk = round(ds)^T qs, dv = eb^T round(dn), dbias = sum of ds over
    windows. Products accumulate in float32."""
    import torch

    bf = torch.bfloat16

    class ResAttention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, bias, mask, scale):
            Bn, h, N, _ = q.shape
            qs = (q.float() * scale).to(bf)
            s = qs.float() @ k.float().transpose(-1, -2) + bias.float()
            if mask is not None:
                nW = mask.shape[0]
                s = (s.reshape(Bn // nW, nW, h, N, N) + mask[None, :, None]).reshape(
                    Bn, h, N, N)
            eb = torch.exp(s - s.amax(-1, keepdim=True)).to(bf)
            rden = 1.0 / eb.float().sum(-1, keepdim=True).clamp_min(1e-37)
            ctx_f = (eb.float() @ v.float()) * rden
            ctx.save_for_backward(qs, k, v, eb, rden, ctx_f)
            ctx.scale = scale
            return ctx_f.to(bf)

        @staticmethod
        def backward(ctx, dctx):
            qs, k, v, eb, rden, ctx_f = ctx.saved_tensors
            dn = dctx.float() * rden
            t = dn * ctx_f
            dnb = dn.to(bf).float()
            de = dnb @ v.float().transpose(-1, -2) - t.to(bf).float().sum(-1, keepdim=True)
            ds = eb.float() * de
            dsb = ds.to(bf).float()
            dq = (dsb @ k.float() * ctx.scale).to(bf)
            dk = (dsb.transpose(-1, -2) @ qs.float()).to(bf)
            dv = (eb.float().transpose(-1, -2) @ dnb).to(bf)
            return dq, dk, dv, ds.sum(0), None, None

    return ResAttention


def res_attention_patch() -> list:
    """Patches ``WindowAttention.forward`` so that the blocks the fused
    route trains on residuals (``SwinBlock.trains_on_residuals``) run
    :func:`res_attention`; the qkv and projection products stay the eager
    model's."""
    import torch

    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.models import layers

    eager_forward = layers.WindowAttention.forward

    def forward(self, xw, mask=None, generator=None):
        Bn, N, C = xw.shape
        h = self.num_heads
        # a block that draws dropout masks trains on the eager block on
        # every route
        if (xw.dtype != torch.bfloat16 or generator is not None
                or not wa.bwd_residuals_enabled(C, h, N)):
            return eager_forward(self, xw, mask, generator)
        qkv = layers.linear(xw, self.qkv.weight, self.qkv.bias)
        qkv = qkv.reshape(Bn, N, 3, h, C // h).permute(2, 0, 3, 1, 4)
        out = res_attention().apply(qkv[0], qkv[1], qkv[2], self.bias_matrix(), mask,
                                    self.scale)
        out = out.permute(0, 2, 1, 3).reshape(Bn, N, C)
        return layers.linear(out, self.proj.weight, self.proj.bias)

    return [(layers.WindowAttention, "forward", forward)]


# The block-kernel training cap before the C=768 stage trained on the block
# kernels: "fused_sublayer" (the route that stage took before, #3 + #12 and
# #13 + #14, JAX's SUNET_TRAIN_BLOCK_KERNEL=0 there), the comparison of the
# train phase and the model path that keeps the sublayer kernels launched.
OLD_TRAIN_BLOCK_CAP = 384


def route_patches(be: str) -> list:
    """Route ``be``'s settings: ``ROUTE_TRAIN_RESID`` off for
    "fused_recompute"; ``ROUTE_TRAIN_BLOCK_MAX_C`` at OLD_TRAIN_BLOCK_CAP
    for "fused_sublayer"; JAX's residual-route attention in the eager model
    for "eager_res*"; the drop-path product in float32 for "*_dp32"; the
    defaults for every other route."""
    from sunet_tf_tpu_torch.models import layers

    return ([(layers, "ROUTE_TRAIN_RESID", be != "fused_recompute")]
            + ([(layers, "ROUTE_TRAIN_BLOCK_MAX_C", OLD_TRAIN_BLOCK_CAP)]
               if be == "fused_sublayer" else [])
            + (res_attention_patch() if be.startswith("eager_res") else [])
            + ([(layers, "drop_path", drop_path_f32)] if be.endswith("_dp32") else []))


def plain_kernel_patches() -> list:
    """(module, name, plain version) of every kernel wrapper the training
    step calls: the step with them patched in runs the kernels' rounding
    points without a kernel."""
    from sunet_tf_tpu_torch.kernels import upsample as up
    from sunet_tf_tpu_torch.kernels import window_attention as wa

    names = [(wa, n) for n in ("fused_swin_block", "swin_block_bwd", "fused_swin_block_res",
                               "swin_block_bwd_res", "fused_ln_window_attention",
                               "ln_window_attention_bwd", "ln_mlp_branch", "ln_mlp_bwd")]
    names += [(up, "fused_dual_upsample4_conv_phase"), (up, "up4_conv_bwd")]

    def block(name, *args, plan_hw=None, **kw):
        return wa.fused_swin_block_reference(*args, **kw)

    # the training Functions' forwards launch through these entries, which
    # the wrappers above call too
    return [(m, n, getattr(m, n + "_reference")) for m, n in names] + [
        (wa, "_counted_block", block),
        (wa, "_ln_window_attention_impl", wa.fused_ln_window_attention_reference),
        (up, "_conv_phase_impl", up.fused_dual_upsample4_conv_phase_reference)]


def train_route(be: str):
    """Route ``be``'s settings (:func:`route_patches`) for the duration."""
    return patched(route_patches(be))


def train_gate(cfg, task: str, inp, tar, fused: tuple, eager_blocks: int = 0,
               configs: dict = None, unresolved_ok: bool = False) -> dict:
    """One training step of ``cfg``'s model (seeded weights) on each fused
    route of ``fused`` (``route_patches`` names), on the eager route in the
    compute dtype and in float32, and on NOISE_ROUTES' variants of the eager
    model, on the same batch and drop-path draws: launch counts equal to
    ``expected_launches(train=True)`` with no plain version run, then each
    fused route held against the float32 eager route by the gate (loss,
    ``grad_limits`` per parameter tensor with NOISE_ROUTES as the noise
    reference; a dropped or sign-flipped one-value gradient must fail).
    ``eager_blocks``: the blocks the router trains on eager autograd (the
    scaled config's C=1440 stage, as JAX). ``configs``: {route: config} of
    fused routes whose model is built from another config than ``cfg``
    (the same weights). ``unresolved_ok``: a one-value gradient whose
    limits the noise routes widen past a dropped one (the eager bf16 routes
    themselves that far from float32) is listed as one the gate cannot
    hold instead of failing the check, as long as the gate still fails a
    dropped and a sign-flipped gradient of some other one-value tensor.
    Returns {"models", "step"}: the models of the fused
    routes and of the eager route, and each route's loss, launches, peak
    memory and generator state after the step."""
    import numpy as np
    import torch

    from sunet_tf_tpu_torch.kernels import _build
    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.models.sunet import TRAIN_WRAPPERS, build_model
    from sunet_tf_tpu_torch.train.loop import loss_and_metrics, step_generators

    # the fused routes and the eager route in the compute dtype (bf16), the
    # eager route in float32, the oracle of all, and NOISE_ROUTES' variants
    # of the eager model, which gauge how far rounding alone moves each
    # gradient
    models = {be: build_model((configs or {}).get(be, cfg), device="cuda", backend="fused",
                              seed=0) for be in fused}
    models["eager"] = build_model(cfg, device="cuda", backend="eager", seed=0)
    models["eager_fp32"] = build_model(cfg.replace(compute_dtype="float32"), device="cuda",
                                       backend="eager", seed=0)
    for be in (*fused[1:], "eager", "eager_fp32"):
        models[be].load_state_dict(models[fused[0]].state_dict())
    for be in NOISE_ROUTES[1:]:
        models[be] = models["eager"]
    valid = torch.ones(inp.shape[0], device="cuda")
    want = {}
    for be in fused:
        with train_route(be):
            want[be] = models[be].expected_launches(tuple(inp.shape), train=True)
    step, grads, plans = {}, {}, {}
    for be, m in models.items():
        m.train().requires_grad_(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_counts()
        gen = step_generators(0, 0, "cuda")[1]
        with train_route(be), wa.exact_fp32(), plans_taken(set()) as plans[be]:
            loss, _, _ = loss_and_metrics(m, inp, tar, gen, valid, task)
            loss.backward()
        torch.cuda.synchronize()
        step[be] = {"loss": loss.item(), "gen_state": gen.get_state(),
                    "launches": {k: _build.counter(k).cuda for k in TRAIN_WRAPPERS},
                    "forms": {k: _build.counter(k).cuda for k in (SEQ64, WIDE_HEAD)},
                    "cpu": {k: _build.counter(k).cpu for k in TRAIN_WRAPPERS},
                    "peak_bytes": torch.cuda.max_memory_allocated()}
        grads[be] = {n: p.grad.double().flatten() for n, p in m.named_parameters()
                     if p.grad is not None}
        m.zero_grad(set_to_none=True)
    blocks = [b for st in list(models[fused[0]].layers) + list(models[fused[0]].layers_up[1:])
              for b in st.blocks]
    windows = {b.window_size for b in blocks}
    check(len(windows) == 1, f"the model's blocks take windows {sorted(windows)}")
    for be in fused:
        got = step[be]["launches"]
        print(f"  {be}: launches per training step: {got} (router predicts {want[be]})")
        check(got == want[be], f"{be}: training launch counts differ from "
              "expected_launches")
        on_res = got["fused_swin_block_res"]
        on_block = got["swin_block_bwd"] // wa.block_bwd_launches(blocks[0].window_size)
        on_seq64 = step[be]["forms"][SEQ64] // wa.SWIN_BLOCK_SEQ_LAUNCHES
        on_split = got["ln_mlp_branch"] // wa.LN_MLP_BRANCH_LAUNCHES
        on_eager = len(blocks) - on_res - on_block - on_split
        print(f"  {be}: blocks {len(blocks)}; on the residual route {on_res}, on the "
              f"block kernels with the recompute backward {on_block} ({on_seq64} of them on "
              f"the sequence form at 64 tokens), on the sublayer kernels {on_split}, on eager "
              f"autograd {on_eager} (the router's rule: {eager_blocks}); launches by form "
              f"{step[be]['forms']}")
        check(on_eager == eager_blocks, f"{be}: {on_eager} blocks trained on eager autograd, "
              f"expected {eager_blocks}")
        check(not any(step[be]["cpu"].values()), f"{be}: plain versions ran in training")
        print(f"  {be}: launch plans: {sorted(plans[be])}")
        if HELD_PLANS:   # the per-kernel checks ran in this process
            check(plans[be] <= HELD_PLANS, f"{be}: launch plans of the training step that no "
                  "per-kernel check held against its plain version: "
                  f"{sorted(plans[be] - HELD_PLANS)}")
    for be in ("eager_fp32", *NOISE_ROUTES):
        check(not any(step[be]["launches"].values()), f"{be} route launched kernels")
    ref = grads["eager_fp32"]
    one = sorted(n for n, v in ref.items() if v.numel() == 1 and bool(v.any()))
    for be in (*fused, *NOISE_ROUTES):
        print(f"  {be}: one-value gradients, relative error against float32: " + " ".join(
            f"{n} {float((grads[be][n] - ref[n]) / ref[n]):+.3e}" for n in one))

    distance = grad_distance
    limits = lambda name, noise=None: grad_limits(
        ref[name].numel(), None if noise is None else noise[name])

    def agree(be: str, noise: dict = None) -> dict:
        """Loss and per-parameter gradient agreement of route ``be`` with
        the float32 eager route."""
        lr, lo = step[be]["loss"], step["eager_fp32"]["loss"]
        r = {"loss_rel_diff": abs(lr - lo) / max(abs(lo), 1e-12), "bad": [],
             "cos": (1.0, ""), "rl2": (0.0, ""), "n": 0, "per": {}, "strict": 0,
             "margin": []}
        for name, b in ref.items():
            if not bool(b.any()):
                continue
            a = grads[be].get(name)
            check(a is not None and bool(torch.isfinite(a).all()),
                  f"{be} grad of {name} missing or non-finite")
            cos, rl2 = distance(a, b)
            r["n"] += 1
            r["per"][name] = (cos, rl2)
            r["cos"] = min(r["cos"], (cos, name))
            r["rl2"] = max(r["rl2"], (rl2, name))
            r["strict"] += cos >= TRAIN_GRAD_COS and rl2 <= TRAIN_GRAD_RL2
            cos_lim, rl2_lim = limits(name, noise)
            if cos < cos_lim or rl2 > rl2_lim:
                r["bad"].append(f"{name} cos {cos:.5f} (limit {cos_lim:.5f}) rl2 "
                                f"{rl2:.3e} (limit {rl2_lim:.3e})")
            r["margin"].append((gate_share(cos, rl2, cos_lim, rl2_lim), name))
        print(f"  {be} vs eager float32: loss {lr:.6f} vs {lo:.6f} (rel diff "
              f"{r['loss_rel_diff']:.3e}); {r['n']} gradient tensors, worst cosine "
              f"{r['cos'][0]:.6f} ({r['cos'][1]}), worst relative L2 {r['rl2'][0]:.3e} "
              f"({r['rl2'][1]}); {r['strict']} within cos {TRAIN_GRAD_COS} and rl2 "
              f"{TRAIN_GRAD_RL2:g}; nearest their limits (share of the limit): "
              + ", ".join(f"{n} {m:.2f}" for m, n in sorted(r["margin"])[-3:]))
        return r

    noise_r = [agree(be) for be in NOISE_ROUTES]
    eager_r = noise_r[0]
    # per tensor, the farthest of the eager bf16 routes
    noise = {n: (min(r["per"][n][0] for r in noise_r),
                 max(r["per"][n][1] for r in noise_r)) for n in eager_r["per"]}
    route_r = {be: agree(be, noise=noise) for be in fused}
    for be, r in route_r.items():
        closer = sum(r["per"][k][1] <= eager_r["per"][k][1] for k in r["per"])
        print(f"  {be} is closer to float32 than the eager bf16 route in "
              f"{closer} of {r['n']} tensors")
        for b in r["bad"][:20]:
            print(f"    FAIL {b}")
        check(np.isfinite(step[be]["loss"]), f"{be}: non-finite training loss")
        check(r["loss_rel_diff"] <= TRAIN_LOSS_RTOL,
              f"{be}: training loss disagrees with eager")
        check(not r["bad"], f"{len(r['bad'])} {be} parameter gradients "
              "disagree with eager float32")
        step[be].update(loss_rel_diff=r["loss_rel_diff"], worst_grad_cos=r["cos"][0],
                        worst_grad_rel_l2=r["rl2"][0])
    # the one-value limits sit between the sound readings and a slope
    # gradient that is dropped or sign-flipped: the gate fails each of those
    unresolved = []
    for name in one:
        for fault, f in (("dropped", 0.0), ("sign-flipped", -1.0)):
            cos, rl2 = distance(grads[fused[0]][name] * f, ref[name])
            cos_lim, rl2_lim = limits(name, noise)
            if unresolved_ok and not (cos < cos_lim and rl2 > rl2_lim):
                unresolved.append(name)
                break
            check(cos < cos_lim and rl2 > rl2_lim,
                  f"the gate does not fail a {fault} gradient of {name}")
    held = [n for n in one if n not in unresolved]
    if unresolved:
        check(bool(held), "the gate holds no one-value tensor")
        print(f"  one-value gradients the gate cannot hold (the eager bf16 routes' own relative "
              "L2 from float32 past a dropped gradient's 1): " + ", ".join(
                  f"{n} (noise rl2 {noise[n][1]:.3e})" for n in unresolved))
    print(f"  one-value gradients: relative L2 limit "
          f"{max(limits(n, noise)[1] for n in held):.3e} at most; the gate "
          f"fails each of the {len(held)} dropped (rl2 1) and sign-flipped (rl2 2, cos -1)")
    for be in fused:
        step[be]["unresolved_one_value"] = unresolved
    for be in ("eager_fp32", *NOISE_ROUTES[1:]):
        models.pop(be)
    torch.cuda.empty_cache()
    return {"models": models, "step": step}


def grad_stage(name: str) -> str:
    """The stage a parameter belongs to: "layers.i" or "layers_up.j" for the
    Swin stages (and layers_up.0, the bottleneck's x2 up-sample), else its
    top-level module (conv_first, patch_embed, norm, concat_back_dim,
    norm_up, up, output)."""
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] in ("layers", "layers_up") else parts[0]


def c2_distances(dots: tuple) -> tuple:
    """(1 - cos, relative L2) of a gradient against the float64 one from
    ``dots`` = (|g|^2, |g64|^2, |g - g64|^2, g.g64, numel), free of the
    cancellation of 1 - g.g64 / (|g| |g64|) near 1."""
    gg, rr, dd = dots[:3]
    ng, nr = gg ** 0.5, rr ** 0.5
    return max(dd - (ng - nr) ** 2, 0.0) / max(2 * ng * nr, 1e-300), (dd / max(rr, 1e-300)) ** 0.5


def c2_pooled(readings: list, name: str) -> tuple:
    """(scale error, relative L2) of tensor ``name`` pooled over the draws
    of ``readings``: sum g.g64 / sum |g64|^2 - 1 (how much of the exact
    gradient the route's carries, less one) and sqrt(sum |g - g64|^2 /
    sum |g64|^2)."""
    rr = sum(d[name][1] for d in readings)
    return (sum(d[name][3] for d in readings) / max(rr, 1e-300) - 1.0,
            (sum(d[name][2] for d in readings) / max(rr, 1e-300)) ** 0.5)


def c2_aggregate(readings: list) -> dict:
    """Per stage, the geometric mean over its tensors and the draws of (1 -
    cos) and of rl2: {stage: (omc, rl2, tensors)} of ``readings`` (one dict
    {tensor: dots} per draw)."""
    import math

    logs: dict = {}
    for draw in readings:
        for name, dots in draw.items():
            omc, rl2 = c2_distances(dots)
            acc = logs.setdefault(grad_stage(name), [0.0, 0.0, 0])
            acc[0] += math.log(max(omc, 1e-30))
            acc[1] += math.log(max(rl2, 1e-30))
            acc[2] += 1
    return {st: (math.exp(a / n), math.exp(b / n), n // len(readings))
            for st, (a, b, n) in logs.items()}


def c2_scale_z(route: list, plain: list) -> dict:
    """Per stage, the largest over its tensors of more than one value of
    |s - s_plain| / rl2_plain (``c2_pooled``): how far the route's share
    of the exact gradient moves from its plain route's, in units of the
    plain route's own distance to float64, as (z, tensor)."""
    out: dict = {}
    for name, dots in route[0].items():
        if dots[4] == 1:
            continue
        s, _ = c2_pooled(route, name)
        sp, rp = c2_pooled(plain, name)
        out[grad_stage(name)] = max(out.get(grad_stage(name), (0.0, "")),
                                    (abs(s - sp) / max(rp, 1e-300), name))
    return out


def c2_arbiter(cfg, task: str, ds) -> dict:
    """C2's readings: the training step of ``cfg``'s model (seeded weights)
    on each route of C2_ROUTES, on each with every kernel by its plain
    version, and on the float64 eager arbiter, over C2_DRAWS batches of
    ``ds`` with their drop-path draws; per stage the aggregates of
    ``c2_aggregate`` and the gate (module text). The kernel routes must
    launch kernels and the plain routes none. Per draw and tensor the dots
    go to ``c2_readings.json`` beside the built kernels."""
    import torch

    from sunet_tf_tpu_torch.data.pipeline import batch_iterator
    from sunet_tf_tpu_torch.kernels import _build
    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.models.sunet import TRAIN_WRAPPERS, build_model, route_copy
    from sunet_tf_tpu_torch.train.loop import (loss_and_metrics, prepare, step_generators,
                                               to_device)

    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", backend="fused", seed=0)
    oracle = route_copy(model, dtype=torch.float64, backend="eager")
    for m in (model, oracle):
        m.train().requires_grad_(True)
    routes = {be: route_patches(be) for be in C2_ROUTES}
    routes.update({f"{be}_plain": route_patches(be) + plain_kernel_patches()
                   for be in C2_ROUTES})
    valid = torch.ones(4, device="cuda")
    readings = {r: [] for r in routes}
    losses = {r: [] for r in ("float64", *routes)}
    for d in range(C2_DRAWS):
        seed = 100 + d
        batch = to_device(next(batch_iterator(ds, 4, shuffle=True, drop_last=True, seed=seed)),
                          "cuda")
        inp, tar = prepare(batch, task, 50.0, step_generators(seed, 0, "cuda")[0])

        def step(m, patches, label):
            _build.reset_counts()
            with patched(patches), wa.exact_fp32():
                loss, _, _ = loss_and_metrics(m, inp, tar, step_generators(seed, 0, "cuda")[1],
                                              valid, task)
                loss.backward()
            launched = sum(_build.counter(k).cuda for k in TRAIN_WRAPPERS)
            check(bool(launched) == (label in C2_ROUTES),
                  f"C2 {label}: {launched} kernel launches in its step")
            losses[label].append(float(loss.detach()))
            g = {n: p.grad.detach().double().flatten() for n, p in m.named_parameters()
                 if p.grad is not None}
            m.zero_grad(set_to_none=True)
            return g

        ref = step(oracle, [], "float64")
        check(all(v.dtype == torch.float64 for v in ref.values()), "C2: float64 grads expected")
        ref = {n: v for n, v in ref.items() if bool(v.any())}
        for r, patches in routes.items():
            g = step(model, patches, r)
            readings[r].append({n: (float(g[n] @ g[n]), float(v @ v),
                                    float((g[n] - v) @ (g[n] - v)), float(g[n] @ v), v.numel())
                                for n, v in ref.items()})
            del g
    (OUT_DIR / "c2_readings.json").write_text(json.dumps({"readings": readings,
                                                          "losses": losses}))
    agg = {r: c2_aggregate(v) for r, v in readings.items()}
    zs = {be: c2_scale_z(readings[be], readings[f"{be}_plain"]) for be in C2_ROUTES}
    stages = list(agg[C2_ROUTES[0]])
    print(f"  C2: {C2_DRAWS} draws, {sum(n for *_, n in agg[C2_ROUTES[0]].values())} gradient "
          f"tensors a draw against the float64 eager arbiter; losses " + ", ".join(
              f"{r} {sum(v) / len(v):.6f}" for r, v in losses.items()))
    print("  C2: per stage, geometric means of 1 - cos and of rl2 to float64: "
          + " | ".join(routes) + "; ratio of each fused route to its plain route; the "
          "largest scale z")
    out, bad = {}, []
    for st in stages:
        row = []
        for be in C2_ROUTES:
            k, p = agg[be][st], agg[f"{be}_plain"][st]
            ratio = (k[0] / max(p[0], 1e-300), k[1] / max(p[1], 1e-300))
            z, zname = zs[be].get(st, (0.0, ""))
            out[f"{be} {st}"] = {"omc": k[0], "rl2": k[1], "plain_omc": p[0],
                                 "plain_rl2": p[1], "ratio_omc": ratio[0], "ratio_rl2": ratio[1],
                                 "scale_z": z, "scale_z_tensor": zname}
            row.append(f"{k[0]:.3e} {k[1]:.3e} / plain {p[0]:.3e} {p[1]:.3e} = "
                       f"{ratio[0]:.2f} {ratio[1]:.2f}, z {z:.2f}")
            if max(ratio) > C2_FACTOR or z > C2_SCALE_Z:
                bad.append(f"{be} {st} ({ratio[0]:.2f}, {ratio[1]:.2f}, z {z:.2f} {zname})")
        print(f"    {st:18s} ({agg[C2_ROUTES[0]][st][2]:3d} tensors) " + " | ".join(row))
    FLOAT64_READINGS["c2"] = out
    print(f"  C2: {time.perf_counter() - t0:.1f} s; stages beyond {C2_FACTOR:g}x their plain "
          f"route or scale z {C2_SCALE_Z:g}: {bad or 'none'}")
    check(not bad, f"C2: fused routes farther from float64 than {C2_FACTOR:g}x their plain "
          f"routes, or scale z above {C2_SCALE_Z:g}, at {bad}")
    del model, oracle
    torch.cuda.empty_cache()
    return out


def step_times(cfg, task: str, models: dict, step: dict, batch: dict) -> tuple:
    """Train-step times (forward, backward, Adam update; median of 10) of
    each route's model on ``batch``, and the peak memory of its first step
    (its optimizer state is made there) and of a steady-state step, into
    ``step``. Returns (times, step functions)."""
    import torch

    from sunet_tf_tpu_torch.train.loop import build_steps
    from sunet_tf_tpu_torch.train.trainer import make_optimizer

    times, fns = {}, {}
    for be, m in models.items():
        fns[be] = build_steps(m, make_optimizer(cfg, m, 1), task=task, seed=0)
        counter = iter(range(1, 10_000))
        run = lambda f=fns[be]: f.train_step(batch, next(counter), f.init_metrics())
        with train_route(be):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            run()
            torch.cuda.synchronize()
            step[be]["first_peak_bytes"] = torch.cuda.max_memory_allocated()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            run()
            torch.cuda.synchronize()
            step[be]["step_peak_bytes"] = torch.cuda.max_memory_allocated()
            step[be]["step_added_bytes"] = step[be]["step_peak_bytes"] - base
            times[be] = time_ms(run, iters=10, warmup=2, device=False)
    for be in models:
        print(f"  {be}: train step {times[be]:.3f} ms (median of 10); peak memory "
              f"over the first step (its optimizer state is made there) "
              f"{step[be]['first_peak_bytes'] / 2**30:.3f} GiB, over a steady-state step "
              f"{step[be]['step_peak_bytes'] / 2**30:.3f} GiB, of which "
              f"{step[be]['step_added_bytes'] / 2**30:.3f} GiB above what was allocated "
              "before it (the models' weights, grads and optimizer states stay resident)")
    return times, fns


def train_phase(results: dict) -> dict:
    """One training step of the default SUNet on both fused routes (the
    residual route, the default, and ``ROUTE_TRAIN_RESID`` off), on the
    route its C=768 stage took before (``fused_sublayer``) and eager, then
    the training entry point."""
    import csv

    import numpy as np
    import torch
    import yaml

    from sunet_tf_tpu_torch.config import Config, config_to_dict
    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.data.pipeline import PairDataset, batch_iterator
    from sunet_tf_tpu_torch.data.synth import generate_dataset
    from sunet_tf_tpu_torch.train.loop import prepare, step_generators, to_device

    print("phase: training slice (default SUNet, 256x256, batch 4, bf16 compute, "
          "float32 parameters)")
    cfg, task = Config(), "mask"
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        generate_dataset(str(tmp / "train"), 12, size=256, seed=0)
        generate_dataset(str(tmp / "val"), 2, size=256, seed=1)
        ds = PairDataset(str(tmp / "train"), 256, train=True, seed=0)
        batch = to_device(next(batch_iterator(ds, 4, shuffle=True, drop_last=True, seed=0)),
                          "cuda")
        inp, tar = prepare(batch, task, 50.0, step_generators(0, 0, "cuda")[0])
        # both fused routes, and the route the C=768 stage took before (its
        # comparison, and the model path of the sublayer kernels)
        fused = ("fused", "fused_recompute", "fused_sublayer")
        gate = train_gate(cfg, task, inp, tar, fused)
        c2 = c2_arbiter(cfg, task, ds)
        models, step = gate["models"], gate["step"]
        launches = step["fused"]["launches"]
        c768 = sum(1 for st in models["fused"].layers for b in st.blocks if b.dim == 768)
        for be in fused:
            # Config(): the 32 blocks at C=96 and C=192 take the residual route
            on_res = step[be]["launches"]["fused_swin_block_res"]
            check(on_res == (0 if be == "fused_recompute" else 32),
                  f"{be}: {on_res} blocks on the residual route")
            # the C=768 stage: the sequence form's train form and #8 at head
            # dim 96 on both fused routes, the sublayer kernels on the old one
            forms, got = step[be]["forms"], step[be]["launches"]
            want_forms = ({SEQ64: 0, WIDE_HEAD: 0} if be == "fused_sublayer" else
                          {SEQ64: c768 * wa.SWIN_BLOCK_SEQ_LAUNCHES,
                           WIDE_HEAD: c768 * wa.SWIN_BLOCK_BWD_LAUNCHES})
            check(forms == want_forms and (got["ln_window_attention_bwd"] > 0)
                  == (be == "fused_sublayer"),
                  f"{be}: the C=768 stage's launches by form {forms}, expected {want_forms}")
        print(f"  the C={768} stage ({c768} blocks): on the sequence form's train form and #8 "
              "on both fused routes, on the sublayer kernels on fused_sublayer")
        ran = {k for be in fused for k, v in step[be]["launches"].items() if v > 0}
        check(ran >= set(launches) - {"fused_swin_block_chain", "fused_ln_mlp",
                                      "fused_dual_upsample4", "up4_bwd"},
              "a training kernel was not launched")

        times, fns = step_times(cfg, task, models, step, batch)
        traces = {}
        for be in fused:
            counter = iter(range(100, 10_000))
            with train_route(be):
                traces[be] = trace_step(lambda f=fns[be]: f.train_step(batch, next(counter),
                                                                       f.init_metrics()),
                                        f"{be} training step")
        del models, fns
        torch.cuda.empty_cache()
        # each kernel's training launches from the route that runs it: the
        # fused route, or for the sublayer kernels the old route's step
        for be in ("fused_sublayer", "fused"):
            for k, v in step[be]["launches"].items():
                if v > 0:
                    results.setdefault(k, {"max_abs_err": 0.0, "cases": []})["train_launches"] = v
        for k, v in step["fused"]["forms"].items():
            results.setdefault(k, {"max_abs_err": 0.0, "cases": []})["train_launches"] = v
        for be in ("fused", "fused_recompute"):
            print(f"  {be} against fused_sublayer (C=768 on #3 + #12, #13 + #14): step "
                  f"{times[be]:.3f} vs {times['fused_sublayer']:.3f} ms host-paced, busy "
                  f"{traces[be].get('busy_ms', float('nan')):.3f} vs "
                  f"{traces['fused_sublayer'].get('busy_ms', float('nan')):.3f} ms")

        # the entry point: python -m sunet_tf_tpu_torch.train
        print("phase: training entry point (1 epoch of 3 steps, one val pass)")
        raw = config_to_dict(cfg)
        raw["TRAINING"].update({"TRAIN_DIR": str(tmp / "train"), "VAL_DIR": str(tmp / "val"),
                                "SAVE_DIR": str(tmp / "ck")})
        (tmp / "training.yaml").write_text(yaml.safe_dump(raw))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "sunet_tf_tpu_torch.train", "--config",
             str(tmp / "training.yaml"), "--epochs", "1", "--steps-per-epoch", "3",
             "--device", "cuda"], cwd=ROOT, capture_output=True, text=True, timeout=900)
        fit_s = time.perf_counter() - t0
        print("\n".join("  | " + ln for ln in proc.stdout.strip().splitlines()[-6:]))
        check(proc.returncode == 0, f"training CLI exited {proc.returncode}: "
              f"{proc.stderr.strip()[-2000:]}")
        ckpt = tmp / "ck" / cfg.mode / "models" / "latest.pth"
        check(ckpt.is_file(), "no latest checkpoint written")
        with open(tmp / "ck" / cfg.mode / "log" / "metrics_per_epoch.csv") as f:
            rows = list(csv.DictReader(f))
        check(len(rows) == 1 and np.isfinite(float(rows[0]["Train_LOSS"]))
              and rows[0].get("Val_LOSS", "") != "", f"metrics rows {rows}")
        print(f"  CLI: {fit_s:.1f} s wall, train loss {float(rows[0]['Train_LOSS']):.6f}, "
              f"val loss {float(rows[0]['Val_LOSS']):.6f}, checkpoint "
              f"{ckpt.stat().st_size / 2**20:.1f} MiB")
    sf = step["fused"]
    out.update({"fused_step_ms": times["fused"], "eager_step_ms": times["eager"],
                "fused_recompute_step_ms": times["fused_recompute"],
                "fused_sublayer_step_ms": times["fused_sublayer"],
                "sublayer_launches": step["fused_sublayer"]["launches"],
                "sublayer_trace": traces["fused_sublayer"],
                "loss_fused": sf["loss"], "loss_eager": step["eager_fp32"]["loss"],
                "loss_rel_diff": sf["loss_rel_diff"], "worst_grad_cos": sf["worst_grad_cos"],
                "worst_grad_rel_l2": sf["worst_grad_rel_l2"],
                "first_step_peak_bytes": {be: step[be].get("first_peak_bytes") for be in step},
                "peak_bytes": {be: step[be].get("step_peak_bytes") for be in step},
                "step_added_bytes": {be: step[be].get("step_added_bytes") for be in step},
                "launches": launches, "recompute_launches": step["fused_recompute"]["launches"],
                "trace": traces["fused"], "recompute_trace": traces["fused_recompute"],
                "cli_seconds": fit_s, "c2": c2})
    return out


# The parity phase's run (tools/parity_run.py): Config() trained for 40
# fused steps at batch 4 on a 40 + 4 image synthetic corpus, then validated.
PARITY_ARGS = ("--n-train", "40", "--n-val", "4", "--epochs", "2", "--steps-per-epoch", "20",
               "--val-every", "1")
PARITY_STEPS = 40
# The float64 oracle's probes on the card against the oracle on the CPU
# (relative L2): float64 throughout agrees to rounding of ~1e-16 per
# operation; one product demoted to float32 reads ~1e-7.
ORACLE_CPU_RL2 = 1e-10


def parity_phase() -> dict:
    """``python -m sunet_tf_tpu_torch.tools.parity_run`` (PARITY_ARGS, its
    own process: Config() trained on the fused route, then validated across
    the routes against the float64 oracle), then ``tools.fp64_oracle`` and
    ``tools.bisect_fp64`` on its checkpoint, each its own process. Fails
    unless every gate of its RESULTS.json holds, the fused route reads mean
    |diff| <= SLICE_MEAN_TOL against eager bf16, every oracle probe is
    float64 and agrees with the oracle on the CPU within ORACLE_CPU_RL2,
    and the training loss is finite over PARITY_STEPS steps."""
    import math

    print(f"phase: parity (Config() trained {PARITY_STEPS} fused steps at batch 4, then "
          "validated on every route against the float64 oracle)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "parity"

        def tool(name: str, *args) -> float:
            t = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", f"sunet_tf_tpu_torch.tools.{name}",
                                   "--out", str(out), *args], cwd=ROOT, capture_output=True,
                                  text=True, timeout=900)
            wall = time.perf_counter() - t
            (OUT_DIR / f"parity_{name}.log").write_text(proc.stdout + proc.stderr)
            check(proc.returncode == 0, f"{name} exited {proc.returncode}: "
                  f"{proc.stderr.strip()[-2000:]}")
            print(f"  {name}: {wall:.1f} s wall")
            return wall

        walls = {"parity_run": tool("parity_run", *PARITY_ARGS), "fp64_oracle": tool("fp64_oracle"),
                 "bisect_fp64": tool("bisect_fp64")}
        res = json.loads((out / "RESULTS.json").read_text())
    (OUT_DIR / "parity_RESULTS.json").write_text(json.dumps(res, indent=1))
    tr = res["training"]
    print(f"  trained {tr['steps']} steps in {tr['train_time_s']} s: loss per epoch "
          f"{tr['train_loss']}, val PSNR per epoch {tr['val_psnr']}")
    print(f"  val (Trainer.eval_epoch): fused {res['val_fused']}; eager {res['val_eager']}")
    for k in res["psnr_mean"]:
        gap = (f", |PSNR - oracle| max {res['psnr_gap_db'][k]:.4f} dB, |SSIM - oracle| max "
               f"{res['ssim_gap_vs_oracle'][k]:.2e}, mean |out - oracle| "
               f"{res['mean_abs_vs_oracle'][k]:.3e}" if k in res["psnr_gap_db"] else "")
        print(f"  {k}: PSNR {res['psnr_mean'][k]:.4f} dB, SSIM {res['ssim_mean'][k]:.5f}{gap}")
    print(f"  fused vs eager bf16 mean |diff| {res['fused_vs_eager_mean_abs']:.3e} (tol "
          f"{SLICE_MEAN_TOL:g}); attention logits {res['attn_logits']}")
    orc = res["fp64_oracle"]
    print(f"  fp64_oracle on images {orc['images']}: |PSNR - PSNR_fp64| "
          f"{orc['psnr_abs_err_vs_fp64']}; fused closer or equal to exact than eager bf16: "
          f"{orc['fused_closer_or_equal_to_exact']}")
    bis = res["bisect_fp64"]
    for k, v in bis["stem"].items():
        print(f"  bisect (a) {k}: {v}")
    probes = bis["probes"]
    print("  bisect (b) rl2 to the oracle per probe: " + "; ".join(
        f"{p} " + " ".join(f"{probes['rl2'][r][p]:.2e}" for r in probes["rl2"])
        for p in probes["probes"]) + f" ({', '.join(probes['rl2'])})")
    print(f"  first probe where fused bf16 is more than 2x farther from the oracle than eager "
          f"bf16: {probes['first_divergent']}; oracle probes on the card against the CPU: "
          f"largest rl2 {max(probes['oracle_cpu_rl2'].values()):.3e} (limit {ORACLE_CPU_RL2:g})")
    gates = {g: res[g] for g in ("parity_within_0.05dB", "quality_no_regression_0.05dB",
                                  "ssim_no_regression_0.002")}
    print(f"  gates: {gates}")
    wall = time.perf_counter() - t0
    print(f"  parity phase: {wall:.1f} s wall ({', '.join(f'{k} {v:.1f} s' for k, v in walls.items())})")
    check(all(gates.values()), f"parity gates failed: {gates}")
    check(res["fused_vs_eager_mean_abs"] <= SLICE_MEAN_TOL, "parity: fused vs eager bf16 mean "
          f"|diff| {res['fused_vs_eager_mean_abs']:.3e} above {SLICE_MEAN_TOL:g}")
    check(set(probes["oracle_dtypes"].values()) == {"torch.float64"},
          f"parity: oracle probes not float64: {probes['oracle_dtypes']}")
    check(max(probes["oracle_cpu_rl2"].values()) <= ORACLE_CPU_RL2,
          f"parity: the oracle's probes on the card differ from the CPU's: "
          f"{probes['oracle_cpu_rl2']}")
    check(tr["steps"] == PARITY_STEPS and all(math.isfinite(v) for v in tr["train_loss"]),
          f"parity: {tr['steps']} steps, losses {tr['train_loss']}")
    return {"wall_s": wall, "tool_wall_s": walls, "psnr_mean": res["psnr_mean"],
            "ssim_mean": res["ssim_mean"], "psnr_gap_db": res["psnr_gap_db"],
            "mean_abs_vs_oracle": res["mean_abs_vs_oracle"],
            "fused_vs_eager_mean_abs": res["fused_vs_eager_mean_abs"],
            "attn_logits": res["attn_logits"], "first_divergent": probes["first_divergent"],
            "train_loss": tr["train_loss"], "gates": gates}


def bands_config():
    """``Config()`` with IN_CHANS = OUT_CHANS = 16: a 16-band denoise SUNet
    (every width and depth as in ``Config()``). 16 * OUT_CHANS > 128, so the
    fused route runs the split x4 head (#10, #11)."""
    import dataclasses

    from sunet_tf_tpu_torch.config import Config

    cfg = Config()
    return cfg.replace(swinunet=dataclasses.replace(cfg.swinunet, in_chans=16, out_chans=16))


def bands_phase(results: dict) -> dict:
    """The split x4 head's path: the 16-band SUNet at 256x256 batch 4, its
    fused forward against eager with launch counts, and one denoise training
    step on the fused route held by the training gate against float32
    eager, with its time, added memory and device trace."""
    import torch

    from sunet_tf_tpu_torch.kernels import upsample as up
    from sunet_tf_tpu_torch.train.loop import prepare, step_generators

    cfg = bands_config()
    sw = cfg.swinunet
    out = {"slice": slice_phase(results, cfg, "16-band SUNet", None,
                                report=("fused_dual_upsample4",)),
           "tiled": bands_tiled()}
    print("phase: training slice (16-band SUNet, denoise, 256x256, batch 4, bf16 compute, "
          "float32 parameters)")
    gen = torch.Generator(device="cuda").manual_seed(16)
    img = torch.randint(0, 256, (4, 256, 256, sw.in_chans), device="cuda", generator=gen,
                        dtype=torch.uint8)
    batch = {"input": img, "target": img}
    inp, tar = prepare(batch, "denoise", 50.0, step_generators(0, 0, "cuda")[0])
    gate = train_gate(cfg, "denoise", inp, tar, ("fused",))
    models, step = gate["models"], gate["step"]
    launches = step["fused"]["launches"]
    check(launches["fused_dual_upsample4"] == up.UP4_SPLIT_LAUNCHES
          and launches["up4_bwd"] == up.UP4_BWD_LAUNCHES
          and launches["fused_dual_upsample4_conv_phase"] == 0,
          "the split head did not train on its kernels")
    times, fns = step_times(cfg, "denoise", models, step, batch)
    counter = iter(range(100, 10_000))
    with train_route("fused"):
        trace = trace_step(lambda f=fns["fused"]: f.train_step(batch, next(counter),
                                                                f.init_metrics()),
                           "16-band fused training step")
    del models, fns
    torch.cuda.empty_cache()
    for k in ("fused_dual_upsample4", "up4_bwd"):
        results.setdefault(k, {"max_abs_err": 0.0, "cases": []})["train_launches"] = launches[k]
    sf = step["fused"]
    out.update({"fused_step_ms": times["fused"], "eager_step_ms": times["eager"],
                "loss_rel_diff": sf["loss_rel_diff"], "worst_grad_cos": sf["worst_grad_cos"],
                "worst_grad_rel_l2": sf["worst_grad_rel_l2"], "launches": launches,
                "step_added_bytes": {be: step[be].get("step_added_bytes") for be in times},
                "trace": trace})
    return out


def entries_phase(results: dict) -> dict:
    """The two entry points with no model route: the standalone W-MSA (#15),
    ``sunet_tf_tpu_torch.kernels.fused_window_attention`` at (64,64,96)
    with 8 heads, window 8, shift 4 and its mask, batch 2; and the ALU-rate
    probe (#16), ``python -m sunet_tf_tpu_torch.tools.alu_floor``'s
    ``main``, each op's chain held against its plain version at T=16 first,
    then its rates at T=2048, and the plain chains' times at T=2048."""
    import torch

    from sunet_tf_tpu_torch import kernels
    from sunet_tf_tpu_torch.kernels import _build
    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.ops.window import shift_attn_mask
    from sunet_tf_tpu_torch.tools import alu_floor

    print("phase: entry points (standalone W-MSA; the ALU-rate probe)")
    gen = torch.Generator(device="cuda").manual_seed(15)
    B, H, C, ws, heads = 2, 64, 96, 8, 8
    p = block_params(C, heads, ws * ws, gen)
    x = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
    mask = torch.as_tensor(shift_attn_mask(H, H, ws, 4), device="cuda")
    torch.cuda.synchronize()
    _build.reset_counts()
    y = kernels.fused_window_attention(x, p[2], p[3], p[4], p[5], p[12], mask, ws=ws,
                                       num_heads=heads, scale=8.0)
    torch.cuda.synchronize()
    n = _build.counter("wmsa_core").cuda
    print(f"  fused_window_attention: {n} launches of wmsa_core, output "
          f"{tuple(y.shape)} {y.dtype}")
    check(n == wa.WMSA_CORE_LAUNCHES and bool(torch.isfinite(y.float()).all())
          and y.shape == x.shape, "the standalone W-MSA did not run through its kernels")
    results.setdefault("wmsa_core", {"max_abs_err": 0.0, "cases": []})["launches"] = n

    sass = alu_floor.sass_step_counts(alu_floor.sass_listing())
    for op in alu_floor.OPS:
        got = {p: sass[op][p] for p in alu_floor.PIPE_RATES}
        print(f"  alu_chain {op}: per step " + ", ".join(f"{p} {v:g}" for p, v in got.items())
              + f" (SASS, a loop of {sass[op]['steps']} steps)")
        check(got == ALU_OPS[op], f"alu_chain {op}: the build's instructions per step {got} "
              f"are not ALU_OPS' {ALU_OPS[op]}")
    xs = torch.rand(alu_floor.ROWS, alu_floor.LANES, device="cuda", generator=gen)
    err = {}
    for op in alu_floor.OPS:
        err[op] = compare(f"alu_chain {op} T=16", alu_floor.alu_chain(xs, op, 16),
                          alu_floor.alu_chain_reference(xs, op, 16))
    torch.cuda.synchronize()
    _build.reset_counts()
    rates = alu_floor.main(["--t", str(alu_floor.T)])
    torch.cuda.synchronize()
    n = _build.counter("alu_chain").cuda
    print(f"  alu_floor: {n} launches of alu_chain")
    check(n > 0 and all(r > 0 for r, _ in rates.values()), "the ALU probe did not run")
    results.setdefault("alu_chain", {"max_abs_err": 0.0, "cases": []})["launches"] = n
    for op, (rate, ms) in rates.items():
        plain_ms = time_ms(lambda: alu_floor.alu_chain_reference(xs, op, alu_floor.T),
                           iters=3, warmup=1)
        cost = alu_cost(op, xs.numel(), alu_floor.T)
        print(f"    {op}: {ms:.4f} ms per launch ({rate:.1f} Gelem/s), plain {plain_ms:.4f} ms, "
              f"bound {cost['bound_ms']:.4f} ms ({cost['bound_by']}, {cost['pipe']} pipe; "
              f"{cost['bound_ms'] / ms:.2f} of it reached)")
        file_case(results, "alu_chain", {
            "case": f"{op} ({alu_floor.ROWS},{alu_floor.LANES}) T={alu_floor.T}",
            "max_abs_err": err[op][0], "mean_abs_err": err[op][1], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": cost["bound_ms"], "bound_by": cost["bound_by"],
            "library_ms": None, "gelem_per_s": rate})
    return {"alu_gelem_per_s": {op: r for op, (r, _) in rates.items()}}


def demo_phase():
    import numpy as np
    from PIL import Image

    from sunet_tf_tpu_torch import demo

    print("phase: demo entry point")
    rng = np.random.default_rng(3)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp, "in"), Path(tmp, "out")
        src.mkdir()
        sizes = {"a_256": (256, 256), "b_256": (256, 256), "c_200x300": (200, 300)}
        for name, (h, w) in sizes.items():
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                src / f"{name}.png")
        written = demo.main(["--input_dir", str(src), "--result_dir", str(dst),
                             "--batch", "2", "--device", "cuda"])
        check(len(written) == len(sizes), f"demo wrote {len(written)} files")
        for name, (h, w) in sizes.items():
            img = Image.open(dst / f"{name}.bmp")
            check(img.size == (w, h), f"{name}.bmp has size {img.size}")
        print(f"  wrote {len(written)} .bmp files of the input sizes")


def tiled_phase() -> dict:
    """Arbitrary-resolution inference (``infer.tiled``) of ``Config()`` on the
    card: a 1024x1024 image at 256 tiles, stride 128 (49 tiles, one forward
    at tile_batch 64) through backend="fused" with its launches, plans and
    output checked as the slice's, against backend="eager"; identity
    reconstruction at 1000x1500 on both canvases; tile_batch 16 (4 chunks)
    against 64; times and the gather / forward / fold split; the corpus of
    ``tools/corpus_bench.py`` one image at a time against ``run_corpus``;
    the ``demo_any_resolution`` and ``evaluate`` entry points on a
    temporary folder."""
    import numpy as np
    import torch
    from PIL import Image

    from sunet_tf_tpu_torch import demo_any_resolution, evaluate
    from sunet_tf_tpu_torch.config import Config
    from sunet_tf_tpu_torch.infer import tiled
    from sunet_tf_tpu_torch.models.sunet import build_model
    from sunet_tf_tpu_torch.ops.image import psnr, rgb_to_gray, ssim
    from sunet_tf_tpu_torch.tools import corpus_bench

    S, K, STRIDE = 1024, 256, 128
    print(f"phase: tiled inference (default SUNet, {S}x{S}, {K} tiles at stride {STRIDE}, "
          "bf16)")
    fused = build_model(Config(), device="cuda", backend="fused", seed=0)
    eager = build_model(Config(), device="cuda", backend="eager", seed=0)
    eager.load_state_dict(fused.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(13)
    img = torch.rand(1, S, S, 3, device="cuda", generator=gen)
    n_tiles = tiled.TiledRunner(fused, K, STRIDE).tiles_per_canvas(S, S)
    check(n_tiles == 49, f"{n_tiles} tiles")

    def run(model, tile_batch=64):
        return tiled.tiled_inference(model, img, kernel=K, stride=STRIDE, tile_batch=tile_batch)

    out = {"tiles": n_tiles}
    with torch.inference_mode():
        y, out["launches"] = run_counted(lambda: run(fused),
                                         fused.expected_launches((n_tiles, K, K, 3)),
                                         "fused_dual_upsample4")
        check(tuple(y.shape) == (1, S, S, 1), f"shape {tuple(y.shape)}")
        out["mean_abs_diff"], out["max_abs_diff"] = fused_vs_eager(y, run(eager))
        out["identity_max_err"] = {}
        for square in (False, True):
            x = torch.rand(1, 1000, 1500, 3, device="cuda", generator=gen)
            err = float((tiled.tiled_inference(lambda t: t, x, kernel=K, stride=STRIDE,
                                               square_pad=square) - x).abs().max())
            print(f"  identity model, 1000x1500, square_pad={square}: max|y - x| {err:.3e}")
            check(err <= 1e-6, "identity reconstruction is not exact")
            out["identity_max_err"][f"square_pad={square}"] = err
        y16 = run(fused, 16)
        d = (y16 - y).abs()
        out["tb16"] = {"max_abs_diff": float(d.max()), "mean_abs_diff": float(d.mean()),
                       "bit_equal": bool(torch.equal(y16, y))}
        print(f"  tile_batch 16 (4 chunks) vs 64: max|diff| {out['tb16']['max_abs_diff']:.3e} "
              f"mean|diff| {out['tb16']['mean_abs_diff']:.3e}, bit for bit: "
              f"{out['tb16']['bit_equal']}")
        check(out["tb16"]["mean_abs_diff"] <= SLICE_MEAN_TOL, "tile_batch 16 disagrees with 64")
        out["device_ms"] = time_ms(lambda: run(fused), iters=10)
        out["wall_ms"] = time_ms(lambda: run(fused), iters=10, device=False)
        print(f"  one {S}x{S} tiled_inference: device {out['device_ms']:.3f} ms "
              f"({1000.0 / out['device_ms']:.2f} img/s), paced by the host "
              f"{out['wall_ms']:.3f} ms ({1000.0 / out['wall_ms']:.2f} img/s)")
        out["trace"] = trace_step(lambda: run(fused), f"tiled {S}x{S} forward")
        canvas = tiled._place(img, S, S, 0, 0)
        tiles = tiled._gather_tiles(canvas, K, STRIDE)
        outs = fused(tiles)
        out["split_busy_ms"] = {
            part: trace_step(fn, f"tiled {part}", detail=False).get("busy_ms")
            for part, fn in (
                ("gather", lambda: tiled._gather_tiles(tiled._place(img, S, S, 0, 0), K, STRIDE)),
                ("forward", lambda: fused(tiles)),
                ("fold", lambda: tiled._fold_tiles(outs, 1, S, S, K, STRIDE)))}
    del fused, eager, outs, tiles
    torch.cuda.empty_cache()

    print("  tools/corpus_bench.py's corpus, one image at a time against run_corpus:")
    cb = corpus_bench.main([])
    for (h, w), a, b in zip(cb["sizes"], cb["serial"], cb["corpus"]):
        check(tuple(a.shape) == tuple(b.shape) == (1, h, w, 1),
              f"corpus output {tuple(b.shape)} for a {h}x{w} image")
        check(bool(torch.isfinite(b).all()), "non-finite corpus output")
    check(cb["mean_abs_diff"] <= SLICE_MEAN_TOL, "run_corpus disagrees with one image at a time")
    out["corpus"] = {k: v for k, v in cb.items() if k not in ("serial", "corpus", "sizes")}

    print("  demo_any_resolution and evaluate entry points:")
    rng = np.random.default_rng(13)
    sizes = {"a_1024x768": (768, 1024), "b_300x500": (300, 500), "c_256": (256, 256)}
    with tempfile.TemporaryDirectory() as tmp:
        src, masks, dst = Path(tmp, "in"), Path(tmp, "masks"), Path(tmp, "out")
        src.mkdir()
        masks.mkdir()
        for name, (h, w) in sizes.items():
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                src / f"{name}.png")
        for name in ("a_1024x768", "c_256"):
            h, w = sizes[name]
            Image.fromarray(rng.integers(0, 256, (h, w), dtype=np.uint8)).save(
                masks / f"{name}.png")
        written = demo_any_resolution.main(["--input_dir", str(src), "--mask_dir", str(masks),
                                            "--result_dir", str(dst), "--device", "cuda"])
        check(len(written) == len(sizes), f"demo_any_resolution wrote {len(written)} files")
        for name, (h, w) in sizes.items():
            size = Image.open(dst / f"{name}.bmp").size
            check(size == (w, h), f"{name}.bmp has size {size}")
        rows = (dst / "tpr_fpr_results.txt").read_text().splitlines()
        check(rows[0] == "Filename\tTPR\tFPR" and len(rows) == 3,
              f"tpr_fpr_results.txt: {rows}")
        ev = evaluate.main(["--gt_dir", str(src), "--pred_dir", str(dst), "--device", "cuda"])
        check(len(ev) == len(sizes), f"evaluate scored {len(ev)} pairs")
        check(all(np.isfinite([r["psnr"], r["ssim"]]).all() for r in ev), "non-finite scores")
        load = lambda f: torch.from_numpy(
            np.asarray(Image.open(f).convert("RGB"), np.float32) / 255.0)[None].cuda()
        for r, name in zip(ev, sorted(sizes)):
            gt, pr = load(src / f"{name}.png"), load(dst / f"{name}.bmp")
            direct = (float(psnr(gt, pr)), float(ssim(rgb_to_gray(gt), rgb_to_gray(pr))))
            check(r["name"] == f"{name}.png" and abs(r["psnr"] - direct[0]) <= 1e-6
                  and abs(r["ssim"] - direct[1]) <= 1e-6,
                  f"evaluate's row {r} differs from psnr/ssim {direct}")
    out["evaluate"] = {"mean_psnr": float(np.mean([r["psnr"] for r in ev])),
                       "mean_ssim": float(np.mean([r["ssim"] for r in ev]))}
    print(f"  wrote {len(written)} .bmp files and 2 TPR/FPR rows; evaluate: "
          f"{len(ev)} rows, each equal to psnr/ssim computed directly")
    return out


def bands_tiled() -> dict:
    """One ``tiled_inference`` of the 16-band SUNet on a (1, 512, 384, 16)
    image (a 512x512 canvas: 9 tiles of 256, stride 128) through
    backend="fused", its launches checked as the slice's (the split head
    #10, not #5), against eager."""
    import torch

    from sunet_tf_tpu_torch.infer.tiled import TiledRunner, tiled_inference
    from sunet_tf_tpu_torch.models.sunet import build_model

    print("phase: tiled inference (16-band SUNet, 512x384, 256 tiles at stride 128)")
    cfg = bands_config()
    fused = build_model(cfg, device="cuda", backend="fused", seed=0)
    eager = build_model(cfg, device="cuda", backend="eager", seed=0)
    eager.load_state_dict(fused.state_dict())
    x = torch.rand(1, 512, 384, 16, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(17))
    run = lambda m: tiled_inference(m, x, kernel=256, stride=128)
    geometry = TiledRunner(None, kernel=256, stride=128)
    n_tiles = geometry.tiles_per_canvas(*geometry.bucket(512, 384))
    check(n_tiles == 9, f"{n_tiles} tiles")
    out = {"tiles": n_tiles}
    with torch.inference_mode():
        y, out["launches"] = run_counted(lambda: run(fused), fused.expected_launches(
            (n_tiles, 256, 256, 16)), "fused_dual_upsample4_conv_phase")
        check(tuple(y.shape) == (1, 512, 384, 16), f"shape {tuple(y.shape)}")
        out["mean_abs_diff"], out["max_abs_diff"] = fused_vs_eager(y, run(eager))
        out["device_ms"] = time_ms(lambda: run(fused), iters=10)
        out["wall_ms"] = time_ms(lambda: run(fused), iters=10, device=False)
    print(f"  one 512x384 tiled_inference ({n_tiles} tiles): device {out['device_ms']:.3f} ms, "
          f"paced by the host {out['wall_ms']:.3f} ms")
    del fused, eager
    torch.cuda.empty_cache()
    return out


# The exported artifact holds no weight: its .pt2 stays under this share of
# the weights' float32 bytes (Config(): 399 MB).
EXPORT_SIZE_SHARE = 0.05


def bit_equal(what: str, got, want) -> float:
    """``got`` equal to ``want`` bit for bit (shape, dtype and values);
    returns max |diff| (0)."""
    import torch

    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: {tuple(got.shape)} {got.dtype} against {tuple(want.shape)} {want.dtype}")
    same = bool(torch.equal(got, want))
    diff = float((got.float() - want.float()).abs().max())
    print(f"  {what}: max|diff| {diff:.3e}, bit for bit: {same}")
    check(same, f"{what}: the reloaded artifact differs from the live model")
    return diff


def dispatch_cost(reps: int = 200) -> dict:
    """Host microseconds per call of the LN+MLP kernel (#4) at (8,8,768),
    batch 4, through its registered op against its implementation called
    directly (the live model's way), in turns (direct, op, op, direct), each
    over ``reps`` calls with one synchronize after them; the card is busy
    for less time than the host takes to enqueue them."""
    import torch

    from sunet_tf_tpu_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(31)
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    C, hid = 768, 3072
    args = (r(4, 8, 8, C).to(torch.bfloat16), 1 + 0.1 * r(C), 0.1 * r(C),
            (r(C, hid) * C ** -0.5).to(torch.bfloat16), 0.1 * r(hid),
            (r(hid, C) * hid ** -0.5).to(torch.bfloat16), 0.1 * r(C))
    fns = {"direct": lambda: ops.IMPLS["fused_ln_mlp"](*args),
           "op": lambda: ops.op("fused_ln_mlp")(*args)}
    check(torch.equal(fns["op"](), fns["direct"]()), "the op differs from its implementation")
    us: dict = {k: [] for k in fns}
    with torch.inference_mode():
        for name in ("direct", "op", "op", "direct"):
            for _ in range(10):
                fns[name]()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fns[name]()
            us[name].append((time.perf_counter() - t0) * 1e6 / reps)
            torch.cuda.synchronize()
    out = {k: min(v) for k, v in us.items()}
    out["op_minus_direct_us"] = out["op"] - out["direct"]
    print(f"  dispatch, #4 at (8,8,768) batch 4, host us per call: direct {out['direct']:.2f}, "
          f"through the op {out['op']:.2f} (+{out['op_minus_direct_us']:.2f})")
    return out


def export_bucket_check(label: str, cfg, size: int, tmp: Path, other_head: str) -> dict:
    """One batch-1 bucket of ``cfg`` at ``size``² exported, reloaded and held
    to the live fused model bit for bit, its launches equal to the
    router's prediction (the x4 head ``other_head`` not run)."""
    import torch

    from sunet_tf_tpu_torch.infer.export import ServingModel, save_exported
    from sunet_tf_tpu_torch.models.sunet import build_model

    fused = build_model(cfg, device="cuda", backend="fused", seed=0)
    sw = cfg.swinunet
    meta = save_exported(str(tmp), fused, size, batches=(1,))
    sm = ServingModel(str(tmp))
    x = torch.rand(1, size, size, sw.in_chans, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(23))
    with torch.inference_mode():
        got, launches = run_counted(lambda: sm(fused, x),
                                    fused.expected_launches(tuple(x.shape)), other_head)
        live = fused(x)
    out = {"export_s": meta["export_seconds"]["1"], "bytes": meta["bytes"]["1"],
           "graph_nodes": meta["graph_nodes"]["1"], "launches": launches,
           "max_abs_diff": bit_equal(f"{label} bucket 1", got, live)}
    print(f"  {label}: exported in {out['export_s']:.1f} s, {out['bytes'] / 1e6:.3f} MB, "
          f"{out['graph_nodes']} graph nodes")
    del fused
    torch.cuda.empty_cache()
    return out


def export_phase() -> dict:
    """Ahead-of-time serving artifacts (``infer/export.py``: ``torch.export``
    programs that call the kernels as ``sunet::`` ops) on the card, bf16,
    backend="fused". ``Config()`` at buckets 1 and 4, exported and
    reloaded in this run: requests of n = 1, 3 (bucket 4 with a zero-padded
    tail) and 4 equal to the live fused forward of the batch each ran, bit
    for bit, each reloaded call's launches equal to ``expected_launches``
    with no plain version run; bucket 4 against eager (mean |diff| <=
    5e-3); the artifact called with perturbed weights equal to the live
    model under them and apart from the unperturbed output; each .pt2 under
    EXPORT_SIZE_SHARE of the weights' float32 bytes; the artifact's
    device busy time (one profiled call) and host-paced forward beside the
    live model's at batch 1 and 4; an op's dispatch cost
    (``dispatch_cost``). Then a 1024x1024
    canvas's tiled artifact (kernel 256, stride 128, tile_batch 64: 49
    tiles in one forward) against the live ``TiledRunner`` on a 1017x1011
    image, with its launches; the 16-band model's batch-1 bucket (#10's op)
    and ``scaled_config()``'s at 512x512 (#1/#2's sequence form, #3/#4 at
    C=720 and 1440), each bit for bit against the live model."""
    import torch

    from sunet_tf_tpu_torch.config import Config, scaled_config
    from sunet_tf_tpu_torch.infer.export import (
        ServingModel,
        TiledServingModel,
        save_exported,
        save_exported_tiled,
    )
    from sunet_tf_tpu_torch.infer.tiled import TiledRunner
    from sunet_tf_tpu_torch.models.sunet import build_model, param_count

    t_phase = time.perf_counter()
    print("phase: export (serving artifacts on torch.export, default SUNet 256x256, bf16)")
    fused = build_model(Config(), device="cuda", backend="fused", seed=0)
    eager = build_model(Config(), device="cuda", backend="eager", seed=0)
    eager.load_state_dict(fused.state_dict())
    weight_bytes = 4 * param_count(fused)
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = Path(tmp_dir)
        meta = save_exported(str(tmp / "cfg"), fused, 256, batches=(1, 4))
        out.update({k: meta[k] for k in ("export_seconds", "bytes", "graph_nodes")})
        share = max(meta["bytes"].values()) / weight_bytes
        print(f"  exported buckets 1, 4: {', '.join(f'{s:.1f} s' for s in meta['export_seconds'].values())}; "
              f".pt2 {', '.join(f'{b / 1e6:.3f} MB' for b in meta['bytes'].values())} "
              f"({share:.4f} of the {weight_bytes / 1e6:.0f} MB of float32 weights); graph "
              f"nodes {', '.join(str(n) for n in meta['graph_nodes'].values())}")
        check(share < EXPORT_SIZE_SHARE, "the artifact holds more than its program")
        t0 = time.perf_counter()
        sm = ServingModel(str(tmp / "cfg"))
        out["load_s"] = time.perf_counter() - t0
        leaves = list(fused.parameters())
        gen = torch.Generator(device="cuda").manual_seed(29)
        x = torch.rand(4, 256, 256, 3, device="cuda", generator=gen)
        other = "fused_dual_upsample4"
        with torch.inference_mode():
            out["requests"] = {}
            for n in (1, 3, 4):
                b = 1 if n == 1 else 4
                xb = torch.cat([x[:n], x.new_zeros((b - n, 256, 256, 3))])
                got, launches = run_counted(lambda: sm(leaves, x[:n]),
                                            fused.expected_launches(tuple(xb.shape)), other)
                out["requests"][n] = bit_equal(f"request n={n} (bucket {b})", got,
                                               fused(xb)[:n])
            out["mean_abs_diff"], out["max_abs_diff"] = fused_vs_eager(
                got, eager(x), "reloaded bucket 4 vs eager")
            del eager
            # The program launches more kernels a call than the card's launch
            # queue holds ahead (its per-call weight casts), so the card cannot
            # be kept ahead of the host as time_ms does: device time is the
            # profiler's busy time of one call, for both.
            times = {}
            for b in (1, 4):
                xb = x[:b]
                art = trace_step(lambda: sm(leaves, xb), f"artifact, batch {b}", detail=False)
                live = trace_step(lambda: fused(xb), f"live, batch {b}", detail=False)
                times[b] = {
                    "artifact_busy_ms": art.get("busy_ms"), "live_busy_ms": live.get("busy_ms"),
                    "artifact_device_events": art.get("device_events"),
                    "live_device_events": live.get("device_events"),
                    "artifact_wall_ms": time_ms(lambda: sm(leaves, xb), iters=10, device=False),
                    "live_wall_ms": time_ms(lambda: fused(xb), iters=10, device=False)}
                t = times[b]
                print(f"  batch {b} forward ms, device busy: artifact {t['artifact_busy_ms']:.3f}, "
                      f"live {t['live_busy_ms']:.3f} "
                      f"(+{t['artifact_busy_ms'] - t['live_busy_ms']:.3f}); paced by the host: "
                      f"artifact {t['artifact_wall_ms']:.3f}, live {t['live_wall_ms']:.3f}")
            out["times"] = times
            y1 = fused(x[:1])
        out["dispatch"] = dispatch_cost()
        with torch.no_grad():
            pgen = torch.Generator(device="cuda").manual_seed(37)
            for p in fused.parameters():
                p.add_(0.01 * torch.randn(p.shape, device="cuda", generator=pgen))
        with torch.inference_mode():
            got = sm(leaves, x[:1])
            bit_equal("perturbed weights, bucket 1", got, fused(x[:1]))
            moved = float((got - y1).abs().max())
        print(f"  perturbed against unperturbed output: max|diff| {moved:.3e}")
        check(moved > 0, "the artifact ignores the weights it is called with")
        del sm, y1, got

        S, K, STRIDE = 1024, 256, 128
        tmeta = save_exported_tiled(str(tmp / "tiled"), fused, [(S, S)], kernel=K,
                                    stride=STRIDE)
        out["tiled"] = {k: tmeta[k][f"{S}x{S}"]
                        for k in ("export_seconds", "bytes", "graph_nodes")}
        tsm = TiledServingModel(str(tmp / "tiled"))
        img = torch.rand(1, S - 7, S - 13, 3, device="cuda", generator=gen)
        runner = TiledRunner(fused, K, STRIDE)
        with torch.inference_mode():
            got, out["tiled"]["launches"] = run_counted(
                lambda: tsm(leaves, img), fused.expected_launches((49, K, K, 3)), other)
            out["tiled"]["max_abs_diff"] = bit_equal(
                f"tiled {S - 7}x{S - 13} on a {S}x{S} canvas", got, runner(img))
            out["tiled"]["artifact_wall_ms"] = time_ms(lambda: tsm(leaves, img), iters=5,
                                                       device=False)
            out["tiled"]["live_wall_ms"] = time_ms(lambda: runner(img), iters=5, device=False)
        print(f"  tiled: exported in {out['tiled']['export_seconds']:.1f} s, "
              f"{out['tiled']['bytes'] / 1e6:.3f} MB, {out['tiled']['graph_nodes']} graph "
              f"nodes; paced by the host, ms: artifact {out['tiled']['artifact_wall_ms']:.3f}, "
              f"live {out['tiled']['live_wall_ms']:.3f}")
        del fused, tsm, runner, leaves
        torch.cuda.empty_cache()

        out["bands"] = export_bucket_check("16-band SUNet 256x256", bands_config(), 256,
                                           tmp / "bands", "fused_dual_upsample4_conv_phase")
        out["scaled"] = export_bucket_check("scaled SUNet 512x512", scaled_config(), 512,
                                            tmp / "scaled", "fused_dual_upsample4")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  export phase: {out['phase_s']:.1f} s wall")
    return out


SCALED_WS = 16
SCALED_QK = 30 ** -0.5   # head dim 30 at every stage, qk_scale None


def seq_halves(p: tuple) -> dict:
    """A block's parameters with one residual branch's output weights
    zeroed: "attention half" (w1, b1, w2, b2 zero: out = y) and "MLP half"
    (wproj, bproj zero: y = x); the whole block as it is."""
    z = lambda t: t * 0
    return {"attention half": p[:8] + (z(p[8]), z(p[9]), z(p[10]), z(p[11]), p[12]),
            "MLP half": p[:4] + (z(p[4]), z(p[5])) + p[6:],
            "block": p}


def scaled_cases(gen, B: int = 2) -> list:
    """The scaled config's kernel cases (WIN 16: 256 tokens a window, head
    dim 30, C=180 not a multiple of 16), each with its launch plan asserted:
    dicts of name, case, the kernel wrapper ``fn``, its ``plain`` version,
    ``args``, ``kw``, ``cost``, the mean limit, a near-tie map (or None) and
    whether chip_smoke times it.
    #1's sequence form at (128,128,180), shift 0 and 8, and (64,64,360)
    shift 8, each residual branch alone (the other's output weights zeroed)
    under the forward limits and the whole block under SEQ_BLOCK_MEAN_TOL;
    #3 at (32,32,720) shift 8, (16,16,1440), and there with logits of ~1e3
    (qkv x 30, near ties left out: a row maximum over fewer than all keys
    overflows); #4 at (32,32,720) and (16,16,1440); #5 at (128,128,180)
    out 1 and 3."""
    import torch

    from sunet_tf_tpu_torch.kernels import upsample as up
    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.ops.window import shift_attn_mask

    ws, scale, N = SCALED_WS, SCALED_QK, SCALED_WS ** 2
    rand = lambda *s: torch.randn(*s, device="cuda", generator=gen).to(torch.bfloat16)
    sw_mask = lambda H, shift: (torch.as_tensor(shift_attn_mask(H, H, ws, shift), device="cuda")
                                if shift else None)
    cases = []

    def add(name, case, fn, plain, args, kw, cost, mean_tol=MEAN_TOL, tie=None, timed=True):
        cases.append(dict(name=name, case=case, fn=fn, plain=plain, args=args, kw=kw, cost=cost,
                          mean_tol=mean_tol, tie=tie, timed=timed))

    for H, C, heads, shift, splits in ((128, 180, 6, 0, (1, 1, 1, 1)),
                                       (128, 180, 6, 8, (1, 1, 1, 1)),
                                       (64, 360, 12, 8, (1, 1, 1, 2))):
        plan = wa.block_seq_plan(H, H, C, 4 * C, ws, heads)
        check((plan["ksq"], plan["ksp"], plan["ks1"], plan["ks2"]) == splits
              and plan["Kp"] == wa.kpad(C), f"fused_swin_block ({H},{H},{C}): plan {plan}")
        p, x, mask = block_params(C, heads, N, gen), rand(B, H, H, C), sw_mask(H, shift)
        for half, q in seq_halves(p).items():
            add("fused_swin_block", f"({H},{H},{C}) shift {shift}, {heads} heads, {half}"
                + (f", Kp={plan['Kp']} splits {splits}" if half == "block" else ""),
                wa.fused_swin_block, wa.fused_swin_block_reference,
                (x, q[0:2], q[2], q[3], q[4], q[5], q[6:8], q[8], q[9], q[10], q[11], q[12], mask),
                dict(ws=ws, num_heads=heads, scale=scale, shift=shift),
                block_cost(B, H, C, ws, heads=heads, masked=shift > 0),
                SEQ_BLOCK_MEAN_TOL if half == "block" else MEAN_TOL, timed=half == "block")

    for H, C, heads, shift, gain, splits in ((32, 720, 24, 8, 1.0, (1, 1)),
                                             (16, 1440, 48, 0, 1.0, (2, 2)),
                                             (16, 1440, 48, 0, 30.0, (2, 2))):
        plan = wa.wmsa_plan(H, H, C, heads, ws)
        check((plan["ksq"], plan["ks"]) == splits, f"fused_ln_window_attention ({H},{H},{C}): "
              f"plan {plan}, expected K splits {splits}")
        p = block_params(C, heads, N, gen, qkv_gain=gain)
        x, mask = rand(B, H, H, C), sw_mask(H, shift)
        tie = None
        if gain != 1.0:
            tie, logit = near_tie_tokens(x, p, mask, ws=ws, heads=heads, scale=scale, shift=0)
            print(f"  qkv x{gain:g}: max |logit| {logit:.3e}")
        add("fused_ln_window_attention", f"({H},{H},{C}) shift {shift}, {heads} heads"
            + (f", qkv x{gain:g}" if gain != 1.0 else "") + f", ksq={splits[0]} ks={splits[1]}",
            wa.fused_ln_window_attention, wa.fused_ln_window_attention_reference,
            (x, *p[0:6], p[12], mask), dict(ws=ws, num_heads=heads, scale=scale),
            ln_wmsa_cost(B, H, C, ws, heads, masked=shift > 0), tie=tie)

    for H, C, splits in ((32, 720, (1, 4)), (16, 1440, (2, 8))):
        plan = wa.mlp_plan(H * H, C, 4 * C)
        check((plan["ks1"], plan["ks"]) == splits, f"fused_ln_mlp ({H},{H},{C}): plan {plan}, "
              f"expected K splits {splits}")
        p, y = block_params(C, 8, 64, gen), rand(B, H, H, C)
        T = B * H * H
        add("fused_ln_mlp", f"({H},{H},{C}), ks1={splits[0]} ks={splits[1]}", wa.fused_ln_mlp,
            wa.fused_ln_mlp_reference, (y, p[6:8], *p[8:12]), {},
            bound(4 * T * C * 4 * C, 2 * T * C * 2 + 2 * C * 4 * C * 2))

    n = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    bw = lambda i, o: (n(i, o) / i ** 0.5).to(torch.bfloat16)
    H, C = 128, 180
    for out_ch in (1, 3):
        plan = up.up4_plan(C, out_ch)
        check(plan["Cp"] == 192 and plan["T"] == 1, f"fused_dual_upsample4_conv_phase C={C} "
              f"out {out_ch}: plan {plan}")
        add("fused_dual_upsample4_conv_phase", f"({H},{H},{C}) out {out_ch}, Cp=192, T=1",
            up.fused_dual_upsample4_conv_phase, up.fused_dual_upsample4_conv_phase_reference,
            (rand(B, H, H, C), bw(C, 16 * C), torch.full((1,), 0.25, device="cuda"), bw(C, C),
             0.1 * n(C), torch.full((1,), 0.2, device="cuda"), bw(C, C), bw(C, C),
             (n(3, 3, C, out_ch) / (9 * C) ** 0.5).to(torch.bfloat16)), {},
            up4_cost(B, H, C, out_ch))
    return cases


def scaled_chain_check(gen, B: int = 2, record=None):
    """#2 K=2 (W -> SW) at (64,64,360), 12 heads: its second block against
    the plain version fed the kernel's own first-block output, under
    SEQ_BLOCK_MEAN_TOL (``record(name, case, got_fn, ref_fn, cost,
    plain_fn)`` files it where given), and the chain equal to two block
    launches bit for bit."""
    import torch

    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.ops.window import shift_attn_mask

    ws, N, H, C, heads = SCALED_WS, SCALED_WS ** 2, 64, 360, 12
    ps = [block_params(C, heads, N, gen) for _ in range(2)]
    x = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
    mask = torch.as_tensor(shift_attn_mask(H, H, ws, 8), device="cuda")
    bkw = dict(ws=ws, num_heads=heads, scale=SCALED_QK)
    blk = lambda q, y, m: (y, q[0:2], q[2], q[3], q[4], q[5], q[6:8], q[8], q[9], q[10], q[11],
                           q[12], m)
    chain = lambda: wa.fused_swin_block_chain(x, [q[:12] for q in ps], [q[12] for q in ps], mask,
                                              shifts=(0, 8), **bkw)
    first = wa.fused_swin_block(*blk(ps[0], x, None), shift=0, **bkw)
    second_ref = lambda y: wa.fused_swin_block_reference(*blk(ps[1], y, mask), shift=8, **bkw)
    case = f"({H},{H},{C}) K=2, {heads} heads, 2nd block"
    cost = block_cost(B, H, C, ws, blocks=2, heads=heads, masked=True)
    plain = lambda: second_ref(wa.fused_swin_block_reference(*blk(ps[0], x, None), shift=0, **bkw))
    if record is None:
        compare(f"fused_swin_block_chain {case}", chain(), second_ref(first),
                mean_tol=SEQ_BLOCK_MEAN_TOL)
    else:
        record("fused_swin_block_chain", case, chain, lambda: second_ref(first), cost, plain)
    two = wa.fused_swin_block(*blk(ps[1], first, mask), shift=8, **bkw)
    check(torch.equal(chain(), two), "fused_swin_block_chain at C=360 differs from two "
          "fused_swin_block launches")
    print("  fused_swin_block_chain == two fused_swin_block launches at C=360, bit for bit")


def float64_copy(a):
    """A float64 copy of a tensor, or of each tensor of a tuple; anything
    else as it is."""
    import torch

    if isinstance(a, torch.Tensor):
        return a.double()
    if isinstance(a, tuple):
        return tuple(float64_copy(t) for t in a)
    return a


def c4_reading(label: str, got, ref, plain, args: tuple, kw: dict) -> dict:
    """C4's reading of one case of #1's sequence form: mean |kernel - f64|
    and mean |plain - f64|, f64 the plain version on float64 copies of the
    case's arguments, and their ratio, held to C4_RATIO."""
    import torch

    with torch.no_grad():
        f64 = plain(*float64_copy(args), **kw)
    check(f64.dtype == torch.float64, f"{label}: the float64 plain version returned {f64.dtype}")
    k = float((got.double() - f64).abs().mean())
    p = float((ref.double() - f64).abs().mean())
    r = {"case": label, "kernel_vs_f64": k, "plain_vs_f64": p, "ratio": k / max(p, 1e-300)}
    print(f"    C4: mean |kernel - f64| {k:.4e}, mean |plain - f64| {p:.4e}, ratio "
          f"{r['ratio']:.3f} (limit {C4_RATIO})")
    FLOAT64_READINGS.setdefault("c4", []).append(r)
    check(r["ratio"] <= C4_RATIO, f"{label}: the kernel sits {r['ratio']:.3f} times as far "
          f"from float64 as its plain version (C4_RATIO {C4_RATIO})")
    return r


def scaled_kernel_phase(results: dict):
    """The scaled config's kernels against their plain versions at batch 2
    (``scaled_cases``, ``scaled_chain_check``), each case timed and filed
    under its wrapper's name + SCALED."""
    import torch

    print("phase: scaled-geometry kernels vs plain versions (bf16, batch 2)")
    gen = torch.Generator(device="cuda").manual_seed(1414)
    for c in scaled_cases(gen):
        got = lambda: c["fn"](*c["args"], **c["kw"])
        ref = lambda: c["plain"](*c["args"], **c["kw"])
        g, r = got(), ref()
        mx, mean = compare(f"{c['name']} {c['case']}", g, r, c["tie"], mean_tol=c["mean_tol"])
        if c["name"] == "fused_swin_block" and c["case"].split(", ")[2] == "block":
            c4_reading(f"{c['name']} {c['case']}", g, r, c["plain"], c["args"], c["kw"])
        if c["timed"]:
            record_time(results, c["name"] + SCALED, c["case"], got, ref, c["cost"], mx, mean)

    def record(name, case, got_fn, ref_fn, cost, plain_fn):
        mx, mean = compare(f"{name} {case}", got_fn(), ref_fn(), mean_tol=SEQ_BLOCK_MEAN_TOL)
        record_time(results, name + SCALED, case, got_fn, plain_fn, cost, mx, mean)

    scaled_chain_check(gen, record=record)


def scaled_phase(results: dict) -> dict:
    """The scaled SUNet (``scaled_config()``: EMB 180, WIN 16, heads
    6/12/24/48, 350,723,145 parameters, seeded weights) at 512x512, batch
    8, through backend="fused": launch counts equal to the router's
    prediction with every block on a kernel, every plan held by the
    scaled kernel checks; against backend="eager" (mean |diff| <= 5e-3);
    device-paced and host-paced images/s, a trace's busy and idle share,
    the forward's peak memory; then ``python -m sunet_tf_tpu_torch.demo
    --config <the scaled YAML>`` (a process of its own, waited for) on
    three 512x512 PNGs."""
    import numpy as np
    import torch
    import yaml
    from PIL import Image

    from sunet_tf_tpu_torch.config import config_to_dict, scaled_config
    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.models.sunet import build_model, param_count

    B, S = 8, 512
    cfg = scaled_config()
    print(f"phase: scaled slice (scaled SUNet, EMB 180, WIN 16, {S}x{S}, batch {B}, bf16)")
    fused = build_model(cfg, device="cuda", backend="fused", seed=0)
    eager = build_model(cfg, device="meta", backend="eager").to_empty(device="cuda")
    eager.load_state_dict(fused.state_dict())
    count = param_count(fused)
    print(f"  parameters: {count}")
    check(count == 350_723_145, f"parameter count {count}")
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = torch.rand(B, S, S, 3, device="cuda", generator=gen)
    want = fused.expected_launches(tuple(x.shape))
    blocks = sum(len(st.blocks) for st in list(fused.layers) + list(fused.layers_up[1:]))
    on_kernels = ((want["fused_swin_block"] + want["fused_swin_block_chain"])
                  // wa.SWIN_BLOCK_SEQ_LAUNCHES + want["fused_ln_window_attention"]
                  // wa.LN_WMSA_LAUNCHES)
    print(f"  blocks on kernels: {on_kernels} of {blocks}")
    check(on_kernels == blocks and want["fused_ln_mlp"] == want["fused_ln_window_attention"],
          "a block of the scaled model is not on a kernel route")
    out = {}
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        y, launches = run_counted(lambda: fused(x), want, "fused_dual_upsample4")
        out["peak_mem_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
        check(tuple(y.shape) == (B, S, S, 1), f"shape {tuple(y.shape)}")
        out["mean_abs_diff"], out["max_abs_diff"] = fused_vs_eager(y, eager(x))
        del y
        out["fused_ms"] = time_ms(lambda: fused(x), iters=5)
        out["fused_wall_ms"] = time_ms(lambda: fused(x), iters=5, device=False)
        out["eager_ms"] = time_ms(lambda: eager(x), iters=3)
        print(f"  forward ms (batch {B}), device: fused {out['fused_ms']:.3f}, eager "
              f"{out['eager_ms']:.3f}; {B * 1000.0 / out['fused_ms']:.2f} img/s fused; paced by "
              f"the host: fused {out['fused_wall_ms']:.3f} ms, "
              f"{B * 1000.0 / out['fused_wall_ms']:.2f} img/s; the forward adds "
              f"{out['peak_mem_gb']:.2f} GB at its peak")
        out["trace"] = trace_step(lambda: fused(x), "fused forward, scaled SUNet")
    out["launches"] = launches
    for k, v in launches.items():
        if v:
            results.setdefault(k + SCALED, {"max_abs_err": 0.0, "cases": []})["launches"] = v
    del fused, eager
    torch.cuda.empty_cache()

    print("  demo entry point with the scaled config's YAML:")
    rng = np.random.default_rng(14)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst, conf = Path(tmp, "in"), Path(tmp, "out"), Path(tmp, "scaled.yaml")
        src.mkdir()
        conf.write_text(yaml.safe_dump(config_to_dict(cfg)))
        names = ("a", "b", "c")
        for name in names:
            Image.fromarray(rng.integers(0, 256, (S, S, 3), dtype=np.uint8)).save(
                src / f"{name}.png")
        cmd = [sys.executable, "-m", "sunet_tf_tpu_torch.demo", "--input_dir", str(src),
               "--result_dir", str(dst), "--config", str(conf), "--batch", "2",
               "--device", "cuda"]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        print("  $ python -m sunet_tf_tpu_torch.demo ... --config scaled.yaml: "
              + (proc.stdout.strip().splitlines() or ["(no output)"])[-1])
        check(proc.returncode == 0, f"demo exited {proc.returncode}: {proc.stderr[-2000:]}")
        written = sorted(dst.glob("*.bmp"))
        check(len(written) == len(names), f"demo wrote {len(written)} files")
        for name in names:
            size = Image.open(dst / f"{name}.bmp").size
            check(size == (S, S), f"{name}.bmp has size {size}")
        print(f"  wrote {len(written)} .bmp files of {S}x{S}")
    torch.cuda.empty_cache()
    return out


def scaled_dp(gen, B: int):
    """(B, 2) drop-path scales drawn from ``gen``: keep 3/4, scaled by 4/3."""
    import torch

    return (torch.rand(B, 2, device="cuda", generator=gen) < 0.75).float() / 0.75


def scaled_train_cases(gen, B: int = 2) -> list:
    """The scaled training step's kernel forms (WIN 16: 256 tokens a window,
    head dim 30), each with its launch plan asserted, as dicts of name,
    case, the kernel wrapper ``fn``, its ``plain`` version, ``args``,
    ``kw``, ``cost``, the grads' labels (None for a forward), the mean limit,
    the launches of one call and whether chip_smoke times it: #1's train
    form (the sequence form with drop-path scales drawn from ``gen``) at
    (128,128,180), (64,64,360) and (32,32,720), shift 8, each residual
    branch alone under the forward limits and the whole block under
    SEQ_BLOCK_MEAN_TOL; #8's big-window form at (128,128,180) shift 0 and 8,
    (64,64,360) and (32,32,720) shift 8, under the backward limits; #5 at
    (128,128,180) out 1 (the step's head forward, untimed: the scaled phase
    times it); #9's wide form at (128,128,180) out 1 (C padded to 192,
    three column boxes) and at (32,32,128) out 1 (two)."""
    import torch

    from sunet_tf_tpu_torch.kernels import upsample as up
    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.ops.window import shift_attn_mask

    ws, scale, N = SCALED_WS, SCALED_QK, SCALED_WS ** 2
    rand = lambda *s: torch.randn(*s, device="cuda", generator=gen).to(torch.bfloat16)
    sw_mask = lambda H, shift: (torch.as_tensor(shift_attn_mask(H, H, ws, shift), device="cuda")
                                if shift else None)
    kw = lambda shift, heads: dict(ws=ws, num_heads=heads, scale=scale, shift=shift)
    cases = []

    def add(name, case, fn, plain, args, kwargs, cost, grads=None, mean_tol=MEAN_TOL,
            launches=None, timed=True):
        cases.append(dict(name=name, case=case, fn=fn, plain=plain, args=args, kw=kwargs,
                          cost=cost, grads=grads, mean_tol=mean_tol, launches=launches,
                          timed=timed))

    for H, C, heads, splits in ((128, 180, 6, (1, 1, 1, 1)), (64, 360, 12, (1, 1, 1, 2)),
                                (32, 720, 24, (1, 1, 1, 4))):
        plan = wa.block_seq_plan(H, H, C, 4 * C, ws, heads)
        check((plan["ksq"], plan["ksp"], plan["ks1"], plan["ks2"]) == splits
              and plan["Kp"] == wa.kpad(C), f"fused_swin_block train form ({H},{H},{C}): "
              f"plan {plan}")
        p, x, mask, dp = block_params(C, heads, N, gen), rand(B, H, H, C), sw_mask(H, 8), \
            scaled_dp(gen, B)
        print(f"  train form ({H},{H},{C}): drop-path scales {dp.tolist()}")
        for half, q in seq_halves(p).items():
            add("fused_swin_block", f"train form ({H},{H},{C}) shift 8, {heads} heads, {half}"
                + (f", Kp={plan['Kp']} splits {splits}" if half == "block" else ""),
                wa.fused_swin_block, wa.fused_swin_block_reference,
                (x, q[0:2], q[2], q[3], q[4], q[5], q[6:8], q[8], q[9], q[10], q[11], q[12], mask,
                 dp), kw(8, heads), block_cost(B, H, C, ws, heads=heads, masked=True),
                mean_tol=SEQ_BLOCK_MEAN_TOL if half == "block" else MEAN_TOL,
                launches=wa.SWIN_BLOCK_SEQ_LAUNCHES, timed=half == "block")

    for H, C, heads, shift, Cp in ((128, 180, 6, 0, 192), (128, 180, 6, 8, 192),
                                   (64, 360, 12, 8, 368), (32, 720, 24, 8, 720)):
        plan = wa.block_bwd_plan(H, H, C, 4 * C, ws, heads)
        check(plan["Cp"] == Cp and plan["nq"] == N // 64
              and max(plan["smem"].values()) <= wa.SMEM_MAX,
              f"swin_block_bwd ({H},{H},{C}): plan {plan}")
        p, x, dout, dp = (block_params(C, heads, N, gen), rand(B, H, H, C), rand(B, H, H, C),
                          scaled_dp(gen, B))
        add("swin_block_bwd", f"({H},{H},{C}) shift {shift}, {heads} heads, Cp={Cp}, "
            f"{plan['windows_per_chunk']} windows a chunk",
            wa.swin_block_bwd, wa.swin_block_bwd_reference,
            (x, dout, p[0:2], *p[2:6], p[6:8], *p[8:12], p[12], sw_mask(H, shift), dp),
            kw(shift, heads), block_bwd_cost(B, H, C, ws, heads=heads, masked=shift > 0),
            grads=BLOCK_GRADS, launches=wa.SWIN_BLOCK_BWD_BIG_LAUNCHES)

    n = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    bw = lambda i, o: (n(i, o) / i ** 0.5).to(torch.bfloat16)
    head = lambda H, C: (rand(B, H, H, C), bw(C, 16 * C), torch.full((1,), 0.25, device="cuda"),
                         bw(C, C), 0.1 * n(C), torch.full((1,), 0.2, device="cuda"), bw(C, C),
                         bw(C, C), (n(3, 3, C, 1) / (9 * C) ** 0.5).to(torch.bfloat16))
    # the head's forward the step runs (#5 at C=180, out 1; timed in the
    # scaled phase)
    add("fused_dual_upsample4_conv_phase", "(128,128,180) out 1, Cp=192, T=1",
        up.fused_dual_upsample4_conv_phase, up.fused_dual_upsample4_conv_phase_reference,
        head(128, 180), {}, up4_cost(B, 128, 180, 1), timed=False)
    for H, C, boxes in ((128, 180, 3), (32, 128, 2)):
        plan = up.up4_conv_bwd_plan(H, H, C, 1)
        check(plan["wide"] and plan["Cp"] == 64 * boxes, f"up4_conv_bwd ({H},{H},{C}): plan "
              f"{plan}")
        add("up4_conv_bwd", f"({H},{H},{C}) out 1, wide, Cp={plan['Cp']}",
            up.up4_conv_bwd, up.up4_conv_bwd_reference,
            (*head(H, C), rand(B, H, H, 16)), {}, up4_bwd_cost(B, H, C, 1), grads=UP4_GRADS,
            launches=up.UP4_CONV_BWD_WIDE_LAUNCHES)
    return cases


def scaled_train_kernel_phase(results: dict):
    """The scaled training step's kernel forms against their plain versions
    at batch 2 (``scaled_train_cases``): forwards under the forward limits,
    backwards under the backward ones, launches per call, each timed case
    filed under its wrapper's name + SCALED."""
    import torch

    print("phase: scaled training kernels vs plain versions (bf16, batch 2)")
    gen = torch.Generator(device="cuda").manual_seed(1515)
    for c in scaled_train_cases(gen):
        got = lambda: c["fn"](*c["args"], **c["kw"])
        ref = lambda: c["plain"](*c["args"], **c["kw"])
        label = f"{c['name']} {c['case']}"
        if c["grads"] is None:
            g, r = got(), ref()
            mx, mean = compare(label, g, r, mean_tol=c["mean_tol"])
            if c["name"] == "fused_swin_block" and c["case"].split(", ")[2] == "block":
                c4_reading(label, g, r, c["plain"], c["args"], c["kw"])
        else:
            mx, mean = compare_grads(label, got(), ref(), c["grads"])
        if c["timed"]:
            launches_per_call(c["name"], got, c["launches"])
            record_time(results, c["name"] + SCALED, c["case"], got, ref, c["cost"], mx, mean)


def scaled_train_phase(results: dict) -> dict:
    """One training step of the scaled SUNet (``scaled_config()``, every
    width and depth, seeded weights) at 512x512 on a generated corpus,
    batch 4 (the recipe's OPTIM.BATCH): launches equal to
    ``expected_launches(train=True)`` (48 blocks on #1's train form + #8's
    big-window form, the 8 C=1440 blocks on eager autograd, the head on #5 +
    #9), every plan held by ``scaled_train_cases``; the training gate
    against eager float32 (same weights, batch, drop-path draws); the timed
    and traced fused step (host-paced ms, device busy ms, idle share,
    memory a steady step adds) and the C=1440 stage's eager forward and
    backward against it; then ``python -m sunet_tf_tpu_torch.train`` with
    the config's YAML for 2 steps, a process of its own."""
    import csv
    import gc

    import numpy as np
    import torch
    import yaml

    from sunet_tf_tpu_torch.config import config_to_dict, scaled_config
    from sunet_tf_tpu_torch.data.pipeline import PairDataset, batch_iterator
    from sunet_tf_tpu_torch.data.synth import generate_dataset
    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.train.loop import prepare, step_generators, to_device

    cfg, task, S = scaled_config(), "mask", 512
    B = cfg.optim.batch
    print(f"phase: scaled training step (scaled SUNet, EMB 180, WIN 16, {S}x{S}, batch {B}, "
          "bf16 compute, float32 parameters)")
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        generate_dataset(str(tmp / "train"), 2 * B, size=S, seed=0)
        generate_dataset(str(tmp / "val"), 2, size=S, seed=1)
        ds = PairDataset(str(tmp / "train"), S, train=True, seed=0)
        batch = to_device(next(batch_iterator(ds, B, shuffle=True, drop_last=True, seed=0)),
                          "cuda")
        inp, tar = prepare(batch, task, 50.0, step_generators(0, 0, "cuda")[0])
        eager_blocks = 8   # the C=1440 stage, above JAX's train cap 768
        gate = None
        try:
            gate = train_gate(cfg, task, inp, tar, ("fused",), eager_blocks=eager_blocks)
        except torch.cuda.OutOfMemoryError as e:
            reason = str(e).splitlines()[0]
        if gate is None:   # the failed attempt's tensors are gone with its frames
            print(f"  the gate's steps do not fit at batch {B} ({reason}); the gate runs at "
                  "batch 2")
            gc.collect()
            torch.cuda.empty_cache()
            B = 2
            gate = train_gate(cfg, task, inp[:B], tar[:B], ("fused",), eager_blocks=eager_blocks)
        out["gate_batch"] = B
        models, step = gate["models"], gate["step"]
        launches = step["fused"]["launches"]
        check(launches["swin_block_bwd"] == 48 * wa.SWIN_BLOCK_BWD_BIG_LAUNCHES,
              f"swin_block_bwd launches {launches['swin_block_bwd']}")
        for k, v in launches.items():
            if v > 0:
                results.setdefault(k + SCALED, {"max_abs_err": 0.0, "cases": []})[
                    "train_launches"] = v
        del models["eager"]
        torch.cuda.empty_cache()
        B = cfg.optim.batch
        times, fns = step_times(cfg, task, {"fused": models["fused"]}, step, batch)
        counter = iter(range(100, 10_000))
        trace = trace_step(lambda f=fns["fused"]: f.train_step(batch, next(counter),
                                                               f.init_metrics()),
                           f"fused training step, scaled SUNet, batch {B}")
        # the C=1440 stage's eager forward and backward at the step's shape
        model = models["fused"]
        stage = model.layers[-1]
        x = torch.randn(B, S // 32, S // 32, stage.blocks[0].dim, device="cuda",
                        dtype=torch.bfloat16, requires_grad=True)
        g = torch.Generator(device="cuda").manual_seed(3)

        def stage_step():
            y = x
            for blk in stage.blocks:
                y = blk(y, g)
            y.float().square().mean().backward()

        stage_ms = time_ms(stage_step, iters=5, warmup=2)
        model.zero_grad(set_to_none=True)
        busy = trace.get("busy_ms")
        print(f"  scaled step (batch {B}): host-paced {times['fused']:.3f} ms, device busy "
              + (f"{busy:.3f} ms of {trace['wall_ms']:.3f} ms traced (idle share "
                 f"{1 - busy / trace['wall_ms']:.3f})" if busy else "not measured")
              + f"; a steady step adds {step['fused']['step_added_bytes'] / 2**30:.3f} GiB; "
              f"the C=1440 stage's eager forward + backward {stage_ms:.3f} ms of device time"
              + (f" ({stage_ms / busy:.3f} of the step's busy time)" if busy else ""))
        out.update({"step_ms": times["fused"], "trace": trace, "stage1440_ms": stage_ms,
                    "step_added_bytes": step["fused"]["step_added_bytes"],
                    "first_step_peak_bytes": step["fused"]["first_peak_bytes"],
                    "loss_rel_diff": step["fused"]["loss_rel_diff"],
                    "worst_grad_cos": step["fused"]["worst_grad_cos"],
                    "worst_grad_rel_l2": step["fused"]["worst_grad_rel_l2"],
                    "launches": launches})
        del models, fns, model, stage, x
        torch.cuda.empty_cache()

        print("phase: scaled training entry point (1 epoch of 2 steps, one val pass)")
        raw = config_to_dict(cfg)
        raw["TRAINING"].update({"TRAIN_DIR": str(tmp / "train"), "VAL_DIR": str(tmp / "val"),
                                "SAVE_DIR": str(tmp / "ck")})
        (tmp / "scaled.yaml").write_text(yaml.safe_dump(raw))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "sunet_tf_tpu_torch.train", "--config",
             str(tmp / "scaled.yaml"), "--epochs", "1", "--steps-per-epoch", "2",
             "--device", "cuda"], cwd=ROOT, capture_output=True, text=True, timeout=900)
        fit_s = time.perf_counter() - t0
        print("\n".join("  | " + ln for ln in proc.stdout.strip().splitlines()[-6:]))
        check(proc.returncode == 0, f"scaled training CLI exited {proc.returncode}: "
              f"{proc.stderr.strip()[-2000:]}")
        ckpt = tmp / "ck" / cfg.mode / "models" / "latest.pth"
        check(ckpt.is_file(), "no latest checkpoint written")
        with open(tmp / "ck" / cfg.mode / "log" / "metrics_per_epoch.csv") as f:
            rows = list(csv.DictReader(f))
        check(len(rows) == 1 and np.isfinite(float(rows[0]["Train_LOSS"]))
              and rows[0].get("Val_LOSS", "") != "", f"metrics rows {rows}")
        print(f"  CLI: {fit_s:.1f} s wall, train loss {float(rows[0]['Train_LOSS']):.6f}, "
              f"val loss {float(rows[0]['Val_LOSS']):.6f}, checkpoint "
              f"{ckpt.stat().st_size / 2**20:.1f} MiB")
        out["cli_seconds"] = fit_s
    return out


# ------------------------------------------------------------ the parallel tier

# The shards of Config()'s Swin stages at 256x256 over two spatial ranks
# (local H, W, C): the B5 form's shapes on the main path.
B5_SHARDS = ((32, 64, 96), (16, 32, 192), (8, 16, 384))
# Config()'s C=768 stage at 512x512 over two spatial ranks: a rank's (local
# H, W, C) of the 16 x 16 map (the runner takes it in training alone: the
# inference cap is 384).
B5_C768_SHARD = (8, 16, 768)
# The scaled config's first stage at 512x512 over two spatial ranks: (B,
# local H, W, C), head dim 30.
B5_SCALED_SHARD = (1, 64, 128, 180)
# One rank group's limit (rendezvous, build, every check): a rank that
# outlasts it fails the phase.
RANKS_TIMEOUT_S = 600
RANKS_LABEL = "two ranks sharing one H100, not a scaling figure"


def shard_mask(H: int, W: int, ws: int, shift: int, index: int, n: int = 2):
    """Rows of spatial shard ``index`` of ``n`` of the rolled-space SW-MSA
    mask of an H x W map (``parallel.spatial``'s slice)."""
    import torch

    from sunet_tf_tpu_torch.ops.window import shift_attn_mask

    full = torch.as_tensor(shift_attn_mask(H, W, ws, shift), device="cuda")
    k = (H // n // ws) * (W // ws)
    return full[index * k:(index + 1) * k].contiguous()


def b5_cases(gen, B: int = 2) -> list:
    """The B5 form (the block kernel and #8 at shift 0 with a shard's slice
    of the SW-MSA mask as an input): #1's inference form, its train form
    (drop-path scales) and #8 on each shard of ``B5_SHARDS`` (spatial rank
    1's rows: the mask's second half); the sequence form's train form at 64
    tokens (on the whole map's plan) and #8 at head dim 96 on
    ``B5_C768_SHARD``; the sequence form's train form and #8's big-window
    form on ``B5_SCALED_SHARD``. Dicts as
    ``scaled_train_cases``' with the name they are filed under."""
    import torch

    from sunet_tf_tpu_torch.kernels import window_attention as wa

    rand = lambda *s: torch.randn(*s, device="cuda", generator=gen).to(torch.bfloat16)
    cases = []

    def add(name, case, fn, plain, args, kwargs, cost, grads=None, mean_tol=MEAN_TOL,
            launches=None, timed=True):
        counter = "fused_swin_block" if grads is None else "swin_block_bwd"
        cases.append(dict(name=name, case=case, fn=fn, plain=plain, args=args, kw=kwargs,
                          cost=cost, grads=grads, mean_tol=mean_tol, launches=launches,
                          timed=timed, counter=counter))

    ws, heads, scale = 8, 8, 8.0
    dp = torch.tensor([[1 / 0.9, 1 / 0.9], [1 / 0.9, 0.0]], device="cuda")
    for H, W, C in B5_SHARDS:
        p, x, dout = block_params(C, heads, ws * ws, gen), rand(B, H, W, C), rand(B, H, W, C)
        mask = shard_mask(2 * H, W, ws, ws // 2, 1)
        blk = (x, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10], p[11], p[12], mask)
        kw = dict(ws=ws, num_heads=heads, scale=scale, shift=0)
        case = f"({H},{W},{C}) shift 0, mask slice"
        cost = block_cost(B, H, C, ws, heads=heads, masked=True, W=W)
        add("fused_swin_block[B5]", case, wa.fused_swin_block, wa.fused_swin_block_reference,
            blk, kw, cost, launches=1)
        add("swin_block_trainable_dynmask", case + ", train form", wa.fused_swin_block,
            wa.fused_swin_block_reference, blk + (dp,), kw, cost, launches=1)
        add("swin_block_trainable_dynmask_bwd", case,
            wa.swin_block_bwd, wa.swin_block_bwd_reference,
            (x, dout, *blk[1:], dp), kw,
            block_bwd_cost(B, H, C, ws, heads=heads, masked=True, W=W), grads=BLOCK_GRADS,
            launches=wa.SWIN_BLOCK_BWD_LAUNCHES)

    # the C=768 shard: the sequence form's train form at 64 tokens (on the
    # whole map's plan, as the runner launches it) and #8 at head dim 96
    H, W, C = B5_C768_SHARD
    p, x, dout = block_params(C, heads, ws * ws, gen), rand(B, H, W, C), rand(B, H, W, C)
    mask = shard_mask(2 * H, W, ws, ws // 2, 1)
    kw = dict(ws=ws, num_heads=heads, scale=scale, shift=0)
    case = f"({H},{W},{C}) shift 0, mask slice, head dim {C // heads}"
    on_map = functools.partial(wa.fused_swin_block, plan_hw=(2 * H, W))
    for half, q in seq_halves(p).items():
        add("swin_block_trainable_dynmask", f"{case}, train form on the sequence form, {half}",
            on_map, wa.fused_swin_block_reference,
            (x, q[0:2], q[2], q[3], q[4], q[5], q[6:8], q[8], q[9], q[10], q[11], q[12], mask,
             dp), kw, block_cost(B, H, C, ws, heads=heads, masked=True, W=W),
            mean_tol=SEQ_BLOCK_MEAN_TOL if half == "block" else MEAN_TOL,
            launches=wa.SWIN_BLOCK_SEQ_LAUNCHES, timed=half == "block")
    add("swin_block_trainable_dynmask_bwd", case, wa.swin_block_bwd, wa.swin_block_bwd_reference,
        (x, dout, p[0:2], *p[2:6], p[6:8], *p[8:12], p[12], mask, dp), kw,
        block_bwd_cost(B, H, C, ws, heads=heads, masked=True, W=W), grads=BLOCK_GRADS,
        launches=wa.SWIN_BLOCK_BWD_LAUNCHES)

    Bs, H, W, C = B5_SCALED_SHARD
    heads, ws = C // 30, SCALED_WS
    p, x, dout = block_params(C, heads, ws * ws, gen), rand(Bs, H, W, C), rand(Bs, H, W, C)
    mask, dps = shard_mask(2 * H, W, ws, ws // 2, 1), scaled_dp(gen, Bs)
    kw = dict(ws=ws, num_heads=heads, scale=SCALED_QK, shift=0)
    case = f"({H},{W},{C}) shift 0, mask slice, {heads} heads"
    for half, q in seq_halves(p).items():
        add("fused_swin_block" + SCALED, f"B5 train form {case}, {half}", wa.fused_swin_block,
            wa.fused_swin_block_reference,
            (x, q[0:2], q[2], q[3], q[4], q[5], q[6:8], q[8], q[9], q[10], q[11], q[12], mask,
             dps), kw, block_cost(Bs, H, C, ws, heads=heads, masked=True, W=W),
            mean_tol=SEQ_BLOCK_MEAN_TOL if half == "block" else MEAN_TOL,
            launches=wa.SWIN_BLOCK_SEQ_LAUNCHES, timed=half == "block")
    add("swin_block_bwd" + SCALED, f"B5 {case}", wa.swin_block_bwd, wa.swin_block_bwd_reference,
        (x, dout, p[0:2], *p[2:6], p[6:8], *p[8:12], p[12], mask, dps), kw,
        block_bwd_cost(Bs, H, C, ws, heads=heads, masked=True, W=W), grads=BLOCK_GRADS,
        launches=wa.SWIN_BLOCK_BWD_BIG_LAUNCHES)
    return cases


def b5_kernel_phase(results: dict):
    """The B5 form's kernels against their plain versions (``b5_cases``),
    timed and filed; and ``swin_block_trainable_dynmask`` (the autograd
    Function the spatial runner calls) equal, forward and dx, to the wrapper
    calls it makes."""
    import torch

    from sunet_tf_tpu_torch.kernels import window_attention as wa

    print("phase: the B5 form (shift 0, a shard's mask slice) vs plain versions (bf16)")
    gen = torch.Generator(device="cuda").manual_seed(1717)
    for c in b5_cases(gen):
        got = lambda: c["fn"](*c["args"], **c["kw"])
        ref = lambda: c["plain"](*c["args"], **c["kw"])
        label = f"{c['name']} {c['case']}"
        if c["grads"] is None:
            mx, mean = compare(label, got(), ref(), mean_tol=c["mean_tol"])
        else:
            mx, mean = compare_grads(label, got(), ref(), c["grads"])
        if c["timed"]:
            launches_per_call(c["counter"], got, c["launches"])
            record_time(results, c["name"], c["case"], got, ref, c["cost"], mx, mean)
    # the Function: forward and dx through autograd equal the wrapper calls
    H, W, C = B5_SHARDS[0]
    p = block_params(C, 8, 64, gen)
    x = torch.randn(2, H, W, C, device="cuda", generator=gen).to(torch.bfloat16)
    dout = torch.randn(2, H, W, C, device="cuda", generator=gen).to(torch.bfloat16)
    mask, dp = shard_mask(2 * H, W, 8, 4, 1), torch.ones(2, 2, device="cuda")
    f32 = [t.float().requires_grad_(True) for t in p]
    xg = x.clone().requires_grad_(True)
    y = wa.swin_block_trainable_dynmask(xg, *f32[:12], f32[12], dp, mask, 8, 8, 8.0)
    y.backward(dout)
    kw = dict(ws=8, num_heads=8, scale=8.0, shift=0)
    want = wa.fused_swin_block(x, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10],
                               p[11], p[12], mask, dp, **kw)
    dx = wa.swin_block_bwd(x, dout, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10],
                           p[11], p[12], mask, dp, **kw)[0]
    check(torch.equal(y.detach(), want) and torch.equal(xg.grad, dx),
          "swin_block_trainable_dynmask differs from the wrapper calls it makes")
    print("  swin_block_trainable_dynmask: forward and dx equal the wrapper calls bit for bit")


def mask_batch_u8(B: int, S: int, seed: int) -> dict:
    """A uint8 mask-task batch on the card: random input, blob targets."""
    import numpy as np

    from sunet_tf_tpu_torch.train.loop import to_device

    rng = np.random.default_rng(seed)
    tar = (rng.random((B, S // 16, S // 16, 1)) > 0.6).astype(np.uint8) * 255
    tar = np.repeat(np.repeat(tar, 16, axis=1), 16, axis=2)
    return to_device({"input": rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8),
                      "target": tar}, "cuda")


class GradTap:
    """An optimizer that keeps a copy of the gradients it is given before
    its own ``step``: the step's gradient, after the data tier's reduction."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def zero_grad(self):
        self.opt.zero_grad()

    def step(self):
        self.grads = [None if p.grad is None else p.grad.detach().clone()
                      for p in self.opt.params]
        self.opt.step()


def gate_vs(name: str, model, grads: list, ref_grads: list) -> dict:
    """Every parameter's gradient against the reference step's under the
    training gate (``grad_limits``); returns the worst tensor's reading."""
    readings = []
    for (pname, prm), g, r in zip(model.named_parameters(), grads, ref_grads):
        if r is None or g is None:
            check(g is None and r is None, f"{name}: {pname} has a gradient on one side only")
            continue
        cos, rl2 = grad_distance(g.double().flatten(), r.double().flatten())
        cos_lim, rl2_lim = grad_limits(prm.numel())
        readings.append((gate_share(cos, rl2, cos_lim, rl2_lim), pname, cos, rl2))
    readings.sort(reverse=True)
    share, pname, cos, rl2 = readings[0]
    beyond = [r for r in readings if r[0] > 1]
    print(f"  {name}: worst gradient {pname}: cos {cos:.6f} rel-L2 {rl2:.3e} "
          f"({share:.3f} of its limits) {'ok' if share <= 1 else 'FAIL'}; "
          f"{len(beyond)} of {len(readings)} tensors beyond"
          + "".join(f"\n    {n}: cos {c:.6f} rel-L2 {e:.3e}" for _, n, c, e in beyond[:12]))
    check(share <= 1, f"{name}: gradient of {pname} outside the training gate")
    return {"worst_tensor": pname, "cos": cos, "rel_l2": rl2, "gate_share": share}


def params_digest(model) -> str:
    """A hash of every parameter's bits."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for prm in model.parameters():
        h.update(prm.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def counted(fn, names) -> tuple:
    """(fn's result, the launches of each wrapper of ``names`` during it)."""
    import torch

    from sunet_tf_tpu_torch.kernels import _build

    torch.cuda.synchronize()
    _build.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: _build.counter(k).cuda for k in names}


def world1_rank(rank: int, device) -> dict:
    """World size 1 over NCCL, ``Config()`` at full width, batch 4: the
    training step, an eval pass and a 1024x1024 tiled image with the mesh
    against the same without it, bit for bit; the step's launches. The
    steps run with PyTorch's deterministic algorithms (the plain ops'
    backwards, e.g. the rel-pos bias gather's, otherwise add with atomics
    in any order; the kernels' reductions are deterministic): the one-process
    step twice equal is the control."""
    import copy

    import torch

    from sunet_tf_tpu_torch.config import Config
    from sunet_tf_tpu_torch.infer.tiled import tiled_inference
    from sunet_tf_tpu_torch.models.sunet import TRAIN_WRAPPERS, build_model
    from sunet_tf_tpu_torch.parallel.mesh import make_mesh
    from sunet_tf_tpu_torch.train.loop import build_steps
    from sunet_tf_tpu_torch.train.trainer import make_optimizer

    torch.use_deterministic_algorithms(True, warn_only=True)
    mesh = make_mesh(1, 1)
    cfg = Config()
    batch = mask_batch_u8(4, 256, 5)
    base = build_model(cfg, device=device, backend="fused", seed=0).train().requires_grad_(True)
    out = {"backend": mesh.backend, "world": 1}
    runs = {}
    for who, m in (("one process", None), ("control", None), ("mesh", mesh)):
        model = copy.deepcopy(base)
        fns = build_steps(model, make_optimizer(cfg, model, 1), task="mask", seed=0, mesh=m)
        (scalars, _), launches = counted(lambda: fns.train_step(batch, 0, fns.init_metrics()),
                                         TRAIN_WRAPPERS)
        runs[who] = (model, fns, {k: float(v) for k, v in scalars.items()}, launches)
    (m1, f1, s1, _), (m2, f2, s2, l2) = runs["one process"], runs["mesh"]
    same = lambda a, b: runs[a][2] == runs[b][2] and all(
        torch.equal(x, y) for x, y in zip(runs[a][0].parameters(), runs[b][0].parameters()))
    out["step_loss"] = (s1["loss"], s2["loss"])
    out["control_bit_equal"] = same("one process", "control")
    out["step_bit_equal"] = same("one process", "mesh")
    del runs["control"]
    out["step_launches_ok"] = l2 == m2.expected_launches((4, 256, 256, 3), train=True)
    evb = dict(batch, valid=torch.tensor([1.0, 1.0, 1.0, 0.0], device=device))
    e1, h1 = f1.eval_step(evb, f1.init_metrics())
    e2, h2 = f2.eval_step(evb, f2.init_metrics())
    out["eval_sums"] = {k: float(v) for k, v in e2.items()}
    out["eval_bit_equal"] = (all(torch.equal(e1[k], e2[k]) for k in e1)
                             and all(torch.equal(h1[k], h2[k]) for k in h1))
    m1.eval()
    img = torch.rand(1, 1024, 1024, 3, device=device,
                     generator=torch.Generator(device=device).manual_seed(13))
    with torch.inference_mode():
        y1 = tiled_inference(m1, img, kernel=256, stride=128)
        y2 = tiled_inference(m1, img, kernel=256, stride=128, mesh=mesh)
    out["tiled_bit_equal"] = torch.equal(y1, y2)
    counter = iter(range(1, 1000))
    for who in runs:
        f = runs[who][1]
        out[f"step_ms {who}"] = time_ms(lambda: f.train_step(batch, next(counter),
                                                             f.init_metrics()),
                                        iters=5, warmup=1, device=False)
    return out


def shared_card_rank(rank: int, device) -> dict:
    """Two ranks on one card over gloo, ``Config()``: the data tier (2, 1)
    at batch 4 (2 + 2) and with 3 valid rows (2 + 1), drop-path 0, against
    the one-process step in this rank; the spatial tier (1, 2) at batch 2,
    its forward and one training step against one process (on the
    recompute route, which the runner's blocks take); a 1024x1024 tiled
    image over the two data ranks; launches and plans of each. The steps
    run with PyTorch's deterministic algorithms, so that each comparison
    reads the tier alone, not the order of the plain backwards' atomics
    (which moves a one-value gradient's cancelling sum far)."""
    import copy

    import torch

    from sunet_tf_tpu_torch.config import Config
    from sunet_tf_tpu_torch.infer.tiled import tiled_inference
    from sunet_tf_tpu_torch.models import layers
    from sunet_tf_tpu_torch.models.sunet import INFER_WRAPPERS, TRAIN_WRAPPERS, build_model
    from sunet_tf_tpu_torch.parallel.mesh import data_rows, make_mesh
    from sunet_tf_tpu_torch.parallel.spatial import SpatialStageRunner
    from sunet_tf_tpu_torch.train.loop import (build_steps, model_generator, prepare,
                                               step_generators)
    from sunet_tf_tpu_torch.train.trainer import make_optimizer

    torch.use_deterministic_algorithms(True, warn_only=True)
    data = make_mesh(data=2, spatial=1)
    spatial = make_mesh(data=1, spatial=2)
    out = {"backend": data.backend, "world": 2}
    cfg0 = Config()
    cfg = cfg0.replace(swinunet=cfg0.swinunet.__class__(
        **{**cfg0.swinunet.__dict__, "drop_path_rate": 0.0}))
    base = build_model(cfg, device=device, backend="fused", seed=0).train().requires_grad_(True)

    def step(model_src, b, mesh=None, runner=None, c=cfg):
        model = copy.deepcopy(model_src)
        opt = GradTap(make_optimizer(c, model, 1))
        fns = build_steps(model, opt, task="mask", seed=0, mesh=mesh, stage_runner=runner)
        (scalars, _), launches = counted(lambda: fns.train_step(b, 0, fns.init_metrics()),
                                         TRAIN_WRAPPERS)
        return model, opt.grads, float(scalars["loss"]), launches, fns

    # the data tier, batch 4 as 2 + 2
    batch = mask_batch_u8(4, 256, 7)
    one, g_one, l_one, _, f_one = step(base, batch)
    plans = set()
    with plans_taken(plans):
        m_d, g_d, l_d, launches, f_d = step(base, batch, data)
    out["data_plans"] = plans
    out["data_launches"] = launches
    out["data_launches_ok"] = launches == m_d.expected_launches((2, 256, 256, 3), train=True)
    out["data_loss"] = (l_one, l_d)
    out["data_gate"] = gate_vs(f"data tier rank {rank}", m_d, g_d, g_one)
    out["data_digest"] = params_digest(m_d)
    # each rank's logits against the one-process rows (drop-path 0: no draw)
    inp, _ = prepare(batch, "mask", 50.0, step_generators(0, 0, device)[0])
    rows = data_rows(data, 4)
    with torch.no_grad():
        full = base(inp, generator=step_generators(0, 0, device)[1])
        mine = base(inp[rows], generator=model_generator(0, 0, device, data.data_index, 2))
    d = (mine - full[rows]).abs()
    out["logits"] = {"bit_equal": bool(torch.equal(mine, full[rows])),
                     "max_abs_diff": float(d.max()), "mean_abs_diff": float(d.mean())}
    counter = iter(range(1, 1000))
    out["step_ms one process"] = time_ms(lambda: f_one.train_step(
        batch, next(counter), f_one.init_metrics()), iters=5, warmup=1, device=False)
    out["step_ms data rank"] = time_ms(lambda: f_d.train_step(
        batch, next(counter), f_d.init_metrics()), iters=5, warmup=1, device=False)
    del one, m_d, f_one, f_d, g_one, g_d

    # 3 valid rows, 2 + 1, against the one-process step on those 3
    b3 = {k: v[:3] for k, v in batch.items()}
    bpad = dict(batch, valid=torch.tensor([1.0, 1.0, 1.0, 0.0], device=device))
    one3, g3, l3, _, _ = step(base, b3)
    m_p, g_p, l_p, _, _ = step(base, bpad, data)
    out["valid3_loss"] = (l3, l_p)
    out["valid3_gate"] = gate_vs(f"3 valid rows rank {rank}", m_p, g_p, g3)
    out["valid3_digest"] = params_digest(m_p)
    del one3, m_p, g3, g_p, base
    torch.cuda.empty_cache()

    # the spatial tier (1, 2), batch 2, Config() with its drop-path rate
    sbase = build_model(cfg0, device=device, backend="fused", seed=0)
    runner = SpatialStageRunner(spatial)
    x = torch.rand(2, 256, 256, 3, device=device,
                   generator=torch.Generator(device=device).manual_seed(21))
    with torch.inference_mode():
        y_one = sbase(x)
        y_sp, launches = counted(lambda: sbase(x, stage_runner=runner), INFER_WRAPPERS)
    d = (y_sp - y_one).abs()
    out["spatial_forward"] = {"max_abs_diff": float(d.max()), "mean_abs_diff": float(d.mean()),
                              "bit_equal": bool(torch.equal(y_sp, y_one)),
                              "finite": bool(torch.isfinite(y_sp).all())}
    out["spatial_forward_launches"] = launches
    out["spatial_forward_launches_ok"] = launches == sbase.expected_launches(
        tuple(x.shape), runner=runner)
    H = 256 // cfg0.swinunet.patch_size
    n = cfg0.swinunet.num_stages
    stages = [(f"encoder {i}", s, i) for i, s in enumerate(sbase.layers)]
    stages += [(f"decoder {j}", s, n - 1 - j) for j, s in enumerate(sbase.layers_up[1:], 1)]
    out["stages_taken"] = {
        f"{name} ({H >> lv}x{H >> lv}, C={s.blocks[0].dim})": runner.applies(
            list(s.blocks), (2, H >> lv, H >> lv, s.blocks[0].dim), True)
        for name, s, lv in stages}
    sbase.train().requires_grad_(True)
    b2 = mask_batch_u8(2, 256, 9)
    # the reference: the one-process step on the recompute route, the route
    # the runner's blocks take (JAX's runner too; the default trains C=96 and
    # 192 on the residual route, other rounding points)
    layers.ROUTE_TRAIN_RESID = False
    try:
        _, g1, l1, _, _ = step(sbase, b2, c=cfg0)
    finally:
        layers.ROUTE_TRAIN_RESID = True
    plans = set()
    with plans_taken(plans):
        m_s, g_s, l_s, launches, f_s = step(sbase, b2, spatial, runner, c=cfg0)
    out["spatial_plans"] = plans
    out["spatial_launches"] = launches
    out["spatial_launches_ok"] = launches == m_s.expected_launches(
        (2, 256, 256, 3), train=True, runner=runner)
    out["spatial_loss"] = (l1, l_s)
    out["spatial_gate"] = gate_vs(f"spatial tier rank {rank}", m_s, g_s, g1)
    out["spatial_digest"] = params_digest(m_s)
    out["step_ms spatial rank"] = time_ms(lambda: f_s.train_step(
        b2, next(counter), f_s.init_metrics()), iters=3, warmup=1, device=False)
    del m_s, g_s, g1, f_s
    torch.cuda.empty_cache()

    # tiled over the two data ranks
    sbase.eval()
    img = torch.rand(1, 1024, 1024, 3, device=device,
                     generator=torch.Generator(device=device).manual_seed(13))
    with torch.inference_mode():
        t_one = tiled_inference(sbase, img, kernel=256, stride=128)
        t_mesh = tiled_inference(sbase, img, kernel=256, stride=128, mesh=data)
    out["tiled_bit_equal"] = bool(torch.equal(t_one, t_mesh))
    out["tiled_max_abs_diff"] = float((t_one - t_mesh).abs().max())
    return out


def parallel_phase(results: dict, held: bool) -> dict:
    """The parallel tier on the card: world size 1 over NCCL (bit for bit
    against one process), then two ranks sharing the card over gloo (data
    and spatial tiers under the gates, tiled bit for bit). The kernels were
    built by this process; the ranks load them. ``held``: the per-kernel
    checks of every form ran in this process, so every plan the ranks take
    must be one they held."""
    from sunet_tf_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    print("phase: parallel tier (torch.distributed; ranks spawned, kernels built above)")
    w1, = run_ranks(world1_rank, 1, backend="nccl", device="cuda:0",
                    timeout_s=RANKS_TIMEOUT_S, env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
    print(f"  world size 1, backend {w1['backend']}: step loss {w1['step_loss'][1]:.6f}, "
          f"bit for bit {w1['step_bit_equal']} (control: the one-process step twice "
          f"{w1['control_bit_equal']}); eval sums bit for bit {w1['eval_bit_equal']}; "
          f"1024x1024 tiled bit for bit {w1['tiled_bit_equal']}; step launches as expected "
          f"{w1['step_launches_ok']}")
    print(f"    host-paced step ms (deterministic algorithms): one process "
          f"{w1['step_ms one process']:.3f}, with the NCCL mesh {w1['step_ms mesh']:.3f}")
    check(w1["control_bit_equal"], "world size 1: the one-process step is not reproducible")
    check(w1["step_bit_equal"], "world size 1: the step with the mesh differs from without")
    check(w1["eval_bit_equal"], "world size 1: eval sums differ")
    check(w1["tiled_bit_equal"], "world size 1: tiled output differs")
    check(w1["step_launches_ok"], "world size 1: step launches differ from expected_launches")

    ranks = run_ranks(shared_card_rank, 2, backend="gloo", device="cuda:0",
                      timeout_s=RANKS_TIMEOUT_S, env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
    r0, r1 = ranks
    print(f"  two ranks, backend {r0['backend']} ({RANKS_LABEL}):")
    for r, rk in enumerate(ranks):
        lg = rk["logits"]
        print(f"    rank {r}: data tier logits vs the one-process rows: bit for bit "
              f"{lg['bit_equal']}, max|diff| {lg['max_abs_diff']:.3e} mean|diff| "
              f"{lg['mean_abs_diff']:.3e}")
        check(lg["mean_abs_diff"] <= SLICE_MEAN_TOL, f"rank {r}: logits outside the forward gate")
        for what in ("data", "valid3"):
            lo, lm = rk[f"{what}_loss"]
            rel = abs(lm - lo) / abs(lo)
            print(f"    rank {r}: {what} step loss {lm:.7f} vs one process {lo:.7f} "
                  f"(rel {rel:.2e}, limit 1e-5)")
            check(rel <= 1e-5, f"rank {r}: {what} step loss differs from one process")
        check(rk["data_launches_ok"], f"rank {r}: data step launches differ from expected")
        check(rk["spatial_launches_ok"] and rk["spatial_forward_launches_ok"],
              f"rank {r}: spatial launches differ from expected: {rk['spatial_launches']}")
        sf = rk["spatial_forward"]
        print(f"    rank {r}: spatial forward vs unsharded: max|diff| {sf['max_abs_diff']:.3e} "
              f"mean|diff| {sf['mean_abs_diff']:.3e} (limit {SLICE_MEAN_TOL}), bit for bit "
              f"{sf['bit_equal']}")
        check(sf["finite"] and sf["mean_abs_diff"] <= SLICE_MEAN_TOL,
              f"rank {r}: spatial forward outside the forward gate")
        lo, ls = rk["spatial_loss"]
        print(f"    rank {r}: spatial step loss {ls:.7f} vs one process {lo:.7f} (rel "
              f"{abs(ls - lo) / abs(lo):.2e}, limit {TRAIN_LOSS_RTOL})")
        check(abs(ls - lo) <= TRAIN_LOSS_RTOL * abs(lo), f"rank {r}: spatial loss")
        check(rk["tiled_bit_equal"], f"rank {r}: tiled over two ranks differs from one "
              f"process (max|diff| {rk['tiled_max_abs_diff']:.3e})")
        print(f"    rank {r}: host-paced step ms (deterministic algorithms), one process "
              f"{rk['step_ms one process']:.3f}, "
              f"data rank {rk['step_ms data rank']:.3f}, spatial rank (batch 2) "
              f"{rk['step_ms spatial rank']:.3f}")
        if held:
            for what in ("data_plans", "spatial_plans"):
                check(rk[what] <= HELD_PLANS, f"rank {r}: launch plans no per-kernel check held: "
                      f"{sorted(rk[what] - HELD_PLANS)}")
    print("    stages the spatial runner took: " + ", ".join(
        f"{k} {'yes' if v else 'no (replicated)'}" for k, v in r0["stages_taken"].items()))
    for what in ("data", "valid3", "spatial"):
        check(r0[f"{what}_digest"] == r1[f"{what}_digest"],
              f"{what}: the two ranks' parameters differ after the update")
    print("    both ranks' parameters equal bit for bit after each update; the 1024x1024 "
          "tiled image over two ranks equals one process bit for bit")
    launches = r0["spatial_launches"]
    results.setdefault("swin_block_trainable_dynmask", {"max_abs_err": 0.0, "cases": []})[
        "launches"] = launches["fused_swin_block"]
    results.setdefault("swin_block_trainable_dynmask_bwd", {"max_abs_err": 0.0, "cases": []})[
        "launches"] = launches["swin_block_bwd"]
    results.setdefault("fused_swin_block[B5]", {"max_abs_err": 0.0, "cases": []})[
        "launches"] = r0["spatial_forward_launches"]["fused_swin_block"]
    for name in ("swin_block_trainable_dynmask", "swin_block_trainable_dynmask_bwd",
                 "fused_swin_block[B5]"):
        check(results[name]["launches"] > 0, f"{name}: never launched on the spatial path")
    wall = time.perf_counter() - t0
    print(f"  parallel phase: {wall:.1f} s wall")
    return {"world1": w1, "ranks": [{k: v for k, v in rk.items() if not k.endswith("_plans")}
                                    for rk in ranks], "label": RANKS_LABEL, "wall_s": wall}


# The data phase's dropout rates (SWINUNET.DROP_RATE and ATTN_DROP_RATE, test
# values: the reference recipe trains with both at 0) and the limit of each
# dropout site's keep fraction, in binomial standard deviations of 1 - rate.
DATA_DROP_RATE = 0.1
KEEP_SIGMAS = 5.0
# The data tier's corpus: pairs of 256x256 PNGs, and the training batch.
DATA_PAIRS = 64
DATA_BATCH = 4
# A block's dropout sites in call order (after the features dropout).
DROP_SITES = ("probabilities", "projection", "gelu", "fc2")


def dropout_config(cfg, rate: float = DATA_DROP_RATE, use_checkpoint: bool = False):
    """``cfg`` with DROP_RATE = ATTN_DROP_RATE = ``rate`` and
    USE_CHECKPOINTS ``use_checkpoint``."""
    import dataclasses

    return cfg.replace(swinunet=dataclasses.replace(
        cfg.swinunet, drop_rate=rate, attn_drop_rate=rate, use_checkpoint=use_checkpoint))


def model_blocks(model) -> list:
    """The model's Swin blocks in the order a forward runs them."""
    return [b for st in list(model.layers) + list(model.layers_up[1:]) for b in st.blocks]


@contextlib.contextmanager
def dropout_sites(into: list):
    """Records each ``layers.dropout`` call for the duration: (dtype, shape,
    kept elements, nonzero elements of its input) on the device; an input
    element that is 0 tells nothing of its mask."""
    import torch

    from sunet_tf_tpu_torch.models import layers

    plain = layers.dropout

    def dropout(x, rate, generator):
        y = plain(x, rate, generator)
        if generator is not None and rate > 0 and torch.is_grad_enabled():
            nz = x.detach() != 0
            into.append((x.dtype, tuple(x.shape), ((y.detach() != 0) & nz).sum(), nz.sum()))
        return y

    with patched([(layers, "dropout", dropout)]):
        yield into


def data_step(model, inp, tar, task: str) -> dict:
    """One training forward and backward of ``model`` with the step-0 model
    generator: the loss, every gradient, the launches per wrapper, the
    generator's state after the step and the memory the step added above
    what was allocated before it."""
    import torch

    from sunet_tf_tpu_torch.kernels import _build
    from sunet_tf_tpu_torch.models.sunet import TRAIN_WRAPPERS
    from sunet_tf_tpu_torch.train.loop import loss_and_metrics, step_generators

    model.zero_grad(set_to_none=True)
    gen = step_generators(0, 0, "cuda")[1]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    loss, _, _ = loss_and_metrics(model, inp, tar, gen, torch.ones(inp.shape[0], device="cuda"),
                                  task)
    loss.backward()
    torch.cuda.synchronize()
    out = {"loss": loss.detach().clone(), "gen_state": gen.get_state(),
           "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()
                     if p.grad is not None},
           "launches": {k: _build.counter(k).cuda for k in TRAIN_WRAPPERS},
           "cpu": {k: _build.counter(k).cpu for k in TRAIN_WRAPPERS},
           "added_bytes": torch.cuda.max_memory_allocated() - base}
    model.zero_grad(set_to_none=True)
    return out


def same_bits(a: dict, b: dict) -> bool:
    """Whether two data_step results have the same loss and gradient bits."""
    import torch

    return (torch.equal(a["loss"], b["loss"]) and a["grads"].keys() == b["grads"].keys()
            and all(torch.equal(a["grads"][k], b["grads"][k]) for k in a["grads"]))


def drop_path_replay(model, batch: int):
    """The step-0 model generator's state after drawing only each block's
    drop-path scales, in forward order (the draws of a training forward
    without dropout)."""
    from sunet_tf_tpu_torch.models import layers
    from sunet_tf_tpu_torch.train.loop import step_generators

    gen = step_generators(0, 0, "cuda")[1]
    for blk in model_blocks(model):
        layers.drop_path_scales(batch, blk.drop_path_rate, gen, "cuda")
    return gen.get_state()


def set_checkpointing(model, on: bool):
    for st in list(model.layers) + list(model.layers_up[1:]):
        st.use_checkpoint = on


def dropout_checks(cfg, task: str, inp, tar) -> dict:
    """(a) and (b) of the data phase with dropout: the fused step and the
    fused step under USE_CHECKPOINTS, each held by the training gate
    against float32 eager on the same draws; their loss bits and generator
    states equal; no block kernel, the x4 head's #5 and #9 launched; each
    dropout site's dtype and keep fraction."""
    import torch

    from sunet_tf_tpu_torch.kernels import upsample as up

    dcfg = dropout_config(cfg)
    blocks = sum(cfg.swinunet.depth_en) * 2 - cfg.swinunet.depth_en[-1]
    # a dropout step's bf16 gradients sit farther from float32 than a
    # step's without dropout (on the CPU too, at full depth: the same masks,
    # bf16 rounding alone), for some one-value tensors beyond what a
    # dropped gradient would move; the gate lists those
    gate = train_gate(dcfg, task, inp, tar, ("fused", "fused_ckpt"), eager_blocks=blocks,
                      configs={"fused_ckpt": dropout_config(cfg, use_checkpoint=True)},
                      unresolved_ok=True)
    models, step = gate["models"], gate["step"]
    out = {"blocks_on_eager": blocks,
           "unresolved_one_value": step["fused"]["unresolved_one_value"]}
    for be in ("fused", "fused_ckpt"):
        got = step[be]["launches"]
        block_kernels = {k: v for k, v in got.items()
                         if k not in ("fused_dual_upsample4_conv_phase", "up4_conv_bwd")}
        check(not any(block_kernels.values()), f"{be}: a dropout step launched block kernels: "
              f"{block_kernels}")
        check(got["fused_dual_upsample4_conv_phase"] == 1
              and got["up4_conv_bwd"] == up.up4_conv_bwd_launches(cfg.swinunet.emb_dim),
              f"{be}: the x4 head did not train on #5 and #9: {got}")
        out[f"{be}_launches"] = got
        out[f"{be}_loss_rel_diff"] = step[be]["loss_rel_diff"]
        out[f"{be}_worst_grad_cos"] = step[be]["worst_grad_cos"]
        out[f"{be}_worst_grad_rel_l2"] = step[be]["worst_grad_rel_l2"]
    check(step["fused"]["loss"] == step["fused_ckpt"]["loss"],
          f"USE_CHECKPOINTS changed the dropout step's loss: {step['fused']['loss']!r} vs "
          f"{step['fused_ckpt']['loss']!r}")
    check(torch.equal(step["fused"]["gen_state"], step["fused_ckpt"]["gen_state"]),
          "USE_CHECKPOINTS left the generator in another state")
    print(f"  dropout step: loss {step['fused']['loss']!r} with and without USE_CHECKPOINTS "
          "(equal bits); generator states equal")

    # each site's dtype and keep fraction over one fused step
    sites: list = []
    with dropout_sites(sites):
        data_step(models["fused"], inp, tar, task)
    n_blocks = len(model_blocks(models["fused"]))
    check(len(sites) == 1 + len(DROP_SITES) * n_blocks,
          f"{len(sites)} dropout calls in the forward, expected 1 + 4 x {n_blocks}")
    names = ["features"] + [DROP_SITES[i % 4] for i in range(len(sites) - 1)]
    per: dict = {}
    for name, (dtype, shape, kept, n) in zip(names, sites):
        want = torch.float32 if name == "probabilities" else torch.bfloat16
        check(dtype == want, f"dropout site {name} {shape} ran in {dtype}, not {want}")
        k0, n0 = per.get(name, (0, 0))
        per[name] = (k0 + kept, n0 + n)
    keep = 1.0 - DATA_DROP_RATE
    out["keep"] = {}
    for name, (kept, n) in per.items():
        kept, n = int(kept), int(n)
        frac, sigma = kept / n, (keep * (1 - keep) / n) ** 0.5
        z = (frac - keep) / sigma
        print(f"  dropout site {name}: keep fraction {frac:.7f} of {n} elements, "
              f"{z:+.2f} binomial sigmas from {keep}")
        check(abs(z) <= KEEP_SIGMAS, f"dropout site {name}: keep fraction {frac} is {z:+.2f} "
              f"sigmas from {keep}")
        out["keep"][name] = {"fraction": frac, "n": n, "sigmas": z}
    for be in ("fused", "fused_ckpt"):
        out[f"{be}_added_bytes"] = data_step(models[be], inp, tar, task)["added_bytes"]
    print(f"  dropout step, memory added above the resident state: "
          f"{out['fused_added_bytes'] / 2**30:.3f} GiB, under USE_CHECKPOINTS "
          f"{out['fused_ckpt_added_bytes'] / 2**30:.3f} GiB (no claim)")
    del models, gate
    torch.cuda.empty_cache()
    return out


def rates0_checks(cfg, task: str, inp, tar) -> dict:
    """At dropout rates 0 (``Config()``, drop-path 0.1): the fused step
    equals, bit for bit, the step with the dropout machinery taken out
    (``layers.dropout`` the identity, no block seed drawn); the generator
    drew only the drop-path scales; and under USE_CHECKPOINTS the block
    kernels' autograd Functions run inside checkpoint with their forwards
    launched twice, the same loss bits and generator state, and gradients
    within the training gate's strict limits. Under PyTorch's deterministic
    algorithms (the plain ops' backwards otherwise add with atomics)."""
    import torch

    from sunet_tf_tpu_torch.models import layers
    from sunet_tf_tpu_torch.models.sunet import build_model

    def no_seed(generator):
        raise AssertionError("a block drew a dropout seed at rates 0")

    model = build_model(cfg, device="cuda", backend="fused", seed=0).train().requires_grad_(True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        a = data_step(model, inp, tar, task)
        with patched([(layers, "dropout", lambda x, rate, generator: x),
                      (layers, "block_seed", no_seed)]):
            b = data_step(model, inp, tar, task)
        set_checkpointing(model, True)
        c = data_step(model, inp, tar, task)
        want_ckpt = model.expected_launches(tuple(inp.shape), train=True)
        set_checkpointing(model, False)
    finally:
        torch.use_deterministic_algorithms(False)
    want = model.expected_launches(tuple(inp.shape), train=True)
    check(a["launches"] == want, f"rates 0: launches {a['launches']}, router predicts {want}")
    check(c["launches"] == want_ckpt, f"rates 0 under USE_CHECKPOINTS: launches "
          f"{c['launches']}, router predicts {want_ckpt}")
    check(not any(x["cpu"][k] for x in (a, c) for k in x["cpu"]), "plain versions ran")
    check(same_bits(a, b), "rates 0: the step differs from the step without dropout")
    replay = drop_path_replay(model, inp.shape[0])
    for who, x in (("rates 0", a), ("without dropout", b), ("under USE_CHECKPOINTS", c)):
        check(torch.equal(x["gen_state"], replay), f"{who}: the generator drew more than the "
              "drop-path scales")
    check(torch.equal(a["loss"], c["loss"]), "USE_CHECKPOINTS changed the rates-0 loss")
    worst = (1.0, 0.0)
    for name, g in a["grads"].items():
        cos, rl2 = grad_distance(c["grads"][name].double().flatten(), g.double().flatten())
        worst = (min(worst[0], cos), max(worst[1], rl2))
        check(cos >= TRAIN_GRAD_COS and rl2 <= TRAIN_GRAD_RL2,
              f"USE_CHECKPOINTS: gradient of {name} cos {cos} rl2 {rl2}")
    print(f"  rates 0: the step equals the step without dropout bit for bit; the generator "
          f"drew only the drop-path scales; launches {a['launches']}")
    print(f"  rates 0 under USE_CHECKPOINTS: launches {c['launches']} (each block's forward "
          f"twice); loss bits equal; gradients worst cos {worst[0]:.9f}, worst rl2 "
          f"{worst[1]:.3e} (bit-equal: {same_bits(a, c)})")
    print(f"  rates 0, memory a step adds above the resident state: "
          f"{a['added_bytes'] / 2**30:.3f} GiB, under USE_CHECKPOINTS "
          f"{c['added_bytes'] / 2**30:.3f} GiB (no claim)")
    del model
    torch.cuda.empty_cache()
    return {"launches": a["launches"], "ckpt_launches": c["launches"],
            "ckpt_worst_grad_cos": worst[0], "ckpt_worst_grad_rel_l2": worst[1],
            "ckpt_grads_bit_equal": same_bits(a, c), "added_bytes": a["added_bytes"],
            "ckpt_added_bytes": c["added_bytes"], "loss": float(a["loss"])}


def data_corpus(tmp: Path):
    """The data phase's corpus: synth -> ``python -m
    sunet_tf_tpu_torch.data.patches`` -> ``pack_pair_dataset``, DATA_PAIRS
    pairs of 256x256 under ``tmp/train`` and ``tmp/packed``."""
    from sunet_tf_tpu_torch.data.packed import pack_pair_dataset
    from sunet_tf_tpu_torch.data.synth import generate_dataset

    t0 = time.perf_counter()
    generate_dataset(str(tmp / "full"), DATA_PAIRS, size=256, seed=3)
    proc = subprocess.run(
        [sys.executable, "-m", "sunet_tf_tpu_torch.data.patches", "--src_dir",
         str(tmp / "full"), "--tar_dir", str(tmp / "train"), "--ps", "256", "--num_patches",
         "1", "--pair_mode", "same", "--pattern", "target/*.png"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"data.patches exited {proc.returncode}: {proc.stderr[-2000:]}")
    print(f"  {proc.stdout.strip()}")
    packed = pack_pair_dataset(str(tmp / "train"), str(tmp / "packed"), 256)
    check(packed["n"] == DATA_PAIRS, f"packed {packed['n']} pairs")
    print(f"  corpus: {DATA_PAIRS} pairs of 256x256 PNGs, patched and packed in "
          f"{time.perf_counter() - t0:.1f} s")


def data_tier_checks(tmp: Path) -> dict:
    """(c) of the data phase on :func:`data_corpus`'s corpus: the workers
    path at 0 and 2 workers equal bit for bit over an epoch; one epoch of
    ``Trainer.train_epoch`` at batch 4 through each ``train_io_bench``
    variant."""
    import numpy as np
    import torch

    from sunet_tf_tpu_torch.data.workers import worker_batch_iterator
    from sunet_tf_tpu_torch.tools import train_io_bench as iob

    t0 = time.perf_counter()
    epochs = [list(worker_batch_iterator(str(tmp / "train"), 256, DATA_BATCH, train=True,
                                         shuffle=True, drop_last=True, seed=86, workers=w))
              for w in (0, 2)]
    check(len(epochs[0]) == DATA_PAIRS // DATA_BATCH and len(epochs[0]) == len(epochs[1]),
          f"worker epochs of {[len(e) for e in epochs]} batches")
    for b0, b2 in zip(*epochs):
        check(b0["names"] == b2["names"] and all(torch.equal(b0[k], b2[k])
                                                 for k in ("input", "target", "valid")),
              "DATA_WORKERS=2 and the workers path at 0 differ")
    print(f"  workers path: 0 and 2 workers give the same {len(epochs[0])} batches bit for "
          f"bit ({time.perf_counter() - t0:.1f} s)")

    out = {}
    cfg = iob.bench_config(str(tmp / "train"), DATA_BATCH, 1, str(tmp / "ck"))
    for name in iob.VARIANTS:
        vcfg, env, packed_dir = iob.variant_setup(name, cfg, str(tmp / "packed"))
        r = iob.run_variant(name, vcfg, 1, env, packed_dir)
        check(np.isfinite(r["steady_img_per_s"]), f"{name}: no rate")
        out[name] = {"img_per_s": r["epochs_img_per_s"][0], "step_ms": r["step_ms"][0]}
        torch.cuda.empty_cache()
    print("  one epoch of Trainer.train_epoch, Config() denoise, batch 4, "
          f"{DATA_PAIRS} pairs (the first epoch of a new Trainer):")
    for name, r in out.items():
        print(f"    {name}: {r['img_per_s']:.2f} img/s, {r['step_ms']:.3f} ms a step host-paced")
    return out


def data_phase() -> dict:
    """Dropout and USE_CHECKPOINTS in training, and the data tier: see the
    module's text."""
    from sunet_tf_tpu_torch.config import Config
    from sunet_tf_tpu_torch.data.pipeline import PairDataset, batch_iterator
    from sunet_tf_tpu_torch.train.loop import prepare, step_generators, to_device

    print("phase: data (dropout and USE_CHECKPOINTS in the default SUNet's training step, "
          "256x256, batch 4; the data tier)")
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data_corpus(tmp)
        ds = PairDataset(str(tmp / "train"), 256, train=True, seed=0)
        batch = to_device(next(batch_iterator(ds, DATA_BATCH, shuffle=True, drop_last=True,
                                              seed=0)), "cuda")
        cfg, task = Config(), "mask"
        inp, tar = prepare(batch, task, 50.0, step_generators(0, 0, "cuda")[0])
        out["dropout"] = dropout_checks(cfg, task, inp, tar)
        out["rates0"] = rates0_checks(cfg, task, inp, tar)
        # after the steps above, so that no variant pays the process's first
        # training step
        out["tier"] = data_tier_checks(tmp)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  data phase: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------- float32
# The float32 route (phase ``fp32``; ROADMAP B2's serving half): a float32
# model on the card computes in float32, its kernels' float32 forms
# (csrc/f32_block.cu, csrc/f32_up4.cu) included. Every reading is a distance
# from float64: the relative L2 distance (rl2) and max |diff| of a float32
# result from the same function in float64 on float64 copies of its inputs.
# A float32 form must sit within FP32_FACTOR of its float32 plain version's
# distance (the C2/C4 idiom: no farther from exact than the plain
# version), and at most FP32_RL2_MAX away; single-pass TF32 rounds each
# operand by up to 2^-11 (4.9e-4 of it) and reads ~1e-3 at the stem, float32
# orders of magnitude below both. Cases whose logits reach ~1e4 (trained
# QK_SCALE 8 magnitudes) amplify every float32 rounding of q and k through
# the exponential; there only the factor applies.
FP32_RL2_MAX = 1e-4
FP32_FACTOR = 2.0
# the side of the float32-exactness check's images (``Config()`` at 128²:
# its last stage's 4 x 4 map takes windows of 4)
FP32_EXACT_SIZE = 128
# dense TF32 of one H100 SXM (NVIDIA data sheet); a float32-exact
# tensor-core form splits each operand in two and sums three products
# (3xTF32), so the float32 forms' bound takes a third of it
PEAK_TF32_FLOPS = 494.7e12
def f32_bound(flops: float, nbytes: float) -> dict:
    """The least time of a float32 form: the larger of the operations over
    the 3xTF32 rate (PEAK_TF32_FLOPS / 3) and the bytes over the HBM rate."""
    t_ops = flops / (PEAK_TF32_FLOPS / 3) * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def f32_block_cost(B: int, H: int, C: int, blocks: int = 1, heads: int = 8,
                   masked: bool = False, ws: int = 8) -> dict:
    """``blocks`` Swin blocks in float32 (#1, #2): block_cost's operations;
    bytes: x in, out, the float32 weights, biases and rel-pos tables (and
    the SW mask)."""
    T, N, hid = B * H * H, ws * ws, 4 * C
    flops = blocks * (2 * T * C * (4 * C + 2 * hid) + 4 * T * N * C)
    weights = blocks * ((4 * C * C + 2 * C * hid) + 9 * C + hid + heads * N * N)
    mask = (H // ws) ** 2 * N * N if masked else 0
    return f32_bound(flops, (2 * T * C + weights + mask) * 4)


def f32_wmsa_cost(B: int, H: int, C: int, heads: int = 8, masked: bool = False,
                  ws: int = 8) -> dict:
    """LN + W-MSA + projection in float32 (#3): wmsa_cost's operations;
    bytes: x in, out, the float32 weights, LN and biases, rel-pos table."""
    T, N = B * H * H, ws * ws
    mask = (H // ws) ** 2 * N * N if masked else 0
    return f32_bound(2 * T * C * 4 * C + 4 * T * N * C,
                     (2 * T * C + 4 * C * C + 6 * C + heads * N * N + mask) * 4)


def f32_mlp_cost(B: int, H: int, C: int) -> dict:
    """LN + MLP + residual in float32 (#4): fc1 and fc2; bytes: y in, out,
    the float32 weights, LN and biases."""
    T, hid = B * H * H, 4 * C
    return f32_bound(4 * T * C * hid, (2 * T * C + 2 * C * hid + 3 * C + hid) * 4)


def f32_up4_cost(B: int, H: int, W: int, C: int, out: int) -> dict:
    """The x4 head + 3x3 conv in float32 (#5): up4_cost's operations per
    low-res pixel; bytes: x in, the phase map out, the float32 weights."""
    M = B * H * W
    return f32_bound(M * (68 * C * C + 288 * C * out),
                     (M * C + M * 16 * out + 19 * C * C + 9 * C * out + C) * 4)


def rl2_max(got, ref) -> tuple:
    """(relative L2 distance, max |diff|) of ``got`` from ``ref``, float64."""
    g, r = got.double(), ref.double()
    return float((g - r).norm() / r.norm().clamp_min(1e-300)), float((g - r).abs().max())


def fp32_distance(label: str, got, plain, f64, trained: bool = False) -> dict:
    """Hold a float32 kernel's distance from float64 to its float32 plain
    version's: rl2 and max |diff| within FP32_FACTOR of the plain
    version's, and (unless ``trained``) rl2 <= FP32_RL2_MAX."""
    import torch

    torch.cuda.synchronize()
    check(got.dtype == torch.float32 and bool(torch.isfinite(got).all()),
          f"{label}: a {got.dtype} or non-finite kernel output")
    k_rl2, k_max = rl2_max(got, f64)
    p_rl2, p_max = rl2_max(plain, f64)
    ok = (k_rl2 <= FP32_FACTOR * p_rl2 and k_max <= FP32_FACTOR * p_max
          and (trained or k_rl2 <= FP32_RL2_MAX))
    print(f"  {label}: from float64 rl2 {k_rl2:.3e} max|diff| {k_max:.3e}; plain float32 rl2 "
          f"{p_rl2:.3e} max|diff| {p_max:.3e} (factor {FP32_FACTOR:g}"
          + ("" if trained else f", rl2 <= {FP32_RL2_MAX:g}") + f") {'ok' if ok else 'FAIL'}")
    check(ok, f"{label}: the float32 form sits farther from float64 than its gates allow")
    return {"rl2": k_rl2, "max": k_max, "plain_rl2": p_rl2, "plain_max": p_max}


def f32_params(C: int, heads: int, N: int, gen, *, qkv_gain: float = 1.0) -> tuple:
    """A block's 13 operands in float32 (``block_params``' draws, unrounded)."""
    import torch

    n = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    w = lambda i, o, g=1.0: n(i, o) * (g / i ** 0.5)
    hid = 4 * C
    return (1 + 0.1 * n(C), 0.1 * n(C), w(C, 3 * C, qkv_gain), 0.1 * n(3 * C), w(C, C),
            0.1 * n(C), 1 + 0.1 * n(C), 0.1 * n(C), w(C, hid), 0.1 * n(hid), w(hid, C),
            0.1 * n(C), n(heads, N, N))


def bf16_copy(a):
    """The bf16 kernels' arguments from a float32 case's: every tensor of
    two or more dimensions (x, the weight matrices, the tables) in bf16,
    vectors as they are."""
    import torch

    if isinstance(a, torch.Tensor):
        return a.to(torch.bfloat16) if a.dim() >= 2 else a
    if isinstance(a, (tuple, list)):
        return type(a)(bf16_copy(t) for t in a)
    return a


def max_logit(x, p, mask, *, ws: int, num_heads: int, scale: float, shift: int) -> float:
    """Largest |logit| of a block's attention on x, float32."""
    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.ops.window import roll2d, window_partition

    with wa.exact_fp32():
        xn = wa.ln32(roll2d(x, -shift), *p[0:2])
        qkv = window_partition(xn, ws) @ p[2] + p[3]
        Bn, N, C3 = qkv.shape
        h = num_heads
        C, d = C3 // 3, C3 // 3 // h
        q = qkv[..., :C].reshape(Bn, N, h, d).transpose(1, 2) * scale
        k = qkv[..., C:2 * C].reshape(Bn, N, h, d).transpose(1, 2)
        s = q @ k.transpose(-1, -2) + p[12]
        if mask is not None:
            s = (s.reshape(-1, mask.shape[0], h, N, N) + mask[None, :, None]).reshape(
                Bn, h, N, N)
    return float(s.abs().max())


def fp32_case(results: dict, name: str, case: str, kernel, plain, args: tuple, kw: dict,
              cost: dict, trained: bool = False):
    """One float32 form against its plain versions (float32 and float64),
    then timed beside the bf16 kernel on bf16 copies of the arguments (the
    median of 20 CUDA-event-timed calls each) and filed under name + FP32."""
    import torch

    with torch.inference_mode():
        got, ref = kernel(*args, **kw), plain(*args, **kw)
        f64 = plain(*float64_copy(args), **kw)
        check(f64.dtype == torch.float64, f"{name}: the float64 plain version gave {f64.dtype}")
        d = fp32_distance(f"{name}{FP32} {case}", got, ref, f64, trained)
        bargs = bf16_copy(args)
        ms = time_ms(lambda: kernel(*args, **kw))
        plain_ms = time_ms(lambda: plain(*args, **kw))
        bf16_ms = time_ms(lambda: kernel(*bargs, **kw))
    print(f"    time {ms:.4f} ms float32 kernel, {bf16_ms:.4f} ms bf16 kernel, {plain_ms:.4f} ms "
          f"float32 plain, bound {cost['bound_ms']:.4f} ms ({cost['bound_by']})")
    file_case(results, name + FP32, {
        "case": case, "max_abs_err": d["max"], "rl2": d["rl2"], "plain_rl2": d["plain_rl2"],
        "plain_max_abs_err": d["plain_max"], "ms": ms, "plain_ms": plain_ms, "bf16_ms": bf16_ms,
        "bound_ms": cost["bound_ms"], "bound_by": cost["bound_by"], "library_ms": None})


def fp32_kernel_phase(results: dict):
    """Each float32 form against its float32 plain version and float64, at
    the default model's shapes, batch 2: #1 at C=96/192/384, shift 0 and 4,
    and at ~1e4 logits; #2's K=2 chains at C=192 and 384; #3 at (8,8,768)
    (and ~1e4 logits) and on a masked (16,16,768) map; #4 at (8,8,768); #5
    at (64,64,96) out 1 and 3 and on a (34,40,96) map of partial tiles."""
    import torch

    from sunet_tf_tpu_torch.kernels import upsample as up
    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.ops.window import shift_attn_mask

    print("phase: fp32 kernels vs plain versions (float32 against float64, batch 2)")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(2020)
    B, ws, heads, scale, N = 2, 8, 8, 8.0, 64
    sw_mask = lambda H, shift: (torch.as_tensor(shift_attn_mask(H, H, ws, shift), device="cuda")
                                if shift else None)
    bkw = dict(ws=ws, num_heads=heads, scale=scale)
    for H, C, shift, gain in ((64, 96, 0, 1.0), (64, 96, 4, 1.0), (32, 192, 0, 1.0),
                              (32, 192, 4, 1.0), (16, 384, 0, 1.0), (16, 384, 4, 1.0),
                              (32, 192, 4, 7.5)):
        p = f32_params(C, heads, N, gen, qkv_gain=gain)
        x = torch.randn(B, H, H, C, device="cuda", generator=gen)
        mask = sw_mask(H, shift)
        case = f"({H},{H},{C}) shift {shift}"
        if gain != 1.0:
            logit = max_logit(x, p, mask, shift=shift, **bkw)
            case += f" qkv x{gain:g}, max |logit| {logit:.3e}"
        fp32_case(results, "fused_swin_block", case, wa.fused_swin_block,
                  wa.fused_swin_block_reference,
                  (x, p[0:2], *p[2:6], p[6:8], *p[8:12], p[12], mask), dict(shift=shift, **bkw),
                  f32_block_cost(B, H, C, masked=shift > 0), trained=gain != 1.0)

    def two_plain(x, params, biases, mask, *, shifts, **kw):
        for q, bias, s in zip(params, biases, shifts):
            x = wa.fused_swin_block_reference(x, q[0:2], *q[2:6], q[6:8], *q[8:12], bias,
                                              mask if s else None, shift=s, **kw)
        return x

    for H, C in ((32, 192), (16, 384)):
        ps = [f32_params(C, heads, N, gen) for _ in range(2)]
        x = torch.randn(B, H, H, C, device="cuda", generator=gen)
        args = (x, [q[:12] for q in ps], [q[12] for q in ps], sw_mask(H, 4))
        kw = dict(shifts=(0, 4), **bkw)
        fp32_case(results, "fused_swin_block_chain", f"({H},{H},{C}) K=2",
                  wa.fused_swin_block_chain, two_plain, args, kw,
                  f32_block_cost(B, H, C, blocks=2, masked=True))
        with torch.inference_mode():
            first = wa.fused_swin_block(x, ps[0][0:2], *ps[0][2:6], ps[0][6:8], *ps[0][8:12],
                                        ps[0][12], None, shift=0, **bkw)
            second = wa.fused_swin_block(first, ps[1][0:2], *ps[1][2:6], ps[1][6:8],
                                         *ps[1][8:12], ps[1][12], args[3], shift=4, **bkw)
            check(torch.equal(wa.fused_swin_block_chain(*args, **kw), second),
                  f"fp32 chain ({H},{H},{C}) differs from two block launches")
        print("    fused_swin_block_chain[fp32] == two fused_swin_block[fp32] launches, bit for bit")

    for H, shift, gain in ((8, 0, 1.0), (16, 4, 1.0), (8, 0, 7.5)):
        C = 768
        p = f32_params(C, heads, N, gen, qkv_gain=gain)
        x = torch.randn(B, H, H, C, device="cuda", generator=gen)
        mask = sw_mask(H, shift)
        case = f"({H},{H},{C}) shift {shift}"
        if gain != 1.0:
            case += f" qkv x{gain:g}, max |logit| {max_logit(x, p, mask, shift=0, **bkw):.3e}"
        fp32_case(results, "fused_ln_window_attention", case, wa.fused_ln_window_attention,
                  wa.fused_ln_window_attention_reference, (x, *p[0:6], p[12], mask), bkw,
                  f32_wmsa_cost(B, H, C, masked=shift > 0), trained=gain != 1.0)
        if H == 8 and gain == 1.0:
            fp32_case(results, "fused_ln_mlp", f"({H},{H},{C})", wa.fused_ln_mlp,
                      wa.fused_ln_mlp_reference, (x, p[6:8], *p[8:12]), {},
                      f32_mlp_cost(B, H, C))

    n = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    for Hh, Wh, out_ch in ((64, 64, 1), (64, 64, 3), (34, 40, 1)):
        C = 96
        hp = (n(B, Hh, Wh, C), n(C, 16 * C) / C ** 0.5, torch.full((1,), 0.25, device="cuda"),
              n(C, C) / C ** 0.5, 0.1 * n(C), torch.full((1,), 0.2, device="cuda"),
              n(C, C) / C ** 0.5, n(C, C) / C ** 0.5, n(3, 3, C, out_ch) / (9 * C) ** 0.5)
        fp32_case(results, "fused_dual_upsample4_conv_phase", f"({Hh},{Wh},{C}) out {out_ch}",
                  up.fused_dual_upsample4_conv_phase, up.fused_dual_upsample4_conv_phase_reference,
                  hp, {}, f32_up4_cost(B, Hh, Wh, C, out_ch))
    print(f"  fp32 kernel checks wall s: {time.perf_counter() - t0:.1f}")


def fp32_exact_check() -> dict:
    """A float32 model computes in float32 on the card (no TF32): ``Config()``
    at FP32_EXACT_SIZE², batch 1, float32 on the eager route against its
    float64 copy (``route_copy``), on the card and on the CPU (which has no
    TF32), the same weights and inputs: the forward's rl2 from float64 and
    the stem's; one training step (``train.loop.step_precision``, the
    train step's context, around the forward and backward; drop-path drawn
    from one CPU generator on both devices) and each parameter's gradient
    rl2 from the float64 step's, the worst taken. Each card reading within
    FP32_FACTOR of the CPU's, the forward's at most FP32_RL2_MAX. A control
    runs the card's float32 forward and step with the guards taken out and
    TF32 on, as the model ran before them, and must fail a gate."""
    import torch

    from sunet_tf_tpu_torch.config import Config
    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.models.sunet import build_model, route_copy
    from sunet_tf_tpu_torch.train import loop

    S = FP32_EXACT_SIZE
    print(f"phase: fp32 exactness (Config() float32 eager at {S}x{S}, batch 1, "
          "card and CPU against float64)")
    base = Config(compute_dtype="float32")
    cfg = base.replace(swinunet=dataclasses.replace(base.swinunet, img_size=S))
    g = torch.Generator().manual_seed(41)
    x, tar = torch.rand(1, S, S, 3, generator=g), torch.rand(1, S, S, 3, generator=g)

    def readings(dev: str) -> dict:
        m32 = build_model(cfg, device=dev, backend="eager", seed=0)
        m64 = route_copy(m32, dtype=torch.float64, backend="eager")
        xd, td = x.to(dev), tar.to(dev)
        with torch.no_grad():
            m32.taps, m64.taps = {}, {}
            fwd, fwd_max = rl2_max(m32(xd), m64(xd.double()))
            stem, stem_max = rl2_max(m32.taps["stem"], m64.taps["stem"])
        for m in (m32, m64):
            m.train().requires_grad_(True)
            with loop.step_precision(m):
                loss, _, _ = loop.loss_and_metrics(m, xd, td, torch.Generator().manual_seed(5),
                                                   torch.ones(1, device=dev), "denoise")
                loss.backward()
        worst, name = 0.0, ""
        for (k, p32), p64 in zip(m32.named_parameters(), m64.parameters()):
            if p64.grad is not None and float(p64.grad.norm()) > 0:
                r = rl2_max(p32.grad, p64.grad)[0]
                if r > worst:
                    worst, name = r, k
        return {"forward_rl2": fwd, "forward_max": fwd_max, "stem_rl2": stem,
                "stem_max": stem_max, "grad_rl2": worst, "grad_worst": name}

    def tf32_on():
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        return contextlib.nullcontext()

    out = {"cuda": readings("cuda"), "cpu": readings("cpu")}
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        with patched([(wa, "exact_fp32", tf32_on), (loop, "exact_fp32", tf32_on)]):
            out["cuda_tf32"] = readings("cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    for dev in ("cuda", "cpu", "cuda_tf32"):
        r = out[dev]
        print(f"  {dev}: forward rl2 {r['forward_rl2']:.3e} (max|diff| {r['forward_max']:.3e}), "
              f"stem rl2 {r['stem_rl2']:.3e} (max|diff| {r['stem_max']:.3e}), worst gradient "
              f"rl2 {r['grad_rl2']:.3e} ({r['grad_worst']})")
    cu, cpu, tf = out["cuda"], out["cpu"], out["cuda_tf32"]

    def passes(r):
        return (r["forward_rl2"] <= FP32_FACTOR * cpu["forward_rl2"]
                and r["grad_rl2"] <= FP32_FACTOR * cpu["grad_rl2"]
                and r["forward_rl2"] <= FP32_RL2_MAX)

    ok = passes(cu)
    print(f"  card within {FP32_FACTOR:g} x the CPU's readings, forward rl2 <= {FP32_RL2_MAX:g}: "
          f"{'ok' if ok else 'FAIL'}; the TF32 control "
          f"{'fails them, as it must' if not passes(tf) else 'PASSES them'}")
    check(ok, "a float32 model does not compute in float32 on the card")
    check(not passes(tf), "the exactness gates do not see TF32")
    return out


def fp32_forward(results: dict) -> dict:
    """The fused float32 ``Config()`` at 256x256, batch 4: launches equal to
    ``expected_launches`` (each wrapper called as in bf16, its float32
    form's launches), no plain version run; against the eager float32 route,
    both against the float64 eager copy: the fused rl2 within FP32_FACTOR of
    eager float32's and at most FP32_RL2_MAX; the exported float32 program
    (``infer.export``) equal to the live model bit for bit; times of the
    fused float32, eager float32 and fused bf16 forwards."""
    import torch

    from sunet_tf_tpu_torch.config import Config
    from sunet_tf_tpu_torch.infer.export import ServingModel, save_exported
    from sunet_tf_tpu_torch.models.sunet import build_model, route_copy

    print("phase: fp32 forward (Config() float32, 256x256, batch 4, fused vs eager vs float64)")
    cfg = Config(compute_dtype="float32")
    fused = build_model(cfg, device="cuda", backend="fused", seed=0)
    eager = route_copy(fused, dtype=torch.float32, backend="eager")
    f64 = route_copy(fused, dtype=torch.float64, backend="eager")
    x = torch.rand(4, 256, 256, 3, device="cuda", generator=torch.Generator(device="cuda").manual_seed(7))
    want = fused.expected_launches(tuple(x.shape))
    with torch.inference_mode():
        y, launches = run_counted(lambda: fused(x), want, "fused_dual_upsample4")
        ye, y64 = eager(x), f64(x.double())
    check(tuple(y.shape) == (4, 256, 256, 1) and y.dtype == torch.float32,
          f"fused float32 output {y.dtype} {tuple(y.shape)}")
    f_rl2, f_max = rl2_max(y, y64)
    e_rl2, e_max = rl2_max(ye, y64)
    ok = f_rl2 <= FP32_FACTOR * e_rl2 and f_rl2 <= FP32_RL2_MAX
    print(f"  from float64: fused rl2 {f_rl2:.3e} max|diff| {f_max:.3e}; eager float32 rl2 "
          f"{e_rl2:.3e} max|diff| {e_max:.3e} (factor {FP32_FACTOR:g}, rl2 <= {FP32_RL2_MAX:g}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "the fused float32 forward sits farther from float64 than its gates allow")
    for k, v in launches.items():
        if v:
            results.setdefault(k + FP32, {"max_abs_err": 0.0, "cases": []})["launches"] = v
    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
        save_exported(tmp, fused, 256, batches=(4,))
        sm = ServingModel(tmp)
        got, _ = run_counted(lambda: sm(fused, x), want, "fused_dual_upsample4")
        exported = bit_equal("exported float32 program vs the live model", got, y)
    refusals = fp32_refusals(fused, x)
    bf16 = build_model(Config(), device="cuda", backend="fused", seed=0)
    with torch.inference_mode():
        ms = {"fused_fp32": time_ms(lambda: fused(x), iters=10),
              "eager_fp32": time_ms(lambda: eager(x), iters=10),
              "fused_bf16": time_ms(lambda: bf16(x), iters=10)}
    print(f"  forward ms (batch 4), device: fused float32 {ms['fused_fp32']:.3f}, eager float32 "
          f"{ms['eager_fp32']:.3f}, fused bf16 {ms['fused_bf16']:.3f}")
    del fused, eager, f64, bf16
    torch.cuda.empty_cache()
    return {"fused_rl2": f_rl2, "fused_max": f_max, "eager_rl2": e_rl2, "eager_max": e_max,
            "launches": launches, "exported_max_abs_diff": exported, "ms": ms,
            "refusals": refusals}


def fp32_refusals(fused, x) -> list:
    """What the float32 route does not take raises NotImplementedError on the
    card, naming its ROADMAP item, before any kernel launches (every count
    stays 0): the float32 fused model's training forward, a float32 fused
    model with 256-token windows (``tiny_config()`` at WIN 16), and the
    float32 fused model given a spatial stage runner."""
    import torch

    from sunet_tf_tpu_torch.config import tiny_config
    from sunet_tf_tpu_torch.kernels import _build
    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.models.sunet import TRAIN_WRAPPERS, build_model

    tiny = tiny_config().replace(compute_dtype="float32")
    big = build_model(tiny.replace(swinunet=dataclasses.replace(tiny.swinunet, win_size=16)),
                      device="cuda", backend="fused", seed=0)
    cases = [("training forward", wa.F32_TRAIN_ITEM,
              lambda: fused(x, generator=torch.Generator(device="cuda").manual_seed(3))),
             ("256-token windows", wa.F32_SEQ_ITEM,
              lambda: big(torch.rand(1, 64, 64, 3, device="cuda"))),
             ("spatial stage runner", wa.F32_SPATIAL_ITEM,
              lambda: fused(x, stage_runner=object()))]
    out = []
    for what, item, fn in cases:
        torch.cuda.synchronize()
        _build.reset_counts()
        try:
            fn()
            why = None
        except NotImplementedError as e:
            why = str(e)
        torch.cuda.synchronize()
        launched = sum(_build.counter(k).cuda + _build.counter(k).cpu for k in TRAIN_WRAPPERS)
        ok = why is not None and item in why and launched == 0
        print(f"  float32 {what}: {'refused, ' + repr(item) if why else 'NOT refused'}, "
              f"{launched} launches {'ok' if ok else 'FAIL'}")
        check(ok, f"float32 {what}: not refused with {item!r} before any launch")
        out.append({"what": what, "item": item})
    return out


def fp32_phase(results: dict) -> dict:
    """The float32 route's exactness check and main path (the kernel forms'
    checks run with the other kernel phases, ``fp32_kernel_phase``)."""
    t0 = time.perf_counter()
    exact = fp32_exact_check()
    t1 = time.perf_counter()
    forward = fp32_forward(results)
    t2 = time.perf_counter()
    print(f"  fp32 phase wall s: exactness {t1 - t0:.1f}, forward and export {t2 - t1:.1f}")
    return {"exact": exact, "forward": forward, "wall_s": {"exact": t1 - t0,
                                                           "forward": t2 - t1}}


PHASES = ("kernels", "fp32", "train_kernels", "slice", "demo", "tiled", "export", "parallel",
          "train",
          "parity", "bands", "entries", "scaled", "scaled_train",
          "data")


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    phases = [p for p in ap.parse_args().phases.split(",") if p]
    if not set(phases) <= set(PHASES):
        raise SystemExit(f"chip_smoke: unknown phases {sorted(set(phases) - set(PHASES))}")
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError as e:
        raise SystemExit(f"chip_smoke: torch missing: {e}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    if not (ROOT / "sunet_tf_tpu_torch").is_dir():
        raise SystemExit(f"chip_smoke: package sunet_tf_tpu_torch not found at {ROOT}")
    sys.path.insert(0, str(ROOT))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip()
          else f"nvidia-smi unavailable: {smi.stderr.strip()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    from sunet_tf_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    seconds, log = _build.build_info()
    (OUT_DIR / "kernel_build.log").write_text(log)
    spills = [ln.strip() for ln in log.splitlines() if "spill" in ln and " 0 bytes spill" not in ln]
    print(f"kernel build: {seconds:.1f} s ({time.perf_counter() - t0:.1f} s wall); "
          f"ptxas spill lines with spills: {len(spills)}")
    for ln in spills:
        print(f"  {ln}")

    results: dict = {}
    stats: dict = {}
    seconds: dict = {}   # wall seconds of each step, the time limit's ledger

    def run(label: str, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[label] = round(time.perf_counter() - t, 1)
        print(f"chip_smoke: {label}: {seconds[label]} s wall")
        return out

    with plans_taken(HELD_PLANS):
        for phase, fn in (("kernels", kernel_phases), ("fp32", fp32_kernel_phase),
                          ("train_kernels", train_kernel_phases),
                          ("scaled", scaled_kernel_phase),
                          ("scaled_train", scaled_train_kernel_phase),
                          ("parallel", b5_kernel_phase)):
            if phase in phases:
                run(f"{phase} kernel checks", fn, results)
    for phase, fn, args in (("fp32", fp32_phase, (results,)), ("slice", slice_phase, (results,)),
                            ("demo", demo_phase, ()), ("tiled", tiled_phase, ()),
                            ("export", export_phase, ()),
                            ("parallel", parallel_phase,
                             (results, {"kernels", "train_kernels"} <= set(phases))),
                            ("train", train_phase, (results,)), ("data", data_phase, ()),
                            ("parity", parity_phase, ()), ("bands", bands_phase, (results,)),
                            ("entries", entries_phase, (results,)),
                            ("scaled", scaled_phase, (results,)),
                            ("scaled_train", scaled_train_phase, (results,))):
        if phase in phases:
            out = run(phase, fn, *args)
            if out is not None:
                stats[phase] = out
    stats["phase_seconds"] = seconds
    total_s = time.perf_counter() - t_start
    print(f"chip_smoke: phases {','.join(phases)} passed in {total_s:.1f} s wall")
    if list(phases) != list(PHASES):
        return

    kernels = []
    for name, (replaces, source) in REPLACES.items():
        r = results[name]
        first = r["cases"][0]
        launches = r["launches"] if "launches" in r else r["train_launches"]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": r["max_abs_err"], "ms": first["ms"],
                        "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
                        "bound_by": first["bound_by"], "library_ms": first["library_ms"],
                        "train_launches": r.get("train_launches", 0), "cases": r["cases"]})
    line = {"kernels": kernels, **stats, "float64": FLOAT64_READINGS, "wall_seconds": total_s}
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(line, indent=1))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
