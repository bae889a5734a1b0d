#!/usr/bin/env python3
"""Calibrate chip_smoke's limits for the backward kernels on one NVIDIA GPU.

    python3 chip_mutants.py [--out PATH] [--step-only] [--mutants NAME,...] [--sound]

Runs chip_smoke's backward checks (``compare_grads`` on the block backward
at (64,64,96), (32,32,192), (16,16,384), shift 0 and 4, batch 2, on the
x4-head backward at (64,64,96) out 1 and (34,40,96) out 3, on the scaled
geometry's forward forms (``chip_smoke.scaled_cases``; the chain's check
``scaled_chain_check`` not in the ``floor`` setting) and its training
step's forms (``chip_smoke.scaled_train_cases``: #1's train form, the
big-window block backward, #9's wide form), and on the C=768
training sublayers
of ``chip_smoke.sublayer_cases``: the LN+W-MSA backward at (8,8,768) and
(16,16,768) shift 4, the LN+MLP branch there too and its backward at
(8,8,768); and
on the residual route's block backward at (64,64,96) and (32,32,192),
shift 0 and 4, from the residual forward's stored state, and on that
forward's output and stored state, ``check_res_state``) with failures
reported instead of raised, and the training step's gradients, in these
settings:

- ``kernel``: the CUDA kernels against their plain versions, two input
  seeds, logit gain 1 and 0.25 (the sound readings the limits must pass);
- ``floor``: the plain version run on the CPU against itself on the card
  (the spread of a reordering alone);
- one run per mutant: a copy of the repository under a temporary directory
  with one deliberate fault (a few mutants write the same fault into each
  kernel that has its own copy of the code) in the kernel sources, built
  and checked there (each must fail); ``--mutants`` runs only the named
  ones and no other setting, ``--sound`` only the kernel and floor
  settings; a mutant's file path is under ``kernels/csrc`` (``../`` for
  the wrappers' Python beside it); the Python mutants of
  ``EXPORT_MUTANTS``, ``PARALLEL_MUTANTS``, ``FLOAT64_MUTANTS`` and
  ``DATA_MUTANTS`` run chip_smoke's export, parallel, parity and train, or
  data phase in their copy, which must fail;
- ``step`` (alone with ``--step-only``): the calibration of chip_smoke's
  training gate. chip_smoke's batch-4 step of the default SUNet runs on the
  float32 eager route and twice on each bf16 variant below, which differ
  only in where they round: the fused route, with and without
  ``ROUTE_TRAIN_RESID``, each also with the drop-path product in float32
  and with every kernel replaced by its plain version (the same rounding
  points, no kernel); the residual route with every kernel by its plain
  version and the drop-path product in float32, and either of those with
  its C=768 stage on eager autograd; the residual route with only #6, or
  only #7, by its plain version; its C=768 stage on eager autograd or on
  its plain versions; and chip_smoke's NOISE_ROUTES: the eager route, the
  eager route with JAX's residual attention (``chip_smoke.res_attention``)
  in the residual route's blocks, each also with the float32 product. It
  reads, per run, every one-value gradient's relative error (the largest
  must stay within ``chip_smoke.ONE_VALUE_NOISE``), the relative L2 error
  of the C=768 stage's output, and the run against chip_smoke's whole gate
  (its noise reference from the first runs of the NOISE_ROUTES variants):
  the tensors beyond it and the largest shares of their limits. Then, over
  the tensors whose eager distance is beyond the strict limits, the
  per-tensor ratio of 1 - cos between two realizations of one route (the
  spread GRAD_NOISE_FACTOR must cover); per variant, the geometric mean of
  its 1 - cos over eager's on those tensors and each stage's median
  relative L2; and the ``PAIRS`` per stage: each fused route against its
  plain-version route (how far the kernels alone move the gradients) and
  against its float32 drop-path product, and the eager route against its
  sound variants (how far one rounding point moves them).

Every reading goes to ``--out`` (default: beside the built kernels, in
``sunet_tf_tpu_torch/kernels/_build/``, git-ignored), the step setting's
per-tensor distances beside it (``.dists.json``); the last lines
summarise the failing checks per setting. Needs one GPU; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import math
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# name: (source file under kernels/csrc, text, replacement), or a list of
# them (one fault written into each of several kernels)
MUTANTS = {
    "tanh_gelu_grad": ("train_common.cuh", """__device__ inline float gelu_grad_f(float v) {
  return 0.5f * (1.f + erff(v * 0.70710678118654752f)) +
         v * expf(-0.5f * v * v) * 0.3989422804014327f;
}""", """__device__ inline float gelu_grad_f(float v) {
  const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v), t = tanhf(u);
  return 0.5f * (1.f + t) +
         0.5f * v * (1.f - t * t) * 0.7978845608028654f * (1.f + 0.134145f * v * v);
}"""),
    # the block backward's dm = round(s2 * dout) gathered in its A load
    "dp_missing_from_dm": ("block_bwd_hopper.cuh",
                           "if (kA == kADm) ri.scale[r] = a.dp ? a.dp[2 * (row / hw) + 1] : 1.f;",
                           "if (kA == kADm) ri.scale[r] = 1.f;"),
    # the LN+MLP backward's (#14) LN rows without mean(dyn g)
    "ln_bwd_no_mean": ("ln_mlp_bwd.cu", "  m1 = warp_sum(m1) / C;\n", "  m1 = 0.f;\n"),
    # the LN+MLP backward's (#14) dab w1^T without the last K-split rank's
    # partial (ks = 8 at (8,8,768))
    "mlp_ksplit_rank_dropped": ("ln_mlp_bwd.cu",
                                "for (int q = 0; q < ks; ++q)   // split partials in rank order",
                                "for (int q = 0; q < ks - 1; ++q)   // split partials in rank order"),
    # the recompute form's attention backward (#8, and #12 on the same
    # kernel) without the rowsum(dP * P) term
    "ds_no_rowsum": ("block_bwd_hopper.cuh",
                     "dpv[nt][u] = s[nt][u] * (dpv[nt][u] - (u < 2 ? rd0 : rd1));",
                     "dpv[nt][u] = s[nt][u] * (dpv[nt][u] - (kMode == kAttnBwd ? 0.f : "
                     "(u < 2 ? rd0 : rd1)));"),
    # the attention backward's dq without its second group of eight
    # 8-column tiles (head dims above 64: #12 at C=768, head dim 96)
    "dq_second_group_dropped": ("block_bwd_hopper.cuh",
                                "        for (int u = 0; u < 4; ++u) o[u] *= a.scale;\n",
                                "        for (int u = 0; u < 4; ++u) o[u] *= dt >= kGroupTiles && "
                                "dt < 2 * kGroupTiles ? 0.f : a.scale;\n"),
    # the residual route's attention backward (#7) without the
    # rowsum_head(t) term
    "res_de_no_rowsum": ("block_bwd_hopper.cuh",
                         "dpv[nt][u] = s[nt][u] * (dpv[nt][u] - (u < 2 ? rd0 : rd1));",
                         "dpv[nt][u] = s[nt][u] * (dpv[nt][u] - (kMode == kAttnBwd ? "
                         "(u < 2 ? rd0 : rd1) : 0.f));"),
    # the block backward's mechanisms (#7 and #8, csrc/block_bwd_hopper.cuh):
    # the weight-gradient launch without dw2's last token chunk; without the
    # column sums of dm and dattn (b2's and bproj's gradients); the
    # tensor-core attention backward with the last head's dk zeroed; the LN
    # backward epilogues with the last cluster rank's row sums left out (at
    # G = 1, C=96, the only one)
    "wgrad_chunk_dropped": (
        "block_bwd_hopper.cuh",
        "if (mm < p.M && nn < p.N) out[(size_t)mm * p.N + nn] = acc[i];",
        "if (mm < p.M && nn < p.N) out[(size_t)mm * p.N + nn] = "
        "(pi == 0 && ch == a.nchunks - 1) ? 0.f : acc[i];"),
    "wgrad_bias_colsum_dropped": ("block_bwd_hopper.cuh",
                                  "        cs += bf(*reinterpret_cast<const bf16*>(",
                                  "        cs += 0.f * bf(*reinterpret_cast<const bf16*>("),
    "attn_tc_head_dk_zeroed": (
        "block_bwd_hopper.cuh", "          store(1, t0 + j, ok[j], row0);   // dk\n",
        "          if (hh == a.heads - 1) ok[j][0] = ok[j][1] = ok[j][2] = ok[j][3] = 0.f;\n"
        "          store(1, t0 + j, ok[j], row0);   // dk\n"),
    "ln_rank_sum_dropped": ("block_bwd_hopper.cuh",
                            "for (int q = 0; q < G; ++q) {   // LN row sums in rank order",
                            "for (int q = 0; q < G - 1; ++q) {   // LN row sums in rank order"),
    # the residual forward (#6, the cluster kernel's residual form): the row
    # sum over the unrounded exponentials (the inference form) instead of
    # JAX's rounded ones; the last cluster rank's eb stored as zeros (at
    # C=192, G=2: its heads' state dropped)
    "res_den_unrounded": ("swin_cluster.cu",
                          "      for (int u = 0; u < 4; ++u) s[nt][u] = bf(tobf(s[nt][u]));\n",
                          "      for (int u = 0; u < 4; ++u) s[nt][u] = s[nt][u];\n"),
    "res_eb_rank_dropped": (
        "swin_cluster.cu",
        "      *reinterpret_cast<uint32_t*>(res.eb + (i0 + g) * N + j) = pack_bf2(s[nt][0], s[nt][1]);",
        "      const bool last = cooperative_groups::this_cluster().num_blocks() > 1 &&\n"
        "          cooperative_groups::this_cluster().block_rank() + 1 ==\n"
        "              cooperative_groups::this_cluster().num_blocks();\n"
        "      *reinterpret_cast<uint32_t*>(res.eb + (i0 + g) * N + j) =\n"
        "          last ? 0u : pack_bf2(s[nt][0], s[nt][1]);\n"
        "      if (last) *reinterpret_cast<uint32_t*>(res.eb + (i0 + g + 8) * N + j) = 0u;\n"
        "      else"),
    # the subpixel branch's PReLU derivative of both x4-head backwards (in
    # each one's phase launch), and the stencil's edge clamp of both stencil
    # adjoints (up4_bwd.cuh's stencil_taps, which both tap_coef reads)
    "up4_prelu_slope_ignored": [
        ("up4_bwd.cu",
         "pack_bf2(acc[i] > 0.f ? d0 : ap * d0, acc[i + 1] > 0.f ? d1 : ap * d1);",
         "pack_bf2(d0, d1);"),
        ("up4_conv_bwd.cu",
         "pack_bf2(z[i] > 0.f ? dp[i] : ap * dp[i], z[i + 1] > 0.f ? dp[i + 1] : ap * dp[i + 1]);",
         "pack_bf2(dp[i], dp[i + 1]);")],
    "up4_stencil_edge_not_folded": (
        "up4_bwd.cuh",
        "  lo = p < 2 ? max(u - 1, 0) : u;\n  hi = p < 2 ? u : min(u + 1, n - 1);",
        "  lo = p < 2 ? u - 1 : u;\n  hi = p < 2 ? u : u + 1;"),
    # the conv-fused head's backward (#9): the fold of the slots that read a
    # phase at a row offset without that offset (dout not shifted back)
    "up4_fold_slot_unshifted": ("up4_conv_bwd.cu",
                                "const int hh = h0 + (r >> 3) - ddh, ww = w0 + (r & 7) - ddw;",
                                "const int hh = h0 + (r >> 3), ww = w0 + (r & 7) - ddw;"),
    # the split head (#10) with its bilinear branch rounded to bf16 before
    # the stencil (the eager route's rounding point, not the JAX kernel's),
    # in its prep launch's bordered xb store (#9's unbordered xb untouched),
    # and with the bordered map's border left as zeros (the edge taps read 0)
    "up4_split_bilinear_rounded": (
        "up4_bwd.cuh",
        "if constexpr (kBorder) store_bordered(a.xb, cells[(i >> 1) & 1], col, acc[i]);",
        "if constexpr (kBorder) store_bordered(a.xb, cells[(i >> 1) & 1], col, bf(tobf(acc[i])));"),
    "up4_split_border_zero": ("up4_bwd.cuh",
                              "if (c.valid >> k & 1) xbp[c.off[k] + col] = v;",
                              "if (c.valid >> k & 1) xbp[c.off[k] + col] = k ? 0.f : v;"),
    # the H-axis stencil adjoint of both dxb tiles (#11's H-axis weights in
    # up4_bwd.cu, #9's H pass) with the top edge's clamped tap not folded
    # back onto the edge row
    "up4_h_adjoint_top_unclamped": [
        ("up4_bwd.cu",
         "(w_axis ? cw : ch)[i] = t < n && P >= 0 && (P >> 2) < n ? tap_coef(P, t, n) : 0.f;",
         "(w_axis ? cw : ch)[i] = t < n && P >= 0 && (P >> 2) < n\n"
         "        ? tap_coef(P, t, n) - (!w_axis && t == 0 && P < 2 ? kQ4[P][0] : 0.f) : 0.f;"),
        ("up4_conv_bwd.cu",
         "        s += tap_coef(P, th, H) * R[((qh * 8 + pw) * 3 + dxi) * out + o];",
         "        s += (th == 0 && P < 2 ? tap_coef(P, th, H) - kQ4[P][0] : tap_coef(P, th, H)) *\n"
         "             R[((qh * 8 + pw) * 3 + dxi) * out + o];")],
    # the cluster block kernel (#1): the last rank's fc2 partial left out of
    # the reduction (at G = 1 the only one), and the next rank's ctx
    # columns not gathered before proj (G > 1: C=192 and 384)
    "cluster_fc2_rank_dropped": ("swin_cluster.cu",
                                 "for (int q = 0; q < G; ++q) {   // fc2 partials in rank order",
                                 "for (int q = 0; q < G - 1; ++q) {   // fc2 partials in rank order"),
    "cluster_ctx_slice_not_gathered": ("swin_cluster.cu",
                                       "if (q == rank) continue;   // ctx gather",
                                       "if (q == rank || q == (rank + 1) % G) continue;"),
    # the token-row GEMM of the LN+MLP (#4) and LN+W-MSA (#3) kernels
    # (gemm_tile.cuh): the last rank's split partial left out (#4's fc2 at
    # ks=4, #3's projection at ks=4)
    "gemm_split_rank_dropped": ("gemm_tile.cuh",
                                "for (int q = 0; q < G; ++q)   // split partials in rank order",
                                "for (int q = 0; q < G - 1; ++q)   // split partials in rank order"),
    # the attention of the LN+W-MSA kernel (#3) and of the standalone W-MSA
    # (#15): the last head's ctx dropped (zero)
    "ln_wmsa_head_ctx_dropped": (
        "wmsa_attn.cuh", "  l0 = fmaxf(l0, 1e-37f);\n  l1 = fmaxf(l1, 1e-37f);\n",
        "  l0 = hh == a.heads - 1 ? INFINITY : fmaxf(l0, 1e-37f);\n"
        "  l1 = hh == a.heads - 1 ? INFINITY : fmaxf(l1, 1e-37f);\n"),
    # the conv-fused x4 head (#5): the top halo row's phases (i = 3) not
    # computed, and the four corners' phases not computed (4 outputs per
    # tile lose a tap)
    "up4c_top_halo_row_dropped": (
        "up4_conv.cu", "if (q < kTW) return i == 3 ? q : (i == 0 ? kTW + q : -1);",
        "if (q < kTW) return i == 3 ? -1 : (i == 0 ? kTW + q : -1);"),
    "up4c_corners_dropped": (
        "up4_conv.cu", "if (q == kTW + kTH && (i == 3 || i == 0) && (j == 3 || j == 0))",
        "if (false && q == kTW + kTH)"),
    # the LN+MLP branch (#13): fc2's bias read from b1 (b2 dropped)
    "ln_mlp_branch_b2_dropped": ("ln_mlp_branch.cu",
                                 "GemmArgs{h, (const float*)b2, nullptr,",
                                 "GemmArgs{h, (const float*)b1, nullptr,"),
    # the standalone W-MSA (#15): its qkv launch without its bias (a zeroed
    # workspace row read instead; #3's launch untouched), and the mask of
    # window (t + 1) % nW for window t
    "wmsa_no_qkv_bias": ("window_attention.cu", "  const float* bq = (const float*)bqkv;\n",
                         "  const float* bq = (const float*)w.ctx;\n"
                         "  SUNET_TRY(cudaMemsetAsync(w.ctx, 0, 12 * (size_t)C, st));\n"),
    "wmsa_mask_next_window": (
        "wmsa_attn.cuh", "mwin = (int)(((long long)b * gridDim.x + win) % gridDim.x);",
        "mwin = (int)(((long long)b * gridDim.x + win + 1) % gridDim.x);"),
    # the scaled geometry's forms (chip_smoke.scaled_kernel_phase): #1's
    # sequence form (csrc/swin_block_seq.cu) with its projection's epilogue
    # without the residual x, or with its output stored at the rolled rows
    # (the SW roll not undone); the big-window attention (wmsa_attn.cuh, #1's
    # sequence form and #3 at 256 tokens) with its row maximum taken over
    # the first 64 keys (exact softmax whenever nothing overflows: the
    # ~1e3-logit case of #3 overflows); gemm_tile.cuh's 8-byte row chunks
    # (C=180) with the halves of each 8-column group swapped; the conv-fused
    # head's (#5) x rows at C=180 with each chunk's second half read from
    # its first
    "seq_proj_no_residual": (
        "swin_block_seq.cu",
        "    SUNET_TRY((gemm_tile_ks<kEpiResid, false, kModeGeneral>(ga, wproj, st)));",
        "    SUNET_TRY((gemm_tile_ks<kEpiBias, false, kModeGeneral>(ga, wproj, st)));"),
    "seq_out_rolled": ("swin_block_seq.cu", "nullptr, nullptr, cc, roll * kRollOut, H, W, shift,",
                       "nullptr, nullptr, cc, 0, H, W, shift,"),
    "big_attn_max_first_chunk": ("wmsa_attn.cuh",
                                 "  float m0 = -INFINITY, m1 = -INFINITY;\n"
                                 "  for (int kc = 0; kc < N / 64; ++kc) {",
                                 "  float m0 = -INFINITY, m1 = -INFINITY;\n"
                                 "  for (int kc = 0; kc < 1; ++kc) {"),
    "gemm_chunk8_halves_swapped": (
        "gemm_tile.cuh",
        "v = __ldg(reinterpret_cast<const uint2*>(gemm_a_row<kMode>(a, r0, r) + k0 + c));",
        "v = __ldg(reinterpret_cast<const uint2*>(gemm_a_row<kMode>(a, r0, r) + k0 + (c ^ 4)));"),
    "up4c_chunk_second_half_dropped": (
        "up4_conv.cu", "__ldg(reinterpret_cast<const uint2*>(p + 4))",
        "__ldg(reinterpret_cast<const uint2*>(p))"),
    # the scaled training step's forms (chip_smoke.scaled_train_cases): #1's
    # train form (gemm_tile.cuh's kModeDrop) with its drop-path scale
    # dropped; the big-window backward (csrc/block_bwd_big.cuh) with D =
    # rowsum(P dP) written as zeros for the dk/dv launch, or with the row
    # maximum the backward launches read off the forward's (P scaled by 1/e
    # there); #9's wide form given C=180's pad channels with nonzero
    # weights (kernels/upsample.py's padding: the pad channels leak into
    # the real ones)
    "seq_dp_dropped": ("gemm_tile.cuh",
                       "a.dp[2 * (row / ((long long)a.H * a.W)) + a.dpi] * (s + a.bias[col]));",
                       "(s + a.bias[col]));"),
    "big_bwd_d_zeroed": ("block_bwd_big.cuh",
                         "      a.dsum[st] = rd0;\n      a.dsum[st + 8] = rd1;",
                         "      a.dsum[st] = 0.f;\n      a.dsum[st + 8] = 0.f;"),
    "big_bwd_max_off": ("block_bwd_big.cuh", "    a.rmax[st] = m0;\n    a.rmax[st + 8] = m1;",
                        "    a.rmax[st] = m0 + 1.f;\n    a.rmax[st + 8] = m1 + 1.f;"),
    "up4_wide_pad_leak": ("../upsample.py",
                          "    square = lambda w: F.pad(w, (0, pad, 0, pad)).contiguous()",
                          "    square = lambda w: F.pad(w, (0, pad, 0, pad), value=0.05).contiguous()"),
}

# Faults in the serving path, each of which chip_smoke's export phase must
# catch: name: (file under sunet_tf_tpu_torch, text, replacement). The ops'
# CUDA implementation that runs the plain version on copies of its operands
# on the CPU (a hidden fallback: caught by the launch counts), and
# ServingModel calling bucket 4 with a request of 3 without its zero-padded
# tail (caught by the n = 3 request).
# The parallel tier's mutants (Python, under sunet_tf_tpu_torch/), each run
# through chip_smoke's parallel phase, which must fail: the loss normalised
# by each rank's own sum of weights (a mean of per-rank losses; the 2 + 1
# valid batch catches it), and the Swin weights' gradients averaged over the
# spatial group instead of summed (the SPATIAL=2 step catches it).
PARALLEL_MUTANTS = {
    "loss_per_rank_weights": (
        "train/loop.py",
        "    den = comm.all_reduce_sum(mesh, mesh.data_group, w.sum().detach())",
        "    den = w.sum().detach()"),
    "spatial_grads_averaged": (
        "train/loop.py",
        "        _flat_all_reduce(mesh, mesh.spatial_group, sp)",
        "        _flat_all_reduce(mesh, mesh.spatial_group, sp, 1.0 / mesh.shape[\"spatial\"])"),
}

# The float64 oracle's and the C2 gate's mutants (Python, under
# sunet_tf_tpu_torch/): mm32 demoting float64 operands to float32 again (the
# parity phase's float64 probe check, the oracle on the card against the
# CPU, catches it), and the residual route's backward (#7's wrapper, the
# kernel path alone) with the wqkv gradient of the C=96 blocks at drop-path
# rate 0 (the first block of each C=96 stage) scaled by 1.01 (the train
# phase's per-stage C2 gate against float64 catches it).
FLOAT64_MUTANTS = {
    "mm32_float32_demotion": (
        "kernels/window_attention.py",
        """    ct = torch.promote_types(torch.promote_types(a.dtype, b.dtype), torch.float32)
    return torch.matmul(a.to(ct), b.to(ct))""",
        """    return torch.matmul(a.float(), b.float())"""),
    "res_c96_dwqkv_scaled": (
        "kernels/window_attention.py",
        """    count.cuda += launches.value
    return (dx, *grads)


class SwinBlockTrainableRes(""",
        """    count.cuda += launches.value
    if C == 96 and bool((dp == 1).all()):
        grads[2] *= 1.01
    return (dx, *grads)


class SwinBlockTrainableRes("""),
}

# The data phase's mutants (Python, under sunet_tf_tpu_torch/), each run
# through chip_smoke's data phase, which must fail: a checkpointed block
# that draws its randomness inside the checkpoint, so the recompute in
# backward draws other masks and drop-path scales (the generator state and
# the gate catch it), and the attention dropout moved after the cast to
# bf16 (the probabilities site's dtype check catches it).
DATA_MUTANTS = {
    "ckpt_redraws_in_recompute": (
        "models/sunet.py",
        """                    x = checkpoint(blk.train_forward, x, *blk.draws(x, generator),
                                   use_reentrant=False)""",
        """                    x = checkpoint(blk, x, generator, use_reentrant=False)"""),
    "attn_dropout_after_bf16_cast": (
        "models/layers.py",
        """        attn = dropout(torch.softmax(attn, dim=-1), self.attn_drop, generator)
        out = wa.mm32(attn.to(dt), v).to(dt)""",
        """        attn = torch.softmax(attn, dim=-1)
        out = wa.mm32(dropout(attn.to(dt), self.attn_drop, generator), v).to(dt)"""),
}

EXPORT_MUTANTS = {
    "op_cuda_runs_plain": ("kernels/ops.py", """        _LIB.impl(_name, IMPLS[_name], _key)""",
                           """        _LIB.impl(_name, IMPLS[_name] if _key == "CPU" else (
            lambda f: lambda *a, **k: f(*[t.cpu() if isinstance(t, torch.Tensor) else [
                u.cpu() for u in t] if isinstance(t, list) else t for t in a], **k).cuda())(
            IMPLS[_name]), _key)"""),
    "serving_tail_unpadded": ("infer/export.py", "        if n < b:\n            x = torch.cat(",
                              "        if n < 0:\n            x = torch.cat("),
}

# Run inside a checkout: the backward checks of chip_smoke in one setting.
CASES = r'''
import sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from sunet_tf_tpu_torch.kernels import upsample as up
from sunet_tf_tpu_torch.kernels import window_attention as wa
from sunet_tf_tpu_torch.ops.window import shift_attn_mask

mode, seed, gain = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
fails = []
cs.check = lambda cond, msg: cond or fails.append(msg)
gen = torch.Generator(device="cuda").manual_seed(seed)
B, ws, heads, scale = 2, 8, 8, 8.0
dp = torch.tensor([[1 / 0.9, 1 / 0.9], [1 / 0.9, 0.0]], device="cuda")
cpu = lambda t: (None if t is None else tuple(cpu(u) for u in t) if isinstance(t, tuple)
                 else t.cpu())
tag = f"[{mode} seed {seed} gain {gain:g}]"
for H, C in ((64, 96), (32, 192), (16, 384)):
    for shift in (0, 4):
        p = cs.block_params(C, heads, ws * ws, gen, qkv_gain=gain)
        x = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
        dout = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
        mask = (torch.as_tensor(shift_attn_mask(H, H, ws, shift), device="cuda")
                if shift else None)
        args = (x, dout, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10], p[11],
                p[12], mask, dp)
        kw = dict(ws=ws, num_heads=heads, scale=scale, shift=shift)
        ref = wa.swin_block_bwd_reference(*args, **kw)
        got = (wa.swin_block_bwd_reference(*cpu(args), **kw) if mode == "floor"
               else wa.swin_block_bwd(*args, **kw))
        cs.compare_grads(f"swin_block_bwd ({H},{H},{C}) shift {shift} {tag}",
                         tuple(g.cuda() for g in got), ref, cs.BLOCK_GRADS)
n = lambda *s: torch.randn(*s, device="cuda", generator=gen)
bw = lambda i, o: (n(i, o) / i ** 0.5).to(torch.bfloat16)
H, C = 64, 96
hp = (n(B, H, H, C).to(torch.bfloat16), bw(C, 16 * C), torch.full((1,), 0.25, device="cuda"),
      bw(C, C), 0.1 * n(C), torch.full((1,), 0.2, device="cuda"), bw(C, C), bw(C, C),
      (n(3, 3, C, 1) / (9 * C) ** 0.5).to(torch.bfloat16), n(B, H, H, 16).to(torch.bfloat16))
ref = up.up4_conv_bwd_reference(*hp)
got = (up.up4_conv_bwd_reference(*cpu(hp)) if mode == "floor" else up.up4_conv_bwd(*hp))
cs.compare_grads(f"up4_conv_bwd (64,64,96) out 1 {tag}", tuple(g.cuda() for g in got), ref,
                 cs.UP4_GRADS)
for name, case, kernel, plain, args, kw, _, labels in cs.sublayer_cases(gen, gain=gain):
    ref = plain(*args, **kw)
    got = plain(*cpu(args), **kw) if mode == "floor" else kernel(*args, **kw)
    if labels is None:
        cs.compare(f"{name} {case} {tag}", got.cuda(), ref)
    else:
        cs.compare_grads(f"{name} {case} {tag}", tuple(g.cuda() for g in got), ref, labels)
for H, C in ((64, 96), (32, 192)):
    for shift in (0, 4):
        p = cs.block_params(C, heads, ws * ws, gen, qkv_gain=gain)
        x = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
        dout = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
        mask = (torch.as_tensor(shift_attn_mask(H, H, ws, shift), device="cuda")
                if shift else None)
        kw = dict(ws=ws, num_heads=heads, scale=scale, shift=shift)
        fargs = (x, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10], p[11], p[12],
                 mask, dp)
        fwd = (wa.fused_swin_block_res_reference if mode == "floor" else wa.fused_swin_block_res)
        out, *res = fwd(*fargs, **kw)
        if mode != "floor":
            ref_out, *ref_res = wa.fused_swin_block_res_reference(*fargs, **kw)
            name = f"fused_swin_block_res ({H},{H},{C}) shift {shift} {tag}"
            cs.compare(f"{name} out", out, ref_out)
            cs.check_res_state(name, tuple(res), tuple(ref_res), x, p, mask, ws=ws, heads=heads,
                               scale=scale, shift=shift)
        args = (x, dout, *res, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10], p[11],
                dp)
        ref = wa.swin_block_bwd_res_reference(*args, **kw)
        got = (wa.swin_block_bwd_res_reference(*cpu(args), **kw) if mode == "floor"
               else wa.swin_block_bwd_res(*args, **kw))
        cs.compare_grads(f"swin_block_bwd_res ({H},{H},{C}) shift {shift} {tag}",
                         tuple(g.cuda() for g in got), ref, cs.BLOCK_GRADS)
# the split head (#10, #11) and the standalone W-MSA (#15), drawn last so
# that the cases above keep their inputs
for H, W in ((64, 64), (30, 44)):
    hp = cs.split_head_args(gen, B, H, W, 96)
    ref = up.fused_dual_upsample4_reference(*hp)
    got = (up.fused_dual_upsample4_reference(*cpu(hp)) if mode == "floor"
           else up.fused_dual_upsample4(*hp))
    cs.compare(f"fused_dual_upsample4 ({H},{W},96) {tag}", got.cuda(), ref)
    dout = torch.randn(B, 4 * H, 4 * W, 96, device="cuda", generator=gen).to(torch.bfloat16)
    ref = up.up4_bwd_reference(*hp, dout)
    got = (up.up4_bwd_reference(*cpu(hp), dout.cpu()) if mode == "floor"
           else up.up4_bwd(*hp, dout))
    cs.compare_grads(f"up4_bwd ({H},{W},96) {tag}", tuple(g.cuda() for g in got), ref,
                     cs.UP4_SPLIT_GRADS)
for shift in (0, 4):
    p = cs.block_params(96, heads, ws * ws, gen, qkv_gain=gain)
    x = torch.randn(B, 64, 64, 96, device="cuda", generator=gen).to(torch.bfloat16)
    mask = (torch.as_tensor(shift_attn_mask(64, 64, ws, shift), device="cuda")
            if shift else None)
    args = (x, p[2], p[3], p[4], p[5], p[12], mask)
    kw = dict(ws=ws, num_heads=heads, scale=scale)
    ref = wa.fused_window_attention_reference(*args, **kw)
    got = (wa.fused_window_attention_reference(*cpu(args), **kw) if mode == "floor"
           else wa.fused_window_attention(*args, **kw))
    cs.compare(f"wmsa_core (64,64,96) shift {shift} {tag}", got.cuda(), ref)
# the cluster block kernel (#1) at the three widths, shift 0 and 4, and the
# LN+MLP kernel (#4), drawn last so that the cases above keep their inputs
for H, C in ((64, 96), (32, 192), (16, 384)):
    for shift in (0, 4):
        p = cs.block_params(C, heads, ws * ws, gen, qkv_gain=gain)
        x = torch.randn(B, H, H, C, device="cuda", generator=gen).to(torch.bfloat16)
        mask = (torch.as_tensor(shift_attn_mask(H, H, ws, shift), device="cuda")
                if shift else None)
        args = (x, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10], p[11], p[12],
                mask)
        kw = dict(ws=ws, num_heads=heads, scale=scale, shift=shift)
        ref = wa.fused_swin_block_reference(*args, **kw)
        got = (wa.fused_swin_block_reference(*cpu(args), **kw) if mode == "floor"
               else wa.fused_swin_block(*args, **kw))
        cs.compare(f"fused_swin_block ({H},{H},{C}) shift {shift} {tag}", got.cuda(), ref)
p = cs.block_params(768, heads, ws * ws, gen, qkv_gain=gain)
y = torch.randn(B, 8, 8, 768, device="cuda", generator=gen).to(torch.bfloat16)
args = (y, p[6:8], p[8], p[9], p[10], p[11])
ref = wa.fused_ln_mlp_reference(*args)
got = (wa.fused_ln_mlp_reference(*cpu(args)) if mode == "floor" else wa.fused_ln_mlp(*args))
cs.compare(f"fused_ln_mlp (8,8,768) {tag}", got.cuda(), ref)
# the LN+W-MSA kernel (#3) at the main path's (8,8,768), batch 4, and with
# the SW mask, and the conv-fused x4 head (#5) at the main path's grid and
# on a map that is not a multiple of its tile, drawn last
for Bt, H, shift in ((4, 8, 0), (2, 16, 4)):
    p = cs.block_params(768, heads, ws * ws, gen, qkv_gain=gain)
    x = torch.randn(Bt, H, H, 768, device="cuda", generator=gen).to(torch.bfloat16)
    mask = (torch.as_tensor(shift_attn_mask(H, H, ws, shift), device="cuda")
            if shift else None)
    args = (x, *p[0:6], p[12], mask)
    kw = dict(ws=ws, num_heads=heads, scale=scale)
    ref = wa.fused_ln_window_attention_reference(*args, **kw)
    got = (wa.fused_ln_window_attention_reference(*cpu(args), **kw) if mode == "floor"
           else wa.fused_ln_window_attention(*args, **kw))
    cs.compare(f"fused_ln_window_attention batch {Bt} ({H},{H},768) shift {shift} {tag}",
               got.cuda(), ref)
for Bt, H, W, out_ch in ((4, 64, 64, 1), (2, 34, 40, 3)):
    hp = (n(Bt, H, W, 96).to(torch.bfloat16), bw(96, 16 * 96),
          torch.full((1,), 0.25, device="cuda"), bw(96, 96), 0.1 * n(96),
          torch.full((1,), 0.2, device="cuda"), bw(96, 96), bw(96, 96),
          (n(3, 3, 96, out_ch) / (9 * 96) ** 0.5).to(torch.bfloat16))
    ref = up.fused_dual_upsample4_conv_phase_reference(*hp)
    got = (up.fused_dual_upsample4_conv_phase_reference(*cpu(hp)) if mode == "floor"
           else up.fused_dual_upsample4_conv_phase(*hp))
    cs.compare(f"fused_dual_upsample4_conv_phase batch {Bt} ({H},{W},96) out {out_ch} {tag}",
               got.cuda(), ref)
# the conv-fused head's backward (#9) on a map of partial tiles, out 3,
# drawn last
hp = (n(B, 34, 40, 96).to(torch.bfloat16), bw(96, 16 * 96), torch.full((1,), 0.25, device="cuda"),
      bw(96, 96), 0.1 * n(96), torch.full((1,), 0.2, device="cuda"), bw(96, 96), bw(96, 96),
      (n(3, 3, 96, 3) / (9 * 96) ** 0.5).to(torch.bfloat16), n(B, 34, 40, 48).to(torch.bfloat16))
ref = up.up4_conv_bwd_reference(*hp)
got = (up.up4_conv_bwd_reference(*cpu(hp)) if mode == "floor" else up.up4_conv_bwd(*hp))
cs.compare_grads(f"up4_conv_bwd (34,40,96) out 3 {tag}", tuple(g.cuda() for g in got), ref,
                 cs.UP4_GRADS)
# the scaled geometry's forms (chip_smoke.scaled_cases, drawn from this
# setting's seed), and #2's chain at C=360 on the card
sgen = torch.Generator(device="cuda").manual_seed(seed)
for c in cs.scaled_cases(sgen):
    ref = c["plain"](*c["args"], **c["kw"])
    got = (c["plain"](*cpu(c["args"]), **c["kw"]) if mode == "floor"
           else c["fn"](*c["args"], **c["kw"]))
    cs.compare(f"{c['name']} {c['case']} {tag}", got.cuda(), ref, c["tie"],
               mean_tol=c["mean_tol"])
if mode != "floor":
    cs.scaled_chain_check(sgen)
# the scaled training step's forms (chip_smoke.scaled_train_cases): #1's
# train form, the big-window backward, #5 and #9's wide form
tgen = torch.Generator(device="cuda").manual_seed(seed + 1)
for c in cs.scaled_train_cases(tgen):
    ref = c["plain"](*c["args"], **c["kw"])
    got = (c["plain"](*cpu(c["args"]), **c["kw"]) if mode == "floor"
           else c["fn"](*c["args"], **c["kw"]))
    if c["grads"] is None:
        cs.compare(f"{c['name']} {c['case']} {tag}", got.cuda(), ref, mean_tol=c["mean_tol"])
    else:
        cs.compare_grads(f"{c['name']} {c['case']} {tag}", tuple(g.cuda() for g in got), ref,
                         c["grads"])
print(f"SUMMARY {tag}: {len(fails)} failing checks", flush=True)
for f in fails:
    print(f"  failing: {f}", flush=True)
'''


# Run inside a checkout: the LN+W-MSA backward's (#12) dx over many draws of
# inputs (chip_smoke.sublayer_cases, fresh generator per seed, qkv gain 1
# and 0.25), kernel and plain version on the CPU each against the plain
# version on the card: mean |diff| over max(1, mean|ref|), the quantity of
# its dx mean limit.
DX_DRAWS = r'''
import sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs

cpu = lambda t: (None if t is None else tuple(cpu(u) for u in t) if isinstance(t, tuple)
                 else t.cpu())
worst = {"kernel": (0.0, ""), "floor": (0.0, "")}
for seed in range(1, int(sys.argv[1]) + 1):
    for gain in (1.0, 0.25):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for name, case, kernel, plain, args, kw, _, _ in cs.sublayer_cases(gen, gain=gain):
            if name != "ln_window_attention_bwd":
                continue
            ref = plain(*args, **kw)[0].float()
            scale = max(1.0, float(ref.abs().mean()))
            for mode, got in (("kernel", kernel(*args, **kw)[0]),
                              ("floor", plain(*cpu(args), **kw)[0])):
                d = (got.cuda().float() - ref).abs()
                rel = float(d.mean()) / scale
                tag = f"seed {seed} gain {gain:g} {case}"
                worst[mode] = max(worst[mode], (rel, tag))
                print(f"DRAW {mode} {tag}: dx mean|diff| / max(1, mean|ref|) {rel:.4e}, "
                      f"max|diff| {float(d.max()):.3e}, mean|ref| {float(ref.abs().mean()):.3e}",
                      flush=True)
for mode, (rel, tag) in worst.items():
    print(f"SUMMARY [ln_window_attention_bwd dx draws] largest {mode} reading {rel:.4e} "
          f"({tag}); chip_smoke's limit {cs.dx_mean_tol('ln_window_attention_bwd'):g}",
          flush=True)
'''


def run_export(cwd: Path, name: str, log, phase: str = "export") -> list:
    """chip_smoke's ``phase`` in the checkout ``cwd``; a SUMMARY line of
    whether it failed (as a mutant must)."""
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--phases", phase], cwd=cwd,
                          capture_output=True, text=True)
    log.write(proc.stdout + proc.stderr)
    log.flush()
    if proc.returncode == 0:
        return [f"SUMMARY [{name}]: the {phase} phase PASSED: the mutant was not caught"]
    lines = (proc.stdout + proc.stderr).strip().splitlines()
    why = next((ln for ln in reversed(lines) if "FAILED" in ln or "Error" in ln), lines[-1])
    return [f"SUMMARY [{name}]: the {phase} phase failed (exit {proc.returncode}): "
            f"{why.strip()[:300]}"]


def run(cwd: Path, mode: str, seed: int, gain: float, log) -> list:
    proc = subprocess.run([sys.executable, "-c", CASES, mode, str(seed), str(gain)], cwd=cwd,
                          capture_output=True, text=True)
    log.write(proc.stdout + proc.stderr)
    log.flush()
    if proc.returncode != 0:
        raise SystemExit(f"chip_mutants: {mode} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    return [ln for ln in proc.stdout.splitlines() if ln.startswith("SUMMARY")]


# The step setting's pairs of variants compared per stage: each fused
# route against its plain-version route (how far its kernels alone move the
# gradients) and against its own float32 drop-path product, and the eager
# route against its two sound variants (how far a rounding point moves
# them, no kernel involved).
PAIRS = (("fused", "fused, every kernel by its plain version"),
         ("fused, ROUTE_TRAIN_RESID off",
          "fused, ROUTE_TRAIN_RESID off, every kernel by its plain version"),
         ("fused", "fused, drop-path product in float32"),
         ("fused, ROUTE_TRAIN_RESID off", "fused, ROUTE_TRAIN_RESID off, drop-path product in "
          "float32"),
         ("eager", "eager, drop-path product in float32"),
         ("eager", "eager, JAX's residual attention"))
# chip_smoke's NOISE_ROUTES by their step-setting labels
NOISE_LABELS = {"eager": "eager", "eager_dp32": "eager, drop-path product in float32",
                "eager_res": "eager, JAX's residual attention",
                "eager_res_dp32": "eager, JAX's residual attention, drop-path product in "
                                  "float32"}


def step_noise(log, dists_out: Path) -> list:
    """The ``step`` setting: one-value gradients of the training step under
    bf16 rounding variants, against the float32 eager route; every run's
    per-tensor (cos, rl2) against it goes to ``dists_out`` (JSON)."""
    import json

    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from sunet_tf_tpu_torch.config import Config
    from sunet_tf_tpu_torch.data.pipeline import PairDataset, batch_iterator
    from sunet_tf_tpu_torch.data.synth import generate_dataset
    from sunet_tf_tpu_torch.kernels import window_attention as wa
    from sunet_tf_tpu_torch.models import layers
    from sunet_tf_tpu_torch.models.sunet import build_model
    from sunet_tf_tpu_torch.train.loop import (loss_and_metrics, prepare, step_generators,
                                               to_device)

    def say(line: str):
        print(line, flush=True)
        log.write(line + "\n")

    cfg, task = Config(), "mask"
    with tempfile.TemporaryDirectory() as tmp:
        generate_dataset(tmp + "/train", 12, size=256, seed=0)
        ds = PairDataset(tmp + "/train", 256, train=True, seed=0)
        batch = to_device(next(batch_iterator(ds, 4, shuffle=True, drop_last=True, seed=0)),
                          "cuda")
    models = {"fused": build_model(cfg, device="cuda", backend="fused", seed=0),
              "eager": build_model(cfg, device="cuda", backend="eager", seed=0),
              "eager_fp32": build_model(cfg.replace(compute_dtype="float32"), device="cuda",
                                        backend="eager", seed=0)}
    for be in ("eager", "eager_fp32"):
        models[be].load_state_dict(models["fused"].state_dict())
    inp, tar = prepare(batch, task, 50.0, step_generators(0, 0, "cuda")[0])
    valid = torch.ones(4, device="cuda")
    acts = {}
    for be, m in models.items():
        m.layers[-1].register_forward_hook(
            lambda mod, args, out, be=be: acts.__setitem__(be, out.detach().float()))

    def step(be: str) -> tuple:
        m = models[be]
        m.train().requires_grad_(True)
        with wa.exact_fp32():
            loss, _, _ = loss_and_metrics(m, inp, tar, step_generators(0, 0, "cuda")[1], valid,
                                          task)
            loss.backward()
        g = {n: p.grad.double().flatten().clone() for n, p in m.named_parameters()
             if p.grad is not None}
        m.zero_grad(set_to_none=True)
        return float(loss.detach()), g, acts[be]

    rl2 = lambda a, b: float((a - b).norm() / b.norm())
    loss32, ref, ref_act = step("eager_fp32")
    gated = [n for n, v in ref.items() if bool(v.any())]
    kept = {}    # first-run gradients of the variants PAIRS compares
    dists = []   # (label, run, {tensor: (cos, rl2) against float32})
    one = sorted(n for n, v in ref.items() if v.numel() == 1)
    say("[step] one-value gradients (float32 route): "
        + " ".join(f"{n} {ref[n].item():.3e}" for n in one))
    dp32 = cs.drop_path_f32
    sublayers = ("fused_ln_window_attention", "ln_window_attention_bwd", "ln_mlp_branch",
                 "ln_mlp_bwd")
    plain = cs.plain_kernel_patches()
    c768_eager = (layers, "ROUTE_TRAIN_SPLIT_MAX_C", layers.ROUTE_TRAIN_BLOCK_MAX_C)
    variants = (
        ("fused", "fused", []),
        ("fused, every kernel by its plain version", "fused", plain),
        ("fused, fused_swin_block_res by its plain version", "fused",
         [(wa, "fused_swin_block_res", wa.fused_swin_block_res_reference)]),
        ("fused, swin_block_bwd_res by its plain version", "fused",
         [(wa, "swin_block_bwd_res", wa.swin_block_bwd_res_reference)]),
        ("fused, every kernel by its plain version, drop-path product in float32", "fused",
         [*plain, (layers, "drop_path", dp32)]),
        ("fused, every kernel by its plain version, C=768 on eager autograd", "fused",
         [*plain, c768_eager]),
        ("fused, every kernel by its plain version, C=768 on eager autograd, drop-path "
         "product in float32", "fused", [*plain, c768_eager, (layers, "drop_path", dp32)]),
        ("fused, ROUTE_TRAIN_RESID off, every kernel by its plain version", "fused",
         [(layers, "ROUTE_TRAIN_RESID", False), *plain]),
        ("fused, ROUTE_TRAIN_RESID off", "fused", [(layers, "ROUTE_TRAIN_RESID", False)]),
        ("fused, C=768 on eager autograd", "fused", [c768_eager]),
        ("fused, C=768 sublayers by their plain versions", "fused",
         [(wa, n, getattr(wa, n + "_reference")) for n in sublayers]),
        ("fused, drop-path product in float32", "fused", [(layers, "drop_path", dp32)]),
        ("fused, ROUTE_TRAIN_RESID off, drop-path product in float32", "fused",
         [(layers, "ROUTE_TRAIN_RESID", False), (layers, "drop_path", dp32)]),
        *((label, "eager", cs.route_patches(be)) for be, label in NOISE_LABELS.items()))
    worst = (0.0, "", "")
    for label, be, patches in variants:
        runs = []
        for run in (1, 2):
            with cs.patched(patches):
                loss, g, act = step(be)
            runs.append(g)
            dists.append((label, run, {n: cs.grad_distance(g[n], ref[n]) for n in gated}))
            err = {n: float((g[n] - ref[n]) / ref[n]) for n in one}
            worst = max(worst, *((abs(e), n, label) for n, e in err.items()))
            say(f"[step] {label}, run {run}: loss rel err {abs(loss - loss32) / loss32:.3e}; "
                f"C=768 stage output rl2 {rl2(act, ref_act):.3e}; one-value gradients' "
                "relative errors: " + " ".join(f"{n} {e:+.3e}" for n, e in err.items()))
        same = sum(torch.equal(runs[0][n], runs[1][n]) for n in runs[0])
        say(f"[step] {label}: {same} of {len(runs[0])} gradient tensors bit-identical "
            "between its two runs")
        if any(label in pair for pair in PAIRS):
            kept[label] = runs[0]
    dists_out.write_text(json.dumps({f"{label}|{run}": d for label, run, d in dists}))
    covered = worst[0] <= cs.ONE_VALUE_NOISE
    summary = [f"SUMMARY [step]: largest one-value relative error {worst[0]:.4e} ({worst[1]}, "
               f"{worst[2]}); chip_smoke.ONE_VALUE_NOISE {cs.ONE_VALUE_NOISE} "
               + ("covers it" if covered else "DOES NOT cover it")]
    # chip_smoke's noise reference: per tensor, the farthest first run of
    # its NOISE_ROUTES (the kernel-free variants)
    first = {label: d for label, run, d in dists if run == 1}
    refs = [first[NOISE_LABELS[be]] for be in cs.NOISE_ROUTES]
    noise = {n: (min(d[n][0] for d in refs), max(d[n][1] for d in refs)) for n in gated}
    noisy = [n for n in gated if first["eager"][n][0] < cs.TRAIN_GRAD_COS
             or first["eager"][n][1] > cs.TRAIN_GRAD_RL2]
    for a in ("eager", "eager, JAX's residual attention", "fused",
              "fused, ROUTE_TRAIN_RESID off", "fused, every kernel by its plain version"):
        b = a + ", drop-path product in float32"
        r = sorted(max(x, y) / max(min(x, y), 1e-30) for x, y in
                   ((1 - first[a][n][0], 1 - first[b][n][0]) for n in noisy))
        summary.append(f"SUMMARY [step] spread, {a} against its float32 drop-path product, "
                       f"1 - cos ratio over {len(r)} noise-dominated tensors: median "
                       f"{r[len(r) // 2]:.2f}, 95% {r[int(0.95 * len(r))]:.2f}, largest "
                       f"{r[-1]:.2f}, {sum(x > 2 for x in r)} above 2")
    # how far each variant sits from float32 over all noise-dominated
    # tensors at once: the geometric mean of its 1 - cos over eager's
    gm = lambda d, ns: math.exp(sum(math.log(max(1 - d[n][0], 1e-30)
                                             / max(1 - first["eager"][n][0], 1e-30))
                                    for n in ns) / len(ns))
    bottleneck = [n for n in noisy if n.startswith("layers.3.")]
    for label, d in first.items():
        summary.append(f"SUMMARY [step] geometric mean of 1 - cos over eager's, {label}: "
                       f"{len(noisy)} noise-dominated tensors {gm(d, noisy):.3f}, the "
                       f"{len(bottleneck)} at layers.3 {gm(d, bottleneck):.3f}; closer to float32 "
                       f"than eager (rl2) in {sum(d[n][1] <= first['eager'][n][1] for n in gated)}"
                       f" of {len(gated)} tensors")
    stage = lambda n: ".".join(n.split(".")[:2]) if n.startswith("layers") else n.split(".")[0]
    stages = sorted({stage(n) for n in gated if n.startswith("layers")})
    for label, d in first.items():
        med = [sorted(d[n][1] for n in gated if stage(n) == st
                      and "relative_position" not in n) for st in stages]
        summary.append(f"SUMMARY [step] median relative L2 per stage (rel-pos tables left out), "
                       f"{label}: " + " ".join(f"{st} {m[len(m) // 2]:.4f}"
                                               for st, m in zip(stages, med)))
    for a, b in PAIRS:
        by_stage = {}
        for n in gated:
            by_stage.setdefault(stage(n), []).append(
                (*cs.grad_distance(kept[a][n], kept[b][n]), n))
        far = {st: max(v, key=lambda t: t[1]) for st, v in by_stage.items()}
        summary.append(f"SUMMARY [step] {a} against {b}, per stage (worst cosine, largest "
                       "relative L2 and its tensor): " + "; ".join(
                           f"{st} {min(c for c, _, _ in v):.5f} {far[st][1]:.2e} "
                           f"{far[st][2][len(st) + 1:] or far[st][2]}"
                           for st, v in by_stage.items()))
    for label, run, d in dists:
        shares = sorted(((cs.gate_share(*d[n], *cs.grad_limits(ref[n].numel(), noise[n])), n)
                         for n in gated), reverse=True)
        beyond = sum(sh > 1 for sh, _ in shares)
        summary.append(f"SUMMARY [step] gate, {label}, run {run}: {beyond} of {len(gated)} "
                       "tensors beyond it; largest shares of the limit: "
                       + ", ".join(f"{n} {sh:.2f}" for sh, n in shares[:4]))
    return summary


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "sunet_tf_tpu_torch" / "kernels" / "_build"
                                         / "chip_mutants.log"))
    ap.add_argument("--step-only", action="store_true",
                    help="run the step setting alone")
    ap.add_argument("--mutants", default="", metavar="NAME,...",
                    help="run only these mutants (no other setting)")
    ap.add_argument("--sound", action="store_true",
                    help="run only the kernel and floor settings (no mutant, no step)")
    ap.add_argument("--dx-draws", type=int, default=0, metavar="N",
                    help="run only the LN+W-MSA backward's dx over N seeds of inputs")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_mutants: torch.cuda.is_available() is false")
    if not (ROOT / "sunet_tf_tpu_torch").is_dir():
        raise SystemExit(f"chip_mutants: package sunet_tf_tpu_torch not found at {ROOT}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    summary = []
    if args.dx_draws:
        proc = subprocess.run([sys.executable, "-c", DX_DRAWS, str(args.dx_draws)], cwd=ROOT,
                              capture_output=True, text=True)
        out.write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise SystemExit(f"chip_mutants: dx draws exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
        print("\n".join(ln for ln in proc.stdout.splitlines() if ln.startswith("SUMMARY")))
        print(f"chip_mutants: readings in {out}")
        return
    only = [m for m in args.mutants.split(",") if m]
    python_mutants = {**{k: (v, "export") for k, v in EXPORT_MUTANTS.items()},
                      **{k: (v, "parallel") for k, v in PARALLEL_MUTANTS.items()},
                      "mm32_float32_demotion": (FLOAT64_MUTANTS["mm32_float32_demotion"],
                                                "parity"),
                      "res_c96_dwqkv_scaled": (FLOAT64_MUTANTS["res_c96_dwqkv_scaled"],
                                               "train"),
                      **{k: (v, "data") for k, v in DATA_MUTANTS.items()}}
    if set(only) - set(MUTANTS) - set(python_mutants):
        raise SystemExit("chip_mutants: unknown mutants "
                         f"{sorted(set(only) - set(MUTANTS) - set(python_mutants))}")
    with open(out, "w") as log, tempfile.TemporaryDirectory() as tmp:
        if not args.step_only:
            if not only:
                for seed in (4321, 99):
                    for gain in (1.0, 0.25):
                        summary += run(ROOT, "kernel", seed, gain, log)
                summary += run(ROOT, "floor", 4321, 1.0, log)
            for name, edits in MUTANTS.items():
                if (only and name not in only) or args.sound:
                    continue
                copy = Path(tmp) / name
                shutil.copytree(ROOT, copy, ignore=shutil.ignore_patterns(
                    "_build", ".git", "__pycache__"))
                for src, old, new in edits if isinstance(edits, list) else [edits]:
                    path = copy / "sunet_tf_tpu_torch" / "kernels" / "csrc" / src
                    text = path.read_text()
                    if text.count(old) != 1:
                        raise SystemExit(f"chip_mutants: {name}: the text to mutate is not in "
                                         f"{src} once")
                    path.write_text(text.replace(old, new))
                summary += run(copy, name, 4321, 1.0, log)
            for name, ((src, old, new), phase) in python_mutants.items():
                if (only and name not in only) or args.sound:
                    continue
                from sunet_tf_tpu_torch.kernels import _build

                _build.library()
                # Python alone changes: the copy keeps this tree's kernel build
                copy = Path(tmp) / name
                shutil.copytree(ROOT, copy, ignore=shutil.ignore_patterns(".git", "__pycache__"))
                path = copy / "sunet_tf_tpu_torch" / src
                text = path.read_text()
                if text.count(old) != 1:
                    raise SystemExit(f"chip_mutants: {name}: the text to mutate is not in "
                                     f"{src} once")
                path.write_text(text.replace(old, new))
                summary += run_export(copy, name, log, phase)
        if not only and not args.sound:
            summary += step_noise(log, out.with_suffix(".dists.json"))
    print("\n".join(summary))
    print(f"chip_mutants: readings in {out}")


if __name__ == "__main__":
    main()
