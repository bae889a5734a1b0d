"""The default model's C=768 stage trained on the block kernels, as JAX's
default training route does (``_trainable_block`` up to
``_kernel_max_c(train=True)`` = 768): #1's train form at 64-token windows
where the cluster kernel refuses the block (the sequence form,
``csrc/swin_block_seq.cu``) and #8 at head dims above 64.

- ``SwinBlockTrainable`` on CPU tensors (the plain versions, what
  ``chip_smoke.py`` holds the kernels against), forward and every
  gradient, against JAX ``swin_block_trainable`` (Pallas in interpret mode)
  with ``SUNET_BWD_RESID=0`` and the per-head attention backward, at
  (1,8,8,768) with 8 heads (head dim 96) and on a shifted, masked
  (1,16,16,192) map with 2 heads (head dim 96); the wrappers' launches by
  form.
- The sequence form's five launches at 64 tokens emulated in plain torch
  with gemm_tile.cuh's row addressing (the SW roll as ``roll_row`` on A,
  the residual and the output; the mask by the rolled map's window) against
  the plain version.
- The router on ``device="meta"``: every C=768 block of ``Config()`` on the
  block kernels' recompute route, the step's launches written out, the
  spatial runner taking the C=768 stage at 512x512 over two spatial ranks
  as JAX's runner does; the plans of the new shapes within the H100's
  shared memory; the C entries handed their plans (library stubbed); an
  inference call the cluster kernel refuses still refused.

float32, inputs from numpy seeds handed to both sides; every output max
|diff| <= 1e-4 * max(1, max|ref|) (``test_torch_port_train.py``'s
tolerance: other summation orders, and the JAX kernels'
Abramowitz-Stegun erf).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunet_tf_tpu.kernels import window_attention as jwa
from sunet_tf_tpu.ops.window import shift_attn_mask
from sunet_tf_tpu.parallel import spatial as jsp
from sunet_tf_tpu.parallel.mesh import make_mesh as jax_mesh
from sunet_tf_tpu_torch.config import Config
from sunet_tf_tpu_torch.kernels import _build
from sunet_tf_tpu_torch.kernels import window_attention as twa
from sunet_tf_tpu_torch.models import layers
from sunet_tf_tpu_torch.models.sunet import build_model
from sunet_tf_tpu_torch.ops.window import window_partition, window_reverse
from sunet_tf_tpu_torch.parallel.mesh import Mesh
from sunet_tf_tpu_torch.parallel.spatial import SpatialStageRunner

REL = 1e-4
DP = np.array([[1 / 0.9, 1 / 0.8]], np.float32)   # both branches scaled, neither by 1
NAMES = ("dx", "dln1_g", "dln1_b", "dwqkv", "dbqkv", "dwproj", "dbproj", "dln2_g",
         "dln2_b", "dw1", "db1", "dw2", "db2", "dbias")
# (H, C, heads, shift): the default model's bottleneck, one window, head dim
# 96; a shifted, masked map of four windows at head dim 96
CASES = [(8, 768, 8, 0), (16, 192, 2, 4)]


def assert_close(got, want, what=""):
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= REL * max(1.0, np.abs(want).max()), (what, err, np.abs(want).max())


def _inputs(H, C, heads, shift, seed, ws=8):
    rng = np.random.default_rng(seed)
    n = lambda *s, sd=1.0: (rng.standard_normal(s) * sd).astype(np.float32)
    N, hid = ws * ws, 4 * C
    p = [1 + n(C, sd=0.1), n(C, sd=0.1), n(C, 3 * C, sd=C ** -0.5), n(3 * C, sd=0.1),
         n(C, C, sd=C ** -0.5), n(C, sd=0.1), 1 + n(C, sd=0.1), n(C, sd=0.1),
         n(C, hid, sd=C ** -0.5), n(hid, sd=0.1), n(hid, C, sd=hid ** -0.5), n(C, sd=0.1),
         n(heads, N, N)]
    x, dout = n(1, H, H, C), n(1, H, H, C)
    mask = shift_attn_mask(H, H, ws, shift) if shift else None
    return x, dout, p, mask, dict(ws=ws, num_heads=heads, scale=(C // heads) ** -0.5,
                                  shift=shift)


@pytest.mark.parametrize("H,C,heads,shift", CASES)
def test_trainable_block_matches_jax(H, C, heads, shift, monkeypatch):
    """Forward and every gradient of the port's SwinBlockTrainable (the
    sequence form's train form and #8 at head dim 96, their plain versions
    on the CPU) against JAX's swin_block_trainable, its recompute VJP."""
    monkeypatch.setenv("SUNET_BWD_RESID", "0")
    monkeypatch.setenv("SUNET_ATTN_LAYOUT_BWD", "perhead")
    x, dout, p, mask, kw = _inputs(H, C, heads, shift, 210 + H)
    ws, scale = kw["ws"], kw["scale"]
    static = None if mask is None else jwa.StaticMask(mask)
    f = lambda *a: jwa.swin_block_trainable(*a[:14], jnp.asarray(DP), static, ws, heads, scale,
                                            shift)
    want, vjp = jax.vjp(f, jnp.asarray(x), *[jnp.asarray(a) for a in p])
    want_grads = vjp(jnp.asarray(dout))

    leaves = [torch.from_numpy(a).clone().requires_grad_(True) for a in (x, *p)]
    _build.reset_counts()
    out = twa.SwinBlockTrainable.apply(
        *leaves, torch.from_numpy(DP), None if mask is None else torch.from_numpy(mask), ws,
        heads, scale, shift)
    out.backward(torch.from_numpy(dout))
    assert_close(out, want, "out")
    for name, leaf, w in zip(NAMES, leaves, want_grads):
        assert_close(leaf.grad, w, name)
    # the forms the calls took: the sequence form's train form (the cluster
    # kernel refuses head dim 96) and the recompute backward above head dim 64
    assert _build.counter("fused_swin_block").cpu == twa.SWIN_BLOCK_SEQ_LAUNCHES
    assert _build.counter(twa.SEQ64_FORM).cpu == twa.SWIN_BLOCK_SEQ_LAUNCHES
    assert _build.counter("swin_block_bwd").cpu == twa.SWIN_BLOCK_BWD_LAUNCHES
    assert _build.counter(twa.BWD_WIDE_HEAD_FORM).cpu == twa.SWIN_BLOCK_BWD_LAUNCHES


def _roll_rows(B, H, W, shift):
    """gemm_tile.cuh's roll_row: the row of the map that row r of the map
    rolled by -shift holds."""
    r = torch.arange(B * H * W)
    b, y, x = r // (H * W), (r // W) % H, r % W
    return b * H * W + ((y + shift) % H) * W + (x + shift) % W


def _emulate_seq(x, p, mask, dp, *, ws, num_heads, scale, shift):
    """The sequence form's five launches in plain torch over token rows in
    the rolled map's order, each row addressed as gemm_tile.cuh and
    wmsa_attn.cuh address it: 1. A = LN1 of x's rows gathered by roll_row,
    qkv at the rolled rows; 2. the attention per window of the rolled map
    (token t of window (wy, wx) at rolled row (wy ws + t / ws) W + wx ws + t
    % ws), the mask of that window; 3. y = x[roll_row] + s1 (ctx wproj +
    bproj) at the rolled rows; 4. LN2 + fc1 + GELU; 5. out[roll_row] = y + s2
    (h w2 + b2). float32 (no rounding points)."""
    B, H, W, C = x.shape
    rows = _roll_rows(B, H, W, shift)
    xf = x.reshape(-1, C)
    img = torch.arange(B * H * W) // (H * W)
    s1, s2 = dp[img, 0:1], dp[img, 1:2]
    qkv = twa.ln32(xf[rows], p[0], p[1]) @ p[2] + p[3]
    ctx = window_reverse(twa.attn_core_reference(
        window_partition(qkv[:, :C].reshape(B, H, W, C), ws).reshape(-1, ws * ws, C),
        window_partition(qkv[:, C:2 * C].reshape(B, H, W, C), ws).reshape(-1, ws * ws, C),
        window_partition(qkv[:, 2 * C:].reshape(B, H, W, C), ws).reshape(-1, ws * ws, C),
        p[12], mask, num_heads=num_heads, scale=scale), ws, H, W).reshape(-1, C)
    y = xf[rows] + s1 * (ctx @ p[4] + p[5])
    h = twa.gelu_erf(twa.ln32(y, p[6], p[7]) @ p[8] + p[9])
    out = torch.empty_like(xf)
    out[rows] = y + s2 * (h @ p[10] + p[11])
    return out.reshape(B, H, W, C)


@pytest.mark.parametrize("H,W,shift", [(16, 16, 4), (8, 16, 0), (16, 24, 4)])
def test_seq_form_row_addressing_at_64_tokens(H, W, shift):
    """The roll as row addressing at 64-token windows (kRollA, kRollY,
    kRollOut and the mask by the rolled map's window) gives the block of
    the plain version: the rolled map's windows are the rolled coordinates
    the mask is built in."""
    B, C, heads, ws = 2, 32, 2, 8
    rng = np.random.default_rng(300 + shift + W)
    n = lambda *s, sd=1.0: torch.from_numpy((rng.standard_normal(s) * sd).astype(np.float32))
    p = [1 + n(C, sd=0.1), n(C, sd=0.1), n(C, 3 * C, sd=C ** -0.5), n(3 * C, sd=0.1),
         n(C, C, sd=C ** -0.5), n(C, sd=0.1), 1 + n(C, sd=0.1), n(C, sd=0.1),
         n(C, 4 * C, sd=C ** -0.5), n(4 * C, sd=0.1), n(4 * C, C, sd=(4 * C) ** -0.5),
         n(C, sd=0.1), n(heads, 64, 64)]
    x = n(B, H, W, C)
    mask = torch.from_numpy(shift_attn_mask(H, W, ws, shift)) if shift else None
    dp = torch.tensor([[1 / 0.9, 0.0], [1 / 0.9, 1 / 0.8]])
    kw = dict(ws=ws, num_heads=heads, scale=8.0, shift=shift)
    want = twa.fused_swin_block_reference(x, p[0:2], *p[2:6], p[6:8], *p[8:13], mask, dp, **kw)
    got = _emulate_seq(x, p, mask, dp, **kw)
    assert_close(got, want.numpy(), "out")


def test_router_trains_c768_on_the_block_kernels():
    """Config(): the 8 C=768 blocks take the sequence form's train form and
    the recompute backward (JAX's rule keeps them off its residual route);
    the step's launches per wrapper."""
    model = build_model(Config(), device="meta", backend="fused", seed=0)
    c768 = list(model.layers[3].blocks)
    assert len(c768) == 8
    for blk in c768:
        assert blk.dim == 768 and blk.attn.num_heads == 8 and blk.window_size == 8
        assert blk.trains_on_block_kernels() and not blk.trains_on_residuals()
        assert not twa.cluster_takes(768, 3072, 8, 8) and twa.seq_form(768, 3072, 8, 8, True)
        assert not twa.bwd_residuals_enabled(768, 8, 64)
    got = model.expected_launches((4, 256, 256, 3), train=True)
    # C=96 and 192 (16 blocks each, encoder and decoder) on the residual
    # route: 32 x 1 forward, 32 x 10 backward; C=384 (16) on the cluster
    # kernel, 16 x 1, and C=768 (8) on the sequence form, 8 x 5: 16 + 40 =
    # 56 forward launches; both on the recompute backward: 24 x 11 = 264
    assert got["fused_swin_block_res"] == 32 and got["swin_block_bwd_res"] == 320
    assert got["fused_swin_block"] == 16 * 1 + 8 * twa.SWIN_BLOCK_SEQ_LAUNCHES == 56
    assert got["swin_block_bwd"] == 24 * twa.SWIN_BLOCK_BWD_LAUNCHES == 264
    for k in ("fused_ln_window_attention", "ln_window_attention_bwd", "ln_mlp_branch",
              "ln_mlp_bwd"):
        assert got[k] == 0, k


def test_old_cap_puts_c768_back_on_the_sublayer_kernels(monkeypatch):
    """ROUTE_TRAIN_BLOCK_MAX_C at 384 (the route before, chip_smoke's
    comparison): the C=768 stage on #3 + #12 and #13 + #14; at 384 with the
    sublayer cap too, on eager autograd."""
    monkeypatch.setattr(layers, "ROUTE_TRAIN_BLOCK_MAX_C", 384)
    model = build_model(Config(), device="meta", backend="fused", seed=0)
    blk = model.layers[3].blocks[0]
    assert not blk.trains_on_block_kernels() and blk.trains_on_split_kernels()
    got = model.expected_launches((4, 256, 256, 3), train=True)
    assert got["fused_swin_block"] == 16 and got["swin_block_bwd"] == 176
    assert got["ln_window_attention_bwd"] == 8 * twa.LN_WMSA_BWD_LAUNCHES
    monkeypatch.setattr(layers, "ROUTE_TRAIN_SPLIT_MAX_C", 384)
    assert not blk.trains_on_block_kernels() and not blk.trains_on_split_kernels()


def test_spatial_runner_takes_the_c768_stage_at_512():
    """The runner (no ranks started) takes Config()'s C=768 stage in
    training at 512x512 over two spatial ranks (a 16 x 16 map, two window
    rows a rank), as JAX's runner does; at 256x256 the map is one window
    and neither shards it; in inference the stage is above the cap 384."""
    cfg = Config()
    cfg = dataclasses.replace(cfg, swinunet=dataclasses.replace(cfg.swinunet, img_size=512))
    model = build_model(cfg, device="meta", backend="fused", seed=0)
    blocks = list(model.layers[3].blocks)
    port = SpatialStageRunner(Mesh(1, 2, 0, None))
    jrunner = jsp.PallasSpatialStageRunner(jax_mesh(data=1, spatial=2, devices=jax.devices()[:2]))
    stand_ins = [types.SimpleNamespace(window_size=b.window_size, shift_size=b.shift_size,
                                       ablate=(), _can_fuse=True) for b in blocks]
    for H, train, want in ((16, True, True), (8, True, False), (16, False, False)):
        shape = (2, H, H, 768)
        assert port.applies(blocks, shape, train) == want, (H, train)
        if train:
            assert jrunner.applies(stand_ins, shape, train) == want, (H, train)
    # the runner takes every stage at 512x512, each block on the recompute
    # route at shift 0: 48 blocks of C <= 384 on the cluster kernel, the 8
    # C=768 blocks on the sequence form (8 x 5), every backward 11 launches
    counts = model.expected_launches((2, 512, 512, 3), train=True, runner=port)
    assert counts["fused_swin_block"] == 48 + 8 * twa.SWIN_BLOCK_SEQ_LAUNCHES == 88
    assert counts["swin_block_bwd"] == 56 * twa.SWIN_BLOCK_BWD_LAUNCHES
    assert counts["fused_swin_block_res"] == counts["ln_window_attention_bwd"] == 0


@pytest.mark.parametrize("H,W,C,heads", [(8, 8, 768, 8), (16, 16, 768, 8), (8, 16, 768, 8),
                                         (16, 16, 384, 2), (16, 16, 192, 2)])
def test_new_plans_exist_and_fit(H, W, C, heads):
    plan = twa.block_seq_plan(H, W, C, 4 * C, 8, heads, train=True)
    assert plan["Kp"] == C and plan["attn_smem"] == 0
    assert max(v for k, v in plan.items() if k.startswith("smem_")) <= twa.SMEM_MAX
    assert plan["ctas_attn"] == twa.PLAN_BATCH * (H // 8) * (W // 8) * heads
    bwd = twa.block_bwd_plan(H, W, C, 4 * C, 8, heads)
    assert max(bwd["smem"].values()) <= twa.SMEM_MAX and bwd["G"] == -(-C // 128)
    # the sequence form takes the 64-token window in training alone
    with pytest.raises(ValueError, match="in training alone"):
        twa.block_seq_plan(H, W, C, 4 * C, 8, heads)


def test_recompute_head_dim_limit():
    """#8 takes even head dims whose attention fits shared memory (192 at
    64 tokens, as #12); the residual route (#7) keeps 64."""
    # C = 2d a multiple of 16: d a multiple of 8
    takes = [d for d in range(8, 400, 8) if twa.block_bwd_takes(2 * d, 8 * d, 2, 8)]
    assert takes == list(range(8, 200, 8))
    assert all(twa.block_bwd_takes(2 * d, 8 * d, 2, 8) == twa.ln_wmsa_bwd_takes(2 * d, 2, 8)
               for d in range(2, 400, 2))
    assert max(d for d in range(2, 400, 2)
               if twa.block_bwd_takes(2 * d, 8 * d, 2, 8, res=True)) == 64


def _stub_library(monkeypatch) -> dict:
    """The kernel library stubbed (each C entry's call recorded) and the
    wrappers' CUDA device check."""
    calls = {}

    class Lib:
        def __getattr__(self, fn):
            def call(*args):
                assert len(args) == len(_build.SIGNATURES[fn]), (fn, len(args))
                calls[fn] = args
                return 4096 if fn.endswith("_workspace") else 0
            return call

    monkeypatch.setattr(_build, "library", lambda: Lib())
    monkeypatch.setattr(_build, "stream", lambda: None)
    monkeypatch.setattr(_build, "ptr", lambda t: t)
    monkeypatch.setattr(twa, "_check_x", lambda *a: None)
    return calls


def test_entries_get_the_c768_plans(monkeypatch):
    """fused_swin_block with drop-path scales at (8,8,768) (meta tensors,
    library stubbed) calls the sequence form's entry with the train plan's
    K splits; without them the cluster kernel's cap refuses it, as JAX's
    inference cap; swin_block_bwd there calls the recompute entry, and the
    residual route's refuses head dim 96."""
    calls = _stub_library(monkeypatch)
    B, H, C, heads, hid = 4, 8, 768, 8, 3072
    m = lambda *s: torch.zeros(*s, dtype=torch.bfloat16, device="meta")
    f = lambda *s: torch.zeros(*s, device="meta")
    args = (m(B, H, H, C), (f(C), f(C)), m(C, 3 * C), f(3 * C), m(C, C), f(C), (f(C), f(C)),
            m(C, hid), f(hid), m(hid, C), f(C), f(heads, 64, 64), None)
    kw = dict(ws=8, num_heads=heads, scale=96 ** -0.5, shift=0)
    twa.fused_swin_block(*args, f(B, 2), **kw)
    plan = twa.block_seq_plan(H, H, C, hid, 8, heads, train=True)
    got = calls["sunet_swin_block_seq"]
    assert got[18:27] == (B, H, H, C, hid, 8, heads, 0, kw["scale"])
    assert got[27:32] == (plan["Kp"], plan["ksq"], plan["ksp"], plan["ks1"], plan["ks2"])
    assert "sunet_swin_block" not in calls
    with pytest.raises(ValueError, match="above the block-kernel cap 384"):
        twa.fused_swin_block(*args, **kw)
    twa.swin_block_bwd(args[0], m(B, H, H, C), *args[1:12], None, f(B, 2), **kw)
    assert calls["sunet_swin_block_bwd"][32:40] == (B, H, H, C, hid, 8, heads, 0)
    with pytest.raises(ValueError, match="head dim 96 above 64"):
        twa._check_bwd_design("swin_block_bwd_res", C, hid, heads, 8)
