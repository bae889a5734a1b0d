"""The scaled SUNet's training slice (``scaled_config``: EMB 180, WIN 16,
512x512) in the port, held against the JAX package on the CPU.

Everything that runs does so at the shrunk scaled shape of
``test_torch_port_scaled.py`` (``SHRUNK``: 128x128, EMB 60, heads
2/4/8/16, depth 2: C=60 and 120 at 256-token windows, C=60 not a multiple
of 16, head dim 30), float32, inputs from numpy seeds handed to both sides:

- #1's train form with drop-path scales (``fused_swin_block_reference``
  with dp, what a CPU tensor runs and what ``chip_smoke.py`` holds the
  sequence form's train form against) against JAX ``swin_block_trainable``
  (the Pallas block kernel in interpret mode), and #8
  (``swin_block_bwd_reference``, the big-window backward's plain version)
  against JAX ``_block_bwd_impl`` in interpret mode with the per-head
  attention backward, JAX's layout at 256 tokens, at one 16 x 16 window
  (shift 0) and a 32 x 32 map (shift 8, the SW mask), C=60, 2 heads. The
  forward at rtol = atol = 1e-4, the backward at
  ``test_torch_port_train.py``'s 1e-4 * max(1, max|ref|).
- #9 (``up4_conv_bwd_reference``) against JAX ``_up4c_bwd_impl`` at C=60
  and at the full size's C=180, on small maps.
- The full size's routing and plans on ``device="meta"``: 48 blocks on
  #1's train form + #8's big-window form, the 8 C=1440 blocks on eager
  autograd, the head on #5 + #9's wide form; every plan within the H100's
  shared memory; the shapes outside the design refused.
- The pads of the kernels' padded widths (C=180 over 192) added and taken
  off exactly, and the C entries handed their plans (library stubbed).

The whole shrunk training step is ``test_torch_port_scaled_train_step.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunet_tf_tpu.kernels import upsample as jup
from sunet_tf_tpu.kernels import window_attention as jwa
from sunet_tf_tpu.ops.window import shift_attn_mask
from sunet_tf_tpu_torch import config as tconfig
from sunet_tf_tpu_torch.kernels import _build
from sunet_tf_tpu_torch.kernels import upsample as tup
from sunet_tf_tpu_torch.kernels import window_attention as twa
from sunet_tf_tpu_torch.models.sunet import build_model

REL = 1e-4   # test_torch_port_train.py's backward tolerance
TOL = dict(rtol=1e-4, atol=1e-4)
SCALE = 30 ** -0.5   # head dim 30, qk_scale None
DP = np.array([[1 / 0.9, 1 / 0.8]], np.float32)   # both branches scaled, neither by 1
NAMES = ("dx", "dln1_g", "dln1_b", "dwqkv", "dbqkv", "dwproj", "dbproj", "dln2_g",
         "dln2_b", "dw1", "db1", "dw2", "db2", "dbias")
UP4_NAMES = ("dx", "dw_exp", "dalpha_p", "dw_b1", "db_b1", "dalpha_b", "dwpf", "dwbf",
             "dwconv")
# (H, shift) of the two 256-token cases: one window, and a map of four with
# the SW mask
CASES = [(16, 0), (32, 8)]


def assert_close(got, want, what=""):
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= REL * max(1.0, np.abs(want).max()), (what, err, np.abs(want).max())


def _block_inputs(H, shift, seed, C=60, heads=2, ws=16):
    rng = np.random.default_rng(seed)
    n = lambda *s, sd=1.0: (rng.standard_normal(s) * sd).astype(np.float32)
    N = ws * ws
    p = [1 + n(C, sd=0.1), n(C, sd=0.1), n(C, 3 * C, sd=C ** -0.5), n(3 * C, sd=0.1),
         n(C, C, sd=C ** -0.5), n(C, sd=0.1), 1 + n(C, sd=0.1), n(C, sd=0.1),
         n(C, 4 * C, sd=C ** -0.5), n(4 * C, sd=0.1), n(4 * C, C, sd=(4 * C) ** -0.5),
         n(C, sd=0.1), n(heads, N, N)]
    x, dout = n(1, H, H, C), n(1, H, H, C)
    mask = shift_attn_mask(H, H, ws, shift) if shift else None
    return x, dout, p, mask, dict(ws=ws, num_heads=heads, scale=SCALE, shift=shift)


def _port_args(x, dout, p, mask):
    t = [torch.from_numpy(a) for a in p]
    return (torch.from_numpy(x), torch.from_numpy(dout), t[0:2], t[2], t[3], t[4], t[5],
            t[6:8], t[8], t[9], t[10], t[11], t[12],
            None if mask is None else torch.from_numpy(mask), torch.from_numpy(DP))


@pytest.mark.parametrize("H,shift", CASES)
def test_train_form_n256_plain_matches_jax(H, shift):
    """#1's train form at 256 tokens a window: the plain version with
    drop-path scales (1/0.9 and 1/0.8) against JAX's trainable block."""
    x, _, p, mask, kw = _block_inputs(H, shift, 150 + shift)
    j = [jnp.asarray(a) for a in p]
    ref = jwa.swin_block_trainable(
        jnp.asarray(x), *j[:12], j[12], jnp.asarray(DP),
        None if mask is None else jwa.StaticMask(mask), kw["ws"], kw["num_heads"],
        kw["scale"], kw["shift"])
    args = _port_args(x, x, p, mask)
    got = twa.fused_swin_block(args[0], *args[2:13], args[13], args[14], **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("H,shift", CASES)
def test_block_bwd_n256_plain_matches_jax(H, shift, monkeypatch):
    """#8 at 256 tokens a window (head dim 30, C=60 not a multiple of 16):
    the plain version against JAX's recompute backward (the per-head
    attention backward, JAX's layout at N = 256)."""
    monkeypatch.setenv("SUNET_ATTN_LAYOUT_BWD", "perhead")
    x, dout, p, mask, kw = _block_inputs(H, shift, 160 + shift)
    want = jwa._block_bwd_impl(
        jnp.asarray(x), *[jnp.asarray(a) for a in p], jnp.asarray(DP),
        None if mask is None else jnp.asarray(mask), jnp.asarray(dout), kw["ws"],
        kw["num_heads"], kw["scale"], shift=shift)
    got = twa.swin_block_bwd_reference(*_port_args(x, dout, p, mask), **kw)
    for name, g, w in zip(NAMES, got, want):
        assert_close(g, w, name)


def test_jax_takes_the_per_head_layout_at_256_tokens():
    """At the scaled config's widths JAX's automatic layout is the per-head
    one and its residual route is off (``bwd_residuals_enabled``), so the
    recompute route is JAX's default there, and the port's rule agrees. At
    the shrunk C=60 and 120 (head dim 30 in 128 lanes either way) JAX's
    padded-MAC rule ties to blockdiag and its residual route; the port keeps
    the recompute route above 64 tokens, whose rounding points differ from
    it in bf16 alone."""
    for C, heads in ((180, 6), (360, 12), (720, 24)):
        assert jwa._attn_layout_bwd(C // heads, 256, C) == "perhead"
        assert not jwa.bwd_residuals_enabled(C, heads, 256)
        assert not twa.bwd_residuals_enabled(C, heads, 256)
    for C, heads in ((60, 2), (120, 4)):
        assert jwa.bwd_residuals_enabled(C, heads, 256) and twa.bwd_residuals_enabled(C, heads, 256)
    model = build_model(tconfig.scaled_config(img_size=128, emb_dim=60, head_num=(2, 4, 8, 16),
                                              depth_en=(2, 2, 2, 2)), device="meta")
    big = [b for s in list(model.layers) + list(model.layers_up[1:]) for b in s.blocks
           if b.window_size == 16]
    assert len(big) == 8 and all(b.trains_on_block_kernels() and not b.trains_on_residuals()
                                 for b in big)


def test_swin_block_trainable_n256_routes_through_the_wrappers():
    """SwinBlockTrainable at 256 tokens: the sequence form's launches
    forward, the big-window backward's launches backward, the grads the
    plain version's."""
    x, dout, p, mask, kw = _block_inputs(32, 8, 170)
    args = _port_args(x, dout, p, mask)
    leaves = [t.clone().requires_grad_(True) for t in
              [args[0], *args[2], *args[3:7], *args[7], *args[8:13]]]
    _build.reset_counts()
    out = twa.SwinBlockTrainable.apply(*leaves, args[14], args[13], kw["ws"], kw["num_heads"],
                                       kw["scale"], kw["shift"])
    out.backward(args[1])
    assert _build.counter("fused_swin_block").cpu == twa.SWIN_BLOCK_SEQ_LAUNCHES
    assert _build.counter("swin_block_bwd").cpu == twa.SWIN_BLOCK_BWD_BIG_LAUNCHES == 12
    want = twa.swin_block_bwd_reference(*args, **kw)
    for name, leaf, w in zip(NAMES, leaves, want):
        assert_close(leaf.grad, w.numpy(), name)


def _up4_inputs(C, seed, H=6, W=8):
    rng = np.random.default_rng(seed)
    n = lambda *s, sd=1.0: (rng.standard_normal(s) * sd).astype(np.float32)
    args = (n(1, H, W, C), n(C, 16 * C, sd=C ** -0.5), np.full((1,), 0.25, np.float32),
            n(C, C, sd=C ** -0.5), n(C, sd=0.1), np.full((1,), 0.1, np.float32),
            n(C, C, sd=C ** -0.5), n(C, C, sd=C ** -0.5), n(3, 3, C, 1, sd=(9 * C) ** -0.5))
    return args, n(1, H, W, 16)


@pytest.mark.parametrize("C", [60, 180])
def test_up4_conv_bwd_plain_matches_jax_at_padded_widths(C):
    """#9 at C=60 (the shrunk head) and C=180 (the full size's head, which
    the kernel runs over 192): the plain version against JAX
    ``_up4c_bwd_impl``; through the autograd Function, the wrapper's count
    is the plan's form's (the wide form's six launches at C=180)."""
    args, dout = _up4_inputs(C, 180 + C)
    want = jup._up4c_bwd_impl(*[jnp.asarray(a) for a in args], jnp.asarray(dout))
    got = tup.up4_conv_bwd_reference(*[torch.from_numpy(a) for a in args],
                                     torch.from_numpy(dout))
    for name, g, w in zip(UP4_NAMES, got, want):
        assert_close(g, w, name)
    leaves = [torch.from_numpy(a).clone().requires_grad_(True) for a in args]
    _build.reset_counts()
    tup.DualUpsample4ConvTrainable.apply(*leaves).backward(torch.from_numpy(dout))
    assert _build.counter("up4_conv_bwd").cpu == tup.up4_conv_bwd_launches(C) == (
        tup.UP4_CONV_BWD_WIDE_LAUNCHES if C == 180 else tup.UP4_CONV_BWD_LAUNCHES)
    for name, leaf, w in zip(UP4_NAMES[1:], leaves[1:], want[1:]):
        assert_close(leaf.grad, w, name)


def test_scaled_training_routes_and_launches():
    """The full-size scaled model (meta tensors): one training step at
    batch 4 launches #1's sequence form and #8's big-window form for the 48
    blocks at C=180, 360 and 720, nothing for the 8 C=1440 blocks (eager
    autograd, as JAX above its train cap 768), and #5 + #9's wide form for
    the head."""
    model = build_model(tconfig.scaled_config(), device="meta")
    blocks = [b for s in list(model.layers) + list(model.layers_up[1:]) for b in s.blocks]
    on_block = [b for b in blocks if b.trains_on_block_kernels()]
    assert len(on_block) == 48 and {b.dim for b in on_block} == {180, 360, 720}
    eager = [b for b in blocks if not b.trains_on_block_kernels()]
    assert len(eager) == 8 and all(b.dim == 1440 and not b.trains_on_split_kernels()
                                   for b in eager)
    assert not any(b.trains_on_residuals() for b in on_block)
    got = model.expected_launches((4, 512, 512, 3), train=True)
    assert got["fused_swin_block"] == 48 * twa.SWIN_BLOCK_SEQ_LAUNCHES
    assert got["swin_block_bwd"] == 48 * twa.SWIN_BLOCK_BWD_BIG_LAUNCHES
    assert got["fused_dual_upsample4_conv_phase"] == 1
    assert got["up4_conv_bwd"] == tup.UP4_CONV_BWD_WIDE_LAUNCHES
    assert all(v == 0 for k, v in got.items()
               if k not in ("fused_swin_block", "swin_block_bwd",
                            "fused_dual_upsample4_conv_phase", "up4_conv_bwd"))


# (H, C, heads, the big-window backward's width)
TRAIN_BLOCKS = [(128, 180, 6, 192), (64, 360, 12, 368), (32, 720, 24, 720)]


def test_every_scaled_train_plan_exists_and_fits():
    """Every plan of the scaled training step fits the H100's shared
    memory: the sequence form's (C=720 too, the train form's width), the
    big-window backward's at C rounded up to 16, and #9's wide form at
    C=180 (padded to 192; before this form it refused C=180)."""
    for H, C, heads, Cp in TRAIN_BLOCKS:
        seq = twa.block_seq_plan(H, H, C, 4 * C, 16, heads)
        assert max(v for k, v in seq.items() if k.startswith("smem")) <= twa.SMEM_MAX
        p = twa.block_bwd_plan(H, H, C, 4 * C, 16, heads)
        assert p["Cp"] == Cp == twa.block_bwd_width(C, 16) and p["nq"] == 4
        assert max(p["smem"].values()) <= twa.SMEM_MAX
        assert p["G"] == -(-Cp // 128) <= 6
        assert p["smem"]["attn_dq"] == max(twa._big_attn_smem(256, 30))
    p = tup.up4_conv_bwd_plan(128, 128, 180, 1)
    assert p["Cp"] == 192 and p["wide"] and max(p["smem"].values()) <= twa.SMEM_MAX
    assert not tup.up4_conv_bwd_plan(64, 64, 96, 1)["wide"]


def test_big_backward_workspace_stays_bounded_at_batch_4():
    """The rel-pos bias partials of the big-window backward are one (heads,
    N, N) map per chunk of windows, the chunks sized at PLAN_BATCH images:
    at batch 4 they stay near ~BWD_ATTN_FILL_CTAS CTAs' worth."""
    for H, C, heads, _ in TRAIN_BLOCKS:
        p = twa.block_bwd_plan(H, H, C, 4 * C, 16, heads)
        chunks = -(-4 * (H // 16) ** 2 // p["windows_per_chunk"])
        assert chunks * heads * 4 <= twa.BWD_ATTN_FILL_CTAS
        assert chunks * heads * 256 * 256 * 4 <= 40e6


@pytest.mark.parametrize("C,hidden,heads,ws,match", [
    (1440, 5760, 48, 16, "above 768"),
    (264, 1056, 4, 16, "head dim 66 above 64"),
    (182, 728, 2, 16, "multiple of 4"),
    (180, 720, 6, 12, "above 64 the kernel takes multiples of 64"),
    (124, 496, 4, 16, "head dim 31 is odd"),
])
def test_big_backward_refuses_shapes_outside_the_design(C, hidden, heads, ws, match):
    why = twa.block_bwd_why(C, hidden, heads, ws)
    assert why is not None and match in why
    assert not twa.block_bwd_takes(C, hidden, heads, ws)
    with pytest.raises(ValueError, match=match):
        twa.block_bwd_plan(ws * 8, ws * 8, C, hidden, ws, heads)


def test_block_operands_padding_round_trips():
    """The big-window backward's operands at C=60 over 64 channels: the
    real values where they were (qkv's q, k and v blocks each at their
    block's start), zeros past them; and the grads cut back exactly."""
    g = torch.Generator().manual_seed(5)
    r = lambda *s: torch.randn(*s, generator=g)
    C, Cp, hid = 60, 64, 240
    x, wqkv, bqkv, w2 = r(1, 16, 16, C), r(C, 3 * C), r(3 * C), r(hid, C)
    ops = twa.pad_block_operands(C, Cp, x, x, (r(C), r(C)), wqkv, bqkv, r(C, C), r(C),
                                 (r(C), r(C)), r(C, hid), r(hid), w2, r(C))
    xp, wq, bq, w2p = ops[0], ops[3], ops[4], ops[10]
    assert xp.shape == (1, 16, 16, Cp) and torch.equal(xp[..., :C], x) and not xp[..., C:].any()
    assert wq.shape == (Cp, 3 * Cp) and not wq[C:].any()
    for i in range(3):
        assert torch.equal(wq[:C, i * Cp:i * Cp + C], wqkv[:, i * C:(i + 1) * C])
        assert not wq[:, i * Cp + C:(i + 1) * Cp].any()
        assert torch.equal(bq[i * Cp:i * Cp + C], bqkv[i * C:(i + 1) * C])
    assert w2p.shape == (hid, Cp) and torch.equal(w2p[:, :C], w2)
    grads = (xp, *[r(*t.shape) for t in (ops[2][0], ops[2][1], wq, bq)],
             r(Cp, Cp), r(Cp), r(Cp), r(Cp), r(Cp, hid), r(hid), r(hid, Cp), r(Cp),
             r(2, 256, 256))
    back = twa.unpad_block_grads(C, grads)
    want = [(1, 16, 16, C), (C,), (C,), (C, 3 * C), (3 * C,), (C, C), (C,), (C,), (C,),
            (C, hid), (hid,), (hid, C), (C,), (2, 256, 256)]
    assert [tuple(t.shape) for t in back] == want
    assert torch.equal(back[0], x)
    assert torch.equal(back[3][:, C:2 * C], grads[3][:C, Cp:Cp + C])
    assert twa.unpad_block_grads(Cp, grads) is grads


def _stub_library(monkeypatch, module) -> dict:
    """Stub the kernel library (each C entry's call recorded, tensors as
    they are handed over) and the wrappers' CUDA device check."""
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
    monkeypatch.setattr(module, "_check_x", lambda *a: None)
    return calls


def test_big_backward_hands_its_entry_the_padded_width(monkeypatch):
    """swin_block_bwd at 256 tokens (meta tensors, library stubbed): the
    big entry gets the rows' width 192 and the real 180, x, dout and the
    weights padded to 192 (q, k, v blocks of 192), and the grads come back
    at 180."""
    calls = _stub_library(monkeypatch, twa)
    B, H, C, heads, hid = 2, 32, 180, 6, 720
    m = lambda *s: torch.zeros(*s, dtype=torch.bfloat16, device="meta")
    f = lambda *s: torch.zeros(*s, device="meta")
    g = twa.swin_block_bwd(m(B, H, H, C), m(B, H, H, C), (f(C), f(C)), m(C, 3 * C), f(3 * C),
                           m(C, C), f(C), (f(C), f(C)), m(C, hid), f(hid), m(hid, C), f(C),
                           f(heads, 256, 256), f(4, 256, 256), f(B, 2), ws=16,
                           num_heads=heads, scale=SCALE, shift=8)
    args = calls["sunet_swin_block_bwd_big"]
    assert args[32:41] == (B, H, H, 192, 180, hid, 16, heads, 8)
    assert tuple(args[0].shape) == (B, H, H, 192) and tuple(args[4].shape) == (192, 576)
    assert tuple(args[12].shape) == (hid, 192) and tuple(args[10].shape) == (192, hid)
    assert calls["sunet_swin_block_bwd_big_workspace"] == (B, H, H, 192, 180, hid, 16, heads)
    assert [tuple(t.shape) for t in g] == [
        (B, H, H, C), (C,), (C,), (C, 3 * C), (3 * C,), (C, C), (C,), (C,), (C,), (C, hid),
        (hid,), (hid, C), (C,), (heads, 256, 256)]


def test_train_form_hands_its_entry_the_drop_path_scales(monkeypatch):
    """The sequence form with drop-path scales at C=720 (above the
    inference cap 384, within the train cap 768): its entry gets the (B, 2)
    scales; without them C=720 is refused, as JAX's inference cap."""
    calls = _stub_library(monkeypatch, twa)
    B, H, C, heads = 2, 32, 720, 24
    m = lambda *s: torch.zeros(*s, dtype=torch.bfloat16, device="meta")
    f = lambda *s: torch.zeros(*s, device="meta")
    args = (m(B, H, H, C), (f(C), f(C)), m(C, 3 * C), f(3 * C), m(C, C), f(C), (f(C), f(C)),
            m(C, 4 * C), f(4 * C), m(4 * C, C), f(C), f(heads, 256, 256), f(4, 256, 256))
    kw = dict(ws=16, num_heads=heads, scale=SCALE, shift=8)
    dp = f(B, 2)
    twa._launch_block_seq(*args, dp, **kw)
    got = calls["sunet_swin_block_seq"]
    assert tuple(got[16].shape) == (B, 2) and got[18:21] == (B, H, H)
    with pytest.raises(ValueError, match="above the block-kernel cap 384"):
        twa._launch_block_seq(*args, **kw)


def test_up4_conv_bwd_hands_the_wide_form_its_padded_width(monkeypatch):
    """#9 at C=180 (meta tensors, library stubbed): its entry gets 192, x
    and the weights zero-padded to it (w_exp (192, 16 * 192) in its column
    order), and the grads come back at 180."""
    calls = _stub_library(monkeypatch, tup)
    B, H, W, C = 2, 16, 16, 180
    m = lambda *s: torch.zeros(*s, dtype=torch.bfloat16, device="meta")
    f = lambda *s: torch.zeros(*s, device="meta")
    g = tup.up4_conv_bwd(m(B, H, W, C), m(C, 16 * C), f(1), m(C, C), f(C), f(1), m(C, C),
                         m(C, C), m(3, 3, C, 1), m(B, H, W, 16))
    args = calls["sunet_up4_conv_bwd"]
    plan = tup.up4_conv_bwd_plan(H, W, C, 1)
    assert args[18:24] == (B, H, W, 192, 1, plan["tiles_per_chunk"])
    assert tuple(args[0].shape) == (B, H, W, 192) and tuple(args[2].shape) == (192, 16 * 192)
    assert tuple(args[7].shape) == (3, 3, 192, 1)
    assert [tuple(t.shape) for t in g] == [(B, H, W, C), (C, 16 * C), (1,), (C, C), (C,),
                                           (1,), (C, C), (C, C), (3, 3, C, 1)]


def test_up4_padding_leaves_the_real_channels():
    """#9's padded operands: w_exp's real (c, n, s) entries where they were
    in its column order c * 16 + s, every pad entry zero."""
    args, _ = _up4_inputs(60, 7)
    t = [torch.from_numpy(a) for a in args]
    x, w_exp, w_b1, b_b1, wpf, wbf, wconv = tup.up4_bwd_pad_operands(
        64, t[0], t[1], t[3], t[4], t[6], t[7], t[8])
    assert torch.equal(w_exp.reshape(64, 64, 16)[:60, :60], t[1].reshape(60, 60, 16))
    assert float(w_exp.reshape(64, 64, 16)[60:].abs().sum()) == 0.0
    assert float(w_exp.reshape(64, 64, 16)[:, 60:].abs().sum()) == 0.0
    assert tuple(x.shape) == (1, 6, 8, 64) and not x[..., 60:].any()
    assert tuple(wconv.shape) == (3, 3, 64, 1) and not wconv[:, :, 60:].any()
    assert not w_b1[60:].any() and not wpf[:, 60:].any() and not b_b1[60:].any()
