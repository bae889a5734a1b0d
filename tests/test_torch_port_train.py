"""The port's training kernels' plain versions against the JAX backward
kernels and against autograd.

- ``swin_block_bwd_reference`` (what a CPU tensor runs, and what
  ``chip_smoke.py`` holds the CUDA backward against) vs the JAX
  ``_block_bwd_impl`` in interpret mode with the per-head attention
  backward (``SUNET_ATTN_LAYOUT_BWD=perhead``), and vs torch.autograd of
  the plain forward ``fused_swin_block_reference``, at shift 0 and 2 with
  drop-path scales that are not one.
- ``up4_conv_bwd_reference`` vs the JAX ``_up4c_bwd_impl`` and vs autograd
  of ``fused_dual_upsample4_conv_phase_reference``, out 1 and 3; the
  phase-space conv fold and its adjoint vs JAX's.
- The autograd Functions route through the wrappers (counted launches).

float32, inputs from numpy seeds given to both sides. Every output: max
|diff| <= 1e-4 * max(1, max|ref|): float32 with other summation orders over
at most a few thousand terms, and the JAX kernels' Abramowitz-Stegun erf
(1.5e-7 from the exact erf the port uses).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunet_tf_tpu.kernels import upsample as jup
from sunet_tf_tpu.kernels import window_attention as jwa
from sunet_tf_tpu.ops.window import shift_attn_mask
from sunet_tf_tpu_torch.kernels import _build
from sunet_tf_tpu_torch.kernels import upsample as tup
from sunet_tf_tpu_torch.kernels import window_attention as twa

REL = 1e-4
DP = np.array([[1 / 0.9, 0.0], [1 / 0.9, 1 / 0.9]], np.float32)


def assert_close(got, want, what=""):
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= REL * max(1.0, np.abs(want).max()), (what, err, np.abs(want).max())


def _block_inputs(shift, seed):
    rng = np.random.default_rng(seed)
    B, H, W, C, heads, ws = 2, 8, 16, 32, 2, 4
    n = lambda *s, sd=1.0: (rng.standard_normal(s) * sd).astype(np.float32)
    p = [1 + n(C, sd=0.1), n(C, sd=0.1), n(C, 3 * C, sd=C ** -0.5), n(3 * C, sd=0.1),
         n(C, C, sd=C ** -0.5), n(C, sd=0.1), 1 + n(C, sd=0.1), n(C, sd=0.1),
         n(C, 4 * C, sd=C ** -0.5), n(4 * C, sd=0.1), n(4 * C, C, sd=(4 * C) ** -0.5),
         n(C, sd=0.1), n(heads, ws * ws, ws * ws)]
    x, dout = n(B, H, W, C), n(B, H, W, C)
    mask = shift_attn_mask(H, W, ws, shift) if shift else None
    return x, dout, p, mask, dict(ws=ws, num_heads=heads, scale=8.0, shift=shift)


def _port_block_args(x, dout, p, mask):
    t = [torch.from_numpy(a) for a in p]
    return (torch.from_numpy(x), torch.from_numpy(dout), t[0:2], t[2], t[3], t[4], t[5],
            t[6:8], t[8], t[9], t[10], t[11], t[12],
            None if mask is None else torch.from_numpy(mask), torch.from_numpy(DP))


NAMES = ("dx", "dln1_g", "dln1_b", "dwqkv", "dbqkv", "dwproj", "dbproj", "dln2_g",
         "dln2_b", "dw1", "db1", "dw2", "db2", "dbias")


@pytest.mark.parametrize("shift", [0, 2])
def test_block_bwd_plain_matches_jax(shift, monkeypatch):
    monkeypatch.setenv("SUNET_ATTN_LAYOUT_BWD", "perhead")
    x, dout, p, mask, kw = _block_inputs(shift, 60 + shift)
    want = jwa._block_bwd_impl(
        jnp.asarray(x), *[jnp.asarray(a) for a in p], jnp.asarray(DP),
        None if mask is None else jnp.asarray(mask), jnp.asarray(dout), kw["ws"],
        kw["num_heads"], kw["scale"], shift=shift)
    got = twa.swin_block_bwd_reference(*_port_block_args(x, dout, p, mask), **kw)
    for name, g, w in zip(NAMES, got, want):
        assert_close(g, w, name)


@pytest.mark.parametrize("shift", [0, 2])
def test_block_bwd_plain_matches_autograd(shift):
    x, dout, p, mask, kw = _block_inputs(shift, 70 + shift)
    args = _port_block_args(x, dout, p, mask)
    leaves = [args[0], *args[2], *args[3:7], *args[7], *args[8:13]]
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    xv, g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, w1, bm1, w2, bm2, bias = leaves
    out = twa.fused_swin_block_reference(xv, (g1, b1), wqkv, bqkv, wproj, bproj, (g2, b2),
                                         w1, bm1, w2, bm2, bias, args[13], args[14], **kw)
    want = torch.autograd.grad(out, leaves, args[1])
    got = twa.swin_block_bwd_reference(*args, **kw)
    for name, g, w in zip(NAMES, got, want):
        assert_close(g, w.numpy(), name)


def test_swin_block_trainable_routes_through_the_wrappers():
    x, dout, p, mask, kw = _block_inputs(2, 80)
    args = _port_block_args(x, dout, p, mask)
    ws, heads, scale, shift = kw["ws"], kw["num_heads"], kw["scale"], kw["shift"]
    leaves = [t.clone().requires_grad_(True) for t in
              [args[0], *args[2], *args[3:7], *args[7], *args[8:13]]]
    _build.reset_counts()
    out = twa.SwinBlockTrainable.apply(*leaves, args[14], args[13], ws, heads, scale, shift)
    out.backward(args[1])
    assert _build.counter("fused_swin_block").cpu == 1
    assert _build.counter("swin_block_bwd").cpu == twa.SWIN_BLOCK_BWD_LAUNCHES
    want = twa.swin_block_bwd_reference(*args, **kw)
    for name, leaf, w in zip(NAMES, leaves, want):
        assert_close(leaf.grad, w.numpy(), name)


def _up4_inputs(out_ch, seed):
    rng = np.random.default_rng(seed)
    B, H, W, C = 2, 8, 8, 16
    n = lambda *s, sd=1.0: (rng.standard_normal(s) * sd).astype(np.float32)
    args = (n(B, H, W, C), n(C, 16 * C, sd=C ** -0.5), np.full((1,), 0.25, np.float32),
            n(C, C, sd=C ** -0.5), n(C, sd=0.1), np.full((1,), 0.1, np.float32),
            n(C, C, sd=C ** -0.5), n(C, C, sd=C ** -0.5),
            n(3, 3, C, out_ch, sd=(9 * C) ** -0.5))
    return args, n(B, H, W, 16 * out_ch)


UP4_NAMES = ("dx", "dw_exp", "dalpha_p", "dw_b1", "db_b1", "dalpha_b", "dwpf", "dwbf",
             "dwconv")


@pytest.mark.parametrize("out_ch", [1, 3])
def test_up4_bwd_plain_matches_jax_and_autograd(out_ch):
    args, dout = _up4_inputs(out_ch, 90 + out_ch)
    want = jup._up4c_bwd_impl(*[jnp.asarray(a) for a in args], jnp.asarray(dout))
    targs = [torch.from_numpy(a) for a in args]
    got = tup.up4_conv_bwd_reference(*targs, torch.from_numpy(dout))
    for name, g, w in zip(UP4_NAMES, got, want):
        assert_close(g, w, name)
    leaves = [t.clone().requires_grad_(True) for t in targs]
    out = tup.fused_dual_upsample4_conv_phase_reference(*leaves)
    auto = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for name, g, w in zip(UP4_NAMES, got, auto):
        assert_close(g, w.numpy(), name)


def test_up4_trainable_and_conv_fold_match_jax():
    args, dout = _up4_inputs(1, 95)
    wconv = args[-1]
    np.testing.assert_array_equal(tup.fold_output_conv4(torch.from_numpy(wconv)).numpy(),
                                  np.asarray(jup.fold_output_conv4(jnp.asarray(wconv))))
    dwfold = np.random.default_rng(96).standard_normal((36, 16, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tup.unfold_output_conv4_grad(torch.from_numpy(dwfold), 16, 1).numpy(),
        np.asarray(jup.unfold_output_conv4_grad(jnp.asarray(dwfold), 16, 1)),
        rtol=1e-6, atol=1e-6)
    leaves = [torch.from_numpy(a).clone().requires_grad_(True) for a in args]
    _build.reset_counts()
    out = tup.DualUpsample4ConvTrainable.apply(*leaves)
    out.backward(torch.from_numpy(dout))
    assert _build.counter("fused_dual_upsample4_conv_phase").cpu == 1
    assert _build.counter("up4_conv_bwd").cpu == tup.UP4_CONV_BWD_LAUNCHES
    want = tup.up4_conv_bwd_reference(*[torch.from_numpy(a) for a in args],
                                      torch.from_numpy(dout))
    for name, leaf, w in zip(UP4_NAMES[1:], leaves[1:], want[1:]):
        assert_close(leaf.grad, w.numpy(), name)


def test_backward_wrappers_raise_off_cpu_and_cuda():
    x = torch.empty(2, 8, 8, 32, device="meta")
    w = torch.empty(32, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        twa.swin_block_bwd(x, x, (w[0], w[0]), w.repeat(1, 3), None, w, w[0], (w[0], w[0]),
                           w.repeat(1, 4), w.repeat(1, 4)[0], w.repeat(4, 1), w[0],
                           torch.empty(2, 16, 16, device="meta"), None, None, ws=4,
                           num_heads=2, scale=8.0)
