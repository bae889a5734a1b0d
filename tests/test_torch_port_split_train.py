"""The port's training-sublayer kernels' plain versions against the JAX
kernels and against autograd.

- ``ln_window_attention_bwd_reference`` (what a CPU tensor runs, and what
  ``chip_smoke.py`` holds the CUDA LN+W-MSA backward against) vs the JAX
  ``_ln_wmsa_bwd_impl`` in interpret mode with the per-head attention
  backward (``SUNET_ATTN_LAYOUT_BWD=perhead``), at shift 0 and with the
  shift-2 mask, and at a head dim of 96 (C=96, one head, window 8: the
  kernel takes head dims above 64 and is held to this plain version on the
  card); and vs torch.autograd of the plain forward
  ``fused_ln_window_attention_reference``.
- ``ln_mlp_branch_reference`` vs the JAX ``_ln_mlp_branch``;
  ``ln_mlp_bwd_reference`` vs the JAX ``_ln_mlp_bwd`` and vs autograd of
  ``ln_mlp_branch_reference``.
- The autograd Functions ``LnWindowAttentionTrainable`` and
  ``LnMlpTrainable`` route through the counted wrappers.

float32, inputs from numpy seeds given to both sides. Every output: max
|diff| <= 1e-4 * max(1, max|ref|), the rule of ``test_torch_port_train.py``:
float32 with other summation orders over at most a few thousand terms, and
the JAX kernels' Abramowitz-Stegun erf (1.5e-7 from the exact erf the port
uses).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunet_tf_tpu.kernels import window_attention as jwa
from sunet_tf_tpu.ops.window import shift_attn_mask
from sunet_tf_tpu_torch.kernels import _build
from sunet_tf_tpu_torch.kernels import window_attention as twa

REL = 1e-4
WMSA_NAMES = ("dx", "dln_g", "dln_b", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias")
MLP_NAMES = ("dy", "dln_g", "dln_b", "dw1", "db1", "dw2", "db2")


def assert_close(got, want, what=""):
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= REL * max(1.0, np.abs(want).max()), (what, err, np.abs(want).max())


def _normal(rng):
    return lambda *s, sd=1.0: (rng.standard_normal(s) * sd).astype(np.float32)


def _wmsa_inputs(shift, seed, C=32, heads=2, ws=4):
    """x, dout (B, H, W, C), [g, b, wqkv, bqkv, wproj, bproj, bias], mask."""
    n = _normal(np.random.default_rng(seed))
    B, H, W = 2, 8, 16
    p = [1 + n(C, sd=0.1), n(C, sd=0.1), n(C, 3 * C, sd=C ** -0.5), n(3 * C, sd=0.1),
         n(C, C, sd=C ** -0.5), n(C, sd=0.1), n(heads, ws * ws, ws * ws)]
    mask = shift_attn_mask(H, W, ws, shift) if shift else None
    return n(B, H, W, C), n(B, H, W, C), p, mask, dict(ws=ws, num_heads=heads, scale=8.0)


def _mlp_inputs(seed):
    """y, dout (B, H, W, C), [g, b, w1, b1, w2, b2]."""
    n = _normal(np.random.default_rng(seed))
    B, H, W, C = 2, 4, 8, 32
    p = [1 + n(C, sd=0.1), n(C, sd=0.1), n(C, 4 * C, sd=C ** -0.5), n(4 * C, sd=0.1),
         n(4 * C, C, sd=(4 * C) ** -0.5), n(C, sd=0.1)]
    return n(B, H, W, C), n(B, H, W, C), p


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("shift,shape", [pytest.param(0, {}, id="0"),
                                         pytest.param(2, {}, id="2"),
                                         pytest.param(0, dict(C=96, heads=1, ws=8),
                                                      id="head_dim_96")])
def test_ln_wmsa_bwd_plain_matches_jax(shift, shape, monkeypatch):
    monkeypatch.setenv("SUNET_ATTN_LAYOUT_BWD", "perhead")
    x, dout, p, mask, kw = _wmsa_inputs(shift, 110 + shift + len(shape), **shape)
    want = jwa._ln_wmsa_bwd_impl(jnp.asarray(x), *[jnp.asarray(a) for a in p],
                                 None if mask is None else jnp.asarray(mask),
                                 jnp.asarray(dout), kw["ws"], kw["num_heads"], kw["scale"])
    t = [_t(a) for a in p]
    got = twa.ln_window_attention_bwd_reference(_t(x), _t(dout), *t[:5], t[6], _t(mask), **kw)
    for name, g, w in zip(WMSA_NAMES, got, want):
        assert_close(g, w, name)


@pytest.mark.parametrize("shift", [0, 2])
def test_ln_wmsa_bwd_plain_matches_autograd(shift):
    x, dout, p, mask, kw = _wmsa_inputs(shift, 120 + shift)
    leaves = [_t(a).clone().requires_grad_(True) for a in [x, *p]]
    out = twa.fused_ln_window_attention_reference(*leaves, _t(mask), **kw)
    want = torch.autograd.grad(out, leaves, _t(dout))
    t = [_t(a) for a in p]
    got = twa.ln_window_attention_bwd_reference(_t(x), _t(dout), *t[:5], t[6], _t(mask), **kw)
    for name, g, w in zip(WMSA_NAMES, got, want):
        assert_close(g, w.numpy(), name)


def test_ln_mlp_branch_plain_matches_jax():
    y, _, p = _mlp_inputs(130)
    want = jwa._ln_mlp_branch(*[jnp.asarray(a) for a in [y, *p]])
    t = [_t(a) for a in p]
    assert_close(twa.ln_mlp_branch_reference(_t(y), t[0:2], *t[2:6]), want, "branch")


def test_ln_mlp_bwd_plain_matches_jax_and_autograd():
    y, dout, p = _mlp_inputs(140)
    want = jwa._ln_mlp_bwd(tuple(jnp.asarray(a) for a in [y, *p]), jnp.asarray(dout))
    t = [_t(a) for a in p]
    got = twa.ln_mlp_bwd_reference(_t(y), _t(dout), t[0:2], *t[2:5])
    for name, g, w in zip(MLP_NAMES, got, want):
        assert_close(g, w, name)
    leaves = [_t(a).clone().requires_grad_(True) for a in [y, *p]]
    out = twa.ln_mlp_branch_reference(leaves[0], leaves[1:3], *leaves[3:7])
    auto = torch.autograd.grad(out, leaves, _t(dout))
    for name, g, w in zip(MLP_NAMES, got, auto):
        assert_close(g, w.numpy(), name)


def test_sublayer_trainables_route_through_the_wrappers():
    x, dout, p, mask, kw = _wmsa_inputs(2, 150)
    leaves = [_t(a).clone().requires_grad_(True) for a in [x, *p]]
    _build.reset_counts()
    out = twa.LnWindowAttentionTrainable.apply(*leaves, _t(mask), kw["ws"], kw["num_heads"],
                                               kw["scale"])
    out.backward(_t(dout))
    assert _build.counter("fused_ln_window_attention").cpu == twa.LN_WMSA_LAUNCHES
    assert _build.counter("ln_window_attention_bwd").cpu == twa.LN_WMSA_BWD_LAUNCHES
    t = [_t(a) for a in p]
    want = twa.ln_window_attention_bwd_reference(_t(x), _t(dout), *t[:5], t[6], _t(mask), **kw)
    for name, leaf, w in zip(WMSA_NAMES, leaves, want):
        assert_close(leaf.grad, w.numpy(), name)

    y, dout, p = _mlp_inputs(160)
    leaves = [_t(a).clone().requires_grad_(True) for a in [y, *p]]
    out = twa.LnMlpTrainable.apply(*leaves)
    out.backward(_t(dout))
    assert _build.counter("ln_mlp_branch").cpu == twa.LN_MLP_BRANCH_LAUNCHES
    assert _build.counter("ln_mlp_bwd").cpu == twa.LN_MLP_BWD_LAUNCHES
    t = [_t(a) for a in p]
    want = twa.ln_mlp_bwd_reference(_t(y), _t(dout), t[0:2], *t[2:5])
    for name, leaf, w in zip(MLP_NAMES, leaves, want):
        assert_close(leaf.grad, w.numpy(), name)


def test_sublayer_wrappers_raise_off_cpu_and_cuda():
    x = torch.empty(2, 8, 8, 32, device="meta")
    w = torch.empty(32, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        twa.ln_window_attention_bwd(x, x, w[0], w[0], w.repeat(1, 3), None, w,
                                    torch.empty(2, 16, 16, device="meta"), None, ws=4,
                                    num_heads=2, scale=8.0)
    with pytest.raises(ValueError, match="CUDA"):
        twa.ln_mlp_branch(x, (w[0], w[0]), w.repeat(1, 4), w.repeat(1, 4)[0], w.repeat(4, 1),
                          w[0])
    with pytest.raises(ValueError, match="CUDA"):
        twa.ln_mlp_bwd(x, x, (w[0], w[0]), w.repeat(1, 4), w.repeat(1, 4)[0], w.repeat(4, 1))
