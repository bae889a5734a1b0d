"""The port's plain kernel versions against the JAX kernels they replace.

Each plain PyTorch version in ``sunet_tf_tpu_torch/kernels`` (what a CPU
tensor runs, and what ``chip_smoke.py`` holds the CUDA kernels against on
the card) is compared with the JAX Pallas kernel function itself, run in
interpret mode on the CPU as the JAX package's own tests run it. float32,
same numpy inputs on both sides, rtol = atol = 1e-4 (the JAX kernels' GELU
uses the Abramowitz-Stegun erf, 1.5e-7 from the exact erf the port uses).
"""

import jax
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

TOL = dict(rtol=1e-4, atol=1e-4)


def _block_arrays(rng, C, heads, N, hidden=None):
    """ln1 g/b, wqkv, bqkv, wproj, bproj, ln2 g/b, w1, b1, w2, b2, bias."""
    hidden = hidden or 4 * C
    n = lambda *s, sd=1.0: (rng.standard_normal(s) * sd).astype(np.float32)
    return [1 + n(C, sd=0.1), n(C, sd=0.1), n(C, 3 * C, sd=C ** -0.5),
            n(3 * C, sd=0.1), n(C, C, sd=C ** -0.5), n(C, sd=0.1),
            1 + n(C, sd=0.1), n(C, sd=0.1), n(C, hidden, sd=C ** -0.5),
            n(hidden, sd=0.1), n(hidden, C, sd=hidden ** -0.5), n(C, sd=0.1),
            n(heads, N, N)]


def _split(p):
    """12+1 arrays -> the fused_swin_block positional arguments."""
    return ((p[0], p[1]), p[2], p[3], p[4], p[5], (p[6], p[7]), p[8], p[9],
            p[10], p[11], p[12])


def _tree(f, p):
    return tuple(tuple(f(b) for b in a) if isinstance(a, tuple) else f(a)
                 for a in p)


J = lambda p: _tree(jnp.asarray, p)
T = lambda p: _tree(torch.from_numpy, p)


@pytest.mark.parametrize("shift", [0, 2])
def test_swin_block_plain_matches_jax(shift):
    rng = np.random.default_rng(10 + shift)
    B, H, W, C, heads, ws = 2, 8, 16, 32, 2, 4
    p = _block_arrays(rng, C, heads, ws * ws)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    mask = shift_attn_mask(H, W, ws, shift) if shift else None
    kw = dict(ws=ws, num_heads=heads, scale=8.0, shift=shift)
    ref = jwa.fused_swin_block(jnp.asarray(x), *J(_split(p)),
                               None if mask is None else jnp.asarray(mask), **kw)
    c = _build.counter("fused_swin_block")
    before = c.cpu
    got = twa.fused_swin_block(torch.from_numpy(x), *T(_split(p)),
                               None if mask is None else torch.from_numpy(mask), **kw)
    assert c.cpu == before + 1 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_swin_block_chain_plain_matches_jax_and_two_blocks():
    rng = np.random.default_rng(20)
    B, H, W, C, heads, ws, ss = 2, 8, 8, 32, 2, 4, 2
    ps = [_block_arrays(rng, C, heads, ws * ws) for _ in range(2)]
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    mask = shift_attn_mask(H, W, ws, ss)
    kw = dict(ws=ws, num_heads=heads, scale=8.0, shifts=(0, ss))
    ref = jwa.fused_swin_block_chain(
        jnp.asarray(x), [tuple(jnp.asarray(a) for a in p[:12]) for p in ps],
        [jnp.asarray(p[12]) for p in ps], jnp.asarray(mask), **kw)
    tp = [[torch.from_numpy(a) for a in p] for p in ps]
    got = twa.fused_swin_block_chain(torch.from_numpy(x), [p[:12] for p in tp],
                                     [p[12] for p in tp], torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    bkw = dict(ws=ws, num_heads=heads, scale=8.0)
    y = twa.fused_swin_block_reference(torch.from_numpy(x), *_split(tp[0]), None,
                                       shift=0, **bkw)
    y = twa.fused_swin_block_reference(y, *_split(tp[1]), torch.from_numpy(mask),
                                       shift=ss, **bkw)
    assert torch.equal(got, y)


def test_ln_window_attention_plain_matches_jax():
    rng = np.random.default_rng(30)
    B, H, W, C, heads, ws = 2, 8, 8, 32, 2, 4
    p = _block_arrays(rng, C, heads, ws * ws)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    kw = dict(ws=ws, num_heads=heads, scale=8.0)
    args = (p[0], p[1], p[2], p[3], p[4], p[5], p[12])
    ref = jwa.fused_ln_window_attention(jnp.asarray(x), *J(args), None, **kw)
    got = twa.fused_ln_window_attention(torch.from_numpy(x), *T(args), None, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_ln_mlp_plain_matches_jax():
    rng = np.random.default_rng(40)
    C = 32
    p = _block_arrays(rng, C, 2, 16)
    y = rng.standard_normal((2, 8, 8, C)).astype(np.float32)
    args = ((p[6], p[7]), p[8], p[9], p[10], p[11])
    ref = jwa.fused_ln_mlp(jnp.asarray(y), *J(args))
    c = _build.counter("fused_ln_mlp")
    before = c.cpu
    got = twa.fused_ln_mlp(torch.from_numpy(y), *T(args))
    # stands in for the kernel's three launches: LN, fc1, fc2
    assert twa.LN_MLP_LAUNCHES == 3 and c.cpu == before + twa.LN_MLP_LAUNCHES
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("out_ch", [1, 3])
def test_up4_conv_phase_plain_matches_jax(out_ch):
    rng = np.random.default_rng(50 + out_ch)
    B, H, W, C = 2, 8, 8, 16
    n = lambda *s, sd=1.0: (rng.standard_normal(s) * sd).astype(np.float32)
    args = (n(B, H, W, C), n(C, 16 * C, sd=C ** -0.5), np.full((1,), 0.25, np.float32),
            n(C, C, sd=C ** -0.5), n(C, sd=0.1), np.full((1,), 0.1, np.float32),
            n(C, C, sd=C ** -0.5), n(C, C, sd=C ** -0.5),
            n(3, 3, C, out_ch, sd=(9 * C) ** -0.5))
    ref = jup.fused_dual_upsample4_conv_phase(*J(args))
    got = tup.fused_dual_upsample4_conv_phase(*T(args))
    assert tuple(got.shape) == (B, H, W, 16 * out_ch)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(tup.phase_to_pixel(got).numpy(),
                               np.asarray(jup.phase_to_pixel(ref)), **TOL)


def test_wrappers_raise_off_cpu_and_cuda():
    """A tensor that is neither on the CPU nor on a CUDA device is refused:
    no wrapper falls back to its plain version."""
    x = torch.empty(1, 8, 8, 32, device="meta")
    w = torch.empty(32, 128, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        twa.fused_ln_mlp(x, (w[:, 0], w[:, 0]), w, w[0], w.t(), w[:, 0])
