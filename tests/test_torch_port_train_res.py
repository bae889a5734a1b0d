"""The residual route's plain versions against the JAX package and autograd.

- ``fused_swin_block_res_reference`` (what a CPU tensor runs, and what
  ``chip_smoke.py`` holds the CUDA forward against) vs the JAX
  ``fused_swin_block_res`` in interpret mode: the block output and the three
  residuals, JAX's lane-concat layouts converted to the port's.
- ``swin_block_bwd_res_reference`` vs the JAX ``_block_bwd_impl_res`` given
  the same residuals, and vs torch.autograd of the plain forward's output.
- ``SwinBlockTrainableRes`` routes through the counted wrappers, which
  refuse a tensor on neither the CPU nor CUDA.
- The port's routing rule ``bwd_residuals_enabled`` agrees with JAX's at
  its defaults for every stage of ``Config()``, ``tiny_config()`` and the
  scaled EMB-180/WIN-16 configuration.

float32 at the sizes of ``test_torch_port_train.py`` (B 2, 8x16, C 32, 2
heads, window 4, drop-path scales that are not one), shift 0 and 2, JAX's
layouts at their defaults (blockdiag, as the route requires). Every output:
max |diff| <= 1e-4 * max(1, max|ref|), as in that file.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunet_tf_tpu import config as jconfig
from sunet_tf_tpu.kernels import window_attention as jwa
from sunet_tf_tpu_torch import config as tconfig
from sunet_tf_tpu_torch.kernels import _build
from sunet_tf_tpu_torch.kernels import window_attention as twa
from sunet_tf_tpu_torch.ops.window import effective_window
from test_torch_port_train import DP, NAMES, _block_inputs, _port_block_args, assert_close

JAX_ENV = ("SUNET_BWD_RESID", "SUNET_SOFTMAX", "SUNET_ATTN_LAYOUT", "SUNET_ATTN_LAYOUT_BWD")


@pytest.fixture
def jax_defaults(monkeypatch):
    for k in JAX_ENV:
        monkeypatch.delenv(k, raising=False)


def _jax_fwd_res(x, p, mask, kw):
    j = [jnp.asarray(a) for a in p]
    return jwa.fused_swin_block_res(
        jnp.asarray(x), (j[0], j[1]), j[2], j[3], j[4], j[5], (j[6], j[7]), j[8], j[9],
        j[10], j[11], j[12], None if mask is None else jnp.asarray(mask),
        drop_path_scale=jnp.asarray(DP), **kw)


def _port_fwd_args(args):
    """_port_block_args' tuple less dout, in fused_swin_block_res's order."""
    return (args[0], *args[2:])


def _port_res_from_jax(eb, rden, ctx, heads):
    """JAX's (B, nW, N, h*N) eb and per-channel (B, nW, N, C) rden and ctx ->
    the port's (B*nW, h, N, N), (B*nW, h, N) and (B*H*W, C)."""
    eb, rden, ctx = (np.asarray(a) for a in (eb, rden, ctx))
    B, nW, N, C = ctx.shape
    d = C // heads
    return (torch.from_numpy(eb.reshape(B * nW, N, heads, N).transpose(0, 2, 1, 3).copy()),
            torch.from_numpy(rden.reshape(B * nW, N, heads, d)[..., 0].transpose(0, 2, 1)
                             .copy()),
            torch.from_numpy(ctx.reshape(B * nW * N, C).copy()))


def _jax_layout(eb, rden, ctx, B, heads):
    """The port's residuals in JAX's layouts (the inverse of the above, rden
    broadcast over each head's channels)."""
    Bn, h, N, _ = eb.shape
    C = ctx.shape[-1]
    return (eb.permute(0, 2, 1, 3).reshape(B, Bn // B, N, h * N),
            rden.permute(0, 2, 1).repeat_interleave(C // heads, -1).reshape(B, Bn // B, N, C),
            ctx.reshape(B, Bn // B, N, C))


@pytest.mark.parametrize("shift", [0, 2])
def test_block_fwd_res_plain_matches_jax(shift, jax_defaults):
    x, dout, p, mask, kw = _block_inputs(shift, 100 + shift)
    want = _jax_fwd_res(x, p, mask, kw)
    got = twa.fused_swin_block_res_reference(*_port_fwd_args(_port_block_args(x, dout, p, mask)),
                                             **kw)
    assert_close(got[0], want[0], "out")
    for name, g, w in zip(("eb", "rden", "ctx"),
                          _jax_layout(*got[1:], x.shape[0], kw["num_heads"]), want[1:]):
        assert_close(g, w, name)


@pytest.mark.parametrize("shift", [0, 2])
def test_block_bwd_res_plain_matches_jax(shift, jax_defaults):
    x, dout, p, mask, kw = _block_inputs(shift, 110 + shift)
    _, *res = _jax_fwd_res(x, p, mask, kw)
    j = [jnp.asarray(a) for a in p]
    want = jwa._block_bwd_impl_res(
        jnp.asarray(x), *j[:12], *res, jnp.asarray(DP), jnp.asarray(dout), kw["ws"],
        kw["num_heads"], kw["scale"], shift=shift)
    args = _port_block_args(x, dout, p, mask)
    got = twa.swin_block_bwd_res_reference(
        args[0], args[1], *_port_res_from_jax(*res, kw["num_heads"]), *args[2:12], args[14],
        **kw)
    for name, g, w in zip(NAMES, got, want):
        assert_close(g, w, name)


def _leaves(args):
    return [t.clone().requires_grad_(True) for t in
            [args[0], *args[2], *args[3:7], *args[7], *args[8:13]]]


@pytest.mark.parametrize("shift", [0, 2])
def test_block_bwd_res_plain_matches_autograd(shift):
    x, dout, p, mask, kw = _block_inputs(shift, 120 + shift)
    args = _port_block_args(x, dout, p, mask)
    leaves = _leaves(args)
    xv, g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, w1, bm1, w2, bm2, bias = leaves
    out, *res = twa.fused_swin_block_res_reference(
        xv, (g1, b1), wqkv, bqkv, wproj, bproj, (g2, b2), w1, bm1, w2, bm2, bias, args[13],
        args[14], **kw)
    want = torch.autograd.grad(out, leaves, args[1])
    got = twa.swin_block_bwd_res_reference(args[0], args[1], *[r.detach() for r in res],
                                           *args[2:12], args[14], **kw)
    for name, g, w in zip(NAMES, got, want):
        assert_close(g, w.numpy(), name)


def test_swin_block_trainable_res_routes_through_the_wrappers():
    x, dout, p, mask, kw = _block_inputs(2, 130)
    args = _port_block_args(x, dout, p, mask)
    leaves = _leaves(args)
    _build.reset_counts()
    out = twa.SwinBlockTrainableRes.apply(*leaves, args[14], args[13], kw["ws"],
                                          kw["num_heads"], kw["scale"], kw["shift"])
    out.backward(args[1])
    assert _build.counter("fused_swin_block_res").cpu == 1
    assert _build.counter("swin_block_bwd_res").cpu == twa.SWIN_BLOCK_BWD_RES_LAUNCHES
    assert _build.counter("fused_swin_block").cpu == 0
    assert _build.counter("swin_block_bwd").cpu == 0
    ref_out, *res = twa.fused_swin_block_res_reference(*_port_fwd_args(args), **kw)
    assert_close(out, ref_out.numpy(), "out")
    want = twa.swin_block_bwd_res_reference(args[0], args[1], *res, *args[2:12], args[14],
                                            **kw)
    for name, leaf, w in zip(NAMES, leaves, want):
        assert_close(leaf.grad, w.numpy(), name)


def test_residual_wrappers_raise_off_cpu_and_cuda():
    x = torch.empty(2, 8, 8, 32, device="meta")
    w = torch.empty(32, 32, device="meta")
    v = w[0]
    bias = torch.empty(2, 16, 16, device="meta")
    block = ((v, v), w.repeat(1, 3), None, w, v, (v, v), w.repeat(1, 4), w.repeat(1, 4)[0],
             w.repeat(4, 1), v)
    with pytest.raises(ValueError, match="CUDA"):
        twa.fused_swin_block_res(x, *block, bias, None, ws=4, num_heads=2, scale=8.0)
    res = (torch.empty(8, 2, 16, 16, device="meta"), torch.empty(8, 2, 16, device="meta"),
           torch.empty(128, 32, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        twa.swin_block_bwd_res(x, x, *res, *block, None, ws=4, num_heads=2, scale=8.0)


def _stage_geometry(sw) -> list:
    """(C, heads, N) of every stage of a SwinUNet config's encoder (the
    decoder mirrors it), with the window auto-degraded as the model does."""
    out = []
    for i, heads in enumerate(sw.head_num):
        res = sw.img_size // sw.patch_size >> i
        ws = effective_window((res, res), sw.win_size, 0)[0]
        out.append((sw.emb_dim << i, heads, ws * ws))
    return out


def test_routing_rule_matches_jax_defaults(jax_defaults):
    configs = {"Config()": tconfig.Config().swinunet,
               "tiny_config()": tconfig.tiny_config().swinunet,
               "scaled EMB-180/WIN-16": jconfig.scaled_config().swinunet}
    seen = set()
    for label, sw in configs.items():
        for C, heads, N in _stage_geometry(sw):
            want = jwa.bwd_residuals_enabled(C, heads, N)
            assert twa.bwd_residuals_enabled(C, heads, N) == want, (label, C, heads, N)
            seen.add(want)
    assert seen == {True, False}
    assert [twa.bwd_residuals_enabled(C, h, N)
            for C, h, N in _stage_geometry(tconfig.Config().swinunet)] == [True, True, False,
                                                                            False]


def test_block_checks_want_the_bias_unless_the_kernel_reads_none():
    with pytest.raises(ValueError, match="bias shape None"):
        twa._check_window("fused_swin_block", 8, 8, 32, 4, 2, None, None)
    with pytest.raises(ValueError, match="takes no rel-pos bias"):
        twa._check_window("swin_block_bwd_res", 8, 8, 32, 4, 2, torch.zeros(2, 16, 16), None,
                          no_bias=True)
    twa._check_window("swin_block_bwd_res", 8, 8, 32, 4, 2, None, None, no_bias=True)
    twa._check_window("fused_swin_block", 8, 8, 32, 4, 2, torch.zeros(2, 16, 16), None)
