"""The split x4 head (kernels #10 and #11) of the port against the JAX package.

The plain versions of ``sunet_tf_tpu_torch/kernels/upsample.py`` (what a CPU
tensor runs, and what ``chip_smoke.py`` holds the CUDA kernels against on
the card) against the JAX Pallas functions in interpret mode, as the JAX
package's own tests run them: ``fused_dual_upsample4_reference`` against
``fused_dual_upsample4`` and ``up4_bwd_reference`` against ``_up4_bwd_impl``,
at C=16 on a (16, 16) map (one strip of the JAX kernel) and a (32, 32) map
(two strips: the strip halo and the edge clamp), in float32 and in bf16.
Then a tiny 16-band denoise SUNet (``tiny_config(in_chans=16,
out_chans=16)``: 16 * OUT_CHANS > 128, so the split head runs) on the fused
route against the JAX pallas-backend model: the forward, and one training
step's loss and gradients against JAX ``value_and_grad``.

Tolerances: float32, rtol = atol = 1e-4 (other summation orders); bf16,
both sides round at the same points and sum in other orders, so an element
may differ by one bf16 ulp where a rounding flips: |diff| <= 2^-6 *
max(1, |ref|) elementwise and a mean |diff| <= 1e-3 * max(1, mean|ref|).
The model: forward rtol 1e-3, atol 1e-4 (the slice tolerance of
``test_torch_port_model.py``); the step as ``test_torch_port_train_step.py``
(loss relative 1e-5, every gradient max |diff| <= 2e-3 * max|ref| + 1e-7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sunet_tf_tpu import config as jconfig
from sunet_tf_tpu.kernels import upsample as jup
from sunet_tf_tpu.models.sunet import build_model as jax_build_model
from sunet_tf_tpu.train.losses import charbonnier_loss as jax_charbonnier
from sunet_tf_tpu_torch import config as tconfig
from sunet_tf_tpu_torch.kernels import _build
from sunet_tf_tpu_torch.kernels import upsample as tup
from sunet_tf_tpu_torch.models import layers as tlayers
from sunet_tf_tpu_torch.models.sunet import TRAIN_WRAPPERS, build_model
from sunet_tf_tpu_torch.train.loop import loss_and_metrics
from sunet_tf_tpu_torch.weights import PREFIX, load_reference_state_dict
from tools.export_torch_checkpoint import params_to_state_dict

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ULPS, BF16_MEAN = 2.0 ** -6, 1e-3
SLICE_TOL = dict(rtol=1e-3, atol=1e-4)
GRAD_REL, GRAD_ABS, LOSS_REL = 2e-3, 1e-7, 1e-5
BANDS = 16


def _head_args(rng, B, H, W, C):
    """x, w_exp, alpha_p, w_b1, b_b1, alpha_b, wpf, wbf as float32 numpy."""
    n = lambda *s, sd=1.0: (rng.standard_normal(s) * sd).astype(np.float32)
    return [n(B, H, W, C), n(C, 16 * C, sd=C ** -0.5), np.full((1,), 0.25, np.float32),
            n(C, C, sd=C ** -0.5), n(C, sd=0.1), np.full((1,), 0.1, np.float32),
            n(C, C, sd=C ** -0.5), n(C, C, sd=C ** -0.5)]


def _pair(args, dtype):
    """The same arrays for JAX and for the port, x and the matrices in
    dtype (the kernels take them so; both sides round the same float32
    values), b_b1 and the slopes float32."""
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    cast = (0, 1, 3, 6, 7)
    j = [jnp.asarray(a).astype(jd) if i in cast else jnp.asarray(a) for i, a in enumerate(args)]
    t = [torch.from_numpy(a).to(td) if i in cast else torch.from_numpy(a)
         for i, a in enumerate(args)]
    return j, t


def _close(got: torch.Tensor, want, dtype: str, what: str):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if dtype == "f32":
        np.testing.assert_allclose(g, w, err_msg=what, **F32_TOL)
        return
    d = np.abs(g - w)
    assert (d <= BF16_ULPS * np.maximum(1.0, np.abs(w))).all(), (what, d.max())
    assert d.mean() <= BF16_MEAN * max(1.0, np.abs(w).mean()), (what, d.mean())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hw", [16, 32])
def test_split_head_plain_matches_jax(hw, dtype):
    """The forward of #10: one JAX strip at 16x16, two at 32x32."""
    assert jup._up4_strips(hw, hw, 16) == hw // 16
    rng = np.random.default_rng(60 + hw)
    j, t = _pair(_head_args(rng, 2, hw, hw, 16), dtype)
    want = jup.fused_dual_upsample4(*j)
    c = _build.counter("fused_dual_upsample4")
    before = c.cpu
    got = tup.fused_dual_upsample4(*t)
    assert c.cpu == before + tup.UP4_SPLIT_LAUNCHES and got.dtype == t[0].dtype
    assert tuple(got.shape) == (2, 4 * hw, 4 * hw, 16)
    _close(got, want, dtype, "out")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hw", [16, 32])
def test_split_head_bwd_plain_matches_jax(hw, dtype):
    """The backward of #11: dx and every float32 grad, with dW_exp in the
    (C, 16C) layout; dx is in x's dtype, the grads float32."""
    rng = np.random.default_rng(70 + hw)
    args = _head_args(rng, 2, hw, hw, 16)
    dout = rng.standard_normal((2, 4 * hw, 4 * hw, 16)).astype(np.float32)
    j, t = _pair(args, dtype)
    want = jup._up4_bwd_impl(*j, jnp.asarray(dout))
    c = _build.counter("up4_bwd")
    before = c.cpu
    got = tup.up4_bwd(*t, torch.from_numpy(dout))
    assert c.cpu == before + tup.UP4_BWD_LAUNCHES
    labels = ("dx", "dw_exp", "dalpha_p", "dw_b1", "db_b1", "dalpha_b", "dwpf", "dwbf")
    for lab, g, w in zip(labels, got, want):
        if lab == "dx":
            _close(g, w, dtype, lab)
            continue
        assert g.dtype == torch.float32, lab
        w = np.asarray(w, np.float32)
        if dtype == "f32":
            np.testing.assert_allclose(g.numpy(), w, err_msg=lab, **F32_TOL)
        else:
            # float32 sums of bf16 products: rounding flips upstream move a
            # sum by a few ulps of its terms, not of the sum
            scale = np.abs(w).max()
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-2 * scale, err_msg=lab)


def test_split_head_function_grads_are_the_wrappers():
    """DualUpsample4Trainable: the forward through the counted wrapper, the
    backward through up4_bwd, grads in the inputs' shapes."""
    rng = np.random.default_rng(80)
    _, t = _pair(_head_args(rng, 1, 8, 8, 16), "f32")
    x = t[0].requires_grad_(True)
    ws = [a.requires_grad_(True) for a in t[1:]]
    _build.reset_counts()
    y = tup.DualUpsample4Trainable.apply(x, *ws)
    dout = torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(np.float32))
    y.backward(dout)
    assert _build.counter("fused_dual_upsample4").cpu == tup.UP4_SPLIT_LAUNCHES
    assert _build.counter("up4_bwd").cpu == tup.UP4_BWD_LAUNCHES
    want = tup.up4_bwd_reference(x.detach(), *[w.detach() for w in ws], dout)
    for a, g in zip((x, *ws), want):
        assert a.grad.shape == a.shape
        torch.testing.assert_close(a.grad, g.reshape(a.shape))


def test_split_head_wrappers_raise_off_cpu_and_cuda():
    x = torch.empty(1, 8, 8, 16, device="meta")
    w = torch.empty(16, 16, device="meta")
    a = torch.empty(1, device="meta")
    args = (x, torch.empty(16, 256, device="meta"), a, w, w[0], a, w, w)
    with pytest.raises(ValueError, match="CUDA"):
        tup.fused_dual_upsample4(*args)
    with pytest.raises(ValueError, match="CUDA"):
        tup.up4_bwd(*args, torch.empty(1, 32, 32, 16, device="meta"))


# ---------------------------------------------------------------- the model


def _jax_cfg(compute_dtype="float32"):
    cfg = jconfig.tiny_config(in_chans=BANDS, out_chans=BANDS)
    cfg = cfg.replace(swinunet=dataclasses.replace(cfg.swinunet, drop_path_rate=0.0))
    return cfg.replace(tpu=cfg.tpu.__class__(compute_dtype=compute_dtype,
                                             attention_backend="pallas"))


@pytest.fixture(scope="module")
def jax_bands():
    """The tiny 16-band JAX model (pallas backend) and its parameters, every
    leaf perturbed from a numpy seed."""
    jmodel = jax_build_model(_jax_cfg(), seed=5)
    gd, state = nnx.split(jmodel, nnx.Param)
    leaves, treedef = jax.tree.flatten(state)
    rng = np.random.default_rng(13)
    leaves = [jnp.asarray(np.asarray(l) + rng.normal(0, 0.05, l.shape).astype(np.float32))
              for l in leaves]
    return gd, jax.tree.unflatten(treedef, leaves)


def _port_bands(gd, params):
    cfg = tconfig.tiny_config(in_chans=BANDS, out_chans=BANDS)
    cfg = cfg.replace(swinunet=dataclasses.replace(cfg.swinunet, drop_path_rate=0.0),
                      compute_dtype="float32")
    model = build_model(cfg, device="cpu", backend="fused", seed=0)
    return load_reference_state_dict(model, params_to_state_dict(nnx.merge(gd, params)))


def test_bands_forward_matches_jax_pallas(jax_bands):
    """Inference: every block on its kernel's plain version and the split
    head (#10) on both sides; the output conv a plain convolution."""
    gd, params = jax_bands
    model = _port_bands(gd, params)
    x = np.random.default_rng(9).random((1, 64, 64, BANDS), np.float32)
    want = jax.jit(lambda p, x: nnx.merge(gd, p)(x))(params, jnp.asarray(x))
    _build.reset_counts()
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    calls = {k: _build.counter(k).cpu for k in model.expected_launches(x.shape)}
    assert calls == model.expected_launches(x.shape)
    assert (calls["fused_dual_upsample4"] == tup.UP4_SPLIT_LAUNCHES
            and calls["fused_dual_upsample4_conv_phase"] == 0)
    assert tuple(got.shape) == (1, 64, 64, BANDS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SLICE_TOL)


def test_bands_training_step_matches_jax(jax_bands, monkeypatch):
    """One denoise training step, the head on #10 + #11 on both sides (JAX
    ``dual_upsample4_trainable``, the port's ``DualUpsample4Trainable``),
    the blocks on plain autograd on both sides (JAX
    ``SUNET_TRAIN_KERNEL_MAX_C=0``, the port's training caps at 0): the
    block routes are held against JAX in the other step files, and this
    keeps the file's interpret-mode work to the head."""
    monkeypatch.setenv("SUNET_TRAIN_KERNEL_MAX_C", "0")
    monkeypatch.setattr(tlayers, "ROUTE_TRAIN_BLOCK_MAX_C", 0)
    monkeypatch.setattr(tlayers, "ROUTE_TRAIN_SPLIT_MAX_C", 0)
    gd, params = jax_bands
    rng = np.random.default_rng(22)
    inp = rng.random((1, 64, 64, BANDS), np.float32)
    tar = rng.random((1, 64, 64, BANDS), np.float32)

    def jloss(p):
        logits = nnx.merge(gd, p)(jnp.asarray(inp), key=jax.random.key(0))
        return jax_charbonnier(logits, jnp.asarray(tar), jnp.ones((1, 1, 1, 1)))

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    want = params_to_state_dict(nnx.merge(gd, jgrads))

    model = _port_bands(gd, params)
    model.train().requires_grad_(True)
    _build.reset_counts()
    loss, _, _ = loss_and_metrics(model, torch.from_numpy(inp), torch.from_numpy(tar),
                                  torch.Generator().manual_seed(0), torch.ones(1), "denoise")
    loss.backward()
    calls = {k: _build.counter(k).cpu for k in TRAIN_WRAPPERS}
    assert calls == model.expected_launches(inp.shape, train=True)
    assert calls["fused_dual_upsample4"] == tup.UP4_SPLIT_LAUNCHES
    assert calls["up4_bwd"] == tup.UP4_BWD_LAUNCHES
    # blocks on autograd
    assert sum(calls.values()) == tup.UP4_SPLIT_LAUNCHES + tup.UP4_BWD_LAUNCHES

    assert abs(float(loss.detach()) - float(jl)) <= LOSS_REL * abs(float(jl))
    for name, p in model.named_parameters():
        w = np.asarray(want[PREFIX + name], np.float64)
        g = np.zeros(p.shape) if p.grad is None else p.grad.double().numpy()
        err = np.abs(g - w).max()
        assert err <= GRAD_REL * np.abs(w).max() + GRAD_ABS, (name, err, np.abs(w).max())
