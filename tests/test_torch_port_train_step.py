"""The port's whole training step held against the JAX package's.

The tiny config (64x64, C=16..128, depths 2, heads 2, ws 4) in float32,
task mask, augmentation off, drop-path rate 0: the loss and the gradient of
every parameter from the port (``train.loop.loss_and_metrics`` + autograd,
the kernels' plain versions on the CPU) against JAX ``value_and_grad`` of
the same loss (``train/loop.py::loss_and_metrics``: forward with a key,
boundary-ring weights, weighted Charbonnier) with the Pallas training
kernels in interpret mode. Weights come from the JAX model through
``tools/export_torch_checkpoint.py::params_to_state_dict``; the JAX
gradients are mapped to the port's parameter names the same way.

Two routings, matched on both sides: every block through the block
kernels (the default caps, this file), and the C=128 stage through plain
autograd (port ``ROUTE_TRAIN_BLOCK_MAX_C`` and JAX
``SUNET_TRAIN_KERNEL_MAX_C`` at 64, ``test_torch_port_train_step_cap.py``,
which imports ``check_step`` from here; one file each keeps each under two
minutes on one core). The JAX side runs the recompute backward with the per-head attention
form (``SUNET_BWD_RESID=0``, ``SUNET_ATTN_LAYOUT_BWD=perhead``), the form
the port implements.

Tolerance: loss relative 1e-5; every gradient tensor max |diff| <= 2e-3 *
max|ref| + 1e-7: float32 through a whole network and back, in other
summation orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from sunet_tf_tpu import config as jconfig
from sunet_tf_tpu.models.sunet import build_model as jax_build_model
from sunet_tf_tpu.ops.morphology import boundary_ring_weights as jax_weights
from sunet_tf_tpu.train.losses import charbonnier_loss as jax_charbonnier
from sunet_tf_tpu_torch import config as tconfig
from sunet_tf_tpu_torch.kernels import _build
from sunet_tf_tpu_torch.models import layers as tlayers
from sunet_tf_tpu_torch.models.sunet import TRAIN_WRAPPERS, build_model
from sunet_tf_tpu_torch.train.loop import loss_and_metrics
from sunet_tf_tpu_torch.weights import PREFIX, load_reference_state_dict
from tools.export_torch_checkpoint import params_to_state_dict

GRAD_REL, GRAD_ABS, LOSS_REL = 2e-3, 1e-7, 1e-5


def _no_drop_path(cfg):
    return cfg.replace(swinunet=dataclasses.replace(cfg.swinunet, drop_path_rate=0.0))


def make_batch():
    rng = np.random.default_rng(21)
    inp = rng.random((1, 64, 64, 3), np.float32)
    # blob-like binary masks, so the boundary rings have every weight
    tar = (rng.random((1, 16, 16, 1)) > 0.6).astype(np.float32)
    tar = np.repeat(np.repeat(tar, 4, axis=1), 4, axis=2)
    return inp, tar


def check_step(cap, monkeypatch):
    """The port's tiny training step against JAX's with the training-kernel
    cap ``cap`` on both sides (None: the defaults)."""
    monkeypatch.setenv("SUNET_BWD_RESID", "0")
    monkeypatch.setenv("SUNET_ATTN_LAYOUT_BWD", "perhead")
    if cap is not None:
        monkeypatch.setenv("SUNET_TRAIN_KERNEL_MAX_C", str(cap))
        monkeypatch.setattr(tlayers, "ROUTE_TRAIN_BLOCK_MAX_C", cap)
    inp, tar = make_batch()

    jcfg = _no_drop_path(jconfig.tiny_config())
    jcfg = jcfg.replace(tpu=jcfg.tpu.__class__(compute_dtype="float32",
                                               attention_backend="pallas"))
    jmodel = jax_build_model(jcfg, seed=4)
    gd, state = nnx.split(jmodel, nnx.Param)
    leaves, treedef = jax.tree.flatten(state)
    rng = np.random.default_rng(12)
    leaves = [jnp.asarray(np.asarray(l) + rng.normal(0, 0.05, l.shape).astype(np.float32))
              for l in leaves]
    params = jax.tree.unflatten(treedef, leaves)

    def jloss(p):
        logits = nnx.merge(gd, p)(jnp.asarray(inp), key=jax.random.key(0))
        t = jnp.asarray(tar)
        return jax_charbonnier(logits, t, jax_weights(t) * jnp.ones((1, 1, 1, 1)))

    jl, jgrads = jax.value_and_grad(jloss)(params)
    want = params_to_state_dict(nnx.merge(gd, jgrads))

    tcfg = _no_drop_path(tconfig.tiny_config().replace(compute_dtype="float32"))
    model = build_model(tcfg, device="cpu", backend="fused", seed=0)
    load_reference_state_dict(model, params_to_state_dict(nnx.merge(gd, params)))
    model.train().requires_grad_(True)
    _build.reset_counts()
    loss, _, _ = loss_and_metrics(model, torch.from_numpy(inp), torch.from_numpy(tar),
                                  torch.Generator().manual_seed(0), torch.ones(1), "mask")
    loss.backward()
    calls = {k: _build.counter(k).cpu for k in TRAIN_WRAPPERS}
    assert calls == model.expected_launches(inp.shape, train=True)
    assert calls["swin_block_bwd"] > 0 and calls["up4_conv_bwd"] > 0
    if cap is not None:   # the C=128 bottleneck's 2 blocks take plain autograd
        assert calls["fused_swin_block"] == 12

    assert abs(float(loss.detach()) - float(jl)) <= LOSS_REL * abs(float(jl))
    n = 0
    for name, p in model.named_parameters():
        w = np.asarray(want[PREFIX + name], np.float64)
        g = np.zeros(p.shape) if p.grad is None else p.grad.double().numpy()
        err = np.abs(g - w).max()
        assert err <= GRAD_REL * np.abs(w).max() + GRAD_ABS, (name, err, np.abs(w).max())
        n += 1
    assert n == len(list(model.parameters()))


def test_training_step_matches_jax(monkeypatch):
    check_step(None, monkeypatch)
