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

Three routings, matched on both sides: every block through the block
kernels (the default caps, this file); the C=128 stage through plain
autograd (port ``ROUTE_TRAIN_BLOCK_MAX_C`` and ``ROUTE_TRAIN_SPLIT_MAX_C``
and JAX ``SUNET_TRAIN_KERNEL_MAX_C`` at 64,
``test_torch_port_train_step_cap.py``); and every block through the two
sublayer kernels (port ``ROUTE_TRAIN_BLOCK_MAX_C`` at 0, JAX
``SUNET_TRAIN_BLOCK_KERNEL=0``, ``test_torch_port_train_step_split.py``).
The other files import ``check_step`` from here; one file each keeps
each under two minutes on one core. These three run the recompute backward
on both sides: the port's ``ROUTE_TRAIN_RESID`` off, and JAX's per-head
attention form (``SUNET_BWD_RESID=0``, ``SUNET_ATTN_LAYOUT_BWD=perhead``),
the form the port implements. ``test_torch_port_train_step_res.py`` runs
the residual route against JAX's defaults (``resid=True``).

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
from sunet_tf_tpu_torch.kernels import window_attention as wa
from sunet_tf_tpu_torch.models import layers as tlayers
from sunet_tf_tpu_torch.models.sunet import TRAIN_WRAPPERS, build_model
from sunet_tf_tpu_torch.train.loop import loss_and_metrics
from sunet_tf_tpu_torch.weights import PREFIX, load_reference_state_dict
from tools.export_torch_checkpoint import params_to_state_dict

GRAD_REL, GRAD_ABS, LOSS_REL = 2e-3, 1e-7, 1e-5


def _no_drop_path(cfg):
    return cfg.replace(swinunet=dataclasses.replace(cfg.swinunet, drop_path_rate=0.0))


def make_batch(size: int = 64):
    rng = np.random.default_rng(21)
    inp = rng.random((1, size, size, 3), np.float32)
    # blob-like binary masks, so the boundary rings have every weight
    tar = (rng.random((1, size // 4, size // 4, 1)) > 0.6).astype(np.float32)
    tar = np.repeat(np.repeat(tar, 4, axis=1), 4, axis=2)
    return inp, tar


def check_step(cap, monkeypatch, split: bool = False, resid: bool = False, configs=None,
               routes=None, jax_backend: str = "pallas"):
    """The port's tiny training step against JAX's with the training-kernel
    cap ``cap`` on both sides (None: the defaults); ``split``: every block
    within the cap on the two sublayer kernels instead of the block
    kernels; ``resid``: the residual route at JAX's defaults (every tiny
    block takes the blockdiag layout), else the recompute route.
    ``configs``: (JAX config, port config) in place of the tiny ones, with
    ``routes``, the blocks on the block kernels and on the sublayer kernels
    that the port's router must give (the tiny model's are written here);
    ``jax_backend``: JAX's attention backend ("xla": autograd of the XLA
    route in place of the Pallas kernels in interpret mode)."""
    if not resid:
        monkeypatch.setenv("SUNET_BWD_RESID", "0")
        monkeypatch.setenv("SUNET_ATTN_LAYOUT_BWD", "perhead")
        monkeypatch.setattr(tlayers, "ROUTE_TRAIN_RESID", False)
    if cap is not None:
        monkeypatch.setenv("SUNET_TRAIN_KERNEL_MAX_C", str(cap))
        monkeypatch.setattr(tlayers, "ROUTE_TRAIN_BLOCK_MAX_C", cap)
        monkeypatch.setattr(tlayers, "ROUTE_TRAIN_SPLIT_MAX_C", cap)
    if split:
        monkeypatch.setenv("SUNET_TRAIN_BLOCK_KERNEL", "0")
        monkeypatch.setattr(tlayers, "ROUTE_TRAIN_BLOCK_MAX_C", 0)
    jbase, tbase = configs or (jconfig.tiny_config(), tconfig.tiny_config())
    inp, tar = make_batch(jbase.swinunet.img_size)

    jcfg = _no_drop_path(jbase)
    jcfg = jcfg.replace(tpu=jcfg.tpu.__class__(compute_dtype="float32",
                                               attention_backend=jax_backend))
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

    value_and_grad = jax.value_and_grad(jloss)
    if jax_backend == "xla":   # one compile of the whole step, not one per op
        value_and_grad = jax.jit(value_and_grad)
    jl, jgrads = value_and_grad(params)
    want = params_to_state_dict(nnx.merge(gd, jgrads))

    tcfg = _no_drop_path(tbase.replace(compute_dtype="float32"))
    model = build_model(tcfg, device="cpu", backend="fused", seed=0)
    load_reference_state_dict(model, params_to_state_dict(nnx.merge(gd, params)))
    model.train().requires_grad_(True)
    _build.reset_counts()
    loss, _, _ = loss_and_metrics(model, torch.from_numpy(inp), torch.from_numpy(tar),
                                  torch.Generator().manual_seed(0), torch.ones(1), "mask")
    loss.backward()
    calls = {k: _build.counter(k).cpu for k in TRAIN_WRAPPERS}
    assert calls == model.expected_launches(inp.shape, train=True)
    assert calls["up4_conv_bwd"] > 0
    # blocks on each route (the tiny model has 14: 2 at C=128)
    blocks = [b for st in list(model.layers) + list(model.layers_up[1:]) for b in st.blocks]
    on_block = (calls["fused_swin_block"] // wa.block_launches(blocks[0].window_size)
                + calls["fused_swin_block_res"])
    on_split = calls["ln_mlp_branch"] // wa.LN_MLP_BRANCH_LAUNCHES
    if routes is None:
        routes = (0, 14) if split else (12, 0) if cap else (14, 0)
    assert (on_block, on_split) == routes
    assert calls["fused_swin_block_res"] == (on_block if resid else 0)

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
