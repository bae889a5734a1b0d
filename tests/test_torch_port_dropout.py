"""Dropout and activation checkpointing in the port's training forward,
against the JAX package.

Both rates (``SWINUNET.DROP_RATE``, ``ATTN_DROP_RATE``) above 0, drop-path
0.1, float32, on the CPU. The two packages draw their masks from different
generators, so both take them from one numpy source: JAX's ``_dropout``
(``models/layers.py`` and ``models/sunet.py``) and ``drop_path``, and the
port's ``layers.dropout`` and ``layers.drop_path_scales``, are replaced by
functions that take keep masks in call order (JAX's block loop is plain
Python, so its call order is its program order); each mask's shape is
checked where it is taken. JAX runs its XLA route (a block with dropout
trains there on both of its backends); the port its fused route, whose
blocks with dropout train on the eager block and whose x4 head runs the
kernels' plain versions. Weights come from the JAX model through
``tools/export_torch_checkpoint.py::params_to_state_dict``.

Weights: the port's seeded tiny model moved by N(0, 0.05) noise; JAX's
model is built by ``nnx.eval_shape`` (its own initialisation never runs)
and filled through ``tools/import_torch_checkpoint.py::torch_to_params``;
JAX's gradients come back through
``tools/export_torch_checkpoint.py::params_to_state_dict``.

Tolerances, per tensor: |got - want| <= atol + rtol * max|want|, rtol 1e-5
and atol 1e-6 against JAX (float32 in other summation orders; the
drop-path product is x * (1/0.9) in the port and x / 0.9 in JAX, one
rounding apart), rtol 1e-6 and atol 0 between USE_CHECKPOINTS on and off
(the same operations on the same values).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sunet_tf_tpu import config as jconfig
from sunet_tf_tpu.models import layers as jlayers
from sunet_tf_tpu.models import sunet as jsunet
from sunet_tf_tpu_torch import config as tconfig
from sunet_tf_tpu_torch.kernels import _build
from sunet_tf_tpu_torch.models import layers as tlayers
from sunet_tf_tpu_torch.models.sunet import INFER_WRAPPERS, TRAIN_WRAPPERS, build_model
from sunet_tf_tpu_torch.weights import PREFIX, load_reference_state_dict
from tools.export_torch_checkpoint import params_to_state_dict
from tools.import_torch_checkpoint import torch_to_params

RATE, DROP_PATH = 0.1, 0.1
RTOL, ATOL = 1e-5, 1e-6
BLOCK = "layers.1.blocks.1"   # C=32, shift 2 on an 8x8 map, drop-path rate > 0
BLOCK_WRAPPERS = ("fused_swin_block", "fused_swin_block_res", "swin_block_bwd",
                  "swin_block_bwd_res", "fused_ln_window_attention", "ln_window_attention_bwd",
                  "ln_mlp_branch", "ln_mlp_bwd", "fused_swin_block_chain", "fused_ln_mlp")


def swin_overrides(rate: float = RATE, **kw) -> dict:
    """Both dropout rates (and ``kw``); ``tiny_config()``'s drop-path rate
    is DROP_PATH on both sides."""
    return dict(drop_rate=rate, attn_drop_rate=rate, **kw)


class MaskSource:
    """Keep masks for both packages, taken in call order: JAX's calls make
    them (numpy seed), the port's calls take them back in the same order."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.drop, self.path = [], []
        self.i_drop = self.i_path = 0

    def make(self, queue: list, shape: tuple, rate: float) -> np.ndarray:
        keep = self.rng.random(shape) < 1.0 - rate
        queue.append(keep)
        return keep

    def take(self, queue: str, shape: tuple) -> np.ndarray:
        i = getattr(self, "i_" + queue)
        keep = getattr(self, queue)[i]
        assert keep.shape == tuple(shape), (queue, i, keep.shape, shape)
        setattr(self, "i_" + queue, i + 1)
        return keep

    def jax_patches(self, monkeypatch):
        def dropout(x, rate, key):
            if rate <= 0.0 or key is None:
                return x
            keep = jnp.asarray(self.make(self.drop, x.shape, rate))
            return jnp.where(keep, x / (1.0 - rate), jnp.zeros_like(x))

        def drop_path(x, rate, key):
            if rate <= 0.0 or key is None:
                return x
            keep = self.make(self.path, (x.shape[0],), rate)
            keep = jnp.asarray(keep).reshape((-1,) + (1,) * (x.ndim - 1))
            return jnp.where(keep, x / (1.0 - rate), jnp.zeros_like(x))

        monkeypatch.setattr(jlayers, "_dropout", dropout)
        monkeypatch.setattr(jsunet, "_dropout", dropout)
        monkeypatch.setattr(jlayers, "drop_path", drop_path)

    def port_patches(self, monkeypatch):
        """The port's sites take masks in order of first sight of (the
        generator's seed, the call's ordinal on that generator object): a
        checkpointed block's recompute, on a new block-local generator of
        the same seed, takes the masks of its forward again."""
        seen, calls, held = {}, {}, []

        def dropout(x, rate, generator):
            if generator is None or rate <= 0.0:
                return x
            held.append(generator)   # no id is reused while the test runs
            k = calls.get(id(generator), 0)
            calls[id(generator)] = k + 1
            key = (generator.initial_seed(), k)
            if key not in seen:
                seen[key] = torch.from_numpy(self.take("drop", x.shape))
            keep = seen[key]
            assert keep.shape == x.shape, (key, keep.shape, x.shape)
            return torch.where(keep, x / (1.0 - rate), 0.0)

        def drop_path_scales(batch, rate, generator, device):
            if generator is None or rate <= 0.0:
                return torch.ones(batch, 2)
            # JAX draws the attention branch's mask, then the MLP branch's
            keep = np.stack([self.take("path", (batch,)), self.take("path", (batch,))], 1)
            return torch.from_numpy(keep.astype(np.float32) / np.float32(1.0 - rate))

        monkeypatch.setattr(tlayers, "dropout", dropout)
        monkeypatch.setattr(tlayers, "drop_path_scales", drop_path_scales)

    def all_taken(self) -> bool:
        return self.i_drop == len(self.drop) and self.i_path == len(self.path)


def jax_model(sd: dict, **overrides) -> tuple:
    """(graphdef, params) of the JAX tiny model (XLA route, float32) with
    both rates and ``overrides``, holding the reference-keyed ``sd``."""
    jcfg = jconfig.tiny_config()
    jcfg = jcfg.replace(swinunet=dataclasses.replace(jcfg.swinunet,
                                                     **swin_overrides(**overrides)),
                        tpu=jcfg.tpu.__class__(compute_dtype="float32",
                                               attention_backend="xla"))
    abstract = nnx.eval_shape(lambda: jsunet.build_model(jcfg, seed=0))
    gd, st = nnx.split(abstract)
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype)
                         if isinstance(a, jax.ShapeDtypeStruct) else a, st)
    jmodel = nnx.merge(gd, zeros)
    params = torch_to_params(sd, jmodel)
    return nnx.split(jmodel, nnx.Param)[0], jax.tree.map(jnp.asarray, params)


@pytest.fixture(scope="module")
def pair():
    """(graphdef, params) of the JAX tiny model with both rates, and the
    reference-keyed weights they hold: the port's seeded model moved by
    N(0, 0.05) noise."""
    model = build_model(tconfig.tiny_config().replace(compute_dtype="float32"),
                        device="cpu", backend="eager", seed=0)
    g = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for prm in model.parameters():
            prm.add_(torch.randn(prm.shape, generator=g) * 0.05)
    sd = {PREFIX + k: v.numpy().copy() for k, v in model.state_dict().items()}
    return (*jax_model(sd), sd)


def port_model(sd, backend: str = "fused", rate: float = RATE, **kw):
    cfg = tconfig.tiny_config(**swin_overrides(rate, **kw)).replace(compute_dtype="float32")
    model = build_model(cfg, device="cpu", backend=backend, seed=0)
    load_reference_state_dict(model, sd)
    return model.train().requires_grad_(True)


def close(got, want, what, rtol=RTOL, atol=ATOL):
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, limit = np.abs(got - want).max(), atol + rtol * np.abs(want).max()
    assert err <= limit, (what, err, limit)


def test_block_forward_and_grads_match_jax(pair, monkeypatch):
    gd, state, sd = pair
    src = MaskSource(11)
    src.jax_patches(monkeypatch)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    dout = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)

    def jloss(st, xx):
        blk = nnx.merge(gd, st).layers[1].blocks[1]
        y = blk(xx, jax.random.key(0))
        return jnp.sum(y * jnp.asarray(dout)), y

    # one trace: the masks are made once, in program order
    (_, jy), (jg, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        state, jnp.asarray(x))
    want = params_to_state_dict(nnx.merge(gd, jg))

    src.port_patches(monkeypatch)
    model = port_model(sd)
    blk = model.get_submodule(BLOCK)
    assert blk.has_dropout() and blk.drop_path_rate > 0 and blk.shift_size == 2
    xt = torch.from_numpy(x).requires_grad_(True)
    _build.reset_counts()
    y = blk(xt, torch.Generator().manual_seed(0))
    (y * torch.from_numpy(dout)).sum().backward()
    assert src.all_taken() and len(src.drop) == 4 and len(src.path) == 2
    assert not any(_build.counter(k).cpu for k in BLOCK_WRAPPERS)
    close(y, jy, "block output")
    close(xt.grad, jgx, "dx")
    n = 0
    for name, p in blk.named_parameters():
        close(p.grad, want[f"{PREFIX}{BLOCK}.{name}"], name)
        n += 1
    assert n == 13


def test_model_training_forward_matches_jax(pair, monkeypatch):
    gd, state, sd = pair
    src = MaskSource(12)
    src.jax_patches(monkeypatch)
    x = np.random.default_rng(6).random((2, 64, 64, 3)).astype(np.float32)
    jy = jax.jit(lambda st, xx: nnx.merge(gd, st)(xx, key=jax.random.key(1)))(
        state, jnp.asarray(x))
    src.port_patches(monkeypatch)
    model = port_model(sd)
    _build.reset_counts()
    y = model(torch.from_numpy(x), generator=torch.Generator().manual_seed(1))
    # the features dropout, then 4 sites in each of the 14 blocks
    assert src.all_taken() and len(src.drop) == 1 + 4 * 14
    assert not any(_build.counter(k).cpu for k in BLOCK_WRAPPERS)
    assert _build.counter("fused_dual_upsample4_conv_phase").cpu == 1
    close(y, jy, "logits")


def test_use_checkpoints_step_matches_jax_checkpoint(pair, monkeypatch):
    """USE_CHECKPOINTS on both sides (JAX ``SwinStage.__call__``'s
    ``jax.checkpoint`` per block): the loss and every gradient of one
    training forward with dropout and drop-path."""
    sd = pair[2]
    gd, state = jax_model(sd, use_checkpoint=True)
    src = MaskSource(13)
    src.jax_patches(monkeypatch)
    rng = np.random.default_rng(9)
    x = rng.random((1, 64, 64, 3)).astype(np.float32)
    w = rng.standard_normal((1, 64, 64, 1)).astype(np.float32)

    def jloss(st):
        return jnp.sum(nnx.merge(gd, st)(jnp.asarray(x), key=jax.random.key(2)) * w)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(state)
    want = params_to_state_dict(nnx.merge(gd, jg))
    assert len(src.drop) == 1 + 4 * 14   # JAX drew each mask once

    src.port_patches(monkeypatch)
    model = port_model(sd, use_checkpoint=True)
    loss = (model(torch.from_numpy(x), generator=torch.Generator().manual_seed(2))
            * torch.from_numpy(w)).sum()
    loss.backward()
    assert src.all_taken()
    close(loss, jl, "loss")
    n = 0
    for name, p in model.named_parameters():
        if p.grad is not None:
            close(p.grad, want[PREFIX + name], name)
            n += 1
    assert n == len(list(model.parameters())) - 1   # all but the unused PReLU


def blocks_of(model) -> list:
    return [b for st in list(model.layers) + list(model.layers_up[1:]) for b in st.blocks]


def test_rates0_draw_only_drop_path(pair):
    """At rates 0 a training forward draws each block's drop-path scales
    and nothing else, so default training keeps its draws and outputs."""
    model = port_model(pair[2], rate=0.0)
    g = torch.Generator().manual_seed(9)
    _build.reset_counts()
    model(torch.rand(1, 64, 64, 3), generator=g)
    assert _build.counter("fused_swin_block_res").cpu == 14   # the kernel route
    replay = torch.Generator().manual_seed(9)
    for blk in blocks_of(model):
        tlayers.drop_path_scales(1, blk.drop_path_rate, replay, "cpu")
    assert torch.equal(g.get_state(), replay.get_state())


def test_dropout_routes_training_to_eager_and_leaves_inference(pair):
    x = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(2))
    with_rates, without = port_model(pair[2]), port_model(pair[2], rate=0.0)
    _build.reset_counts()
    y = with_rates(x, generator=torch.Generator().manual_seed(0))
    y.mean().backward()
    counts = {k: _build.counter(k).cpu for k in TRAIN_WRAPPERS}
    assert not any(counts[k] for k in BLOCK_WRAPPERS)
    assert counts == with_rates.expected_launches(tuple(x.shape), train=True)
    with torch.no_grad():
        _build.reset_counts()
        a = with_rates.eval()(x)
        counts = {k: _build.counter(k).cpu for k in INFER_WRAPPERS}
        b = without.eval()(x)
    assert counts["fused_swin_block"] > 0
    assert counts == with_rates.expected_launches(tuple(x.shape))
    assert torch.equal(a, b)


@pytest.mark.parametrize("rate", [0.0, RATE])
def test_use_checkpoints_keeps_loss_grads_and_draws(pair, rate):
    x = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(3))
    runs = []
    for ckpt in (False, True):
        model = port_model(pair[2], rate=rate, use_checkpoint=ckpt)
        g = torch.Generator().manual_seed(4)
        _build.reset_counts()
        loss = model(x, generator=g).square().mean()
        loss.backward()
        counts = {k: _build.counter(k).cpu for k in TRAIN_WRAPPERS}
        assert counts == model.expected_launches(tuple(x.shape), train=True)
        runs.append((loss.detach(), dict(model.named_parameters()), g.get_state(), counts))
    (l0, p0, s0, c0), (l1, p1, s1, c1) = runs
    close(l1, l0, "loss", rtol=1e-6, atol=0)
    for name, p in p0.items():
        assert (p.grad is None) == (p1[name].grad is None), name
        if p.grad is not None:   # the unused top-level PReLU has none
            close(p1[name].grad, p.grad, name, rtol=1e-6, atol=0)
    assert torch.equal(s0, s1)
    # the recompute in backward runs each block's forward kernels again
    if rate == 0.0:
        assert c1["fused_swin_block_res"] == 2 * c0["fused_swin_block_res"] == 28
        assert c1["swin_block_bwd_res"] == c0["swin_block_bwd_res"]


def test_use_checkpoints_inference_takes_no_chain(pair, monkeypatch):
    """JAX ``SwinStage.__call__``: no chain (and no stage runner) under
    ``use_checkpoint``; the blocks one by one give the chain's values."""
    monkeypatch.setattr(tlayers, "ROUTE_PAIR_MIN_C", 16)
    x = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(8))
    outs = []
    for ckpt in (False, True):
        model = port_model(pair[2], rate=0.0, use_checkpoint=ckpt).eval()
        _build.reset_counts()
        with torch.no_grad():
            outs.append(model(x))
        counts = {k: _build.counter(k).cpu for k in INFER_WRAPPERS}
        assert counts == model.expected_launches(tuple(x.shape))
        assert (counts["fused_swin_block_chain"] > 0) != ckpt
    close(outs[1], outs[0], "chain vs blocks", rtol=1e-6, atol=1e-7)
