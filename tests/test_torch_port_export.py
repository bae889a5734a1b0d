"""Serving artifacts of the PyTorch port (``sunet_tf_tpu_torch/infer/export.py``).

The counterparts of ``tests/test_export.py`` on ``torch.export``: an
artifact reloaded from its ``.pt2`` replays the live fused model bit for
bit, routes requests to its batch buckets, refuses a checkpoint of another
architecture and an artifact of another device, serves any checkpoint of its
architecture, and the tiled program replays the live ``TiledRunner``. The
kernels are the ``sunet::`` ops of ``kernels/ops.py``: the exported graph
holds one node per call, and a reloaded program counts its launches.

All on the CPU (the ops run their kernels' plain versions) at the tiny
config, 64x64, float32, with the port's routing thresholds lowered as in
``tests/test_torch_port_model.py`` so that every block op runs: the whole
block at C=16, W->SW chains at C=32/64, LN+W-MSA + LN+MLP at C=128. The
reloaded artifact is held against the JAX package's jitted forward on its
XLA route (the plain reference of its Pallas kernels) on weights carried
across, at that file's whole-model tolerance (rtol=1e-3, atol=1e-4).
"""

import json
import os
import subprocess
import sys
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx

from sunet_tf_tpu import config as jconfig
from sunet_tf_tpu.models.sunet import build_model as jax_build_model
from sunet_tf_tpu_torch import config as tconfig
from sunet_tf_tpu_torch import export as export_cli
from sunet_tf_tpu_torch.ckpt import save_checkpoint
from sunet_tf_tpu_torch.infer import export as tex
from sunet_tf_tpu_torch.infer.tiled import TiledRunner
from sunet_tf_tpu_torch.kernels import _build, ops
from sunet_tf_tpu_torch.kernels import window_attention as twa
from sunet_tf_tpu_torch.models import layers as tlayers
from sunet_tf_tpu_torch.models.sunet import INFER_WRAPPERS, build_model
from sunet_tf_tpu_torch.ops.window import shift_attn_mask
from tools.import_torch_checkpoint import torch_to_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE_TOL = dict(rtol=1e-3, atol=1e-4)
# launches one call of each op makes on the tiny config (windows of 16
# tokens; chains of ROUTE_CHAIN_MAX blocks)
PER_CALL = {"fused_swin_block": 1, "fused_swin_block_chain": tlayers.ROUTE_CHAIN_MAX,
            "fused_ln_window_attention": twa.LN_WMSA_LAUNCHES,
            "fused_ln_mlp": twa.LN_MLP_LAUNCHES, "fused_dual_upsample4_conv_phase": 1,
            "fused_dual_upsample4": 2}


@pytest.fixture(scope="module")
def routed():
    """Every block route of the port at tiny size, for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlayers, "ROUTE_PAIR_MIN_C", 32)
        mp.setattr(tlayers, "ROUTE_BLOCK_MAX_C", 64)
        yield


def _tiny(**kw):
    return tconfig.tiny_config(**kw).replace(compute_dtype="float32")


@pytest.fixture(scope="module")
def model(routed):
    """The tiny port SUNet, every parameter perturbed from a seed so that LN
    scales, biases and PReLU slopes are not at their init values."""
    m = build_model(_tiny(), device="cpu", backend="fused", seed=0)
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return m


@pytest.fixture(scope="module")
def jax_side(model):
    """The tiny JAX SUNet (XLA route, float32) with the port model's weights
    carried across by the JAX package's own importer
    (``tools/import_torch_checkpoint.py``); its tree comes from
    ``nnx.eval_shape``, so no weight is drawn on the JAX side."""
    cfg = jconfig.tiny_config()
    cfg = cfg.replace(tpu=cfg.tpu.__class__(compute_dtype="float32", attention_backend="xla"))
    gd, params, rest = nnx.split(nnx.eval_shape(lambda: jax_build_model(cfg, seed=3)),
                                 nnx.Param, ...)
    jmodel = nnx.merge(gd, jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), params), rest)
    state = torch_to_params({k: v.numpy() for k, v in model.state_dict().items()}, jmodel)
    return gd, state, rest


@pytest.fixture(scope="module")
def artifact(model, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("artifact"))
    meta = tex.save_exported(out, model, 64, batches=(1, 2))
    return out, meta


@pytest.fixture(scope="module")
def serving(artifact):
    return tex.ServingModel(artifact[0], device="cpu")


def _x(seed, n, size=64, chans=3):
    return torch.from_numpy(np.random.default_rng(seed).random((n, size, size, chans),
                                                                np.float32))


def _live(model, x):
    with torch.inference_mode():
        return model(x)


def _op_nodes(path) -> Counter:
    ep = torch.export.load(str(path))
    return Counter(str(n.target).split(".")[1] for n in ep.graph.nodes
                   if n.op == "call_function" and str(n.target).startswith("sunet."))


def test_export_reload_bit_parity(model, serving):
    x = _x(0, 2)
    assert torch.equal(serving(model, x), _live(model, x))


def test_export_bucket_routing(model, serving):
    """n=1 runs the b1 bucket; n=3 a full b2 chunk and a b2 chunk with a
    zero-padded tail: each equals the live forward of the batch it ran."""
    x = _x(1, 3)
    got = serving(model, x)
    assert got.shape == (3, 64, 64, 1)
    tail = torch.cat([x[2:], torch.zeros_like(x[2:])])
    assert torch.equal(got, torch.cat([_live(model, x[:2]), _live(model, tail)[:1]]))
    assert torch.equal(serving(model, x[:1]), _live(model, x[:1]))


def test_export_leaf_count_guard(model, artifact, serving):
    """A checkpoint of another architecture (a different leaf count, or a
    leaf of another shape) is refused before anything runs."""
    meta = artifact[1]
    leaves = [p.detach() for p in model.parameters()]
    assert meta["num_param_leaves"] == len(leaves)
    assert meta["param_names"] == [n for n, _ in model.named_parameters()]
    x = torch.zeros(1, 64, 64, 3)
    with pytest.raises(ValueError, match="leaves"):
        serving(leaves[:-1], x)
    with pytest.raises(ValueError, match="shape"):
        serving(leaves[:1] + [leaves[1][:-1]] + leaves[2:], x)


def test_export_weights_agnostic(model, artifact, serving):
    """One artifact serves any checkpoint of its architecture: with
    perturbed weights it equals the live model under the same weights and
    differs from the unperturbed output; a state_dict serves as well; the
    .pt2 is far smaller than the weights."""
    meta = artifact[1]
    params2 = [p.detach() + 0.01 for p in model.parameters()]
    model2 = build_model(_tiny(), device="cpu", backend="fused", seed=0)
    model2.load_state_dict(dict(zip(meta["param_names"], params2)))
    x = _x(2, 1)
    got = serving(params2, x)
    assert torch.equal(got, _live(model2, x))
    assert (got - _live(model, x)).abs().max() > 0
    assert torch.equal(serving(model2.state_dict(), x), got)
    weight_bytes = 4 * sum(p.numel() for p in model.parameters())
    assert max(meta["bytes"].values()) < 0.5 * weight_bytes


def test_export_tiled_nonsquare_canvas(model, tmp_path):
    """The tiled program (gather + forward + fold in one exported program)
    of a non-square canvas replays the live TiledRunner bit for bit."""
    runner = TiledRunner(model, kernel=64, stride=32)
    img = torch.from_numpy(np.random.default_rng(4).random((1, 70, 130, 3), np.float32))
    bucket = runner.bucket(70, 130)
    assert bucket[0] != bucket[1]
    out = str(tmp_path / "tiled")
    meta = tex.save_exported_tiled(out, model, [bucket], kernel=64, stride=32)
    assert meta["buckets"] == [list(bucket)]
    got = tex.TiledServingModel(out, device="cpu")(model, img)
    with torch.inference_mode():
        live = runner(img)
    assert got.shape == live.shape == (1, 70, 130, 1)
    assert torch.equal(got, live)


def test_export_graph_holds_the_ops_and_counts_launches(model, artifact, serving):
    """One sunet:: node per kernel call of the forward, every block op
    among them; running the reloaded program adds ``expected_launches`` to
    the CPU counts (the plain versions) and nothing to the kernels'."""
    x = _x(5, 2)
    want = model.expected_launches(tuple(x.shape))
    nodes = _op_nodes(os.path.join(artifact[0], tex.forward_file(2)))
    assert set(nodes) <= set(INFER_WRAPPERS)
    assert {k: nodes[k] * PER_CALL[k] for k in INFER_WRAPPERS} == want
    assert all(nodes[k] > 0 for k in INFER_WRAPPERS[:5]), nodes
    _build.reset_counts()
    serving(model, x)
    assert {k: _build.counter(k).cpu for k in want} == want
    assert not any(_build.counter(k).cuda for k in want)


def test_export_loads_without_the_model_code(model, artifact, tmp_path):
    """A serving process loads and runs the artifact with no module of
    sunet_tf_tpu_torch.models imported, on a checkpoint that ``ckpt.py``
    wrote."""
    src, meta = artifact
    out = tmp_path / "b1"
    out.mkdir()
    os.link(os.path.join(src, tex.forward_file(1)), out / tex.forward_file(1))
    (out / tex.META_NAME).write_text(json.dumps({**meta, "batches": [1]}))
    x = _x(6, 1)
    ckpt = save_checkpoint(str(tmp_path), "latest", model)
    torch.save((x, _live(model, x)), tmp_path / "io.pt")
    code = (
        "import sys, torch\n"
        "from sunet_tf_tpu_torch.infer.export import ServingModel\n"
        f"sm = ServingModel({str(out)!r}, device='cpu')\n"
        f"x, want = torch.load({str(tmp_path / 'io.pt')!r})\n"
        f"got = sm(torch.load({ckpt!r}), x)\n"
        "assert torch.equal(got, want), float((got - want).abs().max())\n"
        "bad = [k for k in sys.modules if k.startswith('sunet_tf_tpu_torch.models')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0 and run.stdout.strip() == "ok", run.stderr[-3000:]


def test_export_refuses_another_device(artifact, tmp_path):
    """An artifact whose meta says it was exported for the card does not
    load for the CPU (and one for the CPU not for the card)."""
    out, meta = artifact
    other = tmp_path / "other"
    other.mkdir()
    (other / tex.META_NAME).write_text(json.dumps({**meta, "device": "cuda"}))
    with pytest.raises(ValueError, match="exported for 'cuda'"):
        tex.ServingModel(str(other), device="cpu")
    with pytest.raises(ValueError, match="exported for 'cpu'"):
        tex.ServingModel(out, device="cuda")


def test_export_matches_jax(model, serving, jax_side):
    """The reloaded artifact against the JAX package's forward on the same
    weights and inputs."""
    gd, params, rest = jax_side
    x = np.random.default_rng(8).random((2, 64, 64, 3), np.float32)
    want = jax.jit(lambda s, x: nnx.merge(gd, s, rest)(x))(params, jnp.asarray(x))
    got = serving(model, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SLICE_TOL)


def test_export_cli_bands_split_head(tmp_path, capsys):
    """``python -m sunet_tf_tpu_torch.export --check --device cpu`` on a
    tiny 16-band config's YAML (the split x4 head, #10): the CLI exports
    bucket 1 and holds the reloaded artifact to the live model bit for bit;
    the graph holds the split head's op once."""
    raw = tconfig.config_to_dict(tconfig.tiny_config(in_chans=16, out_chans=16))
    raw["TPU"]["COMPUTE_DTYPE"] = "float32"
    cfg_path = tmp_path / "bands.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    out = tmp_path / "art"
    metas = export_cli.main(["--out", str(out), "--config", str(cfg_path), "--batches", "1",
                             "--check", "--device", "cpu"])
    assert metas["forward"]["device"] == "cpu" and metas["forward"]["in_chans"] == 16
    assert "bucket 1 reloaded vs live max|diff| = 0.00e+00" in capsys.readouterr().out
    nodes = _op_nodes(out / tex.forward_file(1))
    assert nodes["fused_dual_upsample4"] == 1 and "fused_dual_upsample4_conv_phase" not in nodes


def _op_cases():
    """Small CPU operands for each op (C=16, 2 heads, windows of 16 tokens)."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g) * 0.3
    C, ws, heads = 16, 4, 2
    x = r(2, 8, 8, C)
    blk = [1 + r(C), r(C), r(C, 3 * C), r(3 * C), r(C, C), r(C), 1 + r(C), r(C),
           r(C, 4 * C), r(4 * C), r(4 * C, C), r(C)]
    bias = r(heads, ws * ws, ws * ws)
    mask = torch.from_numpy(shift_attn_mask(8, 8, ws, 2))
    kw = dict(ws=ws, num_heads=heads, scale=8.0)
    xh = r(2, 4, 4, C)
    head = [r(C, 16 * C), torch.full((1,), 0.25), r(C, C), r(C), torch.full((1,), 0.2),
            r(C, C), r(C, C)]
    return {
        "fused_swin_block": ((x, *blk, bias, mask, None), dict(kw, shift=2)),
        "fused_swin_block_chain": ((x, blk + blk, [bias, bias], mask), dict(kw, shifts=[0, 2])),
        "fused_ln_window_attention": ((x, *blk[:6], bias, mask), kw),
        "fused_ln_mlp": ((x, *blk[6:]), {}),
        "fused_dual_upsample4_conv_phase": ((xh, *head, r(3, 3, C, 2)), {}),
        "fused_dual_upsample4": ((xh, *head), {}),
    }


@pytest.mark.parametrize("name", INFER_WRAPPERS)
def test_op_schema_and_fake_match_the_wrapper(name):
    """Each op: ``torch.library.opcheck``'s schema (no mutation, no
    aliasing) and fake-tensor checks, and its output equal to the direct
    implementation's on the same operands."""
    args, kwargs = _op_cases()[name]
    torch.library.opcheck(ops.op(name), args, kwargs,
                          test_utils=("test_schema", "test_faketensor"))
    got = ops.op(name)(*args, **kwargs)
    assert torch.equal(got, ops.IMPLS[name](*args, **kwargs))
