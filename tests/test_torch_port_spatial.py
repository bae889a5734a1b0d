"""The port's spatial tier (``parallel/spatial.py``) on two gloo ranks on the
CPU (a (data 1, spatial 2) mesh), held against the JAX package's on a
(1, 2) CPU device mesh and against the port's one-process paths.

The ranks start once for the file (``parallel.launch.run_ranks``, spawned,
killed at ``RANKS_TIMEOUT``) and run every check of ``tests/
torch_parallel_ranks.py::spatial_rank``; the tests read their results:

- the exchanges: ``halo_exchange_rows`` at halos 1 and 3 in both modes,
  ``spatial_roll_h`` at +-shift and ``spatial_conv3x3`` against JAX's under
  ``shard_map`` (the halo and the roll bit for bit, the convolution within
  1e-5 as JAX's own test), and their gradients against autograd of the
  unsharded op (bit for bit but where a border row sums several of its
  halo copies, there within float32 rounding, 1e-6 relative);
- one stage (the shrunk model's first: C=16, 8x8, window 4, a W and an SW
  block; a window row a rank) through the port's ``SpatialStageRunner`` against JAX's
  ``PallasSpatialStageRunner`` (Pallas in interpret mode): the inference
  form, and the training form's output and gradients (input, and every
  block weight summed over the spatial group) within 1e-5 of the largest
  value; the eager stage against JAX's ``run_swin_blocks_spatial``;
- the whole shrunk model: its forward, and one training step (SGD at rate
  1), at spatial 2 against the port's one-process forward and step (held
  against JAX by the port's step tests): forward within 1e-5, parameters
  within 1e-5 * max(1, the largest update), both ranks' parameters equal;
- ``python -m sunet_tf_tpu_torch.train`` with ``TPU.SPATIAL: 2`` in both ranks;
- the runner's decisions (``applies``) against JAX's for ``Config()``'s and
  ``scaled_config()``'s stages at spatial 2 (no model runs).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx
from jax import shard_map
from jax.sharding import PartitionSpec as P

from sunet_tf_tpu import config as jconfig
from sunet_tf_tpu.parallel import spatial as jsp
from sunet_tf_tpu.parallel.mesh import make_mesh as jax_mesh
from sunet_tf_tpu_torch import config as tconfig
from sunet_tf_tpu_torch.data.synth import generate_dataset
from sunet_tf_tpu_torch.models.sunet import build_model
from sunet_tf_tpu_torch.parallel.launch import start_ranks
from sunet_tf_tpu_torch.parallel.mesh import Mesh
from sunet_tf_tpu_torch.parallel.spatial import SpatialStageRunner
from sunet_tf_tpu_torch.weights import PREFIX
from test_torch_port_parallel import jax_model, seeded_state
from tools.export_torch_checkpoint import params_to_state_dict
from torch_parallel_ranks import build, fit, sgd_step, spatial_rank

RANKS_TIMEOUT = 180
pytestmark = pytest.mark.timeout(2 * RANKS_TIMEOUT)

HALOS = [(1, "edge"), (3, "edge"), (1, "zero"), (3, "zero")]
SHIFTS = [-3, 3, 2]
STAGE_TOL = 1e-5


# tiny_config() shrunk to two stages of a W and an SW block, 32x32
SMALL = dict(img_size=32, depth_en=(2, 2), head_num=(2, 2), drop_path_rate=0.0)


def jax_small():
    cfg = jconfig.tiny_config()
    cfg = cfg.replace(swinunet=dataclasses.replace(cfg.swinunet, **SMALL))
    return cfg.replace(tpu=cfg.tpu.__class__(compute_dtype="float32",
                                             attention_backend="pallas"))


def port_raw() -> dict:
    cfg = tconfig.tiny_config()
    cfg = cfg.replace(swinunet=dataclasses.replace(cfg.swinunet, **SMALL))
    return tconfig.config_to_dict(cfg.replace(compute_dtype="float32"))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial")
    rng = np.random.default_rng(5)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    inp = {
        "halo_x": f32(16, 8, 3), "halos": HALOS,
        "halo_g": {h: [f32(8 + 2 * h[0], 8, 3) for _ in range(2)] for h in HALOS},
        "roll_x": f32(2, 16, 4, 3), "shifts": SHIFTS,
        "roll_g": {s: [f32(2, 8, 4, 3) for _ in range(2)] for s in SHIFTS},
        "conv_x": f32(2, 16, 8, 3), "conv_k": f32(3, 3, 3, 5) * 0.1, "conv_b": f32(5) * 0.1,
        "conv_g": [f32(2, 8, 8, 5) for _ in range(2)],
        "tiny": port_raw(), "stage_x": f32(2, 8, 8, 16), "stage_g": f32(2, 8, 8, 16),
        "small": port_raw(), "state_small": None,
        "model_x": rng.random((2, 32, 32, 3), dtype=np.float32),
    }
    inp["state_tiny"] = seeded_state(inp["tiny"])
    tar = (rng.random((2, 8, 8, 1)) > 0.5).astype(np.uint8) * 255
    inp["model_batch"] = {"input": rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8),
                          "target": np.repeat(np.repeat(tar, 4, axis=1), 4, axis=2),
                          "valid": np.ones(2, np.float32)}
    generate_dataset(str(tmp / "tr"), 4, size=32, seed=0)
    generate_dataset(str(tmp / "va"), 2, size=32, seed=1)
    cfg = tconfig.config_from_dict(port_raw()).replace(
        optim=tconfig.OptimConfig(batch=2, epochs=1))
    argv = {}
    for who, sp in (("one", 1), ("ranks", 2)):
        raw = tconfig.config_to_dict(cfg.replace(spatial=sp))
        raw["TRAINING"].update({"TRAIN_DIR": str(tmp / "tr"), "VAL_DIR": str(tmp / "va"),
                                "SAVE_DIR": str(tmp / f"ck_{who}"), "TRAIN_PS": 32,
                                "VAL_PS": 32})
        (tmp / f"{who}.yaml").write_text(yaml.safe_dump(raw))
        argv[who] = ["--config", str(tmp / f"{who}.yaml"), "--device", "cpu",
                     "--steps-per-epoch", "2"]
    inp["fit_argv"] = argv["ranks"]
    group = start_ranks(spatial_rank, 2, args=(inp,), device="cpu", timeout_s=RANKS_TIMEOUT)
    try:     # while the ranks run
        want = jax_side(inp)
        one = one_process(inp, argv["one"])
    finally:
        ranks = group.join()
    return {"inp": inp, "ranks": ranks, "jax": want, "one": one}


def one_process(inp: dict, argv: list) -> dict:
    """The port's one-process forward, training step and fit that the
    ranks' are held against."""
    model = build(inp["small"], None).eval()
    with torch.no_grad():
        fwd = model(torch.from_numpy(inp["model_x"])).numpy()
    return {"model_fwd": fwd, "model_step": sgd_step(inp["small"], None, inp["model_batch"],
                                                     "mask", True), "fit": fit(argv)}


def jax_side(inp: dict) -> dict:
    """Every JAX result the tests compare with, on a (data 1, spatial 2)
    mesh of two CPU devices: the exchanges in one jitted program, the
    stage's three forms in another."""
    mesh = jax_mesh(data=1, spatial=2, devices=jax.devices()[:2])

    def sharded(fn, spec):
        return shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec)

    def exchanges(hx, rx, cx, k, b):
        halos = [sharded(lambda xl, h=h, m=m: jsp.halo_exchange_rows(xl, "spatial", h, mode=m),
                         P("spatial"))(hx) for h, m in HALOS]
        rolls = [sharded(lambda xl, s=s: jsp.spatial_roll_h(xl, s, "spatial"),
                         P(None, "spatial"))(rx) for s in SHIFTS]
        return halos, rolls, jsp.spatial_conv3x3(mesh, k, b)(cx, k, b)

    with mesh:
        halos, rolls, conv = jax.jit(exchanges)(*(jnp.asarray(inp[k]) for k in (
            "halo_x", "roll_x", "conv_x", "conv_k", "conv_b")))
    out = {("halo", h, m): np.asarray(y) for (h, m), y in zip(HALOS, halos)}
    out.update({("roll", s): np.asarray(y) for s, y in zip(SHIFTS, rolls)})
    out["conv"] = np.asarray(conv)

    gd, params = jax_model(jax_small(), inp["state_tiny"])
    runner = jsp.PallasSpatialStageRunner(mesh)

    @jax.jit
    def stage(p, x, g):
        blocks = lambda p: nnx.merge(gd, p).layers[0].blocks
        y, vjp = jax.vjp(lambda p, x: runner(blocks(p), x, jax.random.key(0)), p, x)
        return (runner(blocks(p), x, None), y, *vjp(g),
                jsp.run_swin_blocks_spatial(mesh, list(blocks(p)), x))

    y_inf, y, dp, dx, y_eager = stage(params, jnp.asarray(inp["stage_x"]),
                                      jnp.asarray(inp["stage_g"]))
    out["stage_infer"], out["stage_eager"] = np.asarray(y_inf), np.asarray(y_eager)
    out["stage_train"] = (np.asarray(y), np.asarray(dx),
                          params_to_state_dict(nnx.merge(gd, dp)))
    return out


@pytest.mark.parametrize("halo,mode", HALOS)
def test_halo_exchange_matches_jax_and_its_gradient_autograd(setup, halo, mode):
    inp = setup["inp"]
    got = [r[("halo", halo, mode)] for r in setup["ranks"]]
    np.testing.assert_array_equal(np.concatenate([g[0] for g in got]),
                                  setup["jax"][("halo", halo, mode)])
    # autograd of the unsharded op: each shard's rows of the padded map
    x = torch.from_numpy(inp["halo_x"]).requires_grad_(True)
    idx = torch.arange(-halo, 16 + halo)
    padded = (x[idx.clamp(0, 15)] if mode == "edge" else
              torch.cat([x.new_zeros(halo, 8, 3), x, x.new_zeros(halo, 8, 3)]))
    loss = sum((padded[r * 8:r * 8 + 8 + 2 * halo] * torch.from_numpy(inp["halo_g"][
        (halo, mode)][r])).sum() for r in range(2))
    loss.backward()
    dx = np.concatenate([g[1] for g in got])
    if mode == "edge" and halo > 1:
        np.testing.assert_allclose(dx, x.grad.numpy(), rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(dx, x.grad.numpy())


@pytest.mark.parametrize("shift", SHIFTS)
def test_roll_matches_jax_and_its_gradient_autograd(setup, shift):
    inp = setup["inp"]
    got = [r[("roll", shift)] for r in setup["ranks"]]
    np.testing.assert_array_equal(np.concatenate([g[0] for g in got], axis=1),
                                  setup["jax"][("roll", shift)])
    x = torch.from_numpy(inp["roll_x"]).requires_grad_(True)
    g = torch.from_numpy(np.concatenate(inp["roll_g"][shift], axis=1))
    (torch.roll(x, shift, dims=1) * g).sum().backward()
    np.testing.assert_array_equal(np.concatenate([g[1] for g in got], axis=1),
                                  x.grad.numpy())


def test_conv3x3_matches_jax_and_its_gradient_autograd(setup):
    inp = setup["inp"]
    got = [r["conv"] for r in setup["ranks"]]
    np.testing.assert_allclose(np.concatenate([g[0] for g in got], axis=1),
                               setup["jax"]["conv"], rtol=1e-5, atol=1e-5)
    x = torch.from_numpy(inp["conv_x"]).requires_grad_(True)
    kt = torch.from_numpy(inp["conv_k"]).requires_grad_(True)
    y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), kt.permute(3, 2, 0, 1),
                                   torch.from_numpy(inp["conv_b"]), padding=1)
    (y.permute(0, 2, 3, 1) * torch.from_numpy(np.concatenate(inp["conv_g"], axis=1))).sum(
    ).backward()
    np.testing.assert_allclose(np.concatenate([g[1] for g in got], axis=1), x.grad.numpy(),
                               rtol=1e-5, atol=1e-6)
    for r in got:
        np.testing.assert_allclose(r[2], kt.grad.numpy(), rtol=1e-5, atol=1e-5)


def _close(got, want, what):
    err = float(np.abs(got - want).max())
    assert err <= STAGE_TOL * max(1.0, float(np.abs(want).max())), (what, err)


def test_stage_runner_matches_jax_pallas_runner(setup):
    y, dx, grads = setup["jax"]["stage_train"]
    for r in setup["ranks"]:
        _close(r["stage_infer"], setup["jax"]["stage_infer"], "inference")
        out, gx, gw = r["stage_train"]
        _close(out, y, "train forward")
        _close(gx, dx, "dx")
        assert len(gw) == 2 * 13     # every parameter of the stage's two blocks
        for name, g in gw.items():
            _close(g, grads[PREFIX + name], name)


def test_eager_stage_matches_jax(setup):
    for r in setup["ranks"]:
        _close(r["stage_eager"], setup["jax"]["stage_eager"], "eager stage")


def test_whole_model_forward_and_step_match_one_process(setup):
    one = setup["one"]
    for r in setup["ranks"]:
        _close(r["model_fwd"], one["model_fwd"], "model forward")
    one = one["model_step"]
    limit = 1e-5 * max(1.0, max(float(np.abs(one["params"][k] - one["before"][k]).max())
                                for k in one["before"]))
    r0, r1 = (r["model_step"] for r in setup["ranks"])
    # the runner took the 8x8 stages, encoder and decoder: 2 x 2 blocks
    assert r0["partial"] == r1["partial"] == 2 * 2 * 13
    for k, v in one["params"].items():
        np.testing.assert_array_equal(r0["params"][k], r1["params"][k])
        assert float(np.abs(r0["params"][k] - v).max()) <= limit, k
    for k, v in one["scalars"].items():
        assert abs(r0["scalars"][k] - v) <= 1e-5 * abs(v), k


def test_train_cli_with_spatial_two(setup):
    r0, r1 = (r["fit"] for r in setup["ranks"])
    assert r0["mesh"] == r1["mesh"] == (1, 2) and r0["runner"]
    for k, v in r0["params"].items():
        np.testing.assert_array_equal(v, r1["params"][k])
    one = setup["one"]["fit"]
    assert one["mesh"] is None
    for m in ("auroc", "auprc"):
        a, b = r0["summary"]["best"][m]["value"], one["summary"]["best"][m]["value"]
        assert abs(a - b) <= 1e-4 * abs(b), (m, a, b)


# The stages at each model's own size: (encoder stages..., decoder stages...),
# True where the runner takes the stage (JAX's decisions, which the port's
# must equal): the 8x8 C=768 stage of Config() has 8 % (2 * 8) rows, the
# scaled C=720 stage is above the inference cap (384), within the train cap
# (768), and its 16x16 C=1440 stage has 16 % (2 * 16) rows.
APPLIES = {
    ("default", False): [True, True, True, False, True, True, True],
    ("default", True): [True, True, True, False, True, True, True],
    ("scaled", False): [True, True, False, False, False, True, True],
    ("scaled", True): [True, True, True, False, True, True, True],
}


@pytest.mark.parametrize("which,train", list(APPLIES))
def test_runner_applies_as_jax(which, train):
    tcfg = tconfig.Config() if which == "default" else tconfig.scaled_config()
    model = build_model(tcfg, device="meta")
    port = SpatialStageRunner(Mesh(1, 2, 0, None))
    jrunner = jsp.PallasSpatialStageRunner(jax_mesh(data=1, spatial=2,
                                                    devices=jax.devices()[:2]))
    n = tcfg.swinunet.num_stages
    res = tcfg.swinunet.img_size // tcfg.swinunet.patch_size
    stages = [(s, i) for i, s in enumerate(model.layers)]
    stages += [(s, n - 1 - j) for j, s in enumerate(model.layers_up[1:], 1)]
    got, want = [], []
    for stage, level in stages:
        blocks = list(stage.blocks)
        shape = (2, res >> level, res >> level, blocks[0].dim)
        got.append(port.applies(blocks, shape, train))
        stand_ins = [types.SimpleNamespace(window_size=b.window_size, shift_size=b.shift_size,
                                           ablate=(), _can_fuse=True) for b in blocks]
        want.append(jrunner.applies(stand_ins, shape, train))
    assert got == want == APPLIES[(which, train)]
