"""The port's data tier (``parallel/``, ``train/loop.py`` with a mesh) on two
gloo ranks on the CPU, held against the JAX package and against the port's
one-process paths.

The ranks start once for the file (``parallel.launch.run_ranks``, spawned,
killed at ``RANKS_TIMEOUT``) and run every check of ``tests/
torch_parallel_ranks.py::data_tier_rank``; the tests read their results:

- the two-process global mean (``tools/multihost_smoke.py``);
- one training step at data size 2 against JAX's ``build_steps(...,
  mesh=make_mesh(data=2))`` step jitted by ``jit_steps(mesh=...)`` on the XLA
  backend: a shrunk ``tiny_config()`` (two stages of two blocks, 32x32,
  float32, drop-path 0), the mask task without augmentation, SGD at rate 1
  on both sides, the same weights and batch, whose ranks hold 2 and 1 valid
  rows (the global loss's sum of weights, not a mean of per-rank losses);
  JAX's limits (``tests/test_spatial_pallas.py``): loss within 1e-5
  relative, parameters within 1e-4 * max(1, the largest update);
- the same step against the port's one-process step with augmentation on:
  a mask batch whose boundary weights give each rank its own sum of
  weights, and a denoise batch with a pad row (noise drawn for the global
  batch), parameters within 1e-5 * max(1, the largest update), the logged
  scalars within 1e-5 relative, the histograms equal; both ranks' parameters
  equal bit for bit;
- evaluation sums (a pad row masked) and histograms, tiled inference and
  ``TiledRunner.run_corpus`` with the tiles split over the ranks, against
  one process;
- ``python -m sunet_tf_tpu_torch.train`` in both ranks (the Trainer lays
  them out as data 2 x spatial 1): rank 0 alone writes, both end with the
  same parameters, and the validation metrics equal one process's within
  1e-4 relative.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import nnx

from sunet_tf_tpu import config as jconfig
from sunet_tf_tpu.models.sunet import build_model as jax_build_model
from sunet_tf_tpu.ops.metrics import init_histograms as jax_histograms
from sunet_tf_tpu.parallel.mesh import make_mesh as jax_mesh
from sunet_tf_tpu.parallel.mesh import shard_batch as jax_shard
from sunet_tf_tpu.train.loop import build_steps as jax_build_steps
from sunet_tf_tpu.train.loop import jit_steps
from sunet_tf_tpu_torch import config as tconfig
from sunet_tf_tpu_torch.data.synth import generate_dataset
from sunet_tf_tpu_torch.parallel.launch import start_ranks
from sunet_tf_tpu_torch.weights import PREFIX
from tools.export_torch_checkpoint import params_to_state_dict
from tools.import_torch_checkpoint import torch_to_params
from torch_parallel_ranks import build, data_tier_rank, one_process

RANKS_TIMEOUT = 180
pytestmark = pytest.mark.timeout(2 * RANKS_TIMEOUT)

SHRUNK = dict(img_size=32, depth_en=(2, 2), head_num=(2, 2), drop_path_rate=0.0)


def shrunk(cfg, **kw):
    sw = dataclasses.replace(cfg.swinunet, **{**SHRUNK, **kw})
    return cfg.replace(swinunet=sw)


def jax_cfg():
    cfg = shrunk(jconfig.tiny_config())
    return cfg.replace(tpu=cfg.tpu.__class__(compute_dtype="float32", attention_backend="xla"))


def port_raw(**kw) -> dict:
    return tconfig.config_to_dict(shrunk(tconfig.tiny_config(), **kw).replace(
        compute_dtype="float32"))


def mask_batch(rng, valid, size=32) -> dict:
    tar = (rng.random((4, size // 4, size // 4, 1)) > 0.55).astype(np.uint8) * 255
    tar = np.repeat(np.repeat(tar, 4, axis=1), 4, axis=2)
    return {"input": rng.integers(0, 256, (4, size, size, 3), dtype=np.uint8),
            "target": tar, "valid": np.asarray(valid, np.float32)}


def seeded_state(raw: dict) -> dict:
    """Reference-keyed weights: the port's seeded model of ``raw`` with
    every parameter moved by N(0, 0.05) noise (LayerNorms away from 1/0)."""
    model = build(raw, None)
    g = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for prm in model.parameters():
            prm.add_(torch.randn(prm.shape, generator=g) * 0.05)
    return {PREFIX + k: v.numpy().copy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(3)
    clean = rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    inp = {
        "tiny": port_raw(), "tiny3": port_raw(out_chans=3), "state_tiny3": None,
        "jax_batch": mask_batch(rng, [1, 1, 1, 0]),
        "mask_batch": mask_batch(rng, [1, 1, 1, 1]),
        "denoise_batch": {"input": clean, "target": clean,
                          "valid": np.asarray([1, 1, 1, 0], np.float32)},
        "eval_batch": mask_batch(rng, [1, 1, 1, 0]),
        "eval3_batch": {"input": rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8),
                        "target": clean, "valid": np.asarray([1, 1, 0, 0], np.float32)},
        # two images' 18 tiles, 9 a rank: the ranks' forwards hold the
        # one-process chunks' tiles; one image's 9 tiles: a zero pad tile
        "tiled_img": rng.random((2, 64, 64, 3), dtype=np.float32),
        "tiled_kw": dict(kernel=32, stride=16, tile_batch=9),
        "tiled_odd_img": rng.random((1, 48, 40, 3), dtype=np.float32),
        "tiled_odd_kw": dict(kernel=32, stride=16, tile_batch=4),
        "corpus": [rng.random((40, 56, 3), dtype=np.float32),
                   rng.random((33, 30, 3), dtype=np.float32)],
        "corpus_kw": dict(kernel=32, stride=16, tile_batch=8),
    }
    inp["state_tiny"] = seeded_state(inp["tiny"])
    inp["steps"] = {"step_jax": ("tiny", "jax_batch", "mask", False),
                    "step_mask": ("tiny", "mask_batch", "mask", True),
                    "step_denoise": ("tiny3", "denoise_batch", "denoise", True)}
    inp["evals"] = {"eval_mask": ("tiny", "eval_batch", "mask"),
                    "eval_denoise": ("tiny3", "eval3_batch", "denoise")}
    generate_dataset(str(tmp / "tr"), 5, size=32, seed=0)
    generate_dataset(str(tmp / "va"), 3, size=32, seed=1)
    raw = tconfig.config_to_dict(shrunk(tconfig.tiny_config()).replace(
        compute_dtype="float32", optim=tconfig.OptimConfig(batch=2, epochs=1)))
    argv = {}
    for who in ("one", "ranks"):
        raw["TRAINING"].update({"TRAIN_DIR": str(tmp / "tr"), "VAL_DIR": str(tmp / "va"),
                                "SAVE_DIR": str(tmp / f"ck_{who}"), "TRAIN_PS": 32,
                                "VAL_PS": 32})
        (tmp / f"{who}.yaml").write_text(yaml.safe_dump(raw))
        argv[who] = ["--config", str(tmp / f"{who}.yaml"), "--device", "cpu",
                     "--steps-per-epoch", "2"]
    inp["fit_argv"], inp["fit_argv_one"] = argv["ranks"], argv["one"]
    group = start_ranks(data_tier_rank, 2, args=(inp,), device="cpu", timeout_s=RANKS_TIMEOUT)
    try:     # while the ranks run
        jax_result = jax_step(inp)
        one = one_process(inp)
    finally:
        ranks = group.join()
    return {"inp": inp, "ranks": ranks, "jax": jax_result, "one": one, "tmp": tmp}


def jax_model(cfg, state: dict) -> tuple:
    """(graphdef, params) of JAX's model of ``cfg`` holding the
    reference-keyed ``state``: the model's structure from ``nnx.eval_shape``
    (its own initialisation never runs), filled by
    ``tools/import_torch_checkpoint.py::torch_to_params``."""
    abstract = nnx.eval_shape(lambda: jax_build_model(cfg, seed=0))
    gd, st = nnx.split(abstract)
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype)
                         if isinstance(a, jax.ShapeDtypeStruct) else a, st)
    model = nnx.merge(gd, zeros)
    params = torch_to_params(state, model)
    return nnx.split(model, nnx.Param)[0], jax.tree.map(jnp.asarray, params)


def jax_step(inp: dict) -> tuple:
    """JAX's data-tier step on ``inp``'s weights and unequal-valid batch:
    (parameters after, loss), reference-keyed without the prefix."""
    gd, params = jax_model(jax_cfg(), inp["state_tiny"])
    tx = optax.sgd(1.0)
    mesh = jax_mesh(data=2, devices=jax.devices()[:2])
    fns = jit_steps(jax_build_steps(jax_cfg(), gd, tx, task="mask", augment=False, mesh=mesh),
                    mesh=mesh, donate=False)
    p1, _, scalars, _ = fns.train_step(params, tx.init(params),
                                       jax_shard(mesh, inp["jax_batch"]), jax.random.key(5),
                                       jnp.uint32(0), jax_histograms(64))
    after = params_to_state_dict(nnx.merge(gd, p1))
    return {k.removeprefix(PREFIX): v for k, v in after.items()}, float(scalars["loss"])


def update_limit(before: dict, after: dict, rel: float) -> float:
    """rel * max(1, the largest |change| of any parameter)."""
    return rel * max(1.0, max(float(np.abs(after[k] - before[k]).max()) for k in after))


def test_multihost_global_mean(setup):
    assert [r["multihost"] for r in setup["ranks"]] == [1.5, 1.5]


def test_mesh_layout(setup):
    for rank, r in enumerate(setup["ranks"]):
        shape, d, s, data_peers, spatial_peers = r["mesh"]
        assert shape == {"data": 2, "spatial": 1} and (d, s) == (rank, 0)
        assert data_peers == [0, 1] and spatial_peers == [rank]


def test_data_tier_step_matches_jax_with_unequal_valid_rows(setup):
    want, jl = setup["jax"]
    before = {k.removeprefix(PREFIX): v for k, v in setup["inp"]["state_tiny"].items()}
    limit = update_limit(before, {k: want[k] for k in before}, 1e-4)
    for r in setup["ranks"]:
        got = r["step_jax"]
        assert abs(got["scalars"]["loss"] - jl) <= 1e-5 * max(1.0, abs(jl))
        assert set(got["params"]) <= set(want)
        worst = max((float(np.abs(got["params"][k] - want[k]).max()), k) for k in got["params"])
        assert worst[0] <= limit, (worst, limit)


@pytest.mark.parametrize("name", ["step_jax", "step_mask", "step_denoise"])
def test_data_tier_step_matches_one_process(setup, name):
    one = setup["one"][name]
    r0, r1 = (r[name] for r in setup["ranks"])
    for k in one["params"]:
        np.testing.assert_array_equal(r0["params"][k], r1["params"][k])
    limit = update_limit(one["before"], one["params"], 1e-5)
    for k, v in one["params"].items():
        assert float(np.abs(r0["params"][k] - v).max()) <= limit, k
    assert set(r0["scalars"]) == set(one["scalars"])
    for k, v in one["scalars"].items():
        assert abs(r0["scalars"][k] - v) <= 1e-5 * abs(v), (k, r0["scalars"][k], v)
        assert r0["scalars"][k] == r1["scalars"][k]
    for k, v in one["hists"].items():
        np.testing.assert_array_equal(r0["hists"][k], v)


@pytest.mark.parametrize("name", ["eval_mask", "eval_denoise"])
def test_sharded_eval_matches_one_process(setup, name):
    inp = setup["inp"]
    batch_key = inp["evals"][name][1]
    one = setup["one"][name]
    for r in setup["ranks"]:
        got = r[name]
        assert got["sums"]["n"] == one["sums"]["n"] == inp[batch_key]["valid"].sum()
        for k, v in one["sums"].items():
            assert abs(got["sums"][k] - v) <= 1e-6 * abs(v), (k, got["sums"][k], v)
        for k, v in one["hists"].items():
            np.testing.assert_array_equal(got["hists"][k], v)


@pytest.mark.parametrize("case", ["tiled", "tiled_odd"])
def test_tiled_inference_over_two_ranks_matches_one_process(setup, case):
    """Bit for bit where each rank's forwards run the tiles of one of the
    one-process chunks; with a pad tile the batches differ, and the CPU's
    plain versions (unlike the card's kernels, whose plans are per image)
    round a tile by its batch: float32 rounding alone, 1e-6."""
    inp = setup["inp"]
    img = inp[case + "_img"]
    one = setup["one"][case]
    assert one.shape == img.shape[:3] + (1,)
    for r in setup["ranks"]:
        if case == "tiled":
            np.testing.assert_array_equal(r[case], one)
        else:
            np.testing.assert_allclose(r[case], one, rtol=0, atol=1e-6)


def test_run_corpus_over_two_ranks_matches_one_process(setup):
    for r in setup["ranks"]:
        for got, want in zip(r["corpus"], setup["one"]["corpus"]):
            np.testing.assert_array_equal(got, want)


def test_train_cli_on_two_ranks(setup):
    r0, r1 = (r["fit"] for r in setup["ranks"])
    assert r0["mesh"] == r1["mesh"] == (2, 1) and not r0["runner"]
    for k, v in r0["params"].items():
        np.testing.assert_array_equal(v, r1["params"][k])
    models = setup["tmp"] / "ck_ranks" / "Denoising" / "models"
    assert sorted(os.listdir(models)) == ["best_auprc.pth", "best_auroc.pth", "latest.pth"]
    one = setup["one"]["fit"]
    assert one["mesh"] is None
    for m in ("auroc", "auprc"):
        a, b = r0["summary"]["best"][m]["value"], one["summary"]["best"][m]["value"]
        assert abs(a - b) <= 1e-4 * abs(b), (m, a, b)
