"""The port's float64 oracle and parity tools held against the JAX package.

On the CPU at the tiny config (64x64, C=16, depths 2, heads 2, ws 4),
weights drawn from a numpy seed into the JAX model and carried to the port
through params_to_state_dict, as tests/test_torch_port_model.py carries
them:
- ``tools/ssim_oracle.py`` and ``tools/fp64_oracle.np_psnr`` equal to the
  JAX repo's ``tools/ssim_oracle.py`` and ``tools/parity_run.py::np_psnr``
  within 1e-12;
- the float64 eager model (``fp64_oracle.oracle_model``) against JAX's XLA
  float32 forward within the slice tolerance (rtol 1e-3, atol 1e-4), every
  probe float64, and the float32 eager model within 1e-5 of the oracle;
- ``fused_swin_block_reference`` on float64 copies against the eager
  ``SwinBlock`` in float64 within 1e-10;
- ``obs.attention_logit_stats`` against JAX's within 1e-4 relative;
- ``tools/parity_run.py``'s functions for 2 steps on a 6-image synthetic
  corpus, then ``fp64_oracle`` and ``bisect_fp64`` on its checkpoint;
- ``tools/bisect_probes.py``: the oracle against itself reads 0 at every
  probe, and a weight perturbed in encoder stage k is reported first there;
- chip_smoke's C2 statistics on synthetic readings: sound noise passes, one
  tensor scaled by 1.01 reads a scale z above ``C2_SCALE_Z``.
"""

import copy
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sunet_tf_tpu import config as jconfig
from sunet_tf_tpu.models.sunet import build_model as jax_build_model
from sunet_tf_tpu.obs import attention_logit_stats as jax_logit_stats
from sunet_tf_tpu_torch import config as tconfig
from sunet_tf_tpu_torch.kernels import window_attention as wa
from sunet_tf_tpu_torch.models.layers import SwinBlock, torch_default_init_
from sunet_tf_tpu_torch.models.sunet import build_model, probe_names
from sunet_tf_tpu_torch.obs import attention_logit_stats
from sunet_tf_tpu_torch.tools import bisect_fp64, bisect_probes, fp64_oracle, parity_run
from sunet_tf_tpu_torch.tools.ssim_oracle import ssim_oracle
from sunet_tf_tpu_torch.weights import load_reference_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from tools.export_torch_checkpoint import params_to_state_dict  # noqa: E402
from tools.parity_run import np_psnr as jax_np_psnr  # noqa: E402
from tools.ssim_oracle import ssim_oracle as jax_ssim_oracle  # noqa: E402

SLICE_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models' ops in one thread: under the suite's parallel
    workers, torch's default of one thread per core makes each small op
    wait on the others' threads many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_tiny():
    """The tiny JAX SUNet (XLA route, float32): its structure from
    ``nnx.eval_shape`` (its own initialisation never runs), every parameter
    drawn from a numpy seed, N(0, 0.05) about 0 (LayerNorm scales about 1),
    so that no value sits at an init value: (graphdef, params)."""
    cfg = jconfig.tiny_config()
    cfg = cfg.replace(tpu=cfg.tpu.__class__(compute_dtype="float32",
                                            attention_backend="xla"))
    abstract = nnx.eval_shape(lambda: jax_build_model(cfg, seed=3))
    gd, state = nnx.split(abstract)
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype)
                         if isinstance(a, jax.ShapeDtypeStruct) else a, state)
    gd, params = nnx.split(nnx.merge(gd, zeros), nnx.Param)
    rng = np.random.default_rng(11)
    draw = lambda path, leaf: jnp.asarray(
        (1.0 if "scale" in jax.tree_util.keystr(path) else 0.0)
        + rng.normal(0, 0.05, leaf.shape).astype(np.float32))
    return gd, jax.tree_util.tree_map_with_path(draw, params)


@pytest.fixture(scope="module")
def port_tiny(jax_tiny):
    """The port's tiny model (fused route, bf16) with the JAX weights."""
    gd, params = jax_tiny
    model = build_model(tconfig.tiny_config(), device="cpu", backend="fused")
    return load_reference_state_dict(model, params_to_state_dict(nnx.merge(gd, params)))


def test_ssim_and_psnr_oracles_equal_the_jax_repos():
    rng = np.random.default_rng(0)
    t = rng.random((3, 48, 40, 3))
    p = np.clip(t + 0.1 * rng.standard_normal(t.shape), -0.2, 1.2)
    np.testing.assert_allclose(ssim_oracle(t, np.clip(p, 0, 1)),
                               jax_ssim_oracle(t, np.clip(p, 0, 1)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ssim_oracle(t[..., 0], p[..., 0]),
                               jax_ssim_oracle(t[..., 0], p[..., 0]), rtol=0, atol=1e-12)
    np.testing.assert_allclose(fp64_oracle.np_psnr(t, p), jax_np_psnr(t, p), rtol=0,
                               atol=1e-12)


def test_fp64_oracle_matches_jax_xla_and_float32_eager(jax_tiny, port_tiny):
    gd, params = jax_tiny
    x = np.random.default_rng(21).random((2, 64, 64, 3), np.float32)
    want = np.asarray(jax.jit(lambda s, x: nnx.merge(gd, s)(x))(params, jnp.asarray(x)))
    oracle = fp64_oracle.oracle_model(port_tiny)
    assert all(p.dtype == torch.float64 for p in oracle.parameters())
    taps = bisect_probes.probes(oracle, torch.from_numpy(x))
    assert list(taps) == list(probe_names(4))
    assert {str(t.dtype) for t in taps.values()} == {"torch.float64"}
    got = taps["output"].numpy()
    assert got.shape == (2, 64, 64, 1)
    np.testing.assert_allclose(got, want, **SLICE_TOL)
    f32 = parity_run.route_outputs(port_tiny, x, "cpu", with_oracle=False)["eager_float32"]
    np.testing.assert_allclose(f32, got, rtol=0, atol=1e-5)


@pytest.mark.parametrize("H,C,heads,ws,shift", [(8, 16, 2, 4, 2), (32, 60, 2, 16, 8)])
def test_block_reference_in_float64_equals_the_eager_block(H, C, heads, ws, shift):
    blk = SwinBlock(C, (H, H), heads, window_size=ws, shift_size=shift)
    torch_default_init_(blk, torch.Generator().manual_seed(H + C))
    rng = np.random.default_rng(C)
    with torch.no_grad():
        for p in blk.parameters():   # off the init values, rel-pos bias too
            p.add_(torch.from_numpy(rng.normal(0, 0.05, p.shape)).float())
    blk = blk.double()
    x = torch.from_numpy(rng.standard_normal((1, H, H, C)))
    a, m = blk.attn, blk.mlp
    mask = blk.mask(H, H, "cpu")
    with torch.no_grad():
        want = blk(x)
        got = wa.fused_swin_block_reference(
            x, (blk.norm1.weight, blk.norm1.bias), a.qkv.weight.t(), a.qkv.bias,
            a.proj.weight.t(), a.proj.bias, (blk.norm2.weight, blk.norm2.bias),
            m.fc1.weight.t(), m.fc1.bias, m.fc2.weight.t(), m.fc2.bias, a.bias_matrix(),
            None if mask is None else mask.double(), ws=ws, num_heads=heads,
            scale=a.scale, shift=shift)
    assert want.dtype == got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-10)


def test_attention_logit_stats_match_jax(jax_tiny, port_tiny):
    gd, params = jax_tiny
    x = np.random.default_rng(4).random((2, 64, 64, 3), np.float32)
    want = jax_logit_stats(nnx.merge(gd, params), jnp.asarray(x))
    got = attention_logit_stats(port_tiny, x)
    for k in ("logit_max", "logit_min"):
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    # the opt-in is off again
    from sunet_tf_tpu_torch.models import layers

    assert not layers.LOGIT_STATS.enabled and layers.LOGIT_STATS.hi is None


def test_parity_run_oracle_and_bisect_on_the_cpu(tmp_path):
    out = str(tmp_path / "run")
    tdir, vdir = parity_run.make_data(os.path.join(out, "data"), 4, 2, 64)
    cfg = parity_run.build_cfg(tconfig.tiny_config(), tdir, vdir, out, batch=2, epochs=1,
                               steps_per_epoch=2, val_every=1)
    recipe = {"batch": 2, "epochs": 1, "steps_per_epoch": 2, "val_every": 1, "tiny": True}
    res = parity_run.run(cfg, "cpu", recipe=recipe)
    with open(os.path.join(out, "RESULTS.json")) as f:
        assert json.load(f) == json.loads(json.dumps(res))
    routes = [name for name, _, _ in parity_run.ROUTES]
    for key in ("recipe", "training", "val_fused", "val_eager", "fused_vs_eager_mean_abs",
                "attn_logits", "per_image_psnr", "psnr_mean", "per_image_ssim", "ssim_mean",
                "psnr_gap_db", "ssim_gap_vs_oracle", "mean_abs_vs_oracle",
                "per_image_delta_vs_oracle_db", *parity_run.GATES):
        assert key in res, key
    assert res["training"]["steps"] == 2 and np.all(np.isfinite(res["training"]["train_loss"]))
    assert set(res["per_image_psnr"]) == {"noisy", "fp64_oracle", *routes}
    assert all(len(v) == 2 for v in res["per_image_ssim"].values())
    assert all(res[g] for g in parity_run.GATES), {g: res[g] for g in parity_run.GATES}
    assert res["fused_vs_eager_mean_abs"] <= 5e-3
    assert res["mean_abs_vs_oracle"]["eager_float32"] < 1e-5

    section = fp64_oracle.main(["--out", out, "--cpu", "--n-worst", "1"])
    assert set(section["psnr"]) == {"fp64_oracle", *routes}
    assert "fused_closer_or_equal_to_exact" in section
    bis = bisect_fp64.main(["--out", out, "--cpu", "--n-worst", "1"])
    rep = bis["probes"]
    assert set(rep["oracle_dtypes"].values()) == {"torch.float64"}
    assert max(rep["oracle_cpu_rl2"].values()) == 0.0
    assert all(bis["stem"][f"eager_float32, {form} stem"]["mean_abs_vs_fp64"] < 1e-5
               for form in ("folded", "unfolded"))
    with open(os.path.join(out, "RESULTS.json")) as f:
        saved = json.load(f)
    assert "fp64_oracle" in saved and "bisect_fp64" in saved


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_bisect_probes_reads_zero_on_itself_and_finds_a_perturbed_stage(port_tiny, stage):
    oracle = fp64_oracle.oracle_model(port_tiny)
    x = torch.from_numpy(np.random.default_rng(stage).random((1, 64, 64, 3)))
    ref = bisect_probes.probes(oracle, x)
    same = bisect_probes.probe_distances(bisect_probes.probes(oracle, x), ref)
    assert set(same.values()) == {0.0}
    bad = copy.deepcopy(oracle)
    with torch.no_grad():
        bad.layers[stage].blocks[-1].attn.qkv.weight.mul_(1.001)
    dist = bisect_probes.probe_distances(bisect_probes.probes(bad, x), ref)
    assert bisect_probes.first_divergence(dist, same) == f"enc{stage}"


def test_c2_gate_reads_a_scaled_gradient_and_passes_noise():
    """chip_smoke's C2 aggregates on synthetic readings: two routes with
    independent noise of rl2 5e-3 about the same exact gradients read
    geometric-mean ratios near 1 and a scale z far under C2_SCALE_Z; one
    tensor of the route scaled by 1.01 leaves the geometric means where
    they were and reads z near 2."""
    import chip_smoke as cs

    rng = np.random.default_rng(7)
    exact = {f"layers_up.3.blocks.{b}.attn.qkv.weight": rng.standard_normal(1024)
             for b in range(100)}   # a stage's ~100 tensors

    def readings(scaled=None, seed=0):
        r = np.random.default_rng(seed)
        out = []
        for _ in range(3):
            draw = {}
            for n, v in exact.items():
                g = v + 5e-3 * np.linalg.norm(v) / 32 * r.standard_normal(v.size)
                g = g * (1.01 if n == scaled else 1.0)
                draw[n] = (g @ g, v @ v, (g - v) @ (g - v), g @ v, v.size)
            out.append(draw)
        return out

    plain, route = readings(seed=1), readings(seed=2)
    mutant = readings("layers_up.3.blocks.0.attn.qkv.weight", seed=2)
    a, p, m = (cs.c2_aggregate(x)["layers_up.3"] for x in (route, plain, mutant))
    assert 0.8 < a[0] / p[0] < 1.25 and 0.9 < a[1] / p[1] < 1.1
    assert m[1] / a[1] < 1.2   # the geometric mean barely moves
    z_sound = cs.c2_scale_z(route, plain)["layers_up.3"][0]
    z_mut, name = cs.c2_scale_z(mutant, plain)["layers_up.3"]
    assert z_sound < 0.3 * cs.C2_SCALE_Z
    assert z_mut > 1.5 * cs.C2_SCALE_Z and name == "layers_up.3.blocks.0.attn.qkv.weight"
    omc, rl2 = cs.c2_distances(route[0]["layers_up.3.blocks.1.attn.qkv.weight"])
    assert rl2 == pytest.approx(5e-3, rel=0.1) and omc == pytest.approx(rl2 ** 2 / 2, rel=0.2)
