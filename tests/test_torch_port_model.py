"""The PyTorch port (sunet_tf_tpu_torch) held against the JAX package.

All on the CPU at the tiny config (64x64, C=16, depths 2, heads 2, ws 4),
float32, inputs from numpy seeds handed to both sides, weights carried
from the JAX model through tools/export_torch_checkpoint.py's
params_to_state_dict into the port's load_reference_state_dict. The JAX
side runs as its own tests run it (Pallas kernels in interpret mode).
Slice tolerance rtol=1e-3, atol=1e-4 (tests/test_pallas.py's full-model
parity tolerance).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx
from PIL import Image

from sunet_tf_tpu import config as jconfig
from sunet_tf_tpu.models.sunet import build_model as jax_build_model
from sunet_tf_tpu.models.sunet import param_count as jax_param_count
from sunet_tf_tpu.ops import window as jwin
from sunet_tf_tpu_torch import config as tconfig
from sunet_tf_tpu_torch.infer.tiled import reflect_pad_nhwc
from sunet_tf_tpu_torch.kernels import _build
from sunet_tf_tpu_torch.models import layers as tlayers
from sunet_tf_tpu_torch.models.sunet import build_model, param_count
from sunet_tf_tpu_torch.ops import window as twin
from sunet_tf_tpu_torch.weights import load_reference_state_dict
from tools.export_torch_checkpoint import params_to_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE_TOL = dict(rtol=1e-3, atol=1e-4)
WRAPPERS = ("fused_swin_block", "fused_swin_block_chain",
            "fused_ln_window_attention", "fused_ln_mlp",
            "fused_dual_upsample4_conv_phase")


def _jax_cfg(backend):
    cfg = jconfig.tiny_config()
    return cfg.replace(tpu=cfg.tpu.__class__(compute_dtype="float32",
                                             attention_backend=backend))


@pytest.fixture(scope="module")
def jax_tiny():
    return jax_build_model(_jax_cfg("xla"), seed=3)


@pytest.fixture(scope="module")
def jax_params(jax_tiny):
    """Tiny JAX SUNet parameters, every leaf perturbed from a numpy seed so
    that LN scales, biases and PReLU slopes are not at their init values."""
    gd, state = nnx.split(jax_tiny, nnx.Param)
    leaves, treedef = jax.tree.flatten(state)
    rng = np.random.default_rng(11)
    leaves = [jnp.asarray(np.asarray(l) + rng.normal(0, 0.05, l.shape).astype(np.float32))
              for l in leaves]
    return jax.tree.unflatten(treedef, leaves)


def _jax_model(backend, params, jax_tiny):
    model = jax_tiny if backend == "xla" else jax_build_model(_jax_cfg(backend), seed=3)
    gd, _ = nnx.split(model, nnx.Param)
    return gd, nnx.merge(gd, params)


def _port_model(backend, jmodel):
    cfg = tconfig.tiny_config().replace(compute_dtype="float32")
    model = build_model(cfg, device="cpu", backend=backend, seed=0)
    return load_reference_state_dict(model, params_to_state_dict(jmodel))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sunet_tf_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'sunet_tf_tpu.')) or k == 'sunet_tf_tpu')\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules if k.startswith('sunet_tf_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[1]) >= 10


@pytest.mark.parametrize("make", ["default", "tiny"])
def test_config_and_yaml_round_trip_match_jax(make, tmp_path):
    jcfg = getattr(jconfig, "Config" if make == "default" else "tiny_config")()
    tcfg = getattr(tconfig, "Config" if make == "default" else "tiny_config")()

    def same(j, t):
        for sect in ("swinunet", "optim", "training"):
            for f, v in vars(getattr(j, sect)).items():
                assert getattr(getattr(t, sect), f) == v, (sect, f)
        assert (t.compute_dtype, t.mode, t.verbose) == (
            j.tpu.compute_dtype, j.mode, j.verbose)

    same(jcfg, tcfg)
    # JAX-written YAML (with its TPU-only keys) into the port, and back
    path = tmp_path / "training.yaml"
    raw = jconfig.config_to_dict(jcfg)
    raw["SWINUNET"]["EMB_DIM"] = 48
    raw["TPU"]["COMPUTE_DTYPE"] = "float32"
    path.write_text(yaml.safe_dump(raw))
    j2, t2 = jconfig.load_config(str(path)), tconfig.load_config(str(path))
    same(j2, t2)
    assert t2.swinunet.emb_dim == 48 and t2.compute_dtype == "float32"
    same(jconfig.config_from_dict(tconfig.config_to_dict(t2)), t2)


@pytest.mark.parametrize("H,W,ws,shift", [(8, 8, 4, 2), (16, 24, 4, 2),
                                          (16, 16, 8, 4), (8, 8, 8, 0)])
def test_window_ops_exact(H, W, ws, shift):
    np.testing.assert_array_equal(twin.shift_attn_mask(H, W, ws, shift),
                                  jwin.shift_attn_mask(H, W, ws, shift))
    np.testing.assert_array_equal(twin.relative_position_index(ws, ws),
                                  jwin.relative_position_index(ws, ws))
    assert twin.effective_window((H, W), ws, shift) == jwin.effective_window(
        (H, W), ws, shift)
    x = np.random.default_rng(H + W).standard_normal((2, H, W, 3)).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    parts = twin.window_partition(tx, ws)
    np.testing.assert_array_equal(parts.numpy(), np.asarray(jwin.window_partition(jx, ws)))
    assert torch.equal(twin.window_reverse(parts, ws, H, W), tx)
    np.testing.assert_array_equal(twin.roll2d(tx, -shift).numpy(),
                                  np.asarray(jwin.roll2d(jx, -shift)))


def test_param_counts(jax_tiny):
    model = build_model(tconfig.Config(), device="meta")
    assert param_count(model) == 99_681_993
    tiny = build_model(tconfig.tiny_config(), device="meta")
    assert param_count(tiny) == jax_param_count(jax_tiny)


@pytest.mark.parametrize("chans", [3, 1])
def test_eager_slice_matches_jax_xla(jax_tiny, jax_params, chans):
    gd, jmodel = _jax_model("xla", jax_params, jax_tiny)
    model = _port_model("eager", jmodel)
    x = np.random.default_rng(5 + chans).random((2, 64, 64, chans), np.float32)
    want = jax.jit(lambda s, x: nnx.merge(gd, s)(x))(jax_params, jnp.asarray(x))
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 64, 64, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SLICE_TOL)


def test_fused_slice_matches_jax_pallas(jax_tiny, jax_params, monkeypatch):
    """Thresholds lowered on both sides so that all five kernel routes run
    at tiny size: whole block at C=16, W->SW chains at C=32/64, split
    LN+W-MSA / LN+MLP at C=128, and the phase-space head."""
    monkeypatch.setenv("SUNET_PAIR_MIN_C", "32")
    monkeypatch.setenv("SUNET_INFER_KERNEL_MAX_C", "64")
    monkeypatch.setattr(tlayers, "ROUTE_PAIR_MIN_C", 32)
    monkeypatch.setattr(tlayers, "ROUTE_BLOCK_MAX_C", 64)
    gd, jmodel = _jax_model("pallas", jax_params, jax_tiny)
    model = _port_model("fused", jmodel)
    x = np.random.default_rng(8).random((2, 64, 64, 3), np.float32)
    want = jax.jit(lambda s, x: nnx.merge(gd, s)(x))(jax_params, jnp.asarray(x))
    _build.reset_counts()
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    calls = {k: _build.counter(k).cpu for k in model.expected_launches(x.shape)}
    assert all(calls[k] > 0 for k in WRAPPERS), calls
    assert calls == model.expected_launches(x.shape)
    assert not any(_build.counter(k).cuda for k in WRAPPERS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SLICE_TOL)


def test_reference_buffers_are_checked(jax_tiny, jax_params):
    _, jmodel = _jax_model("xla", jax_params, jax_tiny)
    sd = params_to_state_dict(jmodel)
    key = next(k for k in sd if k.endswith(".attn_mask"))
    sd[key] = np.zeros_like(sd[key])
    cfg = tconfig.tiny_config().replace(compute_dtype="float32")
    with pytest.raises(ValueError, match="attn_mask"):
        load_reference_state_dict(build_model(cfg, device="cpu"), sd)


def test_reflect_pad_matches_numpy_and_refuses_long_pads():
    x = np.random.default_rng(0).random((1, 5, 7, 2), np.float32)
    got = reflect_pad_nhwc(torch.from_numpy(x), 3, 6)
    want = np.pad(x, ((0, 0), (0, 3), (0, 6), (0, 0)), mode="reflect")
    np.testing.assert_array_equal(got.numpy(), want)
    # a pad at or past the image's side reflects again, as numpy does
    got = reflect_pad_nhwc(torch.from_numpy(x), 5, 16)
    want = np.pad(x, ((0, 0), (0, 5), (0, 16), (0, 0)), mode="reflect")
    np.testing.assert_array_equal(got.numpy(), want)


def test_demo_writes_bmps(tmp_path):
    from sunet_tf_tpu_torch import demo

    cfg_path = tmp_path / "training.yaml"
    cfg_path.write_text(yaml.safe_dump(tconfig.config_to_dict(
        tconfig.tiny_config().replace(compute_dtype="float32"))))
    src, dst = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    rng = np.random.default_rng(2)
    sizes = {"img2": (128, 128), "img10": (100, 120)}  # 100x120 pads to 128
    for name, (h, w) in sizes.items():
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            src / f"{name}.png")
    written = demo.main(["--input_dir", str(src), "--result_dir", str(dst),
                         "--config", str(cfg_path), "--device", "cpu",
                         "--batch", "2"])
    assert [os.path.basename(p) for p in written] == ["img2.bmp", "img10.bmp"]
    for name, (h, w) in sizes.items():
        assert Image.open(dst / f"{name}.bmp").size == (w, h)


def test_build_model_targets_cuda_by_default(monkeypatch):
    """Without ``device`` the model goes to the card; on a machine without
    CUDA that raises instead of quietly building on the CPU."""
    import inspect

    assert inspect.signature(build_model).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(tconfig.tiny_config())
    assert next(build_model(tconfig.tiny_config(), device="cpu").parameters()).device.type == "cpu"
