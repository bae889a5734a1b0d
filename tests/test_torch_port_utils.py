"""The port's utils (``sunet_tf_tpu_torch/utils/``) against the JAX
package's: colour converters, Gaussian blur, MixUp, freezing with one Adam
step, ``get_last_path``, and the kernel cache's directory."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sunet_tf_tpu.utils import augment as jaugment
from sunet_tf_tpu.utils import color as jcolor
from sunet_tf_tpu.utils.dirs import get_last_path as jax_get_last_path
from sunet_tf_tpu.utils.freeze import freeze_mask as jax_freeze_mask
from sunet_tf_tpu.utils.freeze import partition_trainable as jax_partition_trainable
from sunet_tf_tpu_torch.kernels import _build
from sunet_tf_tpu_torch.utils import augment, cache, color, dirs, freeze


def colour_inputs() -> np.ndarray:
    """Random pixels, grays (delta 0), black, white, each primary's max and
    the hue seams, as (n, 3) float32 in [0, 1]."""
    rng = np.random.default_rng(3)
    special = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [0.2, 0.2, 0.2], [1, 0, 0], [0, 1, 0],
               [0, 0, 1], [1, 0, 0.2], [0.3, 0.1, 0.9], [0, 0.5, 1], [1, 1, 0], [0.7, 0.2, 0.7]]
    return np.concatenate([np.asarray(special, np.float32),
                           rng.random((200, 3)).astype(np.float32)])


def hs_inputs() -> np.ndarray:
    """(h, s, v-or-l) triples with l (v) in {0, 1} and s in {0, 1} among
    random ones, h over every sextant."""
    rng = np.random.default_rng(4)
    special = [[0.1, 0.5, 0.0], [0.9, 0.5, 1.0], [0.5, 0.0, 0.4], [0.99, 1.0, 0.5],
               [0.0, 1.0, 1.0], [1 / 6, 0.3, 0.7], [0.5, 1.0, 0.0], [0.75, 0.0, 0.0]]
    return np.concatenate([np.asarray(special, np.float32),
                           rng.random((200, 3)).astype(np.float32)])


@pytest.mark.parametrize("name", ["rgb2hsv", "hsv2rgb", "rgb2hsl", "hsl2rgb"])
def test_colour_converters_match_jax(name):
    x = colour_inputs() if name.startswith("rgb") else hs_inputs()
    x = x.reshape(2, -1, 1, 3)
    got = getattr(color, name)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jcolor, name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [5, 4])
def test_gaussian_blur_matches_jax(k):
    x = np.random.default_rng(k).random((2, 11, 13, 3)).astype(np.float32)
    got = augment.gaussian_blur(torch.from_numpy(x), k, 1.5).numpy()
    want = np.asarray(jaugment.gaussian_blur(jnp.asarray(x), k, 1.5))
    np.testing.assert_array_equal(augment.gaussian_blur_kernel(k, 1.5),
                                  jaugment.gaussian_blur_kernel(k, 1.5))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_mixup_mix_matches_jax_and_lam_is_beta(monkeypatch):
    rng = np.random.default_rng(6)
    t = rng.random((5, 4, 4, 3)).astype(np.float32)
    i = rng.random((5, 4, 4, 3)).astype(np.float32)
    lam = rng.random((5, 1, 1, 1)).astype(np.float32)
    monkeypatch.setattr(jaugment.jax.random, "beta", lambda *a, **k: jnp.asarray(lam))
    want = jaugment.MixUp()(jax.random.key(0), jnp.asarray(t), jnp.asarray(i))
    got = augment.MixUp.mix(torch.from_numpy(lam), torch.from_numpy(t), torch.from_numpy(i))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-7)

    mix = augment.MixUp(0.6)
    n = 100_000
    draws = mix.lam(torch.Generator().manual_seed(1), n).double().flatten()
    assert draws.shape == (n,) and float(draws.min()) >= 0 and float(draws.max()) <= 1
    # Beta(a, a): mean 1/2, variance 1/(4(2a+1)), kurtosis 3 - 6/(2a+3)
    var = 1.0 / (4 * 2.2)
    m4 = var ** 2 * (3 - 6 / 4.2)
    assert abs(float(draws.mean()) - 0.5) <= 5 * (var / n) ** 0.5
    assert abs(float(draws.var()) - var) <= 5 * ((m4 - var ** 2) / n) ** 0.5
    # the torch generator decides lam; the same state gives the same draws
    again = mix.lam(torch.Generator().manual_seed(1), n).double().flatten()
    assert torch.equal(draws, again)
    out = mix(torch.Generator().manual_seed(2), torch.from_numpy(t), torch.from_numpy(1 - t))
    np.testing.assert_allclose((out[0] + out[1]).numpy(), np.ones_like(t), atol=1e-6)


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.norm = torch.nn.LayerNorm(4)
        self.fc = torch.nn.Linear(4, 3)


def test_freeze_one_adam_step_matches_jax():
    torch.manual_seed(0)
    net = Net()
    rng = np.random.default_rng(8)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    grads = {n: rng.standard_normal(p.shape).astype(np.float32)
             for n, p in net.named_parameters()}
    mask = freeze.freeze_mask(net, lambda name: not name.startswith("norm."))
    assert mask == {"norm.weight": False, "norm.bias": False, "fc.weight": True,
                    "fc.bias": True}
    opt = freeze.partition_trainable(net, mask, lambda step: 1e-2)
    assert len(opt.params) == 2 and len(opt.mu) == 2
    for n, p in net.named_parameters():
        assert p.requires_grad == mask[n]
        if p.requires_grad:
            p.grad = torch.from_numpy(grads[n])
    opt.step()

    params = {"norm": {"weight": before["norm.weight"].numpy(),
                       "bias": before["norm.bias"].numpy()},
              "fc": {"weight": before["fc.weight"].numpy(), "bias": before["fc.bias"].numpy()}}
    params = jax.tree.map(jnp.asarray, params)
    jmask = jax_freeze_mask(params, lambda path: path[0].key != "norm")
    tx = jax_partition_trainable(optax.adam(1e-2), jmask)
    jgrads = {"norm": {"weight": grads["norm.weight"], "bias": grads["norm.bias"]},
              "fc": {"weight": grads["fc.weight"], "bias": grads["fc.bias"]}}
    updates, _ = tx.update(jax.tree.map(jnp.asarray, jgrads), tx.init(params), params)
    after = optax.apply_updates(params, updates)
    for n, p in net.named_parameters():
        a, b = n.split(".")
        if mask[n]:
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(after[a][b]), rtol=0,
                                       atol=5e-6, err_msg=n)
            assert not torch.equal(p, before[n])
        else:
            assert torch.equal(p.detach(), before[n]), n


def test_dirs_and_get_last_path_natural_order(tmp_path):
    dirs.mkdirs([str(tmp_path / "a"), str(tmp_path / "b")])
    dirs.mkdir(str(tmp_path / "a"))
    assert (tmp_path / "a").is_dir() and (tmp_path / "b").is_dir()
    for n in (1, 2, 10, 9):
        (tmp_path / f"model_epoch_{n}_latest.pth").write_text("x")
    got = dirs.get_last_path(str(tmp_path), "_latest.pth")
    assert got.endswith("_10_latest.pth") and got == jax_get_last_path(str(tmp_path),
                                                                       "_latest.pth")
    with pytest.raises(FileNotFoundError):
        dirs.get_last_path(str(tmp_path), "_nope.pth")


def test_kernel_cache_priority(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.DEFAULT_BUILD_DIR)
    monkeypatch.delenv(cache.ENV, raising=False)
    assert cache.enable_kernel_cache() == str(_build.DEFAULT_BUILD_DIR)
    monkeypatch.setenv(cache.ENV, str(tmp_path / "env"))
    assert cache.enable_kernel_cache() == str(tmp_path / "env")
    assert cache.enable_kernel_cache(str(tmp_path / "arg")) == str(tmp_path / "arg")
    assert _build.BUILD_DIR == tmp_path / "arg"
    assert _build.library_path().parent == tmp_path / "arg"
    # once the library is loaded the directory stays, with a warning
    monkeypatch.setattr(_build._Library, "lib", object())
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert cache.enable_kernel_cache(str(tmp_path / "late")) == str(tmp_path / "arg")
    assert _build.BUILD_DIR == tmp_path / "arg" and "already loaded" in str(w[0].message)
