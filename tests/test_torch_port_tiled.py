"""The port's tiled inference, its demo_any_resolution entry point and its
directory PSNR/SSIM evaluation held against the JAX package on the CPU.

Geometry, tile order, fold and run_corpus are held bit for bit, through
models that compute the same float32 bits on both sides: the fold through
JAX's own tile outputs of tanh(t @ w) (``tests/test_tiled.py``'s model;
XLA's tanh and torch's differ by a few ulps, so each side is fed the same
outputs), the tiled paths through t[..., 1:] * m for a per-pixel map m
(one rounded product per element on both sides). XLA computes JAX's
division by the constant count map as a product with its float32
reciprocal; the port's fold does the same, and the exact comparison pins
it. The tiny SUNet (64x64 tiles, C=16, depths 2, heads 2, ws 4, float32)
goes tiled through both packages with weights carried over as in
``tests/test_torch_port_model.py``, within rtol=1e-3, atol=1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx
from PIL import Image

from sunet_tf_tpu import config as jconfig
from sunet_tf_tpu.infer import tiled as jtiled
from sunet_tf_tpu.models.sunet import build_model as jax_build_model
from sunet_tf_tpu.ops import image as jimage
from sunet_tf_tpu.ops.metrics import tpr_fpr as jax_tpr_fpr
from sunet_tf_tpu_torch import config as tconfig
from sunet_tf_tpu_torch import demo_any_resolution as dar
from sunet_tf_tpu_torch import evaluate
from sunet_tf_tpu_torch.infer import TiledRunner, tiled_inference
from sunet_tf_tpu_torch.infer import tiled as ttiled
from sunet_tf_tpu_torch.kernels import _build
from sunet_tf_tpu_torch.models import layers as tlayers
from sunet_tf_tpu_torch.models.sunet import build_model
from sunet_tf_tpu_torch.weights import load_reference_state_dict
from tools.export_torch_checkpoint import params_to_state_dict
from tools.ssim_oracle import ssim_oracle

SLICE_TOL = dict(rtol=1e-3, atol=1e-4)
K = 64
SIZES = [(64, 64), (70, 130), (100, 180), (200, 90), (129, 64), (1, 300)]
CORPUS = [(96, 80), (60, 100), (96, 80), (40, 40), (100, 90), (96, 80)]


class _MapModel(torch.nn.Module):
    """t[..., 1:] * m, m a parameter (so ``run_corpus`` runs where m is)."""

    def __init__(self, m):
        super().__init__()
        self.m = torch.nn.Parameter(torch.from_numpy(m), requires_grad=False)

    def forward(self, t):
        return t[..., 1:] * self.m


def _map_models(seed=4):
    """t[..., 1:] * m on both sides, m a (K, K, 2) float32 map."""
    m = np.random.default_rng(seed).random((K, K, 2)).astype(np.float32)
    return (lambda p, t: t[..., 1:] * p), jnp.asarray(m), _MapModel(m)


@pytest.mark.parametrize("stride", [16, 32, 64])
def test_geometry_matches_jax(stride):
    jr = jtiled.TiledRunner(None, kernel=K, stride=stride)
    for square in (False, True):
        tr = TiledRunner(None, kernel=K, stride=stride, square_pad=square)
        jr.square_pad = square
        for H, W in SIZES:
            assert ttiled.canvas_shape(H, W, K, square) == jtiled.canvas_shape(H, W, K, square)
            Xh, Xw = tr.bucket(H, W)
            assert (Xh, Xw) == jr.bucket(H, W)
            assert ttiled._tile_starts(Xh, K, stride) == jtiled._tile_starts(Xh, K, stride)
            assert tr.tiles_per_canvas(Xh, Xw) == jr.tiles_per_canvas(Xh, Xw)


@pytest.mark.parametrize("stride", [16, 32, 64])
def test_gather_tiles_matches_jax(stride):
    x = np.random.default_rng(stride).random((2, 192, 128, 3)).astype(np.float32)
    want = jax.vmap(lambda c: jtiled._gather_tiles(c, K, stride))(jnp.asarray(x))
    got = ttiled._gather_tiles(torch.from_numpy(x), K, stride)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).reshape(got.shape))


@pytest.mark.parametrize("stride", [16, 32, 64])
def test_fold_tiles_matches_jax(stride):
    """The same tile outputs (JAX's tanh(t @ w) on JAX's tiles) folded by
    both packages: the same bits, count maps 1..(K/stride)^2 included."""
    r = np.random.default_rng(100 + stride)
    B, Xh, Xw = 2, 192, 128
    x, w = r.random((B, Xh, Xw, 3)), r.random((3, 3))
    tiles = jax.vmap(lambda c: jtiled._gather_tiles(c, K, stride))(
        jnp.asarray(x, jnp.float32))
    outs = np.asarray(jnp.tanh(tiles @ jnp.asarray(w, jnp.float32)))
    want = jax.jit(jax.vmap(lambda o: jtiled._fold_tiles(o, Xh, Xw, K, stride)))(outs)
    got = ttiled._fold_tiles(torch.from_numpy(outs.reshape((-1,) + outs.shape[2:]).copy()),
                             B, Xh, Xw, K, stride)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hw,square,tile_batch,stride", [
    ((100, 180), False, 4, 32),    # 2 x 15 tiles: 7 chunks of 4, then 2
    ((70, 130), True, 8, 32),      # square canvas, 2 x 25 tiles: 6 chunks of 8, then 2
    ((100, 180), False, 90, 16),   # 2 x 45 tiles, one forward
    ((200, 90), False, 64, 16),    # 2 x 65 tiles: 44 + 44 + 42
])
def test_tiled_inference_matches_jax(hw, square, tile_batch, stride):
    jm, m, tm = _map_models()
    x = np.random.default_rng(sum(hw)).random((2,) + hw + (3,)).astype(np.float32)
    want = np.asarray(jtiled.tiled_inference(jm, jnp.asarray(x), m, kernel=K, stride=stride,
                                             tile_batch=tile_batch, square_pad=square))
    kw = dict(kernel=K, stride=stride, tile_batch=tile_batch, square_pad=square)
    got = tiled_inference(tm, torch.from_numpy(x), **kw)
    assert tuple(got.shape) == (2,) + hw + (2,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(TiledRunner(tm, **kw)(torch.from_numpy(x)).numpy(),
                                  want)


@pytest.mark.parametrize("canvas_batch", [None, 2])
def test_run_corpus_matches_jax(canvas_batch):
    """Mixed sizes, grouped by bucket, outputs in input order: equal to
    JAX's run_corpus and to the port's image-by-image runner."""
    jm, m, tm = _map_models(12)
    r = np.random.default_rng(12)
    images = [r.random((h, w, 3)).astype(np.float32) for h, w in CORPUS]
    want = jtiled.TiledRunner(jm, m, kernel=K, stride=32, tile_batch=8).run_corpus(
        [jnp.asarray(im) for im in images], canvas_batch=canvas_batch)
    runner = TiledRunner(tm, kernel=K, stride=32, tile_batch=8)
    got = runner.run_corpus([im if i % 2 else torch.from_numpy(im)[None]
                             for i, im in enumerate(images)], canvas_batch=canvas_batch)
    assert len(got) == len(images)
    for im, g, w in zip(images, got, want):
        assert tuple(g.shape) == (1,) + im.shape[:2] + (2,) and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), runner(torch.from_numpy(im)[None]).numpy())


def test_identity_reconstruction_exact():
    for hw, square in (((100, 180), False), ((70, 130), True)):
        x = torch.from_numpy(np.random.default_rng(1).random((1,) + hw + (3,)).astype(np.float32))
        y = tiled_inference(lambda t: t, x, kernel=K, stride=32, tile_batch=4, square_pad=square)
        np.testing.assert_allclose(y.numpy(), x.numpy(), atol=1e-6)


def _jax_cfg(backend):
    cfg = jconfig.tiny_config()
    return cfg.replace(tpu=cfg.tpu.__class__(compute_dtype="float32",
                                             attention_backend=backend))


@pytest.fixture(scope="module")
def jax_split():
    """backend -> (graphdef, abstract parameters) of the tiny JAX SUNet,
    traced once each by ``nnx.eval_shape``: initialising it eagerly would
    compile every initialiser op on the CPU (~30 s on one core)."""
    return {b: nnx.split(nnx.eval_shape(lambda: jax_build_model(_jax_cfg(b), seed=3)),
                         nnx.Param) for b in ("xla", "pallas")}


@pytest.fixture(scope="module")
def jax_params(jax_split):
    """Tiny JAX SUNet parameters from a numpy seed, at the initialiser's
    scale plus noise: LayerNorm scales 1 and PReLU slopes 0.25 perturbed by
    N(0, 0.05), every other leaf N(0, 0.05) (the initialiser's ~0.02 plus
    the noise of ``tests/test_torch_port_model.py``)."""
    rng = np.random.default_rng(11)
    centre = {"scale": 1.0, "alpha": 0.25}

    def draw(path, leaf):
        c = centre.get(path[-2].key, 0.0)
        return jnp.asarray(c + rng.normal(0, 0.05, leaf.shape).astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, jax_split["xla"][1])


def _pair(backend, jax_split, jax_params):
    """(JAX model_fn(params, tiles), the port's model with the same weights)."""
    gd = jax_split[backend][0]
    cfg = tconfig.tiny_config().replace(compute_dtype="float32")
    model = build_model(cfg, device="cpu", backend="eager" if backend == "xla" else "fused")
    load_reference_state_dict(model, params_to_state_dict(nnx.merge(gd, jax_params)))
    return (lambda p, t: nnx.merge(gd, p)(t)), model


def test_eager_sunet_run_corpus_matches_jax_xla(jax_split, jax_params):
    """Three sizes on one 128x128 canvas (one compile on the JAX side), each
    placed at its own offsets: one forward of 27 tiles."""
    jfn, model = _pair("xla", jax_split, jax_params)
    r = np.random.default_rng(21)
    images = [r.random((h, w, 3)).astype(np.float32) for h, w in ((96, 80), (70, 110), (100, 90))]
    want = jtiled.TiledRunner(jfn, jax_params, kernel=K, stride=32, tile_batch=64).run_corpus(
        [jnp.asarray(im) for im in images])
    with torch.inference_mode():
        got = TiledRunner(model, kernel=K, stride=32, tile_batch=64).run_corpus(images)
    for im, g, w in zip(images, got, want):
        assert tuple(g.shape) == (1,) + im.shape[:2] + (1,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **SLICE_TOL)


def test_fused_sunet_tiled_matches_jax_pallas(jax_split, jax_params, monkeypatch):
    """The fused tiny model through tiles, its routes lowered as in
    ``test_fused_slice_matches_jax_pallas`` so that every kernel runs (the
    plain versions, on the CPU): one forward of the 3 tiles launches what
    ``expected_launches`` predicts for that batch."""
    monkeypatch.setenv("SUNET_PAIR_MIN_C", "32")
    monkeypatch.setenv("SUNET_INFER_KERNEL_MAX_C", "64")
    monkeypatch.setattr(tlayers, "ROUTE_PAIR_MIN_C", 32)
    monkeypatch.setattr(tlayers, "ROUTE_BLOCK_MAX_C", 64)
    jfn, model = _pair("pallas", jax_split, jax_params)
    x = np.random.default_rng(22).random((1, 60, 100, 3)).astype(np.float32)
    want = jtiled.tiled_inference(jfn, jnp.asarray(x), jax_params, kernel=K, stride=32,
                                  tile_batch=64)
    _build.reset_counts()
    with torch.inference_mode():
        got = tiled_inference(model, torch.from_numpy(x), kernel=K, stride=32, tile_batch=64)
    expected = model.expected_launches((3, K, K, 3))
    calls = {k: _build.counter(k).cpu for k in expected}
    assert calls == expected and all(calls[k] > 0 for k in (
        "fused_swin_block", "fused_swin_block_chain", "fused_ln_window_attention",
        "fused_ln_mlp", "fused_dual_upsample4_conv_phase")), calls
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SLICE_TOL)


@pytest.fixture
def tiny_yaml(tmp_path):
    path = tmp_path / "training.yaml"
    path.write_text(yaml.safe_dump(tconfig.config_to_dict(
        tconfig.tiny_config().replace(compute_dtype="float32"))))
    return str(path)


def test_decode_chunks_budget(tmp_path):
    sizes = [(10, 10), (10, 10), (30, 30), (10, 10), (5, 4), (5, 4), (5, 4)]
    files = []
    for i, (h, w) in enumerate(sizes):
        files.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(np.zeros((h, w, 3), np.uint8)).save(files[-1])
    chunks = dar.decode_chunks(files, max_images=2, max_pixels=250)
    assert chunks == [files[0:2], files[2:3], files[3:5], files[5:7]]
    assert dar.decode_chunks(files, 256, 1 << 26) == [files]


def test_demo_any_resolution_writes_bmps_and_tpr_fpr(tmp_path, tiny_yaml, monkeypatch):
    src, masks = tmp_path / "in", tmp_path / "masks"
    src.mkdir()
    masks.mkdir()
    rng = np.random.default_rng(2)
    # img2 and img3 share the 128x128 canvas, so one chunk runs them in one batch
    sizes = {"img2": (100, 120), "img3": (110, 90), "img10": (70, 150)}
    for name, (h, w) in sizes.items():
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(src / f"{name}.png")
    for name in ("img2", "img10"):   # img3 has no mask
        h, w = sizes[name]
        Image.fromarray(rng.integers(0, 256, (h, w), dtype=np.uint8)).save(masks / f"{name}.png")
    argv = ["--input_dir", str(src), "--mask_dir", str(masks), "--config", tiny_yaml,
            "--size", "64", "--stride", "32", "--tile_batch", "16", "--device", "cpu"]
    written = dar.main(argv + ["--result_dir", str(tmp_path / "one")])
    assert [os.path.basename(p) for p in written] == ["img2.bmp", "img3.bmp", "img10.bmp"]
    rows = (tmp_path / "one" / "tpr_fpr_results.txt").read_text().splitlines()
    assert rows[0] == "Filename\tTPR\tFPR" and len(rows) == 3
    for row, name in zip(rows[1:], ("img2", "img10")):
        out = np.asarray(Image.open(tmp_path / "one" / f"{name}.bmp"))
        gray = (0.2989 * out[..., 0] + 0.5870 * out[..., 1]
                + 0.1140 * out[..., 2]).astype(np.uint8)
        tpr, fpr = jax_tpr_fpr(gray, np.asarray(Image.open(masks / f"{name}.png")))
        assert row == f"{name}.png\t{tpr:.4f}\t{fpr:.4f}"
    for name, (h, w) in sizes.items():
        assert Image.open(tmp_path / "one" / f"{name}.bmp").size == (w, h)
    # a pixel budget that decodes one image per chunk writes the same files
    monkeypatch.setattr(dar, "CHUNK_PIXELS", 100 * 120)
    dar.main(argv + ["--result_dir", str(tmp_path / "split")])
    for name in sizes:
        assert ((tmp_path / "one" / f"{name}.bmp").read_bytes()
                == (tmp_path / "split" / f"{name}.bmp").read_bytes())
    assert (tmp_path / "split" / "tpr_fpr_results.txt").read_text() == "\n".join(rows) + "\n"


def _write_pngs(d, images):
    d.mkdir()
    for i, im in enumerate(images):
        Image.fromarray(im).save(d / f"im{i + 1}.png")


def test_evaluate_matches_jax_and_the_ssim_oracle(tmp_path):
    rng = np.random.default_rng(31)
    gts = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ((48, 64), (40, 40))]
    noisy = lambda s: [np.clip(g.astype(np.int32) + rng.integers(-s, s + 1, g.shape), 0,
                               255).astype(np.uint8) for g in gts]
    preds, noisies = noisy(20), noisy(60)
    _write_pngs(tmp_path / "gt", gts)
    _write_pngs(tmp_path / "pred", preds)
    _write_pngs(tmp_path / "noisy", noisies)
    rows = evaluate.main(["--gt_dir", str(tmp_path / "gt"), "--pred_dir", str(tmp_path / "pred"),
                          "--noisy_dir", str(tmp_path / "noisy"), "--device", "cpu"])
    assert [r["name"] for r in rows] == ["im1.png", "im2.png"]
    for row, g, p, n in zip(rows, gts, preds, noisies):
        gt = jnp.asarray(g, jnp.float32)[None] / 255.0
        for key, other in (("", p), ("_noisy", n)):
            o = jnp.asarray(other, jnp.float32)[None] / 255.0
            assert abs(row["psnr" + key] - float(jimage.psnr(gt, o))) <= 1e-5
            ga, go = jimage.rgb_to_gray(gt), jimage.rgb_to_gray(o)
            assert abs(row["ssim" + key] - float(jimage.ssim(ga, go))) <= 1e-5
            assert abs(row["ssim" + key] - ssim_oracle(np.asarray(ga), np.asarray(go))[0]) <= 1e-4
    _write_pngs(tmp_path / "short", gts[:1])
    with pytest.raises(ValueError, match="1 predictions"):
        evaluate.main(["--gt_dir", str(tmp_path / "gt"), "--pred_dir", str(tmp_path / "short"),
                       "--device", "cpu"])


def test_tiled_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """Without a card the entry points stop with a message (no quiet CPU
    run), and ``run_corpus`` of a model with no parameters to take a device
    from goes to the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dar.parse_args(["--input_dir", "a", "--result_dir", "b"]).device == "cuda"
    assert evaluate.parse_args(["--gt_dir", "a", "--pred_dir", "b"]).device == "cuda"
    with pytest.raises(SystemExit, match="no CUDA device"):
        dar.main(["--input_dir", str(tmp_path), "--result_dir", str(tmp_path / "o")])
    with pytest.raises(SystemExit, match="no CUDA device"):
        evaluate.main(["--gt_dir", str(tmp_path), "--pred_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TiledRunner(lambda t: t, kernel=K, stride=32).run_corpus([np.zeros((8, 8, 3))])
    from sunet_tf_tpu_torch.tools import corpus_bench

    with pytest.raises(SystemExit, match="no CUDA device"):
        corpus_bench.main([])
