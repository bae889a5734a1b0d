"""The port's data tier against the JAX package's: patches, packed shards,
the DataLoader workers against grain's pipeline, InputDataset, the crops,
TPU.DATA_WORKERS in the config and the Trainer, and the synth and
lr_schedule CLIs. Images are 16-40 px; one test spawns workers."""

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from sunet_tf_tpu import config as jconfig
from sunet_tf_tpu.data import packed as jpacked
from sunet_tf_tpu.data import patches as jpatches
from sunet_tf_tpu.data import pipeline as jpipeline
from sunet_tf_tpu.data import synth as jsynth
from sunet_tf_tpu.ops import image as jimage
from sunet_tf_tpu_torch import config as tconfig
from sunet_tf_tpu_torch import lr_schedule as tlr
from sunet_tf_tpu_torch.data import packed as tpacked
from sunet_tf_tpu_torch.data import patches as tpatches
from sunet_tf_tpu_torch.data import pipeline as tpipeline
from sunet_tf_tpu_torch.data import synth as tsynth
from sunet_tf_tpu_torch.data import workers as tworkers
from sunet_tf_tpu_torch.ops import image as timage
from sunet_tf_tpu_torch.train import trainer as ttrainer

ROOT = Path(__file__).resolve().parent.parent
# image sizes of the pair corpus: some below the 24 px patch (reflect-padded)
SIZES = [(32, 40), (20, 28), (24, 24), (40, 30), (18, 16)]


def save(path: Path, img: np.ndarray):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(img).save(path)


def pair_root(tmp: Path, sizes=SIZES, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(sizes):
        save(tmp / "input" / f"im{i}.png", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        save(tmp / "target" / f"im{i}.png", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    return str(tmp)


def tree_bytes(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


@pytest.mark.parametrize("pair_mode", ["tagged", "same"])
def test_generate_patches_matches_jax(tmp_path, pair_mode):
    rng = np.random.default_rng(1)
    for i, (h, w) in enumerate([(40, 36), (20, 30), (33, 33)]):   # one below ps
        for tag in ("GT", "hazy"):
            save(tmp_path / "src" / "scene" / f"img{i}_{tag}.png",
                 rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    kw = dict(ps=24, num_patches=2, num_workers=2, pair_mode=pair_mode, seed=5)
    n_j = jpatches.generate_patches(str(tmp_path / "src"), str(tmp_path / "jax"), **kw)
    n_t = tpatches.generate_patches(str(tmp_path / "src"), str(tmp_path / "port"), **kw)
    assert n_t == n_j == (6 if pair_mode == "tagged" else 12)
    want, got = tree_bytes(tmp_path / "jax"), tree_bytes(tmp_path / "port")
    assert len(got) == 2 * n_t and got == want


@pytest.mark.parametrize("train", [True, False])
def test_packed_dataset_matches_jax(tmp_path, train):
    root = pair_root(tmp_path / "pairs")
    tpacked.pack_pair_dataset(root, str(tmp_path / "port"), 24)
    jpacked.pack_pair_dataset(root, str(tmp_path / "jax"), 24)
    assert tree_bytes(tmp_path / "port") == tree_bytes(tmp_path / "jax")
    a = tpacked.PackedPairDataset(str(tmp_path / "port"), 16, train=train, seed=7)
    b = jpacked.PackedPairDataset(str(tmp_path / "jax"), 16, train=train, seed=7)
    assert len(a) == len(b) == len(SIZES)
    for i in [0, 3, 1, 0, 4, 2, 2]:
        (ai, at, an), (bi, bt, bn) = a.get(i), b.get(i)
        assert an == bn and ai.shape == (16, 16, 3)
        np.testing.assert_array_equal(ai, bi)
        np.testing.assert_array_equal(at, bt)


def test_workers_eval_batches_match_grain(tmp_path):
    pytest.importorskip("grain")
    from sunet_tf_tpu.data.grain_pipeline import grain_batch_iterator

    root = pair_root(tmp_path)
    kw = dict(train=False, shuffle=False, drop_last=False, workers=0)
    for batch, pad_to in ((2, 2), (4, 3), (5, 0)):
        want = list(grain_batch_iterator(root, 24, batch, pad_to=pad_to, **kw))
        got = list(tworkers.worker_batch_iterator(root, 24, batch, pad_to=pad_to, **kw))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g["names"] == w["names"]
            for k in ("input", "target", "valid"):
                np.testing.assert_array_equal(np.asarray(g[k]), w[k], err_msg=k)


def test_workers_train_batches_do_not_depend_on_worker_count(tmp_path):
    root = pair_root(tmp_path)
    kw = dict(train=True, shuffle=True, drop_last=True, seed=9)
    runs = [list(tworkers.worker_batch_iterator(root, 16, 2, workers=w, **kw)) for w in (0, 2)]
    assert len(runs[0]) == len(runs[1]) == len(SIZES) // 2
    for a, b in zip(*runs):
        assert a["names"] == b["names"] and a["input"].dtype == torch.uint8
        for k in ("input", "target", "valid"):
            assert torch.equal(a[k], b[k]), k
    # the crop is the record's: another epoch seed moves it
    other = list(tworkers.worker_batch_iterator(root, 16, 2, workers=0, **{**kw, "seed": 10}))
    assert any(not torch.equal(a["input"], b["input"]) for a, b in zip(runs[0], other))


def test_input_dataset_and_center_crop_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    for name, (h, w) in zip(["a10", "a2", "b1", "a1"], [(16, 20), (16, 20), (24, 16), (16, 20)]):
        save(tmp_path / f"{name}.png", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    (tmp_path / "notes.txt").write_text("not an image")
    got = list(tpipeline.InputDataset(str(tmp_path)).iter_batches(2))
    want = list(jpipeline.InputDataset(str(tmp_path)).iter_batches(2))
    assert [g["names"] for g in got] == [w["names"] for w in want] == [
        ["a1", "a2"], ["a10"], ["b1"]]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["input"], w["input"])
    img = rng.integers(0, 256, (27, 22, 3), dtype=np.uint8)
    for ps in (8, 15, 22):
        np.testing.assert_array_equal(timage.center_crop(torch.from_numpy(img), ps).numpy(),
                                      np.asarray(jimage.center_crop(jnp.asarray(img), ps)))
    inp, tar = torch.from_numpy(img), torch.from_numpy(img[..., ::-1].copy())
    a, b = timage.random_crop_pair(torch.Generator().manual_seed(3), inp, tar, 9)
    assert a.shape == b.shape == (9, 9, 3)
    assert torch.equal(a, b.flip(-1))   # aligned crops


def test_data_workers_in_config_and_trainer(tmp_path, monkeypatch):
    raw = tconfig.config_to_dict(tconfig.tiny_config().replace(data_workers=3))
    assert raw["TPU"]["DATA_WORKERS"] == 3
    path = tmp_path / "training.yaml"
    path.write_text(yaml.safe_dump(raw))
    assert tconfig.load_config(str(path)).data_workers == 3
    assert jconfig.load_config(str(path)).tpu.data_workers == 3
    assert tconfig.config_from_dict({}).data_workers == 0

    root = pair_root(tmp_path / "train", sizes=[(64, 64)] * 4)
    cfg = tconfig.tiny_config().replace(data_workers=2, optim=tconfig.OptimConfig(batch=2))
    cfg = cfg.replace(training=tconfig.TrainingConfig(train_ps=64, val_ps=64, train_dir=root,
                                                      save_dir=str(tmp_path / "ck")))
    calls = []
    monkeypatch.setattr(ttrainer, "worker_batch_iterator",
                        lambda *a, **k: calls.append((a, k)) or iter(()))
    t = ttrainer.Trainer(cfg, task="mask", device="cpu", verbose=False)
    list(t._train_iterator(1))
    list(t._eval_iterator(t.train_ds, 2, 1))
    assert [c[1]["workers"] for c in calls] == [2, 2]
    assert [c[1]["train"] for c in calls] == [True, False]
    assert calls[0][1]["seed"] == cfg.training.seed + 1 and calls[0][1]["drop_last"]
    assert not calls[0][1]["pin_memory"]
    t.cfg = cfg.replace(data_workers=0)
    list(t._train_iterator(1))
    assert len(calls) == 2   # the in-process pipeline


def load_cli(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_cli_{name}", ROOT / "cli" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cli", ["synth", "lr_schedule"])
def test_clis_print_what_jax_prints(cli, tmp_path, capsys, monkeypatch):
    if cli == "synth":
        args = ["--n", "2", "--size", "24", "--seed", "4", "--pair_mode", "awgn"]
        monkeypatch.setattr(sys, "argv", ["synth", "--out", str(tmp_path / "jax"), *args])
        jsynth.main()
        want = capsys.readouterr().out.replace(str(tmp_path / "jax"), "OUT")
        tsynth.main(["--out", str(tmp_path / "port"), *args])
        got = capsys.readouterr().out.replace(str(tmp_path / "port"), "OUT")
        assert tree_bytes(tmp_path / "port") == tree_bytes(tmp_path / "jax")
    else:
        args = ["--epochs", "7", "--lr", "3e-4", "--lr-min", "2e-6", "--warmup", "2"]
        monkeypatch.setattr(sys, "argv", ["lr_schedule", *args])
        load_cli("lr_schedule").main()
        want = capsys.readouterr().out
        tlr.main(args)
        got = capsys.readouterr().out
        assert len(got.splitlines()) == 8
    assert got == want
