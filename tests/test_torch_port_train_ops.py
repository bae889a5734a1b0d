"""The port's training-side ops, optimizer, schedule and Trainer against the
JAX package, on the CPU.

Each numpy input goes to the JAX function and its port. Exact where the
arithmetic is the same (weights, histograms, dihedral ops, schedules,
stochastic rounding); rtol 1e-5 for float32 reductions in another order
(PSNR, SSIM, losses); the fp32 Adam bit for bit against torch.optim.Adam
and against optax within 5e-6 absolute after six steps of rates up to
6e-2 (optax forms the bias corrections 1 - b**count in float32, 4e-5
relative off at count 1, which moves each update by ~2e-5 of its size).
"""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from sunet_tf_tpu.ops import image as jimg
from sunet_tf_tpu.ops import metrics as jmet
from sunet_tf_tpu.ops.morphology import boundary_ring_weights as jax_weights
from sunet_tf_tpu.train import adam as jadam
from sunet_tf_tpu.train import losses as jloss
from sunet_tf_tpu.train import schedule as jsched
from sunet_tf_tpu.train.loop import make_optax_lr_schedule
from sunet_tf_tpu import config as jconfig
from sunet_tf_tpu_torch import config as tconfig
from sunet_tf_tpu_torch.ops import image as timg
from sunet_tf_tpu_torch.ops import metrics as tmet
from sunet_tf_tpu_torch.ops.morphology import boundary_ring_weights
from sunet_tf_tpu_torch.train import adam as tadam
from sunet_tf_tpu_torch.train import losses as tloss
from sunet_tf_tpu_torch.train import schedule as tsched

T = torch.from_numpy
J = jnp.asarray


def test_boundary_weights_match_jax():
    rng = np.random.default_rng(0)
    tar = (rng.random((2, 20, 24, 1)) > 0.8).astype(np.float32)
    np.testing.assert_allclose(boundary_ring_weights(T(tar)).numpy(),
                               np.asarray(jax_weights(J(tar))), rtol=1e-6)
    zero = np.zeros((1, 8, 8, 1), np.float32)
    np.testing.assert_array_equal(boundary_ring_weights(T(zero)).numpy(),
                                  np.asarray(jax_weights(J(zero))))


def test_histograms_and_auroc_match_jax():
    rng = np.random.default_rng(1)
    scores = rng.random((3, 8, 8, 1)).astype(np.float32)
    labels = (rng.random((3, 8, 8, 1)) > 0.6).astype(np.float32)
    sw = np.array([1.0, 0.0, 1.0], np.float32)
    th = tmet.update_histograms(tmet.init_histograms(256), T(scores), T(labels), T(sw))
    jh = jmet.update_histograms(jmet.init_histograms(256), J(scores), J(labels), J(sw))
    for k in ("pos", "neg"):
        np.testing.assert_array_equal(th[k].numpy(), np.asarray(jh[k]))
    assert tmet.auroc_from_histograms(th) == jmet.auroc_from_histograms(jh)
    assert tmet.auprc_from_histograms(th) == jmet.auprc_from_histograms(jh)
    for got, want in zip(tmet.roc_curve_from_histograms(th) + tmet.pr_curve_from_histograms(th),
                         jmet.roc_curve_from_histograms(jh) + jmet.pr_curve_from_histograms(jh)):
        np.testing.assert_array_equal(got, want)
    assert tmet.auroc_exact(labels, scores) == jmet.auroc_exact(labels, scores)
    assert tmet.auprc_exact(labels, scores) == jmet.auprc_exact(labels, scores)


def test_psnr_ssim_gray_match_jax():
    rng = np.random.default_rng(2)
    a = rng.random((2, 24, 24, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), -0.1, 1.1).astype(np.float32)
    close = lambda g, w: np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-5)
    close(timg.psnr(T(a), T(b)), jimg.psnr(J(a), J(b)))
    close(timg.psnr_per_sample(T(a), T(b)), jimg.psnr_per_sample(J(a), J(b)))
    close(timg.ssim_per_sample(T(a), T(b)), jimg.ssim_per_sample(J(a), J(b)))
    close(timg.ssim(T(a), T(b)), jimg.ssim(J(a), J(b)))
    close(timg.rgb_to_gray(T(a)), jimg.rgb_to_gray(J(a)))


def test_dihedral_matches_jax():
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (9, 6, 6, 3), dtype=np.uint8)
    ops = np.arange(9)
    np.testing.assert_array_equal(timg.dihedral_batch(T(imgs), T(ops)).numpy(),
                                  np.asarray(jimg.dihedral_batch(J(imgs), J(ops))))
    for op in range(9):
        np.testing.assert_array_equal(timg.dihedral(T(imgs[op]), op).numpy(),
                                      np.asarray(jimg.dihedral(J(imgs[op]), op)))
    g = lambda: torch.Generator().manual_seed(5)
    x = torch.rand(2, 4, 4, 3)
    assert torch.equal(timg.add_awgn(g(), x, 25.0), timg.add_awgn(g(), x, 25.0))


def test_lr_schedules_match_jax():
    cfg = jconfig.Config()
    o = cfg.optim
    for spe in (1, 7):
        want = make_optax_lr_schedule(cfg, spe)
        for count in range(0, 8 * spe, max(1, spe // 3)):
            got = tsched.lr_for_step(count, spe, o.lr_initial, o.lr_min, o.epochs,
                                     o.warmup_epochs)
            np.testing.assert_allclose(got, float(want(jnp.int32(count))), rtol=1e-6)
    for step in range(0, 40, 3):
        assert tsched.lr_for_step(step, 4, 2e-4, 1e-6, 10) == jsched.lr_for_step(
            step, 4, 2e-4, 1e-6, 10)


def test_adam_fp32_matches_optax_and_torch_adam():
    rng = np.random.default_rng(4)
    shapes = [(5, 7), (3,)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(6)]
    lr = lambda c: 1e-2 * (1 + c)
    ours = [T(p.copy()).requires_grad_(True) for p in p0]
    theirs = [T(p.copy()).requires_grad_(True) for p in p0]
    opt = tadam.AdamLP(ours, lr)
    ref = torch.optim.Adam(theirs, lr=1.0, foreach=False)
    tx = optax.adam(lambda c: 1e-2 * (1 + c))
    jp = [J(p) for p in p0]
    state = tx.init(jp)
    for i, g in enumerate(grads):
        for a, b, gg in zip(ours, theirs, g):
            a.grad, b.grad = T(gg.copy()), T(gg.copy())
        for group in ref.param_groups:
            group["lr"] = lr(i)
        opt.step()
        ref.step()
        upd, state = tx.update([J(gg) for gg in g], state, jp)
        jp = optax.apply_updates(jp, upd)
    for a, b, c in zip(ours, theirs, jp):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(c), rtol=0, atol=5e-6)


def test_bf16_stochastic_rounding_matches_jax_and_is_unbiased():
    rng = np.random.default_rng(6)
    x = rng.random(4096).astype(np.float32) * 1e-3
    for r in (0, 1, 12345, 65535):
        got = tadam.stochastic_round_bf16(T(x), r).float().numpy()
        want = np.asarray(jadam._stochastic_round_bf16(jnp.uint32(r), J(x)).astype(jnp.float32))
        np.testing.assert_array_equal(got, want)
    # one value between two bf16 neighbours: over n random dithers the mean
    # of the roundings is within 5 standard errors (each rounding deviates
    # by at most one bf16 ulp of the value)
    v = np.float32(1.0 + 0.3 * 2 ** -7)
    n = 4000
    dithers = rng.integers(0, 1 << 16, n)
    mean = np.mean([float(tadam.stochastic_round_bf16(T(np.array([v])), int(d))) for d in dithers])
    ulp = 2 ** -7
    assert abs(mean - v) <= 5 * ulp / (2 * np.sqrt(n))
    # the low-precision optimizer keeps bf16 moments and updates
    p = torch.zeros(64, requires_grad=True)
    opt = tadam.AdamLP([p], lambda c: 1e-3, mu_dtype="bfloat16", nu_dtype="bfloat16",
                       stochastic_round_nu=True, sr_seed=3)
    p.grad = torch.ones(64)
    opt.step()
    assert opt.mu[0].dtype == opt.nu[0].dtype == torch.bfloat16 and opt.count == 1
    assert bool((p < 0).all())


def test_losses_match_jax_and_pin_the_denoise_normalisation():
    rng = np.random.default_rng(7)
    pred, tar = rng.random((2, 8, 8, 3)).astype(np.float32), rng.random((2, 8, 8, 3)).astype(np.float32)
    w = rng.random((2, 8, 8, 3)).astype(np.float32)
    close = lambda g, ww: np.testing.assert_allclose(np.asarray(g), np.asarray(ww), rtol=1e-5)
    for fn in ("charbonnier_loss", "mse_loss", "charbonnier_per_sample", "mse_per_sample"):
        close(getattr(tloss, fn)(T(pred), T(tar)), getattr(jloss, fn)(J(pred), J(tar)))
        close(getattr(tloss, fn)(T(pred), T(tar), T(w)),
              getattr(jloss, fn)(J(pred), J(tar), J(w)))
    # The JAX denoise step passes the (B,1,1,1) valid mask as the weight, so
    # its loss is the per-image SUM over pixels (sum(l*v)/sum(v)), not the
    # reference's mean; the port's step expands the mask to the logits'
    # shape and so trains on the mean (ROADMAP queue C).
    v4 = np.ones((2, 1, 1, 1), np.float32)
    l = np.sqrt((pred - tar) ** 2 + 1e-6)
    close(jloss.charbonnier_loss(J(pred), J(tar), J(v4)), l.sum() / 2)
    close(tloss.charbonnier_loss(T(pred), T(tar), T(v4).expand(2, 8, 8, 3)), l.mean())


def test_trainer_and_cli_default_to_cuda(monkeypatch):
    from sunet_tf_tpu_torch.train import __main__ as cli
    from sunet_tf_tpu_torch.train.trainer import Trainer

    assert inspect.signature(Trainer).parameters["device"].default == "cuda"
    assert cli.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(tconfig.tiny_config())


def test_trainer_fit_writes_a_checkpoint_and_resumes(tmp_path):
    from sunet_tf_tpu_torch.data.synth import generate_dataset
    from sunet_tf_tpu_torch.models.sunet import build_model
    from sunet_tf_tpu_torch.train.__main__ import main
    from sunet_tf_tpu_torch.weights import load_reference_checkpoint

    generate_dataset(str(tmp_path / "tr"), 4, size=64, seed=0)
    generate_dataset(str(tmp_path / "va"), 2, size=64, seed=1)
    cfg = tconfig.tiny_config().replace(compute_dtype="float32")
    raw = tconfig.config_to_dict(cfg.replace(optim=cfg.optim.__class__(batch=2, epochs=1)))
    raw["TRAINING"].update({"TRAIN_DIR": str(tmp_path / "tr"), "VAL_DIR": str(tmp_path / "va"),
                            "SAVE_DIR": str(tmp_path / "ck")})
    (tmp_path / "t.yaml").write_text(yaml.safe_dump(raw))
    args = ["--config", str(tmp_path / "t.yaml"), "--device", "cpu", "--steps-per-epoch", "2"]
    main(args)
    mdir = tmp_path / "ck" / cfg.mode / "models"
    assert sorted(os.listdir(mdir)) == ["best_auprc.pth", "best_auroc.pth", "latest.pth"]
    payload = torch.load(mdir / "latest.pth", weights_only=True)
    assert payload["epoch"] == 1 and payload["optimizer"]["count"] == 2
    model = load_reference_checkpoint(build_model(cfg, device="cpu"), str(mdir / "latest.pth"))
    assert torch.equal(model.output.weight, payload["state_dict"]["swin_unet.output.weight"])
    summary = main(args[:-2] + ["--epochs", "2", "--resume"])
    assert summary["best"]["auroc"]["epoch"] in (1, 2)
    assert torch.load(mdir / "latest.pth", weights_only=True)["epoch"] == 2
    with open(tmp_path / "ck" / cfg.mode / "log" / "metrics_per_epoch.csv") as f:
        assert f.read().count("\n") == 2   # header + the resumed epoch 2
