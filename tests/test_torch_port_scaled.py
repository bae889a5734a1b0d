"""The scaled SUNet (EMB 180, WIN 16, 512x512; ``scaled_config``) in the port,
held against the JAX package on the CPU.

The full-size configuration is held field by field and through its launch
plans; everything that runs does so at a shrunk copy,
``scaled_config(img_size=128, emb_dim=60, head_num=(2, 4, 8, 16),
depth_en=(2, 2, 2, 2))``: head dim 30 at every stage (the full size's),
C = 60/120/240/480 (60 and 120 not multiples of 16, as 180 is not), and
windows of 256 tokens at the 32x32 (shift 8) and 16x16 stages. float32,
inputs from numpy seeds handed to both sides; the kernel modules against
the JAX Pallas kernels in interpret mode at rtol = atol = 1e-4 (the JAX
kernels' GELU uses the Abramowitz-Stegun erf, 1.5e-7 from the exact erf
the port uses); the slice at ``test_torch_port_model.SLICE_TOL`` (rtol
1e-3, atol 1e-4), weights carried from the JAX model through
``params_to_state_dict`` and ``load_reference_state_dict``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml
from flax import nnx

from sunet_tf_tpu import config as jconfig
from sunet_tf_tpu.kernels import upsample as jup
from sunet_tf_tpu.kernels import window_attention as jwa
from sunet_tf_tpu.models.sunet import build_model as jax_build_model
from sunet_tf_tpu.ops.window import shift_attn_mask
from sunet_tf_tpu_torch import config as tconfig
from sunet_tf_tpu_torch.kernels import _build
from sunet_tf_tpu_torch.kernels import upsample as tup
from sunet_tf_tpu_torch.kernels import window_attention as twa
from sunet_tf_tpu_torch.models import layers as tlayers
from sunet_tf_tpu_torch.models.sunet import INFER_WRAPPERS, build_model, param_count
from sunet_tf_tpu_torch.weights import load_reference_state_dict
from tools.export_torch_checkpoint import params_to_state_dict

TOL = dict(rtol=1e-4, atol=1e-4)
SLICE_TOL = dict(rtol=1e-3, atol=1e-4)
SHRUNK = dict(img_size=128, emb_dim=60, head_num=(2, 4, 8, 16), depth_en=(2, 2, 2, 2))
SCALE = 30 ** -0.5   # head dim 30, qk_scale None


def _same_config(j, t):
    for sect in ("swinunet", "optim", "training"):
        for f, v in vars(getattr(j, sect)).items():
            assert getattr(getattr(t, sect), f) == v, (sect, f)
    assert (t.compute_dtype, t.mode, t.verbose) == (j.tpu.compute_dtype, j.mode, j.verbose)


@pytest.mark.parametrize("overrides", [{}, SHRUNK], ids=["full", "shrunk"])
def test_scaled_config_matches_jax_and_keeps_qk_scale_none(overrides, tmp_path):
    j, t = jconfig.scaled_config(**overrides), tconfig.scaled_config(**overrides)
    _same_config(j, t)
    assert t.swinunet.qk_scale is None and t.training.train_ps == 512
    # the overrides filter: only SwinUNetConfig fields take
    assert tconfig.scaled_config(batch=3, **overrides) == t
    path = tmp_path / "scaled.yaml"
    path.write_text(yaml.safe_dump(tconfig.config_to_dict(t)))
    assert "QK_SCALE: null" in path.read_text()
    back = tconfig.load_config(str(path))
    assert back == t and back.swinunet.qk_scale is None
    _same_config(jconfig.load_config(str(path)), back)


def test_scaled_model_size_and_launches():
    """Full width (about 3.5e8 parameters, the JAX test's > 3e8) and the
    router's launches of one batch-8 512x512 forward: #1's sequence form at
    C=180 (16 blocks) and C=360 (16 blocks in 8 W->SW chains), five
    launches a block; #3 + #4 at C=720 and 1440 (24 blocks); the
    conv-fused head."""
    model = build_model(tconfig.scaled_config(), device="meta")
    assert param_count(model) == 350_723_145
    seq = twa.SWIN_BLOCK_SEQ_LAUNCHES
    assert model.expected_launches((8, 512, 512, 3)) == {
        "fused_swin_block": 16 * seq, "fused_swin_block_chain": 16 * seq,
        "fused_ln_window_attention": 24 * twa.LN_WMSA_LAUNCHES,
        "fused_ln_mlp": 24 * twa.LN_MLP_LAUNCHES, "fused_dual_upsample4_conv_phase": 1,
        "fused_dual_upsample4": 0}
    blocks = [b for s in list(model.layers) + list(model.layers_up[1:]) for b in s.blocks]
    # training at WIN 16: the C=180/360/720 blocks on the block kernels
    # (#1's train form + #8's big-window form, the recompute route), the
    # C=1440 stage on the eager block (above JAX's train cap 768)
    on_block = [b.dim for b in blocks if b.trains_on_block_kernels()]
    assert sorted(set(on_block)) == [180, 360, 720] and len(on_block) == 48
    assert not any(b.trains_on_residuals() for b in blocks if b.trains_on_block_kernels())
    assert all(b.dim == 1440 and not b.trains_on_split_kernels() for b in blocks
               if not b.trains_on_block_kernels())


# (H, C, hidden, heads) of the full-size path's blocks at WIN 16
SEQ_BLOCKS = [(128, 180, 720, 6), (64, 360, 1440, 12)]
SPLIT_BLOCKS = [(32, 720, 2880, 24), (16, 1440, 5760, 48)]


def test_every_scaled_plan_exists_and_fits():
    for H, C, hidden, heads in SEQ_BLOCKS:
        p = twa.block_seq_plan(H, H, C, hidden, 16, heads)
        Kp = p["Kp"]
        assert Kp % 16 == 0 and C <= Kp < C + 64 and p["attn_smem"] <= twa.SMEM_MAX
        for split, product, K in (("ksq", "qkv", Kp), ("ksp", "proj", Kp), ("ks1", "fc1", Kp),
                                  ("ks2", "fc2", hidden)):
            ks = p[split]
            assert K % (16 * ks) == 0 and 128 % ks == 0
            assert p["smem_" + product] == twa.mlp_smem(K // ks) <= twa.SMEM_MAX
    assert twa.block_seq_plan(128, 128, 180, 720, 16, 6)["Kp"] == 192
    assert twa.block_seq_plan(64, 64, 360, 1440, 16, 12)["Kp"] == 384
    for H, C, hidden, heads in SPLIT_BLOCKS:
        w = twa.wmsa_plan(H, H, C, heads, 16)
        for ks, smem in ((w["ksq"], w["smem_qkv"]), (w["ks"], w["smem_proj"])):
            assert C % (16 * ks) == 0 and smem == twa.mlp_smem(C // ks) <= twa.SMEM_MAX
        assert w["ctas_attn"] == twa.PLAN_BATCH * (H // 16) ** 2 * heads * 4
        m = twa.mlp_plan(H * H, C, hidden)
        assert max(m["smem_fc1"], m["smem_fc2"]) <= twa.SMEM_MAX
        assert C % (16 * m["ks1"]) == 0 and hidden % (16 * m["ks"]) == 0
    # fc1's unsplit 64 x 1440 operand does not fit: fc1 on a K split of 2
    assert twa.mlp_plan(256, 1440, 5760) == {
        "ks": 8, "ks1": 2, "smem_fc1": 165888, "smem_fc2": 165888,
        "ctas_fc1": 1440, "ctas_fc2": 1536}
    p = tup.up4_plan(180, 1)
    assert p["Cp"] == 192 and p["smem"] == tup.up4_smem(192, 1, p["T"]) <= twa.SMEM_MAX
    assert twa.attn_big_smem(256, 30) <= 48 * 1024   # d = 30 pads to 32


def test_default_config_plans_keep_their_values():
    """Config()'s plans as they were before the scaled forms (written down
    from the code that produced the default model's kernel bits)."""
    assert {C: twa.block_plan(H, H, C, 4 * C, 8, 8)
            for H, C in ((64, 96), (32, 192), (16, 384))} == {
        96: {"G": 1, "smem": 199680, "ctas_per_image": 64},
        192: {"G": 2, "smem": 207872, "ctas_per_image": 32},
        384: {"G": 8, "smem": 218112, "ctas_per_image": 32}}
    assert twa.mlp_plan(64, 768, 3072) == {"ks": 4, "ks1": 1, "smem_fc1": 165888,
                                           "smem_fc2": 165888, "ctas_fc1": 96, "ctas_fc2": 96}
    assert twa.wmsa_plan(8, 8, 768, 8, 8) == {
        "ksq": 1, "ks": 4, "smem_qkv": 165888, "smem_proj": 92160, "ctas_qkv": 72,
        "ctas_attn": 32, "ctas_proj": 96}
    assert tup.up4_plan(96, 1) == {"T": 2, "smem": 214016, "Cp": 96}
    assert tup.up4_plan(96, 3) == {"T": 2, "smem": 230400, "Cp": 96}
    model = build_model(tconfig.Config(), device="meta")
    assert model.expected_launches((4, 256, 256, 3)) == {
        "fused_swin_block": 16, "fused_swin_block_chain": 32, "fused_ln_window_attention": 24,
        "fused_ln_mlp": 24, "fused_dual_upsample4_conv_phase": 1, "fused_dual_upsample4": 0}


@pytest.mark.parametrize("args,match", [
    ((128, 128, 180, 720, 8, 6), "cluster form"),          # 64 tokens: block_plan's
    ((128, 128, 180, 720, 32, 6), "window of 1024 tokens"),
    ((128, 128, 192, 768, 16, 2), "head dim 96"),
    ((128, 128, 90, 360, 16, 3), "multiple of 4"),
    ((120, 120, 180, 720, 16, 6), "not divisible"),
])
def test_block_seq_plan_refuses_shapes_outside_the_design(args, match):
    with pytest.raises(ValueError, match=match):
        twa.block_seq_plan(*args)


def _roll_rows(B, H, W, shift):
    """The rows of an NHWC map (as flat token indices) that the rows of the
    map rolled by -shift hold: gemm_tile.cuh's roll_row, in numpy."""
    r = np.arange(B * H * W)
    b, y, x = r // (H * W), (r // W) % H, r % W
    return b * H * W + ((y + shift) % H) * W + (x + shift) % W


@pytest.mark.parametrize("shift", [0, 8])
def test_roll_rows_are_the_sw_roll(shift):
    B, H, W = 2, 32, 48
    x = torch.arange(B * H * W).reshape(B, H, W, 1)
    rolled = torch.roll(x, (-shift, -shift), (1, 2)).reshape(-1)
    assert np.array_equal(rolled.numpy(), _roll_rows(B, H, W, shift))


def _arrays(rng, C, heads, N, hidden):
    n = lambda *s, sd=1.0: (rng.standard_normal(s) * sd).astype(np.float32)
    return [1 + n(C, sd=0.1), n(C, sd=0.1), n(C, 3 * C, sd=C ** -0.5), n(3 * C, sd=0.1),
            n(C, C, sd=C ** -0.5), n(C, sd=0.1), 1 + n(C, sd=0.1), n(C, sd=0.1),
            n(C, hidden, sd=C ** -0.5), n(hidden, sd=0.1), n(hidden, C, sd=hidden ** -0.5),
            n(C, sd=0.1), n(heads, N, N)]


def _padded(w: torch.Tensor) -> torch.Tensor:
    """A weight matrix as the model's weight cache stores it (columns
    zero-padded to multiples of 8, ``twa.wcols``)."""
    return F.pad(w, (0, twa.wcols(w.shape[1]) - w.shape[1]))


def test_swin_block_n256_plain_matches_jax():
    """#1 at head dim 30, 256-token windows, shift 8, C=60: the port's plain
    version, given the weights in the kernels' padded layout, against the
    JAX kernel; it stands in for the sequence form's five launches."""
    rng = np.random.default_rng(60)
    B, H, C, heads, ws, ss = 1, 32, 60, 2, 16, 8
    p = _arrays(rng, C, heads, ws * ws, 4 * C)
    x = rng.standard_normal((B, H, H, C)).astype(np.float32)
    mask = shift_attn_mask(H, H, ws, ss)
    kw = dict(ws=ws, num_heads=heads, scale=SCALE, shift=ss)
    j = [jnp.asarray(a) for a in p]
    ref = jwa.fused_swin_block(jnp.asarray(x), (j[0], j[1]), *j[2:6], (j[6], j[7]), *j[8:13],
                               jnp.asarray(mask), **kw)
    t = [torch.from_numpy(a) for a in p]
    t[2], t[4], t[10] = _padded(t[2]), _padded(t[4]), _padded(t[10])
    assert tuple(t[2].shape) == (60, 184)
    c = _build.counter("fused_swin_block")
    before = c.cpu
    got = twa.fused_swin_block(torch.from_numpy(x), (t[0], t[1]), *t[2:6], (t[6], t[7]),
                               *t[8:13], torch.from_numpy(mask), **kw)
    assert c.cpu == before + twa.SWIN_BLOCK_SEQ_LAUNCHES
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_ln_window_attention_n256_plain_matches_jax():
    """#3 at head dim 30 over one 256-token window (C=120, 4 heads)."""
    rng = np.random.default_rng(61)
    B, H, C, heads, ws = 1, 16, 120, 4, 16
    p = _arrays(rng, C, heads, ws * ws, 4 * C)
    x = rng.standard_normal((B, H, H, C)).astype(np.float32)
    kw = dict(ws=ws, num_heads=heads, scale=SCALE)
    args = (p[0], p[1], p[2], p[3], p[4], p[5], p[12])
    ref = jwa.fused_ln_window_attention(jnp.asarray(x), *[jnp.asarray(a) for a in args], None,
                                        **kw)
    got = twa.fused_ln_window_attention(torch.from_numpy(x),
                                        *[torch.from_numpy(a) for a in args], None, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_ln_mlp_c1440_plain_matches_jax():
    """#4 at the full size's widest stage, C=1440, hidden 5760."""
    rng = np.random.default_rng(62)
    C, hidden = 1440, 5760
    p = _arrays(rng, C, 48, 1, hidden)
    y = rng.standard_normal((1, 4, 4, C)).astype(np.float32)
    args = ((p[6], p[7]), p[8], p[9], p[10], p[11])
    ref = jwa.fused_ln_mlp(jnp.asarray(y), (jnp.asarray(p[6]), jnp.asarray(p[7])),
                           *[jnp.asarray(a) for a in args[1:]])
    got = twa.fused_ln_mlp(torch.from_numpy(y), (torch.from_numpy(p[6]), torch.from_numpy(p[7])),
                           *[torch.from_numpy(a) for a in args[1:]])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("out_ch", [1, 3])
def test_up4_conv_phase_c60_plain_matches_jax(out_ch):
    """#5 at C=60 (not a multiple of 16; the kernel pads it to 64)."""
    rng = np.random.default_rng(63 + out_ch)
    B, H, W, C = 1, 6, 8, 60
    n = lambda *s, sd=1.0: (rng.standard_normal(s) * sd).astype(np.float32)
    args = (n(B, H, W, C), n(C, 16 * C, sd=C ** -0.5), np.full((1,), 0.25, np.float32),
            n(C, C, sd=C ** -0.5), n(C, sd=0.1), np.full((1,), 0.1, np.float32),
            n(C, C, sd=C ** -0.5), n(C, C, sd=C ** -0.5),
            n(3, 3, C, out_ch, sd=(9 * C) ** -0.5))
    ref = jup.fused_dual_upsample4_conv_phase(*[jnp.asarray(a) for a in args])
    got = tup.fused_dual_upsample4_conv_phase(*[torch.from_numpy(a) for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert tup.up4_plan(C, out_ch)["Cp"] == 64


def _jax_cfg(backend):
    cfg = jconfig.scaled_config(**SHRUNK)
    return cfg.replace(tpu=cfg.tpu.__class__(compute_dtype="float32", attention_backend=backend))


@pytest.fixture(scope="module")
def jax_models():
    """The shrunk JAX SUNet on the XLA route and on the Pallas route with
    the same parameters, each traced by ``nnx.eval_shape`` (initialising it
    eagerly would compile every initialiser op on the CPU), the parameters
    from a numpy seed at the initialiser's scale plus noise (LayerNorm
    scales 1 and PReLU slopes 0.25 perturbed by N(0, 0.05), every other leaf
    N(0, 0.05), as ``tests/test_torch_port_tiled.py``); an input and the XLA
    route's output of it."""
    split = {b: nnx.split(nnx.eval_shape(lambda: jax_build_model(_jax_cfg(b), seed=3)),
                          nnx.Param) for b in ("xla", "pallas")}
    rng = np.random.default_rng(12)
    centre = {"scale": 1.0, "alpha": 0.25}

    def draw(path, leaf):
        c = centre.get(path[-2].key, 0.0)
        return jnp.asarray(c + rng.normal(0, 0.05, leaf.shape).astype(np.float32))

    params = jax.tree_util.tree_map_with_path(draw, split["xla"][1])
    xla, pallas = (nnx.merge(split[b][0], params) for b in ("xla", "pallas"))
    x = np.random.default_rng(9).random((1, 128, 128, 3), np.float32)
    return xla, pallas, x, np.asarray(_jax_forward(xla, x))


def _jax_forward(model, x):
    gd, state = nnx.split(model, nnx.Param)
    return jax.jit(lambda s, x: nnx.merge(gd, s)(x))(state, jnp.asarray(x))


def _port(backend, jmodel):
    cfg = tconfig.scaled_config(**SHRUNK).replace(compute_dtype="float32")
    model = build_model(cfg, device="cpu", backend=backend, seed=0)
    return load_reference_state_dict(model, params_to_state_dict(jmodel))


@pytest.mark.parametrize("caps", ["default", "lowered"])
def test_scaled_slice_matches_jax(jax_models, caps, monkeypatch):
    """The whole shrunk slice, port fused (the plain versions on the CPU)
    and port eager against JAX. ``default``: the routing caps as they are,
    against JAX pallas: #1's sequence form at C=60 and, W->SW chained,
    C=120 (chains start at C=120 here: ROUTE_PAIR_MIN_C lowered on both
    sides); #3 + #4 at C=240 (8 heads give no cluster size: the split
    kernels, where JAX runs its block kernel) and C=480; and port eager
    against JAX xla. ``lowered``: ROUTE_BLOCK_MAX_C at 32, so #3 + #4 run
    every block, at 256 tokens too, against JAX xla (the Pallas route
    interpreted once is enough of this file's time). The launch counters
    equal expected_launches."""
    monkeypatch.setenv("SUNET_PAIR_MIN_C", "120")
    monkeypatch.setattr(tlayers, "ROUTE_PAIR_MIN_C", 120)
    if caps == "lowered":
        monkeypatch.setattr(tlayers, "ROUTE_BLOCK_MAX_C", 32)
    xla, pallas, x, want_xla = jax_models
    fused = _port("fused", pallas)
    _build.reset_counts()
    with torch.inference_mode():
        got = fused(torch.from_numpy(x))
    calls = {k: _build.counter(k).cpu for k in INFER_WRAPPERS}
    expected = fused.expected_launches(x.shape)
    assert calls == expected
    if caps == "default":
        assert expected["fused_swin_block"] == 4 * twa.SWIN_BLOCK_SEQ_LAUNCHES
        assert expected["fused_swin_block_chain"] == 4 * twa.SWIN_BLOCK_SEQ_LAUNCHES
        assert expected["fused_ln_window_attention"] == 6 * twa.LN_WMSA_LAUNCHES
    else:
        assert expected["fused_swin_block"] == expected["fused_swin_block_chain"] == 0
        assert expected["fused_ln_window_attention"] == 14 * twa.LN_WMSA_LAUNCHES
    assert not any(_build.counter(k).cuda for k in INFER_WRAPPERS)
    if caps == "default":
        np.testing.assert_allclose(got.numpy(), np.asarray(_jax_forward(pallas, x)), **SLICE_TOL)
        eager = _port("eager", xla)
        with torch.inference_mode():
            np.testing.assert_allclose(eager(torch.from_numpy(x)).numpy(), want_xla, **SLICE_TOL)
    else:
        np.testing.assert_allclose(got.numpy(), want_xla, **SLICE_TOL)


def _stub_library(monkeypatch) -> dict:
    """Stub the kernel library (each C entry's call recorded, tensors as
    they are handed over) and the wrappers' CUDA device check."""
    calls = {}

    class Lib:
        def __getattr__(self, fn):
            def call(*args):
                assert len(args) == len(_build.SIGNATURES[fn]), (fn, len(args))
                calls[fn] = args
                return 0
            return call

    monkeypatch.setattr(_build, "library", lambda: Lib())
    monkeypatch.setattr(_build, "stream", lambda: None)
    monkeypatch.setattr(_build, "ptr", lambda t: t)
    monkeypatch.setattr(twa, "_check_x", lambda *a: None)
    return calls


@pytest.mark.parametrize("H,C,heads,shift", [(128, 180, 6, 8), (64, 360, 12, 0)])
def test_seq_form_launch_takes_its_plan_and_padded_weights(H, C, heads, shift, monkeypatch):
    """The sequence form's C entry gets block_seq_plan's depth and K splits,
    no drop-path scales in inference, and wqkv, wproj and w2 with their
    columns zero-padded to multiples of 8
    (padded here when given at their natural shape, taken as they are when
    the model's cache padded them)."""
    calls = _stub_library(monkeypatch)
    B, ws, hidden = 2, 16, 4 * C
    g = torch.Generator().manual_seed(0)
    w = lambda i, o: torch.randn(i, o, generator=g).to(torch.bfloat16)
    v = lambda n: torch.zeros(n)
    x = torch.zeros(B, H, H, C, dtype=torch.bfloat16)
    wqkv, wproj, w1, w2 = w(C, 3 * C), w(C, C), w(C, hidden), w(hidden, C)
    mask = torch.zeros((H // ws) ** 2, 256, 256) if shift else None
    kw = dict(ws=ws, num_heads=heads, scale=SCALE, shift=shift)
    twa._launch_block_seq(x, (v(C), v(C)), wqkv, v(3 * C), wproj, v(C), (v(C), v(C)), w1,
                          v(hidden), w2, v(C), torch.zeros(heads, 256, 256), mask, **kw)
    args = calls["sunet_swin_block_seq"]
    plan = twa.block_seq_plan(H, H, C, hidden, ws, heads)
    # the inference form: no drop-path scales (dp NULL, pointer 16)
    assert args[16] is None
    assert args[18:26] == (B, H, H, C, hidden, ws, heads, shift) and args[26] == SCALE
    assert args[27:32] == (plan["Kp"], plan["ksq"], plan["ksp"], plan["ks1"], plan["ks2"])
    for got, natural in ((args[4], wqkv), (args[6], wproj), (args[12], w2)):
        cols = natural.shape[1]
        assert tuple(got.shape) == (natural.shape[0], twa.wcols(cols)) and got.is_contiguous()
        assert torch.equal(got[:, :cols], natural) and not got[:, cols:].any()
    assert args[10] is w1
    padded = [_padded(t) for t in (wqkv, wproj, w2)]
    twa._launch_block_seq(x, (v(C), v(C)), padded[0], v(3 * C), padded[1], v(C), (v(C), v(C)),
                          w1, v(hidden), padded[2], v(C), torch.zeros(heads, 256, 256), mask, **kw)
    args = calls["sunet_swin_block_seq"]
    assert args[4] is padded[0] and args[6] is padded[1] and args[12] is padded[2]


def test_scaled_ln_mlp_and_head_launches(monkeypatch):
    """#4 at C=1440 hands its C entry fc1's and fc2's K splits (2, 8); #5 at
    C=180 hands its entry x's own 180 and its weights zero-padded to 192
    (``up4_conv_operands``). The launches run on meta tensors with the
    library stubbed."""
    calls = _stub_library(monkeypatch)
    monkeypatch.setattr(tup, "_check_x", lambda *a: None)
    C = 1440
    m = lambda *s: torch.zeros(*s, dtype=torch.bfloat16, device="meta")
    f = lambda n: torch.zeros(n, device="meta")
    twa.fused_ln_mlp(m(2, 16, 16, C), (f(C), f(C)), m(C, 4 * C), f(4 * C), m(4 * C, C), f(C))
    assert calls["sunet_ln_mlp"][9:14] == (2 * 256, C, 4 * C, 2, 8)
    C = 180
    tup.fused_dual_upsample4_conv_phase(m(2, 16, 16, C), m(C, 16 * C), f(1), m(C, C), f(C), f(1),
                                        m(C, C), m(C, C), m(3, 3, C, 1))
    got = calls["sunet_up4_conv_phase"]
    assert got[9:15] == (2, 16, 16, C, 1, tup.up4_plan(C, 1)["T"])
    assert [tuple(t.shape) for t in got[2:7]] == [(16, 192, 192), (192, 192), (192,),
                                                  (192, 192), (192, 192)]
    g = torch.Generator().manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=g).to(torch.bfloat16)
    w_exp, w_b1, b_b1, wpf, wbf = r(C, 16 * C), r(C, C), torch.randn(C), r(C, C), r(C, C)
    wexp_s, wb1p, bb1p, wpfp, wbfp = tup.up4_conv_operands(w_exp, w_b1, b_b1, wpf, wbf, 192)
    assert torch.equal(wexp_s[:, :C, :C], w_exp.reshape(C, C, 16).permute(2, 0, 1))
    assert not wexp_s[:, C:].any() and not wexp_s[:, :, C:].any()
    for t, natural in ((wb1p, w_b1), (wpfp, wpf), (wbfp, wbf)):
        assert torch.equal(t[:C, :C], natural) and not t[C:].any() and not t[:, C:].any()
    assert torch.equal(bb1p[:C], b_b1) and not bb1p[C:].any() and bb1p.dtype == torch.float32
