"""The float32 route of the port on the CPU (ROADMAP B2, serving half).

A float32 model's fused inference runs the float32 forms of #1-#5
(csrc/f32_swin_block.cu, csrc/f32_block.cu, csrc/f32_up4.cu) on the card;
here, where there is no
card, the plans, the dtype gate, the routes and launch counts, the
arguments each C entry gets (the kernel library stubbed, meta tensors), and
the TF32 guards of a float32 model's forward and training step. The
float32 plain versions are held against the JAX kernels in
``test_torch_port_kernels.py``; the kernels against them on the card in
``chip_smoke.py``'s fp32 phase.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sunet_tf_tpu_torch.config import Config, scaled_config, tiny_config
from sunet_tf_tpu_torch.kernels import _build
from sunet_tf_tpu_torch.kernels import upsample as tup
from sunet_tf_tpu_torch.kernels import window_attention as twa
from sunet_tf_tpu_torch.models import layers as tlayers
from sunet_tf_tpu_torch.models.sunet import INFER_WRAPPERS, build_model
from sunet_tf_tpu_torch.train.loop import build_steps

F32, BF16 = torch.float32, torch.bfloat16


def _stages(cfg):
    """(H, C, hidden, ws, heads) of each encoder stage at the config's size
    (the decoder's blocks repeat these shapes)."""
    sw = cfg.swinunet
    res = sw.img_size // sw.patch_size
    for i, heads in enumerate(sw.head_num):
        h, C = res // 2 ** i, sw.emb_dim * 2 ** i
        yield h, C, int(C * sw.mlp_ratio), min(sw.win_size, h), heads


def test_float32_plans_of_the_default_model_fit_and_take_no_batch():
    """Every float32 plan of ``Config()``'s inference shapes fits a CTA's
    shared memory, and a plan is a function of one image's shape (no batch
    among its arguments): an image gets the same bits at any batch."""
    for plan in (twa.f32_block_plan, twa.f32_wmsa_plan, twa.f32_mlp_plan, tup.f32_up4_plan):
        assert "B" not in inspect.signature(plan).parameters
    seen = 0
    for H, C, hidden, ws, heads in _stages(Config()):
        if C <= twa.BLOCK_KERNEL_MAX_C:
            p = twa.f32_block_plan(H, H, C, hidden, ws, heads)
            assert p["smem"] <= twa.SMEM_MAX and C % p["Gc"] == 0
        else:
            p = twa.f32_wmsa_plan(H, H, C, heads, ws)
            q = twa.f32_mlp_plan(H * H, C, hidden)
            assert max(p["smem_gemm"], p["smem_attn"], q["smem_gemm"]) <= twa.SMEM_MAX
        seen += 1
    head = tup.f32_up4_plan(64, 64, 96, 1)
    assert max(head["smem_gemm"], head["smem_conv"]) <= twa.SMEM_MAX
    assert seen == 4


@pytest.mark.parametrize("args,match", [
    ((64, 64, 96, 384, 16, 8), "window of 256 tokens"),
    ((64, 64, 100, 400, 8, 4), "multiple of 16"),
    ((16, 16, 768, 3072, 8, 8), "widths the kernel is built for"),
    ((16, 16, 384, 1536, 8, 5), "multiple of 16 and of heads"),
])
def test_float32_block_plan_refuses_shapes_outside_the_design(args, match):
    with pytest.raises(ValueError, match=match):
        twa.f32_block_plan(*args)


def _stub_library(monkeypatch) -> dict:
    """The kernel library stubbed (each C entry's arguments recorded and
    held to its ctypes signature's length; workspaces of 4096 bytes), the
    wrappers' CUDA device check off: the launches run on meta tensors."""
    calls = {}

    class Lib:
        def __getattr__(self, fn):
            def call(*args):
                assert len(args) == len(_build.SIGNATURES[fn]), (fn, len(args))
                calls.setdefault(fn, []).append(args)
                return 4096 if fn.endswith("_workspace") else 0
            return call

    monkeypatch.setattr(_build, "library", lambda: Lib())
    monkeypatch.setattr(_build, "stream", lambda: None)
    monkeypatch.setattr(_build, "ptr", lambda t: t)
    monkeypatch.setattr(twa, "_check_x", lambda *a: None)
    monkeypatch.setattr(tup, "_check_x", lambda *a: None)
    return calls


def _meta(*shape, dtype=F32):
    return torch.zeros(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("B", [1, 2, 4, 8])
def test_float32_entries_get_one_images_plan_at_any_batch(B, monkeypatch):
    """Each float32 wrapper hands its C entry the batch only as B, takes
    the plan of one image's shape (the same at batches 1, 2, 4 and 8), and
    the head its w_exp in subpixel-major columns."""
    calls = _stub_library(monkeypatch)
    planned = []
    for mod, name in ((twa, "f32_block_plan"), (twa, "f32_wmsa_plan"), (twa, "f32_mlp_plan"),
                      (tup, "f32_up4_plan")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, real=real, name=name: (
            planned.append((name, a)), real(*a))[1])
    v = lambda n: _meta(n)
    for H, C, hidden, ws, heads in _stages(Config()):
        x = _meta(B, H, H, C)
        if C <= twa.BLOCK_KERNEL_MAX_C:
            twa.fused_swin_block(x, (v(C), v(C)), _meta(C, 3 * C), v(3 * C), _meta(C, C), v(C),
                                 (v(C), v(C)), _meta(C, hidden), v(hidden), _meta(hidden, C),
                                 v(C), _meta(heads, 64, 64), _meta((H // 8) ** 2, 64, 64),
                                 ws=ws, num_heads=heads, scale=8.0, shift=4)
            args = calls["sunet_f32_block"][-1]
            assert args[16:24] == (B, H, H, C, hidden, ws, heads, 4) and args[24] == 8.0
        else:
            twa.fused_ln_window_attention(x, v(C), v(C), _meta(C, 3 * C), v(3 * C), _meta(C, C),
                                          v(C), _meta(heads, 64, 64), None, ws=ws,
                                          num_heads=heads, scale=8.0)
            assert calls["sunet_f32_ln_wmsa"][-1][11:17] == (B, H, H, C, ws, heads)
            twa.fused_ln_mlp(x, (v(C), v(C)), _meta(C, hidden), v(hidden), _meta(hidden, C), v(C))
            assert calls["sunet_f32_ln_mlp"][-1][9:12] == (B * H * H, C, hidden)
    C = 96
    tup.fused_dual_upsample4_conv_phase(_meta(B, 64, 64, C), _meta(C, 16 * C), v(1),
                                        _meta(C, C), v(C), v(1), _meta(C, C), _meta(C, C),
                                        _meta(3, 3, C, 3))
    args = calls["sunet_f32_up4_conv"][-1]
    assert args[10:15] == (B, 64, 64, C, 3) and tuple(args[2].shape) == (C, 16 * C)
    assert planned == [("f32_block_plan", (64, 64, 96, 384, 8, 8)),
                       ("f32_block_plan", (32, 32, 192, 768, 8, 8)),
                       ("f32_block_plan", (16, 16, 384, 1536, 8, 8)),
                       ("f32_wmsa_plan", (8, 8, 768, 8, 8)),
                       ("f32_mlp_plan", (64, 768, 3072)),
                       ("f32_up4_plan", (64, 64, 96, 3))]
    assert not any(fn.startswith("sunet_") and not fn.startswith("sunet_f32") for fn in calls)


def test_float32_head_weights_go_subpixel_major():
    """Column s * C + c of the float32 head's w_exp is column c * 16 + s of
    the model's (the pixel-shuffle expand's layout)."""
    C = 8
    w = torch.arange(C * 16 * C, dtype=F32).reshape(C, 16 * C)
    got = tup.f32_up4_wexp(w)
    for s in (0, 5, 15):
        for c in (0, 3, 7):
            assert torch.equal(got[:, s * C + c], w[:, c * 16 + s])
    assert got.is_contiguous()


TRAIN_NAMES = ("fused_swin_block_res", "swin_block_bwd", "swin_block_bwd_res",
               "ln_window_attention_bwd", "ln_mlp_branch", "ln_mlp_bwd", "up4_conv_bwd",
               "up4_bwd")


@pytest.mark.parametrize("name,dtype,kw,item", [
    *[(n, BF16, {}, None) for n in INFER_WRAPPERS + TRAIN_NAMES],
    *[(n, F32, {"tokens": 64}, None) for n in twa.F32_WRAPPERS],
    ("fused_swin_block", F32, {"tokens": 16}, None),
    ("fused_swin_block", F32, {"tokens": 256}, twa.F32_SEQ_ITEM),
    ("fused_swin_block_chain", F32, {"tokens": 256}, twa.F32_SEQ_ITEM),
    ("fused_ln_window_attention", F32, {"tokens": 256}, twa.F32_SEQ_ITEM),
    ("fused_swin_block", F32, {"tokens": 64, "train": True}, twa.F32_TRAIN_ITEM),
    ("fused_ln_window_attention", F32, {"train": True}, twa.F32_TRAIN_ITEM),
    ("fused_dual_upsample4_conv_phase", F32, {"train": True}, twa.F32_TRAIN_ITEM),
    *[(n, F32, {}, twa.F32_TRAIN_ITEM) for n in TRAIN_NAMES],
    ("fused_dual_upsample4", F32, {}, twa.F32_SPLIT_HEAD_ITEM),
    ("wmsa_core", F32, {}, twa.F32_WMSA_CORE_ITEM),
    ("swin_block_trainable_dynmask", F32, {"train": True}, twa.F32_DYNMASK_ITEM),
    *[(n, torch.float16, {}, twa.F16_ITEM) for n in ("fused_swin_block", "fused_ln_mlp")],
    *[(n, torch.float64, {}, "float64 runs on the eager route")
      for n in ("fused_swin_block", "fused_dual_upsample4_conv_phase")],
])
def test_dtype_gate(name, dtype, kw, item):
    """The CUDA kernels take bfloat16 everywhere and float32 in the
    inference forms of #1-#5 at windows up to 64 tokens; every other call
    is refused with the ROADMAP item that would take it."""
    why = twa.dtype_why(name, dtype, **kw)
    if item is None:
        assert why is None
    else:
        assert why is not None and item in why and "backend='eager'" in why


def _routed_tiny(monkeypatch, dtype: str):
    """``tiny_config()`` on every inference route: C=16 blocks alone, C=32
    chains, C=64 and 128 on the LN+W-MSA and LN+MLP kernels."""
    monkeypatch.setattr(tlayers, "ROUTE_PAIR_MIN_C", 32)
    monkeypatch.setattr(tlayers, "ROUTE_BLOCK_MAX_C", 32)
    return build_model(tiny_config().replace(compute_dtype=dtype), device="cpu",
                       backend="fused", seed=0)


def test_float32_model_calls_each_wrapper_as_bf16_does(monkeypatch):
    """The routes do not depend on the dtype (JAX ``layers.py``): a float32
    fused model calls each inference wrapper as often as the bf16 model,
    and its CPU run counts what ``expected_launches`` gives, each float32
    form launching as many kernels as its bf16 form."""
    calls = {}
    for mod, name in [(twa, n) for n in INFER_WRAPPERS[:4]] + [(tup, INFER_WRAPPERS[4]),
                                                                (tup, INFER_WRAPPERS[5])]:
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, real=real, name=name, **k: (
            calls.__setitem__(name, calls.get(name, 0) + 1), real(*a, **k))[1])
    x = torch.from_numpy(np.random.default_rng(4).random((2, 64, 64, 3), np.float32))
    per_dtype = {}
    for dtype in ("bfloat16", "float32"):
        model = _routed_tiny(monkeypatch, dtype)
        calls.clear()
        want = model.expected_launches(tuple(x.shape))
        _build.reset_counts()
        with torch.inference_mode():
            y = model(x)
        assert y.dtype == F32 and bool(torch.isfinite(y).all())
        assert {k: _build.counter(k).cpu for k in want} == want
        assert not any(_build.counter(k).cuda for k in want)
        per_dtype[dtype] = (dict(calls), want)
    (c16, w16), (c32, w32) = per_dtype["bfloat16"], per_dtype["float32"]
    assert c16 == c32
    assert set(c32) == set(INFER_WRAPPERS) - {"fused_dual_upsample4"}
    assert w32 == w16
    assert w32["fused_swin_block"] == c32["fused_swin_block"]
    assert w32["fused_swin_block_chain"] == 2 * c32["fused_swin_block_chain"]
    assert w32["fused_ln_window_attention"] == (c32["fused_ln_window_attention"]
                                                * twa.LN_WMSA_LAUNCHES)
    assert w32["fused_ln_mlp"] == c32["fused_ln_mlp"] * twa.LN_MLP_LAUNCHES
    assert w32["fused_dual_upsample4_conv_phase"] == 1


def test_fused_why_names_what_float32_does_not_run():
    """The model refuses, before any kernel launches, a float32 fused
    training forward, windows above 64 tokens and the split x4 head, each
    with its ROADMAP item; bf16 and the eager route run everything."""
    f32 = build_model(tiny_config().replace(compute_dtype="float32"), device="meta")
    assert f32.fused_why() is None
    assert twa.F32_TRAIN_ITEM in f32.fused_why(train=True)
    assert build_model(tiny_config(), device="meta").fused_why(train=True) is None
    big = build_model(scaled_config().replace(compute_dtype="float32"), device="meta")
    assert twa.F32_SEQ_ITEM in big.fused_why()
    bands = tiny_config().replace(compute_dtype="float32")
    bands = dataclasses.replace(bands, swinunet=dataclasses.replace(bands.swinunet,
                                                                     out_chans=16))
    assert twa.F32_SPLIT_HEAD_ITEM in build_model(bands, device="meta").fused_why()
    eager = build_model(scaled_config().replace(compute_dtype="float32"), device="meta",
                        backend="eager")
    assert eager.fused_why(train=True) is None


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


@pytest.fixture
def tf32_flags():
    """Both TF32 flags set as the card's defaults set cuDNN's (on), restored
    after the test."""
    old = _flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _conv_flags(monkeypatch, seen: list, fail: bool = False):
    """F.conv2d recording the flags it runs under (and raising, ``fail``)."""
    real = F.conv2d

    def conv(*a, **k):
        seen.append(_flags())
        if fail:
            raise RuntimeError("conv failed")
        return real(*a, **k)

    monkeypatch.setattr(F, "conv2d", conv)


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_float32_forward_runs_without_tf32(backend, monkeypatch, tf32_flags):
    """A float32 model's forward runs its convolutions with TF32 off in
    cuBLAS and cuDNN and gives the caller's flags back, also when it
    raises; a bf16 model leaves them as it finds them."""
    x = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    f32 = build_model(tiny_config().replace(compute_dtype="float32"), device="cpu",
                      backend=backend)
    seen = []
    _conv_flags(monkeypatch, seen)
    with torch.inference_mode():
        f32(x)
    assert seen and set(seen) == {(False, False)}
    assert _flags() == (True, True)
    torch.backends.cuda.matmul.allow_tf32 = False   # a caller's own mix
    bf16 = build_model(tiny_config(), device="cpu", backend=backend)
    seen.clear()
    with torch.inference_mode():
        bf16(x)
    # the stem's convolution (the fused route's head on the CPU runs a
    # plain version, which sets its own flags inside)
    assert seen[0] == (False, True)
    assert _flags() == (False, True)
    torch.backends.cuda.matmul.allow_tf32 = True
    _conv_flags(monkeypatch, seen, fail=True)
    with pytest.raises(RuntimeError, match="conv failed"), torch.inference_mode():
        f32(x)
    assert _flags() == (True, True)


class _KeepGrads:
    """An optimizer that zeroes the gradients and takes no step."""

    def __init__(self, params):
        self.params = list(params)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def step(self):
        pass


def _step(model, fail: bool = False) -> list:
    """One training step of ``model`` through ``build_steps``; returns the
    flags its backward ran under, read by a hook on the stem's output (and
    raising there, ``fail``)."""
    seen = []
    stem = model._stem

    def hooked(x):
        y = stem(x)

        def hook(g):
            seen.append(_flags())
            if fail:
                raise RuntimeError("backward failed")
            return g
        y.register_hook(hook)
        return y

    model._stem = hooked
    model.train().requires_grad_(True)
    steps = build_steps(model, _KeepGrads(model.parameters()), task="denoise", seed=3)
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8))
             for k in ("input", "target")}
    steps.train_step(batch, 0, None)
    return seen


def test_float32_training_step_runs_its_backward_without_tf32(tf32_flags):
    """The train loop's step holds TF32 off over a float32 model's backward
    too (autograd runs it after the forward has returned), gives the
    caller's flags back, also when the backward raises; a bf16 model's step
    leaves them as they are."""
    cfg = tiny_config().replace(compute_dtype="float32")
    model = build_model(cfg, device="cpu", backend="eager")
    assert _step(model) == [(False, False)]
    assert _flags() == (True, True)
    assert all(p.grad is not None for n, p in model.named_parameters() if n != "prelu.weight")
    with pytest.raises(RuntimeError, match="backward failed"):
        _step(build_model(cfg, device="cpu", backend="eager"), fail=True)
    assert _flags() == (True, True)
    assert _step(build_model(tiny_config(), device="cpu", backend="fused")) == [(True, True)]
    assert _flags() == (True, True)


def test_float32_kernel_weights_are_contiguous_padded_and_cached():
    """The float32 copies of a block's and the head's weights are contiguous
    (in, out) matrices with their columns padded to ``wcols`` (zeros), built
    once per dtype and parameter version."""
    blk = tlayers.SwinBlock(20, (8, 8), 2, window_size=4, shift_size=0)
    torch.manual_seed(0)
    for p in blk.parameters():
        p.data.normal_()
    p32 = blk.kernel_params(F32)
    assert blk.kernel_params(F32) is p32 and blk.kernel_params(BF16) is not p32
    for i, (lin, cols) in {2: (blk.attn.qkv, 60), 4: (blk.attn.proj, 20), 8: (blk.mlp.fc1, 80),
                           10: (blk.mlp.fc2, 20)}.items():
        w = p32[i]
        assert w.dtype == F32 and w.is_contiguous() and tuple(w.shape) == (lin.in_features,
                                                                            twa.wcols(cols))
        assert torch.equal(w[:, :cols], lin.weight.t()) and not w[:, cols:].any()
    with torch.no_grad():
        blk.attn.qkv.weight.add_(1.0)
    assert blk.kernel_params(F32) is not p32
    up = tlayers.DualUpsample(16, 4)
    head = up._kernel_params(F32)
    assert up._kernel_params(F32) is head
    assert all(t.is_contiguous() for t in head)
    assert torch.equal(head[0], up.up_p[0].kernel())
