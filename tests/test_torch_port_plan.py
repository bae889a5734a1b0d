"""Launch plans of the cluster kernels (csrc/swin_cluster.cu for the
whole-block kernel #1/#2, csrc/ln_mlp.cu for the LN+MLP kernel #4), on the
CPU: plain Python that picks each width's cluster size and shared-memory
bytes from one image's shape, held to the design's limits, and the router
that sends a block the block kernel does not take to the split kernels. No
kernel runs here; the C entry points take the cluster size and lay out
their shared memory from the same constants."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from sunet_tf_tpu_torch.config import Config, tiny_config
from sunet_tf_tpu_torch.kernels import _build
from sunet_tf_tpu_torch.kernels import window_attention as wa
from sunet_tf_tpu_torch.models.sunet import build_model


def _bands():
    cfg = Config()
    return dataclasses.replace(cfg, swinunet=dataclasses.replace(cfg.swinunet, in_chans=16,
                                                                 out_chans=16))


def _stages(cfg, batch=4):
    """(B, H, C, hidden, ws, heads) of every stage of the encoder (the
    decoder's blocks repeat these widths), at the config's image size."""
    sw = cfg.swinunet
    res = sw.img_size // sw.patch_size
    for i, heads in enumerate(sw.head_num):
        h = res // 2 ** i
        C = sw.emb_dim * 2 ** i
        yield batch, h, C, int(C * sw.mlp_ratio), min(sw.win_size, h), heads


CONFIGS = {"Config()": Config, "16-band": _bands, "tiny_config()": tiny_config}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_every_width_has_a_plan_that_fits(name):
    for B, H, C, hidden, ws, heads in _stages(CONFIGS[name]()):
        if C <= wa.BLOCK_KERNEL_MAX_C and (ws * ws) % 16 == 0:
            p = wa.block_plan(H, H, C, hidden, ws, heads)
            G = p["G"]
            assert p["smem"] <= wa.SMEM_MAX, (C, p)
            assert heads % G == 0 and C % G == 0 and hidden % G == 0, (C, p)
            assert 1 <= G <= wa.CLUSTER_MAX and p["ctas_per_image"] == (H // ws) ** 2 * G
        else:
            p = wa.mlp_plan(H * H, C, hidden)
            assert max(p["smem_fc1"], p["smem_fc2"]) <= wa.SMEM_MAX, (C, p)
            assert hidden % (16 * p["ks"]) == 0 and 128 % p["ks"] == 0


def test_default_model_fills_the_card_at_batch_4():
    assert wa.PLAN_BATCH == 4
    got = {C: wa.block_plan(H, H, C, hidden, ws, heads)
           for _, H, C, hidden, ws, heads in _stages(Config()) if C <= wa.BLOCK_KERNEL_MAX_C}
    assert {C: p["G"] for C, p in got.items()} == {96: 1, 192: 2, 384: 8}
    assert 4 * got[384]["ctas_per_image"] >= 128
    assert all(4 * p["ctas_per_image"] >= wa.FILL_CTAS for p in got.values())
    mlp = wa.mlp_plan(8 * 8, 768, 3072)
    assert mlp["ks"] == 4 and mlp["ctas_fc1"] == mlp["ctas_fc2"] == 96


@pytest.mark.parametrize("args,match", [
    ((32, 32, 192, 768, 16, 8), "window of 256 tokens"),     # WIN 16
    ((8, 8, 768, 3072, 8, 8), "C above 384"),
    ((16, 16, 200, 800, 8, 8), "multiples of 16"),
    ((16, 16, 256, 1024, 8, 2), "head dim 128"),
    ((16, 16, 384, 3072, 8, 6), "no cluster size"),   # fc1 needs G >= 8; 6 heads
])
def test_block_plan_refuses_shapes_outside_the_design(args, match):
    with pytest.raises(ValueError, match=match):
        wa.block_plan(*args)


@pytest.mark.parametrize("args,match", [
    ((256, 2064, 8256), "does not fit"),
    ((256, 100, 400), "multiples of 16"),
    ((0, 768, 3072), "M > 0"),
])
def test_mlp_plan_refuses_shapes_outside_the_design(args, match):
    with pytest.raises(ValueError, match=match):
        wa.mlp_plan(*args)


def test_plans_do_not_depend_on_the_batch():
    """A plan is a function of one image's shape: the same image gives the
    same fp32 summation order, so the same bits, at any batch (the
    per-kernel checks on the card run batch 2, the main path batch 4)."""
    assert list(inspect.signature(wa.block_plan).parameters) == ["H", "W", "C", "hidden", "ws",
                                                                  "heads"]
    assert list(inspect.signature(wa.mlp_plan).parameters) == ["M", "C", "hidden"]
    for H, C in ((64, 96), (32, 192), (16, 384)):
        p = wa.block_plan(H, H, C, 4 * C, 8, 8)
        assert p["ctas_per_image"] == (H // 8) ** 2 * p["G"]


@pytest.mark.parametrize("C,heads,G", [(192, 3, 3), (384, 6, 6), (384, 12, 6), (96, 3, 1)])
def test_cluster_size_need_not_be_a_power_of_two(C, heads, G):
    """Head counts whose divisors are not powers of two still get a plan:
    G is any size up to CLUSTER_MAX that divides heads, C and hidden."""
    H = {96: 64, 192: 32, 384: 16}[C]
    p = wa.block_plan(H, H, C, 4 * C, 8, heads)
    assert p["G"] == G and p["smem"] <= wa.SMEM_MAX
    assert wa.block_kernel_takes(C, 4 * C, heads)


def test_router_sends_blocks_without_a_plan_to_the_split_kernels():
    """A block within the block-kernel cap that the kernel does not take
    (head dim 128 at C=128 with one head) runs the split LN+W-MSA / LN+MLP
    kernels in the forward, the chain route skips it, expected_launches
    predicts it, and the output agrees with the eager route (float32)."""
    cfg = tiny_config().replace(compute_dtype="float32")
    cfg = dataclasses.replace(cfg, swinunet=dataclasses.replace(cfg.swinunet,
                                                                head_num=(2, 2, 2, 1)))
    fused = build_model(cfg, device="cpu", backend="fused", seed=0)
    eager = build_model(cfg, device="cpu", backend="eager", seed=0)
    eager.load_state_dict(fused.state_dict())
    blocks = [b for stage in fused.layers for b in stage.blocks]
    assert [b.takes_block_kernel() for b in blocks] == [True] * 6 + [False] * 2
    x = torch.from_numpy(np.random.default_rng(3).random((2, 64, 64, 3), np.float32))
    want = fused.expected_launches(tuple(x.shape))
    _build.reset_counts()
    with torch.inference_mode():
        got = fused(x)
        ref = eager(x)
    calls = {k: _build.counter(k).cpu for k in want}
    assert calls == want
    # the C=128 stage's two blocks: LN_WMSA_LAUNCHES + 3 launches each, nothing on #1
    assert want["fused_ln_window_attention"] == 2 * wa.LN_WMSA_LAUNCHES
    assert want["fused_ln_mlp"] == 2 * wa.LN_MLP_LAUNCHES
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
