"""Launch plans and tile decompositions of the conv-fused x4 head's kernel
(#5, csrc/up4_conv.cu) and the LN+W-MSA kernel (#3,
csrc/ln_window_attention.cu), on the CPU: plain Python and plain torch that
mirror what the kernels do, held to shared memory, to a brute-force
derivation of the conv's reads and to the plain versions. No kernel runs
here."""

import dataclasses
import inspect
import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sunet_tf_tpu_torch.config import Config
from sunet_tf_tpu_torch.kernels import upsample as up
from sunet_tf_tpu_torch.kernels import window_attention as wa
from sunet_tf_tpu_torch.models import layers
from sunet_tf_tpu_torch.models.sunet import build_model

TH, TW = up.UP4_TILE


@pytest.mark.parametrize("C,out", list(itertools.product((96, 192), range(1, 9))))
def test_up4_plan_fits_shared_memory(C, out):
    p = up.up4_plan(C, out)
    assert p["T"] in (1, 2) and p["smem"] == up.up4_smem(C, out, p["T"]) <= wa.SMEM_MAX
    # two tiles per CTA wherever they fit
    assert p["T"] == 2 or up.up4_smem(C, out, 2) > wa.SMEM_MAX


def test_up4_plan_of_the_main_path_and_refusals():
    assert up.up4_plan(96, 1)["T"] == 2
    for C, out in ((90, 1), (208, 1), (96, 0), (96, 9)):
        with pytest.raises(ValueError, match="up4_plan"):
            up.up4_plan(C, out)


def test_up4_tile_rows_fit_one_wgmma_tile():
    """Every subpixel's rows (the tile's pixels and the halo pixels it
    takes) fit the 64 rows of one wgmma tile, each halo pixel once."""
    for i, j in itertools.product(range(4), repeat=2):
        rows = up.up4_tile_rows(i, j)
        assert len(rows) <= 64 and len({r for r, _ in rows}) == len(rows)
        pix = [p for _, p in rows]
        assert len(set(pix)) == len(pix)


def _conv_reads(H, W, ty0, tx0):
    """Brute force: the (low-res pixel, phase) pairs of the image whose
    full-res pixel a zero-padded 3x3 conv reads for the outputs at the
    tile's in-image pixels (every phase), from conv2d in pixel space."""
    mask = torch.zeros(1, 1, 4 * H, 4 * W, dtype=torch.float64)
    mask[..., 4 * ty0:4 * min(ty0 + TH, H), 4 * tx0:4 * min(tx0 + TW, W)] = 1
    reads = F.conv2d(mask, torch.ones(1, 1, 3, 3, dtype=torch.float64), padding=1)[0, 0] > 0
    return {((int(r) // 4 - ty0, int(c) // 4 - tx0), (int(r) % 4, int(c) % 4))
            for r, c in reads.nonzero()}


@pytest.mark.parametrize("H,W,ty0,tx0", [
    (14, 20, 0, 0),     # the image's top-left corner
    (14, 20, 6, 8),     # inside: every halo pixel in the image
    (14, 20, 12, 16),   # a partial tile at the bottom-right edge
    (6, 8, 0, 0),       # the image is one tile
])
def test_up4_halo_table_matches_a_brute_force_derivation(H, W, ty0, tx0):
    """The halo phases the kernel computes (csrc/up4_conv.cu::halo_src), less
    those of pixels outside the image (the conv's zero pad), are exactly the
    halo phases a 3x3 zero-padded conv reads; the tile's own pixels feed
    every phase."""
    inside = lambda y, x: 0 <= ty0 + y < H and 0 <= tx0 + x < W
    table = {(p, (i, j)) for i, j in itertools.product(range(4), repeat=2)
             for r, p in up.up4_tile_rows(i, j) if inside(*p)}
    want = _conv_reads(H, W, ty0, tx0)
    is_halo = lambda p: not (0 <= p[0] < TH and 0 <= p[1] < TW)
    assert {e for e in table if is_halo(e[0])} == {e for e in want if is_halo(e[0])}
    tile = {(y, x) for y in range(TH) for x in range(TW) if inside(y, x)}
    assert {e for e in want if not is_halo(e[0])} == {
        (p, (i, j)) for p in tile for i, j in itertools.product(range(4), repeat=2)}


def _head_args(B, H, W, C, out, seed):
    rng = np.random.default_rng(seed)
    n = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return (n(B, H, W, C), n(C, 16 * C) / C ** 0.5, torch.tensor([0.25]), n(C, C) / C ** 0.5,
            0.1 * n(C), torch.tensor([0.2]), n(C, C) / C ** 0.5, n(C, C) / C ** 0.5,
            n(3, 3, C, out) / (9 * C) ** 0.5)


def _emulate_tiles(x, w_exp, alpha_p, w_b1, b_b1, alpha_b, wpf, wbf, wconv):
    """#5's decomposition in plain torch (float32): per tile, xb over the
    1-pixel halo region at clamped pixels; per subpixel, the phase map of
    the rows :func:`up.up4_tile_rows` gives; its conv terms (each row, each
    tap) added to the tile's outputs in subpixel order."""
    B, H, W, C = x.shape
    out = wconv.shape[-1]
    wexp_s = w_exp.reshape(C, C, 16).permute(2, 0, 1)
    prelu = lambda v, a: torch.clamp_min(v, 0) + a * torch.clamp_max(v, 0)
    res = torch.zeros(B, H, W, 16 * out)
    taps = wconv.reshape(9, C, out)
    for b, ty0, tx0 in itertools.product(range(B), range(0, H, TH), range(0, W, TW)):
        px = lambda y, xx: x[b, min(max(ty0 + y, 0), H - 1), min(max(tx0 + xx, 0), W - 1)]
        ring = torch.stack([torch.stack([px(y, xx) for xx in range(-1, TW + 1)])
                            for y in range(-1, TH + 1)])
        xb = prelu(ring @ w_b1 + b_b1, alpha_b) @ wbf          # (TH+2, TW+2, C)
        acc = torch.zeros(TH, TW, 4, 4, out)
        for s in range(16):
            i, j = divmod(s, 4)
            rows = [p for _, p in up.up4_tile_rows(i, j)]
            X = torch.stack([px(y, xx) for y, xx in rows])
            P = prelu(X @ wexp_s[s], alpha_p) @ wpf
            for (y, xx), p in zip(rows, P):
                r, c = (y + (i >= 2), xx + (j >= 2))         # the stencil's lower taps
                a0, a1 = up.P4[i]
                b0, b1 = up.P4[j]
                st = (b0 * (a0 * xb[r, c] + a1 * xb[r + 1, c])
                      + b1 * (a0 * xb[r, c + 1] + a1 * xb[r + 1, c + 1]))
                if not (0 <= ty0 + y < H and 0 <= tx0 + xx < W):
                    continue                                   # the zero pad
                terms = torch.einsum("c,tco->to", p + st, taps)
                for t in range(9):
                    dy, dx = t // 3 - 1, t % 3 - 1
                    oy, ti = divmod(4 * y + i - dy, 4)
                    ox, tj = divmod(4 * xx + j - dx, 4)
                    if 0 <= oy < TH and 0 <= ox < TW:
                        acc[oy, ox, ti, tj] += terms[t]
        hh, ww = min(TH, H - ty0), min(TW, W - tx0)
        res[b, ty0:ty0 + hh, tx0:tx0 + ww] = acc[:hh, :ww].reshape(hh, ww, 16 * out)
    return res


def test_up4_tile_decomposition_matches_the_plain_version():
    """The tile decomposition (per-tile phase maps, halo rows by subpixel,
    the conv folded per phase) equals the plain version within float32
    summation order, on a map of 3 x 3 tiles whose last row and column are
    partial."""
    args = _head_args(1, 14, 20, 16, 2, seed=5)
    got = _emulate_tiles(*args)
    want = up.fused_dual_upsample4_conv_phase_reference(*args)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_wmsa_plan_does_not_depend_on_the_batch():
    assert list(inspect.signature(wa.wmsa_plan).parameters) == ["H", "W", "C", "heads", "ws"]
    p = wa.wmsa_plan(8, 8, 768, 8, 8)
    # the default model's C=768 stage: every product over >= 64 CTAs at
    # batch 4, each launch within one wave
    assert (p["ksq"], p["ks"]) == (1, 4)
    assert wa.FILL_CTAS > 64 and 64 <= p["ctas_qkv"] <= wa.WAVE_CTAS
    assert wa.FILL_CTAS <= p["ctas_proj"] <= wa.WAVE_CTAS


@pytest.mark.parametrize("H,C,heads,ws", [
    (8, 768, 8, 8), (16, 768, 8, 8), (16, 384, 2, 8), (16, 384, 6, 8), (8, 48, 3, 4),
    (8, 96, 12, 4), (4, 1024, 4, 4), (16, 16, 1, 8), (8, 2048, 16, 8),
])
def test_wmsa_plan_takes_every_shape_the_old_entry_took(H, C, heads, ws):
    """Windows of 16..64 tokens, C a multiple of 16 and of heads, any head
    dim: each gets a plan whose splits divide the products into whole k16
    steps and whose shared memory fits."""
    p = wa.wmsa_plan(H, H, C, heads, ws)
    for ks, smem in ((p["ksq"], p["smem_qkv"]), (p["ks"], p["smem_proj"])):
        assert C % (16 * ks) == 0 and smem == wa.mlp_smem(C // ks) <= wa.SMEM_MAX
    assert p["ctas_attn"] == wa.PLAN_BATCH * (H // ws) ** 2 * heads


@pytest.mark.parametrize("args,match", [
    ((64, 64, 192, 8, 32), "window of 1024 tokens"),
    ((8, 8, 200, 8, 8), "multiple of 16"),
    ((12, 12, 96, 8, 8), "not divisible"),
])
def test_wmsa_plan_refuses_shapes_outside_the_design(args, match):
    with pytest.raises(ValueError, match=match):
        wa.wmsa_plan(*args)


def test_expected_launches_of_the_default_model(monkeypatch):
    """Config() at 256x256, batch 4: the C=768 stage's 8 LN+W-MSA calls
    launch LN_WMSA_LAUNCHES kernels each in inference, and in training on
    the sublayer route (the training cap at 384; by default the stage
    trains on the block kernels, and no LN+W-MSA call is made); the x4 head
    one."""
    model = build_model(Config(), device="meta", backend="fused")
    infer = model.expected_launches((4, 256, 256, 3))
    assert wa.LN_WMSA_LAUNCHES == 3
    assert infer == {"fused_swin_block": 16, "fused_swin_block_chain": 32,
                     "fused_ln_window_attention": 24, "fused_ln_mlp": 24,
                     "fused_dual_upsample4_conv_phase": 1, "fused_dual_upsample4": 0}
    train = model.expected_launches((4, 256, 256, 3), train=True)
    assert train["fused_ln_window_attention"] == 0
    assert train["fused_dual_upsample4_conv_phase"] == 1
    monkeypatch.setattr(layers, "ROUTE_TRAIN_BLOCK_MAX_C", 384)
    train = model.expected_launches((4, 256, 256, 3), train=True)
    assert train["fused_ln_window_attention"] == 8 * wa.LN_WMSA_LAUNCHES
    bands = dataclasses.replace(Config().swinunet, in_chans=16, out_chans=16)
    split = build_model(Config().replace(swinunet=bands), device="meta", backend="fused")
    assert split.expected_launches((4, 256, 256, 16))["fused_ln_window_attention"] == 24
