"""The split x4 head's forward (#10) and the standalone W-MSA (#15) on
Hopper, on the CPU: #10's launch plan and workspace against counts written
out here, its refusals, #15's plan (a function of one image's windows, never
of T), the launch constants the router counts, what both wrappers hand
their C entries (library stubbed), and plain-torch emulations of both launch
decompositions held against the plain versions.

- #10 (``csrc/up4.cu``, 2 launches): prep writes xb = round(prelu(x wb1 +
  bb1)) wbf in float32 into a map with a one-pixel border that repeats the
  edge; the phase launch, per (chunk of 8 x 8 tiles, phase s = 4 i + j) and
  tile, a = round(prelu(x wexp_s)), Y = a wpf + the stencil from the 9 x 9
  box of the bordered map at (h0 + i // 2, w0 + j // 2), one rounding, the
  tile's box stored at every 4th pixel from (4 h0 + i, 4 w0 + j), skipped
  past the image.
- #15 (``csrc/window_attention.cu``, 3 launches): qkv over the T * N token
  rows, split over K on ksq ranks summed in rank order, + bqkv (zeros for
  None), q scaled and rounded again; per (window t, head) the attention on
  rows t N .. t N + N - 1 with the mask of window t % nW; the projection
  split over K on ks ranks, + bproj, one rounding.

float32: max |diff| <= 1e-4 * max(1, max|ref|); bfloat16: chip_smoke's
forward limits (max |diff| <= 3e-2 * max(1, max|ref|), mean |diff| <= 3e-4
* max(1, mean|ref|)).
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from sunet_tf_tpu_torch.config import Config
from sunet_tf_tpu_torch.kernels import _build
from sunet_tf_tpu_torch.kernels import upsample as up
from sunet_tf_tpu_torch.kernels import window_attention as wa
from sunet_tf_tpu_torch.models.sunet import build_model

FWD_MAX, FWD_MEAN = 3e-2, 3e-4


def _in_order(parts):
    acc = 0.0
    for p in parts:
        acc = acc + p
    return acc


def _assert_close(got, want, dtype, what):
    assert got.shape == want.shape, what
    g, r = got.float(), want.float()
    d = (g - r).abs()
    if dtype == torch.float32:
        assert float(d.max()) <= 1e-4 * max(1.0, float(r.abs().max())), (what, float(d.max()))
        return
    assert float(d.max()) <= FWD_MAX * max(1.0, float(r.abs().max())), (what, float(d.max()))
    assert float(d.mean()) <= FWD_MEAN * max(1.0, float(r.abs().mean())), (what, float(d.mean()))


# ---------------------------------------------------------------- launch counts


def test_launch_constants_and_the_bands_model():
    assert up.UP4_SPLIT_LAUNCHES == 2 and wa.WMSA_CORE_LAUNCHES == 3
    cfg = Config()
    cfg = cfg.replace(swinunet=dataclasses.replace(cfg.swinunet, in_chans=16, out_chans=16))
    model = build_model(cfg, device="meta", backend="fused", seed=0)
    assert model.expected_launches((4, 256, 256, 16))["fused_dual_upsample4"] == 2
    train = model.expected_launches((4, 256, 256, 16), train=True)
    assert train["fused_dual_upsample4"] == 2 and train["up4_bwd"] == 5
    got = build_model(Config(), device="meta", backend="fused", seed=0).expected_launches(
        (4, 256, 256, 3))
    assert got["fused_dual_upsample4"] == 0 and got["fused_dual_upsample4_conv_phase"] == 1


# ---------------------------------------------------------------- #10's plan


@pytest.mark.parametrize("H,W,C,want", [
    # 8 x 8 tiles per chunk, column boxes, ring slots, rows per ring chunk,
    # wexp_s and wpf held for the chunk, tile chains per CTA
    (64, 64, 96, (16, 2, 2, 96, True, 2)),
    (30, 44, 96, (6, 2, 2, 96, True, 2)),
    (8, 8, 192, (1, 3, 3, 64, False, 1)),
    (16, 16, 256, (1, 4, 3, 64, False, 1)),
    (5, 7, 16, (1, 1, 2, 16, True, 2)),
])
def test_up4_split_plan_and_workspace(H, W, C, want):
    p = up.up4_split_plan(H, W, C)
    assert (p["tiles_per_chunk"], p["column_boxes"], p["ring_slots"], p["chunk_rows"],
            p["weights_resident"], p["tile_chains"]) == want
    assert max(p["smem"].values()) <= wa.SMEM_MAX
    up128 = lambda n: -(-n // 128) * 128
    for B in (1, 2, 4):
        # xb (float32) with its border, w_exp by phase (bf16)
        assert up.up4_split_workspace(B, H, W, C) == (
            up128(4 * B * (H + 2) * (W + 2) * C) + up128(2 * 16 * C * C))


@pytest.mark.parametrize("C", [272, 40, 0])
def test_up4_split_plan_refuses_shapes_outside_the_design(C):
    with pytest.raises(ValueError, match=re.escape("C a multiple of 16 up to 256")):
        up.up4_split_plan(16, 16, C)


def _stub(monkeypatch, module, checks) -> dict:
    """Stub the kernel library and the named CUDA checks of ``module``:
    returns the record of each C entry's call."""
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
    for name in checks:
        monkeypatch.setattr(module, name, lambda *a, **k: None)
    return calls


@pytest.mark.parametrize("H,W,C", [(64, 64, 96), (16, 16, 256)])
def test_up4_split_hands_the_entry_its_plan(H, W, C, monkeypatch):
    calls = _stub(monkeypatch, up, ["_check_up4_split"])
    B = 2
    z = lambda *s: torch.zeros(*s, device="meta", dtype=torch.bfloat16)
    v = lambda *s: torch.zeros(*s, device="meta")
    out = up.fused_dual_upsample4(z(B, H, W, C), z(C, 16 * C), v(1), z(C, C), v(C), v(1),
                                  z(C, C), z(C, C))
    assert calls["sunet_up4_workspace"] == (B, H, W, C)
    args = calls["sunet_up4"]
    assert args[9:14] == (B, H, W, C, up.up4_split_plan(H, W, C)["tiles_per_chunk"])
    assert out.shape == (B, 4 * H, 4 * W, C) and out.dtype == torch.bfloat16


# ---------------------------------------------------------------- #15's plan


@pytest.mark.parametrize("nW,ws,C,heads", [(64, 8, 96, 8), (4, 4, 96, 8), (1, 8, 768, 8)])
def test_wmsa_core_plan_is_one_images_and_handed_over(nW, ws, C, heads, monkeypatch):
    """The K splits handed to the entry are wmsa_plan's over one image's nW
    windows side by side, the same at any T; bqkv None becomes zeros."""
    calls = _stub(monkeypatch, wa, ["_check_windows"])
    plan = wa.wmsa_plan(ws, nW * ws, C, heads, ws)
    N = ws * ws
    z = lambda *s: torch.zeros(*s, device="meta", dtype=torch.bfloat16)
    v = lambda *s: torch.zeros(*s, device="meta")
    mask = v(nW, N, N) if nW > 1 else None
    for T in (nW, 4 * nW):
        out = wa.wmsa_core(z(T, N, C), z(C, 3 * C), None, z(C, C), v(C), v(heads, N, N), mask,
                           num_heads=heads, scale=8.0)
        assert calls["sunet_ln_wmsa_workspace"] == (T * N, C)
        args = calls["sunet_wmsa_core"]
        assert args[9:14] == (T, nW, ws, C, heads)
        assert args[15:17] == (plan["ksq"], plan["ks"])
        assert args[3] is not None and out.shape == (T, N, C)


# ---------------------------------------------------------------- #10's emulation


def _prelu(v, a):
    return torch.clamp_min(v, 0) + a * torch.clamp_max(v, 0)


def _bordered(xb):
    """The prep launch's xb map: pixel (h, w) at (h + 1, w + 1), each edge
    pixel also in the border cells beside it (store_bordered)."""
    B, H, W, C = xb.shape
    out = torch.zeros(B, H + 2, W + 2, C)
    for h in range(H):
        for w in range(W):
            for y in {h + 1, 0 if h == 0 else -1, H + 1 if h == H - 1 else -1} - {-1}:
                for x in {w + 1, 0 if w == 0 else -1, W + 1 if w == W - 1 else -1} - {-1}:
                    out[:, y, x] = xb[:, h, w]
    return out


def _emulate_split_fwd(x, w_exp, alpha_p, w_b1, b_b1, alpha_b, wpf, wbf):
    """#10 as its two launches decompose it, in plain torch, with their
    rounding points (no-ops for float32 inputs)."""
    dt = x.dtype
    rnd = lambda t: t.to(dt).float()
    f = lambda t: t.float()
    B, H, W, C = x.shape
    tpc = up.up4_split_plan(H, W, C)["tiles_per_chunk"]
    ap, ab = f(alpha_p).reshape(()), f(alpha_b).reshape(())
    xr = f(x)
    # 1: the strips: abv, xb in float32 into the bordered map
    xbp = _bordered(rnd(_prelu(xr @ f(w_b1) + f(b_b1), ab)) @ f(wbf))
    # the tap boxes read zeros past the bordered map
    xbp = torch.nn.functional.pad(xbp, (0, 0, 0, 9, 0, 9))
    xpad = torch.nn.functional.pad(xr, (0, 0, 0, 8, 0, 8))
    wexp_s = f(w_exp).reshape(C, C, 16).permute(2, 0, 1)
    tiles = [(b, h0, w0) for b in range(B) for h0 in range(0, H, 8) for w0 in range(0, W, 8)]
    out = torch.full((B, 4 * H, 4 * W, C), float("nan"))
    # 2: per (chunk, phase s), the chunk's tiles in order
    for c0 in range(0, len(tiles), tpc):
        for s in range(16):
            i, j = s // 4, s % 4
            (ki0, ki1), (kj0, kj1) = up.P4[i], up.P4[j]
            for b, h0, w0 in tiles[c0:c0 + tpc]:
                xt = xpad[b, h0:h0 + 8, w0:w0 + 8].reshape(64, C)   # zero off the image
                y = rnd(_prelu(xt @ wexp_s[s], ap)) @ f(wpf)
                tb = xbp[b, h0 + i // 2:h0 + i // 2 + 9, w0 + j // 2:w0 + j // 2 + 9]
                st = (kj0 * (ki0 * tb[:8, :8] + ki1 * tb[1:, :8])
                      + kj1 * (ki0 * tb[:8, 1:] + ki1 * tb[1:, 1:]))
                box = rnd(y + st.reshape(64, C)).reshape(8, 8, C)
                hh, ww = min(8, H - h0), min(8, W - w0)   # the store skips the rest
                out[b, 4 * h0 + i:4 * (h0 + hh):4, 4 * w0 + j:4 * (w0 + ww):4] = box[:hh, :ww]
    return out.to(dt)


def _split_inputs(dtype, B, H, W, C, seed):
    rng = np.random.default_rng(seed)
    n = lambda *s, sd=1.0: torch.from_numpy((rng.standard_normal(s) * sd).astype(np.float32))
    w = lambda i, o: n(i, o, sd=i ** -0.5).to(dtype)
    return (n(B, H, W, C).to(dtype), w(C, 16 * C), torch.tensor([0.25]), w(C, C),
            n(C, sd=0.1), torch.tensor([0.2]), w(C, C), w(C, C))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C", [(1, 5, 7, 16), (2, 30, 44, 96), (1, 6, 9, 256)])
def test_up4_split_emulation_matches_the_plain_version(dtype, B, H, W, C):
    """A ragged (5, 7) map (one partial tile, every clamped tap at a border
    cell); (30, 44), the main path's width, in chunks of six partial and
    whole tiles; C = 256, the cap, over four column boxes."""
    args = _split_inputs(dtype, B, H, W, C, 700 + H + C)
    with wa.exact_fp32():
        got = _emulate_split_fwd(*args)
        want = up.fused_dual_upsample4_reference(*args)
    assert not torch.isnan(got.float()).any()   # every pixel stored once
    _assert_close(got, want, dtype, "out")


def test_bordered_map_is_the_clamped_stencil():
    """The bordered map's taps are the plain version's clamped taps: the
    stencil over it at every phase equals ``_stencil_x4`` along both axes."""
    rng = np.random.default_rng(3)
    xb = torch.from_numpy(rng.standard_normal((2, 5, 3, 4))).float()
    xbp = _bordered(xb)
    st = [up._stencil_x4(t, 2) for t in up._stencil_x4(xb, 1)]
    for s in range(16):
        i, j = s // 4, s % 4
        (ki0, ki1), (kj0, kj1) = up.P4[i], up.P4[j]
        tb = xbp[:, i // 2:i // 2 + 6, j // 2:j // 2 + 4]
        got = (kj0 * (ki0 * tb[:, :5, :3] + ki1 * tb[:, 1:, :3])
               + kj1 * (ki0 * tb[:, :5, 1:] + ki1 * tb[:, 1:, 1:]))
        torch.testing.assert_close(got, st[i][j], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- #15's emulation


def _emulate_wmsa(xw, wqkv, bqkv, wproj, bproj, bias, mask, heads, scale, ksq, ks):
    """#15 as its three launches decompose it, in plain torch, with their
    rounding points (no-ops for float32 inputs)."""
    dt = xw.dtype
    rnd = lambda t: t.to(dt).float()
    f = lambda t: t.float()
    T, N, C = xw.shape
    d, nW = C // heads, 1 if mask is None else mask.shape[0]
    rows = f(xw).reshape(T * N, C)
    # 1: qkv over the token rows, K ranks summed in order, + bqkv, q scaled
    kq = C // ksq
    s = _in_order(rows[:, r * kq:(r + 1) * kq] @ f(wqkv)[r * kq:(r + 1) * kq]
                  for r in range(ksq))
    qkv = rnd(s + (0.0 if bqkv is None else f(bqkv)))
    q, k, v = rnd(qkv[:, :C] * scale), qkv[:, C:2 * C], qkv[:, 2 * C:]
    # 2: per (window t, head): rows t N .., the mask of window t % nW
    ctx = torch.zeros(T * N, C)
    for t in range(T):
        r = slice(t * N, (t + 1) * N)
        for hh in range(heads):
            c = slice(hh * d, (hh + 1) * d)
            sc = q[r, c] @ k[r, c].t() + f(bias[hh])
            if mask is not None:
                sc = sc + f(mask[t % nW])
            e = torch.exp(sc - sc.amax(-1, keepdim=True))
            ctx[r, c] = rnd((rnd(e) @ v[r, c]) / e.sum(-1, keepdim=True))
    # 3: the projection, K ranks summed in order, + bproj, one rounding
    kp = C // ks
    s = _in_order(ctx[:, r * kp:(r + 1) * kp] @ f(wproj)[r * kp:(r + 1) * kp] for r in range(ks))
    return rnd(s + f(bproj)).to(dt).reshape(T, N, C)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qkv_bias", [True, False])
@pytest.mark.parametrize("nW,B,ws", [(1, 3, 8), (4, 2, 4)])
def test_wmsa_emulation_matches_the_plain_version(dtype, qkv_bias, nW, B, ws):
    """Head dim 12 (C = 96, 8 heads; the kernel pads it to 16): three
    images of one 64-token window each, and two images of four 16-token
    windows under four different masks (window t takes mask t % 4); with
    bqkv and with None (zeros)."""
    C, heads, N = 96, 8, ws * ws
    T = B * nW
    rng = np.random.default_rng(40 + nW + qkv_bias)
    n = lambda *s, sd=1.0: torch.from_numpy((rng.standard_normal(s) * sd).astype(np.float32))
    xw = n(T, N, C).to(dtype)
    wqkv, wproj = n(C, 3 * C, sd=C ** -0.5).to(dtype), n(C, C, sd=C ** -0.5).to(dtype)
    bqkv = n(3 * C, sd=0.1) if qkv_bias else None
    bproj, bias = n(C, sd=0.1), n(heads, N, N)
    mask = None
    if nW > 1:
        mask = torch.where(torch.from_numpy(rng.random((nW, N, N)) < 0.3), -100.0, 0.0)
        mask[:, torch.arange(N), torch.arange(N)] = 0.0   # every row keeps a key
    plan = wa.wmsa_plan(ws, nW * ws, C, heads, ws)
    with wa.exact_fp32():
        got = _emulate_wmsa(xw, wqkv, bqkv, wproj, bproj, bias, mask, heads, 8.0,
                            plan["ksq"], plan["ks"])
        want = wa.wmsa_core_reference(xw, wqkv, bqkv, wproj, bproj, bias, mask,
                                      num_heads=heads, scale=8.0)
    _assert_close(got, want, dtype, "out")
    if nW > 1:   # the mask of window t % nW, not of window t
        with wa.exact_fp32():
            wrong = wa.wmsa_core_reference(xw, wqkv, bqkv, wproj, bproj, bias,
                                           mask.roll(1, 0), num_heads=heads, scale=8.0)
        assert float((got.float() - wrong.float()).abs().max()) > 1e-2
