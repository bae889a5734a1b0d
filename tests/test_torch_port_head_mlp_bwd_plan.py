"""The conv-fused x4 head's backward (#9) and the LN+MLP backward (#14) on
Hopper, on the CPU: their launch plans and workspaces against counts written
out here, their refusals, the launch constants the router counts, what the
wrappers hand the C entries (library stubbed), and plain-torch emulations of
both launch decompositions held against the plain versions.

- #9 (``csrc/up4_conv_bwd.cu``, 5 launches): the 8 x 8-tile stencil adjoint
  folded with the conv adjoint (per-axis coefficients of the clamped x4
  stencil over dout, then the conv weights); per phase, z = x wexp_s, y =
  round(a wpf + stencil_s(xb)) kept on chip, the 3x3 conv's fold as y^T
  times dout shifted by each slot that reads the phase and masked where the
  shift leaves the image, the conv adjoint as a product over the 9 * out
  (tap, out) pairs, dz = round(prelu'(z) round(dY) wpf^T) in an (M, 16C)
  map; dx = round(dz wexp^T + round(dzb) wb1^T); the weight gradients as
  token-chunk partials, dwpf and the fold as per-(chunk, phase) partials,
  summed in order, dwexp back to w_exp's column order, the fold unfolded.
- #14 (``csrc/ln_mlp_bwd.cu``, 5 launches): the map's own row order (a
  window of one token: token_offset is the identity, shown on a (16, 16)
  map where the window order is not), dab w1^T split over K into ks rank
  partials summed in rank order, the LN backward one row at a time with
  8-row partials of dg and db, the weight gradients in token chunks.

float32: max |diff| <= 1e-4 * max(1, max|ref|); bfloat16: chip_smoke's
backward limits (dx max 1e-1, mean 2e-3; weight grads mean |diff| <= 1e-2 *
mean |ref|), as in ``test_torch_port_res_wmsa_plan.py``.
"""

import dataclasses
import math
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sunet_tf_tpu_torch.config import Config
from sunet_tf_tpu_torch.kernels import _build
from sunet_tf_tpu_torch.kernels import upsample as up
from sunet_tf_tpu_torch.kernels import window_attention as wa
from sunet_tf_tpu_torch.models import layers
from sunet_tf_tpu_torch.models.sunet import build_model

UP4_NAMES = ("dx", "dw_exp", "dalpha_p", "dw_b1", "db_b1", "dalpha_b", "dwpf", "dwbf",
             "dwconv")
MLP_NAMES = ("dy", "dln_g", "dln_b", "dw1", "db1", "dw2", "db2")


def _in_order(parts):
    acc = 0.0
    for p in parts:
        acc = acc + p
    return acc


def _assert_limits(names, got, want, dtype):
    for name, g, r in zip(names, got, want):
        assert g.shape == r.shape, name
        g, r = g.float(), r.float()
        if dtype == torch.float32:
            err = float((g - r).abs().max())
            assert err <= 1e-4 * max(1.0, float(r.abs().max())), (name, err)
        elif name in ("dx", "dy"):
            dd = (g - r).abs()
            assert float(dd.max()) <= 1e-1 * max(1.0, float(r.abs().max())), name
            assert float(dd.mean()) <= 2e-3 * max(1.0, float(r.abs().mean())), name
        else:
            rel = float((g - r).abs().mean()) / max(float(r.abs().mean()), 1e-30)
            assert rel <= 1e-2, (name, rel)


# ---------------------------------------------------------------- launch counts


def test_launch_constants_and_the_default_step(monkeypatch):
    assert up.UP4_CONV_BWD_LAUNCHES == 5 and wa.LN_MLP_BWD_LAUNCHES == 5
    model = build_model(Config(), device="meta", backend="fused", seed=0)
    got = model.expected_launches((4, 256, 256, 3), train=True)
    assert got["up4_conv_bwd"] == up.UP4_CONV_BWD_LAUNCHES and got["up4_bwd"] == 0
    # the C=768 bottleneck trains on the block kernels by default; on the
    # sublayer kernels with the training cap at 384: 8 blocks
    assert got["ln_mlp_bwd"] == got["ln_mlp_branch"] == 0
    monkeypatch.setattr(layers, "ROUTE_TRAIN_BLOCK_MAX_C", 384)
    got = model.expected_launches((4, 256, 256, 3), train=True)
    assert got["ln_mlp_bwd"] == 8 * wa.LN_MLP_BWD_LAUNCHES == 40
    assert got["ln_mlp_branch"] == 8 * wa.LN_MLP_BRANCH_LAUNCHES


def test_launch_counts_of_the_16_band_model(monkeypatch):
    cfg = Config()
    cfg = cfg.replace(swinunet=dataclasses.replace(cfg.swinunet, in_chans=16, out_chans=16))
    model = build_model(cfg, device="meta", backend="fused", seed=0)
    got = model.expected_launches((4, 256, 256, 16), train=True)
    assert got["up4_conv_bwd"] == 0 and got["up4_bwd"] == up.UP4_BWD_LAUNCHES
    assert got["ln_mlp_bwd"] == 0
    monkeypatch.setattr(layers, "ROUTE_TRAIN_BLOCK_MAX_C", 384)
    got = model.expected_launches((4, 256, 256, 16), train=True)
    assert got["ln_mlp_bwd"] == 8 * wa.LN_MLP_BWD_LAUNCHES


# ---------------------------------------------------------------- #9's plan


def _up4_workspace_count(B, H, W, C, out, tpc, wchunk):
    """#9's workspace written out: zb, xb (float32), abv, dxb, round(dzb)
    (bf16, M x C), dz (bf16, M x 16C), w_exp by phase (16C x C) and the conv
    weights by tap (9 out x C), then the float32 partials: dwpf per (chunk,
    phase), the fold per (chunk, slot), the slope per (chunk, phase) (a
    chunk: tpc 8 x 8 tiles), the 64-pixel strips' slope and db_b1, the three
    weight gradients per token chunk; each piece rounded up to 128 bytes."""
    up128 = lambda n: -(-n // 128) * 128
    M = B * H * W
    ntiles = -(-M // 64)
    nch, wnch = -(-(B * -(-H // 8) * -(-W // 8)) // tpc), -(-M // wchunk)
    return (2 * up128(4 * M * C) + 3 * up128(2 * M * C) + up128(2 * 16 * M * C)
            + up128(2 * 16 * C * C) + up128(2 * 9 * out * C) + up128(4 * nch * 16 * C * C)
            + up128(4 * nch * 36 * C * 16 * out) + up128(4 * nch * 16) + up128(4 * ntiles)
            + up128(4 * ntiles * C) + up128(4 * wnch * 16 * C * C) + 2 * up128(4 * wnch * C * C))


@pytest.mark.parametrize("H,W,C,out,want", [
    # 8 x 8 tiles per chunk, fold boxes of the 1-, 2- and 4-slot phases, K of
    # the conv adjoint, weight-gradient tokens per chunk and tiles
    (64, 64, 96, 1, (32, (1, 1, 1), 16, 1664, (24, 2, 2))),
    (34, 40, 96, 3, (13, (1, 2, 3), 32, 576, (24, 2, 2))),
    (16, 24, 32, 8, (3, (2, 4, 8), 80, 64, (4, 1, 1))),
])
def test_up4_conv_bwd_plan_and_workspace(H, W, C, out, want):
    p = up.up4_conv_bwd_plan(H, W, C, out)
    boxes = p["fold_boxes"]
    assert (p["tiles_per_chunk"], (boxes[5], boxes[4], boxes[0]), p["k16"],
            p["wgrad_chunk_tokens"], p["wgrad_tiles"]) == want
    # phase (1, 1) reads one slot per axis, (1, 0) two along W, (0, 0) four
    assert len(boxes) == 16 and max(boxes) == out
    assert max(p["smem"].values()) <= wa.SMEM_MAX
    for B in (1, 2, 4):
        assert up.up4_conv_bwd_workspace(B, H, W, C, out) == _up4_workspace_count(
            B, H, W, C, out, p["tiles_per_chunk"], p["wgrad_chunk_tokens"])


@pytest.mark.parametrize("C,out,match", [
    (208, 1, "C a multiple of 4 (padded to 16) up to 192"),
    (42, 1, "C a multiple of 4 (padded to 16) up to 192"),
    (96, 9, "1 <= out <= 8"),
    (96, 0, "1 <= out <= 8"),
])
def test_up4_conv_bwd_plan_refuses_shapes_outside_the_design(C, out, match):
    with pytest.raises(ValueError, match=re.escape(match)):
        up.up4_conv_bwd_plan(16, 16, C, out)


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


@pytest.mark.parametrize("H,W,out", [(64, 64, 1), (34, 40, 3)])
def test_up4_conv_bwd_hands_the_entry_its_plan(H, W, out, monkeypatch):
    calls = _stub(monkeypatch, up, ["_check_up4"])
    B, C = 2, 96
    z = lambda *s: torch.zeros(*s, device="meta", dtype=torch.bfloat16)
    v = lambda *s: torch.zeros(*s, device="meta")
    g = up.up4_conv_bwd(z(B, H, W, C), z(C, 16 * C), v(1), z(C, C), v(C), v(1), z(C, C),
                        z(C, C), z(3, 3, C, out), z(B, H, W, 16 * out))
    args = calls["sunet_up4_conv_bwd"]
    assert args[18:24] == (B, H, W, C, out, up.up4_conv_bwd_plan(H, W, C, out)["tiles_per_chunk"])
    # the conv grads come back in (3, 3, C, out): the sums launch unfolds them
    assert g[-1].shape == (3, 3, C, out) and g[1].shape == (C, 16 * C)


# ---------------------------------------------------------------- #14's plan


def _mlp_workspace_count(B, H, C, hidden, chunk):
    """#14's workspace written out: yn, dm (bf16, T x C), round(gelu(a)),
    round(da) (bf16, T x hidden), the LN statistics, a (float32, T x hidden),
    dyn (float32, T x C), the weight gradients' partials with more than one
    chunk, b1's per-row-tile and the LN's 8-row partials; each piece rounded
    up to 128 bytes."""
    up128 = lambda n: -(-n // 128) * 128
    T = B * H * H
    nch = -(-T // chunk)
    total = (2 * up128(2 * T * C) + 2 * up128(2 * T * hidden) + up128(8 * T)
             + up128(4 * T * hidden) + up128(4 * T * C))
    if nch > 1:
        total += 2 * up128(4 * nch * C * hidden) + up128(4 * nch * C)
    return total + up128(4 * -(-T // 64) * hidden) + up128(4 * -(-T // 8) * 2 * C)


@pytest.mark.parametrize("H,C,hidden,want", [
    # K split, tokens per chunk, weight-gradient tiles, fc1's tiles per CTA
    (8, 768, 3072, (8, 256, (288, 288), 1)),
    (16, 768, 3072, (2, 1024, (288, 288), 2)),
    (16, 96, 384, (6, 64, (6, 6), 1)),
])
def test_ln_mlp_bwd_plan_and_workspace(H, C, hidden, want):
    p = wa.ln_mlp_bwd_plan(H, H, C, hidden)
    assert (p["ks"], p["chunk_tokens"], p["wgrad_tiles"], p["tiles_per_cta"]["fc1"]) == want
    # ks divides the K chunks of dab w1^T and fits a portable cluster
    assert math.ceil(hidden / 64) % p["ks"] == 0 and p["ks"] <= 8
    assert max(p["smem"].values()) <= wa.SMEM_MAX
    for B in (1, 2, 4, 8):
        assert wa.ln_mlp_bwd_workspace(B, H, H, C, hidden) == _mlp_workspace_count(
            B, H, C, hidden, p["chunk_tokens"])


@pytest.mark.parametrize("C,hidden,match", [
    (784, 3136, "C <= 768"),
    (768, 3000, "multiples of 16"),
    (100, 400, "multiples of 16"),
])
def test_ln_mlp_bwd_plan_refuses_shapes_outside_the_design(C, hidden, match):
    with pytest.raises(ValueError, match=re.escape(match)):
        wa.ln_mlp_bwd_plan(8, 8, C, hidden)


@pytest.mark.parametrize("B,H", [(2, 8), (4, 16)])
def test_ln_mlp_bwd_hands_the_entry_its_plan(B, H, monkeypatch):
    calls = _stub(monkeypatch, wa, ["_check_mlp"])
    C, hidden = 768, 3072
    z = lambda *s: torch.zeros(*s, device="meta", dtype=torch.bfloat16)
    v = lambda *s: torch.zeros(*s, device="meta")
    wa.ln_mlp_bwd(z(B, H, H, C), z(B, H, H, C), (v(C), v(C)), z(C, hidden), v(hidden),
                  z(hidden, C))
    args = calls["sunet_ln_mlp_bwd"]
    assert args[15:21] == (B, H, H, C, hidden, wa.ln_mlp_bwd_plan(H, H, C, hidden)["ks"])


# ---------------------------------------------------------------- #9's emulation


def _tap_coef(P: int, t: int, n: int) -> float:
    """One axis of the clamped x4 stencil: the weight with which high-res
    index P reaches low-res target t (csrc/up4_conv_bwd.cu tap_coef)."""
    u, i = P >> 2, P & 3
    lo, hi = (max(u - 1, 0), u) if i < 2 else (u, min(u + 1, n - 1))
    return (up.P4[i][0] if lo == t else 0.0) + (up.P4[i][1] if hi == t else 0.0)


def _axis(n: int) -> torch.Tensor:
    return torch.tensor([[_tap_coef(P, t, n) for t in range(n)] for P in range(4 * n)])


def _emulate_up4(x, w_exp, alpha_p, w_b1, b_b1, alpha_b, wpf, wbf, wconv, dout):
    """#9 as its five launches decompose it, in plain torch, with their
    rounding points (no-ops for float32 inputs)."""
    dt = x.dtype
    rnd = lambda t: t.to(dt).float()
    f = lambda t: t.float()
    B, H, W, C = x.shape
    out = wconv.shape[-1]
    O, M = 16 * out, B * H * W
    plan = up.up4_conv_bwd_plan(H, W, C, out)
    tpc, wct = plan["tiles_per_chunk"], plan["wgrad_chunk_tokens"]
    ap, ab = f(alpha_p).reshape(()), f(alpha_b).reshape(())
    prelu = lambda v, a: torch.clamp_min(v, 0) + a * torch.clamp_max(v, 0)
    xr = f(x).reshape(M, C)
    dpix = f(up.phase_to_pixel(dout))
    # 1: the strips (zb, abv, xb); the tiles' dxb: per conv tap, dout summed
    # along W then H with the stencil's coefficients, then the conv weights
    zb = xr @ f(w_b1) + f(b_b1)
    abv = rnd(prelu(zb, ab))
    xb = (abv @ f(wbf)).reshape(B, H, W, C)
    Ah, Aw = _axis(H), _axis(W)
    pad = F.pad(dpix, (0, 0, 1, 1, 1, 1))
    hm = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            sh = pad[:, 1 - dy:1 - dy + 4 * H, 1 - dx:1 - dx + 4 * W]
            r = torch.einsum("qw,bpqo->bpwo", Aw, sh)
            hm.append(torch.einsum("ph,bpwo->bhwo", Ah, r))
    hm = torch.stack(hm, 3).reshape(M, 9 * out)
    wc = f(wconv).permute(0, 1, 3, 2).reshape(9 * out, C)   # row tap * out + o
    dxb = rnd(hm @ wc)
    # 2: per phase s = (pi, pj): z, a, y, the fold, dY, dz, dwpf
    st = [up._stencil_x4(t, 2) for t in up._stencil_x4(xb, 1)]
    wexp_s = f(w_exp).reshape(C, C, 16).permute(2, 0, 1)
    dout_lo = F.pad(f(dout), (0, 0, 1, 1, 1, 1))
    # the phase launch's chunks: tpc 8 x 8 tiles each, a tile's pixels row by row
    tiles = [torch.tensor([(b * H + h) * W + w for h in range(h0, min(H, h0 + 8))
                           for w in range(w0, min(W, w0 + 8))])
             for b in range(B) for h0 in range(0, H, 8) for w0 in range(0, W, 8)]
    chunks = [torch.cat(tiles[i:i + tpc]) for i in range(0, len(tiles), tpc)]
    fold = torch.zeros(36, C, O)
    ppf, pap, dz = [], [], torch.zeros(M, 16 * C)
    for rows in chunks:
        for s in range(16):
            pi, pj = s // 4, s % 4
            z = xr[rows] @ wexp_s[s]
            a = rnd(prelu(z, ap))
            y = rnd(a @ f(wpf) + st[pi][pj].reshape(M, C)[rows])
            for uh, (dh, ph) in enumerate(up.USLOTS):
                for uw, (dw, pw) in enumerate(up.USLOTS):
                    if (ph, pw) != (pi, pj):
                        continue
                    # dout shifted by the slot, zero where the shift leaves the image
                    sh = dout_lo[:, 1 - dh:1 - dh + H, 1 - dw:1 - dw + W].reshape(M, O)
                    fold[uh * 6 + uw] += y.t() @ sh[rows]
            taps = [F.pad(dpix, (0, 0, 1, 1, 1, 1))[:, 1 - dy + pi:1 - dy + pi + 4 * H:4,
                                                    1 - dx + pj:1 - dx + pj + 4 * W:4]
                    for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
            dg = torch.stack(taps, 3).reshape(M, 9 * out)[rows]
            dyb = rnd(dg @ wc)
            dP = dyb @ f(wpf).t()
            dz[rows, s * C:(s + 1) * C] = rnd(torch.where(z > 0, dP, ap * dP))
            pap.append((torch.clamp_max(z, 0) * dP).sum())
            ppf.append(a.t() @ dyb)
    # 3: the strips' bilinear chain and dx over K = 16 C + C
    dabm = dxb @ f(wbf).t()
    dzb = torch.where(zb > 0, dabm, ab * dabm)
    dzb_b = rnd(dzb)
    strips = range(0, M, 64)
    dab = _in_order((torch.clamp_max(zb, 0) * dabm)[i:i + 64].sum() for i in strips)
    dbb1 = _in_order(dzb[i:i + 64].sum(0) for i in strips)
    wstT = f(w_exp).reshape(C, C, 16).permute(2, 1, 0).reshape(16 * C, C)
    dx = rnd(torch.cat([dz, dzb_b], 1) @ torch.cat([wstT, f(w_b1).t()], 0)).to(dt)
    # 4-5: the weight gradients in token chunks, every partial in order
    wsum = lambda X, D: _in_order(X[i:i + wct].t() @ D[i:i + wct] for i in range(0, M, wct))
    dwexp = wsum(xr, dz).reshape(C, 16, C).permute(0, 2, 1).reshape(C, 16 * C)
    dwconv = torch.zeros(3, 3, C, out)
    for dy in (-1, 0, 1):
        for dx_ in (-1, 0, 1):
            for i in range(4):
                for j in range(4):
                    slot = up._slot(i, dy) * 6 + up._slot(j, dx_)
                    col = (i * 4 + j) * out
                    dwconv[dy + 1, dx_ + 1] += fold[slot][:, col:col + out]
    return (dx.reshape(B, H, W, C), dwexp, _in_order(pap).reshape(alpha_p.shape),
            wsum(xr, dzb_b), dbb1, dab.reshape(alpha_b.shape), _in_order(ppf),
            wsum(abv, dxb), dwconv)


def _up4_inputs(dtype, B, H, W, C, out, seed):
    rng = np.random.default_rng(seed)
    n = lambda *s, sd=1.0: torch.from_numpy((rng.standard_normal(s) * sd).astype(np.float32))
    w = lambda i, o: n(i, o, sd=i ** -0.5).to(dtype)
    return (n(B, H, W, C).to(dtype), w(C, 16 * C), torch.tensor([0.25]), w(C, C),
            n(C, sd=0.1), torch.tensor([0.2]), w(C, C), w(C, C),
            n(3, 3, C, out, sd=(9 * C) ** -0.5).to(dtype), n(B, H, W, 16 * out).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,out", [(2, 12, 12, 32, 1), (1, 5, 7, 16, 3)])
def test_up4_conv_bwd_emulation_matches_the_plain_version(dtype, B, H, W, C, out):
    """A map of 5 chunks of two 64-pixel tiles at out 1, and a ragged (5, 7)
    map (one partial tile, every border of the fold's zero padding and of
    the stencil's clamp within one 8 x 8 tile) at out 3."""
    args = _up4_inputs(dtype, B, H, W, C, out, 700 + H + out)
    with wa.exact_fp32():
        got = _emulate_up4(*args)
        want = up.up4_conv_bwd_reference(*args)
    _assert_limits(UP4_NAMES, got, want, dtype)


def test_up4_fold_shifts_equal_the_slot_maps():
    """The fold as each phase map times dout shifted back by the slot's
    offset (zero off the image) equals the reference's slot map (the phase
    map shifted forward, zero off the image) times dout, slot by slot."""
    rng = np.random.default_rng(11)
    B, H, W, C, O = 2, 5, 6, 8, 16
    y = torch.from_numpy(rng.standard_normal((16, B, H, W, C)))
    dout = torch.from_numpy(rng.standard_normal((B, H, W, O)))
    want = [s.reshape(-1, C).t() @ dout.reshape(-1, O) for s in up._phase_slots(y)]
    pad = F.pad(dout, (0, 0, 1, 1, 1, 1))
    for uh, (dh, ph) in enumerate(up.USLOTS):
        for uw, (dw, pw) in enumerate(up.USLOTS):
            sh = pad[:, 1 - dh:1 - dh + H, 1 - dw:1 - dw + W].reshape(-1, O)
            got = y[ph * 4 + pw].reshape(-1, C).t() @ sh
            torch.testing.assert_close(got, want[uh * 6 + uw], rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------- #14's emulation


def _token_offset(t: int, H: int, W: int, ws: int, shift: int) -> int:
    """train_common.cuh token_offset in pixels (C = 1)."""
    N, hw, nwx = ws * ws, H * W, W // ws
    b, r = t // hw, t % hw
    win, n = r // N, r % N
    gy = ((win // nwx) * ws + n // ws + shift) % H
    gx = ((win % nwx) * ws + n % ws + shift) % W
    return (b * H + gy) * W + gx


def test_mlp_rows_keep_the_maps_order_where_windows_would_not():
    B, H = 2, 16
    rows = [_token_offset(t, H, H, 1, 0) for t in range(B * H * H)]
    assert rows == list(range(B * H * H))
    assert [_token_offset(t, H, H, 8, 0) for t in range(B * H * H)] != rows


def _emulate_mlp(y, dout, ln, w1, b1, w2):
    """#14 as its five launches decompose it, in plain torch, with their
    rounding points (no-ops for float32 inputs), over the map's own rows."""
    dt = y.dtype
    rnd = lambda t: t.to(dt).float()
    f = lambda t: t.float()
    B, H, W, C = y.shape
    T, hidden = B * H * W, w1.shape[1]
    plan = wa.ln_mlp_bwd_plan(H, W, C, hidden)
    ks, ct = plan["ks"], plan["chunk_tokens"]
    order = [_token_offset(t, H, W, 1, 0) for t in range(T)]
    yr = f(y).reshape(T, C)[order]
    # 1: LN2 + fc1
    mean = yr.mean(-1, keepdim=True)
    inv = torch.rsqrt(((yr - mean) ** 2).mean(-1, keepdim=True) + 1e-5)
    xh = (yr - mean) * inv
    yn = rnd(xh * f(ln[0]) + f(ln[1]))
    a = yn @ f(w1) + f(b1)
    h1 = rnd(wa.gelu_erf(a))
    # 2: dm w2^T, b1's row-tile partials
    dm = rnd(f(dout).reshape(T, C)[order])
    da = (dm @ f(w2).t()) * wa.gelu_erf_grad(a)
    dab = rnd(da)
    db1 = _in_order(da[i:i + 64].sum(0) for i in range(0, T, 64))
    # 3: dab w1^T over ks K ranges, summed in rank order
    per = 64 * (-(-hidden // 64) // ks)
    dyn = _in_order(dab[:, q * per:(q + 1) * per] @ f(w1)[:, q * per:(q + 1) * per].t()
                    for q in range(ks))
    # 4: the LN backward row by row, 8-row partials; the weight gradients
    dxh = dyn * f(ln[0])
    dy = rnd(inv * (dxh - dxh.mean(-1, keepdim=True)
                    - xh * (dxh * xh).mean(-1, keepdim=True)))
    groups = range(0, T, 8)
    wsum = lambda X, D: _in_order(X[i:i + ct].t() @ D[i:i + ct] for i in range(0, T, ct))
    return (dy.reshape(y.shape).to(dt), _in_order((dyn * xh)[i:i + 8].sum(0) for i in groups),
            _in_order(dyn[i:i + 8].sum(0) for i in groups), wsum(yn, dab), db1, wsum(h1, dm),
            _in_order(dm[i:i + ct].sum(0) for i in range(0, T, ct)))


def _mlp_inputs(dtype, B, H, C, hidden, seed):
    rng = np.random.default_rng(seed)
    n = lambda *s, sd=1.0: torch.from_numpy((rng.standard_normal(s) * sd).astype(np.float32))
    w = lambda i, o: n(i, o, sd=i ** -0.5).to(dtype)
    return (n(B, H, H, C).to(dtype), n(B, H, H, C).to(dtype), (1 + n(C, sd=0.1), n(C, sd=0.1)),
            w(C, hidden), n(hidden, sd=0.1), w(hidden, C))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,C,hidden", [(2, 16, 96, 384), (3, 8, 64, 256)])
def test_ln_mlp_bwd_emulation_matches_the_plain_version(dtype, B, H, C, hidden):
    """A (16, 16) map, whose window order is not its row order, with ks = 6
    (uneven rank rows), and a batch of 3 (8, 8) maps with ks = 4."""
    args = _mlp_inputs(dtype, B, H, C, hidden, 800 + H + C)
    with wa.exact_fp32():
        got = _emulate_mlp(*args)
        want = wa.ln_mlp_bwd_reference(*args)
    _assert_limits(MLP_NAMES, got, want, dtype)
