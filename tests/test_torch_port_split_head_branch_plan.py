"""The split x4 head's backward (#11) and the LN+MLP branch forward (#13) on
Hopper, on the CPU: #11's launch plan and workspace against counts written
out here, its refusals, the launch constants the router counts, what both
wrappers hand their C entries (library stubbed), and plain-torch emulations
of both launch decompositions held against the plain versions.

- #11 (``csrc/up4_bwd.cu``, 5 launches, the last three #9's): the 8 x 8-tile
  stencil adjoint over the pixel-space dout (per tile a 40 x 40 window of
  high-res sources, 12 taps per target along W, then along H); per (chunk of
  tiles, phase s, 64-column box q), z = x wexp_s and dP = round(dout_s
  wpf^T) for box q, dz = round(prelu'(z) dP) into an (M, 16C) map, dwpf's
  rows of box q += a^T dout_s, the slope partials in (chunk, phase, box)
  order; dx = round(dz wexp^T + round(dzb) wb1^T); the weight gradients as
  token-chunk partials summed in order.
- #13 (``csrc/ln_mlp_branch.cu``, 2 launches): the LayerNorm of each row in
  fc1's A load (fp32 statistics, rounded once), fc1 + b1 through the erf
  GELU rounded, fc2 over ks K ranges (#4's plan, ``mlp_plan``) whose fp32
  partials are summed in rank order before b2 and the one rounding.

float32: max |diff| <= 1e-4 * max(1, max|ref|); bfloat16: chip_smoke's
limits (dx and the branch output max 1e-1, mean 2e-3; weight grads mean
|diff| <= 1e-2 * mean |ref|), as in ``test_torch_port_head_mlp_bwd_plan.py``.
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
from sunet_tf_tpu_torch.models import layers
from sunet_tf_tpu_torch.models.sunet import build_model

UP4_NAMES = ("dx", "dw_exp", "dalpha_p", "dw_b1", "db_b1", "dalpha_b", "dwpf", "dwbf")


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
        elif name in ("dx", "out"):
            dd = (g - r).abs()
            assert float(dd.max()) <= 1e-1 * max(1.0, float(r.abs().max())), name
            assert float(dd.mean()) <= 2e-3 * max(1.0, float(r.abs().mean())), name
        else:
            rel = float((g - r).abs().mean()) / max(float(r.abs().mean()), 1e-30)
            assert rel <= 1e-2, (name, rel)


# ---------------------------------------------------------------- launch counts


def test_launch_constants_and_both_steps(monkeypatch):
    assert up.UP4_BWD_LAUNCHES == 5 and wa.LN_MLP_BRANCH_LAUNCHES == 2
    got = build_model(Config(), device="meta", backend="fused", seed=0).expected_launches(
        (4, 256, 256, 3), train=True)
    # the C=768 bottleneck trains on the block kernels by default; on the
    # sublayer kernels with the training cap at 384: 8 blocks, 2 launches
    # each
    assert got["ln_mlp_branch"] == 0 and got["up4_bwd"] == 0
    monkeypatch.setattr(layers, "ROUTE_TRAIN_BLOCK_MAX_C", 384)
    got = build_model(Config(), device="meta", backend="fused", seed=0).expected_launches(
        (4, 256, 256, 3), train=True)
    assert got["ln_mlp_branch"] == 16 and got["up4_bwd"] == 0
    cfg = Config()
    cfg = cfg.replace(swinunet=dataclasses.replace(cfg.swinunet, in_chans=16, out_chans=16))
    got = build_model(cfg, device="meta", backend="fused", seed=0).expected_launches(
        (4, 256, 256, 16), train=True)
    assert got["up4_bwd"] == 5 and got["ln_mlp_branch"] == 16


# ---------------------------------------------------------------- #11's plan


def _split_workspace_count(B, H, W, C, tpc, wchunk):
    """#11's workspace written out: zb (float32), abv, dxb, round(dzb) (bf16,
    M x C), dz (bf16, M x 16C), w_exp by phase (16C x C), then the float32
    partials: dwpf per (chunk, phase), the slope per (chunk, phase, 64-column
    box of C) (a chunk: tpc 8 x 8 tiles), the 64-pixel strips' slope and
    db_b1, the three weight gradients per token chunk; each piece rounded up
    to 128 bytes."""
    up128 = lambda n: -(-n // 128) * 128
    M = B * H * W
    ntiles, nbx = -(-M // 64), -(-C // 64)
    nch, wnch = -(-(B * -(-H // 8) * -(-W // 8)) // tpc), -(-M // wchunk)
    return (up128(4 * M * C) + 3 * up128(2 * M * C) + up128(2 * 16 * M * C)
            + up128(2 * 16 * C * C) + up128(4 * nch * 16 * C * C) + up128(4 * nch * 16 * nbx)
            + up128(4 * ntiles) + up128(4 * ntiles * C) + up128(4 * wnch * 16 * C * C)
            + 2 * up128(4 * wnch * C * C))


@pytest.mark.parametrize("H,W,C,want", [
    # 8 x 8 tiles per chunk, the phase launch's column boxes, weight-gradient
    # tokens per chunk and tiles (dwexp, dwbf, dwb1)
    (64, 64, 96, (32, 2, 1664, (24, 2, 2))),
    (30, 44, 96, (12, 2, 576, (24, 2, 2))),
    (16, 16, 256, (2, 4, 512, (128, 8, 8))),
    (5, 7, 16, (1, 1, 64, (2, 1, 1))),
])
def test_up4_bwd_plan_and_workspace(H, W, C, want):
    p = up.up4_bwd_plan(H, W, C)
    assert (p["tiles_per_chunk"], p["column_boxes"], p["wgrad_chunk_tokens"],
            p["wgrad_tiles"]) == want
    assert max(p["smem"].values()) <= wa.SMEM_MAX
    for B in (1, 2, 4):
        assert up.up4_bwd_workspace(B, H, W, C) == _split_workspace_count(
            B, H, W, C, p["tiles_per_chunk"], p["wgrad_chunk_tokens"])


@pytest.mark.parametrize("C", [272, 40, 0])
def test_up4_bwd_plan_refuses_shapes_outside_the_design(C):
    with pytest.raises(ValueError, match=re.escape("C a multiple of 16 up to 256")):
        up.up4_bwd_plan(16, 16, C)


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
def test_up4_bwd_hands_the_entry_its_plan(H, W, C, monkeypatch):
    calls = _stub(monkeypatch, up, ["_check_up4_split"])
    B = 2
    z = lambda *s: torch.zeros(*s, device="meta", dtype=torch.bfloat16)
    v = lambda *s: torch.zeros(*s, device="meta")
    g = up.up4_bwd(z(B, H, W, C), z(C, 16 * C), v(1), z(C, C), v(C), v(1), z(C, C), z(C, C),
                   z(B, 4 * H, 4 * W, C))
    args = calls["sunet_up4_bwd"]
    assert args[16:21] == (B, H, W, C, up.up4_bwd_plan(H, W, C)["tiles_per_chunk"])
    assert g[1].shape == (C, 16 * C) and g[0].shape == (B, H, W, C)


@pytest.mark.parametrize("B,H", [(2, 8), (4, 16)])
def test_ln_mlp_branch_hands_the_entry_its_plan(B, H, monkeypatch):
    calls = _stub(monkeypatch, wa, ["_check_mlp"])
    C, hidden = 768, 3072
    z = lambda *s: torch.zeros(*s, device="meta", dtype=torch.bfloat16)
    v = lambda *s: torch.zeros(*s, device="meta")
    out = wa.ln_mlp_branch(z(B, H, H, C), (v(C), v(C)), z(C, hidden), v(hidden), z(hidden, C),
                           v(C))
    args = calls["sunet_ln_mlp_branch"]
    assert args[9:13] == (B * H * H, C, hidden, wa.mlp_plan(H * H, C, hidden)["ks"])
    assert out.shape == (B, H, H, C)


# ---------------------------------------------------------------- #11's emulation


def _tap_coef(P: int, t: int, n: int) -> float:
    """One axis of the clamped x4 stencil: the weight with which high-res
    index P reaches low-res target t (csrc/up4_bwd.cuh tap_coef)."""
    u, i = P >> 2, P & 3
    lo, hi = (max(u - 1, 0), u) if i < 2 else (u, min(u + 1, n - 1))
    return (up.P4[i][0] if lo == t else 0.0) + (up.P4[i][1] if hi == t else 0.0)


def _taps(t0: int, n: int) -> torch.Tensor:
    """(8, 12): the weights of targets t0 + p over the sources 4 (t0 + p - 1)
    + k, zero past the axis (csrc/up4_bwd.cu prep_dxb's cw and ch)."""
    rows = []
    for p in range(8):
        t = t0 + p
        rows.append([_tap_coef(4 * (t - 1) + k, t, n)
                     if t < n and 0 <= 4 * (t - 1) + k < 4 * n else 0.0 for k in range(12)])
    return torch.tensor(rows)


def _dxb_tiles(dout: torch.Tensor) -> torch.Tensor:
    """#11's prep tiles: per 8 x 8 tile, dout over the 40 x 40 high-res
    sources from (4 (th0 - 1), 4 (tw0 - 1)) (zero off the image), the W axis
    summed per row, then the H axis; float32, unrounded."""
    B, H4, W4, C = dout.shape
    H, W = H4 // 4, W4 // 4
    pad = torch.nn.functional.pad(dout, (0, 0, 4, 36, 4, 36))   # high-res row Y at Y + 4
    out = torch.zeros(B, H + 8, W + 8, C)
    for b in range(B):
        for th0 in range(0, H, 8):
            for tw0 in range(0, W, 8):
                D = pad[b, 4 * th0:4 * th0 + 40, 4 * tw0:4 * tw0 + 40]   # [40][40][C]
                cw, ch = _taps(tw0, W), _taps(th0, H)
                R = torch.stack([torch.einsum("k,rkc->rc", cw[p], D[:, 4 * p:4 * p + 12])
                                 for p in range(8)], 1)                  # [40][8][C]
                out[b, th0:th0 + 8, tw0:tw0 + 8] = torch.stack(
                    [torch.einsum("k,kwc->wc", ch[p], R[4 * p:4 * p + 12]) for p in range(8)])
    return out[:, :H, :W]


def _emulate_split(x, w_exp, alpha_p, w_b1, b_b1, alpha_b, wpf, wbf, dout):
    """#11 as its five launches decompose it, in plain torch, with their
    rounding points (no-ops for float32 inputs)."""
    dt = x.dtype
    rnd = lambda t: t.to(dt).float()
    f = lambda t: t.float()
    B, H, W, C = x.shape
    M = B * H * W
    plan = up.up4_bwd_plan(H, W, C)
    tpc, wct, nbx = plan["tiles_per_chunk"], plan["wgrad_chunk_tokens"], plan["column_boxes"]
    ap, ab = f(alpha_p).reshape(()), f(alpha_b).reshape(())
    prelu = lambda v, a: torch.clamp_min(v, 0) + a * torch.clamp_max(v, 0)
    xr = f(x).reshape(M, C)
    dob = rnd(f(dout))
    # 1: the strips (zb, abv); the tiles' dxb
    zb = xr @ f(w_b1) + f(b_b1)
    abv = rnd(prelu(zb, ab))
    dxb = rnd(_dxb_tiles(dob)).reshape(M, C)
    # 2: per (chunk, phase s, column box q): z, dP, dz, dwpf's rows of box q
    wexp_s = f(w_exp).reshape(C, C, 16).permute(2, 0, 1)
    tiles = [torch.tensor([(b * H + h) * W + w for h in range(h0, min(H, h0 + 8))
                           for w in range(w0, min(W, w0 + 8))])
             for b in range(B) for h0 in range(0, H, 8) for w0 in range(0, W, 8)]
    chunks = [torch.cat(tiles[i:i + tpc]) for i in range(0, len(tiles), tpc)]
    ppf, pap, dz = [], [], torch.zeros(M, 16 * C)
    for rows in chunks:
        for s in range(16):
            dos = dob[:, s // 4::4, s % 4::4].reshape(M, C)[rows]   # dout's phase-s tile rows
            part = torch.zeros(C, C)
            for q in range(nbx):
                cols = slice(64 * q, min(C, 64 * q + 64))
                z = xr[rows] @ wexp_s[s][:, cols]
                a = rnd(prelu(z, ap))
                dP = rnd(dos @ f(wpf)[cols].t())
                dz[rows, s * C + cols.start:s * C + cols.stop] = rnd(torch.where(z > 0, dP, ap * dP))
                pap.append((torch.clamp_max(z, 0) * dP).sum())
                part[cols] = a.t() @ dos
            ppf.append(part)
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
    return (dx.reshape(B, H, W, C), dwexp, _in_order(pap).reshape(alpha_p.shape),
            wsum(xr, dzb_b), dbb1, dab.reshape(alpha_b.shape), _in_order(ppf),
            wsum(abv, dxb))


def _split_inputs(dtype, B, H, W, C, seed):
    rng = np.random.default_rng(seed)
    n = lambda *s, sd=1.0: torch.from_numpy((rng.standard_normal(s) * sd).astype(np.float32))
    w = lambda i, o: n(i, o, sd=i ** -0.5).to(dtype)
    return (n(B, H, W, C).to(dtype), w(C, 16 * C), torch.tensor([0.25]), w(C, C),
            n(C, sd=0.1), torch.tensor([0.2]), w(C, C), w(C, C),
            n(B, 4 * H, 4 * W, C).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C", [(2, 12, 12, 32), (1, 5, 7, 16), (1, 6, 9, 256)])
def test_up4_bwd_emulation_matches_the_plain_version(dtype, B, H, W, C):
    """A map of four partial 8 x 8 tiles per image in chunks of three at one
    column box; a ragged (5, 7) map (one partial tile, every clamped edge of
    the stencil within it); C = 256, the cap, over four column boxes."""
    args = _split_inputs(dtype, B, H, W, C, 900 + H + C)
    with wa.exact_fp32():
        got = _emulate_split(*args)
        want = up.up4_bwd_reference(*args)
    _assert_limits(UP4_NAMES, got, want, dtype)


def test_phase_tiles_are_the_strided_pixel_boxes():
    """The phase launch's dout tile (a TMA box of every 4th pixel from (4 h0
    + i, 4 w0 + j), rows r = (pixel row) * 8 + (pixel column), zero past the
    image) equals phase s = 4 i + j of the plain version's pixel phases at
    the tile's pixels."""
    rng = np.random.default_rng(12)
    B, H, W, C = 2, 5, 11, 8
    dout = torch.from_numpy(rng.standard_normal((B, 4 * H, 4 * W, C)))
    phases = up._pixel_phases(dout)
    pad = torch.nn.functional.pad(dout, (0, 0, 0, 32, 0, 32))
    for b in range(B):
        for h0 in range(0, H, 8):
            for w0 in range(0, W, 8):
                for s in range(16):
                    i, j = s // 4, s % 4
                    box = pad[b, 4 * h0 + i:4 * h0 + i + 32:4, 4 * w0 + j:4 * w0 + j + 32:4]
                    want = torch.zeros(8, 8, C, dtype=dout.dtype)
                    hh, ww = min(8, H - h0), min(8, W - w0)
                    want[:hh, :ww] = phases[s][b, h0:h0 + hh, w0:w0 + ww]
                    torch.testing.assert_close(box.reshape(64, C), want.reshape(64, C),
                                               rtol=0, atol=0)


# ---------------------------------------------------------------- #13's emulation


def _emulate_branch(y, ln, w1, b1, w2, b2, ks):
    """#13 as its two launches decompose it, in plain torch, with their
    rounding points (no-ops for float32 inputs): the LayerNorm of each row
    in fc1's A load, fc2 over ks K ranges summed in rank order."""
    dt = y.dtype
    rnd = lambda t: t.to(dt).float()
    f = lambda t: t.float()
    C, hidden = y.shape[-1], w1.shape[1]
    yr = f(y).reshape(-1, C)
    mean = yr.sum(-1, keepdim=True) / C
    inv = torch.rsqrt(((yr - mean) ** 2).sum(-1, keepdim=True) / C + 1e-5)
    yn = rnd((yr - mean) * inv * f(ln[0]) + f(ln[1]))
    h = rnd(wa.gelu_erf(yn @ f(w1) + f(b1)))
    per = hidden // ks
    s = _in_order(h[:, r * per:(r + 1) * per] @ f(w2)[r * per:(r + 1) * per] for r in range(ks))
    return rnd(s + f(b2)).to(dt).reshape(y.shape)


def _branch_inputs(dtype, B, H, C, hidden, seed):
    rng = np.random.default_rng(seed)
    n = lambda *s, sd=1.0: torch.from_numpy((rng.standard_normal(s) * sd).astype(np.float32))
    w = lambda i, o: n(i, o, sd=i ** -0.5).to(dtype)
    return (n(B, H, H, C).to(dtype), (1 + n(C, sd=0.1), n(C, sd=0.1)), w(C, hidden),
            n(hidden, sd=0.1), w(hidden, C), n(C, sd=0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,C,hidden", [(2, 8, 64, 256), (3, 4, 96, 384)])
def test_ln_mlp_branch_emulation_matches_the_plain_version(dtype, B, H, C, hidden):
    """Two maps with #4's K split of fc2 (8 ranks at these widths) and a
    batch of three (4, 4) maps: a 64-row tile that spans images."""
    args = _branch_inputs(dtype, B, H, C, hidden, 950 + H + C)
    ks = wa.mlp_plan(H * H, C, hidden)["ks"]
    assert ks > 1
    with wa.exact_fp32():
        got = _emulate_branch(*args, ks)
        want = wa.ln_mlp_branch_reference(*args)
    _assert_limits(("out",), (got,), (want,), dtype)
