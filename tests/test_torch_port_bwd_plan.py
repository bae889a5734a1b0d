"""The block backward's plan (#7 and #8, csrc/swin_block_bwd.cuh and
csrc/block_bwd_hopper.cuh) on the CPU: plain Python that sizes each launch
from one image's shape, held to the design's limits, and a plain-torch
emulation of the kernels' decomposition held against the plain versions.

- ``block_bwd_plan`` fits the H100's shared memory at every width of
  ``Config()``, the 16-band model and ``tiny_config()`` and takes no batch;
  it refuses a shape outside the design with the wrappers' reason, and the
  router sends no block it refuses to the block backward.
- The weight-gradient launch's table covers each (product, output tile,
  token chunk) exactly once, and the chunks cover the tokens.
- ``expected_launches`` of the default model, on the residual route and
  with ``ROUTE_TRAIN_RESID`` off, is the per-call constants times the calls
  (its C=768 stage on #1's sequence form and #8).
- The emulation: the token-row products, LN backwards whose row sums come
  from 128-column ranks summed in rank order, the attention per (window,
  head) with the head dim zero-padded to 16, its rel-pos bias and qkv bias
  partials per chunk of windows, the weight gradients as fixed token-chunk
  partials summed in order, and b2's and bproj's gradients as column sums of
  the dB chunks. float32 inputs: max |diff| <= 1e-4 * max(1, max|ref|)
  (other summation orders, as in test_torch_port_train.py); bfloat16
  inputs: chip_smoke's backward limits (dx max 1e-1 and mean 2e-3 of
  max(1, |ref|), every weight grad mean 1e-2 of mean |ref|), the limits the
  kernels are held to on the card.
"""

import dataclasses
import inspect
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sunet_tf_tpu_torch.config import Config, tiny_config
from sunet_tf_tpu_torch.kernels import window_attention as wa
from sunet_tf_tpu_torch.models import layers
from sunet_tf_tpu_torch.models.sunet import build_model
from sunet_tf_tpu_torch.ops.window import roll2d, shift_attn_mask, window_partition, \
    window_reverse


def _bands():
    cfg = Config()
    return dataclasses.replace(cfg, swinunet=dataclasses.replace(cfg.swinunet, in_chans=16,
                                                                 out_chans=16))


CONFIGS = {"Config()": Config, "16-band": _bands, "tiny_config()": tiny_config}


def _stages(cfg):
    """(H, C, hidden, ws, heads) of every encoder stage (the decoder's blocks
    repeat these widths) at the config's image size."""
    sw = cfg.swinunet
    res = sw.img_size // sw.patch_size
    for i, heads in enumerate(sw.head_num):
        h = res // 2 ** i
        C = sw.emb_dim * 2 ** i
        yield h, C, int(C * sw.mlp_ratio), min(sw.win_size, h), heads


@pytest.mark.parametrize("name", list(CONFIGS))
def test_block_bwd_plan_fits_every_width(name):
    for H, C, hidden, ws, heads in _stages(CONFIGS[name]()):
        if C > wa.BLOCK_KERNEL_MAX_C:
            continue
        why = wa.block_bwd_why(C, hidden, heads, ws)
        if (ws * ws) % 16:
            # a window the window kernels refuse (tiny_config()'s 2 x 2 stage)
            assert why is not None and "window" in why
            with pytest.raises(ValueError, match="window"):
                wa.block_bwd_plan(H, H, C, hidden, ws, heads)
            continue
        p = wa.block_bwd_plan(H, H, C, hidden, ws, heads)
        assert max(p["smem"].values()) <= wa.SMEM_MAX, (C, p)
        assert p["G"] == -(-C // 128) and 1 <= p["G"] <= 6
        assert p["chunk_tokens"] % 64 == 0 and p["chunk_tokens"] >= 64
        assert p["windows_per_chunk"] >= 1
        for name, cols in (("qkv", 3 * C), ("fc1", hidden)):
            assert 1 <= p["tiles_per_cta"][name] <= -(-cols // 128), (name, p)
        assert p["wgrad_tiles"] == (-(-hidden // 64) * -(-C // 128), -(-C // 64) * -(-hidden // 128),
                                    -(-C // 64) * -(-C // 128), -(-C // 64) * -(-3 * C // 128))


def test_block_bwd_plan_does_not_depend_on_the_batch():
    """The plan takes one image's shape: the chunks' boundaries are the same
    at any batch, only their count grows with it."""
    assert list(inspect.signature(wa.block_bwd_plan).parameters) == [
        "H", "W", "C", "hidden", "ws", "heads"]
    for H, C in ((64, 96), (32, 192), (16, 384)):
        p = wa.block_bwd_plan(H, H, C, 4 * C, 8, 8)
        for B in (1, 2, 4, 8):
            chunks = {e[3] for e in wa.block_bwd_wgrad_table(H, H, C, 4 * C, 8, 8, B)}
            assert chunks == set(range(-(-B * H * H // p["chunk_tokens"])))


@pytest.mark.parametrize("H,C,hidden,ws,heads,B", [(64, 96, 384, 8, 8, 2), (32, 192, 768, 8, 8, 4),
                                                   (16, 384, 1536, 8, 8, 2),
                                                   (16, 160, 640, 4, 8, 3)])
def test_wgrad_table_covers_each_entry_once(H, C, hidden, ws, heads, B):
    p = wa.block_bwd_plan(H, H, C, hidden, ws, heads)
    table = wa.block_bwd_wgrad_table(H, H, C, hidden, ws, heads, B)
    T, ct = B * H * H, p["chunk_tokens"]
    nch = -(-T // ct)
    want = set()
    for prod, (M, N) in enumerate(((hidden, C), (C, hidden), (C, C), (C, 3 * C))):
        for mt in range(-(-M // 64)):
            for nt in range(-(-N // 128)):
                for ch in range(nch):
                    want.add((prod, mt, nt, ch))
    assert len(table) == len(want) == sum(p["wgrad_tiles"]) * nch
    assert set(table) == want
    # the chunks' token ranges tile [0, T): only the last one is short
    covered = np.zeros(T, int)
    for ch in range(nch):
        covered[ch * ct:min(T, (ch + 1) * ct)] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("C,hidden,heads,ws,match,res_only", [
    # head dims above 64: the residual route (#7) alone refuses them, #8
    # takes them where its attention fits shared memory (up to 192 at 64
    # tokens)
    (384, 1536, 2, 8, "head dim 192 above 64", True),
    (96, 384, 1, 8, "head dim 96 above 64", True),
    (416, 1664, 2, 8, "head dim 208 needs 239552 bytes", False),
    (104, 416, 8, 8, "multiples of 16", False),
    (96, 384, 8, 2, "window 2 gives 4 tokens", False),
    (96, 384, 5, 8, "not divisible by 5 heads", False),
    (48, 192, 16, 8, "head dim 3 is odd", False),
    (832, 3328, 16, 8, "above 768", False),
])
def test_block_bwd_plan_refuses_shapes_outside_the_design(C, hidden, heads, ws, match,
                                                          res_only):
    """A shape outside a route's design: its reason from ``block_bwd_why``
    (``res``: the residual route's), the plan refused where the recompute
    form refuses it too, and each wrapper's own check by its route."""
    why_res, why = (wa.block_bwd_why(C, hidden, heads, ws, res=res) for res in (True, False))
    assert why_res is not None   # the residual route refuses every case
    with pytest.raises(ValueError, match=re.escape(f"swin_block_bwd_res: {why_res}")):
        wa._check_bwd_design("swin_block_bwd_res", C, hidden, heads, ws)
    if res_only:
        assert match in why_res and why is None
        wa._check_bwd_design("swin_block_bwd", C, hidden, heads, ws)
        assert max(wa.block_bwd_plan(8 * ws, 8 * ws, C, hidden, ws, heads)["smem"].values()) \
            <= wa.SMEM_MAX
        return
    assert why is not None and match in why
    with pytest.raises(ValueError, match=match):
        wa.block_bwd_plan(8 * ws, 8 * ws, C, hidden, ws, heads)
    with pytest.raises(ValueError, match=re.escape(f"swin_block_bwd: {why}")):
        wa._check_bwd_design("swin_block_bwd", C, hidden, heads, ws)


@pytest.mark.parametrize("heads", [(8, 8, 8, 8), (2, 2, 2, 1), (8, 8, 2, 8)])
def test_router_never_sends_a_refused_shape_to_the_block_backward(heads):
    """Every block the training router sends to the block backward (either
    route) has a width the route's kernels take: a head dim above 64 (C=128
    with one head, C=384 with two) on the recompute route alone, whose
    attention takes up to 192 at 64 tokens; a wider one (C=768 with one
    head) goes to no block kernel."""
    for cfg in (Config(), tiny_config()):
        if cfg.swinunet.emb_dim == 16 and max(heads) == 8:
            continue
        cfg = dataclasses.replace(cfg, swinunet=dataclasses.replace(cfg.swinunet,
                                                                    head_num=heads))
        model = build_model(cfg, device="meta", backend="fused", seed=0)
        for stage in list(model.layers) + list(model.layers_up[1:]):
            for blk in stage.blocks:
                hidden = blk.mlp.fc1.out_features
                takes = wa.block_bwd_takes(blk.dim, hidden, blk.attn.num_heads)
                if blk.trains_on_block_kernels():
                    assert takes, (blk.dim, blk.attn.num_heads)
                    if blk.trains_on_residuals():
                        assert wa.block_bwd_takes(blk.dim, hidden, blk.attn.num_heads, res=True)
                    if (blk.window_size ** 2) % 16 == 0:
                        wa.block_bwd_plan(8 * blk.window_size, 8 * blk.window_size, blk.dim,
                                          hidden, blk.window_size, blk.attn.num_heads)
                elif blk.dim <= layers.ROUTE_TRAIN_BLOCK_MAX_C:
                    assert not takes or not blk.takes_block_kernel()


@pytest.mark.parametrize("resid", [True, False])
def test_expected_launches_are_the_per_call_constants(resid, monkeypatch):
    monkeypatch.setattr(layers, "ROUTE_TRAIN_RESID", resid)
    assert (wa.SWIN_BLOCK_BWD_LAUNCHES, wa.SWIN_BLOCK_BWD_RES_LAUNCHES) == (11, 10)
    model = build_model(Config(), device="meta", backend="fused", seed=0)
    got = model.expected_launches((4, 256, 256, 3), train=True)
    # depths 8/8/8/8, encoder and decoder: C=96 and 192 are 16 blocks each,
    # C=384 16, the C=768 bottleneck 8, on the block kernels too: the
    # sequence form's train form (5 launches a block) and the recompute
    # backward (11)
    seq = 8 * wa.SWIN_BLOCK_SEQ_LAUNCHES
    assert got["ln_window_attention_bwd"] == got["ln_mlp_bwd"] == 0
    if resid:
        assert got["swin_block_bwd_res"] == 32 * wa.SWIN_BLOCK_BWD_RES_LAUNCHES == 320
        assert got["swin_block_bwd"] == 24 * wa.SWIN_BLOCK_BWD_LAUNCHES == 264
        assert got["fused_swin_block_res"] == 32 and got["fused_swin_block"] == 16 + seq == 56
    else:
        assert got["swin_block_bwd_res"] == 0 and got["fused_swin_block_res"] == 0
        assert got["swin_block_bwd"] == 56 * wa.SWIN_BLOCK_BWD_LAUNCHES == 616
        assert got["fused_swin_block"] == 48 + seq == 88


# ---------------------------------------------------------------- the emulation


def _emulate(x, dout, ln1, wqkv, bqkv, wproj, bproj, ln2, w1, b1, w2, b2, bias, mask, dp, *,
             ws, num_heads, scale, shift, state=None):
    """The block backward as the kernels decompose it, in plain torch, with
    their rounding points (no-ops for float32 inputs). ``state``: the
    residual route's (eb, rden, ctx_f), else the recompute form."""
    dt = x.dtype
    rnd = lambda t: t.to(dt).float()
    f = lambda t: t.float()
    B, H, W, C = x.shape
    hidden, heads = w1.shape[1], num_heads
    N, T, d = ws * ws, B * H * W, C // heads
    dpad = -(-d // 16) * 16
    nwin, nW = T // N, (H // ws) * (W // ws)
    plan = wa.block_bwd_plan(H, W, C, hidden, ws, heads)
    G, ct, wpc = plan["G"], plan["chunk_tokens"], plan["windows_per_chunk"]
    img = torch.arange(T) // (H * W)
    s1, s2 = f(dp)[img, 0:1], f(dp)[img, 1:2]
    rows = lambda t: window_partition(roll2d(t, -shift), ws).reshape(T, t.shape[-1])
    unrows = lambda t: roll2d(window_reverse(t.reshape(-1, N, C), ws, H, W), shift)
    mm = lambda a, b: f(a) @ f(b)

    def in_order(parts):   # a fixed-order sum of partials
        acc = 0.0
        for p in parts:
            acc = acc + p
        return acc

    tiles = lambda m: in_order(m[i:i + 64].sum(0) for i in range(0, T, 64))

    def ln_fwd(r, g, b):
        mean = r.mean(-1, keepdim=True)
        inv = torch.rsqrt(((r - mean) ** 2).mean(-1, keepdim=True) + 1e-5)
        return rnd((r - mean) * inv * f(g) + f(b)), mean, inv

    def ln_bwd(dd, r, mean, inv, g):
        """t of the LN backward, the row sums from G ranks of 128 columns in
        rank order; dg and db from 64-row tile partials."""
        xh = (r - mean) * inv
        dxh = dd * f(g)
        m1 = in_order(dxh[:, 128 * q:128 * (q + 1)].sum(-1, keepdim=True) for q in range(G)) / C
        m2 = in_order((dxh * xh)[:, 128 * q:128 * (q + 1)].sum(-1, keepdim=True)
                      for q in range(G)) / C
        return inv * (dxh - m1 - xh * m2), tiles(dd * xh), tiles(dd)

    def heads_(m):   # (T, C) -> (nwin, heads, N, dpad), the head dim zero-padded
        return F.pad(m.reshape(nwin, N, heads, d).permute(0, 2, 1, 3), (0, dpad - d))

    unheads = lambda h: h[..., :d].permute(0, 2, 1, 3).reshape(T, C)

    # 1-4: the forward recompute
    xw = f(rows(x))
    u, mean1, inv1 = ln_fwd(xw, *ln1)
    qkv = rnd(mm(u, wqkv) + (0.0 if bqkv is None else f(bqkv)))
    q = rnd(heads_(qkv[:, :C]) * scale)
    k, v = heads_(qkv[:, C:2 * C]), heads_(qkv[:, 2 * C:])
    if state is None:
        s = q @ k.transpose(-1, -2) + f(bias)[None]
        if mask is not None:
            s = s + f(mask)[torch.arange(nwin) % nW][:, None]
        P = torch.softmax(s, -1)
        ctx = rnd(unheads(rnd(P) @ v))
    else:
        eb, rden, ctxf = state
        ctx = rnd(ctxf)
    y = rnd(xw + s1 * (mm(ctx, wproj) + f(bproj)))
    yn, mean2, inv2 = ln_fwd(y, *ln2)
    a = mm(yn, w1) + f(b1)
    h1 = rnd(wa.gelu_erf(a))
    # 5-6: the MLP sublayer, da's column partials per 64-row tile
    dm = rnd(s2 * f(rows(dout)))
    da = mm(dm, w2.t()) * wa.gelu_erf_grad(a)
    dab = rnd(da)
    t2, dg2, db2 = ln_bwd(mm(dab, w1.t()), y, mean2, inv2, ln2[0])
    dy = f(rows(dout)) + t2
    dattn = rnd(s1 * dy)
    # 7-8: the attention sublayer per (window, head), padded head dims
    dctx = mm(dattn, wproj.t())
    if state is None:
        o = heads_(rnd(dctx))
        dP = o @ v.transpose(-1, -2)
        ds = P * (dP - (dP * P).sum(-1, keepdim=True))
        pb = rnd(P)
    else:
        dn = heads_(dctx) * f(rden)[..., None]
        o = rnd(dn)
        t = rnd(dn * heads_(f(ctxf))).sum(-1, keepdim=True)
        pb = f(eb)
        ds = pb * (o @ v.transpose(-1, -2) - t)
    dsb = rnd(ds)
    dqkv = torch.cat([unheads(dsb @ k * scale), unheads(dsb.transpose(-1, -2) @ q),
                      unheads(pb.transpose(-1, -2) @ o)], -1)
    dbias = in_order(ds[w:w + wpc].sum(0) for w in range(0, nwin, wpc))
    dbqkv = in_order(dqkv[w * N:(w + wpc) * N].sum(0) for w in range(0, nwin, wpc))
    dqkv_b = rnd(dqkv)
    # 9: the LN1 backward
    t1, dg1, db1 = ln_bwd(mm(dqkv_b, wqkv.t()), xw, mean1, inv1, ln1[0])
    dx = unrows(rnd(dy + t1)).to(dt)
    # 10-11: the weight gradients in token chunks; b2's and bproj's as
    # column sums of the dB chunks
    wsum = lambda X, D: in_order(mm(X[i:i + ct].t(), D[i:i + ct]) for i in range(0, T, ct))
    csum = lambda D: in_order(D[i:i + ct].sum(0) for i in range(0, T, ct))
    return (dx, dg1, db1, wsum(u, dqkv_b), dbqkv, wsum(ctx, dattn), csum(dattn), dg2, db2,
            wsum(yn, dab), tiles(da), wsum(h1, dm), csum(dm), dbias)


def _inputs(dtype, shift, seed):
    """B 2, (16,16,160), 8 heads (head dim 20, padded to 32), window 4 (16
    tokens), hidden 640: two 128-column ranks per row, two token chunks of
    the weight gradients, two windows per attention chunk."""
    rng = np.random.default_rng(seed)
    B, H, C, heads, ws = 2, 16, 160, 8, 4
    n = lambda *s, sd=1.0: torch.from_numpy((rng.standard_normal(s) * sd).astype(np.float32))
    w = lambda i, o: n(i, o, sd=i ** -0.5).to(dtype)
    p = [1 + n(C, sd=0.1), n(C, sd=0.1), w(C, 3 * C), n(3 * C, sd=0.1), w(C, C), n(C, sd=0.1),
         1 + n(C, sd=0.1), n(C, sd=0.1), w(C, 4 * C), n(4 * C, sd=0.1), w(4 * C, C),
         n(C, sd=0.1), n(heads, ws * ws, ws * ws)]
    x, dout = n(B, H, H, C).to(dtype), n(B, H, H, C).to(dtype)
    mask = torch.from_numpy(shift_attn_mask(H, H, ws, shift)) if shift else None
    dp = torch.tensor([[1 / 0.9, 0.0], [1 / 0.9, 1 / 0.9]])
    args = (x, dout, p[0:2], p[2], p[3], p[4], p[5], p[6:8], p[8], p[9], p[10], p[11], p[12],
            mask, dp)
    return args, dict(ws=ws, num_heads=heads, scale=8.0, shift=shift)


def _hold(got, want, dtype):
    names = ("dx",) + tuple(f"grad {i}" for i in range(1, 14))
    if dtype == torch.float32:
        for name, g, r in zip(names, got, want):
            err = float((g.float() - r.float()).abs().max())
            assert err <= 1e-4 * max(1.0, float(r.abs().max())), (name, err)
        return
    d = (got[0].float() - want[0].float()).abs()
    assert float(d.max()) <= 1e-1 * max(1.0, float(want[0].float().abs().max()))
    assert float(d.mean()) <= 2e-3 * max(1.0, float(want[0].float().abs().mean()))
    for name, g, r in zip(names[1:], got[1:], want[1:]):
        rel = float((g - r).abs().mean()) / max(float(r.abs().mean()), 1e-30)
        assert rel <= 1e-2, (name, rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0, 2])
def test_emulation_matches_the_recompute_reference(dtype, shift):
    args, kw = _inputs(dtype, shift, 200 + shift)
    _hold(_emulate(*args, **kw), wa.swin_block_bwd_reference(*args, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0, 2])
def test_emulation_matches_the_residual_reference(dtype, shift):
    args, kw = _inputs(dtype, shift, 210 + shift)
    x, dout, *p, mask, dp = args
    _, *state = wa.fused_swin_block_res_reference(x, *p, mask, dp, **kw)
    rargs = (x, dout, *state, *p[:-1], dp)
    _hold(_emulate(*args, **kw, state=tuple(state)),
          wa.swin_block_bwd_res_reference(*rargs, **kw), dtype)
