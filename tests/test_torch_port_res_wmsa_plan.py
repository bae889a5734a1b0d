"""The residual block forward (#6) on the cluster block kernel and the
LN+W-MSA backward (#12) on the block backward's kernels, on the CPU: the
plans the wrappers hand the kernels, the C entries' ctypes signatures
against the sources, the training router's rules, and a plain-torch
emulation of #12's launch decomposition held against its plain version.

- #6 launches ``csrc/swin_cluster.cu``'s residual form with
  ``block_plan``'s cluster size (the wrapper's call recorded with the
  library stubbed), and every C entry's ctypes signature in
  ``_build.SIGNATURES`` matches its definition in ``csrc/*.cu``.
- Over a grid of block shapes, a block that trains on the residual route
  also has a block-kernel plan (both forwards run on the cluster kernel);
  ``Config()`` still trains 32 blocks on #6 and 16 on #1.
- #12's plan (``ln_wmsa_bwd_plan``) and workspace
  (``ln_wmsa_bwd_workspace``) at the default bottleneck's (8,8,768) with 8
  heads and at (16,16,384) with 2 heads (head dim 192), against counts
  written out here; ``LN_WMSA_BWD_LAUNCHES`` and the default step's
  ``expected_launches`` agree; a head dim beyond the attention's shared
  memory is refused with a message, and the router then trains that block
  on the eager block, while C=384 with 2 heads stays on the kernels.
- The emulation: LN1 + qkv gathered in window order, the attention with the
  head dim zero-padded to 16 (head dims 96 and 20), dctx from dout at scale
  1, the LN1 backward's row sums from 128-column ranks in rank order with no
  residual term, the weight gradients as token-chunk partials (or the
  gradient itself with one chunk), dbproj as dout's column sums. float32:
  max |diff| <= 1e-4 * max(1, max|ref|); bfloat16: chip_smoke's backward
  limits, as in ``test_torch_port_bwd_plan.py``.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sunet_tf_tpu_torch.config import Config, tiny_config
from sunet_tf_tpu_torch.kernels import _build
from sunet_tf_tpu_torch.kernels import window_attention as wa
from sunet_tf_tpu_torch.models import layers
from sunet_tf_tpu_torch.models.sunet import build_model
from sunet_tf_tpu_torch.ops.window import shift_attn_mask, window_partition, window_reverse

CSRC = Path(wa.__file__).resolve().parent / "csrc"
CTYPE = {"int": _build._I, "float": _build._F, "long long": _build.ctypes.c_longlong}


def _c_params(name: str) -> list:
    """ctypes types of the parameters of C entry ``name`` as defined in csrc."""
    for src in sorted(CSRC.glob("*.cu")):
        m = re.search(r'extern "C" \w+ ' + name + r"\(([^)]*)\)", src.read_text())
        if m:
            types = []
            for p in m.group(1).split(","):
                t = " ".join(p.split()[:-1]).replace("const ", "")
                types.append(_build._P if t.endswith("*") else CTYPE[t])
            return types
    raise AssertionError(f"{name} is defined in no csrc/*.cu")


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_ctypes_signatures_match_the_sources(name):
    assert _c_params(name) == _build.SIGNATURES[name]


def _stub_library(monkeypatch) -> dict:
    """Stub the kernel library and the CUDA checks of the block wrappers:
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
    monkeypatch.setattr(wa, "_check_block", lambda *a, **k: None)
    return calls


@pytest.mark.parametrize("H,C,heads", [(64, 96, 8), (32, 192, 8), (16, 384, 8), (32, 192, 3)])
def test_res_form_takes_the_block_plan(H, C, heads, monkeypatch):
    calls = _stub_library(monkeypatch)
    hidden, ws, B = 4 * C, 8, 2
    x = torch.zeros(B, H, H, C, dtype=torch.bfloat16)
    w = lambda i, o: torch.zeros(i, o, dtype=torch.bfloat16)
    v = lambda n: torch.zeros(n)
    out, eb, rden, ctx = wa._launch_block(
        x, (v(C), v(C)), w(C, 3 * C), v(3 * C), w(C, C), v(C), (v(C), v(C)), w(C, hidden),
        v(hidden), w(hidden, C), v(C), torch.zeros(heads, 64, 64), None, torch.ones(B, 2),
        ws=ws, num_heads=heads, scale=8.0, shift=0, res=True)
    args = calls["sunet_swin_block_res"]
    assert args[-2] == wa.block_plan(H, H, C, hidden, ws, heads)["G"]
    assert args[20:28] == (B, H, H, C, hidden, ws, heads, 0)
    nwin = B * (H // ws) ** 2
    assert eb.shape == (nwin, heads, 64, 64) and eb.dtype == torch.bfloat16
    assert rden.shape == (nwin, heads, 64) and ctx.shape == (B * H * H, C)
    # the inference launch takes the same plan
    wa._launch_block(x, (v(C), v(C)), w(C, 3 * C), v(3 * C), w(C, C), v(C), (v(C), v(C)),
                     w(C, hidden), v(hidden), w(hidden, C), v(C), torch.zeros(heads, 64, 64),
                     None, ws=ws, num_heads=heads, scale=8.0, shift=0)
    assert calls["sunet_swin_block"][-2] == args[-2]


GRID = [(C, hidden, heads, ws) for C in (32, 96, 128, 160, 192, 384)
        for hidden in (2 * C, 4 * C) for heads in (1, 2, 3, 4, 6, 8) for ws in (4, 8)
        if C % heads == 0]


@pytest.mark.parametrize("ws", [4, 8])
def test_residual_route_needs_the_block_plan(ws):
    """Every block that trains on the residual route has a block-kernel
    plan and the residual backward's head dim; one that trains on the
    block kernels has both kernels' plans: the cluster kernel's or the
    sequence form's train plan, and the recompute backward's."""
    seen = 0
    for C, hidden, heads, w in GRID:
        if w != ws:
            continue
        with torch.device("meta"):
            blk = layers.SwinBlock(C, (8 * ws, 8 * ws), heads, window_size=ws, shift_size=0,
                                   mlp_ratio=hidden / C, backend="fused")
        if blk.trains_on_block_kernels():
            if not wa.block_kernel_takes(C, hidden, heads):
                wa.block_seq_plan(8 * ws, 8 * ws, C, hidden, ws, heads, train=True)
            assert wa.block_bwd_takes(C, hidden, heads, ws), (C, hidden, heads)
            wa.block_bwd_plan(8 * ws, 8 * ws, C, hidden, ws, heads)
            if blk.trains_on_residuals():
                assert wa.block_kernel_takes(C, hidden, heads), (C, hidden, heads)
                assert wa.block_bwd_takes(C, hidden, heads, ws, res=True), (C, hidden, heads)
                seen += 1
        elif blk.trains_on_split_kernels():
            wa.ln_wmsa_bwd_plan(8 * ws, 8 * ws, C, ws, heads)
    assert seen > 0


def test_default_step_routes_and_launch_counts():
    assert wa.LN_WMSA_BWD_LAUNCHES == 7
    model = build_model(Config(), device="meta", backend="fused", seed=0)
    got = model.expected_launches((4, 256, 256, 3), train=True)
    # the C=768 bottleneck: 8 blocks on the sequence form's train form, 5
    # launches each, beside the 16 C=384 blocks on the cluster kernel; none
    # on the sublayer kernels
    assert got["fused_swin_block_res"] == 32
    assert got["fused_swin_block"] == 16 + 8 * wa.SWIN_BLOCK_SEQ_LAUNCHES == 56
    assert got["ln_window_attention_bwd"] == got["fused_ln_window_attention"] == 0


def _workspace_count(B, H, C, ws, heads, chunk, wpc):
    """#12's workspace bytes written out: seven bf16 token matrices (x and
    LN1(x) gathered, qkv, ctx, dout gathered, round(dctx), round(dqkv)), the
    LN statistics, the weight gradients' partials when there is more than
    one chunk, and the LN, qkv-bias and rel-pos-bias partials; each piece
    rounded up to 128 bytes."""
    up = lambda n: -(-n // 128) * 128
    T, N, nW = B * H * H, ws * ws, (H // ws) ** 2
    nch, ach, rt = -(-T // chunk), -(-B * nW // wpc), -(-T // 64)
    total = up(T * C * 2) * 5 + up(3 * T * C * 2) * 2 + up(2 * T * 4)
    if nch > 1:
        total += up(nch * C * C * 4) + up(nch * 3 * C * C * 4) + up(nch * C * 4)
    return total + up(rt * 2 * C * 4) + up(ach * 3 * C * 4) + up(ach * heads * N * N * 4)


@pytest.mark.parametrize("H,C,heads,want", [
    # G, tokens per chunk, weight-gradient tiles, windows per chunk, qkv tiles per CTA
    (8, 768, 8, (6, 256, (72, 216), 1, 1)),
    (16, 384, 2, (3, 256, (18, 54), 1, 1)),
])
def test_ln_wmsa_bwd_plan_and_workspace(H, C, heads, want):
    p = wa.ln_wmsa_bwd_plan(H, H, C, 8, heads)
    assert (p["G"], p["chunk_tokens"], p["wgrad_tiles"], p["windows_per_chunk"],
            p["tiles_per_cta"]["qkv"]) == want
    assert max(p["smem"].values()) <= wa.SMEM_MAX
    # the attention's shared memory at the head dim: 96 at C=768, 192 at C=384
    assert p["smem"]["attn"] == {96: 127104, 192: 223488}[C // heads]
    for B in (1, 2, 4):
        assert wa.ln_wmsa_bwd_workspace(B, H, H, C, 8, heads) == _workspace_count(
            B, H, C, 8, heads, p["chunk_tokens"], p["windows_per_chunk"])
    assert list(wa.ln_wmsa_bwd_plan.__wrapped__.__code__.co_varnames[:5]) == [
        "H", "W", "C", "ws", "heads"]


@pytest.mark.parametrize("C,heads,ws,match", [
    (768, 2, 8, "head dim 384 needs 416256 bytes"),
    (416, 2, 8, "head dim 208 needs 239552 bytes"),
    (48, 16, 8, "head dim 3 is odd"),
    (832, 8, 8, "above 768"),
    (768, 8, 2, "window 2 gives 4 tokens"),
    (104, 8, 8, "multiple of 16"),
])
def test_ln_wmsa_bwd_refuses_shapes_outside_the_design(C, heads, ws, match):
    why = wa.ln_wmsa_bwd_why(C, heads, ws)
    assert why is not None and match in why
    with pytest.raises(ValueError, match=re.escape(why)):
        wa.ln_wmsa_bwd_plan(8 * ws, 8 * ws, C, ws, heads)


def _with_heads(cfg, heads):
    return dataclasses.replace(cfg, swinunet=dataclasses.replace(cfg.swinunet, head_num=heads))


def test_router_trains_a_refused_head_dim_on_the_eager_block():
    """The bottleneck with 2 heads (head dim 384) is beyond the backward
    kernels' shared memory (the block backward's and the LN+W-MSA
    backward's alike): it trains on the eager block and launches nothing;
    C=384 with 2 heads (head dim 192), which the cluster kernel refuses,
    trains on the block kernels (the sequence form's train form and the
    recompute backward)."""
    model = build_model(_with_heads(Config(), (8, 8, 2, 2)), device="meta", backend="fused",
                        seed=0)
    stage3 = model.layers[3].blocks[0]
    assert stage3.dim == 768 and stage3.attn.num_heads == 2
    assert not stage3.trains_on_block_kernels() and not stage3.trains_on_split_kernels()
    stage2 = model.layers[2].blocks[0]
    assert stage2.trains_on_block_kernels() and not stage2.trains_on_residuals()
    got = model.expected_launches((4, 256, 256, 3), train=True)
    # C=384 (8 + 8 blocks) on the sequence form; C=768 (8) on eager autograd
    assert got["ln_window_attention_bwd"] == 0
    assert got["fused_swin_block"] == 16 * wa.SWIN_BLOCK_SEQ_LAUNCHES
    assert got["swin_block_bwd"] == 16 * wa.SWIN_BLOCK_BWD_LAUNCHES
    assert got["fused_swin_block_res"] == 32


def test_router_keeps_every_tiny_block_on_kernels():
    model = build_model(tiny_config(), device="meta", backend="fused", seed=0)
    for stage in list(model.layers) + list(model.layers_up[1:]):
        for blk in stage.blocks:
            assert blk.trains_on_block_kernels() and blk.trains_on_residuals()


# ---------------------------------------------------------------- the emulation


def _emulate_wmsa(x, dout, g, b, wqkv, bqkv, wproj, bias, mask, *, ws, num_heads, scale):
    """#12 as its launches decompose it, in plain torch, with their rounding
    points (no-ops for float32 inputs)."""
    dt = x.dtype
    rnd = lambda t: t.to(dt).float()
    f = lambda t: t.float()
    B, H, W, C = x.shape
    heads, N, T = num_heads, ws * ws, B * H * W
    d = C // heads
    dpad = -(-d // 16) * 16
    nwin, nW = T // N, (H // ws) * (W // ws)
    plan = wa.ln_wmsa_bwd_plan(H, W, C, ws, heads)
    G, ct, wpc = plan["G"], plan["chunk_tokens"], plan["windows_per_chunk"]
    rows = lambda t: window_partition(t, ws).reshape(T, t.shape[-1])
    mm = lambda p, q: f(p) @ f(q)

    def in_order(parts):
        acc = 0.0
        for p in parts:
            acc = acc + p
        return acc

    tiles = lambda m: in_order(m[i:i + 64].sum(0) for i in range(0, T, 64))
    heads_ = lambda m: F.pad(m.reshape(nwin, N, heads, d).permute(0, 2, 1, 3), (0, dpad - d))
    unheads = lambda h: h[..., :d].permute(0, 2, 1, 3).reshape(T, C)

    # 1-2: LN1 + qkv, the attention forward
    xw = f(rows(x))
    mean = xw.mean(-1, keepdim=True)
    inv = torch.rsqrt(((xw - mean) ** 2).mean(-1, keepdim=True) + 1e-5)
    u = rnd((xw - mean) * inv * f(g) + f(b))
    qkv = rnd(mm(u, wqkv) + (0.0 if bqkv is None else f(bqkv)))
    q = rnd(heads_(qkv[:, :C]) * scale)
    k, v = heads_(qkv[:, C:2 * C]), heads_(qkv[:, 2 * C:])
    s = q @ k.transpose(-1, -2) + f(bias)[None]
    if mask is not None:
        s = s + f(mask)[torch.arange(nwin) % nW][:, None]
    P = torch.softmax(s, -1)
    ctx = rnd(unheads(rnd(P) @ v))
    # 3-4: dctx from dout at scale 1, the attention backward
    dm = rnd(f(rows(dout)))
    o = heads_(rnd(mm(dm, wproj.t())))
    dP = o @ v.transpose(-1, -2)
    ds = P * (dP - (dP * P).sum(-1, keepdim=True))
    dsb = rnd(ds)
    dqkv = torch.cat([unheads(dsb @ k * scale), unheads(dsb.transpose(-1, -2) @ q),
                      unheads(rnd(P).transpose(-1, -2) @ o)], -1)
    dbias = in_order(ds[w:w + wpc].sum(0) for w in range(0, nwin, wpc))
    dbqkv = in_order(dqkv[w * N:(w + wpc) * N].sum(0) for w in range(0, nwin, wpc))
    dqkv_b = rnd(dqkv)
    # 5: the LN1 backward, row sums from G ranks of 128 columns, no residual
    du = mm(dqkv_b, wqkv.t())
    xh = (xw - mean) * inv
    dxh = du * f(g)
    m1 = in_order(dxh[:, 128 * r:128 * (r + 1)].sum(-1, keepdim=True) for r in range(G)) / C
    m2 = in_order((dxh * xh)[:, 128 * r:128 * (r + 1)].sum(-1, keepdim=True)
                  for r in range(G)) / C
    dx = window_reverse(rnd(inv * (dxh - m1 - xh * m2)).reshape(-1, N, C), ws, H, W).to(dt)
    # 6-7: the weight gradients in token chunks, dbproj as dout's column sums
    wsum = lambda X, D: in_order(mm(X[i:i + ct].t(), D[i:i + ct]) for i in range(0, T, ct))
    return (dx, tiles(du * xh), tiles(du), wsum(u, dqkv_b), dbqkv, wsum(ctx, dm),
            in_order(dm[i:i + ct].sum(0) for i in range(0, T, ct)), dbias)


def _wmsa_inputs(dtype, C, heads, shift, seed):
    """B 2, a (16, 16, C) map, window 4 (16 tokens), rolled by the caller."""
    rng = np.random.default_rng(seed)
    B, H, ws = 2, 16, 4
    n = lambda *s, sd=1.0: torch.from_numpy((rng.standard_normal(s) * sd).astype(np.float32))
    w = lambda i, o: n(i, o, sd=i ** -0.5).to(dtype)
    p = [1 + n(C, sd=0.1), n(C, sd=0.1), w(C, 3 * C), n(3 * C, sd=0.1), w(C, C),
         n(heads, ws * ws, ws * ws)]
    mask = torch.from_numpy(shift_attn_mask(H, H, ws, shift)) if shift else None
    args = (n(B, H, H, C).to(dtype), n(B, H, H, C).to(dtype), *p, mask)
    return args, dict(ws=ws, num_heads=heads, scale=8.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,heads,shift", [(96, 1, 0), (160, 8, 2)])
def test_ln_wmsa_bwd_emulation_matches_the_plain_version(dtype, C, heads, shift):
    """Head dim 96 (above the block backward's 64; one 128-column rank, one
    weight-gradient chunk per 256 tokens) and head dim 20 (padded to 32; two
    ranks) with the SW mask."""
    args, kw = _wmsa_inputs(dtype, C, heads, shift, 300 + C + shift)
    x, dout, g, b, wqkv, bqkv, wproj, bias, mask = args
    got = _emulate_wmsa(*args, **kw)
    want = wa.ln_window_attention_bwd_reference(x, dout, g, b, wqkv, bqkv, wproj, bias, mask,
                                                **kw)
    names = ("dx", "dln_g", "dln_b", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias")
    for name, gt, r in zip(names, got, want):
        assert gt.shape == r.shape, name
        if dtype == torch.float32:
            err = float((gt.float() - r.float()).abs().max())
            assert err <= 1e-4 * max(1.0, float(r.abs().max())), (name, err)
        elif name == "dx":
            dd = (gt.float() - r.float()).abs()
            assert float(dd.max()) <= 1e-1 * max(1.0, float(r.float().abs().max()))
            assert float(dd.mean()) <= 2e-3 * max(1.0, float(r.float().abs().mean()))
        else:
            rel = float((gt - r).abs().mean()) / max(float(r.abs().mean()), 1e-30)
            assert rel <= 1e-2, (name, rel)
