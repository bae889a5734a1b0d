"""The last two entry points of the port against the JAX package: the
standalone W-MSA (kernel #15) and the ALU-rate probe (kernel #16).

- ``fused_window_attention`` (its plain version, on the CPU) against JAX
  ``fused_window_attention`` with its Pallas kernel ``wmsa_core`` in
  interpret mode, at the shapes of ``tests/test_pallas.py`` (maps 16x24
  with C=16, 2 heads and 8x8 with C=32, 4 heads; window 4), shift 0 and 2
  with the SW mask, float32, rtol = atol = 1e-4 (other summation orders).
- The probe's plain chain (``alu_chain_reference``) against the JAX
  probe's own body ``tools/vpu_floor.py::_body``, run through a small
  interpret-mode ``pallas_call`` ((8, 128) float32, T = 16), each op,
  rtol = atol = 1e-5 (float32 transcendentals of two libraries, 16 steps).
- The probe's SASS reader (``alu_floor.sass_step_counts``, the instructions
  per pipe of a chain step that its bound counts) on a listing written
  here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sunet_tf_tpu.kernels.window_attention import fused_window_attention as jax_fwa
from sunet_tf_tpu.ops.window import shift_attn_mask
from sunet_tf_tpu_torch import kernels as tkernels
from sunet_tf_tpu_torch.kernels import _build
from sunet_tf_tpu_torch.kernels import window_attention as twa
from sunet_tf_tpu_torch.tools import alu_floor
from tools import vpu_floor

TOL = dict(rtol=1e-4, atol=1e-4)
ALU_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shift", [0, 2])
@pytest.mark.parametrize("dims", [(16, 24, 16, 2), (8, 8, 32, 4)])
def test_window_attention_plain_matches_jax(shift, dims):
    H, W, C, heads = dims
    ws, N = 4, 16
    rng = np.random.default_rng(90 + shift + C)
    n = lambda *s, sd=1.0: (rng.standard_normal(s) * sd).astype(np.float32)
    x = n(2, H, W, C)
    args = (n(C, 3 * C, sd=C ** -0.5), n(3 * C, sd=0.1), n(C, C, sd=C ** -0.5),
            n(C, sd=0.1), n(heads, N, N))
    mask = shift_attn_mask(H, W, ws, shift) if shift else None
    kw = dict(ws=ws, num_heads=heads, scale=8.0)
    want = jax_fwa(jnp.asarray(x), *map(jnp.asarray, args),
                   None if mask is None else jnp.asarray(mask), **kw)
    c = _build.counter("wmsa_core")
    before = c.cpu
    got = tkernels.fused_window_attention(
        torch.from_numpy(x), *map(torch.from_numpy, args),
        None if mask is None else torch.from_numpy(mask), **kw)
    assert c.cpu == before + twa.WMSA_CORE_LAUNCHES and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # no qkv bias: JAX takes None as zeros
    want = jax_fwa(jnp.asarray(x), jnp.asarray(args[0]), None, *map(jnp.asarray, args[2:]),
                   None if mask is None else jnp.asarray(mask), **kw)
    got = twa.fused_window_attention_reference(
        torch.from_numpy(x), torch.from_numpy(args[0]), None,
        *map(torch.from_numpy, args[2:]), None if mask is None else torch.from_numpy(mask),
        **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("op", alu_floor.OPS)
def test_alu_chain_plain_matches_vpu_floor_body(op):
    steps = 16
    x = np.random.default_rng(5).random((8, 128), np.float32)
    f = pl.pallas_call(
        functools.partial(vpu_floor._body, op),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(1,),
            in_specs=[pl.BlockSpec((8, 128), lambda i, t: (i, 0))],
            out_specs=pl.BlockSpec((8, 128), lambda i, t: (i, 0))),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=True)
    want = f(jnp.array([steps], jnp.int32), jnp.asarray(x))
    c = _build.counter("alu_chain")
    before = c.cpu
    got = alu_floor.alu_chain(torch.from_numpy(x), op, steps)
    assert c.cpu == before + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ALU_TOL)


def test_new_wrappers_raise_off_cpu_and_cuda():
    """A tensor on neither the CPU nor a CUDA device is refused, and the
    probe refuses to measure without a card."""
    xw = torch.empty(2, 16, 32, device="meta")
    w = torch.empty(32, 96, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        twa.wmsa_core(xw, w, w[0], w[:, :32], w[0, :32], torch.empty(4, 16, 16), None,
                      num_heads=4, scale=8.0)
    with pytest.raises(ValueError, match="CUDA"):
        alu_floor.alu_chain(torch.empty(8, 128, device="meta"), "fma", 4)
    with pytest.raises(ValueError, match="op"):
        alu_floor.alu_chain(torch.empty(8, 128), "sin", 4)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            alu_floor.main(["--t", "4"])


SASS = """
\t\tFunction : _ZN5sunet16alu_chain_kernelILi1EEEvPKfPfmi
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   FMUL R0, R11, -1.4426950216293334961 ;
        /*0020*/                   MUFU.EX2 R0, R0 ;
        /*0030*/                   FFMA R11, R0, 0.5, 0.25 ;
        /*0040*/                   FSETP.GE.AND P1, PT, |R11|, 0.60000002384185791016, PT ;
        /*0050*/                   FMUL R0, R11, -1.4426950216293334961 ;
        /*0060*/                   MUFU.EX2 R0, R0 ;
        /*0070*/                   FFMA R11, R0, 0.5, 0.25 ;
        /*0080*/                   IADD3 R9, R9, -0x2, RZ ;
        /*0090*/                   ISETP.GT.AND P2, PT, R9, 0x1, PT ;
        /*00a0*/               @P2 BRA 0x10 ;
        /*00b0*/                   FMUL R0, R11, -1.4426950216293334961 ;
        /*00c0*/                   MUFU.EX2 R0, R0 ;
        /*00d0*/                   FFMA R11, R0, 0.5, 0.25 ;
        /*00e0*/              @!P0 BRA 0xb0 ;
        /*00f0*/                   EXIT ;
"""


def test_alu_sass_step_counts():
    """The probe's bound counts a chain step's instructions per pipe in the
    main unrolled loop (the innermost loop of the most steps), each step
    closed by its op's y * a + b."""
    got = alu_floor.sass_step_counts(SASS)
    assert set(got) == {"exp"}
    c = got["exp"]
    assert (c["steps"], c["fp32"], c["alu"], c["mufu"]) == (2, 2.0, 1.5, 1.0)
