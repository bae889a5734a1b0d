"""The inference kernels as ``torch.library`` ops, ``sunet::<wrapper>``.

The counterpart of Pallas lowering to ``stablehlo.custom_call``: each op is
opaque to PyTorch's tracer, so ``torch.export`` records one node per call
instead of reading a ``ctypes`` pointer of a fake tensor, and a reloaded
program calls the same hand-written kernels. The six ops are the inference
wrappers of ``models/sunet.py`` ``INFER_WRAPPERS``:

- ``fused_swin_block`` (:func:`.window_attention.fused_swin_block`, #1)
- ``fused_swin_block_chain`` (#2; its K 12-tuples of block operands flat in
  one ``Tensor[]``, 12 per block, the shifts an ``int[]``)
- ``fused_ln_window_attention`` (#3)
- ``fused_ln_mlp`` (#4)
- ``fused_dual_upsample4_conv_phase`` (:mod:`.upsample`, #5)
- ``fused_dual_upsample4`` (#10)

Each op's real implementation is its wrapper's body: on a CUDA tensor the
kernel (or an error), on a CPU tensor the plain version, the launch counts
(``_build.counter``) taken there, so a reloaded program counts its
launches. Its fake implementation gives the output's shape and dtype. No op
mutates or aliases its inputs.

The wrappers call an op only inside a trace (``torch.export`` or
``torch.compile``: ``torch.compiler.is_compiling()``); outside, they call
the same implementation directly, which saves the dispatcher's per-call
cost on the live model and keeps a tensor on neither device (``meta``)
going to the wrappers' own checks, which refuse it. Importing
``sunet_tf_tpu_torch.kernels`` registers the ops; loading an exported
program needs nothing more.
"""

from __future__ import annotations

import torch

from sunet_tf_tpu_torch.kernels import upsample as up
from sunet_tf_tpu_torch.kernels import window_attention as wa

NAMESPACE = "sunet"
# Block operands per block in the chain op's flat list: ln1 g/b, wqkv, bqkv,
# wproj, bproj, ln2 g/b, w1, b1, w2, b2.
BLOCK_OPERANDS = 12

_LIB = torch.library.Library(NAMESPACE, "DEF")

_BLOCK_ARGS = ("Tensor x, Tensor ln1_s, Tensor ln1_b, Tensor wqkv, Tensor? bqkv, "
               "Tensor wproj, Tensor bproj, Tensor ln2_s, Tensor ln2_b, Tensor w1, "
               "Tensor b1, Tensor w2, Tensor b2, Tensor bias, Tensor? mask")
_HEAD_ARGS = ("Tensor x, Tensor w_exp, Tensor alpha_p, Tensor w_b1, Tensor b_b1, "
              "Tensor alpha_b, Tensor wpf, Tensor wbf")
SCHEMAS = {
    "fused_swin_block": f"({_BLOCK_ARGS}, Tensor? drop_path_scale, *, int ws, "
                        "int num_heads, float scale, int shift) -> Tensor",
    "fused_swin_block_chain": "(Tensor x, Tensor[] params, Tensor[] biases, Tensor? mask, *, "
                              "int ws, int num_heads, float scale, int[] shifts) -> Tensor",
    "fused_ln_window_attention": "(Tensor x, Tensor ln_scale, Tensor ln_bias, Tensor wqkv, "
                                 "Tensor? bqkv, Tensor wproj, Tensor bproj, Tensor bias, "
                                 "Tensor? mask, *, int ws, int num_heads, float scale) -> Tensor",
    "fused_ln_mlp": "(Tensor y, Tensor ln_scale, Tensor ln_bias, Tensor w1, Tensor b1, "
                    "Tensor w2, Tensor b2) -> Tensor",
    "fused_dual_upsample4_conv_phase": f"({_HEAD_ARGS}, Tensor wconv) -> Tensor",
    "fused_dual_upsample4": f"({_HEAD_ARGS}) -> Tensor",
}


def _block(x, ln1_s, ln1_b, wqkv, bqkv, wproj, bproj, ln2_s, ln2_b, w1, b1, w2, b2, bias,
           mask, drop_path_scale, *, ws, num_heads, scale, shift):
    return wa._counted_block("fused_swin_block", x, (ln1_s, ln1_b), wqkv, bqkv, wproj, bproj,
                             (ln2_s, ln2_b), w1, b1, w2, b2, bias, mask, drop_path_scale,
                             ws=ws, num_heads=num_heads, scale=scale, shift=shift)


def _chain(x, params, biases, mask, *, ws, num_heads, scale, shifts):
    K = BLOCK_OPERANDS
    return wa._chain_impl(x, [params[i:i + K] for i in range(0, len(params), K)],
                          list(biases), mask, ws=ws, num_heads=num_heads, scale=scale,
                          shifts=tuple(shifts))


def _ln_wmsa(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, bias, mask, *, ws, num_heads,
             scale):
    return wa._ln_window_attention_impl(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, bias,
                                        mask, ws=ws, num_heads=num_heads, scale=scale)


def _ln_mlp(y, ln_scale, ln_bias, w1, b1, w2, b2):
    return wa._ln_mlp_impl(y, (ln_scale, ln_bias), w1, b1, w2, b2)


IMPLS = {
    "fused_swin_block": _block,
    "fused_swin_block_chain": _chain,
    "fused_ln_window_attention": _ln_wmsa,
    "fused_ln_mlp": _ln_mlp,
    "fused_dual_upsample4_conv_phase": up._conv_phase_impl,
    "fused_dual_upsample4": up._split_head_impl,
}


def _same_as_input(x, *args, **kwargs):
    return x.new_empty(x.shape)


def _conv_phase_fake(x, w_exp, alpha_p, w_b1, b_b1, alpha_b, wpf, wbf, wconv):
    B, H, W, _ = x.shape
    return x.new_empty((B, H, W, 16 * wconv.shape[-1]))


def _split_head_fake(x, *weights):
    B, H, W, C = x.shape
    return x.new_empty((B, 4 * H, 4 * W, C))


FAKES = {
    "fused_swin_block": _same_as_input,
    "fused_swin_block_chain": _same_as_input,
    "fused_ln_window_attention": _same_as_input,
    "fused_ln_mlp": _same_as_input,
    "fused_dual_upsample4_conv_phase": _conv_phase_fake,
    "fused_dual_upsample4": _split_head_fake,
}

for _name, _schema in SCHEMAS.items():
    _LIB.define(_name + _schema)
    for _key in ("CPU", "CUDA"):
        _LIB.impl(_name, IMPLS[_name], _key)
    torch.library.register_fake(f"{NAMESPACE}::{_name}", FAKES[_name], lib=_LIB)


def op(name: str):
    """The registered op ``sunet::name`` (its default overload)."""
    return getattr(getattr(torch.ops, NAMESPACE), name).default
