"""Ahead-of-time serving artifacts on ``torch.export`` (counterpart of
``sunet_tf_tpu/infer/export.py``).

The forward is traced once per static shape into an ``ExportedProgram`` and
written with ``torch.export.save`` as a ``.pt2`` file that a serving
process loads without the model code: it imports
``sunet_tf_tpu_torch.kernels`` (which registers the ``sunet::`` ops of
``kernels/ops.py``, the hand-written kernels the program calls) and no
module of ``sunet_tf_tpu_torch.models``.

Design, as the JAX package's:

- Weights stay outside the artifact. The program takes the model's
  parameters as a flat list of call arguments, in ``named_parameters()``
  order (``meta.json`` records their names and count), and runs the model
  through ``torch.func.functional_call``. Its casts to the compute dtype
  are nodes of the program, so one artifact serves every checkpoint of the
  architecture. Masks and index tensors, which the architecture fixes, are
  its constants.
- Batch sizes are static buckets: the kernels' launch plans follow from
  concrete shapes. ``ServingModel`` sends a request to the smallest bucket
  that fits, zero-pads the tail and crops it back; larger requests run in
  chunks of the biggest bucket.
- The tiled program (``export_tiled``): one artifact per canvas shape
  holds the tile gather, the batched forward and the fold
  (``infer.tiled._tiled_core``); ``TiledServingModel`` places an image on
  its canvas and crops back.
- The artifact records the device it was traced for (``cuda`` or
  ``cpu``); loading it for another device raises. It records the model's
  compute dtype too: a float32 program runs with TF32 off (``exact_fp32``),
  as the live float32 model's forward does. An artifact is read by
  the torch version that wrote it; no other is promised.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections.abc import Mapping
from typing import Optional, Sequence

import torch
import torch.nn as nn

from sunet_tf_tpu_torch.infer.tiled import _tiled_core, canvas_shape
from sunet_tf_tpu_torch.kernels import ops  # noqa: F401  (the sunet:: ops a program calls)
from sunet_tf_tpu_torch.kernels.window_attention import exact_fp32

META_NAME = "meta.json"
TILED_META_NAME = "tiled_meta.json"
FORMAT = "torch.export.save"
# the reference checkpoint's key prefix (``weights.PREFIX``)
_CKPT_PREFIX = "swin_unet."


def forward_file(batch: int) -> str:
    return f"forward_b{batch}.pt2"


def tiled_file(Xh: int, Xw: int) -> str:
    return f"tiled_{Xh}x{Xw}.pt2"


class _Program(nn.Module):
    """(param leaves, x) -> ``body(run, x)``, where ``run(t)`` is the model's
    forward with the leaves as its parameters. The model is held outside
    the module tree, so its parameters are not state of the program."""

    def __init__(self, model: nn.Module, body):
        super().__init__()
        object.__setattr__(self, "_model", model)
        self._names = [n for n, _ in model.named_parameters()]
        self._body = body

    def forward(self, leaves: list, x: torch.Tensor) -> torch.Tensor:
        params = dict(zip(self._names, leaves))
        run = lambda t: torch.func.functional_call(self._model, params, (t,))
        return self._body(run, x)


def _leaves_of(model: nn.Module) -> list:
    return [p.detach() for _, p in model.named_parameters()]


def _export(model: nn.Module, body, x: torch.Tensor) -> torch.export.ExportedProgram:
    """Trace ``body`` after one live run of it, which caches the masks and
    index tensors of these shapes on the device (``ops/constants.py``): the
    program holds each once as a constant there instead of rebuilding it
    from the host on every call."""
    with torch.no_grad():
        body(model, x)
        ep = torch.export.export(_Program(model, body), (_leaves_of(model), x), strict=False)
    _drop_noops(ep.graph_module)
    return ep


def _same_tensor(a, b) -> bool:
    return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) and a.dtype == b.dtype
            and a.shape == b.shape and a.stride() == b.stride() and a.device == b.device)


def _drop_noops(gm: torch.fx.GraphModule) -> int:
    """Remove the nodes of a traced inference graph that change no value:
    metadata checks, detaches, and casts or copies to the dtype and layout
    the tensor already has. The trace records them (the weights' casts of a
    float32 model, ``.detach()`` and ``.contiguous()`` of the live code);
    a run of the program would pay each one's dispatch. Returns how many
    went."""
    aten = torch.ops.aten
    g = gm.graph
    dropped = 0
    for n in list(g.nodes):
        if n.op != "call_function":
            continue
        if n.target == aten._assert_tensor_metadata.default and not n.users:
            g.erase_node(n)
            dropped += 1
            continue
        src = n.args[0] if n.args else None
        # the signature names the outputs: a node the output reads stays
        if not isinstance(src, torch.fx.Node) or any(u.op == "output" for u in n.users):
            continue
        alias = n.target == aten.detach.default or (
            n.target in (aten.to.dtype, aten.contiguous.default)
            and not n.kwargs.get("copy", False) and not any(a is True for a in n.args[1:])
            and _same_tensor(n.meta.get("val"), src.meta.get("val")))
        if alias:
            n.replace_all_uses_with(src)
            g.erase_node(n)
            dropped += 1
    gm.recompile()
    return dropped


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def export_forward(model: nn.Module, batch: int, resolution: int,
                   in_chans: Optional[int] = None) -> torch.export.ExportedProgram:
    """Export one (batch, resolution, resolution, in_chans) float32 forward
    of ``model`` on its parameters' device."""
    c = in_chans or model.cfg.in_chans
    x = torch.zeros((batch, resolution, resolution, c), device=_device_of(model))
    return _export(model, lambda run, t: run(t), x)


def _base_meta(model: nn.Module, in_chans: int) -> dict:
    named = list(model.named_parameters())
    dtype = str(getattr(model, "dtype", torch.bfloat16)).removeprefix("torch.")
    return {"format": FORMAT, "torch": torch.__version__, "device": _device_of(model).type,
            "compute_dtype": dtype,
            "in_chans": int(in_chans), "out_chans": int(model.cfg.out_chans),
            "num_param_leaves": len(named), "param_names": [n for n, _ in named],
            "param_shapes": [list(p.shape) for _, p in named], "bytes": {},
            "export_seconds": {}, "graph_nodes": {}}


def _record(meta: dict, key: str, ep, path: str, t0: float):
    """Write ``ep`` to ``path`` and note its size, nodes and export time."""
    meta["bytes"][key] = _save(ep, path)
    meta["graph_nodes"][key] = len(ep.graph.nodes)
    meta["export_seconds"][key] = time.perf_counter() - t0


def _save(ep, path: str) -> int:
    """Write ``ep`` without its example inputs (they hold the weights it
    was traced with); returns the file's size in bytes."""
    ep.example_inputs = None
    torch.export.save(ep, path)
    return os.path.getsize(path)


def save_exported(out_dir: str, model: nn.Module, resolution: int,
                  batches: Sequence[int] = (1,), in_chans: Optional[int] = None,
                  extra_meta: Optional[dict] = None) -> dict:
    """Write ``forward_b{N}.pt2`` per batch bucket and ``meta.json``;
    returns the meta dict. No weight is written: the artifact is
    weights-agnostic (checkpoints are ``ckpt.py``'s)."""
    os.makedirs(out_dir, exist_ok=True)
    c = in_chans or model.cfg.in_chans
    meta = {**_base_meta(model, c), "resolution": int(resolution),
            "batches": sorted(int(b) for b in batches), **(extra_meta or {})}
    for b in meta["batches"]:
        t0 = time.perf_counter()
        _record(meta, str(b), export_forward(model, b, resolution, c),
                os.path.join(out_dir, forward_file(b)), t0)
    with open(os.path.join(out_dir, META_NAME), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def export_tiled(model: nn.Module, Xh: int, Xw: int, *, canvas_batch: int = 1,
                 kernel: int = 256, stride: int = 128, tile_batch: int = 64,
                 in_chans: Optional[int] = None) -> torch.export.ExportedProgram:
    """Export the whole tiled program of one canvas shape: (param leaves,
    canvases (b, Xh, Xw, C)) -> folded (b, Xh, Xw, C_out) float32, the
    tile gather, batched forward and fold of ``infer.tiled`` in one
    program."""
    c = in_chans or model.cfg.in_chans
    canvases = torch.zeros((canvas_batch, Xh, Xw, c), device=_device_of(model))
    return _export(model, lambda run, t: _tiled_core(run, t, kernel, stride, tile_batch),
                   canvases)


def save_exported_tiled(out_dir: str, model: nn.Module, buckets, *, kernel: int = 256,
                        stride: int = 128, tile_batch: int = 64, canvas_batch: int = 1,
                        in_chans: Optional[int] = None) -> dict:
    """Write ``tiled_{Xh}x{Xw}.pt2`` per canvas bucket and
    ``tiled_meta.json``. buckets: (Xh, Xw) canvas shapes, multiples of
    ``kernel`` (``TiledRunner.bucket(H, W)`` of the corpus' sizes)."""
    os.makedirs(out_dir, exist_ok=True)
    c = in_chans or model.cfg.in_chans
    meta = {**_base_meta(model, c), "kernel": int(kernel), "stride": int(stride),
            "tile_batch": int(tile_batch), "canvas_batch": int(canvas_batch),
            "buckets": sorted([int(a), int(b)] for a, b in buckets)}
    for Xh, Xw in meta["buckets"]:
        t0 = time.perf_counter()
        ep = export_tiled(model, Xh, Xw, canvas_batch=canvas_batch, kernel=kernel,
                          stride=stride, tile_batch=tile_batch, in_chans=c)
        _record(meta, f"{Xh}x{Xw}", ep, os.path.join(out_dir, tiled_file(Xh, Xw)), t0)
    with open(os.path.join(out_dir, TILED_META_NAME), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def _load(path: str) -> torch.fx.GraphModule:
    """The program of a ``.pt2`` as a callable module. Its inputs are checked
    by the caller (``_Artifact.leaves``, the bucket's shape), not again per
    input by the module's own hook."""
    program = torch.export.load(path).module()
    program.validate_inputs = False
    return program


class _Artifact:
    """An artifact directory's meta and its loaded programs, for ``device``
    (the card unless the caller asks for the CPU)."""

    def __init__(self, artifact_dir: str, meta_name: str, inputs, device):
        """inputs(meta) -> {key: (file name, the shape of its traced input)}."""
        with open(os.path.join(artifact_dir, meta_name)) as f:
            self.meta = json.load(f)
        self.device = torch.device(device)
        if self.meta["device"] != self.device.type:
            raise ValueError(f"{artifact_dir}: the artifact was exported for "
                             f"{self.meta['device']!r}; it does not load for "
                             f"{self.device.type!r}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; a 'cuda' artifact runs on the card")
        self._inputs = {key: tuple(shape) for key, (_, shape) in inputs(self.meta).items()}
        self._programs = {key: _load(os.path.join(artifact_dir, name))
                          for key, (name, _) in inputs(self.meta).items()}
        # every parameter of the model is stored in float32
        self._leaf_types = [(torch.Size(s), torch.float32) for s in self.meta["param_shapes"]]

    def run(self, key, leaves: list, x: torch.Tensor) -> torch.Tensor:
        """Program ``key`` on ``x``, which must have the shape it was traced
        with, float32 on the artifact's device."""
        if (tuple(x.shape) != self._inputs[key] or x.dtype != torch.float32
                or x.device.type != self.device.type):
            raise ValueError(f"program {key} takes a float32 {self._inputs[key]} tensor on "
                             f"{self.device.type!r}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
        exact = (exact_fp32() if self.meta.get("compute_dtype", "bfloat16") != "bfloat16"
                 else contextlib.nullcontext())
        with torch.inference_mode(), exact:
            return self._programs[key](leaves, x)

    def leaves(self, params) -> list:
        """The parameter leaves in the exported order, from a list of
        tensors, a ``named_parameters``-keyed mapping (a ``state_dict``; the
        reference checkpoint's ``swin_unet.`` prefix is taken off), or a
        module."""
        n = self.meta["num_param_leaves"]
        if isinstance(params, nn.Module):
            params = list(params.parameters())
        elif isinstance(params, Mapping):
            if "state_dict" in params:
                params = params["state_dict"]
            named = {k.removeprefix(_CKPT_PREFIX): v for k, v in params.items()}
            missing = [k for k in self.meta["param_names"] if k not in named]
            if missing:
                raise ValueError(f"checkpoint lacks {len(missing)} of the artifact's {n} "
                                 f"parameter leaves, e.g. {missing[0]!r}")
            params = [named[k] for k in self.meta["param_names"]]
        leaves = list(params)
        if len(leaves) != n:
            raise ValueError(f"checkpoint has {len(leaves)} leaves, artifact expects {n}")
        types = [(p.shape, p.dtype) for p in leaves]
        if types != self._leaf_types:
            bad = next(i for i, (t, want) in enumerate(zip(types, self._leaf_types)) if t != want)
            raise ValueError(f"leaf {bad} ({self.meta['param_names'][bad]}) is a "
                             f"{types[bad][1]} tensor of shape {tuple(types[bad][0])}; the "
                             f"artifact expects float32 {tuple(self._leaf_types[bad][0])}")
        if leaves[0].device.type != self.device.type:
            raise ValueError(f"the parameter leaves are on {leaves[0].device}; the artifact "
                             f"runs on {self.device.type!r}")
        return leaves


class ServingModel:
    """Serve batched forwards from a ``save_exported`` directory.

    A request goes to the smallest batch bucket that fits (zero-padded,
    cropped back); larger requests run in chunks of the biggest bucket.
    Outputs equal the live fused model's bit for bit (the program replays
    the same operations and kernels)."""

    def __init__(self, artifact_dir: str, device="cuda"):
        self._a = _Artifact(artifact_dir, META_NAME, lambda m: {
            b: (forward_file(b), (b, m["resolution"], m["resolution"], m["in_chans"]))
            for b in m["batches"]}, device)
        self.meta = self._a.meta
        self.resolution = self.meta["resolution"]
        self.batches = self.meta["batches"]

    def _run_bucket(self, b: int, leaves: list, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        if n < b:
            x = torch.cat([x, x.new_zeros((b - n,) + tuple(x.shape[1:]))])
        return self._a.run(b, leaves, x)[:n]

    def __call__(self, params, x: torch.Tensor) -> torch.Tensor:
        """params: the parameter leaves (see ``_Artifact.leaves``); x: (n,
        resolution, resolution, in_chans) float32 on the artifact's device.
        Returns (n, resolution, resolution, out_chans) float32."""
        leaves = self._a.leaves(params)
        r = self.resolution
        if x.dim() != 4 or tuple(x.shape[1:3]) != (r, r):
            raise ValueError(f"exported for {r}x{r}, got {tuple(x.shape)}: use the tiled "
                             "artifact for other sizes")
        n = x.shape[0]
        for b in self.batches:
            if n <= b:
                return self._run_bucket(b, leaves, x)
        big = self.batches[-1]
        return torch.cat([self._run_bucket(big, leaves, x[i:i + big])
                          for i in range(0, n, big)])


class TiledServingModel:
    """Serve images of any size from ``save_exported_tiled`` artifacts:
    place each image on its canvas bucket, run the exported gather +
    forward + fold, crop back. Equal bit for bit to the live
    ``TiledRunner`` for images whose bucket was exported."""

    def __init__(self, artifact_dir: str, device="cuda"):
        self._a = _Artifact(artifact_dir, TILED_META_NAME, lambda m: {
            tuple(b): (tiled_file(*b), (m["canvas_batch"], *b, m["in_chans"]))
            for b in m["buckets"]}, device)
        self.meta = self._a.meta

    def __call__(self, params, img: torch.Tensor) -> torch.Tensor:
        """img: (1, H, W, C) or (H, W, C) float32 in [0, 1] on the
        artifact's device. Returns (1, H, W, C_out) float32."""
        x = img[None] if img.dim() == 3 else img
        if x.shape[0] != 1:
            raise ValueError("pass individual images")
        H, W = x.shape[1], x.shape[2]
        Xh, Xw, top, left = canvas_shape(H, W, self.meta["kernel"], square_pad=False)
        if [Xh, Xw] not in self.meta["buckets"]:
            raise ValueError(f"no exported bucket {Xh}x{Xw} for a {H}x{W} image; exported: "
                             f"{self.meta['buckets']}")
        canvases = x.new_zeros((self.meta["canvas_batch"], Xh, Xw, x.shape[3]))
        canvases[0, top:top + H, left:left + W] = x[0]
        folded = self._a.run((Xh, Xw), self._a.leaves(params), canvases)
        return folded[0:1, top:top + H, left:left + W]
