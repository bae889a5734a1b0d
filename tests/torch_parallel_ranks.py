"""The rank side of ``test_torch_port_parallel.py`` and
``test_torch_port_spatial.py``: module-level functions that
``parallel.launch.run_ranks`` starts in spawned processes (two gloo ranks on
the CPU). Each runs every check of its file once and returns numpy results;
the test files hold them against the JAX package and against the port's
one-process paths. Imports nothing of JAX, so that a rank starts fast."""

from __future__ import annotations

import numpy as np
import torch

from sunet_tf_tpu_torch import config as tconfig


def cfg_of(raw: dict) -> tconfig.Config:
    return tconfig.config_from_dict(raw)


def build(raw: dict, state, device="cpu"):
    """The port's model of ``raw`` with the reference-keyed ``state`` (None:
    the seeded weights), in training mode."""
    from sunet_tf_tpu_torch.models.sunet import build_model
    from sunet_tf_tpu_torch.weights import load_reference_state_dict

    model = build_model(cfg_of(raw), device=device, backend="fused", seed=0)
    if state is not None:
        load_reference_state_dict(model, state)
    return model.train().requires_grad_(True)


def params_np(model) -> dict:
    return {n: p.detach().cpu().numpy().copy() for n, p in model.named_parameters()}


def sgd_step(raw: dict, state: dict, batch: dict, task: str, augment: bool, mesh=None,
             runner=None, step: int = 0) -> dict:
    """One ``build_steps`` training step with SGD at rate 1 (the update is
    minus the gradient): the parameters before and after it, the logged
    scalars and the histograms."""
    from sunet_tf_tpu_torch.ops.metrics import init_histograms
    from sunet_tf_tpu_torch.train.loop import build_steps, to_device

    model = build(raw, state)
    before = params_np(model)
    opt = torch.optim.SGD(model.parameters(), lr=1.0)
    fns = build_steps(model, opt, task=task, sigma=25.0, seed=7, augment=augment, mesh=mesh,
                      stage_runner=runner)
    hists = init_histograms(64) if task == "mask" else {}
    scalars, hists = fns.train_step(to_device(batch, "cpu"), step, hists)
    return {"before": before, "params": params_np(model),
            "scalars": {k: float(v) for k, v in scalars.items()},
            "hists": {k: v.numpy() for k, v in hists.items()}}


def eval_sums(raw: dict, state: dict, batch: dict, task: str, mesh=None, runner=None) -> dict:
    from sunet_tf_tpu_torch.ops.metrics import init_histograms
    from sunet_tf_tpu_torch.train.loop import build_steps, to_device

    model = build(raw, state).eval()
    fns = build_steps(model, torch.optim.SGD(model.parameters(), lr=1.0), task=task,
                      mesh=mesh, stage_runner=runner)
    hists = init_histograms(64) if task == "mask" else {}
    sums, hists = fns.eval_step(to_device(batch, "cpu"), hists)
    return {"sums": {k: float(v) for k, v in sums.items()},
            "hists": {k: v.numpy() for k, v in hists.items()}}


def tiled_out(raw: dict, state: dict, img: np.ndarray, mesh=None, **kw) -> np.ndarray:
    from sunet_tf_tpu_torch.infer.tiled import tiled_inference

    model = build(raw, state).eval().requires_grad_(False)
    with torch.inference_mode():
        return tiled_inference(model, torch.from_numpy(img), mesh=mesh, **kw).numpy()


def corpus_out(raw: dict, state: dict, images: list, mesh=None, **kw) -> list:
    from sunet_tf_tpu_torch.infer.tiled import TiledRunner

    model = build(raw, state).eval().requires_grad_(False)
    with torch.inference_mode():
        return [t.numpy() for t in TiledRunner(model, mesh=mesh, **kw).run_corpus(images)]


def fit(argv: list) -> dict:
    """``python -m sunet_tf_tpu_torch.train`` in this process (its logger
    without the optional plots and TensorBoard, which take seconds): the fit
    summary and the parameters after it."""
    from sunet_tf_tpu_torch.obs import MetricsLogger
    from sunet_tf_tpu_torch.train import __main__ as cli
    from sunet_tf_tpu_torch.train import trainer as trainer_mod

    made = []
    real = trainer_mod.Trainer

    class Keep(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    trainer_mod.Trainer, cli.Trainer = Keep, Keep
    trainer_mod.MetricsLogger = lambda d: MetricsLogger(d, enable_tb=False, enable_plots=False)
    try:
        summary = cli.main(argv)
    finally:
        trainer_mod.Trainer, cli.Trainer = real, real
        trainer_mod.MetricsLogger = MetricsLogger
    t = made[0]
    mesh = t.mesh
    return {"summary": summary, "params": params_np(t.model),
            "mesh": None if mesh is None else (mesh.shape["data"], mesh.shape["spatial"]),
            "runner": t.stage_runner is not None}


def one_process(inp: dict) -> dict:
    """The one-process results ``data_tier_rank``'s are held against."""
    out = {}
    for name, (raw_key, batch_key, task, augment) in inp["steps"].items():
        out[name] = sgd_step(inp[raw_key], inp["state_" + raw_key], inp[batch_key], task,
                             augment)
    for name, (raw_key, batch_key, task) in inp["evals"].items():
        out[name] = eval_sums(inp[raw_key], inp["state_" + raw_key], inp[batch_key], task)
    for case in ("tiled", "tiled_odd"):
        out[case] = tiled_out(inp["tiny"], inp["state_tiny"], inp[case + "_img"],
                              **inp[case + "_kw"])
    out["corpus"] = corpus_out(inp["tiny"], inp["state_tiny"], inp["corpus"], **inp["corpus_kw"])
    out["fit"] = fit(inp["fit_argv_one"])
    return out


def data_tier_rank(rank: int, device, inp: dict) -> dict:
    """Every check of ``test_torch_port_parallel.py`` on this rank."""
    from sunet_tf_tpu_torch.parallel.mesh import make_mesh
    from sunet_tf_tpu_torch.tools.multihost_smoke import check

    torch.set_num_threads(1)
    out = {"multihost": check(rank, device)}
    mesh = make_mesh(data=2)
    out["mesh"] = (mesh.shape, mesh.data_index, mesh.spatial_index, mesh.data_peers(),
                   mesh.spatial_peers())
    for name, (raw_key, batch_key, task, augment) in inp["steps"].items():
        out[name] = sgd_step(inp[raw_key], inp["state_" + raw_key], inp[batch_key], task,
                             augment, mesh)
    for name, (raw_key, batch_key, task) in inp["evals"].items():
        out[name] = eval_sums(inp[raw_key], inp["state_" + raw_key], inp[batch_key], task, mesh)
    for case in ("tiled", "tiled_odd"):
        out[case] = tiled_out(inp["tiny"], inp["state_tiny"], inp[case + "_img"], mesh,
                              **inp[case + "_kw"])
    out["corpus"] = corpus_out(inp["tiny"], inp["state_tiny"], inp["corpus"], mesh,
                               **inp["corpus_kw"])
    out["fit"] = fit(inp["fit_argv"])
    return out


def spatial_rank(rank: int, device, inp: dict) -> dict:
    """Every check of ``test_torch_port_spatial.py`` on this rank."""
    from sunet_tf_tpu_torch.parallel import spatial as sp
    from sunet_tf_tpu_torch.parallel.comm import all_reduce_sum
    from sunet_tf_tpu_torch.parallel.mesh import make_mesh
    from sunet_tf_tpu_torch.train.loop import reduce_gradients

    torch.set_num_threads(1)
    mesh = make_mesh(data=1, spatial=2)
    out = {}
    x = torch.from_numpy(inp["halo_x"])
    L = x.shape[0] // 2
    for halo, mode in inp["halos"]:
        xl = x[rank * L:(rank + 1) * L].clone().requires_grad_(True)
        y = sp.halo_exchange_rows(xl, mesh, halo, mode)
        g = torch.from_numpy(inp["halo_g"][(halo, mode)][rank])
        (y * g).sum().backward()
        out[("halo", halo, mode)] = (y.detach().numpy(), xl.grad.numpy())
    xb = torch.from_numpy(inp["roll_x"])
    L = xb.shape[1] // 2
    for shift in inp["shifts"]:
        xl = xb[:, rank * L:(rank + 1) * L].clone().requires_grad_(True)
        y = sp.spatial_roll_h(xl, shift, mesh)
        (y * torch.from_numpy(inp["roll_g"][shift][rank])).sum().backward()
        out[("roll", shift)] = (y.detach().numpy(), xl.grad.numpy())
    xc = torch.from_numpy(inp["conv_x"])
    L = xc.shape[1] // 2
    xl = xc[:, rank * L:(rank + 1) * L].clone().requires_grad_(True)
    k = torch.from_numpy(inp["conv_k"]).requires_grad_(True)
    b = torch.from_numpy(inp["conv_b"])
    y = sp.spatial_conv3x3(mesh, k, b)(xl)
    (y * torch.from_numpy(inp["conv_g"][rank])).sum().backward()
    out["conv"] = (y.detach().numpy(), xl.grad.numpy(),
                   all_reduce_sum(mesh, mesh.spatial_group, k.grad.clone()).numpy())

    # one stage: the eager spatial stage, and the runner's inference and
    # training forms, the weights' gradients summed over the spatial group
    model = build(inp["tiny"], inp["state_tiny"])
    blocks = list(model.layers[0].blocks)
    xs = torch.from_numpy(inp["stage_x"])
    runner = sp.SpatialStageRunner(mesh)
    with torch.no_grad():
        out["stage_eager"] = sp.run_swin_blocks_spatial(mesh, blocks, xs).numpy()
        out["stage_infer"] = runner(blocks, xs).numpy()
    xg = xs.clone().requires_grad_(True)
    y = runner(blocks, xg, torch.Generator().manual_seed(0))
    (y * torch.from_numpy(inp["stage_g"])).sum().backward()
    names = {id(p): n for n, p in model.named_parameters()}
    partial = list(runner.partial_params.values())
    reduce_gradients([], mesh, partial)
    out["stage_train"] = (y.detach().numpy(), xg.grad.numpy(),
                          {names[id(p)]: p.grad.numpy() for p in partial})

    # the whole shrunk model: forward and one training step at spatial 2
    runner = sp.SpatialStageRunner(mesh)
    model = build(inp["small"], inp["state_small"]).eval()
    with torch.no_grad():
        out["model_fwd"] = model(torch.from_numpy(inp["model_x"]), stage_runner=runner).numpy()
    step_runner = sp.SpatialStageRunner(mesh)
    out["model_step"] = sgd_step(inp["small"], inp["state_small"], inp["model_batch"], "mask",
                                 True, mesh, step_runner)
    out["model_step"]["partial"] = len(step_runner.partial_params)
    out["fit"] = fit(inp["fit_argv"])
    return out
