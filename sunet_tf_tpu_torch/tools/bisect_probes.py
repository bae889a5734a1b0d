"""Phase (b) of the float64 bisection: the probe comparison (the
counterpart of the JAX repo's ``tools/bisect_probes.py``).

Runs each route of the port and the float64 oracle on the same images with
the forward's probe points recorded (``SUNet.taps``, in pipeline order
``models.sunet.probe_names``: the stem, each encoder stage, the bottleneck
norm, layers_up[0], each decoder stage's concat Linear and the stage,
norm_up, the output) and reports each route's relative L2 distance to the
oracle at every probe, and the first probe where the fused route sits
more than ``FACTOR`` times farther from the oracle than eager bf16: the
first point whose divergence the kernels add. The oracle's own probes are
checked for float64, and held against the oracle run on the CPU (where
the card's float64 must agree to ~1e-16 per operation: a product demoted
to float32 anywhere in the oracle shows as ~1e-7 there).
"""

from __future__ import annotations

from typing import Optional

import torch

FACTOR = 2.0


def probes(model, x: torch.Tensor) -> dict:
    """The probe points of ``model``'s forward on ``x`` (name -> tensor, in
    pipeline order); float32 products in float32 (no TF32)."""
    from sunet_tf_tpu_torch.kernels.window_attention import exact_fp32

    model.taps = {}
    try:
        with torch.no_grad(), exact_fp32():
            model(x)
        return model.taps
    finally:
        model.taps = None


def rl2(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| in float64 (on ``b``'s device)."""
    a, b = a.to(b.device, torch.float64), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def probe_distances(route: dict, oracle: dict) -> dict:
    """Relative L2 distance of each probe of ``route`` to ``oracle``'s."""
    return {name: rl2(route[name], oracle[name]) for name in oracle}


def first_divergence(route: dict, reference: dict, factor: float = FACTOR,
                     floor: float = 0.0) -> Optional[str]:
    """The first probe (in ``route``'s order) whose distance exceeds both
    ``factor`` times ``reference``'s at that probe and ``floor``; None
    where none does."""
    for name, d in route.items():
        if d > factor * reference[name] and d > floor:
            return name
    return None


def probe_report(model, x: torch.Tensor, cpu_check: bool = True) -> dict:
    """Each route's probe distances to the oracle on the images ``x`` (on
    ``model``'s device), the first divergent probe of the fused route
    against eager bf16, the oracle's probe dtypes and, with ``cpu_check``,
    each oracle probe's distance to the oracle run on the CPU on the first
    image."""
    from sunet_tf_tpu_torch.models.sunet import route_copy
    from sunet_tf_tpu_torch.tools.fp64_oracle import oracle_model
    from sunet_tf_tpu_torch.tools.parity_run import ROUTES

    oracle = oracle_model(model)
    ref = probes(oracle, x)
    dists = {name: probe_distances(probes(route_copy(model, dtype=dt, backend=be), x), ref)
             for name, be, dt in ROUTES}
    report = {"probes": list(ref), "oracle_dtypes": {k: str(v.dtype) for k, v in ref.items()},
              "rl2": dists,
              "first_divergent": first_divergence(dists["fused_bfloat16"],
                                                  dists["eager_bfloat16"])}
    if cpu_check:
        on_cpu = probes(oracle.to("cpu"), x[:1].cpu())
        report["oracle_cpu_rl2"] = {k: rl2(ref[k][:1], v) for k, v in on_cpu.items()}
    return report


def print_report(report: dict) -> None:
    names = [name for name in report["rl2"]]
    print(f"{'probe':10s} " + " ".join(f"{n:>15s}" for n in names)
          + (" oracle on the CPU" if "oracle_cpu_rl2" in report else ""))
    for p in report["probes"]:
        print(f"{p:10s} " + " ".join(f"{report['rl2'][n][p]:15.3e}" for n in names)
              + (f" {report['oracle_cpu_rl2'][p]:15.3e}" if "oracle_cpu_rl2" in report else ""))
    print(f"first probe where fused bf16 is more than {FACTOR:g}x farther from the oracle "
          f"than eager bf16: {report['first_divergent']}")
