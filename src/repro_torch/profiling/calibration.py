"""Predicted-vs-measured calibration report (the port's counterpart of
``repro.profiling.calibration``).

The paper validates its simulator by comparing simulated against real
execution times (Section 6.1); this module is that loop for our cost
model.  For every layer node it compares

* **predicted** — ``CostModel.roofline_time(node, cfg)``: the on-chip
  part of ``t_C`` (no collectives — those need a multi-host wall clock);
* **measured** — wall time of a synthetic computation on the card
  matched to the node's *per-device* work: a dense matmul sized to the
  node's FLOPs (at the dtype the port computes in, float32 by default,
  where the reference's is bfloat16) and an elementwise stream sized to
  its HBM bytes, combined as ``max`` exactly like the roofline.

The relative error per layer, and its median (``cost_model_rel_error``,
the number the reference's CI bench gates), quantify how far the cost
model's absolute scale is from this machine.  An analytic (uncalibrated)
model on CPU is off by orders of magnitude; a profiled one should land
within a small factor.
"""

from __future__ import annotations

import torch

from repro_torch.core.config import LayerConfig
from repro_torch.core.cost_model import CostModel
from repro_torch.core.graph import CompGraph

from .microbench import default_device, median_time

_EPS = 1e-12


def _measure_equivalent(flops: float, bytes_: float, *, repeats: int = 3,
                        warmup: int = 1, cache: dict | None = None,
                        device=None, dtype=torch.float32) -> float:
    """Wall seconds of synthetic work matching (flops, bytes) on one
    device: max(matmul time, stream time), the measured mirror of the
    roofline max.  Sizes are bucketed (power-of-two matmul edge / stream
    length) so repeated layers share timings via ``cache``."""
    n = 8
    while 2.0 * n**3 < flops and n < 8192:
        n *= 2
    m = 1024
    target_elems = max(1.0, bytes_ / 8.0)   # read + write per element
    while m < target_elems and m < (1 << 28):
        m *= 2
    key = (n, m)
    if cache is not None and key in cache:
        t_mm, t_st = cache[key]
    else:
        device = torch.device(device) if device else default_device()
        a = torch.ones((n, n), dtype=dtype, device=device)
        t_mm = median_time(torch.matmul, a, a, repeats=repeats,
                           warmup=warmup)
        x = torch.zeros((m,), device=device)
        y = torch.empty_like(x)
        t_st = median_time(lambda: torch.mul(x, 2.0, out=y),
                           repeats=repeats, warmup=warmup)
        if cache is not None:
            cache[key] = (t_mm, t_st)
    # scale the bucketed timing back to the exact requested work
    mm = t_mm * flops / (2.0 * n**3) if flops > 0 else 0.0
    st = t_st * bytes_ / (2.0 * m * 4.0) if bytes_ > 0 else 0.0
    return max(mm, st, _EPS)


def layer_report(graph: CompGraph, cost_model: CostModel, strategy=None, *,
                 repeats: int = 3, warmup: int = 1,
                 min_flops: float = 1.0, device=None,
                 dtype=torch.float32) -> dict:
    """Per-layer predicted-vs-measured table + the median relative error.

    ``strategy`` maps node name -> LayerConfig (a searched plan's
    assignment); ``None`` prices every node replicated (single-device
    work).  Nodes with neither FLOPs nor activation bytes (reshapes,
    residual adds) are skipped.  ``device`` / ``dtype`` are the
    measurement's (the card and float32 by default).  Returns::

        {"layers": [{"name", "kind", "predicted_s", "measured_s",
                     "rel_error"}, ...],
         "median_rel_error": float, "max_rel_error": float,
         "num_layers": int}
    """
    mesh = cost_model.mesh
    cache: dict = {}
    rows = []
    for name, node in graph.nodes.items():
        if node.flops < min_flops and node.act_bytes <= 0:
            continue
        cfg = strategy[name] if strategy is not None else LayerConfig.REPLICATED
        deg = max(1, cfg.degree(mesh))
        pdeg = max(1, cfg.degree(mesh, dims=[d for d in cfg.dims
                                             if d not in ("batch", "seq")]))
        predicted = cost_model.roofline_time(node, cfg)
        measured = _measure_equivalent(
            node.flops / deg,
            node.act_bytes / deg + node.param_bytes / pdeg,
            repeats=repeats, warmup=warmup, cache=cache, device=device,
            dtype=dtype)
        rel = abs(predicted - measured) / max(measured, _EPS)
        rows.append({"name": name, "kind": node.kind,
                     "predicted_s": predicted, "measured_s": measured,
                     "rel_error": rel})
    errs = sorted(r["rel_error"] for r in rows)
    if errs:
        mid = len(errs) // 2
        med = errs[mid] if len(errs) % 2 else 0.5 * (errs[mid - 1] + errs[mid])
    else:
        med = 0.0
    return {"layers": rows, "median_rel_error": med,
            "max_rel_error": errs[-1] if errs else 0.0,
            "num_layers": len(rows)}


def format_layer_report(report: dict, *, limit: int = 24) -> str:
    """Human-readable table of a :func:`layer_report`."""
    lines = [f"{'layer':<28} {'kind':<10} {'predicted':>12} "
             f"{'measured':>12} {'rel_err':>8}"]
    for row in report["layers"][:limit]:
        lines.append(
            f"{row['name']:<28.28} {row['kind']:<10.10} "
            f"{row['predicted_s']:>12.3e} {row['measured_s']:>12.3e} "
            f"{row['rel_error']:>8.2f}")
    extra = len(report["layers"]) - limit
    if extra > 0:
        lines.append(f"... ({extra} more layers)")
    lines.append(
        f"median rel error over {report['num_layers']} layers: "
        f"{report['median_rel_error']:.3f} (max {report['max_rel_error']:.3f})")
    return "\n".join(lines)
