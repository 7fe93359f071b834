"""Baseline parallelization strategies (paper Section 6, Baselines 1-3):
the port's copy of ``repro.core.strategies``.

* **Data parallelism** — every layer shards only the sample dimension over
  all mesh axes (each chip holds a full replica).
* **Model parallelism** — every layer with parameters shards its widest
  parameter dimension over the non-pod axes; parameter-free layers follow
  with batch on the pod axis only (Krizhevsky-2014-style equal division).
* **OWT ("one weird trick")** — data parallelism for the compute-dense
  layers (attention/MLP/MoE/recurrent: the conv analogue) and model
  parallelism for the parameter-dense embedding/LM-head layers (the
  densely-connected analogue).
"""

from __future__ import annotations

from .config import LayerConfig
from .device import MeshSpec
from .graph import CompGraph, LayerNode, Strategy, uniform_strategy

# Preference order of the "channel-like" dim to shard under model
# parallelism, per layer kind.
_MODEL_DIM = {
    "embed": "vocab",
    "lm_head": "vocab",
    "attn": "heads",
    "cross_attn": "heads",
    "mlp_in": "d_ff",
    "mlp_out": "d_model",
    "moe": "expert",
    "rwkv": "d_model",
    "ssm": "d_model",
    "norm": "d_model",
    "residual": "d_model",
    "stub": "d_model",
}

# Layer kinds OWT treats as "densely-connected" (model parallel).
_OWT_MODEL_KINDS = frozenset({"embed", "lm_head"})


def _non_pod_axes(mesh: MeshSpec) -> tuple[str, ...]:
    return tuple(a.name for a in mesh.axes if a.name != "pod")


def _all_axes(mesh: MeshSpec) -> tuple[str, ...]:
    return tuple(a.name for a in mesh.axes)


def data_parallel(graph: CompGraph, mesh: MeshSpec) -> Strategy:
    axes = _all_axes(mesh)

    def cfg(node: LayerNode) -> LayerConfig:
        if "batch" in node.parallel_dims:
            return LayerConfig.make(batch=axes)
        return LayerConfig.REPLICATED

    s = uniform_strategy(graph, cfg)
    s.meta["name"] = "data"
    return s


def model_parallel(graph: CompGraph, mesh: MeshSpec) -> Strategy:
    non_pod = _non_pod_axes(mesh)
    pod = tuple(a.name for a in mesh.axes if a.name == "pod")

    def cfg(node: LayerNode) -> LayerConfig:
        dim = _MODEL_DIM.get(node.kind)
        mapping: dict[str, tuple[str, ...]] = {}
        if dim is not None and dim in node.parallel_dims:
            mapping[dim] = non_pod
        elif "batch" in node.parallel_dims:
            mapping["batch"] = non_pod
        if pod and "batch" in node.parallel_dims and "batch" not in mapping:
            mapping["batch"] = pod
        return LayerConfig.make(mapping)

    s = uniform_strategy(graph, cfg)
    s.meta["name"] = "model"
    return s


def owt(graph: CompGraph, mesh: MeshSpec) -> Strategy:
    """One-weird-trick: DP for compute layers, MP for densely-connected."""
    axes = _all_axes(mesh)
    non_pod = _non_pod_axes(mesh)
    pod = tuple(a.name for a in mesh.axes if a.name == "pod")

    def cfg(node: LayerNode) -> LayerConfig:
        if node.kind in _OWT_MODEL_KINDS:
            dim = _MODEL_DIM[node.kind]
            mapping = {dim: non_pod}
            if pod and "batch" in node.parallel_dims:
                mapping["batch"] = pod
            return LayerConfig.make(mapping)
        if "batch" in node.parallel_dims:
            return LayerConfig.make(batch=axes)
        return LayerConfig.REPLICATED

    s = uniform_strategy(graph, cfg)
    s.meta["name"] = "owt"
    return s


BASELINES = {
    "data": data_parallel,
    "model": model_parallel,
    "owt": owt,
}
