"""Computation-graph IR (paper Section 4): the port's copy of
``repro.core.graph``.

Nodes are layers; edges are tensors produced by one layer and consumed by
another.  Parallel edges (same src/dst) are allowed — they are what edge
elimination (paper Fig. 5b) consumes.  The graph is a DAG.

Each node declares:
  * ``out``            — the output :class:`TensorSpec` (named dims + sizes);
  * ``flops``          — total fwd+bwd FLOPs for the *global* batch;
  * ``param_bytes``    — parameter bytes (0 for residual adds etc.);
  * ``act_bytes``      — HBM activation traffic (inputs+outputs, global);
  * ``parallel_dims``  — the paper's Table-1 entry: which logical dims a
                         configuration may shard for this layer;
  * ``extra``          — kind-specific cost-model metadata (e.g. global KV
                         bytes for attention, expert count for MoE).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field, replace
from typing import Iterable, Iterator

from .config import LayerConfig


@dataclass(frozen=True)
class TensorSpec:
    """A named-dimension tensor: (("batch", 256), ("seq", 4096), ...)."""

    dims: tuple[tuple[str, int], ...]
    dtype_bytes: int = 2  # bf16 activations by default

    @staticmethod
    def make(dtype_bytes: int = 2, **dims: int) -> "TensorSpec":
        return TensorSpec(tuple(dims.items()), dtype_bytes)

    @property
    def dim_names(self) -> tuple[str, ...]:
        return tuple(d for d, _ in self.dims)

    def size(self, dim: str) -> int:
        for d, s in self.dims:
            if d == dim:
                return s
        raise KeyError(dim)

    @property
    def num_elements(self) -> int:
        return math.prod(s for _, s in self.dims)

    @property
    def bytes(self) -> int:
        return self.num_elements * self.dtype_bytes

    def __repr__(self) -> str:
        inner = ",".join(f"{d}={s}" for d, s in self.dims)
        return f"T({inner})x{self.dtype_bytes}B"


@dataclass
class LayerNode:
    name: str
    kind: str
    out: TensorSpec
    flops: float = 0.0
    param_bytes: float = 0.0
    act_bytes: float = 0.0
    parallel_dims: tuple[str, ...] = ("batch",)
    extra: dict = field(default_factory=dict)

    def __repr__(self) -> str:
        return f"<{self.kind}:{self.name}>"


@dataclass(frozen=True)
class Edge:
    eid: int
    src: str
    dst: str
    tensor: TensorSpec

    def __repr__(self) -> str:
        return f"E{self.eid}({self.src}->{self.dst})"


class CompGraph:
    """Mutable multigraph of :class:`LayerNode` connected by :class:`Edge`."""

    def __init__(self) -> None:
        self.nodes: dict[str, LayerNode] = {}
        self.edges: dict[int, Edge] = {}
        self._out: dict[str, list[int]] = {}
        self._in: dict[str, list[int]] = {}
        self._next_eid = 0

    # -- construction --------------------------------------------------- #
    def add_node(self, node: LayerNode) -> LayerNode:
        if node.name in self.nodes:
            raise ValueError(f"duplicate node {node.name}")
        self.nodes[node.name] = node
        self._out[node.name] = []
        self._in[node.name] = []
        return node

    def add_edge(self, src: str, dst: str,
                 tensor: TensorSpec | None = None) -> Edge:
        if src not in self.nodes or dst not in self.nodes:
            raise KeyError(f"unknown endpoint {src}->{dst}")
        tensor = tensor if tensor is not None else self.nodes[src].out
        e = Edge(self._next_eid, src, dst, tensor)
        self._next_eid += 1
        self.edges[e.eid] = e
        self._out[src].append(e.eid)
        self._in[dst].append(e.eid)
        return e

    def remove_edge(self, eid: int) -> None:
        e = self.edges.pop(eid)
        self._out[e.src].remove(eid)
        self._in[e.dst].remove(eid)

    def remove_node(self, name: str) -> None:
        if self._out[name] or self._in[name]:
            raise ValueError(f"node {name} still has edges")
        del self.nodes[name]
        del self._out[name]
        del self._in[name]

    # -- queries ---------------------------------------------------------- #
    def in_edges(self, name: str) -> list[Edge]:
        return [self.edges[i] for i in self._in[name]]

    def out_edges(self, name: str) -> list[Edge]:
        return [self.edges[i] for i in self._out[name]]

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    @property
    def num_edges(self) -> int:
        return len(self.edges)

    def iter_edges(self) -> Iterator[Edge]:
        return iter(self.edges.values())

    def topo_order(self) -> list[str]:
        indeg = {n: len(self._in[n]) for n in self.nodes}
        ready = [n for n, d in indeg.items() if d == 0]
        order: list[str] = []
        while ready:
            n = ready.pop()
            order.append(n)
            for eid in self._out[n]:
                m = self.edges[eid].dst
                indeg[m] -= 1
                if indeg[m] == 0:
                    ready.append(m)
        if len(order) != len(self.nodes):
            raise ValueError("graph has a cycle")
        return order

    def validate_dag(self) -> None:
        self.topo_order()

    def copy(self) -> "CompGraph":
        g = CompGraph()
        for n in self.nodes.values():
            g.add_node(replace(n, extra=dict(n.extra)))
        # preserve edge ids so strategies and cost tables stay aligned
        for e in self.edges.values():
            g.edges[e.eid] = e
            g._out[e.src].append(e.eid)
            g._in[e.dst].append(e.eid)
        g._next_eid = self._next_eid
        return g

    def __repr__(self) -> str:
        return f"CompGraph(nodes={self.num_nodes}, edges={self.num_edges})"


# --------------------------------------------------------------------------- #
# A parallelization strategy: one LayerConfig per node (paper Section 4).
# --------------------------------------------------------------------------- #
@dataclass
class Strategy:
    assignment: dict[str, LayerConfig]
    cost: float = float("nan")
    meta: dict = field(default_factory=dict)

    def __getitem__(self, node: str) -> LayerConfig:
        return self.assignment[node]

    def describe(self, graph: CompGraph, mesh=None, max_rows: int = 0) -> str:
        """Human-readable strategy table (paper Table 5 style), grouping
        consecutive topo-ordered nodes that share a config."""
        rows: list[tuple[str, str]] = []
        order = [n for n in graph.topo_order() if n in self.assignment]
        for cfg_desc, group in itertools.groupby(
                order, key=lambda n: self.assignment[n].describe(mesh)):
            names = list(group)
            label = names[0] if len(names) == 1 else f"{names[0]}..{names[-1]} (x{len(names)})"
            rows.append((label, cfg_desc))
        if max_rows and len(rows) > max_rows:
            rows = rows[:max_rows] + [("...", "...")]
        width = max(len(r[0]) for r in rows) if rows else 10
        lines = [f"{label:<{width}}  {cfg}" for label, cfg in rows]
        return "\n".join(lines)


def uniform_strategy(graph: CompGraph, fn) -> Strategy:
    """Build a strategy by applying ``fn(node) -> LayerConfig`` per node."""
    return Strategy({name: fn(node) for name, node in graph.nodes.items()})
