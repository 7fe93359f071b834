"""Node/edge elimination DP (paper Section 5.2, Algorithms 1 & 2): the
port's copy of ``repro.core.elimination``.

The optimizer works on *cost tables*, not on the model itself:

  * ``node_cost[n]``  — vector over ``n``'s configs of ``t_C + t_S``;
  * ``edge_cost[e]``  — matrix over (src cfg, dst cfg) of ``t_X``.

**Node elimination** (paper Eq. 2): a node ``j`` with exactly one in-edge
``(i,j)`` and one out-edge ``(j,k)`` is removed and replaced by an edge
``(i,k)`` whose cost table is the min-plus contraction

    new[ci, ck] = min_cj  in[ci, cj] + node[cj] + out[cj, ck]

**Edge elimination** (paper Eq. 3): two parallel edges ``(i,j)`` merge into
one whose table is the elementwise sum.

Both preserve global optimality (paper Theorems 1-4); undoing the
eliminations in reverse order recovers the optimal config for every
eliminated node (argmin tables are recorded).

Extension beyond the paper (clearly flagged, off in paper-faithful mode):
**source/sink folding** — a node with no in-edges and exactly one out-edge
(or the mirror) folds into its neighbor's node-cost vector:

    node'[ck] += min_ci  node[ci] + edge[ci, ck]

The optimality argument is the same one-step DP as Theorem 1.  This lets
graphs with multiple sources (e.g. encoder-decoder) collapse completely
instead of stopping at K=4.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np

from .config import LayerConfig
from .cost_model import CostModel
from .graph import CompGraph, Strategy


@dataclass
class _Record:
    kind: str                 # "node" | "edge" | "source" | "sink"
    node: str = ""            # eliminated node (node/source/sink)
    new_edge: int = -1        # edge id inserted (node elimination)
    in_edge: int = -1
    out_edge: int = -1
    e1: int = -1              # edge elimination: merged pair
    e2: int = -1
    ctx_src: str = ""         # neighbor names captured at elimination time
    ctx_dst: str = ""
    argmin: np.ndarray | None = None  # (Ci, Ck) or (Ck,) of best cj


@dataclass
class EliminationStats:
    node_elims: int = 0
    edge_elims: int = 0
    source_folds: int = 0
    sink_folds: int = 0
    final_nodes: int = 0
    enumerated: int = 0


class GraphOptimizer:
    """Finds a globally optimal strategy under the cost model (paper Alg. 1)."""

    def __init__(self, graph: CompGraph, cost_model: CostModel,
                 configs: dict[str, list[LayerConfig]],
                 fold_leaves: bool = True,
                 max_final_enum: int = 5_000_000,
                 extra_node_cost: dict | None = None):
        self.original = graph
        self.cm = cost_model
        self.configs = configs
        self.fold_leaves = fold_leaves
        self.max_final_enum = max_final_enum
        self.extra_node_cost = extra_node_cost or {}
        self.stats = EliminationStats()

    # ------------------------------------------------------------------ #
    def _build_tables(self, g: CompGraph):
        # Any memoization of repeated-layer tables lives inside the cost
        # model (which knows its own purity) — the optimizer must not
        # assume cost is a function of (tensor, config list) alone.
        self.node_cost: dict[str, np.ndarray] = {}
        for name, node in g.nodes.items():
            vec = self.cm.node_cost_vector(node, self.configs[name]).copy()
            if name in self.extra_node_cost:
                vec = vec + self.extra_node_cost[name]
            self.node_cost[name] = vec

        self.edge_cost: dict[int, np.ndarray] = {}
        for e in g.iter_edges():
            self.edge_cost[e.eid] = self.cm.edge_cost_matrix(
                e, self.configs[e.src], self.configs[e.dst])

    # ------------------------------------------------------------------ #
    def _try_node_elimination(self, g: CompGraph) -> _Record | None:
        for name in list(g.nodes):
            ins, outs = g.in_edges(name), g.out_edges(name)
            if len(ins) == 1 and len(outs) == 1:
                e_in, e_out = ins[0], outs[0]
                if e_in.src == name or e_out.dst == name:
                    continue  # self loop (impossible in a DAG, but guard)
                # min-plus contraction (paper Eq. 2)
                tmp = self.edge_cost[e_in.eid] + self.node_cost[name][None, :]
                stacked = tmp[:, :, None] + self.edge_cost[e_out.eid][None, :, :]
                best = stacked.min(axis=1)
                arg = stacked.argmin(axis=1).astype(np.int32)
                g.remove_edge(e_in.eid)
                g.remove_edge(e_out.eid)
                g.remove_node(name)
                new_e = g.add_edge(e_in.src, e_out.dst, e_in.tensor)
                self.edge_cost[new_e.eid] = best
                self.stats.node_elims += 1
                return _Record(kind="node", node=name, new_edge=new_e.eid,
                               in_edge=e_in.eid, out_edge=e_out.eid,
                               ctx_src=e_in.src, ctx_dst=e_out.dst, argmin=arg)
        return None

    def _try_edge_elimination(self, g: CompGraph) -> _Record | None:
        for name in list(g.nodes):
            outs = g.out_edges(name)
            seen: dict[str, int] = {}
            for e in outs:
                if e.dst in seen:
                    e1 = g.edges[seen[e.dst]]
                    merged = self.edge_cost[e1.eid] + self.edge_cost[e.eid]
                    g.remove_edge(e1.eid)
                    g.remove_edge(e.eid)
                    new_e = g.add_edge(name, e.dst, e1.tensor)
                    self.edge_cost[new_e.eid] = merged
                    self.stats.edge_elims += 1
                    return _Record(kind="edge", e1=e1.eid, e2=e.eid,
                                   new_edge=new_e.eid)
                seen[e.dst] = e.eid
        return None

    def _try_leaf_fold(self, g: CompGraph) -> _Record | None:
        if not self.fold_leaves or g.num_nodes <= 1:
            return None
        for name in list(g.nodes):
            ins, outs = g.in_edges(name), g.out_edges(name)
            if len(ins) == 0 and len(outs) == 1:
                e = outs[0]
                tmp = self.node_cost[name][:, None] + self.edge_cost[e.eid]
                self.node_cost[e.dst] = self.node_cost[e.dst] + tmp.min(axis=0)
                arg = tmp.argmin(axis=0).astype(np.int32)
                g.remove_edge(e.eid)
                g.remove_node(name)
                self.stats.source_folds += 1
                return _Record(kind="source", node=name, in_edge=e.eid,
                               ctx_dst=e.dst, argmin=arg)
            if len(outs) == 0 and len(ins) == 1:
                e = ins[0]
                tmp = self.edge_cost[e.eid] + self.node_cost[name][None, :]
                self.node_cost[e.src] = self.node_cost[e.src] + tmp.min(axis=1)
                arg = tmp.argmin(axis=1).astype(np.int32)
                g.remove_edge(e.eid)
                g.remove_node(name)
                self.stats.sink_folds += 1
                return _Record(kind="sink", node=name, out_edge=e.eid,
                               ctx_src=e.src, argmin=arg)
        return None

    # ------------------------------------------------------------------ #
    def optimize(self) -> Strategy:
        g = self.original.copy()
        self._build_tables(g)
        records: list[_Record] = []

        while True:
            rec = self._try_node_elimination(g)
            if rec is None:
                rec = self._try_edge_elimination(g)
            if rec is None:
                rec = self._try_leaf_fold(g)
            if rec is None:
                break
            records.append(rec)

        # ---- solve the residual graph by enumeration (paper line 14) ----
        self.stats.final_nodes = g.num_nodes
        final_nodes = list(g.nodes)
        sizes = [len(self.configs[n]) for n in final_nodes]
        n_combos = int(np.prod(sizes)) if sizes else 1
        if n_combos > self.max_final_enum:
            raise RuntimeError(
                f"residual graph too large to enumerate: {final_nodes} "
                f"({n_combos} combos). Enable fold_leaves or prune configs.")
        self.stats.enumerated = n_combos

        final_edges = list(g.iter_edges())
        best_cost = np.inf
        best_choice: tuple[int, ...] = ()
        idx = {n: i for i, n in enumerate(final_nodes)}
        for choice in itertools.product(*[range(s) for s in sizes]):
            c = 0.0
            for n, ci in zip(final_nodes, choice):
                c += self.node_cost[n][ci]
                if c >= best_cost:
                    break
            else:
                for e in final_edges:
                    c += self.edge_cost[e.eid][choice[idx[e.src]],
                                               choice[idx[e.dst]]]
                    if c >= best_cost:
                        break
                else:
                    best_cost = c
                    best_choice = choice
        assignment: dict[str, int] = {
            n: ci for n, ci in zip(final_nodes, best_choice)}

        # ---- undo eliminations in reverse (paper lines 15-23) -----------
        for rec in reversed(records):
            if rec.kind == "node":
                ci = assignment[rec.ctx_src]
                ck = assignment[rec.ctx_dst]
                assignment[rec.node] = int(rec.argmin[ci, ck])
            elif rec.kind == "edge":
                pass  # Theorem 2: strategy unchanged
            elif rec.kind == "source":
                assignment[rec.node] = int(rec.argmin[assignment[rec.ctx_dst]])
            elif rec.kind == "sink":
                assignment[rec.node] = int(rec.argmin[assignment[rec.ctx_src]])

        strategy = Strategy(
            {n: self.configs[n][ci] for n, ci in assignment.items()},
            cost=float(best_cost) if np.isfinite(best_cost) else float("nan"),
        )
        # best_cost above covers only the residual graph; recompute the full
        # objective on the original graph (also validates the undo).
        strategy.cost = self.cm.total_time(self.original, strategy)
        strategy.meta["stats"] = self.stats
        return strategy


# --------------------------------------------------------------------------- #
# Baseline: exhaustive depth-first enumeration (paper Table 3's baseline).
# --------------------------------------------------------------------------- #
def brute_force_optimize(graph: CompGraph, cost_model: CostModel,
                         configs: dict[str, list[LayerConfig]],
                         limit: int = 50_000_000) -> Strategy:
    names = list(graph.nodes)
    sizes = [len(configs[n]) for n in names]
    total = int(np.prod(sizes))
    if total > limit:
        raise RuntimeError(f"brute force too large: {total} strategies")
    node_vec = {n: cost_model.node_cost_vector(graph.nodes[n], configs[n])
                for n in names}
    edges = list(graph.iter_edges())
    edge_mat = {e.eid: cost_model.edge_cost_matrix(e, configs[e.src],
                                                   configs[e.dst])
                for e in edges}
    idx = {n: i for i, n in enumerate(names)}
    best = np.inf
    best_choice = None
    for choice in itertools.product(*[range(s) for s in sizes]):
        c = 0.0
        for n, ci in zip(names, choice):
            c += node_vec[n][ci]
            if c >= best:
                break
        else:
            for e in edges:
                c += edge_mat[e.eid][choice[idx[e.src]], choice[idx[e.dst]]]
                if c >= best:
                    break
            else:
                best = c
                best_choice = choice
    assert best_choice is not None
    return Strategy({n: configs[n][ci] for n, ci in zip(names, best_choice)},
                    cost=float(best))
