"""High-level strategy search API: the port's copy of
``repro.core.search``, whose memory budget follows the mesh's chip.

``find_strategy(graph, mesh_spec)`` enumerates per-layer configuration
spaces (paper Section 4), builds the cost tables, and runs the elimination
DP (paper Algorithm 1) to return a globally optimal :class:`Strategy` under
the cost model.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from .config import LayerConfig, enumerate_configs
from .cost_model import CostModel, node_device_bytes, strategy_device_bytes
from .device import MeshSpec
from .elimination import GraphOptimizer, brute_force_optimize
from .graph import CompGraph, Strategy


#: The per-chip HBM budget as a fraction of the chip's capacity.
HBM_BUDGET_FRACTION = 0.85
#: ``SearchOptions.hbm_budget``'s default: resolved per mesh by
#: :meth:`SearchOptions.budget_for` to ``HBM_BUDGET_FRACTION`` of the
#: mesh chip's ``hbm_bytes`` (on the reference's chip, the reference's
#: default to the bit).
CHIP_BUDGET = "chip"


@dataclass
class SearchOptions:
    # Restrict the slow inter-pod axis to the batch dim (or unused).  Sound
    # for speed: inter-pod bandwidth makes non-DP pod sharding dominated;
    # disable to search the full space.
    pod_axis_batch_only: bool = True
    # Source/sink folding (extension beyond the paper; see elimination.py).
    fold_leaves: bool = True
    # FSDP-stored config variants for parameter-heavy layers (extension).
    fsdp_variants: bool = True
    # HBM capacity budget per chip in bytes; None disables the Lagrangian
    # loop; CHIP_BUDGET follows the mesh's chip (the port's departure: the
    # reference fixes its own chip's figure here).
    hbm_budget: float | str | None = CHIP_BUDGET
    activation_allowance: float = 2.5e9
    # Paper-faithful mode for Table-3-style comparisons.
    paper_faithful: bool = False
    # Inter-op (pipeline) search level — consumed by
    # core.stages.find_staged_strategy: the largest stage count the
    # two-level search may cut the layer graph into (1 = today's purely
    # intra-op search, bit-for-bit), and the microbatch count ``M`` the
    # 1F1B schedule is priced (and executed) with.
    max_stages: int = 1
    stage_microbatches: int = 8

    def __post_init__(self):
        if self.paper_faithful:
            self.fold_leaves = False
            self.fsdp_variants = False
            self.hbm_budget = None

    def budget_for(self, mesh: MeshSpec) -> float | None:
        """The budget in bytes on ``mesh``'s chip (``None``: no budget)."""
        if self.hbm_budget == CHIP_BUDGET:
            return mesh.chip.hbm_bytes * HBM_BUDGET_FRACTION
        return self.hbm_budget


def config_space(graph: CompGraph, mesh: MeshSpec,
                 options: SearchOptions | None = None
                 ) -> dict[str, list[LayerConfig]]:
    """Per-node configuration lists.

    Configs whose per-dim degree exceeds the dim's size (recorded by
    graph_export in ``node.extra["dim_sizes"]``) are dropped — you cannot
    usefully partition 8 KV heads 16 ways.  Identical (parallel_dims,
    dim_sizes) keys share one list object so the optimizer's table caches
    can key on ``id(list)``.
    """
    options = options or SearchOptions()
    cache: dict[tuple, list[LayerConfig]] = {}
    out: dict[str, list[LayerConfig]] = {}
    for name, node in graph.nodes.items():
        sizes = node.extra.get("dim_sizes", {})
        fsdp = options.fsdp_variants and node.param_bytes > 1e6
        key = (tuple(node.parallel_dims), fsdp,
               tuple(sorted((d, sizes[d]) for d in node.parallel_dims
                            if d in sizes)))
        if key not in cache:
            cfgs = enumerate_configs(mesh, tuple(node.parallel_dims),
                                     fsdp_variants=fsdp)
            if options.pod_axis_batch_only and any(
                    a.name == "pod" for a in mesh.axes):
                cfgs = [c for c in cfgs
                        if all(a != "pod" or d == "batch"
                               for d, axes in c.shards for a in axes)]
            # realizability: every sharded dim must be exactly divisible
            # (a sharded argument is not padded)
            cfgs = [c for c in cfgs
                    if all(d not in sizes or sizes[d] % mesh.degree(axes) == 0
                           for d, axes in c.shards)]
            cache[key] = cfgs
        out[name] = cache[key]
    return out


def fsdp_stored(graph: CompGraph, mesh: MeshSpec,
                strategy: Strategy) -> Strategy:
    """``strategy`` with every layer of over 1 MB of parameters stored
    FSDP-sharded over the mesh axes that replicate it (the baselines'
    variant the memory-budget fallback adds to its candidates), with no
    meta."""
    return Strategy({
        n: (c.with_fsdp()
            if graph.nodes[n].param_bytes > 1e6
            and c.replicating_axes(mesh) else c)
        for n, c in strategy.assignment.items()})


def find_strategy(graph: CompGraph, mesh: MeshSpec,
                  training: bool = True,
                  options: SearchOptions | None = None,
                  configs: dict[str, list[LayerConfig]] | None = None,
                  phase: str | None = None,
                  profile=None) -> Strategy:
    """Optimal strategy under the cost model; when an ``hbm_budget`` is set,
    a Lagrangian-relaxation loop adds a per-byte price to each node's
    persistent memory and re-solves until the plan fits (extension beyond
    the paper, which assumes parameters always fit).

    ``phase`` ("train" | "prefill" | "decode") names the workload being
    priced and subsumes ``training``: pass the graph exported for that
    phase's shape and the matching phase here — decode prices a
    single-token ragged batch over the cache slots with no gradient
    sync, prefill a batch-1 long sequence (both reuse the
    ``training=False`` machinery).

    ``profile`` — a measured device profile (the reference's
    ``repro.profiling.DeviceProfile`` surface) — calibrates the cost
    model (:meth:`CostModel.from_profile`); the search then optimizes
    against measured chip rates and collective curves instead of the
    analytic constants, and the strategy's meta records the profile
    fingerprint.  ``None`` is bit-identical to
    today's analytic search."""
    options = options or SearchOptions()
    cm = CostModel.from_profile(profile, mesh, training=training, phase=phase)
    mesh = cm.mesh                     # calibrated (or unchanged) mesh
    training = cm.training
    cfgs = configs if configs is not None else config_space(graph, mesh, options)
    t0 = time.perf_counter()

    def solve(lam: float) -> Strategy:
        extra = None
        if lam > 0.0:
            extra = {
                name: np.array(
                    [lam * node_device_bytes(node, c, mesh, training)
                     for c in cfgs[name]])
                for name, node in graph.nodes.items()}
        opt = GraphOptimizer(graph, cm, cfgs, fold_leaves=options.fold_leaves,
                             extra_node_cost=extra)
        return opt.optimize()

    strategy = solve(0.0)
    budget = options.budget_for(mesh)
    if budget is not None:
        def mem_of(s):
            return strategy_device_bytes(graph, s, mesh, training,
                                         options.activation_allowance)

        candidates = [(strategy, mem_of(strategy))]
        lam = 1e-12          # seconds per byte: ~1 ms/GB starting price
        iters = 0
        while candidates[-1][1] > budget and iters < 12:
            s = solve(lam)
            candidates.append((s, mem_of(s)))
            lam *= 4.0
            iters += 1
        if iters:
            # Lagrangian relaxation has a duality gap: guarantee we never
            # fall below a feasible uniform baseline by seeding the
            # candidate pool with them (plus their FSDP-stored variants).
            from .strategies import BASELINES
            for fn in BASELINES.values():
                base = fn(graph, mesh)
                candidates.append((base, mem_of(base)))
                fsdp_base = fsdp_stored(graph, mesh, base)
                candidates.append((fsdp_base, mem_of(fsdp_base)))
        # among feasible candidates pick the cheapest true objective;
        # if none fits, keep the smallest-memory one.
        for s, m in candidates:
            s.cost = cm.total_time(graph, s)
        feasible = [(s, m) for s, m in candidates
                    if m <= budget]
        lam0_meta = dict(candidates[0][0].meta)
        if feasible:
            strategy, mem = min(feasible, key=lambda sm: sm[0].cost)
        else:
            strategy, mem = min(candidates, key=lambda sm: sm[1])
        # baseline-seeded winners carry no elimination stats: inherit the
        # lam=0 solve's meta so callers always see search metadata
        for k, v in lam0_meta.items():
            strategy.meta.setdefault(k, v)
        strategy.meta["device_bytes"] = mem
        strategy.meta["capacity_iters"] = iters

    strategy.meta["search_seconds"] = time.perf_counter() - t0
    strategy.meta["mesh"] = mesh
    strategy.meta["training"] = training
    strategy.meta["phase"] = cm.phase
    if profile is not None:
        strategy.meta["device_profile"] = profile.fingerprint()
    return strategy


def find_strategy_brute_force(graph: CompGraph, mesh: MeshSpec,
                              training: bool = True,
                              configs: dict[str, list[LayerConfig]] | None = None,
                              options: SearchOptions | None = None) -> Strategy:
    """Exhaustive DFS baseline (paper Table 3)."""
    options = options or SearchOptions()
    cm = CostModel(mesh, training=training)
    cfgs = configs if configs is not None else config_space(graph, mesh, options)
    t0 = time.perf_counter()
    strategy = brute_force_optimize(graph, cm, cfgs)
    strategy.meta["search_seconds"] = time.perf_counter() - t0
    return strategy
