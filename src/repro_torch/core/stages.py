"""Pipeline-stage partitioning: the second search level above the
per-layer elimination DP (the port's copy of ``repro.core.stages``).

The paper searches *intra-op* configs for every layer on one mesh; the
next hidden dimension is *inter-op* — cutting the layer graph into ``S``
contiguous pipeline stages and searching both levels jointly.  The mesh
factors into a ``stage`` axis times an intra-stage mesh (PaSE-style
two-level decomposition): each stage re-runs the existing elimination DP
(:mod:`.elimination` via :func:`.search.find_strategy`)
on its subgraph over the *smaller* intra-stage mesh, and the stage
partition itself is priced by :func:`.cost_model.pipeline_time`
(per-stage compute max + inter-stage activation transfer + the 1F1B
bubble ``(S-1)/(S-1+M)`` for ``M`` microbatches, from the tensor bytes
the exported graph already records on the cut edges).

``S=1`` delegates to the unstaged :func:`find_strategy` on the untouched
graph and mesh, so a single-stage search is bit-for-bit today's search.

Stage granularity is the *pattern unit* (``arch.n_units`` scanned units
of ``period`` layers each): that is the granularity the realized
``ModelPlan`` stacks parameters at, so a contiguous unit range maps
directly onto a slice of the stacked param leaves — which is what lets
the realization (the reference's ``repro.plans.shardings``; the port's
arrives with the realization slice) place each stage's parameter group on its
stage sub-mesh with a plain leading-dim PartitionSpec.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from .cost_model import pipeline_time
from .device import MeshSpec
from .graph import CompGraph, Strategy
from .search import SearchOptions, find_strategy

#: Name of the mesh axis the stage dimension factors out at execution.
STAGE_AXIS = "stage"


@dataclass(frozen=True)
class StageAssignment:
    """A contiguous partition of the unit stack into pipeline stages.

    ``boundaries`` has ``S+1`` entries ``(0, b_1, ..., n_units)``: stage
    ``s`` owns units ``[boundaries[s], boundaries[s+1])``.  The entry
    nodes (embed / frontend) ride stage 0 and the head (final_norm /
    lm_head) the last stage.  ``microbatches`` is the ``M`` the 1F1B
    schedule splits the global batch into; ``mesh_axis`` names the mesh
    axis carrying the stage dimension at execution.
    """

    boundaries: tuple[int, ...]
    microbatches: int = 1
    mesh_axis: str = STAGE_AXIS

    def __post_init__(self):
        b = tuple(int(x) for x in self.boundaries)
        if len(b) < 2 or b[0] != 0 or any(x >= y for x, y in zip(b, b[1:])):
            raise ValueError(
                f"stage boundaries must be strictly increasing from 0, "
                f"got {self.boundaries}")
        object.__setattr__(self, "boundaries", b)
        object.__setattr__(self, "microbatches", max(1, int(self.microbatches)))

    @property
    def num_stages(self) -> int:
        return len(self.boundaries) - 1

    @property
    def n_units(self) -> int:
        return self.boundaries[-1]

    def stage_of_unit(self, unit: int) -> int:
        """Stage owning ``unit``; entry (-1) and head (>= n_units) nodes
        clamp to the first / last stage."""
        if unit < self.boundaries[1]:
            return 0
        for s in range(1, self.num_stages):
            if unit < self.boundaries[s + 1]:
                return s
        return self.num_stages - 1

    def unit_range(self, stage: int) -> tuple[int, int]:
        return self.boundaries[stage], self.boundaries[stage + 1]

    def describe(self) -> str:
        ranges = " | ".join(f"[{a},{b})" for a, b in
                            zip(self.boundaries, self.boundaries[1:]))
        return (f"{self.num_stages} stage(s) over axis "
                f"{self.mesh_axis!r}: units {ranges}, "
                f"M={self.microbatches}")


def single_stage(n_units: int, microbatches: int = 1) -> StageAssignment:
    return StageAssignment((0, int(n_units)), microbatches=microbatches)


@dataclass
class StagedStrategy:
    """A merged per-node strategy plus the stage partition that priced it."""

    strategy: Strategy                 # configs for every node (all stages)
    stages: StageAssignment
    stage_costs: tuple[float, ...]     # per-stage intra-op seconds (full batch)
    cost: float                        # pipelined seconds per step
    bubble_frac: float
    interstage_bytes: float            # activation bytes crossing stage cuts
    meta: dict = field(default_factory=dict)


# --------------------------------------------------------------------------- #
# graph partitioning helpers
# --------------------------------------------------------------------------- #
def _node_units(graph: CompGraph) -> dict[str, int]:
    """The pattern-unit index graph_export recorded on every node.

    Entry nodes carry ``-1`` and head nodes ``n_units`` — both valid
    inputs to :meth:`StageAssignment.stage_of_unit`.
    """
    units = {}
    for name, node in graph.nodes.items():
        u = node.extra.get("unit")
        if u is None:
            raise ValueError(
                f"node {name!r} carries no stage-cut metadata "
                f"(extra['unit']); re-export the graph with a current "
                f"graph_export before staging it")
        units[name] = int(u)
    return units


def partition_units(weights, num_stages: int) -> tuple[int, ...]:
    """Contiguous partition of per-unit ``weights`` into ``num_stages``
    ranges minimizing the max stage weight (the classic linear-partition
    DP).  Ties break toward balanced unit counts, which is also what the
    stacked-parameter PartitionSpec realizes exactly."""
    n, S = len(weights), int(num_stages)
    if S < 1 or S > n:
        raise ValueError(f"cannot cut {n} units into {S} stages")
    prefix = [0.0]
    for w in weights:
        prefix.append(prefix[-1] + float(w))

    def rng(a, b):                     # weight of units [a, b)
        return prefix[b] - prefix[a]

    # dp[s][i]: (max stage weight, imbalance) for units [0, i) in s stages
    INF = (float("inf"), float("inf"))
    dp = [[INF] * (n + 1) for _ in range(S + 1)]
    cut = [[0] * (n + 1) for _ in range(S + 1)]
    dp[0][0] = (0.0, 0.0)
    target = n / S
    for s in range(1, S + 1):
        for i in range(s, n + 1):
            best, arg = INF, 0
            for j in range(s - 1, i):
                if dp[s - 1][j] is INF:
                    continue
                w = max(dp[s - 1][j][0], rng(j, i))
                bal = max(dp[s - 1][j][1], abs((i - j) - target))
                if (w, bal) < best:
                    best, arg = (w, bal), j
            dp[s][i], cut[s][i] = best, arg
    bounds = [n]
    i = n
    for s in range(S, 0, -1):
        i = cut[s][i]
        bounds.append(i)
    return tuple(reversed(bounds))


def factor_stage_mesh(mesh: MeshSpec, num_stages: int
                      ) -> tuple[str, MeshSpec] | None:
    """Factor ``num_stages`` out of one mesh axis: returns the factored
    axis name and the intra-stage sub-mesh, or ``None`` when no axis
    divides.  The slow inter-pod axis is never factored (a pipeline cut
    across pods is a different design point than stages within a node)."""
    cands = [a for a in mesh.axes
             if a.name != "pod" and a.size % num_stages == 0
             and a.size >= num_stages]
    if not cands:
        return None
    axis = max(cands, key=lambda a: a.size)
    return axis.name, mesh.subspec(**{axis.name: axis.size // num_stages})


def _stage_subgraph(graph: CompGraph, members: set[str]) -> CompGraph:
    import dataclasses
    sub = CompGraph()
    for name in graph.nodes:
        if name in members:
            node = graph.nodes[name]
            sub.add_node(dataclasses.replace(node, extra=dict(node.extra)))
    for e in graph.iter_edges():
        if e.src in members and e.dst in members:
            sub.add_edge(e.src, e.dst, tensor=e.tensor)
    return sub


# --------------------------------------------------------------------------- #
def find_staged_strategy(graph: CompGraph, mesh: MeshSpec, *,
                         n_units: int,
                         training: bool = True,
                         phase: str | None = None,
                         options: SearchOptions | None = None,
                         num_stages: int | None = None,
                         max_stages: int | None = None,
                         microbatches: int = 8,
                         mesh_axis: str = STAGE_AXIS,
                         profile=None) -> StagedStrategy:
    """Two-level search: stage partition x per-stage elimination DP.

    ``num_stages`` forces an exact stage count; ``max_stages`` searches
    every feasible ``S`` up to it (always including ``S=1``) and keeps
    the cheapest pipelined plan.  ``S=1`` is the unstaged
    :func:`find_strategy` on the untouched graph and mesh — bit-for-bit
    today's search.

    ``profile`` (a measured DeviceProfile) calibrates both search levels:
    each stage's elimination DP prices on the calibrated sub-mesh and the
    inter-stage transfer term uses the factored axis's measured
    bandwidth.
    """
    options = options or SearchOptions()
    if profile is not None:
        mesh = profile.calibrate_mesh(mesh)  # idempotent under find_strategy
    M = max(1, int(microbatches))
    if num_stages is not None and num_stages < 1:
        raise ValueError(f"num_stages must be >= 1, got {num_stages}")
    tr = (phase == "train") if phase is not None else training

    if num_stages is not None:
        wanted = [int(num_stages)]
    else:
        top = min(max(1, int(max_stages or 1)), max(1, int(n_units)))
        wanted = list(range(1, top + 1))
    t0 = time.perf_counter()

    candidates: list[StagedStrategy] = []
    for S in wanted:
        if S == 1:
            strat = find_strategy(graph, mesh, training=training,
                                  options=options, phase=phase,
                                  profile=profile)
            candidates.append(StagedStrategy(
                strategy=strat, stages=single_stage(n_units),
                stage_costs=(strat.cost,), cost=strat.cost,
                bubble_frac=0.0, interstage_bytes=0.0,
                meta={"stage_search_seconds": strat.meta.get(
                    "search_seconds")}))
            continue
        if S > n_units:
            continue
        prefixed = [n for n in graph.nodes if n.startswith(("enc", "dec."))]
        if prefixed:
            if num_stages is None:
                continue               # encoder-decoder: stay single-stage
            raise ValueError(
                "pipeline stages support decoder-only graphs; "
                f"found encoder/decoder-prefixed nodes like {prefixed[0]!r}")
        factored = factor_stage_mesh(mesh, S)
        if factored is None:
            continue                   # no axis divides by this S
        axis_name, submesh = factored
        units = _node_units(graph)

        # cost-aware contiguous cut over per-unit compute weight (units of
        # one pattern period are homogeneous, so this lands on the
        # balanced split the stacked-param PartitionSpec realizes exactly)
        weights = [0.0] * n_units
        for name, node in graph.nodes.items():
            if 0 <= units[name] < n_units:
                weights[units[name]] += node.flops
        assign = StageAssignment(partition_units(weights, S),
                                 microbatches=M, mesh_axis=mesh_axis)

        members: list[set[str]] = [set() for _ in range(S)]
        for name in graph.nodes:
            members[assign.stage_of_unit(units[name])].add(name)
        cut_bytes = 0.0
        for e in graph.iter_edges():
            if (assign.stage_of_unit(units[e.src])
                    != assign.stage_of_unit(units[e.dst])):
                cut_bytes += e.tensor.bytes

        merged: dict = {}
        stage_costs: list[float] = []
        stage_meta: list[dict] = []
        for s in range(S):
            sub = _stage_subgraph(graph, members[s])
            strat = find_strategy(sub, submesh, training=training,
                                  options=options, phase=phase,
                                  profile=profile)
            merged.update(strat.assignment)
            stage_costs.append(strat.cost)
            stage_meta.append({
                "units": list(assign.unit_range(s)),
                "cost_s": strat.cost,
                "search_seconds": strat.meta.get("search_seconds"),
                "device_bytes": strat.meta.get("device_bytes"),
            })
        pipe = pipeline_time(stage_costs, cut_bytes,
                             mesh.axis(axis_name).bw, M, training=tr)
        candidates.append(StagedStrategy(
            strategy=Strategy(merged, cost=pipe["total"]),
            stages=assign, stage_costs=tuple(stage_costs),
            cost=pipe["total"], bubble_frac=pipe["bubble_frac"],
            interstage_bytes=cut_bytes,
            meta={"factored_axis": axis_name,
                  "intra_mesh": [(a.name, a.size) for a in submesh.axes],
                  "per_stage": stage_meta,
                  "pipeline": pipe}))

    if not candidates:
        raise ValueError(
            f"no feasible stage count in {wanted} for mesh "
            f"{[(a.name, a.size) for a in mesh.axes]} and {n_units} units")
    best = min(candidates, key=lambda c: c.cost)
    if profile is not None:
        best.meta["device_profile"] = profile.fingerprint()
    best.meta["stage_search_seconds"] = time.perf_counter() - t0
    best.meta["stage_candidates"] = [
        {"stages": c.stages.num_stages, "cost_s": c.cost} for c in candidates]
    return best
