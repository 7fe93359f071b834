"""The port's copy of the paper's search (``repro_torch.core`` and
``repro_torch.models.graph_export``) against the reference's on the CPU.

Each parity case runs the reference's function and the port's on the same
inputs, at reduced sizes:

  * ``export_graph`` for every arch of the port's ``configs.ALL_ARCHS``
    (reduced) x the train / prefill / decode phases: node names, kinds,
    tensor specs, flops, bytes, parallel dims, metadata and edges equal;
  * ``CostModel.total_time`` of the uniform, data, model and owt
    strategies, within rel 1e-12, and ``find_strategy``'s per-node
    configs (exactly) and cost (rel 1e-12), on the three meshes the
    chip smoke searches (one node of 8, one of 2 x 4, two such nodes) with
    the reference's chip, the only one it knows;
  * ``find_staged_strategy`` at S = 2 and auto: the same boundaries and
    cost.

Then the port alone: the elimination DP equals brute force on small
random graphs, the searched cost is no more than that of any baseline
the search space holds on H100 meshes, and the memory budget follows the
mesh's chip.
"""

import dataclasses

import numpy as np
import pytest
pytest.importorskip("torch")

from repro import configs as RC
from repro.core import AxisSpec as RAxisSpec
from repro.core import BASELINES as RBASELINES
from repro.core import CostModel as RCostModel
from repro.core import LayerConfig as RLayerConfig
from repro.core import MeshSpec as RMeshSpec
from repro.core import SearchOptions as RSearchOptions
from repro.core import TPU_V5E as RTPU_V5E
from repro.core import find_strategy as rfind_strategy
from repro.core import uniform_strategy as runiform_strategy
from repro.core.stages import find_staged_strategy as rfind_staged
from repro.models.graph_export import export_graph as rexport_graph
from repro.models.graph_export import phase_shape as rphase_shape
from repro_torch import configs as TC
from repro_torch.core import (BASELINES, H100_SXM, TPU_V5E, CompGraph,
                              CostModel, LayerConfig, LayerNode,
                              SearchOptions, TensorSpec, config_space,
                              find_strategy, h100_mesh_spec,
                              single_pod_mesh_spec, uniform_strategy)
from repro_torch.core.cost_model import strategy_device_bytes
from repro_torch.core.elimination import GraphOptimizer, brute_force_optimize
from repro_torch.core.stages import find_staged_strategy
from repro_torch.models.graph_export import export_graph, phase_shape

REL = 1e-12
PHASES = {
    "train": dict(seq_len=64, batch=8),
    "prefill": dict(seq_len=64, batch=1),
    # the engine's mixed step at the paged pool's depth, int8 pool
    "decode": dict(seq_len=64, batch=4, kv_tokens=48, q_tokens=2,
                   kv_quant="int8"),
}
# (nodes, data, model): the chip smoke's meshes
MESHES = [(1, 8, 1), (1, 2, 4), (2, 2, 4)]


def _tpu_meshes():
    """The smoke's mesh shapes with the reference's chip, in both
    packages: (port mesh, reference mesh) pairs."""
    out = []
    for m in MESHES:
        pm = h100_mesh_spec(*m, chip=TPU_V5E)
        rm = RMeshSpec(axes=tuple(RAxisSpec(a.name, a.size, a.bw)
                                  for a in pm.axes), chip=RTPU_V5E)
        out.append((pm, rm))
    return out


def _graphs(name, phase):
    return (export_graph(TC.reduced(name), phase_shape(phase,
                                                       **PHASES[phase])),
            rexport_graph(RC.reduced(name), rphase_shape(phase,
                                                         **PHASES[phase])))


def _spec(t):
    return (t.dims, t.dtype_bytes)


def _graph_sig(g):
    nodes = [(n.name, n.kind, _spec(n.out), n.flops, n.param_bytes,
              n.act_bytes, tuple(n.parallel_dims), n.extra)
             for n in g.nodes.values()]
    edges = [(e.eid, e.src, e.dst, _spec(e.tensor))
             for e in g.edges.values()]
    return nodes, edges, g.topo_order()


def _cfg(c):
    return (c.shards, c.fsdp)


def _close(a, b):
    assert a == pytest.approx(b, rel=REL, abs=0.0), (a, b)


@pytest.mark.parametrize("phase", list(PHASES))
@pytest.mark.parametrize("name", TC.ALL_ARCHS)
def test_export_graph_matches_reference(name, phase):
    g, rg = _graphs(name, phase)
    assert _graph_sig(g) == _graph_sig(rg)
    assert g.num_nodes > 10


@pytest.mark.parametrize("phase", list(PHASES))
@pytest.mark.parametrize("name", TC.ALL_ARCHS)
def test_costs_and_searched_configs_match_reference(name, phase):
    """On each mesh: the four strategies' ``total_time`` within rel
    1e-12, then the searched per-node configs equal and its cost within
    rel 1e-12."""
    g, rg = _graphs(name, phase)
    for pm, rm in _tpu_meshes():
        cm, rcm = CostModel(pm, phase=phase), RCostModel(rm, phase=phase)
        uni = uniform_strategy(g, lambda n: LayerConfig.make(
            batch=("data",)))
        runi = runiform_strategy(rg, lambda n: RLayerConfig.make(
            batch=("data",)))
        _close(cm.total_time(g, uni), rcm.total_time(rg, runi))
        for b in ("data", "model", "owt"):
            _close(cm.total_time(g, BASELINES[b](g, pm)),
                   rcm.total_time(rg, RBASELINES[b](rg, rm)))
        s = find_strategy(g, pm, phase=phase)
        rs = rfind_strategy(rg, rm, phase=phase)
        assert {n: _cfg(c) for n, c in s.assignment.items()} == {
            n: _cfg(c) for n, c in rs.assignment.items()}, pm.axes
        _close(s.cost, rs.cost)
        assert s.meta["device_bytes"] == rs.meta["device_bytes"]
        assert s.meta["capacity_iters"] == rs.meta["capacity_iters"]


@pytest.mark.parametrize("stages", [2, "auto"])
@pytest.mark.parametrize("name", ["llama3_2_1b", "olmoe_1b_7b", "rwkv6_1b6",
                                  "jamba_1_5_large"])
def test_staged_search_matches_reference(name, stages):
    """Four pattern units on a data 4 x model 2 mesh: the stage count
    (forced 2, or searched up to 4), the boundaries, the per-stage and
    pipelined costs and the merged per-node configs."""
    def deep(arch):
        return dataclasses.replace(arch, n_layers=4 * arch.period)
    arch, rarch = deep(TC.reduced(name)), deep(RC.reduced(name))
    shape = dict(seq_len=32, batch=8)
    g = export_graph(arch, phase_shape("train", **shape))
    rg = rexport_graph(rarch, rphase_shape("train", **shape))
    kw = (dict(num_stages=2) if stages == 2 else dict(max_stages=4))
    mesh = single_pod_mesh_spec(4, 2)
    rmesh = RMeshSpec(axes=(RAxisSpec("data", 4, mesh.axes[0].bw),
                            RAxisSpec("model", 2, mesh.axes[1].bw)))
    st = find_staged_strategy(g, mesh, n_units=arch.n_units, phase="train",
                              **kw)
    rst = rfind_staged(rg, rmesh, n_units=rarch.n_units, phase="train", **kw)
    assert st.stages.boundaries == rst.stages.boundaries
    assert st.stages.microbatches == rst.stages.microbatches
    _close(st.cost, rst.cost)
    for a, b in zip(st.stage_costs, rst.stage_costs, strict=True):
        _close(a, b)
    assert st.interstage_bytes == rst.interstage_bytes
    assert {n: _cfg(c) for n, c in st.strategy.assignment.items()} == {
        n: _cfg(c) for n, c in rst.strategy.assignment.items()}
    assert [c["stages"] for c in st.meta["stage_candidates"]] == [
        c["stages"] for c in rst.meta["stage_candidates"]]


# --------------------------------------------------------------------------- #
# the port alone
# --------------------------------------------------------------------------- #
class _TableCostModel:
    """A cost model of random tables (duck-types ``CostModel``), so the
    check covers the algorithm, not one hardware model."""

    def __init__(self, rng, graph, configs):
        self.nodes = {n: rng.uniform(0, 10, len(configs[n]))
                      for n in graph.nodes}
        self.edges = {e.eid: rng.uniform(0, 10, (len(configs[e.src]),
                                                 len(configs[e.dst])))
                      for e in graph.iter_edges()}
        self.configs = configs

    def node_cost_vector(self, node, configs):
        return self.nodes[node.name].copy()

    def edge_cost_matrix(self, edge, src_cfgs, dst_cfgs):
        return self.edges[edge.eid].copy()

    def total_time(self, graph, strategy):
        idx = {n: self.configs[n].index(strategy[n]) for n in graph.nodes}
        return (sum(self.nodes[n][idx[n]] for n in graph.nodes)
                + sum(self.edges[e.eid][idx[e.src], idx[e.dst]]
                      for e in graph.iter_edges()))


def _random_dag(rng, n_nodes, extra, multi):
    g = CompGraph()
    t = TensorSpec.make(batch=4, d_model=8)
    for i in range(n_nodes):
        g.add_node(LayerNode(f"n{i}", "norm", t, flops=1.0))
    for i in range(1, n_nodes):
        g.add_edge(f"n{int(rng.integers(0, i))}", f"n{i}")
    for _ in range(extra + multi):      # forward and parallel edges
        i, j = sorted(rng.choice(n_nodes, size=2, replace=False))
        g.add_edge(f"n{i}", f"n{j}")
    g.validate_dag()
    return g


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("seed", range(8))
def test_elimination_equals_brute_force_on_random_graphs(seed, fold):
    rng = np.random.default_rng(seed)
    g = _random_dag(rng, int(rng.integers(3, 9)), int(rng.integers(0, 5)),
                    int(rng.integers(0, 4)))
    pool = [LayerConfig.make({}), LayerConfig.make(batch=("data",)),
            LayerConfig.make(batch=("data", "model")),
            LayerConfig.make(batch=("model",))]
    configs = {n: pool[:int(rng.integers(1, 5))] for n in g.nodes}
    cm = _TableCostModel(rng, g, configs)
    dp = GraphOptimizer(g, cm, configs, fold_leaves=fold).optimize()
    bf = brute_force_optimize(g, cm, configs)
    assert cm.total_time(g, dp) == pytest.approx(bf.cost, rel=REL)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("name", ["llama3_2_1b", "olmoe_1b_7b",
                                  "jamba_1_5_large", "seamless_m4t_v2"])
def test_searched_never_costs_more_than_a_baseline_on_h100(name, mesh):
    """Without the memory budget the search is optimal over its space, so
    its cost is at most that of every baseline whose configs lie in that
    space (a baseline may split a dimension that does not divide, e.g.
    batch 1 over the pod axis: the space excludes such configs).  The
    published widths, cut to two pattern units, at batch 16."""
    arch = TC.get(name)
    arch = dataclasses.replace(arch, n_layers=2 * arch.period,
                               enc_layers=min(arch.enc_layers, 2))
    m = h100_mesh_spec(*mesh)
    opts = SearchOptions(hbm_budget=None)
    checked = 0
    for phase, batch in (("train", 16), ("prefill", 1), ("decode", 16)):
        g = export_graph(arch, phase_shape(phase, seq_len=64, batch=batch))
        s = find_strategy(g, m, phase=phase, options=opts)
        space = config_space(g, m, opts)
        cm = CostModel(m, phase=phase)
        for fn in BASELINES.values():
            base = fn(g, m)
            if all(base[n] in space[n] for n in g.nodes):
                assert s.cost <= cm.total_time(g, base) * (1 + 1e-9)
                checked += 1
    assert checked >= 2


def test_memory_budget_follows_the_mesh_chip():
    opts = SearchOptions()
    assert opts.budget_for(h100_mesh_spec()) == 0.85 * 80e9
    assert (opts.budget_for(single_pod_mesh_spec(8, 1))
            == RSearchOptions().hbm_budget)
    assert SearchOptions(hbm_budget=1e9).budget_for(h100_mesh_spec()) == 1e9
    assert SearchOptions(paper_faithful=True).budget_for(
        h100_mesh_spec()) is None
    # a chip too small for the unconstrained optimum: the Lagrangian loop
    # runs against 0.85 x its capacity and returns a plan that fits
    arch = TC.reduced("llama3_2_1b")
    g = export_graph(arch, phase_shape("train", **PHASES["train"]))
    free = find_strategy(g, h100_mesh_spec(1, 2, 4), phase="train",
                         options=SearchOptions(hbm_budget=None,
                                               activation_allowance=0.0))
    need = strategy_device_bytes(g, free, h100_mesh_spec(1, 2, 4), True,
                                 0.0)
    small = dataclasses.replace(H100_SXM, hbm_bytes=0.9 * need / 0.85)
    s = find_strategy(g, h100_mesh_spec(1, 2, 4, chip=small), phase="train",
                      options=SearchOptions(activation_allowance=0.0))
    assert s.meta["capacity_iters"] > 0
    assert s.meta["device_bytes"] <= 0.9 * need * (1 + 1e-12)
