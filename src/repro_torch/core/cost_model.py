"""The paper's cost model (Section 5.1), adapted to a named-axis device
mesh: the port's copy of ``repro.core.cost_model``.

Three cost functions (paper Eq. 1):

  t_C(l, c)      — fwd+bwd compute time of layer ``l`` under config ``c``.
                   The paper *measures* this per-config on the GPU; without
                   a measured profile we use the analytic roofline
                   ``max(flops/(d·peak), bytes/(d·hbm_bw))`` with the
                   mesh chip's constants, plus any *layer-internal*
                   collective the config induces (KV all-gather under
                   seq-sharding, MoE all-to-all under expert-sharding,
                   ...).  (The reference's
                   dry run cross-checks these terms against XLA.)

  t_S(l, c)      — gradient synchronization: ring all-reduce of the layer's
                   parameter-gradient shard over every mesh axis that
                   *replicates* the parameters under ``c`` (the SPMD analogue
                   of the paper's parameter-server round trip).

  t_X(e, ci, cj) — tensor re-layout between producer and consumer configs:
                   per mesh axis classified as no-op / all-gather / slice
                   (free) / all-to-all, with ring-collective byte formulas.

All times are seconds for one step at the global batch baked into the graph;
every collective also reports per-chip bytes so communication cost (paper
Fig. 8) falls out of the same code path.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from .config import LayerConfig
from .device import CollectiveCost, MeshSpec, ZERO_COST
from .graph import CompGraph, Edge, LayerNode, Strategy, TensorSpec

# --------------------------------------------------------------------------- #
# Per-backend kernel cost hooks.
#
# The roofline in t_c assumes the layer's hot loop runs at hardware
# efficiency; for ops behind the kernel dispatcher the achievable fraction
# depends on WHICH backend executes (a sequential reference scan on the VPU
# is nowhere near a fused Pallas kernel).  A hook, keyed by
# (dispatch op, backend), returns a multiplicative factor on the layer's
# roofline time; ``CostModel(kernel_backends={...})`` prices a strategy
# under a chosen backend per op.  No entry / no hook -> factor 1.0, so the
# default cost model is unchanged.
# --------------------------------------------------------------------------- #
KERNEL_OP_FOR_KIND = {"ssm": "mamba_scan", "moe": "moe_dispatch_combine"}

_KERNEL_COST_HOOKS: dict[tuple[str, str], Callable[[LayerNode], float]] = {}


def register_kernel_cost_hook(op: str, backend: str):
    """Decorator: ``fn(node) -> float`` multiplies the roofline time of
    every ``node`` whose kind executes through ``op`` on ``backend``."""

    def deco(fn):
        _KERNEL_COST_HOOKS[(op, backend)] = fn
        return fn

    return deco


def kernel_time_factor(node: LayerNode,
                       kernel_backends: dict[str, str],
                       overrides: dict[tuple[str, str], float] | None = None,
                       ) -> float:
    """Multiplicative roofline factor for ``node`` under the chosen
    dispatch backends.  ``overrides`` — measured ``(op, backend) ->
    factor`` entries from a device profile — take precedence over the
    registered analytic hooks; absent entries fall back hook-by-hook."""
    op = KERNEL_OP_FOR_KIND.get(node.kind)
    backend = kernel_backends.get(op) if op else None
    if backend is None:
        return 1.0
    if overrides:
        measured = overrides.get((op, backend))
        if measured is not None:
            return measured
    fn = _KERNEL_COST_HOOKS.get((op, backend))
    return fn(node) if fn is not None else 1.0


@register_kernel_cost_hook("mamba_scan", "ref")
def _mamba_ref_factor(node: LayerNode) -> float:
    # sequential per-step scan: the recurrence issues O(S) tiny VPU ops
    # with no overlap between the state update and the HBM streams.
    return 3.0


@register_kernel_cost_hook("mamba_scan", "xla")
def _mamba_xla_factor(node: LayerNode) -> float:
    # chunked associative scan: ~2x the FLOPs of the recurrence (up-sweep
    # + down-sweep) but parallel across the chunk, and the (chunk, di, N)
    # discretized terms round-trip HBM once.
    return 1.5


@register_kernel_cost_hook("mamba_scan", "pallas")
def _mamba_pallas_factor(node: LayerNode) -> float:
    # fused kernel: state resident in VMEM, inputs streamed once (the
    # reference's TPU kernel; an H100 profile recalibrates this factor).
    return 1.0


@register_kernel_cost_hook("moe_dispatch_combine", "ref")
def _moe_ref_factor(node: LayerNode) -> float:
    # dense one-hot dispatch einsums move an O(S·E·C) tensor through the
    # MXU on top of the expert FFN (~E·C/(S·K) extra work at cap 1.25).
    return 1.0 + 2.0 * float(node.extra.get("capacity_factor", 1.25))


@register_kernel_cost_hook("moe_dispatch_combine", "xla")
def _moe_xla_factor(node: LayerNode) -> float:
    # scatter/gather dispatch: the production path the roofline models.
    return 1.0


@register_kernel_cost_hook("moe_dispatch_combine", "pallas")
def _moe_pallas_factor(node: LayerNode) -> float:
    # fused dispatch keeps the (E·C, D) buffer in VMEM instead of a
    # scatter->HBM->einsum round trip (the reference's TPU kernel; an H100
    # profile recalibrates this factor).
    return 0.9


class CostModel:
    def __init__(self, mesh: MeshSpec, training: bool = True,
                 kernel_backends: dict[str, str] | None = None,
                 phase: str | None = None,
                 kernel_factors: dict[tuple[str, str], float] | None = None):
        """``phase`` ("train" | "prefill" | "decode") is the workload the
        model prices; it subsumes the older ``training`` flag — prefill
        and decode reuse the inference machinery (no t_S, no bwd
        collectives), while the decode-vs-prefill distinction lives in
        the exported graph (single-token batch over cache slots, with
        attention flagged cache-read-dominated via ``extra["decode"]``).
        """
        if phase is not None:
            if phase not in ("train", "prefill", "decode"):
                raise ValueError(f"unknown phase {phase!r}")
            training = phase == "train"
        self.phase = phase or ("train" if training else "inference")
        self.mesh = mesh
        self.training = training  # inference => no t_S, no bwd collectives
        # op name -> dispatch backend the strategy will execute with (see
        # kernel cost hooks above); absent ops price at factor 1.0.
        self.kernel_backends = dict(kernel_backends or {})
        # measured (op, backend) -> factor overrides from a device profile;
        # consulted before the registered analytic hooks.
        self.kernel_factors = dict(kernel_factors or {})
        self._reshard_cache: dict = {}
        # memoization of per-node vectors / per-edge matrices: sound here
        # because t_C/t_S/t_X are pure functions of the keyed quantities
        self._node_vec_cache: dict = {}
        self._edge_mat_cache: dict = {}

    @classmethod
    def from_profile(cls, profile, mesh: MeshSpec, training: bool = True,
                     kernel_backends: dict[str, str] | None = None,
                     phase: str | None = None) -> "CostModel":
        """A cost model calibrated by a measured device profile.

        ``profile`` is any object with the reference's
        ``repro.profiling.DeviceProfile`` calibration surface —
        ``calibrate_mesh(mesh)``
        (measured chip efficiencies + per-axis collective curves) and
        ``kernel_factors()`` (measured per-(op, backend) roofline
        factors).  Fields the profile lacks keep their analytic values,
        so ``from_profile(None, mesh, ...)`` — or an empty profile — is
        bit-identical to ``CostModel(mesh, ...)``.
        """
        factors = None
        if profile is not None:
            mesh = profile.calibrate_mesh(mesh)
            factors = profile.kernel_factors()
        return cls(mesh, training=training, kernel_backends=kernel_backends,
                   phase=phase, kernel_factors=factors)

    # ------------------------------------------------------------------ #
    # t_C
    # ------------------------------------------------------------------ #
    def roofline_time(self, node: LayerNode, cfg: LayerConfig) -> float:
        """The pure on-chip part of :meth:`t_c` — max(compute, memory)
        times the kernel backend factor, with no collective terms.  This
        is the quantity the profiling calibration report compares against
        a measured execution of the node's per-device work."""
        mesh = self.mesh
        deg = cfg.degree(mesh)
        pdeg = max(1, cfg.degree(mesh, dims=[d for d in cfg.dims
                                             if d not in ("batch", "seq")]))
        compute = node.flops / deg / mesh.chip.eff_flops
        memory = (node.act_bytes / deg
                  + node.param_bytes / pdeg) / mesh.chip.eff_hbm_bw
        factor = kernel_time_factor(node, self.kernel_backends,
                                    self.kernel_factors)
        return factor * max(compute, memory)

    def t_c(self, node: LayerNode, cfg: LayerConfig) -> float:
        mesh = self.mesh
        t = self.roofline_time(node, cfg) + self.internal_comm(node, cfg).time
        if cfg.fsdp and node.param_bytes > 0:
            # FSDP: params stored sharded across the replicating axes and
            # all-gathered at each use (fwd + bwd re-gather).
            rep = cfg.replicating_axes(mesh)
            shard = node.param_bytes / max(1, cfg.param_store_degree(mesh))
            n = 2.0 if self.training else 1.0
            t += n * mesh.all_gather(shard, rep).time
        return t

    def internal_comm(self, node: LayerNode, cfg: LayerConfig) -> CollectiveCost:
        """Collectives a config induces *inside* a layer."""
        mesh = self.mesh
        kind = node.kind
        total = ZERO_COST
        if kind in ("attn", "cross_attn"):
            seq_axes = cfg.axes_for("seq")
            if seq_axes:
                if node.extra.get("decode"):
                    # decode with a seq-sharded KV cache: flash-decode style
                    # partial-softmax combine — all-reduce of per-shard
                    # (m, l, o) statistics in f32 over the seq axes.
                    out_f32 = node.out.num_elements * 4.0 / max(
                        1, cfg.degree(mesh, dims=("batch", "heads")))
                    total = total + mesh.all_reduce(out_f32 * 1.1, seq_axes)
                else:
                    # ring attention / KV all-gather: each device must see
                    # all K/V along the sequence-sharded axes.
                    kv_global = node.extra.get("kv_bytes", 0.0)
                    shard = kv_global / max(1, cfg.degree(mesh))
                    total = total + mesh.all_gather(shard, seq_axes)
                    if self.training:
                        # bwd: dK/dV reduce-scatter mirrors the gather
                        total = total + mesh.reduce_scatter(
                            shard * mesh.degree(seq_axes), seq_axes)
        elif kind == "moe":
            exp_axes = cfg.axes_for("expert")
            if exp_axes:
                # token dispatch + combine, fwd and bwd: 4 all-to-alls of the
                # local activation bytes.
                local = node.extra.get("token_bytes", node.act_bytes / 4) / max(
                    1, cfg.degree(mesh, dims=("batch", "seq")))
                n_a2a = 4.0 if self.training else 2.0
                total = total + n_a2a * mesh.all_to_all(local, exp_axes)
            ff_axes = cfg.axes_for("d_ff")
            if ff_axes:
                # TP inside experts: the partial-sum tensor is the
                # pre-combine dispatch buffer (B, E, C, D) — top_k x
                # capacity_factor times larger than the layer output.
                # (Charging only the (B,S,D) output under-prices d_ff-TP
                # ~10x for top-8 MoE and mis-steers the search — found via
                # the olmoe dry-run, see EXPERIMENTS §Perf.)
                buf_bytes = node.extra.get(
                    "token_bytes", node.out.bytes) * node.extra.get(
                        "capacity_factor", 1.25)
                local = buf_bytes / max(1, cfg.degree(
                    mesh, dims=("batch", "seq", "expert")))
                n = 2.0 if self.training else 1.0
                total = total + n * mesh.all_reduce(local, ff_axes)
        elif kind == "embed":
            v_axes = cfg.axes_for("vocab")
            if v_axes:
                # vocab-sharded table => masked-gather partial outputs need
                # an all-reduce across the vocab axes (fwd); bwd scatter of
                # grads is local.
                local_out = node.out.bytes / max(1, cfg.degree(
                    mesh, dims=("batch", "seq", "d_model")))
                total = total + mesh.all_reduce(local_out, v_axes)
        elif kind == "lm_head":
            v_axes = cfg.axes_for("vocab")
            if v_axes:
                # vocab-sharded logits: softmax statistics all-reduce
                # (3 fp32 scalars per token) — the cheap part of TP loss.
                tokens = node.out.num_elements / node.out.size("vocab")
                total = total + mesh.all_reduce(tokens * 12.0, v_axes)
        elif kind == "norm":
            m_axes = cfg.axes_for("d_model")
            if m_axes:
                # mean-of-squares partial reduction (1 fp32 per token)
                tokens = node.out.num_elements / node.out.size("d_model")
                total = total + mesh.all_reduce(tokens * 4.0, m_axes)
        elif kind == "cmix":
            # rwkv channel-mix: d_ff-sharded hidden makes the output a
            # partial sum -> all-reduce over the d_ff axes (x2 for bwd).
            ff_axes = cfg.axes_for("d_ff")
            if ff_axes:
                local = node.out.bytes / max(1, cfg.degree(
                    mesh, dims=("batch", "seq")))
                n = 2.0 if self.training else 1.0
                total = total + n * mesh.all_reduce(local, ff_axes)
        elif kind in ("rwkv", "ssm"):
            # channel(head)-sharded recurrence: out-projection rows are
            # sharded -> partial-sum all-reduce of the output.  seq is
            # excluded from parallel_dims (sequential recurrence), so no
            # config can demand cross-device state exchange.
            m_axes = cfg.axes_for("d_model")
            if m_axes:
                local = node.out.bytes / max(1, cfg.degree(
                    mesh, dims=("batch", "seq")))
                n = 2.0 if self.training else 1.0
                total = total + n * mesh.all_reduce(local, m_axes)
        return total

    # ------------------------------------------------------------------ #
    # t_S
    # ------------------------------------------------------------------ #
    def sync_comm(self, node: LayerNode, cfg: LayerConfig) -> CollectiveCost:
        if not self.training or node.param_bytes <= 0:
            return ZERO_COST
        mesh = self.mesh
        shard = node.param_bytes / max(1, cfg.degree(
            mesh, dims=[d for d in cfg.dims if d not in ("batch", "seq")]))
        rep_axes = cfg.replicating_axes(mesh)
        if cfg.fsdp:
            # FSDP: gradients land sharded — reduce-scatter, not all-reduce.
            return mesh.reduce_scatter(shard, rep_axes)
        return mesh.all_reduce(shard, rep_axes)

    def t_s(self, node: LayerNode, cfg: LayerConfig) -> float:
        return self.sync_comm(node, cfg).time

    # ------------------------------------------------------------------ #
    # t_X
    # ------------------------------------------------------------------ #
    def xfer_comm(self, edge: Edge, cfg_src: LayerConfig,
                  cfg_dst: LayerConfig) -> CollectiveCost:
        """Re-layout ``edge.tensor`` from the producer's partition to the
        partition the consumer's config demands for its *input*.

        The consumer's input demand is the projection of its config onto the
        input tensor's dims (paper: devices computing disjoint output subsets
        need the corresponding input subsets; config dims absent from the
        input tensor demand full replication along their axes).
        """
        dims = edge.tensor.dim_names
        src = cfg_src.restrict(dims)
        dst = cfg_dst.restrict(dims)
        key = (edge.tensor, src, dst)
        hit = self._reshard_cache.get(key)
        if hit is None:
            hit = self._reshard(edge.tensor, src, dst)
            self._reshard_cache[key] = hit
        return hit

    def t_x(self, edge: Edge, cfg_src: LayerConfig, cfg_dst: LayerConfig) -> float:
        return self.xfer_comm(edge, cfg_src, cfg_dst).time

    def _reshard(self, tensor: TensorSpec, src: LayerConfig,
                 dst: LayerConfig) -> CollectiveCost:
        if src == dst:
            return ZERO_COST
        mesh = self.mesh

        def roles(cfg: LayerConfig) -> dict[str, str]:
            r: dict[str, str] = {}
            for d, axes in cfg.shards:
                for a in axes:
                    r[a] = d
            return r

        rs, rd = roles(src), roles(dst)
        local = tensor.bytes / max(1, src.degree(mesh))
        t = b = 0.0
        # 1) axes sharded in src but unused in dst: all-gather (grow local).
        for ax in mesh.axes:
            if ax.name in rs and ax.name not in rd and ax.size > 1:
                stage = (ax.size - 1) * local
                alpha, bw = ax.curve("all_gather")
                t += alpha + stage / bw
                b += stage
                local *= ax.size
        # 2) axes whose sharded dim changes: all-to-all at current local size.
        for ax in mesh.axes:
            if (ax.name in rs and ax.name in rd and rs[ax.name] != rd[ax.name]
                    and ax.size > 1):
                stage = (ax.size - 1) / ax.size * local
                alpha, bw = ax.curve("all_to_all")
                t += alpha + stage / bw
                b += stage
        # 3) axes only in dst: a local slice — free.
        return CollectiveCost(t, b)

    # ------------------------------------------------------------------ #
    # vectorized tables for the DP
    # ------------------------------------------------------------------ #
    @staticmethod
    def _hashable(v):
        if isinstance(v, dict):
            return tuple(sorted((k, CostModel._hashable(x))
                                for k, x in v.items()))
        return v

    def node_cost_vector(self, node: LayerNode,
                         configs: list[LayerConfig]) -> np.ndarray:
        key = (node.kind, node.flops, node.param_bytes, node.act_bytes,
               node.out, self._hashable(node.extra), id(configs))
        hit = self._node_vec_cache.get(key)
        if hit is None:
            hit = np.array([self.t_c(node, c) + self.t_s(node, c)
                            for c in configs], dtype=np.float64)
            self._node_vec_cache[key] = hit
        return hit

    def edge_cost_matrix(self, edge: Edge, src_cfgs: list[LayerConfig],
                         dst_cfgs: list[LayerConfig]) -> np.ndarray:
        key = (edge.tensor, id(src_cfgs), id(dst_cfgs))
        hit = self._edge_mat_cache.get(key)
        if hit is None:
            out = np.empty((len(src_cfgs), len(dst_cfgs)), dtype=np.float64)
            for i, ci in enumerate(src_cfgs):
                for j, cj in enumerate(dst_cfgs):
                    out[i, j] = self.t_x(edge, ci, cj)
            self._edge_mat_cache[key] = out
            hit = out
        return hit

    # ------------------------------------------------------------------ #
    # strategy evaluation (paper Eq. 1 / Fig. 8)
    # ------------------------------------------------------------------ #
    def total_time(self, graph: CompGraph, strategy: Strategy) -> float:
        t = 0.0
        for name, node in graph.nodes.items():
            c = strategy[name]
            t += self.t_c(node, c) + self.t_s(node, c)
        for e in graph.iter_edges():
            t += self.t_x(e, strategy[e.src], strategy[e.dst])
        return t

    def comm_bytes(self, graph: CompGraph, strategy: Strategy) -> dict[str, float]:
        """Per-chip bytes moved per step, by category (paper Fig. 8)."""
        sync = xfer = internal = 0.0
        for name, node in graph.nodes.items():
            c = strategy[name]
            sync += self.sync_comm(node, c).bytes
            internal += self.internal_comm(node, c).bytes
        for e in graph.iter_edges():
            xfer += self.xfer_comm(e, strategy[e.src], strategy[e.dst]).bytes
        return {"sync": sync, "xfer": xfer, "internal": internal,
                "total": sync + xfer + internal}


# --------------------------------------------------------------------------- #
# pipeline (inter-op) cost term: prices a stage partition of the layer
# graph under a 1F1B microbatched schedule (extension beyond the paper —
# the stage dimension the two-level search in core/stages.py optimizes)
# --------------------------------------------------------------------------- #
def pipeline_time(stage_costs, interstage_bytes: float, stage_bw: float,
                  microbatches: int, training: bool = True) -> dict:
    """Seconds per step for ``S`` pipeline stages under 1F1B.

    ``stage_costs`` are each stage's intra-op seconds for the *full*
    global batch (what per-stage ``find_strategy`` returns); a microbatch
    costs ``C_s / M``.  1F1B keeps the slowest stage busy for
    ``M + S - 1`` microbatch slots, so

        compute = (M + S - 1) / M * max_s C_s
        bubble_frac = (S - 1) / (S - 1 + M)

    ``interstage_bytes`` is the activation bytes crossing every stage cut
    for the full batch (the tensor bytes the graph records on the cut
    edges); training sends them twice (activations forward, their
    gradients back) over the factored stage axis at ``stage_bw``.
    Transfers are priced serially — no overlap credit, conservative.
    """
    costs = [float(c) for c in stage_costs]
    if not costs:
        raise ValueError("pipeline_time needs at least one stage cost")
    S = len(costs)
    M = max(1, int(microbatches))
    if S == 1:
        return {"total": costs[0], "compute_s": costs[0], "xfer_s": 0.0,
                "bubble_frac": 0.0, "max_stage_s": costs[0],
                "microbatches": M}
    bubble = (S - 1) / (S - 1 + M)
    compute = (M + S - 1) / M * max(costs)
    xfer = (2.0 if training else 1.0) * float(interstage_bytes) / stage_bw
    return {"total": compute + xfer, "compute_s": compute, "xfer_s": xfer,
            "bubble_frac": bubble, "max_stage_s": max(costs),
            "microbatches": M}


# --------------------------------------------------------------------------- #
# per-device memory accounting (extension beyond the paper: the per-chip
# budget makes HBM capacity a binding constraint the search must respect)
# --------------------------------------------------------------------------- #
def node_device_bytes(node: LayerNode, cfg: LayerConfig, mesh: MeshSpec,
                      training: bool) -> float:
    """Persistent per-device bytes this node pins: parameters (+grads +f32
    moments under training, moments always ZeRO-1-sharded over the data
    axes) and the KV cache for decode attention."""
    pdeg = max(1, cfg.param_store_degree(mesh))
    param = node.param_bytes / pdeg
    total = param
    if training:
        total += param                              # grads (same sharding)
        # f32 moments (2x the bf16 param bytes each), always ZeRO-1-sharded
        # over the replicating data axes on top of the param sharding
        zero1 = max(1, mesh.degree(tuple(
            a for a in cfg.replicating_axes(mesh) if a in ("pod", "data"))))
        base_deg = max(1, cfg.degree(
            mesh, dims=[d for d in cfg.dims if d not in ("batch", "seq")]))
        mom_deg = max(pdeg, base_deg * zero1)
        total += 2 * (node.param_bytes * 2) / mom_deg   # m + v
    if node.extra.get("decode") and node.kind in ("attn", "cross_attn"):
        kv = node.extra.get("kv_bytes", 0.0)
        kv_deg = max(1, cfg.degree(mesh, dims=("batch", "seq", "heads")))
        total += kv / kv_deg
    return total


def strategy_device_bytes(graph: CompGraph, strategy: Strategy,
                          mesh: MeshSpec, training: bool,
                          activation_allowance: float = 2.5e9) -> float:
    total = activation_allowance
    for name, node in graph.nodes.items():
        total += node_device_bytes(node, strategy[name], mesh, training)
    return total
