"""Phase-aware plan search: one searched ParallelPlan for train, prefill
and decode (the port's copy of ``repro.plans.search``).

Each phase prices a *different* computation graph of the same model:

* ``train``   — the dense global batch, fwd+bwd FLOPs, gradient sync t_S;
* ``prefill`` — a batch-1 long sequence (one admitted request), fwd only;
* ``decode``  — a single-token ragged batch over ``max_batch`` cache
  slots against a ``max_len`` KV cache, fwd only, no t_S — the dominant
  tensor is the cache read, so the search trades head/channel sharding
  against the tiny batch instead of defaulting to data parallelism.

``build_parallel_plan`` searches (or applies a named baseline to) each
requested phase's graph and packages the results with provenance into a
:class:`~repro_torch.plans.parallel_plan.ParallelPlan`.

The plan's meta records ``torch.__version__`` where the reference's
records JAX's, and a measured device profile (``profile_path``) is not
ported yet: it arrives with the H100 profiling slice.
"""

from __future__ import annotations

from repro_torch.core.device import MeshSpec
from repro_torch.core.search import SearchOptions, find_strategy
from repro_torch.core.stages import StageAssignment, find_staged_strategy
from repro_torch.core.strategies import BASELINES
from repro_torch.models.arch import ArchConfig
from repro_torch.models.graph_export import export_graph, phase_shape
from repro_torch.models.plan import ModelPlan, strategy_to_plan, uniform_plan

from .parallel_plan import PHASES, ParallelPlan, arch_fingerprint

#: Strategy names the commands accept (symmetric across train & serve).
STRATEGIES = ("uniform", "data", "model", "owt", "searched")


def search_phase_plan(arch: ArchConfig, mesh: MeshSpec, phase: str, *,
                      seq_len: int, batch: int,
                      kv_tokens: int | None = None,
                      q_tokens: int | None = None,
                      kv_quant: str | None = None,
                      num_stages: int = 0, microbatches: int = 8,
                      options: SearchOptions | None = None,
                      profile=None,
                      ) -> tuple[ModelPlan, StageAssignment | None, dict]:
    """Search one phase; returns (realized plan, stage assignment or
    ``None`` when the phase is unstaged, provenance dict).
    ``kv_tokens`` prices the decode phase's cache read at the paged
    engine's allocated-blocks depth; ``q_tokens`` prices the mixed step's
    per-slot query width; ``kv_quant`` prices it at the pool's stored
    byte width (see :func:`phase_shape`).  ``num_stages``
    routes the phase through the two-level pipeline search
    (:func:`~repro_torch.core.stages.find_staged_strategy`): >1 forces that
    stage count, <0 auto-searches up to ``options.max_stages``; 0/1 keep
    today's single-level search bit-for-bit.  ``profile`` (a measured
    device profile, the reference's ``repro.profiling.DeviceProfile``
    surface) calibrates the cost model
    the search prices against; the provenance records its fingerprint."""
    shape = phase_shape(phase, seq_len=seq_len, batch=batch,
                        kv_tokens=kv_tokens, q_tokens=q_tokens,
                        kv_quant=kv_quant)
    graph = export_graph(arch, shape)
    opts = options or SearchOptions()
    # auto mode: sweep up to options.max_stages when set, else every
    # feasible contiguous cut of the unit stack
    auto_max = ((opts.max_stages if opts.max_stages > 1 else arch.n_units)
                if num_stages < 0 else 0)
    if num_stages > 1 or auto_max > 1:
        staged = find_staged_strategy(
            graph, mesh, n_units=arch.n_units, phase=phase, options=options,
            num_stages=num_stages if num_stages > 1 else None,
            max_stages=auto_max if auto_max > 1 else None,
            microbatches=microbatches, profile=profile)
        strat, stages = staged.strategy, staged.stages
        pipe = staged.meta.get("pipeline", {})
        prov = {
            "phase": phase,
            "shape": {"seq_len": shape.seq_len, "batch": shape.global_batch,
                      "kind": shape.kind, "q_tokens": shape.q_tokens,
                      "kv_quant": shape.kv_quant},
            "cost_s": staged.cost,
            "search_seconds": staged.meta.get("stage_search_seconds"),
            "stage_count": stages.num_stages,
            "pipeline_bubble_frac": staged.bubble_frac,
            "interstage_bytes": staged.interstage_bytes,
            "stage_search_seconds": staged.meta.get("stage_search_seconds"),
            "stage_costs_s": list(staged.stage_costs),
            "pipeline_xfer_s": pipe.get("xfer_s"),
        }
        if profile is not None:
            prov["device_profile"] = profile.fingerprint()
        return strategy_to_plan(strat, arch), stages, prov
    strat = find_strategy(graph, mesh, phase=phase, options=options,
                          profile=profile)
    prov = {
        "phase": phase,
        "shape": {"seq_len": shape.seq_len, "batch": shape.global_batch,
                  "kind": shape.kind, "q_tokens": shape.q_tokens,
                      "kv_quant": shape.kv_quant},
        "cost_s": strat.cost,
        "search_seconds": strat.meta.get("search_seconds"),
    }
    if profile is not None:
        prov["device_profile"] = profile.fingerprint()
    return strategy_to_plan(strat, arch), None, prov


def baseline_phase_plan(arch: ArchConfig, mesh: MeshSpec, phase: str,
                        strategy: str, *, seq_len: int, batch: int,
                        kv_tokens: int | None = None,
                        q_tokens: int | None = None,
                        kv_quant: str | None = None,
                        ) -> tuple[ModelPlan, dict]:
    """Apply a named baseline (data/model/owt) to one phase's graph."""
    shape = phase_shape(phase, seq_len=seq_len, batch=batch,
                        kv_tokens=kv_tokens, q_tokens=q_tokens,
                        kv_quant=kv_quant)
    graph = export_graph(arch, shape)
    strat = BASELINES[strategy](graph, mesh)
    prov = {"phase": phase,
            "shape": {"seq_len": shape.seq_len, "batch": shape.global_batch,
                      "kind": shape.kind, "q_tokens": shape.q_tokens,
                      "kv_quant": shape.kv_quant}}
    return strategy_to_plan(strat, arch), prov


def build_parallel_plan(arch: ArchConfig, mesh: MeshSpec | None, *,
                        strategy: str = "searched",
                        phases=PHASES,
                        train_seq: int = 4096, train_batch: int = 256,
                        prompt_len: int = 512,
                        max_batch: int = 8, max_len: int | None = None,
                        decode_kv_tokens: int | None = None,
                        decode_q_tokens: int | None = None,
                        decode_kv_quant: str | None = None,
                        train_stages: int = 0,
                        train_microbatches: int = 8,
                        options: SearchOptions | None = None,
                        profile=None) -> ParallelPlan:
    """Build a ParallelPlan for ``phases`` under one named strategy.

    Phase shapes: train prices ``(train_batch, train_seq)``; prefill a
    batch-1 ``prompt_len`` sequence; decode a ``max_batch``-slot
    single-token batch against a ``max_len`` cache (default
    ``prompt_len`` when unset) — or, when ``decode_kv_tokens`` is given
    (the paged engine's per-slot allocated-block budget), against that
    real depth instead of the ``max_len`` reservation.
    ``decode_q_tokens`` (>1) prices decode as the *mixed* step of a
    chunked-prefill engine: each slot amortizes its share of the
    per-step prefill chunk budget, so the matmul terms grow while the
    cache read stays put — the plan the search returns reflects that
    trade.  ``decode_kv_quant`` ("int8") prices the decode cache read at
    the quantized pool's stored width (and is recorded in the plan's
    meta, so a loaded plan declares which pool it was searched for).
    ``mesh=None`` (single device) degrades to the uniform plan
    regardless of ``strategy``.

    ``train_stages`` routes the train phase through the two-level
    pipeline search (>1 forces that stage count, <0 auto-searches up to
    ``options.max_stages``); serve phases stay single-stage — token-level
    decode pipelining is a named follow-up.  Requires
    ``strategy="searched"``.

    ``profile`` — a measured device profile — calibrates every searched
    phase's cost model; the plan's meta records the profile fingerprint
    so a loaded plan declares which hardware measurement shaped it.
    Baselines ignore it (their configs are not cost-driven).
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; "
                         f"expected one of {STRATEGIES}")
    unknown = [p for p in phases if p not in PHASES]
    if unknown:
        raise ValueError(f"unknown phases {unknown}; expected from {PHASES}")
    if train_stages not in (0, 1) and strategy != "searched":
        raise ValueError(
            f"train_stages={train_stages} needs strategy='searched' "
            f"(got {strategy!r}); baselines are single-stage")
    if mesh is None or strategy == "uniform":
        return ParallelPlan.uniform(arch, phases=tuple(phases), mesh=mesh)
    if profile is not None and strategy == "searched":
        # store (and search under) the calibrated mesh, so the plan JSON
        # round-trips the measured curves and chip efficiencies
        mesh = profile.calibrate_mesh(mesh)

    shapes = {
        "train": (train_seq, train_batch),
        "prefill": (prompt_len, 1),
        "decode": (max_len or prompt_len, max_batch),
    }
    plans: dict[str, ModelPlan] = {}
    stages: dict[str, "StageAssignment"] = {}
    phase_meta: dict[str, dict] = {}
    for phase in phases:
        seq_len, batch = shapes[phase]
        kv = decode_kv_tokens if phase == "decode" else None
        qt = decode_q_tokens if phase == "decode" else None
        kvq = decode_kv_quant if phase == "decode" else None
        if strategy == "searched":
            ns = train_stages if phase == "train" else 0
            plans[phase], st, phase_meta[phase] = search_phase_plan(
                arch, mesh, phase, seq_len=seq_len, batch=batch,
                kv_tokens=kv, q_tokens=qt, kv_quant=kvq, options=options,
                num_stages=ns, microbatches=train_microbatches,
                profile=profile)
            if st is not None and st.num_stages > 1:
                stages[phase] = st
        else:
            plans[phase], phase_meta[phase] = baseline_phase_plan(
                arch, mesh, phase, strategy, seq_len=seq_len, batch=batch,
                kv_tokens=kv, q_tokens=qt, kv_quant=kvq)
    import torch

    meta = {"strategy": strategy, "phases": phase_meta,
            "torch": torch.__version__}
    if decode_kv_quant and decode_kv_quant != "none":
        meta["kv_quant"] = decode_kv_quant
    if profile is not None and strategy == "searched":
        meta["device_profile"] = profile.fingerprint()
    return ParallelPlan(
        arch=arch_fingerprint(arch), phases=plans, mesh=mesh,
        stages=stages, meta=meta)


def resolve_plan(arch: ArchConfig, mesh: MeshSpec | None, *,
                 phases=PHASES, plan_path: str = "",
                 strategy: str = "uniform", save_plan: str = "",
                 train_seq: int = 4096, train_batch: int = 256,
                 prompt_len: int = 512, max_batch: int = 8,
                 max_len: int | None = None,
                 decode_kv_tokens: int | None = None,
                 decode_q_tokens: int | None = None,
                 decode_kv_quant: str | None = None,
                 train_stages: int = 0,
                 train_microbatches: int = 8,
                 options: SearchOptions | None = None,
                 profile_path: str = "",
                 log=print) -> ParallelPlan:
    """The plan tri-logic every command shares: ``plan_path`` (load,
    arch-checked) beats ``strategy`` (build the requested ``phases``);
    ``save_plan`` persists the result either way.

    Surprises are announced rather than silent: a loaded plan missing a
    requested phase names the substitute it will execute under, and a
    non-uniform ``strategy`` on a single device (``mesh=None``) reports
    the degrade to uniform — the saved file's meta records what was
    actually built, so downstream ``--plan`` runs see the truth.

    ``profile_path`` (the commands' ``--device-profile``) would load a
    measured device profile to calibrate the searched cost model; the
    port has no profiler yet, so it raises, naming the slice that brings
    one.
    """
    profile = None
    if profile_path:
        raise NotImplementedError(
            f"a device profile ({profile_path}) is not ported yet: it "
            f"arrives with the H100 profiling slice (ROADMAP.md A8)")
    if plan_path:
        plan = ParallelPlan.load(plan_path, arch=arch)
        log(f"plan: loaded [{plan.strategy_name}] from {plan_path}")
        for phase in phases:
            got = plan.resolved_phase(phase)
            if got != phase:
                log(f"plan: note — no {phase!r} phase in {plan_path}; "
                    f"executing {phase} under its {got!r} plan")
        def axes(m):
            return [(a.name, a.size) for a in m.axes] if m else None
        if plan.mesh is not None and axes(plan.mesh) != axes(mesh):
            log(f"plan: note — plan searched for mesh {axes(plan.mesh)} "
                f"but this host runs {axes(mesh)}; non-dividing axes "
                f"drop to replication at realization")
        for phase in phases:
            st = plan.stage_for(phase)
            if st.num_stages > 1:
                log(f"plan: {phase} is pipeline-staged "
                    f"(S={st.num_stages}, M={st.microbatches})")
        plan_kvq = plan.meta.get("kv_quant")
        want_kvq = (decode_kv_quant
                    if decode_kv_quant not in (None, "none") else None)
        if plan_kvq != want_kvq:
            log(f"plan: note — loaded plan was searched for "
                f"kv_quant={plan_kvq!r} but this run serves "
                f"kv_quant={want_kvq!r}; the decode cost model saw a "
                f"different cache-read width")
        if profile is not None:
            searched_under = plan.meta.get("device_profile")
            if searched_under is None:
                log("plan: note — loaded plan was searched without a "
                    "device profile; --device-profile only affects newly "
                    "built plans")
            elif searched_under.get("device_kind") != profile.device_kind:
                log(f"plan: note — loaded plan was searched under a "
                    f"{searched_under.get('device_kind')!r} profile but "
                    f"this one measures {profile.device_kind!r}")
    else:
        if mesh is None and strategy != "uniform":
            log(f"plan: single device — strategy {strategy!r} degrades "
                f"to uniform (the saved plan records 'uniform')")
        plan = build_parallel_plan(
            arch, mesh, strategy=strategy, phases=phases,
            train_seq=train_seq, train_batch=train_batch,
            prompt_len=prompt_len, max_batch=max_batch, max_len=max_len,
            decode_kv_tokens=decode_kv_tokens,
            decode_q_tokens=decode_q_tokens,
            decode_kv_quant=decode_kv_quant,
            train_stages=train_stages,
            train_microbatches=train_microbatches, options=options,
            profile=profile)
        for phase, pm in plan.meta.get("phases", {}).items():
            cost = pm.get("cost_s")
            if cost is not None:
                log(f"plan: {phase} cost model {cost:.6f}s/step")
            if pm.get("stage_count", 1) > 1:
                log(f"plan: {phase} pipeline S={pm['stage_count']} "
                    f"M={plan.stage_for(phase).microbatches} "
                    f"bubble={pm['pipeline_bubble_frac']:.3f} "
                    f"interstage={pm['interstage_bytes']:.0f}B")
    if save_plan:
        plan.save(save_plan)
        log(f"plan: wrote {save_plan}")
    return plan
