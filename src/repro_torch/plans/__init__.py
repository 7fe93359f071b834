"""Phase-aware parallel plans of the port: search -> save -> load.

The port's copy of ``repro.plans``.  A
:class:`~repro_torch.plans.parallel_plan.ParallelPlan` carries one
:class:`~repro_torch.models.plan.ModelPlan` per phase (``train`` /
``prefill`` / ``decode``), the mesh it was searched for and provenance
metadata, and round-trips through the reference's versioned JSON schema.
``make_train_step``, ``make_serve_fns`` and the ``ServeEngine`` take it;
on one device they place nothing by it.  The sharding realization
(``param_pspecs`` & friends) comes with the realization slice.
"""

from .parallel_plan import (
    PHASES,
    SCHEMA_VERSION,
    ParallelPlan,
    PlanArchMismatchError,
    PlanError,
    PlanFormatError,
    arch_fingerprint,
    as_model_plan,
    model_plan_from_json,
    model_plan_to_json,
)
from .search import (
    STRATEGIES,
    baseline_phase_plan,
    build_parallel_plan,
    resolve_plan,
    search_phase_plan,
)

__all__ = [
    "PHASES", "SCHEMA_VERSION", "STRATEGIES", "ParallelPlan",
    "PlanArchMismatchError", "PlanError", "PlanFormatError",
    "arch_fingerprint", "as_model_plan", "baseline_phase_plan",
    "build_parallel_plan", "model_plan_from_json", "model_plan_to_json",
    "resolve_plan", "search_phase_plan",
]
