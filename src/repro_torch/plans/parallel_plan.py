"""ParallelPlan: the searched, serializable strategy artifact (the port's
copy of ``repro.plans.parallel_plan``; the schema is the reference's, so a
plan saved by either package loads in the other).

The paper's thesis is that different *layers* prefer different
parallelization configs; serving exposes a second hidden dimension —
different *phases* of the same layer prefer different configs, because a
decode step is a batch=``max_batch`` single-token ragged batch while
prefill is a batch-1 long sequence and training a large dense batch.  A
:class:`ParallelPlan` packages one :class:`~repro_torch.models.plan.ModelPlan`
per phase (``train`` / ``prefill`` / ``decode``) together with the mesh
it was searched for and provenance metadata, and round-trips through a
versioned JSON schema so a plan can outlive the process that searched it
(``plan.save(path)`` / ``ParallelPlan.load(path, arch=arch)``) — the
strategy analogue of the persisted autotune cache.

Loading refuses loudly on a corrupt file, a schema-version mismatch, or
an architecture mismatch (a plan realized against the wrong arch would
silently mis-shard or crash at realization).

The chip registry holds the reference's chip and the H100, and a plan
naming any other chip is refused (the reference falls back to its own
chip).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from dataclasses import dataclass, field
from pathlib import Path

from repro_torch.core.config import LayerConfig
from repro_torch.core.device import (H100_SXM, ICI_BW, TPU_V5E, AxisSpec,
                                     MeshSpec)
from repro_torch.core.stages import StageAssignment, single_stage
from repro_torch.models.arch import ArchConfig
from repro_torch.models.plan import ModelPlan, Segment, uniform_plan

SCHEMA = "repro.parallel_plan"
# v2 adds the per-phase ``stages`` dict (pipeline stage assignments);
# v1 files load with every phase defaulting to a single stage.
SCHEMA_VERSION = 2
_READABLE_VERSIONS = (1, 2)

#: The phase axis: one ModelPlan per entry a plan may carry.
PHASES = ("train", "prefill", "decode")

# When a plan lacks the requested phase, fall back to the nearest
# workload: prefill is compute-shaped like train (long dense sequences);
# decode prefers prefill's inference pricing over train's.
_FALLBACK = {
    "train": ("prefill", "decode"),
    "prefill": ("train", "decode"),
    "decode": ("prefill", "train"),
}

_CHIPS = {c.name: c for c in (TPU_V5E, H100_SXM)}


class PlanError(ValueError):
    """Base class for plan (de)serialization failures."""


class PlanFormatError(PlanError):
    """The file is not a readable ParallelPlan (corrupt JSON, wrong
    schema tag, or an unsupported schema version)."""


class PlanArchMismatchError(PlanError):
    """The plan was searched for a different architecture."""


# --------------------------------------------------------------------------- #
# arch fingerprint: every ArchConfig field that determines a plan's
# structure (sublayer keys, segment/unit counts) or realizability
# (sharded-dim divisibility).
# --------------------------------------------------------------------------- #
_FINGERPRINT_FIELDS = (
    "name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
    "d_ff", "vocab", "head_dim", "n_experts", "top_k", "moe_d_ff",
    "rwkv_head_size", "ssm_state", "ssm_expand", "ssm_conv", "enc_layers",
    "tie_embeddings", "frontend", "frontend_tokens",
)


def arch_fingerprint(arch: ArchConfig) -> dict:
    fp = {f: getattr(arch, f) for f in _FINGERPRINT_FIELDS}
    fp["pattern"] = [[s.mixer, s.ffn] for s in arch.pattern]
    return fp


# --------------------------------------------------------------------------- #
# JSON codecs for the plan building blocks
# --------------------------------------------------------------------------- #
def _cfg_to_json(cfg: LayerConfig) -> dict:
    return {"shards": [[d, list(axes)] for d, axes in cfg.shards],
            "fsdp": cfg.fsdp}


def _cfg_from_json(d: dict) -> LayerConfig:
    return LayerConfig.make({dim: tuple(axes) for dim, axes in d["shards"]},
                            fsdp=bool(d.get("fsdp", False)))


def _segment_to_json(seg: Segment) -> dict:
    return {"start": seg.start, "end": seg.end,
            "plan": [{k: _cfg_to_json(c) for k, c in layer.items()}
                     for layer in seg.plan]}


def _segment_from_json(d: dict) -> Segment:
    plan = tuple({k: _cfg_from_json(c) for k, c in layer.items()}
                 for layer in d["plan"])
    return Segment(int(d["start"]), int(d["end"]), plan)


def model_plan_to_json(plan: ModelPlan) -> dict:
    return {
        "embed": _cfg_to_json(plan.embed),
        "final_norm": _cfg_to_json(plan.final_norm),
        "lm_head": _cfg_to_json(plan.lm_head),
        "segments": [_segment_to_json(s) for s in plan.segments],
        "enc_embed": _cfg_to_json(plan.enc_embed),
        "enc_segments": [_segment_to_json(s) for s in plan.enc_segments],
    }


def model_plan_from_json(d: dict) -> ModelPlan:
    return ModelPlan(
        embed=_cfg_from_json(d["embed"]),
        final_norm=_cfg_from_json(d["final_norm"]),
        lm_head=_cfg_from_json(d["lm_head"]),
        segments=tuple(_segment_from_json(s) for s in d["segments"]),
        enc_embed=_cfg_from_json(d["enc_embed"]),
        enc_segments=tuple(_segment_from_json(s) for s in d["enc_segments"]),
    )


def _stages_to_json(st: StageAssignment) -> dict:
    return {"boundaries": list(st.boundaries),
            "microbatches": st.microbatches,
            "mesh_axis": st.mesh_axis}


def _stages_from_json(d: dict) -> StageAssignment:
    return StageAssignment(boundaries=tuple(int(b) for b in d["boundaries"]),
                           microbatches=int(d.get("microbatches", 1)),
                           mesh_axis=str(d.get("mesh_axis", "stage")))


def _mesh_to_json(mesh: MeshSpec | None) -> dict | None:
    if mesh is None:
        return None
    out = {"chip": mesh.chip.name,
           "axes": [{"name": a.name, "size": a.size, "bw": a.bw,
                     **({"curves": [list(c) for c in a.curves]}
                        if a.curves else {})}
                    for a in mesh.axes]}
    # a profile-calibrated chip differs from the registry entry only in
    # its efficiencies; persist them so a loaded plan re-prices the same
    base = _CHIPS.get(mesh.chip.name)
    if base is not None and (mesh.chip.mxu_efficiency != base.mxu_efficiency
                             or mesh.chip.hbm_efficiency
                             != base.hbm_efficiency):
        out["chip_efficiencies"] = {"mxu": mesh.chip.mxu_efficiency,
                                    "hbm": mesh.chip.hbm_efficiency}
    return out


def _mesh_from_json(d: dict | None) -> MeshSpec | None:
    if d is None:
        return None
    axes = tuple(
        AxisSpec(a["name"], int(a["size"]), float(a.get("bw", ICI_BW)),
                 curves=tuple((str(k), float(al), float(bw))
                              for k, al, bw in a.get("curves", ())))
        for a in d["axes"])
    chip = _CHIPS.get(d.get("chip"))
    if chip is None:
        raise PlanFormatError(
            f"plan names chip {d.get('chip')!r}, which this build does not "
            f"know (known: {sorted(_CHIPS)})")
    eff = d.get("chip_efficiencies")
    if eff:
        chip = dataclasses.replace(chip,
                                   mxu_efficiency=float(eff["mxu"]),
                                   hbm_efficiency=float(eff["hbm"]))
    return MeshSpec(axes=axes, chip=chip)


# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ParallelPlan:
    """Per-phase ModelPlans + the mesh they were searched for + provenance.

    ``phases`` maps phase name -> :class:`ModelPlan`; ``meta`` carries
    provenance (strategy name, per-phase search cost/seconds/shape,
    creator versions) and is round-tripped verbatim.
    """

    arch: dict                       # arch_fingerprint() of the target arch
    phases: dict[str, ModelPlan]
    mesh: MeshSpec | None = None
    meta: dict = field(default_factory=dict)
    #: phase name -> pipeline StageAssignment; absent phases are single-stage.
    stages: dict[str, StageAssignment] = field(default_factory=dict)

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        for ph in self.phases:
            if ph not in PHASES:
                raise PlanError(f"unknown phase {ph!r}; expected one of {PHASES}")
        if not self.phases:
            raise PlanError("a ParallelPlan needs at least one phase")
        for ph, st in self.stages.items():
            if ph not in PHASES:
                raise PlanError(
                    f"unknown stage phase {ph!r}; expected one of {PHASES}")
            if not isinstance(st, StageAssignment):
                raise PlanError(
                    f"stages[{ph!r}] must be a StageAssignment, "
                    f"got {type(st).__name__}")

    def resolved_phase(self, phase: str) -> str:
        """The carried phase ``plan_for(phase)`` resolves to — ``phase``
        itself, or its nearest fallback (see ``_FALLBACK``).  Callers
        that care about substitution (a train run handed a serve-only
        plan executes under the prefill config) compare this to
        ``phase`` and warn."""
        if phase not in PHASES:
            raise KeyError(f"unknown phase {phase!r}; expected one of {PHASES}")
        if phase in self.phases:
            return phase
        for alt in _FALLBACK[phase]:
            if alt in self.phases:
                return alt
        raise KeyError(phase)        # unreachable: phases is non-empty

    def plan_for(self, phase: str) -> ModelPlan:
        """The ModelPlan for ``phase``, falling back to the nearest
        phase the plan carries (see ``_FALLBACK``)."""
        return self.phases[self.resolved_phase(phase)]

    def stage_for(self, phase: str) -> StageAssignment:
        """The pipeline stage assignment for ``phase`` (resolved through
        the same fallback chain as ``plan_for``); phases the plan carries
        no assignment for are single-stage."""
        resolved = self.resolved_phase(phase)
        if resolved in self.stages:
            return self.stages[resolved]
        n_layers = int(self.arch.get("n_layers") or 1)
        period = len(self.arch.get("pattern") or ()) or 1
        return single_stage(max(1, n_layers // period))

    @property
    def strategy_name(self) -> str:
        return self.meta.get("strategy", "unknown")

    def describe(self) -> str:
        lines = [f"ParallelPlan[{self.strategy_name}] "
                 f"arch={self.arch.get('name')} "
                 f"mesh={'x'.join(str(a.size) for a in self.mesh.axes) if self.mesh else 'none'}"]
        for ph in PHASES:
            if ph in self.phases:
                lines.append(f"-- {ph} --")
                if ph in self.stages and self.stages[ph].num_stages > 1:
                    lines.append(f"pipeline: {self.stages[ph].describe()}")
                lines.append(self.phases[ph].describe())
        return "\n".join(lines)

    # ------------------------------------------------------------------ #
    @staticmethod
    def uniform(arch: ArchConfig, phases=PHASES,
                mesh: MeshSpec | None = None,
                data_axes: tuple[str, ...] = ("data",)) -> "ParallelPlan":
        """The single-config baseline plan (batch over ``data_axes``) for
        every requested phase."""
        plan = uniform_plan(arch, data_axes=data_axes)
        return ParallelPlan(arch=arch_fingerprint(arch),
                            phases={ph: plan for ph in phases},
                            mesh=mesh, meta={"strategy": "uniform"})

    # ------------------------------------------------------------------ #
    def to_json(self) -> dict:
        return {
            "schema": SCHEMA,
            "version": SCHEMA_VERSION,
            "arch": self.arch,
            "mesh": _mesh_to_json(self.mesh),
            "phases": {ph: model_plan_to_json(p)
                       for ph, p in self.phases.items()},
            "stages": {ph: _stages_to_json(st)
                       for ph, st in self.stages.items()},
            "meta": self.meta,
        }

    def save(self, path) -> Path:
        """Atomic write (tmp + rename), like the autotune cache."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = json.dumps(self.to_json(), indent=1)
        fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(payload)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return path

    @classmethod
    def from_json(cls, data, arch: ArchConfig | None = None) -> "ParallelPlan":
        if not isinstance(data, dict):
            raise PlanFormatError(
                f"plan payload must be a JSON object, got {type(data).__name__}")
        if data.get("schema") != SCHEMA:
            raise PlanFormatError(
                f"not a ParallelPlan file (schema={data.get('schema')!r})")
        if data.get("version") not in _READABLE_VERSIONS:
            raise PlanFormatError(
                f"unsupported plan schema version {data.get('version')!r} "
                f"(this build reads versions {_READABLE_VERSIONS})")
        try:
            # PlanError (e.g. an unknown phase key) is a ValueError and is
            # wrapped below too: anything wrong inside a *file* is a
            # format error by contract.  v1 files predate pipeline stages:
            # every phase defaults to a single stage (stages={}).
            plan = cls(
                arch=dict(data["arch"]),
                phases={ph: model_plan_from_json(p)
                        for ph, p in data["phases"].items()},
                mesh=_mesh_from_json(data.get("mesh")),
                meta=dict(data.get("meta", {})),
                stages={ph: _stages_from_json(st)
                        for ph, st in data.get("stages", {}).items()},
            )
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            raise PlanFormatError(f"malformed plan payload: {e!r}") from e
        if arch is not None:
            plan.check_arch(arch)
        return plan

    @classmethod
    def load(cls, path, arch: ArchConfig | None = None) -> "ParallelPlan":
        """Read a plan; pass ``arch`` to refuse arch-mismatched plans."""
        try:
            data = json.loads(Path(path).read_text())
        except (OSError, json.JSONDecodeError) as e:
            raise PlanFormatError(f"cannot read plan {path}: {e}") from e
        return cls.from_json(data, arch=arch)

    def check_arch(self, arch: ArchConfig) -> None:
        want = arch_fingerprint(arch)
        diffs = [f"{k}: plan={self.arch.get(k)!r} arch={want[k]!r}"
                 for k in want if self.arch.get(k) != want[k]]
        if diffs:
            raise PlanArchMismatchError(
                f"plan was searched for a different architecture "
                f"({self.arch.get('name')!r} vs {arch.name!r}): "
                + "; ".join(diffs))


def as_model_plan(plan, arch: ArchConfig, phase: str) -> ModelPlan:
    """Normalize the plan argument every executor takes: a
    :class:`ParallelPlan` (phase-resolved), a bare :class:`ModelPlan`
    (used for every phase — the pre-phase API), or ``None`` (uniform)."""
    if plan is None:
        return uniform_plan(arch)
    if isinstance(plan, ParallelPlan):
        plan.check_arch(arch)
        return plan.plan_for(phase)
    if isinstance(plan, ModelPlan):
        return plan
    raise TypeError(
        f"expected ParallelPlan | ModelPlan | None, got {type(plan).__name__}")
