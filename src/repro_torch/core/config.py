"""Parallelization configurations (paper Section 4): the port's copy of
``repro.core.config``.

The paper describes a configuration ``c_i`` of layer ``l_i`` as a positive
integer degree per *parallelizable dimension* of the layer's output tensor,
with the product equal to the number of devices used.  On a named-axis device
mesh the natural (and realizable) equivalent is an assignment of **mesh axes
to logical tensor dimensions**:

    LayerConfig({"batch": ("pod", "data"), "heads": ("model",)})

- the *degree* of a dimension is the product of its mesh-axis sizes;
- a mesh axis assigned to no dimension means the layer's compute is
  **replicated** along that axis — the SPMD analogue of the paper's
  "use fewer devices for this layer" (SPMD has no idle chips);
- each mesh axis may be used by at most one dimension (a valid GSPMD
  sharding).

Logical dimension names used across the framework:

    batch   — sample dimension (paper's ``n``)
    seq     — sequence position (paper's ``h``/``w``/length analogue)
    heads   — attention heads            (channel-like, shards q/k/v/o params)
    d_ff    — MLP hidden                 (channel-like, shards MLP params)
    vocab   — embedding/lm-head rows     (channel-like, shards table)
    expert  — MoE expert                 (new hidden dimension, shards experts)
    d_model — model width                (activation channel; shards norms etc.)
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Iterable, Mapping, Sequence

from .device import MeshSpec

# Dimensions whose sharding partitions *parameters* (=> whose complement
# replicates parameters and therefore incurs gradient-sync cost t_S).
PARAM_DIMS = frozenset({"heads", "d_ff", "vocab", "expert", "d_model"})
# Dimensions that partition *data* (activations only).
DATA_DIMS = frozenset({"batch", "seq"})


@dataclass(frozen=True, order=True)
class LayerConfig:
    """Immutable map: logical dim -> tuple of mesh axis names.

    ``fsdp=True`` (extension beyond the paper, required by a per-chip
    memory budget) stores this layer's parameters sharded across the axes
    that would otherwise replicate them, all-gathering on use (ZeRO-3 /
    fully-sharded data parallelism).  The cost model charges the per-use
    all-gather and credits the cheaper gradient reduce-scatter.
    """

    shards: tuple[tuple[str, tuple[str, ...]], ...] = field(default=())
    fsdp: bool = False

    # -- constructors ---------------------------------------------------- #
    @staticmethod
    def make(mapping: Mapping[str, Sequence[str]] | None = None,
             fsdp: bool = False, **kw: Sequence[str]) -> "LayerConfig":
        items = dict(mapping or {})
        items.update(kw)
        norm = tuple(
            sorted((d, tuple(axes)) for d, axes in items.items() if len(axes) > 0)
        )
        return LayerConfig(shards=norm, fsdp=fsdp)

    def with_fsdp(self, fsdp: bool = True) -> "LayerConfig":
        return LayerConfig(shards=self.shards, fsdp=fsdp)

    REPLICATED: "LayerConfig" = None  # set below

    # -- queries ---------------------------------------------------------- #
    def axes_for(self, dim: str) -> tuple[str, ...]:
        for d, axes in self.shards:
            if d == dim:
                return axes
        return ()

    @property
    def dims(self) -> tuple[str, ...]:
        return tuple(d for d, _ in self.shards)

    def axes_used(self) -> tuple[str, ...]:
        out: list[str] = []
        for _, axes in self.shards:
            out.extend(axes)
        return tuple(out)

    def degree(self, mesh: MeshSpec, dims: Iterable[str] | None = None) -> int:
        """Total degree of parallelism over ``dims`` (default: all dims)."""
        sel = set(dims) if dims is not None else None
        deg = 1
        for d, axes in self.shards:
            if sel is None or d in sel:
                deg *= mesh.degree(axes)
        return deg

    def param_axes(self) -> tuple[str, ...]:
        """Mesh axes that shard parameters under this config."""
        out: list[str] = []
        for d, axes in self.shards:
            if d in PARAM_DIMS:
                out.extend(axes)
        return tuple(out)

    def replicating_axes(self, mesh: MeshSpec) -> tuple[str, ...]:
        """Mesh axes along which this layer's *parameters* are replicated
        (or FSDP-sharded when ``fsdp=True``)."""
        used = set(self.param_axes())
        return tuple(a.name for a in mesh.axes if a.name not in used)

    def param_store_degree(self, mesh: MeshSpec) -> int:
        """Total ways the stored parameters are split per device."""
        deg = self.degree(mesh, dims=[d for d in self.dims
                                      if d in PARAM_DIMS])
        if self.fsdp:
            deg *= mesh.degree(self.replicating_axes(mesh))
        return deg

    def is_valid(self, mesh: MeshSpec,
                 allowed_dims: Iterable[str] | None = None) -> bool:
        axes = self.axes_used()
        if len(set(axes)) != len(axes):
            return False                      # axis reused across dims
        names = set(mesh.axis_names)
        if any(a not in names for a in axes):
            return False
        if allowed_dims is not None:
            allow = set(allowed_dims)
            if any(d not in allow for d in self.dims):
                return False
        return True

    def restrict(self, dims: Iterable[str]) -> "LayerConfig":
        keep = set(dims)
        return LayerConfig(
            shards=tuple((d, a) for d, a in self.shards if d in keep)
        )

    # -- pretty ------------------------------------------------------------ #
    def describe(self, mesh: MeshSpec | None = None) -> str:
        tag = "+fsdp" if self.fsdp else ""
        if not self.shards:
            return "{replicated}" + tag
        parts = []
        for d, axes in self.shards:
            if mesh is not None:
                parts.append(f"{d}={mesh.degree(axes)}({'x'.join(axes)})")
            else:
                parts.append(f"{d}:({','.join(axes)})")
        return "{" + ", ".join(parts) + "}" + tag

    def __repr__(self) -> str:  # noqa: D105
        return f"LayerConfig{self.describe()}"


LayerConfig.REPLICATED = LayerConfig.make({})


def enumerate_configs(mesh: MeshSpec, parallel_dims: Sequence[str],
                      fsdp_variants: bool = False) -> list[LayerConfig]:
    """All valid configs for a layer whose parallelizable dims are given.

    Every mesh axis is independently assigned to one of the parallelizable
    dims or left unused (replication).  This is the paper's full
    configuration space (all degree combinations), expressed over mesh axes.
    With 3 mesh axes and <=5 dims the space is at most 6^3 = 216 configs.
    ``fsdp_variants`` doubles it with FSDP-stored copies (extension).
    """
    choices: list[list[str | None]] = []
    for _axis in mesh.axes:
        choices.append([None, *parallel_dims])
    configs: set[LayerConfig] = set()
    for assignment in itertools.product(*choices):
        mapping: dict[str, list[str]] = {}
        for axis, dim in zip(mesh.axes, assignment):
            if dim is not None:
                mapping.setdefault(dim, []).append(axis.name)
        cfg = LayerConfig.make({d: tuple(a) for d, a in mapping.items()})
        configs.add(cfg)
        if fsdp_variants and cfg.replicating_axes(mesh):
            configs.add(cfg.with_fsdp())
    return sorted(configs)
