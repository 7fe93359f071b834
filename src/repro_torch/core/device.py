"""Device & mesh hardware model: the port's copy of
``repro.core.device``, with an H100 chip model beside the reference's.

The paper models hardware as a *device graph* with per-connection bandwidth
(Section 4).  A homogeneous cluster with named-axis topology collapses that
graph to: a chip spec (peak FLOP/s, HBM bandwidth/capacity) plus a
per-mesh-axis link bandwidth.  The ``pod`` axis crosses the slower
inter-node fabric and carries a discounted bandwidth; the search therefore
learns to keep all-to-all-heavy dimensions off that axis — the paper's
intra-node NVLink vs inter-node Infiniband split, which
:func:`h100_mesh_spec` prices with :data:`NVLINK_BW` and :data:`IB_BW`.

:data:`TPU_V5E` and the ``single_pod`` / ``multi_pod`` mesh functions are the
reference's chip and meshes, kept as they are so that a plan the
reference saved loads here and the parity tests price on the same chip.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

GiB = 1024**3

# ---- analytic hardware constants (one seam per number) -------------------- #
# Every hand-written roofline/topology constant the cost model falls back to
# when no measured device profile overrides it lives here under a name;
# nothing outside this module should restate these literals.

#: Fraction of peak FLOP/s achievable on dense matmuls: the reference's
#: analytic assumption, kept for every chip (no H100 reading; a measured
#: profile replaces it with ``measured_flops / peak_flops``).
DEFAULT_MXU_EFFICIENCY = 0.55
#: Fraction of peak HBM bandwidth achievable on streaming reads: the
#: reference's analytic assumption, kept for every chip (no H100 reading).
DEFAULT_HBM_EFFICIENCY = 0.8

#: The reference's chip model (its roofline constants as it has them).
TPU_V5E_PEAK_FLOPS = 197e12
TPU_V5E_HBM_BW = 819e9
TPU_V5E_HBM_BYTES = 16 * GiB
TPU_V5E_VMEM_BYTES = 128 * 1024**2

ICI_BW = 50e9        # the reference's intra-pod link
POD_BW = 12.5e9      # the reference's inter-pod link

# NVIDIA H100 SXM5 80GB ("NVIDIA H100 80GB HBM3, 700.00 W"): spec-sheet
# figures from NVIDIA's H100 Tensor Core GPU datasheet, none of them a
# measurement (a measured device profile replaces them).
#: dense bf16 tensor-core peak, FLOP/s (the datasheet's 1,979 TFLOP/s is
#: with structured sparsity).
H100_PEAK_FLOPS = 989e12
#: float32 peak outside the tensor cores, FLOP/s: the port computes float32
#: with TF32 off, so a float32 step's roofline divides by this one (the
#: chip spec the cost model prices with keeps the bfloat16 peak).
H100_PEAK_FLOPS_F32 = 67e12
#: HBM3 bandwidth, bytes/s.
H100_HBM_BW = 3.35e12
#: HBM3 capacity, bytes.
H100_HBM_BYTES = 80e9
#: on-chip staging memory: 228 KiB of shared memory / L1 an SM x 132 SMs
#: (no search code reads ``vmem_bytes``; it is filled for completeness).
H100_SMEM_BYTES = 228 * 1024 * 132
#: NVLink 4 within a node: 900 GB/s a GPU both ways, one direction.
NVLINK_BW = 450e9
#: between nodes: one 400 Gb/s NDR InfiniBand port a GPU.
IB_BW = 50e9

#: Collective kinds an axis can carry a measured alpha-beta curve for.
COLLECTIVE_KINDS = ("all_reduce", "reduce_scatter", "all_gather",
                    "all_to_all")


@dataclass(frozen=True)
class ChipSpec:
    """A single accelerator chip (roofline constants)."""

    name: str
    peak_flops: float        # bf16 FLOP/s
    hbm_bw: float            # bytes/s
    hbm_bytes: float         # capacity, bytes
    vmem_bytes: float        # on-chip vector memory, bytes
    # Fraction of peak realistically achievable; calibrated from a measured
    # DeviceProfile via ChipSpec.calibrated(), analytic defaults otherwise.
    mxu_efficiency: float = DEFAULT_MXU_EFFICIENCY
    hbm_efficiency: float = DEFAULT_HBM_EFFICIENCY

    @property
    def eff_flops(self) -> float:
        return self.peak_flops * self.mxu_efficiency

    @property
    def eff_hbm_bw(self) -> float:
        return self.hbm_bw * self.hbm_efficiency

    def calibrated(self, measured_flops: float | None = None,
                   measured_hbm_bw: float | None = None) -> "ChipSpec":
        """A copy whose efficiencies make ``eff_flops`` / ``eff_hbm_bw``
        equal the measured rates; ``None`` keeps the analytic default
        (field-by-field fallback)."""
        kw = {}
        if measured_flops is not None and measured_flops > 0:
            kw["mxu_efficiency"] = float(measured_flops) / self.peak_flops
        if measured_hbm_bw is not None and measured_hbm_bw > 0:
            kw["hbm_efficiency"] = float(measured_hbm_bw) / self.hbm_bw
        return dataclasses.replace(self, **kw) if kw else self


# The reference's chip.
TPU_V5E = ChipSpec(
    name="tpu_v5e",
    peak_flops=TPU_V5E_PEAK_FLOPS,
    hbm_bw=TPU_V5E_HBM_BW,
    hbm_bytes=TPU_V5E_HBM_BYTES,
    vmem_bytes=TPU_V5E_VMEM_BYTES,
)

# NVIDIA H100 SXM5 80GB (spec sheet; see the constants above).
H100_SXM = ChipSpec(
    name="h100_sxm",
    peak_flops=H100_PEAK_FLOPS,
    hbm_bw=H100_HBM_BW,
    hbm_bytes=H100_HBM_BYTES,
    vmem_bytes=H100_SMEM_BYTES,
)


@dataclass(frozen=True)
class CollectiveCost:
    """Cost of one collective: wall seconds and per-chip bytes sent."""

    time: float
    bytes: float

    def __add__(self, other: "CollectiveCost") -> "CollectiveCost":
        return CollectiveCost(self.time + other.time, self.bytes + other.bytes)

    def __mul__(self, k: float) -> "CollectiveCost":
        return CollectiveCost(self.time * k, self.bytes * k)

    __rmul__ = __mul__


ZERO_COST = CollectiveCost(0.0, 0.0)


@dataclass(frozen=True)
class AxisSpec:
    """One named mesh axis: its size and the link bandwidth collectives over
    it see (bytes/s per chip).

    ``curves`` optionally carries measured alpha-beta collective curves as
    ``(kind, alpha_seconds, bw_bytes_per_s)`` triples — one per collective
    kind in :data:`COLLECTIVE_KINDS` — fitted by the profiling microbench
    (``t = alpha + wire_bytes / bw``).  An axis without a curve for a kind
    prices it from the analytic ``bw`` with zero latency, so the default
    (empty) tuple is bit-identical to the uncalibrated model.
    """

    name: str
    size: int
    bw: float  # bytes/s per chip for ring collectives along this axis
    curves: tuple[tuple[str, float, float], ...] = ()

    def curve(self, kind: str) -> tuple[float, float]:
        """``(alpha_seconds, bw_bytes_per_s)`` for one collective kind."""
        for k, alpha, bw in self.curves:
            if k == kind:
                return alpha, bw
        return 0.0, self.bw


@dataclass(frozen=True)
class MeshSpec:
    """Named-axis device mesh + chip roofline constants.

    This is the cost model's entire view of hardware (paper's device graph).
    """

    axes: tuple[AxisSpec, ...]
    chip: ChipSpec = TPU_V5E

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        names = [a.name for a in self.axes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate mesh axis names: {names}")

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(a.name for a in self.axes)

    @property
    def num_devices(self) -> int:
        return math.prod(a.size for a in self.axes)

    def axis(self, name: str) -> AxisSpec:
        for a in self.axes:
            if a.name == name:
                return a
        raise KeyError(f"no mesh axis {name!r} in {self.axis_names}")

    def axis_size(self, name: str) -> int:
        return self.axis(name).size

    def degree(self, axes: tuple[str, ...]) -> int:
        return math.prod(self.axis_size(a) for a in axes)

    # ---- collective primitives (ring algorithms) ---------------------- #
    # Each returns ``CollectiveCost(time, bytes)``: seconds on the slowest
    # participating chip, and per-chip bytes sent over the wire.  Per-axis
    # stages price as ``alpha + wire_bytes / bw`` from the axis's measured
    # curve for that collective kind; the analytic fallback is alpha=0 at
    # the axis's nominal ``bw`` (see AxisSpec.curve).

    def all_reduce(self, bytes_full: float, axes: tuple[str, ...]) -> "CollectiveCost":
        """Ring all-reduce of a ``bytes_full`` buffer over ``axes``.

        Hierarchical: reduce-scatter+all-gather along each axis in turn
        (2*(s-1)/s per stage); after each reduce-scatter stage the live shard
        shrinks by the axis size, matching XLA's hierarchical lowering.
        """
        t = b = 0.0
        live = bytes_full
        for name in axes:
            a = self.axis(name)
            if a.size == 1:
                continue
            stage = 2.0 * (a.size - 1) / a.size * live
            alpha, bw = a.curve("all_reduce")
            t += alpha + stage / bw
            b += stage
            live /= a.size
        return CollectiveCost(t, b)

    def reduce_scatter(self, bytes_full: float, axes: tuple[str, ...]) -> "CollectiveCost":
        t = b = 0.0
        live = bytes_full
        for name in axes:
            a = self.axis(name)
            if a.size == 1:
                continue
            stage = (a.size - 1) / a.size * live
            alpha, bw = a.curve("reduce_scatter")
            t += alpha + stage / bw
            b += stage
            live /= a.size
        return CollectiveCost(t, b)

    def all_gather(self, bytes_shard: float, axes: tuple[str, ...]) -> "CollectiveCost":
        """Gather a per-chip ``bytes_shard`` over ``axes`` (result grows)."""
        t = b = 0.0
        live = bytes_shard
        for name in axes:
            a = self.axis(name)
            if a.size == 1:
                continue
            stage = (a.size - 1) * live
            alpha, bw = a.curve("all_gather")
            t += alpha + stage / bw
            b += stage
            live *= a.size
        return CollectiveCost(t, b)

    def all_to_all(self, bytes_local: float, axes: tuple[str, ...]) -> "CollectiveCost":
        """All-to-all of the per-chip ``bytes_local`` buffer over ``axes``."""
        t = b = 0.0
        for name in axes:
            a = self.axis(name)
            if a.size == 1:
                continue
            stage = (a.size - 1) / a.size * bytes_local
            alpha, bw = a.curve("all_to_all")
            t += alpha + stage / bw
            b += stage
        return CollectiveCost(t, b)

    def min_bw(self, axes: tuple[str, ...]) -> float:
        if not axes:
            return ICI_BW
        return min(self.axis(a).bw for a in axes)

    # ------------------------------------------------------------------ #
    def subspec(self, **sizes: int) -> "MeshSpec":
        """A copy with some axis sizes overridden (for what-if analysis)."""
        new = tuple(
            dataclasses.replace(a, size=sizes.get(a.name, a.size)) for a in self.axes
        )
        return MeshSpec(axes=new, chip=self.chip)


def h100_mesh_spec(nodes: int = 1, data: int = 8, model: int = 1,
                   chip: ChipSpec = H100_SXM) -> MeshSpec:
    """``nodes`` H100 nodes of ``data x model`` GPUs: ``data`` and
    ``model`` on NVLink, and a ``pod`` axis on InfiniBand when
    ``nodes > 1``."""
    pod = (AxisSpec("pod", nodes, IB_BW),) if nodes > 1 else ()
    return MeshSpec(
        axes=pod + (AxisSpec("data", data, NVLINK_BW),
                    AxisSpec("model", model, NVLINK_BW)),
        chip=chip,
    )


def single_pod_mesh_spec(data: int = 16, model: int = 16,
                         chip: ChipSpec = TPU_V5E) -> MeshSpec:
    """The reference's single-pod mesh (default 16 x 16)."""
    return MeshSpec(
        axes=(AxisSpec("data", data, ICI_BW), AxisSpec("model", model, ICI_BW)),
        chip=chip,
    )


def multi_pod_mesh_spec(pods: int = 2, data: int = 16, model: int = 16,
                        chip: ChipSpec = TPU_V5E) -> MeshSpec:
    """The reference's multi-pod mesh (default 2 x 16 x 16)."""
    return MeshSpec(
        axes=(
            AxisSpec("pod", pods, POD_BW),
            AxisSpec("data", data, ICI_BW),
            AxisSpec("model", model, ICI_BW),
        ),
        chip=chip,
    )
