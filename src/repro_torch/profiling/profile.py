"""Versioned ``DeviceProfile``: measured hardware truth for the cost model
(the port's copy of ``repro.profiling.profile``).

The paper's execution simulator is built on *measured* per-layer times and
per-connection bandwidths (Section 4); this module is the persisted form of
those measurements for our mesh.  A profile carries three field groups, each
independently optional so calibration falls back to the analytic constants
in :mod:`repro.core.device` field-by-field:

* **chip** — measured dense-matmul FLOP/s and HBM stream bandwidth
  (``ChipSpec.calibrated`` turns them into effective efficiencies);
* **collectives** — per-(mesh axis, collective kind) alpha-beta curves
  ``t = alpha + wire_bytes / bw`` fitted from a message-size ladder;
* **kernels** — per-(op, backend) measured time factors relative to the
  fastest backend for that op (the measured replacement for the analytic
  kernel cost hooks in :mod:`repro.core.cost_model`).

Persistence mirrors the other two on-disk artifacts (ParallelPlan JSON and
the autotune cache): a schema tag + version with explicit refusal on
mismatch or corruption, atomic tmp-file + ``os.replace`` writes, a default
location keyed by device kind, and provenance metadata recording what
measured the numbers.

The JSON is the reference's, field for field: a profile either package
writes loads in the other.  Departures: the fingerprint adds the torch
version (``"torch"``) where the profile's meta records one, so a profile
the reference wrote fingerprints as it does there; and the default
profile directory is the checkout's ``build/profiles`` (beside the
built kernels) instead of the home directory.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from dataclasses import dataclass, field
from pathlib import Path

from repro_torch.core.device import COLLECTIVE_KINDS, MeshSpec
from repro_torch.kernels.build import BUILD

SCHEMA = "repro.device_profile"
SCHEMA_VERSION = 1
_READABLE_VERSIONS = (1,)

ENV_PROFILE_DIR = "REPRO_PROFILE_DIR"


class ProfileError(Exception):
    """Base class for device-profile failures."""


class ProfileFormatError(ProfileError):
    """The file is not a readable device profile (corrupt JSON, wrong
    schema tag, or a version this build cannot read)."""


@dataclass(frozen=True)
class CollectiveCurve:
    """One fitted alpha-beta curve: ``t(wire_bytes) = alpha + wire/bw``.

    ``sizes``/``times`` keep the raw ladder the fit came from so a loaded
    profile can be re-fit or inspected without re-measuring.
    """

    kind: str                 # one of COLLECTIVE_KINDS
    alpha: float              # latency, seconds
    bw: float                 # bytes/s
    sizes: tuple[float, ...] = ()   # wire bytes per ladder rung
    times: tuple[float, ...] = ()   # measured seconds per rung

    def __post_init__(self):
        if self.kind not in COLLECTIVE_KINDS:
            raise ValueError(f"unknown collective kind {self.kind!r}")
        if not (self.bw > 0):
            raise ValueError(f"fitted bandwidth must be positive, got {self.bw}")

    def predict(self, wire_bytes: float) -> float:
        return self.alpha + wire_bytes / self.bw


def fit_alpha_beta(sizes, times) -> tuple[float, float]:
    """Least-squares fit of ``t = alpha + s / bw`` -> ``(alpha, bw)``.

    ``sizes`` are wire bytes, ``times`` seconds.  The fit is over the
    inverse-bandwidth slope ``beta = 1/bw``; a non-positive fitted slope
    (noise floor larger than the bandwidth term) degrades to ``alpha =
    min(t)`` with the secant bandwidth between the smallest and largest
    rung, and a non-positive intercept clamps ``alpha`` to zero with the
    slope refit through the origin.
    """
    s = [float(x) for x in sizes]
    t = [float(x) for x in times]
    if len(s) != len(t) or len(s) < 2:
        raise ValueError("alpha-beta fit needs >= 2 (size, time) points")
    n = len(s)
    ms = sum(s) / n
    mt = sum(t) / n
    var = sum((x - ms) ** 2 for x in s)
    if var <= 0:
        raise ValueError("alpha-beta fit needs >= 2 distinct sizes")
    beta = sum((x - ms) * (y - mt) for x, y in zip(s, t)) / var
    alpha = mt - beta * ms
    if beta <= 0:
        # timing noise swamped the size dependence: latency-dominated.
        span = max(s) - min(s)
        dt = t[s.index(max(s))] - t[s.index(min(s))]
        beta = max(dt / span, 1e-18) if dt > 0 else 1e-18
        return min(t), 1.0 / beta
    if alpha < 0:
        # through-origin refit: pure bandwidth regime.
        beta = sum(x * y for x, y in zip(s, t)) / sum(x * x for x in s)
        return 0.0, 1.0 / beta
    return alpha, 1.0 / beta


@dataclass(frozen=True)
class DeviceProfile:
    """Measured hardware profile; every field group optional.

    ``collectives`` maps axis name -> {kind -> CollectiveCurve};
    ``kernel_times`` maps ``(op, backend, shape_class)`` -> median seconds.
    ``meta`` is provenance (device kind, platform, torch version or the
    reference's jax version, measurement parameters) — carried verbatim
    into plan provenance.
    """

    device_kind: str
    measured_flops: float | None = None       # dense matmul FLOP/s
    measured_hbm_bw: float | None = None      # stream bytes/s
    collectives: dict = field(default_factory=dict)
    kernel_times: dict = field(default_factory=dict)
    meta: dict = field(default_factory=dict)

    # ---- calibration surface (consumed by CostModel.from_profile) ----- #
    def calibrate_mesh(self, mesh: MeshSpec) -> MeshSpec:
        """``mesh`` with measured chip efficiencies and per-axis collective
        curves attached.  Axes the profile never measured keep their
        analytic bandwidth; field groups the profile lacks are no-ops."""
        chip = mesh.chip.calibrated(self.measured_flops, self.measured_hbm_bw)
        axes = []
        for ax in mesh.axes:
            curves = self.collectives.get(ax.name)
            if curves:
                triples = tuple(sorted(
                    (c.kind, float(c.alpha), float(c.bw))
                    for c in curves.values()))
                # point-to-point transfers (pipeline stage cuts, min_bw)
                # see the measured all-gather bandwidth when available
                _, bw = dict((k, (a, b)) for k, a, b in triples).get(
                    "all_gather", (0.0, ax.bw))
                ax = dataclasses.replace(ax, curves=triples, bw=bw)
            axes.append(ax)
        return MeshSpec(axes=tuple(axes), chip=chip)

    def kernel_factors(self) -> dict[tuple[str, str], float]:
        """Measured ``(op, backend) -> factor`` roofline multipliers.

        The factor is the backend's median time relative to the fastest
        measured backend for the same op, aggregated (median) over shape
        classes — the fastest backend defines 1.0, mirroring the analytic
        hook convention where the best implementation runs at roofline.
        """
        by_op: dict[str, dict[str, list[float]]] = {}
        for (op, backend, _shape), t in self.kernel_times.items():
            by_op.setdefault(op, {}).setdefault(backend, []).append(float(t))
        out: dict[tuple[str, str], float] = {}
        for op, backends in by_op.items():
            med = {b: _median(ts) for b, ts in backends.items()}
            best = min(med.values())
            if best <= 0:
                continue
            for b, t in med.items():
                out[(op, b)] = t / best
        return out

    def fingerprint(self) -> dict:
        """Compact provenance for plan metadata (the reference's, plus the
        torch version where the meta has one)."""
        fp = {
            "device_kind": self.device_kind,
            "measured_flops": self.measured_flops,
            "measured_hbm_bw": self.measured_hbm_bw,
            "collective_axes": sorted(self.collectives),
            "kernel_entries": len(self.kernel_times),
            "jax": self.meta.get("jax"),
            "platform": self.meta.get("platform"),
        }
        if "torch" in self.meta:
            fp["torch"] = self.meta["torch"]
        return fp

    # ---- codec -------------------------------------------------------- #
    def to_json(self) -> dict:
        return {
            "schema": SCHEMA,
            "version": SCHEMA_VERSION,
            "device_kind": self.device_kind,
            "chip": {"measured_flops": self.measured_flops,
                     "measured_hbm_bw": self.measured_hbm_bw},
            "collectives": {
                axis: {kind: {"alpha": c.alpha, "bw": c.bw,
                              "sizes": list(c.sizes),
                              "times": list(c.times)}
                       for kind, c in curves.items()}
                for axis, curves in self.collectives.items()},
            "kernels": [{"op": op, "backend": b, "shape_class": sc,
                         "seconds": t}
                        for (op, b, sc), t in sorted(self.kernel_times.items())],
            "meta": dict(self.meta),
        }

    @classmethod
    def from_json(cls, obj: dict) -> "DeviceProfile":
        if not isinstance(obj, dict):
            raise ProfileFormatError(
                f"device profile must be a JSON object, got {type(obj).__name__}")
        if obj.get("schema") != SCHEMA:
            raise ProfileFormatError(
                f"not a device profile (schema={obj.get('schema')!r}, "
                f"want {SCHEMA!r})")
        if obj.get("version") not in _READABLE_VERSIONS:
            raise ProfileFormatError(
                f"device profile version {obj.get('version')!r} not readable "
                f"by this build (readable: {_READABLE_VERSIONS})")
        try:
            chip = obj.get("chip") or {}
            coll = {}
            for axis, curves in (obj.get("collectives") or {}).items():
                coll[axis] = {
                    kind: CollectiveCurve(
                        kind=kind, alpha=float(c["alpha"]), bw=float(c["bw"]),
                        sizes=tuple(float(x) for x in c.get("sizes", ())),
                        times=tuple(float(x) for x in c.get("times", ())))
                    for kind, c in curves.items()}
            kernels = {
                (str(k["op"]), str(k["backend"]), str(k["shape_class"])):
                    float(k["seconds"])
                for k in obj.get("kernels") or ()}
            mf = chip.get("measured_flops")
            mb = chip.get("measured_hbm_bw")
            return cls(
                device_kind=str(obj["device_kind"]),
                measured_flops=None if mf is None else float(mf),
                measured_hbm_bw=None if mb is None else float(mb),
                collectives=coll,
                kernel_times=kernels,
                meta=dict(obj.get("meta") or {}),
            )
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            raise ProfileFormatError(f"malformed device profile: {e}") from e

    # ---- persistence -------------------------------------------------- #
    def save(self, path: str | Path) -> Path:
        """Atomic write (tmp + ``os.replace``) so concurrent readers never
        see a torn profile."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
        tmp.write_text(json.dumps(self.to_json(), indent=1, sort_keys=True))
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str | Path) -> "DeviceProfile":
        path = Path(path)
        try:
            raw = json.loads(path.read_text())
        except (OSError, ValueError) as e:
            raise ProfileFormatError(
                f"unreadable device profile {path}: {e}") from e
        return cls.from_json(raw)


def _median(xs) -> float:
    xs = sorted(float(x) for x in xs)
    n = len(xs)
    if n == 0:
        raise ValueError("median of empty sequence")
    mid = n // 2
    return xs[mid] if n % 2 else 0.5 * (xs[mid - 1] + xs[mid])


def profile_dir() -> Path:
    """Default profile directory, next to the autotune cache (the
    checkout's ``build/``); overridable via ``REPRO_PROFILE_DIR``."""
    d = os.environ.get(ENV_PROFILE_DIR)
    return Path(d) if d else BUILD.parent / "profiles"


def sanitize_device_kind(kind: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]+", "_", kind.strip()) or "unknown"


def default_profile_path(device_kind: str) -> Path:
    return profile_dir() / f"{sanitize_device_kind(device_kind)}.json"


def load_profile(path: str | Path) -> DeviceProfile:
    """Convenience loader used by the ``--device-profile`` driver flags."""
    return DeviceProfile.load(path)
