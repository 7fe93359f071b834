"""Cell drivers, one module a traffic ``kind``: each has
``run(run, device, options) -> Outcome`` that sets up the program under
test, drives it through the window, and decides ``correct`` against the
plain reference."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Outcome:
    attempted: int
    failed: int
    checks: dict                  # name -> {"value", "limit"}
    memory_peak_bytes: int
    readings: dict = field(default_factory=dict)   # control readings etc.

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            c["value"] is not None and c["value"] <= c["limit"]
            for c in self.checks.values())


def relative_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def worst_leaf_gap(prog: dict, ref: dict, counted=None) -> float:
    """Over leaves: the gap between the program's norm and the
    reference's, against the reference's norm of that leaf or of the
    median leaf, whichever is larger."""
    keys = [k for k in ref if counted is None or k in counted]
    norms = sorted(ref[k] for k in keys)
    median = norms[len(norms) // 2]
    return max(abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
               for k in keys)
