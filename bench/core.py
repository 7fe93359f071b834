"""The harness's common part: finding a cell and its files by name,
the run's record that metric readers read, the import guard, and the
result line.

Everything is found by the names in ``BENCHMARK.json``: a cell's
configuration file (``configs[].file``), whose ``reference`` names the
plain reference ``bench/reference/<reference>.py`` (the model, its weight
layout ``shapes`` and, for MoE models, ``capacity``) and the port's
side ``bench/archs/<reference>.py`` (``port_arch``, and for MoE models
the ``routing`` the reference follows);
its traffic mix ``bench/traffic/<traffic>.json``, whose ``kind`` names
the driver ``bench/kinds/<kind>.py``; its correctness limits
``bench/limits/<cell>.json``; and each metric's reader
``bench/metrics/<metric>.py``.  A cell, a configuration of another
model family, a traffic mix or a metric is added as new files and
entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

#: top-level module names a run may never hold: JAX and the JAX package
#: the port was made from.  Compared whole: ``repro_torch`` is the port.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of ``workloads`` with its configuration, traffic mix and
    limits, found by name under ``root``."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = Path(root)
        self.spec = load_json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json; it has "
                           f"{sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in self.spec["configs"]}
        self.config = load_json(self.root / configs[self.entry["config"]]["file"])
        bench = self.root / "bench"
        self.traffic = load_json(bench / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = load_json(bench / "limits" / f"{name}.json")
        self.chips = int(self.entry["chips"])

    def metrics(self, traced: bool) -> list[dict]:
        """The metrics this cell reports: ``end_to_end`` untraced,
        ``per_layer`` traced, each where its ``workloads`` (if any) name
        the cell."""
        group = self.spec["per_layer" if traced else "end_to_end"]
        return [m for m in group
                if self.name in m.get("workloads", [self.name])]

    def driver(self):
        return importlib.import_module(f"bench.kinds.{self.traffic['kind']}")


def reference(cfg: dict):
    """The plain reference module that the configuration file names."""
    return importlib.import_module(f"bench.reference.{cfg['reference']}")


def port_side(cfg: dict):
    """The module under ``bench/archs/`` that the configuration file's
    ``reference`` names: ``port_arch(cfg)``, the port's architecture, and
    optionally ``routing(record)``, a context that records what of the
    program's step the reference follows."""
    return importlib.import_module(f"bench.archs.{cfg['reference']}")


def port_arch(cfg: dict):
    """The port's architecture for the configuration file."""
    return port_side(cfg).port_arch(cfg)


def reader(name: str, root: Path = ROOT):
    """The ``read(run)`` function of ``bench/metrics/<name>.py``."""
    path = Path(root) / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """What one run recorded, for the metric readers: the cell, the
    window's ends (host seconds), kind-specific records, and with
    ``--trace 1`` the traced slice (``bench.trace.Slice``)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, traced: bool,
                 t_start: float):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.traced, self.t_start = traced, t_start
        self.config, self.traffic = cell.config, cell.traffic
        self.t_open = self.t_close = None
        self.slice = None
        self.data: dict = {}


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names
                   if n.split(".")[0] in FORBIDDEN})


def compute_metrics(run: Run, traced: bool, root: Path = ROOT) -> dict:
    out = {}
    for m in run.cell.metrics(traced):
        value = reader(m["name"], root)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, checks: dict,
                breakdown: dict | None = None) -> str:
    """The last line of standard output; ``checks`` (each compared number
    beside its limit) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
