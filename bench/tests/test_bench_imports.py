"""The import guard: no module a run loads, and none the reference
imports, has the top-level name ``jax``, ``jaxlib``, ``flax`` or
``repro`` (compared whole: ``repro_torch`` is the port); the reference
imports nothing of the port either."""

import ast
import subprocess
import sys
import types

import pytest

from bench import core


def test_forbidden_names_are_compared_whole():
    assert core.forbidden_modules(["jax.numpy", "repro", "repro.models",
                                   "flax", "repro_torch", "reprox",
                                   "jaxtyping"]) == ["flax", "jax", "repro"]
    assert core.forbidden_modules(["repro_torch.serve", "torch"]) == []


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=core.ROOT, check=True,
        env={"PYTHONPATH": f"{core.ROOT}:{core.ROOT / 'src'}", "PATH": ""})
    return set(out.stdout.split())


def test_a_run_loads_neither_jax_nor_the_jax_package():
    mods = _loaded_after(
        "import bench.core, bench.trace, bench.readers, bench.kinds.train, "
        "bench.archs.moe_lm, bench.weights\nimport repro_torch.train, "
        "repro_torch.optim, repro_torch.kernels.ops, repro_torch.configs")
    assert "repro_torch" in mods
    assert not core.forbidden_modules(mods)


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (core.BENCH / "reference").glob("*.py")
    if p.stem != "__init__"))
def test_the_reference_imports_nothing_of_the_program(name):
    mods = _loaded_after(f"import bench.reference.{name}")
    assert "torch" in mods
    assert not core.forbidden_modules(mods) and "repro_torch" not in mods


def test_the_guard_runs_after_the_metrics_and_before_the_result(
        monkeypatch, capsys):
    """A module loaded while the metrics are read (a reader's import, or
    a lazy import inside the port) still stops the run: no result line,
    a non-zero exit, and the name on standard error."""
    torch = pytest.importorskip("torch")
    sys.path.insert(0, str(core.BENCH))
    try:
        import run as bench_run
    finally:
        sys.path.remove(str(core.BENCH))
    from bench.kinds import Outcome

    class Driver:
        @staticmethod
        def run(run, device):
            run.t_open, run.t_close = 1.0, 2.0
            return Outcome(attempted=1, failed=0, memory_peak_bytes=0,
                           checks={"x": {"value": 0.0, "limit": 1.0}})

    def metrics_that_load_jax(run, traced, root):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return {}

    monkeypatch.setattr(bench_run, "_environment", lambda: None)
    monkeypatch.setattr(core.Cell, "driver", lambda self: Driver)
    monkeypatch.setattr(core, "compute_metrics", metrics_that_load_jax)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "card")
    rc = bench_run.main(["--workload", "olmoe-train-d8", "--seed", "1",
                         "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and "correct" not in out.out
    assert "jax" in out.err.splitlines()[-1]


def test_no_bench_source_imports_jax_or_the_jax_package():
    for path in core.BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            bad = core.forbidden_modules(names)
            assert not bad, f"{path} imports {bad}"
            if "reference" in path.parts:
                assert not any(n.split(".")[0] == "repro_torch"
                               for n in names), path
