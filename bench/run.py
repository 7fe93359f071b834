"""Run one cell of the benchmark of the PyTorch and CUDA port:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It finds the cell in ``BENCHMARK.json``,
builds the port's system under test from the seed, warms it up, measures
for ``--seconds`` seconds, checks what the timed path produced against
the plain reference, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``: each
number compared beside its limit, which are also the last lines on
standard error.  It exits non-zero and prints no result without enough
CUDA devices, or if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment():
    """Caches inside the checkout, at fixed paths; the program from the
    checkout's ``src``; transformers, if anything loads it, without Flax."""
    build = ROOT / "build"
    os.environ.setdefault("REPRO_AUTOTUNE_CACHE_DIR", str(build / "autotune"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    from bench import core
    cell = core.Cell(args.workload, ROOT)
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"error: the program under test is not in this checkout: {e}",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"error: cell {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    run = core.Run(cell, args.seed, args.seconds, bool(args.trace), T_START)
    outcome = cell.driver().run(run, device)
    metrics = core.compute_metrics(run, bool(args.trace), ROOT)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": cell.chips, "memory_peak_bytes": outcome.memory_peak_bytes}
    extra = {}
    if args.trace:
        from bench import trace
        dev.update(busy_s=run.slice.busy_s, window_s=run.slice.window_s)
        extra["breakdown"] = trace.breakdown(run.slice)
    print(f"window: {json.dumps(outcome.readings.get('window'))}",
          file=sys.stderr)
    for name, c in outcome.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    bad = core.forbidden_modules()
    if bad:
        print(f"error: the run loaded {bad} (JAX or the JAX package)",
              file=sys.stderr)
        return 4
    print(core.result_line(correct=outcome.correct,
                           attempted=outcome.attempted,
                           failed=outcome.failed, metrics=metrics, device=dev,
                           checks=outcome.checks, **extra), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
