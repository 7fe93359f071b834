#!/usr/bin/env python3
"""A/B timing of the MoE scatter and gather kernels of several checkouts
of this repository on one GPU, all on one timer.

    python3 tools/moe_ab.py --run LABEL=DIR[,NAME=VALUE...][,flush=read] \\
        [--run ...] [--rounds 1] [--shapes decode,chunk,...] \\
        [--out chiprun_out/moe_ab.json]

Run from the repository root on a machine with an NVIDIA GPU and the CUDA
toolkit.  ``DIR`` is a checkout: ``.`` for this one, or a parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists.
Each ``--run`` runs in a process of its own, in the order given and then
in reverse (A B B A), ``--rounds`` times over.  A process builds its
checkout's ``csrc/moe_dispatch.cu`` and calls that checkout's
``chip_smoke.phase_moe`` at olmoe-1b-7b's and jamba-1.5-large's decode,
chunk and prefill shapes, float32 and bfloat16, with this checkout's
``chip_smoke.Timer`` (events around each call, the L2 flushed by a 96 MB
write before it), so every checkout is read on the same timer.
``NAME=VALUE`` sets an integer constant of the checkout's
``repro_torch.kernels.moe_dispatch`` first (``SCATTER_MAP_MIN=0``).
``flush=read`` flushes the L2 with a 96 MB read instead: the lines left
behind are clean, so a kernel's own traffic does not write them back.

Prints each process's phases as JSON lines, then one line per phase and
run with the mean ``kernel_ms`` over the rounds and each reading; writes
everything to ``--out``.  Exits nonzero if a phase failed its check.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (name, kwargs of phase_moe): olmoe's (K 8, E 64, D 2048) and jamba's
# (K 2, E 16, D 8192) decode step, 256-token chunk, and stall-the-world
# prefill of the smoke's longest prompt (700) and of 1024-4096 tokens,
# each C as models/moe.py::capacity gives it
SHAPES = [
    ("decode", dict(B=8, S=1, C=8)),
    ("chunk", dict(B=1, S=256, C=40)),
    ("prefill700", dict(B=1, S=700, C=112)),
    ("prefill1024", dict(B=1, S=1024, C=160)),
    ("prefill2048", dict(B=1, S=2048, C=320)),
    ("prefill4096", dict(B=1, S=4096, C=640)),
    ("decode-jamba", dict(B=8, S=1, C=8, K=2, E=16, D=8192)),
    ("chunk-jamba", dict(B=1, S=256, C=40, K=2, E=16, D=8192)),
    ("prefill700-jamba", dict(B=1, S=700, C=112, K=2, E=16, D=8192)),
    ("prefill4096-jamba", dict(B=1, S=4096, C=640, K=2, E=16, D=8192)),
]


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class ReadFlush:
    """Stands in for the timer's flush buffer: ``zero_()`` reads the 96 MB
    (a sum) instead of writing them."""

    def __init__(self, buf):
        self.buf = buf

    def zero_(self):
        import torch
        self.buf.view(torch.int32).sum()


def worker(spec: str, shapes: list[str]) -> int:
    import torch
    root, sets, flush = parse(spec)[1:]
    sys.path.insert(0, str(root / "src"))
    here = load(ROOT / "chip_smoke.py", "chip_smoke_timer")
    theirs = load(root / "chip_smoke.py", "chip_smoke_under_test")
    from repro_torch.kernels import moe_dispatch
    for name, value in sets.items():
        if not hasattr(moe_dispatch, name):
            raise SystemExit(f"{root}: moe_dispatch has no {name}")
        setattr(moe_dispatch, name, value)
    device = torch.device("cuda")
    timer = here.Timer(torch, device)
    if flush == "read":
        timer.flush = ReadFlush(timer.flush)
    rows = []
    for name, kw in SHAPES:
        if shapes and name not in shapes:
            continue
        for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            rows += theirs.phase_moe(torch, timer, device, f"{name}-{tag}",
                                     dt, **kw)
    print("RESULT " + json.dumps(rows), flush=True)
    return 1 if theirs.failures else 0


def parse(spec: str):
    label, rest = spec.split("=", 1)
    parts = rest.split(",")
    sets, flush = {}, "write"
    for p in parts[1:]:
        k, v = p.split("=", 1)
        if k == "flush":
            flush = v
        else:
            sets[k] = int(v)
    return label, (ROOT / parts[0]).resolve(), sets, flush


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", default="chiprun_out/moe_ab.json")
    ap.add_argument("--shapes", default="",
                    help="comma-separated names of SHAPES (default: all)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    shapes = [s for s in args.shapes.split(",") if s]
    if not set(shapes) <= {name for name, _ in SHAPES}:
        ap.error(f"--shapes: one of {[name for name, _ in SHAPES]}")
    if args.worker:
        return worker(args.worker, shapes)
    if not args.run:
        ap.error("give at least one --run")
    order = (args.run + args.run[::-1]) * args.rounds
    results, rc = [], 0
    for spec in order:
        p = subprocess.run([sys.executable, __file__, "--worker", spec,
                            "--shapes", args.shapes],
                           capture_output=True, text=True, cwd=ROOT)
        rows = [json.loads(line[7:]) for line in p.stdout.splitlines()
                if line.startswith("RESULT ")]
        if p.returncode or not rows:
            rc = 1
            print(f"{spec}: exit {p.returncode}\n{p.stderr[-4000:]}",
                  file=sys.stderr)
            continue
        for r in rows[0]:
            r["run"] = parse(spec)[0]
            print(json.dumps(r), flush=True)
        results += rows[0]
    summary = {}
    for r in results:
        s = summary.setdefault((r["phase"], r["run"]), {
            "phase": r["phase"], "run": r["run"], "kernel_ms": [],
            "kernel_device_ms": [], "bound_ms": r["bound_ms"],
            "plain_ms": [], "library_ms": [], "max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], r["max_abs_err"])
        for k in ("kernel_ms", "kernel_device_ms", "plain_ms", "library_ms"):
            if r.get(k) is not None:
                s[k].append(r[k])
    for s in summary.values():
        s["mean_kernel_ms"] = sum(s["kernel_ms"]) / len(s["kernel_ms"])
        print("AB " + json.dumps(s), flush=True)
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"runs": order, "phases": results,
                               "summary": list(summary.values())},
                              indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())
