#!/usr/bin/env python3
"""A/B timing of one train run of ``chip_smoke`` in several checkouts of
this repository on one GPU.

    python3 tools/train_ab.py --run LABEL=DIR [--run ...] \\
        [--arch olmoe-d8] [--steps 4] [--out chiprun_out/train_ab.json]

Run from the repository root on a machine with an NVIDIA GPU and the CUDA
toolkit.  ``DIR`` is a checkout: ``.`` for this one, or a parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists.
Each ``--run`` runs in a process of its own, in the order given and then
in reverse (A B B A).  A process builds its checkout's kernels and calls
that checkout's ``chip_smoke.train_full`` (float32, batch 8 x 256, the
train command's settings) on ``--arch``: ``olmoe-d8`` is
``chip_smoke.olmoe_train_arch()`` (olmoe-1b-7b at full width, 8 of its 16
layers), any other name a config of ``repro_torch.configs``.  Prints each
process's phase line, then one line per run with the mean step time
after the first step, the peak memory and the launches; writes
everything to ``--out``.  Exits nonzero if a process failed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import json, sys
from pathlib import Path
d = Path(sys.argv[1]).resolve()
sys.path[:0] = [str(d), str(d / "src")]
import torch
import chip_smoke as smoke
from repro_torch import configs
from repro_torch.kernels import build
build.build_all()
name, steps = sys.argv[2], int(sys.argv[3])
arch = smoke.olmoe_train_arch() if name == "olmoe-d8" else configs.get(name)
smoke.train_full(torch, torch.device("cuda"), arch, steps=steps)
res = smoke.record["phases"][-1]
print("RESULT " + json.dumps({
    "step_ms_after_first": res["step_ms_after_first"],
    "step_ms": res["step_ms"], "loss": res["loss"],
    "max_memory_allocated_gb": res["max_memory_allocated_gb"],
    "launches": res["launches"], "failures": smoke.failures}))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", action="append", required=True,
                    help="LABEL=DIR")
    ap.add_argument("--arch", default="olmoe-d8")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "train_ab.json"))
    args = ap.parse_args(argv)
    runs = [r.split("=", 1) for r in args.run]
    order = runs + runs[::-1]
    out, ok = [], True
    for label, d in order:
        d = str(Path(d).resolve())
        p = subprocess.run([sys.executable, "-c", CHILD, d, args.arch,
                            str(args.steps)], capture_output=True, text=True,
                           timeout=900, cwd=d)
        lines = [ln for ln in p.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if p.returncode or not lines:
            ok = False
            print(f"{label}: rc {p.returncode}\n{p.stderr[-3000:]}",
                  flush=True)
            continue
        res = json.loads(lines[-1][len("RESULT "):])
        ok &= not res["failures"]
        out.append({"run": label, "dir": d, **res})
        print(json.dumps(out[-1]), flush=True)
    for label, _ in runs:
        mine = [r for r in out if r["run"] == label]
        if mine:
            print(json.dumps({
                "run": label, "arch": args.arch,
                "step_ms_after_first": [r["step_ms_after_first"]
                                        for r in mine],
                "mean_ms": sum(r["step_ms_after_first"] for r in mine)
                / len(mine),
                "max_memory_allocated_gb": [r["max_memory_allocated_gb"]
                                            for r in mine]}), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
