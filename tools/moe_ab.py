#!/usr/bin/env python3
"""A/B timing of the MoE scatter and gather kernels, of the WKV6 kernel,
or of the selective-scan kernel, of several checkouts of this repository
on one GPU, all on one timer.

    python3 tools/moe_ab.py [--kernel moe|wkv6|scan] \\
        --run LABEL=DIR[,NAME=VALUE...][,flush=read] \\
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
``--kernel wkv6`` builds the checkout's ``csrc/rwkv6_scan.cu`` instead
and calls its ``chip_smoke.phase_wkv6`` at rwkv6-1.6b's train shape
(8, 32, 256, 64), at few (b, h) over a long sequence (1, 32, 2048, 64) and
at head size 32 (3, 2, 256, 32), float32 and bfloat16, each shape given
through the checkout's ``chip_smoke.wkv_inputs``.
``--kernel scan`` builds the checkout's ``csrc/mamba_scan.cu`` and calls
its ``chip_smoke.phase_mamba`` at jamba-1.5-large's shapes (d_inner
16384): the serving chunk (1, 256) and decode step (8, 1) with a carried
state, the longest prompt's prefill (1, 675), the stateless forward
(1, 512) and the chunk at N 8, float32 and bfloat16.
``NAME=VALUE`` sets an integer constant of the checkout's kernel module
(``repro_torch.kernels.moe_dispatch``, ``.rwkv6_scan`` or ``.mamba_scan``)
first
(``SCATTER_MAP_MIN=0``).
``flush=read`` flushes the L2 with a 96 MB read instead: the lines left
behind are clean, so a kernel's own traffic does not write them back.

Prints each process's phases as JSON lines, then one line per phase and
run with the mean ``kernel_ms`` over the rounds and each reading; writes
everything to ``--out`` (default ``chiprun_out/<kernel>_ab.json``).
Exits nonzero if a phase failed its check.
"""

from __future__ import annotations

import argparse
import functools
import importlib
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
MOE_SHAPES = [
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
# (name, wkv_inputs' kwargs): rwkv6-1.6b's train step (B 8 x 256 tokens,
# 32 heads of 64), 32 CTAs over 2048 steps, head size 32
WKV6_SHAPES = [
    ("train", dict(B=8, H=32, T=256, N=64)),
    ("long", dict(B=1, H=32, T=2048, N=64)),
    ("n32", dict(B=3, H=2, T=256, N=32)),
]
# (name, phase_mamba's kwargs): jamba's chunk and decode with the cache
# row's state, the stall prefill of the smoke's longest prompt, the
# stateless forward, and the chunk at N 8
SCAN_SHAPES = [
    ("chunk", dict(B=1, S=256)),
    ("decode", dict(B=8, S=1)),
    ("prefill", dict(B=1, S=675)),
    ("forward", dict(B=1, S=512, state=False)),
    ("n8", dict(B=1, S=256, N=8)),
]
SHAPES = {"moe": MOE_SHAPES, "wkv6": WKV6_SHAPES, "scan": SCAN_SHAPES}
MODULE = {"moe": "moe_dispatch", "wkv6": "rwkv6_scan", "scan": "mamba_scan"}


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


def worker(kernel: str, spec: str, shapes: list[str]) -> int:
    import torch
    root, sets, flush = parse(spec)[1:]
    sys.path.insert(0, str(root / "src"))
    here = load(ROOT / "chip_smoke.py", "chip_smoke_timer")
    theirs = load(root / "chip_smoke.py", "chip_smoke_under_test")
    mod = importlib.import_module(f"repro_torch.kernels.{MODULE[kernel]}")
    for name, value in sets.items():
        if not hasattr(mod, name):
            raise SystemExit(f"{root}: {MODULE[kernel]} has no {name}")
        setattr(mod, name, value)
    device = torch.device("cuda")
    timer = here.Timer(torch, device)
    if flush == "read":
        timer.flush = ReadFlush(timer.flush)
    if kernel == "wkv6":
        wkv_inputs = theirs.wkv_inputs     # phase_wkv6's shape comes from it
    rows = []
    for name, kw in SHAPES[kernel]:
        if shapes and name not in shapes:
            continue
        for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            if kernel == "moe":
                rows += theirs.phase_moe(torch, timer, device,
                                         f"{name}-{tag}", dt, **kw)
            elif kernel == "scan":
                rows.append(theirs.phase_mamba(torch, timer, device,
                                               f"mamba-{name}-{tag}", dt,
                                               **kw))
            else:
                theirs.wkv_inputs = functools.partial(wkv_inputs, **kw)
                rows.append(theirs.phase_wkv6(torch, timer, device,
                                              f"wkv6-{name}-{tag}", dt))
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
    ap.add_argument("--kernel", choices=sorted(SHAPES), default="moe")
    ap.add_argument("--run", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", help="default chiprun_out/<kernel>_ab.json")
    ap.add_argument("--shapes", default="",
                    help="comma-separated names of the kernel's SHAPES "
                         "(default: all)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    names = [name for name, _ in SHAPES[args.kernel]]
    shapes = [s for s in args.shapes.split(",") if s]
    if not set(shapes) <= set(names):
        ap.error(f"--shapes: one of {names}")
    if args.worker:
        return worker(args.kernel, args.worker, shapes)
    if not args.run:
        ap.error("give at least one --run")
    order = (args.run + args.run[::-1]) * args.rounds
    results, rc = [], 0
    for spec in order:
        p = subprocess.run([sys.executable, __file__, "--kernel", args.kernel,
                            "--worker", spec, "--shapes", args.shapes],
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
    out = ROOT / (args.out or f"chiprun_out/{args.kernel}_ab.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"runs": order, "phases": results,
                               "summary": list(summary.values())},
                              indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())
