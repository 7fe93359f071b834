"""The program's own spans and counters (``repro_torch.tracing``) over a
traced slice of a training cell, read beside the benchmark's metrics:

    python3 bench/program.py --workload <cell> --seed <n> [--seconds <s>]

runs the cell as ``bench/run.py --trace 1`` does, with the program
recording inside the profiled slice, and prints one JSON line last: the
run's ``correct`` and per-layer metrics, and ``program``: the readings
below, the step coverage, kernels a step, the idle gaps named by the
program's spans, and the counters.  The benchmark's own runs never
record: ``bench/kinds/train.py`` and ``bench/trace.py::profile_slice``
would have to call :func:`profile_slice` for these readings to become
metrics of the cell.

* Charging: a kernel goes to the innermost program span open on the
  thread that launched it at the launch, found through the CUDA runtime
  event that shares its correlation id, else to the innermost open on
  the recording thread then.  The program's spans launch no kernel.
* Clock: the tie marker's launch, the slice's first runtime launch
  event, happened at host time ``t_cal``; runtime and device events share
  the profiler's clock.  The tie is read from the runtime event because
  the profiler can lose the device records of a slice's first (and last)
  kernels, the tie marker's among them.
* Readings (milliseconds a ``train.step``): ``forward_ms``
  (``train.forward`` and the spans inside it), ``recompute_ms``
  (``lm.unit`` and ``moe.ffn`` spans opened inside ``train.backward``: a
  unit's remat recompute and the MoE layer's own inner remat),
  ``backward_ms`` (``train.backward`` less the recompute); and shares of
  the MoE layers' forward calls: ``moe_slot_fill`` (``moe.kept`` over
  ``moe.slots``) and ``moe_drop_share`` (``moe.assignments`` less
  ``moe.kept``, over ``moe.assignments``).  Each is None where it does
  not apply: no step recorded, no recompute, no MoE layer.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import bisect  # noqa: E402
import contextlib  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":      # a script: the checkout's root on the path
    sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

from bench import trace  # noqa: E402

#: the program's spans whose work inside ``train.backward`` is the remat
#: recompute: a unit's function, and the MoE layer's own inner remat
RECOMPUTED = ("lm.unit", "moe.ffn")
#: runtime calls that put work on a stream (kernels, copies, fills)
LAUNCHES = ("Launch", "Memcpy", "Memset")


class Program:
    """The program's record (``repro_torch.tracing.Record``) over a traced
    slice, with the device seconds of the kernels charged to each span
    itself (``own_s``, by the span's index), to no program span
    (``outside_s``: the harness's work) and, for want of a launch event,
    to none (``unlaunched_s``); ``gaps``: (seconds, label) of the slice's
    idle time, each named by the program span open when it started, else
    by the harness's span."""

    def __init__(self, record):
        self.record = record
        self.spans = record.spans
        self.own_s: dict[int, float] = defaultdict(float)
        self.outside_s = 0.0
        self.unlaunched_s = 0.0
        self.gaps: list[tuple[float, str]] = []

    def count(self, name: str) -> int:
        """Closed spans named ``name``."""
        return sum(1 for s in self.spans if s[0] == name and s[4] is not None)

    def seconds(self, names, under: str | None = None) -> float:
        """Device seconds charged to spans named in ``names`` and to their
        descendants, once however they nest; with ``under``, only those
        inside a span named ``under``."""
        names = {names} if isinstance(names, str) else set(names)
        total = 0.0
        for i, sec in self.own_s.items():
            chain = [i]
            while self.spans[chain[-1]][1] >= 0:
                chain.append(self.spans[chain[-1]][1])
            hits = [k for k, j in enumerate(chain) if self.spans[j][0] in names]
            if hits and (under is None or any(
                    self.spans[j][0] == under for j in chain[hits[0] + 1:])):
                total += sec
        return total

    def ms_per_step(self, names, under: str | None = None):
        """:meth:`seconds` in milliseconds a ``train.step``, or None where
        no step was recorded or nothing was charged."""
        steps = self.count("train.step")
        seconds = self.seconds(names, under) if steps else 0.0
        return 1e3 * seconds / steps if seconds > 0 else None


def _timelines(record) -> dict:
    """Per recording thread, (times, innermost): from ``times[k]`` on, the
    innermost open span is ``innermost[k]`` (-1: none)."""
    edges = defaultdict(list)
    for i, (_, _, thread, a, b) in enumerate(record.spans):
        if b is not None:
            edges[thread] += [(a, 1, i), (b, 0, i)]
    out = {}
    for thread, ev in edges.items():
        ev.sort()
        times, inner, stack = [], [], []
        for t, opens, i in ev:
            if opens:
                stack.append(i)
            else:
                stack.remove(i)
            times.append(t)
            inner.append(stack[-1] if stack else -1)
        out[thread] = (times, inner)
    return out


def _open_at(line, t: int) -> int:
    k = bisect.bisect_right(line[0], t) - 1 if line else -1
    return line[1][k] if k >= 0 else -1


def attribute(device, launches, record, harness_host, t_cal: int, t0: int,
              t1: int) -> Program:
    """Charge the slice's device work to the program's spans.  ``device``:
    (name, start_ns, duration_ns, correlation id), sorted by start;
    ``launches``: correlation id -> (name, start_ns, thread) of the
    runtime calls that put work on a stream, the thread as the low 32 bits
    of its ``threading.get_ident()``, the earliest the tie marker's,
    launched at host time ``t_cal``; ``harness_host``: the harness's host
    spans (name, start, end), which name idle time no program span
    covers; ``t0``, ``t1``: the slice's ends on the host."""
    prog = Program(record)
    if not launches:
        return prog
    off = min(v[1] for v in launches.values()) - t_cal   # clock = host + off
    lo, hi = t0 + off, t1 + off
    lines = _timelines(record)
    thread_of = {t & 0xFFFFFFFF: t for t in record.threads}
    home = lines.get(record.thread)
    harness = sorted(harness_host, key=lambda h: h[1])
    starts = [h[1] for h in harness]
    last_end, gaps = lo, []
    for name, start, dur, corr in device:
        end = start + dur
        if trace.MARKER in name or end <= lo or start >= hi:
            continue
        start, end = max(start, lo), min(end, hi)
        launch = launches.get(corr)
        if launch is None:
            prog.unlaunched_s += (end - start) / 1e9
        else:
            t = launch[1] - off
            i = _open_at(lines.get(thread_of.get(launch[2] & 0xFFFFFFFF)), t)
            i = i if i >= 0 else _open_at(home, t)
            if i >= 0:
                prog.own_s[i] += (end - start) / 1e9
            else:
                prog.outside_s += (end - start) / 1e9
        if start > last_end:
            gaps.append((last_end, start))
        last_end = max(last_end, end)
    if hi > last_end:
        gaps.append((last_end, hi))
    for a, b in gaps:
        opened = [i for i in (_open_at(ln, a - off) for ln in lines.values())
                  if i >= 0]
        label = (record.spans[max(opened, key=lambda i: record.spans[i][3])][0]
                 if opened else trace._host_label(harness, starts, a - off))
        prog.gaps.append(((b - a) / 1e9, label))
    return prog


def profile_slice(torch, spans, body, recording=None):
    """``bench/trace.py::profile_slice`` with the program recording inside
    the slice (``recording``: ``repro_torch.tracing.recording``, or None
    for a program without it) and the runtime events kept: the same
    steps, the same device events for ``reduce_events``; the
    :class:`Program` goes to the slice's ``program``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t_cal = time.perf_counter_ns()
        spans.marker()
        torch.cuda.synchronize()
        spans.active = True
        t0 = time.perf_counter_ns()
        try:
            with (recording() if recording else contextlib.nullcontext()
                  ) as record:
                body()
                torch.cuda.synchronize()
        finally:
            spans.active = False
        t1 = time.perf_counter_ns()
    device, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            device.append((e.name(), e.start_ns(), e.duration_ns(),
                           e.correlation_id()))
        elif any(k in e.name() for k in LAUNCHES):
            launches.setdefault(e.correlation_id(), (
                e.name(), e.start_ns(), e.device_resource_id()))
    device.sort(key=lambda e: e[1])
    sl = trace.reduce_events([e[:3] for e in device], spans, t_cal, t0, t1)
    sl.program = (attribute(device, launches, record, spans.host, t_cal, t0,
                            t1) if record is not None else None)
    return sl


def readings(prog: Program | None) -> dict:
    """The five readings of the module docstring (None where they do not
    apply) from the slice's :class:`Program`."""
    out = dict.fromkeys(("forward_ms", "recompute_ms", "backward_ms",
                         "moe_slot_fill", "moe_drop_share"))
    if prog is None:
        return out
    out["forward_ms"] = prog.ms_per_step("train.forward")
    out["recompute_ms"] = prog.ms_per_step(RECOMPUTED, under="train.backward")
    backward = prog.ms_per_step("train.backward")
    if backward is not None:
        out["backward_ms"] = backward - (out["recompute_ms"] or 0.0)
    c = prog.record.counters
    if c.get("moe.slots"):
        out["moe_slot_fill"] = 100.0 * c["moe.kept"] / c["moe.slots"]
    if c.get("moe.assignments"):
        out["moe_drop_share"] = (100.0 * (c["moe.assignments"] - c["moe.kept"])
                                 / c["moe.assignments"])
    return out


def summary(sl) -> dict:
    """Beside :func:`readings`: per ``train.step`` the device time of the
    three phases against the slice's busy time (the step coverage), what
    the rest went to, kernels a step, the named idle gaps and the
    counters."""
    prog = sl.program
    out = {"kernels": sum(v[1] for v in sl.kernels.values()),
           "busy_s": sl.busy_s, "window_s": sl.window_s}
    if prog is None or not prog.count("train.step"):
        return out
    n = prog.count("train.step")
    phases = {p: prog.seconds(f"train.{p}") / n
              for p in ("forward", "backward", "optimizer")}
    idle = defaultdict(float)
    for sec, label in prog.gaps:
        idle[label] += sec
    out.update(
        steps=n, kernels_per_step=out["kernels"] / n,
        busy_ms_per_step=1e3 * sl.busy_s / n,
        phase_ms={p: 1e3 * s for p, s in phases.items()},
        coverage=sum(phases.values()) * n / sl.busy_s if sl.busy_s else None,
        step_rest_ms=1e3 * (prog.seconds("train.step") / n
                            - sum(phases.values())),
        outside_ms=1e3 * prog.outside_s / n,
        unlaunched_ms=1e3 * prog.unlaunched_s / n,
        idle_gaps=sorted(([k, v] for k, v in idle.items()),
                         key=lambda x: -x[1]),
        counters=dict(prog.record.counters))
    return out


def main(argv=None) -> int:
    import argparse
    import json

    from bench.run import ROOT, _environment
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from bench import core
    try:
        from repro_torch.tracing import recording
    except ImportError:          # a program without the recorder
        recording = None
    cell = core.Cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 3
    seconds = args.seconds or cell.spec["run_seconds"]
    run = core.Run(cell, args.seed, seconds, True, T_START)
    real = trace.profile_slice
    trace.profile_slice = lambda torch, spans, body: profile_slice(
        torch, spans, body, recording)
    try:
        outcome = cell.driver().run(run, torch.device("cuda", 0))
    finally:
        trace.profile_slice = real
    steps = sorted((b - a) / 1e6 for n, a, b in run.data["spans"].host
                   if n == "train_step")
    line = {"correct": outcome.correct,
            "metrics": {k: v["value"] for k, v in
                        core.compute_metrics(run, True, ROOT).items()},
            "program": dict(readings(run.slice.program),
                            **summary(run.slice),
                            slice_step_ms_p50=steps[len(steps) // 2]),
            "window": outcome.readings.get("window"),
            "device": torch.cuda.get_device_name(0)}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
