"""Charging a traced slice to the program's own spans
(``bench/program.py::attribute``) and the five readings of them, on a
synthetic slice: kernels, the CUDA runtime events that launched them,
two host threads, a remat recompute under the backward, and an idle gap
inside ``train.forward``."""

from types import SimpleNamespace

import pytest

from bench import program, trace

M = trace.MARKER
R, A = (1 << 32) + 5, (2 << 32) + 7      # threading.get_ident() of two threads
CLOCK = 1000                             # the profiler's clock = host + this
HARNESS = [("train_step", 90, 990)]      # the harness's host span

# (name, parent, thread, start, end), host ns
SPANS = [("train.step", -1, R, 100, 900),
         ("train.forward", 0, R, 110, 300),
         ("lm.unit", 1, R, 120, 200),
         ("moe.ffn", 2, R, 150, 190),
         ("train.backward", 0, R, 300, 700),
         ("lm.unit", 4, A, 320, 400),        # the recompute, autograd's thread
         ("moe.ffn", 4, A, 420, 450),        # the MoE layer's inner remat
         ("train.optimizer", 0, R, 700, 880)]

# (kernel, device start, duration, launching thread, host time of launch)
KERNELS = [("fwd_a", 130, 10, R, 115),      # train.forward itself
           ("gemm", 160, 20, R, 160),       # moe.ffn in the forward
           ("fwd_b", 250, 10, R, 250),      # train.forward, after lm.unit
           # idle 260-330: the host is inside train.forward at its start
           ("attn_re", 330, 20, A, 330),    # lm.unit under train.backward
           ("grad_add", 410, 10, A, 405),   # autograd's thread, no span: the
           #                                  recording thread's backward
           ("gemm", 425, 20, A, 425),       # moe.ffn under train.backward
           ("adam", 720, 40, R, 720),       # train.optimizer
           ("cast", 885, 5, R, 885),        # train.step itself
           ("batch", 950, 5, R, 950),       # no program span: the harness
           ("copy", 960, 5, None, None)]    # no launch event


def _slice(counters=None, spans=SPANS, kernels=KERNELS, clock=CLOCK,
           tie_record=True):
    """The program over a slice from host 100 to 1000, the tie marker
    launched at host 50 (its device record lost where ``tie_record`` is
    false), charged as ``profile_slice`` charges it."""
    record = SimpleNamespace(spans=spans, thread=R,
                             threads={R: 11, A: 12}, counters=counters or {})
    device = [(M, 60 + clock, 1, 1)] if tie_record else []
    launches = {1: ("cudaLaunchKernel", 50 + clock, R & 0xFFFFFFFF)}
    for corr, (name, start, dur, thread, t) in enumerate(kernels, 2):
        device.append((name, start + clock, dur, corr))
        if thread is not None:
            # the runtime event's thread id: the low 32 bits, signed
            tid = thread & 0xFFFFFFFF
            launches[corr] = ("cudaLaunchKernel", t + clock,
                              tid - (1 << 32) if tid >> 31 else tid)
    device.sort(key=lambda e: e[1])
    return program.attribute(device, launches, record, HARNESS, 50, 100,
                             1000)


def test_kernels_are_charged_to_the_span_open_on_their_launching_thread():
    p = _slice()
    own = {i: round(s * 1e9) for i, s in p.own_s.items()}
    assert own == {1: 20, 3: 20, 5: 20, 4: 10, 6: 20, 7: 40, 0: 5}
    assert round(p.outside_s * 1e9) == 5 and round(p.unlaunched_s * 1e9) == 5
    assert p.count("train.step") == 1 and p.count("lm.unit") == 2
    ns = lambda *a, **kw: round(p.seconds(*a, **kw) * 1e9)  # noqa: E731
    assert ns("train.forward") == 40
    assert ns("train.backward") == 50
    assert ns(("lm.unit", "moe.ffn"), under="train.backward") == 40
    assert ns(("lm.unit", "moe.ffn")) == 60          # nested: counted once
    assert ns("train.step") == 135


def test_the_clock_is_tied_through_the_tie_markers_runtime_event():
    """Another profiler clock, or the tie marker's device record lost:
    nothing moves.  Launches 300 ns later against the tie move kernels to
    other spans."""
    base = _slice().own_s
    assert _slice(clock=CLOCK + 12345).own_s == base
    assert _slice(tie_record=False).own_s == base
    late = [k[:4] + (k[4] + 300 if k[4] is not None else None,)
            for k in KERNELS]
    assert _slice(kernels=late).own_s != base


def test_idle_gaps_carry_the_program_span_open_at_their_start():
    """Each gap takes the innermost program span open on any thread when
    it starts; the harness's labels stay where no program span is open."""
    assert [(round(s * 1e9), label) for s, label in _slice().gaps] == [
        (30, "train.step"),          # 100: the step opened
        (20, "lm.unit"),             # 140
        (70, "moe.ffn"),             # 180
        (70, "train.forward"),       # 260: lm.unit closed, forward open
        (60, "lm.unit"),             # 350: autograd's thread's recompute
        (5, "moe.ffn"),              # 420
        (275, "moe.ffn"),            # 445
        (125, "train.optimizer"),    # 760
        (60, "train.step"),          # 890
        (5, "train_step"),           # 955: after the step, the harness's
        (35, "train_step")]          # 965
    bare = _slice(spans=[])
    assert [s for s, _ in bare.gaps] == [s for s, _ in _slice().gaps]
    assert {label for _, label in bare.gaps} == {"train_step"}


COUNTS = {"moe.assignments": 1000, "moe.kept": 950, "moe.slots": 1250}


def test_the_readings_of_the_programs_spans_and_counters():
    got = program.readings(_slice(COUNTS))
    want = {"forward_ms": 40e-6, "recompute_ms": 40e-6, "backward_ms": 10e-6,
            "moe_slot_fill": 76.0, "moe_drop_share": 5.0}
    assert got == pytest.approx(want, rel=1e-9)
    # slot fill x slots = kept; kept + dropped = assignments
    fill, drop = got["moe_slot_fill"] / 100, got["moe_drop_share"] / 100
    assert fill * COUNTS["moe.slots"] == pytest.approx(COUNTS["moe.kept"])
    assert COUNTS["moe.kept"] + drop * COUNTS["moe.assignments"] == \
        pytest.approx(COUNTS["moe.assignments"])


DENSE = [s for s in SPANS if s[0] not in ("lm.unit", "moe.ffn")]


def test_a_dense_remat_free_run_reads_none_where_nothing_applies():
    got = program.readings(_slice(spans=DENSE))
    assert got["forward_ms"] > 0 and got["backward_ms"] > 0
    assert got["recompute_ms"] is got["moe_slot_fill"] is \
        got["moe_drop_share"] is None
    # a program without the recorder reads nothing
    assert set(program.readings(None).values()) == {None}
