"""The port's recorder (``repro_torch.tracing``) on the CPU, in a tiny
OLMoE-shaped train step:

* off (the default), the step records nothing and runs the same ops as
  on, less the counters' own (counted by ``launch/op_analysis.py``'s
  dispatch mode on meta tensors);
* on, the step's parameters and optimizer state are bitwise those of a
  step with it off;
* spans nest, and a span opened on another thread takes the recording
  thread's open span as its parent;
* ``moe.kept`` and ``moe.slots`` are a hand count from the router's
  expert indices, with remat on and off;
* ``lm.unit`` opens once a unit in the forward, and once more under
  ``train.backward`` with remat on.
"""

import contextlib
import dataclasses
import threading

import pytest
torch = pytest.importorskip("torch")

from repro_torch import configs as TC
from repro_torch import tracing
from repro_torch.launch.op_analysis import OpAccountant
from repro_torch.models import lm, moe
from repro_torch.optim import adamw_init
from repro_torch.train import TrainConfig, make_train_step

# capacity 8 a row and expert against 16 assignments an expert on
# average, so calls drop assignments; heads of 64, which the kernels'
# stand-ins on meta tensors take
ARCH = dataclasses.replace(TC.reduced("olmoe_1b_7b"), capacity_factor=0.25,
                           head_dim=64)
B, S = 2, 64


def _state(device="cpu"):
    if device == "meta":
        p = lm.init_lm(ARCH, generator=torch.Generator(), device="meta")
        tokens = torch.empty((B, S), dtype=torch.int64, device="meta")
    else:
        p = lm.init_lm(ARCH, generator=torch.Generator().manual_seed(0),
                       device="cpu")
        tokens = torch.randint(0, ARCH.vocab, (B, S),
                               generator=torch.Generator().manual_seed(1))
    return p, adamw_init(p), {"tokens": tokens}


def _names(rec):
    return [s[0] for s in rec.spans]


def _ops(record: bool) -> int:
    p, o, batch = _state("meta")
    step = make_train_step(ARCH, None, TrainConfig())
    acc = OpAccountant()
    with acc:
        if record:
            with tracing.recording():
                step(p, o, batch)
        else:
            step(p, o, batch)
    return acc.ops


def test_off_records_nothing_and_runs_the_same_ops():
    """Off, a span is the one shared no-op context and nothing is kept;
    on, the ops are off's plus the counters': per MoE forward call a sum,
    a clamp, a sum and the count's detach, and an add into the
    accumulator from the second call on."""
    assert tracing._active is None
    assert tracing.span("train.step") is tracing._OFF
    tracing.count("moe.kept", torch.ones(()))
    assert not tracing.counting()
    p, o, batch = _state()
    make_train_step(ARCH, None, TrainConfig())(p, o, batch)
    assert tracing._active is None
    calls = ARCH.n_units * sum(s.ffn == "moe" for s in ARCH.pattern)
    assert _ops(True) - _ops(False) == 4 * calls + (calls - 1)


def test_recording_leaves_the_step_bitwise_unchanged():
    out = []
    for record in (False, True):
        p, o, batch = _state()
        step = make_train_step(ARCH, None, TrainConfig())
        with tracing.recording() if record else contextlib.nullcontext():
            for _ in range(2):
                p, o, _m = step(p, o, batch)
        out.append((p, o))
    (p0, o0), (p1, o1) = out
    for tree0, tree1 in ((p0, p1), (o0["m"], o1["m"]), (o0["v"], o1["v"])):
        for (k, a), (_, b) in zip(lm.tree_leaves(tree0), lm.tree_leaves(tree1)):
            assert torch.equal(a, b), k
    assert torch.equal(o0["step"], o1["step"])


def test_spans_nest_and_a_second_thread_takes_the_recording_threads_span():
    with tracing.recording() as rec:
        with tracing.span("outer"):
            with tracing.span("inner"):
                pass

            def other():
                with tracing.span("away"):
                    with tracing.span("away.inner"):
                        pass
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        with tracing.span("after"):
            pass
    names = _names(rec)
    parent = {s[0]: (names[s[1]] if s[1] >= 0 else None) for s in rec.spans}
    assert parent == {"outer": None, "inner": "outer", "away": "outer",
                      "away.inner": "away", "after": None}
    threads = {s[0]: s[2] for s in rec.spans}
    assert threads["away"] == threads["away.inner"] != threads["outer"]
    assert set(rec.threads) == {threads["outer"], threads["away"]}
    for _, _, _, a, b in rec.spans:
        assert a <= b
    with pytest.raises(RuntimeError, match="already recording"):
        with tracing.recording():
            with tracing.recording():
                pass


def test_threads_record_every_span_and_count_under_contention():
    """More threads than cores, switching often: no span or count is lost
    and each thread's spans nest under its own or the recording thread's."""
    import os
    import sys
    n_threads, n = 4 * (os.cpu_count() or 1), 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording() as rec:
            with tracing.span("root"):
                def work():
                    for _ in range(n):
                        with tracing.span("a"):
                            with tracing.span("b"):
                                tracing.count("c", 1)
                threads = [threading.Thread(target=work)
                           for _ in range(n_threads)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=60)
                assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert rec.counters == {"c": n_threads * n}
    names = _names(rec)
    assert len(names) == 1 + 2 * n_threads * n
    for name, parent, thread, a, b in rec.spans:
        assert b is not None and a <= b
        if name == "b":
            assert names[parent] == "a" and rec.spans[parent][2] == thread
        elif name == "a":
            assert names[parent] == "root"


def test_counts_add_ints_and_tensors_once_read():
    with tracing.recording() as rec:
        tracing.count("n", 3)
        tracing.count("n", torch.tensor(4))
        tracing.count("t", torch.tensor(5))
        tracing.count("t", torch.tensor(6))
        assert rec.counters == {}
    assert rec.counters == {"n": 7, "t": 11}
    assert all(type(v) is int for v in rec.counters.values())


def _hand_count(p, batch):
    """(assignments, kept, slots) of one forward, from the router's expert
    indices: per row and expert, min(assignments, capacity)."""
    idx, real = [], moe.route

    def route(*a, **kw):
        out = real(*a, **kw)
        idx.append(out[1])
        return out
    moe.route = route
    try:
        with torch.no_grad():
            lm.loss_fn(p, batch, ARCH)
    finally:
        moe.route = real
    C = moe.capacity(S, ARCH)
    E, K = ARCH.n_experts, ARCH.top_k
    kept = 0
    for e in idx:
        for row in e.reshape(B, -1):
            kept += int(torch.bincount(row, minlength=E).clamp(max=C).sum())
    return len(idx) * B * S * K, kept, len(idx) * B * E * C


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_moe_counters_match_a_hand_count(remat):
    p, o, batch = _state()
    want = _hand_count(p, batch)
    with tracing.recording() as rec:
        make_train_step(ARCH, None, TrainConfig(remat=remat))(p, o, batch)
    c = rec.counters
    assert (c["moe.assignments"], c["moe.kept"], c["moe.slots"]) == want
    assert want[1] < want[0]           # capacity dropped some


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_unit_spans_open_in_the_forward_and_the_recompute(remat):
    p, o, batch = _state()
    with tracing.recording() as rec:
        make_train_step(ARCH, None, TrainConfig(remat=remat))(p, o, batch)
    names = _names(rec)
    under = {}
    for name, parent, *_ in rec.spans:
        under.setdefault(name, []).append(names[parent] if parent >= 0
                                          else None)
    assert under["train.step"] == [None]
    assert under["train.forward"] == under["train.backward"] == \
        under["train.optimizer"] == ["train.step"]
    n = ARCH.n_units
    assert under["lm.unit"] == ["train.forward"] * n + \
        ["train.backward"] * (n if remat else 0)
    # the MoE layer's own inner remat recomputes it under either setting
    assert under["moe.ffn"] == ["lm.unit"] * n + ["train.backward"] * n
