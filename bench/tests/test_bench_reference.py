"""The reference agrees with the port at tiny sizes, and the check of
the training cell fails what it has to: each fault planted in the timed
path, and the control (the reference in TF32 put in the program's
place).

Each test drives the rest of a run, past the harness's look for a
chip, on a tiny copy of the cell (``conftest.make_tiny_root``) under the
cell's own limits."""

import time

import pytest

from bench import core
from bench.kinds import train

torch = pytest.importorskip("torch")
CPU = torch.device("cpu")
CELL = "olmoe-train-d8"


def _run(root, cell, seed, device=CPU, options=None):
    run = core.Run(core.Cell(cell, root), seed, 1.0, False,
                   time.perf_counter())
    return run, run.cell.driver().run(run, device, options or {})


def test_the_port_agrees_with_the_reference(tiny_root):
    run, out = _run(tiny_root, CELL, 2**31 + 17)
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0
    metrics = core.compute_metrics(run, False)
    assert {m["name"] for m in run.cell.metrics(False)} == set(metrics)


@pytest.mark.parametrize("fault", ["frozen_state", "half_batch"])
def test_a_planted_fault_makes_the_run_incorrect(tiny_root, fault):
    _, out = _run(tiny_root, CELL, 5, options={"fault": fault})
    assert not out.correct, out.checks


def _fails_a_limit(values, limits):
    return any(values[k] > limits[k] for k in limits)


def test_the_train_control_fails_the_check(card_root):
    # at width 64 the TF32 round-off of a 2-layer model is too small to
    # stand for the cell's; width 256 (head dim 64) is
    run = core.Run(core.Cell(CELL, card_root), 8, 1.0, False, 0.0)
    values = train.control(run, CPU)["values"]
    assert _fails_a_limit(values, run.cell.limits), values


def test_the_reference_drops_assignments_past_capacity():
    from bench.reference import moe_lm
    cfg = {"capacity_factor": 1.25, "num_experts_per_tok": 8,
           "num_experts": 64}
    assert moe_lm.capacity(256, cfg) == 40
    assert moe_lm.capacity(1, cfg) == 8


def test_the_reference_follows_a_routing_and_judges_it(tiny_root):
    from bench import gen, weights
    cell = core.Cell(CELL, tiny_root)
    cfg = cell.config
    model = core.reference(cfg).Model(cfg, weights.make(cfg, 3, CPU))
    tokens = gen.TokenBatches(cell.traffic, cfg["vocab_size"], 3, CPU).next()
    own = float(model.loss(tokens))
    taken = model.taken
    assert model.route_gap == 0.0 and len(taken) == cfg["num_hidden_layers"]

    model.routes, model.taken = taken, []
    assert float(model.loss(tokens)) == own and model.route_gap == 0.0

    # one row of the last layer sent to the expert its router ranks last
    probs_last = None
    moved = [t.clone() for t in taken]
    model.routes, model.taken = moved, []
    real = model.moe

    def spy(mp, x, cap):
        nonlocal probs_last
        probs_last = torch.softmax(model.mm(x.reshape(-1, x.shape[-1]),
                                            mp["router"]), -1)
        return real(mp, x, cap)
    model.moe = spy
    model.loss(tokens)
    worst = int(probs_last[0].argmin())
    moved[-1][0, 0, -1] = worst
    model.routes, model.taken, model.route_gap = moved, [], 0.0
    model.loss(tokens)
    kth = float(torch.topk(probs_last[0], cfg["num_experts_per_tok"]).values[-1])
    assert model.route_gap == pytest.approx(kth - float(probs_last[0, worst]))

    model.routes, model.taken, model.route_gap = [t[:2] for t in taken], [], 0.0
    model.loss(tokens)
    assert model.route_gap == 1.0


@pytest.mark.cuda
def test_the_port_agrees_with_the_reference_on_the_card(card_root, cuda):
    _, out = _run(card_root, CELL, 2**31 + 29, device=cuda)
    assert out.correct, out.checks
