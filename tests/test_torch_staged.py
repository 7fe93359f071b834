"""The port's pipeline-staged (1F1B) train step against the reference's on
the CPU, with the reference's weights moved across by the bridge: the
counterparts of ``tests/test_stages.py``'s staged-step tests.

  * reduced llama3.2 under the plan searched with two stages and four
    microbatches on the data 4 x model 2 modelled mesh, batch 8 x 64: the
    port's stage boundaries are the reference's, and one step of the
    port's staged step matches the reference's jitted staged step
    (``kernel_backend="xla"``) and the port's own unstaged step;
  * hand-made stage assignments for reduced llama3.2 (a tied embedding,
    whose gradient the first and the last stage share), olmoe (the MoE
    balancing loss in every stage), rwkv6 and internvl2 (a frontend
    before the text in stage 0): three stages over depth 3, so a middle
    stage runs, with four microbatches and with one (fewer than
    ``S - 1``: the warmup's ``min``);
  * the refusals: an encoder-decoder, a stage assignment over another
    unit count, a batch that does not split into the microbatches.

Tolerances are the reference test's: loss, nll and the balancing loss
within 2e-5 relative, every parameter after the AdamW step within 1e-5
(at step 1 the default schedule's learning rate is 3e-6, so even a
gradient whose sign the order of the sums decides moves its parameter
by at most 6e-6 either way).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import configs as RC
from repro.core import AxisSpec as RAxisSpec
from repro.core import ICI_BW as RICI_BW
from repro.core import MeshSpec as RMeshSpec
from repro.core.stages import StageAssignment as RStageAssignment
from repro.data import make_dataset as jmake_dataset
from repro.models import lm as jlm
from repro.models.arch import ShapeSpec as JShapeSpec
from repro.optim import adamw_init as jadamw_init
from repro.plans import ParallelPlan as RParallelPlan
from repro.plans import build_parallel_plan as rbuild_parallel_plan
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as jmake_train_step
from repro_torch import configs as TC
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.core import ICI_BW, TPU_V5E, AxisSpec, MeshSpec
from repro_torch.core.stages import StageAssignment
from repro_torch.models import init_params
from repro_torch.optim import adamw_init
from repro_torch.plans import ParallelPlan, build_parallel_plan
from repro_torch.train import TrainConfig, make_train_step

LOSS_REL = 2e-5
PARAM_TOL = 1e-5
RMESH = RMeshSpec(axes=(RAxisSpec("data", 4, RICI_BW),
                        RAxisSpec("model", 2, RICI_BW)))
MESH = MeshSpec(axes=(AxisSpec("data", 4, ICI_BW),
                      AxisSpec("model", 2, ICI_BW)), chip=TPU_V5E)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _metrics_close(got, want, keys=("loss", "nll")):
    for k in keys:
        w = float(want[k])
        assert abs(float(got[k]) - w) <= LOSS_REL * max(abs(w), 1e-6), (
            k, float(got[k]), w)


def _params_close(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    diff = {k: float(np.abs(got[k] - want[k]).max()) for k in want}
    assert max(diff.values()) < PARAM_TOL, max(diff.items(),
                                               key=lambda kv: kv[1])


def _port_step(arch, plan, params, batch, **cfg):
    """One port step on a copy of the (numpy) ``params``; returns (params
    as numpy, metrics as floats)."""
    tp = params_from_jax(params, "cpu")
    tp, _, met = make_train_step(arch, plan, TrainConfig(**cfg))(
        tp, adamw_init(tp), {k: torch.from_numpy(np.array(v))
                             for k, v in batch.items()})
    return params_to_numpy(tp), {k: float(v) for k, v in met.items()}


def _jax_step(arch, plan, params, batch, **cfg):
    jp = jax.tree.map(jnp.asarray, params)
    jp, _, met = jax.jit(jmake_train_step(arch, plan, JTrainConfig(
        kernel_backend="xla", **cfg)))(
        jp, jadamw_init(jp), {k: jnp.asarray(v) for k, v in batch.items()})
    return (jax.tree.map(np.asarray, jp),
            {k: float(v) for k, v in met.items()})


# --------------------------------------------------------------------------- #
# the searched two-stage plan (tests/test_stages.py:236)
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def searched():
    arch, rarch = TC.reduced("llama3_2_1b"), RC.reduced("llama3_2_1b")
    kw = dict(strategy="searched", phases=("train",), train_seq=64,
              train_batch=8)
    staged = dict(train_stages=2, train_microbatches=4)
    plans = {"port2": build_parallel_plan(arch, MESH, **kw, **staged),
             "port1": build_parallel_plan(arch, MESH, **kw),
             "ref2": rbuild_parallel_plan(rarch, RMESH, **kw, **staged)}
    params = jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(0),
                                                  rarch, jnp.float32))
    batch = {"tokens": np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (8, 64), 0, rarch.vocab))}
    return arch, rarch, plans, params, batch


def test_searched_stage_boundaries_are_the_references(searched):
    _, _, plans, _, _ = searched
    got, want = plans["port2"].stage_for("train"), plans["ref2"].stage_for(
        "train")
    assert got.num_stages == 2
    assert (got.boundaries, got.microbatches, got.mesh_axis) == (
        want.boundaries, want.microbatches, want.mesh_axis)
    assert plans["port1"].stage_for("train").num_stages == 1


def test_searched_staged_step_matches_the_reference(searched):
    arch, rarch, plans, params, batch = searched
    got_p, got_m = _port_step(arch, plans["port2"], params, batch)
    want_p, want_m = _jax_step(rarch, plans["ref2"], params, batch)
    _metrics_close(got_m, want_m)
    _params_close(got_p, want_p)


def test_searched_staged_step_matches_the_unstaged_step(searched):
    arch, _, plans, params, batch = searched
    got_p, got_m = _port_step(arch, plans["port2"], params, batch)
    want_p, want_m = _port_step(arch, plans["port1"], params, batch)
    _metrics_close(got_m, want_m)
    _params_close(got_p, want_p)


# --------------------------------------------------------------------------- #
# hand-made stage assignments: a middle stage, and fewer microbatches than
# warmup slots
# --------------------------------------------------------------------------- #
def _staged(plan_cls, stage_cls, arch, boundaries, m):
    base = plan_cls.uniform(arch, phases=("train",))
    return plan_cls(arch=base.arch, phases=base.phases, mesh=base.mesh,
                    meta=base.meta,
                    stages={"train": stage_cls(boundaries, microbatches=m)})


def _depth3(pkg, name):
    arch = pkg.reduced(name)
    return dataclasses.replace(arch, n_layers=3 * arch.period)


@pytest.mark.parametrize("m", [4, 1], ids=["M4", "M1"])
@pytest.mark.parametrize("name", ["llama3_2_1b", "olmoe_1b_7b", "rwkv6_1b6",
                                  "internvl2_76b"])
def test_three_stages_match_the_reference(name, m):
    arch, rarch = _depth3(TC, name), _depth3(RC, name)
    assert arch.n_units == 3
    params = jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(0),
                                                  rarch, jnp.float32))
    seq = 16 + (rarch.frontend_tokens if rarch.frontend else 0)
    batch = jmake_dataset(rarch, JShapeSpec("t", seq, 4, "train")).batch_at(0)
    assert ("frontend" in batch) == bool(rarch.frontend)
    cfg = dict(time_chunk=4, loss_chunk=5)
    got_p, got_m = _port_step(
        arch, _staged(ParallelPlan, StageAssignment, arch, (0, 1, 2, 3),
                      m), params, batch, **cfg)
    want_p, want_m = _jax_step(
        rarch, _staged(RParallelPlan, RStageAssignment, rarch,
                       (0, 1, 2, 3), m), params, batch, **cfg)
    _metrics_close(got_m, want_m, ("loss", "nll", "aux"))
    if rarch.n_experts:
        assert want_m["aux"] > 0
    _params_close(got_p, want_p)


# --------------------------------------------------------------------------- #
# refusals (tests/test_stages.py:219 and the step's own)
# --------------------------------------------------------------------------- #
def test_staged_step_refuses_an_encoder_decoder():
    arch = TC.reduced("seamless_m4t_v2")
    plan = _staged(ParallelPlan, StageAssignment, arch,
                   (0, arch.n_units // 2 or 1, arch.n_units), 2)
    with pytest.raises(ValueError, match="decoder-only"):
        make_train_step(arch, plan, TrainConfig())


def test_staged_step_refuses_another_unit_count():
    arch = TC.reduced("llama3_2_1b")
    plan = _staged(ParallelPlan, StageAssignment, arch, (0, 1, 3), 2)
    with pytest.raises(ValueError, match="covers 3 units but .* has 2"):
        make_train_step(arch, plan, TrainConfig())


def test_staged_step_refuses_an_indivisible_batch():
    arch = TC.reduced("llama3_2_1b")
    plan = _staged(ParallelPlan, StageAssignment, arch, (0, 1, 2), 4)
    step = make_train_step(arch, plan, TrainConfig())
    p = init_params(arch, torch.float32,
                    generator=torch.Generator().manual_seed(0),
                    device=torch.device("cpu"))
    with pytest.raises(ValueError, match="batch 6 not divisible by "
                                         "microbatches 4"):
        step(p, adamw_init(p), {"tokens": torch.zeros(6, 8,
                                                      dtype=torch.int32)})
