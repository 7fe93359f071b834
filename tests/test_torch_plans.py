"""The port's plan codec and plan resolution (``repro_torch.plans``,
``repro_torch.models.plan``) against the reference's on the CPU.

  * ``uniform_plan`` and ``strategy_to_plan`` give the reference's
    ModelPlan (as JSON) for every arch;
  * a plan the reference saved loads in the port and one the port saved
    loads in the reference: ModelPlan JSON, stages and arch fingerprint
    equal;
  * ``resolve_plan``'s log lines equal the reference's: the one-device
    degrade, a searched build on a mesh, the missing phase, and the mesh
    mismatch of a loaded plan;
  * the serve command's preset (``launch/serve.py::resolve_serve_plan``)
    prices decode as the reference's does: the same searched plans.

Then the port's departures: the H100 chip (its efficiencies too) survives
a save and load, a chip the registry does not know is refused, and a
device profile raises, naming its slice.
"""

import dataclasses
import json

import pytest
pytest.importorskip("torch")

from repro import configs as RC
from repro.core import AxisSpec as RAxisSpec
from repro.core import MeshSpec as RMeshSpec
from repro.core import find_strategy as rfind_strategy
from repro.models.graph_export import export_graph as rexport_graph
from repro.models.graph_export import phase_shape as rphase_shape
from repro.models.plan import strategy_to_plan as rstrategy_to_plan
from repro.models.plan import uniform_plan as runiform_plan
from repro.plans import ParallelPlan as RParallelPlan
from repro.plans import build_parallel_plan as rbuild_parallel_plan
from repro.plans import model_plan_to_json as rmodel_plan_to_json
from repro.plans import resolve_plan as rresolve_plan
from repro_torch import configs as TC
from repro_torch.core import (H100_SXM, TPU_V5E, find_strategy,
                              h100_mesh_spec)
from repro_torch.models.graph_export import export_graph, phase_shape
from repro_torch.models.plan import strategy_to_plan, uniform_plan
from repro_torch.plans import (ParallelPlan, PlanFormatError,
                               arch_fingerprint, build_parallel_plan,
                               model_plan_to_json, resolve_plan)

SHAPES = dict(train_seq=64, train_batch=8, prompt_len=32, max_batch=4,
              max_len=48)


def _meshes(m=(1, 2, 4)):
    """The 2 x 4 node with the reference's chip, in both packages."""
    pm = h100_mesh_spec(*m, chip=TPU_V5E)
    rm = RMeshSpec(axes=tuple(RAxisSpec(a.name, a.size, a.bw)
                              for a in pm.axes))
    return pm, rm


def _stages(plan):
    return {ph: (s.boundaries, s.microbatches, s.mesh_axis)
            for ph, s in plan.stages.items()}


def _comparable(plan):
    """A plan's JSON without the creator's version and search seconds, and
    its per-phase costs apart."""
    d = plan.to_json()
    d["meta"].pop("jax", None)
    d["meta"].pop("torch", None)
    phases = d["meta"]["phases"]
    costs = [phases[ph].pop("cost_s") for ph in sorted(phases)]
    for m in phases.values():
        m.pop("search_seconds")
    return d, costs


@pytest.mark.parametrize("name", TC.ALL_ARCHS)
def test_model_plans_match_reference(name):
    """The uniform plan, and the searched train strategy realized as a
    ModelPlan (segments grouped alike)."""
    arch, rarch = TC.reduced(name), RC.reduced(name)
    assert (model_plan_to_json(uniform_plan(arch))
            == rmodel_plan_to_json(runiform_plan(rarch)))
    pm, rm = _meshes()
    g = export_graph(arch, phase_shape("train", seq_len=64, batch=8))
    rg = rexport_graph(rarch, rphase_shape("train", seq_len=64, batch=8))
    plan = strategy_to_plan(find_strategy(g, pm, phase="train"), arch)
    rplan = rstrategy_to_plan(rfind_strategy(rg, rm, phase="train"), rarch)
    assert model_plan_to_json(plan) == rmodel_plan_to_json(rplan)
    assert arch_fingerprint(arch) == json.loads(json.dumps(
        arch_fingerprint(rarch)))


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("name", ["llama3_2_1b", "jamba_1_5_large",
                                  "seamless_m4t_v2"])
def test_plans_load_across_packages(tmp_path, name, writer):
    """A searched three-phase plan on a 2 x 4 mesh, saved by one package
    and loaded by the other (arch-checked): the same ModelPlans, stages,
    mesh and fingerprint."""
    arch, rarch = TC.reduced(name), RC.reduced(name)
    pm, rm = _meshes()
    path = tmp_path / "plan.json"
    if writer == "reference":
        saved = rbuild_parallel_plan(rarch, rm, **SHAPES)
        saved.save(path)
        got = ParallelPlan.load(path, arch=arch)
    else:
        saved = build_parallel_plan(arch, pm, **SHAPES)
        saved.save(path)
        got = RParallelPlan.load(path, arch=rarch)
    read_json, write_json = ((model_plan_to_json, rmodel_plan_to_json)
                             if writer == "reference" else
                             (rmodel_plan_to_json, model_plan_to_json))
    assert sorted(got.phases) == ["decode", "prefill", "train"]
    for ph in got.phases:
        assert read_json(got.phases[ph]) == write_json(saved.phases[ph])
    assert got.arch == saved.arch
    assert _stages(got) == _stages(saved)
    assert [(a.name, a.size, a.bw) for a in got.mesh.axes] == [
        (a.name, a.size, a.bw) for a in saved.mesh.axes]
    assert got.mesh.chip.name == saved.mesh.chip.name == "tpu_v5e"
    assert got.meta["strategy"] == "searched"
    # both packages' builds of the same request are the same plan
    other = (build_parallel_plan(arch, pm, **SHAPES) if writer == "reference"
             else rbuild_parallel_plan(rarch, rm, **SHAPES))
    (mine, costs), (theirs, rcosts) = _comparable(other), _comparable(saved)
    assert mine == theirs
    assert costs == pytest.approx(rcosts, rel=1e-12, abs=0.0)


def _resolve_logs(tmp_path, pkg, case):
    """(log lines, plan) of ``resolve_plan`` in package ``pkg`` for one
    case; file paths are the same for both packages."""
    rp = pkg == "reference"
    arch = RC.reduced("llama3_2_1b") if rp else TC.reduced("llama3_2_1b")
    pm, rm = _meshes()
    mesh = rm if rp else pm
    resolve = rresolve_plan if rp else resolve_plan
    build = rbuild_parallel_plan if rp else build_parallel_plan
    logs = []
    kw = dict(log=logs.append, **SHAPES)
    path = str(tmp_path / "p.json")       # the same name in both runs
    if case == "degrade":
        plan = resolve(arch, None, phases=("train",), strategy="searched",
                       save_plan=path, **kw)
    elif case == "search":
        plan = resolve(arch, mesh, strategy="searched", **kw)
    elif case == "missing-phase":
        build(arch, mesh, phases=("prefill", "decode"), **SHAPES).save(path)
        plan = resolve(arch, None, phases=("train", "decode"),
                       plan_path=path, **kw)
    else:                                 # mesh mismatch, int8 note
        build(arch, mesh, **SHAPES).save(path)
        plan = resolve(arch, None, phases=("prefill", "decode"),
                       plan_path=path, decode_kv_quant="int8", **kw)
    return logs, plan


@pytest.mark.parametrize("case", ["degrade", "search", "missing-phase",
                                  "mesh-mismatch"])
def test_resolve_plan_logs_what_the_reference_logs(tmp_path, case):
    rlogs, rplan = _resolve_logs(tmp_path, "reference", case)
    logs, plan = _resolve_logs(tmp_path, "port", case)
    assert logs == rlogs
    assert logs, case
    assert plan.strategy_name == rplan.strategy_name
    if case == "degrade":
        assert any("degrades to uniform" in line for line in logs)
    if case == "missing-phase":
        assert any("no 'train' phase" in line for line in logs)
    if case == "mesh-mismatch":
        assert any("plan searched for mesh" in line for line in logs)


@pytest.mark.parametrize("pool", [
    dict(kv_block_size=0, prefill_chunk_tokens=0),
    dict(kv_block_size=8, prefill_chunk_tokens=16, shared_prefix_tokens=24),
    dict(kv_block_size=8, prefill_chunk_tokens=16, kv_quant="int8")],
    ids=["dense-stall", "paged-shared", "paged-int8"])
def test_serve_plan_preset_matches_reference(pool):
    """The serve command's preset prices decode as the reference's does
    (the pool's depth, the shared prefix, the mixed step's query width,
    the int8 pool): the same searched prefill and decode plans."""
    from repro.launch.serve import resolve_serve_plan as rresolve_serve
    from repro_torch.launch.serve import resolve_serve_plan
    pm, rm = _meshes()
    kw = dict(strategy="searched", prompt_len=32, max_batch=4, max_len=48,
              **pool)
    plan = resolve_serve_plan(TC.reduced("llama3_2_1b"), pm, **kw)
    rplan = rresolve_serve(RC.reduced("llama3_2_1b"), rm, **kw)
    (d, costs), (rd, rcosts) = _comparable(plan), _comparable(rplan)
    assert d == rd
    assert costs == pytest.approx(rcosts, rel=1e-12, abs=0.0)
    assert plan.meta.get("kv_quant") == pool.get("kv_quant")


# --------------------------------------------------------------------------- #
# the port's departures
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("efficiencies", [None, (0.4, 0.7)],
                         ids=["spec", "calibrated"])
def test_h100_plan_keeps_its_chip(tmp_path, efficiencies):
    arch = TC.reduced("llama3_2_1b")
    mesh = h100_mesh_spec(2, 2, 4)
    if efficiencies:
        mesh = dataclasses.replace(mesh, chip=mesh.chip.calibrated(
            measured_flops=efficiencies[0] * H100_SXM.peak_flops,
            measured_hbm_bw=efficiencies[1] * H100_SXM.hbm_bw))
    plan = build_parallel_plan(arch, mesh, **SHAPES)
    assert plan.meta["torch"] and "jax" not in plan.meta
    got = ParallelPlan.load(plan.save(tmp_path / "h100.json"), arch=arch)
    assert got.mesh == mesh
    assert got.mesh.chip.name == "h100_sxm"
    assert got.mesh.chip.hbm_bytes == 80e9
    want = efficiencies or (H100_SXM.mxu_efficiency, H100_SXM.hbm_efficiency)
    assert (got.mesh.chip.mxu_efficiency,
            got.mesh.chip.hbm_efficiency) == pytest.approx(want, rel=1e-15)
    for ph in plan.phases:
        assert (model_plan_to_json(got.phases[ph])
                == model_plan_to_json(plan.phases[ph]))


def test_unknown_chip_is_refused(tmp_path):
    arch = TC.reduced("llama3_2_1b")
    data = build_parallel_plan(arch, h100_mesh_spec(1, 2, 4),
                               **SHAPES).to_json()
    data["mesh"]["chip"] = "a100_sxm"
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(data))
    with pytest.raises(PlanFormatError, match="a100_sxm"):
        ParallelPlan.load(path, arch=arch)


def test_device_profile_names_its_slice(tmp_path):
    """``profile_path`` loads a measured profile (the profiling slice has
    come): a file that is no profile is refused, naming it; a profile is
    logged as calibrating the cost model."""
    from repro_torch.profiling import DeviceProfile, ProfileFormatError
    arch = TC.reduced("llama3_2_1b")
    with pytest.raises(ProfileFormatError, match="profile.json"):
        resolve_plan(arch, None, profile_path=str(tmp_path / "profile.json"))
    path = DeviceProfile(device_kind="TestChip v0").save(
        tmp_path / "profile.json")
    logs = []
    plan = resolve_plan(arch, None, profile_path=str(path), log=logs.append)
    assert plan.strategy_name == "uniform"
    assert logs[0] == (f"plan: device profile {path} [TestChip v0] "
                       f"calibrates the cost model")
