"""The port's device profiles (``repro_torch.profiling``) against the
reference's (``tests/test_profiling.py``): the alpha-beta fit, the JSON
round trip and its refusals, calibration field by field, the kernel
factors, the no-profile bit-identity over every arch, and the profile's
provenance in a searched plan.  Then the two packages on one profile: a
profile either writes loads in the other with the same ``calibrate_mesh``,
``kernel_factors`` and fingerprint; ``CostModel.from_profile`` prices
every node of reduced llama3.2's graph the same (rel 1e-12) and the
search under it picks the same plan.  Then the measuring side on the
CPU: ``build_profile`` and ``launch.profile`` at the smoke ladders, the
per-layer report, and, on two gloo ranks in subprocesses, the collective
sweep (a curve per kind) and both commands under ``--device-profile``
(the searched plan's meta carries the fingerprint).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import (ICI_BW, AxisSpec, CostModel,  # noqa: E402
                              LayerConfig, MeshSpec, find_strategy)
from repro_torch.core.device import COLLECTIVE_KINDS  # noqa: E402
from repro_torch.models.graph_export import (export_graph,  # noqa: E402
                                             phase_shape)
from repro_torch.profiling import (CollectiveCurve,  # noqa: E402
                                   DeviceProfile, ProfileFormatError,
                                   fit_alpha_beta)

ROOT = Path(__file__).resolve().parent.parent
MESH = MeshSpec(axes=(AxisSpec("data", 4, ICI_BW),
                      AxisSpec("model", 2, ICI_BW)))
REL = 1e-12


def _profile(pkg=None, **kw):
    """A synthetic measured profile: slow chip, latency-heavy links (the
    reference's), built by the port or by ``pkg`` (``repro.profiling``)."""
    mod = pkg or sys.modules["repro_torch.profiling"]
    base = dict(
        device_kind="TestChip v0",
        measured_flops=1e12,
        measured_hbm_bw=1e11,
        collectives={
            "data": {k: mod.CollectiveCurve(k, alpha=25e-6, bw=2e10,
                                            sizes=(1024.0, 4096.0),
                                            times=(3e-5, 5e-5))
                     for k in COLLECTIVE_KINDS},
            "model": {k: mod.CollectiveCurve(k, alpha=5e-6, bw=4e10)
                      for k in COLLECTIVE_KINDS},
        },
        kernel_times={("flash_attention", "xla", "small"): 1e-3,
                      ("flash_attention", "ref", "small"): 2.5e-3,
                      ("mamba_scan", "xla", "small"): 4e-4},
        meta={"jax": "test", "platform": "cpu"},
    )
    base.update(kw)
    return mod.DeviceProfile(**base)


def _rmesh():
    from repro.core import AxisSpec as RAxisSpec
    from repro.core import MeshSpec as RMeshSpec
    return RMeshSpec(axes=tuple(RAxisSpec(a.name, a.size, a.bw)
                                for a in MESH.axes))


def _mesh_sig(m):
    return ([(a.name, a.size, a.bw, a.curves) for a in m.axes],
            (m.chip.name, m.chip.mxu_efficiency, m.chip.hbm_efficiency))


# ---------------------------------------------------------------- fit


def test_fit_alpha_beta_recovers_known_curve():
    from repro.profiling import fit_alpha_beta as rfit
    alpha, bw = 12e-6, 3.5e10
    sizes = [2.0**k for k in range(14, 23)]
    times = [alpha + s / bw for s in sizes]
    a, b = fit_alpha_beta(sizes, times)
    assert a == pytest.approx(alpha, rel=1e-6)
    assert b == pytest.approx(bw, rel=1e-6)
    assert (a, b) == rfit(sizes, times)


def test_fit_alpha_beta_degrades_gracefully():
    # constant times (pure latency): no negative bandwidth out of the fit
    sizes = [1e3, 1e4, 1e5]
    a, b = fit_alpha_beta(sizes, [1e-4, 1e-4, 1e-4])
    assert a >= 0.0 and b > 0.0
    # through-origin data must not fit a negative alpha
    a, b = fit_alpha_beta(sizes, [s / 1e9 for s in sizes])
    assert a >= 0.0 and b == pytest.approx(1e9, rel=1e-6)
    # a single rung (or none) cannot be fit: refuse, don't guess
    with pytest.raises(ValueError):
        fit_alpha_beta([4096.0], [1e-5])
    with pytest.raises(ValueError):
        fit_alpha_beta([4096.0, 4096.0], [1e-5, 2e-5])


def test_curve_predict_matches_model():
    c = CollectiveCurve("all_reduce", alpha=1e-5, bw=1e9)
    assert c.predict(1e6) == pytest.approx(1e-5 + 1e6 / 1e9)
    with pytest.raises(ValueError):
        CollectiveCurve("not_a_collective", alpha=0.0, bw=1e9)
    with pytest.raises(ValueError):
        CollectiveCurve("all_reduce", alpha=0.0, bw=0.0)


# -------------------------------------------------------- persistence


def test_profile_json_round_trip(tmp_path):
    prof = _profile()
    again = DeviceProfile.from_json(prof.to_json())
    assert again == prof
    path = prof.save(tmp_path / "p.json")
    loaded = DeviceProfile.load(path)
    assert loaded == prof
    assert loaded.fingerprint() == prof.fingerprint()


def test_corrupt_profiles_rejected(tmp_path):
    garbage = tmp_path / "garbage.json"
    garbage.write_text("{not json at all")
    with pytest.raises(ProfileFormatError):
        DeviceProfile.load(garbage)
    with pytest.raises(ProfileFormatError):
        DeviceProfile.load(tmp_path / "missing.json")
    wrong_schema = tmp_path / "wrong_schema.json"
    wrong_schema.write_text(json.dumps({"schema": "something.else"}))
    with pytest.raises(ProfileFormatError):
        DeviceProfile.load(wrong_schema)
    good = _profile().to_json()
    bad_version = tmp_path / "bad_version.json"
    bad_version.write_text(json.dumps({**good, "version": 999}))
    with pytest.raises(ProfileFormatError):
        DeviceProfile.load(bad_version)
    broken = json.loads(json.dumps(good))
    broken["collectives"] = {"data": {"all_reduce": "nope"}}
    bad_body = tmp_path / "bad_body.json"
    bad_body.write_text(json.dumps(broken))
    with pytest.raises(ProfileFormatError):
        DeviceProfile.load(bad_body)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_profile_either_package_writes_loads_in_both(writer, tmp_path):
    """The JSON is the reference's field for field: the file one package
    writes loads in the other, with the same calibrated mesh, kernel
    factors and fingerprint (the port's adds its torch version only
    where the meta records one)."""
    import repro.profiling as rp
    made = _profile(rp if writer == "reference" else None,
                    meta={"jax" if writer == "reference" else "torch": "v",
                          "platform": "cpu"})
    path = made.save(tmp_path / "p.json")
    port, ref = DeviceProfile.load(path), rp.DeviceProfile.load(path)
    assert json.loads(path.read_text()) == port.to_json() == ref.to_json()
    assert _mesh_sig(port.calibrate_mesh(MESH)) == _mesh_sig(
        ref.calibrate_mesh(_rmesh()))
    assert port.kernel_factors() == ref.kernel_factors()
    want = ref.fingerprint()
    if writer == "port":
        want = {**want, "torch": "v"}
    assert port.fingerprint() == want


# -------------------------------------------------------- calibration


def test_calibrate_mesh_sets_measured_rates_and_curves():
    prof = _profile()
    cal = prof.calibrate_mesh(MESH)
    assert cal.chip.eff_flops == pytest.approx(1e12)
    assert cal.chip.eff_hbm_bw == pytest.approx(1e11)
    ax = cal.axis("data")
    assert ax.curve("all_reduce") == (pytest.approx(25e-6),
                                      pytest.approx(2e10))
    assert ax.bw == pytest.approx(2e10)
    assert prof.calibrate_mesh(cal) == cal


def test_field_by_field_analytic_fallback():
    base = MESH.chip
    cal = _profile(measured_hbm_bw=None).calibrate_mesh(MESH)
    assert cal.chip.eff_flops == pytest.approx(1e12)
    assert cal.chip.hbm_efficiency == base.hbm_efficiency
    cal = _profile(measured_flops=None).calibrate_mesh(MESH)
    assert cal.chip.mxu_efficiency == base.mxu_efficiency
    assert cal.chip.eff_hbm_bw == pytest.approx(1e11)
    cal = _profile(collectives={}).calibrate_mesh(MESH)
    for ax in cal.axes:
        assert ax.bw == ICI_BW and ax.curves == ()


def test_kernel_factors_normalize_to_fastest_backend():
    factors = _profile().kernel_factors()
    assert factors[("flash_attention", "xla")] == pytest.approx(1.0)
    assert factors[("flash_attention", "ref")] == pytest.approx(2.5)
    assert factors[("mamba_scan", "xla")] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TC.ALL_ARCHS)
def test_no_profile_costs_bit_identical(name):
    """Without a profile every cost is bit-identical to the analytic
    model: ``from_profile(None)`` and an empty profile price the same
    floats."""
    arch = TC.reduced(name)
    shape = phase_shape("train", seq_len=64, batch=8)
    if arch.skip_reason(shape):
        shape = phase_shape("decode", seq_len=64, batch=4)
    graph = export_graph(arch, shape)
    analytic = CostModel(MESH, phase=shape.kind)
    seamed = CostModel.from_profile(None, MESH, phase=shape.kind)
    strat = find_strategy(graph, MESH, phase=shape.kind)
    assert seamed.total_time(graph, strat) == analytic.total_time(
        graph, strat)
    for node in graph.nodes.values():
        cfg = strat.assignment[node.name]
        assert seamed.t_c(node, cfg) == analytic.t_c(node, cfg)
    empty = DeviceProfile(device_kind="Empty v0")
    from_empty = CostModel.from_profile(empty, MESH, phase=shape.kind)
    assert from_empty.total_time(graph, strat) == analytic.total_time(
        graph, strat)


def _graphs(phase):
    from repro import configs as RC
    from repro.models.graph_export import export_graph as rexport
    from repro.models.graph_export import phase_shape as rphase
    kw = dict(seq_len=64, batch=8) if phase == "train" else dict(
        seq_len=64, batch=4)
    return (export_graph(TC.reduced("llama3_2_1b"), phase_shape(phase, **kw)),
            rexport(RC.reduced("llama3_2_1b"), rphase(phase, **kw)))


@pytest.mark.parametrize("phase", ["train", "decode"])
def test_both_packages_price_and_search_the_same_under_one_profile(phase):
    """``CostModel.from_profile`` prices every node of reduced llama3.2's
    graph the same in both packages (rel 1e-12) under every config the
    search holds, with measured kernel factors in force; the searched
    plans are the same, per node, with the same cost."""
    import repro.profiling as rp
    from repro.core import CostModel as RCostModel
    from repro.core import find_strategy as rfind
    from repro.core.config import LayerConfig as RLayerConfig
    g, rg = _graphs(phase)
    prof, rprof = _profile(), _profile(rp)
    kb = {"flash_attention": "ref", "mamba_scan": "xla"}
    cm = CostModel.from_profile(prof, MESH, phase=phase, kernel_backends=kb)
    rcm = RCostModel.from_profile(rprof, _rmesh(), phase=phase,
                                  kernel_backends=kb)
    s = find_strategy(g, MESH, phase=phase, profile=prof)
    rs = rfind(rg, _rmesh(), phase=phase, profile=rprof)
    assert {n: (c.shards, c.fsdp) for n, c in s.assignment.items()} == {
        n: (c.shards, c.fsdp) for n, c in rs.assignment.items()}
    assert s.cost == pytest.approx(rs.cost, rel=REL, abs=0.0)
    assert s.meta["device_profile"] == rs.meta["device_profile"]
    cfgs = [LayerConfig.REPLICATED, LayerConfig.make(batch=("data",)),
            LayerConfig.make(batch=("data",), heads=("model",))]
    rcfgs = [RLayerConfig.REPLICATED, RLayerConfig.make(batch=("data",)),
             RLayerConfig.make(batch=("data",), heads=("model",))]
    for name, node in g.nodes.items():
        rnode = rg.nodes[name]
        pairs = list(zip(cfgs, rcfgs)) + [(s.assignment[name],
                                           rs.assignment[name])]
        for c, rc in pairs:
            for f in ("t_c", "t_s", "roofline_time"):
                a = getattr(cm, f)(node, c)
                b = getattr(rcm, f)(rnode, rc)
                assert a == pytest.approx(b, rel=REL, abs=0.0), (name, f)


def test_searched_plan_records_profile_provenance():
    arch = TC.reduced("llama3_2_1b")
    graph = export_graph(arch, phase_shape("train", seq_len=64, batch=8))
    strat = find_strategy(graph, MESH, phase="train", profile=_profile())
    assert strat.meta["device_profile"] == _profile().fingerprint()


def test_calibrated_mesh_survives_plan_codec(tmp_path):
    """A plan searched under a calibrated mesh round-trips the measured
    curves and chip efficiencies through its JSON."""
    from repro_torch.plans import ParallelPlan, build_parallel_plan
    arch = TC.reduced("llama3_2_1b")
    pp = build_parallel_plan(
        arch, MESH, strategy="searched", phases=("decode",),
        prompt_len=64, max_batch=8, max_len=128, profile=_profile())
    path = pp.save(tmp_path / "plan.json")
    loaded = ParallelPlan.load(path, arch=arch)
    assert loaded.meta["device_profile"] == _profile().fingerprint()
    assert (loaded.meta["phases"]["decode"]["device_profile"]
            == _profile().fingerprint())
    cal = _profile().calibrate_mesh(MESH)
    assert loaded.mesh.chip.eff_flops == pytest.approx(cal.chip.eff_flops)
    assert loaded.mesh.axis("data").curves == cal.axis("data").curves
    assert loaded.mesh.axis("data").bw == pytest.approx(
        cal.axis("data").bw)


# ---------------------------------------------------- measuring (CPU)


SMOKE = dict(matmul_sizes=(32, 64), stream_sizes=(1 << 16, 1 << 18),
             collective_sizes=(1 << 12, 1 << 14), repeats=2, warmup=1)


def test_build_profile_runs_on_the_cpu_at_the_smoke_ladders():
    """Every plain backend of every op timed through the dispatcher (no
    ``cuda`` entry off the card), the GEMM rate at float32 without TF32,
    no collective axis in one process; the result round-trips and
    calibrates."""
    from repro_torch.profiling import build_profile
    from repro_torch.profiling.microbench import KERNEL_OPS
    prof = build_profile(device="cpu", **SMOKE)
    assert prof.measured_flops > 0 and prof.measured_hbm_bw > 0
    assert prof.collectives == {}
    assert sorted(prof.kernel_times) == sorted(
        (op, b, "small") for op in KERNEL_OPS for b in ("ref", "xla"))
    assert prof.meta["matmul_dtype"] == "float32"
    assert prof.meta["allow_tf32"] is False
    assert prof.meta["platform"] == "cpu" and prof.device_kind == "cpu"
    assert DeviceProfile.from_json(prof.to_json()) == prof
    factors = prof.kernel_factors()
    assert all(min(f for (o, _), f in factors.items() if o == op) == 1.0
               for op in KERNEL_OPS)
    cal = prof.calibrate_mesh(MESH)
    assert cal.chip.eff_flops == pytest.approx(prof.measured_flops)


def test_profile_command_writes_the_profile(tmp_path, capsys):
    from repro_torch.launch import profile as cmd
    out = tmp_path / "p.json"
    prof = cmd.main(["--device", "cpu", "--smoke", "--out", str(out)])
    printed = capsys.readouterr().out
    assert "collective axes none" in printed
    assert f"profile: wrote {out}" in printed
    assert "(float32, tf32 off)" in printed
    assert DeviceProfile.load(out) == prof
    assert json.loads(printed.strip().splitlines()[-1]) == {
        "device_kind": "cpu", "kernel_entries": 10, "collective_axes": []}
    assert cmd.parse_axes("data=4, model=2") == {"data": 4, "model": 2}
    assert cmd.default_axes(1) == {} and cmd.default_axes(2) == {"data": 2}
    assert cmd.default_axes(8) == {"data": 4, "model": 2}


def test_layer_report_on_the_cpu():
    from repro_torch.profiling import format_layer_report, layer_report
    arch = TC.reduced("llama3_2_1b")
    graph = export_graph(arch, phase_shape("train", seq_len=16, batch=2))
    cm = CostModel(MESH, phase="train")
    rep = layer_report(graph, cm, repeats=1, warmup=0, device="cpu")
    assert rep["num_layers"] > 5
    assert all(r["measured_s"] > 0 and r["predicted_s"] > 0
               for r in rep["layers"])
    assert "median rel error" in format_layer_report(rep, limit=3)


# ------------------------------------------- two gloo ranks (subprocess)


def _rank_main(d: Path) -> None:
    """One of two ranks: the collective sweep over ``data``, then the
    profile command and both commands under ``--device-profile``."""
    import torch.distributed as dist

    from repro_torch.launch import profile as cmd
    from repro_torch.launch import serve, train
    from repro_torch.profiling import build_profile
    rank = int(os.environ["RANK"])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=2)
    prof = build_profile(axes={"data": 2}, kernel_ops=(), device="cpu",
                         **SMOKE)
    if rank == 0:
        prof.save(d / "prof.json")
    dist.barrier()
    cmd.main(["--device", "cpu", "--smoke", "--out", str(d / "cmd.json"),
              "--shape-classes", "small"])
    small = ["--device", "cpu", "--width", "64", "--depth", "2", "--vocab",
             "64", "--device-profile", str(d / "prof.json"),
             "--kernel-backend", "ref", "--autotune-cache-dir",
             str(d / "tune")]
    train.main(small + ["--steps", "1", "--batch", "4", "--seq", "16",
                        "--ckpt-every", "0", "--strategy", "searched",
                        "--save-plan", str(d / "train-plan.json")])
    serve.main(small + ["--batch", "2", "--requests", "2", "--prompt-len",
                        "8", "--gen", "2", "--kv-block-size", "4",
                        "--strategy", "searched", "--save-plan",
                        str(d / "serve-plan.json")])
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE="2", OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT / "src"))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(d)], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=400))
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return d, outs[0][0]


def test_collective_sweep_on_two_gloo_ranks(two_ranks):
    """A curve per kind over ``data``, from the rank-0 file and from the
    profile command (the serve-mesh axes of two ranks), each fitted to
    its ladder's wire bytes."""
    from repro_torch.profiling.microbench import _wire_bytes
    d, stdout = two_ranks
    for name in ("prof.json", "cmd.json"):
        prof = DeviceProfile.load(d / name)
        assert sorted(prof.collectives) == ["data"]
        curves = prof.collectives["data"]
        assert sorted(curves) == sorted(COLLECTIVE_KINDS)
        for kind, c in curves.items():
            assert c.alpha >= 0 and c.bw > 0
            ladder = [1 << 12, 1 << 14] if name == "prof.json" else [
                64 * 1024, 256 * 1024, 1024 * 1024]
            assert list(c.sizes) == [_wire_bytes(kind, 2, n)
                                     for n in ladder]
        assert prof.meta["num_devices"] == 2
    assert "profile: 2 device(s) [cpu], collective axes {'data': 2}" in stdout


def test_commands_record_the_profile_in_the_searched_plan(two_ranks):
    """``--device-profile`` on both commands under two ranks: the searched
    plan's meta carries the profile's fingerprint, and its mesh the
    measured rates and curves."""
    from repro_torch.plans import ParallelPlan
    d, stdout = two_ranks
    prof = DeviceProfile.load(d / "prof.json")
    arch_logged = "calibrates the cost model"
    assert stdout.count(arch_logged) == 2
    for name in ("train-plan.json", "serve-plan.json"):
        meta = json.loads((d / name).read_text())["meta"]
        assert meta["device_profile"] == prof.fingerprint()
        plan = ParallelPlan.from_json(json.loads((d / name).read_text()))
        assert plan.mesh.chip.eff_flops == pytest.approx(
            prof.measured_flops)
        assert plan.mesh.axis("data").curves == prof.calibrate_mesh(
            plan.mesh).axis("data").curves


if __name__ == "__main__":
    _rank_main(Path(sys.argv[1]))
