"""The pipeline-staged (1F1B) train step realized on a stage-factored mesh
of four gloo ranks against the single-process port: the counterpart of
``tests/test_stages.py``'s eight-device staged step.

  (a) reduced llama3.2 under the plan searched for the four ranks with
      two stages and four microbatches (the train command's mesh, data 4
      x model 1, from which the search factors the stages out), realized
      on the ``(stage 2, data 2, model 1)`` mesh with the stack's unit
      dim split over ``stage``: every stack leaf is placed ``Shard(0)``
      there, and one step gives the single-process unstaged step's loss
      within 2e-5 relative (the reference test's), its gradient norm
      within 1e-5 relative, its AdamW first moments within 1e-4 of each
      leaf's largest entry (``test_torch_train.py``'s gradient tolerance)
      and its parameters within ``test_torch_realize.py``'s atol 2e-4 /
      rtol 2e-3;
  (b) the train command under a torchrun-style environment of four ranks
      with ``--pipeline-stages 2 --microbatches 4`` prints the pipeline
      and the mesh it runs on, and the losses of the plan-free
      single-process run within 2e-5 relative.

The ranks run this file (``__main__``) and rendezvous through a file
under the test's temporary directory, with ``OMP_NUM_THREADS=1`` and a
timeout on every subprocess (``test_torch_realize._spawn``).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

HERE = Path(__file__).resolve()
B, S, M = 8, 16, 4
LOSS_REL = 2e-5            # tests/test_stages.py's staged-loss tolerance
GNORM_REL = 1e-5           # test_torch_train.py's metric tolerance
MOMENT_TOL = 1e-4          # test_torch_train.py's gradient tolerance
ATOL, RTOL = 2e-4, 2e-3    # test_torch_realize.py's parameter tolerances


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _setup():
    """(arch, params, batch), seeded, on the CPU."""
    from repro_torch import configs as TC
    from repro_torch.models import init_params
    arch = TC.reduced("llama3_2_1b")
    params = init_params(arch, torch.float32,
                         generator=torch.Generator().manual_seed(0),
                         device=torch.device("cpu"))
    tokens = torch.randint(0, arch.vocab, (B, S),
                           generator=torch.Generator().manual_seed(1))
    return arch, params, {"tokens": tokens}


def _rank_main(d):
    from repro_torch.core import use_mesh
    from repro_torch.launch.mesh import init_distributed, train_mesh
    from repro_torch.plans import ParallelPlan, gather
    from repro_torch.train import TrainConfig, make_train_step, realize

    torch.set_num_threads(1)
    rank, world = init_distributed(torch.device("cpu"))
    arch, params, batch = _setup()
    pplan = ParallelPlan.load(d / "plan.json", arch=arch)
    stages = pplan.stage_for("train")
    mesh = train_mesh(world, "cpu", stages)
    dp, st, place_batch = realize(params, arch, pplan.plan_for("train"),
                                  mesh, stages=stages)
    placements = {k: [str(p) for p in v.placements]
                  for k, v in _flat(dp["stack"]).items()}
    step = make_train_step(arch, pplan, TrainConfig())
    with use_mesh(mesh):
        dp, st, met = step(dp, st, place_batch(batch))
    full, m = gather(dp), gather(st["m"])
    if rank == 0:
        np.savez(d / "params.npz", **{k: v.numpy()
                                      for k, v in _flat(full).items()})
        np.savez(d / "moments.npz", **{k: v.numpy()
                                       for k, v in _flat(m).items()})
    (d / f"out-{rank}.json").write_text(json.dumps({
        "mesh": list(mesh.mesh_dim_names), "shape": list(mesh.mesh.shape),
        "placements": placements,
        "metrics": {k: float(v) for k, v in met.items()}}))
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def staged_run(tmp_path_factory):
    from repro_torch.launch.mesh import train_mesh_spec
    from repro_torch.optim import adamw_init
    from repro_torch.plans import build_parallel_plan
    from repro_torch.train import TrainConfig, make_train_step
    from test_torch_realize import _spawn
    d = tmp_path_factory.mktemp("staged")
    arch, params, batch = _setup()
    plan = build_parallel_plan(arch, train_mesh_spec(4), phases=("train",),
                               strategy="searched", train_seq=S,
                               train_batch=B, train_stages=2,
                               train_microbatches=M)
    plan.save(d / "plan.json")
    p1, st1, met = make_train_step(arch, None, TrainConfig())(
        params, adamw_init(params), batch)
    _spawn(d, [sys.executable, str(HERE), str(d)])
    outs = [json.loads((d / f"out-{r}.json").read_text()) for r in range(4)]
    return dict(d=d, outs=outs, plan=plan,
                single={k: float(v) for k, v in met.items()},
                params={k: v.numpy() for k, v in _flat(p1).items()},
                moments={k: v.numpy() for k, v in _flat(st1["m"]).items()})


def test_stack_is_split_over_the_stage_axis(staged_run):
    stages = staged_run["plan"].stage_for("train")
    assert stages.num_stages == 2 and stages.microbatches == M
    assert stages.boundaries == (0, 1, 2)
    for out in staged_run["outs"]:
        assert out["mesh"] == ["stage", "data", "model"]
        assert out["shape"] == [2, 2, 1]
        assert out["placements"]
        for path, pl in out["placements"].items():
            assert pl[0] == "S(0)", (path, pl)      # Shard(0) on stage


def test_staged_step_on_the_mesh_matches_single_process(staged_run):
    want = staged_run["single"]
    for out in staged_run["outs"]:
        got = out["metrics"]
        assert got == staged_run["outs"][0]["metrics"]
        assert abs(got["loss"] - want["loss"]) <= LOSS_REL * abs(
            want["loss"]), (got["loss"], want["loss"])
        assert abs(got["grad_norm"] - want["grad_norm"]) <= GNORM_REL * abs(
            want["grad_norm"]), (got["grad_norm"], want["grad_norm"])
    d = staged_run["d"]
    with np.load(d / "moments.npz") as z:
        assert sorted(z.files) == sorted(staged_run["moments"])
        for k, want_m in staged_run["moments"].items():
            bound = MOMENT_TOL * max(float(np.abs(want_m).max()), 1e-30)
            assert float(np.abs(z[k] - want_m).max()) <= bound, k
    with np.load(d / "params.npz") as z:
        assert sorted(z.files) == sorted(staged_run["params"])
        for k, want_p in staged_run["params"].items():
            np.testing.assert_allclose(z[k], want_p, atol=ATOL, rtol=RTOL,
                                       err_msg=k)


def test_train_command_runs_a_staged_plan_on_four_ranks(tmp_path):
    from repro_torch.launch.train import main as train_main
    from test_torch_realize import _spawn
    args = ["--device", "cpu", "--arch", "llama3.2-1b", "--steps", "3",
            "--batch", str(B), "--seq", str(S), "--width", "64", "--depth",
            "2", "--vocab", "64", "--log-every", "1", "--ckpt-every", "0"]
    want = train_main(args + ["--strategy", "uniform"])
    stdout = _spawn(tmp_path, [
        sys.executable, "-m", "repro_torch.launch.train", *args,
        "--strategy", "search", "--pipeline-stages", "2", "--microbatches",
        str(M), "--metrics-out", str(tmp_path / "m.json")])
    assert f"train: pipeline S=2 M={M} boundaries=(0, 1, 2)" in stdout
    assert "mesh: stage=2 data=2 model=1 (4 ranks, gloo)" in stdout
    got = json.loads((tmp_path / "m.json").read_text())
    assert [g["step"] for g in got] == [w["step"] for w in want]
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= LOSS_REL * abs(w["loss"]), (
            g, w)


if __name__ == "__main__":
    _rank_main(Path(sys.argv[1]))
