"""A realized plan on a 2 x 2 ``("data", "model")`` mesh of four gloo
ranks against the single-process port: the counterparts of
``tests/test_sharded_execution.py`` and ``tests/test_phase_plans.py``'s
sharded runs.

  (a) one AdamW step with ZeRO-1 moments under two train plans, the one
      searched for the mesh and the ``model`` baseline (heads, d_ff,
      experts and d_model split on the model axes whatever the search
      picks at these sizes), for reduced llama3.2, the same with one KV
      head (KV heads below the heads' degree: the replicated-KV GQA
      fallback), olmoe (expert parallelism), jamba (scan + MoE), rwkv6
      and seamless-m4t-v2, on the reference's weights (``bridge``): the
      loss within 5e-4 and the parameters within atol 2e-4 / rtol 2e-3
      (the reference's tolerances, ``test_sharded_execution.py``), both
      also against the reference's own one-step update (its jitted
      ``make_train_step`` and AdamW on the same weights and batch), the
      loss there at the port's train tolerance; the gradient norm against
      the single-process port's at that tolerance (reduced rwkv6 at 1e-3
      relative: its float32 gradients carry ~1e-4 of noise of their own,
      its group norm at the first token, ``test_torch_train.py``); and
      each rank's moment shards half the elements of its parameter shards
      where ZeRO-1 split them over data;
  (b) the reduced llama engine, paged chunked and dense, under the
      serve plan searched for the mesh and under the decode phase's
      ``model`` baseline (its 4 heads over both axes, grouped over 2 KV
      heads): tokens equal to single-process;
  (c) the train command under a torchrun-style environment of four ranks
      prints its mesh and the losses of the plan-free single-process run.

The ranks run this file (``__main__``), rendezvous through a file under
``tmp_path`` (never a fixed port), with ``OMP_NUM_THREADS=1`` and a
timeout on every subprocess.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

HERE = Path(__file__).resolve()
ROOT = HERE.parent.parent
CASES = [("llama3_2_1b", False), ("llama3_2_1b", True), ("olmoe_1b_7b", False),
         ("jamba_1_5_large", False), ("rwkv6_1b6", False),
         ("seamless_m4t_v2", False)]
PLANS = ("searched", "model")
B, S = 4, 16
LOSS_TOL, ATOL, RTOL = 5e-4, 2e-4, 2e-3
TRAIN_TOL = 1e-5           # test_torch_train.py's loss tolerance
RWKV_GNORM_REL = 1e-3      # reduced rwkv6's own float32 gradient noise
SERVE_MODES = {"paged": dict(kv_block_size=8), "dense": dict(kv_block_size=0)}


def _case_id(name, kv1):
    return name + ("-kv1" if kv1 else "")


def _arch(pkg, name, kv1):
    arch = pkg.reduced(name)
    return dataclasses.replace(arch, n_kv_heads=1) if kv1 else arch


def _flat(tree, prefix=""):
    """Path -> leaf; an empty dict (a tied head's ``lm_head``) is kept as
    an empty array under ``<path>/{}``."""
    if isinstance(tree, dict):
        out = {} if tree else {f"{prefix}{{}}": np.zeros(0)}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        *head, last = key.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        if last != "{}":
            node[last] = v
    return tree


def _load(path):
    with np.load(path) as z:
        flat = {k: torch.from_numpy(np.array(z[k])) for k in z.files}
    tree = _unflat(flat)
    return tree["params"], tree["batch"]


# --------------------------------------------------------------------------- #
# the ranks
# --------------------------------------------------------------------------- #
def _rank_main(what, d):
    import torch.distributed as dist

    from repro_torch import configs as TC
    from repro_torch.core import use_mesh
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import lm
    from repro_torch.optim import zero1_state_pspecs
    from repro_torch.plans import (ParallelPlan, gather,
                                   model_plan_from_json, param_pspecs)
    from repro_torch.serve import Request, ServeConfig, ServeEngine
    from repro_torch.train import TrainConfig, make_train_step, realize

    rank = int(os.environ["RANK"])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=4)
    mesh = make_smoke_mesh(2, 2, "cpu")
    sizes = {"data": 2, "model": 2}
    spec = json.loads((d / "run.json").read_text())
    out = {"train": {}, "serve": {}}
    for cid, case in spec["train"].items():
        arch = _arch(TC, case["name"], case["kv1"])
        for kind, pj in case["plans"].items():
            params, batch = _load(d / f"{cid}.npz")
            plan = model_plan_from_json(pj)
            specs = param_pspecs(params, arch, plan)
            z = zero1_state_pspecs(specs, params, ("data",), sizes)
            dp, st, place_batch = realize(params, arch, plan, mesh)
            bt = place_batch(batch)
            step = make_train_step(arch, plan, TrainConfig(
                time_chunk=4, loss_chunk=5))
            with use_mesh(mesh):
                dp, st, met = step(dp, st, bt)
            # (path, moment shard size, param shard size, ZeRO-1 split)
            moments = [["/".join(p), _leaf(st["m"], p).to_local().numel(),
                        _leaf(dp, p).to_local().numel(),
                        "data" in str(_leaf(z, p))
                        and "data" not in str(_leaf(specs, p))]
                       for p, _ in lm.tree_leaves(params)]
            full = gather(dp)
            if rank == 0:
                np.savez(d / f"{cid}-{kind}-params.npz",
                         **{k: np.asarray(v) for k, v in _flat(full).items()})
            out["train"][f"{cid}/{kind}"] = {
                "metrics": {k: float(v) for k, v in met.items()},
                "moments": moments,
                "model_split": any("model" in str(s) for s in
                                   _flat(specs).values())}
    name = spec["serve"]["name"]
    arch = TC.reduced(name)
    plans = {"searched": ParallelPlan.load(d / "serve-plan.json", arch=arch),
             "model": model_plan_from_json(spec["serve"]["model_plan"])}
    params, _ = _load(d / f"{name}.npz")
    for kind, plan in plans.items():
        for mode, kw in SERVE_MODES.items():
            reqs = [Request(uid=i, prompt=tuple(p), max_new_tokens=6)
                    for i, p in enumerate(spec["serve"]["prompts"])]
            with use_mesh(mesh):
                eng = ServeEngine(lm.tree_map(lambda t: t.clone(), params),
                                  arch, ServeConfig(max_batch=4, max_len=40,
                                                    **kw), plan=plan)
                done = eng.run(reqs)
            out["serve"][f"{kind}/{mode}"] = {c.uid: c.tokens for c in done}
    (d / f"out-{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _spawn(d, argv, env=None, timeout=420):
    """Four ranks of ``argv`` (torchrun's environment, a file rendezvous);
    returns rank 0's stdout."""
    procs = []
    for r in range(4):
        e = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="4",
                 OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT / "src"),
                 REPRO_TORCH_INIT_METHOD=f"file://{d}/cmd-store", **(env or {}))
        procs.append(subprocess.Popen(
            argv, env=e, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return outs[0][0]


# --------------------------------------------------------------------------- #
# the parent: reference weights, single-process runs, and the checks
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def realized(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from repro import configs as RC
    from repro.data import make_dataset as jmake_dataset
    from repro.models import encdec as jencdec
    from repro.models import lm as jlm
    from repro.models.arch import ShapeSpec as JShapeSpec
    from repro.optim import adamw_init as jadamw_init
    from repro.train import TrainConfig as JTrainConfig
    from repro.train import make_train_step as jmake_train_step
    from repro_torch import configs as TC
    from repro_torch.bridge import params_from_jax
    from repro_torch.core import h100_mesh_spec
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init
    from repro_torch.plans import (baseline_phase_plan, build_parallel_plan,
                                   model_plan_to_json, search_phase_plan)
    from repro_torch.serve import Request, ServeConfig, ServeEngine
    from repro_torch.train import TrainConfig, make_train_step

    d = tmp_path_factory.mktemp("realize")
    ms = h100_mesh_spec(1, 2, 2)
    run = {"train": {}, "serve": {}}
    single, jax_step = {}, {}
    for name, kv1 in CASES:
        cid = _case_id(name, kv1)
        rarch, arch = _arch(RC, name, kv1), _arch(TC, name, kv1)
        init = jencdec.init_encdec if rarch.enc_layers else jlm.init_lm
        jp = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), rarch,
                                           jnp.float32))
        jb = jmake_dataset(rarch, JShapeSpec("t", S, B, "train")).batch_at(0)
        np.savez(d / f"{cid}.npz", **_flat({"params": jp, "batch": jb}))
        jstep = jax.jit(jmake_train_step(rarch, None, JTrainConfig(
            time_chunk=4, loss_chunk=5)))
        jp1, _, jm = jstep(jp, jadamw_init(jp),
                           {k: jnp.asarray(v) for k, v in jb.items()})
        jax_step[cid] = ({k: float(v) for k, v in jm.items()},
                         {k: np.asarray(v) for k, v in _flat(jp1).items()
                          if not k.endswith("{}")})
        searched, _, _ = search_phase_plan(arch, ms, "train", seq_len=S,
                                           batch=B)
        model, _ = baseline_phase_plan(arch, ms, "train", "model",
                                       seq_len=S, batch=B)
        run["train"][cid] = {"name": name, "kv1": kv1, "plans": {
            "searched": model_plan_to_json(searched),
            "model": model_plan_to_json(model)}}
        params, batch = _load(d / f"{cid}.npz")
        step = make_train_step(arch, None, TrainConfig(time_chunk=4,
                                                       loss_chunk=5))
        p1, _, met = step(params, adamw_init(params), batch)
        single[cid] = ({k: float(v) for k, v in met.items()},
                       {k: v.numpy() for k, v in _flat(p1).items()
                        if not k.endswith("{}")})
    # (b): the serve engine's requests and single-process tokens
    arch = TC.reduced("llama3_2_1b")
    plan = build_parallel_plan(arch, ms, phases=("prefill", "decode"),
                               prompt_len=12, max_batch=4, max_len=40)
    plan.save(d / "serve-plan.json")
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, arch.vocab, 9 + 3 * i)]
               for i in range(6)]
    model, _ = baseline_phase_plan(arch, ms, "decode", "model", seq_len=40,
                                   batch=4)
    run["serve"] = {"name": "llama3_2_1b", "prompts": prompts,
                    "model_plan": model_plan_to_json(model)}
    params, _ = _load(d / "llama3_2_1b.npz")
    serve_single = {}
    for mode, kw in SERVE_MODES.items():
        eng = ServeEngine(lm.tree_map(lambda t: t.clone(), params), arch,
                          ServeConfig(max_batch=4, max_len=40, **kw),
                          plan=plan)
        serve_single[mode] = {c.uid: c.tokens for c in eng.run(
            [Request(uid=i, prompt=tuple(p), max_new_tokens=6)
             for i, p in enumerate(prompts)])}
    (d / "run.json").write_text(json.dumps(run))
    _spawn(d, [sys.executable, str(HERE), "ranks", str(d)])
    outs = [json.loads((d / f"out-{r}.json").read_text()) for r in range(4)]
    return dict(d=d, outs=outs, single=single, jax_step=jax_step,
                serve_single=serve_single)


@pytest.mark.parametrize("kind", PLANS)
@pytest.mark.parametrize("case", [_case_id(*c) for c in CASES])
def test_realized_train_step_matches_single_process(realized, case, kind):
    got = realized["outs"][0]["train"][f"{case}/{kind}"]
    want_met, want_params = realized["single"][case]
    m = got["metrics"]
    assert abs(m["loss"] - want_met["loss"]) < LOSS_TOL, (m, want_met)
    gn = want_met["grad_norm"]
    if case.startswith("rwkv6"):
        assert m["grad_norm"] == pytest.approx(gn, rel=RWKV_GNORM_REL)
    else:
        assert abs(m["grad_norm"] - gn) <= TRAIN_TOL * (1 + abs(gn)), (
            m["grad_norm"], gn)
    jax_met, jax_params = realized["jax_step"][case]
    jl = jax_met["loss"]
    assert abs(m["loss"] - jl) <= TRAIN_TOL * (1 + abs(jl)), (m["loss"], jl)
    with np.load(realized["d"] / f"{case}-{kind}-params.npz") as z:
        assert sorted(jax_params) == sorted(want_params)
        for k, want in want_params.items():
            np.testing.assert_allclose(z[k], want, atol=ATOL, rtol=RTOL,
                                       err_msg=k)
            np.testing.assert_allclose(z[k], jax_params[k], atol=ATOL,
                                       rtol=RTOL, err_msg=f"{k} vs JAX")
    # every rank saw the same metrics
    for out in realized["outs"][1:]:
        assert out["train"][f"{case}/{kind}"]["metrics"] == m
    if kind == "model":
        assert got["model_split"], "the model baseline split nothing on model"


@pytest.mark.parametrize("case", [_case_id(*c) for c in CASES])
def test_zero1_moments_hold_half_per_rank(realized, case):
    for out in realized["outs"]:
        for kind in PLANS:
            rows = out["train"][f"{case}/{kind}"]["moments"]
            split = [r for r in rows if r[3]]
            assert split, "ZeRO-1 split no moment over data"
            for path, m_local, p_local, was_split in rows:
                want = p_local // 2 if was_split else p_local
                assert m_local == want, (kind, path, m_local, p_local)


@pytest.mark.parametrize("kind", PLANS)
@pytest.mark.parametrize("mode", sorted(SERVE_MODES))
def test_realized_engine_tokens_equal_single_process(realized, mode, kind):
    want = {str(k): v for k, v in realized["serve_single"][mode].items()}
    for out in realized["outs"]:
        assert out["serve"][f"{kind}/{mode}"] == want


def test_remat_recompute_keeps_each_layer_config(monkeypatch):
    """A Mamba mixer's inner remat recomputes under its own layer's
    config, not the config of the layer the unit's loop ended on (reduced
    jamba: Mamba, then attention + MoE): on a mesh another config lays
    the recompute out differently, and the checkpoint refuses it."""
    from repro_torch import configs as TC
    from repro_torch.core import LayerConfig, h100_mesh_spec
    from repro_torch.models import init_params, lm, recurrent
    from repro_torch.plans import baseline_phase_plan
    arch = TC.reduced("jamba_1_5_large")
    plan, _ = baseline_phase_plan(arch, h100_mesh_spec(1, 2, 2), "train",
                                  "model", seq_len=S, batch=B)
    seen = []
    mix = recurrent.mamba_mix

    def spy(*a, cfg, **kw):
        seen.append(cfg)
        return mix(*a, cfg=cfg, **kw)
    monkeypatch.setattr(recurrent, "mamba_mix", spy)
    params = lm.tree_map(
        lambda t: t.requires_grad_(),
        init_params(arch, torch.float32,
                    generator=torch.Generator().manual_seed(0),
                    device=torch.device("cpu")))
    tokens = torch.randint(0, arch.vocab, (B, S),
                           generator=torch.Generator().manual_seed(1))
    loss, _ = lm.loss_fn(params, {"tokens": tokens}, arch, plan,
                         time_chunk=4, remat=False)
    forward = list(seen)
    loss.backward()
    recompute = seen[len(forward):]
    assert forward and len(recompute) == len(forward)
    assert all(c != LayerConfig.REPLICATED for c in forward)
    assert recompute == forward


def test_train_command_realizes_a_searched_plan(tmp_path):
    """Then the checkpoint: rank 0 wrote the gathered tensors at steps 2
    and 3; with step 3's removed, ``--resume`` re-places step 2's on the
    mesh and its step 2 has the single-process loss."""
    import shutil

    from repro_torch.launch.train import main as train_main
    args = ["--device", "cpu", "--arch", "llama3.2-1b", "--steps", "3",
            "--batch", "4", "--seq", "16", "--width", "64", "--depth", "2",
            "--vocab", "64", "--log-every", "1"]
    want = train_main(args + ["--strategy", "uniform", "--ckpt-every", "0"])
    ckpt = ["--ckpt-every", "2", "--ckpt-dir", str(tmp_path / "ck")]
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *args, *ckpt,
           "--strategy", "searched", "--metrics-out"]
    stdout = _spawn(tmp_path, cmd + [str(tmp_path / "m.json")])
    assert "mesh: data=4 model=1 (4 ranks, gloo)" in stdout
    got = json.loads((tmp_path / "m.json").read_text())
    assert [g["step"] for g in got] == [w["step"] for w in want]
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) < LOSS_TOL, (g, w)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000002", "step_00000003"]
    shutil.rmtree(tmp_path / "ck" / "step_00000003")
    (tmp_path / "cmd-store").unlink(missing_ok=True)
    stdout = _spawn(tmp_path, cmd + [str(tmp_path / "r.json"), "--resume"])
    assert "resumed from step 2" in stdout
    (g,) = json.loads((tmp_path / "r.json").read_text())
    assert g["step"] == 2 and abs(g["loss"] - want[2]["loss"]) < LOSS_TOL


if __name__ == "__main__":
    _rank_main(sys.argv[1], Path(sys.argv[2]))
