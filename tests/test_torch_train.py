"""The port's train path against the JAX reference on the CPU, for reduced
llama3.2, rwkv6, olmoe (MoE) and jamba (Mamba + attention + MoE) with
the reference's weights moved across by the bridge: ``loss_fn`` and every
gradient leaf, ``make_train_step`` after 1 and 3 steps (params, AdamW
moments, step, metrics), microbatch accumulation (against one batch, and
against the reference's microbatched step where the MoE load-balancing
loss makes the two differ), the optimizer alone, the synthetic data (the
encoder-decoder's frames and the VLM's frontend embeddings too),
checkpoints that cross between the packages both ways, and the train
command; then two train steps of reduced seamless-m4t-v2 and internvl2
on their datasets' batches.

Tolerances, float32 (the same math with sums in another order):
  * loss, logits and metrics: 1e-5 (relative to the values' scale);
  * gradients and AdamW moments: within 1e-4 of the largest entry of the
    leaf (a gradient sums over the batch and the sequence);
  * float32 itself is the limit on reduced rwkv6: its per-head group norm
    divides by the spread of a head's output, which is near zero at the
    first token (o_0 = (r.(u*k)) v, one scalar times v), so float32
    rounding there grows to ~2e-4 of a gradient and to ~1e-3 of the
    gradient norm at step 2 -- in both packages, measured against a
    float64 run.  Each of these comparisons therefore also allows four
    times the port's own float32 error, measured in the test as the gap
    between the port's float32 and float64 runs of the same inputs;
  * parameters after AdamW: at step 1 an element moves by about
    ``lr * sign(g)`` whatever |g| is, so an entry whose gradient is at
    the summation-noise level (its sign decided by the order of the sums)
    moves the other way in the other package, 2 * lr apart.  The check is
    therefore two-part: at most 0.1% of the elements of a leaf may differ
    by more than 1e-5, and none by more than 2 * (sum of the step
    learning rates) + 1e-5, the most that such sign flips can add up to.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import configs as C
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import make_dataset as jmake_dataset
from repro.models import lm as jlm
from repro.models.arch import ShapeSpec as JShapeSpec
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_schedule as jcosine_schedule
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as jmake_train_step
from repro_torch import configs as TC
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLM, make_dataset
from repro_torch.models import lm
from repro_torch.models.arch import ShapeSpec
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule)
from repro_torch.train import TrainConfig, make_train_step

ARCHS = ["llama3_2_1b", "rwkv6_1b6", "olmoe_1b_7b", "jamba_1_5_large"]
TOL = 1e-5
GRAD_TOL = 1e-4
OPT = dict(lr=3e-3, warmup_steps=20, total_steps=100)   # launch/train.py's


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


NOISE = 4      # times the port's own float32 error (float64 run)


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _close(got, want, got64=None, tol=TOL, what=""):
    """|got - want| within tol * (1 + |want|) or NOISE x |got - got64|."""
    bound = tol * (1 + float(np.abs(np.asarray(want)).max()))
    if got64 is not None:
        bound = max(bound, NOISE * _err(got, got64))
    assert _err(got, want) <= bound, (what, _err(got, want), bound)


def _grad_close(got, want, got64=None, what=""):
    """|got - want| within GRAD_TOL of the leaf's largest entry, or NOISE
    x |got - got64|."""
    bound = GRAD_TOL * max(float(np.abs(np.asarray(want)).max()), 1e-30)
    if got64 is not None:
        bound = max(bound, NOISE * _err(got, got64))
    assert _err(got, want) <= bound, (what, _err(got, want), bound)


def _params_close(got, want, lr_sum, what=""):
    d = np.abs(np.asarray(got) - np.asarray(want))
    assert float(d.max()) <= 2 * lr_sum + TOL, (what, float(d.max()))
    assert float(np.mean(d > TOL)) <= 1e-3, (what, float(np.mean(d > TOL)))


def _setup(name, B=2, S=16):
    arch = C.reduced(name)
    jp = jlm.init_lm(jax.random.PRNGKey(0), arch, jnp.float32)
    tp = params_from_jax(_np_tree(jp), "cpu")
    tokens = jmake_dataset(arch, JShapeSpec("t", S, B, "train")).batch_at(0)
    return arch, jp, tp, tokens["tokens"]


def _port_loss(tp, tokens, arch, dtype, **kw):
    """(loss, metrics, {path: grad}) of the port in ``dtype``."""
    tp = lm.tree_map(lambda t: t.to(dtype).detach().requires_grad_(), tp)
    loss, met = lm.loss_fn(tp, {"tokens": torch.from_numpy(tokens)}, arch,
                           **kw)
    loss.backward()
    grads = dict(_leaves(lm.tree_map(lambda t: t.grad.numpy(), tp)))
    return loss.detach(), {k: v.detach() for k, v in met.items()}, grads


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_every_gradient_leaf_match_jax(name):
    arch, jp, tp, tokens = _setup(name)
    kw = dict(time_chunk=4, loss_chunk=5)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, {"tokens": jnp.asarray(tokens)}, arch,
                              **kw), has_aux=True)(jp)
    loss, met, got = _port_loss(tp, tokens, arch, torch.float32, **kw)
    loss64, met64, got64 = _port_loss(tp, tokens, arch, torch.float64, **kw)
    _close(loss, jl, loss64)
    for k in ("loss", "nll", "accuracy", "aux"):
        _close(met[k], jm[k], met64[k], what=k)
    want = dict(_leaves(_np_tree(jg)))
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.abs(want[k]).max() > 0, k
        _grad_close(got[k], want[k], got64[k], k)


@pytest.mark.parametrize("name", ARCHS)
def test_forward_logits_match_jax(name):
    arch, jp, tp, tokens = _setup(name)
    want, jaux = jlm.forward(jp, {"tokens": jnp.asarray(tokens)}, arch)
    batch = {"tokens": torch.from_numpy(tokens)}
    with torch.no_grad():
        got, aux = lm.forward(tp, batch, arch)
        got64, aux64 = lm.forward(lm.tree_map(torch.Tensor.double, tp),
                                  batch, arch)
    _close(got, want, got64)
    _close(aux, jaux, aux64)
    assert (float(aux) > 0) == bool(arch.n_experts)     # MoE balancing loss


def test_softmax_xent_matches_jax():
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 5, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    loss, met = lm.softmax_xent(torch.from_numpy(logits),
                                torch.from_numpy(labels))
    jloss, jmet = jlm.softmax_xent(jnp.asarray(logits), jnp.asarray(labels))
    _close(loss, jloss)
    for k in jmet:
        _close(met[k], jmet[k], what=k)


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_state_after_one_and_three_steps(name):
    arch, jp, tp, _ = _setup(name)
    ds = make_dataset(arch, ShapeSpec("t", 16, 2, "train"))
    jstep = jax.jit(jmake_train_step(arch, None, JTrainConfig(
        optimizer=JAdamWConfig(**OPT), time_chunk=4)))
    tstep = make_train_step(arch, None, TrainConfig(
        optimizer=AdamWConfig(**OPT), time_chunk=4))
    # the port once more with the model in float64 (moments stay f32)
    t64 = lm.tree_map(torch.Tensor.double, tp)
    jo, to, to64 = jadamw_init(jp), adamw_init(tp), adamw_init(t64)
    lr_sum = 0.0
    for step in range(3):
        batch = ds.batch_at(step)["tokens"]
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(batch)})
        tp, to, tm = tstep(tp, to, {"tokens": torch.from_numpy(batch)})
        t64, to64, tm64 = tstep(t64, to64,
                                {"tokens": torch.from_numpy(batch)})
        lr_sum += float(jm["lr"])
        for k in jm:
            _close(tm[k], jm[k], tm64[k], what=f"step {step} {k}")
        if step not in (0, 2):
            continue
        assert int(to["step"]) == int(jo["step"]) == step + 1
        assert to["step"].dtype == torch.int32
        for part, got, want, got64 in (
                ("params", tp, jp, t64), ("m", to["m"], jo["m"], to64["m"]),
                ("v", to["v"], jo["v"], to64["v"])):
            want = dict(_leaves(_np_tree(want)))
            got = dict(_leaves(params_to_numpy(got)))
            got64 = dict(_leaves(params_to_numpy(got64)))
            assert sorted(got) == sorted(want)
            for k in want:
                if part == "params":
                    _params_close(got[k], want[k], lr_sum, k)
                else:
                    _grad_close(got[k], want[k], got64[k], f"{part} {k}")


def test_microbatches_match_one_batch():
    arch, _, tp, _ = _setup("rwkv6_1b6", B=4)
    batch = {"tokens": torch.from_numpy(
        make_dataset(arch, ShapeSpec("t", 16, 4, "train")).batch_at(0)
        ["tokens"])}
    out = {}
    for m in (1, 2):
        p = lm.tree_map(torch.clone, tp)
        step = make_train_step(arch, None, TrainConfig(
            optimizer=AdamWConfig(**OPT), microbatches=m, time_chunk=4))
        out[m] = step(p, adamw_init(p), batch)
    (_, o1, m1), (_, o2, m2) = out[1], out[2]
    for k in ("loss", "nll", "accuracy", "grad_norm"):
        _close(m2[k], m1[k])
    g1 = dict(_leaves(params_to_numpy(o1["m"])))
    g2 = dict(_leaves(params_to_numpy(o2["m"])))
    for k in g1:
        _grad_close(g2[k], g1[k], what=k)


@pytest.mark.parametrize("name", ["olmoe_1b_7b", "jamba_1_5_large"])
def test_microbatched_step_matches_jax(name):
    """Two microbatches against the reference's two: with MoE layers the
    averaged load-balancing loss is not one batch's, so the reference's
    microbatched step is the oracle."""
    arch, jp, tp, _ = _setup(name)
    batch = make_dataset(arch, ShapeSpec("t", 16, 4, "train")).batch_at(0)
    cfg = dict(microbatches=2, time_chunk=4)
    jp, jo, jm = jax.jit(jmake_train_step(arch, None, JTrainConfig(
        optimizer=JAdamWConfig(**OPT), **cfg)))(
        jp, jadamw_init(jp), {"tokens": jnp.asarray(batch["tokens"])})
    tp, to, tm = make_train_step(arch, None, TrainConfig(
        optimizer=AdamWConfig(**OPT), **cfg))(
        tp, adamw_init(tp), {"tokens": torch.from_numpy(batch["tokens"])})
    for k in jm:
        _close(tm[k], jm[k], what=k)
    want = dict(_leaves(_np_tree(jo["m"])))
    for k, got in _leaves(params_to_numpy(to["m"])):
        _grad_close(got, want[k], what=k)
    want = dict(_leaves(_np_tree(jp)))
    for k, got in _leaves(params_to_numpy(tp)):
        _params_close(got, want[k], float(jm["lr"]), k)


def test_train_step_runs_a_staged_plan_and_refuses_an_unknown_remat():
    """A pipeline-staged plan runs, with the microbatched unstaged step's
    metrics (``test_torch_staged.py`` holds it against the reference's
    1F1B step); an unknown remat policy is refused."""
    from repro_torch.core.stages import StageAssignment
    from repro_torch.plans import ParallelPlan
    arch = TC.reduced("llama3_2_1b")
    base = ParallelPlan.uniform(arch, phases=("train",))
    staged = ParallelPlan(arch=base.arch, phases=base.phases,
                          stages={"train": StageAssignment((0, 1, 2), 2)})
    p = lm.init_lm(arch, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    tokens = {"tokens": torch.randint(0, arch.vocab, (4, 8),
                                      generator=torch.Generator()
                                      .manual_seed(1))}
    mets = []
    for plan, cfg in ((staged, TrainConfig()),
                      (None, TrainConfig(microbatches=2))):
        q = lm.tree_map(torch.clone, p)
        mets.append(make_train_step(arch, plan, cfg)(q, adamw_init(q),
                                                     tokens)[2])
    for k in mets[1]:
        _close(mets[0][k], mets[1][k], what=k)
    step = make_train_step(arch, None, TrainConfig(remat_policy="offload"))
    with pytest.raises(ValueError, match="'dots', 'dots_batch', 'nothing'"):
        step(p, adamw_init(p), {"tokens": torch.zeros(2, 8, dtype=torch.int32)})


# --------------------------------------------------------------------------- #
# optimizer and data alone
# --------------------------------------------------------------------------- #
def test_cosine_schedule_matches_jax():
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    for s in (0, 1, 5, 10, 11, 55, 99, 100, 150):
        _close(cosine_schedule(AdamWConfig(**cfg), torch.tensor(s)),
               jcosine_schedule(JAdamWConfig(**cfg), jnp.int32(s)), tol=1e-6)


@pytest.mark.parametrize("grad_scale", [1.0, 1e4], ids=["unclipped",
                                                         "clipped"])
def test_adamw_update_matches_jax(grad_scale):
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=1.0)
    jp, jo = params, jadamw_init(params)
    tp = params_from_jax(params, "cpu")
    to = adamw_init(tp)
    for _ in range(3):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * grad_scale)
                         .astype(np.float32), params)
        jp, jo, jm = jadamw_update(jp, g, jo, JAdamWConfig(**cfg))
        tp, to, tm = adamw_update(tp, params_from_jax(g, "cpu"), to,
                                  AdamWConfig(**cfg))
        for k in ("grad_norm", "lr"):
            _close(tm[k], jm[k])
    for (k, got), (_, want) in zip(_leaves(params_to_numpy(tp)),
                                   _leaves(_np_tree(jp))):
        _close(got, want, tol=1e-6)
    for part in ("m", "v"):
        for (k, got), (_, want) in zip(_leaves(params_to_numpy(to[part])),
                                       _leaves(_np_tree(jo[part]))):
            _close(got, want, tol=1e-6)


@pytest.mark.parametrize("seed,step,host", [(0, 0, 0), (3, 7, 1), (11, 2, 0)])
def test_synthetic_batches_equal_the_reference(seed, step, host):
    kw = dict(vocab=101, batch=8, seq_len=33, seed=seed)
    got = SyntheticLM(**kw).batch_at(step, host, 2)["tokens"]
    want = JSyntheticLM(**kw).batch_at(step, host, 2)["tokens"]
    assert got.dtype == want.dtype and got.shape == (4, 33)
    np.testing.assert_array_equal(got, want)
    arch = C.reduced("rwkv6_1b6")
    np.testing.assert_array_equal(
        make_dataset(arch, ShapeSpec("t", 9, 3, "train")).batch_at(step)
        ["tokens"],
        jmake_dataset(arch, JShapeSpec("t", 9, 3, "train")).batch_at(step)
        ["tokens"])
    # the encoder-decoder's frames and the VLM's frontend embeddings
    for name, key in (("seamless_m4t_v2", "frames"),
                      ("internvl2_76b", "frontend")):
        arch = C.reduced(name)
        got = make_dataset(arch, ShapeSpec("t", 12, 4, "train"),
                           seed=seed).batch_at(step, host, 2)
        want = jmake_dataset(arch, JShapeSpec("t", 12, 4, "train"),
                             seed=seed).batch_at(step, host, 2)
        assert sorted(got) == sorted(want) == sorted(["tokens", key])
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


# --------------------------------------------------------------------------- #
# bridge and checkpoints
# --------------------------------------------------------------------------- #
def _train_state(name):
    arch = C.reduced(name)
    jp = jlm.init_lm(jax.random.PRNGKey(1), arch, jnp.float32)
    jo = jadamw_init(jp)
    jo = {"m": jax.tree.map(lambda a: a + 0.5, jo["m"]), "v": jo["v"],
          "step": jnp.int32(7)}
    return _np_tree({"params": jp, "opt": jo})


@pytest.mark.parametrize("name", ARCHS)
def test_bridge_carries_train_state_both_ways(name):
    state = _train_state(name)
    t = params_from_jax(state, "cpu")
    assert t["opt"]["step"].dtype == torch.int32 and t["opt"]["step"].ndim == 0
    back = params_to_numpy(t)
    for (k, a), (k2, b) in zip(_leaves(back), _leaves(state)):
        assert k == k2 and a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_cross_between_packages(tmp_path, writer):
    state = _train_state("rwkv6_1b6")
    tstate = params_from_jax(state, "cpu")
    if writer == "port":
        CheckpointManager(tmp_path).save(7, tstate)
        got = JCheckpointManager(tmp_path).restore(
            7, jax.tree.map(jnp.asarray, state))
        got = _np_tree(got)
    else:
        JCheckpointManager(tmp_path).save(7, jax.tree.map(jnp.asarray,
                                                          state))
        like = lm.tree_map(torch.zeros_like, tstate)
        step, got = CheckpointManager(tmp_path).restore_latest(like)
        assert step == 7
        assert got["opt"]["step"].dtype == torch.int32
        got = params_to_numpy(got)
    for (k, a), (k2, b) in zip(_leaves(got), _leaves(state)):
        assert k == k2
        np.testing.assert_array_equal(a, b)
    manifest = json.loads((tmp_path / "step_00000007" /
                           "MANIFEST.json").read_text())
    assert "opt/step" in manifest["leaves"]


def test_corrupt_checkpoint_is_skipped(tmp_path):
    tstate = params_from_jax(_train_state("llama3_2_1b"), "cpu")
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, tstate)
    mgr.save(2, tstate)
    (tmp_path / "step_00000002" / "arrays.npz").write_bytes(b"garbage")
    step, _ = mgr.restore_latest(lm.tree_map(torch.zeros_like, tstate))
    assert step == 1


# --------------------------------------------------------------------------- #
# the train command
# --------------------------------------------------------------------------- #
TINY = ["--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
        "--width", "64", "--depth", "2", "--vocab", "64", "--log-every", "1"]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-1.6b"])
def test_train_command_runs_on_cpu_and_resumes(tmp_path, capsys, arch):
    from repro_torch.launch import train
    hist = train.main(TINY + ["--arch", arch, "--ckpt-dir", str(tmp_path),
                              "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "degrades to uniform" in out and "tok/s=" in out
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert out.strip().splitlines()[-1].startswith("nll ")
    assert CheckpointManager(tmp_path).all_steps() == [2, 3]
    hist = train.main(TINY + ["--arch", arch, "--ckpt-dir", str(tmp_path),
                              "--ckpt-every", "0", "--steps", "4",
                              "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert [h["step"] for h in hist] == [3]


def _tiny_arch():
    from repro_torch.launch import train
    return train.reduced_arch(TC.get("llama3.2-1b"), 64, 2, 64)


def _staged_plans(tmp_path) -> dict:
    """Plans for ``TINY``'s arch whose train phase is pipeline-staged:
    searched with two stages on a data 4 x model 2 mesh, and a
    prefill-only plan staged by hand, to which train falls back."""
    from repro_torch.core import h100_mesh_spec
    from repro_torch.core.stages import StageAssignment
    from repro_torch.models.plan import uniform_plan
    from repro_torch.plans import (ParallelPlan, arch_fingerprint,
                                   build_parallel_plan)
    arch = _tiny_arch()
    staged = build_parallel_plan(arch, h100_mesh_spec(1, 4, 2),
                                 phases=("train",), train_seq=16,
                                 train_batch=2, train_stages=2,
                                 train_microbatches=2)
    assert staged.stage_for("train").num_stages == 2
    prefill = ParallelPlan(arch=arch_fingerprint(arch),
                           phases={"prefill": uniform_plan(arch)},
                           stages={"prefill": StageAssignment((0, 1, 2))})
    return {"staged": str(staged.save(tmp_path / "staged.json")),
            "prefill": str(prefill.save(tmp_path / "prefill.json")),
            "out": str(tmp_path / "out.json")}


@pytest.mark.parametrize("flag", [["--plan", "{staged}"],
                                  ["--plan", "{prefill}"],
                                  ["--plan", "{staged}", "--save-plan",
                                   "{out}"],
                                  ["--device-profile", "{profile}"],
                                  ["--kernel-backend", "ref"],
                                  ["--autotune-cache-dir", "{tune}"]])
def test_train_command_trains_under_each_once_refused_flag(flag, tmp_path,
                                                          capsys):
    """Each flag that once named the slice still to come is taken now, and
    the command trains: a pipeline-staged train plan (loaded, or reached
    by the phase fallback) runs its microbatches, logs its pipeline and
    gives the unstaged run's losses (its microbatches' mean: float
    reassociation, 1e-5); the profiler's and the dispatcher's flags
    train too."""
    from repro_torch.launch import train
    from repro_torch.profiling import DeviceProfile
    files = _staged_plans(tmp_path)
    files["profile"] = str(DeviceProfile(device_kind="TestChip v0").save(
        tmp_path / "d.json"))
    files["tune"] = str(tmp_path / "tune")
    argv = TINY + [f.format(**files) for f in flag] + ["--ckpt-every", "0"]
    hist = train.main(argv)
    assert [h["step"] for h in hist] == [0, 1, 2]
    if flag[0] == "--plan":
        m = 1 if "prefill" in flag[1] else 2
        assert f"train: pipeline S=2 M={m} boundaries=(0, 1, 2)" in (
            capsys.readouterr().out)
        want = train.main(TINY + ["--ckpt-every", "0", "--strategy",
                                  "uniform"])
        for h, w in zip(hist, want):
            _close(h["loss"], w["loss"], what=h["step"])


@pytest.mark.parametrize("source", ["command", "searched-h100"])
def test_train_command_under_a_plan_keeps_the_losses(tmp_path, capsys,
                                                     source):
    """On one device a plan places nothing: ``--strategy search
    --save-plan`` (degraded to uniform, as logged) and then ``--plan`` on
    that file, or ``--plan`` on a plan searched for an H100 node (the mesh
    mismatch logged), give losses bitwise equal to a run without one."""
    from repro_torch.core import h100_mesh_spec
    from repro_torch.launch import train
    from repro_torch.plans import build_parallel_plan
    base = TINY + ["--ckpt-every", "0", "--strategy", "uniform"]
    want = train.main(base)
    capsys.readouterr()
    path = tmp_path / "plan.json"
    if source == "command":
        train.main(TINY + ["--ckpt-every", "0", "--save-plan", str(path)])
        assert "degrades to uniform" in capsys.readouterr().out
    else:
        build_parallel_plan(_tiny_arch(), h100_mesh_spec(1, 2, 4),
                            train_seq=16, train_batch=2).save(path)
    got = train.main(TINY + ["--ckpt-every", "0", "--plan", str(path)])
    out = capsys.readouterr().out
    assert "plan: loaded [" in out
    assert ("plan searched for mesh" in out) == (source != "command")
    assert got == want


@pytest.mark.parametrize("name", ["seamless_m4t_v2", "internvl2_76b"])
def test_seq2seq_and_vlm_train_steps_match_jax(name):
    """Two steps of ``make_train_step`` on the encoder-decoder (frames +
    tokens; ``encdec.loss_fn``) and on the VLM (frontend + text), each
    batch from the reference's dataset: metrics, AdamW moments and
    parameters against the reference's jitted step."""
    from repro.models import encdec as jencdec
    from repro_torch.data import make_dataset as tmake_dataset
    arch = C.reduced(name)
    init = jencdec.init_encdec if arch.enc_layers else jlm.init_lm
    jp = init(jax.random.PRNGKey(0), arch, jnp.float32)
    tp = params_from_jax(_np_tree(jp), "cpu")
    seq = 16 + arch.frontend_tokens
    ds = tmake_dataset(arch, ShapeSpec("t", seq, 2, "train"))
    jstep = jax.jit(jmake_train_step(arch, None, JTrainConfig(
        optimizer=JAdamWConfig(**OPT))))
    tstep = make_train_step(arch, None, TrainConfig(
        optimizer=AdamWConfig(**OPT)))
    jo, to = jadamw_init(jp), adamw_init(tp)
    lr_sum = 0.0
    for step in range(2):
        batch = ds.batch_at(step)
        assert sorted(batch) == sorted(
            ["tokens", "frames" if arch.enc_layers else "frontend"])
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tp, to, tm = tstep(tp, to, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        lr_sum += float(jm["lr"])
        for k in jm:
            _close(tm[k], jm[k], what=f"step {step} {k}")
    for (k, got), (_, want) in zip(_leaves(params_to_numpy(to["m"])),
                                   _leaves(_np_tree(jo["m"]))):
        _grad_close(got, want, what=k)
    for (k, got), (_, want) in zip(_leaves(params_to_numpy(tp)),
                                   _leaves(_np_tree(jp))):
        _params_close(got, want, lr_sum, k)
