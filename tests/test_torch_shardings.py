"""The port's plan realization specs (``repro_torch.core.sharding``,
``repro_torch.plans.shardings``, ``repro_torch.optim.zero1_state_pspecs``)
against the reference's, in process and on shapes alone.

For every arch of ``configs.all_archs()`` at its published size and every
phase, under the plans searched for two H100 meshes (one node of 2 x 4,
two nodes of 2 x 4) and the uniform plan, the port's ``param_pspecs``
(also with a two-stage assignment), ``batch_pspecs``, ``cache_pspecs``
(dense, paged, paged int8) and ``zero1_state_pspecs`` equal the
reference's leaf for leaf, a ``PartitionSpec`` compared as a tuple.  The
port's plans reach the reference through the plan codec.  Then
``to_shardings(like=)``'s cleaned specs against the reference's
``NamedSharding.spec`` on a real (2, 2, 2) pod/data/model mesh of eight
host devices (one subprocess, as ``tests/test_sharded_execution.py``
runs one), the identity of ``constrain`` without a mesh, and the mesh
order of every multi-axis entry (DTensor shards several mesh dims over
one tensor dim in mesh-dim order, so an entry out of that order would
lay a tensor out differently from the reference).
"""

import functools
import json
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as RP

from repro import configs as RC
from repro.core.stages import StageAssignment as RStageAssignment
from repro.models import encdec as rencdec
from repro.models import lm as rlm
from repro.optim import zero1_state_pspecs as rzero1_state_pspecs
from repro.plans import batch_pspecs as rbatch_pspecs
from repro.plans import cache_pspecs as rcache_pspecs
from repro.plans import model_plan_from_json as rmodel_plan_from_json
from repro.plans import param_pspecs as rparam_pspecs
from repro_torch import configs as TC
from repro_torch.core import h100_mesh_spec
from repro_torch.core.sharding import (P, axis_sizes, constrain, current_mesh,
                                       placements, use_mesh)
from repro_torch.core.stages import StageAssignment
from repro_torch.models.plan import uniform_plan
from repro_torch.optim import zero1_state_pspecs
from repro_torch.plans import (PHASES, batch_pspecs, build_parallel_plan,
                               cache_pspecs, model_plan_to_json,
                               param_pspecs, to_shardings)

SHAPES = dict(train_seq=64, train_batch=8, prompt_len=32, max_batch=4,
              max_len=48)
MESHES = {"1x2x4": (1, 2, 4), "2x2x4": (2, 2, 4)}
MESH_AXES = ("pod", "data", "model")           # h100_mesh_spec's order


@functools.cache
def _plans(name):
    """{label: (port ModelPlan, reference ModelPlan)}: each phase of the
    plans searched on both meshes, and the uniform plan."""
    arch = TC.get(name)
    out = {"uniform": uniform_plan(arch)}
    for m, dims in MESHES.items():
        pp = build_parallel_plan(arch, h100_mesh_spec(*dims), **SHAPES)
        for ph in PHASES:
            out[f"{m}/{ph}"] = pp.plan_for(ph)
    return {k: (p, rmodel_plan_from_json(json.loads(json.dumps(
        model_plan_to_json(p))))) for k, p in out.items()}


@functools.cache
def _shapes(name):
    """Abstract params and caches of the published arch (nothing
    allocated), and a batch of its inputs."""
    rarch = RC.get(name)
    mod = rencdec if rarch.enc_layers else rlm
    init = rencdec.init_encdec if rarch.enc_layers else rlm.init_lm
    ev = lambda f: jax.eval_shape(f)
    params = ev(lambda: init(jax.random.PRNGKey(0), rarch, jnp.float32))
    caches = {"dense": ev(lambda: mod.init_cache(
        rarch, 4, 48, jnp.float32,
        **({"enc_len": 16} if rarch.enc_layers else {})))}
    if not rarch.enc_layers:
        for q in (None, "int8"):
            caches[f"paged-{q or 'fp'}"] = ev(lambda q=q: rlm.init_paged_cache(
                rarch, 9, 8, 4, jnp.float32, kv_quant=q))
    sds = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)
    batch = {"tokens": sds(8, 64)}
    if rarch.enc_layers:
        batch["frames"] = sds(8, 32, rarch.d_model)
    if rarch.frontend:
        batch["frontend"] = sds(8, 256, rarch.d_model)
    return rarch, params, caches, batch


def _tuples(tree):
    """A reference spec tree with every PartitionSpec as a tuple."""
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, RP))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _same(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(_tuples(want)))
    assert got.keys() == want.keys()
    bad = {k: (got[k], want[k]) for k in got if tuple(got[k]) != want[k]}
    assert not bad, list(bad.items())[:4]


def _mesh_order(tree):
    for path, spec in _leaves(tree):
        for e in spec:
            if isinstance(e, tuple):
                order = [MESH_AXES.index(a) for a in e]
                assert order == sorted(order), (path, spec)


@pytest.mark.parametrize("name", TC.ALL_ARCHS)
def test_specs_match_reference(name):
    rarch, params, caches, batch = _shapes(name)
    arch = TC.get(name)
    half = max(1, arch.n_units // 2)
    two = (0, half, arch.n_units) if arch.n_units > 1 else None
    for label, (plan, rplan) in _plans(name).items():
        got = param_pspecs(params, arch, plan)
        want = rparam_pspecs(params, rarch, rplan)
        _same(got, want)
        _mesh_order(got)
        if two is not None and not arch.enc_layers:
            _same(param_pspecs(params, arch, plan,
                               stages=StageAssignment(two, 4)),
                  rparam_pspecs(params, rarch, rplan,
                                stages=RStageAssignment(two, 4)))
        _same(batch_pspecs(batch, plan), rbatch_pspecs(batch, rplan))
        for kind, cache in caches.items():
            paged = kind.startswith("paged")
            spec = cache_pspecs(cache, arch, plan, paged=paged)
            _same(spec, rcache_pspecs(cache, rarch, rplan, paged=paged))
            _mesh_order(spec)
        dims = MESHES.get(label.split("/")[0], (2, 2, 4))
        sizes = axis_sizes(h100_mesh_spec(*dims))
        data_axes = tuple(a for a in ("pod", "data") if a in sizes)
        shapes = jax.tree.map(lambda x: x.shape, params)
        z = zero1_state_pspecs(got, shapes, data_axes, sizes)
        _same(z, rzero1_state_pspecs(want, shapes, data_axes, sizes))
        _mesh_order(z)


def test_constrain_without_a_mesh_is_the_identity():
    x = torch.zeros(2, 3, 4)
    cfg = _plans("llama3_2_1b")["1x2x4/train"][0].embed
    assert constrain(x, cfg, ("batch", "seq", "d_model")) is x


def test_the_active_mesh_is_visible_to_other_threads():
    """The autograd engine recomputes checkpointed units on its device
    threads (CUDA), which must constrain as the forward did."""
    import threading
    mesh, seen = object(), []
    with use_mesh(mesh):
        t = threading.Thread(target=lambda: seen.append(current_mesh()))
        t.start()
        t.join()
    assert seen == [mesh] and current_mesh() is None


def test_an_entry_out_of_mesh_order_is_refused():
    mesh = h100_mesh_spec(2, 2, 4)
    placements(P(None, ("pod", "model")), mesh)
    with pytest.raises(ValueError, match="mesh order"):
        placements(P(None, ("model", "data")), mesh)


_NAMES = ["llama3_2_1b", "olmoe_1b_7b", "rwkv6_1b6", "jamba_1_5_large",
          "seamless_m4t_v2", "internvl2_76b"]

SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp
    from repro import compat, configs as C
    from repro.models import encdec, lm
    from repro.plans import (cache_pspecs, model_plan_from_json,
                             param_pspecs, to_shardings)
    mesh = compat.make_mesh((2, 2, 2), ("pod", "data", "model"))
    spec = lambda t: jax.tree.map(lambda s: [list(e) if isinstance(e, tuple)
                                             else e for e in s.spec], t)
    out = {}
    for name, plans in json.load(open(sys.argv[1])).items():
        arch = C.get(name)
        init = encdec.init_encdec if arch.enc_layers else lm.init_lm
        p = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), arch,
                                        jnp.float32))
        c = jax.eval_shape(lambda: lm.init_paged_cache(arch, 9, 8, 4,
                                                       jnp.float32)
                           ) if not arch.enc_layers else None
        for label, pj in plans.items():
            plan = model_plan_from_json(pj)
            out[f"{name}/{label}/params"] = spec(to_shardings(
                param_pspecs(p, arch, plan), mesh, like=p))
            if c is not None:
                out[f"{name}/{label}/cache"] = spec(to_shardings(
                    cache_pspecs(c, arch, plan, paged=True), mesh, like=c))
    print(json.dumps(out))
""")


def test_cleaned_specs_match_reference_named_shardings(tmp_path):
    """``to_shardings(like=)`` on a (2, 2, 2) pod/data/model mesh: the
    axes it keeps equal those of the reference's ``NamedSharding.spec``
    on eight host devices, for the params and the paged cache of six
    families under their 2 x 2 x 4 plans."""
    plans = {n: {k: model_plan_to_json(p) for k, (p, _) in
                 _plans(n).items() if k.startswith("2x2x4")}
             for n in _NAMES}
    path = tmp_path / "plans.json"
    path.write_text(json.dumps(plans))
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(path)],
                       capture_output=True, text=True, timeout=600, cwd=".")
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(r.stdout)
    mesh = h100_mesh_spec(2, 2, 2)
    as_json = lambda t: json.loads(json.dumps(t))
    for name in _NAMES:
        _, params, caches, _ = _shapes(name)
        arch = TC.get(name)
        for label in plans[name]:
            plan = _plans(name)[label][0]
            got = to_shardings(param_pspecs(params, arch, plan), mesh,
                               like=params)
            key = f"{name}/{label}"
            assert as_json(_spec_tree(got)) == want[f"{key}/params"], key
            if "paged-fp" in caches:
                c = caches["paged-fp"]
                got = to_shardings(cache_pspecs(c, arch, plan, paged=True),
                                   mesh, like=c)
                assert as_json(_spec_tree(got)) == want[f"{key}/cache"], key


def _spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    return list(tree.spec)
