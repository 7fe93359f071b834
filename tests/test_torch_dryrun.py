"""The port's dry run (``repro_torch.launch.dryrun``, its accountant
``launch/op_analysis.py`` and the kernels' fake branches) on the CPU.

* The accountant on cases worked out by hand, on a 2 x 2 mesh over the
  fake process group: a sharded matmul's per-device FLOPs, the operand
  bytes of an all-gather and a reduce-scatter under the reference's
  convention, each op counted once.
* Each kernel's fake branch, on fake CUDA inputs and on meta inputs (the
  dry run's), gives outputs of the plain version's shapes and dtypes,
  launches nothing, loads no library and refuses what the launcher
  refuses.
* The shard-local products DTensor's own cannot do
  (``core.sharding.contract``, ``einsum``) on four gloo ranks, against
  the plain ones.
* Against the reference (its side in a subprocess: importing
  ``repro.launch.dryrun`` sets 512 host devices): ``input_specs`` for
  every arch x shape, the parameter trees' shapes at full width for every
  config, ``build_strategy`` for every reduced arch on the reference's
  TPU meshes, and a reduced llama's train-step FLOPs against
  ``hlo_analysis.analyze`` of the same step compiled by XLA.
* The command on the production cell ``llama3.2-1b train_4k single``
  writes the reference's JSON fields; ``--skip-existing`` finds the file
  a custom cell wrote; a plain ``contract`` is the flattened product.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs
from repro_torch.core import single_pod_mesh_spec, multi_pod_mesh_spec
from repro_torch.kernels import build, ops, ref, work
from repro_torch.kernels import decode_attention as kdecode
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import mamba_scan as kmamba
from repro_torch.kernels import moe_dispatch as kmoe
from repro_torch.kernels import paged_decode_attention as kpaged
from repro_torch.kernels import rwkv6_scan as kwkv
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_mesh
from repro_torch.launch.op_analysis import OpAccountant
from repro_torch.models import init_params, lm
from repro_torch.models.arch import SHAPES

ROOT = Path(__file__).resolve().parents[1]
META = torch.device("meta")


# --------------------------------------------------------------------------- #
# (a) the accountant, by hand
# --------------------------------------------------------------------------- #
def test_accountant_counts_local_ops_once_on_a_2x2_mesh():
    """A (64, 32) split on rows over ``data`` times B (32, 16) split on
    columns over ``model``: each rank multiplies (32, 32) by (32, 8),
    2 * 32 * 32 * 8 FLOPs (the global product over 4, not the global one,
    not twice).  Gathering the (32, 8) result over ``data`` is an
    all-gather of a (64, 8) float32 output, operand 2048 / 2 bytes; a
    (64, 16) partial sum scattered over ``data`` is a reduce-scatter of a
    (32, 16) output, operand 2048 x 2 bytes.  Exact (integer counts)."""
    from repro_torch.core import h100_mesh_spec
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    with fake_mesh(h100_mesh_spec(1, 2, 2)) as mesh:
        a = distribute_tensor(torch.empty(64, 32, device=META), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        b = distribute_tensor(torch.empty(32, 16, device=META), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)
        p = DTensor.from_local(torch.empty(64, 16, device=META), mesh,
                               [Partial(), Replicate()], run_check=False)
        groups = {mesh.get_group(n).group_name: n
                  for n in mesh.mesh_dim_names}
        acc = OpAccountant()
        acc.add_arguments(a, b, p)
        with acc:
            c = a @ b
        mm = acc.analysis(groups)
        acc = OpAccountant()
        with acc:
            c.redistribute(mesh, [Replicate(), Shard(1)])
        ag = acc.analysis(groups)
        acc = OpAccountant()
        with acc:
            p.redistribute(mesh, [Shard(0), Replicate()])
        rs = acc.analysis(groups)
    assert mm["flops"] == 2 * 32 * 32 * 8
    assert mm["ops"] == 1
    assert mm["memory"]["argument_bytes"] == (32 * 32 + 32 * 8 + 64 * 16) * 4
    assert mm["collective_bytes"]["total"] == 0
    assert ag["collective_bytes"]["all-gather"] == 64 * 8 * 4 / 2
    assert ag["collective_exec_counts"]["all-gather"] == 1
    assert ag["collective_bytes_by_group"] == {"data": 64 * 8 * 4 / 2}
    assert ag["flops"] == 0
    assert rs["collective_bytes"]["reduce-scatter"] == 32 * 16 * 4 * 2
    assert rs["collective_exec_counts"]["reduce-scatter"] == 1
    assert rs["collective_bytes"]["total"] == 32 * 16 * 4 * 2


def test_accountant_memory_follows_allocation_and_free():
    """Peak live bytes: the arguments, then each op's output from its
    allocation until it is freed (exact)."""
    x = torch.empty(1024, device=META)
    acc = OpAccountant()
    acc.add_arguments({"x": x})
    with acc:
        y = x * 2            # 4 KiB live beside x
        del y
        z = x + 1            # the freed 4 KiB reused: the peak stays
        w = z * z            # now 3 x 4 KiB
    r = acc.analysis()
    assert r["memory"] == {"argument_bytes": 4096, "peak_bytes": 3 * 4096,
                           "live_bytes_at_end": 3 * 4096}
    assert r["hbm_bytes"] == 3 * 2 * 4096   # three elementwise ops
    del w


def test_accountant_refuses_a_data_dependent_op():
    x = torch.empty(8, device=META)
    with pytest.raises((RuntimeError, NotImplementedError)):
        with OpAccountant():
            x.sum().item()


# --------------------------------------------------------------------------- #
# (b) the kernels' fake branches
# --------------------------------------------------------------------------- #
def _factory(kind):
    """Tensors of a given shape and dtype: real CPU ones, fake CUDA ones
    (a ``FakeTensorMode``), or meta ones (the dry run's)."""
    if kind == "cpu":
        def make(*shape, dtype=torch.float32):
            if dtype.is_floating_point:
                return torch.randn(*shape, generator=g).to(dtype)
            return torch.zeros(shape, dtype=dtype)
        g = torch.Generator().manual_seed(0)
        return make
    if kind == "meta":
        return lambda *shape, dtype=torch.float32: torch.empty(
            shape, dtype=dtype, device=META)
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode()

    def make(*shape, dtype=torch.float32):
        with mode:
            return torch.empty(shape, dtype=dtype, device="cuda")
    return make


def _cases():
    """name -> (inputs from a factory, the launcher, the plain version)."""
    def flash(m):
        return (m(2, 8, 16, 64), m(2, 2, 24, 64), m(2, 2, 24, 64))

    def decode(m):
        return (m(2, 2, 4, 64), m(2, 2, 40, 64), m(2, 2, 40, 64),
                m(2, dtype=torch.int32))

    def paged(m, quant):
        pool = torch.int8 if quant else torch.float32
        base = (m(2, 2, 4, 64), m(9, 16, 2, 64, dtype=pool),
                m(9, 16, 2, 64, dtype=pool), m(2, 4, dtype=torch.int32),
                m(2, dtype=torch.int32))
        return base + ((m(9, 16, 2), m(9, 16, 2)) if quant else ())

    def moe(m):
        return (m(2, 5, 32), m(2, 5, 3, dtype=torch.int32),
                m(2, 24, 32), m(2, 5, 3))

    def wkv(m):
        return (m(1, 2, 7, 32), m(1, 2, 7, 32), m(1, 2, 7, 32),
                m(1, 2, 7, 32), m(2, 32))

    def scan(m):
        return (m(2, 9, 48), m(2, 9, 16), m(2, 9, 16), m(2, 9, 48),
                m(48, 16), m(48), m(2, 48, 16))

    def paged_call(fn, quant):
        return lambda a: fn(*a[:5], **({"k_scale": a[5], "v_scale": a[6]}
                                       if quant else {}))

    return {
        "flash_attention": (flash, lambda a: kflash.flash_attention_cuda(
            *a, causal=True), lambda a: ref.attention_ref(*a, causal=True)),
        "decode_attention": (decode, lambda a: kdecode.decode_attention_cuda(
            *a), lambda a: ref.decode_attention_ref(
                a[0].reshape(2, 8, 64), *a[1:]).reshape(2, 2, 4, 64)),
        "paged_decode_attention": (
            lambda m: paged(m, False),
            paged_call(kpaged.paged_decode_attention_cuda, False),
            paged_call(ref.paged_decode_attention_ref, False)),
        "paged_decode_attention_int8": (
            lambda m: paged(m, True),
            paged_call(kpaged.paged_decode_attention_cuda, True),
            paged_call(ref.paged_decode_attention_ref, True)),
        "moe_scatter": (moe, lambda a: kmoe.moe_scatter_cuda(a[0], a[1], 24),
                        lambda a: ref.moe_scatter_ref(a[0], a[1], 24)),
        "moe_gather": (moe, lambda a: kmoe.moe_gather_cuda(a[2], a[1], a[3]),
                       lambda a: ref.moe_gather_ref(a[2], a[1], a[3])),
        "wkv6": (wkv, lambda a: kwkv.wkv6_cuda(*a),
                 lambda a: ref.wkv6_scan(*a)),
        "mamba_scan": (scan, lambda a: kmamba.mamba_scan_cuda(
            *a[:6], initial_state=a[6], return_state=True),
            lambda a: ref.mamba_scan_ref(*a[:6], initial_state=a[6],
                                         return_state=True)),
    }


def _meta_of(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype) for t in outs]


@pytest.mark.parametrize("kind", ["fake-cuda", "meta"])
@pytest.mark.parametrize("name", list(_cases()))
def test_fake_branch_matches_the_plain_version(name, kind):
    """Output shapes and dtypes equal the plain version's on real CPU
    inputs (exact); one report of the kernel's work, nothing launched,
    no library loaded."""
    inputs, launcher, plain = _cases()[name]
    want = _meta_of(plain(inputs(_factory("cpu"))))
    ops.reset_launch_counts()
    assert build._LIBS == {}
    got_work = []
    with work.recording(lambda n, w: got_work.append(n)):
        got = launcher(inputs(_factory(kind)))
    assert _meta_of(got) == want
    assert got_work == [name]
    assert all(v == 0 for v in ops.launch_counts().values())
    assert build._LIBS == {}
    for t in (got if isinstance(got, tuple) else (got,)):
        assert work.is_fake(t)


def _refused():
    """Shapes each launcher refuses, on fake inputs."""
    def m(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=META)
    return {
        "flash head dim 32": lambda: kflash.flash_attention_cuda(
            m(1, 4, 8, 32), m(1, 4, 8, 32), m(1, 4, 8, 32)),
        "flash T < S": lambda: kflash.flash_attention_cuda(
            m(1, 4, 8, 64), m(1, 4, 4, 64), m(1, 4, 4, 64)),
        "decode G*D > 2048": lambda: kdecode.decode_attention_cuda(
            m(1, 1, 32, 128), m(1, 1, 8, 128), m(1, 1, 8, 128),
            m(1, dtype=torch.int32)),
        "paged head dim 96": lambda: kpaged.paged_decode_attention_cuda(
            m(1, 1, 1, 96), m(3, 16, 1, 96), m(3, 16, 1, 96),
            m(1, 2, dtype=torch.int32), m(1, dtype=torch.int32)),
        "moe float16": lambda: kmoe.moe_scatter_cuda(
            m(1, 2, 8, dtype=torch.float16), m(1, 2, 2, dtype=torch.int32),
            4),
        "wkv6 head size 16": lambda: kwkv.wkv6_cuda(
            *(m(1, 1, 4, 16) for _ in range(4)), m(1, 16)),
        "scan state 32": lambda: kmamba.mamba_scan_cuda(
            m(1, 4, 8), m(1, 4, 32), m(1, 4, 32), m(1, 4, 8), m(8, 32),
            m(8)),
    }


@pytest.mark.parametrize("case", list(_refused()))
def test_fake_branch_refuses_what_the_launcher_refuses(case):
    with pytest.raises(ValueError):
        _refused()[case]()
    assert build._LIBS == {}


def test_fake_branch_reads_data_dependent_counts_where_it_can():
    """A real kv_len is summed; a fake one counts every row full (exact)."""
    got = []
    q = torch.empty(2, 2, 4, 64, device=META)
    kv = torch.empty(2, 2, 40, 64, device=META)
    with work.recording(lambda n, w: got.append(w)):
        kdecode.decode_attention_cuda(q, kv, kv,
                                      torch.empty(2, dtype=torch.int32,
                                                  device=META))
    assert got == [work.decode_attention(q.shape, 2 * 40, 4)]
    assert work.live_rows(torch.tensor([3, 5]), 80) == 8
    assert work.live_gates(torch.tensor([[0.5, 0.0]]), 2) == 1


# --------------------------------------------------------------------------- #
# the shard-local products the production plans need
# --------------------------------------------------------------------------- #
_PRODUCTS = r"""
import itertools, sys, torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, store):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=4)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.core.sharding import contract, einsum
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    g = torch.Generator().manual_seed(0)
    R, S = Replicate(), Shard
    cases = [  # (product, x shape, w shape, x placements, w placements)
        (lambda a, b, f: f(a, b), (4, 8, 8), (8, 12),
         [R, S(0), S(1), S(2)], [R, S(0), S(1)]),
        (lambda a, b, f: f(a, b, 2), (4, 8, 2, 4), (2, 4, 12),
         [R, S(0), S(3)], [R, S(0), S(2)]),
        (lambda a, b, f: f("becd,edf->becf", a, b), (4, 2, 4, 8), (2, 8, 6),
         [R, S(0), S(1), S(3)], [R, S(0), S(1), S(2)])]
    bad = n = 0
    for i, (prod, xs, ws, xpl, wpl) in enumerate(cases):
        mine = contract if i < 2 else einsum
        plain = ((lambda a, b, k=1: torch.tensordot(a, b, k)) if i < 2
                 else torch.einsum)
        X = torch.randn(*xs, generator=g, dtype=torch.float64)
        W = torch.randn(*ws, generator=g, dtype=torch.float64)
        Xr, Wr = X.clone().requires_grad_(), W.clone().requires_grad_()
        want = prod(Xr, Wr, plain)
        G = torch.randn(*want.shape, generator=g, dtype=torch.float64)
        (want * G).sum().backward()
        for a, b, c, e in itertools.product(xpl, xpl, wpl, wpl):
            x = distribute_tensor(X, mesh, [a, b]).requires_grad_()
            w = distribute_tensor(W, mesh, [c, e]).requires_grad_()
            y = prod(x, w, mine)
            (y * distribute_tensor(G, mesh, [R, R])).sum().backward()
            n += 1
            bad += not (torch.allclose(y.full_tensor(), want)
                        and torch.allclose(x.grad.full_tensor(), Xr.grad)
                        and torch.allclose(w.grad.full_tensor(), Wr.grad))
    if rank == 0:
        print(f"PRODUCTS {n} {bad}")
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(run, args=(sys.argv[1],), nprocs=4)
"""


def test_shard_local_products_match_the_plain_ones(tmp_path):
    """``core.sharding.contract`` and ``einsum`` on four gloo ranks (a 2 x 2
    mesh), every placement of x and w over the two mesh dims: the product
    and both gradients equal the plain float64 ones (``allclose``'s
    default, 1e-5 relative: only the order of the local sums differs)."""
    script = tmp_path / "products.py"
    script.write_text(_PRODUCTS)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(script), str(tmp_path / "store")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    n, bad = map(int, next(l for l in r.stdout.splitlines()
                           if l.startswith("PRODUCTS ")).split()[1:])
    assert n == 16 * 9 + 9 * 9 + 16 * 16 and bad == 0


# --------------------------------------------------------------------------- #
# (c) against the reference
# --------------------------------------------------------------------------- #
# the reduced llama's train step, whose FLOPs both sides count
FLOP_SHAPE = dict(seq=64, batch=4)

_REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp
from repro.launch import dryrun as D
from repro import configs
from repro.core.device import single_pod_mesh_spec, multi_pod_mesh_spec
from repro.models import model_module
from repro.models.arch import SHAPES, ShapeSpec
seq, batch = int(sys.argv[1]), int(sys.argv[2])
out = {"specs": {}, "init": {}, "strategy": {}}
for a, s in D.iter_cells():
    arch, shape = configs.get(a), SHAPES[s]
    sp = D.input_specs(arch, shape)
    out["specs"][a + "/" + s] = {
        "batch": {k: [list(v.shape), str(v.dtype)]
                  for k, v in sp["batch"].items()},
        "dec_len": sp["dec_len"], "enc_len": sp["enc_len"]}
def paths(tree, pre=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from paths(v, pre + (k,))
    else:
        yield "/".join(pre), list(tree.shape)
for a in configs.ALL_ARCHS:
    arch = configs.get(a)
    mod = model_module(arch)
    init = mod.init_encdec if arch.enc_layers else mod.init_lm
    abs_ = jax.eval_shape(lambda k: init(k, arch, jnp.bfloat16),
                          jax.random.PRNGKey(0))
    out["init"][a] = dict(paths(abs_))
for a in configs.ALL_ARCHS:
    arch = configs.reduced(a)
    for mesh_name, spec in (("single", single_pod_mesh_spec()),
                            ("multi", multi_pod_mesh_spec())):
        for s in ("train_4k", "decode_32k"):
            g, strat, comm, _ = D.build_strategy(arch, SHAPES[s], spec,
                                                 "search")
            out["strategy"][f"{a}/{mesh_name}/{s}"] = {
                "assignment": {k: repr(v)
                               for k, v in strat.assignment.items()},
                "cost": strat.cost, "comm": comm}
from repro.launch.hlo_analysis import analyze
from repro.kernels.dispatch import force_backend
from repro.optim import adamw_init
from repro.train import TrainConfig, make_train_step
arch = configs.reduced("llama3.2-1b")
params = model_module(arch).init_lm(jax.random.PRNGKey(0), arch,
                                    jnp.float32)
step = make_train_step(arch, None, TrainConfig())
batch_ = {"tokens": jnp.zeros((batch, seq), jnp.int32)}
with force_backend("xla"):
    hlo = jax.jit(step).lower(params, adamw_init(params),
                              batch_).compile().as_text()
out["flops"] = analyze(hlo)["flops"]
print("REFERENCE " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REFERENCE,
                        str(FLOP_SHAPE["seq"]), str(FLOP_SHAPE["batch"])],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    line = next(l for l in r.stdout.splitlines()
                if l.startswith("REFERENCE "))
    return json.loads(line[len("REFERENCE "):])


def test_input_specs_match_the_reference(reference):
    """Every arch x shape: the same inputs, shapes and dtypes (exact)."""
    for a, s in dryrun.iter_cells():
        sp = dryrun.input_specs(configs.get(a), SHAPES[s])
        got = {"batch": {k: [list(v.shape), str(v.dtype).replace(
                   "torch.", "")] for k, v in sp["batch"].items()},
               "dec_len": sp["dec_len"], "enc_len": sp["enc_len"]}
        assert got == reference["specs"][f"{a}/{s}"], (a, s)
        assert all(v.is_meta for v in sp["batch"].values())


def test_meta_init_matches_the_reference_shapes(reference):
    """Every published config at full width: the port's parameter tree on
    meta tensors has the reference's ``eval_shape`` tree (exact)."""
    for a in configs.ALL_ARCHS:
        p = init_params(configs.get(a), torch.bfloat16,
                        generator=torch.Generator(), device=META)
        got = {"/".join(k): list(t.shape) for k, t in lm.tree_leaves(p)}
        assert got == reference["init"][a], a
        assert all(t.is_meta for _, t in lm.tree_leaves(p))


def test_build_strategy_matches_the_reference(reference):
    """Every reduced arch on the reference's TPU meshes: the same
    per-node configs (exact), cost and communicated bytes (rel 1e-12,
    the copied cost model's float sums)."""
    for a in configs.ALL_ARCHS:
        arch = configs.reduced(a)
        for mesh_name, spec in (("single", single_pod_mesh_spec()),
                                ("multi", multi_pod_mesh_spec())):
            for s in ("train_4k", "decode_32k"):
                want = reference["strategy"][f"{a}/{mesh_name}/{s}"]
                _, strat, comm, _ = dryrun.build_strategy(
                    arch, SHAPES[s], spec, "search")
                assert {k: repr(v) for k, v in strat.assignment.items()} \
                    == want["assignment"], (a, mesh_name, s)
                assert strat.cost == pytest.approx(want["cost"], rel=1e-12)
                assert set(comm) == set(want["comm"])
                for k, v in comm.items():
                    assert v == pytest.approx(want["comm"][k], rel=1e-12,
                                              abs=1e-9)


def test_train_step_flops_match_the_reference_analysis(reference):
    """Exactly equal: with both sides on the ``xla`` attention path, the
    port's chunked attention and loss are the reference's XLA forms op for
    op, remat recomputes the same units on both, and both count 2 M N K a
    product (``flop_counter`` and ``analyze``'s dots), integers."""
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainConfig, make_train_step
    arch = configs.reduced("llama3.2-1b")
    params = init_params(arch, torch.float32, generator=torch.Generator(),
                         device=META)
    opt = adamw_init(params)
    batch = {"tokens": torch.empty(FLOP_SHAPE["batch"], FLOP_SHAPE["seq"],
                                   dtype=torch.int32, device=META)}
    step = make_train_step(arch, None, TrainConfig(kernel_backend="xla"))
    acc = OpAccountant()
    with acc:
        step(params, opt, batch)
    assert acc.analysis()["flops"] == reference["flops"]


# --------------------------------------------------------------------------- #
# (d) the command
# --------------------------------------------------------------------------- #
def _reference_result_keys() -> tuple[set, set]:
    """The keys of the reference's result dict and of its ``hbm`` entry,
    read from its source (importing it sets 512 host devices)."""
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == "dryrun_cell")
    res = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", "") == "result")
    keys = {k.value for k in res.keys}
    hbm = next(v for k, v in zip(res.keys, res.values) if k.value == "hbm")
    return keys, {k.value for k in hbm.keys}


def test_command_writes_the_reference_fields():
    """The production cell on the 256-GPU mesh: the reference's JSON keys
    (``fits_80GB`` for ``fits_16GiB``), H100 constants, a finite
    roofline, the flash kernel's fake launches counted."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3.2-1b", "--shape", "train_4k", "--mesh", "single"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    path = next(l.split("result: ", 1)[1] for l in r.stdout.splitlines()
                if l.startswith("result: "))
    got = json.loads(Path(path).read_text())
    keys, hbm = _reference_result_keys()
    assert keys <= set(got)
    assert set(got["hbm"]) == (hbm - {"fits_16GiB"}) | {"fits_80GB"}
    assert got["device"] == "H100_SXM (spec sheet)"
    assert got["n_chips"] == 256 and got["status"] == "ok"
    assert got["kernels"]["flash_attention"]["launches"] == \
        configs.get("llama3.2-1b").n_layers * 2      # forward + recompute
    rf = got["roofline"]
    assert 0 < rf["compute_s"] and 0 < rf["memory_s"] and 0 < rf[
        "collective_s"]
    assert got["hbm"]["fits_80GB"] == (
        got["hbm"]["per_device_total"] < 80e9)


def test_skip_existing_finds_the_file_the_cell_wrote(tmp_path, monkeypatch,
                                                     capsys):
    """``--skip-existing`` looks for the name the cell writes, custom
    shape, depth, mesh shape and ``--fsdp`` included."""
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    argv = ["--arch", "llama3.2-1b", "--shape", "train_4k", "--seq", "16",
            "--batch", "2", "--depth", "1", "--mesh-shape", "1,1,1",
            "--fsdp", "--dtype", "float32", "--skip-existing"]
    dryrun.main(argv)
    name = "llama3.2-1b-d1__train_2x16__1x1x1__search+fsdp"
    assert [p.name for p in tmp_path.iterdir()] == [name + ".json"]
    capsys.readouterr()
    dryrun.main(argv)
    assert f"[skip existing] {name}" in capsys.readouterr().out


@pytest.mark.parametrize("k", [1, 2])
def test_contract_on_plain_tensors_is_the_flattened_product(k):
    """A plain ``contract`` of a 3-D weight is the product of the
    flattened operands (q projection at k = 1, o projection at k = 2),
    exactly."""
    from repro_torch.core.sharding import contract
    g = torch.Generator().manual_seed(0)
    x_dims, w_dims = ((4, 8), (4, 8, 32)) if k == 2 else ((32,), (32, 4, 8))
    x = torch.randn(2, 5, *x_dims, generator=g)
    w = torch.randn(*w_dims, generator=g)
    want = (x.reshape(2, 5, 32) @ w.reshape(32, -1)).reshape(
        2, 5, *w.shape[k:])
    assert torch.equal(contract(x, w, k), want)
