"""The port's remat policies against the JAX reference on the CPU: for
reduced llama3.2, rwkv6, olmoe and jamba, ``loss_fn``'s loss and every
gradient leaf under ``remat_policy="dots"`` and ``"dots_batch"`` against
the reference's ``loss_fn`` under the same policy (its
``REMAT_POLICIES``), with the reference's weights moved across by the
bridge.  A policy changes what the backward pass keeps, never the
result, so the tolerances are ``test_torch_train``'s: 1e-5 on the loss,
1e-4 of a leaf's largest entry on gradients, or four times the port's
own float32 error (its float64 run) where float32 is the limit (rwkv6).

Then what each policy keeps: the matrix products the backward pass runs
again.  ``"dots"`` recomputes no ``mm`` (JAX's dot without a batch
dimension) and ``"dots_batch"`` no ``bmm`` either; ``"nothing"``
recomputes both.
"""

import jax
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import lm as jlm
from repro_torch.models import lm
from test_torch_train import _close, _grad_close, _leaves, _np_tree, \
    _port_loss, _setup

ARCHS = ["llama3_2_1b", "rwkv6_1b6", "olmoe_1b_7b", "jamba_1_5_large"]


@pytest.mark.parametrize("policy", ["dots", "dots_batch"])
@pytest.mark.parametrize("name", ARCHS)
def test_remat_policy_matches_jax(name, policy):
    arch, jp, tp, tokens = _setup(name)
    kw = dict(time_chunk=4, loss_chunk=5, remat_policy=policy)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, {"tokens": jnp.asarray(tokens)}, arch,
                              **kw), has_aux=True)(jp)
    loss, met, got = _port_loss(tp, tokens, arch, torch.float32, **kw)
    loss64, met64, got64 = _port_loss(tp, tokens, arch, torch.float64, **kw)
    _close(loss, jl, loss64)
    for k in ("nll", "aux"):
        _close(met[k], jm[k], met64[k], what=k)
    want = dict(_leaves(_np_tree(jg)))
    assert sorted(got) == sorted(want)
    for k in want:
        _grad_close(got[k], want[k], got64[k], k)


class _CountProducts(TorchDispatchMode):
    """Counts the ``mm`` and ``bmm`` calls that reach the dispatcher."""

    OPS = {torch.ops.aten.mm.default: "mm",
           torch.ops.aten.addmm.default: "mm",
           torch.ops.aten.bmm.default: "bmm",
           torch.ops.aten.baddbmm.default: "bmm"}

    def __init__(self):
        super().__init__()
        self.n = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.OPS:
            self.n[self.OPS[func]] += 1
        return func(*args, **(kwargs or {}))


def _products(tp, tokens, arch, policy):
    """(forward counts, backward counts) of one loss and gradient."""
    leaves = lm.tree_map(lambda t: t.clone().requires_grad_(), tp)
    with _CountProducts() as fwd:
        loss, _ = lm.loss_fn(leaves, {"tokens": torch.from_numpy(tokens)},
                             arch, time_chunk=4, loss_chunk=5,
                             remat_policy=policy)
    with _CountProducts() as bwd:
        loss.backward()
    return fwd.n, bwd.n


def test_policies_keep_the_products_they_name():
    """Reduced llama3.2 (attention's plain version runs its two products
    as ``bmm``): the backward pass of ``"nothing"`` recomputes the unit's
    forward products; ``"dots"`` recomputes its ``bmm`` only and
    ``"dots_batch"`` neither.  The forward passes are the same."""
    arch, _, tp, tokens = _setup("llama3_2_1b")
    runs = {p: _products(tp, tokens, arch, p)
            for p in ("nothing", "dots", "dots_batch")}
    fwd = runs["nothing"][0]
    assert fwd["mm"] > 0 and fwd["bmm"] > 0
    assert all(f == fwd for f, _ in runs.values())
    nothing, dots, both = (runs[p][1] for p in ("nothing", "dots",
                                                "dots_batch"))
    # the stack's products are recomputed once under "nothing"; the loss
    # chunks' (always recomputed) and the gradients' own are in every run
    assert nothing["mm"] > dots["mm"] == both["mm"]
    assert nothing["bmm"] == dots["bmm"] > both["bmm"]
