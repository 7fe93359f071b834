"""The port's MoE path against the reference on the CPU, with the same
numpy inputs and the reference's weights (moved across by the bridge):

* the slot assignment (``moe_positions``) and the plain scatter and
  gather (the plain versions of the CUDA kernels) against the reference's
  Pallas scatter/gather in interpret mode (``_moe_pallas_impl``), with a
  capacity small enough that assignments are dropped;
* the gather's library yardstick on the card
  (``chip_smoke.moe_gather_library``, ``F.embedding_bag``) against the
  plain gather and the reference's Pallas gather body (1e-6);
* the plain op (``moe_scatter``, what ``ops.moe_dispatch_combine`` runs
  on the CPU) against ``moe_scatter_xla``, and ``moe_dense_ref`` (the
  function the kernels' backward pass differentiates) against its twin;
* ``moe_ffn``'s output, aux loss and gradients; ``lm.forward`` and
  ``loss_fn`` on reduced olmoe;
* ``ServeEngine`` token for token against the reference engine on one
  seeded trace of reduced olmoe, and of reduced phi3.5-moe (the same MoE
  code at other widths, with GQA): paged + chunked (prefix cache on),
  dense + chunked, dense stall-the-world.

Float32; tolerance 1e-5 on values, 1e-4 of a leaf's largest entry on
gradients (sums in another order).
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import configs as C
from repro.kernels import moe_kernels as JMK
from repro.models import lm as jlm
from repro.models import moe as JM
from repro_torch import configs as TC
from repro_torch.bridge import params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.models import lm, moe
from test_torch_decode import engines_agree

TOL = 1e-5
ARCH = C.reduced("olmoe_1b_7b")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def moe_case(seed, *, B=2, S=12, D=16, E=4, K=2, F=8):
    """x (B, S, D), K distinct experts per token, gates, expert weights."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    idx = np.argsort(rng.random((B, S, E)), -1)[..., :K].astype(np.int32)
    gates = rng.random((B, S, K)).astype(np.float32)
    w = [(rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
         for s in ((E, D, F), (E, D, F), (E, F, D))]
    return [x, gates, idx, *w]


def _both(case):
    return ([jnp.asarray(a) for a in case],
            [torch.from_numpy(a) for a in case])


def test_config_is_a_copy_of_the_reference():
    assert (dataclasses.asdict(TC.get("olmoe-1b-7b"))
            == dataclasses.asdict(C.get("olmoe_1b_7b")))
    assert dataclasses.asdict(TC.reduced("olmoe_1b_7b")) == \
        dataclasses.asdict(ARCH)
    assert moe.capacity(675, TC.get("olmoe-1b-7b")) == 112
    for n in (1, 7, 256, 675):
        assert moe.capacity(n, ARCH) == JM.capacity(n, ARCH)


@pytest.mark.parametrize("C_", [2, 4, 8])
def test_positions_match_reference(C_):
    _, _, idx, *_ = moe_case(C_)
    lin, keep = JMK._positions(jnp.asarray(idx), 4, C_)
    tlin, tkeep = ref.moe_positions(torch.from_numpy(idx), 4, C_)
    assert tlin.dtype == torch.int32
    np.testing.assert_array_equal(tlin.numpy(), np.asarray(lin))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(keep))


@pytest.mark.parametrize("C_", [4, 8])
def test_scatter_gather_match_pallas_interpret(C_):
    """The plain versions of the two kernels, around the same expert FFN,
    against the reference's Pallas path; capacity 4 drops assignments."""
    j, t = _both(moe_case(10 + C_))
    x, _, idx = t[:3]
    B, S, K = idx.shape
    lin, keep = ref.moe_positions(idx, 4, C_)
    assert bool(keep.all()) == (C_ == 8)           # capacity 4 drops
    buf = ref.moe_scatter_ref(x, lin.reshape(B, S, K), 4 * C_)
    assert not bool(buf[:, -1].any())              # the trash row stays 0
    want = JMK._moe_pallas_impl(*j, capacity=C_, interpret=True)
    _close(ref.moe_scatter(*t, capacity=C_), want)


def test_gather_ref_skips_zero_gates():
    out = torch.full((1, 3, 4), float("nan"))
    out[0, 1] = 2.0
    lin = torch.tensor([[[1, 3], [0, 2]]], dtype=torch.int32)
    gates = torch.tensor([[[0.5, 0.0], [0.0, 0.0]]])
    y = ref.moe_gather_ref(out, lin, gates)
    assert torch.equal(y, torch.tensor([[[1.0] * 4, [0.0] * 4]]))


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pallas_gather(lin, out, gates):
    """The reference's Pallas gather body alone, in interpret mode, with
    the BlockSpecs ``_moe_pallas_impl`` gives it."""
    B, n_slots, D = out.shape
    S, K = lin.shape[1:]
    smem = JMK.pl.BlockSpec((1, S, K), lambda b: (b, 0, 0),
                            memory_space=JMK.pltpu.SMEM)
    return JMK.pl.pallas_call(
        functools.partial(JMK._gather_kernel, S=S, K=K, n_slots=n_slots),
        grid=(B,),
        in_specs=[smem,
                  JMK.pl.BlockSpec((1, n_slots, D), lambda b: (b, 0, 0)),
                  JMK.pl.BlockSpec((1, S, K), lambda b: (b, 0, 0))],
        out_specs=JMK.pl.BlockSpec((1, S, D), lambda b: (b, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((B, S, D), out.dtype),
        interpret=True,
    )(lin, out, gates)


@pytest.mark.parametrize("C_", [4, 13])
def test_gather_yardstick_matches_plain_and_pallas(C_):
    """``chip_smoke.moe_gather_library`` (``F.embedding_bag``, the gather
    kernel's library yardstick on the card) computes the gather: equal to
    ``moe_gather_ref`` and to the reference's Pallas gather body within
    1e-6, and, in the op, to ``_moe_pallas_impl``.  Capacity 4 drops
    assignments (B 2, S 13, K 2, E 8, D 60); 13 drops none."""
    E = 8
    case = moe_case(30 + C_, B=2, S=13, D=60, E=E, K=2)
    j, t = _both(case)
    x, gv, idx = t[:3]
    B, S, K = idx.shape
    lin, keep = ref.moe_positions(idx, E, C_)
    assert bool(keep.all()) == (C_ == 13)
    lin = lin.reshape(B, S, K)
    gates = (keep.reshape(B, S, K) * gv).float()
    rng = np.random.default_rng(C_)
    out = rng.standard_normal((B, E * C_, 60)).astype(np.float32)
    library = _chip_smoke().moe_gather_library
    got = library(torch.from_numpy(out), lin, gates)
    _close(got, ref.moe_gather_ref(torch.from_numpy(out), lin, gates), 1e-6)
    _close(got, _pallas_gather(jnp.asarray(lin.numpy()), jnp.asarray(out),
                               jnp.asarray(gates.numpy())), 1e-6)
    _close(ref.moe_scatter(*t, capacity=C_, gather_rows=library),
           JMK._moe_pallas_impl(*j, capacity=C_, interpret=True))


@pytest.mark.parametrize("C_", [4, 8])
def test_plain_op_matches_scatter_xla_and_dense_ref(C_):
    j, t = _both(moe_case(20 + C_))
    want = JMK.moe_scatter_xla(*j, capacity=C_)
    got = ops.moe_dispatch_combine(*t, capacity=C_)
    _close(got, want)
    _close(ref.moe_dense_ref(*t, capacity=C_),
           JMK.moe_dense_ref(*j, capacity=C_))
    _close(ref.moe_dense_ref(*t, capacity=C_), got)


def _moe_params(seed=0):
    jp = JM.init_moe(jax.random.PRNGKey(seed), ARCH, jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def test_moe_ffn_and_aux_match_reference():
    jp, tp = _moe_params()
    x = np.random.default_rng(5).standard_normal(
        (2, 9, ARCH.d_model)).astype(np.float32)
    want, waux = JM.moe_ffn(jp, jnp.asarray(x), ARCH, None)
    got, aux = moe.moe_ffn(tp, torch.from_numpy(x), ARCH)
    _close(got, want)
    _close(aux, waux)
    g, idx, _ = moe.route(tp, torch.from_numpy(x), ARCH)
    assert idx.shape == (2, 9, ARCH.top_k) and g.dtype == torch.float32
    _close(g.sum(-1), np.ones((2, 9)))


def test_moe_ffn_gradients_match_jax():
    """Gradients of sum(y * w) + aux with respect to x and every weight
    (the router's through the gates and the aux loss)."""
    jp, tp = _moe_params(1)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, ARCH.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 9, ARCH.d_model)).astype(np.float32)

    def jloss(p, x_):
        y, aux = JM.moe_ffn(p, x_, ARCH, None)
        return jnp.sum(y * w) + aux

    jg, jx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_ffn(leaves, tx, ARCH)
    (torch.sum(y * torch.from_numpy(w)) + aux).backward()
    _close(tx.grad, jx, 1e-4 * float(np.abs(np.asarray(jx)).max()))
    for k, t in leaves.items():
        want = np.asarray(jg[k])
        _close(t.grad, want, 1e-4 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def olmoe():
    jp = jlm.init_lm(jax.random.PRNGKey(0), ARCH, jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def test_forward_and_loss_on_reduced_olmoe(olmoe):
    jp, tp = olmoe
    toks = np.random.default_rng(7).integers(0, ARCH.vocab, (2, 11))
    want, waux = jlm.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                             ARCH)
    got, aux = lm.forward(tp, {"tokens": torch.from_numpy(toks)}, ARCH)
    _close(got, want)
    _close(aux, waux)
    assert float(aux) > 0
    wl, wm = jlm.loss_fn(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, ARCH)
    tl, tm = lm.loss_fn(tp, {"tokens": torch.from_numpy(toks)}, ARCH)
    _close(tl, wl)
    for k in ("nll", "accuracy", "aux", "loss"):
        _close(tm[k], wm[k])


MODES = {"paged-chunked": dict(kv_block_size=4, prefill_chunk_tokens=5),
         "dense-chunked": dict(kv_block_size=0, prefill_chunk_tokens=5),
         "dense-stall-the-world": dict(kv_block_size=0,
                                       prefill_chunk_tokens=0)}


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_reference_token_for_token(mode):
    eng, got = engines_agree("olmoe_1b_7b", mode, MODES)
    assert eng.paged == (mode == "paged-chunked")
    if mode == "paged-chunked":
        assert eng.prefill_tokens_saved > 0            # prefix hits



@pytest.mark.parametrize("mode", list(MODES))
def test_phi3_5_engine_matches_reference_token_for_token(mode):
    eng, got = engines_agree("phi3_5_moe_42b", mode, MODES)
    assert eng.paged == (mode == "paged-chunked")
    assert sum(len(t) for t in got.values()) > 0
