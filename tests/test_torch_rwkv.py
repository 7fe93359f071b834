"""The port's RWKV6 pieces against the JAX reference on the CPU: the WKV6
recurrence (plain version against ``repro.kernels.ref`` and against the
Pallas kernel in interpret mode, values and gradients), the time mix and
channel mix (training form, and the carried-state form with a ragged
``q_lens``), the config copy, and the serve cache's leaves.

Tolerances (float32, the same math with sums in another order): 1e-5 on
outputs; gradients within 1e-4 of the largest gradient entry of the
leaf (they sum over the batch and the sequence).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import configs as C
from repro.core.config import LayerConfig
from repro.kernels import ref as jref
from repro.kernels import rwkv6_scan as jwkv
from repro.models import recurrent as jrc
from repro_torch import configs as TC
from repro_torch.bridge import params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.models import recurrent as rc

TOL = 1e-5
GRAD_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _grad_close(got, want):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= GRAD_TOL * scale, (err, scale)


def wkv_inputs(seed, B=2, H=2, T=16, N=8):
    """r/k/v of order 1, decays w in (0.3, 1) as exp(-exp(.)) gives."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, T, N)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.3, 1.0, (B, H, T, N)).astype(np.float32)
    u = rng.standard_normal((H, N)).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("T,chunk", [(16, 4), (12, 64)],
                         ids=["chunked", "whole"])
def test_wkv6_scan_matches_reference_and_pallas_interpret(T, chunk):
    args = wkv_inputs(T, T=T)
    got = ops.wkv6(*map(_t, args), chunk=chunk)
    want = jref.wkv6_scan(*map(jnp.asarray, args), chunk=chunk)
    pallas = jwkv.wkv6(*map(jnp.asarray, args), chunk=min(chunk, T),
                       interpret=True)
    _close(got, want)
    _close(got, pallas)


@pytest.mark.parametrize("T,chunk", [(16, 4), (12, 64)],
                         ids=["chunked", "whole"])
def test_wkv6_gradients_match_jax(T, chunk):
    args = wkv_inputs(T + 1, T=T)
    g = np.random.default_rng(T).standard_normal(args[0].shape).astype(
        np.float32)
    tin = [_t(a).requires_grad_() for a in args]
    (ops.wkv6(*tin, chunk=chunk) * _t(g)).sum().backward()
    # the reference's kernel op: forward the Pallas kernel (interpret),
    # backward the VJP of ref.wkv6_scan
    jgrads = jax.grad(
        lambda *a: jnp.sum(jwkv._via_pallas(*a, chunk=min(chunk, T),
                                            interpret=True) * g),
        argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    for t, jg in zip(tin, jgrads):
        _grad_close(t.grad, jg)


def test_wkv6_stateful_form_and_model_layout_oracle():
    r, k, v, w, u = wkv_inputs(3, T=16)
    s0 = np.random.default_rng(4).standard_normal(
        (2, 2, 8, 8)).astype(np.float32)
    out, sn = ops.wkv6(*map(_t, (r, k, v, w, u)), chunk=4,
                       initial_state=_t(s0), return_state=True)
    jout, jsn = jref.wkv6_scan(*map(jnp.asarray, (r, k, v, w, u)), chunk=4,
                               initial_state=jnp.asarray(s0),
                               return_state=True)
    _close(out, jout)
    _close(sn, jsn)
    # the (B, T, H, N) oracle
    bt = lambda a: np.ascontiguousarray(a.transpose(0, 2, 1, 3))
    o2, s2 = ref.wkv6_ref(*map(_t, map(bt, (r, k, v, w))), _t(u), _t(s0))
    jo2, js2 = jref.wkv6_ref(*map(jnp.asarray, map(bt, (r, k, v, w))),
                             jnp.asarray(u), jnp.asarray(s0))
    _close(o2, jo2)
    _close(s2, js2)


# --------------------------------------------------------------------------- #
# time mix / channel mix
# --------------------------------------------------------------------------- #
def _mix_setup(seed=0):
    arch = C.reduced("rwkv6_1b6")
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    jt = jrc.init_rwkv_tmix(k1, arch, jnp.float32)
    jc = jrc.init_rwkv_cmix(k2, arch, jnp.float32)
    # move the init away from its symmetric values (mu 0.5, w0 -2, ln_x 1)
    rng = np.random.default_rng(seed)
    jt = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape)
                      .astype(np.float32), jt)
    to_t = lambda tree: params_from_jax(jax.tree.map(np.asarray, tree), "cpu")
    return arch, jt, jc, to_t(jt), to_t(jc)


def test_rwkv_tmix_and_cmix_train_form():
    arch, jt, jc, tt, tc = _mix_setup()
    x = np.random.default_rng(5).standard_normal((2, 12, arch.d_model))
    x = x.astype(np.float32)
    cfg = LayerConfig()
    jy, jst = jrc.rwkv_tmix(jt, jnp.asarray(x), arch, cfg, chunk=4)
    y, st = rc.rwkv_tmix(tt, _t(x), arch, chunk=4)
    _close(y, jy)
    assert st["wkv"] is None and jst["wkv"] is None
    _close(st["shift"], jst["shift"])
    jy, _ = jrc.rwkv_cmix(jc, jnp.asarray(x), arch, cfg)
    y, _ = rc.rwkv_cmix(tc, _t(x), arch)
    _close(y, jy)


def test_rwkv_tmix_gradients_match_jax():
    arch, jt, _, tt, _ = _mix_setup(1)
    x = np.random.default_rng(6).standard_normal(
        (2, 16, arch.d_model)).astype(np.float32)
    cfg = LayerConfig()
    jg = jax.grad(lambda p, x_: jnp.sum(jnp.sin(
        jrc.rwkv_tmix(p, x_, arch, cfg, chunk=4)[0])), argnums=(0, 1))(
        jt, jnp.asarray(x))
    tt = {k: v.requires_grad_() for k, v in tt.items()}
    tx = _t(x).requires_grad_()
    torch.sin(rc.rwkv_tmix(tt, tx, arch, chunk=4)[0]).sum().backward()
    for name, g in jg[0].items():
        _grad_close(tt[name].grad, g)
    _grad_close(tx.grad, jg[1])


def test_rwkv_mixes_carried_state_with_ragged_q_lens():
    arch, jt, jc, tt, tc = _mix_setup(2)
    B, S, D = 3, 6, arch.d_model
    H, hs = arch.n_rwkv_heads, arch.rwkv_head_size
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    shift = rng.standard_normal((B, D)).astype(np.float32)
    wkv = rng.standard_normal((B, H, hs, hs)).astype(np.float32)
    q_lens = np.array([6, 2, 0], np.int32)
    cfg = LayerConfig()
    jy, jst = jrc.rwkv_tmix(jt, jnp.asarray(x), arch, cfg,
                            state={"shift": jnp.asarray(shift),
                                   "wkv": jnp.asarray(wkv)},
                            chunk=4, q_lens=jnp.asarray(q_lens))
    y, st = rc.rwkv_tmix(tt, _t(x), arch,
                         state={"shift": _t(shift), "wkv": _t(wkv)},
                         chunk=4, q_lens=_t(q_lens))
    _close(y[0], jy[0])
    _close(y[1, :2], jy[1, :2])
    for key in ("shift", "wkv"):
        _close(st[key], jst[key])
    jy, jst = jrc.rwkv_cmix(jc, jnp.asarray(x), arch, cfg,
                            state={"shift": jnp.asarray(shift)},
                            q_lens=jnp.asarray(q_lens))
    y, st = rc.rwkv_cmix(tc, _t(x), arch, state={"shift": _t(shift)},
                         q_lens=_t(q_lens))
    _close(y[0], jy[0])
    _close(st["shift"], jst["shift"])


def test_rwkv_config_is_a_copy_and_serving_names_its_slice():
    assert (dataclasses.asdict(TC.get("rwkv6-1.6b"))
            == dataclasses.asdict(C.get("rwkv6_1b6")))
    assert (dataclasses.asdict(TC.reduced("rwkv6_1b6"))
            == dataclasses.asdict(C.reduced("rwkv6_1b6")))
    # serving arrived with its slice: the cache has the reference's leaves
    from repro.models import lm as jlm
    from repro_torch.models import lm
    arch = TC.reduced("rwkv6_1b6")
    got = {p: (tuple(t.shape), t.dtype) for p, t in lm.tree_leaves(
        lm.init_cache(arch, 2, 8, torch.bfloat16, device="cpu"))}
    want = {p: (a.shape, torch.float32 if a.dtype == np.float32
                else torch.bfloat16)
            for p, a in lm.tree_leaves(jax.tree.map(
                np.asarray, jlm.init_cache(arch, 2, 8, jnp.bfloat16)))}
    assert got == want
    assert {p[1:] for p in got} == {("tmix_state", "shift"),
                                    ("tmix_state", "wkv"),
                                    ("cmix_state", "shift")}
