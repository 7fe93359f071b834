"""The port's kernel dispatcher (``repro_torch.kernels.dispatch``) against
the reference's (``tests/test_dispatch.py``): backend selection on the
CPU, the override order (``backend=``, ``force_backend``,
``REPRO_KERNEL_BACKEND_<OP>``, ``REPRO_KERNEL_BACKEND``), errors for
unknown names, the preference fall-through, and the plain backends
agreeing with each other and with the reference's ``ref`` / ``xla`` on the
same numpy inputs.  Then the port's departures: the card rule (with the
platform check faked to ``cuda``, automatic selection never picks a plain
impl for a call form a kernel covers), the process-wide forced backend,
and the commands' ``--kernel-backend`` / ``--autotune-cache-dir`` /
``--device-profile`` on the CPU.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import dispatch, ops, ref  # noqa: E402

TOL = 2e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _flash_np(B=1, H=4, KH=2, S=128, D=64, seed=0):
    rng = np.random.default_rng(seed)
    return (_rand(rng, B, H, S, D), _rand(rng, B, KH, S, D),
            _rand(rng, B, KH, S, D))


def _decode_np(B=2, KH=2, G=4, T=256, D=64, seed=1):
    rng = np.random.default_rng(seed)
    return (_rand(rng, B, KH, G, D), _rand(rng, B, KH, T, D),
            _rand(rng, B, KH, T, D), np.array([100, 256], np.int32)[:B])


def _wkv_np(B=1, H=2, T=64, N=32, seed=2):
    rng = np.random.default_rng(seed)
    r, k, v = (_rand(rng, B, H, T, N, scale=0.5) for _ in range(3))
    w = np.exp(-np.exp(_rand(rng, B, H, T, N) - 1.0)).astype(np.float32)
    u = _rand(rng, H, N, scale=0.5)
    return r, k, v, w, u


def _mamba_np(B=2, S=40, di=8, N=4, seed=3):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(_rand(rng, B, S, di))).astype(np.float32)
    Bm, Cm = _rand(rng, B, S, N), _rand(rng, B, S, N)
    x = _rand(rng, B, S, di)
    A = -np.exp(_rand(rng, di, N, scale=0.2)).astype(np.float32)
    return dt, Bm, Cm, x, A, _rand(rng, di)


def _moe_np(B=2, S=32, D=8, E=4, K=2, F=16, seed=4):
    rng = np.random.default_rng(seed)
    x = _rand(rng, B, S, D)
    wi, wg = _rand(rng, E, D, F, scale=0.3), _rand(rng, E, D, F, scale=0.3)
    wo = _rand(rng, E, F, D, scale=0.3)
    logits = _rand(rng, B, S, E)
    idx = np.argsort(-logits, axis=-1)[..., :K].astype(np.int32)
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    gv = np.take_along_axis(p, idx, -1).astype(np.float32)
    return x, gv, idx, wi, wg, wo


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    import jax.numpy as jnp
    return tuple(jnp.asarray(a) for a in arrays)


def _np(x):
    return np.asarray(x, np.float32)


# --------------------------------------------------------------------------- #
# (a) selection on the CPU, and the port's names
# --------------------------------------------------------------------------- #
def test_cpu_auto_selection_takes_the_plain_versions():
    q, k, v = _t(*_flash_np())
    assert dispatch.select("flash_attention", q, k, v,
                           causal=True).backend == "ref"
    dq, dk, dv, n = _t(*_decode_np())
    assert dispatch.select("decode_attention", dq, dk, dv,
                           n).backend == "ref"
    assert dispatch.select("wkv6", *_t(*_wkv_np())).backend == "ref"
    assert dispatch.select("mamba_scan", *_t(*_mamba_np())).backend == "ref"
    x, gv, idx, wi, wg, wo = _t(*_moe_np())
    assert dispatch.select("moe_dispatch_combine", x, gv, idx, wi, wg, wo,
                           capacity=16).backend == "xla"


def test_cpu_large_shapes_fall_back_to_chunked_xla():
    # score tensor would be B*H*S*T = 2^26 elements: over the ref guard
    q = torch.zeros(1, 4, 4096, 8)
    assert dispatch.select("flash_attention", q, q, q,
                           causal=True).backend == "xla"
    # the guard is a preference, not a capability: forcing ref still works
    assert dispatch.select("flash_attention", q, q, q,
                           backend="ref").backend == "ref"


def test_every_op_registers_the_port_backends_and_they_mean_the_same():
    """One table of names; every op has all three; the cost model prices
    ``cuda`` as the reference's ``pallas``."""
    from repro_torch.core.cost_model import _KERNEL_COST_HOOKS
    assert sorted(dispatch.BACKENDS) == ["cuda", "ref", "xla"]
    assert set(dispatch.REFERENCE_NAMES) == set(dispatch.BACKENDS)
    for op in ("flash_attention", "decode_attention",
               "paged_decode_attention", "wkv6", "mamba_scan",
               "moe_dispatch_combine"):
        impls = dispatch.backends(op)
        assert sorted(impls) == ["cuda", "ref", "xla"], op
        assert impls["cuda"].platforms == ("cuda",)
    for op in ("mamba_scan", "moe_dispatch_combine"):
        assert (_KERNEL_COST_HOOKS[(op, "cuda")]
                is _KERNEL_COST_HOOKS[(op, "pallas")])


def test_xla_override_registered_for_every_op():
    """``--kernel-backend xla`` must not crash any op."""
    q, k, v = _t(*_flash_np())
    assert dispatch.select("flash_attention", q, k, v,
                           backend="xla").backend == "xla"
    dq, dk, dv, n = _t(*_decode_np())
    assert dispatch.select("decode_attention", dq, dk, dv, n,
                           backend="xla").backend == "xla"
    assert dispatch.select("wkv6", *_t(*_wkv_np()),
                           backend="xla").backend == "xla"
    assert dispatch.select("mamba_scan", *_t(*_mamba_np()),
                           backend="xla").backend == "xla"
    assert dispatch.select("moe_dispatch_combine", *_t(*_moe_np()),
                           capacity=16, backend="xla").backend == "xla"


def test_per_op_env_override_covers_new_ops(monkeypatch):
    """REPRO_KERNEL_BACKEND_<OP> steers one op without touching others."""
    monkeypatch.setenv(f"{dispatch.ENV_GLOBAL}_MAMBA_SCAN", "xla")
    assert dispatch.select("mamba_scan", *_t(*_mamba_np())).backend == "xla"
    q, k, v = _t(*_flash_np())
    assert dispatch.select("flash_attention", q, k, v).backend != "xla"
    monkeypatch.setenv(f"{dispatch.ENV_GLOBAL}_MOE_DISPATCH_COMBINE", "ref")
    assert dispatch.select("moe_dispatch_combine", *_t(*_moe_np()),
                           capacity=16).backend == "ref"


@pytest.mark.parametrize("name", ["no_such_backend", "interpret", "pallas"])
def test_unknown_op_and_backend_raise(name, monkeypatch):
    """An unknown name raises wherever it comes from, and names the port's
    backends; the reference's ``interpret`` has no counterpart."""
    q, k, v = _t(*_flash_np())
    with pytest.raises(KeyError):
        dispatch.call("no_such_op", q)
    with pytest.raises(ValueError, match=r"\['cuda', 'ref', 'xla'\]"):
        dispatch.call("flash_attention", q, k, v, backend=name)
    monkeypatch.setenv(dispatch.ENV_GLOBAL, name)
    with pytest.raises(ValueError, match="the port's backends"):
        dispatch.select("flash_attention", q, k, v)


# --------------------------------------------------------------------------- #
# (b) overrides: env var and context
# --------------------------------------------------------------------------- #
def test_env_override(monkeypatch):
    q, k, v = _t(*_flash_np())
    monkeypatch.setenv(dispatch.ENV_GLOBAL, "xla")
    assert dispatch.select("flash_attention", q, k, v).backend == "xla"
    # per-op override beats the global one
    monkeypatch.setenv(f"{dispatch.ENV_GLOBAL}_FLASH_ATTENTION", "ref")
    assert dispatch.select("flash_attention", q, k, v).backend == "ref"
    assert dispatch.select("wkv6", *_t(*_wkv_np())).backend == "xla"
    # the context beats both, and backend= beats the context
    with dispatch.force_backend("xla"):
        assert dispatch.select("flash_attention", q, k, v).backend == "xla"
        assert dispatch.select("flash_attention", q, k, v,
                               backend="ref").backend == "ref"


def test_env_override_through_public_ops(monkeypatch):
    """The chunked core (``xla``) under the env override equals the
    reference's plain attention."""
    q, k, v = _t(*_flash_np())
    want = ref.attention_ref(q, k, v, causal=True)
    monkeypatch.setenv(dispatch.ENV_GLOBAL, "xla")
    got = ops.flash_attention(q, k, v, causal=True, block_q=32, block_k=64)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def test_force_backend_context():
    q, k, v = _t(*_flash_np())
    with dispatch.force_backend("xla"):
        assert dispatch.select("flash_attention", q, k, v).backend == "xla"
        with dispatch.force_backend(None):
            # None leaves the outer context in force
            assert dispatch.select("flash_attention", q, k,
                                   v).backend == "xla"
        with dispatch.force_backend("ref"):
            assert dispatch.select("flash_attention", q, k,
                                   v).backend == "ref"
        assert dispatch.select("flash_attention", q, k, v).backend == "xla"
    assert dispatch.select("flash_attention", q, k, v).backend == "ref"


def test_forced_backend_is_seen_by_other_threads():
    """Process-wide (the autograd engine recomputes a checkpointed unit
    on its own device thread)."""
    import threading
    q, k, v = _t(*_flash_np())
    seen = []
    with dispatch.force_backend("xla"):
        t = threading.Thread(target=lambda: seen.append(
            dispatch.select("flash_attention", q, k, v).backend))
        t.start()
        t.join()
    assert seen == ["xla"]


def test_env_override_falls_back_when_call_unsupported(monkeypatch):
    """A preference a backend cannot honor for a particular call (the
    kernel asked for on the CPU, or for the carried-state WKV6 on the
    card) falls back to auto-selection, not a crash; ``backend=`` stays
    strict."""
    r, k, v, w, u = _t(*_wkv_np())
    s0 = torch.zeros(1, 2, 32, 32)
    monkeypatch.setenv(dispatch.ENV_GLOBAL, "cuda")
    impl = dispatch.select("wkv6", r, k, v, w, u, chunk=16,
                           initial_state=s0, return_state=True)
    assert impl.backend == "ref"
    with dispatch.force_backend("cuda"):
        assert dispatch.select("wkv6", r, k, v, w, u).backend == "ref"
    monkeypatch.setattr(dispatch, "call_platform", lambda args: "cuda")
    impl = dispatch.select("wkv6", r, k, v, w, u, chunk=16,
                           initial_state=s0, return_state=True)
    assert impl.backend == "ref"
    with pytest.raises(ValueError, match="does not take"):
        dispatch.select("wkv6", r, k, v, w, u, chunk=16, initial_state=s0,
                        return_state=True, backend="cuda")


def test_forced_ineligible_backend_raises():
    q, k, v = _t(*_flash_np())
    with pytest.raises(ValueError, match="does not take"):
        dispatch.call("flash_attention", q, k, v, backend="cuda")


# --------------------------------------------------------------------------- #
# (c) the card rule: no hidden fallback
# --------------------------------------------------------------------------- #
def _covered_calls():
    """Every call form a kernel covers, at a shape it takes and at one it
    does not (head dim 8, WKV6 N 16, scan N 17)."""
    rng = np.random.default_rng(5)
    out = []
    for D in (64, 8):
        q, k, v = (torch.from_numpy(_rand(rng, 1, 4, 6, D))
                   for _ in range(3))
        out.append(("flash_attention", (q, k, v), {"causal": True}))
        dq = torch.from_numpy(_rand(rng, 2, 2, 2, D))
        kv = torch.from_numpy(_rand(rng, 2, 2, 9, D))
        out.append(("decode_attention", (dq, kv, kv, 5), {}))
        pool = torch.from_numpy(_rand(rng, 5, 4, 2, D))
        bt = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
        out.append(("paged_decode_attention", (dq, pool, pool, bt, 5), {}))
    for N in (64, 16):
        r = torch.from_numpy(_rand(rng, 1, 2, 5, N))
        out.append(("wkv6", (r, r, r, r, torch.zeros(2, N)), {}))
    for N, state in ((8, False), (17, True)):
        dt, Bm, Cm, x, A, D = _t(*_mamba_np(N=N))
        kw = {"initial_state": torch.zeros(2, 8, N), "return_state": True}
        out.append(("mamba_scan", (dt, Bm, Cm, x, A, D),
                    kw if state else {}))
    out.append(("moe_dispatch_combine", _t(*_moe_np()), {"capacity": 16}))
    return out


def test_card_auto_selection_never_takes_a_plain_impl_for_a_covered_form(
        monkeypatch):
    """With the platform check faked to ``cuda``: every form a kernel
    covers selects the kernel, at a shape it takes and at one it does not
    (whose launch would raise); the forms no kernel covers select the
    plain versions the reference's dispatcher picks; a named plain
    backend is taken."""
    monkeypatch.setattr(dispatch, "call_platform", lambda args: "cuda")
    for op, args, kw in _covered_calls():
        assert dispatch.select(op, *args, **kw).backend == "cuda", (op, kw)
        assert dispatch.select(op, *args, backend="ref", **kw).backend == \
            "ref"
        with dispatch.force_backend("xla"):
            assert dispatch.select(op, *args, **kw).backend == "xla"
    r = torch.zeros(1, 2, 5, 64)
    for kw in ({"return_state": True},
               {"initial_state": torch.zeros(1, 2, 64, 64)}):
        assert dispatch.select("wkv6", r, r, r, r, torch.zeros(2, 64),
                               **kw).backend == "ref"
    q5 = torch.zeros(2, 2, 2, 3, 64)
    kv = torch.zeros(2, 2, 9, 64)
    lens = torch.ones(2, 3, dtype=torch.int32)
    assert dispatch.select("decode_attention", q5, kv, kv,
                           lens).backend == "xla"
    pool = torch.zeros(5, 4, 2, 64)
    bt = torch.zeros(2, 2, dtype=torch.int32)
    assert dispatch.select("paged_decode_attention", q5, pool, pool, bt,
                           lens).backend == "xla"


def test_no_spmd_skip_under_a_mesh(monkeypatch):
    """The port's kernels run on local shards, so an active mesh changes
    no selection (the reference skips its Pallas impls there)."""
    import dataclasses
    import importlib
    sharding = importlib.import_module("repro_torch.core.sharding")
    monkeypatch.setattr(dispatch, "call_platform", lambda args: "cuda")
    monkeypatch.setattr(sharding, "current_mesh", lambda: object())
    assert "spmd_safe" not in {f.name for f in
                               dataclasses.fields(dispatch.Impl)}
    for op, args, kw in _covered_calls():
        assert dispatch.select(op, *args, **kw).backend == "cuda", op


def test_cuda_impl_gates_are_the_wrappers_supports():
    """Named ``cuda`` takes a shape only where ``ops.supports_<op>`` does
    (on the card, faked)."""
    for op, args, kw in _covered_calls():
        impl = dispatch.backends(op)["cuda"]
        if op == "flash_attention":
            want = ops.supports_flash_attention(args[0].shape, args[1].shape)
        elif op == "decode_attention":
            want = ops.supports_decode_attention(args[0].shape,
                                                 args[1].shape)
        elif op == "paged_decode_attention":
            want = ops.supports_paged_decode_attention(
                args[0].shape, args[1].shape, args[3].shape)
        elif op == "wkv6":
            want = ops.supports_wkv6(args[0].shape)
        elif op == "mamba_scan":
            want = ops.supports_mamba_scan(args[3].shape,
                                           args[1].shape[-1])
        else:
            want = True
        assert impl.eligible("cuda", args, kw, auto=False) is want, op
        assert not impl.eligible("cpu", args, kw, auto=False)


# --------------------------------------------------------------------------- #
# (d) backend agreement on small shapes, port and reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backends_agree(causal):
    from repro.kernels import ops as jops
    arrays = _flash_np()
    q, k, v = _t(*arrays)
    outs = {b: ops.flash_attention(q, k, v, causal=causal, block_q=32,
                                   block_k=64, backend=b).numpy()
            for b in ("ref", "xla")}
    jq, jk, jv = _j(*arrays)
    for b in ("ref", "xla"):
        want = _np(jops.flash_attention(jq, jk, jv, causal=causal,
                                        block_q=32, block_k=64, backend=b))
        np.testing.assert_allclose(outs[b], want, atol=TOL, rtol=TOL,
                                   err_msg=f"port {b} vs reference {b}")
    np.testing.assert_allclose(outs["xla"], outs["ref"], atol=TOL, rtol=TOL)


def test_decode_backends_agree():
    """4-d and the 5-d mixed form, dense and paged (int8 too)."""
    from repro.kernels import ops as jops
    from repro.kernels.quant import quantize_kv as jquant
    arrays = _decode_np()
    jargs = _j(*arrays)
    want = _np(jops.decode_attention(*jargs, backend="ref"))
    for b in ("ref", "xla"):
        got = ops.decode_attention(*_t(*arrays), backend=b).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    rng = np.random.default_rng(6)
    q5 = _rand(rng, 2, 2, 4, 3, 64)
    lens = np.array([[3, 4, 5], [100, 101, 102]], np.int32)
    want = _np(jops.decode_attention(*_j(q5, *arrays[1:3], lens),
                                     backend="xla"))
    for b in ("ref", "xla"):
        got = ops.decode_attention(*_t(q5, *arrays[1:3], lens),
                                   backend=b).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    pool = _rand(rng, 9, 16, 2, 64)
    vpool = _rand(rng, 9, 16, 2, 64)
    bt = np.array([[1, 2, 3], [4, 8, 0]], np.int32)
    kvl = np.array([40, 17], np.int32)
    for q_, kl in ((arrays[0], kvl), (q5, np.minimum(lens, 48))):
        want = _np(jops.paged_decode_attention(*_j(q_, pool, vpool, bt, kl),
                                               backend="xla"))
        for b in ("ref", "xla"):
            got = ops.paged_decode_attention(*_t(q_, pool, vpool, bt, kl),
                                             backend=b).numpy()
            np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    kq, ks = jquant(*_j(pool))
    vq, vs = jquant(*_j(vpool))
    want = _np(jops.paged_decode_attention(
        *_j(arrays[0]), kq, vq, *_j(bt, kvl), k_scale=ks, v_scale=vs,
        backend="ref"))
    ints = _t(*(np.array(a) for a in (kq, vq, ks, vs)))
    for b in ("ref", "xla"):
        got = ops.paged_decode_attention(
            *_t(arrays[0]), ints[0], ints[1], *_t(bt, kvl), k_scale=ints[2],
            v_scale=ints[3], backend=b).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_wkv6_backends_agree_and_state_matches_oracle():
    from repro.kernels import ops as jops
    arrays = _wkv_np()
    a = ops.wkv6(*_t(*arrays), chunk=16, backend="ref")
    b = ops.wkv6(*_t(*arrays), chunk=16, backend="xla")
    torch.testing.assert_close(a, b, atol=5 * TOL, rtol=5 * TOL)
    out, state = ops.wkv6(*_t(*arrays), chunk=16, return_state=True)
    jout, jstate = jops.wkv6(*_j(*arrays), chunk=16, return_state=True,
                             backend="ref")
    np.testing.assert_allclose(out.numpy(), _np(jout), atol=5 * TOL,
                               rtol=5 * TOL)
    np.testing.assert_allclose(state.numpy(), _np(jstate), atol=5 * TOL,
                               rtol=5 * TOL)


def test_wkv6_carried_state_splits_sequence():
    """Running [0:T/2] then [T/2:T] with the carried state equals one
    full-length pass (the serve path contract)."""
    r, k, v, w, u = _t(*_wkv_np(T=64))
    full, s_full = ops.wkv6(r, k, v, w, u, chunk=16, return_state=True)
    cut = lambda x, a, b: x[:, :, a:b]
    o1, s1 = ops.wkv6(*(cut(x, 0, 32) for x in (r, k, v, w)), u, chunk=16,
                      return_state=True, backend="xla")
    o2, s2 = ops.wkv6(*(cut(x, 32, 64) for x in (r, k, v, w)), u, chunk=16,
                      initial_state=s1, return_state=True, backend="xla")
    torch.testing.assert_close(torch.cat([o1, o2], 2), full, atol=5 * TOL,
                               rtol=5 * TOL)
    torch.testing.assert_close(s2, s_full, atol=5 * TOL, rtol=5 * TOL)


@pytest.mark.parametrize("state", [False, True])
def test_scan_backends_agree(state):
    """The port's chunked associative scan (``xla``, an uneven tail
    chunk) and its sequential one (``ref``) against the reference's two."""
    from repro.kernels import ops as jops
    arrays = _mamba_np()
    h0 = np.random.default_rng(7).standard_normal((2, 8, 4)).astype(
        np.float32) if state else None
    kw = dict(chunk=16, return_state=True)
    jkw = dict(kw, initial_state=None if h0 is None else _j(h0)[0])
    tkw = dict(kw, initial_state=None if h0 is None else _t(h0)[0])
    for b in ("ref", "xla"):
        y, h = ops.mamba_scan(*_t(*arrays), backend=b, **tkw)
        jy, jh = jops.mamba_scan(*_j(*arrays), backend=b, **jkw)
        np.testing.assert_allclose(y.numpy(), _np(jy), atol=5 * TOL,
                                   rtol=5 * TOL, err_msg=b)
        np.testing.assert_allclose(h.numpy(), _np(jh), atol=5 * TOL,
                                   rtol=5 * TOL, err_msg=b)


def test_moe_backends_agree():
    """Scatter / gather (``xla``) and the dense oracle (``ref``), with
    drops (capacity 12 of 16 assignments an expert), against the
    reference's two."""
    from repro.kernels import ops as jops
    arrays = _moe_np()
    outs = {}
    for b in ("ref", "xla"):
        outs[b] = ops.moe_dispatch_combine(*_t(*arrays), capacity=12,
                                           backend=b).numpy()
        want = _np(jops.moe_dispatch_combine(*_j(*arrays), capacity=12,
                                             backend=b))
        np.testing.assert_allclose(outs[b], want, atol=TOL, rtol=TOL,
                                   err_msg=b)
    np.testing.assert_allclose(outs["xla"], outs["ref"], atol=TOL, rtol=TOL)


def test_plain_backends_are_differentiable():
    """The chunked core and the chunked scan differentiate to the plain
    versions' gradients."""
    q, k, v = _t(*_flash_np(S=64))
    q.requires_grad_()
    g_xla, = torch.autograd.grad(ops.flash_attention(
        q, k, v, block_q=32, block_k=32, backend="xla").sum(), q)
    g_ref, = torch.autograd.grad(ref.attention_ref(q, k, v).sum(), q)
    torch.testing.assert_close(g_xla, g_ref, atol=1e-4, rtol=1e-4)
    dt, Bm, Cm, x, A, D = _t(*_mamba_np())
    x.requires_grad_()
    grads = [torch.autograd.grad(ops.mamba_scan(
        dt, Bm, Cm, x, A, D, chunk=16, backend=b).pow(2).sum(), x)[0]
        for b in ("ref", "xla")]
    torch.testing.assert_close(grads[1], grads[0], atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------- #
# (e) the train step and the engine under a forced backend
# --------------------------------------------------------------------------- #
def test_train_step_and_engine_force_their_backend(monkeypatch):
    """``TrainConfig.kernel_backend`` and ``ServeConfig.kernel_backend``
    are in force inside the step (the dispatcher sees them), and only
    there."""
    from repro_torch import configs
    from repro_torch.data import make_dataset
    from repro_torch.models import lm
    from repro_torch.models.arch import ShapeSpec
    from repro_torch.optim import adamw_init
    from repro_torch.serve import Request, ServeConfig, ServeEngine
    from repro_torch.train import TrainConfig, make_train_step
    seen = []
    real = dispatch.select

    def spy(op, *a, **kw):
        impl = real(op, *a, **kw)
        seen.append(impl.backend)
        return impl
    monkeypatch.setattr(dispatch, "select", spy)
    arch = configs.reduced("llama3.2-1b")
    params = lm.init_lm(arch, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in make_dataset(
        arch, ShapeSpec("t", 16, 2, "train")).batch_at(0).items()}
    step = make_train_step(arch, None, TrainConfig(kernel_backend="xla"))
    step(lm.tree_map(lambda t: t.clone(), params), adamw_init(params), batch)
    assert seen and set(seen) == {"xla"}
    seen.clear()
    eng = ServeEngine(params, arch, ServeConfig(
        max_batch=2, max_len=24, kv_block_size=4, kernel_backend="ref"))
    eng.run([Request(uid=0, prompt=(1, 2, 3, 4, 5), max_new_tokens=3)])
    assert seen and set(seen) == {"ref"}
    seen.clear()
    q, k, v = _t(*_flash_np())
    dispatch.select("flash_attention", q, k, v)
    assert seen == ["ref"]


def test_commands_take_the_kernel_flags(tmp_path, capsys):
    """Both commands on the CPU with ``--kernel-backend ref``,
    ``--autotune-cache-dir`` and ``--device-profile``: they run, name the
    profile, leave the cache directory setting as it was, and the serve
    command's tokens equal its default run's."""
    import os
    from repro_torch.launch import serve, train
    from repro_torch.profiling import DeviceProfile
    prof = DeviceProfile(device_kind="TestChip v0", measured_flops=1e12,
                         measured_hbm_bw=1e11, meta={"torch": "test"})
    path = prof.save(tmp_path / "p.json")
    flags = ["--kernel-backend", "ref", "--autotune-cache-dir",
             str(tmp_path / "tune"), "--device-profile", str(path)]
    before = os.environ.get(dispatch.ENV_CACHE_DIR)
    hist = train.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq", "16", "--width", "64", "--depth", "2",
                       "--vocab", "64", "--ckpt-every", "0"] + flags)
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    argv = ["--device", "cpu", "--batch", "2", "--requests", "3",
            "--prompt-len", "9", "--gen", "3", "--kv-block-size", "4",
            "--width", "128", "--depth", "2", "--vocab", "64"]
    got = serve.main(argv + flags)
    want = serve.main(argv)
    out = capsys.readouterr().out
    assert out.count(f"plan: device profile {path} [TestChip v0]") == 2
    assert os.environ.get(dispatch.ENV_CACHE_DIR) == before
    toks = lambda r: {c.uid: c.tokens for c in r["completions"]}
    assert toks(got) == toks(want)
    with pytest.raises(SystemExit):
        train.parser().parse_args(["--kernel-backend", "interpret"])


def test_require_kernel_shapes_takes_any_width_under_a_plain_backend():
    """On the card a plain backend launches nothing, so no width is
    refused for the kernels' sake."""
    from repro_torch import configs
    from repro_torch.launch.train import reduced_arch, require_kernel_shapes
    arch = reduced_arch(configs.get("llama3.2-1b"), 256, 2, 512)
    with pytest.raises(ValueError, match="--width 0"):
        require_kernel_shapes(arch, torch.device("cuda"))
    with pytest.raises(ValueError, match="--width 0"):
        require_kernel_shapes(arch, torch.device("cuda"), "cuda")
    for b in ("ref", "xla"):
        require_kernel_shapes(arch, torch.device("cuda"), b)


def test_plan_meta_carries_the_profile_fingerprint(tmp_path):
    """``resolve_plan(profile_path=)`` (the commands' ``--device-profile``)
    loads the profile, searches under it and records its fingerprint."""
    from repro_torch import configs
    from repro_torch.core import h100_mesh_spec
    from repro_torch.plans import ParallelPlan, resolve_plan
    from repro_torch.profiling import DeviceProfile
    prof = DeviceProfile(device_kind="TestChip v0", measured_flops=5e13,
                         measured_hbm_bw=3e12, meta={"torch": "test"})
    path = prof.save(tmp_path / "p.json")
    arch = configs.reduced("llama3.2-1b")
    logs = []
    plan = resolve_plan(arch, h100_mesh_spec(1, 2, 1), phases=("train",),
                        strategy="searched", train_seq=32, train_batch=4,
                        save_plan=str(tmp_path / "plan.json"),
                        profile_path=str(path), log=logs.append)
    assert plan.meta["device_profile"] == prof.fingerprint()
    back = ParallelPlan.load(tmp_path / "plan.json", arch=arch)
    assert back.meta["device_profile"]["torch"] == "test"
    assert back.mesh.chip.eff_flops == pytest.approx(5e13)
    assert any("calibrates the cost model" in m for m in logs)
    json.loads((tmp_path / "plan.json").read_text())
