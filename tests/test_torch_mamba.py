"""The port's Mamba path against the JAX reference on the CPU, with the
same numpy inputs and the reference's weights (moved across by the
bridge):

* the config copy (``jamba_1_5_large``);
* ``ref.mamba_scan_ref`` (the plain version of the CUDA kernel, what a CPU
  tensor runs) against the reference's ``mamba_scan_ref``, against its
  Pallas kernel in interpret mode for the stateless form, and against
  ``mamba_scan_xla`` with a carried state; a sequence split in two with
  the state carried equals the whole;
* ``_causal_conv1d`` and ``mamba_mix``: stateless, with a state, and in a
  mixed step whose ``q_lens`` leave rows idle (their state must come out
  bitwise unchanged);
* ``forward``, ``loss_fn`` and every gradient leaf on reduced jamba;
  ``prefill``, ``decode_step`` and ``step`` over dense and paged caches;
* the serve path: ``make_serve_fns``' paged mixed step (the chunk pass
  on row views of the Mamba state), the prefix cache staying off on a
  recurrent stack, ``ServeEngine`` token for token against the reference
  engine in four modes, and chunked against stall-the-world.

Float32 tolerance 1e-5 (the same math, sums in another order); bfloat16
scan outputs 1e-2 of the largest (one bf16 rounding of y; the state
stays float32, 1e-5); gradients 1e-4 of a leaf's largest entry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import configs as C
from repro.core.config import LayerConfig
from repro.kernels import mamba_scan as jms
from repro.models import lm as jlm
from repro.models import recurrent as jrc
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve.fns import make_serve_fns as jmake_serve_fns
from repro_torch import configs as TC
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.kernels import ops, ref
from repro_torch.models import lm
from repro_torch.models import recurrent as rc
from repro_torch.serve import Request, ServeConfig, ServeEngine
from repro_torch.serve.fns import make_serve_fns
from test_torch_decode import drive, engines_agree, trace

TOL = 1e-5
GRAD_TOL = 1e-4
NAME = "jamba_1_5_large"
ARCH = C.reduced(NAME)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=tol)


def _rel_close(got, want, tol):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * scale, (err, scale)


def scan_case(seed, *, B=2, S=13, di=24, N=4, state=False):
    """dt > 0 as softplus gives it, A = -exp(log(1..N) + noise), D near 1,
    B/C/x of order 1; an initial state when ``state``."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    dt = np.log1p(np.exp(f(B, S, di) - 2)).astype(np.float32)
    A = -np.exp(np.log(np.arange(1, N + 1, dtype=np.float32))[None]
                + 0.1 * f(di, N)).astype(np.float32)
    D = (1 + 0.1 * f(di)).astype(np.float32)
    h0 = f(B, di, N) if state else None
    return dt, f(B, S, N), f(B, S, N), f(B, S, di), A, D, h0


def _both(arrays, dtype=np.float32):
    """The same arrays as jax and torch tensors; the four sequence inputs
    in ``dtype`` (rounded once, from float32, on both sides)."""
    j, t = [], []
    for i, a in enumerate(arrays):
        if a is None:
            j.append(None)
            t.append(None)
            continue
        ja, ta = jnp.asarray(a), torch.from_numpy(a)
        if i < 4 and dtype != np.float32:
            ja, ta = ja.astype(jnp.bfloat16), ta.to(torch.bfloat16)
        j.append(ja)
        t.append(ta)
    return j, t


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.float().numpy()


# --------------------------------------------------------------------------- #
def test_config_is_a_copy_of_the_reference():
    full = TC.get("jamba-1.5-large-398b")
    assert dataclasses.asdict(full) == dataclasses.asdict(C.get(NAME))
    assert dataclasses.asdict(TC.reduced(NAME)) == dataclasses.asdict(ARCH)
    # the published widths the one-card cut keeps
    assert (full.d_model, full.n_heads, full.n_kv_heads, full.hd) == (
        8192, 64, 8, 128)
    assert (full.d_inner, full.ssm_state, full.ssm_conv) == (16384, 16, 4)
    assert (full.n_experts, full.top_k, full.moe_d_ff, full.vocab) == (
        16, 2, 24576, 65536)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 13, 70])
def test_scan_ref_matches_reference(S, dtype):
    """The stateless form at S = 1, an uneven S, and S > chunk (the chunk
    checkpointing of both sides), in float32 and bfloat16."""
    np_dtype = np.float32 if dtype == "float32" else "bf16"
    j, t = _both(scan_case(S)[:6], np_dtype)
    want = jms.mamba_scan_ref(*j, chunk=64)
    got = ref.mamba_scan_ref(*t, chunk=64)
    assert got.dtype == t[3].dtype and got.shape == t[3].shape
    _rel_close(_f32(got), _f32(want), 1e-2 if dtype == "bfloat16" else TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk", [(16, 8), (7, 64), (1, 64)])
def test_scan_ref_matches_pallas_interpret(S, chunk, dtype):
    """Against the TPU kernel itself (interpret mode), the stateless form
    it takes (its S % chunk rule holds here)."""
    np_dtype = np.float32 if dtype == "float32" else "bf16"
    j, t = _both(scan_case(100 + S, S=S, di=32, N=8)[:6], np_dtype)
    want = jms.mamba_scan_pallas(*j, chunk=chunk, interpret=True)
    got = ops.mamba_scan(*t, chunk=chunk)
    _rel_close(_f32(got), _f32(want), 1e-2 if dtype == "bfloat16" else TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 21])
def test_stateful_scan_matches_xla_and_splits(S, dtype):
    """initial_state in, the final state out: against ``mamba_scan_xla``;
    and the sequence split in two with the state carried equals the
    whole."""
    np_dtype = np.float32 if dtype == "float32" else "bf16"
    case = scan_case(200 + S, S=S, state=True)
    j, t = _both(case, np_dtype)
    wy, wh = jms.mamba_scan_xla(*j[:6], chunk=8, initial_state=j[6],
                                return_state=True)
    gy, gh = ops.mamba_scan(*t[:6], chunk=8, initial_state=t[6],
                            return_state=True)
    assert gh.dtype == torch.float32
    ytol = 1e-2 if dtype == "bfloat16" else TOL
    _rel_close(_f32(gy), _f32(wy), ytol)
    _rel_close(gh.numpy(), np.asarray(wh), TOL)
    if S == 1:
        return
    cut = S // 3
    first = [a[:, :cut] for a in t[:4]]
    second = [a[:, cut:] for a in t[:4]]
    y1, h1 = ops.mamba_scan(*first, *t[4:6], initial_state=t[6],
                            return_state=True)
    y2, h2 = ops.mamba_scan(*second, *t[4:6], initial_state=h1,
                            return_state=True)
    _rel_close(_f32(torch.cat([y1, y2], 1)), _f32(gy), ytol)
    _rel_close(h2.numpy(), gh.numpy(), TOL)


def test_scan_ref_dt_zero_keeps_the_state_bitwise():
    dt, Bm, Cm, x, A, D, h0 = (torch.from_numpy(a) if a is not None else a
                               for a in scan_case(7, state=True))
    dt[1] = 0
    _, hN = ref.mamba_scan_ref(dt, Bm, Cm, x, A, D, initial_state=h0,
                               return_state=True)
    assert torch.equal(hN[1], h0[1]) and not torch.equal(hN[0], h0[0])


# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def mixer():
    jp = jrc.init_mamba(jax.random.PRNGKey(3), ARCH, jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def test_init_mamba_layout_and_rules(mixer):
    jp, _ = mixer
    tp = rc.init_mamba(ARCH, torch.float32,
                       generator=torch.Generator().manual_seed(0),
                       device="cpu", lead=(3,))
    for k, v in jp.items():
        assert tuple(tp[k].shape) == (3, *v.shape), k
    bf = rc.init_mamba(ARCH, torch.bfloat16,
                       generator=torch.Generator().manual_seed(0),
                       device="cpu")
    assert bf["A_log"].dtype == torch.float32 and bf["D"].dtype == \
        torch.float32 and bf["in_proj"].dtype == torch.bfloat16
    _close(tp["A_log"][1], jp["A_log"])
    assert float(tp["dt_bias"].max()) == float(tp["dt_bias"].min()) == \
        pytest.approx(-4.6)
    assert not tp["conv_b"].any()


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(with_state):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    st = rng.standard_normal((2, 3, 16)).astype(np.float32) \
        if with_state else None
    wo, wxp = jrc._causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), None if st is None
                                 else jnp.asarray(st))
    go, gxp = rc._causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b), None if st is None
                                else torch.from_numpy(st))
    _close(go, wo)
    _close(gxp, wxp)


def _state(seed, B):
    rng = np.random.default_rng(seed)
    return {"conv": rng.standard_normal(
                (B, ARCH.ssm_conv - 1, ARCH.d_inner)).astype(np.float32),
            "ssm": rng.standard_normal(
                (B, ARCH.d_inner, ARCH.ssm_state)).astype(np.float32)}


def test_mamba_mix_stateless_and_stateful(mixer):
    jp, tp = mixer
    x = np.random.default_rng(12).standard_normal(
        (2, 10, ARCH.d_model)).astype(np.float32)
    cfg = LayerConfig()
    wy, wst = jrc.mamba_mix(jp, jnp.asarray(x), ARCH, cfg, chunk=4)
    gy, gst = rc.mamba_mix(tp, torch.from_numpy(x), ARCH, chunk=4)
    _close(gy, wy)
    assert wst["ssm"] is None and gst["ssm"] is None
    _close(gst["conv"], wst["conv"])
    st = _state(13, 2)
    wy, wst = jrc.mamba_mix(jp, jnp.asarray(x), ARCH, cfg, chunk=4,
                            state=jax.tree.map(jnp.asarray, st))
    tst = params_from_jax(st, "cpu")
    leaves = dict(tst)
    gy, gst = rc.mamba_mix(tp, torch.from_numpy(x), ARCH, chunk=4,
                           state=tst)
    _close(gy, wy)
    for k in ("conv", "ssm"):
        _close(gst[k], wst[k])
        assert gst[k] is leaves[k]          # written in place


def test_mamba_mix_mixed_step_leaves_idle_rows_bitwise(mixer):
    """q_lens (5, 2, 0): row 2 sits the step out; its conv window and SSM
    state come out bitwise unchanged, and live positions match."""
    jp, tp = mixer
    x = np.random.default_rng(14).standard_normal(
        (3, 5, ARCH.d_model)).astype(np.float32)
    q_lens = np.array([5, 2, 0], np.int32)
    st = _state(15, 3)
    wy, wst = jrc.mamba_mix(jp, jnp.asarray(x), ARCH, LayerConfig(), chunk=4,
                            state=jax.tree.map(jnp.asarray, st),
                            q_lens=jnp.asarray(q_lens))
    tst = params_from_jax(st, "cpu")
    before = {k: v.clone() for k, v in tst.items()}
    gy, gst = rc.mamba_mix(tp, torch.from_numpy(x), ARCH, chunk=4,
                           state=tst, q_lens=torch.from_numpy(q_lens))
    _close(gy[0], wy[0])
    _close(gy[1, :2], wy[1, :2])
    for k in ("conv", "ssm"):
        _close(gst[k], wst[k])
        assert torch.equal(gst[k][2], before[k][2])
        assert not torch.equal(gst[k][1], before[k][1])


# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jamba():
    jp = jlm.init_lm(jax.random.PRNGKey(0), ARCH, jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def test_forward_loss_and_gradients_on_reduced_jamba(jamba):
    jp, tp = jamba
    toks = np.random.default_rng(16).integers(0, ARCH.vocab, (2, 11))
    jb = {"tokens": jnp.asarray(toks, jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks)}
    want, waux = jlm.forward(jp, jb, ARCH, time_chunk=4)
    got, aux = lm.forward(tp, tb, ARCH, time_chunk=4)
    _close(got, want)
    _close(aux, waux)
    (wl, wm), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jb, ARCH, time_chunk=4), has_aux=True)(jp)
    leaves = lm.tree_map(lambda t: t.clone().requires_grad_(), tp)
    tl, tm = lm.loss_fn(leaves, tb, ARCH, time_chunk=4)
    tl.backward()
    _close(tl.detach(), wl)
    for k in ("nll", "accuracy", "aux"):
        _close(tm[k].detach(), wm[k])
    jflat = dict(lm.tree_leaves(jax.tree.map(np.asarray, jg)))
    n_ssm = 0
    for path, t in lm.tree_leaves(leaves):
        assert t.grad is not None, path
        _rel_close(t.grad.numpy(), jflat[path], GRAD_TOL)
        n_ssm += "ssm" in path
    assert n_ssm == 9


def _caches(kind, B=3):
    if kind == "dense":
        return (jlm.init_cache(ARCH, B, 16, jnp.float32),
                lm.init_cache(ARCH, B, 16, torch.float32, device="cpu"), None)
    tables = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    return (jlm.init_paged_cache(ARCH, 6, 4, B, jnp.float32),
            lm.init_paged_cache(ARCH, 6, 4, B, torch.float32, device="cpu"),
            tables)


def _state_leaves(cache):
    return {p: np.asarray(a) for p, a in lm.tree_leaves(cache)
            if "ssm_state" in p}


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_prefill_step_and_decode_over_caches(jamba, kind):
    """A ragged mixed step (rows prefill 6, 3 and nothing), then two
    single-token decodes with per-slot positions: logits of the live rows
    and every Mamba state leaf (the idle row's included) against the
    reference; then a batch-1 prefill into a dense row."""
    jp, tp = jamba
    jc, tc, tables = _caches(kind)
    assert tc["l0"]["ssm_state"]["ssm"].dtype == torch.float32
    assert tuple(tc["l0"]["ssm_state"]["conv"].shape) == (
        ARCH.n_units, 3, ARCH.ssm_conv - 1, ARCH.d_inner)
    jbt = None if tables is None else jnp.asarray(tables)
    tbt = None if tables is None else torch.from_numpy(tables)
    rng = np.random.default_rng(17)
    toks = rng.integers(0, ARCH.vocab, (3, 6))
    q_lens = np.array([6, 3, 0], np.int32)
    pos = np.zeros(3, np.int32)
    want, jc = jlm.step(jp, jnp.asarray(toks, jnp.int32), jc,
                        jnp.asarray(pos), ARCH, q_lens=jnp.asarray(q_lens),
                        block_tables=jbt)
    got, tc = lm.step(tp, torch.from_numpy(toks), tc, torch.from_numpy(pos),
                      ARCH, q_lens=torch.from_numpy(q_lens),
                      block_tables=tbt)
    _close(got[0], want[0])
    _close(got[1, :3], want[1, :3])
    pos = q_lens.copy()
    for _ in range(2):
        tok = rng.integers(0, ARCH.vocab, (3, 1))
        want, jc = jlm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc,
                                   jnp.asarray(pos), ARCH, block_tables=jbt)
        got, tc = lm.decode_step(tp, torch.from_numpy(tok), tc,
                                 torch.from_numpy(pos), ARCH,
                                 block_tables=tbt)
        _close(got[:2], want[:2])
        pos = pos + 1
    want_st = _state_leaves(jax.tree.map(np.asarray, jc))
    got_st = _state_leaves(params_to_numpy(tc))
    assert len(got_st) == 2
    for p, a in got_st.items():
        _close(a, want_st[p])
    prompt = rng.integers(0, ARCH.vocab, (1, 7))
    jrow = jlm.init_cache(ARCH, 1, 8, jnp.float32)
    trow = lm.init_cache(ARCH, 1, 8, torch.float32, device="cpu")
    want, jrow = jlm.prefill(jp, {"tokens": jnp.asarray(prompt, jnp.int32)},
                             jrow, ARCH)
    got, trow = lm.prefill(tp, {"tokens": torch.from_numpy(prompt)}, trow,
                           ARCH)
    _close(got, want)
    jflat = dict(lm.tree_leaves(jax.tree.map(np.asarray, jrow)))
    for p, a in lm.tree_leaves(params_to_numpy(trow)):
        _close(a, jflat[p])


def test_paged_mixed_step_runs_the_chunk_on_state_row_views(jamba):
    """``make_serve_fns``' step over a paged cache: the (1, T) chunk pass
    of the granted row reads and writes that row of every Mamba state leaf
    (views ``leaf[:, g:g+1]``), the KV pool whole; logits and the whole
    cache equal the reference's step."""
    jp, tp = jamba
    jc, tc, tables = _caches("paged")
    rng = np.random.default_rng(18)
    for leaf in ("conv", "ssm"):                  # live carried states
        for j in ("l0",):
            s = rng.standard_normal(tuple(
                tc[j]["ssm_state"][leaf].shape)).astype(np.float32)
            tc[j]["ssm_state"][leaf].copy_(torch.from_numpy(s))
            jc[j]["ssm_state"][leaf] = jnp.asarray(s)
    toks = rng.integers(0, ARCH.vocab, (3, 5))
    q_lens = np.array([1, 5, 0], np.int32)        # row 1 takes the chunk
    pos = np.array([3, 0, 0], np.int32)
    _, jstep = jmake_serve_fns(ARCH)
    _, tstep = make_serve_fns(ARCH)
    before = tc["l0"]["ssm_state"]["ssm"].clone()
    want, jc = jstep(jp, jnp.asarray(toks, jnp.int32), jc, jnp.asarray(pos),
                     q_lens=jnp.asarray(q_lens),
                     block_tables=jnp.asarray(tables))
    got, tc = tstep(tp, torch.from_numpy(toks), tc, torch.from_numpy(pos),
                    q_lens=torch.from_numpy(q_lens),
                    block_tables=torch.from_numpy(tables))
    assert tuple(got.shape) == (3, 1, ARCH.vocab)
    _close(got[:2], want[:2])
    after = tc["l0"]["ssm_state"]["ssm"]
    assert torch.equal(after[:, 2], before[:, 2])          # idle row
    assert not torch.equal(after[:, 1], before[:, 1])      # the chunk row
    jflat = dict(lm.tree_leaves(jax.tree.map(np.asarray, jc)))
    for p, a in lm.tree_leaves(params_to_numpy(tc)):
        if "kv" in p:
            a, b = a[:, 1:], jflat[p][:, 1:]               # live blocks
        else:
            b = jflat[p]
        _close(a, b)


# --------------------------------------------------------------------------- #
MODES = {"paged-chunked": dict(kv_block_size=4, prefill_chunk_tokens=5),
         "paged-stall-the-world": dict(kv_block_size=4,
                                       prefill_chunk_tokens=0),
         "dense-chunked": dict(kv_block_size=0, prefill_chunk_tokens=5),
         "dense-stall-the-world": dict(kv_block_size=0,
                                       prefill_chunk_tokens=0)}


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_reference_token_for_token(mode):
    eng, got = engines_agree(NAME, mode, MODES)
    assert eng.paged == mode.startswith("paged")
    assert eng.prefix is None and eng.prefill_tokens_saved == 0
    assert "ssm_state" in eng.cache["l0"]


def test_prefix_cache_stays_off_on_a_recurrent_stack():
    """Requested on a paged, chunked engine, the prefix cache is on for an
    attention-only stack and off for a Mamba hybrid: skipping cached
    blocks would feed the Mamba state only the uncached tail.  The
    request changes no token (the reference engine's are checked by
    ``test_engine_matches_reference_token_for_token``)."""
    tp = lm.init_lm(ARCH, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    mode = MODES["paged-chunked"]
    tr = trace(ARCH.vocab)
    runs = {}
    for on in (True, False):
        eng = ServeEngine(tp, ARCH, ServeConfig(max_batch=3, max_len=32,
                                                prefix_cache=on, **mode))
        assert eng.paged and eng.chunked and eng.prefix is None
        runs[on] = drive(eng, [Request(uid=i, prompt=p, max_new_tokens=n)
                               for i, p, n in tr])
    assert runs[True] == runs[False]
    llama = TC.reduced("llama3_2_1b")
    dense = lm.init_lm(llama, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    assert ServeEngine(dense, llama, ServeConfig(
        max_batch=3, max_len=32, **mode)).prefix is not None


def _serve(params, arch, specs, lens, *, chunk, kv_block_size,
           reference=False):
    """One engine pass (the port's, or the reference's) with staggered
    admits and a mid-decode submit; returns {uid: (tokens, reason)}."""
    eng_cls, cfg_cls, req_cls = ((JServeEngine, JServeConfig, JRequest)
                                 if reference else
                                 (ServeEngine, ServeConfig, Request))
    engine = eng_cls(params, arch, cfg_cls(
        max_batch=2, max_len=24, kv_block_size=kv_block_size,
        prefill_chunk_tokens=chunk))
    engine.warmup(lens)
    reqs = [req_cls(uid=i, **sp) for i, sp in enumerate(specs)]
    for r in reqs[:3]:
        engine.submit(r)
    got = []
    for _ in range(2):
        got.extend(engine.step())
    for r in reqs[3:]:
        engine.submit(r)
    while engine.busy:
        got.extend(engine.step())
    assert engine.stats["retired"] == len(reqs)
    return {c.uid: (list(c.tokens), c.finish_reason) for c in got}


@pytest.mark.parametrize("kv_block_size", [0, 4], ids=["dense", "paged"])
def test_chunked_matches_stall_the_world_oracle(kv_block_size):
    """The reference's ``test_mixed_step`` oracle on jamba, in the port:
    chunk 4 splits every prompt into several mixed steps, and the
    completions (tokens and finish reasons, an EOS mid-stream among them)
    equal the chunk-0 engine's, which equal the reference engine's."""
    arch = dataclasses.replace(ARCH, capacity_factor=8.0)
    jp = jlm.init_lm(jax.random.PRNGKey(0), arch, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    lens, news = [5, 9, 3, 9, 5], [4, 2, 6, 3, 5]
    rng = np.random.default_rng(0)
    prompts = [tuple(int(t) for t in rng.integers(1, arch.vocab, n))
               for n in lens]
    free = _serve(tp, arch, [dict(prompt=prompts[2], max_new_tokens=news[2])],
                  [3], chunk=0, kv_block_size=kv_block_size)[0][0]
    eos2 = next((t for i, t in enumerate(free[1:], 1) if t not in free[:i]),
                None)
    specs = [dict(prompt=prompts[i], max_new_tokens=news[i],
                  eos_id=eos2 if i == 2 else None) for i in range(5)]
    kw = dict(kv_block_size=kv_block_size)
    want = _serve(tp, arch, specs, lens, chunk=0, **kw)
    got = _serve(tp, arch, specs, lens, chunk=4, **kw)
    assert got == want
    if eos2 is not None:
        assert got[2][1] == "eos"
    assert _serve(jp, arch, specs, lens, chunk=0, reference=True,
                  **kw) == want
