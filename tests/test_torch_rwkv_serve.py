"""The port's RWKV6 serve path against the JAX reference on the CPU, on
reduced rwkv6 with the reference's weights (moved across by the bridge):

* ``lm.init_cache`` and ``init_paged_cache`` build the reference's RWKV
  leaves (``tmix_state`` {``shift``, ``wkv`` float32}, ``cmix_state``
  {``shift``}), slot-dense in both;
* ``prefill``, a ragged mixed ``step`` and ``decode_step``: logits and
  every state leaf; a row with ``q_lens == 0`` keeps its state bitwise;
* ``make_serve_fns``' mixed step: the (1, T) chunk pass writes the
  granted row's state into the cache through its row views;
* ``write_slot`` and ``reset_slot_state`` overwrite and zero all three
  leaves;
* ``ServeEngine`` token for token against the reference engine: chunked,
  stall-the-world, and a paged + int8 request, which is inert on a stack
  without attention (dense layout, no int8, no prefix cache, no KV
  bytes); a slot reused back to back leaks nothing; chunked equals
  stall-the-world.

Float32, tolerance 1e-5 on logits and states (the same math, sums in
another order); the mixed step's idle rows bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import configs as C
from repro.models import lm as jlm
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve.fns import make_serve_fns as jmake_serve_fns
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.models import lm
from repro_torch.serve import Request, ServeConfig, ServeEngine
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.fns import make_serve_fns
from test_torch_decode import engines_agree

TOL = 1e-5
NAME = "rwkv6_1b6"
ARCH = C.reduced(NAME)
LEAVES = {("tmix_state", "shift"), ("tmix_state", "wkv"),
          ("cmix_state", "shift")}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=tol)


@pytest.fixture(scope="module")
def rwkv():
    jp = jlm.init_lm(jax.random.PRNGKey(0), ARCH, jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _tree(cache):
    """{path: (shape, dtype name)} of a cache tree."""
    return {p: (tuple(a.shape), str(a.dtype).replace("torch.", ""))
            for p, a in lm.tree_leaves(cache)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_caches_have_the_reference_leaves(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    for jc, tc in ((jlm.init_cache(ARCH, 3, 8, jdt),
                    lm.init_cache(ARCH, 3, 8, tdt, device="cpu")),
                   (jlm.init_paged_cache(ARCH, 5, 4, 3, jdt, kv_quant="int8"),
                    lm.init_paged_cache(ARCH, 5, 4, 3, tdt, kv_quant="int8",
                                        device="cpu"))):
        want = _tree(jax.tree.map(np.asarray, jc))
        assert _tree(tc) == want
        assert {p[1:] for p in want} == LEAVES
        assert want[("l0", "tmix_state", "wkv")] == (
            (ARCH.n_units, 3, ARCH.n_rwkv_heads, ARCH.rwkv_head_size,
             ARCH.rwkv_head_size), "float32")
        assert all(not t.any() for _, t in lm.tree_leaves(tc))


def _live_state(seed, B=3):
    """A nonzero carried state for every RWKV leaf (the reference's tree
    as numpy), so the steps below start mid-sequence."""
    rng = np.random.default_rng(seed)
    jc = jax.tree.map(np.asarray, jlm.init_cache(ARCH, B, 1, jnp.float32))
    return jax.tree.map(
        lambda a: (0.3 * rng.standard_normal(a.shape)).astype(a.dtype), jc)


def _states(cache):
    return dict(lm.tree_leaves(cache))


def test_prefill_step_and_decode_match_the_reference(rwkv):
    """A batch-1 prefill into a fresh row; then, from a live state, a
    ragged mixed step (rows advance 6, 2 and 0 tokens) and two decodes
    with per-slot positions: logits of the live rows and every state leaf
    against the reference, and the idle row's state bitwise unchanged
    after the mixed step."""
    jp, tp = rwkv
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, ARCH.vocab, (1, 7))
    want, jrow = jlm.prefill(jp, {"tokens": jnp.asarray(prompt, jnp.int32)},
                             jlm.init_cache(ARCH, 1, 8, jnp.float32), ARCH)
    got, trow = lm.prefill(tp, {"tokens": torch.from_numpy(prompt)},
                           lm.init_cache(ARCH, 1, 8, torch.float32,
                                         device="cpu"), ARCH)
    _close(got, want)
    jflat = _states(jax.tree.map(np.asarray, jrow))
    for p, a in lm.tree_leaves(params_to_numpy(trow)):
        _close(a, jflat[p])

    st = _live_state(4)
    jc, tc = jax.tree.map(jnp.asarray, st), params_from_jax(st, "cpu")
    toks = rng.integers(0, ARCH.vocab, (3, 6))
    q_lens = np.array([6, 2, 0], np.int32)
    pos = np.array([5, 9, 3], np.int32)
    before = {p: t.clone() for p, t in lm.tree_leaves(tc)}
    want, jc = jlm.step(jp, jnp.asarray(toks, jnp.int32), jc,
                        jnp.asarray(pos), ARCH, q_lens=jnp.asarray(q_lens))
    got, tc = lm.step(tp, torch.from_numpy(toks), tc, torch.from_numpy(pos),
                      ARCH, q_lens=torch.from_numpy(q_lens))
    _close(got[0], want[0])
    _close(got[1, :2], want[1, :2])
    for p, t in lm.tree_leaves(tc):
        assert torch.equal(t[:, 2], before[p][:, 2]), p      # idle row
        assert not torch.equal(t[:, 1], before[p][:, 1]), p
    jflat = _states(jax.tree.map(np.asarray, jc))
    for p, a in lm.tree_leaves(params_to_numpy(tc)):
        _close(a, jflat[p])
    pos = pos + q_lens
    for _ in range(2):
        tok = rng.integers(0, ARCH.vocab, (3, 1))
        want, jc = jlm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc,
                                   jnp.asarray(pos), ARCH)
        got, tc = lm.decode_step(tp, torch.from_numpy(tok), tc,
                                 torch.from_numpy(pos), ARCH)
        _close(got, want)
        pos = pos + 1
    jflat = _states(jax.tree.map(np.asarray, jc))
    for p, a in lm.tree_leaves(params_to_numpy(tc)):
        _close(a, jflat[p])


def test_chunk_pass_writes_the_state_through_row_views(rwkv):
    """``make_serve_fns``' mixed step on the dense layout: the (B, 1)
    decode pass, then the (1, T) chunk pass on the granted row, whose
    state leaves are the views ``leaf[:, g:g+1]``.  The chunk's state
    must land in the cache itself (the step discards the chunk pass's
    returned cache): the whole cache equals the reference's step, and
    the idle row is bitwise unchanged."""
    jp, tp = rwkv
    st = _live_state(5)
    jc, tc = jax.tree.map(jnp.asarray, st), params_from_jax(st, "cpu")
    rng = np.random.default_rng(6)
    toks = rng.integers(0, ARCH.vocab, (3, 5))
    q_lens = np.array([1, 5, 0], np.int32)          # row 1 takes the chunk
    pos = np.array([3, 0, 0], np.int32)
    _, jstep = jmake_serve_fns(ARCH)
    _, tstep = make_serve_fns(ARCH)
    before = {p: t.clone() for p, t in lm.tree_leaves(tc)}
    want, jc = jstep(jp, jnp.asarray(toks, jnp.int32), jc, jnp.asarray(pos),
                     q_lens=jnp.asarray(q_lens))
    got, tc = tstep(tp, torch.from_numpy(toks), tc, torch.from_numpy(pos),
                    q_lens=torch.from_numpy(q_lens))
    assert tuple(got.shape) == (3, 1, ARCH.vocab)
    _close(got[:2], want[:2])
    for p, t in lm.tree_leaves(tc):
        assert torch.equal(t[:, 2], before[p][:, 2]), p      # idle row
        assert not torch.equal(t[:, 1], before[p][:, 1]), p  # the chunk row
    jflat = _states(jax.tree.map(np.asarray, jc))
    for p, a in lm.tree_leaves(params_to_numpy(tc)):
        _close(a, jflat[p])


def test_write_slot_and_reset_cover_every_rwkv_leaf():
    """The admission write replaces slot 1's three state leaves and
    nothing else; the chunked admission's reset zeroes them."""
    cache = lm.init_cache(ARCH, 3, 8, torch.float32, device="cpu")
    for _, t in lm.tree_leaves(cache):
        t.fill_(7.0)
    row = lm.init_cache(ARCH, 1, 8, torch.float32, device="cpu")
    for i, (_, t) in enumerate(lm.tree_leaves(row)):
        t.fill_(float(i + 1))
    engine_mod.write_slot(cache, row, 1)
    rows = dict(lm.tree_leaves(row))
    assert {p[1:] for p in rows} == LEAVES
    for p, t in lm.tree_leaves(cache):
        assert torch.equal(t[:, 1], rows[p][:, 0]), p
        assert bool((t[:, 0] == 7).all() and (t[:, 2] == 7).all()), p
    engine_mod.reset_slot_state(cache, 2)
    for p, t in lm.tree_leaves(cache):
        assert not t[:, 2].any() and torch.equal(t[:, 1], rows[p][:, 0]), p


MODES = {"chunked": dict(kv_block_size=0, prefill_chunk_tokens=5),
         "stall-the-world": dict(kv_block_size=0, prefill_chunk_tokens=0),
         "paged-int8": dict(kv_block_size=4, prefill_chunk_tokens=5,
                            kv_quant="int8")}


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_reference_token_for_token(mode):
    """The paged + int8 request is inert, as in the reference: a stack
    without attention serves from the dense slot layout."""
    eng, _ = engines_agree(NAME, mode, MODES)
    assert not eng.paged and eng.kv_quant is None and eng.prefix is None
    assert eng.kv_bytes_reserved == 0 and eng.peak_blocks_in_use == 0
    assert eng.chunked == (mode != "stall-the-world")
    assert {p[1:] for p, _ in lm.tree_leaves(eng.cache)} == LEAVES


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [tuple(int(t) for t in rng.integers(1, ARCH.vocab, n))
            for n in lens]


@pytest.mark.parametrize("chunk", [0, 3], ids=["stall-the-world", "chunked"])
def test_slot_reuse_cannot_leak_state(rwkv, chunk):
    """The port's counterpart of the reference's slot-reuse test: two
    requests through one slot back to back; the second generates exactly
    what it generates on a fresh engine, and what the reference's engine
    generates for the same two requests."""
    jp, tp = rwkv
    pa, pb = _prompts([8, 8], seed=3)
    cfg = dict(max_batch=1, max_len=20, prefill_chunk_tokens=chunk)

    def run(params, eng_cls, cfg_cls, req_cls, reqs):
        engine = eng_cls(params, ARCH, cfg_cls(**cfg))
        engine.warmup([8])
        got = engine.run([req_cls(uid=u, prompt=p, max_new_tokens=n)
                          for u, p, n in reqs])
        assert engine.stats["retired"] == len(reqs)
        return {c.uid: list(c.tokens) for c in got}

    fresh = run(tp, ServeEngine, ServeConfig, Request, [(1, pb, 5)])
    both = run(tp, ServeEngine, ServeConfig, Request,
               [(0, pa, 7), (1, pb, 5)])
    assert both[1] == fresh[1]
    assert both == run(jp, JServeEngine, JServeConfig, JRequest,
                       [(0, pa, 7), (1, pb, 5)])


def _serve(params, specs, lens, chunk):
    """One engine pass with staggered admits and a mid-decode submit;
    returns {uid: (tokens, reason)}."""
    engine = ServeEngine(params, ARCH, ServeConfig(
        max_batch=2, max_len=24, prefill_chunk_tokens=chunk))
    engine.warmup(lens)
    reqs = [Request(uid=i, **sp) for i, sp in enumerate(specs)]
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
    if chunk:
        assert engine.stats["prefill_s"] == 0.0
    return {c.uid: (list(c.tokens), c.finish_reason) for c in got}


def test_chunked_matches_stall_the_world_oracle(rwkv):
    """The reference's ``test_mixed_step`` oracle on rwkv6, in the port:
    chunk 4 splits every prompt into several mixed steps, and the
    completions (an EOS mid-stream among them) equal the chunk-0
    engine's exactly."""
    _, tp = rwkv
    lens, news = [5, 9, 3, 9, 5], [4, 2, 6, 3, 5]
    prompts = _prompts(lens, seed=0)
    free = _serve(tp, [dict(prompt=prompts[2], max_new_tokens=news[2])],
                  [3], chunk=0)[0][0]
    eos2 = next((t for i, t in enumerate(free[1:], 1) if t not in free[:i]),
                None)
    specs = [dict(prompt=prompts[i], max_new_tokens=news[i],
                  eos_id=eos2 if i == 2 else None) for i in range(5)]
    want = _serve(tp, specs, lens, chunk=0)
    assert _serve(tp, specs, lens, chunk=4) == want
    if eos2 is not None:
        assert want[2][1] == "eos"


def test_serve_command_takes_rwkv6_on_cpu(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--device", "cpu", "--arch", "rwkv6-1.6b", "--batch",
                      "2", "--requests", "3", "--prompt-len", "6", "--gen",
                      "3", "--width", "64", "--depth", "2", "--vocab", "64",
                      "--kv-quant", "int8"])
    assert len(out["completions"]) == 3
    assert all(len(c.tokens) == 3 for c in out["completions"])
    text = capsys.readouterr().out
    assert "kv=dense" in text and "kv reserved: 0.00 MiB" in text
