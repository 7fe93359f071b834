"""Dense-cache decode in the port against the reference on the CPU, with
the same numpy inputs and the reference's weights (moved across by the
bridge):

* ``ops.decode_attention``'s single-token form (the plain version of the
  CUDA split-KV kernel) against the JAX Pallas kernel in interpret mode:
  scalar and per-slot kv_len, G in {1, 4}, D in {64, 128}, and a cache
  passed as a transposed (B, T, KH, D) view, as the engine passes it;
* the dense decode branch of ``layers.attention`` and ``lm.decode_step``
  over a dense cache, per-slot and scalar positions, on the four dense
  reduced configs and reduced olmoe, and a dense cache continued
  mid-sequence (scalar ``cache_pos`` > 0 with S > 1);
* ``ServeEngine`` with the dense per-slot layout (``kv_block_size=0``),
  chunked and stall-the-world, token for token against the reference
  engine on reduced llama3.2.

Float32, tolerance 1e-5 (the same math, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import configs as C
from repro.kernels import ops as jops
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.serve import Request, ServeConfig, ServeEngine

TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "per-slot"])
@pytest.mark.parametrize("G,D", [(1, 64), (1, 128), (4, 64), (4, 128)])
def test_decode_matches_pallas_interpret(G, D, per_slot):
    rng = np.random.default_rng(G * D + per_slot)
    B, KH, T = 3, 2, 48
    q = rng.standard_normal((B, KH, G, D)).astype(np.float32)
    k = rng.standard_normal((B, T, KH, D)).astype(np.float32)  # cache layout
    v = rng.standard_normal((B, T, KH, D)).astype(np.float32)
    kv_len = (np.array([1, 17, 48], np.int32) if per_slot
              else np.int32(29))
    want = jops.decode_attention(
        jnp.asarray(q), jnp.asarray(k).transpose(0, 2, 1, 3),
        jnp.asarray(v).transpose(0, 2, 1, 3), jnp.asarray(kv_len),
        block_k=16, backend="interpret")
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    got = ops.decode_attention(torch.from_numpy(q), tk.transpose(1, 2),
                               tv.transpose(1, 2), torch.as_tensor(kv_len))
    _close(got, want)
    plain = ref.decode_attention_ref(
        torch.from_numpy(q).reshape(B, KH * G, D), tk.transpose(1, 2),
        tv.transpose(1, 2), torch.as_tensor(kv_len))
    assert torch.equal(got.reshape(B, KH * G, D), plain)


def test_decode_kv_len_shape_is_checked():
    q = torch.zeros(2, 2, 1, 64)
    kv = torch.zeros(2, 2, 8, 64)
    with pytest.raises(ValueError, match="kv_len"):
        ops.decode_attention(q, kv, kv, torch.tensor([1, 2, 3]))


def _attn_params(arch):
    p = JL.init_attention(jax.random.PRNGKey(1), arch, jnp.float32)
    return p, params_from_jax(jax.tree.map(np.asarray, p), "cpu")


@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "per-slot"])
@pytest.mark.parametrize("name", ["llama3_2_1b", "olmoe_1b_7b"])
def test_dense_decode_branch_matches_reference(name, per_slot):
    arch = C.reduced(name)
    jp, tp = _attn_params(arch)
    rng = np.random.default_rng(3)
    B, L_, KH, hd = 3, 12, arch.n_kv_heads, arch.hd
    cache = {k: rng.standard_normal((B, L_, KH, hd)).astype(np.float32)
             for k in ("k", "v")}
    x = rng.standard_normal((B, 1, arch.d_model)).astype(np.float32)
    pos = np.array([2, 7, 11], np.int32) if per_slot else np.int32(5)
    jpos = jnp.asarray(pos)
    positions = jpos[:, None] if per_slot else jpos[None]
    want, jc = JL.attention(jp, jnp.asarray(x), arch, None,
                            positions=positions,
                            kv_cache=jax.tree.map(jnp.asarray, cache),
                            cache_pos=jpos)
    tc = {k: torch.from_numpy(a.copy()) for k, a in cache.items()}
    tpos = torch.as_tensor(pos)
    got, tc = L.attention(tp, torch.from_numpy(x), arch,
                          positions=tpos[:, None] if per_slot else tpos[None],
                          kv_cache=tc, cache_pos=tpos)
    _close(got, want)
    for k in ("k", "v"):
        _close(tc[k], jc[k])


def test_dense_mid_sequence_continuation_names_its_item():
    """A dense cache continued mid-sequence (scalar ``cache_pos`` 2, S 3,
    over rows already holding two tokens): the new rows land at 2-4 and
    attend causally over the whole row through the chunked core, as in
    the reference; output and cache equal its."""
    arch = C.reduced("llama3_2_1b")
    jp, tp = _attn_params(arch)
    rng = np.random.default_rng(9)
    cache = {k: rng.standard_normal((2, 8, arch.n_kv_heads, arch.hd))
             .astype(np.float32) for k in ("k", "v")}
    x = rng.standard_normal((2, 3, arch.d_model)).astype(np.float32)
    want, jc = JL.attention(jp, jnp.asarray(x), arch, None,
                            positions=jnp.arange(2, 5),
                            kv_cache=jax.tree.map(jnp.asarray, cache),
                            cache_pos=2)
    tc = {k: torch.from_numpy(a.copy()) for k, a in cache.items()}
    got, tc = L.attention(tp, torch.from_numpy(x), arch,
                          positions=torch.arange(2, 5), kv_cache=tc,
                          cache_pos=2)
    _close(got, want)
    for k in ("k", "v"):
        _close(tc[k], jc[k])


@pytest.mark.parametrize("name", ["llama3_2_1b", "qwen2_5_3b", "olmo_1b",
                                  "granite_3_2b", "olmoe_1b_7b"])
def test_decode_step_over_a_dense_cache(name):
    arch = C.reduced(name)
    jp = jlm.init_lm(jax.random.PRNGKey(0), arch, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, arch.vocab, (2, 6))
    jc = jlm.init_cache(arch, 2, 12, jnp.float32)
    tc = lm.init_cache(arch, 2, 12, torch.float32, device="cpu")
    _, jc = jlm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jc,
                        arch)
    _, tc = lm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc, arch)
    for pos in (np.int32(6), np.array([7, 7], np.int32)):   # scalar, per-slot
        tok = rng.integers(0, arch.vocab, (2, 1))
        want, jc = jlm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc,
                                   jnp.asarray(pos), arch)
        got, tc = lm.decode_step(tp, torch.from_numpy(tok), tc,
                                 torch.as_tensor(pos), arch)
        _close(got, want)
    jnc = jax.tree.map(np.asarray, jc)["l0"]["kv"]
    tnc = params_to_numpy(tc)["l0"]["kv"]
    for key in ("k", "v"):
        _close(tnc[key][:, :, :8], jnc[key][:, :, :8])


BS = 4
MODES = {"dense-chunked": dict(kv_block_size=0, prefill_chunk_tokens=5),
         "dense-stall-the-world": dict(kv_block_size=0,
                                       prefill_chunk_tokens=0)}


def drive(engine, reqs, waves=(2, 3)):
    """Submit ``reqs`` in waves; each wave's prompts are all prefilled
    before the next arrives.  Returns uid -> (tokens, finish reason)."""
    engine.warmup(sorted({len(r.prompt) for r in reqs}))
    cuts = [0, *waves, len(reqs)]
    got = []
    for a, b in zip(cuts, cuts[1:]):
        for r in reqs[a:b]:
            engine.submit(r)
        while engine.busy and (engine.queue or any(
                st.prefill_remaining
                for st in engine.scheduler.active.values())):
            got.extend(engine.step())
    while engine.busy:
        got.extend(engine.step())
    return {c.uid: (list(c.tokens), c.finish_reason) for c in got}


def trace(vocab):
    rng = np.random.default_rng(0)
    tok = lambda n: tuple(int(t) for t in rng.integers(1, vocab, n))
    shared = tok(2 * BS)
    spec = [(shared + tok(3), 5), (shared + tok(6), 4), (shared, 6),
            (tok(7), 3), (shared + tok(1), 4), (tok(13), 5)]
    return [(i, p, n) for i, (p, n) in enumerate(spec)]


def engines_agree(name, mode, modes):
    """The reference and the port engine on one seeded trace of reduced
    ``name``, with ``modes[mode]`` on both; returns (port engine, tokens)."""
    arch = C.reduced(name)
    jp = jlm.init_lm(jax.random.PRNGKey(0), arch, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tr = trace(arch.vocab)
    cfg = lambda cls: cls(max_batch=3, max_len=32, **modes[mode])
    jeng = JServeEngine(jp, arch, cfg(JServeConfig))
    want = drive(jeng, [JRequest(uid=i, prompt=p, max_new_tokens=n)
                        for i, p, n in tr])
    teng = ServeEngine(tp, arch, cfg(ServeConfig))
    got = drive(teng, [Request(uid=i, prompt=p, max_new_tokens=n)
                       for i, p, n in tr])
    assert got == want
    assert len(got) == len(tr)
    assert teng.stats["prefill_tokens"] == jeng.stats["prefill_tokens"]
    assert teng.kv_bytes_reserved == jeng.kv_bytes_reserved
    return teng, got


@pytest.mark.parametrize("mode", list(MODES))
def test_dense_engine_matches_reference_token_for_token(mode):
    eng, _ = engines_agree("llama3_2_1b", mode, MODES)
    assert not eng.paged and eng.prefix is None
    assert eng.peak_blocks_in_use == 0
    assert tuple(eng.cache["l0"]["kv"]["k"].shape[1:3]) == (
        eng.max_batch, eng.max_len)


# --------------------------------------------------------------------------- #
# the CUDA kernel's split plan (pure Python): fixed small ranges, whole tiles
from repro_torch.kernels import decode_attention as _dk   # noqa: E402

_SIZES = [(8, 16), (8, 8), (1, 1), (2, 4), (64, 32), (256, 16)]
_LENGTHS = [1, 31, 32, 33, 63, 64, 65, 700, 1024, 4096, 32768]


@pytest.mark.parametrize("B,KH", _SIZES)
@pytest.mark.parametrize("T", _LENGTHS)
def test_split_plan_covers_every_token_with_whole_tiles(B, KH, T):
    chunk, splits = _dk.split_plan(B, KH, T)
    assert chunk > 0 and splits > 0
    assert chunk % _dk._TILE == 0 and chunk % _dk.RANGE == 0
    assert (splits - 1) * chunk < T <= splits * chunk


@pytest.mark.parametrize("B,KH", _SIZES)
@pytest.mark.parametrize("T", _LENGTHS)
def test_split_plan_fills_the_card_where_the_rows_allow(B, KH, T):
    chunk, splits = _dk.split_plan(B, KH, T)
    want = 2 * _dk._SMS
    possible = B * KH * -(-T // _dk.RANGE)
    assert B * KH * splits >= min(want, possible)
    if possible <= _dk._CAP:       # small grids keep the smallest range
        assert chunk == _dk.RANGE


def test_split_plan_sized_to_the_live_length():
    """The serving shapes over a 1024-token row at the chip run's ragged
    kv_len: the live ranges alone give at least 2 x 132 CTAs."""
    kv_len = [64, 65, 1024, 241, 267, 87, 110, 71]
    for KH in (8, 16):
        chunk, splits = _dk.split_plan(len(kv_len), KH, 1024)
        live = KH * sum(-(-n // chunk) for n in kv_len)
        assert live >= 2 * _dk._SMS, (KH, chunk, live)


def test_split_plan_never_gives_an_empty_range():
    rng = np.random.default_rng(0)
    for _ in range(500):
        B, KH = int(rng.integers(1, 65)), int(rng.integers(1, 33))
        T = int(rng.integers(1, 70000))
        chunk, splits = _dk.split_plan(B, KH, T)
        assert chunk >= _dk.RANGE and (splits - 1) * chunk < T


# the paged kernel splits each row's pages * block_size tokens the same way
@pytest.mark.parametrize("B,KH,bs,pages", [
    (8, 8, 128, 8), (8, 16, 128, 8), (4, 8, 16, 64), (8, 8, 32, 32),
    (3, 2, 1, 300), (64, 8, 128, 256), (256, 16, 16, 2048)], ids=[
        "llama", "olmoe", "bs16", "bs32", "bs1", "long", "large"])
def test_split_plan_at_paged_shapes(B, KH, bs, pages):
    """Ranges of whole tiles cover the table's pages * bs tokens, none is
    empty, and the grid stays under its cap (all but each row's last,
    partial range) wherever ranges had to grow past RANGE tokens."""
    T = pages * bs
    chunk, splits = _dk.split_plan(B, KH, T)
    assert chunk % _dk._TILE == 0 and chunk % _dk.RANGE == 0
    assert (splits - 1) * chunk < T <= splits * chunk
    if chunk > _dk.RANGE:
        assert B * KH * (splits - 1) < _dk._CAP
    else:
        assert B * KH * splits <= _dk._CAP
