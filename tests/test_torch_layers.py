"""The port's model primitives against ``repro.models.layers`` on the
same numpy inputs and weights: ``rms_norm``, ``rope`` and each branch of
``attention`` the port takes (no cache, prefill into a dense row, paged
single-token decode in fp and int8, the mixed step over paged and dense
caches, a dense cache continued mid-sequence, and cross-attention over
given K/V), plus ``attention_out`` and ``mlp``.  Float32, tolerance
1e-5 (same math, other summation order).  The cache writes are compared
too: the port updates the cache in place where the reference returns a
new one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import configs as C
from repro.models import layers as JL
from repro.models import lm as jlm
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.models import layers as L

TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _attn_params(arch):
    p = JL.init_attention(jax.random.PRNGKey(1), arch, jnp.float32)
    if arch.qkv_bias:                      # non-zero biases exercise them
        rng = np.random.default_rng(2)
        p = {k: (jnp.asarray(rng.standard_normal(v.shape), jnp.float32)
                 if k.startswith("b") else v) for k, v in p.items()}
    return p, params_from_jax(jax.tree.map(np.asarray, p), "cpu")


def _x(arch, B, S, seed=0):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, arch.d_model)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("with_scale", [True, False])
def test_rms_norm(with_scale):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32) * 4
    s = rng.standard_normal(32).astype(np.float32) if with_scale else None
    want = JL.rms_norm(jnp.asarray(x), None if s is None else jnp.asarray(s))
    got = L.rms_norm(torch.from_numpy(x),
                     None if s is None else torch.from_numpy(s))
    _close(got, want)


@pytest.mark.parametrize("pos_shape", [(7,), (2, 7)], ids=["shared", "per-row"])
def test_rope(pos_shape):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, pos_shape).astype(np.int32)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 5e5)
    got = L.rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5)
    _close(got, want, tol=2e-5)     # angles up to 5000 rad: sin/cos ulps


@pytest.mark.parametrize("name", ["llama3_2_1b", "qwen2_5_3b"])
def test_attention_no_cache_and_out_proj(name):
    arch = C.reduced(name)
    jp, tp = _attn_params(arch)
    jx, tx = _x(arch, 2, 9)
    want, _ = JL.attention(jp, jx, arch, None, positions=jnp.arange(9))
    got, _ = L.attention(tp, tx, arch, positions=torch.arange(9))
    _close(got, want)
    _close(L.attention_out(tp, got), JL.attention_out(jp, want, None))


@pytest.mark.parametrize("S", [11, 1])
def test_attention_prefill_writes_dense_row(S):
    arch = C.reduced("llama3_2_1b")
    jp, tp = _attn_params(arch)
    jx, tx = _x(arch, 1, S)
    jc = {"k": jnp.zeros((1, 16, arch.n_kv_heads, arch.hd)),
          "v": jnp.zeros((1, 16, arch.n_kv_heads, arch.hd))}
    tc = params_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    want, jnc = JL.attention(jp, jx, arch, None, positions=jnp.arange(S),
                             kv_cache=jc, cache_pos=0)
    got, tnc = L.attention(tp, tx, arch, positions=torch.arange(S),
                           kv_cache=tc, cache_pos=0)
    _close(got, want)
    assert tnc is tc                                     # written in place
    for key in ("k", "v"):
        _close(tc[key], jnc[key])


def _paged_setup(arch, quant, B=3, NB=9, bs=4, pages=3):
    jc = jlm.init_paged_cache(arch, NB, bs, B, jnp.float32,
                              kv_quant="int8" if quant else None)["l0"]["kv"]
    jc = jax.tree.map(lambda a: a[0], jc)                # one unit's pool
    rng = np.random.default_rng(3)
    jc = {k: (jnp.asarray(rng.integers(-127, 128, v.shape), v.dtype)
              if v.dtype == jnp.int8 else
              jnp.asarray(rng.random(v.shape) * 0.05 if k.endswith("scale")
                          else rng.standard_normal(v.shape), v.dtype))
          for k, v in jc.items()}
    tables = np.array([[1, 2, 0], [3, 4, 5], [0, 0, 0]], np.int32)
    return jc, params_from_jax(jax.tree.map(np.asarray, jc), "cpu"), tables


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_attention_paged_decode(quant):
    arch = C.reduced("llama3_2_1b")
    jp, tp = _attn_params(arch)
    jc, tc, tables = _paged_setup(arch, quant)
    jx, tx = _x(arch, 3, 1, seed=4)
    pos = np.array([6, 9, 0], np.int32)       # row 2 idle: writes to trash
    want, jnc = JL.attention(jp, jx, arch, None,
                             positions=jnp.asarray(pos)[:, None],
                             kv_cache=jc, cache_pos=jnp.asarray(pos),
                             block_tables=jnp.asarray(tables))
    got, _ = L.attention(tp, tx, arch, positions=torch.from_numpy(pos)[:, None],
                         kv_cache=tc, cache_pos=torch.from_numpy(pos),
                         block_tables=torch.from_numpy(tables))
    _close(got[:2], want[:2])
    out = params_to_numpy(tc)
    for key in jnc:                           # live blocks 1..5 match
        _close(out[key][1:6], np.asarray(jnc[key])[1:6])


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_attention_mixed_paged(quant):
    arch = C.reduced("llama3_2_1b")
    jp, tp = _attn_params(arch)
    jc, tc, tables = _paged_setup(arch, quant)
    jx, tx = _x(arch, 3, 5, seed=5)
    pos = np.array([2, 7, 0], np.int32)
    q_lens = np.array([5, 1, 0], np.int32)
    want, jnc = JL.attention(
        jp, jx, arch, None,
        positions=jnp.asarray(pos)[:, None] + jnp.arange(5)[None],
        kv_cache=jc, cache_pos=jnp.asarray(pos),
        block_tables=jnp.asarray(tables), q_lens=jnp.asarray(q_lens))
    got, _ = L.attention(
        tp, tx, arch,
        positions=torch.from_numpy(pos)[:, None] + torch.arange(5)[None],
        kv_cache=tc, cache_pos=torch.from_numpy(pos),
        block_tables=torch.from_numpy(tables),
        q_lens=torch.from_numpy(q_lens))
    _close(got[0], want[0])                   # live: row 0 all, row 1 t=0
    _close(got[1, :1], want[1, :1])
    out = params_to_numpy(tc)
    for key in jnc:
        _close(out[key][1:6], np.asarray(jnc[key])[1:6])


def test_attention_mixed_dense():
    arch = C.reduced("granite_3_2b")
    jp, tp = _attn_params(arch)
    rng = np.random.default_rng(6)
    shape = (2, 12, arch.n_kv_heads, arch.hd)
    jc = {k: jnp.asarray(rng.standard_normal(shape), jnp.float32)
          for k in ("k", "v")}
    tc = params_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    jx, tx = _x(arch, 2, 4, seed=7)
    pos = np.array([3, 8], np.int32)
    q_lens = np.array([4, 1], np.int32)
    want, jnc = JL.attention(
        jp, jx, arch, None,
        positions=jnp.asarray(pos)[:, None] + jnp.arange(4)[None],
        kv_cache=jc, cache_pos=jnp.asarray(pos), q_lens=jnp.asarray(q_lens))
    got, _ = L.attention(
        tp, tx, arch,
        positions=torch.from_numpy(pos)[:, None] + torch.arange(4)[None],
        kv_cache=tc, cache_pos=torch.from_numpy(pos),
        q_lens=torch.from_numpy(q_lens))
    _close(got[0], want[0])
    _close(got[1, :1], want[1, :1])
    for key in ("k", "v"):
        _close(tc[key], jnc[key])


def test_dense_single_token_decode_names_slice_2():
    """Dense single-token decode (per-slot positions) equals the
    reference, and so does continuing the same dense cache mid-sequence
    (a scalar ``cache_pos`` 3 given as a tensor, S 3, G 2)."""
    arch = C.reduced("llama3_2_1b")
    jp, tp = _attn_params(arch)
    jx, tx = _x(arch, 2, 1)
    shape = (2, 8, arch.n_kv_heads, arch.hd)
    jc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tc = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    want, jc = JL.attention(jp, jx, arch, None,
                            positions=jnp.asarray([[3], [4]]), kv_cache=jc,
                            cache_pos=jnp.asarray([3, 4]))
    got, tc = L.attention(tp, tx, arch, positions=torch.tensor([[3], [4]]),
                          kv_cache=tc, cache_pos=torch.tensor([3, 4]))
    _close(got, want)
    for key in ("k", "v"):
        _close(tc[key], jc[key])
    jx3, tx3 = _x(arch, 2, 3)
    want, jc = JL.attention(jp, jx3, arch, None, positions=jnp.arange(3, 6),
                            kv_cache=jc, cache_pos=jnp.int32(3))
    got, tc = L.attention(tp, tx3, arch, positions=torch.arange(3, 6),
                          kv_cache=tc, cache_pos=torch.tensor(3))
    _close(got, want)
    for key in ("k", "v"):
        _close(tc[key], jc[key])


def test_mlp_embed_and_tied_head():
    arch = C.reduced("llama3_2_1b")
    jp = JL.init_mlp(jax.random.PRNGKey(4), arch, jnp.float32)
    je = JL.init_embed(jax.random.PRNGKey(5), arch, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    te = params_from_jax(jax.tree.map(np.asarray, je), "cpu")
    jx, tx = _x(arch, 2, 3)
    _close(L.mlp(tp, tx), JL.mlp(jp, jx, None, None))
    tok = np.array([[1, 5, 7]], np.int32)
    _close(L.embed(te, torch.from_numpy(tok).long()),
           JL.embed(je, jnp.asarray(tok), None))
    _close(L.lm_head({}, tx, te, arch), JL.lm_head({}, jx, je, arch, None))


@pytest.mark.parametrize("use_rope", [False, True], ids=["no-rope", "rope"])
@pytest.mark.parametrize("name", ["llama3_2_1b", "qwen2_5_3b",
                                  "olmoe_1b_7b"])
def test_cross_attention_over_given_kv(name, use_rope):
    """``kv_override``: K/V of another length come in as they are (no
    bias, norm or rope on them), q keeps its bias and norm; the core is
    the chunked one over K/V repeated over the head groups, causal over
    free-form positions or not."""
    arch = C.reduced(name)
    jp, tp = _attn_params(arch)
    jx, tx = _x(arch, 2, 5)
    rng = np.random.default_rng(11)
    mk, mv = (rng.standard_normal((2, 7, arch.n_kv_heads, arch.hd))
              .astype(np.float32) for _ in range(2))
    mpos = np.arange(7, dtype=np.int32)
    for causal in (False, True):
        want, _ = JL.attention(
            jp, jx, arch, None, positions=jnp.arange(2, 7), causal=causal,
            kv_override=(jnp.asarray(mk), jnp.asarray(mv),
                         jnp.asarray(mpos)), use_rope=use_rope)
        got, cache = L.attention(
            tp, tx, arch, positions=torch.arange(2, 7), causal=causal,
            kv_override=(torch.from_numpy(mk), torch.from_numpy(mv),
                         torch.from_numpy(mpos)), use_rope=use_rope)
        assert cache is None
        _close(got, want)
