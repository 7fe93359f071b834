"""The port's attention ops against the JAX reference.

On the CPU each op of ``repro_torch.kernels.ops`` runs its plain PyTorch
version; the JAX side runs the Pallas kernels in interpret mode (paged
decode, int8 paged decode, flash) or the XLA stream (the 5-d mixed
form), as the reference's own tests do; the positions-aware chunked core
(``mha_chunked``, cross-attention's) against the reference's XLA one,
output and gradient.  Tolerance 1e-5 in float32: the
same math with the sums taken in another order.

The CUDA kernels themselves are tested in ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import mha_xla
from repro.kernels import ops as jops
from repro.kernels import quant as jquant
from repro_torch.kernels import mha_stream, ops, ref
from repro_torch.kernels.quant import dequantize_kv, quantize_kv
from test_torch_cuda import paged_case as _paged_case

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_paged_decode_matches_pallas_interpret(G, quant):
    q, kp, vp, ks, vs, tables, kv_len = _paged_case(
        G, B=3, KH=2, G=G, D=16, bs=8, pages=4, quant=quant)
    kw = {} if ks is None else {"k_scale": ks, "v_scale": vs}
    want = jops.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(kv_len), backend="interpret",
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = ops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                     _t(kv_len),
                                     **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_paged_decode_scalar_kv_len_broadcasts():
    q, kp, vp, _, _, tables, _ = _paged_case(
        3, B=2, KH=2, G=2, D=16, bs=8, pages=3, quant=False)
    tables[:] = tables[0]
    got = ops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tables), 5)
    want = ops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                      torch.tensor([5, 5], dtype=torch.int32))
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_paged_mixed_stream_matches_reference(G, quant):
    q, kp, vp, ks, vs, tables, kv_len = _paged_case(
        10 + G, B=3, KH=2, G=G, D=16, bs=8, pages=4, quant=quant, T=5)
    kw = {} if ks is None else {"k_scale": ks, "v_scale": vs}
    want = mha_xla.paged_mixed_attention_xla(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(kv_len), **{k: jnp.asarray(v) for k, v in kw.items()})
    tkw = {k: _t(v) for k, v in kw.items()}
    got = mha_stream.paged_mixed_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                           _t(kv_len), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    # the stream agrees with the port's own gather version too
    plain = ref.paged_decode_attention_ref(_t(q), _t(kp), _t(vp), _t(tables),
                                           _t(kv_len), **tkw)
    torch.testing.assert_close(got, plain, atol=TOL, rtol=TOL)


def test_dense_mixed_stream_matches_reference():
    rng = np.random.default_rng(7)
    B, KH, G, T, D, L = 2, 2, 2, 3, 16, 20
    q = rng.standard_normal((B, KH, G, T, D)).astype(np.float32)
    k = rng.standard_normal((B, KH, L, D)).astype(np.float32)
    v = rng.standard_normal((B, KH, L, D)).astype(np.float32)
    kv_len = np.array([[4, 5, 6], [18, 19, 20]], np.int32)
    want = mha_xla.mixed_decode_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_len),
        block_k=8)
    got = ops.decode_attention(_t(q), _t(k), _t(v), _t(kv_len), block_k=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_single_token_dense_decode_names_its_slice():
    """The dense-cache decode slice has landed: the single-token form runs
    (its plain version on the CPU) instead of raising."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((1, 2, 2, 16)).astype(np.float32)
    kv = rng.standard_normal((1, 2, 8, 16)).astype(np.float32)
    want = jops.decode_attention(jnp.asarray(q), jnp.asarray(kv),
                                 jnp.asarray(kv), 3, block_k=8,
                                 backend="interpret")
    got = ops.decode_attention(_t(q), _t(kv), _t(kv), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("causal,S,T", [(True, 48, 64), (True, 37, 37),
                                        (False, 24, 40), (False, 37, 37)],
                         ids=["causal-T>S", "causal-unaligned",
                              "full-T>S", "full-unaligned"])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_flash_matches_pallas_interpret(G, causal, S, T):
    rng = np.random.default_rng(S + T + G)
    B, KH, D = 1, 2, 16
    q = rng.standard_normal((B, KH * G, S, D)).astype(np.float32)
    k = rng.standard_normal((B, KH, T, D)).astype(np.float32)
    v = rng.standard_normal((B, KH, T, D)).astype(np.float32)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, backend="interpret")
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_paged_scales_must_come_together():
    q, kp, vp, ks, _, tables, kv_len = _paged_case(
        1, B=2, KH=2, G=2, D=16, bs=8, pages=2, quant=True)
    with pytest.raises(ValueError, match="together"):
        ops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                   _t(kv_len), k_scale=_t(ks))
    with pytest.raises(ValueError, match="scale shapes"):
        ops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                   _t(kv_len), k_scale=_t(ks)[:, :4],
                                   v_scale=_t(ks)[:, :4])


def test_quantize_payload_identical_to_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 6, 32)).astype(np.float32) * 3
    # one row with absmax 127 (scale exactly 1) holding half-way values:
    # round half to even must give 2, -4, 0, 4 as jnp.round does
    x[0, 0, :] = 0.0
    x[0, 0, :5] = [127.0, 2.5, -3.5, 0.5, 3.5]
    x[1, 2, :] = 0.0                                     # all-zero row
    jq, js = jquant.quantize_kv(jnp.asarray(x))
    tq, ts = quantize_kv(_t(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[0, 0, :5].tolist() == [127, 2, -4, 0, 4]
    assert float(ts[1, 2]) == 0.0
    assert torch.all(dequantize_kv(tq, ts)[1, 2] == 0)
    np.testing.assert_array_equal(
        dequantize_kv(tq, ts).numpy(),
        np.asarray(jquant.dequantize_kv(jq, js)))


# --------------------------------------------------------------------------- #
# kernels/build.py: a library's name hashes its source, every shared header
# and the flags, so an edited header rebuilds every kernel (no nvcc needed)
def _csrc(tmp_path, monkeypatch):
    from repro_torch.kernels import build
    for name in ("one", "two"):
        (tmp_path / f"{name}.cu").write_text(f'#include "common.cuh"\n// {name}\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    return build


def test_build_target_changes_with_a_shared_header(tmp_path, monkeypatch):
    build = _csrc(tmp_path, monkeypatch)
    before = {n: build._target(n) for n in ("one", "two")}
    (tmp_path / "common.cuh").write_text("// v2\n")
    after = {n: build._target(n) for n in ("one", "two")}
    assert all(before[n] != after[n] for n in before)
    (tmp_path / "extra.cuh").write_text("// a new header\n")
    assert all(build._target(n) != after[n] for n in after)
    assert build.sources() == ["one", "two"]      # headers are not sources


def test_build_target_ignores_another_source(tmp_path, monkeypatch):
    build = _csrc(tmp_path, monkeypatch)
    one, two = build._target("one"), build._target("two")
    (tmp_path / "two.cu").write_text("// edited\n")
    assert build._target("one") == one
    assert build._target("two") != two
    assert one.parent == build.BUILD and one.name.startswith("one-")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("Sq,Skv,qc,kc", [
    (5, 7, 8, 8),        # both below their chunk: one chunk each
    (16, 24, 4, 8),      # both above and dividing: 4 q chunks, 3 kv chunks
    (10, 13, 4, 8),      # above but not dividing: one chunk each
    (12, 9, 4, 3),       # Sq chunked, Skv chunked, queries past the keys
], ids=["below", "chunked", "non-dividing", "mixed"])
def test_mha_chunked_matches_the_reference(causal, Sq, Skv, qc, kc):
    from repro_torch.kernels.mha_chunked import mha_chunked
    rng = np.random.default_rng(Sq * 100 + Skv)
    B, KH, G, D = 2, 2, 3, 16
    q = rng.standard_normal((B, Sq, KH * G, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KH, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KH, D)).astype(np.float32)
    # GQA-expanded heads (head h reads kv head h // G), free-form positions
    k, v = np.repeat(k, G, axis=2), np.repeat(v, G, axis=2)
    qpos = (np.arange(Sq) + 4).astype(np.int32)
    kvpos = np.arange(Skv).astype(np.int32)
    want = mha_xla.mha_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kvpos),
        q_chunk=qc, kv_chunk=kc)
    tq = _t(q).requires_grad_()
    got = mha_chunked(tq, _t(k), _t(v), causal=causal, q_positions=_t(qpos),
                      kv_positions=_t(kvpos), q_chunk=qc, kv_chunk=kc)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)
    got.sum().backward()                      # autograd runs through it
    want_g = jax.grad(lambda x: mha_xla.mha_chunked(
        x, jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kvpos),
        q_chunk=qc, kv_chunk=kc).sum())(jnp.asarray(q))
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(want_g),
                               atol=TOL, rtol=TOL)
