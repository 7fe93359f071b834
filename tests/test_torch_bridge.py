"""The bridge between the reference's trees and the port's: parameter
and cache trees round-trip losslessly (float32, bfloat16, int8 and the
int8 pool's float32 scales), keep the reference's nesting and layouts,
and never alias the source buffer (the port writes caches in place)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import configs as C
from repro.models import lm as jlm
from repro_torch.bridge import params_from_jax, params_to_numpy


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


def _assert_same(a, b):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["llama3_2_1b", "qwen2_5_3b", "olmo_1b"])
def test_params_round_trip(name, dtype):
    arch = C.reduced(name)
    src = jax.tree.map(np.asarray,
                       jlm.init_lm(jax.random.PRNGKey(0), arch, dtype))
    tp = params_from_jax(src, "cpu")
    want = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    assert tp["embed"]["table"].dtype == want
    attn = tp["stack"]["l0"]["attn"]
    n, d, H, KH, hd = (arch.n_units, arch.d_model, arch.n_heads,
                       arch.n_kv_heads, arch.hd)
    assert tuple(attn["wq"].shape) == (n, d, H, hd)
    assert tuple(attn["wk"].shape) == (n, d, KH, hd)
    assert tuple(attn["wo"].shape) == (n, H, hd, d)
    assert ("bq" in attn) == arch.qkv_bias
    assert tp["lm_head"] == {}                          # tied embeddings
    assert (tp["final_norm"] == {}) == arch.nonparam_norm
    _assert_same(params_to_numpy(tp), src)


@pytest.mark.parametrize("quant", [None, "int8"], ids=["fp", "int8"])
def test_cache_trees_round_trip(quant):
    arch = C.reduced("llama3_2_1b")
    rng = np.random.default_rng(0)
    src = jax.tree.map(np.asarray, jlm.init_paged_cache(
        arch, 5, 4, 2, jnp.float32, kv_quant=quant))
    src = jax.tree.map(lambda a: (rng.integers(-127, 128, a.shape)
                                  .astype(a.dtype)) if a.dtype == np.int8
                       else rng.standard_normal(a.shape).astype(a.dtype), src)
    tc = params_from_jax(src, "cpu")
    assert set(tc["l0"]["kv"]) == (
        {"k", "v", "k_scale", "v_scale"} if quant else {"k", "v"})
    _assert_same(params_to_numpy(tc), src)


def test_bridge_copies_rather_than_aliases():
    src = {"a": np.zeros((3,), np.float32)}
    tc = params_from_jax(src, "cpu")
    tc["a"][0] = 1.0
    assert src["a"][0] == 0.0


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_jamba_params_and_state_caches_round_trip(dtype):
    """The Mamba leaves (A_log and D float32 whatever the dtype) and the
    slot-dense ``ssm_state`` cache leaves of both layouts cross both ways
    bit for bit, and the port's own caches have the reference's tree."""
    from repro_torch.models import lm
    arch = C.reduced("jamba_1_5_large")
    src = jax.tree.map(np.asarray,
                       jlm.init_lm(jax.random.PRNGKey(0), arch, dtype))
    tp = params_from_jax(src, "cpu")
    ssm = tp["stack"]["l0"]["ssm"]
    assert set(ssm) == {"in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
                        "dt_bias", "A_log", "D", "out_proj"}
    assert ssm["A_log"].dtype == ssm["D"].dtype == torch.float32
    _assert_same(params_to_numpy(tp), src)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    rng = np.random.default_rng(1)
    for jc, tc in ((jlm.init_cache(arch, 2, 8, dtype),
                    lm.init_cache(arch, 2, 8, tdt, device="cpu")),
                   (jlm.init_paged_cache(arch, 5, 4, 2, dtype),
                    lm.init_paged_cache(arch, 5, 4, 2, tdt, device="cpu"))):
        jc = jax.tree.map(np.asarray, jc)
        _assert_same(params_to_numpy(tc), jc)       # zeros, same tree
        jc = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            a.dtype), jc)
        assert jc["l0"]["ssm_state"]["ssm"].dtype == np.float32
        _assert_same(params_to_numpy(params_from_jax(jc, "cpu")), jc)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_rwkv_state_caches_round_trip(dtype):
    """The RWKV6 cache leaves (token shifts in the cache dtype, the WKV
    state float32 whatever it) of both layouts cross both ways bit for
    bit, and the port's own caches have the reference's tree."""
    from repro_torch.models import lm
    arch = C.reduced("rwkv6_1b6")
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    rng = np.random.default_rng(2)
    for jc, tc in ((jlm.init_cache(arch, 2, 8, dtype),
                    lm.init_cache(arch, 2, 8, tdt, device="cpu")),
                   (jlm.init_paged_cache(arch, 5, 4, 2, dtype),
                    lm.init_paged_cache(arch, 5, 4, 2, tdt, device="cpu"))):
        jc = jax.tree.map(np.asarray, jc)
        _assert_same(params_to_numpy(tc), jc)       # zeros, same tree
        jc = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            a.dtype), jc)
        assert jc["l0"]["tmix_state"]["wkv"].dtype == np.float32
        assert jc["l0"]["cmix_state"]["shift"].dtype == np.dtype(dtype)
        _assert_same(params_to_numpy(params_from_jax(jc, "cpu")), jc)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_encdec_params_and_cache_round_trip(dtype):
    """An ``init_encdec`` tree (encoder stack, cross-attention in the
    decoder) and a filled ``{"dec", "memory"}`` cache move across whole,
    leaf by leaf, with the port's own trees' paths and shapes."""
    from repro.models import encdec as jencdec
    from repro_torch.models import encdec
    arch = C.reduced("seamless_m4t_v2")
    src = jax.tree.map(np.asarray,
                       jencdec.init_encdec(jax.random.PRNGKey(0), arch, dtype))
    tp = params_from_jax(src, "cpu")
    _assert_same(params_to_numpy(tp), src)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    own = params_to_numpy(encdec.init_encdec(
        arch, tdt, generator=torch.Generator().manual_seed(0), device="cpu"))
    assert ({k: (v.shape, v.dtype) for k, v in _flat(own)}
            == {k: (v.shape, v.dtype) for k, v in _flat(src)})
    rng = np.random.default_rng(1)
    cache = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 3).astype(a.dtype),
        jax.tree.map(np.asarray, jencdec.init_cache(arch, 2, 8, dtype,
                                                    enc_len=5)))
    tc = params_from_jax(cache, "cpu")
    assert tuple(tc["memory"].shape) == (2, 5, arch.d_model)
    _assert_same(params_to_numpy(tc), cache)
