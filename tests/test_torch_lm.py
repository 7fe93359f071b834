"""The port's LM against ``repro.models.lm`` on the four reduced dense
configs and reduced jamba (Mamba + attention + MoE), with the reference's
weights moved across by the bridge: ``prefill`` logits and every cache
leaf over a dense row, and ``step`` logits over dense, paged and int8
paged caches (a ragged mixed step, then a single-token decode), with the
KV and Mamba state leaves after it.  Float32, tolerance 1e-5 on logits
and states (1e-4 with the int8 pool); int8 payloads compare within one
quantization step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import configs as C
from repro.models import lm as jlm
from repro_torch import configs as TC
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.models import lm

ARCHS = ["llama3_2_1b", "qwen2_5_3b", "olmo_1b", "granite_3_2b",
         "jamba_1_5_large"]
TOL = 1e-5


def _setup(name):
    arch = C.reduced(name)
    jp = jlm.init_lm(jax.random.PRNGKey(0), arch, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return arch, jp, tp


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("name", ARCHS + ["internvl2_76b", "seamless_m4t_v2",
                                  "phi3_5_moe_42b"])
def test_configs_are_copies_of_the_reference(name):
    assert dataclasses.asdict(TC.get(name)) == dataclasses.asdict(C.get(name))
    assert (dataclasses.asdict(TC.reduced(name))
            == dataclasses.asdict(C.reduced(name)))


def test_other_archs_name_their_slice():
    TC.get("olmoe-1b-7b")                    # ported: MoE serving
    phi = TC.get("phi3.5-moe-42b-a6.6b")     # ported: every config loads
    assert sorted(TC.ALL_ARCHS) == sorted(C.ALL_ARCHS)
    assert (phi.n_experts, phi.top_k, phi.hd) == (16, 2, 128)
    rwkv = TC.reduced("rwkv6_1b6")           # served: slot-dense state
    got = params_to_numpy(lm.init_paged_cache(rwkv, 3, 4, 2, torch.float32,
                                              device="cpu"))
    want = jax.tree.map(np.asarray, jlm.init_paged_cache(
        C.reduced("rwkv6_1b6"), 3, 4, 2, jnp.float32))
    assert ({p: (a.shape, a.dtype) for p, a in lm.tree_leaves(got)}
            == {p: (a.shape, a.dtype) for p, a in lm.tree_leaves(want)})
    assert "kv" not in got["l0"] and "tmix_state" in got["l0"]
    with pytest.raises(ValueError, match="unknown arch"):
        TC.get("gpt-17")
    jamba = TC.get("jamba-1.5-large-398b")   # ported: Mamba hybrid serving
    p = lm.init_lm(TC.reduced("jamba_1_5_large"),
                   generator=torch.Generator().manual_seed(0), device="cpu")
    assert "ssm" in p["stack"]["l0"] and "moe" in p["stack"]["l1"]
    assert jamba.pattern[4].mixer == "attn"


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_logits_and_cache(name):
    arch, jp, tp = _setup(name)
    tokens = np.random.default_rng(1).integers(0, arch.vocab, (2, 7))
    jc = jlm.init_cache(arch, 2, 9, jnp.float32)
    tc = lm.init_cache(arch, 2, 9, torch.float32, device="cpu")
    want, jc = jlm.prefill(jp, {"tokens": jnp.asarray(tokens, jnp.int32)},
                           jc, arch)
    got, tc = lm.prefill(tp, {"tokens": torch.from_numpy(tokens)}, tc, arch)
    _close(got, want)
    jnc = dict(lm.tree_leaves(jax.tree.map(np.asarray, jc)))
    tnc = dict(lm.tree_leaves(params_to_numpy(tc)))
    assert tnc.keys() == jnc.keys()
    for path, leaf in tnc.items():
        _close(leaf, jnc[path])


def _caches(arch, kind):
    if kind == "dense":
        return (jlm.init_cache(arch, 3, 16, jnp.float32),
                lm.init_cache(arch, 3, 16, torch.float32, device="cpu"), None)
    quant = "int8" if kind == "int8" else None
    tables = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    return (jlm.init_paged_cache(arch, 6, 4, 3, jnp.float32, kv_quant=quant),
            lm.init_paged_cache(arch, 6, 4, 3, torch.float32, kv_quant=quant,
                                device="cpu"), tables)


@pytest.mark.parametrize("kind", ["dense", "paged", "int8"])
@pytest.mark.parametrize("name", ARCHS)
def test_step_logits_over_caches(name, kind):
    arch, jp, tp = _setup(name)
    jc, tc, tables = _caches(arch, kind)
    rng = np.random.default_rng(2)
    jbt = None if tables is None else jnp.asarray(tables)
    tbt = None if tables is None else torch.from_numpy(tables)
    # a ragged mixed step from depth 0: row 0 prefills 6, row 1 3, row 2 idle
    toks = rng.integers(0, arch.vocab, (3, 6))
    q_lens = np.array([6, 3, 0], np.int32)
    pos = np.zeros(3, np.int32)
    want, jc = jlm.step(jp, jnp.asarray(toks, jnp.int32), jc, jnp.asarray(pos),
                        arch, q_lens=jnp.asarray(q_lens), block_tables=jbt)
    got, tc = lm.step(tp, torch.from_numpy(toks), tc, torch.from_numpy(pos),
                      arch, q_lens=torch.from_numpy(q_lens), block_tables=tbt)
    tol = 1e-4 if kind == "int8" else TOL
    _close(got[0], want[0], tol)
    _close(got[1, :3], want[1, :3], tol)
    # then one single-token decode through the paged or the dense kernel
    tok = rng.integers(0, arch.vocab, (3, 1))
    pos = q_lens.copy()
    want, jc = jlm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc,
                               jnp.asarray(pos), arch, block_tables=jbt)
    got, tc = lm.decode_step(tp, torch.from_numpy(tok), tc,
                             torch.from_numpy(pos), arch, block_tables=tbt)
    _close(got[:2], want[:2], tol)
    jnc = jax.tree.map(np.asarray, jc)
    tnc = params_to_numpy(tc)
    for j, layer in jnc.items():
        if "ssm_state" in layer:            # Mamba state, every row
            for key, b in layer["ssm_state"].items():
                _close(tnc[j]["ssm_state"][key], b, tol)
            continue
        jkv, tkv = layer["kv"], tnc[j]["kv"]
        for key in jkv:
            if tables is None:              # rows 0, 1 up to their depth
                _close(tkv[key][:, 0, :7], jkv[key][:, 0, :7])
                _close(tkv[key][:, 1, :4], jkv[key][:, 1, :4])
                continue
            a, b = tkv[key][:, 1:], jkv[key][:, 1:]   # blocks 1..5: live
            if a.dtype == np.int8:
                assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
            else:
                _close(a, b)


def test_decode_positions_validates():
    pos, cache_pos = lm.decode_positions(5, 3)
    assert tuple(pos.shape) == (1,) and cache_pos.ndim == 0
    pos, cache_pos = lm.decode_positions([1, 2, 3], 3)
    assert tuple(pos.shape) == (3, 1) and tuple(cache_pos.shape) == (3,)
    with pytest.raises(ValueError, match="decode pos"):
        lm.decode_positions([1, 2], 3)
