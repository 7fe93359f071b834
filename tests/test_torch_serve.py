"""The port's ``ServeEngine`` against the JAX ``ServeEngine`` on the CPU,
token for token, on one seeded trace with the same weights (moved across
by the bridge), in reduced llama3.2.

The trace has a shared two-block prefix, so the chunked modes see prefix
hits and a copy-on-write copy (the request whose prompt is exactly the
block-aligned prefix recomputes its last token into a shared block).
Modes: chunked prefill with the prefix cache, stall-the-world prefill
(through the flash path), the int8 pool, and the static policy.  Greedy
decoding in float32; the tokens must be equal, as must the finish
reasons and the prefix-cache counters.

The port departs from the reference in one place, a fault of the
reference (ROADMAP.md, section C): a slot that waits to prefill while
its position lies inside a shared prefix block must not write there.
The parity trace admits the exact-prefix request when it can prefill at
once; a second trace makes it wait, and there the port must equal the
sharing-off oracle.
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
from repro_torch.bridge import params_from_jax
from repro_torch.serve import (BlockAllocator, Request, ServeConfig,
                               ServeEngine, SlotScheduler)
from repro_torch.serve import engine as engine_mod

BS = 4
MODES = {
    "chunked-prefix": dict(prefill_chunk_tokens=5),
    "stall-the-world": dict(prefill_chunk_tokens=0),
    "int8": dict(prefill_chunk_tokens=5, kv_quant="int8"),
    "static": dict(prefill_chunk_tokens=5, policy="static"),
}


def _trace(vocab):
    rng = np.random.default_rng(0)
    tok = lambda n: tuple(int(t) for t in rng.integers(1, vocab, n))
    shared = tok(2 * BS)
    spec = [(shared + tok(3), 5), (shared + tok(6), 4), (shared, 6),
            (tok(7), 3), (shared + tok(1), 4), (tok(13), 5)]
    return [(i, p, n) for i, (p, n) in enumerate(spec)]


def _config(cls, mode):
    return cls(max_batch=3, max_len=32, kv_block_size=BS, **MODES[mode])


def _drive(engine, reqs, waves=(2, 3)):
    """Submit ``reqs`` in waves (cut at the indices in ``waves``); each
    wave's prompts are all prefilled before the next wave arrives."""
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


@pytest.fixture(scope="module")
def model():
    arch = C.reduced("llama3_2_1b")
    jp = jlm.init_lm(jax.random.PRNGKey(0), arch, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return arch, jp, tp


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_reference_token_for_token(model, mode, monkeypatch):
    arch, jp, tp = model
    trace = _trace(arch.vocab)
    jeng = JServeEngine(jp, arch, _config(JServeConfig, mode))
    want = _drive(jeng, [JRequest(uid=i, prompt=p, max_new_tokens=n)
                         for i, p, n in trace])
    copies = []
    real_copy = engine_mod.copy_block
    monkeypatch.setattr(engine_mod, "copy_block",
                        lambda pool, s, d: copies.append((s, d))
                        or real_copy(pool, s, d))
    teng = ServeEngine(tp, arch, _config(ServeConfig, mode))
    got = _drive(teng, [Request(uid=i, prompt=p, max_new_tokens=n)
                        for i, p, n in trace])
    assert got == want
    assert len(got) == len(trace)
    assert teng.stats["prefill_tokens"] == jeng.stats["prefill_tokens"]
    assert teng.prefill_tokens_saved == jeng.prefill_tokens_saved
    if mode != "stall-the-world":
        assert teng.prefill_tokens_saved > 0             # prefix hits
        assert any(s != d for s, d in copies)            # a COW copy
    else:
        assert teng.prefix is None and teng.stats["prefill_s"] > 0


def test_waiting_slot_in_a_shared_block_writes_nothing(model):
    """The exact-prefix request is admitted with two others and waits
    while they prefill.  The port's tokens must equal the sharing-off
    oracle's, the reference's included."""
    arch, jp, tp = model
    trace = _trace(arch.vocab)
    off = dict(MODES["chunked-prefix"], prefix_cache=False)
    cfg = lambda cls, **kw: cls(max_batch=3, max_len=32, kv_block_size=BS,
                                **kw)
    want = _drive(JServeEngine(jp, arch, cfg(JServeConfig, **off)),
                  [JRequest(uid=i, prompt=p, max_new_tokens=n)
                   for i, p, n in trace], waves=(3,))
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n) for i, p, n in trace]
    on = ServeEngine(tp, arch, cfg(ServeConfig, **MODES["chunked-prefix"]))
    assert _drive(on, reqs, waves=(3,)) == want
    assert on.prefill_tokens_saved > 0
    assert _drive(ServeEngine(tp, arch, cfg(ServeConfig, **off)), reqs,
                  waves=(3,)) == want


def test_engine_pool_layout_and_bytes(model):
    arch, _, tp = model
    fp = ServeEngine(tp, arch, _config(ServeConfig, "chunked-prefix"))
    q8 = ServeEngine(tp, arch, _config(ServeConfig, "int8"))
    kv = q8.cache["l0"]["kv"]
    assert kv["k"].dtype == torch.int8 and kv["k_scale"].dtype == torch.float32
    assert tuple(kv["k_scale"].shape) == tuple(kv["k"].shape[:-1])
    # int8 payload plus one f32 scale per head_dim=16 row: (16 + 4) / 64
    assert q8.kv_bytes_reserved / fp.kv_bytes_reserved == pytest.approx(
        (arch.hd + 4) / (4 * arch.hd))


def test_engine_refuses_what_it_cannot_serve(model):
    arch, _, tp = model
    dense = ServeEngine(tp, arch, ServeConfig(max_batch=2, max_len=16,
                                              kv_block_size=0))
    assert not dense.paged and dense.chunk == 16   # 256 capped at max_len
    with pytest.raises(ValueError, match="exceeds"):
        dense.submit(Request(uid=0, prompt=tuple(range(1, 20)),
                             max_new_tokens=2))
    eng = ServeEngine(tp, arch, ServeConfig(max_batch=2, max_len=16,
                                            kv_block_size=BS))
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit(Request(uid=0, prompt=tuple(range(1, 20)),
                           max_new_tokens=2))
    with pytest.raises(ValueError, match="kv_quant"):
        ServeConfig(max_batch=1, max_len=8, kv_block_size=0,
                    kv_quant="int8")


def test_write_slot_quantizes_on_write_and_copy_block_copies_scales(model):
    arch, jp, tp = model
    eng = ServeEngine(tp, arch, _config(ServeConfig, "int8"))
    row = {"l0": {"kv": {
        k: torch.randn(arch.n_units, 1, 2 * BS, arch.n_kv_heads, arch.hd,
                       generator=torch.Generator().manual_seed(i))
        for i, k in enumerate(("k", "v"))}}}
    pool = engine_mod.write_slot(eng.cache, row, 0, torch.tensor([3, 5]))
    kv = pool["l0"]["kv"]
    deq = kv["k"][:, [3, 5]].float() * kv["k_scale"][:, [3, 5]][..., None]
    want = row["l0"]["kv"]["k"][:, 0].reshape(deq.shape)
    assert torch.allclose(deq, want, atol=float(kv["k_scale"].max()) / 2 + 1e-6)
    engine_mod.copy_block(pool, 5, 7)
    for key in kv:
        assert torch.equal(kv[key][:, 7], kv[key][:, 5])


def test_copied_pure_python_modules_behave_like_the_reference():
    from repro.serve import BlockAllocator as JBlockAllocator
    from repro.serve import SlotScheduler as JSlotScheduler
    ja, ta = JBlockAllocator(6, 4, 2, 3), BlockAllocator(6, 4, 2, 3)
    for a in (ja, ta):
        a.alloc(0, 0)
        a.ensure(1, 5)
        a.free_slot(0)
        a.alloc(1, 0)
    assert ja.tables.tolist() == ta.tables.tolist()
    assert ja.free_blocks == ta.free_blocks
    js, ts = JSlotScheduler(2, "static"), SlotScheduler(2, "static")
    assert js.admissible(3) == ts.admissible(3) == 2
