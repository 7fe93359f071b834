"""The port's VLM path against ``repro.models.lm`` on reduced
internvl2-76b (4 stubbed frontend embeddings before the text), with the
reference's weights moved across by the bridge: ``forward`` logits over
frontend + text, ``loss_fn`` (the text segment alone is scored) and the
gradient of every leaf, ``prefill`` with its cache, and the serve
command's lockstep loop over frontend + text.  Float32, tolerance 1e-5.  Then the engine serves the arch on text prompts, token
for token against the reference's engine, as the reference's launcher
serves it.
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
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.models import lm
from repro_torch.serve import Request, ServeConfig, ServeEngine

TOL = 1e-5
B, S = 2, 6


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.fixture(scope="module")
def model():
    arch = C.reduced("internvl2_76b")
    jp = jlm.init_lm(jax.random.PRNGKey(0), arch, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, arch.vocab, (B, S)).astype(np.int32),
             "frontend": rng.standard_normal(
                 (B, arch.frontend_tokens, arch.d_model)).astype(np.float32)}
    return (arch, jp, tp, {k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def test_forward_over_frontend_and_text(model):
    arch, jp, tp, jb, tb = model
    want, _ = jlm.forward(jp, jb, arch)
    got, _ = lm.forward(tp, tb, arch)
    assert tuple(got.shape) == (B, arch.frontend_tokens + S, arch.vocab)
    _close(got, want)
    # without the key the frontend arch runs on the text alone
    _close(lm.forward(tp, {"tokens": tb["tokens"]}, arch)[0],
           jlm.forward(jp, {"tokens": jb["tokens"]}, arch)[0])


def test_loss_scores_the_text_segment_and_every_gradient(model):
    arch, jp, tp, jb, tb = model
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jb, arch), has_aux=True)(jp)
    tree = lm.tree_map(lambda t: t.detach().requires_grad_(), tp)
    tl, tm = lm.loss_fn(tree, tb, arch)
    _close(tl.detach(), jl)
    for k in ("nll", "accuracy", "aux"):
        _close(tm[k].detach(), jm[k])
    paths = [p for p, _ in lm.tree_leaves(tree)]
    grads = torch.autograd.grad(tl, [t for _, t in lm.tree_leaves(tree)])
    want_g = dict(lm.tree_leaves(jax.tree.map(np.asarray, jg)))
    for p, g in zip(paths, grads):
        _close(g, want_g[p])
    # the frontend positions carry no label: shifting the labels of the
    # text moves the loss, and the text's logits alone set it
    logits, _ = lm.forward(tp, tb, arch)
    text = logits[:, arch.frontend_tokens:-1].float()
    lse = torch.logsumexp(text, -1)
    gold = torch.gather(text, -1, tb["tokens"][:, 1:, None].long())[..., 0]
    _close(tm["nll"].detach(), (lse - gold).mean())


def test_prefill_with_frontend_and_its_cache(model):
    arch, jp, tp, jb, tb = model
    L = arch.frontend_tokens + S + 3
    jc = jlm.init_cache(arch, B, L, jnp.float32)
    tc = lm.init_cache(arch, B, L, torch.float32, device="cpu")
    want, jc = jlm.prefill(jp, jb, jc, arch)
    got, tc = lm.prefill(tp, tb, tc, arch)
    _close(got, want)
    jnc = dict(lm.tree_leaves(jax.tree.map(np.asarray, jc)))
    for p, a in lm.tree_leaves(params_to_numpy(tc)):
        _close(a, jnc[p])
    pos = arch.frontend_tokens + S
    tok = np.array([[3], [5]], np.int32)
    want, _ = jlm.decode_step(jp, jnp.asarray(tok), jc, jnp.int32(pos), arch)
    got, _ = lm.decode_step(tp, torch.from_numpy(tok), tc, pos, arch)
    _close(got, want)


def test_lockstep_loop_over_frontend_and_text(model):
    """``launch.serve.lockstep`` on the VLM (the frontend before the text,
    then scalar-position decode steps) against the reference's prefill and
    ``decode_step``, greedy: tokens equal, logits within TOL."""
    from repro_torch.launch import serve as serve_cmd
    arch, jp, tp, jb, tb = model
    got = serve_cmd.lockstep(tp, arch, tb, 4)
    pos = arch.frontend_tokens + S
    jc = jlm.init_cache(arch, B, pos + 4, jnp.float32)
    lg, jc = jlm.prefill(jp, jb, jc, arch)
    want, toks = [lg[:, -1]], [jnp.argmax(lg[:, -1], -1)[:, None]]
    for i in range(3):
        lg, jc = jlm.decode_step(jp, toks[-1].astype(jnp.int32), jc,
                                 jnp.int32(pos + i), arch)
        want.append(lg[:, -1])
        toks.append(jnp.argmax(lg[:, -1], -1)[:, None])
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.concatenate(toks, axis=1))
    for a, b in zip(got["logits"], want):
        _close(a, b)


@pytest.mark.parametrize("kw", [dict(prefill_chunk_tokens=5),
                                dict(prefill_chunk_tokens=0,
                                     kv_block_size=0)],
                         ids=["paged-chunked", "dense-stall"])
def test_engine_serves_text_prompts_as_the_reference(model, kw):
    arch, jp, tp, _, _ = model
    rng = np.random.default_rng(7)
    trace = [(i, tuple(int(t) for t in rng.integers(1, arch.vocab, n)), g)
             for i, (n, g) in enumerate([(9, 4), (5, 3), (12, 5), (7, 2)])]

    def run(engine, cls):
        done = engine.run([cls(uid=i, prompt=p, max_new_tokens=g)
                           for i, p, g in trace])
        return {c.uid: (list(c.tokens), c.finish_reason) for c in done}

    cfg = dict(max_batch=2, max_len=24, kv_block_size=4)
    cfg.update(kw)
    want = run(JServeEngine(jp, arch, JServeConfig(**cfg)), JRequest)
    got = run(ServeEngine(tp, arch, ServeConfig(**cfg)), Request)
    assert got == want and len(got) == len(trace)
