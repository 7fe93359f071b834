"""The port's encoder-decoder against ``repro.models.encdec`` on reduced
seamless-m4t-v2, with the reference's weights moved across by the
bridge: the parameter tree, ``forward`` logits, ``loss_fn`` metrics and
the gradient of every leaf (the encoder's ``enc_in`` and ``enc_stack``
among them, so the memory's gradient reaches the encoder through every
cross-attention), then ``prefill`` and four ``decode_step``s with the
whole ``{"dec", "memory"}`` cache.  Float32, tolerance 1e-5.

Also: the serve step refuses the mixed-step arguments and the engine
refuses an encoder-decoder, with the reference's messages, and the train
command runs the arch on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import configs as C
from repro.models import encdec as jencdec
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.launch import train as train_cmd
from repro_torch.models import encdec, is_encdec, lm, model_module
from repro_torch.serve import ServeConfig, ServeEngine, make_serve_fns

TOL = 1e-5
B, S_ENC, S_DEC = 2, 6, 5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    arch = C.reduced("seamless_m4t_v2")
    jp = jencdec.init_encdec(jax.random.PRNGKey(0), arch, jnp.float32)
    tp = params_from_jax(_np(jp), "cpu")
    rng = np.random.default_rng(3)
    batch = {"frames": rng.standard_normal((B, S_ENC, arch.d_model))
             .astype(np.float32),
             "tokens": rng.integers(0, arch.vocab, (B, S_DEC)).astype(
                 np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return arch, jp, tp, jb, tb


def test_init_encdec_tree_matches_the_reference(model):
    arch, jp, _, _, _ = model
    got = params_to_numpy(encdec.init_encdec(
        arch, torch.float32, generator=torch.Generator().manual_seed(0),
        device="cpu"))
    shapes = lambda t: {p: (a.shape, a.dtype) for p, a in lm.tree_leaves(t)}
    assert shapes(got) == shapes(_np(jp))
    assert "xattn" in got["stack"]["l0"] and "ln_x" in got["stack"]["l0"]
    assert "xattn" not in got["enc_stack"]["l0"]
    assert is_encdec(arch) and model_module(arch) is encdec
    assert model_module(C.reduced("internvl2_76b")) is lm


def test_forward_loss_and_every_gradient(model):
    arch, jp, tp, jb, tb = model
    want, _ = jencdec.forward(jp, jb, arch)
    got, _ = encdec.forward(tp, tb, arch)
    assert tuple(got.shape) == (B, S_DEC, arch.vocab)
    _close(got, want)

    (jl, jm), jg = jax.value_and_grad(
        lambda p: jencdec.loss_fn(p, jb, arch), has_aux=True)(jp)
    tree = lm.tree_map(lambda t: t.detach().requires_grad_(), tp)
    tl, tm = encdec.loss_fn(tree, tb, arch)
    paths = [p for p, _ in lm.tree_leaves(tree)]
    grads = torch.autograd.grad(tl, [t for _, t in lm.tree_leaves(tree)])
    _close(tl.detach(), jl)
    for k in ("nll", "accuracy"):
        _close(tm[k].detach(), jm[k])
    want_g = dict(lm.tree_leaves(_np(jg)))
    assert set(paths) == set(want_g)
    for p, g in zip(paths, grads):
        _close(g, want_g[p])
    enc = [g for p, g in zip(paths, grads) if p[0] in ("enc_in", "enc_stack")]
    assert enc and all(float(g.abs().max()) > 0 for g in enc)


def test_prefill_then_decode_steps_with_the_whole_cache(model):
    arch, jp, tp, jb, tb = model
    max_len = S_DEC + 4
    jc = jencdec.init_cache(arch, B, max_len, jnp.float32, enc_len=S_ENC)
    tc = encdec.init_cache(arch, B, max_len, torch.float32, enc_len=S_ENC,
                           device="cpu")
    assert ({p: a.shape for p, a in lm.tree_leaves(params_to_numpy(tc))}
            == {p: a.shape for p, a in lm.tree_leaves(_np(jc))})
    want, jc = jencdec.prefill(jp, jb, jc, arch)
    got, tc = encdec.prefill(tp, tb, tc, arch)
    _close(got, want)
    rng = np.random.default_rng(5)
    for i in range(4):
        tok = rng.integers(0, arch.vocab, (B, 1)).astype(np.int32)
        want, jc = jencdec.decode_step(jp, jnp.asarray(tok), jc,
                                       jnp.int32(S_DEC + i), arch)
        got, tc = encdec.decode_step(tp, torch.from_numpy(tok), tc,
                                     S_DEC + i, arch)
        _close(got, want)
    want_c = dict(lm.tree_leaves(_np(jc)))
    got_c = dict(lm.tree_leaves(params_to_numpy(tc)))
    assert set(got_c) == set(want_c) and ("memory",) in got_c
    for p, a in got_c.items():
        _close(a, want_c[p])


def test_lockstep_loop_matches_the_references_greedy_chain(model):
    """The serve command's loop (``launch.serve.lockstep``) against the
    reference's prefill and scalar-position decode steps, greedy: the
    tokens equal, every call's last-position logits within TOL; fed its
    own tokens it repeats itself.  ``models.init_params`` builds the
    reference's tree."""
    from repro_torch.launch import serve as serve_cmd
    from repro_torch.models import init_params
    arch, jp, tp, jb, tb = model
    got = serve_cmd.lockstep(tp, arch, tb, 4)
    jc = jencdec.init_cache(arch, B, S_DEC + 4, jnp.float32, enc_len=S_ENC)
    lg, jc = jencdec.prefill(jp, jb, jc, arch)
    want, toks = [lg[:, -1]], [jnp.argmax(lg[:, -1], -1)[:, None]]
    for i in range(3):
        lg, jc = jencdec.decode_step(jp, toks[-1].astype(jnp.int32), jc,
                                     jnp.int32(S_DEC + i), arch)
        want.append(lg[:, -1])
        toks.append(jnp.argmax(lg[:, -1], -1)[:, None])
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.concatenate(toks, axis=1))
    for a, b in zip(got["logits"], want):
        _close(a, b)
    fed = serve_cmd.lockstep(tp, arch, tb, 4, feed=got["tokens"][:, :-1])
    assert torch.equal(fed["tokens"], got["tokens"])
    own = params_to_numpy(init_params(
        arch, generator=torch.Generator().manual_seed(0), device="cpu"))
    shapes = lambda t: {p: (a.shape, a.dtype) for p, a in lm.tree_leaves(t)}
    assert shapes(own) == shapes(_np(jp))


def test_serve_step_and_engine_refuse_what_the_reference_refuses(model):
    arch, _, tp, _, _ = model
    _, step = make_serve_fns(arch)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    cache = encdec.init_cache(arch, B, 8, torch.float32, enc_len=S_ENC,
                              device="cpu")
    for kw in ({"q_lens": torch.ones(B, dtype=torch.int32)},
               {"block_tables": torch.zeros((B, 1), dtype=torch.int32)}):
        with pytest.raises(NotImplementedError, match="decoder-only"):
            step(tp, tok, cache, torch.zeros(B, dtype=torch.int32), **kw)
    with pytest.raises(NotImplementedError, match="static driver path"):
        ServeEngine(tp, arch, ServeConfig(max_batch=2, max_len=16))
    with pytest.raises(ValueError, match="repro_torch.models.encdec"):
        lm.init_cache(arch, 1, 4, device="cpu")


def test_train_command_runs_the_encoder_decoder(tmp_path):
    hist = train_cmd.main([
        "--arch", "seamless-m4t-large-v2", "--device", "cpu", "--steps",
        "3", "--batch", "2", "--seq", "16", "--width", "64", "--depth", "2",
        "--vocab", "64", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
        "--log-every", "1"])
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert any(tmp_path.iterdir())                        # checkpoints


def test_serve_command_runs_the_encoder_decoder_in_lockstep(capsys):
    from repro_torch.launch import serve as serve_cmd
    out = serve_cmd.main([
        "--arch", "seamless-m4t-large-v2", "--device", "cpu", "--width",
        "64", "--depth", "2", "--vocab", "64", "--batch", "2",
        "--prompt-len", "16", "--gen", "4"])
    assert tuple(out["tokens"].shape) == (2, 4)
    assert "prompt=8 gen=4 mode=static(encdec)" in capsys.readouterr().out
