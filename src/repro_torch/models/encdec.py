"""Encoder-decoder model (seamless-m4t): the counterpart of
``repro.models.encdec``.

A bidirectional encoder over stubbed modality frame embeddings, then a
causal decoder with cross-attention in every layer.  Both stacks are
:mod:`repro_torch.models.lm`'s units: the encoder is the arch seen as a
period-1 ``attn`` + dense pattern (:func:`_enc_view`), run non-causally,
so its self-attention is the flash kernel's full (non-causal) form; the
decoder's units carry ``ln_x`` and ``xattn`` and attend over the
encoder's output (the memory) through the chunked core.

Entry points (``plan``, a ``ModelPlan`` or None for the uniform one,
constrains the activations as in ``lm``):
  init_encdec(arch, dtype, generator=, device=)   -> params
  encode(params, frames, arch[, plan])            -> memory (B, S_enc, D)
  forward(params, batch, arch[, plan])            -> (logits, aux)
  loss_fn(params, batch, arch[, plan])            -> (loss, metrics)
  init_cache(arch, batch, max_len, dtype, enc_len=, device=)
                                                  -> {"dec", "memory"}
  prefill(params, batch, cache, arch)             -> (logits_last, cache)
  decode_step(params, token, cache, pos, arch)    -> (logits, cache)

``batch`` is ``{"frames": (B, S_enc, D), "tokens": (B, S_dec)}``.  As in
the reference, every decode step projects the memory's K/V afresh in
every layer; the cache holds the decoder's KV rows and the memory.
"""

from __future__ import annotations

import torch

from repro_torch.core.sharding import constrain, contract
from repro_torch.device import resolve_device

from . import layers as L
from . import lm
from .arch import ArchConfig
from .plan import _enc_view


def init_encdec(arch: ArchConfig, dtype=torch.float32, *,
                generator: torch.Generator, device=None) -> dict:
    """Random weights from ``generator`` (on ``device``; ``None`` means
    ``cuda``), in the reference's tree: ``enc_in`` (the frames' linear
    adapter), ``enc_stack``, ``enc_norm``, ``embed``, ``stack`` (with
    cross-attention), ``final_norm`` and ``lm_head``."""
    device = resolve_device(device)
    kw = dict(generator=generator, device=device)
    d = arch.d_model
    return {
        "enc_in": {"w": L.dense_init((d, d), dtype, fan_in=d, **kw)},
        "enc_stack": lm.init_stack(_enc_view(arch), arch.enc_layers, dtype,
                                   **kw),
        "enc_norm": L.init_norm(arch, dtype, device=device),
        "embed": L.init_embed(arch, dtype, **kw),
        "stack": lm.init_stack(arch, arch.n_units, dtype, cross_attn=True,
                               **kw),
        "final_norm": L.init_norm(arch, dtype, device=device),
        "lm_head": L.init_lm_head(arch, dtype, **kw),
    }


_BSD = ("batch", "seq", "d_model")


def encode(params, frames, arch: ArchConfig, plan=None, *, remat=False):
    """frames: (B, S_enc, D) stubbed embeddings -> (B, S_enc, D) memory."""
    plan = lm.plan_or_uniform(plan, arch)
    w = params["enc_in"]["w"]
    h = constrain(contract(frames.to(w.dtype), w), plan.enc_embed, _BSD)
    positions = torch.arange(h.shape[1], device=h.device)
    h, _, _ = lm.run_stack(h, params["enc_stack"], _enc_view(arch),
                           plan.enc_segments, positions=positions,
                           causal=False, remat=remat)
    return L.apply_norm(params["enc_norm"], h)


def _decode(params, batch, arch, plan, *, remat):
    """Encode, then the decoder stack over the memory -> ((B, S_dec, D),
    aux); ``remat`` checkpoints every unit of both stacks."""
    plan = lm.plan_or_uniform(plan, arch)
    memory = encode(params, batch["frames"], arch, plan, remat=remat)
    mpos = torch.arange(memory.shape[1], device=memory.device)
    tokens = batch["tokens"]
    h = L.embed(params["embed"], tokens, plan.embed)
    h, aux, _ = lm.run_stack(
        h, params["stack"], arch, plan.segments,
        positions=torch.arange(tokens.shape[1], device=h.device),
        causal=True, memory=(memory, mpos), remat=remat)
    h = L.apply_norm(params["final_norm"], h)
    return constrain(h, plan.final_norm, _BSD), aux


def forward(params, batch: dict, arch: ArchConfig, plan=None, *,
            q_chunk=512, remat=True):
    """-> (logits (B, S_dec, V), aux)."""
    h, aux = _decode(params, batch, arch, plan, remat=remat)
    return L.lm_head(params["lm_head"], h, params["embed"], arch,
                     lm.plan_or_uniform(plan, arch).lm_head), aux


def loss_fn(params, batch: dict, arch: ArchConfig, plan=None, *,
            q_chunk=512, remat=True, loss_chunk=512):
    """Next-token loss of the decoder tokens; returns (loss, {"loss",
    "nll", "accuracy"})."""
    h, _ = _decode(params, batch, arch, plan, remat=remat)
    tokens = batch["tokens"]
    loss, metrics = lm.chunked_lm_loss(h[:, :-1, :], tokens[:, 1:], params,
                                       arch, plan, chunk=loss_chunk)
    metrics["loss"] = loss
    return loss, metrics


def init_cache(arch: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, enc_len: int = 0,
               device=None) -> dict:
    """``{"dec": the decoder's dense KV rows}`` (``lm.init_stack_cache``),
    plus a zero ``"memory"`` (B, enc_len, D) with ``enc_len``."""
    device = resolve_device(device)
    cache = {"dec": lm.init_stack_cache(arch, batch, max_len, dtype,
                                        device=device)}
    if enc_len:
        cache["memory"] = torch.zeros((batch, enc_len, arch.d_model),
                                      dtype=dtype, device=device)
    return cache


def prefill(params, batch: dict, cache: dict, arch: ArchConfig, plan=None,
            *, q_chunk=512):
    """Encode, then prefill the decoder's KV rows from position 0; returns
    (last-position logits (B, 1, V), {"dec", "memory"}) with the memory
    that decode steps attend to."""
    plan = lm.plan_or_uniform(plan, arch)
    memory = encode(params, batch["frames"], arch, plan)
    mpos = torch.arange(memory.shape[1], device=memory.device)
    tokens = batch["tokens"]
    h = L.embed(params["embed"], tokens, plan.embed)
    h, _, dec = lm.run_stack(
        h, params["stack"], arch, plan.segments,
        positions=torch.arange(tokens.shape[1], device=h.device),
        causal=True, cache=cache["dec"], cache_pos=0, memory=(memory, mpos))
    return lm._head(params, h[:, -1:, :], arch, plan), {"dec": dec,
                                                         "memory": memory}


def decode_step(params, token, cache: dict, pos, arch: ArchConfig,
                plan=None):
    """One decode step over the dense rows: token (B, 1); pos a scalar or
    (B,) (``lm.decode_positions``)."""
    plan = lm.plan_or_uniform(plan, arch)
    memory = cache["memory"]
    mpos = torch.arange(memory.shape[1], device=memory.device)
    h = L.embed(params["embed"], token, plan.embed)
    positions, cache_pos = lm.decode_positions(pos, token.shape[0],
                                               token.device)
    h, _, dec = lm.run_stack(h, params["stack"], arch, plan.segments,
                             positions=positions, causal=True,
                             cache=cache["dec"], cache_pos=cache_pos,
                             memory=(memory, mpos))
    return lm._head(params, h, arch, plan), {"dec": dec, "memory": memory}
