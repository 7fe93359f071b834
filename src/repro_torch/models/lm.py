"""Decoder-only LM assembly: the counterpart of ``repro.models.lm`` for
the dense (``attn`` + SwiGLU), MoE (``attn`` + top-k experts), RWKV6
(``rwkv`` time mix + channel mix) and Mamba-hybrid (``mamba`` or ``attn``
mixers with dense or MoE FFNs, as Jamba) patterns.

Parameters are a dict tree with every per-layer tensor stacked over
pattern units (leading dim ``n_units``), exactly the reference's layout;
``run_stack`` walks the units in a Python loop.  Caches are dict trees
in the reference's layouts too, and are updated in place.

Entry points:
  init_lm(arch, dtype, generator=, device=)      -> params
  forward(params, batch, arch[, plan])           -> (logits, aux)
  loss_fn(params, batch, arch[, plan])           -> (loss, metrics)
  init_cache(arch, batch, max_len, dtype, device=) -> cache
  init_paged_cache(arch, num_blocks, block_size, batch, dtype, kv_quant=,
                   device=)                      -> cache
  prefill(params, batch, cache, arch)            -> (logits_last, cache)
  decode_step(params, token, cache, pos, arch[, block_tables])
                                                 -> (logits, cache)
  step(params, tokens, cache, pos, arch[, q_lens, block_tables])
                                                 -> (logits, cache)

``plan`` (a ``ModelPlan``; ``None`` is the uniform plan) places tensors
across devices: each unit runs under its segment's sublayer configs,
which constrain the activations at the reference's points
(:func:`repro_torch.core.sharding.constrain`).  Without an active mesh a
constraint is the identity, so a plan changes no arithmetic on one
device.  A frontend arch (a VLM) takes
``batch["frontend"]`` (B, F, D), stubbed patch embeddings that
``hidden_states`` and ``prefill`` put before the text, as the reference
does; its loss scores the text segment alone.  An encoder-decoder runs
through :mod:`repro_torch.models.encdec`, which reuses this module's
stack with cross-attention (``init_stack(..., cross_attn=True)``,
``run_stack(..., memory=...)``); the decoder-only entry points refuse it.

Training rematerializes each unit (``remat``) under one of the
reference's policies (:data:`REMAT_POLICIES`): recompute everything
(``"nothing"``), or keep the outputs of the matrix products without a
batch dimension (``"dots"``) or of every matrix product
(``"dots_batch"``).
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch import tracing
from repro_torch.core.config import LayerConfig
from repro_torch.core.sharding import constrain, contract, run_local
from repro_torch.device import resolve_device

from . import layers as L
from . import moe as M
from . import recurrent as Rc
from .arch import ArchConfig
from .plan import ModelPlan, uniform_plan

R = LayerConfig.REPLICATED
_BSD = ("batch", "seq", "d_model")


def check_arch(arch: ArchConfig) -> None:
    """Raise for an encoder-decoder, which the decoder-only entry points
    do not run."""
    if arch.enc_layers:
        raise ValueError(
            f"{arch.name} is an encoder-decoder: run it through "
            f"repro_torch.models.encdec (repro_torch.models.model_module)")


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree, path=()):
    """(path, tensor) for every leaf of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, path + (k,))
    else:
        yield path, tree


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #
def init_stack(arch: ArchConfig, n_units: int, dtype=torch.float32, *,
               cross_attn: bool = False, generator: torch.Generator,
               device) -> dict:
    """One pattern unit's layers with every tensor stacked over ``n_units``
    (the reference's ``init_stack``); ``cross_attn`` gives each layer a
    cross-attention block ``xattn`` and its norm ``ln_x``."""
    n = (n_units,)
    kw = dict(generator=generator, device=device)
    unit = {}
    for j, spec in enumerate(arch.pattern):
        lp = {"ln1": L.init_norm(arch, dtype, lead=n, device=device),
              "ln2": L.init_norm(arch, dtype, lead=n, device=device)}
        if spec.mixer == "rwkv":
            lp["tmix"] = Rc.init_rwkv_tmix(arch, dtype, lead=n, **kw)
            lp["cmix"] = Rc.init_rwkv_cmix(arch, dtype, lead=n, **kw)
        else:
            if spec.mixer == "mamba":
                lp["ssm"] = Rc.init_mamba(arch, dtype, lead=n, **kw)
            else:
                lp["attn"] = L.init_attention(arch, dtype, lead=n, **kw)
            if spec.ffn == "moe":
                lp["moe"] = M.init_moe(arch, dtype, lead=n, **kw)
            else:
                lp["mlp"] = L.init_mlp(arch, dtype, lead=n, **kw)
        if cross_attn:
            lp["ln_x"] = L.init_norm(arch, dtype, lead=n, device=device)
            lp["xattn"] = L.init_attention(arch, dtype, lead=n, **kw)
        unit[f"l{j}"] = lp
    return unit


def init_lm(arch: ArchConfig, dtype=torch.float32, *,
            generator: torch.Generator, device=None) -> dict:
    """Random weights from ``generator`` (on ``device``), stacked over
    units.  The numbers differ from the reference's ``jax.random`` init
    from the same seed; parity tests move the reference's weights across
    with :mod:`repro_torch.bridge` instead.  ``device=None`` means
    ``cuda`` (see :func:`repro_torch.device.resolve_device`)."""
    check_arch(arch)
    device = resolve_device(device)
    kw = dict(generator=generator, device=device)
    stack = init_stack(arch, arch.n_units, dtype, **kw)
    return {
        "embed": L.init_embed(arch, dtype, **kw),
        "stack": stack,
        "final_norm": L.init_norm(arch, dtype, device=device),
        "lm_head": L.init_lm_head(arch, dtype, **kw),
    }


# --------------------------------------------------------------------------- #
# one pattern unit, and the stack
# --------------------------------------------------------------------------- #
def _store(leaves: dict, new: dict) -> None:
    """Copy each new state into its cache leaf, in the leaf's dtype."""
    for name, t in new.items():
        leaves[name].copy_(t)


def plan_or_uniform(plan, arch: ArchConfig) -> ModelPlan:
    """``plan``, or the uniform plan (batch over ``data``) for None."""
    return plan if plan is not None else _uniform(arch)


@functools.lru_cache(maxsize=None)
def _uniform(arch: ArchConfig) -> ModelPlan:
    return uniform_plan(arch)


def unit_plan_at(segments, u: int):
    """The UnitPlan of the segment that holds unit ``u`` (None without
    segments)."""
    for seg in segments or ():
        if seg.start <= u < seg.end:
            return seg.plan
    return None


def _cross_attend(h, lp, arch, positions, memory, cfg):
    """Cross-attention after a layer's mixer: ``ln_x``, K/V projected from
    the memory ``(mem_h, mpos)`` with no bias, norm or rope, the
    non-causal chunked core, the output projection and the residual;
    ``cfg(key)`` gives the sublayer configs."""
    if memory is None:
        return h
    mem_h, mpos = memory
    xp = lp["xattn"]
    mk, mv = L._proj(mem_h, xp["wk"]), L._proj(mem_h, xp["wv"])
    hx = constrain(L.apply_norm(lp["ln_x"], h), cfg("ln_x"), _BSD)
    a, _ = L.attention(xp, hx, arch, cfg("xattn"), positions=positions,
                       causal=False, kv_override=(mk, mv, mpos),
                       use_rope=False)
    h = h + L.attention_out(xp, a, cfg("xattn_out"))
    return constrain(h, cfg("add_x"), _BSD)


def unit_forward(h, unit_params, arch: ArchConfig, unit_plan=None, *,
                 positions, causal=True, cache=None, cache_pos=None,
                 block_tables=None, q_lens=None, memory=None,
                 time_chunk=64):
    """Returns (h, aux_loss, new_cache) for one pattern unit; ``aux_loss``
    sums the unit's MoE load-balancing losses (0 without MoE layers).
    ``memory=(mem_h (B, S_enc, D), mpos (S_enc,))`` adds each attention
    or Mamba layer's cross-attention after its mixer (an encoder-decoder's
    decoder; no configuration puts it after an RWKV6 time mix).
    ``unit_plan`` (one dict of sublayer configs a layer) lays the
    activations out at the reference's points; None places nothing."""
    new_cache: dict = {}
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for j, spec in enumerate(arch.pattern):
        sub = unit_plan[j] if unit_plan else {}
        c = lambda key, sub=sub: sub.get(key, R)
        lp = unit_params[f"l{j}"]
        lc = cache.get(f"l{j}") if cache is not None else None
        hn = constrain(L.apply_norm(lp["ln1"], h), c("ln1"), _BSD)
        if spec.mixer == "rwkv":
            if cache is None:
                # the reference's inner remat: during the unit's backward
                # recompute only one time mix's internals are live at a time
                h = h + checkpoint(
                    lambda p_, h_, cfg=c("tmix"): Rc.rwkv_tmix(
                        p_, h_, arch, chunk=time_chunk, cfg=cfg)[0],
                    lp["tmix"], hn, use_reentrant=False,
                    preserve_rng_state=False)
                h = constrain(h, c("add1"), _BSD)
                hn = constrain(L.apply_norm(lp["ln2"], h), c("ln2"), _BSD)
                h = h + Rc.rwkv_cmix(lp["cmix"], hn, arch, cfg=c("cmix"))[0]
                h = constrain(h, c("add2"), _BSD)
                new_cache[f"l{j}"] = {}
                continue
            # the mixers return new states: write them into the cache
            # leaves, which may be a mixed step's row views
            y, st = Rc.rwkv_tmix(lp["tmix"], hn, arch,
                                 state=lc["tmix_state"], chunk=time_chunk,
                                 q_lens=q_lens, cfg=c("tmix"))
            _store(lc["tmix_state"], st)
            h = constrain(h + y, c("add1"), _BSD)
            hn = constrain(L.apply_norm(lp["ln2"], h), c("ln2"), _BSD)
            y, st = Rc.rwkv_cmix(lp["cmix"], hn, arch,
                                 state=lc["cmix_state"], q_lens=q_lens,
                                 cfg=c("cmix"))
            _store(lc["cmix_state"], st)
            h = constrain(h + y, c("add2"), _BSD)
            new_cache[f"l{j}"] = lc
            continue
        nc: dict = {}
        if spec.mixer == "mamba":
            if cache is None:
                # the reference's inner remat: during the unit's backward
                # recompute only one mixer's scan internals are live
                y = checkpoint(
                    lambda p_, h_, cfg=c("ssm"): Rc.mamba_mix(
                        p_, h_, arch, chunk=time_chunk, cfg=cfg)[0],
                    lp["ssm"], hn, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                y, nc["ssm_state"] = Rc.mamba_mix(
                    lp["ssm"], hn, arch, state=lc.get("ssm_state"),
                    chunk=time_chunk, q_lens=q_lens, cfg=c("ssm"))
            h = h + y
        else:
            a, kvc = L.attention(
                lp["attn"], hn, arch, c("attn"), positions=positions,
                causal=causal, kv_cache=(lc or {}).get("kv"),
                cache_pos=cache_pos, block_tables=block_tables,
                q_lens=q_lens)
            h = h + L.attention_out(lp["attn"], a, c("attn_out"))
            if kvc is not None:
                nc["kv"] = kvc
        h = constrain(h, c("add1"), _BSD)
        h = _cross_attend(h, lp, arch, positions, memory, c)
        hn = constrain(L.apply_norm(lp["ln2"], h), c("ln2"), _BSD)
        if spec.ffn == "moe":
            if cache is None:
                # the reference's inner remat: during the unit's backward
                # recompute one MoE layer's dispatch buffers live at a time
                y, a_loss = checkpoint(
                    lambda p_, h_, cfg=c("moe"): M.moe_ffn(p_, h_, arch, cfg),
                    lp["moe"], hn, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                y, a_loss = M.moe_ffn(lp["moe"], hn, arch, c("moe"))
            aux = aux + a_loss
        else:
            y = L.mlp(lp["mlp"], hn, c("mlp_in"), c("mlp_out"))
        h = constrain(h + y, c("add2"), _BSD)
        new_cache[f"l{j}"] = nc
    return h, aux, new_cache


_MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BMM = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
#: the reference's ``REMAT_POLICIES``: the ops whose outputs a unit's
#: backward keeps; everything else it recomputes.  ``x @ w`` of a (B, S, D)
#: activation reaches the dispatcher as ``mm`` (JAX's dot with no batch
#: dimension), an einsum over experts or heads as ``bmm``.  The CUDA
#: kernels are called through ctypes, not through the dispatcher, so no
#: policy sees them: their outputs are recomputed under every policy (a
#: difference in memory, never in results).
REMAT_POLICIES = {"nothing": (), "dots": _MM, "dots_batch": _MM + _BMM}


def remat_context(policy: str):
    """``context_fn`` for ``torch.utils.checkpoint`` under ``policy``."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; expected one "
                         f"of {sorted(REMAT_POLICIES)}")
    saved = REMAT_POLICIES[policy]
    if not saved:
        return noop_context_fn

    def keep(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return lambda: create_selective_checkpoint_contexts(keep)


def _unit(h, unit_params, arch, memory, kw):
    """:func:`unit_forward` inside span ``lm.unit``: the forward runs it
    once a unit, and a remat recompute once more."""
    with tracing.span("lm.unit"):
        return unit_forward(h, unit_params, arch, memory=memory, **kw)


def run_stack(h, stack_params, arch: ArchConfig, segments=(), *, positions,
              causal=True, cache=None, cache_pos=None, block_tables=None,
              q_lens=None, memory=None, time_chunk=64, remat=False,
              remat_policy="nothing"):
    """Walk the units in order; returns (h, aux_loss, cache).  Unit u's
    parameters and cache are the views ``leaf[u]`` of the stacked trees,
    so cache writes land in the stacked cache itself.

    ``remat`` (training, no cache) runs each unit under
    ``torch.utils.checkpoint``: the backward pass keeps each unit's input
    and what ``remat_policy`` saves (:data:`REMAT_POLICIES`), and
    recomputes the rest.  The inner per-mixer checkpoints save nothing,
    as in the reference.  ``memory`` (see :func:`unit_forward`) goes to
    the checkpointed function as an input, so its gradient flows through
    every unit's recompute.  ``segments`` (a ModelPlan's) gives each
    unit its sublayer configs."""
    context_fn = remat_context(remat_policy)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for u in range(arch.n_units):
        unit_params = tree_map(lambda a: a[u], stack_params)
        unit_cache = (tree_map(lambda a: a[u], cache)
                      if cache is not None else None)
        kw = dict(unit_plan=unit_plan_at(segments, u), positions=positions,
                  causal=causal, cache=unit_cache, cache_pos=cache_pos,
                  block_tables=block_tables, q_lens=q_lens,
                  time_chunk=time_chunk)
        if remat and cache is None:
            # ``kw`` (and each inner remat's config) is bound when the
            # lambda is made: the recompute runs after the loop moved on
            h, a = checkpoint(
                lambda h_, p_, m_, kw=kw: _unit(h_, p_, arch, m_, kw)[:2],
                h, unit_params, memory, use_reentrant=False,
                preserve_rng_state=False, context_fn=context_fn)
        else:
            h, a, _ = _unit(h, unit_params, arch, memory, kw)
        aux = aux + a
    return h, aux, cache


# --------------------------------------------------------------------------- #
# full forward / loss
# --------------------------------------------------------------------------- #
def hidden_states(params, batch: dict, arch: ArchConfig, plan=None, *,
                  q_chunk=512, time_chunk=64, remat=True,
                  remat_policy="nothing"):
    """Embed (after ``batch["frontend"]`` for a frontend arch) + layer
    stack + final norm -> ((B, S, D), aux_loss).  ``q_chunk`` is accepted
    for signature parity (the attention kernel does not chunk queries)."""
    check_arch(arch)
    plan = plan_or_uniform(plan, arch)
    h = _embed_inputs(params, batch, arch, plan)
    positions = torch.arange(h.shape[1], device=h.device)
    h, aux, _ = run_stack(h, params["stack"], arch, plan.segments,
                          positions=positions, causal=True,
                          time_chunk=time_chunk, remat=remat,
                          remat_policy=remat_policy)
    h = L.apply_norm(params["final_norm"], h)
    return constrain(h, plan.final_norm, _BSD), aux


def _embed_inputs(params, batch: dict, arch: ArchConfig, plan=None):
    """The token embeddings, after the frontend's (B, F, D) embeddings
    (cast to their dtype) where the arch has a frontend and the batch
    carries one."""
    cfg = plan.embed if plan is not None else R
    h = L.embed(params["embed"], batch["tokens"], cfg)
    if arch.frontend and "frontend" in batch:
        h = torch.cat([batch["frontend"].to(h.dtype), h], dim=1)
        h = constrain(h, cfg, _BSD)
    return h


def forward(params, batch: dict, arch: ArchConfig, plan=None, *,
            q_chunk=512, time_chunk=64, remat=True, remat_policy="nothing"):
    """batch: {"tokens": (B, S_text) [, "frontend": (B, F, D)]} -> (logits
    (B, S, V), aux_loss), S = F + S_text with a frontend."""
    h, aux = hidden_states(params, batch, arch, plan, q_chunk=q_chunk,
                           time_chunk=time_chunk, remat=remat,
                           remat_policy=remat_policy)
    plan = plan_or_uniform(plan, arch)
    return L.lm_head(params["lm_head"], h, params["embed"], arch,
                     plan.lm_head), aux


def softmax_xent(logits, labels, z_loss_coef: float = 1e-4):
    """Causal-LM cross entropy in float32 with z-loss; returns (loss,
    metrics)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    loss = nll.mean() + z_loss_coef * lse.square().mean()
    acc = (lf.argmax(-1) == labels).float().mean()
    return loss, {"nll": nll.mean(), "accuracy": acc}


def _token_xent(lf, lc):
    """Per token: log-sum-exp, the gold logit, and whether the argmax hit
    it (float32 logits (B, T, V), labels (B, T))."""
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, lc.long()[..., None])[..., 0]
    return lse, gold, (lf.argmax(-1) == lc).float()


def _xent_sums(hc, lc, w, cfg=R):
    # the logits are laid out by the plan's lm_head config; on a realized
    # plan the per-token terms are then taken on each shard's tokens with
    # the vocab whole (DTensor's gather over a split vocab is unreliable)
    lf = constrain(contract(hc, w), cfg, ("batch", "seq", "vocab"))
    lf = constrain(lf, cfg, ("batch", "seq", None)).float()
    bs = ("batch", "seq")
    lse, gold, hit = run_local(_token_xent, [lf, lc], [bs + (None,), bs],
                               [bs, bs, bs], allowed=bs)
    return (lse - gold).sum(), lse.square().sum(), hit.sum()


def chunked_lm_loss(h, labels, params, arch: ArchConfig, plan=None, *,
                    chunk: int = 512, z_loss_coef: float = 1e-4):
    """Causal-LM loss with the logits made and consumed in sequence chunks,
    each under ``torch.utils.checkpoint`` (recomputed in the backward
    pass), so the whole (B, T, V) tensor never exists at once.

    h: (B, T, D) hidden states; labels: (B, T) next-token targets.
    """
    B, T, _ = h.shape
    w = (params["embed"]["table"].T if arch.tie_embeddings
         else params["lm_head"]["w"])
    n = T // chunk if (T % chunk == 0 and T > chunk) else 1
    c = T // n
    nll = z = acc = 0.0
    for i in range(n):
        sl = slice(i * c, (i + 1) * c)
        dn, dz, da = checkpoint(_xent_sums, h[:, sl], labels[:, sl], w,
                                plan_or_uniform(plan, arch).lm_head,
                                use_reentrant=False, preserve_rng_state=False)
        nll, z, acc = nll + dn, z + dz, acc + da
    count = B * T
    loss = nll / count + z_loss_coef * z / count
    return loss, {"nll": nll / count, "accuracy": acc / count}


def loss_fn(params, batch: dict, arch: ArchConfig, plan=None, *,
            aux_coef: float = 0.01, q_chunk=512, time_chunk=64, remat=True,
            loss_chunk=512, remat_policy="nothing"):
    """Next-token loss of ``batch["tokens"]`` (B, S); returns (loss,
    {"loss", "nll", "accuracy", "aux"}).  Frontend positions carry no
    labels: only the text segment is scored."""
    h, aux = hidden_states(params, batch, arch, plan, q_chunk=q_chunk,
                           time_chunk=time_chunk, remat=remat,
                           remat_policy=remat_policy)
    tokens = batch["tokens"]
    h = h[:, -tokens.shape[1]:]
    loss, metrics = chunked_lm_loss(h[:, :-1, :], tokens[:, 1:], params,
                                    arch, plan, chunk=loss_chunk)
    loss = loss + aux_coef * aux
    metrics["aux"] = aux
    metrics["loss"] = loss
    return loss, metrics


def _head(params, h, arch, plan=None):
    plan = plan_or_uniform(plan, arch)
    h = constrain(L.apply_norm(params["final_norm"], h), plan.final_norm,
                  _BSD)
    return L.lm_head(params["lm_head"], h, params["embed"], arch,
                     plan.lm_head)


# --------------------------------------------------------------------------- #
# serving: cache init / prefill / decode
# --------------------------------------------------------------------------- #
def _slot_state(arch: ArchConfig, spec, batch: int, dtype, device) -> dict:
    """A recurrent layer's slot-dense state leaves ((n_units, batch, ...)),
    as in the reference: a Mamba layer's conv window in the cache dtype
    and SSM state in float32; an RWKV6 layer's token shifts in the cache
    dtype and WKV state in float32."""
    n = arch.n_units
    zeros = lambda *shape, dt=dtype: torch.zeros((n, batch, *shape),
                                                 dtype=dt, device=device)
    if spec.mixer == "mamba":
        return {"ssm_state": {
            "conv": zeros(arch.ssm_conv - 1, arch.d_inner),
            "ssm": zeros(arch.d_inner, arch.ssm_state, dt=torch.float32)}}
    H, hs, D = arch.n_rwkv_heads, arch.rwkv_head_size, arch.d_model
    return {"tmix_state": {"shift": zeros(D),
                           "wkv": zeros(H, hs, hs, dt=torch.float32)},
            "cmix_state": {"shift": zeros(D)}}


def init_cache(arch: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device=None) -> dict:
    """KV rows ``(n_units, batch, max_len, KH, hd)`` for attention layers,
    slot-dense state for Mamba and RWKV6 layers."""
    check_arch(arch)
    return init_stack_cache(arch, batch, max_len, dtype, device=device)


def init_stack_cache(arch: ArchConfig, batch: int, max_len: int,
                     dtype=torch.bfloat16, *, device=None) -> dict:
    """:func:`init_cache` of the arch's stack alone, whatever else the
    model holds (``encdec`` keeps its decoder's rows in one)."""
    device = resolve_device(device)
    shape = (arch.n_units, batch, max_len, arch.n_kv_heads, arch.hd)
    cache = {}
    for j, spec in enumerate(arch.pattern):
        if spec.mixer != "attn":
            cache[f"l{j}"] = _slot_state(arch, spec, batch, dtype, device)
        else:
            cache[f"l{j}"] = {"kv": {
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}}
    return cache


def init_paged_cache(arch: ArchConfig, num_blocks: int, block_size: int,
                     batch: int, dtype=torch.bfloat16, *,
                     kv_quant: str | None = None, device=None) -> dict:
    """KV leaves as one pool of ``num_blocks`` blocks ``(n_units, NB,
    block_size, KH, hd)`` shared by all slots through a block table.
    ``kv_quant="int8"`` stores the pool as int8 with per-(slot, head)
    f32 scales ``k_scale``/``v_scale`` ``(n_units, NB, block_size, KH)``;
    zero scales dequantize never-written slots to exactly 0.0.  Recurrent
    (Mamba, RWKV6) state is O(1) in sequence length and stays slot-dense
    ``(n_units, batch, ...)``, exactly as in :func:`init_cache`."""
    if kv_quant not in (None, "none", "int8"):
        raise ValueError(f"unknown kv_quant {kv_quant!r}")
    check_arch(arch)
    device = resolve_device(device)
    quant = kv_quant == "int8"
    shape = (arch.n_units, num_blocks, block_size, arch.n_kv_heads, arch.hd)
    pool_dtype = torch.int8 if quant else dtype

    def kv_pool():
        leaves = {"k": torch.zeros(shape, dtype=pool_dtype, device=device),
                  "v": torch.zeros(shape, dtype=pool_dtype, device=device)}
        if quant:
            for name in ("k_scale", "v_scale"):
                leaves[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                           device=device)
        return leaves

    return {f"l{j}": ({"kv": kv_pool()} if spec.mixer == "attn"
                      else _slot_state(arch, spec, batch, dtype, device))
            for j, spec in enumerate(arch.pattern)}


def prefill(params, batch: dict, cache: dict, arch: ArchConfig, plan=None):
    """Process the prompt (``batch["tokens"]`` (B, S), after
    ``batch["frontend"]`` for a frontend arch), filling ``cache`` from
    position 0; returns (last-position logits (B, 1, V), cache)."""
    check_arch(arch)
    plan = plan_or_uniform(plan, arch)
    h = _embed_inputs(params, batch, arch, plan)
    positions = torch.arange(h.shape[1], device=h.device)
    h, _, cache = run_stack(h, params["stack"], arch, plan.segments,
                            positions=positions, causal=True, cache=cache,
                            cache_pos=0)
    return _head(params, h[:, -1:, :], arch, plan), cache


def decode_positions(pos, batch: int, device=None):
    """``pos`` -> (rope positions, cache_pos): a scalar gives ((1,), ())
    (every row at one position); a ``(batch,)`` vector gives ((B, 1),
    (B,)) per-slot positions.  Anything else raises."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    if pos.ndim == 0:
        return pos[None], pos
    if pos.ndim == 1 and pos.shape[0] == batch:
        return pos[:, None], pos
    raise ValueError(
        f"decode pos must be a scalar or a ({batch},) vector matching the "
        f"token batch; got shape {tuple(pos.shape)}")


def decode_step(params, token, cache: dict, pos, arch: ArchConfig,
                plan=None, *, block_tables=None):
    """One decode step.  token: (B, 1); pos: scalar or (B,) (see
    :func:`decode_positions`).  With ``block_tables`` the KV leaves are
    the paged pool and ``pos`` must be (B,)."""
    check_arch(arch)
    plan = plan_or_uniform(plan, arch)
    h = L.embed(params["embed"], token, plan.embed)
    positions, cache_pos = decode_positions(pos, token.shape[0], token.device)
    if block_tables is not None and cache_pos.ndim != 1:
        raise ValueError("paged decode (block_tables) requires a (B,) "
                         "per-slot pos vector")
    h, _, cache = run_stack(h, params["stack"], arch, plan.segments,
                            positions=positions, causal=True, cache=cache,
                            cache_pos=cache_pos, block_tables=block_tables)
    return _head(params, h, arch, plan), cache


def step(params, tokens, cache: dict, pos, arch: ArchConfig, plan=None, *,
         q_lens=None, block_tables=None):
    """One unified mixed step: row b advances ``q_lens[b]`` of its T
    tokens from cache depth ``pos[b]`` (decoding slots 1, a prefill chunk
    up to T, idle slots 0).  ``q_lens=None`` means every row advances all
    T tokens.  Returns (logits (B, T, V), cache); row b's next-token
    logits sit at ``logits[b, q_lens[b] - 1]``, the rest is garbage."""
    check_arch(arch)
    B, T = tokens.shape
    pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
    if pos.ndim == 0:
        pos = pos.expand(B)
    elif tuple(pos.shape) != (B,):
        raise ValueError(
            f"step pos must be a scalar or a ({B},) vector matching the "
            f"token batch; got shape {tuple(pos.shape)}")
    if q_lens is not None:
        q_lens = torch.as_tensor(q_lens, dtype=torch.int32,
                                 device=tokens.device)
        if tuple(q_lens.shape) != (B,):
            raise ValueError(
                f"step q_lens must be a ({B},) vector matching the token "
                f"batch; got shape {tuple(q_lens.shape)}")
    elif T > 1:
        q_lens = torch.full((B,), T, dtype=torch.int32, device=tokens.device)
    plan = plan_or_uniform(plan, arch)
    h = L.embed(params["embed"], tokens, plan.embed)
    positions = pos[:, None] + torch.arange(T, device=tokens.device)[None, :]
    h, _, cache = run_stack(h, params["stack"], arch, plan.segments,
                            positions=positions, causal=True, cache=cache,
                            cache_pos=pos, block_tables=block_tables,
                            q_lens=q_lens)
    return _head(params, h, arch, plan), cache
