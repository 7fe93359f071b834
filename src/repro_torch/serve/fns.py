"""Serving step builders: the counterpart of ``repro.serve.fns``.

``make_serve_fns`` returns ``(prefill, step)`` over the port's dense,
MoE, RWKV6, Mamba-hybrid and VLM LMs, and over the encoder-decoder, whose
step is single-token decode only (as in the reference).
There is no jit: PyTorch runs eagerly, and the cache is updated in
place where the reference donated it to jit.  A plan is taken and
resolved per phase as the reference's is (arch-checked; prefill under
its ``prefill`` phase, the step under its ``decode`` phase).  On a
realized plan (DTensor params and cache, the caller under ``use_mesh``)
both functions return the logits as plain (gathered) tensors.
"""

from __future__ import annotations

import torch

from repro_torch.core.sharding import whole
from repro_torch.kernels.dispatch import force_backend
from repro_torch.models import lm, model_module
from repro_torch.models.arch import ArchConfig
from repro_torch.models.plan import ModelPlan
from repro_torch.plans.parallel_plan import ParallelPlan, as_model_plan


def _is_kv_path(path) -> bool:
    return "kv" in path


def _row_views(tree, g: int, paged: bool, path=()):
    """Row ``g`` of the cache as views ``leaf[:, g:g+1]`` (writes land in
    the cache itself); a paged pool's KV leaves pass whole, since they are
    shared by every slot through the block tables."""
    if isinstance(tree, dict):
        return {k: _row_views(v, g, paged, path + (k,))
                for k, v in tree.items()}
    return tree if paged and _is_kv_path(path) else tree[:, g:g + 1]


def make_serve_fns(arch: ArchConfig,
                   plan: ParallelPlan | ModelPlan | None = None,
                   kernel_backend: str | None = None):
    """Build ``(prefill, step)``.

    ``kernel_backend`` forces a kernel dispatch backend around each call
    (:func:`repro_torch.kernels.dispatch.force_backend`); None
    auto-selects.

    ``plan`` is resolved per phase (``as_model_plan``: a ``ParallelPlan``
    is checked against ``arch``); its configs constrain the activations
    under an active mesh and place nothing without one.

    ``step(params, tokens, cache, pos, q_lens=None, block_tables=None)``
    is the unified mixed step over a paged cache (``block_tables`` given)
    or the dense per-slot rows (``block_tables=None``).  ``pos`` is a
    scalar or a (B,) vector of per-slot positions; ``tokens`` is (B, T)
    with ``q_lens`` marking how many of the T columns each row advances.

    A mixed step (``q_lens`` given, T > 1) returns (B, 1, V) next-token
    logits: every row's last live logits in column 0.  It runs as a
    (B, 1) decode pass with the granted row masked to ``q_lens == 0``,
    then a (1, T) chunk pass on the granted row alone, so the chunk never
    pays for (B - 1) x T padded positions.  The scheduler hands a step's
    whole chunk budget to one slot, so exactly one row has
    ``q_lens == T`` and ``argmax(q_lens)`` finds it.

    An encoder-decoder's ``prefill`` encodes ``batch["frames"]`` and
    fills a ``{"dec", "memory"}`` cache (``encdec.init_cache``); its
    ``step`` is ``encdec.decode_step`` and raises on ``q_lens`` or
    ``block_tables``.
    """
    pre_plan = as_model_plan(plan, arch, "prefill")
    dec_plan = as_model_plan(plan, arch, "decode")
    mod = model_module(arch)

    def prefill(params, batch, cache):
        with force_backend(kernel_backend):
            logits, cache = mod.prefill(params, batch, cache, arch,
                                        pre_plan)
        return whole(logits), cache

    if mod is not lm:
        def decode(params, tokens, cache, pos, q_lens=None,
                   block_tables=None):
            if q_lens is not None or block_tables is not None:
                raise NotImplementedError(
                    f"{arch.name}: mixed-step serving (q_lens/block_tables) "
                    "is decoder-only for now")
            with force_backend(kernel_backend):
                logits, cache = mod.decode_step(params, tokens, cache, pos,
                                                arch, dec_plan)
            return whole(logits), cache
        return prefill, decode

    def _model_step(params, tokens, cache, pos, q_lens, block_tables):
        with force_backend(kernel_backend):
            logits, cache = lm.step(params, tokens, cache, pos, arch,
                                    dec_plan, q_lens=q_lens,
                                    block_tables=block_tables)
        return whole(logits), cache

    def step(params, tokens, cache, pos, q_lens=None, block_tables=None):
        if q_lens is None or tokens.shape[1] == 1:
            return _model_step(params, tokens, cache, pos, q_lens,
                               block_tables)
        B, T = tokens.shape
        dev = tokens.device
        q_lens = torch.as_tensor(q_lens, dtype=torch.int32, device=dev)
        pos = torch.as_tensor(pos, dtype=torch.int32, device=dev).expand(B)
        # 1. (B, 1) decode pass; the granted row is masked to q_lens == 0:
        #    a paged write is parked in the trash block, a dense one lands
        #    at pos[g], inside the range the chunk pass overwrites
        dec_q = (q_lens == 1).to(torch.int32)
        logits, cache = _model_step(params, tokens[:, :1], cache, pos, dec_q,
                                    block_tables)
        # 2. (1, T) chunk pass on row g: a paged pool passes whole with row
        #    g's table row; every other leaf (dense KV rows, recurrent state)
        #    passes as the view leaf[:, g:g+1], so the chunk's writes land
        #    in the cache itself
        g = int(torch.argmax(q_lens))
        paged = block_tables is not None
        row = _row_views(cache, g, paged)
        bt = block_tables[g:g + 1] if paged else None
        chunk_logits, _ = _model_step(params, tokens[g:g + 1], row,
                                      pos[g:g + 1], q_lens[g:g + 1], bt)
        # q_lens[g] == T: the chunk's last column is row g's next token
        logits[g, 0] = chunk_logits[0, -1].to(logits.dtype)
        return logits, cache

    return prefill, step
