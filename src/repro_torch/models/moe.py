"""Top-k MoE FFN with GShard capacity dispatch: the counterpart of
``repro.models.moe``.

Tokens are routed within their batch row (the GShard group) into
per-expert buffers of capacity ``C = capacity(S)``; assignments past
capacity are dropped (they contribute zero; the residual carries the
token).  Routing (router matmul in float32, softmax, top-k, gate
renormalisation) and the load-balancing auxiliary loss live here; the
dispatch -> expert FFN -> combine pipeline runs through
:func:`repro_torch.kernels.ops.moe_dispatch_combine`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.config import LayerConfig
from repro_torch.core.sharding import constrain, contract
from repro_torch.kernels import ops

from .layers import dense_init

R = LayerConfig.REPLICATED


def init_moe(arch, dtype, *, generator, device, lead=()):
    d, f, e = arch.d_model, arch.moe_d_ff or arch.d_ff, arch.n_experts
    kw = dict(generator=generator, device=device)
    return {
        "router": dense_init((*lead, d, e), torch.float32, fan_in=d, **kw),
        "wi": dense_init((*lead, e, d, f), dtype, fan_in=d, **kw),
        "wg": dense_init((*lead, e, d, f), dtype, fan_in=d, **kw),
        "wo": dense_init((*lead, e, f, d), dtype, fan_in=f, **kw),
    }


def capacity(tokens: int, arch) -> int:
    """Slots per expert and batch row: ``capacity_factor * tokens * top_k
    / n_experts``, at least 8, rounded up to a multiple of 8."""
    c = int(arch.capacity_factor * tokens * arch.top_k / arch.n_experts)
    return max(8, -(-c // 8) * 8)


def route(p: dict, x, arch, cfg: LayerConfig = R):
    """x: (B, S, D) -> (gate_vals (B, S, K) in x's dtype, expert_idx
    (B, S, K), probs (B, S, E) float32).  The router runs in float32; the
    top-k gates are renormalised to sum to one (floor 1e-9).  On a
    realized plan the softmax and the top-k see every expert (the
    router's columns may be split over the expert axes)."""
    logits = contract(x.float(), p["router"].float())
    logits = constrain(logits, cfg, ("batch", "seq", None))
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, arch.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return gate_vals.to(x.dtype), expert_idx, probs


def moe_ffn(p: dict, x, arch, cfg: LayerConfig = R):
    """x: (B, S, D) -> (y (B, S, D), aux_loss float32 scalar), the
    Switch/GShard load-balancing loss ``E * sum_e frac_tokens_e *
    frac_probs_e / K``.  ``cfg`` (the plan's ``moe`` config) may shard
    batch/seq, expert (expert parallelism) and d_ff; the dispatch applies
    it through its ``constrain`` callback."""
    S = x.shape[1]
    E, K = arch.n_experts, arch.top_k
    gate_vals, expert_idx, probs = route(p, x, arch, cfg)
    y = ops.moe_dispatch_combine(
        x, gate_vals, expert_idx, p["wi"], p["wg"], p["wo"],
        capacity=capacity(S, arch),
        constrain=lambda a, dims: constrain(a, cfg, dims))
    onehot = F.one_hot(expert_idx, E).sum(2).float()          # (B, S, E)
    frac_tokens = onehot.mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * frac_probs) / K
    return y, aux
