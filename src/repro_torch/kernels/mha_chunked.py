"""Positions-aware chunked attention in plain PyTorch: the counterpart of
``repro.kernels.mha_xla.mha_chunked``.

Queries and keys carry free-form positions (``q_positions``,
``kv_positions``), so this one core serves the two attention forms that
the blocked kernels do not take: cross-attention over an encoder's memory
(``layers.attention(kv_override=...)``, non-causal) and a dense cache
continued mid-sequence (query row i at absolute position ``cache_pos + i``
against the whole cache row, causal).  In the reference it is XLA on every
platform, not a Pallas kernel, so its port is plain torch on the card as
well; it stays differentiable by autograd, since training runs
cross-attention through it.
"""

from __future__ import annotations

import math

import torch

from .ref import NEG_INF


def _attend_chunk(qc, qpos, k, v, kv_positions, *, causal, scale, kv_chunk):
    """qc: (B, C, H, D) -> (B, C, H, D): online softmax over kv chunks with
    float32 statistics."""
    B, Skv, H, D = k.shape
    qf = qc.float()

    def scores(kc, kvpos):
        s = torch.einsum("bchd,bthd->bhct", qf, kc.float()) * scale
        if causal:
            mask = qpos[:, None] >= kvpos[None, :]              # (C, Tc)
            s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
        return s

    if Skv <= kv_chunk or Skv % kv_chunk != 0:
        s = scores(k, kv_positions)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1)
        acc = torch.einsum("bhct,bthd->bhcd", p, v.float())
    else:
        C = qc.shape[1]
        m = torch.full((B, H, C, 1), NEG_INF, dtype=torch.float32,
                       device=qc.device)
        l = torch.zeros((B, H, C), dtype=torch.float32, device=qc.device)
        acc = torch.zeros((B, H, C, D), dtype=torch.float32, device=qc.device)
        for i in range(Skv // kv_chunk):
            sl = slice(i * kv_chunk, (i + 1) * kv_chunk)
            s = scores(k[:, sl], kv_positions[sl])
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha[..., 0] + p.sum(dim=-1)
            acc = acc * alpha + torch.einsum("bhct,bthd->bhcd", p,
                                             v[:, sl].float())
            m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(qc.dtype)                     # (B, C, H, D)


def mha_chunked(q, k, v, *, causal: bool, q_positions, kv_positions,
                q_chunk: int = 512, kv_chunk: int = 1024):
    """q: (B, Sq, H, D); k/v: (B, Skv, H, D), K/V already expanded to the
    full head count; q_positions (Sq,), kv_positions (Skv,).  Returns
    (B, Sq, H, D).  Query chunks of ``q_chunk`` rows, each an online
    softmax over kv chunks of ``kv_chunk`` keys; as in the reference, a
    length at most its chunk or not a multiple of it is one chunk.  With
    ``causal`` a query attends to the keys whose position is at most its
    own."""
    Sq = q.shape[1]
    kw = dict(causal=causal, scale=1.0 / math.sqrt(q.shape[-1]),
              kv_chunk=kv_chunk)
    if Sq <= q_chunk or Sq % q_chunk != 0:
        return _attend_chunk(q, q_positions, k, v, kv_positions, **kw)
    return torch.cat([
        _attend_chunk(q[:, i:i + q_chunk], q_positions[i:i + q_chunk], k, v,
                      kv_positions, **kw)
        for i in range(0, Sq, q_chunk)], dim=1)
