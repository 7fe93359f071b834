"""Depth-proportional mixed-step attention in plain PyTorch: the
counterparts of ``repro.kernels.mha_xla.paged_mixed_attention_xla`` and
``mixed_decode_attention_xla``.

The engine's prefill-chunk pass attends a T-token chunk (the 5-d q
``(B, KH, G, T, D)``, ``kv_len (B, T)``) over the KV written so far.  In
the reference that pass is XLA on every platform — the paged kernel takes
single-token q only — so its port is plain torch too.  Like the
reference it streams KV blocks with an online softmax only up to
``max(kv_len)``, so the work is proportional to the deepest live slot and
not to the padded table.  Folding this form into the paged CUDA kernel
is queued in ROADMAP.md.
"""

from __future__ import annotations

import math

import torch

from .ref import NEG_INF, check_mixed_kv_len


def _online_step(qf, kb, vb, pos, kv_len, m, l, acc, eq_s, eq_o):
    """One streamed block: scores, mask, running (m, l, acc) update."""
    s = torch.einsum(eq_s, qf, kb)                      # (B, KH, G, T, blk)
    valid = pos[None, None, :] < kv_len[:, :, None]     # (B, T, blk)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    mn = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - mn[..., None])
    alpha = torch.exp(m - mn)
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum(eq_o, p, vb)
    return mn, l, acc


def _init_state(B, KH, G, T, D, device):
    m = torch.full((B, KH, G, T), NEG_INF, dtype=torch.float32, device=device)
    l = torch.zeros((B, KH, G, T), dtype=torch.float32, device=device)
    acc = torch.zeros((B, KH, G, T, D), dtype=torch.float32, device=device)
    return m, l, acc


def paged_mixed_attention(q, k_pool, v_pool, block_tables, kv_len, *,
                          k_scale=None, v_scale=None):
    """q: (B, KH, G, T, D); k/v_pool: (NB, block_size, KH, D);
    block_tables: (B, pages); kv_len: (B, T).  Streams each slot's logical
    pages in order up to the deepest live slot; int8 pools (with
    ``k_scale``/``v_scale`` (NB, block_size, KH) f32) dequantize each
    block as it is read."""
    B, KH, G, T, D = q.shape
    bs = k_pool.shape[1]
    pages = block_tables.shape[1]
    kv_len = check_mixed_kv_len(kv_len, B, T, q.device)
    bt = block_tables.long()
    qf = q.float() / math.sqrt(D)
    nb = min(-(-int(kv_len.max()) // bs), pages)
    m, l, acc = _init_state(B, KH, G, T, D, q.device)
    ar = torch.arange(bs, device=q.device)
    for i in range(nb):
        ids = bt[:, i]                                  # (B,)
        kb = k_pool[ids].float()                        # (B, bs, KH, D)
        vb = v_pool[ids].float()
        if k_scale is not None:
            kb = kb * k_scale[ids][..., None]
            vb = vb * v_scale[ids][..., None]
        m, l, acc = _online_step(qf, kb, vb, i * bs + ar, kv_len, m, l, acc,
                                 "bkgtd,blkd->bkgtl", "bkgtl,blkd->bkgtd")
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def mixed_decode_attention(q, k, v, kv_len, *, block_k=None):
    """Dense-cache form: q (B, KH, G, T, D); k/v (B, KH, L, D);
    kv_len (B, T)."""
    B, KH, G, T, D = q.shape
    L = k.shape[2]
    kv_len = check_mixed_kv_len(kv_len, B, T, q.device)
    blk = min(int(block_k) if block_k else 128, L)
    qf = q.float() / math.sqrt(D)
    nb = min(-(-int(kv_len.max()) // blk), -(-L // blk))
    m, l, acc = _init_state(B, KH, G, T, D, q.device)
    for i in range(nb):
        kb = k[:, :, i * blk:(i + 1) * blk].float()
        vb = v[:, :, i * blk:(i + 1) * blk].float()
        pos = i * blk + torch.arange(kb.shape[2], device=q.device)
        m, l, acc = _online_step(qf, kb, vb, pos, kv_len, m, l, acc,
                                 "bkgtd,bkld->bkgtl", "bkgtl,bkld->bkgtd")
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
