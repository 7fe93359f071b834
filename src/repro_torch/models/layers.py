"""Model primitives of the dense decoder-only LM, in PyTorch: the
counterparts of ``repro.models.layers``.

Parameters are plain dicts of tensors in the reference's layouts
(``wq (d, H, hd)``, ``wo (H, hd, d)``, ...), so the bridge moves them
across unchanged.  Each function takes its sublayer's ``LayerConfig``
(replicated by default) and constrains its activations at the
reference's points (:func:`repro_torch.core.sharding.constrain`, the
identity without an active mesh).

Cache updates happen in place: where the reference returns a new cache
and relies on jit donation to reuse the buffer, these functions write
into the cache tensors they were given and return the same dict.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.config import LayerConfig
from repro_torch.core.sharding import (constrain, contract, is_dtensor,
                                       run_local, unflatten)
from repro_torch.kernels import ops
from repro_torch.kernels.quant import quantize_kv

R = LayerConfig.REPLICATED
_BSHD = ("batch", "seq", "heads", None)
_BSD = ("batch", "seq", "d_model")


# --------------------------------------------------------------------------- #
# init helpers
# --------------------------------------------------------------------------- #
def dense_init(shape, dtype, *, fan_in: int, generator, device):
    std = 1.0 / math.sqrt(fan_in)
    return (torch.randn(shape, generator=generator, device=device)
            * std).to(dtype)


def embed_init(shape, dtype, *, generator, device):
    return (torch.randn(shape, generator=generator, device=device)
            * 0.02).to(dtype)


# --------------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------------- #
def rms_norm(x, scale, eps: float = 1e-6):
    """RMS norm in float32, scaled by ``1 + scale`` (zero-init scales)."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * (1.0 + scale.float())
    return y.to(dt)


def init_norm(arch, dtype, *, lead=(), device=None):
    if arch.nonparam_norm:
        return {}
    return {"scale": torch.zeros((*lead, arch.d_model), dtype=dtype,
                                 device=device)}


def apply_norm(p: dict, x):
    return rms_norm(x, p.get("scale"))


# --------------------------------------------------------------------------- #
# rotary embeddings
# --------------------------------------------------------------------------- #
def rope(x, positions, theta: float):
    """x: (..., S, H, D) with D even; positions: (..., S).  Rotates the
    two halves of the head dim (not interleaved pairs)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = positions[..., :, None].float() * freqs        # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                   # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------------- #
def init_attention(arch, dtype, *, generator, device, lead=()):
    d, hd, H, KH = arch.d_model, arch.hd, arch.n_heads, arch.n_kv_heads
    kw = dict(generator=generator, device=device)
    p = {
        "wq": dense_init((*lead, d, H, hd), dtype, fan_in=d, **kw),
        "wk": dense_init((*lead, d, KH, hd), dtype, fan_in=d, **kw),
        "wv": dense_init((*lead, d, KH, hd), dtype, fan_in=d, **kw),
        "wo": dense_init((*lead, H, hd, d), dtype, fan_in=H * hd, **kw),
    }
    zeros = lambda *s: torch.zeros((*lead, *s), dtype=dtype, device=device)
    if arch.qkv_bias:
        p["bq"], p["bk"], p["bv"] = zeros(H, hd), zeros(KH, hd), zeros(KH, hd)
    if arch.qk_norm:
        p["q_norm"], p["k_norm"] = zeros(hd), zeros(hd)
    return p


def _proj(x, w):
    """(B, S, d) x (d, H, hd) -> (B, S, H, hd)."""
    return contract(x, w)


def _scatter_rows(pool, phys, rows):
    """In place: ``pool`` (NB, bs, ...) viewed as token rows gets
    ``rows`` at flat token slots ``phys``.  A realized pool (a DTensor,
    blocks whole, heads maybe split) is written on its local shard, with
    ``rows`` gathered over batch and split as the pool's heads are."""
    if is_dtensor(pool):
        # payload (NB, bs, KH, hd) or int8 scales (NB, bs, KH)
        heads = ("heads", None) if pool.ndim == 4 else ("heads",)
        run_local(lambda p_, r_: _scatter_rows(p_, phys, r_), [pool, rows],
                  [(None, None) + heads,
                   (None,) * (rows.ndim - len(heads)) + heads], None,
                  allowed=("heads",), inplace=(0,))
        return
    NB, bs = pool.shape[:2]
    pool.view(NB * bs, *pool.shape[2:])[phys] = rows


def attention(p: dict, x, arch, cfg: LayerConfig = R, *, positions,
              causal: bool = True, kv_cache: dict | None = None,
              cache_pos=None, block_tables=None, q_lens=None,
              kv_override=None, use_rope: bool = True):
    """GQA attention block (qkv projection + core).

    Four forms through the kernels, as in the reference:

    * no cache, or a prefill (scalar ``cache_pos == 0``, S > 1) into a
      dense cache row: self-attention through ``flash_attention``, causal
      or (an encoder's, without a cache) full;
    * dense single-token decode: ``kv_cache`` leaves are per-slot rows
      (B, max_len, KH, hd); row b's token is written at ``cache_pos[b]``
      (or at the scalar ``cache_pos`` for every row) and attended through
      ``decode_attention`` over positions < ``positions[..., -1] + 1``;
    * paged single-token decode: ``kv_cache`` leaves are a block pool
      (NB, block_size, KH, hd), ``block_tables`` (B, pages) maps row b's
      logical pages to pool blocks, ``cache_pos`` is (B,).  The new token
      is written (quantized for an int8 pool) and attended through
      ``paged_decode_attention``;
    * the mixed step (``q_lens`` given, S > 1): row b's first
      ``q_lens[b]`` tokens are live at positions ``cache_pos[b] + t``;
      padding writes are dropped (dense) or parked in the trash block 0
      (paged).

    Two forms go through the positions-aware chunked core
    (:func:`~repro_torch.kernels.mha_chunked.mha_chunked`), as in the
    reference: cross-attention, where ``kv_override=(k, v, kv_positions)``
    gives K and V (no projection, bias, norm or rope on them; q gets rope
    only with ``use_rope``); and a dense cache continued mid-sequence
    (scalar ``cache_pos`` other than the literal 0, S > 1), whose S rows
    are written at ``cache_pos`` and attend causally over the whole row.
    ``cfg`` (the plan's ``attn`` config) lays q, k, v and the output out
    by ``("batch", "seq", "heads", None)``.  On a realized plan a dense
    cache (DTensor rows) is written and attended on its local shards
    (:func:`_dense_cache_local`); a paged pool is written on its shard by
    :func:`_scatter_rows` and attended through the ops' shard-local path.
    Returns (out (B, S, H, hd), cache).
    """
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if kv_override is None:
        k = _proj(x, p["wk"])
        v = _proj(x, p["wv"])
        if "bk" in p:
            k, v = k + p["bk"], v + p["bv"]
        if "k_norm" in p:
            k = rms_norm(k, p["k_norm"])
        if use_rope:
            k = rope(k, positions, arch.rope_theta)
    else:
        k, v, kv_positions = kv_override
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
    if use_rope:
        q = rope(q, positions, arch.rope_theta)
    q = constrain(q, cfg, _BSHD)
    if kv_override is not None:
        o = ops.chunked_attention(q, k, v, causal=causal,
                                  q_positions=positions,
                                  kv_positions=kv_positions)
        return constrain(o, cfg, _BSHD), kv_cache
    k, v = constrain(k, cfg, _BSHD), constrain(v, cfg, _BSHD)
    kw = dict(positions=positions, causal=causal, kv_cache=kv_cache,
              cache_pos=cache_pos, block_tables=block_tables, q_lens=q_lens)
    if (kv_cache is not None and block_tables is None
            and (is_dtensor(kv_cache["k"]) or is_dtensor(q))):
        o = _dense_cache_local(q, k, v, **kw)
    else:
        o = _attend(q, k, v, **kw)
    return constrain(o, cfg, _BSHD), kv_cache


def _dense_cache_local(q, k, v, *, kv_cache, positions, cache_pos, q_lens,
                       **kw):
    """:func:`_attend` over a dense cache on a realized plan: the layout
    follows the cache's K leaf (its batch and heads placements; a plain
    cache is whole on every rank), so every write lands in the cache's
    own local shard; q, k, v and the per-row metadata are brought to that
    layout first."""
    names = sorted(kv_cache)
    cache_r = act_r = ("batch", None, "heads", None)

    def row_r(t):
        """Per-row metadata splits with the batch; positions shared by
        every row, scalars and ints pass whole."""
        if not torch.is_tensor(t) or t.ndim == 0:
            return None
        return ("batch",) + (None,) * (t.ndim - 1) if (
            t.ndim == 2 or t is not positions) else (None,)

    def local(ql, kl, vl, pos, cp, ql_lens, *leaves):
        cache = dict(zip(names, leaves))
        return _attend(ql, kl, vl, kv_cache=cache, positions=pos,
                       cache_pos=cp, q_lens=ql_lens, **kw)
    args = [kv_cache[n] for n in names]
    return run_local(
        local, [q, k, v, positions, cache_pos, q_lens] + args,
        [act_r, act_r, act_r, row_r(positions), row_r(cache_pos),
         row_r(q_lens)] + [cache_r] * len(args),
        act_r, lead=6 + names.index("k"), allowed=("batch", "heads"),
        inplace=range(6, 6 + len(args)))


def _attend(q, k, v, *, positions, causal, kv_cache, cache_pos,
            block_tables, q_lens):
    """The attention core after the projections: q (B, S, H, hd), k/v
    (B, S, KH, hd) -> (B, S, H, hd), writing ``kv_cache`` in place (see
    :func:`attention`)."""
    B, S, H, hd = q.shape
    KH = k.shape[2]
    G = H // KH
    per_slot = torch.is_tensor(cache_pos) and cache_pos.ndim == 1

    if kv_cache is not None and q_lens is not None and S > 1:
        if not per_slot:
            raise ValueError(
                "mixed-step attention requires per-slot (B,) cache_pos; "
                f"got {getattr(cache_pos, 'shape', cache_pos)}")
        q_lens = q_lens.to(torch.int32)
        ck, cv = kv_cache["k"], kv_cache["v"]
        t_ar = torch.arange(S, device=q.device)
        valid = t_ar[None, :] < q_lens[:, None]                   # (B, S)
        idx = cache_pos[:, None] + t_ar[None, :]                  # (B, S)
        kv_len = cache_pos[:, None] + torch.minimum(t_ar + 1, q_lens[:, None])
        kd, vd = k.to(ck.dtype), v.to(cv.dtype)
        cks = cvs = None
        if block_tables is not None:
            bs = ck.shape[1]
            pages = block_tables.shape[1]
            # clamp for the table gather only; invalid writes go to the
            # trash block 0 (clamping the physical slot could hit a live
            # block)
            idxc = torch.clamp(idx, max=pages * bs - 1).long()
            blk = torch.gather(block_tables.long(), 1, idxc // bs)
            phys = torch.where(valid, blk * bs + idxc % bs,
                               torch.zeros_like(blk))             # (B, S)
            cks, cvs = kv_cache.get("k_scale"), kv_cache.get("v_scale")
            if cks is not None:
                kd, ks = quantize_kv(k)
                vd, vs = quantize_kv(v)
                _scatter_rows(cks, phys, ks)
                _scatter_rows(cvs, phys, vs)
            _scatter_rows(ck, phys, kd)
            _scatter_rows(cv, phys, vd)
        else:
            rows = torch.arange(B, device=q.device)[:, None].expand(B, S)
            ck[rows[valid], idx[valid].long()] = kd[valid]
            cv[rows[valid], idx[valid].long()] = vd[valid]
        qg = unflatten(q.transpose(1, 2), 1, (KH, G))
        if block_tables is not None:
            o = ops.paged_decode_attention(qg, ck, cv, block_tables, kv_len,
                                           k_scale=cks, v_scale=cvs)
        else:
            o = ops.decode_attention(qg, ck.transpose(1, 2),
                                     cv.transpose(1, 2), kv_len)
        return o.reshape(B, H, S, hd).transpose(1, 2)

    if kv_cache is not None and block_tables is not None:
        if S != 1:
            raise ValueError(
                f"paged attention requires single-token decode (got S={S})")
        if not per_slot:
            raise ValueError(
                "paged attention requires per-slot (B,) cache_pos; got "
                f"{getattr(cache_pos, 'shape', cache_pos)}")
        ck, cv = kv_cache["k"], kv_cache["v"]
        bs = ck.shape[1]
        cp = cache_pos.long()
        phys = (block_tables.long()[torch.arange(B, device=q.device), cp // bs]
                * bs + cp % bs)                                   # (B,)
        if q_lens is not None:
            # a row that advances no token parks its write in the trash
            # block: a slot waiting to prefill can sit inside a prefix
            # block it shares, where the write would clobber a live token
            # (the reference writes every row here; see ROADMAP.md, C)
            phys = torch.where(q_lens > 0, phys, torch.zeros_like(phys))
        cks, cvs = kv_cache.get("k_scale"), kv_cache.get("v_scale")
        if cks is not None:
            kd, ks = quantize_kv(k[:, 0])                         # (B, KH, hd)
            vd, vs = quantize_kv(v[:, 0])
            _scatter_rows(cks, phys, ks)
            _scatter_rows(cvs, phys, vs)
        else:
            kd, vd = k[:, 0].to(ck.dtype), v[:, 0].to(cv.dtype)
        _scatter_rows(ck, phys, kd)
        _scatter_rows(cv, phys, vd)
        qg = unflatten(q[:, 0], 1, (KH, G)).contiguous()
        o = ops.paged_decode_attention(qg, ck, cv, block_tables,
                                       positions[..., -1] + 1,
                                       k_scale=cks, v_scale=cvs)
        return o.reshape(B, 1, H, hd)

    if kv_cache is not None and S == 1:
        # dense decode; the reference writes every row here, q_lens or not
        # (a row that advances no token writes its own slot's row, at a
        # position its next real write overwrites)
        ck, cv = kv_cache["k"], kv_cache["v"]
        if per_slot:
            rows = torch.arange(B, device=q.device)
            ck[rows, cache_pos.long()] = k[:, 0].to(ck.dtype)
            cv[rows, cache_pos.long()] = v[:, 0].to(cv.dtype)
        elif torch.is_tensor(cache_pos):
            # one position for every row, read on the device (indexing by
            # the 0-d tensor would read it on the host)
            at = cache_pos.long().reshape(1)
            ck.index_copy_(1, at, k[:, :1].to(ck.dtype))
            cv.index_copy_(1, at, v[:, :1].to(cv.dtype))
        else:
            ck[:, cache_pos] = k[:, 0].to(ck.dtype)
            cv[:, cache_pos] = v[:, 0].to(cv.dtype)
        o = ops.decode_attention(unflatten(q[:, 0], 1, (KH, G)).contiguous(),
                                 ck.transpose(1, 2),
                                 cv.transpose(1, 2), positions[..., -1] + 1)
        return o.reshape(B, 1, H, hd)

    if kv_cache is not None:
        if per_slot:
            raise ValueError(
                "per-slot cache_pos requires single-token decode "
                f"(got S={S})")
        ck, cv = kv_cache["k"], kv_cache["v"]
        if not (isinstance(cache_pos, int) and cache_pos == 0):
            # mid-sequence: query row i sits at cache_pos + i, which the
            # blocked kernels' 0-based causal mask cannot express
            cp = int(cache_pos)
            ck[:, cp:cp + S] = k.to(ck.dtype)
            cv[:, cp:cp + S] = v.to(cv.dtype)
            return ops.chunked_attention(
                q, ck, cv, causal=True, q_positions=positions,
                kv_positions=torch.arange(ck.shape[1], device=q.device))
        ck[:, :S] = k.to(ck.dtype)
        cv[:, :S] = v.to(cv.dtype)
        k, v = ck, cv
        causal = True
    o = ops.flash_attention(q.transpose(1, 2).contiguous(),
                            k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(),
                            causal=causal)
    return o.transpose(1, 2)


def attention_out(p: dict, attn, cfg: LayerConfig = R):
    """o-proj: (B, S, H, hd) -> (B, S, d_model); ``cfg`` lays out
    (batch, seq, d_model)."""
    return constrain(contract(attn, p["wo"], 2), cfg, _BSD)


# --------------------------------------------------------------------------- #
# dense SwiGLU MLP
# --------------------------------------------------------------------------- #
def init_mlp(arch, dtype, *, generator, device, lead=()):
    d, f = arch.d_model, arch.d_ff
    kw = dict(generator=generator, device=device)
    return {
        "wi": dense_init((*lead, d, f), dtype, fan_in=d, **kw),
        "wg": dense_init((*lead, d, f), dtype, fan_in=d, **kw),
        "wo": dense_init((*lead, f, d), dtype, fan_in=f, **kw),
    }


def mlp(p: dict, x, cfg_in: LayerConfig = R, cfg_out: LayerConfig = R):
    h = contract(x, p["wi"])
    g = contract(x, p["wg"])
    h = constrain(F.silu(g) * h, cfg_in, ("batch", "seq", "d_ff"))
    return constrain(contract(h, p["wo"]), cfg_out, _BSD)


# --------------------------------------------------------------------------- #
# embedding / head
# --------------------------------------------------------------------------- #
def init_embed(arch, dtype, *, generator, device):
    return {"table": embed_init((arch.vocab, arch.d_model), dtype,
                                generator=generator, device=device)}


def embed(p: dict, tokens, cfg: LayerConfig = R):
    """The table's rows of ``tokens``; on a realized plan looked up on each
    shard's table columns with every token (DTensor's backward of an index
    into a split table is unreliable), then laid out by ``cfg``."""
    rows = run_local(lambda t, i: t[i], [p["table"], tokens],
                     [(None, "d_model"), (None,) * tokens.ndim],
                     (None,) * tokens.ndim + ("d_model",),
                     allowed=("d_model",))
    return constrain(rows, cfg, _BSD)


def init_lm_head(arch, dtype, *, generator, device):
    if arch.tie_embeddings:
        return {}
    return {"w": dense_init((arch.d_model, arch.vocab), dtype,
                            fan_in=arch.d_model, generator=generator,
                            device=device)}


def lm_head(p: dict, x, embed_p: dict, arch, cfg: LayerConfig = R):
    w = embed_p["table"].T if arch.tie_embeddings else p["w"]
    return constrain(contract(x, w), cfg, ("batch", "seq", "vocab"))
