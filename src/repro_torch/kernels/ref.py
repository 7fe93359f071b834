"""Plain PyTorch versions of the kernels: the counterparts of
``repro.kernels.ref`` (``attention_ref`` .. ``paged_decode_attention_ref``,
``wkv6_ref``, ``wkv6_scan``), of the MoE functions of
``repro.kernels.moe_kernels`` (``moe_positions`` .. ``moe_scatter``) and
of ``repro.kernels.mamba_scan``'s ``mamba_scan_ref`` and
``mamba_scan_xla`` (:func:`mamba_scan_chunked`).

They are what a CPU tensor runs, what ``chip_smoke.py`` holds each CUDA
kernel against on the card, and what the kernels' backward passes
differentiate.  Softmax is taken in float32 over the whole row, with
masked scores at -1e30 as in the reference.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.scan import remat_time_scan
from repro_torch.core.sharding import run_local

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True):
    """q: (B, H, S, D); k/v: (B, KH, T, D) -> (B, H, S, D).  Causal masks
    key t for query s when t > s (both counted from 0)."""
    B, H, S, D = q.shape
    _, KH, T, _ = k.shape
    G = H // KH
    qg = q.reshape(B, KH, G, S, D).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) / math.sqrt(D)
    if causal:
        mask = (torch.arange(S, device=q.device)[:, None]
                >= torch.arange(T, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return o.reshape(B, H, S, D).to(q.dtype)


def normalize_kv_len(kv_len, batch: int, device=None) -> torch.Tensor:
    """A scalar broadcasts to ``(batch,)``; a ``(batch,)`` vector passes
    through; anything else raises (a silently broadcast wrong shape
    means wrong masking)."""
    kv_len = torch.as_tensor(kv_len, dtype=torch.int32, device=device)
    if kv_len.ndim == 0:
        return kv_len.expand(batch).contiguous()
    if tuple(kv_len.shape) == (batch,):
        return kv_len
    raise ValueError(
        f"decode_attention kv_len must be a scalar or a ({batch},) vector "
        f"matching the batch; got shape {tuple(kv_len.shape)}")


def check_mixed_kv_len(kv_len, B: int, T: int, device=None) -> torch.Tensor:
    """The mixed form's kv_len as (B, T) int32; any other shape raises."""
    kv_len = torch.as_tensor(kv_len, dtype=torch.int32, device=device)
    if tuple(kv_len.shape) != (B, T):
        raise ValueError(
            f"mixed decode kv_len must be ({B}, {T}) — one valid length "
            f"per (row, query token); got shape {tuple(kv_len.shape)}")
    return kv_len


def decode_attention_ref(q, k, v, kv_len):
    """q: (B, H, D); k/v: (B, KH, T, D); kv_len: scalar or (B,) — row b
    attends to positions < kv_len[b]."""
    B, H, D = q.shape
    _, KH, T, _ = k.shape
    G = H // KH
    kv_len = normalize_kv_len(kv_len, B, q.device)
    qg = q.reshape(B, KH, G, D).float()
    s = torch.einsum("bkgd,bktd->bkgt", qg, k.float()) / math.sqrt(D)
    valid = (torch.arange(T, device=q.device)[None, None, None, :]
             < kv_len[:, None, None, None])
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,bktd->bkgd", p, v.float())
    return o.reshape(B, H, D).to(q.dtype)


def mixed_decode_attention_ref(q, k, v, kv_len):
    """q: (B, H, T, D) with T query tokens per row; k/v: (B, KH, L, D);
    kv_len: (B, T) — query t of row b attends to positions
    < kv_len[b, t].  Rows past a slot's live tokens are finite garbage."""
    B, H, T, D = q.shape
    _, KH, Lk, _ = k.shape
    G = H // KH
    kv_len = check_mixed_kv_len(kv_len, B, T, q.device)
    qg = q.reshape(B, KH, G, T, D).float()
    s = torch.einsum("bkgtd,bkld->bkgtl", qg, k.float()) / math.sqrt(D)
    valid = (torch.arange(Lk, device=q.device)[None, None, :]
             < kv_len[:, :, None])                              # (B, T, L)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgtl,bkld->bkgtd", p, v.float())
    return o.reshape(B, H, T, D).to(q.dtype)


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, kv_len, *,
                               k_scale=None, v_scale=None):
    """Gather version of the paged decode kernel.

    q: (B, KH, G, D); k_pool/v_pool: (NB, block_size, KH, D);
    block_tables: (B, pages) int32 — logical page p of slot b lives in
    physical block ``block_tables[b, p]``; kv_len: scalar or (B,).
    With ``k_scale``/``v_scale`` ((NB, block_size, KH) f32) the pools are
    int8 and each gathered row is dequantized right after the gather.
    A 5-d q (B, KH, G, T, D) with kv_len (B, T) is the mixed-step form.
    """
    mixed = q.ndim == 5
    if mixed:
        B, KH, G, T, D = q.shape
    else:
        B, KH, G, D = q.shape
    bs = k_pool.shape[1]
    pages = block_tables.shape[1]
    bt = block_tables.long()

    def gather(pool, scale):
        g = pool[bt]                                  # (B, pages, bs, KH, D)
        if scale is not None:
            g = g.float() * scale[bt][..., None]
        return g.permute(0, 3, 1, 2, 4).reshape(B, KH, pages * bs, D)

    k, v = gather(k_pool, k_scale), gather(v_pool, v_scale)
    if mixed:
        out = mixed_decode_attention_ref(q.reshape(B, KH * G, T, D), k, v,
                                         kv_len)
        return out.reshape(B, KH, G, T, D)
    out = decode_attention_ref(q.reshape(B, KH * G, D), k, v, kv_len)
    return out.reshape(B, KH, G, D)


def _wkv6_step(uf):
    def step(S, xs):
        rt, kt, vt, wt = (a.float() for a in xs)              # (B, H, N)
        kv = kt[..., :, None] * vt[..., None, :]              # (B, H, N, N)
        o = torch.einsum("bhi,bhij->bhj", rt, S + uf[None, :, :, None] * kv)
        return wt[..., :, None] * S + kv, o
    return step


def wkv6_ref(r, k, v, w, u, state=None):
    """RWKV6 recurrence oracle in the model layout.

    r/k/v/w: (B, T, H, N); u: (H, N); state: (B, H, N, N) or None.
    Returns (out (B, T, H, N) float32, final state).

      out_t = r_t . (S + u * (k_t x v_t));  S <- diag(w_t) S + k_t x v_t
    """
    B, T, H, N = r.shape
    if state is None:
        state = torch.zeros(B, H, N, N, dtype=torch.float32, device=r.device)
    xs = tuple(a.transpose(0, 1) for a in (r, k, v, w))      # (T, B, H, N)
    S, out = remat_time_scan(_wkv6_step(u.float()), state, xs, chunk=T)
    return out.transpose(0, 1), S


def wkv6_scan(r, k, v, w, u, *, chunk: int = 64, initial_state=None,
              return_state: bool = False):
    """WKV6 recurrence in the kernel layout: r/k/v/w (B, H, T, N); u (H, N);
    state (B, H, N, N) float32.  The plain version of the CUDA kernel
    (``csrc/rwkv6_scan.cu``) and the function its backward differentiates.

    A Python time loop in float32, checkpointed per chunk of ``chunk``
    steps (:func:`repro_torch.core.scan.remat_time_scan`).  Returns out
    (B, H, T, N) in r's dtype, plus the final state when ``return_state``.
    """
    B, H, T, N = r.shape
    S0 = (initial_state if initial_state is not None
          else torch.zeros(B, H, N, N, dtype=torch.float32, device=r.device))
    tm = lambda a: a.permute(2, 0, 1, 3)                      # (T, B, H, N)
    Sn, out = remat_time_scan(_wkv6_step(u.float()), S0,
                              (tm(r), tm(k), tm(v), tm(w)), chunk=chunk)
    out = out.permute(1, 2, 0, 3).to(r.dtype)                 # (B, H, T, N)
    return (out, Sn) if return_state else out


def _mamba_step(A, Dskip):
    """The reference's ``_step``: A (di, N), Dskip (di,) float32; the
    (B, di, N) discretized terms are formed per step."""
    def step(h, xs):
        dt, Bm, Cm, x1 = (a.float() for a in xs)   # (B,di) (B,N) (B,N) (B,di)
        dtA = dt[..., None] * A                     # (B, di, N)
        h = torch.exp(dtA) * h + (dt * x1)[..., None] * Bm[:, None, :]
        y = torch.einsum("bdn,bn->bd", h, Cm) + Dskip * x1
        return h, y
    return step


def mamba_scan_ref(dt, Bm, Cm, x, A, D, *, chunk: int = 64,
                   initial_state=None, return_state: bool = False):
    """Selective scan: dt/x (B, S, di); Bm/Cm (B, S, N); A (di, N)
    (negative); D (di,); initial_state (B, di, N) float32 or None.  The
    plain version of the CUDA kernel (``csrc/mamba_scan.cu``) and the
    function its backward differentiates.

      h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t;  y_t = h_t . C_t + D * x_t

    A Python time loop on a float32 state, inputs widened to float32,
    checkpointed per chunk of ``chunk`` steps
    (:func:`repro_torch.core.scan.remat_time_scan`).  Returns y (B, S, di)
    in x's dtype, plus the final state when ``return_state``.
    """
    B, S, di = x.shape
    N = Bm.shape[-1]
    h0 = (initial_state.float() if initial_state is not None
          else torch.zeros(B, di, N, dtype=torch.float32, device=x.device))
    tm = lambda a: a.transpose(0, 1)                          # (S, B, ...)
    hN, y = remat_time_scan(_mamba_step(A.float(), D.float()), h0,
                            (tm(dt), tm(Bm), tm(Cm), tm(x)), chunk=chunk)
    y = y.transpose(0, 1).to(x.dtype)                         # (B, S, di)
    return (y, hN) if return_state else y


def _assoc_scan(a, b):
    """Inclusive scan along dim 1 of the pairs (a, b) under
    ``(a, b) . (a', b') = (a a', b a' + b')`` (earlier pair on the left),
    by doubling: log2 of the length steps."""
    d, n = 1, a.shape[1]
    while d < n:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], 1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], 1)
        d *= 2
    return a, b


def _mamba_chunk(A, Dskip):
    def body(h, dt, Bm, Cm, x):
        dt, Bm, Cm, x = (t.float() for t in (dt, Bm, Cm, x))   # (B, c, ...)
        a = torch.exp(dt[..., None] * A)                       # (B, c, di, N)
        b = (dt * x)[..., None] * Bm[:, :, None, :]            # (B, c, di, N)
        aa, bb = _assoc_scan(a, b)
        h_all = aa * h[:, None] + bb
        y = torch.einsum("bcdn,bcn->bcd", h_all, Cm) + Dskip * x
        return h_all[:, -1], y
    return body


def mamba_scan_chunked(dt, Bm, Cm, x, A, D, *, chunk: int = 64,
                       initial_state=None, return_state: bool = False):
    """The selective scan of :func:`mamba_scan_ref` as the reference's
    ``mamba_scan_xla`` computes it: a chunked associative scan, parallel
    within each chunk of ``chunk`` steps (log2 of it doubling steps over
    (B, chunk, di, N) terms) and carried across chunks, each chunk
    recomputed in the backward pass (``torch.utils.checkpoint``); an
    uneven tail runs as one short extra chunk.  Returns y (B, S, di) in
    x's dtype, plus the final state when ``return_state``."""
    B, S, di = x.shape
    N = Bm.shape[-1]
    h = (initial_state.float() if initial_state is not None
         else torch.zeros(B, di, N, dtype=torch.float32, device=x.device))
    body = _mamba_chunk(A.float(), D.float())
    chunk = min(chunk, S)
    ys = []
    for c0 in range(0, S, chunk):
        part = tuple(t[:, c0:c0 + chunk] for t in (dt, Bm, Cm, x))
        if torch.is_grad_enabled():
            h, y = checkpoint(body, h, *part, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            h, y = body(h, *part)
        ys.append(y)
    y = torch.cat(ys, 1).to(x.dtype)
    return (y, h) if return_state else y


# --------------------------------------------------------------------------- #
# MoE capacity dispatch (GShard): routing stays in the model; these own
# everything after it
# --------------------------------------------------------------------------- #
def moe_positions(expert_idx, E: int, C: int):
    """Per-group (batch-row) expert slot assignment.

    expert_idx: (B, S, K) -> (lin (B, S*K) int32, the flat buffer index
    ``e * C + position-in-expert`` with assignments past capacity mapped
    to the trash slot ``E * C``; keep (B, S*K) bool).  Assignments take
    slots in (token, k) order, as a one-hot cumsum.
    """
    B, S, K = expert_idx.shape
    flat = F.one_hot(expert_idx.long(), E).reshape(B, S * K, E)
    pos = torch.cumsum(flat, dim=1) - flat                     # (B, S*K, E)
    pos_in_expert = (pos * flat).sum(-1)                       # (B, S*K)
    eidx = expert_idx.reshape(B, S * K).long()
    keep = pos_in_expert < C
    lin = torch.where(keep, eidx * C + pos_in_expert,
                      torch.full_like(eidx, E * C))
    return lin.to(torch.int32), keep


def _no_constraint(a, dims):
    return a


def expert_ffn(buf, wi, wg, wo, constrain=_no_constraint):
    """buf: (B, E, C, D) -> (B, E, C, D), each expert's SwiGLU FFN;
    ``constrain(tensor, dims)`` lays out its hidden and its output (see
    :func:`moe_scatter`)."""
    h = torch.einsum("becd,edf->becf", buf, wi)
    g = torch.einsum("becd,edf->becf", buf, wg)
    h = constrain(F.silu(g) * h, ("batch", "expert", None, "d_ff"))
    out = torch.einsum("becf,efd->becd", h, wo)
    return constrain(out, ("batch", "expert", None, "d_model"))


def moe_scatter_ref(x, lin, n_slots: int):
    """Plain version of the scatter kernel.  x: (B, S, D); lin: (B, S, K)
    flat slot indices (``n_slots`` is the trash slot) -> buf (B, n_slots + 1,
    D) in x's dtype: row ``lin[b, s, k]`` holds x[b, s]; every other row,
    the trash row included, is zero.  Kept slots are unique."""
    B, S, D = x.shape
    K = lin.shape[-1]
    buf = torch.zeros(B, n_slots + 1, D, dtype=x.dtype, device=x.device)
    lin = lin.long().reshape(B, S * K)
    keep = lin < n_slots
    b_idx = torch.arange(B, device=x.device)[:, None].expand(B, S * K)
    src = x[:, :, None, :].expand(B, S, K, D).reshape(B, S * K, D)
    buf[b_idx[keep], lin[keep]] = src[keep]
    return buf


def moe_gather_ref(out, lin, gates):
    """Plain version of the gather kernel.  out: (B, n_slots, D) expert
    outputs; lin: (B, S, K); gates: (B, S, K) float32, zero for dropped
    assignments -> y (B, S, D) in out's dtype, ``y[b, s] = sum_k
    out[b, min(lin, n_slots - 1)] * gates`` in float32.  Terms whose gate
    is zero are skipped (never ``0 * out``), as in the kernel."""
    B, n_slots, D = out.shape
    S, K = lin.shape[1:]
    idx = torch.clamp(lin.long(), max=n_slots - 1).reshape(B, S * K)
    rows = torch.gather(out, 1, idx[..., None].expand(B, S * K, D))
    rows = rows.reshape(B, S, K, D).float() * gates[..., None]
    rows = torch.where(gates[..., None] != 0, rows, torch.zeros_like(rows))
    return rows.sum(2).to(out.dtype)


def moe_scatter(x, gate_vals, expert_idx, wi, wg, wo, *, capacity: int,
                scatter_rows=moe_scatter_ref, gather_rows=moe_gather_ref,
                constrain=None):
    """Scatter/gather dispatch, the counterpart of the reference's
    ``moe_scatter_xla`` and of its Pallas path: x (B, S, D); gate_vals /
    expert_idx (B, S, K); wi/wg (E, D, F); wo (E, F, D) -> y (B, S, D).
    Slot assignment, ``scatter_rows``, the expert FFN, ``gather_rows``
    (float32 accumulation); the CUDA route passes its two kernels for the
    plain versions.

    ``constrain(tensor, dims)`` is the layer's sharding callback, applied
    at the reference's points: the slot assignment and the scatter per
    batch row, the buffer then laid out by ``("batch", "expert", None,
    "d_model")`` for the expert FFN, and back to ``("batch", None,
    "d_model")`` for the gather.  Without it nothing is placed."""
    cs = constrain or _no_constraint
    B, S, D = x.shape
    E, K, C = wi.shape[0], expert_idx.shape[-1], capacity
    lin, keep = run_local(lambda e: moe_positions(e, E, C), [expert_idx],
                          [("batch", None, None)],
                          [("batch", None), ("batch", None)],
                          allowed=("batch",))
    lin = cs(lin, ("batch", None)).reshape(B, S, K)
    buf = cs(scatter_rows(x, lin, E * C), ("batch", None, "d_model"))
    buf = cs(buf[:, :-1].reshape(B, E, C, D),
             ("batch", "expert", None, "d_model"))
    out = expert_ffn(buf, wi, wg, wo, cs).reshape(B, E * C, D)
    out = cs(out, ("batch", None, "d_model"))
    gates = (keep.reshape(B, S, K) * gate_vals).float()
    return cs(gather_rows(out, lin, gates), ("batch", "seq", "d_model"))


def moe_dense_ref(x, gate_vals, expert_idx, wi, wg, wo, *, capacity: int):
    """Capacity-bucketed dense-einsum dispatch, the oracle (the reference's
    ``moe_dense_ref``): a one-hot (B, S, K, E*C) dispatch tensor
    contracted against x and, after the expert FFN, against the gates.
    Dropped assignments land in the trash column, which is sliced off.
    What the MoE kernels' backward pass differentiates."""
    B, S, D = x.shape
    E, K, C = wi.shape[0], expert_idx.shape[-1], capacity
    lin, _ = moe_positions(expert_idx, E, C)
    oh = F.one_hot(lin.long(), E * C + 1).to(x.dtype)[..., :-1]
    disp = oh.reshape(B, S, K, E * C)
    buf = torch.einsum("bse,bsd->bed", disp.sum(2), x).reshape(B, E, C, D)
    out = expert_ffn(buf, wi, wg, wo)
    comb = torch.einsum("bske,bsk->bse", disp, gate_vals.to(x.dtype))
    return torch.einsum("bse,bed->bsd", comb, out.reshape(B, E * C, D))
