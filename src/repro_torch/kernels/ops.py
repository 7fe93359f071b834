"""Kernel entry points with the op names and signatures of
``repro.kernels.ops``, routed through the dispatcher
(:mod:`repro_torch.kernels.dispatch`), and the registrations of every
op's backends: ``cuda`` (the hand-written kernel), ``xla`` and ``ref``
(plain PyTorch).  Each op takes the reference's ``backend=``.

With no backend named, a CUDA tensor goes to the hand-written kernel for
every call form it covers, or the call raises on a shape the kernel does
not take (a wrong dtype, device or layout too): nothing falls back from
the kernel to a plain version on the card.  A CPU tensor goes to the
plain versions, chosen as the reference chooses among its non-Pallas
impls.  ``supports_<op>`` says, as a pure function of shapes, what each
kernel takes, so that a caller can refuse a model before it is built
(:func:`repro_torch.launch.train.require_kernel_shapes`).  Where autograd
records a gradient, a CUDA call goes through the kernel's
``autograd.Function`` (forward the kernel, backward the gradient of the
plain version), so no caller gets an output detached from its inputs.

The mixed-step forms of the dense and paged decode ops (5-d q, one
kv_len per query token) and the carried-state WKV6 have no kernel, as
they have none in the reference: they run plain torch on every device
(:mod:`repro_torch.kernels.mha_stream`, :func:`ref.wkv6_scan`).

On a realized plan (DTensor inputs) every op runs on local shards
(:func:`repro_torch.core.sharding.run_local`), and dispatches there:
attention and WKV6 over
batch and heads, the selective scan over batch and channels, the MoE
scatter and gather over batch, the expert FFN between them on the
expert shards (:func:`moe_dispatch_combine`).  An input
split on any other dim is first gathered to such a layout, as GSPMD does
around a custom call; on the card the shard then launches its kernel or
raises, and launches count per rank.  Where a GQA layer's KV heads do not
divide the heads' degree, K/V stay whole and each shard takes the KV
heads of its query heads' global indices
(:func:`~repro_torch.core.sharding.kv_heads_for`).
"""

from __future__ import annotations

import torch

from repro_torch.core.sharding import is_dtensor, kv_heads_for, run_local

from . import decode_attention as _decode
from . import dispatch
from . import flash_attention as _flash
from . import mamba_scan as _mamba
from . import mha_stream
from . import moe_dispatch as _moe
from . import paged_decode_attention as _paged
from . import ref
from . import rwkv6_scan as _wkv6
from .dispatch import register
from .mha_chunked import mha_chunked

_COUNTERS = (_flash.launches, _decode.launches, _paged.launches,
             _moe.launches, _wkv6.launches, _mamba.launches)


def launch_counts() -> dict[str, int]:
    """Launches of every kernel since the last :func:`reset_launch_counts`."""
    out: dict[str, int] = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = 0


# what each CUDA wrapper takes: pure functions of shapes, one per op whose
# kernel has shape limits (the MoE kernels take any shape)
supports_flash_attention = _flash.supports
supports_decode_attention = _decode.supports
supports_paged_decode_attention = _paged.supports
supports_wkv6 = _wkv6.supports
supports_mamba_scan = _mamba.supports


# each dim's role on a realized plan (see run_local)
_BHSD = ("batch", "heads", None, None)
_KV = ("batch", "kv_heads", None, None)
_POOL = (None, None, "heads", None)
_SCALE = (None, None, "heads")


def _dist(*ts) -> bool:
    return any(is_dtensor(t) for t in ts)


def flash_attention(q, k, v, *, causal: bool = True, block_q=None,
                    block_k=None, backend: str | None = None):
    """q: (B, H, S, D); k/v: (B, KH, T, D) -> (B, H, S, D).  ``block_q`` /
    ``block_k`` size the ``xla`` backend's chunks; the CUDA kernel's tiles
    are compiled in."""
    if _dist(q, k, v):
        G = q.shape[1] // k.shape[1]

        def local(off, ql, kl, vl):
            kl, _ = kv_heads_for(kl, off, ql.shape[1], G, 1)
            vl, _ = kv_heads_for(vl, off, ql.shape[1], G, 1)
            return flash_attention(ql.contiguous(), kl.contiguous(),
                                   vl.contiguous(), causal=causal,
                                   block_q=block_q, block_k=block_k,
                                   backend=backend)
        return run_local(local, [q, k, v], [_BHSD, _KV, _KV], _BHSD)
    return dispatch.call("flash_attention", q, k, v, causal=causal,
                         block_q=block_q, block_k=block_k, backend=backend)


def decode_attention(q, k, v, kv_len, *, block_k=None,
                     backend: str | None = None):
    """Dense-cache decode.  q: (B, KH, G, D); k/v: (B, KH, T, D) (any
    strides with the head dim contiguous) -> (B, KH, G, D); kv_len:
    scalar or (B,).  ``block_k`` sizes the ``xla`` backend's blocks (the
    CUDA kernel's range per CTA comes from the autotune cache).  The
    mixed-step form (q (B, KH, G, T, D), kv_len (B, T)) has no kernel."""
    if _dist(q, k, v):
        if q.ndim == 5:
            return run_local(
                lambda *a: decode_attention(*a, block_k=block_k,
                                            backend=backend),
                [q, k, v, kv_len],
                [_BHSD + (None,), _BHSD, _BHSD, ("batch", None)],
                _BHSD + (None,))
        kv_len = ref.normalize_kv_len(kv_len, q.shape[0], q.device)
        return run_local(
            lambda *a: decode_attention(*a, block_k=block_k,
                                        backend=backend),
            [q, k, v, kv_len], [_BHSD, _BHSD, _BHSD, ("batch",)], _BHSD)
    return dispatch.call("decode_attention", q, k, v, kv_len,
                         block_k=block_k, backend=backend)


def _check_scales(k_pool, k_scale, v_scale) -> None:
    if (k_scale is None) != (v_scale is None):
        raise ValueError(
            "paged_decode_attention: k_scale and v_scale must be passed "
            "together (one without the other would run fp attention on "
            "int8 payload)")
    if k_scale is not None:
        want = tuple(k_pool.shape[:3])
        got = (tuple(k_scale.shape), tuple(v_scale.shape))
        if got != (want, want):
            raise ValueError(
                f"paged_decode_attention: scale shapes {got} do not match "
                f"the pool's (NB, block_size, KH) = {want}")


def paged_decode_attention(q, k_pool, v_pool, block_tables, kv_len, *,
                           k_scale=None, v_scale=None,
                           backend: str | None = None):
    """q: (B, KH, G, D); k_pool/v_pool: (NB, block_size, KH, D);
    block_tables: (B, pages) int32 -> (B, KH, G, D).  kv_len: scalar or
    (B,).  With ``k_scale``/``v_scale`` ((NB, block_size, KH) f32) the
    pools are int8.  A 5-d q (B, KH, G, T, D) with kv_len (B, T) is the
    mixed-step form, which has no kernel."""
    _check_scales(k_pool, k_scale, v_scale)
    if _dist(q, k_pool, v_pool):
        lead = _BHSD + ((None,) if q.ndim == 5 else ())
        kvl = ("batch", None) if q.ndim == 5 else ("batch",)
        if q.ndim == 4:
            kv_len = ref.normalize_kv_len(kv_len, q.shape[0], q.device)
        scales = None if k_scale is None else _SCALE
        return run_local(
            lambda q_, kp, vp, bt, kl, ks, vs: paged_decode_attention(
                q_, kp, vp, bt, kl, k_scale=ks, v_scale=vs, backend=backend),
            [q, k_pool, v_pool, block_tables, kv_len, k_scale, v_scale],
            [lead, _POOL, _POOL, ("batch", None), kvl, scales, scales], lead)
    return dispatch.call("paged_decode_attention", q, k_pool, v_pool,
                         block_tables, kv_len, k_scale=k_scale,
                         v_scale=v_scale, backend=backend)


_TOKENS = ("batch", None, "d_model")


def _scatter_local(fn):
    """``fn`` (a scatter of (x, lin, n_slots)) on each shard's batch rows
    (and model columns)."""
    return lambda x, lin, n_slots: run_local(
        lambda x_, l_: fn(x_, l_, n_slots), [x, lin],
        [_TOKENS, ("batch", None, None)], _TOKENS,
        allowed=("batch", "d_model"))


def _gather_local(fn):
    """``fn`` (a gather of (out, lin, gates)) on each shard's batch rows
    (and model columns)."""
    return lambda out, lin, gates: run_local(
        fn, [out, lin, gates],
        [_TOKENS, ("batch", None, None), ("batch", None, None)], _TOKENS,
        allowed=("batch", "d_model"))


def moe_dispatch_combine(x, gate_vals, expert_idx, wi, wg, wo, *,
                         capacity: int, constrain=None,
                         backend: str | None = None):
    """MoE dispatch + expert FFN + combine; x: (B, S, D); gate_vals /
    expert_idx: (B, S, K); wi/wg: (E, D, F); wo: (E, F, D) -> y (B, S, D).
    GShard capacity per batch row; assignments past ``capacity`` are
    dropped.  The ``cuda`` backend is the plain op
    :func:`repro_torch.kernels.ref.moe_scatter` with the scatter and
    gather kernels in place of their plain versions (each through its
    autograd Function), ``xla`` that op with its plain versions, ``ref``
    the dense one-hot oracle; the expert FFN is torch on every backend.

    ``constrain(tensor, dims)`` applies the layer's sharding constraints
    at the reference's points: on a realized plan (DTensor ``x``) the
    scatter and the gather run shard-local over batch with all E slots
    local, while the expert FFN runs as DTensor einsums on the expert
    shards the constraints lay out (expert parallelism)."""
    return dispatch.call("moe_dispatch_combine", x, gate_vals, expert_idx,
                         wi, wg, wo, capacity=capacity, constrain=constrain,
                         backend=backend)


def chunked_attention(q, k, v, *, causal: bool, q_positions, kv_positions):
    """The positions-aware chunked core
    (:func:`~repro_torch.kernels.mha_chunked.mha_chunked`) over GQA K/V:
    q (B, Sq, H, D); k/v (B, Skv, KH, D), repeated over each KV head's
    query heads.  Plain torch on every device (XLA in the reference)."""
    G = q.shape[2] // k.shape[2]

    def local(off, ql, kl, vl, qp, kp):
        kl, g = kv_heads_for(kl, off, ql.shape[2], G, 2)
        vl, _ = kv_heads_for(vl, off, ql.shape[2], G, 2)
        if g > 1:
            kl = kl.repeat_interleave(g, dim=2)
            vl = vl.repeat_interleave(g, dim=2)
        return mha_chunked(ql, kl, vl, causal=causal, q_positions=qp,
                           kv_positions=kp)
    q_r = ("batch", None, "heads", None)
    kv_r = ("batch", None, "kv_heads", None)
    pos_r = lambda p: ("batch", None) if p.ndim == 2 else (None,)
    return run_local(local, [q, k, v, q_positions, kv_positions],
                     [q_r, kv_r, kv_r, pos_r(q_positions),
                      pos_r(kv_positions)], q_r)


def wkv6(r, k, v, w, u, *, chunk: int = 64, initial_state=None,
         return_state: bool = False, backend: str | None = None):
    """RWKV6 recurrence; r/k/v/w: (B, H, T, N); u: (H, N).  Returns out,
    plus the final (B, H, N, N) float32 state when ``return_state``.  The
    kernel takes the stateless form only (as the reference's does); the
    carried-state form has no kernel."""
    if _dist(r, k, v, w):
        stateful = initial_state is not None or return_state
        return run_local(
            lambda *a: wkv6(*a[:5], chunk=chunk, initial_state=a[5],
                            return_state=return_state, backend=backend),
            [r, k, v, w, u, initial_state],
            [_BHSD] * 4 + [("heads", None),
                           _BHSD if initial_state is not None else None],
            [_BHSD, _BHSD] if stateful and return_state else _BHSD)
    return dispatch.call("wkv6", r, k, v, w, u, chunk=chunk,
                         initial_state=initial_state,
                         return_state=return_state, backend=backend)


def mamba_scan(dt, Bm, Cm, x, A, D, *, chunk: int = 64, initial_state=None,
               return_state: bool = False, backend: str | None = None):
    """Selective-scan recurrence; dt/x: (B, S, di); Bm/Cm: (B, S, N); A:
    (di, N); D: (di,).  Returns y, plus the final (B, di, N) float32 state
    when ``return_state``.  The kernel takes every form (stateless, an
    initial state in, the final state out)."""
    if _dist(dt, x):
        t_r = ("batch", None, "chan")
        s_r = ("batch", "chan", None)
        return run_local(
            lambda *a: mamba_scan(*a[:6], chunk=chunk, initial_state=a[6],
                                  return_state=return_state,
                                  backend=backend),
            [dt, Bm, Cm, x, A, D, initial_state],
            [t_r, ("batch", None, None), ("batch", None, None), t_r,
             ("chan", None), ("chan",),
             s_r if initial_state is not None else None],
            [t_r, s_r] if return_state else t_r,
            allowed=("batch", "chan"), lead=3)
    return dispatch.call("mamba_scan", dt, Bm, Cm, x, A, D, chunk=chunk,
                         initial_state=initial_state,
                         return_state=return_state, backend=backend)


# --------------------------------------------------------------------------- #
# registrations: every op's backends, with the reference's priorities and
# gates for the plain ones (``ref`` / ``mha_xla`` / ``mamba_scan`` /
# ``moe_kernels`` there).  A ``cuda`` impl's ``covers`` is the call form its
# kernel is written for; its ``supports`` adds the shapes the kernel takes.
# --------------------------------------------------------------------------- #
_CUDA = dict(platforms=("cuda",), priority=100)
_MAX_REF_SCORES = 1 << 24   # B*H*S*T scores; larger -> the chunked core
_MAX_REF_SLOTS = 1 << 22    # B*S*E*C elements of the dense dispatch tensor


def _four_d(q, *a, **kw) -> bool:
    return q.ndim == 4


def _five_d(q, *a, **kw) -> bool:
    return q.ndim == 5


# ---- flash_attention
def _flash_layout(q, k, v, **kw) -> bool:
    return q.shape[1] % k.shape[1] == 0 and k.shape == v.shape


@register("flash_attention", "cuda", **_CUDA, covers=_four_d,
          supports=lambda q, k, v, **kw: (
              q.ndim == 4 and _flash_layout(q, k, v)
              and _flash.supports(q.shape, k.shape)))
def _flash_cuda(q, k, v, *, causal=True, block_q=None, block_k=None):
    return _flash.flash_attention(q, k, v, causal=causal)


@register("flash_attention", "ref", priority=60, supports=_flash_layout,
          auto_gate=lambda q, k, v, **kw: (
              q.shape[0] * q.shape[1] * q.shape[2] * k.shape[2]
              <= _MAX_REF_SCORES))
def _flash_ref(q, k, v, *, causal=True, block_q=None, block_k=None):
    return ref.attention_ref(q, k, v, causal=causal)


@register("flash_attention", "xla", priority=50, supports=_flash_layout)
def _flash_xla(q, k, v, *, causal=True, block_q=None, block_k=None):
    """The reference's ``flash_attention_xla``: the chunked core in the
    kernel layout, K/V repeated to the full head count."""
    S, T = q.shape[2], k.shape[2]
    g = q.shape[1] // k.shape[1]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    if g > 1:
        kt = kt.repeat_interleave(g, dim=2)
        vt = vt.repeat_interleave(g, dim=2)
    out = mha_chunked(q.transpose(1, 2), kt, vt, causal=causal,
                      q_positions=torch.arange(S, device=q.device),
                      kv_positions=torch.arange(T, device=q.device),
                      q_chunk=int(block_q) if block_q else 512,
                      kv_chunk=int(block_k) if block_k else 1024)
    return out.transpose(1, 2)


# ---- decode_attention
def _decode_layout(q, k, v, kv_len, **kw) -> bool:
    return q.shape[1] == k.shape[1] and k.shape == v.shape


def _decode_tuned(q, k, v, kv_len, *, block_k=None):
    """The kernel, its range per CTA from the autotune cache."""
    B, KH, G, D = q.shape
    T = k.shape[2]
    kv_len = ref.normalize_kv_len(kv_len, B, q.device)
    (chunk,) = dispatch.tuned_blocks(
        "decode_attention", (B, KH, G, D, T, str(q.dtype)),
        _decode.chunk_candidates(B, KH, T),
        bench=lambda c: _decode.decode_attention_cuda(q, k, v, kv_len,
                                                      chunk=c, count=False),
        args=(q, k, v, kv_len))
    return _decode.decode_attention_cuda(q, k, v, kv_len, chunk=chunk)


register("decode_attention", "cuda", **_CUDA, covers=_four_d,
         supports=lambda q, k, v, kv_len, **kw: (
             q.ndim == 4 and _decode_layout(q, k, v, kv_len)
             and _decode.supports(q.shape, k.shape)))(_decode_tuned)


@register("decode_attention", "ref", priority=60, supports=_decode_layout)
def _decode_ref(q, k, v, kv_len, *, block_k=None):
    if q.ndim == 5:
        B, KH, G, T, D = q.shape
        out = ref.mixed_decode_attention_ref(q.reshape(B, KH * G, T, D), k,
                                             v, kv_len)
        return out.reshape(B, KH, G, T, D)
    B, KH, G, D = q.shape
    kv_len = ref.normalize_kv_len(kv_len, B, q.device)
    out = ref.decode_attention_ref(q.reshape(B, KH * G, D), k, v, kv_len)
    return out.reshape(B, KH, G, D)


@register("decode_attention", "xla", priority=70, supports=_decode_layout,
          auto_gate=_five_d)
def _decode_xla(q, k, v, kv_len, *, block_k=None):
    if q.ndim == 5:
        return mha_stream.mixed_decode_attention(q, k, v, kv_len,
                                                 block_k=block_k)
    return _decode_ref(q, k, v, kv_len)


# ---- paged_decode_attention
def _paged_layout(q, k_pool, v_pool, block_tables, kv_len, *, k_scale=None,
                  v_scale=None) -> bool:
    if (k_scale is None) != (v_scale is None):
        return False
    if k_scale is not None and k_scale.shape != k_pool.shape[:-1]:
        return False
    return (k_pool.shape == v_pool.shape and q.shape[1] == k_pool.shape[2]
            and block_tables.ndim == 2
            and block_tables.shape[0] == q.shape[0])


def _paged_tuned(q, k_pool, v_pool, block_tables, kv_len, *, k_scale=None,
                 v_scale=None):
    """The kernel, its range per CTA from the autotune cache."""
    B, KH, G, D = q.shape
    bs, pages = k_pool.shape[1], block_tables.shape[1]
    kv_len = ref.normalize_kv_len(kv_len, B, q.device)
    tables = block_tables.to(torch.int32)
    kw = dict(k_scale=k_scale, v_scale=v_scale)
    (chunk,) = dispatch.tuned_blocks(
        "paged_decode_attention",
        (B, KH, G, D, bs, pages, str(q.dtype), str(k_pool.dtype)),
        _decode.chunk_candidates(B, KH, pages * bs),
        bench=lambda c: _paged.paged_decode_attention_cuda(
            q, k_pool, v_pool, tables, kv_len, chunk=c, count=False, **kw),
        args=(q, k_pool, v_pool, tables, kv_len))
    return _paged.paged_decode_attention_cuda(q, k_pool, v_pool, tables,
                                              kv_len, chunk=chunk, **kw)


register("paged_decode_attention", "cuda", **_CUDA, covers=_four_d,
         supports=lambda q, kp, vp, bt, kl, **kw: (
             q.ndim == 4 and _paged_layout(q, kp, vp, bt, kl, **kw)
             and _paged.supports(q.shape, kp.shape, bt.shape)))(_paged_tuned)
register("paged_decode_attention", "ref", priority=60,
         supports=_paged_layout)(ref.paged_decode_attention_ref)


@register("paged_decode_attention", "xla", priority=70,
          supports=_paged_layout, auto_gate=_five_d)
def _paged_xla(q, k_pool, v_pool, block_tables, kv_len, *, k_scale=None,
               v_scale=None):
    fn = (mha_stream.paged_mixed_attention if q.ndim == 5
          else ref.paged_decode_attention_ref)
    return fn(q, k_pool, v_pool, block_tables, kv_len, k_scale=k_scale,
              v_scale=v_scale)


# ---- wkv6: the kernel takes the stateless form only
def _stateless(*a, initial_state=None, return_state=False, **kw) -> bool:
    return initial_state is None and not return_state


@register("wkv6", "cuda", **_CUDA, covers=_stateless,
          supports=lambda r, *a, **kw: (_stateless(**kw)
                                        and _wkv6.supports(r.shape)))
def _wkv6_cuda(r, k, v, w, u, *, chunk=64, initial_state=None,
               return_state=False):
    return _wkv6.wkv6(r, k, v, w, u, chunk=chunk)


# the plain scan is the reference's production form too: one function
# under both names, as there
register("wkv6", "ref", priority=60)(ref.wkv6_scan)
register("wkv6", "xla", priority=50)(ref.wkv6_scan)


# ---- mamba_scan: the kernel takes every form
register("mamba_scan", "cuda", **_CUDA, covers=lambda *a, **kw: True,
         supports=lambda dt, Bm, Cm, x, *a, **kw: _mamba.supports(
             x.shape, Bm.shape[-1]))(_mamba.mamba_scan)
register("mamba_scan", "ref", priority=60)(ref.mamba_scan_ref)
register("mamba_scan", "xla", priority=50)(ref.mamba_scan_chunked)


# ---- moe_dispatch_combine: the kernels take every shape
_CUDA_ROWS = dict(scatter_rows=_scatter_local(_moe.MoEScatter.apply),
                  gather_rows=_gather_local(_moe.MoEGather.apply))
_PLAIN_ROWS = dict(scatter_rows=_scatter_local(ref.moe_scatter_ref),
                   gather_rows=_gather_local(ref.moe_gather_ref))


@register("moe_dispatch_combine", "cuda", **_CUDA,
          covers=lambda *a, **kw: True)
def _moe_cuda(x, gate_vals, expert_idx, wi, wg, wo, *, capacity,
              constrain=None):
    return ref.moe_scatter(x, gate_vals, expert_idx, wi, wg, wo,
                           capacity=capacity, constrain=constrain,
                           **_CUDA_ROWS)


@register("moe_dispatch_combine", "xla", priority=60)
def _moe_xla(x, gate_vals, expert_idx, wi, wg, wo, *, capacity,
             constrain=None):
    return ref.moe_scatter(x, gate_vals, expert_idx, wi, wg, wo,
                           capacity=capacity, constrain=constrain,
                           **_PLAIN_ROWS)


@register("moe_dispatch_combine", "ref", priority=50,
          auto_gate=lambda x, g, e, wi, *a, capacity, **kw: (
              x.shape[0] * x.shape[1] * wi.shape[0] * capacity
              <= _MAX_REF_SLOTS))
def _moe_ref(x, gate_vals, expert_idx, wi, wg, wo, *, capacity,
             constrain=None):
    """The dense one-hot oracle; it places nothing (``constrain`` is
    taken for the op's signature)."""
    return ref.moe_dense_ref(x, gate_vals, expert_idx, wi, wg, wo,
                             capacity=capacity)
