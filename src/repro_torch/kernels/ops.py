"""Kernel entry points with the op names and signatures of
``repro.kernels.ops``.

The implementation is chosen by the tensor's device alone: a CUDA tensor
goes to the hand-written kernel (or the call raises), a CPU tensor goes
to the plain PyTorch version.  Nothing falls back from one to the other:
a shape the kernel does not take raises on the card, as a wrong dtype,
device or layout does.  ``supports_<op>`` says, as a pure function of
shapes, what each kernel takes, so that a caller can refuse a model
before it is built (:func:`repro_torch.launch.train.require_kernel_shapes`).
Where autograd records a gradient, a CUDA call goes through the kernel's
``autograd.Function`` (forward the kernel, backward the gradient of the
plain version), so no caller gets an output detached from its inputs.

The mixed-step forms of the dense and paged decode ops (5-d q, one
kv_len per query token) are plain torch on every device, as their
counterparts are XLA in the reference (:mod:`repro_torch.kernels.mha_stream`).

On a realized plan (DTensor inputs) every op runs on local shards
(:func:`repro_torch.core.sharding.run_local`): attention and WKV6 over
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
from . import flash_attention as _flash
from . import mamba_scan as _mamba
from . import mha_stream
from . import moe_dispatch as _moe
from . import paged_decode_attention as _paged
from . import ref
from . import rwkv6_scan as _wkv6
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


def _route(t: torch.Tensor, op: str) -> bool:
    """True for CUDA (launch the kernel), False for CPU (plain version)."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{op}: no implementation for device {t.device}")


def flash_attention(q, k, v, *, causal: bool = True, block_q=None,
                    block_k=None):
    """q: (B, H, S, D); k/v: (B, KH, T, D) -> (B, H, S, D).  ``block_q`` /
    ``block_k`` are accepted for signature parity; the CUDA kernel's
    tiles are fixed."""
    if _dist(q, k, v):
        G = q.shape[1] // k.shape[1]

        def local(off, ql, kl, vl):
            kl, _ = kv_heads_for(kl, off, ql.shape[1], G, 1)
            vl, _ = kv_heads_for(vl, off, ql.shape[1], G, 1)
            return flash_attention(ql.contiguous(), kl.contiguous(),
                                   vl.contiguous(), causal=causal)
        return run_local(local, [q, k, v], [_BHSD, _KV, _KV], _BHSD)
    if _route(q, "flash_attention"):
        return _flash.flash_attention(q, k, v, causal=causal)
    return ref.attention_ref(q, k, v, causal=causal)


def decode_attention(q, k, v, kv_len, *, block_k=None):
    """Dense-cache decode.  q: (B, KH, G, D); k/v: (B, KH, T, D) (any
    strides with the head dim contiguous) -> (B, KH, G, D); kv_len:
    scalar or (B,).  ``block_k`` is accepted for signature parity (the
    CUDA kernel picks its own split).  The mixed-step form (q
    (B, KH, G, T, D), kv_len (B, T)) streams in plain torch on every
    device, as its counterpart is XLA in the reference."""
    if q.ndim == 5:
        if _dist(q, k, v):
            return run_local(
                lambda *a: mha_stream.mixed_decode_attention(*a),
                [q, k, v, kv_len],
                [_BHSD + (None,), _BHSD, _BHSD, ("batch", None)],
                _BHSD + (None,))
        return mha_stream.mixed_decode_attention(q, k, v, kv_len,
                                                 block_k=block_k)
    B, KH, G, D = q.shape
    kv_len = ref.normalize_kv_len(kv_len, B, q.device)
    if _dist(q, k, v):
        return run_local(decode_attention, [q, k, v, kv_len],
                         [_BHSD, _BHSD, _BHSD, ("batch",)], _BHSD)
    if _route(q, "decode_attention"):
        return _decode.decode_attention_cuda(q, k, v, kv_len)
    out = ref.decode_attention_ref(q.reshape(B, KH * G, D), k, v, kv_len)
    return out.reshape(B, KH, G, D)


def paged_decode_attention(q, k_pool, v_pool, block_tables, kv_len, *,
                           k_scale=None, v_scale=None):
    """q: (B, KH, G, D); k_pool/v_pool: (NB, block_size, KH, D);
    block_tables: (B, pages) int32 -> (B, KH, G, D).  kv_len: scalar or
    (B,).  With ``k_scale``/``v_scale`` ((NB, block_size, KH) f32) the
    pools are int8.  A 5-d q (B, KH, G, T, D) with kv_len (B, T) is the
    mixed-step form."""
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
    if _dist(q, k_pool, v_pool):
        lead = _BHSD + ((None,) if q.ndim == 5 else ())
        kvl = ("batch", None) if q.ndim == 5 else ("batch",)
        if q.ndim == 4:
            kv_len = ref.normalize_kv_len(kv_len, q.shape[0], q.device)
        scales = None if k_scale is None else _SCALE
        return run_local(
            lambda q_, kp, vp, bt, kl, ks, vs: paged_decode_attention(
                q_, kp, vp, bt, kl, k_scale=ks, v_scale=vs),
            [q, k_pool, v_pool, block_tables, kv_len, k_scale, v_scale],
            [lead, _POOL, _POOL, ("batch", None), kvl, scales, scales], lead)
    if q.ndim == 5:
        return mha_stream.paged_mixed_attention(
            q, k_pool, v_pool, block_tables, kv_len, k_scale=k_scale,
            v_scale=v_scale)
    if _route(q, "paged_decode_attention"):
        kv_len = ref.normalize_kv_len(kv_len, q.shape[0], q.device)
        return _paged.paged_decode_attention_cuda(
            q, k_pool, v_pool, block_tables.to(torch.int32), kv_len,
            k_scale=k_scale, v_scale=v_scale)
    return ref.paged_decode_attention_ref(q, k_pool, v_pool, block_tables,
                                          kv_len, k_scale=k_scale,
                                          v_scale=v_scale)


_TOKENS = ("batch", None, "d_model")


def _rows(fn_cuda, fn_ref):
    """The kernel on a CUDA tensor (differentiable through its Function),
    the plain version on a CPU one."""
    return lambda t, *a: (fn_cuda if _route(t, "moe") else fn_ref)(t, *a)


def _scatter_local(x, lin, n_slots):
    """The scatter on each shard's batch rows (and model columns)."""
    fn = _rows(_moe.MoEScatter.apply, ref.moe_scatter_ref)
    return run_local(lambda x_, l_: fn(x_, l_, n_slots), [x, lin],
                     [_TOKENS, ("batch", None, None)], _TOKENS,
                     allowed=("batch", "d_model"))


def _gather_local(out, lin, gates):
    """The gather on each shard's batch rows (and model columns)."""
    fn = _rows(_moe.MoEGather.apply, ref.moe_gather_ref)
    return run_local(fn, [out, lin, gates],
                     [_TOKENS, ("batch", None, None), ("batch", None, None)],
                     _TOKENS, allowed=("batch", "d_model"))


def moe_dispatch_combine(x, gate_vals, expert_idx, wi, wg, wo, *,
                         capacity: int, constrain=None):
    """MoE dispatch + expert FFN + combine; x: (B, S, D); gate_vals /
    expert_idx: (B, S, K); wi/wg: (E, D, F); wo: (E, F, D) -> y (B, S, D).
    GShard capacity per batch row; assignments past ``capacity`` are
    dropped.  The plain op :func:`repro_torch.kernels.ref.moe_scatter`
    with the scatter and gather kernels in place of their plain versions
    on the card (each through its autograd Function), the plain versions
    on the CPU; the expert FFN between them is torch on every device.

    ``constrain(tensor, dims)`` applies the layer's sharding constraints
    at the reference's points: on a realized plan (DTensor ``x``) the
    scatter and the gather run shard-local over batch with all E slots
    local, while the expert FFN runs as DTensor einsums on the expert
    shards the constraints lay out (expert parallelism)."""
    return ref.moe_scatter(x, gate_vals, expert_idx, wi, wg, wo,
                           capacity=capacity, scatter_rows=_scatter_local,
                           gather_rows=_gather_local, constrain=constrain)


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
         return_state: bool = False):
    """RWKV6 recurrence; r/k/v/w: (B, H, T, N); u: (H, N).  Returns out,
    plus the final (B, H, N, N) float32 state when ``return_state``.  The
    kernel takes the stateless form only (as the reference's does); the
    stateful form runs the plain version on every device."""
    if _dist(r, k, v, w):
        stateful = initial_state is not None or return_state
        return run_local(
            lambda *a: wkv6(*a[:5], chunk=chunk, initial_state=a[5],
                            return_state=return_state),
            [r, k, v, w, u, initial_state],
            [_BHSD] * 4 + [("heads", None),
                           _BHSD if initial_state is not None else None],
            [_BHSD, _BHSD] if stateful and return_state else _BHSD)
    if initial_state is not None or return_state:
        return ref.wkv6_scan(r, k, v, w, u, chunk=chunk,
                             initial_state=initial_state,
                             return_state=return_state)
    if _route(r, "wkv6"):
        return _wkv6.wkv6(r, k, v, w, u, chunk=chunk)
    return ref.wkv6_scan(r, k, v, w, u, chunk=chunk)


def mamba_scan(dt, Bm, Cm, x, A, D, *, chunk: int = 64, initial_state=None,
               return_state: bool = False):
    """Selective-scan recurrence; dt/x: (B, S, di); Bm/Cm: (B, S, N); A:
    (di, N); D: (di,).  Returns y, plus the final (B, di, N) float32 state
    when ``return_state``.  A CUDA tensor goes to the kernel in every form
    (stateless, an initial state in, the final state out); a CPU tensor to
    the plain version."""
    if _dist(dt, x):
        t_r = ("batch", None, "chan")
        s_r = ("batch", "chan", None)
        return run_local(
            lambda *a: mamba_scan(*a[:6], chunk=chunk, initial_state=a[6],
                                  return_state=return_state),
            [dt, Bm, Cm, x, A, D, initial_state],
            [t_r, ("batch", None, None), ("batch", None, None), t_r,
             ("chan", None), ("chan",),
             s_r if initial_state is not None else None],
            [t_r, s_r] if return_state else t_r,
            allowed=("batch", "chan"), lead=3)
    if _route(x, "mamba_scan"):
        return _mamba.mamba_scan(dt, Bm, Cm, x, A, D, chunk=chunk,
                                 initial_state=initial_state,
                                 return_state=return_state)
    return ref.mamba_scan_ref(dt, Bm, Cm, x, A, D, chunk=chunk,
                              initial_state=initial_state,
                              return_state=return_state)
