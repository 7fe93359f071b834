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
"""

from __future__ import annotations

import torch

from . import decode_attention as _decode
from . import flash_attention as _flash
from . import mamba_scan as _mamba
from . import mha_stream
from . import moe_dispatch as _moe
from . import paged_decode_attention as _paged
from . import ref
from . import rwkv6_scan as _wkv6

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
        return mha_stream.mixed_decode_attention(q, k, v, kv_len,
                                                 block_k=block_k)
    B, KH, G, D = q.shape
    kv_len = ref.normalize_kv_len(kv_len, B, q.device)
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


def moe_dispatch_combine(x, gate_vals, expert_idx, wi, wg, wo, *,
                         capacity: int):
    """MoE dispatch + expert FFN + combine; x: (B, S, D); gate_vals /
    expert_idx: (B, S, K); wi/wg: (E, D, F); wo: (E, F, D) -> y (B, S, D).
    GShard capacity per batch row; assignments past ``capacity`` are
    dropped.  On the card: the scatter and gather kernels around a torch
    expert FFN; on the CPU: the plain scatter/gather
    (:func:`repro_torch.kernels.ref.moe_scatter`)."""
    if _route(x, "moe_dispatch_combine"):
        return _moe.moe_dispatch_combine(x, gate_vals, expert_idx, wi, wg,
                                         wo, capacity=capacity)
    return ref.moe_scatter(x, gate_vals, expert_idx, wi, wg, wo,
                           capacity=capacity)


def wkv6(r, k, v, w, u, *, chunk: int = 64, initial_state=None,
         return_state: bool = False):
    """RWKV6 recurrence; r/k/v/w: (B, H, T, N); u: (H, N).  Returns out,
    plus the final (B, H, N, N) float32 state when ``return_state``.  The
    kernel takes the stateless form only (as the reference's does); the
    stateful form runs the plain version on every device."""
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
    if _route(x, "mamba_scan"):
        return _mamba.mamba_scan(dt, Bm, Cm, x, A, D, chunk=chunk,
                                 initial_state=initial_state,
                                 return_state=return_state)
    return ref.mamba_scan_ref(dt, Bm, Cm, x, A, D, chunk=chunk,
                              initial_state=initial_state,
                              return_state=return_state)
