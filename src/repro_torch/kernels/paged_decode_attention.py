"""Paged flash-decode attention: the CUDA kernel's wrapper and its launch
counts.  Counterpart of ``repro.kernels.paged_decode_attention``.

The kernel (``csrc/paged_decode_attention.cu``) takes single-token q
``(B, KH, G, D)`` over a block pool ``(NB, block_size, KH, D)`` in
float32 or bfloat16, or int8 with ``(NB, block_size, KH)`` float32
scales, head dim 64 or 128, any block size.  It splits each row's
``pages * block_size`` tokens into ranges (by default
:func:`~repro_torch.kernels.decode_attention.split_plan`'s; the
dispatcher takes them from its autotune cache), one CTA each,
and combines a row's ranges in the same launch through the workspace it
shares with the dense decode kernel.  One call of the wrapper is one
launch.  Its plain version is
:func:`repro_torch.kernels.ref.paged_decode_attention_ref`;
:mod:`repro_torch.kernels.ops` picks between the two through the
dispatcher.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, work
from .decode_attention import split_plan, workspace

#: launches of each kernel since the last reset; a wrapper adds one
#: where it launches, and nowhere else
launches = {"paged_decode_attention": 0, "paged_decode_attention_int8": 0}

_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = build.load("paged_decode_attention")
    fn = lib.paged_decode_attention
    if fn.argtypes is None:
        fn.argtypes = [_P] * 10 + [_I] * 10 + [_P]
        fn.restype = _I
    return fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_decode_attention: {msg}")


def supports(q_shape, pool_shape, tables_shape) -> bool:
    """The shapes the kernel takes: q (B, KH, G, D), pools (NB, block_size,
    KH, D), tables (B, pages) with head dim 64 or 128, G * D <= 2048 and a
    non-empty table row."""
    _, _, G, D = q_shape
    return (D in (64, 128) and G * D <= 2048
            and pool_shape[1] * tables_shape[1] >= 1)


def paged_decode_attention_cuda(q, k_pool, v_pool, block_tables, kv_len, *,
                                k_scale=None, v_scale=None,
                                chunk: int | None = None,
                                count: bool = True):
    """Launch the CUDA kernel on CUDA tensors; raises on anything it does
    not take.  ``kv_len`` is a (B,) int32 CUDA tensor.  ``chunk`` and
    ``count`` as for the dense kernel
    (:func:`~repro_torch.kernels.decode_attention.decode_attention_cuda`),
    over the table's ``pages * block_size`` tokens."""
    quant = k_scale is not None
    B, KH, G, D = q.shape
    NB, bs, KHp, Dp = k_pool.shape
    pages = block_tables.shape[1]
    tensors = [q, k_pool, v_pool, block_tables, kv_len]
    if quant:
        tensors += [k_scale, v_scale]
    _require(all(work.on_card(t) and t.device == q.device for t in tensors),
             "every tensor must be on the same CUDA device")
    _require(all(t.is_contiguous() for t in tensors),
             "every tensor must be contiguous")
    _require(q.ndim == 4 and (KHp, Dp) == (KH, D)
             and v_pool.shape == k_pool.shape,
             f"shapes q {tuple(q.shape)} / pools {tuple(k_pool.shape)} "
             f"do not agree")
    _require(supports(q.shape, k_pool.shape, block_tables.shape),
             f"head dim {D} (64 or 128), group {G} (G*D <= 2048) and "
             f"{pages} pages of {bs} tokens (not none)")
    _require(tuple(block_tables.shape) == (B, pages)
             and block_tables.dtype == torch.int32,
             "block_tables must be (B, pages) int32")
    _require(tuple(kv_len.shape) == (B,) and kv_len.dtype == torch.int32,
             "kv_len must be (B,) int32")
    _require(q.dtype in (torch.float32, torch.bfloat16),
             f"q dtype {q.dtype} (float32 or bfloat16)")
    if quant:
        _require(k_pool.dtype == torch.int8 and v_pool.dtype == torch.int8,
                 "scales come with int8 pools")
        _require(tuple(k_scale.shape) == (NB, bs, KH)
                 and tuple(v_scale.shape) == (NB, bs, KH)
                 and k_scale.dtype == torch.float32
                 and v_scale.dtype == torch.float32,
                 "scales must be (NB, block_size, KH) float32")
    else:
        _require(k_pool.dtype == q.dtype and v_pool.dtype == q.dtype,
                 "fp pools must have q's dtype")
    if chunk is None:
        chunk = split_plan(B, KH, pages * bs)[0]
    _require(chunk > 0 and chunk % 32 == 0,
             f"chunk {chunk} must be a positive multiple of 32")
    if work.is_fake(q):
        work.report("paged_decode_attention_int8" if quant
                    else "paged_decode_attention",
                    work.paged_decode_attention(
                        q.shape, pages, work.live_rows(kv_len, B * pages * bs),
                        q.element_size(), k_pool.element_size(), quant))
        return torch.empty_like(q)
    _require(k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0,
             "the pools must start on 16-byte boundaries (cp.async)")
    splits = -(-(pages * bs) // chunk)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    stride = G * D + -(-2 * G // 4) * 4      # per range: acc, m, l
    part, tickets = workspace(q.device, stream, B * KH * splits * stride,
                              B * KH)
    err = _lib()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 k_scale.data_ptr() if quant else None,
                 v_scale.data_ptr() if quant else None,
                 block_tables.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
                 part.data_ptr(), tickets.data_ptr(), B, KH, G, D, bs, pages,
                 chunk, splits, _DTYPE[q.dtype], _DTYPE[k_pool.dtype],
                 stream)
    build.check(err, "paged_decode_attention")
    if count:
        launches["paged_decode_attention_int8" if quant
                 else "paged_decode_attention"] += 1
    return out
