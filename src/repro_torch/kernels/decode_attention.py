"""Split-KV decode attention over a dense per-slot cache: the CUDA kernel's
wrapper and its launch count.  Counterpart of
``repro.kernels.decode_attention``.

The kernel (``csrc/decode_attention.cu``) takes single-token q
``(B, KH, G, D)`` and k/v ``(B, KH, T, D)`` in float32 or bfloat16, head
dim 64 or 128, any T, and any strides with the head dim contiguous (the
engine's ``(B, T, KH, D)`` cache passes transposed, without a copy).  It
splits the KV axis into small fixed ranges, one CTA each, so the live
ranges fill the card whatever the slots' lengths; a slot that spans
several ranges is combined by the last of its CTAs.  One call of the
wrapper is one launch.  Its plain version is
:func:`repro_torch.kernels.ref.decode_attention_ref`;
:mod:`repro_torch.kernels.ops` picks between the two through the
dispatcher, which takes the range per CTA from its autotune cache
(:func:`chunk_candidates`).
"""

from __future__ import annotations

import ctypes

import torch

from . import build, work

#: launches since the last reset; the wrapper adds one where it launches
launches = {"decode_attention": 0}

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SMS = 132          # H100 SXM streaming multiprocessors
_TILE = 32          # tokens per stage of the kernel's shared-memory ring
RANGE = 64          # tokens per CTA, unless the grid would outgrow _CAP
_CAP = 16 * _SMS    # CTAs beyond which ranges grow (~16 per SM)

# per (device, stream): the float32 partials and the int32 tickets, reused
# by every call on that stream of this kernel and of the paged one (a
# stream's launches run in order); both kernels leave the tickets at zero
_WORKSPACE: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _lib():
    fn = build.load("decode_attention").decode_attention
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_I] * 5 + [_L] * 6 + [_I] * 3 + [_P]
        fn.restype = _I
    return fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"decode_attention: {msg}")


def split_plan(B: int, KH: int, T: int) -> tuple[int, int]:
    """(chunk, splits): tokens per CTA and ranges per row.  Ranges are
    ``RANGE`` tokens, so a row of any live length spreads over
    ceil(len / RANGE) CTAs; only where ``B * KH * ceil(T / RANGE)`` would
    pass ``_CAP`` CTAs do they grow, by whole multiples of ``RANGE``.
    ``chunk`` is a whole number of tiles and ``splits * chunk >= T``."""
    n = B * KH * -(-T // RANGE)
    chunk = RANGE * max(1, -(-n // _CAP))
    return chunk, -(-T // chunk)


def chunk_candidates(B: int, KH: int, T: int) -> list[tuple[int]]:
    """The tile choices the launcher takes, for the autotune cache
    (``dispatch.tuned_blocks``): tokens per CTA, whole multiples of
    ``RANGE``.  :func:`split_plan`'s choice (the heuristic) first, then
    1, 2, 4 and 8 ranges where they differ from it and cover no more than
    T rounded up to a whole range."""
    first, _ = split_plan(B, KH, T)
    top = max(first, -(-T // RANGE) * RANGE)
    rest = [c for c in (RANGE, 2 * RANGE, 4 * RANGE, 8 * RANGE)
            if c != first and c <= top]
    return [(c,) for c in [first] + rest]


def supports(q_shape, kv_shape) -> bool:
    """The shapes the kernel takes: q (B, KH, G, D), k/v (B, KH, T, D) with
    head dim 64 or 128, G * D <= 2048 and T >= 1."""
    _, _, G, D = q_shape
    return D in (64, 128) and G * D <= 2048 and kv_shape[2] >= 1


def workspace(device, stream: int, n_part: int, n_tickets: int):
    key = (device.index, stream)
    part, tickets = _WORKSPACE.get(key, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=device)
    _WORKSPACE[key] = (part, tickets)
    return part, tickets


def decode_attention_cuda(q, k, v, kv_len, *, chunk: int | None = None,
                          count: bool = True):
    """Launch the CUDA kernel on CUDA tensors; raises on anything it does
    not take.  ``kv_len`` is a (B,) int32 CUDA tensor.  ``chunk`` (tokens
    per CTA, a whole number of the kernel's 32-token tiles) defaults to
    :func:`split_plan`'s; ``count=False`` is the autotune's timing launch,
    which counts no launch."""
    B, KH, G, D = q.shape
    T = k.shape[2]
    tensors = (q, k, v, kv_len)
    _require(all(work.on_card(t) and t.device == q.device for t in tensors),
             "q, k, v and kv_len must be on the same CUDA device")
    _require(q.ndim == 4 and k.ndim == 4 and v.shape == k.shape
             and tuple(k.shape[:2]) == (B, KH) and k.shape[3] == D,
             f"shapes q {tuple(q.shape)} / k {tuple(k.shape)} / v "
             f"{tuple(v.shape)} do not agree")
    _require(q.is_contiguous() and k.stride(3) == 1 and v.stride(3) == 1,
             "q must be contiguous and k/v contiguous in the head dim")
    _require(q.dtype in _DTYPE and k.dtype == q.dtype and v.dtype == q.dtype,
             f"dtypes {q.dtype}/{k.dtype}/{v.dtype} (float32 or bfloat16, "
             f"all the same)")
    _require(supports(q.shape, k.shape),
             f"head dim {D} (64 or 128), group {G} (G*D <= 2048), T {T} > 0")
    _require(tuple(kv_len.shape) == (B,) and kv_len.dtype == torch.int32,
             "kv_len must be (B,) int32")
    if chunk is None:
        chunk = split_plan(B, KH, T)[0]
    _require(chunk > 0 and chunk % _TILE == 0,
             f"chunk {chunk} must be a positive multiple of {_TILE}")
    if work.is_fake(q):
        work.report("decode_attention", work.decode_attention(
            q.shape, work.live_rows(kv_len, B * T), q.element_size()))
        return torch.empty_like(q)
    splits = -(-T // chunk)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    stride = G * D + -(-2 * G // 4) * 4      # per range: acc, m, l
    part, tickets = workspace(q.device, stream, B * KH * splits * stride,
                              B * KH)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                 out.data_ptr(), part.data_ptr(), tickets.data_ptr(), B, KH,
                 G, D, T, *k.stride()[:3], *v.stride()[:3], chunk, splits,
                 _DTYPE[q.dtype], stream)
    build.check(err, "decode_attention")
    if count:
        launches["decode_attention"] += 1
    return out
