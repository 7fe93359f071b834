"""The work each CUDA kernel does, and the launchers' fake branch.

Each function below gives one kernel's :class:`Work` as a pure function
of its shapes and element sizes: the bytes it must move (each input read
once, each output written once) and the operations it does.  Where the
work depends on the data (how many cache rows are live, how many gates
are nonzero) the caller passes what its data needs.  ``chip_smoke.py``'s
kernel phases bound each kernel's time by it, and each launcher's fake
branch reports it to the dry run's accountant
(:mod:`repro_torch.launch.op_analysis`), so that the kernel table's bound
column and the dry run count the same work.

The fake branch: a launcher given a tensor that holds no data
(:func:`is_fake`: a meta tensor, which stands for the card's tensor in
the dry run, or a ``FakeTensor``) applies its own refusals (device,
layout, dtype, shape), then returns outputs shaped, typed and placed as
the kernel allocates them and :func:`report`\\ s the work.  It builds
nothing, launches nothing and counts no launch.  A data-dependent count
is read from a data-holding argument where there is one; a fake one
holds no value, so the count is then the most the shapes allow (every
cache row full, every gate live), as a compiled step reads the whole
cache.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Work:
    """One launch's work: bytes moved, operations, and the exponentials
    among them that the SFUs compute (the selective scan's)."""
    bytes: float
    flops: float
    exps: float = 0.0


_SINKS: list = []


def is_fake(t) -> bool:
    """Whether ``t`` holds no data: a meta tensor or a ``FakeTensor``."""
    if t.is_meta:
        return True
    if type(t) is torch.Tensor:
        return False
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def on_card(t) -> bool:
    """Whether a launcher takes ``t``'s device: a CUDA tensor, or a meta
    tensor standing for one."""
    return t.is_cuda or t.is_meta


@contextlib.contextmanager
def recording(sink):
    """Call ``sink(name, work)`` for every fake launch in the block."""
    _SINKS.append(sink)
    try:
        yield
    finally:
        _SINKS.remove(sink)


def report(name: str, work: Work) -> None:
    for sink in _SINKS:
        sink(name, work)


def live_rows(kv_len, most: int) -> int:
    """Cache rows a decode reads: ``kv_len`` summed, or ``most`` (every
    row full) when ``kv_len`` holds no data."""
    return most if is_fake(kv_len) else int(kv_len.sum())


def live_gates(gates, most: int) -> int:
    """Assignments a gather reads: the nonzero gates, or ``most`` (all)
    when ``gates`` holds no data."""
    return most if is_fake(gates) else int((gates != 0).sum())


def causal_pairs(S: int, T: int) -> int:
    """(query, key) pairs of causal attention of S queries at positions
    0..S-1 over T keys: query s sees min(s + 1, T) keys."""
    if T >= S:
        return S * (S + 1) // 2
    return T * (T + 1) // 2 + (S - T) * T


def flash_attention(q_shape, kv_shape, causal: bool, el: int) -> Work:
    """q (B, H, S, D) against k/v (B, KH, T, D): q, k and v read, the
    output written; 4 D flops a (query, key) pair (two products)."""
    B, H, S, D = q_shape
    T = kv_shape[2]
    pairs = causal_pairs(S, T) if causal else S * T
    kv = B * kv_shape[1] * T * D
    return Work((2 * B * H * S * D + 2 * kv) * el, 4 * B * H * D * pairs)


def decode_attention(q_shape, live: int, el: int) -> Work:
    """q (B, KH, G, D) over ``live`` cache rows in all (kv_len summed): q
    read and the output written, kv_len, and K and V of each live row."""
    B, KH, G, D = q_shape
    return Work(2 * B * KH * G * D * el + B * 4 + 2 * live * KH * D * el,
                4 * live * KH * G * D)


def paged_decode_attention(q_shape, pages: int, live: int, q_el: int,
                           kv_el: int, quant: bool) -> Work:
    """:func:`decode_attention` read through a (B, pages) int32 table;
    int8 rows add a float32 scale a row and head for K and for V."""
    B, KH, G, D = q_shape
    return Work(2 * B * KH * G * D * q_el + B * pages * 4 + B * 4
                + 2 * live * KH * D * kv_el
                + (2 * live * KH * 4 if quant else 0),
                4 * live * KH * G * D)


def moe_scatter(x_shape, K: int, n_slots: int, el: int) -> Work:
    """lin (B, S, K) and x (B, S, D) read, the (B, n_slots + 1, D) buffer
    written once."""
    B, S, D = x_shape
    return Work(B * S * K * 4 + B * S * D * el + B * (n_slots + 1) * D * el,
                0)


def moe_gather(y_shape, K: int, live: int, el: int) -> Work:
    """lin and the float32 gates (B, S, K) read, the ``live`` rows whose
    gate is nonzero read, y (B, S, D) written; a multiply-add a live
    element."""
    B, S, D = y_shape
    return Work(2 * B * S * K * 4 + live * D * el + B * S * D * el,
                2 * live * D)


def wkv6(r_shape, el: int) -> Work:
    """r, k, v read and out written in the activation dtype, w in
    float32, u (H, N); a step is o = r.S + (r.(u*k)) v (2 N^2) and
    S <- w*S + k v^T (3 N^2)."""
    B, H, T, N = r_shape
    n = B * H * T * N
    return Work(4 * n * el + n * 4 + H * N * 4, 5 * n * N)


def mamba_scan(B: int, S: int, di: int, N: int, el: int, *,
               state_in: bool, state_out: bool) -> Work:
    """dt, x read and y written (B, S, di), Bm and Cm (B, S, N) read, A
    (di, N) and D (di,) float32, and the float32 (B, di, N) state read
    and written where it is; a state and step: dt*A, (dt*x)*B and two
    FMAs, and one exponential; a channel and step: dt*x and D*x."""
    steps = B * S * di
    state = B * di * N * 4
    return Work(el * (3 * steps + 2 * B * S * N) + 4 * (di * N + di)
                + state * (int(state_in) + int(state_out)),
                6 * steps * N + 3 * steps, steps * N)
