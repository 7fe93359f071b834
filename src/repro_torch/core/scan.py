"""Time scan with chunked rematerialization: the counterpart of
``repro.core.scan.remat_time_scan``."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _scan(step, carry, xs):
    ys = []
    for t in range(xs[0].shape[0]):
        carry, y = step(carry, tuple(a[t] for a in xs))
        ys.append(y)
    return carry, torch.stack(ys)


def remat_time_scan(step, carry, xs, chunk: int = 64):
    """``step(carry, x_t) -> (carry, y_t)`` run in a Python loop over time
    axis 0 of the tensors ``xs`` (a tuple); returns ``(carry, ys)`` with
    the ``y_t`` stacked on axis 0.

    When the length divides into more than one chunk of ``chunk`` steps,
    each chunk runs under ``torch.utils.checkpoint``: the backward pass
    keeps only the carry at chunk boundaries and recomputes the steps
    inside a chunk, so its memory is O(T/chunk * state) instead of
    O(T * state).  Otherwise the loop runs whole, as in the reference."""
    S = xs[0].shape[0]
    if S % chunk != 0 or S <= chunk:
        return _scan(step, carry, xs)
    ys = []
    for c0 in range(0, S, chunk):
        carry, yc = checkpoint(_scan, step, carry,
                               tuple(a[c0:c0 + chunk] for a in xs),
                               use_reentrant=False, preserve_rng_state=False)
        ys.append(yc)
    return carry, torch.cat(ys)
