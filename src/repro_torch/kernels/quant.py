"""Int8 KV quantization helpers (plain torch), the counterpart of
``repro.kernels.quant``.

Symmetric absmax per row over the head dim: ``scale = max(|x|) / 127``,
payload ``round(x / scale)`` clipped to [-127, 127].  All-zero rows keep
``scale = 0`` and quantize through a safe divisor of 1, so a never-written
slot dequantizes to exactly 0.0.  ``torch.round`` rounds half to even,
as ``jnp.round`` does: the payload matches the reference bit for bit.
"""

from __future__ import annotations

import torch

#: int8 symmetric range bound.
QMAX = 127.0


def quantize_kv(x: torch.Tensor):
    """``x`` (..., hd) float -> ``(q int8 (..., hd), scale f32 (...,))``."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / QMAX
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / safe[..., None]), -QMAX, QMAX)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: int8 (..., hd) + f32 (...,) -> f32."""
    return q.float() * scale[..., None].float()
