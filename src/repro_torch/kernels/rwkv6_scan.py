"""WKV6 recurrence (RWKV6 time mix): the CUDA kernel's wrapper, its
gradient and its launch count.  Counterpart of
``repro.kernels.rwkv6_scan``.

The kernel (``csrc/rwkv6_scan.cu``) takes r/k/v ``(B, H, T, N)`` in
float32 or bfloat16, w ``(B, H, T, N)`` and u ``(H, N)`` in float32, head
size N 32 or 64 and any T (the TPU kernel's chunk-divisibility rule does
not apply).  It is the stateless form only; the stateful form (an initial
state or the final state returned) runs the plain version on every
device, as in the reference.  Its plain version is
:func:`repro_torch.kernels.ref.wkv6_scan`.

Like the reference's ``with_reference_vjp``, the kernel is forward-only:
:class:`WKV6` runs it forward and, in the backward pass, differentiates
the plain version at the saved inputs.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ref, work

#: launches since the last reset; the wrapper adds one where it launches
launches = {"wkv6": 0}

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    fn = build.load("rwkv6_scan").wkv6_forward
    if fn.argtypes is None:
        fn.argtypes = [_P] * 6 + [_I] * 5 + [_P]
        fn.restype = _I
    return fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"wkv6: {msg}")


def supports(r_shape) -> bool:
    """The shapes the kernel takes: r/k/v/w (B, H, T, N) with head size 32
    or 64, non-empty."""
    B, H, T, N = r_shape
    return N in (32, 64) and min(B, H, T) > 0


def wkv6_cuda(r, k, v, w, u):
    """Launch the CUDA kernel on CUDA tensors; raises on anything it does
    not take.  Returns out (B, H, T, N) in r's dtype."""
    B, H, T, N = r.shape
    tensors = (r, k, v, w, u)
    _require(all(work.on_card(t) and t.device == r.device for t in tensors),
             "r, k, v, w and u must be on the same CUDA device")
    _require(all(t.is_contiguous() for t in tensors),
             "r, k, v, w and u must be contiguous")
    _require(r.dtype in _DTYPE and k.dtype == r.dtype and v.dtype == r.dtype,
             f"r/k/v dtypes {r.dtype}/{k.dtype}/{v.dtype} (float32 or "
             f"bfloat16, all the same)")
    _require(w.dtype == torch.float32 and u.dtype == torch.float32,
             f"w and u must be float32 (got {w.dtype}, {u.dtype})")
    _require(k.shape == r.shape and v.shape == r.shape
             and w.shape == r.shape and tuple(u.shape) == (H, N),
             f"shapes r {tuple(r.shape)} / k {tuple(k.shape)} / v "
             f"{tuple(v.shape)} / w {tuple(w.shape)} / u {tuple(u.shape)}")
    _require(supports(r.shape),
             f"head size {N} (32 or 64) and a non-empty (B, H, T) "
             f"= ({B}, {H}, {T})")
    if work.is_fake(r):
        work.report("wkv6", work.wkv6(r.shape, r.element_size()))
        return torch.empty_like(r)
    out = torch.empty_like(r)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _lib()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), out.data_ptr(), B, H, T, N, _DTYPE[r.dtype],
                 stream)
    build.check(err, "wkv6")
    launches["wkv6"] += 1
    return out


class WKV6(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: the gradient of the plain
    :func:`~repro_torch.kernels.ref.wkv6_scan` at the saved inputs."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk):
        ctx.save_for_backward(r, k, v, w, u)
        ctx.chunk = chunk
        return wkv6_cuda(r, k, v, w, u)

    @staticmethod
    def backward(ctx, g):
        args = [a.detach().requires_grad_() for a in ctx.saved_tensors]
        with torch.enable_grad():
            out = ref.wkv6_scan(*args, chunk=ctx.chunk)
        grads = torch.autograd.grad(out, args, g)
        return (*grads, None)


def wkv6(r, k, v, w, u, *, chunk: int = 64):
    """The kernel, differentiable when autograd needs it: through
    :class:`WKV6` when a gradient is being recorded, else launched
    directly."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u)):
        return WKV6.apply(r, k, v, w, u, chunk)
    return wkv6_cuda(r, k, v, w, u)
