"""Mamba-1 selective scan: the CUDA kernel's wrapper, its gradient and its
launch count.  Counterpart of ``repro.kernels.mamba_scan``.

The kernel (``csrc/mamba_scan.cu``) takes dt/x ``(B, S, di)`` and Bm/Cm
``(B, S, N)`` in float32 or bfloat16 (all four the same; the last axis
contiguous, any batch and time strides, so the model's split views go in
without a copy), A ``(di, N)`` and D ``(di,)`` in float32, N up to 16 and
any S (the TPU kernel's ``S % chunk`` rule does not apply).  It takes the
whole contract of the op: an optional float32 initial state ``(B, di, N)``
in, and the final state out when ``return_state``.  Inputs that are whole
16-byte units (:func:`vector_path`) are staged by 16-byte copies, others
(a split view at an odd column) by the kernel's scalar loads.  Its plain
version is :func:`repro_torch.kernels.ref.mamba_scan_ref`.

Like the reference's ``with_reference_vjp``, the kernel is forward-only:
:class:`MambaScan` runs it forward and, in the backward pass,
differentiates the plain version at the saved inputs.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ref

#: launches since the last reset; the wrapper adds one where it launches
launches = {"mamba_scan": 0}

MAX_N = 16
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib():
    fn = build.load("mamba_scan").mamba_scan_forward
    if fn.argtypes is None:
        fn.argtypes = [_P] * 9 + [_I] * 6 + [_L] * 8 + [_P]
        fn.restype = _I
    return fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"mamba_scan: {msg}")


def _state(t, name, shape, device):
    _require(t.is_cuda and t.device == device,
             f"{name} must be on the inputs' CUDA device")
    _require(t.dtype == torch.float32 and tuple(t.shape) == shape
             and t.is_contiguous(),
             f"{name} must be a contiguous float32 {shape} tensor (got "
             f"{t.dtype} {tuple(t.shape)})")


def supports(x_shape, state_size: int) -> bool:
    """The shapes the kernel takes: x (B, S, di) non-empty, B <= 65535 (the
    grid), state size 1 .. MAX_N."""
    B, S, di = x_shape
    return 0 < state_size <= MAX_N and min(B, S, di) > 0 and B <= 65535


def vector_path(dt, Bm, Cm, x, A, initial_state=None) -> bool:
    """Whether the kernel moves its inputs as 16-byte units (``cp.async``
    tiles, 4-vectors of state): the addresses of dt, Bm, Cm, x, A and the
    initial state, the strides of dt, Bm, Cm and x along each axis longer
    than 1, and the rows of x (di values) and Bm (N) all whole 16-byte
    units.  Otherwise it takes scalar loads, as a split view at an odd
    column needs."""
    el = x.element_size()
    seq = (dt, Bm, Cm, x)
    ptrs = (*seq, A) + (() if initial_state is None else (initial_state,))
    return (all(t.data_ptr() % 16 == 0 for t in ptrs)
            and all(t.stride(i) * el % 16 == 0 for t in seq for i in (0, 1)
                    if t.shape[i] > 1)
            and x.shape[-1] * el % 16 == 0 and Bm.shape[-1] * el % 16 == 0)


def mamba_scan_cuda(dt, Bm, Cm, x, A, D, *, initial_state=None,
                    return_state: bool = False):
    """Launch the CUDA kernel on CUDA tensors; raises on anything it does
    not take.  Returns y (B, S, di) in x's dtype, plus the final (B, di, N)
    float32 state when ``return_state``."""
    B, S, di = x.shape
    N = Bm.shape[-1]
    dev = x.device
    seq = (dt, Bm, Cm, x)
    _require(all(t.is_cuda and t.device == dev for t in (*seq, A, D)),
             "dt, Bm, Cm, x, A and D must be on the same CUDA device")
    _require(x.dtype in _DTYPE and all(t.dtype == x.dtype for t in seq),
             f"dt/Bm/Cm/x dtypes {dt.dtype}/{Bm.dtype}/{Cm.dtype}/{x.dtype} "
             f"(float32 or bfloat16, all the same)")
    _require(tuple(dt.shape) == (B, S, di) and tuple(Bm.shape) == (B, S, N)
             and tuple(Cm.shape) == (B, S, N),
             f"shapes dt {tuple(dt.shape)} / Bm {tuple(Bm.shape)} / Cm "
             f"{tuple(Cm.shape)} / x {tuple(x.shape)}")
    _require(all(t.stride(-1) == 1 for t in seq),
             "the last axis of dt, Bm, Cm and x must be contiguous")
    _require(A.dtype == torch.float32 and D.dtype == torch.float32
             and tuple(A.shape) == (di, N) and tuple(D.shape) == (di,)
             and A.is_contiguous() and D.is_contiguous(),
             f"A must be a contiguous float32 ({di}, {N}) and D a ({di},) "
             f"tensor (got {A.dtype} {tuple(A.shape)}, {D.dtype} "
             f"{tuple(D.shape)})")
    _require(supports(x.shape, N),
             f"state size {N} (1..{MAX_N}) and a non-empty (B, S, di) = "
             f"({B}, {S}, {di}), B <= 65535")
    if initial_state is not None:
        _state(initial_state, "initial_state", (B, di, N), dev)
    hN = (torch.empty(B, di, N, dtype=torch.float32, device=dev)
          if return_state else None)
    y = torch.empty(B, S, di, dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _lib()(dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), x.data_ptr(),
                 A.data_ptr(), D.data_ptr(), ptr(initial_state),
                 ptr(hN), y.data_ptr(), B, S, di, N, _DTYPE[x.dtype],
                 int(vector_path(dt, Bm, Cm, x, A, initial_state)),
                 dt.stride(0), dt.stride(1), Bm.stride(0), Bm.stride(1),
                 Cm.stride(0), Cm.stride(1), x.stride(0), x.stride(1),
                 stream)
    build.check(err, "mamba_scan")
    launches["mamba_scan"] += 1
    return (y, hN) if return_state else y


class MambaScan(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: the gradient of the plain
    :func:`~repro_torch.kernels.ref.mamba_scan_ref` at the saved inputs
    (the initial state included when one was given)."""

    @staticmethod
    def forward(ctx, dt, Bm, Cm, x, A, D, h0, chunk, return_state):
        ctx.save_for_backward(dt, Bm, Cm, x, A, D, h0)
        ctx.chunk = chunk
        ctx.return_state = return_state
        return mamba_scan_cuda(dt, Bm, Cm, x, A, D, initial_state=h0,
                               return_state=return_state)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        args = [None if a is None else a.detach().requires_grad_()
                for a in saved]
        with torch.enable_grad():
            out = ref.mamba_scan_ref(*args[:6], chunk=ctx.chunk,
                                     initial_state=args[6],
                                     return_state=ctx.return_state)
        outs = out if ctx.return_state else (out,)
        live = [a for a in args if a is not None]
        got = iter(torch.autograd.grad(outs, live, grads, allow_unused=True))
        return (*(None if a is None else next(got) for a in args), None,
                None)


def mamba_scan(dt, Bm, Cm, x, A, D, *, chunk: int = 64, initial_state=None,
               return_state: bool = False):
    """The kernel, differentiable when autograd needs it: through
    :class:`MambaScan` when a gradient is being recorded, else launched
    directly."""
    ins = (dt, Bm, Cm, x, A, D, initial_state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in ins):
        return MambaScan.apply(*ins, chunk, return_state)
    return mamba_scan_cuda(dt, Bm, Cm, x, A, D, initial_state=initial_state,
                           return_state=return_state)
