"""MoE capacity dispatch: the CUDA scatter and gather kernels' wrappers,
their launch counts, and the op built on them.  Counterpart of the Pallas
path of ``repro.kernels.moe_kernels`` (``_moe_pallas_impl``).

The kernels (``csrc/moe_dispatch.cu``) take float32 or bfloat16 tokens
and any shape: the TPU path is gated on a 4 MiB VMEM budget for the
(E*C + 1, D) buffer (``_supports_pallas``), which olmoe's decode shape
already exceeds (513 slots x 2048 x 4 B); these have no such limit.

* :func:`moe_scatter_cuda` — lin (B, S, K) int32 and x (B, S, D) -> buf
  (B, E*C + 1, D).  The buffer comes from ``torch.empty``: the kernel
  writes every row of it once, x's row into each kept slot and zeros
  into every slot no token fills (they feed the expert FFN) and into the
  trash row, in one pass, as the TPU kernel zeroes its buffer itself.
  From ``SCATTER_MAP_MIN`` assignments (S*K) up, a first launch writes a
  slot -> token map into a ``torch.empty`` workspace that the row kernel
  reads, instead of every CTA scanning all of lin; the call still counts
  one ``moe_scatter`` launch.
  Plain version :func:`repro_torch.kernels.ref.moe_scatter_ref`.
* :func:`moe_gather_cuda` — lin, out (B, E*C, D) and gates (B, S, K)
  float32 -> y (B, S, D), float32 accumulation; a row whose gate is zero
  is never read.  Plain version
  :func:`repro_torch.kernels.ref.moe_gather_ref`.

:class:`MoEScatter` and :class:`MoEGather` make each kernel
differentiable on its own: like the reference's ``with_reference_vjp``,
the kernels are forward-only, and each Function's backward differentiates
its plain version at the saved inputs.  The op
(:func:`repro_torch.kernels.ops.moe_dispatch_combine`) is the plain
:func:`repro_torch.kernels.ref.moe_scatter` with the two Functions in
place of the plain scatter and gather, so the expert FFN between them is
differentiated by autograd as it ran (on a realized plan, on the expert
shards).
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ref

#: launches since the last reset; each wrapper adds one where it launches
launches = {"moe_scatter": 0, "moe_gather": 0}
#: S*K from which the scatter builds its slot -> token map in a launch of
#: its own, read by every CTA, instead of each CTA scanning all of lin[b]
SCATTER_MAP_MIN = 8192

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


def _fn(name: str, n_ptr: int):
    fn = getattr(build.load("moe_dispatch"), name)
    if fn.argtypes is None:
        fn.argtypes = [_P] * n_ptr + [_I] * 6 + [_P]
        fn.restype = _I
    return fn


def _require(cond: bool, op: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{op}: {msg}")


def _check(op, tensors, dtype_of, lin, B, S):
    _require(all(t.is_cuda and t.device == lin.device for t in tensors), op,
             "every tensor must be on the same CUDA device")
    _require(all(t.is_contiguous() for t in tensors), op,
             "every tensor must be contiguous")
    _require(dtype_of.dtype in _DTYPE, op,
             f"dtype {dtype_of.dtype} (float32 or bfloat16)")
    _require(lin.ndim == 3 and tuple(lin.shape[:2]) == (B, S)
             and lin.dtype == torch.int32, op,
             f"lin must be (B, S, K) = ({B}, {S}, K) int32, got "
             f"{tuple(lin.shape)} {lin.dtype}")


def moe_scatter_cuda(x, lin, n_slots: int):
    """Launch the scatter kernel: x (B, S, D), lin (B, S, K) int32 ->
    buf (B, n_slots + 1, D) in x's dtype."""
    B, S, D = x.shape
    _check("moe_scatter", (x, lin), x, lin, B, S)
    buf = torch.empty(B, n_slots + 1, D, dtype=x.dtype, device=x.device)
    K = lin.shape[2]
    slot_map = (torch.empty(B, n_slots, dtype=torch.int32, device=x.device)
                if S * K >= SCATTER_MAP_MIN else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _fn("moe_scatter", 4)(
        lin.data_ptr(), x.data_ptr(), buf.data_ptr(),
        None if slot_map is None else slot_map.data_ptr(), B, S, K, n_slots,
        D, _DTYPE[x.dtype], stream)
    build.check(err, "moe_scatter")
    launches["moe_scatter"] += 1
    return buf


def moe_gather_cuda(out, lin, gates):
    """Launch the gather kernel: out (B, n_slots, D), lin (B, S, K) int32,
    gates (B, S, K) float32 -> y (B, S, D) in out's dtype."""
    B, n_slots, D = out.shape
    S, K = lin.shape[1:]
    _check("moe_gather", (out, lin, gates), out, lin, B, S)
    _require(tuple(gates.shape) == (B, S, K)
             and gates.dtype == torch.float32, "moe_gather",
             "gates must be (B, S, K) float32")
    y = torch.empty(B, S, D, dtype=out.dtype, device=out.device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = _fn("moe_gather", 4)(lin.data_ptr(), out.data_ptr(),
                               gates.data_ptr(), y.data_ptr(), B, S, K,
                               n_slots, D, _DTYPE[out.dtype], stream)
    build.check(err, "moe_gather")
    launches["moe_gather"] += 1
    return y


class MoEScatter(torch.autograd.Function):
    """Forward: the scatter kernel; backward: the gradient of the plain
    :func:`~repro_torch.kernels.ref.moe_scatter_ref` at the saved x."""

    @staticmethod
    def forward(ctx, x, lin, n_slots):
        ctx.save_for_backward(x, lin)
        ctx.n_slots = n_slots
        return moe_scatter_cuda(x.contiguous(), lin.contiguous(), n_slots)

    @staticmethod
    def backward(ctx, g):
        x, lin = ctx.saved_tensors
        xr = x.detach().requires_grad_()
        with torch.enable_grad():
            out = ref.moe_scatter_ref(xr, lin, ctx.n_slots)
        return torch.autograd.grad(out, xr, g)[0], None, None


class MoEGather(torch.autograd.Function):
    """Forward: the gather kernel; backward: the gradient of the plain
    :func:`~repro_torch.kernels.ref.moe_gather_ref` for ``out`` and
    ``gates``."""

    @staticmethod
    def forward(ctx, out, lin, gates):
        ctx.save_for_backward(out, lin, gates)
        return moe_gather_cuda(out.contiguous(), lin.contiguous(),
                               gates.contiguous())

    @staticmethod
    def backward(ctx, g):
        out, lin, gates = ctx.saved_tensors
        args = [out.detach().requires_grad_(), gates.detach().requires_grad_()]
        with torch.enable_grad():
            y = ref.moe_gather_ref(args[0], lin, args[1])
        go, gg = torch.autograd.grad(y, args, g)
        return go, None, gg
