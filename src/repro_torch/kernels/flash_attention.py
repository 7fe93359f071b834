"""Blockwise flash attention forward: the CUDA kernel's wrapper and its
launch count.  Counterpart of ``repro.kernels.flash_attention``.

The kernel (``csrc/flash_attention.cu``) takes q ``(B, H, S, D)`` and
k/v ``(B, KH, T, D)`` with any S and T >= S, causal or full, head dim 64
or 128, float32 or bfloat16: bfloat16 on the tensor cores through wgmma
with TMA-fed tiles, float32 as three TF32 products per product (float32's
accuracy; TF32 alone stays off).  Unlike the TPU kernel it has no shape
alignment requirement, so no shape falls back to another path; it needs
16-byte-aligned base addresses (TMA and cp.async), which every fresh or
``contiguous()`` copy has.  Its plain version is
:func:`repro_torch.kernels.ref.attention_ref`.

Like the reference's ``with_reference_vjp``, the kernel is forward-only:
:class:`FlashAttention` runs it forward and, in the backward pass,
differentiates the plain version at the saved inputs.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ref, work

#: launches since the last reset; the wrapper adds one where it launches
launches = {"flash_attention": 0}

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    fn = build.load("flash_attention").flash_attention
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_I] * 8 + [_P]
        fn.restype = _I
    return fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def supports(q_shape, kv_shape) -> bool:
    """The shapes the kernel takes: q (B, H, S, D), k/v (B, KH, T, D) with
    head dim 64 or 128, whole head groups and T >= S >= 1."""
    _, H, S, D = q_shape
    KH, T = kv_shape[1], kv_shape[2]
    return D in (64, 128) and KH > 0 and H % KH == 0 and T >= S >= 1


def flash_attention_cuda(q, k, v, *, causal: bool = True):
    """Launch the CUDA kernel on CUDA tensors; raises on anything it does
    not take."""
    B, H, S, D = q.shape
    _, KH, T, _ = k.shape
    _require(work.on_card(q) and k.device == q.device
             and v.device == q.device,
             "q, k and v must be on the same CUDA device")
    _require(q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
             "q, k and v must be contiguous")
    _require(q.dtype in _DTYPE and k.dtype == q.dtype and v.dtype == q.dtype,
             f"dtypes {q.dtype}/{k.dtype}/{v.dtype} (float32 or bfloat16)")
    _require(k.shape == v.shape and k.shape[0] == B and k.shape[3] == D,
             f"shapes q {tuple(q.shape)} / k {tuple(k.shape)} disagree")
    _require(supports(q.shape, k.shape),
             f"head dim {D} (64 or 128), H % KH == 0, T >= S >= 1 ({T}, {S})")
    if work.is_fake(q):
        work.report("flash_attention", work.flash_attention(
            q.shape, k.shape, causal, q.element_size()))
        return torch.empty_like(q)
    _require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
             "q, k and v must start on 16-byte boundaries (TMA, cp.async)")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, H, KH, S, T, D, int(causal), _DTYPE[q.dtype], stream)
    build.check(err, "flash_attention")
    launches["flash_attention"] += 1
    return out


class FlashAttention(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: the gradient of the plain
    :func:`~repro_torch.kernels.ref.attention_ref` at the saved inputs
    (the counterpart of the reference's VJP through
    ``flash_attention_xla``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return flash_attention_cuda(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, g):
        args = [a.detach().requires_grad_() for a in ctx.saved_tensors]
        with torch.enable_grad():
            out = ref.attention_ref(*args, causal=ctx.causal)
        grads = torch.autograd.grad(out, args, g)
        return (*grads, None)


def flash_attention(q, k, v, *, causal: bool = True):
    """The kernel, differentiable when autograd needs it: through
    :class:`FlashAttention` when a gradient is being recorded, else
    launched directly (the serve path)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal)
    return flash_attention_cuda(q, k, v, causal=causal)
