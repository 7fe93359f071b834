"""Recurrent mixers: RWKV6 (Finch) time mix and channel mix, and the
Mamba-1 selective SSM.  The counterparts of ``repro.models.recurrent``.

Parameters are dicts of tensors in the reference's layouts (``mu (5, d)``,
``wr (d, d)`` .. ``u (H, hs)``; ``in_proj (d, 2 di)`` .. ``out_proj
(di, d)``), so the bridge moves them across unchanged.

The WKV6 recurrence runs through :func:`repro_torch.kernels.ops.wkv6` in
the head-major ``(B, H, T, N)`` layout: the CUDA kernel for the stateless
(training) form on the card, the plain version otherwise.  The decay
``w = exp(-exp(w_log))`` and the state stay float32 whatever the
activation dtype (``w`` compounds over thousands of steps).  The
carried-state form (``state``, ``q_lens``) is the reference's serving
form; it runs the plain version on every device, as the reference's does
(the caller, ``lm.unit_forward``, writes the returned state into its
cache leaves).

The selective scan runs through :func:`repro_torch.kernels.ops.mamba_scan`:
the CUDA kernel on the card in every form (stateless for training and
``forward``, with a carried state for serving), the plain version on the
CPU.  ``mamba_mix`` writes the new state into the cache leaves it was
given (``copy_``), so the views a mixed step passes for one row take the
update.

Each mixer takes its sublayer's ``cfg`` (replicated by default) and
constrains its activations at the reference's points.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.config import LayerConfig
from repro_torch.core.sharding import (constrain, contract, flatten_last2,
                                       is_dtensor, unflatten)
from repro_torch.kernels import ops

from .layers import dense_init

R = LayerConfig.REPLICATED
_BSD = ("batch", "seq", "d_model")


def token_shift(x, prev):
    """RWKV token shift: x[t-1] (``prev`` (B, D) carries state across
    calls; zeros when None)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    else:
        prev = prev[:, None, :].to(x.dtype)
    return torch.cat([prev, x[:, :-1]], dim=1)


def _shift_state(x, prev, q_lens):
    """Next shift state: the last *live* token per row -- x[:, -1] without
    ``q_lens``; x[:, q_lens[b] - 1] in a mixed step, and the carried
    ``prev`` when q_lens[b] == 0 (the row sat the step out)."""
    if q_lens is None:
        return x[:, -1, :]
    B, _, D = x.shape
    pv = (prev[:, None, :].to(x.dtype) if prev is not None
          else torch.zeros_like(x[:, :1]))
    xe = torch.cat([pv, x], dim=1)                           # (B, S+1, D)
    gi = q_lens.long()[:, None, None].expand(B, 1, D)
    return torch.gather(xe, 1, gi)[:, 0]


# --------------------------------------------------------------------------- #
# time mix (WKV6 recurrence, data-dependent decay)
# --------------------------------------------------------------------------- #
def init_rwkv_tmix(arch, dtype, *, generator, device, lead=()):
    d = arch.d_model
    H, hs = arch.n_rwkv_heads, arch.rwkv_head_size
    kw = dict(generator=generator, device=device)
    full = lambda shape, val: torch.full((*lead, *shape), val, dtype=dtype,
                                         device=device)
    return {
        "mu": full((5, d), 0.5),                    # r, k, v, g, w mixing
        "wr": dense_init((*lead, d, d), dtype, fan_in=d, **kw),
        "wk": dense_init((*lead, d, d), dtype, fan_in=d, **kw),
        "wv": dense_init((*lead, d, d), dtype, fan_in=d, **kw),
        "wg": dense_init((*lead, d, d), dtype, fan_in=d, **kw),
        "w0": full((d,), -2.0),                     # decay base
        "w_lora_a": dense_init((*lead, d, 64), dtype, fan_in=d, **kw),
        "w_lora_b": dense_init((*lead, 64, d), dtype, fan_in=64, **kw) * 0.1,
        "u": dense_init((*lead, H, hs), dtype, fan_in=H, **kw),   # bonus
        "ln_x": full((d,), 1.0),
        "wo": dense_init((*lead, d, d), dtype, fan_in=d, **kw),
    }


def rwkv_tmix(p: dict, x, arch, state: dict | None = None, chunk: int = 64,
              q_lens=None, cfg: LayerConfig = R):
    """x: (B, S, D) -> (y, new_state).  state: {"shift": (B, D), "wkv":
    (B, H, hs, hs)}.  Without ``state`` the returned ``new_state["wkv"]``
    is None (training discards it, and asking for it would keep the
    recurrence off the kernel).

    q_lens: (B,) -- a mixed step: only row b's first ``q_lens[b]`` tokens
    are live; padding is made state-transparent (w -> 1, k -> 0) and the
    shift state is taken at each row's last live token."""
    B, S, D = x.shape
    H, hs = arch.n_rwkv_heads, arch.rwkv_head_size
    prev = state["shift"] if state is not None else None
    sh = token_shift(x, prev)
    mu = p["mu"]
    xr, xk, xv, xg, xw = (x + mu[i] * (sh - x) for i in range(5))

    heads = lambda t: unflatten(t, -1, (H, hs))
    r = heads(contract(xr, p["wr"]))
    k = heads(contract(xk, p["wk"]))
    v = heads(contract(xv, p["wv"]))
    g = F.silu(contract(xg, p["wg"]))
    w_log = p["w0"] + contract(torch.tanh(contract(xw, p["w_lora_a"])),
                               p["w_lora_b"])
    w = heads(torch.exp(-torch.exp(w_log.float())))

    if q_lens is not None:
        valid = (torch.arange(S, device=x.device)[None, :]
                 < q_lens[:, None])[..., None, None]        # (B, S, 1, 1)
        w = torch.where(valid, w, torch.ones_like(w))
        k = torch.where(valid, k, torch.zeros_like(k))
    r, k, v = (constrain(t, cfg, ("batch", "seq", "heads", None))
               for t in (r, k, v))

    hm = lambda a: a.transpose(1, 2).contiguous()           # (B, H, S, hs)
    u = p["u"].float()
    if state is not None:
        o, Sn = ops.wkv6(hm(r), hm(k), hm(v), hm(w), u, chunk=chunk,
                         initial_state=state["wkv"], return_state=True)
    else:
        o = ops.wkv6(hm(r), hm(k), hm(v), hm(w), u, chunk=chunk)
        Sn = None
    o = flatten_last2(o.transpose(1, 2)).to(x.dtype)

    # per-head group norm
    of = heads(o).float()
    of = (of - of.mean(-1, keepdim=True)) * torch.rsqrt(
        of.var(-1, keepdim=True, correction=0) + 1e-5)
    o = (flatten_last2(of) * p["ln_x"].float()).to(x.dtype)

    y = constrain(contract(o * g, p["wo"]), cfg, _BSD)
    return y, {"shift": _shift_state(x, prev, q_lens), "wkv": Sn}


# --------------------------------------------------------------------------- #
# channel mix
# --------------------------------------------------------------------------- #
def init_rwkv_cmix(arch, dtype, *, generator, device, lead=()):
    d, f = arch.d_model, arch.d_ff
    kw = dict(generator=generator, device=device)
    return {
        "mu": torch.full((*lead, 2, d), 0.5, dtype=dtype, device=device),
        "wk": dense_init((*lead, d, f), dtype, fan_in=d, **kw),
        "wv": dense_init((*lead, f, d), dtype, fan_in=f, **kw),
        "wr": dense_init((*lead, d, d), dtype, fan_in=d, **kw),
    }


def rwkv_cmix(p: dict, x, arch, state: dict | None = None, q_lens=None,
              cfg: LayerConfig = R):
    """x: (B, S, D) -> (y, {"shift": (B, D)})."""
    prev = state["shift"] if state is not None else None
    sh = token_shift(x, prev)
    mu = p["mu"]
    xk = x + mu[0] * (sh - x)
    xr = x + mu[1] * (sh - x)
    k = torch.square(torch.relu(contract(xk, p["wk"])))
    k = constrain(k, cfg, ("batch", "seq", "d_ff"))
    v = contract(k, p["wv"])
    y = constrain(torch.sigmoid(contract(xr, p["wr"])) * v, cfg, _BSD)
    return y, {"shift": _shift_state(x, prev, q_lens)}


# --------------------------------------------------------------------------- #
# Mamba-1 selective SSM
# --------------------------------------------------------------------------- #
def init_mamba(arch, dtype, *, generator, device, lead=()):
    """The reference's layout and init rules: ``A_log`` and ``D`` stay
    float32 whatever ``dtype``; ``dt_bias`` is softplus^-1(0.01) = -4.6;
    ``conv_b`` is zeros."""
    d, di, N = arch.d_model, arch.d_inner, arch.ssm_state
    rank = max(1, math.ceil(d / 16))
    k = arch.ssm_conv
    kw = dict(generator=generator, device=device)
    A = torch.arange(1, N + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init((*lead, d, 2 * di), dtype, fan_in=d, **kw),
        "conv_w": dense_init((*lead, k, di), dtype, fan_in=k, **kw),
        "conv_b": torch.zeros((*lead, di), dtype=dtype, device=device),
        "x_proj": dense_init((*lead, di, rank + 2 * N), dtype, fan_in=di,
                             **kw),
        "dt_proj": dense_init((*lead, rank, di), dtype, fan_in=rank, **kw),
        "dt_bias": torch.full((*lead, di), -4.6, dtype=dtype, device=device),
        "A_log": torch.log(A).expand(*lead, di, N).contiguous(),
        "D": torch.ones((*lead, di), dtype=torch.float32, device=device),
        "out_proj": dense_init((*lead, di, d), dtype, fan_in=di, **kw),
    }


def _causal_conv1d(x, w, b, state=None):
    """x: (B, S, di); w: (k, di) depthwise; state: (B, k-1, di) carried.
    Returns (out, xp) with xp the state-prepended input (B, k-1+S, di); the
    caller takes its next conv state out of xp.  A sum of k shifted
    products, as the reference writes it (``F.conv1d`` would run a float32
    convolution through cuDNN in TF32 on the card)."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S, :] * w[i] for i in range(k)) + b
    return out, xp


def mamba_mix(p: dict, x, arch, state: dict | None = None, chunk: int = 64,
              q_lens=None, cfg: LayerConfig = R):
    """x: (B, S, D) -> (y, new_state).  state: {"conv": (B, k-1, di),
    "ssm": (B, di, N) float32}, updated in place (``copy_``) and returned;
    without ``state`` the returned ``new_state["ssm"]`` is None (training
    discards it, and the stateless scan is the TPU kernel's own form).

    q_lens: (B,) -- a mixed step: only row b's first ``q_lens[b]`` tokens
    are live.  Padding tokens get dt -> 0 (exp(0 A) = 1, zero input: the
    state passes through untouched) and the next conv window is gathered
    at each row's ``q_lens[b]`` (0 keeps the carried window)."""
    B, S, _ = x.shape
    di, N = arch.d_inner, arch.ssm_state
    rank = p["dt_proj"].shape[-2]
    kw = p["conv_w"].shape[-2]

    xz = contract(x, p["in_proj"])
    x1, z = torch.split(xz, di, dim=-1)
    if is_dtensor(xz):
        x1, z = x1.contiguous(), z.contiguous()
    x1 = constrain(x1, cfg, _BSD)
    conv_state = state["conv"] if state is not None else None
    x1, xp = _causal_conv1d(x1, p["conv_w"], p["conv_b"], conv_state)
    if q_lens is None:
        new_conv = xp[:, -(kw - 1):, :]
    else:
        gi = (q_lens.long()[:, None]
              + torch.arange(kw - 1, device=x.device)[None, :])
        new_conv = torch.gather(xp, 1, gi[..., None].expand(B, kw - 1, di))
    x1 = F.silu(x1)

    # on a mesh the two small projections' outputs are laid out by batch
    # and seq first (the port's own points): a partial sum over a split
    # d_inner or rank carried into the next product asks torch 2.11's
    # DTensor for a redistribute from a shard to a partial it lacks
    dbl = constrain(contract(x1, p["x_proj"]), cfg, ("batch", "seq", None))
    dt, Bm, Cm = torch.split(dbl, [rank, N, N], dim=-1)
    if is_dtensor(dbl):     # DTensor's matmul backward views its operands
        dt, Bm, Cm = dt.contiguous(), Bm.contiguous(), Cm.contiguous()
    dt = constrain(contract(dt, p["dt_proj"]), cfg, _BSD)
    dt = F.softplus(dt + p["dt_bias"])
    if q_lens is not None:
        valid = torch.arange(S, device=x.device)[None, :] < q_lens[:, None]
        dt = dt * valid[..., None].to(dt.dtype)
    A = -torch.exp(p["A_log"])                                # (di, N)

    # the scan's inputs stream in the activation dtype; the state
    # recurrence runs in float32 inside the kernel or the plain version
    if state is not None:
        y, hN = ops.mamba_scan(dt.to(x.dtype), Bm, Cm, x1, A, p["D"],
                               chunk=chunk, initial_state=state["ssm"],
                               return_state=True)
        state["conv"].copy_(new_conv)
        state["ssm"].copy_(hN)
        new_state = state
    else:
        y = ops.mamba_scan(dt.to(x.dtype), Bm, Cm, x1, A, p["D"],
                           chunk=chunk)
        new_state = {"conv": new_conv, "ssm": None}
    y = y * F.silu(z)
    return constrain(contract(y, p["out_proj"]), cfg, _BSD), new_state
