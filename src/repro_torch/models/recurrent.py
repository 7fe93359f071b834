"""RWKV6 (Finch) time mix and channel mix: the counterparts of
``repro.models.recurrent``'s RWKV functions.

Parameters are dicts of tensors in the reference's layouts (``mu (5, d)``,
``wr (d, d)`` .. ``u (H, hs)``), so the bridge moves them across
unchanged.  The WKV6 recurrence runs through
:func:`repro_torch.kernels.ops.wkv6` in the head-major ``(B, H, T, N)``
layout: the CUDA kernel for the stateless (training) form on the card, the
plain version otherwise.  The decay ``w = exp(-exp(w_log))`` and the state
stay float32 whatever the activation dtype (``w`` compounds over
thousands of steps).

The carried-state form (``state``, ``q_lens``) is the reference's serving
form; the port computes it with the plain recurrence, and serving an RWKV
model (cache init, prefill, step) arrives with the RWKV6 serve slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from .layers import dense_init


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
              q_lens=None):
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

    r = (xr @ p["wr"]).reshape(B, S, H, hs)
    k = (xk @ p["wk"]).reshape(B, S, H, hs)
    v = (xv @ p["wv"]).reshape(B, S, H, hs)
    g = F.silu(xg @ p["wg"])
    w_log = p["w0"] + torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    w = torch.exp(-torch.exp(w_log.float())).reshape(B, S, H, hs)

    if q_lens is not None:
        valid = (torch.arange(S, device=x.device)[None, :]
                 < q_lens[:, None])[..., None, None]        # (B, S, 1, 1)
        w = torch.where(valid, w, torch.ones_like(w))
        k = torch.where(valid, k, torch.zeros_like(k))

    hm = lambda a: a.transpose(1, 2).contiguous()           # (B, H, S, hs)
    u = p["u"].float()
    if state is not None:
        o, Sn = ops.wkv6(hm(r), hm(k), hm(v), hm(w), u, chunk=chunk,
                         initial_state=state["wkv"], return_state=True)
    else:
        o = ops.wkv6(hm(r), hm(k), hm(v), hm(w), u, chunk=chunk)
        Sn = None
    o = o.transpose(1, 2).reshape(B, S, D).to(x.dtype)

    # per-head group norm
    of = o.reshape(B, S, H, hs).float()
    of = (of - of.mean(-1, keepdim=True)) * torch.rsqrt(
        of.var(-1, keepdim=True, correction=0) + 1e-5)
    o = (of.reshape(B, S, D) * p["ln_x"].float()).to(x.dtype)

    y = (o * g) @ p["wo"]
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


def rwkv_cmix(p: dict, x, arch, state: dict | None = None, q_lens=None):
    """x: (B, S, D) -> (y, {"shift": (B, D)})."""
    prev = state["shift"] if state is not None else None
    sh = token_shift(x, prev)
    mu = p["mu"]
    xk = x + mu[0] * (sh - x)
    xr = x + mu[1] * (sh - x)
    k = torch.square(torch.relu(xk @ p["wk"]))
    v = k @ p["wv"]
    y = torch.sigmoid(xr @ p["wr"]) * v
    return y, {"shift": _shift_state(x, prev, q_lens)}
