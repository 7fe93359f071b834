"""AdamW + cosine schedule + global-norm clipping: the counterpart of
``repro.optim.adamw``.

The state is the reference's tree: ``{"m", "v", "step"}`` with float32
moments of the parameters' shapes and a 0-d int32 ``step``, so the bridge
and the checkpoint move it across unchanged.  Every scalar (learning
rate, clip scale, bias corrections) is a float32 tensor on the
parameters' device, so a step never waits on the host.

:func:`adamw_update` updates the parameters and the state in place (the
reference donates both buffers to its jitted step) and returns them.
ZeRO-1 shardings of the moments arrive with the plans slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.sharding import P, whole
from repro_torch.plans.shardings import distribute, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine down to
    ``min_lr_ratio * lr`` at ``total_steps``; float32."""
    step = torch.as_tensor(step).float()
    warm = step / max(1.0, cfg.warmup_steps)
    prog = (step - cfg.warmup_steps) / max(
        1.0, cfg.total_steps - cfg.warmup_steps)
    prog = prog.clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def adamw_init(params, moment_shardings=None) -> dict:
    """Zero moments (float32) and step.  ``moment_shardings`` (a tree of
    ``NamedSharding``, e.g. ``to_shardings`` of
    :func:`zero1_state_pspecs`) lays the moments out as DTensors."""
    device = next(_leaves(params)).device
    m, v = _zeros_like(params), _zeros_like(params)
    if moment_shardings is not None:
        m = distribute(m, moment_shardings)
        v = distribute(v, moment_shardings)
    return {"m": m, "v": v,
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """The norm over every leaf (a realized leaf's partial sums gathered
    into a plain scalar)."""
    return torch.sqrt(torch.stack(
        [whole(x.float().square().sum()) for x in _leaves(tree)]).sum())


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig):
    """One AdamW step.  ``grads`` has the tree of ``params``.  Updates
    ``params`` and ``state`` in place; returns (params, state, metrics)
    with the metrics ``grad_norm`` (before clipping) and ``lr``."""
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)

    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    t = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=t.device), t)

    for p, g, m, v in zip(_leaves(params), _leaves(grads),
                          _leaves(state["m"]), _leaves(state["v"])):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


# --------------------------------------------------------------------------- #
# ZeRO-1: shard the moments over the data axes
# --------------------------------------------------------------------------- #
def zero1_state_pspecs(param_pspecs, params_shapes,
                       data_axes: tuple[str, ...],
                       mesh_axis_sizes: dict[str, int]):
    """Given the params' spec tree and a matching tree of their shapes
    (or of leaves with a ``shape``), return the moments' specs: the data
    axes (those not already used) added on the largest dim whose entry is
    free and whose size the data degree divides."""
    def one(spec, leaf):
        shape = tuple(getattr(leaf, "shape", leaf))
        if not shape:
            return spec
        entries = list(spec) + [None] * (len(shape) - len(spec))
        used = set()
        for e in entries:
            if e is None:
                continue
            used.update(e if isinstance(e, tuple) else (e,))
        free_axes = tuple(a for a in data_axes if a not in used)
        deg = (math.prod(mesh_axis_sizes[a] for a in free_axes)
               if free_axes else 1)
        if deg <= 1:
            return spec
        cands = [(shape[i], i) for i in range(len(shape))
                 if entries[i] is None and shape[i] % deg == 0]
        if not cands:
            return spec
        _, i = max(cands)
        entries[i] = free_axes if len(free_axes) > 1 else free_axes[0]
        return P(*entries)

    return tree_map(one, param_pspecs, params_shapes)
