"""The plain reference of the optimizer every training cell states:
AdamW over a parameter tree in the benchmark's layout, in plain PyTorch,
with nothing of the program under test.  Shared by the model references
(``bench/reference/<reference>.py``).

Imports torch alone: nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import math

import torch


def leaves(tree, path=()):
    """(path, tensor) of every leaf, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, tree


class AdamW:
    """AdamW as the configuration's optimizer states it: global-norm
    clipping, bias-corrected moments, eps outside the root, decoupled
    weight decay on every leaf, linear warmup then a cosine schedule."""

    def __init__(self, params: dict, opt: dict):
        self.o = opt
        self.params = [t for _, t in leaves(params)]
        self.m = [torch.zeros_like(t) for t in self.params]
        self.v = [torch.zeros_like(t) for t in self.params]
        self.t = 0

    def lr(self, t: int) -> float:
        o = self.o
        if t < o["warmup_steps"]:
            return o["lr"] * t / max(1.0, o["warmup_steps"])
        prog = min(1.0, max(0.0, (t - o["warmup_steps"])
                            / max(1.0, o["total_steps"] - o["warmup_steps"])))
        return o["lr"] * (o["min_lr_ratio"] + (1 - o["min_lr_ratio"]) * 0.5
                          * (1 + math.cos(math.pi * prog)))

    @torch.no_grad()
    def step(self, grads: list):
        """Applies one update, consuming ``grads`` (each entry is freed
        once used, so the update needs no second copy of the gradients);
        returns the norm of each leaf's clipped gradient."""
        o = self.o
        self.t += 1
        gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
        scale = torch.clamp(o["clip_norm"] / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        lr = self.lr(self.t)
        bc1, bc2 = 1 - o["b1"] ** self.t, 1 - o["b2"] ** self.t
        norms = []
        for i, (p, m, v) in enumerate(zip(self.params, self.m, self.v)):
            g = grads[i].mul_(scale)
            grads[i] = None
            norms.append(g.norm())
            m.mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
            v.mul_(o["b2"]).addcmul_(g, g, value=1 - o["b2"])
            del g
            d = (m / bc1).div_((v / bc2).sqrt_().add_(o["eps"]))
            p.sub_(d.add_(p, alpha=o["weight_decay"]), alpha=lr)
        return norms
