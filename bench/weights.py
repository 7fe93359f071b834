"""Weights of a configuration, drawn on the device from ``--seed``.

The tree has the layout that the configuration's plain reference states
(``bench/reference/<reference>.py::shapes``), which is the layout the
port takes; the reference reads the same tree.  Each leaf comes from a
generator of its own, seeded from the run's seed and the leaf's path, in
one call: so a single leaf can be drawn again alone (:func:`leaf`), as
the train cell's check of the first updates does.
"""

from __future__ import annotations

import hashlib

import torch

from bench import core


def shapes(cfg: dict) -> dict:
    """path -> (shape, std or 0.0 for zeros, dtype name)."""
    return core.reference(cfg).shapes(cfg)


def _seed(seed: int, path) -> int:
    h = hashlib.sha256(f"{seed}:{'/'.join(path)}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def leaf(cfg: dict, seed: int, path, device) -> torch.Tensor:
    shape, std, dt = shapes(cfg)[tuple(path)]
    dtype = getattr(torch, dt)
    if std == 0.0:
        return torch.zeros(shape, dtype=dtype, device=device)
    g = torch.Generator(device=device).manual_seed(_seed(seed, path))
    return torch.randn(shape, generator=g, device=device,
                       dtype=dtype).mul_(std)


def make(cfg: dict, seed: int, device) -> dict:
    tree: dict = {}
    for path in shapes(cfg):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf(cfg, seed, path, device)
    return tree
