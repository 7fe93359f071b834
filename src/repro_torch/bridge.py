"""Move parameter and cache trees between the reference and the port.

The reference's trees (``repro.models.lm.init_lm`` parameters, and
``init_cache`` / ``init_paged_cache`` caches, after ``np.asarray`` on each
leaf) are nested dicts of numpy arrays; the port keeps the same nesting,
names and layouts (``wq (d, H, hd)``, ``wo (H, hd, d)``, the optional
``bq``/``bk``/``bv``, tied embeddings, int8 pools with ``k_scale`` /
``v_scale``), so the conversion is leaf by leaf and lossless both ways,
bfloat16 included (its bits move through a 16-bit integer view).
"""

from __future__ import annotations

import numpy as np
import torch


def _to_torch(a, device) -> torch.Tensor:
    # a copy: the port updates caches in place, and the source array may
    # be a read-only view of the reference's buffer
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes        # ships with jax; needed only for bf16 trees
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(np_tree, device) -> dict:
    """Nested dict of numpy arrays (a reference tree) -> the same tree of
    tensors on ``device``.  Works for parameter and cache trees alike."""
    if isinstance(np_tree, dict):
        return {k: params_from_jax(v, device) for k, v in np_tree.items()}
    return _to_torch(np_tree, device)


def params_to_numpy(tree) -> dict:
    """Inverse of :func:`params_from_jax`: tensors -> numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return _to_numpy(tree)
