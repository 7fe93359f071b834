"""Step-atomic checkpointing with crash tolerance: the counterpart of
``repro.checkpoint.manager``, on the same layout, so a checkpoint written
by either package restores in the other.

Layout:  <dir>/step_<k>/{arrays.npz, MANIFEST.json}
  * arrays.npz -- every leaf of a nested dict of tensors, keyed by its
    path: the dict keys joined with ``/``, as
    ``jax.tree_util.tree_flatten_with_path`` names them;
  * MANIFEST.json -- step, per-leaf {shape, dtype, crc}; written LAST, so
    a step directory without a valid manifest is an interrupted write and
    is ignored (and garbage-collected) on restore.

Writes go to ``step_<k>.tmp`` and are atomically renamed: a crash at any
point leaves either the previous complete checkpoint or an ignorable tmp.
Restored leaves take the dtype, shape and device of the ``like`` tree.

On a realized plan (DTensor leaves, a process group) every rank gathers
the full tensors, rank 0 alone writes them, and a restore re-places each
leaf as its ``like`` leaf is laid out.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from pathlib import Path

import numpy as np

from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.core.sharding import is_dtensor, whole


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Path -> numpy leaf, in the reference's order (sorted dict keys)."""
    if isinstance(tree, dict):
        flat = {}
        for k in sorted(tree):
            flat.update(_flatten(tree[k], f"{prefix}{k}/"))
        return flat
    return {prefix[:-1]: params_to_numpy(whole(tree))}


def save_tree(tree, path: Path) -> None:
    np.savez(path, **_flatten(tree))


def _restore(like, data, prefix: str = ""):
    if isinstance(like, dict):
        return {k: _restore(v, data, f"{prefix}{k}/") for k, v in like.items()}
    arr = np.asarray(data[prefix[:-1]]).reshape(tuple(like.shape))
    t = params_from_jax(arr, like.device).to(like.dtype)
    if is_dtensor(like):
        from torch.distributed.tensor import distribute_tensor
        t = distribute_tensor(t, like.device_mesh, like.placements,
                              src_data_rank=None)
    return t


def restore_tree(like, path: Path):
    """Restore into the structure, dtypes and devices of ``like`` (a
    nested dict of tensors)."""
    with np.load(path) as data:
        return _restore(like, data)


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # ------------------------------------------------------------------ #
    def save(self, step: int, state: dict) -> Path:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        flat = _flatten(state)      # every rank: gathers realized leaves
        if _rank() != 0:
            _barrier()
            return final
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **flat)
        manifest = {
            "step": step,
            "leaves": {
                k: {"shape": list(v.shape), "dtype": str(v.dtype),
                    "crc": zlib.crc32(np.ascontiguousarray(v).tobytes())}
                for k, v in flat.items()
            },
        }
        with open(tmp / "MANIFEST.json", "w") as f:
            json.dump(manifest, f)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        _barrier()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
        for p in self.dir.glob("*.tmp"):
            shutil.rmtree(p, ignore_errors=True)

    # ------------------------------------------------------------------ #
    def all_steps(self) -> list[int]:
        steps = []
        for p in sorted(self.dir.glob("step_*")):
            if p.suffix == ".tmp":
                continue
            if not (p / "MANIFEST.json").exists():
                continue
            try:
                with open(p / "MANIFEST.json") as f:
                    m = json.load(f)
                steps.append(int(m["step"]))
            except (json.JSONDecodeError, KeyError, ValueError):
                continue
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like, *, verify: bool = True):
        path = self.dir / f"step_{step:08d}"
        with open(path / "MANIFEST.json") as f:
            manifest = json.load(f)
        state = restore_tree(like, path / "arrays.npz")
        if verify:
            flat = _flatten(state)
            for k, meta in manifest["leaves"].items():
                crc = zlib.crc32(np.ascontiguousarray(flat[k]).tobytes())
                if crc != meta["crc"]:
                    raise IOError(f"checkpoint corruption at leaf {k} "
                                  f"(crc {crc} != {meta['crc']})")
        return state

    def restore_latest(self, like, **kw):
        """Restore the newest complete checkpoint; returns (step, state) or
        (None, None) when no valid checkpoint exists."""
        for step in reversed(self.all_steps()):
            try:
                return step, self.restore(step, like, **kw)
            except Exception:  # noqa: BLE001 -- any corruption (bad zip,
                continue       # truncated npz, crc mismatch) falls back
        return None, None
