"""Checkpointing of the port: the counterpart of ``repro.checkpoint``,
with the same on-disk layout and keys."""

from .manager import CheckpointManager, restore_tree, save_tree

__all__ = ["CheckpointManager", "restore_tree", "save_tree"]
