"""Training subsystem of the port: :class:`TrainConfig` and
:func:`make_train_step`, the counterparts of ``repro.train``'s, and
:func:`realize`, which lays a train state out on a mesh."""

from .step import TrainConfig, make_train_step, realize

__all__ = ["TrainConfig", "make_train_step", "realize"]
