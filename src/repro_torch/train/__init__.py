"""Training subsystem of the port: :class:`TrainConfig` and
:func:`make_train_step`, the counterparts of ``repro.train``'s."""

from .step import TrainConfig, make_train_step

__all__ = ["TrainConfig", "make_train_step"]
