"""Optimizer of the port: the counterpart of ``repro.optim``."""

from .adamw import (AdamWConfig, adamw_init, adamw_update, cosine_schedule,
                    global_norm, zero1_state_pspecs)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "zero1_state_pspecs"]
