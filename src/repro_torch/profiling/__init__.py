"""Measured device profiles: the profiling subsystem that calibrates the
cost model from the card (the port's counterpart of ``repro.profiling``).

The paper's execution simulator runs on *measured* per-layer times and
per-connection bandwidths (Section 4); this package is that measurement
layer for the port.  :mod:`~repro_torch.profiling.microbench` times real
executions on the card (chip roofline at the port's float32, the
kernel backends through the dispatcher, collectives over
``torch.distributed`` process groups); :mod:`~repro_torch.profiling.profile`
persists them as the reference's versioned :class:`DeviceProfile` JSON;
:meth:`repro_torch.core.cost_model.CostModel.from_profile` consumes one,
field by field, falling back to the analytic constants for anything the
profile lacks.  :mod:`~repro_torch.profiling.calibration` closes the loop
with a predicted-vs-measured per-layer report.
"""

from .calibration import format_layer_report, layer_report
from .microbench import build_profile, measure_collectives, measure_kernels
from .profile import (CollectiveCurve, DeviceProfile, ProfileError,
                      ProfileFormatError, default_profile_path,
                      fit_alpha_beta, load_profile, profile_dir)

__all__ = [
    "CollectiveCurve",
    "DeviceProfile",
    "ProfileError",
    "ProfileFormatError",
    "build_profile",
    "default_profile_path",
    "fit_alpha_beta",
    "format_layer_report",
    "layer_report",
    "load_profile",
    "measure_collectives",
    "measure_kernels",
    "profile_dir",
]
