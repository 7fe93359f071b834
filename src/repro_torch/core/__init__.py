"""Shared utilities of the port (the counterpart of ``repro.core``'s
array code; the search and cost model arrive with the plans slice)."""

from .scan import remat_time_scan

__all__ = ["remat_time_scan"]
