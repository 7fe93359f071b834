"""Synthetic data of the port: a copy of ``repro.data``."""

from .pipeline import SyntheticLM, make_dataset

__all__ = ["SyntheticLM", "make_dataset"]
