"""Synthetic data of the port: a copy of ``repro.data``."""

from .pipeline import SyntheticLM, SyntheticSeq2Seq, SyntheticVLM, make_dataset

__all__ = ["SyntheticLM", "SyntheticSeq2Seq", "SyntheticVLM", "make_dataset"]
