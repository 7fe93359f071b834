"""Attention kernels of the port: hand-written CUDA for ``sm_90a``
(``csrc/``), each with its plain PyTorch version (``ref``), routed by
device in ``ops``."""
