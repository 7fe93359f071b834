"""Kernels of the port (attention, WKV6): hand-written CUDA for ``sm_90a``
(``csrc/``), each with its plain PyTorch version (``ref``), routed by
device in ``ops``."""
