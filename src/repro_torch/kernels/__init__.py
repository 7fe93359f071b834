"""Kernels of the port (attention, MoE dispatch, WKV6, the selective
scan): hand-written CUDA for ``sm_90a`` (``csrc/``), each with its plain
PyTorch version (``ref``), routed by device in ``ops``."""
