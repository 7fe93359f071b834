"""Device selection and the float32 matmul settings the reference needs.

Entry points run on ``cuda`` unless the caller asks for ``cpu``.  With no
GPU and no explicit ``cpu`` they raise: a silent CPU run would report CPU
numbers under a device's name.  ``meta`` (tensors without data, which
stand for the card's in the dry run, ``launch/dryrun.py``) is taken on
every host: nothing runs on it.

TF32 is switched off for matmuls and cuDNN: the JAX reference computes in
full float32, and TF32 keeps about three decimal digits.
"""

from __future__ import annotations

import torch


def set_precision() -> None:
    """Full-float32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    set_precision()
    return dev
