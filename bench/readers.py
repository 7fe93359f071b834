"""Arithmetic that several metric readers share: model work per token,
by the frozen yardstick, and sums over a traced slice."""

from __future__ import annotations

from bench import yardstick


def model_flops_per_token(cfg: dict, train: bool) -> float:
    """2 x (6 x training) the active matrix-product weights."""
    return (6 if train else 2) * yardstick.active_matmul_params(cfg)


def kernel_seconds(run, part: str) -> float:
    return sum(v[0] for name, v in run.slice.kernels.items() if part in name)


def share(num: float, den: float):
    """A percentage, or None where the denominator is empty."""
    return 100.0 * num / den if den > 0 else None
