"""Deterministic, stateless-resumable synthetic data pipeline: a copy of
``repro.data.pipeline`` (numpy only), with its encoder-decoder
(``frames``) and VLM (``frontend``) datasets.

Every batch is a pure function of ``(seed, step)``: restarting a run at
step ``k`` reproduces the exact stream with no data-loader state in the
checkpoint, and the port draws the same arrays as the reference.

The token stream has learnable structure (a noisy affine bigram process:
``x[t+1] = (a * x[t] + b) mod V`` with probability ``1-noise``) so small
models visibly learn in the end-to-end example.

``batch_at(step, host_index, host_count)`` returns one host's slice of
the global batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    noise: float = 0.1

    def _rng(self, step: int, host_index: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, host_index]))

    def batch_at(self, step: int, host_index: int = 0,
                 host_count: int = 1) -> dict:
        b = self.batch // host_count
        rng = self._rng(step, host_index)
        a = 31
        c = 17
        x = np.empty((b, self.seq_len), np.int32)
        x[:, 0] = rng.integers(0, self.vocab, size=b)
        noise = rng.random((b, self.seq_len)) < self.noise
        rand = rng.integers(0, self.vocab, size=(b, self.seq_len))
        for t in range(1, self.seq_len):
            nxt = (a * x[:, t - 1] + c) % self.vocab
            x[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        return {"tokens": x}


@dataclass(frozen=True)
class SyntheticSeq2Seq(SyntheticLM):
    d_model: int = 0
    enc_len: int = 0

    def batch_at(self, step: int, host_index: int = 0,
                 host_count: int = 1) -> dict:
        out = super().batch_at(step, host_index, host_count)
        b = self.batch // host_count
        rng = self._rng(step, host_index + 10_000)
        out["frames"] = rng.standard_normal(
            (b, self.enc_len, self.d_model)).astype(np.float32)
        return out


@dataclass(frozen=True)
class SyntheticVLM(SyntheticLM):
    d_model: int = 0
    frontend_tokens: int = 0

    def batch_at(self, step: int, host_index: int = 0,
                 host_count: int = 1) -> dict:
        out = super().batch_at(step, host_index, host_count)
        b = self.batch // host_count
        rng = self._rng(step, host_index + 20_000)
        out["frontend"] = rng.standard_normal(
            (b, self.frontend_tokens, self.d_model)).astype(np.float32)
        return out


def make_dataset(arch, shape, seed: int = 0):
    """Dataset for an (arch, shape) cell."""
    if arch.enc_layers:
        return SyntheticSeq2Seq(
            vocab=arch.vocab, batch=shape.global_batch,
            seq_len=shape.seq_len // 2, seed=seed, d_model=arch.d_model,
            enc_len=shape.seq_len // 2)
    if arch.frontend:
        return SyntheticVLM(
            vocab=arch.vocab, batch=shape.global_batch,
            seq_len=shape.seq_len - arch.frontend_tokens, seed=seed,
            d_model=arch.d_model, frontend_tokens=arch.frontend_tokens)
    return SyntheticLM(vocab=arch.vocab, batch=shape.global_batch,
                       seq_len=shape.seq_len, seed=seed)
