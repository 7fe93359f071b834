"""Deterministic, stateless-resumable synthetic data pipeline: a copy of
``repro.data.pipeline`` (numpy only).

Every batch is a pure function of ``(seed, step)``: restarting a run at
step ``k`` reproduces the exact stream with no data-loader state in the
checkpoint, and the port draws the same token arrays as the reference.

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


def make_dataset(arch, shape, seed: int = 0):
    """Dataset for an (arch, shape) cell.  The encoder-decoder and VLM
    datasets (frames, frontend embeddings) arrive with their models."""
    if arch.enc_layers or arch.frontend:
        raise NotImplementedError(
            f"{arch.name}: the encoder-decoder and VLM datasets arrive with "
            f"the VLM / encoder-decoder slice (ROADMAP.md)")
    return SyntheticLM(vocab=arch.vocab, batch=shape.global_batch,
                       seq_len=shape.seq_len, seed=seed)
