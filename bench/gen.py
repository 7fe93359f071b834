"""The one traffic generator.  A traffic mix is a data file
``bench/traffic/<name>.json`` of parameters; its ``kind`` names the cell
driver (``bench/kinds/<kind>.py``) and this module turns the parameters
and ``--seed`` into inputs:

* ``"train"``: token batches (``batch`` x ``seq``), uniform over the
  vocabulary, drawn on the device one batch a step (:class:`TokenBatches`).

Every seed gives the same sizes; the token contents (and the weights)
come from ``--seed``.
"""

from __future__ import annotations

import hashlib


def sub_seed(seed: int, *parts) -> int:
    """A 63-bit seed for one stream of the run, from ``--seed`` and names."""
    key = ":".join(str(p) for p in (seed,) + parts).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


class TokenBatches:
    """Training batches: step ``i`` is (batch, seq) token ids on
    ``device``, the same for the same seed."""

    def __init__(self, traffic: dict, vocab: int, seed: int, device):
        import torch
        self.torch = torch
        self.shape = (traffic["batch"], traffic["seq"])
        self.vocab = vocab
        self.g = torch.Generator(device=device).manual_seed(
            sub_seed(seed, "batches"))
        self.device = device

    def next(self):
        return self.torch.randint(0, self.vocab, self.shape, generator=self.g,
                                  device=self.device)
