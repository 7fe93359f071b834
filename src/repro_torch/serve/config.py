"""``ServeConfig``: the serve engine's knobs in one validated dataclass,
the counterpart of ``repro.serve.config`` with a torch dtype and without
the reference's prefill query-chunk size (the flash kernel's tiles are
fixed)."""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .paging import PrefixCache
from .scheduler import SlotScheduler


@dataclass(frozen=True)
class ServeConfig:
    """Engine-level serving configuration.

    * ``max_batch`` — cache slot pool size (max in-flight requests).
    * ``max_len`` — per-request cache row budget (prompt + generation).
    * ``policy`` — ``"continuous"`` (admit into any free slot mid-decode)
      or ``"static"`` (lockstep batches, the oracle).
    * ``kv_block_size`` — tokens per paged-KV block; 0 / None is the
      dense per-slot layout (one ``max_len`` row per slot).
    * ``kv_pool_blocks`` — usable blocks in the pool (None = dense-
      equivalent capacity ``max_batch * ceil(max_len / block)``).
    * ``prefill_chunk_tokens`` — per-step prompt-token budget of the
      mixed step (None = two KV blocks paged, 256 dense; 0 = stall-the-
      world prefill).
    * ``dtype`` — cache / activation dtype.
    * ``prefix_cache`` — share identical whole prompt blocks through the
      refcounted copy-on-write prefix index; effective with the paged
      cache and chunked prefill, inert otherwise.
    * ``prefix_evict`` — ``"lru"`` keeps published blocks warm after
      their users retire, ``"none"`` shares only between live requests.
    * ``kv_quant`` — ``"int8"`` stores pool blocks as int8 with per-(slot,
      head) f32 scales (quantize on write, dequantize on read).
    * ``kernel_backend`` — force a kernel dispatch backend (``"cuda"``,
      ``"xla"``, ``"ref"``) around every prefill and step, a preference
      (:mod:`repro_torch.kernels.dispatch`); None auto-selects.
    """

    max_batch: int
    max_len: int
    policy: str = "continuous"
    kv_block_size: int | None = 128
    kv_pool_blocks: int | None = None
    prefill_chunk_tokens: int | None = None
    dtype: torch.dtype = field(default=torch.float32, repr=False)
    prefix_cache: bool = True
    prefix_evict: str = "lru"
    kv_quant: str | None = None
    kernel_backend: str | None = None

    KV_QUANT = (None, "none", "int8")

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {self.max_len}")
        if self.policy not in SlotScheduler.POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}; expected "
                             f"one of {SlotScheduler.POLICIES}")
        if self.prefix_evict not in PrefixCache.EVICTION:
            raise ValueError(
                f"unknown prefix_evict {self.prefix_evict!r}; expected "
                f"one of {PrefixCache.EVICTION}")
        if self.kv_block_size and self.kv_block_size < 0:
            raise ValueError(f"kv_block_size must be >= 0, "
                             f"got {self.kv_block_size}")
        if self.kv_quant not in self.KV_QUANT:
            raise ValueError(f"unknown kv_quant {self.kv_quant!r}; "
                             f"expected one of {self.KV_QUANT}")
        if (self.kv_quant not in (None, "none")
                and not self.kv_block_size):
            raise ValueError(
                "kv_quant requires the paged KV cache (kv_block_size > 0); "
                "the dense per-slot rows are always fp")
