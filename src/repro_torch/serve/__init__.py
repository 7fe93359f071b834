"""Continuous-batching serving over a paged KV pool (chunked prefill
riding the mixed step, copy-on-write prefix sharing, int8 blocks) or
dense per-slot KV rows: the
counterpart of ``repro.serve``.  ``paging`` and ``scheduler`` are copies
of the reference's pure-Python modules."""

from .config import ServeConfig
from .engine import ServeEngine, copy_block, reset_slot_state, write_slot
from .fns import make_serve_fns
from .paging import (BlockAllocator, PoolExhausted, PrefixCache,
                     blocks_for_request)
from .scheduler import Completion, Request, SlotScheduler, SlotState

__all__ = ["BlockAllocator", "Completion", "PoolExhausted", "PrefixCache",
           "Request", "ServeConfig", "ServeEngine", "SlotScheduler",
           "SlotState", "blocks_for_request", "copy_block",
           "make_serve_fns", "reset_slot_state", "write_slot"]
