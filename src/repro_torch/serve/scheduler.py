"""Slot scheduling for the continuous-batching serve engine.

The engine owns a fixed pool of ``max_batch`` cache slots (rows of the
pooled KV / recurrent-state cache); this module owns the host-side
bookkeeping of which slot holds which request.  Two admission policies:

* ``"continuous"`` — a queued request is admitted the moment any slot is
  free, mid-decode of everything else (continuous batching: short
  requests retire early and their slots immediately take new work).
* ``"static"`` — requests are admitted only when the *whole* pool is
  drained, in arrival-order batches of up to ``max_batch`` (the lockstep
  prefill->decode oracle the old serve loop implemented; kept behind
  ``--no-continuous`` as the equivalence/throughput baseline).

Under a **paged** KV cache the binding resource is blocks, not slots:
construct with ``block_size``/``total_blocks`` and admission reserves
each request's worst-case block need
(:func:`repro_torch.serve.paging.blocks_for_request`) up front — many short
requests can coexist where few long ones fit, and a slot can never hit
an empty free list mid-decode (its lazy allocations draw from its own
reservation).  Reservations release on retire, so an EOS-at-short-length
hands its unused budget straight back to the queue.

**Prefix-cache credit** changes both sides of that ledger.  A request
whose leading prompt blocks are already in the pool reserves only the
blocks it will allocate *privately* (``admit(..., reserved=...)``, the
worst case minus the cached-prefix credit) — that is the whole
admission win: more concurrent requests fit because shared blocks are
charged once.  In exchange the budget must also charge the shared
blocks no reservation owns: ``pinned_blocks`` (wired to
``BlockAllocator.pinned_shared``) counts blocks kept alive only by
attached readers after their allocating owner retired, and
``free_block_budget`` subtracts it.  Soundness invariant: ``pinned +
sum(reservations) <= total_blocks`` — every private allocation draws
from its own reservation, so the free list (with retained-only blocks
evictable on demand) can never run dry mid-decode.

Everything here is pure Python — no torch.  The device-side work (prefill,
per-slot decode, slot writes) lives in :mod:`repro_torch.serve.engine`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .paging import blocks_for_request


@dataclass(frozen=True)
class Request:
    """One generation request.

    ``max_new_tokens`` counts every generated token, including the one
    sampled from the prefill logits; generation stops early when
    ``eos_id`` is produced (the EOS token is included in the output).
    """
    uid: int
    prompt: tuple[int, ...]
    max_new_tokens: int
    eos_id: int | None = None

    def __post_init__(self):
        object.__setattr__(self, "prompt",
                           tuple(int(t) for t in self.prompt))
        if not self.prompt:
            raise ValueError(f"request {self.uid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.uid}: max_new_tokens must "
                             f"be >= 1, got {self.max_new_tokens}")


@dataclass
class Completion:
    uid: int
    tokens: list[int]
    prompt_len: int
    finish_reason: str            # "eos" | "length"


@dataclass
class SlotState:
    """Device-slot bookkeeping for one in-flight request: ``pos`` is the
    next cache write position (== tokens currently in the slot's cache
    row), ``generated`` the tokens sampled so far, ``reserved_blocks``
    the worst-case block budget held under a paged cache.

    Under chunked (mixed-step) admission ``prefill_remaining`` counts the
    prompt tokens not yet fed through the model — the slot decodes only
    once it reaches 0; ``seq`` is the scheduler's monotone admission
    counter, used to grant the per-step prefill budget oldest-first."""
    request: Request
    pos: int
    generated: list[int] = field(default_factory=list)
    reserved_blocks: int = 0
    prefill_remaining: int = 0
    seq: int = 0


class SlotScheduler:
    """Assigns queued requests to free cache slots under a policy,
    optionally bounded by a paged-cache block budget."""

    POLICIES = ("continuous", "static")

    def __init__(self, max_batch: int, policy: str = "continuous", *,
                 block_size: int = 0, total_blocks: int = 0,
                 max_len: int = 0, pinned_blocks=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if policy not in self.POLICIES:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"expected one of {self.POLICIES}")
        self.max_batch = max_batch
        self.policy = policy
        self.block_size = int(block_size)
        self.total_blocks = int(total_blocks)   # usable (trash excluded)
        self.max_len = int(max_len)
        # shared prefix blocks alive with no owning reservation — charged
        # against the budget; the engine wires this to the allocator's
        # live ``pinned_shared`` count
        self.pinned_blocks = pinned_blocks or (lambda: 0)
        self._slots: list[SlotState | None] = [None] * max_batch
        self._seq = 0                      # monotone admission counter

    def blocks_for(self, request: Request) -> int:
        """Worst-case block reservation for ``request`` (0 when block
        accounting is off — slot-only admission)."""
        if not self.block_size:
            return 0
        return blocks_for_request(len(request.prompt),
                                  request.max_new_tokens,
                                  self.max_len, self.block_size)

    @property
    def reserved_blocks(self) -> int:
        return sum(s.reserved_blocks for s in self._slots if s is not None)

    @property
    def free_block_budget(self) -> int:
        return (self.total_blocks - self.reserved_blocks
                - self.pinned_blocks())

    # ---------------------------------------------------------------- #
    @property
    def active(self) -> dict[int, SlotState]:
        """slot -> state for every occupied slot (ascending slot order)."""
        return {i: s for i, s in enumerate(self._slots) if s is not None}

    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def state(self, slot: int) -> SlotState:
        st = self._slots[slot]
        if st is None:
            raise KeyError(f"slot {slot} is free")
        return st

    # ---------------------------------------------------------------- #
    def admissible(self, queued: int) -> int:
        """How many of ``queued`` waiting requests may be admitted now
        (slot accounting only — the pre-paging form, kept for callers
        without request visibility)."""
        free = len(self.free_slots())
        if self.policy == "continuous":
            return min(free, queued)
        # static: only form a fresh batch once the pool is fully drained
        return min(free, queued) if free == self.max_batch else 0

    def admissible_requests(self, requests, need_fn=None) -> int:
        """How many of ``requests`` (the queue, FCFS order) may be
        admitted now: bounded by free slots and, under block accounting,
        by the unreserved block budget.  Admission stays in arrival
        order — the count stops at the first request that does not fit,
        so a large request is never starved by later small ones.

        ``need_fn(request) -> int`` overrides the worst-case
        :meth:`blocks_for` charge; the prefix-caching engine passes its
        effective need (worst case minus cached-prefix credit, plus the
        matched blocks an admit would newly pin)."""
        limit = self.admissible(len(requests))
        if not self.block_size:
            return limit
        need_fn = need_fn or self.blocks_for
        budget = self.free_block_budget
        n = 0
        for req in list(requests)[:limit]:
            need = need_fn(req)
            if need > budget:
                break
            budget -= need
            n += 1
        return n

    def admit(self, request: Request, *, chunked: bool = False,
              reserved: int | None = None, cached_len: int = 0) -> int:
        """Place ``request`` in the lowest free slot (reserving its block
        budget under block accounting); returns the slot.

        With ``chunked=True`` the prompt is NOT assumed prefilled: the
        slot starts with the prompt outstanding in ``prefill_remaining``,
        to be fed through mixed steps chunk by chunk
        (:meth:`prefill_grants`).  ``cached_len`` prompt tokens already
        sit in attached shared blocks (prefix-cache hit): the slot
        starts at ``pos=cached_len`` and only prefills the rest.
        ``reserved`` overrides the worst-case block reservation with the
        request's *private* need (worst case minus cached credit)."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slot")
        need = self.blocks_for(request) if reserved is None else reserved
        if self.block_size and need > self.free_block_budget:
            raise RuntimeError(
                f"request {request.uid} needs {need} blocks but only "
                f"{self.free_block_budget} are unreserved")
        slot = free[0]
        plen = len(request.prompt)
        if not chunked and cached_len:
            raise ValueError("cached_len requires chunked admission")
        self._slots[slot] = SlotState(
            request=request,
            pos=cached_len if chunked else plen,
            reserved_blocks=need,
            prefill_remaining=plen - cached_len if chunked else 0,
            seq=self._seq)
        self._seq += 1
        return slot

    def prefill_grants(self, budget: int) -> dict[int, int]:
        """Mixed-step token-budget policy: which slots prefill how many
        prompt tokens this step.

        The whole per-step budget goes to ONE slot — the oldest admission
        (lowest ``seq``) still holding prompt tokens — as
        ``min(remaining, budget)``.  Concentrating the budget keeps the
        jit step-width buckets bounded ({1, budget} plus per-prompt
        remainders, all enumerable from the warmup prompt lengths) and
        finishes prompts in admission order.  Returns {} when the budget
        is off (<= 0) or nothing is waiting to prefill."""
        if budget <= 0:
            return {}
        waiting = [(s.seq, slot) for slot, s in self.active.items()
                   if s.prefill_remaining > 0]
        if not waiting:
            return {}
        _, slot = min(waiting)
        st = self.state(slot)
        return {slot: min(st.prefill_remaining, budget)}

    def retire(self, slot: int) -> SlotState:
        """Free ``slot``; returns its final state."""
        st = self.state(slot)
        self._slots[slot] = None
        return st
