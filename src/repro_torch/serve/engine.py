"""Continuous-batching serve engine: the counterpart of
``repro.serve.engine``.

* Paged (``kv_block_size > 0``, the default): KV lives in one pool of
  fixed-size blocks plus a per-slot block table; blocks bind lazily as a
  slot's position crosses a block boundary and return to the free list
  on retire.  Physical block 0 is the trash block that free slots'
  ignored writes land in.
* Dense (``kv_block_size=0``): one ``max_len`` KV row per slot; a
  stall-the-world admission overwrites the slot's whole row.
* Every step runs all ``max_batch`` slots as one ragged mixed batch:
  decoding slots advance one token, the oldest admitted slot still
  prefilling advances a prompt chunk of up to ``prefill_chunk_tokens``.
  ``prefill_chunk_tokens=0`` is stall-the-world admission (a batch-1
  prefill through the flash kernel, then a slot write).
* Identical whole prompt blocks are shared between requests through the
  refcounted copy-on-write prefix index (paged, chunked and
  attention-only stacks; requested on a Mamba hybrid it stays off).
* Recurrent (Mamba, RWKV6) state is slot-dense in both layouts:
  admission zeroes or overwrites the slot's rows.  A stack without
  attention (RWKV6) has no KV to page: it takes the dense layout whatever
  ``kv_block_size`` says, and ``kv_quant`` is inert there.
* Slots retire on EOS or ``max_new_tokens`` and take new work at once
  (``"continuous"``) or when the pool drains (``"static"``).
* A plan (``plan=``, a ``ParallelPlan`` or ``ModelPlan``) is checked
  against the arch and resolved per phase, as the reference's is; on one
  device it places nothing.
* A frontend arch (a VLM) is served on text prompts alone: the engine
  passes no ``frontend``, as the reference's does.  An encoder-decoder
  raises (``launch/serve.py`` serves it in lockstep).

The cache is updated in place (the reference donated it to jit).
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from repro_torch.kernels.quant import quantize_kv
from repro_torch.models import is_encdec, lm
from repro_torch.models.arch import ArchConfig
from repro_torch.models.plan import ModelPlan
from repro_torch.plans.parallel_plan import ParallelPlan

from .config import ServeConfig
from .fns import _is_kv_path, make_serve_fns
from .paging import BlockAllocator, PoolExhausted, PrefixCache
from .scheduler import Completion, Request, SlotScheduler


def write_slot(pool: dict, row: dict, slot, block_ids=None) -> dict:
    """Admission write, in place: land a batch-1 prefill cache ``row``.

    Dense (``block_ids=None``): every leaf is (n_units, B, ...) against
    the row's (n_units, 1, ...); slot ``slot``'s whole row is replaced,
    positions past the prompt included, so nothing of its previous
    occupant survives.

    Paged: the row's KV leaves (n_units, 1, nb * block_size, KH, hd), the
    prompt rounded up to whole blocks, land in pool blocks ``block_ids``
    ((nb,) int64), each overwritten in full.  An int8 pool quantizes the
    row's K/V on write and scatters payload and scale rows into the same
    blocks; any other leaf takes the slot-row overwrite at ``slot``."""
    nb = 0 if block_ids is None else block_ids.shape[0]
    for path, p in lm.tree_leaves(pool):
        r = row
        for key in path[:-1]:
            r = r[key]
        name = path[-1]
        if block_ids is None or not _is_kv_path(path):
            p[:, slot] = r[name][:, 0].to(p.dtype)
            continue
        n, _, bs = p.shape[:3]
        if name in ("k_scale", "v_scale"):
            _, s = quantize_kv(r[name[0]][:, 0])           # (n, nb*bs, KH)
            p[:, block_ids] = s.reshape(n, nb, bs, *s.shape[2:]).to(p.dtype)
            continue
        x = r[name][:, 0]
        if p.dtype == torch.int8:
            x, _ = quantize_kv(x)
        p[:, block_ids] = x.reshape(n, nb, bs, *p.shape[3:]).to(p.dtype)
    return pool


def copy_block(pool: dict, src: int, dst: int) -> dict:
    """Copy-on-write, in place: duplicate physical KV block ``src`` into
    ``dst`` across every unit's K and V pool (payload and scales)."""
    for path, p in lm.tree_leaves(pool):
        if _is_kv_path(path):
            p[:, dst] = p[:, src]
    return pool


def reset_slot_state(cache: dict, slot: int) -> dict:
    """Chunked-admission hygiene, in place: zero slot ``slot``'s
    non-KV (recurrent) state leaves, so a new request's Mamba or RWKV6
    state starts from zero.  KV leaves are left alone: stale KV beyond a request's
    frontier is masked by ``kv_len``.  (A dense arch has no such leaves;
    the call keeps the reference's admission sequence.)"""
    for path, leaf in lm.tree_leaves(cache):
        if not _is_kv_path(path):
            leaf[:, slot] = 0
    return cache


class ServeEngine:
    """Drives generation over the paged KV pool or the dense slot rows.

    Usage::

        engine = ServeEngine(params, arch,
                             ServeConfig(max_batch=8, max_len=4096))
        engine.warmup([64, 128])
        completions = engine.run(requests)

    or incrementally (``submit`` between ``step`` calls admits mid-decode
    under the continuous policy).  The device is that of ``params``.

    ``itl_samples`` records per-step wall seconds for every step at whose
    entry at least one slot was mid-decode; under stall-the-world
    admission the prefill stall lands in those samples.
    """

    def __init__(self, params, arch: ArchConfig, config: ServeConfig, *,
                 plan: ParallelPlan | ModelPlan | None = None):
        if is_encdec(arch):
            raise NotImplementedError(
                "ServeEngine covers decoder-only LMs; encoder-decoder "
                "serving uses the static driver path")
        self.params = params
        self.arch = arch
        self.config = config
        self.device = params["embed"]["table"].device
        self.max_batch = int(config.max_batch)
        self.max_len = int(config.max_len)
        self.dtype = config.dtype
        # paging applies to KV only: a stack without attention (RWKV6)
        # serves from the dense slot layout, and int8 KV is inert there
        has_attn = any(spec.mixer == "attn" for spec in arch.pattern)
        self.block_size = int(config.kv_block_size or 0) if has_attn else 0
        self.paged = self.block_size > 0
        kvq = config.kv_quant or "none"
        self.kv_quant = kvq if (self.paged and kvq != "none") else None
        if config.prefill_chunk_tokens is None:
            self.chunk = 2 * self.block_size if self.paged else 256
        else:
            self.chunk = max(0, int(config.prefill_chunk_tokens))
        self.chunk = min(self.chunk, self.max_len)
        self.chunked = self.chunk > 0
        # phase-aware, as the reference's: prefill under the plan's
        # prefill phase, the mixed step under its decode phase; on one
        # device neither places anything
        self.plan = plan
        self._prefill, self._step = make_serve_fns(arch, plan)
        if self.paged:
            pages = -(-self.max_len // self.block_size)
            usable = (int(config.kv_pool_blocks) if config.kv_pool_blocks
                      else self.max_batch * pages)
            self._alloc = BlockAllocator(usable + 1, self.block_size,
                                         self.max_batch, pages)
            self.cache = lm.init_paged_cache(
                arch, usable + 1, self.block_size, self.max_batch,
                self.dtype, kv_quant=self.kv_quant, device=self.device)
            self.scheduler = SlotScheduler(
                self.max_batch, config.policy, block_size=self.block_size,
                total_blocks=usable, max_len=self.max_len,
                pinned_blocks=lambda: self._alloc.pinned_shared)
        else:
            self._alloc = None
            self.cache = lm.init_cache(arch, self.max_batch, self.max_len,
                                       self.dtype, device=self.device)
            self.scheduler = SlotScheduler(self.max_batch, config.policy)
        # prefix sharing needs blocks to point at, a chunk that can start
        # at the first uncached token, and a stack whose per-token state is
        # all in the KV blocks: a recurrent layer's state must
        # ingest every prompt token, so it gets no prefix cache
        attn_only = all(spec.mixer == "attn" for spec in arch.pattern)
        use_prefix = (config.prefix_cache and self.paged and self.chunked
                      and attn_only)
        self.prefix = (PrefixCache(self._alloc, evict=config.prefix_evict)
                       if use_prefix else None)
        self.queue: deque[Request] = deque()
        self._tok = np.zeros((self.max_batch,), np.int32)
        self._pos = np.zeros((self.max_batch,), np.int32)
        self.itl_samples: list[float] = []
        self.stats: dict[str, float] = {
            "compile_s": 0.0, "prefill_s": 0.0, "prefill_tokens": 0,
            "decode_s": 0.0, "decode_steps": 0, "decode_tokens": 0,
            "admitted": 0, "retired": 0,
        }

    # ---------------------------------------------------------------- #
    @property
    def busy(self) -> bool:
        return bool(self.queue) or bool(self.scheduler.active)

    @property
    def kv_bytes_reserved(self) -> int:
        """Bytes allocated for the KV pool (payload and scales)."""
        return sum(t.numel() * t.element_size()
                   for path, t in lm.tree_leaves(self.cache)
                   if _is_kv_path(path))

    @property
    def peak_blocks_in_use(self) -> int:
        return self._alloc.peak_in_use if self.paged else 0

    @property
    def prefix_hit_rate(self) -> float:
        if self.prefix is None:
            return 0.0
        n = self.prefix.hits + self.prefix.misses
        return self.prefix.hits / n if n else 0.0

    @property
    def prefill_tokens_saved(self) -> int:
        return self.prefix.tokens_saved if self.prefix is not None else 0

    def _prompt_row_len(self, prompt_len: int) -> int:
        """The batch-1 prefill row: the prompt rounded up to whole blocks
        (paged), or the whole ``max_len`` row a dense slot takes."""
        if not self.paged:
            return self.max_len
        return -(-prompt_len // self.block_size) * self.block_size

    def _tables(self) -> torch.Tensor | None:
        """The block tables on the device; None for the dense layout."""
        if not self.paged:
            return None
        return torch.as_tensor(self._alloc.tables, device=self.device)

    def _ints(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def submit(self, request: Request) -> None:
        """Queue ``request``; a prompt longer than ``max_len``, or (paged)
        a worst-case block need above the whole pool, is refused."""
        plen = len(request.prompt)
        if plen > self.max_len:
            raise ValueError(
                f"request {request.uid}: prompt length {plen} exceeds the "
                f"cache row budget max_len={self.max_len}")
        if not self.paged:
            self.queue.append(request)
            return
        need = self.scheduler.blocks_for(request)
        usable = self._alloc.num_blocks - 1
        if need > usable:
            raise PoolExhausted(
                f"request {request.uid} needs {need} KV blocks worst-"
                f"case (prompt {plen} + max_new "
                f"{request.max_new_tokens}, block_size "
                f"{self.block_size}) but the pool holds {usable}")
        self.queue.append(request)

    def _step_widths(self, prompt_lens=()) -> list[int]:
        """Every step width T the chunked engine can issue for these
        prompt lengths (with prefix caching, from every cached start)."""
        widths = {1}
        for plen in {int(p) for p in prompt_lens}:
            starts = {0}
            if self.prefix is not None:
                starts.update(range(self.block_size, plen, self.block_size))
                starts.add(plen - 1)
            for start in starts:
                r = plen - start
                while r > 0:
                    g = min(r, self.chunk)
                    widths.add(g)
                    r -= g
        return sorted(widths)

    def _sample(self, logits) -> np.ndarray:
        """argmax of each row's single next-token column."""
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32).cpu().numpy()

    @torch.inference_mode()
    def warmup(self, prompt_lens=()) -> float:
        """Run every step shape the serve loop will issue once before
        anything is timed (builds and loads the kernels, warms cuBLAS's
        per-shape choices and the caching allocator); returns the seconds
        spent.  The dummy traffic lands in the trash block or a dense row
        position a real write overwrites (chunked), or in blocks or rows
        admission overwrites (stall-the-world)."""
        t0 = time.perf_counter()
        zeros = self._ints(np.zeros(self.max_batch))
        if self.chunked:
            for T in self._step_widths(prompt_lens):
                logits, self.cache = self._step(
                    self.params,
                    torch.zeros((self.max_batch, T), dtype=torch.int64,
                                device=self.device),
                    self.cache, zeros, q_lens=zeros,
                    block_tables=self._tables())
                self._sample(logits)
            self.cache = reset_slot_state(self.cache, 0)
            if self.prefix is not None:
                self.cache = copy_block(self.cache, 0, 0)
        else:
            for plen in sorted({int(p) for p in prompt_lens}):
                row = lm.init_cache(self.arch, 1, self._prompt_row_len(plen),
                                    self.dtype, device=self.device)
                logits, row = self._prefill(
                    self.params,
                    {"tokens": torch.zeros((1, plen), dtype=torch.int64,
                                           device=self.device)}, row)
                trash = None
                if self.paged:
                    nb = -(-plen // self.block_size)
                    trash = torch.zeros((nb,), dtype=torch.int64,
                                        device=self.device)
                self.cache = write_slot(self.cache, row, 0, trash)
                int(torch.argmax(logits[0, -1]))
            logits, self.cache = self._step(
                self.params,
                torch.zeros((self.max_batch, 1), dtype=torch.int64,
                            device=self.device),
                self.cache, zeros, block_tables=self._tables())
            self._sample(logits)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.stats["compile_s"] += dt
        return dt

    # ---------------------------------------------------------------- #
    def _prefix_plan(self, req: Request):
        """Admission plan against the prefix index now: ``(attach,
        cached_len, reserved, newly_pinned)`` — see the reference's
        ``ServeEngine._prefix_plan``."""
        worst = self.scheduler.blocks_for(req)
        if self.prefix is None:
            return [], 0, worst, 0
        plen = len(req.prompt)
        matched = self.prefix.match(req.prompt)
        bs = self.block_size
        cached_len = min(len(matched) * bs, plen - 1)
        n_attach = -(-cached_len // bs)
        if n_attach == 0:
            return [], 0, worst, 0
        attach = matched[:n_attach]
        capped = len(matched) * bs > cached_len
        credit = n_attach - (1 if capped else 0)
        pinned = sum(1 for b in attach if self._alloc.would_pin(b))
        return attach, cached_len, worst - credit, pinned

    def _admission_need(self, req: Request) -> int:
        _, _, reserved, pinned = self._prefix_plan(req)
        return reserved + pinned

    def _admit_one(self) -> list[Completion] | None:
        req = self.queue.popleft()
        if self.chunked:
            attach, cached_len, reserved, pinned = self._prefix_plan(req)
            if (self.paged and
                    reserved + pinned > self.scheduler.free_block_budget):
                # stale prefix credit (an earlier admit in this wave
                # evicted a matched block): requeue, end the wave
                self.queue.appendleft(req)
                return None
            slot = self.scheduler.admit(
                req, chunked=True, reserved=reserved if self.paged else None,
                cached_len=cached_len)
            if self.prefix is not None:
                for page, block in enumerate(attach):
                    self._alloc.attach(slot, page, block)
                if cached_len:
                    self.prefix.hits += 1
                    self.prefix.tokens_saved += cached_len
                else:
                    self.prefix.misses += 1
                # publish the prompt's remaining full blocks now (safe:
                # prefill grants are oldest-first)
                for page in range(len(attach),
                                  len(req.prompt) // self.block_size):
                    block = self._alloc.alloc(slot, page)
                    self.prefix.register(req.prompt, page, block)
            self.cache = reset_slot_state(self.cache, slot)
            self._tok[slot] = 0
            self._pos[slot] = cached_len
            self.stats["admitted"] += 1
            return []
        slot = self.scheduler.admit(req)
        t0 = time.perf_counter()
        tokens = torch.as_tensor(req.prompt, dtype=torch.int64,
                                 device=self.device)[None, :]
        row = lm.init_cache(self.arch, 1, self._prompt_row_len(len(req.prompt)),
                            self.dtype, device=self.device)
        logits, row = self._prefill(self.params, {"tokens": tokens}, row)
        ids = None
        if self.paged:
            nb = -(-len(req.prompt) // self.block_size)
            ids = torch.as_tensor(
                [self._alloc.alloc(slot, page) for page in range(nb)],
                dtype=torch.int64, device=self.device)
        self.cache = write_slot(self.cache, row, slot, ids)
        first = int(torch.argmax(logits[0, -1]))
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["prefill_tokens"] += len(req.prompt)
        self.stats["admitted"] += 1
        st = self.scheduler.state(slot)
        st.generated.append(first)
        self._tok[slot] = first
        self._pos[slot] = st.pos
        return self._maybe_retire(slot)

    def _maybe_retire(self, slot: int) -> list[Completion]:
        st = self.scheduler.state(slot)
        req = st.request
        reason = None
        if req.eos_id is not None and st.generated[-1] == req.eos_id:
            reason = "eos"
        elif len(st.generated) >= req.max_new_tokens:
            reason = "length"
        elif st.pos >= self.max_len:      # cache row budget exhausted
            reason = "length"
        if reason is None:
            return []
        self.scheduler.retire(slot)
        if self.paged:
            self._alloc.free_slot(slot)   # blocks back to the free list;
        self._tok[slot] = 0               # the table row points at trash
        self._pos[slot] = 0
        self.stats["retired"] += 1
        return [Completion(uid=req.uid, tokens=list(st.generated),
                           prompt_len=len(req.prompt), finish_reason=reason)]

    def _mixed_step(self, active) -> list[Completion]:
        """One unified mixed step: grant this step's prefill budget,
        assemble the ragged (B, T) batch, advance every live slot, sample
        where a next token materialized."""
        t0 = time.perf_counter()
        grants = self.scheduler.prefill_grants(self.chunk)
        T = max([1] + list(grants.values()))
        toks = np.zeros((self.max_batch, T), np.int64)
        q_lens = np.zeros((self.max_batch,), np.int32)
        for slot, st in active.items():
            g = grants.get(slot, 0)
            if g > 0:
                toks[slot, :g] = st.request.prompt[st.pos:st.pos + g]
                q_lens[slot] = g
            elif st.prefill_remaining == 0:
                toks[slot, 0] = self._tok[slot]
                q_lens[slot] = 1
            self._pos[slot] = st.pos
        bs = self.block_size
        for slot, st in active.items():
            g = int(q_lens[slot])
            if g > 0 and self.paged:
                # bind every page this step writes; a write into a
                # still-shared block copies it first (copy-on-write)
                for page in range(st.pos // bs, (st.pos + g - 1) // bs + 1):
                    cow = self._alloc.ensure(slot, page * bs)
                    if cow is not None and cow[0] != cow[1]:
                        self.cache = copy_block(self.cache, *cow)
        logits, self.cache = self._step(
            self.params, torch.as_tensor(toks, device=self.device),
            self.cache, self._ints(self._pos), q_lens=self._ints(q_lens),
            block_tables=self._tables())
        nxt = self._sample(logits)
        done: list[Completion] = []
        for slot, st in active.items():
            g = int(q_lens[slot])
            if g == 0:
                continue
            if st.prefill_remaining > 0:                 # prompt chunk
                st.pos += g
                st.prefill_remaining -= g
                self._pos[slot] = st.pos
                self.stats["prefill_tokens"] += g
                if st.prefill_remaining == 0:            # prompt done:
                    tok = int(nxt[slot])                 # first token
                    st.generated.append(tok)
                    self._tok[slot] = tok
                    done.extend(self._maybe_retire(slot))
            else:                                        # decode token
                tok = int(nxt[slot])
                st.generated.append(tok)
                st.pos += 1
                self._tok[slot] = tok
                self._pos[slot] = st.pos
                self.stats["decode_tokens"] += 1
                done.extend(self._maybe_retire(slot))
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        return done

    def _lockstep_decode(self, active) -> list[Completion]:
        """Stall-the-world decode: every active slot advances one token
        (prompts were prefilled whole at admission)."""
        t0 = time.perf_counter()
        for slot, st in active.items():
            if self.paged:
                self._alloc.ensure(slot, st.pos)    # lazy boundary crossing
        tok = torch.as_tensor(self._tok.astype(np.int64),
                              device=self.device)[:, None]
        logits, self.cache = self._step(
            self.params, tok, self.cache, self._ints(self._pos),
            block_tables=self._tables())
        nxt = self._sample(logits)
        done: list[Completion] = []
        for slot, st in active.items():
            t = int(nxt[slot])
            st.generated.append(t)
            st.pos += 1
            self._tok[slot] = t
            self._pos[slot] = st.pos
            done.extend(self._maybe_retire(slot))
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        self.stats["decode_tokens"] += len(active)
        return done

    @torch.inference_mode()
    def step(self) -> list[Completion]:
        """Admit every admissible queued request, then run one step over
        the pool; returns the requests that finished.  When a slot was
        mid-decode at entry, the call's wall time (admission included) is
        appended to ``itl_samples``."""
        t_entry = time.perf_counter()
        decoding_before = any(st.prefill_remaining == 0
                              for st in self.scheduler.active.values())
        done: list[Completion] = []
        need_fn = self._admission_need if self.prefix is not None else None
        for _ in range(self.scheduler.admissible_requests(self.queue,
                                                          need_fn)):
            admitted = self._admit_one()
            if admitted is None:
                break
            done.extend(admitted)
        active = self.scheduler.active
        if active:
            if self.chunked:
                done.extend(self._mixed_step(active))
            else:
                done.extend(self._lockstep_decode(active))
            if decoding_before:
                self.itl_samples.append(time.perf_counter() - t_entry)
        return done

    def run(self, requests=()) -> list[Completion]:
        """Submit ``requests`` and drive until the queue and pool drain."""
        for req in requests:
            self.submit(req)
        done: list[Completion] = []
        while self.busy:
            done.extend(self.step())
        return done
