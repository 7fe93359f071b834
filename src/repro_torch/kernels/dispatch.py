"""Kernel dispatch of the port: the counterpart of
``repro.kernels.dispatch``.

Every op of :mod:`repro_torch.kernels.ops` registers its implementations
here, one per backend, and the op asks the registry which one runs.  The
port's backend names are chosen once, in :data:`BACKENDS`:

  ``cuda``  the hand-written CUDA kernel for ``sm_90a`` (``csrc/``), on
            CUDA tensors only; what the reference calls ``pallas``
  ``xla``   plain PyTorch, the counterpart of the reference's XLA impls:
            the chunked attention cores (``mha_chunked`` for flash,
            ``mha_stream`` for the 5-d mixed-step forms), the chunked
            associative scan, the scatter / gather MoE; for WKV6 the same
            function as ``ref``, as in the reference
  ``ref``   plain PyTorch oracles (``kernels/ref.py``), the reference's
            ``ref``

A name means the same in a device profile's JSON and in the copied cost
model's kernel hooks (:mod:`repro_torch.core.cost_model`, where ``cuda``
prices as the reference's ``pallas``); :data:`REFERENCE_NAMES` maps one
onto the other.  The reference's ``interpret`` (the Pallas interpreter)
has no counterpart: asking for it, or for any other name, raises and
names the port's backends.

Overrides, strongest first (as in the reference):
  1. ``backend=`` argument to :func:`call` (strict: an impl that cannot
     take the call raises);
  2. the :func:`force_backend` context (the commands' ``--kernel-backend``,
     ``TrainConfig.kernel_backend``, ``ServeConfig.kernel_backend``);
  3. ``REPRO_KERNEL_BACKEND_<OP>`` (op name upper-cased);
  4. ``REPRO_KERNEL_BACKEND``;
  5. automatic selection.
Overrides 2-4 are preferences: a known backend that cannot take a
particular call (the stateless WKV6 kernel asked for the carried state)
logs a warning and falls through to automatic selection; an unknown name
raises.

Departures from the reference, each held by
``tests/test_torch_kernel_dispatch.py``:

* **No hidden fallback on the card.**  The platform of a call is the
  device of its first tensor.  On a CUDA tensor, automatic selection
  takes the ``cuda`` impl for every call form its kernel covers
  (``covers``), whatever the shape: the kernel launches, or its wrapper
  raises on a shape it does not take.  A plain impl runs on the card only
  when it is named (overrides 1-4) or when no kernel covers the call
  form: the carried-state WKV6, the 5-d mixed-step attention
  (``mha_stream``) and ``mha_chunked``.  On a CPU tensor automatic
  selection is the reference's: the highest-priority plain impl whose
  gates accept the call.
* **No ``spmd_safe`` skip.**  The port's kernels run on local shards
  (:func:`repro_torch.core.sharding.run_local`), so every impl is safe
  under a mesh.
* **The forced backend is process-wide**, not per thread: the autograd
  engine runs a checkpointed unit's recompute on its own device thread,
  which must see the same backend as the forward.  ``force_backend(None)``
  leaves an outer context in force.
* **The autotune cache** keeps the reference's two layers, counters and
  environment; its files live by default under the checkout's ``build/``
  (beside the built kernels) instead of the home directory.  The tile a
  tuned launcher takes is dense and paged decode's tokens per CTA (the
  split-KV range, ``decode_attention.chunk_candidates``); flash's tiles
  are compiled into its kernel, so flash takes no candidates.  Tuning
  runs on CUDA tensors only, and its timing launches count no launch.

Ops (the reference's layouts and signatures):
  flash_attention(q, k, v, *, causal, block_q, block_k)
  decode_attention(q, k, v, kv_len, *, block_k)
  paged_decode_attention(q, k_pool, v_pool, block_tables, kv_len, *,
                         k_scale, v_scale)
  wkv6(r, k, v, w, u, *, chunk, initial_state, return_state)
  mamba_scan(dt, B, C, x, A, D, *, chunk, initial_state, return_state)
  moe_dispatch_combine(x, gate_vals, expert_idx, wi, wg, wo, *, capacity,
                       constrain)
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import re
import threading
import time
from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import torch

from . import build

log = logging.getLogger(__name__)

ENV_GLOBAL = "REPRO_KERNEL_BACKEND"
ENV_AUTOTUNE = "REPRO_KERNEL_AUTOTUNE"
ENV_CACHE_DIR = "REPRO_AUTOTUNE_CACHE_DIR"
ENV_PERSIST = "REPRO_AUTOTUNE_PERSIST"

#: The port's backend names, and what each runs.
BACKENDS = {
    "cuda": "the hand-written CUDA kernel (csrc/), CUDA tensors only",
    "xla": "plain PyTorch, the chunked / streaming / scatter forms",
    "ref": "plain PyTorch oracles (kernels/ref.py)",
}
#: The plain backends: what may run on the card only when named, or for
#: a call form no kernel covers.
PLAIN = ("xla", "ref")
#: Each port name as the reference calls the same implementation.
REFERENCE_NAMES = {"cuda": "pallas", "xla": "xla", "ref": "ref"}
#: Devices with implementations.
PLATFORMS = ("cpu", "cuda")


@dataclass(frozen=True)
class Impl:
    op: str
    backend: str                      # one of BACKENDS
    fn: Callable[..., Any]
    platforms: tuple[str, ...] = PLATFORMS
    priority: int = 0                 # higher wins among eligible
    supports: Callable[..., bool] | None = None  # hard capability gate
    # a preference consulted only by automatic selection (e.g. "the plain
    # scores only below this size"); a named backend bypasses it
    auto_gate: Callable[..., bool] | None = None
    # the call forms a kernel is written for: on the card automatic
    # selection takes it for these whatever ``supports`` says of the shape
    covers: Callable[..., bool] | None = None

    def eligible(self, platform: str, args, kwargs, *,
                 auto: bool = True) -> bool:
        if platform not in self.platforms:
            return False
        gates = [self.supports] + ([self.auto_gate] if auto else [])
        return all(_gate(self, g, args, kwargs) for g in gates)

    def takes_form(self, args, kwargs) -> bool:
        return self.covers is not None and _gate(self, self.covers, args,
                                                 kwargs)


def _gate(impl: Impl, gate, args, kwargs) -> bool:
    if gate is None:
        return True
    try:
        return bool(gate(*args, **kwargs))
    except Exception:  # a predicate must never take the process down
        log.exception("predicate failed for %s/%s", impl.op, impl.backend)
        return False


_REGISTRY: dict[str, dict[str, Impl]] = {}
_forced: list[str | None] = [None]
_registered_builtins = False


def register(op: str, backend: str, *,
             platforms: tuple[str, ...] = PLATFORMS, priority: int = 0,
             supports: Callable[..., bool] | None = None,
             auto_gate: Callable[..., bool] | None = None,
             covers: Callable[..., bool] | None = None):
    """Decorator: register ``fn`` as the ``backend`` implementation of
    ``op``.  Re-registration replaces (module reloads)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; the port's "
                         f"backends are {sorted(BACKENDS)}")

    def deco(fn):
        _REGISTRY.setdefault(op, {})[backend] = Impl(
            op=op, backend=backend, fn=fn, platforms=tuple(platforms),
            priority=priority, supports=supports, auto_gate=auto_gate,
            covers=covers)
        return fn

    return deco


def _ensure_builtins() -> None:
    """Import :mod:`~repro_torch.kernels.ops`, whose registrations cover
    every op (lazy, to avoid an import cycle)."""
    global _registered_builtins
    if not _registered_builtins:
        _registered_builtins = True
        from . import ops  # noqa: F401


def backends(op: str) -> dict[str, Impl]:
    _ensure_builtins()
    if op not in _REGISTRY:
        raise KeyError(f"unknown kernel op {op!r}; "
                       f"registered: {sorted(_REGISTRY)}")
    return _REGISTRY[op]


@contextlib.contextmanager
def force_backend(backend: str | None):
    """Force every :func:`call` in this process to ``backend`` (a
    preference, see the module docstring); ``None`` leaves whatever is in
    force."""
    if backend is None:
        yield
        return
    prev = _forced[0]
    _forced[0] = backend
    try:
        yield
    finally:
        _forced[0] = prev


def call_platform(args) -> str:
    """The platform of a call: the device type of its first tensor.  A
    meta tensor stands for the card's (the dry run's tensors,
    :mod:`repro_torch.launch.dryrun`), so its call goes to the kernel's
    fake branch (:mod:`~repro_torch.kernels.work`)."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return "cuda" if a.is_meta else a.device.type
    raise ValueError("a kernel op needs a tensor argument")


def _override_for(op: str) -> str | None:
    return (_forced[0] or os.environ.get(f"{ENV_GLOBAL}_{op.upper()}")
            or os.environ.get(ENV_GLOBAL) or None)


def select(op: str, *args, backend: str | None = None, **kwargs) -> Impl:
    """Resolve the implementation that :func:`call` would run (the
    override order and the card rule in the module docstring)."""
    impls = backends(op)
    platform = call_platform(args)
    strict = backend is not None
    backend = backend or _override_for(op)
    if backend is not None:
        if backend not in impls:
            raise ValueError(
                f"backend {backend!r} not registered for op {op!r} (have: "
                f"{sorted(impls)}; the port's backends are "
                f"{sorted(BACKENDS)})")
        impl = impls[backend]
        if impl.eligible(platform, args, kwargs, auto=False):
            return impl
        if strict:
            raise ValueError(
                f"backend {backend!r} for op {op!r} does not take this "
                f"call (platform {platform!r}, its shapes and form)")
        log.warning("forced backend %r cannot handle this %r call; "
                    "auto-selecting", backend, op)
    if platform not in PLATFORMS:
        raise ValueError(f"{op}: no implementation for device {platform}")
    kernel = impls.get("cuda")
    if platform == "cuda" and kernel is not None and kernel.takes_form(
            args, kwargs):
        return kernel
    for impl in sorted(impls.values(), key=lambda i: -i.priority):
        if impl.eligible(platform, args, kwargs):
            return impl
    raise ValueError(f"{op}: no implementation for device {platform} takes "
                     f"this call; registered: {sorted(impls)}")


def call(op: str, *args, backend: str | None = None, **kwargs):
    """Dispatch ``op`` to the selected backend implementation."""
    return select(op, *args, backend=backend, **kwargs).fn(*args, **kwargs)


# --------------------------------------------------------------------------- #
# Tile autotune cache (CUDA launchers)
#
# Two layers: the in-process dict (consulted first, keyed by the full tuning
# key), and a JSON file per device kind under ``autotune_cache_dir()`` so a
# restart on the same card skips re-tuning.  Disk entries are validated
# against the caller's candidate list before use: a stale or corrupt file
# degrades to a fresh tune, never to a wrong tile.
# --------------------------------------------------------------------------- #
_TUNE_CACHE: dict[tuple, tuple] = {}
_TUNE_LOCK = threading.Lock()          # guards the dicts/counters (fast ops)
_DISK_LOCK = threading.Lock()          # serializes file I/O, outside _TUNE_LOCK
_TUNE_STATS: Counter = Counter()
_DISK_CACHE: dict[str, tuple] = {}     # str(key) -> choice, mirror of the file
_DISK_LOADED: set[str] = set()         # cache-file paths already merged


def autotune_enabled() -> bool:
    return os.environ.get(ENV_AUTOTUNE, "1") not in ("0", "false", "off")


def persist_enabled() -> bool:
    return os.environ.get(ENV_PERSIST, "1") not in ("0", "false", "off")


def autotune_cache_dir() -> Path:
    d = os.environ.get(ENV_CACHE_DIR)
    return Path(d) if d else build.BUILD.parent / "autotune"


@contextlib.contextmanager
def autotune_cache_at(path: str | None):
    """Point the cache at ``path`` (``REPRO_AUTOTUNE_CACHE_DIR``) for the
    block, as the commands' ``--autotune-cache-dir`` does; a falsy
    ``path`` changes nothing."""
    if not path:
        yield
        return
    prev = os.environ.get(ENV_CACHE_DIR)
    os.environ[ENV_CACHE_DIR] = str(path)
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(ENV_CACHE_DIR, None)
        else:
            os.environ[ENV_CACHE_DIR] = prev


def sanitize_device_kind(kind: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]+", "_", kind.strip()) or "unknown"


def _device_kind() -> str:
    kind = (torch.cuda.get_device_name() if torch.cuda.is_available()
            else "cpu")
    return sanitize_device_kind(kind)


def autotune_cache_path() -> Path:
    return autotune_cache_dir() / f"{_device_kind()}.json"


def autotune_cache_stats() -> dict[str, int]:
    """Counters: ``memory_hits`` / ``disk_hits`` (cache served), ``tuned``
    (a choice was computed fresh: heuristic or timed), ``disk_writes``,
    ``disk_errors`` (unreadable/corrupt cache files, recovered by
    re-tuning)."""
    with _TUNE_LOCK:
        return dict(_TUNE_STATS)


def clear_autotune_cache(*, reset_stats: bool = True) -> None:
    """Drop the in-process cache (and forget which disk files were merged,
    so a changed ``REPRO_AUTOTUNE_CACHE_DIR`` is re-read).  The on-disk
    files themselves are left alone."""
    with _TUNE_LOCK:
        _TUNE_CACHE.clear()
        _DISK_CACHE.clear()
        _DISK_LOADED.clear()
        if reset_stats:
            _TUNE_STATS.clear()


def _merge_disk_cache_locked(path: Path) -> None:
    """Merge ``path`` into the in-memory mirror once (under _TUNE_LOCK)."""
    key = str(path)
    if key in _DISK_LOADED:
        return
    _DISK_LOADED.add(key)
    if not path.exists():
        return
    try:
        raw = json.loads(path.read_text())
        if not isinstance(raw, dict):
            raise ValueError(f"expected a JSON object, got {type(raw)}")
        for ks, v in raw.items():
            _DISK_CACHE[ks] = tuple(int(b) for b in v)
    except Exception:
        _TUNE_STATS["disk_errors"] += 1
        log.warning("unreadable autotune cache %s; re-tuning", path,
                    exc_info=True)


def _write_disk_cache(path: Path) -> None:
    """Atomically rewrite ``path`` from the in-memory mirror (tmp file +
    ``os.replace``), merging what another process wrote since (ours win
    on conflict); a corrupt file is overwritten.  File I/O runs under
    _DISK_LOCK only; _TUNE_LOCK is taken briefly, never the other way
    around."""
    with _DISK_LOCK:
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            on_disk: dict[str, tuple] = {}
            if path.exists():
                try:
                    raw = json.loads(path.read_text())
                    if isinstance(raw, dict):
                        on_disk = {ks: tuple(int(b) for b in v)
                                   for ks, v in raw.items()}
                except Exception:
                    pass  # corrupt: the rewrite below repairs it
            with _TUNE_LOCK:
                for ks, v in on_disk.items():
                    _DISK_CACHE.setdefault(ks, v)
                snap = dict(_DISK_CACHE)
            tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
            tmp.write_text(json.dumps(
                {k: list(v) for k, v in sorted(snap.items())}, indent=1))
            os.replace(tmp, path)
            with _TUNE_LOCK:
                _TUNE_STATS["disk_writes"] += 1
        except OSError:
            with _TUNE_LOCK:
                _TUNE_STATS["disk_errors"] += 1
            log.warning("cannot persist autotune cache to %s", path,
                        exc_info=True)


def _is_concrete(args) -> bool:
    """No tensor without data among ``args`` (a fake tensor, as under
    tracing, or a meta tensor, as in the dry run)."""
    from .work import is_fake
    return not any(isinstance(a, torch.Tensor) and is_fake(a) for a in args)


def _time_once(fn, *args, reps: int = 10) -> float:
    """Mean seconds of ``fn(*args)`` over ``reps`` calls, between device
    synchronizations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def tuned_blocks(op: str, key: tuple, candidates: list[tuple],
                 bench: Callable[..., Any], args: tuple) -> tuple:
    """Pick a launcher's tile choice.

    ``candidates`` are already valid; the first is the heuristic.  On CUDA
    tensors with autotuning enabled, each candidate is timed (after a
    warm-up call) by ``bench(*candidate)`` and the winner cached under
    ``(op, key)``; anywhere else the heuristic is cached untimed.
    Tensors without data (under tracing, or the dry run's) get the
    heuristic and leave both caches as they were, so that a later call
    with real tensors can still tune the same shape.  A ``bench`` launch
    counts no launch."""
    if not candidates:
        raise ValueError(f"no valid tile candidates for {op} {key}")
    if not _is_concrete(args):
        return candidates[0]
    cache_key = (op,) + key
    persist = persist_enabled()
    with _TUNE_LOCK:
        if cache_key in _TUNE_CACHE:
            _TUNE_STATS["memory_hits"] += 1
            return _TUNE_CACHE[cache_key]
        if persist:
            _merge_disk_cache_locked(autotune_cache_path())
            disk = _DISK_CACHE.get(repr(cache_key))
            if disk is not None and disk in candidates:
                _TUNE_STATS["disk_hits"] += 1
                _TUNE_CACHE[cache_key] = disk
                return disk
    choice = candidates[0]
    on_card = any(isinstance(a, torch.Tensor) and a.device.type == "cuda"
                  for a in args)
    if len(candidates) == 1:
        pass                          # nothing to tune; cache the choice
    elif not (autotune_enabled() and on_card):
        pass                          # tuning can never run: cache heuristic
    else:
        timings = []
        for cand in candidates:
            try:
                _time_once(bench, *cand, reps=1)     # warm up
                timings.append((_time_once(bench, *cand), cand))
            except Exception:                    # a candidate may not run
                log.debug("autotune candidate %s failed for %s",
                          cand, op, exc_info=True)
        if timings:
            choice = min(timings)[1]
            log.info("autotuned %s %s -> %s", op, key, choice)
    with _TUNE_LOCK:
        _TUNE_CACHE[cache_key] = choice
        _TUNE_STATS["tuned"] += 1
        if persist:
            _DISK_CACHE[repr(cache_key)] = choice
    if persist:
        _write_disk_cache(autotune_cache_path())
    return choice


def block_candidates(dim: int, preferred: tuple[int, ...]) -> list[int]:
    """Block sizes (largest first) from ``preferred`` that evenly divide
    ``dim``; always non-empty (``dim`` itself divides)."""
    cands = [b for b in sorted(set(preferred), reverse=True)
             if b <= dim and dim % b == 0]
    return cands or [dim]
