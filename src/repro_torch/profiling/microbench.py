"""Microbenchmarks that measure the numbers the cost model guesses: the
port's counterpart of ``repro.profiling.microbench``.

Three measurement families, all with the same timing discipline (warmup
calls discarded, ``torch.cuda.synchronize()`` on both sides of every
timed call, median of ``repeats``):

* **chip roofline** — dense-matmul FLOP/s over a size ladder (best rung
  wins: the cost model's ``eff_flops`` is the *achievable* rate) and HBM
  stream bandwidth from one elementwise read + write kernel;
* **kernel factors** — wall time of every eligible dispatch backend per
  (op, shape class) through the public :mod:`repro_torch.kernels.ops`
  wrappers (``backend=``), so the measurement runs exactly the dispatch
  path production uses;
* **collectives** — all-reduce / reduce-scatter / all-gather / all-to-all
  over a message-size ladder on each requested mesh axis, run over the
  ``torch.distributed`` process group of that axis and fitted to an
  alpha-beta curve ``t = alpha + wire_bytes / bw`` per (axis, kind).

Departures from the reference:

* The GEMM rate is measured at the dtype the port computes in: float32,
  with TF32 as the port leaves it (off, :func:`repro_torch.device.set_precision`);
  the dtype and the TF32 switch are recorded in the profile's meta.
  ``measure_matmul_flops(dtype=torch.bfloat16)`` measures the tensor-core
  rate.
* The default stream ladder starts at 64 MiB, above the H100's 50 MB L2,
  so that the best rung reads HBM and not the cache.
* Collectives run on process groups, one rank per device (``torchrun``;
  ``nccl`` on the cards, ``gloo`` on the CPU).  A rung's time is the
  mean of ten calls back to back (on the card between CUDA events: one
  host-timed call reads the launch and the ranks' skew, ~100-300 us on
  four H100s, and no size dependence), the median over the repeats, the
  slowest rank's.  The default ladder runs on to 64 MiB, where NVLink's
  bandwidth term shows.  Without a process group of more than one rank
  no axis is measured, as the reference measures none on one device.

Everything degrades gracefully: an axis the ranks do not divide into, a
backend that refuses the shape, or a collective the process group cannot
run is skipped (the profile lacks that field and calibration falls back
to the analytic constant).
"""

from __future__ import annotations

import logging
import time

import torch

from repro_torch.core.device import COLLECTIVE_KINDS
from repro_torch.kernels import dispatch, ops

from .profile import (CollectiveCurve, DeviceProfile, fit_alpha_beta,
                      sanitize_device_kind)

log = logging.getLogger(__name__)

KiB = 1024
MiB = 1024 * 1024

#: Default size ladders.  ``--smoke`` presets (see launch.profile) shrink
#: these so a run finishes in seconds.
MATMUL_SIZES = (256, 512, 1024, 2048)
STREAM_BYTES = (64 * MiB, 256 * MiB, 1024 * MiB)
COLLECTIVE_BYTES = (64 * KiB, 256 * KiB, 1 * MiB, 4 * MiB, 16 * MiB,
                    64 * MiB)
#: Back-to-back calls a timed collective run averages over.
COLLECTIVE_CALLS = 10

#: Dispatcher ops the kernel sweep times by default.  The port has no
#: interpreter backend, so nothing is skipped by default.
KERNEL_OPS = ("flash_attention", "decode_attention", "mamba_scan", "wkv6",
              "moe_dispatch_combine")
SKIP_BACKENDS: tuple[str, ...] = ()


def default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# --------------------------------------------------------------------------- #
# timing discipline
# --------------------------------------------------------------------------- #
def median_time(fn, *args, repeats: int = 5, warmup: int = 2) -> float:
    """Median wall seconds of ``fn(*args)`` with warmup and a device
    synchronization on both sides of every timed call."""
    with torch.no_grad():
        for _ in range(max(0, warmup)):
            fn(*args)
        _sync()
        ts = []
        for _ in range(max(1, repeats)):
            t0 = time.perf_counter()
            fn(*args)
            _sync()
            ts.append(time.perf_counter() - t0)
    ts.sort()
    n = len(ts)
    mid = n // 2
    return ts[mid] if n % 2 else 0.5 * (ts[mid - 1] + ts[mid])


# --------------------------------------------------------------------------- #
# chip roofline
# --------------------------------------------------------------------------- #
def measure_matmul_flops(sizes=MATMUL_SIZES, *, dtype=torch.float32,
                         device=None, repeats: int = 5,
                         warmup: int = 2) -> float:
    """Best achieved dense-matmul FLOP/s over the size ladder, at
    ``dtype`` (float32 by default: the port's compute dtype)."""
    device = torch.device(device) if device else default_device()
    gen = torch.Generator(device="cpu").manual_seed(0)
    best = 0.0
    for n in sizes:
        a = torch.randn(n, n, generator=gen).to(device, dtype)
        b = torch.randn(n, n, generator=gen).to(device, dtype)
        t = median_time(torch.matmul, a, b, repeats=repeats, warmup=warmup)
        best = max(best, 2.0 * n**3 / t)
    return best


def measure_hbm_bw(sizes=STREAM_BYTES, *, device=None, repeats: int = 5,
                   warmup: int = 2) -> float:
    """Best achieved stream bandwidth (bytes/s) of one elementwise kernel
    that reads each element once and writes it once."""
    device = torch.device(device) if device else default_device()
    best = 0.0
    for nbytes in sizes:
        x = torch.zeros(max(1, int(nbytes) // 4), device=device)
        y = torch.empty_like(x)
        t = median_time(lambda: torch.mul(x, 2.0, out=y), repeats=repeats,
                        warmup=warmup)
        best = max(best, 2.0 * x.numel() * 4 / t)
    return best


# --------------------------------------------------------------------------- #
# kernel sweep (through the production dispatch path)
# --------------------------------------------------------------------------- #
def _kernel_case(op: str, shape_class: str, device=None):
    """``(callable, args, kwargs)`` for one (op, shape class): the
    reference's cases, each a shape the port's kernels take (head dim 64,
    WKV6 N 64, scan N 8 / 16)."""
    device = torch.device(device) if device else default_device()
    big = shape_class == "base"
    B = 2 if big else 1
    S = 256 if big else 128
    H, D = (8, 64) if big else (4, 64)

    def full(shape, value, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype, device=device)

    if op == "flash_attention":
        q = full((B, H, S, D), 1.0)
        return ops.flash_attention, (q, q, q), {}
    if op == "decode_attention":
        q = full((B, H, 1, D), 1.0)
        kv = full((B, H, S, D), 1.0)
        return ops.decode_attention, (q, kv, kv, S), {}
    if op == "mamba_scan":
        di, N = (256, 16) if big else (128, 8)
        dt = full((B, S, di), 0.01)
        Bm = full((B, S, N), 1.0)
        x = full((B, S, di), 1.0)
        A = full((di, N), -1.0)
        Dk = full((di,), 1.0)
        return ops.mamba_scan, (dt, Bm, Bm, x, A, Dk), {}
    if op == "wkv6":
        N = 64
        r = full((B, H, S, N), 0.1)
        w = full((B, H, S, N), -1.0)
        u = full((H, N), 0.1)
        return ops.wkv6, (r, r, r, w, u), {}
    if op == "moe_dispatch_combine":
        Dm, F, E, K = (256, 512, 8, 2) if big else (128, 256, 4, 2)
        x = full((B, S, Dm), 1.0)
        gate = full((B, S, K), 1.0 / K)
        idx = (torch.arange(B * S * K, dtype=torch.int32,
                            device=device).reshape(B, S, K)) % E
        wi = full((E, Dm, F), 0.01)
        wo = full((E, F, Dm), 0.01)
        cap = (S * K + E - 1) // E  # capacity factor ~1.0, no drops
        return ops.moe_dispatch_combine, (x, gate, idx, wi, wi, wo), {
            "capacity": cap}
    raise KeyError(f"no microbench case for kernel op {op!r}")


def measure_kernels(ops_to_time=KERNEL_OPS, shape_classes=("small",), *,
                    skip_backends=SKIP_BACKENDS, repeats: int = 5,
                    warmup: int = 2,
                    device=None) -> dict[tuple[str, str, str], float]:
    """Median seconds per (op, backend, shape_class) for every registered
    backend eligible on this device and shape (``cuda`` launches its
    kernel; ``xla`` and ``ref`` run on the same device)."""
    device = torch.device(device) if device else default_device()
    out: dict[tuple[str, str, str], float] = {}
    for op in ops_to_time:
        for shape_class in shape_classes:
            fn, args, kwargs = _kernel_case(op, shape_class, device)
            for backend, impl in sorted(dispatch.backends(op).items()):
                if backend in skip_backends:
                    continue
                if not impl.eligible(device.type, args, kwargs, auto=False):
                    continue
                try:
                    t = median_time(
                        lambda *a: fn(*a, backend=backend, **kwargs),
                        *args, repeats=repeats, warmup=warmup)
                except Exception:
                    log.warning("kernel microbench %s/%s/%s failed; skipped",
                                op, backend, shape_class, exc_info=True)
                    continue
                out[(op, backend, shape_class)] = t
    return out


# --------------------------------------------------------------------------- #
# collective sweep
# --------------------------------------------------------------------------- #
def _collective_fn(kind: str, x: torch.Tensor, group, size: int):
    """One ``kind`` collective of the local buffer ``x`` over ``group`` (of
    ``size`` ranks), as a closure over preallocated outputs."""
    import torch.distributed as dist
    if kind == "all_reduce":
        return lambda: dist.all_reduce(x, group=group)
    if kind == "reduce_scatter":
        out = x.new_empty(x.numel() // size)
        return lambda: dist.reduce_scatter_tensor(out, x, group=group)
    if kind == "all_gather":
        out = x.new_empty(x.numel() * size)
        return lambda: dist.all_gather_into_tensor(out, x, group=group)
    if kind == "all_to_all":
        out = torch.empty_like(x)
        return lambda: dist.all_to_all_single(out, x, group=group)
    raise KeyError(f"unknown collective kind {kind!r}")


def _wire_bytes(kind: str, size: int, nbytes: float) -> float:
    """Per-chip wire bytes for one ring collective stage — the same
    formulas :class:`repro_torch.core.device.MeshSpec` prices with, so the
    fitted curve and the pricer speak the same units."""
    s = size
    if kind == "all_reduce":
        return 2.0 * (s - 1) / s * nbytes
    if kind == "reduce_scatter":
        return (s - 1) / s * nbytes
    if kind == "all_gather":
        return (s - 1) * nbytes          # nbytes is the per-chip shard
    if kind == "all_to_all":
        return (s - 1) / s * nbytes
    raise KeyError(kind)


def _timed_collective(fn, group, device, *, repeats: int, warmup: int,
                      calls: int = COLLECTIVE_CALLS) -> float:
    """Median over ``repeats`` of the mean seconds of ``calls`` ``fn()``
    back to back, the group's ranks lined up by a barrier before each
    run: on the card between CUDA events (the device's time, the host's
    launches and the ranks' skew amortized), on the CPU by the host clock
    (gloo's collectives return when done)."""
    import torch.distributed as dist
    for _ in range(max(0, warmup)):
        fn()
    _sync()
    ts = []
    for _ in range(max(1, repeats)):
        dist.barrier(group=group)
        _sync()
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3 / calls)
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            ts.append((time.perf_counter() - t0) / calls)
    ts.sort()
    n = len(ts)
    mid = n // 2
    return ts[mid] if n % 2 else 0.5 * (ts[mid - 1] + ts[mid])


def _axis_groups(axes: dict, world: int, device_type: str):
    """(name, size, process group) per measurable axis: each axis of
    ``size`` ranks is the second dim of a (world / size, size) device
    mesh over every rank, so every rank sits in exactly one group of it."""
    from torch.distributed.device_mesh import init_device_mesh
    out = []
    for name, size in dict(axes).items():
        size = int(size)
        if size <= 1:
            continue
        if world % size:
            log.warning("axis %s=%d does not divide %d ranks; skipped",
                        name, size, world)
            continue
        mesh = init_device_mesh(device_type, (world // size, size),
                                mesh_dim_names=("rest", name))
        out.append((name, size, mesh.get_group(name)))
    return out


def measure_collectives(axes, sizes_bytes=COLLECTIVE_BYTES, *,
                        kinds=COLLECTIVE_KINDS, repeats: int = 5,
                        warmup: int = 2,
                        device=None) -> dict[str, dict[str, CollectiveCurve]]:
    """Alpha-beta curves per (mesh axis, collective kind).

    ``axes`` is ``{name: size}``; every rank of the initialized process
    group calls this, and each axis is measured over the groups of
    ``size`` ranks it splits the world into.  Each rank holds a
    ladder-sized local buffer, the per-chip quantity the MeshSpec pricer
    takes; each rung's time is the slowest rank's median.  Without a
    process group of more than one rank nothing is measured."""
    import torch.distributed as dist
    device = torch.device(device) if device else default_device()
    if not (dist.is_available() and dist.is_initialized()):
        return {}
    world = dist.get_world_size()
    out: dict[str, dict[str, CollectiveCurve]] = {}
    for name, size, group in _axis_groups(axes, world, device.type):
        curves: dict[str, CollectiveCurve] = {}
        for kind in kinds:
            wires: list[float] = []
            times: list[float] = []
            for nbytes in sizes_bytes:
                # whole groups of size^2 elements a rank, so that every
                # collective's divisibility holds
                n = max(size * size, int(nbytes) // 4)
                n -= n % (size * size)
                x = torch.zeros(n, device=device)
                try:
                    t = _timed_collective(_collective_fn(kind, x, group, size),
                                          group, device, repeats=repeats,
                                          warmup=warmup)
                except Exception:
                    log.warning("collective microbench %s over %s failed; "
                                "skipped", kind, name, exc_info=True)
                    wires = []
                    break
                wires.append(_wire_bytes(kind, size, n * 4.0))
                times.append(t)
            if wires:
                slowest = torch.tensor(times, dtype=torch.float64,
                                       device=device)
                dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
                times = [float(t) for t in slowest.cpu()]
            if len(wires) >= 2 and max(wires) > min(wires):
                alpha, bw = fit_alpha_beta(wires, times)
                curves[kind] = CollectiveCurve(
                    kind=kind, alpha=alpha, bw=bw,
                    sizes=tuple(wires), times=tuple(times))
        if curves:
            out[name] = curves
    return out


# --------------------------------------------------------------------------- #
# top-level profile build
# --------------------------------------------------------------------------- #
def device_kind(device=None) -> str:
    device = torch.device(device) if device else default_device()
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    return sanitize_device_kind(kind)


def build_profile(*, axes=None, matmul_sizes=MATMUL_SIZES,
                  stream_sizes=STREAM_BYTES,
                  collective_sizes=COLLECTIVE_BYTES,
                  kernel_ops=KERNEL_OPS, shape_classes=("small",),
                  skip_backends=SKIP_BACKENDS,
                  repeats: int = 5, warmup: int = 2, device=None,
                  dtype=torch.float32) -> DeviceProfile:
    """Measure everything and assemble a :class:`DeviceProfile`.

    ``axes`` (``{name: size}``) selects the mesh axes to sweep
    collectives over; ``None`` or empty skips the collective sweep (a
    single-device host has no collectives to measure).  ``dtype`` is the
    GEMM's (the port's float32 by default)."""
    import torch.distributed as dist
    device = torch.device(device) if device else default_device()
    flops = measure_matmul_flops(matmul_sizes, dtype=dtype, device=device,
                                 repeats=repeats, warmup=warmup)
    hbm = measure_hbm_bw(stream_sizes, device=device, repeats=repeats,
                         warmup=warmup)
    kernels = measure_kernels(kernel_ops, shape_classes,
                              skip_backends=skip_backends,
                              repeats=repeats, warmup=warmup, device=device)
    coll = measure_collectives(axes or {}, collective_sizes,
                               repeats=repeats, warmup=warmup, device=device)
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    return DeviceProfile(
        device_kind=device_kind(device),
        measured_flops=flops,
        measured_hbm_bw=hbm,
        collectives=coll,
        kernel_times=kernels,
        meta={
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "platform": device.type,
            "num_devices": world,
            "axes": {k: int(v) for k, v in dict(axes or {}).items()},
            "repeats": int(repeats),
            "warmup": int(warmup),
            "matmul_sizes": [int(s) for s in matmul_sizes],
            "matmul_dtype": str(dtype).removeprefix("torch."),
            "allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
            "stream_bytes": [int(s) for s in stream_sizes],
            "collective_bytes": [int(s) for s in collective_sizes],
            "shape_classes": list(shape_classes),
            "created_unix": time.time(),
        },
    )
