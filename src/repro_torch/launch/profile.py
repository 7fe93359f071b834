"""Device-profile command of the port: measure the card and persist a
DeviceProfile (the counterpart of ``repro.launch.profile``).

    python -m repro_torch.launch.profile --out profile.json

Measures the chip roofline (dense-matmul FLOP/s at the port's float32
without TF32, HBM stream bandwidth), every eligible kernel dispatch
backend per (op, shape class) (``cuda`` launches the hand-written
kernel; ``xla`` and ``ref`` run the plain versions on the card), and,
under ``torchrun`` with more than one rank, the four ring collectives
over a message-size ladder on each mesh axis, fitted to alpha-beta
curves.  The JSON feeds ``--device-profile`` on the train and serve
commands, calibrating the plan search's cost model to the measured card;
it is the reference's format, so either package loads it.

    torchrun --nproc-per-node 4 -m repro_torch.launch.profile \
        --axes data=2,model=2 --out profile.json

The flags are the reference's, plus ``--device`` (``cpu`` measures the
CPU; without it the command needs a GPU).  Only rank 0 prints and writes
the file.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import init_distributed
from repro_torch.profiling import build_profile, default_profile_path
from repro_torch.profiling import microbench as mb

KiB = 1024
MiB = 1024 * 1024

#: Smoke-sized ladders (the reference's): seconds, not minutes.  Their
#: matmuls are too small to reach the card's GEMM rate and their streams
#: fit in its L2, so a profile that calibrates a plan takes the defaults.
SMOKE = dict(matmul_sizes=(128, 256), stream_sizes=(1 * MiB, 4 * MiB),
             collective_sizes=(64 * KiB, 256 * KiB, 1 * MiB),
             repeats=3, warmup=1)


def parse_axes(spec: str) -> dict[str, int]:
    """``"data=4,model=2"`` -> ``{"data": 4, "model": 2}``."""
    out: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, size = part.partition("=")
        if not size:
            raise ValueError(f"bad --axes entry {part!r}; want name=size")
        out[name.strip()] = int(size)
    return out


def default_axes(n_dev: int) -> dict[str, int]:
    """The serve-mesh factoring: (n/2, 2) when n >= 4 and even, else a
    single data axis — the axes plans are actually searched over."""
    if n_dev <= 1:
        return {}
    if n_dev >= 4 and n_dev % 2 == 0:
        return {"data": n_dev // 2, "model": 2}
    return {"data": n_dev}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="measure a DeviceProfile for this card")
    ap.add_argument("--out", default="",
                    help="output JSON path (default: the profile cache, "
                         "keyed by device kind)")
    ap.add_argument("--axes", default="",
                    help="mesh axes to sweep collectives over, e.g. "
                         "data=2,model=2 (default: factor the ranks like "
                         "the serve mesh)")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke-sized ladders (small matmuls, short "
                         "collective ladder, 3 repeats)")
    ap.add_argument("--repeats", type=int, default=0,
                    help="override median-of-k repeats")
    ap.add_argument("--warmup", type=int, default=0,
                    help="override warmup iterations")
    ap.add_argument("--shape-classes", default="small",
                    help="comma-separated kernel shape classes "
                         "(small, base)")
    ap.add_argument("--skip-collectives", action="store_true",
                    help="skip the collective sweep even with >1 rank")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None):
    """Measure and write the profile; returns it."""
    args = parser().parse_args(argv)
    kw = dict(SMOKE) if args.smoke else {}
    if args.repeats > 0:
        kw["repeats"] = args.repeats
    if args.warmup > 0:
        kw["warmup"] = args.warmup
    kw["shape_classes"] = tuple(
        s.strip() for s in args.shape_classes.split(",") if s.strip())

    device = resolve_device(args.device)
    rank, world = init_distributed(device)
    log = print if rank == 0 else (lambda *a, **k: None)
    axes = parse_axes(args.axes) if args.axes else default_axes(world)
    if args.skip_collectives:
        axes = {}
    log(f"profile: {world} device(s) [{mb.device_kind(device)}], "
        f"collective axes {axes or 'none'}")

    prof = build_profile(axes=axes, device=device, **kw)

    out = args.out or str(default_profile_path(prof.device_kind))
    if rank == 0:
        prof.save(out)
    log(f"profile: measured flops {prof.measured_flops:.3e} FLOP/s "
        f"({prof.meta['matmul_dtype']}, tf32 "
        f"{'on' if prof.meta['allow_tf32'] else 'off'}), "
        f"hbm {prof.measured_hbm_bw:.3e} B/s")
    for axis, curves in sorted(prof.collectives.items()):
        for kind, c in sorted(curves.items()):
            log(f"profile: {axis}/{kind}: alpha {c.alpha * 1e6:.1f} us, "
                f"bw {c.bw:.3e} B/s")
    for (op, backend, sc), t in sorted(prof.kernel_times.items()):
        log(f"profile: kernel {op}/{backend}/{sc}: {t * 1e3:.4f} ms")
    factors = prof.kernel_factors()
    for (op, backend), f in sorted(factors.items()):
        log(f"profile: kernel {op}/{backend}: factor {f:.2f}")
    log(f"profile: wrote {out}")
    log(json.dumps({"device_kind": prof.device_kind,
                    "kernel_entries": len(prof.kernel_times),
                    "collective_axes": sorted(prof.collectives)}))
    return prof


if __name__ == "__main__":
    main()
