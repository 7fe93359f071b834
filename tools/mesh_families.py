#!/usr/bin/env python3
"""The port's small model families realized on a 2 x 2 ``("data",
"model")`` mesh of four ranks against the same runs on one device, with
the layouts a one-device mesh never takes: heads, d_ff, experts and the
scan's channels split over ``model``, the batch over ``data``.

    python -c "from repro_torch.kernels import build; build.build_all()"
    torchrun --nproc-per-node 4 tools/mesh_families.py \\
        [--device cpu] [--seq 128] [--requests 6] [--gen 8] \\
        [--out chiprun_out/mesh/families.json]

Run from the repository root with ``PYTHONPATH=src``, the kernels built
first (the ranks would otherwise build them side by side): on four GPUs
(``nccl``), or on the CPU (``--device cpu``: ``gloo``, the plain
versions, small sizes).  Every rank first runs each case unrealized on
its own device, then realized on the mesh, from the same seeded weights
(``chip_smoke``'s small models: llama with 2 KV heads and with 1, the
replicated-KV fallback under split heads; olmoe, 8 experts; jamba,
Mamba + MoE; rwkv6).

* Train: 2 AdamW steps at batch 4 x ``--seq`` under two train plans, the
  one searched for the mesh (``h100_mesh_spec(1, 2, 2)``) and the
  ``model`` baseline; ZeRO-1 moments.  Each loss within 5e-4 of the
  unrealized one (the reference's tolerance,
  ``tests/test_sharded_execution.py``), and every kernel launched as
  often on each rank as unrealized.
* Serve: the 1-KV-head llama in the paged, int8 and dense modes, olmoe
  and jamba paged, under the ``model`` baseline of the decode phase (KV
  heads, experts and channels split over ``model``): the tokens equal
  and the launches alike.

Rank 0 prints one JSON line per run and a summary line; everything also
goes to ``--out``.  A run that raises is recorded and the next one
starts.  Exits nonzero if a check failed or a run raised on any rank.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import h100_mesh_spec, use_mesh  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import init_distributed, make_smoke_mesh  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.plans import (baseline_phase_plan, param_pspecs,  # noqa: E402
                               search_phase_plan)
from repro_torch.train import TrainConfig, make_train_step, realize  # noqa: E402

B, STEPS = 4, 2
LOSS_TOL = 5e-4
SERVE = {"llama-kv1": ("a", "c", "dense"), "olmoe": ("a",), "jamba": ("a",)}


def archs() -> dict:
    llama = dataclasses.replace(
        configs.get("llama3.2-1b"), n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=2, d_ff=512, vocab=512, head_dim=64)
    return {"llama": llama,
            "llama-kv1": dataclasses.replace(llama, n_kv_heads=1),
            "olmoe": smoke.small_moe_arch("olmoe"),
            "jamba": smoke.small_moe_arch("jamba"),
            "rwkv6": dataclasses.replace(
                configs.get("rwkv6-1.6b"), n_layers=2, d_model=256,
                n_heads=4, n_kv_heads=4, d_ff=512, vocab=512)}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def train(arch, plan, mesh, seq, device) -> dict:
    """``STEPS`` AdamW steps from the seeded weights, unrealized (``mesh``
    None) or realized: losses, step times and the steps' launches."""
    params = smoke.init_model(
        torch, arch, device,
        torch.Generator(device=device).manual_seed(smoke.SEED))
    batches = smoke.batches_for(torch, arch, B, seq, STEPS, device)
    if mesh is None:
        opt = adamw_init(params)
    else:
        params, opt, place = realize(params, arch, plan, mesh)
        batches = [place(b) for b in batches]
    step = make_train_step(arch, plan, TrainConfig(
        optimizer=AdamWConfig(total_steps=STEPS, **smoke.TRAIN_OPT),
        **smoke.TRAIN_CFG))
    sync(device)
    ops.reset_launch_counts()
    losses, times = [], []
    for b in batches:
        t0 = time.perf_counter()
        with use_mesh(mesh):
            params, opt, met = step(params, opt, b)
        losses.append(float(met["loss"]))
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return {"loss": losses, "step_ms": times,
            "launches": {k: v for k, v in ops.launch_counts().items() if v}}


def serve(arch, plan, mesh, mode, reqs, device) -> dict:
    params = smoke.init_model(
        torch, arch, device,
        torch.Generator(device=device).manual_seed(smoke.SEED))
    with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        res, eng, toks = smoke.serve_once(
            torch, params, arch, reqs, mode=mode, dtype=torch.float32,
            device=device, max_batch=4, max_len=1024, plan=plan)
    del eng, params
    gc.collect()
    return {"tokens": toks, "launches": res["launches"],
            "itl_p50_ms": res["itl_p50_ms"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "mesh"
                                         / "families.json"))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    rank, world = init_distributed(device)
    if world != 4:
        raise SystemExit(f"run under torchrun with 4 ranks, not {world}")
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        torch.set_num_threads(1)
    mesh = make_smoke_mesh(2, 2, device.type)
    spec = h100_mesh_spec(1, 2, 2)
    log = print if rank == 0 else (lambda *a, **k: None)
    if rank == 0:
        log(smoke.card_line() if device.type == "cuda" else "cpu", flush=True)
    rows, bad = [], []

    def check(row, what, close):
        plain, real = row["unrealized"], row["realized"]
        if not close(plain[what], real[what]):
            bad.append(f"{row['case']}: {what} {real[what]} realized, "
                       f"{plain[what]} unrealized")
        if plain["launches"] != real["launches"]:
            bad.append(f"{row['case']}: launches {real['launches']} "
                       f"realized, {plain['launches']} unrealized")
        rows.append(row)
        log(json.dumps(row), flush=True)

    near = lambda a, b: len(a) == len(b) and all(
        abs(x - y) <= LOSS_TOL for x, y in zip(a, b))
    all_archs = archs()
    for tag, arch in all_archs.items():
        shapes = smoke.init_model(torch, arch, torch.device("cpu"),
                                  torch.Generator().manual_seed(smoke.SEED))
        plans = {
            "searched": search_phase_plan(arch, spec, "train",
                                          seq_len=args.seq, batch=B)[0],
            "model": baseline_phase_plan(arch, spec, "train", "model",
                                         seq_len=args.seq, batch=B)[0]}
        for kind, plan in plans.items():
            try:
                plain = train(arch, plan, None, args.seq, device)
                real = train(arch, plan, mesh, args.seq, device)
            except Exception:
                bad.append(f"train-{tag}-{kind}: {traceback.format_exc()}")
                log(bad[-1], flush=True)
                continue
            split = [p for p, s in _leaves(param_pspecs(shapes, arch, plan))
                     if "model" in str(s)]
            if kind == "model" and not split:
                bad.append(f"train-{tag}-model: nothing split on model")
            check({"case": f"train-{tag}-{kind}", "split_on_model": len(split),
                   "max_loss_diff": max(abs(x - y) for x, y in
                                        zip(plain["loss"], real["loss"])),
                   "unrealized": plain, "realized": real}, "loss", near)
    reqs = smoke.make_requests(512, n=args.requests, gen=args.gen)
    for tag, modes in SERVE.items():
        arch = all_archs[tag]
        plan = baseline_phase_plan(arch, spec, "decode", "model",
                                   seq_len=1024, batch=4)[0]
        for mode in modes:
            try:
                plain = serve(arch, plan, None, mode, reqs, device)
                real = serve(arch, plan, mesh, mode, reqs, device)
            except Exception:
                bad.append(f"serve-{tag}-{mode}: {traceback.format_exc()}")
                log(bad[-1], flush=True)
                continue
            check({"case": f"serve-{tag}-{mode}",
                   "unrealized": plain, "realized": real},
                  "tokens", lambda a, b: a == b)

    import torch.distributed as dist
    flags = [None] * world
    dist.all_gather_object(flags, bad)
    every = [f"rank {r}: {m}" for r, ms in enumerate(flags) for m in ms]
    summary = {"summary": "mesh-families", "mesh": {"data": 2, "model": 2},
               "device": device.type, "runs": len(rows),
               "failures": every}
    log(json.dumps(summary), flush=True)
    if rank == 0:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"rows": rows, **summary}, indent=1))
    dist.destroy_process_group()
    return 1 if every else 0


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield "/".join(path), tree


if __name__ == "__main__":
    sys.exit(main())
