"""Dry run of the port on the production meshes: run every (arch x
shape) cell's real step for one rank of a 256- or 512-GPU H100 cluster,
without a card and without allocating, and report what each GPU holds,
computes, moves and sends.  The counterpart of ``repro.launch.dryrun``:
the same cells, flags and JSON fields, priced for H100s, traced by
PyTorch.

Per cell:
  1. export the computation graph and run the strategy search (or a
     baseline) on the production mesh's cost model
     (:func:`~repro_torch.launch.mesh.production_mesh_spec`);
  2. realize the strategy as DTensor placements on a ``DeviceMesh`` of
     that shape over torch's fake process group, as its rank 0 sees it;
  3. run the step itself once (train: ``make_train_step``; prefill or
     decode: ``make_serve_fns``) on meta tensors under an
     :class:`~repro_torch.launch.op_analysis.OpAccountant`: no value is
     computed, every local op is seen once, every collective is shaped
     and never sent;
  4. record the per-device peak of live bytes (the fits-in-80-GB proof),
     the FLOPs, HBM bytes and collective bytes, and the roofline on the
     H100 SXM's spec-sheet rates, to ``results/dryrun_torch/<cell>.json``.

Meta tensors stand for the card's: on a torch built without CUDA,
autograd on fake CUDA tensors aborts the process (its graph nodes look
up the CUDA device guard), while a meta tensor holds no data on every
build and the kernel dispatcher sends it to each kernel's fake branch
(:mod:`repro_torch.kernels.work`), which applies the launcher's refusals
and reports the kernel's work.  So without ``--device-profile`` the dry
run needs no card, and no number in it is measured: every time in it is
a prediction from spec-sheet constants.  A step that needs a value
(``.item()``, a data-dependent shape) raises; the sweep reports it by
cell.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k \\
      --mesh single --strategy search
  python -m repro_torch.launch.dryrun --all [--mesh both] [--skip-existing]
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k \\
      --seq 256 --batch 8 --mesh-shape 1,1,1 --dtype float32
      (a cell the way one card trains it: one device, no mesh)
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.core import BASELINES, CostModel, Strategy, find_strategy
from repro_torch.core.search import fsdp_stored
from repro_torch.core.device import (H100_HBM_BW, H100_HBM_BYTES,
                                     H100_PEAK_FLOPS, H100_PEAK_FLOPS_F32,
                                     h100_mesh_spec)
from repro_torch.core.sharding import use_mesh
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import fake_mesh, production_mesh_spec
from repro_torch.launch.op_analysis import OpAccountant
from repro_torch.models import (init_params, model_module, is_encdec,
                                strategy_to_plan)
from repro_torch.models.arch import SHAPES, ShapeSpec
from repro_torch.models.graph_export import export_graph
from repro_torch.optim import adamw_init
from repro_torch.plans.shardings import (batch_pspecs, cache_pspecs,
                                         distribute, param_pspecs,
                                         to_shardings)
from repro_torch.serve import make_serve_fns
from repro_torch.train import TrainConfig, make_train_step, realize

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
DEVICE = "H100_SXM (spec sheet)"
#: the tensors' device: meta stands for the card's (see the docstring)
META = torch.device("meta")

# H100 SXM roofline constants (per GPU): raw spec-sheet peaks, not the
# cost model's derated rates; the step's dtype picks the FLOP peak
PEAK_FLOPS = {torch.bfloat16: H100_PEAK_FLOPS,
              torch.float32: H100_PEAK_FLOPS_F32}
HBM_BW = H100_HBM_BW
HBM_BYTES = H100_HBM_BYTES
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def input_specs(arch, shape, *, dtype=torch.bfloat16) -> dict:
    """Meta-tensor stand-ins for every model input of a cell (the
    reference's ``ShapeDtypeStruct``\\ s)."""
    B, S = shape.global_batch, shape.seq_len
    spec = lambda *s, dt=dtype: torch.empty(s, dtype=dt, device=META)
    if arch.enc_layers:
        Se = min(4096, max(16, S // 2)) if shape.kind == "decode" else S // 2
        Sd = S if shape.kind == "decode" else S // 2
        batch = {"frames": spec(B, Se, arch.d_model),
                 "tokens": spec(B, Sd, dt=torch.int32)}
        return {"batch": batch, "dec_len": Sd, "enc_len": Se}
    if arch.frontend:
        F = arch.frontend_tokens
        batch = {"tokens": spec(B, S - F, dt=torch.int32),
                 "frontend": spec(B, F, arch.d_model)}
        return {"batch": batch, "dec_len": S, "enc_len": 0}
    return {"batch": {"tokens": spec(B, S, dt=torch.int32)},
            "dec_len": S, "enc_len": 0}


def build_strategy(arch, shape, mesh_spec, strategy_name: str, *,
                   num_stages: int = 0, microbatches: int = 8,
                   profile=None, fsdp: bool = False):
    """Search (or apply a baseline to) one cell's graph; ``num_stages``
    routes a train-kind search through the two-level pipeline search
    (>1 forces the count, <0 auto-searches); ``profile`` (a measured
    DeviceProfile) calibrates the cost model first; ``fsdp`` stores every
    layer with over 1 MB of parameters FSDP-sharded over the axes that
    replicate it (``core.search.fsdp_stored``, as the search's
    memory-budget fallback stores the baselines).  Returns (graph, strategy, comm bytes, StagedStrategy |
    None)."""
    graph = export_graph(arch, shape)
    cm = CostModel.from_profile(profile, mesh_spec, phase=shape.kind)
    mesh_spec = cm.mesh
    staged = None
    if strategy_name == "search":
        if num_stages not in (0, 1) and shape.kind == "train":
            from repro_torch.core.stages import find_staged_strategy
            staged = find_staged_strategy(
                graph, mesh_spec, n_units=arch.n_units, phase=shape.kind,
                num_stages=num_stages if num_stages > 1 else None,
                max_stages=arch.n_units if num_stages < 0 else None,
                microbatches=microbatches, profile=profile)
            strat = staged.strategy
            strat.cost = staged.cost
        else:
            strat = find_strategy(graph, mesh_spec, phase=shape.kind,
                                  profile=profile)
    else:
        strat = BASELINES[strategy_name](graph, mesh_spec)
    if fsdp:
        strat = Strategy(fsdp_stored(graph, mesh_spec, strat).assignment,
                         meta=strat.meta)
    if fsdp or strategy_name != "search":
        strat.cost = cm.total_time(graph, strat)
    comm = cm.comm_bytes(graph, strat)
    return graph, strat, comm, staged


def _cut(arch, depth: int):
    """``arch`` cut to ``depth`` layers (0 keeps it), named as the smoke
    names its cuts (``olmoe-1b-7b-d8``)."""
    if not depth:
        return arch
    from repro_torch.launch.train import reduced_arch
    return dataclasses.replace(reduced_arch(arch, 0, depth, 0),
                               name=f"{arch.name}-d{depth}")


def _print_plan(strat, graph, mesh_spec, shape, staged) -> None:
    print(strat.describe(graph, mesh_spec))
    if staged is None:
        return
    pipe = staged.meta.get("pipeline", {})
    print(f"stages [{shape.kind}]: {staged.stages.describe()} "
          f"on axis {staged.meta.get('factored_axis')!r}")
    for s in range(staged.stages.num_stages):
        b0, b1 = staged.stages.unit_range(s)
        print(f"  stage {s}: units [{b0},{b1}) "
              f"cost={staged.stage_costs[s]:.6f}s")
    print(f"  pipeline: total={staged.cost:.6f}s "
          f"bubble={staged.bubble_frac:.3f} "
          f"interstage={staged.interstage_bytes:.0f}B "
          f"xfer={pipe.get('xfer_s', 0.0):.6f}s")


def _lay_out(tree, specs, mesh):
    return tree if mesh is None else distribute(
        tree, to_shardings(specs, mesh, like=tree))


def _run_step(arch, shape, plan, mesh, dtype, train_cfg):
    """One step of the cell on meta tensors (under ``use_mesh(mesh)``;
    ``mesh`` None: one device, nothing realized); returns the accountant
    that counted it and the train config used."""
    mod = model_module(arch)
    specs = input_specs(arch, shape, dtype=dtype)
    batch = specs["batch"]
    params = init_params(arch, dtype, generator=torch.Generator(),
                         device=META)
    acc = OpAccountant()
    if shape.kind == "train":
        if train_cfg is None:
            # the reference's gradient-accumulation heuristic: big-width
            # models microbatch the global batch
            mb = (1 if arch.d_model <= 2048
                  else 4 if arch.d_model <= 4096 else 16)
            train_cfg = TrainConfig(microbatches=mb)
        if mesh is None:
            opt = adamw_init(params)
        else:
            params, opt, place_batch = realize(params, arch, plan, mesh)
            batch = place_batch(batch)
        step = make_train_step(arch, plan, train_cfg)
        acc.add_arguments(params, opt, batch)
        with acc:
            out = step(params, opt, batch)
        del out
        return acc, train_cfg
    params = _lay_out(params, param_pspecs(params, arch, plan), mesh)
    prefill_fn, decode_fn = make_serve_fns(arch, plan)
    cache_kw = {"enc_len": specs["enc_len"]} if is_encdec(arch) else {}
    cache = mod.init_cache(arch, shape.global_batch, specs["dec_len"],
                           dtype, device=META, **cache_kw)
    # laid out as the port's serve engine lays it (slot and sequence dims
    # whole, heads split): the kernels write the cache in place on local
    # shards, which a split sequence dim would turn into a copy
    cache = _lay_out(cache, cache_pspecs(cache, arch, plan,
                                         slots_whole=True), mesh)
    if shape.kind == "prefill":
        batch = _lay_out(batch, batch_pspecs(batch, plan), mesh)
        acc.add_arguments(params, batch, cache)
        with acc:
            out = prefill_fn(params, batch, cache)
    else:  # decode: one new token against a full cache
        tok = {"t": torch.empty((shape.global_batch, 1), dtype=torch.int32,
                                device=META)}
        tok = _lay_out(tok, batch_pspecs(tok, plan), mesh)["t"]
        acc.add_arguments(params, tok, cache)
        with acc:
            out = decode_fn(params, tok, cache, 0)
    del out
    return acc, train_cfg


def cell_mesh_and_id(arch, shape: ShapeSpec, *, multi_pod: bool = False,
                     mesh_shape=None, strategy_name: str = "search",
                     fsdp: bool = False, tag: str = ""):
    """A cell's mesh spec, the mesh's name and the cell's id, the name of
    its JSON under ``RESULTS``: ``mesh_shape`` ``(nodes, data, model)`` in
    place of the production mesh is named ``NxDxM``."""
    if mesh_shape is not None:
        mesh_spec = h100_mesh_spec(*mesh_shape)
        mesh_tag = "x".join(str(n) for n in mesh_shape)
    else:
        mesh_spec = production_mesh_spec(multi_pod=multi_pod)
        mesh_tag = "multi" if multi_pod else "single"
    return mesh_spec, mesh_tag, (
        f"{arch.name}__{shape.name}__{mesh_tag}__{strategy_name}"
        f"{'+fsdp' if fsdp else ''}{tag}")


def dryrun_cell(arch_name: str, shape_name: str, *, multi_pod: bool,
                strategy_name: str = "search", dtype=torch.bfloat16,
                train_cfg: TrainConfig | None = None, plan_override=None,
                save: bool = True, tag: str = "",
                num_stages: int = 0, microbatches: int = 8,
                show_plan: bool = False, profile_path: str = "",
                shape: ShapeSpec | None = None, mesh_shape=None,
                depth: int = 0, fsdp: bool = False) -> dict:
    """One cell; ``shape`` (a ``ShapeSpec``) replaces ``SHAPES[shape_name]``
    and ``mesh_shape`` ``(nodes, data, model)`` the production mesh
    (``h100_mesh_spec``; one device runs unrealized, as one card trains),
    ``depth`` cuts the arch: the cells a one-card run actually runs."""
    arch = _cut(configs.get(arch_name), depth)
    shape = shape or SHAPES[shape_name]
    mesh_spec, mesh_tag, cell_id = cell_mesh_and_id(
        arch, shape, multi_pod=multi_pod, mesh_shape=mesh_shape,
        strategy_name=strategy_name, fsdp=fsdp, tag=tag)
    skip = arch.skip_reason(shape)
    if skip:
        return {"cell": cell_id, "status": "skipped", "reason": skip}

    profile = None
    if profile_path:
        from repro_torch.profiling import load_profile
        profile = load_profile(profile_path)
        print(f"dryrun: device profile {profile_path} "
              f"[{profile.device_kind}] calibrates the cost model")

    t0 = time.time()
    graph, strat, model_comm, staged = build_strategy(
        arch, shape, mesh_spec, strategy_name,
        num_stages=num_stages, microbatches=microbatches, profile=profile,
        fsdp=fsdp)
    calib = None
    if profile is not None:
        # predicted-vs-measured per layer: the calibrated roofline against
        # a timed equivalent of each layer's per-device work on the card
        from repro_torch.profiling import format_layer_report, layer_report
        cm_cal = CostModel.from_profile(profile, mesh_spec,
                                        phase=shape.kind)
        calib = layer_report(graph, cm_cal, strat,
                             device=resolve_device(None))
        print(format_layer_report(calib))
    if show_plan or staged is not None:
        _print_plan(strat, graph, mesh_spec, shape, staged)
    plan = plan_override or strategy_to_plan(strat, arch)

    one = mesh_spec.num_devices == 1
    with (contextlib.nullcontext() if one else fake_mesh(mesh_spec)) as mesh:
        group_axes = ({} if one else {mesh.get_group(a).group_name: a
                                      for a in mesh.mesh_dim_names})
        with use_mesh(mesh):
            acc, train_cfg = _run_step(arch, shape, plan, mesh, dtype,
                                       train_cfg)
        deep = acc.analysis(group_axes)

    mem = deep["memory"]
    per_dev_bytes = mem["peak_bytes"]
    compute_s = deep["flops"] / PEAK_FLOPS[dtype]
    memory_s = deep["hbm_bytes"] / HBM_BW
    coll_s = sum(b / mesh_spec.axis(a).bw
                 for a, b in deep["collective_bytes_by_group"].items())
    result = {
        "cell": cell_id,
        "status": "ok",
        "arch": arch.name,
        "shape": shape.name,
        "mesh": mesh_tag,
        "strategy": strategy_name,
        "n_chips": mesh_spec.num_devices,
        "device": DEVICE,
        "dtype": str(dtype).replace("torch.", ""),
        "train_microbatches": (train_cfg.microbatches
                               if shape.kind == "train" else None),
        "search_cost_s": strat.cost,
        "search_seconds": strat.meta.get("search_seconds"),
        "device_profile": strat.meta.get("device_profile"),
        "calibration": (None if calib is None else {
            "median_rel_error": calib["median_rel_error"],
            "max_rel_error": calib["max_rel_error"],
            "num_layers": calib["num_layers"],
            "worst_layers": sorted(calib["layers"],
                                   key=lambda r: -r["rel_error"])[:5],
        }),
        "model_comm_bytes": model_comm,
        "pipeline": (None if staged is None else {
            "stage_count": staged.stages.num_stages,
            "boundaries": list(staged.stages.boundaries),
            "microbatches": staged.stages.microbatches,
            "bubble_frac": staged.bubble_frac,
            "interstage_bytes": staged.interstage_bytes,
            "stage_costs_s": list(staged.stage_costs),
            "stage_search_seconds": staged.meta.get("stage_search_seconds"),
        }),
        # the peak of live bytes over the step, the arguments included
        # (the reference's argument + output + temp - alias); the step
        # updates parameters and moments in place (the reference donates
        # them), so nothing aliases
        "hbm": {
            "argument_bytes": mem["argument_bytes"],
            "output_bytes": mem["live_bytes_at_end"] - mem["argument_bytes"],
            "temp_bytes": per_dev_bytes - mem["argument_bytes"],
            "alias_bytes": 0,
            "per_device_total": per_dev_bytes,
            "fits_80GB": bool(per_dev_bytes < HBM_BYTES),
        },
        "hlo_flops_per_device": deep["flops"],
        "hlo_bytes_per_device": deep["hbm_bytes"],
        # no compiled artifact, so no single-visit cost analysis beside the
        # op counts (which see every executed op once)
        "xla_cost_analysis": {"flops": None, "bytes": None},
        "collective_bytes_per_device": deep["collective_bytes"],
        "collective_bytes_per_axis": deep["collective_bytes_by_group"],
        "collective_counts": deep["collective_exec_counts"],
        "collective_exec_counts": deep["collective_exec_counts"],
        "top_collectives": deep["top_collectives"],
        "kernels": deep["kernels"],
        "ops_counted": deep["ops"],
        "roofline": {
            "compute_s": compute_s,
            "memory_s": memory_s,
            "collective_s": coll_s,
            "dominant": max(
                [("compute", compute_s), ("memory", memory_s),
                 ("collective", coll_s)], key=lambda kv: kv[1])[0],
        },
        "wall_seconds": time.time() - t0,
    }
    if save:
        RESULTS.mkdir(parents=True, exist_ok=True)
        with open(RESULTS / f"{cell_id}.json", "w") as f:
            json.dump(result, f, indent=1)
    return result


def iter_cells():
    for arch_name in configs.ALL_ARCHS:
        for shape_name in SHAPES:
            yield arch_name, shape_name


def summary(r: dict) -> str:
    rf = r["roofline"]
    return (f"mem/dev={r['hbm']['per_device_total'] / 1e9:.2f}GB "
            f"fits={r['hbm']['fits_80GB']} "
            f"compute={rf['compute_s'] * 1e3:.2f}ms "
            f"memory={rf['memory_s'] * 1e3:.2f}ms "
            f"coll={rf['collective_s'] * 1e3:.2f}ms "
            f"dominant={rf['dominant']} wall={r['wall_seconds']:.0f}s")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--strategy", default="search",
                    choices=["search", "data", "model", "owt"])
    ap.add_argument("--stages", type=int, default=0,
                    help="pipeline-stage the train-kind search: >1 forces "
                         "that stage count, -1 auto-searches; prints the "
                         "stage assignment and pipeline cost breakdown "
                         "next to the per-layer table")
    ap.add_argument("--microbatches", type=int, default=8,
                    help="1F1B microbatch count M the pipeline is priced "
                         "with (used with --stages)")
    ap.add_argument("--show-plan", action="store_true",
                    help="print the searched per-layer table for every cell")
    ap.add_argument("--device-profile", default="",
                    help="measured DeviceProfile JSON (launch.profile); "
                         "calibrates the search cost model and prints a "
                         "per-layer predicted-vs-measured report (timed "
                         "on the card)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--seq", type=int, default=0,
                    help="with --batch: a custom shape of --shape's kind, "
                         "trained in one microbatch as the train command "
                         "trains (the reference's microbatch heuristic is "
                         "for the published shapes' 1M-token batches)")
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--depth", type=int, default=0,
                    help="cut the arch to this many layers (0: published)")
    ap.add_argument("--mesh-shape", default="",
                    help="nodes,data,model of an H100 mesh in place of "
                         "--mesh (1,1,1: one card, nothing realized)")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--fsdp", action="store_true",
                    help="store the strategy's parameter-bearing layers "
                         "FSDP-sharded")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    mesh_shape = (tuple(int(n) for n in args.mesh_shape.split(","))
                  if args.mesh_shape else None)
    if mesh_shape is not None:
        meshes = [False]
    cells = (list(iter_cells()) if args.all
             else [(args.arch, args.shape)])
    failures = 0
    for arch_name, shape_name in cells:
        shape = None
        if args.seq or args.batch:
            base = SHAPES[shape_name]
            shape = dataclasses.replace(
                base, name=f"{base.kind}_{args.batch}x{args.seq}",
                seq_len=args.seq, global_batch=args.batch)
        arch = _cut(configs.get(arch_name), args.depth)
        for mp in meshes:
            _, _, tagname = cell_mesh_and_id(
                arch, shape or SHAPES[shape_name], multi_pod=mp,
                mesh_shape=mesh_shape, strategy_name=args.strategy,
                fsdp=args.fsdp)
            if args.skip_existing and (RESULTS / f"{tagname}.json").exists():
                print(f"[skip existing] {tagname}")
                continue
            try:
                r = dryrun_cell(arch_name, shape_name, multi_pod=mp,
                                strategy_name=args.strategy,
                                dtype=DTYPES[args.dtype],
                                train_cfg=(TrainConfig() if shape else None),
                                num_stages=args.stages,
                                microbatches=args.microbatches,
                                show_plan=args.show_plan,
                                profile_path=args.device_profile,
                                shape=shape, mesh_shape=mesh_shape,
                                depth=args.depth, fsdp=args.fsdp)
                if r["status"] == "skipped":
                    print(f"[SKIPPED] {r['cell']}: {r['reason']}")
                    RESULTS.mkdir(parents=True, exist_ok=True)
                    with open(RESULTS / f"{r['cell']}.json", "w") as f:
                        json.dump(r, f, indent=1)
                else:
                    print(f"[OK] {r['cell']}: {summary(r)}")
                    print(f"result: {RESULTS / (r['cell'] + '.json')}")
            except Exception:
                failures += 1
                print(f"[FAIL] {tagname}")
                traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
