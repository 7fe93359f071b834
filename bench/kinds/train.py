"""Training cells: the port's ``make_train_step`` over token batches.

Set-up builds the one train step with its model and optimizer state,
drives it from the seed through its first ``check_steps`` steps (the
window's own call and feed), reads what the check compares, and hands the
same objects to the window.  The window runs whole steps, each ended by
``synchronize()``.  After the window, with the program's state freed,
the plain reference follows the same first steps from the same weights
and batches; the check compares each step's loss, the first clipped
gradient per leaf (the program's worked out from its first moment after
step 1), and the change of each leaf after the checked steps.  Where the
configuration's port side records a routing (``routing`` in
``bench/archs/<reference>.py``), the reference follows the program's and
the check also compares how far that routing lies from the reference's
own (``route_gap``).
"""

from __future__ import annotations

import contextlib
import gc
import time

from bench import core, gen, weights
from bench.kinds import Outcome, relative_gap, worst_leaf_gap
from bench.reference.adamw import AdamW, leaves

#: a leaf whose reference gradient norm is under this share of the median
#: leaf's moves by round-off alone under Adam: its change is not compared
ROUNDOFF_LEAF = 1e-3


def optimizer_config(traffic: dict) -> dict:
    import dataclasses

    from repro_torch.optim import AdamWConfig
    return dataclasses.asdict(AdamWConfig(**traffic["optimizer"]))


def _paths(cfg):
    return list(weights.shapes(cfg))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _change_norms(torch, cfg, seed, params, device):
    """Per leaf, the norm of its change since the seed's weights, each
    initial leaf drawn again alone."""
    out = {}
    for path in _paths(cfg):
        t0 = weights.leaf(cfg, seed, path, device)
        out["/".join(path)] = (_get(params, path).detach().float()
                               - t0.float()).norm()
        del t0
    return {k: float(v) for k, v in out.items()}


def run(run, device, options=None) -> Outcome:
    import torch
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import TrainConfig, make_train_step

    options = options or {}
    cfg, tr = run.config, run.traffic
    opt_cfg = optimizer_config(tr)
    arch = core.port_arch(cfg)
    n_check = tr["check_steps"]
    params = weights.make(cfg, run.seed, device)
    opt = adamw_init(params)
    step = make_train_step(arch, None, TrainConfig(
        optimizer=AdamWConfig(**opt_cfg), remat=tr["remat"],
        remat_policy=tr["remat_policy"],
        aux_coef=cfg.get("router_aux_loss_coef", 0.0)))
    step = _faulty(torch, step, options.get("fault"))
    batches = gen.TokenBatches(tr, cfg["vocab_size"], run.seed, device)

    # set-up: the first steps, through the window's own call and feed
    follow = getattr(core.port_side(cfg), "routing", None)
    losses, grad1, routes = [], None, []
    for i in range(n_check):
        routes.append([])
        with (follow(routes[-1]) if follow else contextlib.nullcontext()):
            params, opt, m = step(params, opt, {"tokens": batches.next()})
        losses.append(m["loss"])
        if i == 0:
            grad1 = {"/".join(p): (_get(opt["m"], p).norm()
                                   / (1 - opt_cfg["b1"])) for p in _paths(cfg)}
    prog = {"loss": [float(x) for x in losses],
            "grad1": {k: float(v) for k, v in grad1.items()},
            "change": _change_norms(torch, cfg, run.seed, params, device)}
    _sync(torch, device)

    tokens = tr["batch"] * tr["seq"]
    steps, step_losses = [], []

    def loop(until):
        nonlocal params, opt
        while True:
            t0 = time.perf_counter()
            with spans.host_span("train_step"):
                params, opt, m = step(params, opt,
                                      {"tokens": batches.next()})
                _sync(torch, device)
            t1 = time.perf_counter()
            steps.append((t0, t1))
            step_losses.append(m["loss"])
            if t1 >= until:
                return

    traced = run.traced and device.type == "cuda"
    spans = _spans(torch, traced)
    if traced:
        from bench import trace
        trace.warm(torch)
    run.t_open = time.perf_counter()
    end = run.t_open + run.seconds
    if traced:
        slice_s = min(tr["trace_seconds"], run.seconds / 2)
        loop(end - slice_s)
        run.slice = trace.profile_slice(
            torch, spans, lambda: loop(time.perf_counter() + slice_s))
        spans.restore()
    else:
        loop(end)
    run.t_close = steps[-1][1]
    run.data.update(steps=steps, tokens_per_step=tokens,
                    spans=spans if run.traced else None)
    failed = int((~torch.isfinite(torch.stack(step_losses))).sum())
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    del params, opt, step, batches, m, losses, step_losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference(torch, cfg, tr, run.seed, device, n_check,
                    routes=routes if follow else None)
    ref.pop("routes")
    values = compare(prog, ref)
    limits = run.cell.limits
    checks = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    dts = sorted(b - a for a, b in steps)
    window = {"steps": len(dts), "step_s_p50": dts[len(dts) // 2],
              "step_s_max": dts[-1],
              "worst_grad_leaf": worst_leaf(prog["grad1"], ref["grad1"]),
              "worst_change_leaf": worst_leaf(prog["change"], ref["change"])}
    return Outcome(attempted=len(steps), failed=failed, checks=checks,
                   memory_peak_bytes=peak,
                   readings={"program": prog, "reference": ref,
                             "window": window})


def compare(prog: dict, ref: dict) -> dict:
    """The numbers the check compares: the worst step's relative loss gap,
    the worst leaf's gap of first-gradient norms and of change norms
    (leaves whose reference gradient is round-off left out of the
    change), and, where the reference followed the program's routing,
    the most by which a routed expert lies below the reference's own
    top-k."""
    g = sorted(ref["grad1"].values())
    counted = {k for k, v in ref["grad1"].items()
               if v >= ROUNDOFF_LEAF * g[len(g) // 2]}
    out = {
        "loss_gap": max(relative_gap(a, b)
                        for a, b in zip(prog["loss"], ref["loss"])),
        "grad_gap": worst_leaf_gap(prog["grad1"], ref["grad1"]),
        "update_gap": worst_leaf_gap(prog["change"], ref["change"], counted),
    }
    if ref.get("route_gap") is not None:
        out["route_gap"] = ref["route_gap"]
    return out


def worst_leaf(prog: dict, ref: dict) -> str:
    return max(ref, key=lambda k: abs(prog[k] - ref[k]) / max(ref[k], 1e-30))


def control(run, device) -> dict:
    """The control: the reference in TF32 put in the program's place,
    against the reference in float32 (which follows the control's
    routing, as it follows the program's).  Returns its numbers
    (``values``) and the readings behind them."""
    import torch
    args = (torch, run.config, run.traffic, run.seed, device,
            run.traffic["check_steps"])
    low = reference(*args, tf32=True)
    ref = reference(*args, routes=low.pop("routes"))
    ref.pop("routes")
    return {"values": compare(low, ref),
            "readings": {"program": low, "reference": ref}}


def reference(torch, cfg, tr, seed, device, n_check, *, tf32=False,
              routes=None):
    """The plain reference's first ``n_check`` steps from the seed's
    weights and batches: each loss, the first clipped gradient's norm per
    leaf, and each leaf's change after the steps; with ``routes`` (one
    list of routings a step), each step follows its routing, and
    ``route_gap`` is the model's reading of them.  ``routes`` in the
    result: the routing each step took."""
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    params = weights.make(cfg, seed, device)
    tensors = [t.requires_grad_() for _, t in leaves(params)]
    names = ["/".join(p) for p, _ in leaves(params)]
    model = core.reference(cfg).Model(cfg, params, tf32=tf32)
    adam = AdamW(params, optimizer_config(tr))
    batches = gen.TokenBatches(tr, cfg["vocab_size"], seed, device)
    out = {"loss": [], "routes": []}
    for i in range(n_check):
        model.routes, model.taken = (routes[i] if routes else None), []
        loss = model.loss(batches.next())
        out["routes"].append(model.taken)
        grads = list(torch.autograd.grad(loss, tensors))
        out["loss"].append(float(loss.detach()))
        del loss
        norms = adam.step(grads)
        if i == 0:
            out["grad1"] = {n: float(g) for n, g in zip(names, norms)}
    out["change"] = _change_norms(torch, cfg, seed, params, device)
    out["route_gap"] = getattr(model, "route_gap", None) if routes else None
    return out


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _spans(torch, on: bool):
    """The spans a traced training run records: the MoE layer (forward
    and remat recompute) and the optimizer update on the device, with
    each MoE call's routing and each flash call's shapes."""
    from bench import trace
    spans = trace.Spans(torch)
    if not on:
        return spans
    import repro_torch.models.moe as moe
    import repro_torch.train.step as train_step
    from repro_torch.kernels import ops
    spans.wrap(moe, "moe_ffn", "moe_ffn")
    spans.wrap(moe, "route", "route", device=False,
               record=lambda a, kw, out: spans.records["route"].append(
                   (out[1], a[1].shape[1])))
    spans.wrap(train_step, "adamw_update", "optimizer")
    spans.wrap(ops, "flash_attention", "flash_attention", device=False,
               record=lambda a, kw, out: spans.records["flash"].append(
                   (tuple(a[0].shape), tuple(a[1].shape),
                    kw.get("causal", True), a[0].element_size())))
    return spans


def _faulty(torch, step, fault):
    """The train step with one planted fault, for the harness's own
    tests: ``frozen_state`` returns parameters and optimizer state
    unchanged; ``half_batch`` trains on the first half of each batch."""
    if fault is None:
        return step
    if fault == "half_batch":
        return lambda p, o, b: step(
            p, o, {"tokens": b["tokens"][: b["tokens"].shape[0] // 2]})
    if fault == "frozen_state":
        import repro_torch.train.step as train_step

        def frozen(p, o, b):
            real = train_step.adamw_update
            train_step.adamw_update = lambda params, g, state, c: (
                params, state, {})
            try:
                return step(p, o, b)
            finally:
                train_step.adamw_update = real
        return frozen
    raise ValueError(f"unknown fault {fault!r}")
