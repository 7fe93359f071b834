"""The train step: the counterpart of ``repro.train.step``'s
``make_train_step``, for unstaged and pipeline-staged plans.

``make_train_step`` returns ``(params, opt_state, batch) -> (params,
opt_state, metrics)`` with:
  * optional microbatch gradient accumulation (float32 accumulators,
    divided by the microbatch count; metrics averaged over microbatches)
    for global batches that exceed memory;
  * remat of each layer unit (``torch.utils.checkpoint``);
  * AdamW with float32 moments, applied in place (the reference donates
    ``params`` and ``opt_state`` to its jitted step).

Gradients come from ``torch.autograd.grad`` of the port's ``loss_fn``
(``lm``'s, or ``encdec``'s for an encoder-decoder).
On the card the attention and WKV6 kernels run forward and their
``autograd.Function``s differentiate the plain versions, as the
reference's ``with_reference_vjp`` does.  ``TrainConfig.kernel_backend``
forces a dispatch backend around the whole step (forward, backward and
the remat recompute), as the reference's does.

On a realized plan (the caller runs the step under ``core.use_mesh``) the
parameters, the batch and the moments are DTensors (:func:`realize`; the
moments ZeRO-1, ``optim.zero1_state_pspecs``): the model runs its
activations per the plan's train phase, each gradient is brought to its
parameter's placement (the data-parallel reduction), the f32
accumulators follow, and the metrics come back as plain scalars.

A plan whose train phase is pipeline-staged (``stage_for("train")
.num_stages > 1``) runs this same step with ``M = stages.microbatches``
microbatches.  The reference's staged step is one program that every
rank runs whole, and its 1F1B order changes when each microbatch's
gradient is taken, not what it sums to: microbatch accumulation gives
the same update.  On a stage-factored mesh the ``stage`` axis shards
only the stack's storage; each step gathers the stack once.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch import tracing
from repro_torch.core.sharding import is_dtensor, whole
from repro_torch.kernels import dispatch as kernel_dispatch
from repro_torch.models import lm, model_module
from repro_torch.models.arch import ArchConfig
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               zero1_state_pspecs)
from repro_torch.plans.parallel_plan import as_model_plan
from repro_torch.plans.shardings import (batch_pspecs, distribute,
                                         param_pspecs, to_shardings)


@dataclass(frozen=True)
class TrainConfig:
    """The train step's settings.  ``time_chunk``, ``aux_coef`` and
    ``remat_policy`` reach the decoder-only ``lm`` alone: the
    encoder-decoder's loss takes none of them and, under ``remat``,
    recomputes every unit whole, as the reference's does."""
    optimizer: AdamWConfig = field(default_factory=AdamWConfig)
    microbatches: int = 1
    q_chunk: int = 512
    time_chunk: int = 64
    remat: bool = True
    remat_policy: str = "nothing"
    loss_chunk: int = 512
    aux_coef: float = 0.01
    # force a kernel dispatch backend ("cuda" | "xla" | "ref") for every op
    # of the step, a preference (kernels.dispatch); None = auto-select
    kernel_backend: str | None = None


def _like_param(g, t):
    """The gradient on its parameter's placement (a partial sum over the
    data axes is all-reduced here)."""
    if is_dtensor(t) and tuple(g.placements) != tuple(t.placements):
        return g.redistribute(t.device_mesh, t.placements)
    return g


def realize(params, arch: ArchConfig, plan, mesh, *, stages=None):
    """The train state on ``mesh`` by ``plan`` (a ``ModelPlan``): params
    by ``param_pspecs`` (with ``stages``, a pipeline ``StageAssignment``,
    the stack's unit dim over the stage axis), fresh AdamW state with
    ZeRO-1 moments over the data axes (``pod`` and ``data``, those the
    mesh has, as the reference's dry run lays them); returns (params,
    opt_state, place_batch), the last laying a batch out by
    ``batch_pspecs``."""
    specs = param_pspecs(params, arch, plan, stages=stages)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    moments = to_shardings(zero1_state_pspecs(specs, params, data_axes,
                                              sizes), mesh, like=params)
    params = distribute(params, to_shardings(specs, mesh, like=params))

    def place_batch(batch):
        return distribute(batch, to_shardings(batch_pspecs(batch, plan),
                                              mesh, like=batch))
    return params, adamw_init(params, moment_shardings=moments), place_batch


def make_train_step(arch: ArchConfig, plan=None,
                    cfg: TrainConfig | None = None):
    """``plan``: a ``ParallelPlan`` (its train phase, pipeline-staged or
    not), a ``ModelPlan`` or None (uniform).  On a realized plan the
    caller lays params, moments and batch out on the mesh
    (:func:`realize`) and runs the step under ``use_mesh``."""
    cfg = cfg or TrainConfig()
    stages = None
    stage_for = getattr(plan, "stage_for", None)     # a ParallelPlan
    if stage_for is not None and stage_for("train").num_stages > 1:
        stages = stage_for("train")
    plan = as_model_plan(plan, arch, "train")
    if cfg.microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {cfg.microbatches}")
    mod = model_module(arch)
    m = cfg.microbatches
    if stages is not None:
        if mod is not lm:
            raise ValueError(
                f"pipeline-staged training supports decoder-only LMs only; "
                f"{arch.name} maps to {mod.__name__} "
                f"(token-level pipelining for other families is a "
                f"follow-up)")
        if stages.n_units != arch.n_units:
            raise ValueError(
                f"stage assignment covers {stages.n_units} units but "
                f"{arch.name} has {arch.n_units}")
        m = max(1, stages.microbatches)
    kw = dict(q_chunk=cfg.q_chunk, remat=cfg.remat, loss_chunk=cfg.loss_chunk)
    if mod is lm:       # the encoder-decoder remats every unit whole
        kw.update(time_chunk=cfg.time_chunk, aux_coef=cfg.aux_coef,
                  remat_policy=cfg.remat_policy)

    def value_and_grad(params, batch):
        """(metrics, gradient leaves in ``lm.tree_leaves`` order)."""
        tree = lm.tree_map(lambda t: t.detach().requires_grad_(), params)
        leaves = [t for _, t in lm.tree_leaves(tree)]
        with tracing.span("train.forward"):
            loss, metrics = mod.loss_fn(tree, batch, arch, plan, **kw)
        with tracing.span("train.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            # a leaf the loss does not reach gets zeros, as under jax.grad
            grads = [torch.zeros_like(t) if g is None else _like_param(g, t)
                     for t, g in zip(leaves, grads)]
        return {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(params, opt_state, batch):
        with tracing.span("train.step"), \
                kernel_dispatch.force_backend(cfg.kernel_backend):
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        run = params
        if stages is not None:          # the stack whole, once a step
            run = dict(params, stack=lm.tree_map(_gather_stages,
                                                 params["stack"]))
        if m == 1:
            metrics, grads = value_and_grad(run, batch)
        else:
            acc, mets = None, []
            for mb in _microbatches(batch, m):
                met, g = value_and_grad(run, mb)
                mets.append(met)
                if acc is None:     # own copies: autograd may share one
                    acc = [x.to(torch.float32, copy=True) for x in g]
                else:               # in place: one accumulator alive
                    for a, x in zip(acc, g):
                        a.add_(x.float())
                del g               # before the next microbatch's backward
            grads = [a.div_(m) for a in acc]
            metrics = {k: torch.stack([d[k] for d in mets]).mean()
                       for k in mets[0]}
        it = iter(grads)
        grads = lm.tree_map(lambda t: _like_param(next(it), t), params)
        with tracing.span("train.optimizer"):
            params, opt_state, om = adamw_update(params, grads, opt_state,
                                                 cfg.optimizer)
        metrics.update(om)
        return params, opt_state, {k: whole(v) for k, v in metrics.items()}

    return train_step


def _gather_stages(a):
    """A stack leaf with its unit dim whole: a DTensor split over the
    stage axis (``Shard(0)``) is gathered there, anything else is
    returned as it is."""
    if not is_dtensor(a):
        return a
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if isinstance(p, Shard) and p.dim == 0 else p
          for p in a.placements]
    if pl == list(a.placements):
        return a
    return a.redistribute(a.device_mesh, pl)


def _microbatches(batch: dict, m: int) -> list[dict]:
    """``batch`` split into ``m`` microbatches of consecutive rows (the
    reference's reshape to (m, B / m, ...)).  A DTensor is gathered once
    and each microbatch laid out as the batch was."""
    B = batch["tokens"].shape[0]
    if B % m:
        raise ValueError(f"global batch {B} not divisible by microbatches "
                         f"{m}")
    n = B // m

    def split(v):
        full = whole(v)
        parts = [full[i * n:(i + 1) * n] for i in range(m)]
        if not is_dtensor(v):
            return parts
        from torch.distributed.tensor import DTensor, Replicate
        mesh, rep = v.device_mesh, [Replicate()] * v.device_mesh.ndim
        return [DTensor.from_local(t, mesh, rep, run_check=False)
                .redistribute(mesh, v.placements) for t in parts]

    splits = {k: split(v) for k, v in batch.items()}
    return [{k: parts[i] for k, parts in splits.items()} for i in range(m)]
