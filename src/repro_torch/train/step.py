"""The train step: the counterpart of ``repro.train.step``'s unstaged
``make_train_step``.

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
reference's ``with_reference_vjp`` does.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.models import lm, model_module
from repro_torch.models.arch import ArchConfig
from repro_torch.optim import AdamWConfig, adamw_update


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


def _check_unstaged(plan) -> None:
    """A ``ParallelPlan`` (anything with ``stage_for``) whose train phase
    is pipeline-staged needs the 1F1B step, which the port lacks.  Any
    other plan (a ``ModelPlan``) only places tensors, a no-op on one
    device."""
    stage_for = getattr(plan, "stage_for", None)
    if stage_for is not None and stage_for("train").num_stages > 1:
        raise NotImplementedError(
            "a pipeline-staged (1F1B) train step arrives with the "
            "realization slice (ROADMAP.md A7); the port trains unstaged")


def make_train_step(arch: ArchConfig, plan=None,
                    cfg: TrainConfig | None = None):
    cfg = cfg or TrainConfig()
    _check_unstaged(plan)
    if cfg.microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {cfg.microbatches}")
    mod = model_module(arch)
    kw = dict(q_chunk=cfg.q_chunk, remat=cfg.remat, loss_chunk=cfg.loss_chunk)
    if mod is lm:       # the encoder-decoder remats every unit whole
        kw.update(time_chunk=cfg.time_chunk, aux_coef=cfg.aux_coef,
                  remat_policy=cfg.remat_policy)

    def value_and_grad(params, batch):
        """(metrics, gradient leaves in ``lm.tree_leaves`` order)."""
        tree = lm.tree_map(lambda t: t.detach().requires_grad_(), params)
        leaves = [t for _, t in lm.tree_leaves(tree)]
        loss, metrics = mod.loss_fn(tree, batch, arch, plan, **kw)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not reach gets zeros, as under jax.grad
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        return {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(params, opt_state, batch):
        m = cfg.microbatches
        if m == 1:
            metrics, grads = value_and_grad(params, batch)
        else:
            B = batch["tokens"].shape[0]
            if B % m:
                raise ValueError(f"batch {B} does not split into {m} "
                                 f"microbatches")
            n = B // m
            acc, mets = None, []
            for i in range(m):
                met, g = value_and_grad(
                    params, {k: v[i * n:(i + 1) * n]
                             for k, v in batch.items()})
                mets.append(met)
                acc = ([x.float() for x in g] if acc is None
                       else [a + x.float() for a, x in zip(acc, g)])
            grads = [a / m for a in acc]
            metrics = {k: torch.stack([d[k] for d in mets]).mean()
                       for k in mets[0]}
        it = iter(grads)
        grads = lm.tree_map(lambda _: next(it), params)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             cfg.optimizer)
        metrics.update(om)
        return params, opt_state, metrics

    return train_step
