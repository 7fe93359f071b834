"""Partition specs for every params / opt-state / cache / batch leaf from
a ModelPlan: the realized form of the searched strategy (the port's copy
of ``repro.plans.shardings``), and :func:`distribute`, which lays a
tensor tree out by them as DTensors.

Parameter rule table: each (sublayer, param) pair maps its tensor dims to
logical dims; the sublayer's LayerConfig supplies the mesh axes.  Stacked
(``stack.*``) leaves get a leading ``None`` for the unit dim.  When a plan
has several segments, parameters follow the *dominant* (most units)
segment's configs; the constraints inside each segment re-lay activations
out per segment.

Trees are nested dicts whose leaves are tensors (or anything with a
``shape``); spec trees mirror them with :class:`~repro_torch.core.sharding.P`
leaves.
"""

from __future__ import annotations

import math

from repro_torch.core.config import LayerConfig
from repro_torch.core.device import multi_pod_mesh_spec
from repro_torch.core.sharding import (P, NamedSharding, clean_spec, pspec,
                                       whole)
from repro_torch.models.arch import ArchConfig
from repro_torch.models.plan import ModelPlan, UnitPlan

R = LayerConfig.REPLICATED

# (sublayer key, param name) -> (cfg key, logical dims per tensor dim)
_RULES: dict[tuple[str, str], tuple[str, tuple]] = {
    ("attn", "wq"): ("attn", (None, "heads", None)),
    ("attn", "wk"): ("attn", (None, "heads", None)),
    ("attn", "wv"): ("attn", (None, "heads", None)),
    ("attn", "bq"): ("attn", ("heads", None)),
    ("attn", "bk"): ("attn", ("heads", None)),
    ("attn", "bv"): ("attn", ("heads", None)),
    ("attn", "q_norm"): ("attn", (None,)),
    ("attn", "k_norm"): ("attn", (None,)),
    ("attn", "wo"): ("attn_out", (None, None, "d_model")),
    ("xattn", "wq"): ("xattn", (None, "heads", None)),
    ("xattn", "wk"): ("xattn", (None, "heads", None)),
    ("xattn", "wv"): ("xattn", (None, "heads", None)),
    ("xattn", "bq"): ("xattn", ("heads", None)),
    ("xattn", "bk"): ("xattn", ("heads", None)),
    ("xattn", "bv"): ("xattn", ("heads", None)),
    ("xattn", "q_norm"): ("xattn", (None,)),
    ("xattn", "k_norm"): ("xattn", (None,)),
    ("xattn", "wo"): ("xattn_out", (None, None, "d_model")),
    ("mlp", "wi"): ("mlp_in", (None, "d_ff")),
    ("mlp", "wg"): ("mlp_in", (None, "d_ff")),
    ("mlp", "wo"): ("mlp_out", (None, "d_model")),
    ("moe", "router"): ("moe", (None, "expert")),
    ("moe", "wi"): ("moe", ("expert", None, "d_ff")),
    ("moe", "wg"): ("moe", ("expert", None, "d_ff")),
    ("moe", "wo"): ("moe", ("expert", "d_ff", None)),
    ("tmix", "wr"): ("tmix", (None, "d_model")),
    ("tmix", "wk"): ("tmix", (None, "d_model")),
    ("tmix", "wv"): ("tmix", (None, "d_model")),
    ("tmix", "wg"): ("tmix", (None, "d_model")),
    ("tmix", "wo"): ("tmix", ("d_model", None)),
    ("tmix", "w0"): ("tmix", ("d_model",)),
    ("tmix", "mu"): ("tmix", (None, None)),
    ("tmix", "w_lora_a"): ("tmix", (None, None)),
    ("tmix", "w_lora_b"): ("tmix", (None, "d_model")),
    ("tmix", "u"): ("tmix", (None, None)),
    ("tmix", "ln_x"): ("tmix", ("d_model",)),
    ("cmix", "wk"): ("cmix", (None, "d_ff")),
    ("cmix", "wv"): ("cmix", ("d_ff", None)),
    ("cmix", "wr"): ("cmix", (None, None)),
    ("cmix", "mu"): ("cmix", (None, None)),
    ("ssm", "in_proj"): ("ssm", (None, "d_model")),
    ("ssm", "conv_w"): ("ssm", (None, "d_model")),
    ("ssm", "conv_b"): ("ssm", ("d_model",)),
    ("ssm", "x_proj"): ("ssm", ("d_model", None)),
    ("ssm", "dt_proj"): ("ssm", (None, "d_model")),
    ("ssm", "dt_bias"): ("ssm", ("d_model",)),
    ("ssm", "A_log"): ("ssm", ("d_model", None)),
    ("ssm", "D"): ("ssm", ("d_model",)),
    ("ssm", "out_proj"): ("ssm", ("d_model", None)),
}


def _map(fn, tree, *rest, path=()):
    """``fn(path, leaf, *rest_leaves)`` over a nested dict."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    return fn(path, tree, *rest)


def tree_map(fn, tree, *rest):
    """``fn(leaf, *rest_leaves)`` over a nested dict (spec trees too)."""
    return _map(lambda _, *a: fn(*a), tree, *rest)


def dominant_unit_plan(segments) -> UnitPlan | None:
    if not segments:
        return None
    return max(segments, key=lambda s: s.n_units).plan


def add_fsdp_axes(spec: P, shape, cfg: LayerConfig, mesh_axis_sizes) -> P:
    """FSDP realization: distribute the replicating (pod/data/model) axes
    onto the largest free divisible dim of the stored param."""
    if not cfg.fsdp:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used: set[str] = set()
    for e in entries:
        if e is None:
            continue
        used.update(e if isinstance(e, tuple) else (e,))
    # FSDP shards over every axis not already sharding this param,
    # the batch axes included (that is what makes it ZeRO-3)
    axes = tuple(a for a in ("pod", "data", "model")
                 if a in mesh_axis_sizes and a not in used)
    while axes:
        deg = math.prod(mesh_axis_sizes[a] for a in axes)
        cands = [(shape[i], i) for i in range(len(shape))
                 if entries[i] is None and shape[i] % deg == 0]
        if cands:
            _, i = max(cands)
            entries[i] = axes if len(axes) > 1 else axes[0]
            return P(*entries)
        axes = axes[:-1]
    return spec


def param_pspecs(params, arch: ArchConfig, plan: ModelPlan, *, stages=None):
    """Spec tree mirroring ``params``.

    ``stages`` (a :class:`~repro_torch.core.stages.StageAssignment` with
    ``num_stages > 1``) places the stacked decoder parameters by pipeline
    stage: the leading unit dim of every ``stack.*`` leaf is sharded over
    the stage mesh axis, so each stage's device group holds its
    contiguous unit range."""
    dec_plan = dominant_unit_plan(plan.segments)
    enc_plan = dominant_unit_plan(plan.enc_segments)
    stage_axis = None
    if stages is not None and stages.num_stages > 1:
        stage_axis = stages.mesh_axis
    # mesh axis sizes are resolved in to_shardings; FSDP's choice of dim
    # uses the production superset, as the reference's does (axes a mesh
    # lacks are dropped downstream)
    sizes = {a.name: a.size for a in multi_pod_mesh_spec().axes}

    def leaf_spec(keys, leaf) -> P:
        top = keys[0]
        ndim = len(leaf.shape)
        if top == "embed":
            return add_fsdp_axes(pspec(plan.embed, ("vocab", "d_model")),
                                 leaf.shape, plan.embed, sizes)
        if top == "lm_head":
            return add_fsdp_axes(pspec(plan.lm_head, (None, "vocab")),
                                 leaf.shape, plan.lm_head, sizes)
        if top == "enc_in":
            return pspec(plan.enc_embed, (None, "d_model"))
        if top in ("final_norm", "enc_norm"):
            return P(*([None] * ndim))
        if top in ("stack", "enc_stack"):
            unit_plan = dec_plan if top == "stack" else enc_plan
            j = int(keys[1][1:])                    # "l{j}"
            sub = unit_plan[j] if unit_plan else {}
            sublayer, pname = keys[2], keys[3]
            lead = stage_axis if top == "stack" else None
            rule = (None if sublayer in ("ln1", "ln2", "ln_x")
                    else _RULES.get((sublayer, pname)))
            if rule is None:
                return P(*((lead,) + (None,) * (ndim - 1)))
            cfg_key, dims = rule
            cfg = sub.get(cfg_key, R)
            spec = add_fsdp_axes(pspec(cfg, dims), tuple(leaf.shape[1:]), cfg,
                                 sizes)
            return P(*((lead,) + tuple(spec)))
        return P(*([None] * ndim))

    return _map(leaf_spec, params)


def batch_pspecs(batch, plan: ModelPlan):
    """Input batch: the batch dim by the embed config's batch axes."""
    baxes = plan.embed.axes_for("batch")
    entry = baxes if len(baxes) > 1 else (baxes[0] if baxes else None)
    return tree_map(lambda leaf: P(*((entry,) + (None,)
                                     * (len(leaf.shape) - 1))), batch)


def cache_pspecs(cache, arch: ArchConfig, plan: ModelPlan, *,
                 paged: bool = False, slots_whole: bool = False):
    """KV/state cache: batch by the embed config's batch axes; KV heads /
    channels by the dominant plan's mixer config.

    With ``paged=True`` the KV leaves are the serve engine's block pool
    ``(units, num_blocks, block_size, KH, hd)``: the block and in-block
    token axes stay replicated (any slot's table can point at any block)
    while heads follow the decode-phase config as in the dense layout.

    ``slots_whole`` (the port's serve engine) leaves the batch (slot) and
    sequence dims unsplit: the engine binds, writes and reads one slot's
    rows at a time (admission, a chunk's row views, copy-on-write), and
    each such write must land in every holder's own shard."""
    dec_plan = dominant_unit_plan(plan.segments)

    def spec(cfg, dims):
        if slots_whole:
            dims = tuple(None if d in ("batch", "seq") else d for d in dims)
        return pspec(cfg, dims)

    def leaf_spec(keys, leaf) -> P:
        ndim = len(leaf.shape)
        lkey = next((k for k in keys if k.startswith("l") and k[1:].isdigit()),
                    None)
        if lkey is None:                    # an encoder-decoder's memory
            return spec(plan.embed, ("batch",) + (None,) * (ndim - 1))
        j = int(lkey[1:])
        sub = dec_plan[j] if dec_plan else {}
        if "kv" in keys:
            cfg = sub.get("attn", R)
            if paged:
                if ndim == 4:               # int8 scales (units, NB, bs, KH)
                    return spec(cfg, (None, None, None, "heads"))
                return spec(cfg, (None, None, None, "heads", None))
            return spec(cfg, (None, "batch", "seq", "heads", None))
        if "ssm_state" in keys:
            cfg = sub.get("ssm", R)
            dims = {"conv": (None, "batch", None, "d_model"),
                    "ssm": (None, "batch", "d_model", None)}
            return spec(cfg, dims.get(keys[-1], (None, "batch")
                                       + (None,) * (ndim - 2)))
        if "tmix_state" in keys or "cmix_state" in keys:
            cfg = sub.get("tmix", R)
            if keys[-1] == "shift":
                return spec(cfg, (None, "batch", "d_model"))
            return spec(cfg, (None, "batch") + (None,) * (ndim - 2))
        return P(*([None] * ndim))

    return _map(leaf_spec, cache)


def to_shardings(pspecs, mesh, like=None):
    """Spec tree -> :class:`~repro_torch.core.sharding.NamedSharding`
    tree on ``mesh`` (a ``DeviceMesh``, or a ``MeshSpec`` for the specs
    alone).  Drops axes the mesh lacks; with ``like`` (a matching tree of
    tensors or shapes' owners) also drops axes, left-first, until each
    dim divides evenly (8 KV heads on a 16-way axis -> replicated)."""
    if like is None:
        return tree_map(lambda s: NamedSharding(mesh, clean_spec(s, mesh)),
                        pspecs)
    return tree_map(lambda s, leaf: NamedSharding(
        mesh, clean_spec(s, mesh, tuple(leaf.shape))), pspecs, like)


def distribute(tree, shardings):
    """A tensor tree as DTensors laid out by ``shardings`` (a matching
    :func:`to_shardings` tree).  Every rank holds the same full tensors
    (made from one seed, or loaded), so each keeps its own shard and
    nothing is communicated."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, s):
        return distribute_tensor(t, s.mesh, s.placements,
                                 src_data_rank=None)
    return tree_map(one, tree, shardings)


def gather(tree):
    """A tree with DTensor leaves as full plain tensors (on every rank)."""
    return tree_map(whole, tree)
