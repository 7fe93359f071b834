"""Realize :class:`LayerConfig` as DTensor placements: the port's
``repro.core.sharding``.

A searched strategy is *realized* by mapping each layer's config onto
partition specs for its activations and parameters, then constraining
the tensors inside the step.  The reference hands the specs to GSPMD
(``with_sharding_constraint``); here they become DTensor placements on a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`
whose dim names are the plan's axes (``pod``, ``data``, ``model``), and a
constraint is a ``DTensor.redistribute``.

A spec (:class:`P`) is a tuple with one entry per tensor dim: ``None``,
an axis name, or a tuple of axis names (several mesh dims on one tensor
dim, ``[Shard(d), Shard(d)]`` in DTensor).  DTensor shards several mesh
dims over one tensor dim in mesh-dim order, so a tuple entry must list
its axes in mesh order, as every plan does; :func:`placements` raises on
one that does not.

The active mesh is threaded through a process-wide slot, so model code
stays mesh-agnostic: without a mesh :func:`constrain` returns its input
object, and nothing in the port changes.  (The reference's slot is
thread-local; here the autograd engine recomputes checkpointed units on
its own device threads, which must see the mesh the forward ran under.)  Under :func:`use_mesh` the
model also runs under DTensor's ``implicit_replication``, so the plain
tensors a model makes itself (positions, masks, zeros) act as
replicated.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Sequence

import torch

from .config import LayerConfig

class _State:
    mesh = None


_state = _State()


class P(tuple):
    """A partition spec: ``P("data", None, ("data", "model"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def current_mesh():
    return _state.mesh


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh`` or None) the active mesh; with a
    mesh, plain tensors combine with DTensors as replicated."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        if mesh is None:
            yield mesh
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield mesh
    finally:
        _state.mesh = prev


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a cost-model
    ``MeshSpec``."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return {a.name: a.size for a in mesh.axes}


# --------------------------------------------------------------------------- #
DimName = str | None


def pspec(cfg: LayerConfig, dims: Sequence[DimName]) -> P:
    """Spec for a tensor whose dims carry the logical dims ``dims``
    (``None`` and dims the config does not shard are unsharded), e.g.
    ``("batch", "seq", "heads", None)`` for a (B, S, H, Dh) activation."""
    entries = []
    for d in dims:
        axes = cfg.axes_for(d) if d is not None else ()
        if len(axes) == 0:
            entries.append(None)
        elif len(axes) == 1:
            entries.append(axes[0])
        else:
            entries.append(tuple(axes))
    return P(*entries)


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def clean_spec(spec, mesh, shape=None) -> P:
    """Drop the axes ``mesh`` lacks (``pod`` on a one-node mesh); with
    ``shape``, also drop axes left-first until each dim divides evenly
    (8 KV heads on a 16-way axis -> replicated, the GQA fallback)."""
    sizes = axis_sizes(mesh)
    entries = []
    for i, e in enumerate(spec):
        axes = tuple(a for a in _axes(e) if a in sizes)
        if shape is not None:
            while axes and shape[i] % math.prod(sizes[a] for a in axes):
                axes = axes[1:]
        entries.append(None if not axes
                       else axes if len(axes) > 1 else axes[0])
    return P(*entries)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of ``jax.sharding
    .NamedSharding``)."""
    mesh: object
    spec: P

    @property
    def placements(self):
        return placements(self.spec, self.mesh)


def placements(spec, mesh) -> list:
    """DTensor placements (one per mesh dim) of a spec whose axes are all
    in ``mesh``: ``Shard(d)`` on the tensor dim whose entry names that
    mesh dim, ``Replicate()`` where none does."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for d, e in enumerate(spec):
        axes = _axes(e)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(
                f"spec entry {e!r} lists its axes out of mesh order "
                f"{tuple(names)}: DTensor would lay it out differently")
        for i in order:
            out[i] = Shard(d)
    return out


def sharding(cfg: LayerConfig, dims: Sequence[DimName],
             mesh=None) -> NamedSharding | None:
    """The config's spec for ``dims`` on ``mesh`` (default: the active
    one), with the axes the mesh lacks dropped; None without a mesh."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return None
    return NamedSharding(mesh, clean_spec(pspec(cfg, dims), mesh))


def is_dtensor(x) -> bool:
    if type(x) is torch.Tensor or not torch.is_tensor(x):
        return False        # the unrealized hot path imports nothing
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def whole(t):
    """``t`` as a plain tensor: a DTensor gathered (a collective every
    rank joins), anything else as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def place(x, s: NamedSharding):
    """``x`` laid out as ``s`` (a redistribute; a plain tensor counts as
    replicated, so placing it needs no communication)."""
    from torch.distributed.tensor import DTensor, Replicate
    pl = s.placements
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, s.mesh, [Replicate()] * len(pl),
                               run_check=False)
    if tuple(x.placements) == tuple(pl):
        return x
    return x.redistribute(s.mesh, pl)


def constrain(x: torch.Tensor, cfg: LayerConfig, dims: Sequence[DimName]):
    """``redistribute`` to the config's layout under the active mesh (the
    reference's ``with_sharding_constraint``); returns ``x`` itself
    without a mesh.  Entries whose shard count does not divide the dim
    are dropped left-first (8 KV heads on a 16-way model axis ->
    replicated KV, the standard GQA-TP fallback)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    spec = clean_spec(pspec(cfg, dims), mesh, tuple(x.shape))
    return place(x, NamedSharding(mesh, spec))


def constrain_tree(tree, cfg: LayerConfig, dims_tree):
    """Constrain a tree of dicts: ``dims_tree`` mirrors ``tree`` with dim
    tuples at its leaves."""
    if isinstance(tree, dict):
        return {k: constrain_tree(v, cfg, dims_tree[k])
                for k, v in tree.items()}
    return constrain(tree, cfg, dims_tree)


# --------------------------------------------------------------------------- #
# shard-local calls: how a kernel runs on a realized plan
# --------------------------------------------------------------------------- #
def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient leaves contiguous: a shard's gradient goes
    back into a DTensor that takes its local strides as they are."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def run_local(fn, args, roles, out_roles, *, allowed=("batch", "heads"),
              lead: int = 0, inplace=()):
    """Run ``fn`` on the local shards of ``args``, the way ``local_map``
    does, and re-wrap its outputs as DTensors.

    ``roles[i]`` names the logical dim of each of ``args[i]``'s dims
    (``"batch"``, ``"heads"``, ...; ``None`` for a dim never split, or
    ``roles[i] = None`` for an argument passed as it is).  The layout
    follows ``args[lead]``: a mesh dim that shards the lead on a dim whose
    role is in ``allowed`` stays on that role (if every argument with the
    role divides by its degree; else mesh dims drop, left-first); every
    other mesh dim is gathered, as GSPMD gathers around a custom call.
    Every argument is then redistributed to that layout (a plain tensor
    counts as replicated, so it is only sliced).

    Role ``"kv_heads"`` marks a GQA K/V heads dim: it is split with the
    query heads where its size divides, and otherwise stays whole (the
    reference's replicated-KV fallback).  ``fn`` then gets, as its first
    argument, the global offset of the local query heads, to pick the K/V
    heads of their global indices (:func:`kv_heads_for`).

    ``out_roles`` gives each output's roles (one tuple for a single
    output, a list of tuples for a tuple of outputs; None returns what
    ``fn`` returns).  The arguments at the indices ``inplace`` are written
    by ``fn``: they must already have the layout (a redistribute would
    write a copy), else the call raises.  Without a DTensor among
    ``args``, ``fn`` runs on them as they are."""
    gqa = any(r is not None and "kv_heads" in r for r in roles)
    if not any(is_dtensor(a) for a in args):
        return fn(0, *args) if gqa else fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    dts = [a for a in args if isinstance(a, DTensor)]
    mesh = dts[0].device_mesh
    sizes = list(mesh.mesh.shape)
    n = len(sizes)
    lead_t, lead_r = args[lead], roles[lead]
    mroles: list = [None] * n
    if isinstance(lead_t, DTensor):
        for i, pl in enumerate(lead_t.placements):
            if isinstance(pl, Shard) and lead_r[pl.dim] in allowed:
                mroles[i] = lead_r[pl.dim]
    for r in set(mroles) - {None}:
        while r in mroles:
            deg = math.prod(s for s, m in zip(sizes, mroles) if m == r)
            if all(a.shape[d] % deg == 0
                   for a, ro in zip(args, roles) if ro is not None
                   for d, rr in enumerate(ro) if rr == r):
                break
            mroles[mroles.index(r)] = None
    hdeg = math.prod(s for s, m in zip(sizes, mroles) if m == "heads")

    def target(a, ro):
        out = []
        for m in mroles:
            if m is not None and m in ro:
                out.append(Shard(ro.index(m)))
            elif (m == "heads" and "kv_heads" in ro
                  and a.shape[ro.index("kv_heads")] % hdeg == 0):
                out.append(Shard(ro.index("kv_heads")))
            else:
                out.append(Replicate())
        return out

    local = []
    for i, (a, ro) in enumerate(zip(args, roles)):
        if ro is None or not torch.is_tensor(a):
            local.append(a)
            continue
        pl = target(a, ro)
        whole = all(isinstance(p, Replicate) for p in pl)
        if i in inplace and not (whole and not isinstance(a, DTensor)) and (
                not isinstance(a, DTensor)
                or tuple(a.placements) != tuple(pl)):
            raise ValueError(
                f"an in-place operand laid out as "
                f"{getattr(a, 'placements', 'a plain tensor')} would need "
                f"{tuple(pl)}: its writes would land in a copy")
        if not isinstance(a, DTensor):
            if whole:
                local.append(a)
                continue
            a = DTensor.from_local(a, mesh, [Replicate()] * n,
                                   run_check=False)
        if tuple(a.placements) != tuple(pl):
            a = a.redistribute(mesh, pl)
        # an operand whole on a mesh dim that splits the call (a weight
        # over the batch shards, GQA K/V over the head shards) gets only
        # its shard's share of the gradient there: a partial sum
        grad_pl = [Partial() if isinstance(p, Replicate) and m is not None
                   else p for p, m in zip(pl, mroles)]
        a = a.to_local(grad_placements=grad_pl)
        local.append(_ContiguousGrad.apply(a) if a.requires_grad else a)
    if gqa:
        q_roles = roles[lead]
        _, off = compute_local_shape_and_global_offset(
            tuple(lead_t.shape), mesh, target(lead_t, q_roles))
        out = fn(off[q_roles.index("heads")], *local)
    else:
        out = fn(*local)

    def wrap(t, ro):
        pl = target(t, ro)
        shape = list(t.shape)
        for m, p in zip(sizes, pl):
            if isinstance(p, Shard):
                shape[p.dim] *= m
        missing = [m for m in mroles if m is not None and m not in ro]
        if missing:
            raise ValueError(f"output roles {ro} lack {missing}")
        return DTensor.from_local(t.contiguous(), mesh, pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=_contiguous_stride(shape))

    if out_roles is None:
        return out
    if isinstance(out_roles, list):
        return tuple(wrap(t, ro) for t, ro in zip(out, out_roles))
    return wrap(out, out_roles)


def contract(x, w, k: int = 1):
    """``x`` (..., *c) contracted with ``w`` (*c, *o) over the ``k`` dims
    ``c``: ``x @ w`` for a 2-D ``w``, else ``torch.tensordot`` (a q
    projection (d, H, hd) at ``k = 1``, an attention output (B, S, H, hd)
    with its (H, hd, D) projection at ``k = 2``), one GEMM either way.
    On DTensors the same product runs on the local shards, see
    :func:`einsum`."""
    def product(a, b):
        return a @ b if k == 1 and b.ndim == 2 else torch.tensordot(a, b,
                                                                    dims=k)
    if not (is_dtensor(x) or is_dtensor(w)):
        return product(x, w)
    letters = "abcdefghijklmnopqrstuvwxyz"
    lead, c = letters[:x.ndim - k], letters[x.ndim - k:x.ndim]
    own = letters[x.ndim:x.ndim + w.ndim - k]
    return _local_product(x, w, lead + c, c + own, lead + own, product)


def einsum(spec: str, x, w):
    """``torch.einsum(spec, x, w)`` of two operands whose every index
    letter appears once in each (an expert FFN's ``"becd,edf->becf"``).

    On DTensors the product runs on the local shards, with the placements
    DTensor's own product would give, because DTensor's product flattens
    dims into one, a view it cannot express when a dim is split over
    several mesh dims, or a later one of the merged dims is split (torch
    2.11 refuses it; 2.13 mislays the shards on the way back).  Per mesh
    dim, with x's partial sums reduced first: a dim only x has, split on
    x, stays split (w gathered there first); a dim both have, split on
    x, is split alike on w, and the output is split on it (a batch dim)
    or sums partially (``Partial``, a contracted one); split on w alone,
    a batch dim is sliced alike on x, a contracted one is gathered (a
    weight stored FSDP-split is used whole); a dim only w has, split on
    w, splits the output's."""
    if not (is_dtensor(x) or is_dtensor(w)):
        return torch.einsum(spec, x, w)
    ins, out = spec.replace(" ", "").split("->")
    xs, ws = ins.split(",")
    return _local_product(x, w, xs, ws, out,
                          lambda a, b: torch.einsum(spec, a, b))


def _local_product(x, w, xs: str, ws: str, os_: str, fn):
    """``fn`` of x's and w's local shards, x / w / the output indexed by
    the letters ``xs`` / ``ws`` / ``os_`` (see :func:`einsum`)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = (x if is_dtensor(x) else w).device_mesh
    n = mesh.ndim

    def as_dt(t):
        return t if is_dtensor(t) else DTensor.from_local(
            t, mesh, [Replicate()] * n, run_check=False)

    x, w = as_dt(x), as_dt(w)
    px, pw = list(x.placements), list(w.placements)
    out, gx, gw = [], [], []
    for i in range(n):
        a, b = px[i], pw[i]
        if a.is_partial():
            px[i] = a = Replicate()
        if a.is_shard() and type(a) is not Shard and (
                xs[a.dim] in ws or xs[a.dim] not in os_
                or os_.index(xs[a.dim]) != a.dim):
            px[i] = a = Replicate()          # a strided x: gathered
        if b.is_shard() and type(b) is not Shard:
            pw[i] = b = Replicate()          # a strided w: gathered
        if a.is_shard():
            letter = xs[a.dim]
            if letter not in ws:             # only x has it
                pw[i] = Replicate()
                out.append(a if letter in os_ else Partial())
                gx.append(a), gw.append(Partial())
                continue
            pw[i] = b = Shard(ws.index(letter))
        elif b.is_shard() and ws[b.dim] in os_ and ws[b.dim] in xs:
            px[i] = a = Shard(xs.index(ws[b.dim]))
        elif b.is_shard() and ws[b.dim] in xs:
            pw[i] = b = Replicate()          # FSDP: stored split, used whole
        if b.is_shard():
            letter = ws[b.dim]
            split = (Shard(os_.index(letter)) if letter in os_
                     else Partial())
            out.append(split)
            gx.append(a if letter in xs else Partial()), gw.append(b)
        else:
            out.append(Replicate()), gx.append(Replicate())
            gw.append(Replicate())
    if px != list(x.placements):
        x = x.redistribute(mesh, px)
    if pw != list(w.placements):
        w = w.redistribute(mesh, pw)
    y = fn(x.to_local(grad_placements=gx),
           w.to_local(grad_placements=gw)).contiguous()
    dims = {**dict(zip(xs, x.shape)), **dict(zip(ws, w.shape))}
    shape = tuple(dims[c] for c in os_)
    return DTensor.from_local(y, mesh, out, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def unflatten(t, dim: int, sizes):
    """``t.unflatten(dim, sizes)``; a DTensor split on ``dim`` by a degree
    that does not divide ``sizes[0]`` first drops mesh dims from that
    split, left-first, until it does (the split can only follow the new
    outer dim; DTensor's own view rule mislays the shards otherwise):
    4 heads over ``("data", "model")`` grouped as (2 KV heads, 2) keep
    ``model`` alone."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard
        d = dim % t.ndim
        n = list(t.device_mesh.mesh.shape)
        pl = list(t.placements)
        on_d = [i for i, p in enumerate(pl)
                if isinstance(p, Shard) and p.dim == d]
        while on_d and sizes[0] % math.prod(n[i] for i in on_d):
            pl[on_d.pop(0)] = Replicate()
        if pl != list(t.placements):
            t = t.redistribute(t.device_mesh, pl)
    return t.unflatten(dim, sizes)


def flatten_last2(t):
    """``t.flatten(-2)``; for a DTensor the result's layout is pinned, so
    the gradient reaches the flatten laid out as its output was (DTensor
    cannot split a dim whose gradient arrives divided by a degree that
    does not divide the outer size)."""
    t = t.flatten(-2)
    if is_dtensor(t):
        t = t.redistribute(t.device_mesh, t.placements)
    return t


def kv_heads_for(k, q_off: int, h_loc: int, G: int, dim: int):
    """K/V heads for the local query heads ``q_off .. q_off + h_loc`` of a
    GQA layer with ``G`` query heads a KV head: ``(k, G)`` when ``k``
    already holds exactly their KV heads (split with them, or whole with
    the query heads whole); otherwise (K/V whole, the query heads split:
    their degree does not divide the KV heads) the KV head of each query
    head's global index ``(q_off + h) // G``, gathered with one query head
    a KV head (returns ``(k', 1)``)."""
    if k.shape[dim] * G == h_loc:
        return k, G
    idx = (q_off + torch.arange(h_loc, device=k.device)) // G
    return k.index_select(dim, idx), 1
