"""Per-device roofline counts of one step, from the ops a rank executes:
the port's counterpart of ``repro.launch.hlo_analysis``.

The reference parses XLA's compiled HLO, and has to multiply each
instruction by the trip counts of the loops around it (``lax.scan``
bodies appear once).  The port has no compiled artifact: PyTorch runs
eagerly, so the dry run (:mod:`repro_torch.launch.dryrun`) runs the step
itself on tensors without data and :class:`OpAccountant` sees every op a
rank executes, each once, as it executes.  Hence the module's other
name: there is no HLO to analyse, and no trip count is needed.

The accountant is a ``TorchDispatchMode``.  It lets DTensor dispatch
(returning ``NotImplemented`` for DTensor and DTensor's wrappers), so it
sees the **local** ops: the per-rank products, the redistributions'
collectives and the local pieces around them.  DTensor's sharding
propagation runs each op once more on its own fake tensors of the global
shapes, to infer the output's; those ops carry ``FakeTensor`` operands
and are not counted.  Counted are the ops on meta tensors (the dry run's
stand-ins for the card's):

* **FLOPs**: matmuls and convolutions, by ``torch.utils.flop_counter``'s
  formulas on the local shapes, plus the work each CUDA kernel's fake
  branch reports (:mod:`repro_torch.kernels.work`).
* **HBM bytes**: the tensor inputs (each once, however often the op
  takes it) and outputs of every op that launches device work, plus the
  kernels' reported bytes.  The port is eager, so
  unlike the TPU reference (which leaves out elementwise ops, as XLA
  fuses them) every elementwise op counts: on the card each one reads
  and writes HBM.  Views, ``empty*`` and metadata ops count 0.
* **Collective bytes and counts** per kind, under the reference's
  operand convention: an all-gather's operand is its output / g, a
  reduce-scatter's its output x g, the others their output; g is read
  from the collective's group.
* **Peak live device bytes**: the step's arguments (parameters, moments,
  batch, cache: :meth:`OpAccountant.add_arguments`), and each storage an
  op allocates from its allocation until it is freed.

Under an accountant a data-dependent op (``.item()``, a boolean mask, a
data-dependent shape) raises, as meta tensors hold no values.
"""

from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import work

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# functional collective op name -> the reference's kind
_KIND = {"all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
         "all_to_all_single": "all-to-all",
         "isend": "collective-permute", "irecv": "collective-permute",
         "batch_p2p_ops": "collective-permute"}
_COLL_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")
# ops that launch no device work: allocation, aliasing and metadata
_NO_WORK = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "_unsafe_view", "lift_fresh", "alias",
            "detach", "set_", "resize_", "_wrap_tensor_autograd",
            "wait_tensor"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(func, args) -> tuple[int, str]:
    """(g, group name) of a functional collective call."""
    name = func._schema.name.split("::")[1]
    group = args[-1]
    if name in ("all_gather_into_tensor", "all_gather_into_tensor_coalesced",
                "reduce_scatter_tensor", "reduce_scatter_tensor_coalesced"):
        return int(args[-2]), group
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group).size(), group


class OpAccountant(TorchDispatchMode):
    """Counts what one rank executes inside the ``with`` block (see the
    module docstring); :meth:`analysis` returns the reference's
    ``analyze`` keys and the memory."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.coll = {k: 0.0 for k in COLLECTIVES}
        self.coll_counts = {k: 0 for k in COLLECTIVES}
        self.coll_by_group: dict[str, float] = defaultdict(float)
        self._top: dict[tuple, list] = {}
        self.kernels: dict[str, dict] = {}
        self.ops = 0
        self.argument_bytes = 0
        self.live = 0
        self.peak = 0
        self.live_at_exit = 0
        self._storages: dict[int, int] = {}

    # -- memory ---------------------------------------------------------- #
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        if self._storages.pop(key, None) is not None:
            self.live -= n

    def add_arguments(self, *trees) -> None:
        """Count the step's arguments (nested dicts / sequences of tensors
        or DTensors; a DTensor by its local shard) as live from the
        start."""
        from repro_torch.core.sharding import is_dtensor
        for t in tree_leaves(trees):
            if not isinstance(t, torch.Tensor):
                continue
            local = t.to_local() if is_dtensor(t) else t
            before = self.live
            self._track(local)
            self.argument_bytes += self.live - before

    # -- kernels' fake launches ------------------------------------------- #
    def _kernel(self, name: str, w: work.Work) -> None:
        k = self.kernels.setdefault(
            name, {"launches": 0, "flops": 0.0, "bytes": 0.0, "exps": 0.0})
        k["launches"] += 1
        k["flops"] += w.flops
        k["bytes"] += w.bytes
        k["exps"] += w.exps
        self.flops += w.flops
        self.hbm_bytes += w.bytes

    def __enter__(self):
        self._recording = work.recording(self._kernel)
        self._recording.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        self.live_at_exit = self.live
        try:
            return super().__exit__(*exc)
        finally:
            self._recording.__exit__(*exc)

    # -- ops --------------------------------------------------------------- #
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch._subclasses.fake_tensor import FakeTensor
        if any(t not in (torch.Tensor, torch.nn.Parameter)
               and not issubclass(t, FakeTensor) for t in types):
            return NotImplemented    # DTensor: its local ops come back here
        out = func(*args, **kwargs)
        ins = list({id(a): a for a in tree_leaves((args, kwargs))
                    if isinstance(a, torch.Tensor)}.values())
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in ins + outs) or not any(
                t.is_meta for t in ins + outs):
            return out               # sharding propagation, or host work
        self.ops += 1
        for o in outs:
            self._track(o)
        ns, name = func._schema.name.split("::")
        if ns in _COLL_NAMESPACES and name in _KIND:
            self._collective(func, _KIND[name], args, ins, outs)
        elif name in _NO_WORK or func.is_view:
            return out
        else:
            self.hbm_bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            fn = self._flop_registry.get(func.overloadpacket)
            if fn is not None:
                self.flops += fn(*args, **kwargs, out_val=out)
        return out

    def _collective(self, func, kind, args, ins, outs) -> None:
        g, group = _group_size(func, args)
        out_b = sum(map(_nbytes, outs))
        operand = (out_b / max(1, g) if kind == "all-gather"
                   else out_b * g if kind == "reduce-scatter" else out_b)
        self.coll[kind] = self.coll.get(kind, 0.0) + operand
        self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
        self.coll_by_group[group] += operand
        self.hbm_bytes += sum(map(_nbytes, ins)) + out_b
        shape = ",".join(str(d) for d in outs[0].shape) if outs else ""
        dtype = str(outs[0].dtype).replace("torch.", "") if outs else ""
        key = (kind, f"{dtype}[{shape}]", group)
        entry = self._top.setdefault(key, [0.0, 0])
        entry[0] += operand
        entry[1] += 1

    # -- the result -------------------------------------------------------- #
    def analysis(self, group_names: dict[str, str] | None = None) -> dict:
        """The reference's ``analyze`` keys (``flops``, ``hbm_bytes``,
        ``collective_bytes`` with ``total``, ``collective_exec_counts``,
        ``top_collectives``), plus ``memory`` (argument and peak live
        bytes), the kernels' fake launches and their work, the ops
        counted, and the collective bytes per group (named by
        ``group_names``, group name -> mesh axis, where given)."""
        names = group_names or {}
        by_group: dict[str, float] = defaultdict(float)
        for g, b in self.coll_by_group.items():
            by_group[names.get(g, g)] += b
        top = sorted(((b, f"{kind} {shape} x{n} on "
                       f"{names.get(group, group)}")
                      for (kind, shape, group), (b, n)
                      in self._top.items()), reverse=True)
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": {**self.coll,
                                 "total": sum(self.coll.values())},
            "collective_exec_counts": dict(self.coll_counts),
            "top_collectives": [f"{b / 1e9:.1f}GB {d}" for b, d in top[:12]],
            "collective_bytes_by_group": dict(by_group),
            "memory": {"argument_bytes": self.argument_bytes,
                       "peak_bytes": self.peak,
                       "live_bytes_at_end": self.live_at_exit},
            "kernels": self.kernels,
            "ops": self.ops,
        }
