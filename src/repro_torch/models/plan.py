"""ModelPlan: the realized form of a searched Strategy (the port's copy
of ``repro.models.plan``).

The search assigns a :class:`LayerConfig` to every *graph node* (named
``L{i}.{sub}``, see graph_export).  Models consume a :class:`ModelPlan`:
per-pattern-unit dicts of sublayer configs, grouped into **segments** of
consecutive units with identical plans (the reference compiles one loop
a segment) — the layer-wise strategy is exactly a segmentation.  On one
device the port's models take a plan and place nothing by it.

A ModelPlan is single-phase: it realizes one strategy for one workload
shape.  The phase-aware, serializable artifact carrying one ModelPlan per
train/prefill/decode phase is :class:`repro_torch.plans.ParallelPlan`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.config import LayerConfig
from repro_torch.core.graph import Strategy

from .arch import ArchConfig

R = LayerConfig.REPLICATED

# sublayer keys per (mixer, ffn)
def sublayer_keys(spec) -> list[str]:
    keys = ["ln1"]
    if spec.mixer == "attn":
        keys += ["attn", "attn_out"]
    elif spec.mixer == "mamba":
        keys += ["ssm"]
    elif spec.mixer == "rwkv":
        keys += ["tmix"]
    keys += ["add1", "ln2"]
    if spec.mixer == "rwkv":
        keys += ["cmix"]
    elif spec.ffn == "moe":
        keys += ["moe"]
    else:
        keys += ["mlp_in", "mlp_out"]
    keys += ["add2"]
    return keys


UnitPlan = tuple[dict[str, LayerConfig], ...]   # one dict per pattern layer


@dataclass(frozen=True)
class Segment:
    start: int          # unit index range [start, end)
    end: int
    plan: UnitPlan

    @property
    def n_units(self) -> int:
        return self.end - self.start


@dataclass(frozen=True)
class ModelPlan:
    embed: LayerConfig = R
    final_norm: LayerConfig = R
    lm_head: LayerConfig = R
    segments: tuple[Segment, ...] = ()
    # encoder-decoder extras
    enc_embed: LayerConfig = R
    enc_segments: tuple[Segment, ...] = ()

    def describe(self) -> str:
        lines = [f"embed: {self.embed.describe()}"]
        for seg in self.enc_segments:
            lines.append(f"enc units [{seg.start},{seg.end}):")
            for j, d in enumerate(seg.plan):
                lines.append(f"  l{j}: " + ", ".join(
                    f"{k}={v.describe()}" for k, v in d.items()))
        for seg in self.segments:
            lines.append(f"units [{seg.start},{seg.end}):")
            for j, d in enumerate(seg.plan):
                lines.append(f"  l{j}: " + ", ".join(
                    f"{k}={v.describe()}" for k, v in d.items()))
        lines.append(f"lm_head: {self.lm_head.describe()}")
        return "\n".join(lines)


def _unit_plan(arch: ArchConfig, cfg_fn, unit: int, prefix: str = "") -> UnitPlan:
    """Build one unit's plan via ``cfg_fn(node_name, sub_key)``."""
    dicts = []
    for j, spec in enumerate(arch.pattern):
        layer_idx = unit * arch.period + j
        d = {k: cfg_fn(f"{prefix}L{layer_idx}.{k}", k) for k in sublayer_keys(spec)}
        if prefix == "dec." or (prefix == "" and arch.enc_layers > 0):
            # decoder layers carry cross-attention sublayers
            for k in ("ln_x", "xattn", "xattn_out", "add_x"):
                d[k] = cfg_fn(f"{prefix}L{layer_idx}.{k}", k)
        dicts.append(d)
    return tuple(dicts)


def _segments(arch: ArchConfig, cfg_fn, n_units: int, prefix: str = ""
              ) -> tuple[Segment, ...]:
    plans = [_unit_plan(arch, cfg_fn, u, prefix) for u in range(n_units)]
    segs: list[Segment] = []
    start = 0
    for u in range(1, n_units + 1):
        if u == n_units or plans[u] != plans[start]:
            segs.append(Segment(start, u, plans[start]))
            start = u
    return tuple(segs)


def uniform_plan(arch: ArchConfig, cfg: LayerConfig | None = None,
                 data_axes: tuple[str, ...] = ("data",)) -> ModelPlan:
    """A single-config plan (default: batch over ``data_axes``)."""
    cfg = cfg if cfg is not None else LayerConfig.make(batch=data_axes)
    cfg_fn = lambda name, key: cfg
    kw = {}
    if arch.enc_layers:
        kw["enc_embed"] = cfg
        kw["enc_segments"] = _segments(
            _enc_view(arch), cfg_fn, arch.enc_layers, prefix="enc.")
    return ModelPlan(
        embed=cfg, final_norm=cfg, lm_head=cfg,
        segments=_segments(arch, cfg_fn, arch.n_units, prefix="dec." if arch.enc_layers else ""),
        **kw)


def _enc_view(arch: ArchConfig) -> ArchConfig:
    """Encoder stack seen as a period-1 attn+dense pattern."""
    import dataclasses

    from .arch import LayerSpec
    return dataclasses.replace(
        arch, n_layers=arch.enc_layers, enc_layers=0,
        pattern=(LayerSpec(mixer="attn", ffn="dense"),))


def strategy_to_plan(strategy: Strategy, arch: ArchConfig) -> ModelPlan:
    """Realize a searched Strategy as a ModelPlan (segment grouping)."""
    a = strategy.assignment

    def cfg_fn(name: str, key: str) -> LayerConfig:
        if name in a:
            return a[name]
        return R

    kw = {}
    dec_prefix = ""
    if arch.enc_layers:
        dec_prefix = "dec."
        kw["enc_embed"] = a.get("enc_embed", R)
        kw["enc_segments"] = _segments(
            _enc_view(arch), cfg_fn, arch.enc_layers, prefix="enc.")
    return ModelPlan(
        embed=a.get("embed", R),
        final_norm=a.get("final_norm", R),
        lm_head=a.get("lm_head", R),
        segments=_segments(arch, cfg_fn, arch.n_units, prefix=dec_prefix),
        **kw)
