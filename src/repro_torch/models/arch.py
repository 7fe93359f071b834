"""Architecture configuration schema + assigned input shapes.

Every assigned architecture is expressed as an :class:`ArchConfig`; the model
builders in this package consume it.  A repeating **layer pattern** (length
``period``) describes heterogeneous stacks (Jamba's 1:7 attn:mamba
interleave, MoE-every-k) so the layer stack can be ``lax.scan``-ed over
pattern units — HLO size stays O(period), which is what makes 512-device
compiles of 72-80 layer models tractable.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating pattern unit."""

    mixer: str = "attn"        # "attn" | "mamba" | "rwkv"
    ffn: str = "dense"         # "dense" | "moe"


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"
    # decode only: query tokens each slot advances per step.  1 is the
    # classic single-token decode; >1 prices the *mixed* step (chunked
    # prefill riding the decode batch), where the average slot carries
    # its share of the per-step prefill budget.
    q_tokens: int = 1
    # decode only: paged-pool KV quantization ("int8" prices the cache
    # read at 1 byte/elem plus the amortized f32 per-row scale; None =
    # the fp pool at activation width).
    kv_quant: str | None = None

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0          # 0 => d_model // n_heads
    # repeating pattern (length == period; n_layers % period == 0)
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0          # per-expert hidden (defaults to d_ff)
    capacity_factor: float = 1.25
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    # norms / embeddings
    nonparam_norm: bool = False   # OLMo: LN without scale/bias
    tie_embeddings: bool = False
    # recurrent dims
    rwkv_head_size: int = 64
    ssm_state: int = 16
    ssm_expand: int = 2
    ssm_conv: int = 4
    # encoder-decoder
    enc_layers: int = 0        # >0 => enc-dec model
    # modality frontend stub ("vit" | "audio" | None): input_specs() provides
    # precomputed patch/frame embeddings per the assignment.
    frontend: str | None = None
    frontend_tokens: int = 0   # prepended embedding positions
    notes: str = ""

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        if self.n_layers % self.period != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern period {self.period}")

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_units(self) -> int:
        return self.n_layers // self.period

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:           # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    @property
    def has_attention(self) -> bool:
        return any(l.mixer == "attn" for l in self.pattern) or self.enc_layers > 0

    @property
    def attention_free_decode(self) -> bool:
        """O(1)-state decode (no KV growth) — pure SSM/RWKV archs."""
        return not self.has_attention

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid; not pure full-attention)."""
        return any(l.mixer in ("mamba", "rwkv") for l in self.pattern)

    def supports_shape(self, shape: ShapeSpec) -> bool:
        if shape.name == "long_500k":
            return self.subquadratic
        return True

    def skip_reason(self, shape: ShapeSpec) -> str | None:
        if self.supports_shape(shape):
            return None
        return (f"{self.name} is pure full-attention; long_500k (seq "
                f"{shape.seq_len}) requires sub-quadratic attention "
                f"(see DESIGN.md §5)")

    # -- parameter counting (for 6·N·D model-flops & memory budgeting) --- #
    def param_count(self) -> dict[str, float]:
        d, hd = self.d_model, self.hd
        counts: dict[str, float] = {}
        counts["embed"] = self.vocab * d
        counts["lm_head"] = 0 if self.tie_embeddings else self.vocab * d
        per_layer: dict[str, float] = {"attn": 0, "mamba": 0, "rwkv": 0,
                                       "dense": 0, "moe": 0}
        per_layer["attn"] = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                             + self.n_heads * hd * d)
        per_layer["dense"] = 3 * d * self.d_ff
        if self.n_experts:
            moe_ff = self.moe_d_ff or self.d_ff
            per_layer["moe"] = self.n_experts * 3 * d * moe_ff + d * self.n_experts
        di = self.d_inner
        per_layer["mamba"] = (d * 2 * di + di * self.ssm_conv
                              + di * (2 * self.ssm_state + 2)  # B,C,dt proj approx
                              + di * self.ssm_state + di * d)
        per_layer["rwkv"] = 4 * d * d + 2 * d * self.d_ff + 6 * d * 64  # tmix+cmix+lora
        total_layers = 0.0
        for spec in self.pattern:
            mix = per_layer[spec.mixer]
            ffn = per_layer["moe"] if spec.ffn == "moe" else per_layer["dense"]
            if spec.mixer == "rwkv":
                ffn = 0  # channel-mix already counted inside rwkv entry
            total_layers += mix + ffn
        counts["layers"] = total_layers * self.n_units
        if self.enc_layers:
            # encoder blocks: self-attn + dense FFN; decoder adds cross-attn
            enc = (per_layer["attn"] + per_layer["dense"]) * self.enc_layers
            cross = per_layer["attn"] * self.n_layers
            counts["layers"] += enc + cross
        counts["total"] = sum(v for k, v in counts.items() if k != "total")
        return counts

    def active_param_count(self) -> float:
        """Activated params per token (MoE: top_k of n_experts)."""
        total = self.param_count()["total"]
        if not self.n_experts:
            return total
        moe_ff = self.moe_d_ff or self.d_ff
        moe_all = 0
        moe_active = 0
        for spec in self.pattern:
            if spec.ffn == "moe":
                moe_all += self.n_experts * 3 * self.d_model * moe_ff
                moe_active += self.top_k * 3 * self.d_model * moe_ff
        scale = self.n_units
        return total - (moe_all - moe_active) * scale
