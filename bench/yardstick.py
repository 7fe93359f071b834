"""The benchmark's frozen yardstick: published peaks of one H100 SXM and
the work (bytes moved, operations) that a call needs, from its shapes.

The kernel counts are a frozen copy of the port's
``repro_torch/kernels/work.py`` as the benchmark's cells use it: a later
change to the port may edit its copy, and must not move what the
benchmark holds it against.  ``bench/tests/test_bench_yardstick.py``
holds each copy equal to the port's at the cells' shapes.  Nothing here
imports the port.
"""

from __future__ import annotations

from dataclasses import dataclass

#: NVIDIA's data sheet, H100 SXM, dense, at its 700 W limit.  Float32
#: work is held against the TF32 tensor-core rate: the port's float32
#: flash kernel already runs on the tensor cores (3xTF32), so the SIMT
#: float32 rate (67e12) is no ceiling for it.
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
HBM_BYTES_S = 3.35e12


@dataclass(frozen=True)
class Work:
    bytes: float
    flops: float


def least_seconds(work: Work, dtype: str = "float32") -> float:
    """The least time the card could take: the larger of operations over
    the dtype's peak and bytes over the HBM rate."""
    return max(work.flops / PEAK_FLOPS[dtype], work.bytes / HBM_BYTES_S)


def causal_pairs(S: int, T: int) -> int:
    """(query, key) pairs of causal attention of S queries at positions
    0..S-1 over T keys."""
    if T >= S:
        return S * (S + 1) // 2
    return T * (T + 1) // 2 + (S - T) * T


def flash_attention(q_shape, kv_shape, causal: bool, el: int) -> Work:
    """q (B, H, S, D) against k/v (B, KH, T, D): q, k, v read once, the
    output written once; 4 D flops a (query, key) pair."""
    B, H, S, D = q_shape
    T = kv_shape[2]
    pairs = causal_pairs(S, T) if causal else S * T
    kv = B * kv_shape[1] * T * D
    return Work((2 * B * H * S * D + 2 * kv) * el, 4 * B * H * D * pairs)


def moe_ffn(tokens: int, live: int, experts_hit: int, d: int, f: int,
            n_experts: int, el: int) -> Work:
    """One MoE layer call over ``tokens`` tokens: the float32 router
    (d x n_experts), and a SwiGLU expert FFN for each of the ``live``
    assignments kept under capacity.  Bytes: the router and the three
    matrices of each expert hit read once, the tokens read and the
    output written once.  Empty capacity slots are no work."""
    flops = 2 * tokens * d * n_experts + live * 2 * 3 * d * f
    weights = d * n_experts * 4 + experts_hit * 3 * d * f * el
    return Work(weights + 2 * tokens * d * el, flops)


def lm_param_counts(cfg: dict) -> dict:
    """Parameters of a decoder layer stack by kind, from the
    configuration file's keys: attention, the feed-forward weights that
    one token uses (its top-k experts, or the one dense SwiGLU FFN where
    the file names no experts), the router, and the LM head."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    kvh, hd = cfg["num_key_value_heads"], cfg["head_dim"]
    f = cfg["intermediate_size"]
    e, k = cfg.get("num_experts", 0), cfg.get("num_experts_per_tok", 1)
    return {"attn": d * h * hd + 2 * d * kvh * hd + h * hd * d,
            "ffn_active": k * 3 * d * f, "router": d * e,
            "head": d * cfg["vocab_size"]}


def active_matmul_params(cfg: dict) -> int:
    """Weights of the matrix products one token goes through: every
    layer's attention, router and feed-forward weights, and the LM head
    (the embedding lookup is no product)."""
    c = lm_param_counts(cfg)
    per_layer = c["attn"] + c["ffn_active"] + c["router"]
    return cfg["num_hidden_layers"] * per_layer + c["head"]


def attention_flops(cfg: dict, context: int) -> int:
    """Forward attention operations of one token over ``context`` keys in
    every layer: q.k and p.v, 2 flops a multiply-add each."""
    return (4 * cfg["num_attention_heads"] * cfg["head_dim"] * context
            * cfg["num_hidden_layers"])
