"""phi3.5-moe-42b-a6.6b [moe] — 32L d4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2.  [hf:microsoft/Phi-3.5-MoE-instruct]

long_500k: SKIPPED — pure full-attention MoE transformer (quadratic decode
attention over a 524k KV cache); see DESIGN.md §5.
"""

import dataclasses

from repro_torch.models.arch import ArchConfig, LayerSpec

ARCH = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32064,
    pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    n_experts=16,
    top_k=2,
    moe_d_ff=6400,
    rope_theta=1e4,
    notes="MoE every layer; 16e top-2; GQA 32/8.",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        ARCH, name="phi3.5-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=96, moe_d_ff=96, vocab=128, n_experts=4, top_k=2)
