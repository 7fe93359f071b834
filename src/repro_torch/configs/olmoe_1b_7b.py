"""olmoe-1b-7b [moe] — 16L d2048 16H (GQA kv=16) d_ff=1024 vocab=50304,
MoE 64 experts top-8.  [arXiv:2409.02060]

long_500k: SKIPPED — pure full-attention; see DESIGN.md §5.
"""

import dataclasses

from repro_torch.models.arch import ArchConfig, LayerSpec

ARCH = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    n_experts=64,
    top_k=8,
    moe_d_ff=1024,
    qk_norm=True,
    notes="64 fine-grained experts, top-8; MHA (kv=16).",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        ARCH, name="olmoe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=48, moe_d_ff=48, vocab=128, n_experts=8, top_k=2)
