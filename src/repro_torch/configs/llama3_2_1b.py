"""llama3.2-1b [dense] — 16L d2048 32H (GQA kv=8) d_ff=8192 vocab=128256.
[hf:meta-llama/Llama-3.2-1B]

long_500k: SKIPPED — pure full-attention; see DESIGN.md §5.
"""

import dataclasses

from repro_torch.models.arch import ArchConfig, LayerSpec

ARCH = ArchConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    head_dim=64,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    rope_theta=5e5,
    tie_embeddings=True,
    notes="small llama3; tied embeddings; GQA 32/8.",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        ARCH, name="llama3.2-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=128, head_dim=16)
