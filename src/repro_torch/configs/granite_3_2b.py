"""granite-3-2b [dense] — 40L d2048 32H (GQA kv=8) d_ff=8192 vocab=49155.
[hf:ibm-granite/granite-3.0-2b-base]

long_500k: SKIPPED — pure full-attention; see DESIGN.md §5.
"""

import dataclasses

from repro_torch.models.arch import ArchConfig, LayerSpec

ARCH = ArchConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=49155,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    tie_embeddings=True,
    notes="deep-narrow dense; GQA 32/8.",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        ARCH, name="granite-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=128)
