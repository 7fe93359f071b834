"""olmo-1b [dense] — 16L d2048 16H (GQA kv=16) d_ff=8192 vocab=50304.
Non-parametric LN.  [arXiv:2402.00838]

long_500k: SKIPPED — pure full-attention; see DESIGN.md §5.
"""

import dataclasses

from repro_torch.models.arch import ArchConfig, LayerSpec

ARCH = ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    nonparam_norm=True,
    tie_embeddings=True,
    notes="non-parametric LayerNorm (no scale/bias); MHA.",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        ARCH, name="olmo-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=128)
