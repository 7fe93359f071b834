"""qwen2.5-3b [dense] — 36L d2048 16H (GQA kv=2) d_ff=11008 vocab=151936.
GQA + QKV bias.  [hf:Qwen/Qwen2.5-3B]

long_500k: SKIPPED — pure full-attention; see DESIGN.md §5.
"""

import dataclasses

from repro_torch.models.arch import ArchConfig, LayerSpec

ARCH = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab=151936,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
    notes="GQA 16/2 with QKV bias; huge vocab.",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        ARCH, name="qwen2.5-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=96, vocab=128)
