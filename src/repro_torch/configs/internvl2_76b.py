"""internvl2-76b [vlm] — 80L d8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
InternViT frontend + Llama-3-70B-class backbone.  [arXiv:2404.16821]

Per the assignment, the entry specifies the transformer BACKBONE only; the
InternViT modality frontend is a STUB — ``input_specs()`` provides
precomputed patch embeddings occupying the first ``frontend_tokens``
positions of the sequence.

long_500k: SKIPPED — pure full-attention backbone; see DESIGN.md §5.
"""

import dataclasses

from repro_torch.models.arch import ArchConfig, LayerSpec

ARCH = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    rope_theta=5e5,
    frontend="vit",
    frontend_tokens=256,
    notes="ViT patch embeds stubbed (256 tokens); llama3-70B-class backbone.",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        ARCH, name="internvl2-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=128, frontend_tokens=4)
