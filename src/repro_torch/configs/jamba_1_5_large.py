"""jamba-1.5-large-398b [hybrid] — 72L d8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2, Mamba:attention 7:1 interleave.
[arXiv:2403.19887]

Pattern unit (period 8): one attention layer per 8 (position 4), Mamba
elsewhere; MoE every other layer (odd positions), dense FFN otherwise —
matching Jamba's published block structure.

long_500k: RUNS — hybrid (only 1/8 of layers keep a KV cache; Mamba layers
carry O(1) state).
"""

import dataclasses

from repro_torch.models.arch import ArchConfig, LayerSpec

_P = []
for i in range(8):
    mixer = "attn" if i == 4 else "mamba"
    ffn = "moe" if i % 2 == 1 else "dense"
    _P.append(LayerSpec(mixer=mixer, ffn=ffn))

ARCH = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    pattern=tuple(_P),
    n_experts=16,
    top_k=2,
    moe_d_ff=24576,
    ssm_state=16,
    ssm_expand=2,
    notes="Mamba+attn 1:7 interleave; MoE 16e top-2 every other layer.",
)


def reduced() -> ArchConfig:
    pat = tuple(
        LayerSpec(mixer="attn" if i == 1 else "mamba",
                  ffn="moe" if i % 2 == 1 else "dense")
        for i in range(2))
    return dataclasses.replace(
        ARCH, name="jamba-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=96, moe_d_ff=96, vocab=128, n_experts=4, top_k=2,
        pattern=pat, ssm_state=4)
