"""seamless-m4t-large-v2 [audio] — 24L d1024 16H (GQA kv=16) d_ff=8192
vocab=256206.  Encoder-decoder, multimodal.  [arXiv:2308.11596]

Interpretation: 24 encoder + 24 decoder layers (SeamlessM4T-large-v2's
text-to-text stack); the speech/audio frontend (w2v-BERT conformer) is a
STUB per the assignment — ``input_specs()`` provides precomputed frame
embeddings as the encoder input.

long_500k: SKIPPED — full-attention decoder + cross-attention;
see DESIGN.md §5.
"""

import dataclasses

from repro_torch.models.arch import ArchConfig, LayerSpec

ARCH = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,           # decoder layers
    enc_layers=24,         # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    frontend="audio",
    notes="enc-dec; audio frames stubbed as precomputed encoder embeddings.",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        ARCH, name="seamless-smoke", n_layers=2, enc_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=128)
