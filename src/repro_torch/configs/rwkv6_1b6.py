"""rwkv6-1.6b [ssm] — 24L d2048 (attention-free) d_ff=7168 vocab=65536.
Finch: data-dependent decay linear recurrence.  [arXiv:2404.05892]

long_500k: RUNS — O(1)-state decode (no KV cache growth).
"""

import dataclasses

from repro_torch.models.arch import ArchConfig, LayerSpec

ARCH = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # rwkv heads = d_model / head_size(64)
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    pattern=(LayerSpec(mixer="rwkv", ffn="dense"),),
    rwkv_head_size=64,
    notes="attention-free; time-mix (WKV6) + channel-mix per layer.",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        ARCH, name="rwkv6-smoke", n_layers=2, d_model=64, n_heads=2,
        n_kv_heads=2, d_ff=128, vocab=128, rwkv_head_size=32)
