"""Architecture configs the port runs (``--arch <id>``).

Copies of every config of ``repro.configs``: the four dense ones,
``olmoe_1b_7b`` and ``phi3_5_moe_42b`` (MoE), ``rwkv6_1b6`` (RWKV6),
``jamba_1_5_large`` (Mamba + attention + MoE), ``internvl2_76b`` (a VLM
backbone behind a stubbed frontend) and ``seamless_m4t_v2``
(encoder-decoder): each module defines ``ARCH`` (the published config)
and ``reduced()`` (a small same-family config for CPU tests).
"""

from __future__ import annotations

import importlib

ALL_ARCHS = ["llama3_2_1b", "olmo_1b", "qwen2_5_3b", "granite_3_2b",
             "olmoe_1b_7b", "phi3_5_moe_42b", "rwkv6_1b6", "jamba_1_5_large",
             "internvl2_76b", "seamless_m4t_v2"]

# assignment ids -> module names (the reference's table)
ALIASES = {
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "rwkv6-1.6b": "rwkv6_1b6",
    "llama3.2-1b": "llama3_2_1b",
    "olmo-1b": "olmo_1b",
    "qwen2.5-3b": "qwen2_5_3b",
    "granite-3-2b": "granite_3_2b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "internvl2-76b": "internvl2_76b",
    "seamless-m4t-large-v2": "seamless_m4t_v2",
}


def _module(name: str):
    key = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if key not in ALL_ARCHS:
        raise ValueError(f"unknown arch {name!r}; the port runs "
                         f"{ALL_ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get(name: str):
    return _module(name).ARCH


def reduced(name: str):
    return _module(name).reduced()


def all_archs():
    return {n: get(n) for n in ALL_ARCHS}
