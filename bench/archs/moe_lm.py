"""The port's side of a configuration file whose reference is
``moe_lm``: its ``ArchConfig`` (a decoder of attention and MoE layers
with per-head q/k norms), and the routing the reference follows."""

from __future__ import annotations

import contextlib
import dataclasses


@contextlib.contextmanager
def routing(record: list):
    """While active, appends the expert indices (B, S, K) of every call of
    the port's MoE router to ``record``, in call order (a step with remat
    routes each layer again in its backward; the reference takes the
    first calls, its own forward's count)."""
    import repro_torch.models.moe as moe
    real = moe.route

    def recording(*a, **kw):
        out = real(*a, **kw)
        record.append(out[1].detach().clone())
        return out
    moe.route = recording
    try:
        yield record
    finally:
        moe.route = real


def port_arch(cfg: dict):
    """Built from the file's keys, and held equal to the port's own config
    named by ``port_arch`` at the file's depth, so that the file states
    what the program runs."""
    from repro_torch import configs
    from repro_torch.models.arch import ArchConfig, LayerSpec
    arch = ArchConfig(
        name=cfg["name"], family="moe", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        vocab=cfg["vocab_size"], head_dim=cfg["head_dim"],
        pattern=(LayerSpec(mixer="attn", ffn="moe"),),
        n_experts=cfg["num_experts"], top_k=cfg["num_experts_per_tok"],
        moe_d_ff=cfg["intermediate_size"],
        capacity_factor=cfg["capacity_factor"], qk_norm=True,
        rope_theta=cfg["rope_theta"],
        tie_embeddings=cfg["tie_word_embeddings"],
        qkv_bias=cfg["attention_bias"])
    if "port_arch" in cfg:
        own = configs.get(cfg["port_arch"])
        own = dataclasses.replace(own, name=arch.name,
                                  n_layers=arch.n_layers, notes="")
        if dataclasses.replace(arch, head_dim=own.head_dim) != own or (
                arch.hd != own.hd):
            raise ValueError(f"{cfg['name']}: the file does not state the "
                             f"port's {cfg['port_arch']}: {arch} != {own}")
    return arch
