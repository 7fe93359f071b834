"""Model zoo of the port: the dense, MoE, RWKV6, Mamba-hybrid and VLM
decoder-only LMs (``lm``, ``moe``, ``recurrent``) and the
encoder-decoder (``encdec``) on the shared ``arch`` schema."""

from .arch import ArchConfig, LayerSpec


def is_encdec(arch: ArchConfig) -> bool:
    return arch.enc_layers > 0


def model_module(arch: ArchConfig):
    from . import encdec, lm
    return encdec if is_encdec(arch) else lm


def init_params(arch: ArchConfig, dtype=None, *, generator, device=None):
    """Random weights of the arch's model (``encdec.init_encdec`` or
    ``lm.init_lm``) from ``generator``, on ``device`` (``None``: ``cuda``);
    ``dtype`` defaults to float32."""
    import torch
    mod = model_module(arch)
    init = mod.init_encdec if is_encdec(arch) else mod.init_lm
    return init(arch, dtype or torch.float32, generator=generator,
                device=device)
