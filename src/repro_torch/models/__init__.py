"""Model zoo of the port: the dense decoder-only LM (``lm``) on the
shared ``arch`` schema.  MoE, RWKV, Mamba and encoder-decoder models
arrive with later slices (see ROADMAP.md)."""

from .arch import ArchConfig, LayerSpec
