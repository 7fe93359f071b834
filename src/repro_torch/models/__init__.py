"""Model zoo of the port: the dense and RWKV6 decoder-only LMs (``lm``,
``recurrent``) on the shared ``arch`` schema.  MoE, Mamba and
encoder-decoder models arrive with later slices (see ROADMAP.md)."""

from .arch import ArchConfig, LayerSpec
