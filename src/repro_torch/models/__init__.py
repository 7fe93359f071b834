"""Model zoo of the port: the dense, MoE, RWKV6 and Mamba-hybrid
decoder-only LMs (``lm``, ``moe``, ``recurrent``) on the shared ``arch``
schema.  VLM and encoder-decoder models arrive with later slices (see
ROADMAP.md)."""

from .arch import ArchConfig, LayerSpec
