"""PyTorch + CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` is the reference: this package keeps its module
names, public function names and array layouts, so each function here can
be held against its counterpart on the same numpy inputs.  It imports
``torch`` and nothing of ``jax`` or ``repro``.

Ported so far: serving a dense decoder-only LM (configs, model layers
and stack, the paged KV pool with int8 blocks, chunked prefill riding the
mixed step, copy-on-write prefix caching, the serve engine and its
launcher), and training dense and RWKV6 LMs (loss, AdamW, the train step
with microbatches and remat, synthetic data, checkpoints that cross with
the reference, the train command), and serving MoE LMs and Mamba hybrids
(Jamba), on the paged pool or dense per-slot rows.  The kernels on those
paths (flash, dense and paged decode attention, the MoE scatter and
gather, the WKV6 recurrence, the selective scan) are CUDA C++ for
``sm_90a`` under ``csrc/``.
"""
