"""Decoder-only LM assembly, dense path: the counterpart of
``repro.models.lm`` for the ``attn`` + dense SwiGLU pattern.

Parameters are a dict tree with every per-layer tensor stacked over
pattern units (leading dim ``n_units``), exactly the reference's layout;
``run_stack`` walks the units in a Python loop.  Caches are dict trees
in the reference's layouts too, and are updated in place.

Entry points:
  init_lm(arch, dtype, generator=, device=)      -> params
  init_cache(arch, batch, max_len, dtype, device=) -> cache
  init_paged_cache(arch, num_blocks, block_size, batch, dtype, kv_quant=,
                   device=)                      -> cache
  prefill(params, batch, cache, arch)            -> (logits_last, cache)
  decode_step(params, token, cache, pos, arch[, block_tables])
                                                 -> (logits, cache)
  step(params, tokens, cache, pos, arch[, q_lens, block_tables])
                                                 -> (logits, cache)

Non-``attn`` mixers, MoE FFNs and modality frontends raise
``NotImplementedError`` naming the slice that brings them.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device

from . import layers as L
from .arch import ArchConfig

_LATER = {"mamba": "the Mamba slice", "rwkv": "the RWKV6 slice",
          "moe": "the MoE slice"}


def check_dense(arch: ArchConfig) -> None:
    """Raise for anything beyond the dense decoder-only LM."""
    for spec in arch.pattern:
        for kind in (spec.mixer, spec.ffn):
            if kind in _LATER:
                raise NotImplementedError(
                    f"{arch.name}: {kind} layers arrive with "
                    f"{_LATER[kind]} (ROADMAP.md)")
    if arch.frontend or arch.enc_layers:
        raise NotImplementedError(
            f"{arch.name}: frontends and encoder-decoder models arrive "
            f"with the VLM / encoder-decoder slice (ROADMAP.md)")


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree, path=()):
    """(path, tensor) for every leaf of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, path + (k,))
    else:
        yield path, tree


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #
def init_lm(arch: ArchConfig, dtype=torch.float32, *,
            generator: torch.Generator, device=None) -> dict:
    """Random weights from ``generator`` (on ``device``), stacked over
    units.  The numbers differ from the reference's ``jax.random`` init
    from the same seed; parity tests move the reference's weights across
    with :mod:`repro_torch.bridge` instead.  ``device=None`` means
    ``cuda`` (see :func:`repro_torch.device.resolve_device`)."""
    check_dense(arch)
    device = resolve_device(device)
    n = (arch.n_units,)
    kw = dict(generator=generator, device=device)
    unit = {}
    for j, _ in enumerate(arch.pattern):
        unit[f"l{j}"] = {
            "ln1": L.init_norm(arch, dtype, lead=n, device=device),
            "ln2": L.init_norm(arch, dtype, lead=n, device=device),
            "attn": L.init_attention(arch, dtype, lead=n, **kw),
            "mlp": L.init_mlp(arch, dtype, lead=n, **kw),
        }
    return {
        "embed": L.init_embed(arch, dtype, **kw),
        "stack": unit,
        "final_norm": L.init_norm(arch, dtype, device=device),
        "lm_head": L.init_lm_head(arch, dtype, **kw),
    }


# --------------------------------------------------------------------------- #
# one pattern unit, and the stack
# --------------------------------------------------------------------------- #
def unit_forward(h, unit_params, arch: ArchConfig, *, positions,
                 causal=True, cache=None, cache_pos=None, block_tables=None,
                 q_lens=None):
    """Returns (h, new_cache) for one pattern unit."""
    new_cache: dict = {}
    for j, _ in enumerate(arch.pattern):
        lp = unit_params[f"l{j}"]
        lc = cache.get(f"l{j}") if cache is not None else None
        hn = L.apply_norm(lp["ln1"], h)
        a, kvc = L.attention(
            lp["attn"], hn, arch, positions=positions, causal=causal,
            kv_cache=(lc or {}).get("kv"), cache_pos=cache_pos,
            block_tables=block_tables, q_lens=q_lens)
        h = h + L.attention_out(lp["attn"], a)
        hn = L.apply_norm(lp["ln2"], h)
        h = h + L.mlp(lp["mlp"], hn)
        new_cache[f"l{j}"] = {"kv": kvc} if kvc is not None else {}
    return h, new_cache


def run_stack(h, stack_params, arch: ArchConfig, *, positions, causal=True,
              cache=None, cache_pos=None, block_tables=None, q_lens=None):
    """Walk the units in order; returns (h, cache).  Unit u's parameters
    and cache are the views ``leaf[u]`` of the stacked trees, so cache
    writes land in the stacked cache itself."""
    for u in range(arch.n_units):
        unit_params = tree_map(lambda a: a[u], stack_params)
        unit_cache = (tree_map(lambda a: a[u], cache)
                      if cache is not None else None)
        h, _ = unit_forward(
            h, unit_params, arch, positions=positions, causal=causal,
            cache=unit_cache, cache_pos=cache_pos,
            block_tables=block_tables, q_lens=q_lens)
    return h, cache


def _head(params, h, arch):
    h = L.apply_norm(params["final_norm"], h)
    return L.lm_head(params["lm_head"], h, params["embed"], arch)


# --------------------------------------------------------------------------- #
# serving: cache init / prefill / decode
# --------------------------------------------------------------------------- #
def init_cache(arch: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device=None) -> dict:
    check_dense(arch)
    device = resolve_device(device)
    shape = (arch.n_units, batch, max_len, arch.n_kv_heads, arch.hd)
    return {f"l{j}": {"kv": {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device)}}
        for j, _ in enumerate(arch.pattern)}


def init_paged_cache(arch: ArchConfig, num_blocks: int, block_size: int,
                     batch: int, dtype=torch.bfloat16, *,
                     kv_quant: str | None = None, device=None) -> dict:
    """KV leaves as one pool of ``num_blocks`` blocks ``(n_units, NB,
    block_size, KH, hd)`` shared by all slots through a block table.
    ``kv_quant="int8"`` stores the pool as int8 with per-(slot, head)
    f32 scales ``k_scale``/``v_scale`` ``(n_units, NB, block_size, KH)``;
    zero scales dequantize never-written slots to exactly 0.0.  ``batch``
    is kept for signature parity: a dense arch has no slot-dense state."""
    if kv_quant not in (None, "none", "int8"):
        raise ValueError(f"unknown kv_quant {kv_quant!r}")
    check_dense(arch)
    device = resolve_device(device)
    quant = kv_quant == "int8"
    shape = (arch.n_units, num_blocks, block_size, arch.n_kv_heads, arch.hd)
    pool_dtype = torch.int8 if quant else dtype

    def kv_pool():
        leaves = {"k": torch.zeros(shape, dtype=pool_dtype, device=device),
                  "v": torch.zeros(shape, dtype=pool_dtype, device=device)}
        if quant:
            for name in ("k_scale", "v_scale"):
                leaves[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                           device=device)
        return leaves

    return {f"l{j}": {"kv": kv_pool()} for j, _ in enumerate(arch.pattern)}


def prefill(params, batch: dict, cache: dict, arch: ArchConfig):
    """Process the prompt (``batch["tokens"]`` (B, S)), filling ``cache``
    from position 0; returns (last-position logits (B, 1, V), cache)."""
    tokens = batch["tokens"]
    h = L.embed(params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    h, cache = run_stack(h, params["stack"], arch, positions=positions,
                         causal=True, cache=cache, cache_pos=0)
    return _head(params, h[:, -1:, :], arch), cache


def decode_positions(pos, batch: int, device=None):
    """``pos`` -> (rope positions, cache_pos): a scalar gives ((1,), ())
    (every row at one position); a ``(batch,)`` vector gives ((B, 1),
    (B,)) per-slot positions.  Anything else raises."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    if pos.ndim == 0:
        return pos[None], pos
    if pos.ndim == 1 and pos.shape[0] == batch:
        return pos[:, None], pos
    raise ValueError(
        f"decode pos must be a scalar or a ({batch},) vector matching the "
        f"token batch; got shape {tuple(pos.shape)}")


def decode_step(params, token, cache: dict, pos, arch: ArchConfig, *,
                block_tables=None):
    """One decode step.  token: (B, 1); pos: scalar or (B,) (see
    :func:`decode_positions`).  With ``block_tables`` the KV leaves are
    the paged pool and ``pos`` must be (B,)."""
    h = L.embed(params["embed"], token)
    positions, cache_pos = decode_positions(pos, token.shape[0], token.device)
    if block_tables is not None and cache_pos.ndim != 1:
        raise ValueError("paged decode (block_tables) requires a (B,) "
                         "per-slot pos vector")
    h, cache = run_stack(h, params["stack"], arch, positions=positions,
                         causal=True, cache=cache, cache_pos=cache_pos,
                         block_tables=block_tables)
    return _head(params, h, arch), cache


def step(params, tokens, cache: dict, pos, arch: ArchConfig, *,
         q_lens=None, block_tables=None):
    """One unified mixed step: row b advances ``q_lens[b]`` of its T
    tokens from cache depth ``pos[b]`` (decoding slots 1, a prefill chunk
    up to T, idle slots 0).  ``q_lens=None`` means every row advances all
    T tokens.  Returns (logits (B, T, V), cache); row b's next-token
    logits sit at ``logits[b, q_lens[b] - 1]``, the rest is garbage."""
    B, T = tokens.shape
    pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
    if pos.ndim == 0:
        pos = pos.expand(B)
    elif tuple(pos.shape) != (B,):
        raise ValueError(
            f"step pos must be a scalar or a ({B},) vector matching the "
            f"token batch; got shape {tuple(pos.shape)}")
    if q_lens is not None:
        q_lens = torch.as_tensor(q_lens, dtype=torch.int32,
                                 device=tokens.device)
        if tuple(q_lens.shape) != (B,):
            raise ValueError(
                f"step q_lens must be a ({B},) vector matching the token "
                f"batch; got shape {tuple(q_lens.shape)}")
    elif T > 1:
        q_lens = torch.full((B,), T, dtype=torch.int32, device=tokens.device)
    h = L.embed(params["embed"], tokens)
    positions = pos[:, None] + torch.arange(T, device=tokens.device)[None, :]
    h, cache = run_stack(h, params["stack"], arch, positions=positions,
                         causal=True, cache=cache, cache_pos=pos,
                         block_tables=block_tables, q_lens=q_lens)
    return _head(params, h, arch), cache
