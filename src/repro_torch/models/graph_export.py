"""Export an (ArchConfig × ShapeSpec) cell as a computation graph for the
strategy search (paper Section 4): the port's copy of
``repro.models.graph_export``.

Node naming matches ``models.plan`` so a searched Strategy realizes directly:
``embed``, ``L{i}.{ln1,attn,attn_out,add1,ln_x,xattn,xattn_out,add_x,ln2,
mlp_in,mlp_out,moe,cmix,tmix,ssm,add2}``, ``final_norm``, ``lm_head`` (+
``enc.*`` / ``dec.*`` prefixes and ``enc_in``/``enc_norm`` for enc-dec,
``frontend``/``vis_concat`` for VLM stubs).

Residual connections appear as *parallel paths* (the skip edge joins the
block output at the ``add`` node) — exactly the structure node/edge
elimination consumes (paper Fig. 5/6).

FLOPs are fwd+bwd (x3) for train shapes and fwd-only for prefill/decode.
Decode graphs read the KV cache: attention act_bytes is dominated by the
cache read and the ``seq`` dim means *cache-sequence* sharding (cheap
partial-softmax combine, flagged via ``extra["decode"]``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.graph import CompGraph, LayerNode, TensorSpec

from .arch import ArchConfig, ShapeSpec

A_BYTES = 2   # bf16 activations
P_BYTES = 2   # bf16 params


def _sizes(**kw) -> dict:
    return {k: v for k, v in kw.items() if v}


class _Exporter:
    def __init__(self, arch: ArchConfig, shape: ShapeSpec):
        self.g = CompGraph()
        self.arch = arch
        self.shape = shape
        self.kind = shape.kind
        self.mult = 3.0 if self.kind == "train" else 1.0
        self.last: str | None = None
        # stage-cut metadata: the pattern-unit index stamped on every node
        # (entry nodes -1, head nodes n_units) — what the stage partitioner
        # in core/stages.py cuts the graph by.
        self.unit: int | None = None

    def node(self, name: str, kind: str, out: TensorSpec, flops: float = 0.0,
             params: float = 0.0, act: float = 0.0,
             dims: tuple[str, ...] = ("batch",), extra: dict | None = None,
             chain: bool = True) -> str:
        extra = dict(extra or {})
        extra.setdefault("dim_sizes", {})
        if self.unit is not None:
            extra.setdefault("unit", self.unit)
        n = LayerNode(name, kind, out, flops=self.mult * flops,
                      param_bytes=params, act_bytes=self.mult * act,
                      parallel_dims=dims, extra=extra)
        self.g.add_node(n)
        if chain and self.last is not None:
            self.g.add_edge(self.last, name)
        self.last = name
        return name


def export_graph(arch: ArchConfig, shape: ShapeSpec) -> CompGraph:
    if arch.enc_layers:
        return _export_encdec(arch, shape)
    return _export_decoder(arch, shape)


def phase_shape(phase: str, *, seq_len: int, batch: int,
                kv_tokens: int | None = None,
                q_tokens: int | None = None,
                kv_quant: str | None = None) -> ShapeSpec:
    """The ShapeSpec a serving/training *phase* prices its graph with.

    ``train``:   the dense global batch (fwd+bwd, gradient sync);
    ``prefill``: one admitted request — batch 1 at its prompt length;
    ``decode``:  a ragged batch over ``batch`` cache slots against a
                 ``seq_len``-deep cache (the exporter emits Sq=q_tokens
                 and flags attention as cache-read-dominated).

    ``kv_tokens`` (decode only) prices the cache read at the *allocated*
    per-slot depth instead of the ``max_len`` reservation — under the
    paged KV cache a slot's live blocks cover its actual request, so the
    dominant ``kv_bytes`` term (and the searched decode plan with it)
    must not be inflated to the padded worst case.

    ``q_tokens`` (decode only, default 1) prices the *mixed* step: with
    chunked prefill riding the decode batch, the average slot advances
    ``q_tokens`` query tokens per step instead of 1 — the matmul/FFN
    terms scale with it while the cache-read term does not, which is
    exactly the trade the searched decode plan must see.

    ``kv_quant`` (decode only) prices the cache read at the paged pool's
    stored width: ``"int8"`` means 1 byte/elem plus the amortized f32
    per-(token-slot, head) scale, so the dominant ``kv_bytes`` term
    shrinks ~4x against the bf16 pool and the searched decode plan can
    trade cache-sequence sharding away accordingly.
    """
    if phase == "train":
        return ShapeSpec(f"train_{seq_len}", seq_len, batch, "train")
    if phase == "prefill":
        return ShapeSpec(f"prefill_{seq_len}", seq_len, 1, "prefill")
    if phase == "decode":
        depth = min(seq_len, kv_tokens) if kv_tokens else seq_len
        qt = max(1, int(q_tokens or 1))
        kvq = None if kv_quant in (None, "none") else kv_quant
        name = (f"decode_{depth}" + (f"+q{qt}" if qt > 1 else "")
                + (f"+{kvq}" if kvq else ""))
        return ShapeSpec(name, depth, batch, "decode", q_tokens=qt,
                         kv_quant=kvq)
    raise ValueError(
        f"unknown phase {phase!r}; expected train | prefill | decode")


# --------------------------------------------------------------------------- #
def _decoder_chain(b: _Exporter, arch: ArchConfig, B: int, Sq: int, Skv: int,
                   prefix: str = "", memory_tokens: int = 0):
    """Emit the layer-stack nodes; assumes b.last is the entry hidden node."""
    D, H, KH, hd = arch.d_model, arch.n_heads, arch.n_kv_heads, arch.hd
    T = B * Sq
    decode = b.kind == "decode"
    act = TensorSpec.make(batch=B, seq=Sq, d_model=D)
    act_b = act.bytes
    h_sizes = _sizes(batch=B, seq=Skv, d_model=D, heads=H, d_ff=arch.d_ff,
                     vocab=arch.vocab, expert=arch.n_experts)

    def norm(name):
        return b.node(name, "norm", act, flops=6 * T * D, act=2 * act_b,
                      params=4 * D, dims=("batch", "seq", "d_model"),
                      extra={"dim_sizes": h_sizes})

    def residual(name, src_skip):
        n = b.node(name, "residual", act, flops=T * D, act=3 * act_b,
                   dims=("batch", "seq", "d_model"),
                   extra={"dim_sizes": h_sizes})
        b.g.add_edge(src_skip, n)
        return n

    def attn_pair(i, tag="attn", kv_tokens=None, cross=False):
        kvt = Skv if kv_tokens is None else kv_tokens
        # decode reads the paged pool at its *stored* width: int8 payload
        # plus the amortized f32 per-(token-slot, head) scale (4 bytes
        # over hd payload bytes).  Everything else stays at A_BYTES.
        if decode and not cross and b.shape.kv_quant == "int8":
            kv_width = 1.0 + 4.0 / hd
        else:
            kv_width = float(A_BYTES)
        kv_bytes = 2 * B * kvt * KH * hd * kv_width
        core = 4 * B * H * Sq * kvt * hd
        proj = 2 * T * D * (H + 2 * KH) * hd
        aout = TensorSpec.make(batch=B, seq=Sq, heads=H, hd=hd)
        # decode: the dominant tensor is the persistent KV cache, which has
        # only KH heads — cap the heads degree so memory accounting and
        # realization agree (beyond KH the cache would replicate).
        sizes = h_sizes if not decode else {**h_sizes, "heads": min(H, KH)}
        b.node(f"{prefix}L{i}.{tag}", "cross_attn" if cross else "attn",
               aout, flops=proj + core,
               params=(D * (H + 2 * KH) * hd) * P_BYTES,
               act=(2 * act_b + 3 * aout.bytes + kv_bytes + kv_bytes),
               dims=("batch", "seq", "heads"),
               extra={"kv_bytes": float(kv_bytes), "decode": decode,
                      "dim_sizes": sizes})
        b.node(f"{prefix}L{i}.{tag}_out", "attn_out", act,
               flops=2 * T * H * hd * D, params=H * hd * D * P_BYTES,
               act=2 * act_b + aout.bytes,
               dims=("batch", "seq", "d_model"),
               extra={"dim_sizes": h_sizes})

    def ffn(i, spec):
        if spec.mixer == "rwkv":
            f = arch.d_ff
            b.node(f"{prefix}L{i}.cmix", "cmix", act,
                   flops=2 * T * (2 * D * f + D * D),
                   params=(2 * D * f + D * D) * P_BYTES,
                   act=4 * act_b + 2 * T * f * A_BYTES,
                   dims=("batch", "seq", "d_ff"),
                   extra={"dim_sizes": h_sizes})
        elif spec.ffn == "moe":
            fe = arch.moe_d_ff or arch.d_ff
            E, K = arch.n_experts, arch.top_k
            eff_tokens = T * K * arch.capacity_factor
            b.node(f"{prefix}L{i}.moe", "moe", act,
                   flops=6 * eff_tokens * D * fe + 2 * T * D * E,
                   params=(E * 3 * D * fe) * P_BYTES + D * E * 4,
                   act=(2 * act_b + 3 * eff_tokens * (D + fe) * A_BYTES),
                   dims=("batch", "seq", "expert", "d_ff"),
                   extra={"token_bytes": float(T * K * D * A_BYTES),
                          "capacity_factor": arch.capacity_factor,
                          "dim_sizes": {**h_sizes, "d_ff": fe}})
        else:
            f = arch.d_ff
            hid = TensorSpec.make(batch=B, seq=Sq, d_ff=f)
            b.node(f"{prefix}L{i}.mlp_in", "mlp_in", hid,
                   flops=4 * T * D * f, params=2 * D * f * P_BYTES,
                   act=2 * act_b + 2 * hid.bytes,
                   dims=("batch", "seq", "d_ff"),
                   extra={"dim_sizes": h_sizes})
            b.node(f"{prefix}L{i}.mlp_out", "mlp_out", act,
                   flops=2 * T * f * D, params=D * f * P_BYTES,
                   act=act_b + hid.bytes,
                   dims=("batch", "seq", "d_model"),
                   extra={"dim_sizes": h_sizes})

    for i in range(arch.n_layers):
        spec = arch.pattern[i % arch.period]
        b.unit = i // arch.period
        entry = b.last
        norm(f"{prefix}L{i}.ln1")
        if spec.mixer == "attn":
            attn_pair(i)
        elif spec.mixer == "mamba":
            di, N = arch.d_inner, arch.ssm_state
            rank = max(1, arch.d_model // 16)
            fl = (2 * T * D * 2 * di + 2 * T * di * arch.ssm_conv
                  + 2 * T * di * (rank + 2 * N) + 2 * T * rank * di
                  + 6 * T * di * N + 2 * T * di * D)
            b.node(f"{prefix}L{i}.ssm", "ssm", act, flops=fl,
                   params=(3 * D * di + di * (rank + 2 * N)) * P_BYTES,
                   act=4 * act_b + 4 * T * di * A_BYTES,
                   dims=("batch", "d_model"),
                   extra={"dim_sizes": h_sizes})
        elif spec.mixer == "rwkv":
            hs = arch.rwkv_head_size
            fl = 8 * T * D * D + 6 * T * D * hs + 2 * T * D * 128
            b.node(f"{prefix}L{i}.tmix", "rwkv", act, flops=fl,
                   params=(5 * D * D) * P_BYTES,
                   act=8 * act_b,
                   dims=("batch", "d_model"),
                   extra={"dim_sizes": h_sizes})
        residual(f"{prefix}L{i}.add1", entry)

        if prefix == "dec." and memory_tokens:
            entry_x = b.last
            norm(f"{prefix}L{i}.ln_x")
            attn_pair(i, tag="xattn", kv_tokens=memory_tokens, cross=True)
            residual(f"{prefix}L{i}.add_x", entry_x)

        entry2 = b.last
        norm(f"{prefix}L{i}.ln2")
        ffn(i, spec)
        residual(f"{prefix}L{i}.add2", entry2)


def _head(b: _Exporter, arch: ArchConfig, B: int, Sq: int):
    D, V = arch.d_model, arch.vocab
    T = B * Sq
    b.unit = arch.n_units            # head rides the last stage
    act = TensorSpec.make(batch=B, seq=Sq, d_model=D)
    b.node("final_norm", "norm", act, flops=6 * T * D, act=2 * act.bytes,
           params=4 * D, dims=("batch", "seq", "d_model"),
           extra={"dim_sizes": _sizes(batch=B, seq=Sq, d_model=D)})
    logits = TensorSpec.make(batch=B, seq=Sq, vocab=V)
    b.node("lm_head", "lm_head", logits, flops=2 * T * D * V,
           params=0 if arch.tie_embeddings else D * V * P_BYTES,
           act=act.bytes + logits.bytes * 2,
           dims=("batch", "seq", "vocab"),
           extra={"dim_sizes": _sizes(batch=B, seq=Sq, vocab=V)})


def _export_decoder(arch: ArchConfig, shape: ShapeSpec) -> CompGraph:
    B = shape.global_batch
    decode = shape.kind == "decode"
    Sq = shape.q_tokens if decode else shape.seq_len
    Skv = shape.seq_len
    D, V = arch.d_model, arch.vocab
    T = B * Sq
    b = _Exporter(arch, shape)
    b.unit = -1                      # entry nodes ride stage 0
    act = TensorSpec.make(batch=B, seq=Sq, d_model=D)
    b.node("embed", "embed", act, flops=2 * T * D,
           params=V * D * P_BYTES, act=3 * act.bytes,
           dims=("batch", "seq", "d_model", "vocab"),
           extra={"dim_sizes": _sizes(batch=B, seq=Sq, d_model=D, vocab=V)})
    if arch.frontend and not decode:
        F = arch.frontend_tokens
        fr = TensorSpec.make(batch=B, seq=F, d_model=D)
        b.node("frontend", "stub", fr, flops=0, act=fr.bytes,
               dims=("batch", "seq", "d_model"),
               extra={"dim_sizes": _sizes(batch=B, seq=F, d_model=D)},
               chain=False)
        b.node("vis_concat", "residual", act, flops=T * D, act=3 * act.bytes,
               dims=("batch", "seq", "d_model"),
               extra={"dim_sizes": _sizes(batch=B, seq=Sq, d_model=D)},
               chain=False)
        b.g.add_edge("embed", "vis_concat")
        b.g.add_edge("frontend", "vis_concat")
        b.last = "vis_concat"
    _decoder_chain(b, arch, B, Sq, Skv)
    _head(b, arch, B, Sq)
    b.g.validate_dag()
    return b.g


def _export_encdec(arch: ArchConfig, shape: ShapeSpec) -> CompGraph:
    """Encoder chain feeds the decoder entry; memory re-layout between
    decoder layers is charged inside each cross_attn node (see DESIGN.md)."""
    from .plan import _enc_view

    B = shape.global_batch
    decode = shape.kind == "decode"
    # split the budgeted sequence between encoder and decoder
    Se = min(4096, max(16, shape.seq_len // 2)) if decode else shape.seq_len // 2
    Sd_total = shape.seq_len if decode else shape.seq_len // 2
    Sq = shape.q_tokens if decode else Sd_total
    D, V = arch.d_model, arch.vocab
    enc_arch = _enc_view(arch)

    b = _Exporter(arch, shape)
    b.unit = -1                      # enc-dec graphs are not stageable yet
    enc_act = TensorSpec.make(batch=B, seq=Se, d_model=D)
    b.node("enc_in", "stub", enc_act, flops=2 * B * Se * D * D,
           params=D * D * P_BYTES, act=3 * enc_act.bytes,
           dims=("batch", "seq", "d_model"),
           extra={"dim_sizes": _sizes(batch=B, seq=Se, d_model=D)})
    # encoder runs full-length even for decode shapes (the memory side of a
    # serving step; flagged non-decode so its attention costs full compute)
    saved = b.kind
    if decode:
        b.kind = "prefill"
    _decoder_chain(b, enc_arch, B, Se, Se, prefix="enc.")
    b.kind = saved
    b.node("enc_norm", "norm", enc_act, flops=6 * B * Se * D,
           act=2 * enc_act.bytes, params=4 * D,
           dims=("batch", "seq", "d_model"),
           extra={"dim_sizes": _sizes(batch=B, seq=Se, d_model=D)})
    enc_out = b.last

    act = TensorSpec.make(batch=B, seq=Sq, d_model=D)
    b.node("embed", "embed", act, flops=2 * B * Sq * D,
           params=V * D * P_BYTES, act=3 * act.bytes,
           dims=("batch", "seq", "d_model", "vocab"),
           extra={"dim_sizes": _sizes(batch=B, seq=Sq, d_model=D, vocab=V)},
           chain=False)
    # decoder entry joins token embeddings with encoder memory
    b.node("dec_entry", "residual", act, flops=B * Sq * D, act=3 * act.bytes,
           dims=("batch", "seq", "d_model"),
           extra={"dim_sizes": _sizes(batch=B, seq=Sq, d_model=D)},
           chain=False)
    b.g.add_edge("embed", "dec_entry")
    b.g.add_edge(enc_out, "dec_entry")
    b.last = "dec_entry"
    _decoder_chain(b, arch, B, Sq, Sd_total, prefix="dec.",
                   memory_tokens=Se)
    _head(b, arch, B, Sq)
    b.g.validate_dag()
    return b.g
