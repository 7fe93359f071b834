"""Serving command of the port: requests in, completions out, through
:class:`repro_torch.serve.ServeEngine` on one GPU or, under ``torchrun``,
a mesh.

    python -m repro_torch.launch.serve --arch llama3.2-1b \
        --width 0 --depth 0 --vocab 0 --batch 8 --requests 16 \
        --prompt-len 256 --gen 32
    python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --width 0 --depth 0 --vocab 0 --experts 0 --kv-block-size 0
    python -m repro_torch.launch.serve --arch jamba-1.5-large-398b \
        --width 0 --depth 2 --vocab 0 --experts 0
    python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --width 0 --depth 0 --vocab 0
    python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 \
        --width 0 --depth 0 --vocab 0 --batch 8 --prompt-len 512
    python -m repro_torch.launch.serve --arch internvl2-76b \
        --width 0 --depth 2 --vocab 0

``--width/--depth/--vocab/--experts`` shrink the config (0 keeps the
published value).  The defaults keep the published width, at which the
heads come out at a size the kernels take, in 4 layers over a 512-token
vocabulary; a width that leaves the heads at another size is refused on
the card (a CPU run takes any, e.g. ``--device cpu --width 128``).
A ``--depth`` below the layer pattern's period takes the pattern of the
config's ``reduced()`` (jamba's: a Mamba layer with a dense FFN, then an
attention layer with MoE), so that ``--depth 2`` keeps every layer kind
of the model at its published width on one card.
``--kv-block-size 0`` serves from dense per-slot KV rows; a stack
without attention (rwkv6) always does, and ``--kv-quant`` is inert there.
Its carried-state WKV6 recurrence runs the plain version on the card too,
as the reference's does.  A VLM (internvl2) is served on text prompts
through the engine, as the reference's is.  The encoder-decoder
(seamless) keeps the reference's static lockstep loop: ``--batch`` rows of
the seq2seq dataset (``--prompt-len`` split evenly between encoder frames
and decoder tokens) are prefilled once over dense rows, then decoded
``--gen`` tokens with one scalar position.  Weights are random,
drawn from a ``torch.Generator`` seeded with ``--seed``; prompts come from
a numpy generator with the same seed.  ``--device cpu`` runs the plain
PyTorch versions on the CPU; without it the command needs a GPU.

The plan flags are the reference's (:func:`resolve_serve_plan`):
``--strategy {uniform,data,model,owt,searched}`` builds a phase-aware
plan (prefill priced as a batch-1 prompt, decode as the engine's mixed
step over the slot pool, at the paged pool's allocated depth, with
``--shared-prefix-tokens`` of it shared across the pool), ``--plan``
loads one from JSON instead (arch-checked), ``--save-plan`` writes it,
``--device-profile`` calibrates the search with a measured device
profile.  ``--kernel-backend`` and ``--autotune-cache-dir`` are the train
command's (:func:`repro_torch.launch.train.add_kernel_flags`).
One GPU has no mesh, so a built plan degrades to uniform and a loaded
one places nothing (both logged); the engine and the lockstep loop take
the plan all the same, and a plan whose decode phase is
pipeline-staged is refused.  With ``WORLD_SIZE`` > 1 (``torchrun``;
``gloo`` with ``--device cpu``, ``nccl`` on the cards) the command joins
the process group, builds the reference's serve mesh (two on ``model``
from four even devices, ``launch/mesh.py::serve_mesh``), resolves the
plan for it and serves under ``use_mesh``: the engine realizes the
decode phase's layout (params, and the cache once).  Only rank 0 prints
and saves the plan.

    python -m repro_torch.launch.serve --arch llama3.2-1b \
        --strategy searched --save-plan plan.json
    python -m repro_torch.launch.serve --arch llama3.2-1b --plan plan.json
"""

from __future__ import annotations

import argparse
import contextlib
import io
import sys
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.sharding import (current_mesh, is_dtensor, use_mesh,
                                       whole)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import init_distributed, serve_mesh
from repro_torch.kernels.dispatch import autotune_cache_at, force_backend
from repro_torch.launch.train import (add_kernel_flags, reduced_arch,
                                      require_kernel_shapes)
from repro_torch.data import make_dataset
from repro_torch.models import init_params, model_module
from repro_torch.models.arch import ShapeSpec
from repro_torch.plans import (STRATEGIES, ParallelPlan, distribute,
                               param_pspecs, resolve_plan, to_shardings)
from repro_torch.plans.parallel_plan import as_model_plan
from repro_torch.serve import PrefixCache, Request, ServeConfig, ServeEngine


def make_requests(vocab: int, n: int, prompt_len: int, gen: int,
                  seed: int = 0) -> list[Request]:
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=tuple(int(t) for t in
                                        rng.integers(1, vocab, prompt_len)),
                    max_new_tokens=gen) for i in range(n)]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=4,
                    help="cache slot pool size (max in-flight requests)")
    ap.add_argument("--requests", type=int, default=0,
                    help="number of requests (default 2x --batch)")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32,
                    help="max new tokens per request")
    ap.add_argument("--no-continuous", action="store_true",
                    help="static-batch oracle: admit a full batch, drain "
                         "it, admit the next")
    ap.add_argument("--kv-block-size", type=int, default=128,
                    help="tokens per paged-KV block (0 = dense per-slot "
                         "max_len rows)")
    ap.add_argument("--kv-pool-blocks", type=int, default=0,
                    help="usable blocks in the pool (0 = dense-equivalent)")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=-1,
                    help="per-step prompt-token budget of the mixed step "
                         "(-1 = 2 * block size paged, 256 dense; 0 = "
                         "stall-the-world)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable copy-on-write prefix sharing")
    ap.add_argument("--prefix-evict", default="lru",
                    choices=list(PrefixCache.EVICTION))
    ap.add_argument("--kv-quant", default="none", choices=["none", "int8"],
                    help="int8 stores pool blocks with per-row f32 scales")
    ap.add_argument("--shared-prefix-tokens", type=int, default=0,
                    help="typical shared-prefix length for decode-phase "
                         "plan pricing: these tokens are allocated once "
                         "across the pool, so per-slot KV depth is "
                         "amortized (0 = no sharing assumed)")
    ap.add_argument("--strategy", default="uniform",
                    choices=list(STRATEGIES),
                    help="parallelization plan: uniform/data/model/owt "
                         "baselines or the searched per-phase plan "
                         "(prefill + decode searched separately)")
    ap.add_argument("--plan", default="",
                    help="load a ParallelPlan JSON (from --save-plan here "
                         "or on the train command); overrides --strategy, "
                         "refuses an arch mismatch")
    ap.add_argument("--save-plan", default="",
                    help="write the plan (searched or baseline) to this "
                         "JSON path for later --plan runs")
    ap.add_argument("--width", type=int, default=0)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--experts", type=int, default=4,
                    help="experts of an MoE arch (top-k capped to it; 0 "
                         "keeps the published count)")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    add_kernel_flags(ap)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    return ap


def resolve_serve_plan(arch, mesh_spec, *, plan_path: str = "",
                       strategy: str = "uniform", prompt_len: int,
                       max_batch: int, max_len: int,
                       kv_block_size: int = 0,
                       prefill_chunk_tokens: int = 0,
                       shared_prefix_tokens: int = 0,
                       kv_quant: str | None = None,
                       save_plan: str = "",
                       profile_path: str = "") -> ParallelPlan:
    """Serving preset of :func:`repro_torch.plans.resolve_plan` (the
    reference's ``repro.launch.serve.resolve_serve_plan``): the phases a
    serving process executes are prefill + decode.

    With a paged cache (``kv_block_size > 0``) the decode phase is priced
    at the per-slot allocated-blocks depth (``max_len`` rounded up to
    whole blocks); with prefix caching, ``shared_prefix_tokens`` of it are
    allocated once across the pool, so the amortized depth is ``unique +
    ceil(shared / max_batch)``.  (The reference's preset also takes a
    typical request budget below ``max_len``, which only its serving
    benchmark passes.)  With
    chunked prefill (``prefill_chunk_tokens > 0``) decode is priced as the
    engine's mixed step: ``ceil((max_batch - 1 + chunk) / max_batch)``
    query tokens a slot.  ``kv_quant="int8"`` prices the cache read at
    the quantized pool's width and is recorded in the plan's meta.
    ``profile_path`` (``--device-profile``) calibrates the search with a
    measured device profile.  A
    plan whose decode phase is pipeline-staged is refused; a staged
    prefill phase is noted (serving runs it unstaged).
    """
    kv_tokens = None
    if kv_block_size:
        tokens = max_len
        shared = min(max(0, shared_prefix_tokens), tokens)
        if shared and max_batch > 1:
            tokens = (tokens - shared) + -(-shared // max_batch)
        kv_tokens = -(-tokens // kv_block_size) * kv_block_size
    q_tokens = None
    if prefill_chunk_tokens > 0:
        q_tokens = -(-(max_batch - 1 + prefill_chunk_tokens) // max_batch)
    plan = resolve_plan(
        arch, mesh_spec, phases=("prefill", "decode"),
        plan_path=plan_path, strategy=strategy, save_plan=save_plan,
        prompt_len=prompt_len, max_batch=max_batch, max_len=max_len,
        decode_kv_tokens=kv_tokens, decode_q_tokens=q_tokens,
        decode_kv_quant=kv_quant if kv_block_size else None,
        profile_path=profile_path)
    dec = plan.stage_for("decode")
    if dec.num_stages > 1:
        raise ValueError(
            f"plan's decode phase is pipeline-staged (S={dec.num_stages}); "
            f"the serve engine executes a single mesh — token-level decode "
            f"pipelining is not implemented yet.  Re-search the serve plan "
            f"without stages or load a plan whose decode phase is "
            f"single-stage.")
    pre = plan.stage_for("prefill")
    if pre.num_stages > 1:
        print(f"serve: note — plan's prefill phase is pipeline-staged "
              f"(S={pre.num_stages}); serving runs the whole model on one "
              f"mesh under stage-0 semantics (per-layer configs only, no "
              f"pipelining)")
    return plan


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lockstep(params, arch, batch: dict, gen: int, *, feed=None,
             plan=None, kernel_backend: str | None = None) -> dict:
    """The static lockstep loop over dense rows: one prefill of ``batch``
    (an encoder-decoder's frames and tokens, or a VLM's frontend and
    text), then ``gen - 1`` greedy decode steps at one scalar position
    (step i fed column i of ``feed`` (B, gen - 1) instead, where given).
    Returns the tokens (B, gen) on the host, every call's last-position
    logits on the device, and the prefill's and the steps' seconds.
    ``plan`` is checked against ``arch``; under an active mesh the loop
    realizes it (params by the decode phase's specs, each call under its
    phase's configs, the logits gathered), and places nothing without.
    ``kernel_backend`` forces a kernel dispatch backend for the loop."""
    pre, dec = (as_model_plan(plan, arch, p) for p in ("prefill", "decode"))
    mesh = current_mesh()
    if mesh is not None and not is_dtensor(params["embed"]["table"]):
        params = distribute(params, to_shardings(
            param_pspecs(params, arch, dec), mesh, like=params))
    mod = model_module(arch)
    device = batch["tokens"].device
    dtype = params["embed"]["table"].dtype
    B, pos = batch["tokens"].shape
    kw = {}
    if arch.enc_layers:
        kw["enc_len"] = batch["frames"].shape[1]
    elif arch.frontend and "frontend" in batch:
        pos += batch["frontend"].shape[1]

    def next_token(logits):
        return logits[:, -1].argmax(-1).to(torch.int32)[:, None]

    with torch.no_grad(), force_backend(kernel_backend):
        cache = mod.init_cache(arch, B, pos + gen, dtype, device=device, **kw)
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = mod.prefill(params, batch, cache, arch, pre)
        logits = whole(logits)
        tok = next_token(logits)
        _sync(device)
        t_prefill = time.perf_counter() - t0
        out, toks = [logits[:, -1]], [tok]
        t0 = time.perf_counter()
        for i in range(gen - 1):
            if feed is not None:
                tok = feed[:, i:i + 1].to(device)
            logits, cache = mod.decode_step(params, tok, cache, pos + i,
                                            arch, dec)
            logits = whole(logits)
            tok = next_token(logits)
            out.append(logits[:, -1])
            toks.append(tok)
        _sync(device)
        t_decode = time.perf_counter() - t0
    return {"tokens": torch.cat(toks, dim=1).cpu(), "logits": out,
            "prefill_s": t_prefill, "decode_s": t_decode}


def encdec_inputs(args, arch, device, dtype):
    """The weights (seeded by ``--seed``) and the batch (``--batch`` rows
    of the seq2seq dataset, ``--prompt-len`` split evenly between encoder
    frames and decoder tokens) that :func:`serve_encdec` serves."""
    params = init_params(arch, dtype, generator=torch.Generator(
        device=device).manual_seed(args.seed), device=device)
    ds = make_dataset(arch, ShapeSpec("serve", args.prompt_len, args.batch,
                                      "prefill"), seed=args.seed)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in ds.batch_at(0).items()}
    return params, batch


def serve_encdec(args, arch, device, dtype, plan=None) -> dict:
    """The reference's lockstep encoder-decoder path (:func:`lockstep`):
    prefill ``--batch`` rows once over a dense cache with the memory, then
    decode with a scalar position.  A prefill and one step run first on a
    throwaway cache, before anything is timed."""
    params, batch = encdec_inputs(args, arch, device, dtype)
    kb = args.kernel_backend or None
    t0 = time.perf_counter()
    lockstep(params, arch, batch, 2, plan=plan, kernel_backend=kb)
    t_warm = time.perf_counter() - t0
    out = lockstep(params, arch, batch, args.gen, plan=plan,
                   kernel_backend=kb)
    t_prefill, t_decode = out["prefill_s"], out["decode_s"]
    pos = batch["tokens"].shape[1]
    gen = out["tokens"]
    tok_s = args.batch * (args.gen - 1) / max(t_decode, 1e-9)
    print(f"arch={arch.name} batch={args.batch} prompt={pos} "
          f"gen={args.gen} mode=static(encdec) dtype={args.dtype}")
    print(f"warmup: {t_warm:.2f} s (excluded from the rates below)")
    print(f"prefill: {t_prefill * 1e3:.1f} ms "
          f"({args.batch * pos / max(t_prefill, 1e-9):.0f} tok/s)")
    print(f"decode:  {t_decode * 1e3:.1f} ms ({tok_s:.0f} tok/s)")
    print("sample generations (token ids):")
    for row in gen[:2]:
        print("  ", row[:24].tolist())
    return {"tokens": gen, "prefill_s": t_prefill, "decode_s": t_decode,
            "decode_tok_s": tok_s}


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    with autotune_cache_at(args.autotune_cache_dir):
        return _main(args)


def _main(args) -> dict:
    device = resolve_device(args.device)
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[args.dtype]
    arch = reduced_arch(configs.get(args.arch), args.width, args.depth,
                        args.vocab, args.experts)
    require_kernel_shapes(arch, device, args.kernel_backend or None)
    rank, world = init_distributed(device)
    mesh = mesh_spec = None
    if world > 1:
        mesh, mesh_spec = serve_mesh(world, device.type)
    out = io.StringIO()
    # one device: no mesh (a built plan degrades to uniform, as logged)
    with contextlib.redirect_stdout(out if rank else sys.stdout), \
            use_mesh(mesh):
        if mesh is not None:
            sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
            print(f"mesh: data={sizes['data']} model={sizes['model']} "
                  f"({world} ranks, "
                  f"{'nccl' if device.type == 'cuda' else 'gloo'})")
        return _serve(args, arch, device, dtype, mesh_spec, rank)


def _serve(args, arch, device, dtype, mesh_spec, rank: int) -> dict:
    max_len = args.prompt_len + args.gen
    # the plan prices decode with the chunk budget the engine will run
    chunk = args.prefill_chunk_tokens
    if chunk < 0:
        chunk = 2 * args.kv_block_size if args.kv_block_size else 256
    plan = resolve_serve_plan(
        arch, mesh_spec, plan_path=args.plan, strategy=args.strategy,
        prompt_len=args.prompt_len, max_batch=args.batch, max_len=max_len,
        kv_block_size=args.kv_block_size,
        prefill_chunk_tokens=min(chunk, max_len),
        shared_prefix_tokens=args.shared_prefix_tokens,
        kv_quant=None if args.kv_quant == "none" else args.kv_quant,
        save_plan=args.save_plan if rank == 0 else "",
        profile_path=args.device_profile)
    if arch.enc_layers:
        return serve_encdec(args, arch, device, dtype, plan)
    n_requests = args.requests or 2 * args.batch
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(arch, dtype, generator=gen, device=device)
    requests = make_requests(arch.vocab, n_requests, args.prompt_len,
                             args.gen, args.seed)
    mode = "static" if args.no_continuous else "continuous"
    engine = ServeEngine(params, arch, ServeConfig(
        max_batch=args.batch, max_len=max_len, policy=mode,
        kv_block_size=args.kv_block_size,
        kv_pool_blocks=args.kv_pool_blocks or None,
        prefill_chunk_tokens=chunk, dtype=dtype,
        prefix_cache=not args.no_prefix_cache,
        prefix_evict=args.prefix_evict,
        kv_quant=None if args.kv_quant == "none" else args.kv_quant,
        kernel_backend=args.kernel_backend or None),
        plan=plan)
    t_warm = engine.warmup(sorted({len(r.prompt) for r in requests}))
    t0 = time.perf_counter()
    completions = engine.run(requests)
    wall = time.perf_counter() - t0

    s = engine.stats
    out_tokens = sum(len(c.tokens) for c in completions)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    kv_desc = (f"paged(bs={engine.block_size}, "
               f"peak_blocks={engine.peak_blocks_in_use}"
               + (f", quant={engine.kv_quant}" if engine.kv_quant else "")
               + ")" if engine.paged else "dense")
    print(f"arch={arch.name} slots={args.batch} requests={n_requests} "
          f"prompt={args.prompt_len} gen<={args.gen} mode={mode} "
          f"plan={plan.strategy_name} dtype={args.dtype} device={where} "
          f"kv={kv_desc}")
    print(f"kv reserved: {engine.kv_bytes_reserved / 2**20:.2f} MiB")
    print(f"warmup: {t_warm:.2f} s (excluded from the rates below)")
    if engine.chunked:
        print(f"mixed:   {s['decode_s'] * 1e3:.1f} ms over "
              f"{int(s['decode_steps'])} steps, "
              f"{int(s['prefill_tokens'])} prompt tokens in chunks of "
              f"{engine.chunk}")
    else:
        print(f"prefill: {s['prefill_s'] * 1e3:.1f} ms for "
              f"{int(s['prefill_tokens'])} prompt tokens")
        print(f"decode:  {s['decode_s'] * 1e3:.1f} ms over "
              f"{int(s['decode_steps'])} steps")
    if engine.prefix is not None:
        print(f"prefix cache: hit_rate={engine.prefix_hit_rate:.2f} "
              f"prefill_tokens_saved={engine.prefill_tokens_saved}")
    itl = (np.percentile(np.asarray(engine.itl_samples) * 1e3, [50, 99])
           if engine.itl_samples else [float("nan")] * 2)
    print(f"inter-token latency: p50={itl[0]:.2f} ms p99={itl[1]:.2f} ms")
    print(f"end-to-end: {out_tokens} output tokens in {wall * 1e3:.1f} ms "
          f"({out_tokens / max(wall, 1e-9):.1f} tok/s)")
    for c in sorted(completions, key=lambda c: c.uid)[:2]:
        print(f"  uid={c.uid} [{c.finish_reason}]", c.tokens[:16])
    return {"completions": completions, "plan": plan, "wall_s": wall,
            "tok_s": out_tokens / max(wall, 1e-9), "itl_ms": list(itl)}


if __name__ == "__main__":
    main()
