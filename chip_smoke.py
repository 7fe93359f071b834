#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts and is right on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit.  It imports nothing of JAX or of the reference package
``repro``.  Phases, in order; any failure makes the exit code nonzero:

1. build: every ``src/repro_torch/csrc/*.cu`` with ``nvcc`` for sm_90a,
   all in parallel; print the card's name and power limit.
2. kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the serve engine's shapes (paged decode f32 / bf16 / int8,
   flash prefill f32 / bf16), with ragged kv_len, tables that point at
   the trash block and a prompt length that is not a multiple of 128.
   One JSON line per phase: error and tolerance, the kernel's, the plain
   version's and (flash) SDPA's time, and the bound.
3. reference: a small model served on the card and on the CPU (plain
   versions) with the same weights; first-token logits must agree.
4. serve: full-width llama3.2-1b in float32, ServeEngine with 8 slots and
   max_len 1024, 12 seeded requests (prompts 60-700 tokens, half behind a
   shared 256-token prefix, 32 new tokens each), in three modes:
   (a) chunked prefill + prefix cache, (b) stall-the-world prefill
   (flash), (c) int8 pool.  Launch counts are reset before and read after
   each run; each mode must launch the kernels it uses.  Then a short
   bfloat16 run of (a).
5. the ``kernels`` JSON line, the card's name and power limit, and the
   result line ``{"ok": true, "device": {...}}``.

Everything measured is also written to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "chiprun_out"

SEED = 0
HBM_BYTES_S = 3.35e12                  # H100 SXM HBM3 (data sheet)
PEAK_FLOPS = {"float32": 67e12,        # f32 outside the tensor cores
              "bfloat16": 989e12}      # bf16 dense tensor cores
# kernel vs plain version: float32 differs only by summation order and
# the online softmax's rescaling (~1e-6 here); bfloat16 output rounding
# alone is 2^-8 relative on values of order 1
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# first-token logits of (a) chunked+prefix vs (b) stall-the-world at full
# width in float32: two attention paths and per-shape cuBLAS algorithms
# through 16 layers; logits are of order 1
SERVE_LOGIT_TOL = 2e-3
# the same small model on the card and on the CPU (plain versions): f32
# sums in another order; with the int8 pool a K/V element on a rounding
# boundary may quantize to the neighbouring int8 value on one side (one
# step is 1/127 of the row's absmax), which moves logits by ~1e-3
REF_LOGIT_TOL = {"a": 1e-4, "b": 1e-4, "c": 5e-3}

failures: list[str] = []
record: dict = {"phases": []}


def fail(msg: str) -> None:
    failures.append(msg)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)


def emit(obj: dict) -> None:
    record["phases"].append(obj)
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# timing
# --------------------------------------------------------------------------- #
class Timer:
    """Mean milliseconds per call from CUDA events around each call, with
    the 50 MB L2 flushed before each (the serve loop reads every layer's
    pool and weights cold).

    Device time: a ~1 ms spin kernel is queued ahead of the start event,
    so the host has queued the call's kernels before the device reaches
    them and the events time the device work alone.  ``host=True`` leaves
    the spin out: the device then waits for the host's Python and
    launches, and the time is what one call costs the caller."""

    SPIN_CYCLES = 2_000_000            # ~1 ms at the H100's ~2 GHz clock

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, iters: int = 20, warm: int = 2,
                 host: bool = False) -> float:
        torch = self.torch
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            if not host:
                torch.cuda._sleep(self.SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            total += s.elapsed_time(e)
        return total / iters


def bound(bytes_: float, flops: float, dtype: str):
    t_bytes = bytes_ / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------- #
def paged_inputs(torch, device, *, B=8, KH=8, G=4, D=64, bs=128,
                 max_len=1024, pool_dtype, q_dtype):
    """The engine's decode shapes: 8 slots, KH 8, G 4, hd 64, 128-token
    blocks, a pool of 8 slots x 8 pages + the trash block."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    pages = -(-max_len // bs)
    NB = B * pages + 1
    g = torch.Generator(device=device).manual_seed(SEED)
    q = torch.randn(B, KH, G, D, generator=g, device=device).to(q_dtype)
    if pool_dtype == torch.int8:
        kp = torch.randint(-127, 128, (NB, bs, KH, D), generator=g,
                           device=device, dtype=torch.int8)
        vp = torch.randint(-127, 128, (NB, bs, KH, D), generator=g,
                           device=device, dtype=torch.int8)
        ks = torch.rand(NB, bs, KH, generator=g, device=device) * 0.03
        vs = torch.rand(NB, bs, KH, generator=g, device=device) * 0.03
        scales = {"k_scale": ks, "v_scale": vs}
    else:
        kp = torch.randn(NB, bs, KH, D, generator=g, device=device).to(pool_dtype)
        vp = torch.randn(NB, bs, KH, D, generator=g, device=device).to(pool_dtype)
        scales = {}
    kv_len = rng.integers(60, 733, B).astype(np.int32)   # prompts + 32 new
    kv_len[:2] = [128, 129]                                # page edges
    ids = rng.permutation(np.arange(1, NB))
    tables = np.zeros((B, pages), np.int32)                # 0 = trash block
    for b in range(B):
        live = -(-int(kv_len[b]) // bs)
        tables[b, :live] = ids[b * pages:b * pages + live]
    return (q, kp, vp, torch.as_tensor(tables, device=device),
            torch.as_tensor(kv_len, device=device), scales)


def phase_paged(torch, timer, device, name, pool_dtype, q_dtype):
    from repro_torch.kernels import ops, ref
    q, kp, vp, tables, kv_len, scales = paged_inputs(
        torch, device, pool_dtype=pool_dtype, q_dtype=q_dtype)
    got = ops.paged_decode_attention(q, kp, vp, tables, kv_len, **scales)
    want = ref.paged_decode_attention_ref(q, kp, vp, tables, kv_len,
                                          **scales)
    torch.cuda.synchronize()
    dt = "bfloat16" if q_dtype == torch.bfloat16 else "float32"
    err = float((got.float() - want.float()).abs().max())
    B, KH, G, D = q.shape
    live = int(kv_len.sum())
    kv_elem = kp.element_size()
    bytes_ = (2 * q.numel() * q.element_size() + tables.numel() * 4
              + kv_len.numel() * 4 + 2 * live * KH * D * kv_elem
              + (2 * live * KH * 4 if scales else 0))
    flops = 4 * live * KH * G * D
    b_ms, b_by = bound(bytes_, flops, dt)
    res = {"phase": name, "shape": {"q": list(q.shape),
                                    "pool": list(kp.shape),
                                    "kv_len": kv_len.tolist()},
           "max_abs_err": err, "tol": TOL[dt],
           "kernel_ms": timer(lambda: ops.paged_decode_attention(
               q, kp, vp, tables, kv_len, **scales), iters=50),
           "kernel_call_ms": timer(lambda: ops.paged_decode_attention(
               q, kp, vp, tables, kv_len, **scales), iters=50, host=True),
           "plain_ms": timer(lambda: ref.paged_decode_attention_ref(
               q, kp, vp, tables, kv_len, **scales), iters=10),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "bytes": bytes_, "flops": flops}
    emit(res)
    if not err <= TOL[dt]:
        fail(f"{name}: max abs err {err} > {TOL[dt]}")
    return res


def phase_flash(torch, timer, device, name, dtype, S=700, T=768):
    """Stall-the-world prefill's shape: q (1, 32, S, 64) of a 700-token
    prompt against its cache row, S rounded up to whole 128-blocks."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=device).manual_seed(SEED)
    q = torch.randn(1, 32, S, 64, generator=g, device=device).to(dtype)
    k = torch.randn(1, 8, T, 64, generator=g, device=device).to(dtype)
    v = torch.randn(1, 8, T, 64, generator=g, device=device).to(dtype)
    k[:, :, S:] = 0          # the row past the prompt holds zeros
    v[:, :, S:] = 0
    got = ops.flash_attention(q, k, v, causal=True)
    want = ref.attention_ref(q, k, v, causal=True)
    lib = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                         enable_gqa=True)
    torch.cuda.synchronize()
    dt = "bfloat16" if dtype == torch.bfloat16 else "float32"
    err = float((got.float() - want.float()).abs().max())
    lib_err = float((lib.float() - want.float()).abs().max())
    B, H, _, D = q.shape
    pairs = sum(min(s + 1, T) for s in range(S))         # causal work
    flops = 4 * B * H * D * pairs
    bytes_ = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    b_ms, b_by = bound(bytes_, flops, dt)
    res = {"phase": name, "shape": {"q": list(q.shape), "kv": list(k.shape)},
           "max_abs_err": err, "tol": TOL[dt],
           "kernel_ms": timer(lambda: ops.flash_attention(q, k, v,
                                                          causal=True)),
           "kernel_call_ms": timer(lambda: ops.flash_attention(
               q, k, v, causal=True), host=True),
           "plain_ms": timer(lambda: ref.attention_ref(q, k, v, causal=True),
                             iters=5),
           "library_ms": timer(lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True, enable_gqa=True)),
           "library_max_abs_err": lib_err,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": bytes_,
           "flops": flops}
    emit(res)
    if not err <= TOL[dt]:
        fail(f"{name}: max abs err {err} > {TOL[dt]}")
    return res


# --------------------------------------------------------------------------- #
# phases 3-4: serving
# --------------------------------------------------------------------------- #
def recording_engine():
    """ServeEngine that keeps each request's first-token logits and checks
    every sampled row of logits is finite."""
    import torch
    from repro_torch.serve import ServeEngine

    class Recording(ServeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.first_logits: dict[int, torch.Tensor] = {}
            self.finite = True
            real_prefill = self._prefill

            def prefill(params, batch, cache):
                logits, cache = real_prefill(params, batch, cache)
                self._prefill_logits = logits[0, -1]
                return logits, cache
            self._prefill = prefill

        def _sample(self, logits):
            self._last = logits[:, -1]
            self.finite &= bool(torch.isfinite(self._last).all())
            return super()._sample(logits)

        def _admit_one(self):
            req = self.queue[0]
            out = super()._admit_one()
            if out is not None and not self.chunked:
                lg = self._prefill_logits.float()
                self.finite &= bool(torch.isfinite(lg).all())
                self.first_logits[req.uid] = lg.cpu()
            return out

        def _mixed_step(self, active):
            before = {slot: (st.request.uid, st.prefill_remaining)
                      for slot, st in active.items()}
            done = super()._mixed_step(active)
            for slot, (uid, rem) in before.items():
                st = self.scheduler._slots[slot]
                finished = st is None or st.prefill_remaining == 0
                if rem > 0 and finished and uid not in self.first_logits:
                    self.first_logits[uid] = self._last[slot].float().cpu()
            return done

    return Recording


def make_requests(vocab: int, n: int = 12, gen: int = 32):
    """12 seeded requests, prompts of 60-700 tokens; the even ones start
    with one shared 256-token prefix (one of them is exactly the prefix,
    whose last token is recomputed into a shared block: a copy-on-write)."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(SEED)
    tok = lambda k: tuple(int(t) for t in rng.integers(1, vocab, k))
    shared = tok(256)
    reqs = []
    for i in range(n):
        if i == 2:
            prompt = shared
        elif i % 2 == 0:
            prompt = shared + tok(int(rng.integers(1, 445)))
        else:
            prompt = tok(int(rng.integers(60, 701)))
        reqs.append(Request(uid=i, prompt=prompt, max_new_tokens=gen))
    return reqs


def serve_once(torch, params, arch, requests, *, mode, dtype, device,
               max_batch=8, max_len=1024):
    """One engine run with the launch counts reset just before it and read
    just after; returns the measurements and the engine."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeConfig
    kw = {"a": {}, "b": {"prefill_chunk_tokens": 0},
          "c": {"kv_quant": "int8"}}[mode]
    eng = recording_engine()(params, arch, ServeConfig(
        max_batch=max_batch, max_len=max_len, dtype=dtype, **kw))
    warm_s = eng.warmup(sorted({len(r.prompt) for r in requests}))
    if device.type == "cuda":
        torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run(requests)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    out_tokens = sum(len(c.tokens) for c in done)
    itl = np.asarray(eng.itl_samples) * 1e3
    steps = int(eng.stats["decode_steps"])
    res = {"mode": mode, "dtype": str(dtype).replace("torch.", ""),
           "requests": len(done), "output_tokens": out_tokens,
           "prompt_tokens": int(sum(len(r.prompt) for r in requests)),
           "wall_s": wall, "tok_s": out_tokens / wall,
           "itl_p50_ms": float(np.percentile(itl, 50)) if itl.size else None,
           "itl_p99_ms": float(np.percentile(itl, 99)) if itl.size else None,
           "steps": steps, "warmup_s": warm_s, "launches": counts,
           "launches_per_step": {k: v / max(steps, 1)
                                 for k, v in counts.items()},
           "prefill_tokens_saved": eng.prefill_tokens_saved,
           "finite": eng.finite}
    return res, eng, {c.uid: c.tokens for c in done}


def phase_reference(torch, device):
    """A small model (2 layers, d 256, 4 heads over 2 KV heads, hd 64)
    served on the card and on the CPU with the same weights: the CUDA
    kernels against the plain versions through the whole engine."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import lm
    arch = dataclasses.replace(configs.get("llama3.2-1b"), n_layers=2,
                               d_model=256, n_heads=4, n_kv_heads=2,
                               d_ff=512, vocab=512, head_dim=64)
    params = lm.init_lm(arch, torch.float32,
                        generator=torch.Generator().manual_seed(SEED),
                        device="cpu")
    reqs = make_requests(arch.vocab, n=6, gen=8)
    for mode in ("a", "b", "c"):
        runs = {}
        for dev in (device, torch.device("cpu")):
            p = lm.tree_map(lambda t: t.to(dev), params)
            _, eng, toks = serve_once(torch, p, arch, reqs, mode=mode,
                                      dtype=torch.float32, device=dev,
                                      max_batch=4, max_len=1024)
            runs[dev.type] = (eng.first_logits, toks)
        (gl, gt), (cl, ct) = runs["cuda"], runs["cpu"]
        err = max(float((gl[u] - cl[u]).abs().max()) for u in cl)
        same = sum(a == b for u in ct for a, b in zip(gt[u], ct[u]))
        total = sum(len(t) for t in ct.values())
        emit({"phase": f"reference-{mode}", "first_logits_max_abs_err": err,
              "tol": REF_LOGIT_TOL[mode], "tokens_equal": same,
              "tokens": total})
        if not err <= REF_LOGIT_TOL[mode]:
            fail(f"reference-{mode}: card vs CPU logits differ by {err}")


def profile_run(torch, params, arch, requests, device):
    """Mode (a) once more under ``torch.profiler``: the device's busy share
    of the run's wall time and the kernels that take the most device time.
    The profiler adds host time of its own, so the busy share it gives is
    a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import ServeConfig
    eng = recording_engine()(params, arch, ServeConfig(
        max_batch=8, max_len=1024, dtype=torch.float32))
    eng.warmup(sorted({len(r.prompt) for r in requests}))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(requests)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    # kernels only: an operator's row repeats the time of the kernels it
    # launched
    rows = sorted((e for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")),
                  key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in rows) / 1e6
    top = [{"name": e.key[:80], "device_ms": dev_us(e) / 1e3,
            "count": e.count} for e in rows[:10]]
    return {"phase": "profile-a", "wall_s": wall, "device_busy_s": busy,
            "device_busy_share": busy / wall if busy else None,
            "top_kernels": top}


def phase_serve(torch, device):
    from repro_torch import configs
    from repro_torch.models import lm
    arch = configs.get("llama3.2-1b")
    t0 = time.perf_counter()
    params = lm.init_lm(arch, torch.float32,
                        generator=torch.Generator(device=device)
                        .manual_seed(SEED), device=device)
    torch.cuda.synchronize()
    print(f"# weights: {time.perf_counter() - t0:.1f} s", flush=True)
    reqs = make_requests(arch.vocab)
    need = {"a": ["paged_decode_attention"],
            "b": ["paged_decode_attention", "flash_attention"],
            "c": ["paged_decode_attention_int8"]}
    runs, main_counts = {}, {}
    for mode in ("a", "b", "c"):
        res, eng, toks = serve_once(torch, params, arch, reqs, mode=mode,
                                    dtype=torch.float32, device=device)
        runs[mode] = (res, eng, toks)
        emit({"phase": f"serve-{mode}", **res})
        for k in need[mode]:
            main_counts.setdefault(k, res["launches"][k])
            if res["launches"][k] <= 0:
                fail(f"serve-{mode}: kernel {k} was not launched")
        if not res["finite"]:
            fail(f"serve-{mode}: non-finite logits")
        if res["requests"] != len(reqs):
            fail(f"serve-{mode}: {res['requests']} of {len(reqs)} served")
    if runs["a"][0]["prefill_tokens_saved"] <= 0:
        fail("serve-a: no prefix-cache hit")
    la, lb = runs["a"][1].first_logits, runs["b"][1].first_logits
    err = max(float((la[u] - lb[u]).abs().max()) for u in lb)
    ta, tb = runs["a"][2], runs["b"][2]
    same = sum(x == y for u in tb for x, y in zip(ta[u], tb[u]))
    total = sum(len(t) for t in tb.values())
    emit({"phase": "serve-a-vs-b", "first_logits_max_abs_err": err,
          "tol": SERVE_LOGIT_TOL, "requests_compared": len(lb),
          "token_agreement": same / total, "tokens_equal": same,
          "tokens": total})
    if len(lb) != len(reqs) or not err <= SERVE_LOGIT_TOL:
        fail(f"serve a vs b: first-token logits differ by {err}")
    prof = profile_run(torch, params, arch, reqs, device)
    # the same work without the profiler's host cost
    prof["device_busy_share_unprofiled"] = (prof["device_busy_s"]
                                            / runs["a"][0]["wall_s"])
    emit(prof)
    bf = lm.tree_map(lambda t: t.to(torch.bfloat16), params)
    del params
    res, _, _ = serve_once(torch, bf, arch, reqs, mode="a",
                           dtype=torch.bfloat16, device=device)
    emit({"phase": "serve-a-bf16", **res})
    if not res["finite"]:
        fail("serve-a-bf16: non-finite logits")
    return main_counts


# --------------------------------------------------------------------------- #
def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU "
              "port and has nothing to run here", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    device = resolve_device("cuda")
    OUT.mkdir(exist_ok=True)

    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    (OUT / "build.log").write_text("\n".join(f"== {k}\n{v}"
                                             for k, v in logs.items()))
    card = card_line()
    emit({"phase": "build", "sources": sorted(logs), "seconds": build_s,
          "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    timer = Timer(torch, device)
    kern = {}
    steps = [
        ("paged-f32", lambda: phase_paged(torch, timer, device, "paged-f32",
                                          torch.float32, torch.float32)),
        ("paged-bf16", lambda: phase_paged(torch, timer, device,
                                           "paged-bf16", torch.bfloat16,
                                           torch.bfloat16)),
        ("paged-int8", lambda: phase_paged(torch, timer, device,
                                           "paged-int8", torch.int8,
                                           torch.float32)),
        ("flash-f32", lambda: phase_flash(torch, timer, device, "flash-f32",
                                          torch.float32)),
        ("flash-bf16", lambda: phase_flash(torch, timer, device,
                                           "flash-bf16", torch.bfloat16)),
        ("reference", lambda: phase_reference(torch, device)),
        ("serve", lambda: phase_serve(torch, device)),
    ]
    counts = {}
    for name, fn in steps:
        try:
            out = fn()
        except Exception:                 # record, then go on to the next
            fail(f"{name}: {traceback.format_exc()}")
            continue
        if name == "serve":
            counts = out
        elif out is not None:
            kern[name] = out

    rows = [("paged_decode_attention", "paged-f32",
             "src/repro_torch/csrc/paged_decode_attention.cu",
             "src/repro/kernels/paged_decode_attention.py:37"),
            ("paged_decode_attention_int8", "paged-int8",
             "src/repro_torch/csrc/paged_decode_attention.cu",
             "src/repro/kernels/paged_decode_attention.py:76"),
            ("flash_attention", "flash-f32",
             "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:33")]
    kernels = []
    for name, phase, source, replaces in rows:
        k = kern.get(phase, {})
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": counts.get(name, 0),
                        "max_abs_err": k.get("max_abs_err"),
                        "ms": k.get("kernel_ms"),
                        "plain_ms": k.get("plain_ms"),
                        "bound_ms": k.get("bound_ms"),
                        "bound_by": k.get("bound_by"),
                        "library_ms": k.get("library_ms")})
    record["kernels"] = kernels
    record["failures"] = failures
    (OUT / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    if failures:
        print(f"chip_smoke: {len(failures)} phase(s) failed",
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
