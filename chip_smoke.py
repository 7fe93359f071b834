#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts and is right on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit.  It imports nothing of JAX or of the reference package
``repro``.  Phases, in order; any failure makes the exit code nonzero:

1. build: every ``src/repro_torch/csrc/*.cu`` with ``nvcc`` for sm_90a,
   all in parallel; print the card's name and power limit.
2. kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the serve engine's shapes (paged decode f32 / bf16 / int8 with
   f32 and with bf16 q at llama3.2's head dim 64 and f32 / bf16 / int8 at
   olmoe's 128, each beside its time before the split-KV redesign, flash prefill
   f32 / bf16 at both, dense split-KV decode f32 / bf16 at olmoe's
   (8, 16, 1, 128) and llama3.2's (8, 8, 4, 64) over a 1024-token cache,
   MoE scatter and gather f32 / bf16 at olmoe's decode shape (B 8, S 1,
   K 8, C 8), chunk shape (B 1, S 256, C 40) and stall-the-world prefill
   (B 1, S 700, C 112; S 1024, C 160, where the scatter builds its slot
   map first), each beside its time before the one-pass redesign), with
   ragged kv_len, tables that point at the trash block and a prompt
   length that is not a multiple of 128; at jamba-1.5-large's shapes
   (paged and dense decode q (8, 8, 8, 128), flash q (1, 64, 675, 128)
   against a 1024-token row, MoE scatter and gather at D 8192, E 16, K 2,
   decode, chunk and prefill (S 700); at phi3.5-moe's (paged and dense
   decode q (8, 8, 4, 128), flash q (1, 32, 675, 128) against 8 KV heads
   of a 1024-token row, MoE scatter and gather at D 4096, E 16, K 2,
   decode, chunk and prefill (S 700), each f32 / bf16); the selective
   scan f32 / bf16 at
   the chunk shape (1, 256, 16384, N 16) and
   the decode shape (8, 1, 16384) with a carried state, a stall prefill
   (1, 675) with a state, the stateless forward (1, 512), N 8, each
   beside its time before the Hopper redesign; rows with
   dt = 0 keep their state bitwise; flash f32 / bf16 at a long prompt
   with jamba's heads, q (1, 64, 4096, 128) against 4096 keys, beside
   SDPA); and at the
   train step's shapes (flash causal q (8, 32, 256, 64), WKV6 (8, 32, 256,
   64) f32 / bf16, each beside its time before the staged redesign); and
   flash's non-causal form, as an encoder runs it, f32 / bf16 beside SDPA
   at seamless-m4t-v2's serve and train shapes (q (8, 16, 256, 64) and
   (8, 16, 128, 64) against as many keys) and at S = T = 300; causal
   flash and dense decode f32 / bf16 at the lockstep serve paths' shapes:
   seamless-m4t-v2's decoder prefill q (8, 16, 256, 64) against its
   288-row cache and its decode (8, 16, 1, 64) over that row, and
   internvl2-76b's prefill q (4, 64, 512, 128) against 8 KV heads of a
   545-row cache and its decode (4, 8, 8, 128), with ragged kv_len.  One
   JSON line per phase: error and tolerance, the kernel's, the plain
   version's and the library call's time, and the bound.  The library calls are yardsticks only, never on the port's
   path: SDPA for attention, ``index_put_`` into a zeroed buffer for the
   MoE scatter, ``F.embedding_bag`` (mode "sum", the gates as per-sample
   weights) for the MoE gather.  Before the kernels, the launch floor:
   the time of one near-empty kernel (``torch.cuda._sleep(0)``) under the
   same timer, what a decode-shape kernel cannot go below; the MoE, WKV6
   and scan phases also give the kernel's own device duration from the
   profiler (``kernel_device_ms``, no launch).  Then the gradients of the kernels'
   autograd Functions (forward the kernel, backward the plain version's
   gradient) against the plain versions' own autograd.
3. reference: a small llama served on the card and on the CPU (plain
   versions) with the same weights; first-token logits must agree; the
   same for a small rwkv6 (head size 64) in its dense modes, where no
   kernel may launch.  The same for a small olmoe (head dim 128) and a
   small jamba (4 layers in its 2-layer Mamba / attention + MoE pattern,
   N 16) in their three modes, with the experts each token chose compared
   first: logits are held only for the requests whose routing agreed on
   both sides.  A small encoder-decoder and a small VLM (16 frames or
   frontend embeddings + 16 tokens) in lockstep: prefill logits and 8
   decode steps, and a dense cache continued mid-sequence (``cache_pos``
   16, S 8).  Then two train steps of a small llama, rwkv6, olmoe, jamba,
   encoder-decoder and VLM on the card and on the CPU from the same
   weights and batches (the MoE models' step-1 routing must agree first):
   metrics, moments and parameters must agree.
4. serve: full-width llama3.2-1b in float32, ServeEngine with 8 slots and
   max_len 1024, 12 seeded requests (prompts 60-700 tokens, half behind a
   shared 256-token prefix, 32 new tokens each), in four modes:
   (a) chunked prefill + prefix cache, (b) stall-the-world prefill
   (flash), (c) int8 pool, and the dense per-slot cache (chunked).
   Launch counts are reset before and read after each run; each mode
   must launch the kernels it uses.  Then a short bfloat16 run of (a).
   Then full-width olmoe-1b-7b (64 experts, top 8) in float32 on the same
   requests: (a) paged, chunked + prefix cache, (b) dense, chunked,
   (c) dense, stall-the-world; each must launch the MoE scatter and
   gather and its decode kernel; then (c) once more in bfloat16 (the
   tensor-core flash prefill and the bf16 dense decode on a served path),
   held to the same gates.  Then jamba-1.5-large at its published
   width cut to one card (2 layers: Mamba + dense FFN, attention + MoE;
   11.9 B parameters) in float32 in the same three modes, each launching
   the scan, the MoE kernels and its attention kernels, with the prefix
   cache requested in (a) and off (a recurrent stack); then its
   ``lm.forward`` at (1, 512), one scan launch per Mamba layer.  Then
   full-width rwkv6-1.6b cut to 8 of 24 layers in float32: (b) dense,
   chunked and (c) dense, stall-the-world (first-token logits within
   2e-3 of each other), (b) in bfloat16, and (a)'s paged + prefix + int8
   request, which a stack without attention serves dense without either; its
   carried-state WKV6 runs the plain version, so every run must launch
   no WKV6 kernel.  Each full-width run is profiled once more for the
   device's busy share, its top kernels and the MoE and scan kernels'
   share of its device time (rwkv6's (b) alone: the plain WKV6's share
   of device and wall time).  Then full-width, full-depth seamless-m4t-v2
   (24 + 24 layers) through the serve command's lockstep encoder-decoder
   path (batch 8, 256 frames + 256 tokens, 32 new tokens): flash 48 times
   a prefill, the dense decode 24 times a step; then the command's own
   loop profiled for the busy share, and cross-attention's share of the
   device time between the first and the last of the markers around each
   layer's cross-attention in 16 decode steps.  Then internvl2-76b at its published
   width in 2 layers: lockstep over 256 frontend embeddings + 256 text
   tokens at batch 4 (32 decode steps), then the engine's mode (a) on the
   text prompts.  Then phi3.5-moe-42b-a6.6b at its published width cut
   to 8 of its 32 layers (10.67 B parameters, 42.7 GB) in olmoe's modes
   (a) and (c), held to the same gates.
5. train: full-width, full-depth llama3.2-1b and rwkv6-1.6b, and
   olmoe-1b-7b at full width cut to ``OLMOE_TRAIN_DEPTH`` layers, in
   float32, batch 8 x 256 tokens, 4 AdamW steps each through
   ``make_train_step`` with the train command's settings.  Launch counts
   are reset before and read after the 4 steps; each run must launch each
   of its kernels exactly as often as the code says (``train_launches``),
   give finite losses and a finite, nonzero gradient to every parameter
   leaf (each expert of an MoE leaf) at step 1 (read from the first AdamW
   moment).  Step time, tok/s, peak memory and the device's busy share of
   one profiled step.  The same for seamless-m4t-v2 whole (128 frames +
   128 tokens) and internvl2-76b cut to 1 layer (2 steps at batch 4 x
   512, 256 of them frontend embeddings).  Then the train command itself
   on the card, at the published width and depth 1-2, for the five.
   Then llama3.2-1b, 2 steps under each remat policy: peak memory and
   step time, gradients equal.
6. plan: the paper's search (``repro_torch.core``) on the host for
   llama3.2-1b and olmoe-1b-7b at their published sizes, the train (8 x
   256), prefill (one 512-token prompt) and decode (8 slots over 1024
   tokens) phases on three modelled H100 meshes (one node of 8 on data,
   one of 2 x 4, two such nodes over InfiniBand), with and without the
   memory budget, beside the data / model / owt baselines (the search
   without the budget may cost no more than any baseline its space
   holds); the cost model's price of llama's uniform train step on one
   H100.  Then llama's 2 x 4 node plan saved and loaded (its chip must
   come back as the H100's), the train command at llama3.2-1b's published
   size for 2 steps without a plan and with ``--plan`` on that file (the
   mesh mismatch must be logged, the losses equal, flash launched 32
   times a step), and the serve command at the published size plain,
   ``--strategy searched --save-plan``, ``--plan`` on that file and
   ``--plan`` on the node plan (the paged decode launched, the tokens
   equal).  Then ``plan-train-staged``: llama's train plan searched on
   the node with 2 pipeline stages and 4 microbatches, saved, and the
   train command for the same 2 steps under it (its 4 microbatches on
   one card): the losses within the train tolerance of the plain run's, every
   kernel launched 4 times the unstaged step's count; its step time and
   peak memory beside the plain run's, and the plan's priced cost and
   bubble for the 8-card mesh (context, not a check).
7. profile: the device profile and the kernel dispatcher.  The profile
   command (``repro_torch.launch.profile``) at the smoke ladders: every
   ``cuda`` entry of its sweep must launch its kernel and the JSON load
   back equal; then at its default ladders (matmuls to 2048, streams from
   64 MiB), the profile that calibrates: the float32 GEMM rate (no TF32,
   as the port computes), the bfloat16 one beside it, the HBM rate, each
   (op, backend) time and factor.  llama3.2-1b's f32 train step priced by
   the calibrated cost model on one H100 beside the analytic price and
   the plan phase's measured step, and its train plan searched on the
   2 x 4 node mesh under the profile.  The reference phase's small llama
   served with ``kernel_backend="ref"`` and by default (tokens equal, no
   launch under ``ref``, the default run's launches the reference
   phase's); the serve command twice into one ``--autotune-cache-dir``
   (the second run re-tunes nothing).
8. realize: a searched plan realized on a one-device ``("data",
   "model")`` mesh (a world-1 ``nccl`` process group, its store under
   ``build/``; DTensor params, batch, cache and ZeRO-1 moments, the
   model under ``use_mesh``), each run beside the same run unrealized:
   two train steps of the small llama, rwkv6, olmoe and jamba under their
   ``model`` baseline plans (heads, d_ff, experts split on the model
   axes, each a whole tensor on this mesh), the small llama engine in its
   paged, int8 and dense modes under a searched serve plan, then
   llama3.2-1b at its published size: 2 train steps at 8 x 256 under the
   plan phase's saved 2 x 4 node plan and the 6-request paged serve run
   under its decode phase.  Losses and tokens must be equal (a difference
   is held to 1e-6 relative and reported), and every kernel's launch
   count equal to the unrealized run's: between them these runs launch
   all eight kernel bodies, each on the shard-local path.  Step time,
   peak memory and inter-token latency both ways (the host's DTensor
   dispatch overhead).  Its launches are not added to the kernels line.
9. dryrun: the dry run (``repro_torch.launch.dryrun``, in processes of
   its own: its fake process group never meets this one's).  Every
   kernel phase's call again on copies of its tensors without data: each
   kernel's fake branch must report the work that phase bounded it by.
   The ``train`` phase's one-card llama3.2-1b and olmoe-1b-7b-d8 runs
   predicted: the peak within 10% of the measured one, the roofline's
   lower bound at or below the measured step.  llama3.2-1b's
   ``train_4k`` on the 256-GPU production mesh under the ``profile``
   phase's device profile: its summary, its seconds and the per-layer
   report.  Launch counters and ``memory_allocated`` unchanged across
   the phase.
10. the ``kernels`` JSON line, the card's name and power limit, and the
   result line ``{"ok": true, "device": {...}}``.

Everything measured is also written to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
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
# width in float32, llama3.2 only: two attention paths and per-shape
# cuBLAS algorithms through 16 layers; logits are of order 1.  (olmoe's
# modes route with different capacities — C depends on the chunk — and
# may legitimately drop different tokens, so they are not compared.)
SERVE_LOGIT_TOL = 2e-3
# the same small model on the card and on the CPU (plain versions): f32
# sums in another order; with the int8 pool a K/V element on a rounding
# boundary may quantize to the neighbouring int8 value on one side (one
# step is 1/127 of the row's absmax), which moves logits by ~1e-3
REF_LOGIT_TOL = {"a": 1e-4, "b": 1e-4, "c": 5e-3}
# WKV6 outputs grow with the decayed sum over the sequence: its tolerances
# are relative to the largest output (sums in another order in float32;
# one bf16 rounding of the output in bfloat16)
WKV_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the selective scan: float32 y and final state within 1e-5 of their
# largest value (sums in another order, the SFU's 2^x against torch.exp
# over hundreds of steps); bfloat16 y within 1e-2 of its largest (one bf16
# rounding of the output; the state stays float32, held at 1e-5)
SCAN_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the SFUs make 16 exponentials a clock on each of the 132 SMs, at the
# 1.98 GHz boost clock that the float32 peak above assumes
SFU_EXP_S = 132 * 16 * 1.98e9
# an autograd Function's backward is the plain version's gradient at the
# same inputs: the same arithmetic, so only the forward may differ
GRAD_TOL = 1e-5
# small train steps, card vs CPU: metrics, moments and parameters within
# 1e-4 of the largest entry (moments) or 1e-5 (metrics, relative), or 4x
# the CPU's own float32 error where float32 is the limit (measured as the
# gap between the CPU's float32 and float64 runs; the rwkv6 group norm of
# a head whose output barely spreads at the first token amplifies
# rounding); a parameter whose gradient sits at the rounding level moves
# by +-lr at a step on either side, so at most 0.1% of a leaf's elements
# may differ by more than 1e-5 and none by more than 2 * sum(lr) + 1e-5
TRAIN_REF_TOL = {"metric": 1e-5, "moment": 1e-4, "noise": 4,
                 "param": 1e-5, "param_frac": 1e-3}
# the paged decode kernel's times before its split-KV redesign (ms, same
# phases and shapes, L2 flushed, on "NVIDIA H100 80GB HBM3, 700.00 W"),
# as PERF.md's kernel table records them; the int8-with-bf16-q and
# head-dim-128 int8 phases were not timed then
PAGED_BEFORE_MS = {"paged-f32": 0.136, "paged-bf16": 0.141,
                   "paged-int8": 0.146, "paged-d128-f32": 0.249,
                   "paged-d128-bf16": 0.254, "paged-jamba-f32": 0.275,
                   "paged-jamba-bf16": 0.286}
# the MoE kernels' times before their one-pass redesign (ms, same phases
# and shapes, L2 flushed, on "NVIDIA H100 80GB HBM3, 700.00 W"; the
# scatter's includes the torch.zeros memset of its buffer), as PERF.md's
# kernel table records them; the prefill phases' from the old kernels'
# tree timed by tools/moe_ab.py on this timer
MOE_BEFORE_MS = {
    "moe-scatter-prefill700-f32": 0.0423,
    "moe-scatter-prefill700-bf16": 0.0235,
    "moe-scatter-prefill1024-f32": 0.0600,
    "moe-scatter-prefill1024-bf16": 0.0312,
    "moe-scatter-prefill700-jamba-f32": 0.0490,
    "moe-scatter-prefill700-jamba-bf16": 0.0262,
    "moe-gather-prefill700-f32": 0.0296,
    "moe-gather-prefill700-bf16": 0.0183,
    "moe-gather-prefill1024-f32": 0.0385,
    "moe-gather-prefill1024-bf16": 0.0239,
    "moe-gather-prefill700-jamba-f32": 0.0335,
    "moe-gather-prefill700-jamba-bf16": 0.0207,
    "moe-scatter-decode-f32": 0.0198, "moe-scatter-decode-bf16": 0.0136,
    "moe-scatter-chunk-f32": 0.0191, "moe-scatter-chunk-bf16": 0.0135,
    "moe-scatter-decode-jamba-f32": 0.0224,
    "moe-scatter-decode-jamba-bf16": 0.0161,
    "moe-scatter-chunk-jamba-f32": 0.0215,
    "moe-scatter-chunk-jamba-bf16": 0.0152,
    "moe-gather-decode-f32": 0.0139, "moe-gather-decode-bf16": 0.0102,
    "moe-gather-chunk-f32": 0.0186, "moe-gather-chunk-bf16": 0.0127,
    "moe-gather-decode-jamba-f32": 0.0145,
    "moe-gather-decode-jamba-bf16": 0.0104,
    "moe-gather-chunk-jamba-f32": 0.0204,
    "moe-gather-chunk-jamba-bf16": 0.0136}
# the WKV6 kernel's times before its staged redesign (ms, same phases and
# shape, L2 flushed, on "NVIDIA H100 80GB HBM3, 700.00 W"): the previous
# kernel's tree timed by tools/moe_ab.py --kernel wkv6 on this timer, the
# mean of its two readings at the train shape
WKV_BEFORE_MS = {"wkv6-f32": 0.1641, "wkv6-bf16": 0.1896}
# the selective-scan kernel's times before its Hopper redesign (ms, same
# phases and shapes, L2 flushed, on "NVIDIA H100 80GB HBM3, 700.00 W"): the
# previous kernel's tree timed by tools/moe_ab.py --kernel scan on this
# timer, the mean of its two readings (A B B A)
SCAN_BEFORE_MS = {
    "mamba-chunk-f32": 0.0810, "mamba-chunk-bf16": 0.0836,
    "mamba-decode-f32": 0.0210, "mamba-decode-bf16": 0.0231,
    "mamba-prefill-f32": 0.2018, "mamba-prefill-bf16": 0.2081,
    "mamba-forward-f32": 0.1539, "mamba-forward-bf16": 0.1586,
    "mamba-n8-f32": 0.0806, "mamba-n8-bf16": 0.0830}
# device time of these kernels is read out of each serve profile by name
PROFILE_WATCH = ("moe_scatter", "moe_gather", "mamba_scan")
# the card's gradients under the three remat policies: the same arithmetic
# (cuBLAS picks one algorithm a shape), so the step-1 first moments agree
# within the train tolerance's moment term, the metrics within its metric
# term
REMAT_POLICIES = ("nothing", "dots", "dots_batch")
# the train command's optimizer and step settings (launch/train.py)
TRAIN_OPT = {"lr": 3e-3, "warmup_steps": 20}
TRAIN_CFG = {"q_chunk": 256, "time_chunk": 32, "remat": True}
# olmoe-1b-7b's train run keeps this many of its 16 layers (see
# olmoe_train_arch)
OLMOE_TRAIN_DEPTH = 8

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


def kernel_device_ms(torch, timer, fn, name: str, iters: int = 20):
    """Device duration (ms) a call of the kernels whose names hold
    ``name``, the mean over ``iters`` calls of ``fn``, each after the
    timer's L2 flush, read from ``torch.profiler``'s raw events: the
    kernels alone, without the launch that the event timer's readings
    include."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            timer.flush.zero_()
            fn()
        torch.cuda.synchronize()
    ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
          if name in e.name()]
    return sum(ns) / iters / 1e6 if ns else None


def bound(bytes_: float, flops: float, dtype: str, exps: float = 0.0):
    """The least time (ms) for the work and what sets it: bytes over the
    memory rate, or operations over the peak for their type (exponentials
    over the SFUs' rate, in their own pipe beside the FMAs)."""
    t_bytes = bytes_ / HBM_BYTES_S * 1e3
    t_ops = max(flops / PEAK_FLOPS[dtype], exps / SFU_EXP_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the kernel phases' calls queued for the dryrun phase, on copies of their
# tensors that hold no data: (phase, call, the work passed to bound())
FAKE_CALLS: list = []


def queue_fake(torch, phase: str, call, tensors, work) -> None:
    """Queue ``call(*fakes)`` for the dryrun phase, ``fakes`` being
    ``FakeTensor`` copies of ``tensors`` (shape, strides, dtype and device;
    no data, nothing on the card), beside ``work`` (``kernels.work``'s
    count, which the phase passes to :func:`bound`).  ``call`` may close
    over the small real tensors a data-dependent count reads (kv_len, the
    gates), never over the phase's large ones."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fakes = [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                     device=t.device) for t in tensors]
    FAKE_CALLS.append((phase, lambda: call(*fakes), work))


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


def phase_paged(torch, timer, device, name, pool_dtype, q_dtype, KH=8, G=4,
                D=64):
    """The split-KV paged kernel against its plain version at the engine's
    decode shape; its time beside the slice-1 kernel's (PAGED_BEFORE_MS)."""
    from repro_torch.kernels import ops, ref, work
    q, kp, vp, tables, kv_len, scales = paged_inputs(
        torch, device, KH=KH, G=G, D=D, pool_dtype=pool_dtype,
        q_dtype=q_dtype)
    got = ops.paged_decode_attention(q, kp, vp, tables, kv_len, **scales)
    want = ref.paged_decode_attention_ref(q, kp, vp, tables, kv_len,
                                          **scales)
    torch.cuda.synchronize()
    dt = "bfloat16" if q_dtype == torch.bfloat16 else "float32"
    err = float((got.float() - want.float()).abs().max())
    w = work.paged_decode_attention(q.shape, tables.shape[1],
                                    int(kv_len.sum()), q.element_size(),
                                    kp.element_size(), bool(scales))
    bytes_, flops = w.bytes, w.flops
    keys = list(scales)
    queue_fake(torch, name, lambda q_, kp_, vp_, t_, *sc:
               ops.paged_decode_attention(q_, kp_, vp_, t_, kv_len,
                                          **dict(zip(keys, sc))),
               [q, kp, vp, tables, *scales.values()], w)
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
           "before_ms": PAGED_BEFORE_MS.get(name),
           "bytes": bytes_, "flops": flops}
    emit(res)
    if not err <= TOL[dt]:
        fail(f"{name}: max abs err {err} > {TOL[dt]}")
    return res


def phase_flash(torch, timer, device, name, dtype, S=700, T=768, H=32, KH=8,
                D=64, plain_iters=5, B=1, causal=True):
    """Stall-the-world prefill's shape: q (1, H, S, D) of an S-token
    prompt against its cache row: llama3.2's paged row (S rounded up to
    whole 128-blocks), or olmoe's dense max_len row; or a long prompt at
    S = T (timed, with SDPA beside it, to rank flash against the library
    on a larger problem).  ``causal=False``: an encoder's self-attention,
    q (B, H, S, D) against all T keys (the flops 4 B H D S T)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref, work
    g = torch.Generator(device=device).manual_seed(SEED)
    q = torch.randn(B, H, S, D, generator=g, device=device).to(dtype)
    k = torch.randn(B, KH, T, D, generator=g, device=device).to(dtype)
    v = torch.randn(B, KH, T, D, generator=g, device=device).to(dtype)
    if causal:
        k[:, :, S:] = 0      # the row past the prompt holds zeros
        v[:, :, S:] = 0
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.attention_ref(q, k, v, causal=causal)
    lib = F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                         enable_gqa=True)
    torch.cuda.synchronize()
    dt = "bfloat16" if dtype == torch.bfloat16 else "float32"
    err = float((got.float() - want.float()).abs().max())
    lib_err = float((lib.float() - want.float()).abs().max())
    w = work.flash_attention(q.shape, k.shape, causal, q.element_size())
    bytes_, flops = w.bytes, w.flops
    queue_fake(torch, name, lambda *a: ops.flash_attention(*a, causal=causal),
               [q, k, v], w)
    b_ms, b_by = bound(bytes_, flops, dt)
    res = {"phase": name, "shape": {"q": list(q.shape), "kv": list(k.shape)},
           "causal": causal, "max_abs_err": err, "tol": TOL[dt],
           "kernel_ms": timer(lambda: ops.flash_attention(q, k, v,
                                                          causal=causal)),
           "kernel_call_ms": timer(lambda: ops.flash_attention(
               q, k, v, causal=causal), host=True),
           "plain_ms": timer(lambda: ref.attention_ref(q, k, v,
                                                       causal=causal),
                             iters=plain_iters),
           "library_ms": timer(lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=causal, enable_gqa=True)),
           "library_max_abs_err": lib_err,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": bytes_,
           "flops": flops}
    emit(res)
    if not err <= TOL[dt]:
        fail(f"{name}: max abs err {err} > {TOL[dt]}")
    return res


def phase_flash_train(torch, timer, device, name="flash-train-f32"):
    """The llama3.2-1b train step's attention: q (8, 32, 256, 64) against
    k/v (8, 8, 256, 64), causal, float32."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref, work
    g = torch.Generator(device=device).manual_seed(SEED)
    q = torch.randn(8, 32, 256, 64, generator=g, device=device)
    k = torch.randn(8, 8, 256, 64, generator=g, device=device)
    v = torch.randn(8, 8, 256, 64, generator=g, device=device)
    got = ops.flash_attention(q, k, v, causal=True)
    want = ref.attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    w = work.flash_attention(q.shape, k.shape, True, q.element_size())
    bytes_, flops = w.bytes, w.flops
    queue_fake(torch, name, lambda *a: ops.flash_attention(*a, causal=True),
               [q, k, v], w)
    b_ms, b_by = bound(bytes_, flops, "float32")
    res = {"phase": name, "shape": {"q": list(q.shape), "kv": list(k.shape)},
           "max_abs_err": err, "tol": TOL["float32"],
           "kernel_ms": timer(lambda: ops.flash_attention(q, k, v,
                                                          causal=True)),
           "plain_ms": timer(lambda: ref.attention_ref(q, k, v, causal=True),
                             iters=5),
           "library_ms": timer(lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True, enable_gqa=True)),
           "bound_ms": b_ms, "bound_by": b_by, "bytes": bytes_,
           "flops": flops}
    emit(res)
    if not err <= TOL["float32"]:
        fail(f"{name}: max abs err {err} > {TOL['float32']}")
    return res


def wkv_inputs(torch, device, dtype, B=8, H=32, T=256, N=64):
    """rwkv6-1.6b's time-mix shapes at batch 8 x 256 tokens: r/k/v in the
    activation dtype, w = exp(-exp(w_log)) and u in float32."""
    g = torch.Generator(device=device).manual_seed(SEED)
    r, k, v = (torch.randn(B, H, T, N, generator=g, device=device).to(dtype)
               for _ in range(3))
    w_log = torch.rand(B, H, T, N, generator=g, device=device) * 5 - 4
    w = torch.exp(-torch.exp(w_log))
    u = torch.randn(H, N, generator=g, device=device)
    return r, k, v, w, u


def phase_wkv6(torch, timer, device, name, dtype):
    """The WKV6 kernel against its plain version at ``wkv_inputs``' shape
    (rwkv6-1.6b's train step); its time beside the kernel's before the
    staged redesign (``WKV_BEFORE_MS``) and its device time alone."""
    from repro_torch.kernels import ops, ref, work
    r, k, v, w, u = wkv_inputs(torch, device, dtype)
    got = ops.wkv6(r, k, v, w, u)
    want = ref.wkv6_scan(r, k, v, w, u)
    torch.cuda.synchronize()
    dt = "bfloat16" if dtype == torch.bfloat16 else "float32"
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    wk = work.wkv6(r.shape, r.element_size())
    bytes_, flops = wk.bytes, wk.flops
    queue_fake(torch, name, lambda *a: ops.wkv6(*a), [r, k, v, w, u], wk)
    b_ms, b_by = bound(bytes_, flops, "float32")
    res = {"phase": name, "shape": list(r.shape), "max_abs_err": err,
           "max_abs_out": scale, "tol": WKV_TOL[dt] * scale,
           "kernel_ms": timer(lambda: ops.wkv6(r, k, v, w, u), iters=20),
           "kernel_call_ms": timer(lambda: ops.wkv6(r, k, v, w, u), iters=20,
                                   host=True),
           "kernel_device_ms": kernel_device_ms(
               torch, timer, lambda: ops.wkv6(r, k, v, w, u), "wkv6"),
           "plain_ms": timer(lambda: ref.wkv6_scan(r, k, v, w, u), iters=3,
                             warm=1),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "before_ms": WKV_BEFORE_MS.get(name),
           "bytes": bytes_, "flops": flops}
    emit(res)
    if not err <= WKV_TOL[dt] * scale:
        fail(f"{name}: max abs err {err} > {WKV_TOL[dt]} x {scale}")
    return res


def phase_decode(torch, timer, device, name, dtype, *, B, KH, G, D,
                 T=1024):
    """Dense-cache decode at the engine's shape: the (B, T, KH, D) cache
    passed transposed, ragged kv_len (prompts + 32 new tokens, tile and
    range edges, one full row; all below T).  The split over the KV axis
    depends on T alone, so a T-row cache takes the main path's split."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref, work
    rng = np.random.default_rng(SEED)
    g = torch.Generator(device=device).manual_seed(SEED)
    q = torch.randn(B, KH, G, D, generator=g, device=device).to(dtype)
    kc = torch.randn(B, T, KH, D, generator=g, device=device).to(dtype)
    vc = torch.randn(B, T, KH, D, generator=g, device=device).to(dtype)
    kv_len = rng.integers(60, min(733, T), B).astype(np.int32)
    kv_len[:3] = [64, 65, T]
    kv_len = torch.as_tensor(kv_len, device=device)
    k, v = kc.transpose(1, 2), vc.transpose(1, 2)
    plain = lambda: ref.decode_attention_ref(
        q.reshape(B, KH * G, D), k, v, kv_len).reshape(B, KH, G, D)
    mask = (torch.arange(T, device=device)[None, :]
            < kv_len[:, None])[:, None, None, :]                 # (B,1,1,T)
    lib = lambda: F.scaled_dot_product_attention(
        q.reshape(B, KH * G, 1, D), k, v, attn_mask=mask, enable_gqa=True)
    got = ops.decode_attention(q, k, v, kv_len)
    want = plain()
    lib_err = float((lib().reshape(B, KH, G, D).float()
                     - want.float()).abs().max())
    torch.cuda.synchronize()
    dt = "bfloat16" if dtype == torch.bfloat16 else "float32"
    err = float((got.float() - want.float()).abs().max())
    w = work.decode_attention(q.shape, int(kv_len.sum()), q.element_size())
    bytes_, flops = w.bytes, w.flops
    queue_fake(torch, name, lambda *a: ops.decode_attention(*a, kv_len),
               [q, k, v], w)
    b_ms, b_by = bound(bytes_, flops, dt)
    res = {"phase": name, "shape": {"q": list(q.shape), "cache": list(kc.shape),
                                    "kv_len": kv_len.tolist()},
           "max_abs_err": err, "tol": TOL[dt],
           "kernel_ms": timer(lambda: ops.decode_attention(q, k, v, kv_len),
                              iters=50),
           "kernel_call_ms": timer(lambda: ops.decode_attention(
               q, k, v, kv_len), iters=50, host=True),
           "plain_ms": timer(plain, iters=10),
           "library_ms": timer(lib, iters=20), "library_max_abs_err": lib_err,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": bytes_,
           "flops": flops}
    emit(res)
    if not err <= TOL[dt]:
        fail(f"{name}: max abs err {err} > {TOL[dt]}")
    return res


def moe_gather_library(out, lin, gates):
    """The MoE gather as one PyTorch call, the gather kernel's yardstick
    (never on the port's path): ``F.embedding_bag`` in mode "sum" over the
    (B * n_slots, D) expert outputs, bag (b, s) the K rows
    ``min(lin, n_slots - 1) + b * n_slots`` weighted by the gates (in
    out's dtype).  A zero gate multiplies its row, so unlike the kernel
    it needs finite rows where gates are zero."""
    import torch
    import torch.nn.functional as F
    B, n_slots, D = out.shape
    S, K = lin.shape[1:]
    idx = (lin.clamp(max=n_slots - 1)
           + n_slots * torch.arange(B, device=lin.device,
                                    dtype=lin.dtype)[:, None, None])
    y = F.embedding_bag(idx.reshape(B * S, K), out.reshape(B * n_slots, D),
                        mode="sum",
                        per_sample_weights=gates.reshape(B * S, K)
                        .to(out.dtype))
    return y.reshape(B, S, D)


def phase_launch_floor(torch, timer):
    """One near-empty kernel under the kernel phases' timer: the launch and
    ramp that every kernel time below includes."""
    res = {"phase": "launch-floor",
           "kernel_ms": timer(lambda: torch.cuda._sleep(0), iters=50)}
    emit(res)
    return res


def phase_moe(torch, timer, device, name, dtype, *, B, S, C, K=8, E=64,
              D=2048):
    """olmoe's MoE scatter and gather at the engine's shapes: routing of K
    distinct experts per token from random router scores, its slot
    assignment (the chunk shape drops assignments past capacity), the
    expert outputs random.  Returns the scatter's and the gather's rows."""
    from repro_torch.kernels import moe_dispatch, ref, work
    g = torch.Generator(device=device).manual_seed(SEED)
    idx = torch.rand(B, S, E, generator=g, device=device).topk(K, -1)[1]
    lin, keep = ref.moe_positions(idx, E, C)
    lin = lin.reshape(B, S, K)
    x = torch.randn(B, S, D, generator=g, device=device).to(dtype)
    out = torch.randn(B, E * C, D, generator=g, device=device).to(dtype)
    gates = (torch.rand(B, S, K, generator=g, device=device)
             * keep.reshape(B, S, K))
    dt = "bfloat16" if dtype == torch.bfloat16 else "float32"
    el = x.element_size()
    kept = int(keep.sum())
    live = int((gates != 0).sum())
    # library: the scatter as one index_put_ into a zeroed buffer
    rows = torch.arange(B, device=device)[:, None, None].expand(B, S, K)
    src = x[:, :, None, :].expand(B, S, K, D)
    kmask = lin < E * C

    def library():
        buf = torch.zeros(B, E * C + 1, D, dtype=dtype, device=device)
        return buf.index_put_((rows[kmask], lin[kmask].long()), src[kmask])

    got = moe_dispatch.moe_scatter_cuda(x, lin, E * C)
    want = ref.moe_scatter_ref(x, lin, E * C)
    lib_err = float((library() - want).float().abs().max())
    y = moe_dispatch.moe_gather_cuda(out, lin, gates)
    y_want = ref.moe_gather_ref(out, lin, gates)
    gather_lib = lambda: moe_gather_library(out, lin, gates)
    gather_lib_err = float((gather_lib() - y_want).float().abs().max())
    torch.cuda.synchronize()
    shape = {"B": B, "S": S, "K": K, "E": E, "C": C, "D": D,
             "kept_assignments": kept, "assignments": B * S * K}
    w_scatter = work.moe_scatter(x.shape, K, E * C, el)
    w_gather = work.moe_gather(x.shape, K, live, el)
    queue_fake(torch, f"moe-scatter-{name}",
               lambda *a: moe_dispatch.moe_scatter_cuda(*a, E * C), [x, lin],
               w_scatter)
    queue_fake(torch, f"moe-gather-{name}",
               lambda *a: moe_dispatch.moe_gather_cuda(*a, gates),
               [out, lin], w_gather)
    results = []
    for kind, err, kern, plain, lib, w, extra in (
            ("scatter", float((got - want).float().abs().max()),
             lambda: moe_dispatch.moe_scatter_cuda(x, lin, E * C),
             lambda: ref.moe_scatter_ref(x, lin, E * C), library, w_scatter,
             {"library_max_abs_err": lib_err}),
            ("gather", float((y - y_want).float().abs().max()),
             lambda: moe_dispatch.moe_gather_cuda(out, lin, gates),
             lambda: ref.moe_gather_ref(out, lin, gates), gather_lib,
             w_gather, {"library_max_abs_err": gather_lib_err})):
        bytes_, flops = w.bytes, w.flops
        b_ms, b_by = bound(bytes_, flops, dt)
        res = {"phase": f"moe-{kind}-{name}", "shape": shape,
               "max_abs_err": err, "tol": 0.0 if kind == "scatter"
               else TOL[dt],
               "kernel_ms": timer(kern, iters=50),
               "kernel_call_ms": timer(kern, iters=50, host=True),
               "kernel_device_ms": kernel_device_ms(torch, timer, kern,
                                                    f"moe_{kind}"),
               "plain_ms": timer(plain, iters=10),
               "library_ms": timer(lib, iters=20),
               "before_ms": MOE_BEFORE_MS.get(f"moe-{kind}-{name}"),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": bytes_,
               "flops": flops, **extra}
        emit(res)
        if not err <= res["tol"]:
            fail(f"moe-{kind}-{name}: max abs err {err} > {res['tol']}")
        results.append(res)
    return results


def mamba_inputs(torch, device, dtype, *, B, S, di=16384, N=16, state=True):
    """The selective scan as jamba's mixer feeds it: dt = softplus(.) > 0,
    A = -exp(A_log) with the reference's log(1..N) init plus noise, D near
    1, dt/x/B/C in ``dtype``, a float32 initial state (the cache row).  B
    and C are split views of one (B, S, rank + 2N) tensor, as ``mamba_mix``
    splits ``x_proj``'s output (rank = di / 32: jamba's 512)."""
    g = torch.Generator(device=device).manual_seed(SEED)
    rn = lambda *shape: torch.randn(*shape, generator=g, device=device)
    dt = torch.nn.functional.softplus(rn(B, S, di) - 4).to(dtype)
    rank = max(1, di // 32)
    _, Bm, Cm = torch.split(rn(B, S, rank + 2 * N).to(dtype), [rank, N, N],
                            dim=-1)
    x = rn(B, S, di).to(dtype)
    ar = torch.arange(1, N + 1, device=device, dtype=torch.float32)
    A = -torch.exp(torch.log(ar).expand(di, N) + 0.1 * rn(di, N))
    D = 1 + 0.1 * rn(di)
    h0 = rn(B, di, N) if state else None
    return dt, Bm, Cm, x, A, D, h0


def phase_mamba(torch, timer, device, name, dtype, *, B, S, di=16384, N=16,
                state=True):
    """The scan kernel against its plain version at one of jamba's shapes:
    y, and the final state when a state is carried; its time beside the
    kernel's before the Hopper redesign (``SCAN_BEFORE_MS``) and its device
    time alone."""
    from repro_torch.kernels import ops, ref, work
    dt_, Bm, Cm, x, A, D, h0 = mamba_inputs(torch, device, dtype, B=B, S=S,
                                            di=di, N=N, state=state)
    kw = dict(initial_state=h0, return_state=state)
    got = ops.mamba_scan(dt_, Bm, Cm, x, A, D, **kw)
    want = ref.mamba_scan_ref(dt_, Bm, Cm, x, A, D, **kw)
    torch.cuda.synchronize()
    y, wy = (got[0], want[0]) if state else (got, want)
    dt = "bfloat16" if dtype == torch.bfloat16 else "float32"
    scale = float(wy.float().abs().max())
    err = float((y.float() - wy.float()).abs().max())
    ok = err <= SCAN_TOL[dt] * scale
    st = {}
    if state:
        hs = float(want[1].abs().max())
        st = {"state_max_abs_err": float((got[1] - want[1]).abs().max()),
              "max_abs_state": hs, "state_tol": SCAN_TOL["float32"] * hs}
        ok &= st["state_max_abs_err"] <= st["state_tol"]
    w = work.mamba_scan(B, S, di, N, x.element_size(), state_in=state,
                        state_out=state)
    bytes_, flops, exps = w.bytes, w.flops, w.exps
    queue_fake(torch, name, lambda *a: ops.mamba_scan(
        *a[:6], initial_state=a[6] if state else None, return_state=state),
        [dt_, Bm, Cm, x, A, D] + ([h0] if state else []), w)
    b_ms, b_by = bound(bytes_, flops, "float32", exps)
    res = {"phase": name, "shape": {"B": B, "S": S, "di": di, "N": N,
                                    "state": state},
           "max_abs_err": err, "max_abs_out": scale,
           "tol": SCAN_TOL[dt] * scale, **st,
           "kernel_ms": timer(lambda: ops.mamba_scan(dt_, Bm, Cm, x, A, D,
                                                     **kw), iters=20),
           "kernel_call_ms": timer(lambda: ops.mamba_scan(
               dt_, Bm, Cm, x, A, D, **kw), iters=20, host=True),
           "kernel_device_ms": kernel_device_ms(
               torch, timer, lambda: ops.mamba_scan(dt_, Bm, Cm, x, A, D,
                                                    **kw), "mamba_scan"),
           "plain_ms": timer(lambda: ref.mamba_scan_ref(dt_, Bm, Cm, x, A, D,
                                                        **kw),
                             iters=3, warm=1),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "before_ms": SCAN_BEFORE_MS.get(name),
           "bytes": bytes_, "flops": flops, "exps": exps}
    emit(res)
    if not ok:
        fail(f"{name}: y err {err} (tol {SCAN_TOL[dt]} x {scale}), {st}")
    return res


def phase_mamba_dt0(torch, device):
    """The decode shape with a carried state: rows whose dt is 0 (slots
    that sit a mixed step out) come out with their initial state bitwise;
    the others match the plain version's."""
    from repro_torch.kernels import mamba_scan, ref
    for dtype in (torch.float32, torch.bfloat16):
        dt_, Bm, Cm, x, A, D, h0 = mamba_inputs(torch, device, dtype, B=8,
                                                S=1)
        idle = [1, 5]
        dt_[idle] = 0
        _, want = ref.mamba_scan_ref(dt_, Bm, Cm, x, A, D, initial_state=h0,
                                     return_state=True)
        _, hN = mamba_scan.mamba_scan_cuda(dt_, Bm, Cm, x, A, D,
                                           initial_state=h0,
                                           return_state=True)
        torch.cuda.synchronize()
        name = str(dtype).replace("torch.", "")
        same = all(torch.equal(hN[r], h0[r]) for r in idle)
        moved = all(not torch.equal(hN[r], h0[r])
                    for r in range(8) if r not in idle)
        err = float((hN - want).abs().max())
        tol = SCAN_TOL["float32"] * float(want.abs().max())
        res = {"phase": f"mamba-dt0-{name}", "idle_rows": idle,
               "idle_rows_bitwise_unchanged": same,
               "other_rows_moved": moved, "state_max_abs_err": err,
               "tol": tol}
        emit(res)
        if not (same and moved and err <= tol):
            fail(f"mamba-dt0-{name}: {res}")


def phase_grads(torch, device):
    """The autograd Functions (flash and WKV6 at the train shapes, MoE and
    the scan at small ones): output and every input gradient against the
    plain version's own autograd on the same inputs."""
    from repro_torch.kernels import ops, ref

    def run(fn, inputs, g):
        leaves = [t.detach().requires_grad_() for t in inputs]
        out = fn(*leaves)
        out.backward(g)
        torch.cuda.synchronize()
        return [out.detach()] + [t.grad for t in leaves]

    gen = torch.Generator(device=device).manual_seed(SEED)
    # MoE: 2 rows of 64 tokens, 16 experts top 4, capacity 16 (drops some)
    E, K, C = 16, 4, 16
    idx = torch.rand(2, 64, E, generator=gen, device=device).topk(K, -1)[1]
    moe_in = [torch.randn(2, 64, 512, generator=gen, device=device),
              torch.rand(2, 64, K, generator=gen, device=device)] + [
        torch.randn(s, generator=gen, device=device) / s[1] ** 0.5
        for s in ((E, 512, 256), (E, 512, 256), (E, 256, 512))]
    cases = {
        "moe-grad-f32": (
            lambda x, g, *w: ops.moe_dispatch_combine(x, g, idx, *w,
                                                      capacity=C),
            lambda x, g, *w: ref.moe_dense_ref(x, g, idx, *w, capacity=C),
            moe_in),
        "flash-grad-f32": (
            lambda *a: ops.flash_attention(*a, causal=True),
            lambda *a: ref.attention_ref(*a, causal=True),
            [torch.randn(8, 32, 256, 64, generator=gen, device=device),
             torch.randn(8, 8, 256, 64, generator=gen, device=device),
             torch.randn(8, 8, 256, 64, generator=gen, device=device)]),
        "wkv6-grad-f32": (
            lambda *a: ops.wkv6(*a, chunk=TRAIN_CFG["time_chunk"]),
            lambda *a: ref.wkv6_scan(*a, chunk=TRAIN_CFG["time_chunk"]),
            list(wkv_inputs(torch, device, torch.float32))),
    }
    # the scan with a carried state: y and the final state, flattened into
    # one output so one cotangent covers both
    m_in = list(mamba_inputs(torch, device, torch.float32, B=2, S=96, di=256))

    def scan(fn):
        return lambda *a: torch.cat([t.flatten() for t in fn(
            *a[:6], chunk=32, initial_state=a[6], return_state=True)])

    cases["mamba-grad-f32"] = (scan(ops.mamba_scan),
                               scan(ref.mamba_scan_ref), m_in)
    for name, (kern, plain, inputs) in cases.items():
        with torch.no_grad():
            shape = plain(*inputs).shape
        g = torch.randn(shape, generator=gen, device=device)
        t0 = time.perf_counter()
        got = run(kern, inputs, g)
        kern_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = run(plain, inputs, g)
        plain_s = time.perf_counter() - t0
        errs = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(got, want)]
        nonzero = all(float(t.abs().max()) > 0 for t in got[1:])
        emit({"phase": name, "rel_err_out": errs[0],
              "rel_err_grads": errs[1:], "tol": GRAD_TOL,
              "fwd_bwd_s": kern_s, "plain_fwd_bwd_s": plain_s,
              "grads_nonzero": nonzero})
        if not (max(errs) <= GRAD_TOL and nonzero):
            fail(f"{name}: relative errors {errs} (tol {GRAD_TOL}), "
                 f"nonzero gradients {nonzero}")


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


# ServeConfig of each serve mode: llama3.2's (a) chunked + prefix cache,
# (b) stall-the-world, (c) int8 pool, and the dense per-slot cache; then
# olmoe's (a) paged, chunked + prefix cache, (b) dense, chunked, (c) dense,
# stall-the-world
SERVE_MODES = {"a": {}, "b": {"prefill_chunk_tokens": 0},
               "c": {"kv_quant": "int8"}, "dense": {"kv_block_size": 0}}
OLMOE_MODES = {"a": {}, "b": {"kv_block_size": 0},
               "c": {"kv_block_size": 0, "prefill_chunk_tokens": 0}}
# jamba's: the same three; in (a) the prefix cache is requested (the
# ServeConfig default) and must stay off, the stack being recurrent
JAMBA_MODES = OLMOE_MODES
# rwkv6's: (a) the paged pool with the prefix cache and int8 KV requested,
# which a stack without attention takes as the dense layout with neither;
# (b) dense, chunked; (c) dense, stall-the-world
RWKV_MODES = {"a": {"kv_quant": "int8"}, "b": {"kv_block_size": 0},
              "c": {"kv_block_size": 0, "prefill_chunk_tokens": 0}}


def serve_once(torch, params, arch, requests, *, mode, dtype, device,
               max_batch=8, max_len=1024, modes=SERVE_MODES, engine=None,
               watch=contextlib.nullcontext, plan=None):
    """One engine run with the launch counts reset just before it and read
    just after (the run alone inside the context ``watch()``); returns the
    measurements and the engine."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeConfig
    kw = modes[mode]
    eng = (engine or recording_engine())(params, arch, ServeConfig(
        max_batch=max_batch, max_len=max_len, dtype=dtype, **kw), plan=plan)
    warm_s = eng.warmup(sorted({len(r.prompt) for r in requests}))
    if device.type == "cuda":
        torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with watch():
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
           "prefix_cache_on": eng.prefix is not None,
           "kv_bytes_reserved": eng.kv_bytes_reserved,
           "finite": eng.finite}
    return res, eng, {c.uid: c.tokens for c in done}


def routing_engine(log: dict):
    """Recording engine that appends, for every MoE layer call, the experts
    each row's tokens chose and the request each row belongs to (None for
    a row that advances no token) to ``log["calls"]``."""
    base = recording_engine()

    class Routing(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            real_step = self._step

            def step(params, tokens, cache, pos, q_lens=None,
                     block_tables=None):
                uid = {slot: st.request.uid
                       for slot, st in self.scheduler.active.items()}
                B, T = tokens.shape
                ql = ([1] * B if q_lens is None
                      else [int(n) for n in q_lens.tolist()])
                # a chunk step's decode pass runs the rows with one token;
                # its chunk pass runs the granted row (the most tokens)
                live = [n == 1 if T > 1 else n > 0 for n in ql]
                rows = [uid.get(b) if live[b] else None for b in range(B)]
                g = max(range(B), key=lambda b: ql[b])
                log["rows"] = {B: rows, "chunk": [uid.get(g)]}
                return real_step(params, tokens, cache, pos, q_lens=q_lens,
                                 block_tables=block_tables)
            self._step = step

        def _admit_one(self):
            log["rows"] = {"chunk": [self.queue[0].uid]}
            return super()._admit_one()

    return Routing


def record_routing(log: dict):
    """Wrap ``models.moe.route`` so each call logs its experts; returns the
    function that restores it."""
    from repro_torch.models import moe
    real = moe.route

    def route(p, x, arch, *cfg):
        out = real(p, x, arch, *cfg)
        rows = (log["rows"].get(x.shape[0]) or log["rows"].get("chunk")
                or [None] * x.shape[0])           # warmup: no request
        log["calls"].append((out[1].cpu(), list(rows)))
        return out
    moe.route = route
    return lambda: setattr(moe, "route", real)


def phase_reference(torch, device):
    """Two small models served on the card and on the CPU with the same
    weights: a llama (2 layers, d 256, 4 heads over 2 KV heads, hd 64) in
    its modes (a)-(c), the CUDA kernels against the plain versions through
    the whole engine; and an rwkv6 (2 layers, d 256, 4 heads of 64) in its
    dense modes (b) and (c), where the carried-state WKV6 recurrence runs
    its plain version on both sides and no kernel may launch."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import lm
    small = {"llama3.2-1b": (dict(n_layers=2, d_model=256, n_heads=4,
                                  n_kv_heads=2, d_ff=512, vocab=512,
                                  head_dim=64), SERVE_MODES, "abc"),
             "rwkv6-1.6b": (dict(n_layers=2, d_model=256, n_heads=4,
                                 n_kv_heads=4, d_ff=512, vocab=512),
                            RWKV_MODES, "bc")}
    for name, (kw, modes, run) in small.items():
        arch = dataclasses.replace(configs.get(name), **kw)
        params = lm.init_lm(arch, torch.float32,
                            generator=torch.Generator().manual_seed(SEED),
                            device="cpu")
        reqs = make_requests(arch.vocab, n=6, gen=8)
        for mode in run:
            runs = {}
            for dev in (device, torch.device("cpu")):
                p = lm.tree_map(lambda t: t.to(dev), params)
                res, eng, toks = serve_once(
                    torch, p, arch, reqs, mode=mode, dtype=torch.float32,
                    device=dev, max_batch=4, max_len=1024, modes=modes)
                runs[dev.type] = (eng.first_logits, toks, res["launches"])
            (gl, gt, launches), (cl, ct, _) = runs["cuda"], runs["cpu"]
            err = max(float((gl[u] - cl[u]).abs().max()) for u in cl)
            same = sum(a == b for u in ct for a, b in zip(gt[u], ct[u]))
            total = sum(len(t) for t in ct.values())
            llama = name == "llama3.2-1b"
            tag = ("reference" if llama else "reference-rwkv6") + f"-{mode}"
            tol = REF_LOGIT_TOL[mode if llama else "a"]
            emit({"phase": tag, "arch": arch.name,
                  "first_logits_max_abs_err": err, "tol": tol,
                  "tokens_equal": same, "tokens": total,
                  "launches_card": launches})
            if not err <= tol:
                fail(f"{tag}: card vs CPU logits differ by {err}")
            if len(cl) != len(reqs):
                fail(f"{tag}: {len(cl)} of {len(reqs)} first tokens")
            if not llama and any(launches.values()):
                fail(f"{tag}: kernels launched on a path that has none "
                     f"({launches})")


def small_moe_arch(name: str):
    """The small MoE models served on the card and on the CPU: olmoe (2
    layers, d 256, 2 heads of 128, 8 experts top 2, d_ff 128), and jamba
    (4 layers in its 2-layer pattern -- Mamba + dense FFN, attention + MoE
    -- d 256, 4 heads of 64 over 2 KV heads, 4 experts top 2, N 16)."""
    import dataclasses
    from repro_torch import configs
    if name == "olmoe":
        return dataclasses.replace(
            configs.get("olmoe-1b-7b"), n_layers=2, d_model=256, n_heads=2,
            n_kv_heads=2, d_ff=128, moe_d_ff=128, vocab=512, n_experts=8,
            top_k=2)
    return dataclasses.replace(
        configs.get("jamba-1.5-large-398b"), name="jamba-small", n_layers=4,
        pattern=configs.reduced("jamba_1_5_large").pattern, d_model=256,
        n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512, moe_d_ff=512,
        vocab=512, n_experts=4, top_k=2, ssm_state=16)


def phase_reference_moe(torch, device, name, modes, kernels):
    """A small MoE model (:func:`small_moe_arch`) served on the card and on
    the CPU with the same weights, in its three modes.  The experts each
    token chose are compared first: the card and the CPU may break a
    near-tie of two router probabilities differently, and a request with a
    different choice anywhere takes another path.  First-token logits are
    held only for the requests whose every routing choice agreed.  The
    card run must launch ``kernels``."""
    from repro_torch.models import lm
    arch = small_moe_arch(name)
    params = lm.init_lm(arch, torch.float32,
                        generator=torch.Generator().manual_seed(SEED),
                        device="cpu")
    reqs = make_requests(arch.vocab, n=6, gen=8)
    for mode in modes:
        runs = {}
        for dev in (device, torch.device("cpu")):
            log = {"calls": [], "rows": {}}
            restore = record_routing(log)
            try:
                p = lm.tree_map(lambda t: t.to(dev), params)
                res, eng, toks = serve_once(
                    torch, p, arch, reqs, mode=mode, dtype=torch.float32,
                    device=dev, max_batch=4, max_len=1024,
                    modes=modes, engine=routing_engine(log))
            finally:
                restore()
            runs[dev.type] = (eng.first_logits, toks, log["calls"],
                              res["launches"])
        (gl, gt, gc, launches), (cl, ct, cc, _) = runs["cuda"], runs["cpu"]
        choices = flips = 0
        moved = set()
        for (a, rows), (b, _) in zip(gc, cc):
            differ = (a != b).any(-1)                      # (rows, tokens)
            for r, uid in enumerate(rows):
                if uid is not None:
                    choices += differ.shape[1]
                    flips += int(differ[r].sum())
                    if bool(differ[r].any()):
                        moved.add(uid)
        held = [u for u in cl if u not in moved]
        err = max((float((gl[u] - cl[u]).abs().max()) for u in held),
                  default=float("nan"))
        same = sum(x == y for u in held for x, y in zip(gt[u], ct[u]))
        tag = f"reference-{name}-{mode}"
        emit({"phase": tag, "arch": arch.name,
              "moe_calls": [len(gc), len(cc)],
              "routing_choices": choices, "routing_choices_differing": flips,
              "requests_rerouted": sorted(moved), "requests_held": held,
              "first_logits_max_abs_err": err, "tol": REF_LOGIT_TOL["a"],
              "tokens_equal": same,
              "tokens": sum(len(ct[u]) for u in held),
              "launches_card": launches})
        if len(gc) != len(cc) or not choices:
            fail(f"{tag}: {len(gc)} MoE calls on the card, {len(cc)} on "
                 f"the CPU")
        if not held or not err <= REF_LOGIT_TOL["a"]:
            fail(f"{tag}: card vs CPU logits differ by {err} over "
                 f"{len(held)} requests with equal routing")
        if min(launches[k] for k in kernels) <= 0:
            fail(f"{tag}: the kernels {kernels} were not all launched "
                 f"({launches})")


def small_seq2seq_archs() -> dict:
    """The small encoder-decoder and VLM held card vs CPU: seamless-m4t-v2
    in 2 + 2 layers, d 256, 4 heads of 64, vocab 512; internvl2's reduced
    shape widened to d 256, 4 heads of 64 over 2 KV heads, vocab 512, 16
    frontend embeddings."""
    import dataclasses
    from repro_torch import configs
    return {
        "seamless": dataclasses.replace(
            configs.get("seamless-m4t-large-v2"), name="seamless-small",
            n_layers=2, enc_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
            d_ff=512, vocab=512),
        "internvl2": dataclasses.replace(
            configs.get("internvl2-76b"), name="internvl2-small", n_layers=2,
            d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
            vocab=512, frontend_tokens=16)}


def lockstep(torch, arch, params, batch, gen, feed=None):
    """The serve command's lockstep loop (``launch.serve.lockstep``: one
    prefill over dense rows, then ``gen - 1`` decode steps at one scalar
    position) for an encoder-decoder or a VLM, with the launch counts of
    the run (reset just before it, read just after): flash launches in
    the prefill alone, the dense decode in the steps alone."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    ops.reset_launch_counts()
    out = serve.lockstep(params, arch, batch, gen, feed=feed)
    out["launches"] = ops.launch_counts()
    out["finite"] = all(bool(torch.isfinite(o).all()) for o in out["logits"])
    return out


def phase_reference_seq2seq(torch, device):
    """The small encoder-decoder and VLM (:func:`small_seq2seq_archs`) in
    lockstep on the card and on the CPU with the same weights and batch (16
    frames or frontend embeddings + 16 tokens, batch 2): the prefill
    logits and 8 decode steps, the card fed the CPU's greedy tokens, all
    within ``REF_LOGIT_TOL``; the card's run must launch flash once a
    layer of each stack (the encoder's non-causal) and the dense decode
    once a decoder layer a step.  Then one dense cache continued
    mid-sequence (``layers.attention``, scalar ``cache_pos`` 16, S 8, over
    a row holding 16 tokens), output and cache, card vs CPU."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    cpu = torch.device("cpu")
    tol = REF_LOGIT_TOL["a"]
    for name, arch in small_seq2seq_archs().items():
        params = init_model(torch, arch, "cpu",
                            torch.Generator().manual_seed(SEED))
        batch = batches_for(torch, arch, 2, 32, 1, cpu)[0]
        want = lockstep(torch, arch, params, batch, 9)
        p = lm.tree_map(lambda t: t.to(device), params)
        got = lockstep(torch, arch, p, {k: v.to(device)
                                        for k, v in batch.items()},
                       9, feed=want["tokens"][:, :-1])
        del p
        err = max(float((a.cpu() - b).abs().max())
                  for a, b in zip(got["logits"], want["logits"]))
        n_layers = arch.n_layers + arch.enc_layers
        res = {"phase": f"reference-{name}", "arch": arch.name,
               "batch": {k: list(v.shape) for k, v in batch.items()},
               "decode_steps": 8, "logits_max_abs_err": err, "tol": tol,
               "launches": got["launches"]}
        emit(res)
        if not (err <= tol and got["finite"]):
            fail(f"reference-{name}: card vs CPU logits differ by {err}")
        if (got["launches"]["flash_attention"] != n_layers
                or got["launches"]["decode_attention"] != 8 * arch.n_layers):
            fail(f"reference-{name}: launches {got['launches']} (want flash "
                 f"{n_layers}, decode {8 * arch.n_layers})")

    arch = small_seq2seq_archs()["internvl2"]
    g = torch.Generator().manual_seed(SEED)
    p = L.init_attention(arch, torch.float32, generator=g, device="cpu")
    shape = (2, 32, arch.n_kv_heads, arch.hd)
    cache = {k: torch.zeros(shape) for k in ("k", "v")}
    for c in cache.values():
        c[:, :16] = torch.randn(2, 16, *shape[2:], generator=g)
    x = torch.randn(2, 8, arch.d_model, generator=g)
    outs = {}
    for dev in (device, cpu):
        c = {k: v.to(dev, copy=True) for k, v in cache.items()}
        ops.reset_launch_counts()
        with torch.no_grad():
            o, c = L.attention(lm.tree_map(lambda t: t.to(dev), p),
                               x.to(dev), arch,
                               positions=torch.arange(16, 24, device=dev),
                               kv_cache=c, cache_pos=16)
        outs[dev.type] = (o.cpu(), {k: v.cpu() for k, v in c.items()},
                          ops.launch_counts())
    (go, gc, launched), (co, cc, _) = outs["cuda"], outs["cpu"]
    err = max(float((go - co).abs().max()),
              *(float((gc[k] - cc[k]).abs().max()) for k in gc))
    emit({"phase": "reference-midseq", "q": [2, 8, arch.n_heads, arch.hd],
          "cache": list(shape), "cache_pos": 16, "max_abs_err": err,
          "tol": tol, "launches_card": launched})
    if not err <= tol:
        fail(f"reference-midseq: card vs CPU differ by {err}")


def busy_share(torch, fn, bracket=None):
    """Run ``fn`` once under ``torch.profiler`` (device activity only);
    returns (wall s, device busy s, top kernels, watched kernels,
    (bracketed s, markers, window s)).  Busy time is the sum of the device events' durations (kernels,
    copies, memsets; one stream, so they do not overlap), read from the
    raw trace: building the profiler's per-operator tables takes minutes
    for a run of ~10^5 launches.  The watched kernels: device time, count
    and share of the busy time of the kernels whose names hold each of
    ``PROFILE_WATCH``.  ``bracket``: part of the name of a marker kernel
    that ``fn`` launches before and after some of its work; the bracketed
    time sums the device events between each pair (the markers are left
    out of every sum), ``markers`` counts them, and the window sums every
    device event between the first marker and the last."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = defaultdict(lambda: [0, 0])               # name -> [ns, count]
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if str(e.device_type()).endswith("CUDA")),
                    key=lambda e: e.start_ns())
    inside, bracketed, markers, since, window = False, 0, 0, 0, 0
    for e in events:
        if bracket and bracket in e.name():
            inside = not inside
            markers += 1
            window = since
            continue
        row = by_name[e.name()]
        row[0] += e.duration_ns()
        row[1] += 1
        bracketed += e.duration_ns() if inside else 0
        since += e.duration_ns() if markers else 0
    busy = sum(ns for ns, _ in by_name.values()) / 1e9
    rows = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)
    top = [{"name": name[:80], "device_ms": ns / 1e6, "count": n}
           for name, (ns, n) in rows[:10]]
    watched = {}
    for w in PROFILE_WATCH:
        ns = sum(t for name, (t, _) in rows if w in name)
        watched[w] = {"device_ms": ns / 1e6,
                      "count": sum(n for name, (_, n) in rows if w in name),
                      "share": ns / 1e9 / busy if busy else None}
    return wall, busy, top, watched, (bracketed / 1e9, markers, window / 1e9)


def profile_run(torch, params, arch, requests, mode, modes, wall_s,
                name, dtype=None, watch=contextlib.nullcontext,
                bracket=None):
    """``mode`` once more under ``torch.profiler``: the device's busy share
    of the run's wall time and the kernels that take the most device time.
    The profiler adds host time of its own, so the busy share it gives is
    a lower bound; ``wall_s`` (the unprofiled run's wall) gives the share
    of the same device work without it.  ``watch`` and ``bracket`` as in
    :func:`serve_once` and :func:`busy_share`."""
    from repro_torch.serve import ServeConfig
    eng = recording_engine()(params, arch, ServeConfig(
        max_batch=8, max_len=1024, dtype=dtype or torch.float32,
        **modes[mode]))
    eng.warmup(sorted({len(r.prompt) for r in requests}))

    def run():
        with watch():
            eng.run(requests)
    wall, busy, top, watched, inside = busy_share(torch, run, bracket)
    res = {"phase": f"profile-{name}", "wall_s": wall,
           "device_busy_s": busy,
           "device_busy_share": busy / wall if busy else None,
           "device_busy_share_unprofiled": busy / wall_s,
           "top_kernels": top, "watched_kernels": watched}
    if bracket is not None:
        (res["bracketed_device_s"], res["bracket_markers"],
         res["bracket_window_device_s"]) = inside
    return res


def serve_modes(torch, params, arch, reqs, device, *, name, modes, need,
                profile):
    """Each mode of ``modes`` once, launch counts reset just before and read
    just after; each must launch the kernels ``need`` names for it, give
    finite logits and serve every request.  Modes in ``profile`` run once
    more under the profiler.  Returns (runs, main-path launch counts by
    run)."""
    runs, counts = {}, {}
    for mode in modes:
        res, eng, toks = serve_once(torch, params, arch, reqs, mode=mode,
                                    dtype=torch.float32, device=device,
                                    modes=modes)
        runs[mode] = (res, eng.first_logits, toks)
        del eng
        counts[f"{name}-{mode}"] = res["launches"]
        emit({"phase": f"{name}-{mode}", "arch": arch.name,
              "config": modes[mode], **res})
        for k in need[mode]:
            if res["launches"][k] <= 0:
                fail(f"{name}-{mode}: kernel {k} was not launched")
        if not res["finite"]:
            fail(f"{name}-{mode}: non-finite logits")
        if res["requests"] != len(reqs):
            fail(f"{name}-{mode}: {res['requests']} of {len(reqs)} served")
        if mode in profile:
            emit(profile_run(torch, params, arch, reqs, mode, modes,
                             res["wall_s"], f"{name}-{mode}"))
        torch.cuda.empty_cache()
    return runs, counts


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
            "c": ["paged_decode_attention_int8"],
            "dense": ["decode_attention"]}
    runs, counts = serve_modes(torch, params, arch, reqs, device,
                               name="serve", modes=SERVE_MODES, need=need,
                               profile=("a", "dense"))
    if runs["a"][0]["prefill_tokens_saved"] <= 0:
        fail("serve-a: no prefix-cache hit")
    for other in ("b", "dense"):
        la, lb = runs["a"][1], runs[other][1]
        err = max(float((la[u] - lb[u]).abs().max()) for u in lb)
        ta, tb = runs["a"][2], runs[other][2]
        same = sum(x == y for u in tb for x, y in zip(ta[u], tb[u]))
        total = sum(len(t) for t in tb.values())
        emit({"phase": f"serve-a-vs-{other}",
              "first_logits_max_abs_err": err, "tol": SERVE_LOGIT_TOL,
              "requests_compared": len(lb), "token_agreement": same / total,
              "tokens_equal": same, "tokens": total})
        if len(lb) != len(reqs) or not err <= SERVE_LOGIT_TOL:
            fail(f"serve a vs {other}: first-token logits differ by {err}")
    bf = lm.tree_map(lambda t: t.to(torch.bfloat16), params)
    del params, runs
    res, _, _ = serve_once(torch, bf, arch, reqs, mode="a",
                           dtype=torch.bfloat16, device=device)
    emit({"phase": "serve-a-bf16", **res})
    if not res["finite"]:
        fail("serve-a-bf16: non-finite logits")
    return counts


def phase_serve_olmoe(torch, device):
    """Full-width olmoe-1b-7b (16 layers, d 2048, 16 heads of 128, 64
    experts top 8, d_ff 1024, vocab 50304) in float32, random weights, on
    the llama phase's requests, in its three modes.  Each mode is held to
    finite logits, every request served and its kernels launched; the
    modes are not compared with each other (their capacities differ)."""
    from repro_torch import configs
    from repro_torch.models import lm
    arch = configs.get("olmoe-1b-7b")
    t0 = time.perf_counter()
    params = lm.init_lm(arch, torch.float32,
                        generator=torch.Generator(device=device)
                        .manual_seed(SEED), device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in lm.tree_leaves(params))
    print(f"# olmoe weights: {n_params / 1e9:.2f} B in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    moe = ["moe_scatter", "moe_gather"]
    need = {"a": ["paged_decode_attention", *moe],
            "b": ["decode_attention", *moe],
            "c": ["decode_attention", "flash_attention", *moe]}
    reqs = make_requests(arch.vocab)
    runs, counts = serve_modes(torch, params, arch, reqs, device,
                               name="serve-olmoe", modes=OLMOE_MODES,
                               need=need, profile=tuple(OLMOE_MODES))
    if runs["a"][0]["prefill_tokens_saved"] <= 0:
        fail("serve-olmoe-a: no prefix-cache hit")
    del runs

    # (c) in bfloat16, the dtype a deployment serves in: the tensor-core
    # flash prefill and the bf16 dense decode on a served path
    bf = lm.tree_map(lambda t: t.to(torch.bfloat16), params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res, eng, _ = serve_once(torch, bf, arch, reqs, mode="c",
                             dtype=torch.bfloat16, device=device,
                             modes=OLMOE_MODES)
    del eng
    counts["serve-olmoe-c-bf16"] = res["launches"]
    emit({"phase": "serve-olmoe-c-bf16", "arch": arch.name,
          "config": OLMOE_MODES["c"], **res})
    for k in need["c"]:
        if res["launches"][k] <= 0:
            fail(f"serve-olmoe-c-bf16: kernel {k} was not launched")
    if not res["finite"]:
        fail("serve-olmoe-c-bf16: non-finite logits")
    if res["requests"] != len(reqs):
        fail(f"serve-olmoe-c-bf16: {res['requests']} of {len(reqs)} served")
    emit(profile_run(torch, bf, arch, reqs, "c", OLMOE_MODES, res["wall_s"],
                     "serve-olmoe-c-bf16", dtype=torch.bfloat16))
    del bf
    return counts


def jamba_one_card():
    """jamba-1.5-large at its published width, cut in depth to one card:
    ``reduced_arch`` to 2 layers, which takes the reduced config's 2-layer
    pattern (layer 0 Mamba + dense SwiGLU, layer 1 attention + MoE) in
    place of 72 layers of the period-8 block (one MoE layer alone holds
    9.66 B parameters)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch.train import reduced_arch
    return dataclasses.replace(
        reduced_arch(configs.get("jamba-1.5-large-398b"), 0, 2, 0),
        name="jamba-1.5-large-1card")


def phase_serve_jamba(torch, device):
    """Full-width jamba-1.5-large-1card (d 8192, 64 heads over 8 KV heads
    of 128, d_ff 24576, 16 experts top 2, d_inner 16384, N 16, vocab 65536)
    in float32, random weights, on the llama phase's requests, in its
    three modes; each must launch the scan, the MoE scatter and gather and
    its attention kernels, and in (a) the requested prefix cache must be
    off.  Then ``lm.forward`` at (1, 512) under ``no_grad``: the TPU
    kernel's own stateless form, one scan launch per Mamba layer."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    arch = jamba_one_card()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = lm.init_lm(arch, torch.float32, generator=gen, device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in lm.tree_leaves(params))
    print(f"# jamba weights: {n_params / 1e9:.2f} B in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB", flush=True)
    base = ["mamba_scan", "moe_scatter", "moe_gather"]
    need = {"a": ["paged_decode_attention", *base],
            "b": ["decode_attention", *base],
            "c": ["decode_attention", "flash_attention", *base]}
    runs, counts = serve_modes(torch, params, arch,
                               make_requests(arch.vocab), device,
                               name="serve-jamba", modes=JAMBA_MODES,
                               need=need, profile=tuple(JAMBA_MODES))
    a = runs["a"][0]
    if a["prefix_cache_on"] or a["prefill_tokens_saved"] != 0:
        fail(f"serve-jamba-a: the prefix cache is on a recurrent stack "
             f"({a['prefill_tokens_saved']} tokens saved)")
    del runs
    gc.collect()
    torch.cuda.empty_cache()

    tokens = torch.randint(0, arch.vocab, (1, 512), generator=gen,
                           device=device)
    n_mamba = arch.n_units * sum(l.mixer == "mamba" for l in arch.pattern)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, aux = lm.forward(params, {"tokens": tokens}, arch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd = ops.launch_counts()
    counts["forward-jamba"] = fwd
    finite = bool(torch.isfinite(logits).all()) and math.isfinite(float(aux))
    emit({"phase": "forward-jamba", "arch": arch.name, "params": n_params,
          "tokens": list(tokens.shape), "logits": list(logits.shape),
          "finite": finite, "wall_ms": wall * 1e3, "mamba_layers": n_mamba,
          "launches": fwd,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    if not finite or tuple(logits.shape) != (1, 512, arch.vocab):
        fail(f"forward-jamba: finite {finite}, shape {tuple(logits.shape)}")
    if fwd["mamba_scan"] != n_mamba or min(fwd["moe_scatter"],
                                           fwd["flash_attention"]) <= 0:
        fail(f"forward-jamba: launches {fwd} (want mamba_scan == "
             f"{n_mamba})")
    del params, logits
    return counts


@contextlib.contextmanager
def stateful_wkv6_watch(log: dict, marker=None):
    """Wrap ``ops.wkv6`` so that each carried-state call (the serve path's
    plain WKV6 recurrence) adds its host seconds to ``log["host_s"]`` and
    one to ``log["calls"]``.  ``marker`` (a launch of one near-empty
    kernel) brackets each such call in the device trace (see
    :func:`busy_share`).  The stateless form passes through untouched."""
    from repro_torch.kernels import ops
    real = ops.wkv6

    def wkv6(*a, initial_state=None, return_state=False, **kw):
        if initial_state is None and not return_state:
            return real(*a, **kw)
        if marker:
            marker()
        t0 = time.perf_counter()
        out = real(*a, initial_state=initial_state,
                   return_state=return_state, **kw)
        log["host_s"] += time.perf_counter() - t0
        log["calls"] += 1
        if marker:
            marker()
        return out
    ops.wkv6 = wkv6
    try:
        yield log
    finally:
        ops.wkv6 = real


def phase_serve_rwkv(torch, device):
    """Full-width rwkv6-1.6b cut to 8 of its 24 layers (d 2048, 32 heads
    of 64, d_ff 7168, vocab 65536; the plain carried-state WKV6 makes
    the phase host-bound, so depth is what the smoke's time limit cuts
    first) in float32, random weights, on the llama phase's requests:
    (b) dense chunked and (c) dense stall-the-world, (b) once more under
    the profiler with the plain WKV6's calls bracketed; their first-token
    logits within ``SERVE_LOGIT_TOL``; (b) in bfloat16 (the WKV state
    stays float32); then (a)'s request (paged, prefix cache, int8), which
    the engine must take as the dense layout without int8 or a prefix
    cache.  Each run is held to finite logits and every request served,
    and records the plain stateful WKV6's calls and its share of the
    run's wall time."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch.train import reduced_arch
    from repro_torch.models import lm
    arch = dataclasses.replace(
        reduced_arch(configs.get("rwkv6-1.6b"), 0, 8, 0),
        name="rwkv6-1.6b-d8")
    t0 = time.perf_counter()
    params = lm.init_lm(arch, torch.float32,
                        generator=torch.Generator(device=device)
                        .manual_seed(SEED), device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in lm.tree_leaves(params))
    print(f"# rwkv6 weights: {n_params / 1e9:.2f} B in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    reqs = make_requests(arch.vocab)
    # the marker: torch.cuda._sleep launches ATen's spin_kernel
    marker = lambda: torch.cuda._sleep(0)
    counts, first = {}, {}
    bf = None
    for mode, dtype in (("b", torch.float32), ("c", torch.float32),
                        ("b", torch.bfloat16), ("a", torch.float32)):
        if dtype == torch.bfloat16:
            bf = lm.tree_map(lambda t: t.to(torch.bfloat16), params)
        tag = f"serve-rwkv6-{mode}" + ("-bf16" if dtype == torch.bfloat16
                                       else "")
        log = {"host_s": 0.0, "calls": 0}
        res, eng, _ = serve_once(
            torch, bf if dtype == torch.bfloat16 else params, arch, reqs,
            mode=mode, dtype=dtype, device=device, modes=RWKV_MODES,
            watch=lambda: stateful_wkv6_watch(log))
        res.update({"engine": {"paged": eng.paged, "kv_quant": eng.kv_quant,
                               "prefix_cache": eng.prefix is not None},
                    "plain_wkv6_calls": log["calls"],
                    "plain_wkv6_host_s": log["host_s"],
                    "plain_wkv6_wall_share": log["host_s"] / res["wall_s"]})
        if dtype == torch.float32 and mode in "bc":
            first[mode] = eng.first_logits
        del eng
        counts[tag] = res["launches"]
        emit({"phase": tag, "arch": arch.name, "params": n_params,
              "config": RWKV_MODES[mode], **res})
        # the carried-state WKV6 runs its plain version, as the
        # reference's does: no kernel yet (ROADMAP B2, the carried-state
        # kernel, turns this into a lower bound)
        if res["launches"]["wkv6"] != 0:
            fail(f"{tag}: {res['launches']['wkv6']} WKV6 kernel launches "
                 f"on the carried-state path")
        if not res["finite"]:
            fail(f"{tag}: non-finite logits")
        if res["requests"] != len(reqs):
            fail(f"{tag}: {res['requests']} of {len(reqs)} served")
        if res["plain_wkv6_calls"] <= 0:
            fail(f"{tag}: the stateful WKV6 was never called")
        if res["engine"] != {"paged": False, "kv_quant": None,
                             "prefix_cache": False}:
            fail(f"{tag}: engine {res['engine']} (a stack without "
                 f"attention serves dense, without int8 or prefix cache)")
        if dtype == torch.float32 and mode == "b":
            plog = {"host_s": 0.0, "calls": 0}
            prof = profile_run(
                torch, params, arch, reqs, mode, RWKV_MODES, res["wall_s"],
                f"serve-rwkv6-{mode}",
                watch=lambda: stateful_wkv6_watch(plog, marker),
                bracket="spin_kernel")
            if prof["bracket_markers"] != 2 * plog["calls"]:
                fail(f"profile-{tag}: {prof['bracket_markers']} markers in "
                     f"the trace for {plog['calls']} WKV6 calls")
            prof.update({
                "plain_wkv6_calls": plog["calls"],
                "plain_wkv6_device_s": prof["bracketed_device_s"],
                "plain_wkv6_device_share":
                    prof["bracketed_device_s"] / prof["device_busy_s"],
                "plain_wkv6_wall_share": plog["host_s"] / prof["wall_s"]})
            emit(prof)
        gc.collect()
        torch.cuda.empty_cache()
    err = max(float((first["b"][u] - first["c"][u]).abs().max())
              for u in first["c"])
    emit({"phase": "serve-rwkv6-b-vs-c", "first_logits_max_abs_err": err,
          "tol": SERVE_LOGIT_TOL, "requests_compared": len(first["c"])})
    if len(first["c"]) != len(reqs) or not err <= SERVE_LOGIT_TOL:
        fail(f"serve-rwkv6 b vs c: first-token logits differ by {err}")
    del params, bf
    return counts


@contextlib.contextmanager
def cross_attention_watch(log: dict, marker, marked: range):
    """Wrap ``lm._cross_attend`` so that ``marker`` (a launch of one
    near-empty kernel) brackets in the device trace (see
    :func:`busy_share`) each decoder layer's cross-attention whose index
    among the run's calls is in ``marked``: its norm, the memory's K/V
    projection, the chunked core and the output projection.
    ``log["calls"]`` counts the calls, ``log["marked"]`` the bracketed."""
    from repro_torch.models import lm
    real = lm._cross_attend

    def cross(h, lp, arch, positions, memory, *cfg):
        if memory is None:
            return real(h, lp, arch, positions, memory, *cfg)
        mark = log["calls"] in marked
        log["calls"] += 1
        if not mark:
            return real(h, lp, arch, positions, memory, *cfg)
        marker()
        out = real(h, lp, arch, positions, memory, *cfg)
        marker()
        log["marked"] += 1
        return out
    lm._cross_attend = cross
    try:
        yield log
    finally:
        lm._cross_attend = real


SEAMLESS_SERVE = ["--arch", "seamless-m4t-large-v2", "--width", "0",
                  "--depth", "0", "--vocab", "0", "--batch", "8",
                  "--prompt-len", "512", "--gen", "32"]


def phase_serve_seamless(torch, device):
    """Full-width, full-depth seamless-m4t-v2 (24 + 24 layers, d 1024, 16
    heads of 64, d_ff 8192, vocab 256206; 2.04 B parameters) in float32,
    random weights, through the serve command (``SEAMLESS_SERVE``): its
    lockstep encoder-decoder path at batch 8, ``--prompt-len 512`` (256
    frames + 256 decoder tokens), ``--gen 32``.  The command runs a
    prefill and a step on a throwaway cache first, then the timed prefill
    and 31 steps: flash must launch 48 times a prefill (24 non-causal in
    the encoder, 24 causal in the decoder), the dense decode 24 times a
    step.  Then the command's loop (``launch.serve.lockstep``) on the
    command's weights and batch once more under the profiler, for the
    busy share; and a prefill and 18 decode steps under it with markers
    around each layer's cross-attention in the middle 16 steps: its share
    of the device time between the first marker and the last."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import lm
    arch = configs.get("seamless-m4t-large-v2")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve.main(SEAMLESS_SERVE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_prefill = arch.enc_layers + arch.n_layers
    want = {"flash_attention": 2 * per_prefill,        # warm-up + timed
            "decode_attention": arch.n_layers * 32}    # 1 warm-up + 31
    gen = out["tokens"]
    res = {"phase": "serve-seamless", "arch": arch.name,
           "gen": list(gen.shape), "wall_s": wall,
           "prefill_ms": out["prefill_s"] * 1e3,
           "decode_ms": out["decode_s"] * 1e3,
           "decode_ms_per_step": out["decode_s"] * 1e3 / 31,
           "decode_tok_s": out["decode_tok_s"],
           "launches": counts, "launches_expected": want,
           "flash_per_prefill": counts["flash_attention"] / 2,
           "decode_per_step": counts["decode_attention"] / 32,
           "max_memory_allocated_gb": peak}
    if any(counts[k] != n for k, n in want.items()):
        fail(f"serve-seamless: launches {counts} (want {want})")
    if not bool((gen >= 0).all() and (gen < arch.vocab).all()):
        fail("serve-seamless: tokens out of the vocabulary")
    del out

    args = serve.parser().parse_args(SEAMLESS_SERVE)
    params, batch = serve.encdec_inputs(args, arch, device, torch.float32)
    res.update({"params": sum(t.numel() for _, t in lm.tree_leaves(params)),
                "batch": {k: list(v.shape) for k, v in batch.items()}})
    ls = None

    def run():
        nonlocal ls
        ls = lockstep(torch, arch, params, batch, 32)
    wall_p, busy, top, _, _ = busy_share(torch, run)
    res.update({"profile_wall_s": wall_p, "device_busy_s": busy,
                "device_busy_share": busy / wall_p,
                "device_busy_share_unprofiled":
                    busy / (ls["prefill_s"] + ls["decode_s"]),
                "top_kernels": top, "finite": ls["finite"]})
    if not ls["finite"]:
        fail("serve-seamless: non-finite logits")
    res["tokens_equal_command"] = bool(torch.equal(ls["tokens"], gen))

    # a prefill (24 cross-attention calls) and 18 steps (24 each); the
    # middle 16 steps' calls are bracketed by markers (torch.cuda._sleep
    # launches ATen's spin_kernel), so that no marker is the trace's
    # first or last event (one went missing there in a run with no
    # unmarked steps)
    n = arch.n_layers
    log = {"calls": 0, "marked": 0}
    with cross_attention_watch(log, lambda: torch.cuda._sleep(0),
                               range(2 * n, 18 * n)):
        wall_d, busy_d, top_d, _, (xs, markers, window) = busy_share(
            torch, lambda: lockstep(torch, arch, params, batch, 19),
            bracket="spin_kernel")
    res.update({"decode_profile": {
        "decode_steps": 18, "marked_steps": 16, "wall_s": wall_d,
        "device_busy_s": busy_d, "top_kernels": top_d,
        "cross_attention_calls": log["calls"],
        "cross_attention_marked": log["marked"],
        "cross_attention_device_s": xs,
        "cross_attention_device_ms_per_step": xs * 1e3 / 16,
        "window_device_s": window,
        "cross_attention_device_share": xs / window,
        "markers": markers}})
    emit(res)
    if markers != 2 * log["marked"] or log["marked"] != 16 * n:
        fail(f"serve-seamless: {markers} markers for {log['marked']} "
             f"marked cross-attention calls (want {16 * n})")
    del params, batch, ls
    return {"serve-seamless": counts}


def phi35_one_card():
    """phi3.5-moe-42b-a6.6b at its published width (d 4096, 32 heads over
    8 KV heads of 128, 16 experts top 2 of d_ff 6400, vocab 32064), cut
    in depth to one card by ``reduced_arch`` to 8 of its 32 layers: 10.67
    B parameters, 42.7 GB in float32."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch.train import reduced_arch
    return dataclasses.replace(
        reduced_arch(configs.get("phi3.5-moe-42b-a6.6b"), 0, 8, 0),
        name="phi3.5-moe-d8")


# phi3.5-moe's serve modes: olmoe's (a) paged, chunked + prefix cache and
# (c) dense, stall-the-world
PHI35_MODES = {k: OLMOE_MODES[k] for k in ("a", "c")}


def phase_serve_phi35(torch, device):
    """Full-width phi3.5-moe-d8 (``phi35_one_card``) in float32, seeded
    weights, on the llama phase's requests in modes (a) and (c) of
    olmoe: (a) must launch the paged decode and both MoE kernels and hit
    the prefix cache, (c) the dense decode, flash and both MoE kernels;
    each gives finite logits and serves every request."""
    from repro_torch.models import lm
    arch = phi35_one_card()
    t0 = time.perf_counter()
    params = lm.init_lm(arch, torch.float32,
                        generator=torch.Generator(device=device)
                        .manual_seed(SEED), device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in lm.tree_leaves(params))
    gb = torch.cuda.memory_allocated() / 1e9
    print(f"# phi3.5 weights: {n_params / 1e9:.2f} B in "
          f"{time.perf_counter() - t0:.1f} s, {gb:.1f} GB", flush=True)
    emit({"phase": "serve-phi3.5-weights", "arch": arch.name,
          "params": n_params, "memory_allocated_gb": gb})
    moe = ["moe_scatter", "moe_gather"]
    need = {"a": ["paged_decode_attention", *moe],
            "c": ["decode_attention", "flash_attention", *moe]}
    runs, counts = serve_modes(torch, params, arch,
                               make_requests(arch.vocab), device,
                               name="serve-phi3.5", modes=PHI35_MODES,
                               need=need, profile=())
    if runs["a"][0]["prefill_tokens_saved"] <= 0:
        fail("serve-phi3.5-a: no prefix-cache hit")
    del params, runs
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def internvl2_one_card(depth: int):
    """internvl2-76b at its published width (d 8192, 64 heads over 8 KV
    heads of 128, d_ff 28672, vocab 128256), cut in depth by
    ``reduced_arch``: its 80 layers are ~70 B parameters."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch.train import reduced_arch
    return dataclasses.replace(
        reduced_arch(configs.get("internvl2-76b"), 0, depth, 0),
        name=f"internvl2-76b-d{depth}")


def phase_serve_internvl2(torch, device):
    """internvl2-76b at published width in 2 layers (3.81 B parameters) in
    float32, random weights: ``lm.prefill`` with 256 frontend embeddings +
    256 text tokens at batch 4 over dense rows, then 32 lockstep decode
    steps at one scalar position (flash once a layer in the prefill, the
    dense decode once a layer a step, asserted), profiled once more for
    the busy share; then the engine on the llama phase's text prompts in
    mode (a) (paged, chunked, prefix cache), as the reference's command
    serves a VLM, which must launch the paged decode."""
    from repro_torch.models import lm
    arch = internvl2_one_card(2)
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = lm.init_lm(arch, torch.float32, generator=gen, device=device)
    n_params = sum(t.numel() for _, t in lm.tree_leaves(params))
    batch = batches_for(torch, arch, 4, 512, 1, device)[0]
    out = lockstep(torch, arch, params, batch, 33)
    want = {"flash_attention": arch.n_layers,
            "decode_attention": arch.n_layers * 32}
    got = {k: out["launches"][k] for k in want}
    wall_p, busy, top, _, _ = busy_share(
        torch, lambda: lockstep(torch, arch, params, batch, 33))
    res = {"phase": "serve-internvl2-lockstep", "arch": arch.name,
           "params": n_params,
           "batch": {k: list(v.shape) for k, v in batch.items()},
           "decode_steps": 32, "prefill_ms": out["prefill_s"] * 1e3,
           "decode_ms_per_step": out["decode_s"] * 1e3 / 32,
           "decode_tok_s": 4 * 32 / out["decode_s"],
           "launches": out["launches"], "finite": out["finite"],
           "profile_wall_s": wall_p, "device_busy_s": busy,
           "device_busy_share": busy / wall_p,
           "device_busy_share_unprofiled":
               busy / (out["prefill_s"] + out["decode_s"]),
           "top_kernels": top,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(res)
    if got != want or not out["finite"]:
        fail(f"serve-internvl2-lockstep: launches {got} (want {want}), "
             f"finite {out['finite']}")
    counts = {"serve-internvl2-lockstep": out["launches"]}
    del batch, out
    gc.collect()
    torch.cuda.empty_cache()
    modes = {"a": SERVE_MODES["a"]}
    _, engine_counts = serve_modes(
        torch, params, arch, make_requests(arch.vocab), device,
        name="serve-internvl2", modes=modes,
        need={"a": ["paged_decode_attention"]}, profile=())
    counts.update(engine_counts)
    del params
    return counts


# --------------------------------------------------------------------------- #
# phases 3 and 5: training
# --------------------------------------------------------------------------- #
def make_step(torch, arch, steps):
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, make_train_step
    return make_train_step(arch, None, TrainConfig(
        optimizer=AdamWConfig(total_steps=steps, **TRAIN_OPT), **TRAIN_CFG))


def batches_for(torch, arch, batch, seq, steps, device):
    """The train command's dataset batches on ``device``: tokens, with
    frames (an encoder-decoder) or frontend embeddings (a VLM)."""
    from repro_torch.data import make_dataset
    from repro_torch.models.arch import ShapeSpec
    ds = make_dataset(arch, ShapeSpec("custom", seq, batch, "train"))
    return [{k: torch.as_tensor(v, device=device)
             for k, v in ds.batch_at(s).items()} for s in range(steps)]


def init_model(torch, arch, device, generator, dtype=None):
    """``models.init_params``, as the train command calls it."""
    from repro_torch.models import init_params
    return init_params(arch, dtype, generator=generator, device=device)


def flat(torch, tree):
    from repro_torch.models import lm
    return {"/".join(p): t.detach().double().cpu()
            for p, t in lm.tree_leaves(tree)}


def phase_reference_train(torch, device):
    """Two train steps of six small models on the card (kernels forward,
    plain gradients) and on the CPU (plain versions), from the same
    weights and batches: a llama, an rwkv6 (head size 64), the olmoe and
    jamba of :func:`small_moe_arch`, and the encoder-decoder and VLM of
    :func:`small_seq2seq_archs` (on frames or frontend embeddings).  The
    CPU runs the models without experts once more in float64 to measure
    float32's own error; an MoE model routes in float32 whatever its dtype, so such a
    run could choose other experts, and the MoE models are held to the
    tolerances alone.  Their routing is compared first: on a near-tie the
    card and the CPU may choose different experts, which moves the loss
    by more than float error, so every expert choice of step 1 (the
    forward pass and both recomputes) must agree."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init
    small = {"llama3.2-1b": (dataclasses.replace(
                 configs.get("llama3.2-1b"), n_layers=2, d_model=256,
                 n_heads=4, n_kv_heads=2, d_ff=512, vocab=512, head_dim=64),
                 ["flash_attention"]),
             "rwkv6-1.6b": (dataclasses.replace(
                 configs.get("rwkv6-1.6b"), n_layers=2, d_model=256,
                 n_heads=4, n_kv_heads=4, d_ff=512, vocab=512), ["wkv6"]),
             "olmoe": (small_moe_arch("olmoe"),
                       ["flash_attention", "moe_scatter", "moe_gather"]),
             "jamba": (small_moe_arch("jamba"),
                       ["flash_attention", "moe_scatter", "moe_gather",
                        "mamba_scan"])}
    small.update((name, (arch, ["flash_attention"]))
                 for name, arch in small_seq2seq_archs().items())
    tol = TRAIN_REF_TOL
    cpu = torch.device("cpu")
    for name, (arch, kernels) in small.items():
        params = init_model(torch, arch, "cpu",
                            torch.Generator().manual_seed(SEED))
        batches = batches_for(torch, arch, 2, 64, 2, cpu)
        step = make_step(torch, arch, 2)
        sides = [("card", device, torch.float32), ("cpu", cpu, torch.float32)]
        if not arch.n_experts:
            sides.append(("cpu64", cpu, torch.float64))
        runs = {}
        for tag, dev, dt in sides:
            # a copy: the step updates its parameters in place
            p = lm.tree_map(lambda t: t.to(dev, dt, copy=True), params)
            o = adamw_init(p)
            mets, log = [], {"calls": [], "rows": {}}
            restore = record_routing(log)
            try:
                ops.reset_launch_counts()
                for b in batches:
                    p, o, m = step(p, o, {k: v.to(dev)
                                          for k, v in b.items()})
                    mets.append({k: float(v) for k, v in m.items()})
                    log.setdefault("step1", len(log["calls"]))
                launched = ops.launch_counts()
            finally:
                restore()
            runs[tag] = (flat(torch, p), flat(torch, o["m"]), mets,
                         {k: launched[k] for k in kernels},
                         [c for c, _ in log["calls"]], log["step1"])
        (pc, mc, metc, n_card, rc, cut), (pp, mp, metp, _, rp, _) = (
            runs["card"], runs["cpu"])
        _, m64, met64 = runs.get("cpu64", (None, None, None))[:3]
        bad = []
        # tokens whose expert choices differ, call by call
        flips = [int((a != b).any(-1).sum()) for a, b in zip(rc, rp)]
        if len(rc) != len(rp):
            bad.append(f"{len(rc)} routing calls on the card, {len(rp)} on "
                       f"the CPU")
        if sum(flips[:cut]):
            bad.append(f"step 1 routing differs for {sum(flips[:cut])} "
                       f"token choices")
        lr_sum = sum(m["lr"] for m in metp)
        for i, (a, b) in enumerate(zip(metc, metp)):
            for k in b:
                lim = tol["metric"] * (1 + abs(b[k]))
                if met64 is not None:
                    lim = max(lim, tol["noise"] * abs(b[k] - met64[i][k]))
                if not abs(a[k] - b[k]) <= lim:
                    bad.append(f"step {i + 1} {k}: {a[k]} vs {b[k]}")
        worst_m = worst_p = frac_p = 0.0
        for k in mp:
            lim = tol["moment"] * max(float(mp[k].abs().max()), 1e-30)
            if m64 is not None:
                lim = max(lim, tol["noise"]
                          * float((mp[k] - m64[k]).abs().max()))
            err = float((mc[k] - mp[k]).abs().max())
            worst_m = max(worst_m, err / lim)
            if not err <= lim:
                bad.append(f"moment {k}: {err} > {lim}")
            d = (pc[k] - pp[k]).abs()
            worst_p = max(worst_p, float(d.max()))
            frac_p = max(frac_p, float((d > tol["param"]).double().mean()))
        if worst_p > 2 * lr_sum + tol["param"] or frac_p > tol["param_frac"]:
            bad.append(f"params: max diff {worst_p}, share beyond "
                       f"{tol['param']} {frac_p}")
        if min(n_card.values()) <= 0:
            bad.append(f"the card run launched {n_card}")
        emit({"phase": f"reference-train-{name}", "arch": arch.name,
              "steps": 2, "loss_card": [m["loss"] for m in metc],
              "loss_cpu": [m["loss"] for m in metp],
              "routing_calls": len(rc),
              "routing_tokens_differing": [sum(flips[:cut]),
                                           sum(flips[cut:])],
              "moment_err_over_limit": worst_m, "param_max_diff": worst_p,
              "param_share_beyond_tol": frac_p, "param_limit": 2 * lr_sum
              + tol["param"], "float64_noise": m64 is not None,
              "launches_card": n_card, "tol": tol})
        if bad:
            fail(f"reference-train-{name}: " + "; ".join(bad[:5]))


def train_launches(arch) -> dict:
    """Kernel launches in one train step of ``arch`` under per-unit remat,
    derived from the code.  Each kernel runs in the unit's forward pass
    and in its recompute in the backward pass; a mixer or MoE layer under
    its own inner checkpoint (WKV6, the scan, the MoE kernels) runs once
    more when the backward pass reaches it.  The unit's recompute stops
    after the last op that saved a tensor for the unit's backward pass
    (checkpoint's early stop): an inner checkpoint at the end of the unit
    (the last layer's MoE) is past it, and is not run there.  Backward
    passes run plain versions and launch nothing.  An encoder-decoder's
    encoder adds its layers' flash, twice each; cross-attention launches
    nothing (the chunked core is plain)."""
    per = {"flash_attention": 2 * arch.enc_layers} if arch.enc_layers else {}
    add = lambda k, n: per.__setitem__(k, per.get(k, 0) + n * arch.n_units)
    last = len(arch.pattern) - 1
    for j, spec in enumerate(arch.pattern):
        kernel = {"attn": "flash_attention", "mamba": "mamba_scan",
                  "rwkv": "wkv6"}[spec.mixer]
        add(kernel, 2 if spec.mixer == "attn" else 3)
        if spec.mixer != "rwkv" and spec.ffn == "moe":
            add("moe_scatter", 2 if j == last else 3)
            add("moe_gather", 2 if j == last else 3)
    return per


def routed_experts(torch, arch, calls) -> dict:
    """{pattern position j: (n_units, E) bool}, the experts that received
    a token in each unit's MoE layer j, from the routing calls of one
    forward pass (``record_routing``'s log; unit by unit, layer by layer)."""
    moe = [j for j, spec in enumerate(arch.pattern)
           if spec.mixer != "rwkv" and spec.ffn == "moe"]
    used = {j: torch.zeros(arch.n_units, arch.n_experts, dtype=torch.bool)
            for j in moe}
    for i, (idx, _) in enumerate(calls[:arch.n_units * len(moe)]):
        u, j = divmod(i, len(moe))
        used[moe[j]][u] = torch.bincount(idx.flatten(),
                                         minlength=arch.n_experts) > 0
    return used


def dead_leaves(torch, tree, used=None) -> list[str]:
    """Paths whose entries (first AdamW moments) are not all finite, or
    are all zero.  An expert weight is checked expert by expert: each
    unit's expert must have a nonzero moment exactly where ``used`` (see
    :func:`routed_experts`) says it received a token (every expert
    without ``used``)."""
    from repro_torch.models import lm
    dead = []
    for path, t in lm.tree_leaves(tree):
        live = bool(t.abs().amax() > 0)
        if "moe" in path and path[-1] in ("wi", "wg", "wo"):
            got = (t.flatten(2).abs().amax(-1) > 0).cpu()
            want = (used[int(path[1][1:])] if used is not None
                    else torch.ones_like(got))
            live = bool((got == want).all())
        if not (bool(torch.isfinite(t).all()) and live):
            dead.append("/".join(path))
    return dead


def olmoe_train_arch():
    """olmoe-1b-7b at its published width (64 experts top 8, d_ff 1024),
    cut in depth to ``OLMOE_TRAIN_DEPTH`` layers by ``reduced_arch``: at
    its 16 layers (6.9 B parameters, ~111 GB of f32 weights, gradients
    and AdamW moments) it does not train on one 80 GB card."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch.train import reduced_arch
    return dataclasses.replace(
        reduced_arch(configs.get("olmoe-1b-7b"), 0, OLMOE_TRAIN_DEPTH, 0),
        name=f"olmoe-1b-7b-d{OLMOE_TRAIN_DEPTH}")


def train_full(torch, device, arch, steps=4, batch=8, seq=256):
    """``arch`` in float32: ``steps`` AdamW steps at ``batch`` x ``seq``
    (an encoder-decoder's frames and tokens, or a VLM's frontend and text,
    together) through ``make_train_step``, launch counts reset just before
    and read just after, each kernel's held to :func:`train_launches`; then
    one more step under the profiler."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init
    params = init_model(torch, arch, device,
                        torch.Generator(device=device).manual_seed(SEED))
    opt = adamw_init(params)
    step = make_step(torch, arch, 100)
    batches = batches_for(torch, arch, batch, seq, steps + 1, device)
    n_params = sum(t.numel() for _, t in lm.tree_leaves(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, mets, dead, used = [], [], [], None
    log = {"calls": [], "rows": {}}
    ops.reset_launch_counts()
    for s in range(steps):
        # step 1's expert choices, to tell an expert that no token chose
        # from one whose gradient went missing
        restore = record_routing(log) if s == 0 else (lambda: None)
        t0 = time.perf_counter()
        try:
            params, opt, m = step(params, opt, batches[s])
            torch.cuda.synchronize()
        finally:
            restore()
        times.append(time.perf_counter() - t0)
        mets.append({k: float(v) for k, v in m.items()})
        if s == 0:      # the first moment is 0.1 x the clipped gradient
            if arch.n_experts:
                used = routed_experts(torch, arch, log["calls"])
            dead = dead_leaves(torch, opt["m"], used)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: n * steps for k, n in train_launches(arch).items()}
    wall, busy, top, _, _ = busy_share(
        torch, lambda: step(params, opt, batches[steps]))
    step_s = sum(times[1:]) / len(times[1:])
    tokens = batch * seq
    res = {"phase": f"train-{arch.name}", "params": n_params,
           "layers": arch.n_layers, "enc_layers": arch.enc_layers,
           "batch": {k: list(v.shape) for k, v in batches[0].items()},
           "steps": steps,
           "step_ms": [t * 1e3 for t in times],
           "step_ms_after_first": step_s * 1e3, "tok_s": tokens / step_s,
           "loss": [m["loss"] for m in mets],
           "nll": [m["nll"] for m in mets],
           "grad_norm": [m["grad_norm"] for m in mets],
           "max_memory_allocated_gb": peak / 1e9,
           "launches": counts, "launches_expected": want,
           "launches_per_step": {k: v / steps for k, v in counts.items()},
           "profiled_step_wall_s": wall, "profiled_step_device_busy_s": busy,
           "device_busy_share": busy / wall,
           "device_busy_share_unprofiled": busy / step_s,
           "top_kernels": top, "leaves_without_gradient": dead}
    if used is not None:
        res["experts_without_tokens_by_unit"] = {
            f"l{j}": (~u).sum(-1).tolist() for j, u in used.items()}
    emit(res)
    if not all(math.isfinite(x) for x in res["loss"] + res["grad_norm"]):
        fail(f"train-{arch.name}: non-finite loss or gradient norm")
    if dead:
        fail(f"train-{arch.name}: no finite nonzero gradient at step 1 "
             f"for {dead} (an expert: where a token chose it, or a "
             f"gradient where none did)")
    if any(counts[k] != n for k, n in want.items()):
        fail(f"train-{arch.name}: launches {counts} in {steps} steps "
             f"(want {want})")
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_remat(torch, device):
    """Full-width llama3.2-1b, 2 AdamW steps at batch 8 x 256 under each
    remat policy from the same weights ("nothing" again last, to tell what
    a policy costs from what a run's place in the process does): peak
    memory and step time of each, then one gradient pass alone for the
    memory the policy keeps.
    The policies decide what the backward pass keeps, never the result:
    the step-1 first moments (0.1 x the clipped gradient) and the metrics
    must agree with ``"nothing"``'s within the train tolerance.  The CUDA
    kernels are called outside the dispatcher, where no policy sees them,
    so flash is recomputed (launched twice a layer) under every policy."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import TrainConfig, make_train_step
    arch = configs.get("llama3.2-1b")
    batches = batches_for(torch, arch, 8, 256, 2, device)
    want = {k: 2 * n for k, n in train_launches(arch).items()}
    counts, base = {}, None
    for i, policy in enumerate(REMAT_POLICIES + ("nothing",)):
        params = lm.init_lm(arch, torch.float32,
                            generator=torch.Generator(device=device)
                            .manual_seed(SEED), device=device)
        opt = adamw_init(params)
        step = make_train_step(arch, None, TrainConfig(
            optimizer=AdamWConfig(total_steps=100, **TRAIN_OPT),
            remat_policy=policy, **TRAIN_CFG))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        times, mets = [], []
        for b in batches:
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            mets.append({k: float(v) for k, v in m.items()})
            if len(mets) == 1:      # on the host: outside the peak
                m1 = [t.cpu() for _, t in lm.tree_leaves(opt["m"])]
        tag = f"train-remat-{policy}" + ("-again" if i == len(
            REMAT_POLICIES) else "")
        counts[tag] = ops.launch_counts()
        res = {"phase": tag, "arch": arch.name, "batch": [8, 256],
               "step_ms": [t * 1e3 for t in times],
               "max_memory_allocated_gb":
                   torch.cuda.max_memory_allocated() / 1e9,
               "loss": [m["loss"] for m in mets], "launches": counts[tag]}
        # the step's peak is AdamW's; one gradient pass alone shows what
        # the policy keeps: memory allocated before it, at the end of its
        # forward pass (what is saved for the backward) and at its peak
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = sum(t.numel() * t.element_size() for tree in
                    (params, opt["m"], opt["v"]) for _, t in
                    lm.tree_leaves(tree))
        res["grad_pass_gb"] = {"before": torch.cuda.memory_allocated() / 1e9,
                               "train_state": state / 1e9}
        tree = lm.tree_map(lambda t: t.detach().requires_grad_(), params)
        # the loss alone: its metrics hold the graph, which holds the
        # parameters, past this run
        loss = lm.loss_fn(tree, batches[0], arch,
                          q_chunk=TRAIN_CFG["q_chunk"],
                          time_chunk=TRAIN_CFG["time_chunk"],
                          remat_policy=policy)[0]
        torch.cuda.synchronize()
        res["grad_pass_gb"]["after_forward"] = (torch.cuda.memory_allocated()
                                                / 1e9)
        grads = torch.autograd.grad(loss, [t for _, t in
                                           lm.tree_leaves(tree)])
        torch.cuda.synchronize()
        res["grad_pass_gb"]["peak"] = torch.cuda.max_memory_allocated() / 1e9
        del tree, loss, grads, params, opt
        if base is None:
            base = (m1, mets)
        else:
            worst = max(float((a - b).abs().max())
                        / max(float(b.abs().max()), 1e-30)
                        for a, b in zip(m1, base[0]))
            metric = max(abs(a[k] - b[k]) / (1 + abs(b[k]))
                         for a, b in zip(mets, base[1]) for k in b)
            res.update({"moment_rel_err_vs_nothing": worst,
                        "metric_rel_err_vs_nothing": metric})
            if not (worst <= TRAIN_REF_TOL["moment"]
                    and metric <= TRAIN_REF_TOL["metric"]):
                fail(f"{tag}: gradients differ from 'nothing' (moment "
                     f"{worst}, metric {metric})")
        del m1
        emit(res)
        if any(counts[tag][k] != n for k, n in want.items()):
            fail(f"{tag}: launches {counts[tag]} (want {want})")
        gc.collect()
        torch.cuda.empty_cache()
    return counts


def phase_train(torch, device):
    """The full-width train runs (:func:`train_full`): llama3.2-1b,
    rwkv6-1.6b and seamless-m4t-v2 whole at batch 8 x 256 (seamless: 128
    frames + 128 tokens), olmoe-1b-7b cut to ``OLMOE_TRAIN_DEPTH`` layers,
    internvl2-76b cut to 1 layer at batch 4 x 512 (256 frontend
    embeddings + 256 text tokens; 2.96 B parameters, ~47 GB of float32
    train state); then the train command on each arch at its published
    width, 1-2 layers; then the remat policies."""
    from repro_torch import configs
    counts = {}
    for arch, kw in ((configs.get("llama3.2-1b"), {}),
                     (configs.get("rwkv6-1.6b"), {}),
                     (olmoe_train_arch(), {}),
                     (configs.get("seamless-m4t-large-v2"), {}),
                     (internvl2_one_card(1),
                      dict(steps=2, batch=4, seq=512))):
        counts[f"train-{arch.name}"] = train_full(torch, device, arch, **kw)
    from repro_torch.launch import train
    for name, width, depth, seq in (
            ("llama3.2-1b", "2048", "2", "64"),
            ("rwkv6-1.6b", "2048", "2", "64"),
            ("olmoe-1b-7b", "0", "2", "64"),
            ("seamless-m4t-large-v2", "0", "2", "64"),
            ("internvl2-76b", "0", "1", "320")):
        t0 = time.perf_counter()
        # the published width (head dims the kernels take; olmoe's 64
        # experts of d_ff 1024) at depth 1-2; a VLM's sequence holds its
        # 256 frontend embeddings
        hist = train.main(["--arch", name, "--width", width, "--depth",
                           depth, "--vocab", "512", "--steps", "3",
                           "--batch", "4", "--seq", seq, "--ckpt-every",
                           "0", "--log-every", "1"])
        ok = (len(hist) == 3
              and all(math.isfinite(h["loss"]) for h in hist))
        emit({"phase": f"train-cli-{name}", "seconds":
              time.perf_counter() - t0, "loss": [h["loss"] for h in hist]})
        if not ok:
            fail(f"train-cli-{name}: {hist}")
    counts.update(phase_remat(torch, device))
    return counts


# --------------------------------------------------------------------------- #
# the plan search, and the train and serve commands under plans
# --------------------------------------------------------------------------- #
# the searched archs, the modelled H100 meshes (nodes, data, model) and the
# phases' shapes: train 8 x 256 (the train runs'), prefill one 512-token
# prompt, decode 8 slots over a 1024-token cache (the serve engine's)
PLAN_ARCHS = ("llama3.2-1b", "olmoe-1b-7b")
PLAN_MESHES = ((1, 8, 1), (1, 2, 4), (2, 2, 4))
PLAN_SHAPES = {"train": {"seq_len": 256, "batch": 8},
               "prefill": {"seq_len": 512, "batch": 1},
               "decode": {"seq_len": 1024, "batch": 8}}
# the serve runs of the plan phase: published llama3.2-1b, 4 slots, paged
# pool and chunked prefill (the command's defaults)
PLAN_SERVE = ["--arch", "llama3.2-1b", "--width", "0", "--depth", "0",
              "--vocab", "0", "--batch", "4", "--requests", "6",
              "--prompt-len", "96", "--gen", "8"]
PLAN_TRAIN = ["--arch", "llama3.2-1b", "--steps", "2", "--ckpt-every", "0",
              "--log-every", "1"]
# the staged train plan: llama3.2-1b on the 2 x 4 node, searched with two
# pipeline stages and four microbatches
STAGED_S, STAGED_M = 2, 4
# the plan phase's train runs ({"plain": (history, step seconds, stdout),
# "plan": ...}) and its node plan, which the staged phase compares with
PLAN_RUNS: dict = {}


def plan_search(arch_name: str, mesh_args) -> dict:
    """Each phase of ``arch_name`` searched on ``h100_mesh_spec(*mesh_args)``
    with the memory budget (the plan a user saves) and without (the
    paper's optimality, which the gate reads), beside the three baselines'
    costs.  A baseline is compared only where its configs lie in the
    search space: one that splits a dimension that does not divide (batch
    1 over the pod axis) is priced by the cost model but realizable by no
    plan, and is reported as such."""
    from repro_torch import configs
    from repro_torch.core import (BASELINES, CostModel, SearchOptions,
                                  config_space, find_strategy,
                                  h100_mesh_spec)
    from repro_torch.models.graph_export import export_graph, phase_shape
    arch = configs.get(arch_name)
    mesh = h100_mesh_spec(*mesh_args)
    free = SearchOptions(hbm_budget=None)
    out = {"phase": f"plan-search-{arch_name}-"
                    f"{'x'.join(map(str, mesh_args))}",
           "mesh": [(a.name, a.size, a.bw) for a in mesh.axes],
           "chip": mesh.chip.name, "phases": {}}
    for phase, shape in PLAN_SHAPES.items():
        g = export_graph(arch, phase_shape(phase, **shape))
        t0 = time.perf_counter()
        s = find_strategy(g, mesh, phase=phase)
        search_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sf = find_strategy(g, mesh, phase=phase, options=free)
        free_s = time.perf_counter() - t0
        space = config_space(g, mesh, free)
        cm = CostModel(mesh, phase=phase)
        base, over = {}, []
        for b, fn in BASELINES.items():
            strat = fn(g, mesh)
            realizable = all(strat[n] in space[n] for n in g.nodes)
            base[b] = {"cost_s": cm.total_time(g, strat),
                       "realizable": realizable}
            if realizable and sf.cost > base[b]["cost_s"] * (1 + 1e-9):
                over.append(b)
        out["phases"][phase] = {
            "nodes": g.num_nodes, "cost_s": s.cost, "search_s": search_s,
            "device_bytes": s.meta["device_bytes"],
            "budget_bytes": SearchOptions().budget_for(mesh),
            "capacity_iters": s.meta["capacity_iters"],
            "cost_budget_free_s": sf.cost, "search_budget_free_s": free_s,
            "baselines": base, "costlier_than": over}
        if over:
            fail(f"{out['phase']} {phase}: searched {sf.cost} above the "
                 f"baselines {over}: {base}")
    return out


def _timed_train(torch, argv):
    """The train command's ``main(argv)`` with its stdout captured (and
    echoed) and the launch counts reset just before and read just after;
    returns (history, each logged step's seconds from its ``step_ms``,
    stdout, counts)."""
    import io
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    buf = io.StringIO()
    ops.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        hist = train.main(argv)
    counts = ops.launch_counts()
    print(buf.getvalue(), end="", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return hist, [h["step_ms"] / 1e3 for h in hist], buf.getvalue(), counts


def _serve(torch, argv):
    import io
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    buf = io.StringIO()
    ops.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        out = serve.main(argv)
    counts = ops.launch_counts()
    print(buf.getvalue(), end="", flush=True)
    toks = {c.uid: list(c.tokens) for c in out["completions"]}
    res = {"plan": out["plan"].strategy_name, "tok_s": out["tok_s"],
           "wall_s": out["wall_s"], "launches": counts}
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return res, toks, buf.getvalue()


def phase_plan(torch, device):
    """The paper's search on the host: llama3.2-1b and olmoe-1b-7b at their
    published sizes, the train / prefill / decode phases on three modelled
    H100 meshes (one node of 8 on data, one of 2 x 4, two such nodes over
    InfiniBand), searched costs beside the baselines'; the cost model's
    price of llama's uniform train step on one H100.  Then the llama node
    plan (2 x 4) saved and loaded (its chip must come back as the H100's),
    the train command at the published size for 2 steps without a plan
    and with ``--plan`` on that file (the mesh mismatch logged, the losses
    equal), and the serve command plain, ``--strategy searched
    --save-plan``, ``--plan`` on that file and ``--plan`` on the node plan
    (the tokens equal)."""
    from repro_torch import configs
    from repro_torch.core import (CostModel, H100_SXM, LayerConfig,
                                  h100_mesh_spec, uniform_strategy)
    from repro_torch.models.graph_export import export_graph, phase_shape
    from repro_torch.plans import ParallelPlan, build_parallel_plan
    counts = {}
    for name in PLAN_ARCHS:
        for m in PLAN_MESHES:
            emit(plan_search(name, m))
    arch = configs.get("llama3.2-1b")
    node = h100_mesh_spec(1, 2, 4)
    t0 = time.perf_counter()
    plan = build_parallel_plan(
        arch, node, train_seq=PLAN_SHAPES["train"]["seq_len"],
        train_batch=PLAN_SHAPES["train"]["batch"],
        prompt_len=PLAN_SHAPES["prefill"]["seq_len"],
        max_batch=PLAN_SHAPES["decode"]["batch"],
        max_len=PLAN_SHAPES["decode"]["seq_len"])
    build_s = time.perf_counter() - t0
    path = plan.save(OUT / "plan-llama3.2-1b-h100-2x4.json")
    back = ParallelPlan.load(path, arch=arch)
    chip_ok = (back.mesh == node and back.mesh.chip == H100_SXM)
    emit({"phase": "plan-save-load", "path": str(path.relative_to(ROOT)),
          "build_s": build_s, "chip": back.mesh.chip.name,
          "chip_efficiencies": [back.mesh.chip.mxu_efficiency,
                                back.mesh.chip.hbm_efficiency],
          "chip_ok": chip_ok,
          "train_segments": len(back.plan_for("train").segments),
          "costs_s": {ph: m["cost_s"] for ph, m in
                      back.meta["phases"].items()}})
    if not chip_ok:
        fail(f"plan-save-load: the plan came back on {back.mesh}")

    # the train command without a plan, then under the loaded node plan
    runs = {}
    for tag, extra in (("plain", []), ("plan", ["--plan", str(path)])):
        hist, times, out, c = _timed_train(torch, PLAN_TRAIN + extra)
        runs[tag] = (hist, times, out)
        counts[f"plan-train-{tag}"] = c
        want = {k: 2 * n for k, n in train_launches(arch).items()}
        if any(c.get(k) != n for k, n in want.items()):
            fail(f"plan-train-{tag}: launches {c} (want {want})")
    PLAN_RUNS.update(runs, node=back)
    (h0, t_plain, _), (h1, t_plan, out1) = runs["plain"], runs["plan"]
    l0, l1 = [h["loss"] for h in h0], [h["loss"] for h in h1]
    bitwise = l0 == l1
    close = len(l0) == len(l1) == 2 and all(
        abs(a - b) <= TRAIN_REF_TOL["metric"] * (1 + abs(b))
        for a, b in zip(l1, l0))
    note = "plan searched for mesh" in out1
    # the cost model's price of the same step on one H100
    g = export_graph(arch, phase_shape("train", **PLAN_SHAPES["train"]))
    one = h100_mesh_spec(1, 1, 1)
    price = CostModel(one, phase="train").total_time(
        g, uniform_strategy(g, lambda n: LayerConfig.make(batch=("data",))))
    flops = sum(n.flops for n in g.nodes.values())
    emit({"phase": "plan-train", "loss_plain": l0, "loss_plan": l1,
          "losses_bitwise_equal": bitwise, "losses_within_tol": close,
          "tol": TRAIN_REF_TOL["metric"], "mesh_mismatch_logged": note,
          "step_ms_plain": [t * 1e3 for t in t_plain],
          "step_ms_plan": [t * 1e3 for t in t_plan],
          "launches": dict(counts)})
    print(f"cost model: llama3.2-1b uniform train step (8 x 256) on one "
          f"H100 (spec sheet, bf16 peak x {one.chip.mxu_efficiency}) "
          f"{price * 1e3:.3f} ms ({flops / 1e12:.2f} TFLOP); measured f32 "
          f"step of the same run {t_plan[-1] * 1e3:.1f} ms", flush=True)
    emit({"phase": "plan-price", "graph_flops": flops,
          "cost_model_ms": price * 1e3,
          "measured_step_ms": t_plan[-1] * 1e3,
          "measured_over_model": t_plan[-1] / price})
    if not close:
        fail(f"plan-train: losses {l1} under the plan, {l0} without")
    if not note:
        fail("plan-train: the mesh mismatch of the loaded plan was not "
             "logged")

    # the serve command: plain, searched + saved, loaded, the node plan
    saved = OUT / "plan-serve-llama3.2-1b.json"
    toks, serve = {}, {}
    for tag, extra in (("plain", []),
                       ("searched", ["--strategy", "searched",
                                     "--save-plan", str(saved)]),
                       ("saved", ["--plan", str(saved)]),
                       ("node", ["--plan", str(path)])):
        res, toks[tag], out = _serve(torch, PLAN_SERVE + extra)
        serve[tag] = res
        counts[f"plan-serve-{tag}"] = res["launches"]
        if res["launches"].get("paged_decode_attention", 0) <= 0:
            fail(f"plan-serve-{tag}: the paged decode was not launched")
        if tag == "node" and "plan searched for mesh" not in out:
            fail("plan-serve-node: the mesh mismatch was not logged")
    equal = all(toks[t] == toks["plain"] for t in toks)
    emit({"phase": "plan-serve", "runs": serve, "tokens_equal": equal,
          "requests": len(toks["plain"]),
          "tokens": sum(len(t) for t in toks["plain"].values())})
    if not equal:
        fail(f"plan-serve: tokens differ between runs: {toks}")
    return counts


def phase_plan_staged(torch, device):
    """The pipeline-staged train step at llama3.2-1b's published
    size: its train plan searched on the 2 x 4 node mesh with
    ``STAGED_S`` stages and ``STAGED_M`` microbatches at the plan phase's
    train shape, saved, and the train command run with ``--plan`` on it
    for the plan phase's 2 steps.  One card has no mesh, so the plan
    places nothing and the staged step runs on plain tensors: each
    microbatch runs every unit, so every kernel launches ``STAGED_M``
    times the unstaged step's count a step, and the losses are the
    unstaged run's (``plan-train-plain``) up to float reassociation.  The
    plan's price is for the 8-card mesh: context, not a check.  Then one
    unstaged and one staged step under the profiler (``busy_share``):
    device time, busy share and top kernels of each."""
    from repro_torch import configs
    from repro_torch.core import h100_mesh_spec
    from repro_torch.plans import build_parallel_plan
    arch = configs.get("llama3.2-1b")
    t0 = time.perf_counter()
    plan = build_parallel_plan(
        arch, h100_mesh_spec(1, 2, 4), phases=("train",),
        strategy="searched", train_seq=PLAN_SHAPES["train"]["seq_len"],
        train_batch=PLAN_SHAPES["train"]["batch"], train_stages=STAGED_S,
        train_microbatches=STAGED_M)
    search_s = time.perf_counter() - t0
    stages = plan.stage_for("train")
    path = plan.save(OUT / "plan-llama3.2-1b-h100-2x4-staged.json")
    if "plain" not in PLAN_RUNS:          # the plan phase failed early
        hist, times, out, _ = _timed_train(torch, PLAN_TRAIN)
        PLAN_RUNS["plain"] = (hist, times, out)
    h0, t_plain, _ = PLAN_RUNS["plain"]
    torch.cuda.reset_peak_memory_stats()
    hist, times, out, c = _timed_train(torch, PLAN_TRAIN + ["--plan",
                                                            str(path)])
    peak = hist[-1]["max_memory_allocated_gb"][0] * 1e9
    want = {k: 2 * STAGED_M * n for k, n in train_launches(arch).items()}
    l0, l1 = [h["loss"] for h in h0], [h["loss"] for h in hist]
    close = len(l0) == len(l1) == 2 and all(
        abs(a - b) <= TRAIN_REF_TOL["metric"] * (1 + abs(b))
        for a, b in zip(l1, l0))
    logged = (f"train: pipeline S={STAGED_S} M={STAGED_M} "
              f"boundaries={stages.boundaries}") in out
    meta = plan.meta["phases"]["train"]
    node = PLAN_RUNS.get("node")
    emit({"phase": "plan-train-staged", "arch": arch.name,
          "boundaries": list(stages.boundaries),
          "microbatches": stages.microbatches, "search_s": search_s,
          "loss_plain": l0, "loss_staged": l1, "losses_within_tol": close,
          "tol": TRAIN_REF_TOL["metric"], "pipeline_logged": logged,
          "step_ms_plain": [t * 1e3 for t in t_plain],
          "step_ms_staged": [t * 1e3 for t in times],
          "max_memory_allocated_gb": peak / 1e9,
          "launches": c, "launches_want": want,
          "pipeline_bubble_frac": meta["pipeline_bubble_frac"],
          "priced_cost_ms": meta["cost_s"] * 1e3,
          "priced_stage_costs_ms": [x * 1e3 for x in meta["stage_costs_s"]],
          "priced_unstaged_cost_ms": (
              node.meta["phases"]["train"]["cost_s"] * 1e3
              if node is not None else None)})
    if stages.num_stages != STAGED_S or stages.microbatches != STAGED_M:
        fail(f"plan-train-staged: the search gave {stages.describe()}")
    if any(c.get(k) != n for k, n in want.items()):
        fail(f"plan-train-staged: launches {c} (want {want})")
    if not close:
        fail(f"plan-train-staged: losses {l1} staged, {l0} unstaged")
    if not logged:
        fail("plan-train-staged: the pipeline line was not logged")

    # one step each way under the profiler, from the same weights and
    # batch: the device's busy share and where the staged step's time goes
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import TrainConfig, make_train_step
    params = init_model(torch, arch, device,
                        torch.Generator(device=device).manual_seed(SEED))
    batch = batches_for(torch, arch, PLAN_SHAPES["train"]["batch"],
                        PLAN_SHAPES["train"]["seq_len"], 1, device)[0]
    prof = {}
    for tag, p in (("plain", None), ("staged", plan)):
        step = make_train_step(arch, p, TrainConfig(
            optimizer=AdamWConfig(**TRAIN_OPT), **TRAIN_CFG))
        opt = adamw_init(params)
        step(params, opt, batch)                      # warm
        wall, busy, top, _, _ = busy_share(
            torch, lambda: step(params, opt, batch))
        prof[tag] = {"wall_ms": wall * 1e3, "device_busy_ms": busy * 1e3,
                     "device_busy_share": busy / wall, "top_kernels": top}
        del opt
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "plan-train-staged-profile", "arch": arch.name,
          **prof})
    del params
    return {"plan-train-staged": c}


# the profile phase: the small llama of the reference phase (hd 64), the
# serve command's runs that fill and then read one autotune cache, the
# kernels each op of the profiler's sweep launches, and the GEMM ladder
# timed beside the profile's
PROFILE_SERVE = ["--arch", "llama3.2-1b", "--batch", "4", "--requests", "4",
                 "--prompt-len", "64", "--gen", "8"]
GEMM_LARGE = (2048, 4096, 8192)
PROFILE_KERNELS = {"flash_attention": ("flash_attention",),
                   "decode_attention": ("decode_attention",),
                   "mamba_scan": ("mamba_scan",), "wkv6": ("wkv6",),
                   "moe_dispatch_combine": ("moe_scatter", "moe_gather")}


def _phase_record(name: str) -> dict | None:
    return next((p for p in record["phases"] if p.get("phase") == name),
                None)


def phase_profile(torch, device):
    """The device profile and the dispatcher on the card.

    1. ``launch.profile --smoke`` (the reference's ladders): every ``cuda``
       entry of the sweep must launch its kernel, and the JSON must load
       back equal.  Then the command at its default ladders (matmuls to
       2048, streams from 64 MiB, past the L2), the profile that
       calibrates; beside it the float32 and bfloat16 GEMM rates over
       ``GEMM_LARGE``.
    2. llama3.2-1b's train step (8 x 256, f32) priced on one H100 by the
       cost model calibrated with that profile, beside the analytic price
       and the step the plan phase measured; its train plan searched on
       the plan phase's 2 x 4 node mesh under the profile (the plan's
       meta must carry the fingerprint).
    3. The reference phase's small llama (d 256, hd 64) in mode (a) with
       ``ServeConfig(kernel_backend="ref")`` and then by default: the
       tokens equal, no launch under ``ref``, and the default run's
       launches those of the reference phase's run of the same requests.
    4. The serve command twice into one ``--autotune-cache-dir``, the
       in-process cache dropped before each (a restart): the first tunes,
       the second re-tunes nothing."""
    import dataclasses
    import shutil
    from repro_torch import configs
    from repro_torch.core import (CostModel, LayerConfig, h100_mesh_spec,
                                  uniform_strategy)
    from repro_torch.kernels import dispatch, ops
    from repro_torch.launch import profile as profile_cmd
    from repro_torch.models import lm
    from repro_torch.models.graph_export import export_graph, phase_shape
    from repro_torch.plans import build_parallel_plan
    from repro_torch.profiling import DeviceProfile
    from repro_torch.profiling.microbench import measure_matmul_flops
    counts = {}

    # 1. the sweep through the dispatcher, at the smoke ladders
    smoke_path = OUT / "profile-smoke.json"
    ops.reset_launch_counts()
    smoke = profile_cmd.main(["--smoke", "--out", str(smoke_path)])
    launched = ops.launch_counts()
    round_trip = DeviceProfile.load(smoke_path) == smoke
    missing = [op for op, names in PROFILE_KERNELS.items()
               if (op, "cuda", "small") not in smoke.kernel_times
               or any(launched.get(n, 0) <= 0 for n in names)]
    full_path = OUT / "profile-h100.json"
    full = profile_cmd.main(["--out", str(full_path), "--skip-collectives"])
    # past the default ladder: whether 2048 reached the f32 rate, and the
    # bf16 rate, whose 2048 rung (17 us on the tensor cores) the host's
    # launch would bound
    f32_large = measure_matmul_flops(GEMM_LARGE, device=device)
    bf16 = measure_matmul_flops(GEMM_LARGE, dtype=torch.bfloat16,
                                device=device)
    card = card_line()
    print(f"profile: {card}: GEMM float32 {full.measured_flops / 1e12:.2f} "
          f"TFLOP/s (smoke ladder {smoke.measured_flops / 1e12:.2f}, to "
          f"{GEMM_LARGE[-1]} {f32_large / 1e12:.2f}), "
          f"bfloat16 {bf16 / 1e12:.2f} TFLOP/s, HBM "
          f"{full.measured_hbm_bw / 1e12:.3f} TB/s (smoke ladder "
          f"{smoke.measured_hbm_bw / 1e12:.3f})", flush=True)
    emit({"phase": "profile", "card": card,
          "gemm_f32_flops": full.measured_flops,
          "gemm_f32_flops_large": f32_large, "gemm_bf16_flops": bf16,
          "gemm_large_sizes": list(GEMM_LARGE),
          "hbm_bytes_s": full.measured_hbm_bw,
          "smoke_gemm_f32_flops": smoke.measured_flops,
          "smoke_hbm_bytes_s": smoke.measured_hbm_bw,
          "matmul_sizes": full.meta["matmul_sizes"],
          "stream_bytes": full.meta["stream_bytes"],
          "allow_tf32": full.meta["allow_tf32"],
          "kernel_ms": {"/".join(k): t * 1e3
                        for k, t in sorted(full.kernel_times.items())},
          "kernel_factors": {"/".join(k): f for k, f in
                             sorted(full.kernel_factors().items())},
          "smoke_kernel_ms": {"/".join(k): t * 1e3 for k, t in
                              sorted(smoke.kernel_times.items())},
          "smoke_launches": launched, "round_trip": round_trip,
          "fingerprint": full.fingerprint()})
    if missing:
        fail(f"profile: the sweep did not launch the kernels of {missing} "
             f"({launched})")
    if not round_trip:
        fail("profile: the smoke profile did not load back equal")

    # 2. the calibrated price of llama3.2-1b's f32 train step
    arch = configs.get("llama3.2-1b")
    g = export_graph(arch, phase_shape("train", **PLAN_SHAPES["train"]))
    one = h100_mesh_spec(1, 1, 1)
    uni = uniform_strategy(g, lambda n: LayerConfig.make(batch=("data",)))
    analytic = CostModel(one, phase="train").total_time(g, uni)
    priced = CostModel.from_profile(full, one, phase="train").total_time(
        g, uni)
    measured = (_phase_record("plan-price") or {}).get("measured_step_ms")
    plan = build_parallel_plan(
        arch, h100_mesh_spec(1, 2, 4), phases=("train",),
        train_seq=PLAN_SHAPES["train"]["seq_len"],
        train_batch=PLAN_SHAPES["train"]["batch"], profile=full)
    node_cost = plan.meta["phases"]["train"]["cost_s"]
    print(f"cost model: llama3.2-1b uniform train step (8 x 256) on one "
          f"H100 {priced * 1e3:.3f} ms calibrated by the profile (analytic "
          f"{analytic * 1e3:.3f} ms); measured f32 step "
          f"{measured if measured is None else round(measured, 1)} ms"
          + ("" if measured is None else
             f", measured / calibrated {measured / (priced * 1e3):.3f}"),
          flush=True)
    emit({"phase": "profile-price", "calibrated_ms": priced * 1e3,
          "analytic_ms": analytic * 1e3, "measured_step_ms": measured,
          "measured_over_calibrated": (None if measured is None
                                       else measured / (priced * 1e3)),
          "measured_over_analytic": (None if measured is None
                                     else measured / (analytic * 1e3)),
          "node_plan_cost_ms": node_cost * 1e3,
          "node_plan_fingerprint_ok": plan.meta.get("device_profile")
          == full.fingerprint()})
    if plan.meta.get("device_profile") != full.fingerprint():
        fail("profile-price: the searched plan does not carry the profile")
    if measured is None:
        fail("profile-price: the plan phase measured no train step")

    # 3. the small llama served under the plain backend, then by default
    small = dataclasses.replace(configs.get("llama3.2-1b"), n_layers=2,
                                d_model=256, n_heads=4, n_kv_heads=2,
                                d_ff=512, vocab=512, head_dim=64)
    params = lm.init_lm(small, torch.float32,
                        generator=torch.Generator().manual_seed(SEED),
                        device="cpu")
    params = lm.tree_map(lambda t: t.to(device), params)
    reqs = make_requests(small.vocab, n=6, gen=8)
    modes = {"ref": {"kernel_backend": "ref"}, "a": {}}
    runs = {}
    for mode in modes:
        res, eng, toks = serve_once(torch, params, small, reqs, mode=mode,
                                    dtype=torch.float32, device=device,
                                    max_batch=4, max_len=1024, modes=modes)
        runs[mode] = (res, toks)
        del eng
    usual = (_phase_record("reference-a") or {}).get("launches_card")
    (r_ref, t_ref), (r_def, t_def) = runs["ref"], runs["a"]
    counts["profile-serve-default"] = r_def["launches"]
    emit({"phase": "profile-serve", "tokens_equal": t_ref == t_def,
          "tokens": sum(len(t) for t in t_def.values()),
          "launches_ref": r_ref["launches"],
          "launches_default": r_def["launches"],
          "launches_reference_phase": usual,
          "tok_s_ref": r_ref["tok_s"], "tok_s_default": r_def["tok_s"]})
    if t_ref != t_def:
        fail(f"profile-serve: tokens differ under ref: {t_ref} vs {t_def}")
    if any(r_ref["launches"].values()):
        fail(f"profile-serve: kernels launched under ref: "
             f"{r_ref['launches']}")
    if r_def["launches"].get("paged_decode_attention", 0) <= 0 or (
            usual is not None and r_def["launches"] != usual):
        fail(f"profile-serve: default launches {r_def['launches']}, the "
             f"reference phase's {usual}")
    del params

    # 4. one autotune cache across a restart
    tune_dir = OUT / "autotune-smoke"
    shutil.rmtree(tune_dir, ignore_errors=True)
    tune = []
    for _ in range(2):
        dispatch.clear_autotune_cache()
        res, toks, _ = _serve(torch, PROFILE_SERVE + [
            "--autotune-cache-dir", str(tune_dir)])
        tune.append((dispatch.autotune_cache_stats(), toks, res))
    dispatch.clear_autotune_cache()
    files = sorted(tune_dir.glob("*.json"))
    entries = json.loads(files[0].read_text()) if files else {}
    (s1, k1, r1), (s2, k2, r2) = tune
    counts["profile-autotune-1"] = r1["launches"]
    counts["profile-autotune-2"] = r2["launches"]
    emit({"phase": "profile-autotune", "first": s1, "second": s2,
          "files": [f.name for f in files], "entries": entries,
          "tokens_equal": k1 == k2,
          "launches_equal": r1["launches"] == r2["launches"]})
    if not (s1.get("tuned", 0) > 0 and s1.get("disk_writes", 0) > 0):
        fail(f"profile-autotune: the first run tuned nothing: {s1}")
    if s2.get("tuned", 0) != 0 or s2.get("disk_hits", 0) <= 0:
        fail(f"profile-autotune: the second run re-tuned: {s2}")
    if k1 != k2 or r1["launches"] != r2["launches"]:
        fail("profile-autotune: the two runs differ")
    return counts


# the realize phase: the small models' train runs (batch x seq, steps), the
# published llama3.2-1b's, and the relative difference a realized loss may
# show (a one-device mesh redistributes nothing, so equal is expected)
REALIZE_SMALL_TRAIN = (4, 128, 2)
REALIZE_FULL_TRAIN = (8, 256, 2)
REALIZE_TOL = 1e-6
REALIZE_SERVE_MODES = ("a", "c", "dense")


def _realize_train(torch, arch, plan, mesh, batch, seq, steps, device):
    """``steps`` AdamW steps from the seeded weights, unrealized (``mesh``
    None) or realized on ``mesh`` (params by ``param_pspecs``, ZeRO-1
    moments, each batch by ``batch_pspecs``): losses, step times, peak
    memory and the launch counts of the steps alone."""
    from repro_torch.core import use_mesh
    from repro_torch.kernels import ops
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import TrainConfig, make_train_step, realize
    params = init_model(torch, arch, device,
                        torch.Generator(device=device).manual_seed(SEED))
    batches = batches_for(torch, arch, batch, seq, steps, device)
    if mesh is None:
        opt = adamw_init(params)
    else:
        params, opt, place = realize(params, arch, plan, mesh)
        batches = [place(b) for b in batches]
    step = make_train_step(arch, plan, TrainConfig(
        optimizer=AdamWConfig(total_steps=steps, **TRAIN_OPT), **TRAIN_CFG))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, times = [], []
    for b in batches:
        t0 = time.perf_counter()
        with use_mesh(mesh):
            params, opt, met = step(params, opt, b)
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    del params, opt, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss": losses, "step_ms": [t * 1e3 for t in times],
            "peak_gib": peak / 2**30,
            "launches": {k: v for k, v in counts.items() if v}}


def _realize_check(tag, plain, real, what):
    """Equal (or within REALIZE_TOL relative) ``what`` and equal launch
    counts, or a failure naming the difference."""
    a, b = plain[what], real[what]
    if isinstance(a, list) and a and isinstance(a[0], float):
        bitwise = a == b
        close = len(a) == len(b) and all(
            abs(x - y) <= REALIZE_TOL * max(1.0, abs(x)) for x, y in zip(a, b))
    else:
        bitwise = close = a == b
    if not close:
        fail(f"realize-{tag}: {what} {b} realized, {a} unrealized")
    if plain["launches"] != real["launches"]:
        fail(f"realize-{tag}: launches {real['launches']} realized, "
             f"{plain['launches']} unrealized")
    return bitwise


def phase_realize(torch, device):
    """A searched plan realized on a one-device mesh against the same runs
    unrealized (see the module docstring, phase 7)."""
    import dataclasses
    import torch.distributed as dist
    # the experimental API the realized model runs under must exist here
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import configs
    from repro_torch.core import h100_mesh_spec, use_mesh
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.plans import (ParallelPlan, baseline_phase_plan,
                                   build_parallel_plan)
    store = ROOT / "build" / "realize-store"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    node = h100_mesh_spec(1, 2, 4)
    try:
        mesh = make_smoke_mesh(1, 1, "cuda")
        emit({"phase": "realize-mesh", "torch": torch.__version__,
              "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
              "implicit_replication": implicit_replication.__module__})
        small = {"llama": dataclasses.replace(
                     configs.get("llama3.2-1b"), n_layers=2, d_model=256,
                     n_heads=4, n_kv_heads=2, d_ff=512, vocab=512,
                     head_dim=64),
                 "rwkv6": dataclasses.replace(
                     configs.get("rwkv6-1.6b"), n_layers=2, d_model=256,
                     n_heads=4, n_kv_heads=4, d_ff=512, vocab=512),
                 "olmoe": small_moe_arch("olmoe"),
                 "jamba": small_moe_arch("jamba")}
        B, S, steps = REALIZE_SMALL_TRAIN
        for tag, arch in small.items():
            plan, _ = baseline_phase_plan(arch, node, "train", "model",
                                          seq_len=S, batch=B)
            plain = _realize_train(torch, arch, plan, None, B, S, steps,
                                   device)
            real = _realize_train(torch, arch, plan, mesh, B, S, steps,
                                  device)
            bitwise = _realize_check(f"train-{tag}", plain, real, "loss")
            emit({"phase": f"realize-train-{tag}", "plan": "model",
                  "batch": B, "seq": S, "unrealized": plain,
                  "realized": real, "losses_bitwise_equal": bitwise})

        # the small llama engine under a searched serve plan
        arch = small["llama"]
        plan = build_parallel_plan(arch, node, phases=("prefill", "decode"),
                                   prompt_len=512, max_batch=4,
                                   max_len=1024)
        params = init_model(torch, arch, device,
                            torch.Generator(device=device).manual_seed(SEED))
        reqs = make_requests(arch.vocab, n=6, gen=8)
        for mode in REALIZE_SERVE_MODES:
            runs = {}
            for tag, ctx in (("unrealized", contextlib.nullcontext()),
                             ("realized", use_mesh(mesh))):
                with ctx:
                    res, eng, toks = serve_once(
                        torch, params, arch, reqs, mode=mode,
                        dtype=torch.float32, device=device, max_batch=4,
                        max_len=1024, plan=plan)
                runs[tag] = {"tokens": toks, "launches": res["launches"],
                             **{k: res[k] for k in ("wall_s", "tok_s",
                                                    "itl_p50_ms",
                                                    "itl_p99_ms")}}
                del eng
                gc.collect()
            _realize_check(f"serve-{mode}", runs["unrealized"],
                           runs["realized"], "tokens")
            emit({"phase": f"realize-serve-{mode}", "plan": "searched",
                  "tokens_equal": runs["unrealized"]["tokens"]
                  == runs["realized"]["tokens"],
                  **{t: {k: v for k, v in r.items() if k != "tokens"}
                     for t, r in runs.items()}})
        del params
        gc.collect()
        torch.cuda.empty_cache()

        # llama3.2-1b at its published size under the node plan
        arch = configs.get("llama3.2-1b")
        saved = ParallelPlan.load(OUT / "plan-llama3.2-1b-h100-2x4.json",
                                  arch=arch)
        B, S, steps = REALIZE_FULL_TRAIN
        plan = saved.plan_for("train")
        plain = _realize_train(torch, arch, plan, None, B, S, steps, device)
        real = _realize_train(torch, arch, plan, mesh, B, S, steps, device)
        bitwise = _realize_check("train-llama3.2-1b", plain, real, "loss")
        emit({"phase": "realize-train-llama3.2-1b", "plan": "node 2x4",
              "batch": B, "seq": S, "unrealized": plain, "realized": real,
              "losses_bitwise_equal": bitwise,
              "step_overhead_ms": real["step_ms"][-1]
              - plain["step_ms"][-1]})
        params = init_model(torch, arch, device,
                            torch.Generator(device=device).manual_seed(SEED))
        reqs = make_requests(arch.vocab, n=6, gen=8)
        runs = {}
        for tag, ctx in (("unrealized", contextlib.nullcontext()),
                         ("realized", use_mesh(mesh))):
            with ctx:
                res, eng, toks = serve_once(
                    torch, params, arch, reqs, mode="a",
                    dtype=torch.float32, device=device, max_batch=4,
                    max_len=1024, plan=saved)
            runs[tag] = {"tokens": toks, "launches": res["launches"],
                         **{k: res[k] for k in ("wall_s", "tok_s", "steps",
                                                "itl_p50_ms", "itl_p99_ms")}}
            del eng
            gc.collect()
        _realize_check("serve-llama3.2-1b", runs["unrealized"],
                       runs["realized"], "tokens")
        emit({"phase": "realize-serve-llama3.2-1b", "plan": "node 2x4",
              "tokens_equal": runs["unrealized"]["tokens"]
              == runs["realized"]["tokens"],
              "itl_overhead_ms": runs["realized"]["itl_p50_ms"]
              - runs["unrealized"]["itl_p50_ms"],
              **{t: {k: v for k, v in r.items() if k != "tokens"}
                 for t, r in runs.items()}})
        del params
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


# --------------------------------------------------------------------------- #
# the dry run's predictions of the train phases' one-card runs: the
# phase's record name -> the command's arch arguments (8 x 256, float32,
# one card, as train_full runs them)
DRYRUN_TRAIN = {"train-llama3.2-1b": ["--arch", "llama3.2-1b"],
                f"train-olmoe-1b-7b-d{OLMOE_TRAIN_DEPTH}": [
                    "--arch", "olmoe-1b-7b", "--depth",
                    str(OLMOE_TRAIN_DEPTH)]}
# a predicted peak within this share of the measured one
DRYRUN_MEMORY_TOL = 0.10


def _dryrun_cli(argv, timeout: int = 600) -> tuple[dict, str, float]:
    """``python -m repro_torch.launch.dryrun`` in a process of its own (its
    fake process group never meets this one's); returns (the cell's JSON,
    its stdout, seconds)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        *argv], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"dryrun {argv} exited {r.returncode}:\n"
                           f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    path = next(line.split("result: ", 1)[1] for line in r.stdout.splitlines()
                if line.startswith("result: "))
    return json.loads(Path(path).read_text()), r.stdout, seconds


def phase_dryrun(torch, device):
    """The dry run (``repro_torch.launch.dryrun``) against the card.

    1. Every kernel phase's call again on copies of its tensors that hold
       no data (``FAKE_CALLS``): each kernel's fake branch must report the
       work that phase passed to ``bound()``.
    2. The one-card train runs of the ``train`` phase predicted
       (``DRYRUN_TRAIN``): the peak within ``DRYRUN_MEMORY_TOL`` of the
       measured ``max_memory_allocated``, and the roofline's lower bound,
       max(compute, memory), at or below the measured step.
    3. llama3.2-1b's ``train_4k`` on the 256-GPU production mesh
       (``--mesh single``, searched) under the ``profile`` phase's device
       profile: its summary, its seconds, and the per-layer report (the
       calibrated cost model against each layer's equivalent timed on
       this card).
    Across the phase every launch counter and ``memory_allocated`` must
    stay as they were: the fake branches touch nothing on the card."""
    from repro_torch.kernels import ops, work
    launches0 = ops.launch_counts()
    mem0 = torch.cuda.memory_allocated()
    mismatched = []
    for phase, call, want in FAKE_CALLS:
        got = []
        with work.recording(lambda n, w: got.append(w)):
            call()
        if got != [want]:
            mismatched.append({"phase": phase, "want": str(want),
                               "got": [str(w) for w in got]})
    mem1 = torch.cuda.memory_allocated()
    res = {"phase": "dryrun", "fake_calls": len(FAKE_CALLS),
           "fake_work_mismatched": mismatched, "predictions": {}}
    one_card = ["--shape", "train_4k", "--seq", "256", "--batch", "8",
                "--mesh-shape", "1,1,1", "--dtype", "float32"]
    for rec_name, argv in DRYRUN_TRAIN.items():
        pred, _, sec = _dryrun_cli(argv + one_card)
        meas = _phase_record(rec_name) or {}
        rf = pred["roofline"]
        got_gb = pred["hbm"]["per_device_total"] / 1e9
        want_gb = meas.get("max_memory_allocated_gb")
        bound_ms = max(rf["compute_s"], rf["memory_s"]) * 1e3
        step_ms = meas.get("step_ms_after_first")
        res["predictions"][rec_name] = {
            "predicted_peak_gb": got_gb, "measured_peak_gb": want_gb,
            "rel_error": (None if not want_gb
                          else abs(got_gb - want_gb) / want_gb),
            "roofline_bound_ms": bound_ms, "compute_ms": rf["compute_s"] * 1e3,
            "memory_ms": rf["memory_s"] * 1e3, "dominant": rf["dominant"],
            "measured_step_ms": step_ms, "kernels": pred["kernels"],
            "seconds": sec}
        print(f"dryrun {rec_name}: peak {got_gb:.2f} GB predicted, "
              f"{want_gb} GB measured; bound {bound_ms:.1f} ms, step "
              f"{step_ms} ms measured", flush=True)
    profile = OUT / "profile-h100.json"
    prod, out, sec = _dryrun_cli(
        ["--arch", "llama3.2-1b", "--shape", "train_4k", "--mesh", "single",
         "--strategy", "search", "--device-profile", str(profile)],
        timeout=900)
    summary = next(line for line in out.splitlines()
                   if line.startswith("[OK]"))
    print(summary, flush=True)
    res["production"] = {
        "cell": prod["cell"], "summary": summary, "seconds": sec,
        "per_device_total_gb": prod["hbm"]["per_device_total"] / 1e9,
        "fits_80GB": prod["hbm"]["fits_80GB"], "roofline": prod["roofline"],
        "collective_bytes_per_axis": prod["collective_bytes_per_axis"],
        "calibration": prod["calibration"]}
    launches1 = ops.launch_counts()
    mem2 = torch.cuda.memory_allocated()
    res.update({"launches_unchanged": launches0 == launches1,
                "memory_allocated_bytes": [mem0, mem1, mem2]})
    emit(res)
    if mismatched:
        fail(f"dryrun: fake work differs from the kernel phases' "
             f"{mismatched}")
    if not (launches0 == launches1 and mem0 == mem1 == mem2):
        fail(f"dryrun: the fake path touched the card (launches "
             f"{launches0} -> {launches1}, memory {mem0}, {mem1}, {mem2})")
    for name, p in res["predictions"].items():
        if p["rel_error"] is None or p["rel_error"] > DRYRUN_MEMORY_TOL:
            fail(f"dryrun {name}: predicted peak {p['predicted_peak_gb']} "
                 f"GB, measured {p['measured_peak_gb']}")
        if p["measured_step_ms"] is None or \
                p["roofline_bound_ms"] > p["measured_step_ms"]:
            fail(f"dryrun {name}: roofline bound {p['roofline_bound_ms']} "
                 f"ms above the measured step {p['measured_step_ms']}")
    if not prod["calibration"]:
        fail("dryrun: no per-layer report")


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
        ("launch-floor", lambda: phase_launch_floor(torch, timer)),
        ("paged-f32", lambda: phase_paged(torch, timer, device, "paged-f32",
                                          torch.float32, torch.float32)),
        ("paged-bf16", lambda: phase_paged(torch, timer, device,
                                           "paged-bf16", torch.bfloat16,
                                           torch.bfloat16)),
        ("paged-int8", lambda: phase_paged(torch, timer, device,
                                           "paged-int8", torch.int8,
                                           torch.float32)),
        ("paged-int8-bf16", lambda: phase_paged(
            torch, timer, device, "paged-int8-bf16", torch.int8,
            torch.bfloat16)),
        ("flash-f32", lambda: phase_flash(torch, timer, device, "flash-f32",
                                          torch.float32)),
        ("flash-bf16", lambda: phase_flash(torch, timer, device,
                                           "flash-bf16", torch.bfloat16)),
        ("paged-d128-f32", lambda: phase_paged(
            torch, timer, device, "paged-d128-f32", torch.float32,
            torch.float32, KH=16, G=1, D=128)),
        ("paged-d128-bf16", lambda: phase_paged(
            torch, timer, device, "paged-d128-bf16", torch.bfloat16,
            torch.bfloat16, KH=16, G=1, D=128)),
        ("paged-d128-int8", lambda: phase_paged(
            torch, timer, device, "paged-d128-int8", torch.int8,
            torch.float32, KH=16, G=1, D=128)),
        ("flash-d128-f32", lambda: phase_flash(
            torch, timer, device, "flash-d128-f32", torch.float32, S=675,
            T=1024, H=16, KH=16, D=128)),
        ("flash-d128-bf16", lambda: phase_flash(
            torch, timer, device, "flash-d128-bf16", torch.bfloat16, S=675,
            T=1024, H=16, KH=16, D=128)),
        ("decode-olmoe-f32", lambda: phase_decode(
            torch, timer, device, "decode-olmoe-f32", torch.float32, B=8,
            KH=16, G=1, D=128)),
        ("decode-olmoe-bf16", lambda: phase_decode(
            torch, timer, device, "decode-olmoe-bf16", torch.bfloat16, B=8,
            KH=16, G=1, D=128)),
        ("decode-llama-f32", lambda: phase_decode(
            torch, timer, device, "decode-llama-f32", torch.float32, B=8,
            KH=8, G=4, D=64)),
        ("decode-llama-bf16", lambda: phase_decode(
            torch, timer, device, "decode-llama-bf16", torch.bfloat16, B=8,
            KH=8, G=4, D=64)),
        ("moe-decode-f32", lambda: phase_moe(
            torch, timer, device, "decode-f32", torch.float32, B=8, S=1,
            C=8)),
        ("moe-decode-bf16", lambda: phase_moe(
            torch, timer, device, "decode-bf16", torch.bfloat16, B=8, S=1,
            C=8)),
        ("moe-chunk-f32", lambda: phase_moe(
            torch, timer, device, "chunk-f32", torch.float32, B=1, S=256,
            C=40)),
        ("moe-chunk-bf16", lambda: phase_moe(
            torch, timer, device, "chunk-bf16", torch.bfloat16, B=1, S=256,
            C=40)),
        ("moe-prefill700-f32", lambda: phase_moe(
            torch, timer, device, "prefill700-f32", torch.float32, B=1,
            S=700, C=112)),
        ("moe-prefill700-bf16", lambda: phase_moe(
            torch, timer, device, "prefill700-bf16", torch.bfloat16, B=1,
            S=700, C=112)),
        ("moe-prefill1024-f32", lambda: phase_moe(
            torch, timer, device, "prefill1024-f32", torch.float32, B=1,
            S=1024, C=160)),
        ("moe-prefill1024-bf16", lambda: phase_moe(
            torch, timer, device, "prefill1024-bf16", torch.bfloat16, B=1,
            S=1024, C=160)),
        ("paged-jamba-f32", lambda: phase_paged(
            torch, timer, device, "paged-jamba-f32", torch.float32,
            torch.float32, KH=8, G=8, D=128)),
        ("paged-jamba-bf16", lambda: phase_paged(
            torch, timer, device, "paged-jamba-bf16", torch.bfloat16,
            torch.bfloat16, KH=8, G=8, D=128)),
        ("flash-jamba-f32", lambda: phase_flash(
            torch, timer, device, "flash-jamba-f32", torch.float32, S=675,
            T=1024, H=64, KH=8, D=128)),
        ("flash-jamba-bf16", lambda: phase_flash(
            torch, timer, device, "flash-jamba-bf16", torch.bfloat16, S=675,
            T=1024, H=64, KH=8, D=128)),
        ("flash-long-f32", lambda: phase_flash(
            torch, timer, device, "flash-long-f32", torch.float32, S=4096,
            T=4096, H=64, KH=8, D=128, plain_iters=2)),
        ("flash-long-bf16", lambda: phase_flash(
            torch, timer, device, "flash-long-bf16", torch.bfloat16, S=4096,
            T=4096, H=64, KH=8, D=128, plain_iters=2)),
        ("decode-jamba-f32", lambda: phase_decode(
            torch, timer, device, "decode-jamba-f32", torch.float32, B=8,
            KH=8, G=8, D=128)),
        ("decode-jamba-bf16", lambda: phase_decode(
            torch, timer, device, "decode-jamba-bf16", torch.bfloat16, B=8,
            KH=8, G=8, D=128)),
        ("moe-decode-jamba-f32", lambda: phase_moe(
            torch, timer, device, "decode-jamba-f32", torch.float32, B=8,
            S=1, C=8, K=2, E=16, D=8192)),
        ("moe-decode-jamba-bf16", lambda: phase_moe(
            torch, timer, device, "decode-jamba-bf16", torch.bfloat16, B=8,
            S=1, C=8, K=2, E=16, D=8192)),
        ("moe-chunk-jamba-f32", lambda: phase_moe(
            torch, timer, device, "chunk-jamba-f32", torch.float32, B=1,
            S=256, C=40, K=2, E=16, D=8192)),
        ("moe-chunk-jamba-bf16", lambda: phase_moe(
            torch, timer, device, "chunk-jamba-bf16", torch.bfloat16, B=1,
            S=256, C=40, K=2, E=16, D=8192)),
        ("moe-prefill700-jamba-f32", lambda: phase_moe(
            torch, timer, device, "prefill700-jamba-f32", torch.float32,
            B=1, S=700, C=112, K=2, E=16, D=8192)),
        ("moe-prefill700-jamba-bf16", lambda: phase_moe(
            torch, timer, device, "prefill700-jamba-bf16", torch.bfloat16,
            B=1, S=700, C=112, K=2, E=16, D=8192)),
        # phi3.5-moe's serve shapes: 32 heads over 8 KV heads of 128 (G 4,
        # G*D 512) in paged and dense decode and the dense prefill; its 16
        # experts top 2 at d 4096 at the decode, chunk and prefill sizes
        *((f"{tag}-phi3.5-{dn}", lambda fn=fn, dt=dt, tag=tag, dn=dn:
           fn(f"{tag}-phi3.5-{dn}", dt))
          for tag, fn in (
              ("paged", lambda n, dt: phase_paged(
                  torch, timer, device, n, dt, dt, KH=8, G=4, D=128)),
              ("decode", lambda n, dt: phase_decode(
                  torch, timer, device, n, dt, B=8, KH=8, G=4, D=128)),
              ("flash", lambda n, dt: phase_flash(
                  torch, timer, device, n, dt, S=675, T=1024, H=32, KH=8,
                  D=128)))
          for dn, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))),
        *((f"moe-{tag}-phi3.5-{dn}", lambda dt=dt, tag=tag, dn=dn, kw=kw:
           phase_moe(torch, timer, device, f"{tag}-phi3.5-{dn}", dt, K=2,
                     E=16, D=4096, **kw))
          for tag, kw in (("decode", dict(B=8, S=1, C=8)),
                          ("chunk", dict(B=1, S=256, C=40)),
                          ("prefill700", dict(B=1, S=700, C=112)))
          for dn, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))),
        ("mamba-chunk-f32", lambda: phase_mamba(
            torch, timer, device, "mamba-chunk-f32", torch.float32, B=1,
            S=256)),
        ("mamba-chunk-bf16", lambda: phase_mamba(
            torch, timer, device, "mamba-chunk-bf16", torch.bfloat16, B=1,
            S=256)),
        ("mamba-decode-f32", lambda: phase_mamba(
            torch, timer, device, "mamba-decode-f32", torch.float32, B=8,
            S=1)),
        ("mamba-decode-bf16", lambda: phase_mamba(
            torch, timer, device, "mamba-decode-bf16", torch.bfloat16, B=8,
            S=1)),
        ("mamba-prefill-f32", lambda: phase_mamba(
            torch, timer, device, "mamba-prefill-f32", torch.float32, B=1,
            S=675)),
        ("mamba-forward-f32", lambda: phase_mamba(
            torch, timer, device, "mamba-forward-f32", torch.float32, B=1,
            S=512, state=False)),
        ("mamba-forward-bf16", lambda: phase_mamba(
            torch, timer, device, "mamba-forward-bf16", torch.bfloat16, B=1,
            S=512, state=False)),
        ("mamba-n8-f32", lambda: phase_mamba(
            torch, timer, device, "mamba-n8-f32", torch.float32, B=1,
            S=256, N=8)),
        ("mamba-dt0", lambda: phase_mamba_dt0(torch, device)),
        ("flash-train-f32", lambda: phase_flash_train(torch, timer, device)),
        # the encoder's non-causal form: seamless' serve and train shapes
        # (S = T, 16 heads of 64, each its own KV head), and S = T = 300
        *((f"flash-full-{tag}-{dn}", lambda S=S, dt=dt, tag=tag, dn=dn:
           phase_flash(torch, timer, device, f"flash-full-{tag}-{dn}", dt,
                       S=S, T=S, H=16, KH=16, D=64, B=8, causal=False))
          for tag, S in (("serve", 256), ("train", 128), ("300", 300))
          for dn, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))),
        # the lockstep serve paths: seamless' decoder prefill q (8, 16,
        # 256, 64) against its 288-row cache (256 tokens + 32 new) and its
        # decode over that row; internvl2's prefill q (4, 64, 512, 128)
        # (256 frontend + 256 text) against 8 KV heads of a 545-row cache
        # and its decode (G 8)
        *((f"flash-{tag}-{dn}", lambda dt=dt, tag=tag, dn=dn, kw=kw:
           phase_flash(torch, timer, device, f"flash-{tag}-{dn}", dt, **kw))
          for tag, kw in (("seamless", dict(S=256, T=288, H=16, KH=16, D=64,
                                            B=8)),
                          ("internvl2", dict(S=512, T=545, H=64, KH=8,
                                             D=128, B=4)))
          for dn, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))),
        *((f"decode-{tag}-{dn}", lambda dt=dt, tag=tag, dn=dn, kw=kw:
           phase_decode(torch, timer, device, f"decode-{tag}-{dn}", dt, **kw))
          for tag, kw in (("seamless", dict(B=8, KH=16, G=1, D=64, T=288)),
                          ("internvl2", dict(B=4, KH=8, G=8, D=128, T=545)))
          for dn, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))),
        ("wkv6-f32", lambda: phase_wkv6(torch, timer, device, "wkv6-f32",
                                        torch.float32)),
        ("wkv6-bf16", lambda: phase_wkv6(torch, timer, device, "wkv6-bf16",
                                         torch.bfloat16)),
        ("grads", lambda: phase_grads(torch, device)),
        ("reference", lambda: phase_reference(torch, device)),
        ("reference-olmoe", lambda: phase_reference_moe(
            torch, device, "olmoe", OLMOE_MODES,
            ["moe_scatter", "moe_gather"])),
        ("reference-jamba", lambda: phase_reference_moe(
            torch, device, "jamba", JAMBA_MODES,
            ["moe_scatter", "moe_gather", "mamba_scan"])),
        ("reference-seq2seq", lambda: phase_reference_seq2seq(torch,
                                                              device)),
        ("reference-train", lambda: phase_reference_train(torch, device)),
        ("serve", lambda: phase_serve(torch, device)),
        ("serve-olmoe", lambda: phase_serve_olmoe(torch, device)),
        ("serve-jamba", lambda: phase_serve_jamba(torch, device)),
        ("serve-rwkv6", lambda: phase_serve_rwkv(torch, device)),
        ("serve-seamless", lambda: phase_serve_seamless(torch, device)),
        ("serve-internvl2", lambda: phase_serve_internvl2(torch, device)),
        ("serve-phi3.5", lambda: phase_serve_phi35(torch, device)),
        ("train", lambda: phase_train(torch, device)),
        ("plan", lambda: phase_plan(torch, device)),
        ("plan-train-staged", lambda: phase_plan_staged(torch, device)),
        ("profile", lambda: phase_profile(torch, device)),
        ("realize", lambda: phase_realize(torch, device)),
        ("dryrun", lambda: phase_dryrun(torch, device)),
    ]
    counts, seconds = {}, {}
    for name, fn in steps:
        t0 = time.perf_counter()
        try:
            out = fn()
        except Exception:                 # record, then go on to the next
            fail(f"{name}: {traceback.format_exc()}")
            continue
        finally:
            # engines hold their parameters in reference cycles (the
            # recording wrappers close over the engine): collect them
            # before the next phase allocates
            gc.collect()
            torch.cuda.empty_cache()
            seconds[name] = time.perf_counter() - t0
            print(f"# {name}: {seconds[name]:.1f} s", flush=True)
        if name in ("serve", "serve-olmoe", "serve-jamba", "serve-rwkv6",
                    "serve-seamless", "serve-internvl2", "serve-phi3.5",
                    "train", "plan", "plan-train-staged", "profile"):
            counts.update(out)            # launch counts of the main path
        elif isinstance(out, list):
            kern.update((r["phase"], r) for r in out)
        elif out is not None:
            kern[name] = out

    # each kernel's launches in the main-path runs it is on (each serve
    # mode and the train steps), and its numbers at one main-path shape
    rows = [("decode_attention", "decode-olmoe-f32",
             "src/repro_torch/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:34"),
            ("moe_scatter", "moe-scatter-decode-f32",
             "src/repro_torch/csrc/moe_dispatch.cu",
             "src/repro/kernels/moe_kernels.py:176"),
            ("moe_gather", "moe-gather-decode-f32",
             "src/repro_torch/csrc/moe_dispatch.cu",
             "src/repro/kernels/moe_kernels.py:192"),
            ("paged_decode_attention", "paged-f32",
             "src/repro_torch/csrc/paged_decode_attention.cu",
             "src/repro/kernels/paged_decode_attention.py:37"),
            ("paged_decode_attention_int8", "paged-int8",
             "src/repro_torch/csrc/paged_decode_attention.cu",
             "src/repro/kernels/paged_decode_attention.py:76"),
            ("flash_attention", "flash-f32",
             "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:33"),
            ("wkv6", "wkv6-f32", "src/repro_torch/csrc/rwkv6_scan.cu",
             "src/repro/kernels/rwkv6_scan.py:28"),
            ("mamba_scan", "mamba-chunk-f32",
             "src/repro_torch/csrc/mamba_scan.cu",
             "src/repro/kernels/mamba_scan.py:139")]
    kernels = []
    # kernels timed in bfloat16 too carry those numbers at the same shape
    bf16_phase = {"flash_attention": "flash-bf16",
                  "decode_attention": "decode-olmoe-bf16",
                  "moe_scatter": "moe-scatter-decode-bf16",
                  "moe_gather": "moe-gather-decode-bf16",
                  "wkv6": "wkv6-bf16",
                  "mamba_scan": "mamba-chunk-bf16"}
    for name, phase, source, replaces in rows:
        k = kern.get(phase, {})
        by_path = {path: c[name] for path, c in counts.items()
                   if c.get(name)}
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": sum(by_path.values()),
               "launches_by_path": by_path,
               "max_abs_err": k.get("max_abs_err"), "ms": k.get("kernel_ms"),
               "plain_ms": k.get("plain_ms"), "bound_ms": k.get("bound_ms"),
               "bound_by": k.get("bound_by"),
               "library_ms": k.get("library_ms")}
        if name in bf16_phase:
            kb = kern.get(bf16_phase[name], {})
            row.update({"ms_bf16": kb.get("kernel_ms"),
                        "library_ms_bf16": kb.get("library_ms"),
                        "bound_ms_bf16": kb.get("bound_ms"),
                        "max_abs_err_bf16": kb.get("max_abs_err")})
        if name == "flash_attention":
            # the non-causal form at the encoder's serve shape
            for dn in ("f32", "bf16"):
                kf = kern.get(f"flash-full-serve-{dn}", {})
                row.update({f"{key}_noncausal_{dn}": kf.get(src) for key, src
                            in (("ms", "kernel_ms"),
                                ("library_ms", "library_ms"),
                                ("plain_ms", "plain_ms"),
                                ("bound_ms", "bound_ms"),
                                ("max_abs_err", "max_abs_err"))})
        kernels.append(row)
    record["kernels"] = kernels
    record["seconds"] = seconds
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
