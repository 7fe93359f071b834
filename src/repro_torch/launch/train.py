"""Training command of the port: the counterpart of
``repro.launch.train``, on one GPU.

Builds the train step, streams the synthetic pipeline, checkpoints
periodically and resumes after failures (``--resume`` restores the newest
complete checkpoint and continues the data stream deterministically from
the restored step).

    python -m repro_torch.launch.train --arch llama3.2-1b \
        --steps 200 --batch 8 --seq 256 --depth 8

Reduced dims (``--width/--depth/--vocab``) scale the assigned arch down;
omit them for the published config.  The encoder-decoder
(``--arch seamless-m4t-large-v2``; ``--depth`` sets both stacks) trains
on frames + tokens, a VLM (``--arch internvl2-76b``) on frontend
embeddings + tokens, each as the reference's dataset gives them
(``--seq`` counts both parts; a VLM's frontend takes 256 of it).  On the
card the width must leave the heads at a size the kernels take (head dim
64 or 128: the published width, ``--width 0``); a width that does not is
refused before anything is built.  The flags and defaults are the
reference's, plus ``--device`` (``cpu`` runs the plain PyTorch versions
on the CPU; without it the command needs a GPU).  The default checkpoint
directory is ``repro_ckpt`` under the temporary directory (``TMPDIR``).

The plan flags are the reference's and go through the port's
``plans.resolve_plan``: ``--strategy`` builds a plan, ``--plan`` loads
one (arch-checked; it beats ``--strategy``), ``--save-plan`` writes the
plan either way, ``--pipeline-stages`` asks the searched train phase for
pipeline stages.  One GPU has no mesh (``None``), on which every built
plan degrades to uniform, and a loaded plan searched for a mesh says
that it places nothing here (both logged, as the reference logs them);
the train phase of the plan goes to ``make_train_step``, which refuses a
pipeline-staged one, naming the realization slice.  The flags that need
the profiler or the kernel dispatcher (``--device-profile``,
``--kernel-backend``, ``--autotune-cache-dir``) raise, naming the slice
that brings them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import make_dataset
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.mamba_scan import MAX_N as MAX_SCAN_N
from repro_torch.models import init_params
from repro_torch.models.arch import ShapeSpec
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.plans import resolve_plan
from repro_torch.train import TrainConfig, make_train_step


def reduced_arch(arch, width, depth, vocab, experts=0):
    """Shrink ``arch`` (0 keeps a dimension), as the reference's
    ``repro.launch.train.reduced_arch`` does.  A depth below the pattern's
    period takes the pattern of the config's ``reduced()`` (jamba's: a
    Mamba layer with a dense FFN, then attention with MoE), where the
    reference rounds the depth up to the period: so ``depth=2`` keeps
    every layer kind of jamba at its published width on one card."""
    if 0 < depth < arch.period:
        arch = dataclasses.replace(
            arch, pattern=configs.reduced(arch.name).pattern)
    kw = {}
    if width:
        kw.update(d_model=width, d_ff=width * 4,
                  moe_d_ff=width * 4 if arch.moe_d_ff else 0,
                  head_dim=0)
        if width % arch.n_heads != 0:
            kw.update(n_heads=8, n_kv_heads=min(8, arch.n_kv_heads))
    if depth:
        period = arch.period
        kw["n_layers"] = max(period, (depth // period) * period)
        if arch.enc_layers:
            kw["enc_layers"] = depth
    if vocab:
        kw["vocab"] = vocab
    if experts and arch.n_experts:
        kw.update(n_experts=experts, top_k=min(arch.top_k, experts))
    return dataclasses.replace(arch, **kw) if kw else arch


def kernel_shape_faults(arch) -> list[str]:
    """What of ``arch`` the card's kernels do not take (``ops.supports_*``
    at one token of its attention, WKV6 and scan layers); empty when every
    such op of its stack can launch its kernel.  An encoder-decoder's
    encoder has the decoder's heads, so its attention check covers both."""
    kinds = {l.mixer for l in arch.pattern}
    faults = []
    if "attn" in kinds:
        H, KH, hd = arch.n_heads, arch.n_kv_heads, arch.hd
        q, kv = (1, H, 1, hd), (1, KH, 1, hd)
        dq = (1, KH, H // KH, hd)
        if not (ops.supports_flash_attention(q, kv)
                and ops.supports_decode_attention(dq, kv)
                and ops.supports_paged_decode_attention(
                    dq, (1, 1, KH, hd), (1, 1))):
            faults.append(f"attention of head dim {hd}, {H} heads over "
                          f"{KH} KV heads (the kernels take head dims 64 "
                          f"and 128, whole head groups of at most "
                          f"2048 / head dim)")
    if "rwkv" in kinds and not ops.supports_wkv6(
            (1, arch.n_rwkv_heads, 1, arch.rwkv_head_size)):
        faults.append(f"WKV6 head size {arch.rwkv_head_size} (the kernel "
                      f"takes 32 and 64)")
    if "mamba" in kinds and not ops.supports_mamba_scan(
            (1, 1, arch.d_inner), arch.ssm_state):
        faults.append(f"scan state size {arch.ssm_state} (the kernel takes "
                      f"1 to {MAX_SCAN_N})")
    return faults


def require_kernel_shapes(arch, device: torch.device) -> None:
    """On the card every attention, WKV6 and scan op launches its kernel,
    which raises on a shape it does not take: refuse such an ``arch``
    before building it, naming the width that works."""
    faults = kernel_shape_faults(arch) if device.type == "cuda" else []
    if faults:
        raise ValueError(
            f"{arch.name} at d_model {arch.d_model}: the CUDA kernels do "
            f"not take {'; '.join(faults)}. Keep the published width "
            f"(--width 0) or one at which the heads come out so, or run "
            f"the plain versions with --device cpu")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--width", type=int, default=0)
    ap.add_argument("--depth", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--experts", type=int, default=0)
    ap.add_argument("--strategy", default="search",
                    choices=["search", "searched", "data", "model", "owt",
                             "uniform", "none"])
    ap.add_argument("--pipeline-stages", type=int, default=0,
                    help="pipeline the train phase over this many stages "
                         "(searched two-level; needs --strategy search and "
                         "a mesh: one GPU degrades to uniform); 0/1 = no "
                         "pipelining, -1 = auto-search the stage count")
    ap.add_argument("--microbatches", type=int, default=8,
                    help="1F1B microbatch count M when pipelining")
    ap.add_argument("--plan", default="",
                    help="load a ParallelPlan JSON (the train phase is "
                         "used); overrides --strategy, refuses an arch "
                         "mismatch")
    ap.add_argument("--save-plan", default="",
                    help="write the plan (searched or baseline) to this "
                         "JSON path; reload with --plan here or on the "
                         "serve command")
    ap.add_argument("--ckpt-dir",
                    default=str(Path(tempfile.gettempdir()) / "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--kernel-backend", default="",
                    help="force a kernel backend (dispatcher slice)")
    ap.add_argument("--autotune-cache-dir", default="",
                    help="block-size autotune cache (dispatcher slice)")
    ap.add_argument("--device-profile", default="",
                    help="measured DeviceProfile JSON (profiling slice)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def _refuse_later_flags(args) -> None:
    later = [
        (args.device_profile, "--device-profile",
         "the H100 profiling slice"),
        (args.kernel_backend or args.autotune_cache_dir,
         "--kernel-backend/--autotune-cache-dir",
         "the dispatcher-overrides slice"),
    ]
    for given, flag, slice_ in later:
        if given:
            raise NotImplementedError(
                f"{flag} is not ported yet: it arrives with {slice_} "
                f"(ROADMAP.md)")


def main(argv=None) -> list[dict]:
    """Train; returns the logged metrics (one dict per logged step)."""
    args = parser().parse_args(argv)
    _refuse_later_flags(args)
    device = resolve_device(args.device)

    arch = reduced_arch(configs.get(args.arch), args.width, args.depth,
                        args.vocab, args.experts)
    require_kernel_shapes(arch, device)
    shape = ShapeSpec("custom", args.seq, args.batch, "train")
    name = {"search": "searched", "none": "uniform"}.get(
        args.strategy, args.strategy)
    # one GPU: no mesh, so a built plan degrades to uniform and a loaded
    # one places nothing (resolve_plan logs both)
    pplan = resolve_plan(
        arch, None, phases=("train",), plan_path=args.plan, strategy=name,
        save_plan=args.save_plan, train_seq=args.seq,
        train_batch=args.batch, train_stages=args.pipeline_stages,
        train_microbatches=args.microbatches)
    staged = pplan.stage_for("train").num_stages > 1

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=20,
                          total_steps=args.steps)
    tcfg = TrainConfig(optimizer=opt_cfg, q_chunk=256, time_chunk=32,
                       remat=True)
    step_fn = make_train_step(
        arch, pplan if staged else pplan.plan_for("train"), tcfg)
    ds = make_dataset(arch, shape)

    ckpt = CheckpointManager(args.ckpt_dir)
    params = init_params(
        arch, torch.float32,
        generator=torch.Generator(device=device).manual_seed(0),
        device=device)
    opt_state = adamw_init(params)
    start_step = 0
    if args.resume:
        like = {"params": params, "opt": opt_state}
        step, state = ckpt.restore_latest(like)
        if step is not None:
            params, opt_state = state["params"], state["opt"]
            start_step = step
            print(f"resumed from step {step}")

    history = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in ds.batch_at(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            tok_s = shape.tokens * (step - start_step + 1) / max(dt, 1e-9)
            print(f"step {step:5d} loss={m['loss']:.4f} "
                  f"nll={m['nll']:.4f} acc={m['accuracy']:.3f} "
                  f"gnorm={m['grad_norm']:.2f} tok/s={tok_s:.0f}")
            history.append({"step": step, **m})
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state})
    if args.ckpt_every:
        ckpt.save(args.steps, {"params": params, "opt": opt_state})
    if args.metrics_out:
        Path(args.metrics_out).write_text(json.dumps(history, indent=1))
    if history:
        first, last = history[0]["nll"], history[-1]["nll"]
        print(f"nll {first:.4f} -> {last:.4f} "
              f"({'LEARNED' if last < first - 0.2 else 'check'})")
    return history


if __name__ == "__main__":
    main()
