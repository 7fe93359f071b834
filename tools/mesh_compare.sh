#!/bin/bash
# The train and serve commands realized on a mesh of every GPU of the
# machine (torchrun, nccl) against the same commands on one GPU, at
# llama3.2-1b's published size:
#
#     bash tools/mesh_compare.sh
#
# Run from the repository root on a machine with several GPUs and the CUDA
# toolkit.  Train: 3 steps of 8 x 256 under the plan searched for the
# train mesh (every rank on data) and under the data baseline, against
# the plan-free run on one GPU; then the pipeline-staged train step: the
# plan searched with 2 stages and 4 microbatches on the stage-factored
# mesh (stage 2 x data n/2), saved, and the same plan on one GPU (which
# places nothing).  Serve: 6 requests on the serve mesh (2 x n/2) under
# the searched plan against one GPU, every completion's tokens compared.
# Each train run's losses, step ms and every rank's peak memory come from
# its --metrics-out records; the staged plan's priced cost and bubble
# from the saved plan.  Logs and metrics land in chiprun_out/mesh/.
set -u
out=chiprun_out/mesh; mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
export PYTHONPATH=src
python -c "from repro_torch.kernels import build; build.build_all()" || exit 1
T="--arch llama3.2-1b --steps 3 --batch 8 --seq 256 --ckpt-every 0 --log-every 1"
S="--arch llama3.2-1b --width 0 --depth 0 --vocab 0 --batch 4 --requests 6 --prompt-len 96 --gen 8"
n=$(nvidia-smi -L | wc -l)
for strat in searched data; do
  timeout 400 torchrun --nproc-per-node $n -m repro_torch.launch.train $T \
    --strategy $strat --metrics-out $out/train-$strat.json \
    > $out/train-$strat.log 2>&1; echo "train-$strat rc=$?"
done
timeout 300 python -m repro_torch.launch.train $T --strategy uniform \
  --metrics-out $out/train-one.json > $out/train-one.log 2>&1
echo "train-one rc=$?"
timeout 600 torchrun --nproc-per-node $n -m repro_torch.launch.train $T \
  --strategy search --pipeline-stages 2 --microbatches 4 \
  --save-plan $out/staged-plan.json --metrics-out $out/train-staged.json \
  > $out/train-staged.log 2>&1; echo "train-staged rc=$?"
timeout 300 python -m repro_torch.launch.train $T \
  --plan $out/staged-plan.json --metrics-out $out/train-staged-one.json \
  > $out/train-staged-one.log 2>&1; echo "train-staged-one rc=$?"
timeout 400 torchrun --nproc-per-node $n tools/serve_tokens.py $S \
  --strategy searched > $out/serve-mesh.log 2>&1; echo "serve-mesh rc=$?"
timeout 300 python tools/serve_tokens.py $S > $out/serve-one.log 2>&1
echo "serve-one rc=$?"
one=$(grep -h "^TOKENS" $out/serve-one.log)
[ -n "$one" ] && [ "$(grep -h "^TOKENS" $out/serve-mesh.log)" = "$one" ] \
  && echo "serve tokens equal" || echo "serve tokens DIFFER"
for f in train-searched train-data train-one train-staged train-staged-one \
    serve-mesh serve-one; do
  echo "== $f"
  grep -v "^\[rank\|W1018\|Warning\|warn\|^TOKENS" $out/$f.log | tail -14
done
python - "$out" <<'EOF'
import json, pathlib, sys
out = pathlib.Path(sys.argv[1])
for f in ("train-searched", "train-data", "train-one", "train-staged",
          "train-staged-one"):
    p = out / f"{f}.json"
    if not p.exists():
        print(f"METRICS {f} missing")
        continue
    hist = json.loads(p.read_text())
    print(f"METRICS {f} " + json.dumps({
        "loss": [h["loss"] for h in hist],
        "step_ms": [h.get("step_ms") for h in hist],
        "max_memory_allocated_gb": hist[-1].get("max_memory_allocated_gb")}))
p = out / "staged-plan.json"
if p.exists():
    plan = json.loads(p.read_text())
    ph = plan.get("meta", {}).get("phases", {}).get("train", {})
    print("PRICED staged " + json.dumps({
        "stages": plan.get("stages", {}).get("train"),
        **{k: ph.get(k) for k in ("cost_s", "pipeline_bubble_frac",
                                  "stage_costs_s")}}))
EOF
